// The split-KV flatten tree-decode kernels over fp32 q (the exactness
// checks), shared by paged_flatten.cu (B1, B4: tokens read through the plan's
// segment table) and flatten_gather.cu (B6, B11: tokens read through one pool
// index each, also at head_dim 96 and 256), over fp32 pools or int8 pools
// with fp32 scales.  Over bf16 q every flatten entry runs flat_q_body.cuh's
// tensor-core body, which shares the row sources, the pool view and the
// merge kernel below.
//
// Folded row r (leaf r / qpk, query head h * qpk + r % qpk) sees plan token t
// iff tok_lo[t] <= r / qpk < tok_hi[t].  Blocks with blk_lo >= blk_hi are
// dead; blk_lo < -(1 << 20) marks a FULL block (every token live for every
// leaf), which takes no mask.  The TPU kernels walk the blocks in order on
// one core and carry (m, l, acc) in VMEM; CUDA blocks run at once, so the
// work is split (split-KV):
//   kernel 1: one block per (64 folded rows, KV head, span of plan blocks)
//             writes the unnormalised (acc, m, l) of its span.  Dead blocks,
//             and blocks whose leaf interval misses the row tile (the
//             narrow-q case of the TPU kernel), are skipped; 64-token tiles
//             whose tokens no row of the tile sees are skipped too.
//   kernel 2: merges the spans by the LSE rule of deft_tpu
//             ops/sharded_flatten.py:158-165 (base 2) and writes 0 where l == 0.
//             Its partial form (the sharded entries, deft_tpu's partial=True)
//             writes the merged unnormalised state instead, for a merge
//             across devices.
// The number of spans is chosen by the caller so that the partial state is
// a fraction of the KV read.
#pragma once

#include "flash_common.cuh"

namespace deft {

// Paged plans: segment j of block b is the pool span [seg_src[b*nseg + j],
// + seg_len).
struct SegRows {
  const int* seg_src;
  int seg_len;
  int nseg;
  __device__ __forceinline__ int row(int b, int bt, int) const {
    return seg_src[b * nseg + bt / seg_len] + bt % seg_len;
  }
};

// Gather plans: plan token t is pool row kv_idx[t].
struct IdxRows {
  const int* kv_idx;
  __device__ __forceinline__ int row(int b, int bt, int block_len) const {
    return kv_idx[b * block_len + bt];
  }
};

// KV pools: (L, S, Hkv*D) of KV, plus (L, Hkv, S) fp32 scales for int8.
template <typename KV>
struct Pools {
  const KV* k;
  const KV* v;
  const float* ks;  // int8 only
  const float* vs;
  long long layer_off;  // li * S * Hkv * D
  long long scale_off;  // li * Hkv * S
  int S;
};

template <typename T, typename KV, int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
    flatten_partial_kernel(const T* __restrict__ q, Pools<KV> pools, Rows rows,
                           const int* __restrict__ tok_lo, const int* __restrict__ tok_hi,
                           const int* __restrict__ blk_lo, const int* __restrict__ blk_hi,
                           float* __restrict__ acc, float* __restrict__ m_out,
                           float* __restrict__ l_out, int R, int Hq, int Hkv, int nb,
                           int block_len, int blocks_per_span, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = Smem<T, D, KV>;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int qpk = Hq / Hkv;
  const int Rq = R * qpk;
  const int r0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int span = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int leaf_a = r0 / qpk;                          // first leaf of the tile
  const int leaf_b = (min(Rq, r0 + kBM) - 1) / qpk;     // last leaf of the tile

  if (threadIdx.x < kBM) {
    const int r = r0 + threadIdx.x;
    sm.roff[threadIdx.x] =
        r < Rq ? ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D : -1;
  }
  __syncthreads();
  load_rows<T, D>(sm.q, S::QS, q, sm.roff, kBM);
  cp_async_wait_all();
  __syncthreads();
  RowState<D> st;
  init_state<T, D>(st, sm);

  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int leaf0 = row0 / qpk, leaf1 = (row0 + 8) / qpk;
  const int b_end = min(nb, (span + 1) * blocks_per_span);
  for (int b = span * blocks_per_span; b < b_end; ++b) {
    const int blo = blk_lo[b], bhi = blk_hi[b];
    const bool full = blo < -(1 << 20);
    if (!full && blo >= bhi) continue;               // dead block
    if (bhi <= leaf_a || (!full && blo > leaf_b)) continue;  // misses the tile
    for (int sub = 0; sub < block_len; sub += kBN) {
      __syncthreads();  // the previous tile is consumed
      int any = 0;
      if (threadIdx.x < kBN) {
        const int bt = sub + threadIdx.x;  // token within the block
        const int row = rows.row(b, bt, block_len);
        sm.roff[threadIdx.x] = pools.layer_off + ((long long)row * Hkv + h) * D;
        if constexpr (S::kQ)
          sm.soff[threadIdx.x] = pools.scale_off + (long long)h * pools.S + row;
        const int t = b * block_len + bt;
        const int lo = tok_lo[t], hi = tok_hi[t];
        sm.lo[threadIdx.x] = lo;
        sm.hi[threadIdx.x] = hi;
        any = lo < hi && lo <= leaf_b && hi > leaf_a;
      }
      if (!full && !__syncthreads_or(any)) continue;  // no row sees this tile
      if (full) __syncthreads();
      if constexpr (S::kQ)
        load_kv_tile<T, D>(sm, pools.k, pools.v, pools.ks, pools.vs);
      else
        load_kv_tile<T, D>(sm, pools.k, pools.v);
      __syncthreads();
      float s[kBN / 8][4];
      tile_scores<T, D>(s, st, sm, s2);
      if (!full) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = n * 8 + tig * 2 + c;
            const int lo = sm.lo[t], hi = sm.hi[t];
            if (!(lo <= leaf0 && leaf0 < hi)) s[n][c] = kNeg;
            if (!(lo <= leaf1 && leaf1 < hi)) s[n][2 + c] = kNeg;
          }
        }
      }
      tile_update<T, D>(s, st, sm);
    }
  }

  // unnormalised state of this span: acc (spans, Hkv, Rq, D), m/l (spans, Hkv, Rq)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= Rq) continue;
    const long long base = ((long long)span * Hkv + h) * Rq + r;
    float* arow = acc + base * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + tig * 2;
      *reinterpret_cast<float2*>(arow + d) = make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
    }
    if (tig == 0) {
      m_out[base] = st.m[hh];
      l_out[base] = st.l[hh];
    }
  }
}

// One warp per folded row: o = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M),
// M = max_s m_s; 0 where the merged l is 0.  Written in the (R, Hq, D) layout.
// Partial form (m_o != null): the merged unnormalised state of the spans,
// acc = sum_s acc_s 2^(m_s - M) to o as fp32 (Hkv, R*qpk, D), m = M ln 2 (the
// natural-log max of deft_tpu's partial outputs, paged_flatten_attn.py:284)
// and l = sum_s l_s 2^(m_s - M) to m_o, l_o (Hkv, R*qpk).  A row no span saw
// keeps M = kNeg (or the -1e5 clamp): finite, so a merge across devices never
// computes inf - inf.
template <typename T>
__global__ void flatten_merge_kernel(const float* __restrict__ acc,
                                     const float* __restrict__ m_in,
                                     const float* __restrict__ l_in, void* __restrict__ o,
                                     float* __restrict__ m_o, float* __restrict__ l_o,
                                     int n_spans, int R, int Hq, int Hkv, int D) {
  const int qpk = Hq / Hkv;
  const int Rq = R * qpk;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int h = blockIdx.y;
  const int lane = threadIdx.x % 32;
  if (r >= Rq) return;
  const long long stride = (long long)Hkv * Rq;  // between spans
  const long long base = (long long)h * Rq + r;
  float mg = kNeg;
  for (int s = 0; s < n_spans; ++s) mg = fmaxf(mg, m_in[s * stride + base]);
  float lg = 0.f;
  for (int s = 0; s < n_spans; ++s) lg += l_in[s * stride + base] * exp2f(m_in[s * stride + base] - mg);
  if (m_o) {
    float* arow = static_cast<float*>(o) + base * D;
    for (int d = lane; d < D; d += 32) {
      float sum = 0.f;
      for (int s = 0; s < n_spans; ++s)
        sum += acc[(s * stride + base) * D + d] * exp2f(m_in[s * stride + base] - mg);
      arow[d] = sum;
    }
    if (lane == 0) {
      m_o[base] = mg * kLn2;
      l_o[base] = lg;
    }
    return;
  }
  const float inv = lg == 0.f ? 0.f : 1.f / lg;
  T* orow = static_cast<T*>(o) + ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D;
  for (int d = lane; d < D; d += 32) {
    float sum = 0.f;
    for (int s = 0; s < n_spans; ++s)
      sum += acc[(s * stride + base) * D + d] * exp2f(m_in[s * stride + base] - mg);
    orow[d] = from_f<T>(sum * inv);
  }
}

// m_o, l_o: null for the normalised output o (R, Hq, D); else the partial
// form of kernel 2, o then fp32 (Hkv, R*qpk, D).
template <typename KV, int D, typename Rows>
cudaError_t launch_flatten(const void* q, Pools<KV> pools, Rows rows, const int* tok_lo,
                           const int* tok_hi, const int* blk_lo, const int* blk_hi,
                           float* acc, float* m, float* l, void* o, float* m_o, float* l_o,
                           int R, int Hq, int Hkv, int nb, int block_len, int n_spans,
                           float scale, cudaStream_t stream) {
  auto kernel = flatten_partial_kernel<float, KV, D, Rows>;
  const size_t smem = sizeof(Smem<float, D, KV>);
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int rq = R * (Hq / Hkv);
  const int bps = (nb + n_spans - 1) / n_spans;
  dim3 grid((rq + kBM - 1) / kBM, Hkv, n_spans);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), pools, rows, tok_lo,
                                           tok_hi, blk_lo, blk_hi, acc, m, l, R, Hq, Hkv,
                                           nb, block_len, bps, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 mgrid((rq + 3) / 4, Hkv);
  flatten_merge_kernel<float><<<mgrid, 128, 0, stream>>>(acc, m, l, o, m_o, l_o, n_spans, R,
                                                         Hq, Hkv, D);
  return cudaGetLastError();
}

// Check the sizes, then instantiate launch_flatten for fp32 q and head_dim
// 64 or 128 (with kWide, the gather entries, also 96 and 256) over pools of
// KV (float, or int8 with scales).  m_o, l_o: see launch_flatten.
template <typename KV, bool kWide, typename Rows>
cudaError_t dispatch_flatten(const void* q, const void* k, const void* v, const float* ks,
                             const float* vs, long long layer_off, long long scale_off,
                             int S, Rows rows, const int* tok_lo, const int* tok_hi,
                             const int* blk_lo, const int* blk_hi, float* acc, float* m,
                             float* l, void* o, float* m_o, float* l_o, int R, int Hq,
                             int Hkv, int D, int nb, int block_len, int n_spans, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || n_spans <= 0 || nb <= 0 || block_len % kBN ||
      !m_o != !l_o)
    return cudaErrorInvalidValue;
  Pools<KV> p{static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, layer_off,
              scale_off, S};
#define DEFT_FLATTEN_AT(DD)                                                              \
  if (D == DD)                                                                         \
    return launch_flatten<KV, DD>(q, p, rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l,  \
                                  o, m_o, l_o, R, Hq, Hkv, nb, block_len, n_spans, scale, \
                                  st);
  DEFT_FLATTEN_AT(64)
  DEFT_FLATTEN_AT(128)
  if constexpr (kWide) {
    DEFT_FLATTEN_AT(96)
    DEFT_FLATTEN_AT(256)
  }
#undef DEFT_FLATTEN_AT
  return cudaErrorInvalidValue;
}

}  // namespace deft
