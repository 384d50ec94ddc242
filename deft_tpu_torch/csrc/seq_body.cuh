// The sequential per-leaf decode kernel over fp32 q (the exactness checks),
// shared by paged_seq.cu (B2, B5: each leaf's path read through its segment
// table) and seq_gather.cu (B7: through its padded row of pool indices),
// over fp32 pools or int8 pools with fp32 scales, at head_dim 64 and 128
// and, over path tables, 96 and 256.  bf16 q runs the tensor-core bodies of
// seq_q_body.cuh at every width instead; this body takes no bf16.
//
// One block per (leaf, KV head) walks the leaf's path in tiles of 64 tokens,
// each holding only live path tokens.  K and V tiles are staged in shared
// memory with 16-byte loads (int8 tiles widened to fp32 as they are
// stored); scores and P V are fp32 FMA loops, with ~2 * qpk FLOPs per byte
// the tensor cores would idle; the softmax is online in the exp2 domain, as
// in the TPU kernels, and P stays fp32 (the q type).  int8 pools: scores
// times the token's K scale after the product, P times its V scale, l over
// the unscaled P (deft_tpu ops/paged_seq_attn.py:197-222).
// Every leaf re-reads its whole path, shared prefix included: that re-read
// is the baseline's defining cost and is kept on purpose.
//
// Partial form (m_out != null; deft_tpu's partial=True entries, which its
// multi-device engine runs on each rank's span of every leaf's path blocks):
// the epilogue writes the unnormalised state, acc (R, Hq, D) fp32, m in
// natural-log units (the running base-2 max times ln 2) and l, (R, Hq) each,
// in place of acc / l.  A leaf that sees no token keeps m = kNeg * ln 2,
// finite, so a merge across devices never computes inf - inf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"

namespace deft_seq {

constexpr int kBN = 64;  // path tokens per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQpk = 8;
constexpr float kNeg = -1e30f;
constexpr float kMClamp = -1e5f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tile rows are only 4-byte aligned (odd pitch): two scalar loads
__device__ __forceinline__ float2 to_f2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Paged plans: leaf r's path is the live spans of its segments, segment j
// covering pool rows seg_src + seg_off .. + seg_live, in path order; blocks
// with blk_live == 0 hold no live token.
struct SegPath {
  const int* seg_src;
  const int* seg_off;
  const int* seg_live;
  const int* blk_live;
  int nseg;  // segments per leaf
  int spb;   // segments per block
};

// Gather plans: leaf r's path is paths[r, c] for c < seq_lens[r].
struct IdxPath {
  const int* paths;
  const int* seq_lens;
  int C;  // padded path length
};

// KV pools: (L, S, Hkv*D) of KV, plus (L, Hkv, S) fp32 scales for int8.
template <typename KV>
struct SeqPools {
  const KV* k;
  const KV* v;
  const float* ks;  // int8 only
  const float* vs;
  long long layer_off;  // li * S * Hkv * D
  long long scale_off;  // li * Hkv * S
  int S;
};

// Shared memory: K/V tiles with an odd number of 32-bit words per row, so a
// warp reading one word from each of 32 token rows hits 32 banks.
template <int D, typename KV>
struct SeqSmem {
  static constexpr bool kQ = std::is_same<KV, int8_t>::value;
  static constexpr int KS = D + 1;
  float k[kBN * KS];
  float v[kBN * KS];
  float q[kMaxQpk * D];       // queries times scale * log2(e)
  float p[kMaxQpk * kBN];     // scores, then probabilities
  float alpha[kMaxQpk];
  float m[kMaxQpk];
  float l[kMaxQpk];
  float ks[kQ ? kBN : 1];     // per-token K and V scales of the tile's head
  float vs[kQ ? kBN : 1];
  long long roff[kBN];
  // followed by int cum[nseg + 1] (dynamic, paged plans)
};

// Store one 16-byte chunk of KV (fp32, or int8 widened) as fp32 values at
// dst (4-byte aligned).
template <typename KV>
__device__ __forceinline__ void store_chunk(float* dst, const uint4& c) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  if constexpr (std::is_same<KV, float>::value) {
    d[0] = c.x; d[1] = c.y; d[2] = c.z; d[3] = c.w;
  } else {
    const int8_t* b = reinterpret_cast<const int8_t*>(&c);
#pragma unroll
    for (int j = 0; j < 16; ++j) d[j] = __float_as_uint(float(b[j]));
  }
}

// q, o and the partial form's acc are fp32.
template <typename KV, int D, typename Path>
__global__ void __launch_bounds__(kThreads)
    seq_kernel(const float* __restrict__ q, SeqPools<KV> pools, Path path,
               void* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
               int Hq, int Hkv, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = SeqSmem<D, KV>;
  constexpr bool kPaged = std::is_same<Path, SegPath>::value;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  int* cum = reinterpret_cast<int*>(smem_raw + sizeof(S));
  const int leaf = blockIdx.x, h = blockIdx.y;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  int total;
  if constexpr (kPaged) {
    const int nseg = path.nseg;
    const int* live = path.seg_live + (long long)leaf * nseg;
    const int* blive = path.blk_live + (long long)leaf * (nseg / path.spb);
    // inclusive prefix sum of live counts: cum[j] = live tokens before segment j
    if (warp == 0) {
      int carry = 0;
      if (lane == 0) cum[0] = 0;
      for (int j0 = 0; j0 < nseg; j0 += 32) {
        const int j = j0 + lane;
        int x = (j < nseg && blive[j / path.spb] > 0) ? live[j] : 0;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int y = __shfl_up_sync(0xffffffffu, x, d);
          if (lane >= d) x += y;
        }
        if (j < nseg) cum[j + 1] = carry + x;
        carry += __shfl_sync(0xffffffffu, x, 31);
      }
    }
  }
  for (int i = tid; i < qpk * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sm.q[i] = q[((long long)leaf * Hq + h * qpk + g) * D + d] * s2;
  }
  if (tid < qpk) {
    sm.m[tid] = kNeg;
    sm.l[tid] = 0.f;
  }
  __syncthreads();
  if constexpr (kPaged) total = cum[path.nseg];
  else total = path.seq_lens[leaf];

  // each thread owns output pairs (row, d..d+1), idx = tid + k * kThreads
  constexpr int kPairs = (kMaxQpk * D / 2 + kThreads - 1) / kThreads;
  float2 acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = make_float2(0.f, 0.f);

  for (int i0 = 0; i0 < total; i0 += kBN) {
    const int n = min(kBN, total - i0);
    if (tid < kBN) {
      long long ro = -1;
      float ksc = 0.f, vsc = 0.f;
      if (tid < n) {
        const int i = i0 + tid;
        int row;
        if constexpr (kPaged) {
          const long long base = (long long)leaf * path.nseg;
          int a = 0, b = path.nseg;  // largest j with cum[j] <= i
          while (b - a > 1) {
            const int c = (a + b) / 2;
            if (cum[c] <= i) a = c; else b = c;
          }
          row = path.seg_src[base + a] + path.seg_off[base + a] + (i - cum[a]);
        } else {
          row = path.paths[(long long)leaf * path.C + i];
        }
        ro = pools.layer_off + ((long long)row * Hkv + h) * D;
        if constexpr (S::kQ) {
          const long long so = pools.scale_off + (long long)h * pools.S + row;
          ksc = pools.ks[so];
          vsc = pools.vs[so];
        }
      }
      sm.roff[tid] = ro;
      if constexpr (S::kQ) {
        sm.ks[tid] = ksc;
        sm.vs[tid] = vsc;
      }
    }
    __syncthreads();
    // 16-byte chunks, kBatch per thread in flight before any is stored (a
    // load feeding a store in the same iteration would wait for each load)
    constexpr int EPC = 16 / sizeof(KV);
    constexpr int CPR = D / EPC;
    constexpr int kIters = kBN * CPR / kThreads;
    constexpr int kBatch = kIters <= 8 ? kIters : kIters % 8 == 0 ? 8 : 6;
    static_assert(kIters * kThreads == kBN * CPR && kIters % kBatch == 0, "tile split");
#pragma unroll
    for (int u0 = 0; u0 < kIters; u0 += kBatch) {
      uint4 kv[kBatch], vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * kThreads;
        const long long ro = sm.roff[i / CPR];
        kv[u] = vv[u] = make_uint4(0, 0, 0, 0);
        if (ro >= 0) {
          kv[u] = *reinterpret_cast<const uint4*>(pools.k + ro + (i % CPR) * EPC);
          vv[u] = *reinterpret_cast<const uint4*>(pools.v + ro + (i % CPR) * EPC);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * kThreads;
        const int t = i / CPR, c = i % CPR;
        // rows are 4-byte aligned only (odd word pitch): stored word by word
        store_chunk<KV>(sm.k + t * S::KS + c * EPC, kv[u]);
        store_chunk<KV>(sm.v + t * S::KS + c * EPC, vv[u]);
      }
    }
    __syncthreads();
    // scores: one (row, token) pair per thread and pass
    for (int i = tid; i < qpk * kBN; i += kThreads) {
      const int g = i / kBN, t = i % kBN;
      float s = kNeg;
      if (t < n) {
        const float* qr = sm.q + g * D;
        const float* kr = sm.k + t * S::KS;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 2) {
          const float2 kk = to_f2(kr + d);
          a += qr[d] * kk.x + qr[d + 1] * kk.y;
        }
        s = a;
        if constexpr (S::kQ) s *= sm.ks[t];
      }
      sm.p[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int g = warp; g < qpk; g += kWarps) {
      float* pr = sm.p + g * kBN;
      float mx = fmaxf(pr[lane], pr[lane + 32]);
#pragma unroll
      for (int d = 16; d > 0; d /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(fmaxf(m_old, mx), kMClamp);
      const float p0 = exp2f(pr[lane] - m_new), p1 = exp2f(pr[lane + 32] - m_new);
      float w0 = p0, w1 = p1;
      if constexpr (S::kQ) {
        w0 *= sm.vs[lane];
        w1 *= sm.vs[lane + 32];
      }
      pr[lane] = w0;
      pr[lane + 32] = w1;
      float sum = p0 + p1;  // l sums the unrounded, unscaled P
#pragma unroll
      for (int d = 16; d > 0; d /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, d);
      __syncwarp();
      if (lane == 0) {
        const float a = exp2f(m_old - m_new);
        sm.alpha[g] = a;
        sm.l[g] = sm.l[g] * a + sum;
        sm.m[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < qpk * D / 2) {
        const int g = idx / (D / 2), d = (idx % (D / 2)) * 2;
        const float a = sm.alpha[g];
        float2 r = make_float2(acc[k].x * a, acc[k].y * a);
        const float* pr = sm.p + g * kBN;
        for (int t = 0; t < n; ++t) {
          const float2 vv = to_f2(sm.v + t * S::KS + d);
          r.x += pr[t] * vv.x;
          r.y += pr[t] * vv.y;
        }
        acc[k] = r;
      }
    }
    __syncthreads();  // tiles and p are rewritten next
  }

  if (m_out) {  // partial form: the unnormalised state
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < qpk * D / 2) {
        const int g = idx / (D / 2), d = (idx % (D / 2)) * 2;
        store2(static_cast<float*>(o) + ((long long)leaf * Hq + h * qpk + g) * D + d,
               acc[k].x, acc[k].y);
      }
    }
    if (tid < qpk) {
      const long long r = (long long)leaf * Hq + h * qpk + tid;
      m_out[r] = sm.m[tid] * kLn2;
      l_out[r] = sm.l[tid];
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < qpk * D / 2) {
      const int g = idx / (D / 2), d = (idx % (D / 2)) * 2;
      const float l = sm.l[g];
      const float inv = l == 0.f ? 0.f : 1.f / l;
      store2(static_cast<float*>(o) + ((long long)leaf * Hq + h * qpk + g) * D + d,
             acc[k].x * inv, acc[k].y * inv);
    }
  }
}

// m_out, l_out: null for the normalised output o (R, Hq, D); else the
// partial form.
template <typename KV, int D, typename Path>
cudaError_t launch_seq(const void* q, SeqPools<KV> pools, Path path, void* o, float* m_out,
                       float* l_out, int R, int Hq, int Hkv, size_t dyn_smem, float scale,
                       cudaStream_t stream) {
  auto kernel = seq_kernel<KV, D, Path>;
  const size_t smem = sizeof(SeqSmem<D, KV>) + dyn_smem;
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid(R, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), pools, path, o, m_out,
                                           l_out, Hq, Hkv, scale * kLog2e);
  return cudaGetLastError();
}

// Check the sizes, then instantiate launch_seq for head_dim 64 and 128, and
// with kWide (the gather entry) 96 and 256; the pools hold KV (fp32, or
// int8 with scales).  dyn_smem: bytes of the path's dynamic shared memory.
// m_out, l_out: see launch_seq.
template <typename KV, bool kWide, typename Path>
cudaError_t dispatch_seq(const void* q, const void* k, const void* v, const float* ks,
                         const float* vs, void* o, float* m_out, float* l_out,
                         long long layer_off, long long scale_off, int S, Path path,
                         size_t dyn_smem, int R, int Hq, int Hkv, int D, float scale,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > kMaxQpk || !m_out != !l_out)
    return cudaErrorInvalidValue;
  SeqPools<KV> p{static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, layer_off,
                 scale_off, S};
#define DEFT_SEQ_AT(DD)                                                                  \
  if (D == DD)                                                                         \
    return launch_seq<KV, DD>(q, p, path, o, m_out, l_out, R, Hq, Hkv, dyn_smem, scale, st);
  DEFT_SEQ_AT(64)
  DEFT_SEQ_AT(128)
  if constexpr (kWide) {
    DEFT_SEQ_AT(96)
    DEFT_SEQ_AT(256)
  }
#undef DEFT_SEQ_AT
  return cudaErrorInvalidValue;
}

}  // namespace deft_seq
