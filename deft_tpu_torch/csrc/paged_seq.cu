// Sequential per-leaf decode attention reading paged KV in the kernel: the
// fair seq (Flash-Decoding) baseline DeFT is compared with.
//
// Replaces the Pallas TPU kernel deft_tpu/ops/paged_seq_attn.py:41
// (_paged_seq_kernel, launched by _paged_seq_call :246 for paged_seq_attention
// :328).  Leaf r's root-to-leaf path is the live spans of its segments:
// segment j of leaf r covers pool rows seg_src + seg_off .. + seg_live
// (plan/seq.py), in path order; blocks with blk_live == 0 hold no live token.
// Every leaf re-reads its whole path, shared prefix included: that re-read is
// the baseline's defining cost and is kept on purpose.
//
// Bound on this card: bytes.  The per-leaf path bytes summed over leaves,
// sum_r len_r * Hkv * D * 2 * itemsize per layer, against 3.35 TB/s; with
// qpk query rows per KV head there are only ~2 * qpk FLOPs per byte, so
// tensor cores would idle.  Design: one block per (leaf, KV head).  Warp 0
// prefix-sums the segments' live counts once, so tile i of 64 path tokens
// maps to pool rows by a binary search and every tile holds only live
// tokens (the segments' dead lead-ins and tails are never read); K and V
// tiles are staged in shared memory with 16-byte loads, scores and P V are
// fp32 FMA loops, and the softmax is online in the exp2 domain, as in the
// TPU kernel.  On bf16 inputs P is rounded to bf16 for P V, as the TPU
// kernel and paged_flatten.cu round it, so the two decode modes differ by
// summation order rather than by where they round.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace deft_seq {

constexpr int kBN = 64;  // path tokens per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQpk = 8;
constexpr float kNeg = -1e30f;
constexpr float kMClamp = -1e5f;
constexpr float kLog2e = 1.4426950408889634f;

// fp32 tile rows are only 4-byte aligned (odd pitch): two scalar loads
__device__ __forceinline__ float2 to_f2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// P as the PV product takes it: in the pool's type, as the TPU kernel casts
// p (deft_tpu ops/paged_seq_attn.py:220) and as paged_flatten.cu does.
template <typename T>
__device__ __forceinline__ float round_p(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory: K/V tiles with an odd number of 32-bit words per row, so a
// warp reading one word from each of 32 token rows hits 32 banks.
template <typename T, int D>
struct SeqSmem {
  static constexpr int KS = D + 4 / sizeof(T);  // bf16: D + 2, fp32: D + 1
  T k[kBN * KS];
  T v[kBN * KS];
  float q[kMaxQpk * D];       // queries times scale * log2(e)
  float p[kMaxQpk * kBN];     // scores, then probabilities
  float alpha[kMaxQpk];
  float m[kMaxQpk];
  float l[kMaxQpk];
  long long roff[kBN];
  // followed by int cum[nseg + 1] (dynamic)
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    seq_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
               const T* __restrict__ v_pool, T* __restrict__ o, long long layer_off,
               const int* __restrict__ seg_src, const int* __restrict__ seg_off,
               const int* __restrict__ seg_live, const int* __restrict__ blk_live, int Hq,
               int Hkv, int nseg, int spb, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = SeqSmem<T, D>;
  S& sm = *reinterpret_cast<S*>(smem_raw);
  int* cum = reinterpret_cast<int*>(smem_raw + sizeof(S));
  const int leaf = blockIdx.x, h = blockIdx.y;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* src = seg_src + (long long)leaf * nseg;
  const int* off = seg_off + (long long)leaf * nseg;
  const int* live = seg_live + (long long)leaf * nseg;
  const int* blive = blk_live + (long long)leaf * (nseg / spb);

  // inclusive prefix sum of live counts: cum[j] = live tokens before segment j
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) cum[0] = 0;
    for (int j0 = 0; j0 < nseg; j0 += 32) {
      const int j = j0 + lane;
      int x = (j < nseg && blive[j / spb] > 0) ? live[j] : 0;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (j < nseg) cum[j + 1] = carry + x;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  for (int i = tid; i < qpk * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sm.q[i] = float(q[((long long)leaf * Hq + h * qpk + g) * D + d]) * s2;
  }
  if (tid < qpk) {
    sm.m[tid] = kNeg;
    sm.l[tid] = 0.f;
  }
  __syncthreads();
  const int total = cum[nseg];

  // each thread owns output pairs (row, d..d+1), idx = tid + k * kThreads
  constexpr int kPairs = (kMaxQpk * D / 2 + kThreads - 1) / kThreads;
  float2 acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = make_float2(0.f, 0.f);

  for (int i0 = 0; i0 < total; i0 += kBN) {
    const int n = min(kBN, total - i0);
    if (tid < kBN) {
      long long ro = -1;
      if (tid < n) {
        const int i = i0 + tid;
        int a = 0, b = nseg;  // largest j with cum[j] <= i
        while (b - a > 1) {
          const int c = (a + b) / 2;
          if (cum[c] <= i) a = c; else b = c;
        }
        const int row = src[a] + off[a] + (i - cum[a]);
        ro = layer_off + ((long long)row * Hkv + h) * D;
      }
      sm.roff[tid] = ro;
    }
    __syncthreads();
    // 16-byte chunks, kBatch per thread in flight before any is stored (a
    // load feeding a store in the same iteration would wait for each load)
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = D / EPC;
    constexpr int kIters = kBN * CPR / kThreads;
    constexpr int kBatch = kIters < 8 ? kIters : 8;
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
          kv[u] = *reinterpret_cast<const uint4*>(k_pool + ro + (i % CPR) * EPC);
          vv[u] = *reinterpret_cast<const uint4*>(v_pool + ro + (i % CPR) * EPC);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * kThreads;
        const int t = i / CPR, c = i % CPR;
        // rows are 4-byte aligned only (odd word pitch): store word by word
        uint32_t* kd = reinterpret_cast<uint32_t*>(sm.k + t * S::KS + c * EPC);
        uint32_t* vd = reinterpret_cast<uint32_t*>(sm.v + t * S::KS + c * EPC);
        kd[0] = kv[u].x; kd[1] = kv[u].y; kd[2] = kv[u].z; kd[3] = kv[u].w;
        vd[0] = vv[u].x; vd[1] = vv[u].y; vd[2] = vv[u].z; vd[3] = vv[u].w;
      }
    }
    __syncthreads();
    // scores: one (row, token) pair per thread and pass
    for (int i = tid; i < qpk * kBN; i += kThreads) {
      const int g = i / kBN, t = i % kBN;
      float s = kNeg;
      if (t < n) {
        const float* qr = sm.q + g * D;
        const T* kr = sm.k + t * S::KS;
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 2) {
          const float2 kk = to_f2(kr + d);
          a += qr[d] * kk.x + qr[d + 1] * kk.y;
        }
        s = a;
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
      pr[lane] = round_p<T>(p0);
      pr[lane + 32] = round_p<T>(p1);
      float sum = p0 + p1;  // l sums the unrounded P
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

#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < qpk * D / 2) {
      const int g = idx / (D / 2), d = (idx % (D / 2)) * 2;
      const float l = sm.l[g];
      const float inv = l == 0.f ? 0.f : 1.f / l;
      store2(o + ((long long)leaf * Hq + h * qpk + g) * D + d, acc[k].x * inv, acc[k].y * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, void* o,
                   long long layer_off, const int* seg_src, const int* seg_off,
                   const int* seg_live, const int* blk_live, int R, int Hq, int Hkv,
                   int nseg, int spb, float scale, cudaStream_t stream) {
  auto kernel = seq_kernel<T, D>;
  const size_t smem = sizeof(SeqSmem<T, D>) + sizeof(int) * (nseg + 1);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  dim3 grid(R, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<T*>(o), layer_off, seg_src, seg_off,
      seg_live, blk_live, Hq, Hkv, nseg, spb, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace deft_seq

// dtype: 0 = float32, 1 = bfloat16.  q, o: (R, Hq, D); pools (L, S, Hkv*D);
// layer_off = li * S * Hkv * D; seg_src/off/live (R * nseg,); blk_live
// (R * nseg / spb,).  Returns a cudaError_t code (0 = launched).
extern "C" int deft_paged_seq(const void* q, const void* k_pool, const void* v_pool,
                              void* o, long long layer_off, const int* seg_src,
                              const int* seg_off, const int* seg_live,
                              const int* blk_live, int R, int Hq, int Hkv, int D,
                              int nseg, int spb, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > deft_seq::kMaxQpk || spb <= 0 ||
      nseg % spb)
    return cudaErrorInvalidValue;
#define DEFT_SEQ(T, DD)                                                                \
  return deft_seq::launch<T, DD>(q, k_pool, v_pool, o, layer_off, seg_src, seg_off,    \
                                 seg_live, blk_live, R, Hq, Hkv, nseg, spb, scale, s)
  if (dtype == 1 && D == 128) DEFT_SEQ(__nv_bfloat16, 128);
  if (dtype == 1 && D == 64) DEFT_SEQ(__nv_bfloat16, 64);
  if (dtype == 0 && D == 128) DEFT_SEQ(float, 128);
  if (dtype == 0 && D == 64) DEFT_SEQ(float, 64);
#undef DEFT_SEQ
  return cudaErrorInvalidValue;
}
