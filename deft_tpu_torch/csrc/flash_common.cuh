// Shared pieces of the tensor-core attention kernels (prefill.cu and the
// flatten kernels of flatten_body.cuh): one thread block owns kBM = 64 folded
// query rows of one KV head, four warps of 16 rows each, and walks KV tiles
// of kBN = 64 tokens staged in shared memory.  Per tile, S = Q K^T and
// O += P V are warp-level products; the online softmax runs in the exp2
// domain on the S fragments held in registers (scores are multiplied by
// scale * log2(e)), with the running max clamped at -1e5 so a fully masked
// row keeps l == 0 and ends at 0 — the convention of the Pallas kernels
// (deft_tpu ops/paged_flatten_attn.py:51-60, ops/prefill.py:61-79).
//
// bf16 tiles use mma.sync.m16n8k16 with fp32 accumulation; P is rounded to
// bf16 for the PV product, as the Pallas kernels cast p to the pool dtype.
// fp32 tiles (the exactness checks) compute the same fragments with FMA
// loops over shared memory, so both types share the layout and the softmax.
//
// int8 KV (Smem<T, D, int8_t>): the tiles arrive as int8 in a staging area
// and are widened to T in shared memory — exact, |x| <= 127 fits bf16's
// 8-bit mantissa — beside the tile's per-token fp32 K and V scales.  The
// scores are multiplied by the K scales after the product and P by the V
// scales before it is rounded for PV, the order of deft_tpu
// ops/paged_quant.py:150-177; l sums the unscaled P.
//
// Head widths: any multiple of 16 (64, 96, 128 and 256 are instantiated).
// Above 128, Q's bf16 A fragments are read from shared memory each tile
// instead of held in registers (D / 16 x 4 words a thread, 64 at D = 256,
// beside the 128 of the O accumulators), and an int8 tile of fp32 T is
// widened straight from device memory, without the staging area that
// would take the block past 227 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace deft {

constexpr int kBM = 64;  // folded query rows per block
constexpr int kBN = 64;  // KV tokens per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;    // masked score
constexpr float kMClamp = -1e5f;  // floor of the running max
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;  // base-2 max to natural log

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b for one 16x8x16 bf16 tile, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory of one block.  The row pitch is padded by 16 bytes so the
// fragment loads (eight rows x four 32-bit words per warp) and the ldmatrix
// row reads hit 32 distinct banks.  KV is the pool's element type: T, or
// int8_t with fp32 scales.
template <typename T, int D, typename KV = T>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kQ = std::is_same<KV, int8_t>::value;
  static constexpr int QS = D + 16 / sizeof(T);  // pitch of Q, K and V tiles
  static constexpr int PS = kBN + 4;             // pitch of the fp32 P tile
  alignas(16) T q[kBM * QS];
  alignas(16) T k[kBN * QS];
  alignas(16) T v[kBN * QS];
  // int8 tiles pass through a staging area, except fp32 tiles above D 128
  static constexpr bool kStage = kQ && !(kF32 && D > 128);
  alignas(16) float p[kF32 ? kWarps * 16 * PS : 4];
  alignas(16) int8_t kst[kStage ? kBN * D : 16];  // int8 tiles as loaded
  alignas(16) int8_t vst[kStage ? kBN * D : 16];
  float ks[kQ ? kBN : 1];  // per-token K and V scales of the tile's head
  float vs[kQ ? kBN : 1];
  long long roff[kBN];  // element offset of each tile token's row, -1: zeros
  long long soff[kQ ? kBN : 1];  // offset of its scales, -1: none
  int lo[kBN];
  int hi[kBN];
};

// Per-thread state: rows g and g + 8 of the warp's 16 rows, where
// g = lane / 4 and tig = lane % 4 index the mma fragment layout.
template <int D>
struct RowState {
  static constexpr bool kQReg = D <= 128;  // Q's fragments held in registers
  uint32_t qa[kQReg ? D / 16 : 1][4];  // bf16 Q A-fragments (unused on fp32)
  float o[D / 8][4];       // O accumulators, C-fragment layout
  float m[2];
  float l[2];
};

// 16-byte asynchronous global -> shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// Wait for every cp.async this thread issued (the caller then syncs).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Start copying `rows` rows of D elements into a tile with row pitch
// `pitch`; row i comes from src + off[i] (off[i] < 0: zeros).  All chunks
// are in flight at once; cp_async_wait_all() + __syncthreads() complete it.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int pitch, const T* __restrict__ src,
                                          const long long* off, int rows) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = off[r] >= 0;
    cp_async16(dst + r * pitch + c * EPC, src + (ok ? off[r] + c * EPC : 0), ok);
  }
}

// Load the K and V tiles of the tokens whose row offsets sit in sm.roff
// (complete on return for this thread; the caller syncs the block).
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(Smem<T, D>& sm, const T* __restrict__ kp,
                                             const T* __restrict__ vp) {
  load_rows<T, D>(sm.k, Smem<T, D>::QS, kp, sm.roff, kBN);
  load_rows<T, D>(sm.v, Smem<T, D>::QS, vp, sm.roff, kBN);
  cp_async_wait_all();
}

// Widen a (kBN, D) int8 tile to T rows of pitch QS, 16 values a step: row
// r from src + r * D (a staged tile), or with `off` from src + off[r] (the
// pool, zeros where off[r] < 0).
template <typename T, int D>
__device__ __forceinline__ void widen_rows(T* dst, const int8_t* src,
                                           const long long* off = nullptr) {
  constexpr int QS = Smem<T, D, int8_t>::QS;
  for (int i = threadIdx.x; i < kBN * D / 16; i += kThreads) {
    const int r = i / (D / 16), c = (i % (D / 16)) * 16;
    int4 raw = make_int4(0, 0, 0, 0);
    if (off == nullptr)
      raw = *reinterpret_cast<const int4*>(src + r * D + c);
    else if (off[r] >= 0)
      raw = *reinterpret_cast<const int4*>(src + off[r] + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    T* d = dst + r * QS + c;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(d + j) = make_float4(b[j], b[j + 1], b[j + 2], b[j + 3]);
    } else {
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = pack_bf16(b[2 * j], b[2 * j + 1]);
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(d + 8) = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// int8 pools: load the int8 K and V tiles of the tokens in sm.roff and their
// scales (offsets in sm.soff) from the (L, Hkv, S) scale pools, then widen
// the tiles to T.  Syncs the block inside; the caller syncs it again before
// reading the tiles.
template <typename T, int D>
__device__ __forceinline__ void load_kv_tile(Smem<T, D, int8_t>& sm,
                                             const int8_t* __restrict__ kp,
                                             const int8_t* __restrict__ vp,
                                             const float* __restrict__ ksp,
                                             const float* __restrict__ vsp) {
  using S = Smem<T, D, int8_t>;
  if constexpr (S::kStage) {
    load_rows<int8_t, D>(sm.kst, D, kp, sm.roff, kBN);
    load_rows<int8_t, D>(sm.vst, D, vp, sm.roff, kBN);
  }
  if (threadIdx.x < kBN) {
    const long long so = sm.soff[threadIdx.x];
    sm.ks[threadIdx.x] = so >= 0 ? ksp[so] : 0.f;
    sm.vs[threadIdx.x] = so >= 0 ? vsp[so] : 0.f;
  }
  if constexpr (S::kStage) {
    cp_async_wait_all();
    __syncthreads();
    widen_rows<T, D>(sm.k, sm.kst);
    widen_rows<T, D>(sm.v, sm.vst);
  } else {
    widen_rows<T, D>(sm.k, kp, sm.roff);
    widen_rows<T, D>(sm.v, vp, sm.roff);
  }
}

// Two transposed 8x8 b16 matrices from shared memory: the B fragment of
// m16n8k16 when B (k x n) is stored row-major, as V[token][dim] is.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a));
}

template <typename T, int D, typename KV>
__device__ __forceinline__ void init_state(RowState<D>& st, const Smem<T, D, KV>& sm) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.o[n][i] = 0.f;
  st.m[0] = st.m[1] = kNeg;
  st.l[0] = st.l[1] = 0.f;
  if constexpr (!Smem<T, D, KV>::kF32 && RowState<D>::kQReg) {
    using S = Smem<T, D, KV>;
    const T* q0 = sm.q + (warp * 16 + g) * S::QS + tig * 2;
    const T* q1 = q0 + 8 * S::QS;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      st.qa[ks][0] = *reinterpret_cast<const uint32_t*>(q0 + ks * 16);
      st.qa[ks][1] = *reinterpret_cast<const uint32_t*>(q1 + ks * 16);
      st.qa[ks][2] = *reinterpret_cast<const uint32_t*>(q0 + ks * 16 + 8);
      st.qa[ks][3] = *reinterpret_cast<const uint32_t*>(q1 + ks * 16 + 8);
    }
  }
}

// s[n][i]: score of the thread's fragment element (row g or g+8, token
// n*8 + tig*2 + (i&1)) times s2 = scale * log2(e) (and the token's K scale
// on int8 pools).
template <typename T, int D, typename KV>
__device__ __forceinline__ void tile_scores(float s[kBN / 8][4], const RowState<D>& st,
                                            const Smem<T, D, KV>& sm, float s2) {
  using S = Smem<T, D, KV>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (S::kF32) {
      const float* q0 = sm.q + (warp * 16 + g) * S::QS;
      const float* q1 = q0 + 8 * S::QS;
      const float* k0 = sm.k + (n * 8 + tig * 2) * S::QS;
      const float* k1 = k0 + S::QS;
      for (int d = 0; d < D; ++d) {
        s[n][0] += q0[d] * k0[d];
        s[n][1] += q0[d] * k1[d];
        s[n][2] += q1[d] * k0[d];
        s[n][3] += q1[d] * k1[d];
      }
    } else {
      const T* kr = sm.k + (n * 8 + g) * S::QS + tig * 2;
      const T* q0 = sm.q + (warp * 16 + g) * S::QS + tig * 2;
      const T* q1 = q0 + 8 * S::QS;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        if constexpr (RowState<D>::kQReg) {
          mma_bf16(s[n], st.qa[ks], b0, b1);
        } else {  // wide heads: Q's fragment from shared memory
          const uint32_t qa[4] = {*reinterpret_cast<const uint32_t*>(q0 + ks * 16),
                                  *reinterpret_cast<const uint32_t*>(q1 + ks * 16),
                                  *reinterpret_cast<const uint32_t*>(q0 + ks * 16 + 8),
                                  *reinterpret_cast<const uint32_t*>(q1 + ks * 16 + 8)};
          mma_bf16(s[n], qa, b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] *= s2;
    if constexpr (S::kQ) {
      const int c = n * 8 + tig * 2;
      s[n][0] *= sm.ks[c];
      s[n][1] *= sm.ks[c + 1];
      s[n][2] *= sm.ks[c];
      s[n][3] *= sm.ks[c + 1];
    }
  }
}

// Online-softmax update with the (already masked) scores of one tile, then
// O += P V.  Masked scores hold kNeg, so exp2 sends them to exactly 0.
template <typename T, int D, typename KV>
__device__ __forceinline__ void tile_update(float s[kBN / 8][4], RowState<D>& st,
                                            Smem<T, D, KV>& sm) {
  using S = Smem<T, D, KV>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // h = 0: row g, h = 1: row g + 8
    float mx = kNeg;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(st.m[h], mx), kMClamp);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      s[n][2 * h] = exp2f(s[n][2 * h] - m_new);
      s[n][2 * h + 1] = exp2f(s[n][2 * h + 1] - m_new);
      sum += s[n][2 * h] + s[n][2 * h + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    alpha[h] = exp2f(st.m[h] - m_new);
    st.l[h] = st.l[h] * alpha[h] + sum;
    st.m[h] = m_new;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }
  if constexpr (S::kQ) {  // P times the V scales, after l took the unscaled P
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const int c = n * 8 + tig * 2;
      s[n][0] *= sm.vs[c];
      s[n][1] *= sm.vs[c + 1];
      s[n][2] *= sm.vs[c];
      s[n][3] *= sm.vs[c + 1];
    }
  }
  if constexpr (S::kF32) {
    float* pw = sm.p + warp * 16 * S::PS;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const int c = n * 8 + tig * 2;
      pw[g * S::PS + c] = s[n][0];
      pw[g * S::PS + c + 1] = s[n][1];
      pw[(g + 8) * S::PS + c] = s[n][2];
      pw[(g + 8) * S::PS + c + 1] = s[n][3];
    }
    __syncwarp();
    const float* p0 = pw + g * S::PS;
    const float* p1 = p0 + 8 * S::PS;
    for (int n = 0; n < D / 8; ++n) {
      const float* vc = sm.v + n * 8 + tig * 2;
      for (int t = 0; t < kBN; ++t) {
        const float v0 = vc[t * S::QS], v1 = vc[t * S::QS + 1];
        st.o[n][0] += p0[t] * v0;
        st.o[n][1] += p0[t] * v1;
        st.o[n][2] += p1[t] * v0;
        st.o[n][3] += p1[t] * v1;
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      // lanes 0-15 address the 16 token rows of this k-step
      const T* vrow = sm.v + (kk * 16 + lane % 16) * S::QS;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + n * 8);
        mma_bf16(st.o[n], a, b0, b1);
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace deft
