// Grouped matmul of the MoE prefill: out[r] = x[r] @ w[tile_eid[r / 128]],
// times the expert's per-column scale when w is int8.
//
// Replaces the Pallas TPU kernels B10, deft_tpu/ops/gmm.py:37 (_gmm_kernel)
// and :58 (_gmm_scaled_kernel), both launched by gmm :72.  x (M, E) bf16 or
// fp32, its rows sorted by expert and padded so that every 128-row tile
// belongs to one expert; w (NE, E, F) of x's type, or int8 codes with fp32
// scales (NE, F); tile_eid (M / 128,) int32 names each row tile's expert.
// out (M, F) in x's type.  The product accumulates in fp32; the scale
// multiplies the fp32 sum and one cast follows, the order of the Pallas
// kernel (gmm.py:50-55).  A tile_eid outside [0, NE) fills its tile with NaN,
// so a bad dispatch shows in the output instead of reading stray memory.
//
// Bound on this card: operations.  At Mixtral-8x7B prefill (4000 tokens x
// top-2 over 8 experts: M = 9088 padded rows; wg/wu E = 4096, F = 14336) one
// call is 2 M E F = 1.07 TFLOP, 1.08 ms at 989 TFLOP/s bf16, against 0.38 ms
// for its bytes (each expert's weights once, x and out once).  Design, simple
// first: one block per (128-row tile, 128-column tile), row tiles varying
// fastest, so the blocks in flight share an expert's weight column tile
// through L2; each block reads its own tile_eid (a GPU has no scalar
// prefetch).  Eight warps each own a 64 x 32 piece of the tile.  A ring of
// four cp.async stages of 32-deep x and w tiles keeps three in flight while
// mma.sync m16n8k16 (bf16 in, fp32 accumulators) consumes the fourth, its
// fragments loaded by ldmatrix.  int8 w tiles are widened to bf16 in shared
// memory (exact: |w| <= 127 fits bf16's 8-bit mantissa), as B9 does; fp32 x
// runs FMA loops over the same tiles (for the exactness checks).  The scale
// and the cast are the epilogue.  wgmma, TMA and a persistent schedule are
// the steps toward the bound.
#include "flash_common.cuh"

namespace deft {
namespace gmm {

constexpr int kBM = 128;  // rows per tile (deft_tpu's tile_m)
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 32;   // E rows per stage
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWM = 64, kWN = 32;             // a warp's piece of the tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;  // its m16 and n8 fragments

// Shared memory: kStages x (x tile, w tile as loaded), plus the widened w
// tile for int8 weights.  Row pitches are padded by 16 bytes so ldmatrix rows
// and fragment loads hit distinct banks.
template <typename T, typename W>
struct Layout {
  static constexpr bool kQ = std::is_same<W, int8_t>::value;
  static constexpr int XP = kBK + 16 / sizeof(T);  // x tile pitch
  static constexpr int WP = kBN + 16 / sizeof(T);  // w tile pitch, as T
  static constexpr int SP = kQ ? kBN : WP;         // staged w tile pitch
  static constexpr size_t kX = size_t(kBM) * XP * sizeof(T);
  static constexpr size_t kWs = size_t(kBK) * SP * sizeof(W);
  static constexpr size_t kWb = kQ ? size_t(kBK) * WP * sizeof(T) : 0;
  static constexpr size_t kBytes = kStages * (kX + kWs) + kWb;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Four 8x8 b16 matrices: the A fragment of m16n8k16 (row-major A), lane i
// addressing row i % 16, column (i / 16) * 8 of the 16 x 16 piece.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Four transposed 8x8 b16 matrices: the B fragments of two neighbouring n8
// tiles when B (k x n) is stored row-major, lane i addressing row i % 16,
// column (i / 16) * 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Start copying stage k0 (E rows [k0, k0 + kBK)) of the block's x rows and
// of its expert's w column tile; x and w point at the tile's origin.
template <typename T, typename W>
__device__ __forceinline__ void load_stage(T* xs, W* ws, const T* __restrict__ x,
                                           const W* __restrict__ w, int k0, int E, int F) {
  using L = Layout<T, W>;
  constexpr int XE = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int XC = kBK / XE;        // chunks per x row
  for (int i = threadIdx.x; i < kBM * XC; i += kThreads) {
    const int r = i / XC, c = i % XC;
    cp_async16(xs + r * L::XP + c * XE, x + (long long)r * E + k0 + c * XE, true);
  }
  constexpr int WE = 16 / sizeof(W);
  constexpr int WC = kBN / WE;  // chunks per w row
  for (int i = threadIdx.x; i < kBK * WC; i += kThreads) {
    const int r = i / WC, c = i % WC;
    cp_async16(ws + r * L::SP + c * WE, w + (long long)(k0 + r) * F + c * WE, true);
  }
}

// Widen a staged (kBK, kBN) int8 tile to T rows of pitch WP, 16 at a step.
template <typename T>
__device__ __forceinline__ void widen(T* dst, const int8_t* src) {
  using L = Layout<T, int8_t>;
  for (int i = threadIdx.x; i < kBK * kBN / 16; i += kThreads) {
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * kBN + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    T* d = dst + r * L::WP + c;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        *reinterpret_cast<float4*>(d + j) = make_float4(b[j], b[j + 1], b[j + 2], b[j + 3]);
    } else {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = pack_bf16(b[2 * j], b[2 * j + 1]);
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(d + 8) = make_uint4(v[4], v[5], v[6], v[7]);
    }
  }
}

// acc += the warp's 64 x 32 piece of x-stage times w-stage, in the mma
// C-fragment layout: acc[m][n] holds rows m * 16 + g (+ 8), columns
// n * 8 + tig * 2 (+ 1) of the piece.
template <typename T, typename W>
__device__ __forceinline__ void stage_product(float acc[kMT][kNT][4], const T* xs,
                                              const T* wt) {
  using L = Layout<T, W>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / (kBN / kWN)) * kWM, wn = (warp % (kBN / kWN)) * kWN;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < kBK; ++k) {
      float bv[kNT][2];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float* wp = wt + k * L::WP + wn + n * 8 + tig * 2;
        bv[n][0] = wp[0];
        bv[n][1] = wp[1];
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float x0 = xs[(wm + m * 16 + g) * L::XP + k];
        const float x1 = xs[(wm + m * 16 + g + 8) * L::XP + k];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[m][n][0] += x0 * bv[n][0];
          acc[m][n][1] += x0 * bv[n][1];
          acc[m][n][2] += x1 * bv[n][0];
          acc[m][n][3] += x1 * bv[n][1];
        }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int m = 0; m < kMT; ++m)
        ldmatrix_x4(a[m], xs + (wm + m * 16 + lane % 16) * L::XP + ks * 16 + (lane / 16) * 8);
      uint32_t b[kNT / 2][4];  // b[p]: b0, b1 of n-tile 2p, then of 2p + 1
#pragma unroll
      for (int p = 0; p < kNT / 2; ++p)
        ldmatrix_x4_trans(b[p], wt + (ks * 16 + lane % 16) * L::WP + wn + p * 16 + (lane / 16) * 8);
#pragma unroll
      for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          mma_bf16(acc[m][n], a[m], b[n / 2][(n % 2) * 2], b[n / 2][(n % 2) * 2 + 1]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// One block: rows [t * kBM, + kBM) times expert tile_eid[t]'s columns
// [n0, n0 + kBN).  blockIdx.x = t (fastest), blockIdx.y = column tile.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const T* __restrict__ x, const W* __restrict__ w, const float* __restrict__ scale,
               const int* __restrict__ tile_eid, T* __restrict__ out, int E, int F, int NE) {
  using L = Layout<T, W>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  W* ws = reinterpret_cast<W*>(smem + kStages * L::kX);
  T* wb = reinterpret_cast<T*>(smem + kStages * (L::kX + L::kWs));
  const int t = blockIdx.x;
  const long long row0 = (long long)t * kBM;
  const int n0 = blockIdx.y * kBN;
  const int eid = tile_eid[t];
  if (eid < 0 || eid >= NE) {  // uniform over the block: no barrier is skipped unevenly
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads)
      out[(row0 + i / kBN) * F + n0 + i % kBN] = from_f<T>(__int_as_float(0x7fc00000));
    return;
  }
  const T* xt = x + row0 * E;
  const W* wt = w + (long long)eid * E * F + n0;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int nk = E / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T, W>(xs + s * (L::kX / sizeof(T)), ws + s * (L::kWs / sizeof(W)), xt, wt,
                       s * kBK, E, F);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kStages - 2>();  // stage c has landed (for this thread)
    __syncthreads();               // ... for every thread; stage c - 1 is consumed
    const int nxt = c + kStages - 1;
    if (nxt < nk) {
      const int s = nxt % kStages;
      load_stage<T, W>(xs + s * (L::kX / sizeof(T)), ws + s * (L::kWs / sizeof(W)), xt, wt,
                       nxt * kBK, E, F);
    }
    cp_async_commit();
    const int s = c % kStages;
    const T* xstage = xs + s * (L::kX / sizeof(T));
    if constexpr (L::kQ) {
      widen<T>(wb, ws + s * (L::kWs / sizeof(W)));
      __syncthreads();
      stage_product<T, W>(acc, xstage, wb);
    } else {
      stage_product<T, W>(acc, xstage, ws + s * (L::kWs / sizeof(W)));
    }
  }
  cp_async_wait<0>();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / (kBN / kWN)) * kWM, wn = (warp % (kBN / kWN)) * kWN;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n0 + wn + n * 8 + tig * 2;
    float s0 = 1.f, s1 = 1.f;
    if (scale != nullptr) {
      s0 = scale[(long long)eid * F + col];
      s1 = scale[(long long)eid * F + col + 1];
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long r = row0 + wm + m * 16 + g + 8 * hh;
        store2(out + r * F + col, acc[m][n][2 * hh] * s0, acc[m][n][2 * hh + 1] * s1);
      }
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, const float* scale, const int* tile_eid,
                   void* out, int M, int E, int F, int NE, cudaStream_t stream) {
  using L = Layout<T, W>;
  auto kernel = gmm_kernel<T, W>;
  static const cudaError_t attr = allow_smem(kernel, L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(M / kBM, F / kBN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const W*>(w), scale, tile_eid,
                                                 static_cast<T*>(out), E, F, NE);
  return cudaGetLastError();
}

}  // namespace gmm
}  // namespace deft

// dtype: 0 = float32, 1 = bfloat16 (x and out).  w_int8: 0 = w of x's type
// (scale must be null), 1 = int8 codes with scale (NE, F) fp32.  x (M, E),
// w (NE, E, F), tile_eid (M / 128,) int32, out (M, F), all contiguous and
// 16-byte aligned; M % 128 == 0, E % 32 == 0, F % 128 == 0.  Returns a
// cudaError_t code.
extern "C" int deft_gmm(const void* x, const void* w, const float* scale, const int* tile_eid,
                        void* out, int M, int E, int F, int NE, int dtype, int w_int8,
                        void* stream) {
  using namespace deft::gmm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || E <= 0 || F <= 0 || NE <= 0 || M % kBM || E % kBK || F % kBN ||
      (w_int8 != 0) != (scale != nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return w_int8 ? launch<__nv_bfloat16, int8_t>(x, w, scale, tile_eid, out, M, E, F, NE, s)
                  : launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, tile_eid, out, M, E,
                                                         F, NE, s);
  if (dtype == 0)
    return w_int8 ? launch<float, int8_t>(x, w, scale, tile_eid, out, M, E, F, NE, s)
                  : launch<float, float>(x, w, scale, tile_eid, out, M, E, F, NE, s);
  return cudaErrorInvalidValue;
}
