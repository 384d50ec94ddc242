// Weight-only int8 matmul for decode-sized activations: out = (x @ w) * scale.
//
// Replaces the Pallas TPU kernel B9, deft_tpu/ops/int8_matmul.py:44 (_kernel,
// launched by int8_matmul :64).  x (R, H) bf16 or fp32, w (H, I) int8 codes,
// scale (I,) fp32 per output column; out (R, I) in x's type.  The product
// accumulates in fp32 and the scale is applied once at the end, in the
// order of deft_tpu's int8 expression (models/llama.py:150): the product
// rounded to x's type, times the scale in fp32, then cast.  (The TPU kernel
// scales the fp32 sum unrounded; in bf16 the two differ by at most one
// rounding of the product.)
//
// Bound on this card: bytes.  Decode has R <= 256 rows, so the H * I int8
// weight bytes, each read once, dwarf x and out: 2 * R FLOPs a weight byte
// against the ~295 the bf16 tensor cores need before they, and not the
// 3.35 TB/s of HBM, are the limit.  Design: one block per 128 output columns
// and span of the H axis; int8 weight tiles (128 x 128) and x tiles arrive
// by cp.async into two stages, so the next tile is in flight while this one
// is used; the int8 tile is widened to bf16 in shared memory (exact: |w| <=
// 127 fits bf16's 8-bit mantissa) and fed to mma.sync with x as the A
// operand, fp32 accumulators in registers (fp32 x: FMA loops over the same
// tiles, for the exactness checks).  Few column tiles (I = 4096: 32 blocks
// for 132 SMs) would leave the card idle, so the caller splits H across
// blocks until there are ~2 blocks an SM; split blocks write fp32 partial
// sums and a small kernel adds them, applies the scale and casts.
#include "flash_common.cuh"

namespace deft {
namespace i8 {

constexpr int kBI = 128;  // output columns per block
constexpr int kWarps = 8;  // each owns 16 of the 128 columns
constexpr int kThreads = kWarps * 32;

// Shared memory: two stages of x (RP x BK) and of the int8 w tile (BK x kBI),
// and the widened w tile.  Row pitches are padded by 16 bytes so fragment
// loads and ldmatrix rows hit distinct banks.
template <typename T, int MT>
struct Layout {
  static constexpr int BK = sizeof(T) == 2 ? 128 : 32;  // H rows per stage
  static constexpr int RP = MT * 16;                    // x rows, padded
  static constexpr int XP = BK + 16 / sizeof(T);
  static constexpr int WP = kBI + 16 / sizeof(T);
  static constexpr size_t kX = size_t(RP) * XP * sizeof(T);
  static constexpr size_t kW8 = size_t(BK) * kBI;
  static constexpr size_t kWb = size_t(BK) * WP * sizeof(T);
  static constexpr size_t kBytes = 2 * kX + 2 * kW8 + kWb;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying H-chunk c of x (rows >= R zero-filled) and of w's column
// tile into stage buffers xd, wd.
template <typename T, int MT>
__device__ __forceinline__ void load_stage(T* xd, int8_t* wd, const T* __restrict__ x,
                                           const int8_t* __restrict__ w, int c, int col0,
                                           int R, int H, int I) {
  using L = Layout<T, MT>;
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = L::BK / EPC;
  const int k0 = c * L::BK;
  for (int i = threadIdx.x; i < L::RP * CPR; i += kThreads) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = r < R;
    cp_async16(xd + r * L::XP + cc * EPC, x + (ok ? (long long)r * H + k0 + cc * EPC : 0), ok);
  }
  constexpr int WCPR = kBI / 16;
  for (int i = threadIdx.x; i < L::BK * WCPR; i += kThreads) {
    const int r = i / WCPR, cc = i % WCPR;
    cp_async16(wd + r * kBI + cc * 16, w + (long long)(k0 + r) * I + col0 + cc * 16, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Widen the staged (BK, kBI) int8 tile to T rows of pitch WP, 16 at a step.
template <typename T, int MT>
__device__ __forceinline__ void widen(T* dst, const int8_t* src) {
  using L = Layout<T, MT>;
  for (int i = threadIdx.x; i < L::BK * kBI / 16; i += kThreads) {
    const int r = i / (kBI / 16), c = (i % (kBI / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * kBI + c);
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

// acc[m][nt] += x rows of m-tile m times w columns warp * 16 + nt * 8 of one
// stage, in the mma C-fragment layout (rows g, g + 8; columns tig*2, +1).
template <typename T, int MT>
__device__ __forceinline__ void stage_product(float acc[MT][2][4], const T* xs, const T* wb) {
  using L = Layout<T, MT>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  if constexpr (std::is_same<T, float>::value) {
    for (int k = 0; k < L::BK; ++k) {
      float wv[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* wp = wb + k * L::WP + warp * 16 + nt * 8 + tig * 2;
        wv[nt][0] = wp[0];
        wv[nt][1] = wp[1];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float x0 = xs[(m * 16 + g) * L::XP + k];
        const float x1 = xs[(m * 16 + g + 8) * L::XP + k];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          acc[m][nt][0] += x0 * wv[nt][0];
          acc[m][nt][1] += x0 * wv[nt][1];
          acc[m][nt][2] += x1 * wv[nt][0];
          acc[m][nt][3] += x1 * wv[nt][1];
        }
      }
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < L::BK / 16; ++ks) {
      uint32_t b[2][2];
      // lanes 0-15 address the 16 H rows of this k-step (w is row-major
      // [H][I], the layout of V in the attention kernels' PV product)
      const T* wrow = wb + (ks * 16 + lane % 16) * L::WP + warp * 16;
      ldmatrix_x2_trans(b[0][0], b[0][1], wrow);
      ldmatrix_x2_trans(b[1][0], b[1][1], wrow + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const T* a0 = xs + (m * 16 + g) * L::XP + ks * 16 + tig * 2;
        const T* a1 = a0 + 8 * L::XP;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(a0),
                               *reinterpret_cast<const uint32_t*>(a1),
                               *reinterpret_cast<const uint32_t*>(a0 + 8),
                               *reinterpret_cast<const uint32_t*>(a1 + 8)};
        mma_bf16(acc[m][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[m][1], a, b[1][0], b[1][1]);
      }
    }
  }
}

// The product rounded to T, times the column's scale in fp32, cast to T.
template <typename T>
__device__ __forceinline__ T scaled(float acc, float s) {
  return from_f<T>(to_f(from_f<T>(acc)) * s);
}

// One block: columns [col0, col0 + 128) over H-chunks [c_begin, c_end).
// part == nullptr: write out = scaled(acc); else the fp32 partial sums of
// this split, part (splits, R, I).
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
    int8_mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ part, int R, int H, int I, int chunks_per_split) {
  using L = Layout<T, MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  int8_t* w8 = reinterpret_cast<int8_t*>(smem + 2 * L::kX);
  T* wb = reinterpret_cast<T*>(smem + 2 * L::kX + 2 * L::kW8);
  const int col0 = blockIdx.x * kBI;
  const int split = blockIdx.y;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(H / L::BK, c_begin + chunks_per_split);

  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;

  if (c_begin < c_end) load_stage<T, MT>(xs, w8, x, w, c_begin, col0, R, H, I);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    if (c + 1 < c_end) {  // the next stage flies while this one is used
      load_stage<T, MT>(xs + (buf ^ 1) * L::RP * L::XP, w8 + (buf ^ 1) * L::BK * kBI, x, w,
                        c + 1, col0, R, H, I);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    widen<T, MT>(wb, w8 + buf * L::BK * kBI);
    __syncthreads();
    stage_product<T, MT>(acc, xs + buf * L::RP * L::XP, wb);
    __syncthreads();  // the stage and wb are consumed before they are refilled
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m * 16 + g + 8 * hh;
        if (r >= R) continue;
        const int col = col0 + warp * 16 + nt * 8 + tig * 2;
        const float v0 = acc[m][nt][2 * hh], v1 = acc[m][nt][2 * hh + 1];
        if (part == nullptr) {
          out[(long long)r * I + col] = scaled<T>(v0, scale[col]);
          out[(long long)r * I + col + 1] = scaled<T>(v1, scale[col + 1]);
        } else {
          *reinterpret_cast<float2*>(part + ((long long)split * R + r) * I + col) =
              make_float2(v0, v1);
        }
      }
}

// out = scaled(sum over splits of part).
template <typename T>
__global__ void int8_mm_reduce(const float* __restrict__ part, const float* __restrict__ scale,
                               T* __restrict__ out, int R, int I, int splits) {
  const long long n = (long long)R * I;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n + i];
    out[i] = scaled<T>(s, scale[i % I]);
  }
}

template <typename T, int MT>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, float* part,
                   int R, int H, int I, int splits, cudaStream_t stream) {
  using L = Layout<T, MT>;
  auto kernel = int8_mm_kernel<T, MT>;
  static const cudaError_t attr = allow_smem(kernel, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int chunks = H / L::BK;
  const int cps = (chunks + splits - 1) / splits;
  if (H % L::BK || (splits - 1) * cps >= chunks || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  dim3 grid(I / kBI, splits);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(static_cast<const T*>(x), w, scale,
                                                static_cast<T*>(out),
                                                splits > 1 ? part : nullptr, R, H, I, cps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)R * I;
  const long long want = (n + 255) / 256;
  const int blocks = want < 132 * 8 ? (int)want : 132 * 8;
  int8_mm_reduce<T><<<blocks, 256, 0, stream>>>(part, scale, static_cast<T*>(out), R, I,
                                                 splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const int8_t* w, const float* scale, void* out, float* part,
                     int R, int H, int I, int splits, cudaStream_t s) {
  if (R <= 16) return launch<T, 1>(x, w, scale, out, part, R, H, I, splits, s);
  if (R <= 32) return launch<T, 2>(x, w, scale, out, part, R, H, I, splits, s);
  if (R <= 64) return launch<T, 4>(x, w, scale, out, part, R, H, I, splits, s);
  if (R <= 128) return launch<T, 8>(x, w, scale, out, part, R, H, I, splits, s);
  return launch<T, 16>(x, w, scale, out, part, R, H, I, splits, s);
}

}  // namespace i8
}  // namespace deft

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x (R, H), w (H, I) int8,
// scale (I,) fp32, out (R, I), all contiguous and 16-byte aligned; 0 < R <=
// 256, H % 128 == 0, I % 128 == 0.  splits > 1 splits H across blocks and
// needs part, (splits, R, I) fp32 scratch; every split must own at least one
// H-chunk (128 rows bf16, 32 fp32).  Returns a cudaError_t code.
extern "C" int deft_int8_matmul(const void* x, const int8_t* w, const float* scale, void* out,
                                float* part, int R, int H, int I, int splits, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 256 || H <= 0 || I <= 0 || I % deft::i8::kBI || splits <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return deft::i8::dispatch<__nv_bfloat16>(x, w, scale, out, part, R, H, I, splits, s);
  if (dtype == 0) return deft::i8::dispatch<float>(x, w, scale, out, part, R, H, I, splits, s);
  return cudaErrorInvalidValue;
}
