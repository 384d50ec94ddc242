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
// 3.35 TB/s of HBM, are the limit (R = 256 is past that line).
//
// bf16 x: the product is computed transposed, out^T = w^T x^T, so the int8
// weight tile is wgmma's A operand, widened in registers, and x^T its B
// operand, read by the tensor cores from shared memory.
// - One block per column tile of BI = 256 output columns (128 when R > 128)
//   and span of H.  A producer warp keeps a ring of 64-deep stages in flight
//   through TMA: x (a 2-D map over (R, H), rows past R zero-filled up to N,
//   the next power of two >= max(R, 8)) and w (128-column int8 boxes), both
//   128-byte swizzled.
// - Two consumer warpgroups each own MT = BI / 128 m64 tiles of columns.  A
//   thread's A fragment holds, for its tile rows g and g + 8, H pairs
//   (k, k + 1): the tile's columns are ordered so that rows g and g + 8 are
//   the neighbouring columns 2g and 2g + 1, so one 16-bit load a k-row gives
//   both rows' bytes; `prmt` pairs two k-rows' loads and a bf16x2 subtract
//   widens them (hopper::widen4).  The swizzle keeps the loads free of bank
//   conflicts, and each weight byte is read from shared memory once.  The
//   epilogue writes through the inverse column map, two columns a store.
// - Each k16 step is its own wgmma group, with its own A registers (four
//   sets at N <= 64, two at N = 128 and 256, whose accumulators take more
//   registers): a set is refilled once the group that last read it has
//   retired, so the widening overlaps the tensor cores; a stage goes back
//   to the producer once its last group has retired.
// - Few column tiles (I = 4096: 16) would leave most SMs idle, so H is split
//   across the blocks of a thread-block cluster (up to 8, chosen by the
//   wrapper).  They reduce their fp32 sums through distributed shared memory:
//   each block leaves its sums in its own shared memory, and after a cluster
//   barrier block r adds up, in rank order, its share of the tile's outputs
//   over every block, applies the scale, rounds and writes them.  No fp32
//   partials go to device memory and the sums' order is fixed.
// fp32 x (the exactness checks) keeps an FMA body over cp.async stages, one
// block per 128 columns over the whole of H: wgmma takes no fp32 input, and
// TF32 would change the numbers.
#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace deft {
namespace i8 {

// The product rounded to T, times the column's scale in fp32, cast to T.
template <typename T>
__device__ __forceinline__ T scaled(float acc, float s) {
  return from_f<T>(to_f(from_f<T>(acc)) * s);
}

// -- fp32: FMA loops over cp.async stages ------------------------------------------

namespace fp32 {

constexpr int kBI = 128;  // output columns per block
constexpr int kBK = 32;   // H rows per stage
constexpr int kWarps = 8;  // each owns 16 of the 128 columns
constexpr int kThreads = kWarps * 32;

// Shared memory: two stages of x (RP x kBK) and of the int8 w tile (kBK x
// kBI), and the widened w tile.  Row pitches are padded by 16 bytes.
template <int MT>
struct Layout {
  static constexpr int RP = MT * 16;  // x rows, padded
  static constexpr int XP = kBK + 4;
  static constexpr int WP = kBI + 4;
  static constexpr size_t kX = size_t(RP) * XP * sizeof(float);
  static constexpr size_t kW8 = size_t(kBK) * kBI;
  static constexpr size_t kWb = size_t(kBK) * WP * sizeof(float);
  static constexpr size_t kBytes = 2 * kX + 2 * kW8 + kWb;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying H-chunk c of x (rows >= R zero-filled) and of w's column
// tile into stage buffers xd, wd.
template <int MT>
__device__ __forceinline__ void load_stage(float* xd, int8_t* wd, const float* __restrict__ x,
                                           const int8_t* __restrict__ w, int c, int col0,
                                           int R, int H, int I) {
  using L = Layout<MT>;
  constexpr int CPR = kBK / 4;
  const int k0 = c * kBK;
  for (int i = threadIdx.x; i < L::RP * CPR; i += kThreads) {
    const int r = i / CPR, cc = i % CPR;
    const bool ok = r < R;
    cp_async16(xd + r * L::XP + cc * 4, x + (ok ? (long long)r * H + k0 + cc * 4 : 0), ok);
  }
  constexpr int WCPR = kBI / 16;
  for (int i = threadIdx.x; i < kBK * WCPR; i += kThreads) {
    const int r = i / WCPR, cc = i % WCPR;
    cp_async16(wd + r * kBI + cc * 16, w + (long long)(k0 + r) * I + col0 + cc * 16, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Widen the staged (kBK, kBI) int8 tile to float rows of pitch WP.
template <int MT>
__device__ __forceinline__ void widen(float* dst, const int8_t* src) {
  using L = Layout<MT>;
  for (int i = threadIdx.x; i < kBK * kBI / 16; i += kThreads) {
    const int r = i / (kBI / 16), c = (i % (kBI / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * kBI + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float* d = dst + r * L::WP + c;
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(b[j], b[j + 1], b[j + 2], b[j + 3]);
  }
}

// acc[m][nt] += x rows of m-tile m times w columns warp * 16 + nt * 8 of one
// stage, in the mma C-fragment layout (rows g, g + 8; columns tig*2, +1).
template <int MT>
__device__ __forceinline__ void stage_product(float acc[MT][2][4], const float* xs,
                                              const float* wb) {
  using L = Layout<MT>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  for (int k = 0; k < kBK; ++k) {
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
}

// One block: columns [col0, col0 + 128) over all of H.
template <int MT>
__global__ void __launch_bounds__(kThreads)
    int8_mm_fma(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out, int R, int H, int I) {
  using L = Layout<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* w8 = reinterpret_cast<int8_t*>(smem + 2 * L::kX);
  float* wb = reinterpret_cast<float*>(smem + 2 * L::kX + 2 * L::kW8);
  const int col0 = blockIdx.x * kBI;
  const int chunks = H / kBK;

  float acc[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;

  load_stage<MT>(xs, w8, x, w, 0, col0, R, H, I);
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) {  // the next stage flies while this one is used
      load_stage<MT>(xs + (buf ^ 1) * L::RP * L::XP, w8 + (buf ^ 1) * kBK * kBI, x, w, c + 1,
                     col0, R, H, I);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    widen<MT>(wb, w8 + buf * kBK * kBI);
    __syncthreads();
    stage_product<MT>(acc, xs + buf * L::RP * L::XP, wb);
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
        out[(long long)r * I + col] = scaled<float>(acc[m][nt][2 * hh], scale[col]);
        out[(long long)r * I + col + 1] = scaled<float>(acc[m][nt][2 * hh + 1], scale[col + 1]);
      }
}

template <int MT>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, int R, int H,
                   int I, cudaStream_t stream) {
  using L = Layout<MT>;
  auto kernel = int8_mm_fma<MT>;
  static const cudaError_t attr = allow_smem(kernel, L::kBytes);
  if (attr != cudaSuccess) return attr;
  if (H % kBK) return cudaErrorInvalidValue;
  kernel<<<I / kBI, kThreads, L::kBytes, stream>>>(static_cast<const float*>(x), w, scale,
                                                   static_cast<float*>(out), R, H, I);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const int8_t* w, const float* scale, void* out, int R,
                     int H, int I, cudaStream_t s) {
  if (R <= 16) return launch<1>(x, w, scale, out, R, H, I, s);
  if (R <= 32) return launch<2>(x, w, scale, out, R, H, I, s);
  if (R <= 64) return launch<4>(x, w, scale, out, R, H, I, s);
  if (R <= 128) return launch<8>(x, w, scale, out, R, H, I, s);
  return launch<16>(x, w, scale, out, R, H, I, s);
}

}  // namespace fp32

// -- bf16: wgmma with the int8 tile as the A operand, widened in registers -----------

namespace wg {

constexpr int kBK = 64;         // H rows per stage: one 128-byte swizzled row of x
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kCThreads = kConsumers * 128;
constexpr int kThreads = kCThreads + 32;  // + the producer warp
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr uint32_t kWBox = kBK * 128;  // one TMA box of w: 64 H rows x 128 columns

// N: x rows as the wgmma sees them (R padded to a power of two >= 8).
template <int N>
struct Cfg {
  static constexpr int MT = N <= 128 ? 2 : 1;  // m64 column tiles per consumer warpgroup
  static constexpr int BI = kConsumers * MT * 64;  // output columns per block
  static constexpr uint32_t kX = N * 128;           // x stage: N rows x 64 bf16
  static constexpr uint32_t kW = BI / 128 * kWBox;  // w stage
  static constexpr uint32_t kStage = kX + kW;
  static constexpr int kStages = 196608 / kStage < 8 ? 196608 / kStage : 8;
  static constexpr uint32_t kRing = kStages * kStage;
  // the split's fp32 sums, left in the ring once it has drained
  static constexpr uint32_t kSums = kCThreads * MT * (N / 2) * 4;
  static constexpr uint32_t kData = kRing > kSums ? kRing : kSums;
  static constexpr size_t kSmem = 1024 + kData + 2 * kStages * sizeof(uint64_t);
};

// Write one (2 rows x 2 columns) piece of out: rows r, r + 1 of x, physical
// columns c, c + 1; v[i] in the accumulator order (i = 0: (c, r), 1: (c,
// r + 1), 2: (c + 1, r), 3: (c + 1, r + 1)).
__device__ __forceinline__ void store_piece(__nv_bfloat16* __restrict__ out,
                                            const float* __restrict__ scale, int R, int I,
                                            int r, int c, float v0, float v1, float v2,
                                            float v3) {
  if (c >= I) return;
  const float s0 = scale[c], s1 = scale[c + 1];
  if (r < R)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * I + c) = __halves2bfloat162(
        scaled<__nv_bfloat16>(v0, s0), scaled<__nv_bfloat16>(v2, s1));
  if (r + 1 < R)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r + 1) * I + c) = __halves2bfloat162(
        scaled<__nv_bfloat16>(v1, s0), scaled<__nv_bfloat16>(v3, s1));
}

// One block: columns [blockIdx.x * BI, + BI) over H-chunks [split * cps,
// + cps) of `chunks`; the gridDim.y splits of a column tile form a cluster.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
    int8_mm_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int R, int I, int chunks, int cps) {
  using C = Cfg<N>;
  constexpr int S = C::kStages;
  constexpr int MT = C::MT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::kData);
  uint64_t* empty = full + S;  // the 8 consumer warps have read the stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = blockIdx.x * C::BI;
  const int split = blockIdx.y, splits = gridDim.y;
  const int c0 = split * cps, c1 = min(chunks, c0 + cps);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers * 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const bool producer = warp == kConsumers * 4;
  const int cw = warp / 4, wq = warp % 4, g = lane / 4, tig = lane % 4;
  // this thread's physical column c (rows g; c + 1: row g + 8) in m64 tile t
  auto column = [&](int t) { return (cw * MT + t) * 64 + wq * 16 + 2 * g; };
  float acc[MT][N / 2];
  if (producer) {
    if (lane == 0) {
      for (int c = c0, it = 0; c < c1; ++c, ++it) {
        const int s = it % S;
        hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        uint8_t* st = base + s * C::kStage;
        hopper::mbar_arrive_expect_tx(&full[s], C::kStage);
        hopper::tma_load_2d(st, &xmap, &full[s], c * kBK, 0);
#pragma unroll
        for (int b = 0; b < C::BI / 128; ++b)
          hopper::tma_load_2d(st + C::kX + b * kWBox, &wmap, &full[s], col0 + b * 128,
                              c * kBK);
      }
    }
  } else {
    // byte offset of column c in a stage's w tiles, before the swizzle
    int cbox[MT], cin[MT];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int c = column(t);
      cbox[t] = c / 128 * kWBox;
      cin[t] = c % 128;
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < N / 2; ++j) acc[t][j] = 0.f;
    // A fragments of the k16 steps in flight: step ks fills buffer ks % kA;
    // four at N <= 64, two where the accumulators leave too few registers
    constexpr int kA = N <= 64 ? 4 : 2;
    uint32_t a[kA][MT][4];
    for (int c = c0, it = 0; c < c1; ++c, ++it) {
      const int s = it % S;
      const uint8_t* st = base + s * C::kStage;
      hopper::mbar_wait(&full[s], (it / S) & 1);
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        uint32_t(&ak)[MT][4] = a[ks % kA];
        // ak was last read by the group kA steps back: at most the kA - 1
        // groups issued after it may still run
        hopper::wgmma_wait<kA - 1>();
#pragma unroll
        for (int t = 0; t < MT; ++t) hopper::fence_regs(ak[t]);
        if (ks == kA - 1 && it > 0 && lane == 0)
          hopper::mbar_arrive(&empty[(it - 1) % S]);  // its last group has retired
        // k-rows k0, k0 + 1, k0 + 8, k0 + 9 of the step; row k's 16-byte
        // unit u sits at unit u ^ (k % 8), and k0 % 8 = 2 tig
        const int k0 = ks * 16 + 2 * tig;
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          const uint8_t* wt = st + C::kX + cbox[t];
          const int u = cin[t] >> 4, b = cin[t] & 15;
          const int o0 = ((u ^ (2 * tig)) << 4) + b, o1 = ((u ^ (2 * tig + 1)) << 4) + b;
          const uint32_t r0 = *reinterpret_cast<const uint16_t*>(wt + k0 * 128 + o0);
          const uint32_t r1 = *reinterpret_cast<const uint16_t*>(wt + (k0 + 1) * 128 + o1);
          const uint32_t r8 = *reinterpret_cast<const uint16_t*>(wt + (k0 + 8) * 128 + o0);
          const uint32_t r9 = *reinterpret_cast<const uint16_t*>(wt + (k0 + 9) * 128 + o1);
          // (k0, k0 + 1) of column c is row g's a0, of column c + 1 row g + 8's a1
          hopper::widen4(hopper::pair_lo(r0, r1), ak[t][0], ak[t][1]);
          hopper::widen4(hopper::pair_lo(r8, r9), ak[t][2], ak[t][3]);
        }
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          hopper::fence_regs(ak[t]);
          hopper::fence_regs(acc[t]);
        }
        hopper::wgmma_fence();
        const uint64_t db = hopper::desc_sw128(st + ks * 32, 16, 1024);
#pragma unroll
        for (int t = 0; t < MT; ++t) hopper::wgmma_rs_kmajor<N>(acc[t], ak[t], db);
        hopper::wgmma_commit();
#pragma unroll
        for (int t = 0; t < MT; ++t) hopper::fence_regs(acc[t]);
      }
    }
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < MT; ++t) hopper::fence_regs(acc[t]);
    // acc[t][4j + i]: physical column column(t) + i / 2, x row 8j + 2 tig + i % 2
    if (splits == 1) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          store_piece(out, scale, R, I, 8 * j + 2 * tig, col0 + column(t), acc[t][4 * j],
                      acc[t][4 * j + 1], acc[t][4 * j + 2], acc[t][4 * j + 3]);
    } else {
      // both warpgroups are done with the ring: leave the sums in it, value
      // j of thread i at word j * kCThreads + i
      hopper::named_barrier(1, kCThreads);
      float* sums = reinterpret_cast<float*>(base);
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < N / 2; ++j)
          sums[(t * (N / 2) + j) * kCThreads + threadIdx.x] = acc[t][j];
    }
  }
  if (splits == 1) return;

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's sums are in place
  if (!producer) {
    // block `split` adds up pieces [p0, p1) of each thread's MT * N / 8
    // pieces over the cluster's blocks in rank order, then stores them
    constexpr int P = MT * N / 8;
    const int p0 = P * split / splits, p1 = P * (split + 1) / splits;
    float* own = reinterpret_cast<float*>(base);
    for (int p = p0; p < p1; ++p) {
      const int t = p / (N / 8), j = p % (N / 8);
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < splits; ++q) {
        const float* peer = cluster.map_shared_rank(own, q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] += peer[(t * (N / 2) + 4 * j + i) * kCThreads + threadIdx.x];
      }
      store_piece(out, scale, R, I, 8 * j + 2 * tig, col0 + column(t), v[0], v[1], v[2], v[3]);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// x rows as the wgmma sees them: R padded to a power of two >= 8.
inline int padded_rows(int R) {
  int n = 8;
  while (n < R) n *= 2;
  return n;
}

template <int N>
cudaError_t launch(const void* x, const int8_t* w, const float* scale, void* out, int R, int H,
                   int I, int splits, cudaStream_t stream) {
  using C = Cfg<N>;
  const int chunks = H / kBK;
  const int cps = (chunks + splits - 1) / splits;
  if (H % kBK || splits > kMaxCluster || (splits - 1) * cps >= chunks)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {cuuint64_t(H), cuuint64_t(R)};
  const cuuint64_t xstrides[1] = {cuuint64_t(H) * 2};
  const cuuint32_t xbox[2] = {kBK, N};
  cudaError_t err = hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims,
                                     xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {cuuint64_t(I), cuuint64_t(H)};
  const cuuint64_t wstrides[1] = {cuuint64_t(I)};
  const cuuint32_t wbox[2] = {128, kBK};
  err = hopper::make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, wstrides, wbox,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = int8_mm_wgmma<N>;
  static const cudaError_t attr = allow_smem(kernel, C::kSmem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((I + C::BI - 1) / C::BI, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, scale, static_cast<__nv_bfloat16*>(out),
                           R, I, chunks, cps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of `splits` blocks of the kernel for R rows can be
// resident on the card at once.
template <int N>
int max_clusters(int splits) {
  using C = Cfg<N>;
  auto kernel = int8_mm_wgmma<N>;
  if (allow_smem(kernel, C::kSmem) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = C::kSmem;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : -1;
}

// Instantiate F<N> for the N that R rows take.
#define DEFT_I8_BY_N(R, CALL)              \
  switch (::deft::i8::wg::padded_rows(R)) { \
    case 8: { constexpr int N = 8; CALL; } \
    case 16: { constexpr int N = 16; CALL; } \
    case 32: { constexpr int N = 32; CALL; } \
    case 64: { constexpr int N = 64; CALL; } \
    case 128: { constexpr int N = 128; CALL; } \
    case 256: { constexpr int N = 256; CALL; } \
    default: break;                        \
  }

}  // namespace wg
}  // namespace i8
}  // namespace deft

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x (R, H), w (H, I) int8,
// scale (I,) fp32, out (R, I), all contiguous and 16-byte aligned; 0 < R <=
// 256, H % 64 == 0, I % 128 == 0.  bf16: splits (1 .. 8) blocks of a
// cluster share each column tile's H, every split owning at least one
// 64-row chunk; fp32 takes splits == 1 and H % 32 == 0.  Returns a
// cudaError_t code.
extern "C" int deft_int8_matmul(const void* x, const int8_t* w, const float* scale, void* out,
                                int R, int H, int I, int splits, int dtype, void* stream) {
  using namespace deft::i8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || R > 256 || H <= 0 || I <= 0 || I % 128 || splits <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    DEFT_I8_BY_N(R, return wg::launch<N>(x, w, scale, out, R, H, I, splits, s));
    return cudaErrorInvalidValue;
  }
  if (dtype == 0 && splits == 1) return fp32::dispatch(x, w, scale, out, R, H, I, s);
  return cudaErrorInvalidValue;
}

// The number of clusters of `splits` blocks that the bf16 kernel for R
// rows can keep resident on the current card, or -1.
extern "C" int deft_int8_matmul_max_clusters(int R, int splits) {
  using namespace deft::i8;
  if (R <= 0 || R > 256 || splits <= 0 || splits > wg::kMaxCluster) return -1;
  DEFT_I8_BY_N(R, return wg::max_clusters<N>(splits));
  return -1;
}
