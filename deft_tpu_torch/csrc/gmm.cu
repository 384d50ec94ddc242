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
// Bound on this card: operations.  At Mixtral-8x7B's prefill of a 4000-token
// prompt (top-2 over 8 experts: M = 9088 padded rows; wg/wu E = 4096,
// F = 14336) the row tiles up to the last group need 2 M E F = 0.99 TFLOP,
// 1.0032 ms at 989 TFLOP/s bf16, against 0.38 ms for the bytes (each
// expert's weights once, x and out once).  The first design (mma.sync
// m16n8k16 through ldmatrix, 128 x 128 blocks of 8 warps, cp.async stages
// issued by every thread, int8 tiles widened behind a block barrier) took
// 4.4806 ms (bf16 w) and 4.9385 ms (int8 w) there on an H100 80GB HBM3 at
// 700 W, 3.0-3.3x torch._grouped_mm.
//
// bf16 x (both w types): a persistent, warp-specialised wgmma kernel.
// - One block per SM walks the output tiles of 128 rows (one tile_eid tile)
//   by 256 columns, row tiles fastest, so the blocks in flight share an
//   expert's weight columns through L2.  256 columns halve the x re-reads
//   of 128 and divide both Mixtral widths (F = 14336 and 4096); a last tile
//   of F % 256 == 128 loads and stores its first half only.
// - Warpgroup 0 is the producer: one thread keeps a ring of 64-deep x and w
//   stages in flight through TMA (x a 2-D map over (M, E); w a 3-D map over
//   (NE, E, F), indexed by the tile's expert), with full/empty mbarrier
//   pairs.  TMA's zero fill past E covers E % 64 != 0.  It runs ahead into
//   the next tile while the consumers store this one, so one tile's
//   epilogue overlaps the next one's loads.
// - Warpgroups 1 and 2 each own 64 rows and issue m64n256k16 wgmma with both
//   operands in shared memory (x K-major; w N-major through the transpose
//   bit), one group in flight while the next stage's products issue; they
//   release a stage when its products have read it.
// - int8 w: TMA brings the int8 tile, and the consumer warpgroups widen it
//   into a swizzled bf16 B tile (exact: |w| <= 127 fits bf16's 8-bit
//   mantissa) while the tensor cores run the previous stage's products; two
//   such B tiles alternate, and a named barrier over the 256 consumer threads
//   (not the block) orders each widening between the products that read the
//   tiles.  The consumers keep the SS form, the same B layout and the same
//   epilogue as bf16 w.  The widening's instructions and shared-memory
//   traffic share the SM with the products, so they are kept few: each
//   thread loads its four 16-byte pieces first, converts two lanes an
//   instruction (a bf16x2 subtract) and stores whole 16-byte units to
//   distinct banks.  The producer warpgroup's three spare warps widening each
//   stage ahead of the consumers could not keep pace: 4.1712 ms at the wg
//   shape, against 1.6840 ms for bf16 w (chip_smoke.py, H100 80GB HBM3,
//   700 W).  The other route, computing w^T x^T with w widened in registers
//   as the RS form's A operand, needs per-thread byte gathers from the int8
//   tile and a transposed epilogue.
// - setmaxnreg moves registers from the producer warpgroup to the consumers'
//   128-float accumulators.
// fp32 x (the exactness checks) keeps the first design's FMA body: wgmma
// takes no fp32 input, and TF32 would change the numbers.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace deft {
namespace gmm {

constexpr int kBM = 128;  // rows per tile (deft_tpu's tile_m)

// -- fp32: FMA loops over cp.async stages ------------------------------------------

namespace fp32 {

constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 32;   // E rows per stage
constexpr int kStages = 4;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWM = 64, kWN = 32;             // a warp's piece of the tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;  // its m16 and n8 fragments

// Shared memory: kStages x (x tile, w tile as loaded), plus the widened w
// tile for int8 weights.  Row pitches are padded by 16 bytes.
template <typename W>
struct Layout {
  static constexpr bool kQ = std::is_same<W, int8_t>::value;
  static constexpr int XP = kBK + 16 / sizeof(float);  // x tile pitch
  static constexpr int WP = kBN + 16 / sizeof(float);  // w tile pitch, as float
  static constexpr int SP = kQ ? kBN : WP;             // staged w tile pitch
  static constexpr size_t kX = size_t(kBM) * XP * sizeof(float);
  static constexpr size_t kWs = size_t(kBK) * SP * sizeof(W);
  static constexpr size_t kWb = kQ ? size_t(kBK) * WP * sizeof(float) : 0;
  static constexpr size_t kBytes = kStages * (kX + kWs) + kWb;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Start copying stage k0 (E rows [k0, k0 + kBK)) of the block's x rows and
// of its expert's w column tile; x and w point at the tile's origin.
template <typename W>
__device__ __forceinline__ void load_stage(float* xs, W* ws, const float* __restrict__ x,
                                           const W* __restrict__ w, int k0, int E, int F) {
  using L = Layout<W>;
  constexpr int XE = 16 / sizeof(float);  // elements per 16-byte chunk
  constexpr int XC = kBK / XE;            // chunks per x row
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

// Widen a staged (kBK, kBN) int8 tile to float rows of pitch WP, 16 at a step.
__device__ __forceinline__ void widen(float* dst, const int8_t* src) {
  using L = Layout<int8_t>;
  for (int i = threadIdx.x; i < kBK * kBN / 16; i += kThreads) {
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + r * kBN + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    float* d = dst + r * L::WP + c;
#pragma unroll
    for (int j = 0; j < 16; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(b[j], b[j + 1], b[j + 2], b[j + 3]);
  }
}

// acc += the warp's 64 x 32 piece of x-stage times w-stage, in the mma
// C-fragment layout: acc[m][n] holds rows m * 16 + g (+ 8), columns
// n * 8 + tig * 2 (+ 1) of the piece.
template <typename W>
__device__ __forceinline__ void stage_product(float acc[kMT][kNT][4], const float* xs,
                                              const float* wt) {
  using L = Layout<W>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int wm = (warp / (kBN / kWN)) * kWM, wn = (warp % (kBN / kWN)) * kWN;
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
}

// One block: rows [t * kBM, + kBM) times expert tile_eid[t]'s columns
// [n0, n0 + kBN).  blockIdx.x = t (fastest), blockIdx.y = column tile.
template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
    gmm_kernel(const float* __restrict__ x, const W* __restrict__ w,
               const float* __restrict__ scale, const int* __restrict__ tile_eid,
               float* __restrict__ out, int E, int F, int NE) {
  using L = Layout<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  W* ws = reinterpret_cast<W*>(smem + kStages * L::kX);
  float* wb = reinterpret_cast<float*>(smem + kStages * (L::kX + L::kWs));
  const int t = blockIdx.x;
  const long long row0 = (long long)t * kBM;
  const int n0 = blockIdx.y * kBN;
  const int eid = tile_eid[t];
  if (eid < 0 || eid >= NE) {  // uniform over the block: no barrier is skipped unevenly
    for (int i = threadIdx.x; i < kBM * kBN; i += kThreads)
      out[(row0 + i / kBN) * F + n0 + i % kBN] = __int_as_float(0x7fc00000);
    return;
  }
  const float* xt = x + row0 * E;
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
      load_stage<W>(xs + s * (L::kX / sizeof(float)), ws + s * (L::kWs / sizeof(W)), xt, wt,
                    s * kBK, E, F);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kStages - 2>();  // stage c has landed (for this thread)
    __syncthreads();               // ... for every thread; stage c - 1 is consumed
    const int nxt = c + kStages - 1;
    if (nxt < nk) {
      const int s = nxt % kStages;
      load_stage<W>(xs + s * (L::kX / sizeof(float)), ws + s * (L::kWs / sizeof(W)), xt, wt,
                    nxt * kBK, E, F);
    }
    cp_async_commit();
    const int s = c % kStages;
    const float* xstage = xs + s * (L::kX / sizeof(float));
    if constexpr (L::kQ) {
      widen(wb, ws + s * (L::kWs / sizeof(W)));
      __syncthreads();
      stage_product<W>(acc, xstage, wb);
    } else {
      stage_product<W>(acc, xstage, ws + s * (L::kWs / sizeof(W)));
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
        *reinterpret_cast<float2*>(out + r * F + col) =
            make_float2(acc[m][n][2 * hh] * s0, acc[m][n][2 * hh + 1] * s1);
      }
  }
}

template <typename W>
cudaError_t launch(const void* x, const void* w, const float* scale, const int* tile_eid,
                   void* out, int M, int E, int F, int NE, cudaStream_t stream) {
  using L = Layout<W>;
  auto kernel = gmm_kernel<W>;
  static const cudaError_t attr = allow_smem(kernel, L::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(M / kBM, F / kBN);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(static_cast<const float*>(x),
                                                 static_cast<const W*>(w), scale, tile_eid,
                                                 static_cast<float*>(out), E, F, NE);
  return cudaGetLastError();
}

}  // namespace fp32

// -- bf16: persistent wgmma over TMA stages ----------------------------------------

namespace wg {

constexpr int kBN = 256;  // output columns per tile
constexpr int kBK = 64;   // E rows per stage: one 128-byte swizzled row of x
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t kXBytes = kBM * kBK * 2;      // x stage: 128 rows x 64
constexpr uint32_t kWChunk = kBK * 64 * 2;       // 64 k-rows x 64 columns of bf16 w
constexpr uint32_t kWBytes = 4 * kWChunk;        // the stage's 256 columns
constexpr uint32_t kRawChunk = kBK * 128;        // 64 k-rows x 128 columns of int8 w
constexpr uint32_t kRawBytes = 2 * kRawChunk;

// Shared memory: a ring of kStages TMA stages (x, then w as loaded), and for
// int8 w two bf16 B tiles that the consumers widen the stages into.
template <typename W>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kStages = 4;
  static constexpr uint32_t kStage = kXBytes + kWBytes;
  static constexpr uint32_t kB = 0;
};
template <>
struct Cfg<int8_t> {
  static constexpr int kStages = 4;
  static constexpr uint32_t kStage = kXBytes + kRawBytes;
  static constexpr uint32_t kB = 2 * kWBytes;
};

template <typename W>
constexpr size_t smem_bytes() {
  return 1024 + Cfg<W>::kStages * (Cfg<W>::kStage + 2 * sizeof(uint64_t)) + Cfg<W>::kB;
}

// The 256 consumer threads widen a stage's int8 tile (two 128-column tiles
// of 64 k-rows) into a bf16 B tile (four 64-column 128-byte-swizzled tiles),
// then make the writes visible to wgmma and wait for each other.  A thread
// takes four 16-column pieces, all loads first.  Sixteen columns of row k
// are 16-byte units u, u + 1 of the row in its 64-column tile, each stored
// at unit ^ (k % 8); of eight neighbouring threads, four fill one tile's row
// and four the next tile's, which store their two units in the other order,
// so each store instruction hits eight bank groups.
__device__ __forceinline__ void widen_stage(uint8_t* b, const int8_t* raw, int tid) {
  constexpr int kPieces = kBK * (kBN / 16) / 256;
  uint4 v[kPieces];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = tid + 256 * j, k = i / (kBN / 16), f0 = i % (kBN / 16) * 16;
    v[j] = *reinterpret_cast<const uint4*>(raw + f0 / 128 * kRawChunk + k * 128 + f0 % 128);
  }
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    const int i = tid + 256 * j, k = i / (kBN / 16), f0 = i % (kBN / 16) * 16;
    uint4 o0, o1;
    hopper::widen4(v[j].x, o0.x, o0.y);
    hopper::widen4(v[j].y, o0.z, o0.w);
    hopper::widen4(v[j].z, o1.x, o1.y);
    hopper::widen4(v[j].w, o1.z, o1.w);
    uint8_t* row = b + f0 / 64 * kWChunk + k * 128;
    const int u = f0 % 64 / 8;
    uint4* p0 = reinterpret_cast<uint4*>(row + ((u ^ (k & 7)) << 4));
    uint4* p1 = reinterpret_cast<uint4*>(row + (((u + 1) ^ (k & 7)) << 4));
    if (f0 / 64 & 1) {
      *p1 = o1;
      *p0 = o0;
    } else {
      *p0 = o0;
      *p1 = o1;
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 256);
}

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const float* __restrict__ scale, const int* __restrict__ tile_eid,
              __nv_bfloat16* __restrict__ out, int M, int E, int F, int NE) {
  using C = Cfg<W>;
  constexpr bool kQ = std::is_same<W, int8_t>::value;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* btiles = base + S * C::kStage;  // int8 w: the widened B tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(btiles + C::kB);
  uint64_t* empty = full + S;  // the 8 consumer warps have read the stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  const int mt = M / kBM, nk = (E + kBK - 1) / kBK;
  const int tiles = mt * ((F + kBN - 1) / kBN);

  if (warp < 4) {  // producer warpgroup: one thread issues every copy
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int rt = t % mt, n0 = t / mt * kBN;
        const int eid = tile_eid[rt];
        if (eid < 0 || eid >= NE) continue;
        // columns past F: a whole 64 (bf16) or 128 (int8) chunk, not loaded
        const int chunks = kQ ? min(2, (F - n0) / 128) : min(4, (F - n0) / 64);
        const uint32_t bytes = kXBytes + chunks * (kQ ? kRawChunk : kWChunk);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % S;
          hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          uint8_t* st = base + s * C::kStage;
          hopper::mbar_arrive_expect_tx(&full[s], bytes);
          hopper::tma_load_2d(st, &xmap, &full[s], kb * kBK, rt * kBM);
          for (int c = 0; c < chunks; ++c) {
            if constexpr (kQ)
              hopper::tma_load_3d(st + kXBytes + c * kRawChunk, &wmap, &full[s], n0 + c * 128,
                                  kb * kBK, eid);
            else
              hopper::tma_load_3d(st + kXBytes + c * kWChunk, &wmap, &full[s], n0 + c * 64,
                                  kb * kBK, eid);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: rows cw * 64 .. + 63 of each tile
  hopper::reg_alloc<232>();
  const int cw = warp / 4 - 1, g = lane / 4, tig = lane % 4, tid = threadIdx.x - 128;
  // int8 w: stage i's int8 tile as loaded, and the B tile it is widened into
  auto raw = [&](int i) {
    return reinterpret_cast<const int8_t*>(base + i % S * C::kStage + kXBytes);
  };
  auto btile = [&](int i) { return btiles + i % 2 * kWBytes; };
  float acc[kBN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int rt = t % mt, n0 = t / mt * kBN;
    const int eid = tile_eid[rt];
    const long long r0 = (long long)rt * kBM + cw * 64 + warp % 4 * 16 + g;
    if (eid < 0 || eid >= NE) {
      const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + j * 8 + tig * 2;
        if (col < F) {
          out[r0 * F + col] = out[r0 * F + col + 1] = nan;
          out[(r0 + 8) * F + col] = out[(r0 + 8) * F + col + 1] = nan;
        }
      }
      continue;
    }
    if constexpr (kQ) {  // the tile's first stage; both B tiles are free here
      hopper::named_barrier(1, 256);
      hopper::mbar_wait(&full[it % S], (it / S) & 1);
      widen_stage(btile(it), raw(it), tid);
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % S;
      const uint8_t* st = base + s * C::kStage;
      if constexpr (!kQ) hopper::mbar_wait(&full[s], (it / S) & 1);
      const uint8_t* b = kQ ? btile(it) : st + kXBytes;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        const uint64_t da = hopper::desc_sw128(st + cw * 64 * 128 + k * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(b + k * 16 * 128, kWChunk, 1024);
        hopper::wgmma_m64n256k16_ss<1>(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      hopper::fence_regs(acc);
      if (kb > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);
      if constexpr (kQ) {
        if (kb + 1 < nk) {
          // widen the next stage while this one's products run: its B tile
          // was last read by the previous stage's, done in both warpgroups
          // once they meet here
          hopper::named_barrier(1, 256);
          hopper::mbar_wait(&full[(it + 1) % S], ((it + 1) / S) & 1);
          widen_stage(btile(it + 1), raw(it + 1), tid);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % S]);

    // acc[4j + i]: rows r0 (i < 2) and r0 + 8, columns n0 + 8j + 2 tig (+1)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;
      if (col < F) {
        float s0 = 1.f, s1 = 1.f;
        if constexpr (kQ) {
          s0 = scale[(long long)eid * F + col];
          s1 = scale[(long long)eid * F + col + 1];
        }
        store_bf16x2(out + r0 * F + col, acc[4 * j] * s0, acc[4 * j + 1] * s1);
        store_bf16x2(out + (r0 + 8) * F + col, acc[4 * j + 2] * s0, acc[4 * j + 3] * s1);
      }
    }
  }
}

template <typename W>
cudaError_t launch(const void* x, const void* w, const float* scale, const int* tile_eid,
                   void* out, int M, int E, int F, int NE, cudaStream_t stream) {
  constexpr bool kQ = std::is_same<W, int8_t>::value;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {cuuint64_t(E), cuuint64_t(M)};
  const cuuint64_t xstrides[1] = {cuuint64_t(E) * 2};
  const cuuint32_t xbox[2] = {kBK, kBM};
  cudaError_t err = hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims,
                                     xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {cuuint64_t(F), cuuint64_t(E), cuuint64_t(NE)};
  const cuuint64_t wstrides[2] = {cuuint64_t(F) * sizeof(W), cuuint64_t(E) * F * sizeof(W)};
  const cuuint32_t wbox[3] = {kQ ? 128u : 64u, kBK, 1};
  err = hopper::make_map(&wmap,
                         kQ ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         3, w, wdims, wstrides, wbox,
                         kQ ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = gmm_wgmma<W>;
  constexpr size_t smem = smem_bytes<W>();
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  static const int sms = hopper::sm_count();
  const int tiles = M / kBM * ((F + kBN - 1) / kBN);
  kernel<<<min(tiles, sms), kThreads, smem, stream>>>(
      xmap, wmap, scale, tile_eid, static_cast<__nv_bfloat16*>(out), M, E, F, NE);
  return cudaGetLastError();
}

}  // namespace wg
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
  if (M <= 0 || E <= 0 || F <= 0 || NE <= 0 || M % kBM || E % 32 || F % 128 ||
      (w_int8 != 0) != (scale != nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return w_int8 ? wg::launch<int8_t>(x, w, scale, tile_eid, out, M, E, F, NE, s)
                  : wg::launch<__nv_bfloat16>(x, w, scale, tile_eid, out, M, E, F, NE, s);
  if (dtype == 0)
    return w_int8 ? fp32::launch<int8_t>(x, w, scale, tile_eid, out, M, E, F, NE, s)
                  : fp32::launch<float>(x, w, scale, tile_eid, out, M, E, F, NE, s);
  return cudaErrorInvalidValue;
}
