// Causal prefill flash attention, GQA rows folded: one prompt (B3), or
// several prompts joined on the token axis (B8, ragged).
//
// B3 replaces the Pallas TPU kernel deft_tpu/ops/prefill.py:82
// (_prefill_kernel, launched by prefill_attention :143).  Folded row r of KV
// head h is query head h * qpk + r % qpk of token r / qpk; it sees keys
// t <= r / qpk.
//
// B8 replaces deft_tpu/ops/prefill.py:205 (_ragged_prefill_kernel, launched
// by ragged_prefill_attention :288 from ragged_prefill_attn_pallas :365).
// seg (N,) gives each token's prompt, ascending, pads < 0; token i sees
// token j iff seg[i] == seg[j] >= 0 and j <= i, and a pad row gives 0.
// seg_start[i] is the first token of i's prompt (the wrapper computes it in
// one pass, as prefill.py:311-316 does).
//
// Both keep deft_tpu's softmax: exp2 with the running max clamped at -1e5,
// so a row that sees nothing gives 0, and P rounded to bf16 before PV
// (flash_common.cuh:4-12).
//
// Bound on this card: operations.  2 * 2 * Hq * D * (sum of the causal
// pairs) FLOPs against 989 TFLOP/s of bf16 tensor cores (B3: N^2 / 2 pairs;
// B8: sum of L_i^2 / 2), while K and V are read once per row tile.  At
// Llama-3.1-8B's heads, a 4000-token prompt is 0.1325 ms (B3) and the batch
// path's four prompts 0.2486 ms (B8).  The first design (4 warps over 64
// folded rows, mma.sync, each 64-token KV tile loaded, waited on and synced
// before its products) took 0.8397 and 1.7190 ms there on an H100 80GB HBM3
// at 700 W, 3.2x SDPA and 2.1x varlen_attn.
//
// bf16: FA3-style, warp-specialised, on wgmma and TMA, at head_dim 64, 96,
// 128 and 256.
// - One block per (128 folded rows, KV head), blocks issued last row tile
//   first so the longest rows start first.  Warpgroup 0 is the producer:
//   one thread TMA-loads the Q tile once, then K and V tiles into a
//   two-stage ring (full/empty mbarriers), so copies overlap the products.
//   Warpgroups 1 and 2 each own 64 rows.
// - No fold copies: the folded rows of KV head h are a 3-D box (64 of D,
//   qpk heads, tokens) of q viewed as (N, Hq, D), 128 / qpk tokens deep
//   (128 rows when qpk divides 128); o is stored through the same box from
//   shared memory.  K and V are 3-D maps over (D, Hkv, N), a box (64 of D,
//   head h, a tile's tokens).  Under 128-byte swizzle a box is at most 128
//   bytes wide, so D spans ceil(D / 64) boxes.
// - S = Q K^T is SS wgmma (m64nTk16, K-major both, T the tile's tokens);
//   the online softmax runs on the accumulator fragments in registers; P
//   becomes bf16 in registers, already in the A-fragment layout, and
//   O += P V is RS wgmma with V N-major through the transpose bit, N the
//   boxes' 64 D columns each.
// - Tiles above the diagonal are skipped and only the diagonal tile takes
//   the causal mask.  B8 starts at the first row's prompt start and takes
//   the segment mask only on tiles that straddle a prompt boundary, so B
//   prompts cost sum L_i^2 / 2, not (sum L_i)^2 / 2.
// - Tile depth by width (Layout): 128 tokens at D <= 128.  At D 256 a
//   128-token K + V stage is 128 KB and two would not fit beside the 64 KB
//   Q tile in 227 KB, so tiles are 64 tokens (two 64 KB stages + Q = 193
//   KB); S is then m64n64k16 (32 registers) beside the 64 x 256 O
//   accumulator (128), and the producer warpgroup drops to 24 registers a
//   thread so that each consumer thread may hold 240 (128 x 24 + 256 x 240
//   <= 65536), as FlashAttention-3 splits them at this width.
// - D 96 (Phi-3-mini) is one 64-column box plus 32 columns.  The second box
//   reads columns 64..127 of each row: TMA fills 96..127 with zeros, since
//   they lie outside the 3-D maps' first dimension, and drops them on the
//   o store.  S issues only the 6 k16 steps over live columns; P V runs at
//   N 128 over both boxes (a quarter of its products on the zero columns):
//   an N-major operand under 128-byte swizzle is laid out in whole 64-column
//   atoms, so N 96 (or n64 + n32) has no canonical descriptor, and a
//   64-byte-swizzled third box would need a second set of descriptors and
//   maps for 32 columns.
// fp32 (the exactness checks) keeps the first design's FMA body from
// flash_common.cuh: wgmma takes no fp32 input, and TF32 would change the
// numbers.
#include "flash_common.cuh"
#include "hopper.cuh"

namespace deft {

// -- fp32: the body of flash_common.cuh ---------------------------------------------

namespace mma {

template <typename T, int D, bool kRagged>
__global__ void __launch_bounds__(kThreads)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ seg,
                   const int* __restrict__ seg_start, T* __restrict__ o, int N,
                   int Hq, int Hkv, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);
  using S = Smem<T, D>;
  const int qpk = Hq / Hkv;
  const int NQ = N * qpk;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int r0 = qt * kBM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;

  if (threadIdx.x < kBM) {
    const int r = r0 + threadIdx.x;
    sm.roff[threadIdx.x] =
        r < NQ ? ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D : -1;
  }
  __syncthreads();
  load_rows<T, D>(sm.q, S::QS, q, sm.roff, kBM);
  cp_async_wait_all();
  __syncthreads();
  RowState<D> st;
  init_state<T, D>(st, sm);

  const int first_tok = r0 / qpk;
  const int last_tok = min(N - 1, (r0 + kBM - 1) / qpk);
  const int row0 = r0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int tok_r0 = row0 / qpk, tok_r1 = (row0 + 8) / qpk;
  // B8: the first row's prompt start bounds the loop from below; a tile
  // whose rows all lie in that prompt takes the causal mask only
  int j_begin = 0, lo = 0, seg_r0 = 0, seg_r1 = 0;
  bool one_seg = true;
  if constexpr (kRagged) {
    const int s_first = seg[first_tok];
    lo = seg_start[first_tok];
    j_begin = s_first < 0 ? last_tok + 1 : lo / kBN * kBN;  // pad rows: 0
    one_seg = seg[last_tok] == s_first;
    seg_r0 = tok_r0 < N ? seg[tok_r0] : -1;
    seg_r1 = tok_r1 < N ? seg[tok_r1] : -1;
  }
  for (int j0 = j_begin; j0 <= last_tok; j0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < kBN) {
      const int t = j0 + threadIdx.x;
      sm.roff[threadIdx.x] = t < N ? ((long long)t * Hkv + h) * D : -1;
      if constexpr (kRagged) sm.lo[threadIdx.x] = t < N ? seg[t] : -2;
    }
    __syncthreads();
    load_kv_tile<T, D>(sm, k, v);
    __syncthreads();
    float s[kBN / 8][4];
    tile_scores<T, D>(s, st, sm, s2);
    if (kRagged && (!one_seg || j0 < lo)) {  // straddles a prompt boundary
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = n * 8 + tig * 2 + c;
          const int sk = sm.lo[j];
          if (j0 + j > tok_r0 || sk != seg_r0 || seg_r0 < 0) s[n][c] = kNeg;
          if (j0 + j > tok_r1 || sk != seg_r1 || seg_r1 < 0) s[n][2 + c] = kNeg;
        }
      }
    } else if (j0 + kBN - 1 > first_tok) {  // diagonal tile: causal mask
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const int t = j0 + n * 8 + tig * 2;
        if (t > tok_r0) s[n][0] = kNeg;
        if (t + 1 > tok_r0) s[n][1] = kNeg;
        if (t > tok_r1) s[n][2] = kNeg;
        if (t + 1 > tok_r1) s[n][3] = kNeg;
      }
    }
    tile_update<T, D>(s, st, sm);
  }

  // normalise and write rows r < NQ back in the (N, Hq, D) layout
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= NQ) continue;
    const float inv = st.l[hh] == 0.f ? 0.f : 1.f / st.l[hh];
    T* orow = o + ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int d = n * 8 + tig * 2;
      orow[d] = from_f<T>(st.o[n][2 * hh] * inv);
      orow[d + 1] = from_f<T>(st.o[n][2 * hh + 1] * inv);
    }
  }
}

template <typename T, int D, bool kRagged>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   const int* seg_start, void* o, int N, int Hq, int Hkv, float scale,
                   cudaStream_t stream) {
  auto kernel = prefill_kernel<T, D, kRagged>;
  const size_t smem = sizeof(Smem<T, D>);
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int nq = N * (Hq / Hkv);
  dim3 grid((nq + kBM - 1) / kBM, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      seg_start, static_cast<T*>(o), N, Hq, Hkv, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace mma

// -- bf16: wgmma over TMA stages ---------------------------------------------------

namespace wg {

constexpr int kRows = 128;  // folded rows per block: two consumer warpgroups of 64
constexpr int kStages = 2;
constexpr int kThreads = 384;
constexpr uint32_t kBoxRow = 128;  // bytes of a swizzled box row: 64 bf16

template <int D>
struct Layout {
  static constexpr int NC = (D + 63) / 64;       // 64-column boxes across D
  static constexpr int kSteps = D / 16;          // k16 steps of S over live columns
  static constexpr int DN = NC * 64;             // P V's N: whole boxes
  static constexpr int kTok = D > 128 ? 64 : 128;  // KV tokens per tile
  static constexpr uint32_t kQBox = kRows * kBoxRow;  // one box of the Q tile
  static constexpr uint32_t kKVBox = kTok * kBoxRow;  // one box of a K (or V) tile
  static constexpr uint32_t kQ = NC * kQBox;           // Q tile, then the o staging
  static constexpr uint32_t kKV = NC * kKVBox;         // K (or V) of one stage
  static constexpr uint32_t kStage = 2 * kKV;
  static constexpr size_t kBytes = 1024 + kQ + kStages * kStage + (1 + 2 * kStages) * 8;
  // registers a thread after setmaxnreg: producer, consumers (128 x 24 +
  // 256 x 240 and 128 x 40 + 256 x 232 both come to 64512 of 65536)
  static constexpr int kProducerRegs = D > 128 ? 24 : 40;
  static constexpr int kConsumerRegs = D > 128 ? 240 : 232;
  static_assert(kBytes <= 232448, "shared memory of a block");
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 65536, "registers of an SM");
};

template <int D, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1)
    prefill_wgmma(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap omap, const int* __restrict__ seg,
                  const int* __restrict__ seg_start, int N, int qpk, int T, float s2) {
  using L = Layout<D>;
  constexpr int NC = L::NC, kTok = L::kTok;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kQ + kStages * L::kStage);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;  // the 8 consumer warps have read the stage
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * T;  // heaviest tiles first
  const int last_tok = min(N - 1, t0 + T - 1);
  // B8: the first row's prompt start bounds the loop from below; a tile
  // whose rows all lie in that prompt takes the causal mask only
  int j_begin = 0, lo = 0;
  bool one_seg = true;
  if constexpr (kRagged) {
    const int s_first = seg[t0];
    lo = seg_start[t0];
    j_begin = s_first < 0 ? last_tok + 1 : lo / kTok * kTok;  // pad rows: 0
    one_seg = seg[last_tok] == s_first;
  }
  const int n_kv = j_begin <= last_tok ? (last_tok - j_begin) / kTok + 1 : 0;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {  // producer warpgroup: one thread issues every copy
    hopper::reg_dealloc<L::kProducerRegs>();
    if (threadIdx.x == 0) {
      // a box's bytes arrive whole, its part outside the tensor as zeros
      hopper::mbar_arrive_expect_tx(q_full, NC * 64 * qpk * T * 2);
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_3d(qs + c * L::kQBox, &qmap, q_full, c * 64, h * qpk, t0);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kStages, j0 = j_begin + i * kTok;
        hopper::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = base + L::kQ + s * L::kStage;
        hopper::mbar_arrive_expect_tx(&full[s], L::kStage);
        for (int c = 0; c < NC; ++c) {
          hopper::tma_load_3d(st + c * L::kKVBox, &kmap, &full[s], c * 64, h, j0);
          hopper::tma_load_3d(st + L::kKV + c * L::kKVBox, &vmap, &full[s], c * 64, h, j0);
        }
      }
    }
    return;
  }

  // consumer warpgroups: folded rows cw * 64 .. + 63 of the block; this
  // thread's rows lr0 and lr0 + 8 (the wgmma accumulator layout)
  hopper::reg_alloc<L::kConsumerRegs>();
  const int cw = warp / 4 - 1, g = lane / 4, tig = lane % 4;
  const int lr0 = cw * 64 + warp % 4 * 16 + g;
  const int tok_r0 = t0 + lr0 / qpk, tok_r1 = t0 + (lr0 + 8) / qpk;
  int seg_r0 = 0, seg_r1 = 0;
  if constexpr (kRagged) {
    seg_r0 = tok_r0 < N ? seg[tok_r0] : -1;
    seg_r1 = tok_r1 < N ? seg[tok_r1] : -1;
  }
  // o[4n + e]: row lr0 (e < 2) or lr0 + 8, column 8n + 2 tig + e % 2
  float o[L::DN / 2];
#pragma unroll
  for (int i = 0; i < L::DN / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kStages, j0 = j_begin + i * kTok;
    const uint8_t* st = base + L::kQ + s * L::kStage;
    hopper::mbar_wait(&full[s], (i / kStages) & 1);
    // S = Q K^T: sc[4n + e] is row lr0 (e < 2) or lr0 + 8, token 8n + 2 tig + e % 2
    float sc[kTok / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L::kSteps; ++kk) {
      const int c = kk / 4, off = kk % 4 * 32;
      const uint64_t da =
          hopper::desc_sw128(qs + c * L::kQBox + cw * 64 * kBoxRow + off, 16, 1024);
      const uint64_t db = hopper::desc_sw128(st + c * L::kKVBox + off, 16, 1024);
      hopper::wgmma_ss_kmajor<kTok>(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(sc);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
#pragma unroll
    for (int e = 0; e < kTok / 2; ++e) sc[e] *= s2;
    if (kRagged && (!one_seg || j0 < lo)) {  // straddles a prompt boundary
#pragma unroll
      for (int n = 0; n < kTok / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = j0 + n * 8 + tig * 2 + c;
          const int sk = j < N ? seg[j] : -2;
          if (j > tok_r0 || sk != seg_r0 || seg_r0 < 0) sc[4 * n + c] = kNeg;
          if (j > tok_r1 || sk != seg_r1 || seg_r1 < 0) sc[4 * n + 2 + c] = kNeg;
        }
      }
    } else if (j0 + kTok - 1 > t0) {  // diagonal tile: causal mask
#pragma unroll
      for (int n = 0; n < kTok / 8; ++n) {
        const int j = j0 + n * 8 + tig * 2;
        if (j > tok_r0) sc[4 * n] = kNeg;
        if (j + 1 > tok_r0) sc[4 * n + 1] = kNeg;
        if (j > tok_r1) sc[4 * n + 2] = kNeg;
        if (j + 1 > tok_r1) sc[4 * n + 3] = kNeg;
      }
    }
    // online softmax in exp2 (masked scores hold kNeg: exp2 sends them to 0)
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < kTok / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * hh], sc[4 * n + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(m[hh], mx), kMClamp);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTok / 8; ++n) {
        sc[4 * n + 2 * hh] = exp2f(sc[4 * n + 2 * hh] - m_new);
        sc[4 * n + 2 * hh + 1] = exp2f(sc[4 * n + 2 * hh + 1] - m_new);
        sum += sc[4 * n + 2 * hh] + sc[4 * n + 2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hh] = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * alpha[hh] + sum;
      m[hh] = m_new;
    }
#pragma unroll
    for (int n = 0; n < L::DN / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    // P in bf16: the S fragments of tokens 16 kt .. + 15 are the A fragment
    // of the kt-th k16 step
    uint32_t pa[kTok / 16][4];
#pragma unroll
    for (int kt = 0; kt < kTok / 16; ++kt) {
      pa[kt][0] = pack_bf16(sc[8 * kt], sc[8 * kt + 1]);
      pa[kt][1] = pack_bf16(sc[8 * kt + 2], sc[8 * kt + 3]);
      pa[kt][2] = pack_bf16(sc[8 * kt + 4], sc[8 * kt + 5]);
      pa[kt][3] = pack_bf16(sc[8 * kt + 6], sc[8 * kt + 7]);
    }
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < kTok / 16; ++kt) {
      // V's tokens 16 kt .. + 15 (k), its NC boxes' columns (N) one box apart
      const uint64_t db =
          hopper::desc_sw128(st + L::kKV + kt * 16 * kBoxRow, L::kKVBox, 1024);
      hopper::wgmma_rs_nmajor<L::DN>(o, pa[kt], db);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(o);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
#pragma unroll
    for (int kt = 0; kt < kTok / 16; ++kt) hopper::fence_regs(pa[kt]);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // o / l into this warpgroup's rows of the Q tile (its products are done),
  // swizzled as the box is, then one TMA store of the block's rows (D 96:
  // the columns past 96, zeros, lie outside the map and are dropped)
  const float inv[2] = {l[0] == 0.f ? 0.f : 1.f / l[0], l[1] == 0.f ? 0.f : 1.f / l[1]};
#pragma unroll
  for (int n = 0; n < L::DN / 8; ++n) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int lr = lr0 + 8 * hh;
      uint8_t* p = qs + n / 8 * L::kQBox + lr * kBoxRow + (((n % 8) ^ (lr & 7)) << 4) +
                   tig * 4;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(o[4 * n + 2 * hh] * inv[hh], o[4 * n + 2 * hh + 1] * inv[hh]);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 256);
  if (threadIdx.x == 128) {
    for (int c = 0; c < NC; ++c)
      hopper::tma_store_3d(&omap, qs + c * L::kQBox, c * 64, h * qpk, t0);
    hopper::tma_store_commit_and_wait();
  }
}

template <int D, bool kRagged>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   const int* seg_start, void* o, int N, int Hq, int Hkv, float scale,
                   cudaStream_t stream) {
  const int qpk = Hq / Hkv;
  if (qpk > kRows) return cudaErrorInvalidValue;
  const int T = kRows / qpk;  // tokens per block: T * qpk <= 128 folded rows
  CUtensorMap qmap, kmap, vmap, omap;
  // q, o: (D, Hq, N), box (64, qpk, T); k, v: (D, Hkv, N), box (64, 1, a tile)
  const cuuint64_t qdims[3] = {cuuint64_t(D), cuuint64_t(Hq), cuuint64_t(N)};
  const cuuint64_t qstrides[2] = {cuuint64_t(D) * 2, cuuint64_t(Hq) * D * 2};
  const cuuint32_t qbox[3] = {64, cuuint32_t(qpk), cuuint32_t(T)};
  const cuuint64_t kdims[3] = {cuuint64_t(D), cuuint64_t(Hkv), cuuint64_t(N)};
  const cuuint64_t kstrides[2] = {cuuint64_t(D) * 2, cuuint64_t(Hkv) * D * 2};
  const cuuint32_t kbox[3] = {64, 1, cuuint32_t(Layout<D>::kTok)};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaError_t err = hopper::make_map(&qmap, bf16, 3, q, qdims, qstrides, qbox, sw);
  if (err == cudaSuccess) err = hopper::make_map(&omap, bf16, 3, o, qdims, qstrides, qbox, sw);
  if (err == cudaSuccess) err = hopper::make_map(&kmap, bf16, 3, k, kdims, kstrides, kbox, sw);
  if (err == cudaSuccess) err = hopper::make_map(&vmap, bf16, 3, v, kdims, kstrides, kbox, sw);
  if (err != cudaSuccess) return err;
  auto kernel = prefill_wgmma<D, kRagged>;
  static const cudaError_t attr = allow_smem(kernel, Layout<D>::kBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + T - 1) / T, Hkv);
  kernel<<<grid, kThreads, Layout<D>::kBytes, stream>>>(qmap, kmap, vmap, omap, seg, seg_start,
                                                          N, qpk, T, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wg

template <bool kRagged>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* seg,
                     const int* seg_start, void* o, int N, int Hq, int Hkv, int D, int dtype,
                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
#define DEFT_PREFILL_AT(DD)                                                               \
  if (D == DD) {                                                                         \
    if (dtype == 1)                                                                      \
      return wg::launch<DD, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale, s);  \
    if (dtype == 0)                                                                      \
      return mma::launch<float, DD, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale, \
                                             s);                                         \
  }
  DEFT_PREFILL_AT(64)
  DEFT_PREFILL_AT(96)
  DEFT_PREFILL_AT(128)
  DEFT_PREFILL_AT(256)
#undef DEFT_PREFILL_AT
  return cudaErrorInvalidValue;
}

}  // namespace deft

// dtype: 0 = float32, 1 = bfloat16.  q, o: (N, Hq, D), D 64, 96, 128 or 256;
// k, v: (N, Hkv, D), all contiguous and 16-byte aligned; bf16 takes
// Hq / Hkv <= 128.  Returns a cudaError_t code (0 = launched).
extern "C" int deft_prefill(const void* q, const void* k, const void* v, void* o,
                            int N, int Hq, int Hkv, int D, int dtype, float scale,
                            void* stream) {
  return deft::dispatch<false>(q, k, v, nullptr, nullptr, o, N, Hq, Hkv, D, dtype, scale,
                               stream);
}

// B8: as deft_prefill, plus seg and seg_start, (N,) int32 each (see the top
// of this file).
extern "C" int deft_ragged_prefill(const void* q, const void* k, const void* v,
                                   const int* seg, const int* seg_start, void* o, int N,
                                   int Hq, int Hkv, int D, int dtype, float scale,
                                   void* stream) {
  if (seg == nullptr || seg_start == nullptr) return cudaErrorInvalidValue;
  return deft::dispatch<true>(q, k, v, seg, seg_start, o, N, Hq, Hkv, D, dtype, scale,
                              stream);
}
