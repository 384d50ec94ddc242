// The tensor-core body of the flatten tree-decode kernels over bf16 q,
// deft_flat_q, shared by paged_flatten.cu (B1, B1p, B4, B4p: plan tokens
// read through the segment table, deft::SegRows; head_dim 64 and 128) and
// flatten_gather.cu (B6, B11: one pool row a plan token, deft::IdxRows;
// head_dim 64, 96, 128 and 256).  fp32 q (the exactness checks) keeps
// flatten_body.cuh's staged body.
#pragma once

#include <type_traits>

#include "flatten_body.cuh"
#include "hopper.cuh"

// -- bf16 q: tensor cores, a cp.async ring, spans of the live tiles --
//
// One body for bf16 pools (B1, B1p, B6, B11) and int8 pools (B4, B4p, B6,
// B11), templated on the pool type and on the row source (Rows: plan token
// bt of block b is pool row rows.row(b, bt, block_len)).  Bound on this
// card: bytes, the live KV (int8: codes and scales) read once.  At 128
// folded rows a block the products are 4 * 128 FLOPs a bf16 KV element per
// row tile, about what those bytes allow, so the products' pace matters as
// much as the copies': over bf16 pools they run on wgmma (on an H100, a
// block took ~3.2 us a 64-token tile on mma.sync, each of its 8 warps
// reading the whole tile from shared memory, ~2.0 us on wgmma, with a warm
// L2 no faster than a cold one); over int8 pools on mma.sync, since wgmma
// takes its B operand from shared memory only, and the codes are widened in
// registers.
// One block of W warps (W = 8: 128 folded rows, two warpgroups; W = 4 where
// a head has at most 64 rows) per (row tile, KV head, span), in a 1-D grid.  What each part
// of the design answers in flatten_body.cuh's staged body (B1's before this
// body, which fp32 q still runs):
// - Too few blocks, dead ones among them: that body takes its span count
//   from the state/KV byte ratio over every plan block (64 spans on the
//   main tree, whose 64 blocks hold 41 live ones), bps = ceil(nb / spans),
//   so tail spans hold only the dead bucket tail.  Here the wrapper picks
//   the spans from the SM count (paged_flatten_attn.q_spans): one block an
//   SM.  Spans split the 64-token tiles of the plan blocks this row tile
//   sees (the block's leaf interval meets the tile's leaves, or it is
//   FULL), listed once by warp 0, so no span holds a dead block.
// - Row tiles of unequal work (a multi-tree gather plan, B6 on the batch
//   path: 136 listed tiles on the busiest row tile, none on the last): the
//   host counts each row tile's tiles from the numpy plan, and the wrapper
//   takes more spans where the busiest row tile would otherwise hold an
//   SM far longer than the card's mean (paged_flatten_attn.balanced_spans);
//   the 1-D grid launches a row tile's blocks together, so the lighter
//   blocks fill the SMs behind the long ones.  With the span outermost (a
//   3-D grid) the busiest row tile's last spans launched last: 0.135 ms on
//   the batch plan against 0.108 (PERF.md §6).
// - No copy in flight during the products: a 4-stage ring of 64-token
//   tiles (K and V rows, for int8 their fp32 scales, the tokens' leaf
//   intervals), cp.async by every thread, one block barrier a tile, the
//   copies of the next three tiles in flight while a tile is multiplied;
//   the pool rows of the tile after those are read a tile ahead, and those
//   of the first three all at once.  cp.async and not TMA: a tile gathers
//   64 / seg_len + 1 segments or fewer (seg_len 32 on the main path: two
//   boxes a tile at least), and a gather plan's tile 64 rows of its own,
//   while cp.async puts 16-byte chunks of rows at any address with no
//   tensor map and no mbarrier; it writes bf16 rows straight into the
//   128-byte-swizzled boxes wgmma reads (TMA's SWIZZLE_128B placement),
//   and each thread fences its copies into the async proxy before the
//   block barrier.
// - KV re-read per row tile: 128 rows a block read each tile once for
//   every row of the tile, so the main tree's 256 folded rows a head read
//   the tree's KV twice, not four times (the staged body's 64-row tiles).
// - The merge: each block writes its span's (acc, m, l) to scratch in
//   flatten_body.cuh's layout and its merge kernel follows (o = acc / l, or
//   for the partial entries the merged state, m in natural log).  Merging
//   the spans of a (row tile, head) inside a thread-block cluster instead
//   was tried: at one block an SM an H100 does not keep every pair's
//   cluster of 8 (main grid) or 16 (sharded grid) resident at once, and
//   fewer spans, to fit the clusters, were slower or level on every path
//   shape (PERF.md §6).
// Products: Q's A fragments in registers (loaded once), P from the S
// accumulators (the same fragment layout for mma.sync and wgmma), P
// rounded to bf16 for P V, l over the unrounded P.
// - bf16 pools: per warpgroup (64 rows) and tile, S = Q K^T as D / 16 RS
//   wgmma m64n64k16 over K's rows K-major, O += P V as 4 RS wgmma m64nDk16
//   over V's rows N-major (the transpose bit); nothing is widened.  Output
//   column n of n-tile nt is d = 8 nt + n.
// - int8 pools: per warp (16 rows), mma.sync m16n8k16 with the codes
//   widened in registers into the fragments (deft::hopper::widen4), as
//   B5's body does: the D axis permuted in Q's A fragments so a thread's K
//   fragment is 4 bytes of one token's row a k16 step, two tokens' V words
//   paired with `prmt` for P V, output column n of n-tile nt at d = (D / 8)
//   n + nt.  Scales in deft_tpu's rounding order (ops/paged_quant.py:
//   150-177): the K scale on the scores after the product, the V scale on
//   P before P is rounded to bf16, l over the unscaled P.
// A FULL block takes no mask; the rows of a product (a warp's, a
// warpgroup's) skip a tile none of them sees (a FULL block's tiles where
// their leaves are all past blk_hi, the pad rows).  Pad tokens (a segment's
// over-read tail, a gather plan's bucket pads at DUMP_SLOT or, in a
// multi-tree plan, at pool row 0) carry empty intervals (lo = 2^30, hi =
// 0): the masks send their scores to kNeg and so their P to exactly 0, and
// a tile of pads alone is skipped by every product.  The ring copies pool
// row 0 (DUMP_SLOT, which the pool never gives a live token, and where
// padded lanes store whatever they computed) as zeros, codes and scales
// alike, reading nothing, so that a pad's row, finite or not, never meets a
// product (0 x NaN is NaN); the rows of a segment's over-read tail are live
// tokens' and are read (taking them as row 0 too, from their intervals
// loaded a tile ahead, put those loads on the copies' path: slower on every
// wide-head and batch plan, PERF.md §6).  A row that sees no token of a
// tile keeps its running max at or above kMClamp, so no exp2 takes inf -
// inf.
// The wide heads (B6 and B11 only: Phi-3-mini's D 96, Gemma-7B's D 256),
// as Layout<KV, D> sets them:
// - D 96 over bf16 pools is one 64-column box and half of a second: a row's
//   12 chunks fill box 0 and chunks 0-3 of box 1 (the chunk map).  S issues
//   the 6 k16 steps over live columns; P V runs at N 128 over both boxes,
//   since an N-major operand under 128-byte swizzle comes in whole 64-column
//   atoms (no 96-wide descriptor), and the 64 bytes of each row of box 1
//   that cp.async never writes are zeroed once a stage at the start, so O's
//   columns 96-127 hold zeros, which the epilogue does not store.
// - D 256 over bf16 pools: Q's A fragments (64 registers) beside O of
//   m64n256 (128), S (32) and P (16) would take 240 of the 255 registers a
//   thread may hold before any address, so Q is staged once in shared
//   memory as its warpgroup's four K-major boxes and S runs SS wgmma; P V
//   is one RS m64n256k16 a k16 step over V's four boxes.  A 64-token stage
//   of four K and four V boxes is 65 KB, so the ring holds 2 stages (one
//   tile's copies in flight while a tile is multiplied) beside 32 KB (W 4)
//   or 64 KB (W 8) of Q; 4 stages of 32-token tiles were slower on Gemma's
//   main tree (PERF.md §6).
// - int8 pools at D 96 and 256: rows keep the pitch D + 16.  A thread's K
//   fragment words are D / 4 bytes of a token row (24 at D 96, read as three
//   8-byte words, the row offset 24 tig being 8-byte aligned only; 64 at D
//   256), its V words D / 8 bytes (12 and 32), read one word u of the four
//   rows at a time.  At D 256 O (128 registers) and Q's fragments (64) do
//   not fit beside S, so each thread stages its Q fragments once in shared
//   memory in its own order (lanes adjacent, no bank conflict) and reads
//   them back four k16 steps at a time.
namespace deft_flat_q {

constexpr int kFull = 1 << 30;   // list entry: plan block | kFull for a FULL block
constexpr int kMaxSmem = 231424;  // dynamic shared memory asked for: 227 KB less 1 KB
constexpr int kQBox = 64 * 128;  // bf16 Q staged (D 256): a 64-column box of a warpgroup's rows
constexpr int kDumpRow = 0;      // DUMP_SLOT (core/kv_pool.py): copied as zeros

template <typename KV, int D>
struct Layout {
  static constexpr bool kQ = std::is_same<KV, int8_t>::value;
  static constexpr int kNB = (D + 63) / 64;    // bf16: 64-column boxes across D
  static constexpr int DN = kQ ? D : 64 * kNB;  // O's columns (bf16: P V's N, whole boxes)
  static constexpr bool kQSmem = D > 128;       // Q staged in shared memory (D 256)
  static constexpr int kTok = 64;               // tokens a tile
  static constexpr int kStages = !kQ && D > 128 ? 2 : 4;
  // int8: rows padded by 16 bytes (read into mma.sync fragments); bf16: as
  // wgmma reads a K-major (K) or N-major (V) operand, 64-column boxes of kTok
  // rows x 128 bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8)
  static constexpr int P = kQ ? D + 16 : 128;  // row pitch, bytes
  static constexpr int kBox = kTok * 128;      // bf16: one 64-column box
  static constexpr int kRows = kQ ? kTok * P : kNB * kBox;
  static constexpr int kScales = kQ ? 2 * kTok * 4 : 0;  // K and V scales (int8)
  // K, V; scales; lo, hi; a stage a whole number of 1024-byte swizzle atoms
  static constexpr int kStage = (2 * kRows + kScales + 2 * kTok * 4 + 1023) / 1024 * 1024;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kQWarp = kQSmem ? 16 * D * 2 : 0;  // staged Q bytes a warp
  // where chunk ch (16 bytes) of the tile's token row tok lands
  static __device__ __forceinline__ int chunk(int tok, int ch) {
    if constexpr (kQ) return tok * P + ch * 16;
    else return (ch / 8) * kBox + tok * 128 + (((ch % 8) ^ (tok & 7)) << 4);
  }
};

// 4 bytes, or 4 zeros where !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

using deft::hopper::cp_async_commit;
using deft::hopper::cp_async_wait;

// x, which the compiler must take as changed here (so what is computed from
// it is not hoisted out of the loop that calls this)
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

template <typename KV, int D, int W, typename Rows>
__global__ void __launch_bounds__(W * 32, 1)
    flatten_q_mma(const __nv_bfloat16* __restrict__ q, deft::Pools<KV> pools,
                  Rows rows, const int* __restrict__ tok_lo,
                  const int* __restrict__ tok_hi, const int* __restrict__ blk_lo,
                  const int* __restrict__ blk_hi, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int R, int Hq, int Hkv,
                  int nb, int block_len, int spans, float s2) {
  using L = Layout<KV, D>;
  constexpr int NT = W * 32, RB = 16 * W, BN = L::kTok, NS = L::kStages;
  constexpr int CPR = D * static_cast<int>(sizeof(KV)) / 16;  // 16-byte chunks of a row
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));       // elements a chunk
  // each warp copies TPW of a tile's token rows, lane l holding the pool row
  // of token l % TPW (shuffled to the lanes copying its chunks): CH chunks a
  // lane, chunk c * 32 + lane of the warp's rows (int8 D 96 at W 8: 1.5, the
  // last partial)
  constexpr int TPW = BN / W, WCH = TPW * CPR, CH = (WCH + 31) / 32;
  static_assert(TPW * W == BN && 2 * TPW <= 32, "tile split");
  static_assert(RB * (D + 1) * 4 <= L::kRing, "the staged state fits the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring at a 1024-byte boundary (the swizzle atom), staged Q, then the list
  unsigned char* base =
      smem_raw + ((1024 - (deft::hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base + L::kRing;
  int* list = reinterpret_cast<int*>(qs + W * L::kQWarp);  // nb entries
  int* list_hi = list + nb;                                 // their blk_hi
  __shared__ int n_list;
  const int qpk = Hq / Hkv, Rq = R * qpk;
  // block b of the 1-D grid: row tile b / (Hkv * spans), then its KV head,
  // then its span, so a row tile's blocks launch together
  const int per_tile = Hkv * spans;
  const int r0 = blockIdx.x / per_tile * RB;
  const int h = blockIdx.x % per_tile / spans, span = blockIdx.x % spans;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int leaf_a = r0 / qpk, leaf_b = (min(Rq, r0 + RB) - 1) / qpk;

  // the plan blocks this row tile sees, in plan order (dead blocks and
  // blocks whose leaf interval misses the tile left out)
  if (warp == 0) {
    int count = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      bool keep = false, full = false;
      if (b < nb) {
        const int lo = blk_lo[b], hi = blk_hi[b];
        full = lo < -(1 << 20);
        keep = hi > leaf_a && (full || (lo < hi && lo <= leaf_b));
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int i = count + __popc(bal & ((1u << lane) - 1));
        list[i] = b | (full ? kFull : 0);
        list_hi[i] = blk_hi[b];
      }
      count += __popc(bal);
    }
    if (lane == 0) n_list = count;
  }
  // Q's A fragments, rows g (hh 0) and g + 8 (hh 1) of the warp's 16, step
  // ks: int8, d = (D / 4) tig + 4 ks + 0, 1 (a0, a1) and + 2, 3 (a2, a3);
  // bf16, d = 16 ks + 2 tig + 0, 1 (a0, a1) and + 8, 9 (a2, a3).  In
  // registers, or at D 256 staged: bf16 as the warpgroup's K-major boxes
  // (row rr of the block, chunk ch at box ch / 8 of warpgroup rr / 64),
  // int8 as each thread's fragments, step ks at uint4 ks * 32 + lane
  const int wr = r0 + 16 * warp;
  uint32_t qa[L::kQSmem ? 1 : D / 16][4];
  if constexpr (L::kQSmem && !L::kQ) {
    constexpr int QC = D / 8;  // 16-byte chunks of a q row
    for (int u = tid; u < RB * QC; u += NT) {
      const int rr = u / QC, ch = u % QC, r = r0 + rr;
      const bool ok = r < Rq;
      const long long src =
          ok ? ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D + ch * 8 : 0;
      deft::cp_async16(qs + (rr / 64) * L::kNB * kQBox + (ch / 8) * kQBox + (rr % 64) * 128 +
                           (((ch % 8) ^ (rr & 7)) << 4),
                       q + src, ok);
    }
    cp_async_commit();  // waited for with the ring's first tile
  } else {
    uint4* qf = reinterpret_cast<uint4*>(qs + warp * L::kQWarp);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wr + g + 8 * hh;
        const __nv_bfloat16* qr = q + ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D +
                                  (L::kQ ? (D / 4) * tig : 2 * tig);
        const int d0 = L::kQ ? 4 * ks : 16 * ks, d1 = L::kQ ? 4 * ks + 2 : 16 * ks + 8;
        a[hh] = r < Rq ? *reinterpret_cast<const uint32_t*>(qr + d0) : 0u;
        a[2 + hh] = r < Rq ? *reinterpret_cast<const uint32_t*>(qr + d1) : 0u;
      }
      if constexpr (L::kQSmem) {
        qf[ks * 32 + lane] = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[ks][i] = a[i];
      }
    }
  }
  // D 96 over bf16 pools: the chunks 4-7 of box 1 of every K and V row,
  // which no copy writes, hold zeros (P V reads them at N 128)
  if constexpr (!L::kQ && D % 64) {
    constexpr int live = (D % 64) / 8, dead = 8 - live;
    for (int i = tid; i < NS * 2 * BN * dead; i += NT) {
      const int c = live + i % dead, tok = i / dead % BN, part = i / (dead * BN);
      *reinterpret_cast<uint4*>(base + part / 2 * L::kStage + part % 2 * L::kRows +
                                (L::kNB - 1) * L::kBox + tok * 128 + ((c ^ (tok & 7)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  // this span's share of the listed blocks' tiles
  const int tpb = block_len / BN;
  const long long total = (long long)n_list * tpb;
  const int t0 = static_cast<int>(total * span / spans);
  const int n = static_cast<int>(total * (span + 1) / spans) - t0;

  // the pool row of token warp * TPW + lane % TPW of tile j
  auto row_of = [&](int j) {
    if (j >= n) return kDumpRow;
    const int li = t0 + j;
    return rows.row(list[li / tpb] & (kFull - 1),
                    (li % tpb) * BN + warp * TPW + lane % TPW, block_len);
  };
  // start copying tile j into its stage (an empty group past the span)
  auto issue = [&](int j, int row) {
    if (j < n) {
      uint8_t* st = base + (j % NS) * L::kStage;
      const int li = t0 + j, e = list[li / tpb], bt0 = (li % tpb) * BN;
      // at D 256 one chunk's shuffle and addresses at a time: unrolled, the
      // 16 (or 8) copies' addresses beside O spilled registers
#pragma unroll (D > 128 ? 1 : CH)
      for (int c = 0; c < CH; ++c) {
        const int v = c * 32 + lane, tl = v / CPR, ch = v % CPR;
        const int r = __shfl_sync(0xffffffffu, row, tl);
        if (WCH % 32 != 0 && v >= WCH) continue;
        const int tok = warp * TPW + tl;
        const long long src = pools.layer_off + ((long long)r * Hkv + h) * D + ch * EPC;
        deft::cp_async16(st + L::chunk(tok, ch), pools.k + src, r != kDumpRow);
        deft::cp_async16(st + L::kRows + L::chunk(tok, ch), pools.v + src, r != kDumpRow);
      }
      if constexpr (L::kQ) {  // lanes < TPW the K scales of the warp's rows, then V's
        if (lane < 2 * TPW)
          cp_async4(st + 2 * L::kRows + 4 * ((lane / TPW) * BN + warp * TPW + lane % TPW),
                    (lane < TPW ? pools.ks : pools.vs) + pools.scale_off +
                        (long long)h * pools.S + row,
                    row != kDumpRow);
      }
      if (!(e & kFull) && tid < BN / 2) {  // the tokens' leaf intervals
        const long long t =
            (long long)(e & (kFull - 1)) * block_len + bt0 + 4 * (tid % (BN / 4));
        deft::cp_async16(st + 2 * L::kRows + L::kScales + 16 * tid,
                         (tid < BN / 4 ? tok_lo : tok_hi) + t, true);
      }
    }
    cp_async_commit();
  };

  const int row0 = wr + g, leaf0 = row0 / qpk, leaf1 = (row0 + 8) / qpk;
  // the rows a tile's products cover: the warp's 16 (int8: mma.sync) or its
  // warpgroup's 64 (bf16: wgmma, which the warpgroup issues together)
  constexpr int SR = L::kQ ? 16 : 64;
  const int sr = r0 + (L::kQ ? 16 * warp : 64 * (warp / 4));
  const int sleaf_a = sr / qpk, sleaf_b = (min(Rq, sr + SR) - 1) / qpk;
  float o_acc[L::DN / 2];  // n-tile nt's fragment at o_acc[4 nt .. + 3]
#pragma unroll
  for (int i = 0; i < L::DN / 2; ++i) o_acc[i] = 0.f;
  float m[2] = {deft::kNeg, deft::kNeg}, l[2] = {0.f, 0.f};  // base-2 max, sum
  // the prologue's tiles: their pool rows read together, then their copies
  {
    int rp[NS - 1];
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) rp[p] = row_of(p);
#pragma unroll
    for (int p = 0; p < NS - 1; ++p) issue(p, rp[p]);
  }
  int rw = row_of(NS - 1);
  for (int it = 0; it < n; ++it) {
    cp_async_wait<NS - 2>();
    // this thread's copies of tile it (and at D 256 of Q) are in shared
    // memory; wgmma reads them through the async proxy
    if constexpr (!L::kQ) deft::hopper::fence_proxy_async();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    issue(it + NS - 1, rw);
    rw = row_of(it + NS);
    if (sr >= Rq) continue;
    const uint8_t* st = base + (it % NS) * L::kStage;
    const int li = (t0 + it) / tpb;
    const bool full = list[li] & kFull;
    if (full && sleaf_a >= list_hi[li]) continue;  // the rows are past the leaves
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kRows);  // int8
    const float* vsc = ksc + BN;
    const int* lo = reinterpret_cast<const int*>(st + 2 * L::kRows + L::kScales);
    const int* hi = lo + BN;
    if (!full) {  // skip a tile none of the rows sees
      bool any = false;
#pragma unroll
      for (int k = lane; k < BN; k += 32)
        any |= lo[k] < hi[k] && lo[k] <= sleaf_b && hi[k] > sleaf_a;
      if (!__any_sync(0xffffffffu, any)) continue;
    }
    // S = Q K^T: s[4 n8 + i], row g (i < 2) or g + 8, token n8 * 8 + 2 tig + i % 2
    float s[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    if constexpr (L::kQ) {
      // K's fragment of step ks: bytes (D / 4) tig + 4 ks .. + 3 of token
      // row n8 * 8 + g, widened into b0, b1
      const uint8_t* kr0 = st + g * L::P + (D / 4) * tig;
      if constexpr (L::kQSmem) {
        const uint4* qf = reinterpret_cast<const uint4*>(qs + warp * L::kQWarp);
#pragma unroll
        for (int v = 0; v < D / 64; ++v) {  // steps 4 v .. + 3: 16 bytes of K a row
          uint32_t qv[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint4 t = qf[(4 * v + j) * 32 + lane];
            qv[j][0] = t.x;
            qv[j][1] = t.y;
            qv[j][2] = t.z;
            qv[j][3] = t.w;
          }
#pragma unroll
          for (int n8 = 0; n8 < BN / 8; ++n8) {
            const uint4 c = *reinterpret_cast<const uint4*>(kr0 + n8 * 8 * L::P + 16 * v);
            const uint32_t kw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              uint32_t b0, b1;
              deft::hopper::widen4(kw[j], b0, b1);
              deft::mma_bf16(s + 4 * n8, qv[j], b0, b1);
            }
          }
        }
      } else {
#pragma unroll
        for (int n8 = 0; n8 < BN / 8; ++n8) {
          const uint8_t* kr = kr0 + n8 * 8 * L::P;
          uint32_t kw[D / 16];
          if constexpr (D % 64 == 0) {
#pragma unroll
            for (int v = 0; v < D / 64; ++v) {
              const uint4 c = *reinterpret_cast<const uint4*>(kr + 16 * v);
              kw[4 * v] = c.x;
              kw[4 * v + 1] = c.y;
              kw[4 * v + 2] = c.z;
              kw[4 * v + 3] = c.w;
            }
          } else {  // D 96: 24 bytes at an 8-byte-aligned offset
#pragma unroll
            for (int v = 0; v < D / 32; ++v) {
              const uint2 c = *reinterpret_cast<const uint2*>(kr + 8 * v);
              kw[2 * v] = c.x;
              kw[2 * v + 1] = c.y;
            }
          }
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t b0, b1;
            deft::hopper::widen4(kw[ks], b0, b1);
            deft::mma_bf16(s + 4 * n8, qa[ks], b0, b1);
          }
        }
      }
    } else {
      // m64n64k16 a k16 step: Q's A fragments from registers (RS) or its
      // staged boxes (SS, D 256), K's 64 token rows K-major from box ks / 4,
      // 32 bytes further a step within it; D 96 issues the 6 live steps
      deft::hopper::wgmma_fence();
      if constexpr (L::kQSmem) {
        // step ks adds its byte offset / 16 to the start-address field; the
        // base is laundered each tile, so no table of 16 descriptors is
        // hoisted out of the loop into registers
        const uint64_t da = opaque(deft::hopper::desc_sw128(
                           qs + (warp / 4) * L::kNB * kQBox, 16, 1024)),
                       db = deft::hopper::desc_sw128(st, 16, 1024);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          deft::hopper::wgmma_m64n64k16_ss<0>(s, da + ((ks / 4) * kQBox + (ks % 4) * 32) / 16,
                                              db + ((ks / 4) * L::kBox + (ks % 4) * 32) / 16);
      } else {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          deft::hopper::wgmma_m64n64k16_rs<0>(
              s, qa[ks],
              deft::hopper::desc_sw128(st + (ks / 4) * L::kBox + (ks % 4) * 32, 16, 1024));
      }
      deft::hopper::wgmma_commit();
      deft::hopper::fence_regs(s);
      deft::hopper::wgmma_wait<0>();
      deft::hopper::fence_regs(s);
    }
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8) {
      const int c = n8 * 8 + 2 * tig;
      float k0 = s2, k1 = s2;
      if constexpr (L::kQ) {
        const float2 k2 = *reinterpret_cast<const float2*>(ksc + c);
        k0 *= k2.x;
        k1 *= k2.y;
      }
      s[4 * n8] *= k0;
      s[4 * n8 + 1] *= k1;
      s[4 * n8 + 2] *= k0;
      s[4 * n8 + 3] *= k1;
      if (!full) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tl = lo[c + e], th = hi[c + e];
          if (!(tl <= leaf0 && leaf0 < th)) s[4 * n8 + e] = deft::kNeg;
          if (!(tl <= leaf1 && leaf1 < th)) s[4 * n8 + 2 + e] = deft::kNeg;
        }
      }
    }
    // online softmax of rows g, g + 8
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = deft::kNeg;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8)
        mx = fmaxf(mx, fmaxf(s[4 * n8 + 2 * hh], s[4 * n8 + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(m[hh], mx), deft::kMClamp);
      float sum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < BN / 8; ++n8) {
        s[4 * n8 + 2 * hh] = exp2f(s[4 * n8 + 2 * hh] - m_new);
        s[4 * n8 + 2 * hh + 1] = exp2f(s[4 * n8 + 2 * hh + 1] - m_new);
        sum += s[4 * n8 + 2 * hh] + s[4 * n8 + 2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hh] = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * alpha[hh] + sum;  // the unscaled, unrounded P
      m[hh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < L::DN / 8; ++nt) {
      o_acc[4 * nt] *= alpha[0];
      o_acc[4 * nt + 1] *= alpha[0];
      o_acc[4 * nt + 2] *= alpha[1];
      o_acc[4 * nt + 3] *= alpha[1];
    }
    // O += P V, 16 tokens a k16 step kk: P's A fragment from the S
    // fragments of tokens 16 kk .. + 15 (int8: times the V scales), in bf16
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      float v0x = 1.f, v0y = 1.f, v1x = 1.f, v1y = 1.f;
      if constexpr (L::kQ) {
        const float2 v0 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 2 * tig);
        const float2 v1 = *reinterpret_cast<const float2*>(vsc + 16 * kk + 2 * tig + 8);
        v0x = v0.x;
        v0y = v0.y;
        v1x = v1.x;
        v1y = v1.y;
      }
      const float* sk = s + 8 * kk;
      pa[kk][0] = deft::pack_bf16(sk[0] * v0x, sk[1] * v0y);
      pa[kk][1] = deft::pack_bf16(sk[2] * v0x, sk[3] * v0y);
      pa[kk][2] = deft::pack_bf16(sk[4] * v1x, sk[5] * v1y);
      pa[kk][3] = deft::pack_bf16(sk[6] * v1x, sk[7] * v1y);
    }
    if constexpr (L::kQ) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // V's tokens 2 tig, 2 tig + 1 (b0) and + 8, + 9 (b1) at d = (D / 8) g + nt
        const uint8_t* vr = st + L::kRows + (16 * kk) * L::P + (D / 8) * g;
        auto row = [&](int r) { return vr + (2 * tig + (r & 1) + 8 * (r >> 1)) * L::P; };
        // word u of the four rows: n-tiles 4 u .. + 3
        auto pv = [&](int u, const uint32_t(&w)[4]) {
          uint32_t b0w[4], b1w[4];
          deft::hopper::widen4(deft::hopper::pair_lo(w[0], w[1]), b0w[0], b0w[1]);
          deft::hopper::widen4(deft::hopper::pair_hi(w[0], w[1]), b0w[2], b0w[3]);
          deft::hopper::widen4(deft::hopper::pair_lo(w[2], w[3]), b1w[0], b1w[1]);
          deft::hopper::widen4(deft::hopper::pair_hi(w[2], w[3]), b1w[2], b1w[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            deft::mma_bf16(o_acc + 4 * (4 * u + j), pa[kk], b0w[j], b1w[j]);
        };
        if constexpr (D == 64 || D == 128) {  // the rows' words read at once
          uint32_t vw[4][D / 32];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (D == 128) {
              const uint4 c = *reinterpret_cast<const uint4*>(row(r));
              vw[r][0] = c.x;
              vw[r][1] = c.y;
              vw[r][2] = c.z;
              vw[r][3] = c.w;
            } else {
              const uint2 c = *reinterpret_cast<const uint2*>(row(r));
              vw[r][0] = c.x;
              vw[r][1] = c.y;
            }
          }
#pragma unroll
          for (int u = 0; u < D / 32; ++u) pv(u, {vw[0][u], vw[1][u], vw[2][u], vw[3][u]});
        } else {  // D 96 (12 bytes, 4-byte aligned) and 256 (32): a word at a time
#pragma unroll
          for (int u = 0; u < D / 32; ++u) {
            uint32_t w[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) w[r] = *reinterpret_cast<const uint32_t*>(row(r) + 4 * u);
            pv(u, w);
          }
        }
      }
    } else {
      // m64nDNk16 a k16 step: P from registers, V's 16 token rows N-major
      // (the transpose bit), the 64-column boxes kBox bytes apart
      deft::hopper::fence_regs(o_acc);
      deft::hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        deft::hopper::wgmma_rs_nmajor<L::DN>(
            o_acc, pa[kk],
            deft::hopper::desc_sw128(st + L::kRows + kk * 16 * 128, L::kBox, 1024));
      deft::hopper::wgmma_commit();
      deft::hopper::fence_regs(o_acc);
      deft::hopper::wgmma_wait<0>();
      deft::hopper::fence_regs(o_acc);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) deft::hopper::fence_regs(pa[kk]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its 16 rows there

  // the span's unnormalised state: acc (spans, Hkv, Rq, D), m/l (spans, Hkv,
  // Rq), base-2 m, merged by flatten_body.cuh's merge kernel
  constexpr int PD = D + 1;
  float* stage = reinterpret_cast<float*>(base) + warp * 16 * PD;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = L::kQ ? (D / 8) * (2 * tig + e) + nt : 8 * nt + 2 * tig + e;
      stage[g * PD + d] = o_acc[4 * nt + e];
      stage[(g + 8) * PD + d] = o_acc[4 * nt + 2 + e];
    }
  __syncwarp();
  const long long ob = ((long long)span * Hkv + h) * Rq;
  for (int rr = 0; rr < 16 && wr + rr < Rq; ++rr)
    for (int d = lane; d < D; d += 32) acc_out[(ob + wr + rr) * D + d] = stage[rr * PD + d];
  if (tig == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      if (r < Rq) {
        m_out[ob + r] = m[hh];
        l_out[ob + r] = l[hh];
      }
    }
  }
}

template <typename KV, int D, int W>
constexpr size_t smem_bytes(int nb) {
  // 1024: the ring's alignment
  return 1024 + Layout<KV, D>::kRing + W * Layout<KV, D>::kQWarp + 2 * sizeof(int) * nb;
}

template <typename KV, int D, int W, typename Rows>
cudaError_t launch(const void* q, deft::Pools<KV> pools, Rows rows,
                   const int* tok_lo, const int* tok_hi, const int* blk_lo, const int* blk_hi,
                   float* acc, float* m, float* l, void* o, float* m_o, float* l_o, int R,
                   int Hq, int Hkv, int nb, int block_len, int n_spans, float scale,
                   cudaStream_t stream) {
  auto kernel = flatten_q_mma<KV, D, W, Rows>;
  static const cudaError_t attr = deft::allow_smem(kernel, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const size_t smem = smem_bytes<KV, D, W>(nb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int rq = R * (Hq / Hkv);
  const long long blocks = (long long)((rq + 16 * W - 1) / (16 * W)) * Hkv * n_spans;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), W * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), pools, rows, tok_lo, tok_hi, blk_lo, blk_hi,
      acc, m, l, R, Hq, Hkv, nb, block_len, n_spans, scale * deft::kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 mgrid((rq + 3) / 4, Hkv);
  deft::flatten_merge_kernel<__nv_bfloat16>
      <<<mgrid, 128, 0, stream>>>(acc, m, l, o, m_o, l_o, n_spans, R, Hq, Hkv, D);
  return cudaGetLastError();
}

// Instantiate launch<KV, D, W> for head_dim 64 and 128 (with kWide, the
// gather entries, also 96 and 256) and W = 8 warps (128 rows) a block
// where a head has more than 64 folded rows, else 4
// (paged_flatten_attn.q_block_rows mirrors this choice).
template <typename KV, bool kWide, typename Rows>
cudaError_t dispatch(const void* q, deft::Pools<KV> pools, Rows rows,
                     const int* tok_lo, const int* tok_hi, const int* blk_lo,
                     const int* blk_hi, float* acc, float* m, float* l, void* o, float* m_o,
                     float* l_o, int R, int Hq, int Hkv, int D, int nb, int block_len,
                     int n_spans, float scale, void* stream) {
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || n_spans <= 0 || nb <= 0 || block_len % 64 ||
      !m_o != !l_o)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w8 = R * (Hq / Hkv) > 64;
#define DEFT_FLAT_Q_AT(DV)                                                                 \
  if (D == DV) {                                                                           \
    if (w8)                                                                                \
      return launch<KV, DV, 8, Rows>(q, pools, rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, \
                                     l, o, m_o, l_o, R, Hq, Hkv, nb, block_len, n_spans,     \
                                     scale, st);                                             \
    return launch<KV, DV, 4, Rows>(q, pools, rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m,   \
                                   l, o, m_o, l_o, R, Hq, Hkv, nb, block_len, n_spans, scale, \
                                   st);                                                      \
  }
  DEFT_FLAT_Q_AT(64)
  DEFT_FLAT_Q_AT(128)
  if constexpr (kWide) {
    DEFT_FLAT_Q_AT(96)
    DEFT_FLAT_Q_AT(256)
  }
#undef DEFT_FLAT_Q_AT
  return cudaErrorInvalidValue;
}

}  // namespace deft_flat_q
