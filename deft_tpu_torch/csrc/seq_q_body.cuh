// The tensor-core bodies of the sequential per-leaf decode kernels over bf16
// q, deft_seq_q, shared by paged_seq.cu (B2, B2p, B5, B5p: each leaf's path
// read through its segment table, deft_seq::SegPath) and seq_gather.cu (B7:
// through its padded row of pool indices, deft_seq::IdxPath): seq_q_mma at
// head_dim 64 and 128, seq_q_wide (the operands swapped, below) at 96 and
// 256, which only B7 takes.  fp32 q (the exactness checks) keeps
// seq_body.cuh's FMA body.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"
#include "seq_body.cuh"

// -- bf16 q: tensor cores, per-warp spans, a cp.async ring -------------------------------
//
// One body for bf16 pools (B2, B2p, B7) and int8 pools (B5, B5p, B7),
// templated on the pool type and on the path source (Path: where path token
// i of a leaf lies in the pool).  One block of W warps (Traits<Path>: 4 over
// segment tables, 2 over path tables) per (leaf, KV head, span of the
// path): the leaf's live path is cut into 16-token tiles; the
// blocks of a cluster (gridDim.z, 1 .. 8, chosen by the wrapper from R, Hkv
// and the SM count where the (leaf, head) pairs alone would leave SMs idle)
// take consecutive spans of them, and each warp a span of its block's.  A
// warp runs alone through its span: a 3-stage ring of K and V rows (and for
// int8 their scales), filled by cp.async (rows are gathered one token at a
// time, so TMA's tiled mode does not apply), and its own online softmax
// (m, l, acc); no block barrier is taken per tile.  Over a path table the
// pool rows of a tile are read one tile before it is issued: each lane of
// a tile's 16 holds its token's row in a register while the tile before is
// multiplied, so the index load is in flight beside the products and the
// ring never waits on it; the first stages' rows are read together, and
// seq_lens[leaf] beside Q, so a short path waits on one index load, not
// three in a row (tile_ref, ref_row).
// Path sources:
// - SegPath (B2, B5 and their partial entries): warp 0 prefix-sums the
//   segments' live counts into shared memory once (blocks with blk_live 0
//   count none); path token i is then found by a binary search, so every
//   tile holds only live tokens and the segments' dead lead-ins and tails
//   are never read.
// - IdxPath (B7): path token i is pool row paths[leaf, i], i < seq_lens
//   [leaf]; no prefix sum and no search.  The pads past seq_lens (DUMP_SLOT)
//   are never read, nor their entries of paths; a leaf with seq_len 0 walks
//   no tile and writes zeros.
// Both products are mma.sync m16n8k16 with the query rows on M (qpk <= 8 of
// 16 rows live), P from the S accumulators (the FlashAttention-2 register
// reuse), P rounded to bf16 for P V.
// - bf16 pools: nothing is widened.  K's rows are S = Q K^T's B operand as
//   they lie in shared memory (ldmatrix, four 8x8 tiles a load: 8 tokens x
//   32 head dims), and V's rows P V's through ldmatrix.trans (16 tokens x 16
//   head dims a load); output column n of n-tile nt is d = 8 nt + n.  Rows
//   padded by 16 bytes keep the 8-row ldmatrix reads free of bank
//   conflicts.  What this answers in seq_body.cuh's body: fp32 FMA loops at
//   ~2 qpk FLOPs a byte with the tensor cores idle, 64-token tiles staged
//   behind block barriers with no copy in flight during the products, and
//   one block a (leaf, head) that never splits a path.
// - int8 pools: the D axis is permuted, identically in Q's A fragments
//   (registers, loaded once), so that a thread's B fragment of S is 4 bytes
//   of one token's row a k16 step: thread tig's step ks reads d = (D / 4)
//   tig + 4 ks .. + 3, widened in registers (deft::hopper::widen4); each
//   score is then times the token's K scale.  P times the token's V scale,
//   rounded to bf16, l summed over the unscaled, unrounded P (deft_tpu
//   ops/paged_seq_attn.py:197-222).  The scales are head-major (L, Hkv, S),
//   read at the token's pool row.  V's B fragment pairs two tokens at one d:
//   two rows' words are interleaved with `prmt` before widening; output
//   column n of n-tile nt is d = (D / 8) n + nt, so one 16-byte (D 64:
//   8-byte) load a token row feeds every n-tile.
// Bound on this card: bytes, each leaf re-reading its path (the shared
// prefix's re-reads hit L2 at the main tree, whose KV of a layer fits it at
// Llama-3.1-8B's heads).  At Gemma-7B's (16 x 256) a layer's KV at 4000
// tokens is 65.5 MB, more than the 50 MB L2, so the re-reads hit it only
// where the blocks sharing a KV head's path run together: the grid's x is
// the leaf, so a head's leaves are issued one after another, and the
// resident blocks hold a few heads' paths (4 MB each) at a time.
// At the end each warp leaves (m, l, acc) in shared memory; after a cluster
// barrier block r merges its share of the (row, d) outputs over every warp
// of every block of the cluster with the LSE rule of flatten_body.cuh's
// kernel 2, in a fixed order, and writes o = acc / l, or the partial state.
namespace deft_seq_q {

constexpr int kTile = 16;  // path tokens per tile: one k16 step of P V
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr float kNeg = deft_seq::kNeg;

// What differs by path source.  kWarps, warps a block: segment tables (B2,
// B5) 4; path tables (B7) 2, so that twice the blocks are resident at the
// same warps and ring bytes an SM (a bf16 block of 4 warps holds 104 KB of
// ring, two an SM): a gather plan's (leaf, head) pairs at the short tree,
// 64 x 8 with paths of about 21 tokens, then run in one wave, not two; on
// long paths each SM holds as many warps walking as many tiles as before.
// kAhead: a tile's pool rows are read one tile before it is issued (a path
// table's index loads from global memory), else found at issue (a segment
// table's search of shared memory, which gains nothing from running early).
template <typename Path>
struct Traits {
  static constexpr int kWarps = 4;
  static constexpr bool kAhead = false;
};
template <>
struct Traits<deft_seq::IdxPath> {
  static constexpr int kWarps = 2;
  static constexpr bool kAhead = true;
};

template <typename KV, int D, int W>
struct Layout {
  static constexpr bool kQ = std::is_same<KV, int8_t>::value;
  static constexpr int P = D * static_cast<int>(sizeof(KV)) + 16;  // row pitch, bytes
  static constexpr int kRows = kTile * P;
  static constexpr int kStage = 2 * kRows + (kQ ? 2 * kTile * 4 : 0);  // K, V rows (scales)
  static constexpr int kRing = W * kStages * kStage;
  // m, l, acc of 8 rows a warp; a row of acc holds a pad word every 32
  // columns, so that the columns a warp stores at once fall in distinct
  // banks: over int8 pools d = (D / 8) (2 tig + e) + nt, D / 4 apart over
  // tig, all in one bank at D 128 without the pad (a 32-way conflict: on
  // an H100, B7 over int8 pools at 21-token paths took 0.0164 ms with it,
  // 0.0124 ms without; PERF.md)
  static constexpr int kAccPitch = D + D / 32;
  static constexpr int kState = W * 8 * (2 + kAccPitch) * 4;
  static constexpr int kBytes = kRing > kState ? kRing : kState;
};

// -- path sources: the shared memory each needs, the path's length, and the
// pool row of path token i (i < the length)

// SegPath: cum[j] = live tokens before segment j, (nseg + 1) ints.
__host__ __device__ inline size_t path_smem(const deft_seq::SegPath& p) {
  return sizeof(int) * (p.nseg + 1);
}
__host__ __device__ inline size_t path_smem(const deft_seq::IdxPath&) { return 0; }

// Before the block barrier: SegPath's warp 0 fills cum (read after the
// barrier); IdxPath loads seq_lens[leaf], its load in flight beside Q's.
// Returns what path_total takes.
__device__ __forceinline__ int path_setup(const deft_seq::SegPath& path, int leaf, int* cum,
                                          int warp, int lane) {
  if (warp != 0) return 0;
  const long long seg_base = (long long)leaf * path.nseg;
  const int* live = path.seg_live + seg_base;
  const int* blive = path.blk_live + (long long)leaf * (path.nseg / path.spb);
  int carry = 0;
  if (lane == 0) cum[0] = 0;
  for (int j0 = 0; j0 < path.nseg; j0 += 32) {
    const int j = j0 + lane;
    int x = (j < path.nseg && blive[j / path.spb] > 0) ? live[j] : 0;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (j < path.nseg) cum[j + 1] = carry + x;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  return 0;
}
__device__ __forceinline__ int path_setup(const deft_seq::IdxPath& path, int leaf, int*, int,
                                          int) {
  return __ldg(path.seq_lens + leaf);
}

// The path's length, after the block barrier; `pre`: path_setup's value.
__device__ __forceinline__ int path_total(const deft_seq::SegPath& path, int,
                                          const int* cum) {
  return cum[path.nseg];
}
__device__ __forceinline__ int path_total(const deft_seq::IdxPath& path, int pre,
                                          const int*) {
  return min(pre, path.C);
}

// A lane's reference to its token of a tile, and the pool row it resolves
// to when the tile is issued.  SegPath: the path position i, resolved by a
// binary search of cum.  IdxPath: the pool row paths[leaf, i] itself, read
// a tile ahead (Traits::kAhead).
__device__ __forceinline__ int path_ref(const deft_seq::SegPath&, int, int i) { return i; }
__device__ __forceinline__ int path_ref(const deft_seq::IdxPath& path, int leaf, int i) {
  return __ldg(path.paths + (long long)leaf * path.C + i);
}

__device__ __forceinline__ int ref_row(const deft_seq::SegPath& path, int leaf, const int* cum,
                                       int i) {
  if (i < 0) return -1;
  const long long seg_base = (long long)leaf * path.nseg;
  int a = 0, b = path.nseg;  // largest j with cum[j] <= i
  while (b - a > 1) {
    const int c = (a + b) / 2;
    if (cum[c] <= i) a = c; else b = c;
  }
  return path.seg_src[seg_base + a] + path.seg_off[seg_base + a] + (i - cum[a]);
}
__device__ __forceinline__ int ref_row(const deft_seq::IdxPath&, int, const int*, int row) {
  return row;
}

// Lane l < 16's reference to path token 16 t + l of tile t, or -1: a lane
// past the tile, a token at or past `total`.
template <typename Path>
__device__ __forceinline__ int tile_ref(const Path& path, int leaf, int t, int total, int lane) {
  const int i = t * kTile + lane;
  return lane < kTile && i < total ? path_ref(path, leaf, i) : -1;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

using deft::hopper::cp_async_commit;
using deft::hopper::cp_async_wait;

// Four 8x8 b16 tiles from shared memory, lane l addressing row l % 8 of tile
// l / 8; .trans: each tile transposed (the B fragment of a row-major B).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Start copying a tile of head h into stage st: lane l < 16 holds the pool
// row of the tile's token l (`row`, -1 for none: zero-filled); K and V rows,
// then for int8 K and V scales.
template <typename KV, int D>
__device__ __forceinline__ void issue_tile(uint8_t* st, int row,
                                           const deft_seq::SeqPools<KV>& pools, int h, int Hkv,
                                           int lane) {
  using L = Layout<KV, D, 1>;
  long long roff = -1, soff = -1;
  if (row >= 0) {
    roff = pools.layer_off + ((long long)row * Hkv + h) * D;
    soff = pools.scale_off + (long long)h * pools.S + row;
  }
  constexpr int EPC = 16 / sizeof(KV);  // elements a 16-byte chunk
  constexpr int CPR = D / EPC;          // chunks a row
#pragma unroll
  for (int u = lane; u < kTile * CPR; u += 32) {
    const int tok = u / CPR, c = u % CPR;
    const long long ro = __shfl_sync(0xffffffffu, roff, tok);
    const long long src = ro >= 0 ? ro + c * EPC : 0;
    deft::cp_async16(st + tok * L::P + c * 16, pools.k + src, ro >= 0);
    deft::cp_async16(st + L::kRows + tok * L::P + c * 16, pools.v + src, ro >= 0);
  }
  if constexpr (L::kQ) {
    const long long so = __shfl_sync(0xffffffffu, soff, lane % kTile);
    float* sc = reinterpret_cast<float*>(st + 2 * L::kRows);
    if (lane < kTile) cp_async4(sc + lane, pools.ks + (so >= 0 ? so : 0), so >= 0);
    else cp_async4(sc + lane, pools.vs + (so >= 0 ? so : 0), so >= 0);
  }
  cp_async_commit();
}

// S = Q K^T of one tile, s[nt8] over its 8-token n-tiles.
template <typename KV, int D>
__device__ __forceinline__ void tile_scores(float (&s)[2][4], const uint32_t (&qa)[D / 16][2],
                                            const uint8_t* st, int lane) {
  using L = Layout<KV, D, 1>;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt8 = 0; nt8 < 2; ++nt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt8][i] = 0.f;
    if constexpr (L::kQ) {
      const uint8_t* kr = st + (nt8 * 8 + g) * L::P + (D / 4) * tig;
      uint32_t kw[D / 16];
#pragma unroll
      for (int v = 0; v < D / 64; ++v) {
        const uint4 c = *reinterpret_cast<const uint4*>(kr + 16 * v);
        kw[4 * v] = c.x;
        kw[4 * v + 1] = c.y;
        kw[4 * v + 2] = c.z;
        kw[4 * v + 3] = c.w;
      }
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0w, b1w;
        deft::hopper::widen4(kw[ks], b0w, b1w);
        const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        deft::mma_bf16(s[nt8], a, b0w, b1w);
      }
    } else {
      // lane l: token nt8 * 8 + l % 8, head dims 8 (l / 8) .. + 7 of each 32
      const uint8_t* kr = st + (nt8 * 8 + lane % 8) * L::P + (lane / 8) * 16;
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t b[4];
        ldsm_x4(b, kr + 64 * kp);
        const uint32_t a0[4] = {qa[2 * kp][0], 0u, qa[2 * kp][1], 0u};
        const uint32_t a1[4] = {qa[2 * kp + 1][0], 0u, qa[2 * kp + 1][1], 0u};
        deft::mma_bf16(s[nt8], a0, b[0], b[1]);
        deft::mma_bf16(s[nt8], a1, b[2], b[3]);
      }
    }
  }
}

// O += P V of one tile, pa P's A fragment (rows g < qpk).
template <typename KV, int D>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4], const uint32_t (&pa)[4],
                                        const uint8_t* st, int lane) {
  using L = Layout<KV, D, 1>;
  const int g = lane / 4, tig = lane % 4;
  if constexpr (L::kQ) {
    // tokens 2 tig, 2 tig + 1 (b0) and + 8, + 9 (b1), d = (D / 8) g + nt
    const uint8_t* vr = st + L::kRows + (D / 8) * g;
    uint32_t vw[4][D / 32];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint8_t* p = vr + (2 * tig + (r & 1) + 8 * (r >> 1)) * L::P;
      if constexpr (D == 128) {
        const uint4 c = *reinterpret_cast<const uint4*>(p);
        vw[r][0] = c.x;
        vw[r][1] = c.y;
        vw[r][2] = c.z;
        vw[r][3] = c.w;
      } else {
        const uint2 c = *reinterpret_cast<const uint2*>(p);
        vw[r][0] = c.x;
        vw[r][1] = c.y;
      }
    }
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      uint32_t b0w[4], b1w[4];
      deft::hopper::widen4(deft::hopper::pair_lo(vw[0][u], vw[1][u]), b0w[0], b0w[1]);
      deft::hopper::widen4(deft::hopper::pair_hi(vw[0][u], vw[1][u]), b0w[2], b0w[3]);
      deft::hopper::widen4(deft::hopper::pair_lo(vw[2][u], vw[3][u]), b1w[0], b1w[1]);
      deft::hopper::widen4(deft::hopper::pair_hi(vw[2][u], vw[3][u]), b1w[2], b1w[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) deft::mma_bf16(acc[4 * u + j], pa, b0w[j], b1w[j]);
    }
  } else {
    // lane l: token l % 8 + 8 ((l / 8) & 1), head dims 8 (l / 16) .. + 7 of each 16
    const uint8_t* vr =
        st + L::kRows + (lane % 8 + 8 * ((lane / 8) & 1)) * L::P + (lane / 16) * 16;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vr + 32 * np);
      deft::mma_bf16(acc[2 * np], pa, b[0], b[1]);
      deft::mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
    }
  }
}

// Q's fragments of query row g (zero at g >= qpk), step ks: int8 pools,
// d = (D / 4) tig + 4 ks + 0, 1 (word 0) and + 2, 3 (word 1); bf16, d =
// 16 ks + 2 tig + 0, 1 and + 8, 9.  deft_seq_q takes them as its A
// fragments (rows g; rows g + 8 are zero), deft_seq_q's wide body as its B
// fragments (query row g on N).
template <typename KV, int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][2], const __nv_bfloat16* q,
                                       int leaf, int Hq, int h, int qpk, int lane) {
  constexpr bool kQ = std::is_same<KV, int8_t>::value;
  const int g = lane / 4, tig = lane % 4;
  const __nv_bfloat16* qr =
      q + ((long long)leaf * Hq + h * qpk + g) * D + (kQ ? (D / 4) * tig : 2 * tig);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int o0 = kQ ? 4 * ks : 16 * ks, o1 = kQ ? 4 * ks + 2 : 16 * ks + 8;
    qa[ks][0] = g < qpk ? *reinterpret_cast<const uint32_t*>(qr + o0) : 0u;
    qa[ks][1] = g < qpk ? *reinterpret_cast<const uint32_t*>(qr + o1) : 0u;
  }
}

// A warp's span of the path's 16-token tiles: block `split` of `splits`
// takes its share of the tiles, warp `warp` of W a share of its block's.
// Returns the first tile; n: how many.
template <int W>
__device__ __forceinline__ int warp_span(int total, int split, int splits, int warp, int& n) {
  const int tiles = (total + kTile - 1) / kTile;
  const int b0 = tiles * split / splits, b1 = tiles * (split + 1) / splits;
  const int w0 = b0 + (b1 - b0) * warp / W, w1 = b0 + (b1 - b0) * (warp + 1) / W;
  n = w1 - w0;
  return w0;
}

// Walk tiles w0 .. w0 + n - 1 of the path through the warp's ring of
// kStages cp.async stages: the first stages' references are all taken
// before any is used, then (with kAhead) always the reference of the next
// tile to issue; per tile the stage freed last is refilled, the tile waited
// for, and tile(st, i0) called on its stage and its first path position.
template <typename KV, int D, typename Path, typename F>
__device__ __forceinline__ void walk_tiles(const Path& path, int leaf, const int* cum,
                                           const deft_seq::SeqPools<KV>& pools, int h, int Hkv,
                                           uint8_t* ring, int w0, int n, int total, int lane,
                                           F&& tile) {
  using L = Layout<KV, D, 1>;
  int refs[kStages - 1];
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    refs[p] = tile_ref(path, leaf, w0 + p, total, lane);
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n)
      issue_tile<KV, D>(ring + p * L::kStage, ref_row(path, leaf, cum, refs[p]), pools, h,
                        Hkv, lane);
    else cp_async_commit();
  }
  int ref = tile_ref(path, leaf, w0 + kStages - 1, total, lane);
  for (int it = 0; it < n; ++it) {
    __syncwarp();  // every lane is done with the stage refilled next
    const int nx = it + kStages - 1;
    if (nx < n) {
      if constexpr (!Traits<Path>::kAhead) ref = tile_ref(path, leaf, w0 + nx, total, lane);
      issue_tile<KV, D>(ring + nx % kStages * L::kStage, ref_row(path, leaf, cum, ref), pools,
                        h, Hkv, lane);
      if constexpr (Traits<Path>::kAhead)
        ref = tile_ref(path, leaf, w0 + nx + 1, total, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile it have landed
    tile(ring + it % kStages * L::kStage, (w0 + it) * kTile);
  }
  cp_async_wait<0>();
}

// After every warp of the block has left its state in shared memory at sm_m
// (m, l of its 8 rows, acc (8, D) at pitch kAccPitch, a pad word every 32
// columns) and before any leaves: block `split` merges outputs [o0, o1) of
// the (qpk, D) rows over the cluster's blocks and their warps with the LSE
// rule, in that order, and writes o = acc / l (bf16), or the partial form.
template <typename KV, int D, int W>
__device__ __forceinline__ void merge_cluster(float* sm_m, void* __restrict__ o,
                                              float* __restrict__ m_out,
                                              float* __restrict__ l_out, int leaf, int h,
                                              int qpk, int Hq, int split, int splits,
                                              int tid) {
  using L = Layout<KV, D, W>;
  float* sm_l = sm_m + W * 8;
  float* sm_acc = sm_l + W * 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int items = qpk * D;
  const int o0 = items * split / splits, o1 = items * (split + 1) / splits;
  for (int it = o0 + tid; it < o1; it += W * 32) {
    const int r = it / D, d = it % D;
    float mm = kNeg;
    for (int b = 0; b < splits; ++b) {
      const float* pm = cluster.map_shared_rank(sm_m, b);
      for (int w = 0; w < W; ++w) mm = fmaxf(mm, pm[w * 8 + r]);
    }
    float ls = 0.f, a = 0.f;
    for (int b = 0; b < splits; ++b) {
      const float* pm = cluster.map_shared_rank(sm_m, b);
      const float* pl = cluster.map_shared_rank(sm_l, b);
      const float* pa = cluster.map_shared_rank(sm_acc, b);
      for (int w = 0; w < W; ++w) {
        const float f = exp2f(pm[w * 8 + r] - mm);
        ls += pl[w * 8 + r] * f;
        a += pa[(w * 8 + r) * L::kAccPitch + d + d / 32] * f;
      }
    }
    const long long row_o = (long long)leaf * Hq + h * qpk + r;
    if (m_out) {  // partial form: the unnormalised state, m in natural log
      static_cast<float*>(o)[row_o * D + d] = a;
      if (d == 0) {
        m_out[row_o] = mm * deft_seq::kLn2;
        l_out[row_o] = ls;
      }
    } else {
      static_cast<__nv_bfloat16*>(o)[row_o * D + d] =
          __float2bfloat16(ls == 0.f ? 0.f : a / ls);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename KV, int D, typename Path>
__global__ void __launch_bounds__(Traits<Path>::kWarps * 32)
    seq_q_mma(const __nv_bfloat16* __restrict__ q, deft_seq::SeqPools<KV> pools, Path path,
              void* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
              int Hq, int Hkv, float s2) {
  constexpr int W = Traits<Path>::kWarps;
  using L = Layout<KV, D, W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* cum = reinterpret_cast<int*>(smem_raw + L::kBytes);  // SegPath only
  const int leaf = blockIdx.x, h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int pre = path_setup(path, leaf, cum, warp, lane);
  uint32_t qa[D / 16][2];  // Q's A fragments (load_q)
  load_q<KV, D>(qa, q, leaf, Hq, h, qpk, lane);
  __syncthreads();
  const int total = path_total(path, pre, cum);
  int n;
  const int w0 = warp_span<W>(total, split, splits, warp, n);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m = kNeg, l = 0.f;  // row g's running max (base 2) and sum
  uint8_t* ring = smem_raw + warp * kStages * L::kStage;
  walk_tiles<KV, D>(path, leaf, cum, pools, h, Hkv, ring, w0, n, total, lane,
                    [&](const uint8_t* st, int i0) {
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kRows);
    const float* vsc = ksc + kTile;

    float s[2][4];
    tile_scores<KV, D>(s, qa, st, lane);
    // online softmax of row g over tokens nt8 * 8 + 2 tig + e
    float mx = kNeg;
#pragma unroll
    for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = nt8 * 8 + 2 * tig + e;
        float v = s[nt8][e] * s2;
        if constexpr (L::kQ) v *= ksc[tok];
        v = i0 + tok < total ? v : kNeg;
        s[nt8][e] = v;
        mx = fmaxf(mx, v);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(fmaxf(m, mx), deft_seq::kMClamp);
    const float alpha = exp2f(m - m_new);
    float sum = 0.f, pv[2][2];
#pragma unroll
    for (int nt8 = 0; nt8 < 2; ++nt8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = exp2f(s[nt8][e] - m_new);
        sum += p;
        pv[nt8][e] = L::kQ ? p * vsc[nt8 * 8 + 2 * tig + e] : p;
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    const uint32_t pa[4] = {deft::pack_bf16(pv[0][0], pv[0][1]), 0u,
                            deft::pack_bf16(pv[1][0], pv[1][1]), 0u};
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha;
      acc[nt][1] *= alpha;
    }
    tile_pv<KV, D>(acc, pa, st, lane);
  });

  // each warp's state: m, l of its 8 rows, acc (8, D)
  __syncthreads();  // every warp is done with its ring
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + W * 8;
  float* sm_acc = sm_l + W * 8;
  if (tig == 0) {
    sm_m[warp * 8 + g] = m;
    sm_l[warp * 8 + g] = l;
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = L::kQ ? (D / 8) * (2 * tig + e) + nt : 8 * nt + 2 * tig + e;
      sm_acc[(warp * 8 + g) * L::kAccPitch + d + d / 32] = acc[nt][e];
    }

  merge_cluster<KV, D, W>(sm_m, o, m_out, l_out, leaf, h, qpk, Hq, split, splits, tid);
}

// -- bf16 q at head_dim 96 and 256 (Phi-3-mini, Gemma: B7's gather plans) ---
//
// deft_seq_q puts the query rows on M: at D 256 its accumulator is D / 8 x
// 4 = 128 registers a thread, half of them rows 8-15 that are always zero,
// beside Q's 32; and at q_per_kv 1 (both models) 15 of 16 rows are zero.
// The wide body swaps the operands: path tokens on M, the <= 8 query rows
// on N, so each m16n8k16 takes 16 tokens (S) or 16 head dims (P V):
// - S^T = K Q^T: K's tile rows are the A operand (bf16: ldmatrix of 16
//   tokens x 16 head dims; int8: rows g and g + 8, D / 4 bytes at
//   (D / 4) tig, widened in registers), Q's fragments the B operand (the
//   same registers deft_seq_q holds as A, load_q).  s[i]: token g + 8 (i /
//   2), query row 2 tig + i % 2.
// - The online softmax runs per query row over the lanes of one tig (xor 4,
//   8, 16); each thread keeps m, l of rows 2 tig and 2 tig + 1.
// - P^T, the B operand of O^T = V^T P^T, wants tokens 2 tig, + 1, + 8, + 9
//   of query row g: four shuffles from the lanes that hold them as S^T
//   (8 tig + g / 2 and + 4), a byte permute picking row g's halves.
// - V^T's A fragments: bf16, ldmatrix.trans of 16 tokens x 16 head dims;
//   int8, per m-tile mt and row m of it head dim (D / 16) m + mt, so a
//   thread reads D / 16 consecutive codes of each of its 4 token rows at
//   rows m = g, g + 8 (16 bytes at D 256; 6 at D 96, from the 4-byte-aligned
//   8 around them), pairs two tokens' codes with prmt and widens them.
// acc is D / 16 x 4 = 64 registers at D 256 (O^T: head dim of m-tile mt,
// row g + 8 (i / 2); query row 2 tig + i % 2), all live at q_per_kv 8.
// The path source, the split over blocks and warps, the ring, the tile
// rows read a tile ahead and the cluster merge are deft_seq_q's.

// The words at p: N of 4 bytes (16, 8 or 4 bytes aligned so).
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N], const uint8_t* p) {
  if constexpr (N == 4) {
    const uint4 c = *reinterpret_cast<const uint4*>(p);
    w[0] = c.x;
    w[1] = c.y;
    w[2] = c.z;
    w[3] = c.w;
  } else if constexpr (N == 2) {
    const uint2 c = *reinterpret_cast<const uint2*>(p);
    w[0] = c.x;
    w[1] = c.y;
  } else {
    static_assert(N == 1, "words a load");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// S^T = K Q^T of one tile: s[i] is token g + 8 (i / 2), query row 2 tig + i % 2.
template <typename KV, int D>
__device__ __forceinline__ void tile_scores_t(float (&s)[4], const uint32_t (&qb)[D / 16][2],
                                              const uint8_t* st, int lane) {
  using L = Layout<KV, D, 1>;
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = 0.f;
  if constexpr (L::kQ) {
    // step ks: word ks of rows g (a0: bytes 0, 1; a2: 2, 3) and g + 8 (a1, a3)
    const int g = lane / 4, tig = lane % 4;
    const uint8_t* k0 = st + g * L::P + (D / 4) * tig;
    const uint8_t* k1 = k0 + 8 * L::P;
    constexpr int WL = D % 64 == 0 ? 4 : 2;  // words a load: 16 bytes, or 8 at D 96
#pragma unroll
    for (int j = 0; j < D / 16 / WL; ++j) {
      uint32_t w0[WL], w1[WL];
      load_words<WL>(w0, k0 + 4 * WL * j);
      load_words<WL>(w1, k1 + 4 * WL * j);
#pragma unroll
      for (int u = 0; u < WL; ++u) {
        uint32_t a[4];
        deft::hopper::widen4(w0[u], a[0], a[2]);
        deft::hopper::widen4(w1[u], a[1], a[3]);
        deft::mma_bf16(s, a, qb[WL * j + u][0], qb[WL * j + u][1]);
      }
    }
  } else {
    // lane l: token l % 16, head dims 8 (l / 16) .. + 7 of each 16
    const uint8_t* kr = st + (lane % 16) * L::P + (lane / 16) * 16;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, kr + 32 * ks);
      deft::mma_bf16(s, a, qb[ks][0], qb[ks][1]);
    }
  }
}

// The D / 16 int8 codes of a V row at head dims (D / 16) m .. + D / 16 - 1
// (row m of every m-tile), code mt in byte mt % 4 of word mt / 4.
template <int D>
__device__ __forceinline__ void v_codes(uint32_t (&c)[(D + 63) / 64], const uint8_t* row,
                                        int m) {
  constexpr int B = D / 16;
  if constexpr (B % 4 == 0) {
    load_words<B / 4>(c, row + B * m);
  } else {
    static_assert(B == 6, "int8 V codes a row");
    // 6 bytes at 6 m, 2-byte aligned: the aligned 8 bytes around them
    const int sh = 16 * (m & 1);
    const uint8_t* p = row + B * m - sh / 8;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 4);
    c[0] = __funnelshift_r(w0, w1, sh);
    c[1] = w1 >> sh;
  }
}

// O^T += V^T P^T of one tile; pb0, pb1: P^T's B fragment (tokens 2 tig, + 1
// and 2 tig + 8, + 9 of query row g).
template <typename KV, int D>
__device__ __forceinline__ void tile_pv_t(float (&acc)[D / 16][4], uint32_t pb0, uint32_t pb1,
                                          const uint8_t* st, int lane) {
  using L = Layout<KV, D, 1>;
  if constexpr (L::kQ) {
    constexpr int CW = (D + 63) / 64;
    const int g = lane / 4, tig = lane % 4;
    const uint8_t* vr = st + L::kRows + 2 * tig * L::P;
    // c[t][hh]: token 2 tig + t % 2 + 8 (t / 2), row m = g + 8 hh of the m-tiles
    uint32_t c[4][2][CW];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        v_codes<D>(c[t][hh], vr + (t % 2 + 8 * (t / 2)) * L::P, g + 8 * hh);
#pragma unroll
    for (int u = 0; u < CW; ++u) {
      // a[j][r]: register r of m-tile 4 u + j, r = 0 .. 3: (tokens 2 tig, + 1;
      // row g), (the same; g + 8), (tokens 2 tig + 8, + 9; g), (the same; g + 8)
      uint32_t a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 2 * (r / 2), hh = r % 2;
        deft::hopper::widen4(deft::hopper::pair_lo(c[t][hh][u], c[t + 1][hh][u]), a[0][r],
                             a[1][r]);
        deft::hopper::widen4(deft::hopper::pair_hi(c[t][hh][u], c[t + 1][hh][u]), a[2][r],
                             a[3][r]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * u + j < D / 16) deft::mma_bf16(acc[4 * u + j], a[j], pb0, pb1);
    }
  } else {
    // lane l: token l % 8 + 8 (l / 16), head dims 8 ((l / 8) % 2) .. + 7 of each 16
    const uint8_t* vr =
        st + L::kRows + (lane % 8 + 8 * (lane / 16)) * L::P + (lane / 8) % 2 * 16;
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t a[4];
      ldsm_x4_trans(a, vr + 32 * mt);
      deft::mma_bf16(acc[mt], a, pb0, pb1);
    }
  }
}

template <typename KV, int D, typename Path>
__global__ void __launch_bounds__(Traits<Path>::kWarps * 32)
    seq_q_wide(const __nv_bfloat16* __restrict__ q, deft_seq::SeqPools<KV> pools, Path path,
               void* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
               int Hq, int Hkv, float s2) {
  constexpr int W = Traits<Path>::kWarps;
  using L = Layout<KV, D, W>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* cum = reinterpret_cast<int*>(smem_raw + L::kBytes);  // SegPath only
  const int leaf = blockIdx.x, h = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int pre = path_setup(path, leaf, cum, warp, lane);
  uint32_t qb[D / 16][2];  // Q^T's B fragments (load_q)
  load_q<KV, D>(qb, q, leaf, Hq, h, qpk, lane);
  __syncthreads();
  const int total = path_total(path, pre, cum);
  int n;
  const int w0 = warp_span<W>(total, split, splits, warp, n);

  float acc[D / 16][4];  // O^T
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // query rows 2 tig + e
  uint8_t* ring = smem_raw + warp * kStages * L::kStage;
  walk_tiles<KV, D>(path, leaf, cum, pools, h, Hkv, ring, w0, n, total, lane,
                    [&](const uint8_t* st, int i0) {
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kRows);
    const float* vsc = ksc + kTile;

    float s[4];
    tile_scores_t<KV, D>(s, qb, st, lane);
    // online softmax of query rows 2 tig + e over tokens g, g + 8 of every g
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tok = g + 8 * (i / 2);
      float v = s[i] * s2;
      if constexpr (L::kQ) v *= ksc[tok];
      v = i0 + tok < total ? v : kNeg;
      s[i] = v;
      mx[i % 2] = fmaxf(mx[i % 2], v);
    }
    float m_new[2], alpha[2], sum[2] = {0.f, 0.f}, pv[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int x = 4; x < 32; x *= 2)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], x));
      m_new[e] = fmaxf(fmaxf(m[e], mx[e]), deft_seq::kMClamp);
      alpha[e] = exp2f(m[e] - m_new[e]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = exp2f(s[i] - m_new[i % 2]);
      sum[i % 2] += p;
      pv[i] = L::kQ ? p * vsc[g + 8 * (i / 2)] : p;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int x = 4; x < 32; x *= 2) sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], x);
      l[e] = l[e] * alpha[e] + sum[e];
      m[e] = m_new[e];
    }
    // P^T's B fragment: tokens 2 tig and 2 tig + 1 of query row g are in
    // lanes 8 tig + g / 2 and + 4, the half g % 2 of their first words
    // (tokens + 8: of their second)
    const uint32_t w01 = deft::pack_bf16(pv[0], pv[1]), w23 = deft::pack_bf16(pv[2], pv[3]);
    const int src = 8 * tig + g / 2;
    const uint32_t sel = g % 2 ? 0x7632u : 0x5410u;
    const uint32_t pb0 = __byte_perm(__shfl_sync(0xffffffffu, w01, src),
                                     __shfl_sync(0xffffffffu, w01, src + 4), sel);
    const uint32_t pb1 = __byte_perm(__shfl_sync(0xffffffffu, w23, src),
                                     __shfl_sync(0xffffffffu, w23, src + 4), sel);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      acc[mt][0] *= alpha[0];
      acc[mt][1] *= alpha[1];
      acc[mt][2] *= alpha[0];
      acc[mt][3] *= alpha[1];
    }
    tile_pv_t<KV, D>(acc, pb0, pb1, st, lane);
  });

  // each warp's state: m, l of its 8 query rows, acc (8, D)
  __syncthreads();  // every warp is done with its ring
  float* sm_m = reinterpret_cast<float*>(smem_raw);
  float* sm_l = sm_m + W * 8;
  float* sm_acc = sm_l + W * 8;
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sm_m[warp * 8 + 2 * tig + e] = m[e];
      sm_l[warp * 8 + 2 * tig + e] = l[e];
    }
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = g + 8 * (i / 2);
      const int d = L::kQ ? (D / 16) * mm + mt : 16 * mt + mm;
      sm_acc[(warp * 8 + 2 * tig + i % 2) * L::kAccPitch + d + d / 32] = acc[mt][i];
    }

  merge_cluster<KV, D, W>(sm_m, o, m_out, l_out, leaf, h, qpk, Hq, split, splits, tid);
}

// The body of head_dim D: deft_seq_q's at 64 and 128, the wide body at 96 and 256.
template <typename KV, int D, typename Path>
inline auto body() {
  if constexpr (D == 64 || D == 128) return seq_q_mma<KV, D, Path>;
  else return seq_q_wide<KV, D, Path>;
}

template <typename KV, int D, typename Path>
cudaError_t launch(const void* q, deft_seq::SeqPools<KV> pools, Path path, void* o,
                   float* m_out, float* l_out, int R, int Hq, int Hkv, int splits, float scale,
                   cudaStream_t stream) {
  constexpr int W = Traits<Path>::kWarps;
  auto kernel = body<KV, D, Path>();
  const size_t smem = Layout<KV, D, W>::kBytes + path_smem(path);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, Hkv, splits);
  cfg.blockDim = dim3(W * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q), pools, path, o,
                         m_out, l_out, Hq, Hkv, scale * deft_seq::kLog2e);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Check the sizes, then instantiate launch for head_dim: 64 or 128, and over
// path tables (B7, whose wide heads take gather plans only) 96 and 256.  q
// bf16; o bf16, or with m_out and l_out the partial form's fp32 acc.
// splits: the blocks of a cluster that share each (leaf, head)'s path, 1 .. 8.
template <typename KV, typename Path>
cudaError_t dispatch(const void* q, deft_seq::SeqPools<KV> pools, Path path, void* o,
                     float* m_out, float* l_out, int R, int Hq, int Hkv, int D, int splits,
                     float scale, void* stream) {
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 8 || !m_out != !l_out || splits < 1 ||
      splits > kMaxCluster)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<KV, 128>(q, pools, path, o, m_out, l_out, R, Hq, Hkv, splits, scale, st);
  if (D == 64)
    return launch<KV, 64>(q, pools, path, o, m_out, l_out, R, Hq, Hkv, splits, scale, st);
  if constexpr (std::is_same<Path, deft_seq::IdxPath>::value) {
    if (D == 256)
      return launch<KV, 256>(q, pools, path, o, m_out, l_out, R, Hq, Hkv, splits, scale, st);
    if (D == 96)
      return launch<KV, 96>(q, pools, path, o, m_out, l_out, R, Hq, Hkv, splits, scale, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace deft_seq_q
