// The flatten kernel lab's three Pallas variants of B1's function, on the
// card (deft_tpu experiments/kernel_lab.py).  Each computes what B1 computes
// (csrc/paged_flatten.cu): tree attention of folded queries q (Hkv, Rq, D)
// over the plan's KV, read from the (L, S, Hkv*D) bf16 pools through the
// segment table, row r (leaf r / qpk) seeing plan token t iff
// tok_lo[t] <= r / qpk < tok_hi[t]; o (Hkv, Rq, D) bf16, normalised, 0 on a
// row that sees no token.  Each answers one question of its TPU variant on
// this card; none replaces B1 on the served path.
//
//   B12 deft_lab_passes replaces _lab_kernel (kernel_lab.py:142, launched by
//       _lab_call :296, variant B "pass-trimmed").  The port's B1 body already
//       takes exp2 with a clamped running max (flat_q_body.cuh,
//       flash_common.cuh tile_update), so on the card the open question is the
//       variant's other half: one program walking every plan block in order,
//       keeping (m, l, acc) and normalising in place.  One block a (64 folded
//       rows, KV head) walks every live block's 64-token tiles in order (the
//       TPU's sequential grid as a loop inside the block), double-buffered
//       cp.async tiles, mma.sync products; no split-KV and no merge kernel:
//       one launch where B1 has two.  Its time against B1's says what B1's
//       spans and merge buy at this shape.
//   B13 deft_lab_fused replaces _lab_kernel_fused (kernel_lab.py:312, launched
//       by _lab_call_fused :449, variant D "all heads at once").  The TPU
//       variant's block-diagonal q is a trick for its matrix unit; on the card
//       it would waste Hkv x the tensor-core work, so it is not copied.  What
//       is kept is its idea: one block owns a span of tokens for every KV head
//       at once.  A token's K and V rows (Hkv * D = 1024 bf16, 2 KB each,
//       contiguous in the pool) are copied whole into shared memory, and the
//       leaf-interval mask of a stage is built once, as one 16-bit row mask a
//       token, for every head.  Warp w computes head w.  Registers bound the
//       rows a block can own: the fp32 accumulators of 16 rows x 8 heads x
//       128 are 64 a thread of 8 warps, so a block owns 16 folded rows, and a
//       token's rows are read by Rq / 16 blocks (the repeats from L2: a
//       layer's live KV of the lab's bench case is 18.5 MB, the L2 50 MB).
//       Shared memory bounds the stage: 64 tokens of K and V at 2 KB a row
//       are 256 KB, above the 227 KB a block can use; the stage is 16 tokens,
//       double-buffered (2 x 16 x 2 x 2 KB = 128 KB).  Spans of the live
//       16-token stages are merged as B1's are (flatten_merge_kernel).
//   B14 deft_lab_k2 replaces _lab2_kernel (kernel_lab.py:544, launched by
//       _lab2_call :729, variants K2 and TQ).  The plan's tokens come in
//       programs of prog_len tokens; inside a program each sub_len sub-block
//       is FULL (sub_lo < -(1 << 20): no mask), masked, or dead (skipped), by
//       sub_lo / sub_hi.  With tq > 0 a masked sub-block updates only the
//       folded-row tiles of tq rows that meet [sub_lo, sub_hi) * qpk; tq is
//       rounded up to 16, the rows of one mma.sync warp tile, so a warp skips
//       or computes a sub-block as a whole.  One block a (64 folded rows, KV
//       head, span of programs) walks its programs' tiles in order; a program
//       of one head's K and V (512 B a token) outgrows shared memory at 512
//       tokens, so the copies run as a double-buffered ring of 64-token tiles
//       across sub-block and program edges instead of one copy set a program.
//       The port's B1 skips whole 128-row tiles only (ops/paged_flatten_attn.py
//       row_tile_tiles); B14 measures what 16-row granules and longer
//       programs give on the deep-tree case, where most blocks serve one leaf.
//       Spans of live programs fill the SMs and are merged as B1's are.
//
// Bound on this card: bytes.  Each live plan token's K and V rows, Hkv * D * 2
// * 2 bytes, against 3.35 TB/s (18.5 MB, 5.5 us a layer at the lab's bench
// case; its 4.6 GFLOP are 4.7 us at 989 TFLOP/s).  These first kernels run
// mma.sync.m16n8k16 (flash_common.cuh's fragments) on tiles copied with
// cp.async; the online softmax is flash_common.cuh's, in the exp2 domain with
// the running max clamped at -1e5, which the three TPU variants share.
#include "flatten_body.cuh"

namespace {

using deft::kBM;
using deft::kBN;
using deft::kNeg;
using deft::kThreads;
using bf16 = __nv_bfloat16;
constexpr int kD = 128;  // the lab's head width (kernel_lab.py:27)
using Tile = deft::Smem<bf16, kD>;
constexpr int kFullThreshold = -(1 << 20);  // blk_lo / sub_lo below: FULL

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pool row of plan token t: the segment table lists the plan's segments in
// token order, seg_len tokens each.
__device__ __forceinline__ int seg_row(const int* seg_src, int seg_len, int t) {
  return seg_src[t / seg_len] + t % seg_len;
}

struct Plan {
  const bf16* k;
  const bf16* v;
  long long layer_off;  // li * S * Hkv * D
  const int* seg_src;
  int seg_len;
  const int* tok_lo;
  const int* tok_hi;
};

// What a tile asks of the warps: `mask` (the leaf intervals, off on FULL
// sub-blocks) and the warps that compute it (B14's row tiles).
struct TileInfo {
  bool mask;
  unsigned warps;
};

// Fill `sm` with the pool offsets and leaf intervals of the 64 plan tokens
// from t0 (head h) and start their K and V copies, one cp.async group.
__device__ __forceinline__ void issue_tile(Tile& sm, const Plan& p, int t0, int h, int Hkv) {
  if (threadIdx.x < kBN) {
    const int t = t0 + threadIdx.x;
    sm.roff[threadIdx.x] =
        p.layer_off + ((long long)seg_row(p.seg_src, p.seg_len, t) * Hkv + h) * kD;
    sm.lo[threadIdx.x] = p.tok_lo[t];
    sm.hi[threadIdx.x] = p.tok_hi[t];
  }
  __syncthreads();
  deft::load_rows<bf16, kD>(sm.k, Tile::QS, p.k, sm.roff, kBN);
  deft::load_rows<bf16, kD>(sm.v, Tile::QS, p.v, sm.roff, kBN);
  cp_commit();
}

// Load the block's 64 folded rows of head h (zeros past Rq) into the first
// buffer and every thread's Q fragments.
__device__ __forceinline__ void load_q(Tile& sm, deft::RowState<kD>& st, const bf16* q,
                                       int h, int r0, int Rq) {
  if (threadIdx.x < kBM) {
    const int r = r0 + threadIdx.x;
    sm.roff[threadIdx.x] = r < Rq ? ((long long)h * Rq + r) * kD : -1;
  }
  __syncthreads();
  deft::load_rows<bf16, kD>(sm.q, Tile::QS, q, sm.roff, kBM);
  deft::cp_async_wait_all();
  __syncthreads();
  deft::init_state<bf16, kD>(st, sm);
  __syncthreads();  // sm.roff is rewritten by the first tile
}

// The tile walk of B12 and B14: next(sm, info) finds the next tile, issues
// its copies into `sm` and returns false past the last; each tile is then
// scored, masked and folded into the warps' state while the next one lands.
template <class Next>
__device__ __forceinline__ void walk_tiles(Tile* sm, deft::RowState<kD>& st, float s2,
                                           int r0, int qpk, Next next) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
  const int leaf0 = (r0 + warp * 16 + g) / qpk, leaf1 = (r0 + warp * 16 + g + 8) / qpk;
  TileInfo cur, nxt;
  bool has = next(sm[0], cur);
  int c = 0;
  while (has) {
    const bool more = next(sm[c ^ 1], nxt);
    if (more)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    if (cur.warps >> warp & 1u) {
      float s[kBN / 8][4];
      deft::tile_scores<bf16, kD>(s, st, sm[c], s2);
      if (cur.mask) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = n * 8 + tig * 2 + e;
            const int lo = sm[c].lo[t], hi = sm[c].hi[t];
            if (!(lo <= leaf0 && leaf0 < hi)) s[n][e] = kNeg;
            if (!(lo <= leaf1 && leaf1 < hi)) s[n][2 + e] = kNeg;
          }
      }
      deft::tile_update<bf16, kD>(s, st, sm[c]);
    }
    __syncthreads();  // sm[c] is consumed before it is refilled
    cur = nxt;
    c ^= 1;
    has = more;
  }
}

// B12: one block a (64 folded rows, KV head) over every plan block.
__global__ void __launch_bounds__(kThreads)
    lab_passes_kernel(const bf16* __restrict__ q, Plan p, const int* __restrict__ blk_lo,
                      const int* __restrict__ blk_hi, bf16* __restrict__ o, int Rq, int Hkv,
                      int qpk, int nb, int block_len, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* sm = reinterpret_cast<Tile*>(smem_raw);
  const int r0 = blockIdx.x * kBM, h = blockIdx.y;
  deft::RowState<kD> st;
  load_q(sm[0], st, q, h, r0, Rq);
  int b = -1, sub = block_len;  // cursor: plan block b, its token sub
  auto next = [&](Tile& buf, TileInfo& info) {
    if (sub == block_len) {  // the next live block (the variant's live(b))
      do ++b;
      while (b < nb && !(blk_lo[b] < blk_hi[b]));
      if (b >= nb) return false;
      sub = 0;
    }
    issue_tile(buf, p, b * block_len + sub, h, Hkv);
    info = {true, 0xffffffffu};
    sub += kBN;
    return true;
  };
  walk_tiles(sm, st, s2, r0, qpk, next);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + warp * 16 + g + 8 * hh;
    if (r >= Rq) continue;
    const float inv = st.l[hh] == 0.f ? 0.f : 1.f / st.l[hh];
    bf16* orow = o + ((long long)h * Rq + r) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + tig * 2) =
          __floats2bfloat162_rn(st.o[n][2 * hh] * inv, st.o[n][2 * hh + 1] * inv);
  }
}

// Write a block's unnormalised state (acc, m, l) of span `span`, in the
// layout flatten_merge_kernel reads: acc (spans, Hkv, Rq, D), m, l
// (spans, Hkv, Rq); rows g and g + 8 of 16-row warp tile `row0`.
__device__ __forceinline__ void store_state(const deft::RowState<kD>& st, float* acc,
                                            float* m, float* l, int span, int h, int Hkv,
                                            int Rq, int row0) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    if (r >= Rq) continue;
    const long long base = ((long long)span * Hkv + h) * Rq + r;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(acc + base * kD + n * 8 + tig * 2) =
          make_float2(st.o[n][2 * hh], st.o[n][2 * hh + 1]);
    if (tig == 0) {
      m[base] = st.m[hh];
      l[base] = st.l[hh];
    }
  }
}

// B14: one block a (64 folded rows, KV head, span of live programs).
__global__ void __launch_bounds__(kThreads)
    lab_k2_kernel(const bf16* __restrict__ q, Plan p, const int* __restrict__ sub_lo,
                  const int* __restrict__ sub_hi, float* __restrict__ acc,
                  float* __restrict__ m_out, float* __restrict__ l_out, int Rq, int Hkv,
                  int qpk, int n_prog, int prog_len, int sub_len, int tq, int n_spans,
                  float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile* sm = reinterpret_cast<Tile*>(smem_raw);
  const int r0 = blockIdx.x * kBM, h = blockIdx.y, span = blockIdx.z;
  const int nsub = prog_len / sub_len;
  deft::RowState<kD> st;
  load_q(sm[0], st, q, h, r0, Rq);
  // the span's share of the live programs (a program is live if a
  // sub-block is), cut evenly in program order
  auto prog_live = [&](int pr) {
    for (int s = 0; s < nsub; ++s)
      if (sub_lo[pr * nsub + s] < sub_hi[pr * nsub + s]) return true;
    return false;
  };
  int n_live = 0;
  for (int pr = 0; pr < n_prog; ++pr) n_live += prog_live(pr);
  const int first = (int)((long long)span * n_live / n_spans);
  const int last = (int)((long long)(span + 1) * n_live / n_spans);
  int pr = -1, rank = -1, sb = nsub, sub = sub_len;  // cursor
  TileInfo here{true, 0u};  // the current sub-block's dispatch
  auto next = [&](Tile& buf, TileInfo& info) {
    while (sub == sub_len) {  // the next sub-block with work for a warp
      if (sb == nsub) {  // the next of the span's live programs
        do {
          ++pr;
          if (pr >= n_prog) return false;
          rank += prog_live(pr);
        } while (!prog_live(pr) || rank < first);
        if (rank >= last) return false;
        sb = 0;
      } else {
        ++sb;
        if (sb == nsub) continue;
      }
      const int i = pr * nsub + sb;
      const int lo = sub_lo[i], hi = sub_hi[i];
      if (!(lo < hi)) continue;  // dead
      if (lo < kFullThreshold) {
        here = {false, 0xfu};
      } else {
        unsigned w = 0xfu;
        if (tq > 0) {  // the warps whose tq-row tile meets [lo, hi) * qpk
          w = 0u;
          for (int k = 0; k < kBM / 16; ++k) {
            const int t0 = (r0 + 16 * k) / tq * tq;
            if ((long long)lo * qpk < t0 + tq && (long long)hi * qpk > t0) w |= 1u << k;
          }
        }
        here = {true, w};
      }
      if (here.warps) sub = 0;
    }
    issue_tile(buf, p, pr * prog_len + sb * sub_len + sub, h, Hkv);
    info = here;
    sub += kBN;
    return true;
  };
  // sb == nsub with sub == sub_len starts the walk at the span's first program
  walk_tiles(sm, st, s2, r0, qpk, next);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  store_state(st, acc, m_out, l_out, span, h, Hkv, Rq, r0 + warp * 16 + lane / 4);
}

// B13's stage: 16 tokens of every head's K and V rows, double-buffered.
constexpr int kStage = 16;
constexpr int kMaxHkv = 8;  // one warp a KV head
struct FusedSmem {
  long long roff[2][kStage];  // pool element offset of each token's row
  unsigned short rows[2][kStage];  // bit j: folded row r0 + j sees the token
};

// B13: one block a (16 folded rows, span of live 16-token stages), warp w
// computing KV head w over the rows every head shares.
__global__ void __launch_bounds__(kMaxHkv * 32)
    lab_fused_kernel(const bf16* __restrict__ q, Plan p, const int* __restrict__ blk_lo,
                     const int* __restrict__ blk_hi, float* __restrict__ acc,
                     float* __restrict__ m_out, float* __restrict__ l_out, int Rq, int Hkv,
                     int qpk, int nb, int block_len, int n_spans, float s2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FusedSmem& fs = *reinterpret_cast<FusedSmem*>(smem_raw);
  const int HD = Hkv * kD;
  const int pitch = HD + 8;  // bf16 elements a staged row: 16 bytes of padding
  bf16* kst = reinterpret_cast<bf16*>(smem_raw + sizeof(FusedSmem));
  bf16* vst = kst + 2 * kStage * pitch;
  const int r0 = blockIdx.x * 16, span = blockIdx.y;
  const int nthreads = Hkv * 32;
  const int lane = threadIdx.x % 32, h = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;

  // Q's A fragments of rows r0 + g and r0 + g + 8, head h (zeros past Rq)
  uint32_t qa[kD / 16][4];
  {
    const int ra = r0 + g, rb = r0 + g + 8;
    const bf16* q0 = q + ((long long)h * Rq + ra) * kD + tig * 2;
    const bf16* q1 = q + ((long long)h * Rq + rb) * kD + tig * 2;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      qa[ks][0] = ra < Rq ? *reinterpret_cast<const uint32_t*>(q0 + ks * 16) : 0u;
      qa[ks][1] = rb < Rq ? *reinterpret_cast<const uint32_t*>(q1 + ks * 16) : 0u;
      qa[ks][2] = ra < Rq ? *reinterpret_cast<const uint32_t*>(q0 + ks * 16 + 8) : 0u;
      qa[ks][3] = rb < Rq ? *reinterpret_cast<const uint32_t*>(q1 + ks * 16 + 8) : 0u;
    }
  }
  float oacc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float mrow[2] = {kNeg, kNeg}, lrow[2] = {0.f, 0.f};

  // the span's share of the live stages (a stage of a live plan block)
  const int per_blk = block_len / kStage;
  int n_live = 0;
  for (int b = 0; b < nb; ++b) n_live += blk_lo[b] < blk_hi[b];
  const long long units = (long long)n_live * per_blk;
  const long long u0 = span * units / n_spans, u1 = (span + 1) * units / n_spans;
  int b = -1, st_in = per_blk;  // cursor: plan block b, its stage st_in
  long long u = 0;              // live stages passed
  auto next = [&](int buf) {
    for (;;) {
      if (st_in == per_blk) {
        do ++b;
        while (b < nb && !(blk_lo[b] < blk_hi[b]));
        if (b >= nb) return false;
        st_in = 0;
      }
      if (u >= u1) return false;
      if (u < u0) {  // skip whole blocks before the span
        const long long skip = min((long long)(per_blk - st_in), u0 - u);
        st_in += (int)skip;
        u += skip;
        continue;
      }
      break;
    }
    const int t0 = b * block_len + st_in * kStage;
    if (threadIdx.x < kStage) {
      const int t = t0 + threadIdx.x;
      fs.roff[buf][threadIdx.x] =
          p.layer_off + (long long)seg_row(p.seg_src, p.seg_len, t) * HD;
      const int lo = p.tok_lo[t], hi = p.tok_hi[t];
      unsigned bits = 0u;
      for (int j = 0; j < 16; ++j) {
        const int leaf = (r0 + j) / qpk;
        bits |= (unsigned)(lo <= leaf && leaf < hi) << j;
      }
      fs.rows[buf][threadIdx.x] = (unsigned short)bits;
    }
    __syncthreads();
    const int chunks = HD / 8;  // 16-byte chunks a row
    for (int i = threadIdx.x; i < 2 * kStage * chunks; i += nthreads) {
      const int kv = i / (kStage * chunks), rest = i % (kStage * chunks);
      const int r = rest / chunks, c = rest % chunks;
      bf16* dst = (kv ? vst : kst) + (buf * kStage + r) * pitch + c * 8;
      deft::cp_async16(dst, (kv ? p.v : p.k) + fs.roff[buf][r] + c * 8, true);
    }
    cp_commit();
    ++st_in;
    ++u;
    return true;
  };

  bool has = next(0);
  int c = 0;
  while (has) {
    const bool more = next(c ^ 1);
    if (more)
      cp_wait<1>();
    else
      cp_wait<0>();
    __syncthreads();
    // S = Q K^T over the stage's 16 tokens (two n-tiles of 8), masked by the
    // row bits every head shares
    float s[2][4];
    const unsigned short* rows = fs.rows[c];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* kr = kst + (c * kStage + n * 8 + g) * pitch + h * kD + tig * 2;
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        deft::mma_bf16(s[n], qa[ks], *reinterpret_cast<const uint32_t*>(kr + ks * 16),
                       *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned bits = rows[n * 8 + tig * 2 + e];
        s[n][e] = bits >> g & 1u ? s[n][e] * s2 : kNeg;
        s[n][2 + e] = bits >> (g + 8) & 1u ? s[n][2 + e] * s2 : kNeg;
      }
    }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                       fmaxf(s[1][2 * hh], s[1][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(mrow[hh], mx), deft::kMClamp);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s[n][2 * hh] = exp2f(s[n][2 * hh] - m_new);
        s[n][2 * hh + 1] = exp2f(s[n][2 * hh + 1] - m_new);
        sum += s[n][2 * hh] + s[n][2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hh] = exp2f(mrow[hh] - m_new);
      lrow[hh] = lrow[hh] * alpha[hh] + sum;
      mrow[hh] = m_new;
    }
    // O = O * alpha + P V: P (16 rows x 16 tokens) is one A fragment
    uint32_t a[4] = {deft::pack_bf16(s[0][0], s[0][1]), deft::pack_bf16(s[0][2], s[0][3]),
                     deft::pack_bf16(s[1][0], s[1][1]), deft::pack_bf16(s[1][2], s[1][3])};
    const bf16* vrow = vst + (c * kStage + lane % 16) * pitch + h * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
      uint32_t b0, b1;
      deft::ldmatrix_x2_trans(b0, b1, vrow + n * 8);
      deft::mma_bf16(oacc[n], a, b0, b1);
    }
    __syncthreads();  // stage c is consumed before it is refilled
    c ^= 1;
    has = more;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= Rq) continue;
    const long long base = ((long long)span * Hkv + h) * Rq + r;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(acc + base * kD + n * 8 + tig * 2) =
          make_float2(oacc[n][2 * hh], oacc[n][2 * hh + 1]);
    if (tig == 0) {
      m_out[base] = mrow[hh];
      l_out[base] = lrow[hh];
    }
  }
}

bool plan_ok(const void* q, const void* k, const void* v, const int* seg_src, int seg_len,
             const int* tok_lo, const int* tok_hi, int Rq, int Hkv, int qpk, int D) {
  return q && k && v && seg_src && tok_lo && tok_hi && seg_len > 0 && Rq > 0 && Hkv > 0 &&
         qpk > 0 && D == kD;
}

// The merge of the spans' states into o (Hkv, Rq, D): flatten_merge_kernel
// with one "leaf" of Hkv * Rq query heads, whose (R, Hq, D) layout is then
// the folded one.
cudaError_t merge(const float* acc, const float* m, const float* l, void* o, int n_spans,
                  int Rq, int Hkv, cudaStream_t st) {
  dim3 grid((Rq + 3) / 4, Hkv);
  deft::flatten_merge_kernel<bf16><<<grid, 128, 0, st>>>(acc, m, l, o, nullptr, nullptr,
                                                         n_spans, 1, Hkv * Rq, Hkv, kD);
  return cudaGetLastError();
}

}  // namespace

// Arguments every entry shares: q, o (Hkv, Rq, D) bf16 folded (row r is
// leaf r / qpk); pools (L, S, Hkv*D) bf16 with layer_off = li * S * Hkv * D;
// seg_src (T / seg_len,) the pool row of each segment, in token order;
// tok_lo, tok_hi (T,); all int32.  Return a cudaError_t code.

// B12: blk_lo, blk_hi (nb,), T = nb * block_len, block_len % 64 == 0.
extern "C" int deft_lab_passes(const void* q, const void* k_pool, const void* v_pool,
                               long long layer_off, const int* seg_src, int seg_len,
                               const int* tok_lo, const int* tok_hi, const int* blk_lo,
                               const int* blk_hi, void* o, int Rq, int Hkv, int qpk, int D,
                               int nb, int block_len, float scale, void* stream) {
  if (!plan_ok(q, k_pool, v_pool, seg_src, seg_len, tok_lo, tok_hi, Rq, Hkv, qpk, D) ||
      !blk_lo || !blk_hi || !o || nb <= 0 || block_len % kBN)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(Tile);
  static const cudaError_t attr = deft::allow_smem(lab_passes_kernel, smem);
  if (attr != cudaSuccess) return attr;
  const Plan p{static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool), layer_off,
               seg_src, seg_len, tok_lo, tok_hi};
  dim3 grid((Rq + kBM - 1) / kBM, Hkv);
  lab_passes_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), p, blk_lo, blk_hi, static_cast<bf16*>(o), Rq, Hkv, qpk, nb,
      block_len, scale * deft::kLog2e);
  return cudaGetLastError();
}

// B13: blk_lo, blk_hi (nb,), block_len % 16 == 0, Hkv <= 8; acc
// (n_spans, Hkv, Rq, D), m, l (n_spans, Hkv, Rq) fp32 scratch of the spans'
// states.
extern "C" int deft_lab_fused(const void* q, const void* k_pool, const void* v_pool,
                              long long layer_off, const int* seg_src, int seg_len,
                              const int* tok_lo, const int* tok_hi, const int* blk_lo,
                              const int* blk_hi, float* acc, float* m, float* l, void* o,
                              int Rq, int Hkv, int qpk, int D, int nb, int block_len,
                              int n_spans, float scale, void* stream) {
  if (!plan_ok(q, k_pool, v_pool, seg_src, seg_len, tok_lo, tok_hi, Rq, Hkv, qpk, D) ||
      !blk_lo || !blk_hi || !acc || !m || !l || !o || Hkv > kMaxHkv || nb <= 0 ||
      block_len % kStage || n_spans <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(FusedSmem) + 2 * 2 * kStage * (Hkv * kD + 8) * sizeof(bf16);
  static const cudaError_t attr =
      deft::allow_smem(lab_fused_kernel, sizeof(FusedSmem) +
                                             2 * 2 * kStage * (kMaxHkv * kD + 8) * sizeof(bf16));
  if (attr != cudaSuccess) return attr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool), layer_off,
               seg_src, seg_len, tok_lo, tok_hi};
  dim3 grid((Rq + 15) / 16, n_spans);
  lab_fused_kernel<<<grid, Hkv * 32, smem, st>>>(static_cast<const bf16*>(q), p, blk_lo,
                                                 blk_hi, acc, m, l, Rq, Hkv, qpk, nb,
                                                 block_len, n_spans, scale * deft::kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(acc, m, l, o, n_spans, Rq, Hkv, st);
}

// B14: sub_lo, sub_hi (T / sub_len,), T = n_prog * prog_len, prog_len %
// sub_len == 0, sub_len % 64 == 0; tq the row tile of a masked sub-block
// (0: every row), rounded up to 16 here; acc, m, l as B13's.
extern "C" int deft_lab_k2(const void* q, const void* k_pool, const void* v_pool,
                           long long layer_off, const int* seg_src, int seg_len,
                           const int* tok_lo, const int* tok_hi, const int* sub_lo,
                           const int* sub_hi, float* acc, float* m, float* l, void* o, int Rq,
                           int Hkv, int qpk, int D, int n_prog, int prog_len, int sub_len,
                           int tq, int n_spans, float scale, void* stream) {
  if (!plan_ok(q, k_pool, v_pool, seg_src, seg_len, tok_lo, tok_hi, Rq, Hkv, qpk, D) ||
      !sub_lo || !sub_hi || !acc || !m || !l || !o || n_prog <= 0 || sub_len <= 0 ||
      sub_len % kBN || prog_len % sub_len || tq < 0 || n_spans <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(Tile);
  static const cudaError_t attr = deft::allow_smem(lab_k2_kernel, smem);
  if (attr != cudaSuccess) return attr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p{static_cast<const bf16*>(k_pool), static_cast<const bf16*>(v_pool), layer_off,
               seg_src, seg_len, tok_lo, tok_hi};
  dim3 grid((Rq + kBM - 1) / kBM, Hkv, n_spans);
  lab_k2_kernel<<<grid, kThreads, smem, st>>>(static_cast<const bf16*>(q), p, sub_lo, sub_hi,
                                              acc, m, l, Rq, Hkv, qpk, n_prog, prog_len,
                                              sub_len, (tq + 15) / 16 * 16, n_spans,
                                              scale * deft::kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge(acc, m, l, o, n_spans, Rq, Hkv, st);
}
