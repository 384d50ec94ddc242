// DeFT-Flatten tree-decode attention reading KV straight from the paged pool.
//
// Replaces two Pallas TPU kernels:
//   B1 deft_tpu/ops/paged_flatten_attn.py:63 (_paged_kernel, launched by
//      _paged_call :296 for paged_flatten_attention :381), bf16/fp32 pools:
//      entry deft_paged_flatten;
//   B4 deft_tpu/ops/paged_quant.py:32 (_paged_q_kernel, launched by
//      _paged_q_call :236 for paged_flatten_attention_q :305), int8 pools
//      with per-(token, head) fp32 scales stored head-major (L, Hkv, S):
//      entry deft_paged_flatten_q.
// and their partial=True entries, which the multi-device engine runs on each
// rank's span of plan blocks (deft_tpu parallel/engine.py): B1p
// paged_flatten_attention_partial (paged_flatten_attn.py:408), entry
// deft_paged_flatten_partial, and B4p paged_flatten_attention_q_partial
// (paged_quant.py:321), entry deft_paged_flatten_q_partial.  Those write the
// unnormalised (acc, m, l) of the span through kernel 2's partial form.
// The plan (plan/flatten.py) lays the tree's KV out in DFS order in blocks of
// block_len tokens; segment j of block b is the pool span
// [seg_src[b*nseg + j], + seg_len); every entry reads the tokens through
// that segment table.
//
// Bound on this card: bytes.  The KV of the flattened tree per layer,
// T * Hkv * D * 2 * itemsize, plus for int8 the scales, T * Hkv * 4 * 2,
// against 3.35 TB/s.  B1, B1p and fp32 q run the split-KV kernels of
// flatten_body.cuh (each block of KV read once per 64-row query tile that
// attends it).  B4 and B4p over bf16 q run the body below (deft_flat_q),
// then flatten_body.cuh's merge kernel.
#include "flatten_body.cuh"
#include "hopper.cuh"

// -- B4 and B4p over bf16 q: int8 codes widened in registers, a cp.async ring -----------
//
// Replaces deft_tpu/ops/paged_quant.py:32 (_paged_q_kernel) for bf16 q.
// Bound on this card: bytes, the live int8 codes and scales read once; the
// widening below, repeated by every warp that multiplies a tile, and not
// the bytes, sets its pace.
// Kernel 1, one block of W warps (W = 8: 128 folded rows, two warpgroups;
// W = 4 where a head has at most 64 rows) per (row tile, KV head, span),
// writes the unnormalised (acc, m, l) of its span in flatten_body.cuh's
// layout, so its merge kernel is B1's.  What it answers in flatten_body.cuh's
// staged body (B1's over an int8 staging area, which fp32 q still runs):
// - Too few blocks: that body takes its span count from the state/KV byte
//   ratio, which int8 halves, over every plan block, dead ones included
//   (32 blocks at a rank's 21-block window: a quarter of the SMs; on the
//   main tree two of its 8 spans hold only the dead bucket tail).  Here the
//   wrapper picks the spans from the SM count (paged_flatten_attn.q_spans):
//   one block an SM.  Spans split the tiles of the plan blocks this row tile sees (the
//   block's leaf interval meets the tile's leaves, or it is FULL), listed
//   once by warp 0, so no span holds dead blocks.
// - No copy in flight during the products: a 4-stage ring of 64-token
//   tiles (K and V codes, their fp32 scales, the tokens' leaf intervals),
//   cp.async by every thread, one block barrier a tile, the copies of the
//   next three tiles in flight while a tile is multiplied; the pool rows of
//   the tile after those are read a tile ahead.  cp.async and not TMA: a
//   tile gathers up to 64 / seg_len + 1 segments (seg_len 32 in the edge
//   plans), and the tensor maps would be encoded on the host every call.
// - No staging pass: each warp widens the int8 codes in registers straight
//   into its mma.sync fragments (deft::hopper::widen4), as B5's body does:
//   the D axis permuted in Q's A fragments so a thread's K fragment is 4
//   bytes of one token's row a k16 step, two tokens' V words paired with
//   `prmt` for P V, output column n of n-tile nt at d = (D / 8) n + nt.
// - KV re-read per row tile: 128 rows a block read each tile once for
//   every row of the tile; the main tree's 256 folded rows a head read the
//   tree's KV twice, not four times.
// Scales in deft_tpu's rounding order (ops/paged_quant.py:150-177): the K
// scale on the scores after the product, the V scale on P before P is
// rounded to bf16, l over the unscaled P.  A FULL block takes no mask; a
// warp skips a tile whose tokens none of its 16 rows sees (a FULL block's
// tiles where its rows' leaves are all past blk_hi, the pad rows).
namespace deft_flat_q {

constexpr int kBN = 64;  // tokens a tile
constexpr int kStages = 4;
constexpr int kFull = 1 << 30;  // list entry: plan block | kFull for a FULL block

template <int D>
struct Layout {
  static constexpr int P = D + 16;  // int8 row pitch, 16 bytes of padding
  static constexpr int kRows = kBN * P;
  static constexpr int kStage = 2 * kRows + 4 * kBN * 4;  // K, V; K, V scales; lo, hi
  static constexpr int kRing = kStages * kStage;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int D, int W>
__global__ void __launch_bounds__(W * 32, 1)
    flatten_q_mma(const __nv_bfloat16* __restrict__ q, deft::Pools<int8_t> pools,
                  deft::SegRows rows, const int* __restrict__ tok_lo,
                  const int* __restrict__ tok_hi, const int* __restrict__ blk_lo,
                  const int* __restrict__ blk_hi, float* __restrict__ acc_out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int R, int Hq,
                  int Hkv, int nb, int block_len, float s2) {
  using L = Layout<D>;
  constexpr int NT = W * 32, RB = 16 * W;
  constexpr int CPR = D / 16;         // 16-byte chunks of a row
  constexpr int CH = kBN * CPR / NT;  // K (and V) chunks a thread copies a tile
  static_assert(CH * NT == kBN * CPR && NT >= 2 * kBN, "tile split");
  static_assert(RB * (D + 1) * 4 <= L::kRing, "the epilogue's staging fits the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* list = reinterpret_cast<int*>(smem_raw + L::kRing);  // nb entries
  int* list_hi = list + nb;                                    // their blk_hi
  __shared__ int n_list;
  const int qpk = Hq / Hkv, Rq = R * qpk;
  const int r0 = blockIdx.x * RB, h = blockIdx.y, span = blockIdx.z, spans = gridDim.z;
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
  // ks: d = (D / 4) tig + 4 ks + 0, 1 (a0, a1) and + 2, 3 (a2, a3)
  const int wr = r0 + 16 * warp;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wr + g + 8 * hh;
    const __nv_bfloat16* qr =
        q + ((long long)(r / qpk) * Hq + h * qpk + r % qpk) * D + (D / 4) * tig;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][hh] = r < Rq ? *reinterpret_cast<const uint32_t*>(qr + 4 * ks) : 0u;
      qa[ks][2 + hh] = r < Rq ? *reinterpret_cast<const uint32_t*>(qr + 4 * ks + 2) : 0u;
    }
  }
  __syncthreads();
  // this span's share of the listed blocks' 64-token tiles
  const int tpb = block_len / kBN;
  const long long total = (long long)n_list * tpb;
  const int t0 = static_cast<int>(total * span / spans);
  const int n = static_cast<int>(total * (span + 1) / spans) - t0;

  // pool rows of the tokens a thread copies in tile j: its K/V chunks', then
  // (threads < 128) the token whose K (< 64) or V scale it copies
  auto rows_of = [&](int j, int(&rw)[CH + 1]) {
    if (j >= n) return;
    const int li = t0 + j, b = list[li / tpb] & (kFull - 1), bt0 = (li % tpb) * kBN;
#pragma unroll
    for (int c = 0; c < CH; ++c) rw[c] = rows.row(b, bt0 + (tid + c * NT) / CPR, block_len);
    if (tid < 2 * kBN) rw[CH] = rows.row(b, bt0 + tid % kBN, block_len);
  };
  // start copying tile j into its stage (an empty group past the span)
  auto issue = [&](int j, const int(&rw)[CH + 1]) {
    if (j < n) {
      uint8_t* st = smem_raw + (j % kStages) * L::kStage;
      const int li = t0 + j, e = list[li / tpb], bt0 = (li % tpb) * kBN;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int u = tid + c * NT, tok = u / CPR, ch = u % CPR;
        const long long src = pools.layer_off + ((long long)rw[c] * Hkv + h) * D + ch * 16;
        deft::cp_async16(st + tok * L::P + ch * 16, pools.k + src, true);
        deft::cp_async16(st + L::kRows + tok * L::P + ch * 16, pools.v + src, true);
      }
      if (tid < 2 * kBN)
        cp_async4(st + 2 * L::kRows + 4 * tid,
                  (tid < kBN ? pools.ks : pools.vs) + pools.scale_off +
                      (long long)h * pools.S + rw[CH]);
      if (!(e & kFull) && tid < 32) {  // the tokens' leaf intervals
        const long long t = (long long)(e & (kFull - 1)) * block_len + bt0 + 4 * (tid % 16);
        deft::cp_async16(st + 2 * L::kRows + 2 * kBN * 4 + 16 * tid,
                         (tid < 16 ? tok_lo : tok_hi) + t, true);
      }
    }
    cp_async_commit();
  };

  const int row0 = wr + g, leaf0 = row0 / qpk, leaf1 = (row0 + 8) / qpk;
  const int wleaf_a = wr / qpk, wleaf_b = (min(Rq, wr + 16) - 1) / qpk;
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.f;
  float m[2] = {deft::kNeg, deft::kNeg}, l[2] = {0.f, 0.f};  // base-2 max, sum
  int rw[CH + 1];
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    rows_of(p, rw);
    issue(p, rw);
  }
  rows_of(kStages - 1, rw);
  for (int it = 0; it < n; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    issue(it + kStages - 1, rw);
    rows_of(it + kStages, rw);
    if (wr >= Rq) continue;
    const uint8_t* st = smem_raw + (it % kStages) * L::kStage;
    const int li = (t0 + it) / tpb;
    const bool full = list[li] & kFull;
    if (full && wleaf_a >= list_hi[li]) continue;  // the warp's rows are past the leaves
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kRows);
    const float* vsc = ksc + kBN;
    const int* lo = reinterpret_cast<const int*>(vsc + kBN);
    const int* hi = lo + kBN;
    if (!full) {  // skip a tile none of the warp's rows sees
      bool any = false;
#pragma unroll
      for (int k = lane; k < kBN; k += 32)
        any |= lo[k] < hi[k] && lo[k] <= wleaf_b && hi[k] > wleaf_a;
      if (!__any_sync(0xffffffffu, any)) continue;
    }
    // S = Q K^T: s[n8][i], row g (i < 2) or g + 8, token n8 * 8 + 2 tig + i % 2
    float s[kBN / 8][4];
#pragma unroll
    for (int n8 = 0; n8 < kBN / 8; ++n8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n8][i] = 0.f;
      const uint8_t* kr = st + (n8 * 8 + g) * L::P + (D / 4) * tig;
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
        uint32_t b0, b1;
        deft::hopper::widen4(kw[ks], b0, b1);
        deft::mma_bf16(s[n8], qa[ks], b0, b1);
      }
      const int c = n8 * 8 + 2 * tig;
      const float2 k2 = *reinterpret_cast<const float2*>(ksc + c);
      s[n8][0] *= s2 * k2.x;
      s[n8][1] *= s2 * k2.y;
      s[n8][2] *= s2 * k2.x;
      s[n8][3] *= s2 * k2.y;
      if (!full) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tl = lo[c + e], th = hi[c + e];
          if (!(tl <= leaf0 && leaf0 < th)) s[n8][e] = deft::kNeg;
          if (!(tl <= leaf1 && leaf1 < th)) s[n8][2 + e] = deft::kNeg;
        }
      }
    }
    // online softmax of rows g, g + 8
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = deft::kNeg;
#pragma unroll
      for (int n8 = 0; n8 < kBN / 8; ++n8)
        mx = fmaxf(mx, fmaxf(s[n8][2 * hh], s[n8][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(m[hh], mx), deft::kMClamp);
      float sum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < kBN / 8; ++n8) {
        s[n8][2 * hh] = exp2f(s[n8][2 * hh] - m_new);
        s[n8][2 * hh + 1] = exp2f(s[n8][2 * hh + 1] - m_new);
        sum += s[n8][2 * hh] + s[n8][2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      alpha[hh] = exp2f(m[hh] - m_new);
      l[hh] = l[hh] * alpha[hh] + sum;  // the unscaled P
      m[hh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }
    // O += P V, 16 tokens a step: P times the V scales, rounded to bf16;
    // V's tokens 2 tig, 2 tig + 1 (b0) and + 8, + 9 (b1) at d = (D / 8) g + nt
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const int c0 = 16 * kk + 2 * tig, c1 = c0 + 8;
      const float2 v0 = *reinterpret_cast<const float2*>(vsc + c0);
      const float2 v1 = *reinterpret_cast<const float2*>(vsc + c1);
      const uint32_t pa[4] = {deft::pack_bf16(s[2 * kk][0] * v0.x, s[2 * kk][1] * v0.y),
                              deft::pack_bf16(s[2 * kk][2] * v0.x, s[2 * kk][3] * v0.y),
                              deft::pack_bf16(s[2 * kk + 1][0] * v1.x, s[2 * kk + 1][1] * v1.y),
                              deft::pack_bf16(s[2 * kk + 1][2] * v1.x, s[2 * kk + 1][3] * v1.y)};
      const uint8_t* vr = st + L::kRows + (16 * kk) * L::P + (D / 8) * g;
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
        for (int j = 0; j < 4; ++j) deft::mma_bf16(o[4 * u + j], pa, b0w[j], b1w[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its 16 rows there

  // the span's unnormalised state: acc (spans, Hkv, Rq, D), m/l (spans, Hkv, Rq)
  constexpr int PD = D + 1;
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 16 * PD;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int d = (D / 8) * (2 * tig + e) + nt;
      stage[g * PD + d] = o[nt][e];
      stage[(g + 8) * PD + d] = o[nt][2 + e];
    }
  __syncwarp();
  const long long base = ((long long)span * Hkv + h) * Rq;
  for (int rr = 0; rr < 16 && wr + rr < Rq; ++rr)
    for (int d = lane; d < D; d += 32) acc_out[(base + wr + rr) * D + d] = stage[rr * PD + d];
  if (tig == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      if (r < Rq) {
        m_out[base + r] = m[hh];
        l_out[base + r] = l[hh];
      }
    }
  }
}

template <int D, int W>
cudaError_t launch(const void* q, deft::Pools<int8_t> pools, deft::SegRows rows,
                   const int* tok_lo, const int* tok_hi, const int* blk_lo, const int* blk_hi,
                   float* acc, float* m, float* l, void* o, float* m_o, float* l_o, int R,
                   int Hq, int Hkv, int nb, int block_len, int n_spans, float scale,
                   cudaStream_t stream) {
  auto kernel = flatten_q_mma<D, W>;
  const size_t smem = Layout<D>::kRing + 2 * sizeof(int) * nb;
  const cudaError_t attr = deft::allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int rq = R * (Hq / Hkv);
  dim3 grid((rq + 16 * W - 1) / (16 * W), Hkv, n_spans);
  kernel<<<grid, W * 32, smem, stream>>>(static_cast<const __nv_bfloat16*>(q), pools, rows,
                                         tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, R, Hq, Hkv,
                                         nb, block_len, scale * deft::kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 mgrid((rq + 3) / 4, Hkv);
  deft::flatten_merge_kernel<__nv_bfloat16>
      <<<mgrid, 128, 0, stream>>>(acc, m, l, o, m_o, l_o, n_spans, R, Hq, Hkv, D);
  return cudaGetLastError();
}

// W = 8 warps (128 rows) a block where a head has more than 64 folded rows,
// else 4 (paged_flatten_attn.q_block_rows mirrors this choice).
cudaError_t dispatch(const void* q, deft::Pools<int8_t> pools, deft::SegRows rows,
                     const int* tok_lo, const int* tok_hi, const int* blk_lo,
                     const int* blk_hi, float* acc, float* m, float* l, void* o, float* m_o,
                     float* l_o, int R, int Hq, int Hkv, int D, int nb, int block_len,
                     int n_spans, float scale, void* stream) {
  if (R <= 0 || Hkv <= 0 || Hq % Hkv || n_spans <= 0 || nb <= 0 || block_len % kBN ||
      !m_o != !l_o)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = R * (Hq / Hkv) > 64;
#define DEFT_FLAT_Q_LAUNCH(DD, WW)                                                           \
  launch<DD, WW>(q, pools, rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, \
                 Hq, Hkv, nb, block_len, n_spans, scale, st)
  if (D == 128) return wide ? DEFT_FLAT_Q_LAUNCH(128, 8) : DEFT_FLAT_Q_LAUNCH(128, 4);
  if (D == 64) return wide ? DEFT_FLAT_Q_LAUNCH(64, 8) : DEFT_FLAT_Q_LAUNCH(64, 4);
#undef DEFT_FLAT_Q_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace deft_flat_q

// Every entry takes the arguments of every flatten entry (flatten_gather.cu
// too); the partial entries take acc_o, m_o, l_o where the others take o.
// dtype: 0 = float32, 1 = bfloat16 (q and o; B1's pools too).  q, o:
// (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S * Hkv * D; B4's scale
// pools (L, Hkv, S) fp32 with scale_off = li * Hkv * S (B1: null, 0, and S
// unread); tok_lo/hi (nb * block_len,); blk_lo/hi (nb,); seg_src
// (nb * block_len / seg_len,); acc (n_spans, Hkv, R*qpk, D) and m, l
// (n_spans, Hkv, R*qpk) fp32 scratch.  Returns a cudaError_t code.
namespace {

int paged_entry(bool int8, const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, long long layer_off,
                long long scale_off, int S, const int* seg_src, const int* tok_lo,
                const int* tok_hi, const int* blk_lo, const int* blk_hi, float* acc, float* m,
                float* l, void* o, float* m_o, float* l_o, int R, int Hq, int Hkv, int D,
                int nb, int block_len, int seg_len, int n_spans, int dtype, float scale,
                void* stream) {
  if (seg_len <= 0 || block_len % seg_len || int8 != (k_scale && v_scale) ||
      (!int8 && (k_scale || v_scale)))
    return cudaErrorInvalidValue;
  const deft::SegRows rows{seg_src, seg_len, block_len / seg_len};
  if (int8 && dtype == 1)
    return deft_flat_q::dispatch(
        q, {static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), k_scale,
            v_scale, layer_off, scale_off, S},
        rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb,
        block_len, n_spans, scale, stream);
  if (int8)
    return deft::dispatch_flatten<int8_t, int8_t>(
        q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, rows, tok_lo, tok_hi,
        blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, dtype,
        scale, stream);
  return deft::dispatch_flatten<float, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, layer_off, 0, 0, rows, tok_lo, tok_hi, blk_lo,
      blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, dtype, scale,
      stream);
}

}  // namespace

// B1 and B4: the normalised output o (R, Hq, D).
extern "C" int deft_paged_flatten(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, void* o, int R, int Hq,
    int Hkv, int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(false, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, nullptr, nullptr, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale, stream);
}

extern "C" int deft_paged_flatten_q(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, void* o, int R, int Hq,
    int Hkv, int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(true, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, nullptr, nullptr, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale, stream);
}

// B1's and B4's partial=True entries (deft_tpu paged_flatten_attn.py:408,
// paged_quant.py:321): the unnormalised state of the plan's blocks, for a
// merge across devices.  acc_o (Hkv, R*qpk, D), m_o and l_o (Hkv, R*qpk),
// fp32, m in natural-log units, where the entries above take o.
extern "C" int deft_paged_flatten_partial(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, float* acc_o, float* m_o,
    float* l_o, int R, int Hq,
    int Hkv, int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(false, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, acc_o, m_o,
                     l_o, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale, stream);
}

extern "C" int deft_paged_flatten_q_partial(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, float* acc_o, float* m_o,
    float* l_o, int R, int Hq,
    int Hkv, int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(true, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, acc_o, m_o,
                     l_o, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale, stream);
}
