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
// Bound on this card: operations.  2 * 2 * Hq * D * (sum of the causal
// pairs) FLOPs against 989 TFLOP/s of bf16 tensor cores (B3: N^2 / 2 pairs;
// B8: sum of L_i^2 / 2), while K and V are only read once per 64-row tile.
// Design: one block per (64 folded rows, KV head); a loop in the block walks
// the 64-token KV tiles up to the causal diagonal (the TPU's sequential kv
// grid axis), skipping tiles above it; tiles entirely below the tile's
// first token take no mask.  B8 also starts the loop at the tile of the
// first row's prompt start — rows are ascending, so that is the smallest
// start among the tile's rows — so B prompts cost sum L_i^2 / 2, not
// (sum L_i)^2 / 2; only tiles that straddle a prompt boundary or the
// diagonal take the segment mask.  Products run on mma.sync tensor cores
// (flash_common.cuh).  Blocks are issued last-tile-first, so the longest
// rows start first and the tail of the grid is short.  Q, K and V keep the
// model's (N, heads, D) layout: no fold/unfold copies.
#include "flash_common.cuh"

namespace deft {

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

template <bool kRagged>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* seg,
                     const int* seg_start, void* o, int N, int Hq, int Hkv, int D, int dtype,
                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Hkv <= 0 || Hq % Hkv) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale,
                                               s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale,
                                              s);
  if (dtype == 0 && D == 128)
    return launch<float, 128, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64, kRagged>(q, k, v, seg, seg_start, o, N, Hq, Hkv, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace deft

// dtype: 0 = float32, 1 = bfloat16.  q, o: (N, Hq, D); k, v: (N, Hkv, D),
// all contiguous.  Returns a cudaError_t code (0 = launched).
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
