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
// unnormalised (acc, m, l) of the plan's blocks, m in natural log.
// The plan (plan/flatten.py) lays the tree's KV out in DFS order in blocks of
// block_len tokens; segment j of block b is the pool span
// [seg_src[b*nseg + j], + seg_len); every entry reads the tokens through
// that segment table.
//
// Bound on this card: bytes.  The KV of the flattened tree per layer,
// T * Hkv * D * 2 * itemsize, plus for int8 the scales, T * Hkv * 4 * 2,
// against 3.35 TB/s.  Over bf16 q all four entries run the tensor-core body
// of flat_q_body.cuh (deft_flat_q) through the segment table
// (deft::SegRows); over fp32 q (the exactness checks) they run the split-KV
// kernels of flatten_body.cuh and its merge kernel.
#include "flat_q_body.cuh"

// Every entry takes the arguments of every flatten entry (flatten_gather.cu
// too); the partial entries take acc_o, m_o, l_o where the others take o.
// dtype: 0 = float32, 1 = bfloat16 (q and o; B1's pools too).  q, o:
// (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S * Hkv * D; B4's scale
// pools (L, Hkv, S) fp32 with scale_off = li * Hkv * S (B1: null, 0, and S
// unread); tok_lo/hi (nb * block_len,); blk_lo/hi (nb,); seg_src
// (nb * block_len / seg_len,); acc (n_spans, Hkv, R*qpk, D) and m, l
// (n_spans, Hkv, R*qpk) fp32 scratch of the spans' states, which the merge
// kernel reads.  Returns a cudaError_t code.
namespace {

int paged_entry(bool int8, const void* q, const void* k_pool, const void* v_pool,
                const float* k_scale, const float* v_scale, long long layer_off,
                long long scale_off, int S, const int* seg_src, const int* tok_lo,
                const int* tok_hi, const int* blk_lo, const int* blk_hi, float* acc, float* m,
                float* l, void* o, float* m_o, float* l_o, int R, int Hq, int Hkv, int D,
                int nb, int block_len, int seg_len, int n_spans, int dtype, float scale,
                void* stream) {
  if (seg_len <= 0 || block_len % seg_len || int8 != (k_scale && v_scale) ||
      (!int8 && (k_scale || v_scale)) || !acc || !m || !l)
    return cudaErrorInvalidValue;
  const deft::SegRows rows{seg_src, seg_len, block_len / seg_len};
  if (dtype == 1 && int8)
    return deft_flat_q::dispatch<int8_t, false>(
        q, {static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), k_scale,
            v_scale, layer_off, scale_off, S},
        rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb,
        block_len, n_spans, scale, stream);
  if (dtype == 1)
    return deft_flat_q::dispatch<__nv_bfloat16, false>(
        q,
        {static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
         nullptr, nullptr, layer_off, 0, 0},
        rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb,
        block_len, n_spans, scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  if (int8)
    return deft::dispatch_flatten<int8_t, false>(
        q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, rows, tok_lo, tok_hi,
        blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, scale,
        stream);
  return deft::dispatch_flatten<float, false>(
      q, k_pool, v_pool, nullptr, nullptr, layer_off, 0, 0, rows, tok_lo, tok_hi, blk_lo,
      blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, scale, stream);
}

}  // namespace

// B1 and B4: the normalised output o (R, Hq, D).
extern "C" int deft_paged_flatten(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, void* o, int R, int Hq, int Hkv,
    int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(false, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, nullptr, nullptr, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale,
                     stream);
}

extern "C" int deft_paged_flatten_q(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, void* o, int R, int Hq, int Hkv,
    int D, int nb, int block_len, int seg_len, int n_spans, int dtype,
    float scale, void* stream) {
  return paged_entry(true, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, nullptr, nullptr, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale,
                     stream);
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
    float* l_o, int R, int Hq, int Hkv, int D, int nb, int block_len, int seg_len,
    int n_spans, int dtype, float scale, void* stream) {
  return paged_entry(false, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, acc_o, m_o, l_o, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale,
                     stream);
}

extern "C" int deft_paged_flatten_q_partial(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* seg_src, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, float* acc_o, float* m_o,
    float* l_o, int R, int Hq, int Hkv, int D, int nb, int block_len, int seg_len,
    int n_spans, int dtype, float scale, void* stream) {
  return paged_entry(true, q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S,
                     seg_src, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, acc_o, m_o, l_o, R,
                     Hq, Hkv, D, nb, block_len, seg_len, n_spans, dtype, scale,
                     stream);
}
