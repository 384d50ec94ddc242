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
// The plan (plan/flatten.py) lays the tree's KV out in DFS order in blocks of
// block_len tokens; segment j of block b is the pool span
// [seg_src[b*nseg + j], + seg_len).  Both entries run the split-KV kernels
// of flatten_body.cuh over that segment table.
//
// Bound on this card: bytes.  The KV of the flattened tree per layer,
// T * Hkv * D * 2 * itemsize, plus for int8 the scales, T * Hkv * 4 * 2,
// against 3.35 TB/s; each block of KV is read once per 64-row query tile
// that attends it.  B4 reads half B1's KV bytes: its tiles arrive as int8
// (cp.async into a staging area) and are widened to the q type in shared
// memory, so the tensor-core products and the online softmax are B1's, with
// the K scales applied to the scores after the product and the V scales to
// P before PV, as deft_tpu ops/paged_quant.py:150-177 orders them.
#include "flatten_body.cuh"

// Both entries take the arguments of every flatten entry (flatten_gather.cu
// too).  dtype: 0 = float32, 1 = bfloat16 (q and o; B1's pools too).  q, o:
// (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S * Hkv * D; B4's scale
// pools (L, Hkv, S) fp32 with scale_off = li * Hkv * S (B1: null, 0, and S
// unread); tok_lo/hi (nb * block_len,); blk_lo/hi (nb,); seg_src
// (nb * block_len / seg_len,); acc (n_spans, Hkv, R*qpk, D) and m, l
// (n_spans, Hkv, R*qpk) fp32 scratch.  Returns a cudaError_t code.
extern "C" int deft_paged_flatten(const void* q, const void* k_pool, const void* v_pool,
                                  const float* k_scale, const float* v_scale,
                                  long long layer_off, long long scale_off, int S,
                                  const int* seg_src, const int* tok_lo,
                                  const int* tok_hi, const int* blk_lo,
                                  const int* blk_hi, float* acc, float* m, float* l,
                                  void* o, int R, int Hq, int Hkv, int D, int nb,
                                  int block_len, int seg_len, int n_spans, int dtype,
                                  float scale, void* stream) {
  if (seg_len <= 0 || block_len % seg_len || k_scale || v_scale)
    return cudaErrorInvalidValue;
  const deft::SegRows rows{seg_src, seg_len, block_len / seg_len};
  return deft::dispatch_flatten<float, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, layer_off, 0, 0, rows, tok_lo, tok_hi, blk_lo,
      blk_hi, acc, m, l, o, R, Hq, Hkv, D, nb, block_len, n_spans, dtype, scale, stream);
}

extern "C" int deft_paged_flatten_q(const void* q, const void* k_pool, const void* v_pool,
                                    const float* k_scale, const float* v_scale,
                                    long long layer_off, long long scale_off, int S,
                                    const int* seg_src, const int* tok_lo,
                                    const int* tok_hi, const int* blk_lo,
                                    const int* blk_hi, float* acc, float* m, float* l,
                                    void* o, int R, int Hq, int Hkv, int D, int nb,
                                    int block_len, int seg_len, int n_spans, int dtype,
                                    float scale, void* stream) {
  if (seg_len <= 0 || block_len % seg_len || !k_scale || !v_scale)
    return cudaErrorInvalidValue;
  const deft::SegRows rows{seg_src, seg_len, block_len / seg_len};
  return deft::dispatch_flatten<int8_t, int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, rows, tok_lo, tok_hi,
      blk_lo, blk_hi, acc, m, l, o, R, Hq, Hkv, D, nb, block_len, n_spans, dtype, scale,
      stream);
}
