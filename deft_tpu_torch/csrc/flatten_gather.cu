// DeFT-Flatten tree-decode attention for plans that are not segment-aligned:
// every plan token carries its own pool row.
//
// Replaces the Pallas TPU kernel B6, deft_tpu/ops/flatten_attn.py:77
// (_flatten_kernel, launched by flatten_attention :141 from
// flatten_attn_pallas :204).  deft_tpu first gathers the tree's KV in XLA
// into a contiguous (Hkv, T, D) copy (dequantised for int8 pools), then runs
// the kernel over it.  This kernel reads row kv_idx[t] of the pool inside
// the kernel instead: the same function, one copy of the tree's KV less per
// layer.  The plan's pads (a tree's bucket tail, a multi-tree plan's tail)
// point at DUMP_SLOT, pool row 0, with empty leaf intervals (tok_lo = 2^30,
// tok_hi = 0): their rows are read and masked, never attended.
//
// Bound on this card: bytes.  T * Hkv * D * 2 * itemsize per layer (plus the
// int8 scales, T * Hkv * 4 * 2) and 4 bytes of kv_idx a token, against
// 3.35 TB/s.  Design: over bf16 q, at every head_dim (64, 96, 128, 256), the
// tensor-core body of flat_q_body.cuh (B1's and B4's, deft_flat_q) with
// deft::IdxRows as its row source: 64 or 128 folded rows a block, warp 0
// lists the plan blocks its row tile sees, the spans split their 64-token
// tiles, and a cp.async ring puts each tile's 64 pool rows, read from kv_idx
// a tile ahead, into the boxes RS or SS wgmma reads (bf16 pools) or into rows
// the int8 codes are widened from in registers for mma.sync (int8 pools);
// then the merge kernel.  At Phi-3-mini's D 96 and Gemma-7B's D 256 the
// body's Layout adds a zeroed half box (D 96) and a two-stage ring beside Q
// staged in shared memory (D 256).  The wrapper picks the spans
// (ops/paged_flatten_attn.py).  Over fp32 q, the staged split-KV kernels of
// flatten_body.cuh with the same row source.
#include "flat_q_body.cuh"

namespace {

int gather_entry(const void* q, const void* k_pool, const void* v_pool,
                 const float* k_scale, const float* v_scale, long long layer_off,
                 long long scale_off, int S, const int* kv_idx, const int* tok_lo,
                 const int* tok_hi, const int* blk_lo, const int* blk_hi, float* acc, float* m,
                 float* l, void* o, float* m_o, float* l_o, int R, int Hq, int Hkv, int D,
                 int nb, int block_len, int n_spans, int dtype, float scale, void* stream) {
  if (!k_scale != !v_scale || !acc || !m || !l || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const deft::IdxRows rows{kv_idx};
  if (dtype == 1 && k_scale)
    return deft_flat_q::dispatch<int8_t, true>(
        q, {static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), k_scale,
            v_scale, layer_off, scale_off, S},
        rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb,
        block_len, n_spans, scale, stream);
  if (dtype == 1)
    return deft_flat_q::dispatch<__nv_bfloat16, true>(
        q,
        {static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
         nullptr, nullptr, layer_off, 0, 0},
        rows, tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb,
        block_len, n_spans, scale, stream);
  if (k_scale)
    return deft::dispatch_flatten<int8_t, true>(
        q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, rows, tok_lo, tok_hi,
        blk_lo, blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, scale,
        stream);
  return deft::dispatch_flatten<float, true>(
      q, k_pool, v_pool, nullptr, nullptr, layer_off, 0, 0, rows, tok_lo, tok_hi, blk_lo,
      blk_hi, acc, m, l, o, m_o, l_o, R, Hq, Hkv, D, nb, block_len, n_spans, scale, stream);
}

}  // namespace

// The arguments of every flatten entry (paged_flatten.cu); seg_len is unread.
// dtype: 0 = float32, 1 = bfloat16 (q and o; the pools too unless int8).
// k_scale / v_scale: (L, Hkv, S) fp32 scales of int8 pools, null for pools
// of the q type.  q, o: (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S
// * Hkv * D; scale_off = li * Hkv * S; kv_idx, tok_lo/hi (nb * block_len,);
// blk_lo/hi (nb,); acc (n_spans, Hkv, R*qpk, D) and m, l (n_spans, Hkv,
// R*qpk) fp32 scratch.  Returns a cudaError_t code.
extern "C" int deft_flatten_gather(const void* q, const void* k_pool, const void* v_pool,
                                   const float* k_scale, const float* v_scale,
                                   long long layer_off, long long scale_off, int S,
                                   const int* kv_idx, const int* tok_lo,
                                   const int* tok_hi, const int* blk_lo,
                                   const int* blk_hi, float* acc, float* m, float* l,
                                   void* o, int R, int Hq, int Hkv, int D, int nb,
                                   int block_len, int /*seg_len*/, int n_spans, int dtype,
                                   float scale, void* stream) {
  return gather_entry(q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, kv_idx,
                      tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, o, nullptr, nullptr, R, Hq,
                      Hkv, D, nb, block_len, n_spans, dtype, scale, stream);
}

// B11, deft_tpu ops/sharded_flatten.py:37 (_partial_kernel, launched by
// flatten_attention_partial :93): one rank's unnormalised (acc, m, l) over
// its span of a gather plan, for a merge across devices.  deft_tpu's
// multi-device engine gathers the span's KV in XLA first and runs the kernel
// over the copy (parallel/engine.py:185-196); this entry reads row kv_idx[t]
// of the pool in the kernel, as deft_flatten_gather does, over bf16/fp32 or
// int8 pools, on the same bodies.  Blocks whose leaf interval, already
// shifted into the rank's row window, misses its rows are skipped before any
// read (deft_tpu sharded_flatten.py:55-60): no row tile lists such a block.
// Arguments of deft_flatten_gather, with acc_o (Hkv, R*qpk, D), m_o and l_o
// (Hkv, R*qpk), fp32, m in natural-log units, where it takes o.
// Bound on this card: bytes, as deft_flatten_gather over the span.
extern "C" int deft_flatten_gather_partial(
    const void* q, const void* k_pool, const void* v_pool, const float* k_scale,
    const float* v_scale, long long layer_off, long long scale_off, int S,
    const int* kv_idx, const int* tok_lo, const int* tok_hi, const int* blk_lo,
    const int* blk_hi, float* acc, float* m, float* l, float* acc_o, float* m_o,
    float* l_o, int R, int Hq, int Hkv, int D, int nb, int block_len, int /*seg_len*/,
    int n_spans, int dtype, float scale, void* stream) {
  return gather_entry(q, k_pool, v_pool, k_scale, v_scale, layer_off, scale_off, S, kv_idx,
                      tok_lo, tok_hi, blk_lo, blk_hi, acc, m, l, acc_o, m_o, l_o, R, Hq, Hkv,
                      D, nb, block_len, n_spans, dtype, scale, stream);
}
