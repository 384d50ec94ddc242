// Sequential per-leaf decode attention for plans that are not segment-aligned:
// each leaf's path is a padded row of pool indices.
//
// Replaces the Pallas TPU kernel B7, deft_tpu/ops/seq_attn.py:28
// (_seq_kernel, launched by seq_attention :89 from seq_attn_pallas :132).
// deft_tpu first gathers every leaf's padded path in XLA into a dense
// (R, Hkv, C, D) copy (dequantised for int8 pools), then runs the kernel over
// it in 128-token blocks masked by seq_lens.  This kernel reads row
// paths[r, c] of the pool for c < seq_lens[r] inside the kernel: the same
// function, without the copy and without reading the padding.  The pad
// entries (DUMP_SLOT, slot 0) are never read.
//
// Bound on this card: bytes.  The per-leaf path bytes summed over leaves,
// sum_r seq_lens[r] * Hkv * D * 2 * itemsize per layer (plus for int8 the
// scales, sum_r seq_lens[r] * Hkv * 4 * 2) and 4 bytes of paths a token,
// against 3.35 TB/s.  Design: the kernel of seq_body.cuh (B2's), one block
// per (leaf, KV head), with each 64-token tile's rows taken from the leaf's
// row of paths; its tiles are 64 tokens where the TPU kernel's blocks are
// 128.  Per-leaf re-reads of the shared prefix are kept: they are the
// baseline's defining cost.  int8 pools are widened and scaled as in B5.
#include "seq_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and o; the pools too unless int8).
// k_scale / v_scale: (L, Hkv, S) fp32 scales of int8 pools, null for pools
// of the q type.  q, o: (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S
// * Hkv * D; scale_off = li * Hkv * S; paths (R, C); seq_lens (R,), each at
// most C.  Returns a cudaError_t code.
extern "C" int deft_seq_gather(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale, void* o,
                               long long layer_off, long long scale_off, int S,
                               const int* paths, const int* seq_lens, int R, int C,
                               int Hq, int Hkv, int D, int dtype, float scale,
                               void* stream) {
  if (C <= 0 || !k_scale != !v_scale) return cudaErrorInvalidValue;
  const deft_seq::IdxPath path{paths, seq_lens, C};
  if (k_scale)
    return deft_seq::dispatch_seq<int8_t, int8_t>(q, k_pool, v_pool, k_scale, v_scale, o,
                                                  nullptr, nullptr, layer_off, scale_off, S,
                                                  path, 0, R, Hq, Hkv, D, dtype, scale,
                                                  stream);
  return deft_seq::dispatch_seq<float, __nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr,
                                                      o, nullptr, nullptr, layer_off, 0, 0,
                                                      path, 0, R, Hq, Hkv, D, dtype, scale,
                                                      stream);
}
