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
// entries (DUMP_SLOT, slot 0) are never read, nor their entries of paths.
//
// Bound on this card: bytes.  The per-leaf path bytes summed over leaves,
// sum_r seq_lens[r] * Hkv * D * 2 * itemsize per layer (plus for int8 the
// scales, sum_r seq_lens[r] * Hkv * 4 * 2) and 4 bytes of paths a token,
// against 3.35 TB/s; the shared prefix's re-reads mostly hit L2, so each
// live row read once is the lower bound.  Design: over bf16 q, the
// tensor-core bodies of seq_q_body.cuh (B2's and B5's, deft_seq_q) with
// deft_seq::IdxPath as their path source: one block of 2 warps per (leaf,
// KV head, span of the path), the blocks of a cluster sharing a path where
// the (leaf, head) pairs alone would leave SMs idle (the wrapper's splits,
// from R, Hkv and the SM count), each warp walking its span of 16-token
// tiles through a 3-stage cp.async ring, the pool rows of a tile read from
// paths a tile ahead; mma.sync over bf16 pools (ldmatrix) and over int8
// pools (codes widened in registers, scales at the token's pool row); the
// cluster merges its warps' states in a fixed order.  At head_dim 64 and
// 128 the query rows lie on the products' M (seq_q_mma); at 96 and 256
// (Phi-3-mini, Gemma-7B, one query row a KV head) on N, the path tokens on
// M (seq_q_wide): S^T = K Q^T, O^T = V^T P^T, so a thread holds D / 16 x 4
// accumulators, not D / 8 x 4 of which half are always zero.  What this
// answers in the staged body that B7 ran before (seq_body.cuh, which fp32 q
// keeps for the exactness checks): fp32 FMA products with the tensor cores
// idle, 64-token tiles behind block barriers with no copy in flight, and
// one block a (leaf, head) however few leaves there are.  Per-leaf re-reads
// of the shared prefix are kept: they are the baseline's defining cost.
#include "seq_q_body.cuh"

// dtype: 0 = float32, 1 = bfloat16 (q and o; the pools too unless int8).
// k_scale / v_scale: (L, Hkv, S) fp32 scales of int8 pools, null for pools
// of the q type.  q, o: (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S
// * Hkv * D; scale_off = li * Hkv * S; paths (R, C); seq_lens (R,), each at
// most C.  D: 64, 96, 128 or 256.  splits: the blocks of a cluster that
// share each (leaf, head)'s path, 1 .. 8 over bf16 q (the tensor-core
// bodies), else 1.  Returns a cudaError_t code.
extern "C" int deft_seq_gather(const void* q, const void* k_pool, const void* v_pool,
                               const float* k_scale, const float* v_scale, void* o,
                               long long layer_off, long long scale_off, int S,
                               const int* paths, const int* seq_lens, int R, int C,
                               int Hq, int Hkv, int D, int splits, int dtype, float scale,
                               void* stream) {
  if (C <= 0 || !k_scale != !v_scale || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && splits != 1))
    return cudaErrorInvalidValue;
  const deft_seq::IdxPath path{paths, seq_lens, C};
  if (dtype == 1 && k_scale)
    return deft_seq_q::dispatch<int8_t>(
        q, {static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), k_scale,
            v_scale, layer_off, scale_off, S},
        path, o, nullptr, nullptr, R, Hq, Hkv, D, splits, scale, stream);
  if (dtype == 1)
    return deft_seq_q::dispatch<__nv_bfloat16>(
        q,
        {static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
         nullptr, nullptr, layer_off, 0, 0},
        path, o, nullptr, nullptr, R, Hq, Hkv, D, splits, scale, stream);
  if (k_scale)
    return deft_seq::dispatch_seq<int8_t, true>(q, k_pool, v_pool, k_scale, v_scale, o,
                                                nullptr, nullptr, layer_off, scale_off, S,
                                                path, 0, R, Hq, Hkv, D, scale, stream);
  return deft_seq::dispatch_seq<float, true>(q, k_pool, v_pool, nullptr, nullptr, o, nullptr,
                                             nullptr, layer_off, 0, 0, path, 0, R, Hq, Hkv,
                                             D, scale, stream);
}
