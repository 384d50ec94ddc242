// Sequential per-leaf decode attention reading paged KV in the kernel: the
// fair seq (Flash-Decoding) baseline DeFT is compared with.
//
// Replaces two Pallas TPU kernels, both deft_tpu/ops/paged_seq_attn.py:41
// (_paged_seq_kernel, launched by _paged_seq_call :246):
//   B2 for paged_seq_attention :328, bf16/fp32 pools: entry deft_paged_seq;
//   B5 for paged_seq_attention_q :369 (quantized=True), int8 pools with
//      per-(token, head) fp32 scales stored head-major (L, Hkv, S): entry
//      deft_paged_seq_q;
//   and their partial=True entries, which the multi-device engine runs on
//   each rank's span of every leaf's path blocks (deft_tpu
//   parallel/seq_engine.py): B2p paged_seq_attention_partial :351, entry
//   deft_paged_seq_partial, and B5p paged_seq_attention_q_partial :389,
//   entry deft_paged_seq_q_partial (seq_body.cuh's partial epilogue).
// Leaf r's root-to-leaf path is the live spans of its segments: segment j
// of leaf r covers pool rows seg_src + seg_off .. + seg_live (plan/seq.py),
// in path order; blocks with blk_live == 0 hold no live token.
//
// Bound on this card: bytes.  Each leaf re-reads its whole live path
// (the baseline's defining cost), sum_r len_r * Hkv * D * 2 * itemsize per
// layer (plus for int8 the scales, sum_r len_r * Hkv * 4 * 2); the shared
// prefix's re-reads mostly hit L2, so the guide's rule (each input byte
// once: the unique live rows) gives the lower bound, and L2 bandwidth sets
// the pace between the two.  Over fp32 q (the exactness checks) B2 and B5
// run the kernel of seq_body.cuh, one block per (leaf, KV head): warp 0
// prefix-sums the segments' live counts once, so tile i of 64 path tokens
// maps to pool rows by a binary search and every tile holds only live tokens
// (the segments' dead lead-ins and tails are never read, where the TPU
// kernel DMAs whole segments and masks them).  Over bf16 q all four entries
// run the tensor-core body of seq_q_body.cuh (deft_seq_q, with
// deft_seq::SegPath as its path source), on the same prefix sums.
#include "seq_q_body.cuh"

namespace {

int paged_seq_entry(bool int8, const void* q, const void* k_pool, const void* v_pool,
                    const float* k_scale, const float* v_scale, void* o, float* m_o,
                    float* l_o, long long layer_off, long long scale_off, int S,
                    const int* seg_src, const int* seg_off, const int* seg_live,
                    const int* blk_live, int R, int Hq, int Hkv, int D, int nseg, int spb,
                    int splits, int dtype, float scale, void* stream) {
  if (spb <= 0 || nseg % spb || int8 != (k_scale && v_scale) ||
      (!int8 && (k_scale || v_scale)) || (dtype != 0 && dtype != 1) ||
      (dtype == 0 && splits != 1))
    return cudaErrorInvalidValue;
  const deft_seq::SegPath path{seg_src, seg_off, seg_live, blk_live, nseg, spb};
  if (dtype == 1 && int8)
    return deft_seq_q::dispatch<int8_t>(
        q, {static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool), k_scale,
            v_scale, layer_off, scale_off, S},
        path, o, m_o, l_o, R, Hq, Hkv, D, splits, scale, stream);
  if (dtype == 1)
    return deft_seq_q::dispatch<__nv_bfloat16>(
        q,
        {static_cast<const __nv_bfloat16*>(k_pool), static_cast<const __nv_bfloat16*>(v_pool),
         nullptr, nullptr, layer_off, 0, 0},
        path, o, m_o, l_o, R, Hq, Hkv, D, splits, scale, stream);
  if (int8)
    return deft_seq::dispatch_seq<int8_t, false>(
        q, k_pool, v_pool, k_scale, v_scale, o, m_o, l_o, layer_off, scale_off, S, path,
        deft_seq_q::path_smem(path), R, Hq, Hkv, D, scale, stream);
  return deft_seq::dispatch_seq<float, false>(
      q, k_pool, v_pool, nullptr, nullptr, o, m_o, l_o, layer_off, 0, 0, path,
      deft_seq_q::path_smem(path), R, Hq, Hkv, D, scale, stream);
}

}  // namespace

// Every entry takes the same arguments, the partial ones acc, m, l where the
// others take o.  dtype: 0 = float32, 1 = bfloat16 (q and o; B2's pools
// too).  q, o: (R, Hq, D); pools (L, S, Hkv*D); layer_off = li * S * Hkv * D;
// B5's scale pools (L, Hkv, S) fp32 with scale_off = li * Hkv * S (B2: null,
// 0, and S unread); seg_src/off/live (R * nseg,); blk_live (R * nseg / spb,).
// splits: the blocks of a cluster that share each (leaf, head)'s path, 1 ..
// 8 over bf16 q (the tensor-core body), else 1.  Returns a cudaError_t code.
extern "C" int deft_paged_seq(const void* q, const void* k_pool, const void* v_pool,
                              const float* k_scale, const float* v_scale, void* o,
                              long long layer_off, long long scale_off, int S,
                              const int* seg_src, const int* seg_off, const int* seg_live,
                              const int* blk_live, int R, int Hq, int Hkv, int D, int nseg,
                              int spb, int splits, int dtype, float scale, void* stream) {
  return paged_seq_entry(false, q, k_pool, v_pool, k_scale, v_scale, o, nullptr, nullptr,
                         layer_off, scale_off, S, seg_src, seg_off, seg_live, blk_live, R,
                         Hq, Hkv, D, nseg, spb, splits, dtype, scale, stream);
}

extern "C" int deft_paged_seq_q(const void* q, const void* k_pool, const void* v_pool,
                                const float* k_scale, const float* v_scale, void* o,
                                long long layer_off, long long scale_off, int S,
                                const int* seg_src, const int* seg_off,
                                const int* seg_live, const int* blk_live, int R, int Hq,
                                int Hkv, int D, int nseg, int spb, int splits, int dtype,
                                float scale, void* stream) {
  return paged_seq_entry(true, q, k_pool, v_pool, k_scale, v_scale, o, nullptr, nullptr,
                         layer_off, scale_off, S, seg_src, seg_off, seg_live, blk_live, R,
                         Hq, Hkv, D, nseg, spb, splits, dtype, scale, stream);
}

// B2's and B5's partial=True entries (deft_tpu paged_seq_attn.py:351, :389):
// the unnormalised state of each leaf over the path blocks in the tables,
// for a merge across devices.  acc (R, Hq, D), m and l (R, Hq), fp32, m in
// natural-log units.
extern "C" int deft_paged_seq_partial(const void* q, const void* k_pool, const void* v_pool,
                                      const float* k_scale, const float* v_scale,
                                      float* acc, float* m, float* l, long long layer_off,
                                      long long scale_off, int S, const int* seg_src,
                                      const int* seg_off, const int* seg_live,
                                      const int* blk_live, int R, int Hq, int Hkv, int D,
                                      int nseg, int spb, int splits, int dtype, float scale,
                                      void* stream) {
  return paged_seq_entry(false, q, k_pool, v_pool, k_scale, v_scale, acc, m, l, layer_off,
                         scale_off, S, seg_src, seg_off, seg_live, blk_live, R, Hq, Hkv, D,
                         nseg, spb, splits, dtype, scale, stream);
}

extern "C" int deft_paged_seq_q_partial(const void* q, const void* k_pool,
                                        const void* v_pool, const float* k_scale,
                                        const float* v_scale, float* acc, float* m,
                                        float* l, long long layer_off, long long scale_off,
                                        int S, const int* seg_src, const int* seg_off,
                                        const int* seg_live, const int* blk_live, int R,
                                        int Hq, int Hkv, int D, int nseg, int spb,
                                        int splits, int dtype, float scale, void* stream) {
  return paged_seq_entry(true, q, k_pool, v_pool, k_scale, v_scale, acc, m, l, layer_off,
                         scale_off, S, seg_src, seg_off, seg_live, blk_live, R, Hq, Hkv, D,
                         nseg, spb, splits, dtype, scale, stream);
}
