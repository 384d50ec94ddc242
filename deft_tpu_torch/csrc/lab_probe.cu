// B15: the flatten kernel lab's exp2 probe on the card.
//
// Replaces _probe_kernel (deft_tpu experiments/kernel_lab.py:763, launched by
// make_exp2_probe's pallas_call :790): nb grid steps x `passes` sweeps of
// x <- exp2(-0.9999 x) over an (Rq, width) fp32 tile that starts at -0.5 and
// is carried from step to step, the first D columns written out (here the
// start tile is an input, which the lab fills with -0.5).  On the TPU
// it isolates the transcendental throughput that bounds the exact flatten
// kernels' score math; on the card it answers the same question for the
// instruction the flatten bodies use: exp2f as flash_common.cuh's tile_update
// takes it, compiled with ops/_cuda.py's flags (no fast-math), which the
// build turns into MUFU.EX2 (chip_smoke.py prints the SASS count).
//
// Bound on this card: transcendentals.  Every element is an independent
// chain of nb * passes dependent exp2 steps (131,072 chains of 72 steps at
// the lab's b512 case: 9.44 M exp2), against 16 exp2 a clock per SM (the
// CUDA C Programming Guide's arithmetic-instruction throughput, compute
// capability 9.0) x 132 SMs x the SM clock: about 2.3 us at 1.98 GHz.
// Design: one thread runs kChains independent chains, so each SM sub-
// partition has several exp2 in flight behind the latency of one; the whole
// tile is written back (the carried state), so no chain is dead code.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 4;  // independent chains a thread
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    lab_probe_kernel(const float* __restrict__ x0, float* __restrict__ o,
                     float* __restrict__ tile, int rq, int width, int d, int steps) {
  const long long n = (long long)rq * width;
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kChains;
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = i0 + c < n ? x0[i0 + c] : 0.f;
  for (int s = 0; s < steps; ++s)
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = exp2f(x[c] * -0.9999f);
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    const long long i = i0 + c;
    if (i >= n) continue;
    tile[i] = x[c];
    const int r = (int)(i / width), col = (int)(i % width);
    if (col < d) o[(long long)r * d + col] = x[c];
  }
}

}  // namespace

// x0 (rq, width) fp32: the tile's start; o (1, rq, d) fp32: the first d
// columns of the tile after nb * passes sweeps; tile (rq, width): the whole
// tile, written too.  Returns a cudaError_t code.
extern "C" int deft_lab_probe(const float* x0, float* o, float* tile, int rq, int width,
                              int d, int nb, int passes, void* stream) {
  if (!x0 || !o || !tile || rq <= 0 || width <= 0 || d <= 0 || d > width || nb <= 0 || passes <= 0)
    return cudaErrorInvalidValue;
  const long long n = (long long)rq * width;
  const long long threads = (n + kChains - 1) / kChains;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  lab_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x0, o, tile, rq, width, d, nb * passes);
  return cudaGetLastError();
}
