// float16 instances of the layers-only B=1 decode step (K10): the chain of
// decode_step.cuh for float16 weights, norms and caches, compiled apart
// from the float32 and bfloat16 ones so that nvcc builds the two at once.
// The products are float16 m16n8k16 with float32 sums, each input rounded
// to float16 where the TPU kernel rounds it to the cache type (the normed
// rows, qM, the probabilities); see decode_step.cu for what K10 computes.
#include "decode_step.cuh"

int pdt_k10::run_f16(const StepArgs& a, cudaStream_t st) {
  return (int)run_step<__half>(a, st);
}
