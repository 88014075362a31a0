// float16 instances of the batched decode step (K2): the chain of
// decode_token_batched.cuh for float16 weights and caches, compiled apart
// from the float32 and bfloat16 ones so that nvcc builds the three at once.
// The products are float16 m16n8k16 with float32 sums (each row rounded to
// float16 first, as the TPU kernel rounds it to the weights' type); the
// residual stream, the softmax and the sums stay float32, and the caches
// are float16 (or the int8 KV cache). See decode_token_batched.cu for what
// K2 computes.
#include "decode_token_batched.cuh"

int pdt_k2::run_f16(int lfmt, int hfmt, int kv8, const Args& a,
                    cudaStream_t st) {
  return (int)run_mode<__half>(lfmt, hfmt, kv8, a, st);
}
