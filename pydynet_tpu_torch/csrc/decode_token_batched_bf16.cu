// bfloat16 instances of the batched decode step (K2): the chain of
// decode_token_batched.cuh for bfloat16 weights, compiled apart from the
// float32 ones in decode_token_batched.cu so that nvcc builds both halves at
// once. See decode_token_batched.cu for what K2 computes.
#include "decode_token_batched.cuh"

int pdt_k2::run_bf16(int lfmt, int hfmt, int kv8, const Args& a,
                     cudaStream_t st) {
  return (int)run_mode<__nv_bfloat16>(lfmt, hfmt, kv8, a, st);
}
