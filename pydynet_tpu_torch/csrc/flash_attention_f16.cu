// float16 instances of the causal flash-attention kernels (K3, K4), compiled
// apart from the float32 and bfloat16 ones in flash_attention.cu so that
// nvcc builds the two at once. float16 takes bfloat16's route: its tiles
// are stored in 2-byte elements, and each element is exact in TF32, so q
// k^T and dO v^T are one TF32 product a k step and the products with p and
// ds (kept float32) two; o and the gradients are rounded to float16 once,
// at the end. See flash_attention.cu for what the kernels compute.
#include "flash_attention.cuh"

int pdt_fa::fwd_f16(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int L, int H, int d, float scale,
                    cudaStream_t st) {
  PDT_FA_BY_DIM(__half, fwd, q, k, v, o, lse, B, L, H, d, scale, st);
}

int pdt_fa::bwd_dq_f16(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dd,
                       void* dq, int B, int L, int H, int d, float scale,
                       cudaStream_t st) {
  PDT_FA_BY_DIM(__half, bwd_dq, q, k, v, dout, lse, dd, dq, B, L, H, d,
                scale, st);
}

int pdt_fa::bwd_dkv_f16(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* dd,
                        void* dk, void* dv, int B, int L, int H, int d,
                        float scale, cudaStream_t st) {
  PDT_FA_BY_DIM(__half, bwd_dkv, q, k, v, dout, lse, dd, dk, dv, B, L, H, d,
                scale, st);
}
