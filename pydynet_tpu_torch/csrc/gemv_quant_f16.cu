// float16 rows of the weight-quantized matmuls (K5-K7): the row
// quantization and the decode kernel's instances that quantize float16
// rows themselves, compiled apart from the float32 and bfloat16 ones in
// gemv_quant.cu so that nvcc builds the two at once. A float16 row is
// widened to float32 exactly and then quantized by the same rule (amax
// over the row, IEEE 127 / amax, round half to even), so the int8 rows,
// their scales and the float32 results are the bits the plain version
// gives; the prefill kernel (K6, K7's prefill branch) takes the int8 rows
// quantize_rows_kernel makes, whatever their source type. See
// gemv_quant.cu for what the kernels compute.
#include "gemv_quant.cuh"

int pdt_gq::quantize_rows_f16(const void* x, void* xq, void* sx, int M,
                               int K, cudaStream_t st) {
  quantize_rows_kernel<__half><<<M, kQThreads, 0, st>>>(
      static_cast<const __half*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), K);
  return (int)cudaGetLastError();
}

int pdt_gq::decode_f16(bool q4, int mt, const DecodeArgs& a,
                        cudaStream_t st) {
  return (int)(q4 ? decode_mt<true, __half>(mt, a, st)
                  : decode_mt<false, __half>(mt, a, st));
}
