// Device helpers shared by the kernel sources (decode_token.cu: K1, the
// B=1 step, and K9, the greedy head;
// decode_token_batched.cu: K2, the batched step; decode_step.cu: K10, the
// layers-only step, on K2's stages; gemv_quant.cu: K5-K7;
// flash_attention.cu: K3/K4; batchnorm.cu: K8). Everything here has
// internal linkage, so each kernel source is compiled on its own.
//
// Types: the residual stream is f32; every matmul input is rounded to the
// weight type T (f32, bf16 or f16) and accumulated in f32; the caches are T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // ops/decode_step.py's _THREADS: the
                               // wrapper keeps head_dim <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr int kAttnRows = 64;  // cache rows per attention block
static_assert(kThreads % kAttnRows == 0 && kAttnRows == 64,
              "attention: one warp reduces the block's 64 scores");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back: "the matmul input is cast to T"
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result. `red` holds kWarps
// floats of shared memory; the leading barrier guards its previous use.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, red[i]);
  return t;
}

// Programmatic dependent launch (sm_90): a kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start while the
// kernel before it in the stream still runs. pdl_wait() blocks until that
// kernel has completed and its writes are visible; pdl_launch() lets the
// next such kernel start. Both are no-ops for a kernel launched without
// the attribute or with no such kernel after it.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// (value, index) order of the greedy argmax: larger value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// the signed low and high nibbles of each byte of p, as int8 bytes
__device__ __forceinline__ unsigned nibbles_lo(unsigned p) {
  return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned nibbles_hi(unsigned p) {
  return __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// Weight formats of a matmul (ops/decode_step.py's _FMT): rows of the
// weight type T, int8 rows, or int4 rows packed two a byte; the quantized
// ones carry a float32 scale per output row.
constexpr int kFmtFloat = 0, kFmtInt8 = 1, kFmtInt4 = 2;

// bytes of n weights of format Q
template <int Q, typename T>
__host__ __device__ __forceinline__ size_t fmt_bytes(size_t n) {
  return Q == kFmtFloat ? n * sizeof(T) : (Q == kFmtInt8 ? n : n / 2);
}

// layer l's matrix of `rows_cols` weights of format Q, and its scales
template <int Q, typename T>
const void* layer_w(const void* w, int l, size_t rows_cols) {
  return static_cast<const char*>(w) + l * fmt_bytes<Q, T>(rows_cols);
}
inline const float* layer_s(const float* s, int l, int rows) {
  return s == nullptr ? nullptr : s + (size_t)l * rows;
}

// One block per row: argmax over that row's n (max, index) tile pairs ->
// out[blockIdx.x]
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ tile_val,
              const int* __restrict__ tile_idx, int n, int* __restrict__ out) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  pdl_wait();  // K9 launches it programmatically dependent on its head
  tile_val += (size_t)blockIdx.x * n;
  tile_idx += (size_t)blockIdx.x * n;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int t = threadIdx.x; t < n; t += blockDim.x)
    if (better(tile_val[t], tile_idx[t], bv, bi)) {
      bv = tile_val[t];
      bi = tile_idx[t];
    }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    wv[threadIdx.x >> 5] = bv;
    wi[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w)
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    out[blockIdx.x] = bi == INT_MAX ? 0 : bi;
  }
}

// ---- tensor-core fragments (mma.sync; gemv_quant.cu, flash_attention.cu,
// head.cuh) ----

// Four 8 x 8 matrices of 16-bit elements (8 rows of 16 bytes each) from
// shared memory, lane l passing the address of row l & 7 of matrix l >> 3:
// the A fragment of a 16 x 32-byte tile when lane l passes row l & 15,
// byte 16 (l >> 4)
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr) : "memory");
}

// c += a (16 x 32 int8, row-major) * b (32 x 8 int8, K-major), exact int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8 x 8 matrices of 16-bit elements, lanes 0-15 passing the addresses
// of their rows: the B fragment (b0, b1) of a 32-byte x 8 K-major tile when
// lane l passes row l & 7, byte 16 ((l >> 3) & 1)
__device__ __forceinline__ void ldmatrix_x2(unsigned addr, unsigned (&b)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr) : "memory");
}

// c += a (16 x 16 T, row-major) * b (16 x 8 T, K-major), float32
// accumulators, T bfloat16 or float16 (the same fragments; every product of
// two 16-bit values is exact in float32)
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, __half>::value,
                "mma16: bfloat16 or float16 operands");
  if constexpr (std::is_same<T, __half>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The pair (lo, hi) rounded to T (bfloat16 or float16) as the 32 bits of an
// mma operand, lo in the low half
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const T v[2] = {from_f<T>(lo), from_f<T>(hi)};
  unsigned u;
  memcpy(&u, v, sizeof(u));
  return u;
}

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as `cvt.rna.tf32.f32` rounds it, in two integer operations (the
// conversion instruction costs more): half a unit of the last kept bit
// added to the magnitude's bits, the 13 bits below it cleared
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (LO), or hi = x exactly (a widened bfloat16 or
// float16, which TF32 holds: lo = 0 and its products are skipped)
template <bool LO, int N>
__device__ __forceinline__ void split(const float (&x)[N], unsigned (&hi)[N],
                                      unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = LO ? tf32_rna(x[i]) : __float_as_uint(x[i]);
    lo[i] = LO ? tf32_rna(x[i] - __uint_as_float(hi[i])) : 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at float32 accuracy (3xTF32): a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small terms first; a_lo b_lo (2^-22 relative) is dropped
template <bool ALO, bool BLO>
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  if constexpr (ALO) mma_tf32(c, al, bh);
  if constexpr (BLO) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

int attn_splits(int seq) { return (seq + kAttnRows - 1) / kAttnRows; }

// Launch `kern` in a chain: programmatically dependent on the kernel
// before it (it may start while that one runs, and waits for it in
// pdl_wait), in clusters of `cluster` blocks when cluster > 0
template <typename... Params, typename... Args>
cudaError_t chain_launch(void (*kern)(Params...), dim3 grid, int threads,
                         size_t smem, cudaStream_t st, int cluster,
                         Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 0 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<Params>(args)...);
}

#define PDT_CHECK()                          \
  do {                                       \
    cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

// Asynchronous copies to shared memory (cp.async; gemv_quant.cu,
// flash_attention.cu)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` of 16 (or 4) from src to shared dst, the rest zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
