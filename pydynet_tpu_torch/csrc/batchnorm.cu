// Train-mode BatchNorm over an (N, C) batch (K8): the port of the Pallas
// TPU kernel pydynet_tpu/ops/batchnorm.py:_bn_kernel.
//
// For each column c: mean = sum_n x / N, var = sum_n (x - mean)^2 / N (the
// biased variance, in two passes as the TPU kernel takes it, not Welford and
// not E[x^2] - E[x]^2), and out = (x - mean) * rsqrt(var + eps) * gamma +
// beta in x's type; mean and var are written as float32 (1, C). x and out
// are float32 or bfloat16, gamma and beta float32 or bfloat16 on their own;
// every sum is float32.
//
// Bound: bytes. The function reads x once and writes out once, 2 N C
// itemsize bytes over 3.35 TB/s; it does about 8 operations an element.
//
// Design. The TPU kernel holds the whole block in VMEM and reduces it in one
// grid step; on Hopper nothing carries across blocks, so each block owns 32
// columns (one warp wide: a warp reads 32 neighbouring values of a row) and
// all N rows of them. Its warps stride over the rows (up to 32 warps, fewer
// for a short batch). Pass 1 sums each lane's rows and reduces the warps'
// partial sums through shared memory in a fixed order, pass 2 does the same
// for the centred squares, pass 3 writes out. x is read three times; the
// second and third reads hit L2 at the trainers' shapes. At (40, 512) that
// is one launch of 16 blocks: latency, not bandwidth, is the cost. Wide
// batches of few columns put few blocks in flight; splitting N across
// blocks with a second reduction is later work.
#include "common.cuh"

namespace {

constexpr int kBnCols = 32;     // columns a block, one per lane
constexpr int kBnMaxWarps = 32; // 1024 threads

template <typename TX, typename TP>
__global__ void __launch_bounds__(kBnCols * kBnMaxWarps)
bn_train_kernel(const TX* __restrict__ x, const TP* __restrict__ gamma,
                const TP* __restrict__ beta, TX* __restrict__ out,
                float* __restrict__ mean_out, float* __restrict__ var_out,
                int N, int C, float eps) {
  __shared__ float red[kBnMaxWarps][kBnCols + 1];
  __shared__ float stat[2][kBnCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int col = blockIdx.x * kBnCols + lane;
  const bool live = col < C;
  const size_t stride = (size_t)C;
  const TX* xc = x + col;

  // pass 1: the column sums, then the mean
  float s = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = warp; r < N; r += warps) s += to_f(xc[r * stride]);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[w][lane];
    stat[0][lane] = t / (float)N;
  }
  __syncthreads();
  const float mu = stat[0][lane];

  // pass 2: the centred squares, then the biased variance (warp 0 finished
  // reading red before the barrier above, so red is free again)
  float q = 0.f;
  if (live) {
#pragma unroll 4
    for (int r = warp; r < N; r += warps) {
      const float c = to_f(xc[r * stride]) - mu;
      q += c * c;
    }
  }
  red[warp][lane] = q;
  __syncthreads();
  if (warp == 0) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[w][lane];
    stat[1][lane] = t / (float)N;
  }
  __syncthreads();
  if (!live) return;
  const float var = stat[1][lane];

  // pass 3: out = centred * rstd * gamma + beta, and the statistics
  const float rstd = rsqrtf(var + eps);
  const float g = to_f(gamma[col]);
  const float b = to_f(beta[col]);
  if (warp == 0) {
    mean_out[col] = mu;
    var_out[col] = var;
  }
  TX* oc = out + col;
#pragma unroll 4
  for (int r = warp; r < N; r += warps)
    oc[r * stride] = from_f<TX>((to_f(xc[r * stride]) - mu) * rstd * g + b);
}

template <typename TX, typename TP>
cudaError_t bn_train(const void* x, const void* gamma, const void* beta,
                     void* out, void* mean, void* var, int N, int C,
                     float eps, cudaStream_t st) {
  // about four rows a warp, at least one warp and at most kBnMaxWarps
  const int warps = N >= 4 * kBnMaxWarps ? kBnMaxWarps : (N + 3) / 4;
  bn_train_kernel<TX, TP><<<(C + kBnCols - 1) / kBnCols, 32 * warps, 0,
                            st>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(gamma),
      static_cast<const TP*>(beta), static_cast<TX*>(out),
      static_cast<float*>(mean), static_cast<float*>(var), N, C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype (x and out) and p_dtype (gamma and beta): 0 float32, 1 bfloat16.
// x and out are (N, C) contiguous, gamma and beta (C), mean and var (C)
// float32. Returns the CUDA error of the launch, or cudaSuccess, and
// cudaErrorInvalidValue for a shape or type the kernel does not take.
int pdt_batch_norm_train(int x_dtype, int p_dtype, const void* x,
                         const void* gamma, const void* beta, void* out,
                         void* mean, void* var, int N, int C, float eps,
                         void* stream) {
  if (N < 1 || C < 1 || x_dtype < 0 || x_dtype > 1 || p_dtype < 0 ||
      p_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return bn_train<float, float>(x, gamma, beta, out, mean, var, N, C, eps,
                                  st);
  if (x_dtype == 0)
    return bn_train<float, __nv_bfloat16>(x, gamma, beta, out, mean, var, N,
                                          C, eps, st);
  if (p_dtype == 0)
    return bn_train<__nv_bfloat16, float>(x, gamma, beta, out, mean, var, N,
                                          C, eps, st);
  return bn_train<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, out, mean,
                                                var, N, C, eps, st);
}

}  // extern "C"
