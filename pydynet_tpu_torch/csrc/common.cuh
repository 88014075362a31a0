// Device helpers shared by the decode kernels (decode_token.cu: K1, the
// B=1 step; decode_token_batched.cu: K2, the batched step). Everything here
// has internal linkage, so each kernel source is compiled on its own.
//
// Types: the residual stream is f32; every matmul input is rounded to the
// weight type T (f32 or bf16) and accumulated in f32; the caches are T. The
// int8 head accumulates exactly in int32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // ops/decode_step.py's _THREADS: the
                               // wrapper keeps head_dim <= kThreads
constexpr int kWarps = kThreads / 32;
constexpr int kHeadRowsPerWarp = 4;  // few, so ~1000 blocks keep the head's
                                     // row loads in flight on every SM
constexpr int kHeadRows = kWarps * kHeadRowsPerWarp;  // vocab rows per block
constexpr int kAttnRows = 64;  // cache rows per attention block
static_assert(kThreads % kAttnRows == 0 && kAttnRows == 64,
              "attention: one warp reduces the block's 64 scores");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ int warp_sum_i(int v) {
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

// (value, index) order of the greedy argmax: larger value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// x_s[i] = R(src[i] / sqrt(mean(src^2) + 1e-6) * w[i]) for i < D, where R
// rounds to the matmul input type (float: no rounding). Ends synchronised.
template <typename R, typename Src, typename W>
__device__ void load_normed(const Src* src, const W* w, int D, float* x_s,
                            float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float v = to_f(src[i]);
    x_s[i] = v;
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float den = sqrtf(ss / (float)D + 1e-6f);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    x_s[i] = round_to<R>(x_s[i] / den * to_f(w[i]));
  __syncthreads();
}

__device__ __forceinline__ int to_i(int8_t x) { return x; }

// One product of a weight and an activation: f32 for f32/bf16 weights, an
// exact int product for int8 weights (the activation then holds an integer)
template <typename Acc, typename W>
__device__ __forceinline__ Acc mul(W w, float x) {
  if constexpr (std::is_same<Acc, int>::value)
    return to_i(w) * (int)x;
  else
    return to_f(w) * x;
}

// Accumulate row[k] * x_s[k] over the lane's share of k < K: 16-byte loads
// of the row where it is 16-byte aligned, element loads for the rest.
// Acc is float (f32/bf16 rows) or int (int8 rows, x_s holding integers).
template <typename Acc, typename W>
__device__ __forceinline__ Acc lane_dot(const W* row, const float* x_s,
                                        int K) {
  constexpr int kVec = 16 / sizeof(W);
  const int lane = threadIdx.x & 31;
  Acc acc = 0;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const int nvec = K / kVec;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int v = lane; v < nvec; v += 32) {
      const uint4 u = rv[v];
      const W* e = reinterpret_cast<const W*>(&u);
      const float* xs = x_s + v * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc += mul<Acc>(e[i], xs[i]);
    }
    k0 = nvec * kVec;
  }
  for (int k = k0 + lane; k < K; k += 32) acc += mul<Acc>(row[k], x_s[k]);
  return acc;
}

// dot(row[0:K], x_s[0:K]) over one warp; every lane gets the sum
template <typename W>
__device__ __forceinline__ float warp_dot(const W* row, const float* x_s,
                                          int K) {
  return warp_sum(lane_dot<float>(row, x_s, K));
}

// One block per row: argmax over that row's n (max, index) tile pairs ->
// out[blockIdx.x]
__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ tile_val,
              const int* __restrict__ tile_idx, int n, int* __restrict__ out) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
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

int head_tiles(int vocab) { return (vocab + kHeadRows - 1) / kHeadRows; }
int attn_splits(int seq) { return (seq + kAttnRows - 1) / kAttnRows; }

#define PDT_CHECK()                          \
  do {                                       \
    cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return e_;        \
  } while (0)

}  // namespace
