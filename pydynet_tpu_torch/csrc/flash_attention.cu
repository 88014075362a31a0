// Causal flash attention on NVIDIA Hopper (sm_90a): the forward (K3) and
// the two halves of its backward, dq and dk/dv (K4).
//
// Replaces the Pallas TPU kernels of pydynet_tpu/ops/flash_attention.py:
//   * `_fa_kernel` (:82, launched by `_fa_forward` :154 at :159): causal
//     attention with an online softmax; writes o and the row log-sum-exp;
//   * `_fa_bwd_dq_kernel` (:192, launched by `_fa_backward` :331 at :348):
//     recompute p = exp(s - lse) per key tile, ds = p * (dO V^T - dd),
//     dq = ds K * scale, over the key tiles up to the diagonal;
//   * `_fa_bwd_dkv_kernel` (:259, launched at :363): dk = ds^T Q * scale and
//     dv = p^T dO for one key tile, over the query tiles from the diagonal
//     on, reading lse and dd per query tile.
// dd = rowsum(dO * O) is computed outside the kernels, as the JAX package
// does (:335). Nothing needs atomics: every output row belongs to one block.
//
// The TPU layout tricks are gone: no 128-lane padding of head_dim (the
// kernels read d = 48 as it is), no VMEM block budget, no double-buffered
// DMA semaphores, and no `_tiles` fallback to a dense composite: the last
// tile is masked, so any L >= 1 runs. Tensors keep the public (B, L, H, d)
// layout (the block for head (b, h) reads rows with a stride of H * d), so
// the wrapper transposes nothing; lse and dd are (B * H, L) float32.
//
// Types: q, k, v, o, dO and the gradients are T (float32 or bfloat16); every
// tile is widened to float32 in shared memory and all arithmetic is float32,
// as in the TPU kernels (`preferred_element_type=jnp.float32`). The forward
// scales q once when it loads it (as `_fa_kernel` does); the backward scales
// s, and dq and dk again at the end (as the TPU's backward kernels do).
//
// What bounds them on an H100: at stories15M's shapes (B * H = 6 to 48
// heads, L = 1024, d = 48) a head's q, k and v are 3 x 196 KB in float32, so
// the traffic is small and the kernels are bound by the float32 FMAs and the
// shared-memory reads that feed them (about L^2 / 2 x d x 2 FMAs a head for
// the forward, twice that for each backward kernel). The design keeps every
// operand of the inner products in shared memory, computes a 4 x 4 (or
// 4 x 2) register tile of scores per thread so each shared load feeds
// several FMAs, keeps the 16 threads that share a row in one half-warp so
// the softmax needs only shuffles, and pads the shared row stride to an odd
// number of floats so the 16 rows a half-warp reads fall in 16 banks. The
// tensor cores (wgmma) and TMA are left for a later change.
//
// Blocks are 256 threads, seen as 16 x 16: thread (ty, tx) owns the query
// rows ty * RQ + i of a tile and the key columns tx + 16 * j, and in the
// accumulations the output columns tx + 16 * c (c < NC, d <= 16 * NC).

#include "common.cuh"

namespace {

constexpr int kFaThreads = 256;
constexpr int kFwdQ = 64, kFwdK = 64;  // forward: query rows a block, key
                                       // rows a tile
constexpr int kBwdQ = 64, kBwdK = 32;  // backward: 32 key rows keep the
                                       // dk/dv kernel's two accumulators in
                                       // registers and its tiles within
                                       // 227 KB at d = 256
constexpr int kMaxHeadDim = 256;

// floats of dynamic shared memory each kernel takes for head_dim d
int fwd_smem_floats(int d) {
  return (kFwdQ + 2 * kFwdK) * (d | 1) + kFwdQ * (kFwdK + 1);
}
int dq_smem_floats(int d) {
  return (2 * kBwdQ + 2 * kBwdK) * (d | 1) + kBwdQ * (kBwdK + 1);
}
int dkv_smem_floats(int d) {
  return (2 * kBwdQ + 2 * kBwdK) * (d | 1) + 2 * kBwdQ * (kBwdK + 1);
}

// Rows [row0, row0 + rows) of one head of a (B, L, H, d) tensor into shared
// memory as float32 times `mul`, `st` floats a row; rows at or past L are 0.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, size_t base,
                          size_t rs, int row0, int rows, int L, int d, int st,
                          float mul) {
  for (int i = threadIdx.x; i < rows * d; i += kFaThreads) {
    const int r = i / d, c = i - r * d;
    const int row = row0 + r;
    dst[r * st + c] =
        row < L ? to_f(src[base + (size_t)row * rs + c]) * mul : 0.f;
  }
}

// s[i][j] = a[ty * RQ + i] . b[tx + 16 * j] over d features
template <int RQ, int RK>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int st, int d, int ty, int tx,
                                         float (&s)[RQ][RK]) {
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
  for (int c = 0; c < d; ++c) {
    float av[RQ], bv[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) av[i] = a[(ty * RQ + i) * st + c];
#pragma unroll
    for (int j = 0; j < RK; ++j) bv[j] = b[(tx + 16 * j) * st + c];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// reductions over the 16 lanes of a half-warp (the threads sharing a row)
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward: one block per (64-row query tile, b * H + h). Key/value tiles of
// 64 rows are staged in shared memory; the online softmax state (m, l) and
// the output rows stay in registers.
template <typename T, int NC>
__global__ void __launch_bounds__(kFaThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int L, int H, int d, float scale) {
  constexpr int BQ = kFwdQ, BK = kFwdK, RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int st = d | 1;
  float* qs = smem;            // BQ x st, q * scale
  float* ks = qs + BQ * st;    // BK x st
  float* vs = ks + BK * st;    // BK x st
  float* ps = vs + BK * st;    // BQ x (BK + 1), this tile's probabilities
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows(qs, q, base, rs, q0, BQ, L, d, st, scale);

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // key tiles covering [0, min(q0 + BQ, L)): the causal bound of the last
  // query row of this tile, whatever the ratio of the two tile sizes
  const int n_tiles = (min(q0 + BQ, L) + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    load_rows(ks, k, base, rs, k0, BK, L, d, st, 1.f);
    load_rows(vs, v, base, rs, k0, BK, L, d, st, 1.f);
    __syncthreads();
    float s[RQ][RK];
    tile_dot<RQ, RK>(qs, ks, st, d, ty, tx, s);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, row = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col > row || col >= L) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - shift);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - shift);
        ps[r * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + half_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // a row's probabilities come from its own half-warp
    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < d ? vs[j * st + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = ps[(ty * RQ + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        o[base + (size_t)row * rs + col] = from_f<T>(acc[i][c] / l[i]);
    }
    if (tx == 0) lse[(size_t)bh * L + row] = m[i] + logf(l[i]);
  }
}

// dq: one block per (64-row query tile, b * H + h), over the 32-row key
// tiles up to the diagonal.
template <typename T, int NC>
__global__ void __launch_bounds__(kFaThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 T* __restrict__ dq, int L, int H, int d, float scale) {
  constexpr int BQ = kBwdQ, BK = kBwdK, RQ = BQ / 16, RK = BK / 16;
  extern __shared__ float smem[];
  const int st = d | 1;
  float* qs = smem;             // BQ x st
  float* dos = qs + BQ * st;    // BQ x st
  float* ks = dos + BQ * st;    // BK x st
  float* vs = ks + BK * st;     // BK x st
  float* dss = vs + BK * st;    // BQ x (BK + 1), this tile's ds
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows(qs, q, base, rs, q0, BQ, L, d, st, 1.f);
  load_rows(dos, dout, base, rs, q0, BQ, L, d, st, 1.f);
  float lse_r[RQ], dd_r[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    lse_r[i] = row < L ? lse[(size_t)bh * L + row] : 0.f;
    dd_r[i] = row < L ? dd[(size_t)bh * L + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const int n_tiles = (min(q0 + BQ, L) + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_rows(ks, k, base, rs, k0, BK, L, d, st, 1.f);
    load_rows(vs, v, base, rs, k0, BK, L, d, st, 1.f);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    tile_dot<RQ, RK>(qs, ks, st, d, ty, tx, s);
    tile_dot<RQ, RK>(dos, vs, st, d, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (col <= row && row < L)
                            ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - dd_r[i]);
      }
    }
    __syncwarp();  // a row's ds comes from its own half-warp
    for (int j = 0; j < BK; ++j) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < d ? ks[j * st + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = dss[(ty * RQ + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d)
        dq[base + (size_t)row * rs + col] = from_f<T>(acc[i][c] * scale);
    }
  }
}

// dk and dv: one block per (32-row key tile, b * H + h), over the 64-row
// query tiles from the one holding the tile's first key row to the end.
// Scores are (query row, key column) as in the other kernels; the
// accumulation then gives thread (ty, tx) the key rows ty * RA + a.
template <typename T, int NC>
__global__ void __launch_bounds__(kFaThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dd,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H, int d,
                  float scale) {
  constexpr int BQ = kBwdQ, BK = kBwdK, RQ = BQ / 16, RK = BK / 16;
  constexpr int RA = BK / 16;  // key rows a thread accumulates
  extern __shared__ float smem[];
  const int st = d | 1;
  float* ks = smem;             // BK x st
  float* vs = ks + BK * st;     // BK x st
  float* qs = vs + BK * st;     // BQ x st
  float* dos = qs + BQ * st;    // BQ x st
  float* ps = dos + BQ * st;    // BQ x (BK + 1)
  float* dss = ps + BQ * (BK + 1);
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows(ks, k, base, rs, k0, BK, L, d, st, 1.f);
  load_rows(vs, v, base, rs, k0, BK, L, d, st, 1.f);
  float adk[RA][NC], adv[RA][NC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[a][c] = adv[a][c] = 0.f;
  // only query rows >= k0 see this tile: start at the query tile holding
  // row k0, whatever the ratio of the two tile sizes
  const int n_tiles = (L + BQ - 1) / BQ;
  for (int t = k0 / BQ; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();
    load_rows(qs, q, base, rs, q0, BQ, L, d, st, 1.f);
    load_rows(dos, dout, base, rs, q0, BQ, L, d, st, 1.f);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    tile_dot<RQ, RK>(qs, ks, st, d, ty, tx, s);
    tile_dot<RQ, RK>(dos, vs, st, d, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, row = q0 + r;
      const bool in = row < L;
      const float lse_i = in ? lse[(size_t)bh * L + row] : 0.f;
      const float dd_i = in ? dd[(size_t)bh * L + row] : 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (col <= row && in && col < L)
                            ? expf(s[i][j] * scale - lse_i) : 0.f;
        ps[r * (BK + 1) + tx + 16 * j] = p;
        dss[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - dd_i);
      }
    }
    __syncthreads();  // the accumulation reads every row of ps and dss
    const int rows = min(BQ, L - q0);
    for (int r = 0; r < rows; ++r) {
      float qv[NC], dov[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        qv[c] = col < d ? qs[r * st + col] : 0.f;
        dov[c] = col < d ? dos[r * st + col] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const float p = ps[r * (BK + 1) + ty * RA + a];
        const float ds = dss[r * (BK + 1) + ty * RA + a];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[a][c] = fmaf(p, dov[c], adv[a][c]);
          adk[a][c] = fmaf(ds, qv[c], adk[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = k0 + ty * RA + a;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dk[base + (size_t)row * rs + col] = from_f<T>(adk[a][c] * scale);
        dv[base + (size_t)row * rs + col] = from_f<T>(adv[a][c]);
      }
    }
  }
}

// Let `kernel` take `floats` of dynamic shared memory (opting in above the
// 48 KB a block gets by default) and launch it on `st`.
template <typename K, typename... Args>
cudaError_t launch(K* kernel, dim3 grid, int floats, cudaStream_t st,
                   Args... args) {
  const size_t bytes = (size_t)floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kFaThreads, bytes, st>>>(args...);
  return cudaGetLastError();
}

bool bad_shape(int B, int L, int H, int d) {
  return B < 1 || L < 1 || H < 1 || d < 1 || d > kMaxHeadDim ||
         (long long)B * H > 65535;
}

template <typename T, int NC>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int L, int H, int d, float scale,
                cudaStream_t st) {
  return launch(fa_fwd_kernel<T, NC>, dim3((L + kFwdQ - 1) / kFwdQ, B * H),
                fwd_smem_floats(d), st, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), L, H, d, scale);
}

template <typename T, int NC>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dq, int B, int L, int H, int d, float scale,
                   cudaStream_t st) {
  return launch(fa_bwd_dq_kernel<T, NC>,
                dim3((L + kBwdQ - 1) / kBwdQ, B * H), dq_smem_floats(d), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(dd),
                static_cast<T*>(dq), L, H, d, scale);
}

template <typename T, int NC>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dd,
                    void* dk, void* dv, int B, int L, int H, int d,
                    float scale, cudaStream_t st) {
  return launch(fa_bwd_dkv_kernel<T, NC>,
                dim3((L + kBwdK - 1) / kBwdK, B * H), dkv_smem_floats(d), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout),
                static_cast<const float*>(lse), static_cast<const float*>(dd),
                static_cast<T*>(dk), static_cast<T*>(dv), L, H, d, scale);
}

// the smallest register tile of output columns (16 * NC) that holds d
#define PDT_FA_DISPATCH(fn, ...)                                        \
  do {                                                                  \
    if (dtype == 0) {                                                   \
      if (d <= 64) return fn<float, 4>(__VA_ARGS__);                    \
      if (d <= 128) return fn<float, 8>(__VA_ARGS__);                   \
      return fn<float, 16>(__VA_ARGS__);                                \
    }                                                                   \
    if (dtype == 1) {                                                   \
      if (d <= 64) return fn<__nv_bfloat16, 4>(__VA_ARGS__);            \
      if (d <= 128) return fn<__nv_bfloat16, 8>(__VA_ARGS__);           \
      return fn<__nv_bfloat16, 16>(__VA_ARGS__);                        \
    }                                                                   \
    return cudaErrorInvalidValue;                                       \
  } while (0)

}  // namespace

extern "C" {

// dtype 0: float32 q, k, v, o (and dO and the gradients), 1: bfloat16.
// Tensors are (B, L, H, d) contiguous; lse and dd are (B * H, L) float32.
// Each returns the CUDA error of its launch, or cudaSuccess, and
// cudaErrorInvalidValue for a shape or type the kernels do not take.
int pdt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                  void* o, void* lse, int B, int L, int H, int d, float scale,
                  void* stream) {
  if (bad_shape(B, L, H, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PDT_FA_DISPATCH(fwd, q, k, v, o, lse, B, L, H, d, scale, st);
}

int pdt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dd,
                     void* dq, int B, int L, int H, int d, float scale,
                     void* stream) {
  if (bad_shape(B, L, H, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PDT_FA_DISPATCH(bwd_dq, q, k, v, dout, lse, dd, dq, B, L, H, d, scale, st);
}

int pdt_flash_bwd_dkv(int dtype, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* dd, void* dk, void* dv, int B, int L, int H,
                      int d, float scale, void* stream) {
  if (bad_shape(B, L, H, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PDT_FA_DISPATCH(bwd_dkv, q, k, v, dout, lse, dd, dk, dv, B, L, H, d, scale,
                  st);
}

}  // extern "C"
