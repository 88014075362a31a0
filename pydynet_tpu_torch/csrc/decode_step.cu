// The layers-only B=1 decode step on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (pydynet_tpu/ops/decode_step.py:
// 1575, launched by `fused_decode_step` at :1657 -> :1721; K10), the older
// step that starts from a given hidden state h0 and has no embedding and no
// head. Per layer: RMSNorm; q/k/v; RoPE as q*cos + (q @ rot)*sin with the
// GIVEN (D, D) rot and (D,) cos/sin, in f32; the K/V row write at
// min(pos, S - 1); a plain softmax over all S cache rows with the rows
// after pos masked, the per-head scores coming from ck @ qM where
// qM = (q x hmask) rounded to the cache type, hmask (D, H) as given; the
// probabilities rounded to the cache type and expanded to D features by
// hmask^T (rounded too), att = sum_s p_exp * cv; wo + residual; RMSNorm;
// SwiGLU + residual. It returns the final-RMSNormed h (f32). Unlike K1's
// online softmax over row blocks, this keeps the TPU kernel's order of
// rounding: a bf16 step rounds p itself, as there.
//
// One step is a chain of 8 * n_layers + 1 launches:
//   1. RMSNorm + q/k/v GEMV (a warp per output row; v goes to the cache),
//   2. RoPE of q and k through rot (a thread per output feature, the rot
//      column read by neighbouring threads as contiguous bytes); k goes to
//      the cache, q becomes qM^T (H, D),
//   3. scores of rows [0, pos] (a warp per row, H dots of D),
//   4. the softmax of each head over the rows (a block per head),
//   5. p_exp @ V over (64-column, 64-row) blocks of the cache, partial sums
//      per row block,
//   6. the sum of those partials + wo GEMV + residual,
//   7. RMSNorm + gate/up + SiLU * up, 8. down + residual (K1's FFN stages,
//      common.cuh),
// and 9. the final RMSNorm. Rows after pos get probability 0 exactly in
// the TPU kernel, so their scores and values are not read here: the result
// is the same for any finite cache contents.
//
// What bounds it on an H100: at stories15M width (6 layers, D 288, F 768,
// S 1024) a bf16 step at pos 1023 reads about 4 MB of weights and up to
// 7 MB of KV, about 3 us at 3.35 TB/s, against 49 launches of a few us
// each: latency. The design keeps each launch simple; it is the reference
// semantics on the card, not a fast path.

#include "common.cuh"

namespace {

constexpr int kCols = 64;      // cache columns of a p @ V block
constexpr int kPvGroups = kThreads / kCols;
constexpr int kMaxHeads = 64;  // ops/decode_step.py's step_kernel_takes

__device__ __forceinline__ int clamp_pos(const int* pos_p, int S) {
  return min(max(*pos_p, 0), S - 1);
}

// 1. RMSNorm + q/k/v. Layer 0 reads h0 (block 0 copies it into h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_qkv_kernel(const int* __restrict__ pos_p, const float* __restrict__ h0,
                int first, float* __restrict__ h,
                const T* __restrict__ in_norm, const T* __restrict__ wq,
                const T* __restrict__ wk, const T* __restrict__ wv,
                float* __restrict__ qk, T* __restrict__ cv, int D, int S) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  const int pos = clamp_pos(pos_p, S);
  if (first) {
    load_normed<T>(h0, in_norm, D, x_s, red);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < D; i += blockDim.x) h[i] = h0[i];
  } else {
    load_normed<T>(h, in_norm, D, x_s, red);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * kWarps + warp; r < 3 * D;
       r += gridDim.x * kWarps) {
    const int which = r / D, j = r - which * D;  // 0 q, 1 k, 2 v
    const T* w = which == 0 ? wq : (which == 1 ? wk : wv);
    const float a = warp_dot(w + (size_t)j * D, x_s, D);
    if (lane == 0) {
      if (which < 2)
        qk[which * D + j] = a;
      else
        cv[(size_t)pos * D + j] = from_f<T>(a);
    }
  }
}

// 2. RoPE: x[j] * cos[j] + (x @ rot)[j] * sin[j] for q and k. Block b owns
// the 32 columns [32 b, 32 b + 32): lane l column 32 b + l, warp w the rows
// i = w, w + 8, ... of rot, so a warp reads 128 contiguous bytes of a rot
// row; the 8 partial sums meet in shared memory in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_rope_kernel(const int* __restrict__ pos_p, const float* __restrict__ qk,
                 const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t,
                 const float* __restrict__ rot,
                 const float* __restrict__ hmask, float* __restrict__ qmt,
                 T* __restrict__ ck, int D, int H, int S) {
  extern __shared__ float smem[];
  float* x_s = smem;               // q, k: 2 D
  float* part = smem + 2 * D;      // [2][kWarps][32]
  const int pos = clamp_pos(pos_p, S);
  for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) x_s[i] = qk[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  float sq = 0.f, sk = 0.f;
  if (j < D)
    for (int i = warp; i < D; i += kWarps) {
      const float r = rot[(size_t)i * D + j];
      sq += x_s[i] * r;
      sk += x_s[D + i] * r;
    }
  part[warp * 32 + lane] = sq;
  part[(kWarps + warp) * 32 + lane] = sk;
  __syncthreads();
  if (warp == 0 && j < D) {
    float rq = 0.f, rk = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      rq += part[w * 32 + lane];
      rk += part[(kWarps + w) * 32 + lane];
    }
    const float c = cos_t[j], s = sin_t[j];
    const float q = x_s[j] * c + rq * s;
    const float k = x_s[D + j] * c + rk * s;
    ck[(size_t)pos * D + j] = from_f<T>(k);
    for (int hh = 0; hh < H; ++hh)  // qM^T: the scores' matmul input
      qmt[(size_t)hh * D + j] = round_to<T>(q * hmask[(size_t)j * H + hh]);
  }
}

// 3. scores[s, h] = dot(ck[s], qM^T[h]) * scale for rows s <= pos, a warp a
// row
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_scores_kernel(const int* __restrict__ pos_p, const T* __restrict__ ck,
                   const float* __restrict__ qmt, float* __restrict__ scores,
                   int D, int H, int S, float scale) {
  const int n = clamp_pos(pos_p, S) + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= n) return;
  const T* row = ck + (size_t)s * D;
  for (int hh = 0; hh < H; ++hh) {
    const float v = warp_dot(row, qmt + (size_t)hh * D, D);
    if (lane == 0) scores[(size_t)s * H + hh] = v * scale;
  }
}

// 4. p[s, h] = softmax over s of scores[:, h] (exp(x - max) / sum), rounded
// to T; one block a head; rows after pos are -inf there, 0 here, unread
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_softmax_kernel(const int* __restrict__ pos_p, float* __restrict__ sp,
                    int H, int S) {
  __shared__ float red[kWarps];
  const int n = clamp_pos(pos_p, S) + 1, hh = blockIdx.x;
  float m = -INFINITY;
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    m = fmaxf(m, sp[(size_t)s * H + hh]);
  m = block_max(m, red);
  float l = 0.f;
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float e = expf(sp[(size_t)s * H + hh] - m);
    sp[(size_t)s * H + hh] = e;
    l += e;
  }
  l = block_sum(l, red);
  for (int s = threadIdx.x; s < n; s += blockDim.x)
    sp[(size_t)s * H + hh] = round_to<T>(sp[(size_t)s * H + hh] / l);
}

// 5. att partials: block (x, y) sums rows [64 y, 64 y + 64) of
// p_exp[s, d] * cv[s, d] for the 64 columns d of block x, where
// p_exp[s, d] = sum_h p[s, h] * T(hmask[d, h]); threads split as (column
// c, row group g)
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_pv_kernel(const int* __restrict__ pos_p, const float* __restrict__ p,
               const float* __restrict__ hmask, const T* __restrict__ cv,
               float* __restrict__ att_part, int D, int H, int S) {
  __shared__ float p_s[kAttnRows * kMaxHeads];
  __shared__ float hm_s[kCols * kMaxHeads];
  __shared__ float part[kThreads];
  const int n = clamp_pos(pos_p, S) + 1;
  const int r0 = blockIdx.y * kAttnRows;
  if (r0 >= n) return;
  const int len = min(kAttnRows, n - r0);
  const int c0 = blockIdx.x * kCols;
  for (int i = threadIdx.x; i < len * H; i += blockDim.x)
    p_s[i] = p[(size_t)r0 * H + i];
  for (int i = threadIdx.x; i < kCols * H; i += blockDim.x) {
    const int c = i / H, hh = i - c * H;
    hm_s[i] = c0 + c < D ? round_to<T>(hmask[(size_t)(c0 + c) * H + hh])
                         : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % kCols, g = threadIdx.x / kCols;
  const int d = c0 + c;
  float acc = 0.f;
  if (d < D)
    for (int r = g; r < len; r += kPvGroups) {
      float pe = 0.f;
      for (int hh = 0; hh < H; ++hh) pe += p_s[r * H + hh] * hm_s[c * H + hh];
      acc += pe * to_f(cv[(size_t)(r0 + r) * D + d]);
    }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && d < D) {
    float t = 0.f;
    for (int gg = 0; gg < kPvGroups; ++gg) t += part[gg * kCols + c];
    att_part[(size_t)blockIdx.y * D + d] = t;
  }
}

// 6. att = the sum of the row blocks' partials, rounded to T, then wo GEMV
// + residual
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_wo_kernel(const int* __restrict__ pos_p,
               const float* __restrict__ att_part, const T* __restrict__ wo,
               float* __restrict__ h, int D, int S) {
  extern __shared__ float x_s[];
  const int n = clamp_pos(pos_p, S) + 1;
  const int used = (n + kAttnRows - 1) / kAttnRows;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float t = 0.f;
    for (int s = 0; s < used; ++s) t += att_part[(size_t)s * D + i];
    x_s[i] = round_to<T>(t);
  }
  __syncthreads();
  gemv_residual<T>(x_s, D, wo, h, D);
}

// 9. h_out = RMSNorm(h) * final_norm in f32, one block
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_final_norm_kernel(const float* __restrict__ h,
                       const T* __restrict__ final_norm,
                       float* __restrict__ h_out, int D) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  load_normed<float>(h, final_norm, D, x_s, red);
  for (int i = threadIdx.x; i < D; i += blockDim.x) h_out[i] = x_s[i];
}

struct StepArgs {
  const int* pos;
  const float *h0, *cos, *sin, *rot, *hmask;
  const void *final_norm, *wq, *wk, *wv, *wo, *gate_w, *up_w, *down_w;
  const void *in_norm, *post_norm;
  void *ck, *cv;
  float *h_out, *scratch;
  int N, D, H, F, S;
  float scale;
};

template <typename T>
cudaError_t run_step(const StepArgs& a, cudaStream_t st) {
  const int D = a.D, F = a.F, S = a.S, H = a.H;
  const int nsplit = attn_splits(S);
  float* h = a.scratch;
  float* qk = h + D;          // 2 D
  float* qmt = qk + 2 * D;    // H D
  float* ff = qmt + H * D;    // F
  float* sp = ff + F;         // S H
  float* att_part = sp + (size_t)S * H;  // nsplit D
  const T* in_norm = static_cast<const T*>(a.in_norm);
  const T* post_norm = static_cast<const T*>(a.post_norm);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wk = static_cast<const T*>(a.wk);
  const T* wv = static_cast<const T*>(a.wv);
  const T* wo = static_cast<const T*>(a.wo);
  const T* gate_w = static_cast<const T*>(a.gate_w);
  const T* up_w = static_cast<const T*>(a.up_w);
  const T* down_w = static_cast<const T*>(a.down_w);
  T* ck = static_cast<T*>(a.ck);
  T* cv = static_cast<T*>(a.cv);
  const size_t LDD = (size_t)D * D, LFD = (size_t)F * D, LSD = (size_t)S * D;

  const int grid_qkv = (3 * D + kWarps - 1) / kWarps;
  const int grid_d = (D + kWarps - 1) / kWarps;
  const int grid_f = (F + kWarps - 1) / kWarps;
  const int grid_rope = (D + 31) / 32;
  const int grid_s = (S + kWarps - 1) / kWarps;
  const dim3 grid_pv((D + kCols - 1) / kCols, nsplit);
  const size_t sm_norm = (size_t)(D + kWarps) * sizeof(float);
  const size_t sm_ff = (size_t)(F + kWarps) * sizeof(float);
  const size_t sm_rope = (size_t)(2 * D + 2 * kWarps * 32) * sizeof(float);
  for (int l = 0; l < a.N; ++l) {
    T* ckl = ck + l * LSD;
    T* cvl = cv + l * LSD;
    step_qkv_kernel<T><<<grid_qkv, kThreads, sm_norm, st>>>(
        a.pos, a.h0, l == 0, h, in_norm + (size_t)l * D, wq + l * LDD,
        wk + l * LDD, wv + l * LDD, qk, cvl, D, S);
    PDT_CHECK();
    step_rope_kernel<T><<<grid_rope, kThreads, sm_rope, st>>>(
        a.pos, qk, a.cos, a.sin, a.rot, a.hmask, qmt, ckl, D, H, S);
    PDT_CHECK();
    step_scores_kernel<T><<<grid_s, kThreads, 0, st>>>(a.pos, ckl, qmt, sp,
                                                         D, H, S, a.scale);
    PDT_CHECK();
    step_softmax_kernel<T><<<H, kThreads, 0, st>>>(a.pos, sp, H, S);
    PDT_CHECK();
    step_pv_kernel<T><<<grid_pv, kThreads, 0, st>>>(a.pos, sp, a.hmask, cvl,
                                                     att_part, D, H, S);
    PDT_CHECK();
    step_wo_kernel<T><<<grid_d, kThreads, D * sizeof(float), st>>>(
        a.pos, att_part, wo + l * LDD, h, D, S);
    PDT_CHECK();
    gate_up_kernel<T><<<grid_f, kThreads, sm_norm, st>>>(
        h, post_norm + (size_t)l * D, gate_w + l * LFD, up_w + l * LFD, ff,
        D, F);
    PDT_CHECK();
    down_residual_kernel<T><<<grid_d, kThreads, sm_ff, st>>>(
        ff, F, down_w + l * LFD, h, D);
    PDT_CHECK();
  }
  step_final_norm_kernel<T><<<1, kThreads, sm_norm, st>>>(
      h, static_cast<const T*>(a.final_norm), a.h_out, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch for one step: h (D), raw q and k (2 D), qM^T (H D), ff
// (F), the scores and probabilities (S H) and the p @ V partials per
// 64-row block (D each).
int pdt_decode_step_scratch_floats(int dim, int n_heads, int ffn, int seq) {
  return 3 * dim + n_heads * dim + ffn + seq * n_heads +
         attn_splits(seq) * dim;
}

// K10. wdtype 0: float32 weights, norms and caches, 1: bfloat16; h0, cos,
// sin (D,), rot (D, D), hmask (D, H) and h_out (D,) are float32. The caches
// are updated in place at row min(pos, S - 1). Returns the CUDA error of
// the first launch that failed, or cudaSuccess.
int pdt_decode_step(int wdtype, const void* pos, const void* h0,
                    const void* cos, const void* sin, const void* rot,
                    const void* hmask, const void* final_norm, const void* wq,
                    const void* wk, const void* wv, const void* wo,
                    const void* gate_w, const void* up_w, const void* down_w,
                    const void* in_norm, const void* post_norm, void* ck,
                    void* cv, void* h_out, void* scratch, int n_layers,
                    int dim, int n_heads, int ffn, int seq, float scale,
                    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  StepArgs a{static_cast<const int*>(pos),
             f(h0), f(cos), f(sin), f(rot), f(hmask),
             final_norm, wq, wk, wv, wo, gate_w, up_w, down_w,
             in_norm, post_norm, ck, cv,
             static_cast<float*>(h_out), static_cast<float*>(scratch),
             n_layers, dim, n_heads, ffn, seq, scale};
  if (n_heads > kMaxHeads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return run_step<float>(a, st);
  if (wdtype == 1) return run_step<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
