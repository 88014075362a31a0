// One greedy decode step for B rows on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_token_kernel_batched`
// (pydynet_tpu/ops/decode_step.py:509, launched by
// `fused_decode_token_batched` at :1027). It computes K1's step
// (decode_token.cu) for B rows that share one position `pos` and one weight
// stream: gather emb[tok[b]]; per layer RMSNorm, q/k/v, interleaved RoPE, the
// K/V row write at pos (clamped to S-1) in row b's cache, online-softmax
// attention of row b over its own cache rows [starts[b], pos] (the row's new
// key at pos always included), wo + residual, RMSNorm, SwiGLU + residual;
// then the final RMSNorm, the lm_head GEMV + bias and a greedy argmax per
// row whose ties go to the lowest index. `starts` is the continuous-batching
// server's per-row lower bound: a slot recycled for a new request keeps the
// old request's rows below its admission row invisible. The TPU layout
// tricks (128-lane padding, 16-row read-modify-write tiles, head-mask and
// pair-swap matmuls, the B x B diagonal-block score matmul) are gone:
// weights are (out, in) rows and caches are (N, B, S, D).
//
// The chain is K1's, with every GEMV block applying each weight row to all
// B activation rows: a warp loads a 16-byte piece of a row once and
// accumulates it into B per-row sums held in registers (BM of them, BM the
// smallest of 4, 8, 16, 32 that holds B), then lane b keeps row b's sum. So
// each weight matrix is read from device memory once per token for the whole
// fleet. Per token, on the caller's stream:
//   1. RMSNorm + q/k/v GEMV + RoPE + K/V row write (layer 0 gathers the
//      embedding rows), B activation rows in shared memory,
//   2. attention split over (head, 64-row cache block, row b); a block
//      whose rows all lie outside [starts[b], pos] exits at once,
//   3. the online-softmax merge of the partials + wo GEMV + residual,
//   4. RMSNorm + gate/up GEMV + SiLU * up,
//   5. down GEMV + residual,
// then 6. final RMSNorm + head GEMV + bias with a (max, index) pair per row
// and vocab tile (the int8 head quantises each row with its own scale, the
// TPU kernel's qvec_b), and 7. one block per row: argmax over its tiles.
// `pos`, `tok` and `starts` are read from device memory, so a chunk of steps
// never waits for the host. Each row does K1's arithmetic in K1's order, so
// row b with starts[b] = 0 gives the token and cache row that K1 gives on
// that row alone.
//
// What bounds it on an H100: at stories15M width (D 288, F 768, 6 layers,
// V 32000), B = 8, pos 512, a token reads about 12 MB of bf16 layer weights
// and 18.4 MB of head once for the fleet, and about 29 MB of KV (8 rows x
// about 3.6 MB): about 18 us at 3.35 TB/s. Here the weight stream is shared,
// which is the point of the kernel; the per-row products read the activation
// rows from shared memory, whose traffic grows with B; the 32 launches of
// the chain stay latency-bound as in K1. A CUDA graph over a chunk and fused
// launches come later.
//
// Shared memory grows with B: B activation rows of width max(D, F) are 96 KB
// at B = 32, F = 768, above the 48 KB a block gets without opting in, so the
// launches above 48 KB opt in to dynamic shared memory (up to 227 KB). The
// wrapper (ops/decode_step.batched_kernel_takes) refuses a B or widths that
// do not fit.

#include "common.cuh"

namespace {

constexpr int kMaxBatch = 32;  // lane b of a warp keeps row b's sums
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to on sm_90

// acc[b] = this lane's share of dot(row[0:K], x_s[b*K : b*K+K]) for b < B:
// lane_dot's loads and summation order for every row b, with each 16-byte
// piece of the weight row loaded once and applied to all B activation rows.
template <int BM, typename Acc, typename W>
__device__ __forceinline__ void lane_dot_rows(const W* row, const float* x_s,
                                              int K, int B, Acc (&acc)[BM]) {
  constexpr int kVec = 16 / sizeof(W);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < BM; ++b) acc[b] = 0;
  int k0 = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && K % kVec == 0) {
    // K % kVec == 0 keeps every x_s row 16-byte aligned for float4 loads
    const int nvec = K / kVec;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int v = lane; v < nvec; v += 32) {
      const uint4 u = rv[v];
      const W* e = reinterpret_cast<const W*>(&u);
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        if (b < B) {
          const float4* xs =
              reinterpret_cast<const float4*>(x_s + (size_t)b * K + v * kVec);
#pragma unroll
          for (int i = 0; i < kVec / 4; ++i) {
            const float4 x = xs[i];
            acc[b] += mul<Acc>(e[4 * i], x.x);
            acc[b] += mul<Acc>(e[4 * i + 1], x.y);
            acc[b] += mul<Acc>(e[4 * i + 2], x.z);
            acc[b] += mul<Acc>(e[4 * i + 3], x.w);
          }
        }
      }
    }
    k0 = nvec * kVec;
  }
  for (int k = k0 + lane; k < K; k += 32) {
    const W w = row[k];
#pragma unroll
    for (int b = 0; b < BM; ++b)
      if (b < B) acc[b] += mul<Acc>(w, x_s[(size_t)b * K + k]);
  }
}

// The warp's sums of acc[b] over its lanes; lane b (< B) returns row b's
template <int BM, typename Acc>
__device__ __forceinline__ Acc lane_row_sum(Acc (&acc)[BM], int B) {
  const int lane = threadIdx.x & 31;
  Acc mine = 0;
#pragma unroll
  for (int b = 0; b < BM; ++b) {
    if (b < B) {
      Acc s;
      if constexpr (std::is_same<Acc, int>::value)
        s = warp_sum_i(acc[b]);
      else
        s = warp_sum(acc[b]);
      if (lane == b) mine = s;
    }
  }
  return mine;
}

// dot(row, x_s row b) for every b < B over one warp; lane b gets row b's
template <int BM, typename W>
__device__ __forceinline__ float warp_dot_rows(const W* row, const float* x_s,
                                               int K, int B) {
  float acc[BM];
  lane_dot_rows<BM>(row, x_s, K, B, acc);
  return lane_row_sum<BM>(acc, B);
}

// Row b's attention lower bound: starts[b] (0 without starts), at most p
__device__ __forceinline__ int row_start(const int* starts, int b, int p) {
  return starts == nullptr ? 0 : min(max(starts[b], 0), p);
}

// 1. RMSNorm + q/k/v + RoPE + K/V row write for B rows. A warp owns one
// (even, odd) feature pair of the concatenated [q; k; v] rows; lane b rotates
// and writes row b's pair. h, q_out: (B, D) f32; ck, cv: the layer's (B, S, D)
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
qkv_rope_b_kernel(const int* __restrict__ pos_p, const int* __restrict__ tok,
                  const T* __restrict__ emb, int first, float* __restrict__ h,
                  const T* __restrict__ in_norm, const T* __restrict__ wq,
                  const T* __restrict__ wk, const T* __restrict__ wv,
                  const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                  float* __restrict__ q_out, T* __restrict__ ck,
                  T* __restrict__ cv, int B, int D, int S, int V) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;  // (B, D)
  float* red = smem + (size_t)B * D;
  const int pos = min(*pos_p, S - 1);
  for (int b = 0; b < B; ++b) {
    float* xb = x_s + (size_t)b * D;
    if (first) {
      const int t = min(max(tok[b], 0), V - 1);
      const T* e = emb + (size_t)t * D;
      load_normed<T>(e, in_norm, D, xb, red);
      if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < D; i += blockDim.x)
          h[(size_t)b * D + i] = to_f(e[i]);
    } else {
      load_normed<T>(h + (size_t)b * D, in_norm, D, xb, red);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npairs = 3 * D / 2;
  for (int p = blockIdx.x * kWarps + warp; p < npairs;
       p += gridDim.x * kWarps) {
    const int which = (2 * p) / D;  // 0 q, 1 k, 2 v
    const int j = 2 * p - which * D;
    const T* w = which == 0 ? wq : (which == 1 ? wk : wv);
    float a = warp_dot_rows<BM>(w + (size_t)j * D, x_s, D, B);
    float b = warp_dot_rows<BM>(w + (size_t)(j + 1) * D, x_s, D, B);
    if (lane < B) {
      const size_t r = (size_t)pos * D + j;
      if (which < 2) {  // rotate the interleaved pair (2i, 2i+1)
        const float ra = a * to_f(cos_t[r]) - b * to_f(sin_t[r]);
        const float rb = b * to_f(cos_t[r + 1]) + a * to_f(sin_t[r + 1]);
        a = ra;
        b = rb;
      }
      if (which == 0) {
        q_out[(size_t)lane * D + j] = a;
        q_out[(size_t)lane * D + j + 1] = b;
      } else {
        T* c = (which == 1 ? ck : cv) + (size_t)lane * S * D + r;
        c[0] = from_f<T>(a);
        c[1] = from_f<T>(b);
      }
    }
  }
}

// 2. Attention of row b (blockIdx.z), one head (blockIdx.x), over one block
// of kAttnRows cache rows (blockIdx.y) clipped to [starts[b], pos]: K1's
// attention_kernel on row b's cache. The block writes its partial (max m,
// sum l, p @ V); blocks with no row in the range write nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_b_kernel(const int* __restrict__ pos_p,
                   const int* __restrict__ starts, const float* __restrict__ q,
                   const T* __restrict__ ck, const T* __restrict__ cv,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int D, int hd, int S,
                   float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // hd
  float* p_s = q_s + hd;         // kAttnRows
  float* part = p_s + kAttnRows; // kThreads
  float* ml = part + kThreads;   // 2
  const int head = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int p = min(*pos_p, S - 1);
  const int n = p + 1;
  const int r0 = blockIdx.y * kAttnRows;
  const int lo = row_start(starts, b, p);
  if (r0 >= n || r0 + kAttnRows <= lo) return;
  const int len = min(kAttnRows, n - r0);  // rows [rlo, len) of the block
  const int rlo = max(lo - r0, 0);
  for (int d = tid; d < hd; d += blockDim.x)
    q_s[d] = round_to<T>(q[(size_t)b * D + head * hd + d]);
  __syncthreads();
  const T* kb = ck + ((size_t)b * S + r0) * D + head * hd;
  const T* vb = cv + ((size_t)b * S + r0) * D + head * hd;
  {  // scores: threads (4 row, sub) with sub = tid % 4 in one warp
    constexpr int kTpr = kThreads / kAttnRows;
    const int row = tid / kTpr, sub = tid % kTpr;
    const int seg = (hd + kTpr - 1) / kTpr;
    const bool valid = row >= rlo && row < len;
    float dot = 0.f;
    if (valid) {
      const T* k = kb + (size_t)row * D;
      for (int e = sub * seg; e < min(hd, sub * seg + seg); ++e)
        dot += to_f(k[e]) * q_s[e];
    }
    for (int o = 1; o < kTpr; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (sub == 0) p_s[row] = valid ? dot * scale : -INFINITY;
  }
  __syncthreads();
  if (tid < 32) {  // one warp: max, exp, sum over the 64 scores
    const float a = p_s[tid], c = p_s[tid + 32];
    const float m = warp_max(fmaxf(a, c));
    const float pa = expf(a - m), pc = expf(c - m);  // exp(-inf) = 0
    p_s[tid] = pa;
    p_s[tid + 32] = pc;
    const float l = warp_sum(pa + pc);
    if (tid == 0) {
      ml[0] = m;
      ml[1] = l;
    }
  }
  __syncthreads();
  const int groups = blockDim.x / hd;
  const int d = tid % hd, g = tid / hd;
  float pv = 0.f;
  if (g < groups)
    for (int r = rlo + g; r < len; r += groups)
      pv += p_s[r] * to_f(vb[(size_t)r * D + d]);
  part[tid] = pv;
  __syncthreads();
  const int slot = (b * gridDim.x + head) * gridDim.y + blockIdx.y;
  if (tid < hd) {
    float t = 0.f;
    for (int gg = 0; gg < groups; ++gg) t += part[gg * hd + tid];
    part_acc[(size_t)slot * hd + tid] = t;
  }
  if (tid == 0) {
    part_m[slot] = ml[0];
    part_l[slot] = ml[1];
  }
}

// h[b, r] += dot(w[r, 0:K], x_s row b) for r < D and b < B, a warp per
// output row r applying it to every activation row
template <typename T, int BM>
__device__ __forceinline__ void gemv_residual_b(const float* x_s, int K,
                                                const T* w, float* h, int D,
                                                int B) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = blockIdx.x * kWarps + warp; r < D; r += gridDim.x * kWarps) {
    const float a = warp_dot_rows<BM>(w + (size_t)r * K, x_s, K, B);
    if (lane < B) h[(size_t)lane * D + r] += a;
  }
}

// 3. Merge each row's attention partials of every head (online-softmax
// rescale to the common max) over the row's blocks, round the (B, D) result
// to T, then wo GEMV + residual. Each block redoes the small merge.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
attn_out_b_kernel(const int* __restrict__ pos_p,
                  const int* __restrict__ starts,
                  const float* __restrict__ part_m,
                  const float* __restrict__ part_l,
                  const float* __restrict__ part_acc, int nsplit, int H,
                  int hd, const T* __restrict__ wo, float* __restrict__ h,
                  int B, int D, int S) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;  // (B, D)
  const int p = min(*pos_p, S - 1);
  const int s1 = (p + kAttnRows) / kAttnRows;  // blocks up to row p
  for (int idx = threadIdx.x; idx < B * D; idx += blockDim.x) {
    const int b = idx / D, i = idx - b * D;
    const int head = i / hd, d = i - head * hd;
    const int base = (b * H + head) * nsplit;
    const int s0 = row_start(starts, b, p) / kAttnRows;
    float m = -INFINITY;
    for (int s = s0; s < s1; ++s) m = fmaxf(m, part_m[base + s]);
    float num = 0.f, den = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float c = expf(part_m[base + s] - m);
      num += c * part_acc[(size_t)(base + s) * hd + d];
      den += c * part_l[base + s];
    }
    x_s[idx] = round_to<T>(num / fmaxf(den, 1e-30f));
  }
  __syncthreads();
  gemv_residual_b<T, BM>(x_s, D, wo, h, D, B);
}

// 4. RMSNorm + gate/up + SiLU(gate) * up -> ff (B, F) f32
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gate_up_b_kernel(const float* __restrict__ h, const T* __restrict__ post_norm,
                 const T* __restrict__ gate_w, const T* __restrict__ up_w,
                 float* __restrict__ ff, int B, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;  // (B, D)
  float* red = smem + (size_t)B * D;
  for (int b = 0; b < B; ++b)
    load_normed<T>(h + (size_t)b * D, post_norm, D, x_s + (size_t)b * D, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = blockIdx.x * kWarps + warp; j < F; j += gridDim.x * kWarps) {
    const float gv = warp_dot_rows<BM>(gate_w + (size_t)j * D, x_s, D, B);
    const float uv = warp_dot_rows<BM>(up_w + (size_t)j * D, x_s, D, B);
    if (lane < B)
      ff[(size_t)lane * F + j] = gv * (1.f / (1.f + expf(-gv))) * uv;
  }
}

// 5. h[b, r] += dot(down[r, 0:F], T(ff[b])) for r < D
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
down_residual_b_kernel(const float* __restrict__ ff, int F,
                       const T* __restrict__ w, float* __restrict__ h, int B,
                       int D) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;  // (B, F)
  for (int i = threadIdx.x; i < B * F; i += blockDim.x)
    x_s[i] = round_to<T>(ff[i]);
  __syncthreads();
  gemv_residual_b<T, BM>(x_s, F, w, h, D, B);
}

// 6. Final RMSNorm + head GEMV + bias over kHeadRows vocab rows, reduced to
// one (max, index) pair per row b and block: tile_val/tile_idx (B, ntiles).
// HW is T, or int8_t for the int8 head (per-row f32 scales `head_s`; each
// activation row quantised with its own scale, as the TPU's qvec_b).
template <typename T, typename HW, int BM>
__global__ void __launch_bounds__(kThreads)
head_b_kernel(const float* __restrict__ h, const T* __restrict__ final_norm,
              const HW* __restrict__ head_w, const float* __restrict__ head_s,
              const T* __restrict__ head_b, float* __restrict__ tile_val,
              int* __restrict__ tile_idx, int B, int D, int V) {
  constexpr bool kInt8 = std::is_same<HW, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;  // (B, D)
  float* red = smem + (size_t)B * D;
  __shared__ float wv[kWarps][BM];
  __shared__ int wi[kWarps][BM];
  __shared__ float sx_s[BM];  // per-row activation scale (int8 head)
  for (int b = 0; b < B; ++b) {
    float* xb = x_s + (size_t)b * D;
    if constexpr (kInt8) {
      load_normed<float>(h + (size_t)b * D, final_norm, D, xb, red);
      float amax = 0.f;
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        amax = fmaxf(amax, fabsf(xb[i]));
      amax = fmaxf(block_max(amax, red), 1e-30f);
      const float inv = 127.0f / amax;
      for (int i = threadIdx.x; i < D; i += blockDim.x)
        xb[i] = rintf(xb[i] * inv);  // round half to even
      if (threadIdx.x == 0) sx_s[b] = amax * (1.0f / 127.0f);
      __syncthreads();
    } else {
      load_normed<T>(h + (size_t)b * D, final_norm, D, xb, red);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sx = kInt8 && lane < B ? sx_s[lane] : 0.f;
  float bv = -INFINITY;
  int bi = INT_MAX;
  const int r0 = blockIdx.x * kHeadRows + warp * kHeadRowsPerWarp;
  for (int r = r0; r < min(r0 + kHeadRowsPerWarp, V); ++r) {
    const HW* row = head_w + (size_t)r * D;
    float logit;
    if constexpr (kInt8) {
      int acc[BM];
      lane_dot_rows<BM>(row, x_s, D, B, acc);
      const int s = lane_row_sum<BM>(acc, B);
      logit = (float)s * (head_s[r] * sx) + to_f(head_b[r]);
    } else {
      logit = warp_dot_rows<BM>(row, x_s, D, B) + to_f(head_b[r]);
    }
    if (lane < B && better(logit, r, bv, bi)) {
      bv = logit;
      bi = r;
    }
  }
  if (lane < B) {
    wv[warp][lane] = bv;
    wi[warp][lane] = bi;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    const int b = threadIdx.x;
    bv = -INFINITY;
    bi = INT_MAX;
    for (int w = 0; w < kWarps; ++w)
      if (better(wv[w][b], wi[w][b], bv, bi)) {
        bv = wv[w][b];
        bi = wi[w][b];
      }
    tile_val[(size_t)b * gridDim.x + blockIdx.x] = bv;
    tile_idx[(size_t)b * gridDim.x + blockIdx.x] = bi;
  }
}

struct Args {
  const int* pos;
  const int* tok;
  const int* starts;  // nullptr: every row starts at 0
  int* out;
  const void *emb, *cos, *sin, *final_norm;
  const void *wq, *wk, *wv, *wo, *gate_w, *up_w, *down_w;
  const void *in_norm, *post_norm, *head_w;
  const float* head_s;
  const void* head_b;
  void *ck, *cv;
  float* scratch;
  int B, N, D, H, F, V, S;
  float scale;
};

// Let `kernel` take `bytes` of dynamic shared memory: the opt-in above the
// 48 KB a block gets by default
template <typename K>
cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define PDT_TRY(expr)                       \
  do {                                      \
    cudaError_t e_ = (expr);                \
    if (e_ != cudaSuccess) return e_;       \
  } while (0)

template <typename T, typename HW, int BM>
cudaError_t run(const Args& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, S = a.S, H = a.H, hd = a.D / a.H;
  const int ntiles = head_tiles(a.V);
  const int nsplit = attn_splits(S);
  float* h = a.scratch;                      // (B, D)
  float* q = h + (size_t)B * D;              // (B, D)
  float* ff = q + (size_t)B * D;             // (B, F)
  float* tile_val = ff + (size_t)B * F;      // (B, ntiles)
  int* tile_idx = reinterpret_cast<int*>(tile_val + (size_t)B * ntiles);
  float* part_m = tile_val + (size_t)2 * B * ntiles;  // (B, H, nsplit)
  float* part_l = part_m + (size_t)B * H * nsplit;
  float* part_acc = part_l + (size_t)B * H * nsplit;  // (B, H, nsplit, hd)
  const T* emb = static_cast<const T*>(a.emb);
  const T* cos_t = static_cast<const T*>(a.cos);
  const T* sin_t = static_cast<const T*>(a.sin);
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
  const size_t LDD = (size_t)D * D, LFD = (size_t)F * D;
  const size_t LBSD = (size_t)B * S * D;  // one layer of the caches

  const int grid_qkv = (3 * D / 2 + kWarps - 1) / kWarps;
  const int grid_d = (D + kWarps - 1) / kWarps;
  const int grid_f = (F + kWarps - 1) / kWarps;
  const size_t sm_norm = ((size_t)B * D + kWarps) * sizeof(float);
  const size_t sm_bd = (size_t)B * D * sizeof(float);
  const size_t sm_bf = (size_t)B * F * sizeof(float);
  const size_t sm_attn = (size_t)(hd + kAttnRows + kThreads + 2) *
                         sizeof(float);
  if (sm_norm > kMaxSmem || sm_bf > kMaxSmem) return cudaErrorInvalidValue;
  PDT_TRY(allow_smem(qkv_rope_b_kernel<T, BM>, sm_norm));
  PDT_TRY(allow_smem(attn_out_b_kernel<T, BM>, sm_bd));
  PDT_TRY(allow_smem(gate_up_b_kernel<T, BM>, sm_norm));
  PDT_TRY(allow_smem(down_residual_b_kernel<T, BM>, sm_bf));
  PDT_TRY(allow_smem(head_b_kernel<T, HW, BM>, sm_norm));
  for (int l = 0; l < a.N; ++l) {
    qkv_rope_b_kernel<T, BM><<<grid_qkv, kThreads, sm_norm, st>>>(
        a.pos, a.tok, emb, l == 0, h, in_norm + (size_t)l * D, wq + l * LDD,
        wk + l * LDD, wv + l * LDD, cos_t, sin_t, q, ck + l * LBSD,
        cv + l * LBSD, B, D, S, a.V);
    PDT_CHECK();
    attention_b_kernel<T><<<dim3(H, nsplit, B), kThreads, sm_attn, st>>>(
        a.pos, a.starts, q, ck + l * LBSD, cv + l * LBSD, part_m, part_l,
        part_acc, D, hd, S, a.scale);
    PDT_CHECK();
    attn_out_b_kernel<T, BM><<<grid_d, kThreads, sm_bd, st>>>(
        a.pos, a.starts, part_m, part_l, part_acc, nsplit, H, hd,
        wo + l * LDD, h, B, D, S);
    PDT_CHECK();
    gate_up_b_kernel<T, BM><<<grid_f, kThreads, sm_norm, st>>>(
        h, post_norm + (size_t)l * D, gate_w + l * LFD, up_w + l * LFD, ff,
        B, D, F);
    PDT_CHECK();
    down_residual_b_kernel<T, BM><<<grid_d, kThreads, sm_bf, st>>>(
        ff, F, down_w + l * LFD, h, B, D);
    PDT_CHECK();
  }
  head_b_kernel<T, HW, BM><<<ntiles, kThreads, sm_norm, st>>>(
      h, static_cast<const T*>(a.final_norm),
      static_cast<const HW*>(a.head_w), a.head_s,
      static_cast<const T*>(a.head_b), tile_val, tile_idx, B, D, a.V);
  PDT_CHECK();
  argmax_kernel<<<B, kThreads, 0, st>>>(tile_val, tile_idx, ntiles, a.out);
  return cudaGetLastError();
}

// the smallest register tile of rows that holds B
template <typename T, typename HW>
cudaError_t run_b(const Args& a, cudaStream_t st) {
  if (a.B <= 4) return run<T, HW, 4>(a, st);
  if (a.B <= 8) return run<T, HW, 8>(a, st);
  if (a.B <= 16) return run<T, HW, 16>(a, st);
  return run<T, HW, kMaxBatch>(a, st);
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper allocates for one step of B rows: h, q
// (B x D each), ff (B x F), a (max, index) pair per row and head tile, and
// the attention partials (m, l and a head_dim vector per row, head and row
// block).
int pdt_decode_token_batched_scratch_floats(int batch, int dim, int n_heads,
                                            int ffn, int vocab, int seq) {
  return batch * (2 * dim + ffn + 2 * head_tiles(vocab) +
                  attn_splits(seq) * (2 * n_heads + dim));
}

// wdtype 0: float32 weights and caches, 1: bfloat16. qhead 1: head_w is
// int8 (V, D) with float32 per-row scales head_s. starts may be null
// (every row attends from row 0). Returns the CUDA error of the first call
// that failed, or cudaSuccess; cudaErrorInvalidValue for a batch outside
// [1, 32] or widths whose activation rows do not fit in shared memory.
int pdt_decode_token_batched(int wdtype, int qhead, const void* pos,
                             const void* tok, const void* starts, void* out,
                             const void* emb, const void* cos,
                             const void* sin, const void* final_norm,
                             const void* wq, const void* wk, const void* wv,
                             const void* wo, const void* gate_w,
                             const void* up_w, const void* down_w,
                             const void* in_norm, const void* post_norm,
                             const void* head_w, const void* head_s,
                             const void* head_b, void* ck, void* cv,
                             void* scratch, int batch, int n_layers, int dim,
                             int n_heads, int ffn, int vocab, int seq,
                             float scale, void* stream) {
  if (batch < 1 || batch > kMaxBatch) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(pos),
         static_cast<const int*>(tok),
         static_cast<const int*>(starts),
         static_cast<int*>(out),
         emb, cos, sin, final_norm,
         wq, wk, wv, wo, gate_w, up_w, down_w,
         in_norm, post_norm, head_w,
         static_cast<const float*>(head_s),
         head_b, ck, cv,
         static_cast<float*>(scratch),
         batch, n_layers, dim, n_heads, ffn, vocab, seq, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0)
    return qhead ? run_b<float, int8_t>(a, st) : run_b<float, float>(a, st);
  if (wdtype == 1)
    return qhead ? run_b<__nv_bfloat16, int8_t>(a, st)
                 : run_b<__nv_bfloat16, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
