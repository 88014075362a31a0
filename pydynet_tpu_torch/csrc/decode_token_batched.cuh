// The batched decode step's kernels and launch chain (K2; see
// decode_token_batched.cu for what it computes and why). Included by
// decode_token_batched.cu, which instantiates the chain for float32 weights
// and holds the C entry points, and by decode_token_batched_bf16.cu, which
// instantiates it for bfloat16 weights: nvcc compiles the two at once, each
// with half of the modes' template instances.
#pragma once

#include "common.cuh"
#include "head.cuh"

namespace pdt_k2 {

// A step's arguments (pdt_decode_token_batched's), shared by the two
// sources that instantiate the chain: decode_token_batched.cu (float32
// weights) and decode_token_batched_bf16.cu (bfloat16 weights)
struct Args {
  const int* pos;
  const int* tok;
  const int* starts;  // nullptr: every row starts at 0
  int* out;
  float* logits;  // emit_logits: the (B, V) f32 logits instead of out
  const void *emb, *cos, *sin, *final_norm;
  const void *wq, *wk, *wv, *wo, *gate_w, *up_w, *down_w;
  const void *in_norm, *post_norm, *head_w;
  const float* head_s;
  const void* head_b;
  const float *s_q, *s_k, *s_v, *s_o, *s_gate, *s_up, *s_down;
  void *ck, *cv;
  float *sk, *sv;  // the int8 KV cache's scales, else nullptr
  float* scratch;
  int B, N, D, H, Hkv, F, V, S;
  float scale;
};

// run_mode<__nv_bfloat16>, defined in decode_token_batched_bf16.cu
int run_bf16(int lfmt, int hfmt, int kv8, const Args& a, cudaStream_t st);

}  // namespace pdt_k2

namespace {

constexpr int kRowGroup = 32;  // rows a GEMV block takes: lane b of a warp
                               // keeps row b of the group's sums
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to on sm_90

// acc[b] = this lane's share of dot(row[0:K], x_s[b*K : b*K+K]) for b < B:
// lane_dot's loads and summation order for every row b, with each 16-byte
// piece of the weight row loaded once and applied to all B activation rows.
// Acc is float (f32/bf16 rows) or int (int8 rows, x_s holding integers).
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

// lane_dot_q4 for every row b < B: an int4 row of K elements packed as K/2
// bytes (byte j holds element j in its low nibble, j + K/2 in its high one)
// times the integer activations x_s[b*K : b*K+K], each 16-byte piece of the
// row unpacked once for all B rows; exact int sums.
template <int BM>
__device__ __forceinline__ void lane_dot_rows_q4(const int8_t* row,
                                                 const float* x_s, int K,
                                                 int B, int (&acc)[BM]) {
  const int K2 = K / 2, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < BM; ++b) acc[b] = 0;
  int j0 = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && K2 % 16 == 0) {
    // K2 % 16 == 0 keeps every x_s row and its upper half 16-byte aligned
    const int nvec = K2 / 16;
    const uint4* rv = reinterpret_cast<const uint4*>(row);
    for (int v = lane; v < nvec; v += 32) {
      const uint4 u = rv[v];
      const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned lo = nibbles_lo(words[i]), hi = nibbles_hi(words[i]);
        const int j = v * 16 + i * 4;
#pragma unroll
        for (int b = 0; b < BM; ++b) {
          if (b < B) {
            const float* xb = x_s + (size_t)b * K;
            const float4 xl = *reinterpret_cast<const float4*>(xb + j);
            const float4 xh = *reinterpret_cast<const float4*>(xb + K2 + j);
            acc[b] += sbyte(lo, 0) * (int)xl.x + sbyte(lo, 1) * (int)xl.y +
                      sbyte(lo, 2) * (int)xl.z + sbyte(lo, 3) * (int)xl.w +
                      sbyte(hi, 0) * (int)xh.x + sbyte(hi, 1) * (int)xh.y +
                      sbyte(hi, 2) * (int)xh.z + sbyte(hi, 3) * (int)xh.w;
          }
        }
      }
    }
    j0 = nvec * 16;
  }
  for (int j = j0 + lane; j < K2; j += 32) {
    const unsigned p = (uint8_t)row[j];
    const int lo = sbyte(nibbles_lo(p), 0), hi = sbyte(nibbles_hi(p), 0);
#pragma unroll
    for (int b = 0; b < BM; ++b)
      if (b < B)
        acc[b] += lo * (int)x_s[(size_t)b * K + j] +
                  hi * (int)x_s[(size_t)b * K + K2 + j];
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

// dot(row r of a (rows, K) weight matrix of format Q, x_s row b) for every
// b < B over one warp; lane b gets row b's: f32 accumulation for T rows; for
// int8 and int4 rows the exact int32 sum rescaled as K1's row_dot does,
// float(acc) * (scale[r] * sx), sx the activation scale of the lane's row
template <int Q, typename T, int BM>
__device__ __forceinline__ float row_dot_rows(const void* w, int r,
                                              const float* x_s, int K, int B,
                                              const float* scale, float sx) {
  if constexpr (Q == kFmtFloat) {
    float acc[BM];
    lane_dot_rows<BM>(static_cast<const T*>(w) + (size_t)r * K, x_s, K, B,
                      acc);
    return lane_row_sum<BM>(acc, B);
  } else {
    const int8_t* row = static_cast<const int8_t*>(w) +
                        fmt_bytes<Q, T>((size_t)r * K);
    int acc[BM];
    if constexpr (Q == kFmtInt8)
      lane_dot_rows<BM>(row, x_s, K, B, acc);
    else
      lane_dot_rows_q4<BM>(row, x_s, K, B, acc);
    return (float)lane_row_sum<BM>(acc, B) * (scale[r] * sx);
  }
}

// The B activation rows x_s[b*K : b*K+K], f32 values written by this block,
// made the matmul input of format Q row by row (prepare_act: rounded to T,
// or quantized with the row's own amax); sx_s[b] holds row b's scale. Ends
// synchronised.
template <int Q, typename T>
__device__ void prepare_rows(float* x_s, int K, int B, float* red,
                             float* sx_s) {
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    const float sx = prepare_act<Q, T>(x_s + (size_t)b * K, K, red);
    if (threadIdx.x == 0) sx_s[b] = sx;
  }
  __syncthreads();
}

// The B rows of the (B, D) residual h made the matmul input of format Q:
// RMSNorm(h[b]) * w, rounded to T or quantized per row (load_normed_act);
// sx_s[b] holds row b's scale. Ends synchronised.
template <int Q, typename T>
__device__ void load_normed_rows(const float* h, const T* w, int D, int B,
                                 float* x_s, float* red, float* sx_s) {
  for (int b = 0; b < B; ++b) {
    const float sx = load_normed_act<Q, T>(h + (size_t)b * D, w, D,
                                           x_s + (size_t)b * D, red);
    if (threadIdx.x == 0) sx_s[b] = sx;
  }
  __syncthreads();
}

// Row b's attention lower bound: starts[b] (0 without starts), at most p
__device__ __forceinline__ int row_start(const int* starts, int b, int p) {
  return starts == nullptr ? 0 : min(max(starts[b], 0), p);
}

// The rows a GEMV block of a step of B rows takes: group blockIdx.y,
// rows [b0, b0 + count) with b0 = 32 * blockIdx.y
struct RowGroup {
  int b0, count;
  __device__ explicit RowGroup(int B)
      : b0(blockIdx.y * kRowGroup), count(min(kRowGroup, B - b0)) {}
};

// 1. RMSNorm + q/k/v + RoPE + K/V row write for one group of rows, layer
// weights of format Q. A warp owns one (even, odd) feature pair of the
// concatenated [q (D); k (Dkv); v (Dkv)] rows; lane b rotates and writes
// pair of row b of the group. k's pair j < Dkv is rotated by column j of the
// (S, D) tables (the pattern repeats per head). h, q_out: (B, D) f32; ck, cv:
// the layer's (B, S, Dkv) T caches, or with KV8 (the int8 KV cache) kv_out:
// the f32 K rows (B, Dkv) then the V rows (B, Dkv), which
// attention_kv8_kernel quantizes.
template <typename T, int Q, bool KV8, int BM>
__global__ void __launch_bounds__(kThreads)
qkv_rope_b_kernel(const int* __restrict__ pos_p, const int* __restrict__ tok,
                  const T* __restrict__ emb, int first, float* __restrict__ h,
                  const T* __restrict__ in_norm, const void* __restrict__ wq,
                  const void* __restrict__ wk, const void* __restrict__ wv,
                  const float* __restrict__ s_q,
                  const float* __restrict__ s_k,
                  const float* __restrict__ s_v, const T* __restrict__ cos_t,
                  const T* __restrict__ sin_t, float* __restrict__ q_out,
                  T* __restrict__ ck, T* __restrict__ cv,
                  float* __restrict__ kv_out, int B, int D, int Dkv, int S,
                  int V) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sx_s[BM];
  const RowGroup g(B);
  const int G = g.count;
  tok += g.b0;
  h += (size_t)g.b0 * D;
  q_out += (size_t)g.b0 * D;
  float* x_s = smem;  // (G, D)
  float* red = smem + (size_t)G * D;
  const int pos = min(*pos_p, S - 1);
  if (first) {
    for (int b = 0; b < G; ++b) {
      const T* e = emb + (size_t)min(max(tok[b], 0), V - 1) * D;
      const float sx = load_normed_act<Q, T>(e, in_norm, D,
                                             x_s + (size_t)b * D, red);
      if (threadIdx.x == 0) sx_s[b] = sx;
      if (blockIdx.x == 0)
        for (int i = threadIdx.x; i < D; i += blockDim.x)
          h[(size_t)b * D + i] = to_f(e[i]);
    }
    __syncthreads();
  } else {
    load_normed_rows<Q, T>(h, in_norm, D, G, x_s, red, sx_s);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sx = lane < G ? sx_s[lane] : 0.f;
  const int npairs = D / 2 + Dkv;
  for (int p = blockIdx.x * kWarps + warp; p < npairs;
       p += gridDim.x * kWarps) {
    const int f = 2 * p;  // 0 q, 1 k, 2 v; j: the feature in its rows
    const int which = f < D ? 0 : (f < D + Dkv ? 1 : 2);
    const int j = which == 0 ? f : f - D - (which - 1) * Dkv;
    const void* w = which == 0 ? wq : (which == 1 ? wk : wv);
    const float* sc = which == 0 ? s_q : (which == 1 ? s_k : s_v);
    float a = row_dot_rows<Q, T, BM>(w, j, x_s, D, G, sc, sx);
    float b = row_dot_rows<Q, T, BM>(w, j + 1, x_s, D, G, sc, sx);
    if (lane < G) {
      const int row = g.b0 + lane;  // in the whole batch
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
      } else if constexpr (KV8) {
        float* o = kv_out + ((size_t)(which - 1) * B + row) * Dkv + j;
        o[0] = a;
        o[1] = b;
      } else {
        T* c = (which == 1 ? ck : cv) + ((size_t)row * S + pos) * Dkv + j;
        c[0] = from_f<T>(a);
        c[1] = from_f<T>(b);
      }
    }
  }
}

// 2. Attention of row b (blockIdx.z), one query head (blockIdx.x), over one
// block of kAttnRows cache rows (blockIdx.y) clipped to [starts[b], pos]:
// K1's attention_kernel on row b's Dkv-wide cache, query head h reading KV
// head h / group. The block writes its partial (max m, sum l, p @ V);
// blocks with no row in the range write nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_b_kernel(const int* __restrict__ pos_p,
                   const int* __restrict__ starts, const float* __restrict__ q,
                   const T* __restrict__ ck, const T* __restrict__ cv,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int D, int Dkv, int group,
                   int hd, int S, float scale) {
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
  const T* kb = ck + ((size_t)b * S + r0) * Dkv + (head / group) * hd;
  const T* vb = cv + ((size_t)b * S + r0) * Dkv + (head / group) * hd;
  {  // scores: threads (4 row, sub) with sub = tid % 4 in one warp
    constexpr int kTpr = kThreads / kAttnRows;
    const int row = tid / kTpr, sub = tid % kTpr;
    const int seg = (hd + kTpr - 1) / kTpr;
    const bool valid = row >= rlo && row < len;
    float dot = 0.f;
    if (valid) {
      const T* k = kb + (size_t)row * Dkv;
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
  const int d = tid % hd, gi = tid / hd;
  float pv = 0.f;
  if (gi < groups)
    for (int r = rlo + gi; r < len; r += groups)
      pv += p_s[r] * to_f(vb[(size_t)r * Dkv + d]);
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

// quantize_kv's scale of the W-wide f32 row x, taken by the whole block:
// max(max |x| / 127, 1e-10), an IEEE division as the plain version's
__device__ float kv_scale(const float* x, int W, float* red) {
  float amax = 0.f;
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    amax = fmaxf(amax, fabsf(x[i]));
  return fmaxf(__fdiv_rn(block_max(amax, red), 127.f), 1e-10f);
}

// quantize_kv's value of x at scale s: clip(rint(x / s), -127, 127)
__device__ __forceinline__ float kv_quant(float x, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// 2'. attention_b_kernel over the int8 KV cache: ck, cv the layer's
// (B, S, Dkv) int8 rows, sk, sv their (B, S) f32 scales, kv_new the f32 K and
// V rows of stage 1. The query row is quantized per row over all D features;
// cached rows [starts[b], pos) score their exact int32 dot per head times
// sk[row] times the query's scale times `scale`, and contribute cv * sv.
// The block holding row pos (always in range) quantizes the new K and V rows
// over their Dkv features and scores them as the self row: its dequantized
// key against the exact f32 query, its dequantized value. The first query
// head of each KV head's group writes that KV head's features at row pos,
// head 0 the scales. No block reads row pos from the cache.
__global__ void __launch_bounds__(kThreads)
attention_kv8_kernel(const int* __restrict__ pos_p,
                     const int* __restrict__ starts,
                     const float* __restrict__ q,
                     const float* __restrict__ kv_new,
                     int8_t* __restrict__ ck, int8_t* __restrict__ cv,
                     float* __restrict__ sk, float* __restrict__ sv,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc, int B, int D, int Dkv,
                     int group, int hd, int S, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // hd: the f32 query
  float* qq_s = q_s + hd;        // hd: the quantized query (integers)
  float* kself = qq_s + hd;      // hd: the new key, dequantized
  float* vself = kself + hd;     // hd: the new value, dequantized
  float* p_s = vself + hd;       // kAttnRows
  float* part = p_s + kAttnRows; // kThreads
  float* ml = part + kThreads;   // 2
  float* red = ml + 2;           // kWarps
  const int head = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int kvh = head / group;  // the KV head this query head reads
  const int p = min(*pos_p, S - 1);
  const int n = p + 1;
  const int r0 = blockIdx.y * kAttnRows;
  const int lo = row_start(starts, b, p);
  if (r0 >= n || r0 + kAttnRows <= lo) return;
  const int len = min(kAttnRows, n - r0);  // rows [rlo, len) of the block
  const int rlo = max(lo - r0, 0);
  const int rp = p - r0;  // the new row, in this block when rp < kAttnRows
  const float* qb = q + (size_t)b * D;
  const float qs = kv_scale(qb, D, red);
  for (int d = tid; d < hd; d += blockDim.x) {
    const float x = qb[head * hd + d];
    q_s[d] = x;
    qq_s[d] = kv_quant(x, qs);
  }
  if (rp < kAttnRows) {
    const float* kn = kv_new + (size_t)b * Dkv;
    const float* vn = kv_new + ((size_t)B + b) * Dkv;
    const float ks = kv_scale(kn, Dkv, red), vs = kv_scale(vn, Dkv, red);
    const size_t at = ((size_t)b * S + p) * Dkv + kvh * hd;
    const bool writer = head % group == 0;
    for (int d = tid; d < hd; d += blockDim.x) {
      const float kq = kv_quant(kn[kvh * hd + d], ks);
      const float vq = kv_quant(vn[kvh * hd + d], vs);
      kself[d] = kq * ks;
      vself[d] = vq * vs;
      if (writer) {
        ck[at + d] = (int8_t)kq;
        cv[at + d] = (int8_t)vq;
      }
    }
    if (head == 0 && tid == 0) {
      sk[(size_t)b * S + p] = ks;
      sv[(size_t)b * S + p] = vs;
    }
  }
  __syncthreads();
  const int8_t* kb = ck + ((size_t)b * S + r0) * Dkv + kvh * hd;
  const int8_t* vb = cv + ((size_t)b * S + r0) * Dkv + kvh * hd;
  const float* skb = sk + (size_t)b * S + r0;
  const float* svb = sv + (size_t)b * S + r0;
  {  // scores: threads (4 row, sub) with sub = tid % 4 in one warp
    constexpr int kTpr = kThreads / kAttnRows;
    const int row = tid / kTpr, sub = tid % kTpr;
    const int seg = (hd + kTpr - 1) / kTpr;
    const bool valid = row >= rlo && row < len;
    const int e0 = sub * seg, e1 = min(hd, sub * seg + seg);
    int idot = 0;
    float fdot = 0.f;
    if (valid && row == rp) {
      for (int e = e0; e < e1; ++e) fdot += kself[e] * q_s[e];
    } else if (valid) {
      const int8_t* k = kb + (size_t)row * Dkv;
      for (int e = e0; e < e1; ++e) idot += (int)k[e] * (int)qq_s[e];
    }
    for (int o = 1; o < kTpr; o <<= 1) {
      idot += __shfl_xor_sync(0xffffffffu, idot, o);
      fdot += __shfl_xor_sync(0xffffffffu, fdot, o);
    }
    if (sub == 0)
      p_s[row] = !valid ? -INFINITY
                 : row == rp ? fdot * scale
                             : (float)idot * skb[row] * qs * scale;
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
  const int d = tid % hd, gi = tid / hd;
  float pv = 0.f;
  if (gi < groups)
    for (int r = rlo + gi; r < len; r += groups)
      pv += p_s[r] * (r == rp ? vself[d]
                              : (float)vb[(size_t)r * Dkv + d] * svb[r]);
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

// h[b, r] += dot(w[r, 0:K], x_s row b) for r < D and b < G (the group's
// rows), w of format Q (scale: its per-row scales, sx_s: the activation
// rows' scales), a warp per output row r applying it to every activation
// row
template <int Q, typename T, int BM>
__device__ __forceinline__ void gemv_residual_b(const float* x_s, int K,
                                                const void* w,
                                                const float* scale,
                                                const float* sx_s, float* h,
                                                int D, int G) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sx = lane < G ? sx_s[lane] : 0.f;
  for (int r = blockIdx.x * kWarps + warp; r < D; r += gridDim.x * kWarps) {
    const float a = row_dot_rows<Q, T, BM>(w, r, x_s, K, G, scale, sx);
    if (lane < G) h[(size_t)lane * D + r] += a;
  }
}

// 3. Merge each row's attention partials of every head (online-softmax
// rescale to the common max) over the row's blocks into the group's (G, D)
// result, made wo's input row by row (rounded to T or quantized), then wo
// GEMV + residual. Each block redoes the small merge for its group.
template <typename T, int Q, int BM>
__global__ void __launch_bounds__(kThreads)
attn_out_b_kernel(const int* __restrict__ pos_p,
                  const int* __restrict__ starts,
                  const float* __restrict__ part_m,
                  const float* __restrict__ part_l,
                  const float* __restrict__ part_acc, int nsplit, int H,
                  int hd, const void* __restrict__ wo,
                  const float* __restrict__ s_o, float* __restrict__ h, int B,
                  int D, int S) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sx_s[BM];
  const RowGroup g(B);
  const int G = g.count;
  float* x_s = smem;  // (G, D)
  float* red = smem + (size_t)G * D;
  const int p = min(*pos_p, S - 1);
  const int s1 = (p + kAttnRows) / kAttnRows;  // blocks up to row p
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int b = g.b0 + idx / D, i = idx % D;
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
    x_s[idx] = num / fmaxf(den, 1e-30f);
  }
  prepare_rows<Q, T>(x_s, D, G, red, sx_s);
  gemv_residual_b<Q, T, BM>(x_s, D, wo, s_o, sx_s, h + (size_t)g.b0 * D, D,
                            G);
}

// 4. RMSNorm + gate/up + SiLU(gate) * up -> ff (B, F) f32, one group of rows
template <typename T, int Q, int BM>
__global__ void __launch_bounds__(kThreads)
gate_up_b_kernel(const float* __restrict__ h, const T* __restrict__ post_norm,
                 const void* __restrict__ gate_w,
                 const void* __restrict__ up_w,
                 const float* __restrict__ s_gate,
                 const float* __restrict__ s_up, float* __restrict__ ff,
                 int B, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sx_s[BM];
  const RowGroup g(B);
  const int G = g.count;
  h += (size_t)g.b0 * D;
  ff += (size_t)g.b0 * F;
  float* x_s = smem;  // (G, D)
  float* red = smem + (size_t)G * D;
  load_normed_rows<Q, T>(h, post_norm, D, G, x_s, red, sx_s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float sx = lane < G ? sx_s[lane] : 0.f;
  for (int j = blockIdx.x * kWarps + warp; j < F; j += gridDim.x * kWarps) {
    const float gv = row_dot_rows<Q, T, BM>(gate_w, j, x_s, D, G, s_gate, sx);
    const float uv = row_dot_rows<Q, T, BM>(up_w, j, x_s, D, G, s_up, sx);
    if (lane < G)
      ff[(size_t)lane * F + j] = gv * (1.f / (1.f + expf(-gv))) * uv;
  }
}

// 5. h[b, r] += dot(down[r, 0:F], ff[b] as the matmul input) for r < D, one
// group of rows
template <typename T, int Q, int BM>
__global__ void __launch_bounds__(kThreads)
down_residual_b_kernel(const float* __restrict__ ff, int F,
                       const void* __restrict__ w,
                       const float* __restrict__ s_down,
                       float* __restrict__ h, int B, int D) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sx_s[BM];
  const RowGroup g(B);
  const int G = g.count;
  ff += (size_t)g.b0 * F;
  float* x_s = smem;  // (G, F)
  float* red = smem + (size_t)G * F;
  for (int i = threadIdx.x; i < G * F; i += blockDim.x) x_s[i] = ff[i];
  prepare_rows<Q, T>(x_s, F, G, red, sx_s);
  gemv_residual_b<Q, T, BM>(x_s, F, w, s_down, sx_s, h + (size_t)g.b0 * D, D,
                            G);
}

using pdt_k2::Args;

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

// Q: the layers' format, HQ: the head's, KV8: the int8 KV cache
template <typename T, int Q, int HQ, bool KV8, int BM>
cudaError_t run(const Args& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, S = a.S, H = a.H, hd = a.D / a.H;
  const int Dkv = a.Hkv * hd, group = a.H / a.Hkv;
  const int ntiles = head_blocks(a.V);
  const int nsplit = attn_splits(S);
  float* h = a.scratch;                      // (B, D)
  float* q = h + (size_t)B * D;              // (B, D)
  float* ff = q + (size_t)B * D;             // (B, F)
  float* tile_val = ff + (size_t)B * F;      // (B, ntiles)
  int* tile_idx = reinterpret_cast<int*>(tile_val + (size_t)B * ntiles);
  float* part_m = tile_val + (size_t)2 * B * ntiles;  // (B, H, nsplit)
  float* part_l = part_m + (size_t)B * H * nsplit;
  float* part_acc = part_l + (size_t)B * H * nsplit;  // (B, H, nsplit, hd)
  float* kv_new = part_acc + (size_t)B * H * nsplit * hd;  // (2, B, Dkv)
  const T* emb = static_cast<const T*>(a.emb);
  const T* cos_t = static_cast<const T*>(a.cos);
  const T* sin_t = static_cast<const T*>(a.sin);
  const T* in_norm = static_cast<const T*>(a.in_norm);
  const T* post_norm = static_cast<const T*>(a.post_norm);
  const size_t LDD = (size_t)D * D, LKD = (size_t)Dkv * D;
  const size_t LFD = (size_t)F * D;
  const size_t LBSD = (size_t)B * S * Dkv;  // one layer of the caches
  const size_t LBS = (size_t)B * S;         // one layer of the scales

  // GEMV grids: (output-row blocks, row groups); a block holds one group
  const int ngroups = (B + kRowGroup - 1) / kRowGroup;
  const int G = min(B, kRowGroup);
  const dim3 grid_qkv((D / 2 + Dkv + kWarps - 1) / kWarps, ngroups);
  const dim3 grid_d((D + kWarps - 1) / kWarps, ngroups);
  const dim3 grid_f((F + kWarps - 1) / kWarps, ngroups);
  const size_t sm_norm = ((size_t)G * D + kWarps) * sizeof(float);
  const size_t sm_ff = ((size_t)G * F + kWarps) * sizeof(float);
  const size_t sm_attn =
      (size_t)((KV8 ? 4 * hd + kWarps : hd) + kAttnRows + kThreads + 2) *
      sizeof(float);
  if (sm_norm > kMaxSmem || sm_ff > kMaxSmem) return cudaErrorInvalidValue;
  PDT_TRY(allow_smem(qkv_rope_b_kernel<T, Q, KV8, BM>, sm_norm));
  PDT_TRY(allow_smem(attn_out_b_kernel<T, Q, BM>, sm_norm));
  PDT_TRY(allow_smem(gate_up_b_kernel<T, Q, BM>, sm_norm));
  PDT_TRY(allow_smem(down_residual_b_kernel<T, Q, BM>, sm_ff));
  for (int l = 0; l < a.N; ++l) {
    T* ck = KV8 ? nullptr : static_cast<T*>(a.ck) + l * LBSD;
    T* cv = KV8 ? nullptr : static_cast<T*>(a.cv) + l * LBSD;
    qkv_rope_b_kernel<T, Q, KV8, BM><<<grid_qkv, kThreads, sm_norm, st>>>(
        a.pos, a.tok, emb, l == 0, h, in_norm + (size_t)l * D,
        layer_w<Q, T>(a.wq, l, LDD), layer_w<Q, T>(a.wk, l, LKD),
        layer_w<Q, T>(a.wv, l, LKD), layer_s(a.s_q, l, D),
        layer_s(a.s_k, l, Dkv), layer_s(a.s_v, l, Dkv), cos_t, sin_t, q, ck,
        cv, kv_new, B, D, Dkv, S, a.V);
    PDT_CHECK();
    if constexpr (KV8) {
      attention_kv8_kernel<<<dim3(H, nsplit, B), kThreads, sm_attn, st>>>(
          a.pos, a.starts, q, kv_new, static_cast<int8_t*>(a.ck) + l * LBSD,
          static_cast<int8_t*>(a.cv) + l * LBSD, a.sk + l * LBS,
          a.sv + l * LBS, part_m, part_l, part_acc, B, D, Dkv, group, hd, S,
          a.scale);
    } else {
      attention_b_kernel<T><<<dim3(H, nsplit, B), kThreads, sm_attn, st>>>(
          a.pos, a.starts, q, ck, cv, part_m, part_l, part_acc, D, Dkv, group,
          hd, S, a.scale);
    }
    PDT_CHECK();
    attn_out_b_kernel<T, Q, BM><<<grid_d, kThreads, sm_norm, st>>>(
        a.pos, a.starts, part_m, part_l, part_acc, nsplit, H, hd,
        layer_w<Q, T>(a.wo, l, LDD), layer_s(a.s_o, l, D), h, B, D, S);
    PDT_CHECK();
    gate_up_b_kernel<T, Q, BM><<<grid_f, kThreads, sm_norm, st>>>(
        h, post_norm + (size_t)l * D, layer_w<Q, T>(a.gate_w, l, LFD),
        layer_w<Q, T>(a.up_w, l, LFD), layer_s(a.s_gate, l, F),
        layer_s(a.s_up, l, F), ff, B, D, F);
    PDT_CHECK();
    down_residual_b_kernel<T, Q, BM><<<grid_d, kThreads, sm_ff, st>>>(
        ff, F, layer_w<Q, T>(a.down_w, l, LFD), layer_s(a.s_down, l, D), h,
        B, D);
    PDT_CHECK();
  }
  PDT_TRY((launch_head<T, HQ>(
      h, static_cast<const T*>(a.final_norm), a.head_w, a.head_s,
      static_cast<const T*>(a.head_b), tile_val, tile_idx, a.logits, B, D,
      a.V, st)));
  if (a.logits == nullptr)
    argmax_kernel<<<B, kThreads, 0, st>>>(tile_val, tile_idx, ntiles, a.out);
  return cudaGetLastError();
}

// the smallest register tile of rows that holds a group of min(B, 32) rows
template <typename T, int Q, int HQ, bool KV8>
cudaError_t run_b(const Args& a, cudaStream_t st) {
  if (a.B <= 4) return run<T, Q, HQ, KV8, 4>(a, st);
  if (a.B <= 8) return run<T, Q, HQ, KV8, 8>(a, st);
  if (a.B <= 16) return run<T, Q, HQ, KV8, 16>(a, st);
  return run<T, Q, HQ, KV8, kRowGroup>(a, st);
}

// the modes of the module doc: (layers, head) formats (0, 0), (0, 1),
// (1, 1), (2, 2), and the int8 KV cache with (0, 0)
template <typename T>
cudaError_t run_mode(int lfmt, int hfmt, int kv8, const Args& a,
                     cudaStream_t st) {
  if (kv8)
    return lfmt == 0 && hfmt == 0
               ? run_b<T, kFmtFloat, kFmtFloat, true>(a, st)
               : cudaErrorInvalidValue;
  switch (lfmt * 3 + hfmt) {
    case 0: return run_b<T, kFmtFloat, kFmtFloat, false>(a, st);
    case 1: return run_b<T, kFmtFloat, kFmtInt8, false>(a, st);
    case 4: return run_b<T, kFmtInt8, kFmtInt8, false>(a, st);
    case 8: return run_b<T, kFmtInt4, kFmtInt4, false>(a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
