// One greedy B=1 Llama decode step on NVIDIA Hopper (sm_90a), and the
// greedy head alone.
//
// Replaces the Pallas TPU kernels `_token_kernel`
// (pydynet_tpu/ops/decode_step.py:160, launched by `fused_decode_token`
// at :1346; K1) and `_lm_head_kernel` (:102, launched by `lm_head_argmax`
// at :129; K9, the head of an h given as it is, without the final RMSNorm
// and without rounding h to the weights' type: `head_tile` in common.cuh).
// K1 computes the same step:
// gather emb[tok]; per layer RMSNorm, q/k/v, interleaved RoPE, the K/V row
// write at pos (clamped to S-1), causal online-softmax attention over rows
// [0, pos], wo + residual, RMSNorm, SwiGLU + residual; then the final
// RMSNorm, the lm_head GEMV + bias and a greedy argmax whose ties go to the
// lowest index. The TPU layout tricks (128-lane padding, 16-row
// read-modify-write cache tiles, head-mask and pair-swap matmuls, scalar
// prefetch) are gone: weights are (out, in) rows so a warp reads one row as
// contiguous bytes, and caches are (N, S, Dkv). Dkv = D for MHA; in the TPU
// kernel's `narrow` mode (a grouped-query model, :201-206 there) Dkv =
// Hkv * head_dim and query head h reads KV head h / (H / Hkv), which the TPU
// kernel does through its 0/1 expansion matrix `egqa`: here the attention
// block of head h just reads that head's columns, so the cache is streamed
// at its narrow width.
//
// One token is a chain of 5 * n_layers + 2 launches on the caller's stream:
//   1. RMSNorm + q/k/v GEMV + RoPE + K/V row write (each block renormalises
//      the D-wide residual itself; layer 0 gathers the embedding row),
//   2. attention split over (head, 64-row block of the cache): each block
//      writes its softmax partial (max, sum, p @ V),
//   3. the online-softmax merge of those partials + wo GEMV + residual,
//   4. RMSNorm + gate/up GEMV + SiLU * up,
//   5. down GEMV + residual,
// then 6. final RMSNorm + head product + bias with a (max, index) pair per
// 128-row vocab block: K2's head stage on a group of one row (head.cuh, on
// the tensor cores), so K1's logits are the bits K2 gives that row; and
// 7. a one-block argmax over the blocks (K9 is head_tile's CUDA-core head
// on h as given, then 7; both keep the tie rule). In the TPU kernel's
// `emit_logits` mode (the sampled decode's, ops/decode_step.py:487-491
// there) stage 6 also writes each vocab row's f32 logit, bias added and
// int8/int4 scale applied by the very arithmetic the argmax compares, to a
// (V,) output, and 7 is not launched: 5 * n_layers + 1 launches. `pos`
// and `tok` are read from device memory, so no step syncs with the host and
// the chain can later be captured in a CUDA graph.
//
// What bounds it on an H100: at stories15M width (D 288, F 768, 6 layers,
// V 32000) a token reads about 12 MB of bf16 layer weights, 18.4 MB of bf16
// head (9.2 MB as int8) and up to about 7 MB of KV at pos 1023: about 10 us
// of traffic at 3.35 TB/s. A chain of 32 launches costs more than that, so
// the step is bound by launch latency. The design spreads each launch over
// many SMs (attention over heads x row blocks, GEMVs a warp per row with
// 16-byte loads) so that each is short; capturing the chain in a CUDA graph,
// then fusing launches, comes later.
//
// Types: the residual stream is f32; every matmul input is rounded to the
// weight type T (f32 or bf16) and accumulated in f32; the caches are T.
// Quantized weights (the TPU kernel's `qhead`, `qlayers` and `q4` modes):
// the int8 head, int8 layers with the int8 head, or int4 layers with the
// int4 head. Each of their matmuls quantizes its f32 activation vector per
// block (the normed h for q/k/v, the attention output for wo, the normed z
// for gate/up, the SwiGLU output for down, the final normed h for the head;
// none rounded to T first), accumulates exactly in int32 and rescales by
// its weight row's scale times amax / 127, as the TPU kernel's qvec/qmm do.

#include "common.cuh"
#include "head.cuh"

namespace {

// 1. RMSNorm + q/k/v + RoPE + K/V row write. A warp owns one (even, odd)
// feature pair of the concatenated [q (D); k (Dkv); v (Dkv)] rows, so RoPE
// needs no exchange between warps. k's pair j < Dkv is rotated by column j
// of the (S, D) tables (the pattern repeats per head) and written to the
// Dkv-wide cache row.
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
qkv_rope_kernel(const int* __restrict__ pos_p, const int* __restrict__ tok_p,
                const T* __restrict__ emb, int first, float* __restrict__ h,
                const T* __restrict__ in_norm, const void* __restrict__ wq,
                const void* __restrict__ wk, const void* __restrict__ wv,
                const float* __restrict__ s_q, const float* __restrict__ s_k,
                const float* __restrict__ s_v, const T* __restrict__ cos_t,
                const T* __restrict__ sin_t, float* __restrict__ q_out,
                T* __restrict__ ck, T* __restrict__ cv, int D, int Dkv,
                int S, int V) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  const int pos = min(*pos_p, S - 1);
  float sx;
  if (first) {
    const int tok = min(max(*tok_p, 0), V - 1);
    const T* e = emb + (size_t)tok * D;
    sx = load_normed_act<Q, T>(e, in_norm, D, x_s, red);
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < D; i += blockDim.x) h[i] = to_f(e[i]);
  } else {
    sx = load_normed_act<Q, T>(h, in_norm, D, x_s, red);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npairs = D / 2 + Dkv;
  for (int p = blockIdx.x * kWarps + warp; p < npairs;
       p += gridDim.x * kWarps) {
    const int f = 2 * p;  // 0 q, 1 k, 2 v; j: the feature in its rows
    const int which = f < D ? 0 : (f < D + Dkv ? 1 : 2);
    const int j = which == 0 ? f : f - D - (which - 1) * Dkv;
    const void* w = which == 0 ? wq : (which == 1 ? wk : wv);
    const float* sc = which == 0 ? s_q : (which == 1 ? s_k : s_v);
    float a = row_dot<Q, T>(w, j, x_s, D, sc, sx);
    float b = row_dot<Q, T>(w, j + 1, x_s, D, sc, sx);
    if (lane == 0) {
      const size_t r = (size_t)pos * D + j;
      if (which < 2) {  // rotate the interleaved pair (2i, 2i+1)
        const float ra = a * to_f(cos_t[r]) - b * to_f(sin_t[r]);
        const float rb = b * to_f(cos_t[r + 1]) + a * to_f(sin_t[r + 1]);
        a = ra;
        b = rb;
      }
      if (which == 0) {
        q_out[j] = a;
        q_out[j + 1] = b;
      } else {
        T* c = (which == 1 ? ck : cv) + (size_t)pos * Dkv + j;
        c[0] = from_f<T>(a);
        c[1] = from_f<T>(b);
      }
    }
  }
}

// 2. Attention of one query head (blockIdx.x) over one block of kAttnRows
// cache rows (blockIdx.y) within [0, pos]: four threads score a row, one
// warp takes the block's max and sum of exp, then threads split as
// (feature d, row group g) to accumulate p @ V. Query head h reads KV head
// h / group of the Dkv-wide cache rows (group 1: MHA). The block writes its
// partial (max m, sum l, p @ V) for attn_out_kernel's merge; blocks past
// pos write nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const int* __restrict__ pos_p, const float* __restrict__ q,
                 const T* __restrict__ ck, const T* __restrict__ cv,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int Dkv, int group, int hd,
                 int S, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;             // hd
  float* p_s = q_s + hd;         // kAttnRows
  float* part = p_s + kAttnRows; // kThreads
  float* ml = part + kThreads;   // 2
  const int head = blockIdx.x, tid = threadIdx.x;
  const int n = min(*pos_p, S - 1) + 1;
  const int r0 = blockIdx.y * kAttnRows;
  if (r0 >= n) return;
  const int len = min(kAttnRows, n - r0);
  for (int d = tid; d < hd; d += blockDim.x)
    q_s[d] = round_to<T>(q[head * hd + d]);
  __syncthreads();
  const T* kb = ck + (size_t)r0 * Dkv + (head / group) * hd;
  const T* vb = cv + (size_t)r0 * Dkv + (head / group) * hd;
  {  // scores: threads (4 row, sub) with sub = tid % 4 in one warp
    constexpr int kTpr = kThreads / kAttnRows;
    const int row = tid / kTpr, sub = tid % kTpr;
    const int seg = (hd + kTpr - 1) / kTpr;
    float dot = 0.f;
    if (row < len) {
      const T* k = kb + (size_t)row * Dkv;
      for (int e = sub * seg; e < min(hd, sub * seg + seg); ++e)
        dot += to_f(k[e]) * q_s[e];
    }
    for (int o = 1; o < kTpr; o <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (sub == 0) p_s[row] = row < len ? dot * scale : -INFINITY;
  }
  __syncthreads();
  if (tid < 32) {  // one warp: max, exp, sum over the 64 scores
    const float a = p_s[tid], b = p_s[tid + 32];
    const float m = warp_max(fmaxf(a, b));
    const float pa = expf(a - m), pb = expf(b - m);  // exp(-inf) = 0
    p_s[tid] = pa;
    p_s[tid + 32] = pb;
    const float l = warp_sum(pa + pb);
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
    for (int r = g; r < len; r += groups)
      pv += p_s[r] * to_f(vb[(size_t)r * Dkv + d]);
  part[tid] = pv;
  __syncthreads();
  const int slot = head * gridDim.y + blockIdx.y;
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

// 3. Merge the attention partials of every head (online-softmax rescale to
// the common max) into the D-wide result, the matmul input of wo (rounded
// to T, or quantized), then wo GEMV + residual. Each block redoes the small
// merge so that no extra launch is needed.
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
attn_out_kernel(const int* __restrict__ pos_p,
                const float* __restrict__ part_m,
                const float* __restrict__ part_l,
                const float* __restrict__ part_acc, int nsplit, int hd,
                const void* __restrict__ wo, const float* __restrict__ s_o,
                float* __restrict__ h, int D, int S) {
  extern __shared__ float smem[];
  float* x_s = smem;
  float* red = smem + D;
  const int n = min(*pos_p, S - 1) + 1;
  const int used = (n + kAttnRows - 1) / kAttnRows;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const int head = i / hd, d = i - head * hd;
    const int base = head * nsplit;
    float m = -INFINITY;
    for (int s = 0; s < used; ++s) m = fmaxf(m, part_m[base + s]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < used; ++s) {
      const float c = expf(part_m[base + s] - m);
      num += c * part_acc[(size_t)(base + s) * hd + d];
      den += c * part_l[base + s];
    }
    x_s[i] = num / fmaxf(den, 1e-30f);
  }
  const float sx = prepare_act<Q, T>(x_s, D, red);
  gemv_residual<Q, T>(x_s, D, wo, s_o, sx, h, D);
}

// K9: the head of h (1, D) alone, h as it is (f32 or bf16, widened to f32,
// not rounded to the weights' type: jnp.dot promotes both to f32)
template <typename H, typename W>
__global__ void __launch_bounds__(kThreads)
lm_head_kernel(const H* __restrict__ h, const W* __restrict__ w,
               const W* __restrict__ b, float* __restrict__ tile_val,
               int* __restrict__ tile_idx, int D, int V) {
  extern __shared__ float x_s[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) x_s[i] = to_f(h[i]);
  __syncthreads();
  head_tile<kFmtFloat, W>(x_s, 1.f, w, nullptr, b, tile_val, tile_idx, D, V);
}

struct Args {
  const int* pos;
  const int* tok;
  int* out;
  float* logits;  // emit_logits: the (V,) f32 logits instead of out
  const void *emb, *cos, *sin, *final_norm;
  const void *wq, *wk, *wv, *wo, *gate_w, *up_w, *down_w;
  const void *in_norm, *post_norm, *head_w;
  const float* head_s;
  const void* head_b;
  const float *s_q, *s_k, *s_v, *s_o, *s_gate, *s_up, *s_down;
  void *ck, *cv;
  float* scratch;
  int N, D, H, Hkv, F, V, S;
  float scale;
};

// Q: the layers' format, HQ: the head's
template <typename T, int Q, int HQ>
cudaError_t run(const Args& a, cudaStream_t st) {
  const int D = a.D, F = a.F, S = a.S, hd = a.D / a.H, Dkv = a.Hkv * hd;
  const int ntiles = head_blocks(a.V);
  const int nsplit = attn_splits(S);
  float* h = a.scratch;
  float* q = h + D;
  float* ff = q + D;
  float* tile_val = ff + F;
  int* tile_idx = reinterpret_cast<int*>(tile_val + ntiles);
  float* part_m = tile_val + 2 * ntiles;
  float* part_l = part_m + a.H * nsplit;
  float* part_acc = part_l + a.H * nsplit;
  const T* emb = static_cast<const T*>(a.emb);
  const T* cos_t = static_cast<const T*>(a.cos);
  const T* sin_t = static_cast<const T*>(a.sin);
  const T* in_norm = static_cast<const T*>(a.in_norm);
  const T* post_norm = static_cast<const T*>(a.post_norm);
  T* ck = static_cast<T*>(a.ck);
  T* cv = static_cast<T*>(a.cv);
  const size_t LDD = (size_t)D * D, LKD = (size_t)Dkv * D;
  const size_t LFD = (size_t)F * D, LSD = (size_t)S * Dkv;

  const int grid_qkv = (D / 2 + Dkv + kWarps - 1) / kWarps;
  const int grid_d = (D + kWarps - 1) / kWarps;
  const int grid_f = (F + kWarps - 1) / kWarps;
  const size_t sm_norm = (size_t)(D + kWarps) * sizeof(float);
  const size_t sm_ff = (size_t)(F + kWarps) * sizeof(float);
  const size_t sm_attn = (size_t)(hd + kAttnRows + kThreads + 2) *
                         sizeof(float);
  for (int l = 0; l < a.N; ++l) {
    qkv_rope_kernel<T, Q><<<grid_qkv, kThreads, sm_norm, st>>>(
        a.pos, a.tok, emb, l == 0, h, in_norm + (size_t)l * D,
        layer_w<Q, T>(a.wq, l, LDD), layer_w<Q, T>(a.wk, l, LKD),
        layer_w<Q, T>(a.wv, l, LKD), layer_s(a.s_q, l, D),
        layer_s(a.s_k, l, Dkv), layer_s(a.s_v, l, Dkv), cos_t, sin_t, q,
        ck + l * LSD, cv + l * LSD, D, Dkv, S, a.V);
    PDT_CHECK();
    attention_kernel<T><<<dim3(a.H, nsplit), kThreads, sm_attn, st>>>(
        a.pos, q, ck + l * LSD, cv + l * LSD, part_m, part_l, part_acc, Dkv,
        a.H / a.Hkv, hd, S, a.scale);
    PDT_CHECK();
    attn_out_kernel<T, Q><<<grid_d, kThreads, sm_norm, st>>>(
        a.pos, part_m, part_l, part_acc, nsplit, hd,
        layer_w<Q, T>(a.wo, l, LDD), layer_s(a.s_o, l, D), h, D, S);
    PDT_CHECK();
    gate_up_kernel<T, Q><<<grid_f, kThreads, sm_norm, st>>>(
        h, post_norm + (size_t)l * D, layer_w<Q, T>(a.gate_w, l, LFD),
        layer_w<Q, T>(a.up_w, l, LFD), layer_s(a.s_gate, l, F),
        layer_s(a.s_up, l, F), ff, D, F);
    PDT_CHECK();
    down_residual_kernel<T, Q><<<grid_d, kThreads, sm_ff, st>>>(
        ff, F, layer_w<Q, T>(a.down_w, l, LFD), layer_s(a.s_down, l, D), h,
        D);
    PDT_CHECK();
  }
  const cudaError_t e = launch_head<T, HQ>(
      h, static_cast<const T*>(a.final_norm), a.head_w, a.head_s,
      static_cast<const T*>(a.head_b), tile_val, tile_idx, a.logits, 1, D,
      a.V, st);
  if (e != cudaSuccess) return e;
  if (a.logits == nullptr)
    argmax_kernel<<<1, kThreads, 0, st>>>(tile_val, tile_idx, ntiles, a.out);
  return cudaGetLastError();
}

template <typename H, typename W>
cudaError_t run_head(const void* h, const void* w, const void* b, int* out,
                     float* scratch, int D, int V, cudaStream_t st) {
  const int ntiles = head_tiles(V);
  float* tile_val = scratch;
  int* tile_idx = reinterpret_cast<int*>(scratch + ntiles);
  lm_head_kernel<H, W><<<ntiles, kThreads, D * sizeof(float), st>>>(
      static_cast<const H*>(h), static_cast<const W*>(w),
      static_cast<const W*>(b), tile_val, tile_idx, D, V);
  PDT_CHECK();
  argmax_kernel<<<1, kThreads, 0, st>>>(tile_val, tile_idx, ntiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper allocates for one step: h, q (D each), ff
// (F), a (max, index) pair per head block, and the attention partials (m, l
// and a head_dim vector per head and row block).
int pdt_decode_token_scratch_floats(int dim, int n_heads, int ffn, int vocab,
                                    int seq) {
  return 2 * dim + ffn + 2 * head_blocks(vocab) +
         attn_splits(seq) * (2 * n_heads + dim);
}

// wdtype 0: float32 weights and caches, 1: bfloat16. lfmt / hfmt: the
// formats of the layer matmuls and of the head (0 the weight type, 1 int8,
// 2 int4 packed along the contraction axis), one of (0, 0), (0, 1), (1, 1),
// (2, 2); a quantized matrix has float32 scales per output row: head_s
// (V,), s_q .. s_down (N, out). With `logits` non-null (the emit_logits
// mode) the step writes the (V,) f32 logits there and launches no argmax
// (`out` is not written); else the greedy token goes to out[0]. Returns
// the CUDA error of the first launch that failed, or cudaSuccess.
// n_kv_heads < n_heads (the narrow mode, a grouped-query model): wk, wv are
// (N, Hkv * head_dim, D) and the caches (N, S, Hkv * head_dim), query head h
// reading KV head h / (n_heads / n_kv_heads); float layers only.
int pdt_decode_token(int wdtype, int lfmt, int hfmt, const void* pos,
                     const void* tok, void* out, void* logits,
                     const void* emb,
                     const void* cos, const void* sin, const void* final_norm,
                     const void* wq, const void* wk, const void* wv,
                     const void* wo, const void* gate_w, const void* up_w,
                     const void* down_w, const void* in_norm,
                     const void* post_norm, const void* head_w,
                     const void* head_s, const void* head_b, const void* s_q,
                     const void* s_k, const void* s_v, const void* s_o,
                     const void* s_gate, const void* s_up,
                     const void* s_down, void* ck, void* cv, void* scratch,
                     int n_layers, int dim, int n_heads, int n_kv_heads,
                     int ffn, int vocab, int seq, float scale,
                     void* stream) {
  if (n_kv_heads < 1 || n_heads % n_kv_heads != 0 ||
      (n_kv_heads != n_heads && lfmt != 0))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{static_cast<const int*>(pos),
         static_cast<const int*>(tok),
         static_cast<int*>(out),
         static_cast<float*>(logits),
         emb, cos, sin, final_norm,
         wq, wk, wv, wo, gate_w, up_w, down_w,
         in_norm, post_norm, head_w, f(head_s), head_b,
         f(s_q), f(s_k), f(s_v), f(s_o), f(s_gate), f(s_up), f(s_down),
         ck, cv,
         static_cast<float*>(scratch),
         n_layers, dim, n_heads, n_kv_heads, ffn, vocab, seq, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mode = lfmt * 3 + hfmt;
  if (wdtype == 0) {
    switch (mode) {
      case 0: return run<float, kFmtFloat, kFmtFloat>(a, st);
      case 1: return run<float, kFmtFloat, kFmtInt8>(a, st);
      case 4: return run<float, kFmtInt8, kFmtInt8>(a, st);
      case 8: return run<float, kFmtInt4, kFmtInt4>(a, st);
    }
  } else if (wdtype == 1) {
    using bf = __nv_bfloat16;
    switch (mode) {
      case 0: return run<bf, kFmtFloat, kFmtFloat>(a, st);
      case 1: return run<bf, kFmtFloat, kFmtInt8>(a, st);
      case 4: return run<bf, kFmtInt8, kFmtInt8>(a, st);
      case 8: return run<bf, kFmtInt4, kFmtInt4>(a, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// Floats of scratch for lm_head_argmax: a (max, index) pair per head tile.
int pdt_lm_head_argmax_scratch_floats(int vocab) {
  return 2 * head_tiles(vocab);
}

// K9: out[0] = argmax over v < V of dot(h, w[v]) + b[v] (ties to the lowest
// v), h (D,) of type hdtype, w (V, D) and b (V,) of type wdtype (0 float32,
// 1 bfloat16), f32 accumulation.
int pdt_lm_head_argmax(int hdtype, int wdtype, const void* h, const void* w,
                       const void* b, void* out, void* scratch, int dim,
                       int vocab, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  float* sc = static_cast<float*>(scratch);
  switch (hdtype * 2 + wdtype) {
    case 0: return run_head<float, float>(h, w, b, o, sc, dim, vocab, st);
    case 1: return run_head<float, bf>(h, w, b, o, sc, dim, vocab, st);
    case 2: return run_head<bf, float>(h, w, b, o, sc, dim, vocab, st);
    case 3: return run_head<bf, bf>(h, w, b, o, sc, dim, vocab, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
