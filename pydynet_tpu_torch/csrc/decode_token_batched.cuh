// The decode step's stage kernels and launch chain (K2, and K1 on a group
// of one row; see decode_token_batched.cu for what it computes and why).
// Included by decode_token_batched.cu, which instantiates the chain for
// float32 weights and holds K2's C entry points, by
// decode_token_batched_bf16.cu, which instantiates it for bfloat16 weights
// (nvcc compiles the two at once, each with half of the modes' template
// instances), by decode_token.cu, whose K1 entry point runs the same
// instances at B = 1, and by decode_step.cu, whose K10 chain runs the wo,
// gate/up and down stages (float formats) on its one row.
#pragma once

#include "common.cuh"
#include "head.cuh"

namespace pdt_k2 {

// A step's arguments (pdt_decode_token_batched's; K1's with B = 1, no
// starts and no int8 KV cache)
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

// run_mode<float>, defined in decode_token_batched.cu, and
// run_mode<__nv_bfloat16>, in decode_token_batched_bf16.cu
int run_f32(int lfmt, int hfmt, int kv8, const Args& a, cudaStream_t st);
int run_bf16(int lfmt, int hfmt, int kv8, const Args& a, cudaStream_t st);

}  // namespace pdt_k2

namespace {

constexpr int kRowGroup = 32;  // rows a block takes (blockIdx.y: the group)
constexpr int kMaxSmem = 232448;  // bytes a block may opt in to on sm_90
constexpr int kLayerRows = 16;    // weight rows of a layer-stage block
constexpr int kMaxHeadDim = kThreads;  // ops/decode_step.py's _heads_take

// Floats of scratch for one step of B rows: h, q, the merged attention
// output (B x D each), ff (B x F), a (max, index) pair per row and head
// block, the attention partials (m, l and a head_dim vector per row, head
// and 64-row cache block), the new K and V rows of the int8 KV cache
// (2 x B x D) and a merge counter per row and head (ints).
inline int scratch_floats(int B, int D, int H, int F, int V, int S) {
  return B * (5 * D + F + 2 * head_blocks(V) +
              attn_splits(S) * (2 * H + D) + H);
}

// Dynamic shared memory of a layer-stage block of MT weight tiles whose
// rows are K wide, for a group of up to G rows: each warp's cp.async ring
// of kTileStages stages of MT x 16 rows x 64 bytes (the warps' partial sums
// reuse it), then the G activation rows (mma_rows.cuh's act_rows).
// ops/decode_step.py's layer_smem_bytes mirrors it.
template <int Q, typename T>
__host__ __device__ __forceinline__ size_t layer_smem(int K, int G, int MT) {
  return (size_t)kWarps * kTileStages * MT * kLayerRows * kTileStageBytes +
         (size_t)act_rows<Q, T>(K).stride * G;
}

// Dynamic shared memory of a block of the stages that normalise their rows
// (q/k/v, gate/up): layer_smem, then the G raw rows (at most 4 bytes an
// element) and the K norm weights, copied in by cp.async (stage_norm_rows).
// ops/decode_step.py's layer_smem_bytes(norm_itemsize=) mirrors it.
template <int Q, typename T>
__host__ __device__ __forceinline__ size_t norm_smem(int K, int G, int MT) {
  return layer_smem<Q, T>(K, G, MT) + (size_t)G * K * 4 +
         ((size_t)K * sizeof(T) + 15) / 16 * 16;
}

// Copy G rows of K values (row b at src + t * K, t = tok[b] clipped to
// [0, V), or t = b without `tok`) to raw, and the K norm weights w to w_s,
// by cp.async from all threads, every copy in flight at once; the caller
// commits them and synchronises. The rows are whole 4-byte words (float32
// rows, or D even); weights that are not (a bfloat16 layer's at odd D) are
// copied element by element past their last aligned word.
template <typename S, typename T>
__device__ void stage_norm_rows(const S* src, const int* tok, int V,
                                const T* w, int K, int G, S* raw, T* w_s) {
  const int rb = K * (int)sizeof(S), wb = K * (int)sizeof(T);
  const int wide = rb % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 ? 16 : 4;
  for (int i = threadIdx.x; i < G * (rb / wide); i += kThreads) {
    const int b = i / (rb / wide), c = i % (rb / wide);
    const int t = tok == nullptr ? b : min(max(tok[b], 0), V - 1);
    const char* from = reinterpret_cast<const char*>(src + (size_t)t * K);
    const unsigned to = smem_u32(reinterpret_cast<char*>(raw) + b * rb);
    if (wide == 16)
      cp_async16(to + 16 * c, from + 16 * c, 16);
    else
      cp_async4(to + 4 * c, from + 4 * c, 4);
  }
  const int ww = reinterpret_cast<uintptr_t>(w) % 4 == 0 ? wb / 4 : 0;
  for (int c = threadIdx.x; c < ww; c += kThreads)
    cp_async4(smem_u32(reinterpret_cast<char*>(w_s) + 4 * c),
              reinterpret_cast<const char*>(w) + 4 * c, 4);
  for (int i = 4 * ww / (int)sizeof(T) + threadIdx.x; i < K; i += kThreads)
    w_s[i] = w[i];
}

// The rows a block of a step of B rows takes: group blockIdx.y, rows
// [b0, b0 + count) with b0 = 32 * blockIdx.y
struct RowGroup {
  int b0, count;
  __device__ explicit RowGroup(int B)
      : b0(blockIdx.y * kRowGroup), count(min(kRowGroup, B - b0)) {}
};

// Row b's attention lower bound: starts[b] (0 without starts), at most p
__device__ __forceinline__ int row_start(const int* starts, int b, int p) {
  return starts == nullptr ? 0 : min(max(starts[b], 0), p);
}

// A layer-stage block's product: MT weight tiles of 16 rows (tile t's rows
// w[t] + r * fmt_bytes(K) for r < nrows[t], zero past them) times the
// group's G activation rows, K wide, weights of format Q. Warp w takes the
// 64-byte stages w, w + 8, w + 16, ... of every tile through its own
// kTileStages-deep cp.async ring, so the block reads its tiles once with
// all its warps' loads in flight and no barrier between stages. `stage`
// issues cp.async copies of the rows: without PDL before the ring's first
// stages, as cp.async group 0 (cp_async_wait<kTileStages - 1> waits for
// it); with PDL (a kernel of a chain of programmatic launches) after them
// and after the wait for the kernel before (pdl_wait), so that the
// weights' copies overlap that kernel, as the last group
// (cp_async_wait<0>). `fill` (all threads, ending synchronised) makes the
// activation rows at `act`. The warps' sums are left in
// `smem` (tile_sum reads them); ends synchronised. No part of the split
// depends on G.
template <int Q, typename T, int MT, int NT, bool PDL, typename Stage,
          typename Fill>
__device__ void layer_product(const unsigned char* const (&w)[MT],
                              const int (&nrows)[MT], int K, ActRows a,
                              int G, unsigned char* smem,
                              const unsigned char* act, Stage stage,
                              Fill fill) {
  constexpr int kTile = kLayerRows * kTileStageBytes;
  constexpr int kSlot = MT * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (int)fmt_bytes<Q, T>(K);  // bytes a weight row
  const int nst = (rb + kTileStageBytes - 1) / kTileStageBytes;
  int vec = 16;
#pragma unroll
  for (int t = 0; t < MT; ++t) vec = min(vec, tile_vec(w[t], rb));
  unsigned char* ring = smem + warp * kTileStages * kSlot;
  const int nj = warp < nst ? (nst - warp + kWarps - 1) / kWarps : 0;
  auto load = [&](int j) {  // the warp's j-th stage into its ring
    unsigned char* slot = ring + (j % kTileStages) * kSlot;
#pragma unroll
    for (int t = 0; t < MT; ++t)
      tile_stage<kLayerRows>(slot + t * kTile, w[t], nrows[t], rb,
                             warp + kWarps * j, vec, lane, 32);
  };
  if constexpr (!PDL) {
    stage();
    cp_async_commit();  // group 0: the rows `stage` copies, if any
  }
#pragma unroll
  for (int j = 0; j < kTileStages - 1; ++j) {
    if (j < nj) load(j);
    cp_async_commit();
  }
  if constexpr (PDL) {  // the weights depend on no earlier kernel
    pdl_wait();
    pdl_launch();
    stage();
    cp_async_commit();
  }
  fill();
  MmaAcc<Q> acc[MT][NT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0;
  for (int j = 0; j < nj; ++j) {
    cp_async_wait<kTileStages - 2>();
    __syncwarp();  // stage j is in; the warp is done with stage j - 1
    if (j + kTileStages - 1 < nj) load(j + kTileStages - 1);
    cp_async_commit();
    const unsigned char* slot = ring + (j % kTileStages) * kSlot;
#pragma unroll
    for (int t = 0; t < MT; ++t)
      mma_stage<Q, T, NT>(acc[t], slot + t * kTile, act, a, G,
                          (warp + kWarps * j) * kTileStageBytes);
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring is consumed: the partial sums reuse them
  static_assert(NT * 4 * 32 * kWarps * 4 <= kTileStages * kTile * kWarps,
                "the warps' partial sums fit in the rings");
  MmaAcc<Q>* part = reinterpret_cast<MmaAcc<Q>*>(smem);
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(((warp * MT + t) * NT + n) * 4 + e) * 32 + lane] = acc[t][n][e];
  __syncthreads();
}

// Tile t's sum at (weight row r, group row b) over the warps' shares, in
// warp order: fragment e = 2 (r >> 3) + (b & 1) of lane 4 (r & 7) +
// ((b & 7) >> 1) in n8 tile b >> 3
template <int Q, int MT, int NT>
__device__ __forceinline__ MmaAcc<Q> tile_sum(const unsigned char* smem,
                                              int t, int r, int b) {
  const MmaAcc<Q>* part = reinterpret_cast<const MmaAcc<Q>*>(smem);
  const int n = b >> 3, c = b & 7;
  const int lane = 4 * (r & 7) + (c >> 1), e = 2 * (r >> 3) + (c & 1);
  MmaAcc<Q> s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    s += part[(((w * MT + t) * NT + n) * 4 + e) * 32 + lane];
  return s;
}

// 1. RMSNorm + q/k/v + RoPE + K/V row write for one group of rows, layer
// weights of format Q. Block x takes 16 rows of wq (x < ceil(D / 16)), of
// wk or of wv, so RoPE's (even, odd) pairs stay in the block; k's pair
// j < Dkv is rotated by column j of the (S, D) tables (the pattern repeats
// per head). Layer 0 gathers the embedding rows (block 0 writes them to h).
// h, q_out: (B, D) f32; ck, cv: the layer's (B, S, Dkv) T caches, or with
// KV8 (the int8 KV cache) kv_out: the f32 K rows (B, Dkv) then the V rows
// (B, Dkv), which the attention stage quantizes. Block 0 also zeroes the
// group's attention merge counters (B, H) for this layer.
template <typename T, int Q, bool KV8, int NT>
__global__ void __launch_bounds__(kThreads)
layer_qkv_kernel(const int* __restrict__ pos_p, const int* __restrict__ tok,
                 const T* __restrict__ emb, int first, float* __restrict__ h,
                 const T* __restrict__ in_norm, const void* __restrict__ wq,
                 const void* __restrict__ wk, const void* __restrict__ wv,
                 const float* __restrict__ s_q, const float* __restrict__ s_k,
                 const float* __restrict__ s_v, const T* __restrict__ cos_t,
                 const T* __restrict__ sin_t, float* __restrict__ q_out,
                 T* __restrict__ ck, T* __restrict__ cv,
                 float* __restrict__ kv_out, int* __restrict__ merge_cnt,
                 int B, int D, int Dkv, int H, int S, int V) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[NT * 8];
  const RowGroup g(B);
  const int G = g.count;
  tok += g.b0;
  h += (size_t)g.b0 * D;
  q_out += (size_t)g.b0 * D;
  const int pos = min(*pos_p, S - 1);
  const int tq = (D + kLayerRows - 1) / kLayerRows;
  const int tk = (Dkv + kLayerRows - 1) / kLayerRows;
  const int x = blockIdx.x;
  const int which = x < tq ? 0 : (x < tq + tk ? 1 : 2);  // 0 q, 1 k, 2 v
  const int row0 = kLayerRows * (x - (which == 0 ? 0 : tq + (which - 1) * tk));
  const int rows = which == 0 ? D : Dkv;
  const void* wm = which == 0 ? wq : (which == 1 ? wk : wv);
  const float* sc = which == 0 ? s_q : (which == 1 ? s_k : s_v);
  const ActRows a = act_rows<Q, T>(D);
  unsigned char* act = smem_u8 + layer_smem<Q, T>(D, 0, 1);
  const unsigned char* wt[1] = {static_cast<const unsigned char*>(wm) +
                                fmt_bytes<Q, T>((size_t)row0 * D)};
  const int nr[1] = {min(kLayerRows, rows - row0)};
  // this thread's output pair: group row b, rows (j, j + 1); its rotation
  // is read now, so the loads overlap the product
  static_assert(kRowGroup * kLayerRows / 2 <= kThreads, "a pair a thread");
  const int b = threadIdx.x / (kLayerRows / 2);
  const int r = 2 * (threadIdx.x % (kLayerRows / 2)), j = row0 + r;
  const bool mine = b < G && j < rows;
  float c0 = 1.f, s0 = 0.f, c1 = 1.f, s1 = 0.f;
  if (mine && which < 2) {
    const size_t c = (size_t)pos * D + j;
    c0 = to_f(cos_t[c]);
    s0 = to_f(sin_t[c]);
    c1 = to_f(cos_t[c + 1]);
    s1 = to_f(sin_t[c + 1]);
  }
  // the rows to normalise (layer 0: the embedding rows) and the norm
  // weights, staged in shared memory after the activation rows
  unsigned char* raw = smem_u8 + layer_smem<Q, T>(D, G, 1);
  T* w_s = reinterpret_cast<T*>(raw + (size_t)G * D * 4);
  auto stage = [&] {
    if (first)
      stage_norm_rows(emb, tok, V, in_norm, D, G,
                      reinterpret_cast<T*>(raw), w_s);
    else
      stage_norm_rows(h, nullptr, 0, in_norm, D, G,
                      reinterpret_cast<float*>(raw), w_s);
  };
  layer_product<Q, T, 1, NT, false>(wt, nr, D, a, G, smem_u8, act, stage,
                                    [&] {
    cp_async_wait<kTileStages - 1>();
    __syncthreads();
    if (first)
      load_act_rows<Q, T>(reinterpret_cast<const T*>(raw), nullptr, 0, w_s,
                          D, G, a, act, sx_s);
    else
      load_act_rows<Q, T>(reinterpret_cast<const float*>(raw), nullptr, 0,
                          w_s, D, G, a, act, sx_s);
  });
  if (x == 0) {
    if (first)
      for (int i = threadIdx.x; i < G * D; i += kThreads)
        h[i] = to_f(emb[(size_t)min(max(tok[i / D], 0), V - 1) * D + i % D]);
    for (int i = threadIdx.x; i < G * H; i += kThreads)
      merge_cnt[(size_t)g.b0 * H + i] = 0;
  }
  if (!mine) return;
  const float sx = Q == kFmtFloat ? 1.f : sx_s[b];
  float va = rescaled(tile_sum<Q, 1, NT>(smem_u8, 0, r, b), sc, j, sx);
  float vb = rescaled(tile_sum<Q, 1, NT>(smem_u8, 0, r + 1, b), sc, j + 1, sx);
  if (which < 2) {  // rotate the interleaved pair (2i, 2i+1), each
    // product and the sum rounded on their own as the plain version rounds
    // them (no fused multiply-add)
    const float ra = __fsub_rn(__fmul_rn(va, c0), __fmul_rn(vb, s0));
    const float rb = __fadd_rn(__fmul_rn(vb, c1), __fmul_rn(va, s1));
    va = ra;
    vb = rb;
  }
  const int row = g.b0 + b;  // in the whole batch
  if (which == 0) {
    q_out[(size_t)b * D + j] = va;
    q_out[(size_t)b * D + j + 1] = vb;
  } else if constexpr (KV8) {
    float* o = kv_out + ((size_t)(which - 1) * B + row) * Dkv + j;
    o[0] = va;
    o[1] = vb;
  } else {
    T* c = (which == 1 ? ck : cv) + ((size_t)row * S + pos) * Dkv + j;
    c[0] = from_f<T>(va);
    c[1] = from_f<T>(vb);
  }
}

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// Elements [e0, e0 + E) of a cache row of head_dim hd: one 16-byte load
// (`vec`: the rows and head_dim are 16-byte multiples), else element loads,
// elements past hd repeating element hd - 1 (the query's are zero there)
template <typename C, int E>
__device__ __forceinline__ void load_piece(const C* row, int e0, int hd,
                                           bool vec, C (&x)[E]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + e0);
    const C* e = reinterpret_cast<const C*>(&u);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = row[min(e0 + i, hd - 1)];
  }
}

// quantize_kv's scale of the W-wide f32 row x, taken by one warp:
// max(max |x| / 127, 1e-10), an IEEE division as the plain version's. A
// lane loads 8 values at a time before it uses them.
__device__ float warp_kv_scale(const float* x, int W) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
  for (int i0 = 0; i0 < W; i0 += 32 * 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < W ? fabsf(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) amax = fmaxf(amax, v[u]);
  }
  return fmaxf(__fdiv_rn(warp_max(amax), 127.f), 1e-10f);
}

// quantize_kv's value of x at scale s: clip(rint(x / s), -127, 127)
__device__ __forceinline__ float kv_quant(float x, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
}

// 2. Attention of row b (blockIdx.z), one query head (blockIdx.x), over one
// block of kAttnRows cache rows (blockIdx.y) clipped to [starts[b], pos];
// query head h reads KV head h / group of row b's Dkv-wide cache, head_dim
// hd <= HD. A row is spread over a quad of lanes along head_dim, each lane
// with every fourth 16-byte piece of its K and V rows, so a warp takes its
// 8 rows of the block at once, and a lane issues all its loads before it
// uses any: one trip to memory a block. The query head is staged in shared
// memory (with KV8 quantized once there). The warp keeps its own
// online-softmax state (max, sum, p @ V), and the 8 states merge in warp
// order into the block's partial. The last block of a (row, head) to
// finish (a counter per (row, head), zeroed by stage 1, counted after a
// fence) merges the partials of every block in range in block order and
// writes the row's attention output att[b, head]: no float atomics, and
// the same bits on every run. Blocks with no row in range write nothing
// and are not counted.
//
// KV8, the int8 KV cache: ck, cv the layer's (B, S, Dkv) int8 rows, sk, sv
// their (B, S) f32 scales, kv_new the f32 K and V rows of stage 1. The
// query row is quantized per row over all D features; cached rows
// [starts[b], pos) score their exact int32 dot per head times sk[row] times
// the query's scale times `scale`, and contribute cv * sv. The lanes of row
// pos (always in range) quantize the new K and V rows over their Dkv
// features and score them as the self row: its dequantized key against the
// exact f32 query, its dequantized value. The first query head of each KV
// head's group writes that KV head's features at row pos, head 0 the
// scales. No block reads row pos from the cache.
template <typename T, bool KV8, int HD>
__global__ void __launch_bounds__(kThreads)
layer_attention_kernel(const int* __restrict__ pos_p,
                       const int* __restrict__ starts,
                       const float* __restrict__ q,
                       const float* __restrict__ kv_new, void* ck_v,
                       void* cv_v, float* __restrict__ sk,
                       float* __restrict__ sv, float* __restrict__ part_m,
                       float* __restrict__ part_l,
                       float* __restrict__ part_acc,
                       int* __restrict__ merge_cnt, float* __restrict__ att,
                       int B, int D, int Dkv, int group, int hd, int S,
                       float scale) {
  using C = typename std::conditional<KV8, int8_t, T>::type;
  constexpr int E = 16 / sizeof(C);           // elements of a 16-byte piece
  constexpr int kRowsW = kAttnRows / kWarps;  // rows a warp: one a quad
  static_assert(kRowsW * 4 == 32, "a warp's quads take its rows at once");
  constexpr int NP = (HD / E + 3) / 4;        // pieces a lane at most
  __shared__ float ws_m[kWarps], ws_l[kWarps];
  __shared__ float ws_acc[kWarps * HD];
  __shared__ float q_s[HD + E];  // zero past hd
  __shared__ int qi_s[KV8 ? HD + E : 1];
  __shared__ int last;
  const int head = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int H = gridDim.x, kvh = head / group;
  const int p = min(*pos_p, S - 1);
  const int n = p + 1;
  const int r0 = blockIdx.y * kAttnRows;
  const int lo = row_start(starts, b, p);
  if (r0 >= n || r0 + kAttnRows <= lo) return;
  const int len = min(kAttnRows, n - r0);  // rows [rlo, len) of the block
  const int rlo = max(lo - r0, 0);
  const int rp = p - r0;  // the new row, in this block when rp < kAttnRows
  C* ck = static_cast<C*>(ck_v);
  C* cv = static_cast<C*>(cv_v);
  const size_t row0 = (size_t)b * S + r0;  // the block's first cache row
  const bool vec = (Dkv * sizeof(C)) % 16 == 0 &&
                   (hd * sizeof(C)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ck) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  const int P = (hd + E - 1) / E;  // pieces a row
  const int pl = lane & 3;         // the lane's pieces: pl, pl + 4, ...
  const int row = warp * kRowsW + (lane >> 2);  // the quad's row
  const bool valid = row >= rlo && row < len;
  const bool self = KV8 && row == rp;
  const bool cached = valid && !self;

  // the quad's K and V pieces (and with KV8 their scales), all in flight
  C kx[NP][E], vx[NP][E];
  if (cached) {
    const size_t at_row = (row0 + row) * Dkv + kvh * hd;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (pl + 4 * j < P) {
        load_piece(ck + at_row, (pl + 4 * j) * E, hd, vec, kx[j]);
        load_piece(cv + at_row, (pl + 4 * j) * E, hd, vec, vx[j]);
      }
  }
  const float skr = KV8 && cached ? sk[row0 + row] : 0.f;
  const float svr = KV8 && cached ? sv[row0 + row] : 0.f;
  // the query head: rounded to T (the cache's type), or with KV8 exact and
  // quantized with the scale of all D features
  const float* qb = q + (size_t)b * D;
  const float qs = KV8 ? warp_kv_scale(qb, D) : 1.f;
  for (int d = tid; d < hd + E; d += kThreads) {
    const float x = d < hd ? qb[head * hd + d] : 0.f;
    q_s[d] = KV8 ? x : round_to<T>(x);
    if constexpr (KV8) qi_s[d] = (int)kv_quant(x, qs);
  }
  // with KV8, the warp holding row pos: the new rows' scales
  float ks = 0.f, vs = 0.f;
  if (KV8 && rp >= warp * kRowsW && rp < (warp + 1) * kRowsW) {
    ks = warp_kv_scale(kv_new + (size_t)b * Dkv, Dkv);
    vs = warp_kv_scale(kv_new + ((size_t)B + b) * Dkv, Dkv);
  }
  const float* kn = kv_new + (size_t)b * Dkv + kvh * hd;
  const float* vn = kv_new + ((size_t)B + b) * Dkv + kvh * hd;
  const bool writer = head % group == 0;
  const size_t at = ((size_t)b * S + p) * Dkv + kvh * hd;
  __syncthreads();

  // the quad's row's score
  float dot = 0.f;
  int idot = 0;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int e0 = (pl + 4 * j) * E;
    if (pl + 4 * j >= P) continue;
#pragma unroll
    for (int c = 0; c < E; ++c) {
      if (self) {
        if (e0 + c >= hd) continue;
        const float kq = kv_quant(kn[e0 + c], ks);
        dot += kq * ks * q_s[e0 + c];
        if (writer) reinterpret_cast<int8_t*>(ck)[at + e0 + c] = (int8_t)kq;
      } else if (cached) {
        if constexpr (KV8)
          idot += (int)kx[j][c] * qi_s[e0 + c];
        else
          dot += to_f(kx[j][c]) * q_s[e0 + c];
      }
    }
  }
  for (int o = 1; o < 4; o <<= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, o);
    idot += __shfl_xor_sync(0xffffffffu, idot, o);
  }
  const float sc = !valid ? -INFINITY
                   : !KV8 || self ? dot * scale
                                  : (float)idot * skr * qs * scale;
  if (self && head == 0 && pl == 0) {
    sk[(size_t)b * S + p] = ks;
    sv[(size_t)b * S + p] = vs;
  }

  // the warp's online-softmax state: max m, sum l, p @ V
  const float m = warp_max(sc);
  const float pr = valid ? expf(sc - m) : 0.f;
  const float l = warp_sum(pl == 0 ? pr : 0.f);
  float acc[NP][E];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int e0 = (pl + 4 * j) * E;
#pragma unroll
    for (int c = 0; c < E; ++c) {
      float v = 0.f;
      if (pl + 4 * j < P) {
        if (self && e0 + c < hd) {
          const float vq = kv_quant(vn[e0 + c], vs);
          v = vq * vs;
          if (writer) reinterpret_cast<int8_t*>(cv)[at + e0 + c] = (int8_t)vq;
        } else if (cached) {
          v = KV8 ? to_f(vx[j][c]) * svr : to_f(vx[j][c]);
        }
      }
      acc[j][c] = pr * v;
    }
  }
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int c = 0; c < E; ++c)
        acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], o);
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int c = 0; c < E; ++c) {
        const int e = (pl + 4 * j) * E + c;
        if (pl + 4 * j < P && e < hd) ws_acc[warp * hd + e] = acc[j][c];
      }
  if (lane == 0) {
    ws_m[warp] = m;
    ws_l[warp] = l;
  }
  __syncthreads();

  // the block's partial: the warps' states merged in warp order
  const int base = (b * H + head) * gridDim.y;
  const int slot = base + blockIdx.y;
  if (tid < hd) {
    float bm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, ws_m[w]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (ws_m[w] == -INFINITY) continue;  // a warp with no row in range
      const float c = expf(ws_m[w] - bm);
      num += c * ws_acc[w * hd + tid];
      den += c * ws_l[w];
    }
    part_acc[(size_t)slot * hd + tid] = num;
    if (tid == 0) {
      part_m[slot] = bm;
      part_l[slot] = den;
    }
  }
  // the block's writes, ordered by the barrier, are made visible device-wide
  // by one fence before the count (fences are cumulative), as a grid
  // barrier does
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int live = p / kAttnRows - lo / kAttnRows + 1;  // blocks in range
    last = atomicAdd(merge_cnt + b * H + head, 1) == live - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the row's output: every block's partial merged as online-softmax states
  // in block order
  const int s0 = lo / kAttnRows, s1 = p / kAttnRows + 1;
  if (tid < hd) {
    float gm = -INFINITY, num = 0.f, den = 0.f;
#pragma unroll 16
    for (int t = s0; t < s1; ++t) {
      const float mt = __ldcg(part_m + base + t);
      const float at_ = __ldcg(part_acc + (size_t)(base + t) * hd + tid);
      const float lt = __ldcg(part_l + base + t);
      const float nm = fmaxf(gm, mt);
      const float co = expf(gm - nm), ct = expf(mt - nm);  // exp(-inf) = 0
      num = num * co + ct * at_;
      den = den * co + ct * lt;
      gm = nm;
    }
    att[(size_t)b * D + (size_t)head * hd + tid] = num / fmaxf(den, 1e-30f);
  }
}

// Launch the attention stage at the smallest head_dim bound of 64, 128 and
// 256 that takes hd
template <typename T, bool KV8>
cudaError_t launch_attention(dim3 grid, cudaStream_t st, const int* pos,
                             const int* starts, const float* q,
                             const float* kv_new, void* ck, void* cv,
                             float* sk, float* sv, float* part_m,
                             float* part_l, float* part_acc, int* merge_cnt,
                             float* att, int B, int D, int Dkv, int group,
                             int hd, int S, float scale) {
#define PDT_ATTENTION(HD)                                                  \
  layer_attention_kernel<T, KV8, HD><<<grid, kThreads, 0, st>>>(           \
      pos, starts, q, kv_new, ck, cv, sk, sv, part_m, part_l, part_acc,     \
      merge_cnt, att, B, D, Dkv, group, hd, S, scale)
  if (hd <= 64)
    PDT_ATTENTION(64);
  else if (hd <= 128)
    PDT_ATTENTION(128);
  else
    PDT_ATTENTION(kMaxHeadDim);
#undef PDT_ATTENTION
  return cudaGetLastError();
}

// 3 and 5. h[b, r] += dot(w[r, 0:K], x[b] as the product's input) for the
// block's 16 rows r < D and the group's rows b: x is the merged attention
// output (wo, K = D) or the SwiGLU output (down, K = F), each row rounded
// to T or quantized with its own amax. One thread writes each element, so
// the residual add is a plain store.
template <typename T, int Q, int NT, bool PDL>
__device__ void residual_stage(const float* __restrict__ x, int K,
                               const void* __restrict__ w,
                               const float* __restrict__ scale,
                               float* __restrict__ h, int B, int D) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[NT * 8];
  const RowGroup g(B);
  const int G = g.count;
  x += (size_t)g.b0 * K;
  h += (size_t)g.b0 * D;
  const int row0 = kLayerRows * blockIdx.x;
  const ActRows a = act_rows<Q, T>(K);
  unsigned char* act = smem_u8 + layer_smem<Q, T>(K, 0, 1);
  const unsigned char* wt[1] = {static_cast<const unsigned char*>(w) +
                                fmt_bytes<Q, T>((size_t)row0 * K)};
  const int nr[1] = {min(kLayerRows, D - row0)};
  layer_product<Q, T, 1, NT, PDL>(wt, nr, K, a, G, smem_u8, act, [] {},
                                  [&] {
    load_act_rows<Q, T>(x, nullptr, 0, nullptr, K, G, a, act, sx_s);
  });
  for (int i = threadIdx.x; i < G * kLayerRows; i += kThreads) {
    const int b = i / kLayerRows, r = i % kLayerRows, j = row0 + r;
    if (j >= D) continue;
    const float sx = Q == kFmtFloat ? 1.f : sx_s[b];
    h[(size_t)b * D + j] +=
        rescaled(tile_sum<Q, 1, NT>(smem_u8, 0, r, b), scale, j, sx);
  }
}

// 3. wo + residual, over the merged attention output. PDL: a kernel of a
// chain of programmatic launches (layer_product)
template <typename T, int Q, int NT, bool PDL = false>
__global__ void __launch_bounds__(kThreads)
layer_wo_kernel(const float* __restrict__ att, const void* __restrict__ wo,
                const float* __restrict__ s_o, float* __restrict__ h, int B,
                int D) {
  residual_stage<T, Q, NT, PDL>(att, D, wo, s_o, h, B, D);
}

// 4. RMSNorm + gate/up + SiLU(gate) * up -> ff (B, F) f32 for one group of
// rows: block x takes gate rows [16 x, 16 x + 16) and the same up rows
template <typename T, int Q, int NT, bool PDL = false>
__global__ void __launch_bounds__(kThreads)
layer_gate_up_kernel(const float* __restrict__ h,
                     const T* __restrict__ post_norm,
                     const void* __restrict__ gate_w,
                     const void* __restrict__ up_w,
                     const float* __restrict__ s_gate,
                     const float* __restrict__ s_up, float* __restrict__ ff,
                     int B, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[NT * 8];
  const RowGroup g(B);
  const int G = g.count;
  h += (size_t)g.b0 * D;
  ff += (size_t)g.b0 * F;
  const int row0 = kLayerRows * blockIdx.x;
  const ActRows a = act_rows<Q, T>(D);
  unsigned char* act = smem_u8 + layer_smem<Q, T>(D, 0, 2);
  const size_t off = fmt_bytes<Q, T>((size_t)row0 * D);
  const unsigned char* wt[2] = {
      static_cast<const unsigned char*>(gate_w) + off,
      static_cast<const unsigned char*>(up_w) + off};
  const int nr[2] = {min(kLayerRows, F - row0), min(kLayerRows, F - row0)};
  float* raw = reinterpret_cast<float*>(smem_u8 + layer_smem<Q, T>(D, G, 2));
  T* w_s = reinterpret_cast<T*>(raw + (size_t)G * D);
  layer_product<Q, T, 2, NT, PDL>(
      wt, nr, D, a, G, smem_u8, act,
      [&] { stage_norm_rows(h, nullptr, 0, post_norm, D, G, raw, w_s); },
      [&] {
        if constexpr (PDL)
          cp_async_wait<0>();
        else
          cp_async_wait<kTileStages - 1>();
        __syncthreads();
        load_act_rows<Q, T>(raw, nullptr, 0, w_s, D, G, a, act, sx_s);
      });
  for (int i = threadIdx.x; i < G * kLayerRows; i += kThreads) {
    const int b = i / kLayerRows, r = i % kLayerRows, j = row0 + r;
    if (j >= F) continue;
    const float sx = Q == kFmtFloat ? 1.f : sx_s[b];
    const float gv =
        rescaled(tile_sum<Q, 2, NT>(smem_u8, 0, r, b), s_gate, j, sx);
    const float uv =
        rescaled(tile_sum<Q, 2, NT>(smem_u8, 1, r, b), s_up, j, sx);
    ff[(size_t)b * F + j] = gv * (1.f / (1.f + expf(-gv))) * uv;
  }
}

// 5. down + residual, over the SwiGLU output
template <typename T, int Q, int NT, bool PDL = false>
__global__ void __launch_bounds__(kThreads)
layer_down_kernel(const float* __restrict__ ff, int F,
                  const void* __restrict__ w,
                  const float* __restrict__ s_down, float* __restrict__ h,
                  int B, int D) {
  residual_stage<T, Q, NT, PDL>(ff, F, w, s_down, h, B, D);
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

// Q: the layers' format, HQ: the head's, KV8: the int8 KV cache, NT: n8
// tiles of group rows in the products (NT * 8 >= min(B, 32))
template <typename T, int Q, int HQ, bool KV8, int NT>
cudaError_t run(const Args& a, cudaStream_t st) {
  const int B = a.B, D = a.D, F = a.F, S = a.S, H = a.H, hd = a.D / a.H;
  const int Dkv = a.Hkv * hd, group = a.H / a.Hkv;
  const int ntiles = head_blocks(a.V);
  const int nsplit = attn_splits(S);
  float* h = a.scratch;                      // (B, D)
  float* q = h + (size_t)B * D;              // (B, D)
  float* att = q + (size_t)B * D;            // (B, D)
  float* ff = att + (size_t)B * D;           // (B, F)
  float* tile_val = ff + (size_t)B * F;      // (B, ntiles)
  int* tile_idx = reinterpret_cast<int*>(tile_val + (size_t)B * ntiles);
  float* part_m = tile_val + (size_t)2 * B * ntiles;  // (B, H, nsplit)
  float* part_l = part_m + (size_t)B * H * nsplit;
  float* part_acc = part_l + (size_t)B * H * nsplit;  // (B, H, nsplit, hd)
  float* kv_new = part_acc + (size_t)B * H * nsplit * hd;  // (2, B, Dkv)
  int* merge_cnt = reinterpret_cast<int*>(kv_new + (size_t)2 * B * D);
  const T* emb = static_cast<const T*>(a.emb);
  const T* cos_t = static_cast<const T*>(a.cos);
  const T* sin_t = static_cast<const T*>(a.sin);
  const T* in_norm = static_cast<const T*>(a.in_norm);
  const T* post_norm = static_cast<const T*>(a.post_norm);
  const size_t LDD = (size_t)D * D, LKD = (size_t)Dkv * D;
  const size_t LFD = (size_t)F * D;
  const size_t LBSD = (size_t)B * S * Dkv;  // one layer of the caches
  const size_t LBS = (size_t)B * S;         // one layer of the scales

  // layer-stage grids: (16-row weight tiles, row groups)
  const int ngroups = (B + kRowGroup - 1) / kRowGroup;
  const int G = min(B, kRowGroup);
  auto tiles = [](int rows) { return (rows + kLayerRows - 1) / kLayerRows; };
  const dim3 grid_qkv(tiles(D) + 2 * tiles(Dkv), ngroups);
  const dim3 grid_d(tiles(D), ngroups);
  const dim3 grid_f(tiles(F), ngroups);
  const size_t sm_qkv = norm_smem<Q, T>(D, G, 1);
  const size_t sm_d = layer_smem<Q, T>(D, G, 1);
  const size_t sm_gu = norm_smem<Q, T>(D, G, 2);
  const size_t sm_f = layer_smem<Q, T>(F, G, 1);
  if (sm_gu > kMaxSmem || sm_f > kMaxSmem) return cudaErrorInvalidValue;
  PDT_TRY(allow_smem(layer_qkv_kernel<T, Q, KV8, NT>, sm_qkv));
  PDT_TRY(allow_smem(layer_wo_kernel<T, Q, NT>, sm_d));
  PDT_TRY(allow_smem(layer_gate_up_kernel<T, Q, NT>, sm_gu));
  PDT_TRY(allow_smem(layer_down_kernel<T, Q, NT>, sm_f));
  for (int l = 0; l < a.N; ++l) {
    T* ck = KV8 ? nullptr : static_cast<T*>(a.ck) + l * LBSD;
    T* cv = KV8 ? nullptr : static_cast<T*>(a.cv) + l * LBSD;
    layer_qkv_kernel<T, Q, KV8, NT><<<grid_qkv, kThreads, sm_qkv, st>>>(
        a.pos, a.tok, emb, l == 0, h, in_norm + (size_t)l * D,
        layer_w<Q, T>(a.wq, l, LDD), layer_w<Q, T>(a.wk, l, LKD),
        layer_w<Q, T>(a.wv, l, LKD), layer_s(a.s_q, l, D),
        layer_s(a.s_k, l, Dkv), layer_s(a.s_v, l, Dkv), cos_t, sin_t, q, ck,
        cv, kv_new, merge_cnt, B, D, Dkv, H, S, a.V);
    PDT_CHECK();
    void* kc = KV8 ? static_cast<void*>(static_cast<int8_t*>(a.ck) + l * LBSD)
                   : static_cast<void*>(ck);
    void* vc = KV8 ? static_cast<void*>(static_cast<int8_t*>(a.cv) + l * LBSD)
                   : static_cast<void*>(cv);
    PDT_TRY((launch_attention<T, KV8>(
        dim3(H, nsplit, B), st, a.pos, a.starts, q, kv_new, kc, vc,
        KV8 ? a.sk + l * LBS : nullptr, KV8 ? a.sv + l * LBS : nullptr,
        part_m, part_l, part_acc, merge_cnt, att, B, D, Dkv, group, hd, S,
        a.scale)));
    layer_wo_kernel<T, Q, NT><<<grid_d, kThreads, sm_d, st>>>(
        att, layer_w<Q, T>(a.wo, l, LDD), layer_s(a.s_o, l, D), h, B, D);
    PDT_CHECK();
    layer_gate_up_kernel<T, Q, NT><<<grid_f, kThreads, sm_gu, st>>>(
        h, post_norm + (size_t)l * D, layer_w<Q, T>(a.gate_w, l, LFD),
        layer_w<Q, T>(a.up_w, l, LFD), layer_s(a.s_gate, l, F),
        layer_s(a.s_up, l, F), ff, B, D, F);
    PDT_CHECK();
    layer_down_kernel<T, Q, NT><<<grid_d, kThreads, sm_f, st>>>(
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

// the fewest n8 tiles that hold a group of min(B, 32) rows
template <typename T, int Q, int HQ, bool KV8>
cudaError_t run_b(const Args& a, cudaStream_t st) {
  if (a.B <= 8) return run<T, Q, HQ, KV8, 1>(a, st);
  if (a.B <= 16) return run<T, Q, HQ, KV8, 2>(a, st);
  return run<T, Q, HQ, KV8, 4>(a, st);
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
