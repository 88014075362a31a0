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
// probabilities rounded to the cache type only after the softmax's global
// max and sum, expanded to D features by T(hmask)^T in f32 (not rounded),
// att = sum_s p_exp * cv; wo + residual; RMSNorm; SwiGLU + residual. It
// returns the final-RMSNormed h (f32). Unlike K1's online softmax over row
// blocks, this keeps the TPU kernel's order of rounding.
//
// One step is a chain of 5 * n_layers + 1 launches:
//   1. RMSNorm + q/k/v (step_qkv_kernel): a block a 16-row tile of wq, wk
//      or wv on the tensor cores through K2's layer_product
//      (decode_token_batched.cuh, mma_rows.cuh) on a group of one row; q
//      and k raw in f32 to scratch, v rounded to the cache at pos;
//   2. attention (step_attention_kernel), one thread-block cluster of up to
//      16 blocks: the rotation, the scores, the softmax, p_exp * cv and
//      their sum over the rows (below);
//   3. wo + residual, 4. RMSNorm + gate/up + SiLU * up, 5. down + residual:
//      K2's layer_wo_kernel, layer_gate_up_kernel and layer_down_kernel on
//      one row, the stages K1 runs;
// and 6. the final RMSNorm. Rows after pos get probability 0 exactly in
// the TPU kernel, so their keys and values are not read here: the result
// is the same for any finite cache contents. Every launch of the chain is
// a programmatic dependent launch (chain_launch): a kernel may start once
// the one before it has passed its own wait, stages its inputs that no
// running kernel writes (the weights' first stages; rot, hmask, cos, sin
// and the K rows of earlier steps), and waits (pdl_wait) before it reads
// or writes anything else, so each kernel's loads overlap the one before.
//
// The attention stage. The rows [0, pos] are split over the cluster's
// blocks (512 threads each) in 16-row tiles, and every block copies its
// tiles' K and V rows into shared memory by cp.async at once (a warp 4 rows
// of 128 bytes an instruction), with its share of the rot columns, the raw
// q and k, cos, sin and hmask: one trip to memory. Each block rotates its
// share of the features (q @ rot and k @ rot, then * sin + x * cos) and
// stores it into every block's q (distributed shared memory; every
// exchange here is a store into the peers' shared memory, then a cluster
// barrier, then local reads, so no block waits on a remote load), and its
// k share into the block holding row pos, which writes k rounded to the
// cache and puts it into its staged row pos itself: no block reads a cache
// row another block writes in this launch. qM^T (heads padded to 8) is made
// once in shared memory; the scores are (16 rows x 16 or 32 bytes) x qM on
// mma.sync (bfloat16 or float16 m16n8k16, float32 in 3xTF32), each lane
// reading its rows' 16 bytes and the matching 16 bytes of qM^T (the products'
// k
// order permuted alike), the K split over warps summed in warp order. Each
// block's max and sum of exp(s - max) per head go to every block before a
// second barrier, and every block forms the global max and sum by one
// shuffle tree before it rounds any p. p_exp runs on mma.sync too,
// transposed: T(hmask) rows (16 features) times p's rows (8 rows), the
// heads the k dimension padded to 16 or 8, as (feature tile, row tile)
// items spread evenly over the warps; each item's products are multiplied
// by the staged V elementwise and summed over its rows, and each feature's
// items are added in row order. Each block pushes its column sums into a
// slot of the block that owns those columns; after a third barrier the
// owners add the slots in rank order and write att. No grid barrier, no
// float atomics: the same bits on every run. The cut (cluster size, rows,
// features and rot rows staged at once) is attn_plan's, from (D, H, S); a
// shape whose rows or features do not fit at once is staged in chunks,
// and scores that do not fit in shared memory go to scratch.
//
// What bounds it on an H100: at stories15M width (6 layers, D 288, F 768,
// S 1024) a bf16 step at pos 512 reads about 4 MB of weights and 3.5 MB of
// KV, about 2.3 us at 3.35 TB/s, against 31 launches of a few us each:
// latency. The design cuts launches, overlaps each with the one before,
// and puts the products on the tensor cores.
//
// The kernels and the chain are in decode_step.cuh. This file runs them
// for float32 and bfloat16 weights and holds the C entry points;
// decode_step_f16.cu instantiates them for float16.

#include "decode_step.cuh"

extern "C" {

// Floats of scratch for one step: h (D), raw q and k (2 D), att (D), ff
// (F), and the scores of S rows for heads padded to 8, used where they do
// not fit in the attention stage's shared memory. ops/decode_step.py's
// step_scratch_floats mirrors it.
int pdt_decode_step_scratch_floats(int dim, int n_heads, int ffn, int seq) {
  return 4 * dim + ffn + seq * ((n_heads + 7) / 8 * 8);
}

// K10. wdtype 0: float32 weights, norms and caches, 1: bfloat16, 2:
// float16; h0, cos, sin (D,), rot (D, D), hmask (D, H) and h_out (D,) are
// float32. The caches are updated in place at row min(pos, S - 1). Returns the CUDA error of
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
  if (n_heads < 1 || n_heads > kMaxHeads || n_heads > dim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return run_step<float>(a, st);
  if (wdtype == 1) return run_step<__nv_bfloat16>(a, st);
  if (wdtype == 2) return pdt_k10::run_f16(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
