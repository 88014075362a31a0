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
// weights are (out, in) rows and caches are (N, B, S, Dkv). Dkv = D for MHA;
// in the TPU kernel's `narrow` mode (a grouped-query model, :560-939 there)
// Dkv = Hkv * head_dim, wk/wv are (N, Dkv, D), and query head h reads KV
// head h / (H / Hkv) where the TPU kernel multiplies by its 0/1 expansion
// matrix `egqa`: each attention block reads its KV head's columns, so the
// cache streams at its narrow width. Narrow composes with every mode below
// except the int8/int4 layers (the TPU kernel asserts that too).
//
// Modes, as the TPU kernel's: float weights (T, f32, bf16 or f16) with T
// caches; the int8 head (`qhead`); int8 layers and head (`qlayers`) or int4
// layers and head packed two a byte (`q4`), with T caches; float weights with
// the int8 KV cache (`kv_int8`). Each quantized matmul quantizes each of its B
// f32 activation rows with the row's own amax (the TPU kernel's qvec_b),
// accumulates exactly in int32 and rescales by the weight row's scale times
// the activation row's amax / 127. The int8 KV
// cache holds int8 rows with f32 per-row scales (ops/decode_step.quantize_kv:
// s = max(amax / 127, 1e-10), q = clip(rint(x / s), +-127), IEEE divisions):
// the new K and V rows are quantized over all D features, the query per row
// the same way, a cached row's score is the exact int32 dot per head times
// its scale times the query's, and the new row scores its dequantized key
// against the exact f32 query.
//
// Any B >= 1 takes the same launches: per token, 5 * n_layers + 2 on the
// caller's stream, in every mode (K1 runs this very chain on a group of one
// row, so a row's token, logits and cache row are the bits K1 gives it):
//   1. RMSNorm + q/k/v + RoPE + K/V row write (layer 0 gathers the
//      embedding rows); with the int8 KV cache the f32 K and V rows go to
//      scratch instead,
//   2. attention split over (head, 64-row cache block, row b); a block
//      whose rows all lie outside [starts[b], pos] exits at once; the last
//      block of a (row, head) merges the blocks' online-softmax partials in
//      block order; with the int8 KV cache the warp holding row pos
//      quantizes the new K and V rows and writes its head's part of them,
//   3. wo + residual over the merged attention output,
//   4. RMSNorm + gate/up + SiLU * up,
//   5. down + residual,
// then 6. the head stage (head.cuh): final RMSNorm + head product + bias on
// the tensor cores, a block per 128 vocab rows and row group, with a (max,
// index) pair per row and block; and 7. one block per row: argmax over its
// blocks. In the TPU kernel's `emit_logits` mode (the sampled decode's,
// :1010-1011 there) stage 6 also writes the (B, V) f32 logits, the very
// values the argmax compares, and 7 is not launched: 5 * n_layers + 1
// launches. `pos`, `tok` and `starts` are read from device memory, so a
// chunk of steps never waits for the host.
//
// What bounds it on an H100: at stories15M width (D 288, F 768, 6 layers,
// V 32000), B = 8, pos 512, a token reads about 12 MB of bf16 layer weights
// (6 MB as int8, 3 MB as int4) and 18.4 MB of head (9.2 as int8) once for the
// fleet, and about 29 MB of bf16 KV (8 rows x about 3.6 MB; 14.2 MB as int8
// with its scales): about 18 us at 3.35 TB/s, against 32 launches of a few
// microseconds each. So each stage is made short, and the chain is kept
// (no grid-wide barrier, whose blocks would all have to be resident):
//   * stages 1, 3, 4 and 5 are products on the tensor cores (mma_rows.cuh,
//     the head's machinery): a block takes 16 weight rows (two 16-row tiles,
//     gate's and up's, in stage 4) of one matrix and a group of up to 32
//     rows (blockIdx.y), its 8 warps splitting the contraction into 64-byte
//     stages, each warp streaming its stages through its own cp.async ring
//     while the block makes the group's rows the product's input, a warp a
//     row in parallel (RMSNorm * w of the rows and norm weights that
//     cp.async copied in beside the ring's first stages, or the merged
//     attention output or the SwiGLU output as they are; rounded to T or
//     quantized per row); the warps' shares are summed in shared memory in
//     warp order and one thread writes each output (RoPE pairs, cache rows,
//     SwiGLU, residual adds). bfloat16 or float16 m16n8k16 with float32
//     sums (the row rounded to the weights' type, as the TPU kernel's
//     hn32.astype(cdtype)), int8 and
//     int4 m16n8k32 with exact int32 sums rescaled as float(acc) * (scale[r]
//     * sx), each operation rounded on its own, float32 in 3xTF32 summed a
//     k8 step at a time. So each weight matrix is read once a token for a
//     group of up to 32 rows; above that each group reads it again, from L2
//     (a stories15M layer is about 2 MB of bf16);
//   * the attention block spreads each cache row over a quad of lanes along
//     head_dim with 16-byte loads, so a warp takes its 8 of the block's 64
//     rows at once with every load in flight, and keeps its own
//     online-softmax state, merged once; the merge over the blocks of a
//     (row, head) runs once, in the last of them to finish (int counters,
//     no float atomics, a fixed order), not in every block of stage 3.
// A CUDA graph over a chunk comes later.
//
// Shared memory grows with the group: a layer-stage block holds its warps'
// rings (32 KB a weight tile) and the group's rows (up to 32 x F floats'
// bytes for the float32 down stage, 99 KB at F = 768), above the 48 KB a
// block gets without opting in, so those launches opt in to dynamic shared
// memory (up to 227 KB). The wrapper (ops/decode_step.batched_kernel_takes,
// whose layer_smem_bytes mirrors layer_smem) refuses widths that do not
// fit; B itself is bounded by device memory and by the attention grid's z
// extent (65535).
//
// The kernels and the chain are in decode_token_batched.cuh. This file
// instantiates them for float32 weights and holds the C entry points;
// decode_token_batched_bf16.cu and decode_token_batched_f16.cu instantiate
// them for bfloat16 and float16, so that nvcc compiles the three thirds of
// the modes' template instances at once.

#include "decode_token_batched.cuh"

int pdt_k2::run_f32(int lfmt, int hfmt, int kv8, const Args& a,
                    cudaStream_t st) {
  return (int)run_mode<float>(lfmt, hfmt, kv8, a, st);
}

extern "C" {

// Floats of scratch the wrapper allocates for one step of B rows
// (scratch_floats in decode_token_batched.cuh).
int pdt_decode_token_batched_scratch_floats(int batch, int dim, int n_heads,
                                            int ffn, int vocab, int seq) {
  return scratch_floats(batch, dim, n_heads, ffn, vocab, seq);
}

// wdtype 0: float32 weights, 1: bfloat16, 2: float16. lfmt / hfmt: the
// formats of the
// layer matmuls and of the head (0 the weight type, 1 int8, 2 int4 packed
// along the contraction axis), one of (0, 0), (0, 1), (1, 1), (2, 2); a
// quantized matrix has float32 scales per output row: head_s (V,), s_q ..
// s_down (N, out). kv8 1: ck, cv are int8 (N, B, S, D) with float32
// per-row scales sk, sv (N, B, S), with (lfmt, hfmt) = (0, 0); else the
// caches have the weight type and sk, sv are null. starts may be null
// (every row attends from row 0). With `logits` non-null (the emit_logits
// mode, any of these modes) the step writes the (B, V) f32 logits there and
// launches no argmax (`out` is not written). n_kv_heads < n_heads (the
// narrow mode): wk, wv are (N, Hkv * head_dim, D) and the caches (N, B, S,
// Hkv * head_dim); float layers only. Returns the CUDA error of the first
// call that failed, or cudaSuccess; cudaErrorInvalidValue for a batch
// outside [1, 65535], KV heads that do not divide the heads, a mode outside
// these, or widths whose activation rows do not fit in shared memory.
int pdt_decode_token_batched(int wdtype, int lfmt, int hfmt, int kv8,
                             const void* pos, const void* tok,
                             const void* starts, void* out, void* logits,
                             const void* emb,
                             const void* cos, const void* sin,
                             const void* final_norm, const void* wq,
                             const void* wk, const void* wv, const void* wo,
                             const void* gate_w, const void* up_w,
                             const void* down_w, const void* in_norm,
                             const void* post_norm, const void* head_w,
                             const void* head_s, const void* head_b,
                             const void* s_q, const void* s_k,
                             const void* s_v, const void* s_o,
                             const void* s_gate, const void* s_up,
                             const void* s_down, void* ck, void* cv,
                             void* sk, void* sv, void* scratch, int batch,
                             int n_layers, int dim, int n_heads,
                             int n_kv_heads, int ffn, int vocab, int seq,
                             float scale, void* stream) {
  if (batch < 1 || batch > 65535 || n_kv_heads < 1 ||
      n_heads % n_kv_heads != 0 || (n_kv_heads != n_heads && lfmt != 0))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{static_cast<const int*>(pos),
         static_cast<const int*>(tok),
         static_cast<const int*>(starts),
         static_cast<int*>(out),
         static_cast<float*>(logits),
         emb, cos, sin, final_norm,
         wq, wk, wv, wo, gate_w, up_w, down_w,
         in_norm, post_norm, head_w, f(head_s), head_b,
         f(s_q), f(s_k), f(s_v), f(s_o), f(s_gate), f(s_up), f(s_down),
         ck, cv,
         static_cast<float*>(sk), static_cast<float*>(sv),
         static_cast<float*>(scratch),
         batch, n_layers, dim, n_heads, n_kv_heads, ffn, vocab, seq, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return pdt_k2::run_f32(lfmt, hfmt, kv8, a, st);
  if (wdtype == 1) return pdt_k2::run_bf16(lfmt, hfmt, kv8, a, st);
  if (wdtype == 2) return pdt_k2::run_f16(lfmt, hfmt, kv8, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
