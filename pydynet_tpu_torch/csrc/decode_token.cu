// One greedy B=1 Llama decode step on NVIDIA Hopper (sm_90a), and the
// greedy head alone.
//
// Replaces the Pallas TPU kernels `_token_kernel`
// (pydynet_tpu/ops/decode_step.py:160, launched by `fused_decode_token`
// at :1346; K1) and `_lm_head_kernel` (:102, launched by `lm_head_argmax`
// at :129; K9, the head of an h given as it is, without the final RMSNorm
// and without rounding h to the weights' type: K1's head stage, head.cuh,
// at one row without its norm, `run_head` below).
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
// One token is K2's chain (decode_token_batched.cuh) on a group of one row:
// the same stage kernels and the same template instances, the (N, S, Dkv)
// caches being K2's (N, 1, S, Dkv), so a row's token, logits and cache row
// are the bits K2 gives that row at any B. 5 * n_layers + 2 launches on the
// caller's stream:
//   1. RMSNorm + q/k/v + RoPE + K/V row write (layer 0 gathers the
//      embedding row),
//   2. attention split over (head, 64-row block of the cache), the last
//      block of a head merging the blocks' softmax partials,
//   3. wo + residual,
//   4. RMSNorm + gate/up + SiLU * up,
//   5. down + residual,
// then 6. final RMSNorm + head product + bias with a (max, index) pair per
// 128-row vocab block (head.cuh), and 7. a one-block argmax over the blocks
// (K9 is 6 on h as given, without the norm, then 7 as a programmatic
// dependent launch; both keep the tie rule). Stages 1, 3, 4 and 5 are
// products on the tensor cores. In the TPU kernel's `emit_logits` mode
// (the sampled decode's, ops/decode_step.py:487-491 there) stage 6 also
// writes each vocab row's f32 logit, bias added and int8/int4 scale
// applied by the very arithmetic the argmax compares, to a (V,) output,
// and 7 is not launched:
// 5 * n_layers + 1 launches. `pos` and `tok` are read from device memory,
// so no step syncs with the host and the chain can later be captured in a
// CUDA graph.
//
// What bounds it on an H100: at stories15M width (D 288, F 768, 6 layers,
// V 32000) a token reads about 12 MB of bf16 layer weights, 18.4 MB of bf16
// head (9.2 MB as int8) and up to about 7 MB of KV at pos 1023: about 10 us
// of traffic at 3.35 TB/s. A chain of 32 launches costs more than that, so
// the step is bound by launch latency; decode_token_batched.cu says how each
// stage is kept short.
//
// Types: the residual stream is f32; every matmul input is rounded to the
// weight type T (f32, bf16 or f16) and accumulated in f32; the caches are
// T.
// Quantized weights (the TPU kernel's `qhead`, `qlayers` and `q4` modes):
// the int8 head, int8 layers with the int8 head, or int4 layers with the
// int4 head. Each of their matmuls quantizes its f32 activation vector (the
// normed h for q/k/v, the attention output for wo, the normed z for
// gate/up, the SwiGLU output for down, the final normed h for the head;
// none rounded to T first), accumulates exactly in int32 and rescales by
// its weight row's scale times amax / 127, as the TPU kernel's qvec/qmm do.

#include "decode_token_batched.cuh"

namespace {

// K9: the head of h (1, D) alone, h as it is (float32, bfloat16 or
// float16, widened to float32, never rounded to the weights' type: jnp.dot
// promotes both to float32). It is the head stage (head.cuh) at G = 1
// without the final norm (lm_head_kernel, LmHeadRoute): 16-bit weights
// against an h of their type in plain 16-bit products, bfloat16 weights
// against another h in three bfloat16 pieces of h, each product exact;
// float32 weights, and float16 weights against another h, in float32
// multiply-adds. Then argmax_kernel over the blocks' pairs, a
// programmatic dependent launch.
template <typename H, typename W>
cudaError_t run_head(const void* h, const void* w, const void* b, int* out,
                     float* scratch, int D, int V, cudaStream_t st) {
  using R = LmHeadRoute<W, H>;
  auto kernel = lm_head_kernel<W, H>;
  const int nblocks = head_blocks(V);
  float* tile_val = scratch;
  int* tile_idx = reinterpret_cast<int*>(scratch + nblocks);
  const size_t smem =
      head_smem<kFmtFloat, typename R::AT>(D, R::SPLIT ? 3 : 1);
  PDT_TRY(allow_smem(kernel, smem));
  kernel<<<nblocks, kThreads, smem, st>>>(
      static_cast<const H*>(h), static_cast<const W*>(w),
      static_cast<const W*>(b), tile_val, tile_idx, D, V);
  PDT_CHECK();
  return chain_launch(argmax_kernel, dim3(1), kThreads, 0, st, 0,
                      static_cast<const float*>(tile_val),
                      static_cast<const int*>(tile_idx), nblocks, out);
}

}  // namespace

extern "C" {

// Floats of scratch the wrapper allocates for one step: K2's at B = 1.
int pdt_decode_token_scratch_floats(int dim, int n_heads, int ffn, int vocab,
                                    int seq) {
  return scratch_floats(1, dim, n_heads, ffn, vocab, seq);
}

// wdtype 0: float32 weights and caches, 1: bfloat16, 2: float16. lfmt /
// hfmt: the
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
  const pdt_k2::Args a{static_cast<const int*>(pos),
                       static_cast<const int*>(tok),
                       nullptr,  // no starts: the row attends from row 0
                       static_cast<int*>(out),
                       static_cast<float*>(logits),
                       emb, cos, sin, final_norm,
                       wq, wk, wv, wo, gate_w, up_w, down_w,
                       in_norm, post_norm, head_w, f(head_s), head_b,
                       f(s_q), f(s_k), f(s_v), f(s_o), f(s_gate), f(s_up),
                       f(s_down),
                       ck, cv,
                       nullptr, nullptr,  // no int8 KV cache
                       static_cast<float*>(scratch),
                       1, n_layers, dim, n_heads, n_kv_heads, ffn, vocab, seq,
                       scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return pdt_k2::run_f32(lfmt, hfmt, 0, a, st);
  if (wdtype == 1) return pdt_k2::run_bf16(lfmt, hfmt, 0, a, st);
  if (wdtype == 2) return pdt_k2::run_f16(lfmt, hfmt, 0, a, st);
  return (int)cudaErrorInvalidValue;
}

// Floats of scratch for lm_head_argmax: a (max, index) pair per head
// block.
int pdt_lm_head_argmax_scratch_floats(int vocab) {
  return 2 * head_blocks(vocab);
}

// K9: out[0] = argmax over v < V of dot(h, w[v]) + b[v] (ties to the lowest
// v), h (D,) of type hdtype, w (V, D) and b (V,) of type wdtype (0 float32,
// 1 bfloat16, 2 float16, in any pairing), f32 accumulation.
int pdt_lm_head_argmax(int hdtype, int wdtype, const void* h, const void* w,
                       const void* b, void* out, void* scratch, int dim,
                       int vocab, void* stream) {
  using bf = __nv_bfloat16;
  using hf = __half;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  float* sc = static_cast<float*>(scratch);
  switch (hdtype * 3 + wdtype) {
    case 0: return run_head<float, float>(h, w, b, o, sc, dim, vocab, st);
    case 1: return run_head<float, bf>(h, w, b, o, sc, dim, vocab, st);
    case 2: return run_head<float, hf>(h, w, b, o, sc, dim, vocab, st);
    case 3: return run_head<bf, float>(h, w, b, o, sc, dim, vocab, st);
    case 4: return run_head<bf, bf>(h, w, b, o, sc, dim, vocab, st);
    case 5: return run_head<bf, hf>(h, w, b, o, sc, dim, vocab, st);
    case 6: return run_head<hf, float>(h, w, b, o, sc, dim, vocab, st);
    case 7: return run_head<hf, bf>(h, w, b, o, sc, dim, vocab, st);
    case 8: return run_head<hf, hf>(h, w, b, o, sc, dim, vocab, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
