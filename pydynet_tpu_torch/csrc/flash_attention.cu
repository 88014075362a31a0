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
// Types: q, k, v, o, dO and the gradients are T (float32, bfloat16 or
// float16); all
// arithmetic is float32 as in the TPU kernels
// (`preferred_element_type=jnp.float32`). The TPU's forward scales q once
// when it loads it; here the forward and the backward scale s (q scaled is
// not bfloat16-exact, q is: one exact product instead of two), and the
// backward dq and dk again at the end (as the TPU's backward kernels do).
//
// What bounds them on an H100: at stories15M's shapes (B * H = 6 to 48
// heads, L = 1024, d = 48) a head's q, k and v are 3 x 196 KB in float32, so
// the traffic is small and the kernels are bound by arithmetic: about
// L^2 / 2 x d multiply-adds a product, two products in the forward, three
// in dq and four in dk/dv.
//
// All three run on the tensor cores at float32 accuracy:
//   * every product is `mma.sync.m16n8k8` TF32 with f32 accumulators, each
//     float32 operand split as a = hi + lo (hi = tf32(a) rounded to nearest,
//     ties away, as `cvt.rna.tf32.f32` rounds; lo = tf32(a - hi)) and a b
//     summed as a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32, about 2^-22
//     relative, as CUTLASS's fast-f32 product). A bfloat16 or float16 input
//     is exact in TF32 (8 and 11 significant bits of TF32's 11, and both
//     exponent ranges inside float32's), so its lo is 0 and those products
//     are skipped: q k^T and dO v^T
//     are one exact product, and the products with p or ds (kept float32,
//     never rounded to the input type) two;
//   * each warp owns 16 rows and keeps its scores (and dP) as accumulator
//     fragments; p (the forward's 2^(s scale log2(e) - m), the backward's
//     2^(s scale log2(e) - lse log2(e))) and ds = p (dP - dd) are formed in
//     registers and fed back as the A operand of p V, ds K, ds^T Q and
//     p^T dO without a trip through shared memory (FwdCfg, BwdCfg below);
//   * the streamed tiles (K and V for the forward and dq; Q, dO, lse and dd
//     for dk/dv) go through two shared-memory stages by cp.async, the next
//     stage copied while the last one is multiplied; tiles stay in T, rows
//     padded so a warp's fragment reads hit 32 banks. The float32 tiles a
//     block keeps for its whole walk (q in the forward, q and dO in dq, k
//     and v in dk/dv) are split into their TF32 parts once, up to d = 128;
//   * at the training shape (1, 1024, 6, 48) each kernel launches 16 x 6 =
//     96 blocks of 16 warps (4 row groups x 4 shares of each stage), the
//     heaviest first: the forward and dq block of the last query tile walks
//     16 key stages of 64, the dk/dv block of key tile 0 16 query stages,
//     each warp 16 rows of every stage. The forward's shares each run an
//     online softmax and are merged as (m, l, acc) states, the backward's
//     are added, in a fixed order: nothing sums a float across blocks or
//     with atomics, the same bits every call.
// What bounds them now is mma.sync's TF32 rate, three products for each
// float32 one, and the latency of the chain from the scores through the
// exponential to the next products with one 16-warp block an SM; `wgmma`
// and TMA are the next step.
//
// The kernels and their launchers are in flash_attention.cuh; this file
// runs them for float32 and bfloat16 and holds the C entry points, and
// flash_attention_f16.cu instantiates them for float16.

#include "flash_attention.cuh"

// return fn's instance for dtype 0 (float32), 1 (bfloat16) or 2 (float16)
// and the kernels' configuration for d
#define PDT_FA_DISPATCH(fn, ...)                                    \
  do {                                                              \
    if (dtype == 0) PDT_FA_BY_DIM(float, fn, __VA_ARGS__);          \
    if (dtype == 1) PDT_FA_BY_DIM(__nv_bfloat16, fn, __VA_ARGS__);  \
    if (dtype == 2) return pdt_fa::fn##_f16(__VA_ARGS__);           \
    return cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" {

// dtype 0: float32 q, k, v, o (and dO and the gradients), 1: bfloat16,
// 2: float16. Tensors are (B, L, H, d) contiguous; lse and dd are (B * H,
// L) float32. Each returns the CUDA error of its launch, or cudaSuccess, and
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
  PDT_FA_DISPATCH(bwd_dq, q, k, v, dout, lse, dd, dq, B, L, H, d, scale,
                      st);
}

int pdt_flash_bwd_dkv(int dtype, const void* q, const void* k,
                      const void* v, const void* dout, const void* lse,
                      const void* dd, void* dk, void* dv, int B, int L, int H,
                      int d, float scale, void* stream) {
  if (bad_shape(B, L, H, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PDT_FA_DISPATCH(bwd_dkv, q, k, v, dout, lse, dd, dk, dv, B, L, H, d,
                      scale, st);
}

}  // extern "C"
