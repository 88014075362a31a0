// The decode steps' head stage on the tensor cores: the final RMSNorm of a
// group of up to 32 residual rows, the (G, D) x (D, V) head product plus
// bias, and per row and vocab block either the (max, lowest index) pair
// for argmax_kernel or, in the emit_logits mode, the float32 logits as
// well. K1 (decode_token.cu, G = 1) and K2 (decode_token_batched.cuh, its
// row groups) launch the same kernel, so a row's logits are the same bits
// at any B and in either step. K9 (decode_token.cu: the greedy head of an h
// given as it is) runs the same block at G = 1 without the final norm
// (lm_head_kernel), h float32, bfloat16 or float16 and never rounded to
// the weights' type: against bfloat16 weights an h of another type goes in
// as three bfloat16 rows (SPLIT, load_split_rows); float32 weights, and
// float16 weights against an h of another type, take the CUDA cores
// (FFMA, the float16 weights widened as they are read).
//
// Replaces the head of the TPU kernels `_token_kernel` and
// `_token_kernel_batched` (pydynet_tpu/ops/decode_step.py): the final norm,
// the vocab-tiled head matmul + bias, and the running argmax whose ties go
// to the lowest index (K1's :470-491, K2's :984-1011 there); and K9's
// `_lm_head_kernel` (:102 there), the same head on h as given.
//
// What bounds it on an H100: at stories15M's head (D 288, V 32000) it reads
// 18.4 MB of bfloat16 weights (9.2 MB int8, 4.6 MB int4, 36.9 MB float32)
// once for up to 32 rows and does 2 G D V operations: far below the
// tensor cores' rate, so the weight bytes over 3.35 TB/s bound it (5.5 us
// in bfloat16). The design for that:
//   * one block takes kHeadBlockRows = 128 vocab rows (8 warps x 16) and the
//     whole group, so 250 blocks read the head once a group, about two a
//     SM, all resident at once;
//   * the weight tile streams through a 4-stage ring of 128 rows x 64
//     bytes by 16-byte cp.async (4-byte, or plain copies, for rows whose
//     bytes are not a multiple of 16 or 4), zero-filled past V and past the
//     row; its 16-byte chunks are swizzled so that ldmatrix reads hit 32
//     banks. The first stages are in flight while the block normalises;
//   * the group's rows are normalised once a block, a warp a row, in
//     parallel (RMSNorm * w rounded to T, or quantized with the row's own
//     amax), into shared memory as the B operand (K-major rows, padded so
//     ldmatrix reads hit 32 banks). The ring's stages, the rows and the
//     products are mma_rows.cuh's, which the layer stages share;
//   * the product is `mma.sync`: bfloat16 or float16 m16n8k16 with
//     float32 accumulators (the activations are rounded to the weights' type
//     first, so every product is exact); int8 m16n8k32 with exact int32 sums,
//     rescaled as float(acc) * (scale[r] * sx) + bias, each product and the
//     sum rounded on its own as the plain version rounds them, so on the same
//     activations the int8 and int4 logits are its bits; int4 bytes unpacked
//     to the int8 low- and high-nibble operands in registers (element j and j
//     + D/2 of ops/quant.py's layout), two IMMAs a fragment; a float32 head in
//     3xTF32 (as flash_attention.cu), about 2^-22 relative;
//   * the logits of the block (128 x G floats) are staged in shared memory,
//     then each row's are written along V (coalesced) and reduced to the
//     row's (max, lowest index) pair, ties low (`better`), over the block's
//     rows in a fixed order.

#pragma once

#include "mma_rows.cuh"

namespace {

constexpr int kHeadBlockRows = 128;  // vocab rows of a head block: 8 warps
constexpr int kHeadRing = kTileStages * kHeadBlockRows * kTileStageBytes;
static_assert(kThreads == 256, "the head block is 8 warps of 16 rows");

// blocks of the head stage for a vocabulary of V rows
int head_blocks(int vocab) {
  return (vocab + kHeadBlockRows - 1) / kHeadBlockRows;
}

// dynamic shared memory of a head block for a group of up to G rows: the
// ring and the G activation rows (an n8 tile's rows past G read row G - 1:
// their sums are dropped); the staged logits reuse the ring. At most
// kHeadRing + G (D + 36) floats' bytes in every format
// (ops/decode_step.py's kernel_takes and batched_kernel_takes keep that
// within a block's shared memory).
template <int HQ, typename T>
size_t head_smem(int D, int G) {
  return (size_t)kHeadRing + (size_t)act_rows<HQ, T>(D).stride * G;
}

// K9's row x (K values, float32 or float16) against bfloat16 weights, as
// the B operand of three bfloat16 rows, a warp each: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid). The differences are exact in
// float32 and the three pieces carry all 24 significand bits (a float16's
// 11 take two), so hi + mid + lo == x, and each piece's product with a
// bfloat16 weight is exact in float32: the head sees x unrounded. The
// split is exact unless lo falls below bfloat16's normal range (|x| below
// about 1e-33, or tensor cores that flush such a subnormal piece): then
// the sum misses x by up to half a subnormal step, 2^-134, as a normed
// hidden state (O(1)) never does. Zero past K; ends synchronised.
template <typename S>
__device__ void load_split_rows(const S* x, int K, ActRows a,
                                unsigned char* act) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 3) {
    unsigned char* row = act + (size_t)warp * a.stride;
    for (int i = lane; i < a.stride / 4; i += 32)
      reinterpret_cast<unsigned*>(row)[i] = 0u;
    __syncwarp();
    for (int i = lane; i < K; i += 32) {
      float r = to_f(x[i]);
      __nv_bfloat16 piece = __float2bfloat16_rn(r);
      for (int p = 0; p < warp; ++p) {  // peel the pieces above this one
        r -= __bfloat162float(piece);
        piece = __float2bfloat16_rn(r);
      }
      reinterpret_cast<__nv_bfloat16*>(row)[i] = piece;
    }
  }
  __syncthreads();
}

// 6. The head stage: final RMSNorm + head product + bias over 128 vocab
// rows for one group of rows (blockIdx.y: rows [32 blockIdx.y, + G)), NT n8
// tiles of rows (NT * 8 >= G). Writes row b's (max, lowest index) pair of
// the block to tile_val/tile_idx[b * gridDim.x + blockIdx.x] and, with
// `logits`, row b's float32 logits to logits[b * V + r], the values the
// pair compares. HQ is the head's format: T rows, int8 rows (the int8
// head and the int8 layers) or int4 rows (the int4 layers), with per-row
// f32 scales `head_s`; a quantized head quantizes each row's activations
// with the row's own scale (the TPU kernel's qvec_b). The rows h are of
// type S (K9's 16-bit h; float32 else). With SPLIT (K9: one float32 or
// float16 row against bfloat16 weights, no final norm) the row is
// load_split_rows' three bfloat16 rows, and a vocab row's logit is its
// three sums added in one order, (lo + mid) + hi, then the bias. With FFMA
// (K9: one row against float32 weights, or against float16 weights when
// h is not float16) the product runs on the CUDA cores from the same
// ring, h kept float32 in shared memory and a float32 multiply-add a
// weight, a float16 weight widened exactly.
template <typename T, int HQ, int NT, typename S, bool SPLIT, bool FFMA>
__device__ __forceinline__ void head_block(
    const S* __restrict__ h, const T* __restrict__ final_norm,
    const void* __restrict__ head_w, const float* __restrict__ head_s,
    const T* __restrict__ head_b, float* __restrict__ tile_val,
    int* __restrict__ tile_idx, float* __restrict__ logits, int B, int D,
    int V) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[NT * 8];
  static_assert(!SPLIT || (HQ == kFmtFloat && NT == 1 &&
                            std::is_same<T, __nv_bfloat16>::value &&
                            !std::is_same<S, T>::value),
                "SPLIT: one row of another type against bfloat16 weights");
  static_assert(!FFMA || (HQ == kFmtFloat && NT == 1 &&
                          !std::is_same<T, __nv_bfloat16>::value),
                "FFMA: one row against float32 or float16 weights");
  // the activation rows' element type: h kept float32 for FFMA
  using AT = typename std::conditional<FFMA, float, T>::type;
  const int b0 = blockIdx.y * 32, G = min(32, B - b0);
  const int GA = SPLIT ? 3 : G;  // activation rows of the product
  h += (size_t)b0 * D;
  tile_val += (size_t)b0 * gridDim.x;
  tile_idx += (size_t)b0 * gridDim.x;
  if (logits != nullptr) logits += (size_t)b0 * V;
  const int v0 = blockIdx.x * kHeadBlockRows;
  const int rb = (int)fmt_bytes<HQ, T>(D);  // bytes a weight row
  const unsigned char* w =
      static_cast<const unsigned char*>(head_w) + (size_t)v0 * rb;
  const int nst = (rb + kTileStageBytes - 1) / kTileStageBytes;
  const int vec = tile_vec(head_w, rb);
  constexpr int kSlot = kHeadBlockRows * kTileStageBytes;
  unsigned char* ring = smem_u8;
  unsigned char* act = smem_u8 + kHeadRing;
  const ActRows a = act_rows<HQ, AT>(D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  // the bias of this thread's two vocab rows, 16 warp + g and + 8, read
  // now, off the block's tail
  float bias_r[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    bias_r[u] = to_f(head_b[min(v0 + 16 * warp + g + 8 * u, V - 1)]);

#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nst)
      tile_stage<kHeadBlockRows>(ring + s * kSlot, w, V - v0, rb, s, vec,
                                 threadIdx.x, kThreads);
    cp_async_commit();
  }
  if constexpr (SPLIT)
    load_split_rows(h, D, a, act);
  else if constexpr (FFMA)  // K9 has no final norm
    load_act_rows<HQ, float>(h, nullptr, 0, static_cast<const float*>(nullptr),
                             D, G, a, act, sx_s);
  else
    load_act_rows<HQ, T>(h, nullptr, 0, final_norm, D, G, a, act, sx_s);

  MmaAcc<HQ> acc[NT][4];
  float fsum[2] = {0.f, 0.f};  // FFMA: rows g and g + 8, chunk q's share
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();  // stage st is in; every warp is done with st - 1
    const int nx = st + kTileStages - 1;
    if (nx < nst)
      tile_stage<kHeadBlockRows>(ring + (nx % kTileStages) * kSlot, w, V - v0,
                                 rb, nx, vec, threadIdx.x, kThreads);
    cp_async_commit();
    // this warp's 16 vocab rows of the stage
    const unsigned char* s_w =
        ring + (st % kTileStages) * kSlot + 16 * warp * kTileStageBytes;
    if constexpr (FFMA) {
      // on the CUDA cores: lane (g, q) takes 16-byte chunk q of rows g and
      // g + 8 (CE weights, 4 float32 or 8 float16) and the CE float32
      // elements of h they meet, one float32 multiply-add a weight
      constexpr int CE = 16 / (int)sizeof(T);
      const float* x = reinterpret_cast<const float*>(act) +
                       st * (kTileStageBytes / (int)sizeof(T)) + CE * q;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(s_w + tile_chunk(g + 8 * u, q));
        const T* wv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < CE; ++i) fsum[u] = fmaf(to_f(wv[i]), x[i], fsum[u]);
      }
    } else {
      mma_stage<HQ, T, NT>(acc, s_w, act, a, GA, st * kTileStageBytes);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed: the logits reuse it

  // fragment e of tile t: vocab row 16 warp + g + 8 (e >> 1), group row
  // 8 t + 2 q + (e & 1); staged as lg[b][r], 128 + 4 floats a row, bias
  // added (rounded as the plain version: no fused multiply-add)
  constexpr int kLgRow = kHeadBlockRows + 4;
  float* lg = reinterpret_cast<float*>(ring);
  if constexpr (SPLIT || FFMA) {
    // one row: SPLIT's three sums (hi, mid in columns 0, 1 of lane q = 0,
    // lo in column 0 of lane q = 1) added as (lo + mid) + hi; FFMA's four
    // chunk shares of a vocab row added over lanes q
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float x;
      if constexpr (SPLIT) {
        const float lo = __shfl_down_sync(0xffffffffu, acc[0][2 * u], 1);
        x = __fadd_rn(__fadd_rn(lo, acc[0][2 * u + 1]), acc[0][2 * u]);
      } else {
        x = fsum[u] + __shfl_xor_sync(0xffffffffu, fsum[u], 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
      }
      const int r = 16 * warp + g + 8 * u;
      if (q == 0 && v0 + r < V) lg[r] = __fadd_rn(x, bias_r[u]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + 8 * (e >> 1),
                  b = 8 * t + 2 * q + (e & 1);
        if (b >= G || v0 + r >= V) continue;
        lg[b * kLgRow + r] = __fadd_rn(
            rescaled(acc[t][e], head_s, v0 + r, sx_s[b]), bias_r[e >> 1]);
      }
  }
  __syncthreads();
  const int nrows = min(kHeadBlockRows, V - v0);
  for (int b = warp; b < G; b += kWarps) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = lane; r < nrows; r += 32) {
      const float x = lg[b * kLgRow + r];
      if (logits != nullptr) logits[(size_t)b * V + v0 + r] = x;
      if (better(x, v0 + r, bv, bi)) {
        bv = x;
        bi = v0 + r;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      tile_val[(size_t)b * gridDim.x + blockIdx.x] = bv;
      tile_idx[(size_t)b * gridDim.x + blockIdx.x] = bi;
    }
  }
}

template <typename T, int HQ, int NT>
__global__ void __launch_bounds__(kThreads)
head_mma_kernel(const float* __restrict__ h, const T* __restrict__ final_norm,
                const void* __restrict__ head_w,
                const float* __restrict__ head_s, const T* __restrict__ head_b,
                float* __restrict__ tile_val, int* __restrict__ tile_idx,
                float* __restrict__ logits, int B, int D, int V) {
  head_block<T, HQ, NT, float, false, false>(h, final_norm, head_w, head_s,
                                             head_b, tile_val, tile_idx,
                                             logits, B, D, V);
}

// K9's route for weights of type W and an h of type S: 16-bit weights
// against an h of their own type on the tensor cores (h exact in W);
// bfloat16 weights against another h as three bfloat16 pieces (SPLIT);
// float32 weights, and float16 weights against another h, on the CUDA
// cores (FFMA: one row leaves 7 of an n8 tile's 8 columns idle, and
// 3xTF32 would split h for that one row, so a float32 multiply-add a
// weight costs less; float16 cannot hold a float32 or bfloat16 h in a few
// pieces, its 5-bit exponent underflowing and overflowing). AT is the type
// of its activation row.
template <typename W, typename S>
struct LmHeadRoute {
  static constexpr bool kSame = std::is_same<W, S>::value;
  static constexpr bool kBf16 = std::is_same<W, __nv_bfloat16>::value;
  static constexpr bool SPLIT = kBf16 && !kSame;
  static constexpr bool FFMA = sizeof(W) == 4 || (!kBf16 && !kSame);
  using AT = typename std::conditional<FFMA, float, W>::type;
};

// K9 (decode_token.cu): the head stage on one row h of type S without the
// final norm, by LmHeadRoute's route. It lets argmax_kernel, launched after
// it as a programmatic dependent launch, start at once and wait there for
// the blocks' pairs.
template <typename W, typename S>
__global__ void __launch_bounds__(kThreads)
lm_head_kernel(const S* __restrict__ h, const W* __restrict__ head_w,
               const W* __restrict__ head_b, float* __restrict__ tile_val,
               int* __restrict__ tile_idx, int D, int V) {
  using R = LmHeadRoute<W, S>;
  pdl_launch();
  head_block<W, kFmtFloat, 1, S, R::SPLIT, R::FFMA>(
      h, nullptr, head_w, nullptr, head_b, tile_val, tile_idx, nullptr, 1, D,
      V);
}

// Launch the head stage for B rows (row groups of 32): NT n8 tiles of rows
// for min(B, 32) rows
template <typename T, int HQ, int NT>
cudaError_t launch_head_nt(const float* h, const T* final_norm,
                           const void* head_w, const float* head_s,
                           const T* head_b, float* tile_val, int* tile_idx,
                           float* logits, int B, int D, int V,
                           cudaStream_t st) {
  auto kernel = head_mma_kernel<T, HQ, NT>;
  const size_t smem = head_smem<HQ, T>(D, min(B, 32));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(head_blocks(V), (B + 31) / 32), kThreads, smem, st>>>(
      h, final_norm, head_w, head_s, head_b, tile_val, tile_idx, logits, B,
      D, V);
  return cudaGetLastError();
}

template <typename T, int HQ>
cudaError_t launch_head(const float* h, const T* final_norm,
                        const void* head_w, const float* head_s,
                        const T* head_b, float* tile_val, int* tile_idx,
                        float* logits, int B, int D, int V, cudaStream_t st) {
  if (B <= 8)
    return launch_head_nt<T, HQ, 1>(h, final_norm, head_w, head_s, head_b,
                                    tile_val, tile_idx, logits, B, D, V, st);
  if (B <= 16)
    return launch_head_nt<T, HQ, 2>(h, final_norm, head_w, head_s, head_b,
                                    tile_val, tile_idx, logits, B, D, V, st);
  return launch_head_nt<T, HQ, 4>(h, final_norm, head_w, head_s, head_b,
                                  tile_val, tile_idx, logits, B, D, V, st);
}

}  // namespace
