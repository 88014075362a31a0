// The decode steps' head stage on the tensor cores: the final RMSNorm of a
// group of up to 32 residual rows, the (G, D) x (D, V) head product plus
// bias, and per row and vocab block either the (max, lowest index) pair
// for argmax_kernel or, in the emit_logits mode, the float32 logits as
// well. K1 (decode_token.cu, G = 1) and K2 (decode_token_batched.cuh, its
// row groups) launch the same kernel, so a row's logits are the same bits
// at any B and in either step. K9 (the head of a given h) keeps head_tile
// (common.cuh): its h is not rounded to the weights' type.
//
// Replaces the head of the TPU kernels `_token_kernel` and
// `_token_kernel_batched` (pydynet_tpu/ops/decode_step.py): the final norm,
// the vocab-tiled head matmul + bias, and the running argmax whose ties go
// to the lowest index (K1's :470-491, K2's :984-1011 there).
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
//     parallel (load_normed_act's arithmetic, its sum of squares over a
//     warp: RMSNorm * w rounded to T, or quantized with the row's own
//     amax), into shared memory as the B operand (K-major rows, padded so
//     ldmatrix reads hit 32 banks);
//   * the product is `mma.sync`: bfloat16 m16n8k16 with float32
//     accumulators (the activations are rounded to bfloat16 first, so every
//     product is exact); int8 m16n8k32 with exact int32 sums, rescaled as
//     float(acc) * (scale[r] * sx) + bias, each product and the sum rounded
//     on its own as the plain version rounds them, so on the same
//     activations the int8 and int4 logits are its bits; int4 bytes unpacked
//     to the int8 low- and high-nibble operands in registers (element j and
//     j + D/2 of ops/quant.py's layout), two IMMAs a fragment; a float32
//     head in 3xTF32 (as flash_attention.cu), about 2^-22 relative;
//   * the logits of the block (128 x G floats) are staged in shared memory,
//     then each row's are written along V (coalesced) and reduced to the
//     row's (max, lowest index) pair, ties low (`better`), over the block's
//     rows in a fixed order.

#pragma once

#include "common.cuh"

namespace {

constexpr int kHeadBlockRows = 128;  // vocab rows of a head block: 8 warps
constexpr int kHeadStageBytes = 64;  // bytes of a weight row a ring stage
constexpr int kHeadStages = 4;
constexpr int kHeadRing = kHeadStages * kHeadBlockRows * kHeadStageBytes;
static_assert(kThreads == 256, "the head block is 8 warps of 16 rows");

// blocks of the head stage for a vocabulary of V rows
int head_blocks(int vocab) {
  return (vocab + kHeadBlockRows - 1) / kHeadBlockRows;
}

// Layout of the activation rows (the B operand) in shared memory:
// `stride` bytes a row; int4's upper half (elements D/2 ..) starts `half`
// bytes into a row.
struct HeadAct {
  int stride, half;
};

template <int HQ, typename T>
__host__ __device__ __forceinline__ HeadAct head_act(int D) {
  const int nst = ((int)fmt_bytes<HQ, T>(D) + kHeadStageBytes - 1) /
                  kHeadStageBytes;
  const int span = nst * kHeadStageBytes;  // weight bytes the stages cover
  HeadAct a{0, 0};
  if constexpr (HQ == kFmtFloat && sizeof(T) == 4) {
    // floats a row = 4 mod 32: a warp's fragment reads hit 32 banks
    a.stride = ((span / 4 + 31) / 32 * 32 + 4) * 4;
  } else if constexpr (HQ == kFmtInt4) {
    a.half = span;  // element j + D/2 meets packed byte j
    a.stride = (2 * span + 127) / 128 * 128 + 16;  // 16 mod 128 bytes
  } else {
    a.stride = (span + 127) / 128 * 128 + 16;
  }
  return a;
}

// dynamic shared memory of a head block for a group of up to G rows: the
// ring and the G activation rows (an n8 tile's rows past G read row G - 1:
// their sums are dropped); the staged logits reuse the ring. At most
// kHeadRing + G (D + 36) floats' bytes in every format
// (ops/decode_step.py's kernel_takes and batched_kernel_takes keep that
// within a block's shared memory).
template <int HQ, typename T>
size_t head_smem(int D, int G) {
  return (size_t)kHeadRing + (size_t)head_act<HQ, T>(D).stride * G;
}

// The ring slot's 16-byte chunk c (0..3) of tile row r: stored at chunk
// c ^ ((r >> 1) & 3), so the 8 rows of an ldmatrix read hit 32 banks.
__device__ __forceinline__ int head_chunk(int r, int c) {
  return r * kHeadStageBytes + 16 * (c ^ ((r >> 1) & 3));
}

// Stage s of the block's weight tile into `slot`: bytes [64 s, 64 s + 64)
// of vocab rows [v0, v0 + 128), zero past V and past the row's `rb` bytes.
// `vec` 16 or 4: cp.async of that width (rows aligned to it), else plain
// byte copies.
__device__ __forceinline__ void head_stage(unsigned char* slot,
                                           const unsigned char* w, int v0,
                                           int V, int rb, int s, int vec) {
  for (int i = threadIdx.x; i < kHeadBlockRows * 4; i += kThreads) {
    const int r = i >> 2, c = i & 3, row = v0 + r;
    const int off = s * kHeadStageBytes + 16 * c;
    const int n = row < V ? max(0, min(16, rb - off)) : 0;
    const unsigned char* src = w + (size_t)row * rb + off;
    unsigned char* dst = slot + head_chunk(r, c);
    if (vec == 16) {
      cp_async16(smem_u32(dst), n ? src : w, n);
    } else if (vec == 4) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const int m = max(0, min(4, n - j));
        cp_async4(smem_u32(dst + j), m ? src + j : w, m);
      }
    } else {
      for (int j = 0; j < 16; ++j) dst[j] = j < n ? src[j] : 0;
    }
  }
}

// The B operand from the G rows of the (B, D) residual h: RMSNorm(h[b]) *
// w, a warp a row (K1's load_normed_act: x / sqrt(mean(x^2) + 1e-6) * w,
// rounded to T; or float32 quantized with the row's amax: rint(x * (127 /
// amax)), scale amax / 127 in sx_s[b]); zero past D. Ends synchronised.
template <int HQ, typename T>
__device__ void head_norm_rows(const float* h, const T* w, int D, int G,
                               HeadAct a, unsigned char* act, float* sx_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < G; b += kWarps) {
    unsigned char* row = act + (size_t)b * a.stride;
    for (int i = lane; i < a.stride / 4; i += 32)  // zero, padding too
      reinterpret_cast<unsigned*>(row)[i] = 0u;
    __syncwarp();
    const float* x = h + (size_t)b * D;
    float ss = 0.f;
    for (int i = lane; i < D; i += 32) ss += x[i] * x[i];
    const float den = sqrtf(warp_sum(ss) / (float)D + 1e-6f);
    if constexpr (HQ == kFmtFloat) {
      for (int i = lane; i < D; i += 32)
        reinterpret_cast<T*>(row)[i] = from_f<T>(x[i] / den * to_f(w[i]));
    } else {
      float amax = 0.f;
      for (int i = lane; i < D; i += 32)
        amax = fmaxf(amax, fabsf(x[i] / den * to_f(w[i])));
      amax = fmaxf(warp_max(amax), 1e-30f);
      const float inv = 127.0f / amax;
      const int K2 = D / 2;
      for (int i = lane; i < D; i += 32) {
        const int8_t q = (int8_t)rintf(x[i] / den * to_f(w[i]) * inv);
        const int at = HQ == kFmtInt4 && i >= K2 ? a.half + (i - K2) : i;
        reinterpret_cast<int8_t*>(row)[at] = q;
      }
      if (lane == 0) sx_s[b] = amax * (1.0f / 127.0f);
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
// with the row's own scale (the TPU kernel's qvec_b).
template <typename T, int HQ, int NT>
__global__ void __launch_bounds__(kThreads)
head_mma_kernel(const float* __restrict__ h, const T* __restrict__ final_norm,
                const void* __restrict__ head_w,
                const float* __restrict__ head_s, const T* __restrict__ head_b,
                float* __restrict__ tile_val, int* __restrict__ tile_idx,
                float* __restrict__ logits, int B, int D, int V) {
  constexpr bool F32 = HQ == kFmtFloat && sizeof(T) == 4;
  constexpr bool INT = HQ != kFmtFloat;
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[NT * 8];
  const int b0 = blockIdx.y * 32, G = min(32, B - b0);
  h += (size_t)b0 * D;
  tile_val += (size_t)b0 * gridDim.x;
  tile_idx += (size_t)b0 * gridDim.x;
  if (logits != nullptr) logits += (size_t)b0 * V;
  const int v0 = blockIdx.x * kHeadBlockRows;
  const unsigned char* w = static_cast<const unsigned char*>(head_w);
  const int rb = (int)fmt_bytes<HQ, T>(D);  // bytes a weight row
  const int nst = (rb + kHeadStageBytes - 1) / kHeadStageBytes;
  const int vec = rb % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0
                      ? 16
                      : (rb % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0
                             ? 4 : 1);
  unsigned char* ring = smem_u8;
  unsigned char* act = smem_u8 + kHeadRing;
  const HeadAct a = head_act<HQ, T>(D);

#pragma unroll
  for (int s = 0; s < kHeadStages - 1; ++s) {
    if (s < nst)
      head_stage(ring + s * kHeadBlockRows * kHeadStageBytes, w, v0, V, rb,
                 s, vec);
    cp_async_commit();
  }
  head_norm_rows<HQ, T>(h, final_norm, D, G, a, act, sx_s);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  using Acc = typename std::conditional<INT, int, float>::type;
  Acc acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0;
  const int ar = 16 * warp + (lane & 15);  // this lane's ldmatrix row of A
  // this lane's ldmatrix row of B (n) and its 16-byte half of a k step
  const int bn = (lane & 7) + (NT > 1 ? 8 * (lane >> 4) : 0);
  const int bh = 16 * ((lane >> 3) & 1);

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kHeadStages - 2>();
    __syncthreads();  // stage st is in; every warp is done with st - 1
    const int nx = st + kHeadStages - 1;
    if (nx < nst)
      head_stage(ring + (nx % kHeadStages) * kHeadBlockRows * kHeadStageBytes,
                 w, v0, V, rb, nx, vec);
    cp_async_commit();
    const unsigned char* s_w =
        ring + (st % kHeadStages) * kHeadBlockRows * kHeadStageBytes;
    const int kb = st * kHeadStageBytes;  // the stage's first weight byte
    if constexpr (F32) {
      // 3xTF32: 16 floats a stage, two k8 steps of chunks (2 ks, 2 ks + 1)
      const float* xs = reinterpret_cast<const float*>(act);
      const int fst = a.stride / 4;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int r0 = 16 * warp + g;
        const float* pw = reinterpret_cast<const float*>(s_w) + q;
        unsigned ah[4], al[4];
        split<true>({pw[head_chunk(r0, 2 * ks) / 4],
                     pw[head_chunk(r0 + 8, 2 * ks) / 4],
                     pw[head_chunk(r0, 2 * ks + 1) / 4],
                     pw[head_chunk(r0 + 8, 2 * ks + 1) / 4]}, ah, al);
        const int k = kb / 4 + 8 * ks + q;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const float* xn = xs + min(8 * t + g, G - 1) * fst + k;
          unsigned bh2[2], bl2[2];
          split<true>({xn[0], xn[4]}, bh2, bl2);
          mma3<true, true>(acc[t], ah, al, bh2, bl2);
        }
      }
    } else {
      // 16-bit or 8-bit elements: 32 bytes a k step, two a stage
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned av[4];
        ldmatrix_x4(smem_u32(s_w + head_chunk(ar, 2 * ks + (lane >> 4))), av);
        const int kbyte = kb + 32 * ks;  // activation byte of the k step
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          unsigned bv[4];
          const unsigned char* brow =
              act + (size_t)min(8 * t + bn, G - 1) * a.stride;
          if (NT > 1)
            ldmatrix_x4(smem_u32(brow + kbyte + bh), bv);
          else
            ldmatrix_x2(smem_u32(brow + kbyte + bh),
                        reinterpret_cast<unsigned(&)[2]>(bv));
          if constexpr (HQ == kFmtInt4) {
            unsigned hv[4];
            if (NT > 1)
              ldmatrix_x4(smem_u32(brow + a.half + kbyte + bh), hv);
            else
              ldmatrix_x2(smem_u32(brow + a.half + kbyte + bh),
                          reinterpret_cast<unsigned(&)[2]>(hv));
            const unsigned lo[4] = {nibbles_lo(av[0]), nibbles_lo(av[1]),
                                    nibbles_lo(av[2]), nibbles_lo(av[3])};
            const unsigned hi[4] = {nibbles_hi(av[0]), nibbles_hi(av[1]),
                                    nibbles_hi(av[2]), nibbles_hi(av[3])};
#pragma unroll
            for (int u = 0; u < 2 && t + u < NT; ++u) {
              mma_s8(acc[t + u], lo, bv[2 * u], bv[2 * u + 1]);
              mma_s8(acc[t + u], hi, hv[2 * u], hv[2 * u + 1]);
            }
          } else if constexpr (HQ == kFmtInt8) {
#pragma unroll
            for (int u = 0; u < 2 && t + u < NT; ++u)
              mma_s8(acc[t + u], av, bv[2 * u], bv[2 * u + 1]);
          } else {
#pragma unroll
            for (int u = 0; u < 2 && t + u < NT; ++u)
              mma_bf16(acc[t + u], av, bv[2 * u], bv[2 * u + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is consumed: the logits reuse it

  // fragment e of tile t: vocab row 16 warp + g + 8 (e >> 1), group row
  // 8 t + 2 q + (e & 1); staged as lg[b][r], 128 + 4 floats a row
  constexpr int kLgRow = kHeadBlockRows + 4;
  float* lg = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + g + 8 * (e >> 1), b = 8 * t + 2 * q + (e & 1);
      const int row = v0 + r;
      if (b >= G || row >= V) continue;
      float logit;
      if constexpr (INT)  // rounded as the plain version: no fused multiply-add
        logit = __fadd_rn(__fmul_rn((float)acc[t][e],
                                    __fmul_rn(head_s[row], sx_s[b])),
                          to_f(head_b[row]));
      else
        logit = __fadd_rn(acc[t][e], to_f(head_b[row]));
      lg[b * kLgRow + r] = logit;
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
