// The tensor-core machinery of the decode steps' products, shared by the head
// stage (head.cuh) and the layer stages (decode_token_batched.cuh) of K1 and
// K2, which K10 (decode_step.cu) runs too: the activation rows of a group of
// up to 32 rows made the B operand a warp a row, a weight tile's 64-byte
// stages copied by cp.async into swizzled shared memory, and one stage's
// mma.sync products (bfloat16 or float16 m16n8k16 with float32 sums, int8
// m16n8k32 with exact int32 sums, int4 unpacked to int8 in registers, float32
// in 3xTF32).
//
// A product element depends only on its weight row and its activation row:
// the k steps run in the same order whatever the group's size, and an n8
// tile's columns past the group read its last row, so a row's sums are the
// same bits at any group size.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTileStageBytes = 64;  // bytes of a weight row a stage
constexpr int kTileStages = 4;       // depth of a cp.async ring

// Layout of the activation rows (the B operand) in shared memory: `stride`
// bytes a row; int4's upper half (elements K/2 ..) starts `half` bytes into
// a row.
struct ActRows {
  int stride, half;
};

// The layout of rows of K elements for weights of format Q: a row covers
// the bytes the weight stages cover, zero past K, padded so that the rows
// of an ldmatrix (or a float32 fragment) read hit 32 banks.
template <int Q, typename T>
__host__ __device__ __forceinline__ ActRows act_rows(int K) {
  const int nst = ((int)fmt_bytes<Q, T>(K) + kTileStageBytes - 1) /
                  kTileStageBytes;
  const int span = nst * kTileStageBytes;  // weight bytes the stages cover
  ActRows a{0, 0};
  if constexpr (Q == kFmtFloat && sizeof(T) == 4) {
    // floats a row = 4 mod 32: a warp's fragment reads hit 32 banks
    a.stride = ((span / 4 + 31) / 32 * 32 + 4) * 4;
  } else if constexpr (Q == kFmtInt4) {
    a.half = span;  // element j + K/2 meets packed byte j
    a.stride = (2 * span + 127) / 128 * 128 + 16;  // 16 mod 128 bytes
  } else {
    a.stride = (span + 127) / 128 * 128 + 16;
  }
  return a;
}

// The stage slot's 16-byte chunk c (0..3) of tile row r: stored at chunk
// c ^ ((r >> 1) & 3), so the 8 rows of an ldmatrix read hit 32 banks.
__device__ __forceinline__ int tile_chunk(int r, int c) {
  return r * kTileStageBytes + 16 * (c ^ ((r >> 1) & 3));
}

// The widest cp.async the rows of a weight matrix at `w`, `rb` bytes each,
// take: 16 or 4 bytes (rows aligned to it), else 1 (plain byte copies).
__device__ __forceinline__ int tile_vec(const void* w, int rb) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(w);
  return rb % 16 == 0 && p % 16 == 0 ? 16 : (rb % 4 == 0 && p % 4 == 0 ? 4
                                                                       : 1);
}

// Stage s of a weight tile of R rows into `slot`: bytes [64 s, 64 s + 64)
// of rows w + r * rb, zero for rows r >= nrows and past a row's rb bytes,
// copied by threads t0, t0 + nt, ... of the block with cp.async of width
// `vec` (tile_vec).
template <int R>
__device__ __forceinline__ void tile_stage(unsigned char* slot,
                                           const unsigned char* w, int nrows,
                                           int rb, int s, int vec, int t0,
                                           int nt) {
  for (int i = t0; i < R * 4; i += nt) {
    const int r = i >> 2, c = i & 3;
    const int off = s * kTileStageBytes + 16 * c;
    const int n = r < nrows ? max(0, min(16, rb - off)) : 0;
    const unsigned char* src = w + (size_t)r * rb + off;
    unsigned char* dst = slot + tile_chunk(r, c);
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

// The B operand of a product with weights of format Q from G rows of K
// values, a warp a row: row b is src + t * K with t = tok[b] clipped to
// [0, V) (an embedding gather), or t = b without `tok`. With `w` the row is
// RMSNorm(row) * w first: x / sqrt(mean(x^2) + 1e-6) * w, the sum of squares
// over the warp. Then it is rounded to T, or quantized with the row's own
// amax (float32: amax = max(max |x|, 1e-30), rint(x * (127 / amax)), no
// clip; sx_s[b] = amax / 127), as the TPU kernel's qvec_b. Zero past K.
// Ends synchronised.
template <int Q, typename T, typename S>
__device__ void load_act_rows(const S* src, const int* tok, int V,
                              const T* w, int K, int G, ActRows a,
                              unsigned char* act, float* sx_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = warp; b < G; b += kWarps) {
    unsigned char* row = act + (size_t)b * a.stride;
    for (int i = lane; i < a.stride / 4; i += 32)  // zero, padding too
      reinterpret_cast<unsigned*>(row)[i] = 0u;
    __syncwarp();
    const S* x =
        src + (size_t)(tok == nullptr ? b : min(max(tok[b], 0), V - 1)) * K;
    float den = 1.f;
    if (w != nullptr) {
      float ss = 0.f;
      for (int i = lane; i < K; i += 32) ss += to_f(x[i]) * to_f(x[i]);
      den = sqrtf(warp_sum(ss) / (float)K + 1e-6f);
    }
    auto value = [&](int i) {
      return w != nullptr ? to_f(x[i]) / den * to_f(w[i]) : to_f(x[i]);
    };
    if constexpr (Q == kFmtFloat) {
      for (int i = lane; i < K; i += 32)
        reinterpret_cast<T*>(row)[i] = from_f<T>(value(i));
    } else {
      float amax = 0.f;
      for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(value(i)));
      amax = fmaxf(warp_max(amax), 1e-30f);
      const float inv = 127.0f / amax;
      const int K2 = K / 2;
      for (int i = lane; i < K; i += 32) {
        const int8_t q = (int8_t)rintf(value(i) * inv);
        const int at = Q == kFmtInt4 && i >= K2 ? a.half + (i - K2) : i;
        reinterpret_cast<int8_t*>(row)[at] = q;
      }
      if (lane == 0) sx_s[b] = amax * (1.0f / 127.0f);
    }
  }
  __syncthreads();
}

// The products' sums: exact int32 for int8/int4 weights, else float32
template <int Q>
using MmaAcc = typename std::conditional<Q == kFmtFloat, float, int>::type;

// One stage of a 16-row weight tile (s_w: its rows 0..15 as tile_stage
// stores them) times the group's G activation rows: acc[t] += the tile x
// rows [8 t, 8 t + 8) of the group over the stage's k, whose first weight
// byte is kb. An n8 tile's rows past G read row G - 1 (their sums are not
// used). bfloat16 or float16 weights: m16n8k16 of that type (the activations
// are rounded to it, so every product is exact); int8: m16n8k32 s8; int4: the
// packed bytes unpacked to their low- and high-nibble int8 operands in
// registers (element j and j + K/2 of ops/quant.py's layout), two IMMAs a
// fragment;
// float32: 3xTF32, each k8 step's products summed apart and then added.
template <int Q, typename T, int NT>
__device__ __forceinline__ void mma_stage(MmaAcc<Q> (&acc)[NT][4],
                                          const unsigned char* s_w,
                                          const unsigned char* act, ActRows a,
                                          int G, int kb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  if constexpr (Q == kFmtFloat && sizeof(T) == 4) {
    // 3xTF32: 16 floats a stage, two k8 steps of chunks (2 ks, 2 ks + 1)
    const float* xs = reinterpret_cast<const float*>(act);
    const int fst = a.stride / 4;
    const float* pw = reinterpret_cast<const float*>(s_w) + q;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned ah[4], al[4];
      split<true>({pw[tile_chunk(g, 2 * ks) / 4],
                   pw[tile_chunk(g + 8, 2 * ks) / 4],
                   pw[tile_chunk(g, 2 * ks + 1) / 4],
                   pw[tile_chunk(g + 8, 2 * ks + 1) / 4]}, ah, al);
      const int k = kb / 4 + 8 * ks + q;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float* xn = xs + min(8 * t + g, G - 1) * fst + k;
        unsigned bh2[2], bl2[2];
        split<true>({xn[0], xn[4]}, bh2, bl2);
        // the tensor cores truncate each sum they round: a k8 step's large
        // product (hi hi) and its two small ones go to fresh accumulators
        // of their own, added to the running sum with round-to-nearest
        // adds, so a truncation is never of more than one k8 step's terms
        float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(small, al, bh2);
        mma_tf32(small, ah, bl2);
        mma_tf32(big, ah, bh2);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] += big[e] + small[e];
      }
    }
  } else {
    // 16-bit or 8-bit elements: 32 bytes a k step, two a stage
    const int ar = lane & 15;  // this lane's ldmatrix row of A
    // this lane's ldmatrix row of B (n) and its 16-byte half of a k step
    const int bn = (lane & 7) + (NT > 1 ? 8 * (lane >> 4) : 0);
    const int bh = 16 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned av[4];
      ldmatrix_x4(smem_u32(s_w + tile_chunk(ar, 2 * ks + (lane >> 4))), av);
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
        if constexpr (Q == kFmtInt4) {
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
        } else if constexpr (Q == kFmtInt8) {
#pragma unroll
          for (int u = 0; u < 2 && t + u < NT; ++u)
            mma_s8(acc[t + u], av, bv[2 * u], bv[2 * u + 1]);
        } else {
#pragma unroll
          for (int u = 0; u < 2 && t + u < NT; ++u)
            mma16<T>(acc[t + u], av, bv[2 * u], bv[2 * u + 1]);
        }
      }
    }
  }
}

// A quantized product's sum rescaled as the plain version rounds it:
// float(acc) * (scale[r] * sx), each operation rounded on its own (no fused
// multiply-add); a float sum as it is
__device__ __forceinline__ float rescaled(float acc, const float*, int,
                                          float) {
  return acc;
}
__device__ __forceinline__ float rescaled(int acc, const float* scale, int r,
                                          float sx) {
  return __fmul_rn((float)acc, __fmul_rn(scale[r], sx));
}

}  // namespace
