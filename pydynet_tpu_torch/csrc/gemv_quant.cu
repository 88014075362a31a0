// Weight-quantized matmuls of the big-dims decode lane on NVIDIA Hopper
// (sm_90a): per-row int8 activations times int8 or packed-int4 weights with
// an exact int32 accumulation and a float32 rescale.
//
// Replaces the Pallas TPU kernels of pydynet_tpu/ops/gemv_quant.py:
//   * K5, `_kgrid_kernel` (:172, launched by `_kgrid_call` :198 at :277 from
//     `qmatmul` :319-323): decode rows, M <= 32 -> `qmm_decode_kernel`;
//   * K6, `_qmm_kernel` (:136, launched by `qmatmul` :293 at :337): the same
//     product for M > 32 rows (prefill) -> `qmm_prefill_kernel`;
//   * K7, the inner `kernel` of `qmatmul_stacked` (:416, launched at :422;
//     its decode branch is K5 with the scalar-prefetched layer index,
//     :401-407): either kernel above on layer `idx` of layer-stacked
//     (L, K, N) weights. The kernels read the index from device memory
//     themselves and offset the weight and scale pointers, so no call
//     slices or copies the stacked weights.
// `quantize_rows_kernel` is the activation quantization that the JAX package
// leaves to XLA around the Pallas call (:309-315): a kernel here because as
// about six torch ops a matmul it would cost more launches than the
// matmuls themselves (4 matmuls x 32 layers a 7B token).
//
// The arithmetic is the JAX package's, bit for bit (`qmatmul_ref` :453):
//   amax = max(max_k |x[m, k]|, 1e-30); xq = rint(x * (127 / amax)) as int8;
//   sx = amax * (1 / 127); acc = sum_k xq[m, k] * w[k, n] in int32, exact;
//   out[m, n] = (float(acc) * ws[n]) * sx[m].
// rint is round half to even (`jnp.round`); 127 / amax is an IEEE division
// (no fast math: the build passes no --use_fast_math); the two products of
// the epilogue are rounded in that order. int32 sums are exact in any
// order, so splitting K over blocks and adding with atomics gives the same
// bits as one sequential sum.
//
// Layouts (the JAX package's, kept at the public function): x (M, K)
// float32 or bfloat16; w (K, N) int8, or (K/2, N) int4 packed two a byte
// (byte (k, n) holds w[k, n] in its low nibble and w[k + K/2, n] in its high
// nibble, `ops/quant.py:quantize_int4`); ws (N,) float32 per output
// channel; out (M, N) float32. Stacked: w (L, Kst, N), ws (L, N). N must be
// a multiple of 4 (one 32-bit word holds 4 neighbouring columns).
//
// What bounds them on an H100: a decode step streams every weight byte once
// for a handful of rows, about 2 operations a byte, far below the ~600 int8
// operations a byte where the card's arithmetic would bind. So K5/K7 are
// bound by the weight bytes over 3.35 TB/s (a Llama-2-7B int8 token is
// 6.6 GB of weights, 1.97 ms). The decode kernel's design for that:
//   * neighbouring threads own neighbouring 4-column words of a weight row,
//     so a warp reads 128 contiguous bytes a row, and every weight byte is
//     read from device memory once a call, for all M rows;
//   * blocks split K as well as N, so N = 4096 (wo, down) still puts about
//     1024 blocks on 132 SMs; each block reduces its warps' int32 partial
//     sums in shared memory, adds them to an int32 (M, N) buffer with
//     atomics, and the last block of a column tile (a counter) writes the
//     float32 epilogue, so the call is one launch after the quantization;
//   * four rows of a thread's word are transposed with `__byte_perm` into
//     one word a column, so one `__dp4a` does 4 multiply-adds of a column;
//     int4 nibbles are unpacked a word at a time (mask, xor 8, per-byte
//     subtract 8 with `__vsub4`: the signed nibble, as `(p << 28) >> 28`
//     and `p >> 4` give it);
//   * the activations of the block's K slice wait in shared memory (a warp
//     reads the same word: a broadcast), and rows are held in registers 8
//     at a time (at M = 32, 4 columns x 32 rows of sums would spill), the
//     weights of later row tiles coming from L1.
// The prefill kernel (M > 32) is a tiled product on CUDA cores: 64 x 128
// outputs a block, 32 packed weight rows a step, both tiles transposed into
// shared memory as k-words so each thread runs 4 x 8 `__dp4a` a word. Any
// M: no row slabs. Tensor-core products (IMMA / wgmma), TMA and a pipelined
// weight stream are left for a later change.

#include "common.cuh"

namespace {

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kTileCols = 128;        // columns of a block: 32 lanes x 4
constexpr int kMaxDecodeRows = 32;    // ops/gemv_quant.py MAX_DECODE_ROWS
constexpr int kMaxSlice = 256;        // packed weight rows of a K slice
constexpr int kTargetBlocks = 1024;   // about 8 blocks an SM on 132 SMs
constexpr int kBM = 64, kBN = 128, kBK = 32;  // prefill tile; kBK packed rows
constexpr int kBKW = kBK / 4 + 1;     // k-words a row of a tile, padded odd

__device__ __forceinline__ int layer_of(const int* idx, int idx_host,
                                        int L) {
  if (idx == nullptr) return idx_host;
  const int l = *idx;  // clamped, as jax.lax.dynamic_index_in_dim does
  return l < 0 ? 0 : (l >= L ? L - 1 : l);
}

// 4 words of 4 int8 columns (rows r0..r3) -> 4 words of 4 int8 rows
// (columns c[0..3]): byte i of c[j] is byte j of r_i
__device__ __forceinline__ void transpose4(unsigned r0, unsigned r1,
                                           unsigned r2, unsigned r3,
                                           int* c) {
  const unsigned a = __byte_perm(r0, r1, 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const unsigned b = __byte_perm(r2, r3, 0x5140);  // r2.0 r3.0 r2.1 r3.1
  const unsigned e = __byte_perm(r0, r1, 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const unsigned f = __byte_perm(r2, r3, 0x7362);  // r2.2 r3.2 r2.3 r3.3
  c[0] = (int)__byte_perm(a, b, 0x5410);
  c[1] = (int)__byte_perm(a, b, 0x7632);
  c[2] = (int)__byte_perm(e, f, 0x5410);
  c[3] = (int)__byte_perm(e, f, 0x7632);
}

__device__ __forceinline__ unsigned load_word(const int8_t* w, size_t off) {
  return __ldg(reinterpret_cast<const unsigned*>(w + off));
}

__device__ __forceinline__ float epilogue(int acc, float ws, float sx) {
  return __fmul_rn(__fmul_rn((float)acc, ws), sx);
}

// One block per row: xq = rint(x * (127 / amax)), sx = amax / 127
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int K) {
  __shared__ float red[kWarps];
  const T* row = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQThreads)
    amax = fmaxf(amax, fabsf(to_f(row[k])));
  amax = fmaxf(block_max(amax, red), 1e-30f);
  const float q = 127.0f / amax;
  int8_t* out = xq + (size_t)blockIdx.x * K;
  for (int k = threadIdx.x; k < K; k += kQThreads)
    out[k] = (int8_t)__float2int_rn(__fmul_rn(to_f(row[k]), q));
  if (threadIdx.x == 0) sx[blockIdx.x] = __fmul_rn(amax, 1.0f / 127.0f);
}

// Packed weight rows a decode block takes: enough K splits for about
// kTargetBlocks blocks, a multiple of 32 (8 warps x 4 rows), at most
// kMaxSlice.
int decode_slice(int Kst, int N) {
  const int tiles = (N + kTileCols - 1) / kTileCols;
  const int want = (kTargetBlocks + tiles - 1) / tiles;
  int slice = (Kst + want - 1) / want;
  slice = (slice + 31) / 32 * 32;
  return slice > kMaxSlice ? kMaxSlice : slice;
}

// Decode rows (M <= 32). Block (tile, s): columns [128 tile, 128 tile + 128)
// and packed weight rows [s * slice, s * slice + slice); warp w takes the
// groups of 4 rows w, w + 8, ...; lane l owns columns 4l..4l+3 of the tile.
// Rows are computed MT at a time. Shared memory: the block's int32 sums
// (M x 128) and its K slice of xq (two halves for int4), zero-padded.
template <int MT, bool Q4>
__global__ void __launch_bounds__(kQThreads)
qmm_decode_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  const int8_t* __restrict__ w, const float* __restrict__ ws,
                  const int* __restrict__ idx, int idx_host, int L,
                  int* __restrict__ acc, unsigned* __restrict__ count,
                  float* __restrict__ out, int M, int K, int N, int slice) {
  extern __shared__ int s_dyn[];
  __shared__ bool s_last;
  constexpr int kHalves = Q4 ? 2 : 1;
  const int Kst = Q4 ? K / 2 : K;
  const int layer = layer_of(idx, idx_host, L);
  w += (size_t)layer * Kst * N;
  ws += (size_t)layer * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * kTileCols;
  const int n0 = col0 + 4 * lane;
  const int k0 = blockIdx.y * slice;
  const int rows = min(slice, Kst - k0);
  const int Mpad = (M + MT - 1) / MT * MT;

  int* s_acc = s_dyn;                                  // [M][128]
  int8_t* s_x = reinterpret_cast<int8_t*>(s_acc + M * kTileCols);
  for (int i = threadIdx.x; i < M * kTileCols; i += kQThreads) s_acc[i] = 0;
  // s_x[h][m][j] = xq[m, h * Kst + k0 + j], 0 past the slice or past M
  for (int i = threadIdx.x; i < kHalves * Mpad * slice; i += kQThreads) {
    const int j = i % slice, m = (i / slice) % Mpad, h = i / (slice * Mpad);
    s_x[i] = (m < M && j < rows)
                 ? xq[(size_t)m * K + (size_t)h * Kst + k0 + j]
                 : (int8_t)0;
  }
  __syncthreads();

  for (int mt0 = 0; mt0 < M; mt0 += MT) {
    int a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[m][c] = 0;
#pragma unroll 2
    for (int g = warp; 4 * g < rows; g += kQWarps) {
      const int r = k0 + 4 * g;
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (r + i < Kst && n0 < N) ? load_word(w, (size_t)(r + i) * N + n0)
                                       : 0u;
      int cl[4], ch[4];
      if constexpr (Q4) {
        transpose4(nibbles_lo(v[0]), nibbles_lo(v[1]), nibbles_lo(v[2]),
                   nibbles_lo(v[3]), cl);
        transpose4(nibbles_hi(v[0]), nibbles_hi(v[1]), nibbles_hi(v[2]),
                   nibbles_hi(v[3]), ch);
      } else {
        transpose4(v[0], v[1], v[2], v[3], cl);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xl = *reinterpret_cast<const int*>(
            s_x + (size_t)(mt0 + m) * slice + 4 * g);
#pragma unroll
        for (int c = 0; c < 4; ++c) a[m][c] = __dp4a(cl[c], xl, a[m][c]);
        if constexpr (Q4) {
          const int xh = *reinterpret_cast<const int*>(
              s_x + (size_t)(Mpad + mt0 + m) * slice + 4 * g);
#pragma unroll
          for (int c = 0; c < 4; ++c) a[m][c] = __dp4a(ch[c], xh, a[m][c]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if (mt0 + m < M)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          atomicAdd(&s_acc[(mt0 + m) * kTileCols + 4 * lane + c], a[m][c]);
  }
  __syncthreads();

  const int ncols = min(kTileCols, N - col0);
  if (gridDim.y == 1) {  // the whole K in this block: write the result
    for (int i = threadIdx.x; i < M * kTileCols; i += kQThreads) {
      const int m = i / kTileCols, c = i % kTileCols;
      if (c < ncols)
        out[(size_t)m * N + col0 + c] = epilogue(s_acc[i], ws[col0 + c],
                                                 sx[m]);
    }
    return;
  }
  for (int i = threadIdx.x; i < M * kTileCols; i += kQThreads) {
    const int m = i / kTileCols, c = i % kTileCols;
    if (c < ncols) atomicAdd(&acc[(size_t)m * N + col0 + c], s_acc[i]);
  }
  // the last block of the column tile to finish writes the epilogue
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&count[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < M * kTileCols; i += kQThreads) {
    const int m = i / kTileCols, c = i % kTileCols;
    if (c < ncols) {
      const size_t o = (size_t)m * N + col0 + c;
      out[o] = epilogue(__ldcg(&acc[o]), ws[col0 + c], sx[m]);
    }
  }
}

// Prefill rows (any M). Block (bx, by): rows [64 by, 64 by + 64) and columns
// [128 bx, 128 bx + 128); thread (ty, tx) of 16 x 16 owns rows 4 ty + i and
// columns tx + 16 j. Each step takes 32 packed weight rows: the weight tile
// transposed to k-words a column (two, lo and hi, for int4) and the xq tile
// as k-words a row, in shared memory with an odd row stride.
template <bool Q4>
__global__ void __launch_bounds__(kQThreads)
qmm_prefill_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ ws, const int* __restrict__ idx,
                   int idx_host, int L, float* __restrict__ out, int M, int K,
                   int N) {
  constexpr int kHalves = Q4 ? 2 : 1;
  __shared__ int s_w[kHalves][kBN][kBKW];
  __shared__ int s_x[kHalves][kBM][kBKW];
  const int Kst = Q4 ? K / 2 : K;
  const int layer = layer_of(idx, idx_host, L);
  w += (size_t)layer * Kst * N;
  ws += (size_t)layer * N;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * kBM, nb = blockIdx.x * kBN;
  int a[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0;

  for (int k0 = 0; k0 < Kst; k0 += kBK) {
    {  // weights: thread -> rows k0 + 4 rg .. + 3, columns nb + 4 cw .. + 3
      const int rg = t >> 5, cw = t & 31;
      const int n = nb + 4 * cw, r = k0 + 4 * rg;
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = (r + i < Kst && n < N) ? load_word(w, (size_t)(r + i) * N + n)
                                      : 0u;
      int c[4];
      if constexpr (Q4) {
        transpose4(nibbles_lo(v[0]), nibbles_lo(v[1]), nibbles_lo(v[2]),
                   nibbles_lo(v[3]), c);
#pragma unroll
        for (int j = 0; j < 4; ++j) s_w[0][4 * cw + j][rg] = c[j];
        transpose4(nibbles_hi(v[0]), nibbles_hi(v[1]), nibbles_hi(v[2]),
                   nibbles_hi(v[3]), c);
#pragma unroll
        for (int j = 0; j < 4; ++j) s_w[kHalves - 1][4 * cw + j][rg] = c[j];
      } else {
        transpose4(v[0], v[1], v[2], v[3], c);
#pragma unroll
        for (int j = 0; j < 4; ++j) s_w[0][4 * cw + j][rg] = c[j];
      }
    }
    {  // xq: thread -> row m0 + r, 8 bytes from column k0 + kb of each half
      const int r = t >> 2, kb = 8 * (t & 3), m = m0 + r;
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          unsigned word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = k0 + kb + 4 * j + b;
            const unsigned byte =
                (m < M && k < Kst)
                    ? (unsigned)(uint8_t)xq[(size_t)m * K + (size_t)h * Kst +
                                            k]
                    : 0u;
            word |= byte << (8 * b);
          }
          s_x[h][r][kb / 4 + j] = (int)word;
        }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int kw = 0; kw < kBK / 4; ++kw) {
        int xw[4], ww[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xw[i] = s_x[h][4 * ty + i][kw];
#pragma unroll
        for (int j = 0; j < 8; ++j) ww[j] = s_w[h][tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][j] = __dp4a(ww[j], xw[i], a[i][j]);
      }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = epilogue(a[i][j], ws[n], sx[m]);
    }
  }
}

template <int MT, bool Q4>
cudaError_t decode(const int8_t* xq, const float* sx, const int8_t* w,
                   const float* ws, const int* idx, int idx_host, int L,
                   int* scratch, float* out, int M, int K, int N,
                   cudaStream_t st) {
  const int Kst = Q4 ? K / 2 : K;
  const int slice = decode_slice(Kst, N);
  const int tiles = (N + kTileCols - 1) / kTileCols;
  const int splits = (Kst + slice - 1) / slice;
  const int Mpad = (M + MT - 1) / MT * MT;
  const size_t smem = (size_t)M * kTileCols * sizeof(int) +
                      (size_t)(Q4 ? 2 : 1) * Mpad * slice;
  unsigned* count = reinterpret_cast<unsigned*>(scratch + (size_t)M * N);
  qmm_decode_kernel<MT, Q4><<<dim3(tiles, splits), kQThreads, smem, st>>>(
      xq, sx, w, ws, idx, idx_host, L, scratch, count, out, M, K, N, slice);
  return cudaGetLastError();
}

template <bool Q4>
cudaError_t dispatch_decode(const int8_t* xq, const float* sx,
                            const int8_t* w, const float* ws, const int* idx,
                            int idx_host, int L, int* scratch, float* out,
                            int M, int K, int N, cudaStream_t st) {
  if (M == 1)
    return decode<1, Q4>(xq, sx, w, ws, idx, idx_host, L, scratch, out, M, K,
                         N, st);
  if (M == 2)
    return decode<2, Q4>(xq, sx, w, ws, idx, idx_host, L, scratch, out, M, K,
                         N, st);
  if (M <= 4)
    return decode<4, Q4>(xq, sx, w, ws, idx, idx_host, L, scratch, out, M, K,
                         N, st);
  return decode<8, Q4>(xq, sx, w, ws, idx, idx_host, L, scratch, out, M, K,
                       N, st);
}

template <bool Q4>
cudaError_t prefill(const int8_t* xq, const float* sx, const int8_t* w,
                    const float* ws, const int* idx, int idx_host, int L,
                    float* out, int M, int K, int N, cudaStream_t st) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  qmm_prefill_kernel<Q4><<<grid, kQThreads, 0, st>>>(
      xq, sx, w, ws, idx, idx_host, L, out, M, K, N);
  return cudaGetLastError();
}

bool bad_shape(int q4, int M, int K, int N, int L, int idx_host) {
  return M < 1 || K < 1 || N < 4 || N % 4 != 0 || L < 1 ||
         (q4 && K % 2 != 0) || idx_host < 0 || idx_host >= L ||
         (M + kBM - 1) / kBM > 65535;
}

}  // namespace

extern "C" {

// dtype 0: float32 x, 1: bfloat16. xq (M, K) int8 and sx (M,) float32 out.
int pdt_quantize_rows(int dtype, const void* x, void* xq, void* sx, int M,
                      int K, void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quantize_rows_kernel<float><<<M, kQThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sx), K);
  else if (dtype == 1)
    quantize_rows_kernel<__nv_bfloat16><<<M, kQThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(sx), K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// int32s of zeroed scratch the product of M rows needs: the decode kernel's
// (M, N) sums and its column-tile counters when it splits K; none for the
// prefill kernel or a single K slice.
int pdt_qmm_scratch_ints(int q4, int M, int K, int N) {
  const int Kst = q4 ? K / 2 : K;
  if (M > kMaxDecodeRows || Kst <= decode_slice(Kst, N)) return 0;
  return M * N + (N + kTileCols - 1) / kTileCols;
}

// out (M, N) float32 = the product of xq (M, K) int8 with row scales sx (M,)
// and layer `*idx` (or `idx_host` when idx is null) of w (L, Kst, N) int8
// with channel scales ws (L, N); q4: Kst = K / 2 packed int4 rows. M <= 32
// runs the decode kernel, which needs `scratch` zeroed
// (pdt_qmm_scratch_ints); larger M the prefill kernel. Returns the CUDA
// error of the launch, or cudaErrorInvalidValue for a shape it does not
// take.
int pdt_qmm(int q4, const void* xq, const void* sx, const void* w,
            const void* ws, const void* idx, int idx_host, int L,
            void* scratch, void* out, int M, int K, int N, void* stream) {
  if (bad_shape(q4, M, K, N, L, idx_host)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* wsf = static_cast<const float*>(ws);
  const int* ip = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  int* s = static_cast<int*>(scratch);
  cudaError_t e;
  if (M <= kMaxDecodeRows)
    e = q4 ? dispatch_decode<true>(x8, sxf, w8, wsf, ip, idx_host, L, s, o,
                                   M, K, N, st)
           : dispatch_decode<false>(x8, sxf, w8, wsf, ip, idx_host, L, s, o,
                                    M, K, N, st);
  else
    e = q4 ? prefill<true>(x8, sxf, w8, wsf, ip, idx_host, L, o, M, K, N, st)
           : prefill<false>(x8, sxf, w8, wsf, ip, idx_host, L, o, M, K, N,
                            st);
  return (int)e;
}

}  // extern "C"
