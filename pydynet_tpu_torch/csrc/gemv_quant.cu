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
// The prefill kernel (M > 32) does 2 M K N int8 operations on K N weight
// bytes: at M = 256 and (4096, 22016) that is 46 G operations against
// 90 MB, about 23 us on the int8 tensor cores (1,979 TOP/s) and 27 us of
// bytes, so the weight stream and how fast it reaches the tensor cores
// bound it, never CUDA-core arithmetic. Its design:
//   * the products run on the tensor cores: `mma.sync.m16n8k32` s8 x s8 ->
//     s32 (IMMA; not `.satfinite`, so the int32 sums stay exact and the
//     result bit-identical to the plain version). A block owns 64 rows x
//     128 columns, each of its 4 warps 64 rows x 32 columns: 4 x 4 IMMA
//     tiles, 64 int32 sums a thread;
//   * both operands stream through a 4-stage ring in shared memory, 64
//     packed weight rows a stage, by 16-byte `cp.async` (weights: 4-byte
//     when N is not a multiple of 16; activations: 4-byte, or plain byte
//     copies, when the packed K is not a multiple of 16, or of 4),
//     zero-filled past M, K and N: three stages are in flight while one is
//     multiplied;
//   * IMMA wants B K-major (4 consecutive k of one column in a register)
//     and the weights are (K, N) N-major, kept as the JAX package stores
//     them (no second, transposed copy). The weight tile is staged raw;
//     each lane reads one 4-column word from 4 consecutive k-rows and
//     transposes the 4 words with `transpose4` (`__byte_perm`) into 4
//     registers that are already B fragments: a lane's 4 columns are the
//     same fragment column of 4 different n8 tiles, and the 4 lanes of a
//     fragment column hold 4 k-groups, whose rows the tile's 16-byte
//     chunks are swizzled for (conflict-free reads). The output columns
//     come out in that permuted order, which makes each lane's 4 tiles 4
//     neighbouring columns: the epilogue writes float4s. int4 words are
//     unpacked in the same registers into the k and k + K/2 fragments,
//     which meet the two halves of the xq row;
//   * activations are read with `ldmatrix` from rows padded to 80 bytes;
//   * the M tile is the fast grid index, so the blocks that share a
//     column tile run together and the weights come from device memory
//     about once: (4096, 22016) at M = 256 is 4 x 172 = 688 blocks.
// `wgmma` (a warpgroup reading B from shared memory, which would need the
// K-major tile written there first) and TMA are the next step.

#include "common.cuh"

namespace {

constexpr int kQThreads = 256;
constexpr int kQWarps = kQThreads / 32;
constexpr int kTileCols = 128;        // columns of a block: 32 lanes x 4
constexpr int kMaxDecodeRows = 32;    // ops/gemv_quant.py MAX_DECODE_ROWS
constexpr int kMaxSlice = 256;        // packed weight rows of a K slice
constexpr int kTargetBlocks = 1024;   // about 8 blocks an SM on 132 SMs
constexpr int kPM = 64, kPN = 128;   // prefill tile: rows, columns
constexpr int kPThreads = 128;        // prefill block: 4 warps x 32 columns
constexpr int kPK = 64;               // packed weight rows a prefill stage
constexpr int kPStages = 4;           // stages of the shared-memory ring
constexpr int kPRow = kPK + 16;       // bytes a row of an activation tile

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

// Prefill rows (any M). Block (bx, by): rows [64 bx, 64 bx + 64) and
// columns [128 by, 128 by + 128); warp w the 32 columns from 32 w. A stage
// is 64 packed weight rows: the raw (64, 128) weight tile and the (64, 64)
// activation tile of each half, in a ring of kPStages stages in dynamic
// shared memory. Lane l of a warp reads the 4-column word 4 (l >> 2) of the
// warp's columns from the k-rows 4 (l & 3) + i (and + 16) of each 32-row k
// step: transposed, word t is the B fragment of n8 tile t, whose fragment
// column l >> 2 is the physical column 4 (l >> 2) + t.
constexpr int kPBytes = kPK * kPN;  // raw weight tile of a stage

template <int kHalves>
__host__ __device__ constexpr int prefill_stage_bytes() {
  return kPBytes + kHalves * kPM * kPRow;
}

// The 16-byte chunk c of weight-tile row r is stored at chunk c ^ 2 (r / 4
// mod 4): the 4 k-groups of a warp's fragment read then fall in 4 different
// 8-bank groups.
__device__ __forceinline__ int chunk_swz(int r, int c) {
  return c ^ (((r >> 2) & 3) << 1);
}

// Copy packed k [k0, k0 + kPK) of the block's rows of each half of xq into
// `s` (kHalves tiles of kPM rows x kPRow bytes): thread t takes rows
// (t >> 2) + 32 p, bytes 16 (t & 3) .. + 15; zero past M and past Kst.
// `vec` 16 or 4: cp.async of that width (xq rows and halves aligned to it),
// else plain byte copies.
template <int kHalves>
__device__ __forceinline__ void load_a(int8_t* s, const int8_t* xq, int m0,
                                       int k0, int M, int K, int Kst,
                                       int vec) {
  const int c = 16 * (threadIdx.x & 3), k = k0 + c;
#pragma unroll
  for (int hp = 0; hp < kHalves * kPM / (kPThreads / 4); ++hp) {
    const int h = hp / (kPM / (kPThreads / 4));
    const int r = (threadIdx.x >> 2) + (kPThreads / 4) *
                  (hp % (kPM / (kPThreads / 4)));
    const int m = m0 + r;
    int8_t* dst = s + (h * kPM + r) * kPRow + c;
    const int8_t* src = xq + (size_t)m * K + (size_t)h * Kst + k;
    if (vec == 16) {
      const int n = (m < M && k < Kst) ? 16 : 0;
      cp_async16(smem_u32(dst), n ? src : xq, n);
    } else if (vec == 4) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const int n = (m < M && k + j < Kst) ? 4 : 0;
        cp_async4(smem_u32(dst + j), n ? src + j : xq, n);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < 16; ++j)
        dst[j] = (m < M && k + j < Kst) ? src[j] : (int8_t)0;
    }
  }
}

// Copy packed weight rows [k0, k0 + kPK), columns [nb, nb + kPN) raw into
// `s` (row r at r * kPN, chunks swizzled), zero past Kst and N: 16-byte
// cp.async when `wvec` (N a multiple of 16, w 16-byte aligned), else 4-byte.
__device__ __forceinline__ void load_w(int8_t* s, const int8_t* w, int k0,
                                       int nb, int Kst, int N, bool wvec) {
  if (wvec) {  // 8 chunks a row, 16 rows a pass
    const int c = threadIdx.x & 7;
#pragma unroll
    for (int r = threadIdx.x >> 3; r < kPK; r += kPThreads / 8) {
      const bool ok = k0 + r < Kst && nb + 16 * c < N;
      const int8_t* src = w + (size_t)(k0 + r) * N + nb + 16 * c;
      cp_async16(smem_u32(s + r * kPN + 16 * chunk_swz(r, c)),
                 ok ? src : w, ok ? 16 : 0);
    }
    return;
  }
  const int wd = threadIdx.x & 31;  // 32 words a row, 4 rows a pass
#pragma unroll 4
  for (int r = threadIdx.x >> 5; r < kPK; r += kPThreads / 32) {
    const bool ok = k0 + r < Kst && nb + 4 * wd < N;
    const int8_t* src = w + (size_t)(k0 + r) * N + nb + 4 * wd;
    cp_async4(smem_u32(s + r * kPN + 16 * chunk_swz(r, wd >> 2) +
                       4 * (wd & 3)),
              ok ? src : w, ok ? 4 : 0);
  }
}

template <bool Q4>
__global__ void __launch_bounds__(kPThreads)
qmm_prefill_kernel(const int8_t* __restrict__ xq,
                   const float* __restrict__ sx,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ ws, const int* __restrict__ idx,
                   int idx_host, int L, float* __restrict__ out, int M, int K,
                   int N) {
  constexpr int kHalves = Q4 ? 2 : 1;
  constexpr int kStage = prefill_stage_bytes<kHalves>();
  extern __shared__ __align__(16) int8_t s_ring[];  // [stage][w tile, xq]
  const int Kst = Q4 ? K / 2 : K;
  const int layer = layer_of(idx, idx_host, L);
  w += (size_t)layer * Kst * N;
  ws += (size_t)layer * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane & 3, g = lane >> 2;
  const int m0 = blockIdx.x * kPM, nb = blockIdx.y * kPN;
  const int nw = nb + 32 * warp;  // the warp's first column
  const int vec = Kst % 16 == 0 ? 16 : (Kst % 4 == 0 ? 4 : 1);
  const bool wvec = N % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int steps = (Kst + kPK - 1) / kPK;
  // this lane's weight word in a tile row whose k-group is q: chunk
  // 2 warp + (g >> 2) swizzled by 2 q, byte 4 (g & 3) of it
  const int wcol = 16 * ((2 * warp + (g >> 2)) ^ (2 * q)) + 4 * (g & 3);

  int acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0;

#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < steps) {
      load_w(s_ring + s * kStage, w, s * kPK, nb, Kst, N, wvec);
      load_a<kHalves>(s_ring + s * kStage + kPBytes, xq, m0, s * kPK, M, K,
                      Kst, vec);
    }
    cp_async_commit();
  }

  for (int st = 0; st < steps; ++st) {
    cp_async_wait<kPStages - 2>();
    __syncthreads();  // stage st is in; every warp is done with st - 1
    const int nx = st + kPStages - 1;
    if (nx < steps) {
      int8_t* slot = s_ring + (nx % kPStages) * kStage;
      load_w(slot, w, nx * kPK, nb, Kst, N, wvec);
      load_a<kHalves>(slot + kPBytes, xq, m0, nx * kPK, M, K, Kst, vec);
    }
    cp_async_commit();
    const int8_t* s_w = s_ring + (st % kPStages) * kStage;
    const int8_t* s_x = s_w + kPBytes;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      unsigned b[2][4][2];  // [half][n8 tile][b0/b1]
#pragma unroll
      for (int gg = 0; gg < 2; ++gg) {
        const int8_t* rw = s_w + (32 * s + 16 * gg + 4 * q) * kPN + wcol;
        unsigned v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = *reinterpret_cast<const unsigned*>(rw + i * kPN);
        int c[4];
        if constexpr (Q4) {
          transpose4(nibbles_lo(v[0]), nibbles_lo(v[1]), nibbles_lo(v[2]),
                     nibbles_lo(v[3]), c);
#pragma unroll
          for (int t = 0; t < 4; ++t) b[0][t][gg] = (unsigned)c[t];
          transpose4(nibbles_hi(v[0]), nibbles_hi(v[1]), nibbles_hi(v[2]),
                     nibbles_hi(v[3]), c);
#pragma unroll
          for (int t = 0; t < 4; ++t) b[1][t][gg] = (unsigned)c[t];
        } else {
          transpose4(v[0], v[1], v[2], v[3], c);
#pragma unroll
          for (int t = 0; t < 4; ++t) b[0][t][gg] = (unsigned)c[t];
        }
      }
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned a[4];
          ldmatrix_x4(smem_u32(s_x + (h * kPM + 16 * i + (lane & 15)) * kPRow +
                               32 * s + 16 * (lane >> 4)), a);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_s8(acc[i][t], a, b[h][t][0],
                                             b[h][t][1]);
        }
    }
  }
  cp_async_wait<0>();

  // fragment e of tile (i, t): row 16 i + g + 8 (e >> 1), physical column
  // nw + 8 q + 4 (e & 1) + t, so tiles t = 0..3 are 4 neighbouring columns
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + 16 * i + g + 8 * hr;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nw + 8 * q + 4 * e;
        if (c >= N) continue;
        float4 o;
        o.x = epilogue(acc[i][0][2 * hr + e], ws[c], s);
        o.y = epilogue(acc[i][1][2 * hr + e], ws[c + 1], s);
        o.z = epilogue(acc[i][2][2 * hr + e], ws[c + 2], s);
        o.w = epilogue(acc[i][3][2 * hr + e], ws[c + 3], s);
        *reinterpret_cast<float4*>(out + (size_t)m * N + c) = o;
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
  constexpr int bytes = kPStages * prefill_stage_bytes<Q4 ? 2 : 1>();
  const cudaError_t e = cudaFuncSetAttribute(  // above the default 48 KB
      reinterpret_cast<const void*>(qmm_prefill_kernel<Q4>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kPM - 1) / kPM, (N + kPN - 1) / kPN);
  qmm_prefill_kernel<Q4><<<grid, kPThreads, bytes, st>>>(
      xq, sx, w, ws, idx, idx_host, L, out, M, K, N);
  return cudaGetLastError();
}

bool bad_shape(int q4, int M, int K, int N, int L, int idx_host) {
  return M < 1 || K < 1 || N < 4 || N % 4 != 0 || L < 1 ||
         (q4 && K % 2 != 0) || idx_host < 0 || idx_host >= L ||
         (N + kPN - 1) / kPN > 65535;
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
