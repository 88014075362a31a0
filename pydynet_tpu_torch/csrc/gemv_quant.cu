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
// leaves to XLA around the Pallas call (:309-315). The decode kernel does it
// itself (one launch a call); the prefill kernel's rows are quantized by
// `quantize_rows_kernel` first.
//
// The arithmetic is the JAX package's, bit for bit (`qmatmul_ref` :453):
//   amax = max(max_k |x[m, k]|, 1e-30); xq = rint(x * (127 / amax)) as int8;
//   sx = amax * (1 / 127); acc = sum_k xq[m, k] * w[k, n] in int32, exact;
//   out[m, n] = (float(acc) * ws[n]) * sx[m].
// rint is round half to even (`jnp.round`); 127 / amax is an IEEE division
// (no fast math: the build passes no --use_fast_math); the two products of
// the epilogue are rounded in that order. A max and an int32 sum are exact
// in any order, so splitting K over blocks gives the same bits as one
// sequential pass.
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
// 6.6 GB of weights, 1.97 ms). The decode kernel (M <= 32 rows) is one
// launch that reads the float rows and the weights and writes the float32
// result, with no scratch in device memory:
//   * a block owns 128 columns (lane l of a warp the 4-column word l) and a
//     K slice of `slice` packed weight rows; the blocks that split K for
//     one column tile are a thread-block cluster (at most 8, `ops/
//     gemv_quant.decode_plan` picks the split so every 7B shape puts 256 to
//     500 blocks on the 132 SMs);
//   * the weights stream through a ring of 64-row stages (8 KB) in shared
//     memory by 16-byte `cp.async.cg` (not kept in L1; 4-byte copies when N
//     is no multiple of 16), 3 stages deep (deeper rings measured slower),
//     the first ones in flight while the rows are quantized;
//   * the row quantization is fused: each block loads its K slice of the
//     rows first (16-byte (f32) or 8-byte (bf16) loads, into registers up
//     to 4 rows, before the weight loads, which they would otherwise queue
//     behind), takes each row's absmax over it, the cluster exchanges the
//     partial maxima through distributed shared memory (`map_shared_rank`
//     after `cluster.sync()`), and each block quantizes its slice into
//     shared memory. Nothing is written to device memory but the result;
//   * 4 rows of a lane's word are transposed with `__byte_perm` into one
//     word a column, so one `__dp4a` does 4 multiply-adds of a column; int4
//     nibbles are shifted into the high half of their byte (16 x the
//     signed nibble, two operations a word) and the sum divided by 16,
//     exact, at the end;
//   * warps split the stage's 4-row groups and, above 8 rows, the rows
//     (tiles of up to 8 rows a warp, at most 32 int32 sums a thread); the
//     warps' sums meet in shared memory; each block of the cluster owns a
//     share of the columns, and every block stores its sums of each share
//     into the owner's shared memory (distributed shared memory, 16 bytes a
//     store); after one `cluster.sync()` each block adds them and writes
//     the float32 epilogue of its own share. So a call depends on no state
//     it does not make itself, and can be captured in a CUDA graph.
// The same kernel also takes rows quantized beforehand (int8 with their
// scales), the route `ops/gemv_quant.py` takes above FUSED_QUANT_MAX_ROWS.
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

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kQThreads = 256;
constexpr int kDThreads = 256;        // decode block: 8 warps
constexpr int kDWarps = kDThreads / 32;
constexpr int kDCols = 128;           // columns of a block: 32 lanes x 4
constexpr int kDStageRows = 64;       // packed weight rows a ring stage
constexpr int kDMaxStages = 4;        // stages of the weight ring, at most
constexpr int kXRegs = 8;             // 4-element groups of x a thread holds
constexpr int kDStageBytes = kDStageRows * kDCols;
constexpr int kMaxCluster = 8;        // a portable cluster
constexpr int kMaxDecodeRows = 32;    // ops/gemv_quant.py MAX_DECODE_ROWS
constexpr int kSmemMax = 232448;      // 227 KB, a block's shared memory
// x of the decode kernel: float32 or bfloat16 rows it quantizes itself, or
// int8 rows quantized beforehand with their scales
constexpr int kXF32 = 0, kXBF16 = 1, kXInt8 = 2;
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

// Columns of a block's tile whose epilogue each block of a cluster of
// `cluster` writes: a multiple of 4
__host__ __device__ constexpr int decode_share(int cluster) {
  return 4 * ((kDCols / 4 + cluster - 1) / cluster);
}

// Bytes of dynamic shared memory of a decode block: the weight ring of
// `stages` stages, the int32 sums of its `mpad` rows x 128 columns, a
// chunk of `chunk` packed rows of its int8 rows (two halves for int4) and
// the sums its cluster's blocks send it for its share of the columns.
// `decode_plan` in ops/gemv_quant.py mirrors it.
__host__ __device__ constexpr int decode_smem(int stages, int mpad,
                                              int halves, int chunk,
                                              int cluster) {
  return stages * kDStageBytes + mpad * kDCols * 4 + halves * mpad * chunk +
         cluster * mpad * decode_share(cluster) * 4;
}

// cp.async.wait_group with a run-time count (the ring's depth is the
// plan's): every group but the newest n is complete
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<kDMaxStages - 2>(); break;
  }
}

// Copy packed weight rows [r0, r0 + kDStageRows), columns [col0, col0 + 128)
// into stage `s` (row r at r * 128), zero past `rend` and N: 16-byte
// cp.async.cg when `wvec` (N a multiple of 16, w 16-byte aligned), else
// 4-byte copies.
__device__ __forceinline__ void load_stage(int8_t* s, const int8_t* w, int r0,
                                           int rend, int col0, int N,
                                           bool wvec) {
  if (wvec) {  // 8 chunks a row, 32 rows a pass
    const int c = threadIdx.x & 7;
#pragma unroll
    for (int r = threadIdx.x >> 3; r < kDStageRows; r += kDThreads / 8) {
      const bool ok = r0 + r < rend && col0 + 16 * c < N;
      cp_async16(smem_u32(s + r * kDCols + 16 * c),
                 ok ? w + (size_t)(r0 + r) * N + col0 + 16 * c : w,
                 ok ? 16 : 0);
    }
    return;
  }
  const int wd = threadIdx.x & 31;  // 32 words a row, 8 rows a pass
#pragma unroll
  for (int r = threadIdx.x >> 5; r < kDStageRows; r += kDThreads / 32) {
    const bool ok = r0 + r < rend && col0 + 4 * wd < N;
    cp_async4(smem_u32(s + r * kDCols + 4 * wd),
              ok ? w + (size_t)(r0 + r) * N + col0 + 4 * wd : w,
              ok ? 4 : 0);
  }
}

// x[0..3] as float32, 0 past the first `n`: one 16-byte (f32) or 8-byte
// (bf16) load when `vec` (aligned) and all 4 are there
__device__ __forceinline__ void load4(const float* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec && n >= 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? __ldg(p + i) : 0.f;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec && n >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(e[i]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < n ? __bfloat162float(p[i]) : 0.f;
}

// rint(v * q) as an int8 byte: the reference's IEEE product, then round
// half to even
__device__ __forceinline__ unsigned quant_byte(float v, float q) {
  return (unsigned)__float2int_rn(__fmul_rn(v, q)) & 0xffu;
}

// 4 int8 rows of x quantized beforehand, as one word (little-endian), 0
// past the first `n`
__device__ __forceinline__ unsigned load4_i8(const int8_t* p, int n,
                                             bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const unsigned*>(p));
  unsigned u = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) u |= ((unsigned)(uint8_t)p[i]) << (8 * i);
  return u;
}

// Decode rows (M <= 32), one launch. Grid (cluster, column tiles), cluster
// (cluster, 1, 1): block (r, t) takes columns [128 t, 128 t + 128) and
// packed weight rows [r * slice, r * slice + slice) of layer *idx. Warp w
// takes row tile w / (8 / wm) (MT rows) and the 4-row groups w % (8 / wm),
// + 8 / wm, ... of each stage; lane l the columns 4l..4l+3. XT float or
// bfloat16: the rows, quantized here (sx unused); int8: rows quantized
// beforehand, with their scales sx.
template <int MT, bool Q4, typename XT>
__global__ void __launch_bounds__(kDThreads)
qmm_decode_kernel(const XT* __restrict__ x, const float* __restrict__ sx,
                  const int8_t* __restrict__ w, const float* __restrict__ ws,
                  const int* __restrict__ idx, int idx_host, int L,
                  float* __restrict__ out, int M, int K, int N, int slice,
                  int chunk, int wm, int stages) {
  extern __shared__ __align__(16) int8_t s_dyn[];
  __shared__ float s_amax[kMaxDecodeRows], s_q[kMaxDecodeRows],
      s_sx[kMaxDecodeRows];
  constexpr bool kFused = !std::is_same<XT, int8_t>::value;
  constexpr int kHalves = Q4 ? 2 : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int Kst = Q4 ? K / 2 : K;
  const int layer = layer_of(idx, idx_host, L);
  w += (size_t)layer * Kst * N;
  ws += (size_t)layer * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kDCols;
  const int k0 = rank * slice;
  const int rows = max(0, min(slice, Kst - k0));  // this block's K slice
  const int mpad = MT * wm;
  const int steps = (rows + kDStageRows - 1) / kDStageRows;
  int8_t* s_ring = s_dyn;
  int* s_acc = reinterpret_cast<int*>(s_dyn + stages * kDStageBytes);
  int8_t* s_x = reinterpret_cast<int8_t*>(s_acc + mpad * kDCols);
  const int share = decode_share(C);
  int* s_part = reinterpret_cast<int*>(s_x + kHalves * mpad * chunk);

  // whole 4-element groups of a row are aligned when K and Kst are
  // multiples of 4 and x is aligned to 4 elements
  const bool xvec = K % 4 == 0 && Kst % 4 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(XT))) == 0;
  // s_x[h][m][j] = xq[m, h * Kst + k0 + c0 + j] for j < chunk, 0 past the
  // slice and for the padding rows m >= M
  auto fill = [&](int c0) {
    const int n = min(chunk, rows - c0);
    const int words = chunk / 4;
#pragma unroll 4
    for (int i = threadIdx.x; i < kHalves * mpad * words; i += kDThreads) {
      const int jw = i % words, m = (i / words) % mpad;
      const int h = i / (words * mpad);
      const int j = 4 * jw;
      unsigned word = 0;
      if (m < M && j < n) {
        const XT* src = x + (size_t)m * K + (size_t)h * Kst + k0 + c0 + j;
        if constexpr (kFused) {
          float v[4];
          load4(src, n - j, xvec, v);
          const float q = s_q[m];
          word = quant_byte(v[0], q) | quant_byte(v[1], q) << 8 |
                 quant_byte(v[2], q) << 16 | quant_byte(v[3], q) << 24;
        } else {
          word = load4_i8(src, n - j, xvec);
        }
      }
      *reinterpret_cast<unsigned*>(s_x + (size_t)(h * mpad + m) * chunk + j) =
          word;
    }
  };
  // the weights: stages - 1 stages in flight, issued after the loads of
  // the rows, which would otherwise wait behind them
  const bool wvec = N % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  auto prefetch = [&]() {
    for (int s = 0; s < stages - 1; ++s) {
      if (s < steps)
        load_stage(s_ring + s * kDStageBytes, w, k0 + s * kDStageRows,
                   k0 + rows, col0, N, wvec);
      cp_async_commit();
    }
  };

  if constexpr (kFused) {
    // each row's absmax over this block's slice (8 / M warps a row up to 8
    // rows; maxima of non-negative floats meet as int32 atomicMax), then
    // over the cluster's slices, which cover the row. Up to 4 rows, when
    // the slice is one chunk, a thread's share of the rows stays in
    // registers from the absmax to the quantization; else `fill` reads the
    // rows again.
    if ((int)threadIdx.x < M) s_amax[threadIdx.x] = 0.f;
    __syncthreads();
    const int wpr = kDWarps / min(M, kDWarps);  // warps a row
    const int seg = 4 * (lane + 32 * (warp % wpr));
    const int per_h = (rows + 128 * wpr - 1) / (128 * wpr);
    const bool in_regs = M <= 4 && kHalves * per_h <= kXRegs && chunk >= rows;
    const int mr = warp / wpr;  // the warp's first row
    float xr[kXRegs][4];
    if (in_regs) {
#pragma unroll
      for (int t = 0; t < kXRegs; ++t) {
        const int h = t / per_h, j = seg + (t % per_h) * 128 * wpr;
        if (mr < M && h < kHalves && j < rows)
          load4(x + (size_t)mr * K + (size_t)h * Kst + k0 + j, rows - j,
                xvec, xr[t]);
        else
          xr[t][0] = xr[t][1] = xr[t][2] = xr[t][3] = 0.f;
      }
    }
    prefetch();
    for (int m = mr; m < M; m += kDWarps / wpr) {
      float a = 0.f;
      if (in_regs) {
#pragma unroll
        for (int t = 0; t < kXRegs; ++t)
          a = fmaxf(a, fmaxf(fmaxf(fabsf(xr[t][0]), fabsf(xr[t][1])),
                             fmaxf(fabsf(xr[t][2]), fabsf(xr[t][3]))));
      } else {
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const XT* row = x + (size_t)m * K + (size_t)h * Kst + k0;
#pragma unroll 4
          for (int j = seg; j < rows; j += 128 * wpr) {
            float v[4];
            load4(row + j, rows - j, xvec, v);
            a = fmaxf(a, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])),
                               fmaxf(fabsf(v[2]), fabsf(v[3]))));
          }
        }
      }
      a = warp_max(a);
      if (lane == 0)
        atomicMax(reinterpret_cast<int*>(s_amax) + m, __float_as_int(a));
    }
    cluster.sync();
    if ((int)threadIdx.x < M) {
      float a = 0.f;
      for (int r = 0; r < C; ++r)
        a = fmaxf(a, cluster.map_shared_rank(s_amax, r)[threadIdx.x]);
      a = fmaxf(a, 1e-30f);
      s_q[threadIdx.x] = __fdiv_rn(127.0f, a);
      s_sx[threadIdx.x] = __fmul_rn(a, 1.0f / 127.0f);
    }
    __syncthreads();
    if (in_regs) {  // the registers' words, and zeros for the rest of s_x
      if (mr < M) {
        const float q = s_q[mr];
#pragma unroll
        for (int t = 0; t < kXRegs; ++t) {
          const int h = t / per_h, j = seg + (t % per_h) * 128 * wpr;
          if (h < kHalves && j < rows)
            *reinterpret_cast<unsigned*>(
                s_x + (size_t)(h * mpad + mr) * chunk + j) =
                quant_byte(xr[t][0], q) | quant_byte(xr[t][1], q) << 8 |
                quant_byte(xr[t][2], q) << 16 | quant_byte(xr[t][3], q) << 24;
        }
      }
      const int words = chunk / 4;
      for (int i = threadIdx.x; i < kHalves * mpad * words; i += kDThreads) {
        const int j = 4 * (i % words), m = (i / words) % mpad;
        if (m >= M || j >= rows)
          *reinterpret_cast<unsigned*>(s_x + (size_t)(i / words) * chunk +
                                       j) = 0u;
      }
    } else {
      fill(0);
    }
  } else {
    if ((int)threadIdx.x < M) s_sx[threadIdx.x] = sx[threadIdx.x];
    fill(0);
    prefetch();
  }
  for (int i = threadIdx.x; i < mpad * kDCols; i += kDThreads) s_acc[i] = 0;

  const int wk = kDWarps / wm;  // warps along K
  const int kw = warp % wk, m0 = (warp / wk) * MT;
  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  for (int st = 0; st < steps; ++st) {
    cp_async_wait_n(stages - 2);
    __syncthreads();  // stage st is in; every warp is done with st - 1
    const int r0 = st * kDStageRows;
    if (st > 0 && r0 % chunk == 0) {  // the next chunk of the rows
      fill(r0);
      __syncthreads();
    }
    const int nx = st + stages - 1;
    if (nx < steps)
      load_stage(s_ring + (nx % stages) * kDStageBytes, w,
                 k0 + nx * kDStageRows, k0 + rows, col0, N, wvec);
    cp_async_commit();
    const int8_t* sw = s_ring + (st % stages) * kDStageBytes;
    const int8_t* sxr = s_x + r0 % chunk;
    for (int g = kw; g < kDStageRows / 4; g += wk) {
      unsigned v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = *reinterpret_cast<const unsigned*>(sw + (4 * g + i) * kDCols +
                                                  4 * lane);
      int cl[4], ch[4];
      if constexpr (Q4) {  // 16 x the signed nibbles, as int8 bytes
        transpose4(v[0] << 4 & 0xF0F0F0F0u, v[1] << 4 & 0xF0F0F0F0u,
                   v[2] << 4 & 0xF0F0F0F0u, v[3] << 4 & 0xF0F0F0F0u, cl);
        transpose4(v[0] & 0xF0F0F0F0u, v[1] & 0xF0F0F0F0u,
                   v[2] & 0xF0F0F0F0u, v[3] & 0xF0F0F0F0u, ch);
      } else {
        transpose4(v[0], v[1], v[2], v[3], cl);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int xl = *reinterpret_cast<const int*>(
            sxr + (size_t)(m0 + m) * chunk + 4 * g);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = __dp4a(cl[c], xl, acc[m][c]);
        if constexpr (Q4) {
          const int xh = *reinterpret_cast<const int*>(
              sxr + (size_t)(mpad + m0 + m) * chunk + 4 * g);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][c] = __dp4a(ch[c], xh, acc[m][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warps' sums meet in shared memory (int4: divided by 16, exact);
  // each block sends the sums of every block's share of the columns to
  // that block (distributed shared memory stores, 16 bytes each), and
  // after one cluster.sync() each block adds the cluster's sums of its own
  // share and writes their epilogue. No block reads another's shared
  // memory after the barrier, so each may leave then. The stores need
  // every block of the cluster started: the fused route's absmax exchange
  // passed a cluster.sync() already, the int8 route passes one here.
#pragma unroll
  for (int m = 0; m < MT; ++m)
    if (m0 + m < M)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        atomicAdd(&s_acc[(m0 + m) * kDCols + 4 * lane + c],
                  Q4 ? acc[m][c] >> 4 : acc[m][c]);
  if constexpr (kFused)
    __syncthreads();
  else
    cluster.sync();
  for (int i = threadIdx.x; i < M * kDCols / 4; i += kDThreads) {
    const int m = i / (kDCols / 4), col = 4 * (i % (kDCols / 4));
    const int owner = col / share;
    int* dst = cluster.map_shared_rank(s_part, owner) +
               (rank * mpad + m) * share + col - owner * share;
    *reinterpret_cast<int4*>(dst) =
        *reinterpret_cast<const int4*>(&s_acc[m * kDCols + col]);
  }
  cluster.sync();
  const int c_lo = rank * share, width = min(kDCols, c_lo + share) - c_lo;
  for (int i = threadIdx.x; i < M * width; i += kDThreads) {
    const int m = i / width, j = i % width, n = col0 + c_lo + j;
    if (n < N) {
      int a = 0;
      for (int r = 0; r < C; ++r) a += s_part[(r * mpad + m) * share + j];
      out[(size_t)m * N + n] = epilogue(a, ws[n], s_sx[m]);
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

// Let `kern` take `bytes` of dynamic shared memory: the attribute is set
// only when a call needs more than `done[device]`, the largest set so far
// for that kernel instance (each instance passes its own `done`; a value
// set is the instance's limit, the default 48 KB no longer holds for it).
inline cudaError_t allow_smem(const void* kern, int bytes, int (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) done[dev] = bytes;
  return e;
}

struct DecodeArgs {
  const void* x;
  const float* sx;
  const int8_t* w;
  const float* ws;
  const int* idx;
  int idx_host, L;
  float* out;
  int M, K, N, cluster, slice, chunk, wm, stages;
};

template <int MT, bool Q4, typename XT>
cudaError_t decode(const DecodeArgs& a, cudaStream_t st) {
  static int done[64] = {};
  auto* kern = qmm_decode_kernel<MT, Q4, XT>;
  const int smem = decode_smem(a.stages, MT * a.wm, Q4 ? 2 : 1, a.chunk,
                               a.cluster);
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kern), smem, done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, (a.N + kDCols - 1) / kDCols);
  cfg.blockDim = dim3(kDThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const XT*>(a.x), a.sx, a.w,
                         a.ws, a.idx, a.idx_host, a.L, a.out, a.M, a.K, a.N,
                         a.slice, a.chunk, a.wm, a.stages);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool Q4, typename XT>
cudaError_t decode_mt(int mt, const DecodeArgs& a, cudaStream_t st) {
  switch (mt) {
    case 1: return decode<1, Q4, XT>(a, st);
    case 2: return decode<2, Q4, XT>(a, st);
    case 4: return decode<4, Q4, XT>(a, st);
    default: return decode<8, Q4, XT>(a, st);
  }
}

template <bool Q4>
cudaError_t decode_x(int xtype, int mt, const DecodeArgs& a,
                     cudaStream_t st) {
  if (xtype == kXF32) return decode_mt<Q4, float>(mt, a, st);
  if (xtype == kXBF16) return decode_mt<Q4, __nv_bfloat16>(mt, a, st);
  return decode_mt<Q4, int8_t>(mt, a, st);
}

template <bool Q4>
cudaError_t prefill(const int8_t* xq, const float* sx, const int8_t* w,
                    const float* ws, const int* idx, int idx_host, int L,
                    float* out, int M, int K, int N, cudaStream_t st) {
  constexpr int bytes = kPStages * prefill_stage_bytes<Q4 ? 2 : 1>();
  static int done[64] = {};
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(qmm_prefill_kernel<Q4>), bytes, done);
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

// out (M, N) float32 = the product of M <= 32 rows x with layer `*idx` (or
// `idx_host` when idx is null) of w (L, Kst, N) int8 with channel scales
// ws (L, N); q4: Kst = K / 2 packed int4 rows. xtype 0: float32 rows,
// 1: bfloat16, both quantized by the kernel (sx null); 2: int8 rows
// quantized beforehand with their scales sx (M,). One launch of the decode
// kernel with the plan of ops/gemv_quant.decode_plan: `cluster` blocks of
// `slice` packed rows split K, their int8 rows staged `chunk` rows at a
// time, `wm` row tiles of `mt` rows, a weight ring of `stages` stages.
// Returns the CUDA error of the launch, or cudaErrorInvalidValue for a
// shape or plan it does not take.
int pdt_qmm_decode(int q4, int xtype, const void* x, const void* sx,
                   const void* w, const void* ws, const void* idx,
                   int idx_host, int L, void* out, int M, int K, int N,
                   int cluster, int slice, int chunk, int mt, int wm,
                   int stages, void* stream) {
  const int Kst = q4 ? K / 2 : K;
  const bool plan_ok =
      cluster >= 1 && cluster <= kMaxCluster && slice >= kDStageRows &&
      slice % kDStageRows == 0 && chunk >= kDStageRows &&
      chunk % kDStageRows == 0 && chunk <= slice &&
      (long long)cluster * slice >= Kst &&
      (long long)(cluster - 1) * slice < Kst &&
      (mt == 1 || mt == 2 || mt == 4 || mt == 8) &&
      (wm == 1 || (mt == 8 && (wm == 2 || wm == 4))) && mt * wm >= M &&
      stages >= 2 && stages <= kDMaxStages && chunk <= kSmemMax &&
      decode_smem(stages, mt * wm, q4 ? 2 : 1, chunk, cluster) <= kSmemMax &&
      (N + kDCols - 1) / kDCols <= 65535;
  if (bad_shape(q4, M, K, N, L, idx_host) || M > kMaxDecodeRows ||
      !plan_ok || xtype < kXF32 || xtype > kXInt8 ||
      (xtype == kXInt8) != (sx != nullptr))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{x, static_cast<const float*>(sx),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(ws),
                     static_cast<const int*>(idx), idx_host, L,
                     static_cast<float*>(out), M, K, N, cluster, slice,
                     chunk, wm, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(q4 ? decode_x<true>(xtype, mt, a, st)
                  : decode_x<false>(xtype, mt, a, st));
}

// out (M, N) float32 = the product of xq (M, K) int8 with row scales sx (M,)
// and layer `*idx` (or `idx_host` when idx is null) of w (L, Kst, N) int8
// with channel scales ws (L, N): the prefill kernel, which takes any M
// (ops/gemv_quant.py sends it M > 32 rows). Returns the CUDA error of the
// launch, or cudaErrorInvalidValue for a shape it does not take.
int pdt_qmm(int q4, const void* xq, const void* sx, const void* w,
            const void* ws, const void* idx, int idx_host, int L, void* out,
            int M, int K, int N, void* stream) {
  if (bad_shape(q4, M, K, N, L, idx_host)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const float* sxf = static_cast<const float*>(sx);
  const int8_t* w8 = static_cast<const int8_t*>(w);
  const float* wsf = static_cast<const float*>(ws);
  const int* ip = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  return (int)(q4 ? prefill<true>(x8, sxf, w8, wsf, ip, idx_host, L, o, M, K,
                                  N, st)
                  : prefill<false>(x8, sxf, w8, wsf, ip, idx_host, L, o, M,
                                   K, N, st));
}

}  // extern "C"
