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
// Layouts (the JAX package's, kept at the public function): x (M, K) float32,
// bfloat16 or float16; w (K, N) int8, or (K/2, N) int4 packed two a byte (byte
// (k, n) holds w[k, n] in its low nibble and w[k + K/2, n] in its high
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
//
// The kernels and their launchers are in gemv_quant.cuh; this file runs
// them on float32 and bfloat16 rows (and int8 rows quantized beforehand)
// and holds the C entry points, and gemv_quant_f16.cu instantiates them for
// float16 rows.

#include "gemv_quant.cuh"

extern "C" {

// dtype 0: float32 x, 1: bfloat16, 3: float16 (the decode kernel's x
// codes). xq (M, K) int8 and sx (M,) float32 out.
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
  else if (dtype == kXF16)
    return pdt_gq::quantize_rows_f16(x, xq, sx, M, K, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out (M, N) float32 = the product of M <= 32 rows x with layer `*idx` (or
// `idx_host` when idx is null) of w (L, Kst, N) int8 with channel scales
// ws (L, N); q4: Kst = K / 2 packed int4 rows. xtype 0: float32 rows,
// 1: bfloat16, 3: float16, each quantized by the kernel (sx null); 2: int8
// rows quantized beforehand with their scales sx (M,). One launch of the decode
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
      !plan_ok || xtype < kXF32 || xtype > kXF16 ||
      (xtype == kXInt8) != (sx != nullptr))
    return (int)cudaErrorInvalidValue;
  const DecodeArgs a{x, static_cast<const float*>(sx),
                     static_cast<const int8_t*>(w),
                     static_cast<const float*>(ws),
                     static_cast<const int*>(idx), idx_host, L,
                     static_cast<float*>(out), M, K, N, cluster, slice,
                     chunk, wm, stages};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xtype == kXF16) return pdt_gq::decode_f16(q4, mt, a, st);
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
