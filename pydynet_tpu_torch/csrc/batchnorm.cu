// Train-mode BatchNorm over an (N, C) batch (K8): the port of the Pallas
// TPU kernel pydynet_tpu/ops/batchnorm.py:_bn_kernel.
//
// For each column c: mean = sum_n x / N, var = sum_n (x - mean)^2 / N (the
// biased variance, in two passes as the TPU kernel takes it, not Welford and
// not E[x^2] - E[x]^2), and out = (x - mean) * rsqrt(var + eps) * gamma +
// beta in x's type; mean and var are written as float32 (1, C). x and out
// are float32 or bfloat16, gamma and beta float32 or bfloat16 on their own;
// every sum is float32.
//
// Bound: bytes. The function reads x once and writes out once, 2 N C
// itemsize bytes over 3.35 TB/s; it does about 8 operations an element.
//
// Design. The TPU kernel holds the whole block in VMEM and reduces it in one
// grid step; on Hopper nothing carries across blocks, so the batch is cut
// into column strips of 128 bytes a row (32 float32 or 64 bfloat16 columns:
// a row of a strip is 8 lanes' 16-byte pieces, a warp 4 rows) and each
// strip's rows into slabs, one slab a block, the slabs of a strip one
// thread-block cluster (bn_plan; ops/batchnorm.py:bn_plan mirrors it). A
// block copies its slab into shared memory by cp.async, every copy in
// flight at once, so x comes from device memory once: the centred squares
// and the output are computed from shared memory. Each block sums its slab
// (each thread 16 bytes of a row, every 32nd row; the row offsets meet by
// shuffles and through shared memory in warp order), pushes its partial
// sums into a slot of every block of its cluster (distributed shared
// memory, after a cluster.sync() that the slab's copies overlap), and after
// a second cluster.sync() each block adds the slots in rank order: every
// block gets the same bits of the mean, no float atomics, the same bits on
// every run. The variance's squares meet the same way. The cluster grows
// until the blocks fill the SMs and can all be resident at once: at (8192,
// 1024) float32 clusters of 16 slabs of 64 KB, three blocks an SM (8 slabs
// of 128 KB, one block an SM, would run in waves). Rows past 1,408 a slab
// (kBnSlabBytes; more than 22,528 rows a strip) are read again from x in
// each pass. Small batches (fewer than 2 x kBnMinRows rows) stay one block a
// strip, one plain launch, the warps' sums added in the block: at (40, 512)
// 16 blocks, latency as before. gamma and beta are loaded at the start, off
// the critical path. One launch a forward either way.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBnThreads = 256;
constexpr int kBnStripBytes = 128;  // bytes of a row a strip holds
constexpr int kBnPieces = kBnStripBytes / 16;  // 16-byte pieces a row
constexpr int kBnRowStep = kBnThreads / kBnPieces;  // rows a block step
constexpr int kBnSms = 132;         // an H100 SXM's SMs: blocks to fill
constexpr int kBnMinRows = 64;      // no slab is cut below this many rows
constexpr int kBnMaxCluster = 16;   // non-portable above 8
constexpr int kBnSlabBytes = 176 * 1024;  // shared memory a slab may take
static_assert(kBnPieces <= 32 && 32 % kBnPieces == 0,
              "a warp holds whole rows of a strip");

// How the batch is cut (ops/batchnorm.py:bn_plan mirrors it): strips of
// `width` columns; `cluster` slabs a strip of `rows` rows each (the last
// may be short), of which the first `cached` rows are held in shared
// memory. The cluster doubles from 1 while half a slab keeps kBnMinRows
// rows and the blocks do not yet fill the SMs, or a slab does not fit in
// kBnSlabBytes, or the blocks cannot all be resident at once (then smaller
// slabs pack more blocks onto an SM).
struct BnPlan {
  int width, strips, cluster, rows, cached;
};

constexpr int kBnSmSmem = 228 * 1024;  // shared memory of an SM
constexpr int kBnSmBlocks = 2048 / kBnThreads;

// Dynamic shared memory of a block holding `held` rows of a strip `width`
// columns wide in a cluster of cs: the rows, then the warps' sums, the two
// exchanges' cs slots and the mean and rstd, `width` floats each
inline int bn_smem(int held, int cs, int width) {
  return held * kBnStripBytes + (kBnThreads / 32 + 2 * cs + 2) * width * 4;
}

inline BnPlan bn_plan(int N, int C, int itemsize) {
  BnPlan p;
  p.width = kBnStripBytes / itemsize;
  p.strips = (C + p.width - 1) / p.width;
  const int max_rows = kBnSlabBytes / kBnStripBytes;
  auto slab = [&](int c) { return (N + c - 1) / c; };
  auto resident = [&](int c) {  // blocks of a cluster of c at once
    const int per_sm = kBnSmSmem / (bn_smem(min(slab(c), max_rows), c,
                                            p.width) + 1024);
    return (long)kBnSms * min(kBnSmBlocks, per_sm);
  };
  int cs = 1;
  while (cs < kBnMaxCluster && slab(2 * cs) >= kBnMinRows &&
         ((long)p.strips * cs < kBnSms || slab(cs) > max_rows ||
          (long)p.strips * cs > resident(cs)))
    cs *= 2;
  p.cluster = cs;
  p.rows = slab(cs);
  p.cached = min(p.rows, max_rows);
  return p;
}

// widen 16 bytes of TX values
template <typename TX>
__device__ __forceinline__ void unpack(const uint4& u,
                                       float (&v)[16 / sizeof(TX)]) {
  const TX* e = reinterpret_cast<const TX*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(TX); ++i) v[i] = to_f(e[i]);
}

// Block (rank, strip) of a cluster of `cs` blocks along x: rows [rank *
// rows, + rows) of the columns [strip * W, + W), the first `cached` of
// them held in shared memory, the rest read from x in each pass. `vec`:
// 16 when x's rows are 16-byte aligned, 4 when 4-byte aligned, else 1
// (element copies).
template <typename TX, typename TP>
__global__ void __launch_bounds__(kBnThreads)
bn_train_kernel(const TX* __restrict__ x, const TP* __restrict__ gamma,
                const TP* __restrict__ beta, TX* __restrict__ out,
                float* __restrict__ mean_out, float* __restrict__ var_out,
                int N, int C, int rows, int cached, int cs, int vec,
                float eps) {
  constexpr int E = 16 / sizeof(TX);             // elements a piece
  constexpr int W = kBnStripBytes / sizeof(TX);  // columns a strip
  // the held rows, then the warps' sums, the cluster's partial sums (two
  // exchanges of cs slots) and the mean and rstd, W floats each (bn_smem)
  extern __shared__ __align__(16) unsigned char slab[];
  auto red = reinterpret_cast<float(*)[W]>(slab + cached * kBnStripBytes);
  auto part = red + kBnThreads / 32;  // [2 cs][W]: exchange k, slot r
  auto stat = part + 2 * cs;          // [2][W]
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = blockIdx.y * W;
  const int r0 = rank * rows;
  const int nr = max(0, min(N, r0 + rows) - r0);  // the block's rows
  const int nc = min(nr, cached);                 // of them held
  const int piece = threadIdx.x % kBnPieces, rsub = threadIdx.x / kBnPieces;
  const int col = c0 + piece * E;                  // the thread's columns
  const int nv = max(0, min(E, C - col));          // of them in the batch
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the held rows by cp.async, zero past C, every copy in flight at once
  for (int i = threadIdx.x; i < nc * kBnPieces; i += kBnThreads) {
    const int r = i / kBnPieces, p = i % kBnPieces;
    const int cc = c0 + p * E;
    const int n = max(0, min(E, C - cc));
    const TX* src = x + (size_t)(r0 + r) * C + cc;
    unsigned char* dst = slab + r * kBnStripBytes + 16 * p;
    if (vec == 16) {
      cp_async16(smem_u32(dst), n ? src : x, n * (int)sizeof(TX));
    } else if (vec == 4) {
      const int nb = n * (int)sizeof(TX);
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        const int m = max(0, min(4, nb - j));
        cp_async4(smem_u32(dst + j),
                  m ? reinterpret_cast<const char*>(src) + j
                    : reinterpret_cast<const char*>(x), m);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        reinterpret_cast<TX*>(dst)[e] = e < n ? src[e] : from_f<TX>(0.f);
    }
  }
  cp_async_commit();
  // the thread's piece of a row past the held ones, from x (zero past C)
  auto streamed = [&](int r, float (&v)[E]) {
    const TX* src = x + (size_t)(r0 + r) * C + col;
    if (vec == 16 && nv == E) {
      unpack<TX>(*reinterpret_cast<const uint4*>(src), v);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = e < nv ? to_f(src[e]) : 0.f;
    }
  };
  auto held = [&](int r, float (&v)[E]) {
    unpack<TX>(*reinterpret_cast<const uint4*>(slab + r * kBnStripBytes +
                                               16 * piece), v);
  };

  // the block's column sums of `acc`: with a cluster, pushed into slot
  // `rank` of part[k] of every block, then after a cluster barrier added in
  // rank order, the same bits in every block
  auto reduce = [&](float (&acc)[E], int k) {
#pragma unroll
    for (int o = kBnPieces; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    if (lane < kBnPieces)
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp][piece * E + e] = acc[e];
    __syncthreads();
    if (cs > 1) {
      for (int t = threadIdx.x; t < W * cs; t += kBnThreads) {
        const int c = t % W, peer = t / W;
        float s = 0.f;
        for (int w = 0; w < kBnThreads / 32; ++w) s += red[w][c];
        cg::this_cluster().map_shared_rank(&part[k * cs + rank][c], peer)[0] =
            s;
      }
      cg::this_cluster().sync();
    }
    for (int c = threadIdx.x; c < W; c += kBnThreads) {
      float s = 0.f;
      if (cs > 1)
        for (int r = 0; r < cs; ++r) s += part[k * cs + r][c];
      else
        for (int w = 0; w < kBnThreads / 32; ++w) s += red[w][c];
      s /= (float)N;
      stat[k][c] = k == 0 ? s : rsqrtf(s + eps);
      if (rank == 0 && c0 + c < C) (k == 0 ? mean_out : var_out)[c0 + c] = s;
    }
    __syncthreads();
  };

  // gamma and beta now, so that their loads are off the critical path
  float g[E], b[E], mu[E], rs[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    g[e] = e < nv ? to_f(gamma[col + e]) : 0.f;
    b[e] = e < nv ? to_f(beta[col + e]) : 0.f;
    acc[e] = 0.f;
  }
  // pass 1: the column sums, then the mean. The streamed rows' loads and
  // the held rows' copies are in flight across the barrier that lets the
  // blocks store into each other's shared memory.
#pragma unroll 4
  for (int r = nc + rsub; r < nr; r += kBnRowStep) {
    float v[E];
    streamed(r, v);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += v[e];
  }
  if (cs > 1) cg::this_cluster().sync();
  cp_async_wait<0>();
  __syncthreads();
  for (int r = rsub; r < nc; r += kBnRowStep) {
    float v[E];
    held(r, v);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += v[e];
  }
  reduce(acc, 0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    mu[e] = stat[0][piece * E + e];
    acc[e] = 0.f;
  }

  // pass 2: the centred squares, then the biased variance
  auto square = [&](const float (&v)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float c = v[e] - mu[e];
      acc[e] += c * c;
    }
  };
#pragma unroll 4
  for (int r = nc + rsub; r < nr; r += kBnRowStep) {
    float v[E];
    streamed(r, v);
    square(v);
  }
  for (int r = rsub; r < nc; r += kBnRowStep) {
    float v[E];
    held(r, v);
    square(v);
  }
  reduce(acc, 1);

  // pass 3: out = centred * rstd * gamma + beta (the threads of columns
  // past C store nothing)
#pragma unroll
  for (int e = 0; e < E; ++e) rs[e] = stat[1][piece * E + e];
  auto write = [&](int r, const float (&v)[E]) {
    TX o[E];
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[e] = from_f<TX>((v[e] - mu[e]) * rs[e] * g[e] + b[e]);
    TX* dst = out + (size_t)(r0 + r) * C + col;
    if (vec == 16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    else
      for (int e = 0; e < nv; ++e) dst[e] = o[e];
  };
  if (nv == 0) return;  // no barrier follows
  for (int r = rsub; r < nc; r += kBnRowStep) {
    float v[E];
    held(r, v);
    write(r, v);
  }
#pragma unroll 4
  for (int r = nc + rsub; r < nr; r += kBnRowStep) {
    float v[E];
    streamed(r, v);
    write(r, v);
  }
}

// Let `kern` take `smem` bytes of dynamic shared memory and, for `cs` > 8,
// run in clusters above the portable size. `done` is the instance's own:
// a per-device record of what was granted.
inline cudaError_t bn_allow(const void* kern, int smem, int cs,
                            int (&done)[64][2]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int* d = dev < 64 ? done[dev] : nullptr;
  if (smem > 48 * 1024 && (d == nullptr || d[0] < smem)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (d) d[0] = smem;
  }
  if (cs > 8 && (d == nullptr || !d[1])) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    if (d) d[1] = 1;
  }
  return cudaSuccess;
}

template <typename TX, typename TP>
cudaError_t bn_train(const void* x, const void* gamma, const void* beta,
                     void* out, void* mean, void* var, int N, int C,
                     float eps, cudaStream_t st) {
  static int done[64][2] = {};
  const BnPlan p = bn_plan(N, C, (int)sizeof(TX));
  auto* kern = bn_train_kernel<TX, TP>;
  const int smem = bn_smem(p.cached, p.cluster, p.width);
  const size_t rb = (size_t)C * sizeof(TX);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(out);
  const int vec = rb % 16 == 0 && xa % 16 == 0 ? 16
                  : rb % 4 == 0 && xa % 4 == 0 ? 4 : 1;
  cudaError_t e = bn_allow(reinterpret_cast<const void*>(kern), smem,
                           p.cluster, done);
  if (e != cudaSuccess) return e;
  const TX* xp = static_cast<const TX*>(x);
  const TP* gp = static_cast<const TP*>(gamma);
  const TP* bp = static_cast<const TP*>(beta);
  TX* op = static_cast<TX*>(out);
  float* mp = static_cast<float*>(mean);
  float* vp = static_cast<float*>(var);
  if (p.cluster == 1) {
    kern<<<dim3(1, p.strips), kBnThreads, smem, st>>>(
        xp, gp, bp, op, mp, vp, N, C, p.rows, p.cached, 1, vec, eps);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.strips);
  cfg.blockDim = dim3(kBnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, xp, gp, bp, op, mp, vp, N, C, p.rows,
                         p.cached, p.cluster, vec, eps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// x_dtype (x and out) and p_dtype (gamma and beta): 0 float32, 1 bfloat16.
// x and out are (N, C) contiguous, gamma and beta (C), mean and var (C)
// float32. Returns the CUDA error of the launch, or cudaSuccess, and
// cudaErrorInvalidValue for a shape or type the kernel does not take.
int pdt_batch_norm_train(int x_dtype, int p_dtype, const void* x,
                         const void* gamma, const void* beta, void* out,
                         void* mean, void* var, int N, int C, float eps,
                         void* stream) {
  if (N < 1 || C < 1 || x_dtype < 0 || x_dtype > 1 || p_dtype < 0 ||
      p_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && p_dtype == 0)
    return bn_train<float, float>(x, gamma, beta, out, mean, var, N, C, eps,
                                  st);
  if (x_dtype == 0)
    return bn_train<float, __nv_bfloat16>(x, gamma, beta, out, mean, var, N,
                                          C, eps, st);
  if (p_dtype == 0)
    return bn_train<__nv_bfloat16, float>(x, gamma, beta, out, mean, var, N,
                                          C, eps, st);
  return bn_train<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, out, mean,
                                                var, N, C, eps, st);
}

// bn_plan's cut of an (N, C) batch of `itemsize`-byte elements into
// out[5]: strip width, strips, cluster size, slab rows, rows held in
// shared memory (for ops/batchnorm.py's mirror to be checked against on
// the card)
int pdt_batch_norm_plan(int N, int C, int itemsize, int* out) {
  if (N < 1 || C < 1 || (itemsize != 2 && itemsize != 4))
    return (int)cudaErrorInvalidValue;
  const BnPlan p = bn_plan(N, C, itemsize);
  out[0] = p.width;
  out[1] = p.strips;
  out[2] = p.cluster;
  out[3] = p.rows;
  out[4] = p.cached;
  return 0;
}

}  // extern "C"
