// The causal flash-attention kernels (K3, K4; see flash_attention.cu for
// what they compute and why) and their launchers. Included by
// flash_attention.cu, which runs them on float32 and bfloat16 tensors and
// holds the C entry points, and by flash_attention_f16.cu, which
// instantiates them for float16, so that nvcc builds the two at once.
#pragma once

#include "common.cuh"

namespace pdt_fa {

// fwd, bwd_dq and bwd_dkv for float16 tensors (T = __half), defined in
// flash_attention_f16.cu; their arguments as pdt_flash_fwd's,
// pdt_flash_bwd_dq's and pdt_flash_bwd_dkv's after dtype
int fwd_f16(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int L, int H, int d, float scale, cudaStream_t st);
int bwd_dq_f16(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dd, void* dq, int B, int L, int H,
               int d, float scale, cudaStream_t st);
int bwd_dkv_f16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* dd, void* dk,
                void* dv, int B, int L, int H, int d, float scale,
                cudaStream_t st);

}  // namespace pdt_fa

namespace {

constexpr int kMaxHeadDim = 256;

// ---- K4: the backward on the tensor cores ----
//
// Tiles: a dq block owns 64 query rows, a dk/dv block 64 key rows; warp
// (rg, ch, sp) takes the 16 rows 16 rg of them, the 8 FT output features
// from 64 ch, and share sp of each stage's KB streamed rows (key rows for
// dq, query rows for dk/dv). Each warp keeps its scores and dP as mma
// accumulators, forms p and ds there, and feeds them straight back as the A
// operand of the next product: an accumulator of m16n8k8 holds columns
// 2q, 2q + 1 of row g, which is the A fragment of the same row for the k
// order (2q, 2q + 1) <- (q, q + 4), so the B operand is read from shared
// memory in that order and nothing goes through shared memory in between.
// Warps of shares 1, 2, ... hand their sums to share 0 through shared
// memory at the end, added in that fixed order: no atomics, the same bits
// every call. One configuration for each head_dim bound (48: the training
// shape's; 64, 128, 256), each within 128 registers a thread at 512
// threads (256 at d <= 64, whose two 64-feature accumulators would spill).
template <int D>
struct BwdCfg {
  static constexpr int FT = (D < 64 ? D : 64) / 8;  // n8 output tiles
  static constexpr int NCH = D <= 64 ? 1 : D / 64;  // warps across features
  static constexpr int SPL = D == 48 ? 4 : (D == 256 ? 1 : 2);  // shares
  static constexpr int KB = D <= 64 ? 64 : (D == 128 ? 32 : 16);  // rows a
                                                    // stage streams
  static constexpr int KW = KB / SPL;               // a warp's rows of it
  static constexpr int NT = KW / 8;                 // its n8 score tiles
  static constexpr int THREADS = 32 * 4 * NCH * SPL;
  // float32: split the kept tiles once (their lo parts fit in shared
  // memory up to d = 128)
  static constexpr bool PRESPLIT = D <= 128;
};
constexpr int kBwdRows = 64;  // query rows of a dq block, keys of a dk/dv
//  elements a shared row: T = float, d rounded to 8 plus 4 (a multiple of 4
// and 4 mod 8); bfloat16 or float16, d rounded to 16 plus 8 (a multiple of 8
// and 8 mod 16): 16-byte aligned rows, and the fragment reads of a warp (8
// rows x 4
// neighbouring columns, or 4 rows 2 apart x 8 columns) fall in 32 banks
template <typename T>
__host__ __device__ __forceinline__ int tile_stride(int d) {
  return sizeof(T) == 4 ? (d + 7) / 8 * 8 + 4 : (d + 15) / 16 * 16 + 8;
}

// Rows [row0, row0 + rows) of one head of a (B, L, H, d) tensor into shared
// memory as T, `st` elements a row, by cp.async (16-byte chunks if `vec`:
// d a multiple of 16 bytes and the tensors 16-byte aligned; else 4-byte
// floats, or plain copies of 16-bit elements); zero at rows >= L and
// features [d, d rounded to 8) that the 8-wide k steps read. 16 threads a
// row (nthreads a multiple of 16), so no thread divides.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src,
                                          size_t base, size_t rs, int row0,
                                          int rows, int L, int d, int st,
                                          bool vec, int nthreads) {
  constexpr int E = 16 / sizeof(T);
  const int dp = (d + 7) / 8 * 8, c0 = threadIdx.x & 15;
  for (int r = threadIdx.x >> 4; r < rows; r += nthreads >> 4) {
    const int row = row0 + r;
    const T* from = src + base + (size_t)row * rs;
    T* to = dst + r * st;
    if (vec) {
      for (int c = c0 * E; c < dp; c += 16 * E) {
        const bool ok = row < L && c < d;
        cp_async16(smem_u32(to + c), ok ? from + c : src, ok ? 16 : 0);
      }
    } else {
      for (int c = c0; c < dp; c += 16) {
        const bool ok = row < L && c < d;
        if constexpr (sizeof(T) == 4)
          cp_async4(smem_u32(to + c), ok ? from + c : src, ok ? 4 : 0);
        else
          to[c] = ok ? from[c] : from_f<T>(0.f);
      }
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// Split rows [0, rows) of a float32 tile in place into their TF32 hi parts
// and, `lo` floats on, their lo parts; 16 threads a row. For the tiles a
// block keeps for its whole walk (q and dO in dq, k and v in dk/dv), so
// their fragments are read, not split, at every stage.
__device__ __forceinline__ void presplit(float* s, int lo, int rows, int d,
                                         int st, int nthreads) {
  const int dp = (d + 7) / 8 * 8;
  for (int r = threadIdx.x >> 4; r < rows; r += nthreads >> 4)
    for (int c = threadIdx.x & 15; c < dp; c += 16) {
      const float x = s[r * st + c];
      const unsigned h = tf32_rna(x);
      s[r * st + c] = __uint_as_float(h);
      s[r * st + c + lo] = __uint_as_float(tf32_rna(x - __uint_as_float(h)));
    }
}

// x[j] = a b^T and y[j] = c e^T over d features: rows ra + (0..15) of a
// and c, rows 8 j + (0..7) of b and e, `st` elements a row; a and c
// pre-split when PRE (presplit, lo parts `lo` floats on)
template <bool F32, bool PRE, int NT, typename T>
__device__ __forceinline__ void scores(const T* sa, const T* sb, const T* sc,
                                       const T* se, int st, int lo, int ra,
                                       int d, int g, int q,
                                       float (&x)[NT][4],
                                       float (&y)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
  const int s8 = 8 * st;
  const T* pa = sa + (ra + g) * st + q;  // A: rows g, g + 8; k q, q + 4
  const T* pc = sc + (ra + g) * st + q;
  const T* pb = sb + g * st + q;  // B^T: row 8 j + g; k q, q + 4
  const T* pe = se + g * st + q;
  for (int k0 = 0; k0 < d; k0 += 8) {
    unsigned ah[4], al[4], ch[4], cl[4];
    const int ka[4] = {k0, k0 + s8, k0 + 4, k0 + s8 + 4};
    if constexpr (PRE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = __float_as_uint(to_f(pa[ka[i]]));
        al[i] = __float_as_uint(to_f(pa[ka[i] + lo]));
        ch[i] = __float_as_uint(to_f(pc[ka[i]]));
        cl[i] = __float_as_uint(to_f(pc[ka[i] + lo]));
      }
    } else {
      split<F32>({to_f(pa[ka[0]]), to_f(pa[ka[1]]), to_f(pa[ka[2]]),
                  to_f(pa[ka[3]])}, ah, al);
      split<F32>({to_f(pc[ka[0]]), to_f(pc[ka[1]]), to_f(pc[ka[2]]),
                  to_f(pc[ka[3]])}, ch, cl);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned bh[2], bl[2], eh[2], el[2];
      split<F32>({to_f(pb[j * s8 + k0]), to_f(pb[j * s8 + k0 + 4])}, bh, bl);
      split<F32>({to_f(pe[j * s8 + k0]), to_f(pe[j * s8 + k0 + 4])}, eh, el);
      mma3<F32, F32>(x[j], ah, al, bh, bl);
      mma3<F32, F32>(y[j], ch, cl, eh, el);
    }
  }
}

// out[n] += x (16 x 8 NT, accumulator fragments) times rows [0, 8 NT) of
// sb, features f0 + 8 n, for the n with f0 + 8 n < d
template <bool F32, int NT, int FT, typename T>
__device__ __forceinline__ void accumulate(const float (&x)[NT][4],
                                           const T* sb, int st, int f0,
                                           int d, int g, int q,
                                           float (&out)[FT][4]) {
  const int nn = (d - f0 + 7) / 8;  // tiles holding features below d
  const T* pb = sb + 2 * q * st + f0 + g;  // B: rows 2q, 2q + 1; column g
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    unsigned ah[4], al[4];
    split<true>({x[j][0], x[j][2], x[j][1], x[j][3]}, ah, al);
    const T* p0 = pb + j * 8 * st;
    const T* p1 = p0 + st;
#pragma unroll
    for (int n = 0; n < FT; ++n) {
      if (n >= nn) break;
      unsigned bh[2], bl[2];
      split<F32>({to_f(p0[8 * n]), to_f(p1[8 * n])}, bh, bl);
      mma3<true, F32>(out[n], ah, al, bh, bl);
    }
  }
}

// Warps of shares 1, 2, ... add their out[FT][4] to share 0's through
// shared memory `red`, in that order. Ends synchronised; only share 0
// holds the sum.
template <int SPL, int FT>
__device__ __forceinline__ void reduce_shares(float (&out)[FT][4], float* red,
                                              int slot, int sp, int lane) {
#pragma unroll 1
  for (int from = 1; from < SPL; ++from) {
    if (sp == from)
#pragma unroll
      for (int n = 0; n < FT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((slot * FT + n) * 4 + e) * 32 + lane] = out[n][e];
    __syncthreads();
    if (sp == 0)
#pragma unroll
      for (int n = 0; n < FT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[n][e] += red[((slot * FT + n) * 4 + e) * 32 + lane];
    __syncthreads();
  }
}

// ---- K3: the forward on the tensor cores ----
//
// A block owns 64 query rows; warp (rg, ch, sp) takes the 16 rows 16 rg of
// them, the output features from 64 ch (FT n8 tiles), and share sp of each
// stage's KB keys. Each warp runs its own online softmax over its keys:
// scores as mma accumulators, in the log2 domain (s scale log2(e)), a row
// max over the 4 lanes of a quad, p = 2^(s - m) fed straight back as the A
// operand of p V (the fragment identity of K4 above), a running max m and
// sum l a row; l is kept as each lane's partial sum of its own columns
// (the quad's rescales are equal), added over the quad at the end. The
// shares' states (m, l, acc) are then merged into share 0's in the fixed
// order 1, 2, ...: no atomics, the same bits every call. One configuration
// for each head_dim bound, as BwdCfg; above d = 64 the NCH feature warps of
// a row group each compute its scores (the redundancy the backward has).
template <int D>
struct FwdCfg {
  static constexpr int FT = (D < 64 ? D : 64) / 8;  // n8 output tiles
  static constexpr int NCH = D <= 64 ? 1 : D / 64;  // warps across features
  static constexpr int SPL = D <= 64 ? 4 : (D == 128 ? 2 : 1);  // shares
  static constexpr int KB = D <= 64 ? 64 : (D == 128 ? 32 : 16);  // keys a
                                                    // stage streams
  static constexpr int KW = KB / SPL;               // a warp's keys of it
  static constexpr int NT = KW / 8;                 // its n8 score tiles
  static constexpr int THREADS = 32 * 4 * NCH * SPL;
  static constexpr bool PRESPLIT = D <= 128;  // float32 q split once
};
constexpr int kFwdRows = 64;  // query rows of a forward block
constexpr float kLn2 = 0.6931471805599453f;

// x[j] = a b^T over d features: rows ra + (0..15) of a, rows 8 j + (0..7)
// of b, `st` elements a row; a pre-split when PRE (presplit, lo parts `lo`
// floats on): the one product of scores() above, which keeps K4's two in
// one loop so that their loads interleave.
template <bool F32, bool PRE, int NT, typename T>
__device__ __forceinline__ void score_tile(const T* sa, const T* sb, int st,
                                           int lo, int ra, int d, int g,
                                           int q, float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
  const int s8 = 8 * st;
  const T* pa = sa + (ra + g) * st + q;  // A: rows g, g + 8; k q, q + 4
  const T* pb = sb + g * st + q;         // B^T: row 8 j + g; k q, q + 4
  for (int k0 = 0; k0 < d; k0 += 8) {
    unsigned ah[4], al[4];
    const int ka[4] = {k0, k0 + s8, k0 + 4, k0 + s8 + 4};
    if constexpr (PRE) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = __float_as_uint(to_f(pa[ka[i]]));
        al[i] = __float_as_uint(to_f(pa[ka[i] + lo]));
      }
    } else {
      split<F32>({to_f(pa[ka[0]]), to_f(pa[ka[1]]), to_f(pa[ka[2]]),
                  to_f(pa[ka[3]])}, ah, al);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned bh[2], bl[2];
      split<F32>({to_f(pb[j * s8 + k0]), to_f(pb[j * s8 + k0 + 4])}, bh, bl);
      mma3<F32, F32>(x[j], ah, al, bh, bl);
    }
  }
}

// The quad's maximum (the 4 lanes sharing a fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// The factor that takes a state of running max m to the max mn: 2^(m - mn),
// with a row that has seen no key yet (mn = -inf) left at 0
__device__ __forceinline__ float rescale(float m, float mn) {
  return exp2f(m - (mn == -INFINITY ? 0.f : mn));
}

// Forward: one block per (64-row query tile, b * H + h), the heaviest
// (last) query tile first, over the KB-key stages up to the diagonal; K and
// V stream through two stages while the last one is multiplied.
template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int L, int H, int d, float scale,
              int vec) {
  using C = FwdCfg<D>;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int st = tile_stride<T>(d);
  T* qs = reinterpret_cast<T*>(smem_raw);  // 64 x st
  T* kvs = qs + kFwdRows * st;             // [stage][K, V][KB x st]
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * kFwdRows;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qq = lane & 3;
  const int rg = warp & 3, ch = (warp >> 2) % C::NCH, sp = warp / (4 * C::NCH);
  copy_rows(qs, q, base, rs, q0, kFwdRows, L, d, st, vec, C::THREADS);
  copy_rows(kvs, k, base, rs, 0, C::KB, L, d, st, vec, C::THREADS);
  copy_rows(kvs + C::KB * st, v, base, rs, 0, C::KB, L, d, st, vec,
            C::THREADS);
  cp_async_commit();
  const int lo = (kFwdRows + 4 * C::KB) * st;  // q's lo parts
  constexpr bool PRE = F32 && C::PRESPLIT;
  if constexpr (PRE) {
    cp_async_wait<0>();
    __syncthreads();
    presplit(qs, lo, kFwdRows, d, st, C::THREADS);
  }

  const int r_lo = q0 + 16 * rg + g, r_hi = r_lo + 8;
  const float scale2 = scale * kLog2e;  // scores in the log2 domain
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[C::FT][4];
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_st = (min(q0 + kFwdRows, L) + C::KB - 1) / C::KB;
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // stage t is in; stage t - 1 is consumed
    if (t + 1 < n_st) {
      T* nxt = kvs + ((t + 1) & 1) * 2 * C::KB * st;
      copy_rows(nxt, k, base, rs, (t + 1) * C::KB, C::KB, L, d, st, vec,
                C::THREADS);
      copy_rows(nxt + C::KB * st, v, base, rs, (t + 1) * C::KB, C::KB, L, d,
                st, vec, C::THREADS);
    }
    cp_async_commit();
    const int kw0 = t * C::KB + sp * C::KW;  // this warp's first key
    if (kw0 > q0 + 16 * rg + 15) continue;   // above the diagonal
    const T* ks = kvs + (t & 1) * 2 * C::KB * st + sp * C::KW * st;
    const T* vs = ks + C::KB * st;
    float s[C::NT][4];
    score_tile<F32, PRE>(qs, ks, st, lo, 16 * rg, d, g, qq, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r_lo : r_hi;
        const int col = kw0 + 8 * j + 2 * qq + (e & 1);
        s[j][e] = (col <= row && col < L) ? s[j][e] * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float a[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mn = fmaxf(m[h], quad_max(mx[h]));
      a[h] = rescale(m[h], mn);
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mh = m[e >> 1];
        s[j][e] = exp2f(s[j][e] - (mh == -INFINITY ? 0.f : mh));  // p
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * a[h] + sum[h];
#pragma unroll
    for (int n = 0; n < C::FT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= a[e >> 1];
    accumulate<F32>(s, vs, st, 64 * ch, d, g, qq, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are consumed: `red` may reuse them

  // merge share 1, 2, ... into share 0, in that order
  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int kSlot = (C::FT * 4 + 4) * 32;  // floats a warp hands over
  float* mine = red + (warp % (4 * C::NCH)) * kSlot + lane;
#pragma unroll 1
  for (int from = 1; from < C::SPL; ++from) {
    if (sp == from) {
#pragma unroll
      for (int n = 0; n < C::FT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = acc[n][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mine[(C::FT * 4 + h) * 32] = m[h];
        mine[(C::FT * 4 + 2 + h) * 32] = l[h];
      }
    }
    __syncthreads();
    if (sp == 0) {
      float a[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mo = mine[(C::FT * 4 + h) * 32];
        const float mn = fmaxf(m[h], mo);
        a[h] = rescale(m[h], mn);
        b[h] = rescale(mo, mn);
        l[h] = l[h] * a[h] + mine[(C::FT * 4 + 2 + h) * 32] * b[h];
        m[h] = mn;
      }
#pragma unroll
      for (int n = 0; n < C::FT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * a[e >> 1] + mine[(n * 4 + e) * 32] * b[e >> 1];
    }
    __syncthreads();
  }
  if (sp != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums over the quad's columns
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r_lo : r_hi;
      const int col = 64 * ch + 8 * n + 2 * qq + (e & 1);
      if (row < L && col < d)
        o[base + (size_t)row * rs + col] = from_f<T>(acc[n][e] / l[e >> 1]);
    }
  if (qq == 0 && ch == 0) {
    const size_t lrow = (size_t)bh * L;
    if (r_lo < L) lse[lrow + r_lo] = m[0] * kLn2 + logf(l[0]);
    if (r_hi < L) lse[lrow + r_hi] = m[1] * kLn2 + logf(l[1]);
  }
}

// dq: one block per (64-row query tile, b * H + h), the heaviest (last)
// query tile first, over the KB-row key stages up to the diagonal; K and V
// stream through two stages while the last one is multiplied.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 T* __restrict__ dq, int L, int H, int d, float scale,
                 int vec) {
  using C = BwdCfg<D>;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int st = tile_stride<T>(d);
  T* qs = reinterpret_cast<T*>(smem_raw);  // 64 x st
  T* dos = qs + kBwdRows * st;
  T* kvs = dos + kBwdRows * st;  // [stage][K, V][KB x st]
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * kBwdRows;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qq = lane & 3;
  const int rg = warp & 3, ch = (warp >> 2) % C::NCH, sp = warp / (4 * C::NCH);
  copy_rows(qs, q, base, rs, q0, kBwdRows, L, d, st, vec, C::THREADS);
  copy_rows(dos, dout, base, rs, q0, kBwdRows, L, d, st, vec, C::THREADS);
  copy_rows(kvs, k, base, rs, 0, C::KB, L, d, st, vec, C::THREADS);
  copy_rows(kvs + C::KB * st, v, base, rs, 0, C::KB, L, d, st, vec,
            C::THREADS);
  cp_async_commit();
  const int lo = (2 * kBwdRows + 4 * C::KB) * st;  // q, dO lo parts
  constexpr bool PRE = F32 && C::PRESPLIT;
  if constexpr (PRE) {
    cp_async_wait<0>();
    __syncthreads();
    presplit(qs, lo, 2 * kBwdRows, d, st, C::THREADS);
  }

  const int r_lo = q0 + 16 * rg + g, r_hi = r_lo + 8;
  const size_t lrow = (size_t)bh * L;
  // p = exp(s scale - lse) = 2^(s scale log2(e) - lse log2(e))
  const float scale2 = scale * kLog2e;
  const float lse0 = r_lo < L ? lse[lrow + r_lo] * kLog2e : 0.f;
  const float lse1 = r_hi < L ? lse[lrow + r_hi] * kLog2e : 0.f;
  const float dd0 = r_lo < L ? dd[lrow + r_lo] : 0.f;
  const float dd1 = r_hi < L ? dd[lrow + r_hi] : 0.f;
  float acc[C::FT][4];
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_st = (min(q0 + kBwdRows, L) + C::KB - 1) / C::KB;
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // stage t is in; stage t - 1 is consumed
    if (t + 1 < n_st) {
      T* nxt = kvs + ((t + 1) & 1) * 2 * C::KB * st;
      copy_rows(nxt, k, base, rs, (t + 1) * C::KB, C::KB, L, d, st, vec,
                C::THREADS);
      copy_rows(nxt + C::KB * st, v, base, rs, (t + 1) * C::KB, C::KB, L, d,
                st, vec, C::THREADS);
    }
    cp_async_commit();
    const int kw0 = t * C::KB + sp * C::KW;  // this warp's first key
    if (kw0 > q0 + 16 * rg + 15) continue;   // above the diagonal
    const T* ks = kvs + (t & 1) * 2 * C::KB * st + sp * C::KW * st;
    const T* vs = ks + C::KB * st;
    float s[C::NT][4], dp[C::NT][4];
    scores<F32, PRE>(qs, ks, dos, vs, st, lo, 16 * rg, d, g, qq, s, dp);
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r_lo : r_hi;
        const int col = kw0 + 8 * j + 2 * qq + (e & 1);
        const float p = (col <= row && row < L)
                            ? exp2f(s[j][e] * scale2 - (e < 2 ? lse0 : lse1))
                            : 0.f;
        s[j][e] = p * (dp[j][e] - (e < 2 ? dd0 : dd1));  // ds
      }
    accumulate<F32>(s, ks, st, 64 * ch, d, g, qq, acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles are consumed: `red` may reuse them
  reduce_shares<C::SPL, C::FT>(acc, reinterpret_cast<float*>(smem_raw),
                                warp % (4 * C::NCH), sp, lane);
  if (sp != 0) return;
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r_lo : r_hi;
      const int col = 64 * ch + 8 * n + 2 * qq + (e & 1);
      if (row < L && col < d)
        dq[base + (size_t)row * rs + col] = from_f<T>(acc[n][e] * scale);
    }
}

// dk and dv: one block per (64-row key tile, b * H + h), key tile 0 (the
// heaviest) first, over the KB-row query stages from the one holding the
// tile's first key to the end; Q, dO and the stage's lse and dd stream
// through two stages. Scores are computed transposed (key rows, query
// columns), so p^T and ds^T are the A operands of dv and dk.
template <typename T, int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dd,
                  T* __restrict__ dk, T* __restrict__ dv, int L, int H, int d,
                  float scale, int vec) {
  using C = BwdCfg<D>;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int st = tile_stride<T>(d);
  T* ks = reinterpret_cast<T*>(smem_raw);  // 64 x st
  T* vs = ks + kBwdRows * st;
  T* qds = vs + kBwdRows * st;  // [stage][Q, dO][KB x st]
  float* lds = reinterpret_cast<float*>(qds + 4 * C::KB * st);  // [stage]
                                                    // [lse, dd][KB]
  const int bh = blockIdx.y, k0 = blockIdx.x * kBwdRows;
  const size_t rs = (size_t)H * d;
  const size_t base = (size_t)(bh / H) * L * rs + (size_t)(bh % H) * d;
  const size_t lrow = (size_t)bh * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qq = lane & 3;
  const int rg = warp & 3, ch = (warp >> 2) % C::NCH, sp = warp / (4 * C::NCH);
  const int t0 = k0 / C::KB, n_st = (L + C::KB - 1) / C::KB;
  auto stage = [&](int t) {  // Q, dO, lse and dd rows of stage t
    T* dst = qds + (t & 1) * 2 * C::KB * st;
    copy_rows(dst, q, base, rs, t * C::KB, C::KB, L, d, st, vec, C::THREADS);
    copy_rows(dst + C::KB * st, dout, base, rs, t * C::KB, C::KB, L, d, st,
              vec, C::THREADS);
    float* l = lds + (t & 1) * 2 * C::KB;
    for (int i = threadIdx.x; i < 2 * C::KB; i += C::THREADS) {
      const int row = t * C::KB + (i % C::KB);
      const bool ok = row < L;
      cp_async4(smem_u32(l + i),
                ok ? (i < C::KB ? lse : dd) + lrow + row : lse, ok ? 4 : 0);
    }
  };
  copy_rows(ks, k, base, rs, k0, kBwdRows, L, d, st, vec, C::THREADS);
  copy_rows(vs, v, base, rs, k0, kBwdRows, L, d, st, vec, C::THREADS);
  stage(t0);
  cp_async_commit();
  // k, v lo parts, after the tiles and lse/dd
  const int lo = (2 * kBwdRows + 4 * C::KB) * st + 4 * C::KB;
  constexpr bool PRE = F32 && C::PRESPLIT;
  if constexpr (PRE) {
    cp_async_wait<0>();
    __syncthreads();
    presplit(ks, lo, 2 * kBwdRows, d, st, C::THREADS);
  }

  const int key_lo = k0 + 16 * rg + g, key_hi = key_lo + 8;
  const float scale2 = scale * kLog2e;  // p = 2^(s scale2 - lse log2(e))
  float adk[C::FT][4], adv[C::FT][4];
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int t = t0; t < n_st; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_st) stage(t + 1);
    cp_async_commit();
    const int qw0 = t * C::KB + sp * C::KW;  // this warp's first query
    if (qw0 + C::KW - 1 < k0 + 16 * rg) continue;  // above the diagonal
    const T* qs = qds + (t & 1) * 2 * C::KB * st + sp * C::KW * st;
    const T* dos = qs + C::KB * st;
    const float* ls = lds + (t & 1) * 2 * C::KB + sp * C::KW;
    float s[C::NT][4], dp[C::NT][4];
    scores<F32, PRE>(ks, qs, vs, dos, st, lo, 16 * rg, d, g, qq, s, dp);
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_lo : key_hi;
        const int c = 8 * j + 2 * qq + (e & 1), col = qw0 + c;
        const float p = (col >= key && col < L)
                            ? exp2f(s[j][e] * scale2 - ls[c] * kLog2e)
                            : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - ls[C::KB + c]);  // ds
      }
    accumulate<F32>(s, dos, st, 64 * ch, d, g, qq, adv);
    accumulate<F32>(dp, qs, st, 64 * ch, d, g, qq, adk);
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_raw);
  const int slot = warp % (4 * C::NCH);
  reduce_shares<C::SPL, C::FT>(adk, red, slot, sp, lane);
  reduce_shares<C::SPL, C::FT>(adv, red, slot, sp, lane);
  if (sp != 0) return;
#pragma unroll
  for (int n = 0; n < C::FT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? key_lo : key_hi;
      const int col = 64 * ch + 8 * n + 2 * qq + (e & 1);
      if (row < L && col < d) {
        dk[base + (size_t)row * rs + col] = from_f<T>(adk[n][e] * scale);
        dv[base + (size_t)row * rs + col] = from_f<T>(adv[n][e]);
      }
    }
}

// Let `kernel` take `bytes` of dynamic shared memory (opting in above the
// 48 KB a block gets by default) and launch it with `threads` on `st`.
template <typename K, typename... Args>
cudaError_t launch_n(K* kernel, dim3 grid, int threads, size_t bytes,
                     cudaStream_t st, Args... args) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, bytes, st>>>(args...);
  return cudaGetLastError();
}

// bytes of dynamic shared memory of a backward kernel: its tiles (and the
// dk/dv kernel's lse and dd, and for float32 the lo parts of the two tiles
// it keeps), or the shares' hand-over, whichever is larger
template <typename T, int D>
size_t bwd_smem(int d, bool dkv) {
  using C = BwdCfg<D>;
  const size_t tiles =
      (size_t)(2 * kBwdRows + 4 * C::KB) * tile_stride<T>(d) * sizeof(T) +
      (dkv ? 4 * C::KB * sizeof(float) : 0) +
      (sizeof(T) == 4 && C::PRESPLIT
           ? (size_t)2 * kBwdRows * tile_stride<T>(d) * sizeof(float) : 0);
  const size_t red =
      C::SPL > 1 ? (size_t)4 * C::NCH * C::FT * 4 * 32 * sizeof(float) : 0;
  return tiles > red ? tiles : red;
}

// 16-byte copies need d a multiple of 16 bytes and 16-byte aligned tensors
template <typename T>
int tile_vec(int d, const void* q, const void* k, const void* v,
             const void* dout) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return d % (16 / (int)sizeof(T)) == 0 && a16(q) && a16(k) && a16(v) &&
         a16(dout);
}

bool bad_shape(int B, int L, int H, int d) {
  return B < 1 || L < 1 || H < 1 || d < 1 || d > kMaxHeadDim ||
         (long long)B * H > 65535;
}

// bytes of dynamic shared memory of the forward: its tiles (and for
// float32 q's lo parts), or the shares' hand-over, whichever is larger
template <typename T, int D>
size_t fwd_smem(int d) {
  using C = FwdCfg<D>;
  const size_t tiles =
      (size_t)(kFwdRows + 4 * C::KB) * tile_stride<T>(d) * sizeof(T) +
      (sizeof(T) == 4 && C::PRESPLIT
           ? (size_t)kFwdRows * tile_stride<T>(d) * sizeof(float) : 0);
  const size_t red = C::SPL > 1
      ? (size_t)4 * C::NCH * (C::FT * 4 + 4) * 32 * sizeof(float) : 0;
  return tiles > red ? tiles : red;
}

// the forward for head_dim up to D (48, 64, 128 or 256)
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int L, int H, int d, float scale,
                cudaStream_t st) {
  return launch_n(fa_fwd_kernel<T, D>,
                  dim3((L + kFwdRows - 1) / kFwdRows, B * H),
                  FwdCfg<D>::THREADS, fwd_smem<T, D>(d), st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<float*>(lse), L, H, d, scale,
                  tile_vec<T>(d, q, k, v, v));
}

// the backward kernels for head_dim up to D (48, 64, 128 or 256)
template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dd,
                   void* dq, int B, int L, int H, int d, float scale,
                   cudaStream_t st) {
  return launch_n(fa_bwd_dq_kernel<T, D>,
                  dim3((L + kBwdRows - 1) / kBwdRows, B * H),
                  BwdCfg<D>::THREADS, bwd_smem<T, D>(d, false), st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(dd), static_cast<T*>(dq), L, H,
                  d, scale, tile_vec<T>(d, q, k, v, dout));
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* dd,
                    void* dk, void* dv, int B, int L, int H, int d,
                    float scale, cudaStream_t st) {
  return launch_n(fa_bwd_dkv_kernel<T, D>,
                  dim3((L + kBwdRows - 1) / kBwdRows, B * H),
                  BwdCfg<D>::THREADS, bwd_smem<T, D>(d, true), st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(dd), static_cast<T*>(dk),
                  static_cast<T*>(dv), L, H, d, scale,
                  tile_vec<T>(d, q, k, v, dout));
}

// return fn<T, D>(...) for the kernels' configuration of head_dim d
// (FwdCfg, BwdCfg)
#define PDT_FA_BY_DIM(T, fn, ...)                                 \
  return d <= 48    ? fn<T, 48>(__VA_ARGS__)                      \
         : d <= 64  ? fn<T, 64>(__VA_ARGS__)                      \
         : d <= 128 ? fn<T, 128>(__VA_ARGS__)                     \
                    : fn<T, 256>(__VA_ARGS__)

}  // namespace
