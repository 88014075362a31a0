// The layers-only B=1 decode step on NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (pydynet_tpu/ops/decode_step.py:
// 1575, launched by `fused_decode_step` at :1657 -> :1721; K10), the older
// step that starts from a given hidden state h0 and has no embedding and no
// head. Per layer: RMSNorm; q/k/v; RoPE as q*cos + (q @ rot)*sin with the
// GIVEN (D, D) rot and (D,) cos/sin, in f32; the K/V row write at
// min(pos, S - 1); a plain softmax over all S cache rows with the rows
// after pos masked, the per-head scores coming from ck @ qM where
// qM = (q x hmask) rounded to the cache type, hmask (D, H) as given; the
// probabilities rounded to the cache type only after the softmax's global
// max and sum, expanded to D features by T(hmask)^T in f32 (not rounded),
// att = sum_s p_exp * cv; wo + residual; RMSNorm; SwiGLU + residual. It
// returns the final-RMSNormed h (f32). Unlike K1's online softmax over row
// blocks, this keeps the TPU kernel's order of rounding.
//
// One step is a chain of 5 * n_layers + 1 launches:
//   1. RMSNorm + q/k/v (step_qkv_kernel): a block a 16-row tile of wq, wk
//      or wv on the tensor cores through K2's layer_product
//      (decode_token_batched.cuh, mma_rows.cuh) on a group of one row; q
//      and k raw in f32 to scratch, v rounded to the cache at pos;
//   2. attention (step_attention_kernel), one thread-block cluster of up to
//      16 blocks: the rotation, the scores, the softmax, p_exp * cv and
//      their sum over the rows (below);
//   3. wo + residual, 4. RMSNorm + gate/up + SiLU * up, 5. down + residual:
//      K2's layer_wo_kernel, layer_gate_up_kernel and layer_down_kernel on
//      one row, the stages K1 runs;
// and 6. the final RMSNorm. Rows after pos get probability 0 exactly in
// the TPU kernel, so their keys and values are not read here: the result
// is the same for any finite cache contents. Every launch of the chain is
// a programmatic dependent launch (chain_launch): a kernel may start once
// the one before it has passed its own wait, stages its inputs that no
// running kernel writes (the weights' first stages; rot, hmask, cos, sin
// and the K rows of earlier steps), and waits (pdl_wait) before it reads
// or writes anything else, so each kernel's loads overlap the one before.
//
// The attention stage. The rows [0, pos] are split over the cluster's
// blocks (512 threads each) in 16-row tiles, and every block copies its
// tiles' K and V rows into shared memory by cp.async at once (a warp 4 rows
// of 128 bytes an instruction), with its share of the rot columns, the raw
// q and k, cos, sin and hmask: one trip to memory. Each block rotates its
// share of the features (q @ rot and k @ rot, then * sin + x * cos) and
// stores it into every block's q (distributed shared memory; every
// exchange here is a store into the peers' shared memory, then a cluster
// barrier, then local reads, so no block waits on a remote load), and its
// k share into the block holding row pos, which writes k rounded to the
// cache and puts it into its staged row pos itself: no block reads a cache
// row another block writes in this launch. qM^T (heads padded to 8) is
// made once in shared memory; the scores are (16 rows x 16 or 32 bytes) x
// qM on mma.sync (bfloat16 m16n8k16, float32 in 3xTF32), each lane reading
// its rows' 16 bytes and the matching 16 bytes of qM^T (the products' k
// order permuted alike), the K split over warps summed in warp order. Each
// block's max and sum of exp(s - max) per head go to every block before a
// second barrier, and every block forms the global max and sum by one
// shuffle tree before it rounds any p. p_exp runs on mma.sync too,
// transposed: T(hmask) rows (16 features) times p's rows (8 rows), the
// heads the k dimension padded to 16 or 8, as (feature tile, row tile)
// items spread evenly over the warps; each item's products are multiplied
// by the staged V elementwise and summed over its rows, and each feature's
// items are added in row order. Each block pushes its column sums into a
// slot of the block that owns those columns; after a third barrier the
// owners add the slots in rank order and write att. No grid barrier, no
// float atomics: the same bits on every run. The cut (cluster size, rows,
// features and rot rows staged at once) is attn_plan's, from (D, H, S); a
// shape whose rows or features do not fit at once is staged in chunks,
// and scores that do not fit in shared memory go to scratch.
//
// What bounds it on an H100: at stories15M width (6 layers, D 288, F 768,
// S 1024) a bf16 step at pos 512 reads about 4 MB of weights and 3.5 MB of
// KV, about 2.3 us at 3.35 TB/s, against 31 launches of a few us each:
// latency. The design cuts launches, overlaps each with the one before,
// and puts the products on the tensor cores.

#include <cooperative_groups.h>

#include "decode_token_batched.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxHeads = 64;        // ops/decode_step.py's MAX_STEP_HEADS
constexpr int kAttnCluster = 16;     // the most blocks of an attention stage
constexpr int kAThreads = 512;       // an attention block's threads
constexpr int kAWarps = kAThreads / 32;
constexpr int kMaxFeatChunk = 512;   // features of a staged cache chunk

__device__ __forceinline__ int clamp_pos(const int* pos_p, int S) {
  return min(max(*pos_p, 0), S - 1);
}

// 1. RMSNorm + q/k/v of the one row. Block x takes rows [16 x', 16 x' + 16)
// of wq (x < t), wk or wv (t = ceil(D / 16)). Layer 0 normalises h0 (block
// 0 copies it into h). q and k go raw (f32) to qk (2 D), v rounded to the
// layer's V cache at row pos.
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_qkv_kernel(const int* __restrict__ pos_p, const float* __restrict__ h0,
                int first, float* __restrict__ h,
                const T* __restrict__ in_norm, const T* __restrict__ wq,
                const T* __restrict__ wk, const T* __restrict__ wv,
                float* __restrict__ qk, T* __restrict__ cv, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  __shared__ float sx_s[8];
  const int t = (D + kLayerRows - 1) / kLayerRows;
  const int which = blockIdx.x / t;  // 0 q, 1 k, 2 v
  const int row0 = kLayerRows * (blockIdx.x - which * t);
  const T* wm = which == 0 ? wq : (which == 1 ? wk : wv);
  const ActRows a = act_rows<kFmtFloat, T>(D);
  unsigned char* act = smem_u8 + layer_smem<kFmtFloat, T>(D, 0, 1);
  const unsigned char* wt[1] = {
      reinterpret_cast<const unsigned char*>(wm + (size_t)row0 * D)};
  const int nr[1] = {min(kLayerRows, D - row0)};
  float* raw =
      reinterpret_cast<float*>(smem_u8 + layer_smem<kFmtFloat, T>(D, 1, 1));
  T* w_s = reinterpret_cast<T*>(raw + D);
  const float* src = first ? h0 : h;
  layer_product<kFmtFloat, T, 1, 1, true>(
      wt, nr, D, a, 1, smem_u8, act,
      [&] { stage_norm_rows(src, nullptr, 0, in_norm, D, 1, raw, w_s); },
      [&] {
        cp_async_wait<0>();
        __syncthreads();
        load_act_rows<kFmtFloat, T>(raw, nullptr, 0, w_s, D, 1, a, act,
                                    sx_s);
      });
  const int pos = clamp_pos(pos_p, S);  // read after layer_product's wait
  if (first && blockIdx.x == 0)
    for (int i = threadIdx.x; i < D; i += kThreads) h[i] = h0[i];
  if ((int)threadIdx.x < nr[0]) {
    const int j = row0 + threadIdx.x;
    const float v = tile_sum<kFmtFloat, 1, 1>(smem_u8, 0, threadIdx.x, 0);
    if (which < 2)
      qk[which * D + j] = v;
    else
      cv[(size_t)pos * D + j] = from_f<T>(v);
  }
}

// The attention stage's cut (attn_plan) and its shared memory's layout
struct AttnPlan {
  int cs;       // blocks of the cluster, the whole grid
  int share;    // features a block rotates and sums (a multiple of 4)
  int mtc;      // 16-row tiles of a staged row chunk: 1, 2, 4 or 8
  int fc;       // features of a staged chunk (a multiple of 32, <= 512)
  int ic;       // rot rows staged at once
  int rg;       // rot row groups (warps) of the rotation: 16, 8, .., 1
  int hp, hk;   // heads padded to 8 (the scores' n), to the k of p_exp
  int v_too;    // V staged beside K when a block's rows are one chunk
  int sb_smem;  // the scores in shared memory, else in scratch
  int kstride;  // bytes of a staged row (an odd multiple of 64)
  int pstride;  // 4-byte words of a row of p (hk's words + 4)
  int bulk;     // cache rows staged 16 bytes a copy (aligned 16-byte rows)
  int rot16;    // rot rows staged 16 bytes a copy (D % 4 == 0, aligned)
  // byte offsets into dynamic shared memory, and its size
  int o_v, o_qm, o_rot, o_qk, o_qr, o_cs, o_hm, o_rp, o_sb, o_pb, o_st,
      o_ml, o_slot, smem;
};

inline int odd64(int bytes) { return (((bytes + 63) / 64) | 1) * 64; }

// The cut for a cluster of cs blocks: everything staged at once where it
// fits in kMaxSmem; else, in this order, V after the scores, the rot rows
// in halves, the scores in scratch, fewer row groups in the rotation, fewer
// rows and fewer features a chunk. smem < 0 when even the smallest cut
// does not fit.
template <typename T>
AttnPlan attn_plan(int D, int H, int S, int cs) {
  AttnPlan p{};
  p.cs = cs;
  p.share = ((D + cs - 1) / cs + 3) / 4 * 4;
  p.hp = (H + 7) / 8 * 8;
  p.hk = sizeof(T) == 2 ? (H + 15) / 16 * 16 : p.hp;
  p.pstride = p.hk * (int)sizeof(T) / 4 + 4;
  const int tpb = ((S + 15) / 16 + cs - 1) / cs;  // tiles a block at most
  p.mtc = 1;
  while (p.mtc < 8 && p.mtc < tpb) p.mtc *= 2;
  p.fc = min((D + 31) / 32 * 32, kMaxFeatChunk);
  p.ic = D;
  p.rg = kAWarps;
  p.v_too = 1;
  p.sb_smem = 1;
  auto layout = [&] {
    p.kstride = odd64(p.fc * (int)sizeof(T));
    auto r16 = [](long b) { return (int)((b + 15) / 16 * 16); };
    const int rc = 16 * p.mtc;
    int o = r16((long)rc * p.kstride);
    p.o_v = o;
    o += p.v_too ? r16((long)rc * p.kstride) : 0;
    p.o_qm = o;
    o += r16((long)p.hp * p.kstride);
    p.o_rot = o;  // the rot rows; then the scores' and p @ V's sums
    o += r16(4L * max((long)p.ic * p.share,
                      max((long)kAWarps * p.hp * 16,
                          (long)(p.fc / 16) * (2 * p.mtc) * 16)));
    p.o_qk = o;  // the raw q and k; then the block's att
    o += r16(2L * D * 4);
    p.o_qr = o;  // the rotated q
    o += r16((long)D * 4);
    p.o_cs = o;  // cos and sin of the share
    o += r16(2L * p.share * 4);
    p.o_hm = o;  // hmask rows of a feature chunk
    o += r16((long)p.fc * H * 4);
    p.o_rp = o;  // the rotation's sums: a row group a warp, q then k
    o += r16(2L * p.rg * p.share * 4);
    p.o_sb = o;
    o += p.sb_smem ? r16(16L * tpb * p.hp * 4) : 0;
    p.o_pb = o;
    o += r16((long)rc * p.pstride * 4);
    p.o_st = o;  // every block's max and sum of each head
    o += r16(2L * cs * p.hp * 4);
    p.o_ml = o;
    o += r16(2L * p.hp * 4);
    p.o_slot = o;  // the rotated k (the block of row pos), then att's
    o += r16((long)max(cs * p.share, D) * 4);
    p.smem = o;
  };
  for (layout(); p.smem > kMaxSmem; layout()) {
    if (p.v_too)
      p.v_too = 0;
    else if (p.ic > 16)
      p.ic = (p.ic + 1) / 2;
    else if (p.sb_smem)
      p.sb_smem = 0;
    else if (p.rg > 1)
      p.rg /= 2;
    else if (p.mtc > 1)
      p.mtc /= 2;
    else if (p.fc > 32)
      p.fc = max(32, p.fc / 2 / 32 * 32);
    else {
      p.smem = -1;
      break;
    }
  }
  return p;
}

// bfloat16 pair (lo, hi) as the 32 bits of an mma operand
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The scores of one 16-row tile: acc[nt] += rows (kt, `stride` bytes a
// row) x qM^T rows 8 nt.. (qm) over k-groups k0, k0 + kstep, .. < ngrp. A
// k-group is 16 bytes of a row a lane: lane (g, q) reads bytes [16 q, +16)
// of the group of rows g and g + 8 and of qM^T row g of each n8 tile, and
// hands them to the mma as its k positions (bfloat16 m16n8k16: two k steps
// of words (0, 1) and (2, 3); float32 3xTF32 m16n8k8: two k steps of
// elements (0, 1) and (2, 3)), the same permutation of k for both
// operands. Each 3xTF32 k step's large and small products go to fresh
// accumulators, added to the running sum (mma_rows.cuh's rule).
template <typename T>
__device__ __forceinline__ void scores_tile(float (&acc)[8][4],
                                            const unsigned char* kt,
                                            const unsigned char* qm,
                                            int stride, int ntl, int k0,
                                            int kstep, int ngrp) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int kg = k0; kg < ngrp; kg += kstep) {
    const int off = 64 * kg + 16 * q;
    const uint4 ra = *reinterpret_cast<const uint4*>(kt + g * stride + off);
    const uint4 rb =
        *reinterpret_cast<const uint4*>(kt + (g + 8) * stride + off);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= ntl) break;
      const uint4 qb = *reinterpret_cast<const uint4*>(
          qm + (8 * nt + g) * stride + off);
      if constexpr (sizeof(T) == 2) {
        const unsigned a0[4] = {ra.x, rb.x, ra.y, rb.y};
        const unsigned a1[4] = {ra.z, rb.z, ra.w, rb.w};
        mma_bf16(acc[nt], a0, qb.x, qb.y);
        mma_bf16(acc[nt], a1, qb.z, qb.w);
      } else {
        const float* fa = reinterpret_cast<const float*>(&ra);
        const float* fb = reinterpret_cast<const float*>(&rb);
        const float* fq = reinterpret_cast<const float*>(&qb);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          unsigned ah[4], al[4], bh[2], bl[2];
          split<true>({fa[2 * s], fb[2 * s], fa[2 * s + 1], fb[2 * s + 1]},
                      ah, al);
          split<true>({fq[2 * s], fq[2 * s + 1]}, bh, bl);
          float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(small, al, bh);
          mma_tf32(small, ah, bl);
          mma_tf32(big, ah, bh);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += big[e] + small[e];
        }
      }
    }
  }
}

// Rows [r0, r0 + cnt) of a (rows, D) cache, features [f0, f0 + nf), into
// shared rows of `ks` bytes (zero from nf to fc) by cp.async, lane l of a
// warp taking 16-byte piece l & 7 of row 4 w + l / 8 (a warp copies 4 rows
// x 128 bytes an instruction); rows that are not aligned 16-byte
// multiples (`bulk` false) are copied element by element, a warp a row,
// and the block synchronises. Out of line: one copy of the code serves
// every call.
template <typename T>
__device__ __noinline__ void stage_rows(unsigned char* buf, const T* src,
                                        int r0, int cnt, int f0, int nf,
                                        int fc, int D, int ks, bool bulk) {
  constexpr int E = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (bulk) {
    const int pieces = (nf + E - 1) / E;
    for (int r = 4 * warp + (lane >> 3); r < cnt; r += 4 * warps) {
      const T* from = src + (size_t)(r0 + r) * D + f0;
      const unsigned to = smem_u32(buf + r * ks);
      for (int pc = lane & 7; pc < pieces; pc += 8)
        cp_async16(to + 16 * pc, from + E * pc, 16);
    }
    if (nf < fc)  // zero the features past D
      for (int r = warp; r < cnt; r += warps)
        for (int f = nf + lane; f < fc; f += 32)
          reinterpret_cast<T*>(buf + r * ks)[f] = from_f<T>(0.f);
    return;
  }
  for (int r = warp; r < cnt; r += warps) {
    T* row = reinterpret_cast<T*>(buf + r * ks);
    const T* from = src + (size_t)(r0 + r) * D + f0;
    for (int f = lane; f < fc; f += 32)
      row[f] = f < nf ? from[f] : from_f<T>(0.f);  // zero past D
  }
  __syncthreads();
}

// cnt rows of a block's share of rot's columns (`from` its first row, the
// rows D apart, nsh columns) into rows of `share` floats by cp.async, 16
// bytes a copy where D is a multiple of 4 (and rot aligned), else 4
__device__ __noinline__ void stage_rot_rows(float* rotb, const float* from,
                                            int cnt, int nsh, int D,
                                            int share, bool v16) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5, v = v16 ? 4 : 1;
  for (int i = 4 * warp + (lane >> 3); i < cnt; i += 4 * warps)
    for (int j = v * (lane & 7); j < nsh; j += 8 * v) {
      const unsigned to = smem_u32(rotb + i * share + j);
      if (v == 4)
        cp_async16(to, from + (size_t)i * D + j, 16);
      else
        cp_async4(to, from + (size_t)i * D + j, 4);
    }
}

// 2. The attention of one layer, one cluster of P.cs blocks (file comment).
// qk: the raw q and k (2 D, stage 1); ck, cv: the layer's (S, D) caches;
// sb_global: (S, hp) scratch for scores that do not fit in shared memory;
// att_out: (D) f32, which the wo stage rounds to T.
template <typename T>
__global__ void __launch_bounds__(kAThreads)
step_attention_kernel(const int* __restrict__ pos_p,
                      const float* __restrict__ qk,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      const float* __restrict__ rot,
                      const float* __restrict__ hmask, T* __restrict__ ck,
                      const T* __restrict__ cv, float* __restrict__ sb_global,
                      float* __restrict__ att_out, int D, int H, int S,
                      float scale, AttnPlan P) {
  constexpr int KG = 64 / sizeof(T);  // features of a k-group: a quad's 64 bytes
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = P.cs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int pos = clamp_pos(pos_p, S), n = pos + 1;
  const int tpb = ((n + 15) / 16 + C - 1) / C;
  const int rlo = min(n, 16 * rank * tpb), rhi = min(n, 16 * (rank + 1) * tpb);
  const int nrows = rhi - rlo, RC = 16 * P.mtc;
  const int nrc = (nrows + RC - 1) / RC, nfc = (D + P.fc - 1) / P.fc;
  const bool one = P.v_too && nrc <= 1 && nfc == 1;
  const bool mine = pos >= rlo && pos < rhi;  // this block holds row pos
  const int owner = min(C - 1, (pos / 16) / tpb);  // the block of row pos
  const int j0 = rank * P.share, nsh = max(0, min(P.share, D - j0));
  const int ks = P.kstride;
  unsigned char* kbuf = sm;
  unsigned char* vbuf = sm + P.o_v;
  unsigned char* qm = sm + P.o_qm;
  float* rotb = reinterpret_cast<float*>(sm + P.o_rot);
  float* qkb = reinterpret_cast<float*>(sm + P.o_qk);
  float* qr = reinterpret_cast<float*>(sm + P.o_qr);
  float* csb = reinterpret_cast<float*>(sm + P.o_cs);  // cos, then sin
  float* hmb = reinterpret_cast<float*>(sm + P.o_hm);
  float* rp = reinterpret_cast<float*>(sm + P.o_rp);
  float* sbuf = P.sb_smem ? reinterpret_cast<float*>(sm + P.o_sb)
                          : sb_global + (size_t)rlo * P.hp;
  float* red = rotb;  // the scores' partial sums, after the rotation
  unsigned* pb = reinterpret_cast<unsigned*>(sm + P.o_pb);
  float* st = reinterpret_cast<float*>(sm + P.o_st);
  float* ml = reinterpret_cast<float*>(sm + P.o_ml);
  float* slot = reinterpret_cast<float*>(sm + P.o_slot);
  float* kr = slot;  // the rotated k, until the att slots are filled
  float* att_blk = qkb;  // the block's att, after the rotation
  float* pvp = rotb;     // p @ V's sums, after the scores
  // the cluster's blocks store into each other's shared memory only after
  // all have started: this arrival is waited for before the first store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  auto stage_cache = [&](unsigned char* buf, const T* src, int r0, int cnt,
                         int f0) {
    stage_rows<T>(buf, src, r0, cnt, f0, min(P.fc, D - f0), P.fc, D, ks,
                  P.bulk);
  };
  auto wait_cache = [&] {
    cp_async_wait<0>();
    __syncthreads();
  };
  auto stage_rot = [&](int i0) {
    stage_rot_rows(rotb, rot + (size_t)i0 * D + j0, min(P.ic, D - i0), nsh,
                   D, P.share, P.rot16);
  };
  // hmask rows [f0, f0 + fc) by cp.async
  auto stage_hmask = [&](int f0) {
    for (int i = tid; i < min(P.fc, D - f0) * H; i += kAThreads)
      cp_async4(smem_u32(hmb + i), hmask + (size_t)f0 * H + i, 4);
  };

  // one trip to memory, all by cp.async. The share's rot rows, cos and
  // sin, the first hmask rows and K rows come from inputs and from earlier
  // steps: they are in flight before the wait for the q/k/v stage (with a
  // programmatic launch, while it runs); the raw q and k and the V rows
  // (row pos is the q/k/v stage's) after it. Group 0 all but V.
  for (int j = tid; j < nsh; j += kAThreads) {
    cp_async4(smem_u32(csb + j), cos_t + j0 + j, 4);
    cp_async4(smem_u32(csb + P.share + j), sin_t + j0 + j, 4);
  }
  stage_hmask(0);
  if (nsh > 0) stage_rot(0);
  if (nrows > 0) stage_cache(kbuf, ck, rlo, min(RC, nrows), 0);
  pdl_wait();
  pdl_launch();
  for (int i = tid; i < 2 * D; i += kAThreads)
    cp_async4(smem_u32(qkb + i), qk + i, 4);
  cp_async_commit();
  if (nrows > 0 && one) stage_cache(vbuf, cv, rlo, nrows, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the block's share of q @ rot and k @ rot: warp w < rg sums the rot
  // rows w, w + rg, .. of its lanes' columns; the rg sums meet in warp
  // order, then the RoPE of the share
  for (int i0 = 0; i0 < D; i0 += P.ic) {
    if (i0 > 0) {
      __syncthreads();
      if (nsh > 0) stage_rot(i0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int cnt = min(P.ic, D - i0);
    for (int j = lane; j < nsh && warp < P.rg; j += 32) {
      float sq = i0 > 0 ? rp[warp * P.share + j] : 0.f;
      float sk = i0 > 0 ? rp[(P.rg + warp) * P.share + j] : 0.f;
#pragma unroll 4
      for (int i = warp; i < cnt; i += P.rg) {
        const float r = rotb[i * P.share + j];
        sq += qkb[i0 + i] * r;
        sk += qkb[D + i0 + i] * r;
      }
      rp[warp * P.share + j] = sq;
      rp[(P.rg + warp) * P.share + j] = sk;
    }
  }
  __syncthreads();
  // the rotated share into every block's q, and its k into the block of
  // row pos
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int j = tid; j < nsh; j += kAThreads) {
    float rq = 0.f, rk = 0.f;
    for (int w = 0; w < P.rg; ++w) {
      rq += rp[w * P.share + j];
      rk += rp[(P.rg + w) * P.share + j];
    }
    const int d = j0 + j;
    rq = qkb[d] * csb[j] + rq * csb[P.share + j];
    rk = qkb[D + d] * csb[j] + rk * csb[P.share + j];
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(qr, r)[d] = rq;
    cluster.map_shared_rank(kr, owner)[d] = rk;
  }
  cluster.sync();  // 1: q and k are in place
  for (int i = tid; i < D; i += kAThreads) att_blk[i] = 0.f;
  if (mine)
    for (int d = tid; d < D; d += kAThreads)
      ck[(size_t)pos * D + d] = from_f<T>(kr[d]);

  // the scores of the block's rows, chunk by chunk, into sbuf (row - rlo)
  const int ntl = P.hp / 8, ksn = kAWarps / P.mtc;
  const int mtw = warp % P.mtc, ksw = warp / P.mtc;
  for (int rc = 0; rc < nrc; ++rc) {
    const int rb = rlo + rc * RC, rcnt = min(RC, rhi - rb);
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int fc = 0; fc < nfc; ++fc) {
      const int f0 = fc * P.fc;
      if (rc > 0 || fc > 0) {
        stage_cache(kbuf, ck, rb, rcnt, f0);
        if (nfc > 1) stage_hmask(f0);  // hmask rows of the chunk
        cp_async_commit();
        if (nfc > 1) {
          cp_async_wait<0>();
          __syncthreads();
        }
      }
      if (rc == 0 || nfc > 1)  // qM^T of the chunk's features
        for (int hh = warp; hh < P.hp; hh += kAWarps)
          for (int f = lane; f < P.fc; f += 32) {
            const int d = f0 + f;
            const float v = d < D && hh < H ? qr[d] * hmb[f * H + hh] : 0.f;
            reinterpret_cast<T*>(qm + hh * ks)[f] = from_f<T>(v);
          }
      wait_cache();
      if (mine && pos < rb + rcnt && pos >= rb) {  // row pos: k as rotated
        T* row = reinterpret_cast<T*>(kbuf + (pos - rb) * ks);
        for (int f = tid; f < P.fc; f += kAThreads)
          row[f] = from_f<T>(f0 + f < D ? kr[f0 + f] : 0.f);
        __syncthreads();
      }
      if (16 * mtw < rcnt)
        scores_tile<T>(acc, kbuf + 16 * mtw * ks, qm, ks, ntl, ksw, ksn,
                       P.fc / KG);
      __syncthreads();
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      if (nt < ntl)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((warp * ntl + nt) * 4 + e) * 32 + lane] = acc[nt][e];
    __syncthreads();
    // element (r, hh) of the tiles: lane 4 (r & 7) + (hh & 7) / 2, entry
    // 2 ((r >> 3) & 1) + (hh & 1) of n8 tile hh / 8 of tile r / 16
#pragma unroll 2
    for (int i = tid; i < rcnt * P.hp; i += kAThreads) {
      const int r = i / P.hp, hh = i - r * P.hp;
      const int ln = 4 * (r & 7) + ((hh & 7) >> 1);
      const int e = 2 * ((r >> 3) & 1) + (hh & 1), nt = hh >> 3;
      float s = 0.f;
      for (int k = 0; k < ksn; ++k)
        s += red[((((r >> 4) + k * P.mtc) * ntl + nt) * 4 + e) * 32 + ln];
      sbuf[(rb - rlo + r) * P.hp + hh] = hh < H ? s * scale : -INFINITY;
    }
    __syncthreads();
  }

  // the softmax's global max and sum per head: each block's (max, sum of
  // exp(s - max)) into every block, then every block merges them, a warp a
  // head and a lane a block, by the same shuffle tree (the same bits in
  // every block)
  for (int hh = warp; hh < H; hh += kAWarps) {
    float m = -INFINITY;
    for (int r = lane; r < nrows; r += 32) m = fmaxf(m, sbuf[r * P.hp + hh]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < nrows; r += 32) l += expf(sbuf[r * P.hp + hh] - m);
    l = warp_sum(l);
    if (lane < C) {  // slot `rank` of block `lane`
      float* o = cluster.map_shared_rank(st, lane) + 2 * rank * P.hp;
      o[hh] = m;
      o[P.hp + hh] = l;
    }
  }
  cluster.sync();  // 2: every block's max and sum are in place
  for (int hh = warp; hh < H; hh += kAWarps) {  // lane r: block r's slot
    const float mr = lane < C ? st[2 * lane * P.hp + hh] : -INFINITY;
    const float M = warp_max(mr);
    const float L = warp_sum(mr != -INFINITY
                                 ? st[(2 * lane + 1) * P.hp + hh] *
                                       expf(mr - M)
                                 : 0.f);
    if (lane == 0) {
      ml[hh] = M;
      ml[P.hp + hh] = L;
    }
  }
  __syncthreads();

  // att of the block's rows: p = T(exp(s - M) / L) made once a chunk into
  // pb (rows x heads). For each 16-feature tile and 8-row tile, C =
  // T(hmask)[features] @ p[rows]^T on the tensor cores (the heads the k
  // dimension, padded to 16 or 8): p_exp transposed, times V elementwise
  // and summed over its 8 rows (in each lane, then over a quad's lanes);
  // then each feature's tiles are added in row order into att_blk
  const int nks = sizeof(T) == 2 ? P.hk / 16 : P.hk / 8;
  for (int fc = 0; fc < nfc; ++fc) {
    const int f0 = fc * P.fc, nf = min(P.fc, D - f0);
    if (nfc > 1) {  // hmask rows of the chunk
      __syncthreads();
      stage_hmask(f0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    for (int rc = 0; rc < nrc; ++rc) {
      const int rb = rlo + rc * RC, rcnt = min(RC, rhi - rb);
      const unsigned char* vb = vbuf;
      if (!one) {
        __syncthreads();
        stage_cache(kbuf, cv, rb, rcnt, f0);
        cp_async_commit();
        vb = kbuf;
      }
#pragma unroll 4
      for (int i = tid; i < RC * P.hk; i += kAThreads) {
        const int r = i / P.hk, hh = i - r * P.hk;
        const float p =
            r < rcnt && hh < H
                ? round_to<T>(expf(sbuf[(rb - rlo + r) * P.hp + hh] -
                                   ml[hh]) / ml[P.hp + hh])
                : 0.f;
        reinterpret_cast<T*>(pb + r * P.pstride)[hh] = from_f<T>(p);
      }
      wait_cache();  // V (staged at the start when one chunk holds it)
      // items (feature tile mt, row tile nt), mt-major, a run of them a
      // warp; each item's 16 sums to pvp, then per feature in row order
      const int nnt = (rcnt + 7) / 8, items = ((nf + 15) / 16) * nnt;
      const int per = (items + kAWarps - 1) / kAWarps;
      int amt = -1;  // the feature tile whose k-step-0 A fragment is held
      unsigned ah[4], al[4];
#pragma unroll 1
      for (int it = warp * per; it < min(items, (warp + 1) * per); ++it) {
        const int mt = it / nnt, nt = it - mt * nnt;
        const int dA = 16 * mt + g;  // the lane's features dA, dA + 8
        // T(hmask) at (feature, head), zero past D and H
        auto hm = [&](int d, int hh) {
          return d < nf && hh < H ? round_to<T>(hmb[d * H + hh]) : 0.f;
        };
        // the A fragment of k step k: T(hmask) at features dA (+8)
        auto a_frag = [&](int k, unsigned (&xh)[4], unsigned (&xl)[4]) {
          if constexpr (sizeof(T) == 2) {
            const int h0 = 16 * k + 2 * q;
            xh[0] = pack_bf16(hm(dA, h0), hm(dA, h0 + 1));
            xh[1] = pack_bf16(hm(dA + 8, h0), hm(dA + 8, h0 + 1));
            xh[2] = pack_bf16(hm(dA, h0 + 8), hm(dA, h0 + 9));
            xh[3] = pack_bf16(hm(dA + 8, h0 + 8), hm(dA + 8, h0 + 9));
          } else {
            const int h0 = 8 * k + q;
            split<true>({hm(dA, h0), hm(dA + 8, h0), hm(dA, h0 + 4),
                         hm(dA + 8, h0 + 4)}, xh, xl);
          }
        };
        if (mt != amt) {
          a_frag(0, ah, al);
          amt = mt;
        }
        const unsigned* pr = pb + (8 * nt + g) * P.pstride;  // B's row
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int k = 0; k < nks; ++k) {
          unsigned xh[4], xl[4];
          if (k == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) xh[e] = ah[e], xl[e] = al[e];
          } else {
            a_frag(k, xh, xl);
          }
          if constexpr (sizeof(T) == 2) {
            mma_bf16(c, xh, pr[8 * k + q], pr[8 * k + 4 + q]);
          } else {
            const float* fr = reinterpret_cast<const float*>(pr);
            unsigned bh[2], bl[2];
            split<true>({fr[8 * k + q], fr[8 * k + q + 4]}, bh, bl);
            float small[4] = {0.f, 0.f, 0.f, 0.f},
                  big[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(small, xl, bh);
            mma_tf32(small, xh, bl);
            mma_tf32(big, xh, bh);
#pragma unroll
            for (int e = 0; e < 4; ++e) c[e] += big[e] + small[e];
          }
        }
        // c: (feature dA, rows 2q, 2q + 1), (feature dA + 8, the same)
        auto v_at = [&](int r, int d) {
          return r < rcnt && d < nf
                     ? to_f(reinterpret_cast<const T*>(vb + r * ks)[d])
                     : 0.f;
        };
        const int r = 8 * nt + 2 * q;
        float acc0 = c[0] * v_at(r, dA) + c[1] * v_at(r + 1, dA);
        float acc1 = c[2] * v_at(r, dA + 8) + c[3] * v_at(r + 1, dA + 8);
        for (int o = 1; o < 4; o <<= 1) {
          acc0 += __shfl_xor_sync(0xffffffffu, acc0, o);
          acc1 += __shfl_xor_sync(0xffffffffu, acc1, o);
        }
        if (q == 0) {
          pvp[it * 16 + g] = acc0;
          pvp[it * 16 + g + 8] = acc1;
        }
      }
      __syncthreads();
      for (int d = tid; d < nf; d += kAThreads) {
        const float* x = pvp + (d >> 4) * nnt * 16 + (d & 15);
        float sum = 0.f;
        for (int nt = 0; nt < nnt; ++nt) sum += x[nt * 16];
        att_blk[f0 + d] += sum;
      }
    }
  }
  __syncthreads();

  // each column's sums from every block into its owner's slots, then the
  // owners add them in rank order
  for (int r = warp; r < C; r += kAWarps)
    for (int j = lane; j < P.share && r * P.share + j < D; j += 32)
      cluster.map_shared_rank(slot, r)[rank * P.share + j] =
          att_blk[r * P.share + j];
  cluster.sync();  // 3: every slot is in place
  for (int j = tid; j < nsh; j += kAThreads) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += slot[r * P.share + j];
    att_out[j0 + j] = s;
  }
}

// 6. h_out = RMSNorm(h) * final_norm in f32, one block
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_final_norm_kernel(const float* __restrict__ h,
                       const T* __restrict__ final_norm,
                       float* __restrict__ h_out, int D) {
  __shared__ float red[kWarps];
  pdl_wait();
  pdl_launch();
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) ss += h[i] * h[i];
  ss = block_sum(ss, red);
  const float den = sqrtf(ss / (float)D + 1e-6f);
  for (int i = threadIdx.x; i < D; i += kThreads)
    h_out[i] = h[i] / den * to_f(final_norm[i]);
}

struct StepArgs {
  const int* pos;
  const float *h0, *cos, *sin, *rot, *hmask;
  const void *final_norm, *wq, *wk, *wv, *wo, *gate_w, *up_w, *down_w;
  const void *in_norm, *post_norm;
  void *ck, *cv;
  float *h_out, *scratch;
  int N, D, H, F, S;
  float scale;
};

// The attention stage's plan for these widths on this device: the largest
// cluster of at most kAttnCluster blocks (and of at most one block a
// 16-row tile of the cache) that fits and that the device can place,
// asked once a device and shape of each instance. The opt-ins it needs
// are set on the way.
template <typename T>
cudaError_t attention_plan(int D, int H, int S, AttnPlan& out) {
  static struct {
    int D, H, S;
    AttnPlan p;
  } done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && done[dev].D == D && done[dev].H == H && done[dev].S == S) {
    out = done[dev].p;
    return cudaSuccess;
  }
  auto* kern = step_attention_kernel<T>;
  const void* kp = reinterpret_cast<const void*>(kern);
  int cs = 1;  // a block a 16-row tile, and shares of at most 128 features
  while (cs < kAttnCluster && (cs * 16 < S || (D + cs - 1) / cs > 128))
    cs *= 2;
  e = cudaFuncSetAttribute(kp, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  if (e != cudaSuccess) return e;
  for (;; cs /= 2) {
    const AttnPlan p = attn_plan<T>(D, H, S, cs);
    if (p.smem >= 0) {
      e = cudaFuncSetAttribute(kp, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
      if (e != cudaSuccess) return e;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cs);
      cfg.blockDim = dim3(kAThreads);
      cfg.dynamicSmemBytes = p.smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cs;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters >= 1) {
        out = p;
        break;
      }
    }
    if (cs == 1) return cudaErrorInvalidConfiguration;
  }
  if (dev < 64) {
    done[dev].D = D;
    done[dev].H = H;
    done[dev].S = S;
    done[dev].p = out;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t run_step(const StepArgs& a, cudaStream_t st) {
  const int D = a.D, F = a.F, S = a.S, H = a.H;
  float* h = a.scratch;        // D
  float* qk = h + D;           // 2 D
  float* att = qk + 2 * D;     // D
  float* ff = att + D;         // F
  float* sb = ff + F;          // S x hp
  const T* in_norm = static_cast<const T*>(a.in_norm);
  const T* post_norm = static_cast<const T*>(a.post_norm);
  const T* wq = static_cast<const T*>(a.wq);
  const T* wk = static_cast<const T*>(a.wk);
  const T* wv = static_cast<const T*>(a.wv);
  const T* wo = static_cast<const T*>(a.wo);
  const T* gate_w = static_cast<const T*>(a.gate_w);
  const T* up_w = static_cast<const T*>(a.up_w);
  const T* down_w = static_cast<const T*>(a.down_w);
  T* ck = static_cast<T*>(a.ck);
  T* cv = static_cast<T*>(a.cv);
  const size_t LDD = (size_t)D * D, LFD = (size_t)F * D, LSD = (size_t)S * D;

  AttnPlan P;
  PDT_TRY(attention_plan<T>(D, H, S, P));
  const uintptr_t caches = reinterpret_cast<uintptr_t>(a.ck) |
                           reinterpret_cast<uintptr_t>(a.cv);
  P.bulk = D * sizeof(T) % 16 == 0 && caches % 16 == 0;
  P.rot16 = D % 4 == 0 && reinterpret_cast<uintptr_t>(a.rot) % 16 == 0;
  auto tiles = [](int rows) { return (rows + kLayerRows - 1) / kLayerRows; };
  const size_t sm_qkv = norm_smem<kFmtFloat, T>(D, 1, 1);
  const size_t sm_d = layer_smem<kFmtFloat, T>(D, 1, 1);
  const size_t sm_gu = norm_smem<kFmtFloat, T>(D, 1, 2);
  const size_t sm_f = layer_smem<kFmtFloat, T>(F, 1, 1);
  if (sm_gu > kMaxSmem || sm_f > kMaxSmem) return cudaErrorInvalidValue;
  PDT_TRY(allow_smem(step_qkv_kernel<T>, sm_qkv));
  PDT_TRY(allow_smem(layer_wo_kernel<T, kFmtFloat, 1, true>, sm_d));
  PDT_TRY(allow_smem(layer_gate_up_kernel<T, kFmtFloat, 1, true>, sm_gu));
  PDT_TRY(allow_smem(layer_down_kernel<T, kFmtFloat, 1, true>, sm_f));
  for (int l = 0; l < a.N; ++l) {
    T* ckl = ck + l * LSD;
    T* cvl = cv + l * LSD;
    PDT_TRY(chain_launch(step_qkv_kernel<T>, dim3(3 * tiles(D)), kThreads,
                         sm_qkv, st, 0, a.pos, a.h0, l == 0, h,
                         in_norm + (size_t)l * D, wq + l * LDD, wk + l * LDD,
                         wv + l * LDD, qk, cvl, D, S));
    PDT_TRY(chain_launch(step_attention_kernel<T>, dim3(P.cs), kAThreads,
                         P.smem, st, P.cs, a.pos, qk, a.cos, a.sin, a.rot,
                         a.hmask, ckl, cvl, sb, att, D, H, S, a.scale, P));
    PDT_TRY(chain_launch(layer_wo_kernel<T, kFmtFloat, 1, true>,
                         dim3(tiles(D), 1), kThreads, sm_d, st, 0, att,
                         wo + l * LDD, nullptr, h, 1, D));
    PDT_TRY(chain_launch(layer_gate_up_kernel<T, kFmtFloat, 1, true>,
                         dim3(tiles(F), 1), kThreads, sm_gu, st, 0, h,
                         post_norm + (size_t)l * D, gate_w + l * LFD,
                         up_w + l * LFD, nullptr, nullptr, ff, 1, D, F));
    PDT_TRY(chain_launch(layer_down_kernel<T, kFmtFloat, 1, true>,
                         dim3(tiles(D), 1), kThreads, sm_f, st, 0, ff, F,
                         down_w + l * LFD, nullptr, h, 1, D));
  }
  PDT_TRY(chain_launch(step_final_norm_kernel<T>, dim3(1), kThreads, 0, st,
                       0, h, static_cast<const T*>(a.final_norm), a.h_out,
                       D));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch for one step: h (D), raw q and k (2 D), att (D), ff
// (F), and the scores of S rows for heads padded to 8, used where they do
// not fit in the attention stage's shared memory. ops/decode_step.py's
// step_scratch_floats mirrors it.
int pdt_decode_step_scratch_floats(int dim, int n_heads, int ffn, int seq) {
  return 4 * dim + ffn + seq * ((n_heads + 7) / 8 * 8);
}

// K10. wdtype 0: float32 weights, norms and caches, 1: bfloat16; h0, cos,
// sin (D,), rot (D, D), hmask (D, H) and h_out (D,) are float32. The caches
// are updated in place at row min(pos, S - 1). Returns the CUDA error of
// the first launch that failed, or cudaSuccess.
int pdt_decode_step(int wdtype, const void* pos, const void* h0,
                    const void* cos, const void* sin, const void* rot,
                    const void* hmask, const void* final_norm, const void* wq,
                    const void* wk, const void* wv, const void* wo,
                    const void* gate_w, const void* up_w, const void* down_w,
                    const void* in_norm, const void* post_norm, void* ck,
                    void* cv, void* h_out, void* scratch, int n_layers,
                    int dim, int n_heads, int ffn, int seq, float scale,
                    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  StepArgs a{static_cast<const int*>(pos),
             f(h0), f(cos), f(sin), f(rot), f(hmask),
             final_norm, wq, wk, wv, wo, gate_w, up_w, down_w,
             in_norm, post_norm, ck, cv,
             static_cast<float*>(h_out), static_cast<float*>(scratch),
             n_layers, dim, n_heads, ffn, seq, scale};
  if (n_heads < 1 || n_heads > kMaxHeads || n_heads > dim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wdtype == 0) return run_step<float>(a, st);
  if (wdtype == 1) return run_step<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
