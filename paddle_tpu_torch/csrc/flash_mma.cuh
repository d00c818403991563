// Flash attention on Hopper's tensor cores (sm_90a): the forward, dQ and
// dK/dV with mma.sync (m16n8k16, bf16 operands, fp32 accumulators), fed by
// ldmatrix from bf16 tiles that cp.async stages in shared memory.
// Included by flash_kernels.cuh after its shared helpers (Args, RowMap,
// row_at, masked, segment_range, load_seg), whose contract these bodies
// keep, on the same template axes <T, D, BK, kMask, kBhsd>. This version
// builds and launches, for bf16 at D <= 128: the forward without a mask
// or with the factored k_valid mask (kMaskValid) in bshd (K1,
// flash_attention.cu) and in bhsd (K6-fwd, flash_bhsd.cu); the forward
// under a dense mask (kMaskDense) in bshd (K1-dense, a head-broadcast
// [b|1, 1, s, s] mask, flash_attention.cu) and in bhsd (K6-fwd-dense, a
// [b|1, h|1, s, s] mask, flash_bhsd.cu); the backward in bshd (K2,
// flash_attention.cu), in bhsd (K6-dQ, K6-dKV, flash_bhsd.cu) and under
// packed segment ids (kMaskSeg: K5-dQ, K5-dKV, flash_segment.cu).
// `mma_forward` and `mma_backward` in flash_kernels.cuh are that choice.
// K5's forward keeps the CUDA-core body: the forward's kSeg instance is
// written but neither built nor checked.
//
// Replaces (paddle_tpu/ops/pallas_attention.py):
//   K1     _flash_fwd_bshd's pallas_call (line 616, kernel
//          _fwd_kernel_bshd), and K1-dense, the same call with a dense
//          [b|1, 1, s, s] mask (lines 606-614);
//   K2-dQ  _flash_bwd_bshd's first pallas_call (line 959, kernel
//          _bwd_dq_kernel_bshd);
//   K2-dKV its second pallas_call (line 977, _bwd_dkv_kernel_bshd);
//   K5-dQ  _flash_bwd_segment's first pallas_call (line 1258, kernel
//          _seg_bwd_dq_kernel);
//   K5-dKV its second pallas_call (line 1289, _seg_bwd_dkv_kernel);
//   K6-fwd _flash_fwd_dispatch's pallas_call (line 430, kernel
//          _fwd_kernel, line 243), and K6-fwd-dense, the same call with a
//          dense [b|1, h|1, s, s] mask (lines 412-428);
//   K6-dQ  _flash_bwd_dispatch's first pallas_call (line 781, kernel
//          _bwd_dq_kernel);
//   K6-dKV its second pallas_call (line 798, _bwd_dkv_kernel).
//
// What bounds them: at the training step (b16 s1024 h8 d64 bf16 causal)
// the bytes bound the forward (0.021 ms) and dQ (0.026 ms) and the
// products dK/dV (0.035 ms) at the card's peaks, but mma.sync reaches only
// part of the tensor cores' rate (wgmma reaches the rest), and the bshd
// bodies issue more products than the function needs: each product with P
// or dS as its A operand runs twice, on a hi and a lo bf16 half (1.5x the
// tensor work in the forward and dK/dV, 1.33x in dQ). K5's backward at
// the packed step (the same shape, 36.6% of the causal pairs visible)
// walks only the key (dK/dV: query) tiles of the segment window; its
// bytes bound it (0.027 ms dQ, 0.032 ms dK/dV). The per-head kernels (K6)
// take S (and dP) in fp64 (below), so the FP64 tensor cores' 67 TFLOP/s
// bound them: ~17 GFLOP of them per backward kernel at the step (>= 0.26
// ms each) and ~9.1 GFLOP in the causal forward (>= 0.14 ms). The
// dense-mask forwards (the prefix-LM step: b16 s1024 h8 d64, not causal)
// visit all 256 key tiles of a (batch, head) rather than the causal 136
// and read one mask byte per score from a staged tile; their bytes bound
// them at 0.026 ms, and K6-fwd-dense's ~17.2 GFLOP of fp64 S at >= 0.26
// ms. The exponentials and masks run on the CUDA cores between the
// products.
//
// Design:
// - 4 warps; each owns 16 rows of a 64-row tile: query rows for the
//   forward and dQ (the rows of RowMap, which may gather several heads of
//   a group), keys for dK/dV. Grids, RowMap, the causal window, the
//   factored k_valid mask and the zero-cotangent rule are the CUDA-core
//   bodies'.
// - Forward: S = Q.K^T per 64-key tile (A from the Q tile, B from the K
//   tile, ldmatrix), the online softmax on the accumulator fragments (a
//   thread holds two rows, gid and gid + 8; a row's max reduces over its
//   quad of lanes), the running max taken over the whole tile, O's
//   accumulators rescaled by exp(m_old - m_new), then O += P.V with P's
//   accumulator fragments as the A operand in registers and V read by
//   ldmatrix.trans. The row sum l takes the unrounded fp32 P and reduces
//   over the quad once, at the end. Past the key window the loop goes on
//   only while a row of the block has seen no visible key (the CUDA-core
//   forward's uniform-average rule), one tile at a time. Under a dense
//   mask the block's [64 rows x 64 keys] byte tile rides in the copy
//   ring beside K and V, and each score reads its byte from shared
//   memory; every key tile is visited when the call is not causal. A
//   block's rows are (head of the group, position) pairs (RowMap) and a
//   per-head bhsd mask may give each its own row (64 heads of one
//   position under the 71-head group), so the tile holds one mask row
//   per block row, 64 rows of 80 bytes, in both layouts (the bshd mask
//   is head-broadcast: the heads of one position stage the same bytes).
// - dQ: S = Q.K^T and dP = dO.V^T per key tile (A from Q/dO tiles, B from
//   the K/V tile, ldmatrix), P = exp(S * scale - Lse) and dS = P (dP - D)
//   on the accumulator fragments, then dQ += dS.K with dS's accumulator
//   fragments reused as the A operand in registers (FlashAttention-2's
//   mapping: two m16n8 fragments are one m16k16 A fragment) and K read
//   by ldmatrix.trans. Neither P nor dS touches shared memory.
// - dK/dV: the transposed orientation, keys as rows: S^T = K.Q^T and
//   dP^T = V.dO^T per query tile, Lse and Delta read per query column
//   from shared memory, then dV += P^T.dO and dK += dS^T.Q with P^T and
//   dS^T as register A operands, dO and Q read by ldmatrix.trans. The
//   group's query heads and the query tiles are one flattened loop, the
//   GQA sum stays in registers (no atomics), one bf16 store per output.
// - Rounding: Q.K^T and dO.V^T take the bf16 inputs exactly. The TPU's
//   K1 and K2 keep P and dS in fp32 (their _dop is a no-op by default),
//   so in bshd they enter each product as hi = bf16(x) and lo = bf16(x -
//   hi): two mma, ~16 bits of mantissa, within a small fraction of a bf16
//   output ulp of fp32 operands. The per-head layout (kBhsd, K6) takes hi
//   alone, which is the rounding of its TPU kernel (P before P.V, dS
//   before dS.K, P before P^T.dO, dS before dS^T.Q); dS is computed from
//   the unrounded P. There the lo halves are never formed. Such a
//   rounding depends on the last bit of S and dP: summed in fp32 in the
//   tensor cores' order they rounded a few P and dS of the early causal
//   rows apart from the plain version's (measured on the H100), which
//   moved whole rows of dQ or dK by an ulp of P. So the per-head bodies
//   sum S (and dP) in fp64 on the FP64 tensor cores (mma.sync m16n8k8
//   f64, bf16 operands widened exactly), 16 or 32 keys or queries at a
//   time, and round each to fp32 once: the correctly rounded sum, which the
//   plain version takes too. The products after the rounding (P.V, dS.K,
//   P^T.dO, dS^T.Q) take bf16 operands exactly on the bf16 tensor cores.
//   K5 is bshd: its TPU kernels keep P and dS in fp32, so its backward
//   takes them as hi + lo from fp32 sums, as K2's does.
// - Segment ids (K5's backward): dQ walks the key tiles of the window
//   that its block's queries can see and dK/dV the query tiles that can
//   see its key tile (segment_range, two binary searches over the row's
//   non-decreasing ids), as the CUDA-core bodies do; the key ids ride in
//   the copy ring beside K and V (kseg_s), the query ids beside each
//   staged query tile in dK/dV (qseg_s), and `masked` compares them per
//   score on the accumulator fragments.
// - Staging: a two-stage ring of tiles in shared memory; the next K/V
//   tile (forward, dQ) or the next Q/dO tile with its Lse and Delta
//   (dK/dV) is in flight (cp.async, 16-byte copies per row: the rows of a
//   forward or dQ block may come from several heads, so no TMA box covers
//   them) while the current one is multiplied. Rows are padded by 16
//   bytes so ldmatrix's eight row addresses fall in distinct banks.
//   Columns past d and rows past s are zeros. Rows whose start is not
//   16-byte aligned (head_dim not a multiple of 8) are copied element by
//   element instead, into the same tiles.
// - Under the causal mask the forward and dQ grids run their query tiles
//   in reverse, so the blocks with the most key tiles start first.

#pragma once

namespace {

constexpr int kWarpRows = 16;    // rows of one warp's m16n8k16 tiles

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (m16n8, fp32) += a (m16k16, bf16) * b (k16n8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi = bf16(x), lo = bf16(x - hi); x0 in the low
// half, the lower column of an mma fragment. The per-head layout (kBhsd)
// takes hi alone: lo is never formed
template <bool kBhsd>
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  *hi = bf16x2_bits(h);
  if constexpr (!kBhsd) {
    const float2 hf = __bfloat1622float2(h);
    *lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
  }
}

// the A fragments (hi, lo) of k-slice j (columns 16j..16j+15) from the
// m16n8 accumulators c[2j], c[2j+1] of the same rows
template <bool kBhsd>
__device__ __forceinline__ void a_from_acc(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16<kBhsd>(c0[0], c0[1], &hi[0], &lo[0]);
  split_bf16<kBhsd>(c0[2], c0[3], &hi[1], &lo[1]);
  split_bf16<kBhsd>(c1[0], c1[1], &hi[2], &lo[2]);
  split_bf16<kBhsd>(c1[2], c1[3], &hi[3], &lo[3]);
}

// acc += A.B twice, once per half of A; the per-head layout takes hi
// alone (K6 rounds its operand to bf16)
template <bool kBhsd>
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          uint32_t b0, uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  if constexpr (!kBhsd) mma_bf16(c, lo, b0, b1);
}

// c (m16n8, fp64) += a (m16k8, fp64) * b (k8n8, fp64) on the FP64 tensor
// cores. Fragments: a[i] row gid + 8 (i & 1), column tig + 4 (i >> 1);
// b[i] row tig + 4 i, column gid; c as the bf16 product's (checked
// against a host product on the H100)
__device__ __forceinline__ void mma_f64(double (&c)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ double f64_at(const __nv_bfloat16* p) {
  return static_cast<double>(__bfloat162float(*p));
}

// sc = A.B^T and dp = G.W^T for the 16 rows of A and G from row r0 and
// the NT * 8 rows of B and W from row n0 (bf16 tiles of row stride SD,
// D columns), summed in fp64 on the FP64 tensor cores and rounded to
// fp32 once: the products of bf16 values are exact in fp64, so this is
// the correctly rounded fp32 of each exact sum, whatever the order. The
// per-head bodies take S and dP so, because K6 rounds P and dS to bf16:
// a rounding then depends on the last bit of S and dP, and an order of
// fp32 sums of its own would round some of them apart from the plain
// version's (which takes the same correctly rounded sums)
template <int D, int SD, int NT>
__device__ __forceinline__ void exact_products(
    float (&sc)[NT][4], float (&dp)[NT][4], const __nv_bfloat16* a_s,
    const __nv_bfloat16* g_s, int r0, const __nv_bfloat16* b_s,
    const __nv_bfloat16* w_s, int n0, int gid, int tig) {
  double s64[NT][4], d64[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s64[i][e] = d64[i][e] = 0.0;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    double fa[4], fg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (r0 + gid + 8 * (i & 1)) * SD + kk + tig + 4 * (i >> 1);
      fa[i] = f64_at(a_s + off);
      fg[i] = f64_at(g_s + off);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      double fb[2], fw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off = (n0 + nt * 8 + gid) * SD + kk + tig + 4 * i;
        fb[i] = f64_at(b_s + off);
        fw[i] = f64_at(w_s + off);
      }
      mma_f64(s64[nt], fa, fb);
      mma_f64(d64[nt], fg, fw);
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[i][e] = static_cast<float>(s64[i][e]);
      dp[i][e] = static_cast<float>(d64[i][e]);
    }
}

// sc = A.B^T alone, as exact_products sums it (the per-head forward's S)
template <int D, int SD, int NT>
__device__ __forceinline__ void exact_product(float (&sc)[NT][4],
                                              const __nv_bfloat16* a_s,
                                              int r0,
                                              const __nv_bfloat16* b_s,
                                              int n0, int gid, int tig) {
  double s64[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s64[i][e] = 0.0;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    double fa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      fa[i] = f64_at(a_s + (r0 + gid + 8 * (i & 1)) * SD + kk + tig +
                     4 * (i >> 1));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      double fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        fb[i] = f64_at(b_s + (n0 + nt * 8 + gid) * SD + kk + tig + 4 * i);
      mma_f64(s64[nt], fa, fb);
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = static_cast<float>(s64[i][e]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// commit what is pending and wait for all of this thread's copies
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// columns [col, col + 8) of a bf16 row into shared memory: one cp.async
// where rows are 16-byte aligned (vec), else element loads; zeros past d
// and for a missing row (nullptr)
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* dst,
                                            const __nv_bfloat16* row,
                                            int col, int d, bool vec) {
  if (row != nullptr && col < d) {
    if (vec) {
      cp_async16(smem_u32(dst), row + col);
      return;
    }
    __align__(16) unsigned short x[8];
    const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = col + e < d ? src[col + e] : 0;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x);
    return;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// whether every input row starts on 16 bytes (cp.async's grain)
__device__ __forceinline__ bool rows_aligned(const Args& a) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a.q) |
                          reinterpret_cast<uintptr_t>(a.k) |
                          reinterpret_cast<uintptr_t>(a.v) |
                          reinterpret_cast<uintptr_t>(a.o_grad);
  return a.d % 8 == 0 && bases % 16 == 0;
}

// one bf16 output pair (columns col, col + 1 of a row at `p`), past d cut
__device__ __forceinline__ void store_pair(float x0, float x1,
                                           __nv_bfloat16* p, int col, int d) {
  if (col + 1 < d && (d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < d) p[col] = __float2bfloat16(x0);
    if (col + 1 < d) p[col + 1] = __float2bfloat16(x1);
  }
}

// reduce over the quad of lanes (lane & 3) that holds one row of an
// m16n8 accumulator fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// key tile t of K and V (and its segment ids) into ring stage st of a
// forward or dQ block, one copy group: the stage holds the K tile then
// the V tile, BK rows of SD bf16 each; keys past s and columns past d
// are zeros
template <int D, int BK, int SD, bool kSeg, bool kBhsd>
__device__ __forceinline__ void stage_kv_tile(__nv_bfloat16* kv_s,
                                              int* kseg_s, const Args& a,
                                              int bi, int kvh, int t, int st,
                                              bool vec) {
  constexpr int CH = D / 8;
  const int k0 = t * BK;
  __nv_bfloat16* ks = kv_s + st * 2 * BK * SD;
  __nv_bfloat16* vs = ks + BK * SD;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v);
  const size_t base = row_at<kBhsd>(bi, k0, kvh, a.s, a.hkv) * a.d;
  const int step = (kBhsd ? 1 : a.hkv) * a.d;
  const int n = min(BK, a.s - k0);
  for (int idx = threadIdx.x; idx < BK * CH; idx += kThreads) {
    const int r = idx / CH, col = (idx % CH) * 8;
    const bool in = r < n;
    stage_chunk(ks + r * SD + col, in ? kp + base + r * step : nullptr, col,
                a.d, vec);
    stage_chunk(vs + r * SD + col, in ? vp + base + r * step : nullptr, col,
                a.d, vec);
  }
  load_seg<kSeg>(kseg_s + st * BK, BK, a.kv_seg, a, bi, k0);
  cp_async_commit();
}

// bytes per staged dense-mask row: 64 keys and a pad, so that the eight
// rows of an m16n8 fragment read from distinct banks (a multiple of 16
// for cp.async)
constexpr int kMaskStride = 80;

// the mask rows of the two 16-byte items of the dense mask's [kRows][BK]
// tile that this thread stages in every key tile (item j: idx = tid + j *
// kThreads, block row idx / (BK / 16)), as row numbers of the [mask_b *
// mask_h * s, s] mask; ~0u for invalid rows. Block row i reads the mask
// row of (head kvh * g + rm.gi(i), position rm.pos(i)): a per-head bhsd
// mask gives each head of a folded query group rows of its own; the bshd
// mask is head-broadcast, so there the heads of one position stage the
// same bytes. Found once a block: found per key tile, with integer
// divisions by g's row count and mask_h, they slowed the copy loop
// (K6-fwd-dense 0.605 ms against 0.665; K1-dense, whose rows were found
// per tile by position, 0.383 against 0.408; in turns at the prefix-LM
// step, H100 80GB HBM3, 700 W)
template <int BK>
__device__ __forceinline__ void mask_items(unsigned row[2], const Args& a,
                                           int bi, int kvh,
                                           const RowMap& rm) {
  constexpr int CH = BK / 16;
  static_assert(kRows * CH == 2 * kThreads, "two 16-byte items a thread");
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = (threadIdx.x + j * kThreads) / CH;
    const int hd = kvh * rm.g + rm.gi(i);
    row[j] = rm.valid(i, a.s)
                 ? ((unsigned)(bi % a.mask_b) * a.mask_h + hd % a.mask_h) *
                           a.s + rm.pos(i)
                 : ~0u;
  }
}

// the dense mask's bytes of the key tile from k0 into one ring stage m_s
// [kRows][kMaskStride], in the caller's copy group, from the rows of
// mask_items — 16-byte copies where the rows are aligned (vec), byte
// loads otherwise; keys past s and invalid rows are zeros
template <int BK>
__device__ __forceinline__ void stage_mask_tile(unsigned char* m_s,
                                                const unsigned row[2],
                                                const Args& a, int k0,
                                                bool vec) {
  constexpr int CH = BK / 16;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int idx = threadIdx.x + j * kThreads, c = (idx % CH) * 16;
    unsigned char* dst = m_s + (idx / CH) * kMaskStride + c;
    if (row[j] != ~0u && k0 + c < a.s) {
      const unsigned char* src = a.dense + (size_t)row[j] * a.s + k0 + c;
      if (vec) {
        cp_async16(smem_u32(dst), src);
        continue;
      }
      __align__(16) unsigned char x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = k0 + c + e < a.s ? src[e] : 0;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(x);
      continue;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

template <int D, int BK, bool kDense>
struct FwdMmaSmem {
  static constexpr int kStride = D + 8;            // bf16 per row
  static constexpr int kTile = kRows * kStride;    // bf16 per tile
  static constexpr int kMaskStage = kRows * kMaskStride;   // bytes
  static constexpr size_t bytes = sizeof(__nv_bfloat16) * 5 * kTile +
                                  sizeof(int) * 2 * BK +
                                  (kDense ? 2 * kMaskStage : 0);
};

// ----------------------------------------------------------------- fwd
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(Args a) {
  static_assert(std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core bodies take bf16");
  static_assert(BK == kRows && D % 16 == 0 && D <= 128,
                "64-wide tiles, head_dim bins of 16 up to 128");
  constexpr bool kSeg = kMask == kMaskSeg;
  constexpr bool kDense = kMask == kMaskDense;
  using S = FwdMmaSmem<D, BK, kDense>;
  constexpr int SD = S::kStride;
  constexpr int CH = D / 8;               // 16-byte chunks per row
  constexpr int NT = BK / 8;              // m16n8 score tiles of a key tile
  // keys per fp64 S chunk (kBhsd): 32 builds without a spill at every D
  // (16 spilled at D = 32) and reloads Q's fragments half as often as 16
  // (K6-fwd 0.395-0.398 ms against 0.418 at the training step, H100
  // 80GB HBM3, 700 W)
  constexpr int KC = 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* kv_s = q_s + S::kTile;               // stage st: K, then V
  int* kseg_s = reinterpret_cast<int*>(kv_s + 4 * S::kTile);   // [2][BK]
  // stage st: the dense mask's [kRows][kMaskStride] bytes (kDense)
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(kseg_s + 2 * BK);

  const int g = a.h / a.hkv;
  const int bx = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const RowMap rm(g, bx);
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* q = static_cast<const T*>(a.q);
  const bool vec = rows_aligned(a);

  // the block's Q rows, in the first copy group
  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, col = (idx % CH) * 8;
    const T* qrow = nullptr;
    if (rm.valid(r, a.s))
      qrow = q + row_at<kBhsd>(bi, rm.pos(r), kvh * g + rm.gi(r), a.s,
                               a.h) * a.d;
    stage_chunk(q_s + r * SD + col, qrow, col, a.d, vec);
  }

  // this thread's rows: warp * 16 + gid and 8 below it; l is this
  // thread's share of the row sum until the end; mrow the offset of the
  // row's staged mask bytes in a stage (kDense: by block row, as
  // stage_mask_tile stages them)
  int qpos[2], qseg[2], mrow[2];
  bool rv[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * kWarpRows + gid + 8 * hh;
    rv[hh] = rm.valid(r, a.s);
    qpos[hh] = rm.pos(r);
    qseg[hh] = kSeg && rv[hh] ? a.q_seg[(size_t)bi * a.s + qpos[hh]] : 0;
    mrow[hh] = r * kMaskStride;
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  const bool mask_vec = kDense && a.s % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(a.dense) % 16 == 0;
  unsigned mrows[2] = {~0u, ~0u};
  if constexpr (kDense) mask_items<BK>(mrows, a, bi, kvh, rm);
  const int qmax = min(rm.q0 + rm.qrows, a.s) - 1;
  int klo, khi;
  segment_range<kSeg>(a.q_seg, a.kv_seg, a, bi, rm.q0, qmax, &klo, &khi);
  if (a.causal) khi = min(khi, qmax);
  const int n_tiles = (a.s + BK - 1) / BK;
  const int t_lo = klo / BK;
  const int n_win = khi >= klo ? khi / BK - t_lo + 1 : 0;
  // the key tile of step `it`: the window first, then the tiles before
  // it, then those after it
  auto tile_at = [&](int it) {
    if (it < n_win) return t_lo + it;
    const int o = it - n_win;
    return o < t_lo ? o : o + n_win;
  };

  // key tile t (and its mask bytes) into stage st, one copy group
  auto stage_tile = [&](int t, int st) {
    if constexpr (kDense)
      stage_mask_tile<BK>(mask_s + st * S::kMaskStage, mrows, a, t * BK,
                          mask_vec);
    stage_kv_tile<D, BK, SD, kSeg, kBhsd>(kv_s, kseg_s, a, bi, kvh, t, st,
                                          vec);
  };

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  if (n_win > 0) stage_tile(t_lo, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int t = tile_at(it);
    if (it >= n_win) {
      // outside the window: go on only for rows with no visible key yet,
      // one tile at a time (no copy ahead)
      int need = 0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) need |= (rv[hh] && m[hh] <= kNegInf);
      if (!__syncthreads_or(need)) break;
      stage_tile(t, st);
    }
    if (it + 1 < n_win) {
      stage_tile(tile_at(it + 1), st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    const T* ks = kv_s + st * 2 * S::kTile;
    const T* vs = ks + S::kTile;
    const int* kseg = kseg_s + st * BK;
    // the staged mask, indexed by key as `masked` reads a mask row
    const unsigned char* mtile = mask_s + st * S::kMaskStage - k0;

    // S = Q.K^T over the tile's keys: in fp64, KC keys at a time, for the
    // per-head layout (K6 rounds P from it)
    float sc[NT][4];
    if constexpr (kBhsd) {
#pragma unroll
      for (int kc = 0; kc < BK; kc += KC) {
        float part[KC / 8][4];
        exact_product<D, SD, KC / 8>(part, q_s, warp * kWarpRows, ks, kc,
                                     gid, tig);
#pragma unroll
        for (int i = 0; i < KC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[kc / 8 + i][e] = part[i][e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t qa[4];
        ldsm_x4(qa, smem_u32(q_s + (warp * kWarpRows + (lane & 15)) * SD +
                             kk + (lane >> 4) * 8));
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t kb[4];
          const int key = nt * 8 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk + ((lane >> 3) & 1) * 8;
          ldsm_x4(kb, smem_u32(ks + key * SD + col));
          mma_bf16(sc[nt], qa, kb[0], kb[1]);
          mma_bf16(sc[nt + 1], qa, kb[2], kb[3]);
        }
      }
    }

    // the online softmax on the accumulators: the running max over the
    // whole tile, P = exp(x - m_new), O and l rescaled by exp(m_old - m_new)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int kl = nt * 8 + 2 * tig + (e & 1);
        const float x = masked<kMask>(sc[nt][e] * a.scale, k0 + kl,
                                      qpos[hh], qseg[hh],
                                      kSeg ? kseg[kl] : 0,
                                      kDense ? mtile + mrow[hh] : nullptr,
                                      a, bi);
        sc[nt][e] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - m[e >> 1]);
        sc[nt][e] = p;
        l[e >> 1] += p;                 // the unrounded P
      }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e >> 1];

    // O += P.V, P from the accumulators, V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t hi[4], lo[4];
      a_from_acc<kBhsd>(sc[2 * j], sc[2 * j + 1], hi, lo);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t vb[4];
        const int key = j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = nd * 8 + (lane >> 4) * 8;
        ldsm_x4_t(vb, smem_u32(vs + key * SD + col));
        mma_split<kBhsd>(o[nd], hi, lo, vb[0], vb[1]);
        mma_split<kBhsd>(o[nd + 1], hi, lo, vb[2], vb[3]);
      }
    }
    __syncthreads();    // the stage is refilled next
  }
  cp_async_wait_all();   // the staged rows of a block with no tile

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lc = fmaxf(quad_sum(l[hh]), 1e-20f);
    if (!rv[hh]) continue;
    const int r = warp * kWarpRows + gid + 8 * hh;
    const int head = kvh * g + rm.gi(r);
    T* row = out + row_at<kBhsd>(bi, qpos[hh], head, a.s, a.h) * a.d;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store_pair(o[nd][2 * hh] / lc, o[nd][2 * hh + 1] / lc, row,
                 nd * 8 + 2 * tig, a.d);
    // the row's Lse on its 8 lanes, two from each thread of the quad
    const float lse = m[hh] + logf(lc);
    *reinterpret_cast<float2*>(
        a.lse_out + (((size_t)bi * a.h + head) * a.s + qpos[hh]) * kLanes +
        2 * tig) = make_float2(lse, lse);
  }
}

template <int D, int BK>
struct DqMmaSmem {
  static constexpr int kStride = D + 8;            // bf16 per row
  static constexpr int kTile = kRows * kStride;    // bf16 per tile
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * 6 * kTile + sizeof(int) * 2 * BK;
};

// ------------------------------------------------------------------ dQ
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(Args a) {
  static_assert(std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core bodies take bf16");
  static_assert(BK == kRows && D % 16 == 0 && D <= 128,
                "64-wide tiles, head_dim bins of 16 up to 128");
  static_assert(kMask != kMaskDense, "a dense mask's backward recomputes");
  constexpr bool kSeg = kMask == kMaskSeg;
  using S = DqMmaSmem<D, BK>;
  constexpr int SD = S::kStride;
  // keys per S/dP chunk: narrower as the dQ accumulators grow with D;
  // 16 for the fp64 products of the per-head layout (32 at D = 64 made
  // K5-dQ slower: 0.153 against 0.144 ms at the packed step, H100 80GB
  // HBM3, 700 W)
  constexpr int KC = kBhsd ? 16 : D <= 32 ? 64 : D <= 64 ? 16 : 32;
  constexpr int CH = D / 8;               // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + S::kTile;
  T* kv_s = do_s + S::kTile;              // stage st: K, then V
  int* kseg_s = reinterpret_cast<int*>(kv_s + 4 * S::kTile);   // [2][BK]

  const int g = a.h / a.hkv;
  const int bx = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const RowMap rm(g, bx);
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.o_grad);
  const bool vec = rows_aligned(a);

  // the block's Q and dO rows, in the first copy group
  for (int idx = tid; idx < kRows * CH; idx += kThreads) {
    const int r = idx / CH, col = (idx % CH) * 8;
    const T* qrow = nullptr;
    const T* grow = nullptr;
    if (rm.valid(r, a.s)) {
      const size_t off = row_at<kBhsd>(bi, rm.pos(r), kvh * g + rm.gi(r),
                                       a.s, a.h) * a.d;
      qrow = q + off;
      grow = dout + off;
    }
    stage_chunk(q_s + r * SD + col, qrow, col, a.d, vec);
    stage_chunk(do_s + r * SD + col, grow, col, a.d, vec);
  }

  // this thread's rows: warp * 16 + gid and 8 below it
  int qpos[2], qseg[2];
  bool rv[2];
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * kWarpRows + gid + 8 * hh;
    rv[hh] = rm.valid(r, a.s);
    qpos[hh] = rm.pos(r);
    const int head = kvh * g + rm.gi(r);
    qseg[hh] = kSeg && rv[hh] ? a.q_seg[(size_t)bi * a.s + qpos[hh]] : 0;
    lse[hh] = rv[hh] ? a.lse_in[(((size_t)bi * a.h + head) * a.s +
                                 qpos[hh]) * kLanes]
                     : 0.f;
    delta[hh] = rv[hh] ? a.delta[row_at<kBhsd>(bi, qpos[hh], head, a.s, a.h)]
                       : 0.f;
  }
  const int qmax = min(rm.q0 + rm.qrows, a.s) - 1;
  int klo, khi;
  segment_range<kSeg>(a.q_seg, a.kv_seg, a, bi, rm.q0, qmax, &klo, &khi);
  if (a.causal) khi = min(khi, qmax);
  const int t_lo = klo / BK;
  const int t_end = khi >= klo ? khi / BK + 1 : 0;

  auto stage_tile = [&](int t, int st) {
    stage_kv_tile<D, BK, SD, kSeg, kBhsd>(kv_s, kseg_s, a, bi, kvh, t, st,
                                          vec);
  };

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  if (t_lo < t_end) stage_tile(t_lo, 0);
  for (int t = t_lo; t < t_end; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_end) {
      stage_tile(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    const T* ks = kv_s + st * 2 * S::kTile;
    const T* vs = ks + S::kTile;
    const int* kseg = kseg_s + st * BK;
#pragma unroll
    for (int kc = 0; kc < BK; kc += KC) {
      float sc[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
      // S = Q.K^T, dP = dO.V^T over this chunk's keys
      if constexpr (kBhsd) {
        exact_products<D, SD, KC / 8>(sc, dp, q_s, do_s, warp * kWarpRows,
                                      ks, vs, kc, gid, tig);
      } else {
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t qa[4], ga[4];
          const int arow = warp * kWarpRows + (lane & 15);
          const int acol = kk + (lane >> 4) * 8;
          ldsm_x4(qa, smem_u32(q_s + arow * SD + acol));
          ldsm_x4(ga, smem_u32(do_s + arow * SD + acol));
#pragma unroll
          for (int nt = 0; nt < KC / 8; nt += 2) {
            uint32_t kb[4], vb[4];
            const int key = kc + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
            const int col = kk + ((lane >> 3) & 1) * 8;
            ldsm_x4(kb, smem_u32(ks + key * SD + col));
            ldsm_x4(vb, smem_u32(vs + key * SD + col));
            mma_bf16(sc[nt], qa, kb[0], kb[1]);
            mma_bf16(sc[nt + 1], qa, kb[2], kb[3]);
            mma_bf16(dp[nt], ga, vb[0], vb[1]);
            mma_bf16(dp[nt + 1], ga, vb[2], vb[3]);
          }
        }
      }
      // P and dS = P (dP - Delta) in the accumulators
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int kl = kc + nt * 8 + 2 * tig + (e & 1);
          const float x = masked<kMask>(sc[nt][e] * a.scale, k0 + kl,
                                        qpos[hh], qseg[hh],
                                        kSeg ? kseg[kl] : 0, nullptr, a, bi);
          const float p = rv[hh] ? expf(x - lse[hh]) : 0.f;
          dp[nt][e] = p * (dp[nt][e] - delta[hh]);
        }
      // dQ += dS.K, dS from the accumulators, K by ldmatrix.trans
#pragma unroll
      for (int j = 0; j < KC / 16; ++j) {
        uint32_t hi[4], lo[4];
        a_from_acc<kBhsd>(dp[2 * j], dp[2 * j + 1], hi, lo);
#pragma unroll
        for (int nd = 0; nd < D / 8; nd += 2) {
          uint32_t kb[4];
          const int key = kc + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = nd * 8 + (lane >> 4) * 8;
          ldsm_x4_t(kb, smem_u32(ks + key * SD + col));
          mma_split<kBhsd>(dq[nd], hi, lo, kb[0], kb[1]);
          mma_split<kBhsd>(dq[nd + 1], hi, lo, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();    // the stage is refilled next
  }
  cp_async_wait_all();   // the staged rows of a block with no tile

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!rv[hh]) continue;
    const int r = warp * kWarpRows + gid + 8 * hh;
    const int head = kvh * g + rm.gi(r);
    T* row = out + row_at<kBhsd>(bi, qpos[hh], head, a.s, a.h) * a.d;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      store_pair(dq[nd][2 * hh] * a.scale, dq[nd][2 * hh + 1] * a.scale, row,
                 nd * 8 + 2 * tig, a.d);
  }
}

template <int D, int BK>
struct DkvMmaSmem {
  static constexpr int kStride = D + 8;
  static constexpr int kKTile = BK * kStride;
  static constexpr int kQTileElems = kQTile * kStride;
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * (2 * kKTile + 4 * kQTileElems) +
      sizeof(float) * 4 * kQTile + sizeof(int) * (BK + 2 * kQTile);
};

// --------------------------------------------------------------- dK/dV
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(Args a) {
  static_assert(std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core bodies take bf16");
  static_assert(BK == 4 * kWarpRows && D % 16 == 0 && D <= 128,
                "64-key tiles, head_dim bins of 16 up to 128");
  static_assert(kMask != kMaskDense, "a dense mask's backward recomputes");
  constexpr bool kSeg = kMask == kMaskSeg;
  using S = DkvMmaSmem<D, BK>;
  constexpr int SD = S::kStride;
  // queries per S^T/dP^T chunk: the dK/dV accumulators take D / 2
  // registers, so the chunk narrows as D grows; 16 for the fp64 products
  // of the per-head layout, and for the segment ids' body at D = 64
  // (K5-dKV 0.199 ms against 0.239 with 32 at the packed step), but not
  // for K2 there (K2-dKV 0.442-0.443 ms with 32 against 0.452-0.458 with
  // 16 at the LM step); each in turns, H100 80GB HBM3, 700 W
  constexpr int QC =
      kBhsd || D > 64 || (kSeg && D > 32) ? 16 : D <= 32 ? 64 : 32;
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + S::kKTile;
  T* qd_s = v_s + S::kKTile;              // stage st: Q, then dO
  float* lse_s = reinterpret_cast<float*>(qd_s + 4 * S::kQTileElems);
  float* delta_s = lse_s + 2 * kQTile;    // [2][kQTile] each
  int* kseg_s = reinterpret_cast<int*>(delta_s + 2 * kQTile);   // [BK]
  int* qseg_s = kseg_s + BK;                                   // [2][kQTile]

  const int g = a.h / a.hkv;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.o_grad);
  const bool vec = rows_aligned(a);

  // the block's K and V rows, in the first copy group
  {
    const size_t base = row_at<kBhsd>(bi, k0, kvh, a.s, a.hkv) * a.d;
    const int step = (kBhsd ? 1 : a.hkv) * a.d;
    const int n = min(BK, a.s - k0);
    const T* kp = static_cast<const T*>(a.k) + base;
    const T* vp = static_cast<const T*>(a.v) + base;
    for (int idx = tid; idx < BK * CH; idx += kThreads) {
      const int r = idx / CH, col = (idx % CH) * 8;
      const bool in = r < n;
      stage_chunk(k_s + r * SD + col, in ? kp + r * step : nullptr, col,
                  a.d, vec);
      stage_chunk(v_s + r * SD + col, in ? vp + r * step : nullptr, col,
                  a.d, vec);
    }
    load_seg<kSeg>(kseg_s, BK, a.kv_seg, a, bi, k0);
  }

  // the query positions that can see a key of this tile: the transposed
  // segment window, from position k0 on under a causal mask; the loop
  // runs over (head of the group, query tile) pairs
  const int kmax = min(k0 + BK, a.s) - 1;
  int qlo, qhi;
  segment_range<kSeg>(a.kv_seg, a.q_seg, a, bi, k0, kmax, &qlo, &qhi);
  if (a.causal) qlo = max(qlo, k0);
  const int n_qt = qhi >= qlo ? (qhi - qlo) / kQTile + 1 : 0;
  const int n_it = g * n_qt;

  // query tile `it` into stage st (Q, dO, Lse, Delta, ids), one group
  auto stage_tile = [&](int it, int st) {
    const int head = kvh * g + it / n_qt;
    const int q0 = qlo + (it % n_qt) * kQTile;
    T* qs = qd_s + st * 2 * S::kQTileElems;
    T* gs = qs + S::kQTileElems;
    const size_t base = row_at<kBhsd>(bi, q0, head, a.s, a.h) * a.d;
    const int step = (kBhsd ? 1 : a.h) * a.d;
    const int n = min(kQTile, a.s - q0);
    for (int idx = tid; idx < kQTile * CH; idx += kThreads) {
      const int r = idx / CH, col = (idx % CH) * 8;
      const bool in = r < n;
      stage_chunk(qs + r * SD + col, in ? q + base + r * step : nullptr, col,
                  a.d, vec);
      stage_chunk(gs + r * SD + col, in ? dout + base + r * step : nullptr,
                  col, a.d, vec);
    }
    for (int r = tid; r < kQTile; r += kThreads) {
      float* l_dst = lse_s + st * kQTile + r;
      float* d_dst = delta_s + st * kQTile + r;
      if (r < n) {
        cp_async4(smem_u32(l_dst), a.lse_in + (((size_t)bi * a.h + head) *
                                                   a.s + q0 + r) * kLanes);
        cp_async4(smem_u32(d_dst),
                  a.delta + row_at<kBhsd>(bi, q0 + r, head, a.s, a.h));
      } else {
        *l_dst = 0.f;
        *d_dst = 0.f;
      }
    }
    load_seg<kSeg>(qseg_s + st * kQTile, kQTile, a.q_seg, a, bi, q0);
    cp_async_commit();
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (n_it > 0) stage_tile(0, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {
      stage_tile(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qlo + (it % n_qt) * kQTile;
    const T* qs = qd_s + st * 2 * S::kQTileElems;
    const T* gs = qs + S::kQTileElems;
    const float* lse = lse_s + st * kQTile;
    const float* delta = delta_s + st * kQTile;
    const int* qseg = qseg_s + st * kQTile;
#pragma unroll
    for (int qc = 0; qc < kQTile; qc += QC) {
      float sc[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int i = 0; i < QC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
      // S^T = K.Q^T, dP^T = V.dO^T over this chunk's queries
      if constexpr (kBhsd) {
        exact_products<D, SD, QC / 8>(sc, dp, k_s, v_s, warp * kWarpRows,
                                      qs, gs, qc, gid, tig);
      } else {
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          uint32_t ka[4], va[4];
          const int arow = warp * kWarpRows + (lane & 15);
          const int acol = kk + (lane >> 4) * 8;
          ldsm_x4(ka, smem_u32(k_s + arow * SD + acol));
          ldsm_x4(va, smem_u32(v_s + arow * SD + acol));
#pragma unroll
          for (int nt = 0; nt < QC / 8; nt += 2) {
            uint32_t qb[4], gb[4];
            const int row = qc + nt * 8 + (lane & 7) + ((lane >> 4) << 3);
            const int col = kk + ((lane >> 3) & 1) * 8;
            ldsm_x4(qb, smem_u32(qs + row * SD + col));
            ldsm_x4(gb, smem_u32(gs + row * SD + col));
            mma_bf16(sc[nt], ka, qb[0], qb[1]);
            mma_bf16(sc[nt + 1], ka, qb[2], qb[3]);
            mma_bf16(dp[nt], va, gb[0], gb[1]);
            mma_bf16(dp[nt + 1], va, gb[2], gb[3]);
          }
        }
      }
      // P^T and dS^T = P^T (dP^T - Delta), Lse and Delta per column
#pragma unroll
      for (int nt = 0; nt < QC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = warp * kWarpRows + gid + 8 * (e >> 1);
          const int ql = qc + nt * 8 + 2 * tig + (e & 1);
          const int qpos = q0 + ql;
          float p = 0.f;
          if (qpos < a.s)
            p = expf(masked<kMask>(sc[nt][e] * a.scale, k0 + kl, qpos,
                                   kSeg ? qseg[ql] : 0,
                                   kSeg ? kseg_s[kl] : 0, nullptr, a, bi) -
                     lse[ql]);
          sc[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta[ql]);
        }
      // dV += P^T.dO and dK += dS^T.Q, dO and Q by ldmatrix.trans
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        uint32_t p_hi[4], p_lo[4], ds_hi[4], ds_lo[4];
        a_from_acc<kBhsd>(sc[2 * j], sc[2 * j + 1], p_hi, p_lo);
        a_from_acc<kBhsd>(dp[2 * j], dp[2 * j + 1], ds_hi, ds_lo);
#pragma unroll
        for (int nd = 0; nd < D / 8; nd += 2) {
          uint32_t gb[4], qb[4];
          const int row = qc + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int col = nd * 8 + (lane >> 4) * 8;
          ldsm_x4_t(gb, smem_u32(gs + row * SD + col));
          ldsm_x4_t(qb, smem_u32(qs + row * SD + col));
          mma_split<kBhsd>(dv[nd], p_hi, p_lo, gb[0], gb[1]);
          mma_split<kBhsd>(dv[nd + 1], p_hi, p_lo, gb[2], gb[3]);
          mma_split<kBhsd>(dk[nd], ds_hi, ds_lo, qb[0], qb[1]);
          mma_split<kBhsd>(dk[nd + 1], ds_hi, ds_lo, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();    // the stage is refilled next
  }
  cp_async_wait_all();   // the staged rows of a block with no tile

  T* dk_out = static_cast<T*>(a.out);
  T* dv_out = static_cast<T*>(a.out2);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + warp * kWarpRows + gid + 8 * hh;
    if (key >= a.s) continue;
    const size_t base = row_at<kBhsd>(bi, key, kvh, a.s, a.hkv) * a.d;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * tig;
      store_pair(dk[nd][2 * hh] * a.scale, dk[nd][2 * hh + 1] * a.scale,
                 dk_out + base, col, a.d);
      store_pair(dv[nd][2 * hh], dv[nd][2 * hh + 1], dv_out + base, col, a.d);
    }
  }
}

}  // namespace
