// Flash attention for Hopper (sm_90a): the kernel bodies shared by
// flash_attention.cu (K1, K2 and K1's dense-mask variant, on [b, s, h, d]),
// flash_segment.cu (K5: packed segment ids, [b, s, h, d]) and
// flash_bhsd.cu (K6: the per-head layout [b, h, s, d]). Each kernel is a
// template on two axes:
//   kBhsd   the layout policy of the loads and stores: element (bi, pos,
//           head) of a tensor with `heads` heads sits at row
//           ((bi*s + pos)*heads + head) in bshd and ((bi*heads + head)*s +
//           pos) in bhsd (rows of d; for K and V heads is hkv; Delta
//           follows O's layout without the d axis);
//   kMask   the mask kind:
//     kMaskValid  key j of batch row bi is visible iff
//                 k_valid[bi % mask_b][j] != 0 (or always, no mask);
//     kMaskSeg    key j is visible to query i iff
//                 q_seg[bi][i] == kv_seg[bi][j];
//     kMaskDense  key j is visible to query i of head hd iff
//                 dense[bi % mask_b][hd % mask_h][i][j] != 0 (a contiguous
//                 [mask_b, mask_h, s, s] byte mask, mask_b in {1, b},
//                 mask_h in {1, h}; forward only);
// and j <= i on top of any of them when causal.
//
// Contract (the TPU kernels' own):
//   q [b, s, h, d], k/v [b, s, hkv, d] (bhsd: [b, h, s, d], [b, hkv, s,
//   d])  fp32 | bf16 (one dtype), GQA with head = kv_head * g + i,
//   g = h / hkv
//   O in q's dtype and layout; Lse fp32 [b*h, s, 8] in both layouts, row
//   bi*h + head, value repeated over the 8 lanes; dq/dk/dv in the input
//   dtype and layout, dk/dv at kv heads.
// Masked logits are -1e30 (finite, NEG_INF of the TPU kernels): a row with
// no visible key comes out as the uniform average of V over all s keys,
// as the plain version gives. These bodies run every product and sum in
// fp32 (tiles are widened at load). The operands P and dS follow each TPU
// kernel: the bshd kernels (K1, K2, K5) keep them in fp32, as theirs do
// by default; the per-head kernels (K6) round them to the input dtype
// before each product under bf16, as the TPU's K6 does (P before P.V,
// dS before dS.K, P before P^T.dO and dS before dS^T.Q; `operand`), the
// forward's row sum keeping the unrounded P. Under bf16 at head_dim <=
// 128 the forwards of K1, K5 and K6 (without a mask, with the factored
// one, under segment ids or under a dense mask) and the backwards of K2,
// K5 and K6 run on the tensor cores instead (flash_mma.cuh): in bshd P
// and dS enter as hi + lo bf16 pairs that keep them near fp32, in bhsd as
// hi alone, K6's rounding, from S and dP summed in fp64 and rounded to
// fp32 once (the plain version's sums). Delta =
// rowsum(dO * O) [b, s, h] fp32 ([b, h, s] in bhsd) comes from the caller
// (a torch reduction, as it is XLA in the reference). The backward
// assumes that a query row with no visible key carries a zero cotangent
// (the op zeroes padded rows' cotangent; under segment ids every row sees
// its own key), so it skips the tiles no row of a block can see.
//
// Design, simple and not yet tuned:
// - Grid (q-tile x group chunk, kv head, batch) for the forward and dQ.
//   A block's 64 rows are (query head of the group, query position)
//   pairs: the g heads that share a kv head are folded into the tile, so
//   each K/V tile is read once per group (the TPU kernel's einsum over the
//   folded group). A group of more than 64 heads (Falcon-7B's 71 on one kv
//   head) is split into chunks of 64 heads, one block each, at one query
//   position per block.
// - A loop inside the block over key tiles takes the place of the TPU
//   grid's sequential axis. It visits only the window of key tiles that
//   some row of the block can see: under segment ids the keys from the
//   segment start of the block's first query to the segment end of its
//   last (ids never decrease along a row, so two binary searches over the
//   row's ids find it, inside the kernel), cut at the diagonal when
//   causal. The forward goes on past the window only while some row has
//   seen no visible key (the uniform-average rule above). A dense mask
//   is read where it lies, one byte per (row, key) score, from each row's
//   own mask row (the tensor-core body stages it in shared memory): no
//   tile of it is skipped yet.
// - Tiles are staged in shared memory as fp32 with a padded row stride
//   (no bank conflicts). Each of the 128 threads owns 4 rows x BK/8 keys
//   of the score tile and 4 rows x D/8 columns of the output, keys and
//   columns strided by 8 so a row's 8 threads sit in one warp and reduce
//   with shuffles. The online-softmax state (m, l) and the output
//   accumulator stay in registers for the whole key loop.
// - dK/dV: grid (key tile, kv head, batch); each block keeps its dK/dV
//   tile in registers and loops over the group's query heads and over
//   the query positions that can see its keys (the transposed window),
//   64 at a time: the group sum happens in registers, no atomics (an fp32
//   output takes the registers' partial sums every 4 query tiles, see
//   DkvFlush).
// - Under bf16 at head_dim <= 128 every forward (K1, K5 and K6, under
//   every mask kind) and the backwards of K2, K5 and K6 (kMaskValid,
//   kMaskSeg) take the tensor-core bodies of flash_mma.cuh (mma.sync,
//   cp.async staging) on the same template axes; fp32 and head_dim > 128
//   take these bodies. Later work: wgmma with TMA.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;        // query rows of a forward / dQ block
constexpr int kQTile = 64;       // query positions per dK/dV step
constexpr int kLanes = 8;        // lanes of the Lse rows
constexpr float kNegInf = -1e30f;
// mask kinds (the kMask template argument)
constexpr int kMaskValid = 0;
constexpr int kMaskSeg = 1;
constexpr int kMaskDense = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// P or dS as an operand of the next product: rounded to bf16 by the
// per-head kernels (kBhsd) under bf16 inputs, as the TPU's K6 rounds them
// (pallas_attention.py:298, :663, :706, :709); fp32 otherwise, as K1, K2
// and K5 keep them
template <typename T, bool kBhsd>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBhsd && std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(x));
  return x;
}

// reduce over the 8 lanes (tid & 7) that share a row
__device__ __forceinline__ float max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o_grad;          // dO (backward)
  const float* lse_in;         // backward
  const float* delta;          // backward, [b, s, h]
  const unsigned char* k_valid;
  int mask_b;                  // rows of k_valid or batch extent of dense
  const int* q_seg;            // [b, s] segment ids (kSeg)
  const int* kv_seg;           // [b, s] segment ids (kSeg)
  void* out;                   // O (fwd) or dQ (dQ) or dK (dK/dV)
  void* out2;                  // dV (dK/dV)
  float* lse_out;              // fwd
  int b, s, h, hkv, d, causal;
  float scale;
  int mask_h;                  // head extent of dense
  const unsigned char* dense;  // [mask_b, mask_h, s, s] (kMaskDense)
};

// blocks along the grid's x axis that split a group of g query heads
// (one unless g > kRows)
__host__ __device__ __forceinline__ int group_chunks(int g) {
  return (g + kRows - 1) / kRows;
}

// row r of block bx -> (head of the group gi(r), query position pos(r)):
// a block holds qrows positions of every head of the group, or, for a
// group larger than kRows, one position of kRows heads from head gi0 on.
// Rows past the group or past the sequence are invalid.
struct RowMap {
  int qrows, g, gi0, q0;
  __device__ RowMap(int g_, int bx) : qrows(max(1, kRows / g_)), g(g_) {
    const int chunks = group_chunks(g_);
    gi0 = (bx % chunks) * kRows;
    q0 = (bx / chunks) * qrows;
  }
  __device__ int gi(int r) const { return gi0 + r / qrows; }
  __device__ int pos(int r) const { return q0 + r % qrows; }
  __device__ bool valid(int r, int s) const {
    return gi(r) < g && pos(r) < s;
  }
};

// the row (of d elements, or of one for Delta) that holds (batch bi,
// position pos, head hd) of a tensor with `heads` heads: the layout policy
template <bool kBhsd>
__device__ __forceinline__ size_t row_at(int bi, int pos, int hd, int s,
                                         int heads) {
  return kBhsd ? ((size_t)bi * heads + hd) * s + pos
               : ((size_t)bi * s + pos) * heads + hd;
}

// BK rows of K or V starting at key k0, widened to fp32 into
// dst[BK][stride]; keys past s and columns past d are zero. The tile's
// base is found once and keys step by a 32-bit stride: 64-bit index
// arithmetic per element made this loop a large share of a tile's time
// (measured on the H100).
template <typename T, int D, int BK, bool kBhsd>
__device__ __forceinline__ void load_kv_tile(float* dst, int stride,
                                             const T* src, const Args& a,
                                             int bi, int kvh, int k0) {
  // key k0 + r sits `step` elements after key k0
  const T* tile = src + row_at<kBhsd>(bi, k0, kvh, a.s, a.hkv) * a.d;
  const int step = (kBhsd ? 1 : a.hkv) * a.d;
  const int n = min(BK, a.s - k0);
  for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f;
    if (r < n && c < a.d) x = to_float(tile[r * step + c]);
    dst[r * stride + c] = x;
  }
}

// the dense mask's row of query qpos in head hd (kMaskDense; nullptr for
// the other kinds). Rows past the sequence read the last row: their
// scores are discarded.
template <int kMask>
__device__ __forceinline__ const unsigned char* dense_row(const Args& a,
                                                          int bi, int hd,
                                                          int qpos) {
  if (kMask != kMaskDense) return nullptr;
  return a.dense + (((size_t)(bi % a.mask_b) * a.mask_h + hd % a.mask_h) *
                        a.s + min(qpos, a.s - 1)) * a.s;
}

// n segment ids of `ids` row bi from position p0 into dst (kSeg only);
// positions past s get -1
template <bool kSeg>
__device__ __forceinline__ void load_seg(int* dst, int n, const int* ids,
                                         const Args& a, int bi, int p0) {
  if (!kSeg) return;
  for (int r = threadIdx.x; r < n; r += kThreads)
    dst[r] = p0 + r < a.s ? ids[(size_t)bi * a.s + p0 + r] : -1;
}

// the score of (row at qpos with segment qseg and dense mask row mrow,
// key with segment kseg): -inf past the sequence (excluded from the
// softmax), -1e30 where the causal, padding, segment or dense mask hides
// the key
template <int kMask>
__device__ __forceinline__ float masked(float x, int key, int qpos,
                                        int qseg, int kseg,
                                        const unsigned char* mrow,
                                        const Args& a, int bi) {
  if (key >= a.s) return -INFINITY;
  if (a.causal && key > qpos) return kNegInf;
  if (kMask == kMaskSeg) {
    if (qseg != kseg) return kNegInf;
  } else if (kMask == kMaskDense) {
    if (!mrow[key]) return kNegInf;
  } else if (a.k_valid &&
             !a.k_valid[(size_t)(bi % a.mask_b) * a.s + key]) {
    return kNegInf;
  }
  return x;
}

// first i in [0, n) with row[i] >= x (upper: row[i] > x), else n
__device__ __forceinline__ int lower_bound(const int* row, int n, int x,
                                           bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int y = row[mid];
    if (y < x || (upper && y == x)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// [*lo, *hi]: the positions of `inner` (a row of ids) whose segment lies
// between the segments of positions pa and pb of `outer`; the whole row
// without segment ids
template <bool kSeg>
__device__ __forceinline__ void segment_range(const int* outer,
                                              const int* inner,
                                              const Args& a, int bi, int pa,
                                              int pb, int* lo, int* hi) {
  *lo = 0;
  *hi = a.s - 1;
  if (kSeg) {
    const int* o = outer + (size_t)bi * a.s;
    const int* in = inner + (size_t)bi * a.s;
    *lo = lower_bound(in, a.s, o[pa], false);
    *hi = lower_bound(in, a.s, o[pb], true) - 1;
  }
}

template <int D, int BK>
struct FwdSmem {
  static constexpr int kQ = kRows * (D + 1);
  static constexpr int kK = BK * (D + 1);
  static constexpr int kV = BK * D;
  static constexpr int kP = kRows * (BK + 1);
  static constexpr size_t bytes =
      sizeof(float) * (kQ + kK + kV + kP) + sizeof(int) * BK;
};

// ---------------------------------------------------------------- fwd
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
  constexpr bool kSeg = kMask == kMaskSeg;
  extern __shared__ __align__(16) float smem[];
  using S = FwdSmem<D, BK>;
  float* q_s = smem;
  float* k_s = q_s + S::kQ;
  float* v_s = k_s + S::kK;
  float* p_s = v_s + S::kV;
  int* kseg_s = reinterpret_cast<int*>(p_s + S::kP);
  constexpr int KJ = BK / 8;     // keys per thread
  constexpr int DC = D / 8;      // output columns per thread

  const int g = a.h / a.hkv;
  const RowMap rm(g, blockIdx.x);
  const int q0 = rm.q0;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const T* q = static_cast<const T*>(a.q);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f;
    if (c < a.d && rm.valid(r, a.s)) {
      const int head = kvh * g + rm.gi(r), qpos = rm.pos(r);
      x = to_float(q[row_at<kBhsd>(bi, qpos, head, a.s, a.h) * a.d + c]);
    }
    q_s[r * (D + 1) + c] = x;
  }
  int qpos[4], qseg[4];
  bool rv[4];
  const unsigned char* mrow[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    rv[i] = rm.valid(r, a.s);
    qpos[i] = rm.pos(r);
    qseg[i] = kSeg && rv[i] ? a.q_seg[(size_t)bi * a.s + qpos[i]] : 0;
    mrow[i] = dense_row<kMask>(a, bi, kvh * g + rm.gi(r), qpos[i]);
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int qmax = min(q0 + rm.qrows, a.s) - 1;
  int klo, khi;
  segment_range<kSeg>(a.q_seg, a.kv_seg, a, bi, q0, qmax, &klo, &khi);
  if (a.causal) khi = min(khi, qmax);
  const int n_tiles = (a.s + BK - 1) / BK;
  const int t_lo = klo / BK;
  const int n_win = khi >= klo ? khi / BK - t_lo + 1 : 0;

  for (int it = 0; it < n_tiles; ++it) {
    int t = t_lo + it;
    if (it >= n_win) {
      // outside the window: go on only for rows with no visible key yet
      int need = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) need |= (rv[i] && m[i] <= kNegInf);
      if (!__syncthreads_or(need)) break;
      const int o = it - n_win;
      t = o < t_lo ? o : o + n_win;
    }
    const int k0 = t * BK;
    __syncthreads();
    load_kv_tile<T, D, BK, kBhsd>(k_s, D + 1, static_cast<const T*>(a.k), a,
                                  bi, kvh, k0);
    load_kv_tile<T, D, BK, kBhsd>(v_s, D, static_cast<const T*>(a.v), a, bi,
                                  kvh, k0);
    load_seg<kSeg>(kseg_s, BK, a.kv_seg, a, bi, k0);
    __syncthreads();

    float sc[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D; ++kd) {
      float qv[4], kv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(rg * 4 + i) * (D + 1) + kd];
#pragma unroll
      for (int j = 0; j < KJ; ++j) kv[j] = k_s[(kg + 8 * j) * (D + 1) + kd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kl = kg + 8 * j;
        sc[i][j] = masked<kMask>(sc[i][j] * a.scale, k0 + kl, qpos[i],
                                 qseg[i], kseg_s[kl], mrow[i], a, bi);
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max8(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(rg * 4 + i) * (BK + 1) + kg + 8 * j] = operand<T, kBhsd>(p);
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[key * D + kg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(rg * 4 + i) * (BK + 1) + key];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rv[i]) continue;
    const int r = rg * 4 + i;
    const int head = kvh * g + rm.gi(r);
    const float lc = fmaxf(l[i], 1e-20f);
    const size_t base = row_at<kBhsd>(bi, qpos[i], head, a.s, a.h) * a.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = kg + 8 * c;
      if (col < a.d) store(acc[i][c] / lc, out + base + col);
    }
    a.lse_out[(((size_t)bi * a.h + head) * a.s + qpos[i]) * kLanes + kg] =
        m[i] + logf(lc);
  }
}

template <int D, int BK>
struct DqSmem {
  static constexpr int kQ = kRows * (D + 1);
  static constexpr int kK = BK * (D + 1);
  static constexpr int kP = kRows * (BK + 1);
  static constexpr size_t bytes =
      sizeof(float) * (2 * kQ + 2 * kK + kP) + sizeof(int) * BK;
};

// ------------------------------------------------------------------ dQ
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  static_assert(kMask != kMaskDense, "a dense mask's backward recomputes");
  constexpr bool kSeg = kMask == kMaskSeg;
  extern __shared__ __align__(16) float smem[];
  using S = DqSmem<D, BK>;
  float* q_s = smem;
  float* do_s = q_s + S::kQ;
  float* k_s = do_s + S::kQ;
  float* v_s = k_s + S::kK;
  float* ds_s = v_s + S::kK;
  int* kseg_s = reinterpret_cast<int*>(ds_s + S::kP);
  constexpr int KJ = BK / 8;
  constexpr int DC = D / 8;

  const int g = a.h / a.hkv;
  const RowMap rm(g, blockIdx.x);
  const int q0 = rm.q0;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.o_grad);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f, y = 0.f;
    if (c < a.d && rm.valid(r, a.s)) {
      const int head = kvh * g + rm.gi(r), qpos = rm.pos(r);
      const size_t off = row_at<kBhsd>(bi, qpos, head, a.s, a.h) * a.d + c;
      x = to_float(q[off]);
      y = to_float(dout[off]);
    }
    q_s[r * (D + 1) + c] = x;
    do_s[r * (D + 1) + c] = y;
  }
  int qpos[4], qseg[4];
  bool rv[4];
  float lse[4], delta[4], dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    rv[i] = rm.valid(r, a.s);
    qpos[i] = rm.pos(r);
    qseg[i] = kSeg && rv[i] ? a.q_seg[(size_t)bi * a.s + qpos[i]] : 0;
    const int head = kvh * g + rm.gi(r);
    lse[i] = rv[i] ? a.lse_in[(((size_t)bi * a.h + head) * a.s + qpos[i]) *
                              kLanes]
                   : 0.f;
    delta[i] = rv[i] ? a.delta[row_at<kBhsd>(bi, qpos[i], head, a.s, a.h)]
                     : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
  }
  const int qmax = min(q0 + rm.qrows, a.s) - 1;
  int klo, khi;
  segment_range<kSeg>(a.q_seg, a.kv_seg, a, bi, q0, qmax, &klo, &khi);
  if (a.causal) khi = min(khi, qmax);
  const int t_end = khi >= klo ? khi / BK + 1 : 0;

  for (int t = klo / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_kv_tile<T, D, BK, kBhsd>(k_s, D + 1, static_cast<const T*>(a.k), a,
                                  bi, kvh, k0);
    load_kv_tile<T, D, BK, kBhsd>(v_s, D + 1, static_cast<const T*>(a.v), a,
                                  bi, kvh, k0);
    load_seg<kSeg>(kseg_s, BK, a.kv_seg, a, bi, k0);
    __syncthreads();

    float sc[4][KJ], dp[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int kd = 0; kd < D; ++kd) {
      float qv[4], gv[4], kv[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(rg * 4 + i) * (D + 1) + kd];
        gv[i] = do_s[(rg * 4 + i) * (D + 1) + kd];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = k_s[(kg + 8 * j) * (D + 1) + kd];
        vv[j] = v_s[(kg + 8 * j) * (D + 1) + kd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          sc[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kl = kg + 8 * j;
        const float x = masked<kMask>(sc[i][j] * a.scale, k0 + kl, qpos[i],
                                      qseg[i], kseg_s[kl], nullptr, a, bi);
        const float p = rv[i] ? expf(x - lse[i]) : 0.f;
        ds_s[(rg * 4 + i) * (BK + 1) + kl] =
            operand<T, kBhsd>(p * (dp[i][j] - delta[i]));
      }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[key * (D + 1) + kg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(rg * 4 + i) * (BK + 1) + key];
#pragma unroll
        for (int c = 0; c < DC; ++c) dq[i][c] += ds * kv[c];
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rv[i]) continue;
    const int head = kvh * g + rm.gi(rg * 4 + i);
    const size_t base = row_at<kBhsd>(bi, qpos[i], head, a.s, a.h) * a.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = kg + 8 * c;
      if (col < a.d) store(dq[i][c] * a.scale, out + base + col);
    }
  }
}

template <int D, int BK>
struct DkvSmem {
  static constexpr int kK = BK * (D + 1);
  static constexpr int kQ = kQTile * (D + 1);
  static constexpr int kP = BK * (kQTile + 1);
  static constexpr size_t bytes =
      sizeof(float) * (2 * kK + 2 * kQ + 2 * kP + 2 * kQTile) +
      sizeof(int) * (BK + kQTile);
};

// Query tiles a dK/dV block sums in registers before it adds them into an
// fp32 output (0: one store at the end). One register summing a group's
// g * s query rows loses ~sqrt(n) half-ulps: over Falcon-7B's 71 heads of
// 256 rows that left dV 1.3e-4 off the plain version (measured on the
// H100), so fp32 adds its partial sums into the output every 4 tiles (256
// rows). A bf16 output's own rounding (2^-9) dwarfs that error: bf16
// keeps one store.
template <typename T>
struct DkvFlush { static constexpr int tiles = 0; };
template <>
struct DkvFlush<float> { static constexpr int tiles = 4; };

// store (first) or add this thread's dK/dV sums into its rows of the
// outputs
template <typename T, int D, int BK, bool kBhsd>
__device__ __forceinline__ void store_dkv(const float (&dk)[BK / 16][D / 8],
                                          const float (&dv)[BK / 16][D / 8],
                                          const Args& a, int bi, int kvh,
                                          int k0, int kgr, int rg,
                                          bool first) {
  constexpr int KI = BK / 16;
  constexpr int DC = D / 8;
  T* dk_out = static_cast<T*>(a.out);
  T* dv_out = static_cast<T*>(a.out2);
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = k0 + kgr * KI + i;
    if (key >= a.s) continue;
    const size_t base = row_at<kBhsd>(bi, key, kvh, a.s, a.hkv) * a.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = rg + 8 * c;
      if (col < a.d) {
        float x = dk[i][c] * a.scale, y = dv[i][c];
        if (!first) {
          x += to_float(dk_out[base + col]);
          y += to_float(dv_out[base + col]);
        }
        store(x, dk_out + base + col);
        store(y, dv_out + base + col);
      }
    }
  }
}

// --------------------------------------------------------------- dK/dV
template <typename T, int D, int BK, int kMask, bool kBhsd>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  static_assert(kMask != kMaskDense, "a dense mask's backward recomputes");
  constexpr bool kSeg = kMask == kMaskSeg;
  extern __shared__ __align__(16) float smem[];
  using S = DkvSmem<D, BK>;
  float* k_s = smem;
  float* v_s = k_s + S::kK;
  float* q_s = v_s + S::kK;
  float* do_s = q_s + S::kQ;
  float* p_s = do_s + S::kQ;      // P^T  [BK][kQTile + 1]
  float* ds_s = p_s + S::kP;      // dS^T [BK][kQTile + 1]
  float* lse_s = ds_s + S::kP;    // [kQTile]
  float* delta_s = lse_s + kQTile;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kQTile);   // [BK]
  int* qseg_s = kseg_s + BK;                                 // [kQTile]
  constexpr int KI = BK / 16;     // keys per thread
  constexpr int RJ = kQTile / 8;  // query rows per thread
  constexpr int DC = D / 8;

  const int g = a.h / a.hkv;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, kgr = tid >> 3, rg = tid & 7;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.o_grad);

  load_kv_tile<T, D, BK, kBhsd>(k_s, D + 1, static_cast<const T*>(a.k), a, bi,
                                kvh, k0);
  load_kv_tile<T, D, BK, kBhsd>(v_s, D + 1, static_cast<const T*>(a.v), a, bi,
                                kvh, k0);
  load_seg<kSeg>(kseg_s, BK, a.kv_seg, a, bi, k0);
  float dk[KI][DC], dv[KI][DC];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // the query positions that can see a key of this tile: the transposed
  // segment window, from position k0 on under a causal mask
  const int kmax = min(k0 + BK, a.s) - 1;
  int qlo, qhi;
  segment_range<kSeg>(a.kv_seg, a.q_seg, a, bi, k0, kmax, &qlo, &qhi);
  if (a.causal) qlo = max(qlo, k0);
  constexpr int kFlush = DkvFlush<T>::tiles;
  int tiles = 0;         // tiles summed since the last store
  bool stored = false;
  for (int gi = 0; gi < g; ++gi) {
    const int head = kvh * g + gi;
    for (int q0 = qlo; q0 <= qhi; q0 += kQTile) {
      __syncthreads();
      for (int idx = tid; idx < kQTile * D; idx += kThreads) {
        const int r = idx / D, c = idx - (idx / D) * D;
        float x = 0.f, y = 0.f;
        if (c < a.d && q0 + r < a.s) {
          const size_t off =
              row_at<kBhsd>(bi, q0 + r, head, a.s, a.h) * a.d + c;
          x = to_float(q[off]);
          y = to_float(dout[off]);
        }
        q_s[r * (D + 1) + c] = x;
        do_s[r * (D + 1) + c] = y;
      }
      for (int r = tid; r < kQTile; r += kThreads) {
        const int qpos = q0 + r;
        lse_s[r] = qpos < a.s ? a.lse_in[(((size_t)bi * a.h + head) * a.s +
                                          qpos) * kLanes]
                              : 0.f;
        delta_s[r] = qpos < a.s
                         ? a.delta[row_at<kBhsd>(bi, qpos, head, a.s, a.h)]
                         : 0.f;
      }
      load_seg<kSeg>(qseg_s, kQTile, a.q_seg, a, bi, q0);
      __syncthreads();

      float sc[KI][RJ], dp[KI][RJ];
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int kd = 0; kd < D; ++kd) {
        float kv[KI], vv[KI], qv[RJ], gv[RJ];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          kv[i] = k_s[(kgr * KI + i) * (D + 1) + kd];
          vv[i] = v_s[(kgr * KI + i) * (D + 1) + kd];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          qv[j] = q_s[(rg + 8 * j) * (D + 1) + kd];
          gv[j] = do_s[(rg + 8 * j) * (D + 1) + kd];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            sc[i][j] += kv[i] * qv[j];
            dp[i][j] += vv[i] * gv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        const int kl = kgr * KI + i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int rl = rg + 8 * j, qpos = q0 + rl;
          float p = 0.f;
          if (qpos < a.s)
            p = expf(masked<kMask>(sc[i][j] * a.scale, k0 + kl, qpos,
                                   qseg_s[rl], kseg_s[kl], nullptr, a, bi) -
                     lse_s[rl]);
          p_s[kl * (kQTile + 1) + rl] = operand<T, kBhsd>(p);
          ds_s[kl * (kQTile + 1) + rl] =
              operand<T, kBhsd>(p * (dp[i][j] - delta_s[rl]));
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int rl = 0; rl < kQTile; ++rl) {
        float qv[DC], gv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          qv[c] = q_s[rl * (D + 1) + rg + 8 * c];
          gv[c] = do_s[rl * (D + 1) + rg + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float p = p_s[(kgr * KI + i) * (kQTile + 1) + rl];
          const float ds = ds_s[(kgr * KI + i) * (kQTile + 1) + rl];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[i][c] += p * gv[c];
            dk[i][c] += ds * qv[c];
          }
        }
      }
      if (kFlush > 0 && ++tiles == kFlush) {
        store_dkv<T, D, BK, kBhsd>(dk, dv, a, bi, kvh, k0, kgr, rg, !stored);
        stored = true;
        tiles = 0;
#pragma unroll
        for (int i = 0; i < KI; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;
      }
    }
  }
  if (!stored || tiles > 0)
    store_dkv<T, D, BK, kBhsd>(dk, dv, a, bi, kvh, k0, kgr, rg, !stored);
}

}  // namespace

#include "flash_mma.cuh"

namespace {

// ------------------------------------------------------------ launch
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr int block_k() { return D <= 128 ? 64 : 32; }

// whether the backward of (T, D, mask kind, layout) runs on the tensor
// cores (flash_mma.cuh): bf16 K2, K5 and K6 at head_dim <= 128. A fixed
// choice by dtype, head_dim and mask kind, not a fallback; fp32 (the
// fp32 gates) and head_dim in (128, 256] take the CUDA-core bodies above.
template <typename T, int D, int kMask, bool kBhsd>
constexpr bool mma_backward() {
  return std::is_same<T, __nv_bfloat16>::value && D <= 128 &&
         (kMask == kMaskValid || kMask == kMaskSeg);
}

// whether the forward runs on the tensor cores: bf16 K1, K5 and K6 at
// head_dim <= 128, without a mask, with the factored one, under segment
// ids (K5-fwd) or under a dense mask (K1-dense, K6-fwd-dense)
template <typename T, int D, int kMask, bool kBhsd>
constexpr bool mma_forward() {
  return std::is_same<T, __nv_bfloat16>::value && D <= 128;
}

template <typename T, int D, int kMask, bool kBhsd>
size_t smem_for(int kernel) {
  constexpr int BK = block_k<D>();
  if (kernel == kFwd) {
    if constexpr (mma_forward<T, D, kMask, kBhsd>())
      return FwdMmaSmem<D, BK, kMask == kMaskDense>::bytes;
    else
      return FwdSmem<D, BK>::bytes;
  }
  if constexpr (mma_backward<T, D, kMask, kBhsd>()) {
    if (kernel == kDq) return DqMmaSmem<D, BK>::bytes;
    return DkvMmaSmem<D, BK>::bytes;
  } else {
    if (kernel == kDq) return DqSmem<D, BK>::bytes;
    return DkvSmem<D, BK>::bytes;
  }
}

template <typename T, int kMask, bool kBhsd>
size_t smem_for_d(int kernel, int d) {
  if (d <= 32) return smem_for<T, 32, kMask, kBhsd>(kernel);
  if (d <= 64) return smem_for<T, 64, kMask, kBhsd>(kernel);
  if (d <= 128) return smem_for<T, 128, kMask, kBhsd>(kernel);
  return smem_for<T, 256, kMask, kBhsd>(kernel);
}

template <int kMask, bool kBhsd>
size_t smem_for_dtype(int kernel, int d, int dtype) {
  return dtype == 1 ? smem_for_d<__nv_bfloat16, kMask, kBhsd>(kernel, d)
                    : smem_for_d<float, kMask, kBhsd>(kernel, d);
}

// shared memory of one block of `kernel` under mask kind `mask` (a kMask
// value) at head_dim d and dtype (0 = float32, 1 = bfloat16), in the
// layout of the calling source: the body that dispatch launches for them
template <bool kBhsd>
size_t smem_bytes(int kernel, int mask, int d, int dtype) {
  if (mask == kMaskSeg)
    return smem_for_dtype<kMaskSeg, kBhsd>(kernel, d, dtype);
  if (mask == kMaskDense)
    return smem_for_dtype<kMaskDense, kBhsd>(kernel, d, dtype);
  return smem_for_dtype<kMaskValid, kBhsd>(kernel, d, dtype);
}

template <typename Fn>
int launch_kernel(Fn fn, dim3 grid, size_t smem, cudaStream_t stream,
                  const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D, int kMask, bool kBhsd>
int dispatch(int kernel, const Args& a, cudaStream_t stream) {
  constexpr int BK = block_k<D>();
  const int g = a.h / a.hkv;
  const int qrows = kRows / g > 0 ? kRows / g : 1;
  const dim3 rows_grid((a.s + qrows - 1) / qrows * group_chunks(g), a.hkv,
                       a.b);
  if (kernel == kFwd) {
    if constexpr (mma_forward<T, D, kMask, kBhsd>())
      return launch_kernel(flash_fwd_mma_kernel<T, D, BK, kMask, kBhsd>,
                           rows_grid,
                           FwdMmaSmem<D, BK, kMask == kMaskDense>::bytes,
                           stream, a);
    else
      return launch_kernel(flash_fwd_kernel<T, D, BK, kMask, kBhsd>,
                           rows_grid, FwdSmem<D, BK>::bytes, stream, a);
  }
  if constexpr (kMask == kMaskDense) {
    return (int)cudaErrorInvalidValue;   // dense masks: forward only
  } else if constexpr (mma_backward<T, D, kMask, kBhsd>()) {
    if (kernel == kDq)
      return launch_kernel(flash_bwd_dq_mma_kernel<T, D, BK, kMask, kBhsd>,
                           rows_grid, DqMmaSmem<D, BK>::bytes, stream, a);
    return launch_kernel(flash_bwd_dkv_mma_kernel<T, D, BK, kMask, kBhsd>,
                         dim3((a.s + BK - 1) / BK, a.hkv, a.b),
                         DkvMmaSmem<D, BK>::bytes, stream, a);
  } else {
    if (kernel == kDq)
      return launch_kernel(flash_bwd_dq_kernel<T, D, BK, kMask, kBhsd>,
                           rows_grid, DqSmem<D, BK>::bytes, stream, a);
    return launch_kernel(flash_bwd_dkv_kernel<T, D, BK, kMask, kBhsd>,
                         dim3((a.s + BK - 1) / BK, a.hkv, a.b),
                         DkvSmem<D, BK>::bytes, stream, a);
  }
}

template <typename T, int kMask, bool kBhsd>
int dispatch_d(int kernel, const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return dispatch<T, 32, kMask, kBhsd>(kernel, a, stream);
  if (a.d <= 64) return dispatch<T, 64, kMask, kBhsd>(kernel, a, stream);
  if (a.d <= 128) return dispatch<T, 128, kMask, kBhsd>(kernel, a, stream);
  return dispatch<T, 256, kMask, kBhsd>(kernel, a, stream);
}

// one launch of `kernel` (kFwd, kDq, kDkv) for the mask kind and layout
// of the calling source; a cudaError_t, 0 on success
template <int kMask, bool kBhsd>
int run(int kernel, const Args& a, int dtype, void* stream) {
  if (a.b <= 0 || a.s <= 0 || a.h <= 0 || a.hkv <= 0 || a.h % a.hkv ||
      a.d <= 0 || a.d > 256 || a.b > 65535 ||
      a.hkv > 65535 || a.mask_b < 0 ||
      (kMask == kMaskSeg && (a.q_seg == nullptr || a.kv_seg == nullptr)) ||
      (kMask == kMaskDense &&
       (a.dense == nullptr || (a.mask_b != 1 && a.mask_b != a.b) ||
        (a.mask_h != 1 && a.mask_h != a.h) || (!kBhsd && a.mask_h != 1))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, kMask, kBhsd>(kernel, a, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, kMask, kBhsd>(kernel, a, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, int b, int s,
               int h, int hkv, int d, float scale, int causal) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask_b = 1;
  a.mask_h = 1;
  a.b = b;
  a.s = s;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  return a;
}

// the factored padding mask's arguments: k_valid [mask_b, s] bytes, or
// none when mask_b is 0
Args padded_args(const void* q, const void* k, const void* v,
                 const void* k_valid, int mask_b, int b, int s, int h,
                 int hkv, int d, float scale, int causal) {
  Args a = make_args(q, k, v, b, s, h, hkv, d, scale, causal);
  a.k_valid = static_cast<const unsigned char*>(mask_b > 0 ? k_valid
                                                           : nullptr);
  a.mask_b = mask_b > 0 ? mask_b : 1;
  return a;
}

// the dense mask's arguments: [mask_b, mask_h, s, s] bytes
Args dense_args(const void* q, const void* k, const void* v,
                const void* mask, int mask_b, int mask_h, int b, int s,
                int h, int hkv, int d, float scale, int causal) {
  Args a = make_args(q, k, v, b, s, h, hkv, d, scale, causal);
  a.dense = static_cast<const unsigned char*>(mask);
  a.mask_b = mask_b;
  a.mask_h = mask_h;
  return a;
}

}  // namespace
