// Flash attention on [batch, seq, heads, head_dim] ("bshd") for Hopper
// (sm_90a): the kernel bodies shared by flash_attention.cu (K1, K2: no
// mask or a factored padding mask) and flash_segment.cu (K5: packed
// segment ids). Each kernel is a template on kSeg, the mask kind:
//   kSeg = false  key j of batch row bi is visible iff
//                 k_valid[bi % mask_b][j] != 0 (or always, no mask);
//   kSeg = true   key j is visible to query i iff
//                 q_seg[bi][i] == kv_seg[bi][j];
// and j <= i on top of either when causal.
//
// Contract (the TPU kernels' own):
//   q [b, s, h, d], k/v [b, s, hkv, d]   fp32 | bf16 (one dtype), GQA with
//                                       head = kv_head * g + i, g = h / hkv
//   O in q's dtype; Lse fp32 [b*h, s, 8], row bi*h + head, value repeated
//   over the 8 lanes; dq/dk/dv in the input dtype, dk/dv at kv heads.
// Masked logits are -1e30 (finite, NEG_INF of the TPU kernels): a row with
// no visible key comes out as the uniform average of V over all s keys,
// as the plain version gives. Every product and sum runs in fp32 (tiles
// are widened at load), as the TPU kernels do. Delta = rowsum(dO * O)
// [b, s, h] fp32 comes from the caller (a torch reduction, as it is XLA in
// the reference). The backward assumes that a query row with no visible
// key carries a zero cotangent (the op zeroes padded rows' cotangent;
// under segment ids every row sees its own key), so it skips the tiles
// no row of a block can see.
//
// Design, simple and not yet tuned:
// - Grid (q-tile, kv head, batch) for the forward and dQ. A block's 64
//   rows are (query head of the group, query position) pairs: the g heads
//   that share a kv head are folded into the tile, so each K/V tile is
//   read once per group (the TPU kernel's einsum over the folded group).
// - A loop inside the block over key tiles takes the place of the TPU
//   grid's sequential axis. It visits only the window of key tiles that
//   some row of the block can see: under segment ids the keys from the
//   segment start of the block's first query to the segment end of its
//   last (ids never decrease along a row, so two binary searches over the
//   row's ids find it, inside the kernel), cut at the diagonal when
//   causal. The forward goes on past the window only while some row has
//   seen no visible key (the uniform-average rule above).
// - Tiles are staged in shared memory as fp32 with a padded row stride
//   (no bank conflicts). Each of the 128 threads owns 4 rows x BK/8 keys
//   of the score tile and 4 rows x D/8 columns of the output, keys and
//   columns strided by 8 so a row's 8 threads sit in one warp and reduce
//   with shuffles. The online-softmax state (m, l) and the output
//   accumulator stay in registers for the whole key loop.
// - dK/dV: grid (key tile, kv head, batch); each block keeps its dK/dV
//   tile in registers and loops over the group's query heads and over
//   the query positions that can see its keys (the transposed window),
//   64 at a time: the group sum happens in registers, no atomics.
// Later work: bf16 tensor-core products (mma.sync / wgmma) with TMA
// staging, which would also round P to bf16 where the TPU kernel does not.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 64;        // query rows of a forward / dQ block
constexpr int kQTile = 64;       // query positions per dK/dV step
constexpr int kLanes = 8;        // lanes of the Lse rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
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
  int mask_b;                  // rows of k_valid (0 = no mask)
  const int* q_seg;            // [b, s] segment ids (kSeg)
  const int* kv_seg;           // [b, s] segment ids (kSeg)
  void* out;                   // O (fwd) or dQ (dQ) or dK (dK/dV)
  void* out2;                  // dV (dK/dV)
  float* lse_out;              // fwd
  int b, s, h, hkv, d, causal;
  float scale;
};

// one block row -> (query head, query position); rows past the group or
// past the sequence are invalid
struct RowMap {
  int qrows, g;
  __device__ RowMap(int g_) : qrows(max(1, kRows / g_)), g(g_) {}
  __device__ bool valid(int r, int q0, int s) const {
    return r / qrows < g && q0 + r % qrows < s;
  }
};

// BK rows of K or V starting at key k0, widened to fp32 into
// dst[BK][stride]; keys past s and columns past d are zero
template <typename T, int D, int BK>
__device__ __forceinline__ void load_kv_tile(float* dst, int stride,
                                             const T* src, const Args& a,
                                             int bi, int kvh, int k0) {
  for (int idx = threadIdx.x; idx < BK * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    const int key = k0 + r;
    float x = 0.f;
    if (key < a.s && c < a.d)
      x = to_float(src[(((size_t)bi * a.s + key) * a.hkv + kvh) * a.d + c]);
    dst[r * stride + c] = x;
  }
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

// the score of (row at qpos with segment qseg, key with segment kseg):
// -inf past the sequence (excluded from the softmax), -1e30 where the
// causal, padding or segment mask hides the key
template <bool kSeg>
__device__ __forceinline__ float masked(float x, int key, int qpos,
                                        int qseg, int kseg, const Args& a,
                                        int bi) {
  if (key >= a.s) return -INFINITY;
  if (a.causal && key > qpos) return kNegInf;
  if (kSeg) {
    if (qseg != kseg) return kNegInf;
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
template <typename T, int D, int BK, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
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
  const RowMap rm(g);
  const int q0 = blockIdx.x * rm.qrows;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const T* q = static_cast<const T*>(a.q);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f;
    if (c < a.d && rm.valid(r, q0, a.s)) {
      const int head = kvh * g + r / rm.qrows, qpos = q0 + r % rm.qrows;
      x = to_float(q[(((size_t)bi * a.s + qpos) * a.h + head) * a.d + c]);
    }
    q_s[r * (D + 1) + c] = x;
  }
  int qpos[4], qseg[4];
  bool rv[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    rv[i] = rm.valid(r, q0, a.s);
    qpos[i] = q0 + r % rm.qrows;
    qseg[i] = kSeg && rv[i] ? a.q_seg[(size_t)bi * a.s + qpos[i]] : 0;
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
    load_kv_tile<T, D, BK>(k_s, D + 1, static_cast<const T*>(a.k), a, bi,
                           kvh, k0);
    load_kv_tile<T, D, BK>(v_s, D, static_cast<const T*>(a.v), a, bi, kvh,
                           k0);
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
        sc[i][j] = masked<kSeg>(sc[i][j] * a.scale, k0 + kl, qpos[i],
                                qseg[i], kseg_s[kl], a, bi);
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max8(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(rg * 4 + i) * (BK + 1) + kg + 8 * j] = p;
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
    const int head = kvh * g + r / rm.qrows;
    const float lc = fmaxf(l[i], 1e-20f);
    const size_t base = (((size_t)bi * a.s + qpos[i]) * a.h + head) * a.d;
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
template <typename T, int D, int BK, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
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
  const RowMap rm(g);
  const int q0 = blockIdx.x * rm.qrows;
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 3, kg = tid & 7;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.o_grad);

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx - (idx / D) * D;
    float x = 0.f, y = 0.f;
    if (c < a.d && rm.valid(r, q0, a.s)) {
      const int head = kvh * g + r / rm.qrows, qpos = q0 + r % rm.qrows;
      const size_t off = (((size_t)bi * a.s + qpos) * a.h + head) * a.d + c;
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
    rv[i] = rm.valid(r, q0, a.s);
    qpos[i] = q0 + r % rm.qrows;
    qseg[i] = kSeg && rv[i] ? a.q_seg[(size_t)bi * a.s + qpos[i]] : 0;
    const int head = kvh * g + r / rm.qrows;
    lse[i] = rv[i] ? a.lse_in[(((size_t)bi * a.h + head) * a.s + qpos[i]) *
                              kLanes]
                   : 0.f;
    delta[i] = rv[i] ? a.delta[((size_t)bi * a.s + qpos[i]) * a.h + head]
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
    load_kv_tile<T, D, BK>(k_s, D + 1, static_cast<const T*>(a.k), a, bi,
                           kvh, k0);
    load_kv_tile<T, D, BK>(v_s, D + 1, static_cast<const T*>(a.v), a, bi,
                           kvh, k0);
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
        const float x = masked<kSeg>(sc[i][j] * a.scale, k0 + kl, qpos[i],
                                     qseg[i], kseg_s[kl], a, bi);
        const float p = rv[i] ? expf(x - lse[i]) : 0.f;
        ds_s[(rg * 4 + i) * (BK + 1) + kl] = p * (dp[i][j] - delta[i]);
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
    const int head = kvh * g + (rg * 4 + i) / rm.qrows;
    const size_t base = (((size_t)bi * a.s + qpos[i]) * a.h + head) * a.d;
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

// --------------------------------------------------------------- dK/dV
template <typename T, int D, int BK, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
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

  load_kv_tile<T, D, BK>(k_s, D + 1, static_cast<const T*>(a.k), a, bi, kvh,
                         k0);
  load_kv_tile<T, D, BK>(v_s, D + 1, static_cast<const T*>(a.v), a, bi, kvh,
                         k0);
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
  for (int gi = 0; gi < g; ++gi) {
    const int head = kvh * g + gi;
    for (int q0 = qlo; q0 <= qhi; q0 += kQTile) {
      __syncthreads();
      for (int idx = tid; idx < kQTile * D; idx += kThreads) {
        const int r = idx / D, c = idx - (idx / D) * D;
        float x = 0.f, y = 0.f;
        if (c < a.d && q0 + r < a.s) {
          const size_t off =
              (((size_t)bi * a.s + q0 + r) * a.h + head) * a.d + c;
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
                         ? a.delta[((size_t)bi * a.s + qpos) * a.h + head]
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
            p = expf(masked<kSeg>(sc[i][j] * a.scale, k0 + kl, qpos,
                                  qseg_s[rl], kseg_s[kl], a, bi) -
                     lse_s[rl]);
          p_s[kl * (kQTile + 1) + rl] = p;
          ds_s[kl * (kQTile + 1) + rl] = p * (dp[i][j] - delta_s[rl]);
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
    }
  }

  T* dk_out = static_cast<T*>(a.out);
  T* dv_out = static_cast<T*>(a.out2);
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = k0 + kgr * KI + i;
    if (key >= a.s) continue;
    const size_t base = (((size_t)bi * a.s + key) * a.hkv + kvh) * a.d;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = rg + 8 * c;
      if (col < a.d) {
        store(dk[i][c] * a.scale, dk_out + base + col);
        store(dv[i][c], dv_out + base + col);
      }
    }
  }
}

// ------------------------------------------------------------ launch
enum Kernel { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
constexpr int block_k() { return D <= 128 ? 64 : 32; }

template <int D>
size_t smem_for(int kernel) {
  constexpr int BK = block_k<D>();
  if (kernel == kFwd) return FwdSmem<D, BK>::bytes;
  if (kernel == kDq) return DqSmem<D, BK>::bytes;
  return DkvSmem<D, BK>::bytes;
}

size_t smem_bytes(int kernel, int d) {
  if (d <= 32) return smem_for<32>(kernel);
  if (d <= 64) return smem_for<64>(kernel);
  if (d <= 128) return smem_for<128>(kernel);
  return smem_for<256>(kernel);
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

template <typename T, int D, bool kSeg>
int dispatch(int kernel, const Args& a, cudaStream_t stream) {
  constexpr int BK = block_k<D>();
  const int g = a.h / a.hkv;
  const int qrows = kRows / g > 0 ? kRows / g : 1;
  if (kernel == kFwd)
    return launch_kernel(flash_fwd_kernel<T, D, BK, kSeg>,
                         dim3((a.s + qrows - 1) / qrows, a.hkv, a.b),
                         FwdSmem<D, BK>::bytes, stream, a);
  if (kernel == kDq)
    return launch_kernel(flash_bwd_dq_kernel<T, D, BK, kSeg>,
                         dim3((a.s + qrows - 1) / qrows, a.hkv, a.b),
                         DqSmem<D, BK>::bytes, stream, a);
  return launch_kernel(flash_bwd_dkv_kernel<T, D, BK, kSeg>,
                       dim3((a.s + BK - 1) / BK, a.hkv, a.b),
                       DkvSmem<D, BK>::bytes, stream, a);
}

template <typename T, bool kSeg>
int dispatch_d(int kernel, const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return dispatch<T, 32, kSeg>(kernel, a, stream);
  if (a.d <= 64) return dispatch<T, 64, kSeg>(kernel, a, stream);
  if (a.d <= 128) return dispatch<T, 128, kSeg>(kernel, a, stream);
  return dispatch<T, 256, kSeg>(kernel, a, stream);
}

template <bool kSeg>
int run(int kernel, const Args& a, int dtype, void* stream) {
  if (a.b <= 0 || a.s <= 0 || a.h <= 0 || a.hkv <= 0 || a.h % a.hkv ||
      a.h / a.hkv > kRows || a.d <= 0 || a.d > 256 || a.b > 65535 ||
      a.hkv > 65535 || a.mask_b < 0 ||
      (kSeg && (a.q_seg == nullptr || a.kv_seg == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, kSeg>(kernel, a, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kSeg>(kernel, a, st);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, int b, int s,
               int h, int hkv, int d, float scale, int causal) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask_b = 1;
  a.b = b;
  a.s = s;
  a.h = h;
  a.hkv = hkv;
  a.d = d;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace
