// Paged decode attention for Hopper (sm_90a): one query token per slot
// attends over that slot's KV pages in a shared pool.
//
// Replaces: paddle_tpu/ops/pallas_paged_attention.py::paged_flash_decode
// (the Pallas TPU kernel _make_kernel, pallas_call at line 239), for
// full-precision pools (K3) and for quantized pools (K3-quant, the same
// pallas_call built with quant_group, lines 102-137 and 210-224). Same
// contract:
//   q          [S, H, D]            fp32 | bf16
//   k/v pools  [P+1, page, KVH, D]  same dtype as q (K3), or int8 |
//                                   float8_e4m3fn (K3-quant)
//   k/v scales [P+1, G, KVH]        fp32, G = page / group (K3-quant only)
//   page_table [S, MP]              int32 page ids in sequence order
//   lengths    [S]                  int32; positions < max(len, 1) are live
//   out        [S, H, D]            q's dtype, acc / max(l, 1e-30)
// GQA: H % KVH == 0, group = H / KVH. head_dim <= 256 and a multiple of 8;
// q and the pools 16-byte aligned (the wrapper checks both). A quantized
// token t of page p for kv head h dequantizes as
// float(x) * scale[p, t / group, h].
//
// Bound on the H100: memory. Per call the kernel must read the live K/V
// rows (len x KVH x D x 2 tensors per slot) plus q, the live page-table
// entries and the lengths, and write out; at the serving slice's shapes
// (KVH 8, D 64, bf16) that is 2 KiB per cached token per layer, over
// 3.35 TB/s. The arithmetic is 4 flops per K/V element, far below the
// card's ratio of flops to bytes, so the design is about keeping many
// loads in flight on every SM, whatever the lengths of the slots.
//
// Design: the live window split across blocks, merged in the same launch.
// - Grid (kv head x head chunk, slot, split). A split is a fixed chunk of
//   the page table, `split_pages` pages (the wrapper's plan: ~512 tokens
//   of fp32/bf16 pools, ~128 of one-byte pools, at most 32 pages); their
//   number comes from the table's width, so the host reads no length.
//   The split is the grid's slowest axis, so every slot's first split,
//   which always has work, is dispatched first. A block whose chunk
//   starts at or past the slot's live frontier max(len, 1) returns at
//   once. One block serves up
//   to kG (1, 2, 4 or 8) query heads that share a kv head, so each K/V
//   row is read once per kG heads (the fold of the Pallas einsum reshape,
//   lines 138-142); larger groups take several head chunks.
// - Within a split each of the 4 warps walks its own tiles of `tile_rows`
//   tokens (4 KiB of K, as many of V; at most 32 rows), tile w, w + 4, ...
//   of the chunk, through a warp-private cp.async ring of one or two
//   stages (two when a warp has more than one tile): the next tile is in
//   flight while the current one is scored and accumulated, and no
//   block-wide barrier runs per tile. The lanes copy whole rows together
//   (8 elements a copy: 16 bytes of bf16, so 8 lanes per D = 64 row and 4
//   rows per warp instruction), each row's address found through the
//   page table, whose entries for the chunk the lanes hold in registers.
//   Rows are padded by 16 bytes so a lane per row reads distinct banks.
// - Per tile: one lane per token dots its K row with the block's q (fp32
//   in shared memory, read by broadcast); the warp folds the tile into
//   its running max m, sum l (fp32, per query head) with two shuffle
//   reductions; the weights go to a 32-wide warp-private row, and P.V
//   gives each lane 8 columns of a strided subset of the tile's rows,
//   its acc [kG][8] in registers for the whole walk.
// - End of a split: the four warps' (m, l, acc) are combined once in
//   shared memory. If the slot's live window is one split, the block
//   writes out. Otherwise it writes its partial (m, l, acc[kG][D]) to a
//   workspace, fences, and takes a ticket from a per-(slot, block row)
//   counter; the block that draws the last ticket merges the live
//   partials in split order, writes out and resets the counter to 0 for
//   the next call. The workspace and the counters come from the
//   wrapper (PyTorch's caching allocator, the counters zeroed once per
//   buffer): one launch per call, no allocation here.
// The order of the sums differs from the plain version's and from one
// split plan to another, not from run to run.
//
// K3-quant is the same kernel body, instantiated with the pool's storage
// type (KV = int8_t or __nv_fp8_e4m3; K3 is KV = T, and its code is
// unchanged by the quantized branches, which are compile-time); the
// tile's K and V scales ride in the ring beside its rows. Its bound is
// the same walk at one byte per element: about half of bf16 K3's bytes,
// plus one fp32 scale per (page, group, kv head). A token's scale is
// constant along its K and V rows, so the kernel FOLDS the scales instead
// of scaling D elements: the score is dot(q, k_raw) * k_scale * softmax
// scale, and the weight stored for P.V is exp(score - m) * v_scale (the
// softmax sum l takes the unscaled exp). This reorders products only
// (s * sum(q k) for sum(q (k s))); a virgin group (scale 0) gives exact
// zeros, as the TPU kernel's dequant does.
//
// Launch count on the device: the first thread of block (0, 0, 0) adds one
// to a module counter per launch (K3 and K3-quant apart), which
// paddle_paged_decode_device_launches reads. A launch inside a CUDA graph
// counts each time the graph runs it, a conditional node's body included,
// where a profiler may record one execution of each body node per graph
// launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;              // elements per staged copy and load
constexpr int kMaxDim = 256;
constexpr int kTileBytes = 4096;     // K bytes of one warp tile (V as many)
constexpr int kRowPad = 16;          // bytes after each staged row
constexpr int kMaxSplitPages = 32;   // page ids a warp holds in its lanes
constexpr float kNegInf = -1e30f;

// launches that ran on the device: [0] K3, [1] K3-quant
__device__ unsigned long long g_launches[2];

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// one-byte storage of quantized pools: 8 elements are 8 bytes (rows are a
// multiple of 8 bytes, so every 8-element offset is 8-byte aligned)
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const int2 raw = *reinterpret_cast<const int2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_storage_t* h =
      reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // exact: every e4m3 value is a half
    const __half2 hv(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3));
    const float2 f = __half22float2(hv);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 elements of a pool row into shared memory: 32 bytes of fp32, 16 of
// bf16, 8 of a one-byte type
template <typename KV>
__device__ __forceinline__ void copy8(void* dst, const KV* src) {
  constexpr int kBytes = kVec * sizeof(KV);
  if constexpr (kBytes == 32) {
    cp_async<16>(dst, src);
    cp_async<16>(static_cast<unsigned char*>(dst) + 16, src + 4);
  } else {
    cp_async<kBytes>(dst, src);
  }
}

// query heads per block for a group of `group` heads
__host__ __device__ constexpr int heads_per_block(int group) {
  return group >= 5 ? 8 : group >= 3 ? 4 : group;
}

// the shared-memory plan of one block, the same on host and device:
// q [kG][D] fp32, the warps' weights [kWarps][kG][32], their (m, l)
// [kWarps][2][kG], a flag, then the warps' rings (each `stages` stages of
// K rows, V rows [tile][row_bytes] and, quantized, K and V scales
// [2][tile]), which the end of the split reuses for the combine
// [kWarps][32][kG][kVec] fp32
struct Plan {
  int kg, tile, stages, row_bytes, stage_bytes;
  size_t header, smem;
};

__host__ __device__ inline Plan make_plan(int group, int head_dim,
                                          int kv_bytes, bool quant, int page,
                                          int split_pages) {
  Plan p;
  p.kg = heads_per_block(group);
  const int row = head_dim * kv_bytes;
  p.tile = kTileBytes / row < 1 ? 1 : kTileBytes / row > 32 ? 32
                                                             : kTileBytes / row;
  p.row_bytes = row + kRowPad;
  p.stage_bytes =
      (2 * p.tile * p.row_bytes + (quant ? 2 * p.tile * 4 : 0) + 15) / 16 * 16;
  const int tiles = (split_pages * page + p.tile - 1) / p.tile;
  p.stages = (tiles + kWarps - 1) / kWarps > 1 ? 2 : 1;
  p.header = (sizeof(float) * ((size_t)p.kg * head_dim + kWarps * p.kg * 32 +
                               kWarps * 2 * p.kg) +
              sizeof(int) + 15) / 16 * 16;
  const size_t ring = (size_t)kWarps * p.stages * p.stage_bytes;
  const size_t red = sizeof(float) * kWarps * 32 * p.kg * kVec;
  p.smem = p.header + (ring > red ? ring : red);
  return p;
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* lengths;
  void* out;
  float* part;        // [S][block rows][splits][2 kG + kG D] (splits > 1)
  int* tickets;       // [S][block rows], zero between calls (splits > 1)
  int heads, kv_heads, head_dim, page, quant_group, max_pages, pool_pages;
  int split_pages, splits, tile, stages, row_bytes, stage_bytes, header;
  float scale;
};

// T: q and out; KV: the pools (T for K3; int8_t or __nv_fp8_e4m3 for
// K3-quant, which also reads k_scale / v_scale [pool_pages][G][KVH]);
// kG: query heads per block
template <typename T, typename KV, int kG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(Params p) {
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.head_dim;
  const int U = D / kVec;                  // 8-element units of a row
  const int group = p.heads / p.kv_heads;
  const int chunks = (group + kG - 1) / kG;
  const int split = blockIdx.z;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * group + (blockIdx.x % chunks) * kG;
  const int gn = min(kG, group - (blockIdx.x % chunks) * kG);
  const int s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.split_pages * p.page;    // tokens of a split
  const int c0 = split * C;

  float* q_s = reinterpret_cast<float*>(smem_raw);     // [kG][D]
  float* p_w = q_s + kG * D + warp * kG * 32;          // this warp's [kG][32]
  float* w_s = q_s + kG * D + kWarps * kG * 32;        // [kWarps][2][kG]
  int* flag = reinterpret_cast<int*>(w_s + kWarps * 2 * kG);
  unsigned char* ring = smem_raw + p.header;

  // the length, this split's page ids (lane i holding page split *
  // split_pages + i) and q are loaded together, before the length decides
  // whether the block has work
  const int* pt = p.page_table + (size_t)s * p.max_pages +
                  (size_t)split * p.split_pages;
  int pid = 0;
  if (lane < p.split_pages && split * p.split_pages + lane < p.max_pages)
    pid = min(max(pt[lane], 0), p.pool_pages - 1);
  // the block's query heads h0 .. h0 + gn - 1 are contiguous in q and out
  const size_t qo_base = ((size_t)s * p.heads + h0) * D;
  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < kG * D; i += kThreads)
    q_s[i] = i < gn * D ? to_float(q[qo_base + i]) : 0.f;
  // positions < max(len, 1) are live (the reference clamps len >= 1);
  // positions past the table's reach do not exist
  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0)
    atomicAdd(&g_launches[kQuant ? 1 : 0], 1ULL);
  const int len = min(max(p.lengths[s], 1), p.max_pages * p.page);
  if (c0 >= len) return;
  const int n = min(C, len - c0);          // live tokens of the split
  __syncthreads();

  const KV* k_pool = static_cast<const KV*>(p.k_pool);
  const KV* v_pool = static_cast<const KV*>(p.v_pool);
  const int TW = p.tile, RS = p.row_bytes;
  const int n_tiles = (n + TW - 1) / TW;
  const int my_tiles =
      n_tiles > warp ? (n_tiles - warp + kWarps - 1) / kWarps : 0;
  unsigned char* wring = ring + (size_t)warp * p.stages * p.stage_bytes;
  const long long tok_stride = (long long)p.kv_heads * D;
  const int n_groups = kQuant ? p.page / p.quant_group : 1;

  // warp tile j (rows j * TW ... of the split) into stage st, one copy
  // group per lane; rows past n are not copied
  auto issue = [&](int j, int st) {
    unsigned char* ks = wring + st * p.stage_bytes;
    unsigned char* vs = ks + TW * RS;
    const int r0 = j * TW;
    const int rows = min(TW, n - r0);
    const int units = rows * U;
    for (int k0 = 0; k0 < units; k0 += 32) {   // the same trips per lane
      const int k = min(k0 + lane, units - 1);
      const int r = k / U;
      const int t = r0 + r;
      const int id = __shfl_sync(0xffffffffu, pid, t / p.page);
      if (k0 + lane < units) {
        const int u = k - r * U;
        const long long off =
            ((long long)id * p.page + t % p.page) * tok_stride +
            (long long)kvh * D + u * kVec;
        const int dst = r * RS + u * kVec * (int)sizeof(KV);
        copy8(ks + dst, k_pool + off);
        copy8(vs + dst, v_pool + off);
      }
    }
    if constexpr (kQuant) {
      float* sc = reinterpret_cast<float*>(vs + TW * RS);   // [2][TW]
      const int t = r0 + min(lane, rows - 1);
      const int id = __shfl_sync(0xffffffffu, pid, t / p.page);
      if (lane < rows) {
        const long long so =
            ((long long)id * n_groups + (t % p.page) / p.quant_group) *
                p.kv_heads + kvh;
        cp_async<4>(sc + lane, p.k_scale + so);
        cp_async<4>(sc + TW + lane, p.v_scale + so);
      }
    }
    cp_async_commit();
  };

  // P.V: lane = (unit pu, row group prg); RG row groups take every RG-th
  // row of a tile
  const int RG = 32 / U;
  const int pu = lane % U, prg = lane / U;
  const bool pv_lane = prg < RG;
  float m[kG], l[kG], acc[kG][kVec];
#pragma unroll
  for (int h = 0; h < kG; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[h][e] = 0.f;
  }

  if (my_tiles > 0) issue(warp, 0);
  if (p.stages > 1 && my_tiles > 1) issue(warp + kWarps, 1);
  for (int it = 0; it < my_tiles; ++it) {
    const int st = p.stages > 1 ? (it & 1) : 0;
    if (p.stages > 1 && it + 1 < my_tiles)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    const int rows = min(TW, n - (warp + it * kWarps) * TW);
    const unsigned char* ks = wring + st * p.stage_bytes;
    const unsigned char* vs = ks + TW * RS;
    const float* sc = reinterpret_cast<const float*>(vs + TW * RS);

    // scores: lane r takes row r
    float x[kG];
    if (lane < rows) {
      float dot[kG];
#pragma unroll
      for (int h = 0; h < kG; ++h) dot[h] = 0.f;
      const KV* krow = reinterpret_cast<const KV*>(ks + lane * RS);
#pragma unroll 4
      for (int u = 0; u < U; ++u) {
        float kf[kVec];
        load8(krow + u * kVec, kf);
#pragma unroll
        for (int h = 0; h < kG; ++h) {
          const float* qq = q_s + h * D + u * kVec;
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot[h] += qq[e] * kf[e];
        }
      }
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        if constexpr (kQuant)
          x[h] = dot[h] * sc[lane] * p.scale;
        else
          x[h] = dot[h] * p.scale;
      }
    } else {
#pragma unroll
      for (int h = 0; h < kG; ++h) x[h] = -INFINITY;
    }

    // online softmax per query head, over the warp
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      const float m_new = fmaxf(m[h], warp_max(x[h]));
      const float e = lane < rows ? expf(x[h] - m_new) : 0.f;
      const float alpha = expf(m[h] - m_new);
      l[h] = l[h] * alpha + warp_sum(e);
      m[h] = m_new;
      if constexpr (kQuant)
        p_w[h * 32 + lane] = lane < rows ? e * sc[TW + lane] : 0.f;
      else
        p_w[h * 32 + lane] = e;
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[h][c] *= alpha;
    }
    __syncwarp();

    // acc += P V over the tile's rows
    if (pv_lane) {
      for (int r = prg; r < rows; r += RG) {
        float vf[kVec];
        load8(reinterpret_cast<const KV*>(vs + r * RS) + pu * kVec, vf);
#pragma unroll
        for (int h = 0; h < kG; ++h) {
          const float w = p_w[h * 32 + r];
#pragma unroll
          for (int c = 0; c < kVec; ++c) acc[h][c] += w * vf[c];
        }
      }
    }
    __syncwarp();   // the stage and the weights are rewritten next
    if (it + p.stages < my_tiles) issue(warp + (it + p.stages) * kWarps, st);
  }

  // the four warps' states, combined in shared memory
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      w_s[(warp * 2) * kG + h] = m[h];
      w_s[(warp * 2 + 1) * kG + h] = l[h];
    }
  }
  __syncthreads();   // every warp is done with the rings
  float* red = reinterpret_cast<float*>(ring);   // [kWarps][32][kG][kVec]
#pragma unroll
  for (int h = 0; h < kG; ++h)
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      red[((warp * 32 + lane) * kG + h) * kVec + c] =
          pv_lane ? acc[h][c] : 0.f;
  __syncthreads();

  const bool single = len <= C;   // the slot's whole window is this split
  T* out = static_cast<T*>(p.out) + qo_base;
  const int rec = kG * (2 + D);   // a partial: m [kG], l [kG], acc [kG][D]
  const size_t row_id = (size_t)s * gridDim.x + blockIdx.x;
  float* mine = p.part + (row_id * p.splits + split) * rec;
  for (int i = tid; i < gn * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_s[w * 2 * kG + h]);
    float a = 0.f, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(w_s[w * 2 * kG + h] - mx);
      float part = 0.f;
      for (int rg = 0; rg < RG; ++rg)
        part += red[((w * 32 + rg * U + d / kVec) * kG + h) * kVec +
                    d % kVec];
      a += f * part;
      sum += f * w_s[(w * 2 + 1) * kG + h];
    }
    if (single) {
      store(a / fmaxf(sum, 1e-30f), out + i);
    } else {
      mine[2 * kG + i] = a;
      if (d == 0) {
        mine[h] = mx;
        mine[kG + h] = sum;
      }
    }
  }
  if (single) return;

  // the last live split of the slot to finish merges the partials
  const int n_live = (len + C - 1) / C;
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(p.tickets + row_id, 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // one pass in split order, the running max rescaling (m, l, acc) as
  // the online softmax does; the loads of several splits in flight
  const float* recs = p.part + row_id * p.splits * rec;
  for (int i = tid; i < gn * D; i += kThreads) {
    const int h = i / D;
    float mx = kNegInf, a = 0.f, sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_live; ++j) {
      const float* r = recs + j * rec;
      const float mj = __ldcg(r + h), lj = __ldcg(r + kG + h);
      const float aj = __ldcg(r + 2 * kG + i);
      const float m_new = fmaxf(mx, mj);
      const float c = expf(mx - m_new), f = expf(mj - m_new);
      sum = sum * c + f * lj;
      a = a * c + f * aj;
      mx = m_new;
    }
    store(a / fmaxf(sum, 1e-30f), out + i);
  }
  if (tid == 0) p.tickets[row_id] = 0;
}

template <typename T, typename KV, int kG>
int launch_g(const Params& p, size_t smem, int slots, cudaStream_t stream) {
  // the whole carve-out for shared memory, so that as many blocks fit on
  // an SM as their bytes allow (set once per instance)
  static bool carved = false;
  if (!carved) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, kG>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    carved = true;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV, kG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int group = p.heads / p.kv_heads;
  dim3 grid(p.kv_heads * ((group + kG - 1) / kG), slots, p.splits);
  paged_decode_kernel<T, KV, kG><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const void* page_table, const void* lengths, void* out,
           void* part, void* tickets, int slots, int heads, int kv_heads,
           int head_dim, int page, int quant_group, int max_pages,
           int pool_pages, int split_pages, float scale,
           cudaStream_t stream) {
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  const Plan pl = make_plan(heads / kv_heads, head_dim, (int)sizeof(KV),
                            kQuant, page, split_pages);
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.page_table = static_cast<const int*>(page_table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.head_dim = head_dim;
  p.page = page;
  p.quant_group = quant_group;
  p.max_pages = max_pages;
  p.pool_pages = pool_pages;
  p.split_pages = split_pages;
  p.splits = (max_pages + split_pages - 1) / split_pages;
  p.tile = pl.tile;
  p.stages = pl.stages;
  p.row_bytes = pl.row_bytes;
  p.stage_bytes = pl.stage_bytes;
  p.header = (int)pl.header;
  p.scale = scale;
  if (p.splits > 1 && (part == nullptr || tickets == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (pl.kg) {
    case 1: return launch_g<T, KV, 1>(p, pl.smem, slots, stream);
    case 2: return launch_g<T, KV, 2>(p, pl.smem, slots, stream);
    case 4: return launch_g<T, KV, 4>(p, pl.smem, slots, stream);
    default: return launch_g<T, KV, 8>(p, pl.smem, slots, stream);
  }
}

int block_rows(int heads, int kv_heads) {
  const int group = heads / kv_heads;
  const int kg = heads_per_block(group);
  return kv_heads * ((group + kg - 1) / kg);
}

bool bad_geometry(int slots, int heads, int kv_heads, int head_dim,
                  int page, int max_pages, int pool_pages, int split_pages) {
  return slots <= 0 || slots > 65535 || heads <= 0 || kv_heads <= 0 ||
         heads % kv_heads || head_dim <= 0 || head_dim > kMaxDim ||
         head_dim % kVec || page <= 0 || max_pages <= 0 || pool_pages <= 0 ||
         split_pages <= 0 || split_pages > kMaxSplitPages ||
         (max_pages + split_pages - 1) / split_pages > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part / tickets: the workspace and the
// ticket counters of paddle_paged_decode_workspace (unused, may be null,
// when the table is one split). Returns a cudaError_t (0 = success);
// launches on `stream` and never synchronises.
extern "C" int paddle_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool,
                                   const void* page_table,
                                   const void* lengths, void* out,
                                   void* part, void* tickets, int slots,
                                   int heads, int kv_heads, int head_dim,
                                   int page, int max_pages, int pool_pages,
                                   int split_pages, float scale, int dtype,
                                   void* stream) {
  if (bad_geometry(slots, heads, kv_heads, head_dim, page, max_pages,
                   pool_pages, split_pages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                page_table, lengths, out, part, tickets,
                                slots, heads, kv_heads, head_dim, page, 1,
                                max_pages, pool_pages, split_pages, scale,
                                st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, page_table, lengths, out, part,
        tickets, slots, heads, kv_heads, head_dim, page, 1, max_pages,
        pool_pages, split_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_quant(int kv_dtype, const void* q, const void* k_pool,
                 const void* v_pool, const void* k_scale, const void* v_scale,
                 const void* page_table, const void* lengths, void* out,
                 void* part, void* tickets, int slots, int heads,
                 int kv_heads, int head_dim, int page, int quant_group,
                 int max_pages, int pool_pages, int split_pages, float scale,
                 cudaStream_t st) {
  if (kv_dtype == 1)
    return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, page_table,
                             lengths, out, part, tickets, slots, heads,
                             kv_heads, head_dim, page, quant_group,
                             max_pages, pool_pages, split_pages, scale, st);
  if (kv_dtype == 2)
    return launch<T, __nv_fp8_e4m3>(
        q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, out, part,
        tickets, slots, heads, kv_heads, head_dim, page, quant_group,
        max_pages, pool_pages, split_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K3-quant. dtype: q/out as above; kv_dtype: 1 = int8, 2 = float8_e4m3fn.
// quant_group tokens share a scale and must divide page.
extern "C" int paddle_paged_decode_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, void* part, void* tickets, int slots,
    int heads, int kv_heads, int head_dim, int page, int quant_group,
    int max_pages, int pool_pages, int split_pages, float scale, int dtype,
    int kv_dtype, void* stream) {
  if (bad_geometry(slots, heads, kv_heads, head_dim, page, max_pages,
                   pool_pages, split_pages) ||
      quant_group <= 0 || page % quant_group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                               page_table, lengths, out, part, tickets, slots,
                               heads, kv_heads, head_dim, page, quant_group,
                               max_pages, pool_pages, split_pages, scale, st);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(
        kv_dtype, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
        out, part, tickets, slots, heads, kv_heads, head_dim, page,
        quant_group, max_pages, pool_pages, split_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

// shared memory of one block: kv_bytes is the pools' element size (4, 2
// or 1), quant whether they carry scales
extern "C" size_t paddle_paged_decode_smem_bytes(int group, int head_dim,
                                                 int kv_bytes, int quant,
                                                 int page, int split_pages) {
  return make_plan(group, head_dim, kv_bytes, quant != 0, page, split_pages)
      .smem;
}

// the workspace (fp32 elements; 0 when the table is one split) and the
// ticket counters (int32, zeroed once by the caller and left at zero by
// every call) of a call
extern "C" void paddle_paged_decode_workspace(int slots, int heads,
                                              int kv_heads, int head_dim,
                                              int max_pages, int split_pages,
                                              size_t* part, size_t* tickets) {
  const int splits = (max_pages + split_pages - 1) / split_pages;
  const int kg = heads_per_block(heads / kv_heads);
  const size_t rows = (size_t)slots * block_rows(heads, kv_heads);
  *part = splits > 1 ? rows * splits * kg * (2 + head_dim) : 0;
  *tickets = splits > 1 ? rows : 0;
}

// the device's launch counts [K3, K3-quant] into out (host memory); call
// after the launches to count have finished (it copies on the legacy
// default stream)
extern "C" int paddle_paged_decode_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
