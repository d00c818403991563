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
// loads in flight.
//
// Design (simple, not yet tuned to the bound):
// - Grid (slot, kv-head). One block serves the `group` query heads that
//   share a kv head, so each K/V row is read from device memory once per
//   group (the fold of the Pallas einsum reshape, lines 138-142).
// - The block reads its own length and page ids (the TPU kernel had them
//   scalar-prefetched) and walks LIVE tokens only, in tiles of 128:
//   pages past the length frontier are never loaded or computed.
// - Online softmax: running max m, sum l and the output accumulator acc
//   stay in fp32 in shared memory for the whole walk; K/V are converted
//   to fp32 as they are loaded.
// - Per tile: (1) scores — one thread per token reads its K row in
//   16-byte vectors and dots it with the group's q (q broadcast from
//   shared memory), so 128 rows are in flight at once; (2) one warp per
//   query head folds the tile into (m, l) and turns scores into
//   weights; (3) P·V — each thread owns 8 adjacent columns for a strided
//   subset of the tile's tokens (16-byte vector loads of V), keeps up to
//   8 heads x 8 columns in registers, and a shared-memory reduction over
//   the token subsets updates acc once per tile.
// Later work: cp.async/TMA double buffering of the next tile, and
// splitting long sequences across blocks (one block per slot and kv head
// leaves SMs idle when few slots are long).
//
// K3-quant is the same kernel body, instantiated with the pool's storage
// type (KV = int8_t or __nv_fp8_e4m3; K3 is KV = T, and its code is
// unchanged by the quantized branches, which are compile-time). Its bound
// is the same walk at one byte per element: about half of bf16 K3's bytes,
// plus one fp32 scale per (page, group, kv head). A token's scale is
// constant along its K and V rows, so the kernel FOLDS the scales instead
// of scaling D elements: the score is dot(q, k_raw) * k_scale * softmax
// scale, and the weight stored for P.V is exp(score - m) * v_scale (the
// softmax sum l takes the unscaled exp). This reorders products only
// (s * sum(q k) for sum(q (k s))); a virgin group (scale 0) gives exact
// zeros, as the TPU kernel's dequant does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;    // tokens per online-softmax step
constexpr int kVec = 8;       // elements per vector load (16 B bf16, 32 B fp32)
constexpr int kGChunk = 8;    // query heads accumulated in registers at once
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;

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

// one-byte storage of quantized pools: 8 elements are 8 bytes (int8 rows of
// D = 64 are 64 bytes, so every 8-element offset is 8-byte aligned)
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

// shared memory: row offsets [kTile] (8-byte), then fp32 q [G][D],
// acc [G][D], weights [G][kTile], m/l/alpha [G], the P·V reduction
// scratch [kThreads / (D/8)][kGChunk][D] (<= 8192 floats), and for
// quantized pools the tile's V scales [kTile]
size_t smem_bytes(int group, int head_dim, bool quant) {
  const size_t lanes = kThreads / (head_dim / kVec);
  return sizeof(long long) * kTile +
         sizeof(float) * (2 * (size_t)group * head_dim +
                          (size_t)group * kTile + 3 * (size_t)group +
                          lanes * kGChunk * head_dim + (quant ? kTile : 0));
}

// T: q and out; KV: the pools (T for K3; int8_t or __nv_fp8_e4m3 for
// K3-quant, which also reads k_scale / v_scale [pool_pages][G][KVH])
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int heads, int kv_heads, int head_dim, int page,
                    int quant_group, int max_pages, int pool_pages,
                    float scale) {
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int group = heads / kv_heads;
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  long long* row_off = reinterpret_cast<long long*>(smem_raw);  // [kTile]
  float* q_s = reinterpret_cast<float*>(row_off + kTile);  // [group][D]
  float* acc = q_s + group * head_dim;                      // [group][D]
  float* p_s = acc + group * head_dim;                      // [group][kTile]
  float* m_s = p_s + group * kTile;                         // [group]
  float* l_s = m_s + group;                                 // [group]
  float* a_s = l_s + group;                                 // [group]
  float* red = a_s + group;                                 // P·V scratch
  float* vsc = red + (kThreads / (head_dim / kVec)) * kGChunk * head_dim;

  // the group's query heads h0 .. h0+group-1 are contiguous in q and out
  const size_t qo_base = ((size_t)s * heads + (size_t)kvh * group) * head_dim;
  for (int i = tid; i < group * head_dim; i += kThreads) {
    q_s[i] = to_float(q[qo_base + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // positions < max(len, 1) are live (the reference clamps len >= 1);
  // positions past the table's reach do not exist
  const int len = min(max(lengths[s], 1), max_pages * page);
  const int* pt = page_table + (size_t)s * max_pages;
  const long long tok_stride = (long long)kv_heads * head_dim;
  const int n_groups = kQuant ? page / quant_group : 1;  // scale groups/page
  // P·V work split: `cols` threads cover a row 8 columns each, `lanes`
  // such groups take every lanes-th token of the tile
  const int cols = head_dim / kVec;
  const int lanes = kThreads / cols;
  const int tl = tid / cols;
  const int c0 = (tid % cols) * kVec;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n_tile = min(kTile, len - t0);

    // (1) scores: thread j takes token t0 + j
    if (tid < n_tile) {
      const int t = t0 + tid;
      const int pid = min(max(pt[t / page], 0), pool_pages - 1);
      const long long off = ((long long)pid * page + t % page) * tok_stride +
                            (long long)kvh * head_dim;
      row_off[tid] = off;
      float ksc = 1.f;
      if constexpr (kQuant) {
        const long long s_off =
            ((long long)pid * n_groups + (t % page) / quant_group) *
                kv_heads + kvh;
        ksc = k_scale[s_off];
        vsc[tid] = v_scale[s_off];
      }
      const KV* krow = k_pool + off;
      for (int g0 = 0; g0 < group; g0 += kGChunk) {
        const int gn = min(kGChunk, group - g0);
        float dot[kGChunk];
#pragma unroll
        for (int i = 0; i < kGChunk; ++i) dot[i] = 0.f;
        for (int d0 = 0; d0 < head_dim; d0 += 8 * kVec) {
          float kf[8][kVec];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (d0 + u * kVec < head_dim) load8(krow + d0 + u * kVec, kf[u]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (d0 + u * kVec >= head_dim) break;
#pragma unroll
            for (int i = 0; i < kGChunk; ++i) {
              if (i >= gn) break;
              const float* qq = q_s + (g0 + i) * head_dim + d0 + u * kVec;
#pragma unroll
              for (int e = 0; e < kVec; ++e) dot[i] += qq[e] * kf[u][e];
            }
          }
        }
        for (int i = 0; i < gn; ++i) {
          if constexpr (kQuant)
            p_s[(g0 + i) * kTile + tid] = dot[i] * ksc * scale;
          else
            p_s[(g0 + i) * kTile + tid] = dot[i] * scale;
        }
      }
    }
    __syncthreads();

    // (2) online softmax: warp w folds query heads w, w + kWarps, ...
    for (int g = warp; g < group; g += kWarps) {
      float* pg = p_s + g * kTile;
      float x[kTile / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int j = lane + 32 * i;
        x[i] = j < n_tile ? pg[j] : kNegInf;
        mx = fmaxf(mx, x[i]);
      }
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int j = lane + 32 * i;
        const float e = j < n_tile ? expf(x[i] - m_new) : 0.f;
        if constexpr (kQuant)
          pg[j] = j < n_tile ? e * vsc[j] : 0.f;   // the V scale, folded
        else
          pg[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // (3) acc = acc * alpha + P V, kGChunk query heads at a time
    for (int g0 = 0; g0 < group; g0 += kGChunk) {
      const int gn = min(kGChunk, group - g0);
      if (tl < lanes) {
        float part[kGChunk][kVec];
#pragma unroll
        for (int i = 0; i < kGChunk; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e) part[i][e] = 0.f;
#pragma unroll 4
        for (int j = tl; j < n_tile; j += lanes) {
          float vf[kVec];
          load8(v_pool + row_off[j] + c0, vf);
#pragma unroll
          for (int i = 0; i < kGChunk; ++i) {
            if (i >= gn) break;
            const float w = p_s[(g0 + i) * kTile + j];
#pragma unroll
            for (int e = 0; e < kVec; ++e) part[i][e] += w * vf[e];
          }
        }
        for (int i = 0; i < gn; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            red[(tl * kGChunk + i) * head_dim + c0 + e] = part[i][e];
      }
      __syncthreads();
      for (int idx = tid; idx < gn * head_dim; idx += kThreads) {
        const int i = idx / head_dim;
        const int d = idx - i * head_dim;
        float sum = 0.f;
        for (int r = 0; r < lanes; ++r)
          sum += red[(r * kGChunk + i) * head_dim + d];
        float* a = acc + (g0 + i) * head_dim + d;
        *a = *a * a_s[g0 + i] + sum;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < group * head_dim; i += kThreads) {
    const float denom = fmaxf(l_s[i / head_dim], 1e-30f);
    store(acc[i] / denom, out + qo_base + i);
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale,
           const void* page_table, const void* lengths, void* out,
           int slots, int heads, int kv_heads, int head_dim, int page,
           int quant_group, int max_pages, int pool_pages, float scale,
           cudaStream_t stream) {
  const int group = heads / kv_heads;
  const size_t smem =
      smem_bytes(group, head_dim, !std::is_same<T, KV>::value);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(slots, kv_heads);
  paged_decode_kernel<T, KV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pool),
      static_cast<const KV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(page_table), static_cast<const int*>(lengths),
      static_cast<T*>(out), heads, kv_heads, head_dim, page, quant_group,
      max_pages, pool_pages, scale);
  return (int)cudaGetLastError();
}

bool bad_geometry(int slots, int heads, int kv_heads, int head_dim,
                  int page, int max_pages, int pool_pages) {
  return slots <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads ||
         head_dim <= 0 || head_dim > kMaxDim || head_dim % kVec ||
         page <= 0 || max_pages <= 0 || pool_pages <= 0 || kv_heads > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success);
// launches on `stream` and never synchronises.
extern "C" int paddle_paged_decode(const void* q, const void* k_pool,
                                   const void* v_pool,
                                   const void* page_table,
                                   const void* lengths, void* out,
                                   int slots, int heads, int kv_heads,
                                   int head_dim, int page, int max_pages,
                                   int pool_pages, float scale, int dtype,
                                   void* stream) {
  if (bad_geometry(slots, heads, kv_heads, head_dim, page, max_pages,
                   pool_pages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                page_table, lengths, out, slots, heads,
                                kv_heads, head_dim, page, 1, max_pages,
                                pool_pages, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, page_table, lengths, out, slots,
        heads, kv_heads, head_dim, page, 1, max_pages, pool_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_quant(int kv_dtype, const void* q, const void* k_pool,
                 const void* v_pool, const void* k_scale, const void* v_scale,
                 const void* page_table, const void* lengths, void* out,
                 int slots, int heads, int kv_heads, int head_dim, int page,
                 int quant_group, int max_pages, int pool_pages, float scale,
                 cudaStream_t st) {
  if (kv_dtype == 1)
    return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, page_table,
                             lengths, out, slots, heads, kv_heads, head_dim,
                             page, quant_group, max_pages, pool_pages, scale,
                             st);
  if (kv_dtype == 2)
    return launch<T, __nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale,
                                    page_table, lengths, out, slots, heads,
                                    kv_heads, head_dim, page, quant_group,
                                    max_pages, pool_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

// K3-quant. dtype: q/out as above; kv_dtype: 1 = int8, 2 = float8_e4m3fn.
// quant_group tokens share a scale and must divide page.
extern "C" int paddle_paged_decode_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, void* out, int slots, int heads, int kv_heads,
    int head_dim, int page, int quant_group, int max_pages, int pool_pages,
    float scale, int dtype, int kv_dtype, void* stream) {
  if (bad_geometry(slots, heads, kv_heads, head_dim, page, max_pages,
                   pool_pages) ||
      quant_group <= 0 || page % quant_group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_quant<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                               page_table, lengths, out, slots, heads,
                               kv_heads, head_dim, page, quant_group,
                               max_pages, pool_pages, scale, st);
  if (dtype == 1)
    return launch_quant<__nv_bfloat16>(
        kv_dtype, q, k_pool, v_pool, k_scale, v_scale, page_table, lengths,
        out, slots, heads, kv_heads, head_dim, page, quant_group, max_pages,
        pool_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" size_t paddle_paged_decode_smem_bytes(int group, int head_dim,
                                                 int quant) {
  return smem_bytes(group, head_dim, quant != 0);
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
