// Fused Adam for Hopper (sm_90a): one launch updates every parameter of a
// model (K4).
//
// Replaces paddle_tpu/ops/pallas_optimizer.py: fused_adam_flat
// (pallas_call at line 85, kernel _kernel at line 42), which runs one Adam
// pass over flat fp32 buffers with the bias-corrected step size lr_t and
// the gradient factor gscale (loss-scale unscale x global-norm clip) as
// scalars in SMEM.
//
// The TPU kernel's flat [rows, 1024] view comes from the TPU's lane
// tiling; on this card the concatenation and split around it would move
// about three times the update's own bytes. So this kernel reads each
// tensor where it lies: a table of per-tensor pointers (p, g, m1, m2;
// [4][n] int64) and prefix offsets ([n + 1] int64), which the wrapper
// copies to the device once per step, and a grid over the total element
// count. It writes p, m1 and m2 into three flat buffers, one allocation
// each, which the wrapper hands back as per-tensor views. A block takes
// kChunk consecutive elements and finds the tensor holding its first one
// by a binary search over the offsets. Nearly every chunk lies inside one
// tensor: the block then reads that tensor's pointers once and moves 16
// bytes per access (where the tensor's offset allows), all of a thread's
// loads in flight together. A chunk across a tensor boundary goes element
// by element. lr_t and gscale are device scalars read from memory (no
// host sync to fetch them).
//
// The arithmetic is _kernel's, token for token, each operation rounded on
// its own (__fmul_rn & co. keep nvcc from contracting a multiply and an
// add into an FMA), so the result equals the plain PyTorch version's,
// which runs one eager kernel per operation. Outputs go to fresh tensors.
//
// Bound on the H100: 28 bytes per element (16 read, 12 written) and ~12
// FLOP, so the bytes bound it: 71,153,920 parameters of the flagship LM
// are 1.99 GB, 0.595 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;
enum { kP, kG, kM1, kM2, kCols };

struct Hyper {
  float gs, lr_t, beta1, one_minus_beta1, beta2, one_minus_beta2, epsilon;
};

// one element of _kernel, each operation rounded on its own
__device__ __forceinline__ void adam(float p, float gr, float m1, float m2,
                                     const Hyper& h, float* po, float* m1o,
                                     float* m2o) {
  const float g = __fmul_rn(gr, h.gs);
  *m1o = __fadd_rn(__fmul_rn(h.beta1, m1), __fmul_rn(h.one_minus_beta1, g));
  *m2o = __fadd_rn(__fmul_rn(h.beta2, m2),
                   __fmul_rn(__fmul_rn(h.one_minus_beta2, g), g));
  *po = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr_t, *m1o),
                               __fadd_rn(__fsqrt_rn(*m2o), h.epsilon)));
}

__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const int64_t* __restrict__ table, int n, int64_t total,
                  const float* __restrict__ lr_t_ptr,
                  const float* __restrict__ gscale_ptr,
                  float* __restrict__ po, float* __restrict__ m1o,
                  float* __restrict__ m2o, float beta1,
                  float one_minus_beta1, float beta2, float one_minus_beta2,
                  float epsilon) {
  const int64_t* offs = table + (size_t)kCols * n;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  // the last tensor t with offs[t] <= c0
  int t = 0, hi = n - 1;
  while (t < hi) {
    const int mid = (t + hi + 1) >> 1;
    if (offs[mid] <= c0) t = mid;
    else hi = mid - 1;
  }
  const Hyper h = {*gscale_ptr, *lr_t_ptr, beta1, one_minus_beta1, beta2,
                   one_minus_beta2, epsilon};
  if (c0 + kChunk <= offs[t + 1]) {
    // the common case: the whole chunk lies in tensor t, so its four
    // pointers are the block's; with 16-byte alignment, float4 accesses,
    // every load of the thread issued before the first use (the outputs
    // are flat: c0 is a multiple of kChunk)
    const int64_t i0 = c0 - offs[t];
    const float* p = reinterpret_cast<const float*>(table[kP * n + t]);
    const float* gr = reinterpret_cast<const float*>(table[kG * n + t]);
    const float* m1 = reinterpret_cast<const float*>(table[kM1 * n + t]);
    const float* m2 = reinterpret_cast<const float*>(table[kM2 * n + t]);
    bool vec = (i0 & 3) == 0;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      vec = vec && (table[c * n + t] & 15) == 0;
    if (vec) {
      constexpr int kVec = kPerThread / 4;
      float4 pv[kVec], gv[kVec], av[kVec], bv[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t i = i0 + ((int64_t)k * kThreads + threadIdx.x) * 4;
        pv[k] = *reinterpret_cast<const float4*>(p + i);
        gv[k] = *reinterpret_cast<const float4*>(gr + i);
        av[k] = *reinterpret_cast<const float4*>(m1 + i);
        bv[k] = *reinterpret_cast<const float4*>(m2 + i);
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t e = c0 + ((int64_t)k * kThreads + threadIdx.x) * 4;
        float4 x, y, z;
        adam(pv[k].x, gv[k].x, av[k].x, bv[k].x, h, &x.x, &y.x, &z.x);
        adam(pv[k].y, gv[k].y, av[k].y, bv[k].y, h, &x.y, &y.y, &z.y);
        adam(pv[k].z, gv[k].z, av[k].z, bv[k].z, h, &x.z, &y.z, &z.z);
        adam(pv[k].w, gv[k].w, av[k].w, bv[k].w, h, &x.w, &y.w, &z.w);
        *reinterpret_cast<float4*>(po + e) = x;
        *reinterpret_cast<float4*>(m1o + e) = y;
        *reinterpret_cast<float4*>(m2o + e) = z;
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t j = (int64_t)k * kThreads + threadIdx.x;
      const int64_t i = i0 + j;
      adam(p[i], gr[i], m1[i], m2[i], h, po + c0 + j, m1o + c0 + j,
           m2o + c0 + j);
    }
    return;
  }
  // a chunk across tensor boundaries (or the ragged end): element by
  // element, each finding its tensor from the one before
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t e = c0 + (int64_t)k * kThreads + threadIdx.x;
    if (e >= total) break;
    while (e >= offs[t + 1]) ++t;
    const int64_t i = e - offs[t];
    adam(reinterpret_cast<const float*>(table[kP * n + t])[i],
         reinterpret_cast<const float*>(table[kG * n + t])[i],
         reinterpret_cast<const float*>(table[kM1 * n + t])[i],
         reinterpret_cast<const float*>(table[kM2 * n + t])[i], h, po + e,
         m1o + e, m2o + e);
  }
}

}  // namespace

// table: device int64 [4 * n] pointers (p, g, m1, m2, each [n]) then
// [n + 1] prefix offsets; total = offsets[n] > 0. lr_t, gscale: device
// fp32 scalars. p_out, m1_out, m2_out: flat fp32 [total]. Returns a
// cudaError_t (0 = success); launches on `stream` and never synchronises.
extern "C" int paddle_fused_adam(const void* table, int n, long long total,
                                 const void* lr_t, const void* gscale,
                                 void* p_out, void* m1_out, void* m2_out,
                                 float beta1, float one_minus_beta1,
                                 float beta2, float one_minus_beta2,
                                 float epsilon, void* stream) {
  if (n <= 0 || total <= 0 || (total + kChunk - 1) / kChunk > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kChunk - 1) / kChunk);
  fused_adam_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(table), n, (int64_t)total,
      static_cast<const float*>(lr_t), static_cast<const float*>(gscale),
      static_cast<float*>(p_out), static_cast<float*>(m1_out),
      static_cast<float*>(m2_out), beta1, one_minus_beta1, beta2,
      one_minus_beta2, epsilon);
  return (int)cudaGetLastError();
}

extern "C" const char* paddle_fused_adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
