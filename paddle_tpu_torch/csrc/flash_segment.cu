// Packed-segment flash attention on [batch, seq, heads, head_dim] for
// Hopper (sm_90a): the forward (K5-fwd) and the two backward kernels
// (K5-dQ, K5-dKV) of the fused_attention op under QSegIds/KSegIds. The
// kernel bodies, their contract and design are in flash_kernels.cuh
// (shared with K1/K2), instantiated with kMask = kMaskSeg.
//
// Replaces (paddle_tpu/ops/pallas_attention.py):
//   K5-fwd  _flash_fwd_segment (pallas_call at line 1115, kernel
//           _seg_fwd_kernel): O and Lse under segment equality;
//   K5-dQ   _flash_bwd_segment's first pallas_call (line 1258, kernel
//           _seg_bwd_dq_kernel);
//   K5-dKV  _flash_bwd_segment's second pallas_call (line 1289, kernel
//           _seg_bwd_dkv_kernel), dK/dV at the kv heads.
// q_seg, kv_seg: [b, s] int32, non-decreasing along each row (the packer's
// contract); key j is visible to query i iff q_seg[bi][i] ==
// kv_seg[bi][j] (and j <= i when causal).
//
// What the TPU kernel does with scalar-prefetched block windows
// (segment_mask.segment_block_windows, 256-wide blocks, computed outside
// the kernel) these kernels do inside each block, at their own tile
// sizes: two binary searches over the row's ids give the keys (for dK/dV
// the queries) that the block can see, and the tile loop walks only
// those. No extra launch per layer.
//
// Bound on the H100: at the packed training step's shape (b16 s1024 h8
// d64 bf16 causal, 3-4 documents per row) the mask leaves ~37% of the
// causal pairs visible: ~6.3 / 9.4 / 12.6 GFLOP against ~71 / 89 / 105 MB
// of inputs and outputs, so the bytes bound all three (~0.02-0.03 ms).
// Under bf16 at head_dim <= 128 the backward (K5-dQ, K5-dKV) runs on the
// tensor cores (flash_mma.cuh's kMaskSeg bodies: S and dP summed in fp32
// by mma.sync, P and dS as hi + lo bf16 halves, as K2's); the forward,
// fp32 and head_dim > 128 run their products in fp32 on the CUDA cores.
// The skip cuts the work to the tiles that straddle or lie inside a
// segment.

#include "flash_kernels.cuh"

namespace {

Args segment_args(const void* q, const void* k, const void* v,
                  const void* q_seg, const void* kv_seg, int b, int s, int h,
                  int hkv, int d, float scale, int causal) {
  Args a = make_args(q, k, v, b, s, h, hkv, d, scale, causal);
  a.q_seg = static_cast<const int*>(q_seg);
  a.kv_seg = static_cast<const int*>(kv_seg);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 =
// success); launches on `stream` and never synchronises.
extern "C" int paddle_flash_segment_fwd(const void* q, const void* k,
                                        const void* v, const void* q_seg,
                                        const void* kv_seg, void* out,
                                        void* lse, int b, int s, int h,
                                        int hkv, int d, float scale,
                                        int causal, int dtype,
                                        void* stream) {
  Args a = segment_args(q, k, v, q_seg, kv_seg, b, s, h, hkv, d, scale,
                        causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run<kMaskSeg, false>(kFwd, a, dtype, stream);
}

extern "C" int paddle_flash_segment_bwd_dq(
    const void* q, const void* k, const void* v, const void* o_grad,
    const void* lse, const void* delta, const void* q_seg,
    const void* kv_seg, void* dq, int b, int s, int h, int hkv, int d,
    float scale, int causal, int dtype, void* stream) {
  Args a = segment_args(q, k, v, q_seg, kv_seg, b, s, h, hkv, d, scale,
                        causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return run<kMaskSeg, false>(kDq, a, dtype, stream);
}

extern "C" int paddle_flash_segment_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o_grad,
    const void* lse, const void* delta, const void* q_seg,
    const void* kv_seg, void* dk, void* dv, int b, int s, int h, int hkv,
    int d, float scale, int causal, int dtype, void* stream) {
  Args a = segment_args(q, k, v, q_seg, kv_seg, b, s, h, hkv, d, scale,
                        causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return run<kMaskSeg, false>(kDkv, a, dtype, stream);
}

// kernel: 0 = K5-fwd, 1 = K5-dQ, 2 = K5-dKV; mask: 1 (segment ids, the
// one kind this source launches). Under bf16 at head_dim <= 128 K5-dQ
// and K5-dKV report the tensor-core bodies' bytes, K5-fwd the CUDA-core
// body's.
extern "C" size_t paddle_flash_segment_smem_bytes(int kernel, int mask,
                                                  int d, int dtype) {
  return smem_bytes<false>(kernel, mask, d, dtype);
}

extern "C" const char* paddle_flash_segment_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
