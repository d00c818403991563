// Flash attention on the per-head layout [batch, heads, seq, head_dim]
// ("bhsd") for Hopper (sm_90a): the forward (K6-fwd, without a mask, with
// a factored padding mask, or under a dense [b|1, h|1, s, s] mask) and
// the two backward kernels (K6-dQ, K6-dKV) of the fused_attention op at
// its default layout. The kernel bodies, their contract and design are in
// flash_kernels.cuh (shared with K1/K2 and K5), instantiated with the
// bhsd layout policy.
//
// Replaces (paddle_tpu/ops/pallas_attention.py):
//   K6-fwd  _flash_fwd_dispatch's pallas_call (line 430, kernel
//           _fwd_kernel, line 243): O and Lse over [b*h, s, d] rows, GQA
//           by the kv index map; the dense mask streamed in (BQ, BK)
//           tiles, a factored mask as a k_valid row;
//   K6-dQ   _flash_bwd_dispatch's first pallas_call (line 781, kernel
//           _bwd_dq_kernel, line 630);
//   K6-dKV  its second pallas_call (line 798, kernel _bwd_dkv_kernel,
//           line 672).
// The TPU backward takes full heads (its caller repeats K/V over each
// group and sums dK/dV after); these kernels fold each kv head's query
// group into a block as K1/K2 do, so dK/dV come out at the kv heads with
// the group summed in registers and no expanded copy of K/V.
// k_valid [mb, s] bytes (optional): key j of batch row bi is visible iff
// k_valid[bi % mb][j] != 0. The dense mask [mb, mh, s, s] bytes: key j is
// visible to query i of head hd iff mask[bi % mb][hd % mh][i][j] != 0.
//
// Bound on the H100: at the bhsd training step (b16 s1024 h8 d64 bf16
// causal) the work and bytes are K1/K2's (~17 / 26 / 34 GFLOP over 67-100
// MB: the bytes bound them at the tensor-core rate); under the prefix-LM
// dense mask (not causal, prefixes of 128-896) about two thirds of all
// pairs are visible, ~21 GFLOP on ~88 MB with the mask. Under bf16 inputs
// P and dS are rounded to bf16 before each product they enter, as the
// TPU's K6 rounds them. K6-fwd, K6-fwd-dense, K6-dQ and K6-dKV under bf16
// at head_dim <= 128 run on the tensor cores (flash_mma.cuh's bodies: S
// (and dP) summed in fp64 on the FP64 tensor cores and rounded to fp32
// once, so that the roundings of P and dS do not follow a summation
// order, then the products after them with bf16 operands); their own
// bound is the FP64 tensor-core rate (67 TFLOP/s: ~0.26 ms for each
// backward kernel and ~0.14 ms for the causal forward at the step's
// shape; ~0.26 ms for the dense-mask forward, which computes S for all
// 256 key tiles of a head). The dense-mask forward stages one mask row
// per block row (flash_mma.cuh). fp32 and head_dim > 128 run their
// products in fp32 on the CUDA cores.

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16. mask_b: rows of k_valid (0 = none).
// Each returns a cudaError_t (0 = success); launches on `stream` and never
// synchronises.
extern "C" int paddle_flash_bhsd_fwd(const void* q, const void* k,
                                     const void* v, const void* k_valid,
                                     int mask_b, void* out, void* lse, int b,
                                     int s, int h, int hkv, int d,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run<kMaskValid, true>(kFwd, a, dtype, stream);
}

// mask: [mask_b, mask_h, s, s] bytes, mask_b in {1, b}, mask_h in {1, h};
// no backward kernel takes it (the op recomputes a dense mask's backward).
extern "C" int paddle_flash_bhsd_fwd_dense(const void* q, const void* k,
                                           const void* v, const void* mask,
                                           int mask_b, int mask_h, void* out,
                                           void* lse, int b, int s, int h,
                                           int hkv, int d, float scale,
                                           int causal, int dtype,
                                           void* stream) {
  Args a = dense_args(q, k, v, mask, mask_b, mask_h, b, s, h, hkv, d, scale,
                      causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run<kMaskDense, true>(kFwd, a, dtype, stream);
}

// delta: [b, h, s] fp32 (rowsum(dO * O) in O's layout)
extern "C" int paddle_flash_bhsd_bwd_dq(const void* q, const void* k,
                                        const void* v, const void* o_grad,
                                        const void* lse, const void* delta,
                                        const void* k_valid, int mask_b,
                                        void* dq, int b, int s, int h,
                                        int hkv, int d, float scale,
                                        int causal, int dtype,
                                        void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return run<kMaskValid, true>(kDq, a, dtype, stream);
}

extern "C" int paddle_flash_bhsd_bwd_dkv(const void* q, const void* k,
                                         const void* v, const void* o_grad,
                                         const void* lse, const void* delta,
                                         const void* k_valid, int mask_b,
                                         void* dk, void* dv, int b, int s,
                                         int h, int hkv, int d, float scale,
                                         int causal, int dtype,
                                         void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return run<kMaskValid, true>(kDkv, a, dtype, stream);
}

// kernel: 0 = K6-fwd (mask 0) or K6-fwd-dense (mask 2), 1 = K6-dQ, 2 =
// K6-dKV; mask: 0 = none or k_valid, 2 = dense (the bf16 bodies at
// head_dim <= 128 are the tensor-core ones, of each mask kind's own
// bytes)
extern "C" size_t paddle_flash_bhsd_smem_bytes(int kernel, int mask, int d,
                                               int dtype) {
  return smem_bytes<true>(kernel, mask, d, dtype);
}

extern "C" const char* paddle_flash_bhsd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
