// Flash attention on [batch, seq, heads, head_dim] ("bshd") for Hopper
// (sm_90a): the forward (K1) and the two backward kernels (K2: dQ, dK/dV)
// of the fused_attention op's saved-residual path, without a mask or with
// a factored padding mask, and the forward under a dense head-broadcast
// mask (K1-dense). The kernel bodies, their contract and design are in
// flash_kernels.cuh (shared with the segment kernels, K5, and the
// per-head kernels, K6).
//
// Replaces (paddle_tpu/ops/pallas_attention.py):
//   K1     _flash_fwd_bshd (pallas_call at line 616, kernel
//          _fwd_kernel_bshd): O and the row logsumexp Lse;
//   K1-dense  the same pallas_call with a dense [b|1, 1, s, s] mask
//          (lines 606-614): O and Lse (the reference saves no Lse there;
//          the op keeps it);
//   K2-dQ  _flash_bwd_bshd's first pallas_call (line 959, kernel
//          _bwd_dq_kernel_bshd);
//   K2-dKV _flash_bwd_bshd's second pallas_call (line 977, kernel
//          _bwd_dkv_kernel_bshd).
// k_valid [mb, s] bytes (optional): key j of batch row bi is visible iff
// k_valid[bi % mb][j] != 0. The dense mask [mb, 1, s, s] bytes: key j is
// visible to query i of batch row bi iff mask[bi % mb][0][i][j] != 0.
//
// Bound on the H100: at the training slice's shape (b16 s1024 h8 d64,
// bf16, causal) K1 does ~17 GFLOP on 67 MB of inputs and outputs, 250
// FLOP per byte, so at the tensor-core rate the bytes bound it (~0.021
// ms). K2-dQ (~26 GFLOP on 88 MB) is bound by its bytes too (0.026 ms),
// K2-dKV (~34 GFLOP) by its products (0.035 ms). Under bf16 at head_dim <=
// 128 K1, K1-dense and K2 run on the tensor cores (flash_mma.cuh: mma.sync
// fed by ldmatrix from cp.async-staged bf16 tiles; the forward's online
// softmax on the score accumulators; P and dS as register operands split
// into hi and lo bf16 halves so they stay near the fp32 of the TPU
// kernels); their own limit is mma.sync's share of the tensor-core rate
// and the hi/lo products (1.5x the tensor work in K1 and dK/dV, 1.33x in
// dQ). K1-dense at the prefix-LM step (b16 s1024 h8 d64 bf16, not causal,
// prefixes of 128-896) sees about two thirds of all pairs: ~21 GFLOP on
// ~88 MB (the 16 MiB mask counted once), so its bytes bound it (0.026
// ms); it visits every key tile (256 of a head against the causal K1's
// 136) and reads each score's mask byte from a [64 x 64] byte tile that
// rides in the copy ring beside K and V. In fp32 or at head_dim > 128
// the forwards and K2 do their products in fp32 on the CUDA cores (67
// TFLOP/s peak), so their own bound is the fp32 rate.

#include "flash_kernels.cuh"

// dtype: 0 = float32, 1 = bfloat16. mask_b: rows of k_valid (0 = none).
// Each returns a cudaError_t (0 = success); launches on `stream` and never
// synchronises.
extern "C" int paddle_flash_fwd(const void* q, const void* k, const void* v,
                                const void* k_valid, int mask_b, void* out,
                                void* lse, int b, int s, int h, int hkv,
                                int d, float scale, int causal, int dtype,
                                void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run<kMaskValid, false>(kFwd, a, dtype, stream);
}

// mask: [mask_b, 1, s, s] bytes, mask_b in {1, b}; no backward kernel
// takes it (the op recomputes a dense mask's backward).
extern "C" int paddle_flash_fwd_dense(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      int mask_b, int mask_h, void* out,
                                      void* lse, int b, int s, int h,
                                      int hkv, int d, float scale,
                                      int causal, int dtype, void* stream) {
  Args a = dense_args(q, k, v, mask, mask_b, mask_h, b, s, h, hkv, d, scale,
                      causal);
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  return run<kMaskDense, false>(kFwd, a, dtype, stream);
}

extern "C" int paddle_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* o_grad,
                                   const void* lse, const void* delta,
                                   const void* k_valid, int mask_b, void* dq,
                                   int b, int s, int h, int hkv, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return run<kMaskValid, false>(kDq, a, dtype, stream);
}

extern "C" int paddle_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* o_grad,
                                    const void* lse, const void* delta,
                                    const void* k_valid, int mask_b,
                                    void* dk, void* dv, int b, int s, int h,
                                    int hkv, int d, float scale, int causal,
                                    int dtype, void* stream) {
  Args a = padded_args(q, k, v, k_valid, mask_b, b, s, h, hkv, d, scale,
                       causal);
  a.o_grad = o_grad;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return run<kMaskValid, false>(kDkv, a, dtype, stream);
}

// kernel: 0 = K1 (mask 0) or K1-dense (mask 2), 1 = K2-dQ, 2 = K2-dKV;
// mask: 0 = none or k_valid, 2 = dense; dtype as above (the bf16 bodies at
// head_dim <= 128 are the tensor-core ones)
extern "C" size_t paddle_flash_smem_bytes(int kernel, int mask, int d,
                                          int dtype) {
  return smem_bytes<false>(kernel, mask, d, dtype);
}

extern "C" const char* paddle_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
