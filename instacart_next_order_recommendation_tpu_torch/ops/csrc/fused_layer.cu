// One post-LN BERT encoder layer forward, bf16 in and out, for Hopper.
//
// Replaces: the JAX package's ops/fused_layer.py::_kernel (the Pallas TPU
// kernel behind fused_encoder_layer and, with its two dropout-mask inputs,
// the forward of fused_encoder_layer_train), with the same function and the
// same cast points:
//   qkv = bf16(x @ Wqkv + bqkv)                     f32 accumulation
//   per head: p = exp(scale * q k^T + keybias - max) f32; z = sum(p)
//             attn = bf16((bf16(p) @ v) / z)        1/z applied after PV
//   ao  = bf16(attn @ Wo + bo) [* m1];  x1 = bf16(LN(float(bf16(x + ao))))
//   h   = bf16(gelu(x1 @ W1 + b1));  f = bf16(h @ W2 + b2) [* m2]
//   y   = bf16(LN(float(bf16(x1 + f))))
// The masks m1, m2 are {0, 1/keep} in bf16, drawn by the caller so that the
// backward (fused_layer_bwd.cu) sees the same ones; the products round to
// bf16 as the JAX kernel's do. Null masks mean no dropout. The key bias is
// -1e9 at padded keys (not -inf), so an all-pad row stays finite. GELU uses
// erff.
//
// What bounds it on the H100: at serve shapes (B*S rows in the thousands)
// the four GEMMs, 2*B*S*(4*H^2 + 2*H*I) operations, against 989 TFLOP/s of
// bf16 tensor cores; attention adds 4*B*S^2*H. Activations are a few MB.
//
// What the design does about it: the GEMMs run on the tensor cores (WMMA,
// bf16 in, f32 accumulate) in 64x64 tiles; attention keeps one head's K and
// V (S <= 256, head_dim 32: 16 KB each) in shared memory with a 64-row query
// tile, so the [S, S] scores never reach device memory. The TPU layout
// (block-diagonal head groups, 128-padded K/V, batch blocking for VMEM) is
// not carried over. This is the simple first version: no TMA, no wgmma, no
// pipelining of tile loads. The kernels live in fused_layer_common.cuh,
// which the backward shares.

#include "fused_layer_common.cuh"

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes the wrapper has checked: H == num_heads * 32, H % 64 == 0,
// H <= 1024, I % 64 == 0, S % 16 == 0, 16 <= S <= 256, every pointer
// 16-byte aligned and contiguous. m1, m2: [B, S, H] bf16 or both null.
// Scratch buffers come from the caller.
int fused_layer_forward(const void* x, const void* key_bias, const void* qkv_w,
                        const void* qkv_b, const void* o_w, const void* o_b, const void* ln1_s,
                        const void* ln1_b, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* ln2_s, const void* ln2_b, const void* m1,
                        const void* m2, void* qkv, void* attn, void* tmp, void* x1, void* hid,
                        void* y, int batch, int seq, int hidden, int num_heads, int inter,
                        float scale, float eps, void* stream_ptr) {
  using namespace fl;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  cudaError_t e;

  e = launch_gemm<false, EPI_BIAS>((const bf16*)x, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                   nullptr, nullptr, M, 3 * H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_attention((const bf16*)qkv, (const float*)key_bias, (bf16*)attn, batch, seq, H,
                       num_heads, scale, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<false, EPI_BIAS>((const bf16*)attn, (const bf16*)o_w, (const bf16*)o_b, tmp,
                                   nullptr, nullptr, M, H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln((const bf16*)x, (const bf16*)tmp, (const bf16*)m1, (const float*)ln1_s,
                (const float*)ln1_b, (bf16*)x1, M, H, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<false, EPI_BIAS_GELU>((const bf16*)x1, (const bf16*)w1, (const bf16*)b1, hid,
                                        nullptr, nullptr, M, inter, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<false, EPI_BIAS>((const bf16*)hid, (const bf16*)w2, (const bf16*)b2, tmp,
                                   nullptr, nullptr, M, H, inter, stream);
  if (e != cudaSuccess) return e;
  return launch_ln((const bf16*)x1, (const bf16*)tmp, (const bf16*)m2, (const float*)ln2_s,
                   (const float*)ln2_b, (bf16*)y, M, H, eps, stream);
}

}  // extern "C"
