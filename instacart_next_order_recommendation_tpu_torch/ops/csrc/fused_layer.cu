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
// bf16 tensor cores; attention adds 4*B*S^2*H. The activations that the
// seven launches pass through device memory (qkv, attn, the projection, x1,
// the FFN hidden layer) come to about 1 GB written and read at the MiniLM
// serve batch (B=256, S=192), 0.29 ms at 3.35 TB/s against the operations'
// 0.19 ms: with this many launches, bytes are the floor.
//
// What the design does about it (the kernels live in fused_layer_common.cuh
// and mma_common.cuh, which the backward shares):
// - One GEMM core for the four products: mma.sync m16n8k16 tensor-core
//   products fed by ldmatrix from 16-byte-padded shared tiles, 128 x 128
//   block tiles over 8 warps, tiles arriving by cp.async into a four-stage
//   ring, and epilogues (bias, GELU) applied to the accumulators in
//   registers and stored as bf16 pairs, with no staging tile.
// - Attention in one pass on tensor cores: one block per (64-query tile,
//   head, batch row) reads q, k and v in place from the packed projection;
//   the whole score row (S <= 256, head_dim 32 or 64) stays in the mma
//   accumulators, the exact row max and sum follow, P is rounded to bf16 in
//   registers and multiplied by V, so the [S, S] scores never reach shared
//   or device memory.
// - Residual + LayerNorm as one row kernel each (a warp per row).
// Not wgmma with TMA: mma.sync keeps one core for the three operand forms
// the forward and the backward need (X W, dY W^T, X^T dY); wgmma is for a
// later change, if the measured GEMM times show the issue rate as the
// limit. The TPU layout (block-diagonal head groups, 128-padded K/V, batch
// blocking for VMEM) is not carried over.

#include "fused_layer_common.cuh"

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes the wrapper has checked: H == num_heads * head_dim with head_dim
// 32 or 64, H % 64 == 0, H <= 1024, I % 64 == 0, S % 16 == 0,
// 16 <= S <= 256, every pointer 16-byte aligned and contiguous. m1, m2: [B, S, H] bf16 or both null.
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

  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)x, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                   nullptr, nullptr, M, 3 * H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_attention((const bf16*)qkv, (const float*)key_bias, (bf16*)attn, batch, seq, H,
                       num_heads, scale, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)attn, (const bf16*)o_w, (const bf16*)o_b, tmp,
                                   nullptr, nullptr, M, H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln((const bf16*)x, (const bf16*)tmp, (const bf16*)m1, (const float*)ln1_s,
                (const float*)ln1_b, (bf16*)x1, M, H, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS_GELU>((const bf16*)x1, (const bf16*)w1, (const bf16*)b1, hid,
                                        nullptr, nullptr, M, inter, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)hid, (const bf16*)w2, (const bf16*)b2, tmp,
                                   nullptr, nullptr, M, H, inter, stream);
  if (e != cudaSuccess) return e;
  return launch_ln((const bf16*)x1, (const bf16*)tmp, (const bf16*)m2, (const float*)ln2_s,
                   (const float*)ln2_b, (bf16*)y, M, H, eps, stream);
}

}  // extern "C"
