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
// What the design does about it (the kernels live in fused_layer_common.cuh,
// wgmma_common.cuh and mma_common.cuh, which the backward shares):
// - One GEMM core for the four products, on Hopper's asynchronous path
//   (GemmShape in fused_layer_common.cuh): wgmma.mma_async (m64n128k16,
//   both operands from shared memory) on two consumer warpgroups, fed by
//   TMA loads of 128-byte swizzled tiles that one producer thread keeps
//   coming through full/empty mbarriers. These four products, whose
//   epilogues store bf16 alone, take 256 x 128 x 64 tiles (128 rows a
//   consumer) in a ring of three 48 KB stages; the backward's products
//   with f32 epilogues and its X^T dY take 128 x 128 x 64 in four 32 KB
//   stages. Persistent blocks (one an SM) walk the output tiles, the
//   producer loading the next tile's stages during this one's epilogue.
//   The epilogue (bias, GELU) applies to the accumulators in registers,
//   writes the tile into a swizzled shared-memory buffer, and one thread
//   stores it by TMA while the next tile's products run. bf16 wgmma reads
//   either major-ness from shared memory, so the one core also takes the
//   backward's dY W^T and X^T dY. It replaced an mma.sync core (ldmatrix,
//   cp.async ring), whose issue rate held the products well under the
//   tensor cores' peak.
// - Attention on tensor cores: one block per (64-query tile, head, batch
//   row) reads q, k and v in place from the packed projection; where the
//   whole score row fits in the mma accumulators (S <= 256, head_dim <= 64)
//   it is computed once, the exact row max and sum follow, P is rounded to
//   bf16 in registers and multiplied by V, so the [S, S] scores never reach
//   shared or device memory. Past that (S up to 512, head_dim 128) two
//   passes over the keys, the row max first: the same bits.
// - The residual-saving form (save_resid) keeps attn, the post-dropout ao,
//   x1 and the post-dropout f for the backward: ao and f get buffers of
//   their own, and each LayerNorm row kernel writes the masked residual it
//   reads back over its input.
// - Residual + LayerNorm as one row kernel each (a warp per row).
// The TPU layout (block-diagonal head groups, 128-padded K/V, batch
// blocking for VMEM) is not carried over.

#include "fused_layer_common.cuh"

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes the wrapper has checked: H == num_heads * head_dim with head_dim
// 16, 32, 64 or 128, H % 64 == 0, H <= 1024, I % 64 == 0, S % 16 == 0,
// 16 <= S <= 512, every pointer 16-byte aligned and contiguous. m1, m2:
// [B, S, H] bf16 or both null. Scratch buffers come from the caller; ao and
// f may be one buffer. With save_resid (the residual-saving form of the JAX
// kernel, its save_resid=True) attn, ao, x1 and f are outputs: the
// attention output, the post-dropout projection bf16(bf16(attn Wo + bo) *
// m1), x1 and the post-dropout FFN output, each [B, S, H] bf16, the values
// the backward would otherwise recompute; ao and f must then be two buffers.
int fused_layer_forward(const void* x, const void* key_bias, const void* qkv_w,
                        const void* qkv_b, const void* o_w, const void* o_b, const void* ln1_s,
                        const void* ln1_b, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* ln2_s, const void* ln2_b, const void* m1,
                        const void* m2, void* qkv, void* attn, void* ao, void* x1, void* hid,
                        void* f, void* y, int save_resid, int batch, int seq, int hidden,
                        int num_heads, int inter, float scale, float eps, void* stream_ptr) {
  using namespace fl;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  // The LayerNorms store the post-dropout residual over the pre-dropout one
  // where it is kept and differs.
  bf16* ao_out = save_resid && m1 != nullptr ? (bf16*)ao : nullptr;
  bf16* f_out = save_resid && m2 != nullptr ? (bf16*)f : nullptr;
  cudaError_t e;

  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)x, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                   nullptr, nullptr, M, 3 * H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_attention((const bf16*)qkv, (const float*)key_bias, (bf16*)attn, batch, seq, H,
                       num_heads, scale, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)attn, (const bf16*)o_w, (const bf16*)o_b, ao,
                                   nullptr, nullptr, M, H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln((const bf16*)x, (const bf16*)ao, (const bf16*)m1, (const float*)ln1_s,
                (const float*)ln1_b, (bf16*)x1, M, H, eps, stream, ao_out);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS_GELU>((const bf16*)x1, (const bf16*)w1, (const bf16*)b1, hid,
                                        nullptr, nullptr, M, inter, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)hid, (const bf16*)w2, (const bf16*)b2, f,
                                   nullptr, nullptr, M, H, inter, stream);
  if (e != cudaSuccess) return e;
  return launch_ln((const bf16*)x1, (const bf16*)f, (const bf16*)m2, (const float*)ln2_s,
                   (const float*)ln2_b, (bf16*)y, M, H, eps, stream, f_out);
}

}  // extern "C"
