// One post-LN BERT encoder layer forward, bf16 in and out, for Hopper.
//
// Replaces: the JAX package's ops/fused_layer.py::_kernel (the Pallas TPU
// kernel behind fused_encoder_layer), with the same function and the same
// cast points:
//   qkv = bf16(x @ Wqkv + bqkv)                     f32 accumulation
//   per head: p = exp(scale * q k^T + keybias - max) f32; z = sum(p)
//             attn = bf16((bf16(p) @ v) / z)        1/z applied after PV
//   ao  = bf16(attn @ Wo + bo);  x1 = bf16(LN(float(bf16(x + ao))))
//   h   = bf16(gelu(x1 @ W1 + b1));  f = bf16(h @ W2 + b2)
//   y   = bf16(LN(float(bf16(x1 + f))))
// The key bias is -1e9 at padded keys (not -inf), so an all-pad row stays
// finite. GELU uses erff.
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
// pipelining of tile loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------- GEMM
// C[M, N] = epilogue(A[M, K] @ W[K, N] + bias[N]), bf16 in and out.
constexpr int GBM = 64, GBN = 64, GBK = 32;
constexpr int A_LD = GBK + 8;   // padded shared-memory strides (elements)
constexpr int B_LD = GBN + 8;
constexpr int C_LD = GBN + 4;
constexpr int GEMM_THREADS = 128;  // 4 warps, 2x2, each a 32x32 sub-tile
constexpr int GEMM_SMEM =
    (GBM * C_LD * 4 > (GBM * A_LD + GBK * B_LD) * 2) ? GBM * C_LD * 4
                                                     : (GBM * A_LD + GBK * B_LD) * 2;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <bool GELU>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                 const bf16* __restrict__ bias, bf16* __restrict__ C,
                 int M, int N, int K) {
  __shared__ __align__(128) unsigned char smem[GEMM_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + GBM * A_LD;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the k loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * GBM;
  const int col0 = blockIdx.x * GBN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += GBK) {
    // A tile: 64 rows x 32 cols, 16-byte chunks of 8 bf16.
    for (int i = tid; i < GBM * (GBK / 8); i += GEMM_THREADS) {
      const int r = i / (GBK / 8);
      const int c = (i % (GBK / 8)) * 8;
      const int gr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * A_LD + c) = v;
    }
    // W tile: 32 rows x 64 cols.
    for (int i = tid; i < GBK * (GBN / 8); i += GEMM_THREADS) {
      const int r = i / (GBN / 8);
      const int c = (i % (GBN / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * B_LD + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + col0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * C_LD + wn + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < GBM * (GBN / 2); i += GEMM_THREADS) {
    const int r = i / (GBN / 2);
    const int c = (i % (GBN / 2)) * 2;
    const int gr = row0 + r;
    if (gr >= M) continue;
    float v0 = Cs[r * C_LD + c] + __bfloat162float(bias[col0 + c]);
    float v1 = Cs[r * C_LD + c + 1] + __bfloat162float(bias[col0 + c + 1]);
    if (GELU) {
      v0 = gelu_erf(v0);
      v1 = gelu_erf(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(C + (size_t)gr * N + col0 + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

// ----------------------------------------------------------- attention
// One block per (64-query tile, head, batch row); 4 warps of 16 query rows.
constexpr int HD = 32;
constexpr int AQ = 64;
constexpr int ATTN_THREADS = 128;

__host__ __device__ constexpr size_t attn_smem_bytes(int S) {
  return (size_t)2 * S * HD * 2   // K, V
         + (size_t)AQ * HD * 2    // Q tile
         + (size_t)AQ * S * 4     // f32 scores, 16 rows per warp
         + (size_t)AQ * S * 2     // bf16 probabilities
         + (size_t)S * 4          // key bias
         + (size_t)AQ * 4;        // row sums
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                 bf16* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S * HD;
  bf16* Qs = Vs + S * HD;
  float* Sc = reinterpret_cast<float*>(Qs + AQ * HD);
  bf16* Ps = reinterpret_cast<bf16*>(Sc + AQ * S);
  float* Kb = reinterpret_cast<float*>(Ps + AQ * S);
  float* Zs = Kb + S;

  const int q0 = blockIdx.x * AQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int H3 = 3 * H;
  const bf16* base = qkv + (size_t)b * S * H3;

  for (int i = tid; i < S * (HD / 8); i += ATTN_THREADS) {
    const int s = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    const bf16* row = base + (size_t)s * H3 + head * HD + c;
    *reinterpret_cast<uint4*>(Ks + s * HD + c) = *reinterpret_cast<const uint4*>(row + H);
    *reinterpret_cast<uint4*>(Vs + s * HD + c) = *reinterpret_cast<const uint4*>(row + 2 * H);
  }
  for (int i = tid; i < AQ * (HD / 8); i += ATTN_THREADS) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < S)
      v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * H3 + head * HD + c);
    *reinterpret_cast<uint4*>(Qs + r * HD + c) = v;
  }
  for (int s = tid; s < S; s += ATTN_THREADS) Kb[s] = key_bias[(size_t)b * S + s];
  __syncthreads();

  const int r0 = warp * 16;
  if (q0 + r0 >= S) return;  // warp-uniform; no block barrier follows
  float* sc = Sc + r0 * S;
  bf16* p = Ps + r0 * S;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[2];
  wmma::load_matrix_sync(qa[0], Qs + r0 * HD, HD);
  wmma::load_matrix_sync(qa[1], Qs + r0 * HD + 16, HD);
  for (int n0 = 0; n0 < S; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      // K stored [S][HD] row-major is K^T in column-major order.
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, Ks + n0 * HD + kk * 16, HD);
      wmma::mma_sync(acc, qa[kk], kb, acc);
    }
    wmma::store_matrix_sync(sc + n0, acc, S, wmma::mem_row_major);
  }
  __syncwarp();

  for (int r = 0; r < 16; ++r) {
    float* row = sc + r * S;
    float m = -3.0e38f;  // below any biased score (keys carry >= -1e9)
    for (int j = lane; j < S; j += 32) {
      const float v = __fadd_rn(__fmul_rn(row[j], scale), Kb[j]);
      row[j] = v;
      m = fmaxf(m, v);
    }
    m = warp_max(m);
    float z = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - m);
      z += e;
      p[r * S + j] = __float2bfloat16(e);
    }
    z = warp_sum(z);
    if (lane == 0) Zs[r0 + r] = z;
  }
  __syncwarp();

  // PV into the (now free) score rows, [16][HD] f32 at stride HD.
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < S; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(pa, p + k0, S);
      wmma::load_matrix_sync(vb, Vs + k0 * HD + d0, HD);
      wmma::mma_sync(acc, pa, vb, acc);
    }
    wmma::store_matrix_sync(sc + d0, acc, HD, wmma::mem_row_major);
  }
  __syncwarp();

  for (int i = lane; i < 16 * HD; i += 32) {
    const int r = i / HD;
    const int d = i % HD;
    const int q = q0 + r0 + r;
    if (q < S)
      out[((size_t)b * S + q) * H + head * HD + d] = __float2bfloat16(sc[r * HD + d] / Zs[r0 + r]);
  }
}

// ------------------------------------------------ residual + LayerNorm
// y = bf16(LN(float(bf16(x + r)))) per row; one warp per row, H <= 1024.
constexpr int LN_ROWS = 4;
constexpr int LN_MAX_PER_LANE = 32;

__global__ void __launch_bounds__(LN_ROWS * 32)
residual_layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                          const float* __restrict__ scale, const float* __restrict__ shift,
                          bf16* __restrict__ y, int M, int H, float eps) {
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int per_lane = H / 32;
  const size_t off = (size_t)row * H;
  float v[LN_MAX_PER_LANE];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
    if (t < per_lane) {
      const int j = lane + 32 * t;
      const float s = __bfloat162float(x[off + j]) + __bfloat162float(r[off + j]);
      v[t] = __bfloat162float(__float2bfloat16(s));
      sum += v[t];
    }
  }
  const float mean = warp_sum(sum) / H;
  float sq = 0.0f;
#pragma unroll
  for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
    if (t < per_lane) {
      v[t] -= mean;
      sq += v[t] * v[t];
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
    if (t < per_lane) {
      const int j = lane + 32 * t;
      y[off + j] = __float2bfloat16(v[t] * inv * scale[j] + shift[j]);
    }
  }
}

template <bool GELU>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias, bf16* C, int M, int N,
                        int K, cudaStream_t stream) {
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_bias_kernel<GELU><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, C, M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_ln(const bf16* x, const bf16* r, const float* s, const float* b, bf16* y,
                      int M, int H, float eps, cudaStream_t stream) {
  residual_layernorm_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      x, r, s, b, y, M, H, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes the wrapper has checked: H == num_heads * 32, H % 64 == 0,
// H <= 1024, I % 64 == 0, S % 16 == 0, 16 <= S <= 256, every pointer
// 16-byte aligned and contiguous. Scratch buffers come from the caller.
int fused_layer_forward(const void* x, const void* key_bias, const void* qkv_w,
                        const void* qkv_b, const void* o_w, const void* o_b, const void* ln1_s,
                        const void* ln1_b, const void* w1, const void* b1, const void* w2,
                        const void* b2, const void* ln2_s, const void* ln2_b, void* qkv,
                        void* attn, void* tmp, void* x1, void* hid, void* y, int batch,
                        int seq, int hidden, int num_heads, int inter, float scale, float eps,
                        void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  cudaError_t e;

  e = launch_gemm<false>((const bf16*)x, (const bf16*)qkv_w, (const bf16*)qkv_b, (bf16*)qkv, M,
                         3 * H, H, stream);
  if (e != cudaSuccess) return e;

  const size_t smem = attn_smem_bytes(seq);
  e = cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 agrid((seq + AQ - 1) / AQ, num_heads, batch);
  attention_kernel<<<agrid, ATTN_THREADS, smem, stream>>>((const bf16*)qkv,
                                                         (const float*)key_bias, (bf16*)attn,
                                                         seq, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  e = launch_gemm<false>((const bf16*)attn, (const bf16*)o_w, (const bf16*)o_b, (bf16*)tmp, M,
                         H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_ln((const bf16*)x, (const bf16*)tmp, (const float*)ln1_s, (const float*)ln1_b,
                (bf16*)x1, M, H, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<true>((const bf16*)x1, (const bf16*)w1, (const bf16*)b1, (bf16*)hid, M, inter,
                        H, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<false>((const bf16*)hid, (const bf16*)w2, (const bf16*)b2, (bf16*)tmp, M, H,
                         inter, stream);
  if (e != cudaSuccess) return e;
  return launch_ln((const bf16*)x1, (const bf16*)tmp, (const float*)ln2_s, (const float*)ln2_b,
                   (bf16*)y, M, H, eps, stream);
}

}  // extern "C"
