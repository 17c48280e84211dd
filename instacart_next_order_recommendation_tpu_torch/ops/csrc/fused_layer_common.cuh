// Device code shared by the fused encoder layer's forward (fused_layer.cu)
// and backward (fused_layer_bwd.cu): WMMA GEMMs with fused epilogues, the
// per-head attention forward, residual + LayerNorm, and small reductions.
//
// Cast points follow the JAX package's ops/fused_layer.py (_kernel and
// _bwd_kernel): bf16 operands into every product with f32 accumulation,
// bf16 stores of activations, f32 LayerNorm and softmax.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace fl {

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// d/dv gelu_erf(v) = Phi(v) + v * phi(v)  (the JAX package's _gelu_grad)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  const float pdf = expf(-0.5f * v * v) * 0.3989422804014327f;
  return cdf + v * pdf;
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------- GEMM
// C[M, N] = epilogue(A[M, K] @ B), A bf16 row-major, f32 accumulation on the
// tensor cores (WMMA 16x16x16) in 64x64 block tiles, 4 warps of 32x32.
//   B_TRANS = false: B = W, W bf16 [K, N] row-major  (forward products)
//   B_TRANS = true:  B = W^T, W bf16 [N, K] row-major (dgrad products dY W^T)
constexpr int GBM = 64, GBN = 64, GBK = 32;
constexpr int A_LD = GBK + 8;   // padded shared-memory strides (elements)
constexpr int B_LD = GBN + 8;   // W tile [GBK][GBN]
constexpr int BT_LD = GBK + 8;  // W tile [GBN][GBK] (B_TRANS)
constexpr int C_LD = GBN + 4;
constexpr int GEMM_THREADS = 128;
constexpr int GEMM_SMEM_AB = (GBM * A_LD + (GBK * B_LD > GBN * BT_LD ? GBK * B_LD : GBN * BT_LD)) * 2;
constexpr int GEMM_SMEM =
    GBM * C_LD * 4 > GEMM_SMEM_AB ? GBM * C_LD * 4 : GEMM_SMEM_AB;

enum Epilogue {
  EPI_BIAS = 0,       // C bf16 = acc + bias (bias may be null)
  EPI_BIAS_GELU,      // C bf16 = gelu(acc + bias)
  EPI_BIAS_GELU_GRAD, // C bf16 = gelu(acc + bias); aux_out f32 = gelu'(acc + bias)
  EPI_MUL_AUX,        // d = acc * aux (f32); C bf16 = d; colpart[blockIdx.y][n] = sum of d
  EPI_ADD_AUX_F32,    // C f32 = acc + aux (f32)
  EPI_ADD_AUX_BF16,   // C bf16 = acc + aux (f32)
};

template <bool B_TRANS, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, void* __restrict__ Cv,
            const float* __restrict__ aux, float* __restrict__ aux_out, int M, int N, int K) {
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
    // A tile: 64 rows x 32 cols, 16-byte chunks of 8 bf16; rows past M are 0.
    for (int i = tid; i < GBM * (GBK / 8); i += GEMM_THREADS) {
      const int r = i / (GBK / 8);
      const int c = (i % (GBK / 8)) * 8;
      const int gr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < M) v = *reinterpret_cast<const uint4*>(A + (size_t)gr * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * A_LD + c) = v;
    }
    if (B_TRANS) {
      // W rows col0..col0+63, cols k0..k0+31: stored [n][k] (B in column-major).
      for (int i = tid; i < GBN * (GBK / 8); i += GEMM_THREADS) {
        const int n = i / (GBK / 8);
        const int c = (i % (GBK / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + n * BT_LD + c) =
            *reinterpret_cast<const uint4*>(W + (size_t)(col0 + n) * K + k0 + c);
      }
    } else {
      // W tile: 32 rows x 64 cols.
      for (int i = tid; i < GBK * (GBN / 8); i += GEMM_THREADS) {
        const int r = i / (GBN / 8);
        const int c = (i % (GBN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * B_LD + c) =
            *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + col0 + c);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * A_LD + kk, A_LD);
      if (B_TRANS) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wn + j * 16) * BT_LD + kk, BT_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
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
    if (gr >= M) {
      if (EPI == EPI_MUL_AUX) {
        Cs[r * C_LD + c] = 0.0f;
        Cs[r * C_LD + c + 1] = 0.0f;
      }
      continue;
    }
    const size_t off = (size_t)gr * N + col0 + c;
    float v0 = Cs[r * C_LD + c];
    float v1 = Cs[r * C_LD + c + 1];
    if (EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) {
      if (bias != nullptr) {
        v0 += __bfloat162float(bias[col0 + c]);
        v1 += __bfloat162float(bias[col0 + c + 1]);
      }
    }
    if (EPI == EPI_BIAS_GELU_GRAD) {
      aux_out[off] = gelu_erf_grad(v0);
      aux_out[off + 1] = gelu_erf_grad(v1);
    }
    if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) {
      v0 = gelu_erf(v0);
      v1 = gelu_erf(v1);
    }
    if (EPI == EPI_MUL_AUX) {
      v0 *= aux[off];
      v1 *= aux[off + 1];
      Cs[r * C_LD + c] = v0;
      Cs[r * C_LD + c + 1] = v1;
    }
    if (EPI == EPI_ADD_AUX_F32 || EPI == EPI_ADD_AUX_BF16) {
      v0 += aux[off];
      v1 += aux[off + 1];
    }
    if (EPI == EPI_ADD_AUX_F32) {
      float* C = reinterpret_cast<float*>(Cv);
      C[off] = v0;
      C[off + 1] = v1;
    } else {
      bf16* C = reinterpret_cast<bf16*>(Cv);
      *reinterpret_cast<__nv_bfloat162*>(C + off) = __floats2bfloat162_rn(v0, v1);
    }
  }
  if (EPI == EPI_MUL_AUX) {
    // Column sums of the f32 products over this block's 64 rows, in row
    // order: one partial row per block row, reduced by colsum_kernel.
    __syncthreads();
    for (int c = tid; c < GBN; c += GEMM_THREADS) {
      float s = 0.0f;
      for (int r = 0; r < GBM; ++r) s += Cs[r * C_LD + c];
      aux_out[(size_t)blockIdx.y * N + col0 + c] = s;
    }
  }
}

template <bool B_TRANS, int EPI>
cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias, void* C,
                        const float* aux, float* aux_out, int M, int N, int K,
                        cudaStream_t stream) {
  dim3 grid(N / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<B_TRANS, EPI><<<grid, GEMM_THREADS, 0, stream>>>(A, W, bias, C, aux, aux_out, M,
                                                               N, K);
  return cudaGetLastError();
}

// ----------------------------------------------------------- attention
// Forward: one block per (64-query tile, head, batch row); 4 warps of 16
// query rows. K and V of one head (S <= 256, head_dim 32) sit in shared
// memory; the scores never reach device memory.
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

inline cudaError_t launch_attention(const bf16* qkv, const float* key_bias, bf16* out, int batch,
                                    int seq, int H, int num_heads, float scale,
                                    cudaStream_t stream) {
  const size_t smem = attn_smem_bytes(seq);
  cudaError_t e = cudaFuncSetAttribute(attention_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((seq + AQ - 1) / AQ, num_heads, batch);
  attention_kernel<<<grid, ATTN_THREADS, smem, stream>>>(qkv, key_bias, out, seq, H, scale);
  return cudaGetLastError();
}

// ------------------------------------------------ residual + LayerNorm
// y = bf16(LN(float(bf16(x + r')))) per row, r' = bf16(r * mask) when a
// dropout mask ({0, 1/keep} in bf16) is given, else r. One warp per row,
// H <= 1024.
constexpr int LN_ROWS = 4;
constexpr int LN_MAX_PER_LANE = 32;

__device__ __forceinline__ float residual_in(const bf16* x, const bf16* r, const bf16* mask,
                                             size_t idx) {
  float rv = __bfloat162float(r[idx]);
  if (mask != nullptr) rv = __bfloat162float(__float2bfloat16(rv * __bfloat162float(mask[idx])));
  return __bfloat162float(__float2bfloat16(__bfloat162float(x[idx]) + rv));
}

__global__ void __launch_bounds__(LN_ROWS * 32)
residual_layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                          const bf16* __restrict__ mask, const float* __restrict__ scale,
                          const float* __restrict__ shift, bf16* __restrict__ y, int M, int H,
                          float eps) {
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
      v[t] = residual_in(x, r, mask, off + lane + 32 * t);
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

inline cudaError_t launch_ln(const bf16* x, const bf16* r, const bf16* mask, const float* s,
                             const float* b, bf16* y, int M, int H, float eps,
                             cudaStream_t stream) {
  residual_layernorm_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      x, r, mask, s, b, y, M, H, eps);
  return cudaGetLastError();
}

}  // namespace fl
