// Device code shared by the fused encoder layer's forward (fused_layer.cu)
// and backward (fused_layer_bwd.cu): one tensor-core GEMM core with fused
// epilogues, the per-head attention forward, residual + LayerNorm, and
// small reductions.
//
// Cast points follow the JAX package's ops/fused_layer.py (_kernel and
// _bwd_kernel): bf16 operands into every product with f32 accumulation,
// bf16 stores of activations, f32 LayerNorm and softmax.

#pragma once

#include <atomic>

#include "mma_common.cuh"

namespace fl {

using namespace mmac;

// A kernel's dynamic shared memory allowance, set once per device (`done`
// is the launcher's own set of devices done): at small batches the host's
// launch path is the critical one, and the call costs host time on every
// launch otherwise.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// d/dv gelu_erf(v) = Phi(v) + v * phi(v)  (the JAX package's _gelu_grad)
__device__ __forceinline__ float gelu_erf_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  const float pdf = expf(-0.5f * v * v) * 0.3989422804014327f;
  return cdf + v * pdf;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------- GEMM
// One core for every product of the layer, on mma.sync m16n8k16 (bf16 in,
// f32 accumulation). Block tiles of 128 x 128 over 8 warps (2 x 4, each
// 64 x 32: 16 products per 16-deep step), 32 deep; tiles arrive by cp.async
// 16-byte copies into a ring of four stages in dynamic shared memory, so
// the copies of the next three steps overlap each step's products. Two
// blocks per SM are asked of ptxas (at most 128 registers a thread).
// Rows are padded by 16 bytes (conflict-free ldmatrix). Copies past the
// matrix edges are zero-filled; rows and columns past M and N are not
// stored, so N need only be a multiple of 8 (the layer's are multiples of
// 64, such as 3H = 960 at H = 320) and M anything.
//
// Operand forms:
//   FORM_XW:  C[M, N] = A[M, K] W, W bf16 [K, N] row-major (forward
//             products); W's tile [k][n] feeds B through ldmatrix.trans.
//   FORM_XWT: C[M, N] = A[M, K] W^T, W bf16 [N, K] row-major (dgrad
//             products dY W^T); W's tile [n][k] feeds B through ldmatrix.
//   FORM_ATB: part[z][M, N] = A[r, M]^T B[r, N] summed over split z's rows
//             r (weight gradients, K = the row count); A's tile [r][m]
//             feeds the A operand through ldmatrix.trans.
// Epilogues work on the accumulators in registers and store bf16 pairs (or
// f32 pairs) straight to device memory.
enum Form { FORM_XW = 0, FORM_XWT, FORM_ATB };

enum Epilogue {
  EPI_BIAS = 0,       // C bf16 = acc + bias (bias may be null)
  EPI_BIAS_GELU,      // C bf16 = gelu(acc + bias)
  EPI_BIAS_GELU_GRAD, // C bf16 = gelu(acc + bias); aux_out f32 = gelu'(acc + bias)
  EPI_MUL_AUX,        // d = acc * aux (f32); C bf16 = d; aux_out[row tile][n] = sum of d
  EPI_ADD_AUX_F32,    // C f32 = acc + aux (f32)
  EPI_ADD_AUX_BF16,   // C bf16 = acc + aux (f32)
  EPI_PARTIAL,        // C f32 = acc, at C + z * M * N (FORM_ATB)
};

constexpr int GBM = 128, GBN = 128, GBK = 32, GSTAGES = 4;
constexpr int WARP_M = 64, WARP_N = 32;
constexpr int WARPS_M = GBM / WARP_M, WARPS_N = GBN / WARP_N;
constexpr int GEMM_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MI = WARP_M / 16, NI = WARP_N / 8;

template <int FORM>
struct GemmTiles {
  // A: [GBM][GBK + 8], or [GBK][GBM + 8] read transposed (FORM_ATB).
  // B: [GBK][GBN + 8] read transposed, or [GBN][GBK + 8] (FORM_XWT).
  static constexpr int LDA = FORM == FORM_ATB ? GBM + 8 : GBK + 8;
  static constexpr int LDB = FORM == FORM_XWT ? GBK + 8 : GBN + 8;
  static constexpr int A_ELEMS = FORM == FORM_ATB ? GBK * LDA : GBM * LDA;
  static constexpr int B_ELEMS = FORM == FORM_XWT ? GBN * LDB : GBK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM = (size_t)GSTAGES * STAGE * 2;
};

// One stage of A and B tiles, rows [row0, row0 + GBM) of the product and
// columns [col0, col0 + GBN), depth [k0, k0 + GBK) clipped at k_end.
template <int FORM>
__device__ __forceinline__ void gemm_load_stage(bf16* As, bf16* Bs, const bf16* A, const bf16* W,
                                                int M, int N, int K, int row0, int col0, int k0,
                                                int k_end, int tid) {
  using T = GemmTiles<FORM>;
#pragma unroll
  for (int it = 0; it < GBM * GBK / 8 / GEMM_THREADS; ++it) {
    const int i = tid + it * GEMM_THREADS;
    if (FORM == FORM_ATB) {  // [k][m]: rows of A, GBM / 8 chunks each
      const int r = i / (GBM / 8), c = (i % (GBM / 8)) * 8;
      const bool ok = k0 + r < k_end && row0 + c < M;
      cp_async16(As + r * T::LDA + c, ok ? A + (size_t)(k0 + r) * M + row0 + c : A, ok);
    } else {  // [m][k]
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const bool ok = row0 + r < M;
      cp_async16(As + r * T::LDA + c, ok ? A + (size_t)(row0 + r) * K + k0 + c : A, ok);
    }
  }
#pragma unroll
  for (int it = 0; it < GBN * GBK / 8 / GEMM_THREADS; ++it) {
    const int i = tid + it * GEMM_THREADS;
    if (FORM == FORM_XWT) {  // [n][k]: rows of W
      const int r = i / (GBK / 8), c = (i % (GBK / 8)) * 8;
      const bool ok = col0 + r < N;
      cp_async16(Bs + r * T::LDB + c, ok ? W + (size_t)(col0 + r) * K + k0 + c : W, ok);
    } else {  // [k][n]
      const int r = i / (GBN / 8), c = (i % (GBN / 8)) * 8;
      const bool ok = k0 + r < k_end && col0 + c < N;
      cp_async16(Bs + r * T::LDB + c, ok ? W + (size_t)(k0 + r) * N + col0 + c : W, ok);
    }
  }
}

// FORM_XW / FORM_XWT: A bf16 [M, K], W as the form says, K % GBK == 0.
// FORM_ATB: A bf16 [K, M] and W bf16 [K, N] (the row count K split into
// gridDim.z ranges of rows_per_split, a multiple of GBK). Block b takes
// column tile b % n_tiles of row tile b / n_tiles, so the blocks that run
// together share A's rows.
template <int FORM, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            const bf16* __restrict__ bias, void* __restrict__ Cv,
            const float* __restrict__ aux, float* __restrict__ aux_out, int M, int N, int K,
            int rows_per_split) {
  using T = GemmTiles<FORM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (N + GBN - 1) / GBN;
  const int row_tile = blockIdx.x / n_tiles;
  const int row0 = row_tile * GBM;
  const int col0 = (blockIdx.x % n_tiles) * GBN;
  const int wm = (warp / WARPS_N) * WARP_M;
  const int wn = (warp % WARPS_N) * WARP_N;
  const int k_begin = FORM == FORM_ATB ? blockIdx.z * rows_per_split : 0;
  const int k_end = FORM == FORM_ATB ? min(K, k_begin + rows_per_split) : K;
  const int steps = k_end > k_begin ? (k_end - k_begin + GBK - 1) / GBK : 0;

  // Each lane's ldmatrix offset (bytes) within a stage's A and B tiles.
  const uint32_t a_lane =
      FORM == FORM_ATB
          ? ((((lane & 7) + ((lane >> 4) << 3)) * T::LDA + ((lane >> 3) & 1) * 8 + wm) * 2)
          : (((lane & 15) + wm) * T::LDA + (lane >> 4) * 8) * 2;
  const uint32_t b_lane =
      FORM == FORM_XWT
          ? ((((lane & 7) + ((lane >> 4) << 3)) + wn) * T::LDB + ((lane >> 3) & 1) * 8) * 2
          : ((lane & 15) * T::LDB + (lane >> 4) * 8 + wn) * 2;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < steps) {
      bf16* As = ring + s * T::STAGE;
      gemm_load_stage<FORM>(As, As + T::A_ELEMS, A, W, M, N, K, row0, col0,
                            k_begin + s * GBK, k_end, tid);
    }
    cp_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_wait<GSTAGES - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1
    {
      const int next = kt + GSTAGES - 1;
      if (next < steps) {
        bf16* As = ring + (next % GSTAGES) * T::STAGE;
        gemm_load_stage<FORM>(As, As + T::A_ELEMS, A, W, M, N, K, row0, col0,
                              k_begin + next * GBK, k_end, tid);
      }
      cp_commit();
    }
    const uint32_t a_base = smem_addr(ring + (kt % GSTAGES) * T::STAGE) + a_lane;
    const uint32_t b_base = smem_addr(ring + (kt % GSTAGES) * T::STAGE + T::A_ELEMS) + b_lane;
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (FORM == FORM_ATB)
          ldsm_x4_trans(af[i], a_base + (kk * 16 * T::LDA + i * 16) * 2);
        else
          ldsm_x4(af[i], a_base + (i * 16 * T::LDA + kk * 16) * 2);
      }
#pragma unroll
      for (int jj = 0; jj < NI / 2; ++jj) {
        uint32_t b[4];
        if (FORM == FORM_XWT)
          ldsm_x4(b, b_base + (jj * 16 * T::LDB + kk * 16) * 2);
        else
          ldsm_x4_trans(b, b_base + (kk * 16 * T::LDB + jj * 16) * 2);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma(acc[i][2 * jj], af[i], b[0], b[1]);
          mma(acc[i][2 * jj + 1], af[i], b[2], b[3]);
        }
      }
    }
  }

  // Epilogue, from the registers: lane (g, t) holds rows g and g + 8 of
  // each 16-row tile, columns 2 t and 2 t + 1 of each 8-column tile.
  const int g = lane >> 2;
  const int t = lane & 3;
  float colsum[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    colsum[j][0] = 0.0f;
    colsum[j][1] = 0.0f;
    const int col = col0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;  // N % 8 == 0: the whole pair is past the edge
    float b0 = 0.0f, b1 = 0.0f;
    if ((EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) &&
        bias != nullptr) {
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col));
      b0 = bb.x;
      b1 = bb.y;
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (EPI == EPI_PARTIAL) {
          float* C = reinterpret_cast<float*>(Cv) + (size_t)blockIdx.z * M * N;
          *reinterpret_cast<float2*>(C + (size_t)row * N + col) = make_float2(v0, v1);
          continue;
        }
        const size_t off = (size_t)row * N + col;
        if (EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) {
          v0 += b0;
          v1 += b1;
        }
        if (EPI == EPI_BIAS_GELU_GRAD)
          *reinterpret_cast<float2*>(aux_out + off) =
              make_float2(gelu_erf_grad(v0), gelu_erf_grad(v1));
        if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (EPI == EPI_MUL_AUX) {
          const float2 a = *reinterpret_cast<const float2*>(aux + off);
          v0 *= a.x;
          v1 *= a.y;
          colsum[j][0] += v0;
          colsum[j][1] += v1;
        }
        if (EPI == EPI_ADD_AUX_F32 || EPI == EPI_ADD_AUX_BF16) {
          const float2 a = *reinterpret_cast<const float2*>(aux + off);
          v0 += a.x;
          v1 += a.y;
        }
        if (EPI == EPI_ADD_AUX_F32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(Cv) + off) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(Cv) + off) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
  if (EPI == EPI_MUL_AUX) {
    // Column sums of the f32 products over this row tile, in a fixed
    // order: each lane's rows, then the 8 lanes of a column (g), then the
    // two warps of a column; one partial row per row tile, reduced by
    // colsum_kernel.
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = colsum[j][e];
        v += __shfl_xor_sync(FULL, v, 4);
        v += __shfl_xor_sync(FULL, v, 8);
        v += __shfl_xor_sync(FULL, v, 16);
        colsum[j][e] = v;
      }
    cp_wait<0>();
    __syncthreads();  // the ring is free
    float* red = reinterpret_cast<float*>(smem);  // [WARPS_M][GBN]
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        red[(warp / WARPS_N) * GBN + wn + j * 8 + 2 * t] = colsum[j][0];
        red[(warp / WARPS_N) * GBN + wn + j * 8 + 2 * t + 1] = colsum[j][1];
      }
    }
    __syncthreads();
    for (int c = tid; c < GBN; c += GEMM_THREADS) {
      if (col0 + c >= N) break;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS_M; ++w) v += red[w * GBN + c];
      aux_out[(size_t)row_tile * N + col0 + c] = v;
    }
  }
}

// The launchers are static: their flags for allow_smem_once stay each
// library's own (a static local of a function with external linkage would
// be one object across every library the process loads, and the second
// library's kernels would launch without their allowance).
template <int FORM, int EPI>
static cudaError_t launch_gemm(const bf16* A, const bf16* W, const bf16* bias, void* C,
                               const float* aux, float* aux_out, int M, int N, int K,
                               cudaStream_t stream, int splits = 1, int rows_per_split = 0) {
  constexpr size_t smem = GemmTiles<FORM>::SMEM;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(gemm_kernel<FORM, EPI>, smem, done);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
  gemm_kernel<FORM, EPI><<<dim3(tiles, 1, splits), GEMM_THREADS, smem, stream>>>(
      A, W, bias, C, aux, aux_out, M, N, K, rows_per_split);
  return cudaGetLastError();
}

// Row tiles of a GEMM over M rows (the column-partial rows of EPI_MUL_AUX).
__host__ __device__ constexpr int gemm_row_tiles(int M) { return (M + GBM - 1) / GBM; }

// ----------------------------------------------------------- attention
// Forward: the one-pass kernel of mma_common.cuh with the JAX _kernel's
// cast point (P = exp(x - m) rounded to bf16 unnormalised, 1/z applied to
// the f32 P V product), reading q, k and v in place from the packed
// [B * S, 3 H] projection and writing [B * S, H]. One block per (64-query
// tile, head, batch row), 4 warps of 16 query rows; every score row stays
// in the mma accumulators (head_dim HD in {32, 64}, S <= 256: at most 128
// f32 per thread), K and V stream through a two-stage cp.async ring of
// 64-key tiles, and no score touches shared memory. K6 runs the same
// template at head_dim 64 without a spill.
template <int HD, int NT>
static cudaError_t launch_attention_nt(const bf16* qkv, const float* key_bias, bf16* out,
                                       int batch, int seq, int H, int num_heads, float scale,
                                       cudaStream_t stream) {
  const size_t smem = (size_t)3 * tile_elems<HD>() * 2 + (size_t)NT * TK * 4;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(attn_fwd_one_pass_kernel<HD, NT, DIVIDE_AFTER_PV>, smem, done);
  if (e != cudaSuccess) return e;
  const View vqkv{(long long)seq * 3 * H, HD, 3LL * H};
  const View vo{(long long)seq * H, HD, (long long)H};
  dim3 grid((seq + TQ - 1) / TQ, num_heads, batch);
  attn_fwd_one_pass_kernel<HD, NT, DIVIDE_AFTER_PV><<<grid, THREADS, smem, stream>>>(
      qkv, qkv + H, qkv + 2 * H, key_bias, out, vqkv, vqkv, vqkv, vo, seq, scale);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_attention_hd(const bf16* qkv, const float* key_bias, bf16* out,
                                       int batch, int seq, int H, int num_heads, float scale,
                                       cudaStream_t stream) {
  switch ((seq + TK - 1) / TK) {
    case 1: return launch_attention_nt<HD, 1>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 2: return launch_attention_nt<HD, 2>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 3: return launch_attention_nt<HD, 3>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 4: return launch_attention_nt<HD, 4>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The head_dim comes from hidden / num_heads: 32 (MiniLM-class) or 64
// (mpnet-base-class).
static inline cudaError_t launch_attention(const bf16* qkv, const float* key_bias, bf16* out,
                                           int batch, int seq, int H, int num_heads, float scale,
                                           cudaStream_t stream) {
  if (num_heads <= 0 || H % num_heads) return cudaErrorInvalidValue;
  switch (H / num_heads) {
    case 32: return launch_attention_hd<32>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 64: return launch_attention_hd<64>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ residual + LayerNorm
// y = bf16(LN(float(bf16(x + r')))) per row, r' = bf16(r * mask) when a
// dropout mask ({0, 1/keep} in bf16) is given, else r. One warp per row,
// H <= 1024.
constexpr int LN_ROWS = 4;
constexpr int LN_MAX_PER_LANE = 32;
constexpr int LN_MAX_H = 32 * LN_MAX_PER_LANE;

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
