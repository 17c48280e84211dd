// Backward of one post-LN BERT encoder layer (with optional dropout masks),
// bf16 activations, for Hopper: dx plus all twelve weight gradients.
//
// Replaces: the JAX package's ops/fused_layer.py::_bwd_kernel in its fully
// fused form (wgrads=True, reached through _fused_backward from the
// custom_vjp of fused_encoder_layer_train). Same function, same cast points:
//   forward recompute: qkv, attn, ao, x1 = LN1(x + ao*m1), hpre = x1 W1 + b1,
//     hg = bf16(gelu(hpre)), f = bf16(hg W2 + b2)            (as _kernel)
//   LN2 backward in f32 on res2 = bf16(x1 + f*m2), dy = f32(g) -> dres2,
//     ds2 = sum(dy * nh2), db2 = sum(dy)
//   df = dres2 * m2; d_b2 = sum(df); dW2 = hg^T bf16(df)
//   dhpre = (bf16(df) W2^T) * gelu'(hpre)  (f32); d_b1 = sum(dhpre);
//     dW1 = x1^T bf16(dhpre); dx1 = dres2 + bf16(dhpre) W1^T
//   LN1 backward on res1 = bf16(x + ao*m1), dy = dx1 -> dres1, ds1, db1
//   dao = dres1 * m1; d_ob = sum(dao); dWo = attn^T bf16(dao);
//     dattn = bf16(bf16(dao) Wo^T)
//   attention, per head, with the deferred softmax denominator:
//     dU = dA / z, dV = bf16(P)^T bf16(dU), dP = bf16(dU) V^T,
//     dz = -sum_d(dA * A) / z, dL = bf16(P * (dP + dz)),
//     dQ = scale dL K, dK = scale dL^T Q             -> dqkv (bf16)
//   dWqkv = x^T dqkv; d_bqkv = sum(f32(dqkv)); dx = bf16(dres1 + dqkv Wqkv^T)
// Every product takes bf16 operands and accumulates in f32; every weight
// gradient is an f32 sum over the B*S rows.
//
// What bounds it on the H100: the GEMMs, about 3 * 2*B*S*(4*H^2 + 2*H*I)
// operations (forward recompute, dgrad, wgrad), plus 12*B*S^2*H in
// attention, against 989 TFLOP/s of bf16 tensor cores; the f32 gelu' and
// residual-gradient streams add a few hundred MB at B=512, S=256.
//
// Design (the simple first version): the forward recompute reuses K1's
// kernels (fused_layer_common.cuh) into scratch; row kernels do the two
// LayerNorm backwards with the masks; one block per (head, batch row) runs
// the attention backward with that head's K, V (S <= 256, head_dim 32), a
// 64-row query tile of P and dL, and the dK, dV sums in shared memory; the
// dgrad products (dY W^T) and the four weight-gradient products (X^T dY,
// split over the B*S rows, partial tiles summed in a fixed order) are
// hand-written WMMA GEMMs; bias and LayerNorm grads are f32 column sums in
// a fixed order, so the result does not change from run to run. The TPU's
// head groups, 128-padding of K/V, FFN chunking and resident probabilities
// exist for VMEM and are not carried over.

#include "fused_layer_common.cuh"

namespace {

using namespace fl;

// ------------------------------------------------- weight-gradient GEMM
// part[split][K1, N] = A[m, :]^T B[m, :] summed over this split's rows m.
// A bf16 [M, K1], B bf16 [M, N] row-major; 64x64 output tiles.
constexpr int WBK = 32;
constexpr int W_LD = 64 + 8;
constexpr int W_SMEM_AB = 2 * WBK * W_LD * 2;
constexpr int W_SMEM = GBM * C_LD * 4 > W_SMEM_AB ? GBM * C_LD * 4 : W_SMEM_AB;

__global__ void __launch_bounds__(GEMM_THREADS)
wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
             int M, int K1, int N, int rows_per_split) {
  __shared__ __align__(128) unsigned char smem[W_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + WBK * W_LD;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int i0 = blockIdx.y * 64;
  const int j0 = blockIdx.x * 64;
  const int split = blockIdx.z;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int m_begin = split * rows_per_split;
  const int m_end = min(M, m_begin + rows_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int m0 = m_begin; m0 < m_end; m0 += WBK) {
    for (int i = tid; i < WBK * 8; i += GEMM_THREADS) {
      const int r = i / 8;
      const int c = (i % 8) * 8;
      const int gm = m0 + r;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      uint4 vb = make_uint4(0u, 0u, 0u, 0u);
      if (gm < m_end) {
        va = *reinterpret_cast<const uint4*>(A + (size_t)gm * K1 + i0 + c);
        vb = *reinterpret_cast<const uint4*>(B + (size_t)gm * N + j0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * W_LD + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * W_LD + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      // A^T tile: element (i, m) sits at As[m][i], i.e. column-major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + kk * W_LD + wm + i * 16, W_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * W_LD + wn + j * 16, W_LD);
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
  for (int i = tid; i < 64 * 64; i += GEMM_THREADS) {
    const int r = i / 64;
    const int c = i % 64;
    part[((size_t)split * K1 + i0 + r) * N + j0 + c] = Cs[r * C_LD + c];
  }
}

// ------------------------------------------------------- column sums
// out[chunk][c] = sum of X[r][c] over the chunk's rows, in row order within
// each of 8 row lanes, then the 8 lanes in order: a fixed order, so the
// result is the same on every run.
template <typename T>
__global__ void __launch_bounds__(256)
colsum_kernel(const T* __restrict__ X, float* __restrict__ out, int rows, int cols,
              int rows_per_chunk) {
  __shared__ float sm[8][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  const int r_begin = blockIdx.y * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);
  float s = 0.0f;
  if (col < cols)
    for (int r = r_begin + ty; r < r_end; r += 8) s += to_f32(X[(size_t)r * cols + col]);
  sm[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < cols) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += sm[k][tx];
    out[(size_t)blockIdx.y * cols + col] = t;
  }
}

constexpr int COLSUM_SINGLE_PASS_ROWS = 2048;
constexpr int COLSUM_CHUNK = 512;

template <typename T>
cudaError_t reduce_columns(const T* X, int rows, int cols, float* out, float* tmp,
                           cudaStream_t stream) {
  const dim3 block(256);
  const int col_blocks = (cols + 31) / 32;
  if (rows <= COLSUM_SINGLE_PASS_ROWS) {
    colsum_kernel<T><<<dim3(col_blocks, 1), block, 0, stream>>>(X, out, rows, cols, rows);
    return cudaGetLastError();
  }
  const int chunks = (rows + COLSUM_CHUNK - 1) / COLSUM_CHUNK;
  colsum_kernel<T><<<dim3(col_blocks, chunks), block, 0, stream>>>(X, tmp, rows, cols,
                                                                   COLSUM_CHUNK);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_kernel<float><<<dim3(col_blocks, 1), block, 0, stream>>>(tmp, out, chunks, cols, chunks);
  return cudaGetLastError();
}

int wgrad_splits(int M, int K1, int N) {
  const int tiles = (K1 / 64) * (N / 64);
  int s = (4 * 132 + tiles - 1) / tiles;  // about four blocks per SM
  const int max_s = (M + 255) / 256;
  if (s > max_s) s = max_s;
  return s < 1 ? 1 : s;
}

int wgrad_rows_per_split(int M, int splits) {
  const int r = (M + splits - 1) / splits;
  return (r + WBK - 1) / WBK * WBK;
}

cudaError_t launch_wgrad(const bf16* A, const bf16* B, float* out, float* wpart, float* tmp,
                         int M, int K1, int N, cudaStream_t stream) {
  const int splits = wgrad_splits(M, K1, N);
  wgrad_kernel<<<dim3(N / 64, K1 / 64, splits), GEMM_THREADS, 0, stream>>>(
      A, B, wpart, M, K1, N, wgrad_rows_per_split(M, splits));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_columns<float>(wpart, splits, K1 * N, out, tmp, stream);
}

// ------------------------------------------------ LayerNorm backward
// One warp per row, 8 warps and 64 rows per block. For the row's residual
// res = bf16(a + bf16(r * mask)) (LN input, recomputed) and upstream dy:
//   nh = (res - mean) * inv;  dnh = dy * scale
//   dres = inv * (dnh - mean(dnh) - nh * mean(dnh * nh))          (f32 out)
//   dmasked = bf16(dres * mask)                                   (bf16 out)
// and per-block column partials [3][H] of dy * nh, dy and dres * mask.
constexpr int LNB_WARPS = 8;
constexpr int LNB_ROWS = 64;

template <typename DyT>
__global__ void __launch_bounds__(LNB_WARPS * 32)
ln_bwd_kernel(const bf16* __restrict__ a, const bf16* __restrict__ r,
              const bf16* __restrict__ mask, const DyT* __restrict__ dy,
              const float* __restrict__ scale, float* __restrict__ dres,
              bf16* __restrict__ dmasked, float* __restrict__ part, int M, int H, float eps) {
  extern __shared__ float acc_sm[];  // [LNB_WARPS][3][H]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc = acc_sm + (size_t)warp * 3 * H;
  for (int j = lane; j < 3 * H; j += 32) acc[j] = 0.0f;
  __syncwarp();

  const int per_lane = H / 32;
  const int row_begin = (int)blockIdx.x * LNB_ROWS;
  const int row_end = min(M, row_begin + LNB_ROWS);
  for (int row = row_begin + warp; row < row_end; row += LNB_WARPS) {
    const size_t off = (size_t)row * H;
    float v[LN_MAX_PER_LANE];
    float g[LN_MAX_PER_LANE];
    float sum = 0.0f;
#pragma unroll
    for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
      if (t < per_lane) {
        v[t] = residual_in(a, r, mask, off + lane + 32 * t);
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
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
      if (t < per_lane) {
        const int j = lane + 32 * t;
        v[t] *= inv;  // nh
        g[t] = to_f32(dy[off + j]);
        const float dnh = g[t] * scale[j];
        s1 += dnh;
        s2 += dnh * v[t];
      }
    }
    const float mean_dnh = warp_sum(s1) / H;
    const float mean_dnh_nh = warp_sum(s2) / H;
#pragma unroll
    for (int t = 0; t < LN_MAX_PER_LANE; ++t) {
      if (t < per_lane) {
        const int j = lane + 32 * t;
        const float dnh = g[t] * scale[j];
        const float dr = inv * (dnh - mean_dnh - v[t] * mean_dnh_nh);
        dres[off + j] = dr;
        const float dm = mask != nullptr ? dr * __bfloat162float(mask[off + j]) : dr;
        dmasked[off + j] = __float2bfloat16(dm);
        acc[j] += g[t] * v[t];
        acc[H + j] += g[t];
        acc[2 * H + j] += dm;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * H; idx += LNB_WARPS * 32) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) s += acc_sm[(size_t)w * 3 * H + idx];
    part[(size_t)blockIdx.x * 3 * H + idx] = s;
  }
}

template <typename DyT>
cudaError_t launch_ln_bwd(const bf16* a, const bf16* r, const bf16* mask, const DyT* dy,
                          const float* scale, float* dres, bf16* dmasked, float* part, int M,
                          int H, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)LNB_WARPS * 3 * H * 4;
  cudaError_t e = cudaFuncSetAttribute(ln_bwd_kernel<DyT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ln_bwd_kernel<DyT><<<(M + LNB_ROWS - 1) / LNB_ROWS, LNB_WARPS * 32, smem, stream>>>(
      a, r, mask, dy, scale, dres, dmasked, part, M, H, eps);
  return cudaGetLastError();
}

// ------------------------------------------------ attention backward
// One block per (head, batch row), 4 warps. K, V of the head stay in shared
// memory; query tiles of 64 rows (16 per warp) recompute the scores and
// probabilities exactly as the forward does, then:
//   dV += bf16(P)^T dU and dK += dL^T Q (warps split the key rows; f32 sums
//   in shared memory), dQ = scale dL K (each warp its own query rows).
__host__ __device__ constexpr size_t attn_bwd_smem_bytes(int S) {
  return (size_t)2 * S * HD * 2     // K, V
         + (size_t)2 * AQ * HD * 2  // Q tile, bf16(dU) tile
         + (size_t)AQ * S * 4       // scores -> P (f32); later dQ staging
         + (size_t)AQ * S * 2       // bf16(P), then dL
         + (size_t)2 * S * HD * 4   // dK, dV sums (f32)
         + (size_t)S * 4            // key bias
         + (size_t)AQ * 4           // dz per query row
         + (size_t)4 * 16 * 16 * 4; // per-warp dP tile
}

// Acc[S][HD] += Xs^T Rs, Xs bf16 [AQ][S], Rs bf16 [AQ][HD]; the warp owns
// key tiles warp, warp + 4, ...
__device__ void accumulate_keys(const bf16* Xs, const bf16* Rs, float* Acc, int S, int warp) {
  for (int kt = warp; kt < S / 16; kt += 4) {
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Acc + kt * 16 * HD + d0, HD, wmma::mem_row_major);
#pragma unroll
      for (int qq = 0; qq < AQ; qq += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> xa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> rb;
        wmma::load_matrix_sync(xa, Xs + qq * S + kt * 16, S);
        wmma::load_matrix_sync(rb, Rs + qq * HD + d0, HD);
        wmma::mma_sync(acc, xa, rb, acc);
      }
      wmma::store_matrix_sync(Acc + kt * 16 * HD + d0, acc, HD, wmma::mem_row_major);
    }
  }
}

__global__ void __launch_bounds__(ATTN_THREADS)
attention_bwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                     const bf16* __restrict__ attn, const bf16* __restrict__ dattn,
                     bf16* __restrict__ dqkv, int S, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + S * HD;
  bf16* Qs = Vs + S * HD;
  bf16* dUs = Qs + AQ * HD;
  float* Sc = reinterpret_cast<float*>(dUs + AQ * HD);
  bf16* Xs = reinterpret_cast<bf16*>(Sc + AQ * S);
  float* dKa = reinterpret_cast<float*>(Xs + AQ * S);
  float* dVa = dKa + S * HD;
  float* Kb = dVa + S * HD;
  float* Dz = Kb + S;
  float* Stage = Dz + AQ;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
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
  for (int s = tid; s < S; s += ATTN_THREADS) Kb[s] = key_bias[(size_t)b * S + s];
  for (int i = tid; i < S * HD; i += ATTN_THREADS) {
    dKa[i] = 0.0f;
    dVa[i] = 0.0f;
  }

  const int r0 = warp * 16;
  float* sc = Sc + r0 * S;
  bf16* xw = Xs + r0 * S;
  float* stage = Stage + warp * 256;

  for (int q0 = 0; q0 < S; q0 += AQ) {
    __syncthreads();  // the previous tile's readers of Qs, dUs, Sc, Xs are done
    for (int i = tid; i < AQ * (HD / 8); i += ATTN_THREADS) {
      const int r = i / (HD / 8);
      const int c = (i % (HD / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < S)
        v = *reinterpret_cast<const uint4*>(base + (size_t)(q0 + r) * H3 + head * HD + c);
      *reinterpret_cast<uint4*>(Qs + r * HD + c) = v;
    }
    __syncthreads();
    const bool valid = q0 + r0 < S;  // warp-uniform (S % 16 == 0)

    if (valid) {
      // Scores and probabilities, exactly as the forward computes them.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[2];
      wmma::load_matrix_sync(qa[0], Qs + r0 * HD, HD);
      wmma::load_matrix_sync(qa[1], Qs + r0 * HD + 16, HD);
      for (int n0 = 0; n0 < S; n0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, Ks + n0 * HD + kk * 16, HD);
          wmma::mma_sync(acc, qa[kk], kb, acc);
        }
        wmma::store_matrix_sync(sc + n0, acc, S, wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        float* row = sc + r * S;
        float m = -3.0e38f;
        for (int j = lane; j < S; j += 32) {
          const float v = __fadd_rn(__fmul_rn(row[j], scale), Kb[j]);
          row[j] = v;
          m = fmaxf(m, v);
        }
        m = warp_max(m);
        float z = 0.0f;
        for (int j = lane; j < S; j += 32) {
          const float e = expf(row[j] - m);
          row[j] = e;
          z += e;
          xw[r * S + j] = __float2bfloat16(e);
        }
        z = warp_sum(z);
        const size_t ro = ((size_t)b * S + q0 + r0 + r) * H + head * HD + lane;
        const float dA = __bfloat162float(dattn[ro]);
        const float A = __bfloat162float(attn[ro]);
        const float dz = -warp_sum(dA * A) / z;
        dUs[(r0 + r) * HD + lane] = __float2bfloat16(dA / z);
        if (lane == 0) Dz[r0 + r] = dz;
      }
    } else {
      for (int i = lane; i < 16 * S; i += 32) xw[i] = __float2bfloat16(0.0f);
      for (int i = lane; i < 16 * HD; i += 32) dUs[r0 * HD + i] = __float2bfloat16(0.0f);
    }
    __syncthreads();
    accumulate_keys(Xs, dUs, dVa, S, warp);  // dV += bf16(P)^T bf16(dU)
    __syncthreads();

    if (valid) {
      // dL = bf16(P * (dU V^T + dz)), one 16x16 tile of dP at a time.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ua[2];
      wmma::load_matrix_sync(ua[0], dUs + r0 * HD, HD);
      wmma::load_matrix_sync(ua[1], dUs + r0 * HD + 16, HD);
      for (int n0 = 0; n0 < S; n0 += 16) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vb;
          wmma::load_matrix_sync(vb, Vs + n0 * HD + kk * 16, HD);
          wmma::mma_sync(acc, ua[kk], vb, acc);
        }
        wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4;
          const int cc = e & 15;
          const float p = sc[rr * S + n0 + cc];
          xw[rr * S + n0 + cc] = __float2bfloat16(p * (stage[e] + Dz[r0 + rr]));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    accumulate_keys(Xs, Qs, dKa, S, warp);  // dK += dL^T Q (scaled at the end)

    if (valid) {
      // dQ = scale * dL K for this warp's rows, 16 columns at a time.
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
      wmma::fill_fragment(acc[0], 0.0f);
      wmma::fill_fragment(acc[1], 0.0f);
      for (int k0 = 0; k0 < S; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> la;
        wmma::load_matrix_sync(la, xw + k0, S);
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
          wmma::load_matrix_sync(kb, Ks + k0 * HD + d * 16, HD);
          wmma::mma_sync(acc[d], la, kb, acc[d]);
        }
      }
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        wmma::store_matrix_sync(stage, acc[d], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4;
          const size_t o = ((size_t)b * S + q0 + r0 + rr) * H3 + head * HD + d * 16 + (e & 15);
          dqkv[o] = __float2bfloat16(stage[e] * scale);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < S * HD; i += ATTN_THREADS) {
    const int s = i / HD;
    const int d = i % HD;
    const size_t o = ((size_t)b * S + s) * H3 + head * HD + d;
    dqkv[o + H] = __float2bfloat16(dKa[i] * scale);
    dqkv[o + 2 * H] = __float2bfloat16(dVa[i]);
  }
}

// --------------------------------------------------------- workspace
struct Layout {
  size_t qkv, attn, ao, x1, hg, f, dfc, dhpre, daoc, dattn, dqkv;  // bf16
  size_t gp, dres, dx1, part_ln, part_b1, red_tmp, wpart, out3;    // f32
  size_t total;
};

Layout make_layout(int batch, int seq, int H, int I) {
  const size_t M = (size_t)batch * seq;
  size_t n = 0;
  auto take = [&n](size_t bytes) {
    const size_t o = n;
    n += (bytes + 255) / 256 * 256;
    return o;
  };
  Layout L;
  L.qkv = take(M * 3 * H * 2);
  L.attn = take(M * H * 2);
  L.ao = take(M * H * 2);
  L.x1 = take(M * H * 2);
  L.hg = take(M * I * 2);
  L.f = take(M * H * 2);
  L.dfc = take(M * H * 2);
  L.dhpre = take(M * I * 2);
  L.daoc = take(M * H * 2);
  L.dattn = take(M * H * 2);
  L.dqkv = take(M * 3 * H * 2);
  L.gp = take(M * I * 4);
  L.dres = take(M * H * 4);
  L.dx1 = take(M * H * 4);
  const size_t row_blocks = (M + 63) / 64;
  L.part_ln = take(row_blocks * 3 * H * 4);
  L.part_b1 = take(row_blocks * I * 4);
  const size_t widest = (size_t)(3 * H > I ? 3 * H : I);
  L.red_tmp = take(((M + COLSUM_CHUNK - 1) / COLSUM_CHUNK + 1) * widest * 4);
  const int Mi = (int)M;
  size_t wp = 0;
  const int shapes[4][2] = {{H, 3 * H}, {H, H}, {H, I}, {I, H}};
  for (const auto& s : shapes) {
    const size_t need = (size_t)wgrad_splits(Mi, s[0], s[1]) * s[0] * s[1] * 4;
    if (need > wp) wp = need;
  }
  L.wpart = take(wp);
  L.out3 = take((size_t)3 * H * 4);
  L.total = n;
  return L;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of device scratch fused_layer_backward needs at these shapes.
int fused_layer_backward_workspace(int batch, int seq, int hidden, int inter,
                                   unsigned long long* bytes) {
  *bytes = (unsigned long long)make_layout(batch, seq, hidden, inter).total;
  return 0;
}

// Shapes the wrapper has checked: H == num_heads * 32, H % 64 == 0,
// H <= 1024, I % 64 == 0, S % 16 == 0, 16 <= S <= 256, every pointer
// 16-byte aligned and contiguous. g, dx: [B, S, H] bf16; m1, m2: [B, S, H]
// bf16 or both null; the twelve grads are f32 in the weights' shapes
// (Wqkv [H, 3H], bqkv [3H], Wo [H, H], bo, ln1 scale/shift [H], W1 [H, I],
// b1 [I], W2 [I, H], b2, ln2 scale/shift [H]); workspace holds
// fused_layer_backward_workspace(...) bytes.
int fused_layer_backward(const void* x, const void* key_bias, const void* g, const void* m1,
                         const void* m2, const void* qkv_w, const void* qkv_b, const void* o_w,
                         const void* o_b, const void* ln1_s, const void* ln1_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, const void* ln2_s,
                         const void* ln2_b, void* dx, void* d_qkv_w, void* d_qkv_b, void* d_o_w,
                         void* d_o_b, void* d_ln1_s, void* d_ln1_b, void* d_w1, void* d_b1,
                         void* d_w2, void* d_b2, void* d_ln2_s, void* d_ln2_b, void* workspace,
                         int batch, int seq, int hidden, int num_heads, int inter, float scale,
                         float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  const int I = inter;
  const Layout L = make_layout(batch, seq, H, I);
  unsigned char* ws = reinterpret_cast<unsigned char*>(workspace);
  bf16* qkv = reinterpret_cast<bf16*>(ws + L.qkv);
  bf16* attn = reinterpret_cast<bf16*>(ws + L.attn);
  bf16* ao = reinterpret_cast<bf16*>(ws + L.ao);
  bf16* x1 = reinterpret_cast<bf16*>(ws + L.x1);
  bf16* hg = reinterpret_cast<bf16*>(ws + L.hg);
  bf16* f = reinterpret_cast<bf16*>(ws + L.f);
  bf16* dfc = reinterpret_cast<bf16*>(ws + L.dfc);
  bf16* dhpre = reinterpret_cast<bf16*>(ws + L.dhpre);
  bf16* daoc = reinterpret_cast<bf16*>(ws + L.daoc);
  bf16* dattn = reinterpret_cast<bf16*>(ws + L.dattn);
  bf16* dqkv = reinterpret_cast<bf16*>(ws + L.dqkv);
  float* gp = reinterpret_cast<float*>(ws + L.gp);
  float* dres = reinterpret_cast<float*>(ws + L.dres);
  float* dx1 = reinterpret_cast<float*>(ws + L.dx1);
  float* part_ln = reinterpret_cast<float*>(ws + L.part_ln);
  float* part_b1 = reinterpret_cast<float*>(ws + L.part_b1);
  float* red_tmp = reinterpret_cast<float*>(ws + L.red_tmp);
  float* wpart = reinterpret_cast<float*>(ws + L.wpart);
  float* out3 = reinterpret_cast<float*>(ws + L.out3);

  const bf16* xb = (const bf16*)x;
  const bf16* mask1 = (const bf16*)m1;
  const bf16* mask2 = (const bf16*)m2;
  const int row_blocks = (M + 63) / 64;
  cudaError_t e;
#define FLB_CHECK(call)            \
  do {                             \
    e = (call);                    \
    if (e != cudaSuccess) return e; \
  } while (0)

  // ---- forward recompute (K1's kernels)
  FLB_CHECK((launch_gemm<false, EPI_BIAS>(xb, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                          nullptr, nullptr, M, 3 * H, H, stream)));
  FLB_CHECK(launch_attention(qkv, (const float*)key_bias, attn, batch, seq, H, num_heads, scale,
                             stream));
  FLB_CHECK((launch_gemm<false, EPI_BIAS>(attn, (const bf16*)o_w, (const bf16*)o_b, ao, nullptr,
                                          nullptr, M, H, H, stream)));
  FLB_CHECK(launch_ln(xb, ao, mask1, (const float*)ln1_s, (const float*)ln1_b, x1, M, H, eps,
                      stream));
  FLB_CHECK((launch_gemm<false, EPI_BIAS_GELU_GRAD>(x1, (const bf16*)w1, (const bf16*)b1, hg,
                                                    nullptr, gp, M, I, H, stream)));
  FLB_CHECK((launch_gemm<false, EPI_BIAS>(hg, (const bf16*)w2, (const bf16*)b2, f, nullptr,
                                          nullptr, M, H, I, stream)));

  // ---- second LayerNorm, FFN
  FLB_CHECK(launch_ln_bwd<bf16>(x1, f, mask2, (const bf16*)g, (const float*)ln2_s, dres, dfc,
                                part_ln, M, H, eps, stream));
  FLB_CHECK(reduce_columns<float>(part_ln, row_blocks, 3 * H, out3, red_tmp, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln2_s, out3, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln2_b, out3 + H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_b2, out3 + 2 * H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(launch_wgrad(hg, dfc, (float*)d_w2, wpart, red_tmp, M, I, H, stream));
  FLB_CHECK((launch_gemm<true, EPI_MUL_AUX>(dfc, (const bf16*)w2, nullptr, dhpre, gp, part_b1, M,
                                            I, H, stream)));
  FLB_CHECK(reduce_columns<float>(part_b1, row_blocks, I, (float*)d_b1, red_tmp, stream));
  FLB_CHECK(launch_wgrad(x1, dhpre, (float*)d_w1, wpart, red_tmp, M, H, I, stream));
  FLB_CHECK((launch_gemm<true, EPI_ADD_AUX_F32>(dhpre, (const bf16*)w1, nullptr, dx1, dres,
                                                nullptr, M, H, I, stream)));

  // ---- first LayerNorm, output projection
  FLB_CHECK(launch_ln_bwd<float>(xb, ao, mask1, dx1, (const float*)ln1_s, dres, daoc, part_ln, M,
                                 H, eps, stream));
  FLB_CHECK(reduce_columns<float>(part_ln, row_blocks, 3 * H, out3, red_tmp, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln1_s, out3, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln1_b, out3 + H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_o_b, out3 + 2 * H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(launch_wgrad(attn, daoc, (float*)d_o_w, wpart, red_tmp, M, H, H, stream));
  FLB_CHECK((launch_gemm<true, EPI_BIAS>(daoc, (const bf16*)o_w, nullptr, dattn, nullptr, nullptr,
                                         M, H, H, stream)));

  // ---- attention, QKV projection, dx
  const size_t smem = attn_bwd_smem_bytes(seq);
  FLB_CHECK(cudaFuncSetAttribute(attention_bwd_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  attention_bwd_kernel<<<dim3(num_heads, batch), ATTN_THREADS, smem, stream>>>(
      qkv, (const float*)key_bias, attn, dattn, dqkv, seq, H, scale);
  FLB_CHECK(cudaGetLastError());
  FLB_CHECK(launch_wgrad(xb, dqkv, (float*)d_qkv_w, wpart, red_tmp, M, H, 3 * H, stream));
  FLB_CHECK(reduce_columns<bf16>(dqkv, M, 3 * H, (float*)d_qkv_b, red_tmp, stream));
  FLB_CHECK((launch_gemm<true, EPI_ADD_AUX_BF16>(dqkv, (const bf16*)qkv_w, nullptr, dx, dres,
                                                 nullptr, M, H, 3 * H, stream)));
#undef FLB_CHECK
  return cudaSuccess;
}

}  // extern "C"
