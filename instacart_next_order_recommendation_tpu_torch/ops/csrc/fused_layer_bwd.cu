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
//   attention, per head, with the deferred softmax denominator (P is the
//   unnormalised exp(x - m) in f32, z its row sum):
//     dU = dA / z, dV = bf16(P)^T bf16(dU), dP = bf16(dU) V^T,
//     dz = -sum_d(dA * A) / z, dL = bf16(P * (dP + dz)),
//     dQ = scale dL K, dK = scale dL^T Q             -> dqkv (bf16)
//   dWqkv = x^T dqkv; d_bqkv = sum(f32(dqkv)); dx = bf16(dres1 + dqkv Wqkv^T)
// Every product takes bf16 operands and accumulates in f32; every weight
// gradient is an f32 sum over the B*S rows.
//
// What bounds it on the H100: the GEMMs, about 3 * 2*B*S*(4*H^2 + 2*H*I)
// operations (forward recompute, dgrad, wgrad), plus 12*B*S^2*H in
// attention, against 989 TFLOP/s of bf16 tensor cores; the activations and
// f32 gelu' and residual-gradient streams that pass between the launches
// come to about 1.9 GB at B=64, S=256 (0.57 ms at 3.35 TB/s), more than the
// operations' 0.2 ms.
//
// Design:
// - Every product runs on the GEMM core of fused_layer_common.cuh (mma.sync
//   tensor cores, cp.async ring, epilogues in registers): the forward
//   recompute as K1 does it (X W), the three dgrad products (dY W^T, with
//   the gelu' product and its column partials, or the residual gradient,
//   in the epilogue) and the four weight gradients (X^T dY over row splits,
//   partial tiles summed in a fixed order by colsum_kernel).
// - Attention backward in two kernels on tensor cores, no atomics. The dQ
//   kernel, per 64-query tile, recomputes the scores in registers with the
//   forward's exact max m and sum z (the whole row at once where it fits
//   in registers, else the key tiles twice: head_dim 64 at S > 192, rule at
//   dq_row_in_registers), forms dz and dU, writes dU over dA (it
//   is the dK/dV kernel's input; nothing else reads dA), computes dP, dL
//   and dQ += dL K tile by tile, and leaves m, z and dz per row in an f32
//   workspace [3, B, heads, S]. The dK/dV kernel, per 64-key tile, loops
//   over the query tiles and computes K Q^T and V dU^T directly, so that
//   P^T and dL^T are accumulators in the A layout, from the saved m and dz;
//   bf16(P)^T feeds dV += P^T dU and dL^T feeds dK += dL^T Q, with Q and dU
//   read through ldmatrix.trans. Every operand is bf16 in JAX's kernel, so
//   each product is one mma (no hi/lo split as in K7).
// - The LayerNorm backwards are row kernels with the masks; bias and
//   LayerNorm grads are f32 column sums in a fixed order. Every sum runs in
//   a fixed order, so the result is the same, bit for bit, on every run.
// The TPU's head groups, 128-padding of K/V, FFN chunking and resident
// probabilities exist for VMEM and are not carried over.

#include "fused_layer_common.cuh"

namespace {

using namespace fl;

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

// ------------------------------------------------- weight-gradient GEMM
// The current device's SM count, read once per device (132 on an H100 SXM).
cudaError_t device_sm_count(int* sms) {
  static std::atomic<int> known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int n = known[dev & 63].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    known[dev & 63].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// Weight-gradient splits: about two blocks per SM over the 128 x 128
// output tiles, at least 512 rows a split. The split count fixes the order
// of the sums, so a card gives the same bits on every run.
int wgrad_splits(int M, int K1, int N, int sms) {
  const int tiles = ((K1 + GBM - 1) / GBM) * ((N + GBN - 1) / GBN);
  int s = (2 * sms + tiles - 1) / tiles;
  const int max_s = (M + 511) / 512;
  if (s > max_s) s = max_s;
  return s < 1 ? 1 : s;
}

int wgrad_rows_per_split(int M, int splits) {
  const int r = (M + splits - 1) / splits;
  return (r + GBK - 1) / GBK * GBK;
}

// out[K1, N] = A[M, K1]^T B[M, N] in f32: split partials on the GEMM core,
// then their sum in split order.
cudaError_t launch_wgrad(const bf16* A, const bf16* B, float* out, float* wpart, float* tmp,
                         int M, int K1, int N, int sms, cudaStream_t stream) {
  const int splits = wgrad_splits(M, K1, N, sms);
  cudaError_t e = launch_gemm<FORM_ATB, EPI_PARTIAL>(A, B, nullptr, wpart, nullptr, nullptr, K1,
                                                     N, M, stream, splits,
                                                     wgrad_rows_per_split(M, splits));
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
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(ln_bwd_kernel<DyT>, (size_t)LNB_WARPS * 3 * LN_MAX_H * 4, done);
  if (e != cudaSuccess) return e;
  ln_bwd_kernel<DyT><<<(M + LNB_ROWS - 1) / LNB_ROWS, LNB_WARPS * 32, smem, stream>>>(
      a, r, mask, dy, scale, dres, dmasked, part, M, H, eps);
  return cudaGetLastError();
}

// ------------------------------------------------ attention backward
// q, k, v at row stride 3H in the packed projection, A, dA and dU at row
// stride H, head_dim HD in {32, 64}; NT = ceil(S / 64) key (or query)
// tiles, all of a head's tiles resident in shared memory (S <= 256: 5 KB a
// tile at HD 32, 9 KB at HD 64).
template <int HD>
__device__ __forceinline__ View packed_view(int S, int H) {
  return View{(long long)S * 3 * H, HD, 3LL * H};
}

template <int HD>
__device__ __forceinline__ View row_view(int S, int H) {
  return View{(long long)S * H, HD, (long long)H};
}

// Wait until at most n (0..3, known after unrolling) copy groups are pending.
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

// bf16(p * (dp + dz)) as the A operand over columns [16 kc, 16 kc + 16),
// dz0 for row g and dz1 for row g + 8.
__device__ __forceinline__ void dl_operand(const float (&p)[8][4], const float (&dp)[8][4],
                                           int kc, float dz0, float dz1, uint32_t (&a)[4]) {
  a[0] = pack_bf16(p[2 * kc][0] * (dp[2 * kc][0] + dz0), p[2 * kc][1] * (dp[2 * kc][1] + dz0));
  a[1] = pack_bf16(p[2 * kc][2] * (dp[2 * kc][2] + dz1), p[2 * kc][3] * (dp[2 * kc][3] + dz1));
  a[2] = pack_bf16(p[2 * kc + 1][0] * (dp[2 * kc + 1][0] + dz0),
                   p[2 * kc + 1][1] * (dp[2 * kc + 1][1] + dz0));
  a[3] = pack_bf16(p[2 * kc + 1][2] * (dp[2 * kc + 1][2] + dz1),
                   p[2 * kc + 1][3] * (dp[2 * kc + 1][3] + dz1));
}

// Whether the dQ kernel keeps a warp's whole score row in registers: NT *
// 32 f32 a lane, beside dQ (HD / 2) and dU (HD / 4). At 152 of these (HD
// 32, S = 256) ptxas fits the kernel in 201 registers; at 176 (HD 64, S =
// 256) it spilled at the 255 cap, even with dP formed 32 keys at a time.
// Where the row does not fit, the kernel passes over the key tiles twice,
// as K7's dQ kernel does.
template <int HD, int NT>
__host__ __device__ constexpr bool dq_row_in_registers() {
  return NT * 32 + HD / 2 + HD / 4 <= 160;
}

// dQ of one 64-query tile; dA is replaced by dU = bf16(dA / z) in place,
// and each row's m, z and dz go to stats ([3][B][heads][S] f32). One pass
// where the score row fits in registers: the exact max m, then z = sum of
// exp(x - m). Else two: the first keeps m and z online (z rescaled when m
// grows), the second recomputes each key tile's scores.
template <int HD, int NT>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                   const bf16* __restrict__ attn, bf16* __restrict__ dattn,
                   bf16* __restrict__ dqkv, float* __restrict__ stats, int S, int H,
                   float scale) {
  constexpr int LD = row_stride<HD>();
  constexpr int ATILE = tile_elems<HD>();
  constexpr int AROW = row_stride<HD>() * 2;  // bytes
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dAs = Qs + ATILE;
  bf16* As = dAs + ATILE;
  bf16* Ks = As + ATILE;
  bf16* Vs = Ks + NT * ATILE;
  float* Kb = reinterpret_cast<float*>(Vs + NT * ATILE);
  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const View vqkv = packed_view<HD>(S, H);
  const View vh = row_view<HD>(S, H);

  load_tile<HD>(Qs, qkv, vqkv, bi, hi, q0, S, tid);
#pragma unroll
  for (int t = 0; t < NT; ++t) load_tile<HD>(Ks + t * ATILE, qkv + H, vqkv, bi, hi, t * TK, S, tid);
  cp_commit();
#pragma unroll
  for (int t = 0; t < NT; ++t)
    load_tile<HD>(Vs + t * ATILE, qkv + 2 * H, vqkv, bi, hi, t * TK, S, tid);
  load_tile<HD>(dAs, dattn, vh, bi, hi, q0, S, tid);
  load_tile<HD>(As, attn, vh, bi, hi, q0, S, tid);
  cp_commit();
  load_bias(Kb, key_bias, bi, NT, S, tid);
  cp_wait<1>();
  __syncthreads();

  bf16* Qw = Qs + warp * 16 * LD;
  const uint32_t qa = smem_addr(Qw) + lane_a<HD>(lane);
  const uint32_t kbt = smem_addr(Ks) + lane_bt<HD>(lane);  // K as B^T (scores)
  const uint32_t kb = smem_addr(Ks) + lane_a<HD>(lane);    // K as B (dQ)
  const uint32_t vbt = smem_addr(Vs) + lane_bt<HD>(lane);  // V as B^T (dP)

  // Scores, the exact max m and the sum z of P = exp(x - m), as the
  // forward: the whole row at once, or online over the key tiles.
  constexpr bool ROW = dq_row_in_registers<HD, NT>();
  float x[ROW ? NT : 1][8][4];
  float m0 = INIT_MAX, m1 = INIT_MAX, z0 = 0.0f, z1 = 0.0f;
  if constexpr (ROW) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mma_abt<HD>(x[t], qa, kbt + t * ATILE * 2);
      logits(x[t], Kb + t * TK, scale, lane);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float t0, t1;
      tile_max(x[t], t0, t1);
      m0 = fmaxf(m0, t0);
      m1 = fmaxf(m1, t1);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[t][j][0] = expf(x[t][j][0] - m0);
        x[t][j][1] = expf(x[t][j][1] - m0);
        x[t][j][2] = expf(x[t][j][2] - m1);
        x[t][j][3] = expf(x[t][j][3] - m1);
        z0 += x[t][j][0] + x[t][j][1];
        z1 += x[t][j][2] + x[t][j][3];
      }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      mma_abt<HD>(x[0], qa, kbt + t * ATILE * 2);
      logits(x[0], Kb + t * TK, scale, lane);
      float t0, t1;
      tile_max(x[0], t0, t1);
      const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e0 += expf(x[0][j][0] - n0) + expf(x[0][j][1] - n0);
        e1 += expf(x[0][j][2] - n1) + expf(x[0][j][3] - n1);
      }
      z0 = fmaf(z0, expf(m0 - n0), quad_sum(e0));
      z1 = fmaf(z1, expf(m1 - n1), quad_sum(e1));
      m0 = n0;
      m1 = n1;
    }
  }
  cp_wait<0>();
  __syncthreads();

  // dz and dU from dA and A, read in the A-operand layout (rows g, g + 8;
  // columns 16 kk + 8 hh + c2, + 1).
  const bf16* dAw = dAs + warp * 16 * LD;
  const bf16* Aw = As + warp * 16 * LD;
  const int r0 = q0 + warp * 16 + g;
  uint32_t du[HD / 16][4];
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = kk * 16 + hh * 8 + c2;
      const float2 da0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dAw + g * LD + d));
      const float2 da1 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dAw + (g + 8) * LD + d));
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Aw + g * LD + d));
      const float2 a1 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Aw + (g + 8) * LD + d));
      s0 += da0.x * a0.x + da0.y * a0.y;
      s1 += da1.x * a1.x + da1.y * a1.y;
      du[kk][2 * hh] = pack_bf16(da0.x / z0, da0.y / z0);
      du[kk][2 * hh + 1] = pack_bf16(da1.x / z1, da1.y / z1);
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(dattn + vh.at(bi, hi, r0) + d) = du[kk][2 * hh];
      if (r0 + 8 < S)
        *reinterpret_cast<uint32_t*>(dattn + vh.at(bi, hi, r0 + 8) + d) = du[kk][2 * hh + 1];
    }
  const float dz0 = -quad_sum(s0) / z0;
  const float dz1 = -quad_sum(s1) / z1;
  if ((lane & 3) == 0) {
    const size_t plane = (size_t)gridDim.z * gridDim.y * S;
    const size_t row = ((size_t)bi * gridDim.y + hi) * S;
    if (r0 < S) {
      stats[row + r0] = m0;
      stats[plane + row + r0] = z0;
      stats[2 * plane + row + r0] = dz0;
    }
    if (r0 + 8 < S) {
      stats[row + r0 + 8] = m1;
      stats[plane + row + r0 + 8] = z1;
      stats[2 * plane + row + r0 + 8] = dz1;
    }
  }

  // Per key tile: dP = bf16(dU) V^T, dL = bf16(P (dP + dz)), dQ += dL K.
  float dq[HD / 8][4];
  zero<HD>(dq);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if constexpr (!ROW) {  // this tile's P = exp(x - m) again
      mma_abt<HD>(x[0], qa, kbt + t * ATILE * 2);
      logits(x[0], Kb + t * TK, scale, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[0][j][0] = expf(x[0][j][0] - m0);
        x[0][j][1] = expf(x[0][j][1] - m0);
        x[0][j][2] = expf(x[0][j][2] - m1);
        x[0][j][3] = expf(x[0][j][3] - m1);
      }
    }
    const float(&p)[8][4] = x[ROW ? t : 0];
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        ldsm_x4(b, vbt + t * ATILE * 2 + jj * 16 * AROW + kk * 32);
        mma(dp[2 * jj], du[kk], b[0], b[1]);
        mma(dp[2 * jj + 1], du[kk], b[2], b[3]);
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[1][4];
      dl_operand(p, dp, kc, dz0, dz1, a[0]);
      mma_ab<HD, 1>(dq, a, kb + t * ATILE * 2, kc);
    }
  }
  store_rows<HD>(dq, scale, Qw, dqkv, vqkv, bi, hi, q0 + warp * 16, S, lane);
}

// dK and dV of one 64-key tile, looping over the query tiles. A warp owns
// 16 keys: its accumulator tiles are K Q^T and V dU^T (keys by queries).
template <int HD, int NT>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                     const bf16* __restrict__ du, const float* __restrict__ stats,
                     bf16* __restrict__ dqkv, int S, int H, float scale) {
  constexpr int LD = row_stride<HD>();
  constexpr int ATILE = tile_elems<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + ATILE;
  bf16* Qs = Vs + ATILE;
  bf16* dUs = Qs + NT * ATILE;
  float* Ms = reinterpret_cast<float*>(dUs + NT * ATILE);  // per query: m, dz
  float* Dzs = Ms + NT * TQ;
  const int k0 = blockIdx.x * TK;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const View vqkv = packed_view<HD>(S, H);
  const View vh = row_view<HD>(S, H);

  load_tile<HD>(Ks, qkv + H, vqkv, bi, hi, k0, S, tid);
  load_tile<HD>(Vs, qkv + 2 * H, vqkv, bi, hi, k0, S, tid);
  cp_commit();
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    load_tile<HD>(Qs + t * ATILE, qkv, vqkv, bi, hi, t * TQ, S, tid);
    load_tile<HD>(dUs + t * ATILE, du, vh, bi, hi, t * TQ, S, tid);
    cp_commit();
  }
  {
    const size_t plane = (size_t)gridDim.z * gridDim.y * S;
    const size_t row = ((size_t)bi * gridDim.y + hi) * S;
    for (int j = tid; j < NT * TQ; j += THREADS) {
      const bool ok = j < S;  // queries past S: P = exp(x - 3e38) = 0
      Ms[j] = ok ? stats[row + j] : -PAD_BIAS;
      Dzs[j] = ok ? stats[2 * plane + row + j] : 0.0f;
    }
  }
  const int kr = k0 + warp * 16 + (lane >> 2);  // this lane's keys: kr, kr + 8
  const float b0 = kr < S ? key_bias[(size_t)bi * S + kr] : PAD_BIAS;
  const float b1 = kr + 8 < S ? key_bias[(size_t)bi * S + kr + 8] : PAD_BIAS;

  bf16* Kw = Ks + warp * 16 * LD;
  bf16* Vw = Vs + warp * 16 * LD;
  const uint32_t ka = smem_addr(Kw) + lane_a<HD>(lane);
  const uint32_t va = smem_addr(Vw) + lane_a<HD>(lane);
  const uint32_t qbt = smem_addr(Qs) + lane_bt<HD>(lane);  // Q, dU as B^T
  const uint32_t dubt = smem_addr(dUs) + lane_bt<HD>(lane);
  const uint32_t qb = smem_addr(Qs) + lane_a<HD>(lane);    // Q, dU as B
  const uint32_t dub = smem_addr(dUs) + lane_a<HD>(lane);

  float dk[HD / 8][4], dv[HD / 8][4];
  zero<HD>(dk);
  zero<HD>(dv);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    cp_wait_upto(NT - 1 - t);
    __syncthreads();
    float p[8][4], dl[8][4];
    mma_abt<HD>(p, ka, qbt + t * ATILE * 2);    // scores, keys by queries
    mma_abt<HD>(dl, va, dubt + t * ATILE * 2);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = t * TQ + j * 8 + 2 * (lane & 3);
      const float2 m = *reinterpret_cast<const float2*>(Ms + c);
      const float2 dz = *reinterpret_cast<const float2*>(Dzs + c);
      p[j][0] = expf(__fadd_rn(__fmul_rn(p[j][0], scale), b0) - m.x);
      p[j][1] = expf(__fadd_rn(__fmul_rn(p[j][1], scale), b0) - m.y);
      p[j][2] = expf(__fadd_rn(__fmul_rn(p[j][2], scale), b1) - m.x);
      p[j][3] = expf(__fadd_rn(__fmul_rn(p[j][3], scale), b1) - m.y);
      dl[j][0] = p[j][0] * (dl[j][0] + dz.x);
      dl[j][1] = p[j][1] * (dl[j][1] + dz.y);
      dl[j][2] = p[j][2] * (dl[j][2] + dz.x);
      dl[j][3] = p[j][3] * (dl[j][3] + dz.y);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[1][4];
      a_operand(p, kc, 1.0f, 1.0f, a[0]);
      mma_ab<HD, 1>(dv, a, dub + t * ATILE * 2, kc);  // dV += bf16(P)^T dU
      a_operand(dl, kc, 1.0f, 1.0f, a[0]);
      mma_ab<HD, 1>(dk, a, qb + t * ATILE * 2, kc);   // dK += dL^T Q
    }
  }
  store_rows<HD>(dk, scale, Kw, dqkv + H, vqkv, bi, hi, k0 + warp * 16, S, lane);
  store_rows<HD>(dv, 1.0f, Vw, dqkv + 2 * H, vqkv, bi, hi, k0 + warp * 16, S, lane);
}

template <int HD, int NT>
cudaError_t launch_attention_bwd_nt(const bf16* qkv, const float* key_bias, const bf16* attn,
                                    bf16* dattn, bf16* dqkv, float* stats, int batch, int seq,
                                    int H, int heads, float scale, cudaStream_t stream) {
  constexpr int ATILE = tile_elems<HD>();
  const size_t dq_smem = (size_t)(3 + 2 * NT) * ATILE * 2 + (size_t)NT * TK * 4;
  const size_t dkdv_smem = (size_t)(2 + 2 * NT) * ATILE * 2 + (size_t)2 * NT * TQ * 4;
  static std::atomic<unsigned long long> dq_done{0}, dkdv_done{0};
  cudaError_t e = allow_smem_once(attn_bwd_dq_kernel<HD, NT>, dq_smem, dq_done);
  if (e != cudaSuccess) return e;
  e = allow_smem_once(attn_bwd_dkdv_kernel<HD, NT>, dkdv_smem, dkdv_done);
  if (e != cudaSuccess) return e;
  const dim3 grid(NT, heads, batch);
  attn_bwd_dq_kernel<HD, NT><<<grid, THREADS, dq_smem, stream>>>(qkv, key_bias, attn, dattn,
                                                                  dqkv, stats, seq, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<HD, NT><<<grid, THREADS, dkdv_smem, stream>>>(qkv, key_bias, dattn,
                                                                      stats, dqkv, seq, H, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_attention_bwd_hd(const bf16* qkv, const float* key_bias, const bf16* attn,
                                    bf16* dattn, bf16* dqkv, float* stats, int batch, int seq,
                                    int H, int heads, float scale, cudaStream_t stream) {
  switch ((seq + TK - 1) / TK) {
    case 1: return launch_attention_bwd_nt<HD, 1>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 2: return launch_attention_bwd_nt<HD, 2>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 3: return launch_attention_bwd_nt<HD, 3>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 4: return launch_attention_bwd_nt<HD, 4>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_attention_bwd(const bf16* qkv, const float* key_bias, const bf16* attn,
                                 bf16* dattn, bf16* dqkv, float* stats, int batch, int seq, int H,
                                 int heads, float scale, cudaStream_t stream) {
  if (heads <= 0 || H % heads) return cudaErrorInvalidValue;
  switch (H / heads) {
    case 32: return launch_attention_bwd_hd<32>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 64: return launch_attention_bwd_hd<64>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- workspace
struct Layout {
  size_t qkv, attn, ao, x1, hg, f, dfc, dhpre, daoc, dattn, dqkv;      // bf16
  size_t gp, dres, dx1, part_ln, part_b1, red_tmp, wpart, out3, stats;  // f32
  size_t total;
};

Layout make_layout(int batch, int seq, int H, int heads, int I, int sms) {
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
  L.part_ln = take((M + LNB_ROWS - 1) / LNB_ROWS * 3 * H * 4);
  L.part_b1 = take((size_t)gemm_row_tiles((int)M) * I * 4);
  const size_t widest = (size_t)(3 * H > I ? 3 * H : I);
  L.red_tmp = take(((M + COLSUM_CHUNK - 1) / COLSUM_CHUNK + 1) * widest * 4);
  const int Mi = (int)M;
  size_t wp = 0;
  const int shapes[4][2] = {{H, 3 * H}, {H, H}, {H, I}, {I, H}};
  for (const auto& s : shapes) {
    const size_t need = (size_t)wgrad_splits(Mi, s[0], s[1], sms) * s[0] * s[1] * 4;
    if (need > wp) wp = need;
  }
  L.wpart = take(wp);
  L.out3 = take((size_t)3 * H * 4);
  L.stats = take((size_t)3 * M * heads * 4);
  L.total = n;
  return L;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Bytes of device scratch fused_layer_backward needs at these shapes on the
// current device.
int fused_layer_backward_workspace(int batch, int seq, int hidden, int num_heads, int inter,
                                   unsigned long long* bytes) {
  int sms = 0;
  const cudaError_t e = device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  *bytes = (unsigned long long)make_layout(batch, seq, hidden, num_heads, inter, sms).total;
  return 0;
}

// Shapes the wrapper has checked: H == num_heads * head_dim with head_dim
// 32 or 64, H % 64 == 0, H <= 1024, I % 64 == 0, S % 16 == 0,
// 16 <= S <= 256, every pointer 16-byte aligned and contiguous. g, dx: [B, S, H] bf16; m1, m2: [B, S, H]
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
  int sms = 0;
  cudaError_t e = device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const Layout L = make_layout(batch, seq, H, num_heads, I, sms);
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
  float* stats = reinterpret_cast<float*>(ws + L.stats);

  const bf16* xb = (const bf16*)x;
  const bf16* mask1 = (const bf16*)m1;
  const bf16* mask2 = (const bf16*)m2;
  const int ln_blocks = (M + LNB_ROWS - 1) / LNB_ROWS;
#define FLB_CHECK(call)            \
  do {                             \
    e = (call);                    \
    if (e != cudaSuccess) return e; \
  } while (0)

  // ---- forward recompute (K1's kernels)
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(xb, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                          nullptr, nullptr, M, 3 * H, H, stream)));
  FLB_CHECK(launch_attention(qkv, (const float*)key_bias, attn, batch, seq, H, num_heads, scale,
                             stream));
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(attn, (const bf16*)o_w, (const bf16*)o_b, ao, nullptr,
                                          nullptr, M, H, H, stream)));
  FLB_CHECK(launch_ln(xb, ao, mask1, (const float*)ln1_s, (const float*)ln1_b, x1, M, H, eps,
                      stream));
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS_GELU_GRAD>(x1, (const bf16*)w1, (const bf16*)b1, hg,
                                                    nullptr, gp, M, I, H, stream)));
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(hg, (const bf16*)w2, (const bf16*)b2, f, nullptr,
                                          nullptr, M, H, I, stream)));

  // ---- second LayerNorm, FFN
  FLB_CHECK(launch_ln_bwd<bf16>(x1, f, mask2, (const bf16*)g, (const float*)ln2_s, dres, dfc,
                                part_ln, M, H, eps, stream));
  FLB_CHECK(reduce_columns<float>(part_ln, ln_blocks, 3 * H, out3, red_tmp, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln2_s, out3, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln2_b, out3 + H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_b2, out3 + 2 * H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(launch_wgrad(hg, dfc, (float*)d_w2, wpart, red_tmp, M, I, H, sms, stream));
  FLB_CHECK((launch_gemm<FORM_XWT, EPI_MUL_AUX>(dfc, (const bf16*)w2, nullptr, dhpre, gp, part_b1, M,
                                            I, H, stream)));
  FLB_CHECK(reduce_columns<float>(part_b1, gemm_row_tiles(M), I, (float*)d_b1, red_tmp, stream));
  FLB_CHECK(launch_wgrad(x1, dhpre, (float*)d_w1, wpart, red_tmp, M, H, I, sms, stream));
  FLB_CHECK((launch_gemm<FORM_XWT, EPI_ADD_AUX_F32>(dhpre, (const bf16*)w1, nullptr, dx1, dres,
                                                nullptr, M, H, I, stream)));

  // ---- first LayerNorm, output projection
  FLB_CHECK(launch_ln_bwd<float>(xb, ao, mask1, dx1, (const float*)ln1_s, dres, daoc, part_ln, M,
                                 H, eps, stream));
  FLB_CHECK(reduce_columns<float>(part_ln, ln_blocks, 3 * H, out3, red_tmp, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln1_s, out3, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_ln1_b, out3 + H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(cudaMemcpyAsync(d_o_b, out3 + 2 * H, H * 4, cudaMemcpyDeviceToDevice, stream));
  FLB_CHECK(launch_wgrad(attn, daoc, (float*)d_o_w, wpart, red_tmp, M, H, H, sms, stream));
  FLB_CHECK((launch_gemm<FORM_XWT, EPI_BIAS>(daoc, (const bf16*)o_w, nullptr, dattn, nullptr, nullptr,
                                         M, H, H, stream)));

  // ---- attention, QKV projection, dx
  FLB_CHECK(launch_attention_bwd(qkv, (const float*)key_bias, attn, dattn, dqkv, stats, batch,
                                 seq, H, num_heads, scale, stream));
  FLB_CHECK(launch_wgrad(xb, dqkv, (float*)d_qkv_w, wpart, red_tmp, M, H, 3 * H, sms, stream));
  FLB_CHECK(reduce_columns<bf16>(dqkv, M, 3 * H, (float*)d_qkv_b, red_tmp, stream));
  FLB_CHECK((launch_gemm<FORM_XWT, EPI_ADD_AUX_BF16>(dqkv, (const bf16*)qkv_w, nullptr, dx, dres,
                                                 nullptr, M, H, 3 * H, stream)));
#undef FLB_CHECK
  return cudaSuccess;
}

}  // extern "C"
