// Backward of one post-LN BERT encoder layer (with optional dropout masks),
// bf16 activations, for Hopper: dx plus all twelve weight gradients.
//
// Replaces: the JAX package's ops/fused_layer.py::_bwd_kernel in its fully
// fused form (wgrads=True, reached through _fused_backward from the
// custom_vjp of fused_encoder_layer_train), and its resid form (resid=True:
// attn, ao, x1 and f read from the forward's saved residuals, as
// _train_core's fwd_rule passes them). Same function, same cast points:
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
// - Every product runs on the GEMM core of fused_layer_common.cuh (wgmma
//   fed by TMA through mbarriers, persistent blocks, epilogues stored by
//   TMA): the forward recompute as K1 does it (X W), the four dgrad
//   products (dY W^T, with the gelu' product and its column partials, or
//   the residual gradient, in the epilogue) and the four weight gradients
//   (X^T dY over row splits, partial tiles summed in a fixed order by
//   colsum_kernel).
// - Attention backward in two kernels on tensor cores, no atomics, each
//   streaming the other side's 64-row tiles through a cp.async ring (any S
//   up to 512, head_dim 16 to 128). The dQ kernel, per 64-query tile,
//   passes over the key tiles twice: first the scores' max m and sum z
//   online, then the scores again, forms dz and dU, writes dU over dA (it
//   is the dK/dV kernel's input; nothing else reads dA), computes dP, dL
//   and dQ += dL K tile by tile, and leaves m, z and dz per row in an f32
//   workspace [3, B, heads, S]. The dK/dV kernel, per 64-key tile, loops
//   over the query tiles and computes K Q^T and V dU^T directly, so that
//   P^T and dL^T are accumulators in the A layout, from the saved m and dz;
//   bf16(P)^T feeds dV += P^T dU and dL^T feeds dK += dL^T Q, with Q and dU
//   read through ldmatrix.trans. Every operand is bf16 in JAX's kernel, so
//   each product is one mma (no hi/lo split as in K7).
// - The resid form reads the four residuals the forward kept (K1's
//   save_resid) in place of four of the six recompute launches; it sums the
//   same bf16 values in the same order, so its results are the recompute
//   form's, bit for bit.
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
// Weight-gradient splits: about two work items (128 x 128 output tiles of
// one split) per SM, at least 512 rows a split. The split count fixes the
// order of the sums, so a card gives the same bits on every run.
int wgrad_splits(int M, int K1, int N, int sms) {
  constexpr int BM = GemmShape<FORM_ATB, EPI_PARTIAL>::BM;
  const int tiles = ((K1 + BM - 1) / BM) * ((N + GBN - 1) / GBN);
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
// res = bf16(a + bf16(r * rmask)) (LN input, recomputed; r alone where
// rmask is null: the residual-saving form passes r already masked) and
// upstream dy:
//   nh = (res - mean) * inv;  dnh = dy * scale
//   dres = inv * (dnh - mean(dnh) - nh * mean(dnh * nh))          (f32 out)
//   dmasked = bf16(dres * gmask)                                  (bf16 out)
// and per-block column partials [3][H] of dy * nh, dy and dres * gmask.
constexpr int LNB_WARPS = 8;
constexpr int LNB_ROWS = 64;

template <typename DyT>
__global__ void __launch_bounds__(LNB_WARPS * 32)
ln_bwd_kernel(const bf16* __restrict__ a, const bf16* __restrict__ r,
              const bf16* __restrict__ rmask, const bf16* __restrict__ gmask,
              const DyT* __restrict__ dy,
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
        v[t] = residual_in(a, r, rmask, off + lane + 32 * t);
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
        const float dm = gmask != nullptr ? dr * __bfloat162float(gmask[off + j]) : dr;
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
cudaError_t launch_ln_bwd(const bf16* a, const bf16* r, const bf16* rmask, const bf16* gmask,
                          const DyT* dy, const float* scale, float* dres, bf16* dmasked,
                          float* part, int M, int H, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)LNB_WARPS * 3 * H * 4;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(ln_bwd_kernel<DyT>, (size_t)LNB_WARPS * 3 * LN_MAX_H * 4, done);
  if (e != cudaSuccess) return e;
  ln_bwd_kernel<DyT><<<(M + LNB_ROWS - 1) / LNB_ROWS, LNB_WARPS * 32, smem, stream>>>(
      a, r, rmask, gmask, dy, scale, dres, dmasked, part, M, H, eps);
  return cudaGetLastError();
}

// ------------------------------------------------ attention backward
// q, k, v at row stride 3H in the packed projection, A, dA and dU at row
// stride H, head_dim HD in {16, 32, 64, 128}, any S up to MAX_SEQ. Each
// kernel holds one 64-row tile of its own side and streams the other
// side's tiles through a two-stage cp.async ring, as K7 does, so shared
// memory does not grow with S (a head's 16 tiles at S = 512 would take 272
// KB at HD 128). A form that held all the other side's tiles in shared
// memory (S <= 256) read 0.4-0.7% slower than these kernels on an H100
// (MiniLM's widths, S = 256, PERF.md), and is gone.
template <int HD>
__device__ __forceinline__ View packed_view(int S, int H) {
  return View{(long long)S * 3 * H, HD, 3LL * H};
}

template <int HD>
__device__ __forceinline__ View row_view(int S, int H) {
  return View{(long long)S * H, HD, (long long)H};
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

// dQ of one 64-query tile; dA is replaced by dU = bf16(dA / z) in place
// (it is the dK/dV kernel's input; nothing else reads dA), and each row's
// m, z and dz go to stats ([3][B][heads][S] f32). Two passes over the key
// tiles: the first keeps m and z online (z rescaled when m grows), the
// second recomputes each tile's scores, P = exp(x - m), dP = bf16(dU) V^T,
// dL = bf16(P (dP + dz)) and dQ += dL K. The K tiles (pass one), then the
// K and V tiles (pass two), come through the ring.
template <int HD>
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
  bf16* ring = As + ATILE;                                 // two stages of (K, V)
  float* Kb = reinterpret_cast<float*>(ring + 4 * ATILE);  // n_tiles * 64 key biases
  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int n_tiles = (S + TK - 1) / TK;
  const View vqkv = packed_view<HD>(S, H);
  const View vh = row_view<HD>(S, H);

  // Steps 0 .. n - 1 bring K tile `step` (pass one), n .. 2 n - 1 the K and
  // V tiles `step - n` (pass two).
  auto issue = [&](int step) {
    bf16* dst = ring + (step & 1) * 2 * ATILE;
    if (step < n_tiles) {
      load_tile<HD>(dst, qkv + H, vqkv, bi, hi, step * TK, S, tid);
    } else if (step < 2 * n_tiles) {
      load_tile<HD>(dst, qkv + H, vqkv, bi, hi, (step - n_tiles) * TK, S, tid);
      load_tile<HD>(dst + ATILE, qkv + 2 * H, vqkv, bi, hi, (step - n_tiles) * TK, S, tid);
    }
    cp_commit();
  };
  load_tile<HD>(Qs, qkv, vqkv, bi, hi, q0, S, tid);
  load_tile<HD>(dAs, dattn, vh, bi, hi, q0, S, tid);
  load_tile<HD>(As, attn, vh, bi, hi, q0, S, tid);
  issue(0);  // one group with Q, dA and A
  load_bias(Kb, key_bias, bi, n_tiles, S, tid);

  bf16* Qw = Qs + warp * 16 * LD;
  const uint32_t qa = smem_addr(Qw) + lane_a<HD>(lane);
  const uint32_t kbt = smem_addr(ring) + lane_bt<HD>(lane);          // K as B^T (scores)
  const uint32_t kb = smem_addr(ring) + lane_a<HD>(lane);            // K as B (dQ)
  const uint32_t vbt = smem_addr(ring + ATILE) + lane_bt<HD>(lane);  // V as B^T (dP)

  float x[8][4];
  float m0 = INIT_MAX, m1 = INIT_MAX, z0 = 0.0f, z1 = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    mma_abt<HD>(x, qa, kbt + (t & 1) * 2 * ATILE * 2);
    logits(x, Kb + t * TK, scale, lane);
    float t0, t1;
    tile_max(x, t0, t1);
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e0 += expf(x[j][0] - n0) + expf(x[j][1] - n0);
      e1 += expf(x[j][2] - n1) + expf(x[j][3] - n1);
    }
    z0 = fmaf(z0, expf(m0 - n0), quad_sum(e0));
    z1 = fmaf(z1, expf(m1 - n1), quad_sum(e1));
    m0 = n0;
    m1 = n1;
    __syncthreads();
  }

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

  float dq[HD / 8][4];
  zero<HD>(dq);
  for (int t = 0; t < n_tiles; ++t) {
    issue(n_tiles + t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = ((n_tiles + t) & 1) * 2 * ATILE * 2;
    mma_abt<HD>(x, qa, kbt + stage);  // this tile's P = exp(x - m) again
    logits(x, Kb + t * TK, scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j][0] = expf(x[j][0] - m0);
      x[j][1] = expf(x[j][1] - m0);
      x[j][2] = expf(x[j][2] - m1);
      x[j][3] = expf(x[j][3] - m1);
    }
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
        ldsm_x4(b, vbt + stage + jj * 16 * AROW + kk * 32);
        mma(dp[2 * jj], du[kk], b[0], b[1]);
        mma(dp[2 * jj + 1], du[kk], b[2], b[3]);
      }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[1][4];
      dl_operand(x, dp, kc, dz0, dz1, a[0]);
      mma_ab<HD, 1>(dq, a, kb + stage, kc);
    }
    __syncthreads();
  }
  store_rows<HD>(dq, scale, Qw, dqkv, vqkv, bi, hi, q0 + warp * 16, S, lane);
}

// dK and dV of one 64-key tile, looping over the query tiles, whose Q and dU
// tiles come through the ring. A warp owns 16 keys: its accumulator tiles
// are K Q^T and V dU^T (keys by queries), so that P^T and dL^T are
// accumulators in the A layout, from the saved m and dz; bf16(P)^T feeds
// dV += P^T dU and dL^T feeds dK += dL^T Q. A query tile goes in NJ
// 8-column groups at a time: the whole tile, or at head_dim 128 (whose dK
// and dV accumulators hold 128 f32 a lane) its two halves, one after the
// other (not unrolled, so that ptxas does not hoist the second half's
// scores), which keeps P^T and dL^T at 32 registers: no spill. Each score
// is the same dot product either way, and the halves feed dK and dV in the
// same order. At head_dim 32
// ptxas's own choice trims the kernel to 128 registers (a fourth block per
// SM) and spills, as K7's dK/dV kernel; asked for three blocks it keeps what
// it needs; at head_dim 16 it picks 80 and spills, and asked for four it
// does not.
template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 16 ? 4 : HD == 32 ? 3 : 0)
attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                     const bf16* __restrict__ du, const float* __restrict__ stats,
                     bf16* __restrict__ dqkv, int S, int H, float scale) {
  constexpr int LD = row_stride<HD>();
  constexpr int ATILE = tile_elems<HD>();
  constexpr int NJ = HD <= 64 ? 8 : 4;
  constexpr int ROW = row_stride<HD>() * 2;  // bytes
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + ATILE;
  bf16* ring = Vs + ATILE;                                 // two stages of (Q, dU)
  float* Ms = reinterpret_cast<float*>(ring + 4 * ATILE);  // per query: m, dz
  const int k0 = blockIdx.x * TK;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (S + TQ - 1) / TQ;
  float* Dzs = Ms + n_tiles * TQ;
  const View vqkv = packed_view<HD>(S, H);
  const View vh = row_view<HD>(S, H);

  auto issue = [&](int step) {  // Q and dU tile `step`
    if (step < n_tiles) {
      bf16* dst = ring + (step & 1) * 2 * ATILE;
      load_tile<HD>(dst, qkv, vqkv, bi, hi, step * TQ, S, tid);
      load_tile<HD>(dst + ATILE, du, vh, bi, hi, step * TQ, S, tid);
    }
    cp_commit();
  };
  load_tile<HD>(Ks, qkv + H, vqkv, bi, hi, k0, S, tid);
  load_tile<HD>(Vs, qkv + 2 * H, vqkv, bi, hi, k0, S, tid);
  issue(0);  // one group with K and V
  {
    const size_t plane = (size_t)gridDim.z * gridDim.y * S;
    const size_t row = ((size_t)bi * gridDim.y + hi) * S;
    for (int j = tid; j < n_tiles * TQ; j += THREADS) {
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
  const uint32_t qbt = smem_addr(ring) + lane_bt<HD>(lane);  // Q, dU as B^T
  const uint32_t dubt = smem_addr(ring + ATILE) + lane_bt<HD>(lane);
  const uint32_t qb = smem_addr(ring) + lane_a<HD>(lane);    // Q, dU as B
  const uint32_t dub = smem_addr(ring + ATILE) + lane_a<HD>(lane);

  float dk[HD / 8][4], dv[HD / 8][4];
  zero<HD>(dk);
  zero<HD>(dv);
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = (t & 1) * 2 * ATILE * 2;
#pragma unroll 1
    for (int h = 0; h < 8 / NJ; ++h) {
      const uint32_t rows = stage + h * NJ * 8 * ROW;  // the part's first query
      float p[NJ][4], dl[NJ][4];
      mma_abt<HD>(p, ka, qbt + rows);    // scores, keys by queries
      mma_abt<HD>(dl, va, dubt + rows);  // dP^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t * TQ + h * NJ * 8 + j * 8 + 2 * (lane & 3);
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
      for (int kc = 0; kc < NJ / 2; ++kc) {
        uint32_t a[1][4];
        a_operand(p, kc, 1.0f, 1.0f, a[0]);
        mma_ab<HD, 1>(dv, a, dub + stage, h * NJ / 2 + kc);  // dV += bf16(P)^T dU
        a_operand(dl, kc, 1.0f, 1.0f, a[0]);
        mma_ab<HD, 1>(dk, a, qb + stage, h * NJ / 2 + kc);   // dK += dL^T Q
      }
    }
    __syncthreads();
  }
  store_rows<HD>(dk, scale, Kw, dqkv + H, vqkv, bi, hi, k0 + warp * 16, S, lane);
  store_rows<HD>(dv, 1.0f, Vw, dqkv + 2 * H, vqkv, bi, hi, k0 + warp * 16, S, lane);
}

template <int HD>
cudaError_t launch_attention_bwd_hd(const bf16* qkv, const float* key_bias, const bf16* attn,
                                    bf16* dattn, bf16* dqkv, float* stats, int batch, int seq,
                                    int H, int heads, float scale, cudaStream_t stream) {
  if (seq < 1 || seq > fl::MAX_SEQ) return cudaErrorInvalidValue;
  constexpr int ATILE = tile_elems<HD>();
  constexpr int MAX_TILES = fl::MAX_SEQ / TK;
  // Fixed sizes (the longest S), so that one allowance per device serves
  // every S.
  const size_t dq_smem = (size_t)7 * ATILE * 2 + (size_t)MAX_TILES * TK * 4;
  const size_t dkdv_smem = (size_t)6 * ATILE * 2 + (size_t)2 * MAX_TILES * TQ * 4;
  static std::atomic<unsigned long long> dq_done{0}, dkdv_done{0};
  cudaError_t e = allow_smem_once(attn_bwd_dq_kernel<HD>, dq_smem, dq_done);
  if (e != cudaSuccess) return e;
  e = allow_smem_once(attn_bwd_dkdv_kernel<HD>, dkdv_smem, dkdv_done);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + TK - 1) / TK, heads, batch);
  attn_bwd_dq_kernel<HD><<<grid, THREADS, dq_smem, stream>>>(qkv, key_bias, attn, dattn, dqkv,
                                                              stats, seq, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<HD><<<grid, THREADS, dkdv_smem, stream>>>(qkv, key_bias, dattn, stats,
                                                                  dqkv, seq, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_attention_bwd(const bf16* qkv, const float* key_bias, const bf16* attn,
                                 bf16* dattn, bf16* dqkv, float* stats, int batch, int seq, int H,
                                 int heads, float scale, cudaStream_t stream) {
  if (heads <= 0 || H % heads) return cudaErrorInvalidValue;
  switch (H / heads) {
    case 16: return launch_attention_bwd_hd<16>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 32: return launch_attention_bwd_hd<32>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 64: return launch_attention_bwd_hd<64>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    case 128: return launch_attention_bwd_hd<128>(qkv, key_bias, attn, dattn, dqkv, stats, batch, seq, H, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------- workspace
// The recompute form's attn, ao, x1 and f take no space in the resid form,
// which reads the forward's.
struct Layout {
  size_t qkv, attn, ao, x1, hg, f, dfc, dhpre, daoc, dattn, dqkv;      // bf16
  size_t gp, dres, dx1, part_ln, part_b1, red_tmp, wpart, out3, stats;  // f32
  size_t total;
};

Layout make_layout(int batch, int seq, int H, int heads, int I, int sms, bool resid) {
  const size_t M = (size_t)batch * seq;
  size_t n = 0;
  auto take = [&n](size_t bytes) {
    const size_t o = n;
    n += (bytes + 255) / 256 * 256;
    return o;
  };
  const size_t recomputed = resid ? 0 : M * H * 2;
  Layout L;
  L.qkv = take(M * 3 * H * 2);
  L.attn = take(recomputed);
  L.ao = take(recomputed);
  L.x1 = take(recomputed);
  L.hg = take(M * I * 2);
  L.f = take(recomputed);
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

// The GEMM core alone, for tests and timings (not on the layer's path):
// one launch of a (form, epilogue) pair the layer runs, the arguments as
// launch_gemm takes them: (FORM_XW, EPI_BIAS / EPI_BIAS_GELU /
// EPI_BIAS_GELU_GRAD), (FORM_XWT, EPI_MUL_AUX / EPI_ADD_AUX_F32 / EPI_BIAS /
// EPI_ADD_AUX_BF16), (FORM_ATB, EPI_PARTIAL). Shapes as the layer's: N % 8
// == 0, K % 8 == 0 (the row count of FORM_ATB anything), pointers 16-byte
// aligned.
int fused_gemm(int form, int epi, const void* a, const void* w, const void* bias, void* c,
               const void* aux, void* aux_out, int M, int N, int K, int splits,
               int rows_per_split, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bf16* A = (const bf16*)a;
  const bf16* W = (const bf16*)w;
  const bf16* b = (const bf16*)bias;
  const float* x = (const float*)aux;
  float* xo = (float*)aux_out;
  if (form == FORM_XW && epi == EPI_BIAS)
    return launch_gemm<FORM_XW, EPI_BIAS>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XW && epi == EPI_BIAS_GELU)
    return launch_gemm<FORM_XW, EPI_BIAS_GELU>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XW && epi == EPI_BIAS_GELU_GRAD)
    return launch_gemm<FORM_XW, EPI_BIAS_GELU_GRAD>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XWT && epi == EPI_MUL_AUX)
    return launch_gemm<FORM_XWT, EPI_MUL_AUX>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XWT && epi == EPI_ADD_AUX_F32)
    return launch_gemm<FORM_XWT, EPI_ADD_AUX_F32>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XWT && epi == EPI_BIAS)
    return launch_gemm<FORM_XWT, EPI_BIAS>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_XWT && epi == EPI_ADD_AUX_BF16)
    return launch_gemm<FORM_XWT, EPI_ADD_AUX_BF16>(A, W, b, c, x, xo, M, N, K, stream);
  if (form == FORM_ATB && epi == EPI_PARTIAL)
    return launch_gemm<FORM_ATB, EPI_PARTIAL>(A, W, b, c, x, xo, M, N, K, stream, splits,
                                              rows_per_split);
  return (int)cudaErrorInvalidValue;
}

// The split count and rows a split that K5 gives the weight gradient
// out[k1, n] = A[rows, k1]^T B[rows, n] on the current device.
int fused_gemm_wgrad_splits(int rows, int k1, int n, int* splits, int* rows_per_split) {
  int sms = 0;
  const cudaError_t e = device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  *splits = wgrad_splits(rows, k1, n, sms);
  *rows_per_split = wgrad_rows_per_split(rows, *splits);
  return 0;
}

// Bytes of device scratch fused_layer_backward needs at these shapes on the
// current device, in the recompute form (resid 0) or the resid form.
int fused_layer_backward_workspace(int batch, int seq, int hidden, int num_heads, int inter,
                                   int resid, unsigned long long* bytes) {
  int sms = 0;
  const cudaError_t e = device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  *bytes = (unsigned long long)make_layout(batch, seq, hidden, num_heads, inter, sms, resid != 0)
               .total;
  return 0;
}

// Shapes the wrapper has checked: H == num_heads * head_dim with head_dim
// 16, 32, 64 or 128, H % 64 == 0, H <= 1024, I % 64 == 0, S % 16 == 0,
// 16 <= S <= 512, every pointer 16-byte aligned and contiguous. g, dx: [B,
// S, H] bf16; m1, m2: [B, S, H] bf16 or both null; the twelve grads are f32
// in the weights' shapes (Wqkv [H, 3H], bqkv [3H], Wo [H, H], bo, ln1
// scale/shift [H], W1 [H, I], b1 [I], W2 [I, H], b2, ln2 scale/shift [H]);
// workspace holds fused_layer_backward_workspace(...) bytes.
// r_attn, r_ao, r_x1, r_f: all null (the recompute form), or the four
// residuals the forward saved with save_resid (the JAX _bwd_kernel's resid
// form: attn, the post-dropout ao, x1, the post-dropout f, [B, S, H] bf16),
// which replace the attention forward, the o-projection, LN1 and the W2
// GEMM of the recompute; the qkv and W1 GEMMs run as in the recompute form.
// The two forms read the same bf16 values and give the same bits.
int fused_layer_backward(const void* x, const void* key_bias, const void* g, const void* m1,
                         const void* m2, const void* qkv_w, const void* qkv_b, const void* o_w,
                         const void* o_b, const void* ln1_s, const void* ln1_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, const void* ln2_s,
                         const void* ln2_b, const void* r_attn, const void* r_ao,
                         const void* r_x1, const void* r_f, void* dx, void* d_qkv_w,
                         void* d_qkv_b, void* d_o_w, void* d_o_b, void* d_ln1_s, void* d_ln1_b,
                         void* d_w1, void* d_b1, void* d_w2, void* d_b2, void* d_ln2_s,
                         void* d_ln2_b, void* workspace, int batch, int seq, int hidden,
                         int num_heads, int inter, float scale, float eps, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  const int I = inter;
  const bool resid = r_attn != nullptr;
  if (resid != (r_ao != nullptr) || resid != (r_x1 != nullptr) || resid != (r_f != nullptr))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const Layout L = make_layout(batch, seq, H, num_heads, I, sms, resid);
  unsigned char* ws = reinterpret_cast<unsigned char*>(workspace);
  bf16* qkv = reinterpret_cast<bf16*>(ws + L.qkv);
  bf16* attn = resid ? (bf16*)r_attn : reinterpret_cast<bf16*>(ws + L.attn);
  bf16* ao = resid ? (bf16*)r_ao : reinterpret_cast<bf16*>(ws + L.ao);
  bf16* x1 = resid ? (bf16*)r_x1 : reinterpret_cast<bf16*>(ws + L.x1);
  bf16* hg = reinterpret_cast<bf16*>(ws + L.hg);
  bf16* f = resid ? (bf16*)r_f : reinterpret_cast<bf16*>(ws + L.f);
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
  // The saved ao and f are post-dropout: their LayerNorm residuals take no
  // mask (the gradients still do).
  const bf16* rmask1 = resid ? nullptr : mask1;
  const bf16* rmask2 = resid ? nullptr : mask2;
  const int ln_blocks = (M + LNB_ROWS - 1) / LNB_ROWS;
#define FLB_CHECK(call)            \
  do {                             \
    e = (call);                    \
    if (e != cudaSuccess) return e; \
  } while (0)

  // ---- forward recompute (K1's kernels); the resid form keeps the qkv and
  // W1 GEMMs only
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(xb, (const bf16*)qkv_w, (const bf16*)qkv_b, qkv,
                                          nullptr, nullptr, M, 3 * H, H, stream)));
  if (!resid) {
    FLB_CHECK(launch_attention(qkv, (const float*)key_bias, attn, batch, seq, H, num_heads,
                               scale, stream));
    FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(attn, (const bf16*)o_w, (const bf16*)o_b, ao,
                                            nullptr, nullptr, M, H, H, stream)));
    FLB_CHECK(launch_ln(xb, ao, mask1, (const float*)ln1_s, (const float*)ln1_b, x1, M, H, eps,
                        stream));
  }
  FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS_GELU_GRAD>(x1, (const bf16*)w1, (const bf16*)b1, hg,
                                                    nullptr, gp, M, I, H, stream)));
  if (!resid) {
    FLB_CHECK((launch_gemm<FORM_XW, EPI_BIAS>(hg, (const bf16*)w2, (const bf16*)b2, f, nullptr,
                                            nullptr, M, H, I, stream)));
  }

  // ---- second LayerNorm, FFN
  FLB_CHECK(launch_ln_bwd<bf16>(x1, f, rmask2, mask2, (const bf16*)g, (const float*)ln2_s, dres,
                                dfc, part_ln, M, H, eps, stream));
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
  FLB_CHECK(launch_ln_bwd<float>(xb, ao, rmask1, mask1, dx1, (const float*)ln1_s, dres, daoc,
                                 part_ln, M, H, eps, stream));
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
