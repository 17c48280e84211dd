// Multi-head attention over [B, heads, S, D] bf16, forward and backward, for
// Hopper.
//
// Replaces: the JAX package's ops/attention.py::_attn_kernel (forward, the
// Pallas TPU kernel behind _attention_pallas) and ::_attn_bwd_kernel (its
// recompute backward). Same functions:
//   forward   P = softmax(scale * Q K^T + key_bias), normalised in f32, then
//             O = bf16(P) V with f32 accumulation, stored in bf16;
//   backward  P recomputed as above in f32; dV = P^T dO; dP = dO V^T;
//             Dr = rowsum(P * dP); dS = P * (dP - Dr); dQ = scale dS K;
//             dK = scale dS^T Q; f32 math throughout, bf16 outputs.
// key_bias is (1 - mask) * -1e9 per key; an all-pad row therefore attends
// uniformly over its S keys, as in the JAX package.
//
// What bounds it on the H100: the forward moves 4*B*h*S*D*2 bytes (3.35
// TB/s) for 4*B*h*S^2*D operations on bf16 operands (989 TFLOP/s on the
// tensor cores), so below S of about 590 the bytes bound it; the backward
// does 10*B*h*S^2*D in f32 (67 TFLOP/s of FMA, no TF32) against
// 8*B*h*S*D*2 bytes, so above S = 32 the operations bound it.
//
// What the design does about it:
// - Forward: one block per (64-query tile, head, batch row), 4 warps of 16
//   query rows, WMMA bf16 products with f32 accumulation. K and V stream
//   through shared memory in 64-key tiles, so any S fits (S <= 512 is what
//   the port sends; 49 KB of shared memory at D = 64). Two passes over the
//   key tiles: the first finds each row's max and sum, the second writes P
//   normalised in f32, rounds it to bf16 and accumulates P V in registers.
//   That keeps the JAX cast points exactly (the flash-style division after
//   P V would round differently) at the price of computing Q K^T twice.
// - Backward: f32 on the CUDA cores, register tiles of 4 x 4 per thread, no
//   atomics. One block per (query tile, head, row) computes the row max and
//   sum, then Dr, then dQ, each a pass over the key tiles, and leaves max,
//   sum and Dr in a small f32 workspace; one block per (key tile, head, row)
//   then loops over the query tiles for dK and dV. Every sum runs in a fixed
//   order, so a run gives the same gradients every time.
// - Strides: q, k, v, the output and the gradients are strided views (the
//   head dimension contiguous), so the layer's [B, S, 3, heads, D] QKV
//   projection and the [B, S, heads, D] output need no copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TQ = 64;              // query rows per block
constexpr int TK = 64;              // keys per tile
constexpr int FWD_THREADS = 128;    // 4 warps x 16 query rows
constexpr int BWD_THREADS = 256;    // 16 x 16 threads, 4 x 4 elements each
constexpr float INIT_MAX = -3.0e38f;
constexpr float PAD_BIAS = -3.0e38f;  // keys past S: below every real key (>= -1e9)
constexpr unsigned FULL = 0xffffffffu;

struct View {  // element strides of a [B, heads, S, D] view; D is contiguous
  long long b, h, s;
  __device__ __forceinline__ long long at(int bi, int hi, int si) const {
    return bi * b + hi * h + si * s;
  }
};

// Rows [r0, r0 + 64) of one (batch row, head) of a bf16 view into shared
// memory as bf16 [64][D]; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, View v, int bi,
                                               int hi, int r0, int S, int tid, int nthreads) {
  for (int i = tid; i < 64 * (D / 8); i += nthreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + v.at(bi, hi, r0 + r) + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// The same tile widened to f32 [64][D + 1] (the padding keeps column reads
// of neighbouring rows in different banks).
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const bf16* src, View v, int bi,
                                              int hi, int r0, int S, int tid) {
  for (int i = tid; i < 64 * (D / 8); i += BWD_THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + v.at(bi, hi, r0 + r) + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * (D + 1) + c + j] = __bfloat162float(e[j]);
  }
}

__device__ __forceinline__ void load_bias(float* dst, const float* key_bias, int bi, int k0,
                                          int S, int tid, int nthreads) {
  for (int j = tid; j < TK; j += nthreads)
    dst[j] = k0 + j < S ? key_bias[(size_t)bi * S + k0 + j] : PAD_BIAS;
}

// ------------------------------------------------------------------ forward

template <int D>
__host__ __device__ constexpr int fwd_scratch_width() {
  return D > TK ? D : TK;
}

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  return (size_t)(TQ + 2 * TK) * D * 2                  // Q, K, V tiles (bf16)
         + (size_t)4 * 16 * fwd_scratch_width<D>() * 4  // per-warp f32 scores / output
         + (size_t)4 * 16 * TK * 2                      // per-warp bf16 P
         + (size_t)TK * 4;                              // key bias tile
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ key_bias,
                bf16* __restrict__ o, View vq, View vk, View vv, View vo, int S, float scale) {
  constexpr int SW = fwd_scratch_width<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TQ * D;
  bf16* Vs = Ks + TK * D;
  float* Sc = reinterpret_cast<float*>(Vs + TK * D);
  bf16* Ps = reinterpret_cast<bf16*>(Sc + 4 * 16 * SW);
  float* Kb = reinterpret_cast<float*>(Ps + 4 * 16 * TK);

  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* sc = Sc + warp * 16 * SW;
  bf16* p = Ps + warp * 16 * TK;
  // Each lane pair owns one of the warp's 16 rows, a lane 32 of its columns.
  const int row = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int n_tiles = (S + TK - 1) / TK;

  load_tile_bf16<D>(Qs, q, vq, bi, hi, q0, S, tid, FWD_THREADS);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], Qs + warp * 16 * D + kk * 16, D);

  // Scores of this warp's 16 rows against the staged key tile, into sc.
  auto scores = [&]() {
#pragma unroll
    for (int n0 = 0; n0 < TK; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        // K stored [TK][D] row-major is K^T in column-major order.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + n0 * D + kk * 16, D);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(sc + n0, acc, SW, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // Pass 1: each row's max m and sum l of exp(logit - m), online over tiles.
  float m = INIT_MAX, l = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile_bf16<D>(Ks, k, vk, bi, hi, t * TK, S, tid, FWD_THREADS);
    load_bias(Kb, key_bias, bi, t * TK, S, tid, FWD_THREADS);
    __syncthreads();
    scores();
    float tmax = INIT_MAX;
    for (int jj = 0; jj < 32; ++jj) {
      const int c = c0 + ((jj + lane) & 31);  // rotated: no bank conflicts
      const float x = __fadd_rn(__fmul_rn(sc[row * SW + c], scale), Kb[c]);
      sc[row * SW + c] = x;
      tmax = fmaxf(tmax, x);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
    const float mn = fmaxf(m, tmax);
    float ts = 0.0f;
    for (int jj = 0; jj < 32; ++jj) ts += expf(sc[row * SW + c0 + ((jj + lane) & 31)] - mn);
    ts += __shfl_xor_sync(FULL, ts, 1);
    l = l * expf(m - mn) + ts;
    m = mn;
    __syncwarp();
  }

  // Pass 2: P = exp(logit - m) / l in f32, rounded to bf16, then P V.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
#pragma unroll
  for (int d = 0; d < D / 16; ++d) wmma::fill_fragment(oacc[d], 0.0f);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile_bf16<D>(Ks, k, vk, bi, hi, t * TK, S, tid, FWD_THREADS);
    load_tile_bf16<D>(Vs, v, vv, bi, hi, t * TK, S, tid, FWD_THREADS);
    load_bias(Kb, key_bias, bi, t * TK, S, tid, FWD_THREADS);
    __syncthreads();
    scores();
    for (int jj = 0; jj < 32; ++jj) {
      const int c = c0 + ((jj + lane) & 31);
      const float x = __fadd_rn(__fmul_rn(sc[row * SW + c], scale), Kb[c]);
      p[row * TK + c] = __float2bfloat16(expf(x - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, p + kk * 16, TK);
#pragma unroll
      for (int d = 0; d < D / 16; ++d) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * D + d * 16, D);
        wmma::mma_sync(oacc[d], pa, vb, oacc[d]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int d = 0; d < D / 16; ++d)
    wmma::store_matrix_sync(sc + d * 16, oacc[d], SW, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi >= S) continue;
    __align__(16) bf16 packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) packed[j] = __float2bfloat16(sc[r * SW + c + j]);
    *reinterpret_cast<uint4*>(o + vo.at(bi, hi, qi) + c) = *reinterpret_cast<uint4*>(packed);
  }
}

// ----------------------------------------------------------------- backward
// Thread (tx, ty) of 16 x 16 owns rows ty + 16 i and columns tx + 16 j of a
// 64 x 64 tile (i, j < 4); the 16 threads of one row are a half-warp.

template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int tx, int ty,
                                         float out[4][4]) {
  // out[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], both [64][D + 1].
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a[i], b[j], out[i][j]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int D>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * 64 * (D + 1) * 4  // four f32 [64][D + 1] tiles
         + (size_t)2 * 64 * 65 * 4     // two f32 [64][64 + 1] tiles
         + (size_t)4 * 64 * 4;         // key bias and per-row max, sum, Dr
}

// dQ, and each row's max, sum and Dr into stats ([3][B][heads][S] f32).
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ key_bias,
                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                   float* __restrict__ stats, View vq, View vk, View vv, View vdo, View vdq,
                   int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DP = D + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + 64 * DP;
  float* Ks = dOs + 64 * DP;
  float* Vs = Ks + 64 * DP;
  float* dSs = Vs + 64 * DP;      // [64][65]
  float* Kb = dSs + 2 * 64 * 65;  // one [64][65] tile is unused here
  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_tiles = (S + TK - 1) / TK;

  load_tile_f32<D>(Qs, q, vq, bi, hi, q0, S, tid);
  load_tile_f32<D>(dOs, dout, vdo, bi, hi, q0, S, tid);

  float m[4], l[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = INIT_MAX;
    l[i] = 0.0f;
    dr[i] = 0.0f;
  }
  float s[4][4], dp[4][4];

  // Pass A: row max and sum, online over the key tiles.
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile_f32<D>(Ks, k, vk, bi, hi, t * TK, S, tid);
    load_bias(Kb, key_bias, bi, t * TK, S, tid, BWD_THREADS);
    __syncthreads();
    tile_dot<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = INIT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = __fadd_rn(__fmul_rn(s[i][j], scale), Kb[tx + 16 * j]);
        tmax = fmaxf(tmax, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(tmax));
      float ts = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) ts += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + half_warp_sum(ts);
      m[i] = mn;
    }
  }

  // Pass B: Dr = rowsum(P * dP).
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile_f32<D>(Ks, k, vk, bi, hi, t * TK, S, tid);
    load_tile_f32<D>(Vs, v, vv, bi, hi, t * TK, S, tid);
    load_bias(Kb, key_bias, bi, t * TK, S, tid, BWD_THREADS);
    __syncthreads();
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = __fadd_rn(__fmul_rn(s[i][j], scale), Kb[tx + 16 * j]);
        dr[i] = fmaf(expf(x - m[i]) / l[i], dp[i][j], dr[i]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) dr[i] = half_warp_sum(dr[i]);

  // Pass C: dS = P * (dP - Dr) through shared memory, dQ += dS K.
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile_f32<D>(Ks, k, vk, bi, hi, t * TK, S, tid);
    load_tile_f32<D>(Vs, v, vv, bi, hi, t * TK, S, tid);
    load_bias(Kb, key_bias, bi, t * TK, S, tid, BWD_THREADS);
    __syncthreads();
    tile_dot<D>(Qs, Ks, tx, ty, s);
    tile_dot<D>(dOs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = __fadd_rn(__fmul_rn(s[i][j], scale), Kb[tx + 16 * j]);
        const float pij = expf(x - m[i]) / l[i];
        dSs[(ty + 16 * i) * 65 + tx + 16 * j] = pij * (dp[i][j] - dr[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * 65 + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float kv = Ks[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[vdq.at(bi, hi, qi) + tx + 16 * j] = __float2bfloat16(acc[i][j] * scale);
    if (tx == 0) {
      const size_t plane = (size_t)gridDim.z * gridDim.y * S;
      const size_t at = ((size_t)bi * gridDim.y + hi) * S + qi;
      stats[at] = m[i];
      stats[plane + at] = l[i];
      stats[2 * plane + at] = dr[i];
    }
  }
}

// dK and dV of one key tile, looping over the query tiles.
template <int D>
__global__ void __launch_bounds__(BWD_THREADS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ key_bias,
                     const bf16* __restrict__ dout, const float* __restrict__ stats,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, View vq, View vk, View vv,
                     View vdo, View vdk, View vdv, int S, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DP = D + 1;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 64 * DP;
  float* Qs = Vs + 64 * DP;
  float* dOs = Qs + 64 * DP;
  float* Ps = dOs + 64 * DP;  // [64 queries][65]
  float* dSs = Ps + 64 * 65;  // [64 queries][65]
  float* Kb = dSs + 64 * 65;
  float* Ms = Kb + 64;
  float* Ls = Ms + 64;
  float* Drs = Ls + 64;
  const int k0 = blockIdx.x * TK;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const size_t plane = (size_t)gridDim.z * gridDim.y * S;
  const size_t row0 = ((size_t)bi * gridDim.y + hi) * S;

  load_tile_f32<D>(Ks, k, vk, bi, hi, k0, S, tid);
  load_tile_f32<D>(Vs, v, vv, bi, hi, k0, S, tid);
  load_bias(Kb, key_bias, bi, k0, S, tid, BWD_THREADS);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk_acc[i][j] = 0.0f;
      dv_acc[i][j] = 0.0f;
    }
  float s[4][4], dp[4][4];

  for (int q0 = 0; q0 < S; q0 += TQ) {
    __syncthreads();
    load_tile_f32<D>(Qs, q, vq, bi, hi, q0, S, tid);
    load_tile_f32<D>(dOs, dout, vdo, bi, hi, q0, S, tid);
    for (int r = tid; r < TQ; r += BWD_THREADS) {
      const bool ok = q0 + r < S;  // rows past S: P = exp(-inf) = 0
      Ms[r] = ok ? stats[row0 + q0 + r] : -PAD_BIAS;
      Ls[r] = ok ? stats[plane + row0 + q0 + r] : 1.0f;
      Drs[r] = ok ? stats[2 * plane + row0 + q0 + r] : 0.0f;
    }
    __syncthreads();
    tile_dot<D>(Qs, Ks, tx, ty, s);    // [query][key]
    tile_dot<D>(dOs, Vs, tx, ty, dp);  // [query][key]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = __fadd_rn(__fmul_rn(s[i][j], scale), Kb[c]);
        const float pij = expf(x - Ms[r]) / Ls[r];
        Ps[r * 65 + c] = pij;
        dSs[r * 65 + c] = pij * (dp[i][j] - Drs[r]);
      }
    }
    __syncthreads();
    // Thread rows are now keys ty + 16 i, columns d = tx + 16 j.
#pragma unroll 4
    for (int r = 0; r < TQ; ++r) {
      float pr[4], dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = Ps[r * 65 + ty + 16 * i];
        dsr[i] = dSs[r * 65 + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float dov = dOs[r * DP + tx + 16 * j];
        const float qv = Qs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pr[i], dov, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dsr[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[vdk.at(bi, hi, ki) + tx + 16 * j] = __float2bfloat16(dk_acc[i][j] * scale);
      dv[vdv.at(bi, hi, ki) + tx + 16 * j] = __float2bfloat16(dv_acc[i][j]);
    }
  }
}

View view_of(const long long* st) { return View{st[0], st[1], st[2]}; }

template <int D>
cudaError_t launch_forward(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* o,
                           const long long* st, int B, int heads, int S, float scale,
                           cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TQ - 1) / TQ, heads, B);
  attn_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(
      q, k, v, bias, o, view_of(st), view_of(st + 3), view_of(st + 6), view_of(st + 9), S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                            const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* stats,
                            const long long* st, int B, int heads, int S, float scale,
                            cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const View vq = view_of(st), vk = view_of(st + 3), vv = view_of(st + 6),
             vdo = view_of(st + 9), vdq = view_of(st + 12), vdk = view_of(st + 15),
             vdv = view_of(st + 18);
  dim3 grid((S + 63) / 64, heads, B);
  attn_bwd_dq_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(q, k, v, bias, dout, dq, stats, vq,
                                                             vk, vv, vdo, vdq, S, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<D><<<grid, BWD_THREADS, smem, stream>>>(
      q, k, v, bias, dout, stats, dk, dv, vq, vk, vv, vdo, vdk, vdv, S, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// q, k, v, out: bf16 [B, heads, S, D] views with element strides (batch,
// head, seq) in strides[0:12] (q, k, v, out), D contiguous, every row
// 16-byte aligned; key_bias [B, S] f32. D in {16, 32, 64, 128}.
int attention_forward(const void* q, const void* k, const void* v, const void* key_bias,
                      void* out, const long long* strides, int batch, int heads, int seq,
                      int head_dim, float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bf16 *Q = (const bf16*)q, *K = (const bf16*)k, *V = (const bf16*)v;
  const float* bias = (const float*)key_bias;
  bf16* O = (bf16*)out;
  switch (head_dim) {
    case 16: return launch_forward<16>(Q, K, V, bias, O, strides, batch, heads, seq, scale, stream);
    case 32: return launch_forward<32>(Q, K, V, bias, O, strides, batch, heads, seq, scale, stream);
    case 64: return launch_forward<64>(Q, K, V, bias, O, strides, batch, heads, seq, scale, stream);
    case 128: return launch_forward<128>(Q, K, V, bias, O, strides, batch, heads, seq, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// As attention_forward, with dout and the gradients dq, dk, dv: strides[0:21]
// for q, k, v, dout, dq, dk, dv; stats is an f32 workspace of 3 * B * heads * S.
int attention_backward(const void* q, const void* k, const void* v, const void* key_bias,
                       const void* dout, void* dq, void* dk, void* dv, void* stats,
                       const long long* strides, int batch, int heads, int seq, int head_dim,
                       float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bf16 *Q = (const bf16*)q, *K = (const bf16*)k, *V = (const bf16*)v;
  const bf16* dO = (const bf16*)dout;
  bf16 *dQ = (bf16*)dq, *dK = (bf16*)dk, *dV = (bf16*)dv;
  const float* bias = (const float*)key_bias;
  float* st = (float*)stats;
  switch (head_dim) {
    case 16: return launch_backward<16>(Q, K, V, bias, dO, dQ, dK, dV, st, strides, batch, heads, seq, scale, stream);
    case 32: return launch_backward<32>(Q, K, V, bias, dO, dQ, dK, dV, st, strides, batch, heads, seq, scale, stream);
    case 64: return launch_backward<64>(Q, K, V, bias, dO, dQ, dK, dV, st, strides, batch, heads, seq, scale, stream);
    case 128: return launch_backward<128>(Q, K, V, bias, dO, dQ, dK, dV, st, strides, batch, heads, seq, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
