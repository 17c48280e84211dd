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
//             dK = scale dS^T Q; f32 operands, bf16 outputs.
// Each logit is fadd(fmul(score, scale), key_bias) in f32, key_bias being
// (1 - mask) * -1e9 per key; keys past S take PAD_BIAS, below every real key,
// so an all-pad row attends uniformly over its S keys, as in the JAX package.
// Rows past S are not written. P takes 1 / l once per row: e * (1 / l) is
// within one f32 ulp of e / l.
//
// What bounds it on the H100: the forward moves 4*B*h*S*D*2 bytes (3.35
// TB/s) for 4*B*h*S^2*D operations on bf16 operands (989 TFLOP/s), the
// backward 7*B*h*S*D*2 bytes (q, k, v, dO in; dq, dk, dv out) for
// 10*B*h*S^2*D; at the port's S <= 512 both
// are bound by bytes, and in practice by latency: how well tile copies
// overlap the products, and how few trips the scores make through shared
// memory.
//
// What the design does about it:
// - Tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulation),
//   operands fed by ldmatrix from shared tiles whose rows are padded by 16
//   bytes, so every ldmatrix phase hits 32 distinct banks. The accumulator
//   layout of one product is the A-operand layout of the next, so a score
//   tile becomes P (or dS) in registers with no trip through shared memory.
//   Not wgmma: at these shapes the math is not the limit (the forward's
//   operations bound is a third of its bytes bound); wgmma with TMA is for
//   a later change, if the measured times show the math as the limit.
// - Tiles of 64 rows arrive by cp.async.cg 16-byte copies (zero-filled past
//   S) into a ring of two stages: tile t + 1 is in flight while tile t is
//   multiplied. The copies take the strided views as they are (every row is
//   16-byte aligned, which the wrapper checks).
// - Blocks of 4 warps; a warp owns 16 rows of its block's 64 (queries, or
//   keys in the dK/dV kernel).
// - Forward: one block per (64-query tile, head, batch row). Where the score
//   row fits in registers (rule below) it is computed once: every key tile's
//   scores stay in the accumulators, the exact row max and sum follow, then
//   P = exp(x - m) / l in f32 is rounded to bf16 in registers and multiplied
//   by V tile by tile: K and V are each read once per block and Q K^T is
//   computed once. That keeps JAX's cast point (P normalised before the bf16
//   cast; the flash-style division after P V would round differently).
//   Rule: one pass holds 32 f32 per thread for each 64-key tile; it runs for
//   S <= 256 (four tiles) at D <= 64. Above that (S > 256, or D = 128 with
//   its 64 output registers) ptxas would spill, and the two-pass form runs:
//   pass one keeps each row's max and sum online, pass two recomputes the
//   scores and accumulates P V, as the one-pass form does.
// - Backward, two kernels, no atomics, every sum in a fixed order (the same
//   gradients from every run). The dQ kernel, per 64-query tile, passes over
//   the key tiles twice: first the online max m, sum l and u = sum exp(x - m)
//   dP under the same rescaling, so Dr = u / l; then dS and dQ += dS K. It
//   leaves m, l and Dr in the [3, B, heads, S] f32 workspace. The dK/dV
//   kernel, per 64-key tile, loops over the query tiles and computes the
//   transposed scores K Q^T and V dO^T directly, so P^T and dS^T are
//   accumulators in registers too; Q and dO feed dK += dS^T Q and
//   dV += P^T dO through ldmatrix.trans. That is 12 products of B*h*S^2*D
//   on the tensor cores, counting the split ones twice.
// - Split operands: Q K^T and dO V^T multiply bf16 values, the plain
//   version's operands, so the products are exact. P and dS are f32; each
//   enters its product as hi = bf16(x) and lo = bf16(x - hi), two mma into
//   one f32 accumulator, which keeps about 2^-17 of its relative precision.
//   Their partners (dO, K, Q) are bf16 values already.
//
// The PTX wrappers, tile helpers and both forward kernels live in
// mma_common.cuh, which the fused encoder layer (K1, K5) shares.

#include "mma_common.cuh"

namespace {

using namespace mmac;

// ----------------------------------------------------------------- backward

// Blocks per SM asked of ptxas for the two backward kernels, 0 leaving it
// its own choice. At head_dim 32 that choice trims the dK/dV kernel to 128
// registers (a fourth block per SM) and spills; asking for three lets it
// keep 164 with no spill. A floor of two blocks on both kernels made K7 16%
// slower on an H100 (more registers, fewer blocks). Other choices build by
// -D: scripts/torch_attention_bounds_ab.py compares them.
#ifndef ATTN_BWD_MIN_BLOCKS
#define ATTN_BWD_MIN_BLOCKS 0
#endif
#ifndef ATTN_DKDV_MIN_BLOCKS_D32
#define ATTN_DKDV_MIN_BLOCKS_D32 3
#endif

// dQ of one 64-query tile, and each row's m, l and Dr into stats
// ([3][B][heads][S] f32).
template <int D>
__global__ void __launch_bounds__(THREADS, ATTN_BWD_MIN_BLOCKS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ key_bias,
                   const bf16* __restrict__ dout, bf16* __restrict__ dq,
                   float* __restrict__ stats, View vq, View vk, View vv, View vdo, View vdq,
                   int S, float scale) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE;
  bf16* ring = dOs + TILE;                                // two stages of (K, V)
  float* Kb = reinterpret_cast<float*>(ring + 4 * TILE);  // n_tiles * 64 key biases
  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (S + TK - 1) / TK;
  bf16* Qw = Qs + warp * 16 * LD;
  const uint32_t qa = smem_addr(Qw) + lane_a<D>(lane);
  const uint32_t doa = smem_addr(dOs + warp * 16 * LD) + lane_a<D>(lane);
  const uint32_t kbt = smem_addr(ring) + lane_bt<D>(lane);  // K as B^T
  const uint32_t vbt = smem_addr(ring + TILE) + lane_bt<D>(lane);
  const uint32_t kb = smem_addr(ring) + lane_a<D>(lane);    // K as B

  // Steps 0 .. 2 n - 1 bring K and V tile `step % n`: pass A, then pass B.
  auto issue = [&](int step) {
    if (step < 2 * n_tiles) {
      bf16* dst = ring + (step & 1) * 2 * TILE;
      load_tile<D>(dst, k, vk, bi, hi, (step % n_tiles) * TK, S, tid);
      load_tile<D>(dst + TILE, v, vv, bi, hi, (step % n_tiles) * TK, S, tid);
    }
    cp_commit();
  };
  load_tile<D>(Qs, q, vq, bi, hi, q0, S, tid);
  load_tile<D>(dOs, dout, vdo, bi, hi, q0, S, tid);
  issue(0);
  load_bias(Kb, key_bias, bi, n_tiles, S, tid);

  float s[8][4], dp[8][4];
  // Pass A: m, l and u = sum exp(x - m) dP, online over the key tiles.
  float m0 = INIT_MAX, m1 = INIT_MAX, l0 = 0.0f, l1 = 0.0f, u0 = 0.0f, u1 = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = (t & 1) * 2 * TILE * 2;
    mma_abt<D>(s, qa, kbt + stage);
    mma_abt<D>(dp, doa, vbt + stage);
    logits(s, Kb + t * TK, scale, lane);
    float t0, t1;
    tile_max(s, t0, t1);
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    float e0 = 0.0f, e1 = 0.0f, w0 = 0.0f, w1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a = expf(s[j][0] - n0), b = expf(s[j][1] - n0);
      const float c = expf(s[j][2] - n1), d = expf(s[j][3] - n1);
      e0 += a + b;
      e1 += c + d;
      w0 = fmaf(a, dp[j][0], fmaf(b, dp[j][1], w0));
      w1 = fmaf(c, dp[j][2], fmaf(d, dp[j][3], w1));
    }
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);
    l0 = fmaf(l0, a0, quad_sum(e0));
    l1 = fmaf(l1, a1, quad_sum(e1));
    u0 = fmaf(u0, a0, quad_sum(w0));
    u1 = fmaf(u1, a1, quad_sum(w1));
    m0 = n0;
    m1 = n1;
    __syncthreads();
  }
  const float i0 = 1.0f / l0, i1 = 1.0f / l1;
  const float dr0 = u0 / l0, dr1 = u1 / l1;

  // Pass B: dS = P (dP - Dr), dQ += dS K with dS split.
  float acc[D / 8][4];
  zero<D>(acc);
  for (int t = 0; t < n_tiles; ++t) {
    issue(n_tiles + t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = ((n_tiles + t) & 1) * 2 * TILE * 2;
    mma_abt<D>(s, qa, kbt + stage);
    mma_abt<D>(dp, doa, vbt + stage);
    logits(s, Kb + t * TK, scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m0) * i0 * (dp[j][0] - dr0);
      s[j][1] = expf(s[j][1] - m0) * i0 * (dp[j][1] - dr0);
      s[j][2] = expf(s[j][2] - m1) * i1 * (dp[j][2] - dr1);
      s[j][3] = expf(s[j][3] - m1) * i1 * (dp[j][3] - dr1);
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[2][4];
      a_operand_split(s, kc, a);
      mma_ab<D, 2>(acc, a, kb + stage, kc);
    }
    __syncthreads();
  }
  store_rows<D>(acc, scale, Qw, dq, vdq, bi, hi, q0 + warp * 16, S, lane);
  if ((lane & 3) == 0) {
    const size_t plane = (size_t)gridDim.z * gridDim.y * S;
    const size_t row0 = ((size_t)bi * gridDim.y + hi) * S;
    const int r = q0 + warp * 16 + (lane >> 2);
    if (r < S) {
      stats[row0 + r] = m0;
      stats[plane + row0 + r] = l0;
      stats[2 * plane + row0 + r] = dr0;
    }
    if (r + 8 < S) {
      stats[row0 + r + 8] = m1;
      stats[plane + row0 + r + 8] = l1;
      stats[2 * plane + row0 + r + 8] = dr1;
    }
  }
}

// dK and dV of one 64-key tile, looping over the query tiles. A warp owns 16
// keys: its accumulator tiles are K Q^T and V dO^T (keys by queries).
template <int D>
__global__ void __launch_bounds__(THREADS,
                                  D == 32 ? ATTN_DKDV_MIN_BLOCKS_D32 : ATTN_BWD_MIN_BLOCKS)
attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ key_bias,
                     const bf16* __restrict__ dout, const float* __restrict__ stats,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, View vq, View vk, View vv,
                     View vdo, View vdk, View vdv, int S, float scale) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* ring = Vs + TILE;                                 // two stages of (Q, dO)
  float* Ms = reinterpret_cast<float*>(ring + 4 * TILE);  // per query: m, 1 / l, Dr
  const int k0 = blockIdx.x * TK;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (S + TQ - 1) / TQ;
  float* Is = Ms + n_tiles * TQ;
  float* Drs = Is + n_tiles * TQ;
  bf16* Kw = Ks + warp * 16 * LD;
  bf16* Vw = Vs + warp * 16 * LD;
  const uint32_t ka = smem_addr(Kw) + lane_a<D>(lane);
  const uint32_t va = smem_addr(Vw) + lane_a<D>(lane);
  const uint32_t qbt = smem_addr(ring) + lane_bt<D>(lane);  // Q, dO as B^T
  const uint32_t dobt = smem_addr(ring + TILE) + lane_bt<D>(lane);
  const uint32_t qb = smem_addr(ring) + lane_a<D>(lane);    // Q, dO as B
  const uint32_t dob = smem_addr(ring + TILE) + lane_a<D>(lane);

  auto issue = [&](int step) {  // Q and dO tile `step`
    if (step < n_tiles) {
      bf16* dst = ring + (step & 1) * 2 * TILE;
      load_tile<D>(dst, q, vq, bi, hi, step * TQ, S, tid);
      load_tile<D>(dst + TILE, dout, vdo, bi, hi, step * TQ, S, tid);
    }
    cp_commit();
  };
  load_tile<D>(Ks, k, vk, bi, hi, k0, S, tid);
  load_tile<D>(Vs, v, vv, bi, hi, k0, S, tid);
  issue(0);
  {
    const size_t plane = (size_t)gridDim.z * gridDim.y * S;
    const size_t row0 = ((size_t)bi * gridDim.y + hi) * S;
    for (int j = tid; j < n_tiles * TQ; j += THREADS) {
      const bool ok = j < S;  // rows past S: P = exp(x - 3e38) = 0
      Ms[j] = ok ? stats[row0 + j] : -PAD_BIAS;
      Is[j] = ok ? 1.0f / stats[plane + row0 + j] : 1.0f;
      Drs[j] = ok ? stats[2 * plane + row0 + j] : 0.0f;
    }
  }
  const int kr = k0 + warp * 16 + (lane >> 2);  // this lane's keys: kr, kr + 8
  const float b0 = kr < S ? key_bias[(size_t)bi * S + kr] : PAD_BIAS;
  const float b1 = kr + 8 < S ? key_bias[(size_t)bi * S + kr + 8] : PAD_BIAS;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  // A query tile goes in NJ 8-column groups at a time: the whole tile, or
  // at head_dim 128 (whose dK and dV accumulators hold 128 f32 a lane) its
  // quarters, one after the other, so that P^T and dS^T and their bf16
  // pairs fit beside them: ptxas then does not spill. Each score is the
  // same dot product either way, and the parts feed dK and dV in the same
  // order.
  constexpr int NJ = D <= 64 ? 8 : 2;
  constexpr int ROW = row_stride<D>() * 2;  // bytes
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = (t & 1) * 2 * TILE * 2;
#pragma unroll 1
    for (int h = 0; h < 8 / NJ; ++h) {
      const uint32_t rows = stage + h * NJ * 8 * ROW;  // the part's first query
      float p[NJ][4], ds[NJ][4];
      mma_abt<D>(p, ka, qbt + rows);    // scores, keys by queries
      mma_abt<D>(ds, va, dobt + rows);  // dP^T
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = t * TQ + h * NJ * 8 + j * 8 + 2 * (lane & 3);
        const float2 m = *reinterpret_cast<const float2*>(Ms + c);
        const float2 il = *reinterpret_cast<const float2*>(Is + c);
        const float2 dr = *reinterpret_cast<const float2*>(Drs + c);
        p[j][0] = expf(__fadd_rn(__fmul_rn(p[j][0], scale), b0) - m.x) * il.x;
        p[j][1] = expf(__fadd_rn(__fmul_rn(p[j][1], scale), b0) - m.y) * il.y;
        p[j][2] = expf(__fadd_rn(__fmul_rn(p[j][2], scale), b1) - m.x) * il.x;
        p[j][3] = expf(__fadd_rn(__fmul_rn(p[j][3], scale), b1) - m.y) * il.y;
        ds[j][0] = p[j][0] * (ds[j][0] - dr.x);
        ds[j][1] = p[j][1] * (ds[j][1] - dr.y);
        ds[j][2] = p[j][2] * (ds[j][2] - dr.x);
        ds[j][3] = p[j][3] * (ds[j][3] - dr.y);
      }
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) {
        uint32_t a[2][4];
        a_operand_split(p, kc, a);
        mma_ab<D, 2>(dv_acc, a, dob + stage, h * NJ / 2 + kc);
        a_operand_split(ds, kc, a);
        mma_ab<D, 2>(dk_acc, a, qb + stage, h * NJ / 2 + kc);
      }
    }
    __syncthreads();
  }
  store_rows<D>(dk_acc, scale, Kw, dk, vdk, bi, hi, k0 + warp * 16, S, lane);
  store_rows<D>(dv_acc, 1.0f, Vw, dv, vdv, bi, hi, k0 + warp * 16, S, lane);
}

// -------------------------------------------------------------------- host

View view_of(const long long* st) { return View{st[0], st[1], st[2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, int NT>
cudaError_t launch_fwd_one_pass(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                                bf16* o, const long long* st, int B, int heads, int S,
                                float scale, cudaStream_t stream) {
  const size_t smem = (size_t)3 * tile_elems<D>() * 2 + (size_t)NT * TK * 4;
  cudaError_t e = allow_smem(attn_fwd_one_pass_kernel<D, NT, NORMALISE_BEFORE_CAST>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + TQ - 1) / TQ, heads, B);
  attn_fwd_one_pass_kernel<D, NT, NORMALISE_BEFORE_CAST><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, o, view_of(st), view_of(st + 3), view_of(st + 6), view_of(st + 9), S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_forward(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* o,
                           const long long* st, int B, int heads, int S, float scale,
                           cudaStream_t stream) {
  const int n_tiles = (S + TK - 1) / TK;
  if constexpr (D <= 64) {  // the one-pass rule: S <= 256 at D <= 64
    switch (n_tiles) {
      case 1: return launch_fwd_one_pass<D, 1>(q, k, v, bias, o, st, B, heads, S, scale, stream);
      case 2: return launch_fwd_one_pass<D, 2>(q, k, v, bias, o, st, B, heads, S, scale, stream);
      case 3: return launch_fwd_one_pass<D, 3>(q, k, v, bias, o, st, B, heads, S, scale, stream);
      case 4: return launch_fwd_one_pass<D, 4>(q, k, v, bias, o, st, B, heads, S, scale, stream);
      default: break;
    }
  }
  const size_t smem = (size_t)5 * tile_elems<D>() * 2 + (size_t)n_tiles * TK * 4;
  cudaError_t e = allow_smem(attn_fwd_two_pass_kernel<D, NORMALISE_BEFORE_CAST>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_tiles, heads, B);
  attn_fwd_two_pass_kernel<D, NORMALISE_BEFORE_CAST><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, o, view_of(st), view_of(st + 3), view_of(st + 6), view_of(st + 9), S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_backward(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                            const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* stats,
                            const long long* st, int B, int heads, int S, float scale,
                            cudaStream_t stream) {
  const int n_tiles = (S + TK - 1) / TK;
  const size_t dq_smem = (size_t)6 * tile_elems<D>() * 2 + (size_t)n_tiles * TK * 4;
  const size_t dkdv_smem = (size_t)6 * tile_elems<D>() * 2 + (size_t)3 * n_tiles * TQ * 4;
  cudaError_t e = allow_smem(attn_bwd_dq_kernel<D>, dq_smem);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_bwd_dkdv_kernel<D>, dkdv_smem);
  if (e != cudaSuccess) return e;
  const View vq = view_of(st), vk = view_of(st + 3), vv = view_of(st + 6),
             vdo = view_of(st + 9), vdq = view_of(st + 12), vdk = view_of(st + 15),
             vdv = view_of(st + 18);
  dim3 grid(n_tiles, heads, B);
  attn_bwd_dq_kernel<D><<<grid, THREADS, dq_smem, stream>>>(q, k, v, bias, dout, dq, stats, vq,
                                                            vk, vv, vdo, vdq, S, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_kernel<D><<<grid, THREADS, dkdv_smem, stream>>>(
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
