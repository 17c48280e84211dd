// Tensor-core building blocks shared by the attention kernels (attention.cu:
// K6 and K7), the fused encoder layer (fused_layer_common.cuh: K1 and K5)
// and the cosine top-k (topk.cu: K3 and K4) on Hopper: PTX wrappers for
// cp.async, ldmatrix and mma.sync m16n8k16 (bf16 in, f32 accumulation) and
// m16n8k8 (TF32 in, f32 accumulation), the tile helpers of 64-row tiles whose rows
// are padded by 16 bytes (every ldmatrix phase hits 32 distinct banks), and
// the attention forward kernels (one pass, two passes) that K6 and K1 both
// run, each with its own cast point for the probabilities.
//
// Accumulator layout of one m16n8k16 product: lane (g = lane / 4,
// t = lane % 4) holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]), columns
// 2 t and 2 t + 1, which is also the layout of the A operand of the next
// product, so a score tile becomes P in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace mmac {

constexpr int TQ = 64;          // query rows per block (and per tile)
constexpr int TK = 64;          // keys per tile
constexpr int THREADS = 128;    // 4 warps x 16 rows
constexpr float INIT_MAX = -3.0e38f;
constexpr float PAD_BIAS = -3.0e38f;  // keys past S: below every real key (>= -1e9)
constexpr unsigned FULL = 0xffffffffu;

struct View {  // element strides of a [B, heads, S, D] view; D is contiguous
  long long b, h, s;
  __device__ __forceinline__ long long at(int bi, int hi, int si) const {
    return bi * b + hi * h + si * s;
  }
};

// Shared tiles are [64][D + 8] bf16: 16 bytes of padding per row.
template <int D>
__host__ __device__ constexpr int row_stride() {
  return D + 8;
}

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return 64 * row_stride<D>();
}

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix takes 32-bit shared addresses: a lane's base plus a constant
// offset, which ptxas folds into the instruction.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one m16n8k16 tile: a 16 x 16 row-major, b 16 x 8 column-major.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for one m16n8k8 tile in TF32: a 16 x 8 row-major, b 8 x 8
// column-major. Lane (g = lane / 4, t = lane % 4) holds a[0] = (g, t),
// a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8, t + 4), b0 = (t, g),
// b1 = (t + 4, g); c as in the m16n8k16 product.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero: half a TF32 ulp added to the magnitude bits, the low 13
// cleared; the value cvt.rna.tf32.f32 gives for every finite x), lo = x - hi
// (exact in f32), passed on whole: the tensor core reads a TF32 operand's
// top 19 bits, so it takes lo truncated to TF32. hi hi + hi lo + lo hi is
// then the product of two such values to 1.25 * 2^-20 of its magnitude at
// worst ("split TF32", three tensor-core products in place of one f32 FMA).
// Three integer and float instructions: on the H100 each instruction
// dispatched beside a product costs about a cycle, and cvt.rna.tf32.f32 and a
// rounded lo made the top-k kernel slower.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & ~0x1FFFu;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 as one bf16 pair (x0 in the low half: the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}

// x = hi + lo, hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in f32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// ------------------------------------------------------------ tile helpers
// An accumulator tile c[8][4] covers a warp's 16 rows by 64 columns: c[j]
// is columns [8 j, 8 j + 8); lane (g = lane / 4, t = lane % 4) holds rows g
// (c[j][0], c[j][1]) and g + 8 (c[j][2], c[j][3]), columns 8 j + 2 t and
// 8 j + 2 t + 1.

// Rows [r0, r0 + 64) of one (batch row, head) of a view into a shared tile,
// by cp.async; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, View v, int bi, int hi,
                                          int r0, int S, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < 64 * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * row_stride<D>() + c, src + v.at(bi, hi, ok ? r0 + r : 0) + c, ok);
  }
}

// Each lane's ldmatrix address within a shared tile, in bytes. lane_a: an
// A operand (16 rows by 16 columns), or a B operand read transposed (its
// rows are the k dimension). lane_bt: a B operand of A B^T (its rows are
// the product's columns).
template <int D>
__device__ __forceinline__ uint32_t lane_a(int lane) {
  return ((lane & 15) * row_stride<D>() + (lane >> 4) * 8) * 2;
}

template <int D>
__device__ __forceinline__ uint32_t lane_bt(int lane) {
  return (((lane & 7) + ((lane >> 4) << 3)) * row_stride<D>() + ((lane >> 3) & 1) * 8) * 2;
}

// c = A B^T over D: a is the lane's lane_a address in the warp's 16 rows of
// a shared tile, b its lane_bt address in the 64 rows of another (Q K^T,
// dO V^T, K Q^T, V dO^T); c's NJ 8-column groups (8: the whole 64-row tile
// of b; fewer: its first 8 NJ rows).
template <int D, int NJ>
__device__ __forceinline__ void mma_abt(float (&c)[NJ][4], uint32_t a_addr, uint32_t b_addr) {
  constexpr int ROW = row_stride<D>() * 2;  // bytes
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + kk * 32);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + jj * 16 * ROW + kk * 32);
      mma(c[2 * jj], a, b[0], b[1]);
      mma(c[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// The A operand over columns [16 kc, 16 kc + 16) of an accumulator tile of
// N 8-column groups.
template <int N>
__device__ __forceinline__ void a_operand(const float (&c)[N][4], int kc, float mul0, float mul1,
                                          uint32_t (&a)[4]) {
  a[0] = pack_bf16(c[2 * kc][0] * mul0, c[2 * kc][1] * mul0);
  a[1] = pack_bf16(c[2 * kc][2] * mul1, c[2 * kc][3] * mul1);
  a[2] = pack_bf16(c[2 * kc + 1][0] * mul0, c[2 * kc + 1][1] * mul0);
  a[3] = pack_bf16(c[2 * kc + 1][2] * mul1, c[2 * kc + 1][3] * mul1);
}

// The same, split: a[0] the bf16 value, a[1] the bf16 remainder.
template <int N>
__device__ __forceinline__ void a_operand_split(const float (&c)[N][4], int kc,
                                                uint32_t (&a)[2][4]) {
  split_bf16(c[2 * kc][0], c[2 * kc][1], a[0][0], a[1][0]);
  split_bf16(c[2 * kc][2], c[2 * kc][3], a[0][1], a[1][1]);
  split_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1], a[0][2], a[1][2]);
  split_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3], a[0][3], a[1][3]);
}

// acc += sum over PARTS of a[p] B[16 kc : 16 kc + 16][0 : D], B a shared tile
// read transposed from the lane's lane_a address b (P V, dS K, P^T dO,
// dS^T Q).
template <int D, int PARTS>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 8][4], const uint32_t (&a)[PARTS][4],
                                       uint32_t b_addr, int kc) {
  constexpr int ROW = row_stride<D>() * 2;  // bytes
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    uint32_t b[4];
    ldsm_x4_trans(b, b_addr + kc * 16 * ROW + dd * 32);
#pragma unroll
    for (int p = 0; p < PARTS; ++p) {
      mma(acc[2 * dd], a[p], b[0], b[1]);
      mma(acc[2 * dd + 1], a[p], b[2], b[3]);
    }
  }
}

// x = fadd(fmul(score, scale), bias) in place; bias[c] belongs to column c.
__device__ __forceinline__ void logits(float (&c)[8][4], const float* bias, float scale, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * (lane & 3));
    c[j][0] = __fadd_rn(__fmul_rn(c[j][0], scale), b.x);
    c[j][1] = __fadd_rn(__fmul_rn(c[j][1], scale), b.y);
    c[j][2] = __fadd_rn(__fmul_rn(c[j][2], scale), b.x);
    c[j][3] = __fadd_rn(__fmul_rn(c[j][3], scale), b.y);
  }
}

// The largest entry of rows g and g + 8 of a tile, across the quad.
__device__ __forceinline__ void tile_max(const float (&c)[8][4], float& m0, float& m1) {
  m0 = INIT_MAX;
  m1 = INIT_MAX;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m0 = fmaxf(m0, fmaxf(c[j][0], c[j][1]));
    m1 = fmaxf(m1, fmaxf(c[j][2], c[j][3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
}

// A warp's 16 x D accumulator rows, times mul, in bf16 to rows [r0, r0 + 16)
// of dst (those at or past S skipped), staged through the warp's own 16 rows
// of a shared tile so that every store is 16 bytes.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul, bf16* stage,
                                           bf16* dst, View v, int bi, int hi, int r0, int S,
                                           int lane) {
  constexpr int LD = row_stride<D>();
  const int g = lane >> 2;
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(stage + g * LD + n * 8 + c) =
        __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * LD + n * 8 + c) =
        __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < D / 16; ++it) {  // 16 rows of D / 8 chunks, 32 lanes
    const int i = lane + it * 32;
    const int r = i / (D / 8);
    const int col = (i % (D / 8)) * 8;
    if (r0 + r < S)
      *reinterpret_cast<uint4*>(dst + v.at(bi, hi, r0 + r) + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
}

// Key biases of one batch row for n_tiles * 64 keys, PAD_BIAS past S.
__device__ __forceinline__ void load_bias(float* dst, const float* key_bias, int bi, int n_tiles,
                                          int S, int tid) {
  for (int j = tid; j < n_tiles * TK; j += THREADS)
    dst[j] = j < S ? key_bias[(size_t)bi * S + j] : PAD_BIAS;
}


// ------------------------------------------------------------------ forward

// Where P takes 1 / l: K6 (the JAX package's _attn_kernel) normalises P in
// f32 before its bf16 cast; K1 (_kernel) rounds the unnormalised
// exp(x - m) to bf16 and divides the f32 P V product by l.
constexpr int NORMALISE_BEFORE_CAST = 1;
constexpr int DIVIDE_AFTER_PV = 0;

// One pass, NT key tiles (S <= 64 NT): the whole score row in registers.
// Q, K, V and o are views (rows of D contiguous elements at View strides):
// K6 gives [B, heads, S, D] tensors, K1 the packed [B * S, 3 H] projection.
template <int D, int NT, int CAST>
__global__ void __launch_bounds__(THREADS)
attn_fwd_one_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ key_bias,
                         bf16* __restrict__ o, View vq, View vk, View vv, View vo, int S,
                         float scale) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + TILE;                                 // two stages of one tile
  float* Kb = reinterpret_cast<float*>(ring + 2 * TILE);  // NT * 64 key biases
  const int q0 = blockIdx.x * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  bf16* Qw = Qs + warp * 16 * LD;
  const uint32_t qa = smem_addr(Qw) + lane_a<D>(lane);
  const uint32_t kb = smem_addr(ring) + lane_bt<D>(lane);
  const uint32_t vb = smem_addr(ring) + lane_a<D>(lane);

  // Steps 0 .. NT - 1 bring the K tiles, NT .. 2 NT - 1 the V tiles.
  auto issue = [&](int step) {
    bf16* dst = ring + (step & 1) * TILE;
    if (step < NT)
      load_tile<D>(dst, k, vk, bi, hi, step * TK, S, tid);
    else if (step < 2 * NT)
      load_tile<D>(dst, v, vv, bi, hi, (step - NT) * TK, S, tid);
    cp_commit();
  };
  load_tile<D>(Qs, q, vq, bi, hi, q0, S, tid);
  issue(0);
  load_bias(Kb, key_bias, bi, NT, S, tid);

  float x[NT][8][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    mma_abt<D>(x[t], qa, kb + (t & 1) * TILE * 2);
    logits(x[t], Kb + t * TK, scale, lane);
    __syncthreads();
  }
  float m0 = INIT_MAX, m1 = INIT_MAX;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float t0, t1;
    tile_max(x[t], t0, t1);
    m0 = fmaxf(m0, t0);
    m1 = fmaxf(m1, t1);
  }
  float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[t][j][0] = expf(x[t][j][0] - m0);
      x[t][j][1] = expf(x[t][j][1] - m0);
      x[t][j][2] = expf(x[t][j][2] - m1);
      x[t][j][3] = expf(x[t][j][3] - m1);
      l0 += x[t][j][0] + x[t][j][1];
      l1 += x[t][j][2] + x[t][j][3];
    }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float i0 = CAST == NORMALISE_BEFORE_CAST ? 1.0f / l0 : 1.0f;
  const float i1 = CAST == NORMALISE_BEFORE_CAST ? 1.0f / l1 : 1.0f;
  // P rounded to bf16 A operands now: half the registers of x.
  uint32_t pa[NT][4][1][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) a_operand(x[t], kc, i0, i1, pa[t][kc][0]);

  float acc[D / 8][4];
  zero<D>(acc);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    issue(NT + t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = ((NT + t) & 1) * TILE * 2;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) mma_ab<D, 1>(acc, pa[t][kc], vb + stage, kc);
    __syncthreads();
  }
  if (CAST == DIVIDE_AFTER_PV) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] /= l0;
      acc[n][1] /= l0;
      acc[n][2] /= l1;
      acc[n][3] /= l1;
    }
  }
  store_rows<D>(acc, 1.0f, Qw, o, vo, bi, hi, q0 + warp * 16, S, lane);
}

// Two passes over the key tiles, any S (the tile count is a runtime value):
// the scores are computed twice, K and V stream through a two-stage ring.
// NORMALISE_BEFORE_CAST (K6): pass one keeps each row's max and sum online,
// pass two rounds P = exp(x - m) / l to bf16. DIVIDE_AFTER_PV (K1): pass one
// keeps only the exact row max (P is cast after it, so it must be final);
// pass two sums exp(x - m) in the one-pass kernel's order, tile by tile and
// column by column, and divides the f32 P V product by it at the end, so
// K1's output is the one-pass form's, bit for bit, where both apply.
template <int D, int CAST>
__global__ void __launch_bounds__(THREADS)
attn_fwd_two_pass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ key_bias,
                         bf16* __restrict__ o, View vq, View vk, View vv, View vo, int S,
                         float scale) {
  constexpr int LD = row_stride<D>();
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + TILE;                                 // two stages of (K, V)
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
  const uint32_t kb = smem_addr(ring) + lane_bt<D>(lane);
  const uint32_t vb = smem_addr(ring + TILE) + lane_a<D>(lane);

  // Steps 0 .. n - 1 bring K tile `step` (pass one), n .. 2 n - 1 the K and
  // V tiles `step - n` (pass two).
  auto issue = [&](int step) {
    bf16* dst = ring + (step & 1) * 2 * TILE;
    if (step < n_tiles) {
      load_tile<D>(dst, k, vk, bi, hi, step * TK, S, tid);
    } else if (step < 2 * n_tiles) {
      load_tile<D>(dst, k, vk, bi, hi, (step - n_tiles) * TK, S, tid);
      load_tile<D>(dst + TILE, v, vv, bi, hi, (step - n_tiles) * TK, S, tid);
    }
    cp_commit();
  };
  load_tile<D>(Qs, q, vq, bi, hi, q0, S, tid);
  issue(0);
  load_bias(Kb, key_bias, bi, n_tiles, S, tid);

  float x[8][4];
  float m0 = INIT_MAX, m1 = INIT_MAX, l0 = 0.0f, l1 = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    issue(t + 1);
    cp_wait<1>();
    __syncthreads();
    mma_abt<D>(x, qa, kb + (t & 1) * 2 * TILE * 2);
    logits(x, Kb + t * TK, scale, lane);
    float t0, t1;
    tile_max(x, t0, t1);
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    if (CAST == NORMALISE_BEFORE_CAST) {
      float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        e0 += expf(x[j][0] - n0) + expf(x[j][1] - n0);
        e1 += expf(x[j][2] - n1) + expf(x[j][3] - n1);
      }
      l0 = fmaf(l0, expf(m0 - n0), quad_sum(e0));
      l1 = fmaf(l1, expf(m1 - n1), quad_sum(e1));
    }
    m0 = n0;
    m1 = n1;
    __syncthreads();
  }
  const float i0 = CAST == NORMALISE_BEFORE_CAST ? 1.0f / l0 : 1.0f;
  const float i1 = CAST == NORMALISE_BEFORE_CAST ? 1.0f / l1 : 1.0f;
  if (CAST == DIVIDE_AFTER_PV) {
    l0 = 0.0f;
    l1 = 0.0f;
  }

  float acc[D / 8][4];
  zero<D>(acc);
  for (int t = 0; t < n_tiles; ++t) {
    issue(n_tiles + t + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = ((n_tiles + t) & 1) * 2 * TILE * 2;
    mma_abt<D>(x, qa, kb + stage);
    logits(x, Kb + t * TK, scale, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j][0] = expf(x[j][0] - m0);
      x[j][1] = expf(x[j][1] - m0);
      x[j][2] = expf(x[j][2] - m1);
      x[j][3] = expf(x[j][3] - m1);
      if (CAST == DIVIDE_AFTER_PV) {
        l0 += x[j][0] + x[j][1];
        l1 += x[j][2] + x[j][3];
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[1][4];
      a_operand(x, kc, i0, i1, a[0]);
      mma_ab<D, 1>(acc, a, vb + stage, kc);
    }
    __syncthreads();
  }
  if (CAST == DIVIDE_AFTER_PV) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] /= l0;
      acc[n][1] /= l0;
      acc[n][2] /= l1;
      acc[n][3] /= l1;
    }
  }
  store_rows<D>(acc, 1.0f, Qw, o, vo, bi, hi, q0 + warp * 16, S, lane);
}

}  // namespace mmac
