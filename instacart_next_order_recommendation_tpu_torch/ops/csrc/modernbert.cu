// One ModernBERT encoder layer forward (pre-norm, RoPE, global or banded
// attention, GeGLU), an f32 residual stream in and out, for Hopper.
//
// Replaces no TPU kernel: the JAX package has only the post-LN BERT layer
// (ops/fused_layer.py::_kernel). It was added so that the port serves
// ModernBERT (answerdotai/ModernBERT-base, as nomic-ai/modernbert-embed-base
// runs it) through its own kernels. Per layer, with LN a LayerNorm without
// bias, the products' operands in bf16 and their accumulation in f32:
//   h    = bf16(LN_attn(x))          layer 0: bf16(x), no norm
//   qkv  = bf16(h @ Wqkv)            no bias anywhere
//   q, k = bf16(rope_theta(q)), bf16(rope_theta(k))   f32 cos / sin tables
//   attn = bf16(softmax(scale q k^T + keybias [band]) v)
//   x'   = x + attn @ Wo             f32
//   [a | g] = bf16(bf16(LN_mlp(x')) @ Wi)
//   u    = bf16(gelu(a) * g)
//   y    = x' + u @ Wo_mlp           f32
// The band keeps keys with |i - j| <= half (64 in ModernBERT's windowed
// layers, every layer but each third); half < 0 means global attention.
// The key bias is -1e9 at padded keys, as K1's.
//
// What bounds it on the H100, per token of a 768-wide layer: the four
// products, 2 (4 H^2 + 3 H I) = 10.0 MFLOP, at 989 TFLOP/s; global attention
// 4 S H operations a token (S = 8,192: 25 MFLOP, more than the products),
// bound by operations; banded attention 4 H 129 operations a token against
// the 8 H bytes of q, k, v and o, about 64 operations a byte, under the
// card's 295: bound by bytes. The row passes (norms, RoPE, GeGLU) move a few
// KB a token each and are bound by bytes.
//
// What the design does about it:
// - The four products run on the GEMM core of fused_layer_common.cuh (the
//   one K1 and K5 run: wgmma fed by TMA), FORM_XW. The two residual adds are
//   its EPI_ADD_AUX_F32 epilogue: the f32 residual is loaded by TMA beside
//   the tile's products and the f32 sum stored, so the stream never rounds.
// - Global attention, mb_attn_global_kernel, is warp-specialised on wgmma
//   fed by TMA: one block per (192-query tile, head, batch row), a producer
//   warpgroup whose one thread loads Q once and streams 128-key tiles of K,
//   V and the key bias through a four-stage mbarrier ring (its registers
//   given to the consumers by setmaxnreg), and three consumer warpgroups of
//   64 query rows, each holding its Q in shared memory for every product:
//   S = Q K^T as wgmma with both operands in shared memory, O += P V with P
//   in registers. Kept overlap: a warpgroup's softmax of tile n runs under
//   its own P V of tile n - 1, and the warpgroups issue their products in
//   turns, so one's softmax runs under the others' products (details at the
//   kernel).
// - Banded attention, mb_attn_band_kernel, keeps the bring-up body
//   (attn_body, mma.sync products of mma_common.cuh): one block per
//   (64-query tile, head, batch row), online softmax over 64-key tiles that
//   stream through a two-stage cp.async ring, scheduling only the key tiles
//   that meet the band (three of them at half 64), so its work grows as S,
//   not S^2. It is bound by bytes over three key tiles a query tile, where
//   the global form is bound by its long K, V streams at the tensor cores'
//   rate; the two share no code, so neither carries a mode switch in its
//   inner loop, and a trace tells them apart by name.
// - RoPE in place on q and k of the packed projection (one pass), GeGLU as
//   one pass over [a | g], and the norms as one row pass each, f32 in and
//   bf16 out. Fusing them into the products' epilogues is later work.

#include "fused_layer_common.cuh"

namespace mb {

using namespace fl;
using namespace mmac;

constexpr int HD = 64;  // ModernBERT's head_dim, the one these kernels take
constexpr int ROT = HD / 2;

// ------------------------------------------------------------------ RoPE
// q and k of every head, rotated in place in the packed [B * S, 3 H]
// projection: pairs (j, j + 32) of a head by the angle of (position, j),
// cos and sin f32 [S, 32]. One thread takes 8 pairs (16-byte loads).
constexpr int ROPE_THREADS = 256;

__global__ void __launch_bounds__(ROPE_THREADS)
mb_rope_kernel(bf16* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, long long M, int S, int H) {
  const int per_row = 2 * (H / HD) * (ROT / 8);  // q and k, heads, groups of 8 pairs
  const long long t = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  if (t >= M * per_row) return;
  const long long row = t / per_row;
  const int rem = (int)(t % per_row);
  const int part = rem / (per_row / 2);         // 0: q, 1: k
  const int head = (rem % (per_row / 2)) / (ROT / 8);
  const int j0 = (rem % (ROT / 8)) * 8;
  const int pos = (int)(row % S);
  bf16* base = qkv + row * 3 * H + part * H + head * HD;
  uint4 lo = *reinterpret_cast<const uint4*>(base + j0);
  uint4 hi = *reinterpret_cast<const uint4*>(base + j0 + ROT);
  const float4* c4 = reinterpret_cast<const float4*>(cos_t + (size_t)pos * ROT + j0);
  const float4* s4 = reinterpret_cast<const float4*>(sin_t + (size_t)pos * ROT + j0);
  const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
  const float cs[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  const float sn[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  __nv_bfloat162* l2 = reinterpret_cast<__nv_bfloat162*>(&lo);
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 a = __bfloat1622float2(l2[p]);
    const float2 b = __bfloat1622float2(h2[p]);
    const float c0 = cs[2 * p], c1 = cs[2 * p + 1], s0 = sn[2 * p], s1 = sn[2 * p + 1];
    l2[p] = __floats2bfloat162_rn(a.x * c0 - b.x * s0, a.y * c1 - b.y * s1);
    h2[p] = __floats2bfloat162_rn(b.x * c0 + a.x * s0, b.y * c1 + a.y * s1);
  }
  *reinterpret_cast<uint4*>(base + j0) = lo;
  *reinterpret_cast<uint4*>(base + j0 + ROT) = hi;
}

// --------------------------------------------------- banded attention
// Online softmax (the running row max m and sum l, the output rescaled by
// exp(m_old - m_new) as each key tile lands); P = exp(x - m) rounded to bf16
// for the P V product, l summed in f32, the output divided by l at the end.
// Keys past S and, in the band, keys farther than `half` from the query
// take INIT_MAX in place of their logit: exp of it is 0 against any real
// maximum. Every scheduled tile holds, for each query row, at least one key
// inside the band, so no row's maximum is INIT_MAX once its first tile is
// in; a padded key (bias -1e9) is finite, as in K1.
template <bool BAND>
__device__ __forceinline__ void attn_body(const bf16* __restrict__ qkv,
                                          const float* __restrict__ key_bias,
                                          bf16* __restrict__ out, int S, int H, int half,
                                          float scale) {
  constexpr int LD = row_stride<HD>();
  constexpr int TILE = tile_elems<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + TILE;  // two stages of (K, V)
  const int qt = blockIdx.x;
  const int q0 = qt * TQ;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_tiles = (S + TK - 1) / TK;
  int t_lo = 0, t_hi = n_tiles;
  if (BAND) {
    t_lo = max(0, q0 - half) / TK;
    t_hi = min(n_tiles, (q0 + TQ - 1 + half) / TK + 1);
  }
  const int nt = t_hi - t_lo;
  const View vqkv{(long long)S * 3 * H, HD, 3LL * H};
  const View vo{(long long)S * H, HD, (long long)H};
  const bf16* q = qkv;
  const bf16* k = qkv + H;
  const bf16* v = qkv + 2 * H;
  bf16* Qw = Qs + warp * 16 * LD;
  const uint32_t qa = smem_addr(Qw) + lane_a<HD>(lane);
  const uint32_t kb = smem_addr(ring) + lane_bt<HD>(lane);
  const uint32_t vb = smem_addr(ring + TILE) + lane_a<HD>(lane);

  auto issue = [&](int i) {  // the i-th scheduled key tile's K and V
    if (i < nt) {
      bf16* dst = ring + (i & 1) * 2 * TILE;
      const int r0 = (t_lo + i) * TK;
      load_tile<HD>(dst, k, vqkv, bi, hi, r0, S, tid);
      load_tile<HD>(dst + TILE, v, vqkv, bi, hi, r0, S, tid);
    }
    cp_commit();
  };
  load_tile<HD>(Qs, q, vqkv, bi, hi, q0, S, tid);
  issue(0);

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r_a = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_b = r_a + 8;
  const float* kbias = key_bias + (size_t)bi * S;
  float m0 = INIT_MAX, m1 = INIT_MAX, l0 = 0.0f, l1 = 0.0f;
  float acc[HD / 8][4];
  zero<HD>(acc);
  for (int i = 0; i < nt; ++i) {
    issue(i + 1);
    cp_wait<1>();
    __syncthreads();
    const uint32_t stage = (i & 1) * 2 * TILE * 2;
    const int c0 = (t_lo + i) * TK;
    float x[8][4];
    mma_abt<HD>(x, qa, kb + stage);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + j * 8 + 2 * tq + e;
        const bool real = c < S;
        const float bias = real ? __ldg(kbias + c) : 0.0f;
        const float xa = __fadd_rn(__fmul_rn(x[j][e], scale), bias);
        const float xb = __fadd_rn(__fmul_rn(x[j][2 + e], scale), bias);
        x[j][e] = real && (!BAND || abs(r_a - c) <= half) ? xa : INIT_MAX;
        x[j][2 + e] = real && (!BAND || abs(r_b - c) <= half) ? xb : INIT_MAX;
      }
    float t0, t1;
    tile_max(x, t0, t1);
    const float n0 = fmaxf(m0, t0), n1 = fmaxf(m1, t1);
    const float a0 = __expf(m0 - n0), a1 = __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x[j][0] = __expf(x[j][0] - m0);
      x[j][1] = __expf(x[j][1] - m0);
      x[j][2] = __expf(x[j][2] - m1);
      x[j][3] = __expf(x[j][3] - m1);
      l0 += x[j][0] + x[j][1];
      l1 += x[j][2] + x[j][3];
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t a[1][4];
      a_operand(x, kc, 1.0f, 1.0f, a[0]);
      mma_ab<HD, 1>(acc, a, vb + stage, kc);
    }
    __syncthreads();  // the stage is free for tile i + 2
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    acc[n][0] /= l0;
    acc[n][1] /= l0;
    acc[n][2] /= l1;
    acc[n][3] /= l1;
  }
  store_rows<HD>(acc, 1.0f, Qw, out, vo, bi, hi, q0 + warp * 16, S, lane);
}

__global__ void __launch_bounds__(THREADS)
mb_attn_band_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                    bf16* __restrict__ out, int S, int H, int half, float scale) {
  attn_body<true>(qkv, key_bias, out, S, H, half, scale);
}

// ------------------------------------------------------ global attention
// The global form on Hopper's asynchronous path: one block per (192-query
// tile, head, batch row) and four warpgroups. The producer's one thread
// loads the block's Q once by TMA, then streams 128-key tiles of K and V and
// their 128 f32 key biases by TMA into a ring of GSTAGES stages, each handed
// over on its full mbarrier (expected bytes) and taken back on its empty one
// (one arrival a consumer warp); setmaxnreg gives its registers to the
// consumers. Three consumer warpgroups own 64 query rows each: S = Q K^T is
// wgmma m64n128k16 with both operands in shared memory; O += P V is wgmma
// m64n64k16 with P, rounded to bf16, as the register A operand and V an
// MN-major operand in shared memory. Overlap: within a warpgroup the softmax
// of tile n runs under the P V of tile n - 1, and O's rescale under the
// Q K^T of tile n; across warpgroups the products are issued in turns (named
// barriers 4 + wg, round robin), so that one warpgroup's softmax runs under
// the others' products. Three warpgroups and not two: at head_dim 64 the
// softmax (an exponential a score) costs as much issue as the products, and
// two left the card idle between them (an H100 at B=16 S=8192: 9.0 ms against
// 7.3 for three).
//
// The arithmetic is attn_body's with log2 e folded into the exponent: the
// logit z = scale qk + bias in f32 (INIT_MAX at keys past S), P = 2^(z log2 e
// - m log2 e) for the running maximum m, rounded to bf16 for P V while l
// sums it in f32, the rescale 2^((m_old - m_new) log2 e) (skipped where it is
// 1 for every row of a warp), the output divided by l.
//
// Tensor maps: q, k and v through one 3-D map of the packed projection
// [B, S, 3H] (boxes of 64 x 64 x 1), so that rows past S read as zeros and
// never the next batch row's; the key bias through a 1-D map of [B * S]
// (any S; what lands past a row's S is masked); the output through a 3-D
// map [B, S, H], one box of 64 rows a consumer, which drops rows past S.
constexpr int GC = 3;                    // consumer warpgroups, 64 query rows each
constexpr int GQ = 64 * GC, GK = 128;    // query rows a block, keys a tile
constexpr int GSTAGES = 4;
constexpr int G_THREADS = 128 * (1 + GC);
constexpr int G_BOX = 64 * HD * 2;       // 64 rows of q, k, v or o: 8192 bytes
constexpr int G_KV_BYTES = GK * HD * 2;  // a K or V tile
constexpr int G_BIAS = GK * 4;
constexpr int G_STAGE_TX = 2 * G_KV_BYTES + G_BIAS;
constexpr size_t G_SMEM = 1024 + GC * G_BOX + (size_t)GSTAGES * (2 * G_KV_BYTES + G_BIAS) +
                          (1 + 2 * GSTAGES) * sizeof(uint64_t);
constexpr int G_PRODUCER_REGS = 24, G_CONSUMER_REGS = 160;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(wgc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wgc::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(wgc::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wgc::smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both K-major in shared memory;
// `accumulate` 0 overwrites d. d's layout: wgc::wgmma_m64n128k16's.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A bf16 from registers (the
// mma.sync m16n8k16 A fragment, warp w taking rows 16 w to 16 w + 15), B
// MN-major in shared memory. d[4 j + 2 h + e] at row 16 w + g + 8 h, column
// 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) wgc::fence_operand(r[i]);
}

__device__ __forceinline__ void fence_all(uint32_t (&r)[GK / 4]) {
#pragma unroll
  for (int i = 0; i < GK / 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S = Q K^T of one key tile: four 16-deep steps over head_dim 64.
__device__ __forceinline__ void issue_qk(float (&s)[GK / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_qk(s, wgc::sw128_desc(q_rows + kk * 32, 16, 1024),
             wgc::sw128_desc(k_tile + kk * 32, 16, 1024), kk);
}

// O += P V of one key tile: eight 16-key steps, 2048 bytes of V apart.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[GK / 4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < GK / 16; ++kc)
    wgmma_pv(o, p + 4 * kc, wgc::sw128_desc(v_tile + kc * 2048, 8192, 1024));
}

// The online softmax of one key tile on its scores s, in place (s becomes P
// in f32); bias is the tile's key biases in shared memory. Lane (g, t) holds
// rows g and g + 8 of its warp's 16, columns 8 j + 2 t + e in s[4 j + 2 h +
// e]. Sets each row's rescale factor a.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[GK / 2], uint32_t bias, int c0, int S,
                                             int tq, float scale, float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1) {
  // Each row's maximum and sum in two chains (even and odd j), for the
  // scheduler's sake; the maximum is exact whatever the order.
  float t0[2] = {INIT_MAX, INIT_MAX}, t1[2] = {INIT_MAX, INIT_MAX};
#pragma unroll
  for (int j = 0; j < GK / 8; ++j) {
    const float2 b = lds2(bias + 4 * (8 * j + 2 * tq));
    s[4 * j] = fmaf(s[4 * j], scale, b.x);
    s[4 * j + 1] = fmaf(s[4 * j + 1], scale, b.y);
    s[4 * j + 2] = fmaf(s[4 * j + 2], scale, b.x);
    s[4 * j + 3] = fmaf(s[4 * j + 3], scale, b.y);
    if (MASK) {
      const int c = c0 + 8 * j + 2 * tq;
      if (c >= S) s[4 * j] = s[4 * j + 2] = INIT_MAX;
      if (c + 1 >= S) s[4 * j + 1] = s[4 * j + 3] = INIT_MAX;
    }
    t0[j & 1] = fmaxf(t0[j & 1], fmaxf(s[4 * j], s[4 * j + 1]));
    t1[j & 1] = fmaxf(t1[j & 1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float n0 = fmaxf(m0, quad_max(fmaxf(t0[0], t0[1])));
  const float n1 = fmaxf(m1, quad_max(fmaxf(t1[0], t1[1])));
  a0 = ex2((m0 - n0) * LOG2E);
  a1 = ex2((m1 - n1) * LOG2E);
  m0 = n0;
  m1 = n1;
  const float k0 = -n0 * LOG2E, k1 = -n1 * LOG2E;
  float r0[2] = {0.0f, 0.0f}, r1[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < GK / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], LOG2E, k0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, k0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, k1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, k1));
    r0[j & 1] += s[4 * j] + s[4 * j + 1];
    r1[j & 1] += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + (r0[0] + r0[1]);
  l1 = l1 * a1 + (r1[0] + r1[1]);
}

__device__ __forceinline__ void softmax_any(bool masked, float (&s)[GK / 2], uint32_t bias,
                                            int c0, int S, int tq, float scale, float& m0,
                                            float& m1, float& l0, float& l1, float& a0,
                                            float& a1) {
  if (masked)
    softmax_tile<true>(s, bias, c0, S, tq, scale, m0, m1, l0, l1, a0, a1);
  else
    softmax_tile<false>(s, bias, c0, S, tq, scale, m0, m1, l0, l1, a0, a1);
}

// P in bf16 as the A operand of the 16-key step kc: p[4 kc + i] holds
// s[8 kc + 2 i] and s[8 kc + 2 i + 1] (the accumulator's layout is the A
// fragment's, two column groups a step).
__device__ __forceinline__ void to_operand(const float (&s)[GK / 2], uint32_t (&p)[GK / 4]) {
#pragma unroll
  for (int i = 0; i < GK / 4; ++i) p[i] = bits(__floats2bfloat162_rn(s[2 * i], s[2 * i + 1]));
}

__device__ __forceinline__ void rescale(float (&o)[32], float a0, float a1) {
  if (__all_sync(FULL, a0 == 1.0f && a1 == 1.0f)) return;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

__global__ void __launch_bounds__(G_THREADS, 1)
mb_attn_global_kernel(const __grid_constant__ CUtensorMap map_qkv,
                      const __grid_constant__ CUtensorMap map_bias,
                      const __grid_constant__ CUtensorMap map_out, int S, int H, float scale) {
  extern __shared__ unsigned char g_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;             // consumer w's 64 rows of Q (then of O) at w G_BOX
  unsigned char* kv = qs + GC * G_BOX;  // stage s: K at kv + 2 s G_KV_BYTES, V after it
  float* bias_s = reinterpret_cast<float*>(kv + GSTAGES * 2 * G_KV_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(bias_s + GSTAGES * GK);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + GSTAGES;
  const int q0 = blockIdx.x * GQ, hi = blockIdx.y, bi = blockIdx.z;
  const int nt = (S + GK - 1) / GK;
  const bool ragged = S % GK != 0;  // the last key tile reaches past S

  if (threadIdx.x == 0) {
    wgc::mbar_init(q_full, 1);
    for (int s = 0; s < GSTAGES; ++s) {
      wgc::mbar_init(&full[s], 1);
      wgc::mbar_init(&empty[s], 4 * GC);  // every consumer warp
    }
    wgc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    wgc::setmaxnreg_dec<G_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      wgc::tma_prefetch(&map_qkv);
      wgc::tma_prefetch(&map_bias);
      wgc::mbar_arrive_expect_tx(q_full, GC * G_BOX);
      for (int w = 0; w < GC; ++w)
        tma_load_3d(qs + w * G_BOX, &map_qkv, q_full, hi * HD, q0 + 64 * w, bi);
      int stage = 0;
      uint32_t phase = 0;
      for (int n = 0; n < nt; ++n) {
        wgc::mbar_wait(&empty[stage], phase ^ 1);
        wgc::mbar_arrive_expect_tx(&full[stage], G_STAGE_TX);
        unsigned char* k_tile = kv + stage * 2 * G_KV_BYTES;
        for (int r = 0; r < GK; r += 64) {
          tma_load_3d(k_tile + r * 128, &map_qkv, &full[stage], H + hi * HD, n * GK + r, bi);
          tma_load_3d(k_tile + G_KV_BYTES + r * 128, &map_qkv, &full[stage], 2 * H + hi * HD,
                      n * GK + r, bi);
        }
        tma_load_1d(bias_s + stage * GK, &map_bias, &full[stage], bi * S + n * GK);
        if (++stage == GSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups
    wgc::setmaxnreg_inc<G_CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int wg = ct >> 7;
    const int warp4 = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const uint32_t q_rows = wgc::smem_u32(qs) + wg * G_BOX;
    const uint32_t ring = wgc::smem_u32(kv);
    const uint32_t bias_ring = wgc::smem_u32(bias_s);
    float s[GK / 2], o[32];
    uint32_t p[GK / 4];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = INIT_MAX, m1 = INIT_MAX, l0 = 0.0f, l1 = 0.0f, a0, a1;
    int stage = 0;
    uint32_t phase = 0;

    // Turns: a warpgroup issues a round's products once the one before it
    // has issued its own of that round (warpgroup 0: the last one, of the
    // round before).
    auto my_turn = [&]() { wgc::named_sync(4 + wg, 256); };
    auto your_turn = [&](bool last) {
      if (!(last && wg == GC - 1)) named_arrive(4 + (wg + 1) % GC, 256);
    };
    if (wg == GC - 1) named_arrive(4, 256);  // warpgroup 0 goes first

    wgc::mbar_wait(q_full, 0);
    wgc::mbar_wait(&full[0], 0);
    fence_all(s);
    my_turn();
    wgc::wgmma_fence();
    issue_qk(s, q_rows, ring);
    wgc::wgmma_commit();
    your_turn(false);
    wgc::wgmma_wait<0>();
    fence_all(s);
    softmax_any(ragged && nt == 1, s, bias_ring, 0, S, tq, scale, m0, m1, l0, l1, a0, a1);
    to_operand(s, p);
    for (int n = 1; n < nt; ++n) {
      const int prev = stage;
      if (++stage == GSTAGES) {
        stage = 0;
        phase ^= 1;
      }
      wgc::mbar_wait(&full[stage], phase);
      fence_all(s);
      fence_all(o);
      fence_all(p);
      my_turn();
      wgc::wgmma_fence();
      issue_qk(s, q_rows, ring + stage * 2 * G_KV_BYTES);
      wgc::wgmma_commit();
      rescale(o, a0, a1);  // by tile n - 1's factors, while Q K^T runs
      fence_all(o);
      wgc::wgmma_fence();
      issue_pv(o, p, ring + prev * 2 * G_KV_BYTES + G_KV_BYTES);
      wgc::wgmma_commit();
      your_turn(false);
      wgc::wgmma_wait<1>();  // S of tile n; P V of tile n - 1 still runs
      fence_all(s);
      softmax_any(ragged && n == nt - 1, s, bias_ring + stage * G_BIAS, n * GK, S, tq, scale,
                  m0, m1, l0, l1, a0, a1);
      wgc::wgmma_wait<0>();
      fence_all(o);
      fence_all(p);
      if (lane == 0) wgc::mbar_arrive(&empty[prev]);
      to_operand(s, p);
    }
    rescale(o, a0, a1);
    fence_all(o);
    fence_all(p);
    my_turn();
    wgc::wgmma_fence();
    issue_pv(o, p, ring + stage * 2 * G_KV_BYTES + G_KV_BYTES);
    wgc::wgmma_commit();
    your_turn(true);
    wgc::wgmma_wait<0>();
    fence_all(o);

    // ---- epilogue: O / l, staged in this warpgroup's own 64 rows of Q (its
    // last product has read them) in TMA's swizzled layout, stored by TMA.
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    unsigned char* ob = qs + wg * G_BOX;
    const int r = warp4 * 16 + g;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(ob + wgc::sw128_offset<2>(r, 8 * j + 2 * tq)) =
          __floats2bfloat162_rn(o[4 * j] / l0, o[4 * j + 1] / l0);
      *reinterpret_cast<__nv_bfloat162*>(ob + wgc::sw128_offset<2>(r + 8, 8 * j + 2 * tq)) =
          __floats2bfloat162_rn(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
    wgc::fence_proxy_async();
    wgc::named_sync(1 + wg, 128);
    if ((ct & 127) == 0) {
      wgc::tma_store_3d(&map_out, ob, hi * HD, q0 + wg * 64, bi);
      wgc::bulk_commit();
      wgc::bulk_wait<0>();
    }
  }
}

// f32 [n] in boxes of GK, no swizzle (encode_map's 128-byte swizzle takes
// rows of at most 128 bytes).
static cudaError_t encode_bias_map(CUtensorMap* map, const float* bias, long long n) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = wgc::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unread at rank 1
  const cuuint32_t box[1] = {GK}, elem_strides[1] = {1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(bias),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

static cudaError_t launch_attention_global(const bf16* qkv, const float* key_bias, bf16* out,
                                           int batch, int seq, int H, int heads, float scale,
                                           cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(mb_attn_global_kernel, G_SMEM, done);
  if (e != cudaSuccess) return e;
  CUtensorMap map_qkv, map_bias, map_out;
  const cuuint32_t box[3] = {HD, 64, 1};
  const cuuint64_t qkv_dims[3] = {(cuuint64_t)3 * H, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t qkv_strides[2] = {(cuuint64_t)3 * H * 2, (cuuint64_t)seq * 3 * H * 2};
  e = wgc::encode_map(&map_qkv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv, qkv_dims, qkv_strides,
                      box);
  if (e != cudaSuccess) return e;
  const cuuint64_t out_dims[3] = {(cuuint64_t)H, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t out_strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)seq * H * 2};
  e = wgc::encode_map(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, out_dims, out_strides,
                      box);
  if (e != cudaSuccess) return e;
  e = encode_bias_map(&map_bias, key_bias, (long long)batch * seq);
  if (e != cudaSuccess) return e;
  const dim3 grid((seq + GQ - 1) / GQ, heads, batch);
  mb_attn_global_kernel<<<grid, G_THREADS, G_SMEM, stream>>>(map_qkv, map_bias, map_out, seq, H,
                                                            scale);
  return cudaGetLastError();
}

static cudaError_t launch_attention_mb(const bf16* qkv, const float* key_bias, bf16* out,
                                       int batch, int seq, int H, int heads, int half,
                                       float scale, cudaStream_t stream) {
  if (half < 0)
    return launch_attention_global(qkv, key_bias, out, batch, seq, H, heads, scale, stream);
  const size_t smem = (size_t)5 * tile_elems<HD>() * 2;  // Q and two stages of (K, V)
  const dim3 grid((seq + TQ - 1) / TQ, heads, batch);
  mb_attn_band_kernel<<<grid, THREADS, smem, stream>>>(qkv, key_bias, out, seq, H, half, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------- row norms
// y = bf16(LN(x) * scale) per row of f32 x (a LayerNorm without bias), or
// bf16(x) where scale is null (layer 0 has no attention norm). One warp a
// row, float4 loads, H % 128 == 0 and H <= 1024.
constexpr int NORM_ROWS = 4;
constexpr int NORM_MAX_VEC = 8;  // float4 a lane: H <= 1024

__global__ void __launch_bounds__(NORM_ROWS * 32)
mb_rownorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                  bf16* __restrict__ y, long long M, int H, float eps) {
  const long long row = (long long)blockIdx.x * NORM_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int vecs = H / 128;
  const float4* xr = reinterpret_cast<const float4*>(x + row * H);
  float4 v[NORM_MAX_VEC];
  float sum = 0.0f;
#pragma unroll
  for (int t = 0; t < NORM_MAX_VEC; ++t)
    if (t < vecs) {
      v[t] = xr[lane + 32 * t];
      sum += (v[t].x + v[t].y) + (v[t].z + v[t].w);
    }
  float mean = 0.0f, inv = 1.0f;
  if (scale != nullptr) {
    mean = warp_sum(sum) / H;
    float sq = 0.0f;
#pragma unroll
    for (int t = 0; t < NORM_MAX_VEC; ++t)
      if (t < vecs) {
        const float a = v[t].x - mean, b = v[t].y - mean, c = v[t].z - mean, d = v[t].w - mean;
        sq += (a * a + b * b) + (c * c + d * d);
      }
    inv = rsqrtf(warp_sum(sq) / H + eps);
  }
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(y + row * H);
#pragma unroll
  for (int t = 0; t < NORM_MAX_VEC; ++t)
    if (t < vecs) {
      const int col = 4 * (lane + 32 * t);
      float4 s = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      if (scale != nullptr) s = *reinterpret_cast<const float4*>(scale + col);
      yr[col / 2] = __floats2bfloat162_rn((v[t].x - mean) * inv * s.x, (v[t].y - mean) * inv * s.y);
      yr[col / 2 + 1] =
          __floats2bfloat162_rn((v[t].z - mean) * inv * s.z, (v[t].w - mean) * inv * s.w);
    }
}

static cudaError_t launch_rownorm(const float* x, const float* scale, bf16* y, long long M, int H,
                                  float eps, cudaStream_t stream) {
  if (H % 128 || H > 128 * NORM_MAX_VEC) return cudaErrorInvalidValue;
  const long long blocks = (M + NORM_ROWS - 1) / NORM_ROWS;
  mb_rownorm_kernel<<<(unsigned)blocks, NORM_ROWS * 32, 0, stream>>>(x, scale, y, M, H, eps);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- GeGLU
// u[r, c] = bf16(gelu(a) * g), a = ag[r, c], g = ag[r, I + c]: Wi's output
// is [input | gate], as ModernBERT's Wi(x).chunk(2). 8 columns a thread.
constexpr int GEGLU_THREADS = 256;

__global__ void __launch_bounds__(GEGLU_THREADS)
mb_geglu_kernel(const bf16* __restrict__ ag, bf16* __restrict__ u, long long M, int I) {
  const int per_row = I / 8;
  const long long t = (long long)blockIdx.x * GEGLU_THREADS + threadIdx.x;
  if (t >= M * per_row) return;
  const long long row = t / per_row;
  const int c = (int)(t % per_row) * 8;
  uint4 a = *reinterpret_cast<const uint4*>(ag + row * 2 * I + c);
  const uint4 gv = *reinterpret_cast<const uint4*>(ag + row * 2 * I + I + c);
  __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float2 x = __bfloat1622float2(a2[p]);
    const float2 gg = __bfloat1622float2(g2[p]);
    a2[p] = __floats2bfloat162_rn(gelu_erf(x.x) * gg.x, gelu_erf(x.y) * gg.y);
  }
  *reinterpret_cast<uint4*>(u + row * I + c) = a;
}

static cudaError_t launch_geglu(const bf16* ag, bf16* u, long long M, int I, cudaStream_t stream) {
  if (I % 8) return cudaErrorInvalidValue;
  const long long n = M * (I / 8);
  mb_geglu_kernel<<<(unsigned)((n + GEGLU_THREADS - 1) / GEGLU_THREADS), GEGLU_THREADS, 0,
                    stream>>>(ag, u, M, I);
  return cudaGetLastError();
}

static cudaError_t launch_rope(bf16* qkv, const float* cos_t, const float* sin_t, long long M,
                               int S, int H, cudaStream_t stream) {
  const long long n = M * 2 * (H / HD) * (ROT / 8);
  mb_rope_kernel<<<(unsigned)((n + ROPE_THREADS - 1) / ROPE_THREADS), ROPE_THREADS, 0, stream>>>(
      qkv, cos_t, sin_t, M, S, H);
  return cudaGetLastError();
}

}  // namespace mb

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shapes the wrapper has checked: H = heads * 64, H % 128 == 0, H <= 1024,
// I % 64 == 0, S >= 1, every pointer 16-byte aligned and contiguous.
// x_in, x_mid, x_out: f32 [B * S, H], three buffers; key_bias f32 [B, S];
// cos_t, sin_t f32 [S, 32] for this layer's theta; attn_ln null for layer 0;
// half < 0 for a global layer. Scratch: h bf16 [B * S, H] (both norms'
// output), qkv bf16 [B * S, 3 H], attn bf16 [B * S, H], ag bf16 [B * S, 2 I],
// u bf16 [B * S, I].
int modernbert_layer_forward(const void* x_in, const void* key_bias, const void* cos_t,
                             const void* sin_t, const void* attn_ln, const void* wqkv,
                             const void* wo, const void* mlp_ln, const void* wi,
                             const void* wo_mlp, void* h, void* qkv, void* attn, void* x_mid,
                             void* ag, void* u, void* x_out, int batch, int seq, int hidden,
                             int heads, int inter, int half, float scale, float eps,
                             void* stream_ptr) {
  using namespace mb;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = batch * seq;
  const int H = hidden;
  cudaError_t e;
  e = launch_rownorm((const float*)x_in, (const float*)attn_ln, (bf16*)h, M, H, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)h, (const bf16*)wqkv, nullptr, qkv, nullptr,
                                     nullptr, M, 3 * H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_rope((bf16*)qkv, (const float*)cos_t, (const float*)sin_t, M, seq, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_attention_mb((const bf16*)qkv, (const float*)key_bias, (bf16*)attn, batch, seq, H,
                          heads, half, scale, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_ADD_AUX_F32>((const bf16*)attn, (const bf16*)wo, nullptr, x_mid,
                                            (const float*)x_in, nullptr, M, H, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_rownorm((const float*)x_mid, (const float*)mlp_ln, (bf16*)h, M, H, eps, stream);
  if (e != cudaSuccess) return e;
  e = launch_gemm<FORM_XW, EPI_BIAS>((const bf16*)h, (const bf16*)wi, nullptr, ag, nullptr,
                                     nullptr, M, 2 * inter, H, stream);
  if (e != cudaSuccess) return e;
  e = launch_geglu((const bf16*)ag, (bf16*)u, M, inter, stream);
  if (e != cudaSuccess) return e;
  return launch_gemm<FORM_XW, EPI_ADD_AUX_F32>((const bf16*)u, (const bf16*)wo_mlp, nullptr,
                                               x_out, (const float*)x_mid, nullptr, M, H, inter,
                                               stream);
}

// RoPE in place on q and k of qkv bf16 [B * S, 3 H], then attention into
// out bf16 [B * S, H]: the layer's attention alone (tests, timings).
int modernbert_attention(void* qkv, const void* key_bias, const void* cos_t, const void* sin_t,
                         void* out, int batch, int seq, int hidden, int heads, int half,
                         float scale, void* stream_ptr) {
  using namespace mb;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = launch_rope((bf16*)qkv, (const float*)cos_t, (const float*)sin_t,
                              (long long)batch * seq, seq, hidden, stream);
  if (e != cudaSuccess) return e;
  return launch_attention_mb((const bf16*)qkv, (const float*)key_bias, (bf16*)out, batch, seq,
                             hidden, heads, half, scale, stream);
}

// y bf16 [M, H] = LN(x) * scale of f32 x [M, H] (the final norm), or
// bf16(x) where scale is null.
int modernbert_rownorm(const void* x, const void* scale, void* y, int rows, int hidden, float eps,
                       void* stream_ptr) {
  return mb::launch_rownorm((const float*)x, (const float*)scale, (bf16*)y, rows, hidden, eps,
                            reinterpret_cast<cudaStream_t>(stream_ptr));
}

}  // extern "C"
