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
// - Attention, one block per (64-query tile, head, batch row), online
//   softmax over 64-key tiles that stream through a two-stage cp.async ring
//   (mma.sync products of mma_common.cuh); the banded form schedules only
//   the key tiles that meet the band (three of them at half 64), so its
//   work grows as S, not S^2. The global and banded forms are two kernels,
//   mb_attn_global_kernel and mb_attn_band_kernel, so a trace tells them
//   apart.
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

// ------------------------------------------------------------- attention
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
mb_attn_global_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                      bf16* __restrict__ out, int S, int H, float scale) {
  attn_body<false>(qkv, key_bias, out, S, H, 0, scale);
}

__global__ void __launch_bounds__(THREADS)
mb_attn_band_kernel(const bf16* __restrict__ qkv, const float* __restrict__ key_bias,
                    bf16* __restrict__ out, int S, int H, int half, float scale) {
  attn_body<true>(qkv, key_bias, out, S, H, half, scale);
}

static cudaError_t launch_attention_mb(const bf16* qkv, const float* key_bias, bf16* out,
                                       int batch, int seq, int H, int heads, int half,
                                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)5 * tile_elems<HD>() * 2;  // Q and two stages of (K, V)
  const dim3 grid((seq + TQ - 1) / TQ, heads, batch);
  if (half < 0) {
    mb_attn_global_kernel<<<grid, THREADS, smem, stream>>>(qkv, key_bias, out, seq, H, scale);
  } else {
    mb_attn_band_kernel<<<grid, THREADS, smem, stream>>>(qkv, key_bias, out, seq, H, half,
                                                         scale);
  }
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
