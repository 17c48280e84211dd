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
#include <cstring>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

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
// One core for every product of the layer, on Hopper's asynchronous
// tensor-core path (wgmma_common.cuh): wgmma.mma_async m64n128k16 (bf16
// in, f32 accumulation) reading both operands from shared memory, fed by
// TMA tile loads into a ring of stages in dynamic shared memory, and
// storing each finished tile by TMA.
//
// What bounds it: the operations (2 M N K at 989 TFLOP/s) for the products
// of B*S in the thousands; then the L2, since a block tile of BM x 128
// reads (BM + 128) * 2 bytes of operands a unit of depth for 2 * BM * 128
// operations (64 a byte at BM = 128, 85 at BM = 256: the tensor cores'
// rate asks about 15 and 12 TB/s of it); then the bytes of the f32 tiles
// some epilogues read or write (gelu', the residual gradient, K5's weight
// gradient partials). The mma.sync core it replaced issued one 16 x 8 x 16
// product a warp from registers that ldmatrix filled (K5's eight dgrad and
// wgrad products at B=512: 4.99 ms on it, 1.41 for cuBLAS's wgmma kernels).
//
// What the design does about it:
// - A block is three warpgroups: one producer, whose one thread issues the
//   TMA loads of each stage (128-byte swizzled boxes) and hands it over on
//   the stage's full mbarrier (expected bytes); and two consumers, 64 * MI
//   rows each, that run 4 * MI wgmma a stage on descriptors into the stage
//   and release it on its empty mbarrier (one arrival a consumer warp) once
//   the products reading it are done, keeping one group of products in
//   flight while they wait for the next stage. setmaxnreg moves registers
//   from the producer (40) to the consumers (232).
// - Persistent: one block an SM (grid min(work, SM count)); block b walks
//   the work items b, b + grid, ... in the order of the grid it replaced
//   (column tile minor, then row tile, then split), so the blocks that run
//   together share A's rows; the producer runs ahead into the next item's
//   stages while the consumers finish the last one.
// - TMA zero-fills reads past the matrix edges and drops stores past them,
//   so N need only be a multiple of 8 (the layer's are multiples of 64,
//   such as 3H = 960 at H = 320) and M anything.
// - Epilogues work on the accumulators in registers (warp w of a consumer
//   holds rows 16 w + g and 16 w + g + 8 of each of its 64-row blocks,
//   columns 8 j + 2 t and 8 j + 2 t + 1: the mma.sync C fragment repeated
//   over the 16 column groups), with the cast points of the mma.sync core,
//   and leave through shared memory (below).
// Tensor maps are made on the host for every launch's pointers and shapes
// (the tensors move from call to call; an encoded map is kept per host
// thread by its key, wgmma_common.cuh) and passed as __grid_constant__
// parameters.
//
// Operand forms (bf16 wgmma takes either major-ness from shared memory, so
// one core serves all three):
//   FORM_XW:  C[M, N] = A[M, K] W, W bf16 [K, N] row-major (forward
//             products); A K-major, B MN-major.
//   FORM_XWT: C[M, N] = A[M, K] W^T, W bf16 [N, K] row-major (dgrad
//             products dY W^T); A and B K-major.
//   FORM_ATB: part[z][M, N] = A[r, M]^T B[r, N] summed over split z's rows
//             r (weight gradients, K = the row count); A and B MN-major.
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

// Block tiles: BM = 128 * MI rows by 128 columns, 64 deep, MI being the
// 64-row wgmma blocks each consumer warpgroup takes. MI = 2 (256 x 128, a
// ring of three 48 KB stages) for the products whose epilogue stores bf16
// alone (K1's four, the same in K5's recompute, and K5's dY Wo^T): a
// 128 x 128 tile reads 64 operations' worth of operands a byte, which at
// the tensor cores' rate asks more of the L2 than it gives, and the
// 256 x 128 tile reads 85. MI = 1 (128 x 128, four 32 KB stages) where the
// epilogue reads or writes f32 tiles (an f32 tile of 256 rows would not fit
// in shared memory beside the ring) and for X^T dY, whose M is a weight's
// rows (384 at MiniLM's width: a 256-row tile would be a quarter empty).
//
// Epilogue through shared memory: the consumers write the finished tile
// into an epilogue buffer in TMA's swizzled layout and one thread stores it
// with TMA, asynchronously, so the store overlaps the next tile's products
// (the buffer is waited for before the next tile writes it). The f32 input
// of an epilogue (gelu', the residual gradient) is loaded into the same
// buffer by the producer, by TMA, while the tile's products run, so the
// epilogue reads it from shared memory.
constexpr int GBN = 128, GBK = 64;
constexpr int GROW_TILE = 128;  // the rows of one column-partial row of EPI_MUL_AUX
constexpr int GEMM_CONSUMERS = 2;  // warpgroups, 64 * MI rows each
constexpr int GEMM_THREADS = 128 * (1 + GEMM_CONSUMERS);
constexpr int GBOX_BYTES = 64 * GBK * 2;  // 64 K-major rows, or one MN-major box
constexpr int GB_BYTES = GBN * GBK * 2;   // B's part of a stage
constexpr int GEMM_PRODUCER_REGS = 40, GEMM_CONSUMER_REGS = 232;

template <int FORM, int EPI>
struct GemmShape {
  static constexpr bool AUX_IN = EPI == EPI_MUL_AUX || EPI == EPI_ADD_AUX_F32 ||
                                 EPI == EPI_ADD_AUX_BF16;
  static constexpr bool OUT_F32 = EPI == EPI_ADD_AUX_F32 || EPI == EPI_PARTIAL;
  static constexpr int MI =
      FORM == FORM_ATB || AUX_IN || OUT_F32 || EPI == EPI_BIAS_GELU_GRAD ? 1 : 2;
  static constexpr int BM = 128 * MI;
  static constexpr int A_BYTES = BM * GBK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + GB_BYTES;
  static constexpr int STAGES = MI == 1 ? 4 : 3;
  static constexpr int OUT_BYTES = BM * GBN * (OUT_F32 ? 4 : 2);
  // gelu' of EPI_BIAS_GELU_GRAD (f32), after C in the buffer; or the f32
  // epilogue input, which the output then overwrites.
  static constexpr int X_BYTES = EPI == EPI_BIAS_GELU_GRAD || AUX_IN ? BM * GBN * 4 : 0;
  static constexpr int EB_BYTES =
      EPI == EPI_BIAS_GELU_GRAD ? OUT_BYTES + X_BYTES : (X_BYTES > OUT_BYTES ? X_BYTES : OUT_BYTES);
  static constexpr int X_OFFSET = EPI == EPI_BIAS_GELU_GRAD ? OUT_BYTES : 0;
  static constexpr int RED_FLOATS = EPI == EPI_MUL_AUX ? 4 * GEMM_CONSUMERS * GBN : 0;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + EB_BYTES +
                                 RED_FLOATS * 4 + GBN * 2 + (2 * STAGES + 2) * sizeof(uint64_t);
};

// The current device's SM count, read once per device (132 on an H100 SXM).
static inline cudaError_t device_sm_count(int* sms) {
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

// Byte offset of tile element (r, c) in the epilogue buffer's boxes of 128
// bytes a row (64 bf16 or 32 f32 columns, BM rows each).
template <int ELEM, int BM>
__device__ __forceinline__ uint32_t eb_offset(int r, int c) {
  constexpr int COLS = 128 / ELEM;
  return (c / COLS) * (BM * 128) + wgc::sw128_offset<ELEM>(r, c % COLS);
}

// FORM_XW / FORM_XWT: A bf16 [M, K], W as the form says. FORM_ATB: A bf16
// [K, M] and W bf16 [K, N] (the row count K split into `splits` ranges of
// rows_per_split, a multiple of GBK, so that no stage reaches into the next
// split's rows; a split past K is empty and stores zeros). Tensor maps
// (launch_gemm): map_a, map_b the operands; map_c the output (3-D [splits,
// M, N] for EPI_PARTIAL); map_x the f32 epilogue input (aux), or gelu'
// (aux_out) of EPI_BIAS_GELU_GRAD.
template <int FORM, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c,
                  const __grid_constant__ CUtensorMap map_x, const bf16* __restrict__ bias,
                  float* __restrict__ aux_out, int M, int N, int K, int rows_per_split,
                  int splits) {
  using G = GemmShape<FORM, EPI>;
  constexpr int MI = G::MI;
  constexpr bool A_MN = FORM == FORM_ATB;
  constexpr bool B_MN = FORM != FORM_XWT;
  constexpr bool HAS_BIAS = EPI == EPI_BIAS || EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* eb = smem + G::STAGES * G::STAGE_BYTES;
  float* red = reinterpret_cast<float*>(eb + G::EB_BYTES);
  uint32_t* bias_sm = reinterpret_cast<uint32_t*>(red + G::RED_FLOATS);  // GBN / 2 pairs
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_sm + GBN / 2);
  uint64_t* empty = full + G::STAGES;
  uint64_t* x_full = empty + G::STAGES;  // the epilogue input has landed
  uint64_t* x_free = x_full + 1;         // the buffer may take the next input

  const int n_tiles = (N + GBN - 1) / GBN;
  const int tiles = ((M + G::BM - 1) / G::BM) * n_tiles;
  const int work = tiles * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      wgc::mbar_init(&full[s], 1);
      wgc::mbar_init(&empty[s], GEMM_CONSUMERS * 4);
    }
    wgc::mbar_init(x_full, 1);
    wgc::mbar_init(x_free, 1);
    wgc::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    wgc::setmaxnreg_dec<GEMM_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      wgc::tma_prefetch(&map_a);
      wgc::tma_prefetch(&map_b);
      int stage = 0;
      uint32_t phase = 0, x_phase = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const int z = w / tiles, t = w % tiles;
        const int row0 = (t / n_tiles) * G::BM, col0 = (t % n_tiles) * GBN;
        const int k_begin = FORM == FORM_ATB ? z * rows_per_split : 0;
        const int k_end = FORM == FORM_ATB ? min(K, k_begin + rows_per_split) : K;
        for (int k0 = k_begin; k0 < k_end; k0 += GBK) {
          wgc::mbar_wait(&empty[stage], phase ^ 1);
          wgc::mbar_arrive_expect_tx(&full[stage], G::STAGE_BYTES);
          unsigned char* As = smem + stage * G::STAGE_BYTES;
          unsigned char* Bs = As + G::A_BYTES;
          if (A_MN) {
#pragma unroll
            for (int b = 0; b < G::BM / 64; ++b)
              wgc::tma_load_2d(As + b * GBOX_BYTES, &map_a, &full[stage], row0 + 64 * b, k0);
          } else {
            wgc::tma_load_2d(As, &map_a, &full[stage], k0, row0);
          }
          if (B_MN) {
            wgc::tma_load_2d(Bs, &map_b, &full[stage], col0, k0);
            wgc::tma_load_2d(Bs + GBOX_BYTES, &map_b, &full[stage], col0 + 64, k0);
          } else {
            wgc::tma_load_2d(Bs, &map_b, &full[stage], k0, col0);
          }
          if (++stage == G::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (G::AUX_IN) {  // the tile's f32 epilogue input, once the last tile's store has read the buffer
          wgc::mbar_wait(x_free, x_phase ^ 1);
          wgc::mbar_arrive_expect_tx(x_full, G::X_BYTES);
#pragma unroll
          for (int b = 0; b < GBN / 32; ++b)
            wgc::tma_load_2d(eb + b * G::BM * 128, &map_x, x_full, col0 + 32 * b, row0);
          x_phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 * MI rows each
    wgc::setmaxnreg_inc<GEMM_CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cwg = ct >> 7;
    const int warp4 = (ct >> 5) & 3;
    const int lane = ct & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    // 64-row block i of this warpgroup: 64 K-major rows of 128 bytes, or
    // one MN-major box: 8192 bytes in either form.
    const uint32_t a_off = cwg * MI * GBOX_BYTES;
    constexpr uint32_t A_STEP = A_MN ? 2048 : 32, B_STEP = B_MN ? 2048 : 32;
    constexpr uint32_t A_LBO = A_MN ? GBOX_BYTES : 16, B_LBO = B_MN ? GBOX_BYTES : 16;
    const uint32_t ring = wgc::smem_u32(smem);
    int stage = 0;
    uint32_t phase = 0, x_phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int z = w / tiles, t = w % tiles;
      const int row0 = (t / n_tiles) * G::BM, col0 = (t % n_tiles) * GBN;
      const int k_begin = FORM == FORM_ATB ? z * rows_per_split : 0;
      const int k_end = FORM == FORM_ATB ? min(K, k_begin + rows_per_split) : K;

      // The tile's 64 bias pairs, one a thread of the first 64, loaded ahead
      // of the products and put in shared memory after them.
      uint32_t bias_pair = 0;
      if (HAS_BIAS && bias != nullptr && ct < GBN / 2 && col0 + 2 * ct < N)
        bias_pair = *reinterpret_cast<const uint32_t*>(bias + col0 + 2 * ct);

      float acc[MI][64];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[i][e] = 0.0f;
      int prev = -1;
      for (int k0 = k_begin; k0 < k_end; k0 += GBK) {
        wgc::mbar_wait(&full[stage], phase);
        const uint32_t a_base = ring + stage * G::STAGE_BYTES + a_off;
        const uint32_t b_base = ring + stage * G::STAGE_BYTES + G::A_BYTES;
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 64; ++e) wgc::fence_operand(acc[i][e]);
        wgc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GBK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < MI; ++i)
            wgc::wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(
                acc[i], wgc::sw128_desc(a_base + i * GBOX_BYTES + kk * A_STEP, A_LBO, 1024),
                wgc::sw128_desc(b_base + kk * B_STEP, B_LBO, 1024));
        wgc::wgmma_commit();
        wgc::wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int e = 0; e < 64; ++e) wgc::fence_operand(acc[i][e]);
        if (prev >= 0 && lane == 0) wgc::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == G::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgc::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 64; ++e) wgc::fence_operand(acc[i][e]);
      if (prev >= 0 && lane == 0) wgc::mbar_arrive(&empty[prev]);

      // ---- epilogue. Lane (g, tq) of warp warp4 holds tile rows
      // r = (cwg * MI + i) * 64 + warp4 * 16 + g + 8 h, columns 8 j + 2 tq
      // and 8 j + 2 tq + 1 in acc[i][4 j + 2 h] and acc[i][4 j + 2 h + 1].
      // A bf16 output over the f32 input others may still be reading is
      // written in a second pass; every other output as it is computed.
      constexpr bool TWO_PASS = G::AUX_IN && !G::OUT_F32;
      static_assert(!TWO_PASS || MI == 1, "the second pass writes one 64-row block");
      if (G::AUX_IN) {
        wgc::mbar_wait(x_full, x_phase);  // the input has landed (and the buffer is free)
        x_phase ^= 1;
      } else {
        if (HAS_BIAS && ct < GBN / 2) bias_sm[ct] = bias_pair;
        if (ct == 0) wgc::bulk_wait_read<0>();  // the last tile's store has read the buffer
        wgc::named_sync(1, 128 * GEMM_CONSUMERS);
      }
      float colsum[16][2];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        colsum[j][0] = 0.0f;
        colsum[j][1] = 0.0f;
        float2 bb = make_float2(0.0f, 0.0f);
        if (HAS_BIAS)
          bb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bias_sm[4 * j + tq]));
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (cwg * MI + i) * 64 + warp4 * 16 + g + 8 * h;
            const int c = j * 8 + 2 * tq;
            float v0 = acc[i][4 * j + 2 * h], v1 = acc[i][4 * j + 2 * h + 1];
            if (HAS_BIAS) {
              v0 += bb.x;
              v1 += bb.y;
            }
            if (EPI == EPI_BIAS_GELU_GRAD)
              *reinterpret_cast<float2*>(eb + G::X_OFFSET + eb_offset<4, G::BM>(r, c)) =
                  make_float2(gelu_erf_grad(v0), gelu_erf_grad(v1));
            if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_GRAD) {
              v0 = gelu_erf(v0);
              v1 = gelu_erf(v1);
            }
            if (G::AUX_IN) {
              const float2 a = *reinterpret_cast<const float2*>(eb + eb_offset<4, G::BM>(r, c));
              if (EPI == EPI_MUL_AUX) {
                v0 *= a.x;
                v1 *= a.y;
                colsum[j][0] += v0;
                colsum[j][1] += v1;
              } else {
                v0 += a.x;
                v1 += a.y;
              }
            }
            if (TWO_PASS) {
              acc[i][4 * j + 2 * h] = v0;
              acc[i][4 * j + 2 * h + 1] = v1;
            } else if (G::OUT_F32) {
              *reinterpret_cast<float2*>(eb + eb_offset<4, G::BM>(r, c)) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(eb + eb_offset<2, G::BM>(r, c)) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
      }
      if (TWO_PASS) {
        wgc::named_sync(1, 128 * GEMM_CONSUMERS);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = cwg * 64 + warp4 * 16 + g + 8 * h;  // MI == 1
            *reinterpret_cast<__nv_bfloat162*>(eb + eb_offset<2, G::BM>(r, j * 8 + 2 * tq)) =
                __floats2bfloat162_rn(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]);
          }
      }
      wgc::fence_proxy_async();
      wgc::named_sync(1, 128 * GEMM_CONSUMERS);
      if (ct == 0) {
        constexpr int OUT_COLS = G::OUT_F32 ? 32 : 64;
#pragma unroll
        for (int b = 0; b < GBN / OUT_COLS; ++b) {
          if (EPI == EPI_PARTIAL)
            wgc::tma_store_3d(&map_c, eb + b * G::BM * 128, col0 + OUT_COLS * b, row0, z);
          else
            wgc::tma_store_2d(&map_c, eb + b * G::BM * 128, col0 + OUT_COLS * b, row0);
        }
        if (EPI == EPI_BIAS_GELU_GRAD) {
#pragma unroll
          for (int b = 0; b < GBN / 32; ++b)
            wgc::tma_store_2d(&map_x, eb + G::X_OFFSET + b * G::BM * 128, col0 + 32 * b, row0);
        }
        wgc::bulk_commit();
        if (G::AUX_IN) {  // the producer loads the next input into the buffer
          wgc::bulk_wait_read<0>();
          wgc::mbar_arrive(x_free);
        }
      }
      if (EPI == EPI_MUL_AUX) {
        // Column sums of the f32 products over the tile's 128 rows, in a
        // fixed order: each lane's two rows, then the 8 lanes of a column
        // (g), then the tile's 8 warps in row order; one partial row per
        // 128 rows, reduced by colsum_kernel. (Rows past M hold zeros: A
        // and the input read zeros there.)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = colsum[j][e];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            colsum[j][e] = v;
          }
        const int rw = cwg * 4 + warp4;
        if (g == 0) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            red[rw * GBN + j * 8 + 2 * tq] = colsum[j][0];
            red[rw * GBN + j * 8 + 2 * tq + 1] = colsum[j][1];
          }
        }
        wgc::named_sync(2, 128 * GEMM_CONSUMERS);
        if (ct < GBN && col0 + ct < N) {
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < 4 * GEMM_CONSUMERS; ++r) v += red[r * GBN + ct];
          aux_out[(size_t)(row0 / GROW_TILE) * N + col0 + ct] = v;
        }
        wgc::named_sync(2, 128 * GEMM_CONSUMERS);  // red is free for the next tile
      }
    }
    if (ct == 0) wgc::bulk_wait<0>();  // the last stores are done before the block exits
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
  using G = GemmShape<FORM, EPI>;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(gemm_wgmma_kernel<FORM, EPI>, G::SMEM, done);
  if (e != cudaSuccess) return e;
  if (FORM == FORM_ATB && (rows_per_split <= 0 || rows_per_split % GBK)) return cudaErrorInvalidValue;
  int sms = 0;
  e = device_sm_count(&sms);
  if (e != cudaSuccess) return e;
  CUtensorMap map_a, map_b, map_c, map_x;
  memset(&map_x, 0, sizeof(map_x));
  e = FORM == FORM_ATB ? wgc::encode_2d(&map_a, A, false, M, K, 64, GBK)
                       : wgc::encode_2d(&map_a, A, false, K, M, GBK, G::BM);
  if (e != cudaSuccess) return e;
  e = FORM == FORM_XWT ? wgc::encode_2d(&map_b, W, false, K, N, GBK, GBN)
                       : wgc::encode_2d(&map_b, W, false, N, K, 64, GBK);
  if (e != cudaSuccess) return e;
  if (EPI == EPI_PARTIAL) {  // [splits, M, N]: a box never crosses into the next split
    const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)M, (cuuint64_t)splits};
    const cuuint64_t strides[2] = {(cuuint64_t)N * 4, (cuuint64_t)M * N * 4};
    const cuuint32_t box[3] = {32, (cuuint32_t)G::BM, 1};
    e = wgc::encode_map(&map_c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, C, dims, strides, box);
  } else {
    e = wgc::encode_2d(&map_c, C, G::OUT_F32, N, M, G::OUT_F32 ? 32 : 64, G::BM);
  }
  if (e != cudaSuccess) return e;
  if (G::AUX_IN) e = wgc::encode_2d(&map_x, aux, true, N, M, 32, G::BM);
  if (EPI == EPI_BIAS_GELU_GRAD) e = wgc::encode_2d(&map_x, aux_out, true, N, M, 32, G::BM);
  if (e != cudaSuccess) return e;
  const int work = ((M + G::BM - 1) / G::BM) * ((N + GBN - 1) / GBN) * splits;
  gemm_wgmma_kernel<FORM, EPI><<<work < sms ? work : sms, GEMM_THREADS, G::SMEM, stream>>>(
      map_a, map_b, map_c, map_x, bias, aux_out, M, N, K, rows_per_split, splits);
  return cudaGetLastError();
}

// Column-partial rows of EPI_MUL_AUX over M rows: one per 128 rows.
__host__ __device__ constexpr int gemm_row_tiles(int M) { return (M + GROW_TILE - 1) / GROW_TILE; }

// ----------------------------------------------------------- attention
// Forward: the attention kernels of mma_common.cuh with the JAX _kernel's
// cast point (P = exp(x - m) rounded to bf16 unnormalised, 1/z applied to
// the f32 P V product), reading q, k and v in place from the packed
// [B * S, 3 H] projection and writing [B * S, H]. One block per (64-query
// tile, head, batch row), 4 warps of 16 query rows. Where the score row fits
// in registers (head_dim HD <= 64 and S <= 256: at most 128 f32 per thread)
// it is computed once, K and V streaming through a two-stage cp.async ring
// of 64-key tiles, and no score touches shared memory. Elsewhere (S > 256,
// or HD 128, whose 64 output registers leave no room for the row) the
// two-pass kernel runs: the exact row max first, then the scores again with
// P V; the same bits as the one-pass form where both apply. K6 takes the
// same rule.
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

// Largest S the forward takes: the tower's position table (max_position
// 512) caps it; the two-pass kernel's key biases, S * 4 bytes of shared
// memory, are what grows with it.
constexpr int MAX_SEQ = 512;

template <int HD>
static cudaError_t launch_attention_two_pass(const bf16* qkv, const float* key_bias, bf16* out,
                                             int batch, int seq, int H, int num_heads,
                                             float scale, cudaStream_t stream) {
  const int n_tiles = (seq + TK - 1) / TK;
  const size_t smem = (size_t)5 * tile_elems<HD>() * 2 + (size_t)(MAX_SEQ / TK) * TK * 4;
  static std::atomic<unsigned long long> done{0};
  cudaError_t e = allow_smem_once(attn_fwd_two_pass_kernel<HD, DIVIDE_AFTER_PV>, smem, done);
  if (e != cudaSuccess) return e;
  const View vqkv{(long long)seq * 3 * H, HD, 3LL * H};
  const View vo{(long long)seq * H, HD, (long long)H};
  dim3 grid(n_tiles, num_heads, batch);
  attn_fwd_two_pass_kernel<HD, DIVIDE_AFTER_PV><<<grid, THREADS, smem, stream>>>(
      qkv, qkv + H, qkv + 2 * H, key_bias, out, vqkv, vqkv, vqkv, vo, seq, scale);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_attention_hd(const bf16* qkv, const float* key_bias, bf16* out,
                                       int batch, int seq, int H, int num_heads, float scale,
                                       cudaStream_t stream) {
  if (seq < 1 || seq > MAX_SEQ) return cudaErrorInvalidValue;
  if constexpr (HD <= 64) {  // the one-pass rule: S <= 256 at HD <= 64
    switch ((seq + TK - 1) / TK) {
      case 1: return launch_attention_nt<HD, 1>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
      case 2: return launch_attention_nt<HD, 2>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
      case 3: return launch_attention_nt<HD, 3>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
      case 4: return launch_attention_nt<HD, 4>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
      default: break;
    }
  }
  return launch_attention_two_pass<HD>(qkv, key_bias, out, batch, seq, H, num_heads, scale,
                                       stream);
}

// The head_dim comes from hidden / num_heads: 16, 32 (MiniLM-class), 64
// (mpnet-base-class) or 128, every head_dim that divides 128 as the JAX
// kernel's gate admits.
static inline cudaError_t launch_attention(const bf16* qkv, const float* key_bias, bf16* out,
                                           int batch, int seq, int H, int num_heads, float scale,
                                           cudaStream_t stream) {
  if (num_heads <= 0 || H % num_heads) return cudaErrorInvalidValue;
  switch (H / num_heads) {
    case 16: return launch_attention_hd<16>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 32: return launch_attention_hd<32>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 64: return launch_attention_hd<64>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    case 128: return launch_attention_hd<128>(qkv, key_bias, out, batch, seq, H, num_heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ residual + LayerNorm
// y = bf16(LN(float(bf16(x + r')))) per row, r' = bf16(r * mask) when a
// dropout mask ({0, 1/keep} in bf16) is given, else r. One warp per row,
// H <= 1024. With r_out (the residual-saving forward), r' is also stored
// there: r_out may be r itself, each element read before the same thread
// writes it.
constexpr int LN_ROWS = 4;
constexpr int LN_MAX_PER_LANE = 32;
constexpr int LN_MAX_H = 32 * LN_MAX_PER_LANE;

__device__ __forceinline__ float masked_residual(const bf16* r, const bf16* mask, size_t idx) {
  const float rv = __bfloat162float(r[idx]);
  return mask != nullptr ? __bfloat162float(__float2bfloat16(rv * __bfloat162float(mask[idx])))
                         : rv;
}

__device__ __forceinline__ float residual_in(const bf16* x, const bf16* r, const bf16* mask,
                                             size_t idx) {
  return __bfloat162float(__float2bfloat16(__bfloat162float(x[idx]) + masked_residual(r, mask, idx)));
}

__global__ void __launch_bounds__(LN_ROWS * 32)
residual_layernorm_kernel(const bf16* __restrict__ x, const bf16* r,
                          const bf16* __restrict__ mask, const float* __restrict__ scale,
                          const float* __restrict__ shift, bf16* __restrict__ y, bf16* r_out,
                          int M, int H, float eps) {
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
      const size_t idx = off + lane + 32 * t;
      const float rm = masked_residual(r, mask, idx);
      if (r_out != nullptr) r_out[idx] = __float2bfloat16(rm);
      v[t] = __bfloat162float(__float2bfloat16(__bfloat162float(x[idx]) + rm));
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
                             cudaStream_t stream, bf16* r_out = nullptr) {
  residual_layernorm_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, stream>>>(
      x, r, mask, s, b, y, r_out, M, H, eps);
  return cudaGetLastError();
}

}  // namespace fl
