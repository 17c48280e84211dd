// Cosine top-k over a catalog block, f32, for Hopper: exact, or on packed
// 20-bit keys.
//
// Replaces: the JAX package's ops/topk.py::_topk_block_kernel (K3) and
// ::_topk_block_kernel_packed (K4), the Pallas TPU kernels behind
// cosine_topk_pallas. Same function per catalog block: exact f32 dot
// products (no TF32), rows at or past n_valid and rows whose candidate mask
// is 0 set to -1e30, then the block's top-k with ties broken to the lowest
// index. K4 ranks each score by its packed int32 key instead: the top 20
// bits of the order-preserving bit pattern, 0xFFF - column in the low 12,
// and returns the score the quantized key stands for. The caller merges the
// [B, n_blocks * k] candidates, laid out block-major per query, with a
// stable descending sort, so ties across blocks also go to the lowest index.
//
// What bounds it on the H100: the f32 dot products, 2*B*N*D operations
// against 67 TFLOP/s of f32 FMA, at serve batches; at B=1 the catalog read,
// N*D*4 bytes against 3.35 TB/s.
//
// What the design does about it: a block owns 256 catalog rows and a tile
// of TQ queries (64, or 8 for small batches), so the catalog is read
// ceil(B / TQ) times per call, not once per query. The [TQ, 256] score tile
// stays in shared memory; each warp then sorts one query's 256 scores as
// 64-bit keys (order-preserving score bits, then the inverted column) with
// a bitonic network and writes the first k. The sort costs the same for
// every k <= 256, unlike the TPU kernel's k rounds of max extraction. K4
// sorts its packed keys, unique per column, as 32-bit keys: half the shared
// memory traffic of K3's 64-bit keys, and the TPU kernel's single integer
// comparison per step (value and column at once).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 256;       // catalog rows per block; k <= BN
constexpr int DK = 16;        // feature chunk staged in shared memory
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__host__ __device__ constexpr size_t topk_smem_bytes(int tq, int key_bytes) {
  // Phase 1 stages Q and C chunks; phase 2 reuses that space for the score
  // tile. Per-warp sort keys follow.
  return ((size_t)(tq + BN) * (DK + 1) * 4 > (size_t)tq * BN * 4
              ? (size_t)(tq + BN) * (DK + 1) * 4
              : (size_t)tq * BN * 4) +
         (size_t)WARPS * BN * key_bytes;
}

__device__ __forceinline__ uint32_t order_bits(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The JAX kernel's packed key: sortable = bits < 0 ? ~bits ^ sign : bits
// (signed order), top 20 bits kept, 0xFFF - column below; flipping the sign
// bit turns the signed order into the unsigned one the sort compares.
__device__ __forceinline__ uint32_t packed_key(float s, int col) {
  const uint32_t bits = __float_as_uint(s);
  const uint32_t sortable = (bits & 0x80000000u) ? (~bits) ^ 0x80000000u : bits;
  return ((sortable & ~0xFFFu) | (0xFFFu - (uint32_t)col)) ^ 0x80000000u;
}

// The score a quantized key stands for (the JAX kernel's s_bits).
__device__ __forceinline__ float packed_score(uint32_t key) {
  const uint32_t q = (key ^ 0x80000000u) & ~0xFFFu;
  return __uint_as_float((q & 0x80000000u) ? ~(q ^ 0x80000000u) : q);
}

template <int TQ, bool PACKED>
__global__ void __launch_bounds__(THREADS)
topk_block_kernel(const float* __restrict__ Q, const float* __restrict__ C,
                  const int* __restrict__ mask, float* __restrict__ cand_s,
                  int* __restrict__ cand_i, int B, int N, int D, int n_valid, int k,
                  int n_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int QPT = TQ / WARPS;  // query rows per thread
  const int blk = blockIdx.x;
  const int q0 = blockIdx.y * TQ;
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;

  float* Qs = reinterpret_cast<float*>(smem);  // [TQ][DK + 1]
  float* Cs = Qs + TQ * (DK + 1);              // [BN][DK + 1]

  float acc[QPT][BN / 32];
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int i = tid; i < TQ * DK; i += THREADS) {
      const int r = i / DK, c = i % DK;
      const int q = q0 + r;
      Qs[r * (DK + 1) + c] = q < B ? Q[(size_t)q * D + d0 + c] : 0.0f;
    }
    for (int i = tid; i < BN * DK; i += THREADS) {
      const int r = i / DK, c = i % DK;
      const int g = blk * BN + r;
      Cs[r * (DK + 1) + c] = g < N ? C[(size_t)g * D + d0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DK; ++c) {
      float a[QPT], bv[BN / 32];
#pragma unroll
      for (int i = 0; i < QPT; ++i) a[i] = Qs[(ty + WARPS * i) * (DK + 1) + c];
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) bv[j] = Cs[(tx + 32 * j) * (DK + 1) + c];
#pragma unroll
      for (int i = 0; i < QPT; ++i)
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* Sc = reinterpret_cast<float*>(smem);  // [TQ][BN], over the staging space
#pragma unroll
  for (int i = 0; i < QPT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) Sc[(ty + WARPS * i) * BN + tx + 32 * j] = acc[i][j];
  __syncthreads();

  using Key = typename std::conditional<PACKED, uint32_t, unsigned long long>::type;
  const size_t keys_off = topk_smem_bytes(TQ, sizeof(Key)) - (size_t)WARPS * BN * sizeof(Key);
  Key* keys = reinterpret_cast<Key*>(smem + keys_off) + ty * BN;

  for (int r = ty; r < TQ; r += WARPS) {
    const int q = q0 + r;
    if (q >= B) break;  // warp-uniform
    for (int c = tx; c < BN; c += 32) {
      const int g = blk * BN + c;
      float s = Sc[r * BN + c];
      const bool ok = g < n_valid && g < N && (mask == nullptr || mask[g] != 0);
      if (!ok) s = NEG_INF;
      if constexpr (PACKED) {
        keys[c] = packed_key(s, c);
      } else {
        if (s == 0.0f) s = 0.0f;  // one key for +0 and -0
        keys[c] = ((unsigned long long)order_bits(s) << 32) | (uint32_t)(BN - 1 - c);
      }
    }
    __syncwarp();
    // Bitonic sort, descending; keys are unique (they carry the column).
    for (int size = 2; size <= BN; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tx; i < BN; i += 32) {
          const int j = i ^ stride;
          if (j > i) {
            const Key a = keys[i], b = keys[j];
            const bool desc = (i & size) == 0;
            if (desc ? (a < b) : (a > b)) {
              keys[i] = b;
              keys[j] = a;
            }
          }
        }
        __syncwarp();
      }
    }
    const size_t o = ((size_t)q * n_blocks + blk) * k;
    for (int t = tx; t < k; t += 32) {
      const Key key = keys[t];
      if constexpr (PACKED) {
        cand_s[o + t] = packed_score(key);
        cand_i[o + t] = blk * BN + (int)(0xFFFu - ((key ^ 0x80000000u) & 0xFFFu));
      } else {
        cand_s[o + t] = from_order_bits((uint32_t)(key >> 32));
        cand_i[o + t] = blk * BN + (BN - 1 - (int)(key & 0xffffffffu));
      }
    }
    __syncwarp();
  }
}

template <int TQ, bool PACKED>
cudaError_t launch(const float* Q, const float* C, const int* mask, float* cand_s, int* cand_i,
                   int B, int N, int D, int n_valid, int k, cudaStream_t stream) {
  const int n_blocks = (N + BN - 1) / BN;
  const size_t smem = topk_smem_bytes(TQ, PACKED ? 4 : 8);
  cudaError_t e = cudaFuncSetAttribute(topk_block_kernel<TQ, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_blocks, (B + TQ - 1) / TQ);
  topk_block_kernel<TQ, PACKED><<<grid, THREADS, smem, stream>>>(Q, C, mask, cand_s, cand_i, B,
                                                                 N, D, n_valid, k, n_blocks);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_for_batch(const void* Q, const void* C, const void* mask, void* cand_s,
                             void* cand_i, int B, int N, int D, int n_valid, int k,
                             cudaStream_t stream) {
  if (B <= 8)
    return launch<8, PACKED>((const float*)Q, (const float*)C, (const int*)mask, (float*)cand_s,
                             (int*)cand_i, B, N, D, n_valid, k, stream);
  return launch<64, PACKED>((const float*)Q, (const float*)C, (const int*)mask, (float*)cand_s,
                            (int*)cand_i, B, N, D, n_valid, k, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// queries [B, D] f32, catalog [N, D] f32, mask [N] int32 or null,
// cand_s / cand_i [B, ceil(N / 256) * k]; D % 16 == 0, 1 <= k <= 256.
// packed != 0 ranks by the 20-bit packed keys (K4), else exactly (K3).
int topk_blocks(const void* queries, const void* catalog, const void* mask, void* cand_s,
                void* cand_i, int batch, int n_rows, int dim, int n_valid, int k, int packed,
                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (packed)
    return launch_for_batch<true>(queries, catalog, mask, cand_s, cand_i, batch, n_rows, dim,
                                  n_valid, k, stream);
  return launch_for_batch<false>(queries, catalog, mask, cand_s, cand_i, batch, n_rows, dim,
                                 n_valid, k, stream);
}

}  // extern "C"
