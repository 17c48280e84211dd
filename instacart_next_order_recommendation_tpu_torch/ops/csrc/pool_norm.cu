// Masked mean pooling over the sequence, then L2 normalisation (K2).
//
// Replaces: the JAX package's ops/pool_norm.py:34 _pool_kernel (the Pallas
// TPU kernel behind masked_mean_pool_l2norm_pallas). Same function:
//   pooled = sum_s(hidden[b, s, :] * mask[b, s]) / max(sum_s mask[b, s], 1e-9)
//   out    = pooled / max(||pooled||_2, 1e-12)                 (f32 out)
// Every position is read and multiplied by its mask weight, as the plain
// version does, so a NaN or Inf under a zero weight reaches its row.
//
// What bounds it on the H100: bytes. It reads B*S*H bf16 values once and
// does one multiply-add per value (one flop a byte), far below the ridge.
//
// What the design does about it:
// - Streaming: each thread loads 16 bytes (8 bf16) of a token row at a
//   time, neighbouring threads neighbouring chunks of the row, and keeps
//   ROWS token rows in flight with an f32 accumulator set each, so every
//   SM has tens of KB of loads outstanding. The mask is staged in shared
//   memory as f32 weights once per block (per 2048 positions), and the
//   count is taken from it there. The row lanes' partial sums meet in
//   shared memory and are added in a fixed order, and the norm is taken in
//   the same launch: the pooled vector never goes to device memory.
// - Cluster form, where the batch does not fill the card: a batch row's S
//   is split over the blocks of a thread-block cluster (2, 4 or 8). Each
//   block sums its rows; rank 0 adds the blocks' column sums and counts in
//   rank order through distributed shared memory and normalises. Still one
//   launch, with no second pass and no atomics, so two launches on the same
//   input are bitwise equal.
// - H % 8 != 0, or rows not 16-byte aligned: the same kernel on 2-byte
//   loads, with 8 token rows in flight.
// ops/pool_norm.py's pool_plan picks the cluster size, the warps and ROWS
// from the shape; the entry point refuses any other form.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_WARPS = 16;
constexpr int MASK_TILE = 2048;  // token positions whose weights a block stages at once
constexpr int MAX_H = 12288;

// How a block's threads cover a token row: one VEC-wide chunk per thread,
// `per_pass` chunk lanes side by side, `rows` row lanes each taking every
// rows-th token row, and `passes` over the columns where a row has more
// chunks than the block has threads.
struct Lanes {
  int chunks, per_pass, rows, passes, stride;  // stride: floats per row lane's sums
};

__host__ __device__ inline Lanes lanes_of(int h, int vec, int threads) {
  Lanes l;
  l.chunks = (h + vec - 1) / vec;
  l.per_pass = l.chunks < threads ? l.chunks : threads;
  l.rows = threads / l.per_pass;
  l.passes = (l.chunks + l.per_pass - 1) / l.per_pass;
  l.stride = l.passes * l.per_pass * vec;
  return l;
}

__host__ __device__ inline size_t smem_bytes(Lanes l) {
  return ((size_t)l.rows * l.stride + MASK_TILE + 64) * sizeof(float);
}

// bf16 -> f32 is a 16-bit shift: exact, NaN and Inf kept.
__device__ __forceinline__ float lo_bf16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

template <int VEC>
struct Chunk;

template <>
struct Chunk<8> {  // 16 bytes
  using T = uint4;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void fma(float* acc, T v, float w) {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(lo_bf16(words[i]), w, acc[2 * i]);
      acc[2 * i + 1] = fmaf(hi_bf16(words[i]), w, acc[2 * i + 1]);
    }
  }
};

template <>
struct Chunk<1> {  // 2 bytes
  using T = unsigned short;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ void fma(float* acc, T v, float w) {
    acc[0] = fmaf(lo_bf16(v), w, acc[0]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid: B blocks, or B clusters of CLUSTER-form blocks (rank = the S chunk).
// hidden [B, S, H] bf16, mask [B, S] int32, out [B, H] f32. A block takes
// token rows [rank * chunk, min(S, (rank + 1) * chunk)).
template <int VEC, int ROWS, bool CLUSTER>
__global__ void __launch_bounds__(MAX_WARPS * 32)
pool_l2norm_kernel(const __nv_bfloat16* __restrict__ hidden, const int* __restrict__ mask,
                   float* __restrict__ out, int S, int H, int chunk) {
  extern __shared__ float smem[];
  const Lanes L = lanes_of(H, VEC, blockDim.x);
  float* red = smem;                      // [L.rows][L.stride]: each row lane's column sums
  float* wts = red + L.rows * L.stride;   // [MASK_TILE]: a tile's mask weights
  float* scratch = wts + MASK_TILE;       // [0, 32): per-warp sums; [32]: the block's count

  int b = blockIdx.x, rank = 0;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    b = blockIdx.x / (int)cluster.num_blocks();
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_lane = tid % L.per_pass, r_lane = tid / L.per_pass;
  const int step = L.rows * ROWS;
  const int s_begin = min(S, rank * chunk), s_end = min(S, s_begin + chunk);
  const __nv_bfloat16* x = hidden + (size_t)b * S * H;
  const int* m = mask + (size_t)b * S;

  float count = 0.0f;  // warp 0's running sum of the weights
  bool first = true;   // an empty range still writes its (zero) sums
  for (int t0 = s_begin; first || t0 < s_end; t0 += MASK_TILE, first = false) {
    const int t1 = min(s_end, t0 + MASK_TILE);
    __syncthreads();  // the previous tile's weights are consumed
    for (int i = tid; i < t1 - t0; i += blockDim.x) wts[i] = (float)m[t0 + i];
    __syncthreads();
    if (warp == 0) {
      float c = 0.0f;
      for (int i = lane; i < t1 - t0; i += 32) c += wts[i];
      count += warp_sum(c);
    }
    for (int p = 0; p < L.passes; ++p) {
      const int cc = p * L.per_pass + c_lane;
      if (r_lane >= L.rows || cc >= L.chunks) continue;
      float acc[ROWS][VEC];
#pragma unroll
      for (int u = 0; u < ROWS; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[u][j] = 0.0f;
      const __nv_bfloat16* col = x + (size_t)cc * VEC;
      for (int s = t0 + r_lane; s < t1; s += step) {
        typename Chunk<VEC>::T v[ROWS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int su = s + u * L.rows;
          if (su < t1) v[u] = Chunk<VEC>::load(col + (size_t)su * H);
        }
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
          const int su = s + u * L.rows;
          if (su < t1) Chunk<VEC>::fma(acc[u], v[u], wts[su - t0]);
        }
      }
      float* dst = red + r_lane * L.stride + cc * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = acc[0][j];
#pragma unroll
        for (int u = 1; u < ROWS; ++u) v += acc[u][j];
        dst[j] = first ? v : dst[j] + v;
      }
    }
  }
  if (tid == 0) scratch[32] = count;
  __syncthreads();
  for (int c = tid; c < H; c += blockDim.x) {  // the row lanes' sums, in row-lane order
    float v = red[c];
    for (int r = 1; r < L.rows; ++r) v += red[r * L.stride + c];
    red[c] = v;
  }

  // Each thread goes on with the columns it summed: no barrier is needed
  // inside a block from here to the norm.
  float cnt = 0.0f;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's column sums and count are in its shared memory
    if (rank == 0) {
      const int n = (int)cluster.num_blocks();
      cnt = scratch[32];
      for (int k = 1; k < n; ++k) cnt += *cluster.map_shared_rank(scratch + 32, k);
      for (int c = tid; c < H; c += blockDim.x) {  // the blocks' sums, in rank order
        float v = red[c];
        for (int k = 1; k < n; ++k) v += cluster.map_shared_rank(red, k)[c];
        red[c] = v;
      }
    }
    cluster.sync();  // rank 0 has read the other blocks' shared memory
    if (rank != 0) return;
  } else {
    cnt = scratch[32];
  }

  // The clamps keep a NaN, as the plain version's clamp_min does (fmaxf
  // would drop it): a NaN or Inf under a zero weight makes its row NaN.
  cnt = cnt < 1e-9f ? 1e-9f : cnt;
  float sq = 0.0f;
  for (int c = tid; c < H; c += blockDim.x) {
    const float v = red[c] / cnt;
    red[c] = v;
    sq += v * v;
  }
  sq = warp_sum(sq);
  if (lane == 0) scratch[warp] = sq;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  float norm = sqrtf(total);
  norm = norm < 1e-12f ? 1e-12f : norm;
  for (int c = tid; c < H; c += blockDim.x) out[(size_t)b * H + c] = red[c] / norm;
}

template <int VEC, int ROWS, bool CLUSTER>
cudaError_t launch(const void* hidden, const void* mask, void* out, int batch, int seq, int h,
                   int cluster, int warps, int chunk, cudaStream_t stream) {
  const int threads = warps * 32;
  const size_t smem = smem_bytes(lanes_of(h, VEC, threads));
  auto kernel = pool_l2norm_kernel<VEC, ROWS, CLUSTER>;
  // This instance's dynamic shared memory limit so far. Several host threads
  // may launch at once, so it is read and raised under a lock, which only a
  // block above the default 48 KB takes.
  static std::mutex opt_in_mu;
  static size_t opted_in = 48 * 1024;
  if (smem > 48 * 1024) {
    std::lock_guard<std::mutex> hold(opt_in_mu);
    if (smem > opted_in) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      opted_in = smem;
    }
  }
  const auto* x = static_cast<const __nv_bfloat16*>(hidden);
  const auto* m = static_cast<const int*>(mask);
  auto* y = static_cast<float*>(out);
  if constexpr (CLUSTER) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)batch * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, m, y, seq, h, chunk);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<batch, threads, smem, stream>>>(x, m, y, seq, h, chunk);
  }
  return cudaGetLastError();
}

template <int VEC, int ROWS>
cudaError_t launch_rows(const void* hidden, const void* mask, void* out, int batch, int seq,
                        int h, int cluster, int warps, int chunk, cudaStream_t stream) {
  if (cluster == 1)
    return launch<VEC, ROWS, false>(hidden, mask, out, batch, seq, h, 1, warps, chunk, stream);
  return launch<VEC, ROWS, true>(hidden, mask, out, batch, seq, h, cluster, warps, chunk, stream);
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// hidden [B, S, H] bf16, mask [B, S] int32, out [B, H] f32; all contiguous.
// vec: 8 (H % 8 == 0, rows 16-byte aligned) or 1. cluster: 1, 2, 4 or 8
// blocks per batch row, each taking `chunk` token rows (chunk * cluster >=
// S). warps: 1-16 per block. rows: token rows in flight per thread with
// 16-byte loads, 2 or 4; the 2-byte loads always keep 8.
int pool_l2norm(const void* hidden, const void* mask, void* out, int batch, int seq, int hidden_dim,
                int vec, int cluster, int warps, int rows, int chunk, void* stream_ptr) {
  const bool ok = batch >= 1 && seq >= 0 && hidden_dim >= 1 && hidden_dim <= MAX_H &&
                  (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) && warps >= 1 &&
                  warps <= MAX_WARPS && (rows == 2 || rows == 4) && chunk >= 1 &&
                  (long long)chunk * cluster >= seq &&
                  (vec == 1 || (vec == 8 && hidden_dim % 8 == 0));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (vec == 1)
    return (int)launch_rows<1, 8>(hidden, mask, out, batch, seq, hidden_dim, cluster, warps, chunk,
                                  stream);
  if (rows == 2)
    return (int)launch_rows<8, 2>(hidden, mask, out, batch, seq, hidden_dim, cluster, warps, chunk,
                                  stream);
  return (int)launch_rows<8, 4>(hidden, mask, out, batch, seq, hidden_dim, cluster, warps, chunk,
                                stream);
}

}  // extern "C"
