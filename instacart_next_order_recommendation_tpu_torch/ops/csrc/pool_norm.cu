// Masked mean pooling over the sequence, then L2 normalisation.
//
// Replaces: the JAX package's ops/pool_norm.py::_pool_kernel (Pallas TPU
// kernel behind masked_mean_pool_l2norm_pallas). Same function:
//   pooled = sum_s(hidden[b, s, :] * mask[b, s]) / max(sum_s mask[b, s], 1e-9)
//   out    = pooled / max(||pooled||_2, 1e-12)            (f32 out)
//
// What bounds it on the H100: bytes. It reads B*S*H hidden values once and
// does one multiply-add per value, far below the card's compute rate.
//
// What the design does about it: one block per batch row; each thread owns
// a few hidden columns and walks the sequence, so consecutive threads read
// consecutive addresses of each row; the squared norm is a block reduction
// in shared memory. The [B, H] pooled vector never leaves the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int POOL_THREADS = 128;

__global__ void __launch_bounds__(POOL_THREADS)
pool_l2norm_kernel(const __nv_bfloat16* __restrict__ hidden, const int* __restrict__ mask,
                   float* __restrict__ out, int S, int H) {
  extern __shared__ float pooled[];  // [H]
  __shared__ float partial[POOL_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int* m = mask + (size_t)b * S;
  const __nv_bfloat16* x = hidden + (size_t)b * S * H;

  float count = 0.0f;
  for (int s = 0; s < S; ++s) count += (m[s] != 0) ? 1.0f : 0.0f;
  count = fmaxf(count, 1e-9f);

  float sq = 0.0f;
  for (int h = tid; h < H; h += POOL_THREADS) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float w = (m[s] != 0) ? 1.0f : 0.0f;
      acc += __bfloat162float(x[(size_t)s * H + h]) * w;
    }
    const float v = acc / count;
    pooled[h] = v;
    sq += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) partial[tid >> 5] = sq;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < POOL_THREADS / 32; ++w) total += partial[w];
  const float norm = fmaxf(sqrtf(total), 1e-12f);
  for (int h = tid; h < H; h += POOL_THREADS) out[(size_t)b * H + h] = pooled[h] / norm;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// hidden [B, S, H] bf16, mask [B, S] int32, out [B, H] f32; all contiguous.
int pool_l2norm(const void* hidden, const void* mask, void* out, int batch, int seq, int hidden_dim,
                void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const size_t smem = (size_t)hidden_dim * sizeof(float);
  pool_l2norm_kernel<<<batch, POOL_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)hidden, (const int*)mask, (float*)out, seq, hidden_dim);
  return cudaGetLastError();
}

}  // extern "C"
