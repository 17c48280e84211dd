// Hopper's asynchronous building blocks for the fused layer's GEMM core
// (fused_layer_common.cuh): PTX wrappers for mbarriers, TMA tile loads
// (cp.async.bulk.tensor), wgmma.mma_async (m64n128k16, bf16 in, f32
// accumulation, both operands in shared memory), its shared-memory matrix
// descriptors for 128-byte swizzled tiles, TMA stores and bulk groups,
// setmaxnreg and named barriers; and, on the host, the tensor maps TMA
// reads and writes through, encoded by the CUDA driver's cuTensorMapEncodeTiled
// (reached through the runtime, so the libraries link no libcuda) and kept
// per host thread. wgmma and setmaxnreg exist only for sm_90a.
//
// Tiles: every operand tile in shared memory is a run of 128-byte rows in
// TMA's 128-byte swizzle (16-byte chunk c of row r stored at chunk c ^ (r %
// 8)), each 8-row group 1024 bytes, every tile 1024-byte aligned, so that a
// wgmma descriptor of layout "128B" reads exactly what TMA wrote:
//   K-major (the depth contiguous: X [M, K], W^T's W [N, K]): one box of
//     64 depth values by up to 256 rows; 8-row groups 1024 bytes apart
//     (SBO); a 16-deep step is 32 bytes further along the row.
//   MN-major (the rows contiguous: W [K, N], X^T's X [K, M]): boxes of 64
//     rows (128 bytes) by 64 depth values, one per 64 of the tile's rows,
//     8192 bytes apart (LBO); 8-deep groups 1024 bytes apart (SBO); a
//     16-deep step is 2048 bytes further.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <unordered_map>

namespace wgc {

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so parity 1 passes at once: the previous phase counts as
// done).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at (c0 inner, c1 outer) of a 2-D map into shared memory at dst,
// completing `bar`'s transactions; out-of-bounds elements land as zeros
// (and count towards the bytes all the same).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The shared tile at src into the box at (c0, c1) of a 2-D map (c2 the
// third coordinate of a 3-D one), as one bulk-async group of the issuing
// thread; the parts of the box past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until at most N of this thread's store groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy (a
// TMA store that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (r, c) in a 128-byte swizzled box whose rows are
// 128 bytes (64 bf16 or 32 f32): TMA's layout, 16-byte chunk c / (16 /
// elem) of row r stored at chunk (c / (16 / elem)) ^ (r % 8).
template <int ELEM>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  constexpr int PER_CHUNK = 16 / ELEM;
  return r * 128 + ((((c / PER_CHUNK) ^ (r & 7)) & 7) * 16) + (c % PER_CHUNK) * ELEM;
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
// (SWIZZLE_128B on sm_90), base offset 0 (every atom 1024-byte aligned).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x 128] += A[64 x 16] B[16 x 128] for one warpgroup, A and B by
// descriptor; TA / TB: 1 where that operand is MN-major. Accumulator
// layout: warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8 (g =
// lane / 4), d[4 j + 2 h + e] at row 16 w + g + 8 h, column 8 j + 2 (lane %
// 4) + e: the mma.sync m16n8 C fragment repeated over the 16 column groups.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ------------------------------------------------- registers, barriers

// Per-warpgroup register limits (all four warps of the warpgroup execute
// it): the producer gives registers back, the consumers take them.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------- host side

// The CUDA driver's cuTensorMapEncodeTiled, looked up once per library.
static inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// What a tensor map encodes: equal keys give equal maps.
struct MapKey {
  CUtensorMapDataType type;
  int rank;
  const void* base;
  cuuint64_t dims[3];
  cuuint64_t strides[2];
  cuuint32_t box[3];
};

struct MapKeyOps {
  size_t operator()(const MapKey& k) const {  // FNV-1a over the key's bytes
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    size_t h = 1469598103934665603ull;
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ p[i]) * 1099511628211ull;
    return h;
  }
  bool operator()(const MapKey& a, const MapKey& b) const {
    return memcmp(&a, &b, sizeof(MapKey)) == 0;
  }
};

// A row-major matrix of `rank` dimensions (dims innermost first, the
// innermost contiguous; byte strides of the outer ones, multiples of 16;
// base 16-byte aligned), read or written in boxes of `box` elements with
// the 128-byte swizzle (box[0] * element size == 128). Reads past an edge
// are zero; stores past one are dropped. Encoded maps are kept per host
// thread, keyed by every argument: the CUDA driver's encode costs microseconds,
// and a training step launches hundreds of products whose weights, and
// mostly whose activations (PyTorch's allocator hands the same blocks
// back), come again every step.
static inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
                                     const void* base, const cuuint64_t* dims,
                                     const cuuint64_t* strides, const cuuint32_t* box) {
  MapKey key;
  memset(&key, 0, sizeof(key));  // the padding too: keys compare as bytes
  key.type = type;
  key.rank = rank;
  key.base = base;
  for (int d = 0; d < rank; ++d) {
    key.dims[d] = dims[d];
    key.box[d] = box[d];
    if (d + 1 < rank) key.strides[d] = strides[d];
  }
  thread_local std::unordered_map<MapKey, CUtensorMap, MapKeyOps, MapKeyOps> known;
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (known.size() >= 4096) known.clear();  // a bound on what stale pointers may hold
  known.emplace(key, *map);
  return cudaSuccess;
}

// A row-major matrix [outer, inner] of bf16 (f32 with `f32`) in boxes of
// [box_outer, box_inner].
static inline cudaError_t encode_2d(CUtensorMap* map, const void* base, bool f32, uint64_t inner,
                                    uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  return encode_map(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    2, base, dims, strides, box);
}

}  // namespace wgc
