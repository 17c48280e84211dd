// Cosine top-k over catalog slices, f32 or bf16 rows, for Hopper: exact, or
// on packed 20-bit keys.
//
// Replaces: the JAX package's ops/topk.py::_topk_block_kernel (K3) and
// ::_topk_block_kernel_packed (K4), the Pallas TPU kernels behind
// cosine_topk_pallas. Same function: dot products of the queries with the
// catalog rows (both f32, or both bf16 as the JAX index stores a bf16
// catalog: index/sharded.py, dtype="bfloat16"), accumulated in f32, rows at
// or past n_valid and rows whose candidate mask is 0 set to -1e30, then the
// top k with ties broken to the lowest index. K4
// ranks each score by the top 20 bits of its order-preserving bit pattern
// instead (the JAX kernel's packed key, `quantized_keys` in ops/topk.py),
// ties again to the lowest index, and returns the score the quantized key
// stands for. Each block of the slice kernel takes TQ queries over one
// slice of whole 128-row tiles and writes each query's top k keys of the
// slice to [B, n_slices, k]; the merge kernel selects each query's top k of
// those with the same selection and writes scores and rows.
//
// What bounds it on the H100: the products, 2*B*N*D multiply-adds (here
// three TF32 tensor-core products each), at serve batches; at B=1 and B=8
// the catalog read, N*D*4 bytes against 3.35 TB/s. bf16 rows halve those
// bytes, and each multiply-add is one bf16 tensor-core product.
//
// What the design does about it:
// - Scores on tensor cores in split TF32: each f32 operand is hi + lo, two
//   TF32 values (mma_common.cuh: split_tf32), and hi hi + hi lo + lo hi go
//   through mma.sync m16n8k8 with f32 accumulation, at most 1.25 * 2^-20 of
//   sum |q_i c_i| from the f32 product (1.2e-6 for unit rows, and typically
//   a twentieth of that). The tensor cores truncate as they accumulate: on
//   the H100, over all 3 * D / 8 products of a score, scores near 1 drifted
//   several 1e-6 from float64; each 32 columns sum into a fresh partial,
//   added in rounded f32, which keeps them within 1e-6 of float64
//   (tests/test_torch_kernels_gpu.py). Values that TF32 holds exactly
//   (lo = 0) give exact f32 scores. Catalog rows are the M side (16 per
//   product), queries the N side (8), so B=1 wastes only the N side. Tiles
//   arrive through a cp.async ring of 64-column stages, the next stage
//   loading while the current one multiplies; within each 32 columns of a
//   stage the k index is permuted (lane t feeds columns 8t..8t+7) so every
//   fragment load is 16 bytes and free of bank conflicts. The products
//   dispatch at one per 6 cycles per scheduler, and each split instruction
//   beside them costs about one more, so the split is three instructions
//   (mma_common.cuh: split_tf32).
// - bf16 rows (topk_slices_bf16_kernel, the same body): queries and rows go
//   straight into mma.sync m16n8k16 bf16 -> f32. A product of two bf16
//   values is exact in f32, so there is one product where split TF32 takes
//   three. The stage holds 128 columns (256 bytes a row, as the f32 stage's
//   64); within each 64 columns lane t loads columns 16t..16t+15 of its rows
//   as two 16-byte loads, and k-step s takes its logical columns (2t, 2t+1)
//   from 16t + 4s + {0, 1} and (2t+8, 2t+9) from 16t + 4s + {2, 3}, for
//   both operands, so each dot product sums the same terms. Each 64 columns
//   sum into a fresh partial, as each 32 do in the f32 form. The selection,
//   the keys and the merge are the f32 form's: they see f32 scores.
// - A selection that costs what k costs: each query keeps a sorted list of
//   its best KP keys (KP = k rounded up to a power of two, at least 32) and
//   a threshold, its k-th key. A score passes with one comparison against
//   it; a warp collects passing keys 32 at a time and merges them into the
//   list with shuffles (a bitonic sort of the 32, then a bitonic merge),
//   WarpSelect's scheme. A warp takes its queries side by side, 32 rows at
//   a time, so their loads, comparisons and ballots overlap; the merge is
//   one function, called where a query's 32 pending keys are full.
// - Keys are unique 64-bit values: the score's order bits (K4: with the low
//   12 cleared), then the inverted global row, so any selection order gives
//   the stable sort's answer. An empty slot is key 0, below every row, so
//   masked rows (-1e30) still fill a list that has fewer than k rows.
// - One slice per block: the grid is (query tiles, slices), the query tile
//   fastest, so blocks reading the same catalog rows run together and share
//   them through L2; each query emits n_slices * k candidate keys, which one
//   warp per query merges in a second, small kernel (one launch, where a
//   stable sort and a gather took seven).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_common.cuh"

namespace {

using mmac::cp_async16;
using mmac::cp_commit;
using mmac::cp_wait;
using mmac::FULL;
typedef unsigned long long Key;

constexpr int BM = 128;        // catalog rows per tile; slices are whole tiles
constexpr int LDS = BM + 4;    // score tile row stride in floats
constexpr int STAGES = 2;      // a third stage measured no faster
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PEND = 32;       // passing keys collected per query before a merge
constexpr float NEG_INF = -1e30f;

// A ring stage's columns per operand type: 256 bytes of each row, staged at
// a stride of 272 bytes (16 mod 128), so the 16-byte fragment loads of a
// warp's quarter, two rows of four 32-byte lane spans, hit 32 distinct banks.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int DK = 64;       // feature columns per ring stage
  static constexpr int LDT = DK + 4;  // staged row stride in elements
};
template <>
struct Elem<bf16> {
  static constexpr int DK = 128;
  static constexpr int LDT = DK + 8;
};

template <typename T, int TQ, int KP>
struct Shape {
  static constexpr int WN = TQ >= 16 ? 2 : 1;  // warps along the queries
  static constexpr int WM = WARPS / WN;         // warps along the catalog rows
  static constexpr int MT = BM / 16 / WM;       // m16 tiles per warp
  static constexpr int NT = TQ / 8 / WN;        // n8 tiles per warp
  static constexpr int STAGE = (BM + TQ) * Elem<T>::LDT;  // elements
  static constexpr size_t RING = (size_t)STAGES * STAGE * sizeof(T);
  static constexpr size_t SCORES = (size_t)TQ * LDS * 4;
  static constexpr size_t TOP = (size_t)TQ * KP * 8;
  static constexpr size_t PENDING = (size_t)TQ * PEND * 8;
  static constexpr size_t SMEM = RING + SCORES + TOP + PENDING + (size_t)TQ * 12;
  static_assert(WM * MT * 16 == BM && WN * NT * 8 == TQ, "warp tiling");
};

__device__ __forceinline__ uint32_t order_bits(float s) {
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The selection key of score s at global row `row`. K4's quantized order
// bits equal ops/topk.py's quantized_keys with the sign bit flipped (signed
// order made unsigned).
__device__ __forceinline__ Key make_key(float s, int row, bool packed) {
  if (s == 0.0f) s = 0.0f;  // one key for +0 and -0
  uint32_t ob = order_bits(s);
  if (packed) ob &= ~0xFFFu;
  return ((Key)ob << 32) | (uint32_t)~(uint32_t)row;
}

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }
__device__ __forceinline__ Key kmin(Key a, Key b) { return a < b ? a : b; }

// Merges the keys pend[0, n) (n <= 32) into a query's list top[KP], sorted
// descending, and returns the new threshold: the k-th key, or 0 while the
// list holds fewer than k rows. top[e * 32 + lane] lives in lane `lane`.
template <int KP>
__device__ __noinline__ Key merge_pending(Key* top, const Key* pend, int n, int k, int lane) {
  constexpr int E = KP / 32;
  Key p = lane < n ? pend[lane] : 0;
  // Bitonic sort of the 32 pending keys, ascending across the lanes.
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key o = __shfl_xor_sync(FULL, p, stride);
      const bool up = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      p = lower == up ? kmin(p, o) : kmax(p, o);
    }
  }
  Key v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = top[e * 32 + lane];
  // top (descending) against the pending keys (ascending, below KP - 32
  // padded with empties): the elementwise larger holds the best KP of both,
  // as a bitonic sequence. Only the last 32 slots can change.
  v[E - 1] = kmax(v[E - 1], p);
  // Bitonic merge into descending order: strides of 32 and more within a
  // lane's slots, below 32 across lanes.
#pragma unroll
  for (int es = E / 2; es > 0; es >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((e & es) == 0) {
        const Key a = v[e], b = v[e + es];
        v[e] = kmax(a, b);
        v[e + es] = kmin(a, b);
      }
    }
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const Key o = __shfl_xor_sync(FULL, v[e], stride);
      v[e] = (lane & stride) ? kmin(v[e], o) : kmax(v[e], o);
    }
  }
  Key kth = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    top[e * 32 + lane] = v[e];
    if (e == (k - 1) / 32) kth = v[e];
  }
  return __shfl_sync(FULL, kth, (k - 1) % 32);
}

// The keys of the lanes in ballot `m` (those above the query's threshold
// `th`) join its pending keys pq[0, c); 32 pending keys merge into its list
// top, which raises `th`. The warp takes the same branches.
template <int KP>
__device__ __forceinline__ void take(Key key, unsigned m, Key* top, Key* pq, Key& th, int& c,
                                     int k, int lane) {
  if (m == 0) return;
  const bool pass = (m >> lane) & 1;
  const int rank = __popc(m & ((1u << lane) - 1u));
  const int n = __popc(m);
  const int room = PEND - c;
  if (pass && rank < room) pq[c + rank] = key;
  if (n < room) {
    c += n;
    return;
  }
  __syncwarp();
  th = merge_pending<KP>(top, pq, PEND, k, lane);
  __syncwarp();
  if (pass && rank >= room) pq[rank - room] = key;
  c = n - room;
}

// One ring stage added to the warp's accumulators: acc[mt][nt] covers
// catalog rows (wm * MT + mt) * 16 + [0, 16) and queries (wn * NT + nt) * 8 +
// [0, 8) of the tile. Logical k = t of k-step s within 32 columns of the
// stage is column 8t + 2s of them, k = t + 4 column 8t + 2s + 1, for A and B
// alike. The tensor cores truncate as they accumulate, so each 32 columns'
// products go into a fresh partial, added to acc in rounded f32.
template <int TQ, int KP>
__device__ __forceinline__ void mma_stage(
    float (&acc)[Shape<float, TQ, KP>::MT][Shape<float, TQ, KP>::NT][4], const float* st, int wm,
    int wn, int g, int t) {
  using S = Shape<float, TQ, KP>;
  constexpr int DK = Elem<float>::DK;
  constexpr int LDT = Elem<float>::LDT;
  const float* Cs = st + (wm * S::MT * 16 + g) * LDT + 8 * t;
  const float* Qs = st + (BM + wn * S::NT * 8 + g) * LDT + 8 * t;
#pragma unroll
  for (int c32 = 0; c32 < DK / 32; ++c32) {
    float part[S::MT][S::NT][4];
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two k-steps: columns col + [0, 4) of the lane
      const int col = 32 * c32 + 4 * h;
      // [part][tile][column]: part 0 the TF32 high parts, 1 the remainders;
      // a[.][.][0..3] row g, a[.][.][4..7] row g + 8.
      uint32_t b[2][S::NT][4], a[2][S::MT][8];
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const float4 v = *reinterpret_cast<const float4*>(Qs + nt * 8 * LDT + col);
        mmac::split_tf32(v.x, b[0][nt][0], b[1][nt][0]);
        mmac::split_tf32(v.y, b[0][nt][1], b[1][nt][1]);
        mmac::split_tf32(v.z, b[0][nt][2], b[1][nt][2]);
        mmac::split_tf32(v.w, b[0][nt][3], b[1][nt][3]);
      }
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 u = *reinterpret_cast<const float4*>(Cs + (mt * 16 + half * 8) * LDT + col);
          mmac::split_tf32(u.x, a[0][mt][4 * half + 0], a[1][mt][4 * half + 0]);
          mmac::split_tf32(u.y, a[0][mt][4 * half + 1], a[1][mt][4 * half + 1]);
          mmac::split_tf32(u.z, a[0][mt][4 * half + 2], a[1][mt][4 * half + 2]);
          mmac::split_tf32(u.w, a[0][mt][4 * half + 3], a[1][mt][4 * half + 3]);
        }
      }
      // lo hi, hi lo, then hi hi (the small terms first); within a term
      // every tile's product is independent of the others, so MT * NT
      // products lie between two that share an accumulator.
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          const int pa = term == 0 ? 1 : 0;
          const int pb = term == 1 ? 1 : 0;
#pragma unroll
          for (int mt = 0; mt < S::MT; ++mt) {
            const uint32_t frag[4] = {a[pa][mt][2 * s2], a[pa][mt][4 + 2 * s2],
                                      a[pa][mt][2 * s2 + 1], a[pa][mt][4 + 2 * s2 + 1]};
#pragma unroll
            for (int nt = 0; nt < S::NT; ++nt)
              mmac::mma_tf32(part[mt][nt], frag, b[pb][nt][2 * s2], b[pb][nt][2 * s2 + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
}

// One ring stage of bf16 rows added to the warp's accumulators, tiles as in
// the f32 stage. Within each 64 columns lane t holds columns 16t + [0, 16)
// of its rows in eight registers, two columns each; k-step s takes
// registers 2s (logical columns 2t, 2t + 1) and 2s + 1 (2t + 8, 2t + 9) of
// A and B alike. Each 64 columns' products go into a fresh partial.
template <int TQ, int KP>
__device__ __forceinline__ void mma_stage(
    float (&acc)[Shape<bf16, TQ, KP>::MT][Shape<bf16, TQ, KP>::NT][4], const bf16* st, int wm,
    int wn, int g, int t) {
  using S = Shape<bf16, TQ, KP>;
  constexpr int LDT = Elem<bf16>::LDT;
  const bf16* Cs = st + (wm * S::MT * 16 + g) * LDT + 16 * t;
  const bf16* Qs = st + (BM + wn * S::NT * 8 + g) * LDT + 16 * t;
#pragma unroll
  for (int c64 = 0; c64 < Elem<bf16>::DK / 64; ++c64) {
    // b[tile][register]; a[tile][half][register]: half 0 row g, 1 row g + 8.
    uint32_t b[S::NT][8], a[S::MT][2][8];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) {
      const uint4* p = reinterpret_cast<const uint4*>(Qs + nt * 8 * LDT + 64 * c64);
      const uint4 v0 = p[0], v1 = p[1];
      b[nt][0] = v0.x, b[nt][1] = v0.y, b[nt][2] = v0.z, b[nt][3] = v0.w;
      b[nt][4] = v1.x, b[nt][5] = v1.y, b[nt][6] = v1.z, b[nt][7] = v1.w;
    }
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4* p =
            reinterpret_cast<const uint4*>(Cs + (mt * 16 + half * 8) * LDT + 64 * c64);
        const uint4 u0 = p[0], u1 = p[1];
        uint32_t* r = a[mt][half];
        r[0] = u0.x, r[1] = u0.y, r[2] = u0.z, r[3] = u0.w;
        r[4] = u1.x, r[5] = u1.y, r[6] = u1.z, r[7] = u1.w;
      }
    }
    float part[S::MT][S::NT][4];
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int mt = 0; mt < S::MT; ++mt) {
        const uint32_t frag[4] = {a[mt][0][2 * s], a[mt][1][2 * s], a[mt][0][2 * s + 1],
                                  a[mt][1][2 * s + 1]};
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt)
          mmac::mma(part[mt][nt], frag, b[nt][2 * s], b[nt][2 * s + 1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }
}

// The slice kernel's body over rows of type T (float or bf16).
template <typename T, int TQ, int KP>
__device__ __forceinline__ void slices_body(const T* __restrict__ Q, const T* __restrict__ C,
                                            const int* __restrict__ mask, Key* __restrict__ cand,
                                            int B, int N, int D, int n_valid, int k, int packed,
                                            int slice_rows, int n_slices) {
  using S = Shape<T, TQ, KP>;
  constexpr int DK = Elem<T>::DK;
  constexpr int LDT = Elem<T>::LDT;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* Sc = reinterpret_cast<float*>(smem + S::RING);  // [TQ][LDS], query-major
  Key* top = reinterpret_cast<Key*>(smem + S::RING + S::SCORES);  // [TQ][KP]
  Key* pend = top + TQ * KP;                                      // [TQ][PEND]
  Key* thr = pend + TQ * PEND;                                    // [TQ]
  int* cnt = reinterpret_cast<int*>(thr + TQ);                    // [TQ]

  const int q0 = blockIdx.x * TQ;
  const int slice = blockIdx.y;
  const int r_begin = slice * slice_rows;
  const int r_end = min(N, r_begin + slice_rows);
  const int n_chunks = (D + DK - 1) / DK;
  const int n_tiles = (r_end - r_begin + BM - 1) / BM;
  const int steps = n_tiles * n_chunks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % S::WM;
  const int wn = warp / S::WM;
  const int g = lane >> 2;
  const int t = lane & 3;

  for (int i = tid; i < TQ * KP; i += THREADS) top[i] = 0;
  for (int i = tid; i < TQ; i += THREADS) {
    thr[i] = 0;
    cnt[i] = 0;
  }

  // Step `step` brings columns [d0, d0 + DK) of one tile's catalog rows and
  // of the query tile; rows past the slice or the batch and columns past D
  // are zero.
  auto load_stage = [&](int step) {
    if (step < steps) {
      T* st = ring + (step % STAGES) * S::STAGE;
      const int row0 = r_begin + (step / n_chunks) * BM;
      const int d0 = (step % n_chunks) * DK;
      for (int i = tid; i < (BM + TQ) * (DK / VEC); i += THREADS) {
        const int r = i / (DK / VEC);
        const int c = d0 + (i % (DK / VEC)) * VEC;
        const int row = r < BM ? row0 + r : q0 + r - BM;
        const bool ok = c < D && (r < BM ? row < r_end : row < B);
        const T* src = (r < BM ? C : Q) + (ok ? (size_t)row * D + c : 0);
        cp_async16(st + r * LDT + c - d0, src, ok);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_stage(s);

  for (int tile = 0; tile < n_tiles; ++tile) {
    float acc[S::MT][S::NT][4];
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int step = tile * n_chunks + ch;
      cp_wait<STAGES - 2>();
      __syncthreads();  // stage `step` has landed; stage `step - 1` is free
      load_stage(step + STAGES - 1);
      mma_stage<TQ, KP>(acc, ring + (step % STAGES) * S::STAGE, wm, wn, g, t);
    }
#pragma unroll
    for (int mt = 0; mt < S::MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const int r = (wm * S::MT + mt) * 16 + g;
        const int q = (wn * S::NT + nt) * 8 + 2 * t;
        Sc[q * LDS + r] = acc[mt][nt][0];
        Sc[(q + 1) * LDS + r] = acc[mt][nt][1];
        Sc[q * LDS + r + 8] = acc[mt][nt][2];
        Sc[(q + 1) * LDS + r + 8] = acc[mt][nt][3];
      }
    }
    __syncthreads();

    // Selection: warp w takes queries w, w + 8, ...; lane holds rows
    // lane + 32 j of the tile.
    const int row0 = r_begin + tile * BM;
    unsigned exists = 0, eligible = 0;  // bit j: row lane + 32 j of the tile
#pragma unroll
    for (int j = 0; j < BM / 32; ++j) {
      const int row = row0 + lane + 32 * j;
      if (row < r_end) {
        exists |= 1u << j;
        if (row < n_valid && (mask == nullptr || mask[row] != 0)) eligible |= 1u << j;
      }
    }
    // The warp's queries side by side, 32 rows at a time: their keys and
    // ballots are independent, so their loads and comparisons overlap; a
    // merge (rare once a slice's first tiles are past) is one call.
    constexpr int QW = TQ / WARPS;  // queries per warp: warp + 8 i
    Key th[QW];
    int c[QW];
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const bool live = q0 + warp + WARPS * i < B;
      th[i] = live ? thr[warp + WARPS * i] : ~0ull;  // nothing passes a missing query
      c[i] = cnt[warp + WARPS * i];
    }
#pragma unroll
    for (int j = 0; j < BM / 32; ++j) {
      const int row = row0 + lane + 32 * j;
      Key key[QW];
      unsigned m[QW];
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const float s =
            (eligible >> j) & 1 ? Sc[(warp + WARPS * i) * LDS + lane + 32 * j] : NEG_INF;
        key[i] = make_key(s, row, packed);
        m[i] = __ballot_sync(FULL, (exists >> j) & 1 && key[i] > th[i]);
      }
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const int qi = warp + WARPS * i;
        take<KP>(key[i], m[i], top + qi * KP, pend + qi * PEND, th[i], c[i], k, lane);
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        if (q0 + warp + WARPS * i < B) {
          thr[warp + WARPS * i] = th[i];
          cnt[warp + WARPS * i] = c[i];
        }
      }
    }
  }

  // The keys still pending, then each query's first k keys of the slice
  // (0 past a slice's last row: below every row).
  for (int qi = warp; qi < TQ && q0 + qi < B; qi += WARPS) {
    __syncwarp();
    if (cnt[qi] > 0) merge_pending<KP>(top + qi * KP, pend + qi * PEND, cnt[qi], k, lane);
    __syncwarp();
    Key* out = cand + ((size_t)(q0 + qi) * n_slices + slice) * k;
    for (int i = lane; i < k; i += 32) out[i] = top[qi * KP + i];
  }
}

template <int TQ, int KP>
__global__ void __launch_bounds__(THREADS, TQ == 8 ? 2 : 1)
topk_slices_kernel(const float* __restrict__ Q, const float* __restrict__ C,
                   const int* __restrict__ mask, Key* __restrict__ cand, int B, int N, int D,
                   int n_valid, int k, int packed, int slice_rows, int n_slices) {
  slices_body<float, TQ, KP>(Q, C, mask, cand, B, N, D, n_valid, k, packed, slice_rows, n_slices);
}

template <int TQ, int KP>
__global__ void __launch_bounds__(THREADS, TQ == 8 ? 2 : 1)
topk_slices_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ C,
                        const int* __restrict__ mask, Key* __restrict__ cand, int B, int N, int D,
                        int n_valid, int k, int packed, int slice_rows, int n_slices) {
  slices_body<bf16, TQ, KP>(Q, C, mask, cand, B, N, D, n_valid, k, packed, slice_rows, n_slices);
}

// Each query's top k of its n_cand candidate keys, one warp per query, by
// the slice kernel's selection: scores and rows, in key order.
template <int KP>
__global__ void __launch_bounds__(THREADS)
topk_merge_kernel(const Key* __restrict__ cand, float* __restrict__ out_s,
                  int* __restrict__ out_i, int B, int n_cand, int k) {
  __shared__ Key top_s[WARPS][KP];
  __shared__ Key pend_s[WARPS][PEND];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= B) return;  // warp-uniform; no block-wide barrier follows
  Key* top = top_s[warp];
  Key* pq = pend_s[warp];
  for (int i = lane; i < KP; i += 32) top[i] = 0;
  __syncwarp();
  Key th = 0;
  int c = 0;
  const Key* in = cand + (size_t)q * n_cand;
  for (int i0 = 0; i0 < n_cand; i0 += 4 * 32) {  // four loads in flight
    Key key[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      key[u] = i < n_cand ? in[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // key 0 (past n_cand) never passes
      take<KP>(key[u], __ballot_sync(FULL, key[u] > th), top, pq, th, c, k, lane);
    }
  }
  __syncwarp();
  if (c > 0) merge_pending<KP>(top, pq, c, k, lane);
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const Key key = top[i];
    out_s[(size_t)q * k + i] = from_order_bits((uint32_t)(key >> 32));
    out_i[(size_t)q * k + i] = (int)~(uint32_t)key;
  }
}

template <typename T, int TQ, int KP>
cudaError_t launch(const void* Q, const void* C, const void* mask, void* cand, void* out_s,
                   void* out_i, int B, int N, int D, int n_valid, int k, int packed,
                   int slice_rows, int n_slices, cudaStream_t stream) {
  using S = Shape<T, TQ, KP>;
  void (*kernel)(const T*, const T*, const int*, Key*, int, int, int, int, int, int, int, int);
  if constexpr (std::is_same<T, float>::value)
    kernel = topk_slices_kernel<TQ, KP>;
  else
    kernel = topk_slices_bf16_kernel<TQ, KP>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((B + TQ - 1) / TQ, n_slices), THREADS, S::SMEM, stream>>>(
      (const T*)Q, (const T*)C, (const int*)mask, (Key*)cand, B, N, D, n_valid, k, packed,
      slice_rows, n_slices);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  topk_merge_kernel<KP><<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      (const Key*)cand, (float*)out_s, (int*)out_i, B, n_slices * k, k);
  return cudaGetLastError();
}

// The entry points' checks and the forms the k rule picks, for rows of type T.
template <typename T>
int topk_entry(const void* queries, const void* catalog, const void* mask, void* cand,
               void* out_s, void* out_i, int batch, int n_rows, int dim, int n_valid, int k,
               int packed, int query_tile, int slice_rows, int n_slices, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  constexpr int VEC = 16 / sizeof(T);
  if (batch < 1 || n_rows < 1 || dim < VEC || dim % VEC || k < 1 || k > 256 ||
      slice_rows < BM || slice_rows % BM || n_slices != (n_rows + slice_rows - 1) / slice_rows)
    return (int)cudaErrorInvalidValue;
  const int kp = k <= 32 ? 32 : k <= 64 ? 64 : k <= 128 ? 128 : 256;
#define TOPK_LAUNCH(TQ_, KP_)                                                                  \
  if (query_tile == TQ_ && kp == KP_)                                                         \
    return (int)launch<T, TQ_, KP_>(queries, catalog, mask, cand, out_s, out_i, batch, n_rows, \
                                    dim, n_valid, k, packed, slice_rows, n_slices, stream);
  TOPK_LAUNCH(8, 32)
  TOPK_LAUNCH(8, 64)
  TOPK_LAUNCH(8, 128)
  TOPK_LAUNCH(8, 256)
  TOPK_LAUNCH(64, 32)
  TOPK_LAUNCH(64, 64)
  TOPK_LAUNCH(64, 128)
  TOPK_LAUNCH(32, 256)
#undef TOPK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// queries [B, D] f32, catalog [N, D] f32 (both 16-byte aligned), mask [N]
// int32 or null, cand [B, n_slices, k] 64-bit scratch, out_s / out_i
// [B, k]; D % 4 == 0, 1 <= k <= 256, slice_rows a multiple of 128 with
// n_slices = ceil(N / slice_rows). query_tile is 8, or 64 for k <= 128 and
// 32 above (ops/topk.py: query_tile). packed != 0 ranks by the 20-bit
// quantized keys (K4), else exactly (K3).
int topk_slices(const void* queries, const void* catalog, const void* mask, void* cand,
                void* out_s, void* out_i, int batch, int n_rows, int dim, int n_valid, int k,
                int packed, int query_tile, int slice_rows, int n_slices, void* stream_ptr) {
  return topk_entry<float>(queries, catalog, mask, cand, out_s, out_i, batch, n_rows, dim,
                           n_valid, k, packed, query_tile, slice_rows, n_slices, stream_ptr);
}

// The same on bf16 queries and catalog rows (D % 8 == 0); scores are f32.
int topk_slices_bf16(const void* queries, const void* catalog, const void* mask, void* cand,
                     void* out_s, void* out_i, int batch, int n_rows, int dim, int n_valid, int k,
                     int packed, int query_tile, int slice_rows, int n_slices, void* stream_ptr) {
  return topk_entry<bf16>(queries, catalog, mask, cand, out_s, out_i, batch, n_rows, dim,
                          n_valid, k, packed, query_tile, slice_rows, n_slices, stream_ptr);
}

}  // extern "C"
