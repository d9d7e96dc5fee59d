// The frame shared by the banded kernels K1 (dia_mv.cu) and K2
// (dia_rmv.cu) on Hopper (sm_90a).
//
// Work split.  A block owns one tile of 32 * R * V consecutive outputs.
// Each of its warps covers the whole tile for a contiguous group of
// diagonals: lane L holds the 16-byte chunks 32 * r + L (r < R = 2) of the
// tile, V = 16 / sizeof(T) values each, so the tile is 256 rows in f32 and
// 128 in f64.  Two chunks a lane (32 bytes of each stream per diagonal)
// pay for the fixed cost of a diagonal (its offset, addresses, the shift);
// one chunk timed 10-17% slower in f32, four at most 5% faster.
// With a thread-block cluster of C blocks on one tile, the C * warps
// groups split the diagonals between the blocks as well:
//     group g = rank * warps + warp  takes  [g * nd / G, (g + 1) * nd / G)
// with G = C * warps groups (ops/dia_kernel.py:launch_plan chooses warps
// and C, and mirrors this split in ``LaunchPlan.group_ranges``).
//
// Shifted reads.  For one diagonal a warp needs a window of a stream that
// starts at some row `start` not aligned to V.  It loads the aligned
// chunks that cover it (lane L the chunk at b + V * (32 * r + L), b =
// start rounded down to V, lane 31 one more), and moves each value to the
// lane that needs it with warp shuffles: the shift s = start - b is the
// same for every lane, so the select is a uniform branch, and no warp
// ever reads a misaligned sector.
//
// Bytes in flight.  Each lane streams its chunks through a ring of
// kStages = 2 stages in shared memory with cp.async (16 bytes a copy,
// zero-filled outside the stream): while it uses diagonal k the copies of
// diagonal k + 1 are in flight, and they hold no registers.  Four stages
// timed within 5%: the small ring leaves room for more resident warps.  A
// lane reads back only what it copied itself, so the ring needs no
// barrier; cross-lane moves are the shuffles above.  `data` is copied
// past L1 (.cg), x through it (.ca), where its window stays across
// neighbouring diagonals.
//
// Deterministic sum.  Each lane adds its group's diagonals in ascending
// order; the warps' partial tiles are added in shared memory in warp
// order, and the blocks of a cluster in rank order through distributed
// shared memory.  No atomics: a launch is bitwise repeatable, and the
// order depends only on (nd, the launch plan).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace porotpu {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;  // a launch takes at most 16 warps a block
constexpr int kChunks = 2;        // R: 16-byte chunks a lane holds per diagonal
constexpr int kStages = 2;        // ring stages a warp
constexpr unsigned kFull = 0xffffffffu;

// one 16-byte chunk of T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ __forceinline__ void unpack(const float4& t, float (&v)[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void unpack(const double2& t, double (&v)[2]) {
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ float4 pack(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack(const double (&v)[2]) {
  return make_double2(v[0], v[1]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy the chunk p[c : c + V] into the shared-memory slot `dst`, zero
// outside [0, n).  kVec: p is 16-byte aligned and n % V == 0 (c is a
// multiple of V), so a chunk is wholly inside or wholly outside and is one
// asynchronous 16-byte copy (kL1: kept in L1); otherwise each value is
// read, masked and stored on its own, synchronously.
template <bool kVec, bool kL1, typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* __restrict__ p, int64_t c,
                                           int64_t n) {
  constexpr int V = Vec<T>::n;
  if constexpr (kVec) {
    const bool inside = c >= 0 && c + V <= n;
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const T* src = inside ? p + c : p;
    const int bytes = inside ? 16 : 0;
    if constexpr (kL1) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
                   "r"(bytes)
                   : "memory");
    } else {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
                   "r"(bytes)
                   : "memory");
    }
  } else {
    T v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t i = c + k;
      v[k] = (i >= 0 && i < n) ? __ldg(p + i) : T(0);
    }
    *reinterpret_cast<typename Vec<T>::type*>(dst) = pack(v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void read_chunk(const T* src, T (&v)[V]) {
  unpack(*reinterpret_cast<const typename Vec<T>::type*>(src), v);
}

// The tile of R chunks a lane, and a warp's ring: kStages stages, each R
// chunks of `data` and R of x per lane, then two chunks for lane 31 (K1:
// x; K2: data and x).
template <typename T>
struct Ring {
  static constexpr int V = Vec<T>::n, R = kChunks;
  static constexpr int kRows = 32 * R * V;  // outputs of a tile
  static constexpr int kChunkRow = 32 * V;  // values of one chunk row
  static constexpr int kStage = (2 * R * 32 + 2) * V;  // values of a stage
  T* base;
  __device__ T* data(int slot, int r, int lane) const {
    return base + slot * kStage + r * kChunkRow + V * lane;
  }
  __device__ T* x(int slot, int r, int lane) const {
    return base + slot * kStage + (R + r) * kChunkRow + V * lane;
  }
  __device__ T* extra(int slot, int e) const {
    return base + slot * kStage + 2 * R * kChunkRow + V * e;
  }
};

template <typename T>
__host__ __device__ constexpr size_t ring_bytes(int warps) {
  return static_cast<size_t>(warps) * kStages * Ring<T>::kStage * sizeof(T);
}

// Dynamic shared memory of a block: the warps' rings, then the partial
// tiles of reduce_store.
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int warps) {
  return ring_bytes<T>(warps) + static_cast<size_t>(warps + 1) * Ring<T>::kRows * sizeof(T);
}

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return smem_raw;
}

template <typename T>
__device__ __forceinline__ Ring<T> warp_ring() {
  return Ring<T>{reinterpret_cast<T*>(dynamic_smem()) +
                 (threadIdx.x >> 5) * kStages * Ring<T>::kStage};
}

// Run copy(slot, k) and use(slot, k) over k in [0, n), with the copies of
// the next kStages - 1 diagonals in flight while diagonal k is used.
template <typename Copy, typename Use>
__device__ __forceinline__ void pipeline(int n, Copy copy, Use use) {
  constexpr int S = kStages;
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < n) copy(k, k);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    const int ahead = k + S - 1;
    if (ahead < n) copy(ahead % S, ahead);
    cp_async_commit();
    cp_async_wait<S - 1>();
    use(k % S, k);
  }
}

// out[r][k] = the value at position kShift + V * (32 * r + lane) + k of a
// segment of which lane L holds chunk 32 * r + L in lo[r] and lane 31 also
// holds chunk 32 * R in ex.  The values past a lane's own chunk come from
// lane + 1 (for lane 31: lane 0's next chunk, or ex).
template <int kShift, typename T, int V, int R>
__device__ __forceinline__ void shift_by(const T (&lo)[R][V], const T (&ex)[V],
                                         int lane, T (&out)[R][V]) {
  if constexpr (kShift == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < V; ++k) out[r][k] = lo[r][k];
  } else {
    const int src = (lane + 1) & 31;
    T rot[R][kShift];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < kShift; ++e) rot[r][e] = __shfl_sync(kFull, lo[r][e], src);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < V - kShift; ++k) out[r][k] = lo[r][k + kShift];
#pragma unroll
      for (int e = 0; e < kShift; ++e) {
        const T last = (r + 1 < R) ? rot[(r + 1) % R][e] : ex[e];
        out[r][V - kShift + e] = lane == 31 ? last : rot[r][e];
      }
    }
  }
}

template <typename T, int V, int R>
__device__ __forceinline__ void shift(const T (&lo)[R][V], const T (&ex)[V], int s,
                                      int lane, T (&out)[R][V]) {
  if constexpr (V == 4) {
    switch (s) {
      case 0: shift_by<0>(lo, ex, lane, out); break;
      case 1: shift_by<1>(lo, ex, lane, out); break;
      case 2: shift_by<2>(lo, ex, lane, out); break;
      default: shift_by<3>(lo, ex, lane, out); break;
    }
  } else {
    if (s == 0) {
      shift_by<0>(lo, ex, lane, out);
    } else {
      shift_by<1>(lo, ex, lane, out);
    }
  }
}

// This warp's diagonal group [*d_lo, *d_hi) and the first output of the
// block's tile of `rows`.
__device__ __forceinline__ void tile_and_group(int nd, int cluster, int rows, int64_t* t0,
                                               int* d_lo, int* d_hi) {
  const int warps = blockDim.x >> 5;
  const int rank = blockIdx.x % cluster;
  *t0 = static_cast<int64_t>(blockIdx.x / cluster) * rows;
  const int64_t groups = static_cast<int64_t>(warps) * cluster;
  const int64_t g = static_cast<int64_t>(rank) * warps + (threadIdx.x >> 5);
  *d_lo = static_cast<int>(g * nd / groups);
  *d_hi = static_cast<int>((g + 1) * nd / groups);
}

// Sum the warps' partial tiles (acc[r][k] is output t0 + V * (32 * r +
// lane) + k) in warp order, then the cluster's blocks in rank order, and
// write the outputs below n_out.  Uses (warps + 1) * kRows values of
// shared memory after the rings.
template <typename T, int V, int R>
__device__ __forceinline__ void reduce_store(const T (&acc)[R][V], int64_t t0,
                                             int64_t n_out, int cluster,
                                             T* __restrict__ y) {
  constexpr int kTile = Ring<T>::kRows;
  const int warps = blockDim.x >> 5;
  T* part = reinterpret_cast<T*>(dynamic_smem() + ring_bytes<T>(warps));  // [warps][kTile]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  using VT = typename Vec<T>::type;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    *reinterpret_cast<VT*>(part + w * kTile + V * (32 * r + lane)) = pack(acc[r]);
  }
  __syncthreads();
  T* tile_sum = part + warps * kTile;  // [kTile]
  for (int row = threadIdx.x; row < kTile; row += blockDim.x) {
    T s = part[row];
    for (int q = 1; q < warps; ++q) s += part[q * kTile + row];
    if (cluster == 1) {
      if (t0 + row < n_out) y[t0 + row] = s;
    } else {
      tile_sum[row] = s;
    }
  }
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's tile_sum is written
    const int rank = static_cast<int>(cl.block_rank());
    const int per = kTile / cluster;
    for (int row = rank * per + threadIdx.x; row < (rank + 1) * per; row += blockDim.x) {
      T s = cl.map_shared_rank(tile_sum, 0)[row];
      for (int q = 1; q < cluster; ++q) s += cl.map_shared_rank(tile_sum, q)[row];
      if (t0 + row < n_out) y[t0 + row] = s;
    }
    cl.sync();  // no block leaves while another still reads its tile_sum
  }
}

// Dynamic shared memory a block may take without a cudaFuncSetAttribute
// call; the plan stays within it (42.5 KB at 8 warps in f32).
constexpr int kMaxSmem = 48 * 1024;

// One launch of `kernel` over ceil(n_out / kRows) tiles, `cluster` blocks
// a tile (a thread-block cluster when cluster > 1), `warps` warps a block.
// `tile` and `stages` are the plan's (ops/dia_kernel.py), checked against
// this frame's.  Returns the launch's cudaError_t.
template <typename T, typename... KArgs, typename... Args>
int launch_tiles(void (*kernel)(KArgs...), int64_t n_out, int warps, int cluster, int tile,
                 int stages, void* stream, Args... args) {
  constexpr int kRows = Ring<T>::kRows;
  const size_t smem = smem_bytes<T>(warps);
  if (tile != kRows || stages != kStages || warps < 1 || warps * 32 > kMaxThreads ||
      cluster < 1 || cluster > 8 || kRows % cluster != 0 ||
      smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n_out + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * cluster));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace porotpu
