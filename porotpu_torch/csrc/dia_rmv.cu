// Banded (DIA) transpose product for Hopper (sm_90a): kernel K2.
//
//   y[j] = sum_d data[d, j - off[d]] * x[j - off[d]],   j in [0, ne),
//   where a term counts only if 0 <= j - off[d] < nrows.
//
// That is A^T x for the (nrows, ne) banded A stored as (data, off), read
// from A's own layout: no transposed copy `dataT` is needed.  Replaces the
// Pallas TPU kernel porotpu/ops/pallas_dia.py:_rkernel_call (wrapper
// `rmv`), which took f32 only, nrows % 128 == 0 and ne == nrows.  This one
// takes f32 and f64, any nrows and any ne (the Transposed coupling blocks
// built with a row embedding have ne != nrows).
//
// Bound: device memory, as K1: one multiply-add per stored value of
// `data`, read once.  The first design (one thread per output j, 256-thread
// blocks) had K1's occupancy problem and, in addition, read data[d, j -
// off[d]] misaligned by off[d] on every diagonal: 28-38% of the bound, and
// slower than cuSPARSE in f64.  This design is K1's frame (dia_tile.cuh)
// over the output tile [j0, j0 + tile):
//   - for diagonal d the tile's inputs are the rows [j0 - off, j0 - off +
//     tile) of data[d] and of x, both shifted by off.  Each lane copies the
//     aligned 16-byte chunks that cover them (data past L1, x through L1)
//     with cp.async into a two-stage ring a warp, multiplies them
//     chunk by chunk, and the warp shifts the products into the output
//     lanes with shuffles: every load is aligned, and one shift serves
//     both streams;
//   - the warps split the diagonals, a cluster splits them further on
//     operators with few tiles (ops/dia_kernel.py:launch_plan), and the
//     partial tiles are summed in a fixed order: deterministic, no atomics;
//   - the next diagonal is in flight while this one is used, holding no
//     registers;
//   - x is read through L1, not staged: its window per tile is the tile
//     plus the offset span (thousands of rows on the solve's operators);
//   - rows are formed in 64 bits, so no offset can overflow the bounds test.
// The TPU kernel's slot accumulation, lane rotations and per-tile edge
// slabs exist only for its (T, 128) VMEM tile and are not carried over.

#include "dia_tile.cuh"

namespace {

using namespace porotpu;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
dia_rmv_kernel(const T* __restrict__ data, const int* __restrict__ offsets, int nd,
               int64_t nrows, const T* __restrict__ x, int64_t ne, T* __restrict__ y,
               int cluster) {
  using Rg = Ring<T>;
  constexpr int V = Rg::V, R = Rg::R;
  const int lane = threadIdx.x & 31;
  int64_t j0;
  int d_lo, d_hi;
  tile_and_group(nd, cluster, Rg::kRows, &j0, &d_lo, &d_hi);
  const Rg ring = warp_ring<T>();

  T acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[r][k] = T(0);

  pipeline(
      d_hi - d_lo,
      [&](int slot, int k) {  // copy the chunks of data[d] and x covering rows j0 - off ..
        const int d = d_lo + k;
        const T* row = data + static_cast<int64_t>(d) * nrows;
        const int64_t b = (j0 - __ldg(offsets + d)) & ~static_cast<int64_t>(V - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int64_t c = b + V * (32 * r + lane);
          copy_chunk<kVec, false>(ring.data(slot, r, lane), row, c, nrows);
          copy_chunk<kVec, true>(ring.x(slot, r, lane), x, c, nrows);
        }
        if (lane == 31) {
          copy_chunk<kVec, false>(ring.extra(slot, 0), row, b + V * 32 * R, nrows);
          copy_chunk<kVec, true>(ring.extra(slot, 1), x, b + V * 32 * R, nrows);
        }
      },
      [&](int slot, int k) {  // multiply, shift the products into place, accumulate
        const int s = static_cast<int>((j0 - __ldg(offsets + d_lo + k)) & (V - 1));
        T dv[R][V], xv[R][V], de[V], xe[V], p[R][V], pe[V], ps[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          read_chunk(ring.data(slot, r, lane), dv[r]);
          read_chunk(ring.x(slot, r, lane), xv[r]);
#pragma unroll
          for (int q = 0; q < V; ++q) p[r][q] = dv[r][q] * xv[r][q];
        }
        read_chunk(ring.extra(slot, 0), de);
        read_chunk(ring.extra(slot, 1), xe);
#pragma unroll
        for (int q = 0; q < V; ++q) pe[q] = de[q] * xe[q];
        shift(p, pe, s, lane, ps);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < V; ++q) acc[r][q] += ps[r][q];
      });
  reduce_store(acc, j0, ne, cluster, y);
}

template <typename T>
int launch(const void* data, const void* offsets, int nd, int nrows, const void* x, int ne,
           void* y, void* stream, int vec, int warps, int cluster, int stages, int tile) {
  auto kernel = vec ? dia_rmv_kernel<T, true> : dia_rmv_kernel<T, false>;
  return launch_tiles<T>(kernel, ne, warps, cluster, tile, stages, stream,
                         static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
                         static_cast<int64_t>(nrows),
                         static_cast<const T*>(x), static_cast<int64_t>(ne),
                         static_cast<T*>(y), cluster);
}

}  // namespace

// Plain C interface for ctypes.  `vec`, `warps`, `cluster`, `stages` and
// `tile` come from ops/dia_kernel.py:launch_plan (the last two must match
// dia_tile.cuh); vec needs data and x 16-byte aligned and
// nrows a multiple of 16 / sizeof(T).  Each returns the
// cudaError_t of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int porotpu_dia_rmv_f32(const void* data, const void* offsets, int nd,
                                   int nrows, const void* x, int ne, void* y,
                                   void* stream, int vec, int warps, int cluster,
                                   int stages, int tile) {
  return launch<float>(data, offsets, nd, nrows, x, ne, y, stream, vec, warps, cluster,
                       stages, tile);
}

extern "C" int porotpu_dia_rmv_f64(const void* data, const void* offsets, int nd,
                                   int nrows, const void* x, int ne, void* y,
                                   void* stream, int vec, int warps, int cluster,
                                   int stages, int tile) {
  return launch<double>(data, offsets, nd, nrows, x, ne, y, stream, vec, warps, cluster,
                        stages, tile);
}
