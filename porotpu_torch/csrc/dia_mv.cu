// Banded (DIA) matrix-vector product for Hopper (sm_90a): kernel K1.
//
//   y[i] = sum_d data[d, i] * xe[i + off[d]],   i in [0, nrows),
//   with xe read as zero outside [0, ne).
//
// Replaces the Pallas TPU kernel porotpu/ops/pallas_dia.py:_kernel_call
// (wrapper `mv`).  It carries every forward banded product of the solve
// on (data, offsets), and the f32 transposes on the transposed layout
// (dataT, -offsets); f64 transposes run K2 (dia_rmv.cu), see
// porotpu_torch/ops/dia.py.
//
// Bound: device memory.  A product streams the nd * nrows values of
// `data` once and does one multiply-add per value; x (at most a few
// hundred KB) stays in L1/L2 across the diagonals.  The first design (one
// thread per row, 256-thread blocks) kept too few bytes in flight: on 59136
// rows about 448 resident threads an SM with four 4-byte loads each
// (42% of the bound in f32), and on the 4480-row coarse level 18 blocks
// for 132 SMs (8-10%).  This design (frame in dia_tile.cuh):
//   - tiles of 256 rows (f32) or 128 (f64), the warps of a block splitting
//     the diagonals, and
//     on operators with few tiles a thread-block cluster of up to 8 blocks
//     splitting them further, summed through distributed shared memory in
//     one launch; ops/dia_kernel.py:launch_plan picks the warps and the
//     cluster so that every operator of the solve fills the card;
//   - each lane copies its two chunks of data[d, tile] (past L1) and the
//     aligned chunks of x that cover their window (through L1) with 16-byte
//     cp.async into a two-stage ring a warp, so the next diagonal is in
//     flight while this one is used, without holding registers;
//   - x[i + off : i + off + V] is misaligned by off: the warp shifts the
//     aligned chunks into place with shuffles (no misaligned sector, one
//     copy per chunk).  x is not staged as a whole window: the offset spans
//     of the solve's operators are thousands of rows, far wider than a
//     128-row tile, so only the chunks a diagonal needs are copied;
//   - the offsets are read from global memory (L1) where a diagonal is
//     copied and where it is used: nothing is staged, so nd has no limit;
//   - sums in the operand type, in a fixed order (deterministic).
// Lengths that are not multiples of V, or an unaligned x, take the same
// code with masked 4- or 8-byte loads (kVec false).

#include "dia_tile.cuh"

namespace {

using namespace porotpu;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
dia_mv_kernel(const T* __restrict__ data, const int* __restrict__ offsets, int nd,
              int64_t nrows, const T* __restrict__ xe, int64_t ne, T* __restrict__ y,
              int cluster) {
  using Rg = Ring<T>;
  constexpr int V = Rg::V, R = Rg::R;
  const int lane = threadIdx.x & 31;
  int64_t i0;
  int d_lo, d_hi;
  tile_and_group(nd, cluster, Rg::kRows, &i0, &d_lo, &d_hi);
  const Rg ring = warp_ring<T>();

  T acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[r][k] = T(0);

  pipeline(
      d_hi - d_lo,
      [&](int slot, int k) {  // copy data[d, tile] and the chunks of x covering its window
        const int d = d_lo + k;
        const T* row = data + static_cast<int64_t>(d) * nrows;
        const int64_t b = (i0 + __ldg(offsets + d)) & ~static_cast<int64_t>(V - 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          copy_chunk<kVec, false>(ring.data(slot, r, lane), row, i0 + V * (32 * r + lane), nrows);
          copy_chunk<kVec, true>(ring.x(slot, r, lane), xe, b + V * (32 * r + lane), ne);
        }
        if (lane == 31) copy_chunk<kVec, true>(ring.extra(slot, 0), xe, b + V * 32 * R, ne);
      },
      [&](int slot, int k) {  // shift x into place and accumulate
        const int s = static_cast<int>((i0 + __ldg(offsets + d_lo + k)) & (V - 1));
        T dv[R][V], xv[R][V], xx[V], xs[R][V];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          read_chunk(ring.data(slot, r, lane), dv[r]);
          read_chunk(ring.x(slot, r, lane), xv[r]);
        }
        read_chunk(ring.extra(slot, 0), xx);
        shift(xv, xx, s, lane, xs);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < V; ++q) acc[r][q] = fma(dv[r][q], xs[r][q], acc[r][q]);
      });
  reduce_store(acc, i0, nrows, cluster, y);
}

template <typename T>
int launch(const void* data, const void* offsets, int nd, int nrows, const void* xe, int ne,
           void* y, void* stream, int vec, int warps, int cluster, int stages, int tile) {
  auto kernel = vec ? dia_mv_kernel<T, true> : dia_mv_kernel<T, false>;
  return launch_tiles<T>(kernel, nrows, warps, cluster, tile, stages, stream,
                         static_cast<const T*>(data), static_cast<const int*>(offsets), nd,
                         static_cast<int64_t>(nrows),
                         static_cast<const T*>(xe), static_cast<int64_t>(ne),
                         static_cast<T*>(y), cluster);
}

}  // namespace

// Plain C interface for ctypes.  `vec`, `warps`, `cluster`, `stages` and
// `tile` come from ops/dia_kernel.py:launch_plan (the last two must match
// dia_tile.cuh); vec needs data and xe 16-byte aligned and nrows, ne
// multiples of 16 / sizeof(T).  Each returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int porotpu_dia_mv_f32(const void* data, const void* offsets, int nd,
                                  int nrows, const void* xe, int ne, void* y,
                                  void* stream, int vec, int warps, int cluster,
                                  int stages, int tile) {
  return launch<float>(data, offsets, nd, nrows, xe, ne, y, stream, vec, warps, cluster,
                       stages, tile);
}

extern "C" int porotpu_dia_mv_f64(const void* data, const void* offsets, int nd,
                                  int nrows, const void* xe, int ne, void* y,
                                  void* stream, int vec, int warps, int cluster,
                                  int stages, int tile) {
  return launch<double>(data, offsets, nd, nrows, xe, ne, y, stream, vec, warps, cluster,
                        stages, tile);
}

extern "C" const char* porotpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
