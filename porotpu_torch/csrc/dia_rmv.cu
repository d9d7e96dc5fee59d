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
// Bound: device memory, as K1 (porotpu_torch/csrc/dia_mv.cu): one
// multiply-add per stored value of `data`, read once.  Design:
//   - one thread per output j, looping over the diagonals in ascending
//     order; for a fixed d the row i = j - off[d] runs along j, so the
//     reads of data[d, i] and x[i] are coalesced;
//   - the offsets are staged once per block in shared memory;
//   - every output is written by one thread: no atomics, and the sum has
//     one fixed order, so the result is deterministic;
//   - i is formed in 64 bits, so no offset can overflow the bounds test.
// The TPU kernel's slot accumulation, lane rotations and per-tile edge
// slabs exist only for its (T, 128) VMEM tile and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_rmv_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
               int nd, int nrows, const T* __restrict__ x, int ne,
               T* __restrict__ y) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= ne) return;
  T acc = T(0);
#pragma unroll 4
  for (int d = 0; d < nd; ++d) {
    const int64_t i = static_cast<int64_t>(j) - s_off[d];
    if (i >= 0 && i < nrows) {
      acc += __ldg(data + static_cast<int64_t>(d) * nrows + i) * __ldg(x + i);
    }
  }
  y[j] = acc;
}

template <typename T>
int launch(const void* data, const void* offsets, int nd, int nrows,
           const void* x, int ne, void* y, void* stream) {
  const int blocks = (ne + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(nd) * sizeof(int);
  dia_rmv_kernel<T><<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd, nrows,
      static_cast<const T*>(x), ne, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int porotpu_dia_rmv_f32(const void* data, const void* offsets, int nd,
                                   int nrows, const void* x, int ne, void* y,
                                   void* stream) {
  return launch<float>(data, offsets, nd, nrows, x, ne, y, stream);
}

extern "C" int porotpu_dia_rmv_f64(const void* data, const void* offsets, int nd,
                                   int nrows, const void* x, int ne, void* y,
                                   void* stream) {
  return launch<double>(data, offsets, nd, nrows, x, ne, y, stream);
}
