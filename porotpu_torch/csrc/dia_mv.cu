// Banded (DIA) matrix-vector product for Hopper (sm_90a).
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
// Bound: device memory.  A product streams nd * nrows values of `data`
// once and does one multiply-add per value; x (at most a few hundred KB)
// stays in L2/L1 across the diagonals.  Design:
//   - one thread per output row, looping over the diagonals, so the
//     read of data[d, i] is coalesced along i for every d;
//   - the offsets are staged once per block in shared memory;
//   - xe[i + off] is read through a bounds mask (no padded copy of x);
//   - the sum is kept in the operand type, as the TPU kernel does.
// Rectangular blocks (ne != nrows) and f32/f64 are handled natively.
// No TMA or tensor cores: there is no reuse of `data` to exploit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_mv_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
              int nd, int nrows, const T* __restrict__ xe, int ne,
              T* __restrict__ y) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  const T* col = data + i;
  T acc = T(0);
#pragma unroll 4
  for (int d = 0; d < nd; ++d) {
    const T v = col[static_cast<int64_t>(d) * nrows];
    const int j = i + s_off[d];
    if (j >= 0 && j < ne) acc += v * __ldg(xe + j);
  }
  y[i] = acc;
}

template <typename T>
int launch(const void* data, const void* offsets, int nd, int nrows,
           const void* xe, int ne, void* y, void* stream) {
  const int blocks = (nrows + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(nd) * sizeof(int);
  dia_mv_kernel<T><<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), nd, nrows,
      static_cast<const T*>(xe), ne, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Each returns the cudaError_t of the launch
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int porotpu_dia_mv_f32(const void* data, const void* offsets, int nd,
                                  int nrows, const void* xe, int ne, void* y,
                                  void* stream) {
  return launch<float>(data, offsets, nd, nrows, xe, ne, y, stream);
}

extern "C" int porotpu_dia_mv_f64(const void* data, const void* offsets, int nd,
                                  int nrows, const void* xe, int ne, void* y,
                                  void* stream) {
  return launch<double>(data, offsets, nd, nrows, xe, ne, y, stream);
}

extern "C" const char* porotpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
