// Banded (DIA) matvec on a pre-padded input for Hopper (sm_90a): kernel K3.
//
//   y[i] = sum_d data[d, i] * xpad[i + lo + off[d]],   i in [0, nrows),
//
// where xpad holds x with lo = max(0, -min off) zeros before it and
// hi = max(0, max off) zeros after it, so every read is in bounds and the
// inner loop has no bounds test.  f32, as the TPU kernel.
//
// Replaces the Pallas TPU prototype tools/pallas_dia.py:pallas_dia_matvec,
// whose (T, 128) row tiles and lane rotations do not carry over (nor its
// rule that nrows be a multiple of 128 * T).  It is K1
// (porotpu_torch/csrc/dia_mv.cu) without the per-diagonal mask, and
// answers whether that mask costs anything on this card; its entry point
// is porotpu_torch/tools/dia_microbench.py.
//
// Bound: device memory: one multiply-add per value of `data`, read once.
// Design as K1: one thread per output row looping over the diagonals, the
// read of data[d, i] coalesced along i, the offsets (shifted by lo) staged
// once per block in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
dia_mv_padded_kernel(const float* __restrict__ data,
                     const int* __restrict__ offsets, int nd, int nrows,
                     const float* __restrict__ xpad, int lo,
                     float* __restrict__ y) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < nd; d += blockDim.x) s_off[d] = offsets[d] + lo;
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  const float* col = data + i;
  const float* xi = xpad + i;
  float acc = 0.0f;
#pragma unroll 4
  for (int d = 0; d < nd; ++d) {
    acc += col[static_cast<int64_t>(d) * nrows] * __ldg(xi + s_off[d]);
  }
  y[i] = acc;
}

}  // namespace

// Plain C interface for ctypes: returns the cudaError_t of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int porotpu_dia_mv_padded_f32(const void* data, const void* offsets,
                                         int nd, int nrows, const void* xpad,
                                         int lo, void* y, void* stream) {
  const int blocks = (nrows + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(nd) * sizeof(int);
  dia_mv_padded_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(offsets), nd,
      nrows, static_cast<const float*>(xpad), lo, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}
