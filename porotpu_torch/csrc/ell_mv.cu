// Padded-row (ELL) sparse matrix-vector product for Hopper (sm_90a).
//
//   y[i] = sum_j data[i, j] * x[cols[i, j]],   i in [0, n), j in [0, width),
//
// over the row-major (n, width) values and int32 column indices, pad slots
// included (their value is zero, their column the row's first).  A x runs
// on A's layout (data, cols); A^T x on the transposed layout built with the
// matrix on the host (dataT, colsT), so no product scatters and none needs
// atomics.  See porotpu_torch/ops/sparse.py: ELL, its launch EllLaunch and
// its plain version ell_mv_ref.
//
// Replaces no TPU kernel: porotpu's ELL product (porotpu/ops/sparse.py:
// ELL.matvec) is a plain jnp gather, left to XLA.  The port ran it as three
// torch kernels (index, mul, sum), each writing or reading an (n, width)
// temporary, with int64 columns.  This kernel is one launch that reads the
// values and the int32 columns once and writes y once.
//
// Bound: device memory.  A product streams n * width * (sizeof(T) + 4)
// bytes of values and columns and does one multiply-add per slot; x is
// gathered through the read-only cache, where its rows are reused across
// neighbouring rows of the matrix.  Design (times on an H100, f64, the L2
// flushed before each launch):
//   - a group of G lanes (G a power of two, 2 to 32) takes a row; lane g
//     reads the slots g, g + G, g + 2G, ..., so a group's reads of a row
//     are consecutive addresses, coalesced.  group_for picks G from the
//     width alone, the power of two nearest above width / kUnroll: a
//     9-wide coupling block takes 4 lanes a row, 8 rows a warp; the 90- to
//     741-wide rows a warp each.  Of the groups 4 to 32, it timed best or
//     within 10% of the best on every operator shape of the benchmark;
//   - each lane runs passes of kUnroll slots: it loads the pass's values
//     and columns, then gathers their x, then adds, so 2 * kUnroll loads
//     are in flight a lane; slots past the row are masked, so a row
//     shorter than a pass still issues its loads together (the 206,763 x
//     90 prolongator: 67% of the bound with an unmasked tail loop, 86%
//     masked).  2 slots a pass timed slower, 8 at most 3% faster in f64
//     and up to 20% slower in f32;
//   - the values and columns are read once: they bypass L1
//     (ld.global.nc.L1::no_allocate), which then holds x.  L1-allocating
//     loads timed 3% slower on that prolongator and 5% faster on its
//     stored transpose (16,422 x 741);
//   - deterministic: each lane adds its slots in ascending order, then the
//     group's partial sums go through a fixed xor-shuffle tree.  The order
//     depends on (width, G) alone: two runs are equal bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// a read-once load: through the non-coherent path, not allocated in L1
__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double load_once(const double* p) {
  double v;
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int load_once(const int* p) {
  int v;
  asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
ell_mv_kernel(const T* __restrict__ data, const int* __restrict__ cols, int64_t n, int width,
              const T* __restrict__ x, T* __restrict__ y) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int lane = threadIdx.x & (G - 1);
  // a group past the last row runs no slot but still joins the shuffles
  const int end = row < n ? width : 0;
  const T* d = data + row * width;
  const int* c = cols + row * width;
  T acc = T(0);
  // passes of kUnroll slots a lane: every load of a pass is issued before
  // the first multiply-add; the slots past the row are masked
  for (int j0 = lane; j0 < end; j0 += kUnroll * G) {
    T dv[kUnroll], xv[kUnroll];
    int cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * G;
      dv[u] = j < end ? load_once(d + j) : T(0);
      cv[u] = j < end ? load_once(c + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = cv[u] >= 0 ? __ldg(x + cv[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * G < end) acc = fma(dv[u], xv[u], acc);
    }
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(kFull, acc, s, G);
  if (lane == 0 && row < n) y[row] = acc;
}

template <typename T, int G>
int launch_group(const T* data, const int* cols, int n, int width, const T* x, T* y,
                 cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(n) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  ell_mv_kernel<T, G><<<blocks, kThreads, 0, stream>>>(data, cols, n, width, x, y);
  return static_cast<int>(cudaGetLastError());
}

// lanes a row: the power of two, 2 to 32, nearest above width / kUnroll,
// so that every lane has a full pass of a row where the row allows it
// (9 wide: 4 lanes; 48 and 50: 16; 90 and wider: a warp)
int group_for(int width) {
  int g = 2;
  while (g < 32 && g * kUnroll < width) g *= 2;
  return g;
}

template <typename T>
int launch(const void* data, const void* cols, int n, int width, const void* x, int n_in,
           void* y, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return n == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (n_in == 0 || width == 0) {  // no slot or nothing to gather: y = 0
    return static_cast<int>(cudaMemsetAsync(y, 0, static_cast<size_t>(n) * sizeof(T), s));
  }
  const auto* d = static_cast<const T*>(data);
  const auto* c = static_cast<const int*>(cols);
  const auto* xv = static_cast<const T*>(x);
  auto* yv = static_cast<T*>(y);
  switch (group_for(width)) {
    case 2: return launch_group<T, 2>(d, c, n, width, xv, yv, s);
    case 4: return launch_group<T, 4>(d, c, n, width, xv, yv, s);
    case 8: return launch_group<T, 8>(d, c, n, width, xv, yv, s);
    case 16: return launch_group<T, 16>(d, c, n, width, xv, yv, s);
    case 32: return launch_group<T, 32>(d, c, n, width, xv, yv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes.  data (n, width) and cols (n, width, int32,
// every entry in [0, n_in)) row-major on the device, x (n_in,), y (n,).
// Each returns the cudaError_t of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int porotpu_ell_mv_f32(const void* data, const void* cols, int n, int width,
                                  const void* x, int n_in, void* y, void* stream) {
  return launch<float>(data, cols, n, width, x, n_in, y, stream);
}

extern "C" int porotpu_ell_mv_f64(const void* data, const void* cols, int n, int width,
                                  const void* x, int n_in, void* y, void* stream) {
  return launch<double>(data, cols, n, width, x, n_in, y, stream);
}
