// Tropical (min-plus) matrix product for Hopper (sm_90a):
//     Z[i, j] = min_k X[i, k] + Y[k, j]
//
// Replaces the Pallas TPU kernel src/repro/kernels/tropical_apsp/kernel.py
// (_minplus_kernel, launched by minplus_matmul).  Repeated squaring with it
// gives all-pairs hop distances: the port's route-table build runs its
// hop-distance step through it (repro_torch/core/routing.py).
//
// What bounds it on an H100.  Each output needs k adds and k mins: 2*m*n*k
// float32 operations on the CUDA cores (min-plus has no tensor-core form),
// against 4*(m*k + k*n + m*n) bytes of device memory.  At the route table's
// shape (n = 153 nodes on leaf-spine-xl) that is 7.2 MFLOP and 0.28 MB: the
// operation bound is about 0.1 us and the byte bound below it, so one
// launch (several microseconds) is far above both and the kernel is
// launch-bound there.  At n >= 1024 it becomes bound by the CUDA cores.
//
// Design.  One 32x32 tile of Z per block of 32x8 threads; each thread keeps
// four running minima in registers.  Along k, 32x32 tiles of X and Y are
// staged through shared memory (X padded by one column), so a warp reads one
// X element as a broadcast and 32 consecutive Y elements.  Ragged edges are
// masked in the kernel by loading +inf, which leaves every minimum unchanged
// (inf + a = inf for every a that is not -inf or NaN); the host pads
// nothing.  Inputs must hold no NaN and no -inf.
//
// Exactness.  Each a + b rounds once and min is exact, so there is no
// reduction-order freedom: the result equals the plain PyTorch version
// (x[:, :, None] + y[None]).amin(1) bit for bit.  No multiply appears, so
// no multiply-add can be contracted.
//
// Known divergence from the Pallas kernel: that kernel starts its
// accumulator at BIG = 3.4e38, so an unreachable pair comes out as 3.4e38.
// This one starts at +inf, as the plain version and the numpy hop distances
// do (the route table tests np.isfinite on the distances).
//
// Left for later: int32 hop counts with the DPX __viaddmin_s32, larger
// tiles, and one launch for all squarings.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kThreadRows = kTile / kRowsPerThread;  // blockDim.y

__global__ void __launch_bounds__(kTile * kThreadRows)
minplus_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ z, int m, int k, int n) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ys[kTile][kTile];
  const float inf = __int_as_float(0x7f800000);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tx;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = inf;

  for (int k0 = 0; k0 < k; k0 += kTile) {
#pragma unroll
    for (int r = ty; r < kTile; r += kThreadRows) {
      const int gi = row0 + r;
      const int gk = k0 + tx;
      xs[r][tx] = (gi < m && gk < k) ? x[(size_t)gi * k + gk] : inf;
      const int yk = k0 + r;
      ys[r][tx] = (yk < k && col < n) ? y[(size_t)yk * n + col] : inf;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float b = ys[kk][tx];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        acc[r] = fminf(acc[r], xs[ty + r * kThreadRows][kk] + b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gi = row0 + ty + r * kThreadRows;
    if (gi < m && col < n) z[(size_t)gi * n + col] = acc[r];
  }
}

}  // namespace

// x: [m, k], y: [k, n], z: [m, n], all float32, contiguous, row-major, on
// the device.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int minplus_f32(const float* x, const float* y, float* z, int m,
                           int k, int n, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 block(kTile, kThreadRows);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  minplus_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, m, k, n);
  return static_cast<int>(cudaGetLastError());
}
