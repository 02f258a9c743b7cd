// Tropical (min-plus) matrix product and all-pairs shortest paths for
// Hopper (sm_90a):
//     Z[i, j] = min_k X[i, k] + Y[k, j]
//     D_{s+1} = D_s (min,+) D_s, until D stops changing or `steps` run out.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tropical_apsp/kernel.py
// (_minplus_kernel, launched by minplus_matmul) and the host loop of
// src/repro/kernels/tropical_apsp/ops.py::apsp that squares with it.  The
// port's route-table build runs its hop-distance step here
// (repro_torch/core/routing.py): one launch of apsp_f32 per route table.
//
// What bounds it on an H100.  Min-plus has no tensor-core form.  Each
// (add, min) pair is two float32 instructions, FADD and FMNMX, and no
// instruction fuses them.  The CUDA cores issue 128 lanes a clock on each
// of 132 SMs at 1.98 GHz, 3.35e13 instructions a second, so one n^3 product
// needs at least 2 n^3 / 3.35e13 s: 0.21 us at n = 153, 51 ms at n = 9473
// (fat_tree(32)).  An APSP needs ceil(log2 diameter) products; the early
// stop below runs one more, which confirms that nothing changes.  The
// bytes, 4 n^2 in and 4 n^2 out, are far below that, so the kernel is bound
// by the cores' issue rate, except at small n where one launch and a grid
// barrier take longer than the arithmetic.
//
// Design.
// * One tile routine (tile_minplus): a block computes one BM x BN tile of
//   Z; each thread keeps a TM x TN micro-tile of running minima in
//   registers, starting at +inf.  K-slabs of BK columns of X (stored
//   transposed) and BK rows of Y are staged in shared memory by cp.async,
//   two slabs in flight.  A thread reads its TM + TN operands of one k step
//   as 16-byte vector loads (its rows and columns split in two halves of
//   the tile, so a quarter warp's loads hit 32 distinct banks), then issues
//   TM x TN (add, min) pairs: at TM = TN = 8, 4 loads for 128
//   instructions, so FADD/FMNMX, not LDS, set the pace.  Ragged edges are
//   masked in the kernel by storing +inf into shared memory, which leaves
//   every minimum unchanged; the host pads nothing.
// * Four tiles (16, 32, 64, 128 square, micro-tiles 2, 2, 4, 8); the host
//   picks the largest whose grid has a tile for every SM
//   (kernels/tropical_apsp/kernel.py::tile_for): 16 x 16 tiles at n = 153
//   give 100 blocks where 32 x 32 gave 25.
// * minplus_f32, the Pallas contract of one product, launches one block
//   per tile.  apsp_f32 runs the whole APSP in one cooperative launch: a
//   persistent grid (blocks an SM from the occupancy calculator times the
//   SMs, at most one block per tile) walks the output tiles of each
//   squaring, ping-ponging between two buffers (true squarings, not
//   in-place relaxation, so the result at any `steps` is the reference's),
//   with a grid-wide barrier between squarings.  A block whose tile differs
//   from its input (bit for bit) sets that squaring's "changed" flag (one
//   int per squaring, zeroed by the caller); after the barrier every block
//   reads it and all stop together when nothing changed: a settled matrix
//   squares to itself, so stopping changes no bit.  The number of
//   squarings run is written to ws[1]; the result always lands in `out`.
// * The barrier is a counter in global memory (ws[0], zeroed by the
//   caller): thread 0 of each block fences, adds one and spins with an
//   acquire load until the count reaches (squaring + 1) x blocks.  The
//   cooperative launch guarantees that every block is resident; a launch
//   the card cannot hold is refused (the caller raises).  A block that
//   waits more than 20 s traps rather than hang the card.
//
// Exactness.  Each a + b rounds once and min is exact, so there is no
// reduction-order freedom: the result equals the plain PyTorch version
// (x[:, :, None] + y[None]).amin(1) bit for bit, at any tile.  No multiply
// appears, so no multiply-add can be contracted.  Inputs must hold no NaN
// and no -inf.
//
// Known divergence from the Pallas kernel: that kernel starts its
// accumulator at BIG = 3.4e38, so an unreachable pair comes out as 3.4e38.
// This one starts at +inf, as the plain version and the numpy hop distances
// do (the route table tests np.isfinite on the distances).
//
// Left for later.  At n = 153 a squaring costs microseconds for ~0.07 us
// of arithmetic: a latency chain of k-slabs, the epilogue's loads and the
// grid barrier whose parts are not measured (longer k-slabs did not
// shorten it).  At large n the 128 tile spills under its 2-blocks-an-SM
// register cap and stays near 58 % of its bound; register double-buffering
// of the fragments, 16-byte global loads where rows are 16-byte aligned
// and tiles ordered for L2 reuse are the next steps.  Int32 hop counts on
// DPX (__viaddmin_s32, one instruction a pair) were built and measured on
// an H100 80GB HBM3 at 700 W: 1.15x faster at fat_tree(32), whose route
// table no scenario builds, and no faster at n = 153, so they are not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float inf_f32() {
  return __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

template <int BM_, int TM_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BM_;   // output tile
  static constexpr int TM = TM_, TN = TM_;   // a thread's micro-tile
  static constexpr int BK = 16;              // k-slab
  static constexpr int TX = BN / TN, TY = BM / TM;
  static constexpr int kThreads = TX * TY;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int VEC = TM < 4 ? TM : 4;  // elements a vector load
  static constexpr int CH = TM / VEC;          // vector loads a k step
  static constexpr int LD = BM + 4;            // padded shared-memory row
  static_assert(BM % TM == 0 && TM % VEC == 0, "tile shape");
  static_assert((BM * BK) % kThreads == 0, "slab loads divide evenly");
  static_assert(LD % 4 == 0, "rows stay 16-byte aligned");
};

using Tile16 = Tile<16, 2, 1>;    //  64 threads
using Tile32 = Tile<32, 2, 1>;    // 256 threads
using Tile64 = Tile<64, 4, 1>;    // 256 threads
using Tile128 = Tile<128, 8, 2>;  // 256 threads, <= 128 registers

template <class C>
struct __align__(16) Smem {
  float xs[2][C::BK][C::LD];  // X slab, transposed: xs[k][i]
  float ys[2][C::BK][C::LD];  // Y slab: ys[k][j]
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Stage X[row0:row0+BM, k0:k0+BK] (transposed) and Y[k0:k0+BK,
// col0:col0+BN] into shared memory; entries past the edges are +inf.
template <class C>
__device__ __forceinline__ void load_slab(float (*xs)[C::LD],
                                          float (*ys)[C::LD], const float* x,
                                          const float* y, int m, int k,
                                          int n, int row0, int col0,
                                          int k0) {
#pragma unroll
  for (int r = 0; r < C::BM * C::BK / C::kThreads; ++r) {
    const int e = threadIdx.x + r * C::kThreads;
    const int i = e / C::BK, kk = e % C::BK;  // consecutive threads: along k
    const int gi = row0 + i, gk = k0 + kk;
    if (gi < m && gk < k)
      cp_async4(&xs[kk][i], x + (size_t)gi * k + gk);
    else
      xs[kk][i] = inf_f32();
  }
#pragma unroll
  for (int r = 0; r < C::BK * C::BN / C::kThreads; ++r) {
    const int e = threadIdx.x + r * C::kThreads;
    const int kk = e / C::BN, j = e % C::BN;
    const int gk = k0 + kk, gj = col0 + j;
    if (gk < k && gj < n)
      cp_async4(&ys[kk][j], y + (size_t)gk * n + gj);
    else
      ys[kk][j] = inf_f32();
  }
}

// A thread's VEC * CH operands of one k step: CH vector loads of VEC
// elements, STRIDE elements apart.
template <int VEC, int CH, int STRIDE>
__device__ __forceinline__ void load_frag(float (&v)[VEC * CH],
                                          const float* p) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if constexpr (VEC == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c * STRIDE);
      v[c * 4 + 0] = q.x;
      v[c * 4 + 1] = q.y;
      v[c * 4 + 2] = q.z;
      v[c * 4 + 3] = q.w;
    } else if constexpr (VEC == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + c * STRIDE);
      v[c * 2 + 0] = q.x;
      v[c * 2 + 1] = q.y;
    } else {
      v[c] = p[c * STRIDE];
    }
  }
}

// Row (or column) of a thread's micro-tile entry r inside the tile.
template <class C>
__device__ __forceinline__ int frag_offset(int r, int t) {
  return (r / C::VEC) * (C::BM / C::CH) + t * C::VEC + r % C::VEC;
}

// acc = X[row0:row0+BM, :] (min,+) Y[:, col0:col0+BN], this thread's part.
// Ends with a barrier, so the block may reuse `sm` at once.
template <class C>
__device__ __forceinline__ void tile_minplus(Smem<C>& sm, const float* x,
                                             const float* y, int m, int k,
                                             int n, int row0, int col0,
                                             float (&acc)[C::TM][C::TN]) {
  const int tx = threadIdx.x % C::TX;
  const int ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = inf_f32();

  const int slabs = (k + C::BK - 1) / C::BK;
  load_slab<C>(sm.xs[0], sm.ys[0], x, y, m, k, n, row0, col0, 0);
  cp_async_commit();
  for (int s = 0; s < slabs; ++s) {
    if (s + 1 < slabs) {
      load_slab<C>(sm.xs[(s + 1) & 1], sm.ys[(s + 1) & 1], x, y, m, k, n,
                   row0, col0, (s + 1) * C::BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*xs)[C::LD] = sm.xs[s & 1];
    const float(*ys)[C::LD] = sm.ys[s & 1];
#pragma unroll
    for (int kk = 0; kk < C::BK; ++kk) {
      float a[C::TM], b[C::TN];
      load_frag<C::VEC, C::CH, C::BM / C::CH>(a, &xs[kk][ty * C::VEC]);
      load_frag<C::VEC, C::CH, C::BN / C::CH>(b, &ys[kk][tx * C::VEC]);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j)
          acc[i][j] = fminf(a[i] + b[j], acc[i][j]);  // FADD, then FMNMX
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// one product: one block per tile
// ---------------------------------------------------------------------------

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
minplus_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ z, int m, int k, int n) {
  __shared__ Smem<C> sm;
  const int tiles_n = (n + C::BN - 1) / C::BN;
  const int row0 = (blockIdx.x / tiles_n) * C::BM;
  const int col0 = (blockIdx.x % tiles_n) * C::BN;
  float acc[C::TM][C::TN];
  tile_minplus<C>(sm, x, y, m, k, n, row0, col0, acc);
  const int tx = threadIdx.x % C::TX;
  const int ty = threadIdx.x / C::TX;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int gi = row0 + frag_offset<C>(i, ty);
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int gj = col0 + frag_offset<C>(j, tx);
      if (gi < m && gj < n) z[(size_t)gi * n + gj] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the whole APSP: one cooperative launch, a grid barrier between squarings
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Every block of the grid arrives, then waits until `target` arrivals in
// all (the counter only grows: the s-th barrier waits for s x gridDim.x).
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's writes before its arrival
    atomicAdd(count, 1u);
    const unsigned long long t0 = global_ns();
    while (load_acquire(count) < target) {
      __nanosleep(64);
      if (global_ns() - t0 > 20000000000ull) __trap();
    }
  }
  __syncthreads();
}

// adj, out, tmp: [n, n]; ws: int32 [2 + steps], zeroed by the caller:
// ws[0] the barrier's counter, ws[1] the squarings run (written here),
// ws[2 + s] squaring s's "changed" flag.
template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
apsp_kernel(const float* adj, float* out, float* tmp, int* ws, int n,
            int steps) {
  __shared__ Smem<C> sm;
  unsigned* count = reinterpret_cast<unsigned*>(ws);
  int* changed = ws + 2;
  const int tiles_n = (n + C::BN - 1) / C::BN;
  const int tiles = tiles_n * tiles_n;
  const int tx = threadIdx.x % C::TX;
  const int ty = threadIdx.x / C::TX;

  const float* src = adj;
  int ran = 0;
  bool in_tmp = false;
  for (int s = 0; s < steps; ++s) {
    float* dst = (s & 1) ? tmp : out;  // squaring s reads src, writes dst
    int diff = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int row0 = (t / tiles_n) * C::BM;
      const int col0 = (t % tiles_n) * C::BN;
      float acc[C::TM][C::TN];
      tile_minplus<C>(sm, src, src, n, n, n, row0, col0, acc);
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const int gi = row0 + frag_offset<C>(i, ty);
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          const int gj = col0 + frag_offset<C>(j, tx);
          if (gi < n && gj < n) {
            const size_t at = (size_t)gi * n + gj;
            diff |= __float_as_uint(acc[i][j]) != __float_as_uint(src[at]);
            dst[at] = acc[i][j];
          }
        }
      }
    }
    if (__syncthreads_or(diff) && threadIdx.x == 0) atomicOr(&changed[s], 1);
    grid_barrier(count, (unsigned)(s + 1) * gridDim.x);
    ran = s + 1;
    src = dst;
    in_tmp = (s & 1) != 0;
    if (*reinterpret_cast<volatile int*>(&changed[s]) == 0) {
      // dst equals src: when dst is tmp, src (squaring s - 1's output) is
      // out, since squaring 0 writes out
      in_tmp = false;
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ws[1] = ran;
  if (in_tmp) {  // ran out of steps on an odd count: the result is in tmp
    const size_t total = (size_t)n * n;
    for (size_t e = (size_t)blockIdx.x * C::kThreads + threadIdx.x; e < total;
         e += (size_t)gridDim.x * C::kThreads)
      out[e] = tmp[e];
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

enum Entry { kMinplusF32 = 0, kApspF32 = 1 };

template <class C>
const void* entry_fn(int entry) {
  switch (entry) {
    case kMinplusF32:
      return reinterpret_cast<const void*>(minplus_kernel<C>);
    case kApspF32:
      return reinterpret_cast<const void*>(apsp_kernel<C>);
  }
  return nullptr;
}

// `tile` indexes the tile shapes: 0 -> 16, 1 -> 32, 2 -> 64, 3 -> 128.
const void* kernel_fn(int entry, int tile, int* threads) {
  switch (tile) {
    case 0: *threads = Tile16::kThreads; return entry_fn<Tile16>(entry);
    case 1: *threads = Tile32::kThreads; return entry_fn<Tile32>(entry);
    case 2: *threads = Tile64::kThreads; return entry_fn<Tile64>(entry);
    case 3: *threads = Tile128::kThreads; return entry_fn<Tile128>(entry);
  }
  return nullptr;
}

int tile_size(int tile) { return 16 << tile; }

}  // namespace

// x: [m, k], y: [k, n], z: [m, n], all float32, contiguous, row-major, on
// the device; `tile` as in kernel_fn.  Launches one block per output tile
// on `stream` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
extern "C" int minplus_f32(const float* x, const float* y, float* z, int m,
                           int k, int n, int tile, void* stream) {
  int threads = 0;
  const void* fn = kernel_fn(kMinplusF32, tile, &threads);
  if (fn == nullptr || m <= 0 || n <= 0 || k <= 0)
    return cudaErrorInvalidValue;
  const int bm = tile_size(tile);
  const long long tiles = (long long)((m + bm - 1) / bm) * ((n + bm - 1) / bm);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  void* args[] = {&x, &y, &z, &m, &k, &n};
  const cudaError_t err = cudaLaunchKernel(
      fn, dim3(static_cast<unsigned>(tiles)), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refusal
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// All-pairs shortest paths of adj [n, n] in one cooperative launch of
// `grid` persistent blocks: at most `steps` squarings, stopping after the
// first that changes nothing.  out, tmp: [n, n] float32 scratch; the
// result lands in out.  ws: int32 [2 + steps], zeroed; ws[1] receives the
// squarings run.  Returns the launch's error (a grid the card cannot hold
// at once is refused: cudaErrorCooperativeLaunchTooLarge).
extern "C" int apsp_f32(const float* adj, float* out, float* tmp, int* ws,
                        int n, int steps, int tile, int grid, void* stream) {
  int threads = 0;
  const void* fn = kernel_fn(kApspF32, tile, &threads);
  if (fn == nullptr || n <= 0 || steps <= 0 || grid <= 0)
    return cudaErrorInvalidValue;
  void* args[] = {&adj, &out, &tmp, &ws, &n, &steps};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(threads), args, 0,
      static_cast<cudaStream_t>(stream));
  // a refused launch also records its error as the last one: clear it, so
  // that the next launch does not report it again
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Registers a thread, static and dynamic shared memory (bytes) a block,
// resident blocks an SM and threads a block of one entry (0 minplus_f32,
// 1 apsp_f32) at one tile, from cudaFuncGetAttributes and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int tropical_apsp_kernel_info(int entry, int tile, int* out) {
  int threads = 0;
  const void* fn = kernel_fn(entry, tile, &threads);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = 0;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}
