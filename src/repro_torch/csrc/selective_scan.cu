// Mamba1 selective scan for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t    (elementwise over [D, N], in order over t)
//     y_t[d] = sum_n h_t[d, n] * c_t[n]
// in float32, with two C entry points:
//
//   selective_scan_f32        a, b [B, S, D, N], c [B, S, N] -> y [B, S, D]
//                             (h_0 = 0): the Pallas kernel's own contract.
//   selective_scan_fused_f32  dt, x [B, S, D], bmat, cmat [B, S, N],
//                             a_neg [D, N], h0 [B, D, N]
//                             -> y [B, S, D], h_last [B, D, N], with
//                             a_t = exp(dt * a_neg) and b_t = (dt * x) * bmat
//                             computed in the loop, so no [B, S, D, N]
//                             tensor reaches device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan/kernel.py
// (_scan_kernel, launched by selective_scan), and on the port's Mamba path
// the jnp scan that the reference's model runs in its place
// (src/repro/models/ssm.py::_fused_scan, which computes the same recurrence
// and contraction with the discretisation inside each chunk).  On the
// serving path of falcon-mamba-7b the fused entry runs once per layer at
// every prefill (B = 1, S = the bucket, D = 8192, N = 16) and every decode
// tick (B = 4, S = 1, h0 = the cache's state).
//
// What bounds it on an H100.  The fused entry moves dt, x and y (12 bytes
// per (t, d)) and does one exp per (t, d, n): at S = 2048, D = 8192,
// N = 16 that is 201 MB, 0.060 ms at 3.35 TB/s, against 268 M exps, 0.064
// ms on the special-function units (16 a clock on each of 132 SMs), so
// the exps set its bound.  The Pallas-contract entry reads a and b whole
// (2 x 1.07 GB at that shape): 0.66 ms, bound by bytes.  At the serving
// bucket and the decode tick the work is a few MB and one launch's latency
// is the whole cost.
//
// Fused entry.  A thread owns NPT states of one channel in registers (all
// N for N <= 4, 4 of 16 at falcon-mamba's N = 16, 8 of 32), so 1, 2 or 4
// threads share a channel.  A block of 128 threads covers CPB = 128 /
// threads-a-channel channels of one batch row (32 at N = 16).  Per tile of
// 16 steps the block stages the rows of dt and x of its channels
// (coalesced across d) and the B and C rows that all its channels share
// into shared memory by cp.async, two tiles in flight, so each input is
// read from device memory once.  A thread's share of y_t goes to shared
// memory (no shuffle in the step), and after the tile the shares of each
// channel are summed and y is stored coalesced across the block's
// channels.  exp(dt A) is exp2f(dt * (A log2 e)), A pre-scaled once
// (accurate exp2f, no fast math).
//
// One pass over the whole sequence, no chunks across it.  Chunks (each
// chunk's end state from h = 0, the carries combined by exp(A sum dt), then
// each chunk rerun, or one pass with decoupled look-back) pay only where
// the batch rows and channels leave SMs idle; both compute each chunk's
// exps twice.  At falcon-mamba's shapes B x D x threads-a-channel is at
// least 32768 threads, 256 blocks of 128, so every SM already has a block
// (the waves below), and the second look at each step would be pure cost.
//
// Waves at falcon-mamba's shapes (D = 8192, N = 16: 4 threads a channel,
// 56 registers a thread and 20 KB of shared memory a block of 128, so 9
// blocks an SM, 1188 on the card): the decode tick [4, 1] is 1024 blocks
// and the serving bucket [1, 32] 256, each one wave; the long prefill
// [1, 2048] is 256 blocks, one wave of 2 blocks (8 warps) an SM, each a
// 2048-step loop with 4 independent states a thread to hide latency.
//
// Pallas-contract entry (off the serving path; its earlier design).  One
// thread per (channel d, state n); N (a power of two that divides 32)
// lanes of a warp own one channel, and each keeps its h in one register
// for the whole sequence.  Blocks of 128 threads cover 128 / N channels of
// one batch row (grid: channels x batch).  The loop walks t in tiles of 8
// steps, the next tile's inputs loaded into registers while the current
// one is computed.  The loads are unconditional, on clamped indices: a
// load behind a per-step branch cannot be hoisted, and each one then waits
// out its own trip to memory.  Per step: the dependent FMA, then the
// N-lane sum of h * c by __shfl_xor_sync, and lane 0 of the channel writes
// y[t, d].  exp is the accurate expf (no fast math).  Lanes past D compute
// on channel 0's inputs and write nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 8;
constexpr unsigned kFull = 0xffffffffu;

// The Pallas contract's inputs: load puts one tile of kTile steps of a
// lane's inputs into registers (plain loads, nothing waits on them) and
// step turns step j of a loaded tile into (a_t, b_t, c_t).  td indexes
// [B, S, D] and tn [B, S, N] at the tile's step j.
struct PallasInputs {
  const float* a;  // [B, S, D, N]
  const float* b;  // [B, S, D, N]
  const float* c;  // [B, S, N]

  struct Tile {
    float a[kTile], b[kTile], c[kTile];
  };

  __device__ __forceinline__ void load(Tile& tl, int j, long long td,
                                       long long tn, int n,
                                       int n_state) const {
    const long long i = td * n_state + n;
    tl.a[j] = a[i];
    tl.b[j] = b[i];
    tl.c[j] = c[tn];
  }

  __device__ __forceinline__ void step(const Tile& tl, int j, float& decay,
                                       float& drive, float& cc) const {
    decay = tl.a[j];
    drive = tl.b[j];
    cc = tl.c[j];
  }
};

// Load the tile that starts at t0.  Steps past S read step S - 1 and
// lanes past D read channel 0 (the callers mask both), so every load is
// in bounds and none sits behind a branch: they all issue back to back.
template <int N, class In>
__device__ __forceinline__ void load_tile(const In& in, typename In::Tile& tl,
                                          int t0, long long row_d,
                                          long long row_n, int s,
                                          int d_total, int n) {
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const long long t = min(t0 + j, s - 1);
    in.load(tl, j, row_d + t * d_total, row_n + t * N, n, N);
  }
}

// The recurrence of one lane over the whole sequence; returns the final h.
// row_d / row_n index [B, S, D] / [B, S, N] at step 0 of this lane's batch
// row and channel (channel 0 for a lane past D).  The next tile's loads
// are issued before the current tile is computed, so their latency hides
// behind its arithmetic.
template <int N, class In>
__device__ __forceinline__ float scan_lane(const In& in, float h, int bi,
                                           int s, int d, int d_total,
                                           int n, bool live, float* y) {
  const long long row_d = (long long)bi * s * d_total + (live ? d : 0);
  const long long row_n = (long long)bi * s * N + n;
  typename In::Tile cur, nxt;
  load_tile<N>(in, cur, 0, row_d, row_n, s, d_total, n);
  for (int t0 = 0; t0 < s; t0 += kTile) {
    if (t0 + kTile < s) {
      load_tile<N>(in, nxt, t0 + kTile, row_d, row_n, s, d_total, n);
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const int t = t0 + j;
      if (t >= s) break;  // uniform across the block
      float decay, drive, cc;
      in.step(cur, j, decay, drive, cc);
      h = fmaf(decay, h, drive);
      float v = h * cc;
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      if (n == 0 && live) y[row_d + (long long)t * d_total] = v;
    }
    cur = nxt;
  }
  return h;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    pallas_scan_kernel(PallasInputs in, float* y, int s, int d_total) {
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * (kThreads / N) + threadIdx.x / N;
  scan_lane<N>(in, 0.f, blockIdx.y, s, d, d_total, n, d < d_total, y);
}

template <int N>
void launch_pallas(const PallasInputs& in, float* y, int bsz, int s, int d,
                   cudaStream_t stream) {
  const dim3 grid((d + kThreads / N - 1) / (kThreads / N), bsz);
  pallas_scan_kernel<N><<<grid, kThreads, 0, stream>>>(in, y, s, d);
}

// ---------------------------------------------------------------------------
// The fused entry: one thread per channel (or up to 4), one pass over S
// ---------------------------------------------------------------------------

constexpr int kSteps = 16;  // time steps of one shared-memory tile

// States a thread and threads a channel: N = 1, 2, 4 -> one thread holds all
// N; N = 8 -> 2 threads of 4; N = 16 -> 4 of 4; N = 32 -> 4 of 8.
template <int N>
struct Split {
  static constexpr int NPT = N <= 4 ? N : (N / 4 > 4 ? N / 4 : 4);
  static constexpr int TPC = N / NPT;
  static constexpr int CPB = kThreads / TPC;  // channels a block
};

struct FusedArgs {
  const float* dt;     // [B, S, D]
  const float* x;      // [B, S, D]
  const float* bmat;   // [B, S, N]
  const float* cmat;   // [B, S, N]
  const float* a_neg;  // [D, N]
  const float* h0;     // [B, D, N]
  float* y;            // [B, S, D]
  float* h_last;       // [B, D, N]
  int s, d;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int N>
struct FusedTile {
  float dt[kSteps][Split<N>::CPB];
  float x[kSteps][Split<N>::CPB];
  float b[kSteps][N];
  float c[kSteps][N];
};

// Stage steps [t0, t0 + kSteps) of the block's channels [d0, d0 + CPB) and
// of B and C into `tl` by cp.async; entries past S or D are zeros.
template <int N>
__device__ __forceinline__ void stage(FusedTile<N>& tl, const FusedArgs& a,
                                      int bi, int d0, int t0) {
  constexpr int CPB = Split<N>::CPB;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kSteps * CPB / kThreads; ++r) {
    const int i = tid + r * kThreads;
    const int j = i / CPB, ch = i % CPB;
    const bool ok = t0 + j < a.s && d0 + ch < a.d;
    const long long off =
        ok ? ((long long)bi * a.s + t0 + j) * a.d + d0 + ch : 0;
    cp_async4(&tl.dt[j][ch], a.dt + off, ok);
    cp_async4(&tl.x[j][ch], a.x + off, ok);
  }
#pragma unroll
  for (int r = 0; r < (kSteps * N + kThreads - 1) / kThreads; ++r) {
    const int i = tid + r * kThreads;
    if (i >= kSteps * N) break;
    const int j = i / N, n = i % N;
    const bool ok = t0 + j < a.s;
    const long long off = ok ? ((long long)bi * a.s + t0 + j) * N + n : 0;
    cp_async4(&tl.b[j][n], a.bmat + off, ok);
    cp_async4(&tl.c[j][n], a.cmat + off, ok);
  }
}

template <int K>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
}

template <int K>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = src[i];
  }
}

// Block (x, b) scans channels [x CPB, (x + 1) CPB) of batch row b over the
// whole sequence from h0, writing y and h_last.
template <int N>
__global__ void __launch_bounds__(kThreads)
    fused_scan_kernel(FusedArgs a) {
  using Sp = Split<N>;
  constexpr int NPT = Sp::NPT;
  constexpr int TPC = Sp::TPC;
  __shared__ __align__(16) FusedTile<N> tiles[2];
  // each thread's share of y_t (its NPT states' h * c) for one tile
  __shared__ float y_part[kSteps][Sp::CPB][TPC];

  const int tid = threadIdx.x;
  const int ch = tid / TPC;
  const int sub = tid % TPC;
  const int n0 = sub * NPT;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * Sp::CPB;
  const int d = d0 + ch;
  const bool live = d < a.d;
  const int dc = live ? d : a.d - 1;  // lanes past D read the last channel

  // the first tile's copies go out before anything else is read
  stage<N>(tiles[0], a, bi, d0, 0);
  cp_async_commit();

  // A in the log2 domain: exp(dt A) = exp2(dt (A log2 e))
  float a2[NPT];
  load_vec<NPT>(a2, a.a_neg + (long long)dc * N + n0);
#pragma unroll
  for (int i = 0; i < NPT; ++i) a2[i] *= 1.4426950408889634f;

  float h[NPT];
  load_vec<NPT>(h, a.h0 + ((long long)bi * a.d + dc) * N + n0);

  int buf = 0;
  for (int t0 = 0; t0 < a.s; t0 += kSteps) {
    if (t0 + kSteps < a.s) {
      stage<N>(tiles[buf ^ 1], a, bi, d0, t0 + kSteps);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const FusedTile<N>& tl = tiles[buf];
    const int steps = min(kSteps, a.s - t0);
#pragma unroll 4
    for (int j = 0; j < steps; ++j) {
      const float dtv = tl.dt[j][ch];
      const float dx = dtv * tl.x[j][ch];
      float bv[NPT], cv[NPT];
      load_vec<NPT>(bv, &tl.b[j][n0]);
      load_vec<NPT>(cv, &tl.c[j][n0]);
      float yv = 0.f;
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        h[i] = fmaf(exp2f(dtv * a2[i]), h[i], dx * bv[i]);
        yv = fmaf(h[i], cv[i], yv);
      }
      y_part[j][ch][sub] = yv;
    }
    __syncthreads();  // tiles[buf] read, and the tile's y shares written
    // y of the tile's steps, the channel's shares summed, stored coalesced
    // across the block's channels
#pragma unroll
    for (int r = 0; r < kSteps * Sp::CPB / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int j = i / Sp::CPB, c = i % Sp::CPB;
      if (j < steps && d0 + c < a.d) {
        float yv = y_part[j][c][0];
#pragma unroll
        for (int k = 1; k < TPC; ++k) yv += y_part[j][c][k];
        a.y[((long long)bi * a.s + t0 + j) * a.d + d0 + c] = yv;
      }
    }
    buf ^= 1;
  }

  if (live) {
    store_vec<NPT>(a.h_last + ((long long)bi * a.d + d) * N + n0, h);
  }
}

template <int N>
int launch_fused(const FusedArgs& a, int bsz, cudaStream_t stream) {
  const int blocks_d = (a.d + Split<N>::CPB - 1) / Split<N>::CPB;
  fused_scan_kernel<N><<<dim3(blocks_d, bsz), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool sizes_ok(int bsz, int s, int d) {
  return bsz >= 1 && bsz < 65536 && s >= 1 && d >= 1;
}

// The kernels at state size n, for occupancy.
const void* pallas_kernel(int n) {
  switch (n) {
    case 1: return reinterpret_cast<const void*>(pallas_scan_kernel<1>);
    case 2: return reinterpret_cast<const void*>(pallas_scan_kernel<2>);
    case 4: return reinterpret_cast<const void*>(pallas_scan_kernel<4>);
    case 8: return reinterpret_cast<const void*>(pallas_scan_kernel<8>);
    case 16: return reinterpret_cast<const void*>(pallas_scan_kernel<16>);
    case 32: return reinterpret_cast<const void*>(pallas_scan_kernel<32>);
    default: return nullptr;
  }
}

const void* fused_kernel(int n) {
  switch (n) {
    case 1: return reinterpret_cast<const void*>(fused_scan_kernel<1>);
    case 2: return reinterpret_cast<const void*>(fused_scan_kernel<2>);
    case 4: return reinterpret_cast<const void*>(fused_scan_kernel<4>);
    case 8: return reinterpret_cast<const void*>(fused_scan_kernel<8>);
    case 16: return reinterpret_cast<const void*>(fused_scan_kernel<16>);
    case 32: return reinterpret_cast<const void*>(fused_scan_kernel<32>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int selective_scan_f32(const float* a, const float* b,
                                  const float* c, float* y, int bsz, int s,
                                  int d, int n, cudaStream_t stream) {
  if (!sizes_ok(bsz, s, d)) return cudaErrorInvalidValue;
  const PallasInputs in{a, b, c};
  switch (n) {
    case 1: launch_pallas<1>(in, y, bsz, s, d, stream); break;
    case 2: launch_pallas<2>(in, y, bsz, s, d, stream); break;
    case 4: launch_pallas<4>(in, y, bsz, s, d, stream); break;
    case 8: launch_pallas<8>(in, y, bsz, s, d, stream); break;
    case 16: launch_pallas<16>(in, y, bsz, s, d, stream); break;
    case 32: launch_pallas<32>(in, y, bsz, s, d, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int selective_scan_fused_f32(const float* dt, const float* x,
                                        const float* bmat, const float* cmat,
                                        const float* a_neg, const float* h0,
                                        float* y, float* h_last, int bsz,
                                        int s, int d, int n,
                                        cudaStream_t stream) {
  if (!sizes_ok(bsz, s, d)) return cudaErrorInvalidValue;
  const FusedArgs a{dt, x, bmat, cmat, a_neg, h0, y, h_last, s, d};
  switch (n) {
    case 1: return launch_fused<1>(a, bsz, stream);
    case 2: return launch_fused<2>(a, bsz, stream);
    case 4: return launch_fused<4>(a, bsz, stream);
    case 8: return launch_fused<8>(a, bsz, stream);
    case 16: return launch_fused<16>(a, bsz, stream);
    case 32: return launch_fused<32>(a, bsz, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Occupancy of one kernel at state size n (kernel 0: the Pallas-contract
// entry's, 1: the fused entry's): out[0] registers a thread, out[1] static
// and out[2] dynamic shared memory (bytes) a block, out[3] resident blocks
// an SM, out[4] threads a block.  Returns a CUDA error.
extern "C" int selective_scan_kernel_info(int kernel, int n, int* out) {
  const void* fn = kernel == 0   ? pallas_kernel(n)
                   : kernel == 1 ? fused_kernel(n)
                                 : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = 0;
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}
