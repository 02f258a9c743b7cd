// Mamba1 selective scan for Hopper (sm_90a):
//     h_t = a_t * h_{t-1} + b_t    (elementwise over [D, N], in order over t)
//     y_t[d] = sum_n h_t[d, n] * c_t[n]
// in float32, with two C entry points that share one device-side recurrence:
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
// tick (S = 1, h0 = the cache's state).
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
// Design (simple first).  One thread per (channel d, state n); N (a power
// of two that divides 32) lanes of a warp own one channel, and each keeps
// its h in one register for the whole sequence: the TPU kernel's carry
// across its sequential chunk grid becomes a loop over t inside the block.
// Blocks of 128 threads cover 128 / N channels of one batch row
// (grid: channels x batch).  The loop walks t in tiles of 8 steps, the
// next tile's inputs loaded into registers while the current one is
// computed (dt[t, d] and x[t, d] once per channel, broadcast across its
// lanes; bmat, cmat and the Pallas entry's a, b, c coalesced).  The loads
// are unconditional, on clamped indices: a load behind a per-step branch
// cannot be hoisted, and each one then waits out its own trip to memory.
// Per step: the dependent FMA, then the N-lane sum of h * c by
// __shfl_xor_sync, and lane 0 of the channel writes y[t, d].  exp is the
// accurate expf (no fast math).  Lanes past D (the ragged edge) compute on
// channel 0's inputs and write nothing, so every lane takes part in the
// shuffles and no input is padded on the host.  A chunked parallel scan
// across blocks and a shared-memory B/C tile are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 8;
constexpr unsigned kFull = 0xffffffffu;

// Each input type loads one tile of kTile steps of a lane's inputs into
// registers (load: plain loads, nothing waits on them) and turns step j of
// a loaded tile into (a_t, b_t, c_t) (step).  td indexes [B, S, D] and tn
// [B, S, N] at the tile's step j.
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

struct FusedInputs {
  const float* dt;     // [B, S, D]
  const float* x;      // [B, S, D]
  const float* bmat;   // [B, S, N]
  const float* cmat;   // [B, S, N]
  float a;             // a_neg[d, n] of this lane

  struct Tile {
    float dt[kTile], x[kTile], b[kTile], c[kTile];
  };

  __device__ __forceinline__ void load(Tile& tl, int j, long long td,
                                       long long tn, int, int) const {
    tl.dt[j] = dt[td];
    tl.x[j] = x[td];
    tl.b[j] = bmat[tn];
    tl.c[j] = cmat[tn];
  }

  __device__ __forceinline__ void step(const Tile& tl, int j, float& decay,
                                       float& drive, float& cc) const {
    decay = expf(tl.dt[j] * a);
    drive = (tl.dt[j] * tl.x[j]) * tl.b[j];
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
__global__ void __launch_bounds__(kThreads)
    fused_scan_kernel(FusedInputs in, const float* a_neg, const float* h0,
                      float* y, float* h_last, int s, int d_total) {
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * (kThreads / N) + threadIdx.x / N;
  const bool live = d < d_total;
  const int dc = live ? d : 0;  // lanes past D read channel 0's state
  const long long hi = ((long long)blockIdx.y * d_total + dc) * N + n;
  in.a = a_neg[(long long)dc * N + n];
  float h = h0[hi];
  h = scan_lane<N>(in, h, blockIdx.y, s, d, d_total, n, live, y);
  if (live) h_last[hi] = h;
}

template <int N>
void launch_pallas(const PallasInputs& in, float* y, int bsz, int s, int d,
                   cudaStream_t stream) {
  const dim3 grid((d + kThreads / N - 1) / (kThreads / N), bsz);
  pallas_scan_kernel<N><<<grid, kThreads, 0, stream>>>(in, y, s, d);
}

// The fused entry's state and outputs.
struct Out {
  const float* a_neg;  // [D, N]
  const float* h0;     // [B, D, N]
  float* y;            // [B, S, D]
  float* h_last;       // [B, D, N]
};

template <int N>
void launch_fused(const FusedInputs& in, const Out& out, int bsz, int s,
                  int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads / N - 1) / (kThreads / N), bsz);
  fused_scan_kernel<N><<<grid, kThreads, 0, stream>>>(
      in, out.a_neg, out.h0, out.y, out.h_last, s, d);
}

bool sizes_ok(int bsz, int s, int d) {
  return bsz >= 1 && bsz < 65536 && s >= 1 && d >= 1;
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
  const FusedInputs in{dt, x, bmat, cmat, 0.f};
  const Out out{a_neg, h0, y, h_last};
  switch (n) {
    case 1: launch_fused<1>(in, out, bsz, s, d, stream); break;
    case 2: launch_fused<2>(in, out, bsz, s, d, stream); break;
    case 4: launch_fused<4>(in, out, bsz, s, d, stream); break;
    case 8: launch_fused<8>(in, out, bsz, s, d, stream); break;
    case 16: launch_fused<16>(in, out, bsz, s, d, stream); break;
    case 32: launch_fused<32>(in, out, bsz, s, d, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
