// Flash attention (forward) for Hopper (sm_90a):
//     O = softmax(Q K^T * scale + mask) V
// with GQA (query head h reads kv head h / (H / KV)), an optional causal
// mask whose query rows start at q_offset, and m / l / acc in float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_bhsd through the GQA wrapper
// ops.py::flash_attention).  On the port's serving path it is the prefill's
// attention (repro_torch/models/attention.py, backend "kernel"): qwen3-4b
// at q [1, S, 32, 128], k/v [1, S, 8, 128] in bf16, causal, q_offset 0.
//
// What bounds it on an H100.  Causal attention over S positions does
// 4 * B * H * Dh * S(S+1)/2 operations against 2 * B * Dh * (2 * S * H +
// 2 * S * KV) bytes of bf16: at S = 2048 that is 34.4 GFLOP against 42 MB,
// about 820 operations per byte, so the card's bound is the tensor cores'
// 989 TFLOP/s bf16: 0.035 ms.  This design does both products with scalar
// float32 FMAs on the CUDA cores (67 TFLOP/s), which puts its own floor
// near 0.53 ms; shared-memory reads and the softmax's shuffles sit on top.
// At the serving bucket (S = 32) the work is 8.7 MFLOP and one launch's
// latency is the whole cost.
//
// Design (simple first; moving the two products to wgmma with TMA-fed
// tiles is later work).  One block of 8 warps owns 64 query rows of one
// (batch, head); each warp owns 8 rows.  The block walks the key axis in
// tiles of 32 keys, in order, and stops at the last tile that touches the
// causal diagonal of its last row, so tiles wholly above the diagonal are
// never loaded.  Q (64 x Dh) and each K / V tile (32 x Dh) are staged in
// shared memory as float32, read straight from [B, S, H, Dh] through the
// strides the wrapper passes: no transposes and no host padding.  Scores:
// lane j of a warp owns key j of the tile and computes its 8 rows' dot
// products with scalar float32 FMAs (K rows padded by one float, so the
// 32 lanes hit 32 banks).  The online softmax runs per row across the
// warp with shuffles: running max m and sum l stay in registers,
// replicated over the lanes, and each lane keeps the output columns
// d = lane + 32 i of its 8 rows in registers.  P goes through shared
// memory to the P V product, in which lane d reads V[j][d].  All
// arithmetic is IEEE float32 on both the bf16 and the float32 path (no
// TF32, no tensor cores yet), so the float32 path meets a 2e-5 tolerance.
//
// Masks follow the Pallas kernel: a masked score is -1e30 (NEG_INF), not
// -inf; keys past Skv and, when causal, keys after the row's position
// (q_offset + row) are masked in the kernel; l is floored at 1e-30 before
// the division.  Every row sees key 0 in its first tile (q_offset >= 0),
// so a masked score never stands as a row's running maximum at the end.
// Query rows past Sq are computed on zeros and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBq = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBk = 32;                     // keys per tile: one per lane
constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int b, sq, skv, h, kv;
  long long q_sb, q_ss, q_sh;  // element strides of q: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  int q_offset;
  float scale;
};

template <int DH>
constexpr size_t smem_floats() {
  return size_t(kBq) * DH + size_t(kBk) * (DH + 1) + size_t(kBk) * DH +
         size_t(kBq) * kBk;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int kDpl = DH >= 32 ? DH / 32 : 1;  // output columns per lane
  constexpr int kKs = DH + 1;                   // padded K row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [kBq][DH]
  float* ks = qs + kBq * DH;      // [kBk][DH + 1]
  float* vs = ks + kBk * kKs;     // [kBk][DH]
  float* ps = vs + kBk * DH;      // [kBq][kBk]

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int kvi = hi / (a.h / a.kv);
  const int q0 = blockIdx.x * kBq;

  const T* qb = q + bi * a.q_sb + hi * a.q_sh;
  const T* kb = k + bi * a.k_sb + kvi * a.k_sh;
  const T* vb = v + bi * a.v_sb + kvi * a.v_sh;

  for (int i = tid; i < kBq * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i % DH;
    const int qi = q0 + r;
    qs[i] = qi < a.sq ? to_f32(qb[qi * a.q_ss + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (a.skv + kBk - 1) / kBk;
  if (a.causal) {
    const long long last = (long long)a.q_offset + q0 + kBq - 1;
    const long long lim = last / kBk + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }

  const int row0 = warp * kRowsPerWarp;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // q staged; the previous tile's K, V and P are read
    for (int i = tid; i < kBk * DH; i += kThreads) {
      const int j = i / DH;
      const int d = i % DH;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < a.skv) {
        kx = to_f32(kb[kj * a.k_ss + d]);
        vx = to_f32(vb[kj * a.v_ss + d]);
      }
      ks[j * kKs + d] = kx;
      vs[j * DH + d] = vx;
    }
    __syncthreads();

    // scores of this lane's key against the warp's 8 rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = ks + lane * kKs;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (row0 + r) * DH + d);
        s[r] = fmaf(qv.x, k0v, s[r]);
        s[r] = fmaf(qv.y, k1v, s[r]);
        s[r] = fmaf(qv.z, k2v, s[r]);
        s[r] = fmaf(qv.w, k3v, s[r]);
      }
    }

    // online softmax, one row at a time across the warp
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long qpos = (long long)a.q_offset + q0 + row0 + r;
      const bool ok = kpos < a.skv && (!a.causal || qpos >= kpos);
      const float sv = ok ? s[r] * a.scale : kNegInf;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      ps[(row0 + r) * kBk + lane] = p;
#pragma unroll
      for (int c = 0; c < kDpl; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    // acc += P V over this tile: lane owns columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kBk; j += 4) {
      float vv[4][kDpl];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kDpl; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < DH ? vs[(j + jj) * DH + d] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + (row0 + r) * kBk + j);
#pragma unroll
        for (int c = 0; c < kDpl; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  // out[b, qi, h, :] = acc / max(l, 1e-30), contiguous [B, Sq, H, Dh]
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= a.sq) continue;
    const float denom = fmaxf(l[r], kLFloor);
    T* orow = o + ((long long)(bi * a.sq + qi) * a.h + hi) * DH;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) store_out(orow + d, acc[r][c] / denom);
    }
  }
}

template <typename T, int DH>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kBq - 1) / kBq, a.b * a.h);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int skv, int h, int kv, long long q_sb,
               long long q_ss, long long q_sh, long long k_sb,
               long long k_ss, long long k_sh, long long v_sb,
               long long v_ss, long long v_sh, int causal, int q_offset,
               float scale) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.b = b; a.sq = sq; a.skv = skv; a.h = h; a.kv = kv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.causal = causal; a.q_offset = q_offset; a.scale = scale;
  return a;
}

}  // namespace

// q: [B, Sq, H, Dh], k / v: [B, Skv, KV, Dh] with unit stride along Dh and
// the given element strides for batch, sequence and head; o: [B, Sq, H, Dh]
// contiguous, in q's type.  Dh is 16, 32, 64 or 128; H is a multiple of KV;
// q_offset >= 0.  Launches on `stream` and returns cudaGetLastError()
// (0 on success, cudaErrorInvalidValue for another Dh); it does not
// synchronise.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* o, int b,      \
                      int sq, int skv, int h, int kv, int dh,               \
                      long long q_sb, long long q_ss, long long q_sh,       \
                      long long k_sb, long long k_ss, long long k_sh,       \
                      long long v_sb, long long v_ss, long long v_sh,       \
                      int causal, int q_offset, float scale, void* stream) { \
    if (b <= 0 || sq <= 0 || h <= 0) return 0;                              \
    if (skv <= 0 || kv <= 0 || h % kv != 0 || q_offset < 0)                 \
      return (int)cudaErrorInvalidValue;                                    \
    const Args a = make_args(q, k, v, o, b, sq, skv, h, kv, q_sb, q_ss,     \
                             q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,      \
                             causal, q_offset, scale);                      \
    return dispatch<T>(a, dh, stream);                                      \
  }

FLASH_ENTRY(flash_attention_f32, float)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16)
