// Flash attention (forward) for Hopper (sm_90a):
//     O = softmax(Q K^T * scale + mask) V
// with GQA (query head h reads kv head h / (H / KV)), an optional causal
// mask whose query rows start at q_offset, and m / l / O in float32.
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
// 989 TFLOP/s bf16: 0.035 ms.  At the serving bucket (S = 32) the work is
// 8.7 MFLOP and one launch's latency is the whole cost.
//
// bf16 entry (flash_attention_bf16): both products on the tensor cores by
// wgmma, fed by TMA, in the shape of FlashAttention-3.
//   * One block owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, and one producer warp.  288 threads; at
//     Dh = 128 a consumer thread holds 64 floats of O, 32 of S and 16
//     registers of bf16 P (152 registers a thread, 97 KB of shared
//     memory), so one block fits an SM: its registers set that.  At
//     qwen3-4b's S = 2048 the grid is 16 q-tiles x 32 heads = 512 blocks,
//     3.9 waves of 132.
//   * The producer warp's lane 0 loads the block's Q tile once and then
//     keeps the K and V tiles of 64 keys in flight through a ring of two
//     shared-memory stages, by TMA (cp.async.bulk.tensor, 4-d maps over
//     [B, S, heads, Dh] built on the host for each call from the strides),
//     with a full and an empty mbarrier per stage.  The tiles land in the
//     swizzle that wgmma reads: 128-byte rows (64 columns) for Dh >= 64,
//     64- and 32-byte rows for Dh = 32 and 16.  Rows past Sq or Skv are
//     filled with zeros by the TMA unit: no host padding.
//   * S = Q K^T: wgmma m64n64k16 with Q and K both K-major in shared
//     memory, Dh / 16 of them a tile.  The online softmax runs on the
//     accumulator fragments in registers: each thread holds two rows,
//     their max and sum across the row's four threads by quad shuffles,
//     exp2f with scale * log2(e) folded into the scores.
//   * P is rounded to bf16 in registers (the plain version casts the
//     weights to bf16 before P V too) and is the register A operand of
//     wgmma m64n{Dh}k16 for O += P V, with V read from shared memory as
//     an MN-major (transposed) B operand.  No P goes through shared memory.
//   * Causal: key tiles wholly above the diagonal are never loaded (the
//     loop's bound), and only tiles that cross the diagonal or the ragged
//     Skv edge are masked.  The q-tile index is reversed and put on the
//     grid's slow axis, so the heaviest q-tiles of every head start first
//     and the light ones fill the tail.
//   * A warpgroup issues P V and goes on to the next tile's S = Q K^T
//     without waiting: the wait for S also sees the previous P V done, and
//     only then is that tile's stage handed back to the producer.  The two
//     warpgroups work on the same K/V stage independently, so one runs its
//     softmax while the other's wgmma runs; the copy of the next stage
//     overlaps both.  Two alternatives ran slower on the H100 at S = 2048:
//     tiles of 128 keys (168 registers), and each tile's softmax
//     overlapped with the previous tile's P V (two P buffers, three
//     stages).  setmaxnreg, a pingpong schedule of the two warpgroups and
//     a persistent grid are later work.
//
// float32 entry (flash_attention_f32): scalar IEEE float32 FMAs on the CUDA
// cores (TF32 would miss its 2e-5 tolerance; float32 is not on the serving
// path).  One block of 8 warps owns 64 query rows; key tiles of 32 are
// staged in shared memory through the strides, lane j of a warp owns key j
// of the tile, the online softmax runs across the warp with shuffles, and P
// goes through shared memory to the P V product.
//
// Masks follow the Pallas kernel: a masked score is -1e30 (NEG_INF), not
// -inf; keys past Skv and, when causal, keys after the row's position
// (q_offset + row) are masked in the kernel; l is floored at 1e-30 before
// the division.  Every row sees key 0 in its first tile (q_offset >= 0),
// so a masked score never stands as a row's running maximum at the end.
// Query rows past Sq are computed on zeros and not written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Returned when cuTensorMapEncodeTiled refuses a TMA descriptor (alignment,
// strides).
constexpr int kErrTensorMap = -1;

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

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;             // query rows a block: two warpgroups
constexpr int kBK = 64;              // keys a tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kConsumers = 256;      // threads of the two warpgroups
constexpr int kTcThreads = kConsumers + 32;  // and the producer warp

template <int DH>
struct Tc {
  static constexpr int SW = DH * 2 < 128 ? DH * 2 : 128;  // swizzle, bytes
  static constexpr int AC = SW / 2;          // columns of one swizzle atom
  static constexpr int ATOMS = DH / AC;      // atoms across Dh
  static constexpr int Q_ATOM = kBM * SW;    // bytes of one Q atom
  static constexpr int KV_ATOM = kBK * SW;   // bytes of one K or V atom
  static constexpr int Q_BYTES = Q_ATOM * ATOMS;
  static constexpr int KV_BYTES = KV_ATOM * ATOMS;  // one K (or V) tile
  static constexpr int BAR_OFF = Q_BYTES + kStages * 2 * KV_BYTES;
  // tiles, 2 * kStages + 1 mbarriers, and slack to align the base to 1024
  static constexpr int SMEM = BAR_OFF + 8 * (2 * kStages + 1) + 1024;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-d map (Dh, heads, seq, batch) into shared memory,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int pos, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(pos), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle's layout type.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, int layout) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0..32) = (accumulate ? d : 0) + A B^T: A 64 x 16 and B 64 x 16,
// both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..8) += A B: A 64 x 16 in registers, B 16 x 16 MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n16(float* d,
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..16) += A B: A 64 x 16 in registers, B 16 x 32 MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32(float* d,
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..32) += A B: A 64 x 16 in registers, B 16 x 64 MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d,
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0..64) += A B: A 64 x 16 in registers, B 16 x 128 MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float* d,
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBq = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBk = 32;                     // keys per tile: one per lane

template <int DH>
constexpr size_t smem_floats() {
  return size_t(kBq) * DH + size_t(kBk) * (DH + 1) + size_t(kBk) * DH +
         size_t(kBq) * kBk;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Args a) {
  constexpr int kDpl = DH >= 32 ? DH / 32 : 1;  // output columns per lane
  constexpr int kKs = DH + 1;                   // padded K row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [kBq][DH]
  float* ks = qs + kBq * DH;      // [kBk][DH + 1]
  float* vs = ks + kBk * kKs;     // [kBk][DH]
  float* ps = vs + kBk * DH;      // [kBq][kBk]

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  float* __restrict__ o = static_cast<float*>(a.o);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bi = blockIdx.y / a.h;
  const int hi = blockIdx.y % a.h;
  const int kvi = hi / (a.h / a.kv);
  const int q0 = blockIdx.x * kBq;

  const float* qb = q + bi * a.q_sb + hi * a.q_sh;
  const float* kb = k + bi * a.k_sb + kvi * a.k_sh;
  const float* vb = v + bi * a.v_sb + kvi * a.v_sh;

  for (int i = tid; i < kBq * DH; i += kThreads) {
    const int r = i / DH;
    const int d = i % DH;
    const int qi = q0 + r;
    qs[i] = qi < a.sq ? qb[qi * a.q_ss + d] : 0.f;
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
        kx = kb[kj * a.k_ss + d];
        vx = vb[kj * a.v_ss + d];
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
    float* orow = o + ((long long)(bi * a.sq + qi) * a.h + hi) * DH;
#pragma unroll
    for (int c = 0; c < kDpl; ++c) {
      const int d = lane + 32 * c;
      if (d < DH) orow[d] = acc[r][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 kernel
// ---------------------------------------------------------------------------

template <int DH>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* p,
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16(o, p, db);
  if constexpr (DH == 32) wgmma_rs_n32(o, p, db);
  if constexpr (DH == 64) wgmma_rs_n64(o, p, db);
  if constexpr (DH == 128) wgmma_rs_n128(o, p, db);
}

template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, Args a) {
  using C = Tc<DH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles start on a 1024-byte boundary (the 128-byte pattern's
  // period), whatever the base the runtime gives
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                     // [ATOMS][kBM][SW]
  const uint32_t kv_s = base + C::Q_BYTES;       // [kStages][K, V][ATOMS][kBK][SW]
  const uint32_t bars = base + C::BAR_OFF;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };
  const uint32_t q_bar = bars + 8u * (2 * kStages);

  const int tid = threadIdx.x;
  const int bi = blockIdx.x / a.h;
  const int hi = blockIdx.x % a.h;
  const int kvi = hi / (a.h / a.kv);
  // heaviest causal q-tiles first: the grid's slow axis walks them backwards
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;

  int n_tiles = (a.skv + kBK - 1) / kBK;
  if (a.causal) {
    const long long last = (long long)a.q_offset + q0 + kBM - 1;
    const long long lim = last / kBK + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread issues every copy
    if (tid == kConsumers) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int at = 0; at < C::ATOMS; ++at)
        tma_load(q_s + at * C::Q_ATOM, &qmap, q_bar, at * C::AC, hi, q0, bi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty_bar(s), ((t / kStages) - 1) & 1);
        mbar_expect_tx(full_bar(s), 2 * C::KV_BYTES);
        const uint32_t ks = kv_s + s * 2 * C::KV_BYTES;
        const uint32_t vs = ks + C::KV_BYTES;
#pragma unroll
        for (int at = 0; at < C::ATOMS; ++at) {
          tma_load(ks + at * C::KV_ATOM, &kmap, full_bar(s), at * C::AC, kvi,
                   t * kBK, bi);
          tma_load(vs + at * C::KV_ATOM, &vmap, full_bar(s), at * C::AC, kvi,
                   t * kBK, bi);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64);
  // this thread holds rows r0 and r0 + 8 of them, and in every 8-column
  // block of an accumulator the columns cq and cq + 1
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int row_first = q0 + wg * 64;
  const long long first_pos = (long long)a.q_offset + row_first;
  const long long pos0 = first_pos + r0;
  const long long pos1 = pos0 + 8;
  const float sl2 = a.scale * kLog2e;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint32_t q_wg = q_s + wg * 64 * C::SW;

  // P of the tile whose P V may still run: kept live (fence_regs) until
  // the next tile's wait has seen that product done
  uint32_t pa[kBK / 16][4];
  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(full_bar(s), (t / kStages) & 1);
    const uint32_t ks = kv_s + s * 2 * C::KV_BYTES;
    const uint32_t vs = ks + C::KV_BYTES;

    // S = Q K^T over Dh in steps of 16 (32 bytes of a swizzled row)
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int at = (kk * 16) / C::AC;
      const int within = ((kk * 16) % C::AC) * 2;
      const uint64_t da = wgmma_desc(q_wg + at * C::Q_ATOM + within, 16,
                                     8 * C::SW, C::LAYOUT);
      const uint64_t db = wgmma_desc(ks + at * C::KV_ATOM + within, 16,
                                     8 * C::SW, C::LAYOUT);
      wgmma_ss_n64(sc, da, db, kk > 0);
    }
    wgmma_commit();
    // S of this tile done, and with it the previous tile's P V: its stage
    // goes back to the producer
    wgmma_wait_all();
    fence_regs<kBK / 2>(sc);
    fence_regs<DH / 2>(o);
    fence_regs<kBK / 4>(&pa[0][0]);
    if (t > 0) mbar_arrive(empty_bar((t - 1) % kStages));

    // scores in the log2 domain, masked only on a tile that crosses the
    // diagonal or the ragged Skv edge
    const int k0 = t * kBK;
    const bool edge = k0 + kBK > a.skv ||
                      (a.causal && (long long)k0 + kBK - 1 > first_pos);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v0 = sc[4 * j + e] * sl2;
        float v1 = sc[4 * j + 2 + e] * sl2;
        if (edge) {
          const int key = k0 + 8 * j + cq + e;
          if (key >= a.skv || (a.causal && key > pos0)) v0 = kNegInf;
          if (key >= a.skv || (a.causal && key > pos1)) v1 = kNegInf;
        }
        sc[4 * j + e] = v0;
        sc[4 * j + 2 + e] = v1;
        mx0 = fmaxf(mx0, v0);
        mx1 = fmaxf(mx1, v1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float al0 = exp2f(m0 - mx0);
    const float al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P in bf16, laid out as wgmma's register A operand: for keys
    // [16 kk, 16 kk + 16), {row r0 cols cq.., row r0+8 cols cq..,
    //  row r0 cols cq+8.., row r0+8 cols cq+8..}
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float p00 = exp2f(sc[4 * j] - m0);
      const float p01 = exp2f(sc[4 * j + 1] - m0);
      const float p10 = exp2f(sc[4 * j + 2] - m1);
      const float p11 = exp2f(sc[4 * j + 3] - m1);
      rs0 += p00 + p01;
      rs1 += p10 + p11;
      pa[j / 2][2 * (j % 2)] = pack_bf16(p00, p01);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= al0;
      o[4 * j + 1] *= al0;
      o[4 * j + 2] *= al1;
      o[4 * j + 3] *= al1;
    }

    // O += P V over the tile's keys in steps of 16 rows of V; the product
    // runs on while the next tile's S is issued, and is waited for there
    fence_regs<DH / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t db = wgmma_desc(vs + kk * 16 * C::SW, C::KV_ATOM,
                                     8 * C::SW, C::LAYOUT);
      wgmma_pv<DH>(o, pa[kk], db);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs<DH / 2>(o);

  // out[b, q, h, :] = O / max(l, 1e-30), contiguous [B, Sq, H, Dh]
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, kLFloor);
  const float inv1 = 1.f / fmaxf(l1, kLFloor);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
  const int qa = row_first + r0;
  const int qb = qa + 8;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int d = 8 * j + cq;
    if (qa < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((long long)(bi * a.sq + qa) * a.h + hi) * DH + d) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    }
    if (qb < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((long long)(bi * a.sq + qb) * a.h + hi) * DH + d) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d bf16 map over (Dh, heads, seq, batch) with the given element
// strides, boxes of `cols` x 1 x `rows` x 1, swizzled by `sw` bytes; reads
// past the tensor's edge fill with zeros.
bool make_map(CUtensorMap* map, const void* ptr, int dh, int heads, int seq,
              int batch, long long s_head, long long s_seq, long long s_batch,
              int cols, int rows, int sw) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_seq * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = sw == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_tc(const Args& a, cudaStream_t stream) {
  using C = Tc<DH>;
  if ((a.sq + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, a.q, DH, a.h, a.sq, a.b, a.q_sh, a.q_ss, a.q_sb, C::AC,
                kBM, C::SW) ||
      !make_map(&km, a.k, DH, a.kv, a.skv, a.b, a.k_sh, a.k_ss, a.k_sb,
                C::AC, kBK, C::SW) ||
      !make_map(&vm, a.v, DH, a.kv, a.skv, a.b, a.v_sh, a.v_ss, a.v_sb,
                C::AC, kBK, C::SW)) {
    return kErrTensorMap;
  }
  auto kern = flash_fwd_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.b * a.h, (a.sq + kBM - 1) / kBM);
  kern<<<grid, kTcThreads, C::SMEM, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  auto kern = flash_fwd_f32_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kBq - 1) / kBq, a.b * a.h);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The kernel of one entry point and Dh, with its block size and dynamic
// shared memory; fn is null for a Dh the kernels do not take.
struct KernelRef {
  const void* fn;
  int threads;
  int smem;
};

template <int DH>
KernelRef kernel_ref(bool tensor_cores) {
  if (tensor_cores) {
    return {reinterpret_cast<const void*>(flash_fwd_tc_kernel<DH>),
            kTcThreads, Tc<DH>::SMEM};
  }
  return {reinterpret_cast<const void*>(flash_fwd_f32_kernel<DH>), kThreads,
          (int)(smem_floats<DH>() * sizeof(float))};
}

KernelRef find_kernel(bool tensor_cores, int dh) {
  switch (dh) {
    case 16: return kernel_ref<16>(tensor_cores);
    case 32: return kernel_ref<32>(tensor_cores);
    case 64: return kernel_ref<64>(tensor_cores);
    case 128: return kernel_ref<128>(tensor_cores);
    default: return {nullptr, 0, 0};
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

int dispatch(const Args& a, int dh, bool tensor_cores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return tensor_cores ? launch_tc<16>(a, st) : launch_f32<16>(a, st);
    case 32: return tensor_cores ? launch_tc<32>(a, st) : launch_f32<32>(a, st);
    case 64: return tensor_cores ? launch_tc<64>(a, st) : launch_f32<64>(a, st);
    case 128:
      return tensor_cores ? launch_tc<128>(a, st) : launch_f32<128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Sq, H, Dh], k / v: [B, Skv, KV, Dh] with unit stride along Dh and
// the given element strides for batch, sequence and head; o: [B, Sq, H, Dh]
// contiguous, in q's type.  Dh is 16, 32, 64 or 128; H is a multiple of KV;
// q_offset >= 0.  The bf16 entry also needs 16-byte aligned bases and
// strides (TMA).  Launches on `stream` and returns cudaGetLastError() (0
// on success, cudaErrorInvalidValue for another Dh, -1 when a TMA
// descriptor is refused); it does not synchronise.
#define FLASH_ENTRY(NAME, T, TC)                                             \
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
    return dispatch(a, dh, TC, stream);                                     \
  }

FLASH_ENTRY(flash_attention_f32, float, false)
FLASH_ENTRY(flash_attention_bf16, __nv_bfloat16, true)

// Occupancy of the kernel behind an entry point (tensor_cores: the bf16
// entry, else the float32 one) at head size dh: out[0] registers a thread,
// out[1] static and out[2] dynamic shared memory (bytes) a block, out[3]
// resident blocks an SM, out[4] threads a block.  Returns a CUDA error.
extern "C" int flash_attention_kernel_info(int tensor_cores, int dh,
                                           int* out) {
  const KernelRef ref = find_kernel(tensor_cores != 0, dh);
  if (ref.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ref.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, ref.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ref.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ref.fn,
                                                      ref.threads, ref.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = ref.smem;
  out[3] = blocks;
  out[4] = ref.threads;
  return 0;
}
