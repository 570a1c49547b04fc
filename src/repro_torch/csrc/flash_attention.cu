// flash_attention.cu — causal (or full) GQA attention forward, bf16 in and
// out, f32 softmax statistics: the prefill attention of the model path.
//
// Replaces src/repro/kernels/flash_attention.py::_fa_kernel (:26,
// pallas_call :95).  Same function: q (B, Hq, Sq, D) against k, v
// (B, Hkv, Skv, D), query head h reading KV head h / (Hq / Hkv); query i
// sits at position q_offset + i and, when causal, sees keys j <= that
// position; masked scores are NEG_INF = -1e30; a running (m, l, acc) in
// f32 over KV tiles (online softmax); KV tiles wholly in the future of a
// query tile are skipped; out = acc / max(l, 1e-30) in bf16.  Unlike the
// Pallas wrapper (which asserts Sq % 128 == 0 and Skv % 128 == 0), a
// ragged tail of Sq or Skv is masked here: rows past Sq are not stored,
// keys past Skv score NEG_INF and their tile rows are loaded as zeros.
//
// Bound: operations.  4 * B * Hq * D flops for every (query, key) pair the
// mask keeps (QK^T and PV), over 989 TFLOP/s bf16 dense; at the prefill's
// B 4, Hq 16, Sq = Skv = 2048, D 128 that is 68.7 GFLOP (0.0695 ms)
// against 75.5 MB of q, k, v and out (0.0225 ms at 3.35 TB/s).  The TPU
// grid ran (B*Hq, Sq/bq, Skv/bk) in order with (m, l, acc) in VMEM across
// the last axis.  Here blocks run in parallel, so the KV axis is a loop
// inside the block:
//   * one block of 4 warps per (batch, query head, 64-row query tile);
//     heavy tiles (the causal diagonal's far end) are issued first;
//   * each warp keeps its 16 query rows as mma A fragments in registers
//     for the whole loop, and its 16 x D f32 accumulator and the rows'
//     (m, l) in registers: nothing of the softmax touches memory;
//   * per 64-key tile the block stages K and V in shared memory with
//     16-byte loads (rows padded by 8 values, so the fragment reads below
//     hit 32 distinct banks);
//   * S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 bf16 -> f32; P is rounded to bf16 for the PV
//     product (Pallas kept it in f32), l sums the unrounded f32 P;
//   * the causal and ragged masks are applied only on tiles that need
//     them (the diagonal tiles and the ragged last tile);
//   * exp2 with the scale folded into log2(e) * scale.
// Right and simple first: no cp.async / TMA pipelining, no wgmma, no warp
// specialisation, and K/V are re-read per query head (the L2 holds them
// across the Hq / Hkv heads of a group).  The K and V tiles live in
// dynamic shared memory: at D 192 (the MLA prefill: 128 nope + 64 rope
// dims, V zero-padded from 128) they take 51,200 bytes, which needs the
// opt-in past 48 KB; a thread then keeps 48 registers of Q fragments and
// 96 of accumulator.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define NEG_INF -1e30f

namespace {

constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BK = 64;      // keys per tile
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half (the element of
// the lower column index, as the mma fragments want it)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const uint16_t* __restrict__ q,
                           const uint16_t* __restrict__ k,
                           const uint16_t* __restrict__ v,
                           uint16_t* __restrict__ o, int Hq, int Hkv, int Sq,
                           int Skv, long long qsb, long long qsh,
                           long long qss, long long ksb, long long ksh,
                           long long kss, long long vsb, long long vsh,
                           long long vss, long long osb, long long osh,
                           long long oss, float scale_log2, int causal,
                           int q_offset) {
  constexpr int LD = D + 8;           // padded shared-memory row
  constexpr int KD = D / 16;          // k-steps of QK^T
  constexpr int ND = D / 8;           // n-tiles of the output
  constexpr int NK = BK / 8;          // n-tiles of S
  constexpr int VPR = D / 8;          // 16-byte vectors per row
  extern __shared__ __align__(16) uint16_t smem[];   // 2 * BK * LD
  uint16_t* Ks = smem;
  uint16_t* Vs = smem + BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  const uint16_t* qb = q + b * qsb + h * qsh;
  const uint16_t* kb = k + b * ksb + kvh * ksh;
  const uint16_t* vb = v + b * vsb + kvh * vsh;

  // this warp's 16 query rows as A fragments, kept for the whole loop
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < Sq ? ld32(qb + r0 * qss + c) : 0u;
    qa[kk][1] = r1 < Sq ? ld32(qb + r1 * qss + c) : 0u;
    qa[kk][2] = r0 < Sq ? ld32(qb + r0 * qss + c + 8) : 0u;
    qa[kk][3] = r1 < Sq ? ld32(qb + r1 * qss + c + 8) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // keys this query tile can see: up to the causal diagonal of its last
  // live row (KV tiles past it are skipped)
  int kv_end = Skv;
  if (causal) {
    const int last = q_offset + min(q0 + BQ, Sq) - 1;
    kv_end = min(Skv, last + 1);
  }
  const int qp0 = q_offset + r0, qp1 = q_offset + r1;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                  // every warp is done with the tile
    for (int i = threadIdx.x; i < BK * VPR; i += THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      int4 kx = make_int4(0, 0, 0, 0), vx = make_int4(0, 0, 0, 0);
      if (k0 + r < Skv) {
        kx = *reinterpret_cast<const int4*>(kb + (k0 + r) * kss + c);
        vx = *reinterpret_cast<const int4*>(vb + (k0 + r) * vss + c);
      }
      *reinterpret_cast<int4*>(&Ks[r * LD + c]) = kx;
      *reinterpret_cast<int4*>(&Vs[r * LD + c]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const uint16_t* kr = &Ks[(n * 8 + g) * LD + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale (log2 domain), masks on the tiles that need them, online
    // softmax per row: rows r0 (elements 0, 1) and r1 (elements 2, 3)
    const bool masked = (k0 + BK > Skv) ||
                        (causal && k0 + BK - 1 > q_offset + q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= Skv || (causal && kp > qp)) x = NEG_INF;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;              // this lane's share of the row sum
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: S's accumulator layout is the A fragment layout of P
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const uint16_t* vr = &Vs[(kk * 16 + 2 * t) * LD + n * 8 + g];
        const uint32_t b0 = (uint32_t)vr[0] | ((uint32_t)vr[LD] << 16);
        const uint32_t b1 =
            (uint32_t)vr[8 * LD] | ((uint32_t)vr[9 * LD] << 16);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  uint16_t* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + c) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * oss + c) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// the K and V tiles, BK rows of D + 8 values each: 51,200 bytes at D 192,
// past the 48 KB a launch gets without opting in
constexpr int smem_bytes(int d) { return 2 * BK * (d + 8) * 2; }

}  // namespace

// Strides are in elements (the last dimension is contiguous); the wrapper
// checks that every stride is a multiple of 8 and every pointer 16-byte
// aligned, that D is 32, 64, 128 or 192 and B * Hq fits the grid.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, int q_offset,
    void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq), block(THREADS);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_LAUNCH(DD)                                                       \
  do {                                                                      \
    const int bytes = smem_bytes(DD);                                       \
    if (bytes > 48 * 1024) {                                                \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          flash_attention_kernel<DD>,                                       \
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);              \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    flash_attention_kernel<DD><<<grid, block, bytes, s>>>(                  \
        (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,         \
        (uint16_t*)o, Hq, Hkv, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss, vsb,  \
        vsh, vss, osb, osh, oss, scale_log2, causal, q_offset);             \
  } while (0)
  if (D == 32) FA_LAUNCH(32);
  else if (D == 64) FA_LAUNCH(64);
  else if (D == 128) FA_LAUNCH(128);
  else if (D == 192) FA_LAUNCH(192);
  else return (int)cudaErrorInvalidValue;
#undef FA_LAUNCH
  return (int)cudaGetLastError();
}
