// selective_scan.cu — the Mamba-1 selective scan: the prefill's SSM
// recurrence of every Mamba layer, from an optional initial state.
//
// Design (Hopper): a channel's N states are split over LANES lanes of a
// warp, SPL = 8 states a lane (kernels/selective_scan.py::scan_plan: at N
// 16, 2 lanes), so the falcon-mamba-7b prefill (B 4, DI 8192) runs
// B x DI x LANES threads instead of B x DI: 16 warps an SM, not 8.  A
// block of 256 threads takes 256 / LANES channels of one batch row and
// walks time in chunks of L steps (64, or 32 where the block's shared
// memory would pass 100 KB), double buffered: chunk k + 1's x and dt
// tiles (16-byte cp.async pieces) and B_t / C_t rows (16-byte pieces
// where N fills the plan, else 4-byte ones, zero-filled past N and S)
// load while chunk k is computed.  A lane reads its share of B_t and C_t
// as float4s.  y takes a sum over the channel's lanes: LANES steps at a
// time, a reduce-scatter of the lanes' partial sums (LANES - 1 shuffles
// for LANES steps) leaves lane g with step g's sum; its y goes into a
// shared-memory tile that the block stores at the chunk's end in 16-byte
// pieces.  Padded steps (past S, to a multiple of LANES) carry dt = x =
// B = C = 0: their decay is exp(0) = 1 and their update 0, so the state
// passes through them unchanged, and their y is not stored.  Dead
// channels (past DI) and dead states (past N) compute zeros and store
// nothing.
//
// Bound: operations.  Each (b, t, channel, state) needs one exponential
// and five f32 instructions: x = dt * a and x * log2 e (__expf's
// argument), dt x * B, the update's FMA and C's FMA.  At the falcon
// prefill that is 1.07 G exponentials a launch against ~406 MB of
// operands (0.121 ms at 3.35 TB/s); the SFU's 16 exponentials a clock per
// SM make 0.26 ms at 1.98 GHz.  A scheduler issues one warp instruction
// a clock and its SFU quarter retires one warp's ex2 every 8 clocks, so
// the six instructions an element plus the loads, the conversions and
// the reduction (some 8.3 an element as compiled) keep issue as busy as
// the SFU: an exponential moved onto the FMA pipes as a polynomial (some
// 12 instructions) would cost more issue slots than the SFU time it
// frees, so every exponential stays on the SFU.  It is __expf's
// ex2.approx of x * log2 e (the same multiply by the same constant) in
// its .ftz form: at most 2 + floor(|1.173 x|) ulp, a result under 2^-126
// flushed to 0; nvcc contracts the updates into FMAs; the lanes' partial
// sums of y add in another order than the plain version's.
// kernels/selective_scan.py states what all three do to the tolerance.
//
// Replaces src/repro/kernels/selective_scan.py::_scan_kernel (:25,
// pallas_call :72).  Same function: x, dt (B, S, DI) in bf16 or f32;
// A (DI, N), B_t and C_t (B, S, N), D (DI,) and h0 (B, DI, N) in f32;
// in f32, for t = 0 .. S-1,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
//   y_t = C_t . h_t + D * x_t
// -> y (B, S, DI) in x's dtype and h_final (B, DI, N) f32.  The Pallas
// wrapper asserts S % 64 == 0 and DI % 256 == 0 (selective_scan.py:65);
// here a ragged S and a ragged DI are masked in the kernel.  The TPU grid
// ran (B, DI/256, S/64) with the chunk axis in order and the state in
// VMEM scratch; here the time axis is a loop inside the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads a block
constexpr int N_MAX = 64;        // the largest plan's states a channel
constexpr int SPL = 8;           // states a lane
constexpr int SMEM_CAP = 100 * 1024;   // a block's bytes: two blocks an SM
#define FULL 0xffffffffu

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// __expf(x) -- ex2.approx of x * log2 e, the same multiply by the same
// f32 constant -- in its .ftz form: a result under 2^-126 is 0 where
// __expf's non-ftz form would give a denormal through three more
// instructions (a test, a halved argument, a squared result)
__device__ __forceinline__ float exp_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x * 1.4426950408889634f));
  return r;
}

// cp.async of 16 or 4 bytes; where ``on`` is false nothing is read and
// the destination is zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, bool on) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool on) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one level of the lanes' reduce-scatter: lanes M apart swap halves of
// their partial sums; the lane with bit M set keeps the upper half
template <int M>
__device__ __forceinline__ void rs_level(float* v, int g) {
  const bool up = (g & M) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? v[i] : v[i + M];
    const float keep = up ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, M);
  }
}

// v[j] holds this lane's partial sum of step j (j < LANES); afterwards
// v[0] holds lane g's step g summed over the channel's LANES lanes
template <int LANES>
__device__ __forceinline__ void reduce_scatter(float* v, int g) {
  if constexpr (LANES >= 8) rs_level<4>(v, g);
  if constexpr (LANES >= 4) rs_level<2>(v, g);
  if constexpr (LANES >= 2) rs_level<1>(v, g);
}

// a block's shared memory at chunks of L steps: two stages of the x and
// dt tiles and the B_t and C_t rows, and the y tile
template <typename T, int LANES>
constexpr int smem_bytes(int L) {
  return 2 * (2 * L * (NT / LANES) * (int)sizeof(T) + 2 * L * LANES * SPL * 4)
         + L * (NT / LANES) * (int)sizeof(T);
}

// L: the largest of 64, 32, 16 whose shared memory fits SMEM_CAP
template <typename T, int LANES>
int chunk_steps() {
  int L = 64;
  while (L > 16 && smem_bytes<T, LANES>(L) > SMEM_CAP) L /= 2;
  return L;
}

template <typename T, int LANES>
__global__ void __launch_bounds__(NT, 2)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ Dv,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hout, int S, int DI, int n, int L,
                      int vx, int vbc) {
  // vx: DI % E == 0 and x, dt and y 16-byte aligned; vbc: n == NP and B_t,
  // C_t 16-byte aligned
  constexpr int CHB = NT / LANES;      // channels a block
  constexpr int NP = LANES * SPL;      // states a channel, padded
  constexpr int E = 16 / (int)sizeof(T);   // x / dt elements a piece
  constexpr int PR = CHB / E;          // pieces a tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int xbytes = L * CHB * (int)sizeof(T);
  const int sbytes = 2 * xbytes + 2 * L * NP * 4;
  T* yt = reinterpret_cast<T*>(smem + 2 * sbytes);     // L x CHB

  const int tid = threadIdx.x;
  const int grp = tid / LANES, g = tid % LANES;
  const int bi = blockIdx.y;
  const int c0 = blockIdx.x * CHB;
  const int ch = c0 + grp;
  const bool live = ch < DI;

  float a[SPL], h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int st = g * SPL + i;
    const bool on = live && st < n;
    a[i] = on ? A[(size_t)ch * n + st] : 0.f;
    h[i] = (on && h0 != nullptr) ? h0[((size_t)bi * DI + ch) * n + st] : 0.f;
  }
  const float dskip = live ? Dv[ch] : 0.f;
  const int nchunks = (S + L - 1) / L;

  auto stage = [&](int k) {
    unsigned char* base = smem + (k & 1) * sbytes;
    T* xd = reinterpret_cast<T*>(base);
    T* dd = reinterpret_cast<T*>(base + xbytes);
    float* bd = reinterpret_cast<float*>(base + 2 * xbytes);
    float* cd = bd + L * NP;
    const int t0 = k * L;
    const int len = min(L, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    if (vx) {
      for (int i = tid; i < L * PR; i += NT) {
        const int r = i / PR, p = i % PR;
        const int cc = c0 + p * E;
        const bool on = r < len && cc < DI;
        const size_t gi = on ? (row0 + r) * DI + cc : 0;
        cp16(xd + r * CHB + p * E, x + gi, on);
        cp16(dd + r * CHB + p * E, dt + gi, on);
      }
    } else {                // element by element, through registers
      for (int i = tid; i < L * CHB; i += NT) {
        const int r = i / CHB, j = i % CHB;
        const bool on = r < len && c0 + j < DI;
        const size_t gi = (row0 + r) * DI + c0 + j;
        xd[i] = on ? x[gi] : from_f<T>(0.f);
        dd[i] = on ? dt[gi] : from_f<T>(0.f);
      }
    }
    if (vbc) {              // the chunk's rows are contiguous
      for (int i = tid; i < L * NP / 4; i += NT) {
        const bool on = (4 * i) / NP < len;
        const size_t gi = on ? row0 * NP + 4 * i : 0;
        cp16(bd + 4 * i, Bm + gi, on);
        cp16(cd + 4 * i, Cm + gi, on);
      }
    } else {
      for (int i = tid; i < L * NP; i += NT) {
        const int r = i / NP, q = i % NP;
        const bool on = r < len && q < n;
        const size_t gi = on ? (row0 + r) * n + q : 0;
        cp4(bd + i, Bm + gi, on);
        cp4(cd + i, Cm + gi, on);
      }
    }
    cp_commit();
  };

  stage(0);
  if (nchunks > 1) stage(1); else cp_commit();
  for (int k = 0; k < nchunks; ++k) {
    cp_wait_all_but_one();
    __syncthreads();
    const unsigned char* base = smem + (k & 1) * sbytes;
    const T* xd = reinterpret_cast<const T*>(base);
    const T* dd = reinterpret_cast<const T*>(base + xbytes);
    const float* bd = reinterpret_cast<const float*>(base + 2 * xbytes);
    const float* cd = bd + L * NP;
    const int len = min(L, S - k * L);
#pragma unroll 2
    for (int r = 0; r < len; r += LANES) {
      float part[LANES];
      float xmine = 0.f;
#pragma unroll
      for (int j = 0; j < LANES; ++j) {
        const int rr = r + j;           // < L: L is a multiple of LANES
        const float xv = to_f(xd[rr * CHB + grp]);
        const float dv = to_f(dd[rr * CHB + grp]);
        const float dx = dv * xv;
        const float4* b4 =
            reinterpret_cast<const float4*>(bd + rr * NP + g * SPL);
        const float4* c4 =
            reinterpret_cast<const float4*>(cd + rr * NP + g * SPL);
        float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
        for (int q = 0; q < SPL / 4; ++q) {
          const float4 bq = b4[q], cq = c4[q];
          const float bb[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cc[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * q + e;
            const float da = exp_ftz(dv * a[i]);
            h[i] = da * h[i] + dx * bb[e];
            if (e & 1) acc1 += h[i] * cc[e];
            else acc0 += h[i] * cc[e];
          }
        }
        part[j] = acc0 + acc1;
        if (j == g) xmine = xv;
      }
      reduce_scatter<LANES>(part, g);
      yt[(r + g) * CHB + grp] = from_f<T>(part[0] + dskip * xmine);
    }
    __syncthreads();            // this stage is read and the y tile full
    if (k + 2 < nchunks) stage(k + 2); else cp_commit();
    // the y tile's rows under len and channels under DI, out in 16-byte
    // pieces where the rows allow; the next chunk's first barrier keeps
    // its y writes behind these reads
    const size_t row0 = (size_t)bi * S + (size_t)k * L;
    if (vx) {
      for (int i = tid; i < L * PR; i += NT) {
        const int r = i / PR, p = i % PR;
        const int cc = c0 + p * E;
        if (r < len && cc < DI)
          *reinterpret_cast<int4*>(y + (row0 + r) * DI + cc) =
              *reinterpret_cast<const int4*>(yt + r * CHB + p * E);
      }
    } else {
      for (int i = tid; i < L * CHB; i += NT) {
        const int r = i / CHB, j = i % CHB;
        if (r < len && c0 + j < DI) y[(row0 + r) * DI + c0 + j] = yt[i];
      }
    }
  }
  cp_wait_all();                // S = 0 still staged (zeros) chunk 0
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int st = g * SPL + i;
    if (live && st < n) hout[((size_t)bi * DI + ch) * n + st] = h[i];
  }
}

template <typename T, int LANES>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, const void* h0, void* y,
           void* hout, int B, int S, int DI, int n, cudaStream_t s) {
  constexpr int NP = LANES * SPL;
  constexpr int E = 16 / (int)sizeof(T);
  const int L = chunk_steps<T, LANES>();
  const int smem = smem_bytes<T, LANES>(L);
  auto* k = selective_scan_kernel<T, LANES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const auto al16 = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vx = DI % E == 0 && al16(x) && al16(dt) && al16(y);
  const int vbc = n == NP && al16(Bm) && al16(Cm);
  const dim3 grid((DI + NT / LANES - 1) / (NT / LANES), B), block(NT);
  k<<<grid, block, smem, s>>>((const T*)x, (const T*)dt, (const float*)A,
                              (const float*)Bm, (const float*)Cm,
                              (const float*)Dv, (const float*)h0, (T*)y,
                              (float*)hout, S, DI, n, L, vx, vbc);
  return (int)cudaGetLastError();
}

template <typename T, int LANES>
int info(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
  *smem = smem_bytes<T, LANES>(chunk_steps<T, LANES>());
  auto* k = selective_scan_kernel<T, LANES>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  if (*smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                            NT, *smem);
}

// the plans of kernels/selective_scan.py::scan_plan: lanes a channel
#define SCAN_PLANS(X, T) X(T, 1) X(T, 2) X(T, 4) X(T, 8)

template <typename T>
int dispatch(int lanes, const void* x, const void* dt,
             const void* A, const void* Bm, const void* Cm, const void* Dv,
             const void* h0, void* y, void* hout, int B, int S, int DI,
             int n, cudaStream_t s) {
#define X(T_, LN)                                                        \
  if (lanes == LN)                                                       \
    return launch<T_, LN>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S, DI, \
                              n, s);
  SCAN_PLANS(X, T)
#undef X
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_info(int lanes, int* out) {
#define X(T_, LN) \
  if (lanes == LN) return info<T_, LN>(out, out + 1, out + 2, out + 3);
  SCAN_PLANS(X, T)
#undef X
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt and y); every other operand f32;
// all contiguous; h0 may be null (zeros).  lanes is the wrapper's
// scan_plan(n): lanes * SPL >= n.  The wrapper checks the shapes,
// 1 <= n <= 64, B <= 65535 and B * DI > 0 (S may be 0: h_final is then
// h0, or zeros).
extern "C" int selective_scan_launch(int dtype, const void* x,
                                     const void* dt, const void* A,
                                     const void* Bm, const void* Cm,
                                     const void* Dv, const void* h0,
                                     void* y, void* hout, int B, int S,
                                     int DI, int n, int lanes,
                                     void* stream) {
  if (n < 1 || n > N_MAX || n > lanes * SPL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(lanes, x, dt, A, Bm, Cm, Dv, h0, y, hout, B,
                           S, DI, n, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(lanes, x, dt, A, Bm, Cm, Dv, h0, y,
                                   hout, B, S, DI, n, s);
  return (int)cudaErrorInvalidValue;
}

// out: registers a thread, local (spill) bytes a thread, dynamic shared
// memory a block, resident blocks an SM, of the plan's kernel
extern "C" int selective_scan_info(int dtype, int lanes, int* out) {
  if (dtype == 0) return dispatch_info<float>(lanes, out);
  if (dtype == 1) return dispatch_info<__nv_bfloat16>(lanes, out);
  return (int)cudaErrorInvalidValue;
}
