// selective_scan.cu — the Mamba-1 selective scan: the prefill's SSM
// recurrence of every Mamba layer, from an optional initial state.
//
// Replaces src/repro/kernels/selective_scan.py::_scan_kernel (:25,
// pallas_call :72).  Same function: x, dt (B, S, DI) in bf16 or f32;
// A (DI, N), B_t and C_t (B, S, N), D (DI,) and h0 (B, DI, N) in f32;
// in f32, for t = 0 .. S-1,
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t * B_t
//   y_t = C_t . h_t + D * x_t
// -> y (B, S, DI) in x's dtype and h_final (B, DI, N) f32.  The Pallas
// wrapper asserts S % 64 == 0 and DI % 256 == 0 (selective_scan.py:65);
// here a ragged S and a ragged DI are masked in the kernel.
//
// Bound: operations, and not the tensor cores.  Each (b, t, channel,
// state) needs one exponential, exp(dt * a), and four f32 flops; the
// falcon-mamba-7b prefill (B 4, S 2048, DI 8192, N 16) takes 1.07 G
// exponentials a launch against ~406 MB of operands (0.121 ms at
// 3.35 TB/s): at the SM's 16 exponentials a clock the exponentials cost
// some 0.26 ms at 1.98 GHz, twice the bytes.  The TPU grid ran
// (B, DI/256, S/64) with the chunk axis in order and the state in VMEM
// scratch; here the time axis is a loop inside the block:
//   * one block of 128 threads per (128-channel tile of DI, batch row);
//     each thread owns one channel and keeps its N states and its N
//     values of A in registers for the whole sequence (N a template
//     parameter: 4 and 16 exactly, any other N up to 64 on a predicated
//     path that keeps 64);
//   * time runs in chunks of 64 steps: the block stages the chunk's x and
//     dt tiles (64 x 128, each thread its own column, 64 independent
//     loads in flight) and its B_t and C_t rows (64 x N f32, read by every
//     thread of the block as broadcasts) in shared memory, then each
//     thread runs the 64 steps of its channel in order, writing y over
//     x in the tile, and stores the tile's y at the chunk's end;
//   * exp is __expf (one multiply by log2 e, then the SFU's ex2.approx:
//     at most 2 + floor(|1.173 x|) ulp, denormal results flushed to 0);
//     nvcc contracts the updates into FMAs.  kernels/selective_scan.py
//     states what both do to the tolerance.
// Right and simple first: 8 warps an SM at the prefill's 256 blocks is
// too few to hide the SFU's and the FMAs' latency; splitting N over
// lanes, double-buffering the chunks and wider loads are the levers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 128;     // channels (threads) per block
constexpr int L = 64;       // time steps per staged chunk
constexpr int N_MAX = 64;   // the predicated path's states per channel

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

// NS states per channel, all of them live when EXACT, else the first n
template <typename T, int NS, bool EXACT>
__global__ void __launch_bounds__(CH)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ Dv,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hout, int S, int DI, int n_rt) {
  const int n = EXACT ? NS : n_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);         // L x CH: x, then y
  T* ds = xs + L * CH;                         // L x CH: dt
  float* bs = reinterpret_cast<float*>(ds + L * CH);   // L x n
  float* cs = bs + L * n;                               // L x n

  const int tid = threadIdx.x;
  const int bi = blockIdx.y;
  const int ch = blockIdx.x * CH + tid;
  const bool live = ch < DI;

  float a[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool on = live && (EXACT || i < n);
    a[i] = on ? A[(size_t)ch * n + i] : 0.f;
    h[i] = (on && h0 != nullptr) ? h0[((size_t)bi * DI + ch) * n + i] : 0.f;
  }
  const float dskip = live ? Dv[ch] : 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int len = min(L, S - t0);
    const size_t row0 = (size_t)bi * S + t0;
    __syncthreads();            // every thread is done with bs / cs
    if (live) {
      for (int r = 0; r < len; ++r) {
        const size_t g = (row0 + r) * DI + ch;
        xs[r * CH + tid] = x[g];
        ds[r * CH + tid] = dt[g];
      }
    }
    for (int i = tid; i < len * n; i += CH) {
      bs[i] = Bm[row0 * n + i];
      cs[i] = Cm[row0 * n + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < len; ++r) {
      const float xv = to_f(xs[r * CH + tid]);
      const float dv = to_f(ds[r * CH + tid]);
      const float dx = dv * xv;
      const float* br = bs + r * n;
      const float* cr = cs + r * n;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (EXACT || i < n) {
          const float da = __expf(dv * a[i]);
          h[i] = da * h[i] + dx * br[i];
          acc += h[i] * cr[i];
        }
      }
      xs[r * CH + tid] = from_f<T>(acc + dskip * xv);
    }
    // each thread stores the column it wrote: no barrier needed
    for (int r = 0; r < len; ++r) y[(row0 + r) * DI + ch] = xs[r * CH + tid];
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (EXACT || i < n) hout[((size_t)bi * DI + ch) * n + i] = h[i];
  }
}

template <typename T, int NS, bool EXACT>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, const void* h0, void* y,
           void* hout, int B, int S, int DI, int n, cudaStream_t s) {
  const int smem = 2 * L * CH * (int)sizeof(T) + 2 * L * n * 4;
  auto* k = selective_scan_kernel<T, NS, EXACT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((DI + CH - 1) / CH, B), block(CH);
  k<<<grid, block, smem, s>>>((const T*)x, (const T*)dt, (const float*)A,
                              (const float*)Bm, (const float*)Cm,
                              (const float*)Dv, (const float*)h0, (T*)y,
                              (float*)hout, S, DI, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* Dv, const void* h0, void* y,
             void* hout, int B, int S, int DI, int n, cudaStream_t s) {
  if (n == 16)
    return launch<T, 16, true>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S, DI,
                               n, s);
  if (n == 4)
    return launch<T, 4, true>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S, DI,
                              n, s);
  return launch<T, N_MAX, false>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S,
                                 DI, n, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, dt and y); every other operand f32;
// all contiguous; h0 may be null (zeros).  The wrapper checks the shapes,
// 1 <= n <= 64, B <= 65535 and B * DI > 0 (S may be 0: h_final is then
// h0, or zeros).
extern "C" int selective_scan_launch(int dtype, const void* x,
                                     const void* dt, const void* A,
                                     const void* Bm, const void* Cm,
                                     const void* Dv, const void* h0,
                                     void* y, void* hout, int B, int S,
                                     int DI, int n, void* stream) {
  if (n < 1 || n > N_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S, DI, n,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, h0, y, hout, B, S,
                                   DI, n, s);
  return (int)cudaErrorInvalidValue;
}
