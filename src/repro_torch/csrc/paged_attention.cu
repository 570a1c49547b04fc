// paged_attention.cu — one-token GQA decode attention over per-sequence
// chains of KV pages (the layout the delegated page table serves).
//
// Replaces src/repro/kernels/paged_attention.py::_pa_kernel (:31,
// pallas_call :113).  Same function: scale 1/sqrt(D) unless given; scores
// of positions at or past lengths[b] are NEG_INF = -1e30; a running
// (m, l, acc) in f32 page by page (online softmax); pages with
// j * PS >= lengths[b] are skipped; a page id of -1 inside the live length
// reads page 0 and ids are clipped into [0, P) (the TPU index map's
// max(id, 0), the reference's clip); out = acc / max(l, 1e-30) in q's
// dtype.
//
// Bound: bytes.  Each live page's K and V rows of one KV head are read
// once, q once and out written once: sum_b ceil(len_b / PS) * Hkv * PS * D
// * 2 * itemsize + 2 * B * Hq * D * itemsize over 3.35 TB/s.  The TPU grid
// (B*Hq, MP) fetched every page once per QUERY head, rep = Hq / Hkv times
// (8 at qwen2.5-3b's 16 / 2 heads).  Here one block serves one
// (sequence, KV head) and all rep query heads of its group:
//   * the block copies each live page's K and V (PS x D) into shared
//     memory once, with 16-byte loads when the page is 16-byte aligned;
//   * one warp per query head: each lane holds D/32 of q and of the
//     accumulator in registers, a score is a warp-reduced dot product, and
//     the warp runs the online softmax in f32;
//   * bf16, f16 and f32 inputs, f32 math.
// Right and simple first: no split over pages (flash-decoding), no
// cp.async / TMA pipelining and no tensor-core products yet.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define MAX_DPL 8  // D <= 256: D / 32 values per lane
#define NEG_INF -1e30f

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename T>
__global__ void paged_attention_kernel(const T* q, const T* kp, const T* vp,
                                       const int* pt, const int* lengths,
                                       T* out, int Hq, int Hkv, int P, int PS,
                                       int D, int MP, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x % Hkv;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = kvh * rep + warp;
  const int page_elems = PS * D;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + page_elems;
  const size_t kv_bytes = 2 * (size_t)page_elems * sizeof(T);
  float* sc = reinterpret_cast<float*>(smem + ((kv_bytes + 15) & ~(size_t)15))
              + warp * PS;

  float qr[MAX_DPL], acc[MAX_DPL];
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f(q[((size_t)b * Hq + h) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  const int len = lengths[b];

  for (int j = 0; j < MP && j * PS < len; ++j) {
    int page = pt[(size_t)b * MP + j];
    page = page < 0 ? 0 : (page >= P ? P - 1 : page);
    const T* ksrc = kp + ((size_t)page * Hkv + kvh) * page_elems;
    const T* vsrc = vp + ((size_t)page * Hkv + kvh) * page_elems;
    __syncthreads();  // every warp is done with the previous page
    if (vec) {
      const int n16 = page_elems * (int)sizeof(T) / 16;
      const int4* k4 = reinterpret_cast<const int4*>(ksrc);
      const int4* v4 = reinterpret_cast<const int4*>(vsrc);
      int4* ks4 = reinterpret_cast<int4*>(ks);
      int4* vs4 = reinterpret_cast<int4*>(vs);
      for (int i = threadIdx.x; i < n16; i += blockDim.x) {
        ks4[i] = k4[i];
        vs4[i] = v4[i];
      }
    } else {
      for (int i = threadIdx.x; i < page_elems; i += blockDim.x) {
        ks[i] = ksrc[i];
        vs[i] = vsrc[i];
      }
    }
    __syncthreads();

    float mx = m;
    for (int p = 0; p < PS; ++p) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) part += qr[i] * to_f(ks[p * D + d]);
      }
      float s = warp_sum(part) * scale;
      if (j * PS + p >= len) s = NEG_INF;
      if (lane == 0) sc[p] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();
    const float alpha = expf(m - mx);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) acc[i] *= alpha;
    for (int p = 0; p < PS; ++p) {
      const float e = expf(sc[p] - mx);
      psum += e;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += e * to_f(vs[p * D + d]);
      }
    }
    l = l * alpha + psum;
    m = mx;
    __syncwarp();
  }

  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) out[((size_t)b * Hq + h) * D + d] = from_f<T>(acc[i] / denom);
  }
}

// dtype: 0 float32, 1 bfloat16, 2 float16; vec: every page of the pools
// starts on a 16-byte boundary (the wrapper checks the pointers)
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* kp, const void* vp,
                                      const void* pt, const void* lengths,
                                      void* out, int B, int Hq, int Hkv,
                                      int P, int PS, int D, int MP,
                                      float scale, int vec, int smem_bytes,
                                      void* stream) {
  const int rep = Hq / Hkv;
  const dim3 grid(B * Hkv), block(32 * rep);
  cudaStream_t s = (cudaStream_t)stream;
#define PA_LAUNCH(T)                                                         \
  {                                                                          \
    if (smem_bytes > 48 * 1024) {                                            \
      cudaError_t e = cudaFuncSetAttribute(                                  \
          paged_attention_kernel<T>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);          \
      if (e != cudaSuccess) return (int)e;                                   \
    }                                                                        \
    paged_attention_kernel<T><<<grid, block, smem_bytes, s>>>(               \
        (const T*)q, (const T*)kp, (const T*)vp, (const int*)pt,             \
        (const int*)lengths, (T*)out, Hq, Hkv, P, PS, D, MP, scale, vec);    \
  }
  if (dtype == 0) PA_LAUNCH(float)
  else if (dtype == 1) PA_LAUNCH(__nv_bfloat16)
  else if (dtype == 2) PA_LAUNCH(__half)
  else return (int)cudaErrorInvalidValue;
#undef PA_LAUNCH
  return (int)cudaGetLastError();
}
