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
// dtype (0 for a length of 0).
//
// Bound: bytes.  Each live page's K and V rows of one KV head are read
// once, q once and out written once: sum_b ceil(len_b / PS) * Hkv * PS * D
// * 2 * itemsize + 2 * B * Hq * D * itemsize over 3.35 TB/s (21 MB,
// 6.6 us on the paged decode's largest call).  The TPU grid (B*Hq, MP)
// fetched every page once per QUERY head and walked a chain in order.
// One block per (sequence, KV head) walking its chain leaves most of the
// 132 SMs idle at B 63 and exposes each page's load latency; and one
// warp per query head redoes a page's dot products and conversions rep
// times on the CUDA cores.  Here (flash-decoding):
//   * the grid is (sequence x KV head, split): a split takes a fixed run
//     of `pps` pages of the chain (the wrapper's plan, from MP alone: the
//     lengths stay on the card), and a split past its sequence's live
//     pages exits at once;
//   * the block asks for the split's pages up front, one thread a page
//     (a ring of `nst` stages; nst = pps unless shared memory is short):
//     each page's K and V of this KV head are contiguous, so each is one
//     bulk copy (cp.async.bulk) completed on an mbarrier — no barrier of
//     the whole block in the page loop;
//   * bf16 / f16 (PS a multiple of 16, D 64 or 128, rep <= 16): 4 warps,
//     each taking pages of the split and computing all rep heads of the
//     group at once on the tensor cores, S = Q K^T and O += P V as
//     mma.sync.m16n8k16 with the heads as rows, the online softmax in f32
//     on the accumulator fragments; P goes into the PV product as a bf16
//     / f16 part plus the rounding of the rest, so it keeps f32's
//     precision; the warps' partials are combined in shared memory;
//   * otherwise (f32, other shapes) the CUDA cores: one warp per query
//     head, each lane D / 32 of q and of the accumulator, a score a
//     warp-reduced dot product; pages that are not 16-byte multiples (or
//     pools that are not 16-byte aligned) are read from global memory;
//   * each split stores its (m, l, acc) in f32 to scratch, and the last
//     split of a (sequence, KV head) to finish (an atomic ticket on a
//     zeroed counter) merges the group's splits in split order, its loads
//     in flight together; a plan of one split writes the output itself.
// What bounds it now (H100, the paged decode's largest call): the chain
// of dependent latencies a block waits through (lengths, page ids, bulk
// copies, the ticket, the merge's loads) times the waves of blocks, not
// bytes or arithmetic.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define FULL 0xffffffffu
#define MAX_DPL 8  // D <= 256: D / 32 values per lane
#define NEG_INF -1e30f

namespace {

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

__device__ __forceinline__ int live_pages(int len, int PS, int MP) {
  return min(MP, (max(len, 0) + PS - 1) / PS);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// K and V of one page of one KV head into a stage: two bulk copies of
// `bytes` each, completed on `bar`
__device__ __forceinline__ void load_page(uint32_t ks, uint32_t vs,
                                          const void* k, const void* v,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(2 * bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(ks),
      "l"(k), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(vs),
      "l"(v), "r"(bytes), "r"(bar)
      : "memory");
}

// One warp's online-softmax update over page j (positions j*PS ..) whose
// K and V rows (PS x D) are at kr / vr; sc is the warp's PS scores
template <typename T>
__device__ __forceinline__ void attend_page(const T* kr, const T* vr,
                                            float* sc, const float qr[],
                                            float acc[], float& m, float& l,
                                            int j, int len, int PS, int D,
                                            float scale, int lane) {
  float mx = m;
  for (int p = 0; p < PS; ++p) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) part += qr[i] * to_f(kr[p * D + d]);
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
      if (d < D) acc[i] += e * to_f(vr[p * D + d]);
    }
  }
  l = l * alpha + psum;
  m = mx;
  __syncwarp();
}

// The split's pages through a ring of `nst` stages of (K page, V page)
// in shared memory: thread i asks for the first stages' page i (its K and
// V of this KV head, two bulk copies completed on the stage's "full"
// mbarrier); each warp hands a stage back on its "empty" mbarrier once it
// is done with it, and thread 0 then refills it with the page nst further
// on.
// No barrier of the whole block in the page loop.
template <typename T>
struct PageRing {
  unsigned char* smem;
  uint32_t bar, page_bytes;  // full[s] at bar + 8 s, empty[s] at + 8 nst
  int nst, n;
  const T *kp, *vp;
  const int* chain;          // the split's first page id
  int P;
  size_t page_stride, kv_off;

  __device__ void issue(int i) const {
    const int page = min(max(chain[i], 0), P - 1);
    const size_t off = (size_t)page * page_stride + kv_off;
    const uint32_t dst = smem_u32(smem) + 2 * (i % nst) * page_bytes;
    load_page(dst, dst + page_bytes, kp + off, vp + off, page_bytes,
              bar + 8 * (i % nst));
  }
  // every thread of the block: set up the barriers, ask for the first
  // stages
  __device__ void start() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < nst; ++s) {
        mbar_init(bar + 8 * s, 1);
        mbar_init(bar + 8 * (nst + s), blockDim.x / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < min(nst, n)) issue(threadIdx.x);  // in parallel
  }
  // the K page of the split's page i once it has landed (V follows it)
  __device__ const T* wait(int i) const {
    mbar_wait(bar + 8 * (i % nst), (i / nst) & 1);
    return reinterpret_cast<const T*>(smem) +
           (size_t)2 * (i % nst) * (page_bytes / sizeof(T));
  }
  // this warp is done with page i's stage
  __device__ void release(int i) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar + 8 * (nst + i % nst));
    if (threadIdx.x == 0 && i + nst < n) {
      mbar_wait(bar + 8 * (nst + i % nst), (i / nst) & 1);  // every warp
      issue(i + nst);
    }
  }
};

// The last block of a (sequence, KV head) to store its split's partial
// merges the group's `ns` splits in split order: out = sum_s e^(m_s - M)
// acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).  A block takes its ticket
// after a fence, so the last one sees every partial, and reads them past
// L1.  A warp a query head turns the splits' (m, l) into weights in
// `wsm` (rep x (ns + 1) floats of shared memory, the last 1 / L); then
// each thread sums two outputs (four dims each where D allows), every
// load of a split in flight at once: the merge is a few L2 round trips.
template <typename T>
__device__ void merge_if_last(const float* part_ml, const float* part_acc,
                              int* counter, T* out, float* wsm, int b,
                              int kvh, int Hq, int rep, int D, int ns,
                              int NS) {
  __shared__ int ticket;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter + blockIdx.x, 1);
  __syncthreads();
  if (ticket != ns - 1) return;
  __threadfence();
  const int lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * Hq + kvh * rep;
  for (int r = threadIdx.x >> 5; r < rep; r += blockDim.x >> 5) {
    const float2* ml =
        reinterpret_cast<const float2*>(part_ml) + (row0 + r) * NS;
    float* w = wsm + r * (ns + 1);
    float mx = NEG_INF, l = 0.f;
    // one load a split when ns <= 32, kept in a register for both passes
    const float2 x0 = lane < ns ? __ldcg(ml + lane) : make_float2(NEG_INF, 0.f);
    mx = x0.x;
    for (int s = lane + 32; s < ns; s += 32) mx = fmaxf(mx, __ldcg(ml + s).x);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    for (int s = lane; s < ns; s += 32) {
      const float2 x = s == lane ? x0 : __ldcg(ml + s);
      w[s] = expf(x.x - mx);
      l += w[s] * x.y;
    }
    l = warp_sum(l);
    if (lane == 0) w[ns] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int vec = (D & 3) == 0 ? 4 : 1;    // dims an output
  const int per = D / vec, n = rep * per;  // outputs a head, in all
  for (int i = threadIdx.x; i < n; i += 2 * blockDim.x) {
    float acc[2][4] = {};
    int r[2], c[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = min(i + u * (int)blockDim.x, n - 1);
      r[u] = k / per;
      c[u] = k % per * vec;
    }
    const float* pa[2] = {part_acc + (row0 + r[0]) * NS * D + c[0],
                          part_acc + (row0 + r[1]) * NS * D + c[1]};
    const float* w[2] = {wsm + r[0] * (ns + 1), wsm + r[1] * (ns + 1)};
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (vec == 4) {
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(pa[u] + (size_t)s * D));
          acc[u][0] += w[u][s] * x.x, acc[u][1] += w[u][s] * x.y;
          acc[u][2] += w[u][s] * x.z, acc[u][3] += w[u][s] * x.w;
        } else {
          acc[u][0] += w[u][s] * __ldcg(pa[u] + (size_t)s * D);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (i + u * (int)blockDim.x >= n) break;
      T* o = out + (row0 + r[u]) * D + c[u];
      for (int e = 0; e < vec; ++e) o[e] = from_f<T>(acc[u][e] * w[u][ns]);
    }
  }
}

// CUDA cores, any dtype and shape.  grid (B * Hkv, NS), block 32 * rep:
// one warp per query head of the KV head's group.  Split blockIdx.y takes
// pages [y * pps, (y + 1) * pps) of the chain.  With NS == 1 it writes
// out; else its partial (m, l) to part_ml[(b, h, split)] and acc to
// part_acc[(b, h, split), :D], and the group's last split merges them.
template <typename T, bool BULK>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ pt,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counter, int Hq, int Hkv, int P, int PS, int D, int MP,
    int pps, int nst, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int split = blockIdx.y, NS = gridDim.y;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kvh * rep + warp;
  const int len = lengths[b], live = live_pages(len, PS, MP);
  // the splits that store a partial: those with a live page (split 0 of
  // a length 0, whose merge answers zeros)
  const int stored = max(1, (live + pps - 1) / pps);
  if (split >= stored) return;
  const int j0 = split * pps, j1 = min(j0 + pps, live);
  const int page_elems = PS * D;
  const uint32_t page_bytes = (uint32_t)(page_elems * sizeof(T));
  // BULK: the ring's stages, then the warps' scores, then the ring's
  // mbarriers, then the merge's weights
  const size_t ring = BULK ? (size_t)nst * 2 * page_bytes : 0;
  const size_t bar_off = ring + ((4 * rep * PS + 7) & ~7);
  float* sc = reinterpret_cast<float*>(smem + ring) + warp * PS;
  const PageRing<T> pages{smem, smem_u32(smem + bar_off),
                          page_bytes, nst, j1 - j0, kp, vp,
                          pt + (size_t)b * MP + j0, P,
                          (size_t)Hkv * page_elems,
                          (size_t)kvh * page_elems};

  float qr[MAX_DPL], acc[MAX_DPL];
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < D ? to_f(q[((size_t)b * Hq + h) * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  if (BULK) {
    pages.start();
    for (int i = 0; i < pages.n; ++i) {
      const T* kr = pages.wait(i);
      attend_page<T>(kr, kr + page_elems, sc, qr, acc, m, l, j0 + i, len,
                     PS, D, scale, lane);
      pages.release(i);
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      const int page = min(max(pt[(size_t)b * MP + j], 0), P - 1);
      const size_t off = (size_t)page * pages.page_stride + pages.kv_off;
      attend_page<T>(kp + off, vp + off, sc, qr, acc, m, l, j, len, PS, D,
                     scale, lane);
    }
  }

  if (NS == 1) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[((size_t)b * Hq + h) * D + d] = from_f<T>(acc[i] / denom);
    }
    return;
  }
  const size_t slot = ((size_t)b * Hq + h) * NS + split;
#pragma unroll
  for (int i = 0; i < MAX_DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) part_acc[slot * D + d] = acc[i];
  }
  if (lane == 0) {
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
  merge_if_last<T>(part_ml, part_acc, counter, out,
                   reinterpret_cast<float*>(smem + bar_off + 16 * nst), b,
                   kvh, Hq, rep, D, stored, NS);
}

// ---- tensor cores (bf16, f16) ----------------------------------------------

template <typename T>
__device__ __forceinline__ void mma16816(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float c[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float c[4], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint32_t b0,
                                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to T and packed, and what the rounding left off
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat162 make(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ float2 back(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
};
template <> struct Pair<__half> {
  static __device__ __forceinline__ __half2 make(float a, float b) {
    return __floats2half2_rn(a, b);
  }
  static __device__ __forceinline__ float2 back(__half2 v) {
    return __half22float2(v);
  }
};
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi, float& rlo,
                                          float& rhi) {
  auto v = Pair<T>::make(lo, hi);
  const float2 f = Pair<T>::back(v);
  rlo = lo - f.x;
  rhi = hi - f.y;
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tensor cores, bf16 / f16 pages of 16-position groups, D 64 or 128,
// rep <= 16.  grid (B * Hkv, NS), block MMA_WARPS warps: warp w takes
// pages w, w + MMA_WARPS, ... of its split (the ring holds them all), for
// all rep query heads of the group at once: S = Q K^T and O += P V as
// mma.sync.m16n8k16 with the heads as the 16 rows (rows past rep are
// zero).  Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8.  The
// dims of a k-step are permuted so that lane t's slots 2t, 2t + 1, 2t + 8,
// 2t + 9 are 4 consecutive dims: one 16-byte load of a K row gives its B
// fragments for two k-steps, and Q's A fragments take the same order.  V's
// fragments come from ldmatrix.trans.  P is split into a T part and the
// T-rounding of the rest (two products), so P V keeps f32's precision.
// The warps' (m, l, O) are combined through shared memory once their pages
// are done (over the ring), then stored or merged as in the CUDA-core
// kernel.
constexpr int MMA_WARPS = 4;

template <typename T, int D>
__global__ void __launch_bounds__(32 * MMA_WARPS) paged_attention_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ pt,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counter, int Hq, int Hkv, int P, int PS, int MP,
    int pps, int nst, float scale, int region) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KC = D / 32;  // 16-byte chunks of a row a lane reads
  constexpr int NT = D / 8;   // n-tiles of O
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int split = blockIdx.y, NS = gridDim.y;
  const int rep = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = lengths[b], live = live_pages(len, PS, MP);
  const int stored = max(1, (live + pps - 1) / pps);
  if (split >= stored) return;
  const int j0 = split * pps, j1 = min(j0 + pps, live);
  const int page_elems = PS * D;
  const uint32_t page_bytes = (uint32_t)(page_elems * sizeof(T));
  // the ring (reused for the warps' combine), its mbarriers, the merge's
  // weights
  const PageRing<T> pages{smem, smem_u32(smem + region), page_bytes, nst,
                          j1 - j0, kp, vp, pt + (size_t)b * MP + j0, P,
                          (size_t)Hkv * page_elems,
                          (size_t)kvh * page_elems};
  pages.start();

  // Q's A fragments, rows g and g + 8: dims 32 c + 8 t .. + 7
  uint4 qa[KC], qb[KC];
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const size_t row0 = (size_t)b * Hq + kvh * rep;
  const T* q0 = q + row0 * D + 8 * t;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    qa[c] = g < rep ? *reinterpret_cast<const uint4*>(q0 + g * D + 32 * c)
                    : zero;
    qb[c] = g + 8 < rep
                ? *reinterpret_cast<const uint4*>(q0 + (g + 8) * D + 32 * c)
                : zero;
  }
  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = warp; i < pages.n; i += MMA_WARPS) {
    const T* kr = pages.wait(i);
    const T* vr = kr + page_elems;
    for (int p0 = 0; p0 < PS; p0 += 16) {
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const T* krow = kr + (p0 + nt * 8 + g) * D + 8 * t;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const uint4 kw = *reinterpret_cast<const uint4*>(krow + 32 * c);
          mma16816<T>(s[nt], qa[c].x, qb[c].x, qa[c].y, qb[c].y, kw.x, kw.y);
          mma16816<T>(s[nt], qa[c].z, qb[c].z, qa[c].w, qb[c].w, kw.z, kw.w);
        }
      }
      // s[nt][e]: row g (e < 2) or g + 8, position p0 + 8 nt + 2 t + e % 2
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = (j0 + i) * PS + p0 + 8 * nt + 2 * t + (e & 1);
          s[nt][e] = pos < len ? s[nt][e] * scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
          sum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(FULL, sum[r], 1);
        sum[r] += __shfl_xor_sync(FULL, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0], o[j][1] *= alpha[0];
        o[j][2] *= alpha[1], o[j][3] *= alpha[1];
      }
      // P as A fragments (k = the 16 positions), and its remainder
      uint32_t ph[4], pl[4];
      float r[8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        ph[2 * nt] = pack2<T>(s[nt][0], s[nt][1], r[4 * nt], r[4 * nt + 1]);
        ph[2 * nt + 1] =
            pack2<T>(s[nt][2], s[nt][3], r[4 * nt + 2], r[4 * nt + 3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float unused[2];
        pl[k] = pack2<T>(r[2 * k], r[2 * k + 1], unused[0], unused[1]);
      }
      // V: 8 x 8 blocks (positions x dims) transposed by ldmatrix; lanes
      // 8 m .. 8 m + 7 address block m: positions + 8 (m & 1), dims
      // + 8 (m >> 1)
      const uint32_t vaddr =
          smem_u32(vr + (p0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * D +
                   8 * (lane >> 4));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t v0, v1, v2, v3;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
            "%3}, [%4];\n"
            : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
            : "r"(vaddr + j * 16));
        mma16816<T>(o[j], ph[0], ph[1], ph[2], ph[3], v0, v1);
        mma16816<T>(o[j], pl[0], pl[1], pl[2], pl[3], v0, v1);
        mma16816<T>(o[j + 1], ph[0], ph[1], ph[2], ph[3], v2, v3);
        mma16816<T>(o[j + 1], pl[0], pl[1], pl[2], pl[3], v2, v3);
      }
    }
  }

  // the warps' (m, l) and O over the ring: o[j] holds rows g, g + 8, dims
  // 8 j + 2 t, + 1
  __syncthreads();
  float* cml = reinterpret_cast<float*>(smem);     // [warp][head][2]
  float* co = cml + MMA_WARPS * rep * 2;           // [warp][head][D]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = g + 8 * r;
    if (h >= rep) continue;
    if (t == 0) {
      cml[(warp * rep + h) * 2] = m[r];
      cml[(warp * rep + h) * 2 + 1] = l[r];
    }
    float* orow = co + (warp * rep + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[j][2 * r], o[j][2 * r + 1]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) {
    const int h = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w)
      mx = fmaxf(mx, cml[(w * rep + h) * 2]);
    float lw = 0.f, ow = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) {
      const float e = expf(cml[(w * rep + h) * 2] - mx);
      lw += e * cml[(w * rep + h) * 2 + 1];
      ow += e * co[(w * rep + h) * D + d];
    }
    if (NS == 1) {
      out[(row0 + h) * D + d] = from_f<T>(ow / fmaxf(lw, 1e-30f));
      continue;
    }
    const size_t slot = (row0 + h) * NS + split;
    part_acc[slot * D + d] = ow;
    if (d == 0) {
      part_ml[2 * slot] = mx;
      part_ml[2 * slot + 1] = lw;
    }
  }
  if (NS > 1)
    merge_if_last<T>(part_ml, part_acc, counter, out,
                     reinterpret_cast<float*>(smem + region + 16 * nst), b,
                     kvh, Hq, rep, D, stored, NS);
}

struct Args {
  const void *q, *kp, *vp, *pt, *lengths;
  void* out;
  float *part_ml, *part_acc;
  int* counter;
  int B, Hq, Hkv, P, PS, D, MP, pps, ns, nst;
  float scale;
  int region, smem_bytes;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

template <typename T, bool BULK>
cudaError_t launch_cuda_cores(const Args& a) {
  auto kernel = paged_attention_kernel<T, BULK>;
  cudaError_t e = set_smem(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.Hkv, a.ns), 32 * (a.Hq / a.Hkv), a.smem_bytes,
           a.stream>>>((const T*)a.q, (const T*)a.kp, (const T*)a.vp,
                       (const int*)a.pt, (const int*)a.lengths, (T*)a.out,
                       a.part_ml, a.part_acc, a.counter, a.Hq, a.Hkv, a.P,
                       a.PS, a.D, a.MP, a.pps, a.nst, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a) {
  auto kernel = paged_attention_mma_kernel<T, D>;
  cudaError_t e = set_smem(kernel, a.smem_bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.B * a.Hkv, a.ns), 32 * MMA_WARPS, a.smem_bytes,
           a.stream>>>((const T*)a.q, (const T*)a.kp, (const T*)a.vp,
                       (const int*)a.pt, (const int*)a.lengths, (T*)a.out,
                       a.part_ml, a.part_acc, a.counter, a.Hq, a.Hkv, a.P,
                       a.PS, a.MP, a.pps, a.nst, a.scale, a.region);
  return cudaGetLastError();
}

// path: 0 CUDA cores with bulk copies, 1 CUDA cores reading global
// memory, 2 tensor cores (the wrapper picks it)
template <typename T>
cudaError_t dispatch(int path, const Args& a) {
  if (path == 1) return launch_cuda_cores<T, false>(a);
  if constexpr (!std::is_same<T, float>::value) {
    if (path == 2 && a.D == 64) return launch_mma<T, 64>(a);
    if (path == 2 && a.D == 128) return launch_mma<T, 128>(a);
  }
  if (path == 2) return cudaErrorInvalidValue;
  return launch_cuda_cores<T, true>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  path: 0 CUDA cores with
// bulk copies (every page of the pools a 16-byte multiple on a 16-byte
// boundary, nst stages in smem_bytes), 1 CUDA cores reading global
// memory, 2 tensor cores (bf16 / f16, bulk copies, PS a multiple of 16,
// D 64 or 128, Hq / Hkv <= 16, nst >= pps; `region` the bytes of the ring
// or of the warps' combine, whichever is larger, rounded to 16).
// part_ml (B, Hq, ns, 2) and part_acc (B, Hq, ns, D) f32 scratch and
// counter (B * Hkv,) int32 zeros, unused when ns == 1.
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* kp, const void* vp,
                                      const void* pt, const void* lengths,
                                      void* out, void* part_ml,
                                      void* part_acc, void* counter, int B,
                                      int Hq, int Hkv, int P, int PS, int D,
                                      int MP, int pps, int ns, int nst,
                                      float scale, int path, int region,
                                      int smem_bytes, void* stream) {
  const Args a{q, kp, vp, pt, lengths, out, (float*)part_ml,
               (float*)part_acc, (int*)counter, B, Hq, Hkv, P, PS, D, MP,
               pps, ns, nst, scale, region, smem_bytes,
               (cudaStream_t)stream};
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<float>(path, a);
  else if (dtype == 1)
    e = dispatch<__nv_bfloat16>(path, a);
  else if (dtype == 2)
    e = dispatch<__half>(path, a);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
