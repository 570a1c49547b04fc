// Client-side pack of the delegation channel, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_pack.py, function _pack_kernel
// (its pallas_call in delegation_pack), together with the second_round
// rerun of that kernel on the rejected rows (src/repro/core/channel.py,
// _pack_with_kernel).
//
// What it computes, for every client shard d at once: each row i with a
// destination t = dst[d, i] in [0, T) gets its FIFO rank r among the rows
// of shard d addressed to t.  Rank r < C puts the row's W 32-bit words in
// the primary block at slot t*C + r; C <= r < C + C2 puts it in the
// second_round block at t*C2 + (r - C) (request_slot T*C + t*C2 + r - C);
// any other row gets request_slot -1.  counts/counts2 are the clamped
// per-destination row counts and totals the pre-capacity demand.  Unused
// slot rows are zeroed.
//
// What bounds it: bytes.  The work is a row copy; the least traffic is
// the R*W payload words read once, the (T*C + T*C2)*W slot words written
// once, and the R-entry index arrays.  At the MoE prefill's shapes (rows
// of 1,024 or 2,049 words) that is 1.3-1.5 GB, about 0.4 ms at 3.35 TB/s;
// the trustees' pack by expert leaves some three quarters of its 805 MB
// of slots empty, so its zero stores are most of its bytes.
//
// What the design does about it.  The TPU kernel expressed the rank as a
// lower-triangular matmul and the scatter as a one-hot matmul, because an
// MXU moves data best as dense products.  The first CUDA kernel ran one
// block per shard (4 blocks on a 132-SM card at the MoE shapes), advanced
// ranks warp by warp with a barrier per warp, and copied each row word by
// word from one thread: no load coalesced, about 23 GB/s.  Here four
// short launches on the stream, their grids set from the shapes alone (no
// host readback: the round stays capturable as a CUDA graph):
//   (a) delegation_pack_count: each shard's rows are cut into chunks of a
//       fixed size; a block per (chunk, shard) counts its rows per
//       destination (warp-aggregated shared atomics);
//   (b) delegation_pack_scan: a thread per (shard, destination) turns the
//       chunks' counts into each chunk's first rank (an exclusive scan),
//       and writes totals, counts and counts2;
//   (c) delegation_pack_rank: a block per (chunk, shard) ranks its rows in
//       row order, FIFO: __match_any_sync groups a warp's lanes by
//       destination (the popcount of the lower lanes is the rank inside
//       the warp), one scan over the warps' counts in shared memory gives
//       each warp's base (no turn loop of barriers), plus the chunk's
//       first rank; it writes request_slot and, for every placed row, the
//       slot's source row;
//   (d) delegation_pack_place: a walk over every slot row of both blocks,
//       spread over the whole card, lanes on consecutive words: a filled
//       slot copies its source row, an empty one is zeroed.  A row of 32
//       words or more goes to a group of lanes (16-byte vectors where
//       W % 4 == 0 and the rows are aligned, else 4-byte words with eight
//       loads in flight a lane; zeros in 16-byte stores from the first
//       aligned word); narrower rows are walked flat, a thread a word.
//       Integers of any size move exactly: nothing but 32-bit words is
//       read or written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int COUNT_THREADS = 256;
constexpr int SCAN_THREADS = 128;
constexpr int PLACE_THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ bool active(int t, int T) {
  return t >= 0 && t < T;
}

}  // namespace

// (a) rows [c * chunk, min((c + 1) * chunk, R)) of shard d, counted per
// destination into cnt[d, c, :]
__global__ void __launch_bounds__(COUNT_THREADS)
    delegation_pack_count(const int32_t* __restrict__ dst, int R, int T,
                          int chunk, int32_t* __restrict__ cnt) {
  extern __shared__ int hist[];
  const int c = blockIdx.x, d = blockIdx.y, nch = gridDim.x;
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < T; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  const int lo = c * chunk, hi = min(lo + chunk, R);
  for (int base = lo; base < hi; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int t = i < hi ? dst[(size_t)d * R + i] : -1;
    const bool act = active(t, T);
    const unsigned peers = __match_any_sync(FULL, act ? t : -1);
    if (act && lane == __ffs(peers) - 1) atomicAdd(&hist[t], __popc(peers));
  }
  __syncthreads();
  int32_t* out = cnt + ((size_t)d * nch + c) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) out[t] = hist[t];
}

// (b) cnt[d, :, t] -> the exclusive prefix over the chunks, in place;
// totals, counts and counts2 of (d, t)
__global__ void __launch_bounds__(SCAN_THREADS)
    delegation_pack_scan(int32_t* __restrict__ cnt, int nch, int T, int C,
                         int C2, int32_t* __restrict__ counts,
                         int32_t* __restrict__ counts2,
                         int32_t* __restrict__ totals) {
  const int d = blockIdx.y, t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int32_t* col = cnt + (size_t)d * nch * T + t;
  int run = 0;
  for (int c = 0; c < nch; ++c) {
    const int n = col[(size_t)c * T];
    col[(size_t)c * T] = run;
    run += n;
  }
  const size_t o = (size_t)d * T + t;
  totals[o] = run;
  counts[o] = min(run, C);
  counts2[o] = min(max(run - C, 0), C2);
}

// (c) the FIFO rank of each row of chunk c of shard d, in row order, from
// the chunk's first rank per destination (base[d, c, :]); shared memory:
// run[T], then the warps' counts wc[nw][T] and bases pre[nw][T]
__global__ void delegation_pack_rank(const int32_t* __restrict__ dst,
                                     const int32_t* __restrict__ base, int R,
                                     int T, int C, int C2, int chunk,
                                     int32_t* __restrict__ request_slot,
                                     int32_t* __restrict__ src_of) {
  extern __shared__ int sh[];
  const int c = blockIdx.x, d = blockIdx.y, nch = gridDim.x;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* run = sh;
  int* wc = sh + T;
  int* pre = wc + nw * T;
  const int32_t* b0 = base + ((size_t)d * nch + c) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) run[t] = b0[t];
  for (int k = threadIdx.x; k < nw * T; k += blockDim.x) wc[k] = 0;
  __syncthreads();
  const int lo = c * chunk, hi = min(lo + chunk, R);
  const unsigned lower = (1u << lane) - 1u;
  const int32_t* dd = dst + (size_t)d * R;
  int32_t* rs = request_slot + (size_t)d * R;
  int32_t* so = src_of + (size_t)d * T * (C + C2);
  for (int b = lo; b < hi; b += blockDim.x) {
    const int i = b + threadIdx.x;
    const int t = i < hi ? dd[i] : -1;
    const bool act = active(t, T);
    const unsigned peers = __match_any_sync(FULL, act ? t : -1);
    if (act && lane == 31 - __clz(peers)) wc[warp * T + t] = __popc(peers);
    __syncthreads();
    // per destination, the warps in order: each warp's first rank
    for (int u = threadIdx.x; u < T; u += blockDim.x) {
      int r = run[u];
      for (int w = 0; w < nw; ++w) {
        const int n = wc[w * T + u];
        wc[w * T + u] = 0;
        pre[w * T + u] = r;
        r += n;
      }
      run[u] = r;
    }
    __syncthreads();
    if (i < hi) {
      int slot = -1;
      if (act) {
        const int rank = pre[warp * T + t] + __popc(peers & lower);
        if (rank < C)
          slot = t * C + rank;
        else if (rank < C + C2)
          slot = T * C + t * C2 + (rank - C);
        if (slot >= 0) so[slot] = i;
      }
      rs[i] = slot;
    }
  }
}

namespace {

// copy W words from src to out, lane j of a group of G
__device__ __forceinline__ void copy_row(int32_t* __restrict__ out,
                                         const int32_t* __restrict__ src,
                                         int W, int j, int G, bool vec) {
  if (vec) {                 // W % 4 == 0, both rows 16-byte aligned
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* o4 = reinterpret_cast<int4*>(out);
    const int n4 = W >> 2;
    for (int k = j; k < n4; k += UNROLL * G) {
      int4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (k + u * G < n4) v[u] = s4[k + u * G];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (k + u * G < n4) o4[k + u * G] = v[u];
    }
    return;
  }
  for (int k = j; k < W; k += UNROLL * G) {
    int32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (k + u * G < W) v[u] = src[k + u * G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (k + u * G < W) out[k + u * G] = v[u];
  }
}

// zero W words at out, lane j of a group of G: 4-byte stores up to the
// first 16-byte boundary, 16-byte stores, 4-byte stores for the tail
__device__ __forceinline__ void zero_row(int32_t* __restrict__ out, int W,
                                         int j, int G) {
  int head = (int)((4 - ((reinterpret_cast<uintptr_t>(out) >> 2) & 3)) & 3);
  head = min(head, W);
  if (j < head) out[j] = 0;
  const int n4 = (W - head) >> 2;
  int4* o4 = reinterpret_cast<int4*>(out + head);
  for (int k = j; k < n4; k += G) o4[k] = make_int4(0, 0, 0, 0);
  for (int k = head + 4 * n4 + j; k < W; k += G) out[k] = 0;
}

// the slot row `row` of both blocks (primary rows first): its shard, its
// slot index in request_slot's numbering, whether its destination's count
// reaches it, and where it lies
__device__ __forceinline__ int32_t* slot_row(
    long long row, long long n1, int T, int C, int C2,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ counts2,
    int32_t* __restrict__ slots, int32_t* __restrict__ slots2, int W,
    int& d, int& s, bool& filled) {
  if (row < n1) {
    d = (int)(row / ((long long)T * C));
    s = (int)(row - (long long)d * T * C);
    filled = s % C < counts[d * T + s / C];
    return slots + row * W;
  }
  const long long r2 = row - n1;
  d = (int)(r2 / ((long long)T * C2));
  const int s2 = (int)(r2 - (long long)d * T * C2);
  filled = s2 % C2 < counts2[d * T + s2 / C2];
  s = T * C + s2;
  return slots2 + r2 * W;
}

}  // namespace

// (d) every slot row of both blocks: its source row, or zeros.  Rows of
// 32 words and more: a group of G lanes a row (32; with 16-byte vectors,
// W / 4 lanes rounded up to 8, 16 or 32), 32 / G rows to a warp, a
// grid-stride walk.  Narrower rows: a flat grid-stride walk over (slot
// row, word), a thread a word, so every warp stores 128 contiguous bytes
__global__ void __launch_bounds__(PLACE_THREADS)
    delegation_pack_place(const int32_t* __restrict__ words,
                          const int32_t* __restrict__ src_of,
                          const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ counts2, int D, int R,
                          int W, int T, int C, int C2, int G, int vec,
                          int32_t* __restrict__ slots,
                          int32_t* __restrict__ slots2) {
  const long long n1 = (long long)D * T * C;
  const long long n = n1 + (long long)D * T * C2;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int d, s;
  bool filled;
  if (G == 0) {
    for (long long e = tid; e < n * W; e += threads) {
      const long long row = e / W;
      const int k = (int)(e - row * W);
      int32_t* out = slot_row(row, n1, T, C, C2, counts, counts2, slots,
                              slots2, W, d, s, filled);
      int32_t v = 0;
      if (filled) {
        const int i = src_of[(size_t)d * T * (C + C2) + s];
        v = words[((size_t)d * R + i) * W + k];
      }
      out[k] = v;
    }
    return;
  }
  const int rpw = 32 / G, lane = threadIdx.x & 31;
  const long long step = threads / 32 * rpw;
  for (long long row = tid / 32 * rpw + lane / G; row < n; row += step) {
    int32_t* out = slot_row(row, n1, T, C, C2, counts, counts2, slots,
                            slots2, W, d, s, filled);
    if (filled) {
      const int i = src_of[(size_t)d * T * (C + C2) + s];
      copy_row(out, words + ((size_t)d * R + i) * W, W, lane % G, G,
               vec != 0);
    } else {
      zero_row(out, W, lane % G, G);
    }
  }
}

// The wrapper computes every launch parameter from the shapes alone
// (kernels/delegation_pack.py::launch_plan): chunk rows a (chunk, shard)
// block of (a) and (c), n_chunks, rank_threads (a multiple of 32, at
// most 1024) of (c), G (lanes a slot row: 32, 16 or 8 with 16-byte
// vectors, 0 for the flat walk over words) and place_blocks of (d), vec
// (W % 4 == 0 and words 16-byte aligned).
// scratch holds D * n_chunks * T + D * T * (C + C2) int32.  Returns the
// cudaError_t of the launches.
extern "C" int delegation_pack_launch(
    const void* dst, const void* words, int D, int R, int W, int T, int C,
    int C2, void* slots, void* slots2, void* counts, void* counts2,
    void* request_slot, void* totals, void* scratch, int chunk, int n_chunks,
    int rank_threads, int G, int place_blocks, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* cnt = (int32_t*)scratch;
  int32_t* src_of = cnt + (size_t)D * n_chunks * T;
  const size_t count_smem = (size_t)T * sizeof(int);
  const size_t rank_smem =
      (size_t)T * (1 + 2 * (rank_threads / 32)) * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (count_smem > 48 * 1024)
    err = cudaFuncSetAttribute(delegation_pack_count,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)count_smem);
  if (err == cudaSuccess && rank_smem > 48 * 1024)
    err = cudaFuncSetAttribute(delegation_pack_rank,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rank_smem);
  if (err != cudaSuccess) return (int)err;
  if (D == 0) return 0;
  if (n_chunks > 0)
    delegation_pack_count<<<dim3(n_chunks, D), COUNT_THREADS, count_smem,
                            s>>>((const int32_t*)dst, R, T, chunk, cnt);
  if (T > 0)
    delegation_pack_scan<<<dim3((T + SCAN_THREADS - 1) / SCAN_THREADS, D),
                           SCAN_THREADS, 0, s>>>(
        cnt, n_chunks, T, C, C2, (int32_t*)counts, (int32_t*)counts2,
        (int32_t*)totals);
  if (n_chunks > 0) {
    delegation_pack_rank<<<dim3(n_chunks, D), rank_threads, rank_smem, s>>>(
        (const int32_t*)dst, cnt, R, T, C, C2, chunk,
        (int32_t*)request_slot, src_of);
  }
  if (place_blocks > 0)
    delegation_pack_place<<<place_blocks, PLACE_THREADS, 0, s>>>(
        (const int32_t*)words, src_of, (const int32_t*)counts,
        (const int32_t*)counts2, D, R, W, T, C, C2, G, vec,
        (int32_t*)slots, (int32_t*)slots2);
  return (int)cudaGetLastError();
}
