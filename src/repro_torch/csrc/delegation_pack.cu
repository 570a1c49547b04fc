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
// once, and the R-entry index arrays.
//
// What the design does about it: the TPU kernel expressed the rank as a
// lower-triangular matmul and the scatter as a one-hot matmul, because an
// MXU moves data best as dense products.  Here the rank is a running
// per-destination count in shared memory, advanced warp by warp over
// chunks of blockDim rows (__match_any_sync groups the lanes of a warp
// that share a destination; the popcount of the lower lanes is the rank
// inside the warp), and each row is copied word for word straight to its
// slot — no one-hot, and integers of any size move exactly.  One block
// per client shard walks its rows in order, which is what FIFO needs;
// the blocks of all shards run in one launch.  This is the simple first
// version: its copies are not coalesced and one block per shard leaves
// most SMs idle at 8 shards.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void delegation_pack_kernel(
    const int32_t* __restrict__ dst, const int32_t* __restrict__ words,
    int R, int W, int T, int C, int C2,
    int32_t* __restrict__ slots, int32_t* __restrict__ slots2,
    int32_t* __restrict__ counts, int32_t* __restrict__ counts2,
    int32_t* __restrict__ request_slot, int32_t* __restrict__ totals) {
  extern __shared__ int running[];
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  dst += (size_t)d * R;
  words += (size_t)d * R * W;
  request_slot += (size_t)d * R;
  slots += (size_t)d * T * C * W;
  slots2 += (size_t)d * T * C2 * W;
  counts += (size_t)d * T;
  counts2 += (size_t)d * T;
  totals += (size_t)d * T;

  for (int t = tid; t < T; t += blockDim.x) running[t] = 0;
  __syncthreads();

  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < R; base += blockDim.x) {
    const int i = base + tid;
    const int t = (i < R) ? dst[i] : -1;
    const bool act = (t >= 0) && (t < T);
    const unsigned peers = __match_any_sync(0xffffffffu, act ? t : -1);
    const int before = __popc(peers & lower);
    const bool leader = lane == 31 - __clz(peers);
    int rank = 0;
    // warps take their turn in row order, so ranks stay FIFO per shard
    for (int w = 0; w < nwarps; ++w) {
      if (warp == w) {
        if (act) rank = running[t] + before;
        __syncwarp();
        if (act && leader) running[t] += __popc(peers);
      }
      __syncthreads();
    }
    if (i < R) {
      int slot = -1;
      const int32_t* src = words + (size_t)i * W;
      if (act && rank < C) {
        slot = t * C + rank;
        int32_t* out = slots + (size_t)slot * W;
        for (int k = 0; k < W; ++k) out[k] = src[k];
      } else if (act && rank < C + C2) {
        const int s2 = t * C2 + (rank - C);
        int32_t* out = slots2 + (size_t)s2 * W;
        for (int k = 0; k < W; ++k) out[k] = src[k];
        slot = T * C + s2;
      }
      request_slot[i] = slot;
    }
  }

  // running[] is final here (the turn loop ends on a barrier); rows at or
  // past a destination's count were never written above
  for (int t = tid; t < T; t += blockDim.x) {
    const int n = running[t];
    totals[t] = n;
    counts[t] = min(n, C);
    counts2[t] = min(max(n - C, 0), C2);
  }
  for (int s = tid; s < T * C; s += blockDim.x) {
    const int t = s / C;
    if (s - t * C >= running[t]) {
      int32_t* out = slots + (size_t)s * W;
      for (int k = 0; k < W; ++k) out[k] = 0;
    }
  }
  for (int s = tid; s < T * C2; s += blockDim.x) {
    const int t = s / C2;
    if (C + (s - t * C2) >= running[t]) {
      int32_t* out = slots2 + (size_t)s * W;
      for (int k = 0; k < W; ++k) out[k] = 0;
    }
  }
}

extern "C" int delegation_pack_launch(
    const void* dst, const void* words, int D, int R, int W, int T, int C,
    int C2, void* slots, void* slots2, void* counts, void* counts2,
    void* request_slot, void* totals, int threads, void* stream) {
  const size_t smem = (size_t)T * sizeof(int);
  delegation_pack_kernel<<<D, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)dst, (const int32_t*)words, R, W, T, C, C2,
      (int32_t*)slots, (int32_t*)slots2, (int32_t*)counts,
      (int32_t*)counts2, (int32_t*)request_slot, (int32_t*)totals);
  return (int)cudaGetLastError();
}
