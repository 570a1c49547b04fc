// Fetch-and-add of the trustee serve: a segmented scan across blocks, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_serve.py, function
// _scatter_add_kernel (its pallas_call in _scatter_add), and the ADD-prior
// carry that _gather_kernel threaded from row tile to row tile through a
// VMEM scratch keyed by Grouping.tile_meta's `cont`.
//
// What it computes, for every trustee shard at once, over the rows in
// sorted (op, key) order (order[p] is the request row at sorted position
// p, sid[p] its segment's first position, seg_end[p] one past its last):
//   * every ADD row adds its prior — the sum of the deltas of the earlier
//     rows of its segment — to resp[row], which already holds the ADD base
//     the gather read after the PUT commit;
//   * each segment's last ADD row adds the segment total to its key's
//     table line, in place.  One writer per line: deterministic, and no
//     float atomics.
//
// What bounds it: bytes — N index entries and N*W deltas read, N*W
// response words read and written, one table line per segment.
//
// What the design does about it: the TPU grid ran in order, so the kernel
// could carry a running sum from one row tile to the next.  Hopper blocks
// run in parallel and in no order, and a Zipf hot key forms one segment
// spanning many blocks, so the prefix is a real segmented scan in three
// launches: (1) each block scans its BS rows (Hillis-Steele over
// (head flag, value) pairs in shared memory) and records its exclusive
// in-block prefixes, its aggregate and its first segment head; (2) one
// block per shard walks the block aggregates in order to get each
// block's carry-in; (3) a fix-up adds the carry to the rows before each
// block's first head and applies the responses and the table totals.
// The scratch (in-block prefixes, aggregates, carries, first heads) is
// allocated by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BS = 256;  // rows per scan block
constexpr int LANE_ADD = 2;

__global__ void seg_add_local(const int32_t* __restrict__ order,
                              const int32_t* __restrict__ sid,
                              const int32_t* __restrict__ lane,
                              const float* __restrict__ value, int N, int W,
                              int nb, float* __restrict__ prior_local,
                              float* __restrict__ agg,
                              int32_t* __restrict__ first_head) {
  __shared__ float sv[BS];
  __shared__ int sf[BS];
  __shared__ int fh;
  const int i = threadIdx.x;
  const int b = blockIdx.x;
  const size_t o = (size_t)blockIdx.y * N;
  const int p = b * BS + i;
  const bool valid = p < N;
  const int row = valid ? order[o + p] : 0;
  const bool is_add = valid && lane[o + row] == LANE_ADD;
  const bool head = valid && sid[o + p] == p;
  if (i == 0) fh = BS;
  __syncthreads();
  if (head) atomicMin(&fh, i);
  __syncthreads();
  const size_t ob = (size_t)blockIdx.y * nb + b;
  if (i == 0) first_head[ob] = fh;

  for (int c = 0; c < W; ++c) {
    float v = is_add ? value[(o + row) * W + c] : 0.0f;
    int f = head ? 1 : 0;
    sv[i] = v;
    sf[i] = f;
    __syncthreads();
    // inclusive segmented scan: (pf, pv) earlier (+) (f, v) later is
    // (pf | f, f ? v : pv + v)
    for (int off = 1; off < BS; off <<= 1) {
      float pv = 0.0f;
      int pf = 0;
      if (i >= off) {
        pv = sv[i - off];
        pf = sf[i - off];
      }
      __syncthreads();
      if (i >= off) {
        if (!f) v = pv + v;
        f |= pf;
      }
      sv[i] = v;
      sf[i] = f;
      __syncthreads();
    }
    // exclusive in-block prefix: 0 at a segment head and at the block's
    // first row (the carry covers that one), else the previous inclusive
    if (valid) prior_local[(o + p) * W + c] = (head || i == 0) ? 0.0f : sv[i - 1];
    if (i == BS - 1) agg[ob * W + c] = v;
    __syncthreads();
  }
}

__global__ void seg_add_carry(const float* __restrict__ agg,
                              const int32_t* __restrict__ first_head, int nb,
                              int W, float* __restrict__ carry_in) {
  const size_t ob = (size_t)blockIdx.x * nb;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float carry = 0.0f;
    for (int b = 0; b < nb; ++b) {
      carry_in[(ob + b) * W + c] = carry;
      const float a = agg[(ob + b) * W + c];
      carry = first_head[ob + b] < BS ? a : carry + a;
    }
  }
}

__global__ void seg_add_fixup(const int32_t* __restrict__ order,
                              const int32_t* __restrict__ seg_end,
                              const int32_t* __restrict__ lane,
                              const int32_t* __restrict__ keys,
                              const float* __restrict__ value,
                              const float* __restrict__ prior_local,
                              const float* __restrict__ carry_in,
                              const int32_t* __restrict__ first_head, int N,
                              int K, int W, int nb, float* __restrict__ resp,
                              float* __restrict__ table) {
  const int i = threadIdx.x;
  const int b = blockIdx.x;
  const int p = b * BS + i;
  if (p >= N) return;
  const size_t o = (size_t)blockIdx.y * N;
  const int row = order[o + p];
  if (lane[o + row] != LANE_ADD) return;
  const size_t ob = (size_t)blockIdx.y * nb + b;
  const bool lead = i < first_head[ob];
  const bool last = seg_end[o + p] - 1 == p;
  const int k = keys[o + row];
  float* line = table + ((size_t)blockIdx.y * K + k) * W;
  const bool commit = last && k >= 0 && k < K;
  for (int c = 0; c < W; ++c) {
    float pr = prior_local[(o + p) * W + c];
    if (lead) pr = carry_in[ob * W + c] + pr;
    resp[(o + row) * W + c] += pr;
    if (commit) line[c] += pr + value[(o + row) * W + c];
  }
}

extern "C" int segmented_add_launch(
    void* table, void* resp, const void* keys, const void* lane,
    const void* order, const void* sid, const void* seg_end,
    const void* value, void* prior_local, void* agg, void* carry_in,
    void* first_head, int T, int N, int K, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (N + BS - 1) / BS;
  const dim3 grid(nb, T);
  seg_add_local<<<grid, BS, 0, s>>>(
      (const int32_t*)order, (const int32_t*)sid, (const int32_t*)lane,
      (const float*)value, N, W, nb, (float*)prior_local, (float*)agg,
      (int32_t*)first_head);
  seg_add_carry<<<T, W < 1024 ? W : 1024, 0, s>>>(
      (const float*)agg, (const int32_t*)first_head, nb, W,
      (float*)carry_in);
  seg_add_fixup<<<grid, BS, 0, s>>>(
      (const int32_t*)order, (const int32_t*)seg_end, (const int32_t*)lane,
      (const int32_t*)keys, (const float*)value, (const float*)prior_local,
      (const float*)carry_in, (const int32_t*)first_head, N, K, W, nb,
      (float*)resp, (float*)table);
  return (int)cudaGetLastError();
}

// rows per scan block, so the caller can size the scratch
extern "C" int segmented_add_block_rows() { return BS; }
