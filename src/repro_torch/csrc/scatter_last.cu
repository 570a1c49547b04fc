// Last-writer-wins commit of the trustee serve, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_serve.py, function
// _scatter_last_kernel (its pallas_call in _scatter_last), used for the
// PUT commit and for the CAS commit of matching rows.
//
// What it computes, for every trustee shard at once: the rows arrive
// grouped — order[p] is the request row at sorted position p and sid[p]
// the first sorted position of its (op, key) segment.  In every segment
// the flagged row with the greatest sorted position (the last in request
// order: the grouping sort is stable) writes its whole value row into its
// key's table line, IN PLACE.  One lane per call, so a key has at most
// one winner and no two threads write one line.
//
// What bounds it: bytes — N order/sid/flag entries read, and one value
// row read plus one table line written per winning segment.
//
// What the design does about it: the TPU kernel found the block-local
// winner with an (br, br) same-segment matmul and wrote it through a
// (br, bk) one-hot matmul, walking every key tile for every row tile, and
// produced a fresh table copy per call (the TPU's output-revisit rule).
// Here pass 1 has each flagged row atomicMax its sorted position into its
// segment's slot of a scratch array, and pass 2 lets each segment head
// copy the winning row: two launches over N threads, no one-hot, no table
// copy.  The scratch starts at -1 (cudaMemsetAsync on the same stream).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scatter_last_mark(const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ sid,
                                  const int32_t* __restrict__ flag, int N,
                                  int32_t* __restrict__ last) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const size_t o = (size_t)blockIdx.y * N;
  if (flag[o + order[o + p]] != 0) atomicMax(&last[o + sid[o + p]], p);
}

__global__ void scatter_last_commit(const int32_t* __restrict__ order,
                                    const int32_t* __restrict__ sid,
                                    const int32_t* __restrict__ last,
                                    const int32_t* __restrict__ keys,
                                    const float* __restrict__ value, int N,
                                    int K, int W, float* __restrict__ table) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const size_t o = (size_t)blockIdx.y * N;
  if (sid[o + p] != p) return;  // one thread per segment: its head
  const int win = last[o + p];
  if (win < 0) return;
  const int row = order[o + win];
  const int k = keys[o + row];
  if (k < 0 || k >= K) return;
  const float* src = value + (o + row) * W;
  float* dst = table + ((size_t)blockIdx.y * K + k) * W;
  for (int c = 0; c < W; ++c) dst[c] = src[c];
}

extern "C" int scatter_last_launch(void* table, const void* keys,
                                   const void* order, const void* sid,
                                   const void* flag, const void* value,
                                   void* last, int T, int N, int K, int W,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(last, 0xff, (size_t)T * N * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const dim3 grid((N + threads - 1) / threads, T);
  scatter_last_mark<<<grid, threads, 0, s>>>(
      (const int32_t*)order, (const int32_t*)sid, (const int32_t*)flag, N,
      (int32_t*)last);
  scatter_last_commit<<<grid, threads, 0, s>>>(
      (const int32_t*)order, (const int32_t*)sid, (const int32_t*)last,
      (const int32_t*)keys, (const float*)value, N, K, W, (float*)table);
  return (int)cudaGetLastError();
}
