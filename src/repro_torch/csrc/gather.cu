// Response gather of the trustee serve, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_serve.py, function _gather_kernel
// (its pallas_call in _gather) — its table reads; the ADD prior it also
// carried across row tiles moves to segmented_add.cu — and the CAS compare
// the JAX wrapper ran in plain jnp after it (delegation_serve.py:317).
//
// What it computes, for every trustee shard at once: each row whose lane
// is `which` copies its key's table line into out[row]; with `expect`
// given (the CAS lane) it also sets flag[row] = all(cur == expect).  The
// serve calls it once per read phase on the table as it stands at that
// phase — GET before the PUT commit, the ADD base after it, the CAS
// current after the ADD commit — which is the phase order the TPU kernel
// kept with three table snapshots (T0, T1, T2).
//
// What bounds it: bytes — the N key and lane entries, and one table line
// read plus one response row written per row of the lane.
//
// What the design does about it: the TPU kernel gathered through (br, bk)
// one-hot matmuls over every key tile; here each thread reads its row's
// line with an indexed load.  No snapshot copies: the caller orders the
// phases on one stream and the table is updated in place between them.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_kernel(const float* __restrict__ table,
                              const int32_t* __restrict__ keys,
                              const int32_t* __restrict__ lane, int which,
                              const float* __restrict__ expect, int N, int K,
                              int W, float* __restrict__ out,
                              int32_t* __restrict__ flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t o = (size_t)blockIdx.y * N + i;
  if (lane[o] != which) return;
  const int k = keys[o];
  if (k < 0 || k >= K) return;
  const float* src = table + ((size_t)blockIdx.y * K + k) * W;
  float* dst = out + o * W;
  bool eq = true;
  for (int c = 0; c < W; ++c) {
    const float v = src[c];
    dst[c] = v;
    if (expect != nullptr) eq = eq && (v == expect[o * W + c]);
  }
  if (expect != nullptr) flag[o] = eq ? 1 : 0;
}

extern "C" int gather_launch(const void* table, const void* keys,
                             const void* lane, int which, const void* expect,
                             void* out, void* flag, int T, int N, int K,
                             int W, void* stream) {
  const int threads = 256;
  const dim3 grid((N + threads - 1) / threads, T);
  gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int32_t*)keys, (const int32_t*)lane, which,
      (const float*)expect, N, K, W, (float*)out, (int32_t*)flag);
  return (int)cudaGetLastError();
}
