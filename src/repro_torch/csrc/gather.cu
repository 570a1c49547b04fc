// Response gather of the trustee serve, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_serve.py, function _gather_kernel
// (its pallas_call in _gather) — its table reads; the ADD prior it also
// carried across row tiles moves to segmented_add.cu — and the CAS compare
// the JAX wrapper ran in plain jnp after it (delegation_serve.py:317).
//
// What it computes, for every trustee shard at once: each row whose lane
// is `which` copies its key's table line into out[row]; with `expect`
// given (the CAS lane) it also sets flag[row] = all(cur == expect).  A
// lane row's key outside [0, K) reads the clamped line (key 0 or K - 1),
// as the plain version does: a key past the table is clamped for reads
// and for writes on every path.  Rows of other lanes are left untouched,
// in out and in flag.  The serve calls it once per read phase on the
// table as it stands at that phase — GET before the PUT commit, the ADD
// base after it, the CAS current after the ADD commit — which is the
// phase order the TPU kernel kept with three table snapshots (T0, T1,
// T2).
//
// What bounds it: bytes — the T*N key and lane entries, and one table line
// read plus one response row written per row of the lane (with expect, an
// expect row read and a flag word written too).  The lines sit at random
// keys and each moves in its own sectors, so in practice it is the
// latency of those random reads (the tables of the main paths stay in the
// 50 MB L2) and the number of them kept in flight.
//
// What the design does about it: the TPU kernel gathered through (br, bk)
// one-hot matmuls over every key tile; here rows are read with indexed
// loads, and the launch is shaped so that each row costs one dependent
// step after its lane and key:
//   * the T*N rows are one flat range, a row a thread, so every warp load
//     of lanes and keys and every warp store of response rows is
//     contiguous; the grid is gather_plan's (kernels/delegation_serve.py),
//     a thread or a warp for every row;
//   * a thread loads its row's lane and key together, unconditionally,
//     and works out the line's address before it looks at the lane; the
//     line (and expect row) load and the store are predicated on it, with
//     no early exit: the only dependent chain is index -> line -> store
//     (an early-exit form of the same steps timed 10-25% slower at
//     kv_mixed on an H100);
//   * a row moves in 16-byte pieces where W % 4 == 0 and the buffers are
//     aligned (V = 4: one load and one store a row at W 4), else word by
//     word; the CAS compare folds every word without a short circuit;
//   * rows wider than WIDE_WORDS take a warp each, the warp's lanes on
//     neighbouring pieces, so a row of 1,100 words is 9 coalesced steps of
//     a warp and not one thread's loop;
//   * table, expect, keys and lanes are read through the read-only path
//     (ld.global.nc): nothing the launch writes aliases them.
// One launch, no scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;          // a block: 8 warps
constexpr int WARPS = THREADS / 32;   // rows a block on the wide path
constexpr int WIDE_WORDS = 32;        // wider rows take a warp each
constexpr int UNROLL = 4;             // pieces a lane keeps in flight (wide)
constexpr unsigned FULL = 0xffffffffu;

template <int V>
using VecT = typename std::conditional<V == 4, float4, float>::type;

__device__ __forceinline__ float4 ldro(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ldro(const float* p) { return __ldg(p); }

__device__ __forceinline__ bool same(float4 a, float4 b) {
  return (a.x == b.x) & (a.y == b.y) & (a.z == b.z) & (a.w == b.w);
}
__device__ __forceinline__ bool same(float a, float b) { return a == b; }

__device__ __forceinline__ size_t line_of(int r, int key, int N, int K,
                                          int W) {
  const int k = min(max(key, 0), K - 1);
  return ((size_t)(r / N) * K + k) * W;
}

// W <= WIDE_WORDS: a row a thread.
template <int V>
__global__ void __launch_bounds__(THREADS) gather_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ lane, int which,
    const float* __restrict__ expect, int rows, int N, int K, int W,
    float* __restrict__ out, int32_t* __restrict__ flag) {
  using Vec = VecT<V>;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const int l = r < rows ? __ldg(lane + r) : -1;
  const int key = r < rows ? __ldg(keys + r) : 0;
  const bool on = l == which;
  const size_t src = line_of(r, key, N, K, W);
  bool eq = true;
  const int groups = W / V;
  for (int g = 0; g < groups; ++g) {
    Vec v, e;
    if (on) v = ldro(reinterpret_cast<const Vec*>(table + src) + g);
    if (expect != nullptr && on)
      e = ldro(reinterpret_cast<const Vec*>(expect + (size_t)r * W) + g);
    if (!on) continue;
    reinterpret_cast<Vec*>(out + (size_t)r * W)[g] = v;
    if (expect != nullptr) eq &= same(v, e);
  }
  if (expect != nullptr && on) flag[r] = eq ? 1 : 0;
}

// W > WIDE_WORDS: a warp a row, its lanes on neighbouring pieces.
template <int V>
__global__ void __launch_bounds__(THREADS) gather_wide_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ lane, int which,
    const float* __restrict__ expect, int rows, int N, int K, int W,
    float* __restrict__ out, int32_t* __restrict__ flag) {
  using Vec = VecT<V>;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int ln = threadIdx.x & 31;
  if (r >= rows) return;
  const int l = __ldg(lane + r), key = __ldg(keys + r);
  if (l != which) return;                        // the whole warp leaves
  const int groups = W / V;
  const Vec* src =
      reinterpret_cast<const Vec*>(table + line_of(r, key, N, K, W));
  const Vec* cmp = expect == nullptr ? nullptr
      : reinterpret_cast<const Vec*>(expect + (size_t)r * W);
  Vec* dst = reinterpret_cast<Vec*>(out + (size_t)r * W);
  bool eq = true;
  for (int g0 = ln; g0 < groups; g0 += 32 * UNROLL) {
    Vec v[UNROLL], e[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g0 + 32 * u < groups) v[u] = ldro(src + g0 + 32 * u);
    if (expect != nullptr) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (g0 + 32 * u < groups) e[u] = ldro(cmp + g0 + 32 * u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (g0 + 32 * u >= groups) continue;
      dst[g0 + 32 * u] = v[u];
      if (expect != nullptr) eq &= same(v[u], e[u]);
    }
  }
  if (expect != nullptr) {
    eq = __all_sync(FULL, eq);
    if (ln == 0) flag[r] = eq ? 1 : 0;
  }
}

__global__ void gather_empty_kernel() {}

}  // namespace

// `blocks` blocks of THREADS (gather_plan's grid: a thread a row, or a
// warp a row where W > WIDE_WORDS); `vec` (1 or 4) the piece a row moves
// in
extern "C" int gather_launch(const void* table, const void* keys,
                             const void* lane, int which, const void* expect,
                             void* out, void* flag, int T, int N, int K,
                             int W, int vec, int blocks, void* stream) {
  const int rows = T * N;
  if ((vec != 1 && vec != 4)
      || (long long)blocks * (W > WIDE_WORDS ? WARPS : THREADS) < rows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* tb = (const float*)table;
  const auto* ks = (const int32_t*)keys;
  const auto* ls = (const int32_t*)lane;
  const auto* ex = (const float*)expect;
  auto* o = (float*)out;
  auto* f = (int32_t*)flag;
  auto go = W > WIDE_WORDS
      ? (vec == 4 ? gather_wide_kernel<4> : gather_wide_kernel<1>)
      : (vec == 4 ? gather_kernel<4> : gather_kernel<1>);
  go<<<blocks, THREADS, 0, s>>>(tb, ks, ls, which, ex, rows, N, K, W, o, f);
  return (int)cudaGetLastError();
}

// an empty kernel on gather_launch's grid and block: the floor a launch is
// weighed against
extern "C" int gather_empty_launch(int blocks, void* stream) {
  gather_empty_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
