// Last-writer-wins commit of the trustee serve, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/delegation_serve.py, function
// _scatter_last_kernel (its pallas_call in _scatter_last), used for the
// PUT commit and for the CAS commit of matching rows.
//
// What it computes, for every trustee shard at once: the rows arrive
// grouped — order[p] is the request row at sorted position p and
// seg_end[p] one past the last position of its (op, key) segment.  In
// every segment the flagged row with the greatest sorted position (the
// last in request order: the grouping sort is stable) writes its whole
// value row into its key's table line, IN PLACE.  The flag of position p
// is flag[order[p]], in request order.  One lane per call, so a key has at
// most one winner and no two threads write one line.
//
// What bounds it: bytes — N order / seg_end / flag entries read, and one
// value row read plus one table line written per winning segment.  The
// flags, keys and value rows sit at request rows, reached at random
// through order, and the lines at random keys: each access moves a
// 32-byte sector for a 4- or 16-byte word.
//
// What the design does about it: the TPU kernel found the block-local
// winner with an (br, br) same-segment matmul and wrote it through a
// (br, bk) one-hot matmul, walking every key tile for every row tile.
// Here a flagged row p wins exactly when no row in (p, seg_end[p]) is
// flagged, and the flags are inputs, so the test needs no state shared
// between blocks, no scratch and one launch:
//   * a block takes TILE sorted rows, ITEMS a thread, each 32-row chunk a
//     warp's coalesced load; a ballot gives the next flagged row inside a
//     chunk, and a suffix minimum over the chunks' first flagged rows (in
//     shared memory) the next one inside the tile;
//   * the tile's last flagged row, when its segment runs past the tile,
//     is the one row that reads forward: the whole block takes THREADS *
//     AHEAD flags a step and stops at the first flagged row or at seg_end;
//   * a tile with no flagged row leaves after loading its flags; in the
//     others the flagged rows' keys and first words load while the
//     winners are settled, and each winner writes its row, a float4 at a
//     time where W % 4 == 0.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;           // a block: 8 warps
constexpr int ITEMS = 1;               // sorted rows a thread, THREADS apart
constexpr int TILE = THREADS * ITEMS;  // sorted rows a tile
constexpr int AHEAD = 4;               // rows a thread a forward-read step
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = TILE / 32;      // 32-row chunks a tile: one warp's
constexpr int NONE = INT_MAX;
constexpr unsigned FULL = 0xffffffffu;
static_assert(CHUNKS <= 32, "the suffix minimum takes one chunk a lane");

template <int V>
__global__ void __launch_bounds__(THREADS) scatter_last_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ seg_end,
    const int32_t* __restrict__ flag, const int32_t* __restrict__ keys,
    const float* __restrict__ value, float* __restrict__ table, int N, int K,
    int W) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  __shared__ int s_first[CHUNKS];   // a chunk's first flagged position
  __shared__ int s_next[CHUNKS];    // the first flagged one after the chunk
  __shared__ int s_fwd_end;         // > 0: the forward read's end
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  const size_t o = (size_t)blockIdx.y * N;
  const int t0 = blockIdx.x * TILE;
  const int t_end = min(t0 + TILE, N);
  if (tid == 0) s_fwd_end = 0;

  int row[ITEMS], end[ITEMS];
  bool fl[ITEMS];
  bool any = false;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = t0 + i * THREADS + tid;
    row[i] = p < N ? order[o + p] : 0;
    end[i] = p < N ? seg_end[o + p] : 0;
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    fl[i] = t0 + i * THREADS + tid < N && flag[o + row[i]] != 0;
    any |= fl[i];
  }
  if (!__syncthreads_or(any)) return;  // no flagged row, no winner
  // the flagged rows' keys and first words, in flight while the winners
  // are settled
  int key[ITEMS];
  Vec w0[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    key[i] = -1;
    if (fl[i]) {
      key[i] = keys[o + row[i]];
      w0[i] = *reinterpret_cast<const Vec*>(value + (o + row[i]) * W);
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned m = __ballot_sync(FULL, fl[i]);
    if (ln == 0)
      s_first[i * WARPS + warp] =
          m ? t0 + i * THREADS + warp * 32 + __ffs(m) - 1 : NONE;
  }
  __syncthreads();
  if (warp == 0) {                   // suffix minimum over the chunks
    int v = ln < CHUNKS ? s_first[ln] : NONE;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_down_sync(FULL, v, d);
      if (ln + d < 32) v = min(v, u);
    }
    const int next = __shfl_down_sync(FULL, v, 1);
    if (ln < CHUNKS) s_next[ln] = ln < 31 ? next : NONE;
  }
  __syncthreads();
  bool win[ITEMS], fwd[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const unsigned later =
        __ballot_sync(FULL, fl[i]) & (ln < 31 ? FULL << (ln + 1) : 0u);
    const int p = t0 + i * THREADS + tid;
    const int next = later ? p - ln + __ffs(later) - 1
                           : s_next[i * WARPS + warp];
    win[i] = fl[i] && (next != NONE ? next >= end[i] : end[i] <= t_end);
    // the tile's last flagged row, its segment running past the tile
    fwd[i] = fl[i] && next == NONE && end[i] > t_end;
    if (fwd[i]) s_fwd_end = end[i];
  }
  __syncthreads();
  const int e = s_fwd_end;
  if (e > 0) {            // read forward to e, THREADS * AHEAD flags a step
    bool found = false;
    for (int q0 = t_end; q0 < e && !found; q0 += THREADS * AHEAD) {
      int r[AHEAD];
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        const int q = q0 + i * THREADS + tid;
        r[i] = q < e ? order[o + q] : -1;
      }
      bool hit = false;
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) hit |= r[i] >= 0 && flag[o + r[i]] != 0;
      found = __syncthreads_or(hit);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) win[i] |= fwd[i] && !found;
  }
  // each winner writes its row into its line, V words at a time
  const int groups = W / V;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (!win[i] || key[i] < 0 || key[i] >= K) continue;
    const float* src = value + (o + row[i]) * W;
    float* dst = table + ((size_t)blockIdx.y * K + key[i]) * W;
    *reinterpret_cast<Vec*>(dst) = w0[i];
    for (int g = 1; g < groups; ++g)
      reinterpret_cast<Vec*>(dst)[g] = reinterpret_cast<const Vec*>(src)[g];
  }
}

}  // namespace

extern "C" int scatter_last_launch(void* table, const void* keys,
                                   const void* order, const void* seg_end,
                                   const void* flag, const void* value, int T,
                                   int N, int K, int W, int vec,
                                   void* stream) {
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, T);
  auto kernel = vec == 4 ? scatter_last_kernel<4> : scatter_last_kernel<1>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)order, (const int32_t*)seg_end, (const int32_t*)flag,
      (const int32_t*)keys, (const float*)value, (float*)table, N, K, W);
  return (int)cudaGetLastError();
}
