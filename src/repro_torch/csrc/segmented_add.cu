// Fetch-and-add of the trustee serve: a one-pass segmented scan with a
// deterministic look-back, for Hopper (sm_90a).
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
//     ADD rows of its segment — to resp[row], which already holds the ADD
//     base the gather read after the PUT commit;
//   * each segment's last row, when it is an ADD row, adds the segment
//     total to its key's table line, in place.  One writer per line:
//     deterministic, and no float atomics.
//
// What bounds it: bytes — N order / sid / seg_end / lane entries, the ADD
// rows' deltas read and responses read and written, one table line in and
// out per ADD segment.  All but order, sid and seg_end are reached at
// random through order (a row's lane, delta, response and key sit at its
// request row, a line at its key), so each access moves a 32-byte sector
// for a 4- or 16-byte word: the byte bound is not a reachable floor.
//
// What the design does about it: one launch a call, and nothing per row
// leaves the chip but the responses and the table lines.
//   * A block takes its tile (TILE sorted rows of one shard) from an
//     atomic ticket, so tiles start in ticket order and a block only ever
//     waits on tiles that have already started: no deadlock, whatever
//     order the hardware schedules blocks in.
//   * Every row's request row, head flag and lane load first; a tile
//     without an ADD row (most of them: each shard's sorted ADD rows are
//     one run) publishes zero aggregates and leaves.  The others load
//     seg_end and the keys of their segments' last ADD rows, then the
//     deltas and responses.
//   * Inside a tile each thread holds ITEMS consecutive rows; their words
//     load VEC at a time (a float4 where W % 4 == 0) and the segmented scan
//     over (head flag, value) pairs runs in the thread, then across the
//     warp with __shfl_up_sync, then across the block's warps by warp 0's
//     shuffles: two barriers a group of VEC words, none a word.
//   * Each tile publishes a descriptor per word group as soon as warp 0
//     has scanned the warps — its aggregate (the sum from its last
//     segment head to its end, or over the whole tile if it holds no
//     head) and a status word saying that it is ready and whether the
//     tile holds a head.  A tile whose leading rows continue an earlier
//     segment (and hold an ADD row) then looks back: the block reads
//     THREADS predecessors' descriptors a step, keeps those up to the
//     nearest one that holds a head, and sums them in a fixed tree.  Only
//     aggregates are summed, never a predecessor's inclusive prefix that
//     happens to be ready, so the carry — and every float result — is the
//     same from run to run; a hot segment over up to THREADS tiles costs
//     one step.
//   * Wide rows loop over word groups; each group scans, publishes and
//     looks back on its own descriptors, so any W works the same way.
// Scratch: the descriptors only (T * tiles * W floats of aggregates, and
// T * tiles * W / VEC status words plus the ticket, zeroed by one
// cudaMemsetAsync on the same stream before the launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;          // a block: 16 warps
constexpr int ITEMS = 2;              // consecutive sorted rows a thread
constexpr int TILE = THREADS * ITEMS; // sorted rows a tile
constexpr int WARPS = THREADS / 32;
static_assert(WARPS <= 32, "warp 0 scans the warps' runs, a lane each");
constexpr int LANE_ADD = 2;
constexpr unsigned READY = 1u, HAS_HEAD = 2u;  // descriptor status bits
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1ll << 26;    // a lost descriptor traps

template <int V>
struct Words {
  float w[V];
};

template <int V>
__device__ __forceinline__ Words<V> zero() {
  Words<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.w[c] = 0.0f;
  return r;
}

template <int V>
__device__ __forceinline__ Words<V> add(const Words<V>& a, const Words<V>& b) {
  Words<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.w[c] = a.w[c] + b.w[c];
  return r;
}

template <int V>
__device__ __forceinline__ Words<V> load(const float* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) r.w[c] = p[c];
  }
  return r;
}

// an L2 load: another block's descriptor, past the acquire of its status
template <int V>
__device__ __forceinline__ Words<V> load_cg(const float* p) {
  Words<V> r;
  if constexpr (V == 4) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
    r.w[0] = x.x, r.w[1] = x.y, r.w[2] = x.z, r.w[3] = x.w;
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) r.w[c] = __ldcg(p + c);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Words<V>& v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
#pragma unroll
    for (int c = 0; c < V; ++c) p[c] = v.w[c];
  }
}

template <int V>
__device__ __forceinline__ Words<V> shfl_up(const Words<V>& v, int d) {
  Words<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.w[c] = __shfl_up_sync(FULL, v.w[c], d);
  return r;
}

template <int V>
__device__ __forceinline__ Words<V> shfl_down(const Words<V>& v, int d) {
  Words<V> r;
#pragma unroll
  for (int c = 0; c < V; ++c) r.w[c] = __shfl_down_sync(FULL, v.w[c], d);
  return r;
}

// (flag, value) of an earlier run followed by (f, v) of a later one
template <int V>
__device__ __forceinline__ void combine(int& flag, Words<V>& value, int f,
                                        const Words<V>& v) {
  value = f ? v : add(value, v);
  flag |= f;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// inclusive segmented scan of (flag, value) runs across a warp's lanes
template <int V>
__device__ __forceinline__ void scan_warp(int& f, Words<V>& x, int ln) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int pf = __shfl_up_sync(FULL, f, d);
    const Words<V> px = shfl_up(x, d);
    if (ln >= d) {
      x = f ? x : add(px, x);
      f |= pf;
    }
  }
}

// The carry into tile b of a shard, for word group g, by the whole block:
// the sum of the aggregates of tiles b-1, b-2, ... down to the nearest
// that holds a segment head, THREADS descriptors a step (a thread each),
// summed in a fixed tree — each warp's shuffle tree, then the warps' sums
// in warp order.  Aggregates only: the same float result from run to run.
template <int V>
__device__ Words<V> look_back(const float* agg, const unsigned* status,
                              int shard, int b, int tiles, int groups, int g,
                              int W, int* s_cut, Words<V>* s_part) {
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  Words<V> carry = zero<V>();
  for (int j0 = b - 1;; j0 -= THREADS) {
    const int j = j0 - tid;
    unsigned st = HAS_HEAD;               // before tile 0: stop there
    Words<V> a = zero<V>();
    if (j >= 0) {
      const size_t dj = (size_t)shard * tiles + j;
      long long spins = 0;
      while ((st = ld_acquire(status + dj * groups + g)) == 0) {
        if (++spins > SPIN_LIMIT) __trap();
        __nanosleep(64);
      }
      a = load_cg<V>(agg + dj * W + g * V);
    }
    if (tid == 0) *s_cut = THREADS;
    __syncthreads();
    if (st & HAS_HEAD) atomicMin(s_cut, tid);
    __syncthreads();
    const int cut = *s_cut;
    if (tid > cut) a = zero<V>();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) a = add(a, shfl_down(a, d));
    if (ln == 0) s_part[warp] = a;
    __syncthreads();
    Words<V> sum = zero<V>();
    for (int w = 0; w < WARPS; ++w) sum = add(sum, s_part[w]);
    carry = add(sum, carry);              // the older step first
    if (cut < THREADS) return carry;
    __syncthreads();                      // s_cut and s_part are reused
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS) segmented_add_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ sid,
    const int32_t* __restrict__ seg_end, const int32_t* __restrict__ lane,
    const int32_t* __restrict__ keys, const float* __restrict__ value,
    float* __restrict__ resp, float* __restrict__ table,
    float* __restrict__ agg, unsigned* __restrict__ status,
    unsigned* __restrict__ ticket, int N, int K, int W, int tiles) {
  __shared__ int s_tile, s_first_head;
  __shared__ int s_warp_flag[WARPS];
  __shared__ Words<V> s_warp_value[WARPS];  // a warp's run, then its prefix
  __shared__ int s_cut;                     // the look-back's nearest head
  __shared__ Words<V> s_part[WARPS];        // the look-back's warp sums
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_tile = (int)atomicAdd(ticket, 1u);
    s_first_head = TILE;
  }
  __syncthreads();
  const int tile = s_tile;                // logical tile: shard * tiles + b
  const int shard = tile / tiles, b = tile - shard * tiles;
  const size_t o = (size_t)shard * N;
  const int p0 = b * TILE + tid * ITEMS;  // this thread's first sorted row

  // every row: its request row, head flag and lane
  int row[ITEMS];
  bool head[ITEMS], is_add[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = p0 + i;
    row[i] = p < N ? order[o + p] : 0;
    head[i] = p < N && sid[o + p] == p;
  }
  int first = TILE;
  bool any_add = false;
#pragma unroll
  for (int i = ITEMS - 1; i >= 0; --i) {
    is_add[i] = p0 + i < N && lane[o + row[i]] == LANE_ADD;
    if (head[i]) first = tid * ITEMS + i;
    any_add |= is_add[i];
  }
  if (first < TILE) atomicMin(&s_first_head, first);
  const int groups = W / V;
  if (!__syncthreads_or(any_add)) {
    // no ADD row: every delta is 0, so the descriptors are zero
    // aggregates, published at once, and nothing is written
    const unsigned st = READY | (s_first_head < TILE ? HAS_HEAD : 0u);
    for (int g = tid; g < groups; g += THREADS) {
      store(agg + (size_t)tile * W + g * V, zero<V>());
      st_release(status + (size_t)tile * groups + g, st);
    }
    return;
  }
  // the ADD rows: which ends its segment, and its key
  int key[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    key[i] = -1;
    if (is_add[i] && seg_end[o + p0 + i] - 1 == p0 + i)
      key[i] = keys[o + row[i]];
  }
  // the tile's leading rows (before its first head) take the carry: look
  // back only when one of them is an ADD row
  bool lead_add = false;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    lead_add |= is_add[i] && tid * ITEMS + i < s_first_head;
  const bool need = __syncthreads_or(lead_add) && b > 0;

  for (int g = 0; g < groups; ++g) {
    // the deltas and the responses, in flight while the tile scans
    Words<V> v[ITEMS], r[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      v[i] = zero<V>();
      r[i] = zero<V>();
      if (is_add[i]) {
        v[i] = load<V>(value + (o + row[i]) * W + g * V);
        r[i] = load<V>(resp + (o + row[i]) * W + g * V);
      }
    }
    // the thread's run, then the warp's inclusive scan of the runs
    int f = 0;
    Words<V> x = zero<V>();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) combine(f, x, head[i] ? 1 : 0, v[i]);
    scan_warp(f, x, ln);
    int ef = __shfl_up_sync(FULL, f, 1);   // the runs of the lanes before
    Words<V> ex = shfl_up(x, 1);
    if (ln == 0) ef = 0, ex = zero<V>();
    if (ln == 31) s_warp_flag[warp] = f, s_warp_value[warp] = x;
    __syncthreads();

    if (warp == 0) {
      // the warps' runs scanned: the tile's aggregate is published at
      // once, and each warp's exclusive prefix stored
      int wf = ln < WARPS ? s_warp_flag[ln] : 0;
      Words<V> wx = ln < WARPS ? s_warp_value[ln] : zero<V>();
      scan_warp(wf, wx, ln);
      if (ln == 31) {
        store(agg + (size_t)tile * W + g * V, wx);
        st_release(status + (size_t)tile * groups + g,
                   READY | (wf ? HAS_HEAD : 0u));
      }
      int pf = __shfl_up_sync(FULL, wf, 1);
      Words<V> px = shfl_up(wx, 1);
      if (ln == 0) pf = 0, px = zero<V>();
      if (ln < WARPS) s_warp_flag[ln] = pf, s_warp_value[ln] = px;
    }
    Words<V> run = need ? look_back<V>(agg, status, shard, b, tiles, groups,
                                       g, W, &s_cut, s_part)
                        : zero<V>();
    __syncthreads();

    // this thread's prefix: the carry, its warp's prefix, the lanes before
    int pf = 0;
    combine(pf, run, s_warp_flag[warp], s_warp_value[warp]);
    combine(pf, run, ef, ex);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const Words<V> prior = head[i] ? zero<V>() : run;
      run = head[i] ? v[i] : add(run, v[i]);
      if (!is_add[i]) continue;
      store(resp + (o + row[i]) * W + g * V, add(r[i], prior));
      if (key[i] >= 0 && key[i] < K) {    // the segment's last row commits
        float* line = table + ((size_t)shard * K + key[i]) * W + g * V;
        store(line, add(load<V>(line), add(prior, v[i])));
      }
    }
    __syncthreads();                      // shared memory reused next group
  }
}

}  // namespace

extern "C" int segmented_add_launch(
    void* table, void* resp, const void* keys, const void* lane,
    const void* order, const void* sid, const void* seg_end,
    const void* value, void* agg, void* status, int T, int N, int K, int W,
    int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  const int tiles = (N + TILE - 1) / TILE;
  const size_t words = (size_t)T * tiles * (W / vec);  // then the ticket
  cudaError_t err =
      cudaMemsetAsync(status, 0, (words + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  auto kernel = vec == 4 ? segmented_add_kernel<4> : segmented_add_kernel<1>;
  kernel<<<T * tiles, THREADS, 0, s>>>(
      (const int32_t*)order, (const int32_t*)sid, (const int32_t*)seg_end,
      (const int32_t*)lane, (const int32_t*)keys, (const float*)value,
      (float*)resp, (float*)table, (float*)agg, (unsigned*)status,
      (unsigned*)status + words, N, K, W, tiles);
  return (int)cudaGetLastError();
}
