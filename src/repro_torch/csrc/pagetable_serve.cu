// pagetable_serve.cu — the delegated page table's trustee serve: one op pass
// (alloc, append, free or lookup) over every trustee's received rows.
//
// Replaces the JAX serve of src/repro/core/pagetable.py:250-315
// (serve_alloc / serve_append / serve_free / serve_lookup): a lax.scan over
// the round's rows, one step per row, each alloc / append step carrying the
// eviction while_loop of _evict_alloc (:186).  It is not a Pallas kernel but
// the trustee's serial application on the hot path; in eager PyTorch the
// same loop would cost some fifteen launches a row plus a host sync for
// every eviction loop's condition.
//
// Semantics (bit for bit the JAX serve and ref.pagetable_serve, all int32):
//   * rows are applied one after another in serve order; rows whose valid
//     byte is 0 are no-ops and their responses are left unwritten (the
//     caller's masked pass keeps valid rows only);
//   * seq_l = clip(floor(seq / T), 0, SL - 1);
//   * alloc: k = clip(n, 0, MP); append: k = clip(pos // PS + 1 -
//     chain_len, 0, MP), only for pos // PS in [0, MP);
//   * admission is all-or-nothing: free0 + reclaimable >= k and
//     chain_len + k <= MP; then LRU victims (least last_used * SL + seq_l,
//     ties to the lowest index, never the requester) are evicted whole
//     until k pages are free, and the k lowest-numbered free pages are
//     chained;
//   * touch stamps last_used with the clock before the clock advances;
//     free advances the clock without a stamp.
//
// Bound: bytes.  The state (used, chains, chain_len, last_used, clock,
// evictions) read once and written once, every row's valid byte read, the
// valid rows' seq and arg read and their responses written: some 100 KB a
// pass at the qwen2.5-3b decode geometry, well under a microsecond at
// 3.35 TB/s.  The work is
// serial per trustee by definition (each row sees the state its
// predecessors left), so the design is latency-bound instead:
//   * one block of one warp per trustee; the trustee's state lives in
//     shared memory for the whole pass;
//   * the received buffer is mostly padding (every client's slot block is
//     sized for the worst case), so the warp skips it 32 rows at a time
//     with a ballot over the valid bytes and walks only the set bits;
//   * each row's parallel parts run across the warp: the free-page count
//     and rank (ballot + popc over the local pool), the reclaimable sum and
//     the LRU argmin over the local sequences, the chain copies.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define I32MAX 2147483647

enum { PT_ALLOC = 0, PT_APPEND = 1, PT_FREE = 2, PT_LOOKUP = 3 };

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ int count_free(const int* used, int pl, int lane) {
  __syncwarp();
  int c = 0;
  for (int i = lane; i < pl; i += 32) c += used[i] == 0;
  return warp_sum(c);
}

// _evict_alloc for one row, on the warp (every lane returns the same flag)
__device__ bool evict_alloc(int* used, int* chains, int* cl, const int* lu,
                            int& ev, int pl, int sl, int mp, int seq_l, int k,
                            bool want, int lane) {
  if (!want) return false;
  __syncwarp();
  int rec = 0;
  for (int s = lane; s < sl; s += 32)
    if (cl[s] > 0 && s != seq_l) rec += cl[s];
  rec = warp_sum(rec);
  int nfree = count_free(used, pl, lane);
  if (!(nfree + rec >= k && cl[seq_l] + k <= mp)) return false;
  while (nfree < k) {
    long long best = 0x7fffffffffffffffLL;
    int bi = I32MAX;
    for (int s = lane; s < sl; s += 32) {
      long long key = (cl[s] > 0 && s != seq_l)
                          ? (long long)lu[s] * sl + s : (long long)I32MAX;
      if (key < best) { best = key; bi = s; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      long long ob = __shfl_xor_sync(FULL, best, o);
      int oi = __shfl_xor_sync(FULL, bi, o);
      if (ob < best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    // no victim left: unreachable on a consistent state (admission counted
    // the reclaimable pages); stops a corrupted one from spinning
    if (best >= I32MAX) break;
    const int v = bi;
    const int cv = cl[v];
    for (int i = lane; i < cv; i += 32) {
      const int p = chains[v * mp + i];
      if ((unsigned)p < (unsigned)pl) used[p] = 0;
    }
    __syncwarp();
    for (int i = lane; i < mp; i += 32) chains[v * mp + i] = -1;
    if (lane == 0) cl[v] = 0;
    ev += 1;
    nfree = count_free(used, pl, lane);
  }
  __syncwarp();
  const int base = cl[seq_l];
  int taken = 0;
  for (int i0 = 0; i0 < pl && taken < k; i0 += 32) {
    const int i = i0 + lane;
    const bool f = i < pl && used[i] == 0;
    const unsigned m = __ballot_sync(FULL, f);
    const int r = taken + __popc(m & ((1u << lane) - 1u));
    if (f && r < k) {
      chains[seq_l * mp + base + r] = i;
      used[i] = 1;
    }
    taken += __popc(m);
  }
  __syncwarp();
  if (lane == 0) cl[seq_l] = base + k;
  __syncwarp();
  return true;
}

__global__ void pagetable_serve_kernel(
    int op, int T, int N, int pl, int sl, int mp, int ps, int* g_used,
    int* g_chains, int* g_cl, int* g_lu, int* g_clock, int* g_ev,
    const int* seq, const int* arg, const unsigned char* valid, int* r_pages,
    int* r_page, int* r_n, int* r_flag) {
  extern __shared__ int smem[];
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  int* used = smem;
  int* chains = used + pl;
  int* cl = chains + sl * mp;
  int* lu = cl + sl;
  for (int i = lane; i < pl; i += 32) used[i] = g_used[(size_t)t * pl + i];
  for (int i = lane; i < sl * mp; i += 32)
    chains[i] = g_chains[(size_t)t * sl * mp + i];
  for (int i = lane; i < sl; i += 32) {
    cl[i] = g_cl[(size_t)t * sl + i];
    lu[i] = g_lu[(size_t)t * sl + i];
  }
  int clock = g_clock[t];
  int ev = g_ev[t];
  __syncwarp();

  const size_t row0 = (size_t)t * N;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int jl = j0 + lane;
    unsigned m = __ballot_sync(FULL, jl < N && valid[row0 + jl] != 0);
    while (m) {
      const int j = j0 + __ffs(m) - 1;
      m &= m - 1;
      const size_t ri = row0 + j;
      const int seq_l = clampi(floordiv(seq[ri], T), 0, sl - 1);
      int* chain = chains + seq_l * mp;
      int* out_pages = r_pages + ri * mp;
      if (op == PT_FREE) {
        __syncwarp();
        const int n = cl[seq_l];
        for (int i = lane; i < n; i += 32)
          if ((unsigned)chain[i] < (unsigned)pl) used[chain[i]] = 0;
        __syncwarp();
        for (int i = lane; i < mp; i += 32) {
          chain[i] = -1;
          out_pages[i] = 0;
        }
        if (lane == 0) {
          cl[seq_l] = 0;
          r_page[ri] = 0;
          r_n[ri] = n;
          r_flag[ri] = 1;
        }
        clock += 1;
        __syncwarp();
        continue;
      }
      int flag = 0, page = -1;
      if (op == PT_ALLOC) {
        const int k = clampi(arg[ri], 0, mp);
        flag = evict_alloc(used, chains, cl, lu, ev, pl, sl, mp, seq_l, k,
                           k > 0, lane) ? 1 : 0;
      } else if (op == PT_APPEND) {
        const int page_idx = floordiv(arg[ri], ps);
        const bool inrange = page_idx >= 0 && page_idx < mp;
        __syncwarp();
        const int k = clampi(page_idx + 1 - cl[seq_l], 0, mp);
        const bool did = evict_alloc(used, chains, cl, lu, ev, pl, sl, mp,
                                     seq_l, k, inrange && k > 0, lane);
        const bool ok = inrange && (k == 0 || did);
        page = ok ? chain[clampi(page_idx, 0, mp - 1)] : -1;
        flag = ok ? (did ? k : 0) : -1;
      }
      __syncwarp();
      if (lane == 0) {
        lu[seq_l] = clock;
        r_n[ri] = cl[seq_l];
        r_page[ri] = page;
        r_flag[ri] = op == PT_LOOKUP ? (cl[seq_l] > 0 ? 1 : 0) : flag;
      }
      clock += 1;
      for (int i = lane; i < mp; i += 32)
        out_pages[i] = op == PT_APPEND ? -1 : chain[i];
      __syncwarp();
    }
  }

  __syncwarp();
  for (int i = lane; i < pl; i += 32) g_used[(size_t)t * pl + i] = used[i];
  for (int i = lane; i < sl * mp; i += 32)
    g_chains[(size_t)t * sl * mp + i] = chains[i];
  for (int i = lane; i < sl; i += 32) {
    g_cl[(size_t)t * sl + i] = cl[i];
    g_lu[(size_t)t * sl + i] = lu[i];
  }
  if (lane == 0) {
    g_clock[t] = clock;
    g_ev[t] = ev;
  }
}

extern "C" int pagetable_serve_launch(
    int op, int T, int N, int pl, int sl, int mp, int ps, void* used,
    void* chains, void* cl, void* lu, void* clock, void* ev, const void* seq,
    const void* arg, const void* valid, void* r_pages, void* r_page,
    void* r_n, void* r_flag, int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pagetable_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  pagetable_serve_kernel<<<T, 32, smem_bytes, (cudaStream_t)stream>>>(
      op, T, N, pl, sl, mp, ps, (int*)used, (int*)chains, (int*)cl, (int*)lu,
      (int*)clock, (int*)ev, (const int*)seq, (const int*)arg,
      (const unsigned char*)valid, (int*)r_pages, (int*)r_page, (int*)r_n,
      (int*)r_flag);
  return (int)cudaGetLastError();
}
