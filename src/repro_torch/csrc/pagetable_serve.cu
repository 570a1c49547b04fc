// pagetable_serve.cu — the delegated page table's trustee serve: one op pass
// (alloc, append, free or lookup) over every trustee's received rows.
//
// Design (Hopper): one block of 256 threads per trustee.  The block finds
// the pass's valid rows first (a block scan over the valid bytes, 32 rows
// a thread in two 16-byte loads, 8192 rows a pass, keeping serve order)
// and a trustee with none returns before touching its state.  Otherwise
// every thread issues its share of the state's loads at once (chains in
// 16-byte vectors, `used` compressed into a bitmap of PL bits by warp
// ballots) together with the listed rows' seq and arg (an append's page
// index divided out here), so the state and the rows arrive in one round
// trip; the list holds 2048 rows, a window at a time.  Warp 0 then applies
// the listed rows in serve order on the shared-memory copy: the free-page
// count is one __popc a bitmap word and a warp sum (REDUX), the k lowest
// free pages come from the first word with a free page where it holds
// them all (an append's one page), else from an exclusive scan of the
// words' free counts across lanes and a bit walk inside each word; the
// reclaimable sum and the LRU argmin (keyed in 64 bits) are warp
// reductions.  At the
// end the block writes back only what the pass changed: the `used`
// entries a row wrote (a dirty bitmap), the chains, chain_len and
// last_used of the sequences the rows touched, the clock and evictions.
// A `used` entry no row wrote keeps whatever value it held (phantom
// pages are 2).  Bound: the byte bound (state read and written once, the
// rows' bytes) is some 35 ns at the paged decode's geometry and says
// little, since each row sees the state its predecessors left: the floor
// is one launch, one round trip to device memory and the rows' dependent
// chain on one warp (chip_smoke.py phase 9 times an empty launch of the
// same grid beside it).
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
//   * one block a stacked shard: in dedicated mode the first shards are
//     clients, which receive no rows and return before reading their
//     (zero) state; T, the trustee count, only divides the sequence ids;
//   * seq_l = clip(floor(seq / T), 0, SL - 1);
//   * alloc: k = clip(n, 0, MP); append: k = clip(pos // PS + 1 -
//     chain_len, 0, MP), only for pos // PS in [0, MP);
//   * admission is all-or-nothing: free0 + reclaimable >= k and
//     chain_len + k <= MP; then LRU victims (least last_used * SL + seq_l,
//     ties to the lowest index, never the requester) are evicted whole
//     until k pages are free, and the k lowest-numbered free pages are
//     chained;
//   * touch stamps last_used with the clock before the clock advances;
//     free advances the clock without a stamp;
//   * a page is free where used == 0; any other value is taken.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define I32MAX 2147483647

namespace {

enum { PT_ALLOC = 0, PT_APPEND = 1, PT_FREE = 2, PT_LOOKUP = 3 };

constexpr int NT = 256;            // threads a block (one block a trustee)
constexpr int NW = NT / 32;
constexpr int RPT = 32;            // received rows a thread scans a pass
constexpr int CHUNK = NT * RPT;    // received rows a compaction pass scans
constexpr int LIST = 2048;         // listed rows a serial walk takes

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(FULL, (unsigned)v);
}

// the trustee's state in shared memory; chains first (16-byte aligned)
struct State {
  int* chains;      // SL x MP
  int* cl;          // SL
  int* lu;          // SL
  unsigned* bm;     // W words: bit set = taken (also the bits past PL)
  unsigned* dirty;  // W words: bit set = the pass wrote this used entry
  unsigned* dseq;   // ceil(SL / 32) words: the sequences the pass touched
  int pl, sl, mp, w;
};

__device__ __forceinline__ void mark_seq(State& s, int q) {
  s.dseq[q >> 5] |= 1u << (q & 31);
}

// a page leaves a chain: free in the bitmap, marked dirty (lane-parallel,
// so atomics: two lanes may share a word)
__device__ __forceinline__ void release(State& s, int p) {
  if ((unsigned)p < (unsigned)s.pl) {
    atomicAnd(&s.bm[p >> 5], ~(1u << (p & 31)));
    atomicOr(&s.dirty[p >> 5], 1u << (p & 31));
  }
}

__device__ __forceinline__ int count_free(const State& s, int lane) {
  __syncwarp();
  int c = 0;
  for (int i = lane; i < s.w; i += 32) c += __popc(~s.bm[i]);
  return warp_sum(c);
}

// _evict_alloc for one row, on warp 0 (every lane returns the same flag)
__device__ __forceinline__ bool evict_alloc(State& s, int& ev, int seq_l,
                                            int k, bool want, int lane) {
  if (!want) return false;
  const int sl = s.sl, mp = s.mp;
  __syncwarp();
  int rec = 0;
  for (int q = lane; q < sl; q += 32)
    if (s.cl[q] > 0 && q != seq_l) rec += s.cl[q];
  rec = warp_sum(rec);
  int nfree = count_free(s, lane);
  if (!(nfree + rec >= k && s.cl[seq_l] + k <= mp)) return false;
  while (nfree < k) {
    long long best = 0x7fffffffffffffffLL;
    int bi = I32MAX;
    for (int q = lane; q < sl; q += 32) {
      long long key = (s.cl[q] > 0 && q != seq_l)
                          ? (long long)s.lu[q] * sl + q : (long long)I32MAX;
      if (key < best) { best = key; bi = q; }
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
    const int cv = s.cl[v];
    for (int i = lane; i < cv; i += 32) release(s, s.chains[v * mp + i]);
    __syncwarp();
    for (int i = lane; i < mp; i += 32) s.chains[v * mp + i] = -1;
    if (lane == 0) {
      s.cl[v] = 0;
      mark_seq(s, v);
    }
    ev += 1;
    nfree = count_free(s, lane);
  }
  // the k lowest-numbered free pages: lane i holds word w0 + i; an
  // exclusive scan of the words' free counts gives each lane the rank of
  // its first free page, and it walks its word's free bits from there
  __syncwarp();
  const int base = s.cl[seq_l];
  int* chain = s.chains + seq_l * mp;
  int taken = 0;
  for (int w0 = 0; w0 < s.w && taken < k; w0 += 32) {
    const int wi = w0 + lane;
    unsigned f = wi < s.w ? ~s.bm[wi] : 0u;
    const int c = __popc(f);
    // the first word with a free page often holds all that is left to
    // take (an append's one page): then it alone walks, with no scan
    const unsigned nz = __ballot_sync(FULL, c != 0);
    const int first = nz ? __ffs(nz) - 1 : 0;
    int r, group;             // this lane's first rank; the group's pages
    if (__shfl_sync(FULL, c, first) >= k - taken) {
      if (lane != first) f = 0;
      r = taken;
      group = k - taken;
    } else {
      int incl = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += u;
      }
      r = taken + incl - c;
      group = __shfl_sync(FULL, incl, 31);
    }
    unsigned got = 0;
    while (f && r < k) {
      const int b = __ffs(f) - 1;
      f &= f - 1;
      chain[base + r] = wi * 32 + b;
      got |= 1u << b;
      ++r;
    }
    if (got) {          // each lane owns its word here
      s.bm[wi] |= got;
      s.dirty[wi] |= got;
    }
    taken += group;
  }
  __syncwarp();
  if (lane == 0) {
    s.cl[seq_l] = base + k;
    mark_seq(s, seq_l);
  }
  __syncwarp();
  return true;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// bit i set where row j0 + i (< N) is valid: two 16-byte loads where the
// rows allow, else byte loads
__device__ __forceinline__ unsigned valid_bits(const unsigned char* vrow,
                                               int j0, int N) {
  unsigned bits = 0;
  if (j0 + RPT <= N && aligned16(vrow + j0)) {
    const uint4 a = *reinterpret_cast<const uint4*>(vrow + j0);
    const uint4 b = *reinterpret_cast<const uint4*>(vrow + j0 + 16);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      bits |= (((w[i >> 2] >> (8 * (i & 3))) & 0xffu) != 0) << i;
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (j0 + i < N && vrow[j0 + i] != 0) bits |= 1u << i;
  }
  return bits;
}

// one listed row on warp 0: its op on the shared state, its responses
// written; ``a`` is an alloc's page count or an append's page index
__device__ __forceinline__ void serve_row(
    State& s, int op, int row, int seq_l, int a, size_t row0, int& clock,
    int& ev, int* r_pages, int* r_page, int* r_n, int* r_flag, int lane) {
  const int mp = s.mp;
  const size_t ri = row0 + row;
  int* chain = s.chains + seq_l * mp;
  int* out_pages = r_pages + ri * mp;
  if (op == PT_FREE) {
    __syncwarp();
    const int n = s.cl[seq_l];
    for (int i = lane; i < n; i += 32) release(s, chain[i]);
    __syncwarp();
    for (int i = lane; i < mp; i += 32) {
      chain[i] = -1;
      out_pages[i] = 0;
    }
    if (lane == 0) {
      s.cl[seq_l] = 0;
      mark_seq(s, seq_l);
      r_page[ri] = 0;
      r_n[ri] = n;
      r_flag[ri] = 1;
    }
    clock += 1;
    __syncwarp();
    return;
  }
  int flag = 0, page = -1;
  if (op == PT_ALLOC) {
    const int k = clampi(a, 0, mp);
    flag = evict_alloc(s, ev, seq_l, k, k > 0, lane) ? 1 : 0;
  } else if (op == PT_APPEND) {
    const bool inrange = a >= 0 && a < mp;
    __syncwarp();
    const int k = clampi(a + 1 - s.cl[seq_l], 0, mp);
    const bool did = evict_alloc(s, ev, seq_l, k, inrange && k > 0, lane);
    const bool ok = inrange && (k == 0 || did);
    page = ok ? chain[clampi(a, 0, mp - 1)] : -1;
    flag = ok ? (did ? k : 0) : -1;
  }
  __syncwarp();
  if (lane == 0) {
    s.lu[seq_l] = clock;
    mark_seq(s, seq_l);
    r_n[ri] = s.cl[seq_l];
    r_page[ri] = page;
    r_flag[ri] = op == PT_LOOKUP ? (s.cl[seq_l] > 0 ? 1 : 0) : flag;
  }
  clock += 1;
  for (int i = lane; i < mp; i += 32)
    out_pages[i] = op == PT_APPEND ? -1 : chain[i];
  __syncwarp();
}

__global__ void __launch_bounds__(NT) pagetable_serve_kernel(
    int op, int T, int N, int pl, int sl, int mp, int ps,
    int* __restrict__ g_used, int* __restrict__ g_chains,
    int* __restrict__ g_cl, int* __restrict__ g_lu, int* __restrict__ g_clock,
    int* __restrict__ g_ev, const int* __restrict__ seq,
    const int* __restrict__ arg, const unsigned char* __restrict__ valid,
    int* __restrict__ r_pages, int* __restrict__ r_page,
    int* __restrict__ r_n, int* __restrict__ r_flag) {
  extern __shared__ __align__(16) int smem[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  State s;
  s.pl = pl;
  s.sl = sl;
  s.mp = mp;
  s.w = (pl + 31) >> 5;
  const int sw = (sl + 31) >> 5;
  s.chains = smem;
  s.cl = s.chains + sl * mp;
  s.lu = s.cl + sl;
  s.bm = reinterpret_cast<unsigned*>(s.lu + sl);
  s.dirty = s.bm + s.w;
  s.dseq = s.dirty + s.w;
  int* l_row = reinterpret_cast<int*>(s.dseq + sw);   // LIST each
  int* l_seq = l_row + LIST;
  int* l_arg = l_seq + LIST;
  int* wsum = l_arg + LIST;                             // NW + 1

  int* gu = g_used + (size_t)t * pl;
  int* gch = g_chains + (size_t)t * sl * mp;
  int* gcl = g_cl + (size_t)t * sl;
  int* glu = g_lu + (size_t)t * sl;
  const size_t row0 = (size_t)t * N;
  const unsigned char* vrow = valid + row0;

  bool loaded = false;        // block-uniform
  int clock = 0, ev = 0;      // live in warp 0
  for (int c0 = 0; c0 < N; c0 += CHUNK) {
    // -- the pass's valid rows, ranked in serve order ---------------------
    const int j0 = c0 + tid * RPT;
    const unsigned bits = valid_bits(vrow, j0, N);
    const int cnt = __popc(bits);
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int x = lane < NW ? wsum[lane] : 0;
      int xi = x;
      for (int o = 1; o < NW; o <<= 1) {
        const int u = __shfl_up_sync(FULL, xi, o);
        if (lane >= o) xi += u;
      }
      __syncwarp();
      if (lane < NW) wsum[lane] = xi - x;
      if (lane == NW - 1) wsum[NW] = xi;
    }
    __syncthreads();
    const int total = wsum[NW];
    if (total == 0) continue;         // block-uniform: nothing to serve

    // -- the state, first time only, in the same trip as the first rows ---
    if (!loaded) {
      for (int i = tid; i < s.w + sw; i += NT) s.dirty[i] = 0u;  // + dseq
      const int nch = sl * mp;
      if ((nch & 3) == 0 && aligned16(gch)) {
        const int4* g4 = reinterpret_cast<const int4*>(gch);
        int4* s4 = reinterpret_cast<int4*>(s.chains);
        for (int i = tid; i < nch / 4; i += NT) s4[i] = g4[i];
      } else {
        for (int i = tid; i < nch; i += NT) s.chains[i] = gch[i];
      }
      for (int i = tid; i < sl; i += NT) {
        s.cl[i] = gcl[i];
        s.lu[i] = glu[i];
      }
      // used -> bitmap: a warp ballots 32 consecutive pages; four pages a
      // thread are loaded before the ballots, so they are all in flight
      for (int b0 = 0; b0 < s.w * 32; b0 += 4 * NT) {
        int u[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = b0 + i * NT + tid;
          u[i] = p < pl ? gu[p] : 1;        // the bits past PL: taken
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int p = b0 + i * NT + tid;
          const unsigned m = __ballot_sync(FULL, u[i] != 0);
          if (lane == 0 && p < s.w * 32) s.bm[p >> 5] = m;
        }
      }
      if (warp == 0) {
        clock = g_clock[t];
        ev = g_ev[t];
      }
      loaded = true;
    }

    // -- the ranked rows, LIST at a time (one window unless more are
    //    valid): list (row, seq_l, argument; an append's page index),
    //    then warp 0 applies them in serve order -------------------------
    for (int w0 = 0; w0 < total; w0 += LIST) {
      int k = wsum[warp] + incl - cnt;
      unsigned m = bits;
      while (m) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        if (k >= w0 && k < w0 + LIST) {
          const size_t ri = row0 + j0 + i;
          l_row[k - w0] = j0 + i;
          l_seq[k - w0] = clampi(floordiv(seq[ri], T), 0, sl - 1);
          l_arg[k - w0] = op == PT_ALLOC ? arg[ri]
                          : op == PT_APPEND ? floordiv(arg[ri], ps) : 0;
        }
        ++k;
      }
      __syncthreads();
      if (warp == 0) {
        const int rows = min(LIST, total - w0);
        for (int li = 0; li < rows; ++li)
          serve_row(s, op, l_row[li], l_seq[li], l_arg[li], row0, clock,
                    ev, r_pages, r_page, r_n, r_flag, lane);
      }
      __syncthreads();        // the list is rewritten by the next window
    }
  }
  if (!loaded) return;

  // -- write back what the pass changed -------------------------------------
  for (int p = tid; p < pl; p += NT) {
    const unsigned bit = 1u << (p & 31);
    if (s.dirty[p >> 5] & bit) gu[p] = (s.bm[p >> 5] & bit) ? 1 : 0;
  }
  const int nch = sl * mp;
  if ((mp & 3) == 0 && aligned16(gch)) {
    int4* g4 = reinterpret_cast<int4*>(gch);
    const int4* s4 = reinterpret_cast<const int4*>(s.chains);
    for (int i = tid; i < nch / 4; i += NT) {
      const int q = (4 * i) / mp;
      if (s.dseq[q >> 5] & (1u << (q & 31))) g4[i] = s4[i];
    }
  } else {
    for (int i = tid; i < nch; i += NT) {
      const int q = i / mp;
      if (s.dseq[q >> 5] & (1u << (q & 31))) gch[i] = s.chains[i];
    }
  }
  for (int q = tid; q < sl; q += NT) {
    if (s.dseq[q >> 5] & (1u << (q & 31))) {
      gcl[q] = s.cl[q];
      glu[q] = s.lu[q];
    }
  }
  if (tid == 0) {
    g_clock[t] = clock;
    g_ev[t] = ev;
  }
}

// the same grid, block and shared memory doing nothing: the launch and
// scheduling floor the serve's time is weighed against
__global__ void __launch_bounds__(NT) pagetable_empty_kernel() {}

int smem_needed(int pl, int sl, int mp) {
  const int w = (pl + 31) / 32, sw = (sl + 31) / 32;
  return 4 * (sl * mp + 2 * sl + 2 * w + sw + 3 * LIST + NW + 1);
}

int set_smem(const void* k, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

// smem_bytes is the wrapper's kernels/pagetable_serve.smem_bytes(PL, SL,
// MP); a smaller value is refused
// shards: the stacked shards (the grid), T: the trustees (the seq divisor)
extern "C" int pagetable_serve_launch(
    int op, int shards, int T, int N, int pl, int sl, int mp, int ps,
    void* used,
    void* chains, void* cl, void* lu, void* clock, void* ev, const void* seq,
    const void* arg, const void* valid, void* r_pages, void* r_page,
    void* r_n, void* r_flag, int smem_bytes, void* stream) {
  if (smem_bytes < smem_needed(pl, sl, mp)) return (int)cudaErrorInvalidValue;
  const int e = set_smem((const void*)pagetable_serve_kernel, smem_bytes);
  if (e != 0) return e;
  pagetable_serve_kernel<<<shards, NT, smem_bytes, (cudaStream_t)stream>>>(
      op, T, N, pl, sl, mp, ps, (int*)used, (int*)chains, (int*)cl, (int*)lu,
      (int*)clock, (int*)ev, (const int*)seq, (const int*)arg,
      (const unsigned char*)valid, (int*)r_pages, (int*)r_page, (int*)r_n,
      (int*)r_flag);
  return (int)cudaGetLastError();
}

// out: registers a thread, local (spill) bytes a thread, resident blocks
// an SM at smem_bytes
extern "C" int pagetable_serve_info(int smem_bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, pagetable_serve_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  const int r = set_smem((const void*)pagetable_serve_kernel, smem_bytes);
  if (r != 0) return r;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 2, pagetable_serve_kernel, NT, smem_bytes);
}

extern "C" int pagetable_empty_launch(int T, int smem_bytes, void* stream) {
  const int e = set_smem((const void*)pagetable_empty_kernel, smem_bytes);
  if (e != 0) return e;
  pagetable_empty_kernel<<<T, NT, smem_bytes, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
