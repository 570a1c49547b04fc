// grouped_matmul.cu — one matmul per expert, bf16 in and out, f32
// accumulation: the trustee's expert FFN of the MoE serve path.
//
// Replaces src/repro/kernels/grouped_matmul.py::_gmm_kernel (:25,
// pallas_call :52).  Same function: x (E, C, D) @ w (E, D, F) ->
// (E, C, F), the products of bf16 operands summed in f32 and the sum
// rounded once to bf16.  Optional counts (E,) int32 on the card: the
// filled rows of each expert's slots; x's rows at and past counts[e] are
// zero (the pack zero-fills them), so the output's rows there are zero
// and a 128-row tile that starts at or past counts[e] is written as
// zeros without a product.  counts is read on the card only.
//
// Bound: operations where C is filled, bytes where it is not.  The MoE
// prefill (E 64, C 3072, D 2048, F 1408) fills about a quarter of its
// slots: 2 * rows * D * F = 0.28 TFLOP a launch (0.29 ms at 989 TFLOP/s
// bf16 dense), and the whole (E, C, F) output is written, 554 MB (0.17 ms
// at 3.35 TB/s).  A decode step (C 8) fills 32 of the 64 experts: their
// 184 MB of weights read once, 0.055 ms.  The TPU grid ran (E, C/bc,
// F/bf, D/bd) in order with the f32 accumulator in VMEM across the last
// axis.  Here (Hopper):
//   * a persistent block on each SM takes every 132nd of the 128 x 128
//     output tiles that hold a filled row (experts outermost, then C,
//     then F): wherever the counts put them, they spread evenly; three
//     warps of the producer's warpgroup store the tiles past counts[e] as
//     zeros meanwhile, and their operands are never loaded;
//   * one producer thread keeps a ring of 4 stages of TMA loads in
//     flight, each an A tile of 128 x 64 of x (a 3-d map over (E, C, D),
//     so rows past C read as zeros and no expert reads its neighbour's)
//     and a B tile of 64 x 128 of w, two 64-column boxes of the (E, D, F)
//     map, all with the 128-byte swizzle, completed on an mbarrier;
//   * two consumer warpgroups each run wgmma.mma_async m64n128k16 bf16 ->
//     f32 on a 64-row half of the tile, the accumulators in registers, A
//     K-major and B MN-major (w is F-contiguous: wgmma's transpose bit,
//     no transposed copy); a half whose rows are all past counts[e]
//     multiplies nothing and stores zeros; each stage goes back to the
//     producer through an "empty" mbarrier once its wgmmas have retired,
//     so the next tile's loads overlap this tile's last products and its
//     store;
//   * the f32 sums are rounded to bf16 once, at the store.
// TMA needs 16-byte strides: D or F that is not a multiple of 8 takes the
// masked mma.sync kernel below (a ragged C, D or F otherwise reads zeros
// past the map's edge and is masked at the store).
#include "sm90.cuh"

namespace {

constexpr int BM = 128;      // C rows per tile
constexpr int BN = 128;      // F columns per tile
constexpr int BK = 64;       // D depth per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int A_TILE = BM * BK * 2;             // 16 KB
constexpr int B_HALF = BK * 64 * 2;             // 8 KB: 64 k-rows x 64 cols
constexpr int STAGE_BYTES = A_TILE + 2 * B_HALF;
constexpr int WG = 128;                         // threads of a warpgroup
constexpr int THREADS = 3 * WG;                 // producer + 2 consumers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// zeros into rows [r0, min(r1, C)) and columns [n0, min(n0 + BN, F)) of
// one expert's (C, F) output, by `n` threads of which this is `t`
__device__ void zero_tile(uint16_t* __restrict__ oe, int r0, int r1, int n0,
                          int C, int F, int t, int n) {
  const int rows = min(r1, C) - r0, cols = min(n0 + BN, F) - n0;
  if (rows <= 0 || cols <= 0) return;
  if ((F & 7) == 0) {                   // 16-byte stores
    const int per = cols >> 3;
    for (int i = t; i < rows * per; i += n)
      *reinterpret_cast<int4*>(oe + (size_t)(r0 + i / per) * F + n0 +
                               (i % per) * 8) = make_int4(0, 0, 0, 0);
  } else {
    for (int i = t; i < rows * cols; i += n)
      oe[(size_t)(r0 + i / cols) * F + n0 + i % cols] = 0;
  }
}

__device__ __forceinline__ int filled_rows(const int* counts, int e, int C) {
  return counts == nullptr ? C : min(max(counts[e], 0), C);
}

// Walks one kind of tile — those with a filled row (to multiply) or those
// past counts[e] (to zero) — in order, experts outermost, then C, then F:
// at(k) is the k-th tile of the kind.  Each role of a block asks for
// k = blockIdx.x, + gridDim.x, ... so the filled tiles, wherever the
// counts put them, spread evenly over the blocks, and an expert's tiles
// run at about the same time (its weights stay in L2).
struct TileWalk {
  const int* counts;
  int E, C, mt, nt;
  bool zeros;
  int e = -1, base = 0, n = 0, m_first = 0;

  __device__ TileWalk(const int* counts_, int E_, int C_, int mt_, int nt_,
                      bool zeros_)
      : counts(counts_), E(E_), C(C_), mt(mt_), nt(nt_), zeros(zeros_) {}

  // false past the last tile; k must not decrease between calls
  __device__ bool at(int k, int& ex, int& m0, int& n0) {
    while (k >= base + n) {
      base += n;
      if (++e >= E) return false;
      const int full = (filled_rows(counts, e, C) + BM - 1) / BM;
      m_first = zeros ? full : 0;
      n = (zeros ? mt - full : full) * nt;
    }
    const int local = k - base;
    ex = e;
    m0 = (m_first + local / nt) * BM;
    n0 = local % nt * BN;
    return true;
  }
};

// d (64 x 128 f32, the accumulator layout of m64n128) += A (64 x 16,
// K-major) x B (16 x 128, MN-major: imm-trans-b = 1)
__device__ __forceinline__ void wgmma_m64n128k16(float d[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- the TMA + wgmma kernel (D and F multiples of 8) -----------------------

__global__ void __launch_bounds__(THREADS, 1)
    grouped_matmul_kernel(const __grid_constant__ CUtensorMap tx,
                          const __grid_constant__ CUtensorMap tw,
                          uint16_t* __restrict__ o,
                          const int* __restrict__ counts, int E, int C, int D,
                          int F) {
  extern __shared__ unsigned char smem[];
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  // stage s: A at base + s * STAGE_BYTES, B's two boxes after it;
  // full[s] at bar + 8 s, empty[s] at bar + 8 (STAGES + s)
  const uint32_t bar = base + STAGES * STAGE_BYTES;
  const int nt = (F + BN - 1) / BN, mt = (C + BM - 1) / BM;
  const int nk = (D + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (STAGES + s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int e, m0, n0;

  if (threadIdx.x < WG) {
    if (threadIdx.x >= 32) {  // warps 1-3: the tiles past counts[e]
      TileWalk zero(counts, E, C, mt, nt, true);
      for (int k = blockIdx.x; zero.at(k, e, m0, n0); k += gridDim.x)
        zero_tile(o + (size_t)e * C * F, m0, m0 + BM, n0, C, F,
                  threadIdx.x - 32, WG - 32);
      return;
    }
    if (threadIdx.x != 0) return;
    // the producer: one thread issues every load of the filled tiles
    TileWalk walk(counts, E, C, mt, nt, false);
    uint32_t it = 0;
    for (int k = blockIdx.x; walk.at(k, e, m0, n0); k += gridDim.x) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        if (it >= STAGES)
          mbar_wait(bar + 8 * (STAGES + s), ((it / STAGES) - 1) & 1);
        const uint32_t full = bar + 8 * s, a = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load_3d(a, &tx, kt * BK, m0, e, full);
        tma_load_3d(a + A_TILE, &tw, n0, kt * BK, e, full);
        tma_load_3d(a + A_TILE + B_HALF, &tw, n0 + 64, kt * BK, e, full);
      }
    }
    return;
  }

  // the consumers: rows 64 half .. of each filled tile
  const int half = threadIdx.x / WG - 1;
  const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
  TileWalk walk(counts, E, C, mt, nt, false);
  uint32_t it = 0;
  for (int k = blockIdx.x; walk.at(k, e, m0, n0); k += gridDim.x) {
    uint16_t* oe = o + (size_t)e * C * F;
    const int r0 = m0 + 64 * half;
    if (r0 >= filled_rows(counts, e, C)) {  // every row here is empty
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(bar + 8 * s, (it / STAGES) & 1);
        if (tid == 0) mbar_arrive(bar + 8 * (STAGES + s));
      }
      zero_tile(oe, r0, r0 + 64, n0, C, F, tid, WG);
      continue;
    }
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    fence_acc(d);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(bar + 8 * s, (it / STAGES) & 1);
      const uint32_t a = base + s * STAGE_BYTES + half * 64 * 128;
      const uint32_t b = base + s * STAGE_BYTES + A_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // A: 8-row groups 1024 bytes apart, k advances 32 bytes in the
        // swizzled row; B: 8-row k groups 1024 bytes apart, the two
        // 64-column boxes 8192 apart, k advances 16 rows of 128 bytes
        wgmma_m64n128k16(d, sw128_desc(a + kk * 32, 16, 1024),
                         sw128_desc(b + kk * 16 * 128, B_HALF, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have retired
      if (kt > 0 && tid == 0)
        mbar_arrive(bar + 8 * (STAGES + (it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (tid == 0) mbar_arrive(bar + 8 * (STAGES + (it - 1) % STAGES));
    // accumulator layout: row 16 warp + lane / 4 (+ 8), columns
    // 8 j + 2 (lane % 4) (+ 1) in registers 4 j (+ 2) (+ 1)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 16 * warp + (lane >> 2) + 8 * i;
        if (row < C && col < F)
          *reinterpret_cast<uint32_t*>(oe + (size_t)row * F + col) =
              pack_bf16(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
      }
    }
  }
}

// ---- the masked mma.sync kernel (D or F not a multiple of 8) ---------------

constexpr int RK = 32;       // D depth per k-tile
constexpr int R_THREADS = 256;
constexpr int LDA = RK + 8;
constexpr int LDB = BN + 8;

// 8 consecutive values of row `row` from column `col` of a (rows, cols)
// row-major matrix, zeros past its edge
__device__ __forceinline__ int4 load8(const uint16_t* __restrict__ m,
                                      int rows, int cols, int row, int col) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const uint16_t* p = m + (size_t)row * cols + col;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = col + 2 * j < cols ? p[2 * j] : 0u;
    const uint32_t hi = col + 2 * j + 1 < cols ? p[2 * j + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// one block of 8 warps per (128-column F tile, 128-row C tile, expert),
// each warp a 64 x 32 piece of the output tile; 32-deep k-tiles staged
// in shared memory, mma.sync.m16n8k16 on the tensor cores
__global__ void __launch_bounds__(R_THREADS)
    grouped_matmul_ragged_kernel(const uint16_t* __restrict__ x,
                                 const uint16_t* __restrict__ w,
                                 uint16_t* __restrict__ o,
                                 const int* __restrict__ counts, int C, int D,
                                 int F) {
  __shared__ __align__(16) uint16_t As[BM * LDA];
  __shared__ __align__(16) uint16_t Bs[RK * LDB];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  uint16_t* oe = o + (size_t)e * C * F;
  const int filled = filled_rows(counts, e, C);
  if (m0 >= filled) {
    zero_tile(oe, m0, m0 + BM, n0, C, F, threadIdx.x, R_THREADS);
    return;
  }
  const uint16_t* xe = x + (size_t)e * C * D;
  const uint16_t* we = w + (size_t)e * D * F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2;           // 2 x 64 rows
  const int wn = warp & 3;            // 4 x 32 columns
  const bool live = m0 + wm * 64 < C;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < D; k0 += RK) {
    for (int i = threadIdx.x; i < BM * RK / 8; i += R_THREADS) {
      const int r = i / (RK / 8), c = (i % (RK / 8)) * 8;
      *reinterpret_cast<int4*>(&As[r * LDA + c]) =
          load8(xe, C, D, m0 + r, k0 + c);
    }
    for (int i = threadIdx.x; i < RK * BN / 8; i += R_THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<int4*>(&Bs[r * LDB + c]) =
          load8(we, D, F, k0 + r, n0 + c);
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < RK / 16; ++kk) {
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const uint16_t* ap = &As[(wm * 64 + mt * 16 + g) * LDA + kk * 16 +
                                   2 * t];
          a[mt][0] = ld32(ap);
          a[mt][1] = ld32(ap + 8 * LDA);
          a[mt][2] = ld32(ap + 8);
          a[mt][3] = ld32(ap + 8 * LDA + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint16_t* bp = &Bs[(kk * 16 + 2 * t) * LDB + wn * 32 +
                                   nt * 8 + g];
          const uint32_t b0 = (uint32_t)bp[0] | ((uint32_t)bp[LDB] << 16);
          const uint32_t b1 =
              (uint32_t)bp[8 * LDB] | ((uint32_t)bp[9 * LDB] << 16);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  if (!live) return;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (row >= C || col >= F) continue;
        const uint32_t v = pack_bf16(acc[mt][nt][2 * half],
                                     acc[mt][nt][2 * half + 1]);
        uint16_t* op = oe + (size_t)row * F + col;
        op[0] = (uint16_t)(v & 0xffffu);
        if (col + 1 < F) op[1] = (uint16_t)(v >> 16);
      }
    }
  }
}

// ---- host side -------------------------------------------------------------

// a bf16 (d2, d1, d0) tensor, d0 contiguous, read in (1, b1, b0) boxes
// with the 128-byte swizzle; elements past its edge read as zeros
bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
              uint64_t d2, uint32_t b0, uint32_t b1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x (E, C, D), w (E, D, F), o (E, C, F), all bf16, contiguous and 16-byte
// aligned; counts (E,) int32 or null; E * C * F > 0 and D > 0 (the
// wrapper checks).  Returns the cudaError_t of the launch:
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled,
// cudaErrorInvalidValue when it refuses a map.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* o,
                                     const void* counts, int E, int C, int D,
                                     int F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* cnt = (const int*)counts;
  if (D % 8 || F % 8) {
    const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
    grouped_matmul_ragged_kernel<<<grid, R_THREADS, 0, s>>>(
        (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)o, cnt, C, D, F);
    return (int)cudaGetLastError();
  }
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, D, C, E, BK, BM) ||
      !make_map(&tw, w, F, D, E, 64, BK))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grouped_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)E * ((C + BM - 1) / BM) *
                          ((F + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  grouped_matmul_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      tx, tw, (uint16_t*)o, cnt, E, C, D, F);
  return (int)cudaGetLastError();
}
