// grouped_matmul.cu — one matmul per expert, bf16 in and out, f32
// accumulation: the trustee's expert FFN of the MoE serve path.
//
// Replaces src/repro/kernels/grouped_matmul.py::_gmm_kernel (:25,
// pallas_call :52).  Same function: x (E, C, D) @ w (E, D, F) ->
// (E, C, F), the products of bf16 operands summed in f32 and the sum
// rounded once to bf16.  The Pallas wrapper pads C to 8 and D, F to 128
// (src/repro/kernels/ops.py:106-116); here a ragged C, D or F is masked
// in the kernel: rows past C and columns past F are not stored, and the
// k-tiles' entries past D are loaded as zeros.
//
// Bound: operations where C is large, bytes where it is small.  The MoE
// prefill (E 64, C 3072, D 2048, F 1408) does 2*E*C*D*F = 1.13 TFLOP a
// launch (1.15 ms at 989 TFLOP/s bf16 dense) against 1.73 GB of
// operands; a decode step (C 8) reads 369 MB of expert weights for
// 2.95 GFLOP, 0.11 ms at 3.35 TB/s.  Both count every slot: the serve's
// filled slots (about a quarter at prefill) need less.  The TPU grid ran
// (E, C/bc, F/bf, D/bd) in order with the f32 accumulator in VMEM across
// the last axis; here the D axis is a loop inside the block:
//   * one block of 8 warps per (128-column F tile, 128-row C tile,
//     expert); each warp owns a 64 x 32 piece of the output tile, its
//     f32 accumulator in registers for the whole loop;
//   * per 32-wide k-tile the block stages x's 128 x 32 and w's 32 x 128
//     tile in shared memory with 16-byte loads (rows padded by 8 values,
//     so the fragment reads below hit distinct banks), then runs
//     mma.sync.m16n8k16 bf16 -> f32 on the tensor cores (the fragment
//     code of flash_attention.cu: A as 32-bit pairs along k, B as two
//     16-bit reads down a column);
//   * a warp whose 64 rows all lie past C skips the products (a decode
//     step fills 8 of the tile's 128 rows): the tile's weights are still
//     read once, which is the decode's cost;
//   * the f32 sums are rounded to bf16 once, at the store.
// Right and simple first: no cp.async / TMA pipelining, no wgmma, and
// empty capacity slots are multiplied like full ones.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // C rows per block
constexpr int BN = 128;     // F columns per block
constexpr int BK = 32;      // D depth per k-tile
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 consecutive values of row `row` from column `col` of a (rows, cols)
// row-major matrix, zeros past its edge; 16-byte load where the row
// length allows it
__device__ __forceinline__ int4 load8(const uint16_t* __restrict__ m,
                                      int rows, int cols, bool vec, int row,
                                      int col) {
  if (row >= rows || col >= cols) return make_int4(0, 0, 0, 0);
  const uint16_t* p = m + (size_t)row * cols + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const int4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t lo = col + 2 * j < cols ? p[2 * j] : 0u;
    const uint32_t hi = col + 2 * j + 1 < cols ? p[2 * j + 1] : 0u;
    w[j] = lo | (hi << 16);
  }
  return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

__global__ void __launch_bounds__(THREADS)
    grouped_matmul_kernel(const uint16_t* __restrict__ x,
                          const uint16_t* __restrict__ w,
                          uint16_t* __restrict__ o, int C, int D, int F) {
  __shared__ __align__(16) uint16_t As[BM * LDA];
  __shared__ __align__(16) uint16_t Bs[BK * LDB];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint16_t* xe = x + (size_t)e * C * D;
  const uint16_t* we = w + (size_t)e * D * F;
  uint16_t* oe = o + (size_t)e * C * F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2;           // 2 x 64 rows
  const int wn = warp & 3;            // 4 x 32 columns
  const bool live = m0 + wm * 64 < C;
  const bool vec_a = (D % 8) == 0, vec_b = (F % 8) == 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<int4*>(&As[r * LDA + c]) =
          load8(xe, C, D, vec_a, m0 + r, k0 + c);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<int4*>(&Bs[r * LDB + c]) =
          load8(we, D, F, vec_b, k0 + r, n0 + c);
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
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
  const bool pair = (F % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mt * 16 + g + 8 * half;
        if (row >= C || col >= F) continue;
        const float lo = acc[mt][nt][2 * half], hi = acc[mt][nt][2 * half + 1];
        uint16_t* op = oe + (size_t)row * F + col;
        if (pair) {
          *reinterpret_cast<uint32_t*>(op) = pack_bf16(lo, hi);
        } else {
          const uint32_t v = pack_bf16(lo, hi);
          op[0] = (uint16_t)(v & 0xffffu);
          if (col + 1 < F) op[1] = (uint16_t)(v >> 16);
        }
      }
    }
  }
}

}  // namespace

// x (E, C, D), w (E, D, F), o (E, C, F), all bf16 and contiguous; the
// wrapper checks that the pointers are 16-byte aligned, E fits the grid
// and E * C * F > 0.
extern "C" int grouped_matmul_launch(const void* x, const void* w, void* o,
                                     int E, int C, int D, int F,
                                     void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E), block(THREADS);
  grouped_matmul_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)o, C, D, F);
  return (int)cudaGetLastError();
}
