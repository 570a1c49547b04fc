// flash_attention.cu — causal (or full) GQA attention forward, bf16 in and
// out, f32 softmax statistics: the prefill attention of the model path.
//
// Replaces src/repro/kernels/flash_attention.py::_fa_kernel (:26,
// pallas_call :95).  Same function: q (B, Hq, Sq, D) against k, v
// (B, Hkv, Skv, D), query head h reading KV head h / (Hq / Hkv); query i
// sits at position q_offset + i and, when causal, sees keys j <= that
// position; masked scores are NEG_INF = -1e30; a running (m, l, acc) in
// f32 over KV tiles (online softmax); KV tiles wholly in the future of a
// query tile are skipped; out = acc / max(l, 1e-30) in bf16.  Unlike the
// Pallas wrapper (which asserts Sq % 128 == 0 and Skv % 128 == 0), a
// ragged tail of Sq or Skv is masked here: rows past Sq are not stored,
// keys past Skv score NEG_INF (their tile rows arrive as zeros).
//
// Bound: operations.  4 * B * Hq * D flops for every (query, key) pair the
// mask keeps (QK^T and PV), over 989 TFLOP/s bf16 dense; at the qwen
// prefill's B 4, Hq 16, Sq = Skv = 2048, D 128 that is 68.7 GFLOP (0.0695
// ms) against 75.5 MB of q, k, v and out (0.0225 ms at 3.35 TB/s).  The
// TPU grid ran (B*Hq, Sq/bq, Skv/bk) in order with (m, l, acc) in VMEM
// across the last axis.  Here blocks run in parallel, so the KV axis is a
// loop inside the block.  The tensor cores reach their rate only through
// wgmma fed from shared memory (the mma.sync kernel before this one ran at
// 107 TFLOP/s, loads and products in series), and beside the products the
// softmax's exponentials (one per score, 16 a clock an SM) and its
// dependent max and sum chains cost as much as the products themselves.
// D 64, 128, 192 and 256 take the warp-specialised kernel:
//   * one block per (128-row query tile, batch, query head), the heaviest
//     query tiles (the causal diagonal's far end) issued first and the
//     query heads of one KV group on neighbouring blocks, so one read of a
//     K/V tile from device memory serves the group through the L2;
//   * a producer warp (one thread) loads the block's Q tile once and keeps
//     2 stages of K and V tiles in flight with TMA: 4-d maps over the
//     strided (D, H, S, B) views (the model's (B, S, H, D) tensors are read
//     in place), 64-column boxes with the 128-byte swizzle, completed on
//     an mbarrier ring ("full"), handed back on a second one ("empty");
//     rows past Sq or Skv arrive as zeros (TMA's out-of-bounds fill);
//   * two consumer warpgroups, 64 query rows each, run both products with
//     wgmma.mma_async bf16 -> f32: S = Q K^T with Q and K from shared
//     memory, both K-major (m64nBKk16); O += P V with P from registers
//     (the S accumulator's layout is the A operand's) and V MN-major
//     through the transpose bit (m64nDk16).  While one warpgroup runs its
//     softmax the other's products keep the tensor cores busy.  P is
//     rounded to bf16 for the PV product (Pallas kept it in f32), l sums
//     the unrounded f32 P;
//   * the online softmax stays in registers, with independent work for
//     the SFU and the adders: the scale folded into the exponent (one FMA
//     and one ex2.approx.ftz a score), the row maxima and sums as trees,
//     the causal and ragged masks only on the tiles that need them, and a
//     warpgroup skips (but hands back) a KV tile wholly past its own rows'
//     diagonal;
//   * registers: at D 192 the 64 x 192 f32 output accumulator alone is 96
//     a thread, so K/V tiles there are 64 keys (BK 64), 128 elsewhere; no
//     product is serialised and nothing spills at 168 registers a thread;
//   * at D 256 (gemma-7b) the accumulator is 64 x 256 f32, 128 registers a
//     thread, beside the 32 of a 64-key S tile and the 16 of its bf16 P:
//     more than the 168 a thread that 384 threads get, so ptxas spills
//     (S's accumulators around the QK^T wgmma) and serialises the wgmma;
//     m64n256k16 is wgmma's widest N.  The warpgroup index is shuffled
//     from lane 0 there, so that ptxas sees the branch warp-uniform: with
//     nvcc 12.9 that halves the spill (472 to 232 bytes of stores).
//     FlashAttention-3's register split (setmaxnreg.dec to 40 in the
//     producer, .inc to 232 in the consumers) was tried and left out:
//     ptxas still allocated the consumers' code within 168 (216 bytes of
//     stores).  Right and 2.2x SDPA on an H100; one consumer warpgroup a
//     block (255 registers) or two passes over D's halves are the ways
//     past it.
//     Issuing tile j's QK^T beside tile j - 1's PV (more registers, a third
//     stage) and turns between the two warpgroups on named barriers were
//     both tried and were not faster on an H100.
// Shared memory: Q 128 x D, and 2 stages of K and V BK x D: 160 KB at D
// 128, 144 KB at D 192, 192 KB at D 256, 80 KB at D 64 (opted in past 48
// KB).  TMA needs
// 16-byte strides and a 16-byte aligned base: the wrapper copies a tensor
// that has neither.  D 32, which no main path uses, keeps the simple
// mma.sync kernel at the end of this file (a choice by shape, stated in
// the wrapper; both are held to the plain version).
#include "sm90.cuh"

#define FULL 0xffffffffu
#define NEG_INF -1e30f

namespace {

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

// d (64 x 64 f32) = (scale_d ? d : 0) + A (64 x 16, K-major, shared) x
// B (16 x 64, K-major, shared)
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) = (scale_d ? d : 0) + A (64 x 16, K-major, shared) x
// B (16 x 128, K-major, shared)
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
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
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers, the accumulator
// layout) x B (16 x 64, MN-major, shared: imm-trans-b = 1)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16 in registers, the accumulator
// layout) x B (16 x 128, MN-major, shared: imm-trans-b = 1)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 f32) += A (64 x 16 bf16 in registers, the accumulator
// layout) x B (16 x 192, MN-major, shared: imm-trans-b = 1)
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256 f32) += A (64 x 16 bf16 in registers, the accumulator
// layout) x B (16 x 256, MN-major, shared: imm-trans-b = 1)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the TMA + wgmma kernel (D 64, 128, 192, 256) --------------------------

constexpr int BQ = 128;      // query rows per block: two warpgroups of 64
constexpr int WG = 128;      // threads of a warpgroup
constexpr int THREADS = 3 * WG;   // producer + 2 consumers

template <int D>
struct Tile {
  static constexpr int BK = D >= 192 ? 64 : 128;   // keys per KV tile
  static constexpr int STAGES = 2;
  static constexpr int CB = D / 64;                // 64-column boxes a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES + 1024 +
                              8 * (1 + 2 * STAGES);
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one warpgroup's S tile (64 rows x BK keys) in
// wgmma's accumulator layout: a thread holds rows r0 (elements 4 n, 4 n + 1)
// and r1 = r0 + 8 (4 n + 2, 4 n + 3), columns 8 n + 2 t (+ 1); the four
// lanes of a row share it through shuffles.  Masked scores are set to
// NEG_INF before the scale (still below -1e29 after it: their weight is
// 0); the scale is folded into the exponent, p = 2^(s * scale_log2 - m);
// the maxima and sums are trees, so the SFU and the adders see independent
// work; l keeps this lane's share of each row's sum of the f32 weights.
template <int BK>
struct Rows {
  int first_pos, qp0, qp1, Skv;     // positions: the warpgroup's first row,
  bool causal;                      // this thread's rows
  int t;
  float scale_log2;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float al0 = 1.f, al1 = 1.f;       // the last tile's rescale factors

  __device__ __forceinline__ void softmax(float (&s)[BK / 2], int k0) {
    constexpr int NK = BK / 8;
    if ((k0 + BK > Skv) || (causal && k0 + BK - 1 > first_pos)) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= Skv || (causal && kp > qp)) s[4 * n + e] = NEG_INF;
        }
    }
    float v0[NK], v1[NK];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      v0[n] = fmaxf(s[4 * n], s[4 * n + 1]);
      v1[n] = fmaxf(s[4 * n + 2], s[4 * n + 3]);
    }
#pragma unroll
    for (int lv = 1; lv < NK; lv *= 2)     // a tree: log2(NK) levels
#pragma unroll
      for (int n = 0; n + lv < NK; n += 2 * lv) {
        v0[n] = fmaxf(v0[n], v0[n + lv]);
        v1[n] = fmaxf(v1[n], v1[n + lv]);
      }
    v0[0] = fmaxf(v0[0], __shfl_xor_sync(FULL, v0[0], 1));
    v1[0] = fmaxf(v1[0], __shfl_xor_sync(FULL, v1[0], 1));
    v0[0] = fmaxf(v0[0], __shfl_xor_sync(FULL, v0[0], 2));
    v1[0] = fmaxf(v1[0], __shfl_xor_sync(FULL, v1[0], 2));
    const float mx0 = fmaxf(m0, v0[0] * scale_log2);
    const float mx1 = fmaxf(m1, v1[0] * scale_log2);
    al0 = ex2(m0 - mx0);
    al1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[4 * n] = ex2(fmaf(s[4 * n], scale_log2, -mx0));
      s[4 * n + 1] = ex2(fmaf(s[4 * n + 1], scale_log2, -mx0));
      s[4 * n + 2] = ex2(fmaf(s[4 * n + 2], scale_log2, -mx1));
      s[4 * n + 3] = ex2(fmaf(s[4 * n + 3], scale_log2, -mx1));
      v0[n] = s[4 * n] + s[4 * n + 1];
      v1[n] = s[4 * n + 2] + s[4 * n + 3];
    }
#pragma unroll
    for (int lv = 1; lv < NK; lv *= 2)
#pragma unroll
      for (int n = 0; n + lv < NK; n += 2 * lv) {
        v0[n] += v0[n + lv];
        v1[n] += v1[n + lv];
      }
    l0 = l0 * al0 + v0[0];
    l1 = l1 * al1 + v1[0];
  }

  // the output accumulator (the same layout, ND 8-column groups) onto
  // the last tile's running maximum
  template <int ND>
  __device__ __forceinline__ void rescale(float (&acc)[ND * 4]) const {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[4 * n] *= al0;
      acc[4 * n + 1] *= al0;
      acc[4 * n + 2] *= al1;
      acc[4 * n + 3] *= al1;
    }
  }

  __device__ __forceinline__ float row_sum(float l) const {
    l += __shfl_xor_sync(FULL, l, 1);
    return l + __shfl_xor_sync(FULL, l, 2);
  }
};

// P (the exponentiated S tile) rounded to bf16 as wgmma's register A
// operand: k-step kk takes S's 8-column groups 2 kk and 2 kk + 1
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T for one warpgroup's 64 query rows (Q at qw) against the BK
// keys of a K tile (at kt), issued and committed, not waited for.
// 16-deep k-steps advance 32 bytes in a swizzled 128-byte row, and a
// 64-column box every 4 steps (Q's boxes BQ * 128 bytes apart, K's BK *
// 128); 8-row groups are 1024 bytes apart in both operands
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t qw,
                                        uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(
        s, sw128_desc(qw + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
        sw128_desc(kt + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
}

// O += P V for a V tile at vt, issued and committed, not waited for: P's
// k-step kk is pa[kk]; V's k-steps are 16 rows of 128 bytes, its 64-column
// boxes BK * 128 bytes apart
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], sw128_desc(vt + kk * 16 * 128, BK * 128, 1024));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           uint16_t* __restrict__ o, int B, int Hq, int Hkv,
                           int Sq, int Skv, long long osb, long long osh,
                           long long oss, float scale_log2, int causal,
                           int q_offset) {
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::STAGES, CB = T::CB;
  constexpr int NK = BK / 8;       // 8-column groups of S
  constexpr int ND = D / 8;        // 8-column groups of O
  extern __shared__ unsigned char smem[];
  // Q: CB boxes of BQ x 64; stage s: K (CB boxes of BK x 64), then V;
  // then the barriers: Q's, full[s], empty[s]
  const uint32_t qs = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t kvs = qs + T::Q_BYTES;
  const uint32_t qbar = kvs + STAGES * T::STAGE_BYTES;
  const uint32_t full = qbar + 8, empty = full + 8 * STAGES;

  // block -> (query tile, batch, query head): the heaviest query tiles
  // first, and a KV group's query heads on neighbouring blocks
  const int heads = B * Hq;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)(blockIdx.x / heads)) * BQ;
  const int b = (int)(blockIdx.x % heads) / Hq;
  const int h = (int)(blockIdx.x % heads) % Hq;
  const int kvh = h / (Hq / Hkv);
  // keys this query tile can see: up to the causal diagonal of its last
  // live row (KV tiles past it are never loaded)
  const int kv_end =
      causal ? min(Skv, q_offset + min(q0 + BQ, Sq)) : Skv;
  const int ntiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);      // one arrival per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup; at D 256 shuffled from lane 0 so that ptxas sees it
  // uniform over the warp (with nvcc 12.9 it halves D 256's spill)
  const int wgi = D == 256 ? __shfl_sync(FULL, (int)(threadIdx.x / WG), 0)
                           : (int)(threadIdx.x / WG);
  if (wgi == 0) {
    // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
        tma_load_4d(qs + cb * BQ * 128, &tq, 64 * cb, h, q0, b, qbar);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t kt = kvs + s * T::STAGE_BYTES, vt = kt + T::KV_BYTES;
        mbar_expect_tx(full + 8 * s, T::STAGE_BYTES);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          tma_load_4d(kt + cb * BK * 128, &tk, 64 * cb, kvh, j * BK, b,
                      full + 8 * s);
          tma_load_4d(vt + cb * BK * 128, &tv, 64 * cb, kvh, j * BK, b,
                      full + 8 * s);
        }
      }
    }
  } else {
    // the consumers: rows q0 + 64 wg .. + 63, KV tile by KV tile: S = Q
    // K^T, the softmax, O += P V
    const int wg = wgi - 1;
    const int tid = threadIdx.x % WG, warp = tid >> 5, lane = tid & 31;
    const int row0 = q0 + 64 * wg;
    const int r0 = row0 + 16 * warp + (lane >> 2), r1 = r0 + 8;
    const bool live = row0 < Sq;
    Rows<BK> rows{q_offset + row0, q_offset + r0, q_offset + r1, Skv,
                  causal != 0, lane & 3, scale_log2};
    // the KV tiles this warpgroup computes: those not wholly past its
    // last live row's diagonal (the rest it only hands back)
    int n_wg = live ? ntiles : 0;
    if (live && causal)
      n_wg = min(ntiles, (q_offset + min(row0 + 63, Sq - 1)) / BK + 1);
    const uint32_t qw = qs + wg * 64 * 128;   // this warpgroup's Q rows

    float acc[ND * 4], s[NK * 4];
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NK * 4; ++i) s[i] = 0.f;
    uint32_t pa[BK / 16][4];

    mbar_wait(qbar, 0);
    for (int j = 0; j < n_wg; ++j) {
      const int st = j % STAGES;
      const uint32_t kt = kvs + st * T::STAGE_BYTES, vt = kt + T::KV_BYTES;
      mbar_wait(full + 8 * st, (j / STAGES) & 1);
      fence_acc(s);
      wgmma_fence();
      issue_s<D, BK>(s, qw, kt);
      wgmma_wait<0>();
      fence_acc(s);
      rows.softmax(s, j * BK);
      rows.template rescale<ND>(acc);
      pack_p<BK>(s, pa);
      fence_acc(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, vt);
      wgmma_wait<0>();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty + 8 * st);
    }
    for (int j = n_wg; j < ntiles; ++j) {   // nothing here to see
      mbar_wait(full + 8 * (j % STAGES), (j / STAGES) & 1);
      if (tid == 0) mbar_arrive(empty + 8 * (j % STAGES));
    }

    if (!live) return;
    const float d0 = fmaxf(rows.row_sum(rows.l0), 1e-30f);
    const float d1 = fmaxf(rows.row_sum(rows.l1), 1e-30f);
    uint16_t* ob = o + b * osb + h * osh;
    const int t = lane & 3;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * oss + c) =
            pack_bf16(acc[4 * n] / d0, acc[4 * n + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * oss + c) =
            pack_bf16(acc[4 * n + 2] / d1, acc[4 * n + 3] / d1);
    }
  }
}

// ---- the mma.sync kernel (D 32) --------------------------------------------
//
// One block of 4 warps per (batch, query head, 64-row query tile); K and V
// staged in shared memory by the same threads that compute, 64 keys a
// tile; both products on mma.sync.m16n8k16.  Same function, masks and
// rounding as the kernel above.

constexpr int M_BQ = 64;    // query rows per block, 16 per warp
constexpr int M_BK = 64;    // keys per tile
constexpr int M_THREADS = 128;

template <int D>
__global__ void __launch_bounds__(M_THREADS)
    flash_attention_mma_kernel(const uint16_t* __restrict__ q,
                               const uint16_t* __restrict__ k,
                               const uint16_t* __restrict__ v,
                               uint16_t* __restrict__ o, int Hq, int Hkv,
                               int Sq, int Skv, long long qsb, long long qsh,
                               long long qss, long long ksb, long long ksh,
                               long long kss, long long vsb, long long vsh,
                               long long vss, long long osb, long long osh,
                               long long oss, float scale_log2, int causal,
                               int q_offset) {
  constexpr int LD = D + 8;           // padded shared-memory row
  constexpr int KD = D / 16;          // k-steps of QK^T
  constexpr int ND = D / 8;           // n-tiles of the output
  constexpr int NK = M_BK / 8;        // n-tiles of S
  constexpr int VPR = D / 8;          // 16-byte vectors per row
  extern __shared__ __align__(16) uint16_t msmem[];  // 2 * M_BK * LD
  uint16_t* Ks = msmem;
  uint16_t* Vs = msmem + M_BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * M_BQ;  // heavy first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  const uint16_t* qb = q + b * qsb + h * qsh;
  const uint16_t* kb = k + b * ksb + kvh * ksh;
  const uint16_t* vb = v + b * vsb + kvh * vsh;

  // this warp's 16 query rows as A fragments, kept for the whole loop
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < Sq ? ld32(qb + r0 * qss + c) : 0u;
    qa[kk][1] = r1 < Sq ? ld32(qb + r1 * qss + c) : 0u;
    qa[kk][2] = r0 < Sq ? ld32(qb + r0 * qss + c + 8) : 0u;
    qa[kk][3] = r1 < Sq ? ld32(qb + r1 * qss + c + 8) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // keys this query tile can see: up to the causal diagonal of its last
  // live row (KV tiles past it are skipped)
  int kv_end = Skv;
  if (causal) {
    const int last = q_offset + min(q0 + M_BQ, Sq) - 1;
    kv_end = min(Skv, last + 1);
  }
  const int qp0 = q_offset + r0, qp1 = q_offset + r1;

  for (int k0 = 0; k0 < kv_end; k0 += M_BK) {
    __syncthreads();                  // every warp is done with the tile
    for (int i = threadIdx.x; i < M_BK * VPR; i += M_THREADS) {
      const int r = i / VPR, c = (i % VPR) * 8;
      int4 kx = make_int4(0, 0, 0, 0), vx = make_int4(0, 0, 0, 0);
      if (k0 + r < Skv) {
        kx = *reinterpret_cast<const int4*>(kb + (k0 + r) * kss + c);
        vx = *reinterpret_cast<const int4*>(vb + (k0 + r) * vss + c);
      }
      *reinterpret_cast<int4*>(&Ks[r * LD + c]) = kx;
      *reinterpret_cast<int4*>(&Vs[r * LD + c]) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const uint16_t* kr = &Ks[(n * 8 + g) * LD + kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale (log2 domain), masks on the tiles that need them, online
    // softmax per row: rows r0 (elements 0, 1) and r1 (elements 2, 3)
    const bool masked = (k0 + M_BK > Skv) ||
                        (causal && k0 + M_BK - 1 > q_offset + q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int kp = k0 + n * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= Skv || (causal && kp > qp)) x = NEG_INF;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float al0 = exp2f(m0 - mx0), al1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;              // this lane's share of the row sum
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V: S's accumulator layout is the A fragment layout of P
#pragma unroll
    for (int kk = 0; kk < M_BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const uint16_t* vr = &Vs[(kk * 16 + 2 * t) * LD + n * 8 + g];
        const uint32_t b0 = (uint32_t)vr[0] | ((uint32_t)vr[LD] << 16);
        const uint32_t b1 =
            (uint32_t)vr[8 * LD] | ((uint32_t)vr[9 * LD] << 16);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  uint16_t* ob = o + b * osb + h * osh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * oss + c) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * oss + c) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// the K and V tiles, M_BK rows of D + 8 values each (10,240 bytes at D 32)
constexpr int mma_smem_bytes(int d) { return 2 * M_BK * (d + 8) * 2; }

// ---- host side -------------------------------------------------------------

// a bf16 (B, S, H, D)-indexed tensor with element strides sb, ss, sh (D
// contiguous), as a 4-d map over (D, H, S, B) read in (64, 1, rows, 1)
// boxes with the 128-byte swizzle; rows past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
              long long sb, long long sh, long long ss, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int B, int Hq, int Hkv, int Sq, int Skv, long long qsb,
                 long long qsh, long long qss, long long ksb, long long ksh,
                 long long kss, long long vsb, long long vsh, long long vss,
                 long long osb, long long osh, long long oss,
                 float scale_log2, int causal, int q_offset,
                 cudaStream_t s) {
  using T = Tile<D>;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, Sq, D, qsb, qsh, qss, BQ) ||
      !make_map(&tk, k, B, Hkv, Skv, D, ksb, ksh, kss, T::BK) ||
      !make_map(&tv, v, B, Hkv, Skv, D, vsb, vsh, vss, T::BK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BQ - 1) / BQ) * B * Hq;
  flash_attention_kernel<D><<<(unsigned)blocks, THREADS, T::SMEM, s>>>(
      tq, tk, tv, (uint16_t*)o, B, Hq, Hkv, Sq, Skv, osb, osh, oss,
      scale_log2, causal, q_offset);
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes a thread and dynamic shared memory of the
// kernel that takes head dim D, as built
template <int D>
int wgmma_info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, flash_attention_kernel<D>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = Tile<D>::SMEM;
  return 0;
}

}  // namespace

// out[0..2] = registers, local bytes and dynamic shared memory of the
// kernel that takes head dim D (the mma.sync kernel's at D 32)
extern "C" int flash_attention_info(int D, int* out) {
  if (D == 64) return wgmma_info<64>(out);
  if (D == 128) return wgmma_info<128>(out);
  if (D == 192) return wgmma_info<192>(out);
  if (D == 256) return wgmma_info<256>(out);
  if (D != 32) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e =
      cudaFuncGetAttributes(&attr, flash_attention_mma_kernel<32>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = mma_smem_bytes(32);
  return 0;
}

// Strides are in elements (the last dimension is contiguous); the wrapper
// checks that every stride is a multiple of 8 and every pointer 16-byte
// aligned (TMA's 16-byte strides), that D is 32, 64, 128, 192 or 256,
// Skv > 0, and that the grid fits.  Returns the cudaError_t of the launch:
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled,
// cudaErrorInvalidValue when it refuses a map or D is not taken.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, int q_offset,
    void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_WGMMA(DD)                                                        \
  return launch_wgmma<DD>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qsb, qsh, qss,  \
                          ksb, ksh, kss, vsb, vsh, vss, osb, osh, oss,      \
                          scale_log2, causal, q_offset, s)
  if (D == 64) FA_WGMMA(64);
  if (D == 128) FA_WGMMA(128);
  if (D == 192) FA_WGMMA(192);
  if (D == 256) FA_WGMMA(256);
#undef FA_WGMMA
  if (D != 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + M_BQ - 1) / M_BQ, B * Hq), block(M_THREADS);
  flash_attention_mma_kernel<32><<<grid, block, mma_smem_bytes(32), s>>>(
      (const uint16_t*)q, (const uint16_t*)k, (const uint16_t*)v,
      (uint16_t*)o, Hq, Hkv, Sq, Skv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh,
      vss, osb, osh, oss, scale_log2, causal, q_offset);
  return (int)cudaGetLastError();
}
