// wgmma.mma_async for Hopper (sm_90a): D[64 x N] (+)= A[64 x K] * B[K x N],
// B K-major in shared memory, named by a matrix descriptor, A likewise or in
// registers; the accumulators in the registers of the 128 threads of a
// warpgroup.  One instruction takes 32 bytes of K: 16 bf16, 8 tf32 or 32 int8
// values.
//   MmaBf16<N>: m64nNk16, bf16 x bf16 -> f32, A and B in shared memory
//   MmaTf32<N>: m64nNk8,  tf32 x tf32 -> f32 (operands are f32 words whose low
//               13 mantissa bits the tensor core does not read), A in registers
//   MmaS8<N>:   m64nNk32, s8 x s8 -> s32 (exact), A and B in shared memory
// PTX wants every accumulator register named, so the register lists are made
// by the macros below, for N = 32, 64, 96, 128 and 192: N / 2 registers a
// thread.  Thread t of the warpgroup (warp t / 32, lane l) holds, for
// j = 0 .. N/8 - 1:
//   d[4j + 0], d[4j + 1]: row 16 * warp + l / 4,     columns 8j + 2 (l % 4) + {0, 1}
//   d[4j + 2], d[4j + 3]: row 16 * warp + l / 4 + 8, the same columns.
// ... and of a tf32 A tile [64 x 8] in registers:
//   a[0], a[1]: rows 16 * warp + l / 4 and + 8, column l % 4
//   a[2], a[3]: the same rows, column l % 4 + 4.
#pragma once

#include <cstdint>

namespace repnerv {
namespace wgmma {

// Order the warpgroup's earlier register and shared-memory accesses before
// its next wgmma.mma_async.
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
// Close the group of the wgmma.mma_async started so far.
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most PENDING committed groups are still running.
template <int PENDING>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Keep the compiler from moving a use of an accumulator across this point
// (the asynchronous MMAs write the registers until wait() returns).
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// ... or reusing the register of an A operand that a running MMA still reads
template <int R>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are ROW_BYTES
// (64 or 128) in the swizzle of that width, as a TMA load with
// CU_TENSOR_MAP_SWIZZLE_64B / _128B leaves it: groups of 8 rows, 8 * ROW_BYTES
// apart.  The tile must start on a boundary of 8 * ROW_BYTES; the next 32
// bytes of K of a row are the descriptor plus DESC_K_STEP.
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr) {
  static_assert(ROW_BYTES == 64 || ROW_BYTES == 128, "the 64- and 128-byte swizzles");
  uint64_t d = static_cast<uint64_t>((smem_addr & 0x3FFFF) >> 4);  // start address
  d |= static_cast<uint64_t>(1) << 16;                             // leading offset: unused here
  d |= static_cast<uint64_t>(8 * ROW_BYTES >> 4) << 32;            // stride between 8-row groups
  d |= static_cast<uint64_t>(ROW_BYTES == 64 ? 2 : 1) << 62;       // swizzle mode
  return d;
}
constexpr uint64_t DESC_K_STEP = 32 >> 4;

template <int N>
struct MmaBf16;
template <int N>
struct MmaTf32;
template <int N>
struct MmaS8;

// "%0, ..., %15" and so on: the accumulators' places in the operand list
#define REPNERV_R16_0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define REPNERV_R16_1 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REPNERV_R16_2 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define REPNERV_R16_3 \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define REPNERV_R16_4 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define REPNERV_R16_5 \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define REPNERV_REGS_16 REPNERV_R16_0
#define REPNERV_REGS_32 REPNERV_REGS_16 ", " REPNERV_R16_1
#define REPNERV_REGS_48 REPNERV_REGS_32 ", " REPNERV_R16_2
#define REPNERV_REGS_64 REPNERV_REGS_48 ", " REPNERV_R16_3
#define REPNERV_REGS_96 REPNERV_REGS_64 ", " REPNERV_R16_4 ", " REPNERV_R16_5

// ... and the operands themselves, C the constraint ("+f" or "+r")
#define REPNERV_O16(C, d, o)                                                                  \
  C(d[o]), C(d[o + 1]), C(d[o + 2]), C(d[o + 3]), C(d[o + 4]), C(d[o + 5]), C(d[o + 6]),      \
      C(d[o + 7]), C(d[o + 8]), C(d[o + 9]), C(d[o + 10]), C(d[o + 11]), C(d[o + 12]),        \
      C(d[o + 13]), C(d[o + 14]), C(d[o + 15])
#define REPNERV_OPS_16(C, d) REPNERV_O16(C, d, 0)
#define REPNERV_OPS_32(C, d) REPNERV_OPS_16(C, d), REPNERV_O16(C, d, 16)
#define REPNERV_OPS_48(C, d) REPNERV_OPS_32(C, d), REPNERV_O16(C, d, 32)
#define REPNERV_OPS_64(C, d) REPNERV_OPS_48(C, d), REPNERV_O16(C, d, 48)
#define REPNERV_OPS_96(C, d) REPNERV_OPS_64(C, d), REPNERV_O16(C, d, 64), REPNERV_O16(C, d, 80)
#define REPNERV_ACC_F32(x) "+f"(x)
#define REPNERV_ACC_S32(x) "+r"(x)

// One width of one type.  R = N / 2 accumulators; the descriptors and the
// scale flag are operands R, R + 1 and R + 2.  scale_d == 0: D = A * B (the
// accumulators' old values are not read).
#define REPNERV_MMA(STRUCT, ACC_T, C, N, R, A, B, S, KTYPES, TAIL)                            \
  template <>                                                                                 \
  struct STRUCT<N> {                                                                          \
    static __device__ __forceinline__ void run(ACC_T (&d)[R], uint64_t desc_a,                \
                                               uint64_t desc_b, int scale_d) {                \
      asm volatile(                                                                           \
          "{\n"                                                                               \
          ".reg .pred p;\n"                                                                   \
          "setp.ne.b32 p, %" #S ", 0;\n"                                                      \
          "wgmma.mma_async.sync.aligned.m64n" #N KTYPES " {" REPNERV_REGS_##R "}, "           \
          "%" #A ", %" #B ", p" TAIL ";\n"                                                    \
          "}\n"                                                                               \
          : REPNERV_OPS_##R(C, d)                                                             \
          : "l"(desc_a), "l"(desc_b), "r"(scale_d));                                          \
    }                                                                                         \
  };
// The same with A in registers: operands R .. R + 3 are the thread's part of
// the A tile, R + 4 the descriptor of B, R + 5 the scale flag.
#define REPNERV_MMA_RS(STRUCT, N, R, A0, A1, A2, A3, B, S, KTYPES, TAIL)                      \
  template <>                                                                                 \
  struct STRUCT<N> {                                                                          \
    static __device__ __forceinline__ void run(float (&d)[R], const uint32_t (&a)[4],         \
                                               uint64_t desc_b, int scale_d) {                \
      asm volatile(                                                                           \
          "{\n"                                                                               \
          ".reg .pred p;\n"                                                                   \
          "setp.ne.b32 p, %" #S ", 0;\n"                                                      \
          "wgmma.mma_async.sync.aligned.m64n" #N KTYPES " {" REPNERV_REGS_##R "}, "           \
          "{%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p" TAIL ";\n"                   \
          "}\n"                                                                               \
          : REPNERV_OPS_##R(REPNERV_ACC_F32, d)                                               \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));           \
    }                                                                                         \
  };
#define REPNERV_MMA_WIDTHS(STRUCT, ACC_T, C, KTYPES, TAIL)         \
  REPNERV_MMA(STRUCT, ACC_T, C, 32, 16, 16, 17, 18, KTYPES, TAIL)  \
  REPNERV_MMA(STRUCT, ACC_T, C, 64, 32, 32, 33, 34, KTYPES, TAIL)  \
  REPNERV_MMA(STRUCT, ACC_T, C, 96, 48, 48, 49, 50, KTYPES, TAIL)  \
  REPNERV_MMA(STRUCT, ACC_T, C, 128, 64, 64, 65, 66, KTYPES, TAIL) \
  REPNERV_MMA(STRUCT, ACC_T, C, 192, 96, 96, 97, 98, KTYPES, TAIL)

// after the flag: scale of A, scale of B (1, 1) and, for 16-bit types only,
// the two transpose flags (0, 0: both K-major); the integer form takes none
REPNERV_MMA_WIDTHS(MmaBf16, float, REPNERV_ACC_F32, "k16.f32.bf16.bf16", ", 1, 1, 0, 0")
REPNERV_MMA_RS(MmaTf32, 32, 16, 16, 17, 18, 19, 20, 21, "k8.f32.tf32.tf32", ", 1, 1")
REPNERV_MMA_RS(MmaTf32, 64, 32, 32, 33, 34, 35, 36, 37, "k8.f32.tf32.tf32", ", 1, 1")
REPNERV_MMA_RS(MmaTf32, 96, 48, 48, 49, 50, 51, 52, 53, "k8.f32.tf32.tf32", ", 1, 1")
REPNERV_MMA_WIDTHS(MmaS8, int, REPNERV_ACC_S32, "k32.s32.s8.s8", "")

#undef REPNERV_MMA_WIDTHS
#undef REPNERV_MMA_RS
#undef REPNERV_MMA

}  // namespace wgmma
}  // namespace repnerv
