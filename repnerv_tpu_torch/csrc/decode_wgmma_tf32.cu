// The f32 stage kernel on the tensor cores: stage_wgmma.cuh's mainloop with
// each f32 product made of three TF32 products.
//
// Replaces, for f32 stages whose Cin is a multiple of 4 and C of 8 (blocks 2-4
// of the 720p flagship), the TPU kernels
// repnerv_tpu/pallas_kernels/decode.py::fused_conv_ps_act and
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_fwd_kernel_call with f32
// operands; decode.cu's FMA kernel keeps the other f32 shapes.
//
// What bounds it: operations, three tensor-core products per f32 product:
// 495 / 3 = 165 TFLOP/s of f32-grade work against the FMA pipes' 67.
//
// A TF32 wgmma alone reads 10 mantissa bits of each operand, which is not f32.
// So each operand is split into two TF32 numbers, a = hi + lo: hi is a rounded
// to 10 mantissa bits (nearest, ties away from zero), lo = a - hi (exact in
// f32) rounded the same way; both have their low 13 bits clear, so every
// product is exact in the tensor core whatever it does with those bits.  Three
// products are summed, the small ones first:
//   a_lo * b_hi + a_hi * b_lo + a_hi * b_hi;
// what is dropped, a_lo * b_lo and lo's own rounding, is ~2^-22 of a * b.
//   * The sum over K is not left to the tensor cores.  They add each group of
//     8 products into the f32 accumulator by truncation, not to nearest, so a
//     sum of 3 * K / 8 = 324 such additions (K = 864) drifts toward zero by up
//     to an ulp of the running sum each time: the first form of this kernel,
//     which summed everything in wgmma accumulators, stood 2.8e-5 from the
//     exact-f32 result where the FMA kernel stood 6.8e-6.  So a ring slot's
//     six MMAs go into fresh registers (small partial sums, small truncation),
//     and ordinary f32 additions, rounded to nearest, add them into the sums
//     the epilogue reads.  Two such sets of registers alternate, so the
//     additions of one slot run while the tensor cores work on the next.
//     That is 3 x 48 registers at N = 96, so a work item holds one sub-pixel.
//   * B: kernels/decode.py::pack_weights splits the K-major weights once
//     ([2, s*s*C, 9*Cin]: hi, lo); a slot holds a tile of each, loaded through
//     two tensor maps.
//   * A arrives by TMA as raw f32 and is split on its way into the tensor
//     cores: wgmma takes A from registers, so a thread reads its part of the
//     landed tile from shared memory through the swizzle (8 words a slot, no
//     bank conflict), splits each word in registers and hands hi or lo to the
//     MMA.  Nothing is written back, so no second tile, no proxy fence and no
//     barrier; and at N = 96 a wgmma that reads A from shared memory too would
//     fetch 5 KB for what now takes 3.  The registers of one slot's A stay
//     untouched until its wgmma group has been waited for (two sets, by the
//     step's parity).
//   * A ring slot holds 16 input channels of one tap: rows of 64 bytes in the
//     64-byte swizzle as in the bf16 kernel; A 8 KB, B 6 + 6 KB at N = 96,
//     eight slots.  Six m64nBNk8 wgmma a slot and warpgroup.
//   * The epilogue keeps the exact expf and division of apply_act; out and z
//     are stored as f32 pairs, z in the first pass (96 more registers to hold
//     it until the store pass would spill).

#include "stage_wgmma.cuh"

namespace repnerv {
namespace {

// nearest TF32 number, ties away from zero (cvt.rna.tf32.f32), low 13 bits clear
__device__ __forceinline__ float tf32_round(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
}
struct Tf32x3Policy {
  using Acc = float;
  using Out = float;
  using ZPair = float2;
  static constexpr int ELEM_BYTES = 4, ROW_BYTES = 64, BK = ROW_BYTES / ELEM_BYTES;
  static constexpr int STAGES = 8, A_COPIES = 1, B_PARTS = 2, NSUB = 1;
  static constexpr int MIN_CIN_STEP = 4, MAX_CIN = 0;
  template <int N>
  struct Regs {
    float d[N / 2];     // the sums, added to nearest
    float t[2][N / 2];  // a slot's sums out of the tensor cores, by the step's parity
    uint32_t a[2][16];  // a slot's A words as TF32 numbers: [parity][8 * k8 + 4 * (lo) + i]
  };
  static constexpr bool FAST_SWISH = false, DEQUANT = false, INT8_OUT = false, HAS_Z = true,
                        PACK_Z = false, HAS_HEAD = true;
  static constexpr CUtensorMapDataType DATA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;

  static __device__ __forceinline__ ZPair pack_pair(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ void store_pair(Out* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }

  template <int N, typename L, int BUF>
  static __device__ __forceinline__ void products(Regs<N>& regs, unsigned char* slot, int wg,
                                                  int t, bool /*first*/, int /*k32s*/) {
    float(&acc)[N / 2] = regs.t[BUF];
    uint32_t(&a)[16] = regs.a[BUF];
    // this thread's rows of the A tile [128 pixels][16 channels]: row and row + 8;
    // the 64-byte swizzle exchanges a row's 16-byte chunks by bits 1-2 of the row
    const int lane = t % 32, row = wg * 64 + (t / 32) * 16 + lane / 4;
    const unsigned char* rows = slot + row * ROW_BYTES + (lane % 4) * 4;
#pragma unroll
    for (int chunk = 0; chunk < ROW_BYTES / 16; ++chunk) {  // channels 4 * chunk + lane % 4
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const float v = *reinterpret_cast<const float*>(rows + r8 * 8 * ROW_BYTES +
                                                        ((chunk ^ (lane / 8)) << 4));
        const float hi = tf32_round(v);
        // k8 step chunk / 2; within it word r8 + 2 * (chunk % 2)
        const int i = 8 * (chunk / 2) + r8 + 2 * (chunk % 2);
        a[i] = __float_as_uint(hi);
        a[i + 4] = __float_as_uint(tf32_round(v - hi));
      }
    }
    const uint32_t base = smem_addr(slot);
    const uint64_t db_hi = wgmma::descriptor<ROW_BYTES>(base + L::B_OFFSET);
    const uint64_t db_lo = wgmma::descriptor<ROW_BYTES>(base + L::B_OFFSET + L::B_BYTES);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
      const uint64_t k = kk * wgmma::DESC_K_STEP;
      const uint32_t a_hi[4] = {a[8 * kk], a[8 * kk + 1], a[8 * kk + 2], a[8 * kk + 3]};
      const uint32_t a_lo[4] = {a[8 * kk + 4], a[8 * kk + 5], a[8 * kk + 6], a[8 * kk + 7]};
      wgmma::MmaTf32<N>::run(acc, a_lo, db_hi + k, kk > 0);  // a slot starts from zero
      wgmma::MmaTf32<N>::run(acc, a_hi, db_lo + k, 1);
      wgmma::MmaTf32<N>::run(acc, a_hi, db_hi + k, 1);
    }
  }
  template <int N>
  static __device__ __forceinline__ void start_item(Regs<N>& regs) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) regs.d[i] = 0.f;
  }
  // the wgmma group that wrote t[BUF] has been waited for
  template <int N, int BUF>
  static __device__ __forceinline__ void retire(Regs<N>& regs) {
    wgmma::fence_operand(regs.a[BUF]);  // until here the MMAs were reading them
    wgmma::fence_operand(regs.t[BUF]);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) regs.d[i] += regs.t[BUF][i];
  }
};

}  // namespace

// x [B, H, W, Cin] f32; wt_hi, wt_lo the two TF32 parts of the K-major weights
// [s*s*C, 9*Cin] f32; b f32 [s*s*C]; z == nullptr: decode.  Returns the
// cudaError_t.
int launch_stage_wgmma_tf32(const void* x, const void* wt_hi, const void* wt_lo, const float* b,
                            const float* head_w, const float* head_b, void* out, void* z, int B,
                            int H, int W, int Cin, int C, int s, int act, int c_final,
                            int sigmoid_squash, cudaStream_t stream) {
  const StageIo io{b, nullptr, nullptr, head_w, head_b, out, z};
  return launch_stage<Tf32x3Policy>(x, wt_hi, wt_lo, io, B, H, W, Cin, C, s, act, c_final,
                                    sigmoid_squash, stream);
}

}  // namespace repnerv

REPNERV_PROBE_ENTRY(repnerv::Tf32x3Policy)
