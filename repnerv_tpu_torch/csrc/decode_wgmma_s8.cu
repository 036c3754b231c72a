// The int8 stage kernel on wgmma: stage_wgmma.cuh's mainloop with int8
// operands and int32 accumulators.
//   acc = conv3x3_same(x_q, w_q)                      (int8 x int8 -> int32, exact)
//   y   = act(pixel_shuffle(f32(acc) * scale + bias)) (f32)
//   out = clip(rint(y * inv_out), -127, 127)          (int8), or
//   out = squash(head_1x1(y))                         (f32 RGB, the last stage)
//
// Replaces, for stages with Cin % 16 == 0, Cin <= 128 and C % 8 == 0, C <= 96
// (blocks 3-4 of the 720p flagship's int8 decode), the TPU kernel
// repnerv_tpu/pallas_kernels/decode_int8.py::fused_conv_ps_act_int8;
// decode_int8.cu's WMMA kernel keeps the other shapes.
//
// What bounds it: operations, at the tensor cores' int8 rate (twice bf16's).
// The bf16 mainloop is held by the rate of rows that TMA brings an SM, so here
// a row is one whole pixel: a box of 128 channels over [B, H, W, Cin] in the
// 128-byte swizzle, TMA zero-filling the channels past Cin; a ring slot is one
// tap (A 16 KB, B 24 KB at N = 192; five slots), nine slots a work item, and
// ceil(Cin / 32) m64n(2*BN)k32 wgmma a slot and warpgroup (the products that
// would read only zeros are skipped): three times fewer rows per
// multiply-add than the bf16 kernel.  B is a K-major copy of the packed
// weights that kernels/decode_int8.py::pack_int8_stage makes once.
// What holds it on an H100 is still the loads: at block 4 + head and 8 frames
// they take 1.85 ms alone, the products 0.76 ms, the whole kernel 1.9 ms (the
// epilogue hides behind the loads).  A form that kept one sub-pixel group's
// whole B (162 KB) in shared memory and streamed A alone halved the mainloop
// (0.96 ms), but with three slots left for A the epilogue no longer hid and
// the kernel took as long; so did that form with the two consumer warpgroups
// taking 64-pixel items in turn.  Neither is kept.
//
// The epilogue keeps the JAX kernel's rounding points: f32(acc) is exact
// (|acc| < 2^24 for Cin <= 113; rounded to nearest above), __fmul_rn by
// scale[col] and __fadd_rn of the bias (never contracted), the activation of
// activations.cuh (swish through the fast exponential and division, see
// below), then rintf(__fmul_rn(y, inv_out)) clamped to +-127, or the f32 head
// and squash.  scale sits beside the bias in shared memory.  int8
// stores: the four lanes of a row exchange their channel pairs with two
// shuffles per 32 channels, so a lane stores 8 contiguous bytes.

#include "stage_wgmma.cuh"

namespace repnerv {
namespace {

struct S8Policy {
  using Acc = int;
  using Out = signed char;
  using ZPair = int;  // unused: no training forward in int8, and its stores are 8-byte words
  static constexpr int ELEM_BYTES = 1, ROW_BYTES = 128, BK = ROW_BYTES / ELEM_BYTES;
  static constexpr int STAGES = 5, A_COPIES = 1, B_PARTS = 1, NSUB = 2;
  template <int N>
  using Regs = Accumulators<int, N / 2>;
  static constexpr int MIN_CIN_STEP = 16, MAX_CIN = BK;
  // swish through __expf and __fdividef: with expf and a division the epilogue
  // of block 4 + head took 1.1 ms longer (3.04 against 1.87 ms at 8 frames),
  // more than the whole mainloop; 2^-21 relative moves a requantized count
  // only next to a .5 boundary
#ifdef REPNERV_PROBE_EXACT_ACT
  static constexpr bool FAST_SWISH = false;
#else
  static constexpr bool FAST_SWISH = true;
#endif
  static constexpr bool DEQUANT = true, INT8_OUT = true, HAS_Z = false, PACK_Z = false,
                        HAS_HEAD = true;
  static constexpr CUtensorMapDataType DATA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_128B;

  template <int N, typename L, int BUF>
  static __device__ __forceinline__ void products(Regs<N>& regs, unsigned char* slot, int wg,
                                                  int /*t*/, bool first, int k32s) {
    int(&acc)[N / 2] = regs.d;
    const uint32_t base = smem_addr(slot);
    const uint64_t da = wgmma::descriptor<ROW_BYTES>(base + wg * (64 * ROW_BYTES));
    const uint64_t db = wgmma::descriptor<ROW_BYTES>(base + L::B_OFFSET);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
      const uint64_t k = kk * wgmma::DESC_K_STEP;
      if (kk < k32s) wgmma::MmaS8<N>::run(acc, da + k, db + k, kk > 0 || !first);
    }
  }
  template <int N, int BUF>
  static __device__ __forceinline__ void retire(Regs<N>&) {}
  template <int N>
  static __device__ __forceinline__ void start_item(Regs<N>&) {}
  static __device__ __forceinline__ uint32_t quant_byte(float y, float inv_out) {
    return requant_byte(y, inv_out);
  }
};

}  // namespace

// x_q [B, H, W, Cin] int8; wt the K-major weights [s*s*C, 9*Cin] int8; scale,
// bias f32 [s*s*C]; c_final = 0: requantize with *inv_out, else the head.
// Returns the cudaError_t.
int launch_stage_wgmma_s8(const void* x, const void* wt, const float* scale, const float* bias,
                          const float* inv_out, const float* head_w, const float* head_b,
                          void* out, int B, int H, int W, int Cin, int C, int s, int act,
                          int c_final, int sigmoid_squash, cudaStream_t stream) {
  const StageIo io{bias, scale, inv_out, head_w, head_b, out, nullptr};
  return launch_stage<S8Policy>(x, wt, nullptr, io, B, H, W, Cin, C, s, act, c_final,
                                sigmoid_squash, stream);
}

}  // namespace repnerv

REPNERV_PROBE_ENTRY(repnerv::S8Policy)
