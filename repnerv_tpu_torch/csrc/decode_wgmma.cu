// The bf16 stage kernel: stage_wgmma.cuh's mainloop with bf16 operands.
//
// Replaces, for bf16 stages whose Cin and C are multiples of 8 (blocks 2-4 of
// the 720p flagship), the TPU kernels
// repnerv_tpu/pallas_kernels/decode.py::fused_conv_ps_act and
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_fwd_kernel_call; decode.cu
// keeps the other bf16 shapes.  Same layouts, same cast points as there: bf16
// operands, f32 accumulation, f32 bias + activation + head + squash.
//
// A ring slot holds 32 input channels of one tap: rows of 64 bytes in the
// 64-byte swizzle, two m64n(2*BN)k16 wgmma a slot and warpgroup.  Six slots:
// 6 and 10 timed alike at the flagship shapes (the loads wait for L2, not for
// a free slot).  Swish takes the fast exponential and division, far inside the
// bf16 output's rounding and the head's 1e-4.  Stores are bf16 pairs.
//
// Where the next block is served in int8, the stage without a head can write
// that block's input itself (Bf16QuantOutPolicy, chosen by a non-null sx): the
// int8 words of the int8 stage's lane exchange, each byte the one the plain
// pass (kernels/decode_int8.py::quantize_act_int8) makes from the bf16
// output, so the bf16 map is never written and read back.

#include <cuda_bf16.h>

#include "stage_wgmma.cuh"

namespace repnerv {
namespace {

struct Bf16Policy {
  using Acc = float;
  using Out = __nv_bfloat16;
  using ZPair = __nv_bfloat162;
  static constexpr int ELEM_BYTES = 2, ROW_BYTES = 64, BK = ROW_BYTES / ELEM_BYTES;
  static constexpr int STAGES = 6, A_COPIES = 1, B_PARTS = 1;
  // two sub-pixels a work item (N = 192 at C = 96) halve the A traffic of one
  // and timed faster at every flagship shape but one
  static constexpr int NSUB = 2;
  static constexpr int MIN_CIN_STEP = 8, MAX_CIN = 0;
  template <int N>
  using Regs = Accumulators<float, N / 2>;
  static constexpr bool FAST_SWISH = true, DEQUANT = false, INT8_OUT = false, HAS_Z = true,
                        PACK_Z = true, HAS_HEAD = true;
  static constexpr CUtensorMapDataType DATA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr CUtensorMapSwizzle SWIZZLE = CU_TENSOR_MAP_SWIZZLE_64B;

  static __device__ __forceinline__ ZPair pack_pair(float a, float b) {
    return __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void store_pair(Out* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }

  template <int N, typename L, int BUF>
  static __device__ __forceinline__ void products(Regs<N>& regs, unsigned char* slot, int wg,
                                                  int /*t*/, bool first, int /*k32s*/) {
    float(&acc)[N / 2] = regs.d;
    const uint32_t base = smem_addr(slot);
    const uint64_t da = wgmma::descriptor<ROW_BYTES>(base + wg * (64 * ROW_BYTES));
    const uint64_t db = wgmma::descriptor<ROW_BYTES>(base + L::B_OFFSET);
    wgmma::fence();
    wgmma::MmaBf16<N>::run(acc, da, db, !first);
    wgmma::MmaBf16<N>::run(acc, da + wgmma::DESC_K_STEP, db + wgmma::DESC_K_STEP, 1);
  }
  template <int N, int BUF>
  static __device__ __forceinline__ void retire(Regs<N>&) {}
  template <int N>
  static __device__ __forceinline__ void start_item(Regs<N>&) {}
};

// The bf16 stage whose output is the next int8 block's input: no head, no z.
// A value's byte is the plain pass's: y rounded to bf16 as store_pair rounds
// it, widened, divided by sx with IEEE rounding (as torch divides by a scale
// tensor on the card), rounded half to even, clamped to +-127.
struct Bf16QuantOutPolicy : Bf16Policy {
  static constexpr bool INT8_OUT = true, HAS_Z = false, HAS_HEAD = false;

  static __device__ __forceinline__ uint32_t quant_byte(float y, float sx) {
    const float v = __bfloat162float(__float2bfloat16_rn(y));
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v, sx)), -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
  }
};

}  // namespace

// x [B, H, W, Cin] bf16; wt the K-major weights [s*s*C, 9*Cin] bf16; b f32
// [s*s*C]; z == nullptr: decode.  sx (device, one f32) != nullptr: out is int8,
// quantised with it (no head, no z).  Returns the cudaError_t.
int launch_stage_wgmma(const void* x, const void* wt, const float* b, const float* head_w,
                       const float* head_b, void* out, void* z, const float* sx, int B, int H,
                       int W, int Cin, int C, int s, int act, int c_final, int sigmoid_squash,
                       cudaStream_t stream) {
  const StageIo io{b, nullptr, sx, head_w, head_b, out, z};
  if (sx != nullptr)
    return launch_stage<Bf16QuantOutPolicy>(x, wt, nullptr, io, B, H, W, Cin, C, s, act, c_final,
                                            sigmoid_squash, stream);
  return launch_stage<Bf16Policy>(x, wt, nullptr, io, B, H, W, Cin, C, s, act, c_final,
                                  sigmoid_squash, stream);
}

}  // namespace repnerv

REPNERV_PROBE_ENTRY(repnerv::Bf16Policy)
