// The bf16 stage kernel designed for Hopper (sm_90a): wgmma fed by TMA.
//   out = act(pixel_shuffle(conv3x3_same(x) + b))                    (no head), or
//   out = squash(head_1x1(act(pixel_shuffle(conv3x3_same(x) + b))))  (head),
// and, for the training forward, also z = pixel_shuffle(conv3x3_same(x) + b).
//
// Replaces, for bf16 stages whose Cin and C are multiples of 8 (blocks 2-4 of
// the 720p flagship), the TPU kernels
// repnerv_tpu/pallas_kernels/decode.py::fused_conv_ps_act and
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_fwd_kernel_call; decode.cu
// keeps the other shapes and f32.  Same layouts, same cast points as there:
// bf16 operands, f32 accumulation, f32 bias + activation + head + squash.
//
// What bounds it: operations.  At the flagship's block 4 the conv does ~2,800
// FLOP per byte of device memory, so the tensor cores are the limit and only
// wgmma reaches their rate.  What the design does about it:
//   * The conv is an implicit GEMM, M = pixels, N = s*s*C, K = 9*Cin.  A work
//     item is a rectangle of 128 low-res pixels (TH x TW, chosen per launch)
//     times two sub-pixels (N = 2 * BN), so each A tile feeds twice the math it
//     would with one sub-pixel per item.
//   * One producer thread starts the TMA loads: for each tap (dy, dx) and each
//     32-channel slice, the A tile is one 4-D box of x at shifted coordinates.
//     TMA fills what lies outside the image with zeros, negative coordinates
//     included, so the SAME halo costs no instruction and no padded copy.  The
//     B tile is a box of the K-major weights [s*s, C, 9, Cin]; rows past C or
//     past the last sub-pixel, and channels past Cin, arrive as zeros too.
//   * Both land in the 64-byte swizzle that the wgmma descriptors name, in a
//     ring of STAGES slots with a full and an empty mbarrier each: no block
//     barrier in the loop.  Two consumer warpgroups (64 pixels each) run
//     m64n(2*BN)k16 wgmma, two per slot, and keep one group in flight while
//     they release the slot before it; setmaxnreg hands them the registers
//     that the producer's warpgroup does not need.
//   * The grid is persistent: one block per SM walks the work items, and the
//     ring runs on across them, so while the consumers are in one item's
//     epilogue the producer already fills the slots with the next item's tiles.
//   * The epilogue runs from the wgmma register layout, in three passes over
//     the accumulators: bias, the activation (chosen once per work item, its
//     formula compiled into a straight run over the registers), then the
//     shuffled store as bf16 pairs or the head, whose C -> c_final product is
//     reduced over the four lanes that share a row with two shuffles.  No trip
//     through shared memory.
// Edge tiles compute on zeros and mask at the store.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "activations.cuh"
#include "stage_common.cuh"
#include "wgmma_sm90.cuh"

namespace repnerv {
namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;      // low-res pixels per work item: two warpgroups x 64 rows
constexpr int BK = 32;       // input channels per ring slot: 64 bytes, the swizzle's row
// Ring slots.  6 and 10 timed alike at the flagship shapes (the loads wait for
// L2, not for a free slot); 6 leaves shared memory over.
#ifdef REPNERV_PROBE_STAGES
constexpr int STAGES = REPNERV_PROBE_STAGES;
#else
constexpr int STAGES = 6;
#endif
constexpr int MAX_SUBS = 26; // sub-pixels (padded to whole groups) whose bias a block keeps: s <= 5
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer's warpgroup (one thread of it works)
// registers a thread after the roles part (setmaxnreg moves them between whole
// warpgroups): 2 * 128 * 232 + 128 * 40 = 64,512 of the SM's 65,536
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int A_BYTES = BM * BK * 2;
constexpr int MAX_HEAD = 4;  // head outputs kept in registers
// Sub-pixels a work item holds: 2 (N = 192 at C = 96) halves the A traffic of 1
// and timed faster at every flagship shape but one.
#ifdef REPNERV_PROBE_NSUB
constexpr int NSUB_OF_BLOCK = REPNERV_PROBE_NSUB;
#else
constexpr int NSUB_OF_BLOCK = 2;
#endif
// The REPNERV_PROBE_* macros exist for kernels/probe_wgmma.py, which times the
// kernel with a part taken out (no loads, no products, no epilogue) or a design
// choice changed; a build without them is the kernel the port runs.

constexpr int ACT_SWISH = 6;  // activations.cuh's code of the paper recipe's activation

// The problem and the block's place in it.
struct TileStage {
  int B, H, W, Cin, C, s, act, c_final, sigmoid_squash;
  int tw_log2;           // a tile is (BM >> tw_log2) rows x (1 << tw_log2) columns
  int tiles_h, tiles_w;  // tiles per image
  int n_groups;          // groups of NSUB sub-pixels: ceil(s*s / NSUB)
};

template <int BN, int NSUB>
struct Layout {
  static constexpr int B_BYTES = NSUB * BN * BK * 2;
  static constexpr int SLOT_BYTES = A_BYTES + B_BYTES;  // a multiple of 512
  static constexpr int BARRIERS = STAGES * SLOT_BYTES;  // full[STAGES], empty[STAGES]
  static constexpr int BIAS = BARRIERS + 2 * STAGES * 8;  // f32 [MAX_SUBS][BN]
  static constexpr int HEAD_W = BIAS + MAX_SUBS * BN * 4;  // f32 [BN][MAX_HEAD]
  static constexpr int HEAD_B = HEAD_W + BN * MAX_HEAD * 4;
  static constexpr int BYTES = HEAD_B + MAX_HEAD * 4 + 1024;  // + room to align the ring
  static_assert(SLOT_BYTES % 512 == 0, "every tile must start on the swizzle's period");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one 4-D box, global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The activation of 96 accumulators a thread is what the epilogue spends its
// time on, so the stage's activation is chosen once per work item, not once
// per value: one switch, each case a straight run over the registers with its
// activation compiled in.  (A switch inside the unrolled loop, inlined 96
// times, made the whole kernel 2.3x to 4x slower.)  Swish, the paper recipe's,
// takes the fast exponential and division: 2 MUFU operations a value, ~2^-21
// relative, far inside the bf16 output's rounding and the head's 1e-4.
template <int ACT, int R>
__device__ __forceinline__ void activate_as(float (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    v[i] = ACT == ACT_SWISH ? __fdividef(v[i], 1.f + __expf(-v[i])) : apply_act(v[i], ACT);
}
template <int R>
__device__ __forceinline__ void activate_in_place(float (&v)[R], int act) {
  switch (act) {
    case 0: activate_as<0>(v); break;
    case 1: activate_as<1>(v); break;
    case 2: activate_as<2>(v); break;
    case 3: activate_as<3>(v); break;
    case 4: activate_as<4>(v); break;
    case 5: activate_as<5>(v); break;
    case 6: activate_as<6>(v); break;
    case 7: activate_as<7>(v); break;
    case 8: activate_as<8>(v); break;
  }
}

// Which low-res pixels and sub-pixels a work item covers.
struct Work {
  int b, h0, w0, sub0;
};
__device__ __forceinline__ Work work_item(const TileStage& st, int item, int nsub) {
  // item -> (tile, group of sub-pixels); the groups of one tile are
  // neighbours in the order, so blocks that run side by side share its A boxes in L2
  Work wk;
  wk.sub0 = nsub * (item % st.n_groups);
  int tile = item / st.n_groups;
  wk.w0 = (tile % st.tiles_w) << st.tw_log2;
  tile /= st.tiles_w;
  wk.h0 = (tile % st.tiles_h) * (BM >> st.tw_log2);
  wk.b = tile / st.tiles_h;
  return wk;
}

// BN: channels of one sub-pixel a block holds (C <= BN); NSUB: sub-pixels a
// work item holds (the wgmma width is NSUB * BN); HEAD: fused 1x1 head +
// squash with f32 output, else the shuffled bf16 output; WITH_Z: the training
// forward, which also stores the pre-activation z.
// One block per SM walks the work items blockIdx.x, + gridDim.x, ...: while
// the consumers run an item's epilogue the producer is already filling the
// ring with the next item's tiles.
template <int BN, int NSUB, bool HEAD, bool WITH_Z>
__global__ void __launch_bounds__(THREADS, 1)
stage_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ bias, const float* __restrict__ head_w,
            const float* __restrict__ head_b, void* __restrict__ out_, bf16* __restrict__ z,
            const TileStage st) {
  using L = Layout<BN, NSUB>;
  constexpr int N = NSUB * BN;  // wgmma width
  constexpr int ACC = N / 2;    // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  // the ring must start on the swizzle's period (512 bytes; 1024 to be safe)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + L::BARRIERS, empty = full + STAGES * 8;
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);  // [n_groups * NSUB][BN]
  float4* head_w_s = reinterpret_cast<float4*>(smem + L::HEAD_W);
  float* head_b_s = reinterpret_cast<float*>(smem + L::HEAD_B);

  const int tid = threadIdx.x;
  const int n_sub = st.s * st.s;
  const int k_chunks = (st.Cin + BK - 1) / BK;
  const int n_steps = 9 * k_chunks;
  const int n_items = st.B * st.tiles_h * st.tiles_w * st.n_groups;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);                       // the producer's expect_tx arrive
      mbar_init(empty + 8 * i, CONSUMER_THREADS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < st.n_groups * N; i += THREADS) {
    const int sub = i / BN, c = i % BN;
    bias_s[i] = (sub < n_sub && c < st.C) ? bias[sub * st.C + c] : 0.f;
  }
  if (HEAD) {
    for (int i = tid; i < BN * MAX_HEAD; i += THREADS) {
      const int c = i / MAX_HEAD, k = i % MAX_HEAD;
      reinterpret_cast<float*>(head_w_s)[i] =
          (c < st.C && k < st.c_final) ? head_w[c * st.c_final + k] : 0.f;
    }
    if (tid < MAX_HEAD) head_b_s[tid] = tid < st.c_final ? head_b[tid] : 0.f;
  }
  __syncthreads();  // the only block barrier: the roles part here

  if (tid >= CONSUMER_THREADS) {
    // ---- producer: one thread keeps the ring full, across work items ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid != CONSUMER_THREADS) return;
    int slot = 0;
    uint32_t parity = 1;  // a fresh barrier reads as "phase 1 complete": the first lap does not wait
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const Work wk = work_item(st, item, NSUB);
      for (int step = 0; step < n_steps; ++step) {
        const int tap = step / k_chunks, ci0 = (step % k_chunks) * BK;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        mbar_wait(empty + 8 * slot, parity);
        const uint32_t dst = ring + slot * L::SLOT_BYTES, bar = full + 8 * slot;
#ifdef REPNERV_PROBE_NO_LOADS
        mbar_arrive(bar);
#else
        mbar_arrive_expect_tx(bar, L::SLOT_BYTES);  // a box counts in full, zeros included
        tma_load_4d(dst, &map_x, bar, ci0, wk.w0 + dx, wk.h0 + dy, wk.b);
        tma_load_4d(dst + A_BYTES, &map_w, bar, ci0, tap, 0, wk.sub0);
#endif
        if (++slot == STAGES) {
          slot = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 pixels x N channels each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int q = lane % 4;
  const int tw_mask = (1 << st.tw_log2) - 1;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  int slot = 0;
  uint32_t parity = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Work wk = work_item(st, item, NSUB);
    int prev = 0;
    for (int step = 0; step < n_steps; ++step) {
      mbar_wait(full + 8 * slot, parity);
      const uint32_t tile_a = ring + slot * L::SLOT_BYTES + wg * (64 * BK * 2);
      const uint64_t da = wgmma::descriptor_sw64(tile_a);
      const uint64_t db = wgmma::descriptor_sw64(ring + slot * L::SLOT_BYTES + A_BYTES);
      wgmma::fence();
#ifndef REPNERV_PROBE_NO_PRODUCTS
      wgmma::Mma<N>::run(acc, da, db, step > 0);  // an item's first product overwrites
      wgmma::Mma<N>::run(acc, da + wgmma::DESC_K16_STEP, db + wgmma::DESC_K16_STEP, 1);
#endif
      wgmma::commit();
      if (step > 0) {
        wgmma::wait<1>();  // the slot before this one has been read
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = slot;
      if (++slot == STAGES) {
        slot = 0;
        parity ^= 1;
      }
    }
    wgmma::wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * prev);  // the producer runs on into the next item
    wgmma::fence_operand(acc);

#ifdef REPNERV_PROBE_NO_EPILOGUE
    {  // keep the accumulators alive, store nothing
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < ACC; ++i) sum += acc[i];
      if (sum == 12345.678f) static_cast<float*>(out_)[0] = sum;
      continue;
    }
#endif
    // ---- epilogue, from the accumulators' own layout, in three passes over
    // the registers: bias (z's pairs are packed here and stored in the third
    // pass, so that its stores mix with that pass's arithmetic), the
    // activation in place, then the store or the head ----
    __nv_bfloat162 zp[WITH_Z ? ACC / 2 : 1];
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const float* bias_sub = bias_s + (wk.sub0 + sub) * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float b0 = bias_sub[8 * j + 2 * q], b1 = bias_sub[8 * j + 2 * q + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 4 * (sub * (BN / 8) + j) + 2 * half;
          acc[r] += b0;
          acc[r + 1] += b1;
          if constexpr (WITH_Z) zp[r / 2] = __floats2bfloat162_rn(acc[r], acc[r + 1]);
        }
      }
    }
    activate_in_place(acc, st.act);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wg * 64 + warp * 16 + lane / 4 + 8 * half;
      const int h = wk.h0 + (m >> st.tw_log2), w = wk.w0 + (m & tw_mask);
      const bool row_ok = h < st.H && w < st.W;
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        const int sp = wk.sub0 + sub;
        const bool ok = row_ok && sp < n_sub;
        const long long pix =
            ((long long)wk.b * st.H * st.s + (long long)h * st.s + sp / st.s) *
                ((long long)st.W * st.s) +
            (long long)w * st.s + sp % st.s;
        float hacc[MAX_HEAD] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          const int r = 4 * (sub * (BN / 8) + j) + 2 * half;
          const bool store = ok && c < st.C;
          if constexpr (WITH_Z) {
            if (store) *reinterpret_cast<__nv_bfloat162*>(z + pix * st.C + c) = zp[r / 2];
          }
          if (HEAD) {  // head weights past C are zeros
            const float4 w0v = head_w_s[c], w1v = head_w_s[c + 1];
            hacc[0] = fmaf(acc[r], w0v.x, fmaf(acc[r + 1], w1v.x, hacc[0]));
            hacc[1] = fmaf(acc[r], w0v.y, fmaf(acc[r + 1], w1v.y, hacc[1]));
            hacc[2] = fmaf(acc[r], w0v.z, fmaf(acc[r + 1], w1v.z, hacc[2]));
            hacc[3] = fmaf(acc[r], w0v.w, fmaf(acc[r + 1], w1v.w, hacc[3]));
          } else if (store) {
            store_pair(static_cast<bf16*>(out_) + pix * st.C + c, acc[r], acc[r + 1]);
          }
        }
        if (HEAD) {
          // the four lanes of a row hold a quarter of its channels each
#pragma unroll
          for (int k = 0; k < MAX_HEAD; ++k) {
            hacc[k] += __shfl_xor_sync(0xffffffffu, hacc[k], 1);
            hacc[k] += __shfl_xor_sync(0xffffffffu, hacc[k], 2);
          }
          const float y = q == 0 ? hacc[0] : q == 1 ? hacc[1] : q == 2 ? hacc[2] : hacc[3];
          if (ok && q < st.c_final)
            static_cast<float*>(out_)[pix * st.c_final + q] =
                squash(y + head_b_s[q], st.sigmoid_squash);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled out of libcuda, which the runtime has loaded already,
// so the library links against nothing new.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault);
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 tensor of 4 dimensions (innermost first), boxes in the 64-byte
// swizzle, zeros outside.
bool encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                const cuuint32_t (&box)[4], CUtensorMapL2promotion promote) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                promote, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  CUtensorMap map_x, map_w;
  const float *b, *hw, *hb;
  void *out, *z;
  TileStage st;
  unsigned blocks, sms;  // work items; blocks the card runs at once (one per SM)
  cudaStream_t stream;
};

template <int BN, int NSUB, bool HEAD, bool WITH_Z>
cudaError_t launch(const Launch& l) {
  auto* fn = stage_wgmma<BN, NSUB, HEAD, WITH_Z>;
  constexpr int bytes = Layout<BN, NSUB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
#ifdef REPNERV_PROBE_ONE_ITEM_PER_BLOCK
  const unsigned grid = l.blocks;
#else
  const unsigned grid = l.blocks < l.sms ? l.blocks : l.sms;
#endif
  fn<<<grid, THREADS, bytes, l.stream>>>(l.map_x, l.map_w, l.b, l.hw, l.hb, l.out,
                                             static_cast<bf16*>(l.z), l.st);
  return cudaGetLastError();
}

template <int BN, int NSUB>
cudaError_t launch_for(const Launch& l) {
  if (l.z != nullptr)
    return l.st.c_final > 0 ? launch<BN, NSUB, true, true>(l) : launch<BN, NSUB, false, true>(l);
  return l.st.c_final > 0 ? launch<BN, NSUB, true, false>(l) : launch<BN, NSUB, false, false>(l);
}

}  // namespace

static unsigned sm_count() {
  static const unsigned n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}

// The tile of BM pixels that wastes the fewest on this image; the squarer one
// (fewer halo pixels fetched) on a tie.
static int choose_tile_width_log2(int H, int W) {
  int best = 4;
  long long best_area = -1;
  for (int l : {4, 5, 3, 6, 7}) {
    const int tw = 1 << l, th = BM >> l;
    const long long area =
        (long long)((H + th - 1) / th * th) * (long long)((W + tw - 1) / tw * tw);
    if (best_area < 0 || area < best_area) best = l, best_area = area;
  }
  return best;
}

// x [B, H, W, Cin] bf16; wt the K-major weights [s*s*C, 9*Cin] bf16 (row
// (i*s + j)*C + c, column (dy, dx, ci)); b f32 [s*s*C]; z == nullptr: decode.
// Takes Cin % 8 == 0 (TMA wants 16-byte strides), C % 8 == 0, C <= 96,
// c_final <= 4; anything else is cudaErrorInvalidValue.
int launch_stage_wgmma(const void* x, const void* wt, const float* b, const float* head_w,
                       const float* head_b, void* out, void* z, int B, int H, int W, int Cin,
                       int C, int s, int act, int c_final, int sigmoid_squash,
                       cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (Cin % 8 != 0 || C % 8 != 0 || C > 96 || c_final > MAX_HEAD || misaligned(x) ||
      misaligned(wt) || wt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{};
  l.b = b, l.hw = head_w, l.hb = head_b, l.out = out, l.z = z, l.stream = stream;
  TileStage& st = l.st;
  st = TileStage{B, H, W, Cin, C, s, act, c_final, sigmoid_squash, 0, 0, 0, 0};
  st.tw_log2 = choose_tile_width_log2(H, W);
  const int tw = 1 << st.tw_log2, th = BM >> st.tw_log2;
  st.tiles_h = (H + th - 1) / th;
  st.tiles_w = (W + tw - 1) / tw;
  st.n_groups = (s * s + NSUB_OF_BLOCK - 1) / NSUB_OF_BLOCK;
  const long long blocks = (long long)B * st.tiles_h * st.tiles_w * st.n_groups;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  l.blocks = static_cast<unsigned>(blocks);
  l.sms = sm_count();
  if (l.sms == 0 || s > 5) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = C <= 32 ? 32 : C <= 64 ? 64 : 96;

  const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t x_box[4] = {BK, (cuuint32_t)tw, (cuuint32_t)th, 1};
  const cuuint64_t w_dims[4] = {(cuuint64_t)Cin, 9, (cuuint64_t)C, (cuuint64_t)(s * s)};
  const cuuint32_t w_box[4] = {BK, 1, (cuuint32_t)bn, NSUB_OF_BLOCK};
  if (!encode_map(&l.map_x, x, x_dims, x_box, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(&l.map_w, wt, w_dims, w_box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return static_cast<int>(cudaErrorInvalidValue);

  const cudaError_t err = bn == 32   ? launch_for<32, NSUB_OF_BLOCK>(l)
                          : bn == 64 ? launch_for<64, NSUB_OF_BLOCK>(l)
                                     : launch_for<96, NSUB_OF_BLOCK>(l);
  return static_cast<int>(err);
}

}  // namespace repnerv

#ifdef REPNERV_PROBE
// C entry for kernels/probe_wgmma.py, which builds this file alone.
extern "C" int repnerv_probe_stage_wgmma(const void* x, const void* wt, const float* b,
                                         const float* head_w, const float* head_b, void* out,
                                         void* z, int B, int H, int W, int Cin, int C, int s,
                                         int act, int c_final, int sigmoid_squash, void* stream) {
  return repnerv::launch_stage_wgmma(x, wt, b, head_w, head_b, out, z, B, H, W, Cin, C, s, act,
                                     c_final, sigmoid_squash, static_cast<cudaStream_t>(stream));
}
#endif
