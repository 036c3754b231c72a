// The stage kernel designed for Hopper (sm_90a): wgmma fed by TMA, one
// mainloop for three operand types.
//   out = act(pixel_shuffle(conv3x3_same(x) + b))                    (no head), or
//   out = squash(head_1x1(act(pixel_shuffle(conv3x3_same(x) + b))))  (head),
// and, for the training forward, also z = pixel_shuffle(conv3x3_same(x) + b).
//
// decode_wgmma.cu (bf16), decode_wgmma_tf32.cu (f32 as three TF32 products)
// and decode_wgmma_s8.cu (int8) each give this file an operand policy (below)
// and are compiled on their own, so the three build side by side.
//
// What bounds the stage: operations.  At the flagship's block 4 the conv does
// ~2,800 operations per byte of device memory, so the tensor cores are the
// limit and only wgmma reaches their rate.  What the design does about it:
//   * The conv is an implicit GEMM, M = pixels, N = s*s*C, K = 9*Cin.  A work
//     item is a rectangle of 128 low-res pixels (TH x TW, chosen per launch)
//     times NSUB sub-pixels (N = NSUB * BN); with two, each A tile feeds twice
//     the math it would with one.
//   * One producer thread starts the TMA loads: for each tap (dy, dx) and each
//     slice of BK input channels, the A tile is one 4-D box of x at shifted
//     coordinates.  TMA fills what lies outside the image with zeros, negative
//     coordinates included, so the SAME halo costs no instruction and no padded
//     copy.  The B tile is a box of the K-major weights [s*s, C, 9, Cin]; rows
//     past C or past the last sub-pixel, and channels past Cin, arrive as zeros.
//   * Both land in the swizzle that the wgmma descriptors name (rows of 64 or
//     128 bytes), in a ring of STAGES slots with a full and an empty mbarrier
//     each: no block barrier in the loop.  Two consumer warpgroups (64 pixels
//     each) run the policy's wgmma on a slot and keep one group in flight while
//     they release the slot before it; setmaxnreg hands them the registers
//     that the producer's warpgroup does not need.
//   * The grid is persistent: one block per SM walks the work items, and the
//     ring runs on across them, so while the consumers are in one item's
//     epilogue the producer already fills the slots with the next item's tiles.
//   * The epilogue runs from the wgmma register layout, in three passes over
//     the accumulators: dequantization (int8) and bias, the activation (chosen
//     once per work item, its formula compiled into a straight run over the
//     registers), then the shuffled store (of Out, or of int8 words) or the
//     head, whose C -> c_final product is reduced over the four lanes that
//     share a row with two shuffles.  No trip through shared memory.
// Edge tiles compute on zeros and mask at the store.
//
// An operand policy P says:
//   Acc          float or int: the accumulator registers
//   Out          the element of z and, unless INT8_OUT, of the no-head output
//   ELEM_BYTES   of x and the weights
//   ROW_BYTES    bytes of K per pixel in a ring slot, the swizzle's row (64 or
//                128); BK = ROW_BYTES / ELEM_BYTES input channels a slot
//   STAGES       ring slots
//   NSUB         sub-pixels a work item holds
//   Regs<N>      the accumulator registers of a thread: d[N / 2], which the
//                epilogue reads, and whatever else products / retire keep
//   A_COPIES     A tiles a slot has room for: TMA fills the first, the policy
//                may make the others (f32: the low parts)
//   B_PARTS      B tiles a slot holds, each loaded through its own tensor map
//   MIN_CIN_STEP, MAX_CIN  what Cin must be a multiple of (16-byte TMA strides)
//                and, if not 0, stay under (one slot a tap)
//   FAST_SWISH   swish through __expf and __fdividef (2^-21 relative) instead
//                of expf and a division
//   DEQUANT      int32 sums -> f32 * scale[col] + bias, one rounding each
//   INT8_OUT     the no-head output is int8: quant_byte(y, *io.q_out) a value,
//                stored as 8-byte words after a lane exchange
//   HAS_Z, PACK_Z  a training forward exists; z waits packed in registers for
//                the store pass (16-bit) or is stored in the first pass
//   HAS_HEAD     the fused head exists
//   DATA_TYPE, SWIZZLE  of the tensor maps
//   products<N, L, BUF>(regs, slot, wg, t, first, k32s)  everything between a
//                slot's full barrier and the commit of its wgmma group; BUF is
//                the step's parity within its work item
//   retire<N, BUF>(regs)  after the wait for the group of a step of parity BUF:
//                f32 adds that step's sums into d; the others do nothing
//   start_item<N>(regs)  before a work item's first step (f32 clears d; the
//                others' first product overwrites it)
//   quant_byte(y, q)  INT8_OUT: the int8 of the activated f32 value y, as the
//                low byte of an int (int8: requant_byte with q = 1 / out_scale)
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "activations.cuh"
#include "stage_common.cuh"
#include "wgmma_sm90.cuh"

namespace repnerv {
namespace {  // every source that includes this file holds its own copy

constexpr int BM = 128;      // low-res pixels per work item: two warpgroups x 64 rows
constexpr int MAX_SUBS = 26; // sub-pixels (padded to whole groups) whose bias a block keeps: s <= 5
constexpr int CONSUMER_THREADS = 256;
constexpr int THREADS = CONSUMER_THREADS + 128;  // + the producer's warpgroup (one thread of it works)
// registers a thread after the roles part (setmaxnreg moves them between whole
// warpgroups): 2 * 128 * 232 + 128 * 40 = 64,512 of the SM's 65,536
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr int MAX_HEAD = 4;  // head outputs kept in registers
// The REPNERV_PROBE_* macros exist for kernels/probe_wgmma.py, which times a
// kernel with a part taken out (no loads, no products, no epilogue) or a design
// choice changed; a build without them is the kernel the port runs.
constexpr int ring_slots(int stages) {
#ifdef REPNERV_PROBE_STAGES
  return REPNERV_PROBE_STAGES;
#else
  return stages;
#endif
}
constexpr int sub_pixels(int nsub) {
#ifdef REPNERV_PROBE_NSUB
  return REPNERV_PROBE_NSUB;
#else
  return nsub;
#endif
}

// The registers of a policy that sums inside the tensor cores only.
template <typename Acc, int R>
struct Accumulators {
  Acc d[R];
};

constexpr int ACT_SWISH = 6;  // activations.cuh's code of the paper recipe's activation

// The problem and the block's place in it.
struct TileStage {
  int B, H, W, Cin, C, s, act, c_final, sigmoid_squash;
  int tw_log2;           // a tile is (BM >> tw_log2) rows x (1 << tw_log2) columns
  int tiles_h, tiles_w;  // tiles per image
  int n_groups;          // groups of NSUB sub-pixels: ceil(s*s / NSUB)
};

// What the epilogue reads and writes.
struct StageIo {
  const float *bias, *scale;  // scale: DEQUANT only
  const float* q_out;         // INT8_OUT only: the scalar of P::quant_byte
  const float *head_w, *head_b;
  void *out, *z;
};

template <typename P, int BN, int NSUB>
struct Layout {
  static constexpr int STAGES = ring_slots(P::STAGES);
  static constexpr int A_TILE = BM * P::ROW_BYTES;
  static constexpr int B_BYTES = NSUB * BN * P::ROW_BYTES;
  static constexpr int B_OFFSET = P::A_COPIES * A_TILE;
  static constexpr int SLOT_BYTES = B_OFFSET + P::B_PARTS * B_BYTES;
  static constexpr int TX_BYTES = A_TILE + P::B_PARTS * B_BYTES;  // what TMA brings a slot
  static constexpr int BARRIERS = STAGES * SLOT_BYTES;    // full[STAGES], empty[STAGES]
  static constexpr int BIAS = BARRIERS + 2 * STAGES * 8;  // f32 [MAX_SUBS][BN]
  static constexpr int SCALE = BIAS + MAX_SUBS * BN * 4;  // f32 [MAX_SUBS][BN], int8 only
  static constexpr int HEAD_W = SCALE + (P::DEQUANT ? MAX_SUBS * BN * 4 : 0);  // f32 [BN][MAX_HEAD]
  static constexpr int HEAD_B = HEAD_W + BN * MAX_HEAD * 4;
  static constexpr int BYTES = HEAD_B + MAX_HEAD * 4 + 1024;  // + room to align the ring
  static_assert(A_TILE % (8 * P::ROW_BYTES) == 0 && B_BYTES % (8 * P::ROW_BYTES) == 0,
                "every tile must start on the swizzle's period");
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
// spin until the barrier's phase differs from `parity`; in the probe's
// bounded_spin variant (for trying a change to the protocol) a wait of about
// two seconds traps, so that a fault ends the kernel instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#ifdef REPNERV_PROBE_BOUNDED_SPIN
  const long long t0 = clock64();
#endif
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
#ifdef REPNERV_PROBE_BOUNDED_SPIN
    if (!done && clock64() - t0 > 4000000000LL) __trap();
#endif
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

// The accumulators are f32 or, for int8, int32 registers that the epilogue's
// first pass turns into f32 in place (a second array of 96 would spill).
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int v) { return __int_as_float(v); }
__device__ __forceinline__ void set_f32(float& d, float v) { d = v; }
__device__ __forceinline__ void set_f32(int& d, float v) { d = __float_as_int(v); }

// The activation of 96 accumulators a thread is what the epilogue spends its
// time on, so the stage's activation is chosen once per work item, not once
// per value: one switch, each case a straight run over the registers with its
// activation compiled in.  (A switch inside the unrolled loop, inlined 96
// times, made the whole bf16 kernel 2.3x to 4x slower.)  Where the policy
// says so, swish, the paper recipe's, takes the fast exponential and division:
// 2 MUFU operations a value, ~2^-21 relative.
template <bool FAST_SWISH, int ACT, typename Acc, int R>
__device__ __forceinline__ void activate_as(Acc (&v)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float a = as_f32(v[i]);
    set_f32(v[i], (FAST_SWISH && ACT == ACT_SWISH) ? __fdividef(a, 1.f + __expf(-a))
                                                   : apply_act(a, ACT));
  }
}
template <bool FAST_SWISH, typename Acc, int R>
__device__ __forceinline__ void activate_in_place(Acc (&v)[R], int act) {
  switch (act) {
    case 0: activate_as<FAST_SWISH, 0>(v); break;
    case 1: activate_as<FAST_SWISH, 1>(v); break;
    case 2: activate_as<FAST_SWISH, 2>(v); break;
    case 3: activate_as<FAST_SWISH, 3>(v); break;
    case 4: activate_as<FAST_SWISH, 4>(v); break;
    case 5: activate_as<FAST_SWISH, 5>(v); break;
    case 6: activate_as<FAST_SWISH, 6>(v); break;
    case 7: activate_as<FAST_SWISH, 7>(v); break;
    case 8: activate_as<FAST_SWISH, 8>(v); break;
  }
}

// clip(rint(y * inv_out), -127, 127) as the low byte of an int: the JAX
// kernel's requantization, one rounding per operation
__device__ __forceinline__ uint32_t requant_byte(float y, float inv_out) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv_out)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xffu;
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

// The tensor maps of a launch: x, the weights and, where a slot holds two B
// tiles, the second one's.
template <int B_PARTS>
struct TensorMaps {
  CUtensorMap x, w, w2;
};
template <>
struct TensorMaps<1> {
  CUtensorMap x, w;
};

// P: the operand policy; BN: channels of one sub-pixel a block holds (C <=
// BN); NSUB: sub-pixels a work item holds (the wgmma width is NSUB * BN);
// HEAD: fused 1x1 head + squash with f32 output, else the shuffled output in
// P::Out; WITH_Z: the training forward, which also stores the pre-activation z.
// One block per SM walks the work items blockIdx.x, + gridDim.x, ...: while
// the consumers run an item's epilogue the producer is already filling the
// ring with the next item's tiles.
template <typename P, int BN, int NSUB, bool HEAD, bool WITH_Z>
__global__ void __launch_bounds__(THREADS, 1)
stage_wgmma(const __grid_constant__ TensorMaps<P::B_PARTS> maps, const StageIo io,
            const TileStage st) {
  using L = Layout<P, BN, NSUB>;
  using Acc = typename P::Acc;
  using Out = typename P::Out;
  constexpr int STAGES = L::STAGES;
  constexpr int N = NSUB * BN;  // wgmma width
  constexpr int ACC = N / 2;    // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  // the ring must start on the swizzle's period (1024 bytes at most)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + L::BARRIERS, empty = full + STAGES * 8;
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);  // [n_groups * NSUB][BN]
  float* scale_s = reinterpret_cast<float*>(smem + L::SCALE);
  float4* head_w_s = reinterpret_cast<float4*>(smem + L::HEAD_W);
  float* head_b_s = reinterpret_cast<float*>(smem + L::HEAD_B);

  const int tid = threadIdx.x;
  const int n_sub = st.s * st.s;
  const int k_chunks = (st.Cin + P::BK - 1) / P::BK;
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
    const bool ok = sub < n_sub && c < st.C;
    bias_s[i] = ok ? io.bias[sub * st.C + c] : 0.f;
    if (P::DEQUANT) scale_s[i] = ok ? io.scale[sub * st.C + c] : 0.f;
  }
  if (HEAD) {
    for (int i = tid; i < BN * MAX_HEAD; i += THREADS) {
      const int c = i / MAX_HEAD, k = i % MAX_HEAD;
      reinterpret_cast<float*>(head_w_s)[i] =
          (c < st.C && k < st.c_final) ? io.head_w[c * st.c_final + k] : 0.f;
    }
    if (tid < MAX_HEAD) head_b_s[tid] = tid < st.c_final ? io.head_b[tid] : 0.f;
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
        const int tap = step / k_chunks, ci0 = (step % k_chunks) * P::BK;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        mbar_wait(empty + 8 * slot, parity);
        const uint32_t dst = ring + slot * L::SLOT_BYTES, bar = full + 8 * slot;
#ifdef REPNERV_PROBE_NO_LOADS
        mbar_arrive(bar);
#else
        mbar_arrive_expect_tx(bar, L::TX_BYTES);  // a box counts in full, zeros included
        tma_load_4d(dst, &maps.x, bar, ci0, wk.w0 + dx, wk.h0 + dy, wk.b);
        tma_load_4d(dst + L::B_OFFSET, &maps.w, bar, ci0, tap, 0, wk.sub0);
        if constexpr (P::B_PARTS == 2)
          tma_load_4d(dst + L::B_OFFSET + L::B_BYTES, &maps.w2, bar, ci0, tap, 0, wk.sub0);
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
  const int k32s = (st.Cin + 31) / 32;  // int8: 32-channel products a slot holds
  float q_out = 0.f;
  if (P::INT8_OUT && !HEAD) q_out = *io.q_out;
  typename P::template Regs<N> regs;
  Acc(&acc)[ACC] = regs.d;
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  int slot = 0, prev = 0;
  uint32_t parity = 0;
  // one step: a slot's products, then the step before it retires and frees its slot
  auto consume = [&](auto buf, int step) {
    constexpr int BUF = decltype(buf)::value;
    mbar_wait(full + 8 * slot, parity);
#ifndef REPNERV_PROBE_NO_PRODUCTS
    // an item's first product overwrites the accumulators
    P::template products<N, L, BUF>(regs, smem + slot * L::SLOT_BYTES, wg, tid % 128, step == 0,
                                    k32s);
#endif
    wgmma::commit();
    if (step > 0) {
      wgmma::wait<1>();  // the slot before this one has been read
#ifndef REPNERV_PROBE_NO_PRODUCTS
      P::template retire<N, 1 - BUF>(regs);
#endif
      if (lane == 0) mbar_arrive(empty + 8 * prev);
    }
    prev = slot;
    if (++slot == STAGES) {
      slot = 0;
      parity ^= 1;
    }
  };
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Work wk = work_item(st, item, NSUB);
    P::template start_item<N>(regs);
    for (int step = 0; step < n_steps; step += 2) {
      consume(std::integral_constant<int, 0>{}, step);
      if (step + 1 < n_steps) consume(std::integral_constant<int, 1>{}, step + 1);
    }
    wgmma::wait<0>();
#ifndef REPNERV_PROBE_NO_PRODUCTS
    if (n_steps & 1)
      P::template retire<N, 0>(regs);
    else
      P::template retire<N, 1>(regs);
#endif
    if (lane == 0) mbar_arrive(empty + 8 * prev);  // the producer runs on into the next item
    wgmma::fence_operand(acc);

#ifdef REPNERV_PROBE_NO_EPILOGUE
    {  // keep the accumulators alive, store nothing
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < ACC; ++i) sum += static_cast<float>(acc[i]);
      if (sum == 12345.678f) static_cast<float*>(io.out)[0] = sum;
      continue;
    }
#endif
    // ---- epilogue, from the accumulators' own layout, in three passes over
    // the registers: dequantization and bias (16-bit z's pairs are packed
    // here and stored in the third pass, so that its stores mix with that
    // pass's arithmetic; 32-bit z is stored here), the activation in place,
    // then the store or the head ----
    Out* const out = static_cast<Out*>(io.out);
    Out* const z = static_cast<Out*>(io.z);
    // the output pixel of one of this thread's two rows in a sub-pixel, and
    // whether it lies inside the image
    const auto place = [&](int half, int sub, long long& px) {
      const int m = wg * 64 + warp * 16 + lane / 4 + 8 * half;
      const int h = wk.h0 + (m >> st.tw_log2), w = wk.w0 + (m & tw_mask);
      const int sp = wk.sub0 + sub;
      px = ((long long)wk.b * st.H * st.s + (long long)h * st.s + sp / st.s) *
               ((long long)st.W * st.s) +
           (long long)w * st.s + sp % st.s;
      return h < st.H && w < st.W && sp < n_sub;
    };
    // z stored in the first pass needs the places then; they are kept for the
    // third.  Otherwise the third pass works them out: held across the first
    // two beside packed z they would spill.
    constexpr bool EARLY = WITH_Z && !P::PACK_Z;
    long long pix[EARLY ? 2 : 1][EARLY ? NSUB : 1];
    bool ok[EARLY ? 2 : 1][EARLY ? NSUB : 1];
    if constexpr (EARLY) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int sub = 0; sub < NSUB; ++sub) ok[half][sub] = place(half, sub, pix[half][sub]);
      }
    }
    typename P::ZPair zp[(WITH_Z && P::PACK_Z) ? ACC / 2 : 1];
#pragma unroll
    for (int sub = 0; sub < NSUB; ++sub) {
      const float* bias_sub = bias_s + (wk.sub0 + sub) * BN;
      const float* scale_sub = scale_s + (wk.sub0 + sub) * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float b0 = bias_sub[c], b1 = bias_sub[c + 1];
        float s0 = 1.f, s1 = 1.f;
        if (P::DEQUANT) s0 = scale_sub[c], s1 = scale_sub[c + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 4 * (sub * (BN / 8) + j) + 2 * half;
          float v0, v1;
          if constexpr (P::DEQUANT) {
            v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[r]), s0), b0);
            v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[r + 1]), s1), b1);
          } else {
            v0 = acc[r] + b0;
            v1 = acc[r + 1] + b1;
          }
          set_f32(acc[r], v0);
          set_f32(acc[r + 1], v1);
          if constexpr (WITH_Z && P::PACK_Z) zp[r / 2] = P::pack_pair(v0, v1);
          if constexpr (EARLY) {
            if (ok[half][sub] && c < st.C) P::store_pair(z + pix[half][sub] * st.C + c, v0, v1);
          }
        }
      }
    }
    activate_in_place<P::FAST_SWISH>(acc, st.act);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int sub = 0; sub < NSUB; ++sub) {
        long long px;
        bool inside;
        if constexpr (EARLY)
          px = pix[half][sub], inside = ok[half][sub];
        else
          inside = place(half, sub, px);
        float hacc[MAX_HEAD] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * q;
          const int r = 4 * (sub * (BN / 8) + j) + 2 * half;
          const bool store = inside && c < st.C;
          if constexpr (WITH_Z && P::PACK_Z) {
            if (store) *reinterpret_cast<typename P::ZPair*>(z + px * st.C + c) = zp[r / 2];
          }
          const float a0 = as_f32(acc[r]), a1 = as_f32(acc[r + 1]);
          if (HEAD) {  // head weights past C are zeros
            const float4 w0v = head_w_s[c], w1v = head_w_s[c + 1];
            hacc[0] = fmaf(a0, w0v.x, fmaf(a1, w1v.x, hacc[0]));
            hacc[1] = fmaf(a0, w0v.y, fmaf(a1, w1v.y, hacc[1]));
            hacc[2] = fmaf(a0, w0v.z, fmaf(a1, w1v.z, hacc[2]));
            hacc[3] = fmaf(a0, w0v.w, fmaf(a1, w1v.w, hacc[3]));
          } else if constexpr (!P::INT8_OUT) {
            if (store) P::store_pair(out + px * st.C + c, a0, a1);
          }
        }
        if constexpr (P::INT8_OUT && !HEAD) {
          // int8 out: a lane holds the channel pair 2q, 2q + 1 of every block
          // of 8 channels.  Over a group of four blocks the four lanes of a
          // row exchange their pairs (two shuffles: lanes 2 apart swap two
          // blocks, lanes 1 apart swap the halves), so that lane q holds all
          // 8 channels of block q and stores them as one 8-byte word.
#pragma unroll
          for (int g = 0; g < BN / 32; ++g) {
            uint32_t lo2, hi2;  // this lane's pairs of blocks (4g, 4g + 1) and (4g + 2, 4g + 3)
            {
              const int r = 4 * (sub * (BN / 8) + 4 * g) + 2 * half;
              lo2 = P::quant_byte(as_f32(acc[r]), q_out) |
                    P::quant_byte(as_f32(acc[r + 1]), q_out) << 8 |
                    P::quant_byte(as_f32(acc[r + 4]), q_out) << 16 |
                    P::quant_byte(as_f32(acc[r + 5]), q_out) << 24;
              hi2 = P::quant_byte(as_f32(acc[r + 8]), q_out) |
                    P::quant_byte(as_f32(acc[r + 9]), q_out) << 8 |
                    P::quant_byte(as_f32(acc[r + 12]), q_out) << 16 |
                    P::quant_byte(as_f32(acc[r + 13]), q_out) << 24;
            }
            // lanes q and q ^ 2: the lower lane keeps blocks (0, 1) of both, the upper (2, 3)
            const bool upper = q & 2, odd = q & 1;
            const uint32_t got2 = __shfl_xor_sync(0xffffffffu, upper ? lo2 : hi2, 2);
            const uint32_t from_lower = upper ? got2 : lo2;  // the pair's lower lane's two blocks
            const uint32_t from_upper = upper ? hi2 : got2;
            // lanes q and q ^ 1: the even lane keeps the first block of each, the odd the second
            const uint32_t firsts = __byte_perm(from_lower, from_upper, 0x5410);
            const uint32_t seconds = __byte_perm(from_lower, from_upper, 0x7632);
            const uint32_t kept = odd ? seconds : firsts;
            const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? firsts : seconds, 1);
            // kept: block q's pairs from lanes (q & 1) and (q & 1) + 2; got1: from the other two
            const uint32_t even_lanes = odd ? got1 : kept, odd_lanes = odd ? kept : got1;
            uint2 word;
            word.x = __byte_perm(even_lanes, odd_lanes, 0x5410);  // channels from lanes 0, 1
            word.y = __byte_perm(even_lanes, odd_lanes, 0x7632);  // ... and from lanes 2, 3
            const int c = 32 * g + 8 * q;
            if (inside && c < st.C)
              *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(io.out) + px * st.C + c) =
                  word;
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
          if (inside && q < st.c_final)
            static_cast<float*>(io.out)[px * st.c_final + q] =
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

// A tensor of 4 dimensions (innermost first) of the policy's element, boxes in
// its swizzle, zeros outside.
template <typename P>
bool encode_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                const cuuint32_t (&box)[4], CUtensorMapL2promotion promote) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t e = P::ELEM_BYTES;
  const cuuint64_t strides[3] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, P::DATA_TYPE, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, P::SWIZZLE, promote,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int B_PARTS>
struct Launch {
  TensorMaps<B_PARTS> maps;
  StageIo io;
  TileStage st;
  unsigned blocks, sms;  // work items; blocks the card runs at once (one per SM)
  cudaStream_t stream;
};

template <typename P, int BN, int NSUB, bool HEAD, bool WITH_Z>
cudaError_t launch(const Launch<P::B_PARTS>& l) {
  auto* fn = stage_wgmma<P, BN, NSUB, HEAD, WITH_Z>;
  constexpr int bytes = Layout<P, BN, NSUB>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
#ifdef REPNERV_PROBE_ONE_ITEM_PER_BLOCK
  const unsigned grid = l.blocks;
#else
  const unsigned grid = l.blocks < l.sms ? l.blocks : l.sms;
#endif
  fn<<<grid, THREADS, bytes, l.stream>>>(l.maps, l.io, l.st);
  return cudaGetLastError();
}

template <typename P, int BN, int NSUB>
cudaError_t launch_for(const Launch<P::B_PARTS>& l) {
  if constexpr (P::HAS_Z) {
    if (l.io.z != nullptr)
      return l.st.c_final > 0 ? launch<P, BN, NSUB, true, true>(l)
                              : launch<P, BN, NSUB, false, true>(l);
  }
  if constexpr (P::HAS_HEAD) {
    if (l.st.c_final > 0) return launch<P, BN, NSUB, true, false>(l);
  }
  return launch<P, BN, NSUB, false, false>(l);
}

unsigned sm_count() {
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
int choose_tile_width_log2(int H, int W) {
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

// x [B, H, W, Cin]; wt the K-major weights [s*s*C, 9*Cin] (row (i*s + j)*C + c,
// column (dy, dx, ci)), wt2 the second B tile's (f32: the low parts) or null;
// io.z == nullptr: decode.  Takes Cin in multiples of P::MIN_CIN_STEP (TMA wants
// 16-byte strides) up to P::MAX_CIN, C % 8 == 0, C <= 96, c_final <= 4, s <= 5;
// anything else is cudaErrorInvalidValue.
template <typename P>
int launch_stage(const void* x, const void* wt, const void* wt2, const StageIo& io, int B, int H,
                 int W, int Cin, int C, int s, int act, int c_final, int sigmoid_squash,
                 cudaStream_t stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (Cin <= 0 || Cin % P::MIN_CIN_STEP != 0 || (P::MAX_CIN > 0 && Cin > P::MAX_CIN) ||
      C <= 0 || C % 8 != 0 || C > 96 || c_final < 0 || c_final > MAX_HEAD || s < 1 || s > 5 ||
      x == nullptr || wt == nullptr || misaligned(x) || misaligned(wt) ||
      (P::B_PARTS == 2 && (wt2 == nullptr || misaligned(wt2))) ||
      (!P::HAS_Z && io.z != nullptr) || (!P::HAS_HEAD && c_final > 0) ||
      (P::DEQUANT && io.scale == nullptr) ||
      (P::INT8_OUT && c_final == 0 && io.q_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch<P::B_PARTS> l{};
  l.io = io, l.stream = stream;
  TileStage& st = l.st;
  st = TileStage{B, H, W, Cin, C, s, act, c_final, sigmoid_squash, 0, 0, 0, 0};
  st.tw_log2 = choose_tile_width_log2(H, W);
  const int tw = 1 << st.tw_log2, th = BM >> st.tw_log2;
  st.tiles_h = (H + th - 1) / th;
  st.tiles_w = (W + tw - 1) / tw;
  constexpr int NSUB = sub_pixels(P::NSUB);
  st.n_groups = (s * s + NSUB - 1) / NSUB;
  const long long blocks = (long long)B * st.tiles_h * st.tiles_w * st.n_groups;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  l.blocks = static_cast<unsigned>(blocks);
  l.sms = sm_count();
  if (l.sms == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bn = C <= 32 ? 32 : C <= 64 ? 64 : 96;

  const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t x_box[4] = {P::BK, (cuuint32_t)tw, (cuuint32_t)th, 1};
  const cuuint64_t w_dims[4] = {(cuuint64_t)Cin, 9, (cuuint64_t)C, (cuuint64_t)(s * s)};
  const cuuint32_t w_box[4] = {P::BK, 1, (cuuint32_t)bn, NSUB};
  if (!encode_map<P>(&l.maps.x, x, x_dims, x_box, CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map<P>(&l.maps.w, wt, w_dims, w_box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (P::B_PARTS == 2) {
    if (!encode_map<P>(&l.maps.w2, wt2, w_dims, w_box, CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
      return static_cast<int>(cudaErrorInvalidValue);
  }

  const cudaError_t err = bn == 32   ? launch_for<P, 32, NSUB>(l)
                          : bn == 64 ? launch_for<P, 64, NSUB>(l)
                                     : launch_for<P, 96, NSUB>(l);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace repnerv

#ifdef REPNERV_PROBE
// C entry for kernels/probe_wgmma.py, which builds one of the three sources
// alone: the same signature for every type (wt2, scale, inv_out and z null
// where the type has none; inv_out goes to io.q_out).  Each source defines it
// with its policy.
#define REPNERV_PROBE_ENTRY(POLICY)                                                             \
  extern "C" int repnerv_probe_stage(const void* x, const void* wt, const void* wt2,            \
                                     const float* b, const float* scale, const float* inv_out,  \
                                     const float* head_w, const float* head_b, void* out,       \
                                     void* z, int B, int H, int W, int Cin, int C, int s,       \
                                     int act, int c_final, int sigmoid_squash, void* stream) {  \
    const repnerv::StageIo io{b, scale, inv_out, head_w, head_b, out, z};                       \
    return repnerv::launch_stage<POLICY>(x, wt, wt2, io, B, H, W, Cin, C, s, act, c_final,      \
                                         sigmoid_squash, static_cast<cudaStream_t>(stream));    \
  }
#else
#define REPNERV_PROBE_ENTRY(POLICY)
#endif
