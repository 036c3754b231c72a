// Fused decode stage for Hopper (sm_90a):
//   out = act(pixel_shuffle(conv3x3_same(x) + b))                    (no head), or
//   out = squash(head_1x1(act(pixel_shuffle(conv3x3_same(x) + b))))  (head)
//
// Replaces the TPU kernels repnerv_tpu/pallas_kernels/decode.py::fused_conv_ps_act
// and, with the pre-activation store below, the training forward
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_fwd_kernel_call.
//
// Training forward (repnerv_train_stage_fwd): the same kernels also store the
// pre-activation z = pixel_shuffle(conv3x3(x) + b) [B, H*s, W*s, C] in the
// compute dtype, at the index of the no-head shuffled store and before the
// activation (the JAX kernel's z5 [B, H, s, W, s*C] is the same bytes).  With
// the head, z is written too (the backward needs it) and out stays the f32 RGB.
//
// Layouts (as the JAX kernel's): x is NHWC [B, H, W, Cin]; w is the packed
// implicit-GEMM operand [9*Cin, Cout] whose rows run (dy, dx, ci) and whose
// columns are in shuffle-major order (i*s + j)*C + c, so the C channels of
// one sub-pixel (i, j) are contiguous; b is f32 [Cout] in the same order.
// The output is [B, H*s, W*s, C] in the compute dtype, or [B, H*s, W*s, c_final]
// f32 with the head.  Inputs are f32 or bf16; the accumulator, bias,
// activation, head and squash are f32.
//
// What bounds it: at the 720p stage 4 shape (360x640x96 -> 720x1280x96) the
// conv is ~2,800 FLOP per byte of device memory moved, so the kernel is
// compute-bound, and the tensor cores are the unit to use.  Stages whose
// channel counts allow it run the wgmma + TMA kernels of decode_wgmma.cu (bf16,
// route 2 below) and decode_wgmma_tf32.cu (f32 as three TF32 products, route
// 3); the two kernels here take the remaining shapes (Cin not a multiple of 8
// in bf16 or of 4 in f32, C not a multiple of 8 or above 96, a head wider than
// 4: block 1 of the flagship, Cin 26).  Both are plain shared-memory implicit GEMMs (no TMA, no wgmma, no
// warp specialisation): one block computes BM output pixels x one chunk of
// one sub-pixel's channels, stepping over K one tap and one slice of input
// channels at a time, with the next slices' loads in flight during the math.
//   * f32: CUDA-core FMA, 8 x BN/16 outputs per thread, register prefetch;
//   * bf16: WMMA 16x16x16 tensor-core tiles with f32 accumulation, fed by a
//     3-stage cp.async ring, staged through shared memory for the epilogue.
// What the design keeps out of device memory is what the TPU kernel kept out:
//   * the SAME halo is bounds-checked in the loader, so no padded copy of x;
//   * pixel-shuffled pixels are stored straight to out[b, h*s+i, w*s+j, :],
//     so the pre-shuffle conv output never exists;
//   * with the head, one block owns all C channels of a sub-pixel (it walks
//     the channel chunks of one sub-pixel in turn and accumulates the 1x1 head
//     in registers), so the full-resolution feature map (354 MB per 720p frame
//     in f32) is never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "activations.cuh"
#include "stage_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

using repnerv::apply_act;
using repnerv::grid_for;
using repnerv::out_pixel;
using repnerv::pack_row;
using repnerv::Stage;

// Epilogue of one channel chunk for the TM x TN values a thread holds (rows
// m0 + ty + ROW_STRIDE*r, chunk columns tx + 16*c): bias + activation, then
// either the shuffled store or this chunk's share of the head, summed over
// the 16 lanes (one half-warp, tx = 0..15) that hold the same rows.
template <typename OutT, typename ZT, int TM, int TN, int ROW_STRIDE>
__device__ __forceinline__ void epilogue_chunk(const Stage& st, float (&v)[TM][TN],
                                               float (&head_acc)[TM], int m0, int ty,
                                               int tx, int c0, int col0, int si, int sj,
                                               const float* __restrict__ bias,
                                               const float* __restrict__ head_w,
                                               OutT* __restrict__ out, ZT* __restrict__ z) {
  const int M = st.M();
  const bool with_head = st.c_final > 0;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + ROW_STRIDE * r;
    const long long pix = m < M ? out_pixel(st, m, si, sj) : 0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int cc = c0 + tx + 16 * c;
      const bool ok = m < M && cc < st.C;
      if (ok) {
        const float pre = v[r][c] + bias[col0 + tx + 16 * c];
        if (z != nullptr) z[pix * st.C + cc] = from_f32<ZT>(pre);  // training forward only
        v[r][c] = apply_act(pre, st.act);
        if (!with_head) out[pix * st.C + cc] = from_f32<OutT>(v[r][c]);
      } else {
        v[r][c] = 0.f;
      }
    }
    if (with_head) {
      for (int k = 0; k < st.c_final; ++k) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const int cc = c0 + tx + 16 * c;
          if (cc < st.C) p = fmaf(v[r][c], head_w[cc * st.c_final + k], p);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (tx == k) head_acc[r] += p;
      }
    }
  }
}

// After the last chunk: lane tx < c_final writes head output tx of its rows.
template <typename OutT, int TM, int ROW_STRIDE>
__device__ __forceinline__ void store_head(const Stage& st, const float (&head_acc)[TM],
                                           int m0, int ty, int tx, int si, int sj,
                                           const float* __restrict__ head_b,
                                           OutT* __restrict__ out) {
  if (st.c_final == 0 || tx >= st.c_final) return;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + ty + ROW_STRIDE * r;
    if (m >= st.M()) continue;
    const float y = head_acc[r] + head_b[tx];
    out[out_pixel(st, m, si, sj) * st.c_final + tx] =
        from_f32<OutT>(repnerv::squash(y, st.sigmoid_squash));
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA.  BM = 128 pixels x BN channels, 256 threads (16 x 16),
// 8 x BN/16 outputs per thread, BK = 16 input channels per k-step.
// ---------------------------------------------------------------------------

namespace cuda_core {
constexpr int BM = 128, BK = 16, THREADS = 256, TM = BM / 16;
constexpr int AS_LD = BM + 4;  // padded A-tile row, spreads the loader's stores over banks

// two blocks per SM: at 255 registers and one block (no spills) it ran 30%
// slower at the 720p shapes than at 128 registers with small spills
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const float* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ bias, const float* __restrict__ head_w,
       const float* __restrict__ head_b, float* __restrict__ out, float* __restrict__ z,
       Stage st) {
  constexpr int TN = BN / 16;
  constexpr int B_PER_THREAD = BK * BN / THREADS;
  static_assert(BK * BN % THREADS == 0, "B tile must split evenly");
  __shared__ float As[BK][AS_LD];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int sub = blockIdx.y / st.chunk_groups;
  const int si = sub / st.s, sj = sub % st.s;
  const int n_chunks = (st.C + BN - 1) / BN;
  const int chunk_begin = (blockIdx.y % st.chunk_groups) * st.chunks_per_block;
  const int chunk_end = min(chunk_begin + st.chunks_per_block, n_chunks);
  const int Cout = st.s * st.s * st.C;
  const int k_chunks = (st.Cin + BK - 1) / BK;
  const int n_steps = 9 * k_chunks;

  // A loader: channel a_k of rows a_r0 + 16*q
  const int a_k = tid % BK, a_r0 = tid / BK;
  int a_hw[TM];
#pragma unroll
  for (int q = 0; q < TM; ++q) a_hw[q] = pack_row(st, m0 + a_r0 + 16 * q);

  float a_reg[TM], b_reg[B_PER_THREAD], head_acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) head_acc[r] = 0.f;

  for (int chunk = chunk_begin; chunk < chunk_end; ++chunk) {
    const int c0 = chunk * BN;
    const int col0 = sub * st.C + c0;

    auto load_tile = [&](int step) {
      const int tap = step / k_chunks;
      const int ci0 = (step % k_chunks) * BK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const int ci = ci0 + a_k;
#pragma unroll
      for (int q = 0; q < TM; ++q) {
        const int ih = (a_hw[q] >> 16) + dy, iw = (a_hw[q] & 0xffff) + dx;
        const int m = m0 + a_r0 + 16 * q;
        const bool ok = ci < st.Cin && ih >= 0 && ih < st.H && iw >= 0 && iw < st.W;
        a_reg[q] = ok ? x[(m + dy * st.W + dx) * st.Cin + ci] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < B_PER_THREAD; ++q) {
        const int e = tid + THREADS * q;
        const int k = e / BN, n = e % BN;
        const bool ok = ci0 + k < st.Cin && c0 + n < st.C;
        b_reg[q] = ok ? w[(tap * st.Cin + ci0 + k) * Cout + col0 + n] : 0.f;
      }
    };
    auto store_tile = [&]() {
#pragma unroll
      for (int q = 0; q < TM; ++q) As[a_k][a_r0 + 16 * q] = a_reg[q];
#pragma unroll
      for (int q = 0; q < B_PER_THREAD; ++q) {
        const int e = tid + THREADS * q;
        Bs[e / BN][e % BN] = b_reg[q];
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;

    load_tile(0);
    store_tile();
    __syncthreads();
    for (int step = 0; step < n_steps; ++step) {
      if (step + 1 < n_steps) load_tile(step + 1);  // in flight during the FMAs
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = As[k][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < TN; ++c) bv[c] = Bs[k][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
      if (step + 1 < n_steps) {
        store_tile();
        __syncthreads();
      }
    }
    epilogue_chunk<float, float, TM, TN, 16>(st, acc, head_acc, m0, ty, tx, c0, col0, si,
                                             sj, bias, head_w, out, z);
  }
  store_head<float, TM, 16>(st, head_acc, m0, ty, tx, si, sj, head_b, out);
}
}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bf16: WMMA tensor cores.  BM = 128 pixels x BN = 96 channels, 8 warps in a
// 4 x 2 grid, each warp 32 x 48 = 2 x 3 fragments of 16 x 16; BK = 32 input
// channels of one tap per k-step.  Tiles reach shared memory by cp.async
// (global -> shared, no registers) in a 3-stage ring, VEC channels per copy:
// 8 (16 bytes) where Cin, C and the pointers allow it, else 2 (4 bytes), else
// 1 (plain loads).  Out-of-bounds halo pixels and channel tails are
// zero-filled by the copy itself.  After the k-loop the ring's memory holds
// the f32 accumulators for the same per-thread epilogue as the f32 kernel
// (8 rows x 6 channels a thread).
// ---------------------------------------------------------------------------

namespace tensor_core {
constexpr int BM = 128, BN = 96, BK = 32, THREADS = 256, STAGES = 3;
constexpr int A_LD = BK + 8, B_LD = BN + 8, C_LD = BN + 4;  // padded rows
constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * B_LD;      // bf16 elements
constexpr int RING_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES) + BM * 4;
constexpr int TM = BM / 16, TN = BN / 16;  // epilogue: 8 x 6

// copy VEC bf16 from gmem to smem, or zeros when !valid (gmem then unread)
template <int VEC>
__device__ __forceinline__ void copy_async(bf16* smem, const bf16* gmem, bool valid) {
  if constexpr (VEC == 1) {
    *smem = valid ? *gmem : __float2bfloat16_rn(0.f);
  } else {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? VEC * 2 : 0;
    if constexpr (VEC == 8)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                   "r"(n));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
                   "r"(n));
  }
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename OutT, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
       const float* __restrict__ bias, const float* __restrict__ head_w,
       const float* __restrict__ head_b, OutT* __restrict__ out, bf16* __restrict__ z,
       Stage st) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);     // STAGES x (A tile, B tile)
  float* Cs = reinterpret_cast<float*>(smem);     // after the k-loop: [BM][C_LD]
  int* row_hw = reinterpret_cast<int*>(smem + SMEM_BYTES - BM * 4);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;    // warp tile: rows wm*32, cols wn*48
  const int tx = tid % 16, ty = tid / 16;    // epilogue: rows ty + 16r, cols tx + 16c
  const int m0 = blockIdx.x * BM;
  const int sub = blockIdx.y / st.chunk_groups;
  const int si = sub / st.s, sj = sub % st.s;
  const int n_chunks = (st.C + BN - 1) / BN;
  const int chunk_begin = (blockIdx.y % st.chunk_groups) * st.chunks_per_block;
  const int chunk_end = min(chunk_begin + st.chunks_per_block, n_chunks);
  const int Cout = st.s * st.s * st.C;
  const int k_chunks = (st.Cin + BK - 1) / BK;
  const int n_steps = 9 * k_chunks;

  for (int r = tid; r < BM; r += THREADS) row_hw[r] = pack_row(st, m0 + r);
  __syncthreads();

  float head_acc[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) head_acc[r] = 0.f;

  for (int chunk = chunk_begin; chunk < chunk_end; ++chunk) {
    const int c0 = chunk * BN;
    const int col0 = sub * st.C + c0;

    // issue the copies of k-step `step` into ring slot `slot`
    auto load_tile = [&](int step, int slot) {
      bf16* As = ring + slot * (A_STAGE + B_STAGE);
      bf16* Bs = As + A_STAGE;
      const int tap = step / k_chunks;
      const int ci0 = (step % k_chunks) * BK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      constexpr int A_VECS = BM * BK / VEC, A_ROW = BK / VEC;
#pragma unroll
      for (int e = tid; e < A_VECS; e += THREADS) {
        const int row = e / A_ROW, ci = ci0 + (e % A_ROW) * VEC;
        const int hw = row_hw[row];
        const int ih = (hw >> 16) + dy, iw = (hw & 0xffff) + dx;
        const bool ok = ci < st.Cin && ih >= 0 && ih < st.H && iw >= 0 && iw < st.W;
        copy_async<VEC>(&As[row * A_LD + (e % A_ROW) * VEC],
                        ok ? x + (m0 + row + dy * st.W + dx) * st.Cin + ci : x, ok);
      }
      constexpr int B_VECS = BK * BN / VEC, B_ROW = BN / VEC;
#pragma unroll
      for (int e = tid; e < B_VECS; e += THREADS) {
        const int k = e / B_ROW, n = (e % B_ROW) * VEC;
        const bool ok = ci0 + k < st.Cin && c0 + n < st.C;
        copy_async<VEC>(&Bs[k * B_LD + n],
                        ok ? w + (tap * st.Cin + ci0 + k) * Cout + col0 + n : w, ok);
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < n_steps) load_tile(p, p);
      commit();
    }
    for (int step = 0; step < n_steps; ++step) {
      wait_pending<STAGES - 2>();  // this step's copies have landed ...
      __syncthreads();             // ... for every thread, and the slot refilled
                                   // below is no longer being read
      const int next = step + STAGES - 1;
      if (next < n_steps) load_tile(next, next % STAGES);
      commit();
      const bf16* As = ring + (step % STAGES) * (A_STAGE + B_STAGE);
      const bf16* Bs = As + A_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[3];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * B_LD + wn * 48 + 16 * j, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    wait_pending<0>();
    __syncthreads();  // the ring is free: reuse it for the accumulators

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + 16 * i) * C_LD + wn * 48 + 16 * j, acc[i][j],
                                C_LD, wmma::mem_row_major);
    __syncthreads();
    float v[TM][TN];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) v[r][c] = Cs[(ty + 16 * r) * C_LD + tx + 16 * c];
    epilogue_chunk<OutT, bf16, TM, TN, 16>(st, v, head_acc, m0, ty, tx, c0, col0, si, sj,
                                           bias, head_w, out, z);
    __syncthreads();  // the next chunk's copies overwrite Cs
  }
  store_head<OutT, TM, 16>(st, head_acc, m0, ty, tx, si, sj, head_b, out);
}
}  // namespace tensor_core

template <int BN>
cudaError_t launch_fma(const void* x, const void* w, const float* b, const float* hw,
                       const float* hb, void* out, void* z, Stage st, cudaStream_t stream) {
  const dim3 grid = grid_for(st, cuda_core::BM, BN);
  cuda_core::kernel<BN><<<grid, cuda_core::THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), b, hw, hb,
      static_cast<float*>(out), static_cast<float*>(z), st);
  return cudaGetLastError();
}

template <typename OutT, int VEC>
cudaError_t launch_tc(const void* x, const void* w, const float* b, const float* hw,
                      const float* hb, void* out, void* z, Stage st, cudaStream_t stream) {
  auto* fn = tensor_core::kernel<OutT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tensor_core::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid = grid_for(st, tensor_core::BM, tensor_core::BN);
  fn<<<grid, tensor_core::THREADS, tensor_core::SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), b, hw, hb,
      static_cast<OutT*>(out), static_cast<bf16*>(z), st);
  return cudaGetLastError();
}

// the widest copy that Cin, C and both pointers' alignment allow
template <typename OutT>
cudaError_t launch_tc_vec(const void* x, const void* w, const float* b, const float* hw,
                          const float* hb, void* out, void* z, Stage st,
                          cudaStream_t stream) {
  const auto aligned = [&](int bytes) {
    return reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(w) % bytes == 0;
  };
  if (st.Cin % 8 == 0 && st.C % 8 == 0 && aligned(16))
    return launch_tc<OutT, 8>(x, w, b, hw, hb, out, z, st, stream);
  if (st.Cin % 2 == 0 && st.C % 2 == 0 && aligned(4))
    return launch_tc<OutT, 2>(x, w, b, hw, hb, out, z, st, stream);
  return launch_tc<OutT, 1>(x, w, b, hw, hb, out, z, st, stream);
}

// z == nullptr: decode (no pre-activation store); else the training forward.
// sx != nullptr: the int8 output of route 2 (the others refuse it).
// The caller names the route (kernels/decode.py::stage_route); a route that
// cannot take the shape is an error, never another kernel.
int launch_stage(int route, const void* x, const void* w, const void* wt, const float* b,
                 const float* head_w, const float* head_b, void* out, void* z, const float* sx,
                 int B, int H, int W, int Cin, int C, int s, int act, int c_final,
                 int sigmoid_squash, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return repnerv::launch_stage_wgmma(x, wt, b, head_w, head_b, out, z, sx, B, H, W, Cin, C, s,
                                       act, c_final, sigmoid_squash, st);
  if (sx != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 3) {
    if (wt == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    // wt holds the high parts [Cout, 9*Cin], then the low parts
    const float* lo = static_cast<const float*>(wt) + (size_t)s * s * C * 9 * Cin;
    return repnerv::launch_stage_wgmma_tf32(x, wt, lo, b, head_w, head_b, out, z, B, H, W, Cin, C,
                                            s, act, c_final, sigmoid_squash, st);
  }
  Stage stage{B, H, W, Cin, C, s, act, c_final, sigmoid_squash, 1, 1};
  if (route == 0) {
    // the smallest channel tile that holds C (the flagship's C = 96 fills one
    // 96-wide tile); wider C walks 96-wide chunks
    if (C <= 32) return launch_fma<32>(x, w, b, head_w, head_b, out, z, stage, st);
    if (C <= 64) return launch_fma<64>(x, w, b, head_w, head_b, out, z, stage, st);
    return launch_fma<96>(x, w, b, head_w, head_b, out, z, stage, st);
  }
  if (route == 1 && c_final > 0)
    return launch_tc_vec<float>(x, w, b, head_w, head_b, out, z, stage, st);
  if (route == 1) return launch_tc_vec<bf16>(x, w, b, head_w, head_b, out, z, stage, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// route: 0 = float32 on the FMA pipes, 1 = bfloat16 WMMA, 2 = bfloat16 wgmma +
// TMA, 3 = float32 as three TF32 wgmma products + TMA (x and w in that type).
// w is the operand [9*Cin, Cout] of routes 0 and 1; wt is its K-major copy
// [Cout, 9*Cin] of route 2, or that copy's two TF32 parts [2, Cout, 9*Cin] of
// route 3; the one a route does not read may be null.
// c_final = 0: no head, out in the compute dtype; c_final > 0: fused head, out
// float32.  sx (device, one f32) != nullptr, route 2 without a head only: out
// is int8, the next int8 block's input quantised with *sx.  Returns the
// cudaError_t of the launch.
extern "C" int repnerv_fused_conv_ps_act(int route, const void* x, const void* w,
                                         const void* wt, const float* b,
                                         const float* head_w, const float* head_b, void* out,
                                         const float* sx, int B, int H, int W, int Cin, int C,
                                         int s, int act, int c_final, int sigmoid_squash,
                                         void* stream) {
  return launch_stage(route, x, w, wt, b, head_w, head_b, out, nullptr, sx, B, H, W, Cin, C, s,
                      act, c_final, sigmoid_squash, stream);
}

// The training forward: as repnerv_fused_conv_ps_act, and also z [B, H*s, W*s, C]
// (the pre-activation, compute dtype).
extern "C" int repnerv_train_stage_fwd(int route, const void* x, const void* w,
                                       const void* wt, const float* b, const float* head_w,
                                       const float* head_b, void* out, void* z, int B, int H,
                                       int W, int Cin, int C, int s, int act, int c_final,
                                       int sigmoid_squash, void* stream) {
  if (z == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stage(route, x, w, wt, b, head_w, head_b, out, z, nullptr, B, H, W, Cin, C, s,
                      act, c_final, sigmoid_squash, stream);
}
