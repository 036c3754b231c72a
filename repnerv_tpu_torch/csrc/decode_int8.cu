// int8 fused decode stage for Hopper (sm_90a):
//   acc = conv3x3_same(x_q, w_q)                      (int8 x int8 -> int32, exact)
//   y   = act(pixel_shuffle(f32(acc) * scale + bias)) (f32)
//   out = clip(rint(y * inv_out), -127, 127)          (int8, the next int8 stage's input), or
//   out = squash(head_1x1(y))                         (f32 RGB, the last stage)
//
// Replaces the TPU kernel repnerv_tpu/pallas_kernels/decode_int8.py::fused_conv_ps_act_int8.
//
// Layouts (as the JAX kernel's): x_q is NHWC int8 [B, H, W, Cin]; w is the
// packed implicit-GEMM operand [9*Cin, Cout] int8, rows (dy, dx, ci), columns
// in shuffle-major order (i*s + j)*C + c; scale (= sx * sw, the input scale
// folded into the per-channel weight scale) and bias are f32 [Cout] in the
// same order; inv_out is one f32 (1/out_scale, computed by the caller).  The
// output is int8 [B, H*s, W*s, C], or f32 [B, H*s, W*s, c_final] with the head.
//
// Rounding, one per operation as in the JAX kernel: f32(acc) is exact (|acc| <
// 2^24 for Cin <= 113; rounded to nearest above), then __fmul_rn by the scale
// and __fadd_rn of the bias (never contracted into an FMA), the activation of
// activations.cuh, and the requantization rintf (round half to even, as
// jnp.round and torch.round) of __fmul_rn(y, inv_out), clamped to +-127.
//
// What bounds it: the flagship's block 4 (360x640x96 -> 720x1280x96 at stride
// 2) is ~2,800 int8 operations per byte of device memory moved, so the kernel
// is bound by the tensor cores' int8 rate.  Stages whose channel counts allow
// it (Cin % 16 == 0, Cin <= 128, C % 8 == 0, C <= 96, head <= 4: the
// flagship's blocks 3-4) run the wgmma + TMA kernel of decode_wgmma_s8.cu
// (route 1 below); the kernel here takes the remaining shapes.  It is the
// first K1 bf16 design with int8 operands: a plain shared-memory implicit GEMM, one block
// computing BM = 128 output pixels x one chunk of BN = 96 channels of one
// sub-pixel, 8 warps of 32 x 48 WMMA 16x16x16 signed-char fragments with int32
// accumulators, fed by a 3-stage cp.async ring (BK = 32 input channels of one
// tap per k-step).  Each 16x16 operand tile is stored as its own 256-byte
// block in shared memory, so every fragment pointer is 256-bit aligned and its
// leading dimension is 16.  What the design keeps out of device memory is what
// the TPU kernel kept out: the SAME halo is bounds-checked in the loader (no
// padded copy of x), the pixel-shuffled int8 output is stored straight to its
// index, and with the head one block owns all C channels of a sub-pixel and
// accumulates the 1x1 head in registers, so the full-resolution feature map is
// never written.

#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "activations.cuh"
#include "stage_common.cuh"

namespace {

using repnerv::apply_act;
using repnerv::out_pixel;
using repnerv::pack_row;
using repnerv::Stage;
using s8 = signed char;

constexpr int BM = 128, BN = 96, BK = 32, THREADS = 256, STAGES = 3;
constexpr int A_STAGE = BM * BK, B_STAGE = BK * BN;  // bytes: 16x16 tiles of 256 bytes
constexpr int RING_BYTES = STAGES * (A_STAGE + B_STAGE);
constexpr int C_LD = BN + 4;  // padded int32 accumulator rows
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = (RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES) + BM * 4;
constexpr int TM = BM / 16, TN = BN / 16;  // epilogue: 8 rows x 6 channels a thread

// byte offset of A element (row, k) and B element (k, n) in their stage:
// 16x16 tiles, row-major inside a tile, tiles row-major over the stage
__device__ __forceinline__ int a_off(int row, int k) {
  return (((row >> 4) * (BK / 16) + (k >> 4)) << 8) + ((row & 15) << 4) + (k & 15);
}
__device__ __forceinline__ int b_off(int k, int n) {
  return (((k >> 4) * (BN / 16) + (n >> 4)) << 8) + ((k & 15) << 4) + (n & 15);
}

// copy VEC int8 from gmem to smem, or zeros when !valid (gmem then unread)
template <int VEC>
__device__ __forceinline__ void copy_async(s8* smem, const s8* gmem, bool valid) {
  if constexpr (VEC == 1) {
    *smem = valid ? *gmem : s8(0);
  } else {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    const int n = valid ? VEC : 0;
    if constexpr (VEC == 16)
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

template <bool HEAD, int VEC>
__global__ void __launch_bounds__(THREADS, 2)
kernel(const s8* __restrict__ x, const s8* __restrict__ w, const float* __restrict__ scale,
       const float* __restrict__ bias, const float* __restrict__ inv_out_p,
       const float* __restrict__ head_w, const float* __restrict__ head_b,
       void* __restrict__ out_v, Stage st) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  s8* ring = reinterpret_cast<s8*>(smem);    // STAGES x (A tiles, B tiles)
  int* Cs = reinterpret_cast<int*>(smem);    // after the k-loop: [BM][C_LD]
  int* row_hw = reinterpret_cast<int*>(smem + SMEM_BYTES - BM * 4);
  s8* out8 = static_cast<s8*>(out_v);
  float* outf = static_cast<float*>(out_v);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows wm*32, cols wn*48
  const int tx = tid % 16, ty = tid / 16;  // epilogue: rows ty + 16r, cols tx + 16c
  const int m0 = blockIdx.x * BM;
  const int sub = blockIdx.y / st.chunk_groups;
  const int si = sub / st.s, sj = sub % st.s;
  const int n_chunks = (st.C + BN - 1) / BN;
  const int chunk_begin = (blockIdx.y % st.chunk_groups) * st.chunks_per_block;
  const int chunk_end = min(chunk_begin + st.chunks_per_block, n_chunks);
  const int Cout = st.s * st.s * st.C;
  const int k_chunks = (st.Cin + BK - 1) / BK;
  const int n_steps = 9 * k_chunks;
  const int M = st.M();
  const float inv_out = HEAD ? 0.f : *inv_out_p;

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
      s8* As = ring + slot * (A_STAGE + B_STAGE);
      s8* Bs = As + A_STAGE;
      const int tap = step / k_chunks;
      const int ci0 = (step % k_chunks) * BK;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      constexpr int A_VECS = BM * BK / VEC, A_ROW = BK / VEC;
#pragma unroll
      for (int e = tid; e < A_VECS; e += THREADS) {
        const int row = e / A_ROW, k = (e % A_ROW) * VEC;
        const int hw = row_hw[row];
        const int ih = (hw >> 16) + dy, iw = (hw & 0xffff) + dx;
        const bool ok = ci0 + k < st.Cin && ih >= 0 && ih < st.H && iw >= 0 && iw < st.W;
        copy_async<VEC>(As + a_off(row, k),
                        ok ? x + (size_t)(m0 + row + dy * st.W + dx) * st.Cin + ci0 + k : x, ok);
      }
      constexpr int B_VECS = BK * BN / VEC, B_ROW = BN / VEC;
#pragma unroll
      for (int e = tid; e < B_VECS; e += THREADS) {
        const int k = e / B_ROW, n = (e % B_ROW) * VEC;
        const bool ok = ci0 + k < st.Cin && c0 + n < st.C;
        copy_async<VEC>(Bs + b_off(k, n),
                        ok ? w + (size_t)(tap * st.Cin + ci0 + k) * Cout + col0 + n : w, ok);
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0);

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
      const s8* As = ring + (step % STAGES) * (A_STAGE + B_STAGE);
      const s8* Bs = As + A_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, s8, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, s8, wmma::row_major> fb[3];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (((wm * 2 + i) * (BK / 16) + kk) << 8), 16);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          wmma::load_matrix_sync(fb[j], Bs + ((kk * (BN / 16) + wn * 3 + j) << 8), 16);
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

    // epilogue of this chunk: dequant, bias, activation, then the requantized
    // shuffled store or this chunk's share of the head
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + ty + 16 * r;
      const long long pix = m < M ? out_pixel(st, m, si, sj) : 0;
      float v[TN];
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int cc = c0 + tx + 16 * c;
        v[c] = 0.f;
        if (m < M && cc < st.C) {
          const int col = col0 + tx + 16 * c;
          const float deq = __fmul_rn(static_cast<float>(Cs[(ty + 16 * r) * C_LD + tx + 16 * c]),
                                      scale[col]);
          v[c] = apply_act(__fadd_rn(deq, bias[col]), st.act);
          if (!HEAD) {
            const float q = fminf(fmaxf(rintf(__fmul_rn(v[c], inv_out)), -127.f), 127.f);
            out8[pix * st.C + cc] = static_cast<s8>(static_cast<int>(q));
          }
        }
      }
      if (HEAD) {
        for (int k = 0; k < st.c_final; ++k) {
          float p = 0.f;
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const int cc = c0 + tx + 16 * c;
            if (cc < st.C) p = fmaf(v[c], head_w[cc * st.c_final + k], p);
          }
          // sum over the 16 lanes (one half-warp) that hold this row
#pragma unroll
          for (int off = 8; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
          if (tx == k) head_acc[r] += p;
        }
      }
    }
    __syncthreads();  // the next chunk's copies overwrite Cs
  }

  // after the last chunk: lane tx < c_final writes head output tx of its rows
  if (HEAD && tx < st.c_final) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + ty + 16 * r;
      if (m >= M) continue;
      outf[out_pixel(st, m, si, sj) * st.c_final + tx] =
          repnerv::squash(head_acc[r] + head_b[tx], st.sigmoid_squash);
    }
  }
}

template <bool HEAD, int VEC>
cudaError_t launch(const void* x, const void* w, const float* scale, const float* bias,
                   const float* inv_out, const float* hw, const float* hb, void* out, Stage st,
                   cudaStream_t stream) {
  auto* fn = kernel<HEAD, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid = repnerv::grid_for(st, BM, BN);
  fn<<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const s8*>(x), static_cast<const s8*>(w),
                                            scale, bias, inv_out, hw, hb, out, st);
  return cudaGetLastError();
}

// the widest copy that Cin, C and both pointers' alignment allow
template <bool HEAD>
cudaError_t launch_vec(const void* x, const void* w, const float* scale, const float* bias,
                       const float* inv_out, const float* hw, const float* hb, void* out,
                       Stage st, cudaStream_t stream) {
  const auto aligned = [&](int bytes) {
    return reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(w) % bytes == 0;
  };
  if (st.Cin % 16 == 0 && st.C % 16 == 0 && aligned(16))
    return launch<HEAD, 16>(x, w, scale, bias, inv_out, hw, hb, out, st, stream);
  if (st.Cin % 4 == 0 && st.C % 4 == 0 && aligned(4))
    return launch<HEAD, 4>(x, w, scale, bias, inv_out, hw, hb, out, st, stream);
  return launch<HEAD, 1>(x, w, scale, bias, inv_out, hw, hb, out, st, stream);
}

}  // namespace

// route: 0 = the WMMA kernel here, which reads w [9*Cin, Cout]; 1 = the wgmma +
// TMA kernel, which reads its K-major copy wt [Cout, 9*Cin]; the one a route
// does not read may be null.  The caller names the route
// (kernels/decode_int8.py::int8_route); a route that cannot take the shape is
// an error, never another kernel.
// c_final = 0: requantize to int8 with *inv_out (device pointer, one f32);
// c_final > 0: fused head + squash, out float32, inv_out unused.  Returns the
// cudaError_t of the launch.
extern "C" int repnerv_fused_conv_ps_act_int8(int route, const void* x, const void* w,
                                              const void* wt, const float* scale,
                                              const float* bias, const float* inv_out,
                                              const float* head_w, const float* head_b,
                                              void* out, int B, int H, int W, int Cin, int C,
                                              int s, int act, int c_final, int sigmoid_squash,
                                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return repnerv::launch_stage_wgmma_s8(x, wt, scale, bias, inv_out, head_w, head_b, out, B, H,
                                          W, Cin, C, s, act, c_final, sigmoid_squash, st);
  if (route != 0 || w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Stage stage{B, H, W, Cin, C, s, act, c_final, sigmoid_squash, 1, 1};
  if (c_final > 0)
    return launch_vec<true>(x, w, scale, bias, inv_out, head_w, head_b, out, stage, st);
  if (inv_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_vec<false>(x, w, scale, bias, inv_out, head_w, head_b, out, stage, st);
}
