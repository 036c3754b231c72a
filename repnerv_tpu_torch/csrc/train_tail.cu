// Fused epilogue backward of one training stage for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_bwd_kernel_call.
//
// The stage's forward (csrc/decode.cu, repnerv_train_stage_fwd) is
//   z   = pixel_shuffle(conv3x3(x) + b)            [B, H*s, W*s, C], compute dtype
//   out = act(z)                                   (no head), or
//   out = squash(act(z) @ hw + hb)                 [B, H*s, W*s, c_final] f32 (head)
// and this kernel takes the cotangent ct of out back to the conv output:
//   head:    d_h = ct * squash'(out)  (tanh: 0.5 * (1 - u^2), u = 2 out - 1;
//                                      sigmoid: out * (1 - out)), f32
//            d_a = d_h @ hw^T         (operands rounded to the compute dtype,
//                                      f32 sum: the JAX kernel's cast points)
//            head partials  d_hw += act(z)^T d_h,  d_hb += sum d_h
//   no head: d_a = ct
//   d_z = d_a * act'(z), stored as d_conv [B, H, W, s*s*C] in the compute dtype,
//   with shuffle-major columns (i*s + j)*C + c: the conv output layout of the
//   packed weights, so the shuffle's inverse is the store's index arithmetic;
//   the bias partial sums the f32 d_z before that rounding.
//
// What bounds it: the bytes.  At the 720p head stage it reads z (177 MB in
// bf16) and writes d_conv (the same), with a few FLOPs per element, so it is
// memory-bound (~0.1 ms at 3.35 TB/s).  Design: a block owns `tile` low-res
// pixels and all s*s*C columns; each thread owns whole columns and walks the
// tile's pixels, so for a fixed pixel a warp reads C-contiguous z and writes
// contiguous d_conv, and a column's bias partial stays in a register.  d_h and
// the head weight sit in shared memory.  Blocks run in no order, so every
// block writes its own partials ([n_blocks, ...] f32) and the wrapper sums
// them with torch.sum afterwards, as the JAX code sums its per-tile partials
// outside the kernel: no atomics, so the gradients are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// round to the compute dtype and back (identity in f32)
template <typename T>
__device__ __forceinline__ float round_cd(float v) { return to_f32(from_f32<T>(v)); }

using repnerv::act_grad;
using repnerv::apply_act;

struct Bwd {
  int B, H, W, C, s, act, c_final, sigmoid_squash, tile;
};

// Full-resolution pixel of low-res pixel m, sub-pixel (si, sj).
__device__ __forceinline__ long long full_pixel(const Bwd& p, long long m, int si, int sj) {
  const long long HW = (long long)p.H * p.W;
  const long long bi = m / HW, rem = m % HW;
  const long long h = rem / p.W, w = rem % p.W;
  return (bi * p.H * p.s + h * p.s + si) * ((long long)p.W * p.s) + w * p.s + sj;
}

// Shared memory (f32): d_h [tile][s*s][c_final], the head weight rounded to
// the compute dtype [C][c_final], and per-column head partials [Cout][c_final].
template <typename T>
__global__ void epilogue_bwd(const T* __restrict__ z, const T* __restrict__ ct,
                             const float* __restrict__ ct_head,
                             const float* __restrict__ out, const float* __restrict__ hw,
                             T* __restrict__ d_conv, float* __restrict__ db_part,
                             float* __restrict__ dhw_part, float* __restrict__ dhb_part,
                             Bwd p) {
  extern __shared__ float smem[];
  const int s2 = p.s * p.s, cf = p.c_final, C = p.C, Cout = s2 * C;
  const bool with_head = cf > 0;
  float* dh = smem;                          // [tile][s2][cf]
  float* hwr = dh + p.tile * s2 * cf;        // [C][cf]
  float* dhw_col = hwr + C * cf;             // [Cout][cf]
  const long long M = (long long)p.B * p.H * p.W;
  const long long m0 = (long long)blockIdx.x * p.tile;
  const int n_pix = (int)min((long long)p.tile, M - m0);
  const int tid = threadIdx.x, nthreads = blockDim.x;

  if (with_head) {
    for (int e = tid; e < p.tile * s2 * cf; e += nthreads) {
      const int lp = e / (s2 * cf), sub = (e / cf) % s2, k = e % cf;
      float d = 0.f;
      if (lp < n_pix) {
        const long long q = full_pixel(p, m0 + lp, sub / p.s, sub % p.s) * cf + k;
        const float o = out[q], g = ct_head[q];
        if (p.sigmoid_squash) {
          d = g * o * (1.f - o);
        } else {
          const float u = 2.f * o - 1.f;
          d = g * 0.5f * (1.f - u * u);
        }
      }
      dh[e] = d;
    }
    for (int e = tid; e < C * cf; e += nthreads) hwr[e] = round_cd<T>(hw[e]);
    __syncthreads();
  }

  for (int col = tid; col < Cout; col += nthreads) {
    const int sub = col / C, c = col % C, si = sub / p.s, sj = sub % p.s;
    if (with_head)
      for (int k = 0; k < cf; ++k) dhw_col[col * cf + k] = 0.f;
    float db = 0.f;
    for (int lp = 0; lp < n_pix; ++lp) {
      const long long q = full_pixel(p, m0 + lp, si, sj) * C + c;
      const float zf = to_f32(z[q]);
      float da;
      if (with_head) {
        const float* d = dh + (lp * s2 + sub) * cf;
        const float a = apply_act(zf, p.act);
        da = 0.f;
        for (int k = 0; k < cf; ++k) {
          da = fmaf(round_cd<T>(d[k]), hwr[c * cf + k], da);
          dhw_col[col * cf + k] = fmaf(a, d[k], dhw_col[col * cf + k]);
        }
      } else {
        da = to_f32(ct[q]);
      }
      const float dz = da * act_grad(zf, p.act);
      d_conv[(m0 + lp) * Cout + col] = from_f32<T>(dz);
      db += dz;
    }
    db_part[(long long)blockIdx.x * Cout + col] = db;
  }

  if (with_head) {
    __syncthreads();
    // this block's head partials: sum the per-column ones over the s*s
    // sub-pixels of each channel, and d_h over the tile
    for (int e = tid; e < C * cf; e += nthreads) {
      const int c = e / cf, k = e % cf;
      float acc = 0.f;
      for (int sub = 0; sub < s2; ++sub) acc += dhw_col[(sub * C + c) * cf + k];
      dhw_part[(long long)blockIdx.x * C * cf + e] = acc;
    }
    for (int k = tid; k < cf; k += nthreads) {
      float acc = 0.f;
      for (int e = 0; e < n_pix * s2; ++e) acc += dh[e * cf + k];
      dhb_part[(long long)blockIdx.x * cf + k] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* z, const void* ct, const float* ct_head, const float* out,
                   const float* hw, void* d_conv, float* db_part, float* dhw_part,
                   float* dhb_part, Bwd p, int n_blocks, int threads, int smem_bytes,
                   cudaStream_t stream) {
  auto* fn = epilogue_bwd<T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  fn<<<n_blocks, threads, smem_bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(ct), ct_head, out, hw,
      static_cast<T*>(d_conv), db_part, dhw_part, dhb_part, p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z, ct without a head, d_conv).  c_final = 0:
// no head, ct is [B, H*s, W*s, C] in the compute dtype and ct_head, out, hw,
// dhw_part, dhb_part are unused; c_final > 0: ct_head and out are f32
// [B, H*s, W*s, c_final] and hw is f32 [C, c_final].  Partials: db_part
// [n_blocks, s*s*C], dhw_part [n_blocks, C, c_final], dhb_part [n_blocks,
// c_final], n_blocks = ceil(B*H*W / tile).  Returns the cudaError_t of the launch.
extern "C" int repnerv_train_stage_bwd(int dtype, const void* z, const void* ct,
                                       const float* ct_head, const float* out,
                                       const float* hw, void* d_conv, float* db_part,
                                       float* dhw_part, float* dhb_part, int B, int H, int W,
                                       int C, int s, int act, int c_final, int sigmoid_squash,
                                       int tile, void* stream) {
  if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Bwd p{B, H, W, C, s, act, c_final, sigmoid_squash, tile};
  const long long M = (long long)B * H * W;
  const int n_blocks = (int)((M + tile - 1) / tile);
  const int cout = s * s * C;
  const int threads = min(((cout + 31) / 32) * 32, 512);
  const int smem_bytes =
      c_final > 0 ? (tile * s * s * c_final + C * c_final + cout * c_final) * 4 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(z, ct, ct_head, out, hw, d_conv, db_part, dhw_part, dhb_part, p,
                         n_blocks, threads, smem_bytes, st);
  if (dtype == 1)
    return launch<bf16>(z, ct, ct_head, out, hw, d_conv, db_part, dhw_part, dhb_part, p,
                        n_blocks, threads, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
