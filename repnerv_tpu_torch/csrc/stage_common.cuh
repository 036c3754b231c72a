// What the fused decode-stage kernels (decode.cu, decode_int8.cu and the
// wgmma kernels of stage_wgmma.cuh) share: the problem description, the index
// arithmetic of the SAME halo and of the pixel-shuffled store, the launch
// grid, and the wgmma kernels' launchers.
#pragma once

#include <cuda_runtime.h>

namespace repnerv {

// Everything a block needs to know about the problem and its own place in it.
struct Stage {
  int B, H, W, Cin, C, s, act, c_final, sigmoid_squash;
  int chunk_groups, chunks_per_block;
  __device__ int M() const { return B * H * W; }
};

// Output pixel index (in units of channels-rows) of GEMM row m, sub-pixel (si, sj).
__device__ __forceinline__ long long out_pixel(const Stage& st, int m, int si, int sj) {
  const int HW = st.H * st.W;
  const int bi = m / HW, rem = m % HW;
  const int h = rem / st.W, wc = rem % st.W;
  return ((long long)bi * st.H * st.s + (long long)h * st.s + si) * ((long long)st.W * st.s) +
         (long long)wc * st.s + sj;
}

// Rows are kept packed as (h << 16 | w); rows past M get an h never in bounds.
__device__ __forceinline__ int pack_row(const Stage& st, int m) {
  if (m >= st.M()) return 0x3fff << 16;
  const int r = m % (st.H * st.W);
  return ((r / st.W) << 16) | (r % st.W);
}

__device__ __forceinline__ float squash(float y, int sigmoid) {
  return sigmoid ? 1.f / (1.f + expf(-y)) : (tanhf(y) + 1.f) * 0.5f;
}

// Without a head every (sub-pixel, channel chunk) pair is its own block; with
// one, a block walks all chunks of its sub-pixel.
inline dim3 grid_for(Stage& st, int bm, int bn) {
  const int n_chunks = (st.C + bn - 1) / bn;
  st.chunk_groups = st.c_final > 0 ? 1 : n_chunks;
  st.chunks_per_block = st.c_final > 0 ? n_chunks : 1;
  const long long M = (long long)st.B * st.H * st.W;
  return dim3((unsigned)((M + bm - 1) / bm), (unsigned)(st.s * st.s * st.chunk_groups));
}

// The wgmma + TMA stage kernels, one source per operand type; each returns the
// cudaError_t and refuses (cudaErrorInvalidValue) a shape it does not take.
// bf16 (decode_wgmma.cu): wt the K-major weights [s*s*C, 9*Cin]; sx != null:
// out is the next int8 block's input, quantised with *sx
int launch_stage_wgmma(const void* x, const void* wt, const float* b, const float* head_w,
                       const float* head_b, void* out, void* z, const float* sx, int B, int H,
                       int W, int Cin, int C, int s, int act, int c_final, int sigmoid_squash,
                       cudaStream_t stream);
// f32 as three TF32 products (decode_wgmma_tf32.cu): wt split into hi and lo
int launch_stage_wgmma_tf32(const void* x, const void* wt_hi, const void* wt_lo, const float* b,
                            const float* head_w, const float* head_b, void* out, void* z, int B,
                            int H, int W, int Cin, int C, int s, int act, int c_final,
                            int sigmoid_squash, cudaStream_t stream);
// int8 (decode_wgmma_s8.cu)
int launch_stage_wgmma_s8(const void* x, const void* wt, const float* scale, const float* bias,
                          const float* inv_out, const float* head_w, const float* head_b,
                          void* out, int B, int H, int W, int Cin, int C, int s, int act,
                          int c_final, int sigmoid_squash, cudaStream_t stream);

}  // namespace repnerv
