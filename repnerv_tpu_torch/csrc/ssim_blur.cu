// Separable VALID gaussian blur on [N, H, W] f32 for SSIM / MS-SSIM, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repnerv_tpu/pallas_kernels/ssim_blur.py::_blur_call
// (gauss_blur_valid).  out[n, r, c] = sum_j w[j] * (sum_i w[i] * x[n, r+i, c+j]),
// the vertical taps first and then the horizontal ones, each sum taken in tap
// order as acc = w[0]*x_0, acc = acc + w[k]*x_k: the order of the slice-sum
// reference (repnerv_tpu/ops/ssim.py::_gaussian_filter).  Every product and
// every sum is rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction),
// so the kernel gives the same bits as the plain PyTorch version, which runs
// the same multiplies and adds as separate elementwise ops.  SSIM needs the
// exact f32: a rounded E[x^2] (bf16 or a TF32 conv) can push the variance
// filter(x*x) - mu^2 below -C2 and blow up the loss gradient.
//
// What bounds it: the bytes.  Each output costs 2*K multiplies and adds
// (K = 11) against 8 bytes read and written, far below the card's ~20 FLOP
// per byte f32 balance point, so one pass over memory is the floor.  Design:
// a block owns a TH x TW output tile; it loads the (TH+K-1) x (TW+K-1) input
// window into shared memory once (coalesced rows, zero past the edge), runs
// the vertical taps into a TH x (TW+K-1) shared buffer, then the horizontal
// taps, and writes only the VALID outputs: each input is read from device
// memory about once, as in the TPU kernel's one VMEM pass per row tile.
// The VJP is this kernel on the cotangent zero-padded by K-1 on each side
// (the window is symmetric), done by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32, TW = 64, THREADS = 256, MAX_K = 16;

struct Window {
  float w[MAX_K];
  int size;
};

__global__ void __launch_bounds__(THREADS)
blur_valid(const float* __restrict__ x, float* __restrict__ out, int H, int W, Window win) {
  extern __shared__ float smem[];
  const int K = win.size, halo = K - 1;
  const int in_w = TW + halo, in_h = TH + halo;
  float* wk = smem;                // [K]
  float* tile = wk + MAX_K;        // [in_h][in_w]
  float* vert = tile + in_h * in_w;  // [TH][in_w]
  const int tid = threadIdx.x;
  const int Ho = H - halo, Wo = W - halo;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const float* xn = x + (long long)blockIdx.z * H * W;
  float* on = out + (long long)blockIdx.z * Ho * Wo;

  if (tid < K) wk[tid] = win.w[tid];
  for (int e = tid; e < in_h * in_w; e += THREADS) {
    const int r = r0 + e / in_w, c = c0 + e % in_w;
    tile[e] = (r < H && c < W) ? xn[(long long)r * W + c] : 0.f;
  }
  __syncthreads();

  for (int e = tid; e < TH * in_w; e += THREADS) {
    const int r = e / in_w, c = e % in_w;
    float acc = __fmul_rn(wk[0], tile[r * in_w + c]);
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(wk[k], tile[(r + k) * in_w + c]));
    vert[e] = acc;
  }
  __syncthreads();

  for (int e = tid; e < TH * TW; e += THREADS) {
    const int r = e / TW, c = e % TW;
    if (r0 + r >= Ho || c0 + c >= Wo) continue;
    const float* v = vert + r * in_w + c;
    float acc = __fmul_rn(wk[0], v[0]);
    for (int k = 1; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(wk[k], v[k]));
    on[(long long)(r0 + r) * Wo + c0 + c] = acc;
  }
}

}  // namespace

// x [N, H, W] f32 -> out [N, H-K+1, W-K+1] f32, K = size <= 16 taps in `window`.
// Returns the cudaError_t of the launch.
extern "C" int repnerv_gauss_blur_valid(const float* x, float* out, int N, int H, int W,
                                        const float* window, int size, void* stream) {
  if (size < 1 || size > MAX_K || H < size || W < size || N < 1 || N > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Window win{};
  for (int k = 0; k < size; ++k) win.w[k] = window[k];
  win.size = size;
  const int halo = size - 1;
  const int Ho = H - halo, Wo = W - halo;
  const dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, N);
  const int smem_bytes = (MAX_K + (TH + halo) * (TW + halo) + TH * (TW + halo)) * 4;
  blur_valid<<<grid, THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(x, out, H, W,
                                                                               win);
  return static_cast<int>(cudaGetLastError());
}
