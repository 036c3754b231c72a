// Separable gaussian blur on [N, H, W] f32 for SSIM / MS-SSIM, for Hopper
// (sm_90a): the five blurred moments of an SSIM term in one launch, their
// VJP in one launch, and the single-map blur.
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
// What bounds it: the instructions, not the bytes.  An SSIM term reads x and
// y and writes five maps (28 bytes a pixel: 0.023 ms at 720p at an H100's 3.35
// TB/s) against ~200 rounded multiplies and adds a pixel, none of which exact
// f32 lets one merge or drop: the launch takes 0.051 ms there, and 0.033 ms
// with no load at all.  So the design spends no instruction it can save:
//   * One launch makes all five maps: x*x, y*y and x*y are formed in
//     registers (__fmul_rn, as the plain version's elementwise products) and
//     never cross device memory.
//   * A block owns a TH x TW output tile.  Vertical pass: a thread owns one
//     column of the tile and walks down it, one coalesced load of x and y per
//     input row; the K sums that an input row feeds live in registers (the
//     loops are unrolled, so every index is static) and each receives its
//     taps in tap order as the rows arrive.  The window is symmetric, so
//     w[k]*v and w[K-1-k]*v are one product: K/2+1 multiplies and K-1 adds
//     per value, not K and K-1.  The finished sums go to shared memory.
//   * Horizontal pass: a thread owns a run of L adjacent outputs of one row of
//     the vertical result and slides over it the same way, one shared-memory
//     load per input (lanes on different rows of an odd stride: no bank
//     conflict).  The run's outputs go back into the same row after a block
//     barrier, and the block stores the tile with coalesced rows.
//   * The VJP of a VALID blur is the same blur of the cotangent zero-padded by
//     K-1 on each side.  The padding is never written: the column loader
//     takes coordinates that start at -(K-1) and fills what lies outside the
//     cotangent with zeros.  The moments' VJP blurs the three cotangents that
//     reach one input and combines them in the store pass,
//     d_a = B(g_mu) + 2 a B(g_sq) + b B(g_ab).

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;        // output rows of a tile; the two halves of the vertical pass
#ifdef REPNERV_PROBE_COLS  // kernels/probe_train.py: narrower tiles, more blocks an SM
constexpr int COLS = REPNERV_PROBE_COLS;
#else
constexpr int COLS = 128;     // input columns of a tile: one thread each in the vertical pass
#endif
constexpr int THREADS = 2 * COLS;  // 2 halves x COLS columns; THREADS / 32 warps x 32 rows in the horizontal pass
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 15;

struct Window {
  float w[MAX_K + 1];
};

template <int K>
struct Geometry {
  static constexpr int TW = COLS - (K - 1);          // output columns of a tile
  static constexpr int L = (TW + WARPS - 1) / WARPS;  // outputs of a horizontal run
  static constexpr int S = (WARPS * L + K - 1) | 1;   // row stride in shared memory, odd
};

// One value of a sliding 1-D correlation.  `step` is the value's place in the
// stream; the sums of outputs step-K+1 .. step are in flight in acc[o % K].
// Call with step = 0, 1, ... (unrolled: every index is a constant).
template <int K, int N_OUT>
__device__ __forceinline__ void feed(float (&acc)[K], const Window& win, float v, int step) {
  float prod[K / 2 + 1];
#pragma unroll
  for (int t = 0; t <= K / 2; ++t) prod[t] = __fmul_rn(win.w[t], v);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int o = step - k;
    if (o >= 0 && o < N_OUT) {
      const float p = prod[k <= K / 2 ? k : K - 1 - k];
      acc[o % K] = k == 0 ? p : __fadd_rn(acc[o % K], p);
    }
  }
}

// A value of the input, zero outside it.  (kernels/probe_train.py's no_loads
// variant makes the value up from its place, to time the kernel with no load.)
__device__ __forceinline__ float fetch(const float* p, long long plane, int off, bool inside) {
#ifdef REPNERV_PROBE_NO_LOADS
  return inside ? __int_as_float(0x3f000000 | (off & 0xffff)) : 0.f;
#else
  return inside ? __ldg(p + plane + off) : 0.f;
#endif
}

// The five moments of an SSIM term from x and y.
struct MomentsForward {
  static constexpr int MAPS = 5;
  const float* x;
  const float* y;
  float* out;  // [5, N, Ho, Wo]
  __device__ __forceinline__ void load(long long plane_in, int off, bool inside,
                                       float (&v)[MAPS]) const {
    const float a = fetch(x, plane_in, off, inside), b = fetch(y, plane_in, off, inside);
    v[0] = a;
    v[1] = b;
    v[2] = __fmul_rn(a, a);
    v[3] = __fmul_rn(b, b);
    v[4] = __fmul_rn(a, b);
  }
  __device__ __forceinline__ void store(long long plane_out, long long map_stride, int off,
                                        const float (&v)[MAPS]) const {
#pragma unroll
    for (int m = 0; m < MAPS; ++m) out[m * map_stride + plane_out + off] = v[m];
  }
};

// The VJP of the moments with respect to one input a (b the other):
// d_a = B(g_mu) + 2 a B(g_sq) + b B(g_ab), B the zero-padded blur.
struct MomentsVjp {
  static constexpr int MAPS = 3;
  const float* g_mu;
  const float* g_sq;
  const float* g_ab;
  const float* a;
  const float* b;
  float* d;  // [N, H, W]
  __device__ __forceinline__ void load(long long plane_in, int off, bool inside,
                                       float (&v)[MAPS]) const {
    v[0] = fetch(g_mu, plane_in, off, inside);
    v[1] = fetch(g_sq, plane_in, off, inside);
    v[2] = fetch(g_ab, plane_in, off, inside);
  }
  __device__ __forceinline__ void store(long long plane_out, long long, int off,
                                        const float (&v)[MAPS]) const {
    const float av = __ldg(a + plane_out + off), bv = __ldg(b + plane_out + off);
    const float sq = __fmul_rn(2.f, __fmul_rn(v[1], av));  // g*a + g*a, exactly
    d[plane_out + off] = __fadd_rn(__fadd_rn(v[0], sq), __fmul_rn(v[2], bv));
  }
};

// One map: gauss_blur_valid and, with pad = K-1, its VJP.
struct SingleMap {
  static constexpr int MAPS = 1;
  const float* x;
  float* out;
  __device__ __forceinline__ void load(long long plane_in, int off, bool inside,
                                       float (&v)[MAPS]) const {
    v[0] = fetch(x, plane_in, off, inside);
  }
  __device__ __forceinline__ void store(long long plane_out, long long, int off,
                                        const float (&v)[MAPS]) const {
    out[plane_out + off] = v[0];
  }
};

// Input [N, Hi, Wi] (zero outside), output [N, Ho, Wo] with Ho = Hi + 2 pad -
// K + 1; output (r, c) reads input rows r - pad .. r - pad + K - 1.
template <int K, class Op>
__global__ void __launch_bounds__(THREADS, 256 / COLS)
blur_tiles(Op op, int Hi, int Wi, int Ho, int Wo, int pad, Window win) {
  using G = Geometry<K>;
  constexpr int MAPS = Op::MAPS, R = TH / 2;
  extern __shared__ float vert[];  // [MAPS][TH][S]
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * G::TW;
  const long long plane_in = (long long)blockIdx.z * Hi * Wi;
  const long long plane_out = (long long)blockIdx.z * Ho * Wo;

  {  // vertical pass: thread = (half of the rows, column)
    const int col = tid % COLS, half = tid / COLS;
    const int gc = c0 + col - pad, gr0 = r0 + half * R - pad;
    const bool col_inside = gc >= 0 && gc < Wi;
    float acc[MAPS][K];
#pragma unroll
    for (int j = 0; j < R + K - 1; ++j) {
      const int gr = gr0 + j;
      float v[MAPS];
      op.load(plane_in, gr * Wi + gc, col_inside && gr >= 0 && gr < Hi, v);
#pragma unroll
      for (int m = 0; m < MAPS; ++m) {
        feed<K, R>(acc[m], win, v[m], j);
        if (j >= K - 1)
          vert[(m * TH + half * R + j - (K - 1)) * G::S + col] = acc[m][(j - (K - 1)) % K];
      }
    }
  }
  __syncthreads();

#ifndef REPNERV_PROBE_NO_HORIZONTAL  // kernels/probe_train.py: the column pass and the stores alone
  {  // horizontal pass: thread = (run of L columns, row); results in place
    const int lane = tid % 32, seg = tid / 32;
#pragma unroll 1
    for (int m = 0; m < MAPS; ++m) {
      float* row = vert + (m * TH + lane) * G::S + seg * G::L;
      float acc[K], res[G::L];
#pragma unroll
      for (int j = 0; j < G::L + K - 1; ++j) {
        feed<K, G::L>(acc, win, row[j], j);
        if (j >= K - 1) res[j - (K - 1)] = acc[(j - (K - 1)) % K];
      }
      __syncthreads();  // every run of this map is read before any is overwritten
#pragma unroll
      for (int o = 0; o < G::L; ++o) row[o] = res[o];
    }
  }
  __syncthreads();
#endif

  // store pass: warp = row, lanes = adjacent columns
  const long long map_stride = (long long)gridDim.z * Ho * Wo;
  for (int r = tid / 32; r < TH && r0 + r < Ho; r += WARPS) {
    for (int c = tid % 32; c < G::TW && c0 + c < Wo; c += 32) {
      float v[MAPS];
#pragma unroll
      for (int m = 0; m < MAPS; ++m) v[m] = vert[(m * TH + r) * G::S + c];
      op.store(plane_out, map_stride, (r0 + r) * Wo + c0 + c, v);
    }
  }
}

template <int K, class Op>
cudaError_t launch_k(const Op& op, int N, int Hi, int Wi, int pad, const Window& win,
                     cudaStream_t stream) {
  using G = Geometry<K>;
  const int Ho = Hi + 2 * pad - (K - 1), Wo = Wi + 2 * pad - (K - 1);
  const int smem_bytes = Op::MAPS * TH * G::S * 4;
  auto* fn = blur_tiles<K, Op>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Wo + G::TW - 1) / G::TW, (Ho + TH - 1) / TH, N);
  fn<<<grid, THREADS, smem_bytes, stream>>>(op, Hi, Wi, Ho, Wo, pad, win);
  return cudaGetLastError();
}

// Odd windows of 3 to 15 taps, symmetric (the wrapper checks): input
// [N, Hi, Wi], pad 0 (VALID) or size - 1 (the VJP's zero padding).
template <class Op>
int launch(const Op& op, int N, int Hi, int Wi, int pad, const float* window, int size,
           void* stream) {
  if (size < 3 || size > MAX_K || size % 2 == 0 || N < 1 || N > 65535 ||
      (pad != 0 && pad != size - 1) || Hi < 1 || Wi < 1 || Hi + 2 * pad < size ||
      Wi + 2 * pad < size)
    return static_cast<int>(cudaErrorInvalidValue);
  Window win{};
  for (int k = 0; k < size; ++k) win.w[k] = window[k];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (size) {
    case 3: err = launch_k<3>(op, N, Hi, Wi, pad, win, st); break;
    case 5: err = launch_k<5>(op, N, Hi, Wi, pad, win, st); break;
    case 7: err = launch_k<7>(op, N, Hi, Wi, pad, win, st); break;
    case 9: err = launch_k<9>(op, N, Hi, Wi, pad, win, st); break;
    case 11: err = launch_k<11>(op, N, Hi, Wi, pad, win, st); break;
    case 13: err = launch_k<13>(op, N, Hi, Wi, pad, win, st); break;
    case 15: err = launch_k<15>(op, N, Hi, Wi, pad, win, st); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// x, y [N, H, W] f32 -> out [5, N, H-K+1, W-K+1] f32: the VALID blurs of x, y,
// x*x, y*y, x*y.  `window`: K = size host floats.  All entry points return the
// cudaError_t of the launch.
extern "C" int repnerv_ssim_moments(const float* x, const float* y, float* out, int N, int H,
                                    int W, const float* window, int size, void* stream) {
  return launch(MomentsForward{x, y, out}, N, H, W, 0, window, size, stream);
}

// Cotangents g_mu, g_sq, g_ab [N, H-K+1, W-K+1] of blur(a), blur(a*a),
// blur(a*b); a, b [N, H, W] -> d [N, H, W], the gradient with respect to a.
extern "C" int repnerv_ssim_moments_vjp(const float* g_mu, const float* g_sq, const float* g_ab,
                                        const float* a, const float* b, float* d, int N, int H,
                                        int W, const float* window, int size, void* stream) {
  return launch(MomentsVjp{g_mu, g_sq, g_ab, a, b, d}, N, H - (size - 1), W - (size - 1),
                size - 1, window, size, stream);
}

// x [N, H, W] f32 -> out [N, H-K+1, W-K+1] (full = 0: the VALID blur) or
// [N, H+K-1, W+K-1] (full = 1: the blur of x zero-padded by K-1, its VJP).
extern "C" int repnerv_gauss_blur_valid(const float* x, float* out, int N, int H, int W,
                                        const float* window, int size, int full, void* stream) {
  return launch(SingleMap{x, out}, N, H, W, full ? size - 1 : 0, window, size, stream);
}
