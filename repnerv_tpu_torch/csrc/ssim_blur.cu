// Separable gaussian blur on [N, H, W] f32 for SSIM / MS-SSIM, for Hopper
// (sm_90a): an SSIM term's per-plane SSIM and cs means in one launch (the
// five blurred moments formed, and kept only for a backward), their VJP in one
// launch, and the single-map blur.
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
// y and, for a backward, writes five maps (28 bytes a pixel at most: 0.023 ms
// at 720p at an H100's 3.35 TB/s) against ~200 rounded multiplies and adds a
// pixel, none of which exact f32 lets one merge or drop: a launch that
// writes the five maps takes 0.051 ms there, and 0.033 ms with no load at
// all.  So the design spends no instruction it can save:
//   * One launch blurs all five moments: x*x, y*y and x*y are formed in
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
//   * The SSIM formula runs where the moments are in registers.  The forward
//     (SsimStats) reads the NHWC images in place (plane n = channel n % C),
//     forms sigma, cs and ssim per pixel in the store pass, with
//     the rounded operations of the plain formula (ops/ssim.py), and sums
//     both per block in a fixed order (each thread's pixels in its loop
//     order, then the lanes of a warp by shuffles, then the warps in order):
//     no float atomics, so a launch gives the same bits every time.  Each
//     block writes its two sums over H*W; the caller adds a plane's blocks.
//     The backward (SsimGrad) forms the three cotangents of the moments in
//     the loader, from the five saved moments and the plane's two upstream
//     scalars, runs the moments' VJP on them, and writes the gradient in the
//     images' layout.

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

// d_a = B(g_mu) + 2 a B(g_sq) + b B(g_ab) from the blurred cotangents v: the
// store pass of the moments' VJP.
__device__ __forceinline__ float combine(const float* a, const float* b, long long at,
                                         const float (&v)[3]) {
  const float av = __ldg(a + at), bv = __ldg(b + at);
  const float sq = __fmul_rn(2.f, __fmul_rn(v[1], av));  // g*a + g*a, exactly
  return __fadd_rn(__fadd_rn(v[0], sq), __fmul_rn(v[2], bv));
}

// Where an SSIM term's inputs lie: [N / C, H, W, C] images, plane n their
// channel n % C (C = 1: [N, H, W] planes), read and written in place.
__device__ __forceinline__ long long image_base(int channels, long long plane_size) {
  return blockIdx.z / channels * plane_size * channels + blockIdx.z % channels;
}

// The per-plane means of the SSIM and cs maps of images x and y, as
// [2, N, tiles] partial sums over Ho*Wo, one a block; with `moments` not null,
// the five moments too ([5, N, Ho, Wo] planes, for the backward).
struct SsimStats {
  static constexpr int MAPS = 5;
  const float* x;
  const float* y;
  float* moments;  // null: the maps are not stored
  float* partial;  // [2, N, tiles]
  int channels;
  float c1, c2, hw;
  long long base;          // this plane's first value in x and y
  float ssim_sum, cs_sum;  // this thread's pixels
  __device__ __forceinline__ void begin(long long hw_in, long long) {
    base = image_base(channels, hw_in);
    ssim_sum = cs_sum = 0.f;
  }
  __device__ __forceinline__ void load(long long, int off, bool inside, float (&v)[MAPS]) const {
    const float a = fetch(x, base, off * channels, inside);
    const float b = fetch(y, base, off * channels, inside);
    v[0] = a;
    v[1] = b;
    v[2] = __fmul_rn(a, a);
    v[3] = __fmul_rn(b, b);
    v[4] = __fmul_rn(a, b);
  }
  // The plain formula's operations, each rounded on its own:
  // cs = (2 s12 + C2) / (s11 + s22 + C2), ssim = (2 m12 + C1) / (m11 + m22 + C1) * cs.
  __device__ __forceinline__ void store(long long plane_out, long long map_stride, int off,
                                        const float (&v)[MAPS]) {
    if (moments != nullptr) {
#pragma unroll
      for (int m = 0; m < MAPS; ++m) moments[m * map_stride + plane_out + off] = v[m];
    }
    const float m11 = __fmul_rn(v[0], v[0]), m22 = __fmul_rn(v[1], v[1]),
                m12 = __fmul_rn(v[0], v[1]);
    const float s11 = __fsub_rn(v[2], m11), s22 = __fsub_rn(v[3], m22), s12 = __fsub_rn(v[4], m12);
    const float cs = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, s12), c2),
                               __fadd_rn(__fadd_rn(s11, s22), c2));
    const float lum = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, m12), c1),
                                __fadd_rn(__fadd_rn(m11, m22), c1));
    ssim_sum = __fadd_rn(ssim_sum, __fmul_rn(lum, cs));
    cs_sum = __fadd_rn(cs_sum, cs);
  }
  // The block's two sums in a fixed order; `scratch` is the tile's shared
  // memory, free once every thread has stored.
  __device__ __forceinline__ void finish(float* scratch) {
    float s = ssim_sum, c = cs_sum;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
      c = __fadd_rn(c, __shfl_down_sync(0xffffffffu, c, o));
    }
    __syncthreads();  // the store pass has read the tile
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) {
      scratch[2 * warp] = s;
      scratch[2 * warp + 1] = c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w) {
        s = __fadd_rn(s, scratch[2 * w]);
        c = __fadd_rn(c, scratch[2 * w + 1]);
      }
      const long long tiles = (long long)gridDim.x * gridDim.y;
      const long long at = blockIdx.z * tiles + blockIdx.y * gridDim.x + blockIdx.x;
      partial[at] = __fdiv_rn(s, hw);
      partial[gridDim.z * tiles + at] = __fdiv_rn(c, hw);
    }
  }
};

// The VJP of the per-plane means g_ssim[n] * mean(ssim) + g_cs[n] * mean(cs)
// with respect to one input image a (b the other; mu_a .. e_ab the saved
// moments of the pair in that order).  The loader forms the cotangents of
// blur(a), blur(a*a) and blur(a*b) from the moments; zero outside them, as
// the padding.
struct SsimGrad {
  static constexpr int MAPS = 3;
  const float* mu_a;
  const float* mu_b;
  const float* e_aa;
  const float* e_bb;
  const float* e_ab;  // [N, Hi, Wi] planes
  const float* g_ssim;
  const float* g_cs;  // [N]
  const float* a;
  const float* b;
  float* d;  // images, as a
  int channels;
  float c1, c2, hw;
  long long base;  // this plane's first value in a, b and d
  float gs, gc;    // this plane's upstream scalars over hw
  __device__ __forceinline__ void begin(long long, long long hw_out) {
    base = image_base(channels, hw_out);
    gs = __fdiv_rn(__ldg(g_ssim + blockIdx.z), hw);
    gc = __fdiv_rn(__ldg(g_cs + blockIdx.z), hw);
  }
  __device__ __forceinline__ void finish(float*) {}
  // With l = (2 m_ab + C1) / b1, cs = (2 s_ab + C2) / b2 and t = (gs l + gc) / b2:
  // g_mu = 2 (gs cs (mu_b - l mu_a) / b1 + t (cs mu_a - mu_b)),
  // g_sq = -t cs, g_ab = 2 t.
  __device__ __forceinline__ void load(long long plane_in, int off, bool inside,
                                       float (&v)[MAPS]) const {
    const float ma = fetch(mu_a, plane_in, off, inside), mb = fetch(mu_b, plane_in, off, inside);
    const float eaa = fetch(e_aa, plane_in, off, inside), ebb = fetch(e_bb, plane_in, off, inside);
    const float eab = fetch(e_ab, plane_in, off, inside);
    const float m_aa = __fmul_rn(ma, ma), m_bb = __fmul_rn(mb, mb), m_ab = __fmul_rn(ma, mb);
    const float b1 = __fadd_rn(__fadd_rn(m_aa, m_bb), c1);
    const float b2 = __fadd_rn(__fadd_rn(__fsub_rn(eaa, m_aa), __fsub_rn(ebb, m_bb)), c2);
    const float l = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, m_ab), c1), b1);
    const float cs = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, __fsub_rn(eab, m_ab)), c2), b2);
    const float t = __fdiv_rn(__fadd_rn(__fmul_rn(gs, l), gc), b2);
    const float lum_part =
        __fdiv_rn(__fmul_rn(__fmul_rn(gs, cs), __fsub_rn(mb, __fmul_rn(l, ma))), b1);
    const float cs_part = __fmul_rn(t, __fsub_rn(__fmul_rn(cs, ma), mb));
    v[0] = inside ? __fmul_rn(2.f, __fadd_rn(lum_part, cs_part)) : 0.f;
    v[1] = inside ? -__fmul_rn(t, cs) : 0.f;
    v[2] = inside ? __fmul_rn(2.f, t) : 0.f;
  }
  __device__ __forceinline__ void store(long long, long long, int off,
                                        const float (&v)[MAPS]) const {
    const long long at = base + (long long)off * channels;
    d[at] = combine(a, b, at, v);
  }
};

// One map: gauss_blur_valid and, with pad = K-1, its VJP.
struct SingleMap {
  static constexpr int MAPS = 1;
  __device__ __forceinline__ void begin(long long, long long) {}
  __device__ __forceinline__ void finish(float*) {}
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
  op.begin((long long)Hi * Wi, (long long)Ho * Wo);  // an Op's own work once a block, if any

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
  op.finish(vert);  // after every thread's stores; vert is free
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

// All entry points return the cudaError_t of the launch; `window`: K = size
// host floats.

// x, y [N / C, H, W, C] f32 images (C = channels; N planes, plane n channel
// n % C) -> partial [2, N, tiles] f32: each block's sums of the SSIM map and
// of the cs map over (H-K+1)(W-K+1), so that a plane's blocks add up to its
// two means; moments: null, or [5, N, H-K+1, W-K+1], the VALID blurs of the
// planes' x, y, x*x, y*y, x*y.  c1, c2: the SSIM constants.  `tiles`, the
// caller's count of a plane's blocks, has to be the launch's:
// ceil((W-K+1) / (COLS-K+1)) * ceil((H-K+1) / TH).
extern "C" int repnerv_ssim_stats(const float* x, const float* y, float* moments, float* partial,
                                  int N, int H, int W, int channels, int tiles,
                                  const float* window, int size, float c1, float c2,
                                  void* stream) {
  const int ho = H - size + 1, wo = W - size + 1, tw = COLS - (size - 1);  // Geometry<size>::TW
  if (channels < 1 || N % channels != 0 || ho < 1 || wo < 1 ||
      tiles != ((wo + tw - 1) / tw) * ((ho + TH - 1) / TH))
    return static_cast<int>(cudaErrorInvalidValue);
  const float hw = static_cast<float>(static_cast<long long>(ho) * wo);
  return launch(SsimStats{x, y, moments, partial, channels, c1, c2, hw}, N, H, W, 0, window, size,
                stream);
}

// The moments mu_a, mu_b, e_aa, e_bb, e_ab [N, H-K+1, W-K+1] of a pair of
// inputs (a first) as repnerv_ssim_stats keeps them, the cotangents g_ssim,
// g_cs [N] of its two means; a, b [N / C, H, W, C] images -> d, the gradient
// with respect to a, in their layout.
extern "C" int repnerv_ssim_stats_vjp(const float* mu_a, const float* mu_b, const float* e_aa,
                                      const float* e_bb, const float* e_ab, const float* g_ssim,
                                      const float* g_cs, const float* a, const float* b, float* d,
                                      int N, int H, int W, int channels, const float* window,
                                      int size, float c1, float c2, void* stream) {
  if (channels < 1 || N % channels != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int hi = H - (size - 1), wi = W - (size - 1);
  const float hw = static_cast<float>(static_cast<long long>(hi) * wi);
  return launch(SsimGrad{mu_a, mu_b, e_aa, e_bb, e_ab, g_ssim, g_cs, a, b, d, channels, c1, c2, hw},
                N, hi, wi, size - 1, window, size, stream);
}

// x [N, H, W] f32 -> out [N, H-K+1, W-K+1] (full = 0: the VALID blur) or
// [N, H+K-1, W+K-1] (full = 1: the blur of x zero-padded by K-1, its VJP).
extern "C" int repnerv_gauss_blur_valid(const float* x, float* out, int N, int H, int W,
                                        const float* window, int size, int full, void* stream) {
  return launch(SingleMap{x, out}, N, H, W, full ? size - 1 : 0, window, size, stream);
}
