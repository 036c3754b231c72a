// ERB's online reparameterisation for Hopper (sm_90a): a block's branch
// fusion in two launches and its VJP in two, in exact f32 on the FMA pipes.
//
// The TPU package folds the branches with plain jnp.einsum
// (repnerv_tpu/models/reparam.py::fuse_erb); there is no TPU kernel.  With
// w1 [M, I] (the bias-free 1x1 to M = 2I channels), w2 [Om, M, 3, 3] and
// w3 [Oo, Om] (the bias-free 1x1 back), the fused kernel is
//   T = w2 . w1                 [Om, I, 3, 3]  (contract m)
//   K = w3x3 + pad(w1x3) + pad(w3x1) + w3 . T   [Oo, I, 3, 3]  (contract p)
//   b = b3x3 + b1x3 + b3x1
// and its VJP, from dK and db,
//   dw3 = dK (x) T over (i, u, v)       dT = w3^T . dK
//   dw2 = dT (x) w1^T over i            dw1 = w2 (x) dT over (p, u, v)
//   dw3x3 = dK, dw1x3 / dw3x1 its centre row / column, each bias's = db.
// Every contraction is a small f32 GEMM (at most 1200 x 1200 x 1200), so the
// library's way (permute copies, a cuBLAS call per einsum, autograd's
// elementwise backward ops: ~10 kernels a block each way) spends its time on
// launches and copies, not on the ~0.1-0.6 GFLOP a block.  Here:
//   * One kernel, erb_fold_tiles<BM, BN>, runs up to four GEMM problems and a
//     list of elementwise copies in one launch.  A problem is described by
//     index maps, so the operands are read where they lie (OIHW weights, the
//     [Om, I, 9] and [Om, 9, I] intermediates) and no permuted copy is made:
//       C[r, c] = sum over k of A[r, k] B[k, c]
//     A[r, k] = a[at(a_outer, r) + at(a_k, k)], B[k, c] = b[at(b_k, k) +
//     at(b_outer, c)], C[r, c] = c[at(c_row, r) + at(c_col, c)], where an
//     Index maps x to (x / div) hi + (x % div) lo: one stride, or two for a
//     pair such as (p, uv).
//     The launches: forward (1) T, with the bias sum and the zeroing of the
//     later launches' tickets beside it; (2) K, the three small kernels' sum
//     (fuse_erb's order) plus the products.  VJP (1) dw3 and dT, with
//     the copies of dK and db into the five direct gradients beside them;
//     (2) dw2 and dw1.
//   * A block owns a BM x BN tile of C and a thread a 4 x 4 part of it, with
//     BK = 16 values of k a step, staged through registers into a double
//     buffer in shared memory (one barrier a step).  The loads walk along
//     whichever index has unit stride, 16 bytes a load where they can.
//   * Too few tiles to fill the card (dw1 is [M, I] with k = 9 Om), or too
//     many k steps for one block: the k steps are split over `splits`
//     blocks; each writes its partial tile to its own slot, and the last to
//     finish (a ticket from an atomicAdd after __threadfence) adds the slots
//     in split order and writes C, so the result does not depend on the
//     order the blocks ran in.  The tickets go back to 0.
//   * Exact f32 on the FMA pipes: no TF32 or bf16 operand rounding (a
//     wgmma's truncating f32 accumulation drifts, see PERF.md).  A step's 16
//     products are summed on their own and then added to the running sum,
//     which keeps a long k range within the library's rounding error.
// What bounds it at these sizes is latency, not the FMA pipes: a block holds
// its SM slot for ~5 us of fixed cost (parameters, first loads, stores) and
// ~0.6 us a k step, where the step's FMAs alone take 0.1-0.3 us (PERF.md
// §6).  So the plan trades tiles against splits, and the caller runs the
// launches on a stream of their own, where the VJP overlaps the rest of the
// backward (kernels/reparam_fuse.py).
// kernels/reparam_fuse.py builds the problem lists, chooses each launch's
// tile and splits, and holds the plain version of the same descriptors.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;
constexpr int PAD = 4;  // floats after each shared row: keeps rows 16-byte aligned
constexpr int MAX_GEMMS = 4;
constexpr int MAX_COPIES = 6;
constexpr int GEMM_FIELDS = 28;  // int64 values of one problem's host record
constexpr int COPY_FIELDS = 11;
constexpr int AUX_PER_THREAD = 8;  // copied values a thread of an aux block

// An index x lies at (x / div) hi + (x % div) lo elements from the start:
// one stride (div 1), or two for an index that runs over a pair such as
// (p, uv) of an [Om, ., 9] tensor.
struct Index {
  int div, hi, lo;
};

__device__ __forceinline__ int at(const Index& ix, int x) {
  if (ix.div == 1) return x * ix.hi;
  const int q = x / ix.div;
  return q * ix.hi + (x - q * ix.div) * ix.lo;
}

// A[r, k] at a[at(a_outer, r) + at(a_k, k)], B[k, c] at b[at(b_k, k) +
// at(b_outer, c)], C[r, c] at c[at(c_row, r) + at(c_col, c)]
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  float* work;  // splits > 1: partial tiles [tiles, splits, BM, BN]
  int* ticket;  // splits > 1: one a tile, 0 at the launch
  Index a_outer, a_k, b_outer, b_k, c_row, c_col;
  int rows, cols, k, splits, epi;
  int a_mode, b_mode;  // how the loaders walk (Slab's Mode), set by the launcher
  int tiles_m, tiles_n, steps, first;  // set by the launcher
};

// dst[e] = ((src0[o] + src1[o]) + src2[o]) (the sources that are not null),
// o = base + i0 s0 + i1 s1 + i2 s2 for e = (i0 d1 + i1) d2 + i2 < n
struct Copy {
  const float* src[3];
  float* dst;
  long long s0, s1, s2, base;
  int n, first, d1, d2;
};

// epi 1: C[o, n] = ((w33[o, n] + pad(w13)[o, n]) + pad(w31)[o, n]) + products,
// n = (i, u, v) over [cin, 3, 3]; the small kernels contiguous
struct Fold {
  const float* w33;
  const float* w13;
  const float* w31;
  int cin;
};

struct Params {
  Gemm g[MAX_GEMMS];
  Copy cp[MAX_COPIES];
  Fold fold;
  int* zero;
  int n_zero, copy_elems, n_gemm, n_copy, gemm_blocks;
};

// epi 1's base of C[r, c]: ((w33 + pad(w13)) + pad(w31))[r, c], fuse_erb's
// sum of the three small kernels, which C = base + products adds last
__device__ __forceinline__ float fold_base(const Fold& f, int r, int c) {
  const int i = c / 9, uv = c - 9 * i, u = uv / 3, v = uv - 3 * u;
  const long long row3 = 3LL * f.cin * r + 3 * i;
  float base = __ldg(f.w33 + 9LL * f.cin * r + c);
  base = base + (u == 1 ? __ldg(f.w13 + row3 + v) : 0.0f);
  return base + (v == 1 ? __ldg(f.w31 + row3 + u) : 0.0f);
}

__device__ void aux_work(const Params& p, int block, int blocks, int nt) {
  const int stride = blocks * nt, start = block * nt + threadIdx.x;
  for (int e = start; e < p.n_zero; e += stride) p.zero[e] = 0;
  for (int e = start; e < p.copy_elems; e += stride) {
    int ci = 0;
    while (ci + 1 < p.n_copy && e >= p.cp[ci + 1].first) ++ci;
    const Copy& cp = p.cp[ci];
    const int l = e - cp.first, d12 = cp.d1 * cp.d2;
    const int i0 = l / d12, rem = l - i0 * d12;
    const int i1 = rem / cp.d2, i2 = rem - i1 * cp.d2;
    const long long o = cp.base + i0 * cp.s0 + i1 * cp.s1 + i2 * cp.s2;
    float v = __ldg(cp.src[0] + o);
    if (cp.src[1] != nullptr) v = v + __ldg(cp.src[1] + o);
    if (cp.src[2] != nullptr) v = v + __ldg(cp.src[2] + o);
    cp.dst[l] = v;
  }
}

// One operand's loads of a BK x BO slab a step, staged through L registers
// a thread into shared memory (k-major: s[k][outer]).  The loads walk along
// whichever index has unit stride, 16 bytes a load where the rows are
// 16-byte aligned and whole, 4 bytes otherwise; zeros outside the matrix.
//   K4 (k unit, 16-byte): a thread's j-th float4 is k = 4 (tid % (BK / 4))
//       .. +3 of outer index tid / (BK / 4) + j NT * 4 / BK, stored as four
//       columns of s.
//   O4 (outer unit, 16-byte): outer 4 (tid % (BO / 4)) .. +3 at k = tid /
//       (BO / 4) + j NT * 4 / BO, one 16-byte store.
//   K1 (k unit): k = tid % BK, outer tid / BK + j NT / BK.
//   O1 (outer unit or neither): outer tid % BO, k = tid / BO + j NT / BO.
// Every mode's address of value (or float4) j is a base plus j fixed steps
// but for K1 / O1 with a two-stride index, which the launcher does not pair
// with them.
enum Mode { K4 = 0, O4 = 1, K1 = 2, O1 = 3 };

template <int BO, int NT, int L>
struct Slab {
  static_assert(L % 4 == 0, "16-byte modes stage whole float4s");
  const float* p;
  Index k_ix;
  long long base, step;  // offset of value 0 at k = 0, and from value j to j + 1
  int k_total, kk, o, n_in, mode;

  __device__ void init(const float* ptr, const Index& outer, const Index& k, int m, int o0,
                       int n_outer, int k_n, int tid) {
    p = ptr;
    k_ix = k;
    k_total = k_n;
    mode = m;
    if (mode == K4 || mode == K1) {  // outer has one stride here
      constexpr int KW = BK / 4;
      const int per = mode == K4 ? NT / KW : NT / BK;  // outer indices a round of the block
      kk = mode == K4 ? 4 * (tid % KW) : tid % BK;
      o = mode == K4 ? tid / KW : tid / BK;
      const int first = o0 + o;
      n_in = first < n_outer ? (n_outer - first + per - 1) / per : 0;
      base = static_cast<long long>(first) * outer.hi;
      step = static_cast<long long>(per) * outer.hi;
    } else {  // k has one stride here
      constexpr int OW = BO / 4;
      o = mode == O4 ? 4 * (tid % OW) : tid % BO;
      kk = mode == O4 ? tid / OW : tid / BO;
      const int first = o0 + o;
      n_in = first < n_outer;
      base = first < n_outer ? at(outer, first) : 0;
      step = static_cast<long long>(mode == O4 ? NT / OW : NT / BO) * k.hi;
    }
  }

  __device__ void load(int k0, float (&r)[L]) const {
    if (mode == K4) {
      const int k = k0 + kk;
      const float* q = p + base + k;
#pragma unroll
      for (int j = 0; j < L / 4; ++j) {
        const float4 v = j < n_in && k < k_total ? __ldg(reinterpret_cast<const float4*>(q + j * step))
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        r[4 * j] = v.x, r[4 * j + 1] = v.y, r[4 * j + 2] = v.z, r[4 * j + 3] = v.w;
      }
    } else if (mode == O4) {
      const float* q = p + base + static_cast<long long>(k0 + kk) * k_ix.hi;
#pragma unroll
      for (int j = 0; j < L / 4; ++j) {
        const bool ok = n_in && k0 + kk + j * (NT * 4 / BO) < k_total;
        const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(q + j * step))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        r[4 * j] = v.x, r[4 * j + 1] = v.y, r[4 * j + 2] = v.z, r[4 * j + 3] = v.w;
      }
    } else if (mode == K1) {
      const int k = k0 + kk;
      const bool k_in = k < k_total;
      const float* q = p + base + (k_in ? at(k_ix, k) : 0);
#pragma unroll
      for (int j = 0; j < L; ++j) r[j] = k_in && j < n_in ? __ldg(q + j * step) : 0.0f;
    } else {
      const float* q = p + base + static_cast<long long>(k0 + kk) * k_ix.hi;
#pragma unroll
      for (int j = 0; j < L; ++j)
        r[j] = n_in && k0 + kk + j * (NT / BO) < k_total ? __ldg(q + j * step) : 0.0f;
    }
  }

  __device__ void stage(float (*s)[BO + PAD], const float (&r)[L]) const {
    if (mode == K4) {
#pragma unroll
      for (int j = 0; j < L / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kk + e][o + j * (NT * 4 / BK)] = r[4 * j + e];
      }
    } else if (mode == O4) {
#pragma unroll
      for (int j = 0; j < L / 4; ++j)
        *reinterpret_cast<float4*>(&s[kk + j * (NT * 4 / BO)][o]) =
            make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
    } else if (mode == K1) {
#pragma unroll
      for (int j = 0; j < L; ++j) s[kk][o + j * (NT / BK)] = r[j];
    } else {
#pragma unroll
      for (int j = 0; j < L; ++j) s[kk + j * (NT / BO)][o] = r[j];
    }
  }
};

// A block of (BM / 4) x (BN / 4) threads owns a BM x BN tile of C and a
// thread a 4 x 4 part of it: rows 4 ty .. +3, columns 4 tx .. +3, so that a
// step of k reads each fragment as one 16-byte shared load, broadcast over
// a quarter-warp for A and one contiguous 128-byte row for B.  Two register
// sets stage the loads: those of step t + 2 go out while step t is
// multiplied, and those of step t + 1, in since the step before, go to the
// other shared buffer after it.
template <int BM, int BN>
__global__ void __launch_bounds__((BM / 4) * (BN / 4), 512 / ((BM / 4) * (BN / 4)))
    erb_fold_tiles(const __grid_constant__ Params p) {
  constexpr int NT = (BM / 4) * (BN / 4);
  constexpr int LA = BM * BK / NT;  // A values a thread stages a step
  constexpr int LB = BN * BK / NT;
  static_assert(NT % BK == 0 && NT % BM == 0 && NT % BN == 0 && 4 * BM >= NT && 4 * BN >= NT,
                "tile");
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= p.gemm_blocks) {
    aux_work(p, blockIdx.x - p.gemm_blocks, gridDim.x - p.gemm_blocks, NT);
    return;
  }
  // the block's problem, copied into registers with constant indices (a
  // parameter read at a computed index is slow, and one through a reference
  // could alias the shared stores and be read again each step)
  const int b = blockIdx.x;
  const Gemm g = p.n_gemm > 1 && b >= p.g[1].first
                     ? (p.n_gemm > 2 && b >= p.g[2].first
                            ? (p.n_gemm > 3 && b >= p.g[3].first ? p.g[3] : p.g[2])
                            : p.g[1])
                     : p.g[0];
  const Fold fold = p.fold;

  const int local = blockIdx.x - g.first;
  const int split = local % g.splits, tile = local / g.splits;
  const int tn = tile % g.tiles_n, tm = tile / g.tiles_n;
  const int r0 = tm * BM, c0 = tn * BN;
  const int t_begin = static_cast<int>(static_cast<long long>(g.steps) * split / g.splits);
  const int t_end = static_cast<int>(static_cast<long long>(g.steps) * (split + 1) / g.splits);

  Slab<BM, NT, LA> sa;
  Slab<BN, NT, LB> sb;
  sa.init(g.a, g.a_outer, g.a_k, g.a_mode, r0, g.rows, g.k, tid);
  sb.init(g.b, g.b_outer, g.b_k, g.b_mode, c0, g.cols, g.k, tid);
  float ra[LA], rb[LB];

  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  const int rt = r0 + ty * 4, ct = c0 + tx * 4;  // the thread's first row and column
  // epi 1 with one split: the small kernels' sum, loaded now so that its
  // loads overlap the operands' first ones, and added as C = base + products
  const bool early = g.epi == 1 && g.splits == 1;
  float base[4][4], acc[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      base[i][j] = early && rt + i < g.rows && ct + j < g.cols ? fold_base(fold, rt + i, ct + j)
                                                               : 0.0f;
  }
  // a step's BK products are summed on their own and then added to acc, so
  // that a long k range rounds like a two-level sum, not one long chain
  auto multiply = [&](int buf) {
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + part[i][j];
    }
  };
  sa.load(t_begin * BK, ra);
  sb.load(t_begin * BK, rb);
  sa.stage(As[0], ra);
  sb.stage(Bs[0], rb);
  __syncthreads();
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      sa.load((t + 1) * BK, ra);
      sb.load((t + 1) * BK, rb);
    }
    multiply(buf);
    if (t + 1 < t_end) {
      sa.stage(As[buf ^ 1], ra);
      sb.stage(Bs[buf ^ 1], rb);
    }
    __syncthreads();
  }

  if (g.splits == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rt + i >= g.rows) continue;
      const int row = at(g.c_row, rt + i);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ct + j < g.cols) g.c[row + at(g.c_col, ct + j)] = early ? base[i][j] + acc[i][j]
                                                                    : acc[i][j];
      }
    }
    return;
  }

  // split k: the block's partial tile goes to its slot of the tile's
  // [splits, BM, BN] partials, and the tile's last block adds them
  float* slot = g.work + (static_cast<long long>(tile) * g.splits + split) * (BM * BN);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(slot + (ty * 4 + i) * BN + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(g.ticket + tile, 1) == g.splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float4* parts = reinterpret_cast<const float4*>(slot - split * (BM * BN));
  for (int q = tid; q < BM * BN / 4; q += NT) {
    float4 s = __ldcg(parts + q);
#pragma unroll 4
    for (int sp = 1; sp < g.splits; ++sp) {
      const float4 v = __ldcg(parts + sp * (BM * BN / 4) + q);
      s.x = s.x + v.x, s.y = s.y + v.y, s.z = s.z + v.z, s.w = s.w + v.w;
    }
    const int r = r0 + (4 * q) / BN, c = c0 + (4 * q) % BN;
    if (r >= g.rows) continue;
    const int row = at(g.c_row, r);
    const float v4[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e < g.cols)
        g.c[row + at(g.c_col, c + e)] = g.epi == 1 ? fold_base(fold, r, c + e) + v4[e] : v4[e];
    }
  }
  if (tid == 0) g.ticket[tile] = 0;
}

template <int BM, int BN>
cudaError_t launch_tiles(Params& p, cudaStream_t stream) {
  constexpr int NT = (BM / 4) * (BN / 4);
  int blocks = 0;
  for (int i = 0; i < p.n_gemm; ++i) {
    Gemm& g = p.g[i];
    g.tiles_m = (g.rows + BM - 1) / BM;
    g.tiles_n = (g.cols + BN - 1) / BN;
    g.steps = (g.k + BK - 1) / BK;
    if (g.splits > g.steps) return cudaErrorInvalidValue;  // a split with no k
    g.first = blocks;
    const long long n = static_cast<long long>(g.tiles_m) * g.tiles_n * g.splits;
    if (n > (1 << 30) - blocks) return cudaErrorInvalidValue;
    blocks += static_cast<int>(n);
  }
  p.gemm_blocks = blocks;
  const int aux = p.copy_elems > p.n_zero ? p.copy_elems : p.n_zero;
  blocks += (aux + NT * AUX_PER_THREAD - 1) / (NT * AUX_PER_THREAD);
  if (blocks == 0) return cudaSuccess;
  erb_fold_tiles<BM, BN><<<blocks, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

Index index_of(const long long* q) {
  return Index{static_cast<int>(q[0]), static_cast<int>(q[1]), static_cast<int>(q[2])};
}

bool unit_k(const Index& k) { return (k.div > 1 ? k.lo : k.hi) == 1; }

// How an operand's loads walk (Slab's Mode), -1 if they cannot: along k where
// k has unit stride (the outer index then needs one stride), else along the
// outer index (k then needs one stride); 16 bytes a load where the unit
// stride is a whole one-stride index, the other stride and the extent are
// multiples of 4 and the tensor starts 16-byte aligned.
int mode_of(const float* ptr, const Index& outer, const Index& k, int n_outer, int k_n) {
  const bool aligned = reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
  if (unit_k(k)) {
    if (outer.div != 1) return -1;
    return aligned && k.div == 1 && outer.hi % 4 == 0 && k_n % 4 == 0 ? K4 : K1;
  }
  if (k.div != 1) return -1;
  return aligned && outer.div == 1 && outer.hi == 1 && n_outer % 4 == 0 && k.hi % 4 == 0 ? O4
                                                                                        : O1;
}

}  // namespace

// One launch of erb_fold_tiles.  gemms: n_gemm host records of GEMM_FIELDS
// int64 values: a, b, c, work, ticket as addresses; then (div, hi, lo) of
// a_outer, a_k, b_outer, b_k, c_row, c_col; rows, cols, k, splits, epi.
// An operand whose k has unit stride has a one-stride outer index, else a
// one-stride k.  Every offset fits in an int.  copies: n_copy records of COPY_FIELDS (src0, src1,
// src2, dst as addresses, 0 for none; s0, s1, s2, base, d1, d2, n); fold:
// w33, w13, w31 addresses and cin, read by epi 1; zero: n_zero ints set to
// 0 (tickets of later launches); work, for splits > 1: [tiles, splits, BM,
// BN] floats.  tile: BM x BN = 64 x 64 (0, 256 threads), 32 x 32 (1, 64),
// 32 x 64 (2, 128) or 64 x 32 (3, 128).  Returns the launch's cudaError_t.
extern "C" int repnerv_erb_fold(const long long* gemms, int n_gemm, const long long* copies,
                                int n_copy, const long long* fold, int* zero, long long n_zero,
                                int tile, void* stream) {
  if (n_gemm < 0 || n_gemm > MAX_GEMMS || n_copy < 0 || n_copy > MAX_COPIES || n_zero < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n_gemm = n_gemm;
  p.n_copy = n_copy;
  for (int i = 0; i < n_gemm; ++i) {
    const long long* q = gemms + i * GEMM_FIELDS;
    Gemm& g = p.g[i];
    g.a = reinterpret_cast<const float*>(q[0]);
    g.b = reinterpret_cast<const float*>(q[1]);
    g.c = reinterpret_cast<float*>(q[2]);
    g.work = reinterpret_cast<float*>(q[3]);
    g.ticket = reinterpret_cast<int*>(q[4]);
    g.a_outer = index_of(q + 5), g.a_k = index_of(q + 8);
    g.b_outer = index_of(q + 11), g.b_k = index_of(q + 14);
    g.c_row = index_of(q + 17), g.c_col = index_of(q + 20);
    g.rows = static_cast<int>(q[23]), g.cols = static_cast<int>(q[24]);
    g.k = static_cast<int>(q[25]), g.splits = static_cast<int>(q[26]);
    g.epi = static_cast<int>(q[27]);
    const Index* ixs[6] = {&g.a_outer, &g.a_k, &g.b_outer, &g.b_k, &g.c_row, &g.c_col};
    bool ok = g.rows >= 1 && g.cols >= 1 && g.k >= 1 && g.splits >= 1 && g.epi >= 0 &&
              g.epi <= 1 && (g.splits == 1 || (g.work != nullptr && g.ticket != nullptr));
    for (const Index* ix : ixs) ok = ok && ix->div >= 1;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    g.a_mode = mode_of(g.a, g.a_outer, g.a_k, g.rows, g.k);
    g.b_mode = mode_of(g.b, g.b_outer, g.b_k, g.cols, g.k);
    if (g.a_mode < 0 || g.b_mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  long long elems = 0;
  for (int i = 0; i < n_copy; ++i) {
    const long long* q = copies + i * COPY_FIELDS;
    Copy& c = p.cp[i];
    for (int s = 0; s < 3; ++s) c.src[s] = reinterpret_cast<const float*>(q[s]);
    c.dst = reinterpret_cast<float*>(q[3]);
    c.s0 = q[4], c.s1 = q[5], c.s2 = q[6], c.base = q[7];
    c.d1 = static_cast<int>(q[8]), c.d2 = static_cast<int>(q[9]);
    if (q[0] == 0 || q[3] == 0 || c.d1 < 1 || c.d2 < 1 || q[10] < 0 || q[10] > (1 << 30) - elems)
      return static_cast<int>(cudaErrorInvalidValue);
    c.n = static_cast<int>(q[10]);
    c.first = static_cast<int>(elems);
    elems += c.n;
  }
  if (n_zero > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  p.copy_elems = static_cast<int>(elems);
  p.fold = Fold{reinterpret_cast<const float*>(fold[0]), reinterpret_cast<const float*>(fold[1]),
                reinterpret_cast<const float*>(fold[2]), static_cast<int>(fold[3])};
  p.zero = zero;
  p.n_zero = zero == nullptr ? 0 : static_cast<int>(n_zero);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (tile) {
    case 0: err = launch_tiles<64, 64>(p, st); break;
    case 1: err = launch_tiles<32, 32>(p, st); break;
    case 2: err = launch_tiles<32, 64>(p, st); break;
    case 3: err = launch_tiles<64, 32>(p, st); break;
  }
  return static_cast<int>(err);
}
