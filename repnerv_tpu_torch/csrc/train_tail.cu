// Fused epilogue backward of one training stage for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repnerv_tpu/pallas_kernels/train_tail.py::_fused_bwd_kernel_call.
//
// The stage's forward (repnerv_train_stage_fwd) is
//   z   = pixel_shuffle(conv3x3(x) + b)            [B, H*s, W*s, C], compute dtype
//   out = act(z)                                   (no head), or
//   out = squash(act(z) @ hw + hb)                 [B, H*s, W*s, c_final] f32 (head)
// and this kernel takes the cotangent ct of out back to the conv output:
//   head:    d_h = ct * squash'(out)  (tanh: 0.5 * (1 - u^2), u = 2 out - 1;
//                                      sigmoid: out * (1 - out)), f32
//            d_a = d_h @ hw^T         (operands rounded to the compute dtype,
//                                      f32 sum: the JAX kernel's cast points)
//            d_hw = act(z)^T d_h,  d_hb = sum d_h
//   no head: d_a = ct
//   d_z = d_a * act'(z), stored as d_conv [B, H, W, s*s*C] in the compute dtype,
//   with shuffle-major columns (i*s + j)*C + c: the conv output layout of the
//   packed weights; d_b sums the f32 d_z before that rounding and is written
//   in PixelShuffle channel order c*s*s + i*s + j, the order of the model's
//   bias.
//
// What bounds it: the bytes.  At the 720p head stage it reads z (177 MB in
// bf16) and writes d_conv (the same), so one pass over memory at 3.35 TB/s
// (~0.1 ms) is the floor, and the activation's derivative (an expf and a
// division per element) has to hide under the loads.  Design:
//   * Contiguous runs.  For a full-resolution row r = (b*H + h)*s + i and a
//     low-res pixel w, the s*C values z[r, w*s : (w+1)*s, :] are one run, and
//     they land in d_conv[b, h, w, i*s*C : (i+1)*s*C], one run too.  So the
//     inverse shuffle is index arithmetic: a thread loads 16 bytes of z (and
//     of ct without a head), and stores 16 bytes of d_conv, both coalesced.
//     A block works on tiles of one row r and P*U adjacent pixels: U vectors
//     a thread are loaded before the first is used.  Channel counts that do
//     not give 16-byte runs take the same kernel with one value a thread.
//   * A persistent grid in which a block keeps one sub-row i (and, for wide
//     stages, one group of the run's columns) for its whole life, so a thread
//     owns the same columns in every tile: its bias sums, its head-weight
//     rows (rounded once) and its d_hw sums stay in registers.  Tile index
//     arithmetic is one division per tile.
//   * With a head, d_h is computed once per full-resolution pixel into shared
//     memory (f32 and rounded to the compute dtype), double-buffered and
//     fetched a tile ahead: one barrier per tile, and no load waited for
//     before it.  The activation is chosen once per tile, not per value.
//   * The partial sums end in the kernel.  A block adds its threads' sums in
//     a fixed order and writes one row of partials; the block that finishes
//     last (a ticket from an atomicAdd after __threadfence) adds the rows in
//     a fixed order, so the gradients do not depend on the order the blocks
//     ran in, and writes d_b through the permutation, d_hw and d_hb.  One
//     block adding all rows took longer than the small stages' whole pass, so
//     the rows are added in two rounds of ~sqrt(G): per group of blocks, then
//     over the groups.  The tickets go back to 0 for the next launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activations.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repnerv::act_grad;
using repnerv::apply_act;

// kernels/probe_train.py builds this file with REPNERV_PROBE_* macros that take
// a part out or change a design choice; the port builds it with none.
constexpr int MAX_THREADS = 256;
constexpr int MAX_TICKETS = 64;  // ints behind `ticket`: the last round's, then one a group
#ifdef REPNERV_PROBE_U
constexpr int U = REPNERV_PROBE_U;
#else
constexpr int U = 4;               // vectors a thread has in flight
#endif
#ifdef REPNERV_PROBE_BLOCKS_PER_SM
constexpr int BLOCKS_PER_SM = REPNERV_PROBE_BLOCKS_PER_SM;
#else
constexpr int BLOCKS_PER_SM = 2;   // of the persistent grid
#endif

// V values of T as one load / store
template <typename T, int V>
struct Pack;
template <>
struct Pack<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[4]) {
    f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Pack<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) { f[0] = r; }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) { return f[0]; }
};
template <>
struct Pack<bf16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 t = __bfloat1622float2(h[k]);
      f[2 * k] = t.x, f[2 * k + 1] = t.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[8]) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
};
template <>
struct Pack<bf16, 1> {
  using Raw = bf16;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[1]) {
    f[0] = __bfloat162float(r);
  }
  static __device__ __forceinline__ Raw pack(const float (&f)[1]) {
    return __float2bfloat16_rn(f[0]);
  }
};

// round to the compute dtype and back (identity in f32)
template <typename T>
__device__ __forceinline__ float round_cd(float v);
template <>
__device__ __forceinline__ float round_cd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_cd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Swish' in bf16 takes __expf and __fdividef: d_conv is rounded to 8 bits, and
// the exact forms kept the 720p head stage off its loads (0.276 against 0.212
// ms on an H100; one bf16 ulp of difference in 1.2e-5 of its values).  f32 keeps expf and
// the IEEE division: d_conv is held to 1e-5.
template <typename T>
struct FastAct {
#if defined(REPNERV_PROBE_FAST_ACT)
  static constexpr bool value = true;
#elif defined(REPNERV_PROBE_EXACT_ACT)
  static constexpr bool value = false;
#else
  static constexpr bool value = sizeof(T) == 2;
#endif
};

// act(v) and act'(v); swish shares its sigmoid between the two
template <int ACT, bool NEED_ACT, bool FAST>
__device__ __forceinline__ void act_pair(float v, float& a, float& g) {
#ifdef REPNERV_PROBE_NO_ACT
  a = v, g = 1.f;  // loads, stores and sums only
  return;
#endif
  if (ACT == 6) {
    const float sg = FAST ? __fdividef(1.f, 1.f + __expf(-v)) : 1.f / (1.f + expf(-v));
    a = v * sg;
    g = sg * (1.f + v * (1.f - sg));
  } else {
    a = NEED_ACT ? apply_act(v, ACT) : 0.f;
    g = act_grad(v, ACT);
  }
}

// d_h = ct * squash'(out), from the squashed output
__device__ __forceinline__ float squash_vjp(float g, float o, int sigmoid) {
  if (sigmoid) return g * o * (1.f - o);
  const float u = 2.f * o - 1.f;
  return g * 0.5f * (1.f - u * u);
}

constexpr int HPT = 2;  // d_h values a thread fetches a tile ahead

struct Bwd {
  int B, H, W, C, s, act, c_final, sigmoid_squash;
  int nv;      // vectors in a run of s*C values
  int nvb;     // ... of them a block owns (one column group)
  int ncg;     // column groups of a run
  int P;       // pixels a block takes at once: blockDim.x = nvb * P
  int nwc;     // tiles of P*U pixels in a row
  int Gi;      // blocks per (sub-row, column group); gridDim.x = Gi * s * ncg
  int GS, NG;  // the sums' two rounds: NG groups of GS consecutive gi
};

// What a thread carries from tile to tile.
template <int V, int CF>
struct Sums {
  float db[V];
  float dhw[V][CF];
  float dhb[CF];
};

// The values of one tile: raw[u] (and ct_raw[u] without a head) hold pixel
// w0 + u*P + ps of row r, for the thread's V columns.
template <typename T, int V, int CF, bool HEAD, int ACT>
__device__ __forceinline__ void compute_tile(
    const typename Pack<T, V>::Raw (&raw)[U], const typename Pack<T, V>::Raw (&ct_raw)[U],
    const float* dh, const float* dhr, const float (&hwr)[V][CF], Sums<V, CF>& sums,
    T* d_conv, long long d_off, int d_step, int w, int w_step, int W, int dh_off, int dh_step,
    int cf, bool counts_hb) {
  using P = Pack<T, V>;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (w + u * w_step >= W) break;
    float zf[V], dz[V], da[V];
    P::unpack(raw[u], zf);
    float d[CF], dr[CF];
    if (HEAD) {
#pragma unroll
      for (int k = 0; k < CF; ++k) {
        d[k] = k < cf ? dh[dh_off + u * dh_step + k] : 0.f;
        dr[k] = k < cf ? dhr[dh_off + u * dh_step + k] : 0.f;
      }
      if (counts_hb) {
#pragma unroll
        for (int k = 0; k < CF; ++k) sums.dhb[k] += d[k];
      }
    } else {
      P::unpack(ct_raw[u], da);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      float a, g;
      act_pair<ACT, HEAD, FastAct<T>::value>(zf[q], a, g);
      if (HEAD) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < CF; ++k) {
          acc = fmaf(dr[k], hwr[q][k], acc);
          sums.dhw[q][k] = fmaf(a, d[k], sums.dhw[q][k]);
        }
        da[q] = acc;
      }
      dz[q] = da[q] * g;
      sums.db[q] += dz[q];
    }
    *reinterpret_cast<typename P::Raw*>(d_conv + d_off + (long long)u * d_step) = P::pack(dz);
  }
}

// Workspace (f32): part [G][nvb*V][1 + cf] (a block's column sums: d_b, then
// the column's d_hw row), hb_part [G][cf], colsum [s*s*C][1 + cf], and the
// groups' sums gpart [NG][s*s*C][1 + cf], ghb [NG][cf].
// Shared memory (f32): dh and dhr, 2 buffers each of P*U*s*cf; then
// red [blockDim][V * (1 + cf)] for the block's sums (it overlays nothing).
template <typename T, int V, int CF, bool HEAD>
__global__ void __launch_bounds__(MAX_THREADS, BLOCKS_PER_SM)
epilogue_bwd(const T* __restrict__ z, const T* __restrict__ ct,
             const float* __restrict__ ct_head, const float* __restrict__ out,
             const float* __restrict__ hw, T* __restrict__ d_conv, float* __restrict__ d_b,
             float* __restrict__ d_hw, float* __restrict__ d_hb, float* __restrict__ work,
             int* __restrict__ ticket, Bwd p) {
  using PK = Pack<T, V>;
  using Raw = typename PK::Raw;
  extern __shared__ float smem[];
  const int s = p.s, C = p.C, sC = s * C, Cout = s * sC, cf = HEAD ? p.c_final : 0;
  const int comps = 1 + cf, ncolb = p.nvb * V, ngrp = s * p.ncg;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int G = gridDim.x;
  const int cgid = blockIdx.x % ngrp, gi = blockIdx.x / ngrp;
  const int sub_i = cgid / p.ncg, cg = cgid % p.ncg;
  const int v = tid % p.nvb, ps = tid / p.nvb;
  const int vg = cg * p.nvb + v;      // the thread's vector of the run
  const bool active = vg < p.nv;      // the last column group may be short
  const int e0 = vg * V;              // its first column of the run
  const int sub_j = e0 / C, c0 = e0 % C;
  const int TWP = p.P * U, Ws = p.W * s;
  const int dh_tile = TWP * s * cf;   // values of one dh buffer
  float* dh_buf = smem;               // [2][dh_tile]
  float* dhr_buf = smem + 2 * dh_tile;
  float* red = smem + 4 * dh_tile;    // [nthreads][V * comps]

  Sums<V, CF> sums;
  float hwr[V][CF];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    sums.db[q] = 0.f;
#pragma unroll
    for (int k = 0; k < CF; ++k) {
      sums.dhw[q][k] = 0.f;
      hwr[q][k] = (HEAD && active && k < cf) ? round_cd<T>(hw[(c0 + q) * cf + k]) : 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < CF; ++k) sums.dhb[k] = 0.f;
  // one thread of each full-resolution pixel adds its d_h into d_hb
  const bool counts_hb = HEAD && active && c0 == 0;

  const int n_tiles = p.B * p.H * p.nwc;
  // d_h of tile t: n values, contiguous in ct_head and out from h_off on.  A
  // thread fetches its first HPT of them a tile ahead (head_fetch) and turns
  // them into d_h when the tile before has been computed (head_write).
  float ho[HPT], hg[HPT];
  auto head_span = [&](int t, long long& h_off) {
    const int bh = t / p.nwc, w0 = (t - bh * p.nwc) * TWP;
    h_off = ((long long)(bh * s + sub_i) * Ws + (long long)w0 * s) * cf;
    return min(TWP, p.W - w0) * s * cf;
  };
  auto head_fetch = [&](int t) {
    long long h_off;
    const int n = head_span(t, h_off);
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int e = tid + i * nthreads;
      if (e < n) ho[i] = out[h_off + e], hg[i] = ct_head[h_off + e];
    }
  };
  auto head_write = [&](int t, float* dh, float* dhr) {
    long long h_off;
    const int n = head_span(t, h_off);
#pragma unroll
    for (int i = 0; i < HPT; ++i) {
      const int e = tid + i * nthreads;
      if (e < n) {
        const float d = squash_vjp(hg[i], ho[i], p.sigmoid_squash);
        dh[e] = d, dhr[e] = round_cd<T>(d);
      }
    }
    for (int e = tid + HPT * nthreads; e < n; e += nthreads) {
      const float d = squash_vjp(ct_head[h_off + e], out[h_off + e], p.sigmoid_squash);
      dh[e] = d, dhr[e] = round_cd<T>(d);
    }
  };
  if (HEAD) {
    if (gi < n_tiles) {
      head_fetch(gi);
      head_write(gi, dh_buf, dhr_buf);
    }
    __syncthreads();
  }
  int parity = 0;
  for (int t = gi; t < n_tiles; t += p.Gi, parity ^= 1) {
    const int bh = t / p.nwc, w0 = (t - bh * p.nwc) * TWP;
    const int r = bh * s + sub_i;  // the row of z, ct and out
    const int w = w0 + ps;
    const long long z_off = ((long long)r * Ws + (long long)w * s) * C + e0;
    const long long d_off = ((long long)bh * p.W + w) * Cout + sub_i * sC + e0;
    Raw raw[U], ct_raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (active && w + u * p.P < p.W) {
        raw[u] = *reinterpret_cast<const Raw*>(z + z_off + (long long)u * p.P * sC);
        if (!HEAD) ct_raw[u] = *reinterpret_cast<const Raw*>(ct + z_off + (long long)u * p.P * sC);
      }
    }
    const bool more = t + p.Gi < n_tiles;
    if (HEAD && more) head_fetch(t + p.Gi);
    if (active) {
      const float* dh = dh_buf + parity * dh_tile;
      const float* dhr = dhr_buf + parity * dh_tile;
      const int dh_off = (ps * s + sub_j) * cf, dh_step = p.P * s * cf;
#define REPNERV_TILE(ACT)                                                                  \
  case ACT:                                                                                \
    compute_tile<T, V, CF, HEAD, ACT>(raw, ct_raw, dh, dhr, hwr, sums, d_conv, d_off,      \
                                      p.P * Cout, w, p.P, p.W, dh_off, dh_step, cf,       \
                                      counts_hb);                                          \
    break;
      switch (p.act) {
        REPNERV_TILE(0) REPNERV_TILE(1) REPNERV_TILE(2) REPNERV_TILE(3) REPNERV_TILE(4)
        REPNERV_TILE(5) REPNERV_TILE(6) REPNERV_TILE(7) REPNERV_TILE(8)
      }
#undef REPNERV_TILE
    }
    if (HEAD) {
      // the other buffer's readers passed the barrier that ended the tile before
      if (more) head_write(t + p.Gi, dh_buf + (parity ^ 1) * dh_tile,
                           dhr_buf + (parity ^ 1) * dh_tile);
      __syncthreads();
    }
  }

  // the block's sums, thread by thread in a fixed order
  __syncthreads();
#pragma unroll
  for (int q = 0; q < V; ++q) {
    red[(tid * V + q) * comps] = sums.db[q];
#pragma unroll
    for (int k = 0; k < CF; ++k)
      if (k < cf) red[(tid * V + q) * comps + 1 + k] = sums.dhw[q][k];
  }
  __syncthreads();
  float* part = work;                                   // [G][ncolb][comps]
  float* hb_part = part + (long long)G * ncolb * comps; // [G][cf]
  float* colsum = hb_part + (long long)G * cf;          // [Cout][comps]
  for (int o = tid; o < ncolb * comps; o += nthreads) {
    float acc = 0.f;
    for (int pp = 0; pp < p.P; ++pp) acc += red[pp * ncolb * comps + o];
    part[(long long)blockIdx.x * ncolb * comps + o] = acc;
  }
  if (HEAD) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CF; ++k)
      if (k < cf) red[tid * cf + k] = sums.dhb[k];
    __syncthreads();
    for (int k = tid; k < cf; k += nthreads) {
      float acc = 0.f;
      for (int e = 0; e < nthreads; ++e) acc += red[e * cf + k];
      hb_part[blockIdx.x * cf + k] = acc;
    }
  }

  // Two rounds of tickets, so that no block adds more than ~sqrt(G) rows: the
  // blocks of GS consecutive gi form a group; the last of a group to arrive
  // adds the group's rows, the last group to finish adds the groups' rows.
  // Which block does it depends on the run; what is added, and in which order,
  // does not.
  __shared__ int is_last;
  float* gpart = colsum + Cout * comps;                     // [NG][Cout][comps]
  float* ghb = gpart + (long long)p.NG * Cout * comps;      // [NG][cf]
  const int grp = gi / p.GS, gi0 = grp * p.GS, gi1 = min(p.Gi, gi0 + p.GS);
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket + 1 + grp, 1) == (gi1 - gi0) * ngrp - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#ifndef REPNERV_PROBE_NO_TAIL
  for (int o = tid; o < Cout * comps; o += nthreads) {
    const int col = o / comps, comp = o - col * comps;
    const int ci = col / sC, ec = col - ci * sC;
    const int vgc = ec / V, q = ec - vgc * V;
    const int ccg = vgc / p.nvb, cv = vgc - ccg * p.nvb;
    const long long stride = (long long)ngrp * ncolb * comps;
    const float* src = part + gi0 * stride +
                       ((long long)(ci * p.ncg + ccg) * ncolb + cv * V + q) * comps + comp;
    float acc = 0.f;
#pragma unroll 4
    for (int g = 0; g < gi1 - gi0; ++g) acc += __ldcg(src + g * stride);
    gpart[(long long)grp * Cout * comps + o] = acc;
  }
  if (HEAD) {
    for (int k = tid; k < cf; k += nthreads) {
      float acc = 0.f;
      for (int b = gi0 * ngrp; b < gi1 * ngrp; ++b) acc += __ldcg(hb_part + b * cf + k);
      ghb[grp * cf + k] = acc;
    }
  }
#endif
  if (tid == 0) ticket[1 + grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1) == p.NG - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#ifndef REPNERV_PROBE_NO_TAIL
  for (int o = tid; o < Cout * comps; o += nthreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int g = 0; g < p.NG; ++g) acc += __ldcg(gpart + (long long)g * Cout * comps + o);
    colsum[o] = acc;
  }
  __syncthreads();
  const int s2 = s * s;
  for (int col = tid; col < Cout; col += nthreads) {
    const int sub = col / C, c = col - sub * C;
    d_b[c * s2 + sub] = colsum[col * comps];
  }
  if (HEAD) {
    for (int o = tid; o < C * cf; o += nthreads) {
      const int c = o / cf, k = o - c * cf;
      float acc = 0.f;
      for (int sub = 0; sub < s2; ++sub) acc += colsum[(sub * C + c) * comps + 1 + k];
      d_hw[o] = acc;
    }
    for (int k = tid; k < cf; k += nthreads) {
      float acc = 0.f;
      for (int g = 0; g < p.NG; ++g) acc += __ldcg(ghb + g * cf + k);
      d_hb[k] = acc;
    }
  }
#endif
  if (tid == 0) ticket[0] = 0;
}

// The launch geometry of a problem: the same for the workspace query and the launch.
struct Plan {
  Bwd p;
  int V, threads, G, smem_bytes;
  long long work_floats;
  bool vec;
};

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// 16-byte vectors when a run of C values is a whole number of them and the
// head's rows fit the registers (c_final <= 3); else one value a thread.
bool make_plan(int dtype, int B, int H, int W, int C, int s, int act, int c_final,
               int sigmoid_squash, Plan& plan) {
  if (dtype < 0 || dtype > 1 || B < 1 || H < 1 || W < 1 || C < 1 || s < 1 || s > 5 || act < 0 ||
      act > 8 || c_final < 0 || c_final > 16)
    return false;
  const int full = dtype == 0 ? 4 : 8;
  plan.vec = C % full == 0 && c_final <= 3;
  plan.V = plan.vec ? full : 1;
  Bwd& p = plan.p;
  p = Bwd{B, H, W, C, s, act, c_final, sigmoid_squash, 0, 0, 0, 0, 0, 0, 0, 0};
  p.nv = s * C / plan.V;
  p.ncg = (p.nv + MAX_THREADS - 1) / MAX_THREADS;
  p.nvb = (p.nv + p.ncg - 1) / p.ncg;
  p.P = MAX_THREADS / p.nvb;
  if (p.P > W) p.P = W;
  plan.threads = p.nvb * p.P;
  p.nwc = (W + p.P * U - 1) / (p.P * U);
  const long long n_tiles = (long long)B * H * p.nwc;
  if (n_tiles > 0x7fffffff) return false;
  const int ngrp = s * p.ncg;
  long long gi = (long long)num_sms() * BLOCKS_PER_SM / ngrp;
  if (gi < 1) gi = 1;
  if (gi > n_tiles) gi = n_tiles;
  p.Gi = (int)gi;
  plan.G = p.Gi * ngrp;
  p.GS = 1;
  while (p.GS * p.GS < p.Gi) ++p.GS;
  p.NG = (p.Gi + p.GS - 1) / p.GS;
  if (1 + p.NG > MAX_TICKETS) return false;
  const int comps = 1 + c_final;
  const long long dh = c_final > 0 ? 4LL * p.P * U * s * c_final : 0;
  plan.smem_bytes = (int)(dh + (long long)plan.threads * plan.V * comps) * 4;
  plan.work_floats = (long long)plan.G * p.nvb * plan.V * comps + (long long)plan.G * c_final +
                     (long long)(1 + p.NG) * s * s * C * comps + (long long)p.NG * c_final;
  return true;
}

template <typename T, int V, int CF, bool HEAD>
cudaError_t launch(const Plan& plan, const void* z, const void* ct, const float* ct_head,
                   const float* out, const float* hw, void* d_conv, float* d_b, float* d_hw,
                   float* d_hb, float* work, int* ticket, cudaStream_t stream) {
  auto* fn = epilogue_bwd<T, V, CF, HEAD>;
  if (plan.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
    if (err != cudaSuccess) return err;
  }
  fn<<<plan.G, plan.threads, plan.smem_bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(ct), ct_head, out, hw,
      static_cast<T*>(d_conv), d_b, d_hw, d_hb, work, ticket, plan.p);
  return cudaGetLastError();
}

template <typename T, int VFULL>
cudaError_t launch_type(const Plan& plan, const void* z, const void* ct, const float* ct_head,
                        const float* out, const float* hw, void* d_conv, float* d_b,
                        float* d_hw, float* d_hb, float* work, int* ticket,
                        cudaStream_t stream) {
#define REPNERV_ARGS plan, z, ct, ct_head, out, hw, d_conv, d_b, d_hw, d_hb, work, ticket, stream
  const bool head = plan.p.c_final > 0;
  if (plan.vec)
    return head ? launch<T, VFULL, 3, true>(REPNERV_ARGS) : launch<T, VFULL, 1, false>(REPNERV_ARGS);
  return head ? launch<T, 1, 16, true>(REPNERV_ARGS) : launch<T, 1, 1, false>(REPNERV_ARGS);
#undef REPNERV_ARGS
}

}  // namespace

// The f32 values of workspace a launch of this problem needs, or -1 for a
// problem the kernel does not take.
extern "C" long long repnerv_train_stage_bwd_workspace(int dtype, int B, int H, int W, int C,
                                                       int s, int c_final) {
  Plan plan;
  return make_plan(dtype, B, H, W, C, s, 0, c_final, 0, plan) ? plan.work_floats : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (z, ct without a head, d_conv).  c_final = 0:
// no head, ct is [B, H*s, W*s, C] in the compute dtype and ct_head, out, hw,
// d_hw, d_hb are unused; c_final > 0: ct_head and out are f32 [B, H*s, W*s,
// c_final] and hw is f32 [C, c_final].  Outputs: d_conv [B, H, W, s*s*C], d_b
// [s*s*C] f32 in PixelShuffle channel order, d_hw [C, c_final], d_hb [c_final].
// work: repnerv_train_stage_bwd_workspace(...) f32 values; ticket: 64 ints that
// are 0 before the launch and 0 again after it, shared by the launches of one
// stream.  Returns the cudaError_t of the launch.
extern "C" int repnerv_train_stage_bwd(int dtype, const void* z, const void* ct,
                                       const float* ct_head, const float* out,
                                       const float* hw, void* d_conv, float* d_b, float* d_hw,
                                       float* d_hb, float* work, int* ticket, int B, int H,
                                       int W, int C, int s, int act, int c_final,
                                       int sigmoid_squash, void* stream) {
  Plan plan;
  if (!make_plan(dtype, B, H, W, C, s, act, c_final, sigmoid_squash, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_type<float, 4>(plan, z, ct, ct_head, out, hw, d_conv, d_b, d_hw, d_hb,
                                         work, ticket, st)
                 : launch_type<bf16, 8>(plan, z, ct, ct_head, out, hw, d_conv, d_b, d_hw, d_hb,
                                        work, ticket, st);
  return static_cast<int>(err);
}
