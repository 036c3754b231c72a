// Activation functions and their derivatives, shared by the stage kernels.
// Codes: the order of ACT_CODES in kernels/decode.py.
#pragma once

#include <cuda_runtime.h>

namespace repnerv {

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case 0: return fmaxf(v, 0.f);                           // relu
    case 1: return v >= 0.f ? v : 0.01f * v;                // leaky
    case 2: return v >= 0.f ? v : 0.1f * v;                 // leaky01
    case 3: return fminf(fmaxf(v, 0.f), 6.f);               // relu6
    case 4: return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));  // gelu (erf)
    case 5: return sinf(v);                                 // sin
    case 6: return v * (1.f / (1.f + expf(-v)));            // swish
    case 7: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); // softplus, unthresholded
    case 8: return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) / 6.f;  // hardswish
  }
  return v;
}

// d act / dz, with JAX's values at the kinks: relu 0 at 0, leaky 1 at 0,
// relu6 0 at 0 and 6, hardswish 0 at -3 and 1 at 3.
__device__ __forceinline__ float act_grad(float v, int act) {
  switch (act) {
    case 0: return v > 0.f ? 1.f : 0.f;
    case 1: return v >= 0.f ? 1.f : 0.01f;
    case 2: return v >= 0.f ? 1.f : 0.1f;
    case 3: return (v > 0.f && v < 6.f) ? 1.f : 0.f;
    case 4:  // exact-erf gelu
      return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
             v * expf(-0.5f * v * v) * 0.39894228040143268f;
    case 5: return cosf(v);
    case 6: {
      const float sg = 1.f / (1.f + expf(-v));
      return sg * (1.f + v * (1.f - sg));
    }
    case 7: return 1.f / (1.f + expf(-v));
    case 8: {
      const float r = fminf(fmaxf(v + 3.f, 0.f), 6.f);
      const float dr = (v + 3.f > 0.f && v + 3.f < 6.f) ? 1.f : 0.f;
      return (r + v * dr) / 6.f;
    }
  }
  return 1.f;
}

}  // namespace repnerv
