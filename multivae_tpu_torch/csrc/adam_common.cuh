// Adam's per-element update, shared by flat_adam.cu (one launch per update)
// and the persistent step kernels (mopoe_step.cu, method_step.cu,
// presence_step.cu, generic_step.cu: in the last phase of every step of a
// launch, each gradient element where it is produced), for Hopper (sm_90a). One body, so the two give the same bits:
//   bc1 = 1 - exp(t log b1);  bc2 = 1 - exp(t log b2)
//   mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
//   p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)
// Every product and sum is rounded on its own (no fused multiply-add), as
// the plain version and the TPU bodies round them: b1 mu and (1 - b1) g
// nearly cancel where the gradient turns.

#pragma once

#include <cuda_runtime.h>

namespace adam {

// The scalars come in as float32, as the TPU kernel's Python constants do
// (1 - b1 and log b1 rounded once from double).
struct Hyper {
  float lr, b1, b2, one_minus_b1, one_minus_b2, log_b1, log_b2, eps;
};

struct Correction {
  float bc1, bc2;
};

// The bias corrections of step t (count + step + 1).
__device__ __forceinline__ Correction correction(float t, const Hyper& h) {
  Correction c;
  c.bc1 = 1.0f - expf(t * h.log_b1);
  c.bc2 = 1.0f - expf(t * h.log_b2);
  return c;
}

// One element's update on values held in registers.
__device__ __forceinline__ void update_values(float& p, float& mu, float& nu,
                                              float g, const Hyper& h,
                                              const Correction& c) {
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.one_minus_b1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu),
                 __fmul_rn(h.one_minus_b2, __fmul_rn(g, g)));
  const float step = __fmul_rn(h.lr, mu / c.bc1) /
                     __fadd_rn(sqrtf(nu / c.bc2), h.eps);
  p = __fsub_rn(p, step);
}

__device__ __forceinline__ void update_element(float* p, float* mu, float* nu,
                                               float g, long long i,
                                               const Hyper& h,
                                               const Correction& c) {
  float pv = p[i], m = mu[i], v = nu[i];
  update_values(pv, m, v, g, h, c);
  mu[i] = m;
  nu[i] = v;
  p[i] = pv;
}

// The update of elements [begin, end) by every thread of a grid,
// elementwise; a thread has kUnroll elements' loads in flight at a time.
__device__ __forceinline__ void update_range(float* p, float* mu, float* nu,
                                             const float* g, long long begin,
                                             long long end, const Hyper& h,
                                             const Correction& c) {
  constexpr int kUnroll = 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i0 = begin + static_cast<long long>(blockIdx.x) *
                                  blockDim.x + threadIdx.x;
       i0 < end; i0 += kUnroll * stride) {
    float gv[kUnroll], pv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < end) {
        gv[u] = g[i];
        pv[u] = p[i];
        mv[u] = mu[i];
        vv[u] = nu[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      if (i < end) {
        update_values(pv[u], mv[u], vv[u], gv[u], h, c);
        mu[i] = mv[u];
        nu[i] = vv[u];
        p[i] = pv[u];
      }
    }
  }
}

}  // namespace adam
