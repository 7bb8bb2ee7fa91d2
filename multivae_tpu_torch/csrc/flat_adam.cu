// Adam over the whole flat train state in one launch, for Hopper (sm_90a).
//
// Replaces the Adam bodies of the TPU epoch kernels:
// multivae_tpu/ops/fused_step.py::_epoch_kernel (:615-626),
// fused_presence.py::_presence_epoch_kernel (:287-297) and
// fused_methods.py::_method_epoch_kernel (:382-392), the same math as
// train/train_step.py::flat_adam (optax.adam, eps_root = 0):
//   t = count + step + 1;  bc1 = 1 - exp(t log b1);  bc2 = 1 - exp(t log b2)
//   mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
//   p -= lr (mu / bc1) / (sqrt(nu / bc2) + eps)
// params, mu and nu are three flat float32 buffers (the 28 split tensors
// back to back), updated in place; g is the step's flat gradient.
//
// What bounds it: HBM bytes. ~167k elements at the flagship widths move
// 7 floats each (p, mu, nu, g in; p, mu, nu out), ~4.7 MB, a few
// microseconds at 3.35 TB/s, less than a launch costs; the TPU kernel
// needed no launch at all since its moments stayed in VMEM. Design: one
// thread per element, grid-stride, no reduction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adam_common.cuh"

namespace {

constexpr int kThreads = 256;

struct AdamArgs {
  float* p;
  float* mu;
  float* nu;
  const float* g;
  long long n;
  float t;
  adam::Hyper h;
};

// the element update is adam_common.cuh's, shared with the persistent steps
__global__ void __launch_bounds__(kThreads) flat_adam_kernel(const AdamArgs a) {
  adam::update_range(a.p, a.mu, a.nu, a.g, 0, a.n, a.h,
                     adam::correction(a.t, a.h));
}

}  // namespace

extern "C" {

// One Adam update at step t (count + step + 1) on `stream`; returns
// cudaGetLastError() after the launch. The scalars come in as float32, as
// the TPU kernel's Python constants do (1 - b1 and log b1 rounded once from
// double).
int flat_adam_launch(float* p, float* mu, float* nu, const float* g,
                     long long n, long long t, float lr, float b1, float b2,
                     float one_minus_b1, float one_minus_b2, float log_b1,
                     float log_b2, float eps, void* stream) {
  if (n <= 0) return 0;
  AdamArgs a{p, mu, nu, g, n, static_cast<float>(t),
             adam::Hyper{lr, b1, b2, one_minus_b1, one_minus_b2, log_b1,
                         log_b2, eps}};
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  flat_adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* flat_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
