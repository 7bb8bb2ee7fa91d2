// Avatar-sweep kernel of the Digital Avatars Analysis, for Hopper (sm_90a).
//
// Replaces multivae_tpu/ops/fused_daa.py::_avatar_kernel (the Pallas TPU
// kernel launched by sweep_cells). It computes what that kernel computes,
// not its block layout. For every output row r of n_rows = n_cells * B rows
// (one perturbation cell times one subject; subject i = r mod B):
//
//   h     = relu(x1[r] . Wh + bh)                       clinical encoder
//   cmu1  = h . Wcmu + bcmu,  clv1 = h . Wclv + bclv    content heads
//   t1 = 1/(exp(clv1)+1e-8), t2 = 1/(exp(clv2[i])+1e-8), tp = 1/(1+1e-8)
//   ts = t1 + t2 + tp,  mu_c = (cmu1 t1 + cmu2[i] t2) / ts     PoE + prior
//   zc    = the joint latent by method (sampled: the mixture row partition
//           of subject i plus streamed eps; deterministic: the mixture
//           mean), zs2 = smu2[i] (+ eps * exp(slv2[i] / 2) when sampled)
//   out[r] = zs2 . Wds + zc . Wdc + bd                  ROI decoder
//
// Row partition (fused_step.py:251-255, fused_daa.py:92-137): joint_elbo
// and jsd split the subjects at floor(B/3) and 2 floor(B/3), moe at B/2.
// joint_elbo's singleton log-variances are log(exp(clv)+1e-8); moe and jsd
// use the raw clv; jsd's third component is the unit expert (mu 0, logvar
// 0) and its deterministic mean divides by 3. eps rows are
// [content (cd) | style (s2)]. Weights stay in the JAX layout [in, out].
//
// What bounds it: per row about 60 kFLOP (7*256 + 256*40 + 40*444
// multiply-adds, x2) against 1,776 B of output, ~30 FLOP/B -- near the
// H100's f32 CUDA-core balance point, so neither the f32 pipes nor HBM is
// far ahead. Design: one block per tile of kRows rows; the tile's inputs,
// hidden activations, heads and latents are staged in shared memory and
// never touch device memory; each thread owns output columns and keeps
// kRows accumulators in registers, so every weight it reads (~120 KB of
// weights in all, served from L1/L2) is reused kRows times. Stores are
// coalesced across threads. At the flagship DAA sizes the device->host copy
// of the avatars costs more than this kernel. wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;      // output rows per block
constexpr int kThreads = 256;  // threads per block
constexpr float kPoeEps = 1e-8f;

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

struct SweepArgs {
  const float* cdata;  // [n_rows, d1]
  const float* eps;    // [n_rows, cd + s2]
  const float* Wh;     // [d1, h]
  const float* bh;     // [h]
  const float* Wcmu;   // [h, cd]
  const float* bcmu;   // [cd]
  const float* Wclv;   // [h, cd]
  const float* bclv;   // [cd]
  const float* Wds;    // [s2, d2]
  const float* Wdc;    // [cd, d2]
  const float* bd;     // [d2]
  const float* cmu2;   // [b, cd]
  const float* clv2;   // [b, cd]
  const float* smu2;   // [b, s2]
  const float* slv2;   // [b, s2]
  float* out;          // [n_rows, d2]
  int64_t n_rows;
  int b, d1, h, cd, s2, d2;
  int method, sample_latents;
  int k1, k2, kh;      // mixture row bounds
};

// The joint content latent of one (row, column) element.
__device__ __forceinline__ float joint_content(const SweepArgs& a, int subj,
                                               float cmu1, float clv1,
                                               float cmu2, float clv2,
                                               float eps) {
  const float t1 = 1.0f / (expf(clv1) + kPoeEps);
  const float t2 = 1.0f / (expf(clv2) + kPoeEps);
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float ts = t1 + t2 + tp;
  const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
  if (!a.sample_latents) {
    switch (a.method) {
      case kJointElbo: return (cmu1 + cmu2 + mu_c) / 3.0f;
      case kMoe: return (cmu1 + cmu2) / 2.0f;
      case kJsd: return (cmu1 + cmu2) / 3.0f;
      default: return mu_c;
    }
  }
  float mu, lv;
  switch (a.method) {
    case kJointElbo:
      if (subj < a.k1) {
        mu = cmu1; lv = logf(expf(clv1) + kPoeEps);
      } else if (subj < a.k2) {
        mu = cmu2; lv = logf(expf(clv2) + kPoeEps);
      } else {
        mu = mu_c; lv = -logf(ts);
      }
      break;
    case kMoe:
      if (subj < a.kh) { mu = cmu1; lv = clv1; } else { mu = cmu2; lv = clv2; }
      break;
    case kJsd:
      if (subj < a.k1) {
        mu = cmu1; lv = clv1;
      } else if (subj < a.k2) {
        mu = cmu2; lv = clv2;
      } else {
        mu = 0.0f; lv = 0.0f;
      }
      break;
    default:
      mu = mu_c; lv = -logf(ts);
  }
  return mu + eps * expf(0.5f * lv);
}

__global__ void __launch_bounds__(kThreads)
avatar_sweep_kernel(const SweepArgs a) {
  extern __shared__ float smem[];
  const int d1 = a.d1, h = a.h, cd = a.cd, s2 = a.s2, d2 = a.d2;
  const int two_cd = 2 * cd, zw = s2 + cd, ew = cd + s2;
  float* x_s = smem;                      // [kRows, d1]
  float* h_s = x_s + kRows * d1;          // [kRows, h]
  float* heads_s = h_s + kRows * h;       // [kRows, 2 cd]: cmu1 | clv1
  float* z_s = heads_s + kRows * two_cd;  // [kRows, s2 + cd]: zs2 | zc

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t left = a.n_rows - row0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  const int tid = threadIdx.x;

  // 1. the tile's perturbed clinical rows (zero past the last row)
  for (int i = tid; i < kRows * d1; i += blockDim.x) {
    x_s[i] = (i / d1) < rows ? a.cdata[row0 * d1 + i] : 0.0f;
  }
  __syncthreads();

  // 2. hidden layer: thread owns hidden column j for all kRows rows
  for (int j = tid; j < h; j += blockDim.x) {
    float acc[kRows];
    const float bias = a.bh[j];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = bias;
    for (int k = 0; k < d1; ++k) {
      const float w = a.Wh[k * h + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x_s[r * d1 + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) h_s[r * h + j] = fmaxf(acc[r], 0.0f);
  }
  __syncthreads();

  // 3. content heads: one (row, column) dot product of length h per step
  for (int i = tid; i < kRows * two_cd; i += blockDim.x) {
    const int r = i / two_cd;
    const int c = i - r * two_cd;
    const bool is_mu = c < cd;
    const int col = is_mu ? c : c - cd;
    const float* W = is_mu ? a.Wcmu : a.Wclv;
    float acc = is_mu ? a.bcmu[col] : a.bclv[col];
    const float* hr = h_s + r * h;
    for (int k = 0; k < h; ++k) acc = fmaf(hr[k], W[k * cd + col], acc);
    heads_s[i] = acc;
  }
  __syncthreads();

  // 4. latents z = [zs2 | zc] per row
  for (int i = tid; i < kRows * zw; i += blockDim.x) {
    const int r = i / zw;
    const int c = i - r * zw;
    float z = 0.0f;
    if (r < rows) {
      const int64_t row = row0 + r;
      const int subj = static_cast<int>(row % a.b);
      const float* e = a.eps + row * ew;
      if (c < s2) {
        const float mu = a.smu2[subj * s2 + c];
        z = a.sample_latents
                ? mu + e[cd + c] * expf(0.5f * a.slv2[subj * s2 + c])
                : mu;
      } else {
        const int cc = c - s2;
        z = joint_content(a, subj, heads_s[r * two_cd + cc],
                          heads_s[r * two_cd + cd + cc],
                          a.cmu2[subj * cd + cc], a.clv2[subj * cd + cc],
                          a.sample_latents ? e[cc] : 0.0f);
      }
    }
    z_s[i] = z;
  }
  __syncthreads();

  // 5. ROI decoder: thread owns output column n for all kRows rows
  for (int n = tid; n < d2; n += blockDim.x) {
    float acc[kRows];
    const float bias = a.bd[n];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = bias;
    for (int k = 0; k < s2; ++k) {
      const float w = a.Wds[k * d2 + n];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(z_s[r * zw + k], w, acc[r]);
    }
    for (int k = 0; k < cd; ++k) {
      const float w = a.Wdc[k * d2 + n];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(z_s[r * zw + s2 + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) a.out[(row0 + r) * d2 + n] = acc[r];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long avatar_sweep_smem_bytes(int d1, int h, int cd, int s2) {
  return static_cast<long long>(kRows) * (d1 + h + 2 * cd + s2 + cd) *
         static_cast<long long>(sizeof(float));
}

// Launches the sweep on `stream`; returns cudaGetLastError() after the
// launch (0 on success). Synchronizes nothing and allocates nothing.
int avatar_sweep_launch(const float* cdata, const float* eps, const float* Wh,
                        const float* bh, const float* Wcmu, const float* bcmu,
                        const float* Wclv, const float* bclv, const float* Wds,
                        const float* Wdc, const float* bd, const float* cmu2,
                        const float* clv2, const float* smu2,
                        const float* slv2, float* out, long long n_rows, int b,
                        int d1, int h, int cd, int s2, int d2, int method,
                        int sample_latents, void* stream) {
  SweepArgs a{cdata, eps, Wh, bh, Wcmu, bcmu, Wclv, bclv, Wds, Wdc, bd,
              cmu2, clv2, smu2, slv2, out, static_cast<int64_t>(n_rows), b, d1, h,
              cd, s2, d2,
              method, sample_latents, b / 3, 2 * (b / 3), b / 2};
  const long long smem = avatar_sweep_smem_bytes(d1, h, cd, s2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        avatar_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_rows + kRows - 1) / kRows;
  avatar_sweep_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                        static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* avatar_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
