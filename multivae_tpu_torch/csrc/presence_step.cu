// One train step of a batch where only one modality is present, joint_elbo
// branch, forward and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_presence.py::
// _presence_epoch_kernel for method joint_elbo: presence_loss_split
// (fused_presence.py:142-213, 241-244) under jax.value_and_grad. The TPU
// kernel gets its backward from in-kernel autodiff; here it is derived by
// hand. For the present modality i (mod_idx 0 or 1):
//   h = relu(x Wh + bh); cmu, clv, smu, slv = the four heads
//   t = 1/(exp(clv) + 1e-8); lv = -log t     (masked PoE of the bare expert)
//   zc = cmu + ej exp(lv/2); zs = smu + es exp(slv/2)
//   loc = zs Wds + zc Wdc + bd; nll from the present decoder only
//   loss = nll + beta (beta_style^2 KL(smu, slv) + beta_content KL(cmu, lv))
// with d lv / d clv = exp(clv) t. Out: the 9 metrics in
// presence_metric_names order and the gradient of all 28 split tensors:
// the absent modality's 14 are zero (it still takes the Adam update,
// fused_presence.py:35-37).
//
// What bounds it: the MoPoE step's half (one encoder, one decoder), so the
// same launch-bound profile (see mopoe_step.cu); 10 launches plus one
// memset of the gradient buffer. No library product, no float atomics.

#include "step_common.cuh"

namespace {

using step::kPoeEps;

constexpr int kRowThreads = 128;
constexpr int kParts = 6;  // per-row partial sums, see latent_fwd_kernel

struct Work {
  float *h, *cmu, *clv, *smu, *slv;
  float *g_cmu, *g_clv, *g_smu, *g_slv;
  float *zc, *zs, *r, *g_loc, *g_zc, *g_zs, *g_h;
  float *part;     // [kParts, B]
  float *nll_col;  // [d]
  long long total;
};

Work carve(float* base, int b, int d, int h, int cd, int s) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  const long long bl = b;
  w.h = take(bl * h);
  w.cmu = take(bl * cd);
  w.clv = take(bl * cd);
  w.smu = take(bl * s);
  w.slv = take(bl * s);
  w.g_cmu = take(bl * cd);
  w.g_clv = take(bl * cd);
  w.g_smu = take(bl * s);
  w.g_slv = take(bl * s);
  w.zc = take(bl * cd);
  w.zs = take(bl * s);
  w.r = take(bl * d);
  w.g_loc = take(bl * d);
  w.g_zc = take(bl * cd);
  w.g_zs = take(bl * s);
  w.g_h = take(bl * h);
  w.part = take(kParts * bl);
  w.nll_col = take(d);
  w.total = off;
  return w;
}

struct LatentArgs {
  const float *cmu, *clv, *smu, *slv;
  float *g_cmu, *g_clv, *g_smu, *g_slv;
  const float *ej, *es;
  int ld_ej, ld_es;
  float *zc, *zs;
  const float *g_zc, *g_zs;
  float* part;
  int b, cd, s;
  float cg, cs;  // beta beta_content / b, beta beta_style^2 / b
};

// Row partials (each [B]): 0 KL sum of the subset posterior (cmu, lv),
// 1 style KL sum, 2-5 the sums of cmu, clv, smu, slv.
__global__ void latent_fwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  float p_m = 0.0f, p_s = 0.0f;
  float m_cmu = 0.0f, m_clv = 0.0f, m_smu = 0.0f, m_slv = 0.0f;
  for (int c = 0; c < a.cd; ++c) {
    const long long j = static_cast<long long>(i) * a.cd + c;
    const float cmu = a.cmu[j], clv = a.clv[j];
    const float t = 1.0f / (expf(clv) + kPoeEps);
    const float lv = -logf(t);
    a.zc[j] = cmu + a.ej[static_cast<long long>(i) * a.ld_ej + c] *
                        expf(0.5f * lv);
    p_m += 1.0f - expf(lv) - cmu * cmu + lv;
    m_cmu += cmu;
    m_clv += clv;
  }
  for (int c = 0; c < a.s; ++c) {
    const long long j = static_cast<long long>(i) * a.s + c;
    const float smu = a.smu[j], slv = a.slv[j];
    a.zs[j] = smu + a.es[static_cast<long long>(i) * a.ld_es + c] *
                        expf(0.5f * slv);
    p_s += 1.0f - expf(slv) - smu * smu + slv;
    m_smu += smu;
    m_slv += slv;
  }
  const float parts[kParts] = {p_m, p_s, m_cmu, m_clv, m_smu, m_slv};
#pragma unroll
  for (int q = 0; q < kParts; ++q) a.part[q * a.b + i] = parts[q];
}

__global__ void latent_bwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  for (int c = 0; c < a.cd; ++c) {
    const long long j = static_cast<long long>(i) * a.cd + c;
    const float cmu = a.cmu[j], clv = a.clv[j];
    const float ev = expf(clv);
    const float t = 1.0f / (ev + kPoeEps);
    const float lv = -logf(t);
    const float ej = a.ej[static_cast<long long>(i) * a.ld_ej + c];
    const float g_zc = a.g_zc[j];
    a.g_cmu[j] = g_zc + a.cg * cmu;
    const float g_lv = g_zc * ej * 0.5f * expf(0.5f * lv) +
                       a.cg * 0.5f * (expf(lv) - 1.0f);
    a.g_clv[j] = g_lv * ev * t;
  }
  for (int c = 0; c < a.s; ++c) {
    const long long j = static_cast<long long>(i) * a.s + c;
    const float smu = a.smu[j], slv = a.slv[j];
    const float es = a.es[static_cast<long long>(i) * a.ld_es + c];
    const float g_zs = a.g_zs[j];
    a.g_smu[j] = g_zs + a.cs * smu;
    a.g_slv[j] = g_zs * es * 0.5f * expf(0.5f * slv) +
                 a.cs * 0.5f * (expf(slv) - 1.0f);
  }
}

struct MetricArgs {
  const float* part;     // [kParts, b]
  const float* nll_col;  // [d]
  float* metrics;        // [9]
  int b, d, cd, s;
  float beta, beta_style, beta_content;
};

__global__ void __launch_bounds__(step::kMetricThreads)
metrics_kernel(const MetricArgs a) {
  __shared__ float scratch[step::kMetricThreads];
  float sums[kParts];
  for (int q = 0; q < kParts; ++q) {
    const float* p = a.part + static_cast<long long>(q) * a.b;
    sums[q] = step::block_sum(a.b, [&](int i) { return p[i]; }, scratch);
  }
  const float nll_sum = step::block_sum(
      a.d, [&](int i) { return a.nll_col[i]; }, scratch);
  if (threadIdx.x != 0) return;
  const float b = static_cast<float>(a.b);
  const float nll = nll_sum / b;
  const float kld_m = -0.5f * sums[0] / b;
  const float kld_s = -0.5f * sums[1] / b;
  const float group_div = kld_m;
  const float loss = nll + a.beta * (a.beta_style * a.beta_style * kld_s +
                                     a.beta_content * group_div);
  const float n_c = b * a.cd, n_s = b * a.s;
  const float out[9] = {loss,          group_div,     nll,
                        kld_m,         kld_s,         sums[2] / n_c,
                        sums[3] / n_c, sums[4] / n_s, sums[5] / n_s};
  for (int q = 0; q < 9; ++q) a.metrics[q] = out[q];
}

#define STEP_CHECK(expr)                                    \
  do {                                                      \
    cudaError_t err_ = (expr);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace

extern "C" {

long long presence_step_workspace_floats(int b, int d, int h, int cd,
                                         int s) {
  return carve(nullptr, b, d, h, cd, s).total;
}

// One step on `stream` for the present modality `mod_idx` (x [B, d_i],
// noise ej [B, cd] and es [B, s_i]). grads and params are flat buffers of
// the split layout of both modalities; metrics holds 9 floats. Returns the
// first CUDA error (0 on success); synchronizes and allocates nothing.
int presence_step_launch(const float* params, float* grads, float* metrics,
                         const float* x, const float* ej, int ld_ej,
                         const float* es, int ld_es, float* work, int mod_idx,
                         int b, int d1, int d2, int h, int cd, int s1, int s2,
                         float beta, float beta_style, float beta_content,
                         int learn_scale, void* stream_ptr) {
  if (mod_idx != 0 && mod_idx != 1) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const step::Layout L = step::make_layout(d1, d2, h, cd, s1, s2);
  const step::EncLayout& E = L.enc[mod_idx];
  const step::DecLayout& D = L.dec[mod_idx];
  const int d = mod_idx == 0 ? d1 : d2;
  const int s = mod_idx == 0 ? s1 : s2;
  const Work w = carve(work, b, d, h, cd, s);
  const float* P = params;
  float* G = grads;

  // the absent modality's gradients are exactly zero
  STEP_CHECK(cudaMemsetAsync(G, 0, sizeof(float) * L.total, stream));
  {
    step::GemmBuilder g;
    auto* p = g.add(b, h, 0, 0, w.h, h, step::kBiasRelu, P + E.bh);
    g.add_segment(p, x, d, P + E.Wh, h, d);
    STEP_CHECK(g.launch(stream));
  }
  const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
  const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
  float* heads[4] = {w.cmu, w.clv, w.smu, w.slv};
  float* g_heads[4] = {w.g_cmu, w.g_clv, w.g_smu, w.g_slv};
  const int n[4] = {cd, cd, s, s};
  {
    step::GemmBuilder g;
    for (int k = 0; k < 4; ++k) {
      auto* p = g.add(b, n[k], 0, 0, heads[k], n[k], step::kBias, P + bo[k]);
      g.add_segment(p, w.h, h, P + Wo[k], n[k], h);
    }
    STEP_CHECK(g.launch(stream));
  }
  LatentArgs la{w.cmu, w.clv, w.smu, w.slv, w.g_cmu, w.g_clv, w.g_smu,
                w.g_slv, ej, es, ld_ej, ld_es, w.zc, w.zs, w.g_zc, w.g_zs,
                w.part, b, cd, s,
                beta * beta_content / static_cast<float>(b),
                beta * beta_style * beta_style / static_cast<float>(b)};
  const int row_blocks = (b + kRowThreads - 1) / kRowThreads;
  latent_fwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  {
    step::GemmBuilder g;
    auto* p = g.add(b, d, 0, 0, w.r, d, step::kResidual, P + D.bd, x, d);
    g.add_segment(p, w.zs, s, P + D.Wds, d, s);
    g.add_segment(p, w.zc, cd, P + D.Wdc, d, cd);
    STEP_CHECK(g.launch(stream));
  }
  {
    step::DecReduceBatch rb;
    rb.p[0] = step::DecReduce{w.r, P + D.olv, w.g_loc, G + D.bd, G + D.olv,
                              w.nll_col, d};
    rb.p[1] = rb.p[0];
    rb.b = b;
    rb.learn_scale = learn_scale;
    dim3 grid((d + step::kColThreads - 1) / step::kColThreads, 1);
    step::dec_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    STEP_CHECK(cudaGetLastError());
  }
  {
    step::GemmBuilder g;
    auto* p = g.add(s, d, 1, 0, G + D.Wds, d);  // zs^T g_loc
    g.add_segment(p, w.zs, s, w.g_loc, d, b);
    p = g.add(cd, d, 1, 0, G + D.Wdc, d);       // zc^T g_loc
    g.add_segment(p, w.zc, cd, w.g_loc, d, b);
    p = g.add(b, s, 0, 1, w.g_zs, s);           // g_loc Wds^T
    g.add_segment(p, w.g_loc, d, P + D.Wds, d, d);
    p = g.add(b, cd, 0, 1, w.g_zc, cd);         // g_loc Wdc^T
    g.add_segment(p, w.g_loc, d, P + D.Wdc, d, d);
    STEP_CHECK(g.launch(stream));
  }
  latent_bwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  {
    step::GemmBuilder g;
    for (int k = 0; k < 4; ++k) {
      auto* p = g.add(h, n[k], 1, 0, G + Wo[k], n[k]);  // h^T g_head
      g.add_segment(p, w.h, h, g_heads[k], n[k], b);
    }
    auto* p = g.add(b, h, 0, 1, w.g_h, h, step::kReluMask, nullptr, w.h, h);
    for (int k = 0; k < 4; ++k) {
      g.add_segment(p, g_heads[k], n[k], P + Wo[k], n[k], n[k]);
    }
    STEP_CHECK(g.launch(stream));
  }
  {
    step::ColSumBuilder c;
    for (int k = 0; k < 4; ++k) c.add(g_heads[k], b, n[k], G + bo[k]);
    c.add(w.g_h, b, h, G + E.bh);
    STEP_CHECK(c.launch(stream));
  }
  {
    step::GemmBuilder g;
    auto* p = g.add(d, h, 1, 0, G + E.Wh, h);  // x^T g_h
    g.add_segment(p, x, d, w.g_h, h, b);
    STEP_CHECK(g.launch(stream));
  }
  MetricArgs ma{w.part, w.nll_col, metrics, b, d, cd, s,
                beta, beta_style, beta_content};
  metrics_kernel<<<1, step::kMetricThreads, 0, stream>>>(ma);
  STEP_CHECK(cudaGetLastError());
  return 0;
}

const char* presence_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
