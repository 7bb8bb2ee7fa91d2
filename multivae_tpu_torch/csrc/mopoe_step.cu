// One MoPoE (joint_elbo) train step, forward and hand-derived backward, for
// Hopper (sm_90a).
//
// Replaces multivae_tpu/ops/fused_step.py::_fused_kernel (one step,
// fused_loss_and_grads) and the step inside ::_epoch_kernel (fused_epoch),
// whose math is ::_fwd_bwd (fused_step.py:319-499); the same math at any row
// count B is the joint_elbo branch of fused_methods.py::_method_epoch_kernel.
// In: the 28 split tensors as one flat buffer (step_common.cuh,
// make_layout), x1 [B, d1], x2 [B, d2] and the noise ej [B, cd],
// es1 [B, s1], es2 [B, s2] (each with its own row stride). Out: the 17
// metrics in METRIC_TEMPLATES order (loss first) and the gradient of every
// split tensor in a flat buffer of the same layout.
//
// The same step on one shard's row slice of a batch (mopoe_step_slice_launch)
// replaces multivae_tpu/ops/fused_sharded.py::_dp_kernel: the rows at hand
// are rows [row_offset, row_offset + B) of a batch of b_total rows. The
// 3-way mixture partition is the whole batch's (a row compares its global
// index with floor(b_total / 3) and twice that), every sum that the loss
// holds is divided by b_total, so metrics 0-8 and all gradients are partial
// sums that add up over the shards to the whole batch's; metrics 9-16 (the
// latent means) stay means over the local rows, as in the TPU kernel, and
// the caller divides their sum by the number of shards. Workspace, grids
// and every product's row extent are the local B. With row_offset = 0 and
// b_total = B it is the unsharded step, bit for bit: mopoe_step_launch
// calls it so.
//
// What bounds it: at the flagship widths (d = 7/444, h = 256, cd = 20,
// s = 3/20) and B = 256 a step needs ~195 MFLOP over ~0.67 MB of params, a
// few MB of activations at most: compute-light, and every product is small
// (M, N, K <= 444), so launch count and the serial K loops bound it, not
// HBM or the f32 pipes. The TPU kernel keeps params and both Adam moments
// resident in VMEM for a whole epoch; 2 MB do not fit one SM's 228 KB of
// shared memory, so here a step is 11 launches on one stream (the host
// loops the epoch, flat_adam.cu updates the state after each step):
//   1. grouped GEMM  h_e = relu(x_e Wh_e + bh_e)                 (2 problems)
//   2. grouped GEMM  the 8 encoder heads (+ bias)                (8)
//   3. latent_fwd    PoE, 3-way mixture rows, reparameterization, per-row
//                    KL and mean partial sums (one thread per row)
//   4. grouped GEMM  r_e = x_e - (zs_e Wds_e + zc Wdc_e + bd_e)  (2, 2 segs)
//   5. dec_colreduce g_loc, bias and out-logvar grads, NLL column sums
//   6. grouped GEMM  dWds, dWdc (A^T G), g_zs, g_zc (G W^T)      (7)
//   7. latent_bwd    head-output grads (one thread per row)
//   8. grouped GEMM  head weight grads (h^T G) and g_h (4 segs, ReLU mask)
//   9. colsum        head and hidden bias grads                  (10)
//  10. grouped GEMM  dWh_e = x_e^T g_h_e                          (2)
//  11. metrics       fixed-order tree sums -> the 17 metrics (one block)
// No library product (no cuBLAS), no float atomics: every sum has one fixed
// order, so two runs give the same bits. Tensor cores (TF32/bf16 wgmma),
// TMA and a persistent whole-step kernel are later work.

#include <initializer_list>

#include "step_common.cuh"

namespace {

using step::kLog2Pi;
using step::kPoeEps;

constexpr int kRowThreads = 128;
constexpr int kParts = 13;  // per-row partial sums, see latent_fwd_kernel

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct Work {
  float *h[2];
  Heads heads[2], g_heads[2];
  float *zc, *zs[2];
  float *r[2], *g_loc[2];
  float *g_zs[2], *g_zc;
  float *g_h[2];
  float *part;     // [kParts, B]
  float *nll_col;  // [d1 + d2]
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
Work carve(float* base, int b, int d1, int d2, int h, int cd, int s1,
           int s2) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  for (int e = 0; e < 2; ++e) w.h[e] = take(static_cast<long long>(b) * h);
  for (int e = 0; e < 2; ++e) {
    for (Heads* H : {&w.heads[e], &w.g_heads[e]}) {
      H->cmu = take(static_cast<long long>(b) * cd);
      H->clv = take(static_cast<long long>(b) * cd);
      H->smu = take(static_cast<long long>(b) * s[e]);
      H->slv = take(static_cast<long long>(b) * s[e]);
    }
  }
  w.zc = take(static_cast<long long>(b) * cd);
  w.g_zc = take(static_cast<long long>(b) * cd);
  for (int e = 0; e < 2; ++e) {
    w.zs[e] = take(static_cast<long long>(b) * s[e]);
    w.g_zs[e] = take(static_cast<long long>(b) * s[e]);
    w.r[e] = take(static_cast<long long>(b) * d[e]);
    w.g_loc[e] = take(static_cast<long long>(b) * d[e]);
    w.g_h[e] = take(static_cast<long long>(b) * h);
  }
  w.part = take(static_cast<long long>(kParts) * b);
  w.nll_col = take(d1 + d2);
  w.total = off;
  return w;
}

struct LatentArgs {
  Heads heads[2], g_heads[2];
  const float *ej, *es[2];
  int ld_ej, ld_es[2];
  float *zc, *zs[2];
  const float *g_zc, *g_zs[2];
  float* part;
  int b, cd, s[2];
  int row_offset, k1, k2;  // global index of local row 0; partition bounds
  // beta beta_content / (3 b_total), beta beta_style^2 / b_total
  float cg, cs;
};

// Forward latents, one thread per row. Row partials (each [B]):
// 0-2 KL sums of the subsets a, b, c; 3-4 style KL sums; 5-12 the sums of
// cmu1, clv1, smu1, slv1, cmu2, clv2, smu2, slv2 (for the latent means).
// A KL sum is sum(1 - exp(lv) - mu^2 + lv); the metric is -0.5 sum / b_total.
__global__ void latent_fwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int gi = a.row_offset + i;  // the row's index in the whole batch
  const bool in_a = gi < a.k1, in_b = gi >= a.k1 && gi < a.k2;
  float p_a = 0.0f, p_b = 0.0f, p_c = 0.0f;
  float m_cmu1 = 0.0f, m_clv1 = 0.0f, m_cmu2 = 0.0f, m_clv2 = 0.0f;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = a.heads[0].cmu[j], clv1 = a.heads[0].clv[j];
    const float cmu2 = a.heads[1].cmu[j], clv2 = a.heads[1].clv[j];
    const float t1 = 1.0f / (expf(clv1) + kPoeEps);
    const float t2 = 1.0f / (expf(clv2) + kPoeEps);
    const float lv_a = -logf(t1), lv_b = -logf(t2);
    const float ts = t1 + t2 + tp;
    const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
    const float lv_c = -logf(ts);
    const float jmu = in_a ? cmu1 : (in_b ? cmu2 : mu_c);
    const float jlv = in_a ? lv_a : (in_b ? lv_b : lv_c);
    a.zc[j] = jmu + a.ej[static_cast<long long>(i) * a.ld_ej + c] *
                        expf(0.5f * jlv);
    p_a += 1.0f - expf(lv_a) - cmu1 * cmu1 + lv_a;
    p_b += 1.0f - expf(lv_b) - cmu2 * cmu2 + lv_b;
    p_c += 1.0f - expf(lv_c) - mu_c * mu_c + lv_c;
    m_cmu1 += cmu1;
    m_clv1 += clv1;
    m_cmu2 += cmu2;
    m_clv2 += clv2;
  }
  float p_s[2], m_smu[2], m_slv[2];
  for (int e = 0; e < 2; ++e) {
    const int s = a.s[e];
    p_s[e] = m_smu[e] = m_slv[e] = 0.0f;
    for (int c = 0; c < s; ++c) {
      const long long j = static_cast<long long>(i) * s + c;
      const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
      a.zs[e][j] = smu + a.es[e][static_cast<long long>(i) * a.ld_es[e] + c] *
                             expf(0.5f * slv);
      p_s[e] += 1.0f - expf(slv) - smu * smu + slv;
      m_smu[e] += smu;
      m_slv[e] += slv;
    }
  }
  const float parts[kParts] = {p_a,      p_b,      p_c,      p_s[0],   p_s[1],
                               m_cmu1,   m_clv1,   m_smu[0], m_slv[0], m_cmu2,
                               m_clv2,   m_smu[1], m_slv[1]};
#pragma unroll
  for (int q = 0; q < kParts; ++q) a.part[q * a.b + i] = parts[q];
}

// Backward of latent_fwd: the gradients of the 8 head outputs, one thread
// per row (fused_step.py:452-474).
__global__ void latent_bwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int gi = a.row_offset + i;
  const float m_a = gi < a.k1 ? 1.0f : 0.0f;
  const float m_b = (gi >= a.k1 && gi < a.k2) ? 1.0f : 0.0f;
  const float m_c = gi >= a.k2 ? 1.0f : 0.0f;
  const float cg = a.cg;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = a.heads[0].cmu[j], clv1 = a.heads[0].clv[j];
    const float cmu2 = a.heads[1].cmu[j], clv2 = a.heads[1].clv[j];
    const float ev1 = expf(clv1), ev2 = expf(clv2);
    const float t1 = 1.0f / (ev1 + kPoeEps);
    const float t2 = 1.0f / (ev2 + kPoeEps);
    const float lv_a = -logf(t1), lv_b = -logf(t2);
    const float ts = t1 + t2 + tp;
    const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
    const float lv_c = -logf(ts);
    const float jlv = m_a * lv_a + m_b * lv_b + m_c * lv_c;
    const float sj = expf(0.5f * jlv);
    const float ej = a.ej[static_cast<long long>(i) * a.ld_ej + c];
    const float g_jmu = a.g_zc[j];
    const float g_jlv = g_jmu * ej * 0.5f * sj;
    const float g_mu_a = m_a * g_jmu + cg * cmu1;
    const float g_mu_b = m_b * g_jmu + cg * cmu2;
    const float g_mu_c = m_c * g_jmu + cg * mu_c;
    const float g_lv_a = m_a * g_jlv + cg * 0.5f * (expf(lv_a) - 1.0f);
    const float g_lv_b = m_b * g_jlv + cg * 0.5f * (expf(lv_b) - 1.0f);
    const float g_lv_c = m_c * g_jlv + cg * 0.5f * (expf(lv_c) - 1.0f);
    a.g_heads[0].cmu[j] = g_mu_a + g_mu_c * (t1 / ts);
    a.g_heads[1].cmu[j] = g_mu_b + g_mu_c * (t2 / ts);
    const float g_t1 = g_mu_c * (cmu1 - mu_c) / ts - g_lv_c / ts;
    const float g_t2 = g_mu_c * (cmu2 - mu_c) / ts - g_lv_c / ts;
    a.g_heads[0].clv[j] = g_lv_a * ev1 * t1 + g_t1 * (-ev1 * t1 * t1);
    a.g_heads[1].clv[j] = g_lv_b * ev2 * t2 + g_t2 * (-ev2 * t2 * t2);
  }
  for (int e = 0; e < 2; ++e) {
    const int s = a.s[e];
    for (int c = 0; c < s; ++c) {
      const long long j = static_cast<long long>(i) * s + c;
      const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
      const float es = a.es[e][static_cast<long long>(i) * a.ld_es[e] + c];
      const float g_zs = a.g_zs[e][j];
      a.g_heads[e].smu[j] = g_zs + a.cs * smu;
      a.g_heads[e].slv[j] = g_zs * es * 0.5f * expf(0.5f * slv) +
                            a.cs * 0.5f * (expf(slv) - 1.0f);
    }
  }
}

struct MetricArgs {
  const float* part;     // [kParts, b]
  const float* nll_col;  // [d1 + d2]
  float* metrics;        // [17]
  int b, b_total, d1, d2, cd, s1, s2;
  float beta, beta_style, beta_content;
};

// Sums over the local rows: those of the loss divided by b_total (partial
// sums of the whole batch's), the latent means by the local element count.
__global__ void __launch_bounds__(step::kMetricThreads)
metrics_kernel(const MetricArgs a) {
  __shared__ float scratch[step::kMetricThreads];
  float sums[kParts];
  for (int q = 0; q < kParts; ++q) {
    const float* p = a.part + static_cast<long long>(q) * a.b;
    sums[q] = step::block_sum(a.b, [&](int i) { return p[i]; }, scratch);
  }
  const float nll1_sum = step::block_sum(
      a.d1, [&](int i) { return a.nll_col[i]; }, scratch);
  const float nll2_sum = step::block_sum(
      a.d2, [&](int i) { return a.nll_col[a.d1 + i]; }, scratch);
  if (threadIdx.x != 0) return;
  const float b = static_cast<float>(a.b_total);
  const float nll1 = nll1_sum / b, nll2 = nll2_sum / b;
  const float kld_a = -0.5f * sums[0] / b;
  const float kld_b = -0.5f * sums[1] / b;
  const float kld_c = -0.5f * sums[2] / b;
  const float kld_s1 = -0.5f * sums[3] / b;
  const float kld_s2 = -0.5f * sums[4] / b;
  const float group_div = (kld_a + kld_b + kld_c) / 3.0f;
  const float kld_style = kld_s1 + kld_s2;
  const float loss =
      nll1 + nll2 + a.beta * (a.beta_style * a.beta_style * kld_style +
                              a.beta_content * group_div);
  const float bl = static_cast<float>(a.b);
  const float n_c = bl * a.cd, n_s1 = bl * a.s1, n_s2 = bl * a.s2;
  const float out[17] = {loss,  group_div, nll1, nll2, kld_a, kld_b,
                         kld_c, kld_s1,    kld_s2,
                         sums[5] / n_c,  sums[6] / n_c,
                         sums[7] / n_s1, sums[8] / n_s1,
                         sums[9] / n_c,  sums[10] / n_c,
                         sums[11] / n_s2, sums[12] / n_s2};
  for (int q = 0; q < 17; ++q) a.metrics[q] = out[q];
}

#define STEP_CHECK(expr)                          \
  do {                                            \
    cudaError_t err_ = (expr);                    \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace

extern "C" {

long long mopoe_step_param_floats(int d1, int d2, int h, int cd, int s1,
                                  int s2) {
  return step::make_layout(d1, d2, h, cd, s1, s2).total;
}

long long mopoe_step_workspace_floats(int b, int d1, int d2, int h, int cd,
                                      int s1, int s2) {
  return carve(nullptr, b, d1, d2, h, cd, s1, s2).total;
}

// One step on `stream` over rows [row_offset, row_offset + b) of a batch of
// b_total rows: grads (flat, split layout) and metrics[17] from the flat
// params, as partial sums of the whole batch's (see the header). Returns the
// first CUDA error (0 on success). Synchronizes nothing and allocates
// nothing: `work` holds mopoe_step_workspace_floats(b, ...) floats.
int mopoe_step_slice_launch(const float* params, float* grads, float* metrics,
                            const float* x1, const float* x2, const float* ej,
                            int ld_ej, const float* es1, int ld_es1,
                            const float* es2, int ld_es2, float* work, int b,
                            int row_offset, int b_total, int d1, int d2,
                            int h, int cd, int s1, int s2, float beta,
                            float beta_style, float beta_content,
                            int learn_scale, void* stream_ptr) {
  if (b < 1 || row_offset < 0 || b_total < row_offset + b) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const step::Layout L = step::make_layout(d1, d2, h, cd, s1, s2);
  const Work w = carve(work, b, d1, d2, h, cd, s1, s2);
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  const float* x[2] = {x1, x2};
  const float* P = params;
  float* G = grads;

  // 1. hidden layers
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      auto* p = g.add(b, h, 0, 0, w.h[e], h, step::kBiasRelu,
                      P + L.enc[e].bh);
      g.add_segment(p, x[e], d[e], P + L.enc[e].Wh, h, d[e]);
    }
    STEP_CHECK(g.launch(stream));
  }
  // 2. encoder heads
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
      const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
      float* out[4] = {w.heads[e].cmu, w.heads[e].clv, w.heads[e].smu,
                       w.heads[e].slv};
      const int n[4] = {cd, cd, s[e], s[e]};
      for (int k = 0; k < 4; ++k) {
        auto* p = g.add(b, n[k], 0, 0, out[k], n[k], step::kBias, P + bo[k]);
        g.add_segment(p, w.h[e], h, P + Wo[k], n[k], h);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 3. latents
  LatentArgs la;
  for (int e = 0; e < 2; ++e) {
    la.heads[e] = w.heads[e];
    la.g_heads[e] = w.g_heads[e];
    la.zs[e] = w.zs[e];
    la.g_zs[e] = w.g_zs[e];
    la.s[e] = s[e];
  }
  la.ej = ej;
  la.ld_ej = ld_ej;
  la.es[0] = es1;
  la.es[1] = es2;
  la.ld_es[0] = ld_es1;
  la.ld_es[1] = ld_es2;
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  la.b = b;
  la.cd = cd;
  la.row_offset = row_offset;
  la.k1 = b_total / 3;  // floor(b_total / 3), fused_step.py:251-255, 333
  la.k2 = 2 * (b_total / 3);
  la.cg = beta * beta_content / (3.0f * static_cast<float>(b_total));
  la.cs = beta * beta_style * beta_style / static_cast<float>(b_total);
  const int row_blocks = (b + kRowThreads - 1) / kRowThreads;
  latent_fwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 4. decoders: r = x - (zs Wds + zc Wdc + bd)
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* p = g.add(b, d[e], 0, 0, w.r[e], d[e], step::kResidual,
                      P + D.bd, x[e], d[e]);
      g.add_segment(p, w.zs[e], s[e], P + D.Wds, d[e], s[e]);
      g.add_segment(p, w.zc, cd, P + D.Wdc, d[e], cd);
    }
    STEP_CHECK(g.launch(stream));
  }
  // 5. g_loc, bias / out-logvar grads, NLL column sums
  {
    step::DecReduceBatch rb;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      rb.p[e] = step::DecReduce{w.r[e], P + D.olv, w.g_loc[e], G + D.bd,
                                G + D.olv, w.nll_col + (e == 0 ? 0 : d1),
                                d[e], nullptr, nullptr, nullptr};
    }
    rb.b = b;
    rb.b_total = b_total;
    rb.learn_scale = learn_scale;
    const int dmax = d1 > d2 ? d1 : d2;
    dim3 grid((dmax + step::kColThreads - 1) / step::kColThreads, 2);
    step::dec_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    STEP_CHECK(cudaGetLastError());
  }
  // 6. decoder weight grads and the latents' grads
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* p = g.add(s[e], d[e], 1, 0, G + D.Wds, d[e]);  // zs^T g_loc
      g.add_segment(p, w.zs[e], s[e], w.g_loc[e], d[e], b);
      p = g.add(cd, d[e], 1, 0, G + D.Wdc, d[e]);           // zc^T g_loc
      g.add_segment(p, w.zc, cd, w.g_loc[e], d[e], b);
      p = g.add(b, s[e], 0, 1, w.g_zs[e], s[e]);            // g_loc Wds^T
      g.add_segment(p, w.g_loc[e], d[e], P + D.Wds, d[e], d[e]);
    }
    auto* p = g.add(b, cd, 0, 1, w.g_zc, cd);  // sum_e g_loc_e Wdc_e^T
    for (int e = 0; e < 2; ++e) {
      g.add_segment(p, w.g_loc[e], d[e], P + L.dec[e].Wdc, d[e], d[e]);
    }
    STEP_CHECK(g.launch(stream));
  }
  // 7. head-output grads
  latent_bwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 8. head weight grads, and g_h = (sum_k g_head_k W_k^T) * (h > 0)
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
      const float* gh[4] = {w.g_heads[e].cmu, w.g_heads[e].clv,
                            w.g_heads[e].smu, w.g_heads[e].slv};
      const int n[4] = {cd, cd, s[e], s[e]};
      for (int k = 0; k < 4; ++k) {
        auto* p = g.add(h, n[k], 1, 0, G + Wo[k], n[k]);
        g.add_segment(p, w.h[e], h, gh[k], n[k], b);
      }
    }
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
      const float* gh[4] = {w.g_heads[e].cmu, w.g_heads[e].clv,
                            w.g_heads[e].smu, w.g_heads[e].slv};
      const int n[4] = {cd, cd, s[e], s[e]};
      auto* p = g.add(b, h, 0, 1, w.g_h[e], h, step::kReluMask, nullptr,
                      w.h[e], h);
      for (int k = 0; k < 4; ++k) {
        g.add_segment(p, gh[k], n[k], P + Wo[k], n[k], n[k]);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 9. head and hidden bias grads
  {
    step::ColSumBuilder c;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      c.add(w.g_heads[e].cmu, b, cd, G + E.bcmu);
      c.add(w.g_heads[e].clv, b, cd, G + E.bclv);
      c.add(w.g_heads[e].smu, b, s[e], G + E.bsmu);
      c.add(w.g_heads[e].slv, b, s[e], G + E.bslv);
      c.add(w.g_h[e], b, h, G + E.bh);
    }
    STEP_CHECK(c.launch(stream));
  }
  // 10. hidden weight grads
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      auto* p = g.add(d[e], h, 1, 0, G + L.enc[e].Wh, h);  // x^T g_h
      g.add_segment(p, x[e], d[e], w.g_h[e], h, b);
    }
    STEP_CHECK(g.launch(stream));
  }
  // 11. metrics
  MetricArgs ma{w.part, w.nll_col, metrics, b, b_total, d1, d2, cd, s1, s2,
                beta, beta_style, beta_content};
  metrics_kernel<<<1, step::kMetricThreads, 0, stream>>>(ma);
  STEP_CHECK(cudaGetLastError());
  return 0;
}

// The unsharded step: the slice that is the whole batch.
int mopoe_step_launch(const float* params, float* grads, float* metrics,
                      const float* x1, const float* x2, const float* ej,
                      int ld_ej, const float* es1, int ld_es1,
                      const float* es2, int ld_es2, float* work, int b,
                      int d1, int d2, int h, int cd, int s1, int s2,
                      float beta, float beta_style, float beta_content,
                      int learn_scale, void* stream_ptr) {
  return mopoe_step_slice_launch(params, grads, metrics, x1, x2, ej, ld_ej,
                                 es1, ld_es1, es2, ld_es2, work, b, 0, b, d1,
                                 d2, h, cd, s1, s2, beta, beta_style,
                                 beta_content, learn_scale, stream_ptr);
}

const char* mopoe_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
