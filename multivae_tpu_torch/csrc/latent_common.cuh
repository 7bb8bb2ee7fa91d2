// The methods' latent math of a complete-batch train step, shared by
// method_step.cu and generic_step.cu, for Hopper (sm_90a): what stands
// between the encoders' head outputs and the decoders' inputs, forward and
// hand-derived backward, and the step's metric reduction.
//
// * latent_fwd_kernel: per row, the subset posteriors of the method, the
//   joint selection, the reparameterization with the streamed noise (zc, zs
//   and, for poe, the unimodal zcu, zsu) and the row partials of the KL sums
//   and latent means.
// * latent_bwd_kernel: the gradients of the head outputs from those of the
//   latents (and, for poe with masks, of the unimodal encoding's heads).
// * metrics_kernel: the 17 metrics of method_metric_names (19 for poe) from
//   the row partials and the decoders' per-column NLL sums, every sum in a
//   fixed order.
//
// The methods are described at the top of method_step.cu. Nothing here knows
// what produced the heads or what consumes the latents: the networks around
// are the caller's.

#pragma once

#include "step_common.cuh"

namespace latent {

using step::kPoeEps;

constexpr int kRowThreads = 128;
constexpr int kParts = 14;  // per-row partial sums, see latent_fwd_kernel

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct LatentArgs {
  Heads heads[2], g_heads[2];    // the first encoding
  Heads uheads[2], g_uheads[2];  // poe: the unimodal pass's
  int separate;  // poe: the unimodal pass has an encoding of its own
  const float* noise;
  int ld, es_off[2], uj_off[2], us_off[2];
  float *zc, *zs[2], *zcu[2], *zsu[2];
  const float *g_zc, *g_zs[2], *g_zcu[2], *g_zsu[2];
  float* part;
  int method, b, cd, s[2];
  int row_offset;    // global index of local row 0
  int k3a, k3b, k2;  // bounds of the 3-way and the 2-way partition (global)
  float cg, cs;      // KL coefficients / b_total, see the launch function
};

// The parts of LatentArgs that depend only on the step's sizes and weights:
// the noise and its column offsets (cd | s1 | s2, poe appends cd | s1 and
// cd | s2), the row partitions of a batch of b_total rows, and the KL
// coefficients.
inline void set_latent_consts(LatentArgs& la, int method, int b,
                              int row_offset, int b_total, int cd, int s1,
                              int s2, const float* noise, int ld_noise,
                              float beta, float beta_style,
                              float beta_content) {
  la.noise = noise;
  la.ld = ld_noise;
  const int off = cd + s1 + s2;
  la.es_off[0] = cd;
  la.es_off[1] = cd + s1;
  la.uj_off[0] = off;
  la.us_off[0] = off + cd;
  la.uj_off[1] = off + cd + s1;
  la.us_off[1] = off + 2 * cd + s1;
  la.method = method;
  la.b = b;
  la.cd = cd;
  la.s[0] = s1;
  la.s[1] = s2;
  la.row_offset = row_offset;
  la.k3a = b_total / 3;  // floor(b_total / k) i, fused_methods.py:125-139
  la.k3b = 2 * (b_total / 3);
  la.k2 = b_total / 2;
  const float bf = static_cast<float>(b_total);
  // the divergence's weight on each unit-prior (jsd: dynamic-prior) KL
  const float n_kl = method == kJointElbo || method == kJsd ? 3.0f
                     : method == kMoe                      ? 2.0f
                                                           : 1.0f;
  la.cg = beta * beta_content / (n_kl * bf);
  // poe counts each style KL in the unimodal and in the joint ELBO
  la.cs = (method == kPoe ? 2.0f : 1.0f) * beta * beta_style * beta_style / bf;
}

// sum term of a KL to the unit prior: the metric is -0.5 sum / b_total
__device__ inline float kl_term(float mu, float lv) {
  return 1.0f - expf(lv) - mu * mu + lv;
}

// Forward latents, one thread per row. Row partials (each [B]):
// 0-2 KL sums of the subsets a, b, c; 3-4 style KL sums; 5-12 the sums of
// cmu1, clv1, smu1, slv1, cmu2, clv2, smu2, slv2 (for the latent means);
// 13 jsd: the sum of the three KLs against the dynamic prior.
__global__ void latent_fwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = a.noise + static_cast<long long>(i) * a.ld;
  const int gi = a.row_offset + i;  // the row's index in the whole batch
  const bool in3a = gi < a.k3a, in3b = gi >= a.k3a && gi < a.k3b;
  const bool in2a = gi < a.k2;
  float p_a = 0.0f, p_b = 0.0f, p_c = 0.0f, p_j = 0.0f;
  float m_cmu1 = 0.0f, m_clv1 = 0.0f, m_cmu2 = 0.0f, m_clv2 = 0.0f;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = a.heads[0].cmu[j], clv1 = a.heads[0].clv[j];
    const float cmu2 = a.heads[1].cmu[j], clv2 = a.heads[1].clv[j];
    const float ev1 = expf(clv1), ev2 = expf(clv2);
    const float t1 = 1.0f / (ev1 + kPoeEps);
    const float t2 = 1.0f / (ev2 + kPoeEps);
    float jmu, jlv;
    if (a.method == kJointElbo) {
      const float lv_a = -logf(t1), lv_b = -logf(t2);
      const float ts = t1 + t2 + tp;
      const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
      const float lv_c = -logf(ts);
      jmu = in3a ? cmu1 : (in3b ? cmu2 : mu_c);
      jlv = in3a ? lv_a : (in3b ? lv_b : lv_c);
      p_a += kl_term(cmu1, lv_a);
      p_b += kl_term(cmu2, lv_b);
      p_c += kl_term(mu_c, lv_c);
    } else if (a.method == kMoe) {
      jmu = in2a ? cmu1 : cmu2;
      jlv = in2a ? clv1 : clv2;
      p_a += kl_term(cmu1, clv1);
      p_b += kl_term(cmu2, clv2);
      p_c += kl_term(jmu, jlv);
    } else if (a.method == kJsd) {
      jmu = in3a ? cmu1 : (in3b ? cmu2 : 0.0f);  // unit rows: mu = 0
      jlv = in3a ? clv1 : (in3b ? clv2 : 0.0f);  // unit rows: logvar = 0
      p_a += kl_term(cmu1, clv1);
      p_b += kl_term(cmu2, clv2);
      p_c += in2a ? kl_term(cmu1, clv1) : kl_term(cmu2, clv2);
      const float S = t1 + t2 + tp;
      const float pm = (cmu1 * t1 + cmu2 * t2) / S;
      const float ipv = S / 3.0f;  // exp(-plv)
      const float plv = -logf(ipv);
      const float d1 = cmu1 - pm, d2 = cmu2 - pm;
      p_j += (1.0f - ev1 * ipv - d1 * d1 * ipv + clv1 - plv) +
             (1.0f - ev2 * ipv - d2 * d2 * ipv + clv2 - plv) +
             (1.0f - ipv - pm * pm * ipv - plv);
    } else {  // poe
      const float ts_a = t1 + tp, ts_b = t2 + tp, ts_c = t1 + t2 + tp;
      const float mu_a = cmu1 * t1 / ts_a, lv_a = -logf(ts_a);
      const float mu_b = cmu2 * t2 / ts_b, lv_b = -logf(ts_b);
      jmu = (cmu1 * t1 + cmu2 * t2) / ts_c;
      jlv = -logf(ts_c);
      p_a += kl_term(mu_a, lv_a);
      p_b += kl_term(mu_b, lv_b);
      p_c += kl_term(jmu, jlv);
      float mu_u[2] = {mu_a, mu_b}, lv_u[2] = {lv_a, lv_b};
      if (a.separate) {
        for (int e = 0; e < 2; ++e) {
          const float cmuu = a.uheads[e].cmu[j];
          const float tu = 1.0f / (expf(a.uheads[e].clv[j]) + kPoeEps);
          mu_u[e] = cmuu * tu / (tu + tp);
          lv_u[e] = -logf(tu + tp);
        }
      }
      for (int e = 0; e < 2; ++e) {
        a.zcu[e][j] = mu_u[e] + nz[a.uj_off[e] + c] * expf(0.5f * lv_u[e]);
      }
    }
    a.zc[j] = jmu + nz[c] * expf(0.5f * jlv);
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
      a.zs[e][j] = smu + nz[a.es_off[e] + c] * expf(0.5f * slv);
      if (a.method == kPoe) {
        a.zsu[e][j] = a.uheads[e].smu[j] +
                      nz[a.us_off[e] + c] * expf(0.5f * a.uheads[e].slv[j]);
      }
      p_s[e] += kl_term(smu, slv);
      m_smu[e] += smu;
      m_slv[e] += slv;
    }
  }
  const float parts[kParts] = {p_a,      p_b,    p_c,      p_s[0],   p_s[1],
                               m_cmu1,   m_clv1, m_smu[0], m_slv[0], m_cmu2,
                               m_clv2,   m_smu[1], m_slv[1], p_j};
#pragma unroll
  for (int q = 0; q < kParts; ++q) a.part[q * a.b + i] = parts[q];
}

// Backward of latent_fwd: the gradients of the head outputs of the first
// encoding (and, for poe with masks, of the unimodal one), one thread per
// row. cg x is the gradient of a unit-prior KL's mu, cg (exp(lv) - 1) / 2
// its logvar's.
__global__ void latent_bwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = a.noise + static_cast<long long>(i) * a.ld;
  const int gi = a.row_offset + i;
  const float m3a = gi < a.k3a ? 1.0f : 0.0f;
  const float m3b = (gi >= a.k3a && gi < a.k3b) ? 1.0f : 0.0f;
  const float m3c = gi >= a.k3b ? 1.0f : 0.0f;
  const float m2a = gi < a.k2 ? 1.0f : 0.0f, m2b = 1.0f - m2a;
  const float cg = a.cg;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = a.heads[0].cmu[j], clv1 = a.heads[0].clv[j];
    const float cmu2 = a.heads[1].cmu[j], clv2 = a.heads[1].clv[j];
    const float ev1 = expf(clv1), ev2 = expf(clv2);
    const float t1 = 1.0f / (ev1 + kPoeEps);
    const float t2 = 1.0f / (ev2 + kPoeEps);
    const float ej = nz[c];
    const float g_jmu = a.g_zc[j];
    float g_cmu1, g_clv1, g_cmu2, g_clv2;
    if (a.method == kJointElbo) {
      const float lv_a = -logf(t1), lv_b = -logf(t2);
      const float ts = t1 + t2 + tp;
      const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
      const float lv_c = -logf(ts);
      const float jlv = m3a * lv_a + m3b * lv_b + m3c * lv_c;
      const float g_jlv = g_jmu * ej * 0.5f * expf(0.5f * jlv);
      const float g_mu_c = m3c * g_jmu + cg * mu_c;
      const float g_lv_a = m3a * g_jlv + cg * 0.5f * (expf(lv_a) - 1.0f);
      const float g_lv_b = m3b * g_jlv + cg * 0.5f * (expf(lv_b) - 1.0f);
      const float g_lv_c = m3c * g_jlv + cg * 0.5f * (expf(lv_c) - 1.0f);
      g_cmu1 = m3a * g_jmu + cg * cmu1 + g_mu_c * (t1 / ts);
      g_cmu2 = m3b * g_jmu + cg * cmu2 + g_mu_c * (t2 / ts);
      const float g_t1 = g_mu_c * (cmu1 - mu_c) / ts - g_lv_c / ts;
      const float g_t2 = g_mu_c * (cmu2 - mu_c) / ts - g_lv_c / ts;
      g_clv1 = g_lv_a * ev1 * t1 + g_t1 * (-ev1 * t1 * t1);
      g_clv2 = g_lv_b * ev2 * t2 + g_t2 * (-ev2 * t2 * t2);
    } else if (a.method == kMoe) {
      const float jlv = m2a * clv1 + m2b * clv2;
      const float g_jlv = g_jmu * ej * 0.5f * expf(0.5f * jlv);
      g_cmu1 = m2a * g_jmu + cg * cmu1;
      g_cmu2 = m2b * g_jmu + cg * cmu2;
      g_clv1 = m2a * g_jlv + cg * 0.5f * (ev1 - 1.0f);
      g_clv2 = m2b * g_jlv + cg * 0.5f * (ev2 - 1.0f);
    } else if (a.method == kJsd) {
      const float jlv = m3a * clv1 + m3b * clv2;
      const float g_jlv = g_jmu * ej * 0.5f * expf(0.5f * jlv);
      const float S = t1 + t2 + tp;
      const float pm = (cmu1 * t1 + cmu2 * t2) / S;
      const float ipv = S / 3.0f;
      const float d1 = cmu1 - pm, d2 = cmu2 - pm;
      const float e1 = ev1 * ipv, e2 = ev2 * ipv;  // exp(clv_e - plv)
      // through the prior: d/d pm and d/d plv of the three KLs
      const float g_pm = -cg * ipv * (d1 + d2 - pm);
      const float g_plv =
          -cg * 0.5f * ((e1 + d1 * d1 * ipv - 1.0f) +
                        (e2 + d2 * d2 * ipv - 1.0f) +
                        (ipv + pm * pm * ipv - 1.0f));
      const float g_t1 = g_pm * d1 / S - g_plv / S;
      const float g_t2 = g_pm * d2 / S - g_plv / S;
      g_cmu1 = m3a * g_jmu + cg * d1 * ipv + g_pm * t1 / S;
      g_cmu2 = m3b * g_jmu + cg * d2 * ipv + g_pm * t2 / S;
      g_clv1 = m3a * g_jlv + cg * 0.5f * (e1 - 1.0f) - g_t1 * ev1 * t1 * t1;
      g_clv2 = m3b * g_jlv + cg * 0.5f * (e2 - 1.0f) - g_t2 * ev2 * t2 * t2;
    } else {  // poe
      const float cmu[2] = {cmu1, cmu2}, ev[2] = {ev1, ev2}, t[2] = {t1, t2};
      const float ts_c = t1 + t2 + tp;
      const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts_c;
      const float lv_c = -logf(ts_c);
      const float g_mu_c = g_jmu + cg * mu_c;
      const float g_lv_c = g_jmu * ej * 0.5f * expf(0.5f * lv_c) +
                           cg * 0.5f * (expf(lv_c) - 1.0f);
      float g_cmu[2], g_clv[2];
      for (int e = 0; e < 2; ++e) {
        const float ts_s = t[e] + tp;
        const float mu_s = cmu[e] * t[e] / ts_s, lv_s = -logf(ts_s);
        // the subset KL is the first encoding's in both cases
        float g_mu_s = cg * mu_s;
        float g_lv_s = cg * 0.5f * (expf(lv_s) - 1.0f);
        const float g_zcu = a.g_zcu[e][j];
        const float uj = nz[a.uj_off[e] + c];
        if (a.separate) {
          const float cmuu = a.uheads[e].cmu[j];
          const float evu = expf(a.uheads[e].clv[j]);
          const float tu = 1.0f / (evu + kPoeEps);
          const float ts_u = tu + tp;
          const float mu_u = cmuu * tu / ts_u, lv_u = -logf(ts_u);
          const float g_lv_u = g_zcu * uj * 0.5f * expf(0.5f * lv_u);
          const float g_tu = g_zcu * (cmuu - mu_u) / ts_u - g_lv_u / ts_u;
          a.g_uheads[e].cmu[j] = g_zcu * tu / ts_u;
          a.g_uheads[e].clv[j] = -g_tu * evu * tu * tu;
        } else {
          g_mu_s += g_zcu;
          g_lv_s += g_zcu * uj * 0.5f * expf(0.5f * lv_s);
        }
        const float g_t = g_mu_c * (cmu[e] - mu_c) / ts_c - g_lv_c / ts_c +
                          g_mu_s * (cmu[e] - mu_s) / ts_s - g_lv_s / ts_s;
        g_cmu[e] = g_mu_c * (t[e] / ts_c) + g_mu_s * t[e] / ts_s;
        g_clv[e] = -g_t * ev[e] * t[e] * t[e];
      }
      g_cmu1 = g_cmu[0];
      g_cmu2 = g_cmu[1];
      g_clv1 = g_clv[0];
      g_clv2 = g_clv[1];
    }
    a.g_heads[0].cmu[j] = g_cmu1;
    a.g_heads[0].clv[j] = g_clv1;
    a.g_heads[1].cmu[j] = g_cmu2;
    a.g_heads[1].clv[j] = g_clv2;
  }
  for (int e = 0; e < 2; ++e) {
    const int s = a.s[e];
    for (int c = 0; c < s; ++c) {
      const long long j = static_cast<long long>(i) * s + c;
      const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
      const float ss = expf(0.5f * slv);
      const float g_zs = a.g_zs[e][j];
      float g_smu = g_zs + a.cs * smu;
      float g_slv = g_zs * nz[a.es_off[e] + c] * 0.5f * ss +
                    a.cs * 0.5f * (expf(slv) - 1.0f);
      if (a.method == kPoe) {
        const float g_zsu = a.g_zsu[e][j];
        const float us = nz[a.us_off[e] + c];
        if (a.separate) {
          a.g_uheads[e].smu[j] = g_zsu;
          a.g_uheads[e].slv[j] =
              g_zsu * us * 0.5f * expf(0.5f * a.uheads[e].slv[j]);
        } else {
          g_smu += g_zsu;
          g_slv += g_zsu * us * 0.5f * ss;
        }
      }
      a.g_heads[e].smu[j] = g_smu;
      a.g_heads[e].slv[j] = g_slv;
    }
  }
}

struct MetricArgs {
  const float* part;     // [kParts, b]
  const float* nll_col;  // [2, d1 + d2]
  float* metrics;        // [17], poe [19]
  int method, b, b_total, d1, d2, cd, s1, s2;
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
  float nll_sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // nll1, nll2, uni1, uni2
  const int n_nll = a.method == kPoe ? 4 : 2;
  for (int q = 0; q < n_nll; ++q) {
    const float* p = a.nll_col + (q / 2) * (a.d1 + a.d2) + (q % 2) * a.d1;
    nll_sum[q] = step::block_sum(
        q % 2 == 0 ? a.d1 : a.d2, [&](int i) { return p[i]; }, scratch);
  }
  if (threadIdx.x != 0) return;
  const float b = static_cast<float>(a.b_total);
  const float nll1 = nll_sum[0] / b, nll2 = nll_sum[1] / b;
  const float kld_a = -0.5f * sums[0] / b;
  const float kld_b = -0.5f * sums[1] / b;
  const float kld_c = -0.5f * sums[2] / b;
  const float kld_s1 = -0.5f * sums[3] / b;
  const float kld_s2 = -0.5f * sums[4] / b;
  const float style = a.beta_style * a.beta_style * (kld_s1 + kld_s2);
  float group_div, loss;
  if (a.method == kPoe) {
    const float uni1 = nll_sum[2] / b, uni2 = nll_sum[3] / b;
    group_div = kld_c;
    loss = uni1 + uni2 + nll1 + nll2 +
           a.beta * (a.beta_content * (kld_a + kld_b + group_div) +
                     2.0f * style);
    a.metrics[17] = uni1;
    a.metrics[18] = uni2;
  } else {
    if (a.method == kJointElbo) {
      group_div = (kld_a + kld_b + kld_c) / 3.0f;
    } else if (a.method == kMoe) {
      group_div = (kld_a + kld_b) / 2.0f;
    } else {
      group_div = -0.5f * sums[13] / b / 3.0f;
    }
    loss = nll1 + nll2 + a.beta * (style + a.beta_content * group_div);
  }
  const float bl = static_cast<float>(a.b);
  const float n_c = bl * a.cd, n_s1 = bl * a.s1, n_s2 = bl * a.s2;
  const float head[17] = {loss,  group_div, nll1, nll2, kld_a, kld_b,
                          kld_c, kld_s1,    kld_s2,
                          sums[5] / n_c,  sums[6] / n_c,
                          sums[7] / n_s1, sums[8] / n_s1,
                          sums[9] / n_c,  sums[10] / n_c,
                          sums[11] / n_s2, sums[12] / n_s2};
  for (int q = 0; q < 17; ++q) a.metrics[q] = head[q];
}

#define STEP_CHECK(expr)                                    \
  do {                                                      \
    cudaError_t err_ = (expr);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace latent
