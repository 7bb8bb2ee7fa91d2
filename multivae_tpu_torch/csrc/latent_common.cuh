// The methods' latent math of a complete-batch train step, shared by the
// persistent method_step.cu and generic_step.cu, for Hopper (sm_90a): what
// stands between the encoders' head outputs and the decoders' inputs,
// forward and hand-derived backward, and the step's metrics. Each is a
// __device__ task that a persistent kernel strides over its blocks in a
// phase of its own (every thread of the block calls it):
//
// * latent_fwd_task: kWarps rows, a warp per row with the lanes over the
//   latent columns (every load of a lane's columns starts before its first
//   use): the subset posteriors of the method, the joint selection, the
//   reparameterization with the streamed noise (zc, zs and, for poe, the
//   unimodal zcu, zsu) and the row partials of the KL sums and latent means,
//   each a fixed butterfly over the lanes.
// * latent_bwd_task: a thread per element of [B, cd + s1 + s2]: the
//   gradients of the head outputs (and, for poe with masks, of the unimodal
//   encoding's heads) from those of the latents.
// * metrics_task: the 17 metrics of method_metric_names (19 for poe) from
//   the row partials and the decoders' per-column NLL sums, a warp per sum.
//
// A thread per row (the multi-launch structure's) made every row a serial
// chain of cd + s1 + s2 elements, each ~10 expf/logf deep, on two blocks at
// B = 256; here the chains are one element long and spread over the grid.
// The methods are described at the top of method_step.cu. Nothing here knows
// what produced the heads or what consumes the latents: the networks around
// are the caller's.

#pragma once

#include "step_common.cuh"

namespace latent {

using step::kPoeEps;

constexpr int kParts = 14;  // per-row partial sums, see latent_fwd_task

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

__host__ __device__ inline int n_metrics(int method) {
  return method == kPoe ? 19 : 17;
}

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

// Everything the tasks need but the step's noise, by pointers into the
// caller's workspace.
struct LatentArgs {
  Heads heads[2], g_heads[2];    // the first encoding
  Heads uheads[2], g_uheads[2];  // poe: the unimodal pass's
  int separate;  // poe: the unimodal pass has an encoding of its own
  int ld, es_off[2], uj_off[2], us_off[2];  // the noise's row stride, columns
  float *zc, *zs[2], *zcu[2], *zsu[2];
  float *g_zc, *g_zs[2], *g_zcu[2], *g_zsu[2];
  float* part;           // [kParts, b]
  const float* nll_col;  // [2, d1 + d2]: first decode, poe's unimodal decode
  int method, b, b_total, cd, s[2], d[2];
  int row_offset;    // global index of local row 0
  int k3a, k3b, k2;  // bounds of the 3-way and the 2-way partition (global)
  float cg, cs;      // KL coefficients / b_total, see set_latent_consts
  float beta, beta_style, beta_content;
};

// The parts of LatentArgs that depend only on the step's sizes and weights:
// the noise's row stride and its column offsets (cd | s1 | s2, poe appends
// cd | s1 and cd | s2; a style width may be 0: the unfactorized latent has
// no style columns, heads or KL), the row partitions of a batch of b_total
// rows, and the KL coefficients.
__host__ __device__ inline void set_latent_consts(
    LatentArgs& la, int method, int b, int row_offset, int b_total, int d1,
    int d2, int cd, int s1, int s2, int ld_noise, float beta,
    float beta_style, float beta_content) {
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
  la.b_total = b_total;
  la.cd = cd;
  la.s[0] = s1;
  la.s[1] = s2;
  la.d[0] = d1;
  la.d[1] = d2;
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
  la.beta = beta;
  la.beta_style = beta_style;
  la.beta_content = beta_content;
}

// sum term of a KL to the unit prior: the metric is -0.5 sum / b_total
__device__ __forceinline__ float kl_term(float mu, float lv) {
  return 1.0f - expf(lv) - mu * mu + lv;
}

// One task of the forward latents: kWarps rows of the step whose noise
// starts at `noise`, a warp per row. Row partials (each [B]): 0-2 KL sums of
// the subsets a, b, c; 3-4 style KL sums; 5-12 the sums of cmu1, clv1,
// smu1, slv1, cmu2, clv2, smu2, slv2 (for the latent means); 13 jsd: the sum
// of the three KLs against the dynamic prior.
__device__ void latent_fwd_task(const LatentArgs& a, const float* noise,
                                int task) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = task * step::kWarps + warp;
  if (i >= a.b) return;  // the same for every lane of the warp
  const int cd = a.cd, method = a.method;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = noise + static_cast<long long>(i) * a.ld;
  const int gi = a.row_offset + i;  // the row's index in the whole batch
  const bool in3a = gi < a.k3a, in3b = gi >= a.k3a && gi < a.k3b;
  const bool in2a = gi < a.k2;
  float parts[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) parts[q] = 0.0f;
  for (int c = lane; c < cd; c += 32) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = a.heads[0].cmu[j], clv1 = a.heads[0].clv[j];
    const float cmu2 = a.heads[1].cmu[j], clv2 = a.heads[1].clv[j];
    const float ej = nz[c];
    const float ev1 = expf(clv1), ev2 = expf(clv2);
    const float t1 = 1.0f / (ev1 + kPoeEps);
    const float t2 = 1.0f / (ev2 + kPoeEps);
    float jmu, jlv;
    if (method == kJointElbo) {
      const float lv_a = -logf(t1), lv_b = -logf(t2);
      const float ts = t1 + t2 + tp;
      const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
      const float lv_c = -logf(ts);
      jmu = in3a ? cmu1 : (in3b ? cmu2 : mu_c);
      jlv = in3a ? lv_a : (in3b ? lv_b : lv_c);
      parts[0] += kl_term(cmu1, lv_a);
      parts[1] += kl_term(cmu2, lv_b);
      parts[2] += kl_term(mu_c, lv_c);
    } else if (method == kMoe) {
      jmu = in2a ? cmu1 : cmu2;
      jlv = in2a ? clv1 : clv2;
      parts[0] += kl_term(cmu1, clv1);
      parts[1] += kl_term(cmu2, clv2);
      parts[2] += kl_term(jmu, jlv);
    } else if (method == kJsd) {
      jmu = in3a ? cmu1 : (in3b ? cmu2 : 0.0f);  // unit rows: mu = 0
      jlv = in3a ? clv1 : (in3b ? clv2 : 0.0f);  // unit rows: logvar = 0
      parts[0] += kl_term(cmu1, clv1);
      parts[1] += kl_term(cmu2, clv2);
      parts[2] += in2a ? kl_term(cmu1, clv1) : kl_term(cmu2, clv2);
      const float S = t1 + t2 + tp;
      const float pm = (cmu1 * t1 + cmu2 * t2) / S;
      const float ipv = S / 3.0f;  // exp(-plv)
      const float plv = -logf(ipv);
      const float d1 = cmu1 - pm, d2 = cmu2 - pm;
      parts[13] += (1.0f - ev1 * ipv - d1 * d1 * ipv + clv1 - plv) +
                   (1.0f - ev2 * ipv - d2 * d2 * ipv + clv2 - plv) +
                   (1.0f - ipv - pm * pm * ipv - plv);
    } else {  // poe
      const float ts_a = t1 + tp, ts_b = t2 + tp, ts_c = t1 + t2 + tp;
      const float mu_a = cmu1 * t1 / ts_a, lv_a = -logf(ts_a);
      const float mu_b = cmu2 * t2 / ts_b, lv_b = -logf(ts_b);
      jmu = (cmu1 * t1 + cmu2 * t2) / ts_c;
      jlv = -logf(ts_c);
      parts[0] += kl_term(mu_a, lv_a);
      parts[1] += kl_term(mu_b, lv_b);
      parts[2] += kl_term(jmu, jlv);
      float mu_u[2] = {mu_a, mu_b}, lv_u[2] = {lv_a, lv_b};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (a.separate) {
          const float cmuu = a.uheads[e].cmu[j];
          const float tu = 1.0f / (expf(a.uheads[e].clv[j]) + kPoeEps);
          mu_u[e] = cmuu * tu / (tu + tp);
          lv_u[e] = -logf(tu + tp);
        }
        a.zcu[e][j] = mu_u[e] + nz[a.uj_off[e] + c] * expf(0.5f * lv_u[e]);
      }
    }
    a.zc[j] = jmu + ej * expf(0.5f * jlv);
    parts[5] += cmu1;
    parts[6] += clv1;
    parts[9] += cmu2;
    parts[10] += clv2;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = a.s[e];
    for (int c = lane; c < s; c += 32) {
      const long long j = static_cast<long long>(i) * s + c;
      const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
      a.zs[e][j] = smu + nz[a.es_off[e] + c] * expf(0.5f * slv);
      if (method == kPoe) {
        a.zsu[e][j] = a.uheads[e].smu[j] +
                      nz[a.us_off[e] + c] * expf(0.5f * a.uheads[e].slv[j]);
      }
      parts[3 + e] += kl_term(smu, slv);
      parts[7 + 4 * e] += smu;
      parts[8 + 4 * e] += slv;
    }
  }
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const float total = step::warp_sum(parts[q]);
    if (lane == 0) a.part[q * a.b + i] = total;
  }
}

// The gradients of the two encoders' content heads at row i, column c. cg x
// is the gradient of a unit-prior KL's mu, cg (exp(lv) - 1) / 2 its
// logvar's.
__device__ __forceinline__ void content_bwd(const LatentArgs& a,
                                            const float* nz, int i, int c) {
  const float tp = 1.0f / (1.0f + kPoeEps);
  const long long j = static_cast<long long>(i) * a.cd + c;
  const int gi = a.row_offset + i;
  const float m3a = gi < a.k3a ? 1.0f : 0.0f;
  const float m3b = (gi >= a.k3a && gi < a.k3b) ? 1.0f : 0.0f;
  const float m3c = gi >= a.k3b ? 1.0f : 0.0f;
  const float m2a = gi < a.k2 ? 1.0f : 0.0f, m2b = 1.0f - m2a;
  const float cg = a.cg;
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
    const float g_plv = -cg * 0.5f * ((e1 + d1 * d1 * ipv - 1.0f) +
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
#pragma unroll
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

// The gradients of encoder e's style heads at row i, column c.
__device__ __forceinline__ void style_bwd(const LatentArgs& a,
                                          const float* nz, int i, int e,
                                          int c) {
  const long long j = static_cast<long long>(i) * a.s[e] + c;
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

// One task of the latents' backward: kGemmThreads elements of [B, cd + s1 +
// s2] (the content columns serve both encoders), a thread per element.
__device__ void latent_bwd_task(const LatentArgs& a, const float* noise,
                                int task) {
  const int width = a.cd + a.s[0] + a.s[1];
  const int idx = task * step::kGemmThreads + threadIdx.x;
  if (idx >= a.b * width) return;
  const int i = idx / width;
  int c = idx % width;
  const float* nz = noise + static_cast<long long>(i) * a.ld;
  if (c < a.cd) {
    content_bwd(a, nz, i, c);
    return;
  }
  c -= a.cd;
  const int e = c < a.s[0] ? 0 : 1;
  style_bwd(a, nz, i, e, e == 0 ? c : c - a.s[0]);
}

// Tasks of the two latent phases.
__host__ __device__ inline int latent_fwd_tasks(int b) {
  return (b + step::kWarps - 1) / step::kWarps;
}

__host__ __device__ inline int latent_bwd_tasks(int b, int cd, int s1,
                                                int s2) {
  return (b * (cd + s1 + s2) + step::kGemmThreads - 1) / step::kGemmThreads;
}

// The step's metrics into `metrics` (17, poe 19), a warp per sum (lanes
// strided over the rows or columns, then a fixed butterfly). Sums over the
// local rows: those of the loss divided by b_total (partial sums of the
// whole batch's), the latent means by the local element count. `sums`:
// kParts + 4 floats of shared memory. Every thread of the block calls it.
__device__ void metrics_task(const LatentArgs& a, float* metrics,
                             float* sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_nll = a.method == kPoe ? 4 : 2;  // nll1, nll2, uni1, uni2
  for (int q = warp; q < kParts + n_nll; q += step::kWarps) {
    const float* src;
    int n;
    if (q < kParts) {
      src = a.part + static_cast<long long>(q) * a.b;
      n = a.b;
    } else {
      const int k = q - kParts;
      src = a.nll_col + (k / 2) * (a.d[0] + a.d[1]) + (k % 2) * a.d[0];
      n = a.d[k % 2];
    }
    float acc = 0.0f;
    for (int i = lane; i < n; i += 32) acc += src[i];
    acc = step::warp_sum(acc);
    if (lane == 0) sums[q] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float b = static_cast<float>(a.b_total);
    const float nll1 = sums[kParts] / b, nll2 = sums[kParts + 1] / b;
    const float kld_a = -0.5f * sums[0] / b;
    const float kld_b = -0.5f * sums[1] / b;
    const float kld_c = -0.5f * sums[2] / b;
    const float kld_s1 = -0.5f * sums[3] / b;
    const float kld_s2 = -0.5f * sums[4] / b;
    const float style = a.beta_style * a.beta_style * (kld_s1 + kld_s2);
    float group_div, loss;
    if (a.method == kPoe) {
      const float uni1 = sums[kParts + 2] / b, uni2 = sums[kParts + 3] / b;
      group_div = kld_c;
      loss = uni1 + uni2 + nll1 + nll2 +
             a.beta * (a.beta_content * (kld_a + kld_b + group_div) +
                       2.0f * style);
      metrics[17] = uni1;
      metrics[18] = uni2;
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
    const float n_c = bl * a.cd, n_s1 = bl * a.s[0], n_s2 = bl * a.s[1];
    // a style latent of width 0 (the unfactorized latent) has mean 0
    const float m_s1 = n_s1 > 0.0f ? sums[7] / n_s1 : 0.0f;
    const float l_s1 = n_s1 > 0.0f ? sums[8] / n_s1 : 0.0f;
    const float m_s2 = n_s2 > 0.0f ? sums[11] / n_s2 : 0.0f;
    const float l_s2 = n_s2 > 0.0f ? sums[12] / n_s2 : 0.0f;
    const float head[17] = {loss,  group_div, nll1, nll2, kld_a, kld_b,
                            kld_c, kld_s1,    kld_s2,
                            sums[5] / n_c,  sums[6] / n_c,
                            m_s1,           l_s1,
                            sums[9] / n_c,  sums[10] / n_c,
                            m_s2,           l_s2};
    for (int q = 0; q < 17; ++q) metrics[q] = head[q];
  }
  __syncthreads();
}

}  // namespace latent
