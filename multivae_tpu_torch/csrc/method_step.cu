// One train step of a complete batch for any of the four methods
// (joint_elbo, moe, jsd, poe), with optional streamed dropout masks, forward
// and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_methods.py::
// _method_epoch_kernel: method_loss_split (fused_methods.py:142-338) under
// jax.value_and_grad. The TPU kernel gets its backward from in-kernel
// autodiff; CUDA has none, so each method's backward is derived by hand here
// (and pinned to jax.grad through the plain version,
// multivae_tpu_torch/ops/fused_methods.py::method_fwd_bwd_reference).
// In: the 28 split tensors as one flat buffer (step_common.cuh, make_layout),
// x1 [B, d1], x2 [B, d2], the noise [B, w] (columns cd | s1 | s2, poe
// appends cd | s1 and cd | s2 for its unimodal draws) and up to four
// pre-scaled keep masks [B, h] (encoder 1, encoder 2, poe: the unimodal
// re-encodings of 1 and 2). Out: the 17 metrics of method_metric_names (19
// for poe) and the gradient of every split tensor.
//
// The same step on one shard's row slice of a batch
// (method_step_slice_launch) replaces multivae_tpu/ops/fused_sharded.py::
// _dp_method_kernel: the rows at hand (x, noise and masks alike) are rows
// [row_offset, row_offset + B) of a batch of b_total rows. Every row
// partition is the whole batch's (a row compares its global index with the
// bounds from b_total: moe's 2-way, joint_elbo's 3-way, jsd's 3-way and the
// 2-way of its kld metric), every sum that the loss holds is divided by
// b_total, so metrics 0-8, poe's 17-18 and all gradients are partial sums
// that add up over the shards to the whole batch's; metrics 9-16 (the latent
// means) stay means over the local rows, as in the TPU kernel, and the
// caller divides their sum by the number of shards. A shard may hold no row
// of a subset. Workspace, grids and every product's row extent are the
// local B. With row_offset = 0 and b_total = B it is the unsharded step, bit
// for bit: method_step_launch calls it so.
//
// Per method (t_e = 1 / (exp(clv_e) + 1e-8), tp = 1 / (1 + 1e-8)):
//   joint_elbo  subsets a, b bare (lv = -log t_e), c = PoE with the prior;
//               joint = 3-way row mixture; divergence = mean of the 3 KLs.
//   moe         joint = 2-way row mixture of the raw heads; divergence =
//               (KL_1 + KL_2) / 2 on (cmu_e, clv_e); kld of the pair subset
//               (the mixture's KL) is a metric only.
//   jsd         joint = 3-way row mixture [e1, e2, unit]; divergence = mean
//               KL of e1, e2 and the unit expert against the alpha-PoE prior
//               pm = sum(cmu_e t_e) / S, plv = log 3 - log S, S = t1 + t2 +
//               tp: the gradient reaches cmu_e and clv_e through pm and plv;
//               the three KLs to the unit prior are metrics only.
//   poe         every subset fuses with the prior; joint = the full PoE;
//               loss = joint ELBO + one unimodal ELBO per modality: a second
//               decode from (zs_u, zc_e) with the second noise blocks. Under
//               dropout the unimodal posterior is re-encoded with its own
//               mask and gets the unimodal NLL's gradient only (the KLs stay
//               the first pass's); each style KL counts twice.
//
// What bounds it: as mopoe_step.cu, launch count and the serial K loops of
// small products (M, N, K <= 444), not HBM (~2 MB moved) or the f32 pipes
// (~0.25 GFLOP; poe with dropout ~0.5). 11 launches per step (13 for poe
// with masks: one more hidden and one more heads launch), all on one stream
// from one C entry point; the grouped GEMM sums poe's two decodes and two
// encodings inside one problem (two segments), so no gradient is added up
// in memory. No library product, no float atomics: two runs give the same
// bits.

#include <initializer_list>

#include "step_common.cuh"

namespace {

using step::kPoeEps;

constexpr int kRowThreads = 128;
constexpr int kParts = 14;  // per-row partial sums, see latent_fwd_kernel

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct Work {
  // [pass][encoder]; pass 1 exists for poe with masks (the unimodal
  // re-encoding)
  float* h[2][2];
  float* g_h[2][2];
  Heads heads[2][2], g_heads[2][2];
  float *zc, *g_zc;
  float *zs[2], *g_zs[2], *r[2], *g_loc[2];
  // poe's unimodal decode
  float *zcu[2], *g_zcu[2], *zsu[2], *g_zsu[2], *ru[2], *g_locu[2];
  float* part;     // [kParts, B]
  float* nll_col;  // [2, d1 + d2]: first decode, unimodal decode
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
Work carve(float* base, int method, int passes, int b, int d1, int d2, int h,
           int cd, int s1, int s2) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  const long long bl = b;
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  for (int p = 0; p < 2; ++p) {
    for (int e = 0; e < 2; ++e) {
      const long long on = p < passes ? 1 : 0;
      w.h[p][e] = take(on * bl * h);
      w.g_h[p][e] = take(on * bl * h);
      for (Heads* H : {&w.heads[p][e], &w.g_heads[p][e]}) {
        H->cmu = take(on * bl * cd);
        H->clv = take(on * bl * cd);
        H->smu = take(on * bl * s[e]);
        H->slv = take(on * bl * s[e]);
      }
    }
  }
  w.zc = take(bl * cd);
  w.g_zc = take(bl * cd);
  const long long uni = method == kPoe ? 1 : 0;
  for (int e = 0; e < 2; ++e) {
    w.zs[e] = take(bl * s[e]);
    w.g_zs[e] = take(bl * s[e]);
    w.r[e] = take(bl * d[e]);
    w.g_loc[e] = take(bl * d[e]);
    w.zcu[e] = take(uni * bl * cd);
    w.g_zcu[e] = take(uni * bl * cd);
    w.zsu[e] = take(uni * bl * s[e]);
    w.g_zsu[e] = take(uni * bl * s[e]);
    w.ru[e] = take(uni * bl * d[e]);
    w.g_locu[e] = take(uni * bl * d[e]);
  }
  w.part = take(static_cast<long long>(kParts) * bl);
  w.nll_col = take(2LL * (d1 + d2));
  w.total = off;
  return w;
}

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

}  // namespace

extern "C" {

long long method_step_workspace_floats(int method, int has_masks, int b,
                                       int d1, int d2, int h, int cd, int s1,
                                       int s2) {
  const int passes = (method == kPoe && has_masks) ? 2 : 1;
  return carve(nullptr, method, passes, b, d1, d2, h, cd, s1, s2).total;
}

// One step on `stream` over rows [row_offset, row_offset + b) of a batch of
// b_total rows: grads (flat, split layout) and the metrics from the flat
// params, as partial sums of the whole batch's (see the header). method:
// 0 joint_elbo, 1 moe, 2 jsd, 3 poe. mask0..mask3 are all null (no
// dropout) or the keep masks of encoder 1, encoder 2 and, for
// poe, of the unimodal re-encodings of 1 and 2 (null otherwise), each
// [B, h] with row stride ld_mask (the local rows, like x and the noise).
// Returns the first CUDA error (0 on success). Synchronizes nothing and
// allocates nothing: `work` holds method_step_workspace_floats(..., b, ...)
// floats.
int method_step_slice_launch(const float* params, float* grads,
                             float* metrics, const float* x1, const float* x2,
                             const float* noise, int ld_noise,
                             const float* mask0, const float* mask1,
                             const float* mask2, const float* mask3,
                             int ld_mask, float* work, int method, int b,
                             int row_offset, int b_total, int d1, int d2,
                             int h, int cd, int s1, int s2, float beta,
                             float beta_style, float beta_content,
                             int learn_scale, void* stream_ptr) {
  if (method < kJointElbo || method > kPoe) return cudaErrorInvalidValue;
  if (b < 1 || row_offset < 0 || b_total < row_offset + b) {
    return cudaErrorInvalidValue;
  }
  const bool masked = mask0 != nullptr;
  if (masked != (mask1 != nullptr)) return cudaErrorInvalidValue;
  const bool uni_masked = mask2 != nullptr;
  if (uni_masked != (mask3 != nullptr) ||
      uni_masked != (masked && method == kPoe)) {
    return cudaErrorInvalidValue;
  }
  const int passes = uni_masked ? 2 : 1;
  const bool poe = method == kPoe;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const step::Layout L = step::make_layout(d1, d2, h, cd, s1, s2);
  const Work w = carve(work, method, passes, b, d1, d2, h, cd, s1, s2);
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  const float* x[2] = {x1, x2};
  const float* mask[2][2] = {{mask0, mask1}, {mask2, mask3}};
  const float* P = params;
  float* G = grads;

  // 1. hidden layers of every encoding: relu(x Wh + bh) [* mask]
  {
    step::GemmBuilder g;
    for (int p = 0; p < passes; ++p) {
      for (int e = 0; e < 2; ++e) {
        auto* q = g.add(b, h, 0, 0, w.h[p][e], h, step::kBiasRelu,
                        P + L.enc[e].bh, nullptr, 0, mask[p][e], ld_mask);
        g.add_segment(q, x[e], d[e], P + L.enc[e].Wh, h, d[e]);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 2. encoder heads, one launch per encoding
  for (int p = 0; p < passes; ++p) {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
      const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
      const Heads& H = w.heads[p][e];
      float* out[4] = {H.cmu, H.clv, H.smu, H.slv};
      const int n[4] = {cd, cd, s[e], s[e]};
      for (int k = 0; k < 4; ++k) {
        auto* q = g.add(b, n[k], 0, 0, out[k], n[k], step::kBias, P + bo[k]);
        g.add_segment(q, w.h[p][e], h, P + Wo[k], n[k], h);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 3. latents
  LatentArgs la;
  const int up = passes - 1;  // the encoding the unimodal pass reads
  for (int e = 0; e < 2; ++e) {
    la.heads[e] = w.heads[0][e];
    la.g_heads[e] = w.g_heads[0][e];
    la.uheads[e] = w.heads[up][e];
    la.g_uheads[e] = w.g_heads[up][e];
    la.zs[e] = w.zs[e];
    la.g_zs[e] = w.g_zs[e];
    la.zcu[e] = w.zcu[e];
    la.g_zcu[e] = w.g_zcu[e];
    la.zsu[e] = w.zsu[e];
    la.g_zsu[e] = w.g_zsu[e];
    la.s[e] = s[e];
  }
  la.separate = passes == 2;
  la.noise = noise;
  la.ld = ld_noise;
  const int off = cd + s1 + s2;
  la.es_off[0] = cd;
  la.es_off[1] = cd + s1;
  la.uj_off[0] = off;
  la.us_off[0] = off + cd;
  la.uj_off[1] = off + cd + s1;
  la.us_off[1] = off + 2 * cd + s1;
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  la.method = method;
  la.b = b;
  la.cd = cd;
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
  la.cs = (poe ? 2.0f : 1.0f) * beta * beta_style * beta_style / bf;
  const int row_blocks = (b + kRowThreads - 1) / kRowThreads;
  latent_fwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 4. decoders: r = x - (zs Wds + zc Wdc + bd); poe: the unimodal decode too
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* q = g.add(b, d[e], 0, 0, w.r[e], d[e], step::kResidual, P + D.bd,
                      x[e], d[e]);
      g.add_segment(q, w.zs[e], s[e], P + D.Wds, d[e], s[e]);
      g.add_segment(q, w.zc, cd, P + D.Wdc, d[e], cd);
      if (poe) {
        q = g.add(b, d[e], 0, 0, w.ru[e], d[e], step::kResidual, P + D.bd,
                  x[e], d[e]);
        g.add_segment(q, w.zsu[e], s[e], P + D.Wds, d[e], s[e]);
        g.add_segment(q, w.zcu[e], cd, P + D.Wdc, d[e], cd);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 5. g_loc, bias / out-logvar grads (summed over poe's two decodes), NLL
  {
    step::DecReduceBatch rb;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      float* nll = w.nll_col + (e == 0 ? 0 : d1);
      rb.p[e] = step::DecReduce{w.r[e],    P + D.olv, w.g_loc[e], G + D.bd,
                                G + D.olv, nll,       d[e],
                                poe ? w.ru[e] : nullptr,
                                poe ? w.g_locu[e] : nullptr,
                                poe ? nll + d1 + d2 : nullptr};
    }
    rb.b = b;
    rb.b_total = b_total;
    rb.learn_scale = learn_scale;
    const int dmax = d1 > d2 ? d1 : d2;
    dim3 grid((dmax + step::kColThreads - 1) / step::kColThreads, 2);
    step::dec_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    STEP_CHECK(cudaGetLastError());
  }
  // 6. decoder weight grads (poe: both decodes in one sum) and the latents'
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* q = g.add(s[e], d[e], 1, 0, G + D.Wds, d[e]);  // zs^T g_loc
      g.add_segment(q, w.zs[e], s[e], w.g_loc[e], d[e], b);
      if (poe) g.add_segment(q, w.zsu[e], s[e], w.g_locu[e], d[e], b);
      q = g.add(cd, d[e], 1, 0, G + D.Wdc, d[e]);           // zc^T g_loc
      g.add_segment(q, w.zc, cd, w.g_loc[e], d[e], b);
      if (poe) g.add_segment(q, w.zcu[e], cd, w.g_locu[e], d[e], b);
      q = g.add(b, s[e], 0, 1, w.g_zs[e], s[e]);            // g_loc Wds^T
      g.add_segment(q, w.g_loc[e], d[e], P + D.Wds, d[e], d[e]);
      if (poe) {
        q = g.add(b, s[e], 0, 1, w.g_zsu[e], s[e]);
        g.add_segment(q, w.g_locu[e], d[e], P + D.Wds, d[e], d[e]);
        q = g.add(b, cd, 0, 1, w.g_zcu[e], cd);
        g.add_segment(q, w.g_locu[e], d[e], P + D.Wdc, d[e], d[e]);
      }
    }
    auto* q = g.add(b, cd, 0, 1, w.g_zc, cd);  // sum_e g_loc_e Wdc_e^T
    for (int e = 0; e < 2; ++e) {
      g.add_segment(q, w.g_loc[e], d[e], P + L.dec[e].Wdc, d[e], d[e]);
    }
    STEP_CHECK(g.launch(stream));
  }
  // 7. head-output grads
  latent_bwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 8. head weight grads (both encodings in one sum), and per encoding
  //    g_h = (sum_k g_head_k W_k^T) * mask * (h > 0)
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
      const int n[4] = {cd, cd, s[e], s[e]};
      for (int k = 0; k < 4; ++k) {
        auto* q = g.add(h, n[k], 1, 0, G + Wo[k], n[k]);
        for (int p = 0; p < passes; ++p) {
          const Heads& GH = w.g_heads[p][e];
          const float* gh[4] = {GH.cmu, GH.clv, GH.smu, GH.slv};
          g.add_segment(q, w.h[p][e], h, gh[k], n[k], b);
        }
      }
    }
    for (int p = 0; p < passes; ++p) {
      for (int e = 0; e < 2; ++e) {
        const step::EncLayout& E = L.enc[e];
        const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
        const Heads& GH = w.g_heads[p][e];
        const float* gh[4] = {GH.cmu, GH.clv, GH.smu, GH.slv};
        const int n[4] = {cd, cd, s[e], s[e]};
        auto* q = g.add(b, h, 0, 1, w.g_h[p][e], h, step::kReluMask, nullptr,
                        w.h[p][e], h, mask[p][e], ld_mask);
        for (int k = 0; k < 4; ++k) {
          g.add_segment(q, gh[k], n[k], P + Wo[k], n[k], n[k]);
        }
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 9. head and hidden bias grads
  {
    step::ColSumBuilder c;
    for (int e = 0; e < 2; ++e) {
      const step::EncLayout& E = L.enc[e];
      const Heads& A = w.g_heads[0][e];
      const Heads& U = w.g_heads[1][e];
      const bool two = passes == 2;
      c.add(A.cmu, b, cd, G + E.bcmu, two ? U.cmu : nullptr);
      c.add(A.clv, b, cd, G + E.bclv, two ? U.clv : nullptr);
      c.add(A.smu, b, s[e], G + E.bsmu, two ? U.smu : nullptr);
      c.add(A.slv, b, s[e], G + E.bslv, two ? U.slv : nullptr);
      c.add(w.g_h[0][e], b, h, G + E.bh, two ? w.g_h[1][e] : nullptr);
    }
    STEP_CHECK(c.launch(stream));
  }
  // 10. hidden weight grads
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      auto* q = g.add(d[e], h, 1, 0, G + L.enc[e].Wh, h);  // x^T g_h
      for (int p = 0; p < passes; ++p) {
        g.add_segment(q, x[e], d[e], w.g_h[p][e], h, b);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 11. metrics
  MetricArgs ma{w.part, w.nll_col, metrics, method, b,    b_total,
                d1,     d2,        cd,      s1,     s2,   beta,
                beta_style, beta_content};
  metrics_kernel<<<1, step::kMetricThreads, 0, stream>>>(ma);
  STEP_CHECK(cudaGetLastError());
  return 0;
}

// The unsharded step: the slice that is the whole batch.
int method_step_launch(const float* params, float* grads, float* metrics,
                       const float* x1, const float* x2, const float* noise,
                       int ld_noise, const float* mask0, const float* mask1,
                       const float* mask2, const float* mask3, int ld_mask,
                       float* work, int method, int b, int d1, int d2, int h,
                       int cd, int s1, int s2, float beta, float beta_style,
                       float beta_content, int learn_scale,
                       void* stream_ptr) {
  return method_step_slice_launch(params, grads, metrics, x1, x2, noise,
                                  ld_noise, mask0, mask1, mask2, mask3,
                                  ld_mask, work, method, b, 0, b, d1, d2, h,
                                  cd, s1, s2, beta, beta_style, beta_content,
                                  learn_scale, stream_ptr);
}

const char* method_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
