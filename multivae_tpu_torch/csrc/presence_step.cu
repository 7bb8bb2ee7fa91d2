// One train step of a batch where only one modality is present, for any of
// the four methods (joint_elbo, moe, jsd, poe), with optional streamed
// dropout masks, forward and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_presence.py::
// _presence_epoch_kernel: presence_loss_split (fused_presence.py:113-244)
// under jax.value_and_grad. The TPU kernel gets its backward from in-kernel
// autodiff; here it is derived by hand (and pinned to jax.grad through the
// plain version, multivae_tpu_torch/ops/fused_presence.py::
// presence_fwd_bwd_reference). For the present modality i (mod_idx 0 or 1):
//   h = relu(x Wh + bh) [* mask]; cmu, clv, smu, slv = the four heads
//   t = 1 / (exp(clv) + 1e-8), tp = 1 / (1 + 1e-8)
//   joint_elbo  joint = (cmu, -log t), the masked PoE of the bare expert;
//               divergence = its KL
//   moe         joint = (cmu, clv); divergence = its KL
//   jsd         joint = 2-way row mixture [expert, unit]; divergence = mean
//               KL of the expert and the unit expert against the alpha-PoE
//               prior pm = cmu t / S, plv = log 2 - log S, S = t + tp; the
//               expert's KL to the unit prior is a metric only
//   poe         joint = PoE with the prior; loss adds the unimodal ELBO: a
//               second decode with the second noise block; under dropout the
//               re-run re-encodes with its own mask and gets the unimodal
//               NLL's gradient only; the KLs count twice
//   zc = jmu + ej exp(jlv / 2); zs = smu + es exp(slv / 2)
//   loc = zs Wds + zc Wdc + bd; nll from the present decoder only
// Noise [B, w]: cd | s_i, poe appends a second cd | s_i. Out: the 9 metrics
// of presence_metric_names (10 for poe) and the gradient of all 28 split
// tensors: the absent modality's 14 are zero (it still takes the Adam
// update, fused_presence.py:35-37).
//
// What bounds it: the method step's half (one encoder, one decoder), so the
// same launch-bound profile (see mopoe_step.cu); 10 launches plus one memset
// of the gradient buffer. No library product, no float atomics.

#include <initializer_list>

#include "step_common.cuh"

namespace {

using step::kPoeEps;

constexpr int kRowThreads = 128;
constexpr int kParts = 7;  // per-row partial sums, see latent_fwd_kernel

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct Work {
  // [pass]; pass 1 exists for poe with masks (the unimodal re-encoding)
  float *h[2], *g_h[2];
  Heads heads[2], g_heads[2];
  float *zc, *zs, *r, *g_loc, *g_zc, *g_zs;
  float *zcu, *zsu, *ru, *g_locu, *g_zcu, *g_zsu;  // poe's unimodal decode
  float *part;     // [kParts, B]
  float *nll_col;  // [2, d]: first decode, unimodal decode
  long long total;
};

Work carve(float* base, int method, int passes, int b, int d, int h, int cd,
           int s) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  const long long bl = b;
  for (int p = 0; p < 2; ++p) {
    const long long on = p < passes ? 1 : 0;
    w.h[p] = take(on * bl * h);
    w.g_h[p] = take(on * bl * h);
    for (Heads* H : {&w.heads[p], &w.g_heads[p]}) {
      H->cmu = take(on * bl * cd);
      H->clv = take(on * bl * cd);
      H->smu = take(on * bl * s);
      H->slv = take(on * bl * s);
    }
  }
  w.zc = take(bl * cd);
  w.zs = take(bl * s);
  w.r = take(bl * d);
  w.g_loc = take(bl * d);
  w.g_zc = take(bl * cd);
  w.g_zs = take(bl * s);
  const long long uni = method == kPoe ? 1 : 0;
  w.zcu = take(uni * bl * cd);
  w.zsu = take(uni * bl * s);
  w.ru = take(uni * bl * d);
  w.g_locu = take(uni * bl * d);
  w.g_zcu = take(uni * bl * cd);
  w.g_zsu = take(uni * bl * s);
  w.part = take(kParts * bl);
  w.nll_col = take(2LL * d);
  w.total = off;
  return w;
}

struct LatentArgs {
  Heads heads, g_heads;    // the first encoding
  Heads uheads, g_uheads;  // poe: the unimodal pass's
  int separate;  // poe: the unimodal pass has an encoding of its own
  const float* noise;
  int ld;
  float *zc, *zs, *zcu, *zsu;
  const float *g_zc, *g_zs, *g_zcu, *g_zsu;
  float* part;
  int method, b, cd, s, k2;  // k2: bound of the 2-way row partition
  float cg, cs;  // KL coefficients / b, see presence_step_launch
};

__device__ inline float kl_term(float mu, float lv) {
  return 1.0f - expf(lv) - mu * mu + lv;
}

// Row partials (each [B]): 0 KL sum of the subset posterior, 1 style KL
// sum, 2-5 the sums of cmu, clv, smu, slv, 6 jsd: the sum of the two KLs
// against the dynamic prior. Noise columns: ej at 0, es at cd, poe: uj at
// cd + s, us at 2 cd + s.
__global__ void latent_fwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd, s = a.s;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = a.noise + static_cast<long long>(i) * a.ld;
  const bool in_a = i < a.k2;
  float p_m = 0.0f, p_s = 0.0f, p_j = 0.0f;
  float m_cmu = 0.0f, m_clv = 0.0f, m_smu = 0.0f, m_slv = 0.0f;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu = a.heads.cmu[j], clv = a.heads.clv[j];
    const float ev = expf(clv);
    const float t = 1.0f / (ev + kPoeEps);
    float jmu, jlv;
    if (a.method == kJointElbo) {
      jmu = cmu;
      jlv = -logf(t);
      p_m += kl_term(jmu, jlv);
    } else if (a.method == kMoe) {
      jmu = cmu;
      jlv = clv;
      p_m += kl_term(cmu, clv);
    } else if (a.method == kJsd) {
      jmu = in_a ? cmu : 0.0f;  // unit rows: mu = 0
      jlv = in_a ? clv : 0.0f;  // unit rows: logvar = 0
      p_m += kl_term(cmu, clv);
      const float S = t + tp;
      const float pm = cmu * t / S;
      const float ipv = S / 2.0f;  // exp(-plv)
      const float plv = -logf(ipv);
      const float d = cmu - pm;
      p_j += (1.0f - ev * ipv - d * d * ipv + clv - plv) +
             (1.0f - ipv - pm * pm * ipv - plv);
    } else {  // poe
      const float ts = t + tp;
      jmu = cmu * t / ts;
      jlv = -logf(ts);
      p_m += kl_term(jmu, jlv);
      float mu_u = jmu, lv_u = jlv;
      if (a.separate) {
        const float cmuu = a.uheads.cmu[j];
        const float tu = 1.0f / (expf(a.uheads.clv[j]) + kPoeEps);
        mu_u = cmuu * tu / (tu + tp);
        lv_u = -logf(tu + tp);
      }
      a.zcu[j] = mu_u + nz[cd + s + c] * expf(0.5f * lv_u);
    }
    a.zc[j] = jmu + nz[c] * expf(0.5f * jlv);
    m_cmu += cmu;
    m_clv += clv;
  }
  for (int c = 0; c < s; ++c) {
    const long long j = static_cast<long long>(i) * s + c;
    const float smu = a.heads.smu[j], slv = a.heads.slv[j];
    a.zs[j] = smu + nz[cd + c] * expf(0.5f * slv);
    if (a.method == kPoe) {
      a.zsu[j] = a.uheads.smu[j] +
                 nz[2 * cd + s + c] * expf(0.5f * a.uheads.slv[j]);
    }
    p_s += kl_term(smu, slv);
    m_smu += smu;
    m_slv += slv;
  }
  const float parts[kParts] = {p_m, p_s, m_cmu, m_clv, m_smu, m_slv, p_j};
#pragma unroll
  for (int q = 0; q < kParts; ++q) a.part[q * a.b + i] = parts[q];
}

__global__ void latent_bwd_kernel(const LatentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.b) return;
  const int cd = a.cd, s = a.s;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = a.noise + static_cast<long long>(i) * a.ld;
  const float m_a = i < a.k2 ? 1.0f : 0.0f;
  const float cg = a.cg;
  for (int c = 0; c < cd; ++c) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu = a.heads.cmu[j], clv = a.heads.clv[j];
    const float ev = expf(clv);
    const float t = 1.0f / (ev + kPoeEps);
    const float ej = nz[c];
    const float g_zc = a.g_zc[j];
    float g_cmu, g_clv;
    if (a.method == kJointElbo) {
      const float lv = -logf(t);
      const float g_lv = g_zc * ej * 0.5f * expf(0.5f * lv) +
                         cg * 0.5f * (expf(lv) - 1.0f);
      g_cmu = g_zc + cg * cmu;
      g_clv = g_lv * ev * t;  // d(-log t) / d clv = exp(clv) t
    } else if (a.method == kMoe) {
      g_cmu = g_zc + cg * cmu;
      g_clv = g_zc * ej * 0.5f * expf(0.5f * clv) + cg * 0.5f * (ev - 1.0f);
    } else if (a.method == kJsd) {
      const float g_jlv = m_a * g_zc * ej * 0.5f * expf(0.5f * clv);
      const float S = t + tp;
      const float pm = cmu * t / S;
      const float ipv = S / 2.0f;
      const float d = cmu - pm;
      const float e1 = ev * ipv;  // exp(clv - plv)
      // through the prior: d/d pm and d/d plv of the two KLs
      const float g_pm = -cg * ipv * (d - pm);
      const float g_plv = -cg * 0.5f * ((e1 + d * d * ipv - 1.0f) +
                                        (ipv + pm * pm * ipv - 1.0f));
      const float g_t = g_pm * d / S - g_plv / S;
      g_cmu = m_a * g_zc + cg * d * ipv + g_pm * t / S;
      g_clv = g_jlv + cg * 0.5f * (e1 - 1.0f) - g_t * ev * t * t;
    } else {  // poe
      const float ts = t + tp;
      const float mu_s = cmu * t / ts, lv_s = -logf(ts);
      float g_mu_s = g_zc + cg * mu_s;
      float g_lv_s = g_zc * ej * 0.5f * expf(0.5f * lv_s) +
                     cg * 0.5f * (expf(lv_s) - 1.0f);
      const float g_zcu = a.g_zcu[j];
      const float uj = nz[cd + s + c];
      if (a.separate) {
        const float cmuu = a.uheads.cmu[j];
        const float evu = expf(a.uheads.clv[j]);
        const float tu = 1.0f / (evu + kPoeEps);
        const float ts_u = tu + tp;
        const float mu_u = cmuu * tu / ts_u, lv_u = -logf(ts_u);
        const float g_lv_u = g_zcu * uj * 0.5f * expf(0.5f * lv_u);
        const float g_tu = g_zcu * (cmuu - mu_u) / ts_u - g_lv_u / ts_u;
        a.g_uheads.cmu[j] = g_zcu * tu / ts_u;
        a.g_uheads.clv[j] = -g_tu * evu * tu * tu;
      } else {
        g_mu_s += g_zcu;
        g_lv_s += g_zcu * uj * 0.5f * expf(0.5f * lv_s);
      }
      const float g_t = g_mu_s * (cmu - mu_s) / ts - g_lv_s / ts;
      g_cmu = g_mu_s * t / ts;
      g_clv = -g_t * ev * t * t;
    }
    a.g_heads.cmu[j] = g_cmu;
    a.g_heads.clv[j] = g_clv;
  }
  for (int c = 0; c < s; ++c) {
    const long long j = static_cast<long long>(i) * s + c;
    const float smu = a.heads.smu[j], slv = a.heads.slv[j];
    const float ss = expf(0.5f * slv);
    const float g_zs = a.g_zs[j];
    float g_smu = g_zs + a.cs * smu;
    float g_slv = g_zs * nz[cd + c] * 0.5f * ss +
                  a.cs * 0.5f * (expf(slv) - 1.0f);
    if (a.method == kPoe) {
      const float g_zsu = a.g_zsu[j];
      const float us = nz[2 * cd + s + c];
      if (a.separate) {
        a.g_uheads.smu[j] = g_zsu;
        a.g_uheads.slv[j] = g_zsu * us * 0.5f * expf(0.5f * a.uheads.slv[j]);
      } else {
        g_smu += g_zsu;
        g_slv += g_zsu * us * 0.5f * ss;
      }
    }
    a.g_heads.smu[j] = g_smu;
    a.g_heads.slv[j] = g_slv;
  }
}

struct MetricArgs {
  const float* part;     // [kParts, b]
  const float* nll_col;  // [2, d]
  float* metrics;        // [9], poe [10]
  int method, b, d, cd, s;
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
  float uni_sum = 0.0f;
  if (a.method == kPoe) {
    uni_sum = step::block_sum(
        a.d, [&](int i) { return a.nll_col[a.d + i]; }, scratch);
  }
  if (threadIdx.x != 0) return;
  const float b = static_cast<float>(a.b);
  const float nll = nll_sum / b;
  const float kld_m = -0.5f * sums[0] / b;
  const float kld_s = -0.5f * sums[1] / b;
  const float style = a.beta_style * a.beta_style * kld_s;
  float group_div = kld_m, loss;
  if (a.method == kPoe) {
    const float uni = uni_sum / b;
    loss = uni + nll +
           a.beta * (2.0f * a.beta_content * kld_m + 2.0f * style);
    a.metrics[9] = uni;
  } else {
    if (a.method == kJsd) group_div = -0.5f * sums[6] / b / 2.0f;
    loss = nll + a.beta * (style + a.beta_content * group_div);
  }
  const float n_c = b * a.cd, n_s = b * a.s;
  const float head[9] = {loss,          group_div,     nll,
                         kld_m,         kld_s,         sums[2] / n_c,
                         sums[3] / n_c, sums[4] / n_s, sums[5] / n_s};
  for (int q = 0; q < 9; ++q) a.metrics[q] = head[q];
}

#define STEP_CHECK(expr)                                    \
  do {                                                      \
    cudaError_t err_ = (expr);                              \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace

extern "C" {

long long presence_step_workspace_floats(int method, int has_masks, int b,
                                         int d, int h, int cd, int s) {
  const int passes = (method == kPoe && has_masks) ? 2 : 1;
  return carve(nullptr, method, passes, b, d, h, cd, s).total;
}

// One step on `stream` for the present modality `mod_idx` (x [B, d_i],
// noise [B, w] with row stride ld_noise). method: 0 joint_elbo, 1 moe,
// 2 jsd, 3 poe. mask0 is null (no dropout) or the encoder's keep mask
// [B, h] with row stride ld_mask; mask1 is poe's unimodal re-encoding's
// (null otherwise). grads and params are flat buffers of the split layout
// of both modalities; metrics holds 9 floats (10 for poe). Returns the
// first CUDA error (0 on success); synchronizes and allocates nothing.
int presence_step_launch(const float* params, float* grads, float* metrics,
                         const float* x, const float* noise, int ld_noise,
                         const float* mask0, const float* mask1, int ld_mask,
                         float* work, int method, int mod_idx, int b, int d1,
                         int d2, int h, int cd, int s1, int s2, float beta,
                         float beta_style, float beta_content,
                         int learn_scale, void* stream_ptr) {
  if (mod_idx != 0 && mod_idx != 1) return cudaErrorInvalidValue;
  if (method < kJointElbo || method > kPoe) return cudaErrorInvalidValue;
  const bool poe = method == kPoe;
  if ((mask1 != nullptr) != (mask0 != nullptr && poe)) {
    return cudaErrorInvalidValue;
  }
  const int passes = mask1 != nullptr ? 2 : 1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const step::Layout L = step::make_layout(d1, d2, h, cd, s1, s2);
  const step::EncLayout& E = L.enc[mod_idx];
  const step::DecLayout& D = L.dec[mod_idx];
  const int d = mod_idx == 0 ? d1 : d2;
  const int s = mod_idx == 0 ? s1 : s2;
  const Work w = carve(work, method, passes, b, d, h, cd, s);
  const float* mask[2] = {mask0, mask1};
  const float* P = params;
  float* G = grads;

  // the absent modality's gradients are exactly zero
  STEP_CHECK(cudaMemsetAsync(G, 0, sizeof(float) * L.total, stream));
  // hidden layer of every encoding: relu(x Wh + bh) [* mask]
  {
    step::GemmBuilder g;
    for (int p = 0; p < passes; ++p) {
      auto* q = g.add(b, h, 0, 0, w.h[p], h, step::kBiasRelu, P + E.bh,
                      nullptr, 0, mask[p], ld_mask);
      g.add_segment(q, x, d, P + E.Wh, h, d);
    }
    STEP_CHECK(g.launch(stream));
  }
  const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
  const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
  const int n[4] = {cd, cd, s, s};
  float* heads[2][4];
  float* g_heads[2][4];
  for (int p = 0; p < 2; ++p) {
    const Heads &H = w.heads[p], &GH = w.g_heads[p];
    float* hp[4] = {H.cmu, H.clv, H.smu, H.slv};
    float* gp[4] = {GH.cmu, GH.clv, GH.smu, GH.slv};
    for (int k = 0; k < 4; ++k) {
      heads[p][k] = hp[k];
      g_heads[p][k] = gp[k];
    }
  }
  {
    step::GemmBuilder g;
    for (int p = 0; p < passes; ++p) {
      for (int k = 0; k < 4; ++k) {
        auto* q = g.add(b, n[k], 0, 0, heads[p][k], n[k], step::kBias,
                        P + bo[k]);
        g.add_segment(q, w.h[p], h, P + Wo[k], n[k], h);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  const float bf = static_cast<float>(b);
  // weight / b of the divergence's KL (jsd: two KLs against the dynamic
  // prior, halved) and of the style KL; poe counts both KLs twice
  const float n_kl = method == kJsd ? 2.0f : (poe ? 0.5f : 1.0f);
  const int up = passes - 1;  // the encoding the unimodal pass reads
  LatentArgs la;
  la.heads = w.heads[0];
  la.g_heads = w.g_heads[0];
  la.uheads = w.heads[up];
  la.g_uheads = w.g_heads[up];
  la.separate = passes == 2;
  la.noise = noise;
  la.ld = ld_noise;
  la.zc = w.zc;
  la.zs = w.zs;
  la.zcu = w.zcu;
  la.zsu = w.zsu;
  la.g_zc = w.g_zc;
  la.g_zs = w.g_zs;
  la.g_zcu = w.g_zcu;
  la.g_zsu = w.g_zsu;
  la.part = w.part;
  la.method = method;
  la.b = b;
  la.cd = cd;
  la.s = s;
  la.k2 = b / 2;  // floor(b / 2), fused_methods.py:125-129
  la.cg = beta * beta_content / (n_kl * bf);
  la.cs = (poe ? 2.0f : 1.0f) * beta * beta_style * beta_style / bf;
  const int row_blocks = (b + kRowThreads - 1) / kRowThreads;
  latent_fwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  {
    step::GemmBuilder g;
    auto* q = g.add(b, d, 0, 0, w.r, d, step::kResidual, P + D.bd, x, d);
    g.add_segment(q, w.zs, s, P + D.Wds, d, s);
    g.add_segment(q, w.zc, cd, P + D.Wdc, d, cd);
    if (poe) {
      q = g.add(b, d, 0, 0, w.ru, d, step::kResidual, P + D.bd, x, d);
      g.add_segment(q, w.zsu, s, P + D.Wds, d, s);
      g.add_segment(q, w.zcu, cd, P + D.Wdc, d, cd);
    }
    STEP_CHECK(g.launch(stream));
  }
  {
    step::DecReduceBatch rb;
    rb.p[0] = step::DecReduce{w.r,       P + D.olv, w.g_loc, G + D.bd,
                              G + D.olv, w.nll_col, d,
                              poe ? w.ru : nullptr,
                              poe ? w.g_locu : nullptr,
                              poe ? w.nll_col + d : nullptr};
    rb.p[1] = rb.p[0];
    rb.b = b;
    rb.b_total = b;
    rb.learn_scale = learn_scale;
    dim3 grid((d + step::kColThreads - 1) / step::kColThreads, 1);
    step::dec_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    STEP_CHECK(cudaGetLastError());
  }
  {
    step::GemmBuilder g;
    auto* q = g.add(s, d, 1, 0, G + D.Wds, d);  // zs^T g_loc
    g.add_segment(q, w.zs, s, w.g_loc, d, b);
    if (poe) g.add_segment(q, w.zsu, s, w.g_locu, d, b);
    q = g.add(cd, d, 1, 0, G + D.Wdc, d);       // zc^T g_loc
    g.add_segment(q, w.zc, cd, w.g_loc, d, b);
    if (poe) g.add_segment(q, w.zcu, cd, w.g_locu, d, b);
    q = g.add(b, s, 0, 1, w.g_zs, s);           // g_loc Wds^T
    g.add_segment(q, w.g_loc, d, P + D.Wds, d, d);
    q = g.add(b, cd, 0, 1, w.g_zc, cd);         // g_loc Wdc^T
    g.add_segment(q, w.g_loc, d, P + D.Wdc, d, d);
    if (poe) {
      q = g.add(b, s, 0, 1, w.g_zsu, s);
      g.add_segment(q, w.g_locu, d, P + D.Wds, d, d);
      q = g.add(b, cd, 0, 1, w.g_zcu, cd);
      g.add_segment(q, w.g_locu, d, P + D.Wdc, d, d);
    }
    STEP_CHECK(g.launch(stream));
  }
  latent_bwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  {
    step::GemmBuilder g;
    for (int k = 0; k < 4; ++k) {
      auto* q = g.add(h, n[k], 1, 0, G + Wo[k], n[k]);  // h^T g_head
      for (int p = 0; p < passes; ++p) {
        g.add_segment(q, w.h[p], h, g_heads[p][k], n[k], b);
      }
    }
    for (int p = 0; p < passes; ++p) {
      auto* q = g.add(b, h, 0, 1, w.g_h[p], h, step::kReluMask, nullptr,
                      w.h[p], h, mask[p], ld_mask);
      for (int k = 0; k < 4; ++k) {
        g.add_segment(q, g_heads[p][k], n[k], P + Wo[k], n[k], n[k]);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  {
    step::ColSumBuilder c;
    const bool two = passes == 2;
    for (int k = 0; k < 4; ++k) {
      c.add(g_heads[0][k], b, n[k], G + bo[k],
            two ? g_heads[1][k] : nullptr);
    }
    c.add(w.g_h[0], b, h, G + E.bh, two ? w.g_h[1] : nullptr);
    STEP_CHECK(c.launch(stream));
  }
  {
    step::GemmBuilder g;
    auto* q = g.add(d, h, 1, 0, G + E.Wh, h);  // x^T g_h
    for (int p = 0; p < passes; ++p) {
      g.add_segment(q, x, d, w.g_h[p], h, b);
    }
    STEP_CHECK(g.launch(stream));
  }
  MetricArgs ma{w.part, w.nll_col, metrics, method, b,           d,
                cd,     s,         beta,    beta_style, beta_content};
  metrics_kernel<<<1, step::kMetricThreads, 0, stream>>>(ma);
  STEP_CHECK(cudaGetLastError());
  return 0;
}

const char* presence_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
