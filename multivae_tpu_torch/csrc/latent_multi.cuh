// The methods' latent math of a complete-batch train step for any modality
// count M (2 .. kMaxMods), for Hopper (sm_90a): what stands between the
// encoders' head outputs and the decoders' inputs, forward and hand-derived
// backward, and the step's metrics. generic_step.cu runs it for every M but
// 2 and for poe without its unimodal ELBOs; at M = 2 the other methods keep
// latent_common.cuh, whose two-modality shortcuts this header does not
// take. The plain version is multivae_tpu_torch/ops/latent_multi.py; both
// follow multivae_tpu/models/mmvae.py and multivae_tpu/train/losses.py:
//
// * joint_elbo mixes all S = 2^M - 1 subsets in powerset_subsets order
//   (sizes 1 .. M, each in combinations order; `subsets` holds their
//   bitmasks), each the PoE of its experts, the unit prior expert joining
//   the full set only. Rows go to components by mixture_partition(S, B):
//   `joint_size` rows each, the last component the rest (0 when S > B:
//   every row is the last's). The divergence is the mean of the S subsets'
//   KLs over every row.
// * moe mixes the M unimodal posteriors (an M-way partition); a subset of
//   several modalities has, as a metric, the KL of its members' mixture
//   (a |s|-way partition of the rows over its members).
// * jsd mixes the M experts and the unit expert; the divergence is the mean
//   of the M + 1 KLs against their alpha-PoE with weights 1 / (M + 1).
// * poe: the joint is the PoE of the prior and all M experts; every subset
//   takes the prior. With its unimodal ELBOs (`uni`) one more ELBO per
//   modality decodes (zsu, zcu) from the PoE of the prior with that
//   modality's expert, of the first encoding or (`separate`, under dropout)
//   of a second one; its KL is the first encoding's subset {m}.
//
// Tasks, each strided over the blocks of a phase by the caller (every
// thread of the block calls it):
// * fwd_task: the latent phase. Tasks [0, row_tasks) take kWarps rows, a
//   warp per row with the lanes over the columns: the joint selection, the
//   reparameterizations (zc, zs, poe's zcu, zsu), the style KLs, the latent
//   means and jsd's prior KLs, as row partials. The other tasks take kWarps
//   (row, subset) pairs, a warp per pair: the subset's KL over the row's
//   content columns. Every partial is a fixed butterfly over the lanes.
// * bwd_task: a thread per element of [B, cd + sum s]: a content element
//   walks every subset (joint_elbo) or expert for all M encoders' content
//   heads; a style element is its modality's.
// * sum_task: kWarps of the metrics' sums, a warp per sum (the row
//   partials over the rows, the NLLs over the columns); metrics_task: the
//   metric vector from them (one task).
// No float atomics; every sum's order is fixed, so two runs and two grids
// give the same bits.

#pragma once

#include <cmath>

#include "latent_common.cuh"
#include "step_common.cuh"

namespace latent_m {

using latent::Heads;
using latent::kJointElbo;
using latent::kJsd;
using latent::kl_term;
using latent::kMoe;
using latent::kPoe;
using step::kPoeEps;

constexpr int kMaxMods = 10;
constexpr int kMaxSubsets = (1 << kMaxMods) - 1;

// Row partials: [0, S) the subsets' KL sums; S + e the style KL of e;
// S + M + 4 e + {0, 1, 2, 3} the sums of cmu, clv, smu, slv of e; S + 5 M
// jsd's KLs against its prior.
__host__ __device__ inline int n_parts(int m, int n_subsets) {
  return n_subsets + 5 * m + 1;
}

// The metrics' sums: the row partials', then the NLL of every decode
// (the first decode's M, then poe's unimodal decodes' M).
__host__ __device__ inline int n_sums(int m, int n_subsets, int uni) {
  return n_parts(m, n_subsets) + m * (uni ? 2 : 1);
}

// loss, joint_divergence, log_prob x M, kld x S, kld_style x M, the four
// latent means x M, poe's log_prob_uni x M (ops/latent_multi.py,
// step_metric_names).
__host__ __device__ inline int n_metrics(int m, int n_subsets, int uni) {
  return 2 + 6 * m + n_subsets + (uni ? m : 0);
}

// The bitmasks of the non-empty subsets of M modalities in powerset_subsets
// order; returns their count.
__host__ __device__ inline int powerset_masks(int m, unsigned short* out) {
  int n = 0;
  for (int r = 1; r <= m; ++r) {
    int idx[kMaxMods];
    for (int j = 0; j < r; ++j) idx[j] = j;
    for (;;) {
      unsigned mask = 0;
      for (int j = 0; j < r; ++j) mask |= 1u << idx[j];
      out[n++] = static_cast<unsigned short>(mask);
      int j = r - 1;
      while (j >= 0 && idx[j] == m - r + j) --j;
      if (j < 0) break;
      ++idx[j];
      for (int k = j + 1; k < r; ++k) idx[k] = idx[k - 1] + 1;
    }
  }
  return n;
}

// The component of `row` under a k-way partition of `size` rows each, the
// last component taking the rest.
__host__ __device__ inline int owner(int row, int k, int size) {
  if (size <= 0) return k - 1;
  const int c = row / size;
  return c < k - 1 ? c : k - 1;
}

// Rows per component of mixture_partition(k, b) (multivae_tpu/ops/
// fusion.py): floor(b w) with w = (1 / k) / sum of k copies of 1 / k, in
// double as there.
__host__ __device__ inline int partition_size(int k, int b) {
  double total = 0.0;
  for (int i = 0; i < k; ++i) total += 1.0 / k;
  const double w = (1.0 / k) / total;
  return static_cast<int>(floor(static_cast<double>(b) * w));
}

struct Args {
  int method, m, b, cd, uni, separate, n_subsets;
  int s[kMaxMods], d[kMaxMods];
  const unsigned short* subsets;  // [n_subsets] bitmasks
  // the noise's row stride and column offsets: cd | s_1 .. s_M, then for
  // poe's unimodal ELBOs cd | s_m per modality
  int ld, es_off[kMaxMods], uj_off[kMaxMods], us_off[kMaxMods];
  Heads heads[kMaxMods], g_heads[kMaxMods];    // the first encoding
  Heads uheads[kMaxMods], g_uheads[kMaxMods];  // poe: the unimodal pass's
  float* zc;
  const float* g_zc_part[kMaxMods];  // decoder e's share of zc's gradient
  float *zs[kMaxMods], *g_zs[kMaxMods];
  float *zcu[kMaxMods], *g_zcu[kMaxMods], *zsu[kMaxMods], *g_zsu[kMaxMods];
  float* part;           // [n_parts, b]
  const float* nll_col;  // [passes, sum d]: the NLL's column sums
  float* sums;           // [n_sums]
  int joint_size;               // rows per component of the joint selection
  int size_of[kMaxMods + 2];    // rows per component of a k-way partition
  float cg, cs, beta, beta_style, beta_content;
};

// What Args holds beside the workspace's pointers: the noise's layout, the
// partitions and the coefficients (cg: of a unit-prior (jsd: dynamic-prior)
// KL's gradient, cs: of a style KL's, each over b).
__host__ __device__ inline void set_consts(Args& a, int method, int uni,
                                           int m, int b, int cd, const int* d,
                                           const int* s, int ld_noise,
                                           float beta, float beta_style,
                                           float beta_content) {
  a.method = method;
  a.uni = uni;
  a.m = m;
  a.b = b;
  a.cd = cd;
  a.n_subsets = (1 << m) - 1;
  a.ld = ld_noise;
  int off = cd;
  for (int e = 0; e < m; ++e) {
    a.d[e] = d[e];
    a.s[e] = s[e];
    a.es_off[e] = off;
    off += s[e];
  }
  for (int e = 0; e < m; ++e) {
    a.uj_off[e] = off;
    a.us_off[e] = off + cd;
    off += cd + s[e];
  }
  a.joint_size = partition_size(a.n_subsets, b);
  for (int k = 1; k <= m + 1; ++k) a.size_of[k] = partition_size(k, b);
  a.size_of[0] = 0;
  const float bf = static_cast<float>(b);
  const float n_kl = method == kJointElbo ? static_cast<float>(a.n_subsets)
                     : method == kMoe     ? static_cast<float>(m)
                     : method == kJsd     ? static_cast<float>(m + 1)
                                          : 1.0f;
  a.cg = beta * beta_content / (n_kl * bf);
  a.cs = (uni ? 2.0f : 1.0f) * beta * beta_style * beta_style / bf;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
}

__host__ __device__ inline int row_tasks(int b) {
  return (b + step::kWarps - 1) / step::kWarps;
}

__host__ __device__ inline int fwd_tasks(int b, int n_subsets) {
  return row_tasks(b) +
         (b * n_subsets + step::kWarps - 1) / step::kWarps;
}

__host__ __device__ inline int bwd_tasks(int b, int cd, const int* s, int m) {
  int width = cd;
  for (int e = 0; e < m; ++e) width += s[e];
  return (b * width + step::kGemmThreads - 1) / step::kGemmThreads;
}

__host__ __device__ inline int sum_tasks(int m, int n_subsets, int uni) {
  return (n_sums(m, n_subsets, uni) + step::kWarps - 1) / step::kWarps;
}

// The PoE of the experts in `mask` (and the unit prior expert), summed in
// model order, the prior last: mu, lv = -log ts, ts.
__device__ __forceinline__ void poe_of(unsigned mask, bool prior,
                                       const float* cmu, const float* t,
                                       int m, float& mu, float& lv,
                                       float& ts) {
  float tsum = 0.0f, num = 0.0f;
  bool first = true;
  for (int e = 0; e < m; ++e) {
    if (!(mask >> e & 1u)) continue;
    tsum = first ? t[e] : tsum + t[e];
    num = first ? cmu[e] * t[e] : num + cmu[e] * t[e];
    first = false;
  }
  if (prior) tsum += 1.0f / (1.0f + kPoeEps);
  ts = tsum;
  mu = num / tsum;
  lv = -logf(tsum);
}

// The joint selection at row i: (mu, lv) of the component that owns it,
// from the experts' content heads at one column.
__device__ __forceinline__ void joint_of(const Args& a, int i,
                                         const float* cmu, const float* clv,
                                         const float* t, int& k, float& mu,
                                         float& lv) {
  const unsigned full = (1u << a.m) - 1u;
  if (a.method == kJointElbo) {
    k = owner(i, a.n_subsets, a.joint_size);
    const unsigned mask = a.subsets[k];
    float ts;
    poe_of(mask, mask == full, cmu, t, a.m, mu, lv, ts);
  } else if (a.method == kMoe) {
    k = owner(i, a.m, a.size_of[a.m]);
    mu = cmu[k];
    lv = clv[k];
  } else if (a.method == kJsd) {
    k = owner(i, a.m + 1, a.size_of[a.m + 1]);
    mu = k < a.m ? cmu[k] : 0.0f;  // the unit expert: mu = 0, logvar = 0
    lv = k < a.m ? clv[k] : 0.0f;
  } else {
    k = 0;
    float ts;
    poe_of(full, true, cmu, t, a.m, mu, lv, ts);
  }
}

// One task of the latent phase (see the header).
__device__ void fwd_task(const Args& a, const float* noise, int task) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cd = a.cd, M = a.m;
  const int rows = row_tasks(a.b);
  if (task >= rows) {  // a (row, subset) pair's KL
    const long long q =
        static_cast<long long>(task - rows) * step::kWarps + warp;
    if (q >= static_cast<long long>(a.b) * a.n_subsets) return;
    const int i = static_cast<int>(q / a.n_subsets);
    const int k = static_cast<int>(q % a.n_subsets);
    const unsigned mask = a.subsets[k];
    const int members = __popc(mask);
    const bool poe_like = a.method == kJointElbo || a.method == kPoe;
    const bool prior = a.method == kPoe || mask == (1u << M) - 1u;
    // moe and jsd: the mixture of the members picks one per row
    int pick = -1;
    if (!poe_like) {
      int j = members == 1 ? 0 : owner(i, members, a.size_of[members]);
      for (int e = 0; e < M; ++e) {
        if (mask >> e & 1u) {
          if (j == 0) {
            pick = e;
            break;
          }
          --j;
        }
      }
    }
    float acc = 0.0f;
    for (int c = lane; c < cd; c += 32) {
      const long long j = static_cast<long long>(i) * cd + c;
      float mu, lv;
      if (poe_like) {
        float cmu[kMaxMods], t[kMaxMods], ts;
        for (int e = 0; e < M; ++e) {
          if (!(mask >> e & 1u)) continue;
          cmu[e] = a.heads[e].cmu[j];
          t[e] = 1.0f / (expf(a.heads[e].clv[j]) + kPoeEps);
        }
        poe_of(mask, prior, cmu, t, M, mu, lv, ts);
      } else {
        mu = a.heads[pick].cmu[j];
        lv = a.heads[pick].clv[j];
      }
      acc += kl_term(mu, lv);
    }
    acc = step::warp_sum(acc);
    if (lane == 0) a.part[static_cast<long long>(k) * a.b + i] = acc;
    return;
  }
  const int i = task * step::kWarps + warp;
  if (i >= a.b) return;  // the same for every lane of the warp
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float* nz = noise + static_cast<long long>(i) * a.ld;
  const int S = a.n_subsets;
  float parts[5 * kMaxMods + 1];
  for (int q = 0; q < 5 * M + 1; ++q) parts[q] = 0.0f;
  for (int c = lane; c < cd; c += 32) {
    const long long j = static_cast<long long>(i) * cd + c;
    float cmu[kMaxMods], clv[kMaxMods], ev[kMaxMods], t[kMaxMods];
    for (int e = 0; e < M; ++e) {
      cmu[e] = a.heads[e].cmu[j];
      clv[e] = a.heads[e].clv[j];
      ev[e] = expf(clv[e]);
      t[e] = 1.0f / (ev[e] + kPoeEps);
      parts[M + 4 * e] += cmu[e];
      parts[M + 4 * e + 1] += clv[e];
    }
    int k;
    float jmu, jlv;
    joint_of(a, i, cmu, clv, t, k, jmu, jlv);
    a.zc[j] = jmu + nz[c] * expf(0.5f * jlv);
    if (a.method == kJsd) {
      float big_s = t[0], num = cmu[0] * t[0];
      for (int e = 1; e < M; ++e) {
        big_s += t[e];
        num += cmu[e] * t[e];
      }
      big_s += tp;
      const float pm = num / big_s;
      const float ipv = big_s / static_cast<float>(M + 1);  // exp(-plv)
      const float plv = -logf(ipv);
      float kl = 0.0f;
      for (int e = 0; e < M; ++e) {
        const float dm = cmu[e] - pm;
        kl += 1.0f - ev[e] * ipv - dm * dm * ipv + clv[e] - plv;
      }
      kl += 1.0f - ipv - pm * pm * ipv - plv;
      parts[5 * M] += kl;
    }
    if (a.uni) {
      for (int e = 0; e < M; ++e) {
        float tu = t[e], cmuu = cmu[e];
        if (a.separate) {
          cmuu = a.uheads[e].cmu[j];
          tu = 1.0f / (expf(a.uheads[e].clv[j]) + kPoeEps);
        }
        const float ts_u = tu + tp;
        const float mu_u = cmuu * tu / ts_u, lv_u = -logf(ts_u);
        a.zcu[e][j] = mu_u + nz[a.uj_off[e] + c] * expf(0.5f * lv_u);
      }
    }
  }
  for (int e = 0; e < M; ++e) {
    const int s = a.s[e];
    for (int c = lane; c < s; c += 32) {
      const long long j = static_cast<long long>(i) * s + c;
      const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
      a.zs[e][j] = smu + nz[a.es_off[e] + c] * expf(0.5f * slv);
      if (a.uni) {
        a.zsu[e][j] = a.uheads[e].smu[j] +
                      nz[a.us_off[e] + c] * expf(0.5f * a.uheads[e].slv[j]);
      }
      parts[e] += kl_term(smu, slv);
      parts[M + 4 * e + 2] += smu;
      parts[M + 4 * e + 3] += slv;
    }
  }
  for (int q = 0; q < 5 * M + 1; ++q) {
    const float total = step::warp_sum(parts[q]);
    if (lane == 0) a.part[static_cast<long long>(S + q) * a.b + i] = total;
  }
}

// The gradients of every encoder's content heads at row i, column c.
__device__ __forceinline__ void content_bwd(const Args& a, const float* nz,
                                            int i, int c) {
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int M = a.m;
  const long long j = static_cast<long long>(i) * a.cd + c;
  const float cg = a.cg;
  float cmu[kMaxMods], clv[kMaxMods], ev[kMaxMods], t[kMaxMods];
  float g_cmu[kMaxMods], g_clv[kMaxMods], g_t[kMaxMods];
  for (int e = 0; e < M; ++e) {
    cmu[e] = a.heads[e].cmu[j];
    clv[e] = a.heads[e].clv[j];
    ev[e] = expf(clv[e]);
    t[e] = 1.0f / (ev[e] + kPoeEps);
    g_cmu[e] = g_clv[e] = g_t[e] = 0.0f;
  }
  float g_zc = a.g_zc_part[0][j];
  for (int e = 1; e < M; ++e) g_zc += a.g_zc_part[e][j];
  int k;
  float jmu, jlv;
  joint_of(a, i, cmu, clv, t, k, jmu, jlv);
  const float g_jmu = g_zc;
  const float g_jlv = g_zc * nz[c] * 0.5f * expf(0.5f * jlv);
  // mu = sum(cmu t) / ts, lv = -log ts: into g_cmu and g_t of the members
  auto through_poe = [&](unsigned mask, float mu, float ts, float g_mu,
                         float g_lv) {
    for (int e = 0; e < M; ++e) {
      if (!(mask >> e & 1u)) continue;
      g_cmu[e] += g_mu * (t[e] / ts);
      g_t[e] += g_mu * (cmu[e] - mu) / ts - g_lv / ts;
    }
  };
  if (a.method == kJointElbo) {
    const unsigned full = (1u << M) - 1u;
    for (int s = 0; s < a.n_subsets; ++s) {
      const unsigned mask = a.subsets[s];
      float mu, lv, ts;
      poe_of(mask, mask == full, cmu, t, M, mu, lv, ts);
      const float own = s == k ? 1.0f : 0.0f;
      through_poe(mask, mu, ts, own * g_jmu + cg * mu,
                  own * g_jlv + cg * 0.5f * (expf(lv) - 1.0f));
    }
  } else if (a.method == kMoe) {
    for (int e = 0; e < M; ++e) {
      const float own = e == k ? 1.0f : 0.0f;
      g_cmu[e] = own * g_jmu + cg * cmu[e];
      g_clv[e] = own * g_jlv + cg * 0.5f * (ev[e] - 1.0f);
    }
  } else if (a.method == kJsd) {
    float big_s = t[0], num = cmu[0] * t[0];
    for (int e = 1; e < M; ++e) {
      big_s += t[e];
      num += cmu[e] * t[e];
    }
    big_s += tp;
    const float pm = num / big_s;
    const float ipv = big_s / static_cast<float>(M + 1);
    // through the prior: d/d pm and d/d plv of the M + 1 KLs
    float sum_d = 0.0f, sum_v = 0.0f;
    for (int e = 0; e < M; ++e) {
      const float dm = cmu[e] - pm;
      sum_d += dm;
      sum_v += ev[e] * ipv + dm * dm * ipv - 1.0f;
    }
    const float g_pm = -cg * ipv * (sum_d - pm);
    const float g_plv = -cg * 0.5f * (sum_v + (ipv + pm * pm * ipv - 1.0f));
    for (int e = 0; e < M; ++e) {
      const float own = e == k ? 1.0f : 0.0f;
      const float dm = cmu[e] - pm;
      const float gt = g_pm * dm / big_s - g_plv / big_s;
      g_cmu[e] = own * g_jmu + cg * dm * ipv + g_pm * t[e] / big_s;
      g_clv[e] = own * g_jlv + cg * 0.5f * (ev[e] * ipv - 1.0f) -
                 gt * ev[e] * t[e] * t[e];
    }
  } else {  // poe
    const unsigned full = (1u << M) - 1u;
    float mu_c, lv_c, ts_c;
    poe_of(full, true, cmu, t, M, mu_c, lv_c, ts_c);
    through_poe(full, mu_c, ts_c, g_jmu + cg * mu_c,
                g_jlv + cg * 0.5f * (expf(lv_c) - 1.0f));
    if (a.uni) {
      for (int e = 0; e < M; ++e) {
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
        through_poe(1u << e, mu_s, ts_s, g_mu_s, g_lv_s);
      }
    }
  }
  for (int e = 0; e < M; ++e) {
    // d t / d clv = -exp(clv) t^2
    a.g_heads[e].cmu[j] = g_cmu[e];
    a.g_heads[e].clv[j] = g_clv[e] - g_t[e] * ev[e] * t[e] * t[e];
  }
}

// The gradients of encoder e's style heads at row i, column c.
__device__ __forceinline__ void style_bwd(const Args& a, const float* nz,
                                          int i, int e, int c) {
  const long long j = static_cast<long long>(i) * a.s[e] + c;
  const float smu = a.heads[e].smu[j], slv = a.heads[e].slv[j];
  const float ss = expf(0.5f * slv);
  const float g_zs = a.g_zs[e][j];
  float g_smu = g_zs + a.cs * smu;
  float g_slv = g_zs * nz[a.es_off[e] + c] * 0.5f * ss +
                a.cs * 0.5f * (expf(slv) - 1.0f);
  if (a.uni) {
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

// One task of the latents' backward: kGemmThreads elements of [B, cd +
// sum s], a thread per element.
__device__ void bwd_task(const Args& a, const float* noise, int task) {
  int width = a.cd;
  for (int e = 0; e < a.m; ++e) width += a.s[e];
  const long long idx =
      static_cast<long long>(task) * step::kGemmThreads + threadIdx.x;
  if (idx >= static_cast<long long>(a.b) * width) return;
  const int i = static_cast<int>(idx / width);
  int c = static_cast<int>(idx % width);
  const float* nz = noise + static_cast<long long>(i) * a.ld;
  if (c < a.cd) {
    content_bwd(a, nz, i, c);
    return;
  }
  c -= a.cd;
  int e = 0;
  while (c >= a.s[e]) c -= a.s[e++];
  style_bwd(a, nz, i, e, c);
}

// One task of the sums: kWarps of them, a warp per sum (lanes strided over
// the rows or columns, then a fixed butterfly).
__device__ void sum_task(const Args& a, int task) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q = task * step::kWarps + warp;
  const int np = n_parts(a.m, a.n_subsets);
  if (q >= n_sums(a.m, a.n_subsets, a.uni)) return;
  const float* src;
  int n;
  if (q < np) {
    src = a.part + static_cast<long long>(q) * a.b;
    n = a.b;
  } else {
    const int k = q - np, u = k / a.m, e = k % a.m;
    int sum_d = 0, off = 0;
    for (int f = 0; f < a.m; ++f) {
      if (f < e) off += a.d[f];
      sum_d += a.d[f];
    }
    src = a.nll_col + static_cast<long long>(u) * sum_d + off;
    n = a.d[e];
  }
  float acc = 0.0f;
  for (int r = lane; r < n; r += 32) acc += src[r];
  acc = step::warp_sum(acc);
  if (lane == 0) a.sums[q] = acc;
}

// The step's metrics into `metrics` (n_metrics of them) from the sums.
// Thread 0 takes the loss and the divergence, the others the rest.
__device__ void metrics_task(const Args& a, float* metrics) {
  const int M = a.m, S = a.n_subsets;
  const float b = static_cast<float>(a.b);
  const int np = n_parts(M, S);
  const float* sums = a.sums;
  if (threadIdx.x == 0) {
    float nll = 0.0f, style = 0.0f, uni = 0.0f, single = 0.0f;
    for (int e = 0; e < M; ++e) {
      nll += sums[np + e] / b;
      style += -0.5f * sums[S + e] / b;
      single += -0.5f * sums[e] / b;  // the first M subsets: {e}
      if (a.uni) uni += sums[np + M + e] / b;
    }
    style *= a.beta_style * a.beta_style;
    float group_div;
    if (a.method == kJointElbo) {
      group_div = 0.0f;
      for (int s = 0; s < S; ++s) group_div += -0.5f * sums[s] / b;
      group_div /= static_cast<float>(S);
    } else if (a.method == kMoe) {
      group_div = single / static_cast<float>(M);
    } else if (a.method == kJsd) {
      group_div = -0.5f * sums[S + 5 * M] / b / static_cast<float>(M + 1);
    } else {
      group_div = -0.5f * sums[S - 1] / b;  // the full set
    }
    float loss;
    if (a.uni) {
      loss = uni + nll +
             a.beta * (a.beta_content * (single + group_div) + 2.0f * style);
    } else if (a.method == kPoe) {
      loss = nll + a.beta * (a.beta_content * group_div + style);
    } else {
      loss = nll + a.beta * (style + a.beta_content * group_div);
    }
    metrics[0] = loss;
    metrics[1] = group_div;
  }
  const int n = n_metrics(M, S, a.uni);
  for (int q = 2 + threadIdx.x; q < n; q += blockDim.x) {
    int r = q - 2;
    float v;
    if (r < M) {
      v = sums[np + r] / b;  // log_prob
    } else if ((r -= M) < S) {
      v = -0.5f * sums[r] / b;  // kld of subset r
    } else if ((r -= S) < M) {
      v = -0.5f * sums[S + r] / b;  // kld_style
    } else if ((r -= M) < 4 * M) {
      const int e = r / 4, k = r % 4;
      const float count = b * static_cast<float>(k < 2 ? a.cd : a.s[e]);
      // a style latent of width 0 (the unfactorized latent) has mean 0
      v = count > 0.0f ? sums[S + M + r] / count : 0.0f;
    } else {
      v = sums[np + M + (r - 4 * M)] / b;  // log_prob_uni
    }
    metrics[q] = v;
  }
}

}  // namespace latent_m
