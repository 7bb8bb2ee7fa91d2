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
// What bounds it: latency, as for the MoPoE step (see mopoe_step.cu): the
// method step's half (one encoder, one decoder), every product small, so
// the hand-overs between dependent phases and the serial loops cost the
// time, not bytes or float32 operations. The same design: ONE persistent,
// cooperative launch runs a group of n steps (presence_epoch_launch; the
// one-step entry point is the same kernel with n = 1 and Adam off) for any
// method, mask setting and mod_idx; params, moments and activations stay in
// L2 across the steps, the stand-in for the TPU kernel's VMEM residency.
// Eight phases, 8 grid barriers a step (the launch's last one left out: 7
// for one step), each phase's tasks strided over the blocks:
//   0. hidden layer of every encoding: relu(x Wh + bh) [* mask]; beside it
//      the absent modality's gradients are set to zero
//   1. the four heads of every encoding
//   2. the latents, a warp per row
//   3. g_loc of the decode (and of poe's unimodal decode) with per-row-tile
//      column partials in the epilogue
//   4. the decoder's weight grads and the latents' grads; the column
//      partials added in row-tile order (both decodes' for poe)
//   5. the head-output grads, a thread per element
//   6. g_h of every encoding; beside it the metrics (a warp per sum)
//   7. head and hidden weight grads, head and hidden bias grads; with Adam
//      on, every gradient element takes its update where it is produced and
//      the older phases' (the decoder's, the absent modality's zeros) beside
//      them, over all 28 tensors
// Products are step_common.cuh's gemm_tile (in-block split-K in a fixed
// order), float32 FMA in the float32 instance; the bfloat16 branch (bf16 !=
// 0, scheme B of multivae_tpu_torch/ops/bf16.py, as in method_step.cu) is a
// second instance: forward products on the tensor cores, backward products
// of a float32 cotangent and a bfloat16 operand on the FMA path with each
// product's sum rounded to bfloat16. No library product, no float atomics:
// two runs and two grids give the same bits.

#include <cooperative_groups.h>

#include "adam_common.cuh"
#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using step::kPoeEps;
using step::kTile;
using step::kWarps;

constexpr int kParts = 7;  // per-row partial sums, see latent_fwd_task
constexpr int kPhases = 8;
constexpr int kTableProblems = 25;  // the sum of phase_problems
constexpr int kColSums = 5;
constexpr int kCombineCols = step::kGemmThreads;  // columns per combine task
enum Phase {
  kHidden = 0, kHeads, kLatentFwd, kDecode, kDecGrads, kLatentBwd,
  kHiddenGrad, kWeightGrads
};

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

// Problems in each phase's table (poe with masks fills them).
__host__ __device__ inline int phase_problems(int phase) {
  const int n[kPhases] = {2, 8, 0, 2, 6, 0, 2, 5};
  return n[phase];
}

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct Work {
  // [pass]; pass 1 exists for poe with masks (the unimodal re-encoding)
  float *h[2], *g_h[2];
  Heads heads[2], g_heads[2];
  float *zc, *zs, *g_loc, *g_zc, *g_zs;
  float *zcu, *zsu, *g_locu, *g_zcu, *g_zsu;  // poe's unimodal decode
  float *colp[2];  // [3, row tiles, d]: first decode, unimodal decode
  float *part;     // [kParts, B]
  float *nll_col;  // [2, d]: first decode, unimodal decode
  long long total;
};

__host__ __device__ Work carve(float* base, int method, int passes, int b,
                               int d, int h, int cd, int s) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 3) / 4 * 4;  // every buffer starts 16-byte aligned
    return p;
  };
  const long long bl = b;
  const long long row_tiles = (b + kTile - 1) / kTile;
  for (int p = 0; p < 2; ++p) {
    const long long on = p < passes ? 1 : 0;
    w.h[p] = take(on * bl * h);
    w.g_h[p] = take(on * bl * h);
    Heads* both[2] = {&w.heads[p], &w.g_heads[p]};
    for (Heads* H : both) {
      H->cmu = take(on * bl * cd);
      H->clv = take(on * bl * cd);
      H->smu = take(on * bl * s);
      H->slv = take(on * bl * s);
    }
  }
  w.zc = take(bl * cd);
  w.zs = take(bl * s);
  w.g_loc = take(bl * d);
  w.g_zc = take(bl * cd);
  w.g_zs = take(bl * s);
  w.colp[0] = take(step::kMaxColOut * row_tiles * d);
  const long long uni = method == kPoe ? 1 : 0;
  w.zcu = take(uni * bl * cd);
  w.zsu = take(uni * bl * s);
  w.g_locu = take(uni * bl * d);
  w.g_zcu = take(uni * bl * cd);
  w.g_zsu = take(uni * bl * s);
  w.colp[1] = take(uni * step::kMaxColOut * row_tiles * d);
  w.part = take(kParts * bl);
  w.nll_col = take(2LL * d);
  w.total = off;
  return w;
}

// Everything one launch needs, by value (the kernel derives its pointers
// into params, grads and the workspace itself).
struct StepParams {
  float *params, *grads, *metrics;  // metrics [n_steps, 9 | 10]
  float *mu, *nu;                   // Adam's moments (adam != 0)
  float* work;
  const float *x, *noise;           // step 0's
  const float *mask0, *mask1;       // step 0's keep masks, or nullptr
  long long x_step, noise_step, mask_step;  // floats between two steps'
  int ld_noise, ld_mask;
  int n_steps, adam, method, mod_idx, passes, b;
  int d1, d2, h, cd, s1, s2, learn_scale;
  int bf16;  // the bfloat16 branch (scheme B): the kernel<true> instance
  float beta, beta_style, beta_content;
  long long count;  // Adam updates taken before this launch
  adam::Hyper hyper;
  // tracing: null, or [n_steps, kPhases + 1] device timestamps in ns (block
  // 0's clock at the start of each step and after each phase's barrier)
  unsigned long long* phase_times;

  __host__ __device__ int d() const { return mod_idx == 0 ? d1 : d2; }
  __host__ __device__ int s() const { return mod_idx == 0 ? s1 : s2; }
  __host__ __device__ int n_metrics() const { return method == kPoe ? 10 : 9; }
};

// The problems of one phase into T, and the last phase's column sums into C.
__host__ __device__ void build_phase(int phase, const StepParams& a,
                                     const step::Layout& L, const Work& w,
                                     step::GemmTable& T,
                                     step::ColSumTable& C) {
  const step::EncLayout& E = L.enc[a.mod_idx];
  const step::DecLayout& D = L.dec[a.mod_idx];
  const int b = a.b, h = a.h, cd = a.cd, d = a.d(), s = a.s();
  const int passes = a.passes;
  const bool poe = a.method == kPoe;
  const int x_step = static_cast<int>(a.x_step);
  const int mask_step = static_cast<int>(a.mask_step);
  const float* mask[2] = {a.mask0, a.mask1};
  float* P = a.params;
  float* G = a.grads;
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
  if (phase == kLatentFwd || phase == kLatentBwd) {
    // no products
  } else if (phase == kHidden) {
    // hidden layer of every encoding: relu(x Wh + bh) [* mask]
    for (int p = 0; p < passes; ++p) {
      auto* q = T.add(b, h, 0, 0, w.h[p], h, step::kBiasRelu, P + E.bh,
                      nullptr, 0, mask[p], a.ld_mask);
      T.add_segment(q, a.x, d, P + E.Wh, h, d);
      if (q != nullptr) {
        q->step_A = x_step;
        q->step_mask = mask_step;
      }
    }
  } else if (phase == kHeads) {
    for (int p = 0; p < passes; ++p) {
      for (int k = 0; k < 4; ++k) {
        auto* q = T.add(b, n[k], 0, 0, heads[p][k], n[k], step::kBias,
                        P + bo[k]);
        T.add_segment(q, w.h[p], h, P + Wo[k], n[k], h);
      }
    }
  } else if (phase == kDecode) {
    const long long row_tiles = (b + kTile - 1) / kTile;
    float* zs[2] = {w.zs, w.zsu};
    float* zc[2] = {w.zc, w.zcu};
    float* g_loc[2] = {w.g_loc, w.g_locu};
    for (int u = 0; u < (poe ? 2 : 1); ++u) {
      auto* q = T.add(b, d, 0, 0, g_loc[u], d, step::kDecLoss, P + D.bd,
                      a.x, d);
      T.add_segment(q, zs[u], s, P + D.Wds, d, s);
      T.add_segment(q, zc[u], cd, P + D.Wdc, d, cd);
      if (q != nullptr) {
        q->step_aux = x_step;
        q->olv = P + D.olv;
        q->colp = w.colp[u];
        q->colp_stride = row_tiles * d;
        q->ld_colp = d;
        q->scale = static_cast<float>(b);
      }
    }
  } else if (phase == kDecGrads) {
    auto* q = T.add(s, d, 1, 0, G + D.Wds, d);  // zs^T g_loc
    T.add_segment(q, w.zs, s, w.g_loc, d, b);
    if (poe) T.add_segment(q, w.zsu, s, w.g_locu, d, b);
    q = T.add(cd, d, 1, 0, G + D.Wdc, d);       // zc^T g_loc
    T.add_segment(q, w.zc, cd, w.g_loc, d, b);
    if (poe) T.add_segment(q, w.zcu, cd, w.g_locu, d, b);
    q = T.add(b, s, 0, 1, w.g_zs, s);           // g_loc Wds^T
    T.add_segment(q, w.g_loc, d, P + D.Wds, d, d);
    q = T.add(b, cd, 0, 1, w.g_zc, cd);         // g_loc Wdc^T
    T.add_segment(q, w.g_loc, d, P + D.Wdc, d, d);
    if (poe) {
      q = T.add(b, s, 0, 1, w.g_zsu, s);
      T.add_segment(q, w.g_locu, d, P + D.Wds, d, d);
      q = T.add(b, cd, 0, 1, w.g_zcu, cd);
      T.add_segment(q, w.g_locu, d, P + D.Wdc, d, d);
    }
  } else if (phase == kHiddenGrad) {
    // g_h = (sum_k g_head_k W_k^T) * (h > 0) [* mask]
    for (int p = 0; p < passes; ++p) {
      auto* q = T.add(b, h, 0, 1, w.g_h[p], h, step::kReluMask, nullptr,
                      w.h[p], h, mask[p], a.ld_mask);
      for (int k = 0; k < 4; ++k) {
        T.add_segment(q, g_heads[p][k], n[k], P + Wo[k], n[k], n[k]);
      }
      if (q != nullptr) q->step_mask = mask_step;
    }
  } else {  // kWeightGrads
    const bool two = passes == 2;
    auto* q = T.add(d, h, 1, 0, G + E.Wh, h);  // x^T g_h
    for (int p = 0; p < passes; ++p) {
      T.add_segment(q, a.x, d, w.g_h[p], h, b);
    }
    if (q != nullptr) q->step_A = x_step;
    for (int k = 0; k < 4; ++k) {
      q = T.add(h, n[k], 1, 0, G + Wo[k], n[k]);  // h^T g_head
      for (int p = 0; p < passes; ++p) {
        T.add_segment(q, w.h[p], h, g_heads[p][k], n[k], b);
      }
      C.add(g_heads[0][k], b, n[k], G + bo[k],
            two ? g_heads[1][k] : nullptr);
    }
    C.add(w.g_h[0], b, h, G + E.bh, two ? w.g_h[1] : nullptr);
  }
}

// Tasks of a phase beside its product tiles.
__host__ __device__ int extra_tasks(int phase, const StepParams& a,
                                    const step::ColSumTable& C) {
  if (phase == kLatentFwd) return (a.b + kWarps - 1) / kWarps;
  if (phase == kLatentBwd) {
    return (a.b * (a.cd + a.s()) + step::kGemmThreads - 1) /
           step::kGemmThreads;
  }
  if (phase == kDecGrads) return (a.d() + kCombineCols - 1) / kCombineCols;
  if (phase == kHiddenGrad) return 1;
  if (phase == kWeightGrads) return C.total_chunks;
  return 0;
}

constexpr int kStages = 3;  // slices of a k-group in flight or in use
using Smem = step::GemmSmem<kStages>;

struct Tables {
  step::Problem prob[kTableProblems];
  step::GemmTable tab[kPhases];
  step::ColSum cs[kColSums];
  step::ColSumTable cst;
  step::Layout layout;
  Work work;
  float sums[kParts + 2];
};

__device__ inline float kl_term(float mu, float lv) {
  return 1.0f - expf(lv) - mu * mu + lv;
}

// KL coefficients / b: the weight of the divergence's KL (jsd: two KLs
// against the dynamic prior, halved) and of the style KL; poe counts both
// KLs twice.
struct KlWeights {
  float cg, cs;
};

__device__ inline KlWeights kl_weights(const StepParams& a) {
  const float bf = static_cast<float>(a.b);
  const bool poe = a.method == kPoe;
  const float n_kl = a.method == kJsd ? 2.0f : (poe ? 0.5f : 1.0f);
  KlWeights k;
  k.cg = a.beta * a.beta_content / (n_kl * bf);
  k.cs = (poe ? 2.0f : 1.0f) * a.beta * a.beta_style * a.beta_style / bf;
  return k;
}

// One task of the forward latents: kWarps rows, a warp per row with the
// lanes over the latent columns. Row partials (each [B]): 0 KL sum of the
// subset posterior, 1 style KL sum, 2-5 the sums of cmu, clv, smu, slv,
// 6 jsd: the sum of the two KLs against the dynamic prior. Noise columns: ej
// at 0, es at cd, poe: uj at cd + s, us at 2 cd + s.
__device__ void latent_fwd_task(const StepParams& a, const Work& w, int step,
                                int task) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = task * kWarps + warp;
  if (i >= a.b) return;  // the same for every lane of the warp
  const int cd = a.cd, s = a.s(), method = a.method;
  const bool separate = a.passes == 2;
  const Heads& heads = w.heads[0];
  const Heads& uheads = w.heads[a.passes - 1];
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int k2 = a.b / 2;  // floor(b / 2), fused_methods.py:125-129
  const float* nz = a.noise + a.noise_step * step +
                    static_cast<long long>(i) * a.ld_noise;
  const bool in_a = i < k2;
  float p_m = 0.0f, p_s = 0.0f, p_j = 0.0f;
  float m_cmu = 0.0f, m_clv = 0.0f, m_smu = 0.0f, m_slv = 0.0f;
  for (int c = lane; c < cd; c += 32) {
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu = heads.cmu[j], clv = heads.clv[j];
    const float ev = expf(clv);
    const float t = 1.0f / (ev + kPoeEps);
    float jmu, jlv;
    if (method == kJointElbo) {
      jmu = cmu;
      jlv = -logf(t);
      p_m += kl_term(jmu, jlv);
    } else if (method == kMoe) {
      jmu = cmu;
      jlv = clv;
      p_m += kl_term(cmu, clv);
    } else if (method == kJsd) {
      jmu = in_a ? cmu : 0.0f;  // unit rows: mu = 0
      jlv = in_a ? clv : 0.0f;  // unit rows: logvar = 0
      p_m += kl_term(cmu, clv);
      const float S = t + tp;
      const float pm = cmu * t / S;
      const float ipv = S / 2.0f;  // exp(-plv)
      const float plv = -logf(ipv);
      const float dd = cmu - pm;
      p_j += (1.0f - ev * ipv - dd * dd * ipv + clv - plv) +
             (1.0f - ipv - pm * pm * ipv - plv);
    } else {  // poe
      const float ts = t + tp;
      jmu = cmu * t / ts;
      jlv = -logf(ts);
      p_m += kl_term(jmu, jlv);
      float mu_u = jmu, lv_u = jlv;
      if (separate) {
        const float cmuu = uheads.cmu[j];
        const float tu = 1.0f / (expf(uheads.clv[j]) + kPoeEps);
        mu_u = cmuu * tu / (tu + tp);
        lv_u = -logf(tu + tp);
      }
      w.zcu[j] = mu_u + nz[cd + s + c] * expf(0.5f * lv_u);
    }
    w.zc[j] = jmu + nz[c] * expf(0.5f * jlv);
    m_cmu += cmu;
    m_clv += clv;
  }
  for (int c = lane; c < s; c += 32) {
    const long long j = static_cast<long long>(i) * s + c;
    const float smu = heads.smu[j], slv = heads.slv[j];
    w.zs[j] = smu + nz[cd + c] * expf(0.5f * slv);
    if (method == kPoe) {
      w.zsu[j] = uheads.smu[j] +
                 nz[2 * cd + s + c] * expf(0.5f * uheads.slv[j]);
    }
    p_s += kl_term(smu, slv);
    m_smu += smu;
    m_slv += slv;
  }
  float parts[kParts] = {p_m, p_s, m_cmu, m_clv, m_smu, m_slv, p_j};
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const float total = step::warp_sum(parts[q]);
    if (lane == 0) w.part[q * a.b + i] = total;
  }
}

// One task of the latents' backward: the gradients of the head outputs of
// the first encoding (and, for poe with masks, of the unimodal one), a
// thread per element of [B, cd + s].
__device__ void latent_bwd_task(const StepParams& a, const Work& w, int step,
                                int task) {
  const int cd = a.cd, s = a.s(), method = a.method;
  const int width = cd + s;
  const int idx = task * step::kGemmThreads + threadIdx.x;
  if (idx >= a.b * width) return;
  const int i = idx / width;
  int c = idx % width;
  const bool separate = a.passes == 2;
  const Heads& heads = w.heads[0];
  const Heads& g_heads = w.g_heads[0];
  const Heads& uheads = w.heads[a.passes - 1];
  const Heads& g_uheads = w.g_heads[a.passes - 1];
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int k2 = a.b / 2;
  const KlWeights kw = kl_weights(a);
  const float cg = kw.cg, cs = kw.cs;
  const float* nz = a.noise + a.noise_step * step +
                    static_cast<long long>(i) * a.ld_noise;
  if (c < cd) {
    const float m_a = i < k2 ? 1.0f : 0.0f;
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu = heads.cmu[j], clv = heads.clv[j];
    const float ev = expf(clv);
    const float t = 1.0f / (ev + kPoeEps);
    const float ej = nz[c];
    const float g_zc = w.g_zc[j];
    float g_cmu, g_clv;
    if (method == kJointElbo) {
      const float lv = -logf(t);
      const float g_lv = g_zc * ej * 0.5f * expf(0.5f * lv) +
                         cg * 0.5f * (expf(lv) - 1.0f);
      g_cmu = g_zc + cg * cmu;
      g_clv = g_lv * ev * t;  // d(-log t) / d clv = exp(clv) t
    } else if (method == kMoe) {
      g_cmu = g_zc + cg * cmu;
      g_clv = g_zc * ej * 0.5f * expf(0.5f * clv) + cg * 0.5f * (ev - 1.0f);
    } else if (method == kJsd) {
      const float g_jlv = m_a * g_zc * ej * 0.5f * expf(0.5f * clv);
      const float S = t + tp;
      const float pm = cmu * t / S;
      const float ipv = S / 2.0f;
      const float dd = cmu - pm;
      const float e1 = ev * ipv;  // exp(clv - plv)
      // through the prior: d/d pm and d/d plv of the two KLs
      const float g_pm = -cg * ipv * (dd - pm);
      const float g_plv = -cg * 0.5f * ((e1 + dd * dd * ipv - 1.0f) +
                                        (ipv + pm * pm * ipv - 1.0f));
      const float g_t = g_pm * dd / S - g_plv / S;
      g_cmu = m_a * g_zc + cg * dd * ipv + g_pm * t / S;
      g_clv = g_jlv + cg * 0.5f * (e1 - 1.0f) - g_t * ev * t * t;
    } else {  // poe
      const float ts = t + tp;
      const float mu_s = cmu * t / ts, lv_s = -logf(ts);
      float g_mu_s = g_zc + cg * mu_s;
      float g_lv_s = g_zc * ej * 0.5f * expf(0.5f * lv_s) +
                     cg * 0.5f * (expf(lv_s) - 1.0f);
      const float g_zcu = w.g_zcu[j];
      const float uj = nz[cd + s + c];
      if (separate) {
        const float cmuu = uheads.cmu[j];
        const float evu = expf(uheads.clv[j]);
        const float tu = 1.0f / (evu + kPoeEps);
        const float ts_u = tu + tp;
        const float mu_u = cmuu * tu / ts_u, lv_u = -logf(ts_u);
        const float g_lv_u = g_zcu * uj * 0.5f * expf(0.5f * lv_u);
        const float g_tu = g_zcu * (cmuu - mu_u) / ts_u - g_lv_u / ts_u;
        g_uheads.cmu[j] = g_zcu * tu / ts_u;
        g_uheads.clv[j] = -g_tu * evu * tu * tu;
      } else {
        g_mu_s += g_zcu;
        g_lv_s += g_zcu * uj * 0.5f * expf(0.5f * lv_s);
      }
      const float g_t = g_mu_s * (cmu - mu_s) / ts - g_lv_s / ts;
      g_cmu = g_mu_s * t / ts;
      g_clv = -g_t * ev * t * t;
    }
    g_heads.cmu[j] = g_cmu;
    g_heads.clv[j] = g_clv;
  } else {
    c -= cd;
    const long long j = static_cast<long long>(i) * s + c;
    const float smu = heads.smu[j], slv = heads.slv[j];
    const float ss = expf(0.5f * slv);
    const float g_zs = w.g_zs[j];
    float g_smu = g_zs + cs * smu;
    float g_slv = g_zs * nz[cd + c] * 0.5f * ss +
                  cs * 0.5f * (expf(slv) - 1.0f);
    if (method == kPoe) {
      const float g_zsu = w.g_zsu[j];
      const float us = nz[2 * cd + s + c];
      if (separate) {
        g_uheads.smu[j] = g_zsu;
        g_uheads.slv[j] = g_zsu * us * 0.5f * expf(0.5f * uheads.slv[j]);
      } else {
        g_smu += g_zsu;
        g_slv += g_zsu * us * 0.5f * ss;
      }
    }
    g_heads.smu[j] = g_smu;
    g_heads.slv[j] = g_slv;
  }
}

// One combine task: kCombineCols decoder columns, a thread per column, the
// row tiles' partials added in row-tile order (for poe the first decode's,
// then the unimodal decode's: the gradients are the two passes' sums).
__device__ void combine_task(const StepParams& a, const step::Layout& L,
                             const Work& w, int task) {
  const int d = a.d();
  const int c = task * kCombineCols + threadIdx.x;
  if (c >= d) return;
  const step::DecLayout& D = L.dec[a.mod_idx];
  const int row_tiles = (a.b + kTile - 1) / kTile;
  const long long stride = static_cast<long long>(row_tiles) * d;
  float acc_g = 0.0f, acc_o = 0.0f;
  for (int u = 0; u < (a.method == kPoe ? 2 : 1); ++u) {
    float acc_n = 0.0f;
    for (int rt = 0; rt < row_tiles; ++rt) {
      const float* src = w.colp[u] + static_cast<long long>(rt) * d + c;
      acc_g += src[0];
      acc_o += src[stride];
      acc_n += src[2 * stride];
    }
    w.nll_col[u * d + c] = acc_n;
  }
  a.grads[D.bd + c] = acc_g;
  a.grads[D.olv + c] =
      a.learn_scale ? acc_o / static_cast<float>(a.b) : 0.0f;
}

// The step's 9 metrics (10 for poe), a warp per sum. Every thread of the
// block calls it.
__device__ void metrics_task(const StepParams& a, const Work& w, int step,
                             float* sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = a.d();
  const int n_sums = kParts + (a.method == kPoe ? 2 : 1);
  for (int q = warp; q < n_sums; q += kWarps) {
    const float* src = q < kParts ? w.part + static_cast<long long>(q) * a.b
                                  : w.nll_col + (q - kParts) * d;
    const int n = q < kParts ? a.b : d;
    float acc = 0.0f;
    for (int i = lane; i < n; i += 32) acc += src[i];
    acc = step::warp_sum(acc);
    if (lane == 0) sums[q] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float* metrics = a.metrics + static_cast<long long>(step) * a.n_metrics();
    const float b = static_cast<float>(a.b);
    const float nll = sums[kParts] / b;
    const float kld_m = -0.5f * sums[0] / b;
    const float kld_s = -0.5f * sums[1] / b;
    const float style = a.beta_style * a.beta_style * kld_s;
    float group_div = kld_m, loss;
    if (a.method == kPoe) {
      const float uni = sums[kParts + 1] / b;
      loss = uni + nll +
             a.beta * (2.0f * a.beta_content * kld_m + 2.0f * style);
      metrics[9] = uni;
    } else {
      if (a.method == kJsd) group_div = -0.5f * sums[6] / b / 2.0f;
      loss = nll + a.beta * (style + a.beta_content * group_div);
    }
    const float n_c = b * a.cd, n_s = b * a.s();
    const float head[9] = {loss,          group_div,     nll,
                           kld_m,         kld_s,         sums[2] / n_c,
                           sums[3] / n_c, sums[4] / n_s, sums[5] / n_s};
    for (int q = 0; q < 9; ++q) metrics[q] = head[q];
  }
  __syncthreads();
}

// The absent modality's blocks of the flat buffers: its encoder's and its
// decoder's tensors, [begin[r], end[r]) for r = 0, 1.
struct AbsentRanges {
  long long begin[2], end[2];
};

__device__ AbsentRanges absent_ranges(const StepParams& a,
                                      const step::Layout& L) {
  const int o = 1 - a.mod_idx;
  AbsentRanges r;
  r.begin[0] = L.enc[o].Wh;
  r.end[0] = o == 0 ? L.enc[1].Wh : L.dec[0].Wds;
  r.begin[1] = L.dec[o].Wds;
  r.end[1] = o == 0 ? L.dec[1].Wds : L.total;
  return r;
}

// The absent modality's gradients are exactly zero, elementwise over the
// grid.
__device__ void zero_absent(const StepParams& a, const step::Layout& L) {
  const AbsentRanges ranges = absent_ranges(a, L);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int r = 0; r < 2; ++r) {
    for (long long i = ranges.begin[r] + static_cast<long long>(blockIdx.x) *
                                             blockDim.x + threadIdx.x;
         i < ranges.end[r]; i += stride) {
      a.grads[i] = 0.0f;
    }
  }
}

// Grid barriers of one step: one after each phase (Adam has none of its
// own: it rides on the last phase), but the last of a launch.
__host__ __device__ constexpr int barriers_per_step(int adam) {
  return adam ? kPhases : kPhases - 1;
}

template <bool kBf16>
__global__ void __launch_bounds__(step::kGemmThreads)
presence_steps_kernel(const __grid_constant__ StepParams a) {
  cg::grid_group grid = cg::this_grid();
  // the product tiles' ring of stages is dynamic shared memory (above the
  // 48 KB a block may declare); the tables are static
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  __shared__ Tables tb;
  if (threadIdx.x == 0) {
    tb.layout = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
    tb.work = carve(a.work, a.method, a.passes, a.b, a.d(), a.h, a.cd, a.s());
    tb.cst.reset(tb.cs, kColSums);
  }
  __syncthreads();
  // one thread per phase builds that phase's table
  if (threadIdx.x % 32 == 0 && threadIdx.x / 32 < kPhases) {
    const int phase = threadIdx.x / 32;
    int first = 0;
    for (int q = 0; q < phase; ++q) first += phase_problems(q);
    tb.tab[phase].reset(tb.prob + first, phase_problems(phase));
    build_phase(phase, a, tb.layout, tb.work, tb.tab[phase], tb.cst);
    // scheme B: the forward products round both operands, autodiff's
    // backward products the one that is not the cotangent
    if (kBf16) tb.tab[phase].round_products(phase >= kDecGrads);
  }
  __syncthreads();
  const Work& w = tb.work;
  const long long n_params = tb.layout.total;

  step::AdamAt adam_at;
  adam_at.p = a.params;
  adam_at.mu = a.mu;
  adam_at.nu = a.nu;
  adam_at.g = a.grads;
  adam_at.hyper = a.hyper;
  for (int step = 0; step < a.n_steps; ++step) {
    step::stamp(a.phase_times, step * (kPhases + 1));
    adam_at.correction = adam::correction(
        static_cast<float>(a.count + step + 1), a.hyper);
    for (int phase = 0; phase < kPhases; ++phase) {
      const step::GemmTable& T = tb.tab[phase];
      const int tiles = T.total_tiles;
      const int tasks = tiles + extra_tasks(phase, a, tb.cst);
      // the last phase's gradients take their Adam update where they are
      // produced: every reader of the params in this step is done
      const step::AdamAt* adam =
          a.adam && phase == kWeightGrads ? &adam_at : nullptr;
      for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
        if (task < tiles) {
          int tile = task;
          const step::Problem& P = T.find(tile);
          step::gemm_tile<kStages, step::kNormal,
                          kBf16 ? step::kSchemeB : step::kSchemeF32>(
              P, tile, step, sm, adam);
        } else if (phase == kLatentFwd) {
          latent_fwd_task(a, w, step, task);
        } else if (phase == kLatentBwd) {
          latent_bwd_task(a, w, step, task);
        } else if (phase == kDecGrads) {
          combine_task(a, tb.layout, w, task - tiles);
        } else if (phase == kHiddenGrad) {
          metrics_task(a, w, step, tb.sums);
        } else {
          int chunk = task - tiles;
          const step::ColSum& S = tb.cst.find(chunk);
          step::colsum_chunk(S, chunk, sm.colred[0], adam);
        }
      }
      if (phase == kHidden) zero_absent(a, tb.layout);
      if (adam != nullptr) {
        // older phases' gradients take their update here: the present
        // decoder's, and the absent modality's zeros (its moments decay)
        const AbsentRanges absent = absent_ranges(a, tb.layout);
        const step::DecLayout& D = tb.layout.dec[a.mod_idx];
        const long long dec_end =
            a.mod_idx == 0 ? tb.layout.dec[1].Wds : n_params;
        const long long begin[3] = {absent.begin[0], absent.begin[1], D.Wds};
        const long long end[3] = {absent.end[0], absent.end[1], dec_end};
        for (int r = 0; r < 3; ++r) {
          adam::update_range(a.params, a.mu, a.nu, a.grads, begin[r], end[r],
                             a.hyper, adam_at.correction);
        }
      }
      if (phase + 1 < kPhases || step + 1 < a.n_steps) grid.sync();
      step::stamp(a.phase_times, step * (kPhases + 1) + phase + 1);
    }
  }
}

// The largest task count of any phase: more blocks than that only wait.
int max_phase_tasks(const StepParams& a) {
  const step::Layout L = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
  const Work w = carve(a.work, a.method, a.passes, a.b, a.d(), a.h, a.cd,
                       a.s());
  step::Problem prob[kTableProblems];
  step::ColSum cs[kColSums];
  step::ColSumTable C;
  C.reset(cs, kColSums);
  int most = 0;
  for (int phase = 0; phase < kPhases; ++phase) {
    step::GemmTable T;
    T.reset(prob, phase_problems(phase));
    build_phase(phase, a, L, w, T, C);
    if (T.overflow || C.overflow) return -1;
    const int tasks = T.total_tiles + extra_tasks(phase, a, C);
    if (tasks > most) most = tasks;
  }
  return most;
}

// The cooperative grid of a launch at these sizes on the current device.
int grid_blocks(const StepParams& a, int* blocks) {
  return step::cooperative_grid(
      a.bf16 ? &presence_steps_kernel<true> : &presence_steps_kernel<false>,
      static_cast<int>(sizeof(Smem)),
      {a.b, a.d1, a.d2, a.h, a.cd, a.s1, a.s2, a.method, a.passes,
       a.mod_idx, a.bf16},
      [&] { return max_phase_tasks(a); }, blocks);
}

int launch_steps(const StepParams& a, cudaStream_t stream) {
  if (a.mod_idx != 0 && a.mod_idx != 1) return cudaErrorInvalidValue;
  if (a.method < kJointElbo || a.method > kPoe) return cudaErrorInvalidValue;
  if ((a.mask1 != nullptr) != (a.mask0 != nullptr && a.method == kPoe)) {
    return cudaErrorInvalidValue;
  }
  if (a.b < 1 || a.n_steps < 1 || (!a.adam && a.n_steps != 1)) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int rc = grid_blocks(a, &blocks);
  if (rc != 0) return rc;
  StepParams params = a;
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(a.bf16 ? &presence_steps_kernel<true>
                                     : &presence_steps_kernel<false>),
      dim3(blocks),
      dim3(step::kGemmThreads), args, sizeof(Smem), stream));
}

StepParams sizes_only(int method, int passes, int mod_idx, int b, int d1,
                      int d2, int h, int cd, int s1, int s2, int bf16) {
  StepParams a = {};
  a.bf16 = bf16 != 0;
  a.n_steps = 1;
  a.method = method;
  a.passes = passes;
  a.mod_idx = mod_idx;
  a.b = b;
  a.d1 = d1;
  a.d2 = d2;
  a.h = h;
  a.cd = cd;
  a.s1 = s1;
  a.s2 = s2;
  return a;
}

}  // namespace

extern "C" {

long long presence_step_workspace_floats(int method, int has_masks, int b,
                                         int d, int h, int cd, int s) {
  const int passes = (method == kPoe && has_masks) ? 2 : 1;
  return carve(nullptr, method, passes, b, d, h, cd, s).total;
}

// Blocks of the cooperative grid at these sizes on the current device, of
// the float32 (bf16 = 0) or the bfloat16 instance (negative: minus a CUDA
// error code).
int presence_step_grid_blocks(int method, int has_masks, int mod_idx, int b,
                              int d1, int d2, int h, int cd, int s1, int s2,
                              int bf16) {
  const int passes = (method == kPoe && has_masks) ? 2 : 1;
  int blocks = 0;
  const int rc = grid_blocks(
      sizes_only(method, passes, mod_idx, b, d1, d2, h, cd, s1, s2, bf16),
      &blocks);
  return rc != 0 ? -rc : blocks;
}

// Grid barriers per step of a launch (adam: with the in-kernel update).
int presence_step_barriers(int adam) { return barriers_per_step(adam); }

// One step on `stream` for the present modality `mod_idx` (x [B, d_i],
// noise [B, w] with row stride ld_noise), in one cooperative launch; params
// are not touched. method: 0 joint_elbo, 1 moe, 2 jsd, 3 poe. mask0 is null
// (no dropout) or the encoder's keep mask [B, h] with row stride ld_mask;
// mask1 is poe's unimodal re-encoding's (null otherwise). grads and params
// are flat buffers of the split layout of both modalities; metrics holds 9
// floats (10 for poe). bf16 != 0 takes the bfloat16 branch (scheme B).
// Returns the first CUDA error (0 on success); synchronizes and allocates
// nothing.
int presence_step_launch(float* params, float* grads, float* metrics,
                         const float* x, const float* noise, int ld_noise,
                         const float* mask0, const float* mask1, int ld_mask,
                         float* work, int method, int mod_idx, int b, int d1,
                         int d2, int h, int cd, int s1, int s2, float beta,
                         float beta_style, float beta_content, int learn_scale,
                         void* stream_ptr, int bf16) {
  StepParams a = sizes_only(method, mask1 != nullptr ? 2 : 1, mod_idx, b, d1,
                            d2, h, cd, s1, s2, bf16);
  a.params = params;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x = x;
  a.noise = noise;
  a.ld_noise = ld_noise;
  a.mask0 = mask0;
  a.mask1 = mask1;
  a.ld_mask = ld_mask;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

// n steps in ONE cooperative launch on `stream`, each followed by Adam at
// t = count + step + 1 over params, mu and nu (all 28 tensors, in place):
// xs [n, b, d_i], noise [n, b, w] and masks [n, n_masks, b, h] (null for no
// dropout; n_masks 1, for poe 2) contiguous, metrics [n, 9 | 10], grads a
// scratch buffer of the params' size. The Adam scalars are float32 as in
// flat_adam_launch. phase_times is null, or takes n x 9 device timestamps in
// ns (tracing, as in mopoe_epoch_launch). bf16 != 0 takes the bfloat16
// branch. Returns the first CUDA error (0 on success); synchronizes and
// allocates nothing.
int presence_epoch_launch(float* params, float* mu, float* nu, float* grads,
                          float* metrics, const float* xs, const float* noise,
                          const float* masks, float* work, int n, int method,
                          int mod_idx, int b, int d1, int d2, int h, int cd,
                          int s1, int s2, float beta, float beta_style,
                          float beta_content, int learn_scale, long long count,
                          float lr, float b1, float b2, float one_minus_b1,
                          float one_minus_b2, float log_b1, float log_b2,
                          float eps, unsigned long long* phase_times,
                          void* stream_ptr, int bf16) {
  const bool two = masks != nullptr && method == kPoe;
  StepParams a = sizes_only(method, two ? 2 : 1, mod_idx, b, d1, d2, h, cd,
                            s1, s2, bf16);
  const int width = (cd + a.s()) * (method == kPoe ? 2 : 1);
  const long long mask_floats = static_cast<long long>(b) * h;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x = xs;
  a.noise = noise;
  a.ld_noise = width;
  a.mask0 = masks;
  a.mask1 = two ? masks + mask_floats : nullptr;
  a.ld_mask = h;
  a.x_step = static_cast<long long>(b) * a.d();
  a.noise_step = static_cast<long long>(b) * width;
  a.mask_step = masks == nullptr ? 0 : (two ? 2 : 1) * mask_floats;
  a.n_steps = n;
  a.adam = 1;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  a.count = count;
  a.hyper = adam::Hyper{lr, b1, b2, one_minus_b1, one_minus_b2, log_b1,
                        log_b2, eps};
  a.phase_times = phase_times;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

const char* presence_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
