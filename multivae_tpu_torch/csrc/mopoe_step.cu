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
// What bounds it: latency, not bytes or operations. At the flagship widths
// (d = 7/444, h = 256, cd = 20, s = 3/20) and B = 256 a step is ~195 MFLOP
// (a few microseconds of float32 FMA on 132 SMs) over ~0.67 MB of params and
// a few MB of activations, and every product is small (M, N, K <= 444): what
// costs time is each hand-over from one dependent phase to the next (a
// barrier and two or three trips to L2) and every serial loop inside a
// phase. The TPU kernel keeps params and both Adam moments resident in VMEM
// for a whole epoch. The design here:
// * ONE persistent, cooperative launch runs n steps (mopoe_epoch_launch; the
//   one-step entry points are the same kernel with n = 1 and Adam off). The
//   grid is what is co-resident (SM count x the occupancy query, capped at
//   the largest phase's task count or the SM count); the phases of a step follow each other
//   inside the kernel, separated by grid barriers, each phase's tasks strided
//   over the blocks. With Adam on, every gradient element of the last phase
//   takes its update at t = count + step + 1 right where it is produced and
//   the older phases' gradients beside it (adam_common.cuh, flat_adam's
//   arithmetic bit for bit); the next step reads the new params. Params,
//   moments and activations (~4 MB) stay in the 50 MB L2 across the steps of
//   a launch: the card's stand-in for the TPU's VMEM residency. Nothing the
//   kernel writes is read through the read-only path.
// * Eight phases, 8 grid barriers a step (the launch's last one left out: 7
//   for one step):
//   0. h_e = relu(x_e Wh_e + bh_e)                               (2 problems)
//   1. the 8 encoder heads (+ bias)                              (8)
//   2. the latents (PoE, 3-way mixture rows, reparameterization, row
//      partials of the KL sums and latent means), a warp per row
//   3. g_loc from r_e = x_e - (zs_e Wds_e + zc Wdc_e + bd_e), with
//      per-row-tile column partials in the epilogue              (2, 2 segs)
//   4. dWds, dWdc (A^T G), g_zs, g_zc (G W^T); the column
//      partials added in row-tile order: bd, olv grads, NLL sums (7)
//   5. the head-output grads, a thread per element
//   6. g_h (4 segs, ReLU mask); beside it the 17 metrics (a warp per
//      sum)                                                      (2)
//   7. head weight grads (h^T G), dWh_e = x_e^T g_h_e, the head and hidden
//      bias grads (rows over warps), and Adam                    (10)
//   The latents are phases of their own: as a prologue of the products that
//   need them they made every tile wait on several serial elements a thread;
//   a whole latent phase with its barrier is ~3 us on an H100 (a launch
//   given phase_times stamps each phase).
// * Products: step_common.cuh's gemm_tile (32 x 32 tiles, 4 x 4 outputs a
//   thread, in-block split-K in a fixed order, a ring of cp.async stages).
//   The kernel builds its own problem tables in shared memory from the
//   eight sizes (make_layout, carve), once per launch.
// No library product (no cuBLAS), no float atomics: every sum has one fixed
// order that depends on the tile alone, so two runs, two grids and the
// (0, b) row slice against the whole batch give the same bits. Two
// instantiations of the kernel: float32 (the products on the float32 FMA
// path, held to the plain version in full float32 at 1e-4; TF32 would keep
// three digits) and the bfloat16 branch (bf16 != 0, the TPU kernel's
// matmul_bf16, scheme A of multivae_tpu_torch/ops/bf16.py): every product,
// forward and backward, rounds both operands to bfloat16 and runs on the
// tensor cores (mma.sync m16n8k16, float32 accumulation) in the same tiles
// and the same order of sums. TMA buys nothing for 32-wide tiles of
// L2-resident operands; cp.async is the asynchronous copy that fits.

#include <cooperative_groups.h>

#include "adam_common.cuh"
#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using step::kPoeEps;
using step::kTile;
using step::kWarps;

constexpr int kParts = 13;  // per-row partial sums, see latent_fwd_task
constexpr int kMetrics = 17;
constexpr int kPhases = 8;
constexpr int kTableProblems = 31;  // the sum of phase_problems
constexpr int kColSums = 10;
constexpr int kCombineCols = step::kGemmThreads;  // columns per combine task
enum Phase {
  kHidden = 0, kHeads, kLatentFwd, kDecode, kDecGrads, kLatentBwd,
  kHiddenGrad, kWeightGrads
};

// Problems in each phase's table.
__host__ __device__ inline int phase_problems(int phase) {
  const int n[kPhases] = {2, 8, 0, 2, 7, 0, 2, 10};
  return n[phase];
}

struct Heads {
  float *cmu, *clv, *smu, *slv;  // [B, cd], [B, cd], [B, s], [B, s]
};

struct Work {
  float *h[2];
  Heads heads[2], g_heads[2];
  float *zc, *zs[2];
  float *g_loc[2];
  float *g_zs[2], *g_zc;
  float *g_h[2];
  float *colp[2];  // [3, row tiles, d_e]: the decoders' column partials
  float *part;     // [kParts, B]
  float *nll_col;  // [d1 + d2]
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
__host__ __device__ Work carve(float* base, int b, int d1, int d2, int h,
                               int cd, int s1, int s2) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 3) / 4 * 4;  // every buffer starts 16-byte aligned
    return p;
  };
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  const long long bl = b;
  const long long row_tiles = (b + kTile - 1) / kTile;
  for (int e = 0; e < 2; ++e) w.h[e] = take(bl * h);
  for (int e = 0; e < 2; ++e) {
    Heads* both[2] = {&w.heads[e], &w.g_heads[e]};
    for (Heads* H : both) {
      H->cmu = take(bl * cd);
      H->clv = take(bl * cd);
      H->smu = take(bl * s[e]);
      H->slv = take(bl * s[e]);
    }
  }
  w.zc = take(bl * cd);
  w.g_zc = take(bl * cd);
  for (int e = 0; e < 2; ++e) {
    w.zs[e] = take(bl * s[e]);
    w.g_zs[e] = take(bl * s[e]);
    w.g_loc[e] = take(bl * d[e]);
    w.g_h[e] = take(bl * h);
    w.colp[e] = take(step::kMaxColOut * row_tiles * d[e]);
  }
  w.part = take(static_cast<long long>(kParts) * b);
  w.nll_col = take(d1 + d2);
  w.total = off;
  return w;
}

// Everything one launch needs, by value (the kernel derives its pointers
// into params, grads and the workspace itself).
struct StepParams {
  float *params, *grads, *metrics;  // metrics [n_steps, 17]
  float *mu, *nu;                   // Adam's moments (adam != 0)
  float* work;
  const float *x1, *x2, *ej, *es1, *es2;  // step 0's
  long long x1_step, x2_step, noise_step; // floats from one step's to the next
  int ld_ej, ld_es1, ld_es2;
  int n_steps, adam, b, row_offset, b_total;
  int d1, d2, h, cd, s1, s2, learn_scale;
  int bf16;  // the bfloat16 branch (scheme A): the kernel<true> instance
  float beta, beta_style, beta_content;
  long long count;  // Adam updates taken before this launch
  adam::Hyper hyper;
  // tracing: null, or [n_steps, kPhases + 1] device timestamps in ns (block
  // 0's clock at the start of each step and after each phase's barrier)
  unsigned long long* phase_times;
};

// The problems of one phase (phase < kPhases) into T, and the last phase's
// column sums into C.
__host__ __device__ void build_phase(int phase, const StepParams& a,
                                     const step::Layout& L, const Work& w,
                                     step::GemmTable& T,
                                     step::ColSumTable& C) {
  const int b = a.b, h = a.h, cd = a.cd;
  const int d[2] = {a.d1, a.d2}, s[2] = {a.s1, a.s2};
  const float* x[2] = {a.x1, a.x2};
  const long long x_step[2] = {a.x1_step, a.x2_step};
  float* P = a.params;
  float* G = a.grads;
  if (phase == kLatentFwd || phase == kLatentBwd) return;  // no products
  if (phase == kHidden) {
    for (int e = 0; e < 2; ++e) {
      auto* p = T.add(b, h, 0, 0, w.h[e], h, step::kBiasRelu,
                      P + L.enc[e].bh);
      T.add_segment(p, x[e], d[e], P + L.enc[e].Wh, h, d[e]);
      if (p != nullptr) p->step_A = static_cast<int>(x_step[e]);
    }
    return;
  }
  if (phase == kDecode) {
    const long long row_tiles = (b + kTile - 1) / kTile;
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* p = T.add(b, d[e], 0, 0, w.g_loc[e], d[e], step::kDecLoss,
                      P + D.bd, x[e], d[e]);
      T.add_segment(p, w.zs[e], s[e], P + D.Wds, d[e], s[e]);
      T.add_segment(p, w.zc, cd, P + D.Wdc, d[e], cd);
      if (p != nullptr) {
        p->step_aux = static_cast<int>(x_step[e]);
        p->olv = P + D.olv;
        p->colp = w.colp[e];
        p->colp_stride = row_tiles * d[e];
        p->ld_colp = d[e];
        p->scale = static_cast<float>(a.b_total);
      }
    }
    return;
  }
  if (phase == kDecGrads) {
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* p = T.add(s[e], d[e], 1, 0, G + D.Wds, d[e]);  // zs^T g_loc
      T.add_segment(p, w.zs[e], s[e], w.g_loc[e], d[e], b);
      p = T.add(cd, d[e], 1, 0, G + D.Wdc, d[e]);           // zc^T g_loc
      T.add_segment(p, w.zc, cd, w.g_loc[e], d[e], b);
      p = T.add(b, s[e], 0, 1, w.g_zs[e], s[e]);            // g_loc Wds^T
      T.add_segment(p, w.g_loc[e], d[e], P + D.Wds, d[e], d[e]);
    }
    auto* p = T.add(b, cd, 0, 1, w.g_zc, cd);  // sum_e g_loc_e Wdc_e^T
    for (int e = 0; e < 2; ++e) {
      T.add_segment(p, w.g_loc[e], d[e], P + L.dec[e].Wdc, d[e], d[e]);
    }
    return;
  }
  // the three phases over the encoders' heads
  for (int e = 0; e < 2; ++e) {
    const step::EncLayout& E = L.enc[e];
    const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
    const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
    float* out[4] = {w.heads[e].cmu, w.heads[e].clv, w.heads[e].smu,
                     w.heads[e].slv};
    float* gh[4] = {w.g_heads[e].cmu, w.g_heads[e].clv, w.g_heads[e].smu,
                    w.g_heads[e].slv};
    const int n[4] = {cd, cd, s[e], s[e]};
    if (phase == kHeads) {
      for (int k = 0; k < 4; ++k) {
        auto* p = T.add(b, n[k], 0, 0, out[k], n[k], step::kBias, P + bo[k]);
        T.add_segment(p, w.h[e], h, P + Wo[k], n[k], h);
      }
    } else if (phase == kHiddenGrad) {
      // g_h = (sum_k g_head_k W_k^T) * (h > 0)
      auto* p = T.add(b, h, 0, 1, w.g_h[e], h, step::kReluMask, nullptr,
                      w.h[e], h);
      for (int k = 0; k < 4; ++k) {
        T.add_segment(p, gh[k], n[k], P + Wo[k], n[k], n[k]);
      }
    } else {  // kWeightGrads
      auto* p = T.add(d[e], h, 1, 0, G + E.Wh, h);  // x^T g_h
      T.add_segment(p, x[e], d[e], w.g_h[e], h, b);
      if (p != nullptr) p->step_A = static_cast<int>(x_step[e]);
      for (int k = 0; k < 4; ++k) {
        p = T.add(h, n[k], 1, 0, G + Wo[k], n[k]);  // h^T g_head
        T.add_segment(p, w.h[e], h, gh[k], n[k], b);
        C.add(gh[k], b, n[k], G + bo[k]);
      }
      C.add(w.g_h[e], b, h, G + E.bh);
    }
  }
}

// Tasks of a phase beside its product tiles.
__host__ __device__ int extra_tasks(int phase, const StepParams& a,
                                    const step::ColSumTable& C) {
  if (phase == kLatentFwd) return (a.b + kWarps - 1) / kWarps;
  if (phase == kLatentBwd) {
    return (a.b * (a.cd + a.s1 + a.s2) + step::kGemmThreads - 1) /
           step::kGemmThreads;
  }
  if (phase == kDecGrads) return (a.d1 + a.d2 + kCombineCols - 1) / kCombineCols;
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

// One task of the forward latents: kWarps rows, a warp per row with the
// lanes over the latent columns (every load of a lane's columns starts
// before the first use). Row partials (each [B]): 0-2 KL sums of the
// subsets a, b, c; 3-4 style KL sums; 5-12 the sums of cmu1, clv1, smu1,
// slv1, cmu2, clv2, smu2, slv2 (for the latent means). A KL sum is
// sum(1 - exp(lv) - mu^2 + lv); the metric is -0.5 sum / b_total.
__device__ void latent_fwd_task(const StepParams& a, const Work& w, int step,
                                int task) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = task * kWarps + warp;
  if (i >= a.b) return;  // the same for every lane of the warp
  const int cd = a.cd, s1 = a.s1, s2 = a.s2;
  const float tp = 1.0f / (1.0f + kPoeEps);
  const int k1 = a.b_total / 3;  // floor(b_total / 3), fused_step.py:251-255
  const int k2 = 2 * (a.b_total / 3);
  const long long noise_off = a.noise_step * step;
  const float* ej = a.ej + noise_off + static_cast<long long>(i) * a.ld_ej;
  const float* es1 = a.es1 + noise_off + static_cast<long long>(i) * a.ld_es1;
  const float* es2 = a.es2 + noise_off + static_cast<long long>(i) * a.ld_es2;
  const int gi = a.row_offset + i;  // the row's index in the whole batch
  const bool in_a = gi < k1, in_b = gi >= k1 && gi < k2;
  float parts[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) parts[q] = 0.0f;
  const int s_max = s1 > s2 ? s1 : s2;
  const int widest = cd > s_max ? cd : s_max;
  for (int c = lane; c < widest; c += 32) {
    const bool on_c = c < cd, on_1 = c < s1, on_2 = c < s2;
    const long long jc = static_cast<long long>(i) * cd + c;
    const long long j1 = static_cast<long long>(i) * s1 + c;
    const long long j2 = static_cast<long long>(i) * s2 + c;
    const float cmu1 = on_c ? w.heads[0].cmu[jc] : 0.0f;
    const float clv1 = on_c ? w.heads[0].clv[jc] : 0.0f;
    const float cmu2 = on_c ? w.heads[1].cmu[jc] : 0.0f;
    const float clv2 = on_c ? w.heads[1].clv[jc] : 0.0f;
    const float nj = on_c ? ej[c] : 0.0f;
    const float smu1 = on_1 ? w.heads[0].smu[j1] : 0.0f;
    const float slv1 = on_1 ? w.heads[0].slv[j1] : 0.0f;
    const float n1 = on_1 ? es1[c] : 0.0f;
    const float smu2 = on_2 ? w.heads[1].smu[j2] : 0.0f;
    const float slv2 = on_2 ? w.heads[1].slv[j2] : 0.0f;
    const float n2 = on_2 ? es2[c] : 0.0f;
    if (on_c) {
      const float t1 = 1.0f / (expf(clv1) + kPoeEps);
      const float t2 = 1.0f / (expf(clv2) + kPoeEps);
      const float lv_a = -logf(t1), lv_b = -logf(t2);
      const float ts = t1 + t2 + tp;
      const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
      const float lv_c = -logf(ts);
      const float jmu = in_a ? cmu1 : (in_b ? cmu2 : mu_c);
      const float jlv = in_a ? lv_a : (in_b ? lv_b : lv_c);
      w.zc[jc] = jmu + nj * expf(0.5f * jlv);
      parts[0] += 1.0f - expf(lv_a) - cmu1 * cmu1 + lv_a;
      parts[1] += 1.0f - expf(lv_b) - cmu2 * cmu2 + lv_b;
      parts[2] += 1.0f - expf(lv_c) - mu_c * mu_c + lv_c;
      parts[5] += cmu1;
      parts[6] += clv1;
      parts[9] += cmu2;
      parts[10] += clv2;
    }
    if (on_1) {
      w.zs[0][j1] = smu1 + n1 * expf(0.5f * slv1);
      parts[3] += 1.0f - expf(slv1) - smu1 * smu1 + slv1;
      parts[7] += smu1;
      parts[8] += slv1;
    }
    if (on_2) {
      w.zs[1][j2] = smu2 + n2 * expf(0.5f * slv2);
      parts[4] += 1.0f - expf(slv2) - smu2 * smu2 + slv2;
      parts[11] += smu2;
      parts[12] += slv2;
    }
  }
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    const float total = step::warp_sum(parts[q]);
    if (lane == 0) w.part[q * a.b + i] = total;
  }
}

// One task of the latents' backward: the gradients of the 8 head outputs,
// a thread per element of [B, cd + s1 + s2] (fused_step.py:452-474).
__device__ void latent_bwd_task(const StepParams& a, const Work& w, int step,
                                int task) {
  const int cd = a.cd;
  const int width = cd + a.s1 + a.s2;
  const int idx = task * step::kGemmThreads + threadIdx.x;
  if (idx >= a.b * width) return;
  const int i = idx / width;
  int c = idx % width;
  const float bt = static_cast<float>(a.b_total);
  if (c < cd) {
    const float tp = 1.0f / (1.0f + kPoeEps);
    const int k1 = a.b_total / 3, k2 = 2 * (a.b_total / 3);
    // beta beta_content / (3 b_total)
    const float cg = a.beta * a.beta_content / (3.0f * bt);
    const int gi = a.row_offset + i;
    const float m_a = gi < k1 ? 1.0f : 0.0f;
    const float m_b = (gi >= k1 && gi < k2) ? 1.0f : 0.0f;
    const float m_c = gi >= k2 ? 1.0f : 0.0f;
    const long long j = static_cast<long long>(i) * cd + c;
    const float cmu1 = w.heads[0].cmu[j], clv1 = w.heads[0].clv[j];
    const float cmu2 = w.heads[1].cmu[j], clv2 = w.heads[1].clv[j];
    const float ej = a.ej[a.noise_step * step +
                          static_cast<long long>(i) * a.ld_ej + c];
    const float g_jmu = w.g_zc[j];
    const float ev1 = expf(clv1), ev2 = expf(clv2);
    const float t1 = 1.0f / (ev1 + kPoeEps);
    const float t2 = 1.0f / (ev2 + kPoeEps);
    const float lv_a = -logf(t1), lv_b = -logf(t2);
    const float ts = t1 + t2 + tp;
    const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
    const float lv_c = -logf(ts);
    const float jlv = m_a * lv_a + m_b * lv_b + m_c * lv_c;
    const float sj = expf(0.5f * jlv);
    const float g_jlv = g_jmu * ej * 0.5f * sj;
    const float g_mu_a = m_a * g_jmu + cg * cmu1;
    const float g_mu_b = m_b * g_jmu + cg * cmu2;
    const float g_mu_c = m_c * g_jmu + cg * mu_c;
    const float g_lv_a = m_a * g_jlv + cg * 0.5f * (expf(lv_a) - 1.0f);
    const float g_lv_b = m_b * g_jlv + cg * 0.5f * (expf(lv_b) - 1.0f);
    const float g_lv_c = m_c * g_jlv + cg * 0.5f * (expf(lv_c) - 1.0f);
    w.g_heads[0].cmu[j] = g_mu_a + g_mu_c * (t1 / ts);
    w.g_heads[1].cmu[j] = g_mu_b + g_mu_c * (t2 / ts);
    const float g_t1 = g_mu_c * (cmu1 - mu_c) / ts - g_lv_c / ts;
    const float g_t2 = g_mu_c * (cmu2 - mu_c) / ts - g_lv_c / ts;
    w.g_heads[0].clv[j] = g_lv_a * ev1 * t1 + g_t1 * (-ev1 * t1 * t1);
    w.g_heads[1].clv[j] = g_lv_b * ev2 * t2 + g_t2 * (-ev2 * t2 * t2);
  } else {
    c -= cd;
    const int e = c < a.s1 ? 0 : 1;
    if (e == 1) c -= a.s1;
    const int s = e == 0 ? a.s1 : a.s2;
    const float* es = (e == 0 ? a.es1 : a.es2) + a.noise_step * step;
    const int ld = e == 0 ? a.ld_es1 : a.ld_es2;
    const float cs = a.beta * a.beta_style * a.beta_style / bt;
    const long long j = static_cast<long long>(i) * s + c;
    const float smu = w.heads[e].smu[j], slv = w.heads[e].slv[j];
    const float en = es[static_cast<long long>(i) * ld + c];
    const float g_zs = w.g_zs[e][j];
    w.g_heads[e].smu[j] = g_zs + cs * smu;
    w.g_heads[e].slv[j] = g_zs * en * 0.5f * expf(0.5f * slv) +
                          cs * 0.5f * (expf(slv) - 1.0f);
  }
}

// One combine task: kCombineCols decoder columns, a thread per column, the
// row tiles' partials added in row-tile order.
__device__ void combine_task(const StepParams& a, const step::Layout& L,
                             const Work& w, int task) {
  const int c = task * kCombineCols + threadIdx.x;
  if (c >= a.d1 + a.d2) return;
  const int e = c < a.d1 ? 0 : 1;
  const int d = e == 0 ? a.d1 : a.d2;
  const int cc = e == 0 ? c : c - a.d1;
  const int row_tiles = (a.b + kTile - 1) / kTile;
  const long long stride = static_cast<long long>(row_tiles) * d;
  float acc[step::kMaxColOut] = {0.0f, 0.0f, 0.0f};
  for (int rt = 0; rt < row_tiles; ++rt) {
#pragma unroll
    for (int q = 0; q < step::kMaxColOut; ++q) {
      acc[q] += w.colp[e][q * stride + static_cast<long long>(rt) * d + cc];
    }
  }
  a.grads[L.dec[e].bd + cc] = acc[0];
  a.grads[L.dec[e].olv + cc] =
      a.learn_scale ? acc[1] / static_cast<float>(a.b_total) : 0.0f;
  w.nll_col[c] = acc[2];
}

// The step's 17 metrics, a warp per sum (lanes strided over the rows or
// columns, then a fixed butterfly). Sums over the local rows: those of the
// loss divided by b_total (partial sums of the whole batch's), the latent
// means by the local element count. Every thread of the block calls it.
__device__ void metrics_task(const StepParams& a, const Work& w, int step,
                             float* sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int q = warp; q < kParts + 2; q += kWarps) {
    const float* src = q < kParts ? w.part + static_cast<long long>(q) * a.b
                                  : w.nll_col + (q == kParts ? 0 : a.d1);
    const int n = q < kParts ? a.b : (q == kParts ? a.d1 : a.d2);
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
    const float group_div = (kld_a + kld_b + kld_c) / 3.0f;
    const float kld_style = kld_s1 + kld_s2;
    const float loss =
        nll1 + nll2 + a.beta * (a.beta_style * a.beta_style * kld_style +
                                a.beta_content * group_div);
    const float bl = static_cast<float>(a.b);
    const float n_c = bl * a.cd, n_s1 = bl * a.s1, n_s2 = bl * a.s2;
    const float out[kMetrics] = {loss,  group_div, nll1, nll2, kld_a, kld_b,
                                 kld_c, kld_s1,    kld_s2,
                                 sums[5] / n_c,  sums[6] / n_c,
                                 sums[7] / n_s1, sums[8] / n_s1,
                                 sums[9] / n_c,  sums[10] / n_c,
                                 sums[11] / n_s2, sums[12] / n_s2};
    float* metrics = a.metrics + static_cast<long long>(step) * kMetrics;
    for (int q = 0; q < kMetrics; ++q) metrics[q] = out[q];
  }
  __syncthreads();
}

// Grid barriers of one step: one after each phase (Adam has none of its
// own: it rides on the last phase), but the last of a launch.
__host__ __device__ constexpr int barriers_per_step(int adam) {
  return adam ? kPhases : kPhases - 1;
}

template <bool kBf16>
__global__ void __launch_bounds__(step::kGemmThreads)
mopoe_steps_kernel(const __grid_constant__ StepParams a) {
  cg::grid_group grid = cg::this_grid();
  // the product tiles' ring of stages is dynamic shared memory (above the
  // 48 KB a block may declare); the tables are static
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  __shared__ Tables tb;
  if (threadIdx.x == 0) {
    tb.layout = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
    tb.work = carve(a.work, a.b, a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
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
    if (kBf16) tb.tab[phase].round_products(false);  // scheme A
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
                          kBf16 ? step::kSchemeA : step::kSchemeF32>(
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
      if (adam != nullptr) {
        // the decoders' gradients are older phases': their update here
        adam::update_range(a.params, a.mu, a.nu, a.grads,
                           tb.layout.dec[0].Wds, n_params, a.hyper,
                           adam_at.correction);
      }
      if (phase + 1 < kPhases || step + 1 < a.n_steps) grid.sync();
      step::stamp(a.phase_times, step * (kPhases + 1) + phase + 1);
    }
  }
}

// The largest task count of any phase: more blocks than that only wait.
int max_phase_tasks(const StepParams& a) {
  const step::Layout L = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
  const Work w = carve(a.work, a.b, a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
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
      a.bf16 ? &mopoe_steps_kernel<true> : &mopoe_steps_kernel<false>,
      static_cast<int>(sizeof(Smem)),
      {a.b, a.d1, a.d2, a.h, a.cd, a.s1, a.s2, 0, 0, 0, a.bf16},
      [&] { return max_phase_tasks(a); }, blocks);
}

int launch_steps(const StepParams& a, cudaStream_t stream) {
  if (a.b < 1 || a.n_steps < 1 || a.row_offset < 0 ||
      a.b_total < a.row_offset + a.b || (!a.adam && a.n_steps != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int rc = grid_blocks(a, &blocks);
  if (rc != 0) return rc;
  StepParams params = a;
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(a.bf16 ? &mopoe_steps_kernel<true>
                                     : &mopoe_steps_kernel<false>),
      dim3(blocks),
      dim3(step::kGemmThreads), args, sizeof(Smem), stream));
}

StepParams sizes_only(int b, int d1, int d2, int h, int cd, int s1, int s2,
                      int bf16) {
  StepParams a = {};
  a.bf16 = bf16 != 0;
  a.n_steps = 1;
  a.b = a.b_total = b;
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

long long mopoe_step_param_floats(int d1, int d2, int h, int cd, int s1,
                                  int s2) {
  return step::make_layout(d1, d2, h, cd, s1, s2).total;
}

long long mopoe_step_workspace_floats(int b, int d1, int d2, int h, int cd,
                                      int s1, int s2) {
  return carve(nullptr, b, d1, d2, h, cd, s1, s2).total;
}

// Blocks of the cooperative grid at these sizes on the current device, of
// the float32 (bf16 = 0) or the bfloat16 instance (negative: minus a CUDA
// error code).
int mopoe_step_grid_blocks(int b, int d1, int d2, int h, int cd, int s1,
                           int s2, int bf16) {
  int blocks = 0;
  const int rc =
      grid_blocks(sizes_only(b, d1, d2, h, cd, s1, s2, bf16), &blocks);
  return rc != 0 ? -rc : blocks;
}

// Grid barriers per step of a launch (adam: with the in-kernel update).
int mopoe_step_barriers(int adam) { return barriers_per_step(adam); }

// One step on `stream` over rows [row_offset, row_offset + b) of a batch of
// b_total rows: grads (flat, split layout) and metrics[17] from the flat
// params, as partial sums of the whole batch's (see the header); params are
// not touched. bf16 != 0 takes the bfloat16 branch (scheme A). One
// cooperative launch. Returns the first CUDA error (0 on success).
// Synchronizes nothing and allocates nothing: `work` holds
// mopoe_step_workspace_floats(b, ...) floats.
int mopoe_step_slice_launch(float* params, float* grads, float* metrics,
                            const float* x1, const float* x2, const float* ej,
                            int ld_ej, const float* es1, int ld_es1,
                            const float* es2, int ld_es2, float* work, int b,
                            int row_offset, int b_total, int d1, int d2, int h,
                            int cd, int s1, int s2, float beta,
                            float beta_style, float beta_content,
                            int learn_scale, void* stream_ptr, int bf16) {
  StepParams a = sizes_only(b, d1, d2, h, cd, s1, s2, bf16);
  a.params = params;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x1 = x1;
  a.x2 = x2;
  a.ej = ej;
  a.es1 = es1;
  a.es2 = es2;
  a.ld_ej = ld_ej;
  a.ld_es1 = ld_es1;
  a.ld_es2 = ld_es2;
  a.row_offset = row_offset;
  a.b_total = b_total;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

// The unsharded step: the slice that is the whole batch.
int mopoe_step_launch(float* params, float* grads, float* metrics,
                      const float* x1, const float* x2, const float* ej,
                      int ld_ej, const float* es1, int ld_es1, const float* es2,
                      int ld_es2, float* work, int b, int d1, int d2, int h,
                      int cd, int s1, int s2, float beta, float beta_style,
                      float beta_content, int learn_scale, void* stream_ptr,
                      int bf16) {
  return mopoe_step_slice_launch(params, grads, metrics, x1, x2, ej, ld_ej, es1,
                                 ld_es1, es2, ld_es2, work, b, 0, b, d1, d2, h,
                                 cd, s1, s2, beta, beta_style, beta_content,
                                 learn_scale, stream_ptr, bf16);
}

// n steps in ONE cooperative launch on `stream`, each followed by Adam at
// t = count + step + 1 over params, mu and nu (flat, split layout, updated
// in place): x1s [n, b, d1], x2s [n, b, d2] and noise [n, b, cd + s1 + s2]
// (columns cd | s1 | s2) contiguous, metrics [n, 17], grads a scratch buffer
// of the params' size (it ends as the last step's gradient). The Adam
// scalars are float32 as in flat_adam_launch. phase_times is null, or takes
// n x 9 device timestamps in ns (tracing: the start of each step and the
// end of each of its 8 phases, by block 0's clock). bf16 != 0 takes the
// bfloat16 branch. Returns the first CUDA error (0 on success);
// synchronizes and allocates nothing.
int mopoe_epoch_launch(float* params, float* mu, float* nu, float* grads,
                       float* metrics, const float* x1s, const float* x2s,
                       const float* noise, float* work, int n, int b, int d1,
                       int d2, int h, int cd, int s1, int s2, float beta,
                       float beta_style, float beta_content, int learn_scale,
                       long long count, float lr, float b1, float b2,
                       float one_minus_b1, float one_minus_b2, float log_b1,
                       float log_b2, float eps, unsigned long long* phase_times,
                       void* stream_ptr, int bf16) {
  StepParams a = sizes_only(b, d1, d2, h, cd, s1, s2, bf16);
  a.phase_times = phase_times;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  const int width = cd + s1 + s2;
  a.x1 = x1s;
  a.x2 = x2s;
  a.ej = noise;
  a.es1 = noise + cd;
  a.es2 = noise + cd + s1;
  a.ld_ej = a.ld_es1 = a.ld_es2 = width;
  a.x1_step = static_cast<long long>(b) * d1;
  a.x2_step = static_cast<long long>(b) * d2;
  a.noise_step = static_cast<long long>(b) * width;
  a.n_steps = n;
  a.adam = 1;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  a.count = count;
  a.hyper = adam::Hyper{lr, b1, b2, one_minus_b1, one_minus_b2, log_b1,
                        log_b2, eps};
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

const char* mopoe_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
