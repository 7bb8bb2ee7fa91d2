// One train step of a complete batch for any of the four methods
// (joint_elbo, moe, jsd, poe), with optional streamed dropout masks, forward
// and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_methods.py::
// _method_epoch_kernel: method_loss_split (fused_methods.py:142-338) under
// jax.value_and_grad, and that kernel's epoch contract (params and both Adam
// moments resident over a grid of steps, Adam inside). The TPU kernel gets
// its backward from in-kernel autodiff; CUDA has none, so each method's
// backward is derived by hand here (and pinned to jax.grad through the plain
// version, multivae_tpu_torch/ops/fused_methods.py::
// method_fwd_bwd_reference).
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
// What bounds it: latency, as for the MoPoE step (mopoe_step.cu): every
// product is small (M, N, K <= 444; ~0.2 GFLOP a step, poe with masks ~0.4)
// over ~2 MB, so what costs time is each hand-over from one dependent phase
// to the next and every serial loop inside a phase. The design is
// mopoe_step.cu's and presence_step.cu's, of which this kernel is the
// union: ONE persistent, cooperative launch runs n steps with Adam inside
// (method_epoch_launch; the one-step entry points are the same kernel with
// n = 1 and Adam off), grid = what is co-resident, capped at the largest
// phase's task count or the SM count. With Adam on, every gradient element
// of the last phase takes its update at t = count + step + 1 where it is
// produced and the decoders' (older phases') beside them (adam_common.cuh,
// flat_adam's arithmetic bit for bit); the next step reads the new params.
// Eight phases, 8 grid barriers a step (the launch's last one left out: 7
// for one step), each phase's tasks strided over the blocks:
//   0. hidden layer of every encoding: relu(x Wh + bh) [* mask]  (2 | 4)
//   1. the four heads of every encoding (+ bias)                  (8 | 16)
//   2. the latents, a warp per row (latent_common.cuh)
//   3. g_loc of both decoders (and of poe's unimodal decodes) with
//      per-row-tile column partials in the epilogue (kDecLoss)    (2 | 4)
//   4. dWds, dWdc (A^T G, both decodes in one sum), g_zs, g_zc (G W^T); the
//      column partials added in row-tile order, first decode then unimodal:
//      bd, olv grads, NLL column sums                             (7 | 11)
//   5. the head-output grads, a thread per element
//   6. g_h of every encoding (4 segments, ReLU and keep mask); beside it
//      the metrics, a warp per sum                                (2 | 4)
//   7. head and hidden weight grads (both encodings in one sum), head and
//      hidden bias grads (rows over warps), and Adam             (10)
// poe with masks has the two-wave phases: 4 hidden problems of 256 x 256
// (256 tiles on 132 blocks) and 16 heads problems.
// Products: step_common.cuh's gemm_tile (32 x 32 tiles, in-block split-K in
// a fixed order), float32 FMA in the float32 instance. The bfloat16 branch
// (bf16 != 0, the TPU kernel's matmul_bf16 under in-kernel autodiff, scheme
// B of multivae_tpu_torch/ops/bf16.py) is a second instance: the forward
// products (phases 0, 1, 3) round both operands and run on the tensor cores;
// the backward products (phases 4, 6, 7) multiply the float32 cotangent by
// the other operand rounded to bfloat16 on the FMA path and round each
// product's sum to bfloat16 before a problem's segments (the four heads,
// the two decoders, poe's two passes) are added. No library product, no
// float atomics, no sum whose order depends on gridDim: two runs and two
// grids give the same bits.

#include <cooperative_groups.h>

#include "adam_common.cuh"
#include "latent_common.cuh"
#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace latent;
using step::kTile;
using step::kWarps;

constexpr int kPhases = 8;
constexpr int kTableProblems = 49;  // the sum of phase_problems
constexpr int kColSums = 10;
constexpr int kCombineCols = step::kGemmThreads;  // columns per combine task
enum Phase {
  kHidden = 0, kHeads, kLatentFwd, kDecode, kDecGrads, kLatentBwd,
  kHiddenGrad, kWeightGrads
};

// Problems in each phase's table (poe with masks fills them).
__host__ __device__ inline int phase_problems(int phase) {
  const int n[kPhases] = {4, 16, 0, 4, 11, 0, 4, 10};
  return n[phase];
}

struct Work {
  // [pass][encoder]; pass 1 exists for poe with masks (the unimodal
  // re-encoding)
  float* h[2][2];
  float* g_h[2][2];
  Heads heads[2][2], g_heads[2][2];
  float *zc, *g_zc;
  float *zs[2], *g_zs[2], *g_loc[2];
  // poe's unimodal decode
  float *zcu[2], *g_zcu[2], *zsu[2], *g_zsu[2], *g_locu[2];
  float* colp[2][2];  // [decode][decoder]: [3, row tiles, d_e] partials
  float* part;        // [kParts, B]
  float* nll_col;     // [2, d1 + d2]: first decode, unimodal decode
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
__host__ __device__ Work carve(float* base, int method, int passes, int b,
                               int d1, int d2, int h, int cd, int s1,
                               int s2) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 3) / 4 * 4;  // every buffer starts 16-byte aligned
    return p;
  };
  const long long bl = b;
  const long long row_tiles = (b + kTile - 1) / kTile;
  const int d[2] = {d1, d2}, s[2] = {s1, s2};
  for (int p = 0; p < 2; ++p) {
    for (int e = 0; e < 2; ++e) {
      const long long on = p < passes ? 1 : 0;
      w.h[p][e] = take(on * bl * h);
      w.g_h[p][e] = take(on * bl * h);
      Heads* both[2] = {&w.heads[p][e], &w.g_heads[p][e]};
      for (Heads* H : both) {
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
    w.g_loc[e] = take(bl * d[e]);
    w.colp[0][e] = take(step::kMaxColOut * row_tiles * d[e]);
    w.zcu[e] = take(uni * bl * cd);
    w.g_zcu[e] = take(uni * bl * cd);
    w.zsu[e] = take(uni * bl * s[e]);
    w.g_zsu[e] = take(uni * bl * s[e]);
    w.g_locu[e] = take(uni * bl * d[e]);
    w.colp[1][e] = take(uni * step::kMaxColOut * row_tiles * d[e]);
  }
  w.part = take(static_cast<long long>(kParts) * bl);
  w.nll_col = take(2LL * (d1 + d2));
  w.total = off;
  return w;
}

// Everything one launch needs, by value (the kernel derives its pointers
// into params, grads and the workspace itself).
struct StepParams {
  float *params, *grads, *metrics;  // metrics [n_steps, 17 | 19]
  float *mu, *nu;                   // Adam's moments (adam != 0)
  float* work;
  const float *x1, *x2, *noise;     // step 0's
  const float* mask[4];             // step 0's keep masks, or all null
  // floats from one step's x1, x2, noise and masks to the next's
  long long x1_step, x2_step, noise_step, mask_step;
  int ld_noise, ld_mask;
  int n_steps, adam, method, passes, b, row_offset, b_total;
  int d1, d2, h, cd, s1, s2, learn_scale;
  int bf16;  // the bfloat16 branch (scheme B): the kernel<true> instance
  float beta, beta_style, beta_content;
  long long count;  // Adam updates taken before this launch
  adam::Hyper hyper;
  // tracing: null, or [n_steps, kPhases + 1] device timestamps in ns (block
  // 0's clock at the start of each step and after each phase's barrier)
  unsigned long long* phase_times;
};

// The problems of one phase into T, and the last phase's column sums into C.
__host__ __device__ void build_phase(int phase, const StepParams& a,
                                     const step::Layout& L, const Work& w,
                                     step::GemmTable& T,
                                     step::ColSumTable& C) {
  const int b = a.b, h = a.h, cd = a.cd;
  const int d[2] = {a.d1, a.d2}, s[2] = {a.s1, a.s2};
  const float* x[2] = {a.x1, a.x2};
  const int x_step[2] = {static_cast<int>(a.x1_step),
                         static_cast<int>(a.x2_step)};
  const int mask_step = static_cast<int>(a.mask_step);
  const int passes = a.passes;
  const bool poe = a.method == kPoe;
  float* P = a.params;
  float* G = a.grads;
  if (phase == kLatentFwd || phase == kLatentBwd) return;  // no products
  if (phase == kHidden) {
    for (int p = 0; p < passes; ++p) {
      for (int e = 0; e < 2; ++e) {
        auto* q = T.add(b, h, 0, 0, w.h[p][e], h, step::kBiasRelu,
                        P + L.enc[e].bh, nullptr, 0, a.mask[2 * p + e],
                        a.ld_mask);
        T.add_segment(q, x[e], d[e], P + L.enc[e].Wh, h, d[e]);
        if (q != nullptr) {
          q->step_A = x_step[e];
          q->step_mask = mask_step;
        }
      }
    }
    return;
  }
  if (phase == kDecode) {
    const long long row_tiles = (b + kTile - 1) / kTile;
    const float* zs[2][2] = {{w.zs[0], w.zs[1]}, {w.zsu[0], w.zsu[1]}};
    const float* zc[2][2] = {{w.zc, w.zc}, {w.zcu[0], w.zcu[1]}};
    float* g_loc[2][2] = {{w.g_loc[0], w.g_loc[1]},
                          {w.g_locu[0], w.g_locu[1]}};
    for (int u = 0; u < (poe ? 2 : 1); ++u) {
      for (int e = 0; e < 2; ++e) {
        const step::DecLayout& D = L.dec[e];
        auto* q = T.add(b, d[e], 0, 0, g_loc[u][e], d[e], step::kDecLoss,
                        P + D.bd, x[e], d[e]);
        T.add_segment(q, zs[u][e], s[e], P + D.Wds, d[e], s[e]);
        T.add_segment(q, zc[u][e], cd, P + D.Wdc, d[e], cd);
        if (q != nullptr) {
          q->step_aux = x_step[e];
          q->olv = P + D.olv;
          q->colp = w.colp[u][e];
          q->colp_stride = row_tiles * d[e];
          q->ld_colp = d[e];
          q->scale = static_cast<float>(a.b_total);
        }
      }
    }
    return;
  }
  if (phase == kDecGrads) {
    for (int e = 0; e < 2; ++e) {
      const step::DecLayout& D = L.dec[e];
      auto* q = T.add(s[e], d[e], 1, 0, G + D.Wds, d[e]);  // zs^T g_loc
      T.add_segment(q, w.zs[e], s[e], w.g_loc[e], d[e], b);
      if (poe) T.add_segment(q, w.zsu[e], s[e], w.g_locu[e], d[e], b);
      q = T.add(cd, d[e], 1, 0, G + D.Wdc, d[e]);           // zc^T g_loc
      T.add_segment(q, w.zc, cd, w.g_loc[e], d[e], b);
      if (poe) T.add_segment(q, w.zcu[e], cd, w.g_locu[e], d[e], b);
      q = T.add(b, s[e], 0, 1, w.g_zs[e], s[e]);            // g_loc Wds^T
      T.add_segment(q, w.g_loc[e], d[e], P + D.Wds, d[e], d[e]);
      if (poe) {
        q = T.add(b, s[e], 0, 1, w.g_zsu[e], s[e]);
        T.add_segment(q, w.g_locu[e], d[e], P + D.Wds, d[e], d[e]);
        q = T.add(b, cd, 0, 1, w.g_zcu[e], cd);
        T.add_segment(q, w.g_locu[e], d[e], P + D.Wdc, d[e], d[e]);
      }
    }
    auto* q = T.add(b, cd, 0, 1, w.g_zc, cd);  // sum_e g_loc_e Wdc_e^T
    for (int e = 0; e < 2; ++e) {
      T.add_segment(q, w.g_loc[e], d[e], P + L.dec[e].Wdc, d[e], d[e]);
    }
    return;
  }
  // the three phases over the encoders' heads
  const bool two = passes == 2;
  for (int e = 0; e < 2; ++e) {
    const step::EncLayout& E = L.enc[e];
    const long long Wo[4] = {E.Wcmu, E.Wclv, E.Wsmu, E.Wslv};
    const long long bo[4] = {E.bcmu, E.bclv, E.bsmu, E.bslv};
    const int n[4] = {cd, cd, s[e], s[e]};
    float* heads[2][4];
    float* g_heads[2][4];
    for (int p = 0; p < 2; ++p) {
      const Heads &H = w.heads[p][e], &GH = w.g_heads[p][e];
      float* hp[4] = {H.cmu, H.clv, H.smu, H.slv};
      float* gp[4] = {GH.cmu, GH.clv, GH.smu, GH.slv};
      for (int k = 0; k < 4; ++k) {
        heads[p][k] = hp[k];
        g_heads[p][k] = gp[k];
      }
    }
    if (phase == kHeads) {
      for (int p = 0; p < passes; ++p) {
        for (int k = 0; k < 4; ++k) {
          auto* q = T.add(b, n[k], 0, 0, heads[p][k], n[k], step::kBias,
                          P + bo[k]);
          T.add_segment(q, w.h[p][e], h, P + Wo[k], n[k], h);
        }
      }
    } else if (phase == kHiddenGrad) {
      // g_h = (sum_k g_head_k W_k^T) * (h > 0) [* mask]
      for (int p = 0; p < passes; ++p) {
        auto* q = T.add(b, h, 0, 1, w.g_h[p][e], h, step::kReluMask,
                        nullptr, w.h[p][e], h, a.mask[2 * p + e], a.ld_mask);
        for (int k = 0; k < 4; ++k) {
          T.add_segment(q, g_heads[p][k], n[k], P + Wo[k], n[k], n[k]);
        }
        if (q != nullptr) q->step_mask = mask_step;
      }
    } else {  // kWeightGrads
      auto* q = T.add(d[e], h, 1, 0, G + E.Wh, h);  // x^T g_h
      for (int p = 0; p < passes; ++p) {
        T.add_segment(q, x[e], d[e], w.g_h[p][e], h, b);
      }
      if (q != nullptr) q->step_A = x_step[e];
      for (int k = 0; k < 4; ++k) {
        q = T.add(h, n[k], 1, 0, G + Wo[k], n[k]);  // h^T g_head
        for (int p = 0; p < passes; ++p) {
          T.add_segment(q, w.h[p][e], h, g_heads[p][k], n[k], b);
        }
        C.add(g_heads[0][k], b, n[k], G + bo[k],
              two ? g_heads[1][k] : nullptr);
      }
      C.add(w.g_h[0][e], b, h, G + E.bh, two ? w.g_h[1][e] : nullptr);
    }
  }
}

// Tasks of a phase beside its product tiles.
__host__ __device__ int extra_tasks(int phase, const StepParams& a,
                                    const step::ColSumTable& C) {
  if (phase == kLatentFwd) return latent_fwd_tasks(a.b);
  if (phase == kLatentBwd) return latent_bwd_tasks(a.b, a.cd, a.s1, a.s2);
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
  LatentArgs lat;
  float sums[kParts + 4];
};

// The latents' view of the workspace.
__device__ LatentArgs latent_args(const StepParams& a, const Work& w) {
  LatentArgs la;
  const int up = a.passes - 1;  // the encoding the unimodal pass reads
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
  }
  la.separate = a.passes == 2;
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  la.nll_col = w.nll_col;
  set_latent_consts(la, a.method, a.b, a.row_offset, a.b_total, a.d1, a.d2,
                    a.cd, a.s1, a.s2, a.ld_noise, a.beta, a.beta_style,
                    a.beta_content);
  return la;
}

// One combine task: kCombineCols decoder columns, a thread per column, the
// row tiles' partials added in row-tile order (for poe the first decode's,
// then the unimodal decode's: the gradients are the two passes' sums).
__device__ void combine_task(const StepParams& a, const step::Layout& L,
                             const Work& w, int task) {
  const int c = task * kCombineCols + threadIdx.x;
  if (c >= a.d1 + a.d2) return;
  const int e = c < a.d1 ? 0 : 1;
  const int d = e == 0 ? a.d1 : a.d2;
  const int cc = e == 0 ? c : c - a.d1;
  const int row_tiles = (a.b + kTile - 1) / kTile;
  const long long stride = static_cast<long long>(row_tiles) * d;
  float acc_g = 0.0f, acc_o = 0.0f;
  for (int u = 0; u < (a.method == kPoe ? 2 : 1); ++u) {
    float acc_n = 0.0f;
    for (int rt = 0; rt < row_tiles; ++rt) {
      const float* src = w.colp[u][e] + static_cast<long long>(rt) * d + cc;
      acc_g += src[0];
      acc_o += src[stride];
      acc_n += src[2 * stride];
    }
    w.nll_col[u * (a.d1 + a.d2) + c] = acc_n;
  }
  a.grads[L.dec[e].bd + cc] = acc_g;
  a.grads[L.dec[e].olv + cc] =
      a.learn_scale ? acc_o / static_cast<float>(a.b_total) : 0.0f;
}

// Grid barriers of one step: one after each phase (Adam has none of its
// own: it rides on the last phase), but the last of a launch.
__host__ __device__ constexpr int barriers_per_step(int adam) {
  return adam ? kPhases : kPhases - 1;
}

template <bool kBf16>
__global__ void __launch_bounds__(step::kGemmThreads)
method_steps_kernel(const __grid_constant__ StepParams a) {
  cg::grid_group grid = cg::this_grid();
  // the product tiles' ring of stages is dynamic shared memory (above the
  // 48 KB a block may declare); the tables are static
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  __shared__ Tables tb;
  if (threadIdx.x == 0) {
    tb.layout = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
    tb.work = carve(a.work, a.method, a.passes, a.b, a.d1, a.d2, a.h, a.cd,
                    a.s1, a.s2);
    tb.cst.reset(tb.cs, kColSums);
    tb.lat = latent_args(a, tb.work);
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
  const int n_met = n_metrics(a.method);

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
    const float* noise = a.noise + a.noise_step * step;
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
          latent_fwd_task(tb.lat, noise, task - tiles);
        } else if (phase == kLatentBwd) {
          latent_bwd_task(tb.lat, noise, task - tiles);
        } else if (phase == kDecGrads) {
          combine_task(a, tb.layout, w, task - tiles);
        } else if (phase == kHiddenGrad) {
          metrics_task(tb.lat, a.metrics + static_cast<long long>(step) * n_met,
                       tb.sums);
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

// The largest task count of any phase (more blocks than that only wait),
// or -1 when a table overflows.
int max_phase_tasks(const StepParams& a) {
  const step::Layout L = step::make_layout(a.d1, a.d2, a.h, a.cd, a.s1, a.s2);
  const Work w = carve(a.work, a.method, a.passes, a.b, a.d1, a.d2, a.h,
                       a.cd, a.s1, a.s2);
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
      a.bf16 ? &method_steps_kernel<true> : &method_steps_kernel<false>,
      static_cast<int>(sizeof(Smem)),
      {a.b, a.d1, a.d2, a.h, a.cd, a.s1, a.s2, a.method, a.passes, a.bf16},
      [&] { return max_phase_tasks(a); }, blocks);
}

int launch_steps(const StepParams& a, cudaStream_t stream) {
  if (a.method < kJointElbo || a.method > kPoe) return cudaErrorInvalidValue;
  if (a.b < 1 || a.n_steps < 1 || a.row_offset < 0 ||
      a.b_total < a.row_offset + a.b || (!a.adam && a.n_steps != 1)) {
    return cudaErrorInvalidValue;
  }
  const bool masked = a.mask[0] != nullptr;
  const bool uni_masked = a.mask[2] != nullptr;
  if (masked != (a.mask[1] != nullptr) ||
      uni_masked != (a.mask[3] != nullptr) ||
      uni_masked != (masked && a.method == kPoe) ||
      a.passes != (uni_masked ? 2 : 1)) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int rc = grid_blocks(a, &blocks);
  if (rc != 0) return rc;
  StepParams params = a;
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(a.bf16 ? &method_steps_kernel<true>
                                     : &method_steps_kernel<false>),
      dim3(blocks),
      dim3(step::kGemmThreads), args, sizeof(Smem), stream));
}

StepParams sizes_only(int method, int passes, int b, int d1, int d2, int h,
                      int cd, int s1, int s2, int bf16) {
  StepParams a = {};
  a.bf16 = bf16 != 0;
  a.n_steps = 1;
  a.method = method;
  a.passes = passes;
  a.b = a.b_total = b;
  a.d1 = d1;
  a.d2 = d2;
  a.h = h;
  a.cd = cd;
  a.s1 = s1;
  a.s2 = s2;
  return a;
}

int passes_of(int method, int has_masks) {
  return (method == kPoe && has_masks) ? 2 : 1;
}

}  // namespace

extern "C" {

long long method_step_workspace_floats(int method, int has_masks, int b,
                                       int d1, int d2, int h, int cd, int s1,
                                       int s2) {
  return carve(nullptr, method, passes_of(method, has_masks), b, d1, d2, h,
               cd, s1, s2).total;
}

// Blocks of the cooperative grid at these sizes on the current device, of
// the float32 (bf16 = 0) or the bfloat16 instance (negative: minus a CUDA
// error code).
int method_step_grid_blocks(int method, int has_masks, int b, int d1, int d2,
                            int h, int cd, int s1, int s2, int bf16) {
  int blocks = 0;
  const int rc = grid_blocks(sizes_only(method, passes_of(method, has_masks),
                                        b, d1, d2, h, cd, s1, s2, bf16),
                             &blocks);
  return rc != 0 ? -rc : blocks;
}

// Grid barriers per step of a launch (adam: with the in-kernel update).
int method_step_barriers(int adam) { return barriers_per_step(adam); }

// One step on `stream` over rows [row_offset, row_offset + b) of a batch of
// b_total rows: grads (flat, split layout) and the metrics from the flat
// params, as partial sums of the whole batch's (see the header); params are
// not touched. method: 0 joint_elbo, 1 moe, 2 jsd, 3 poe. mask0..mask3 are
// all null (no dropout) or the keep masks of encoder 1, encoder 2 and, for
// poe, of the unimodal re-encodings of 1 and 2 (null otherwise), each
// [B, h] with row stride ld_mask (the local rows, like x and the noise).
// bf16 != 0 takes the bfloat16 branch (scheme B). One cooperative launch.
// Returns the first CUDA error (0 on success). Synchronizes nothing and
// allocates nothing: `work` holds
// method_step_workspace_floats(..., b, ...) floats.
int method_step_slice_launch(const float* params, float* grads, float* metrics,
                             const float* x1, const float* x2,
                             const float* noise, int ld_noise,
                             const float* mask0, const float* mask1,
                             const float* mask2, const float* mask3,
                             int ld_mask, float* work, int method, int b,
                             int row_offset, int b_total, int d1, int d2, int h,
                             int cd, int s1, int s2, float beta,
                             float beta_style, float beta_content,
                             int learn_scale, void* stream_ptr, int bf16) {
  StepParams a = sizes_only(method, mask2 != nullptr ? 2 : 1, b, d1, d2, h,
                            cd, s1, s2, bf16);
  // n = 1 and Adam off: the params are only read
  a.params = const_cast<float*>(params);
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x1 = x1;
  a.x2 = x2;
  a.noise = noise;
  a.ld_noise = ld_noise;
  a.mask[0] = mask0;
  a.mask[1] = mask1;
  a.mask[2] = mask2;
  a.mask[3] = mask3;
  a.ld_mask = ld_mask;
  a.row_offset = row_offset;
  a.b_total = b_total;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

// The unsharded step: the slice that is the whole batch.
int method_step_launch(const float* params, float* grads, float* metrics,
                       const float* x1, const float* x2, const float* noise,
                       int ld_noise, const float* mask0, const float* mask1,
                       const float* mask2, const float* mask3, int ld_mask,
                       float* work, int method, int b, int d1, int d2, int h,
                       int cd, int s1, int s2, float beta, float beta_style,
                       float beta_content, int learn_scale, void* stream_ptr,
                       int bf16) {
  return method_step_slice_launch(params, grads, metrics, x1, x2, noise,
                                  ld_noise, mask0, mask1, mask2, mask3, ld_mask,
                                  work, method, b, 0, b, d1, d2, h, cd, s1, s2,
                                  beta, beta_style, beta_content, learn_scale,
                                  stream_ptr, bf16);
}

// n steps in ONE cooperative launch on `stream`, each followed by Adam at
// t = count + step + 1 over params, mu and nu (flat, split layout, updated
// in place): x1s [n, b, d1], x2s [n, b, d2], noise [n, b, w] (w as for one
// step of the method) and masks [n, 2 | 4, b, h] (null for no dropout; 4
// for poe) contiguous, metrics [n, 17 | 19], grads a scratch buffer of the
// params' size (it ends as the last step's gradient). The Adam scalars are
// float32 as in flat_adam_launch. phase_times is null, or takes n x 9
// device timestamps in ns (tracing, as in mopoe_epoch_launch). bf16 != 0
// takes the bfloat16 branch. Returns the first CUDA error (0 on success);
// synchronizes and allocates nothing.
int method_epoch_launch(float* params, float* mu, float* nu, float* grads,
                        float* metrics, const float* x1s, const float* x2s,
                        const float* noise, const float* masks, float* work,
                        int n, int method, int b, int d1, int d2, int h, int cd,
                        int s1, int s2, float beta, float beta_style,
                        float beta_content, int learn_scale, long long count,
                        float lr, float b1, float b2, float one_minus_b1,
                        float one_minus_b2, float log_b1, float log_b2,
                        float eps, unsigned long long* phase_times,
                        void* stream_ptr, int bf16) {
  const bool poe = method == kPoe;
  const int passes = passes_of(method, masks != nullptr);
  StepParams a = sizes_only(method, passes, b, d1, d2, h, cd, s1, s2, bf16);
  const int width = (cd + s1 + s2) + (poe ? 2 * cd + s1 + s2 : 0);
  const long long mask_floats = static_cast<long long>(b) * h;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x1 = x1s;
  a.x2 = x2s;
  a.noise = noise;
  a.ld_noise = width;
  if (masks != nullptr) {
    for (int k = 0; k < 2 * passes; ++k) a.mask[k] = masks + k * mask_floats;
    a.mask_step = 2 * passes * mask_floats;
  }
  a.ld_mask = h;
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
  a.phase_times = phase_times;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

const char* method_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
