// One train step of a full complete batch for an architecture of any depth
// and any modality count: encoder and decoder layer stacks around the
// methods' latent math, forward and hand-derived backward, for Hopper
// (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_generic.py::
// make_generic_fused_epoch (its inner `kernel`): jax.value_and_grad of
// model.apply + total_loss traced into the TPU kernel for whatever model the
// config builds, params and both Adam moments resident over a grid of
// steps with Adam inside. CUDA cannot trace a model into a kernel, so this
// is the same function written by hand with the sizes as launch arguments
// (pinned to jax.value_and_grad through the plain version,
// multivae_tpu_torch/ops/fused_generic.py::generic_fwd_bwd_reference). One
// body serves M in [2, kMaxMods] modalities, n_enc in [1, kMaxDepth] hidden
// layers per encoder, n_dec in [0, kMaxDepth] per decoder, and three
// output-scale modes: a learned or a frozen per-feature out_logvar, or
// (sample_scale) the out_heads projection to loc | logvar per sample, whose
// weight gradient takes [g_loc | g_lv] as one right-hand side. Methods:
// joint_elbo, moe, jsd, poe with or without its unimodal ELBOs. The latent
// math is latent_common.cuh at M = 2 (but for poe without its unimodal
// ELBOs), latent_multi.cuh otherwise (`general`). Likelihoods
// (step::Likelihood): normal, laplace and bernoulli in the output layer's
// epilogue (gemm_tile's kLik), categorical in a phase of its own (see
// below); bernoulli and categorical read the location as logits and give
// the log-variance an exact zero gradient. A style width of 0 is a modality
// without style latents (the unfactorized latent): no style heads, noise or
// KL, the decoder reads zc.
//
// In: the params as one flat buffer in the general layout (make_layout: the
// flax leaves in the JAX layout [in, out]: encoders 1 .. M, decoders 1 .. M;
// per network hidden_0 .. hidden_{n-1}, then heads, or out_mu and
// out_logvar, or out_heads; kernel before bias), x_e [B, d_e] per modality,
// the noise [B, w] (cd | s_1 .. s_M, poe's unimodal ELBOs append cd | s_m per
// modality) and, under dropout, pre-scaled keep masks [n_masks, B, h], one
// per hidden layer and pass: the main pass's encoder 1 .. M layers, decoder
// 1 .. M layers, then for poe's unimodal ELBOs the re-runs' in the same
// order. Out: the metrics (latent_multi.cuh's n_metrics; at M = 2 the 17 of
// method_metric_names, 19 for poe) and the gradient of every parameter, in
// the params' layout.
//
// poe's unimodal ELBOs add one decode per modality: a second pass through
// the decoder stack from (zsu, zcu). Without masks it reads the main pass's
// encoding; with masks the encoder stack runs a second time under its own
// masks and that pass gets the unimodal NLL's gradient only. Both passes'
// weight gradients are summed inside one product (two segments).
//
// What bounds it: latency, as for the split-layout steps (mopoe_step.cu,
// method_step.cu), with a phase per layer. The same design: ONE persistent,
// cooperative launch runs n steps with Adam inside (generic_epoch_launch;
// generic_step_launch is the same kernel with n = 1 and Adam off). The
// kernel builds its phase list and every phase's problem table once per
// launch from (M, n_enc, n_dec, sample_scale, passes), each phase's tasks
// strided over the blocks, a grid barrier after each phase but the launch's
// last. The tables live in shared memory, every block building its own,
// while their problems fit kPoolBytes; past that (many modalities with deep
// stacks) block 0 builds them once in the workspace and a grid barrier
// publishes them:
//   enc i (i < n_enc)   relu(in W_i + b_i) [* mask], every encoding
//   heads               the heads of every encoding
//   latents             latent_common.cuh, a warp per row; latent_multi.cuh
//                       a warp per row and a warp per (row, subset)
//   dec j (j < n_dec)   the decoder layers of every decode pass
//   output              the output layer with the loss in its epilogue:
//                       kDecLoss (per-feature out_logvar) writes g_out and
//                       per-row-tile column partials; under a per-sample
//                       scale a task computes the log-variance tile, then
//                       the loc tile whose kSampleLoss epilogue writes g_loc,
//                       g_lv and the partials of both bias halves and the NLL;
//                       categorical: the logits alone (kBias)
//   output rows         categorical only: a row's log-sum-exp spans every
//                       column tile, so a task takes a row tile, a warp per
//                       row (max, log-sum-exp, g_loc = (softmax sum_j x_j -
//                       x) / b), then a thread per column adds the tile's
//                       rows in order into the partials of g_loc and the NLL
//   output grads        dWout and g of the last decoder layer (or, without
//                       decoder layers, the latents' grads); beside them the
//                       partials added in row-tile order: bout (and olv)
//                       grads, NLL column sums
//   dec j grads         dW_j and g of layer j - 1 (j = n_dec - 1 .. 1)
//   z grads             the first decoder layer's weight grads (zs and zc
//                       rows) and the latents' grads (n_dec > 0); general:
//                       each decoder's share of zc's gradient apart (a
//                       product takes at most kMaxSeg segments), summed in
//                       model order by the latents' backward
//   latents backward    a thread per element
//   heads grads         head weight grads and g of the last encoder layer;
//                       beside them the metrics, a warp per sum (general:
//                       the sums alone)
//   enc i grads         dW_i and g of layer i - 1 (i = n_enc - 1 .. 1)
//   last                dW_0 = x^T g_0, every bias grad (rows over warps),
//                       Adam; general: the metrics from the sums
// 2 (n_enc + n_dec) + 6 phases (one more for categorical): 10 at n_enc =
// n_dec = 1 (13 launches in the multi-launch structure), 12 at n_enc = 2.
// With Adam on, the last phase's
// gradients take their update where they are produced and every older
// phase's tensors beside them (adam_common.cuh, flat_adam's arithmetic bit
// for bit). Every product is step_common.cuh's gemm_tile (float32 FMA, no
// library product), no float atomics, every reduction in a fixed order that
// does not depend on the grid: two runs and two grids give the same bits.

#include <cooperative_groups.h>

#include <vector>

#include "adam_common.cuh"
#include "latent_common.cuh"
#include "latent_multi.cuh"
#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace latent;
using latent_m::kMaxMods;
using latent_m::kMaxSubsets;
using step::kTile;
using step::kWarps;

constexpr int kMaxDepth = 8;  // hidden layers per network
constexpr int kMaxPhases = 4 * kMaxDepth + 7;
constexpr int kMaxRanges = kMaxMods * (2 * kMaxDepth + 2);
constexpr int kCombineCols = step::kGemmThreads;
// shared memory for the problem and column-sum tables of one launch; a
// launch whose tables need more keeps them in the workspace
constexpr int kPoolBytes = 72 * 1024;

struct Shape {
  int b, m, d[kMaxMods], h, cd, s[kMaxMods], n_enc, n_dec, sample;
};

__host__ __device__ inline int sum_d(const Shape& S) {
  int total = 0;
  for (int e = 0; e < S.m; ++e) total += S.d[e];
  return total;
}

struct NetLayout {
  long long W[kMaxDepth], b[kMaxDepth];  // hidden layers: [in, h], [h]
  // the output projection: an encoder's heads [h, 2 cd + 2 s] (columns
  // cmu | clv | smu | slv), a decoder's out_mu [w, d] or out_heads [w, 2 d]
  // (columns loc | logvar)
  long long Wout, bout;
  long long olv;  // a decoder's out_logvar [d] (per-feature scale), else -1
  long long end;  // the end of the network's tensors
  int n_out;      // columns of the output projection
};

struct Layout {
  NetLayout enc[kMaxMods], dec[kMaxMods];
  long long total;
};

// The layout's offsets into L (written in place: a Layout is kilobytes, too
// large for a thread's stack).
__host__ __device__ void make_layout(const Shape& S, Layout& L) {
  long long off = 0;
  for (int e = 0; e < S.m; ++e) {
    NetLayout& E = L.enc[e];
    int width = S.d[e];
    for (int i = 0; i < S.n_enc; ++i) {
      E.W[i] = off; off += static_cast<long long>(width) * S.h;
      E.b[i] = off; off += S.h;
      width = S.h;
    }
    E.n_out = 2 * S.cd + 2 * S.s[e];
    E.Wout = off; off += static_cast<long long>(width) * E.n_out;
    E.bout = off; off += E.n_out;
    E.olv = -1;
    E.end = off;
  }
  for (int e = 0; e < S.m; ++e) {
    NetLayout& D = L.dec[e];
    int width = S.s[e] + S.cd;
    for (int j = 0; j < S.n_dec; ++j) {
      D.W[j] = off; off += static_cast<long long>(width) * S.h;
      D.b[j] = off; off += S.h;
      width = S.h;
    }
    D.n_out = S.sample ? 2 * S.d[e] : S.d[e];
    D.Wout = off; off += static_cast<long long>(width) * D.n_out;
    D.bout = off; off += D.n_out;
    D.olv = -1;
    if (!S.sample) {
      D.olv = off; off += S.d[e];
    }
    D.end = off;
  }
  L.total = off;
}

struct Work {
  // encoders: [pass][encoder][layer]; pass 1 exists for poe with masks
  float* h[2][kMaxMods][kMaxDepth];
  float* g_h[2][kMaxMods][kMaxDepth];
  Heads heads[2][kMaxMods], g_heads[2][kMaxMods];
  float *zc, *g_zc;
  float* g_zc_part[kMaxMods];  // general: decoder e's share of g_zc
  float *zs[kMaxMods], *g_zs[kMaxMods];
  // poe's unimodal latents
  float *zcu[kMaxMods], *g_zcu[kMaxMods], *zsu[kMaxMods], *g_zsu[kMaxMods];
  // decoders: [decode pass][decoder][layer]; pass 1 is poe's unimodal decode
  float* hd[2][kMaxMods][kMaxDepth];
  float* g_hd[2][kMaxMods][kMaxDepth];
  // the output layer's gradient [B, n_out]; under a per-sample scale the
  // log-variance [B, d] and the loss gradient [g_loc | g_lv]; categorical:
  // the logits [B, d] in lv
  float* g_out[2][kMaxMods];
  float* lv[2][kMaxMods];
  float* colp[2][kMaxMods];  // [3, row tiles, d]: the output's column partials
  float* part;     // [kParts | latent_m::n_parts, B]
  float* nll_col;  // [2, sum d]: first decode, unimodal decode
  float* sums;     // general: [latent_m::n_sums]
  float* tables;   // the launch's tables when they are kept here, else null
  long long total;
};

// Everything one launch needs, by value.
struct StepParams {
  float *params, *grads, *metrics;  // metrics [n_steps, n_metrics]
  float *mu, *nu;                   // Adam's moments (adam != 0)
  float* work;
  const float* x[kMaxMods];         // step 0's batches
  const float* noise;               // step 0's
  // step 0's keep masks (mask k at masks + k mask_stride, row stride
  // ld_mask) or null
  const float* masks;
  long long mask_stride;
  // floats from one step's batch, noise and masks to the next's
  long long x_step[kMaxMods], noise_step, mask_step;
  int ld_noise, ld_mask;
  int n_steps, adam, method, enc_passes, dec_passes, learn_scale;
  int uni;        // poe with its unimodal ELBOs
  int general;    // the latents of latent_multi.cuh (else latent_common.cuh)
  int likelihood;  // step::Likelihood
  // the tables: problems and column sums of every phase, and whether they
  // live in the workspace (else in shared memory)
  int pool_problems, pool_colsums, tables_global;
  float* tables;  // tables_global: where they live in the workspace
  Shape S;
  float beta, beta_style, beta_content;
  long long count;  // Adam updates taken before this launch
  adam::Hyper hyper;
  // tracing: null, or [n_steps, phases + 1] device timestamps in ns (block
  // 0's clock at the start of each step and after each phase's barrier)
  unsigned long long* phase_times;
};

__host__ __device__ inline int n_subsets_of(const StepParams& a) {
  return (1 << a.S.m) - 1;
}

__host__ __device__ inline int n_metrics_of(const StepParams& a) {
  return a.general ? latent_m::n_metrics(a.S.m, n_subsets_of(a), a.uni)
                   : n_metrics(a.method);
}

// Bytes of the launch's tables (Tables below, then the pools).
__host__ __device__ long long table_bytes(const StepParams& a);

// Carves the workspace into w (or, with base == nullptr, only counts its
// floats into w.total).
__host__ __device__ void carve(float* base, const StepParams& a, Work& w) {
  const Shape& S = a.S;
  const int enc_passes = a.enc_passes, dec_passes = a.dec_passes;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 3) / 4 * 4;  // every buffer starts 16-byte aligned
    return p;
  };
  const long long bl = S.b;
  const long long row_tiles = (S.b + kTile - 1) / kTile;
  for (int p = 0; p < 2; ++p) {
    for (int e = 0; e < S.m; ++e) {
      const long long on = p < enc_passes ? 1 : 0;
      for (int i = 0; i < kMaxDepth; ++i) {
        const long long li = i < S.n_enc ? on : 0;
        w.h[p][e][i] = take(li * bl * S.h);
        w.g_h[p][e][i] = take(li * bl * S.h);
      }
      Heads* both[2] = {&w.heads[p][e], &w.g_heads[p][e]};
      for (Heads* H : both) {
        H->cmu = take(on * bl * S.cd);
        H->clv = take(on * bl * S.cd);
        H->smu = take(on * bl * S.s[e]);
        H->slv = take(on * bl * S.s[e]);
      }
    }
  }
  w.zc = take(bl * S.cd);
  w.g_zc = take(bl * S.cd);
  const long long uni = dec_passes == 2 ? 1 : 0;
  const long long general = a.general ? 1 : 0;
  for (int e = 0; e < S.m; ++e) {
    w.g_zc_part[e] = take(general * bl * S.cd);
    w.zs[e] = take(bl * S.s[e]);
    w.g_zs[e] = take(bl * S.s[e]);
    w.zcu[e] = take(uni * bl * S.cd);
    w.g_zcu[e] = take(uni * bl * S.cd);
    w.zsu[e] = take(uni * bl * S.s[e]);
    w.g_zsu[e] = take(uni * bl * S.s[e]);
  }
  for (int q = 0; q < 2; ++q) {
    for (int e = 0; e < S.m; ++e) {
      const long long on = q < dec_passes ? 1 : 0;
      for (int j = 0; j < kMaxDepth; ++j) {
        const long long lj = j < S.n_dec ? on : 0;
        w.hd[q][e][j] = take(lj * bl * S.h);
        w.g_hd[q][e][j] = take(lj * bl * S.h);
      }
      const long long n_out = S.sample ? 2 * S.d[e] : S.d[e];
      w.g_out[q][e] = take(on * bl * n_out);
      const bool lv = S.sample || a.likelihood == step::kCategorical;
      w.lv[q][e] = take((lv ? on : 0) * bl * S.d[e]);
      w.colp[q][e] = take(on * step::kMaxColOut * row_tiles * S.d[e]);
    }
  }
  const int n_sub = n_subsets_of(a);
  w.part = take(static_cast<long long>(
                    a.general ? latent_m::n_parts(S.m, n_sub) : kParts) *
                bl);
  w.nll_col = take(2LL * sum_d(S));
  w.sums = take(general * latent_m::n_sums(S.m, n_sub, a.uni));
  w.tables = nullptr;
  if (a.tables_global) w.tables = take((table_bytes(a) + 3) / 4);
  w.total = off;
}

// the keep mask of hidden layer `i` of encoder (dec = 0) or decoder (dec = 1)
// `e` in pass `p`, step 0's
__host__ __device__ inline const float* mask_at(const StepParams& a, int p,
                                                int dec, int e, int i) {
  if (a.masks == nullptr) return nullptr;
  const int M = a.S.m, n_enc = a.S.n_enc, n_dec = a.S.n_dec;
  const int idx = p * M * (n_enc + n_dec) + (dec ? M * n_enc : 0) +
                  e * (dec ? n_dec : n_enc) + i;
  return a.masks + idx * a.mask_stride;
}

enum PhaseKind {
  kEncFwd = 0, kHeadsFwd, kLatentFwd, kDecFwd, kOutFwd, kOutBwd, kDecBwd,
  kZBwd, kLatentBwd, kHeadsBwd, kEncBwd, kLast, kRowLoss
};

struct PhaseDesc {
  int kind, layer;
};

// The phase list of a step at these depths and likelihood; returns its
// length.
__host__ __device__ int phase_list(int n_enc, int n_dec, int likelihood,
                                   PhaseDesc* out) {
  int n = 0;
  for (int i = 0; i < n_enc; ++i) out[n++] = PhaseDesc{kEncFwd, i};
  out[n++] = PhaseDesc{kHeadsFwd, 0};
  out[n++] = PhaseDesc{kLatentFwd, 0};
  for (int j = 0; j < n_dec; ++j) out[n++] = PhaseDesc{kDecFwd, j};
  out[n++] = PhaseDesc{kOutFwd, 0};
  if (likelihood == step::kCategorical) out[n++] = PhaseDesc{kRowLoss, 0};
  // without decoder layers the output layer's input is zs | zc: its
  // backward is the z grads' phase
  out[n++] = PhaseDesc{kOutBwd, 0};
  for (int j = n_dec - 1; j >= 1; --j) out[n++] = PhaseDesc{kDecBwd, j};
  if (n_dec > 0) out[n++] = PhaseDesc{kZBwd, 0};
  out[n++] = PhaseDesc{kLatentBwd, 0};
  out[n++] = PhaseDesc{kHeadsBwd, 0};
  for (int i = n_enc - 1; i >= 1; --i) out[n++] = PhaseDesc{kEncBwd, i};
  out[n++] = PhaseDesc{kLast, 0};
  return n;
}

// Under a per-sample scale the output phase's tasks are (log-variance, loc)
// tile pairs; categorical needs no log-variance (its gradient is 0).
__host__ __device__ inline bool output_pairs(const StepParams& a) {
  return a.S.sample && a.likelihood != step::kCategorical;
}

// The most problems a phase of this kind may add at these passes.
__host__ __device__ inline int phase_cap(const PhaseDesc& ph,
                                         const StepParams& a) {
  const int NP = a.enc_passes, Q = a.dec_passes, M = a.S.m;
  // zs^T gin, zc^T gin, g_zs (and poe's g_zsu, g_zcu) per decoder, and g_zc
  // (general: a share per decoder)
  const int z_layer = M * (3 + 2 * (Q - 1)) + (a.general ? M : 1);
  switch (ph.kind) {
    case kEncFwd: return M * NP;
    case kHeadsFwd: return 4 * M * NP;
    case kDecFwd: return M * Q;
    case kOutFwd: return M * Q * (a.S.sample ? 2 : 1);
    case kOutBwd: return a.S.n_dec > 0 ? M * (1 + Q) : z_layer;
    case kDecBwd: return M * (1 + Q);
    case kZBwd: return z_layer;
    case kHeadsBwd: return 4 * M + M * NP;
    case kEncBwd: return M * (1 + NP);
    case kLast: return M;
    default: return 0;
  }
}

// Column sums of the last phase: per encoder its heads' and hidden layers'
// biases, per decoder its hidden layers'.
__host__ __device__ inline int colsum_cap(const StepParams& a) {
  return a.S.m * (4 + a.S.n_enc + a.S.n_dec);
}

// The backward of a decoder's first layer, whose input is zs | zc: the
// weight gradient's style and content rows (both decode passes in one sum)
// and the gradients of the latents. `gin[q][e]` [B, n] is the gradient of
// the layer's pre-activation in decode pass q, the layer's kernel
// [s + cd, n] sits at offset `Woff[e]` of params and grads.
__host__ __device__ void z_layer_problems(const StepParams& a, const Work& w,
                                          float* gin[2][kMaxMods],
                                          const int* n,
                                          const long long* Woff,
                                          step::GemmTable& T) {
  const Shape& S = a.S;
  const int cd = S.cd, Q = a.dec_passes;
  float* P = a.params;
  float* G = a.grads;
  for (int e = 0; e < S.m; ++e) {
    const int s = S.s[e];
    const long long Ws = Woff[e];
    const long long Wc = Woff[e] + static_cast<long long>(s) * n[e];
    auto* q = T.add(s, n[e], 1, 0, G + Ws, n[e]);  // zs^T gin
    T.add_segment(q, w.zs[e], s, gin[0][e], n[e], S.b);
    if (Q == 2) T.add_segment(q, w.zsu[e], s, gin[1][e], n[e], S.b);
    q = T.add(cd, n[e], 1, 0, G + Wc, n[e]);  // zc^T gin
    T.add_segment(q, w.zc, cd, gin[0][e], n[e], S.b);
    if (Q == 2) T.add_segment(q, w.zcu[e], cd, gin[1][e], n[e], S.b);
    q = T.add(S.b, s, 0, 1, w.g_zs[e], s);  // gin Ws^T
    T.add_segment(q, gin[0][e], n[e], P + Ws, n[e], n[e]);
    if (Q == 2) {
      q = T.add(S.b, s, 0, 1, w.g_zsu[e], s);
      T.add_segment(q, gin[1][e], n[e], P + Ws, n[e], n[e]);
      q = T.add(S.b, cd, 0, 1, w.g_zcu[e], cd);
      T.add_segment(q, gin[1][e], n[e], P + Wc, n[e], n[e]);
    }
  }
  if (a.general) {  // decoder e's share gin_e Wc_e^T, summed by the latents
    for (int e = 0; e < S.m; ++e) {
      const long long Wc = Woff[e] + static_cast<long long>(S.s[e]) * n[e];
      auto* q = T.add(S.b, cd, 0, 1, w.g_zc_part[e], cd);
      T.add_segment(q, gin[0][e], n[e], P + Wc, n[e], n[e]);
    }
    return;
  }
  auto* q = T.add(S.b, cd, 0, 1, w.g_zc, cd);  // sum_e gin_e Wc_e^T
  for (int e = 0; e < S.m; ++e) {
    const long long Wc = Woff[e] + static_cast<long long>(S.s[e]) * n[e];
    T.add_segment(q, gin[0][e], n[e], P + Wc, n[e], n[e]);
  }
}

// The problems of one phase into T, and the last phase's bias sums into C.
__host__ __device__ void build_phase(const PhaseDesc& ph, const StepParams& a,
                                     const Layout& L, const Work& w,
                                     step::GemmTable& T,
                                     step::ColSumTable& C) {
  const Shape& S = a.S;
  const int b = S.b, h = S.h, cd = S.cd, nE = S.n_enc, nD = S.n_dec;
  const int M = S.m;
  const int* d = S.d;
  const int* s = S.s;
  const int NP = a.enc_passes, Q = a.dec_passes;
  const int mask_step = static_cast<int>(a.mask_step);
  const int ldm = a.ld_mask;
  float* P = a.params;
  float* G = a.grads;
  // the head slices of an encoder's output projection: cmu | clv | smu | slv
  auto head_n = [&](int e, int k) { return k < 2 ? cd : s[e]; };
  auto head_col = [&](int e, int k) {
    return k == 0 ? 0 : k == 1 ? cd : k == 2 ? 2 * cd : 2 * cd + s[e];
  };
  auto head = [&](const Heads& H, int k) {
    return k == 0 ? H.cmu : k == 1 ? H.clv : k == 2 ? H.smu : H.slv;
  };
  // the latents a decode pass reads
  auto zs_of = [&](int q, int e) -> const float* {
    return q == 0 ? w.zs[e] : w.zsu[e];
  };
  auto zc_of = [&](int q, int e) -> const float* {
    return q == 0 ? w.zc : w.zcu[e];
  };
  const long long row_tiles = (b + kTile - 1) / kTile;

  switch (ph.kind) {
    case kEncFwd: {  // relu(in W_i + b_i) [* mask]
      const int i = ph.layer;
      for (int p = 0; p < NP; ++p) {
        for (int e = 0; e < M; ++e) {
          const float* in = i == 0 ? a.x[e] : w.h[p][e][i - 1];
          const int K = i == 0 ? d[e] : h;
          auto* q = T.add(b, h, 0, 0, w.h[p][e][i], h, step::kBiasRelu,
                          P + L.enc[e].b[i], nullptr, 0,
                          mask_at(a, p, 0, e, i), ldm);
          T.add_segment(q, in, K, P + L.enc[e].W[i], h, K);
          if (q != nullptr) {
            if (i == 0) q->step_A = static_cast<int>(a.x_step[e]);
            q->step_mask = mask_step;
          }
        }
      }
      break;
    }
    case kHeadsFwd:
      for (int p = 0; p < NP; ++p) {
        for (int e = 0; e < M; ++e) {
          const NetLayout& E = L.enc[e];
          for (int k = 0; k < 4; ++k) {
            auto* q = T.add(b, head_n(e, k), 0, 0, head(w.heads[p][e], k),
                            head_n(e, k), step::kBias,
                            P + E.bout + head_col(e, k));
            T.add_segment(q, w.h[p][e][nE - 1], h,
                          P + E.Wout + head_col(e, k), E.n_out, h);
          }
        }
      }
      break;
    case kDecFwd: {  // the first layer reads zs | zc as two segments
      const int j = ph.layer;
      for (int q = 0; q < Q; ++q) {
        for (int e = 0; e < M; ++e) {
          const NetLayout& D = L.dec[e];
          auto* pr = T.add(b, h, 0, 0, w.hd[q][e][j], h, step::kBiasRelu,
                           P + D.b[j], nullptr, 0, mask_at(a, q, 1, e, j),
                           ldm);
          if (j == 0) {
            T.add_segment(pr, zs_of(q, e), s[e], P + D.W[0], h, s[e]);
            T.add_segment(pr, zc_of(q, e), cd,
                          P + D.W[0] + static_cast<long long>(s[e]) * h, h,
                          cd);
          } else {
            T.add_segment(pr, w.hd[q][e][j - 1], h, P + D.W[j], h, h);
          }
          if (pr != nullptr) pr->step_mask = mask_step;
        }
      }
      break;
    }
    case kOutFwd:
      // per-feature scale: g_out from kDecLoss; per-sample: a pair per
      // (pass, decoder), the log-variance tile (kBias) then the loc tile
      // (kSampleLoss), taken by one task; categorical: the logits into lv
      // (kBias), whose loss is the next phase's
      for (int q = 0; q < Q; ++q) {
        for (int e = 0; e < M; ++e) {
          const NetLayout& D = L.dec[e];
          const int ldb = D.n_out;
          const bool logits = a.likelihood == step::kCategorical;
          for (int half = output_pairs(a) ? 1 : 0; half >= 0; --half) {
            const long long col = half ? d[e] : 0;  // lv columns, loc columns
            step::Problem* pr;
            if (half || logits) {
              pr = T.add(b, d[e], 0, 0, w.lv[q][e], d[e], step::kBias,
                         P + D.bout + col);
            } else {
              pr = T.add(b, d[e], 0, 0, w.g_out[q][e], D.n_out,
                         S.sample ? step::kSampleLoss : step::kDecLoss,
                         P + D.bout, a.x[e], d[e]);
            }
            if (nD == 0) {
              T.add_segment(pr, zs_of(q, e), s[e], P + D.Wout + col, ldb,
                            s[e]);
              T.add_segment(pr, zc_of(q, e), cd,
                            P + D.Wout + static_cast<long long>(s[e]) * ldb +
                                col,
                            ldb, cd);
            } else {
              T.add_segment(pr, w.hd[q][e][nD - 1], h, P + D.Wout + col, ldb,
                            h);
            }
            if (pr != nullptr && !half && !logits) {
              pr->step_aux = static_cast<int>(a.x_step[e]);
              pr->olv = S.sample ? nullptr : P + D.olv;
              pr->lv = S.sample ? w.lv[q][e] : nullptr;
              pr->ld_lv = d[e];
              pr->colp = w.colp[q][e];
              pr->colp_stride = row_tiles * d[e];
              pr->ld_colp = d[e];
              pr->scale = static_cast<float>(b);
            }
          }
        }
      }
      break;
    case kOutBwd:
      if (nD > 0) {
        for (int e = 0; e < M; ++e) {
          const NetLayout& D = L.dec[e];
          auto* pr = T.add(h, D.n_out, 1, 0, G + D.Wout, D.n_out);
          for (int q = 0; q < Q; ++q) {
            T.add_segment(pr, w.hd[q][e][nD - 1], h, w.g_out[q][e], D.n_out,
                          b);
          }
          for (int q = 0; q < Q; ++q) {
            pr = T.add(b, h, 0, 1, w.g_hd[q][e][nD - 1], h, step::kReluMask,
                       nullptr, w.hd[q][e][nD - 1], h,
                       mask_at(a, q, 1, e, nD - 1), ldm);
            T.add_segment(pr, w.g_out[q][e], D.n_out, P + D.Wout, D.n_out,
                          D.n_out);
            if (pr != nullptr) pr->step_mask = mask_step;
          }
        }
      } else {
        float* gin[2][kMaxMods];
        int n[kMaxMods];
        long long Woff[kMaxMods];
        for (int e = 0; e < M; ++e) {
          n[e] = L.dec[e].n_out;
          Woff[e] = L.dec[e].Wout;
          for (int q = 0; q < 2; ++q) gin[q][e] = w.g_out[q][e];
        }
        z_layer_problems(a, w, gin, n, Woff, T);
      }
      break;
    case kDecBwd: {  // dW_j and g of layer j - 1
      const int j = ph.layer;
      for (int e = 0; e < M; ++e) {
        const NetLayout& D = L.dec[e];
        auto* pr = T.add(h, h, 1, 0, G + D.W[j], h);
        for (int q = 0; q < Q; ++q) {
          T.add_segment(pr, w.hd[q][e][j - 1], h, w.g_hd[q][e][j], h, b);
        }
        for (int q = 0; q < Q; ++q) {
          pr = T.add(b, h, 0, 1, w.g_hd[q][e][j - 1], h, step::kReluMask,
                     nullptr, w.hd[q][e][j - 1], h,
                     mask_at(a, q, 1, e, j - 1), ldm);
          T.add_segment(pr, w.g_hd[q][e][j], h, P + D.W[j], h, h);
          if (pr != nullptr) pr->step_mask = mask_step;
        }
      }
      break;
    }
    case kZBwd: {
      float* gin[2][kMaxMods];
      int n[kMaxMods];
      long long Woff[kMaxMods];
      for (int e = 0; e < M; ++e) {
        n[e] = h;
        Woff[e] = L.dec[e].W[0];
        for (int q = 0; q < 2; ++q) gin[q][e] = w.g_hd[q][e][0];
      }
      z_layer_problems(a, w, gin, n, Woff, T);
      break;
    }
    case kHeadsBwd:
      // head weight grads (both encodings in one sum), and per encoding the
      // last layer's g = (sum_k g_head_k W_k^T) * mask * (h > 0)
      for (int e = 0; e < M; ++e) {
        const NetLayout& E = L.enc[e];
        for (int k = 0; k < 4; ++k) {
          auto* pr = T.add(h, head_n(e, k), 1, 0,
                           G + E.Wout + head_col(e, k), E.n_out);
          for (int p = 0; p < NP; ++p) {
            T.add_segment(pr, w.h[p][e][nE - 1], h, head(w.g_heads[p][e], k),
                          head_n(e, k), b);
          }
        }
        for (int p = 0; p < NP; ++p) {
          auto* pr = T.add(b, h, 0, 1, w.g_h[p][e][nE - 1], h,
                           step::kReluMask, nullptr, w.h[p][e][nE - 1], h,
                           mask_at(a, p, 0, e, nE - 1), ldm);
          for (int k = 0; k < 4; ++k) {
            T.add_segment(pr, head(w.g_heads[p][e], k), head_n(e, k),
                          P + E.Wout + head_col(e, k), E.n_out, head_n(e, k));
          }
          if (pr != nullptr) pr->step_mask = mask_step;
        }
      }
      break;
    case kEncBwd: {  // dW_i and g of layer i - 1
      const int i = ph.layer;
      for (int e = 0; e < M; ++e) {
        const NetLayout& E = L.enc[e];
        auto* pr = T.add(h, h, 1, 0, G + E.W[i], h);
        for (int p = 0; p < NP; ++p) {
          T.add_segment(pr, w.h[p][e][i - 1], h, w.g_h[p][e][i], h, b);
        }
        for (int p = 0; p < NP; ++p) {
          pr = T.add(b, h, 0, 1, w.g_h[p][e][i - 1], h, step::kReluMask,
                     nullptr, w.h[p][e][i - 1], h,
                     mask_at(a, p, 0, e, i - 1), ldm);
          T.add_segment(pr, w.g_h[p][e][i], h, P + E.W[i], h, h);
          if (pr != nullptr) pr->step_mask = mask_step;
        }
      }
      break;
    }
    case kLast:
      // dW_0 = x^T g_0; the bias grads of the heads and of every hidden
      // layer (two passes' sources one after the other)
      for (int e = 0; e < M; ++e) {
        const NetLayout& E = L.enc[e];
        auto* pr = T.add(d[e], h, 1, 0, G + E.W[0], h);
        for (int p = 0; p < NP; ++p) {
          T.add_segment(pr, a.x[e], d[e], w.g_h[p][e][0], h, b);
        }
        if (pr != nullptr) pr->step_A = static_cast<int>(a.x_step[e]);
        for (int k = 0; k < 4; ++k) {
          C.add(head(w.g_heads[0][e], k), b, head_n(e, k),
                G + E.bout + head_col(e, k),
                NP == 2 ? head(w.g_heads[1][e], k) : nullptr);
        }
        for (int i = 0; i < nE; ++i) {
          C.add(w.g_h[0][e][i], b, h, G + E.b[i],
                NP == 2 ? w.g_h[1][e][i] : nullptr);
        }
        for (int j = 0; j < nD; ++j) {
          C.add(w.g_hd[0][e][j], b, h, G + L.dec[e].b[j],
                Q == 2 ? w.g_hd[1][e][j] : nullptr);
        }
      }
      break;
    default:
      break;
  }
}

// Tasks of a phase beside its product tiles (the per-sample output pairs
// count once: see output_pair).
__host__ __device__ int extra_tasks(const PhaseDesc& ph, const StepParams& a,
                                    const step::ColSumTable& C) {
  const Shape& S = a.S;
  const int n_sub = n_subsets_of(a);
  switch (ph.kind) {
    case kLatentFwd:
      return a.general ? latent_m::fwd_tasks(S.b, n_sub)
                       : latent_fwd_tasks(S.b);
    case kLatentBwd:
      return a.general ? latent_m::bwd_tasks(S.b, S.cd, S.s, S.m)
                       : latent_bwd_tasks(S.b, S.cd, S.s[0], S.s[1]);
    case kOutBwd: return (sum_d(S) + kCombineCols - 1) / kCombineCols;
    case kRowLoss:
      return a.dec_passes * S.m * ((S.b + kTile - 1) / kTile);
    case kHeadsBwd:
      return a.general ? latent_m::sum_tasks(S.m, n_sub, a.uni) : 1;
    case kLast: return C.total_chunks + (a.general ? 1 : 0);
    default: return 0;
  }
}

// The product tasks of a phase: its tiles, or under a per-sample scale the
// output phase's loc tiles (each also computes its log-variance tile).
__host__ __device__ inline int product_tasks(const PhaseDesc& ph,
                                             const StepParams& a,
                                             const step::GemmTable& T) {
  return ph.kind == kOutFwd && output_pairs(a) ? T.total_tiles / 2
                                               : T.total_tiles;
}

// The tensors of the older phases, whose Adam update rides on the last
// phase: [begin[r], end[r]). The last phase produces the encoders' first
// layer kernels and every hidden and head bias.
struct Ranges {
  long long begin[kMaxRanges], end[kMaxRanges];
  int count;
};

__host__ __device__ void older_ranges(const Shape& S, const Layout& L,
                                      Ranges& r) {
  r.count = 0;
  for (int e = 0; e < S.m; ++e) {
    const NetLayout& E = L.enc[e];
    for (int i = 1; i < S.n_enc; ++i) {
      r.begin[r.count] = E.W[i];
      r.end[r.count++] = E.b[i];
    }
    r.begin[r.count] = E.Wout;
    r.end[r.count++] = E.bout;
  }
  for (int e = 0; e < S.m; ++e) {
    const NetLayout& D = L.dec[e];
    for (int j = 0; j < S.n_dec; ++j) {
      r.begin[r.count] = D.W[j];
      r.end[r.count++] = D.b[j];
    }
    r.begin[r.count] = D.Wout;  // Wout, bout and out_logvar
    r.end[r.count++] = D.end;
  }
}

constexpr int kStages = 3;  // slices of a k-group in flight or in use
using Smem = step::GemmSmem<kStages>;

// The launch's tables: in dynamic shared memory after the product stages
// (above the 48 KB a block may declare statically), or in the workspace;
// the problem and column-sum pools follow them.
struct Tables {
  step::GemmTable tab[kMaxPhases];
  PhaseDesc phases[kMaxPhases];
  int n_phases;
  step::ColSumTable cst;
  Layout layout;
  Work work;
  LatentArgs lat;        // latent_common.cuh's (M = 2)
  latent_m::Args latm;   // latent_multi.cuh's (general)
  Ranges older;
  float sums[kParts + 4];
  unsigned short subsets[kMaxSubsets];
};

__host__ __device__ inline long long pool_offset() {
  return (static_cast<long long>(sizeof(Tables)) + 15) / 16 * 16;
}

__host__ __device__ long long table_bytes(const StepParams& a) {
  return pool_offset() +
         static_cast<long long>(a.pool_problems) * sizeof(step::Problem) +
         static_cast<long long>(a.pool_colsums) * sizeof(step::ColSum);
}

constexpr int kSmemBytes =
    static_cast<int>(sizeof(Smem) + (sizeof(Tables) + 15) / 16 * 16) +
    kPoolBytes;

// The latents' view of the workspace (latent_common.cuh, M = 2).
__device__ LatentArgs latent_args(const StepParams& a, const Work& w) {
  LatentArgs la;
  const int up = a.enc_passes - 1;  // the encoding the unimodal pass reads
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
  la.separate = a.enc_passes == 2;
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  la.nll_col = w.nll_col;
  const Shape& S = a.S;
  set_latent_consts(la, a.method, S.b, 0, S.b, S.d[0], S.d[1], S.cd, S.s[0],
                    S.s[1], a.ld_noise, a.beta, a.beta_style,
                    a.beta_content);
  return la;
}

// The latents' view of the workspace (latent_multi.cuh, general).
__device__ void latent_multi_args(const StepParams& a, const Work& w,
                                  const unsigned short* subsets,
                                  latent_m::Args& la) {
  const Shape& S = a.S;
  const int up = a.enc_passes - 1;
  latent_m::set_consts(la, a.method, a.uni, S.m, S.b, S.cd, S.d, S.s,
                       a.ld_noise, a.beta, a.beta_style, a.beta_content);
  la.separate = a.enc_passes == 2;
  la.subsets = subsets;
  for (int e = 0; e < S.m; ++e) {
    la.heads[e] = w.heads[0][e];
    la.g_heads[e] = w.g_heads[0][e];
    la.uheads[e] = w.heads[up][e];
    la.g_uheads[e] = w.g_heads[up][e];
    la.g_zc_part[e] = w.g_zc_part[e];
    la.zs[e] = w.zs[e];
    la.g_zs[e] = w.g_zs[e];
    la.zcu[e] = w.zcu[e];
    la.g_zcu[e] = w.g_zcu[e];
    la.zsu[e] = w.zsu[e];
    la.g_zsu[e] = w.g_zsu[e];
  }
  la.zc = w.zc;
  la.part = w.part;
  la.nll_col = w.nll_col;
  la.sums = w.sums;
}

// One combine task: kCombineCols output columns, a thread per column, the
// row tiles' partials added in row-tile order (for poe the first decode's,
// then the unimodal decode's: the gradients are the two passes' sums).
__device__ void combine_task(const StepParams& a, const Layout& L,
                             const Work& w, int task) {
  const Shape& S = a.S;
  const int total = sum_d(S);
  const int c = task * kCombineCols + threadIdx.x;
  if (c >= total) return;
  int e = 0, cc = c;
  while (cc >= S.d[e]) cc -= S.d[e++];
  const int d = S.d[e];
  const int row_tiles = (S.b + kTile - 1) / kTile;
  const long long stride = static_cast<long long>(row_tiles) * d;
  float acc_a = 0.0f, acc_b = 0.0f;
  for (int u = 0; u < a.dec_passes; ++u) {
    float acc_n = 0.0f;
    for (int rt = 0; rt < row_tiles; ++rt) {
      const float* src = w.colp[u][e] + static_cast<long long>(rt) * d + cc;
      acc_a += src[0];
      acc_b += src[stride];
      acc_n += src[2 * stride];
    }
    w.nll_col[u * total + c] = acc_n;
  }
  const NetLayout& D = L.dec[e];
  a.grads[D.bout + cc] = acc_a;
  if (S.sample) {
    a.grads[D.bout + d + cc] = acc_b;  // the g_lv half (already / b)
  } else {
    a.grads[D.olv + cc] =
        a.learn_scale ? acc_b / static_cast<float>(S.b) : 0.0f;
  }
}

// The largest of v over a warp's lanes; every lane of the warp calls it and
// gets the result (a max does not depend on the order of its operands).
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Categorical, one task of the output-rows phase: row tile `rt` (kTile rows)
// of decoder e in decode pass q. A warp per row reads the row's logits (lv,
// stored by the output phase across every column tile) and data: its max,
// its log-sum-exp lse and sum_j x_j (fixed butterflies), then g_loc =
// (exp(l - lse) sum_j x_j - x) / b into g_out (under a per-sample scale an
// exact 0 into the log-variance half). Then a thread per column adds the
// tile's rows in row order: the column partials of g_loc, of the
// log-variance gradient (0) and of the NLL x (lse - l), as kDecLoss writes
// them for the combine. `lse_rows`: kTile floats of shared memory. Every
// thread of the block calls it.
__device__ void row_loss_task(const StepParams& a, const Work& w, int task,
                              int step, float* lse_rows) {
  const Shape& S = a.S;
  const int row_tiles = (S.b + kTile - 1) / kTile;
  const int q = task / (S.m * row_tiles);
  const int e = task / row_tiles % S.m;
  const int rt = task % row_tiles;
  const int d = S.d[e];
  const int n_out = S.sample ? 2 * d : d;
  const float* x = a.x[e] + a.x_step[e] * step;
  const float* logits = w.lv[q][e];
  float* g = w.g_out[q][e];
  const float bf = static_cast<float>(S.b);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rows = min(kTile, S.b - rt * kTile);
  for (int r = warp; r < rows; r += kWarps) {  // uniform across the warp
    const long long m = static_cast<long long>(rt) * kTile + r;
    const float* lr = logits + m * d;
    const float* xr = x + m * d;
    float top = -3.402823466e38f;  // -FLT_MAX
    for (int c = lane; c < d; c += 32) top = fmaxf(top, lr[c]);
    top = warp_max(top);
    float se = 0.0f, sx = 0.0f;
    for (int c = lane; c < d; c += 32) {
      se += expf(lr[c] - top);
      sx += xr[c];
    }
    se = step::warp_sum(se);
    sx = step::warp_sum(sx);
    const float lse = top + logf(se);
    if (lane == 0) lse_rows[r] = lse;
    float* gr = g + m * n_out;
    for (int c = lane; c < d; c += 32) {
      gr[c] = (expf(lr[c] - lse) * sx - xr[c]) / bf;
      if (S.sample) gr[d + c] = 0.0f;
    }
  }
  __syncthreads();  // the tile's g_loc and lse are visible to the block
  const long long stride = static_cast<long long>(row_tiles) * d;
  float* colp = w.colp[q][e] + static_cast<long long>(rt) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc_g = 0.0f, acc_n = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const long long m = static_cast<long long>(rt) * kTile + r;
      acc_g += g[m * n_out + c];
      acc_n += x[m * d + c] * (lse_rows[r] - logits[m * d + c]);
    }
    colp[c] = acc_g;
    colp[stride + c] = 0.0f;
    colp[2 * stride + c] = acc_n;
  }
  __syncthreads();  // lse_rows is the next task's
}

// Under a per-sample scale, one output task: the log-variance tile, then
// the loc tile, whose kSampleLoss epilogue reads what this block just stored
// (the block barrier at the end of gemm_tile makes it visible).
template <int kLik>
__device__ void output_pair(const step::GemmTable& T, int task, int step,
                            Smem& sm) {
  int pi = 0, tile = task;
  for (;;) {
    const step::Problem& loc = T.p[pi + 1];
    const int tiles = ((loc.M + kTile - 1) / kTile) * loc.tiles_n;
    if (tile < tiles || pi + 3 >= T.count) break;
    tile -= tiles;
    pi += 2;
  }
  step::gemm_tile(T.p[pi], tile, step, sm);
  step::gemm_tile<kStages, kLik>(T.p[pi + 1], tile, step, sm);
}

// One task of the output phase: a pair, or one tile (the loss epilogue's
// likelihood kLik; categorical stores logits under kBias).
template <int kLik>
__device__ void output_task(const StepParams& a, const step::GemmTable& T,
                            int task, int step, Smem& sm) {
  if (output_pairs(a)) {
    output_pair<kLik>(T, task, step, sm);
    return;
  }
  int tile = task;
  const step::Problem& P = T.find(tile);
  step::gemm_tile<kStages, kLik>(P, tile, step, sm);
}

__host__ __device__ constexpr int n_phases_of(int n_enc, int n_dec,
                                              int likelihood) {
  return 2 * (n_enc + n_dec) + 6 + (likelihood == step::kCategorical);
}

// The launch's setup, by one thread: the layout, the workspace, the
// latents' arguments, the older ranges, the phase list and every phase's
// (empty) table over the pools.
__device__ void setup_tables(const StepParams& a, Tables& tb,
                             step::Problem* prob, step::ColSum* cs) {
  make_layout(a.S, tb.layout);
  carve(a.work, a, tb.work);
  tb.cst.reset(cs, a.pool_colsums);
  if (a.general) {
    latent_m::powerset_masks(a.S.m, tb.subsets);
    latent_multi_args(a, tb.work, tb.subsets, tb.latm);
  } else {
    tb.lat = latent_args(a, tb.work);
  }
  older_ranges(a.S, tb.layout, tb.older);
  tb.n_phases = phase_list(a.S.n_enc, a.S.n_dec, a.likelihood, tb.phases);
  int first = 0;
  for (int ph = 0; ph < tb.n_phases; ++ph) {
    const int cap = phase_cap(tb.phases[ph], a);
    tb.tab[ph].reset(prob + first, cap);
    first += cap;
  }
}

__global__ void __launch_bounds__(step::kGemmThreads)
generic_steps_kernel(const __grid_constant__ StepParams a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  // the tables: every block's own in shared memory, or one copy in the
  // workspace that block 0 builds and a grid barrier publishes
  unsigned char* base = a.tables_global
                            ? reinterpret_cast<unsigned char*>(a.tables)
                            : dynamic_smem + sizeof(Smem);
  Tables& tb = *reinterpret_cast<Tables*>(base);
  auto* prob = reinterpret_cast<step::Problem*>(base + pool_offset());
  auto* cs = reinterpret_cast<step::ColSum*>(prob + a.pool_problems);
  const bool builds = !a.tables_global || blockIdx.x == 0;
  if (builds && threadIdx.x == 0) setup_tables(a, tb, prob, cs);
  __syncthreads();
  if (builds) {
    // one thread per phase builds that phase's table
    for (int ph = threadIdx.x / 32; ph < tb.n_phases; ph += kWarps) {
      if (threadIdx.x % 32 == 0) {
        build_phase(tb.phases[ph], a, tb.layout, tb.work, tb.tab[ph],
                    tb.cst);
      }
    }
  }
  if (a.tables_global) {
    grid.sync();
  } else {
    __syncthreads();
  }
  const int n_phases = tb.n_phases;
  const int n_met = n_metrics_of(a);

  step::AdamAt adam_at;
  adam_at.p = a.params;
  adam_at.mu = a.mu;
  adam_at.nu = a.nu;
  adam_at.g = a.grads;
  adam_at.hyper = a.hyper;
  for (int step = 0; step < a.n_steps; ++step) {
    step::stamp(a.phase_times, step * (n_phases + 1));
    adam_at.correction = adam::correction(
        static_cast<float>(a.count + step + 1), a.hyper);
    const float* noise = a.noise + a.noise_step * step;
    float* metrics = a.metrics + static_cast<long long>(step) * n_met;
    for (int ph = 0; ph < n_phases; ++ph) {
      const PhaseDesc desc = tb.phases[ph];
      const step::GemmTable& T = tb.tab[ph];
      const int tiles = product_tasks(desc, a, T);
      const int tasks = tiles + extra_tasks(desc, a, tb.cst);
      // the last phase's gradients take their Adam update where they are
      // produced: every reader of the params in this step is done
      const step::AdamAt* adam =
          a.adam && desc.kind == kLast ? &adam_at : nullptr;
      for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
        if (task < tiles) {
          if (desc.kind == kOutFwd) {
            switch (a.likelihood) {
              case step::kLaplace:
                output_task<step::kLaplace>(a, T, task, step, sm);
                break;
              case step::kBernoulli:
                output_task<step::kBernoulli>(a, T, task, step, sm);
                break;
              default:  // normal; categorical's tiles store logits
                output_task<step::kNormal>(a, T, task, step, sm);
                break;
            }
          } else {
            int tile = task;
            const step::Problem& P = T.find(tile);
            step::gemm_tile(P, tile, step, sm, adam);
          }
        } else if (desc.kind == kRowLoss) {
          row_loss_task(a, tb.work, task - tiles, step, &sm.colred[0][0][0]);
        } else if (desc.kind == kLatentFwd) {
          if (a.general) {
            latent_m::fwd_task(tb.latm, noise, task - tiles);
          } else {
            latent_fwd_task(tb.lat, noise, task - tiles);
          }
        } else if (desc.kind == kLatentBwd) {
          if (a.general) {
            latent_m::bwd_task(tb.latm, noise, task - tiles);
          } else {
            latent_bwd_task(tb.lat, noise, task - tiles);
          }
        } else if (desc.kind == kOutBwd) {
          combine_task(a, tb.layout, tb.work, task - tiles);
        } else if (desc.kind == kHeadsBwd) {
          if (a.general) {
            latent_m::sum_task(tb.latm, task - tiles);
          } else {
            metrics_task(tb.lat, metrics, tb.sums);
          }
        } else {
          int chunk = task - tiles;
          if (chunk == tb.cst.total_chunks) {  // general: the metrics
            latent_m::metrics_task(tb.latm, metrics);
          } else {
            const step::ColSum& S = tb.cst.find(chunk);
            step::colsum_chunk(S, chunk, sm.colred[0], adam);
          }
        }
      }
      if (adam != nullptr) {
        for (int r = 0; r < tb.older.count; ++r) {
          adam::update_range(a.params, a.mu, a.nu, a.grads,
                             tb.older.begin[r], tb.older.end[r], a.hyper,
                             adam_at.correction);
        }
      }
      if (ph + 1 < n_phases || step + 1 < a.n_steps) grid.sync();
      step::stamp(a.phase_times, step * (n_phases + 1) + ph + 1);
    }
  }
}

bool valid_shape(const Shape& S, int likelihood) {
  if (S.m < 2 || S.m > kMaxMods) return false;
  for (int e = 0; e < S.m; ++e) {
    if (S.d[e] < 1 || S.s[e] < 0) return false;
  }
  return S.b >= 1 && S.h >= 1 && S.cd >= 1 && S.n_enc >= 1 &&
         S.n_enc <= kMaxDepth && S.n_dec >= 0 && S.n_dec <= kMaxDepth &&
         likelihood >= step::kNormal && likelihood <= step::kCategorical;
}

// The largest task count of any phase (more blocks than that only wait),
// or -1 when a table overflows.
int max_phase_tasks(const StepParams& a) {
  Layout L;
  make_layout(a.S, L);
  Work w;
  carve(a.work, a, w);
  PhaseDesc phases[kMaxPhases];
  const int n = phase_list(a.S.n_enc, a.S.n_dec, a.likelihood, phases);
  std::vector<step::Problem> prob(a.pool_problems);
  std::vector<step::ColSum> cs(a.pool_colsums);
  step::ColSumTable C;
  C.reset(cs.data(), a.pool_colsums);
  int most = 0, used = 0;
  for (int ph = 0; ph < n; ++ph) {
    step::GemmTable T;
    const int cap = phase_cap(phases[ph], a);
    T.reset(prob.data() + used, cap);
    used += cap;
    build_phase(phases[ph], a, L, w, T, C);
    if (T.overflow || C.overflow || used > a.pool_problems) return -1;
    const int tasks = product_tasks(phases[ph], a, T) +
                      extra_tasks(phases[ph], a, C);
    if (tasks > most) most = tasks;
  }
  return most;
}

int grid_blocks(const StepParams& a, int* blocks) {
  const Shape& S = a.S;
  // the cache's key: the widths folded into one number each (any key is
  // safe: the grid is what is co-resident, capped by the largest phase)
  int dh = 0, sh = 0;
  for (int e = 0; e < S.m; ++e) {
    dh = dh * 131 + S.d[e];
    sh = sh * 131 + S.s[e];
  }
  return step::cooperative_grid(
      generic_steps_kernel, kSmemBytes,
      {S.b, S.m, dh, S.h, S.cd, sh, S.n_enc, S.n_dec,
       S.sample + 2 * a.likelihood + 8 * a.uni, a.method, a.enc_passes,
       a.tables_global},
      [&] { return max_phase_tasks(a); }, blocks);
}

int launch_steps(const StepParams& a, cudaStream_t stream) {
  if (a.method < kJointElbo || a.method > kPoe ||
      !valid_shape(a.S, a.likelihood) ||
      a.n_steps < 1 || (!a.adam && a.n_steps != 1)) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int rc = grid_blocks(a, &blocks);
  if (rc != 0) return rc;
  StepParams params = a;
  Work w;
  carve(a.work, a, w);
  params.tables = w.tables;
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(generic_steps_kernel), dim3(blocks),
      dim3(step::kGemmThreads), args, kSmemBytes, stream));
}

StepParams sizes_only(int method, int uni, int has_masks, const Shape& S,
                      int likelihood) {
  StepParams a = {};
  a.n_steps = 1;
  a.method = method;
  a.likelihood = likelihood;
  a.S = S;
  a.uni = method == kPoe && uni;
  a.general = S.m != 2 || (method == kPoe && !a.uni);
  a.dec_passes = a.uni ? 2 : 1;
  a.enc_passes = (a.uni && has_masks) ? 2 : 1;
  PhaseDesc phases[kMaxPhases];
  const int n = phase_list(S.n_enc, S.n_dec, likelihood, phases);
  for (int ph = 0; ph < n; ++ph) a.pool_problems += phase_cap(phases[ph], a);
  a.pool_colsums = colsum_cap(a);
  a.tables_global = table_bytes(a) - pool_offset() > kPoolBytes;
  return a;
}

Shape make_shape(int b, int m, const int* ds, int h, int cd, const int* ss,
                 int n_enc, int n_dec, int sample_scale) {
  Shape S = {};
  S.b = b;
  S.m = m;
  S.h = h;
  S.cd = cd;
  S.n_enc = n_enc;
  S.n_dec = n_dec;
  S.sample = sample_scale;
  for (int e = 0; e < m && e < kMaxMods; ++e) {
    S.d[e] = ds[e];
    S.s[e] = ss[e];
  }
  return S;
}

// The noise's columns of one step (latent_multi.cuh's layout).
int noise_width(const Shape& S, int uni) {
  int width = S.cd;
  for (int e = 0; e < S.m; ++e) width += S.s[e] + (uni ? S.cd + S.s[e] : 0);
  return width;
}

}  // namespace

extern "C" {

int generic_step_max_depth() { return kMaxDepth; }

int generic_step_max_mods() { return kMaxMods; }

// The sizes are (m, ds, h, cd, ss, n_enc, n_dec, sample_scale, likelihood)
// throughout: ds and ss hold m widths each, in model order; likelihood is
// step::Likelihood (0 normal, 1 laplace, 2 bernoulli, 3 categorical). The
// layout does not depend on it.
long long generic_step_param_floats(int m, const int* ds, int h, int cd,
                                    const int* ss, int n_enc, int n_dec,
                                    int sample_scale, int likelihood) {
  if (m < 2 || m > kMaxMods) return -1;
  const Shape S = make_shape(1, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  if (!valid_shape(S, likelihood)) return -1;
  Layout L;
  make_layout(S, L);
  return L.total;
}

// uni: poe with its unimodal ELBOs (ignored for the other methods).
long long generic_step_workspace_floats(int method, int uni, int has_masks,
                                        int b, int m, const int* ds, int h,
                                        int cd, const int* ss, int n_enc,
                                        int n_dec, int sample_scale,
                                        int likelihood) {
  if (m < 2 || m > kMaxMods) return -1;
  const Shape S = make_shape(b, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  if (!valid_shape(S, likelihood)) return -1;
  Work w;
  carve(nullptr, sizes_only(method, uni, has_masks, S, likelihood), w);
  return w.total;
}

// Phases of one step at these depths and likelihood (a launch given
// phase_times stamps the start of each step and the end of each phase).
int generic_step_phases(int n_enc, int n_dec, int likelihood) {
  return n_phases_of(n_enc, n_dec, likelihood);
}

// Grid barriers per step of a launch (adam: with the in-kernel update).
int generic_step_barriers(int n_enc, int n_dec, int likelihood, int adam) {
  return n_phases_of(n_enc, n_dec, likelihood) - (adam ? 0 : 1);
}

// Blocks of the cooperative grid at these sizes on the current device
// (negative: minus a CUDA error code).
int generic_step_grid_blocks(int method, int uni, int has_masks, int b,
                             int m, const int* ds, int h, int cd,
                             const int* ss, int n_enc, int n_dec,
                             int sample_scale, int likelihood) {
  if (m < 2 || m > kMaxMods) return -static_cast<int>(cudaErrorInvalidValue);
  const Shape S = make_shape(b, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  if (!valid_shape(S, likelihood)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int rc =
      grid_blocks(sizes_only(method, uni, has_masks, S, likelihood), &blocks);
  return rc != 0 ? -rc : blocks;
}

// 1 when a launch at these sizes keeps its tables in the workspace (they
// outgrow kPoolBytes of shared memory), 0 when in shared memory, -1 for
// sizes the kernel does not take.
int generic_step_tables_in_device_memory(int method, int uni, int has_masks,
                                         int b, int m, const int* ds, int h,
                                         int cd, const int* ss, int n_enc,
                                         int n_dec, int sample_scale,
                                         int likelihood) {
  if (m < 2 || m > kMaxMods) return -1;
  const Shape S = make_shape(b, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  if (!valid_shape(S, likelihood)) return -1;
  return sizes_only(method, uni, has_masks, S, likelihood).tables_global;
}

// One step on `stream`, in one cooperative launch: grads (flat, the params'
// layout) and the metrics from the flat params; params are not touched.
// method: 0 joint_elbo, 1 moe, 2 jsd, 3 poe; xs: the m batches [b, d_e].
// `masks` is null (no dropout) or the keep masks in the order of the
// header, mask k at masks + k * mask_stride, each [B, h] with row stride
// ld_mask. learn_scale freezes the per-feature out_logvar when 0 (its
// gradient is then 0); the per-sample scale always learns. Returns the first
// CUDA error (0 on success). Synchronizes nothing and allocates nothing:
// `work` holds generic_step_workspace_floats(...) floats.
int generic_step_launch(const float* params, float* grads, float* metrics,
                        const float* const* xs, const float* noise,
                        int ld_noise, const float* masks,
                        long long mask_stride, int ld_mask, float* work,
                        int method, int uni, int b, int m, const int* ds,
                        int h, int cd, const int* ss, int n_enc, int n_dec,
                        int sample_scale, int likelihood, float beta,
                        float beta_style, float beta_content, int learn_scale,
                        void* stream_ptr) {
  if (m < 2 || m > kMaxMods) return cudaErrorInvalidValue;
  const Shape S = make_shape(b, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  StepParams a =
      sizes_only(method, uni, masks != nullptr, S, likelihood);
  // n = 1 and Adam off: the params are only read
  a.params = const_cast<float*>(params);
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  for (int e = 0; e < m; ++e) a.x[e] = xs[e];
  a.noise = noise;
  a.ld_noise = ld_noise;
  a.masks = masks;
  a.mask_stride = mask_stride;
  a.ld_mask = ld_mask;
  a.learn_scale = learn_scale;
  a.beta = beta;
  a.beta_style = beta_style;
  a.beta_content = beta_content;
  return launch_steps(a, static_cast<cudaStream_t>(stream_ptr));
}

// n steps in ONE cooperative launch on `stream`, each followed by Adam at
// t = count + step + 1 over params, mu and nu (flat, the general layout,
// updated in place): xs the m stacks [n, b, d_e], noise [n, b, w] (w as for
// one step of the method) and masks [n, n_masks, b, h] (null for no
// dropout) contiguous, metrics [n, n_metrics] (the step's order), grads a
// scratch buffer of the params' size. The Adam scalars are float32 as in
// flat_adam_launch. phase_times is null, or takes n x (generic_step_phases
// + 1) device timestamps in ns (tracing). Returns the first CUDA error (0
// on success); synchronizes and allocates nothing.
int generic_epoch_launch(float* params, float* mu, float* nu, float* grads,
                         float* metrics, const float* const* xs,
                         const float* noise, const float* masks, float* work,
                         int n, int method, int uni, int b, int m,
                         const int* ds, int h, int cd, const int* ss,
                         int n_enc, int n_dec, int sample_scale,
                         int likelihood, float beta, float beta_style,
                         float beta_content, int learn_scale,
                         long long count, float lr, float b1, float b2,
                         float one_minus_b1, float one_minus_b2,
                         float log_b1, float log_b2, float eps,
                         unsigned long long* phase_times, void* stream_ptr) {
  if (m < 2 || m > kMaxMods) return cudaErrorInvalidValue;
  const Shape S = make_shape(b, m, ds, h, cd, ss, n_enc, n_dec, sample_scale);
  StepParams a =
      sizes_only(method, uni, masks != nullptr, S, likelihood);
  const long long mask_floats = static_cast<long long>(b) * h;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  for (int e = 0; e < m; ++e) {
    a.x[e] = xs[e];
    a.x_step[e] = static_cast<long long>(b) * ds[e];
  }
  a.noise = noise;
  a.ld_noise = noise_width(S, a.uni);
  a.masks = masks;
  a.mask_stride = mask_floats;
  a.ld_mask = h;
  if (masks != nullptr) {
    a.mask_step = static_cast<long long>(m) * (n_enc + n_dec) *
                  a.enc_passes * mask_floats;
  }
  a.noise_step = static_cast<long long>(b) * a.ld_noise;
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

const char* generic_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
