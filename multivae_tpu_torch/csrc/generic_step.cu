// One train step of a full complete batch for an architecture of any depth:
// encoder and decoder layer stacks around the methods' latent math, forward
// and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_generic.py::
// make_generic_fused_epoch (its inner `kernel`): jax.value_and_grad of
// model.apply + total_loss traced into the TPU kernel for whatever model the
// config builds, params and both Adam moments resident over a grid of
// steps with Adam inside. CUDA cannot trace a model into a kernel, so this
// is the same function written by hand with the depths as launch arguments
// (pinned to jax.value_and_grad through the plain version,
// multivae_tpu_torch/ops/fused_generic.py::generic_fwd_bwd_reference). One
// body serves every depth: n_enc in [1, kMaxDepth] hidden layers per
// encoder, n_dec in [0, kMaxDepth] per decoder, and three output-scale
// modes: a learned or a frozen per-feature out_logvar, or (sample_scale) the
// out_heads projection to loc | logvar per sample, whose weight gradient
// takes [g_loc | g_lv] as one right-hand side. Methods: joint_elbo, moe,
// jsd, poe (latent_common.cuh).
//
// In: the params as one flat buffer in the general layout (make_layout: the
// flax leaves in the JAX layout [in, out]: encoder 1, encoder 2, decoder 1,
// decoder 2; per network hidden_0 .. hidden_{n-1}, then heads, or out_mu and
// out_logvar, or out_heads; kernel before bias), x1 [B, d1], x2 [B, d2], the
// noise [B, w] (cd | s1 | s2, poe appends cd | s1 and cd | s2) and, under
// dropout, pre-scaled keep masks [n_masks, B, h], one per hidden layer and
// pass: the main pass's encoder 1 layers, encoder 2 layers, decoder 1 layers,
// decoder 2 layers, then for poe the unimodal re-runs' in the same order.
// Out: the 17 metrics of method_metric_names (19 for poe) and the gradient
// of every parameter, in the params' layout.
//
// poe adds one unimodal ELBO per modality: a second pass through the decoder
// stack from (zsu, zcu). Without masks it reads the main pass's encoding;
// with masks the encoder stack runs a second time under its own masks and
// that pass gets the unimodal NLL's gradient only. Both passes' weight
// gradients are summed inside one product (two segments).
//
// What bounds it: latency, as for the split-layout steps (mopoe_step.cu,
// method_step.cu), with a phase per layer. The same design: ONE persistent,
// cooperative launch runs n steps with Adam inside (generic_epoch_launch;
// generic_step_launch is the same kernel with n = 1 and Adam off). The
// kernel builds its phase list and every phase's problem table in shared
// memory once per launch from (n_enc, n_dec, sample_scale, passes), each
// phase's tasks strided over the blocks, a grid barrier after each phase
// but the launch's last:
//   enc i (i < n_enc)   relu(in W_i + b_i) [* mask], every encoding
//   heads               the heads of every encoding
//   latents             latent_common.cuh, a warp per row
//   dec j (j < n_dec)   the decoder layers of every decode pass
//   output              the output layer with the loss in its epilogue:
//                       kDecLoss (per-feature out_logvar) writes g_out and
//                       per-row-tile column partials; under a per-sample
//                       scale a task computes the log-variance tile, then
//                       the loc tile whose kSampleLoss epilogue writes g_loc,
//                       g_lv and the partials of both bias halves and the NLL
//   output grads        dWout and g of the last decoder layer (or, without
//                       decoder layers, the latents' grads); beside them the
//                       partials added in row-tile order: bout (and olv)
//                       grads, NLL column sums
//   dec j grads         dW_j and g of layer j - 1 (j = n_dec - 1 .. 1)
//   z grads             the first decoder layer's weight grads (zs and zc
//                       rows) and the latents' grads (n_dec > 0)
//   latents backward    a thread per element
//   heads grads         head weight grads and g of the last encoder layer;
//                       beside them the metrics, a warp per sum
//   enc i grads         dW_i and g of layer i - 1 (i = n_enc - 1 .. 1)
//   last                dW_0 = x^T g_0, every bias grad (rows over warps),
//                       Adam
// 2 (n_enc + n_dec) + 6 phases: 10 at n_enc = n_dec = 1 (13 launches in the
// multi-launch structure), 12 at n_enc = 2. With Adam on, the last phase's
// gradients take their update where they are produced and every older
// phase's tensors beside them (adam_common.cuh, flat_adam's arithmetic bit
// for bit). Every product is step_common.cuh's gemm_tile (float32 FMA, no
// library product), no float atomics, every reduction in a fixed order that
// does not depend on the grid: two runs and two grids give the same bits.

#include <cooperative_groups.h>

#include "adam_common.cuh"
#include "latent_common.cuh"
#include "step_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace latent;
using step::kTile;
using step::kWarps;

constexpr int kMaxDepth = 4;  // hidden layers per network
constexpr int kMaxPhases = 4 * kMaxDepth + 6;
constexpr int kPoolProblems = 128;  // every phase's problems of one launch
constexpr int kColSums = 2 * (4 + 2 * kMaxDepth);
constexpr int kMaxRanges = 2 * kMaxDepth + 2 * (kMaxDepth + 1);
constexpr int kCombineCols = step::kGemmThreads;

struct Shape {
  int b, d[2], h, cd, s[2], n_enc, n_dec, sample;
};

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
  NetLayout enc[2], dec[2];
  long long total;
};

__host__ __device__ Layout make_layout(const Shape& S) {
  Layout L;
  long long off = 0;
  for (int e = 0; e < 2; ++e) {
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
  for (int e = 0; e < 2; ++e) {
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
  return L;
}

struct Work {
  // encoders: [pass][encoder][layer]; pass 1 exists for poe with masks
  float* h[2][2][kMaxDepth];
  float* g_h[2][2][kMaxDepth];
  Heads heads[2][2], g_heads[2][2];
  float *zc, *g_zc;
  float *zs[2], *g_zs[2];
  float *zcu[2], *g_zcu[2], *zsu[2], *g_zsu[2];  // poe's unimodal latents
  // decoders: [decode pass][decoder][layer]; pass 1 is poe's unimodal decode
  float* hd[2][2][kMaxDepth];
  float* g_hd[2][2][kMaxDepth];
  // the output layer's gradient [B, n_out]; under a per-sample scale the
  // log-variance [B, d] and the loss gradient [g_loc | g_lv]
  float* g_out[2][2];
  float* lv[2][2];
  float* colp[2][2];  // [3, row tiles, d]: the output's column partials
  float* part;        // [kParts, B]
  float* nll_col;     // [2, d1 + d2]: first decode, unimodal decode
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
__host__ __device__ Work carve(float* base, const Shape& S, int enc_passes,
                               int dec_passes) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += (n + 3) / 4 * 4;  // every buffer starts 16-byte aligned
    return p;
  };
  const long long bl = S.b;
  const long long row_tiles = (S.b + kTile - 1) / kTile;
  for (int p = 0; p < 2; ++p) {
    for (int e = 0; e < 2; ++e) {
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
  for (int e = 0; e < 2; ++e) {
    w.zs[e] = take(bl * S.s[e]);
    w.g_zs[e] = take(bl * S.s[e]);
    w.zcu[e] = take(uni * bl * S.cd);
    w.g_zcu[e] = take(uni * bl * S.cd);
    w.zsu[e] = take(uni * bl * S.s[e]);
    w.g_zsu[e] = take(uni * bl * S.s[e]);
  }
  for (int q = 0; q < 2; ++q) {
    for (int e = 0; e < 2; ++e) {
      const long long on = q < dec_passes ? 1 : 0;
      for (int j = 0; j < kMaxDepth; ++j) {
        const long long lj = j < S.n_dec ? on : 0;
        w.hd[q][e][j] = take(lj * bl * S.h);
        w.g_hd[q][e][j] = take(lj * bl * S.h);
      }
      const long long n_out = S.sample ? 2 * S.d[e] : S.d[e];
      w.g_out[q][e] = take(on * bl * n_out);
      w.lv[q][e] = take((S.sample ? on : 0) * bl * S.d[e]);
      w.colp[q][e] = take(on * step::kMaxColOut * row_tiles * S.d[e]);
    }
  }
  w.part = take(static_cast<long long>(kParts) * bl);
  w.nll_col = take(2LL * (S.d[0] + S.d[1]));
  w.total = off;
  return w;
}

// Everything one launch needs, by value.
struct StepParams {
  float *params, *grads, *metrics;  // metrics [n_steps, 17 | 19]
  float *mu, *nu;                   // Adam's moments (adam != 0)
  float* work;
  const float *x1, *x2, *noise;     // step 0's
  // step 0's keep masks (mask k at masks + k mask_stride, row stride
  // ld_mask) or null
  const float* masks;
  long long mask_stride;
  // floats from one step's x1, x2, noise and masks to the next's
  long long x1_step, x2_step, noise_step, mask_step;
  int ld_noise, ld_mask;
  int n_steps, adam, method, enc_passes, dec_passes, learn_scale;
  Shape S;
  float beta, beta_style, beta_content;
  long long count;  // Adam updates taken before this launch
  adam::Hyper hyper;
  // tracing: null, or [n_steps, phases + 1] device timestamps in ns (block
  // 0's clock at the start of each step and after each phase's barrier)
  unsigned long long* phase_times;
};

// the keep mask of hidden layer `i` of encoder (dec = 0) or decoder (dec = 1)
// `e` in pass `p`, step 0's
__host__ __device__ inline const float* mask_at(const StepParams& a, int p,
                                                int dec, int e, int i) {
  if (a.masks == nullptr) return nullptr;
  const int n_enc = a.S.n_enc, n_dec = a.S.n_dec;
  const int idx = p * 2 * (n_enc + n_dec) + (dec ? 2 * n_enc : 0) +
                  e * (dec ? n_dec : n_enc) + i;
  return a.masks + idx * a.mask_stride;
}

enum PhaseKind {
  kEncFwd = 0, kHeadsFwd, kLatentFwd, kDecFwd, kOutFwd, kOutBwd, kDecBwd,
  kZBwd, kLatentBwd, kHeadsBwd, kEncBwd, kLast
};

struct PhaseDesc {
  int kind, layer;
};

// The phase list of a step at these depths; returns its length.
__host__ __device__ int phase_list(int n_enc, int n_dec, PhaseDesc* out) {
  int n = 0;
  for (int i = 0; i < n_enc; ++i) out[n++] = PhaseDesc{kEncFwd, i};
  out[n++] = PhaseDesc{kHeadsFwd, 0};
  out[n++] = PhaseDesc{kLatentFwd, 0};
  for (int j = 0; j < n_dec; ++j) out[n++] = PhaseDesc{kDecFwd, j};
  out[n++] = PhaseDesc{kOutFwd, 0};
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

// The most problems a phase of this kind may add at these passes.
__host__ __device__ inline int phase_cap(const PhaseDesc& ph,
                                         const StepParams& a) {
  const int NP = a.enc_passes, Q = a.dec_passes;
  const int z_layer = 2 * (3 + 2 * (Q - 1)) + 1;
  switch (ph.kind) {
    case kEncFwd: return 2 * NP;
    case kHeadsFwd: return 8 * NP;
    case kDecFwd: return 2 * Q;
    case kOutFwd: return 2 * Q * (a.S.sample ? 2 : 1);
    case kOutBwd: return a.S.n_dec > 0 ? 2 + 2 * Q : z_layer;
    case kDecBwd: return 2 * (1 + Q);
    case kZBwd: return z_layer;
    case kHeadsBwd: return 8 + 2 * NP;
    case kEncBwd: return 2 * (1 + NP);
    case kLast: return 2;
    default: return 0;
  }
}

// The backward of a decoder's first layer, whose input is zs | zc: the
// weight gradient's style and content rows (both decode passes in one sum)
// and the gradients of the latents. `gin[q][e]` [B, n] is the gradient of
// the layer's pre-activation in decode pass q, the layer's kernel
// [s + cd, n] sits at offset `Woff[e]` of params and grads.
__host__ __device__ void z_layer_problems(const StepParams& a, const Work& w,
                                          float* gin[2][2],
                                          const int n[2],
                                          const long long Woff[2],
                                          step::GemmTable& T) {
  const Shape& S = a.S;
  const int cd = S.cd, Q = a.dec_passes;
  float* P = a.params;
  float* G = a.grads;
  for (int e = 0; e < 2; ++e) {
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
  auto* q = T.add(S.b, cd, 0, 1, w.g_zc, cd);  // sum_e gin_e Wc_e^T
  for (int e = 0; e < 2; ++e) {
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
  const int* d = S.d;
  const int* s = S.s;
  const int NP = a.enc_passes, Q = a.dec_passes;
  const float* x[2] = {a.x1, a.x2};
  const int x_step[2] = {static_cast<int>(a.x1_step),
                         static_cast<int>(a.x2_step)};
  const int mask_step = static_cast<int>(a.mask_step);
  const int ldm = a.ld_mask;
  float* P = a.params;
  float* G = a.grads;
  // the head slices of an encoder's output projection
  int hn[2][4], hcol[2][4];
  for (int e = 0; e < 2; ++e) {
    const int n[4] = {cd, cd, s[e], s[e]};
    int col = 0;
    for (int k = 0; k < 4; ++k) {
      hn[e][k] = n[k];
      hcol[e][k] = col;
      col += n[k];
    }
  }
  auto head = [&](const Heads& H, int k) {
    return k == 0 ? H.cmu : k == 1 ? H.clv : k == 2 ? H.smu : H.slv;
  };
  // the latents a decode pass reads
  const float* zs_of[2][2] = {{w.zs[0], w.zs[1]}, {w.zsu[0], w.zsu[1]}};
  const float* zc_of[2][2] = {{w.zc, w.zc}, {w.zcu[0], w.zcu[1]}};
  const long long row_tiles = (b + kTile - 1) / kTile;

  switch (ph.kind) {
    case kEncFwd: {  // relu(in W_i + b_i) [* mask]
      const int i = ph.layer;
      for (int p = 0; p < NP; ++p) {
        for (int e = 0; e < 2; ++e) {
          const float* in = i == 0 ? x[e] : w.h[p][e][i - 1];
          const int K = i == 0 ? d[e] : h;
          auto* q = T.add(b, h, 0, 0, w.h[p][e][i], h, step::kBiasRelu,
                          P + L.enc[e].b[i], nullptr, 0,
                          mask_at(a, p, 0, e, i), ldm);
          T.add_segment(q, in, K, P + L.enc[e].W[i], h, K);
          if (q != nullptr) {
            if (i == 0) q->step_A = x_step[e];
            q->step_mask = mask_step;
          }
        }
      }
      break;
    }
    case kHeadsFwd:
      for (int p = 0; p < NP; ++p) {
        for (int e = 0; e < 2; ++e) {
          const NetLayout& E = L.enc[e];
          for (int k = 0; k < 4; ++k) {
            auto* q = T.add(b, hn[e][k], 0, 0, head(w.heads[p][e], k),
                            hn[e][k], step::kBias, P + E.bout + hcol[e][k]);
            T.add_segment(q, w.h[p][e][nE - 1], h, P + E.Wout + hcol[e][k],
                          E.n_out, h);
          }
        }
      }
      break;
    case kDecFwd: {  // the first layer reads zs | zc as two segments
      const int j = ph.layer;
      for (int q = 0; q < Q; ++q) {
        for (int e = 0; e < 2; ++e) {
          const NetLayout& D = L.dec[e];
          auto* pr = T.add(b, h, 0, 0, w.hd[q][e][j], h, step::kBiasRelu,
                           P + D.b[j], nullptr, 0, mask_at(a, q, 1, e, j),
                           ldm);
          if (j == 0) {
            T.add_segment(pr, zs_of[q][e], s[e], P + D.W[0], h, s[e]);
            T.add_segment(pr, zc_of[q][e], cd,
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
      // (kSampleLoss), taken by one task
      for (int q = 0; q < Q; ++q) {
        for (int e = 0; e < 2; ++e) {
          const NetLayout& D = L.dec[e];
          const int ldb = D.n_out;
          for (int half = S.sample ? 1 : 0; half >= 0; --half) {
            const long long col = half ? d[e] : 0;  // lv columns, loc columns
            step::Problem* pr;
            if (half) {
              pr = T.add(b, d[e], 0, 0, w.lv[q][e], d[e], step::kBias,
                         P + D.bout + col);
            } else {
              pr = T.add(b, d[e], 0, 0, w.g_out[q][e], D.n_out,
                         S.sample ? step::kSampleLoss : step::kDecLoss,
                         P + D.bout, x[e], d[e]);
            }
            if (nD == 0) {
              T.add_segment(pr, zs_of[q][e], s[e], P + D.Wout + col, ldb,
                            s[e]);
              T.add_segment(pr, zc_of[q][e], cd,
                            P + D.Wout + static_cast<long long>(s[e]) * ldb +
                                col,
                            ldb, cd);
            } else {
              T.add_segment(pr, w.hd[q][e][nD - 1], h, P + D.Wout + col, ldb,
                            h);
            }
            if (pr != nullptr && !half) {
              pr->step_aux = x_step[e];
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
        for (int e = 0; e < 2; ++e) {
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
        float* gin[2][2];
        int n[2];
        long long Woff[2];
        for (int e = 0; e < 2; ++e) {
          n[e] = L.dec[e].n_out;
          Woff[e] = L.dec[e].Wout;
          for (int q = 0; q < 2; ++q) gin[q][e] = w.g_out[q][e];
        }
        z_layer_problems(a, w, gin, n, Woff, T);
      }
      break;
    case kDecBwd: {  // dW_j and g of layer j - 1
      const int j = ph.layer;
      for (int e = 0; e < 2; ++e) {
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
      float* gin[2][2];
      const int n[2] = {h, h};
      const long long Woff[2] = {L.dec[0].W[0], L.dec[1].W[0]};
      for (int e = 0; e < 2; ++e) {
        for (int q = 0; q < 2; ++q) gin[q][e] = w.g_hd[q][e][0];
      }
      z_layer_problems(a, w, gin, n, Woff, T);
      break;
    }
    case kHeadsBwd:
      // head weight grads (both encodings in one sum), and per encoding the
      // last layer's g = (sum_k g_head_k W_k^T) * mask * (h > 0)
      for (int e = 0; e < 2; ++e) {
        const NetLayout& E = L.enc[e];
        for (int k = 0; k < 4; ++k) {
          auto* pr = T.add(h, hn[e][k], 1, 0, G + E.Wout + hcol[e][k],
                           E.n_out);
          for (int p = 0; p < NP; ++p) {
            T.add_segment(pr, w.h[p][e][nE - 1], h, head(w.g_heads[p][e], k),
                          hn[e][k], b);
          }
        }
        for (int p = 0; p < NP; ++p) {
          auto* pr = T.add(b, h, 0, 1, w.g_h[p][e][nE - 1], h,
                           step::kReluMask, nullptr, w.h[p][e][nE - 1], h,
                           mask_at(a, p, 0, e, nE - 1), ldm);
          for (int k = 0; k < 4; ++k) {
            T.add_segment(pr, head(w.g_heads[p][e], k), hn[e][k],
                          P + E.Wout + hcol[e][k], E.n_out, hn[e][k]);
          }
          if (pr != nullptr) pr->step_mask = mask_step;
        }
      }
      break;
    case kEncBwd: {  // dW_i and g of layer i - 1
      const int i = ph.layer;
      for (int e = 0; e < 2; ++e) {
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
      for (int e = 0; e < 2; ++e) {
        const NetLayout& E = L.enc[e];
        auto* pr = T.add(d[e], h, 1, 0, G + E.W[0], h);
        for (int p = 0; p < NP; ++p) {
          T.add_segment(pr, x[e], d[e], w.g_h[p][e][0], h, b);
        }
        if (pr != nullptr) pr->step_A = x_step[e];
        for (int k = 0; k < 4; ++k) {
          C.add(head(w.g_heads[0][e], k), b, hn[e][k],
                G + E.bout + hcol[e][k],
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
  switch (ph.kind) {
    case kLatentFwd: return latent_fwd_tasks(S.b);
    case kLatentBwd: return latent_bwd_tasks(S.b, S.cd, S.s[0], S.s[1]);
    case kOutBwd: return (S.d[0] + S.d[1] + kCombineCols - 1) / kCombineCols;
    case kHeadsBwd: return 1;
    case kLast: return C.total_chunks;
    default: return 0;
  }
}

// The product tasks of a phase: its tiles, or under a per-sample scale the
// output phase's loc tiles (each also computes its log-variance tile).
__host__ __device__ inline int product_tasks(const PhaseDesc& ph,
                                             const StepParams& a,
                                             const step::GemmTable& T) {
  return ph.kind == kOutFwd && a.S.sample ? T.total_tiles / 2
                                          : T.total_tiles;
}

// The tensors of the older phases, whose Adam update rides on the last
// phase: [begin[r], end[r]). The last phase produces the encoders' first
// layer kernels and every hidden and head bias.
struct Ranges {
  long long begin[kMaxRanges], end[kMaxRanges];
  int count;
};

__host__ __device__ Ranges older_ranges(const Shape& S, const Layout& L) {
  Ranges r;
  r.count = 0;
  for (int e = 0; e < 2; ++e) {
    const NetLayout& E = L.enc[e];
    for (int i = 1; i < S.n_enc; ++i) {
      r.begin[r.count] = E.W[i];
      r.end[r.count++] = E.b[i];
    }
    r.begin[r.count] = E.Wout;
    r.end[r.count++] = E.bout;
  }
  for (int e = 0; e < 2; ++e) {
    const NetLayout& D = L.dec[e];
    for (int j = 0; j < S.n_dec; ++j) {
      r.begin[r.count] = D.W[j];
      r.end[r.count++] = D.b[j];
    }
    r.begin[r.count] = D.Wout;  // Wout, bout and out_logvar
    r.end[r.count++] = D.end;
  }
  return r;
}

constexpr int kStages = 3;  // slices of a k-group in flight or in use
using Smem = step::GemmSmem<kStages>;

// The launch's tables, in dynamic shared memory after the product stages
// (above the 48 KB a block may declare statically).
struct Tables {
  step::Problem prob[kPoolProblems];
  step::GemmTable tab[kMaxPhases];
  PhaseDesc phases[kMaxPhases];
  int n_phases;
  step::ColSum cs[kColSums];
  step::ColSumTable cst;
  Layout layout;
  Work work;
  LatentArgs lat;
  Ranges older;
  float sums[kParts + 4];
};

constexpr int kSmemBytes = static_cast<int>(sizeof(Smem) + sizeof(Tables));

// The latents' view of the workspace.
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

// One combine task: kCombineCols output columns, a thread per column, the
// row tiles' partials added in row-tile order (for poe the first decode's,
// then the unimodal decode's: the gradients are the two passes' sums).
__device__ void combine_task(const StepParams& a, const Layout& L,
                             const Work& w, int task) {
  const Shape& S = a.S;
  const int c = task * kCombineCols + threadIdx.x;
  if (c >= S.d[0] + S.d[1]) return;
  const int e = c < S.d[0] ? 0 : 1;
  const int d = S.d[e];
  const int cc = e == 0 ? c : c - S.d[0];
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
    w.nll_col[u * (S.d[0] + S.d[1]) + c] = acc_n;
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

// Under a per-sample scale, one output task: the log-variance tile, then
// the loc tile, whose kSampleLoss epilogue reads what this block just stored
// (the block barrier at the end of gemm_tile makes it visible).
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
  step::gemm_tile(T.p[pi + 1], tile, step, sm);
}

__host__ __device__ constexpr int n_phases_of(int n_enc, int n_dec) {
  return 2 * (n_enc + n_dec) + 6;
}

__global__ void __launch_bounds__(step::kGemmThreads)
generic_steps_kernel(const __grid_constant__ StepParams a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(dynamic_smem);
  Tables& tb = *reinterpret_cast<Tables*>(dynamic_smem + sizeof(Smem));
  if (threadIdx.x == 0) {
    tb.layout = make_layout(a.S);
    tb.work = carve(a.work, a.S, a.enc_passes, a.dec_passes);
    tb.cst.reset(tb.cs, kColSums);
    tb.lat = latent_args(a, tb.work);
    tb.older = older_ranges(a.S, tb.layout);
    tb.n_phases = phase_list(a.S.n_enc, a.S.n_dec, tb.phases);
    int first = 0;
    for (int ph = 0; ph < tb.n_phases; ++ph) {
      const int cap = phase_cap(tb.phases[ph], a);
      tb.tab[ph].reset(tb.prob + first, cap);
      first += cap;
    }
  }
  __syncthreads();
  // one thread per phase builds that phase's table
  for (int ph = threadIdx.x / 32; ph < tb.n_phases; ph += kWarps) {
    if (threadIdx.x % 32 == 0) {
      build_phase(tb.phases[ph], a, tb.layout, tb.work, tb.tab[ph], tb.cst);
    }
  }
  __syncthreads();
  const int n_phases = tb.n_phases;
  const int n_met = n_metrics(a.method);

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
    for (int ph = 0; ph < n_phases; ++ph) {
      const PhaseDesc desc = tb.phases[ph];
      const step::GemmTable& T = tb.tab[ph];
      const int tiles = product_tasks(desc, a, T);
      const int tasks = tiles + extra_tasks(desc, a, tb.cst);
      const bool pairs = desc.kind == kOutFwd && a.S.sample;
      // the last phase's gradients take their Adam update where they are
      // produced: every reader of the params in this step is done
      const step::AdamAt* adam =
          a.adam && desc.kind == kLast ? &adam_at : nullptr;
      for (int task = blockIdx.x; task < tasks; task += gridDim.x) {
        if (task < tiles) {
          if (pairs) {
            output_pair(T, task, step, sm);
          } else {
            int tile = task;
            const step::Problem& P = T.find(tile);
            step::gemm_tile(P, tile, step, sm, adam);
          }
        } else if (desc.kind == kLatentFwd) {
          latent_fwd_task(tb.lat, noise, task - tiles);
        } else if (desc.kind == kLatentBwd) {
          latent_bwd_task(tb.lat, noise, task - tiles);
        } else if (desc.kind == kOutBwd) {
          combine_task(a, tb.layout, tb.work, task - tiles);
        } else if (desc.kind == kHeadsBwd) {
          metrics_task(tb.lat, a.metrics + static_cast<long long>(step) * n_met,
                       tb.sums);
        } else {
          int chunk = task - tiles;
          const step::ColSum& S = tb.cst.find(chunk);
          step::colsum_chunk(S, chunk, sm.colred[0], adam);
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

bool valid_shape(const Shape& S) {
  return S.b >= 1 && S.d[0] >= 1 && S.d[1] >= 1 && S.h >= 1 && S.cd >= 1 &&
         S.s[0] >= 1 && S.s[1] >= 1 && S.n_enc >= 1 && S.n_enc <= kMaxDepth &&
         S.n_dec >= 0 && S.n_dec <= kMaxDepth;
}

// The largest task count of any phase (more blocks than that only wait),
// or -1 when a table overflows.
int max_phase_tasks(const StepParams& a) {
  const Layout L = make_layout(a.S);
  const Work w = carve(a.work, a.S, a.enc_passes, a.dec_passes);
  PhaseDesc phases[kMaxPhases];
  const int n = phase_list(a.S.n_enc, a.S.n_dec, phases);
  step::Problem prob[kPoolProblems];
  step::ColSum cs[kColSums];
  step::ColSumTable C;
  C.reset(cs, kColSums);
  int most = 0, used = 0;
  for (int ph = 0; ph < n; ++ph) {
    step::GemmTable T;
    const int cap = phase_cap(phases[ph], a);
    used += cap;
    T.reset(prob, cap);
    build_phase(phases[ph], a, L, w, T, C);
    if (T.overflow || C.overflow || used > kPoolProblems) return -1;
    const int tasks = product_tasks(phases[ph], a, T) +
                      extra_tasks(phases[ph], a, C);
    if (tasks > most) most = tasks;
  }
  return most;
}

int grid_blocks(const StepParams& a, int* blocks) {
  const Shape& S = a.S;
  return step::cooperative_grid(
      generic_steps_kernel, kSmemBytes,
      {S.b, S.d[0], S.d[1], S.h, S.cd, S.s[0], S.s[1], S.n_enc, S.n_dec,
       S.sample, a.method, a.enc_passes},
      [&] { return max_phase_tasks(a); }, blocks);
}

int launch_steps(const StepParams& a, cudaStream_t stream) {
  if (a.method < kJointElbo || a.method > kPoe || !valid_shape(a.S) ||
      a.n_steps < 1 || (!a.adam && a.n_steps != 1)) {
    return cudaErrorInvalidValue;
  }
  int blocks = 0;
  const int rc = grid_blocks(a, &blocks);
  if (rc != 0) return rc;
  StepParams params = a;
  void* args[] = {&params};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(generic_steps_kernel), dim3(blocks),
      dim3(step::kGemmThreads), args, kSmemBytes, stream));
}

StepParams sizes_only(int method, int has_masks, const Shape& S) {
  StepParams a = {};
  a.n_steps = 1;
  a.method = method;
  a.S = S;
  a.dec_passes = method == kPoe ? 2 : 1;
  a.enc_passes = (method == kPoe && has_masks) ? 2 : 1;
  return a;
}

}  // namespace

extern "C" {

int generic_step_max_depth() { return kMaxDepth; }

long long generic_step_param_floats(int d1, int d2, int h, int cd, int s1,
                                    int s2, int n_enc, int n_dec,
                                    int sample_scale) {
  const Shape S{1, {d1, d2}, h, cd, {s1, s2}, n_enc, n_dec, sample_scale};
  if (!valid_shape(S)) return -1;
  return make_layout(S).total;
}

long long generic_step_workspace_floats(int method, int has_masks, int b,
                                        int d1, int d2, int h, int cd, int s1,
                                        int s2, int n_enc, int n_dec,
                                        int sample_scale) {
  const Shape S{b, {d1, d2}, h, cd, {s1, s2}, n_enc, n_dec, sample_scale};
  if (!valid_shape(S)) return -1;
  const StepParams a = sizes_only(method, has_masks, S);
  return carve(nullptr, S, a.enc_passes, a.dec_passes).total;
}

// Phases of one step at these depths (a launch given phase_times stamps
// the start of each step and the end of each phase).
int generic_step_phases(int n_enc, int n_dec) {
  return n_phases_of(n_enc, n_dec);
}

// Grid barriers per step of a launch (adam: with the in-kernel update).
int generic_step_barriers(int n_enc, int n_dec, int adam) {
  return n_phases_of(n_enc, n_dec) - (adam ? 0 : 1);
}

// Blocks of the cooperative grid at these sizes on the current device
// (negative: minus a CUDA error code).
int generic_step_grid_blocks(int method, int has_masks, int b, int d1,
                             int d2, int h, int cd, int s1, int s2,
                             int n_enc, int n_dec, int sample_scale) {
  const Shape S{b, {d1, d2}, h, cd, {s1, s2}, n_enc, n_dec, sample_scale};
  if (!valid_shape(S)) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int rc = grid_blocks(sizes_only(method, has_masks, S), &blocks);
  return rc != 0 ? -rc : blocks;
}

// One step on `stream`, in one cooperative launch: grads (flat, the params'
// layout) and the metrics from the flat params; params are not touched.
// method: 0 joint_elbo, 1 moe, 2 jsd, 3 poe. `masks` is null (no dropout)
// or the keep masks in the order of the header, mask k at masks + k *
// mask_stride, each [B, h] with row stride ld_mask. learn_scale freezes the
// per-feature out_logvar when 0 (its gradient is then 0); the per-sample
// scale always learns. Returns the first CUDA error (0 on success).
// Synchronizes nothing and allocates nothing: `work` holds
// generic_step_workspace_floats(...) floats.
int generic_step_launch(const float* params, float* grads, float* metrics,
                        const float* x1, const float* x2, const float* noise,
                        int ld_noise, const float* masks,
                        long long mask_stride, int ld_mask, float* work,
                        int method, int b, int d1, int d2, int h, int cd,
                        int s1, int s2, int n_enc, int n_dec,
                        int sample_scale, float beta, float beta_style,
                        float beta_content, int learn_scale,
                        void* stream_ptr) {
  const Shape S{b, {d1, d2}, h, cd, {s1, s2}, n_enc, n_dec, sample_scale};
  StepParams a = sizes_only(method, masks != nullptr, S);
  // n = 1 and Adam off: the params are only read
  a.params = const_cast<float*>(params);
  a.grads = grads;
  a.metrics = metrics;
  a.work = work;
  a.x1 = x1;
  a.x2 = x2;
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
// updated in place): x1s [n, b, d1], x2s [n, b, d2], noise [n, b, w] (w as
// for one step of the method) and masks [n, n_masks, b, h] (null for no
// dropout) contiguous, metrics [n, 17 | 19] (method_metric_names order),
// grads a scratch buffer of the params' size. The Adam scalars are float32
// as in flat_adam_launch. phase_times is null, or takes n x
// (generic_step_phases + 1) device timestamps in ns (tracing). Returns the
// first CUDA error (0 on success); synchronizes and allocates nothing.
int generic_epoch_launch(float* params, float* mu, float* nu, float* grads,
                         float* metrics, const float* x1s, const float* x2s,
                         const float* noise, const float* masks, float* work,
                         int n, int method, int b, int d1, int d2, int h,
                         int cd, int s1, int s2, int n_enc, int n_dec,
                         int sample_scale, float beta, float beta_style,
                         float beta_content, int learn_scale,
                         long long count, float lr, float b1, float b2,
                         float one_minus_b1, float one_minus_b2, float log_b1,
                         float log_b2, float eps,
                         unsigned long long* phase_times, void* stream_ptr) {
  const Shape S{b, {d1, d2}, h, cd, {s1, s2}, n_enc, n_dec, sample_scale};
  StepParams a = sizes_only(method, masks != nullptr, S);
  const int width = (cd + s1 + s2) + (method == kPoe ? 2 * cd + s1 + s2 : 0);
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
  a.masks = masks;
  a.mask_stride = mask_floats;
  a.ld_mask = h;
  if (masks != nullptr) {
    a.mask_step = 2LL * (n_enc + n_dec) * a.enc_passes * mask_floats;
  }
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

const char* generic_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
