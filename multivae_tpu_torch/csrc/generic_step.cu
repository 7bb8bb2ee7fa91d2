// One train step of a full complete batch for an architecture of any depth:
// encoder and decoder layer stacks around the methods' latent math, forward
// and hand-derived backward, for Hopper (sm_90a).
//
// Replaces the step inside multivae_tpu/ops/fused_generic.py::
// make_generic_fused_epoch (its inner `kernel`): jax.value_and_grad of
// model.apply + total_loss traced into the TPU kernel for whatever model the
// config builds. CUDA cannot trace a model into a kernel, so this is the same
// function written by hand with the depths as launch arguments (pinned to
// jax.value_and_grad through the plain version, multivae_tpu_torch/ops/
// fused_generic.py::generic_fwd_bwd_reference). One body serves every depth:
// n_enc in [1, kMaxDepth] hidden layers per encoder, n_dec in [0, kMaxDepth]
// per decoder, and three output-scale modes: a learned or a frozen
// per-feature out_logvar, or (sample_scale) the out_heads projection to
// loc | logvar per sample, whose weight gradient takes [g_loc | g_lv] as one
// right-hand side. Methods: joint_elbo, moe, jsd, poe (latent_common.cuh).
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
// Launches per step, all on one stream from one C entry point:
// n_enc + passes (encoders, heads) + 1 (latents) + n_dec + 1 (decoders,
// output) + 1 (column pass) + max(n_dec, 1) + [n_dec > 0] (decoder backward)
// + 1 (latents) + 1 + n_enc (heads, encoders backward) + 1 (bias sums) + 1
// (metrics): 13 at n_enc = n_dec = 1, 15 at n_enc = 2. Every product is the
// grouped f32 GEMM of step_common.cuh; no library product, no float atomics,
// every reduction in a fixed order: two runs give the same bits.

#include <initializer_list>

#include "latent_common.cuh"
#include "step_common.cuh"

namespace {

using namespace latent;

constexpr int kMaxDepth = 4;  // hidden layers per network

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
  int n_out;      // columns of the output projection
};

struct Layout {
  NetLayout enc[2], dec[2];
  long long total;
};

Layout make_layout(const Shape& S) {
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
  // the output layer: the residual x - loc [B, d], or with a per-sample
  // scale loc | logvar [B, 2 d]; g_out its gradient [B, n_out]
  float* out[2][2];
  float* g_out[2][2];
  float* part;     // [kParts, B]
  float* nll_col;  // [2, d1 + d2]: first decode, unimodal decode
  long long total;
};

// Carves the workspace (or, with base == nullptr, only counts its floats).
Work carve(float* base, const Shape& S, int enc_passes, int dec_passes) {
  Work w;
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base == nullptr ? nullptr : base + off;
    off += n;
    return p;
  };
  const long long bl = S.b;
  for (int p = 0; p < 2; ++p) {
    for (int e = 0; e < 2; ++e) {
      const long long on = p < enc_passes ? 1 : 0;
      for (int i = 0; i < kMaxDepth; ++i) {
        const long long li = i < S.n_enc ? on : 0;
        w.h[p][e][i] = take(li * bl * S.h);
        w.g_h[p][e][i] = take(li * bl * S.h);
      }
      for (Heads* H : {&w.heads[p][e], &w.g_heads[p][e]}) {
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
      w.out[q][e] = take(on * bl * n_out);
      w.g_out[q][e] = take(on * bl * n_out);
    }
  }
  w.part = take(static_cast<long long>(kParts) * bl);
  w.nll_col = take(2LL * (S.d[0] + S.d[1]));
  w.total = off;
  return w;
}

// One decoder's column pass under a per-sample scale (blockIdx.y picks the
// decoder): per column c of the d features, over the rows in order,
//   r = x - loc, g_loc = -r exp(-lv) / b, g_lv = (0.5 - 0.5 r^2 exp(-lv)) / b
// written as g_out = [g_loc | g_lv] [B, 2 d], their column sums (the bias
// gradient of out_heads) and the column's NLL sum; a second decode of the
// same modality (poe's unimodal pass) adds into the bias gradient and has an
// NLL sum of its own. metrics_kernel then sums the columns.
struct SampleReduce {
  const float* x;     // [b, d]
  const float* both;  // [b, 2 d]: loc | logvar
  float* g_out;       // [b, 2 d]
  float* g_bias;      // [2 d]
  float* nll_col;     // [d]
  int d;
  const float* both2;  // the second decode, or nullptr
  float* g_out2;
  float* nll_col2;
};

struct SampleReduceBatch {
  SampleReduce p[2];
  int b;
};

__global__ void sample_colreduce_kernel(const SampleReduceBatch batch) {
  const SampleReduce& P = batch.p[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.d) return;
  const float bf = static_cast<float>(batch.b);
  const int ld = 2 * P.d;
  float acc_l = 0.0f, acc_v = 0.0f;
  const float* both[2] = {P.both, P.both2};
  float* g_out[2] = {P.g_out, P.g_out2};
  float* nll_col[2] = {P.nll_col, P.nll_col2};
  for (int pass = 0; pass < 2; ++pass) {
    if (both[pass] == nullptr) continue;
    float acc_n = 0.0f;
    for (int row = 0; row < batch.b; ++row) {
      const long long i = static_cast<long long>(row) * ld + c;
      const float lv = both[pass][i + P.d];
      const float rv = P.x[static_cast<long long>(row) * P.d + c] -
                       both[pass][i];
      const float iv = expf(-lv);
      const float q = 0.5f * (rv * rv) * iv;  // 0.5 r^2 iv
      const float gl = -rv * iv / bf;
      const float gv = (0.5f - q) / bf;
      g_out[pass][i] = gl;
      g_out[pass][i + P.d] = gv;
      acc_l += gl;
      acc_v += gv;
      acc_n += 0.5f * step::kLog2Pi + 0.5f * lv + q;
    }
    nll_col[pass][c] = acc_n;
  }
  P.g_bias[c] = acc_l;
  P.g_bias[P.d + c] = acc_v;
}

struct Masks {
  const float* base;  // nullptr without dropout
  long long stride;   // floats between two masks
  int ld, n_enc, n_dec;

  // the keep mask of hidden layer `i` of encoder (dec = 0) or decoder
  // (dec = 1) `e` in pass `p`
  const float* at(int p, int dec, int e, int i) const {
    if (base == nullptr) return nullptr;
    const int idx = p * 2 * (n_enc + n_dec) + (dec ? 2 * n_enc : 0) +
                    e * (dec ? n_dec : n_enc) + i;
    return base + idx * stride;
  }
};

// The backward of a decoder's first layer, whose input is zs | zc: the
// weight gradient's style and content rows (both decode passes in one sum)
// and the gradients of the latents. `gin[q][e]` [B, n] is the gradient of
// the layer's pre-activation in decode pass q, `W[e]` the layer's kernel
// [s + cd, n] at offset `Woff[e]` of params and grads.
cudaError_t z_layer_backward(const Shape& S, const Work& w, int dec_passes,
                             float* gin[2][2], const int n[2],
                             const long long Woff[2], const float* P,
                             float* G, cudaStream_t stream) {
  step::GemmBuilder g;
  const int cd = S.cd;
  for (int e = 0; e < 2; ++e) {
    const int s = S.s[e];
    const long long Ws = Woff[e];
    const long long Wc = Woff[e] + static_cast<long long>(s) * n[e];
    auto* q = g.add(s, n[e], 1, 0, G + Ws, n[e]);  // zs^T gin
    g.add_segment(q, w.zs[e], s, gin[0][e], n[e], S.b);
    if (dec_passes == 2) g.add_segment(q, w.zsu[e], s, gin[1][e], n[e], S.b);
    q = g.add(cd, n[e], 1, 0, G + Wc, n[e]);  // zc^T gin
    g.add_segment(q, w.zc, cd, gin[0][e], n[e], S.b);
    if (dec_passes == 2) g.add_segment(q, w.zcu[e], cd, gin[1][e], n[e], S.b);
    q = g.add(S.b, s, 0, 1, w.g_zs[e], s);  // gin Ws^T
    g.add_segment(q, gin[0][e], n[e], P + Ws, n[e], n[e]);
    if (dec_passes == 2) {
      q = g.add(S.b, s, 0, 1, w.g_zsu[e], s);
      g.add_segment(q, gin[1][e], n[e], P + Ws, n[e], n[e]);
      q = g.add(S.b, cd, 0, 1, w.g_zcu[e], cd);
      g.add_segment(q, gin[1][e], n[e], P + Wc, n[e], n[e]);
    }
  }
  auto* q = g.add(S.b, cd, 0, 1, w.g_zc, cd);  // sum_e gin_e Wc_e^T
  for (int e = 0; e < 2; ++e) {
    const long long Wc = Woff[e] + static_cast<long long>(S.s[e]) * n[e];
    g.add_segment(q, gin[0][e], n[e], P + Wc, n[e], n[e]);
  }
  return g.launch(stream);
}

bool valid_shape(const Shape& S) {
  return S.b >= 1 && S.d[0] >= 1 && S.d[1] >= 1 && S.h >= 1 && S.cd >= 1 &&
         S.s[0] >= 1 && S.s[1] >= 1 && S.n_enc >= 1 && S.n_enc <= kMaxDepth &&
         S.n_dec >= 0 && S.n_dec <= kMaxDepth;
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
  const int dec_passes = method == kPoe ? 2 : 1;
  const int enc_passes = (method == kPoe && has_masks) ? 2 : 1;
  return carve(nullptr, S, enc_passes, dec_passes).total;
}

// One step on `stream`: grads (flat, the params' layout) and the metrics
// from the flat params. method: 0 joint_elbo, 1 moe, 2 jsd, 3 poe. `masks`
// is null (no dropout) or the keep masks in the order of the header, mask k
// at masks + k * mask_stride, each [B, h] with row stride ld_mask.
// learn_scale freezes the per-feature out_logvar when 0 (its gradient is
// then 0); the per-sample scale always learns. Returns the first CUDA error
// (0 on success). Synchronizes nothing and allocates nothing: `work` holds
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
  if (method < kJointElbo || method > kPoe || !valid_shape(S)) {
    return cudaErrorInvalidValue;
  }
  const bool poe = method == kPoe;
  const int Q = poe ? 2 : 1;                        // decode passes
  const int NP = (poe && masks != nullptr) ? 2 : 1;  // encode passes
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Layout L = make_layout(S);
  const Work w = carve(work, S, NP, Q);
  const Masks M{masks, mask_stride, ld_mask, n_enc, n_dec};
  const int* d = S.d;
  const int* s = S.s;
  const float* x[2] = {x1, x2};
  const float* P = params;
  float* G = grads;
  const int nE = n_enc, nD = n_dec;
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
  auto head_ptrs = [](const Heads& H, float* out[4]) {
    out[0] = H.cmu;
    out[1] = H.clv;
    out[2] = H.smu;
    out[3] = H.slv;
  };
  // the latents a decode pass reads
  const float* zs_of[2][2] = {{w.zs[0], w.zs[1]}, {w.zsu[0], w.zsu[1]}};
  const float* zc_of[2][2] = {{w.zc, w.zc}, {w.zcu[0], w.zcu[1]}};

  // 1. encoder stacks, one launch per layer index: relu(in W + b) [* mask]
  for (int i = 0; i < nE; ++i) {
    step::GemmBuilder g;
    for (int p = 0; p < NP; ++p) {
      for (int e = 0; e < 2; ++e) {
        const float* in = i == 0 ? x[e] : w.h[p][e][i - 1];
        const int K = i == 0 ? d[e] : h;
        auto* q = g.add(b, h, 0, 0, w.h[p][e][i], h, step::kBiasRelu,
                        P + L.enc[e].b[i], nullptr, 0, M.at(p, 0, e, i),
                        ld_mask);
        g.add_segment(q, in, K, P + L.enc[e].W[i], h, K);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 2. encoder heads, one launch per encoding
  for (int p = 0; p < NP; ++p) {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const NetLayout& E = L.enc[e];
      float* out[4];
      head_ptrs(w.heads[p][e], out);
      for (int k = 0; k < 4; ++k) {
        auto* q = g.add(b, hn[e][k], 0, 0, out[k], hn[e][k], step::kBias,
                        P + E.bout + hcol[e][k]);
        g.add_segment(q, w.h[p][e][nE - 1], h, P + E.Wout + hcol[e][k],
                      E.n_out, h);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 3. latents
  LatentArgs la;
  const int up = NP - 1;  // the encoding the unimodal pass reads
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
  la.separate = NP == 2;
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  set_latent_consts(la, method, b, 0, b, cd, s1, s2, noise, ld_noise, beta,
                    beta_style, beta_content);
  const int row_blocks = (b + kRowThreads - 1) / kRowThreads;
  latent_fwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 4. decoder stacks, one launch per layer index; the first layer reads
  //    zs | zc as two segments
  for (int j = 0; j < nD; ++j) {
    step::GemmBuilder g;
    for (int q = 0; q < Q; ++q) {
      for (int e = 0; e < 2; ++e) {
        const NetLayout& D = L.dec[e];
        auto* pr = g.add(b, h, 0, 0, w.hd[q][e][j], h, step::kBiasRelu,
                         P + D.b[j], nullptr, 0, M.at(q, 1, e, j), ld_mask);
        if (j == 0) {
          g.add_segment(pr, zs_of[q][e], s[e], P + D.W[0], h, s[e]);
          g.add_segment(pr, zc_of[q][e], cd,
                        P + D.W[0] + static_cast<long long>(s[e]) * h, h, cd);
        } else {
          g.add_segment(pr, w.hd[q][e][j - 1], h, P + D.W[j], h, h);
        }
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 5. output layer: r = x - (in Wout + bout), or loc | logvar = in Wout +
  //    bout with a per-sample scale
  {
    step::GemmBuilder g;
    for (int q = 0; q < Q; ++q) {
      for (int e = 0; e < 2; ++e) {
        const NetLayout& D = L.dec[e];
        auto* pr = g.add(b, D.n_out, 0, 0, w.out[q][e], D.n_out,
                         sample_scale ? step::kBias : step::kResidual,
                         P + D.bout, sample_scale ? nullptr : x[e], d[e]);
        if (nD == 0) {
          g.add_segment(pr, zs_of[q][e], s[e], P + D.Wout, D.n_out, s[e]);
          g.add_segment(pr, zc_of[q][e], cd,
                        P + D.Wout + static_cast<long long>(s[e]) * D.n_out,
                        D.n_out, cd);
        } else {
          g.add_segment(pr, w.hd[q][e][nD - 1], h, P + D.Wout, D.n_out, h);
        }
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 6. the output's gradient, the output bias' (and out_logvar's) and the
  //    NLL's column sums; poe's two decodes sum into the parameters'
  {
    const int dmax = d[0] > d[1] ? d[0] : d[1];
    dim3 grid((dmax + step::kColThreads - 1) / step::kColThreads, 2);
    if (sample_scale) {
      SampleReduceBatch rb;
      for (int e = 0; e < 2; ++e) {
        float* nll = w.nll_col + (e == 0 ? 0 : d[0]);
        rb.p[e] = SampleReduce{x[e],
                               w.out[0][e],
                               w.g_out[0][e],
                               G + L.dec[e].bout,
                               nll,
                               d[e],
                               poe ? w.out[1][e] : nullptr,
                               poe ? w.g_out[1][e] : nullptr,
                               poe ? nll + d[0] + d[1] : nullptr};
      }
      rb.b = b;
      sample_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    } else {
      step::DecReduceBatch rb;
      for (int e = 0; e < 2; ++e) {
        const NetLayout& D = L.dec[e];
        float* nll = w.nll_col + (e == 0 ? 0 : d[0]);
        rb.p[e] = step::DecReduce{w.out[0][e], P + D.olv, w.g_out[0][e],
                                  G + D.bout,  G + D.olv, nll,
                                  d[e],
                                  poe ? w.out[1][e] : nullptr,
                                  poe ? w.g_out[1][e] : nullptr,
                                  poe ? nll + d[0] + d[1] : nullptr};
      }
      rb.b = b;
      rb.b_total = b;
      rb.learn_scale = learn_scale;
      step::dec_colreduce_kernel<<<grid, step::kColThreads, 0, stream>>>(rb);
    }
    STEP_CHECK(cudaGetLastError());
  }
  // 7. decoder stacks backward. With hidden layers: the output projection's
  //    weight gradient and the last hidden layer's, then layer by layer
  //    down to the first, whose input is zs | zc
  if (nD > 0) {
    {
      step::GemmBuilder g;
      for (int e = 0; e < 2; ++e) {
        const NetLayout& D = L.dec[e];
        auto* pr = g.add(h, D.n_out, 1, 0, G + D.Wout, D.n_out);
        for (int q = 0; q < Q; ++q) {
          g.add_segment(pr, w.hd[q][e][nD - 1], h, w.g_out[q][e], D.n_out, b);
        }
        for (int q = 0; q < Q; ++q) {
          pr = g.add(b, h, 0, 1, w.g_hd[q][e][nD - 1], h, step::kReluMask,
                     nullptr, w.hd[q][e][nD - 1], h, M.at(q, 1, e, nD - 1),
                     ld_mask);
          g.add_segment(pr, w.g_out[q][e], D.n_out, P + D.Wout, D.n_out,
                        D.n_out);
        }
      }
      STEP_CHECK(g.launch(stream));
    }
    for (int j = nD - 1; j >= 1; --j) {
      step::GemmBuilder g;
      for (int e = 0; e < 2; ++e) {
        const NetLayout& D = L.dec[e];
        auto* pr = g.add(h, h, 1, 0, G + D.W[j], h);
        for (int q = 0; q < Q; ++q) {
          g.add_segment(pr, w.hd[q][e][j - 1], h, w.g_hd[q][e][j], h, b);
        }
        for (int q = 0; q < Q; ++q) {
          pr = g.add(b, h, 0, 1, w.g_hd[q][e][j - 1], h, step::kReluMask,
                     nullptr, w.hd[q][e][j - 1], h, M.at(q, 1, e, j - 1),
                     ld_mask);
          g.add_segment(pr, w.g_hd[q][e][j], h, P + D.W[j], h, h);
        }
      }
      STEP_CHECK(g.launch(stream));
    }
  }
  {
    float* gin[2][2];
    int n[2];
    long long Woff[2];
    for (int e = 0; e < 2; ++e) {
      n[e] = nD > 0 ? h : L.dec[e].n_out;
      Woff[e] = nD > 0 ? L.dec[e].W[0] : L.dec[e].Wout;
      for (int q = 0; q < 2; ++q) {
        gin[q][e] = nD > 0 ? w.g_hd[q][e][0] : w.g_out[q][e];
      }
    }
    STEP_CHECK(z_layer_backward(S, w, Q, gin, n, Woff, P, G, stream));
  }
  // 8. head-output grads
  latent_bwd_kernel<<<row_blocks, kRowThreads, 0, stream>>>(la);
  STEP_CHECK(cudaGetLastError());
  // 9. head weight grads (both encodings in one sum), and per encoding the
  //    last hidden layer's g_h = (sum_k g_head_k W_k^T) * mask * (h > 0)
  {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const NetLayout& E = L.enc[e];
      for (int k = 0; k < 4; ++k) {
        auto* pr = g.add(h, hn[e][k], 1, 0, G + E.Wout + hcol[e][k], E.n_out);
        for (int p = 0; p < NP; ++p) {
          float* gh[4];
          head_ptrs(w.g_heads[p][e], gh);
          g.add_segment(pr, w.h[p][e][nE - 1], h, gh[k], hn[e][k], b);
        }
      }
    }
    for (int p = 0; p < NP; ++p) {
      for (int e = 0; e < 2; ++e) {
        const NetLayout& E = L.enc[e];
        float* gh[4];
        head_ptrs(w.g_heads[p][e], gh);
        auto* pr = g.add(b, h, 0, 1, w.g_h[p][e][nE - 1], h, step::kReluMask,
                         nullptr, w.h[p][e][nE - 1], h,
                         M.at(p, 0, e, nE - 1), ld_mask);
        for (int k = 0; k < 4; ++k) {
          g.add_segment(pr, gh[k], hn[e][k], P + E.Wout + hcol[e][k], E.n_out,
                        hn[e][k]);
        }
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 10. encoder stacks backward, layer by layer: dW_i = in^T g_h_i and,
  //     above the first layer (whose input is the data), g_h_{i-1}
  for (int i = nE - 1; i >= 0; --i) {
    step::GemmBuilder g;
    for (int e = 0; e < 2; ++e) {
      const NetLayout& E = L.enc[e];
      const int K = i == 0 ? d[e] : h;
      auto* pr = g.add(K, h, 1, 0, G + E.W[i], h);
      for (int p = 0; p < NP; ++p) {
        const float* in = i == 0 ? x[e] : w.h[p][e][i - 1];
        g.add_segment(pr, in, K, w.g_h[p][e][i], h, b);
      }
      if (i == 0) continue;
      for (int p = 0; p < NP; ++p) {
        pr = g.add(b, h, 0, 1, w.g_h[p][e][i - 1], h, step::kReluMask,
                   nullptr, w.h[p][e][i - 1], h, M.at(p, 0, e, i - 1),
                   ld_mask);
        g.add_segment(pr, w.g_h[p][e][i], h, P + E.W[i], h, h);
      }
    }
    STEP_CHECK(g.launch(stream));
  }
  // 11. bias grads of the heads and of every hidden layer (two passes'
  //     sources one after the other)
  {
    step::ColSumBuilder c;
    for (int e = 0; e < 2; ++e) {
      const NetLayout& E = L.enc[e];
      float *a[4], *u[4];
      head_ptrs(w.g_heads[0][e], a);
      head_ptrs(w.g_heads[1][e], u);
      for (int k = 0; k < 4; ++k) {
        c.add(a[k], b, hn[e][k], G + E.bout + hcol[e][k],
              NP == 2 ? u[k] : nullptr);
      }
      for (int i = 0; i < nE; ++i) {
        c.add(w.g_h[0][e][i], b, h, G + E.b[i],
              NP == 2 ? w.g_h[1][e][i] : nullptr);
      }
      for (int j = 0; j < nD; ++j) {
        c.add(w.g_hd[0][e][j], b, h, G + L.dec[e].b[j],
              Q == 2 ? w.g_hd[1][e][j] : nullptr);
      }
    }
    STEP_CHECK(c.launch(stream));
  }
  // 12. metrics
  MetricArgs ma{w.part, w.nll_col, metrics, method, b,    b,
                d1,     d2,        cd,      s1,     s2,   beta,
                beta_style, beta_content};
  metrics_kernel<<<1, step::kMetricThreads, 0, stream>>>(ma);
  STEP_CHECK(cudaGetLastError());
  return 0;
}

const char* generic_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
