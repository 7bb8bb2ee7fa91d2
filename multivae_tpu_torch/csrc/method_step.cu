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

#include "latent_common.cuh"
#include "step_common.cuh"

namespace {

using namespace latent;

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
  la.zc = w.zc;
  la.g_zc = w.g_zc;
  la.part = w.part;
  set_latent_consts(la, method, b, row_offset, b_total, cd, s1, s2, noise,
                    ld_noise, beta, beta_style, beta_content);
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
