// Avatar-sweep kernel of the Digital Avatars Analysis, for Hopper (sm_90a).
//
// Replaces multivae_tpu/ops/fused_daa.py::_avatar_kernel (the Pallas TPU
// kernel launched by sweep_cells). It computes what that kernel computes,
// not its block layout. For every output row r of n_rows = n_cells * B rows
// (one perturbation cell times one subject; subject i = r mod B):
//
//   h     = relu(x1[r] . Wh + bh)                       clinical encoder
//   cmu1  = h . Wcmu + bcmu,  clv1 = h . Wclv + bclv    content heads
//   t1 = 1/(exp(clv1)+1e-8), t2 = 1/(exp(clv2[i])+1e-8), tp = 1/(1+1e-8)
//   ts = t1 + t2 + tp,  mu_c = (cmu1 t1 + cmu2[i] t2) / ts     PoE + prior
//   zc    = the joint latent by method (sampled: the mixture row partition
//           of subject i plus streamed eps; deterministic: the mixture
//           mean), zs2 = smu2[i] (+ eps * exp(slv2[i] / 2) when sampled)
//   out[r] = zs2 . Wds + zc . Wdc + bd                  ROI decoder
//
// Row partition (fused_step.py:251-255, fused_daa.py:92-137): joint_elbo
// and jsd split the subjects at floor(B/3) and 2 floor(B/3), moe at B/2,
// per row, so a tile may straddle cells. joint_elbo's singleton
// log-variances are log(exp(clv)+1e-8); moe and jsd use the raw clv; jsd's
// third component is the unit expert (mu 0, logvar 0) and its
// deterministic mean divides by 3. eps rows are [content (cd) | style
// (s2)]. Weights stay in the JAX layout [in, out].
//
// What bounds it, at the flagship round (B=50 x 200 samples x 7 scores =
// 70,000 rows; d1 7, h 256, cd 20, s2 20, d2 444): 4.17 GFLOP of f32
// multiply-adds, 62 us at 67 TFLOP/s outside the tensor cores; 124.3 MB of
// avatars written and 11.2 MB of noise read, 41 us at 3.35 TB/s. Operations
// bound it, bytes not far behind. Every product stays an f32 FMA.
//
// Design. The Python wrapper (ops/fused_daa.py, sweep_plan) computes the
// plan -- tile rows, the heads' K splits, resident or chunked weights,
// chunk widths, grid, shared memory -- from the widths alone and passes it
// in; make_layout below and the wrapper's _sweep_floats give the same
// offsets, and the launch refuses a byte count that differs.
// * Persistent grid: one block of kThreads per SM walks the row tiles
//   tile = blockIdx.x + k gridDim.x. It copies the weights into shared
//   memory once (cp.async, 16 bytes a copy where both sides are 16-byte
//   aligned row by row, else 4), so a sweep reads ~16 MB of weights from
//   L2 (one copy per SM) where one block per 16 rows read ~520 MB.
// * Row tiles (32 rows at the flagship widths): the tile's inputs, hidden
//   activations, head partials and latents stay in shared memory; the next
//   tile's clinical and noise rows arrive by cp.async while this one
//   computes. Budget at the flagship widths, 197,648 of 232,448 bytes:
//   weights 122,128 (Wh 7x256, bh, [Wcmu|Wclv] 256x40, its bias,
//   [Wds;Wdc] 40x444, bd), inputs 2 x 6,016 (32 rows x (7 + 40) floats,
//   double-buffered), hidden h^T 32,768 (the latents z^T reuse it), head
//   partials 6 splits x 40 x 32 floats 30,720.
// * Register-tiled products: each thread owns a micro-tile of 4 rows
//   (decoder 8) x 4 columns with one accumulator per output, the k loop
//   innermost and unrolled. The activations are stored transposed
//   ([k][row]: x^T as it arrives, h^T, z^T), so both operands are 16-byte
//   shared loads: a load feeds 8 FMAs (decoder 10.7), where the
//   tile-per-block kernel fed each FMA a load. The heads, 80 micro-tiles of
//   K 256, are split in K over the block (6 splits of 43 at the flagship
//   widths, added in split order by the latents), so 480 of 512 threads
//   work where 80 would; the decoder's 444 columns are 111 float4 columns
//   x 4 row groups, 444 tasks in one pass of 512 threads. The avatars leave
//   as float4 streaming stores (__stcs; 124 MB exceeds the 50 MB L2),
//   coalesced across threads.
// * One order for every sum: each output's sums run over k in a fixed
//   order set by the plan, which depends on the widths alone; no split-K
//   across blocks, no atomics. An element's bits do not depend on gridDim,
//   on the tile it falls in, or on how the cells are sliced over launches.
// * exp and log run on the latent phase alone (R x (s2 + cd) elements), out
//   of the product loops.
// * Widths whose weights do not fit whole beside a tile of 16 rows or more
//   (hidden 1024, a decoder of thousands of columns) stage them per tile in
//   chunks -- of hidden columns, of the heads' K, of decoder columns --
//   through one staging region; the sums keep the resident plan's order.
//   Tile rows shrink to 16, 8 or 4 where the tile itself is wide. Each kind
//   of plan has its own kernel instance, so a tile's loop holds only the
//   code its plan runs.
// * What is left (PERF.md, the table's row 1): four barriers a tile
//   (inputs, hidden, heads, latents) serialise short phases; the products
//   run at 35-40 % of the f32 FMA rate, each thread with one short task a
//   phase; the latents are a latency-bound chain of exp, log and divisions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"  // cp_async16, cp_async4, commit, wait

namespace {

using step::cp_async16;
using step::cp_async4;
using step::cp_async_commit;
using step::cp_async_wait;

constexpr int kThreads = 512;  // threads per block (fused_daa.py SWEEP_THREADS)
// a thread's micro-tile (rows x columns) in the heads (its shape sets
// fused_daa.py _splits) and the decoder (4 rows where a tile's rows are not
// a multiple of 8)
constexpr int kHeadRows = 4, kHeadCols = 4;
constexpr int kDecRows = 8, kDecCols = 4;
constexpr float kPoeEps = 1e-8f;

enum Method { kJointElbo = 0, kMoe = 1, kJsd = 2, kPoe = 3 };

// Tracing phases: the tile's inputs and barrier, the hidden layer, the
// heads, the latents, the decoder (fused_daa.py SWEEP_PHASES).
constexpr int kPhases = 5;

struct Plan {
  int rows;      // rows per tile, a multiple of 4
  int split;     // K splits of the content heads
  int resident;  // weights copied once per block, else staged in chunks
  int h_chunk;   // chunked: hidden columns per chunk (a multiple of 4)
  int k_chunk;   // chunked: rows of [Wcmu|Wclv] per chunk
  int n_chunk;   // chunked: decoder columns per chunk (a multiple of 4)
};

struct SweepArgs {
  const float* cdata;  // [n_rows, d1]
  const float* eps;    // [n_rows, cd + s2]
  const float* Wh;     // [d1, h]
  const float* bh;     // [h]
  const float* Wcmu;   // [h, cd]
  const float* bcmu;   // [cd]
  const float* Wclv;   // [h, cd]
  const float* bclv;   // [cd]
  const float* Wds;    // [s2, d2]
  const float* Wdc;    // [cd, d2]
  const float* bd;     // [d2]
  const float* cmu2;   // [b, cd]
  const float* clv2;   // [b, cd]
  const float* smu2;   // [b, s2]
  const float* slv2;   // [b, s2]
  float* out;          // [n_rows, d2]
  long long* clocks;   // tracing: [gridDim.x, kPhases] cycles, or null
  int64_t n_rows;
  int b, d1, h, cd, s2, d2;
  int method, sample_latents;
  int k1, k2, kh;      // mixture row bounds
  Plan plan;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Offsets of the shared-memory regions, in floats, each a multiple of 4.
struct Layout {
  int h4;          // h rounded up to 4 (zero-padded hidden columns)
  int cp, dp;      // 2 cd and d2 rounded up to 4 (zero-padded columns)
  int kd, ew;      // decoder depth s2 + cd; noise width cd + s2
  int in_eps;      // in an input buffer: x^T [d1, rows], then eps [rows, ew]
  int in_size;     // one input buffer (two: the tile's and the next one's)
  int act;         // h^T [h4, rows]; after the heads z^T [kd, rows]
  int part;        // head partials [split, cp, rows]
  int wh, bh, wc, wd, bd;  // resident: Wh [d1, h4], bh, [Wcmu|Wclv] [h, cp],
                           // [Wds; Wdc] [kd, dp], bd
  int bc;          // [bcmu|bclv] [cp], both modes
  int stage;       // chunked: one chunk of one phase's weights
  int total;
};

__host__ __device__ inline Layout make_layout(int d1, int h, int cd, int s2,
                                              int d2, const Plan& p) {
  Layout L;
  L.h4 = round4(h);
  L.cp = round4(2 * cd);
  L.dp = round4(d2);
  L.kd = s2 + cd;
  L.ew = cd + s2;
  L.in_eps = round4(p.rows * d1);
  L.in_size = L.in_eps + round4(p.rows * L.ew);
  L.act = 2 * L.in_size;
  L.part = L.act + imax(L.h4, L.kd) * p.rows;
  const int w = L.part + p.split * L.cp * p.rows;
  if (p.resident) {
    L.wh = w;
    L.bh = L.wh + d1 * L.h4;
    L.wc = L.bh + L.h4;
    L.bc = L.wc + h * L.cp;
    L.wd = L.bc + L.cp;
    L.bd = L.wd + L.kd * L.dp;
    L.stage = L.bd + L.dp;
    L.total = L.stage;
  } else {
    L.wh = L.bh = L.wc = L.wd = L.bd = -1;
    L.bc = w;
    L.stage = L.bc + L.cp;
    L.total = L.stage + imax(imax(d1 * p.h_chunk + p.h_chunk,
                                  p.k_chunk * L.cp),
                             L.kd * p.n_chunk + p.n_chunk);
  }
  return L;
}

// Stages rows x cols floats (row strides src_ld, dst_ld) into shared memory
// by cp.async, 16 bytes a copy where every row starts 16-byte aligned on
// both sides, else 4; zeros columns [cols, pad_cols) of each row.
__device__ void stage_block(float* dst, int dst_ld, const float* src,
                            int64_t src_ld, int rows, int cols,
                            int pad_cols) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0 &&
      ((src_ld & 3) | (dst_ld & 3) | (cols & 3)) == 0;
  if (vec) {
    const int q = cols >> 2;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int r = i / q;
      const int c = (i - r * q) << 2;
      cp_async16(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols;
      const int c = i - r * cols;
      cp_async4(dst + r * dst_ld + c, src + r * src_ld + c);
    }
  }
  const int pad = pad_cols - cols;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * dst_ld + cols + (i - r * pad)] = 0.0f;
  }
}

// The clinical rows of a tile, transposed (x^T [d1, rows], 4 bytes a
// copy) and, when sampled, its noise rows.
__device__ void stage_inputs(float* buf, const Layout& L, const SweepArgs& a,
                             int64_t tile) {
  const int R = a.plan.rows;
  const int64_t row0 = tile * R;
  const int64_t left = a.n_rows - row0;
  const int valid = left < R ? static_cast<int>(left) : R;
  const float* x = a.cdata + row0 * a.d1;
  for (int i = threadIdx.x; i < valid * a.d1; i += kThreads) {
    const int r = i / a.d1;
    cp_async4(buf + (i - r * a.d1) * R + r, x + i);
  }
  if (a.sample_latents) {
    const int ne = valid * L.ew;
    stage_block(buf + L.in_eps, ne, a.eps + row0 * L.ew, ne, 1, ne, ne);
  }
}

// N consecutive floats of shared memory, 16 bytes a load.
template <int N>
__device__ __forceinline__ void load_frag(float (&f)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * q);
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

template <int MR, int NC>
__device__ __forceinline__ void outer_fma(float (&acc)[MR][NC],
                                          const float (&x)[MR],
                                          const float (&w)[NC]) {
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(x[i], w[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{k < n} x[k lx + i] w[k lw + j], k ascending.
template <int MR, int NC>
__device__ __forceinline__ void micro_product(float (&acc)[MR][NC],
                                              const float* x, int lx,
                                              const float* w, int lw, int n) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float xk[MR], wk[NC];
    load_frag(xk, x + k * lx);
    load_frag(wk, w + k * lw);
    outer_fma(acc, xk, wk);
  }
}

// Hidden columns [j0, j0 + ncols) of the tile: hT[j][r] = relu(bias[j] +
// sum_k x[r][k] W[k][j]), k ascending. A task is 4 rows x 4 columns, the
// row group fastest so that a warp's transposed stores are contiguous.
__device__ void hidden_chunk(float* hT, const float* xT, const float* W,
                             int ldw, const float* bias, int j0, int ncols,
                             int rows, int d1) {
  const int nrg = rows >> 2;
  const int ncg = ncols >> 2;
  for (int t = threadIdx.x; t < nrg * ncg; t += kThreads) {
    const int rg = t % nrg;
    const int cg = t / nrg;
    float b4[4];
    load_frag(b4, bias + 4 * cg);
    float acc[4][4];  // [row][column]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = b4[j];
    }
    micro_product(acc, xT + 4 * rg, rows, W + 4 * cg, ldw, d1);
    float* o = hT + (j0 + 4 * cg) * rows + 4 * rg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(o + j * rows) =
          make_float4(fmaxf(acc[0][j], 0.0f), fmaxf(acc[1][j], 0.0f),
                      fmaxf(acc[2][j], 0.0f), fmaxf(acc[3][j], 0.0f));
    }
  }
}

// Head partials over this chunk's rows [k0, k0 + kc) of W = [Wcmu|Wclv]
// (W points at row k0): split s sums k in [s ks, (s + 1) ks) of the chunk,
// ascending, into part[s][c][r]; split 0 starts from the bias. A task is
// MR rows x NC columns of one split, the same thread's in every chunk.
template <int MR, int NC>
__device__ void heads_chunk(float* part, const float* hT, const float* W,
                            const float* bias, int k0, int kc, int h,
                            int rows, int cp, int split) {
  const int nrg = rows / MR;
  const int ncg = cp / NC;
  const int mt = nrg * ncg;
  const int ks = (h + split - 1) / split;
  for (int t = threadIdx.x; t < mt * split; t += kThreads) {
    const int rg = t % nrg;
    const int cg = (t / nrg) % ncg;
    const int s = t / mt;
    const int kb = imax(s * ks, k0);
    const int ke = imin(imin((s + 1) * ks, h), k0 + kc);
    float* P = part + (s * cp + NC * cg) * rows + MR * rg;
    float acc[MR][NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (k0 == 0) {
        const float v = s == 0 ? bias[NC * cg + j] : 0.0f;
#pragma unroll
        for (int i = 0; i < MR; ++i) acc[i][j] = v;
      } else {
        float v[MR];
        load_frag(v, P + j * rows);
#pragma unroll
        for (int i = 0; i < MR; ++i) acc[i][j] = v[i];
      }
    }
    micro_product(acc, hT + kb * rows + MR * rg, rows,
                  W + (kb - k0) * cp + NC * cg, cp, ke - kb);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int q = 0; q < MR / 4; ++q) {
        *reinterpret_cast<float4*>(P + j * rows + 4 * q) =
            make_float4(acc[4 * q][j], acc[4 * q + 1][j], acc[4 * q + 2][j],
                        acc[4 * q + 3][j]);
      }
    }
  }
}

// The joint content latent of one (row, column) element.
__device__ __forceinline__ float joint_content(const SweepArgs& a, int subj,
                                               float cmu1, float clv1,
                                               float cmu2, float clv2,
                                               float eps) {
  const float t1 = 1.0f / (expf(clv1) + kPoeEps);
  const float t2 = 1.0f / (expf(clv2) + kPoeEps);
  const float tp = 1.0f / (1.0f + kPoeEps);
  const float ts = t1 + t2 + tp;
  const float mu_c = (cmu1 * t1 + cmu2 * t2) / ts;
  if (!a.sample_latents) {
    switch (a.method) {
      case kJointElbo: return (cmu1 + cmu2 + mu_c) / 3.0f;
      case kMoe: return (cmu1 + cmu2) / 2.0f;
      case kJsd: return (cmu1 + cmu2) / 3.0f;
      default: return mu_c;
    }
  }
  float mu, lv;
  switch (a.method) {
    case kJointElbo:
      if (subj < a.k1) {
        mu = cmu1; lv = logf(expf(clv1) + kPoeEps);
      } else if (subj < a.k2) {
        mu = cmu2; lv = logf(expf(clv2) + kPoeEps);
      } else {
        mu = mu_c; lv = -logf(ts);
      }
      break;
    case kMoe:
      if (subj < a.kh) { mu = cmu1; lv = clv1; } else { mu = cmu2; lv = clv2; }
      break;
    case kJsd:
      if (subj < a.k1) {
        mu = cmu1; lv = clv1;
      } else if (subj < a.k2) {
        mu = cmu2; lv = clv2;
      } else {
        mu = 0.0f; lv = 0.0f;
      }
      break;
    default:
      mu = mu_c; lv = -logf(ts);
  }
  return mu + eps * expf(0.5f * lv);
}

// Latents z^T[c][r] = [zs2 | zc] of the tile's rows: the heads are the
// partials added in split order, the subject is (row0 + r) mod B per row.
__device__ void latents(float* zT, const float* part, const float* eps_s,
                        const SweepArgs& a, const Layout& L, int rows,
                        int subj0) {
  const int cd = a.cd, s2 = a.s2;
  const int stride = L.cp * rows;
  for (int i = threadIdx.x; i < rows * L.kd; i += kThreads) {
    const int r = i % rows;
    const int c = i / rows;
    int subj = subj0 + r;
    if (subj >= a.b) subj %= a.b;
    const float* e = eps_s + r * L.ew;
    float z;
    if (c < s2) {
      const float mu = __ldg(a.smu2 + subj * s2 + c);
      z = a.sample_latents
              ? mu + e[cd + c] * expf(0.5f * __ldg(a.slv2 + subj * s2 + c))
              : mu;
    } else {
      const int cc = c - s2;
      const float* pm = part + cc * rows + r;
      const float* pl = part + (cd + cc) * rows + r;
      float cmu1 = pm[0], clv1 = pl[0];
      for (int s = 1; s < a.plan.split; ++s) {
        cmu1 += pm[s * stride];
        clv1 += pl[s * stride];
      }
      z = joint_content(a, subj, cmu1, clv1, __ldg(a.cmu2 + subj * cd + cc),
                        __ldg(a.clv2 + subj * cd + cc),
                        a.sample_latents ? e[cc] : 0.0f);
    }
    zT[c * rows + r] = z;
  }
}

// Decoder columns [n0, n0 + ncols) of the tile's valid rows: out[r][n] =
// bias[n] + sum_k z[r][k] W[k][n], k over the style rows then the content
// rows. A task is MR rows x NC columns, the column group fastest so that a
// warp's stores of a row are contiguous; columns from d2 on (the padding)
// are not stored.
template <int MR, int NC>
__device__ void decoder_chunk(float* out, const float* zT, const float* W,
                              int ldw, const float* bias, int n0, int ncols,
                              int rows, int valid, int64_t row0, int kd,
                              int d2, bool vec_out) {
  const int nrg = rows / MR;
  const int ncg = ncols / NC;
  for (int t = threadIdx.x; t < nrg * ncg; t += kThreads) {
    const int cg = t % ncg;
    const int rg = t / ncg;
    float acc[MR][NC];
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(bias + NC * cg + 4 * q);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        acc[i][4 * q] = b4.x;
        acc[i][4 * q + 1] = b4.y;
        acc[i][4 * q + 2] = b4.z;
        acc[i][4 * q + 3] = b4.w;
      }
    }
    micro_product(acc, zT + MR * rg, rows, W + NC * cg, ldw, kd);
    const int col = n0 + NC * cg;
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int r = MR * rg + i;
      if (r < valid) {
        float* o = out + (row0 + r) * d2 + col;
#pragma unroll
        for (int q = 0; q < NC / 4; ++q) {
          if (vec_out) {
            if (col + 4 * q < d2) {
              __stcs(reinterpret_cast<float4*>(o + 4 * q),
                     make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                 acc[i][4 * q + 2], acc[i][4 * q + 3]));
            }
          } else {
#pragma unroll
            for (int j = 4 * q; j < 4 * q + 4; ++j) {
              if (col + j < d2) __stcs(o + j, acc[i][j]);
            }
          }
        }
      }
    }
  }
}

// One instance per kind of plan (resident or chunked weights; 8 or 4 rows
// of a decoder micro-tile), so that a tile's loop holds only the code its
// plan runs.
template <bool kResident, int kDecMR>
__global__ void __launch_bounds__(kThreads, 1)
avatar_sweep_kernel(const SweepArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Plan& p = a.plan;
  const Layout L = make_layout(a.d1, a.h, a.cd, a.s2, a.d2, p);
  const int R = p.rows;
  const int64_t n_tiles = (a.n_rows + R - 1) / R;
  int64_t tile = blockIdx.x;
  if (tile >= n_tiles) return;
  float* act = smem + L.act;
  float* part = smem + L.part;
  float* stage = smem + L.stage;
  const bool vec_out =
      (a.d2 & 3) == 0 && (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;

  // the weights, once per block (resident plans), the heads' bias always
  if (kResident) {
    stage_block(smem + L.wh, L.h4, a.Wh, a.h, a.d1, a.h, L.h4);
    stage_block(smem + L.bh, L.h4, a.bh, a.h, 1, a.h, L.h4);
    stage_block(smem + L.wc, L.cp, a.Wcmu, a.cd, a.h, a.cd, a.cd);
    stage_block(smem + L.wc + a.cd, L.cp, a.Wclv, a.cd, a.h, a.cd,
                L.cp - a.cd);
    stage_block(smem + L.wd, L.dp, a.Wds, a.d2, a.s2, a.d2, L.dp);
    stage_block(smem + L.wd + a.s2 * L.dp, L.dp, a.Wdc, a.d2, a.cd, a.d2,
                L.dp);
    stage_block(smem + L.bd, L.dp, a.bd, a.d2, 1, a.d2, L.dp);
  }
  stage_block(smem + L.bc, L.cp, a.bcmu, a.cd, 1, a.cd, a.cd);
  stage_block(smem + L.bc + a.cd, L.cp, a.bclv, a.cd, 1, a.cd, L.cp - a.cd);
  stage_inputs(smem, L, a, tile);
  cp_async_commit();

  // tracing: thread 0 adds each phase's SM cycles, barrier to barrier (one
  // barrier more a tile, after the decoder)
  long long phase_cycles[kPhases] = {0, 0, 0, 0, 0};
  long long last = clock64();
  const auto mark = [&](int phase) {
    if (a.clocks != nullptr && threadIdx.x == 0) {
      const long long now = clock64();
      phase_cycles[phase] += now - last;
      last = now;
    }
  };
  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    // the next tile's inputs go out before this tile's arrive
    const int64_t next = tile + gridDim.x;
    if (next < n_tiles) {
      stage_inputs(smem + ((it + 1) & 1) * L.in_size, L, a, next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mark(0);
    const float* in = smem + (it & 1) * L.in_size;
    const int64_t row0 = tile * R;
    const int64_t left = a.n_rows - row0;
    const int valid = left < R ? static_cast<int>(left) : R;
    const int subj0 = static_cast<int>(row0 % a.b);

    // 1. hidden layer h^T, by column chunks (one chunk when resident)
    const int jstep = kResident ? L.h4 : p.h_chunk;
    for (int j0 = 0; j0 < L.h4; j0 += jstep) {
      const int nc = imin(jstep, L.h4 - j0);
      const float* W = smem + L.wh + j0;
      const float* bias = smem + L.bh + j0;
      int ldw = L.h4;
      if (!kResident) {
        const int cols = imin(nc, a.h - j0);
        __syncthreads();  // the stage's last readers are done
        stage_block(stage, nc, a.Wh + j0, a.h, a.d1, cols, nc);
        stage_block(stage + a.d1 * nc, nc, a.bh + j0, a.h, 1, cols, nc);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        W = stage;
        bias = stage + a.d1 * nc;
        ldw = nc;
      }
      hidden_chunk(act, in, W, ldw, bias, j0, nc, R, a.d1);
    }
    __syncthreads();

    mark(1);

    // 2. content heads, partials per K split, by K chunks
    const int kstep = kResident ? a.h : p.k_chunk;
    for (int k0 = 0; k0 < a.h; k0 += kstep) {
      const int kc = imin(kstep, a.h - k0);
      const float* W = smem + L.wc + k0 * L.cp;
      if (!kResident) {
        __syncthreads();
        stage_block(stage, L.cp, a.Wcmu + k0 * a.cd, a.cd, kc, a.cd, a.cd);
        stage_block(stage + a.cd, L.cp, a.Wclv + k0 * a.cd, a.cd, kc, a.cd,
                    L.cp - a.cd);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        W = stage;
      }
      heads_chunk<kHeadRows, kHeadCols>(part, act, W, smem + L.bc, k0, kc,
                                        a.h, R, L.cp, p.split);
    }
    __syncthreads();

    mark(2);

    // 3. latents z^T over h^T's space
    latents(act, part, in + L.in_eps, a, L, R, subj0);
    __syncthreads();

    mark(3);

    // 4. ROI decoder, by column chunks, straight to the avatars
    const int nstep = kResident ? L.dp : p.n_chunk;
    for (int n0 = 0; n0 < L.dp; n0 += nstep) {
      const int nc = imin(nstep, L.dp - n0);
      const float* W = smem + L.wd + n0;
      const float* bias = smem + L.bd + n0;
      int ldw = L.dp;
      if (!kResident) {
        const int cols = imin(nc, a.d2 - n0);
        __syncthreads();
        stage_block(stage, nc, a.Wds + n0, a.d2, a.s2, cols, nc);
        stage_block(stage + a.s2 * nc, nc, a.Wdc + n0, a.d2, a.cd, cols, nc);
        stage_block(stage + L.kd * nc, nc, a.bd + n0, a.d2, 1, cols, nc);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        W = stage;
        bias = stage + L.kd * nc;
        ldw = nc;
      }
      decoder_chunk<kDecMR, kDecCols>(a.out, act, W, ldw, bias, n0, nc, R,
                                      valid, row0, L.kd, a.d2, vec_out);
    }
    if (a.clocks != nullptr) {
      __syncthreads();
      mark(4);
    }
  }
  if (a.clocks != nullptr && threadIdx.x == 0) {
    for (int q = 0; q < kPhases; ++q) {
      a.clocks[blockIdx.x * kPhases + q] = phase_cycles[q];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs under a plan, in bytes (the wrapper's
// _sweep_floats computes the same).
long long avatar_sweep_smem_bytes(int d1, int h, int cd, int s2, int d2,
                                  int rows, int split, int resident,
                                  int h_chunk, int k_chunk, int n_chunk) {
  const Plan p{rows, split, resident, h_chunk, k_chunk, n_chunk};
  return static_cast<long long>(make_layout(d1, h, cd, s2, d2, p).total) *
         static_cast<long long>(sizeof(float));
}

// Launches the sweep on `stream` with `grid` persistent blocks under the
// plan; returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a plan it does not take or a shared-memory size
// other than the plan's. `clocks` is null, or (tracing) [grid, kPhases]
// int64 that receives each block's SM cycles per phase. Synchronizes
// nothing and allocates nothing.
int avatar_sweep_launch(const float* cdata, const float* eps, const float* Wh,
                        const float* bh, const float* Wcmu, const float* bcmu,
                        const float* Wclv, const float* bclv, const float* Wds,
                        const float* Wdc, const float* bd, const float* cmu2,
                        const float* clv2, const float* smu2,
                        const float* slv2, float* out, long long* clocks,
                        long long n_rows, int b,
                        int d1, int h, int cd, int s2, int d2, int method,
                        int sample_latents, int rows, int split, int resident,
                        int h_chunk, int k_chunk, int n_chunk, int grid,
                        long long smem, void* stream) {
  if (n_rows <= 0) return 0;
  const bool chunks_ok = resident || (h_chunk >= 4 && (h_chunk & 3) == 0 &&
                                      k_chunk >= 1 && n_chunk >= 4 &&
                                      (n_chunk & 3) == 0);
  if (rows < 4 || (rows & 3) != 0 || split < 1 || grid < 1 || b < 1 ||
      !chunks_ok ||
      smem != avatar_sweep_smem_bytes(d1, h, cd, s2, d2, rows, split,
                                       resident, h_chunk, k_chunk, n_chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SweepArgs a{cdata, eps, Wh, bh, Wcmu, bcmu, Wclv, bclv, Wds, Wdc, bd,
                    cmu2, clv2, smu2, slv2, out, clocks,
                    static_cast<int64_t>(n_rows),
                    b, d1, h, cd, s2, d2, method, sample_latents, b / 3,
                    2 * (b / 3), b / 2,
                    Plan{rows, split, resident, h_chunk, k_chunk, n_chunk}};
  // the plan's kernel: resident or chunked weights, 8 or 4 decoder rows
  void (*kernel)(const SweepArgs) =
      resident ? (rows % kDecRows == 0 ? avatar_sweep_kernel<true, kDecRows>
                                       : avatar_sweep_kernel<true, 4>)
               : (rows % kDecRows == 0 ? avatar_sweep_kernel<false, kDecRows>
                                       : avatar_sweep_kernel<false, 4>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(grid), kThreads,
           static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* avatar_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
