// Shared device code of the persistent train-step kernels (mopoe_step.cu,
// method_step.cu, presence_step.cu, generic_step.cu), for Hopper (sm_90a).
//
// * The split layout: the 28 split tensors of multivae_tpu/ops/fused_step.py
//   (SPLIT_NAMES) back to back in one flat float32 buffer, in the JAX layout
//   [in, out]. make_layout gives their offsets; the Python side computes the
//   same ones (multivae_tpu_torch/params.py, split_shapes).
// * gemm_tile: one 32 x 32 tile of C = epilogue(sum_s op(A_s) op(B_s)), the
//   sum of up to kMaxSeg products that share M and N (the decoders'
//   zs.Wds + zc.Wdc, the encoders' four head products in the backward), by
//   one block of 256 threads. The block is four k-groups of 64 threads: the
//   16-deep k-slices are dealt to the groups in turn (in-block split-K), a
//   thread keeps 4 x 4 outputs in registers and reads its operands from
//   shared memory 16 bytes at a time, and a group's next slices are on their
//   way while it multiplies the current one (a ring of stages filled by
//   cp.async: 16 bytes a copy where the slice lies in memory as it is staged
//   and its rows are 16-byte aligned, 4 bytes a copy where k runs along
//   memory and the slice is transposed on its way, at ragged edges and for
//   rows such as 7 or 3 floats; zeros past the edge).
//   The groups' partials are added in group order: the order of every sum
//   depends on the tile alone, never on the grid or on which block took the
//   tile, so there is no float atomicAdd anywhere and two runs, two cards
//   and a row slice against the whole batch give the same bits. dW = A^T G
//   is the same product with transposed A. A problem may carry a dropout
//   keep mask (pre-scaled, [M, N]): the forward epilogue multiplies it in
//   after the ReLU, the backward one where the ReLU let the unit through.
//   Two epilogues turn a decoder's output product straight into the loss
//   gradient and per-row-tile column partials, which a later phase adds in
//   row-tile order: kDecLoss under a per-feature output log-variance
//   (g_loc; partials of the bias gradient, the log-variance gradient and
//   the NLL), kSampleLoss under a per-sample one (g_loc and g_lv; partials
//   of both halves of the bias gradient and of the NLL). GemmTable holds
//   the problems of one phase of a launch, built by the kernel itself in
//   shared memory; the blocks stride over its tiles.
// * The bfloat16 branch (precision = "bfloat16", the TPU kernels'
//   matmul_bf16; multivae_tpu_torch/ops/bf16.py names the two schemes): a
//   kernel instantiated for scheme A or B (kScheme) reads each problem's
//   `rounding`. kRoundBoth rounds both operands to bfloat16 as the
//   fragments are loaded from the float32 stages (__float2bfloat16_rn, to
//   nearest even) and multiplies them on the tensor cores (mma.sync
//   m16n8k16, bf16 x bf16 with float32 accumulation), each k-slice's
//   product into a zeroed fragment that is then added to the running sums
//   with float32 adds (the tensor cores truncate as they accumulate; kept to
//   16 products, their bias stays near float32 round-off); the tile, its
//   k-groups and the order of every sum stay those of the float32 tile, so
//   the results still depend on the tile alone. kRoundA / kRoundB (scheme
//   B's backward: a float32 cotangent times the other operand as bfloat16)
//   run on the float32 FMA path with the named operand rounded as it is
//   read, and round each segment's sum to bfloat16 before the segments are
//   added (a segment is one product of the JAX forward, whose gradient
//   autodiff rounds on its own); the epilogue (ReLU and mask, Adam) takes
//   that sum. A float32 instance (kSchemeF32) compiles none of this.
// * colsum_chunk: bias gradients, 32 columns by one block: the rows dealt to
//   the 8 warps, neighbouring lanes on neighbouring columns, the warps'
//   partials added in warp order (of one source, or of two passes' sources
//   one after the other).
// * cooperative_grid: the grid of a persistent cooperative launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <map>
#include <mutex>

#include "adam_common.cuh"

namespace step {

constexpr float kPoeEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi)
constexpr float kLog2 = 0.6931471805599453f;    // log(2)

// The decoders' output likelihoods, in the order of LIKELIHOODS in
// multivae_tpu_torch/ops/likelihoods.py.
enum Likelihood {
  kNormal = 0, kLaplace = 1, kBernoulli = 2, kCategorical = 3
};

struct EncLayout {
  long long Wh, bh, Wcmu, bcmu, Wclv, bclv, Wsmu, bsmu, Wslv, bslv;
};
struct DecLayout {
  long long Wds, Wdc, bd, olv;
};
struct Layout {
  EncLayout enc[2];
  DecLayout dec[2];
  long long total;
};

// Offsets of the split tensors in SPLIT_NAMES order: enc1_*, enc2_* (Wh, bh,
// Wcmu, bcmu, Wclv, bclv, Wsmu, bsmu, Wslv, bslv), then dec1_*, dec2_* (Wds,
// Wdc, bd, olv). dec Wds [s, d] and Wdc [cd, d] are adjacent.
__host__ __device__ inline Layout make_layout(int d1, int d2, int h, int cd, int s1, int s2) {
  Layout L;
  long long off = 0;
  const int d[2] = {d1, d2};
  const int s[2] = {s1, s2};
  for (int e = 0; e < 2; ++e) {
    EncLayout& E = L.enc[e];
    E.Wh = off;   off += static_cast<long long>(d[e]) * h;
    E.bh = off;   off += h;
    E.Wcmu = off; off += static_cast<long long>(h) * cd;
    E.bcmu = off; off += cd;
    E.Wclv = off; off += static_cast<long long>(h) * cd;
    E.bclv = off; off += cd;
    E.Wsmu = off; off += static_cast<long long>(h) * s[e];
    E.bsmu = off; off += s[e];
    E.Wslv = off; off += static_cast<long long>(h) * s[e];
    E.bslv = off; off += s[e];
  }
  for (int e = 0; e < 2; ++e) {
    DecLayout& D = L.dec[e];
    D.Wds = off; off += static_cast<long long>(s[e]) * d[e];
    D.Wdc = off; off += static_cast<long long>(cd) * d[e];
    D.bd = off;  off += d[e];
    D.olv = off; off += d[e];
  }
  L.total = off;
  return L;
}

// ------------------------------------------------------------ grouped GEMM
constexpr int kTile = 32;         // output tile: kTile x kTile
constexpr int kSlice = 16;        // depth of one staged k-slice
constexpr int kGroups = 4;        // k-groups of a block (in-block split-K)
constexpr int kGroupThreads = 64; // 8 x 8 threads, 4 x 4 outputs each
constexpr int kGemmThreads = kGroups * kGroupThreads;
constexpr int kWarps = kGemmThreads / 32;
constexpr int kLd = kTile + 4;    // padded row of a staged slice (16-byte rows)
constexpr int kMaxSeg = 4;
constexpr int kMaxColOut = 3;     // column partials an epilogue may emit

enum Epilogue {
  kStore = 0,     // C = acc
  kBias = 1,      // C = acc + bias[n]
  kBiasRelu = 2,  // C = max(acc + bias[n], 0) [* mask[m, n]]
  kReluMask = 3,  // C = aux[m, n] > 0 ? acc [* mask[m, n]] : 0 (ReLU backward;
                  // aux is the masked activation: it is 0 where the mask is)
  kDecLoss = 4,   // r = aux - (acc + bias), C = g_loc = -r exp(-olv[n]) / scale
                  // and, per row tile, the column sums of g_loc, of
                  // 0.5 - 0.5 r^2 exp(-olv) and of the per-element NLL into
                  // colp[j][row_tile][n] (j = 0, 1, 2); laplace: g_loc =
                  // -sign(r) exp(-olv / 2) / scale (sign +1 at r = 0), the
                  // log-variance term 0.5 - 0.5 |r| exp(-olv / 2);
                  // bernoulli (acc + bias the logits l): g_loc = (sigmoid(l)
                  // - aux) / scale, the log-variance term 0
  kSampleLoss = 5,  // loc = acc + bias, r = aux - loc, lv = lv[m, n] (the
                    // per-sample log-variance, already stored by this block),
                    // C[m, n] = g_loc = -r exp(-lv) / scale, C[m, N + n] =
                    // g_lv = (0.5 - 0.5 r^2 exp(-lv)) / scale and, per row
                    // tile, the column sums of g_loc, g_lv and the NLL;
                    // laplace and bernoulli as kDecLoss with lv per element
};

// How a problem's products round in a kernel of the bfloat16 branch; a
// float32 kernel ignores it.
enum Rounding {
  kRoundNone = 0,  // float32 operands, float32 FMA
  kRoundBoth = 1,  // both operands bfloat16, float32 sums, tensor cores
  kRoundA = 2,     // A bfloat16, B float32, float32 FMA; each segment's
                   // sum rounded
  kRoundB = 3,     // B bfloat16, A float32, likewise
};

// The products a kernel instance compiles: float32 FMA alone; the bfloat16
// branch's scheme A (every problem kRoundBoth); scheme B (kRoundBoth and
// kRoundA / kRoundB).
enum Scheme { kSchemeF32 = 0, kSchemeA = 1, kSchemeB = 2 };

struct Segment {
  const float* A;
  const float* B;
  int K, lda, ldb;
};

// A(m, k) = transA ? A[k lda + m] : A[m lda + k]
// B(k, n) = transB ? B[n ldb + k] : B[k ldb + n]
struct Problem {
  Segment seg[kMaxSeg];
  int nseg, M, N, transA, transB;
  float* C;
  int ldc, epilogue;
  const float* bias;
  const float* aux;
  const float* mask;  // optional pre-scaled keep mask, nullptr for none
  int ld_aux, ld_mask, tiles_n, tile_begin;
  // floats added to every segment's A, to aux and to mask per step of a
  // launch that runs several steps (the stacked batches); 0 otherwise
  int step_A, step_aux, step_mask;
  // kDecLoss: the output log-variance [N], the divisor (rows the loss is a
  // mean over) and the column partials [kMaxColOut][row tiles][ld_colp]
  int ld_colp;
  const float* olv;
  float* colp;
  long long colp_stride;
  float scale;
  // kSampleLoss: the per-sample log-variance [M, N] with row stride ld_lv
  int ld_lv;
  const float* lv;
  int rounding;  // a Rounding, read by the kernels of the bfloat16 branch
};

// Adam applied where a gradient element is produced (the persistent steps'
// last phase): the element at offset i of the flat gradient buffer `g`
// updates p[i], mu[i], nu[i] right after it is stored.
struct AdamAt {
  float *p, *mu, *nu;
  const float* g;
  adam::Hyper hyper;
  adam::Correction correction;

  __device__ __forceinline__ void update(const float* at, float value) const {
    adam::update_element(p, mu, nu, value, at - g, hyper, correction);
  }
};

// A table of problems under construction, on the host (to count a launch's
// tasks) or in shared memory on the device: the problems of one phase.
struct GemmTable {
  Problem* p;
  int cap, count, total_tiles, overflow;

  __host__ __device__ void reset(Problem* storage, int capacity) {
    p = storage;
    cap = capacity;
    count = 0;
    total_tiles = 0;
    overflow = 0;
  }

  // C[M, N] = epilogue(sum over the segments added by add_segment)
  __host__ __device__ Problem* add(int M, int N, int transA, int transB,
                                   float* C, int ldc, int epilogue = kStore,
                                   const float* bias = nullptr,
                                   const float* aux = nullptr, int ld_aux = 0,
                                   const float* mask = nullptr,
                                   int ld_mask = 0) {
    if (count >= cap) {
      overflow = 1;
      return nullptr;
    }
    Problem& P = p[count++];
    P.nseg = 0;
    P.M = M;
    P.N = N;
    P.transA = transA;
    P.transB = transB;
    P.C = C;
    P.ldc = ldc;
    P.epilogue = epilogue;
    P.bias = bias;
    P.aux = aux;
    P.ld_aux = ld_aux;
    P.mask = mask;
    P.ld_mask = ld_mask;
    P.step_A = 0;
    P.step_aux = 0;
    P.step_mask = 0;
    P.olv = nullptr;
    P.colp = nullptr;
    P.colp_stride = 0;
    P.ld_colp = 0;
    P.scale = 1.0f;
    P.ld_lv = 0;
    P.lv = nullptr;
    P.rounding = kRoundNone;
    P.tiles_n = (N + kTile - 1) / kTile;
    P.tile_begin = total_tiles;
    total_tiles += ((M + kTile - 1) / kTile) * P.tiles_n;
    return &P;
  }

  __host__ __device__ void add_segment(Problem* P, const float* A, int lda,
                                       const float* B, int ldb, int K) {
    if (P == nullptr || P->nseg >= kMaxSeg) {
      overflow = 1;
      return;
    }
    Segment& S = P->seg[P->nseg++];
    S.A = A;
    S.B = B;
    S.K = K;
    S.lda = lda;
    S.ldb = ldb;
  }

  // The bfloat16 branch's rounding of every problem in the table: scheme A
  // (the hand backward, and every forward product) rounds both operands;
  // scheme B's backward products (`autodiff`) round the operand that is not
  // the cotangent: A of dW = A^T G, B of G W^T.
  __host__ __device__ void round_products(bool autodiff) {
    for (int i = 0; i < count; ++i) {
      p[i].rounding =
          !autodiff ? kRoundBoth : (p[i].transA ? kRoundA : kRoundB);
    }
  }

  // the problem that owns `tile`, which becomes the tile's index inside it
  __device__ const Problem& find(int& tile) const {
    int pi = 0;
    while (pi + 1 < count && tile >= p[pi + 1].tile_begin) ++pi;
    tile -= p[pi].tile_begin;
    return p[pi];
  }
};

// Shared memory of one block's product tile: a ring of kStages stages of
// every k-group's slices, the split-K partials (over the `a` stages, once
// the k loop is done) and the epilogue's column partials.
template <int kStages>
struct __align__(16) GemmSmem {
  float a[kStages][kGroups][kSlice][kLd];  // a[stage][group][k][m]
  float b[kStages][kGroups][kSlice][kLd];  // b[stage][group][k][n]
  float colred[kMaxColOut][kWarps][kTile];
};
static_assert(2 * kSlice * kLd >= kTile * kTile,
              "the split-K partials reuse the a stages");

// Asynchronous copies from global to shared memory. 16 bytes go through L2
// only (.cg); 4 bytes exist only as .ca. Either way what another block wrote
// before the last grid barrier is what arrives: the barrier's fences order
// it, as for an ordinary load.
__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem_dst,
                                          const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One operand's view of a tile: element (i, k), i the tile's m (A) or n (B).
// contig_i: i runs along memory (A^T products' A, row-major B) and the slice
// is copied as it lies, 16 bytes at a time where `vec`; else k runs along
// memory and the slice is transposed on its way, 4 bytes at a time.
struct Operand {
  const float* base;
  int ld, extent_i, K, i0;
  bool contig_i, vec;
};

__device__ __forceinline__ Operand make_operand(const float* base, int ld,
                                                int extent_i, int K, int i0,
                                                bool contig_i) {
  Operand X;
  X.base = base;
  X.ld = ld;
  X.extent_i = extent_i;
  X.K = K;
  X.i0 = i0;
  X.contig_i = contig_i;
  X.vec = contig_i && (reinterpret_cast<uintptr_t>(base) & 15) == 0 &&
          (ld & 3) == 0;
  return X;
}

// Start the asynchronous copies of slice k0 of X into dst[k][i] by thread j
// of a k-group; what lies past a ragged edge is stored as zero.
__device__ __forceinline__ void load_slice(const Operand& X, int k0,
                                           float (*dst)[kLd], int j) {
  if (X.vec) {
#pragma unroll
    for (int r = 0; r < kSlice * kTile / 4 / kGroupThreads; ++r) {
      const int idx = j + kGroupThreads * r;
      const int k = idx / (kTile / 4), i = (idx % (kTile / 4)) * 4;
      const int gk = k0 + k, gi = X.i0 + i;
      const float* src = X.base + static_cast<long long>(gk) * X.ld + gi;
      if (gk < X.K && gi + 3 < X.extent_i) {
        cp_async16(&dst[k][i], src);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (gk < X.K && gi + t < X.extent_i) {
            cp_async4(&dst[k][i + t], src + t);
          } else {
            dst[k][i + t] = 0.0f;
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kSlice * kTile / kGroupThreads; ++r) {
    const int idx = j + kGroupThreads * r;
    // neighbouring threads on neighbouring addresses
    const int i = X.contig_i ? idx % kTile : idx / kSlice;
    const int k = X.contig_i ? idx / kTile : idx % kSlice;
    const int gk = k0 + k, gi = X.i0 + i;
    if (gk < X.K && gi < X.extent_i) {
      const long long at = X.contig_i
                               ? static_cast<long long>(gk) * X.ld + gi
                               : static_cast<long long>(gi) * X.ld + gk;
      cp_async4(&dst[k][i], X.base + at);
    } else {
      dst[k][i] = 0.0f;
    }
  }
}

// bfloat16 helpers of the bfloat16 branch: x rounded to nearest even and
// widened back; two floats rounded into one 32-bit register (lo in the low
// half, the element of the lower k or column index, as mma expects).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One bf16 x bf16 -> float32 tensor-core product of a 16 x 16 A fragment and
// a 16 x 8 B fragment, added to c with float32 adds (per thread: c[0..1] at
// row lane / 4, columns 2 (lane % 4) + 0..1; c[2..3] eight rows further).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] += d[q];
}

// The k loop of one kTile x kTile tile over the segments [s_begin, s_end)
// of P, by every thread of the block (it holds block barriers). The
// k-slices of those segments, in order, are dealt round-robin to the
// kGroups k-groups; a group sums its slices in order, the groups' partials
// are added in group order, so the order of every sum is a function of the
// tile alone. While a group multiplies one slice its next kStages - 1 are
// on the way (a ring of stages filled by cp.async). kMode is a Rounding:
// kRoundNone multiplies on the float32 FMA path, a thread 4 x 4 outputs;
// kRoundA on the same path with the operand P.rounding names (A or B)
// rounded to bfloat16 as it is read; kRoundBoth on the tensor cores, a
// warp 16 rows x 32 columns (four m16n8k16 products a slice), the operands
// rounded as their fragments are loaded. v[r] is the sum at row m0 + 4 warp
// + r, column n0 + threadIdx.x % kTile (0 past the problem's edge).
template <int kStages, int kMode>
__device__ __forceinline__ void tile_sums(const Problem& P, int s_begin,
                                          int s_end, int m0, int n0,
                                          long long a_off,
                                          GemmSmem<kStages>& sm,
                                          float v[4]) {
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, j = tid % kGroupThreads;
  const int tx = j % 8, ty = j / 8;
  const int M = P.M, N = P.N;

  int nsl = 0;
  for (int s = s_begin; s < s_end; ++s) {
    nsl += (P.seg[s].K + kSlice - 1) / kSlice;
  }
  const int iters = (nsl + kGroups - 1) / kGroups;

  // scheme B's backward products round one operand
  constexpr bool kRoundOne = kMode == kRoundA;
  const bool round_a = P.rounding == kRoundA;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }

  // start the copies of this group's slice of iteration `it` (none past
  // the end) into the ring
  auto start_copies = [&](int it) {
    int q = it * kGroups + g;
    for (int s = s_begin; s < s_end; ++s) {
      const int ns = (P.seg[s].K + kSlice - 1) / kSlice;
      if (q < ns) {
        const Segment& S = P.seg[s];
        const int stage = it % kStages;
        load_slice(make_operand(S.A + a_off, S.lda, M, S.K, m0,
                                P.transA != 0),
                   q * kSlice, sm.a[stage][g], j);
        load_slice(make_operand(S.B, S.ldb, N, S.K, n0, P.transB == 0),
                   q * kSlice, sm.b[stage][g], j);
        return;
      }
      q -= ns;
    }
  };

  // one commit per stage and iteration, empty or not, so that the count of
  // groups in flight says which slice has landed
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < iters) start_copies(it);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice `it` has landed; the stage of `it - 1` is free
    if (it + kStages - 1 < iters) start_copies(it + kStages - 1);
    cp_async_commit();
    if (it * kGroups + g < nsl) {
      float (*As)[kLd] = sm.a[it % kStages][g];
      float (*Bs)[kLd] = sm.b[it % kStages][g];
      if constexpr (kMode == kRoundBoth) {
        // warp j / 32 of the group: rows 16 (j / 32) .. + 16, all 32
        // columns as four n8 fragments; A(m, k) = As[k][m]
        const int lane = j % 32;
        const int r0 = 16 * (j / 32) + lane / 4, k0 = 2 * (lane % 4);
        const uint32_t a[4] = {
            pack_bf16(As[k0][r0], As[k0 + 1][r0]),
            pack_bf16(As[k0][r0 + 8], As[k0 + 1][r0 + 8]),
            pack_bf16(As[k0 + 8][r0], As[k0 + 9][r0]),
            pack_bf16(As[k0 + 8][r0 + 8], As[k0 + 9][r0 + 8])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = 8 * nt + lane / 4;
          mma_bf16(acc[nt], a, pack_bf16(Bs[k0][c], Bs[k0 + 1][c]),
                   pack_bf16(Bs[k0 + 8][c], Bs[k0 + 9][c]));
        }
      } else {
#pragma unroll
        for (int k = 0; k < kSlice; ++k) {
          const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
          const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
          float a4[4] = {av.x, av.y, av.z, av.w};
          float b4[4] = {bv.x, bv.y, bv.z, bv.w};
          if constexpr (kRoundOne) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (round_a) {
                a4[q] = round_bf16(a4[q]);
              } else {
                b4[q] = round_bf16(b4[q]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(a4[r], b4[c], acc[r][c]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every group is done with the stages

  // the groups' partials, then each thread finishes 4 rows of one column
  float (*red)[kTile][kTile] =
      reinterpret_cast<float (*)[kTile][kTile]>(&sm.a[0][0][0][0]);
  if constexpr (kMode == kRoundBoth) {
    const int lane = j % 32;
    const int r0 = 16 * (j / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(&red[g][r0][8 * nt + c0]) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(&red[g][r0 + 8][8 * nt + c0]) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(&red[g][4 * ty + r][4 * tx]) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  const int nl = tid % kTile, warp = tid / kTile;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ml = 4 * warp + r;
    v[r] = (m0 + ml < M && n0 + nl < N)
               ? ((red[0][ml][nl] + red[1][ml][nl]) + red[2][ml][nl]) +
                     red[3][ml][nl]
               : 0.0f;
  }
}

// One kTile x kTile output tile of P by one block of kGemmThreads threads;
// every thread of the block calls it (it holds block barriers). The sums
// are tile_sums' (float32 FMA; under scheme A on the tensor cores; under
// scheme B as P.rounding says, each segment's sum rounded on its own for
// kRoundA / kRoundB), then the epilogue. `step` picks the batch of a launch
// that runs several steps; with `adam` every output element (a gradient)
// also takes its Adam update. kLik is the likelihood of the kDecLoss and
// kSampleLoss epilogues; kScheme a Scheme.
template <int kStages, int kLik = kNormal, int kScheme = kSchemeF32>
__device__ void gemm_tile(const Problem& P, int tile, int step,
                          GemmSmem<kStages>& sm,
                          const AdamAt* adam = nullptr) {
  const int tid = threadIdx.x;
  const int M = P.M, N = P.N, nseg = P.nseg;
  const int m0 = (tile / P.tiles_n) * kTile;
  const int n0 = (tile % P.tiles_n) * kTile;
  const long long a_off = static_cast<long long>(P.step_A) * step;
  // what the epilogue needs of its column, asked for before the k loop
  const int nl = tid % kTile, warp = tid / kTile;
  const int n = n0 + nl;
  const int epilogue = P.epilogue;
  const float* aux =
      P.aux == nullptr ? nullptr
                       : P.aux + static_cast<long long>(P.step_aux) * step;
  const float* mask =
      P.mask == nullptr ? nullptr
                        : P.mask + static_cast<long long>(P.step_mask) * step;
  float bias = 0.0f, olv = 0.0f;
  float aux4[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // aux[m, n] of the 4 rows
  float mask4[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // mask[m, n], 1 without one
  if (n < N) {
    if (P.bias != nullptr) bias = P.bias[n];
    if (epilogue == kDecLoss) olv = P.olv[n];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + 4 * warp + r;
      if (m >= M) continue;
      if (aux != nullptr) {
        aux4[r] = aux[static_cast<long long>(m) * P.ld_aux + n];
      }
      if (mask != nullptr) {
        mask4[r] = mask[static_cast<long long>(m) * P.ld_mask + n];
      }
    }
  }

  float sums[4];
  if constexpr (kScheme == kSchemeA) {
    tile_sums<kStages, kRoundBoth>(P, 0, nseg, m0, n0, a_off, sm, sums);
  } else if constexpr (kScheme == kSchemeB) {
    if (P.rounding == kRoundBoth) {
      tile_sums<kStages, kRoundBoth>(P, 0, nseg, m0, n0, a_off, sm, sums);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) sums[r] = 0.0f;
      for (int s = 0; s < nseg; ++s) {
        float part[4];
        tile_sums<kStages, kRoundA>(P, s, s + 1, m0, n0, a_off, sm, part);
#pragma unroll
        for (int r = 0; r < 4; ++r) sums[r] += round_bf16(part[r]);
        __syncthreads();  // the next segment's copies reuse the stages
      }
    }
  } else {
    tile_sums<kStages, kRoundNone>(P, 0, nseg, m0, n0, a_off, sm, sums);
  }

  // used by kDecLoss alone: 1 / variance, laplace 1 / scale
  const float iv = kLik == kLaplace ? expf(-0.5f * olv) : expf(-olv);
  float col[kMaxColOut] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ml = 4 * warp + r, m = m0 + ml;
    if (m >= M || n >= N) continue;
    float v = sums[r];
    switch (epilogue) {
      case kBias:
        v += bias;
        break;
      case kBiasRelu:
        v = fmaxf(v + bias, 0.0f);
        if (mask != nullptr) v *= mask4[r];
        break;
      case kReluMask:
        if (aux4[r] > 0.0f) {
          if (mask != nullptr) v *= mask4[r];
        } else {
          v = 0.0f;
        }
        break;
      case kDecLoss: {
        if constexpr (kLik == kNormal) {
          const float rv = aux4[r] - (v + bias);
          const float q = 0.5f * (rv * rv) * iv;  // 0.5 r^2 iv
          v = -rv * iv / P.scale;                 // g_loc = -r iv / b_total
          col[0] += v;
          col[1] += 0.5f - q;
          col[2] += 0.5f * kLog2Pi + 0.5f * olv + q;
        } else if constexpr (kLik == kLaplace) {
          const float rv = aux4[r] - (v + bias);
          const float a = fabsf(rv) * iv;  // |r| / scale
          v = (rv >= 0.0f ? -iv : iv) / P.scale;
          col[0] += v;
          col[1] += 0.5f - 0.5f * a;
          col[2] += kLog2 + 0.5f * olv + a;
        } else if constexpr (kLik == kBernoulli) {
          const float l = v + bias;
          v = (1.0f / (1.0f + expf(-l)) - aux4[r]) / P.scale;
          col[0] += v;
          col[2] += fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l))) - aux4[r] * l;
        }
        break;
      }
      case kSampleLoss: {
        const float lv = P.lv[static_cast<long long>(m) * P.ld_lv + n];
        if constexpr (kLik == kNormal) {
          const float ivs = expf(-lv);
          const float rv = aux4[r] - (v + bias);
          const float q = 0.5f * (rv * rv) * ivs;
          v = -rv * ivs / P.scale;
          const float gv = (0.5f - q) / P.scale;
          P.C[static_cast<long long>(m) * P.ldc + N + n] = gv;
          col[0] += v;
          col[1] += gv;
          col[2] += 0.5f * kLog2Pi + 0.5f * lv + q;
        } else if constexpr (kLik == kLaplace) {
          const float isc = expf(-0.5f * lv);
          const float rv = aux4[r] - (v + bias);
          const float a = fabsf(rv) * isc;
          v = (rv >= 0.0f ? -isc : isc) / P.scale;
          const float gv = (0.5f - 0.5f * a) / P.scale;
          P.C[static_cast<long long>(m) * P.ldc + N + n] = gv;
          col[0] += v;
          col[1] += gv;
          col[2] += kLog2 + 0.5f * lv + a;
        } else if constexpr (kLik == kBernoulli) {
          const float l = v + bias;
          v = (1.0f / (1.0f + expf(-l)) - aux4[r]) / P.scale;
          P.C[static_cast<long long>(m) * P.ldc + N + n] = 0.0f;
          col[0] += v;
          col[2] += fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l))) - aux4[r] * l;
        }
        break;
      }
      default:
        break;
    }
    float* out = P.C + static_cast<long long>(m) * P.ldc + n;
    *out = v;
    if (adam != nullptr) adam->update(out, v);
  }
  if (epilogue == kDecLoss || epilogue == kSampleLoss) {  // uniform
#pragma unroll
    for (int q = 0; q < kMaxColOut; ++q) sm.colred[q][warp][nl] = col[q];
    __syncthreads();
    if (tid < kMaxColOut * kTile && n0 + tid % kTile < N) {
      const int q = tid / kTile;
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += sm.colred[q][w][nl];
      P.colp[q * P.colp_stride +
             static_cast<long long>(tile / P.tiles_n) * P.ld_colp + n] = total;
    }
  }
  __syncthreads();  // the next tile's loads reuse the stages
}

// ------------------------------------------------------- column reductions
struct ColSum {
  const float* src;   // [rows, ld]
  const float* src2;  // a second pass's [rows, ld] summed in, or nullptr
  float* dst;         // [cols]
  int rows, cols, ld, chunk_begin;
};

// A table of column sums under construction (see GemmTable); one task is a
// chunk of kTile neighbouring columns.
struct ColSumTable {
  ColSum* p;
  int cap, count, total_chunks, overflow;

  __host__ __device__ void reset(ColSum* storage, int capacity) {
    p = storage;
    cap = capacity;
    count = 0;
    total_chunks = 0;
    overflow = 0;
  }

  __host__ __device__ void add(const float* src, int rows, int cols,
                               float* dst, const float* src2 = nullptr) {
    if (count >= cap) {
      overflow = 1;
      return;
    }
    ColSum& P = p[count++];
    P.src = src;
    P.src2 = src2;
    P.dst = dst;
    P.rows = rows;
    P.cols = cols;
    P.ld = cols;
    P.chunk_begin = total_chunks;
    total_chunks += (cols + kTile - 1) / kTile;
  }

  __device__ const ColSum& find(int& chunk) const {
    int pi = 0;
    while (pi + 1 < count && chunk >= p[pi + 1].chunk_begin) ++pi;
    chunk -= p[pi].chunk_begin;
    return p[pi];
  }
};

// Bias gradients: kTile columns of P by one block. Warp w sums rows w,
// w + kWarps, ... (of src, then of src2) with neighbouring lanes on
// neighbouring columns; the warps' partials are added in warp order.
// scratch: [kWarps][kTile]. Every thread of the block calls it. With `adam`
// every sum (a gradient) also takes its Adam update.
__device__ void colsum_chunk(const ColSum& P, int chunk,
                             float (*scratch)[kTile],
                             const AdamAt* adam = nullptr) {
  const int lane = threadIdx.x % kTile, warp = threadIdx.x / kTile;
  const int c = chunk * kTile + lane;
  float acc = 0.0f;
  if (c < P.cols) {
    for (int r = warp; r < P.rows; r += kWarps) {
      acc += P.src[static_cast<long long>(r) * P.ld + c];
    }
    if (P.src2 != nullptr) {
      for (int r = warp; r < P.rows; r += kWarps) {
        acc += P.src2[static_cast<long long>(r) * P.ld + c];
      }
    }
  }
  scratch[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < P.cols) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += scratch[w][lane];
    P.dst[c] = total;
    if (adam != nullptr) adam->update(P.dst + c, total);
  }
  __syncthreads();
}

// Tracing: block 0 writes the device's nanosecond clock into times[slot]
// (nothing when times is null).
__device__ __forceinline__ void stamp(unsigned long long* times, int slot) {
  if (times == nullptr || blockIdx.x != 0 || threadIdx.x != 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  times[slot] = now;
}

// The sum of v over a warp's lanes (a fixed butterfly); every lane of the
// warp calls it and gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The grid of a persistent cooperative `kernel` (kGemmThreads threads a
// block, smem_bytes of dynamic shared memory) on the current device: what is
// co-resident (SM count x the occupancy query), at most a block per task of
// its largest phase (`tasks()`; more would only wait at the barriers) or per
// SM, whichever is more.
// Remembered per device and `sizes`, so a later launch asks the runtime
// nothing. Returns a CUDA error code (0 on success).
template <typename Kernel, typename Tasks>
int cooperative_grid(Kernel kernel, int smem_bytes,
                     const std::array<int, 12>& sizes, Tasks tasks,
                     int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mutex;
  static std::map<std::pair<int, std::array<int, 12>>, int> known;
  std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_pair(device, sizes);
  const auto found = known.find(key);
  if (found != known.end()) {
    *blocks = found->second;
    return 0;
  }
  int sms = 0, cooperative = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&cooperative, cudaDevAttrCooperativeLaunch,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cooperative) return static_cast<int>(cudaErrorNotSupported);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kGemmThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int most = tasks();
  if (most < 1) return static_cast<int>(cudaErrorInvalidValue);
  // at least a block per SM: the elementwise phases use every thread
  const int useful = most > sms ? most : sms;
  *blocks = sms * per_sm < useful ? sms * per_sm : useful;
  known[key] = *blocks;
  return 0;
}

}  // namespace step
