// Shared device code of the train-step kernels (mopoe_step.cu,
// method_step.cu, presence_step.cu), for Hopper (sm_90a).
//
// * The split layout: the 28 split tensors of multivae_tpu/ops/fused_step.py
//   (SPLIT_NAMES) back to back in one flat float32 buffer, in the JAX layout
//   [in, out]. make_layout gives their offsets; the Python side computes the
//   same ones (multivae_tpu_torch/params.py, split_shapes).
// * grouped_gemm: one launch runs up to kMaxProblems independent products
//   C = epilogue(sum_s op(A_s) op(B_s)), each the sum of up to kMaxSeg
//   products that share M and N (the decoders' zs.Wds + zc.Wdc, the
//   encoders' four head products in the backward). Tiles of 32 x 32 outputs,
//   a 32-deep slice of each operand staged in shared memory, 4 outputs per
//   thread, every sum over k in one fixed order. dW = A^T G is the same
//   product with transposed A: the reduction over the batch rows runs in a
//   fixed order inside one block, never across blocks, so there is no float
//   atomicAdd anywhere and two runs give the same bits. A problem may carry
//   a dropout keep mask (pre-scaled, [M, N]): the forward epilogue
//   multiplies it in after the ReLU, the backward one where the ReLU let
//   the unit through.
// * colsum: bias gradients, one thread per column summing the rows in order
//   (of one source, or of two passes' sources one after the other).
// * dec_colreduce: per decoder column, the residual's gradient
//   g_loc = -r exp(-olv) / b, its column sum (bias gradient), the
//   output-log-variance gradient and the column's NLL sum; with a second
//   residual (poe's unimodal decode) the gradients are the two passes' sums.
// * block_sum: a fixed-order tree reduction inside one block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace step {

constexpr float kPoeEps = 1e-8f;
constexpr float kLog2Pi = 1.8378770664093453f;  // log(2 pi)

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
inline Layout make_layout(int d1, int d2, int h, int cd, int s1, int s2) {
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
constexpr int kTile = 32;
constexpr int kGemmThreads = 256;
constexpr int kMaxSeg = 4;
constexpr int kMaxProblems = 12;

enum Epilogue {
  kStore = 0,     // C = acc
  kBias = 1,      // C = acc + bias[n]
  kBiasRelu = 2,  // C = max(acc + bias[n], 0) [* mask[m, n]]
  kReluMask = 3,  // C = aux[m, n] > 0 ? acc [* mask[m, n]] : 0 (ReLU backward;
                  // aux is the masked activation: it is 0 where the mask is)
  kResidual = 4,  // C = aux[m, n] - (acc + bias[n])   (r = x - loc)
};

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
};

struct GemmBatch {
  Problem p[kMaxProblems];
  int count, total_tiles;
};

__global__ void __launch_bounds__(kGemmThreads)
grouped_gemm_kernel(const GemmBatch batch) {
  __shared__ float As[kTile][kTile + 1];  // As[k][m]
  __shared__ float Bs[kTile][kTile + 1];  // Bs[k][n]
  int tile = blockIdx.x;
  int pi = 0;
  while (pi + 1 < batch.count && tile >= batch.p[pi + 1].tile_begin) ++pi;
  const Problem& P = batch.p[pi];
  tile -= P.tile_begin;
  const int m0 = (tile / P.tiles_n) * kTile;
  const int n0 = (tile % P.tiles_n) * kTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int s = 0; s < P.nseg; ++s) {
    const Segment S = P.seg[s];
    for (int k0 = 0; k0 < S.K; k0 += kTile) {
      for (int i = threadIdx.x; i < kTile * kTile; i += kGemmThreads) {
        // neighbouring threads read neighbouring addresses
        const int major = i / kTile, minor = i % kTile;
        const int mm = P.transA ? minor : major;
        const int kk = P.transA ? major : minor;
        const int gm = m0 + mm, gk = k0 + kk;
        float v = 0.0f;
        if (gm < P.M && gk < S.K) {
          v = P.transA ? S.A[static_cast<long long>(gk) * S.lda + gm]
                       : S.A[static_cast<long long>(gm) * S.lda + gk];
        }
        As[kk][mm] = v;
      }
      for (int i = threadIdx.x; i < kTile * kTile; i += kGemmThreads) {
        const int major = i / kTile, minor = i % kTile;
        const int nn = P.transB ? major : minor;
        const int kk = P.transB ? minor : major;
        const int gn = n0 + nn, gk = k0 + kk;
        float v = 0.0f;
        if (gn < P.N && gk < S.K) {
          v = P.transB ? S.B[static_cast<long long>(gn) * S.ldb + gk]
                       : S.B[static_cast<long long>(gk) * S.ldb + gn];
        }
        Bs[kk][nn] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        const float a0 = As[kk][ty], a1 = As[kk][ty + 16];
        const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
        acc[0][0] = fmaf(a0, b0, acc[0][0]);
        acc[0][1] = fmaf(a0, b1, acc[0][1]);
        acc[1][0] = fmaf(a1, b0, acc[1][0]);
        acc[1][1] = fmaf(a1, b1, acc[1][1]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 16 * i;
      const int n = n0 + tx + 16 * j;
      if (m >= P.M || n >= P.N) continue;
      float v = acc[i][j];
      switch (P.epilogue) {
        case kBias:
          v += P.bias[n];
          break;
        case kBiasRelu:
          v = fmaxf(v + P.bias[n], 0.0f);
          if (P.mask != nullptr) {
            v *= P.mask[static_cast<long long>(m) * P.ld_mask + n];
          }
          break;
        case kReluMask:
          if (P.aux[static_cast<long long>(m) * P.ld_aux + n] > 0.0f) {
            if (P.mask != nullptr) {
              v *= P.mask[static_cast<long long>(m) * P.ld_mask + n];
            }
          } else {
            v = 0.0f;
          }
          break;
        case kResidual:
          v = P.aux[static_cast<long long>(m) * P.ld_aux + n] -
              (v + P.bias[n]);
          break;
        default:
          break;
      }
      P.C[static_cast<long long>(m) * P.ldc + n] = v;
    }
  }
}

// Host-side builder of one grouped launch.
struct GemmBuilder {
  GemmBatch batch;
  bool overflow = false;

  GemmBuilder() {
    batch.count = 0;
    batch.total_tiles = 0;
  }

  // C[M, N] = epilogue(sum over the segments added by add_segment)
  Problem* add(int M, int N, int transA, int transB, float* C, int ldc,
               int epilogue = kStore, const float* bias = nullptr,
               const float* aux = nullptr, int ld_aux = 0,
               const float* mask = nullptr, int ld_mask = 0) {
    if (batch.count >= kMaxProblems) {
      overflow = true;
      return nullptr;
    }
    Problem& P = batch.p[batch.count++];
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
    P.tiles_n = (N + kTile - 1) / kTile;
    P.tile_begin = batch.total_tiles;
    batch.total_tiles += ((M + kTile - 1) / kTile) * P.tiles_n;
    return &P;
  }

  void add_segment(Problem* P, const float* A, int lda, const float* B,
                   int ldb, int K) {
    if (P == nullptr || P->nseg >= kMaxSeg) {
      overflow = true;
      return;
    }
    P->seg[P->nseg++] = Segment{A, B, K, lda, ldb};
  }

  cudaError_t launch(cudaStream_t stream) {
    if (overflow) return cudaErrorInvalidValue;
    if (batch.total_tiles == 0) return cudaSuccess;
    grouped_gemm_kernel<<<batch.total_tiles, kGemmThreads, 0, stream>>>(batch);
    return cudaGetLastError();
  }
};

// ------------------------------------------------------- column reductions
constexpr int kMaxColSums = 12;
constexpr int kColThreads = 128;

struct ColSum {
  const float* src;   // [rows, ld]
  const float* src2;  // a second pass's [rows, ld] summed in, or nullptr
  float* dst;         // [cols]
  int rows, cols, ld, col_begin;
};

struct ColSumBatch {
  ColSum p[kMaxColSums];
  int count, total_cols;
};

__global__ void colsum_kernel(const ColSumBatch batch) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= batch.total_cols) return;
  int pi = 0;
  while (pi + 1 < batch.count && c >= batch.p[pi + 1].col_begin) ++pi;
  const ColSum& P = batch.p[pi];
  c -= P.col_begin;
  float acc = 0.0f;
  for (int r = 0; r < P.rows; ++r) {
    acc += P.src[static_cast<long long>(r) * P.ld + c];
  }
  if (P.src2 != nullptr) {
    for (int r = 0; r < P.rows; ++r) {
      acc += P.src2[static_cast<long long>(r) * P.ld + c];
    }
  }
  P.dst[c] = acc;
}

struct ColSumBuilder {
  ColSumBatch batch;
  bool overflow = false;

  ColSumBuilder() {
    batch.count = 0;
    batch.total_cols = 0;
  }

  void add(const float* src, int rows, int cols, float* dst,
           const float* src2 = nullptr) {
    if (batch.count >= kMaxColSums) {
      overflow = true;
      return;
    }
    batch.p[batch.count++] = ColSum{src, src2, dst, rows, cols, cols,
                                    batch.total_cols};
    batch.total_cols += cols;
  }

  cudaError_t launch(cudaStream_t stream) {
    if (overflow) return cudaErrorInvalidValue;
    if (batch.total_cols == 0) return cudaSuccess;
    const int blocks = (batch.total_cols + kColThreads - 1) / kColThreads;
    colsum_kernel<<<blocks, kColThreads, 0, stream>>>(batch);
    return cudaGetLastError();
  }
};

// One decoder's column pass (blockIdx.y picks the decoder).
struct DecReduce {
  const float* r;    // [b, d] residual x - loc
  const float* olv;  // [d] output log-variance
  float* g_loc;      // [b, d]
  float* g_bd;       // [d]
  float* g_olv;      // [d]
  float* nll_col;    // [d] column sums of the per-element NLL
  int d;
  // a second decode of the same modality (poe's unimodal pass), or nullptr:
  // g_bd and g_olv are then the sums over both passes
  const float* r2;
  float* g_loc2;
  float* nll_col2;
};

struct DecReduceBatch {
  DecReduce p[2];
  int b, learn_scale;
};

__global__ void dec_colreduce_kernel(const DecReduceBatch batch) {
  const DecReduce& P = batch.p[blockIdx.y];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= P.d) return;
  const float bf = static_cast<float>(batch.b);
  const float olv = P.olv[c];
  const float iv = expf(-olv);
  float acc_g = 0.0f, acc_o = 0.0f, acc_n = 0.0f;
  for (int row = 0; row < batch.b; ++row) {
    const long long i = static_cast<long long>(row) * P.d + c;
    const float rv = P.r[i];
    const float gl = -rv * iv / bf;        // g_loc = -r iv / b
    const float q = 0.5f * (rv * rv) * iv;  // 0.5 r^2 iv
    P.g_loc[i] = gl;
    acc_g += gl;
    acc_o += 0.5f - q;
    acc_n += 0.5f * kLog2Pi + 0.5f * olv + q;
  }
  P.nll_col[c] = acc_n;
  if (P.r2 != nullptr) {
    acc_n = 0.0f;
    for (int row = 0; row < batch.b; ++row) {
      const long long i = static_cast<long long>(row) * P.d + c;
      const float rv = P.r2[i];
      const float gl = -rv * iv / bf;
      const float q = 0.5f * (rv * rv) * iv;
      P.g_loc2[i] = gl;
      acc_g += gl;
      acc_o += 0.5f - q;
      acc_n += 0.5f * kLog2Pi + 0.5f * olv + q;
    }
    P.nll_col2[c] = acc_n;
  }
  P.g_bd[c] = acc_g;
  P.g_olv[c] = batch.learn_scale ? acc_o / bf : 0.0f;
}

// Fixed-order tree sum of `n` values read by `get(i)` across one block of
// kMetricThreads threads; every thread returns the total.
constexpr int kMetricThreads = 256;

template <typename Get>
__device__ float block_sum(int n, Get get, float* scratch) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += kMetricThreads) acc += get(i);
  scratch[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kMetricThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      scratch[threadIdx.x] += scratch[threadIdx.x + stride];
    }
    __syncthreads();
  }
  const float total = scratch[0];
  __syncthreads();
  return total;
}

}  // namespace step
