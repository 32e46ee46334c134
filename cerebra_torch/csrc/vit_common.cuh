// Building blocks shared by the fused ViT half-block kernels (vit_attn.cu,
// vit_mlp.cu) for Hopper (sm_90a): row-wise LayerNorm forward and backward,
// column sums, and one tiled matrix product with a per-element epilogue.
//
// Types: SD is the residual stream's dtype (x, out, dx), CD the compute
// dtype of every matrix product's operands (float or __nv_bfloat16). Every
// product accumulates in f32: bf16 operands on the tensor cores (wmma), f32
// operands with true f32 FMA on the CUDA cores (no TF32). Every sum over rows
// (dW, db, dgamma, dbeta) adds fixed chunks in a fixed order, so a result is
// the same on every run and no atomics are used.
//
// What bounds them on an H100: the products load their tiles synchronously
// from device memory into shared memory (no cp.async/TMA ring, no wgmma), so
// they run well below the tensor cores' rate. The bf16 ViT half-blocks no
// longer use them: K7/K8's and K5/K6's products run on wgmma_gemm.cuh (a TMA
// ring feeding wgmma), and so do K2/K2g's bf16 dW and db (wgmma_gemm.cuh's
// stack_contract, with EpiPairPartial below). Their callers now: the f32
// bodies of K5-K8 (the DINOv2 teacher); K1/K4's input products, K2/K2g's
// chain and K11's products (lstm_stack.cu), whose move is later work. The
// row and column kernels are bound by memory bandwidth.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace vit {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the value a float takes after a round trip through dtype T
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

constexpr float kLnEps = 1e-6f;  // flax nn.LayerNorm's, as the Pallas kernels use

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ LayerNorm
// One warp per row: mu, rstd of x in f32; y = ((x - mu) * rstd) * g + b
// rounded to CD (g, b already in CD, as the Pallas wrappers cast them).
template <typename SD, typename CD>
__global__ void ln_fwd_rows(const SD* __restrict__ x, const CD* __restrict__ g,
                            const CD* __restrict__ b, CD* __restrict__ y,
                            float* __restrict__ mu, float* __restrict__ rstd, int M, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const SD* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int j = lane; j < D; j += 32) s += to_f(xr[j]);
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float d = to_f(xr[j]) - mean;
    v += d * d;
  }
  const float r = 1.0f / sqrtf(warp_sum(v) / D + kLnEps);
  CD* yr = y + (size_t)row * D;
  for (int j = lane; j < D; j += 32) {
    const float xn = (to_f(xr[j]) - mean) * r;
    yr[j] = from_f<CD>(xn * to_f(g[j]) + to_f(b[j]));
  }
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = r;
  }
}

// One warp per row: dx = dout + rstd * (dxn - mean(dxn) - xn * mean(dxn * xn)),
// dxn = dy * g (the LN core backward of the Pallas bodies).
template <typename SD, typename CD>
__global__ void ln_bwd_rows(const SD* __restrict__ x, const float* __restrict__ mu,
                            const float* __restrict__ rstd, const float* __restrict__ dy,
                            const CD* __restrict__ g, const SD* __restrict__ dout,
                            SD* __restrict__ dx, int M, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t off = (size_t)row * D;
  const float m = mu[row], r = rstd[row];
  float s1 = 0.f, s2 = 0.f;
  for (int j = lane; j < D; j += 32) {
    const float dxn = dy[off + j] * to_f(g[j]);
    const float xn = (to_f(x[off + j]) - m) * r;
    s1 += dxn;
    s2 += dxn * xn;
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int j = lane; j < D; j += 32) {
    const float dxn = dy[off + j] * to_f(g[j]);
    const float xn = (to_f(x[off + j]) - m) * r;
    dx[off + j] = from_f<SD>(to_f(dout[off + j]) + r * (dxn - m1 - xn * m2));
  }
}

// -------------------------------------------------------- sums over rows
// Every sum over the M rows (db, dgamma, dbeta, and dW in `contract_rows`)
// runs in two launches: blocks along z each sum one fixed chunk of rows into
// an f32 partial, and `sum_partials` adds the partials in chunk order. The
// order is fixed, so the result is the same on every run, without atomics,
// and the chunks give the card enough blocks to fill its 132 SMs.
constexpr int kColSplits = 32;  // row chunks of a column sum
constexpr int kRowSplits = 8;   // row chunks of a contraction over rows

// out[e] = sum_z part[z * ld + e] for e < n, z < splits, in order of z
__global__ void sum_partials(const float* __restrict__ part, float* __restrict__ out, int splits,
                             long long n, long long ld) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * ld + e];
    out[e] = s;
  }
}

inline int launch_sum_partials(const float* part, float* out, int splits, long long n,
                               long long ld, cudaStream_t st) {
  const long long blocks = (n + 255) / 256;
  sum_partials<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(part, out, splits, n, ld);
  return (int)cudaGetLastError();
}

// Rows [m0, m1) of block z's chunk.
__device__ __forceinline__ void row_chunk(int M, int& m0, int& m1) {
  const int chunk = (M + gridDim.y - 1) / gridDim.y;
  m0 = blockIdx.y * chunk;
  m1 = min(M, m0 + chunk);
}

// Block (32, 8) over 32 columns and chunk blockIdx.y of the rows: row group
// ty sums rows m0 + ty, m0 + ty + 8, ...; the 8 sums are added in order.
// part[y * N + j] = sum over the chunk of a[m, j] * (rs ? rs[m / rdiv] : 1)
template <typename T>
__global__ void col_sum_part(const T* __restrict__ a, const float* __restrict__ rs, int rdiv,
                             float* __restrict__ part, int M, int N) {
  __shared__ float acc_s[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  int m0, m1;
  row_chunk(M, m0, m1);
  float acc = 0.f;
  if (j < N) {
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      float v = to_f(a[(size_t)m * N + j]);
      if (rs) v *= rs[m / rdiv];
      acc += v;
    }
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < N) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += acc_s[r][threadIdx.x];
    part[(size_t)blockIdx.y * N + j] = s;
  }
}

// out[j] = sum_m a[m, j] * (rs ? rs[m / rdiv] : 1); scratch: kColSplits * N
template <typename T>
int column_sum(const T* a, const float* rs, int rdiv, float* out, int M, int N, float* scratch,
               cudaStream_t st) {
  col_sum_part<T><<<dim3((N + 31) / 32, kColSplits), dim3(32, 8), 0, st>>>(a, rs, rdiv, scratch,
                                                                          M, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum_partials(scratch, out, kColSplits, N, N, st);
}

// part[y][0][j] = sum over the chunk of dy[m, j] * xn[m, j],
// part[y][1][j] = sum over the chunk of dy[m, j]
template <typename SD>
__global__ void ln_bwd_cols_part(const SD* __restrict__ x, const float* __restrict__ mu,
                                 const float* __restrict__ rstd, const float* __restrict__ dy,
                                 float* __restrict__ part, int M, int D) {
  __shared__ float pg[8][33], pb[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  int m0, m1;
  row_chunk(M, m0, m1);
  float ag = 0.f, ab = 0.f;
  if (j < D) {
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      const size_t o = (size_t)m * D + j;
      const float d = dy[o];
      ag += d * ((to_f(x[o]) - mu[m]) * rstd[m]);
      ab += d;
    }
  }
  pg[threadIdx.y][threadIdx.x] = ag;
  pb[threadIdx.y][threadIdx.x] = ab;
  __syncthreads();
  if (threadIdx.y == 0 && j < D) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < 8; ++r) {
      sg += pg[r][threadIdx.x];
      sb += pb[r][threadIdx.x];
    }
    part[(size_t)blockIdx.y * 2 * D + j] = sg;
    part[(size_t)blockIdx.y * 2 * D + D + j] = sb;
  }
}

// dg[j] = sum_m dy[m, j] * xn[m, j], db[j] = sum_m dy[m, j]; scratch:
// kColSplits * 2D
template <typename SD>
int ln_backward_cols(const SD* x, const float* mu, const float* rstd, const float* dy, float* dg,
                     float* db, int M, int D, float* scratch, cudaStream_t st) {
  ln_bwd_cols_part<SD><<<dim3((D + 31) / 32, kColSplits), dim3(32, 8), 0, st>>>(
      x, mu, rstd, dy, scratch, M, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc = launch_sum_partials(scratch, dg, kColSplits, D, 2LL * D, st);
  if (rc) return rc;
  return launch_sum_partials(scratch + D, db, kColSplits, D, 2LL * D, st);
}

// dn[m, j] = (dout[m, j] * (rs ? rs[m / rdiv] : 1)) rounded to CD: the
// branch cotangent, scaled by the drop-path factor, in the compute dtype.
template <typename SD, typename CD>
__global__ void scale_round(const SD* __restrict__ dout, const float* __restrict__ rs, int rdiv,
                            CD* __restrict__ dn, long long total, int D) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float v = to_f(dout[e]);
  if (rs) v *= rs[(e / D) / rdiv];
  dn[e] = from_f<CD>(v);
}

// ------------------------------------------------------------- products
// C(i, j) = sum_k A(i, k) B(k, j) for i < M, j < N, then epi(i, j, acc).
// A(i, k) = A_T ? A[k * lda + i] : A[i * lda + k];
// B(k, j) = B_T ? B[j * ldb + k] : B[k * ldb + j].
// Block z of the grid covers k in [z * kchunk, (z + 1) * kchunk): with one
// z the block owns its output tile; with several (`contract_rows`) each
// writes a partial that `sum_partials` adds in order.
//
// Two bodies: f32 operands run CUDA-core f32 FMA (64x64 tile, 4x4 per
// thread, float4 shared loads), true f32 with no TF32; bf16 operands run
// the tensor cores through wmma 16x16x16 bf16 tiles with f32 accumulation
// (products of two bf16 values are exact; the sum is f32), and pass each
// 64x64 tile through shared memory to the epilogue.
constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

template <typename TA, typename TB, bool A_T, bool B_T, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm(const TA* __restrict__ A, int lda, const TB* __restrict__ B, int ldb, int M, int N, int K,
     int kchunk, Epi epi) {
  __shared__ __align__(16) float As[kBK][kBM + 4];  // As[k][i]
  __shared__ __align__(16) float Bs[kBK][kBN + 4];  // Bs[k][j]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kGemmThreads) {
      // the thread order follows the contiguous index in memory
      const int ii = A_T ? e % kBM : e / kBK;
      const int kk = A_T ? e / kBM : e % kBK;
      const int gi = i0 + ii, gk = k0 + kk;
      float v = 0.f;
      if (gi < M && gk < ke) v = to_f(A_T ? A[(size_t)gk * lda + gi] : A[(size_t)gi * lda + gk]);
      As[kk][ii] = v;
    }
#pragma unroll
    for (int e = tid; e < kBN * kBK; e += kGemmThreads) {
      const int jj = B_T ? e / kBK : e % kBN;
      const int kk = B_T ? e % kBK : e / kBN;
      const int gj = j0 + jj, gk = k0 + kk;
      float v = 0.f;
      if (gj < N && gk < ke) v = to_f(B_T ? B[(size_t)gj * ldb + gk] : B[(size_t)gk * ldb + gj]);
      Bs[kk][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      if (j < N) epi(i, j, acc[r][c]);
    }
  }
}

// The bf16 body. Shared tiles keep global memory's orientation, and the
// wmma fragment layout says which index is contiguous: A (i, k) row-major
// or, with A_T, col-major; B (k, j) row-major or, with B_T, col-major.
// Eight warps: warp w owns rows 16 (w / 2) and columns 32 (w % 2) + {0, 16}.
// Each thread loads 8 elements of a tile that are contiguous in global
// memory, as one 16-byte load where they are all in range and aligned, else
// one by one; either way the tile holds the same values.
constexpr int kTcBK = 32, kTcPad = 8;

// tile[r * LD + cc + v] = src(r, cc + v) for v < 8, with src's contiguous
// index along cc: gr (the tile row's global index, in range below nr) and
// gc (cc's, in range below nc) address src + gr * ld + gc; zero out of range
template <int LD>
__device__ __forceinline__ void load8(__nv_bfloat16* tile, int r, int cc,
                                      const __nv_bfloat16* __restrict__ src, int ld, int gr,
                                      int nr, int gc, int nc) {
  const __nv_bfloat16* p = src + (size_t)gr * ld + gc;
  __nv_bfloat16* d = tile + r * LD + cc;
  if (gr < nr && gc + 7 < nc && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int v = 0; v < 8; ++v) d[v] = (gr < nr && gc + v < nc) ? p[v] : zero;
}

template <bool A_T, bool B_T, class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tc(const __nv_bfloat16* __restrict__ A, int lda, const __nv_bfloat16* __restrict__ B,
        int ldb, int M, int N, int K, int kchunk, Epi epi) {
  using namespace nvcuda;
  constexpr int A_ROWS = A_T ? kTcBK : kBM, A_LD = (A_T ? kBM : kTcBK) + kTcPad;
  constexpr int B_ROWS = B_T ? kBN : kTcBK, B_LD = (B_T ? kTcBK : kBN) + kTcPad;
  __shared__ __align__(32) __nv_bfloat16 As[A_ROWS * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[B_ROWS * B_LD];
  __shared__ __align__(32) float Cs[kBM * (kBN + 4)];
  using LayoutA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  const int tid = threadIdx.x, warp = tid / 32;
  const int i0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const int wr = 16 * (warp / 2), wc = 32 * (warp % 2);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2];
  wmma::fill_fragment(c[0], 0.f);
  wmma::fill_fragment(c[1], 0.f);

  for (int k0 = kb; k0 < ke; k0 += kTcBK) {
    for (int e = 8 * tid; e < kBM * kTcBK; e += 8 * kGemmThreads) {
      // (row, col) of the shared tile, col contiguous in global memory
      const int r = e / (A_LD - kTcPad), cc = e % (A_LD - kTcPad);
      if (A_T)
        load8<A_LD>(As, r, cc, A, lda, k0 + r, ke, i0 + cc, M);
      else
        load8<A_LD>(As, r, cc, A, lda, i0 + r, M, k0 + cc, ke);
    }
    for (int e = 8 * tid; e < kBN * kTcBK; e += 8 * kGemmThreads) {
      const int r = e / (B_LD - kTcPad), cc = e % (B_LD - kTcPad);
      if (B_T)
        load8<B_LD>(Bs, r, cc, B, ldb, j0 + r, N, k0 + cc, ke);
      else
        load8<B_LD>(Bs, r, cc, B, ldb, k0 + r, ke, j0 + cc, N);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LayoutA> a;
      wmma::load_matrix_sync(a, A_T ? &As[kk * A_LD + wr] : &As[wr * A_LD + kk], A_LD);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LayoutB> b;
        const int col = wc + 16 * f;
        wmma::load_matrix_sync(b, B_T ? &Bs[col * B_LD + kk] : &Bs[kk * B_LD + col], B_LD);
        wmma::mma_sync(c[f], a, b, c[f]);
      }
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(&Cs[wr * (kBN + 4) + wc], c[0], kBN + 4, wmma::mem_row_major);
  wmma::store_matrix_sync(&Cs[wr * (kBN + 4) + wc + 16], c[1], kBN + 4, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kGemmThreads) {
    const int r = e / kBN, cc = e % kBN;
    if (i0 + r < M && j0 + cc < N) epi(i0 + r, j0 + cc, Cs[r * (kBN + 4) + cc]);
  }
}

template <typename TA, typename TB, bool A_T, bool B_T, class Epi>
void launch_gemm(const TA* A, int lda, const TB* B, int ldb, int M, int N, int K, Epi epi,
                 cudaStream_t s, int splits = 1) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const int kchunk = (K + splits - 1) / splits;
  if constexpr (std::is_same<TA, __nv_bfloat16>::value && std::is_same<TB, __nv_bfloat16>::value)
    gemm_tc<A_T, B_T, Epi><<<grid, kGemmThreads, 0, s>>>(A, lda, B, ldb, M, N, K, kchunk, epi);
  else
    gemm<TA, TB, A_T, B_T, Epi><<<grid, kGemmThreads, 0, s>>>(A, lda, B, ldb, M, N, K, kchunk,
                                                              epi);
}

// part[z][i][j] = the partial product of chunk z
struct EpiPartial {
  float* part;
  int ld;
  size_t zstride;
  __device__ void operator()(int i, int j, float acc) const {
    part[blockIdx.z * zstride + (size_t)i * ld + j] = acc;
  }
};

// part[y][i][j] = C(i, j) over k chunk y = blockIdx.y, and C(i, j + 1) where
// two: the pair epilogue (wgmma_gemm.cuh's convention) of K2/K2g's one-pass
// dW and db contraction (lstm_stack.cu layer_products), which replaces
// EpiPartial there
struct EpiPairPartial {
  float* part;
  int ld;
  size_t zstride;
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    float* p = part + blockIdx.y * zstride + (size_t)i * ld + j;
    if (two && ((uintptr_t)p & 7) == 0) {
      *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    } else {
      p[0] = v0;
      if (two) p[1] = v1;
    }
  }
};

// out (K1, K2) f32 = a^T b over the M rows of a (M, K1) and b (M, K2): the
// Pallas _contract_rows. kRowSplits chunks of rows, each a partial, then
// their sum in order. scratch: kRowSplits * K1 * K2 floats.
template <typename T>
int contract_rows(const T* a, int K1, const T* b, int K2, int M, float* out, float* scratch,
                  cudaStream_t st) {
  const size_t n = (size_t)K1 * K2;
  launch_gemm<T, T, true, false>(a, K1, b, K2, K1, K2, M, EpiPartial{scratch, K2, n}, st,
                                 kRowSplits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_sum_partials(scratch, out, kRowSplits, (long long)n, (long long)n, st);
}

// ------------------------------------------------------------ epilogues
// out (f32) = acc
struct EpiF32 {
  float* out;
  int ld;
  __device__ void operator()(int i, int j, float acc) const { out[(size_t)i * ld + j] = acc; }
};

// out (T) = acc + bias (bias may be null), rounded to T
template <typename T>
struct EpiBiasRound {
  const T* bias;
  T* out;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    if (bias) acc += to_f(bias[j]);
    out[(size_t)i * ld + j] = from_f<T>(acc);
  }
};

// out (SD) = x + s * (acc + bias), s = rs[i / rdiv] or 1: the residual add
// with the drop-path branch scale, as the Pallas bodies end.
template <typename SD, typename CD>
struct EpiResidual {
  const SD* x;
  const CD* bias;
  const float* rs;
  int rdiv;
  SD* out;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    float v = acc + to_f(bias[j]);
    if (rs) v *= rs[i / rdiv];
    const size_t o = (size_t)i * ld + j;
    out[o] = from_f<SD>(to_f(x[o]) + v);
  }
};

}  // namespace vit

// Run one launch and return its error code from the enclosing function if
// it was refused.
#define CEREBRA_VIT_CHECK(...)                  \
  do {                                          \
    __VA_ARGS__;                                \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

// Return the error code of a helper that returns one, if it is not 0.
#define CEREBRA_VIT_RC(...)            \
  do {                                 \
    const int rc_ = (__VA_ARGS__);     \
    if (rc_ != 0) return rc_;          \
  } while (0)

// Instantiate CALL for the (stream, compute) dtype pair the flags name and
// return its result.
#define CEREBRA_DISPATCH(SDB, CDB, CALL)                                    \
  do {                                                                      \
    if (SDB && CDB) {                                                       \
      using SD = __nv_bfloat16;                                             \
      using CD = __nv_bfloat16;                                             \
      return CALL;                                                          \
    } else if (SDB) {                                                       \
      using SD = __nv_bfloat16;                                             \
      using CD = float;                                                     \
      return CALL;                                                          \
    } else if (CDB) {                                                       \
      using SD = float;                                                     \
      using CD = __nv_bfloat16;                                             \
      return CALL;                                                          \
    } else {                                                                \
      using SD = float;                                                     \
      using CD = float;                                                     \
      return CALL;                                                          \
    }                                                                       \
  } while (0)
