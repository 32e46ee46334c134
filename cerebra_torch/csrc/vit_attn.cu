// Fused ViT attention half-block for Hopper (sm_90a): the CUDA counterparts
// of the Pallas kernels in cerebra/models/pallas_vit_attn.py.
//
//   cerebra_vit_attn_fwd  replaces _fwd_kernel (K5):
//       out = x + s * proj(MHA(LN(x) * g + b))  per sequence
//   cerebra_vit_attn_bwd  replaces _bwd_kernel (K6): dx, and f32 dg, db,
//       dWqkv, dbqkv, dWp, dbp (dWq and dbq in the scale-folded space; the
//       wrapper rescales them, as the Pallas _bwd does)
//
// Layouts (row-major, M = B * N rows): x, out, dout, dx (M, D) in SD;
// g, b (D), Wqkv (D, 3D) with the q scale folded into its first D columns,
// bqkv (3D), Wp (D, D), bp (D) in CD; s (B) f32 or null. The qkv feature
// order is i*D + h*dh + c (_split_params); dh = D / H <= 64.
//
// What bounds it on an H100, and the design. The TPU kernel keeps each
// head's whole (Np, Np) score matrix in VMEM (one backward takes 16.6 MiB at
// Np = 800); a block has 227 KB of shared memory. So the half-block is a
// chain of launches on one stream:
//   forward:  LN rows (y) -> y @ Wqkv + bqkv rounded to CD (qkv) ->
//             attention over 64x64 query/key tiles (o) -> o @ Wp + bp,
//             scaled, plus the residual;
//   backward: dout*s in CD -> dWp, dbp -> do = dn @ Wp^T -> dq (query tiles)
//             -> dk, dv (key tiles) -> dWqkv, dbqkv -> dy = dqkv @ Wqkv^T ->
//             LN backward.
// The attention never holds more than one 64x64 tile of scores. It is
// two-pass: pass 1 finds each row's max m and sum l = sum exp(s - m), pass 2
// forms p = exp(s - m) / l, rounds p to CD and accumulates p @ v, so p is
// rounded at the point where the Pallas body rounds its full-row softmax
// (a one-pass online softmax would round unnormalised values instead). The
// forward saves m and l per row; the backward recomputes p from them
// bit-for-bit and, for dS = p (dp - sum_j p dp), first sums p * dp over
// every key tile as the Pallas body does (not FlashAttention's do . o,
// which would use the rounded o). Every dW is a contraction over rows summed
// in fixed chunks and a fixed order (vit_common.cuh): deterministic, no
// atomics. In bf16 every product, the attention tiles' included, runs on the
// tensor cores (wmma); in f32 on the CUDA cores with true f32 FMA. Bound: the
// attention tiles, two score products in the forward and three in the
// backward per tile pair, each passed through shared memory for the softmax
// algebra; wgmma, TMA and a one-pass kernel are later work.
//
// Rounding points follow the Pallas bodies: LN in f32 with eps 1e-6; y, q,
// k, v, p, o, dout*s, do, dS, dq, dk, dv rounded to CD where the body casts
// them; f32 accumulation; softmax, dp, dbqkv, dbp, dg, db in f32; the
// residual stream in SD.

#include "vit_common.cuh"

namespace {

using namespace vit;

constexpr int kT = 64;         // queries or keys per tile, and the largest dh
constexpr int kLd = kT + 4;    // shared-memory row stride (keeps float4 alignment)
constexpr int kTile = kT * kLd;
constexpr int kAttnThreads = 256;  // 16 x 16; each thread owns a 4x4 sub-tile

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// t[c * kLd + r] = src row (r0 + r), column c, for r < kT, c < dh; zero for
// rows at or beyond n (a transposed tile: column c of every row is contiguous)
template <typename CD>
__device__ __forceinline__ void load_t(float* t, const CD* src, int ld, int r0, int n, int dh) {
  for (int e = threadIdx.x; e < kT * dh; e += kAttnThreads) {
    const int r = e / dh, c = e % dh;
    t[c * kLd + r] = (r0 + r < n) ? to_f(src[(size_t)(r0 + r) * ld + c]) : 0.f;
  }
}

// t[r * kLd + c] = src row (r0 + r), column c (a row-major tile)
template <typename CD>
__device__ __forceinline__ void load_r(float* t, const CD* src, int ld, int r0, int n, int dh) {
  for (int e = threadIdx.x; e < kT * dh; e += kAttnThreads) {
    const int r = e / dh, c = e % dh;
    t[r * kLd + c] = (r0 + r < n) ? to_f(src[(size_t)(r0 + r) * ld + c]) : 0.f;
  }
}

// acc[r][c] = sum_k a[k][4 ty + r] * b[k][4 tx + c] over k < depth, from
// tiles stored with the contracted index as the row
__device__ __forceinline__ void tile_dot(const float* a, const float* b, int depth, int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k = 0; k < depth; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// acc[r][c] += sum_k a[k][4 ty + r] * b[k][4 tx + c] over k < kT
__device__ __forceinline__ void tile_acc(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < kT; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(a + k * kLd + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + k * kLd + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
  }
}

// Forward attention for one (query tile, head, sequence). qkv (B*N, 3D) CD;
// o (B*N, D) CD; stats (B, H, N, 2) f32 = (m, l) per query row.
template <typename CD>
__global__ void __launch_bounds__(kAttnThreads)
attn_fwd(const CD* __restrict__ qkv, CD* __restrict__ o, float* __restrict__ stats, int N,
         int H, int dh) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;           // [c][i]
  float* Kt = Qt + kTile;   // [c][j]
  float* Vs = Kt + kTile;   // [j][c]
  float* Pt = Vs + kTile;   // [j][i]
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const CD* q = qkv + (size_t)b * N * ld + h * dh;
  const CD* k = q + D;
  const CD* v = q + 2 * D;
  load_t(Qt, q, ld, i0, N, dh);

  float m[4], l[4], s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -INFINITY, l[r] = 0.f;
  // pass 1: row max and sum of exp over every key tile
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_t(Kt, k, ld, j0, N, dh);
    __syncthreads();
    tile_dot(Qt, Kt, dh, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) mx = fmaxf(mx, s[r][c]);
      const float mn = fmaxf(m[r], group16_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) e += expf(s[r][c] - mn);
      l[r] = l[r] * expf(m[r] - mn) + group16_sum(e);
      m[r] = mn;
    }
  }
  // pass 2: p = exp(s - m) / l rounded to CD, o = p @ v
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_t(Kt, k, ld, j0, N, dh);
    load_r(Vs, v, ld, j0, N, dh);
    __syncthreads();
    tile_dot(Qt, Kt, dh, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j0 + 4 * tx + c < N;
        Pt[(4 * tx + c) * kLd + 4 * ty + r] = ok ? rnd<CD>(expf(s[r][c] - m[r]) / l[r]) : 0.f;
      }
    __syncthreads();
    float pv[4][4];
    tile_dot(Pt, Vs, kT, ty, tx, pv);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += pv[r][c];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh) o[((size_t)b * N + i) * D + h * dh + 4 * tx + c] = from_f<CD>(acc[r][c]);
    if (tx == 0) {
      float* st = stats + (((size_t)b * H + h) * N + i) * 2;
      st[0] = m[r];
      st[1] = l[r];
    }
  }
}

// dq for one (query tile, head, sequence), and delta_i = sum_j p_ij dp_ij.
// dob (B*N, D) CD holds do = (dout*s) @ Wp^T; dq goes to columns [0, D) of
// dqkv32 (f32) and dqkvn (CD), both (B*N, 3D).
template <typename CD>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dq(const CD* __restrict__ qkv, const CD* __restrict__ dob,
            const float* __restrict__ stats, float* __restrict__ delta,
            float* __restrict__ dqkv32, CD* __restrict__ dqkvn, int N, int H, int dh) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;            // [c][i]
  float* dOt = Qt + kTile;   // [c][i]
  float* Kt = dOt + kTile;   // [c][j]
  float* Vt = Kt + kTile;    // [c][j]
  float* Ks = Vt + kTile;    // [j][c]
  float* dSt = Ks + kTile;   // [j][i]
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const CD* q = qkv + (size_t)b * N * ld + h * dh;
  const CD* k = q + D;
  const CD* v = q + 2 * D;
  load_t(Qt, q, ld, i0, N, dh);
  load_t(dOt, dob + (size_t)b * N * D + h * dh, D, i0, N, dh);
  float m[4], l[4], dl[4], s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    const float* st = stats + (((size_t)b * H + h) * N + (i < N ? i : 0)) * 2;
    m[r] = st[0];
    l[r] = st[1];
    dl[r] = 0.f;
  }
  // pass A: delta = sum_j p * dp
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_t(Kt, k, ld, j0, N, dh);
    load_t(Vt, v, ld, j0, N, dh);
    __syncthreads();
    tile_dot(Qt, Kt, dh, ty, tx, s);
    tile_dot(dOt, Vt, dh, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) part += (expf(s[r][c] - m[r]) / l[r]) * dp[r][c];
      dl[r] += group16_sum(part);
    }
  }
  // pass B: dS = p * (dp - delta) rounded to CD, dq = dS @ k
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_t(Kt, k, ld, j0, N, dh);
    load_t(Vt, v, ld, j0, N, dh);
    load_r(Ks, k, ld, j0, N, dh);
    __syncthreads();
    tile_dot(Qt, Kt, dh, ty, tx, s);
    tile_dot(dOt, Vt, dh, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j0 + 4 * tx + c < N;
        const float p = expf(s[r][c] - m[r]) / l[r];
        dSt[(4 * tx + c) * kLd + 4 * ty + r] = ok ? rnd<CD>(p * (dp[r][c] - dl[r])) : 0.f;
      }
    __syncthreads();
    tile_acc(dSt, Ks, ty, tx, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= N) continue;
    const size_t row = ((size_t)b * N + i) * ld + h * dh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh) {
        dqkv32[row + 4 * tx + c] = acc[r][c];
        dqkvn[row + 4 * tx + c] = from_f<CD>(acc[r][c]);
      }
    if (tx == 0) delta[((size_t)b * H + h) * N + i] = dl[r];
  }
}

// dk and dv for one (key tile, head, sequence): dv = p_CD^T do, dk = dS^T q,
// over every query tile in order; to columns [D, 2D) and [2D, 3D).
template <typename CD>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dkdv(const CD* __restrict__ qkv, const CD* __restrict__ dob,
              const float* __restrict__ stats, const float* __restrict__ delta,
              float* __restrict__ dqkv32, CD* __restrict__ dqkvn, int N, int H, int dh) {
  extern __shared__ __align__(16) float sm[];
  float* Kt = sm;            // [c][j]
  float* Vt = Kt + kTile;    // [c][j]
  float* Qt = Vt + kTile;    // [c][i]
  float* dOt = Qt + kTile;   // [c][i]
  float* Qs = dOt + kTile;   // [i][c]
  float* dOs = Qs + kTile;   // [i][c]
  float* Ps = dOs + kTile;   // [i][j]
  float* dSs = Ps + kTile;   // [i][j]
  __shared__ float mS[kT], lS[kT], dS_[kT];
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const CD* q = qkv + (size_t)b * N * ld + h * dh;
  const CD* k = q + D;
  const CD* v = q + 2 * D;
  const CD* dO = dob + (size_t)b * N * D + h * dh;
  load_t(Kt, k, ld, j0, N, dh);
  load_t(Vt, v, ld, j0, N, dh);
  float s[4][4], dp[4][4], dk[4][4], dv[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[r][c] = dv[r][c] = 0.f;
  for (int i0 = 0; i0 < N; i0 += kT) {
    __syncthreads();
    load_t(Qt, q, ld, i0, N, dh);
    load_r(Qs, q, ld, i0, N, dh);
    load_t(dOt, dO, D, i0, N, dh);
    load_r(dOs, dO, D, i0, N, dh);
    if (threadIdx.x < kT) {
      const int i = i0 + threadIdx.x;
      const size_t bh = (size_t)b * H + h;
      mS[threadIdx.x] = i < N ? stats[(bh * N + i) * 2] : 0.f;
      lS[threadIdx.x] = i < N ? stats[(bh * N + i) * 2 + 1] : 1.f;
      dS_[threadIdx.x] = i < N ? delta[bh * N + i] : 0.f;
    }
    __syncthreads();
    // rows 4 ty + r are queries, columns 4 tx + c keys
    tile_dot(Qt, Kt, dh, ty, tx, s);
    tile_dot(dOt, Vt, dh, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = i0 + il < N && j0 + 4 * tx + c < N;
        const float p = ok ? expf(s[r][c] - mS[il]) / lS[il] : 0.f;
        Ps[il * kLd + 4 * tx + c] = rnd<CD>(p);
        dSs[il * kLd + 4 * tx + c] = rnd<CD>(p * (dp[r][c] - dS_[il]));
      }
    }
    __syncthreads();
    // rows 4 ty + r are keys, columns 4 tx + c head dims
    tile_acc(Ps, dOs, ty, tx, dv);
    tile_acc(dSs, Qs, ty, tx, dk);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= N) continue;
    const size_t row = ((size_t)b * N + j) * ld + h * dh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh) {
        dqkv32[row + D + 4 * tx + c] = dk[r][c];
        dqkvn[row + D + 4 * tx + c] = from_f<CD>(dk[r][c]);
        dqkv32[row + 2 * D + 4 * tx + c] = dv[r][c];
        dqkvn[row + 2 * D + 4 * tx + c] = from_f<CD>(dv[r][c]);
      }
  }
}

// ------------------------------------------- tensor-core attention (bf16)
// The same three kernels for a bf16 compute dtype, with every tile product
// on the tensor cores (wmma 16x16x16 bf16, f32 accumulation). Tiles are bf16
// [row][c] in shared memory, zero beyond dh up to 64 columns; each 64x64
// score tile goes through f32 shared memory to the threads' 4x4 sub-tiles,
// which run the softmax algebra exactly as above; p and dS are rounded to
// bf16 into shared memory as the next product's operand. One helper forms
// every score tile, so the backward recomputes the forward's p bit for bit.
using bf16 = __nv_bfloat16;
namespace wm = nvcuda::wmma;
using FragAcc = wm::fragment<wm::accumulator, 16, 16, 16, float>;
constexpr int kHLd = kT + 8;  // bf16 tile row stride (a multiple of 8 elements)
constexpr int kHTile = kT * kHLd;

// t[r][c] = src row r0 + r, column c, for c < dh; zero elsewhere in 64 x 64
__device__ __forceinline__ void load_h(bf16* t, const bf16* src, int ld, int r0, int n, int dh) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < kT * kT; e += kAttnThreads) {
    const int r = e / kT, c = e % kT;
    t[r * kHLd + c] = (r0 + r < n && c < dh) ? src[(size_t)(r0 + r) * ld + c] : zero;
  }
}

// Warp w owns rows 16 (w / 2) and columns 32 (w % 2) + {0, 16} of a 64x64 result.
__device__ __forceinline__ void warp_tile(int& wr, int& wc) {
  const int warp = threadIdx.x / 32;
  wr = 16 * (warp / 2);
  wc = 32 * (warp % 2);
}

// out (64x64 f32, row stride kLd) = a . b^T over `depth` columns: every row
// of a against every row of b (scores q k^T, dp = do v^T)
__device__ __forceinline__ void tc_abt(const bf16* a, const bf16* b, int depth, float* out) {
  int wr, wc;
  warp_tile(wr, wc);
  FragAcc c[2];
  wm::fill_fragment(c[0], 0.f);
  wm::fill_fragment(c[1], 0.f);
  for (int kk = 0; kk < depth; kk += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
    wm::load_matrix_sync(fa, a + wr * kHLd + kk, kHLd);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
      wm::load_matrix_sync(fb, b + (wc + 16 * f) * kHLd + kk, kHLd);
      wm::mma_sync(c[f], fa, fb, c[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wm::store_matrix_sync(out + wr * kLd + wc + 16 * f, c[f], kLd, wm::mem_row_major);
}

// c += a . b over 64 (A_T: a^T . b), a and b stored [k][...] or [row][k]:
// a (row, k) row-major, or with A_T stored [k][row]; b (k, col) [k][col]
template <bool A_T>
__device__ __forceinline__ void tc_ab(const bf16* a, const bf16* b, FragAcc (&c)[2]) {
  using LA = typename std::conditional<A_T, wm::col_major, wm::row_major>::type;
  int wr, wc;
  warp_tile(wr, wc);
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    wm::fragment<wm::matrix_a, 16, 16, 16, bf16, LA> fa;
    wm::load_matrix_sync(fa, A_T ? a + kk * kHLd + wr : a + wr * kHLd + kk, kHLd);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
      wm::load_matrix_sync(fb, b + kk * kHLd + wc + 16 * f, kHLd);
      wm::mma_sync(c[f], fa, fb, c[f]);
    }
  }
}

__device__ __forceinline__ void tc_store(FragAcc (&c)[2], float* out) {
  int wr, wc;
  warp_tile(wr, wc);
#pragma unroll
  for (int f = 0; f < 2; ++f)
    wm::store_matrix_sync(out + wr * kLd + wc + 16 * f, c[f], kLd, wm::mem_row_major);
}

// v[r][c] = t[4 ty + r][4 tx + c] of an f32 64x64 tile
__device__ __forceinline__ void read44(const float* t, int ty, int tx, float (&v)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 q = *reinterpret_cast<const float4*>(t + (4 * ty + r) * kLd + 4 * tx);
    v[r][0] = q.x;
    v[r][1] = q.y;
    v[r][2] = q.z;
    v[r][3] = q.w;
  }
}

constexpr int kFwdTcSmem = 4 * kHTile * 2 + kTile * 4;
constexpr int kDqTcSmem = 5 * kHTile * 2 + 2 * kTile * 4;
constexpr int kDkdvTcSmem = 6 * kHTile * 2 + 2 * kTile * 4;

__global__ void __launch_bounds__(kAttnThreads)
attn_fwd_tc(const bf16* __restrict__ qkv, bf16* __restrict__ o, float* __restrict__ stats, int N,
            int H, int dh) {
  extern __shared__ __align__(32) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);  // [i][c]
  bf16* Ks = Qs + kHTile;                      // [j][c]
  bf16* Vs = Ks + kHTile;                      // [j][c]
  bf16* Ps = Vs + kHTile;                      // [i][j]
  float* Ss = reinterpret_cast<float*>(Ps + kHTile);
  const int D = H * dh, ld = 3 * D, depth = (dh + 15) / 16 * 16;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  load_h(Qs, q, ld, i0, N, dh);

  float m[4], l[4], s[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -INFINITY, l[r] = 0.f;
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_h(Ks, k, ld, j0, N, dh);
    __syncthreads();
    tc_abt(Qs, Ks, depth, Ss);
    __syncthreads();
    read44(Ss, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) mx = fmaxf(mx, s[r][c]);
      const float mn = fmaxf(m[r], group16_max(mx));
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) e += expf(s[r][c] - mn);
      l[r] = l[r] * expf(m[r] - mn) + group16_sum(e);
      m[r] = mn;
    }
  }
  FragAcc oc[2];
  wm::fill_fragment(oc[0], 0.f);
  wm::fill_fragment(oc[1], 0.f);
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_h(Ks, k, ld, j0, N, dh);
    load_h(Vs, v, ld, j0, N, dh);
    __syncthreads();
    tc_abt(Qs, Ks, depth, Ss);
    __syncthreads();
    read44(Ss, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j0 + 4 * tx + c < N;
        Ps[(4 * ty + r) * kHLd + 4 * tx + c] =
            __float2bfloat16_rn(ok ? expf(s[r][c] - m[r]) / l[r] : 0.f);
      }
    __syncthreads();
    tc_ab<false>(Ps, Vs, oc);
  }
  __syncthreads();
  tc_store(oc, Ss);
  __syncthreads();
  read44(Ss, ty, tx, s);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh)
        o[((size_t)b * N + i) * D + h * dh + 4 * tx + c] = __float2bfloat16_rn(s[r][c]);
    if (tx == 0) {
      float* st = stats + (((size_t)b * H + h) * N + i) * 2;
      st[0] = m[r];
      st[1] = l[r];
    }
  }
}

__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dq_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
               const float* __restrict__ stats, float* __restrict__ delta,
               float* __restrict__ dqkv32, bf16* __restrict__ dqkvn, int N, int H, int dh) {
  extern __shared__ __align__(32) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);  // [i][c]
  bf16* dOs = Qs + kHTile;                     // [i][c]
  bf16* Ks = dOs + kHTile;                     // [j][c]
  bf16* Vs = Ks + kHTile;                      // [j][c]
  bf16* dSs = Vs + kHTile;                     // [i][j]
  float* Ss = reinterpret_cast<float*>(dSs + kHTile);
  float* dPs = Ss + kTile;
  const int D = H * dh, ld = 3 * D, depth = (dh + 15) / 16 * 16;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  load_h(Qs, q, ld, i0, N, dh);
  load_h(dOs, dob + (size_t)b * N * D + h * dh, D, i0, N, dh);
  float m[4], l[4], dl[4], s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    const float* st = stats + (((size_t)b * H + h) * N + (i < N ? i : 0)) * 2;
    m[r] = st[0];
    l[r] = st[1];
    dl[r] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_h(Ks, k, ld, j0, N, dh);
    load_h(Vs, v, ld, j0, N, dh);
    __syncthreads();
    tc_abt(Qs, Ks, depth, Ss);
    tc_abt(dOs, Vs, depth, dPs);
    __syncthreads();
    read44(Ss, ty, tx, s);
    read44(dPs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + 4 * tx + c < N) part += (expf(s[r][c] - m[r]) / l[r]) * dp[r][c];
      dl[r] += group16_sum(part);
    }
  }
  FragAcc dq[2];
  wm::fill_fragment(dq[0], 0.f);
  wm::fill_fragment(dq[1], 0.f);
  for (int j0 = 0; j0 < N; j0 += kT) {
    __syncthreads();
    load_h(Ks, k, ld, j0, N, dh);
    load_h(Vs, v, ld, j0, N, dh);
    __syncthreads();
    tc_abt(Qs, Ks, depth, Ss);
    tc_abt(dOs, Vs, depth, dPs);
    __syncthreads();
    read44(Ss, ty, tx, s);
    read44(dPs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j0 + 4 * tx + c < N;
        const float p = expf(s[r][c] - m[r]) / l[r];
        dSs[(4 * ty + r) * kHLd + 4 * tx + c] =
            __float2bfloat16_rn(ok ? p * (dp[r][c] - dl[r]) : 0.f);
      }
    __syncthreads();
    tc_ab<false>(dSs, Ks, dq);
  }
  __syncthreads();
  tc_store(dq, Ss);
  __syncthreads();
  read44(Ss, ty, tx, s);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= N) continue;
    const size_t row = ((size_t)b * N + i) * ld + h * dh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh) {
        dqkv32[row + 4 * tx + c] = s[r][c];
        dqkvn[row + 4 * tx + c] = __float2bfloat16_rn(s[r][c]);
      }
    if (tx == 0) delta[((size_t)b * H + h) * N + i] = dl[r];
  }
}

__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dkdv_tc(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
                 const float* __restrict__ stats, const float* __restrict__ delta,
                 float* __restrict__ dqkv32, bf16* __restrict__ dqkvn, int N, int H, int dh) {
  extern __shared__ __align__(32) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);  // [j][c]
  bf16* Vs = Ks + kHTile;                      // [j][c]
  bf16* Qs = Vs + kHTile;                      // [i][c]
  bf16* dOs = Qs + kHTile;                     // [i][c]
  bf16* Ps = dOs + kHTile;                     // [i][j]
  bf16* dSs = Ps + kHTile;                     // [i][j]
  float* Ss = reinterpret_cast<float*>(dSs + kHTile);
  float* dPs = Ss + kTile;
  __shared__ float mS[kT], lS[kT], dS_[kT];
  const int D = H * dh, ld = 3 * D, depth = (dh + 15) / 16 * 16;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  const bf16* dO = dob + (size_t)b * N * D + h * dh;
  load_h(Ks, k, ld, j0, N, dh);
  load_h(Vs, v, ld, j0, N, dh);
  float s[4][4], dp[4][4];
  FragAcc dk[2], dv[2];
  for (int f = 0; f < 2; ++f) {
    wm::fill_fragment(dk[f], 0.f);
    wm::fill_fragment(dv[f], 0.f);
  }
  for (int i0 = 0; i0 < N; i0 += kT) {
    __syncthreads();
    load_h(Qs, q, ld, i0, N, dh);
    load_h(dOs, dO, D, i0, N, dh);
    if (threadIdx.x < kT) {
      const int i = i0 + threadIdx.x;
      const size_t bh = (size_t)b * H + h;
      mS[threadIdx.x] = i < N ? stats[(bh * N + i) * 2] : 0.f;
      lS[threadIdx.x] = i < N ? stats[(bh * N + i) * 2 + 1] : 1.f;
      dS_[threadIdx.x] = i < N ? delta[bh * N + i] : 0.f;
    }
    __syncthreads();
    tc_abt(Qs, Ks, depth, Ss);    // rows i, columns j
    tc_abt(dOs, Vs, depth, dPs);
    __syncthreads();
    read44(Ss, ty, tx, s);
    read44(dPs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = i0 + il < N && j0 + 4 * tx + c < N;
        const float p = ok ? expf(s[r][c] - mS[il]) / lS[il] : 0.f;
        Ps[il * kHLd + 4 * tx + c] = __float2bfloat16_rn(p);
        dSs[il * kHLd + 4 * tx + c] = __float2bfloat16_rn(p * (dp[r][c] - dS_[il]));
      }
    }
    __syncthreads();
    tc_ab<true>(Ps, dOs, dv);   // rows j, columns c
    tc_ab<true>(dSs, Qs, dk);
  }
  __syncthreads();
  tc_store(dk, Ss);
  tc_store(dv, dPs);
  __syncthreads();
  read44(Ss, ty, tx, s);
  read44(dPs, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= N) continue;
    const size_t row = ((size_t)b * N + j) * ld + h * dh;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * tx + c < dh) {
        dqkv32[row + D + 4 * tx + c] = s[r][c];
        dqkvn[row + D + 4 * tx + c] = __float2bfloat16_rn(s[r][c]);
        dqkv32[row + 2 * D + 4 * tx + c] = dp[r][c];
        dqkvn[row + 2 * D + 4 * tx + c] = __float2bfloat16_rn(dp[r][c]);
      }
  }
}

// Launch the attention kernels of compute dtype CD: the tensor-core bodies
// for bf16, the CUDA-core f32 bodies for float.
template <typename CD>
int launch_attn_fwd(const CD* qkv, CD* o, float* stats, int B, int N, int H, int dh,
                    cudaStream_t st) {
  const dim3 grid((N + kT - 1) / kT, H, B);
  if constexpr (std::is_same<CD, bf16>::value) {
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(attn_fwd_tc,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kFwdTcSmem));
    CEREBRA_VIT_CHECK(attn_fwd_tc<<<grid, kAttnThreads, kFwdTcSmem, st>>>(qkv, o, stats, N, H,
                                                                         dh));
  } else {
    const int smem = 4 * kTile * (int)sizeof(float);
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(attn_fwd<CD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    CEREBRA_VIT_CHECK(attn_fwd<CD><<<grid, kAttnThreads, smem, st>>>(qkv, o, stats, N, H, dh));
  }
  return 0;
}

template <typename CD>
int launch_attn_bwd(const CD* qkv, const CD* dob, const float* stats, float* delta,
                    float* dqkv32, CD* dqkvn, int B, int N, int H, int dh, cudaStream_t st) {
  const dim3 grid((N + kT - 1) / kT, H, B);
  if constexpr (std::is_same<CD, bf16>::value) {
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dq_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqTcSmem));
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dkdv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvTcSmem));
    CEREBRA_VIT_CHECK(attn_bwd_dq_tc<<<grid, kAttnThreads, kDqTcSmem, st>>>(
        qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh));
    CEREBRA_VIT_CHECK(attn_bwd_dkdv_tc<<<grid, kAttnThreads, kDkdvTcSmem, st>>>(
        qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh));
  } else {
    const int smem_dq = 6 * kTile * (int)sizeof(float);
    const int smem_dkdv = 8 * kTile * (int)sizeof(float);
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dq<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq));
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dkdv<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv));
    CEREBRA_VIT_CHECK(attn_bwd_dq<CD><<<grid, kAttnThreads, smem_dq, st>>>(
        qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh));
    CEREBRA_VIT_CHECK(attn_bwd_dkdv<CD><<<grid, kAttnThreads, smem_dkdv, st>>>(
        qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh));
  }
  return 0;
}

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

int row_blocks(int M) { return (M + kRowThreads / 32 - 1) / (kRowThreads / 32); }

template <typename SD, typename CD>
int attn_fwd_all(const SD* x, const float* s, const CD* g, const CD* b, const CD* wqkv,
                 const CD* bqkv, const CD* wp, const CD* bp, CD* y, float* mu, float* rstd,
                 CD* qkv, CD* o, float* stats, SD* out, int B, int N, int D, int H,
                 cudaStream_t st) {
  const int M = B * N, dh = D / H;
  CEREBRA_VIT_CHECK(ln_fwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, g, b, y, mu, rstd, M, D));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
      y, D, wqkv, 3 * D, M, 3 * D, D, EpiBiasRound<CD>{bqkv, qkv, 3 * D}, st));
  CEREBRA_VIT_RC(launch_attn_fwd<CD>(qkv, o, stats, B, N, H, dh, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
      o, D, wp, D, M, D, D, EpiResidual<SD, CD>{x, bp, s, N, out, D}, st));
  return 0;
}

template <typename SD, typename CD>
int attn_bwd_all(const SD* x, const SD* dout, const float* s, const CD* g, const CD* wqkv,
                 const CD* wp, const CD* y, const float* mu, const float* rstd, const CD* qkv,
                 const CD* o, const float* stats, CD* dn, CD* dob, float* delta, float* dqkv32,
                 CD* dqkvn, float* dy, float* scratch, SD* dx, float* dg, float* db,
                 float* dwqkv, float* dbqkv, float* dwp, float* dbp, int B, int N, int D, int H,
                 cudaStream_t st) {
  const int M = B * N, dh = D / H;
  const long long MD = (long long)M * D;
  // proj: dn = dout * s in CD; dbp = sum dout * s; dWp = o^T dn; do = dn @ Wp^T
  CEREBRA_VIT_CHECK(scale_round<SD, CD><<<(unsigned)((MD + 255) / 256), 256, 0, st>>>(
      dout, s, N, dn, MD, D));
  CEREBRA_VIT_RC(column_sum<SD>(dout, s, N, dbp, M, D, scratch, st));
  CEREBRA_VIT_RC(contract_rows<CD>(o, D, dn, D, M, dwp, scratch, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
      dn, D, wp, D, M, D, D, EpiBiasRound<CD>{nullptr, dob, D}, st));
  // attention
  CEREBRA_VIT_RC(launch_attn_bwd<CD>(qkv, dob, stats, delta, dqkv32, dqkvn, B, N, H, dh, st));
  // qkv weights: dWqkv = y^T dqkv_CD; dbqkv = sum dqkv (f32); dy = dqkv_CD @ Wqkv^T
  CEREBRA_VIT_RC(contract_rows<CD>(y, D, dqkvn, 3 * D, M, dwqkv, scratch, st));
  CEREBRA_VIT_RC(column_sum<float>(dqkv32, nullptr, 1, dbqkv, M, 3 * D, scratch, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
      dqkvn, 3 * D, wqkv, 3 * D, M, D, 3 * D, EpiF32{dy, D}, st));
  // LN affine and core backward
  CEREBRA_VIT_RC(ln_backward_cols<SD>(x, mu, rstd, dy, dg, db, M, D, scratch, st));
  CEREBRA_VIT_CHECK(ln_bwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, mu, rstd, dy, g, dout, dx, M, D));
  return 0;
}

}  // namespace

extern "C" {

// sd_bf16 / cd_bf16 != 0: the stream / compute dtype is bfloat16, else float.
// Outputs the backward reads: y (M, D) CD, mu and rstd (M) f32, qkv (M, 3D)
// CD, o (M, D) CD, stats (B, H, N, 2) f32.
int cerebra_vit_attn_fwd(int sd_bf16, int cd_bf16, const void* x, const float* s,
                         const void* g, const void* b, const void* wqkv, const void* bqkv,
                         const void* wp, const void* bp, void* y, float* mu, float* rstd,
                         void* qkv, void* o, float* stats, void* out, int B, int N, int D, int H,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  CEREBRA_DISPATCH(sd_bf16, cd_bf16,
                   (attn_fwd_all<SD, CD>((const SD*)x, s, (const CD*)g, (const CD*)b,
                                         (const CD*)wqkv, (const CD*)bqkv, (const CD*)wp,
                                         (const CD*)bp, (CD*)y, mu, rstd, (CD*)qkv, (CD*)o,
                                         stats, (SD*)out, B, N, D, H, st)));
}

// f32 scratch floats the backward needs for width D.
long long cerebra_vit_attn_scratch(int D) {
  const long long sums = (long long)kColSplits * 3 * D;
  const long long dw = (long long)kRowSplits * 3 * D * D;
  return sums > dw ? sums : dw;
}

// Scratch: dn (M, D) CD, dob (M, D) CD, delta (B, H, N) f32, dqkv32 (M, 3D)
// f32, dqkvn (M, 3D) CD, dy (M, D) f32, scratch (cerebra_vit_attn_scratch)
// f32. Outputs: dx (M, D) SD and f32 dg, db (D), dwqkv (D, 3D), dbqkv (3D),
// dwp (D, D), dbp (D).
int cerebra_vit_attn_bwd(int sd_bf16, int cd_bf16, const void* x, const void* dout,
                         const float* s, const void* g, const void* wqkv, const void* wp,
                         const void* y, const float* mu, const float* rstd, const void* qkv,
                         const void* o, const float* stats, void* dn, void* dob, float* delta,
                         float* dqkv32, void* dqkvn, float* dy, float* scratch, void* dx,
                         float* dg, float* db,
                         float* dwqkv, float* dbqkv, float* dwp, float* dbp, int B, int N, int D,
                         int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  CEREBRA_DISPATCH(sd_bf16, cd_bf16,
                   (attn_bwd_all<SD, CD>((const SD*)x, (const SD*)dout, s, (const CD*)g,
                                         (const CD*)wqkv, (const CD*)wp, (const CD*)y, mu, rstd,
                                         (const CD*)qkv, (const CD*)o, stats, (CD*)dn,
                                         (CD*)dob, delta, dqkv32, (CD*)dqkvn, dy, scratch,
                                         (SD*)dx, dg, db, dwqkv, dbqkv, dwp, dbp, B, N, D, H,
                                         st)));
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
