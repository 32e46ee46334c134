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
//             attention core (o, and each query row's m and l) -> o @ Wp +
//             bp, scaled, plus the residual;
//   backward: dout*s in CD -> dbp -> do = dn @ Wp^T -> dq core (query
//             tiles) -> dk/dv core (key tiles) -> dWp = o^T dn and dWqkv =
//             y^T dqkv -> dbqkv -> dy = dqkv @ Wqkv^T -> LN backward.
// The attention cores never hold more than a 64x64 tile of scores. In bf16
// the forward makes one pass over the keys (K15's flash_fwd_wgmma at scale
// 1): each key tile's scores rescale the running row max m, sum l and
// output, p~ = exp(s - m) over the running m is rounded to CD for p~ v, and o
// = (sum p~ v) / l is divided in f32 and rounded once at the end. The
// rounding of p~ has the same relative error as rounding the normalised p
// where the Pallas body rounds its full-row softmax, and no score-sized
// product or exp is formed twice. The forward saves each row's final m and
// l; the backward recomputes p = exp(s - m) / l from them and, for dS = p
// (dp - delta), takes delta_i = sum_c o_ic do_ic from the saved o (equal to
// the Pallas body's sum_j p_ij dp_ij, since o_i = sum_j p_ij v_ij and dp_ij =
// do_i . v_j), so dq too makes one pass over the keys. f32 compute keeps the
// two-pass bodies: pass 1 finds m and l, pass 2 rounds the normalised p;
// delta sums p dp over a pass of its own. Every dW is a contraction over
// rows summed in fixed chunks and a fixed order: deterministic, no atomics.
//
// The five dense products (qkv, proj, do, dy and the two dW) are 14.5 of the
// 26.8 TFLOP this half-block does in a main_dino step at batch 128 (12
// blocks, the teacher's forward too). In bf16 they run on wgmma_gemm.cuh as
// K7/K8's do: a TMA ring feeding wgmma, the epilogues on register pairs, dWp
// and dWqkv as one launch of two split-row contractions once the cores have
// written dqkv (`product`, `weight_grads`, `dw_splits`). The TMA needs
// 16-byte aligned bases and D % 8 == 0, as every ViT width has; other
// operands are refused (cudaErrorInvalidValue). f32 compute keeps
// vit_common.cuh's CUDA-core f32 body and its contract_rows.
//
// In bf16 the cores are bound by their tensor-core products (4 N^2 dh a
// head and sequence forward, 10 backward, as the bound counts them; the
// forward forms each score once on wgmma, dq forms three score-sized
// products a tile pair and dk/dv four) and by the exp of every score. So
// the scores never leave registers: the forward is K15's TMA ring into
// wgmma with p packed from the S accumulators into the register A operand;
// in the backward cores each warp owns 16 whole rows and packs p or dS,
// rounded, straight into the A fragment of the next mma.sync, the streamed
// tiles through a cp.async ring that overlaps the next tile's copy with
// this tile's math, one barrier a tile. In f32 the cores run on the CUDA
// cores with true f32 FMA.
//
// Rounding points follow the Pallas bodies but for the cores' p: LN in f32
// with eps 1e-6; y, q, k, v, o, dout*s, do, dS, dq, dk, dv rounded to CD
// where the body casts them; p rounded to CD unnormalised in the bf16
// forward, normalised in the backward and in f32; f32 accumulation;
// softmax, delta, dp, dbqkv, dbp, dg, db in f32; the residual stream in SD.

#include "vit_common.cuh"
#include "warp_mma.cuh"
#include "wgmma_gemm.cuh"

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

// s *= scale, rounded once (scale 1 leaves s as it is)
__device__ __forceinline__ void scale_tile(float (&s)[4][4], float scale) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = __fmul_rn(s[r][c], scale);
}

// Forward attention for one (query tile, head, sequence). qkv (B*N, 3D) CD;
// o (B*N, D) CD; stats (B, H, N, 2) f32 = (m, l) per query row.
// s = scale * q.k in f32 (K5: 1, its scale folded into Wq; K15: dh^-0.5).
template <typename CD>
__global__ void __launch_bounds__(kAttnThreads)
attn_fwd(const CD* __restrict__ qkv, CD* __restrict__ o, float* __restrict__ stats, int N,
         int H, int dh, float scale) {
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
    scale_tile(s, scale);
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
    scale_tile(s, scale);
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

// dq for one (query tile, head, sequence), and delta_i = sum_j p_ij dp_ij
// (K6), or with o given delta_i = sum_c o_ic do_ic (K15, the JAX library's
// di; the pass over the keys for delta is then skipped). dob (B*N, D) CD
// holds do = (dout*s) @ Wp^T, o (B*N, D) CD the forward's output; dq goes to
// columns [0, D) of dqkv32 (f32, where given) and dqkvn (CD), both (B*N,
// 3D). s = scale q.k; dS = p (dp - delta) scale, rounded to CD.
template <typename CD>
__global__ void __launch_bounds__(kAttnThreads)
attn_bwd_dq(const CD* __restrict__ qkv, const CD* __restrict__ dob, const CD* __restrict__ o,
            const float* __restrict__ stats, float* __restrict__ delta,
            float* __restrict__ dqkv32, CD* __restrict__ dqkvn, int N, int H, int dh,
            float scale) {
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
  if (o) {  // delta = sum_c o do, the columns split over the 16 threads of a row
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + 4 * ty + r;
      float part = 0.f;
      if (i < N) {
        const size_t row = ((size_t)b * N + i) * D + h * dh;
        for (int c = tx; c < dh; c += 16) part += to_f(o[row + c]) * to_f(dob[row + c]);
      }
      dl[r] = group16_sum(part);
    }
  }
  // pass A (K6): delta = sum_j p * dp
  for (int j0 = 0; j0 < (o ? 0 : N); j0 += kT) {
    __syncthreads();
    load_t(Kt, k, ld, j0, N, dh);
    load_t(Vt, v, ld, j0, N, dh);
    __syncthreads();
    tile_dot(Qt, Kt, dh, ty, tx, s);
    scale_tile(s, scale);
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
    scale_tile(s, scale);
    tile_dot(dOt, Vt, dh, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = j0 + 4 * tx + c < N;
        const float p = expf(s[r][c] - m[r]) / l[r];
        dSt[(4 * tx + c) * kLd + 4 * ty + r] =
            ok ? rnd<CD>(__fmul_rn(p * (dp[r][c] - dl[r]), scale)) : 0.f;
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
        if (dqkv32) dqkv32[row + 4 * tx + c] = acc[r][c];
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
              float* __restrict__ dqkv32, CD* __restrict__ dqkvn, int N, int H, int dh,
              float scale) {
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
    scale_tile(s, scale);
    tile_dot(dOt, Vt, dh, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = i0 + il < N && j0 + 4 * tx + c < N;
        const float p = ok ? expf(s[r][c] - mS[il]) / lS[il] : 0.f;
        Ps[il * kLd + 4 * tx + c] = rnd<CD>(p);
        dSs[il * kLd + 4 * tx + c] = rnd<CD>(__fmul_rn(p * (dp[r][c] - dS_[il]), scale));
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
        if (dqkv32) {
          dqkv32[row + D + 4 * tx + c] = dk[r][c];
          dqkv32[row + 2 * D + 4 * tx + c] = dv[r][c];
        }
        dqkvn[row + D + 4 * tx + c] = from_f<CD>(dk[r][c]);
        dqkvn[row + 2 * D + 4 * tx + c] = from_f<CD>(dv[r][c]);
      }
  }
}

// ------------------------------------------------ attention cores (bf16)
// The two backward kernels for a bf16 compute dtype, on mma.sync m16n8k16
// (bf16 operands, f32 sums), with every score tile in registers (the bf16
// forward is K15's flash_fwd_wgmma, below). A CTA of four warps owns 64
// rows of one (sequence, head): query rows in dq, key rows in dk/dv; warp w
// owns rows 16 w .. 16 w + 15 across every column, so a row's sums stay in
// the four lanes of a quad (two shuffles). Its own rows' operands go from
// shared memory into A fragments once; the other side's 64-row tiles stream
// through a ring of kStages shared-memory stages filled by cp.async
// (16-byte copies, zero fill past N) while the previous tile is being used,
// one barrier a tile.
// Tiles are bf16 [row][c], rows kLdH = 72 values apart (the 8 rows an
// ldmatrix reads land in 8 different 4-bank groups), zero from dh up to
// the depth KD * 16.
using bf16 = __nv_bfloat16;
constexpr int kRows = 64;            // rows a CTA owns, and rows of a ring tile
constexpr int kMmaThreads = 128;     // four warps of 16 rows
constexpr int kLdH = kT + 8;         // bf16 row stride of a shared tile
constexpr int kHTile = kRows * kLdH;
constexpr int kStages = 2;
// CTAs an SM holds, as the launch bounds ask: 4 for dq (registers capped
// at 128 a thread) and 3 for dk/dv (168 registers); none spills (nvcc
// -Xptxas -v).

// Shared memory of each kernel, bytes: its own rows' tiles and the ring.
constexpr int kDqSmem = (2 + 2 * kStages) * kHTile * 2;                  // Q, dO | (K, V)
constexpr int kDkdvSmem = (2 + 2 * kStages) * kHTile * 2 + kStages * kRows * 3 * 4;

// t[r][c] = src row r0 + r, column c, for r < 64 and c < KD * 16; zero at
// rows >= n and columns >= dh. vec (dh % 8 == 0, 16-byte aligned rows):
// cp.async of 8 values, completed by the caller's cp_async_wait and barrier;
// else one value at a time, visible after the caller's barrier.
template <int KD>
__device__ __forceinline__ void load_tile(bf16* t, const bf16* src, int ld, int r0, int n,
                                          int dh, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kRows * 2 * KD; e += kMmaThreads) {
      const int r = e / (2 * KD), c = 8 * (e % (2 * KD));
      bf16* d = t + r * kLdH + c;
      if (c < dh)
        tc::cp_async<16>(d, src + (size_t)(r0 + r < n ? r0 + r : 0) * ld + c, r0 + r < n);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < kRows * 16 * KD; e += kMmaThreads) {
      const int r = e / (16 * KD), c = e % (16 * KD);
      t[r * kLdH + c] = (r0 + r < n && c < dh) ? src[(size_t)(r0 + r) * ld + c] : zero;
    }
  }
}

// a[kk] = the A fragments of this warp's 16 rows of tile t, k-steps kk < KD
template <int KD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const bf16* t) {
  const int lane = threadIdx.x % 32;
  const bf16* p = t + (16 * (threadIdx.x / 32) + lane % 8 + 8 * (lane / 8 % 2)) * kLdH;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) tc::ldmatrix_x4(a[kk], p + 16 * kk + 8 * (lane / 16));
}

// s = a . t[c16 .. c16 + 15]^T: this warp's 16 rows against 16 rows of tile
// t (two n8 tiles), summed over k-steps 0 .. KD-1 in order from zero. Every
// score of both backward cores is formed here, so a score recomputed with
// its operands swapped (S^T = K Q^T in dk/dv) adds the same products in the
// same order as dq.
template <int KD>
__device__ __forceinline__ void score16(float (&s)[2][4], const uint32_t (&a)[KD][4],
                                        const bf16* t, int c16) {
  const int lane = threadIdx.x % 32;
  const bf16* p = t + (c16 + lane % 8 + 8 * (lane / 16)) * kLdH + 8 * (lane / 8 % 2);
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[f][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t b[4];
    tc::ldmatrix_x4(b, p + 16 * kk);
    tc::mma_bf16(s[0], a[kk], b[0], b[1]);
    tc::mma_bf16(s[1], a[kk], b[2], b[3]);
  }
}

// acc[n8] += pa . t[k16 .. k16 + 15][n8 tiles]: the packed 16-column A
// fragment pa against 16 rows of tile t as the k side (ldmatrix.trans), for
// every n8 tile of the depth
template <int KD>
__device__ __forceinline__ void acc16(float (&acc)[2 * KD][4], const uint32_t (&pa)[4],
                                      const bf16* t, int k16) {
  const int lane = threadIdx.x % 32;
  const bf16* p = t + (k16 + lane % 8 + 8 * (lane / 8 % 2)) * kLdH + 8 * (lane / 16);
#pragma unroll
  for (int nd = 0; nd < KD; ++nd) {
    uint32_t b[4];
    tc::ldmatrix_x4_trans(b, p + 16 * nd);
    tc::mma_bf16(acc[2 * nd], pa, b[0], b[1]);
    tc::mma_bf16(acc[2 * nd + 1], pa, b[2], b[3]);
  }
}

// the A fragment of 16 columns from their two n8 C fragments
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4], const float (&c)[2][4]) {
  pa[0] = tc::pack_bf16(c[0][0], c[0][1]);
  pa[1] = tc::pack_bf16(c[0][2], c[0][3]);
  pa[2] = tc::pack_bf16(c[1][0], c[1][1]);
  pa[3] = tc::pack_bf16(c[1][2], c[1][3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(scale s - m) as every core forms it, 2^(s sL - m log2e) with sL =
// scale log2e (K5/K6: scale 1, sL = log2e) and mL = m log2e: one FMA and
// the MUFU ex2; the backward's p is that times rl = 1 / l (both rounded to
// nearest). dq and dk/dv run exactly these instructions on the same scores,
// so they form the same p; the forward forms its exp so too, over its
// running max.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp_sm(float s, float sL, float mL) {
  return ex2(__fmaf_rn(s, sL, -mL));
}

__device__ __forceinline__ float log2e_of(float m) { return __fmul_rn(m, kLog2e); }

// column col of the 64-column tile at j0 lies below n; always true in a full
// tile, where Masked is std::false_type (the kernels branch once a tile)
template <class Masked>
__device__ __forceinline__ bool col_ok(Masked, int j0, int col, int n) {
  return !Masked::value || j0 + col < n;
}

// f(false_type) for a full tile at j0, f(true_type) for the ragged last one
template <class F>
__device__ __forceinline__ void by_tile(int j0, int n, F f) {
  if (j0 + kRows <= n)
    f(std::false_type{});
  else
    f(std::true_type{});
}

// Write this warp's 16 x (KD * 16) accumulators, rows r0 + 16 w + (g, g + 8),
// to f32 (if out32) and bf16 tiles whose row r starts at base + r * ld; only
// rows < n and columns < dh.
template <int KD>
__device__ __forceinline__ void store_rows(const float (&acc)[2 * KD][4], float* out32,
                                           bf16* out16, size_t ld, int r0, int n, int dh) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * (threadIdx.x / 32) + g + 8 * half;
    if (r >= n) continue;
#pragma unroll
    for (int nd = 0; nd < 2 * KD; ++nd) {
      const int c = 8 * nd + 2 * t;
      const float v0 = acc[nd][2 * half], v1 = acc[nd][2 * half + 1];
      const size_t at = (size_t)r * ld + c;
      if (dh % 2 == 0 && c < dh) {  // an even dh keeps every pair 4- and 8-byte aligned
        if (out32) *reinterpret_cast<float2*>(out32 + at) = make_float2(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(out16 + at) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (c < dh) {
          if (out32) out32[at] = v0;
          out16[at] = __float2bfloat16_rn(v0);
        }
        if (c + 1 < dh) {
          if (out32) out32[at + 1] = v1;
          out16[at + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// dq for one (query tile, head, sequence), and delta_i = sum_c o_ic do_ic
// from the forward's output o (B*N, D) (the JAX library's di; equal to the
// Pallas body's sum_j p_ij dp_ij), so the ring runs K and V once. dob (B*N,
// D) holds do; dq goes to columns [0, D) of dqkv32 (f32, where given) and
// dqkvn (bf16), both (B*N, 3D). s = scale q.k; dS = p (dp - delta) scale,
// rounded into the A fragment of dS k (sL = scale log2e).
template <int KD>
__global__ void __launch_bounds__(kMmaThreads, 4)
attn_bwd_dq_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
                const bf16* __restrict__ o, const float* __restrict__ stats,
                float* __restrict__ delta, float* __restrict__ dqkv32,
                bf16* __restrict__ dqkvn, int N, int H, int dh, int vec, float scale, float sL) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Qs = reinterpret_cast<bf16*>(smraw);
  bf16* dOs = Qs + kHTile;
  bf16* ring = dOs + kHTile;  // stage st: K at ring + 2 st kHTile, V after it
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  const int nt = (N + kRows - 1) / kRows;

  auto fetch = [&](int it) {
    if (it < nt) {
      bf16* st = ring + 2 * (it % kStages) * kHTile;
      const int j0 = it * kRows;
      load_tile<KD>(st, k, ld, j0, N, dh, vec);
      load_tile<KD>(st + kHTile, v, ld, j0, N, dh, vec);
    }
    tc::cp_async_commit();
  };
  load_tile<KD>(Qs, q, ld, i0, N, dh, vec);
  load_tile<KD>(dOs, dob + (size_t)b * N * D + h * dh, D, i0, N, dh, vec);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float mL[2], rl[2], dl[2], acc[2 * KD][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * r;
    const float* st = stats + (((size_t)b * H + h) * N + (i < N ? i : 0)) * 2;
    mL[r] = log2e_of(st[0]);
    rl[r] = __frcp_rn(st[1]);
    float part = 0.f;  // this lane's columns t, t + 4, ... of its row, summed over the quad
    if (i < N) {
      const size_t row = ((size_t)b * N + i) * D + h * dh;
      for (int c = t; c < dh; c += 4)
        part += __bfloat162float(o[row + c]) * __bfloat162float(dob[row + c]);
    }
    dl[r] = quad_sum(part);
  }
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  uint32_t qa[KD][4], da[KD][4];

  for (int it = 0; it < nt; ++it) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it == 0) {
      load_a<KD>(qa, Qs);
      load_a<KD>(da, dOs);
    }
    fetch(it + kStages - 1);
    const bf16* Ks = ring + 2 * (it % kStages) * kHTile;
    const int j0 = it * kRows;
    by_tile(j0, N, [&](auto masked) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s[2][4], dp[2][4];
        score16<KD>(s, qa, Ks, 16 * c);
        score16<KD>(dp, da, Ks + kHTile, 16 * c);
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __fmul_rn(exp_sm(s[f][e], sL, mL[e / 2]), rl[e / 2]);
            s[f][e] = col_ok(masked, j0, 16 * c + 8 * f + 2 * t + e % 2, N)
                          ? __fmul_rn(p * (dp[f][e] - dl[e / 2]), scale) : 0.f;
          }
        uint32_t pa[4];
        pack_a(pa, s);
        acc16<KD>(acc, pa, Ks, 16 * c);
      }
    });
  }
  tc::cp_async_wait<0>();
  const size_t row0 = (size_t)b * N * ld + h * dh;
  store_rows<KD>(acc, dqkv32 ? dqkv32 + row0 : nullptr, dqkvn + row0, ld, i0, N, dh);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 16 * (threadIdx.x / 32) + lane / 4 + 8 * r;
      if (i < N) delta[((size_t)b * H + h) * N + i] = dl[r];
    }
}

// dk and dv for one (key tile, head, sequence): dv = p_bf16^T do, dk = dS^T q
// over every query tile in order; to columns [D, 2D) and [2D, 3D). The key
// rows are the A side: S^T = K Q^T and dP^T = V dO^T come out with a key per
// row, so p^T and dS^T are already the A fragments of p^T do and dS^T q. The
// ring carries each query tile's Q, dO and its rows' m, l and delta.
template <int KD>
__global__ void __launch_bounds__(kMmaThreads, 3)
attn_bwd_dkdv_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
                  const float* __restrict__ stats, const float* __restrict__ delta,
                  float* __restrict__ dqkv32, bf16* __restrict__ dqkvn, int N, int H, int dh,
                  int vec, float scale, float sL) {
  extern __shared__ __align__(16) unsigned char smraw[];
  bf16* Ks = reinterpret_cast<bf16*>(smraw);
  bf16* Vs = Ks + kHTile;
  bf16* ring = Vs + kHTile;  // stage st: Q at ring + 2 st kHTile, dO after it
  // stage st's rows: (m, l) pairs at rowst + st 3 kRows, delta after them;
  // each pair becomes (m log2e, 1 / l) once it has landed
  float* rowst = reinterpret_cast<float*>(ring + 2 * kStages * kHTile);
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  const bf16* k = q + D;
  const bf16* v = q + 2 * D;
  const bf16* dO = dob + (size_t)b * N * D + h * dh;
  const size_t bh = (size_t)b * H + h;
  const int nt = (N + kRows - 1) / kRows;

  auto fetch = [&](int it) {
    if (it < nt) {
      bf16* st = ring + 2 * (it % kStages) * kHTile;
      const int r0 = it * kRows;
      load_tile<KD>(st, q, ld, r0, N, dh, vec);
      load_tile<KD>(st + kHTile, dO, D, r0, N, dh, vec);
      float* rs = rowst + (it % kStages) * kRows * 3;
      const int r = threadIdx.x % kRows, i = r0 + r < N ? r0 + r : 0;
      if (threadIdx.x < kRows)
        tc::cp_async<8>(rs + 2 * r, stats + (bh * N + i) * 2, r0 + r < N);
      else
        tc::cp_async<4>(rs + 2 * kRows + r, delta + bh * N + i, r0 + r < N);
    }
    tc::cp_async_commit();
  };
  load_tile<KD>(Ks, k, ld, j0, N, dh, vec);
  load_tile<KD>(Vs, v, ld, j0, N, dh, vec);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  float dk[2 * KD][4], dv[2 * KD][4];
#pragma unroll
  for (int nd = 0; nd < 2 * KD; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;
  uint32_t ka[KD][4], va[KD][4];

  for (int it = 0; it < nt; ++it) {
    tc::cp_async_wait<kStages - 2>();
    if (threadIdx.x < kRows) {  // this thread's own copy: (m, l) -> (m log2e, 1 / l)
      float* ml = rowst + (it % kStages) * kRows * 3 + 2 * threadIdx.x;
      ml[0] = log2e_of(ml[0]);
      ml[1] = __frcp_rn(ml[1]);
    }
    __syncthreads();
    if (it == 0) {
      load_a<KD>(ka, Ks);
      load_a<KD>(va, Vs);
    }
    fetch(it + kStages - 1);
    const bf16* Qs = ring + 2 * (it % kStages) * kHTile;
    const float* rs = rowst + (it % kStages) * kRows * 3;
    const int i0 = it * kRows;
    by_tile(i0, N, [&](auto masked) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float s[2][4], dp[2][4];
        score16<KD>(s, ka, Qs, 16 * c);  // rows keys, columns queries
        score16<KD>(dp, va, Qs + kHTile, 16 * c);
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = 16 * c + 8 * f + 2 * t + e % 2;
            const float p =
                col_ok(masked, i0, il, N)
                    ? __fmul_rn(exp_sm(s[f][e], sL, rs[2 * il]), rs[2 * il + 1]) : 0.f;
            s[f][e] = p;
            dp[f][e] = __fmul_rn(p * (dp[f][e] - rs[2 * kRows + il]), scale);
          }
        uint32_t pa[4], da[4];
        pack_a(pa, s);
        pack_a(da, dp);
        acc16<KD>(dv, pa, Qs + kHTile, 16 * c);
        acc16<KD>(dk, da, Qs, 16 * c);
      }
    });
  }
  tc::cp_async_wait<0>();
  const size_t row0 = (size_t)b * N * ld + h * dh;
  store_rows<KD>(dk, dqkv32 ? dqkv32 + row0 + D : nullptr, dqkvn + row0 + D, ld, j0, N, dh);
  store_rows<KD>(dv, dqkv32 ? dqkv32 + row0 + 2 * D : nullptr, dqkvn + row0 + 2 * D, ld, j0, N,
                 dh);
}

// S (B, H, N, N) from dq's orientation (A = q rows, B = k rows) and St (B,
// H, N, N) from dk/dv's (A = k rows, B = q rows), both through score16: for
// the card test that the backward cores recompute the same scores bit for
// bit, and the forward's saved row max from them.
template <int KD>
__global__ void __launch_bounds__(kMmaThreads)
attn_scores_mma(const bf16* __restrict__ qkv, float* __restrict__ S, float* __restrict__ St,
                int N, int H, int dh, int vec) {
  __shared__ __align__(16) bf16 Qs[kHTile], Ks[kHTile];
  const int D = H * dh, ld = 3 * D;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4, w = threadIdx.x / 32;
  const bf16* q = qkv + (size_t)b * N * ld + h * dh;
  load_tile<KD>(Qs, q, ld, i0, N, dh, vec);
  load_tile<KD>(Ks, q + D, ld, j0, N, dh, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t a[KD][4];
  for (int side = 0; side < 2; ++side) {
    load_a<KD>(a, side ? Ks : Qs);
    const int r0 = side ? j0 : i0, c0 = side ? i0 : j0;
    float* out = (side ? St : S) + (size_t)bh * N * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s[2][4];
      score16<KD>(s, a, side ? Qs : Ks, 16 * c);
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * w + g + 8 * (e / 2), col = c0 + 16 * c + 8 * f + 2 * t + e % 2;
          if (r < N && col < N) out[(size_t)r * N + col] = s[f][e];
        }
    }
  }
}

// the depth in k-steps of 16 for head dim dh <= 64, as a template argument
template <class F>
int with_kd(int dh, F f) {
  switch ((dh + 15) / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
  }
  return (int)cudaErrorInvalidValue;
}

// 16-byte copies need a head dim of 8k and 16-byte aligned bases
bool vec_ok(int dh, const void* a, const void* b) {
  return dh % 8 == 0 && ((uintptr_t)a % 16) == 0 && ((uintptr_t)b % 16) == 0;
}

// ------------------------------------ the bf16 forward core (K15, K5)
// Replaces the forward of cerebra/models/vit.py:_flash_mha, which calls the
// JAX library's Pallas TPU flash_attention: one pass over the keys with an
// online softmax, f32 running max m, sum l and output o, o rescaled by
// exp(m_old - m_new) as m grows, the scale applied to the f32 scores, p =
// exp(scale s - m) rounded to bf16 for p v, o = (sum p v) / l rounded at
// the end. K5's bf16 core is the same kernel at scale 1 (K5 folds its scale
// into Wq). It reads q, k and v straight from the qkv rows (B, N, 3D) of
// the dense layer and writes o (B, N, D) for proj.
// What bounds it: the tensor-core products (4 N^2 dh a head and sequence,
// 15.1 GFLOP at main_dino's globals, 0.015 ms at 989 TFLOP/s) and the exp of
// every score (the MUFU's 16 a cycle an SM: 0.009 ms), not the bytes. The
// design: a CTA owns 64 query rows of one (sequence, head), one consumer
// warpgroup and one producer warp, four CTAs an SM (a consumer waits on its
// own products, so the SM interleaves four; two warpgroups a CTA with a
// 3-stage ring, two CTAs an SM, took 0.086 ms against 0.071 on an H100 at
// main_dino's globals). The producer asks the TMA for the Q tile once, then
// for each 64-key tile's K and V into a ring of kFlashStages stages
// (128-byte swizzle; a rank-4 map (c, which q/k/v and head, row, sequence)
// zero-fills the columns past dh and the rows past N, so the ragged last
// key tile and the last query tile need no copy of their own); completion
// lands on the stage's "full" mbarrier and the consumer frees the stage on
// its "empty" one. A consumer runs
// S = Q K^T as wgmma m64n64k16 from shared memory (KD k-steps of 16),
// masks the keys past N, scales, takes the row max with two quad shuffles,
// forms p with one FMA and ex2 a score, rescales its o accumulators, and
// packs p, rounded, from the S accumulators straight into the register A
// operand of o += P V (wgmma m64n64k16, V MN-major from shared memory). A
// head dim that the TMA cannot cut (dh % 8, or an unaligned base) has the
// producer warp copy the same swizzled tiles itself.
constexpr int kFlashWG = 1;                          // consumer warpgroups of 64 query rows
constexpr int kFlashRows = 64 * kFlashWG;            // query rows a CTA owns
constexpr int kFlashStages = 2;                      // K/V stages of the ring
constexpr int kFlashThreads = 128 * kFlashWG + 32;   // + the producer warp
constexpr int kFlashTile = 64 * 64;                  // bf16 values of a tile: 64 rows of 128 bytes
constexpr int kFlashSmem =
    (kFlashWG + 2 * kFlashStages) * kFlashTile * 2 + (2 * kFlashStages + 1) * 8 + 1024;

// element (r, c) of a 64 x 64 bf16 tile under the 128-byte swizzle: the
// 16-byte chunk c / 8 of row r lands at chunk (c / 8) ^ (r % 8)
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// the producer warp's copy of a tile where the TMA cannot cut it: rows r0 ..
// r0 + 63 of src (row stride ld), columns < dh, zero elsewhere; then the
// async-proxy fence that lets wgmma read what the warp stored
__device__ __forceinline__ void flash_fill(bf16* t, const bf16* src, int ld, int r0, int n,
                                           int dh) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x % 32; e < kFlashTile; e += 32) {
    const int r = e >> 6, c = e & 63;
    t[swizzled(r, c)] = (r0 + r < n && c < dh) ? src[(size_t)(r0 + r) * ld + c] : zero;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
}

// qkv (B, N, 3D) bf16 -> o (B, N, D) bf16 and stats (B, H, N, 2) f32 = (m,
// l) of each query row, m the max of scale s. sL = scale log2e.
template <int KD>
__global__ void __launch_bounds__(kFlashThreads, 4)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map, const bf16* __restrict__ qkv,
                bf16* __restrict__ o, float* __restrict__ stats, int N, int H, int dh,
                float scale, float sL, int tma) {
  extern __shared__ unsigned char smraw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  bf16* Qs = reinterpret_cast<bf16*>(base);  // warpgroup g's Q tile at Qs + g kFlashTile
  bf16* ring = Qs + kFlashWG * kFlashTile;   // stage st: K at ring + 2 st kFlashTile, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * kFlashStages * kFlashTile);
  uint64_t* empty = full + kFlashStages;
  uint64_t* qbar = empty + kFlashStages;
  const int D = H * dh, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kFlashRows;
  const int nt = (N + 63) / 64, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kFlashStages; ++st) {
      wg::mbar_init(&full[st], 1);
      wg::mbar_init(&empty[st], kFlashWG);
    }
    wg::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kFlashWG) {  // the producer: lane 0 through the TMA, else the warp
    if (tma && lane != 0) return;
    const bf16* seq = qkv + (size_t)b * N * ld + h * dh;
    if (tma) {
      wg::mbar_expect_tx(qbar, kFlashWG * kFlashTile * 2);
      for (int g = 0; g < kFlashWG; ++g)
        wg::tma_load4(Qs + g * kFlashTile, &map, qbar, 0, h, i0 + 64 * g, b);
    } else {
      for (int g = 0; g < kFlashWG; ++g)
        flash_fill(Qs + g * kFlashTile, seq, ld, i0 + 64 * g, N, dh);
      if (lane == 0) wg::mbar_arrive(qbar);
    }
    for (int it = 0; it < nt; ++it) {
      const int st = it % kFlashStages;
      bf16* K = ring + 2 * st * kFlashTile;
      if (it >= kFlashStages) wg::mbar_wait(&empty[st], (it / kFlashStages - 1) & 1);
      if (tma) {
        wg::mbar_expect_tx(&full[st], 2 * kFlashTile * 2);
        wg::tma_load4(K, &map, &full[st], 0, H + h, 64 * it, b);
        wg::tma_load4(K + kFlashTile, &map, &full[st], 0, 2 * H + h, 64 * it, b);
      } else {
        flash_fill(K, seq + D, ld, 64 * it, N, dh);
        flash_fill(K + kFlashTile, seq + 2 * D, ld, 64 * it, N, dh);
        if (lane == 0) wg::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  const int g = warp / 4, t = lane % 4;
  const char* Qg = reinterpret_cast<const char*>(Qs + g * kFlashTile);
  float acc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wg::mbar_wait(qbar, 0);

  for (int it = 0; it < nt; ++it) {
    const int st = it % kFlashStages, j0 = 64 * it;
    wg::mbar_wait(&full[st], (it / kFlashStages) & 1);
    const char* K = reinterpret_cast<const char*>(ring + 2 * st * kFlashTile);
    const char* V = K + kFlashTile * 2;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg::fence_regs(s);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      wg::mma_n64_ss(s, wg::desc(Qg + 32 * kk, 16, 1024), wg::desc(K + 32 * kk, 16, 1024), kk);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(s);

    // the new row max of scale s over the valid keys, then p and the sums
    const bool ragged = j0 + 64 > N;
    float mn[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t + i % 2;
      if (!ragged || j0 + col < N) mn[(i / 2) % 2] = fmaxf(mn[(i / 2) % 2], __fmul_rn(s[i], scale));
    }
    float mL[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = quad_max(mn[r]);
      alpha[r] = ex2(log2e_of(m[r] - mn[r]));  // 0 at the first tile (m = -inf)
      mL[r] = log2e_of(mn[r]);
      m[r] = mn[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t + i % 2, r = (i / 2) % 2;
      s[i] = (!ragged || j0 + col < N) ? exp_sm(s[i], sL, mL[r]) : 0.f;
      sum[r] += s[i];
      acc[i] *= alpha[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = tc::pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = tc::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = tc::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = tc::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wg::fence_regs(acc);
    wg::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wg::mma_n64_rs(acc, pa[kk], wg::desc(V + 2048 * kk, 8192, 1024));
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(acc);
    if (threadIdx.x % 128 == 0) wg::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = __fdiv_rn(acc[i], l[(i / 2) % 2]);
  store_rows<4>(*reinterpret_cast<float(*)[8][4]>(acc), nullptr, o + (size_t)b * N * D + h * dh,
                D, i0, N, dh);
  if (t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 16 * warp + lane / 4 + 8 * r;
      if (i < N) {
        float* sp = stats + (((size_t)b * H + h) * N + i) * 2;
        sp[0] = m[r];
        sp[1] = l[r];
      }
    }
}

// The rank-4 map of the qkv rows (B, N, 3D) for K15's forward: (c < dh, q/k/v
// and head 3H, row N, sequence B), boxes of 64 c x 1 x 64 rows x 1, the
// 128-byte swizzle; zero fill past dh and N.
int flash_map(CUtensorMap* map, const bf16* qkv, int B, int N, int H, int dh) {
  const wg::EncodeTiled fn = wg::encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)3 * H, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)3 * H * dh * 2,
                                 (cuuint64_t)N * 3 * H * dh * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<bf16*>(qkv), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// K15's bf16 forward: through the TMA where dh % 8 == 0 and qkv is 16-byte
// aligned (tma_used set to 1), else with the producer warp's copies.
int launch_flash_fwd(const bf16* qkv, bf16* o, float* stats, int B, int N, int H, int dh,
                     float scale, int* tma_used, cudaStream_t st) {
  CUtensorMap map{};
  int tma = dh % 8 == 0 && ((uintptr_t)qkv % 16) == 0;
  if (tma) tma = flash_map(&map, qkv, B, N, H, dh) == 0;
  if (tma_used) *tma_used = tma;
  const dim3 grid((N + kFlashRows - 1) / kFlashRows, H, B);
  const float sL = scale * kLog2e;
  return with_kd(dh, [&](auto kd) {
    auto kern = flash_fwd_wgmma<decltype(kd)::value>;
    CEREBRA_VIT_CHECK(
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kFlashSmem));
    CEREBRA_VIT_CHECK(kern<<<grid, kFlashThreads, kFlashSmem, st>>>(map, qkv, o, stats, N, H, dh,
                                                                    scale, sL, tma));
    return 0;
  });
}

// The forward core of compute dtype CD: s = scale q.k in f32 (K5: 1, its
// scale folded into Wq). bf16: flash_fwd_wgmma, one pass over the keys
// (*tma_used says whether the TMA brought the tiles); f32: the CUDA-core
// two-pass body.
template <typename CD>
int launch_attn_fwd(const CD* qkv, CD* o, float* stats, int B, int N, int H, int dh,
                    cudaStream_t st, float scale = 1.f, int* tma_used = nullptr) {
  if constexpr (std::is_same<CD, bf16>::value) {
    return launch_flash_fwd(qkv, o, stats, B, N, H, dh, scale, tma_used, st);
  } else {
    if (tma_used) *tma_used = 0;
    const dim3 grid((N + kT - 1) / kT, H, B);
    const int smem = 4 * kTile * (int)sizeof(float);
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(attn_fwd<CD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    CEREBRA_VIT_CHECK(
        attn_fwd<CD><<<grid, kAttnThreads, smem, st>>>(qkv, o, stats, N, H, dh, scale));
    return 0;
  }
}

// The backward cores of compute dtype CD: dq (query tiles), then dk/dv (key
// tiles), s = scale q.k. delta = sum_c o do from the forward's o, in one
// pass over the keys; f32 alone also takes a null o and then sums delta =
// sum_j p dp over a pass of its own (K6's f32 body). bf16: the mma.sync
// cores (a null o is refused); f32: the CUDA-core bodies.
template <typename CD>
int launch_attn_bwd(const CD* qkv, const CD* dob, const CD* o, const float* stats, float* delta,
                    float* dqkv32, CD* dqkvn, int B, int N, int H, int dh, cudaStream_t st,
                    float scale = 1.f) {
  if constexpr (std::is_same<CD, bf16>::value) {
    if (!o) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + kRows - 1) / kRows, H, B);
    const int vec = vec_ok(dh, qkv, dob);
    const float sL = scale * kLog2e;
    return with_kd(dh, [&](auto kd) {
      constexpr int KD = decltype(kd)::value;
      auto dq = attn_bwd_dq_mma<KD>;
      auto dkdv = attn_bwd_dkdv_mma<KD>;
      CEREBRA_VIT_CHECK(
          cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem));
      CEREBRA_VIT_CHECK(
          cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem));
      CEREBRA_VIT_CHECK(dq<<<grid, kMmaThreads, kDqSmem, st>>>(
          qkv, dob, o, stats, delta, dqkv32, dqkvn, N, H, dh, vec, scale, sL));
      CEREBRA_VIT_CHECK(dkdv<<<grid, kMmaThreads, kDkdvSmem, st>>>(
          qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh, vec, scale, sL));
      return 0;
    });
  } else {
    const dim3 grid((N + kT - 1) / kT, H, B);
    const int smem_dq = 6 * kTile * (int)sizeof(float);
    const int smem_dkdv = 8 * kTile * (int)sizeof(float);
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dq<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq));
    CEREBRA_VIT_CHECK(cudaFuncSetAttribute(
        attn_bwd_dkdv<CD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv));
    CEREBRA_VIT_CHECK(attn_bwd_dq<CD><<<grid, kAttnThreads, smem_dq, st>>>(
        qkv, dob, o, stats, delta, dqkv32, dqkvn, N, H, dh, scale));
    CEREBRA_VIT_CHECK(attn_bwd_dkdv<CD><<<grid, kAttnThreads, smem_dkdv, st>>>(
        qkv, dob, stats, delta, dqkv32, dqkvn, N, H, dh, scale));
    return 0;
  }
}

// The o K6's cores take delta from: the forward's in bf16 (one pass over
// the keys), none in f32 (its two-pass body sums p dp).
template <typename CD>
const CD* k6_o(const CD* o) {
  return std::is_same<CD, bf16>::value ? o : nullptr;
}

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

int row_blocks(int M) { return (M + kRowThreads / 32 - 1) / (kRowThreads / 32); }

// ------------------------------------------------- K5/K6's dense products
// One product of the half-block, C = A B with A = a^T where A_T and B = b^T
// where B_T (a and b row-major), then epi on C: in bf16 on wgmma_gemm.cuh
// with the pair epilogue we (B_MN is !B_T; cudaErrorInvalidValue where the
// TMA cannot read an operand), in f32 on vit_common.cuh's CUDA-core body
// with te.
template <bool A_T, bool B_T, typename CD, class WgEpi, class TcEpi>
int product(const CD* a, int lda, const CD* b, int ldb, int M, int N, int K, WgEpi we, TcEpi te,
            cudaStream_t st) {
  if constexpr (std::is_same<CD, bf16>::value) {
    return wg::launch<A_T, !B_T>(wg::Operands{a, b, lda, ldb, M, N}, nullptr, we, we, K, 1, st);
  } else {
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, A_T, B_T>(a, lda, b, ldb, M, N, K, te, st));
    return 0;
  }
}

// Row chunks of the bf16 dWp (D, D) and dWqkv (D, 3D) contractions over M
// rows, one launch of both: the most whose CTAs (both products' output
// tiles, once a chunk) fit one wave at wg::kMinBlocks CTAs an SM, at most
// 32 and M / 256, so that a chunk holds four 64-row steps. One wave leaves
// no tail and the fewest partials to write: on an H100 at main_dino's
// 200,960 and 74,240 rows, 7 chunks (252 CTAs) ran K6 1-4 % faster than 4,
// 11, 14, 18, 22, 29 or 32. K8 keeps its own rule (vit_mlp.cu's
// contraction_splits).
int dw_splits(int M, int D) {
  const int t = wg::tiles(wg::Dims{D, D}) + wg::tiles(wg::Dims{D, 3 * D});
  int s = wg::kMinBlocks * wg::sm_count() / t;
  if (s > M / (4 * wg::kBK)) s = M / (4 * wg::kBK);
  return s < 1 ? 1 : s > 32 ? 32 : s;
}

// dWp = o^T dn (D, D) and dWqkv = y^T dqkvn (D, 3D), f32, in fixed row
// chunks added in a fixed order: the same result on every run, no atomics.
// bf16: one launch of the two split-row contractions on wgmma_gemm.cuh,
// dw_splits chunks of whole 64-row steps, each chunk's partial to scratch
// (dWp's, then dWqkv's), the partials added in chunk order; f32:
// contract_rows each (kRowSplits chunks).
template <typename CD>
int weight_grads(const CD* o, const CD* dn, const CD* y, const CD* dqkvn, float* dwp,
                 float* dwqkv, int M, int D, float* scratch, cudaStream_t st) {
  if constexpr (std::is_same<CD, bf16>::value) {
    const int splits = dw_splits(M, D);
    const size_t pp = (size_t)D * D, pq = 3 * pp;
    float* qpart = scratch + splits * pp;
    const wg::Operands q{y, dqkvn, D, 3 * D, D, 3 * D};
    CEREBRA_VIT_RC((wg::launch<true, true>(wg::Operands{o, dn, D, D, D, D}, &q,
                                           wg::EpiPartial{scratch, D, pp},
                                           wg::EpiPartial{qpart, 3 * D, pq}, M, splits, st)));
    CEREBRA_VIT_RC(launch_sum_partials(scratch, dwp, splits, (long long)pp, (long long)pp, st));
    return launch_sum_partials(qpart, dwqkv, splits, (long long)pq, (long long)pq, st);
  } else {
    CEREBRA_VIT_RC(contract_rows<CD>(o, D, dn, D, M, dwp, scratch, st));
    return contract_rows<CD>(y, D, dqkvn, 3 * D, M, dwqkv, scratch, st);
  }
}

template <typename SD, typename CD>
int attn_fwd_all(const SD* x, const float* s, const CD* g, const CD* b, const CD* wqkv,
                 const CD* bqkv, const CD* wp, const CD* bp, CD* y, float* mu, float* rstd,
                 CD* qkv, CD* o, float* stats, SD* out, int B, int N, int D, int H,
                 cudaStream_t st) {
  const int M = B * N, dh = D / H;
  CEREBRA_VIT_CHECK(ln_fwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, g, b, y, mu, rstd, M, D));
  CEREBRA_VIT_RC((product<false, false>(y, D, wqkv, 3 * D, M, 3 * D, D,
                                        wg::EpiBiasRound<CD>{bqkv, qkv, 3 * D},
                                        EpiBiasRound<CD>{bqkv, qkv, 3 * D}, st)));
  CEREBRA_VIT_RC(launch_attn_fwd<CD>(qkv, o, stats, B, N, H, dh, st));
  CEREBRA_VIT_RC((product<false, false>(o, D, wp, D, M, D, D,
                                        wg::EpiResidual<SD, CD>{x, bp, s, N, out, D},
                                        EpiResidual<SD, CD>{x, bp, s, N, out, D}, st)));
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
  // proj: dn = dout * s in CD; dbp = sum dout * s; do = dn @ Wp^T
  CEREBRA_VIT_CHECK(scale_round<SD, CD><<<(unsigned)((MD + 255) / 256), 256, 0, st>>>(
      dout, s, N, dn, MD, D));
  CEREBRA_VIT_RC(column_sum<SD>(dout, s, N, dbp, M, D, scratch, st));
  CEREBRA_VIT_RC((product<false, true>(dn, D, wp, D, M, D, D,
                                       wg::EpiBiasRound<CD>{nullptr, dob, D},
                                       EpiBiasRound<CD>{nullptr, dob, D}, st)));
  // attention
  CEREBRA_VIT_RC(launch_attn_bwd<CD>(qkv, dob, k6_o(o), stats, delta, dqkv32, dqkvn, B, N, H,
                                     dh, st));
  // weights: dWp = o^T dn, dWqkv = y^T dqkv_CD; dbqkv = sum dqkv (f32);
  // dy = dqkv_CD @ Wqkv^T
  CEREBRA_VIT_RC(weight_grads<CD>(o, dn, y, dqkvn, dwp, dwqkv, M, D, scratch, st));
  CEREBRA_VIT_RC(column_sum<float>(dqkv32, nullptr, 1, dbqkv, M, 3 * D, scratch, st));
  CEREBRA_VIT_RC((product<false, true>(dqkvn, 3 * D, wqkv, 3 * D, M, D, 3 * D,
                                       wg::EpiF32{dy, D}, EpiF32{dy, D}, st)));
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
// In bf16 compute the products run on wgmma_gemm.cuh, whose TMA needs
// 16-byte aligned bases and D % 8 == 0 (cudaErrorInvalidValue else).
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

// The attention core of the forward alone: qkv (B*N, 3D) CD -> o (B*N, D)
// CD and stats (B, H, N, 2) f32, as cerebra_vit_attn_fwd runs it (in bf16
// K15's forward at scale 1).
int cerebra_vit_attn_core_fwd(int cd_bf16, const void* qkv, void* o, float* stats, int B, int N,
                              int D, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  if (cd_bf16)
    return launch_attn_fwd<bf16>((const bf16*)qkv, (bf16*)o, stats, B, N, H, D / H, st);
  return launch_attn_fwd<float>((const float*)qkv, (float*)o, stats, B, N, H, D / H, st);
}

// The attention core of the backward alone: from qkv, dob (B*N, D) CD and
// the forward's o (B*N, D) CD and stats -> delta (B, H, N) f32, dq, dk, dv
// into dqkv32 (B*N, 3D) f32 and dqkvn (B*N, 3D) CD, as cerebra_vit_attn_bwd
// runs it (delta from o in bf16, from p dp in f32).
int cerebra_vit_attn_core_bwd(int cd_bf16, const void* qkv, const void* dob, const void* o,
                              const float* stats, float* delta, float* dqkv32, void* dqkvn,
                              int B, int N, int D, int H, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  if (cd_bf16)
    return launch_attn_bwd<bf16>((const bf16*)qkv, (const bf16*)dob, k6_o((const bf16*)o), stats,
                                 delta, dqkv32, (bf16*)dqkvn, B, N, H, D / H, st);
  return launch_attn_bwd<float>((const float*)qkv, (const float*)dob, k6_o((const float*)o),
                                stats, delta, dqkv32, (float*)dqkvn, B, N, H, D / H, st);
}

// K15, the flash attention of Attention(use_flash): qkv (B, N, 3D) CD, the
// qkv dense layer's rows as they are -> o (B, N, D) CD, the rows proj reads,
// and stats (B, H, N, 2) f32 = (m, l) per query row; s = scale q.k in f32.
// bf16: the one-pass wgmma core (flash_fwd_wgmma, K5's bf16 core too;
// *tma_used says whether the TMA brought the tiles); f32: the CUDA-core
// body. The caller's head dim is at most 64.
int cerebra_vit_flash_fwd(int cd_bf16, const void* qkv, void* o, float* stats, int B, int N,
                          int D, int H, float scale, int* tma_used, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  if (cd_bf16)
    return launch_attn_fwd<bf16>((const bf16*)qkv, (bf16*)o, stats, B, N, H, D / H, st, scale,
                                 tma_used);
  return launch_attn_fwd<float>((const float*)qkv, (float*)o, stats, B, N, H, D / H, st, scale,
                                tma_used);
}

// K15's backward: from qkv, its forward's o and stats and do (B, N, D) CD ->
// delta (B, H, N) f32 = sum_c o do per query row, and dq, dk, dv with the
// scale chained in, straight into dqkv (B, N, 3D) CD, the gradient of the
// qkv rows (f32 sums, rounded once).
int cerebra_vit_flash_bwd(int cd_bf16, const void* qkv, const void* o, const void* dob,
                          const float* stats, float* delta, void* dqkv, int B, int N, int D,
                          int H, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  if (cd_bf16)
    return launch_attn_bwd<bf16>((const bf16*)qkv, (const bf16*)dob, (const bf16*)o, stats, delta,
                                 nullptr, (bf16*)dqkv, B, N, H, D / H, st, scale);
  return launch_attn_bwd<float>((const float*)qkv, (const float*)dob, (const float*)o, stats,
                                delta, nullptr, (float*)dqkv, B, N, H, D / H, st, scale);
}

// The scores of every (sequence, head) as the dq core forms them, S (B, H,
// N, N) f32, and as the dk/dv core forms them with the operands swapped, St
// (B, H, N, N) f32, row key: St[j][i] must equal S[i][j] bit for bit.
int cerebra_vit_attn_scores(const void* qkv, float* S, float* St, int B, int N, int D, int H,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % H != 0 || D / H > kT) return (int)cudaErrorInvalidValue;
  const int dh = D / H, tiles = (N + kRows - 1) / kRows;
  const dim3 grid(tiles, tiles, B * H);
  const int vec = vec_ok(dh, qkv, qkv);
  return with_kd(dh, [&](auto kd) {
    CEREBRA_VIT_CHECK(attn_scores_mma<decltype(kd)::value><<<grid, kMmaThreads, 0, st>>>(
        (const bf16*)qkv, S, St, N, H, dh, vec));
    return 0;
  });
}

// f32 scratch floats the backward needs for M rows of width D in the
// compute dtype cd_bf16 names.
long long cerebra_vit_attn_scratch(int cd_bf16, int M, int D) {
  const long long sums = (long long)kColSplits * 3 * D;
  const long long dw = cd_bf16 ? (long long)dw_splits(M, D) * 4 * D * D
                               : (long long)kRowSplits * 3 * D * D;
  return sums > dw ? sums : dw;
}

// Row chunks of the bf16 backward's dWp and dWqkv contractions on this card.
int cerebra_vit_attn_splits(int M, int D) { return dw_splits(M, D); }

// Scratch: dn (M, D) CD, dob (M, D) CD, delta (B, H, N) f32, dqkv32 (M, 3D)
// f32, dqkvn (M, 3D) CD, dy (M, D) f32, scratch (cerebra_vit_attn_scratch)
// f32. Outputs: dx (M, D) SD and f32 dg, db (D), dwqkv (D, 3D), dbqkv (3D),
// dwp (D, D), dbp (D). In bf16 compute the products run on wgmma_gemm.cuh,
// as cerebra_vit_attn_fwd's, the dW contractions in dw_splits row chunks.
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
