// Fused ViT MLP half-block for Hopper (sm_90a): the CUDA counterparts of
// the Pallas kernels in cerebra/models/pallas_vit_mlp.py.
//
//   cerebra_vit_mlp_fwd  replaces _fwd_kernel (K7):
//       out = x + s * (gelu_erf(LN(x) * g + b) @ W1 + b1) @ W2 + b2)
//   cerebra_vit_mlp_bwd  replaces _bwd_kernel (K8): dx, and f32 dg, db,
//       dW1, db1, dW2, db2
//
// Layouts (row-major): x, out, dout, dx (M, D) in SD; g, b (D), W1 (D, F),
// b1 (F), W2 (F, D), b2 (D) in CD (the wrapper casts them, as _prep does);
// s (M) f32 or null (the drop-path branch scale, per row).
//
// What bounds it on an H100, and the design. In bf16 the half-blocks do K7
// 4 M D F and K8 10 M D F operations of products (29.6 and 74.1 GFLOP at
// main_dino's globals, M = 12,560, D = 384, F = 1,536: 0.03 and 0.075 ms at
// 989 TFLOP/s) and move the (M, F) bf16 intermediates gh and dhn (38.6 MB
// each there). The TPU kernel holds a row tile's whole (rows, F)
// intermediate in VMEM; a block has 227 KB of shared memory, so here each
// half-block is a chain of launches on one stream. Every product runs on
// wgmma_gemm.cuh (TMA copies into a ring of stages, wgmma, accumulators and
// epilogue in registers), which needs 16-byte aligned bases and rows (D and
// F multiples of 8; every ViT width is): other operands are refused with
// cudaErrorInvalidValue, and the wrappers raise before that:
//   K7 (3 launches): LN rows (y, and the row statistics for the backward)
//     -> fc1 + bias + GELU (gh, rounded to CD) -> fc2 + bias, scaled, plus
//     the residual.
//   K8 (7 launches): dn = dout * s rounded to CD and db2's partials in one
//     pass (mlp_bwd_dn) -> one kernel per (64-row, 128-column) tile of
//     (M, F) that forms h = y W1 + b1 and dgh = dn W2^T side by side over the
//     same depth D and leaves only gh, dhn (CD) and db1's partial of the
//     tile's rows (mlp_bwd_dh): h and dh live only in registers -> dW2 =
//     gh^T dn and dW1 = y^T dhn as one launch of split-row contractions ->
//     dy = dhn W1^T (f32) -> LN column partials -> every sum of partials in
//     one launch (sum_jobs) -> LN rows.
// On an H100 the products run at 200-440 TFLOP/s there (chip_smoke.py's
// `[mlp pieces]`); the fused dh kernel is the slowest launch, bound by its
// L2 loads and its GELU epilogue rather than its products (below). The TPU sums dW, db into constant-index blocks over
// its sequential grid; here every sum over rows adds fixed chunks in a fixed
// order (partials, then sum_jobs): the same result on every run, no
// atomics. The row chunks of the contractions are whole 64-row steps, as
// many as fill the card with the 2 x (D/128) x (F/128) output tiles
// (`contraction_splits`).
//
// In f32 compute the products stay on vit_common.cuh's CUDA-core f32 body
// (the parity runs; main_dino computes in bf16): fc1 leaves h in dhn's
// buffer and the dgh product turns it into dh in place, so there too no
// (M, F) f32 tensor is allocated beyond gh and dhn, which are CD.
//
// Rounding points follow the Pallas bodies: LN statistics in f32 with eps
// 1e-6; y, gh, dout*s and dh rounded to CD before they enter a product; f32
// accumulation; h, dh, db1, db2, dg, db kept in f32; gelu' of the f32 h; the
// residual stream in SD. GELU is the exact erf form, erf computed as the TPU
// kernel computes it (Abramowitz & Stegun 7.1.26, within 1.5e-7 of erf).

#include "vit_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace vit;
using bf16 = __nv_bfloat16;

// erf as the Pallas kernels compute it (`_erf`, Abramowitz & Stegun 7.1.26,
// |error| <= 1.5e-7): branch-free, one reciprocal and one exponential, and
// that exponential, exp(-x^2) at x = h / sqrt(2), is also the Gaussian
// factor of gelu'. In K8's fused dh kernel the epilogue, not the products,
// sets much of the time, and on an H100 this form took less of it than
// erff and expf.
constexpr float kRsqrt2 = 0.707106781186547524f;

// erf(x), and e2 = exp(-x^2)
__device__ __forceinline__ float erf_as(float x, float& e2) {
  const float a = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, a, 1.0f));
  const float poly =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f), 0.254829592f);
  e2 = __expf(-a * a);
  return copysignf(1.0f - poly * e2, x);
}

__device__ __forceinline__ float gelu_f(float h) {
  float e2;
  return 0.5f * h * (1.0f + erf_as(h * kRsqrt2, e2));
}

// gelu(h) and gelu'(h) = Phi(h) + h phi(h) from one erf, as the Pallas
// _gelu_exact and _dgelu_exact
__device__ __forceinline__ void gelu_both(float h, float& gel, float& dgel) {
  float e2;
  const float e = erf_as(h * kRsqrt2, e2);
  gel = 0.5f * h * (1.0f + e);
  dgel = 0.5f * (1.0f + e) + h * e2 * 0.398942280401432678f;
}

// gh (CD) = gelu(C + b1); with h, also h (f32) = C + b1 (the f32 body only)
template <typename CD>
struct EpiGelu {
  const CD* bias;
  CD* gh;
  float* h;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    const float v = acc + to_f(bias[j]);
    const size_t o = (size_t)i * ld + j;
    if (h) h[o] = v;
    gh[o] = from_f<CD>(gelu_f(v));
  }
  __device__ void operator()(int i, int j, float v0, float v1, bool two) const {
    const float a = gelu_f(v0 + to_f(bias[j]));
    const float b = two ? gelu_f(v1 + to_f(bias[j + 1])) : 0.f;
    wg::store2(gh + (size_t)i * ld + j, a, b, two);
  }
};

// f32 body: hd holds h on entry and dh = C * gelu'(h) after
struct EpiDgeluInPlace {
  float* hd;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    const size_t o = (size_t)i * ld + j;
    float gel, dgel;
    gelu_both(hd[o], gel, dgel);
    hd[o] = acc * dgel;
  }
};

// --------------------------------------------------- K8: dn and db2's parts
// Block (32, 8) over 32 columns and chunk blockIdx.y of the rows (vit's
// col_sum_part): dn[m, j] = (dout[m, j] * rs[m]) rounded to CD, and
// part[y * D + j] = the chunk's sum of the unrounded values.
template <typename SD, typename CD>
__global__ void mlp_bwd_dn(const SD* __restrict__ dout, const float* __restrict__ rs,
                           CD* __restrict__ dn, float* __restrict__ part, int M, int D) {
  __shared__ float acc_s[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  int m0, m1;
  row_chunk(M, m0, m1);
  float acc = 0.f;
  if (j < D) {
    for (int m = m0 + threadIdx.y; m < m1; m += 8) {
      const size_t o = (size_t)m * D + j;
      float v = to_f(dout[o]);
      if (rs) v *= rs[m];
      dn[o] = from_f<CD>(v);
      acc += v;
    }
  }
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < D) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += acc_s[r][threadIdx.x];
    part[(size_t)blockIdx.y * D + j] = s;
  }
}

// ------------------------------------------------- K8: the fused dh kernel
// One CTA per (64 rows, 128 columns of F) forms two accumulators over the
// same depth D, h = y W1 and dgh = dn W2^T; its epilogue, in registers:
// gh = gelu(h + b1) and dhn = dgh * gelu'(h + b1), rounded to CD, and
// db1's partial of the tile's rows. The partial adds each thread's rows in
// order, the row groups of a warp by shuffles, then the warps' sums in
// order through shared memory: a fixed order.
constexpr int kDhRows = 64;

// a thread's column sums of dh over its rows: cs[j][e] for columns
// 8 j + 2 t + e of the tile, summed over its warp and stored at
// red[warp_row][n0 + ...]
template <int NJ>
__device__ __forceinline__ void dh_colsum_store(float (&cs)[NJ][2], float (*red)[wg::kBN],
                                                int warp_row, int n0) {
  const int l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (l < 4) red[warp_row][n0 + 8 * j + 2 * l + e] = v;
    }
}

// gh, dhn and the column sum of dh at (i, f) and (i, f + 1) from the two
// accumulators' values there
__device__ __forceinline__ void dh_pair(const bf16* __restrict__ b1, bf16* __restrict__ gh,
                                        bf16* __restrict__ dhn, int M, int F, int i, int f,
                                        const float (&h)[2], const float (&dg)[2],
                                        float (&cs)[2]) {
  float gel[2], d[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in_f = f + e < F;
    float dgel;
    gelu_both(h[e] + (in_f ? __bfloat162float(b1[f + e]) : 0.f), gel[e], dgel);
    d[e] = dg[e] * dgel;
    cs[e] += (i < M && in_f) ? d[e] : 0.f;
  }
  if (i < M && f < F) {
    const size_t o = (size_t)i * F + f;
    wg::store2(gh + o, gel[0], gel[1], f + 1 < F);
    wg::store2(dhn + o, d[0], d[1], f + 1 < F);
  }
}

// The TMA + wgmma body: one warpgroup holding both 64 x 128 accumulators
// (159 registers a thread, no spills), two CTAs an SM. On an H100 at main_dino's
// globals its time splits into the loads (L2-bound: y and dn are read once
// for each of F / 128 column tiles, W1 and W2 once for each of M / 64 row
// tiles), then the epilogue (an erf and an exp a value, bound by latency at
// one warp a scheduler), with the products hidden under the loads; a CTA
// of 128 rows, a persistent walk over tiles and two warpgroups taking turns
// on tiles were each tried and none was faster. A stage holds y and dn's
// rows (K-major, 8 KB each), W1's columns (MN-major, 16 KB) and W2's rows
// (K-major, 16 KB) of the tile.
constexpr int kDhStages = 2, kDhThreads = 128;
constexpr int kDhRowTile = kDhRows * wg::kBK;       // y or dn tile, elements
constexpr int kDhWTile = wg::kTileBytes / 2;        // W1 or W2 tile, elements
constexpr int kDhStage = 2 * kDhRowTile + 2 * kDhWTile;
constexpr int kDhSmem = kDhStages * kDhStage * 2 + 2 * kDhStages * 8 + 1024;

__global__ void __launch_bounds__(kDhThreads, 2)
mlp_bwd_dh(const __grid_constant__ CUtensorMap my, const __grid_constant__ CUtensorMap mdn,
           const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
           const bf16* __restrict__ b1, bf16* __restrict__ gh, bf16* __restrict__ dhn,
           float* __restrict__ db1_part, int M, int D, int F) {
  extern __shared__ unsigned char smraw[];
  __shared__ float red[4][wg::kBN];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smraw) + 1023) & ~uintptr_t(1023));
  bf16* tiles = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kDhStages * kDhStage * 2);
  uint64_t* empty = full + kDhStages;
  const int i0 = blockIdx.y * kDhRows, f0 = blockIdx.x * wg::kBN;
  const int nk = (D + wg::kBK - 1) / wg::kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDhStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 4);  // the 4 warps that read the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto produce = [&](int it) {  // thread 0: step it's copies into stage it % kDhStages
    const int s = it % kDhStages, k0 = it * wg::kBK;
    bf16* st = tiles + s * kDhStage;
    wg::mbar_expect_tx(&full[s], kDhStage * 2);
    wg::tma_load(st, &my, &full[s], k0, i0);
    wg::tma_load(st + kDhRowTile, &mdn, &full[s], k0, i0);
    wg::load_operand<true>(st + 2 * kDhRowTile, &mw1, &full[s], f0, k0);
    wg::load_operand<false>(st + 2 * kDhRowTile + kDhWTile, &mw2, &full[s], f0, k0);
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < kDhStages && it < nk; ++it) produce(it);
  __syncwarp();  // wgmma is .aligned: warp 0 reconverges after thread 0's copies
  float ah[64], ag[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) ah[i] = ag[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kDhStages;
    wg::mbar_wait(&full[s], (it / kDhStages) & 1);
    const bf16* st = tiles + s * kDhStage;
    wg::fence_regs(ah);
    wg::fence_regs(ag);
    wg::wg_fence();
    wg::stage_mma<false, true>(ah, st, st + 2 * kDhRowTile, 0);
    wg::stage_mma<false, false>(ag, st + kDhRowTile, st + 2 * kDhRowTile + kDhWTile, 0);
    wg::wg_commit();
    wg::wg_wait<0>();
    wg::fence_regs(ah);
    wg::fence_regs(ag);
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && it + kDhStages < nk) {
      wg::mbar_wait(&empty[s], (it / kDhStages) & 1);
      produce(it + kDhStages);
    }
    __syncwarp();
  }

  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  float cs[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) cs[j][0] = cs[j][1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 16 * w + l / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int q = 4 * j + 2 * h;
      dh_pair(b1, gh, dhn, M, F, i, f0 + 8 * j + 2 * (l % 4), {ah[q], ah[q + 1]},
              {ag[q], ag[q + 1]}, cs[j]);
    }
  }
  dh_colsum_store<16>(cs, red, w, 0);
  __syncthreads();
  if (f0 + (int)threadIdx.x < F)
    db1_part[(size_t)blockIdx.y * F + f0 + threadIdx.x] =
        red[0][threadIdx.x] + red[1][threadIdx.x] + red[2][threadIdx.x] + red[3][threadIdx.x];
}

int launch_dh(const bf16* y, const bf16* dn, const bf16* w1, const bf16* b1, const bf16* w2,
              bf16* gh, bf16* dhn, float* db1_part, int M, int D, int F, cudaStream_t st) {
  if (!wg::tma_ok(y, D) || !wg::tma_ok(dn, D) || !wg::tma_ok(w1, F) || !wg::tma_ok(w2, D))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];
  CEREBRA_VIT_RC(wg::operand_map(&m[0], y, D, M, D, false, kDhRows));
  CEREBRA_VIT_RC(wg::operand_map(&m[1], dn, D, M, D, false, kDhRows));
  CEREBRA_VIT_RC(wg::operand_map(&m[2], w1, F, F, D, true));
  CEREBRA_VIT_RC(wg::operand_map(&m[3], w2, D, F, D, false));
  CEREBRA_VIT_CHECK(
      cudaFuncSetAttribute(mlp_bwd_dh, cudaFuncAttributeMaxDynamicSharedMemorySize, kDhSmem));
  const dim3 grid((F + wg::kBN - 1) / wg::kBN, (M + kDhRows - 1) / kDhRows);
  CEREBRA_VIT_CHECK(mlp_bwd_dh<<<grid, kDhThreads, kDhSmem, st>>>(
      m[0], m[1], m[2], m[3], b1, gh, dhn, db1_part, M, D, F));
  return 0;
}

// ------------------------------------------------------------- products
// One product or two of the same orientation, split `splits` ways along k,
// with A = a^T where A_T and B = b^T where B_T (a and b row-major): B_T is
// a K-major B, so wgmma_gemm.cuh's B_MN is !B_T.
template <bool A_T, bool B_T, class Epi>
int run_product(const wg::Operands& o0, const wg::Operands* o1, Epi e0, Epi e1, int K,
                int splits, cudaStream_t st) {
  return wg::launch<A_T, !B_T>(o0, o1, e0, e1, K, splits, st);
}

// ------------------------------------------------------- sums of partials
// out[e] = sum_z part[z * ld + e] for e < n, z < splits, in order of z, for
// each job (blockIdx.y); the order is vit's sum_partials'.
struct SumJob {
  const float* part;
  float* out;
  long long n, ld;
  int splits;
};
constexpr int kMaxJobs = 6;
struct SumJobs {
  SumJob job[kMaxJobs];
};

__global__ void sum_jobs(SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.y];
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < jb.n;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int z = 0; z < jb.splits; ++z) s += jb.part[z * jb.ld + e];  // loads ahead, adds in order
    jb.out[e] = s;
  }
}

int launch_sums(const SumJobs& jobs, int count, cudaStream_t st) {
  long long most = 0;
  for (int q = 0; q < count; ++q) most = jobs.job[q].n > most ? jobs.job[q].n : most;
  const long long blocks = (most + 255) / 256;
  CEREBRA_VIT_CHECK(
      sum_jobs<<<dim3((unsigned)(blocks < 2048 ? blocks : 2048), count), 256, 0, st>>>(jobs));
  return 0;
}

// ------------------------------------------------------------- the chain
constexpr int kRowThreads = 256;  // 8 rows (warps) per block

int row_blocks(int M) { return (M + kRowThreads / 32 - 1) / (kRowThreads / 32); }

// Row chunks of each dW contraction: the count s <= 6 whose CTAs (2 x
// (D/128) x (F/128) output tiles, s chunks each, one CTA an SM) take the
// fewest waves per chunk, ceil(tiles s / SMs) / s; the smaller on a tie, and
// no more than M / 256.
int contraction_splits(int M, int D, int F) {
  const int t = 2 * ((D + 127) / 128) * ((F + 127) / 128), sms = wg::sm_count();
  int best = 1;
  double cost = (double)((t + sms - 1) / sms);
  for (int s = 2; s <= 6 && s <= M / 256; ++s) {
    const double c = (double)((t * s + sms - 1) / sms) / s;
    if (c < cost - 1e-9) best = s, cost = c;
  }
  return best;
}

// The f32 scratch of the backward, in floats from its start: dy (M, D),
// then the partials of db2, db1, dW2, dW1 and the LN columns.
struct Scratch {
  long long dy, db2, db1, dw2, dw1, ln, total;
  int splits, db1_parts;
  Scratch(int M, int D, int F) {
    splits = contraction_splits(M, D, F);
    const int tiles = (M + kDhRows - 1) / kDhRows;
    db1_parts = tiles > kColSplits ? tiles : kColSplits;
    dy = 0;
    db2 = dy + (long long)M * D;
    db1 = db2 + (long long)kColSplits * D;
    dw2 = db1 + (long long)db1_parts * F;
    dw1 = dw2 + (long long)splits * D * F;
    ln = dw1 + (long long)splits * D * F;
    total = ln + (long long)kColSplits * 2 * D;
  }
};

template <typename SD, typename CD>
int mlp_fwd(const SD* x, const float* s, const CD* g, const CD* b, const CD* w1, const CD* b1,
            const CD* w2, const CD* b2, CD* y, float* mu, float* rstd, CD* gh, SD* out, int M,
            int D, int F, cudaStream_t st) {
  CEREBRA_VIT_CHECK(ln_fwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, g, b, y, mu, rstd, M, D));
  if constexpr (std::is_same<CD, bf16>::value) {
    const EpiGelu<CD> fc1{b1, gh, nullptr, F};
    const wg::EpiResidual<SD, CD> fc2{x, b2, s, 1, out, D};
    CEREBRA_VIT_RC((run_product<false, false>(wg::Operands{y, w1, D, F, M, F}, nullptr, fc1, fc1,
                                              D, 1, st)));
    CEREBRA_VIT_RC((run_product<false, false>(wg::Operands{gh, w2, F, D, M, D}, nullptr, fc2, fc2,
                                              F, 1, st)));
  } else {
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
        y, D, w1, F, M, F, D, EpiGelu<CD>{b1, gh, nullptr, F}, st));
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
        gh, F, w2, D, M, D, F, EpiResidual<SD, CD>{x, b2, s, 1, out, D}, st));
  }
  return 0;
}

template <typename SD, typename CD>
int mlp_bwd(const SD* x, const SD* dout, const float* s, const CD* g, const CD* w1, const CD* b1,
            const CD* w2, const CD* y, const float* mu, const float* rstd, CD* dn, CD* gh,
            CD* dhn, float* scratch, SD* dx, float* dg, float* db, float* dw1, float* db1,
            float* dw2, float* db2, int M, int D, int F, cudaStream_t st) {
  const Scratch sc(M, D, F);
  float* dy = scratch + sc.dy;
  const size_t DF = (size_t)D * F;
  // dn = dout * s in CD, db2's partials
  CEREBRA_VIT_CHECK(mlp_bwd_dn<SD, CD><<<dim3((D + 31) / 32, kColSplits), dim3(32, 8), 0, st>>>(
      dout, s, dn, scratch + sc.db2, M, D));
  int db1_splits;
  if constexpr (std::is_same<CD, bf16>::value) {
    // gh, dhn and db1's partials, h and dh in registers only
    CEREBRA_VIT_RC(launch_dh(y, dn, w1, b1, w2, gh, dhn, scratch + sc.db1, M, D, F, st));
    db1_splits = (M + kDhRows - 1) / kDhRows;
    // dW2 = gh^T dn (F, D) and dW1 = y^T dhn (D, F): one launch, split rows
    const wg::Operands dw1_ops{y, dhn, D, F, D, F};
    CEREBRA_VIT_RC((run_product<true, false>(
        wg::Operands{gh, dn, F, D, F, D}, &dw1_ops, wg::EpiPartial{scratch + sc.dw2, D, DF},
        wg::EpiPartial{scratch + sc.dw1, F, DF}, M, sc.splits, st)));
    // dy = dhn W1^T (M, D) f32
    const wg::EpiF32 dy_epi{dy, D};
    CEREBRA_VIT_RC((run_product<false, true>(wg::Operands{dhn, w1, F, F, M, D}, nullptr, dy_epi,
                                             dy_epi, F, 1, st)));
  } else {
    // h into dhn's buffer, then dh in place; db1's partials by row chunks
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
        y, D, w1, F, M, F, D, EpiGelu<CD>{b1, gh, dhn, F}, st));
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
        dn, D, w2, D, M, F, D, EpiDgeluInPlace{dhn, F}, st));
    CEREBRA_VIT_CHECK(col_sum_part<float><<<dim3((F + 31) / 32, kColSplits), dim3(32, 8), 0, st>>>(
        dhn, nullptr, 1, scratch + sc.db1, M, F));
    db1_splits = kColSplits;
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, true, false>(
        gh, F, dn, D, F, D, M, EpiPartial{scratch + sc.dw2, D, DF}, st, sc.splits));
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, true, false>(
        y, D, dhn, F, D, F, M, EpiPartial{scratch + sc.dw1, F, DF}, st, sc.splits));
    CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
        dhn, F, w1, F, M, D, F, EpiF32{dy, D}, st));
  }
  // LN affine: dg, db partials; every sum in order; LN core backward
  CEREBRA_VIT_CHECK(ln_bwd_cols_part<SD><<<dim3((D + 31) / 32, kColSplits), dim3(32, 8), 0, st>>>(
      x, mu, rstd, dy, scratch + sc.ln, M, D));
  SumJobs jobs{{{scratch + sc.db2, db2, D, D, kColSplits},
                {scratch + sc.db1, db1, F, F, db1_splits},
                {scratch + sc.dw2, dw2, (long long)DF, (long long)DF, sc.splits},
                {scratch + sc.dw1, dw1, (long long)DF, (long long)DF, sc.splits},
                {scratch + sc.ln, dg, D, 2LL * D, kColSplits},
                {scratch + sc.ln + D, db, D, 2LL * D, kColSplits}}};
  CEREBRA_VIT_RC(launch_sums(jobs, kMaxJobs, st));
  CEREBRA_VIT_CHECK(ln_bwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, mu, rstd, dy, g, dout, dx, M, D));
  return 0;
}

// The products of the MLP alone, as the half-blocks run them, for the card
// tests and the timing of the pieces: epi 0 out f32 = C, 1 out (CD) =
// gelu(C + bias), 2 out (f32) = x + s (C + bias), 3 out = the partials of C
// over `splits` row chunks (splits, M, N) f32, 4 out (CD) = C + bias (bias
// may be null; K5/K6's qkv and do epilogue).
template <bool A_T, bool B_T>
int product(int epi, const bf16* a, int lda, const bf16* b, int ldb, int M, int N, int K,
            int splits, const bf16* bias, const float* x, const float* s, void* out,
            cudaStream_t st) {
  const wg::Operands o{a, b, lda, ldb, M, N};
  switch (epi) {
    case 0: {
      const wg::EpiF32 e{(float*)out, N};
      return run_product<A_T, B_T>(o, nullptr, e, e, K, 1, st);
    }
    case 1: {
      const EpiGelu<bf16> e{bias, (bf16*)out, nullptr, N};
      return run_product<A_T, B_T>(o, nullptr, e, e, K, 1, st);
    }
    case 2: {
      const wg::EpiResidual<float, bf16> e{x, bias, s, 1, (float*)out, N};
      return run_product<A_T, B_T>(o, nullptr, e, e, K, 1, st);
    }
    case 3: {
      const wg::EpiPartial e{(float*)out, N, (size_t)M * N};
      return run_product<A_T, B_T>(o, nullptr, e, e, K, splits, st);
    }
    case 4: {
      const wg::EpiBiasRound<bf16> e{bias, (bf16*)out, N};
      return run_product<A_T, B_T>(o, nullptr, e, e, K, 1, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// sd_bf16 / cd_bf16 != 0: the stream / compute dtype is bfloat16, else float.
// y (M, D) CD, mu and rstd (M) f32 and gh (M, F) CD are outputs the backward
// reads (gh is scratch).
int cerebra_vit_mlp_fwd(int sd_bf16, int cd_bf16, const void* x, const float* s, const void* g,
                        const void* b, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* y, float* mu, float* rstd, void* gh, void* out,
                        int M, int D, int F, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  CEREBRA_DISPATCH(sd_bf16, cd_bf16,
                   (mlp_fwd<SD, CD>((const SD*)x, s, (const CD*)g, (const CD*)b, (const CD*)w1,
                                    (const CD*)b1, (const CD*)w2, (const CD*)b2, (CD*)y, mu,
                                    rstd, (CD*)gh, (SD*)out, M, D, F, st)));
}

// f32 scratch floats the backward needs for M rows and widths D and F.
long long cerebra_vit_mlp_scratch(int M, int D, int F) { return Scratch(M, D, F).total; }

// Row chunks of the backward's dW contractions on this card.
int cerebra_vit_mlp_splits(int M, int D, int F) { return contraction_splits(M, D, F); }

// Scratch: dn (M, D) CD, gh (M, F) CD, dhn (M, F) CD, scratch
// (cerebra_vit_mlp_scratch) f32. Outputs: dx (M, D) SD and f32 dg, db (D),
// dw1 (D, F), db1 (F), dw2 (F, D), db2 (D).
int cerebra_vit_mlp_bwd(int sd_bf16, int cd_bf16, const void* x, const void* dout,
                        const float* s, const void* g, const void* w1, const void* b1,
                        const void* w2, const void* y, const float* mu, const float* rstd,
                        void* dn, void* gh, void* dhn, float* scratch, void* dx, float* dg,
                        float* db, float* dw1, float* db1, float* dw2, float* db2, int M, int D,
                        int F, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  CEREBRA_DISPATCH(sd_bf16, cd_bf16,
                   (mlp_bwd<SD, CD>((const SD*)x, (const SD*)dout, s, (const CD*)g,
                                    (const CD*)w1, (const CD*)b1, (const CD*)w2, (const CD*)y,
                                    mu, rstd, (CD*)dn, (CD*)gh, (CD*)dhn, scratch, (SD*)dx, dg,
                                    db, dw1, db1, dw2, db2, M, D, F, st)));
}

// K8's fused dh kernel alone (bf16): gh, dhn (M, F) and db1_part
// (ceil(M / 64), F) f32, as cerebra_vit_mlp_bwd runs it.
int cerebra_vit_mlp_dh(const void* y, const void* dn, const void* w1, const void* b1,
                       const void* w2, void* gh, void* dhn, float* db1_part, int M, int D, int F,
                       void* stream) {
  return launch_dh((const bf16*)y, (const bf16*)dn, (const bf16*)w1, (const bf16*)b1,
                   (const bf16*)w2, (bf16*)gh, (bf16*)dhn, db1_part, M, D, F,
                   (cudaStream_t)stream);
}

// One product of the MLP alone (bf16 operands; `product` above) in one of
// the half-blocks' orientations: a_t / b_t as run_product's A_T / B_T, not
// both.
int cerebra_vit_mlp_product(int a_t, int b_t, int epi, const void* a, int lda, const void* b,
                            int ldb, int M, int N, int K, int splits, const void* bias,
                            const float* x, const float* s, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *A = (const bf16*)a, *B = (const bf16*)b, *bi = (const bf16*)bias;
  if (a_t && b_t) return (int)cudaErrorInvalidValue;
  if (a_t) return product<true, false>(epi, A, lda, B, ldb, M, N, K, splits, bi, x, s, out, st);
  if (b_t) return product<false, true>(epi, A, lda, B, ldb, M, N, K, splits, bi, x, s, out, st);
  return product<false, false>(epi, A, lda, B, ldb, M, N, K, splits, bi, x, s, out, st);
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
