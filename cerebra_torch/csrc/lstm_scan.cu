// Per-layer LSTM recurrence kernels for Hopper (sm_90a): the CUDA counterparts
// of the Pallas kernels in cerebra/models/pallas_lstm.py (lstm_scan_pallas),
// which run one layer over a precomputed input projection x_proj = x @ w_ih + b.
//
//   scan_wave_kernel<false, NS>   replaces _fwd_infer_kernel (K12) and
//   scan_wave_kernel<true, NS>    _fwd_train_kernel (K13) in bf16 where
//                                 lstm_scan.py scan_wave_fits: W_hh in
//                                 shared memory, the step's product on
//                                 mma.sync, x_proj through a cp.async ring,
//                                 NS = 2 a layer split over two CTAs
//   scan_fwd_kernel<T, BT, false> replaces _fwd_infer_kernel (K12) and
//   scan_fwd_kernel<T, BT, true>  _fwd_train_kernel (K13) elsewhere (f32
//                                 streams, widths the wave kernel does not take)
//   scan_bwd_kernel<T, T, false, BT> replaces _bwd_kernel    (K14), the
//                                 reverse scan of lstm_common.cuh that K2/K2g
//                                 and K11 run once per layer too
//
// Layouts (row-major, T = stream dtype, float or __nv_bfloat16): x_proj
// (Tn, B, 4H); w_hh (H, 4H); h_all (Tn, B, H); prefac (Tn, B, 4H) =
// [g·i(1−i), c_prev·f(1−f), i(1−g²), tanh c·o(1−o)]; qf (Tn, B, 2H) =
// [o(1−tanh²c), f]; g (Tn, B, H), the cotangent of h_all; w_hhT (4H, H);
// dgates (Tn, B, 4H), the cotangent of x_proj. Gate order [i, f, g, o].
//
// What bounds them on an H100: the recurrence is serial over Tn steps, and
// per step a batch tile of BT rows needs H * 4H * BT multiply-adds against
// w_hh and streams 4H (K12), 10H (K13) or 11H (K14) values a row, so a step
// costs latency, not bandwidth or FLOPs (K13 at B = 1024, H = 96, T = 460
// moves 0.99 GB: 0.30 ms at 3.35 TB/s). scan_fwd_kernel's step re-reads
// every thread's column of w_hh from L2 (72 KiB a block at H = 96), runs the
// product as scalar f32 FMAs, loads x_proj on the critical path and passes
// the gates through shared memory between two barriers. The wave kernel's
// step is the wavefront forward's (lstm_stack.cu) without the input
// product: w_hh's columns stay in shared memory, the product is a few
// mma.sync a warp, x_proj arrives kWaveRing - 1 steps ahead, the cell runs
// in registers straight from the accumulators, and one barrier closes the
// step. K14 is the shared reverse scan (lstm_common.cuh, with its own design
// notes). The per-element cell math comes from lstm_common.cuh: cell_step
// and cell_update, as lstm_stack.cu's forwards, and gate_grads in the scan.
// Rounding points follow the Pallas kernels: gates = f32(x_proj_t) + (h
// rounded to the stream dtype) @ w_hh with f32 accumulation, h's f32 carry
// kept unrounded (the wave kernel rounds h once, where it stores it, and
// uses only the rounded value); K14's dh/dc carries f32, its dgates
// stream-dtype products of the rounded carries and prefactors.
//
// The kernels allocate nothing and do not synchronise; the C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cooperative_groups.h>

#include "lstm_common.cuh"
#include "warp_mma.cuh"
#include "wave_common.cuh"

namespace {

// Replaces cerebra/models/pallas_lstm.py:_fwd_infer_kernel (TRAIN false: h_all
// only) and :_fwd_train_kernel (TRAIN true: h_all, prefac, qf).
// Shared memory (floats): c_s (BT, H) f32 cell | hr_s (H, BT) h in the stream
// dtype | gates_s (BT, 4H)
template <typename T, int BT, bool TRAIN>
__global__ void __launch_bounds__(MAX_THREADS)
    scan_fwd_kernel(const T* __restrict__ x_proj, const T* __restrict__ w_hh,
                    T* __restrict__ h_all, T* __restrict__ prefac, T* __restrict__ qf, int Tn,
                    int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* c_s = smem;
  float* hr_s = c_s + BT * H;
  float* gates_s = hr_s + H * BT;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;

  for (int i = tid; i < 2 * BT * H; i += nthr) c_s[i] = 0.0f;  // c_s and hr_s

  for (int t = 0; t < Tn; ++t) {
    __syncthreads();  // hr_s holds h_{t-1}; gates_s is free
    // gates = x_proj_t + h @ w_hh: one thread per gate column
    for (int j = tid; j < G; j += nthr) {
      float ah[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) ah[r] = 0.0f;
      col_dot<T, BT>(ah, w_hh, hr_s, H, G, j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        const float xp = b < B ? to_f<T>(x_proj[((size_t)t * B + b) * G + j]) : 0.0f;
        gates_s[r * G + j] = xp + ah[r];
      }
    }
    __syncthreads();  // gates complete; hr_s may be overwritten

    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, u = i - r * H, b = b0 + r;
      const size_t row = (size_t)t * B + b;
      const bool res = TRAIN && b < B;
      const float h_new = cell_step<T>(gates_s + r * G + u, H, c_s[i],
                                       res ? prefac + row * G + u : nullptr,
                                       res ? qf + row * 2 * H + u : nullptr);
      hr_s[u * BT + r] = rnd<T>(h_new);
      if (b < B) h_all[row * H + u] = from_f<T>(h_new);
    }
  }
}

template <typename T, int BT>
int launch_fwd(int train, const void* x_proj, const void* w_hh, void* h_all, void* prefac,
               void* qf, int Tn, int B, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * BT * H + BT * 4 * H);
  auto kern = train ? scan_fwd_kernel<T, BT, true> : scan_fwd_kernel<T, BT, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(B + BT - 1) / BT, threads_for(H), smem, stream>>>(
      (const T*)x_proj, (const T*)w_hh, (T*)h_all, (T*)prefac, (T*)qf, Tn, B, H);
  return (int)cudaGetLastError();
}


// ------------------------------------------------ the scan's wavefront forward
// Replaces cerebra/models/pallas_lstm.py:_fwd_infer_kernel (TRAIN false: h_all
// only, K12) and :_fwd_train_kernel (TRAIN true: h_all, prefac, qf, K13) in
// bf16. One cluster of NS CTAs a batch tile of kWaveRows = 16 rows (an
// mma.sync's m16; rows past B zero, never stored). CTA s owns the U = H/NS
// units [s U, (s+1) U) and their four gates: local column q U + u is global
// column q H + s U + u. It holds those 4U columns of w_hh in shared memory
// for the whole sequence, column by column, and runs every step of its units:
// h_{t-1}·W_hh on mma.sync (m16n8k16, bf16 operands, f32 sums) with warp w
// owning local units [8w, 8w + 8) and their four gates, so each lane's
// accumulators hold all four pre-activations of its 2 rows x 2 units; each
// lane adds its own values of x_proj_t (f32(x_proj_t) + dot, the Pallas
// body's order) and runs the f32 cell in registers (c an unrounded register
// carry); h_t, rounded to bf16, goes into the CTA's h buffer (t+1) % 2; one
// __syncthreads closes the step, and the stores to device memory (h_all; for
// K13 the four prefactors, q and f) come after it, never waited on.
// x_proj_t's 16 x 4U values of this CTA arrive in ring slot t % kWaveRing by
// cp.async, 16 bytes a copy, issued kWaveRing - 1 steps ahead (zeros for rows
// past B); each thread waits for its own copies of step t + 1 before the
// step's barrier, which makes every thread's visible.
// NS = 2 ("the split", for more CTAs at the same batch): each CTA also sends
// its half of h_t by st.async into the same place of its sibling's buffer,
// completing on the sibling's "hfull" mbarrier of that buffer (the split
// layer's exchange of lstm_stack.cu's wavefront forward: armed at init for
// each buffer's first use and re-armed after each wait; no "empty" barrier,
// since a CTA writes buffer (t+1) % 2 at step t only after the sibling's
// whole h_{t-1} landed, which each sibling warp computed after its own
// reads of that buffer). With no input product to hide the wait behind,
// the K loop takes the CTA's own half of h_{t-1} first and waits for the
// sibling's half after it.
// Buffers: bf16 w_s (4U, H + 8) | x_s (kWaveRing, 16, 4U + 8) | h_s (2, 16,
// H + 8) (rows padded by 8 values: ldmatrix and each lane's x_proj loads hit
// 32 banks); then, split, the mbarriers hfull[2].

// bytes of shared memory of one CTA of the scan's wavefront forward, NS CTAs
// a batch tile (lstm_scan.py scan_wave_smem)
inline size_t scan_wave_smem(int H, int NS) {
  const size_t U = H / NS, HW = (size_t)H + 8;
  return 2 * (4 * U * HW + (size_t)kWaveRing * kWaveRows * (4 * U + 8) + 2 * kWaveRows * HW) +
         (NS > 1 ? 2 : 0) * sizeof(uint64_t);
}

// H a multiple of 16 NS (a CTA's U units in k-steps of 16), 4U threads within
// the kernel's bound, NS of 1 or 2, and a CTA's shared memory within a block's
inline bool scan_wave_ok(int H, int NS) {
  return (NS == 1 || NS == 2) && H > 0 && H % (16 * NS) == 0 && 4 * H / NS <= kWaveThreads &&
         scan_wave_smem(H, NS) <= 232448;
}

template <bool TRAIN, int NS>
__global__ void __launch_bounds__(kWaveThreads, 1)
    scan_wave_kernel(const __nv_bfloat16* __restrict__ x_proj,
                     const __nv_bfloat16* __restrict__ w_hh, __nv_bfloat16* __restrict__ h_all,
                     __nv_bfloat16* __restrict__ prefac, __nv_bfloat16* __restrict__ qf, int Tn,
                     int B, int H) {
  using bf = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();  // which half of the units (0 unsplit)
  const int G = 4 * H, U = H / NS, NC = 4 * U, ub = s * U, HW = H + 8, XW = NC + 8;
  const int b0 = (int)(blockIdx.x / NS) * kWaveRows;
  extern __shared__ __align__(16) float smem[];
  bf* w_s = reinterpret_cast<bf*>(smem);                  // [local column][k]
  bf* x_s = w_s + (size_t)NC * HW;                         // [slot][row][local column]
  bf* h_s = x_s + (size_t)kWaveRing * kWaveRows * XW;      // [buf][row][unit]
  uint64_t* hfull = reinterpret_cast<uint64_t*>(h_s + 2 * kWaveRows * HW);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int half_bytes = kWaveRows * U * (int)sizeof(bf);

  for (int i = tid; i < H * NC; i += nthr) {
    const int k = i / NC, j = i - k * NC, q = j / U, col = q * H + ub + (j - q * U);
    w_s[(size_t)j * HW + k] = w_hh[(size_t)k * G + col];
  }
  for (int i = tid; i < 2 * kWaveRows * HW; i += nthr) h_s[i] = __float2bfloat16_rn(0.0f);
  if constexpr (NS > 1) {
    if (tid == 0) {
      for (int k = 0; k < 2; ++k) {  // first uses: buffer 1 at t = 1, buffer 0 at t = 2
        wave_init(hfull + k, 1);
        wave_expect(hfull + k, half_bytes);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // x_proj_t's 16 rows of this CTA's 4U columns into ring slot t % kWaveRing,
  // 16 x 4U / 8 = 2 NC copies of 8 values, two a thread (nthr = NC): copy
  // i = tid + p nthr takes row r and local columns [j, j + 8) of gate
  // q = j / U. Their offsets are the same at every step, so they are
  // computed once; one commit group a step (empty past Tn).
  int x_dst[2];
  size_t x_src[2];
  bool x_ok[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int i = tid + p * nthr, chunks = NC / 8;
    const int r = i / chunks, j = 8 * (i - r * chunks), q = j / U, b = b0 + r;
    x_dst[p] = r * XW + j;
    x_src[p] = (size_t)(b < B ? b : 0) * G + q * H + ub + (j - q * U);
    x_ok[p] = b < B;
  }
  auto load_x = [&](int t) {
    if (t < Tn) {
      bf* dst = x_s + (size_t)(t % kWaveRing) * kWaveRows * XW;
      const bf* src = x_proj + (size_t)t * B * G;
#pragma unroll
      for (int p = 0; p < 2; ++p) tc::cp_async<16>(dst + x_dst[p], src + x_src[p], x_ok[p]);
    }
    tc::cp_async_commit();
  };
  for (int t = 0; t < kWaveRing - 1; ++t) load_x(t);

  const int lane = tid % 32, warp = tid / 32, g = lane / 4, tg = lane % 4;
  const int j0 = 8 * warp + 2 * tg, u0 = ub + j0;  // this lane's local units j0, j0 + 1
  float c[4] = {};  // [2 rr + e]: row g + 8 rr, unit u0 + e

  tc::cp_async_wait<kWaveRing - 2>();  // x_proj_0 is in
  cluster.sync();  // weights, zero h, x_proj_0 and the barriers in place; the sibling started

  // fragments by ldmatrix.x4 (lane i gives a row of matrix i / 8): A's rows
  // i % 8 + 8 ((i / 8) & 1) at k + 8 (i / 16); B's local column 8 warp + i % 8
  // of gate q + i / 16 at k + 8 ((i / 8) & 1), the b0 and b1 of gates q, q + 1
  const int ar = (lane % 8) + 8 * ((lane / 8) & 1), ak = 8 * (lane / 16);
  const bf* wl = w_s + (size_t)(8 * warp + lane % 8 + (lane / 16) * U) * HW + 8 * ((lane / 8) & 1);
  const int sib = (s ^ 1) * U;  // the sibling's first unit (split)
  // this lane's h_t (bf16 pairs) and, for K13, its residuals, [rr]: h, the
  // four prefactors, q, f
  uint32_t out[2][7];
  for (int t = 0; t < Tn; ++t) {
    const bf* slot = x_s + (size_t)(t % kWaveRing) * kWaveRows * XW;
    load_x(t + kWaveRing - 1);  // into the slot step t - 1 read
    uint32_t xv[4][2];  // [q][rr]: x_proj_t at row g + 8 rr, local columns q U + j0, + 1
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) xv[q][rr] = tc::ld32(slot + (g + 8 * rr) * XW + q * U + j0);
    const bf* ha = h_s + (size_t)(t & 1) * kWaveRows * HW + ar * HW + ak;
    float acc[4][4];  // [q][e]: gate q's n8 tile, the mma's C fragment
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.0f;
    auto product = [&](int k0) {  // acc += h_{t-1}[:, k0 : k0 + U]·W_hh[k0 : k0 + U, CTA's columns]
#pragma unroll 3
      for (int kb = k0; kb < k0 + U; kb += 16) {
        uint32_t a[4], b[4];
        tc::ldmatrix_x4(a, ha + kb);
#pragma unroll
        for (int q = 0; q < 4; q += 2) {
          tc::ldmatrix_x4(b, wl + (size_t)q * U * HW + kb);
          tc::mma_bf16(acc[q], a, b[0], b[1]);
          tc::mma_bf16(acc[q + 1], a, b[2], b[3]);
        }
      }
    };
    product(ub);  // this CTA's own units of h_{t-1} first
    if constexpr (NS > 1) {  // then the sibling's half, in buffer t % 2
      if (t > 0) wave_wait(hfull + (t & 1), ((t - 1) >> 1) & 1);
      product(sib);
    }

    bf* hn = h_s + (size_t)((t + 1) & 1) * kWaveRows * HW;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = g + 8 * rr;
      float hv[2], res[2][6];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float gv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(&xv[q][rr]);
          gv[q] = (e ? __high2float(x2) : __low2float(x2)) + acc[q][2 * rr + e];
        }
        hv[e] = cell_update<TRAIN>(gv, 1, c[2 * rr + e], res[e]);
      }
      uint32_t* o = out[rr];
      o[0] = tc::pack_bf16(hv[0], hv[1]);
      *reinterpret_cast<uint32_t*>(hn + r * HW + u0) = o[0];
      if constexpr (NS > 1) {  // the sibling reads h_t at step t + 1
        if (t + 1 < Tn) wave_store_peer(hn + r * HW + u0, o[0], hfull + ((t + 1) & 1), s ^ 1);
      }
      if constexpr (TRAIN) {
#pragma unroll
        for (int j = 0; j < 6; ++j) o[j + 1] = tc::pack_bf16(res[0][j], res[1][j]);
      }
    }
    tc::cp_async_wait<kWaveRing - 2>();  // x_proj_{t+1} is in
    __syncthreads();  // h_t in place; every warp has read slot t % kWaveRing and h buffer t % 2
    if constexpr (NS > 1) {
      if (tid == 0 && t > 0) wave_expect(hfull + (t & 1), half_bytes);  // its next use, t + 2
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int b = b0 + g + 8 * rr;
      if (b >= B) continue;
      const size_t row = (size_t)t * B + b;
      const uint32_t* o = out[rr];
      *reinterpret_cast<uint32_t*>(h_all + row * H + u0) = o[0];
      if constexpr (TRAIN) {
        bf* pf = prefac + row * G + u0;
#pragma unroll
        for (int q = 0; q < 4; ++q) *reinterpret_cast<uint32_t*>(pf + q * H) = o[q + 1];
        bf* qr = qf + row * 2 * H + u0;
        *reinterpret_cast<uint32_t*>(qr) = o[5];
        *reinterpret_cast<uint32_t*>(qr + H) = o[6];
      }
    }
  }
  cluster.sync();  // no CTA leaves while its sibling may still signal it
}

template <int NS>
int launch_scan_wave(int train, const void* x_proj, const void* w_hh, void* h_all, void* prefac,
                     void* qf, int Tn, int B, int H, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t smem = scan_wave_smem(H, NS);
  const int tiles = (B + kWaveRows - 1) / kWaveRows;
  auto kern = train ? scan_wave_kernel<true, NS> : scan_wave_kernel<false, NS>;
  return launch_clusters(kern, NS, tiles, 4 * H / NS, smem, s, (const bf*)x_proj, (const bf*)w_hh,
                         (bf*)h_all, (bf*)prefac, (bf*)qf, Tn, B, H);
}
}  // namespace

extern "C" {

// train != 0: K13 (h_all, prefac, qf), else K12 (h_all; prefac and qf may be
// null). bf16 != 0: __nv_bfloat16 streams, else float. bt in {1, 2, 4, 8, 16}.
int cerebra_scan_fwd(int train, int bf16, int bt, const void* x_proj, const void* w_hh,
                     void* h_all, void* prefac, void* qf, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_fwd<__nv_bfloat16, BT>(train, x_proj, w_hh, h_all, prefac, qf, Tn, B,
                                                H, s)
                : launch_fwd<float, BT>(train, x_proj, w_hh, h_all, prefac, qf, Tn, B, H, s);
  });
}

// K12 (train == 0: h_all; prefac and qf may be null) or K13 (h_all, prefac,
// qf) on the scan's wavefront forward, bf16 streams, ns CTAs (1 or 2) a
// 16-row batch tile. The shape within scan_wave_ok (lstm_scan.py
// scan_wave_fits), else cudaErrorInvalidValue.
int cerebra_scan_fwd_wave(int train, int ns, const void* x_proj, const void* w_hh, void* h_all,
                          void* prefac, void* qf, int Tn, int B, int H, void* stream) {
  if (!scan_wave_ok(H, ns)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return ns == 1 ? launch_scan_wave<1>(train, x_proj, w_hh, h_all, prefac, qf, Tn, B, H, s)
                 : launch_scan_wave<2>(train, x_proj, w_hh, h_all, prefac, qf, Tn, B, H, s);
}

// clusters of the scan's wavefront forward (ns CTAs each) the card holds at
// once at width H, or minus a CUDA error code
int cerebra_scan_wave_clusters(int ns, int H) {
  if (!scan_wave_ok(H, ns)) return -(int)cudaErrorInvalidValue;
  int clusters = 0;
  const size_t smem = scan_wave_smem(H, ns);
  const cudaError_t e =
      ns == 1 ? cluster_occupancy(scan_wave_kernel<true, 1>, 1, 4 * H, smem, &clusters)
              : cluster_occupancy(scan_wave_kernel<true, 2>, 2, 2 * H, smem, &clusters);
  return e == cudaSuccess ? clusters : -(int)e;
}

// bytes of shared memory of one CTA of the scan's wavefront forward at width
// H, ns CTAs a tile (lstm_scan.py scan_wave_smem holds its formula)
long long cerebra_scan_wave_smem(int H, int ns) { return (long long)scan_wave_smem(H, ns); }

// K14: dgates (Tn, B, 4H) from K13's prefac and qf, the cotangent g of h_all
// and w_hhT (4H, H).
int cerebra_scan_bwd(int bf16, int bt, const void* prefac, const void* qf, const void* g,
                     const void* w_hhT, void* dgates, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    using bf = __nv_bfloat16;
    return bf16 ? launch_scan_bwd<bf, bf, false, BT>(
                      ScanRes<bf>{(const bf*)prefac, (const bf*)qf}, g, 0, w_hhT, nullptr,
                      dgates, Tn, B, H, s)
                : launch_scan_bwd<float, float, false, BT>(
                      ScanRes<float>{(const float*)prefac, (const float*)qf}, g, 0, w_hhT,
                      nullptr, dgates, Tn, B, H, s);
  });
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
