// Whole-stack LSTM kernels for Hopper (sm_90a): the CUDA counterparts of the
// Pallas kernels in cerebra/models/pallas_lstm_stack.py.
//
//   lstm_fwd_kernel<T, BT, TRAIN>      replaces _fwd_train_kernel      (K1)
//   lstm_fwd_kernel<T, BT, INFER_LAST> replaces _fwd_infer_last_kernel (K3)
//   lstm_fwd_kernel<T, BT, INFER_SEQ>  replaces _fwd_infer_kernel      (K4)
//   lstm_fwd_kernel<T, BT, TRAIN_RC>   replaces _fwd_train_rc_kernel   (K10)
//   cerebra_fwd_in_product +           replace _fwd_train_kernel (K1) and
//   cerebra_fwd_cluster_scan           _fwd_infer_kernel (K4) at the small
//                                      batches lstm_stack.py pick_fwd takes,
//                                      and _fwd_infer_last_kernel (K3) in f32,
//                                      layer by layer: the input product on
//                                      the tensor cores (f32: FMA), then the
//                                      recurrence on a thread-block cluster
//                                      that keeps W_hh in shared memory
//   cerebra_fwd_wave                   replaces _fwd_train_kernel (K1),
//                                      _fwd_infer_last_kernel (K3),
//                                      _fwd_train_rc_kernel (K10) and
//                                      _fwd_infer_kernel (K4) in bf16 at the
//                                      widths lstm_stack.py wave_fits and
//                                      wave_split_fits take: a cluster a batch
//                                      tile, a CTA (split: two) a layer
//                                      holding [W_ih; W_hh] (its units'
//                                      columns) in shared memory, the layers
//                                      one step apart
//   cerebra_stack_scan_bwd +           replace _bwd_kernel: K2 (need_dx=False,
//   cerebra_stack_bwd_products         g_last_only=True) and K2g (need_dx=True
//                                      and/or a full (Tn, B, H) cotangent), as
//                                      one reverse scan (lstm_common.cuh's
//                                      scan_bwd_kernel, K14's) and one set of
//                                      tensor-core products per layer
//   cerebra_rc_gates +                 replace _bwd_rc_kernel (K11), per time
//   cerebra_rc_scan +                  chunk and layer: the gates recomputed
//   cerebra_rc_products +              on the tensor cores, the reverse scan
//   cerebra_sum_partials               forming K11's residuals with carries
//                                      between chunks, and the products into
//                                      dW partials that ordered sums add
//
// Layouts (all row-major, T = stream dtype, float or __nv_bfloat16):
//   x (Tn, B, C); w_ih0 (C, 4H); w_ihr (L-1, H, 4H); w_hh (L, H, 4H);
//   bias (L, 4H); h_all (L, Tn, B, H); prefac (L, Tn, B, 4H);
//   qf (L, Tn, B, 2H); c_all (L, Tn, B, H); h_out (B, H) for K3, (Tn, B, H)
//   for K4; g (B, H) or (Tn, B, H) for K2/K2g, (Tn, B, H) for K11;
//   dx (Tn, B, C); gate order [i, f, g, o].
//
// What bounds the forwards on an H100: the recurrence is serial over
// Tn = 460 steps. Per step and layer a batch tile of BT rows needs
// (in + H) * 4H * BT multiply-adds (in = C or H) and reads the layer's whole
// weights (~72 K values, from L2: the 2-layer bf16 stack is 288 KiB, more
// than one block's 227 KB of shared memory), so a step costs microseconds of
// issue and latency, not bandwidth or FLOPs. The design: one block per batch
// tile loops over time and layers itself (the TPU's sequential grid becomes
// the in-block loop) and keeps every layer's carry in shared memory, so the
// layers hand over h_t without touching device memory. Each of the 4H
// threads owns one gate column: it reads that column's weights coalesced
// and applies each to all BT rows, which shared memory holds transposed
// ([k][row]) so one vector load fetches a value for every row. The wrapper
// picks BT from timings on the card (lstm_stack.py pick_tile). At small
// batches K1 and K4 take the layer-by-layer path instead ("the
// layer-by-layer forward" below), as does K3 in f32 at every batch, and in
// bf16 at the CLI's widths all four take the wavefront path ("the wavefront
// forward"), K3, K4 and K10 at the DINO-LSTM's H = 128 its split layer.
//
// K2/K2g keep only what is serial in the serial loop: the dh/dc carries of
// one layer (the reverse scan). Everything else is a function of a layer's
// dgates stream and runs afterwards over all Tn·B rows at once, on the
// tensor cores in bf16 (vit_common.cuh's tiled product): dW_ih, dW_hh and db
// as f32 sums in fixed row chunks added in order, the f32 chain to the
// layer below and dx. K11 is the same decomposition run over time chunks
// (see "the recompute backward" below).
//
// Rounding points follow the Pallas kernels: matmul operands in the stream
// dtype with f32 accumulation, bias cast to f32, h cast to the stream dtype
// before W_hh and before it feeds the next layer, residual streams stored in
// the stream dtype; the backward's dgates are stream-dtype products of the
// f32 accumulators rounded to the stream dtype, the chain to the layer below
// an f32 product that is not rounded, dx rounded once.
//
// The kernels allocate nothing and do not synchronise; the C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cooperative_groups.h>

#include "lstm_common.cuh"
#include "vit_common.cuh"
#include "warp_mma.cuh"
#include "wave_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

// gates[r * 4H + j] = (inp @ wi)[r][j] + (hr @ wh)[r][j] + bias[j] for the
// BT rows of a batch tile and every gate column j < 4H, one thread per column;
// inp (in, BT) and hr (H, BT) are transposed rows in shared memory.
template <typename T, int BT>
__device__ __forceinline__ void gate_product(float* gates, const T* __restrict__ wi,
                                             const float* inp, int in,
                                             const T* __restrict__ wh, const float* hr,
                                             const T* __restrict__ bias, int H) {
  const int G = 4 * H;
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    float ax[BT], ah[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) ax[r] = ah[r] = 0.0f;
    col_dot<T, BT>(ax, wi, inp, in, G, j);
    col_dot<T, BT>(ah, wh, hr, H, G, j);
    const float bj = to_f<T>(bias[j]);
#pragma unroll
    for (int r = 0; r < BT; ++r) gates[r * G + j] = (ax[r] + ah[r]) + bj;
  }
}

// ---------------------------------------------------------------- forward
// The C entry point's `mode` argument takes these values.
enum FwdMode { INFER_LAST = 0, TRAIN = 1, INFER_SEQ = 2, TRAIN_RC = 3 };

// Replaces cerebra/models/pallas_lstm_stack.py:_fwd_train_kernel (TRAIN),
// :_fwd_infer_last_kernel (INFER_LAST), :_fwd_infer_kernel (INFER_SEQ) and
// :_fwd_train_rc_kernel (TRAIN_RC).
// Bound by latency: each of the Tn serial steps reads every layer's weights
// from L2 for (in + H) * 4H * BT multiply-adds per layer, with two barriers
// per layer-step; the carries never leave shared memory, and BT = 8 rows
// share each weight read. When 4H exceeds MAX_THREADS (H = 384) each
// thread takes several gate columns.
// K1 (TRAIN) streams h_all, prefac and qf for every layer and step; K10
// (TRAIN_RC) only h_all and c_all, the f32 cell rounded to the stream dtype
// (its f32 carry stays unrounded); K3 only writes the top layer's h at Tn-1,
// K4 the top layer's h at every step.
// Shared memory (floats):
//   c_s (L, BT, H) f32 cell | hr_s (L, H, BT) h in the stream dtype, which
//   is both the layer's recurrent operand and the next layer's input |
//   x_s (C, BT) | gates_s (BT, 4H)
template <typename T, int BT, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_ih0,
                    const T* __restrict__ w_ihr, const T* __restrict__ w_hh,
                    const T* __restrict__ bias, T* __restrict__ h_all, T* __restrict__ prefac,
                    T* __restrict__ qf, T* __restrict__ c_all, T* __restrict__ h_out, int Tn,
                    int B, int C, int H, int L) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* c_s = smem;
  float* hr_s = c_s + L * BT * H;
  float* x_s = hr_s + L * H * BT;
  float* gates_s = x_s + C * BT;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;

  for (int i = tid; i < 2 * L * BT * H; i += nthr) c_s[i] = 0.0f;  // c_s and hr_s

  for (int t = 0; t < Tn; ++t) {
    __syncthreads();  // the previous step is done with x_s
    for (int i = tid; i < BT * C; i += nthr) {
      const int r = i / C, k = i - r * C, b = b0 + r;
      x_s[k * BT + r] = b < B ? to_f<T>(x[((size_t)t * B + b) * C + k]) : 0.0f;
    }
    for (int l = 0; l < L; ++l) {
      const T* wi = l == 0 ? w_ih0 : w_ihr + (size_t)(l - 1) * H * G;
      const float* inp = l == 0 ? x_s : hr_s + (l - 1) * H * BT;
      float* hr = hr_s + l * H * BT;
      float* cl = c_s + l * BT * H;
      __syncthreads();  // this layer's input rows are in place

      gate_product<T, BT>(gates_s, wi, inp, l == 0 ? C : H, w_hh + (size_t)l * H * G, hr,
                          bias + (size_t)l * G, H);
      __syncthreads();  // gates complete; hr may be overwritten

      // f32 cell math, and K1's residuals
      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, u = i - r * H, b = b0 + r;
        const size_t row = ((size_t)l * Tn + t) * B + b;
        const bool res = MODE == TRAIN && b < B;
        const float h_new = cell_step<T>(gates_s + r * G + u, H, cl[i],
                                         res ? prefac + row * G + u : nullptr,
                                         res ? qf + row * 2 * H + u : nullptr);
        hr[u * BT + r] = rnd<T>(h_new);
        if (b >= B) continue;
        if (MODE == TRAIN || MODE == TRAIN_RC) h_all[row * H + u] = from_f<T>(h_new);
        if (MODE == TRAIN_RC) c_all[row * H + u] = from_f<T>(cl[i]);
        if ((MODE == INFER_SEQ || (MODE == INFER_LAST && t == Tn - 1)) && l == L - 1) {
          const size_t out = MODE == INFER_SEQ ? (size_t)t * B + b : (size_t)b;
          h_out[out * H + u] = from_f<T>(h_new);
        }
      }
    }
  }
}

template <typename T, int BT, int MODE>
int launch_fwd(const void* x, const void* w_ih0, const void* w_ihr, const void* w_hh,
               const void* bias, void* h_all, void* prefac, void* qf, void* c_all, void* h_out,
               int Tn, int B, int C, int H, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * L * BT * H + C * BT + BT * 4 * H);
  auto kern = lstm_fwd_kernel<T, BT, MODE>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_blk = (B + BT - 1) / BT;
  kern<<<n_blk, threads_for(H), smem, stream>>>(
      (const T*)x, (const T*)w_ih0, (const T*)w_ihr, (const T*)w_hh, (const T*)bias,
      (T*)h_all, (T*)prefac, (T*)qf, (T*)c_all, (T*)h_out, Tn, B, C, H, L);
  return (int)cudaGetLastError();
}

template <typename T, int BT>
int launch_fwd_mode(int mode, const void* x, const void* w_ih0, const void* w_ihr,
                    const void* w_hh, const void* bias, void* h_all, void* prefac, void* qf,
                    void* c_all, void* h_out, int Tn, int B, int C, int H, int L,
                    cudaStream_t s) {
#define CEREBRA_MODE(M)                                                                    \
  case M:                                                                                  \
    return launch_fwd<T, BT, M>(x, w_ih0, w_ihr, w_hh, bias, h_all, prefac, qf, c_all, h_out, \
                                Tn, B, C, H, L, s);
  switch (mode) {
    CEREBRA_MODE(INFER_LAST)
    CEREBRA_MODE(TRAIN)
    CEREBRA_MODE(INFER_SEQ)
    CEREBRA_MODE(TRAIN_RC)
  }
#undef CEREBRA_MODE
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------- the layer-by-layer forward
// Replaces _fwd_train_kernel (K1) and _fwd_infer_kernel (K4) at the batches
// lstm_stack.py pick_fwd sends here (the autoencoder's B = 16), and
// _fwd_infer_last_kernel (K3) in f32 at every batch (the eval's galleries of
// 320 and 80 rows), layer by layer, bottom first, in two launches a layer:
//   cerebra_fwd_in_product   P (Tn, B, 4H) f32 = inp·W_ih over all Tn·B rows
//                            (pallas_lstm_stack.py:140, :213): the input's
//                            product does not depend on h, so it leaves the
//                            serial loop for one tiled product
//                            (vit_common.cuh's wmma in bf16; in f32
//                            in_product_f32 below, true f32 FMA), no bias,
//                            nothing rounded
//   cerebra_fwd_cluster_scan the recurrence over P (:141-144, :214-225): one
//                            thread-block cluster of N CTAs a batch tile of
//                            16 rows; gates = (P + h·W_hh) + b in that order
// What bounds the scan on an H100: Tn serial steps, each a (16, H) x (H, 4H)
// product, the cell and a hand-over of h to every CTA: latency. The old
// forward's block read all of W_hh from L2 at every step (1.18 MB in bf16 at
// H = 384); here CTA k of the cluster owns the hidden units [kU, (k+1)U),
// U = H/N, and their 4U gate columns, holds that slice of W_hh (H x 4U) in
// its shared memory for the whole sequence, keeps its units' f32 c on chip,
// and per step multiplies the 16 rows of h_{t-1} by its slice (true f32 FMA
// in f32, never TF32; the tensor cores in bf16, below), runs the cell,
// writes its units of h_t, rounded to the stream dtype, into the h buffer of
// every CTA
// of the cluster (distributed shared memory) and meets the others at one
// cluster barrier (release/acquire). h is double-buffered by step parity, so
// that one barrier a step suffices: step t reads buffer t%2 and writes
// (t+1)%2, which every CTA finished reading before the barrier of step t-1.
// In f32 no barrier spans the cluster in the loop: a CTA hands its slice of
// h_t to every peer by st.async, 16 bytes a store, whose bytes complete on
// that peer's "hfull" mbarrier of the buffer, and waits only for its peers'
// slices before the next step's product. A CTA writes a peer's buffer
// (t+1)%2 at step t only after the peer's slice of h_{t-1} has landed, which
// the peer sent after its own step t-1 product, its last read of that
// buffer; so no "empty" barrier is needed. The f32 step's product is bound
// by the latency of its shared-memory loads (K3 at B = 320, H = 128, n = 4
// on an H100: 2.4 µs of a 4.3 µs step with one pass over k in 256 threads),
// so the threads split k in two halves (twice the warps, the same loads and
// FMAs).
// P of step t+1 is loaded into registers while step t multiplies.
// K3 (last != 0 on its top layer) writes h only at Tn-1, into (B, H); its
// lower layers write their h sequence into one buffer the wrapper reuses.
// The clusters of different batch tiles share nothing, so a batch of more
// tiles than the card holds clusters at once runs them in waves (K3 in f32
// at B = 320: 20 clusters of 4 CTAs in one wave, lstm_stack.py pick_fwd).

constexpr int kClusterRows = 16;  // batch rows of one cluster's tile

// bytes of shared memory of one CTA of the f32 cluster scan:
//   w_s (H, 4U) | h_s (2, H, 16) | g_s (16, 4U) | c_s (16, U), all f32
inline size_t cluster_smem(int H, int N) {
  const size_t U = H / N;
  return sizeof(float) * ((size_t)H * 4 * U + kClusterRows * (2 * (size_t)H + 5 * U));
}

constexpr int kClusterKSplit = 2;  // halves of k the f32 scan's threads split its product in

// rows a thread of the f32 cluster scan multiplies: 16 / RG for row groups
// RG, a power of two from 2 (1 where 2 would pass 512 threads: the 2U
// column pairs x RG groups x kClusterKSplit halves of k) up to 8, doubled
// while the 2U column pairs x RG stay within 192. Each row group reads the
// whole W_hh slice from shared memory every step, so fewer rows a thread
// cost shared-memory traffic, more cost warps. Timed on an H100 (one
// layer's scan, T = 460; PERF.md §6): at 2U = 64 (H 128, n 4) 8 rows
// 1.71 ms against 4 rows 1.77; 2U = 16 (H 128, n 16) 2 rows 0.95 against 1
// row 1.28; 2U = 32 4 rows 1.11 against 2 rows 1.28; 2U = 48 (H 96, n 4) 4
// rows 1.19 against 8 rows 1.39; 2U = 96 8 rows 1.87 against 16 rows 3.63.
inline int cluster_rows(int NC) {
  const int np = NC / 2;
  int rg = np * 2 * kClusterKSplit <= 512 ? 2 : 1;
  while (rg < 8 && np * rg * 2 <= 192) rg *= 2;
  return kClusterRows / rg;
}

// One layer's recurrence over its input product P (Tn, B, 4H) f32, in
// clusters of N CTAs (the launch's cluster size) over batch tiles of 16
// rows: h_seq (Tn, B, H), or with last only h at Tn-1 (B, H), and, with RES
// (K1), prefac (Tn, B, 4H) and qf (Tn, B, 2H) of the layer, f32 streams.
// Thread (s, p, g) multiplies the local gate columns 2p and 2p+1 for rows
// [g RR, (g+1) RR) of the tile over half s of k: twice the warps of one
// pass over k, for the latency of the shared-memory loads, at the same
// loads and FMAs; the second half's sums join the first's in g_s.
template <int RR, bool RES>
__global__ void __launch_bounds__(512, 1)
    cluster_scan_kernel(const float* __restrict__ P, const float* __restrict__ w_hh,
                        const float* __restrict__ bias, float* __restrict__ h_seq,
                        float* __restrict__ prefac, float* __restrict__ qf, int Tn, int B,
                        int H, int last) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int U = H / N, NC = 4 * U, G = 4 * H, k0 = rank * U, NH = H * kClusterRows;
  const int b0 = (int)(blockIdx.x / N) * kClusterRows;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                            // [k][local col]
  float* h_s = w_s + (size_t)H * NC;             // [buf][k][row]
  float* g_s = h_s + 2 * NH;                     // [row][local col]
  float* c_s = g_s + kClusterRows * NC;          // [row][unit]
  __shared__ __align__(8) uint64_t hfull[2];     // the peers' slices of an h buffer land here
  const int tid = threadIdx.x, nthr = blockDim.x;

  // local column j = q U + u is gate q of unit k0 + u: global column q H + k0 + u
  for (int i = tid; i < H * NC; i += nthr) {
    const int k = i / NC, j = i - k * NC, q = j / U;
    w_s[i] = w_hh[(size_t)k * G + q * H + k0 + (j - q * U)];
  }
  for (int i = tid; i < 2 * NH; i += nthr) h_s[i] = 0.0f;
  for (int i = tid; i < kClusterRows * U; i += nthr) c_s[i] = 0.0f;
  if (tid == 0) {
    wave_init(&hfull[0], 1);
    wave_init(&hfull[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int NP = NC / 2, half = nthr / kClusterKSplit, ks = tid / half;
  const int p = (tid - ks * half) % NP, r0 = ((tid - ks * half) / NP) * RR;
  const int kb = ks * (H / 2), ke = ks ? H : H / 2;
  int col[2];
  float bv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = 2 * p + e, q = j / U;
    col[e] = q * H + k0 + (j - q * U);
    bv[e] = bias[col[e]];
  }
  float pc[RR][2], pn[RR][2];  // P of this step and of the next (the first half's threads)
  auto load_p = [&](float (&dst)[RR][2], int t) {
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int b = b0 + r0 + r;
      const float* row = P + ((size_t)t * B + (b < B ? b : 0)) * G;
      dst[r][0] = b < B ? row[col[0]] : 0.0f;
      dst[r][1] = b < B ? row[col[1]] : 0.0f;
    }
  };
  if (ks == 0) load_p(pc, 0);
  cluster.sync();  // every CTA's h_s is zero and its barriers set before a peer writes

  const int n4 = U * kClusterRows / 4, peer_bytes = (N - 1) * n4 * (int)sizeof(float4);
  for (int t = 0; t < Tn; ++t) {
    const float* hc = h_s + (t & 1) * NH;
    float* hn = h_s + ((t + 1) & 1) * NH;
    if (ks == 0 && t + 1 < Tn) load_p(pn, t + 1);
    // the peers' slices of h_{t-1}: buffer t % 2 is filled at steps t-1, t-3, ...
    if (N > 1 && t > 0) wave_wait(&hfull[t & 1], ((t - 1) >> 1) & 1);
    float acc[RR][2];
#pragma unroll
    for (int r = 0; r < RR; ++r) acc[r][0] = acc[r][1] = 0.0f;
    const float* wp = w_s + 2 * p;
#pragma unroll 8
    for (int k = kb; k < ke; ++k) {
      const float2 w = *reinterpret_cast<const float2*>(wp + k * NC);
      float v[RR];
      rows<RR>(hc + k * kClusterRows + r0, v);
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        acc[r][0] = fmaf(v[r], w.x, acc[r][0]);
        acc[r][1] = fmaf(v[r], w.y, acc[r][1]);
      }
    }
    if (ks == 1)
#pragma unroll
      for (int r = 0; r < RR; ++r)
        *reinterpret_cast<float2*>(g_s + (r0 + r) * NC + 2 * p) = make_float2(acc[r][0], acc[r][1]);
    __syncthreads();  // the second half's sums are in g_s
    if (ks == 0)
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        float* gr = g_s + (r0 + r) * NC + 2 * p;
        gr[0] = (pc[r][0] + (acc[r][0] + gr[0])) + bv[0];
        gr[1] = (pc[r][1] + (acc[r][1] + gr[1])) + bv[1];
      }
    __syncthreads();  // the tile's gates of this CTA's columns are complete

    for (int i = tid; i < kClusterRows * U; i += nthr) {
      const int r = i / U, u = i - r * U, b = b0 + r;
      const size_t row = (size_t)t * B + b;
      const bool res = RES && b < B;
      const float h = cell_step<float>(g_s + r * NC + u, (size_t)U, H, c_s[i],
                                       res ? prefac + row * G + k0 + u : nullptr,
                                       res ? qf + row * 2 * H + k0 + u : nullptr);
      if (b < B && (!last || t == Tn - 1)) h_seq[(last ? (size_t)b : row) * H + k0 + u] = h;
      hn[(k0 + u) * kClusterRows + r] = b < B ? h : 0.0f;
    }
    __syncthreads();  // this CTA's slice of h_t is in its own buffer; g_s free

    // hand the slice, U units x 16 rows and contiguous, to the other CTAs by
    // st.async, 16 bytes a store, completing on their "hfull" barrier of the
    // buffer (none needs h at Tn-1)
    if (N > 1 && t + 1 < Tn) {
      uint64_t* bar = &hfull[(t + 1) & 1];
      if (tid == 0) wave_expect(bar, peer_bytes);
      float4* slice = reinterpret_cast<float4*>(hn + k0 * kClusterRows);
      for (int i = tid; i < (N - 1) * n4; i += nthr) {
        const int k = i / n4, e = i - k * n4;
        wave_store_peer4(slice + e, slice[e], bar, k < rank ? k : k + 1);
      }
    }

#pragma unroll
    for (int r = 0; r < RR; ++r) {
      pc[r][0] = pn[r][0];
      pc[r][1] = pn[r][1];
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still write into it
}

// ---- the f32 input product
// P (M, N) = A (M, K)·B (K, N), row-major f32, true f32 FMA with k in order
// (cerebra_fwd_in_product in f32: K1/K3/K4's layer-by-layer path). At the
// eval's K3 (M = 147,200 rows, K = 96 or 128, N = 512) it is bound by its
// FMAs (14.5-19.3 GFLOP a layer, 0.22-0.29 ms at 67 TFLOP/s), not by
// writing P (301 MB, 0.09 ms). A CTA of 256 threads owns a 128 x 128 tile
// of P and each thread an 8 x 8 block of it in registers (rows 4 ty + i and
// 64 + 4 ty + i, columns 4 tx + j and 64 + 4 tx + j), so a k-step is four
// 16-byte shared-memory loads for 64 FMAs; k runs in steps of 8 through two
// shared-memory buffers, the next step's tiles read into registers while
// this one multiplies. Ragged M, N and K are masked (zeros past K add
// nothing).
constexpr int kPBM = 128, kPBN = 128, kPBK = 8, kPThreads = 256;

__global__ void __launch_bounds__(kPThreads, 2)
    in_product_f32(const float* __restrict__ A, const float* __restrict__ Bm,
                   float* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) float As[2][kPBK][kPBM];  // [k][row]
  __shared__ __align__(16) float Bs[2][kPBK][kPBN];  // [k][col]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kPBM, n0 = blockIdx.y * kPBN;
  const int ar = tid / 2, ak = (tid % 2) * 4;    // A: row ar, k ak .. ak + 3
  const int bk = tid / 32, bc = (tid % 32) * 4;  // B: k bk, columns bc .. bc + 3
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + q, c = n0 + bc + q;
      ra[q] = (m0 + ar < M && k < K) ? A[(size_t)(m0 + ar) * K + k] : 0.f;
      rb[q] = (k0 + bk < K && c < N) ? Bm[(size_t)(k0 + bk) * N + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) As[buf][ak + q][ar] = ra[q];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bc]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  const int nk = (K + kPBK - 1) / kPBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kPBK);
#pragma unroll
    for (int kk = 0; kk < kPBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(buf ^ 1);  // its last reader was step kt - 1, before the barrier
    __syncthreads();
  }
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (r >= M) continue;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      const int c = n0 + jh * 64 + 4 * tx;
      float* out = C + (size_t)r * N + c;
      if (vec && c + 3 < N) {
        *reinterpret_cast<float4*>(out) = make_float4(acc[i][4 * jh], acc[i][4 * jh + 1],
                                                      acc[i][4 * jh + 2], acc[i][4 * jh + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < N) out[j] = acc[i][4 * jh + j];
      }
    }
  }
}

// ---- the bf16 step product on the tensor cores
// In bf16 the step's product runs as mma.sync m16n8k16 (bf16 operands, f32
// accumulation), which fits the 16-row tile: h_{t-1} is the A operand,
// held in bf16 (rows padded to H + 8 values, so the fragment loads of a
// warp hit 32 different banks), and the CTA's slice of W_hh the B operand,
// held column by column ([4U][H + 8], k contiguous). Warp w owns the 8-column
// tiles w, w + W, ... (W warps, at most MT each) over all H/16 k-steps. The
// rest of a step is the f32 kernel's.

// (ld32 and mma_bf16 come from warp_mma.cuh)
using tc::ld32;
using tc::mma_bf16;

// bytes of shared memory of one CTA of the bf16 cluster scan:
//   w_s (4U, H + 8) bf16 | h_s (2, 16, H + 8) bf16 | g_s (16, 4U) f32 | c_s (16, U) f32
inline size_t cluster_tc_smem(int H, int N) {
  const size_t U = H / N, HP = H + 8;
  return 2 * (4 * U * HP + 2 * kClusterRows * HP) + sizeof(float) * kClusterRows * 5 * U;
}

// warps of the bf16 cluster scan: one a column tile, 4 to 8
inline int cluster_tc_warps(int NC) {
  const int tiles = NC / 8;
  return tiles < 4 ? 4 : (tiles > 8 ? 8 : tiles);
}

// this CTA's slice of h_t, rows of U bf16 at hn + r HP + k0, copied into the
// same place of every other CTA of the cluster, V (4, 8 or 16 bytes) a store
template <typename V>
__device__ __forceinline__ void push_rows(cooperative_groups::cluster_group& cluster,
                                          __nv_bfloat16* hn, int HP, int k0, int U, int N,
                                          int rank) {
  const int nv = U * 2 / (int)sizeof(V), per_peer = kClusterRows * nv;
  for (int i = threadIdx.x; i < (N - 1) * per_peer; i += blockDim.x) {
    const int k = i / per_peer, rem = i - k * per_peer, r = rem / nv, e = rem - r * nv;
    V* src = reinterpret_cast<V*>(hn + r * HP + k0);
    cluster.map_shared_rank(src, k < rank ? k : k + 1)[e] = src[e];
  }
}

// One layer's recurrence in bf16 (cluster_scan_kernel's contract) with the
// step's product on the tensor cores. H is a multiple of 16, U of 2.
template <int MT, bool RES>
__global__ void __launch_bounds__(256, 1)
    cluster_scan_tc_kernel(const float* __restrict__ P, const __nv_bfloat16* __restrict__ w_hh,
                           const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ h_seq,
                           __nv_bfloat16* __restrict__ prefac, __nv_bfloat16* __restrict__ qf,
                           int Tn, int B, int H, int last) {
  using bf = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int N = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int U = H / N, NC = 4 * U, G = 4 * H, k0 = rank * U, HP = H + 8;
  const int b0 = (int)(blockIdx.x / N) * kClusterRows;
  extern __shared__ __align__(16) float smem[];
  bf* w_s = reinterpret_cast<bf*>(smem);                         // [local col][k]
  bf* h_s = w_s + (size_t)NC * HP;                               // [buf][row][k]
  float* g_s = reinterpret_cast<float*>(h_s + 2 * kClusterRows * HP);  // [row][local col]
  float* c_s = g_s + kClusterRows * NC;                          // [row][unit]
  const int tid = threadIdx.x, nthr = blockDim.x;

  // local column j = q U + u is gate q of unit k0 + u: global column q H + k0 + u
  for (int i = tid; i < H * NC; i += nthr) {
    const int k = i / NC, j = i - k * NC, q = j / U;
    w_s[j * HP + k] = w_hh[(size_t)k * G + q * H + k0 + (j - q * U)];
  }
  for (int i = tid; i < 2 * kClusterRows * HP; i += nthr) h_s[i] = __float2bfloat16_rn(0.0f);
  for (int i = tid; i < kClusterRows * U; i += nthr) c_s[i] = 0.0f;

  const int lane = tid % 32, warp = tid / 32, nwarps = nthr / 32, tiles = NC / 8;
  const int g = lane / 4, tg = lane % 4;  // the fragments' row and column pair
  int col[MT][2];
  float bv[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nt = warp + m * nwarps, j = nt * 8 + 2 * tg + e, q = j / U;
      col[m][e] = nt < tiles ? q * H + k0 + (j - q * U) : 0;
      bv[m][e] = nt < tiles ? to_f<bf>(bias[col[m][e]]) : 0.0f;
    }
  float pc[MT][4], pn[MT][4];  // P of this step and of the next: rows g, g + 8
  auto load_p = [&](float (&dst)[MT][4], int t) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int b = b0 + g + 8 * rr;
        const bool ok = b < B && warp + m * nwarps < tiles;
        const float* row = P + ((size_t)t * B + (ok ? b : 0)) * G;
        dst[m][2 * rr] = ok ? row[col[m][0]] : 0.0f;
        dst[m][2 * rr + 1] = ok ? row[col[m][1]] : 0.0f;
      }
  };
  load_p(pc, 0);
  cluster.sync();  // every CTA's h_s is zero before a peer writes into it

  for (int t = 0; t < Tn; ++t) {
    const bf* hc = h_s + (t & 1) * kClusterRows * HP;
    bf* hn = h_s + ((t + 1) & 1) * kClusterRows * HP;
    if (t + 1 < Tn) load_p(pn, t + 1);
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;
    const bf* ha = hc + g * HP + 2 * tg;
    for (int kb = 0; kb < H; kb += 16) {
      const uint32_t a[4] = {ld32(ha + kb), ld32(ha + 8 * HP + kb), ld32(ha + kb + 8),
                             ld32(ha + 8 * HP + kb + 8)};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int nt = warp + m * nwarps;
        if (nt < tiles) {
          const bf* wb = w_s + (nt * 8 + g) * HP + kb + 2 * tg;
          mma_bf16(acc[m], a, ld32(wb), ld32(wb + 8));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int nt = warp + m * nwarps;
      if (nt >= tiles) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float* gr = g_s + (g + 8 * rr) * NC + nt * 8 + 2 * tg;
        gr[0] = (pc[m][2 * rr] + acc[m][2 * rr]) + bv[m][0];
        gr[1] = (pc[m][2 * rr + 1] + acc[m][2 * rr + 1]) + bv[m][1];
      }
    }
    __syncthreads();  // the tile's gates of this CTA's columns are complete

    for (int i = tid; i < kClusterRows * U; i += nthr) {
      const int r = i / U, u = i - r * U, b = b0 + r;
      const size_t row = (size_t)t * B + b;
      const bool res = RES && b < B;
      const float h = cell_step<bf>(g_s + r * NC + u, (size_t)U, H, c_s[i],
                                    res ? prefac + row * G + k0 + u : nullptr,
                                    res ? qf + row * 2 * H + k0 + u : nullptr);
      const bf hb = from_f<bf>(b < B ? h : 0.0f);
      if (b < B && (!last || t == Tn - 1)) h_seq[(last ? (size_t)b : row) * H + k0 + u] = hb;
      hn[r * HP + k0 + u] = hb;
    }
    __syncthreads();  // this CTA's slice of h_t is in its own buffer

    if (U % 8 == 0)
      push_rows<uint4>(cluster, hn, HP, k0, U, N, rank);
    else if (U % 4 == 0)
      push_rows<uint2>(cluster, hn, HP, k0, U, N, rank);
    else
      push_rows<uint32_t>(cluster, hn, HP, k0, U, N, rank);
    cluster.sync();  // h_t complete in every CTA; g_s free

#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) pc[m][e] = pn[m][e];
  }
}

template <bool RES>
int launch_cluster_scan(int N, const float* P, const float* w_hh, const float* bias,
                        float* h_seq, float* prefac, float* qf, int Tn, int B, int H, int last,
                        cudaStream_t s) {
  if (N < 1 || H % N != 0) return (int)cudaErrorInvalidValue;
  const int NC = 4 * (H / N), tiles = (B + kClusterRows - 1) / kClusterRows;
  const size_t smem = cluster_smem(H, N);
#define CEREBRA_RR(R)                                                                          \
  case R:                                                                                      \
    return launch_clusters(cluster_scan_kernel<R, RES>, N, tiles,                              \
                           NC / 2 * (kClusterRows / R) * kClusterKSplit, smem, s, P, w_hh, bias, \
                           h_seq, prefac, qf, Tn, B, H, last);
  switch (cluster_rows(NC)) {
    CEREBRA_RR(16)
    CEREBRA_RR(8)
    CEREBRA_RR(4)
    CEREBRA_RR(2)
    CEREBRA_RR(1)
  }
#undef CEREBRA_RR
  return (int)cudaErrorInvalidValue;
}

template <bool RES>
int launch_cluster_scan(int N, const float* P, const __nv_bfloat16* w_hh,
                        const __nv_bfloat16* bias, __nv_bfloat16* h_seq, __nv_bfloat16* prefac,
                        __nv_bfloat16* qf, int Tn, int B, int H, int last, cudaStream_t s) {
  if (N < 1 || H % N != 0 || H % 16 != 0 || (H / N) % 2 != 0) return (int)cudaErrorInvalidValue;
  const int NC = 4 * (H / N), tiles = (B + kClusterRows - 1) / kClusterRows;
  const int nwarps = cluster_tc_warps(NC), mt = (NC / 8 + nwarps - 1) / nwarps;
  const size_t smem = cluster_tc_smem(H, N);
#define CEREBRA_MT(M)                                                                        \
  if (mt <= M)                                                                               \
    return launch_clusters(cluster_scan_tc_kernel<M, RES>, N, tiles, 32 * nwarps, smem, s, P, \
                           w_hh, bias, h_seq, prefac, qf, Tn, B, H, last);
  CEREBRA_MT(1)
  CEREBRA_MT(2)
  CEREBRA_MT(4)
  CEREBRA_MT(8)
#undef CEREBRA_MT
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- the wavefront forward
// Replaces _fwd_train_kernel (K1), _fwd_infer_last_kernel (K3),
// _fwd_train_rc_kernel (K10) and _fwd_infer_kernel (K4) in bf16 at the
// widths lstm_stack.py wave_fits and wave_split_fits take: the whole stack
// in one launch, with no input product in device memory. One thread-block
// cluster a batch tile of 16 MT rows (MT = 1, split 1 to 3), NS CTAs a
// layer: NS = 1 where one CTA holds a layer's weights (the CLI's C = H =
// 96), NS = 2 ("the split layer") where only half fit (the DINO-LSTM's
// C 96, H 128: 289.5 KiB a layer). CTA s of layer l (cluster rank NS l + s) owns the U = H/NS hidden
// units [s U, (s+1) U) and their four gates, holds those 4U columns of
// [W_ih; W_hh] ((in + H) x 4U bf16: 150 KiB at C = H = 96, 132 KiB split at
// C 96, H 128) in shared memory for the whole sequence, column by column,
// and runs the steps t = 0 .. T-1 of its units: the step's product
// [inp_t | h_{t-1}]·[W_ih; W_hh] on mma.sync (m16n8k16, bf16 operands, f32
// sums; inp·W_ih and h·W_hh in two accumulators, then (ax + ah) + b, the
// Pallas bodies' order), the f32 cell in registers straight from the
// accumulators, h_t rounded to bf16 into the CTA's own h buffer, into its
// sibling's (split) and into the input ring of each CTA of layer l+1, and
// one __syncthreads. What a step stores to device memory is the mode's:
// K1 (TRAIN) h_all, prefac and qf; K10 (TRAIN_RC) h_all and c_all, c
// rounded to bf16 from the f32 register carry, which stays unrounded; K3
// (INFER_LAST) the top layer's h at T-1; K4 (INFER_SEQ) the top layer's h
// at every t.
// Layer 0 copies x_t into its ring with cp.async, kWaveRing - 1 steps
// ahead. The layers meet only at the ring (a wavefront: layer l runs behind
// layer l-1, at most kWaveRing - 1 steps): each CTA of layer l writes its
// units of h_t into slot t % kWaveRing of every CTA of layer l+1 with
// st.async, whose bytes complete on that slot's "full" mbarrier there (a
// slot's phase wants all H units, from the NS producers), and each CTA of
// layer l+1, once it has read a slot, arrives on the slot's "empty"
// mbarrier in every CTA of layer l (NS arrivals a phase), which waits for
// it before it refills the slot. So no barrier spans the cluster in the
// loop, and no barrier waits for the stores to device memory.
// The split's sibling exchange: a CTA's W_hh product needs all of h_{t-1},
// half of it its sibling's. Each CTA writes its half of h_t into its own h
// buffer (t+1) % 2 and by st.async into the same place of its sibling's,
// completing on the sibling's "hfull" mbarrier of that buffer; the sibling
// waits on it between its W_ih product (which needs no h) and its W_hh
// product. No "empty" barrier guards that buffer: a CTA writes into it at
// step t only once the sibling's whole h_{t-1} has landed, and every warp
// of the sibling computed its part of h_{t-1} from its own reads of that
// buffer at step t-1, so those reads are done.
// Warp w owns local units [8w, 8w + 8) and their four gates: its n8 tiles
// are the columns q U + 8w .. of gate q, so each lane's accumulators hold
// all four pre-activations of its 2 rows x 2 units of each row tile and the
// cell needs no exchange: U/8 warps, c in registers. With MT row tiles a
// warp applies each B fragment of the weights to MT A fragments: the
// split's 15 clusters of 8 CTAs a card (one CTA an SM) then take B = 1024
// in 2 waves of 48 rows in place of 5 of 16, at a step that costs far
// less than MT times one tile's (lstm_stack.py split_tiles).
// What bounds it on an H100: T serial steps of a few µs, not the bytes (K1
// at B = 1024 writes 1.27 GB, 0.38 ms at 3.35 TB/s) or the operations (0.07
// ms). In a step a CTA's product reads 222 KiB of fragments from shared
// memory (the weights' 150 KiB and every warp's copy of A: ~1,700 cycles at
// 128 bytes a cycle), then its cell runs ten MUFU operations a value on
// 16 x U values (~1,000 cycles at 16 a cycle), one after the other. A
// barrier across the cluster at every step, which this kernel first used,
// cost more than the handshake that replaced it and waited for K1's stores
// to device memory (PERF.md §6).
// Buffers, the same offsets in every CTA (the ring and h are written across
// the cluster): bf16 w_s (4U, KW) | in_s (kWaveRing, 16 MT, IW) | h_s (2,
// 16 MT, H + 8), KW = max(C, H) + H + 8, IW = max(C, H) + 8 (rows padded by 8
// values, so a warp's fragment loads hit 32 banks); then the mbarriers
// full[kWaveRing], empty[kWaveRing] and, split, hfull[2].

constexpr int kWaveSplitTiles = 3;  // row tiles of 16 a cluster of the split layer, at most

// bytes of shared memory of one CTA of the wavefront forward, NS CTAs a
// layer, MT row tiles of 16 a cluster
inline size_t wave_smem(int C, int H, int NS, int MT) {
  const size_t in = C > H ? C : H, U = H / NS, rows = (size_t)kWaveRows * MT;
  return 2 * (4 * U * (in + H + 8) + kWaveRing * rows * (in + 8) + 2 * rows * ((size_t)H + 8)) +
         (2 * kWaveRing + (NS > 1 ? 2 : 0)) * sizeof(uint64_t);
}

template <int MODE, int NS, int MT>
__global__ void __launch_bounds__(kWaveThreads, 1)
    wave_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_ih0,
                    const __nv_bfloat16* __restrict__ w_ihr,
                    const __nv_bfloat16* __restrict__ w_hh,
                    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ h_all,
                    __nv_bfloat16* __restrict__ prefac, __nv_bfloat16* __restrict__ qf,
                    __nv_bfloat16* __restrict__ c_all, __nv_bfloat16* __restrict__ h_out, int Tn,
                    int B, int C, int H) {
  using bf = __nv_bfloat16;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), L = (int)cluster.num_blocks() / NS;
  const int l = rank / NS, ub = (rank % NS) * (H / NS);  // layer, first unit of this CTA
  const int G = 4 * H, U = H / NS, NC = 4 * U, in = l == 0 ? C : H, wide = C > H ? C : H;
  const int KW = wide + H + 8, IW = wide + 8, HW = H + 8;
  constexpr int R = kWaveRows * MT;  // rows of the cluster's tile
  const int b0 = (int)(blockIdx.x / (NS * L)) * R;
  extern __shared__ __align__(16) float smem[];
  bf* w_s = reinterpret_cast<bf*>(smem);          // [local column][k]: W_ih rows, then W_hh's
  bf* in_s = w_s + (size_t)NC * KW;                // [slot][row][k]
  bf* h_s = in_s + (size_t)kWaveRing * R * IW;     // [buf][row][unit]
  // full[k]: the layer below's h has filled slot k; empty[k]: the layer
  // above has read its slot k; hfull[buf]: the sibling's half of h is in
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + 2 * R * HW);
  uint64_t* empty = full + kWaveRing;
  uint64_t* hfull = empty + kWaveRing;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int slot_bytes = R * H * (int)sizeof(bf), half_bytes = R * U * (int)sizeof(bf);

  const bf* wi = l == 0 ? w_ih0 : w_ihr + (size_t)(l - 1) * H * G;
  const bf* wh = w_hh + (size_t)l * H * G;
  // local column j = q U + u is gate q of unit ub + u: global column q H + ub + u
  for (int i = tid; i < (in + H) * NC; i += nthr) {
    const int k = i / NC, j = i - k * NC, q = j / U, col = q * H + ub + (j - q * U);
    w_s[(size_t)j * KW + k] = k < in ? wi[(size_t)k * G + col] : wh[(size_t)(k - in) * G + col];
  }
  for (int i = tid; i < 2 * R * HW; i += nthr) h_s[i] = __float2bfloat16_rn(0.0f);
  if (tid == 0) {
    for (int k = 0; k < kWaveRing; ++k) {
      wave_init(full + k, 1);
      wave_init(empty + k, NS);  // every CTA of the layer above frees the slot
      if (l > 0) wave_expect(full + k, slot_bytes);  // the first use of each slot
    }
    if constexpr (NS > 1) {
      for (int k = 0; k < 2; ++k) {  // first uses: buffer 1 at t = 1, buffer 0 at t = 2
        wave_init(hfull + k, 1);
        wave_expect(hfull + k, half_bytes);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // layer 0: x_t's R rows into ring slot t % kWaveRing, 16 bytes a copy,
  // zeros for rows past B; one commit group a step (empty past Tn)
  auto load_x = [&](int t) {
    if (l == 0 && t < Tn) {
      bf* dst = in_s + (size_t)(t % kWaveRing) * R * IW;
      const int chunks = C / 8;
      for (int i = tid; i < R * chunks; i += nthr) {
        const int r = i / chunks, e = i - r * chunks, b = b0 + r;
        tc::cp_async<16>(dst + r * IW + e * 8,
                         x + ((size_t)t * B + (b < B ? b : 0)) * C + e * 8, b < B);
      }
    }
    tc::cp_async_commit();
  };
  for (int t = 0; t < kWaveRing - 1; ++t) load_x(t);

  const int lane = tid % 32, warp = tid / 32, g = lane / 4, tg = lane % 4;
  const int u0 = ub + 8 * warp + 2 * tg;  // this lane's units u0, u0 + 1
  float bv[4][2];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[q][e] = to_f<bf>(bias[(size_t)l * G + q * H + u0 + e]);
  float c[MT][4] = {};  // [m][2 rr + e]: row 16 m + g + 8 rr, unit u0 + e

  tc::cp_async_wait<kWaveRing - 2>();  // x_0 is in
  cluster.sync();  // weights, zero h, x_0 and the barriers in place; every CTA has started

  // this lane's h_t (bf16 pairs) and, for K1, its residuals, [m][rr]: h,
  // the four prefactors, q, f; for K10 [m][rr][1] is c_t
  uint32_t out[MT][2][7];
  for (int t = 0; t < Tn; ++t) {
    const int k = t % kWaveRing, phase = (t / kWaveRing) & 1;
    bf* slot = in_s + (size_t)k * R * IW;
    if (l == 0)
      load_x(t + kWaveRing - 1);  // into the slot step t - 1 read
    else
      wave_wait(full + k, phase);  // h_t of the layer below is in slot k
    // fragments by ldmatrix.x4 (lane i gives a row of matrix i / 8): A's
    // rows i % 8 + 8 ((i / 8) & 1) at k + 8 (i / 16), the mma's a[0..3]; B's
    // local column 8 warp + i % 8 of gate q + i / 16 at k + 8 ((i / 8) & 1),
    // the b0 and b1 of gates q and q + 1
    const int ar = (lane % 8) + 8 * ((lane / 8) & 1), ak = 8 * (lane / 16);
    const bf* xa = slot + ar * IW + ak;
    const bf* ha = h_s + (size_t)(t & 1) * R * HW + ar * HW + ak;
    const bf* wl =
        w_s + (size_t)(8 * warp + lane % 8 + (lane / 16) * U) * KW + 8 * ((lane / 8) & 1);
    // [m][q]: row tile m, gate q; a B fragment serves every row tile
    float ax[MT][4][4], ah[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[m][q][e] = ah[m][q][e] = 0.0f;
#pragma unroll 3
    for (int kb = 0; kb < in; kb += 16) {
      uint32_t a[MT][4], b[4];
#pragma unroll
      for (int m = 0; m < MT; ++m) tc::ldmatrix_x4(a[m], xa + m * kWaveRows * IW + kb);
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        tc::ldmatrix_x4(b, wl + (size_t)q * U * KW + kb);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(ax[m][q], a[m], b[0], b[1]);
          mma_bf16(ax[m][q + 1], a[m], b[2], b[3]);
        }
      }
    }
    if constexpr (NS > 1) {  // the sibling's half of h_{t-1} is in buffer t % 2
      if (t > 0) wave_wait(hfull + (t & 1), ((t - 1) >> 1) & 1);
    }
#pragma unroll 3
    for (int kb = 0; kb < H; kb += 16) {
      uint32_t a[MT][4], b[4];
#pragma unroll
      for (int m = 0; m < MT; ++m) tc::ldmatrix_x4(a[m], ha + m * kWaveRows * HW + kb);
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
        tc::ldmatrix_x4(b, wl + (size_t)q * U * KW + in + kb);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(ah[m][q], a[m], b[0], b[1]);
          mma_bf16(ah[m][q + 1], a[m], b[2], b[3]);
        }
      }
    }

    const bool up = l + 1 < L;
    // the layer above reads h_t from its slot k, once it has read step t - 4
    if (up && t >= kWaveRing) wave_wait(empty + k, phase ^ 1);
    bf* hn = h_s + (size_t)((t + 1) & 1) * R * HW;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = kWaveRows * m + g + 8 * rr;
        float hv[2], res[2][6];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float gv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gv[q] = (ax[m][q][2 * rr + e] + ah[m][q][2 * rr + e]) + bv[q][e];
          hv[e] = cell_update<MODE == TRAIN>(gv, 1, c[m][2 * rr + e], res[e]);
        }
        uint32_t* o = out[m][rr];
        o[0] = tc::pack_bf16(hv[0], hv[1]);
        *reinterpret_cast<uint32_t*>(hn + r * HW + u0) = o[0];
        if constexpr (NS > 1) {  // the sibling reads h_t at step t + 1
          if (t + 1 < Tn) wave_store_peer(hn + r * HW + u0, o[0], hfull + ((t + 1) & 1), rank ^ 1);
        }
        if (up) {
#pragma unroll
          for (int p = 0; p < NS; ++p)
            wave_store_peer(slot + r * IW + u0, o[0], full + k, (l + 1) * NS + p);
        }
        if constexpr (MODE == TRAIN) {
#pragma unroll
          for (int j = 0; j < 6; ++j) o[j + 1] = tc::pack_bf16(res[0][j], res[1][j]);
        }
        if constexpr (MODE == TRAIN_RC) o[1] = tc::pack_bf16(c[m][2 * rr], c[m][2 * rr + 1]);
      }
    if (l == 0) tc::cp_async_wait<kWaveRing - 2>();  // x_{t+1} is in
    __syncthreads();  // h_t in place; every warp has read slot k and h buffer t % 2
    if (tid == 0) {
      if (l > 0) {
        wave_expect(full + k, slot_bytes);  // slot k's next use, step t + 4
#pragma unroll
        for (int p = 0; p < NS; ++p)
          wave_arrive_peer(empty + k, (l - 1) * NS + p);  // the layer below may refill slot k
      }
      if constexpr (NS > 1) {
        if (t > 0) wave_expect(hfull + (t & 1), half_bytes);  // buffer t % 2's next use, t + 2
      }
    }
    const bool top = l == L - 1;
    if (MODE == TRAIN || MODE == TRAIN_RC || (top && (MODE == INFER_SEQ || t == Tn - 1))) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int b = b0 + kWaveRows * m + g + 8 * rr;
          if (b >= B) continue;
          const size_t row = ((size_t)l * Tn + t) * B + b;
          const uint32_t* o = out[m][rr];
          if constexpr (MODE == TRAIN) {
            *reinterpret_cast<uint32_t*>(h_all + row * H + u0) = o[0];
            bf* pf = prefac + row * G + u0;
#pragma unroll
            for (int q = 0; q < 4; ++q) *reinterpret_cast<uint32_t*>(pf + q * H) = o[q + 1];
            bf* qr = qf + row * 2 * H + u0;
            *reinterpret_cast<uint32_t*>(qr) = o[5];
            *reinterpret_cast<uint32_t*>(qr + H) = o[6];
          } else if constexpr (MODE == TRAIN_RC) {
            *reinterpret_cast<uint32_t*>(h_all + row * H + u0) = o[0];
            *reinterpret_cast<uint32_t*>(c_all + row * H + u0) = o[1];
          } else {
            const size_t at = MODE == INFER_SEQ ? (size_t)t * B + b : (size_t)b;
            *reinterpret_cast<uint32_t*>(h_out + at * H + u0) = o[0];
          }
        }
    }
  }
  cluster.sync();  // no CTA leaves while a neighbour may still signal it
}

// C and H multiples of 16 (H of 32 split: U of 16), 4U threads within the
// kernel's bound, at most 8 CTAs a cluster (portable), MT row tiles of 16
// (more than one only split) and a CTA's shared memory within one block's
inline bool wave_shape_ok(int C, int H, int L, int NS, int MT) {
  return C > 0 && H > 0 && C % 16 == 0 && H % (16 * NS) == 0 && 4 * H / NS <= kWaveThreads &&
         L >= 1 && NS * L <= 8 && MT >= 1 && MT <= (NS > 1 ? kWaveSplitTiles : 1) &&
         wave_smem(C, H, NS, MT) <= 232448;
}

// the launch of the wavefront forward in mode `mode` with NS CTAs a layer
// and MT row tiles a cluster
template <int NS, int MT>
int launch_wave(int mode, const void* x, const void* w_ih0, const void* w_ihr, const void* w_hh,
                const void* bias, void* h_all, void* prefac, void* qf, void* c_all, void* h_out,
                int Tn, int B, int C, int H, int L, cudaStream_t s) {
  using bf = __nv_bfloat16;
  const size_t smem = wave_smem(C, H, NS, MT);
  const int tiles = (B + kWaveRows * MT - 1) / (kWaveRows * MT);
#define CEREBRA_MODE(M)                                                                          \
  case M:                                                                                        \
    return launch_clusters(wave_fwd_kernel<M, NS, MT>, NS * L, tiles, 4 * H / NS, smem, s,       \
                           (const bf*)x, (const bf*)w_ih0, (const bf*)w_ihr, (const bf*)w_hh,    \
                           (const bf*)bias, (bf*)h_all, (bf*)prefac, (bf*)qf, (bf*)c_all,        \
                           (bf*)h_out, Tn, B, C, H);
  switch (mode) {
    CEREBRA_MODE(INFER_LAST)
    CEREBRA_MODE(TRAIN)
    CEREBRA_MODE(INFER_SEQ)
    CEREBRA_MODE(TRAIN_RC)
  }
#undef CEREBRA_MODE
  return (int)cudaErrorInvalidValue;
}

// -------------------------------------------------- K2/K2g's layer products
// Replaces the products of pallas_lstm_stack.py:_bwd_kernel (:296-315) for
// one layer, over all M = Tn·B rows of its dgates stream at once, after the
// layer's reverse scan: the f32 weight gradients dW_ih = inpᵀ·dgates
// (in, 4H), dW_hh = h[0:Tn-1]ᵀ·dgates[1:Tn] (H, 4H; the t = 0 term vanishes,
// h_prev is zero there) and db = Σ dgates (4H), and the chain dgates·w_ihᵀ to
// the layer below, kept f32 (chain 1: gup (Tn, B, in)) or rounded once to
// the stream dtype (chain 2: dx (Tn, B, C)). w_ih (in, 4H) is read in place
// through the product's B_T flag. Each dW sums fixed row chunks into f32
// partials (scratch) that sum_partials adds in order, so a result is the
// same on every run; the caller picks the chunks to fill the card and keep
// each chunk's f32 sum short (at most 4096 rows).
//
// In bf16, where the TMA can read the operands (in and H multiples of 8,
// 16-byte bases), dW_ih, dW_hh and db are one launch of wgmma_gemm.cuh's
// stack_contract (dw_rows > 0 rows a chunk, whole 64-row steps): one pass
// over dgates a layer, h's rows B back with the TMA's zero fill for t = 0,
// db from the column sums of the same dgates tiles in shared memory, one
// partial [dW_ih | dW_hh | db] a chunk. Bound by bytes: reading dgates, inp
// and h once takes 0.16-0.19 ms a layer at B = 1024, C = H = 96, over the
// 0.09-0.14 ms of the padded multiply-adds (in and H to 128 rows) on the
// bf16 tensor cores. Elsewhere (f32, other widths) dW_ih and dW_hh are
// row-chunked products on vit_common.cuh's tiles, loaded synchronously, and
// db a column sum, each reading dgates again. The chain stays a
// vit_common.cuh product in both.

// part[z * zstride + i * K2 + j] = (aᵀ·b)[i][j] over rows [z R, (z + 1) R) of
// a (M, K1) and b (M, K2), for each group z of R rows (the last one ragged):
// one f32 partial a group, on the tensor cores in bf16
template <typename T>
int contract_groups(const T* a, int K1, const T* b, int K2, int M, int R, float* part,
                    size_t zstride, cudaStream_t st) {
  if (M <= 0) return 0;
  const dim3 grid((K2 + vit::kBN - 1) / vit::kBN, (K1 + vit::kBM - 1) / vit::kBM,
                  (M + R - 1) / R);
  const vit::EpiPartial epi{part, K2, zstride};
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    vit::gemm_tc<true, false, vit::EpiPartial>
        <<<grid, vit::kGemmThreads, 0, st>>>(a, K1, b, K2, K1, K2, M, R, epi);
  else
    vit::gemm<T, T, true, false, vit::EpiPartial>
        <<<grid, vit::kGemmThreads, 0, st>>>(a, K1, b, K2, K1, K2, M, R, epi);
  return (int)cudaGetLastError();
}

// out (K1, K2) f32 = aᵀ·b over the M rows of a (M, K1) and b (M, K2), in at
// most `splits` row chunks of whole 32-row steps, so that every chunk's tiles
// start where the products' 16-byte loads can reach them; scratch: splits *
// K1 * K2 floats
template <typename T>
int contract(const T* a, int K1, const T* b, int K2, int M, float* out, float* scratch,
             int splits, cudaStream_t st) {
  const size_t n = (size_t)K1 * K2;
  if (M == 0) return (int)cudaMemsetAsync(out, 0, n * sizeof(float), st);
  const int kchunk = ((M + splits - 1) / splits + vit::kTcBK - 1) / vit::kTcBK * vit::kTcBK;
  CEREBRA_VIT_RC(contract_groups<T>(a, K1, b, K2, M, kchunk, scratch, n, st));
  return vit::launch_sum_partials(scratch, out, (M + kchunk - 1) / kchunk, (long long)n,
                                  (long long)n, st);
}

// the chain dgates·w_ihᵀ (M, in) to the layer below: chain 1 f32 (gup), 2
// rounded once to the stream dtype (dx), 0 none
template <typename T>
int chain_product(const T* dgates, const T* w_ih, int in, int chain, void* out, int M, int H,
                  cudaStream_t st) {
  const int G = 4 * H;
  if (chain == 1)
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, true>(dgates, G, w_ih, G, M, in, G,
                                                          vit::EpiF32{(float*)out, in}, st));
  else if (chain == 2)
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, true>(
        dgates, G, w_ih, G, M, in, G, vit::EpiBiasRound<T>{nullptr, (T*)out, in}, st));
  return 0;
}

// dW_ih, dW_hh and db of one layer in one stack_contract launch over chunks
// of `rows` rows, then the chunks' partials added in order: scratch holds
// ceil(M / rows) partials of (in + H + 1) * 4H floats
inline int stack_dw(const __nv_bfloat16* dgates, const __nv_bfloat16* inp, int in,
                    const __nv_bfloat16* h, float* dw_ih, float* dw_hh, float* db, float* scratch,
                    int rows, int M, int B, int H, cudaStream_t st) {
  const int G = 4 * H, chunks = (M + rows - 1) / rows;
  const long long n = (long long)(in + H + 1) * G;
  CEREBRA_VIT_RC(wg::launch_stack(inp, in, h, H, B, dgates, G, M, rows, 1,
                                  vit::EpiPairPartial{scratch, G, (size_t)n}, st));
  CEREBRA_VIT_RC(vit::launch_sum_partials(scratch, dw_ih, chunks, (long long)in * G, n, st));
  CEREBRA_VIT_RC(
      vit::launch_sum_partials(scratch + (size_t)in * G, dw_hh, chunks, (long long)H * G, n, st));
  return vit::launch_sum_partials(scratch + (size_t)(in + H) * G, db, chunks, G, n, st);
}

template <typename T>
int layer_products(const T* dgates, const T* inp, int in, const T* h, const T* w_ih, int chain,
                   void* out, float* dw_ih, float* dw_hh, float* db, float* scratch,
                   int splits_ih, int splits_hh, int dw_rows, int Tn, int B, int H,
                   cudaStream_t st) {
  const int G = 4 * H, M = Tn * B;
  if (dw_rows > 0) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      CEREBRA_VIT_RC(stack_dw(dgates, inp, in, h, dw_ih, dw_hh, db, scratch, dw_rows, M, B, H,
                              st));
      return chain_product<T>(dgates, w_ih, in, chain, out, M, H, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  CEREBRA_VIT_RC(contract<T>(inp, in, dgates, G, M, dw_ih, scratch, splits_ih, st));
  CEREBRA_VIT_RC(
      contract<T>(h, H, dgates + (size_t)B * G, G, M - B, dw_hh, scratch, splits_hh, st));
  CEREBRA_VIT_RC(vit::column_sum<T>(dgates, nullptr, 1, db, M, G, scratch, st));
  return chain_product<T>(dgates, w_ih, in, chain, out, M, H, st);
}

// ---------------------------------------------------- the recompute backward
// Replaces cerebra/models/pallas_lstm_stack.py:_bwd_rc_kernel (K11), the
// backward that streams only K10's h_all and c_all and recomputes each
// layer-step's gates. Its rounding points are its own, not K2's
// (pallas_lstm_stack.py:366-398): q = o - o tanh^2 c and f stay f32; the
// four prefactors, dc and dh are rounded to the stream dtype before their
// products, which are rounded too; tanh c and c_prev come from the rounded
// c_all; c_prev and h_prev are zero at t = 0.
//
// The gates depend on the stored h and c only, not on the backward's
// carries, so only the dh/dc carry is serial, as in K2. The wrapper
// (lstm_stack.py _bwd_rc_chunked) walks time chunks of Tc steps from the
// last to the first and, in each, the layers from the top down, over the
// chunk's M = Tc·B rows (h_prev and c_prev are h and c one step back, a
// zero step first at t = 0):
//   cerebra_rc_gates      gates (M, 4H) f32 = [inp | h_prev]·[W_ih; W_hh] + b,
//                         one tiled product (vit_common.cuh: wmma in bf16,
//                         true f32 FMA in f32) over the concatenated operands
//   cerebra_rc_scan       the reverse scan (RC): each step forms K11's
//                         residuals from the gates and c, c_prev as it reads
//                         them, and a carry buffer takes dh_acc and dc to the
//                         next chunk
//   cerebra_rc_products   dW_ih, dW_hh and db as f32 partials of sub-groups
//                         of R_sub rows, folded in order into one partial per
//                         group of R = S·B rows (groups start at multiples of
//                         S steps, and Tc is a multiple of S), and the chain
//                         to the layer below: f32, or dx rounded once
//   cerebra_sum_partials  per layer at the end, the groups in order
// so the layer below takes a chunk's f32 chain, never a whole (Tn, B, H)
// stream, and the chunk buffers, not the sequence, set the memory. dW is the
// same for every Tc (the groups and sub-groups do not move) and on every run.
// What bounds it: the scans are serial over Tn steps and latency-bound (see
// lstm_common.cuh); the gate and dW products move each chunk's f32 gates,
// dgates and partials through device memory, bound by bytes. The
// dW contractions reduce over many rows into a small output, so a block
// sums R_sub (~512) rows: enough blocks a chunk to keep several on each SM.

// out (f32) = acc + bias (stream dtype)
template <typename T>
struct EpiGates {
  float* out;
  const T* bias;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    out[(size_t)i * ld + j] = acc + to_f<T>(bias[j]);
  }
};

// part[z * zstride + j] = sum of a[m, j] over the rows m of group z (R rows a
// group), 8 row strands a column added in order
template <typename T>
__global__ void col_sum_groups(const T* __restrict__ a, float* __restrict__ part,
                               size_t zstride, int M, int N, int R) {
  __shared__ float acc_s[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int m0 = blockIdx.y * R, m1 = min(M, m0 + R);
  float acc = 0.f;
  if (j < N)
    for (int m = m0 + threadIdx.y; m < m1; m += 8) acc += to_f<T>(a[(size_t)m * N + j]);
  acc_s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < N) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += acc_s[r][threadIdx.x];
    part[blockIdx.y * zstride + j] = s;
  }
}

// part[g * n + e] = sum over the sub-groups s < k of group g (the last group
// may have fewer, nsub in all) of sub[(g k + s) * n + e], in order of s
__global__ void fold_groups(const float* __restrict__ sub, float* __restrict__ part, int k,
                            int nsub, long long n) {
  const int g = blockIdx.y, s1 = min(nsub, (g + 1) * k);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = g * k; s < s1; ++s) acc += sub[s * n + e];
    part[g * n + e] = acc;
  }
}

// One chunk's products of one layer over its M rows: one partial of n =
// (in + H + 1)·4H floats [dW_ih | dW_hh | db] per group of R rows into part
// (which points at the chunk's first group), by way of sub-partials of
// R_sub rows (R a multiple of R_sub) in sub; and the chain. h_prev (M, H)
// pairs with dgates row by row.
template <typename T>
int rc_products(const T* dgates, const T* inp, int in, const T* h_prev, const T* w_ih, int chain,
                void* out, float* part, float* sub, int M, int R, int R_sub, int H,
                cudaStream_t st) {
  const int G = 4 * H, nsub = (M + R_sub - 1) / R_sub, groups = (M + R - 1) / R;
  const size_t n = (size_t)(in + H + 1) * G;
  CEREBRA_VIT_RC(contract_groups<T>(inp, in, dgates, G, M, R_sub, sub, n, st));
  CEREBRA_VIT_RC(contract_groups<T>(h_prev, H, dgates, G, M, R_sub, sub + (size_t)in * G, n, st));
  CEREBRA_VIT_CHECK(col_sum_groups<T><<<dim3((G + 31) / 32, nsub), dim3(32, 8), 0, st>>>(
      dgates, sub + (size_t)(in + H) * G, n, M, G, R_sub));
  const long long blocks = ((long long)n + 255) / 256;
  CEREBRA_VIT_CHECK(fold_groups<<<dim3((unsigned)(blocks < 1024 ? blocks : 1024), groups), 256,
                                  0, st>>>(sub, part, R / R_sub, nsub, (long long)n));
  return chain_product<T>(dgates, w_ih, in, chain, out, M, H, st);
}

}  // namespace

extern "C" {

// mode (FwdMode): 1 = K1 (h_all, prefac, qf); 0 = K3 (h_out (B, H));
// 2 = K4 (h_out (Tn, B, H)); 3 = K10 (h_all, c_all). bf16 != 0:
// __nv_bfloat16 streams, else float. bt in {1, 2, 4, 8, 16}.
int cerebra_lstm_fwd(int mode, int bf16, int bt, const void* x, const void* w_ih0,
                     const void* w_ihr, const void* w_hh, const void* bias, void* h_all,
                     void* prefac, void* qf, void* c_all, void* h_out, int Tn, int B, int C,
                     int H, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_fwd_mode<__nv_bfloat16, BT>(mode, x, w_ih0, w_ihr, w_hh, bias, h_all,
                                                     prefac, qf, c_all, h_out, Tn, B, C, H, L, s)
                : launch_fwd_mode<float, BT>(mode, x, w_ih0, w_ihr, w_hh, bias, h_all, prefac,
                                             qf, c_all, h_out, Tn, B, C, H, L, s);
  });
}

// K1/K4's layer-by-layer path, one layer's input product: P (M, 4H) f32 =
// inp (M, in)·w_ih (in, 4H), M = Tn·B rows.
int cerebra_fwd_in_product(int bf16, const void* inp, const void* w_ih, void* P, int M, int in,
                           int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int G = 4 * H;
  if (bf16) {
    using T = __nv_bfloat16;
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, false>((const T*)inp, in, (const T*)w_ih, G, M,
                                                           G, in, vit::EpiF32{(float*)P, G}, s));
  } else {
    const dim3 grid((M + kPBM - 1) / kPBM, (G + kPBN - 1) / kPBN);
    CEREBRA_VIT_CHECK(in_product_f32<<<grid, kPThreads, 0, s>>>(
        (const float*)inp, (const float*)w_ih, (float*)P, M, G, in));
  }
  return 0;
}

// K1/K3/K4's layer-by-layer path, one layer's recurrence over its input
// product P (Tn, B, 4H) f32 in clusters of n CTAs: h_seq (Tn, B, H), or with
// last != 0 (K3's top layer) only h at Tn-1 into h_seq (B, H); and, when
// res != 0 (K1), prefac (Tn, B, 4H) and qf (Tn, B, 2H) of the layer.
int cerebra_fwd_cluster_scan(int bf16, int res, int last, int n, const void* P,
                             const void* w_hh, const void* bias, void* h_seq, void* prefac,
                             void* qf, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)P;
  if (res && last) return (int)cudaErrorInvalidValue;
  if (bf16) {
    using T = __nv_bfloat16;
    return res ? launch_cluster_scan<true>(n, p, (const T*)w_hh, (const T*)bias, (T*)h_seq,
                                           (T*)prefac, (T*)qf, Tn, B, H, 0, s)
               : launch_cluster_scan<false>(n, p, (const T*)w_hh, (const T*)bias, (T*)h_seq,
                                            (T*)nullptr, (T*)nullptr, Tn, B, H, last, s);
  }
  using T = float;
  return res ? launch_cluster_scan<true>(n, p, (const T*)w_hh, (const T*)bias, (T*)h_seq,
                                         (T*)prefac, (T*)qf, Tn, B, H, 0, s)
             : launch_cluster_scan<false>(n, p, (const T*)w_hh, (const T*)bias, (T*)h_seq,
                                          (T*)nullptr, (T*)nullptr, Tn, B, H, last, s);
}

// K1 (mode TRAIN: h_all, prefac, qf), K3 (INFER_LAST: h_out (B, H)), K10
// (TRAIN_RC: h_all, c_all) or K4 (INFER_SEQ: h_out (Tn, B, H)) on the
// wavefront path, bf16 streams: one cluster of L CTAs (split != 0: 2L, two
// a layer) a batch tile of 16 mt rows (mt > 1 only split). The shape within
// wave_shape_ok (lstm_stack.py wave_fits, wave_split_fits), else
// cudaErrorInvalidValue.
int cerebra_fwd_wave(int mode, int split, int mt, const void* x, const void* w_ih0,
                     const void* w_ihr, const void* w_hh, const void* bias, void* h_all,
                     void* prefac, void* qf, void* c_all, void* h_out, int Tn, int B, int C, int H,
                     int L, void* stream) {
  const int NS = split ? 2 : 1;
  if (!wave_shape_ok(C, H, L, NS, mt)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CEREBRA_WAVE(S, M)                                                                     \
  if (NS == S && mt == M)                                                                      \
    return launch_wave<S, M>(mode, x, w_ih0, w_ihr, w_hh, bias, h_all, prefac, qf, c_all, h_out, \
                             Tn, B, C, H, L, s);
  CEREBRA_WAVE(1, 1)
  CEREBRA_WAVE(2, 1)
  CEREBRA_WAVE(2, 2)
  CEREBRA_WAVE(2, 3)
#undef CEREBRA_WAVE
  return (int)cudaErrorInvalidValue;
}

// clusters of the wavefront forward (split != 0: two CTAs a layer; mt row
// tiles a cluster) the card holds at once at (C, H, L), or minus a CUDA
// error code
int cerebra_fwd_wave_clusters(int split, int mt, int C, int H, int L) {
  const int NS = split ? 2 : 1;
  if (!wave_shape_ok(C, H, L, NS, mt)) return -(int)cudaErrorInvalidValue;
  int clusters = 0;
  auto occupancy = [&](auto kern) {
    return cluster_occupancy(kern, NS * L, 4 * H / NS, wave_smem(C, H, NS, mt), &clusters);
  };
  const cudaError_t e = NS == 1   ? occupancy(wave_fwd_kernel<TRAIN, 1, 1>)
                        : mt == 1 ? occupancy(wave_fwd_kernel<TRAIN, 2, 1>)
                        : mt == 2 ? occupancy(wave_fwd_kernel<TRAIN, 2, 2>)
                                  : occupancy(wave_fwd_kernel<TRAIN, 2, 3>);
  return e == cudaSuccess ? clusters : -(int)e;
}

// K2/K2g, one layer's reverse scan: dgates (Tn, B, 4H) from the layer's
// prefac and qf (contiguous slices of the stacked streams), its w_hhT
// (4H, H) and the cotangent g of its h, in the stream dtype (g_f32 == 0) or
// f32, (B, H) reaching step Tn-1 only (g_last != 0) or (Tn, B, H).
int cerebra_stack_scan_bwd(int bf16, int g_f32, int g_last, int bt, const void* prefac,
                           const void* qf, const void* g, const void* w_hhT, void* dgates,
                           int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    if (!bf16)
      return launch_scan_bwd<float, float, false, BT>(
          ScanRes<float>{(const float*)prefac, (const float*)qf}, g, g_last, w_hhT, nullptr,
          dgates, Tn, B, H, s);
    const ScanRes<bf> res{(const bf*)prefac, (const bf*)qf};
    return g_f32 ? launch_scan_bwd<bf, float, false, BT>(res, g, g_last, w_hhT, nullptr, dgates,
                                                         Tn, B, H, s)
                 : launch_scan_bwd<bf, bf, false, BT>(res, g, g_last, w_hhT, nullptr, dgates, Tn,
                                                      B, H, s);
  });
}

// K2/K2g, one layer's products (layer_products) after its scan: inp (Tn, B,
// in) is x or the layer below's h, h (Tn, B, H) the layer's own h, w_ih
// (in, 4H); dW_ih, dW_hh and db are f32 outputs; chain 0 none, 1 gup (f32),
// 2 dx (stream dtype) into out. dw_rows > 0 (bf16 only): dW and db in one
// stack_contract pass, chunks of dw_rows rows, scratch ceil(Tn B / dw_rows)
// * (in + H + 1) * 4H floats; else scratch max(splits_ih * in, splits_hh *
// H, 32) * 4H floats.
int cerebra_stack_bwd_products(int bf16, const void* dgates, const void* inp, int in,
                               const void* h, const void* w_ih, int chain, void* out,
                               void* dw_ih, void* dw_hh, void* db, void* scratch, int splits_ih,
                               int splits_hh, int dw_rows, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return layer_products<T>((const T*)dgates, (const T*)inp, in, (const T*)h, (const T*)w_ih,
                             chain, out, (float*)dw_ih, (float*)dw_hh, (float*)db,
                             (float*)scratch, splits_ih, splits_hh, dw_rows, Tn, B, H, s);
  }
  return layer_products<float>((const float*)dgates, (const float*)inp, in, (const float*)h,
                               (const float*)w_ih, chain, out, (float*)dw_ih, (float*)dw_hh,
                               (float*)db, (float*)scratch, splits_ih, splits_hh, dw_rows, Tn, B,
                               H, s);
}

// K11, one chunk and layer: the gates (M, 4H) f32 = a·w + bias of M rows,
// a = [inp | h_prev] (M, K) and w = [W_ih; W_hh] (K, 4H).
int cerebra_rc_gates(int bf16, const void* a, const void* w, const void* bias, void* gates,
                     int M, int K, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int G = 4 * H;
  if (bf16) {
    using T = __nv_bfloat16;
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, false>(
        (const T*)a, K, (const T*)w, G, M, G, K, EpiGates<T>{(float*)gates, (const T*)bias, G},
        s));
  } else {
    CEREBRA_VIT_CHECK(vit::launch_gemm<float, float, false, false>(
        (const float*)a, K, (const float*)w, G, M, G, K,
        EpiGates<float>{(float*)gates, (const float*)bias, G}, s));
  }
  return 0;
}

// K11, one chunk and layer: the reverse scan (lstm_common.cuh, RC) that
// forms K11's residuals from the f32 gates (Tn, B, 4H) and c, c_prev (Tn, B,
// H) of the chunk, under the cotangent g (Tn, B, H) in the stream dtype
// (g_f32 == 0) or f32, with the layer's f32 (2, B, H) carry: dgates.
int cerebra_rc_scan(int bf16, int g_f32, int bt, const void* gates, const void* c,
                    const void* c_prev, const void* g, const void* w_hhT, void* carry,
                    void* dgates, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    if (!bf16)
      return launch_scan_bwd<float, float, true, BT>(
          ScanRes<float>{nullptr, nullptr, (const float*)gates, (const float*)c,
                         (const float*)c_prev},
          g, 0, w_hhT, carry, dgates, Tn, B, H, s);
    const ScanRes<bf> res{nullptr, nullptr, (const float*)gates, (const bf*)c, (const bf*)c_prev};
    return g_f32 ? launch_scan_bwd<bf, float, true, BT>(res, g, 0, w_hhT, carry, dgates, Tn, B,
                                                        H, s)
                 : launch_scan_bwd<bf, bf, true, BT>(res, g, 0, w_hhT, carry, dgates, Tn, B, H,
                                                     s);
  });
}

// K11, one chunk and layer: dW partials per group of R rows into part (by way
// of sub-partials of R_sub rows in sub) and the chain (0 none, 1 f32 gup,
// 2 dx) into out (rc_products).
int cerebra_rc_products(int bf16, const void* dgates, const void* inp, int in,
                        const void* h_prev, const void* w_ih, int chain, void* out, void* part,
                        void* sub, int M, int R, int R_sub, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return rc_products<T>((const T*)dgates, (const T*)inp, in, (const T*)h_prev, (const T*)w_ih,
                          chain, out, (float*)part, (float*)sub, M, R, R_sub, H, s);
  }
  return rc_products<float>((const float*)dgates, (const float*)inp, in, (const float*)h_prev,
                            (const float*)w_ih, chain, out, (float*)part, (float*)sub, M, R,
                            R_sub, H, s);
}

// out[e] = sum over z < splits of part[z * n + e], in order of z
int cerebra_sum_partials(const void* part, void* out, int splits, long long n, void* stream) {
  return vit::launch_sum_partials((const float*)part, (float*)out, splits, n, n,
                                  (cudaStream_t)stream);
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
