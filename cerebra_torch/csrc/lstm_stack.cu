// Whole-stack LSTM kernels for Hopper (sm_90a): the CUDA counterparts of the
// Pallas kernels in cerebra/models/pallas_lstm_stack.py.
//
//   lstm_fwd_kernel<T, BT, TRAIN>      replaces _fwd_train_kernel      (K1)
//   lstm_fwd_kernel<T, BT, INFER_LAST> replaces _fwd_infer_last_kernel (K3)
//   lstm_fwd_kernel<T, BT, INFER_SEQ>  replaces _fwd_infer_kernel      (K4)
//   lstm_fwd_kernel<T, BT, TRAIN_RC>   replaces _fwd_train_rc_kernel   (K10)
//   cerebra_stack_scan_bwd +           replace _bwd_kernel: K2 (need_dx=False,
//   cerebra_stack_bwd_products         g_last_only=True) and K2g (need_dx=True
//                                      and/or a full (Tn, B, H) cotangent), as
//                                      one reverse scan (lstm_common.cuh's
//                                      scan_bwd_kernel, K14's) and one set of
//                                      tensor-core products per layer
//   lstm_bwd_rc_kernel<T, BT>          replaces _bwd_rc_kernel         (K11)
//   reduce_partials                    replaces K11's accumulation of dW
//                                      across the sequential TPU grid
//
// Layouts (all row-major, T = stream dtype, float or __nv_bfloat16):
//   x (Tn, B, C); w_ih0 (C, 4H); w_ihr (L-1, H, 4H); w_hh (L, H, 4H);
//   bias (L, 4H); h_all (L, Tn, B, H); prefac (L, Tn, B, 4H);
//   qf (L, Tn, B, 2H); c_all (L, Tn, B, H); h_out (B, H) for K3, (Tn, B, H)
//   for K4; g (B, H) or (Tn, B, H) for K2/K2g, (Tn, B, H) for K11;
//   dx (Tn, B, C); w_ihT0 (4H, C), w_ihT_r (L-1, 4H, H) and w_hhT (L, 4H, H)
//   are the transposes K11's chain products read; gate order [i, f, g, o].
//
// What bounds the forwards and K11 on an H100: the recurrence is serial over
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
// picks BT per direction from timings on the card (lstm_stack.py
// pick_tile). Tensor cores (wgmma), TMA and clusters are later work.
//
// K2/K2g keep only what is serial in the serial loop: the dh/dc carries of
// one layer (the reverse scan). Everything else is a function of a layer's
// dgates stream and runs afterwards over all Tn·B rows at once, on the
// tensor cores in bf16 (vit_common.cuh's tiled product): dW_ih, dW_hh and db
// as f32 sums in fixed row chunks added in order, the f32 chain to the
// layer below and dx.
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

#include "lstm_common.cuh"
#include "vit_common.cuh"

namespace {

// gates[r * rs + j * js] = (inp @ wi)[r][j] + (hr @ wh)[r][j] + bias[j] for the
// BT rows of a batch tile and every gate column j < 4H, one thread per column;
// inp (in, BT) and hr (H, BT) are transposed rows in shared memory. The
// forwards compute their gates here and K11 recomputes them here, so K11's
// gates equal K10's bit for bit (the same operands in the same order).
template <typename T, int BT>
__device__ __forceinline__ void gate_product(float* gates, int rs, int js,
                                             const T* __restrict__ wi, const float* inp, int in,
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
    for (int r = 0; r < BT; ++r) gates[r * rs + j * js] = (ax[r] + ah[r]) + bj;
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

      gate_product<T, BT>(gates_s, G, 1, wi, inp, l == 0 ? C : H, w_hh + (size_t)l * H * G, hr,
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

// ---------------------------------------------------- the recompute backward
// K11's shared-memory layout (floats):
//   dh_s, dc_s (L, BT, H) | dg_s (4H, BT) | gup_s (BT, H) |
//   inp_s (max(C, H), BT) | hp_s (H, BT)
// and, per layer-step, the two device functions below. Each block owns one
// f32 partial of every dW/db (n_part floats at part + blockIdx.x * n_part,
// laid out as [dW_ih0 (C, 4H) | dW_ihr (L-1, H, 4H) | dW_hh (L, H, 4H) |
// db (L, 4H)]), read-modified-written only by the thread of that gate
// column: no atomics.

// this block's partial dW_ih (in, 4H), dW_hh (H, 4H) and db (4H) of one layer
// += inp_sᵀ dg, hp_sᵀ dg, Σ_r dg: one thread per gate column
template <int BT>
__device__ __forceinline__ void accumulate_dw(float* p_ih, float* p_hh, float* p_b,
                                              const float* dg_s, const float* inp_s, int in,
                                              const float* hp_s, int H) {
  const int G = 4 * H;
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    float d[BT];
    rows<BT>(dg_s + j * BT, d);
    float sb = 0.0f;
#pragma unroll
    for (int r = 0; r < BT; ++r) sb += d[r];
#pragma unroll 4
    for (int k = 0; k < in; ++k) {
      float v[BT];
      rows<BT>(inp_s + k * BT, v);
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < BT; ++r) s = fmaf(v[r], d[r], s);
      p_ih[(size_t)k * G + j] += s;
    }
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float v[BT];
      rows<BT>(hp_s + k * BT, v);
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < BT; ++r) s = fmaf(v[r], d[r], s);
      p_hh[(size_t)k * G + j] += s;
    }
    p_b[j] += sb;
  }
}

// the recurrent carry dh = dg @ w_hh^T (BT, H) into dhl, then the chain
// g_up = dg @ w_ih^T over the layer's n_up input units: H for a layer above
// 0, into gup_s; C for layer 0 when dx is wanted, into dx at step t; none
// otherwise. One thread per output unit and all BT rows.
template <typename T, int BT>
__device__ __forceinline__ void chain(float* dhl, float* gup_s, T* __restrict__ dx,
                                      const float* dg_s, const T* __restrict__ whT,
                                      const T* __restrict__ wiT, int l, int n_up, int t, int b0,
                                      int B, int C, int H) {
  const int G = 4 * H;
  for (int k = threadIdx.x; k < H + n_up; k += blockDim.x) {
    float s[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) s[r] = 0.0f;
    if (k < H) {
      col_dot<T, BT>(s, whT, dg_s, G, H, k);
#pragma unroll
      for (int r = 0; r < BT; ++r) dhl[r * H + k] = s[r];
      continue;
    }
    const int u = k - H;
    col_dot<T, BT>(s, wiT, dg_s, G, n_up, u);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      if (l > 0)
        gup_s[r * H + u] = s[r];
      else if (b0 + r < B)
        dx[((size_t)t * B + b0 + r) * C + u] = from_f<T>(s[r]);
    }
  }
}

// Replaces cerebra/models/pallas_lstm_stack.py:_bwd_rc_kernel: the backward
// that streams only h_all and c_all (K10's) and recomputes each layer-step's
// gates with gate_product, bit for bit K10's, before the chain, dx (always)
// and dW. Its rounding points are not K2's (pallas_lstm_stack.py:372-399):
// q = o - o tanh^2 c and f stay f32; only the four prefactors and dc, dh are
// rounded to the stream dtype before their products, which are rounded too;
// tanh c and c_prev come from the rounded c_all; c_prev and h_prev are zero
// at t = 0. The gates are recomputed in place in dg_s (4H, BT): each thread
// reads its four gates and writes its four gate gradients at the same
// places. Bound by latency: per serial layer-step a tile reads the layer's
// weights three times from L2 (K10's product, dh and the chain) and
// read-modify-writes its (in + H) * 4H f32 partial of dW in device memory.
template <typename T, int BT>
__global__ void __launch_bounds__(MAX_THREADS)
    lstm_bwd_rc_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const T* __restrict__ h_all, const T* __restrict__ c_all,
                       const T* __restrict__ w_ih0, const T* __restrict__ w_ihr,
                       const T* __restrict__ w_hh, const T* __restrict__ bias,
                       const T* __restrict__ w_ihT0, const T* __restrict__ w_ihT_r,
                       const T* __restrict__ w_hhT, T* __restrict__ dx, float* __restrict__ part,
                       int Tn, int B, int C, int H, int L) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int IN = C > H ? C : H;
  float* dh_s = smem;
  float* dc_s = dh_s + L * BT * H;
  float* dg_s = dc_s + L * BT * H;
  float* gup_s = dg_s + G * BT;
  float* inp_s = gup_s + BT * H;
  float* hp_s = inp_s + IN * BT;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const size_t n_part = (size_t)G * (C + (L - 1) * H + L * H + L);
  float* mine = part + blockIdx.x * n_part;
  float* p_hh = mine + (size_t)G * (C + (L - 1) * H);
  float* p_b = p_hh + (size_t)L * H * G;
  const size_t HB = (size_t)H * BT;  // stride between two gates of a unit in dg_s

  for (size_t i = tid; i < n_part; i += nthr) mine[i] = 0.0f;
  for (int i = tid; i < 2 * L * BT * H; i += nthr) dh_s[i] = 0.0f;  // dh_s and dc_s
  for (int i = tid; i < BT * H; i += nthr) gup_s[i] = 0.0f;

  for (int t = Tn - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int in = l == 0 ? C : H;
      float* dhl = dh_s + l * BT * H;
      float* dcl = dc_s + l * BT * H;
      __syncthreads();  // the layer above has written gup_s and is done with the rest

      // input rows of this layer at t and h at t-1: the recompute's operands
      // (exactly K10's) and dW's
      for (int i = tid; i < BT * in; i += nthr) {
        const int r = i / in, k = i - r * in, b = b0 + r;
        float v = 0.0f;
        if (b < B)
          v = l == 0 ? to_f<T>(x[((size_t)t * B + b) * C + k])
                     : to_f<T>(h_all[(((size_t)(l - 1) * Tn + t) * B + b) * H + k]);
        inp_s[k * BT + r] = v;
      }
      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, u = i - r * H, b = b0 + r;
        hp_s[u * BT + r] = b < B && t > 0
                               ? to_f<T>(h_all[(((size_t)l * Tn + t - 1) * B + b) * H + u])
                               : 0.0f;
      }
      __syncthreads();  // operands in place

      gate_product<T, BT>(dg_s, 1, BT, l == 0 ? w_ih0 : w_ihr + (size_t)(l - 1) * H * G,
                          inp_s, in, w_hh + (size_t)l * H * G, hp_s, bias + (size_t)l * G, H);
      __syncthreads();  // gates complete

      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, u = i - r * H, b = b0 + r;
        float* gd = dg_s + u * BT + r;  // gate q of this row and unit at gd[q * HB]
        if (b >= B) {
#pragma unroll
          for (int q = 0; q < 4; ++q) gd[q * HB] = 0.0f;
          continue;
        }
        float a[4], p[4], d[4];
        activations(gd, HB, a);
        const size_t row = ((size_t)l * Tn + t) * B + b;
        const float c_prev = t > 0 ? to_f<T>(c_all[(row - B) * H + u]) : 0.0f;
        const float q = prefactors(a, c_prev, tanhf(to_f<T>(c_all[row * H + u])), p);
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = rnd<T>(p[k]);
        // the cotangent reaches the top layer at every step; a lower layer
        // takes the chain from the layer above
        const float g_up = l == L - 1 ? to_f<T>(g[((size_t)t * B + b) * H + u]) : gup_s[i];
        dcl[i] = gate_grads<T>(dhl[i] + g_up, dcl[i], q, a[1], p, d);
#pragma unroll
        for (int k = 0; k < 4; ++k) gd[k * HB] = d[k];
      }
      __syncthreads();  // dg_s complete

      accumulate_dw<BT>(l == 0 ? mine : mine + (size_t)G * (C + (l - 1) * H),
                        p_hh + (size_t)l * H * G, p_b + (size_t)l * G, dg_s, inp_s, in, hp_s, H);
      chain<T, BT>(dhl, gup_s, dx, dg_s, w_hhT + (size_t)l * G * H,
                   l > 0 ? w_ihT_r + (size_t)(l - 1) * G * H : w_ihT0, l, l > 0 ? H : C, t,
                   b0, B, C, H);
    }
  }
}

// Replaces the accumulation of dW across the TPU's sequential grid
// (pallas_lstm_stack.py:_bwd_kernel and _bwd_rc_kernel, dwih_ref/dwhh_ref/
// db_ref +=). Bound by reading the partials once (n_blk * n floats),
// coalesced over i.
// out[i] = sum over blocks of part[blk, i], in block order: deterministic
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int n_blk, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < n_blk; ++b) s += part[(size_t)b * n + i];
  out[i] = s;
}

size_t bwd_smem(int BT, int C, int H, int L) {
  const int IN = C > H ? C : H;
  return sizeof(float) * ((size_t)2 * L * BT * H + 4 * H * BT + BT * H + IN * BT + H * BT);
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
int launch_bwd_rc(const void* g, const void* x, const void* h_all, const void* c_all,
                  const void* w_ih0, const void* w_ihr, const void* w_hh, const void* bias,
                  const void* w_ihT0, const void* w_ihT_r, const void* w_hhT, void* dx,
                  void* part, int Tn, int B, int C, int H, int L, cudaStream_t stream) {
  const size_t smem = bwd_smem(BT, C, H, L);
  auto kern = lstm_bwd_rc_kernel<T, BT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_blk = (B + BT - 1) / BT;
  kern<<<n_blk, threads_for(H), smem, stream>>>(
      (const T*)g, (const T*)x, (const T*)h_all, (const T*)c_all, (const T*)w_ih0,
      (const T*)w_ihr, (const T*)w_hh, (const T*)bias, (const T*)w_ihT0, (const T*)w_ihT_r,
      (const T*)w_hhT, (T*)dx, (float*)part, Tn, B, C, H, L);
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

// -------------------------------------------------- K2/K2g's layer products
// Replaces the products of pallas_lstm_stack.py:_bwd_kernel (:296-315) for
// one layer, over all M = Tn·B rows of its dgates stream at once, after the
// layer's reverse scan: the f32 weight gradients dW_ih = inpᵀ·dgates
// (in, 4H), dW_hh = h[0:Tn-1]ᵀ·dgates[1:Tn] (H, 4H; the t = 0 term vanishes,
// h_prev is zero there) and db = Σ dgates (4H), and the chain dgates·w_ihᵀ to
// the layer below, kept f32 (chain 1: gup (Tn, B, in)) or rounded once to
// the stream dtype (chain 2: dx (Tn, B, C)). w_ih (in, 4H) is read in place
// through the product's B_T flag. Each dW sums `splits` fixed row chunks
// into f32 partials (scratch) that sum_partials adds in order, so a result
// is the same on every run; the caller picks the splits to fill the card and
// keep each chunk's f32 sum short. Bound by bytes: reading dgates, inp and h
// once and writing gup takes 0.16-0.22 ms a layer at B = 1024, C = H = 96,
// over the 0.07-0.11 ms of its multiply-adds on the bf16 tensor cores; the
// products load their tiles synchronously (vit_common.cuh) and read dgates
// three or four times, so they reach neither bound.

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
  const int chunks = (M + kchunk - 1) / kchunk;
  const dim3 grid((K2 + vit::kBN - 1) / vit::kBN, (K1 + vit::kBM - 1) / vit::kBM, chunks);
  const vit::EpiPartial epi{scratch, K2, n};
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    vit::gemm_tc<true, false, vit::EpiPartial>
        <<<grid, vit::kGemmThreads, 0, st>>>(a, K1, b, K2, K1, K2, M, kchunk, epi);
  else
    vit::gemm<T, T, true, false, vit::EpiPartial>
        <<<grid, vit::kGemmThreads, 0, st>>>(a, K1, b, K2, K1, K2, M, kchunk, epi);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return vit::launch_sum_partials(scratch, out, chunks, (long long)n, (long long)n, st);
}

template <typename T>
int layer_products(const T* dgates, const T* inp, int in, const T* h, const T* w_ih, int chain,
                   void* out, float* dw_ih, float* dw_hh, float* db, float* scratch,
                   int splits_ih, int splits_hh, int Tn, int B, int H, cudaStream_t st) {
  const int G = 4 * H, M = Tn * B;
  CEREBRA_VIT_RC(contract<T>(inp, in, dgates, G, M, dw_ih, scratch, splits_ih, st));
  CEREBRA_VIT_RC(
      contract<T>(h, H, dgates + (size_t)B * G, G, M - B, dw_hh, scratch, splits_hh, st));
  CEREBRA_VIT_RC(vit::column_sum<T>(dgates, nullptr, 1, db, M, G, scratch, st));
  if (chain == 1)
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, true>(dgates, G, w_ih, G, M, in, G,
                                                          vit::EpiF32{(float*)out, in}, st));
  else if (chain == 2)
    CEREBRA_VIT_CHECK(vit::launch_gemm<T, T, false, true>(
        dgates, G, w_ih, G, M, in, G, vit::EpiBiasRound<T>{nullptr, (T*)out, in}, st));
  return 0;
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

// K2/K2g, one layer's reverse scan: dgates (Tn, B, 4H) from the layer's
// prefac and qf (contiguous slices of the stacked streams), its w_hhT
// (4H, H) and the cotangent g of its h, in the stream dtype (g_f32 == 0) or
// f32, (B, H) reaching step Tn-1 only (g_last != 0) or (Tn, B, H).
int cerebra_stack_scan_bwd(int bf16, int g_f32, int g_last, int bt, const void* prefac,
                           const void* qf, const void* g, const void* w_hhT, void* dgates,
                           int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    if (!bf16)
      return launch_scan_bwd<float, float, BT>(prefac, qf, g, g_last, w_hhT, dgates, Tn, B, H, s);
    return g_f32 ? launch_scan_bwd<__nv_bfloat16, float, BT>(prefac, qf, g, g_last, w_hhT,
                                                              dgates, Tn, B, H, s)
                 : launch_scan_bwd<__nv_bfloat16, __nv_bfloat16, BT>(prefac, qf, g, g_last, w_hhT,
                                                                      dgates, Tn, B, H, s);
  });
}

// K2/K2g, one layer's products (layer_products) after its scan: inp (Tn, B,
// in) is x or the layer below's h, h (Tn, B, H) the layer's own h, w_ih
// (in, 4H); dW_ih, dW_hh and db are f32 outputs; chain 0 none, 1 gup (f32),
// 2 dx (stream dtype) into out. scratch: max(splits_ih * in, splits_hh * H,
// 32) * 4H floats.
int cerebra_stack_bwd_products(int bf16, const void* dgates, const void* inp, int in,
                               const void* h, const void* w_ih, int chain, void* out,
                               void* dw_ih, void* dw_hh, void* db, void* scratch, int splits_ih,
                               int splits_hh, int Tn, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    return layer_products<T>((const T*)dgates, (const T*)inp, in, (const T*)h, (const T*)w_ih,
                             chain, out, (float*)dw_ih, (float*)dw_hh, (float*)db,
                             (float*)scratch, splits_ih, splits_hh, Tn, B, H, s);
  }
  return layer_products<float>((const float*)dgates, (const float*)inp, in, (const float*)h,
                               (const float*)w_ih, chain, out, (float*)dw_ih, (float*)dw_hh,
                               (float*)db, (float*)scratch, splits_ih, splits_hh, Tn, B, H, s);
}

// K11: g (Tn, B, H); h_all, c_all from K10; the weights as the forward takes
// them (recompute) and transposed (chain, dx always).
int cerebra_lstm_bwd_rc(int bf16, int bt, const void* g, const void* x, const void* h_all,
                        const void* c_all, const void* w_ih0, const void* w_ihr,
                        const void* w_hh, const void* bias, const void* w_ihT0,
                        const void* w_ihT_r, const void* w_hhT, void* dx, void* part, int Tn,
                        int B, int C, int H, int L, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return with_tile(bt, [&](auto tile) {
    constexpr int BT = decltype(tile)::value;
    return bf16 ? launch_bwd_rc<__nv_bfloat16, BT>(g, x, h_all, c_all, w_ih0, w_ihr, w_hh, bias,
                                                   w_ihT0, w_ihT_r, w_hhT, dx, part, Tn, B, C,
                                                   H, L, s)
                : launch_bwd_rc<float, BT>(g, x, h_all, c_all, w_ih0, w_ihr, w_hh, bias, w_ihT0,
                                           w_ihT_r, w_hhT, dx, part, Tn, B, C, H, L, s);
  });
}

int cerebra_reduce_partials(const void* part, void* out, int n_blk, long long n,
                            void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  reduce_partials<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, n_blk, n);
  return (int)cudaGetLastError();
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
