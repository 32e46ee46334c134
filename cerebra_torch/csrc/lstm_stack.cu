// Whole-stack LSTM kernels for Hopper (sm_90a): the CUDA counterparts of the
// three Pallas kernels in cerebra/models/pallas_lstm_stack.py that the
// LSTM->DINOv2 trainer runs.
//
//   lstm_fwd_kernel<T, BT, TRAIN=true>   replaces _fwd_train_kernel      (K1)
//   lstm_fwd_kernel<T, BT, TRAIN=false>  replaces _fwd_infer_last_kernel (K3)
//   lstm_bwd_kernel<T, BT>               replaces _bwd_kernel            (K2,
//                                        need_dx=False, g_last_only=True)
//   reduce_partials                      replaces K2's accumulation of dW
//                                        across the sequential TPU grid
//
// Layouts (all row-major, T = stream dtype, float or __nv_bfloat16):
//   x (Tn, B, C); w_ih0 (C, 4H); w_ihr (L-1, H, 4H); w_hh (L, H, 4H);
//   bias (L, 4H); h_all (L, Tn, B, H); prefac (L, Tn, B, 4H);
//   qf (L, Tn, B, 2H); h_last (B, H); g (B, H);
//   w_ihT_r (L-1, 4H, H) and w_hhT (L, 4H, H) are the transposes the
//   backward's chain products read; gate order [i, f, g, o].
//
// What bounds them on an H100: the recurrence is serial over Tn = 460 steps.
// Per step and layer a batch tile of BT rows needs (in + H) * 4H * BT
// multiply-adds (in = C or H) and reads the layer's whole weights (~72 K
// values, from L2: the 2-layer bf16 stack is 288 KiB, more than one block's
// 227 KB of shared memory), so a step costs microseconds of issue and
// latency, not bandwidth or FLOPs. The design: one block per batch tile
// loops over time and layers itself (the TPU's sequential grid becomes the
// in-block loop) and keeps every layer's carry in shared memory, so the
// layers hand over h_t without touching device memory. Each of the 4H
// threads owns one gate column: it reads that column's weights coalesced
// and applies each to all BT rows, which shared memory holds transposed
// ([k][row]) so one vector load fetches a value for every row. The wrapper
// picks BT per direction from timings on the card (lstm_stack.py
// pick_tile). Tensor cores (wgmma), TMA and clusters are later work.
//
// Rounding points follow the Pallas kernels: matmul operands in the stream
// dtype with f32 accumulation, bias cast to f32, h cast to the stream dtype
// before W_hh and before it feeds the next layer, residual streams stored in
// the stream dtype; the backward's dgates are stream-dtype products of the
// f32 accumulators rounded to the stream dtype.
//
// The kernels allocate nothing and do not synchronise; the C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// the value a float takes after a round trip through the stream dtype
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

// v[r] = p[r] for the BT rows of one transposed shared-memory entry
template <int BT>
__device__ __forceinline__ void rows(const float* p, float (&v)[BT]) {
  if constexpr (BT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < BT / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (BT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int r = 0; r < BT; ++r) v[r] = p[r];
  }
}

// acc[r] += sum_k m[k * stride + j] * rows(s + k * BT)[r], k = 0 .. n-1
template <typename T, int BT>
__device__ __forceinline__ void col_dot(float (&acc)[BT], const T* __restrict__ m,
                                        const float* s, int n, int stride, int j) {
#pragma unroll 16
  for (int k = 0; k < n; ++k) {
    const float w = to_f<T>(m[(size_t)k * stride + j]);
    float v[BT];
    rows<BT>(s + k * BT, v);
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = fmaf(v[r], w, acc[r]);
  }
}

// ---------------------------------------------------------------- forward
// Replaces cerebra/models/pallas_lstm_stack.py:_fwd_train_kernel (TRAIN)
// and :_fwd_infer_last_kernel. Bound by latency: each of the Tn serial steps
// reads every layer's weights from L2 for (in + H) * 4H * BT multiply-adds
// per layer, with two barriers per layer-step; the carries never leave
// shared memory, and BT = 8 rows share each weight read.
// K1 (TRAIN) streams h_all, prefac and qf for every layer and step; K3 only
// writes the top layer's h at Tn-1. Shared memory (floats):
//   c_s (L, BT, H) f32 cell | hr_s (L, H, BT) h in the stream dtype, which
//   is both the layer's recurrent operand and the next layer's input |
//   x_s (C, BT) | gates_s (BT, 4H)
template <typename T, int BT, bool TRAIN>
__global__ void lstm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_ih0,
                                const T* __restrict__ w_ihr, const T* __restrict__ w_hh,
                                const T* __restrict__ bias, T* __restrict__ h_all,
                                T* __restrict__ prefac, T* __restrict__ qf,
                                T* __restrict__ h_last, int Tn, int B, int C, int H, int L) {
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
      const int in = l == 0 ? C : H;
      const T* wi = l == 0 ? w_ih0 : w_ihr + (size_t)(l - 1) * H * G;
      const T* wh = w_hh + (size_t)l * H * G;
      const float* inp = l == 0 ? x_s : hr_s + (l - 1) * H * BT;
      float* hr = hr_s + l * H * BT;
      float* cl = c_s + l * BT * H;
      __syncthreads();  // this layer's input rows are in place

      // gates = inp @ w_ih + h @ w_hh + b: one thread per gate column
      for (int j = tid; j < G; j += nthr) {
        float ax[BT], ah[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) ax[r] = ah[r] = 0.0f;
        col_dot<T, BT>(ax, wi, inp, in, G, j);
        col_dot<T, BT>(ah, wh, hr, H, G, j);
        const float bj = to_f<T>(bias[(size_t)l * G + j]);
#pragma unroll
        for (int r = 0; r < BT; ++r) gates_s[r * G + j] = (ax[r] + ah[r]) + bj;
      }
      __syncthreads();  // gates complete; hr may be overwritten

      // f32 cell math and the backward's derivative prefactors
      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, u = i - r * H, b = b0 + r;
        const float* gr = gates_s + r * G;
        const float ig = sigmoid_f(gr[u]);
        const float fg = sigmoid_f(gr[H + u]);
        const float gg = tanhf(gr[2 * H + u]);
        const float og = sigmoid_f(gr[3 * H + u]);
        const float c_prev = cl[i];
        const float igg = ig * gg;
        const float c_new = fg * c_prev + igg;
        const float tc = tanhf(c_new);
        const float h_new = og * tc;
        cl[i] = c_new;
        hr[u * BT + r] = rnd<T>(h_new);
        if (b < B) {
          if (TRAIN) {
            const size_t row = ((size_t)l * Tn + t) * B + b;
            h_all[row * H + u] = from_f<T>(h_new);
            T* pf = prefac + row * G;
            pf[u] = from_f<T>(gg * (ig - ig * ig));
            pf[H + u] = from_f<T>(c_prev * (fg - fg * fg));
            pf[2 * H + u] = from_f<T>(ig - gg * igg);
            pf[3 * H + u] = from_f<T>(tc * (og - og * og));
            T* q = qf + row * 2 * H;
            q[u] = from_f<T>(og - og * tc * tc);
            q[H + u] = from_f<T>(fg);
          } else if (l == L - 1 && t == Tn - 1) {
            h_last[(size_t)b * H + u] = from_f<T>(h_new);
          }
        }
      }
    }
  }
}

// --------------------------------------------------------------- backward
// Replaces cerebra/models/pallas_lstm_stack.py:_bwd_kernel with need_dx=False
// and g_last_only=True. Bound by latency: per serial step and layer a tile
// reads both transposed weights from L2 for the chain products (which only
// H of the 4H threads compute) and read-modify-writes its (in + H) * 4H f32
// partial in device memory. dh and dc stay in shared memory; the wrapper
// picks BT near B / 16, which balances a block's time against the number
// of partials.
// Reverse time, top layer first. Each block owns one f32 partial of every
// dW/db (n_part floats at part + blockIdx.x * n_part, laid out as
// [dW_ih0 (C, 4H) | dW_ihr (L-1, H, 4H) | dW_hh (L, H, 4H) | db (L, 4H)]),
// read-modified-written only by the thread of that gate column: no atomics.
// Shared memory (floats):
//   dh_s, dc_s (L, BT, H) | dg_s (4H, BT) | gup_s (BT, H) |
//   inp_s (max(C, H), BT) | hp_s (H, BT)
template <typename T, int BT>
__global__ void lstm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                const T* __restrict__ h_all, const T* __restrict__ prefac,
                                const T* __restrict__ qf, const T* __restrict__ w_ihT_r,
                                const T* __restrict__ w_hhT, float* __restrict__ part,
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

  for (size_t i = tid; i < n_part; i += nthr) mine[i] = 0.0f;
  for (int i = tid; i < 2 * L * BT * H; i += nthr) dh_s[i] = 0.0f;  // dh_s and dc_s
  for (int i = tid; i < BT * H; i += nthr) gup_s[i] = 0.0f;

  for (int t = Tn - 1; t >= 0; --t) {
    for (int l = L - 1; l >= 0; --l) {
      const int in = l == 0 ? C : H;
      float* dhl = dh_s + l * BT * H;
      float* dcl = dc_s + l * BT * H;
      __syncthreads();  // the layer above has written gup_s; dg_s is free

      // input rows of this layer at t (for dW_ih) and h at t-1 (for dW_hh)
      for (int i = tid; i < BT * in; i += nthr) {
        const int r = i / in, k = i - r * in, b = b0 + r;
        float v = 0.0f;
        if (b < B)
          v = l == 0 ? to_f<T>(x[((size_t)t * B + b) * C + k])
                     : to_f<T>(h_all[(((size_t)(l - 1) * Tn + t) * B + b) * H + k]);
        inp_s[k * BT + r] = v;
      }
      // transcendental-free gate gradients from the saved prefactors
      for (int i = tid; i < BT * H; i += nthr) {
        const int r = i / H, u = i - r * H, b = b0 + r;
        if (b >= B) {
          hp_s[u * BT + r] = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) dg_s[(q * H + u) * BT + r] = 0.0f;
          continue;
        }
        hp_s[u * BT + r] =
            t > 0 ? to_f<T>(h_all[(((size_t)l * Tn + t - 1) * B + b) * H + u]) : 0.0f;
        // the head's cotangent reaches the top layer at Tn-1 only
        const float g_up =
            l == L - 1 ? (t == Tn - 1 ? to_f<T>(g[(size_t)b * H + u]) : 0.0f) : gup_s[i];
        const size_t row = ((size_t)l * Tn + t) * B + b;
        const T* q = qf + row * 2 * H;
        const T* pf = prefac + row * G;
        const float dh = dhl[i] + g_up;
        const float dc = dcl[i] + dh * to_f<T>(q[u]);
        const float dcn = rnd<T>(dc), dhn = rnd<T>(dh);
        dg_s[u * BT + r] = rnd<T>(dcn * to_f<T>(pf[u]));
        dg_s[(H + u) * BT + r] = rnd<T>(dcn * to_f<T>(pf[H + u]));
        dg_s[(2 * H + u) * BT + r] = rnd<T>(dcn * to_f<T>(pf[2 * H + u]));
        dg_s[(3 * H + u) * BT + r] = rnd<T>(dhn * to_f<T>(pf[3 * H + u]));
        dcl[i] = dc * to_f<T>(q[H + u]);
      }
      __syncthreads();  // dg_s, inp_s, hp_s complete

      // this block's partial dW_ih, dW_hh, db: one thread per gate column
      float* p_ih = l == 0 ? mine : mine + (size_t)G * (C + (l - 1) * H);
      float* p_hhl = p_hh + (size_t)l * H * G;
      for (int j = tid; j < G; j += nthr) {
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
          p_hhl[(size_t)k * G + j] += s;
        }
        p_b[(size_t)l * G + j] += sb;
      }

      // recurrent carry dh = dgates @ w_hh^T, and the chain to the layer
      // below g_up = dgates @ w_ih^T (none for layer 0: the input is data);
      // one thread per output unit k and all BT rows
      const T* whT = w_hhT + (size_t)l * G * H;
      const T* wiT = l > 0 ? w_ihT_r + (size_t)(l - 1) * G * H : nullptr;
      for (int k = tid; k < H; k += nthr) {
        float sh[BT], su[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) sh[r] = su[r] = 0.0f;
        col_dot<T, BT>(sh, whT, dg_s, G, H, k);
        if (wiT) col_dot<T, BT>(su, wiT, dg_s, G, H, k);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          dhl[r * H + k] = sh[r];
          if (wiT) gup_s[r * H + k] = su[r];
        }
      }
    }
  }
}

// Replaces the accumulation of dW across the TPU's sequential grid
// (pallas_lstm_stack.py:_bwd_kernel, dwih_ref/dwhh_ref/db_ref +=). Bound by
// reading the partials once (n_blk * n floats), coalesced over i.
// out[i] = sum over blocks of part[blk, i], in block order: deterministic
__global__ void reduce_partials(const float* __restrict__ part, float* __restrict__ out,
                                int n_blk, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < n_blk; ++b) s += part[(size_t)b * n + i];
  out[i] = s;
}

int threads_for(int H) {
  const int t = (4 * H + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}

template <typename T, int BT, bool TRAIN>
int launch_fwd(const void* x, const void* w_ih0, const void* w_ihr, const void* w_hh,
               const void* bias, void* h_all, void* prefac, void* qf, void* h_last, int Tn,
               int B, int C, int H, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * L * BT * H + C * BT + BT * 4 * H);
  auto kern = lstm_fwd_kernel<T, BT, TRAIN>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_blk = (B + BT - 1) / BT;
  kern<<<n_blk, threads_for(H), smem, stream>>>(
      (const T*)x, (const T*)w_ih0, (const T*)w_ihr, (const T*)w_hh, (const T*)bias,
      (T*)h_all, (T*)prefac, (T*)qf, (T*)h_last, Tn, B, C, H, L);
  return (int)cudaGetLastError();
}

template <typename T, int BT>
int launch_bwd(const void* g, const void* x, const void* h_all, const void* prefac,
               const void* qf, const void* w_ihT_r, const void* w_hhT, void* part, int Tn,
               int B, int C, int H, int L, cudaStream_t stream) {
  const int IN = C > H ? C : H;
  const size_t smem =
      sizeof(float) * ((size_t)2 * L * BT * H + 4 * H * BT + BT * H + IN * BT + H * BT);
  auto kern = lstm_bwd_kernel<T, BT>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_blk = (B + BT - 1) / BT;
  kern<<<n_blk, threads_for(H), smem, stream>>>(
      (const T*)g, (const T*)x, (const T*)h_all, (const T*)prefac, (const T*)qf,
      (const T*)w_ihT_r, (const T*)w_hhT, (float*)part, Tn, B, C, H, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(int train, int bt, const void* x, const void* w_ih0, const void* w_ihr,
                 const void* w_hh, const void* bias, void* h_all, void* prefac, void* qf,
                 void* h_last, int Tn, int B, int C, int H, int L, cudaStream_t s) {
#define CEREBRA_FWD(BT)                                                                  \
  if (bt == BT)                                                                          \
    return train ? launch_fwd<T, BT, true>(x, w_ih0, w_ihr, w_hh, bias, h_all, prefac, qf, \
                                           h_last, Tn, B, C, H, L, s)                    \
                 : launch_fwd<T, BT, false>(x, w_ih0, w_ihr, w_hh, bias, h_all, prefac,  \
                                            qf, h_last, Tn, B, C, H, L, s);
  CEREBRA_FWD(1)
  CEREBRA_FWD(2)
  CEREBRA_FWD(4)
  CEREBRA_FWD(8)
  CEREBRA_FWD(16)
#undef CEREBRA_FWD
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_bwd(int bt, const void* g, const void* x, const void* h_all, const void* prefac,
                 const void* qf, const void* w_ihT_r, const void* w_hhT, void* part, int Tn,
                 int B, int C, int H, int L, cudaStream_t s) {
#define CEREBRA_BWD(BT) \
  if (bt == BT)         \
    return launch_bwd<T, BT>(g, x, h_all, prefac, qf, w_ihT_r, w_hhT, part, Tn, B, C, H, L, s);
  CEREBRA_BWD(1)
  CEREBRA_BWD(2)
  CEREBRA_BWD(4)
  CEREBRA_BWD(8)
  CEREBRA_BWD(16)
#undef CEREBRA_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// train != 0: K1 (h_all, prefac, qf); train == 0: K3 (h_last).
// bf16 != 0: __nv_bfloat16 streams, else float. bt in {1, 2, 4, 8, 16}.
int cerebra_lstm_fwd(int train, int bf16, int bt, const void* x, const void* w_ih0,
                     const void* w_ihr, const void* w_hh, const void* bias, void* h_all,
                     void* prefac, void* qf, void* h_last, int Tn, int B, int C, int H, int L,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_fwd<__nv_bfloat16>(train, bt, x, w_ih0, w_ihr, w_hh, bias, h_all, prefac,
                                       qf, h_last, Tn, B, C, H, L, s);
  return dispatch_fwd<float>(train, bt, x, w_ih0, w_ihr, w_hh, bias, h_all, prefac, qf, h_last,
                             Tn, B, C, H, L, s);
}

int cerebra_lstm_bwd(int bf16, int bt, const void* g, const void* x, const void* h_all,
                     const void* prefac, const void* qf, const void* w_ihT_r,
                     const void* w_hhT, void* part, int Tn, int B, int C, int H, int L,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch_bwd<__nv_bfloat16>(bt, g, x, h_all, prefac, qf, w_ihT_r, w_hhT, part, Tn,
                                       B, C, H, L, s);
  return dispatch_bwd<float>(bt, g, x, h_all, prefac, qf, w_ihT_r, w_hhT, part, Tn, B, C, H,
                             L, s);
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
