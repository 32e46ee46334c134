// Per-layer LSTM recurrence kernels for Hopper (sm_90a): the CUDA counterparts
// of the Pallas kernels in cerebra/models/pallas_lstm.py (lstm_scan_pallas),
// which run one layer over a precomputed input projection x_proj = x @ w_ih + b.
//
//   scan_fwd_kernel<T, BT, false> replaces _fwd_infer_kernel (K12)
//   scan_fwd_kernel<T, BT, true>  replaces _fwd_train_kernel (K13)
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
// w_hh (72 KiB in bf16 at H = 96, read from L2) and streams 4H (K12), 10H
// (K13) or 11H (K14) values a row, so a step costs latency, not bandwidth
// or FLOPs. The forwards' design is lstm_stack.cu's for one layer: one block
// per batch tile loops over time with its f32 carries in shared memory; each
// thread owns one gate column and applies each weight it reads to all BT
// rows, held transposed in shared memory. K14 is the shared reverse scan
// (lstm_common.cuh, with its own design notes). The per-element cell math
// comes from lstm_common.cuh: cell_step, as lstm_stack.cu's forwards, and
// gate_grads in the scan. Rounding points follow the Pallas kernels:
// gates = f32(x_proj_t) + (h rounded to the stream dtype) @ w_hh with f32
// accumulation, h's f32 carry kept unrounded; K14's dh/dc carries f32, its
// dgates stream-dtype products of the rounded carries and prefactors.
//
// The kernels allocate nothing and do not synchronise; the C entry points
// launch on the caller's stream and return cudaGetLastError().

#include "lstm_common.cuh"

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
