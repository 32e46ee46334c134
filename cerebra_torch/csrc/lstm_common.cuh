// Helpers shared by the LSTM kernels (lstm_stack.cu, lstm_scan.cu): stream-dtype
// conversions, the rounding of a float through the stream dtype, the block size, the
// column product over a batch tile held transposed in shared memory, and the
// per-element cell math of the forwards and the backwards, so that every kernel
// computes and rounds it in one place.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Threads per block: one per gate column up to this cap, above which each
// thread takes several columns. 1024 threads would leave 64 registers a
// thread, and the kernels use up to ~100 (ptxas -v on an H100 toolchain).
constexpr int MAX_THREADS = 512;

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

// the gate activations [σ(i), σ(f), tanh(g), σ(o)] of one row and unit from its
// pre-activations at gr[0], gr[gs], gr[2 gs], gr[3 gs]
__device__ __forceinline__ void activations(const float* gr, size_t gs, float (&a)[4]) {
  a[0] = sigmoid_f(gr[0]);
  a[1] = sigmoid_f(gr[gs]);
  a[2] = tanhf(gr[2 * gs]);
  a[3] = sigmoid_f(gr[3 * gs]);
}

// the backward's prefactors of one unit from its activations a, c_{t-1} and
// tanh c_t: p = [g·i(1−i), c_prev·f(1−f), i(1−g²), tanh c·o(1−o)]; returns
// q = o(1−tanh²c)
__device__ __forceinline__ float prefactors(const float (&a)[4], float c_prev, float tc,
                                            float (&p)[4]) {
  const float ig = a[0], fg = a[1], gg = a[2], og = a[3];
  p[0] = gg * (ig - ig * ig);
  p[1] = c_prev * (fg - fg * fg);
  p[2] = ig - gg * (ig * gg);
  p[3] = tc * (og - og * og);
  return og - og * tc * tc;
}

// One row and unit of a forward step: the f32 cell update from the
// pre-activations at gr[k * H] (c holds c_{t-1} in and c_t out), returning
// h_t. With pf and q non-null (K1, K13) it also stores the backward's
// residuals in the stream dtype: the prefactors at pf[k * H], q and f at
// q[0] and q[H].
template <typename T>
__device__ __forceinline__ float cell_step(const float* gr, int H, float& c, T* pf, T* q) {
  float a[4];
  activations(gr, H, a);
  const float c_prev = c;
  c = a[1] * c_prev + a[0] * a[2];
  const float tc = tanhf(c);
  if (pf != nullptr) {
    float p[4];
    const float qv = prefactors(a, c_prev, tc, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) pf[k * H] = from_f<T>(p[k]);
    q[0] = from_f<T>(qv);
    q[H] = from_f<T>(a[1]);
  }
  return a[3] * tc;
}

// One row and unit of a transcendental-free backward step (K11, K14; K2
// writes the same algebra out, see lstm_bwd_kernel): dc = dc_acc + dh·q, then
// the four gate gradients d = [dc·p_i, dc·p_f, dc·p_g, dh·p_o] as
// stream-dtype products of dc and dh rounded to the stream dtype and the
// prefactors p (as the caller rounded them); returns the next step's carry
// dc·f. dh already holds the cotangent of this step.
template <typename T>
__device__ __forceinline__ float gate_grads(float dh, float dc_acc, float q, float f,
                                            const float (&p)[4], float (&d)[4]) {
  const float dc = dc_acc + dh * q;
  const float dcn = rnd<T>(dc), dhn = rnd<T>(dh);
  d[0] = rnd<T>(dcn * p[0]);
  d[1] = rnd<T>(dcn * p[1]);
  d[2] = rnd<T>(dcn * p[2]);
  d[3] = rnd<T>(dhn * p[3]);
  return dc * f;
}

// one thread per gate column of 4H, capped at MAX_THREADS, in whole warps
inline int threads_for(int H) {
  const int t = (4 * H + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// calls launch(std::integral_constant<int, BT>()) for the batch tile bt in
// {1, 2, 4, 8, 16}, the tiles the kernels are built for
template <typename F>
int with_tile(int bt, F launch) {
  switch (bt) {
    case 1: return launch(std::integral_constant<int, 1>());
    case 2: return launch(std::integral_constant<int, 2>());
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
