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

// One row and unit of a forward step from its pre-activations at gr[k * gs]:
// the f32 cell update (c holds c_{t-1} in and c_t out), returning h_t; with
// RES also the backward's residuals in f32, r = [the four prefactors, q, f].
template <bool RES>
__device__ __forceinline__ float cell_update(const float* gr, size_t gs, float& c,
                                             float (&r)[6]) {
  float a[4];
  activations(gr, gs, a);
  const float c_prev = c;
  c = a[1] * c_prev + a[0] * a[2];
  const float tc = tanhf(c);
  if constexpr (RES) {
    float p[4];
    r[4] = prefactors(a, c_prev, tc, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = p[k];
    r[5] = a[1];
  }
  return a[3] * tc;
}

// cell_update, with pf and q non-null (K1, K13) storing the residuals in the
// stream dtype: the prefactors at pf[k * H], q and f at q[0] and q[H].
template <typename T>
__device__ __forceinline__ float cell_step(const float* gr, size_t gs, int H, float& c, T* pf,
                                           T* q) {
  float r[6];
  if (pf == nullptr) return cell_update<false>(gr, gs, c, r);
  const float h = cell_update<true>(gr, gs, c, r);
#pragma unroll
  for (int k = 0; k < 4; ++k) pf[k * H] = from_f<T>(r[k]);
  q[0] = from_f<T>(r[4]);
  q[H] = from_f<T>(r[5]);
  return h;
}

// cell_step with the pre-activations H apart, as the gates of a row lie
template <typename T>
__device__ __forceinline__ float cell_step(const float* gr, int H, float& c, T* pf, T* q) {
  return cell_step<T>(gr, (size_t)H, H, c, pf, q);
}

// One row and unit of a backward step (the reverse scan below, which
// K2/K2g, K11 and K14 run): dc = dc_acc + dh·q, then
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

// ------------------------------------------------------ the reverse scan
// One layer's reverse-time backward over its residuals, emitting the dgates
// stream. K14 (lstm_scan.cu) runs it on the caller's cotangent; K2/K2g
// (lstm_stack.cu) once per layer, top layer first, with the products of each
// layer (dW, the chain below, dx) left to tensor-core kernels over all Tn·B
// rows afterwards; K11 (lstm_stack.cu) once per layer and time chunk (RC),
// forming the residuals from the gates it recomputed for the chunk and
// carrying dh_acc and dc from one chunk to the next. Per step t, from Tn-1
// down to 0:
//   dh = dh_acc + g_t    dc = dc_acc + dh·q
//   dgates_t = [dc·p_i, dc·p_f, dc·p_g, dh·p_o]   (gate_grads; to dgates)
//   dh_acc = dgates_t @ w_hhᵀ                      dc_acc = dc·f
// with f32 carries that start at zero (or at K11's carry), dgates
// stream-dtype products of the rounded dc, dh and the rounded prefactors,
// and dh_acc an f32 sum of exact
// products of the stream-dtype dgates and w_hh (pallas_lstm_stack.py
// _bwd_kernel :282-300, pallas_lstm.py _bwd_kernel).
//
// What bounds it on an H100: Tn serial steps, each a (BT, 4H) x (4H, H)
// product and a few loads a row of prefac, qf and g, so latency. The design:
// w_hhᵀ (4H x H, 72 KiB in bf16 at H = 96) is copied into shared memory once
// where it fits beside the carries, else read through L2; dh_acc's 4H-long
// sum is split by gate over 4H threads (item (q, k) sums gate q's H terms
// for hidden unit k), and dh adds the four partials in the order q = 0..3,
// so the result is the same on every run; while step t multiplies, the
// block asks L2 for step t-1's rows of prefac, qf and g. Where w_hhᵀ does not
// fit (H = 384: 1.18 MB in bf16, read whole at every step) the step is bound
// by the bytes a block keeps in flight from L2, so that path (VEC) reads 16
// bytes a load, eight loads ahead, for 16 / sizeof(T) hidden units, and also
// splits each gate's H terms into S ranges to use all threads: 4S partials,
// added in order.
//
// TG is the cotangent's type: the stream dtype T (the caller's g) or float
// (the unrounded chain from the layer above, pallas_lstm_stack.py :310-313).
// RC selects where a step's residuals come from: K1/K13's stored prefac and
// qf (false), or K11's f32 gates (Tn, B, 4H) and the stored c at t and t-1
// (Tn, B, H) each (true), from which the scan forms K11's own: the four
// prefactors rounded to T, q and f in f32 (pallas_lstm_stack.py :366-391).
// g_last != 0: g is (B, H) and reaches step Tn-1 only (K2's h[-1] head);
// else g is (Tn, B, H). Layouts: prefac (Tn, B, 4H), qf (Tn, B, 2H), w_hhT
// (4H, H), dgates (Tn, B, 4H), all row-major.
// carry: null (K2/K2g, K14: the carries start at zero and the scan stops
// after step 0's dgates), or an f32 (2, B, H) buffer [dh_acc | dc] that K11
// runs its time chunks through: read as the carries entering step Tn-1
// (dh_acc as partial 0 of its sum, the others zero) and overwritten with
// those leaving step 0 (dh_acc as its ordered sum of partials), so that a
// scan cut into chunks gives the dgates of one launch over all steps, bit
// for bit.
// Shared memory: [w_s (4H, H) in T, when w_smem] | part_s (4S, BT, H) |
// dc_s (BT, H) | dg_s (4H, BT), floats after w_s.

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory one H100 block may use

// floats that w_hhᵀ takes at the head of the scan's shared memory
template <typename T> __host__ __device__ inline size_t scan_w_floats(int H) {
  return ((size_t)4 * H * H * sizeof(T) + 15) / 16 * 4;
}

// bytes of part_s, dc_s and dg_s for S ranges a gate
inline size_t scan_bwd_base_smem(int BT, int H, int S) {
  return sizeof(float) * (size_t)(4 * S + 5) * BT * H;
}

// the 16 / sizeof(T) stream-dtype values of one 16-byte load, as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// dst[i] = src[i], i < n, by the whole block: 16 bytes a thread where aligned
template <typename T>
__device__ __forceinline__ void block_copy(T* dst, const T* __restrict__ src, size_t n) {
  const size_t bytes = n * sizeof(T);
  if (((uintptr_t)src & 15) == 0 && bytes % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// ask L2 for the bytes [p, p + bytes), one 128-byte line a thread
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = (size_t)threadIdx.x * 128; o < bytes; o += (size_t)blockDim.x * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

// part_s[q S + s][r][k .. k + V) = sum over u in range s of gate q of
// dg_s[q H + u][r] * w_hhT[q H + u][k .. k + V), for every item (q, s, k / V)
// of the block, w_hhT read from device memory (L2) 16 bytes a load
template <typename T, int BT>
__device__ __forceinline__ void dh_partials_vec(float* part_s, const float* dg_s,
                                                const T* __restrict__ w_hhT, int H, int S) {
  constexpr int V = Vec<T>::V, AHEAD = 8;
  const size_t BH = (size_t)BT * H;
  const int KV = H / V, HS = (H + S - 1) / S;
  for (int j = threadIdx.x; j < 4 * S * KV; j += blockDim.x) {
    const int qs = j / KV, kv = j - qs * KV, q = qs / S;
    const int u0 = (qs - q * S) * HS, u1 = min(H, u0 + HS);
    const T* wr = w_hhT + (size_t)q * H * H + kv * V;
    const float* dr = dg_s + (size_t)q * H * BT;
    float acc[V][BT];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[c][r] = 0.0f;
    for (int u = u0; u < u1; u += AHEAD) {
      uint4 raw[AHEAD];
#pragma unroll
      for (int i = 0; i < AHEAD; ++i)
        if (u + i < u1) raw[i] = *reinterpret_cast<const uint4*>(wr + (size_t)(u + i) * H);
#pragma unroll
      for (int i = 0; i < AHEAD; ++i) {
        if (u + i >= u1) break;
        float w[V], d[BT];
        Vec<T>::unpack(raw[i], w);
        rows<BT>(dr + (u + i) * BT, d);
#pragma unroll
        for (int c = 0; c < V; ++c)
#pragma unroll
          for (int r = 0; r < BT; ++r) acc[c][r] = fmaf(d[r], w[c], acc[c][r]);
      }
    }
    float* out = part_s + qs * BH + kv * V;
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < BT; ++r) out[r * H + c] = acc[c][r];
  }
}

// dh_acc of one item: its NP partials at pp[0], pp[BH], ... added in order
__device__ __forceinline__ float dh_sum(const float* pp, int NP, size_t BH) {
  float s = pp[0];
  for (int p = 1; p < NP; ++p) s += pp[p * BH];
  return s;
}

// the residual streams a scan reads: prefac and qf, or (RC) gates, c, c_prev;
// the launch hands them to the kernel as __restrict__ parameters, which lets
// the loads take the read-only path (a struct's pointers would not)
template <typename T>
struct ScanRes {
  const T* prefac;
  const T* qf;
  const float* gates;
  const T* c;
  const T* c_prev;
};

template <typename T, typename TG, bool RC, int BT, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
    scan_bwd_kernel(const T* __restrict__ prefac, const T* __restrict__ qf,
                    const float* __restrict__ gates, const T* __restrict__ c,
                    const T* __restrict__ c_prev, const TG* __restrict__ g, int g_last,
                    const T* __restrict__ w_hhT, int w_smem, int S, float* carry,
                    T* __restrict__ dgates, int Tn, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  const int NP = 4 * S;              // partials of dh_acc, added in order
  const size_t BH = (size_t)BT * H;  // stride between two partials in part_s
  float* part_s = smem + (w_smem ? scan_w_floats<T>(H) : 0);
  float* dc_s = part_s + NP * BH;
  float* dg_s = dc_s + BH;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * BT;
  const int nb = B - b0 < BT ? B - b0 : BT;  // rows of this tile within the batch
  const T* w = w_hhT;
  if (w_smem) {
    block_copy(reinterpret_cast<T*>(smem), w_hhT, (size_t)G * H);
    w = reinterpret_cast<const T*>(smem);
  }
  for (size_t i = tid; i < (NP + 1) * BH; i += nthr) part_s[i] = 0.0f;  // part_s and dc_s
  if (carry != nullptr) {
    __syncthreads();  // zeroed
    for (int i = tid; i < BT * H; i += nthr) {
      const int b = b0 + i / H, u = i % H;
      if (b >= B) continue;
      part_s[i] = carry[(size_t)b * H + u];
      dc_s[i] = carry[((size_t)B + b) * H + u];
    }
  }

  for (int t = Tn - 1; t >= 0; --t) {
    __syncthreads();  // part_s holds step t+1's dh_acc partials; dg_s is free
    for (int i = tid; i < BT * H; i += nthr) {
      const int r = i / H, u = i - r * H, b = b0 + r;
      if (b >= B) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[(q * H + u) * BT + r] = 0.0f;
        continue;
      }
      const size_t row = (size_t)t * B + b;
      float gt = 0.0f;
      if (!g_last)
        gt = to_f<TG>(g[row * H + u]);
      else if (t == Tn - 1)
        gt = to_f<TG>(g[(size_t)b * H + u]);
      const float dh_acc = dh_sum(part_s + i, NP, BH);
      float p[4], d[4];
      // (each branch calls gate_grads itself: with q and f hoisted out of
      // the branch the compiler's code for one row a block ran slower on an
      // H100)
      if constexpr (RC) {
        float a[4];
        activations(gates + row * G + u, H, a);
        const float q = prefactors(a, to_f<T>(c_prev[row * H + u]),
                                   tanhf(to_f<T>(c[row * H + u])), p);
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = rnd<T>(p[k]);
        dc_s[i] = gate_grads<T>(dh_acc + gt, dc_s[i], q, a[1], p, d);
      } else {
        const T* q = qf + row * 2 * H + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] = to_f<T>(prefac[row * G + k * H + u]);
        dc_s[i] = gate_grads<T>(dh_acc + gt, dc_s[i], to_f<T>(q[0]), to_f<T>(q[H]), p, d);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dg_s[(k * H + u) * BT + r] = d[k];
        dgates[row * G + k * H + u] = from_f<T>(d[k]);
      }
    }
    __syncthreads();  // dg_s complete; part_s is free
    if (t == 0 && carry == nullptr) break;

    if (t > 0) {
      const size_t next = (size_t)(t - 1) * B + b0;  // step t-1's first row of this tile
      if constexpr (RC) {
        prefetch_l2(gates + next * G, (size_t)nb * G * sizeof(float));
        prefetch_l2(c + next * H, (size_t)nb * H * sizeof(T));
        prefetch_l2(c_prev + next * H, (size_t)nb * H * sizeof(T));
      } else {
        prefetch_l2(prefac + next * G, (size_t)nb * G * sizeof(T));
        prefetch_l2(qf + next * 2 * H, (size_t)nb * 2 * H * sizeof(T));
      }
      if (!g_last) prefetch_l2(g + next * H, (size_t)nb * H * sizeof(TG));
    }
    if constexpr (VEC) {
      dh_partials_vec<T, BT>(part_s, dg_s, w_hhT, H, S);
    } else {
      // part_s[q][r][k] = sum_u dg_s[q H + u][r] * w_hhT[q H + u][k]
      for (int j = tid; j < G; j += nthr) {
        const int q = j / H, k = j - q * H;
        float s[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) s[r] = 0.0f;
        col_dot<T, BT>(s, w + (size_t)q * H * H, dg_s + (size_t)q * H * BT, H, H, k);
#pragma unroll
        for (int r = 0; r < BT; ++r) part_s[q * BH + r * H + k] = s[r];
      }
    }
  }
  if (carry != nullptr) {
    __syncthreads();  // the carries leaving step 0 are complete
    for (int i = tid; i < BT * H; i += nthr) {
      const int b = b0 + i / H, u = i % H;
      if (b >= B) continue;
      carry[(size_t)b * H + u] = dh_sum(part_s + i, NP, BH);
      carry[((size_t)B + b) * H + u] = dc_s[i];
    }
  }
}

// Launch the scan on `stream`: w_hhᵀ goes to shared memory when it fits
// beside the carries of BT rows; else, where H is a multiple of 16 bytes'
// worth of values, the VEC path with as many ranges S a gate as fill the
// block's threads and fit in shared memory. Returns cudaGetLastError().
template <typename T, typename TG, bool RC, int BT>
int launch_scan_bwd(ScanRes<T> res, const void* g, int g_last, const void* w_hhT, void* carry,
                    void* dgates, int Tn, int B, int H, cudaStream_t stream) {
  constexpr int V = Vec<T>::V;
  const int nthr = threads_for(H);
  const size_t w_bytes = scan_w_floats<T>(H) * sizeof(float);
  const int w_smem = scan_bwd_base_smem(BT, H, 1) + w_bytes <= MAX_SMEM;
  const bool vec = !w_smem && H % V == 0;
  int S = 1;
  if (vec) {
    S = nthr / (4 * H / V);
    while (S > 1 && scan_bwd_base_smem(BT, H, S) > MAX_SMEM) --S;
    S = S > 1 ? S : 1;
  }
  const size_t smem = scan_bwd_base_smem(BT, H, S) + (w_smem ? w_bytes : 0);
  auto kern = vec ? scan_bwd_kernel<T, TG, RC, BT, true> : scan_bwd_kernel<T, TG, RC, BT, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(B + BT - 1) / BT, nthr, smem, stream>>>(res.prefac, res.qf, res.gates, res.c,
                                                  res.c_prev, (const TG*)g, g_last,
                                                  (const T*)w_hhT, w_smem, S, (float*)carry,
                                                  (T*)dgates, Tn, B, H);
  return (int)cudaGetLastError();
}

}  // namespace
