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
// What bounds it on an H100, and the design. The TPU kernel holds a row
// tile's whole (rows, F) intermediate in VMEM; a block has 227 KB of shared
// memory, so here the half-block is a chain of launches on one stream:
// LN rows -> fc1 + bias + GELU (gh, rounded to CD, in device memory) -> fc2
// + bias + scale + residual. The forward also leaves y = LN(x)*g+b and the
// row statistics for the backward. The TPU sums dW into constant-index
// blocks over its sequential grid; here every dW is a contraction over the
// M rows in 8 fixed chunks whose partials are added in order
// (`contract_rows`, vit_common.cuh): deterministic, no atomics. The backward
// recomputes h = y @ W1 + b1 in f32 as the TPU kernel does. Bound: the
// products (tensor cores in bf16, CUDA-core FMA in f32) and the (M, F)
// intermediates' trips through device memory.
//
// Rounding points follow the Pallas bodies: LN statistics in f32 with eps
// 1e-6; y, gh, dout*s and dh rounded to CD before they enter a product; f32
// accumulation; h, dh, db1, db2, dg, db kept in f32; the residual stream in
// SD. GELU is the exact erf form with erff (the TPU kernel's rational erf
// differs by at most 1.5e-7).

#include "vit_common.cuh"

namespace {

using namespace vit;

__device__ __forceinline__ float gelu_f(float h) {
  return 0.5f * h * (1.0f + erff(h / 1.41421356237309515f));
}

__device__ __forceinline__ float dgelu_f(float h) {
  return 0.5f * (1.0f + erff(h / 1.41421356237309515f)) +
         h * expf(-0.5f * h * h) * 0.398942280401432678f;
}

// gh (CD) = gelu(acc + b1); h (f32) = acc + b1 when h is not null
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
};

// dh (f32) = acc * gelu'(h); dhn (CD) = dh rounded
template <typename CD>
struct EpiDgelu {
  const float* h;
  float* dh;
  CD* dhn;
  int ld;
  __device__ void operator()(int i, int j, float acc) const {
    const size_t o = (size_t)i * ld + j;
    const float d = acc * dgelu_f(h[o]);
    dh[o] = d;
    dhn[o] = from_f<CD>(d);
  }
};

constexpr int kRowThreads = 256;  // 8 rows (warps) per block

int row_blocks(int M) { return (M + kRowThreads / 32 - 1) / (kRowThreads / 32); }

template <typename SD, typename CD>
int mlp_fwd(const SD* x, const float* s, const CD* g, const CD* b, const CD* w1, const CD* b1,
            const CD* w2, const CD* b2, CD* y, float* mu, float* rstd, CD* gh, SD* out, int M,
            int D, int F, cudaStream_t st) {
  CEREBRA_VIT_CHECK(ln_fwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, g, b, y, mu, rstd, M, D));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
      y, D, w1, F, M, F, D, EpiGelu<CD>{b1, gh, nullptr, F}, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
      gh, F, w2, D, M, D, F, EpiResidual<SD, CD>{x, b2, s, 1, out, D}, st));
  return 0;
}

template <typename SD, typename CD>
int mlp_bwd(const SD* x, const SD* dout, const float* s, const CD* g, const CD* w1, const CD* b1,
            const CD* w2, const CD* y, const float* mu, const float* rstd, float* h, CD* gh,
            CD* dn, float* dh, CD* dhn, float* dy, float* scratch, SD* dx, float* dg, float* db,
            float* dw1,
            float* db1, float* dw2, float* db2, int M, int D, int F, cudaStream_t st) {
  const long long MD = (long long)M * D;
  // recompute h = y @ W1 + b1 (f32) and gh = gelu(h) (CD)
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, false>(
      y, D, w1, F, M, F, D, EpiGelu<CD>{b1, gh, h, F}, st));
  // the branch cotangent dout * s, in CD; db2 = sum of dout * s in f32
  CEREBRA_VIT_CHECK(scale_round<SD, CD><<<(unsigned)((MD + 255) / 256), 256, 0, st>>>(
      dout, s, 1, dn, MD, D));
  CEREBRA_VIT_RC(column_sum<SD>(dout, s, 1, db2, M, D, scratch, st));
  // fc2: dW2 = gh^T dn (F, D); dh = (dn @ W2^T) * gelu'(h)
  CEREBRA_VIT_RC(contract_rows<CD>(gh, F, dn, D, M, dw2, scratch, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
      dn, D, w2, D, M, F, D, EpiDgelu<CD>{h, dh, dhn, F}, st));
  // fc1: db1 = sum dh; dW1 = y^T dhn (D, F); dy = dhn @ W1^T (M, D) f32
  CEREBRA_VIT_RC(column_sum<float>(dh, nullptr, 1, db1, M, F, scratch, st));
  CEREBRA_VIT_RC(contract_rows<CD>(y, D, dhn, F, M, dw1, scratch, st));
  CEREBRA_VIT_CHECK(launch_gemm<CD, CD, false, true>(
      dhn, F, w1, F, M, D, F, EpiF32{dy, D}, st));
  // LN affine and core backward
  CEREBRA_VIT_RC(ln_backward_cols<SD>(x, mu, rstd, dy, dg, db, M, D, scratch, st));
  CEREBRA_VIT_CHECK(ln_bwd_rows<SD, CD><<<row_blocks(M), kRowThreads, 0, st>>>(
      x, mu, rstd, dy, g, dout, dx, M, D));
  return 0;
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

// f32 scratch floats the backward needs for widths D and F.
long long cerebra_vit_mlp_scratch(int D, int F) {
  const long long sums = (long long)kColSplits * (F > 2 * D ? F : 2 * D);
  const long long dw = (long long)kRowSplits * D * F;
  return sums > dw ? sums : dw;
}

// Scratch: h (M, F) f32, gh (M, F) CD, dn (M, D) CD, dh (M, F) f32,
// dhn (M, F) CD, dy (M, D) f32, scratch (cerebra_vit_mlp_scratch) f32.
// Outputs: dx (M, D) SD and f32 dg, db (D), dw1 (D, F), db1 (F), dw2 (F, D),
// db2 (D).
int cerebra_vit_mlp_bwd(int sd_bf16, int cd_bf16, const void* x, const void* dout,
                        const float* s, const void* g, const void* w1, const void* b1,
                        const void* w2, const void* y, const float* mu, const float* rstd,
                        float* h, void* gh, void* dn, float* dh, void* dhn, float* dy,
                        float* scratch, void* dx,
                        float* dg, float* db, float* dw1, float* db1, float* dw2, float* db2,
                        int M, int D, int F, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  CEREBRA_DISPATCH(sd_bf16, cd_bf16,
                   (mlp_bwd<SD, CD>((const SD*)x, (const SD*)dout, s, (const CD*)g,
                                    (const CD*)w1, (const CD*)b1, (const CD*)w2, (const CD*)y,
                                    mu, rstd, h, (CD*)gh, (CD*)dn, dh, (CD*)dhn, dy, scratch,
                                    (SD*)dx, dg, db, dw1, db1, dw2, db2, M, D, F, st)));
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
