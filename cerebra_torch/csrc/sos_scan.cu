// A cascade of biquads (second-order sections, direct form II transposed)
// run along the last axis of a (lanes, T) array: the counterpart of
// cerebra/signal/filters.py::_sos_scan, a lax.scan over time whose step
// updates every section of every lane.
//
// The recurrence is serial in t, so one thread owns one lane and steps
// through time with its sections' two-value states in registers. The
// coefficients come in the launch's parameter block (a constant bank every
// thread reads at once). Each warp owns 32 lanes and moves them through
// shared memory in 32 x 32 tiles: it loads a tile of 32 lanes x 32 steps
// with one coalesced row read a lane (the next tile's reads in flight while
// the current one runs), each thread runs its lane through the tile's steps
// in place, and the warp writes the tile back the same way.
// `reverse` walks the tiles and the steps in a tile from the end, so the
// backward pass of filtfilt needs no flipped copies; its initial state is
// scaled by the pass's first sample, the input's last.
//
// Plain C interface (ctypes); f32 and f64. y may be x (x and y are not
// __restrict__: each tile is read whole before any of it is written, and
// the next tile's reads are of other addresses).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 8;
constexpr int kTile = 32;        // steps a tile, and lanes a warp
constexpr int kWarps = 2;        // warps a block

template <typename T>
struct SosParams {
  T b0[kMaxSections], b1[kMaxSections], b2[kMaxSections];
  T a1[kMaxSections], a2[kMaxSections];
  T zi0[kMaxSections], zi1[kMaxSections];
};

template <typename T, int S>
__global__ void __launch_bounds__(32 * kWarps)
sos_scan_kernel(const T* x, T* y, const T* __restrict__ zscale,
                const SosParams<T> c, long long lanes, long long Tn, int reverse) {
  __shared__ T tiles[kWarps][kTile][kTile + 1];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const long long lane0 = ((long long)blockIdx.x * kWarps + w) * kTile;
  if (lane0 >= lanes) return;  // the whole warp leaves together
  const long long lane = lane0 + l;
  const bool live = lane < lanes;
  const int rows = (int)min((long long)kTile, lanes - lane0);
  T(*tile)[kTile + 1] = tiles[w];

  T z0[S], z1[S];
  const T sc = (zscale != nullptr && live) ? zscale[lane] : T(0);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    z0[s] = c.zi0[s] * sc;
    z1[s] = c.zi1[s] * sc;
  }

  // Tile k+1's 32 row reads are issued before tile k's steps run, so their
  // latency hides behind the recurrence: each thread holds its column of
  // the next tile in registers until the current tile is written back.
  const long long ntiles = (Tn + kTile - 1) / kTile;
  auto tile_start = [&](long long k) { return (reverse ? ntiles - 1 - k : k) * kTile; };
  T next[kTile];
  auto load = [&](long long t0) {
    const int n = (int)min((long long)kTile, Tn - t0);
#pragma unroll
    for (int r = 0; r < kTile; ++r)  // row r: 32 consecutive steps of lane lane0 + r
      if (r < rows && l < n) next[r] = x[(lane0 + r) * Tn + t0 + l];
  };
  load(tile_start(0));
  for (long long k = 0; k < ntiles; ++k) {
    const long long t0 = tile_start(k);
    const int n = (int)min((long long)kTile, Tn - t0);
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (r < rows && l < n) tile[r][l] = next[r];
    __syncwarp();
    if (k + 1 < ntiles) load(tile_start(k + 1));
    if (live) {
      for (int i = 0; i < n; ++i) {
        const int j = reverse ? n - 1 - i : i;
        T s_in = tile[l][j];
#pragma unroll
        for (int s = 0; s < S; ++s) {  // the step of filters.py:116-126, section by section
          const T yn = c.b0[s] * s_in + z0[s];
          z0[s] = c.b1[s] * s_in - c.a1[s] * yn + z1[s];
          z1[s] = c.b2[s] * s_in - c.a2[s] * yn;
          s_in = yn;
        }
        tile[l][j] = s_in;
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kTile; ++r)
      if (r < rows && l < n) y[(lane0 + r) * Tn + t0 + l] = tile[r][l];
    __syncwarp();
  }
}

template <typename T>
int launch(int S, int reverse, const void* x, void* y, const void* zscale, const double* sos,
           const double* zi, long long lanes, long long Tn, cudaStream_t stream) {
  SosParams<T> c{};
  for (int s = 0; s < S; ++s) {  // rows [b0 b1 b2 a0 a1 a2], a0 == 1
    c.b0[s] = (T)sos[6 * s + 0];
    c.b1[s] = (T)sos[6 * s + 1];
    c.b2[s] = (T)sos[6 * s + 2];
    c.a1[s] = (T)sos[6 * s + 4];
    c.a2[s] = (T)sos[6 * s + 5];
    c.zi0[s] = zi != nullptr ? (T)zi[2 * s + 0] : T(0);
    c.zi1[s] = zi != nullptr ? (T)zi[2 * s + 1] : T(0);
  }
  const long long warps = (lanes + kTile - 1) / kTile;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps)), block(32 * kWarps);
  const T* xp = (const T*)x;
  T* yp = (T*)y;
  const T* zp = zi != nullptr ? (const T*)zscale : nullptr;
  switch (S) {
#define CEREBRA_SOS_CASE(n) \
  case n: sos_scan_kernel<T, n><<<grid, block, 0, stream>>>(xp, yp, zp, c, lanes, Tn, reverse); break;
    CEREBRA_SOS_CASE(1) CEREBRA_SOS_CASE(2) CEREBRA_SOS_CASE(3) CEREBRA_SOS_CASE(4)
    CEREBRA_SOS_CASE(5) CEREBRA_SOS_CASE(6) CEREBRA_SOS_CASE(7) CEREBRA_SOS_CASE(8)
#undef CEREBRA_SOS_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y = the S-section cascade `sos` (S x 6 doubles, host memory, rows
// [b0 b1 b2 a0 a1 a2]) run over each of `lanes` contiguous rows of Tn
// samples of x, forward or (reverse != 0) from the last sample back. zi
// (S x 2 doubles, host) times zscale[lane] is each lane's initial state;
// zi == nullptr starts from zero (zscale unread). y may be x. f64 != 0:
// double, else float; coefficients are rounded to that type.
int cerebra_sos_scan(int f64, int reverse, const void* x, void* y, const void* zscale,
                     const double* sos, const double* zi, int S, long long lanes, long long Tn,
                     void* stream) {
  if (S < 1 || S > kMaxSections || lanes < 1 || Tn < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch<double>(S, reverse, x, y, zscale, sos, zi, lanes, Tn, s)
             : launch<float>(S, reverse, x, y, zscale, sos, zi, lanes, Tn, s);
}

const char* cerebra_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
