// What the LSTM kernels that run on thread-block clusters share
// (lstm_stack.cu: the cluster scans and the wavefront forward; lstm_scan.cu:
// the scan's wavefront forward): the launch of a grid of clusters after the
// card's occupancy check, the 16-row tile and 4-slot ring of the wavefront
// kernels, and the handshake across a cluster on mbarriers in shared memory
// (mapa, mbarrier arrive / expect_tx / try_wait, st.async), with a watchdog
// that turns a handshake that never completes into a launch error.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

// the launch of `tiles` clusters of N CTAs of nthr threads and `smem` bytes
// of dynamic shared memory each on `stream`; attr is the one attribute it
// names, the cluster's size
inline cudaLaunchConfig_t cluster_config(int N, int tiles, int nthr, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * tiles);
  cfg.blockDim = dim3(nthr);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// kern's shared-memory and cluster-size attributes for `smem` bytes and N
// CTAs a cluster, then the clusters the card holds at once (into *clusters)
template <typename... KArgs>
cudaError_t cluster_occupancy(void (*kern)(KArgs...), int N, int nthr, size_t smem,
                              int* clusters) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && N > 8)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(N, 1, nthr, smem, 0, attr);
  *clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(clusters, (const void*)kern, &cfg);
  return e;
}

// Launch kern on `stream` in `tiles` clusters of N CTAs of nthr threads and
// `smem` bytes of dynamic shared memory each; a cluster the card cannot
// place (too large, too much shared memory) is refused before the launch.
// Returns the first CUDA error, else 0.
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kern)(KArgs...), int N, int tiles, int nthr, size_t smem,
                    cudaStream_t stream, Args... args) {
  int clusters = 0;
  cudaError_t e = cluster_occupancy(kern, N, nthr, smem, &clusters);
  if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(N, tiles, nthr, smem, stream, attr);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error behind for the next one
    return (int)e;
  }
  return (int)cudaGetLastError();
}

constexpr int kWaveRows = 16;  // batch rows of one row tile (an mma.sync's m16)
constexpr int kWaveRing = 4;   // slots of an input ring (a layer's inputs; the scan's x_proj)
constexpr int kWaveThreads = 384;  // 4U threads (U/8 warps), U <= 96: at most 170 registers a thread

// ---- the handshake across a cluster (mbarriers in shared memory): between
// neighbouring layers, and between the two halves of a split layer
// the address of p in CTA rank's shared memory
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(tc::smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void wave_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(tc::smem_addr(b)), "r"(count)
               : "memory");
}

// arrive on local barrier b, expecting `bytes` more to complete on it
__device__ __forceinline__ void wave_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(tc::smem_addr(b)), "r"(bytes) : "memory");
}

// arrive (release at cluster scope) on barrier b of CTA rank
__device__ __forceinline__ void wave_arrive_peer(uint64_t* b, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(peer_addr(b, rank)) : "memory");
}

// whether the phase of parity `parity` of local barrier b has completed
// (acquire at cluster scope), after a wait of the hardware's own length
__device__ __forceinline__ bool wave_try(uint64_t* b, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(tc::smem_addr(b)), "r"(parity) : "memory");
  return done != 0;
}

// cycles after which a wait traps (~10 s at 1.98 GHz): a handshake that
// never completes ends the launch with an error instead of holding the card
constexpr long long kWaveWatchdog = 20000000000LL;

// wait until the phase of parity `parity` of local barrier b has completed
__device__ __forceinline__ void wave_wait(uint64_t* b, int parity) {
  if (wave_try(b, parity)) return;
  const long long t0 = clock64();
  while (!wave_try(b, parity))
    if (clock64() - t0 > kWaveWatchdog) __trap();
}

// v into CTA rank's shared memory at p's offset, its 4 bytes completing on
// that CTA's barrier b
__device__ __forceinline__ void wave_store_peer(void* p, uint32_t v, uint64_t* b, int rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(peer_addr(p, rank)), "r"(v), "r"(peer_addr(b, rank)) : "memory");
}

// v into CTA rank's shared memory at p's offset (16-byte aligned), its 16
// bytes completing on that CTA's barrier b
__device__ __forceinline__ void wave_store_peer4(void* p, float4 v, uint64_t* b, int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n"
      :: "r"(peer_addr(p, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
         "r"(peer_addr(b, rank)) : "memory");
}

}  // namespace
