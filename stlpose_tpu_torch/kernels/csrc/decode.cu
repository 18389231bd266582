// K1: heatmap peak decode for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_decode.py::heatmap_peaks_pallas (kernel
// _decode_kernel, pallas_call at :74). Per (crop, joint) map of H*W f32
// values: the flat argmax (lowest index on ties), the max, (x, y) zeroed
// where the max is <= 0, and the +-0.25 px shift from the signs of the
// central differences, set only where 1 < p < size-1.
//
// Bound on the H100: reading the maps once, N*J*H*W*4 bytes at 3.35 TB/s
// (13.4 MB, 4.0 us at the serving shape 64x17x64x48). Covering HBM's
// latency at that rate takes megabytes in flight (Little's law); a warp per
// map with one scalar load per lane keeps ~128 bytes in flight per warp.
//
// peaks_bulk_kernel, for contiguous maps (unit column stride, row stride W,
//   map bytes a multiple of 16 and at most kMaxMapBytes, every map base
//   16-byte aligned; every map of the serving and training paths):
//   - thread 0 brings a whole map into shared memory with one 1-D bulk
//     asynchronous copy (cp.async.bulk, TMA's 1-D form) completed on an
//     mbarrier: every block has all its bytes in flight at once, and no
//     thread spends instructions on addresses;
//   - 128 threads a block, so that one block per map at 12 KB a map fits
//     the 1,088 maps of the serving path on the card in one wave;
//   - the threads reduce from shared memory with float4 reads (thread t
//     takes vectors t, t + 128, ...) and merge (value, index) pairs with
//     v > best || (v == best && i < best_i): inside a thread, across lanes
//     by shuffles, across warps through shared memory;
//   - the four neighbours are read from shared memory.
//   A persistent grid with a ring of map buffers (a later map's copy in
//   flight while one is reduced) measured slower: 1,088 maps barely
//   outnumber the blocks the card holds at once.
// peaks_strided_kernel, for any other strides (an NHWC-memory view, an
//   unaligned base): one warp per map, a loop over rows, then over columns
//   (no per-element division), the same merge, neighbours from global
//   memory. Not on a main path.
// The wrapper (kernels/decode.py) picks the kernel from the strides and the
// alignment.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // bulk kernel: 16 blocks of 12 KB maps an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMapBytes = 48 * 1024;    // one buffer
constexpr int kStridedWarps = 4;

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// (v, i) into (best, best_i): the larger value; the lower index on a tie.
__device__ __forceinline__ void merge(float v, int i, float& best,
                                      int& best_i) {
  if (v > best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_merge(float& best, int& best_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    merge(ov, oi, best, best_i);
  }
}

// The outputs of map m from its peak; at(y, x) reads the map. An index of
// H*W (no value taken: all NaN) gives max -inf, coordinates 0, no shift.
template <class At>
__device__ __forceinline__ void write_peak(int m, float best, int best_i,
                                           int H, int W, At at,
                                           float* __restrict__ coords,
                                           float* __restrict__ maxvals,
                                           float* __restrict__ shift) {
  const float valid = best > 0.f ? 1.f : 0.f;
  const int row = best_i / W;
  const float x = (float)(best_i - row * W) * valid;
  const float y = (float)row * valid;
  const int px = (int)floorf(x + 0.5f), py = (int)floorf(y + 0.5f);
  const bool ok = px > 1 && px < W - 1 && py > 1 && py < H - 1;
  const int pxc = min(max(px, 1), W - 2), pyc = min(max(py, 1), H - 2);
  const float dx = at(pyc, pxc + 1) - at(pyc, pxc - 1);
  const float dy = at(pyc + 1, pxc) - at(pyc - 1, pxc);
  coords[m * 2 + 0] = x;
  coords[m * 2 + 1] = y;
  maxvals[m] = best;
  shift[m * 2 + 0] = ok ? sign_of(dx) * 0.25f : 0.f;
  shift[m * 2 + 1] = ok ? sign_of(dy) * 0.25f : 0.f;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait for the phase of ``bar`` with this parity to complete. A copy that
// never completes ends the kernel with an error instead of hanging it.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}

__global__ void __launch_bounds__(kThreads)
peaks_bulk_kernel(const float* __restrict__ hm, long long sN, long long sJ,
                  int J, int H, int W, float* __restrict__ coords,
                  float* __restrict__ maxvals, float* __restrict__ shift) {
  extern __shared__ __align__(128) float4 buf[];   // the map, HW/4 vectors
  __shared__ __align__(8) uint64_t bar;
  __shared__ float warp_best[kWarps];
  __shared__ int warp_idx[kWarps];
  const int HW = H * W, HW4 = HW >> 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = blockIdx.x, n = m / J;             // one division per map

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(&bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bulk_load(buf, hm + n * sN + (long long)(m - n * J) * sJ,
              (uint32_t)HW * 4u, &bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it

  float best = -CUDART_INF_F;
  int best_i = HW;  // larger than any index: loses every tie
  wait_parity(&bar, 0);
  for (int q = tid; q < HW4; q += kThreads) {
    const float4 v = buf[q];
    merge(v.x, 4 * q + 0, best, best_i);
    merge(v.y, 4 * q + 1, best, best_i);
    merge(v.z, 4 * q + 2, best, best_i);
    merge(v.w, 4 * q + 3, best, best_i);
  }
  warp_merge(best, best_i);
  if (lane == 0) {
    warp_best[warp] = best;
    warp_idx[warp] = best_i;
  }
  __syncthreads();
  if (warp != 0) return;
  best = lane < kWarps ? warp_best[lane] : -CUDART_INF_F;
  best_i = lane < kWarps ? warp_idx[lane] : HW;
  warp_merge(best, best_i);
  if (lane == 0) {
    const float* map = reinterpret_cast<const float*>(buf);
    write_peak(m, best, best_i, H, W,
               [&](int y, int x) { return map[y * W + x]; }, coords, maxvals,
               shift);
  }
}

__global__ void peaks_strided_kernel(const float* __restrict__ hm,
                                     long long sN, long long sJ,
                                     long long sH, long long sW, int J,
                                     int n_maps, int H, int W,
                                     float* __restrict__ coords,
                                     float* __restrict__ maxvals,
                                     float* __restrict__ shift) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kStridedWarps + (threadIdx.x >> 5);
  if (m >= n_maps) return;
  const int n = m / J;
  const float* map = hm + n * sN + (long long)(m - n * J) * sJ;
  float best = -CUDART_INF_F;
  int best_i = H * W;
  for (int y = 0; y < H; ++y) {
    const float* row = map + y * sH;
    for (int x = lane; x < W; x += 32)
      merge(__ldg(row + x * sW), y * W + x, best, best_i);
  }
  warp_merge(best, best_i);
  if (lane == 0)
    write_peak(m, best, best_i, H, W,
               [&](int y, int x) { return map[y * sH + x * sW]; }, coords,
               maxvals, shift);
}

}  // namespace

// Contiguous maps (see the header): one block per map. Returns a
// cudaError_t.
extern "C" int heatmap_peaks_bulk_launch(const float* hm, long long sN,
                                         long long sJ, int N, int J, int H,
                                         int W, float* coords,
                                         float* maxvals, float* shift,
                                         void* stream) {
  const int n_maps = N * J;
  const int bytes = H * W * 4;
  if (n_maps == 0) return 0;
  if (bytes % 16 != 0 || bytes > kMaxMapBytes)
    return (int)cudaErrorInvalidValue;
  // a 48 KB map and the static shared memory need the attribute (once)
  static const cudaError_t attr = cudaFuncSetAttribute(
      peaks_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxMapBytes);
  if (attr != cudaSuccess) return (int)attr;
  peaks_bulk_kernel<<<n_maps, kThreads, bytes, (cudaStream_t)stream>>>(
      hm, sN, sJ, J, H, W, coords, maxvals, shift);
  return (int)cudaGetLastError();
}

extern "C" int heatmap_peaks_strided_launch(const float* hm, long long sN,
                                            long long sJ, long long sH,
                                            long long sW, int N, int J, int H,
                                            int W, float* coords,
                                            float* maxvals, float* shift,
                                            void* stream) {
  const int n_maps = N * J;
  if (n_maps == 0) return 0;
  const int blocks = (n_maps + kStridedWarps - 1) / kStridedWarps;
  peaks_strided_kernel<<<blocks, 32 * kStridedWarps, 0,
                         (cudaStream_t)stream>>>(hm, sN, sJ, sH, sW, J,
                                                 n_maps, H, W, coords,
                                                 maxvals, shift);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
