// Heatmap peak decode for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_decode.py::heatmap_peaks_pallas (kernel
// _decode_kernel). Per (crop, joint) heatmap of H*W values it finds the
// flat argmax (lowest index on ties) and the max, zeroes the coordinates
// where max <= 0, and computes the reference's +-0.25 px sub-pixel shift
// from the sign of the central differences, only where 1 < p < size-1.
//
// Bound: reading the heatmaps once (N*J*H*W*4 bytes; 208,896 B per crop
// at 64x48x17). One warp owns one (crop, joint) map: its lanes stride over
// the map so a warp's loads are contiguous when the map is (the port's
// HRNet writes NCHW, so the (N, J, H, W) view handed to decode is), then a
// shuffle reduction keeps (value, index) pairs with the lower index
// winning on equal values. Four neighbour reads finish the job. The
// heatmap is accessed through element strides, so NHWC-contiguous input
// needs no copy either.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void heatmap_peaks_kernel(const float* __restrict__ hm,
                                     long long sN, long long sJ,
                                     long long sH, long long sW,
                                     int N, int J, int H, int W,
                                     float* __restrict__ coords,
                                     float* __restrict__ maxvals,
                                     float* __restrict__ shift) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= N * J) return;
  const int n = pair / J, j = pair % J;
  const float* map = hm + n * sN + j * sJ;
  const int HW = H * W;

  float best = -CUDART_INF_F;
  int best_i = HW;  // larger than any index: loses every tie
  for (int i = lane; i < HW; i += 32) {
    const float v = map[(i / W) * sH + (i % W) * sW];
    if (v > best || best_i == HW) {  // first value seen always taken
      best = v;
      best_i = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane != 0) return;

  const float valid = best > 0.f ? 1.f : 0.f;
  const float x = (float)(best_i % W) * valid;
  const float y = floorf((float)best_i / (float)W) * valid;
  const int px = (int)floorf(x + 0.5f), py = (int)floorf(y + 0.5f);
  const bool ok = px > 1 && px < W - 1 && py > 1 && py < H - 1;
  const int pxc = min(max(px, 1), W - 2), pyc = min(max(py, 1), H - 2);
  const float dx = map[pyc * sH + (pxc + 1) * sW] - map[pyc * sH + (pxc - 1) * sW];
  const float dy = map[(pyc + 1) * sH + pxc * sW] - map[(pyc - 1) * sH + pxc * sW];

  coords[pair * 2 + 0] = x;
  coords[pair * 2 + 1] = y;
  maxvals[pair] = best;
  shift[pair * 2 + 0] = ok ? sign_of(dx) * 0.25f : 0.f;
  shift[pair * 2 + 1] = ok ? sign_of(dy) * 0.25f : 0.f;
}

}  // namespace

extern "C" int heatmap_peaks_launch(const float* hm, long long sN,
                                    long long sJ, long long sH, long long sW,
                                    int N, int J, int H, int W, float* coords,
                                    float* maxvals, float* shift,
                                    void* stream) {
  const int pairs = N * J;
  if (pairs == 0) return 0;
  const int blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  heatmap_peaks_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                         (cudaStream_t)stream>>>(hm, sN, sJ, sH, sW, N, J, H,
                                                 W, coords, maxvals, shift);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
