// Batched affine crop warp for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_warp.py::_pallas_warp_call (kernel
// _warp_kernel) as used by crop_from_center_scale_batched_pallas: crop k
// reads image img_idx[k]; each output pixel (x', y') is a bilinear sample
// of that image at the inverse similarity map
//   sx = a*x' - b*y' + tx,   sy = b*x' + a*y' + ty
// with general (a, b), so rotated crops work too. Each of the four taps is
// valid on its own (0 <= x < W, 0 <= y < H) and reads 0 otherwise: cv2
// BORDER_CONSTANT, the rule of stlpose_tpu/ops/warp.py::_bilinear_sample
// (not the RoIAlign clamp rule).
//
// Bound: writing the crops (K*DH*DW*C*4 bytes) plus reading the source
// images they come from. One thread per (crop, output pixel), all C
// channels in a loop: neighbouring threads write neighbouring pixels, so
// stores coalesce, and the taps of neighbouring pixels share cache lines.
// The TPU kernel's two-pass split, 128-lane chunking, square canvas and
// 90-degree pre-rotation exist for Mosaic's gather limits and are not
// carried over: this samples directly.

#include <cuda_runtime.h>

namespace {

__global__ void affine_crop_kernel(const float* __restrict__ images, int B,
                                   int H, int W, int C,
                                   const float* __restrict__ params,
                                   const int* __restrict__ img_idx, int K,
                                   int DH, int DW, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)K * DH * DW;
  if (t >= total) return;
  const int k = (int)(t / ((long long)DH * DW));
  const int rem = (int)(t % ((long long)DH * DW));
  const float gy = (float)(rem / DW), gx = (float)(rem % DW);

  const float a = params[k * 4 + 0], b = params[k * 4 + 1];
  const float tx = params[k * 4 + 2], ty = params[k * 4 + 3];
  const float sx = a * gx - b * gy + tx;
  const float sy = b * gx + a * gy + ty;
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float fx = sx - x0, fy = sy - y0;
  const int x0i = (int)x0, y0i = (int)y0;
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy;
  const float w11 = fx * fy;
  const int img = img_idx[k];
  const bool img_ok = img >= 0 && img < B;  // a bad index reads zeros only
  const bool vx0 = x0i >= 0 && x0i < W, vx1 = x0i + 1 >= 0 && x0i + 1 < W;
  const bool vy0 = img_ok && y0i >= 0 && y0i < H;
  const bool vy1 = img_ok && y0i + 1 >= 0 && y0i + 1 < H;

  const float* src = images + (long long)img * H * W * C;
  const long long r0 = (long long)y0i * W, r1 = (long long)(y0i + 1) * W;
  float* dst = out + t * C;
  for (int c = 0; c < C; ++c) {
    const float t00 = (vy0 && vx0) ? src[(r0 + x0i) * C + c] : 0.f;
    const float t01 = (vy0 && vx1) ? src[(r0 + x0i + 1) * C + c] : 0.f;
    const float t10 = (vy1 && vx0) ? src[(r1 + x0i) * C + c] : 0.f;
    const float t11 = (vy1 && vx1) ? src[(r1 + x0i + 1) * C + c] : 0.f;
    dst[c] = t00 * w00 + t01 * w01 + t10 * w10 + t11 * w11;
  }
}

}  // namespace

extern "C" int affine_crop_launch(const float* images, int B, int H, int W,
                                  int C, const float* params,
                                  const int* img_idx, int K, int DH, int DW,
                                  float* out, void* stream) {
  const long long total = (long long)K * DH * DW;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  affine_crop_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      images, B, H, W, C, params, img_idx, K, DH, DW, out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
