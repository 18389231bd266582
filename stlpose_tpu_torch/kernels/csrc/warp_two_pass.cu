// Two-pass (Catmull-Smith) rotated crop warp for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_warp.py::affine_warp_pallas (kernel
// _warp_kernel launched by _pallas_warp_call), the warp that makes every
// rotated training crop of the device-warp input pipeline. It computes
// the same function as the Pallas kernel, which for rotated crops is not
// direct bilinear sampling (that is K2, warp.cu). With the per-crop row
// (u, r, txr, b, a, ty) of the conditioned inverse map, output pixel
// (x', y') is
//   Y  = b*x' + a*y' + ty,  y0 = floor(Y),  fy = Y - y0
//   h(y) = lerp of source row y at X(y) = u*x' - r*y + txr   (pass 1)
//   out  = h(y0)*(1 - fy) + h(y0 + 1)*fy                    (pass 2)
// where a lerp is g0*(1 - f) + g1*f and every tap outside [0, S) reads 0.
// The Pallas kernel materialises pass 1 for all S source rows and
// transposes it, because Mosaic only gathers inside a vreg; here each
// thread computes just the two rows its pixel needs.
//
// Conditioning: where |a| < |b| the reference turns the canvas by 90
// degrees (jnp.rot90, k = 1, axes (1, 2)) before the warp; the rotated
// canvas R has R[y][x] = I[x][S-1-y]. The kernel folds that into its
// indexing (params[6] != 0), so no turned copy is written.
//
// Bound: writing the crops (N*DH*DW*C*4 bytes) plus reading the canvas
// pixels under them. The canvases may be uint8 (the pipeline's wire
// format): the conversion to f32 is exact, and the f32 copy of the batch
// is never made. One thread per (crop, output pixel), C channels in a
// loop; neighbouring threads write neighbouring pixels. Built with
// --fmad=false, so each product and sum rounds where the plain PyTorch
// version's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void warp_two_pass_kernel(const T* __restrict__ images, int S,
                                     int C, const float* __restrict__ params,
                                     int N, int DH, int DW,
                                     float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)DH * DW;
  if (t >= (long long)N * plane) return;
  const int n = (int)(t / plane);
  const int rem = (int)(t % plane);
  const float gx = (float)(rem % DW), gy = (float)(rem / DW);

  const float* p = params + (long long)n * 8;
  const float u = p[0], r = p[1], txr = p[2];
  const float b = p[3], a = p[4], ty = p[5];
  const bool swap = p[6] != 0.f;

  const float Y = b * gx + a * gy + ty;
  const float y0f = floorf(Y);
  const float fy = Y - y0f;
  const float ux = u * gx;
  const T* src = images + (long long)n * S * S * C;

  // per row k (y = y0 + k): is the row inside, and its two taps' offsets
  // (-1 for a tap outside) and weights
  bool row_ok[2];
  long long off0[2], off1[2];
  float w0[2], w1[2];
  for (int k = 0; k < 2; ++k) {
    const float yf = y0f + (float)k;
    row_ok[k] = yf >= 0.f && yf <= (float)(S - 1);
    off0[k] = off1[k] = -1;
    w0[k] = w1[k] = 0.f;
    if (!row_ok[k]) continue;
    const int y = (int)yf;
    const float X = ux - r * yf + txr;
    const float x0f = floorf(X);
    const float fx = X - x0f;
    w0[k] = 1.f - fx;
    w1[k] = fx;
    // (y, x) of the conditioned canvas -> element offset in the batch
    if (x0f >= 0.f && x0f <= (float)(S - 1)) {
      const int x = (int)x0f;
      off0[k] = swap ? ((long long)x * S + (S - 1 - y)) * C
                     : ((long long)y * S + x) * C;
    }
    if (x0f >= -1.f && x0f <= (float)(S - 2)) {
      const int x = (int)x0f + 1;
      off1[k] = swap ? ((long long)x * S + (S - 1 - y)) * C
                     : ((long long)y * S + x) * C;
    }
  }

  float* dst = out + t * C;
  for (int c = 0; c < C; ++c) {
    float h[2];
    for (int k = 0; k < 2; ++k) {
      const float g0 = off0[k] >= 0 ? (float)src[off0[k] + c] : 0.f;
      const float g1 = off1[k] >= 0 ? (float)src[off1[k] + c] : 0.f;
      h[k] = row_ok[k] ? g0 * w0[k] + g1 * w1[k] : 0.f;
    }
    dst[c] = h[0] * (1.f - fy) + h[1] * fy;
  }
}

template <typename T>
int launch(const T* images, int N, int S, int C, const float* params, int DH,
           int DW, float* out, void* stream) {
  const long long total = (long long)N * DH * DW;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  warp_two_pass_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      images, S, C, params, N, DH, DW, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_two_pass_u8_launch(const uint8_t* images, int N, int S,
                                       int C, const float* params, int DH,
                                       int DW, float* out, void* stream) {
  return launch(images, N, S, C, params, DH, DW, out, stream);
}

extern "C" int warp_two_pass_f32_launch(const float* images, int N, int S,
                                        int C, const float* params, int DH,
                                        int DW, float* out, void* stream) {
  return launch(images, N, S, C, params, DH, DW, out, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
