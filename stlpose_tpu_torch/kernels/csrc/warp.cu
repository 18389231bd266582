// K2: batched affine crop warp for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_warp.py::_pallas_warp_call (kernel
// _warp_kernel, pallas_call at :235) behind
// crop_from_center_scale_batched_pallas (:254) and
// crop_from_center_scale_pallas (:295). Crop k reads image img_idx[k]; each
// output pixel (gx, gy) is a bilinear sample of that image at the inverse
// similarity map
//   sx = a*gx - b*gy + tx,   sy = b*gx + a*gy + ty.
// Each of the four taps is valid on its own (0 <= x < W, 0 <= y < H) and
// reads 0 otherwise (cv2 BORDER_CONSTANT, the rule of
// stlpose_tpu/ops/warp.py::_bilinear_sample); a crop whose img_idx is
// outside [0, B) reads zeros only. The TPU kernel's two-pass split,
// 128-lane chunks and square canvas exist for Mosaic's gather limits and
// are not carried over: this samples directly.
//
// Bound on the H100: writing the crops (K*DH*DW*C*4 bytes; 37.7 MB of the
// serving shape's 53 MB) plus reading the images they come from, at
// 3.35 TB/s. Short of that, the time goes to the 12 gathered tap loads
// per pixel and to stores that a 12-byte pixel leaves unaligned. So:
// - a block per (crop, band of 8 output rows), a 2-D grid with no
//   division; the crop's params and image index are read once per block;
// - a warp makes 32 consecutive pixels of a row, lane l pixel l, so that a
//   tap load of the warp touches few source cache lines (four pixels a
//   thread spread them over ~4x as many lines and measured slower);
// - where DW*C is a multiple of 4 (every serving crop), the band, a
//   contiguous run of the NHWC crop, is staged in shared memory and
//   written with one bulk asynchronous copy (this measured faster than
//   staging each warp's 32 pixels and storing them as float4); otherwise
//   each value is stored as it is made;
// - unrotated crops (b == 0, every serving crop) separate: the x taps
//   (x0, fx) of each column are computed once per block into shared
//   memory, the y taps once per row. a*gx - b*gy + tx with b == 0 equals
//   a*gx + tx, and the weights are the plain version's products summed in
//   its order, so kernel and plain version agree bit for bit (nvcc
//   --fmad=false). Rotated crops (b != 0) compute each pixel's position
//   directly; the choice is made per crop, on the device;
// - source taps go through the read-only path (__ldg); C = 3 is unrolled
//   at compile time, any other C runs a loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // a block: 8 warps of 32 lanes
constexpr int kBandRows = 8;               // a band: a row per warp
constexpr int kMaxTableCols = 4096;        // x-tap table: 8 bytes a column
constexpr int kMaxStageBytes = 24 * 1024;  // one staged band
constexpr int kMaxGridY = 65535;

// Bilinear sample at tap (x0, y0) with fractions (fx, fy): the plain
// version's weights and sum, nc channels stored to d[0..nc).
template <int CT>
__device__ __forceinline__ void sample(const float* __restrict__ src,
                                       bool img_ok, int H, int W, int C,
                                       int x0, float fx, int y0, float fy,
                                       float* d) {
  const float w00 = (1.f - fx) * (1.f - fy);
  const float w01 = fx * (1.f - fy);
  const float w10 = (1.f - fx) * fy;
  const float w11 = fx * fy;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x0 >= -1 && x0 < W - 1;
  const bool vy0 = img_ok && y0 >= 0 && y0 < H;
  const bool vy1 = img_ok && y0 >= -1 && y0 < H - 1;
  const int nc = CT > 0 ? CT : C;
  const float* r0 = src + ((long long)y0 * W + x0) * nc;
  const float* r1 = r0 + (long long)W * nc;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float t00 = (vy0 && vx0) ? __ldg(r0 + c) : 0.f;
    const float t01 = (vy0 && vx1) ? __ldg(r0 + nc + c) : 0.f;
    const float t10 = (vy1 && vx0) ? __ldg(r1 + c) : 0.f;
    const float t11 = (vy1 && vx1) ? __ldg(r1 + nc + c) : 0.f;
    d[c] = t00 * w00 + t01 * w01 + t10 * w10 + t11 * w11;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A block is (32, kWarps) threads and owns crop k0 + blockIdx.y, output
// rows [blockIdx.x * band_rows, + band_rows); warp w takes rows w, w + 8,
// ... of the band, 32 consecutive pixels at a time. CT: channels fixed at
// compile time (3) or 0 (any C). bulk: stage the band in shared memory and
// write it with one bulk copy (DW*C a multiple of 4, band_rows rows fit).
template <int CT>
__global__ void __launch_bounds__(kWarps * 32)
affine_crop_kernel(const float* __restrict__ images, int B, int H, int W,
                   int C, const float* __restrict__ params,
                   const int* __restrict__ img_idx, int k0, int DH, int DW,
                   int band_rows, int use_table, int bulk,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_par[4];
  __shared__ int s_img;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int k = k0 + blockIdx.y;
  const int y_begin = blockIdx.x * band_rows;
  const int y_end = min(DH, y_begin + band_rows);
  if (tid < 4) s_par[tid] = params[k * 4 + tid];
  if (tid == 4) s_img = img_idx[k];
  __syncthreads();
  const float a = s_par[0], b = s_par[1], tx = s_par[2], ty = s_par[3];
  const int img = s_img;
  const bool img_ok = img >= 0 && img < B;  // a bad index reads zeros only
  const float* src = images + (long long)(img_ok ? img : 0) * H * W * C;
  const long long row_len = (long long)DW * C;
  // shared memory: [band (bulk)][x0 table][fx table]
  int* col_x0 = reinterpret_cast<int*>(smem + (bulk ? band_rows * row_len
                                                    : 0));
  float* col_fx = reinterpret_cast<float*>(col_x0 + DW);

  const bool table = use_table && b == 0.f;  // per crop, block-uniform
  if (table) {
    for (int x = tid; x < DW; x += kWarps * 32) {
      const float sx = a * (float)x + tx;
      const float x0f = floorf(sx);
      col_x0[x] = (int)x0f;
      col_fx[x] = sx - x0f;
    }
    __syncthreads();
  }

  for (int y = y_begin + warp; y < y_end; y += kWarps) {
    const float gy = (float)y;
    int y0r = 0;
    float fyr = 0.f;
    if (table) {
      const float sy = a * gy + ty;
      const float y0f = floorf(sy);
      y0r = (int)y0f;
      fyr = sy - y0f;
    }
    float* orow = bulk ? smem + (y - y_begin) * row_len
                       : out + ((long long)k * DH + y) * row_len;
    for (int x = lane; x < DW; x += 32) {
      if (table) {
        sample<CT>(src, img_ok, H, W, C, col_x0[x], col_fx[x], y0r, fyr,
                   orow + (long long)x * C);
      } else {
        const float gx = (float)x;
        const float sx = a * gx - b * gy + tx;
        const float sy = b * gx + a * gy + ty;
        const float x0f = floorf(sx), y0f = floorf(sy);
        sample<CT>(src, img_ok, H, W, C, (int)x0f, sx - x0f, (int)y0f,
                   sy - y0f, orow + (long long)x * C);
      }
    }
  }

  if (bulk) {
    // the band's generic-proxy writes, then one async-proxy copy out
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)((y_end - y_begin) * row_len * 4);
      float* dst = out + ((long long)k * DH + y_begin) * row_len;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(dst), "r"(smem_u32(smem)), "r"(bytes) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory must outlive the copy's reads
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int CT>
cudaError_t launch(const float* images, int B, int H, int W, int C,
                   const float* params, const int* img_idx, int K, int DH,
                   int DW, float* out, cudaStream_t stream) {
  const long long row_bytes = (long long)DW * C * 4;
  const int use_table = DW <= kMaxTableCols;
  const int bulk = row_bytes % 16 == 0 && row_bytes <= kMaxStageBytes;
  const int band_rows =
      bulk ? (int)min((long long)kBandRows, kMaxStageBytes / row_bytes)
           : kBandRows;
  const size_t smem = (bulk ? band_rows * row_bytes : 0) +
                      (use_table ? (size_t)DW * 8 : 0);
  auto kernel = affine_crop_kernel<CT>;
  if (smem > 40 * 1024) {  // with the static shared memory, over 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int bands = (DH + band_rows - 1) / band_rows;
  for (int k0 = 0; k0 < K; k0 += kMaxGridY) {
    const dim3 grid(bands, min(K - k0, kMaxGridY));
    kernel<<<grid, dim3(32, kWarps), smem, stream>>>(
        images, B, H, W, C, params, img_idx, k0, DH, DW, band_rows,
        use_table, bulk, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t.
extern "C" int affine_crop_launch(const float* images, int B, int H, int W,
                                  int C, const float* params,
                                  const int* img_idx, int K, int DH, int DW,
                                  float* out, void* stream) {
  if (K == 0 || DH == 0 || DW == 0 || C == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(C == 3 ? launch<3>(images, B, H, W, C, params, img_idx, K, DH,
                                  DW, out, s)
                      : launch<0>(images, B, H, W, C, params, img_idx, K, DH,
                                  DW, out, s));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
