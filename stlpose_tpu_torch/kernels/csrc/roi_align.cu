// Multilevel FPN RoIAlign for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_roi.py::_roi_chunk_call (kernels
// _roi_kernel_pp and _roi_kernel, one function) behind
// multilevel_roi_align_pallas_batched, on float32, bfloat16 and int8
// pyramids (patch_quant). Each box is pooled from the one FPN level the
// wrapper assigned to it (int32 level per box, computed once on the host
// side so kernel and plain version see the same level): 7x7 bins, sampling
// ratio 2 (14x14 bilinear samples), torchvision aligned=False border rules
// as in stlpose_tpu/ops/roi_align.py::roi_align_single_level (a sample
// outside [-1, size] reads 0; otherwise it is clamped to [0, size-1] and its
// high tap clamps to the last index), then the mean of each 2x2.
//
// Element types: taps are read in their stored type (float, __nv_bfloat16,
// int8_t) and widened to f32; the bilinear weights, the 2x2 mean and the
// optional dequantization multiply by the (L, C) f32 scale of the box's
// level (pallas_roi.py:530-537, here fused into the epilogue) run in f32,
// and the result is rounded once to the output type (float or bfloat16) at
// the store. The Pallas body instead rounds its lerp into a compute-dtype
// scratch and runs a banded matmul in that dtype.
//
// Bound: writing the pooled output and reading the feature maps once
// (about 212 MB at B=8, P=256, C=256, 400x400 canvas in f32; 79 MB with an
// int8 pyramid and a bf16 output). One block per box; the 14 x- and 14
// y-sample positions are computed once into shared memory; threads then
// walk (bin, channel) with the channel fastest, so every tap of a warp is
// one contiguous run of an NHWC row. The TPU kernel's DMA geometry
// (transposed pyramid half, aligned row windows and the int8 32-row
// sublane alignment, band vs per-point copies, CHUNK, KB) is not carried
// over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kOut = 7;
constexpr int kSr = 2;
constexpr int kNs = kOut * kSr;

struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sample positions along one axis: low/high tap index, fraction, inside.
__device__ __forceinline__ void axis_sample(float lo, float hi, int size,
                                            int s, int* i0, int* i1,
                                            float* frac, bool* inside) {
  const float roi = fmaxf(hi - lo, 1.0f);
  const float bin = roi / (float)kOut;
  const float pos = (float)(s / kSr) + ((float)(s % kSr) + 0.5f) / (float)kSr;
  const float g = lo + pos * bin;
  *inside = g >= -1.0f && g <= (float)size;
  const float gc = fminf(fmaxf(g, 0.0f), (float)(size - 1));
  const float g0 = floorf(gc);
  *frac = gc - g0;
  *i0 = (int)g0;
  *i1 = min(*i0 + 1, size - 1);
}

// dequant: (L, C) f32 per-(level, channel) scales, or null.
template <typename TIn, typename TOut>
__global__ void roi_align_kernel(Levels lv, int L, int C,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ levels, int P,
                                 const float* __restrict__ dequant,
                                 TOut* __restrict__ out) {
  __shared__ int xi0[kNs], xi1[kNs], yi0[kNs], yi1[kNs];
  __shared__ float xf[kNs], yf[kNs];
  __shared__ bool xin[kNs], yin[kNs];

  const int box = blockIdx.x;
  const int img = box / P;
  const int l = levels[box];
  TOut* dst = out + (long long)box * kOut * kOut * C;
  if (l < 0 || l >= L) {  // not a level of this pyramid: pool zeros
    for (int o = threadIdx.x; o < kOut * kOut * C; o += blockDim.x)
      dst[o] = narrow<TOut>(0.f);
    return;
  }
  const int H = lv.h[l], W = lv.w[l];
  const float sc = lv.scale[l];
  if (threadIdx.x < 2 * kNs) {
    const float* bx = boxes + box * 4;
    const int s = threadIdx.x % kNs;
    if (threadIdx.x < kNs) {
      axis_sample(bx[0] * sc, bx[2] * sc, W, s, &xi0[s], &xi1[s], &xf[s],
                  &xin[s]);
    } else {
      axis_sample(bx[1] * sc, bx[3] * sc, H, s, &yi0[s], &yi1[s], &yf[s],
                  &yin[s]);
    }
  }
  __syncthreads();

  const TIn* feat =
      static_cast<const TIn*>(lv.feat[l]) + (long long)img * H * W * C;
  const float* dq = dequant == nullptr ? nullptr : dequant + l * C;
  for (int o = threadIdx.x; o < kOut * kOut * C; o += blockDim.x) {
    const int c = o % C, b = o / C;
    const int by = b / kOut, bx = b % kOut;
    float acc = 0.f;
#pragma unroll
    for (int sy = 0; sy < kSr; ++sy) {
#pragma unroll
      for (int sx = 0; sx < kSr; ++sx) {
        const int iy = by * kSr + sy, ix = bx * kSr + sx;
        float v = 0.f;
        if (yin[iy] && xin[ix]) {
          const float fx = xf[ix], fy = yf[iy];
          const TIn* r0 = feat + (long long)yi0[iy] * W * C;
          const TIn* r1 = feat + (long long)yi1[iy] * W * C;
          const float t00 = widen(r0[xi0[ix] * C + c]);
          const float t01 = widen(r0[xi1[ix] * C + c]);
          const float t10 = widen(r1[xi0[ix] * C + c]);
          const float t11 = widen(r1[xi1[ix] * C + c]);
          v = t00 * ((1.f - fx) * (1.f - fy)) + t01 * (fx * (1.f - fy)) +
              t10 * ((1.f - fx) * fy) + t11 * (fx * fy);
        }
        acc = (sy == 0 && sx == 0) ? v : acc + v;
      }
    }
    float r = acc * 0.25f;
    if (dq != nullptr) r = r * dq[c];
    dst[o] = narrow<TOut>(r);
  }
}

template <typename TIn, typename TOut>
int launch(const void* f0, const void* f1, const void* f2, const void* f3,
           int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
           float s0, float s1, float s2, float s3, int L, int C,
           const float* boxes, const int* levels, int B, int P,
           const float* dequant, void* out, void* stream) {
  if (B * P == 0) return 0;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
            {s0, s1, s2, s3}};
  roi_align_kernel<TIn, TOut><<<B * P, 256, 0, (cudaStream_t)stream>>>(
      lv, L, C, boxes, levels, P, dequant, static_cast<TOut*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per instantiation: <pyramid type>_<output type>.
#define ROI_ALIGN_ENTRY(NAME, TIN, TOUT)                                     \
  extern "C" int NAME(const void* f0, const void* f1, const void* f2,        \
                      const void* f3, int h0, int w0, int h1, int w1,        \
                      int h2, int w2, int h3, int w3, float s0, float s1,    \
                      float s2, float s3, int L, int C, const float* boxes,  \
                      const int* levels, int B, int P, const float* dequant, \
                      void* out, void* stream) {                             \
    return launch<TIN, TOUT>(f0, f1, f2, f3, h0, w0, h1, w1, h2, w2, h3, w3, \
                             s0, s1, s2, s3, L, C, boxes, levels, B, P,      \
                             dequant, out, stream);                          \
  }

ROI_ALIGN_ENTRY(roi_align_f32_f32, float, float)
ROI_ALIGN_ENTRY(roi_align_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
ROI_ALIGN_ENTRY(roi_align_i8_f32, int8_t, float)
ROI_ALIGN_ENTRY(roi_align_i8_bf16, int8_t, __nv_bfloat16)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
