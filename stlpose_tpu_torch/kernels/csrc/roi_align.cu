// Multilevel FPN RoIAlign for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_roi.py::_roi_chunk_call (kernels
// _roi_kernel_pp and _roi_kernel, one function) behind
// multilevel_roi_align_pallas_batched. Each box is pooled from the one
// FPN level the wrapper assigned to it (int32 level per box, computed once
// on the host side so kernel and plain version see the same level): 7x7
// bins, sampling ratio 2 (14x14 bilinear samples), torchvision
// aligned=False border rules as in stlpose_tpu/ops/roi_align.py::
// roi_align_single_level (a sample outside [-1, size] reads 0; otherwise
// it is clamped to [0, size-1] and its high tap clamps to the last
// index), then the mean of each 2x2.
//
// Bound: writing the pooled output and reading the feature maps once
// (about 212 MB at B=8, P=256, C=256, 400x400 canvas). One block per box;
// the 14 x- and 14 y-sample positions are computed once into shared
// memory; threads then walk (bin, channel) with the channel fastest, so
// every tap of a warp is one contiguous run of an NHWC row. The TPU
// kernel's DMA geometry (transposed pyramid half, aligned row windows,
// band vs per-point copies, CHUNK, KB) is not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kOut = 7;
constexpr int kSr = 2;
constexpr int kNs = kOut * kSr;

struct Levels {
  const float* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

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

__global__ void roi_align_kernel(Levels lv, int L, int C,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ levels, int P,
                                 float* __restrict__ out) {
  __shared__ int xi0[kNs], xi1[kNs], yi0[kNs], yi1[kNs];
  __shared__ float xf[kNs], yf[kNs];
  __shared__ bool xin[kNs], yin[kNs];

  const int box = blockIdx.x;
  const int img = box / P;
  const int l = levels[box];
  float* dst = out + (long long)box * kOut * kOut * C;
  if (l < 0 || l >= L) {  // not a level of this pyramid: pool zeros
    for (int o = threadIdx.x; o < kOut * kOut * C; o += blockDim.x) dst[o] = 0.f;
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

  const float* feat = lv.feat[l] + (long long)img * H * W * C;
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
          const float* r0 = feat + (long long)yi0[iy] * W * C;
          const float* r1 = feat + (long long)yi1[iy] * W * C;
          const float t00 = r0[xi0[ix] * C + c], t01 = r0[xi1[ix] * C + c];
          const float t10 = r1[xi0[ix] * C + c], t11 = r1[xi1[ix] * C + c];
          v = t00 * ((1.f - fx) * (1.f - fy)) + t01 * (fx * (1.f - fy)) +
              t10 * ((1.f - fx) * fy) + t11 * (fx * fy);
        }
        acc = (sy == 0 && sx == 0) ? v : acc + v;
      }
    }
    dst[o] = acc * 0.25f;
  }
}

}  // namespace

extern "C" int roi_align_launch(const float* f0, const float* f1,
                                const float* f2, const float* f3, int h0,
                                int w0, int h1, int w1, int h2, int w2,
                                int h3, int w3, float s0, float s1, float s2,
                                float s3, int L, int C, const float* boxes,
                                const int* levels, int B, int P, float* out,
                                void* stream) {
  if (B * P == 0) return 0;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
            {s0, s1, s2, s3}};
  roi_align_kernel<<<B * P, 256, 0, (cudaStream_t)stream>>>(
      lv, L, C, boxes, levels, P, out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
