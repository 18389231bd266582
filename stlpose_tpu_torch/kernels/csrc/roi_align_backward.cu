// K3b: the gradient of multilevel FPN RoIAlign with respect to the feature
// maps, for Hopper (sm_90a).
//
// Has no Pallas original: the JAX package differentiates XLA's
// stlpose_tpu/ops/roi_align.py::multilevel_roi_align (:143) by autodiff
// inside FasterRCNN.loss_fn (stlpose_tpu/models/faster_rcnn.py:515-517).
// This is the backward of K3's f32 instantiation (csrc/roi_align.cu), with
// the same sample positions, clamps and `inside` rule (axis_sample below is
// K3's): for each box, its level's 14 x 14 bilinear samples; for each sample
// s of bin b that lies inside and each channel c,
//   d_map[level][img, tap, c] += (g[box, b, c] * 0.25) * w_tap(s)
// at its 4 taps (two of them the same pixel where a tap clamps to the last
// index). The maps start at zero (the wrapper zeroes them); a box on no
// level of the pyramid adds nothing. Each product is rounded as the plain
// version's autograd rounds it (built with --fmad=false); only the order
// of the sums differs, since they are f32 atomic adds.
//
// Bound: bytes, the upstream gradient read once and the maps written once
// (at the training shape 102.8 + 108.9 MB); what limits it is the atomic
// adds, 4 per (sample inside, channel): ~411 M at the training shape,
// resolved in L2.
// Design: a block per box; the box's 14 x 14 sample weights (each already
// the product of its two axis weights, as the forward rounds it) and its
// taps' element offsets in shared memory; the block's threads walk the
// box's (sample, channel) pairs with the channel fastest, so a warp's 4
// atomic adds of one tap fall on 32 adjacent floats of one pixel (one
// 128-byte line) and issue as RED (the old value is not read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kOut = 7;
constexpr int kSr = 2;
constexpr int kNs = kOut * kSr;
constexpr int kBins = kOut * kOut;
constexpr int kThreads = 256;

struct Levels {
  float* grad[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// K3's sample positions along one axis (csrc/roi_align.cu::axis_sample).
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

__global__ void __launch_bounds__(kThreads)
    roi_align_backward_kernel(Levels lv, int L, int C,
                              const float* __restrict__ boxes,
                              const int* __restrict__ levels, int P,
                              const float* __restrict__ grad_out) {
  __shared__ float4 wts[kNs * kNs];   // the 4 tap weights of each sample
  __shared__ int4 off[kNs * kNs];     // the 4 taps' element offsets
  __shared__ int n_in;                // samples inside, packed first
  __shared__ short order[kNs * kNs];  // their indices

  const int box = blockIdx.x;
  const int img = box / P;
  const int l = levels[box];
  if (l < 0 || l >= L) return;  // pooled zeros: no gradient
  const int H = pick(lv.h, l), W = pick(lv.w, l);
  const float sc = pick(lv.scale, l);
  const float* bx = boxes + box * 4;
  if (threadIdx.x == 0) n_in = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < kNs * kNs; t += blockDim.x) {
    const int iy = t / kNs, ix = t % kNs;
    int x0, x1, y0, y1;
    float fx, fy;
    bool inx, iny;
    axis_sample(bx[0] * sc, bx[2] * sc, W, ix, &x0, &x1, &fx, &inx);
    axis_sample(bx[1] * sc, bx[3] * sc, H, iy, &y0, &y1, &fy, &iny);
    wts[t] = make_float4((1.f - fx) * (1.f - fy), fx * (1.f - fy),
                         (1.f - fx) * fy, fx * fy);
    off[t] = make_int4((y0 * W + x0) * C, (y0 * W + x1) * C,
                       (y1 * W + x0) * C, (y1 * W + x1) * C);
    if (iny && inx) order[atomicAdd(&n_in, 1)] = (short)t;
  }
  __syncthreads();

  float* grad = pick(lv.grad, l) + (long long)img * H * W * C;
  const float* g = grad_out + (long long)box * kBins * C;
  const int n = n_in * C;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = order[i / C];
    const int c = i % C;
    const int bin = (t / kNs / kSr) * kOut + (t % kNs) / kSr;
    const float v = __ldg(g + bin * C + c) * 0.25f;
    const float4 w = wts[t];
    const int4 o = off[t];
    atomicAdd(grad + o.x + c, v * w.x);
    atomicAdd(grad + o.y + c, v * w.y);
    atomicAdd(grad + o.z + c, v * w.z);
    atomicAdd(grad + o.w + c, v * w.w);
  }
}

}  // namespace

// d_maps (B, h_l, w_l, C) f32 per level, zeroed by the caller, += the
// gradient of K3's f32 pooling of boxes (B, P, 4) at levels (B, P) int32,
// from grad_out (B, P, 7, 7, C) f32. Returns a cudaError_t.
extern "C" int roi_align_backward_f32(
    void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1,
    int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    int L, int C, const float* boxes, const int* levels, int B, int P,
    const float* grad_out, void* stream) {
  if (B * P == 0 || C == 0) return 0;
  Levels lv{{static_cast<float*>(g0), static_cast<float*>(g1),
             static_cast<float*>(g2), static_cast<float*>(g3)},
            {h0, h1, h2, h3},
            {w0, w1, w2, w3},
            {s0, s1, s2, s3}};
  roi_align_backward_kernel<<<B * P, kThreads, 0, (cudaStream_t)stream>>>(
      lv, L, C, boxes, levels, P, grad_out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
