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
// int8_t) and widened to f32 exactly (bf16 by a shift, int8 through the
// 2^23 mantissa trick, no conversion instructions); the bilinear weights,
// the 2x2 mean and the optional dequantization multiply by the (L, C) f32
// scale of the box's level (pallas_roi.py:530-537, here fused into the
// epilogue) run in f32, in the plain version's order, and the result is
// rounded once to the output type (float or bfloat16) at the store. The
// Pallas body instead rounds its lerp into a compute-dtype scratch and runs
// a banded matmul in that dtype.
//
// Bound: writing the pooled output and reading the feature maps once. What
// the kernel must really serve is the taps: 16 per output element (784 per
// box and channel), from L1/L2, and the f32 operations on them in the
// plain version's order without FMA (about 53 instructions per output for
// bf16, 73 for int8), which is what limits it on the H100: its cold and
// warm times are equal.
// Design: a block per box, walking the box's channel slices one after
// another; a lane per (bin, 16 bytes of adjacent channels; 8 for int8), so
// one tap of a bin is one vector load and the lanes of a bin read one run
// of the pixel's bytes (8 lanes, 128 bytes; for int8 4 lanes, 32 bytes,
// with 4 blocks per SM instead of 2). A lane issues its bin's 16 tap loads
// before it uses any of them. A slice's footprint in the level (at most
// 28 x 28 pixels of one run, whatever the box's extent) stays in L1 while
// its 49 bins reuse the taps they share. The box's 14 x 14 sample weights
// and its row and column offsets are computed once per block into shared
// memory. The vector loads need C to be a multiple of a lane's channels
// and 16-byte aligned maps; otherwise every lane reads its channels one at
// a time, the last lane stopping at C.
// The TPU kernel's DMA geometry (transposed pyramid half, aligned row
// windows and the int8 32-row sublane alignment, band vs per-point copies,
// CHUNK, KB) is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kOut = 7;
constexpr int kSr = 2;
constexpr int kNs = kOut * kSr;
constexpr int kBins = kOut * kOut;
// Lanes per bin and __launch_bounds__ blocks per SM, for float and
// bfloat16 pyramids (8 x 16 B = a 128-byte line) and for int8 ones (4 x 8
// B): the layouts that measured fastest on the H100.
constexpr int kLanesF = 8, kMinBlocksF = 2;
constexpr int kLanesI8 = 4, kMinBlocksI8 = 4;

struct Levels {
  const void* feat[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ T pick(const T (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// A lane's vector of kBytes adjacent channels: loaded as 32-bit words,
// element j widened to f32 exactly; kLanes lanes per bin, kMinBlocks
// blocks per SM.
template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int kBytes = 16, kN = 4;
  static constexpr int kLanes = kLanesF, kMinBlocks = kMinBlocksF;
  __device__ __forceinline__ static float at(const uint32_t* w, int j) {
    return __uint_as_float(w[j]);
  }
  __device__ __forceinline__ static float one(float v) { return v; }
};
template <>
struct Wide<__nv_bfloat16> {
  static constexpr int kBytes = 16, kN = 8;
  static constexpr int kLanes = kLanesF, kMinBlocks = kMinBlocksF;
  __device__ __forceinline__ static float at(const uint32_t* w, int j) {
    const uint32_t x = w[j >> 1];
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  __device__ __forceinline__ static float one(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};
template <>
struct Wide<int8_t> {
  static constexpr int kBytes = 8, kN = 8;
  static constexpr int kLanes = kLanesI8, kMinBlocks = kMinBlocksI8;
  // the byte b + 128 (sign bit flipped) as the mantissa of 2^23: the float
  // 2^23 + 128 + b, less 2^23 + 128, is b exactly
  __device__ __forceinline__ static float at(const uint32_t* w, int j) {
    const uint32_t x = w[j >> 2] ^ 0x80808080u;
    return __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540 | (j & 3))) -
           8388736.0f;
  }
  __device__ __forceinline__ static float one(int8_t v) { return (float)v; }
};

template <int kWords>
__device__ __forceinline__ void load_words(uint32_t (&w)[kWords],
                                           const void* p) {
  if constexpr (kWords == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n results of a lane to dst (16-byte aligned when kVec), or the first
// n_valid of them one at a time.
template <typename TOut, int kN, bool kVec>
__device__ __forceinline__ void store(TOut* dst, const float (&r)[kN],
                                      int n_valid) {
  if constexpr (kVec) {
    if constexpr (sizeof(TOut) == 4) {
#pragma unroll
      for (int j = 0; j < kN; j += 4)
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < kN; j += 8) {
        uint32_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 b =
              __floats2bfloat162_rn(r[j + 2 * k], r[j + 2 * k + 1]);
          p[k] = *reinterpret_cast<const uint32_t*>(&b);
        }
        *reinterpret_cast<uint4*>(dst + j) = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (j < n_valid) dst[j] = narrow<TOut>(r[j]);
  }
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

// A block per box, walking its channel slices: slice s covers channel
// groups [s * lanes, (s + 1) * lanes) of kN channels each; thread = bin *
// lanes + lane. dequant: (L, C) f32 per-(level, channel) scales, or null.
template <typename TIn, typename TOut, bool kVec>
__global__ void __launch_bounds__(kBins * Wide<TIn>::kLanes,
                                  Wide<TIn>::kMinBlocks)
    roi_align_kernel(Levels lv, int L, int C, int lanes, int slices,
                     const float* __restrict__ boxes,
                     const int* __restrict__ levels, int P,
                     const float* __restrict__ dequant,
                     TOut* __restrict__ out) {
  constexpr int kN = Wide<TIn>::kN;
  constexpr int kWords = Wide<TIn>::kBytes / 4;
  __shared__ float4 wts[kNs * kNs];  // the 4 tap weights of each sample
  __shared__ bool inside[kNs * kNs];
  __shared__ int yoff[2][kNs], xoff[2][kNs];  // element offsets of taps

  const int box = blockIdx.x;
  const int img = box / P;
  const int l = levels[box];
  const int bin = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  TOut* dst = out + ((long long)box * kBins + bin) * C;
  if (l < 0 || l >= L) {  // not a level of this pyramid: pool zeros
    for (int c0 = lane * kN; c0 < C; c0 += lanes * kN) {
      float z[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) z[j] = 0.f;
      store<TOut, kN, kVec>(dst + c0, z, C - c0);
    }
    return;
  }
  const int H = pick(lv.h, l), W = pick(lv.w, l);
  const float sc = pick(lv.scale, l);
  const float* bx = boxes + box * 4;
  for (int t = threadIdx.x; t < kNs * kNs; t += blockDim.x) {
    const int iy = t / kNs, ix = t % kNs;
    int x0, x1, y0, y1;
    float fx, fy;
    bool inx, iny;
    axis_sample(bx[0] * sc, bx[2] * sc, W, ix, &x0, &x1, &fx, &inx);
    axis_sample(bx[1] * sc, bx[3] * sc, H, iy, &y0, &y1, &fy, &iny);
    wts[t] = make_float4((1.f - fx) * (1.f - fy), fx * (1.f - fy),
                         (1.f - fx) * fy, fx * fy);
    inside[t] = iny && inx;
    if (iy == 0) {
      xoff[0][ix] = x0 * C;
      xoff[1][ix] = x1 * C;
    }
    if (ix == 0) {
      yoff[0][iy] = y0 * W * C;
      yoff[1][iy] = y1 * W * C;
    }
  }
  __syncthreads();

  const TIn* feat =
      static_cast<const TIn*>(pick(lv.feat, l)) + (long long)img * H * W * C;
  const float* dq = dequant == nullptr ? nullptr : dequant + l * C;
  const int iy0 = bin / kOut * kSr, ix0 = bin % kOut * kSr;
  for (int sl = 0; sl < slices; ++sl) {
    const int c0 = (sl * lanes + lane) * kN;
    const int n_valid = min(kN, C - c0);
    if (n_valid <= 0) break;
    const TIn* f = feat + c0;
    // sample s = (sy, sx) of the bin; its tap k: row half k >> 1, column
    // half k & 1 (offsets re-read from shared memory, not held)
    if constexpr (kVec) {
      uint32_t raw[4][4][kWords];  // all 16 taps in flight before any is used
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          load_words(raw[s][k], f + yoff[k >> 1][iy0 + (s >> 1)] +
                                    xoff[k & 1][ix0 + (s & 1)]);
      float r[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int t = (iy0 + (s >> 1)) * kNs + ix0 + (s & 1);
          const float4 w = wts[t];
          float v = Wide<TIn>::at(raw[s][0], j) * w.x +
                    Wide<TIn>::at(raw[s][1], j) * w.y +
                    Wide<TIn>::at(raw[s][2], j) * w.z +
                    Wide<TIn>::at(raw[s][3], j) * w.w;
          v = inside[t] ? v : 0.f;
          acc = s == 0 ? v : acc + v;
        }
        r[j] = acc * 0.25f;
      }
      if (dq != nullptr) {
#pragma unroll
        for (int j = 0; j < kN; j += 4) {
          const float4 d = __ldg(reinterpret_cast<const float4*>(dq + c0 + j));
          r[j] = r[j] * d.x, r[j + 1] = r[j + 1] * d.y;
          r[j + 2] = r[j + 2] * d.z, r[j + 3] = r[j + 3] * d.w;
        }
      }
      store<TOut, kN, true>(dst + c0, r, kN);
    } else {
      float r[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        float acc = 0.f;
        if (j < n_valid) {
          float tap[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int k = 0; k < 4; ++k)
              tap[s][k] = Wide<TIn>::one(__ldg(
                  f + yoff[k >> 1][iy0 + (s >> 1)] +
                  xoff[k & 1][ix0 + (s & 1)] + j));
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int t = (iy0 + (s >> 1)) * kNs + ix0 + (s & 1);
            const float4 w = wts[t];
            float v = tap[s][0] * w.x + tap[s][1] * w.y + tap[s][2] * w.z +
                      tap[s][3] * w.w;
            v = inside[t] ? v : 0.f;
            acc = s == 0 ? v : acc + v;
          }
          acc = acc * 0.25f;
          if (dq != nullptr) acc = acc * dq[c0 + j];
        }
        r[j] = acc;
      }
      store<TOut, kN, false>(dst + c0, r, n_valid);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* f0, const void* f1, const void* f2, const void* f3,
           int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
           float s0, float s1, float s2, float s3, int L, int C,
           const float* boxes, const int* levels, int B, int P,
           const float* dequant, void* out, void* stream) {
  if (B * P == 0) return 0;
  constexpr int kN = Wide<TIn>::kN;
  Levels lv{{f0, f1, f2, f3}, {h0, h1, h2, h3}, {w0, w1, w2, w3},
            {s0, s1, s2, s3}};
  bool vec = C % kN == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(dequant) % 16 == 0;
  for (int i = 0; i < L; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(lv.feat[i]) % 16 == 0;
  const int groups = (C + kN - 1) / kN;
  const int lanes = min(Wide<TIn>::kLanes, groups);
  const int slices = (groups + lanes - 1) / lanes;
  const dim3 grid(B * P), block(kBins * lanes);
  auto* kernel = vec ? roi_align_kernel<TIn, TOut, true>
                     : roi_align_kernel<TIn, TOut, false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      lv, L, C, lanes, slices, boxes, levels, P, dequant,
      static_cast<TOut*>(out));
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
