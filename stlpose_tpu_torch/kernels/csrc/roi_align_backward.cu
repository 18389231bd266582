// K3b: the gradient of multilevel FPN RoIAlign with respect to the feature
// maps, for Hopper (sm_90a): a deterministic gather, no atomics.
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
// index), w_tap the product of its two axis weights, rounded as the
// forward rounds it; each product is rounded as the plain version's
// autograd rounds it (built with --fmad=false). A box on no level of the
// pyramid adds nothing.
//
// Bound: bytes, the upstream gradient read once and the maps written once
// (at the training shape 102.8 + 108.9 MB). A scatter of f32 atomic adds
// (~408 M at that shape) would sum in an order that changes from run to
// run. Here every map element is summed by one thread and
// written once, its contributions in a fixed order: box index, then bin,
// then sample (y, x), then tap (00, 01, 10, 11). The result is the same
// bits on every run. Two launches:
// 1. roi_backward_footprint_kernel, a thread per box: the pixel range of
//    its taps on its level (min i0 .. max i1 of its inside samples; the
//    taps themselves fall on at most 28 columns and 28 rows whatever the
//    box's size), or level -1 if it has no inside sample or no level.
// 2. roi_backward_gather_kernel, a block of 8 warps per (image, level,
//    8 pixels of a row, 32 lanes of 8 adjacent channels, or of 1 where
//    C is not a multiple of 8): the block tests the image's
//    boxes 256 at a time against its pixels and keeps, in index order,
//    those that reach them; computes their 28 axis samples into shared
//    memory, 32 boxes at a time, and for each of its pixels' columns and
//    its row the range of samples whose taps hit it (contiguous: taps do
//    not decrease along an axis). Warp w owns pixel w: for each kept box,
//    bin by bin, it reads the bin's pooled gradient once (8 channels a
//    lane, a 1 KB line a warp; the next bin's load in flight meanwhile)
//    and, for each of the bin's samples in the row's and the column's
//    ranges, adds the products of the taps that hit the pixel to sums in
//    registers. Each pixel is stored once; pixels that no box reaches get
//    0, so the maps need no zero fill.
//
// On an H100 (NVIDIA H100 80GB HBM3, 700 W) it is bound by the latency of
// that walk and its per-sample bookkeeping, not by bytes: several times
// its byte bound (chip_smoke.py's K3b record).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kOut = 7;
constexpr int kSr = 2;
constexpr int kNs = kOut * kSr;  // samples along an axis
constexpr int kBins = kOut * kOut;
constexpr int kTile = 8;         // a gather block: 8 pixels of a row,
constexpr int kThreads = 32 * kTile;  // a warp each
constexpr int kBatch = 32;       // kept boxes whose samples are staged
constexpr int kPrepassThreads = 128;

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

// Sample s of box `bx` on its level (s < kNs: x, else y): its taps, -1 if
// the sample is not inside, and its fraction.
__device__ __forceinline__ void box_sample(const float* bx, float sc, int H,
                                           int W, int s, int2* taps,
                                           float* frac) {
  int i0, i1;
  bool inside;
  if (s < kNs)
    axis_sample(bx[0] * sc, bx[2] * sc, W, s, &i0, &i1, frac, &inside);
  else
    axis_sample(bx[1] * sc, bx[3] * sc, H, s - kNs, &i0, &i1, frac, &inside);
  *taps = inside ? make_int2(i0, i1) : make_int2(-1, -1);
}

__global__ void __launch_bounds__(kPrepassThreads)
    roi_backward_footprint_kernel(Levels lv, int L,
                                  const float* __restrict__ boxes,
                                  const int* __restrict__ levels, int n_boxes,
                                  int4* __restrict__ range,
                                  int* __restrict__ level_out) {
  const int box = blockIdx.x * blockDim.x + threadIdx.x;
  if (box >= n_boxes) return;
  const int l = levels[box];
  if (l < 0 || l >= L) {  // pooled zeros: no gradient
    level_out[box] = -1;
    return;
  }
  const int H = pick(lv.h, l), W = pick(lv.w, l);
  const float sc = pick(lv.scale, l);
  const float* bx = boxes + box * 4;
  int lo[2] = {0x7fffffff, 0x7fffffff}, hi[2] = {-1, -1};
  for (int s = 0; s < 2 * kNs; ++s) {
    int2 t;
    float f;
    box_sample(bx, sc, H, W, s, &t, &f);
    const int a = s < kNs ? 0 : 1;
    if (t.x >= 0) {
      lo[a] = min(lo[a], t.x);
      hi[a] = max(hi[a], t.y);
    }
  }
  range[box] = make_int4(lo[0], hi[0], lo[1], hi[1]);
  level_out[box] = hi[0] < 0 || hi[1] < 0 ? -1 : l;
}

// VEC adjacent channels of one pixel: load (from g, read-only) and add
// v * w to a thread's sums, one rounding per product and per sum.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void add_vec(float (&a)[VEC], const float (&v)[VEC],
                                        float w) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) a[e] += v[e] * w;
}

// The range [lo, hi] of the samples of one axis (taps[0..kNs)) whose taps
// hit pixel `pix`, (1, 0) if none: a contiguous range, since a sample's
// taps do not decrease along the axis and the inside samples are
// contiguous.
__device__ __forceinline__ int2 sample_range(const int2* taps, int pix) {
  int lo = kNs, hi = -1;
  for (int s = 0; s < kNs; ++s)
    if (taps[s].x == pix || taps[s].y == pix) {
      lo = min(lo, s);
      hi = s;
    }
  return lo <= hi ? make_int2(lo, hi) : make_int2(1, 0);
}

// The ranges of a kept box on a tile: the x samples whose taps hit each
// of its pixels, then the y samples whose taps hit its row.
using Ranges = int2[kTile + 1];

// A warp's walk over the (kept box k, bin (by, bx)) pairs whose samples
// hit its pixel: boxes in order, bins row by row within the box's ranges
// for the pixel.
struct BinWalk {
  int k, by, bx, bx0, bx1, by1;

  __device__ __forceinline__ bool first(const Ranges* rng, int col,
                                        int k_from, int nb) {
    for (k = k_from; k < nb; ++k) {
      const int2 xr = rng[k][col], yr = rng[k][kTile];
      if (xr.x > xr.y || yr.x > yr.y) continue;
      by = yr.x / kSr;
      by1 = yr.y / kSr;
      bx = bx0 = xr.x / kSr;
      bx1 = xr.y / kSr;
      return true;
    }
    return false;
  }

  __device__ __forceinline__ bool next(const Ranges* rng, int col, int nb) {
    if (++bx <= bx1) return true;
    bx = bx0;
    if (++by <= by1) return true;
    return first(rng, col, k + 1, nb);
  }

  // The bin's pooled gradient for channel c of box `box`.
  __device__ __forceinline__ const float* at(const float* grad_out, int box,
                                             int C, int c) const {
    return grad_out + ((long long)box * kBins + by * kOut + bx) * C + c;
  }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    roi_backward_gather_kernel(Levels lv, int L, int C, const float* boxes,
                               int P, const int4* __restrict__ range,
                               const int* __restrict__ level_of,
                               const float* __restrict__ grad_out) {
  __shared__ int2 s_taps[kBatch][2 * kNs];  // x samples, then y samples
  __shared__ float2 s_w[kBatch][2 * kNs];   // tap weights (1 - f, f)
  __shared__ Ranges s_rng[kBatch];
  __shared__ int s_box[kThreads];           // a round's kept boxes, in order
  __shared__ int s_count[kThreads / 32];

  // blockIdx.x -> (image, level, tile)
  int tiles = 0;
  for (int l = 0; l < L; ++l)
    tiles += pick(lv.h, l) * ((pick(lv.w, l) + kTile - 1) / kTile);
  const int img = blockIdx.x / tiles;
  int t = blockIdx.x % tiles, l = 0;
  int H = 0, W = 0, tw = 0;
  for (;; ++l) {
    H = pick(lv.h, l);
    W = pick(lv.w, l);
    tw = (W + kTile - 1) / kTile;
    if (t < H * tw) break;
    t -= H * tw;
  }
  const int py = t / tw, x0 = (t % tw) * kTile;
  const float sc = pick(lv.scale, l);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warp w: pixel (py, x0 + w); lane: VEC channels
  const int px = x0 + warp;
  const int c = (blockIdx.y * 32 + lane) * VEC;
  const bool has_c = c < C;  // C % VEC == 0
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;

  // rounds of kThreads boxes, one a thread; the boxes that reach the tile
  // are kept in index order
  for (int r0 = 0; r0 < P; r0 += kThreads) {
    const int box = img * P + r0 + tid;
    bool hit = false;
    if (r0 + tid < P && level_of[box] == l) {
      const int4 q = range[box];
      hit = q.y >= x0 && q.x < x0 + kTile && q.w >= py && q.z <= py;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(bal);
    __syncthreads();
    int kept = 0, off = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      off += w < warp ? s_count[w] : 0;
      kept += s_count[w];
    }
    if (hit) s_box[off + __popc(bal & ((1u << lane) - 1))] = box;
    __syncthreads();

    for (int k0 = 0; k0 < kept; k0 += kBatch) {
      const int nb = min(kBatch, kept - k0);
      for (int i = tid; i < nb * 2 * kNs; i += kThreads) {
        const int k = i / (2 * kNs), s = i % (2 * kNs);
        float f;
        box_sample(boxes + s_box[k0 + k] * 4, sc, H, W, s, &s_taps[k][s],
                   &f);
        s_w[k][s] = make_float2(1.f - f, f);
      }
      __syncthreads();
      for (int i = tid; i < nb * (kTile + 1); i += kThreads) {
        const int k = i / (kTile + 1), j = i % (kTile + 1);
        s_rng[k][j] = j < kTile ? sample_range(s_taps[k], x0 + j)
                                : sample_range(s_taps[k] + kNs, py);
      }
      __syncthreads();
      // the warp walks its (kept box, bin) pairs in order, bin by bin: one
      // load of a bin's pooled gradient serves all its samples that hit
      // the pixel, and the next bin's load is in flight while this one is
      // summed
      BinWalk cur;
      bool more = has_c && cur.first(s_rng, warp, 0, nb);
      float vn[VEC];
      if (more) load_vec<VEC>(cur.at(grad_out, s_box[k0 + cur.k], C, c), vn);
      while (more) {
        const BinWalk it = cur;
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = vn[e] * 0.25f;
        more = cur.next(s_rng, warp, nb);
        if (more)
          load_vec<VEC>(cur.at(grad_out, s_box[k0 + cur.k], C, c), vn);
        const int k = it.k;
        const int2 xr = s_rng[k][warp], yr = s_rng[k][kTile];
        const int sxa = max(xr.x, kSr * it.bx);
        const int sxb = min(xr.y, kSr * it.bx + 1);
        const int sya = max(yr.x, kSr * it.by);
        const int syb = min(yr.y, kSr * it.by + 1);
        for (int sy = sya; sy <= syb; ++sy) {
          const int2 ty = s_taps[k][kNs + sy];
          const float2 wy = s_w[k][kNs + sy];
          const bool y0m = ty.x == py, y1m = ty.y == py;
          for (int sx = sxa; sx <= sxb; ++sx) {
            const int2 tx = s_taps[k][sx];
            const float2 wx = s_w[k][sx];
            const bool x0m = tx.x == px, x1m = tx.y == px;
            if ((x0m && x1m) || (y0m && y1m)) {  // two taps here (clamped)
              if (y0m && x0m) add_vec<VEC>(acc, v, wx.x * wy.x);
              if (y0m && x1m) add_vec<VEC>(acc, v, wx.y * wy.x);
              if (y1m && x0m) add_vec<VEC>(acc, v, wx.x * wy.y);
              if (y1m && x1m) add_vec<VEC>(acc, v, wx.y * wy.y);
            } else {  // the one tap of the sample on this pixel
              add_vec<VEC>(acc, v, (x0m ? wx.x : wx.y) * (y0m ? wy.x : wy.y));
            }
          }
        }
      }
      __syncthreads();  // s_taps, s_w and s_rng are rewritten next
    }
  }

  if (!has_c || px >= W) return;
  float* dst = pick(lv.grad, l) + (((long long)img * H + py) * W + px) * C + c;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  } else {
    dst[0] = acc[0];
  }
}

}  // namespace

// Bytes of the scratch that roi_align_backward_f32 takes for n_boxes boxes.
extern "C" long long roi_align_backward_scratch_bytes(int n_boxes) {
  return (long long)n_boxes * (sizeof(int4) + sizeof(int));
}

// d_maps (B, h_l, w_l, C) f32 per level, every element written: the
// gradient of K3's f32 pooling of boxes (B, P, 4) at levels (B, P) int32,
// from grad_out (B, P, 7, 7, C) f32; scratch of
// roi_align_backward_scratch_bytes(B * P) bytes, 16-byte aligned. Two
// launches. Returns a cudaError_t.
extern "C" int roi_align_backward_f32(
    void* g0, void* g1, void* g2, void* g3, int h0, int w0, int h1, int w1,
    int h2, int w2, int h3, int w3, float s0, float s1, float s2, float s3,
    int L, int C, const float* boxes, const int* levels, int B, int P,
    const float* grad_out, void* scratch, void* stream) {
  if (B == 0 || C == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  Levels lv{{static_cast<float*>(g0), static_cast<float*>(g1),
             static_cast<float*>(g2), static_cast<float*>(g3)},
            {h0, h1, h2, h3},
            {w0, w1, w2, w3},
            {s0, s1, s2, s3}};
  const int n_boxes = B * P;
  int4* range = static_cast<int4*>(scratch);
  int* level_of = reinterpret_cast<int*>(range + n_boxes);
  if (n_boxes > 0) {
    roi_backward_footprint_kernel<<<(n_boxes + kPrepassThreads - 1) /
                                        kPrepassThreads,
                                    kPrepassThreads, 0, s>>>(
        lv, L, boxes, levels, n_boxes, range, level_of);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  long long tiles = 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3}, ws[kMaxLevels] = {w0, w1, w2,
                                                                 w3};
  for (int l = 0; l < L; ++l)
    tiles += (long long)hs[l] * ((ws[l] + kTile - 1) / kTile);
  if (tiles == 0) return 0;
  if (tiles * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 8 adjacent channels a lane (two 16-byte accesses) where C allows
  const int vec = C % 8 == 0 ? 8 : 1;
  const dim3 grid((unsigned)(tiles * B), (C + 32 * vec - 1) / (32 * vec));
  if (vec == 8)
    roi_backward_gather_kernel<8><<<grid, kThreads, 0, s>>>(
        lv, L, C, boxes, P, range, level_of, grad_out);
  else
    roi_backward_gather_kernel<1><<<grid, kThreads, 0, s>>>(
        lv, L, C, boxes, P, range, level_of, grad_out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
