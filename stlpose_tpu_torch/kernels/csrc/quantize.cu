// Symmetric int8 quantization of an FPN pyramid for Hopper (sm_90a).
//
// Replaces the quantize prologue of stlpose_tpu/ops/pallas_roi.py::
// multilevel_roi_align_pallas_batched(patch_quant=True) (pallas_roi.py:
// 417-429, XLA ops in front of the Pallas RoIAlign): per (level, channel)
// over B, h and w, s = max(absmax, 1e-8) / 127 and q = clip(rint(x / s),
// -127, 127), in f32, for float32 or bfloat16 levels (B, h, w, C), all
// levels in one launch of each of two kernels:
//
//   absmax:   each thread keeps the running |x| maximum of one group of
//             channels over a block's run of pixels (16-byte loads), the
//             block reduces them in shared memory and merges them into a
//             zeroed (L, C) buffer with atomicMax on the bit pattern of the
//             non-negative f32 (max is order-free, so this is exact);
//   quantize: each block computes its level's scales from that buffer
//             (IEEE f32 divisions; a level's first block writes them out),
//             then each thread turns 16 elements into one 16-byte int8
//             store: x / s as a true division, rintf (half to even), the
//             clamp, and the low byte of r + 1.5 * 2^23 as the int8. Blocks
//             walk the pyramid in the reverse of the absmax pass's order, so
//             the first ones read what that pass left in L2.
//
// Bound: the pyramid read once, plus what of it the 50 MB L2 cannot keep
// for the second pass (the absmax completes before the first element is
// quantized), plus the int8 pyramid written. A pixel's channels start on 16
// bytes: C is a multiple of 16 and the maps are 16-byte aligned (the
// wrapper refuses anything else).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
constexpr int kAbsmaxIters = 16;   // pixel rows per thread in the absmax
constexpr int kQuantItems = 2;     // 16-element items per quantize thread

struct Pyramid {
  const void* x[kMaxLevels];
  int8_t* q[kMaxLevels];
  long long pixels[kMaxLevels];   // B * h * w
  int first_block[kMaxLevels + 1];
};

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int kN = 4;   // per 16 bytes
  __device__ __forceinline__ static float at(const uint4& v, int j) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    return __uint_as_float(w[j]);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float at(const uint4& v, int j) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const uint32_t x = w[j >> 1];
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};

// Field l of a per-level array of the kernel's parameters (selects, not a
// local copy of the array).
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// The level of block b: the number of later levels' first blocks <= b.
__device__ __forceinline__ int level_of(const int (&first)[kMaxLevels + 1],
                                        int L, int b) {
  return (L > 1 && b >= first[1]) + (L > 2 && b >= first[2]) +
         (L > 3 && b >= first[3]);
}

// Block of `groups * rows` threads: thread (row, group) takes channels
// [group * kN, group * kN + kN) of pixels row, row + rows, ... of the block's
// run of rows * kAbsmaxIters pixels. absmax: (L, C) f32 bits, zeroed.
template <typename T>
__global__ void absmax_kernel(Pyramid p, int L, int C, int groups, int rows,
                              unsigned int* __restrict__ absmax) {
  constexpr int kN = Elem<T>::kN;
  extern __shared__ float part[];   // [rows][groups * kN]
  const int l = level_of(p.first_block, L, blockIdx.x);
  const int first = pick(p.first_block, l);
  const long long run = (long long)rows * kAbsmaxIters;
  const long long p0 = (blockIdx.x - first) * run;
  const long long p1 = min(p0 + run, pick(p.pixels, l));
  const int group = threadIdx.x % groups, row = threadIdx.x / groups;
  const T* x = static_cast<const T*>(pick(p.x, l)) + group * kN;
  float m[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) m[j] = 0.f;
  uint4 v[kAbsmaxIters];   // every load of the thread in flight at once
#pragma unroll
  for (int it = 0; it < kAbsmaxIters; ++it) {
    const long long px = p0 + row + (long long)it * rows;
    v[it] = px < p1 ? __ldg(reinterpret_cast<const uint4*>(x + px * C))
                    : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int it = 0; it < kAbsmaxIters; ++it)
#pragma unroll
    for (int j = 0; j < kN; ++j)
      m[j] = fmaxf(m[j], fabsf(Elem<T>::at(v[it], j)));
#pragma unroll
  for (int j = 0; j < kN; ++j) part[row * groups * kN + group * kN + j] = m[j];
  __syncthreads();
  for (int c = threadIdx.x; c < groups * kN; c += blockDim.x) {
    float v = part[c];
    for (int r = 1; r < rows; ++r) v = fmaxf(v, part[r * groups * kN + c]);
    atomicMax(absmax + l * C + c, __float_as_uint(v));
  }
}

// r: an integer in [-127, 127] held in a float; its int8 bit pattern is the
// low byte of r + 1.5 * 2^23.
__device__ __forceinline__ uint32_t int8_bits(float r) {
  return __float_as_uint(r + 12582912.0f) & 0xffu;
}

__device__ __forceinline__ float quantize(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// Items of 16 consecutive elements of a level; block b takes the run of
// kThreads * kQuantItems items counted from the end of the pyramid.
template <typename T>
__global__ void quantize_kernel(Pyramid p, int L, int C, int nblocks,
                                const float* __restrict__ absmax,
                                float* __restrict__ scales) {
  extern __shared__ float s[];   // [C]
  const int b = nblocks - 1 - blockIdx.x;
  const int l = level_of(p.first_block, L, b);
  const int first = pick(p.first_block, l);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s[c] = fmaxf(absmax[l * C + c], 1e-8f) / 127.0f;
    if (b == first) scales[l * C + c] = s[c];
  }
  __syncthreads();
  const long long n = pick(p.pixels, l) * C;   // elements of the level
  const long long i0 = (long long)(b - first) * kThreads * kQuantItems;
  const T* x = static_cast<const T*>(pick(p.x, l));
  int8_t* q = pick(p.q, l);
  // every load of the thread in flight before its first int8 store (a
  // store through int8_t* could alias them otherwise)
  constexpr int kN = Elem<T>::kN, kV = 16 / kN;
  uint4 v[kQuantItems][kV];
#pragma unroll
  for (int k = 0; k < kQuantItems; ++k) {
    const long long e = (i0 + k * kThreads + threadIdx.x) * 16;
    if (e < n)
#pragma unroll
      for (int u = 0; u < kV; ++u)
        v[k][u] = __ldg(reinterpret_cast<const uint4*>(x + e) + u);
  }
#pragma unroll
  for (int k = 0; k < kQuantItems; ++k) {
    const long long e = (i0 + k * kThreads + threadIdx.x) * 16;
    if (e >= n) break;
    const int c = (int)(e % C);
    uint32_t w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      uint32_t b4 = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = u * 4 + j;
        b4 |= int8_bits(quantize(Elem<T>::at(v[k][i / kN], i % kN),
                                 s[c + i])) << (8 * j);
      }
      w[u] = b4;
    }
    *reinterpret_cast<uint4*>(q + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
int launch(const void* x0, const void* x1, const void* x2, const void* x3,
           long long n0, long long n1, long long n2, long long n3, int L,
           int C, void* q0, void* q1, void* q2, void* q3, void* absmax,
           float* scales, void* stream) {
  Pyramid p{{x0, x1, x2, x3},
            {static_cast<int8_t*>(q0), static_cast<int8_t*>(q1),
             static_cast<int8_t*>(q2), static_cast<int8_t*>(q3)},
            {n0, n1, n2, n3},
            {0}};
  const int n = Elem<T>::kN;
  const int groups = C / n;
  const int rows = max(1, kThreads / groups);
  const long long run = (long long)rows * kAbsmaxIters;
  const long long items = kThreads * kQuantItems;
  int first2[kMaxLevels + 1] = {0};
  for (int i = 0; i < L; ++i) {
    p.first_block[i + 1] = p.first_block[i] + (int)((p.pixels[i] + run - 1) / run);
    const long long n_items = p.pixels[i] * C / 16;
    first2[i + 1] = first2[i] + (int)((n_items + items - 1) / items);
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem1 = (size_t)rows * groups * n * sizeof(float);
  absmax_kernel<T><<<p.first_block[L], groups * rows, smem1, st>>>(
      p, L, C, groups, rows, static_cast<unsigned int*>(absmax));
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // the quantize pass counts its blocks per level on its own item runs
  for (int i = 0; i <= L; ++i) p.first_block[i] = first2[i];
  quantize_kernel<T><<<first2[L], kThreads, C * sizeof(float), st>>>(
      p, L, C, first2[L], static_cast<const float*>(absmax), scales);
  return (int)cudaGetLastError();
}

}  // namespace

// One C entry per level type: both kernels, in order, on one stream.
#define QUANTIZE_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x0, const void* x1, const void* x2,        \
                      const void* x3, long long n0, long long n1,            \
                      long long n2, long long n3, int L, int C, void* q0,    \
                      void* q1, void* q2, void* q3, void* absmax,            \
                      float* scales, void* stream) {                         \
    return launch<T>(x0, x1, x2, x3, n0, n1, n2, n3, L, C, q0, q1, q2, q3,   \
                     absmax, scales, stream);                                \
  }

QUANTIZE_ENTRY(quantize_levels_f32, float)
QUANTIZE_ENTRY(quantize_levels_bf16, __nv_bfloat16)

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
