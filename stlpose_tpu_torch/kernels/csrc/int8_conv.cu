// Int8 x int8 -> int32 convolution with its dequantize epilogue (K6) and
// the per-tensor activation quantizer in front of it (K6q), for Hopper
// (sm_90a).
//
// No Pallas original: they replace the int8 serving path of
// stlpose_tpu/models/hrnet.py::ConvBN (quant "int8" and "int8u",
// hrnet.py:94-137), which XLA runs as conv_general_dilated on int8
// operands with int32 accumulation. PyTorch on CUDA has no int8 x int8 ->
// int32 convolution, and an f32 convolution of the integer codes is not
// exact once |acc| passes 2^24 (K = 3*3*512 products of up to 127*128).
//
// K6q, act_quant_kernel: NCHW f32 or bf16 activations -> NHWC int8 codes,
//   q = clip(rint(x / sx), lo, hi) - zp, a true f32 division and round half
//   to even (the "signed" flavor: lo -127, hi 127, zp 0). A block
//   transposes a 32-channel x 32-pixel tile through shared memory, so both
//   the read (along the pixels) and the write (along the channels) run
//   along contiguous addresses. Bound: bytes (the input read once, a
//   quarter or half of it written).
//
// K6, int8_conv_kernel: an implicit GEMM. M = N*Ho*Wo output pixels,
//   N = C_out, K = kh*kw*C_in taps x channels, padded with zero weights to
//   a multiple of 32. The activations are int8 NHWC, so a K slice of 16 is
//   16 contiguous bytes of one tap when C_in % 16 == 0 (one 16-byte load);
//   other C_in (HRNet's 3-channel stem) gather byte by byte. Weights are
//   int8 (C_out, Kpad), re-laid once at quantize time in (C_out, kh, kw,
//   C_in) order. A block of 4 warps takes a 64 x 64 output tile; each k
//   step stages a 64 x 32 slice of A and of B in shared memory (rows of 48
//   bytes, so the fragment loads hit 32 distinct banks), double-buffered
//   with the next slice's global loads in registers, and each warp runs 8
//   mma.sync.m16n8k32 s8 x s8 -> s32 on its 32 x 32 quarter. Taps outside
//   the image read the pad value: 0 for "int8", -zp for "int8u". The
//   epilogue: (float)acc * (sx * sw[o]) + bias[o] (the product sx * sw[o]
//   rounded first, as XLA forms the vector sx * sw; no FMA: the library is
//   built with --fmad=false), optional ReLU, then f32 or bf16 (round to
//   nearest even), written NCHW. Bound: int8 tensor-core operations or
//   bytes, whichever is longer; this first design has no TMA, no wgmma and
//   one stage of prefetch, and is not expected near either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output pixels of a block tile
constexpr int kBN = 64;        // output channels of a block tile
constexpr int kBK = 32;        // K of one mma and one shared-memory stage
constexpr int kRow = 48;       // bytes per staged row: 32 data + 16 pad
constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kTile = 32;      // K6q's transpose tile

struct Conv {
  const int8_t* x;      // (N, H, W, C) int8
  const int8_t* w;      // (O, Kpad) int8
  const float* sx;      // () activation scale
  const float* sw;      // (O,) weight scales
  const float* bias;    // (O,)
  const float* zp;      // () zero point ("int8u"), or null ("int8")
  int N, H, W, C, O, Ho, Wo, k, stride, pad, K, Kpad;
  int M;                // N * Ho * Wo
  int relu;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 activation bytes of K indices k..k+15 for one output pixel
// (image n, top-left tap iy0, ix0); valid == false gives zeros.
template <bool kVec>
__device__ __forceinline__ uint4 load_a(const Conv& p, uint32_t pad4,
                                        bool valid, int n, int iy0, int ix0,
                                        int k) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return v;
  if (kVec) {
    if (k >= p.K) return v;
    const int tap = k / p.C;
    const int ci = k - tap * p.C;
    const int ky = tap / p.k;
    const int iy = iy0 + ky;
    const int ix = ix0 + (tap - ky * p.k);
    if (iy < 0 || iy >= p.H || ix < 0 || ix >= p.W)
      return make_uint4(pad4, pad4, pad4, pad4);
    return *reinterpret_cast<const uint4*>(
        p.x + (((long long)n * p.H + iy) * p.W + ix) * p.C + ci);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const uint32_t pad = pad4 & 0xffu;
  for (int j = 0; j < 16; ++j) {
    const int kk = k + j;
    if (kk >= p.K) break;
    const int tap = kk / p.C;
    const int ci = kk - tap * p.C;
    const int ky = tap / p.k;
    const int iy = iy0 + ky;
    const int ix = ix0 + (tap - ky * p.k);
    uint32_t byte = pad;
    if (iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
      byte = (uint8_t)p.x[(((long long)n * p.H + iy) * p.W + ix) * p.C + ci];
    w[j >> 2] |= byte << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename Out>
__device__ __forceinline__ Out to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kVec, typename Out>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(Conv p, Out* __restrict__ out) {
  __shared__ __align__(16) uint8_t As[2][kBM * kRow];
  __shared__ __align__(16) uint8_t Bs[2][kBN * kRow];
  const int tid = threadIdx.x;
  // the pad byte -zp (0 without a zero point), four times
  const uint32_t pad4 =
      p.zp ? (uint32_t)(uint8_t)(int8_t)(int)(-*p.zp) * 0x01010101u : 0u;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread stages row tid / 2 of both slices, bytes (tid % 2) * 16..
  const int row = tid >> 1;
  const int half = (tid & 1) * 16;
  const int m = m0 + row;
  const bool m_ok = m < p.M;
  int n = 0, iy0 = 0, ix0 = 0;
  if (m_ok) {
    const int hw = p.Ho * p.Wo;
    n = m / hw;
    const int r = m - n * hw;
    const int oy = r / p.Wo;
    iy0 = oy * p.stride - p.pad;
    ix0 = (r - oy * p.Wo) * p.stride - p.pad;
  }
  const int o_row = n0 + row;
  const bool o_ok = o_row < p.O;
  const int8_t* wrow = p.w + (long long)o_row * p.Kpad + half;

  const int nk = p.Kpad / kBK;
  uint4 a_next = load_a<kVec>(p, pad4, m_ok, n, iy0, ix0, half);
  uint4 b_next = o_ok ? *reinterpret_cast<const uint4*>(wrow)
                      : make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<uint4*>(&As[0][row * kRow + half]) = a_next;
  *reinterpret_cast<uint4*>(&Bs[0][row * kRow + half]) = b_next;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 4;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      const int k = (kt + 1) * kBK + half;
      a_next = load_a<kVec>(p, pad4, m_ok, n, iy0, ix0, k);
      b_next = o_ok ? *reinterpret_cast<const uint4*>(wrow + (kt + 1) * kBK)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    const uint8_t* A = As[buf];
    const uint8_t* Bt = Bs[buf];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = A + (wm + i * 16 + g) * kRow + t4;
      const uint8_t* r1 = r0 + 8 * kRow;
      a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[i][1] = *reinterpret_cast<const uint32_t*>(r1);
      a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* c0 = Bt + (wn + j * 8 + g) * kRow + t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
    if (more) {
      *reinterpret_cast<uint4*>(&As[buf ^ 1][row * kRow + half]) = a_next;
      *reinterpret_cast<uint4*>(&Bs[buf ^ 1][row * kRow + half]) = b_next;
    }
    __syncthreads();
  }

  // epilogue: acc * (sx * sw[o]) + bias[o], ReLU, NCHW store
  const float sx = *p.sx;
  const int hw = p.Ho * p.Wo;
  const int l2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m0 + wm + i * 16 + g + h * 8;
      if (mm >= p.M) continue;
      const int nb = mm / hw;
      const long long pix = (long long)nb * p.O * hw + (mm - nb * hw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = n0 + wn + j * 8 + l2 + c;
          if (o >= p.O) continue;
          const float s = sx * p.sw[o];
          float v = (float)acc[i][j][h * 2 + c] * s + p.bias[o];
          if (p.relu) v = fmaxf(v, 0.0f);
          out[pix + (long long)o * hw] = to_out<Out>(v);
        }
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ float as_f32(T v);
template <>
__device__ __forceinline__ float as_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// grid (pixel tiles, channel tiles, N), block (32, 8)
template <typename T>
__global__ void act_quant_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q, int C, int HW,
                                const float* sx_p, const float* zp_p,
                                const float* lo_p, const float* hi_p) {
  __shared__ int8_t tile[kTile][kTile + 4];
  const float sx = *sx_p;
  const float zp = zp_p ? *zp_p : 0.0f;
  const float lo = lo_p ? *lo_p : -127.0f;
  const float hi = hi_p ? *hi_p : 127.0f;
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const T* xn = x + (long long)n * C * HW;
  const int pix = p0 + threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int c = c0 + r;
    int8_t v = 0;
    if (c < C && pix < HW) {
      float f = as_f32<T>(xn[(long long)c * HW + pix]) / sx;
      f = fminf(fmaxf(rintf(f), lo), hi) - zp;
      v = (int8_t)(int)f;
    }
    tile[r][threadIdx.x] = v;
  }
  __syncthreads();
  int8_t* qn = q + (long long)n * HW * C;
  const int c = c0 + threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y) {
    const int pp = p0 + r;
    if (c < C && pp < HW) qn[(long long)pp * C + c] = tile[threadIdx.x][r];
  }
}

template <typename Out>
int conv_launch(const int8_t* x, const int8_t* w, const float* sx,
                const float* sw, const float* bias, const float* zp,
                int N, int H, int W, int C, int O, int k, int stride,
                int relu, void* out, void* stream) {
  Conv p;
  p.x = x; p.w = w; p.sx = sx; p.sw = sw; p.bias = bias;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O; p.k = k;
  p.stride = stride; p.pad = k / 2;
  p.Ho = (H + 2 * p.pad - k) / stride + 1;
  p.Wo = (W + 2 * p.pad - k) / stride + 1;
  p.K = k * k * C;
  p.Kpad = (p.K + kBK - 1) / kBK * kBK;
  p.M = N * p.Ho * p.Wo;
  p.relu = relu;
  p.zp = zp;
  dim3 grid((p.M + kBM - 1) / kBM, (O + kBN - 1) / kBN);
  cudaStream_t st = (cudaStream_t)stream;
  Out* o = static_cast<Out*>(out);
  if (C % 16 == 0)
    int8_conv_kernel<true, Out><<<grid, kThreads, 0, st>>>(p, o);
  else
    int8_conv_kernel<false, Out><<<grid, kThreads, 0, st>>>(p, o);
  return (int)cudaGetLastError();
}

template <typename T>
int quantize_launch(const void* x, void* q, int N, int C, int HW,
                    const float* sx, const float* zp, const float* lo,
                    const float* hi, void* stream) {
  dim3 grid((HW + kTile - 1) / kTile, (C + kTile - 1) / kTile, N);
  act_quant_kernel<T><<<grid, dim3(kTile, 8), 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), C, HW, sx, zp, lo,
      hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int8_conv_f32(const int8_t* x, const int8_t* w,
                             const float* sx, const float* sw,
                             const float* bias, const float* zp, int N, int H,
                             int W, int C, int O, int k, int stride, int relu,
                             void* out, void* stream) {
  return conv_launch<float>(x, w, sx, sw, bias, zp, N, H, W, C, O, k, stride,
                            relu, out, stream);
}

extern "C" int int8_conv_bf16(const int8_t* x, const int8_t* w,
                              const float* sx, const float* sw,
                              const float* bias, const float* zp, int N,
                              int H, int W, int C, int O, int k, int stride,
                              int relu, void* out, void* stream) {
  return conv_launch<__nv_bfloat16>(x, w, sx, sw, bias, zp, N, H, W, C, O, k,
                                    stride, relu, out, stream);
}

extern "C" int quantize_activations_f32(const void* x, void* q, int N, int C,
                                        int HW, const float* sx,
                                        const float* zp, const float* lo,
                                        const float* hi, void* stream) {
  return quantize_launch<float>(x, q, N, C, HW, sx, zp, lo, hi, stream);
}

extern "C" int quantize_activations_bf16(const void* x, void* q, int N,
                                         int C, int HW, const float* sx,
                                         const float* zp, const float* lo,
                                         const float* hi, void* stream) {
  return quantize_launch<__nv_bfloat16>(x, q, N, C, HW, sx, zp, lo, hi,
                                        stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
