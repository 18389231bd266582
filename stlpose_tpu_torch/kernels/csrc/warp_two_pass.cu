// K4: two-pass (Catmull-Smith) rotated crop warp for Hopper (sm_90a).
//
// Replaces stlpose_tpu/ops/pallas_warp.py::affine_warp_pallas (:156;
// kernel _warp_kernel launched by _pallas_warp_call), the warp that makes
// every rotated training crop of the device-warp input pipeline. It
// computes the same function as the Pallas kernel, which for rotated
// crops is not direct bilinear sampling (that is K2, warp.cu). With the
// per-crop row (u, r, txr, b, a, ty) of the conditioned inverse map,
// output pixel (x', y') is
//   Y  = b*x' + a*y' + ty,  y0 = floor(Y),  fy = Y - y0
//   h(y) = lerp of source row y at X(y) = u*x' - r*y + txr   (pass 1)
//   out  = h(y0)*(1 - fy) + h(y0 + 1)*fy                    (pass 2)
// where a lerp is g0*(1 - f) + g1*f and every tap outside [0, S) reads 0.
// The Pallas kernel materialises pass 1 for all S source rows and
// transposes it, because Mosaic only gathers inside a vreg; here each
// pixel computes just the two rows it needs. Built with --fmad=false, so
// each product and sum rounds where the plain PyTorch version's does.
//
// Conditioning: where |a| < |b| the reference turns the canvas by 90
// degrees (jnp.rot90, k = 1, axes (1, 2)) before the warp; the rotated
// canvas R has R[y][x] = I[x][S-1-y]. The kernel folds that into its
// indexing (params[6] != 0), so no turned copy is written.
//
// Bound: writing the crops (N*DH*DW*C*4 bytes) plus reading the canvas
// pixels under them; the canvases may be uint8 (the pipeline's wire
// format, converted exactly). Short of that, the time goes to the 12
// gathered single-byte tap loads per pixel and the exact f32 work around
// them: a warp's tap load touches one cache line per canvas row that its
// lanes reach. So:
// - a block per (crop, 32 x 32 output tile) on a 3-D grid, no division,
//   the crop's params read once per block; 8 warps, each making 4 lines
//   of 32 pixels;
// - a line runs along x' (lanes on neighbouring output columns), except
//   in a crop with the conditioning turn, where it runs along y': there
//   neighbouring lanes step along R's rows, that is along a row of I, so
//   a tap load of the warp reads neighbouring bytes instead of 32 canvas
//   rows 3*S bytes apart;
// - a pixel issues all its tap loads before the first use; C = 3 is
//   unrolled at compile time, any other C runs a loop;
// - a line along x' stores its pixels as it makes them (a warp's store is
//   one contiguous run); a turned crop's tile, whose lines run across the
//   output rows, is staged in shared memory and each of its rows written
//   with one bulk asynchronous copy (where DW*C is a multiple of 4 and
//   C <= 7; else it stores as it goes). Staging every tile this way
//   measured slower on the H100, as did copying each tile's canvas
//   footprint into shared memory first, more warps a block, and two
//   pixels in flight a thread (more registers, fewer warps resident).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // output tile: 32 x 32 pixels
constexpr int kWarps = 8;                 // 4 lines of 32 pixels a warp
constexpr int kMaxTileBytes = 32 * 1024;  // staged output tile (C <= 7)
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const uint8_t* p) {
  return (float)__ldg(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

struct Params {
  float u, r, txr, b, a, ty;
  bool swap;
};

// A pixel's taps: for rows k = 0, 1 (y0 + k) whether the row is inside,
// the element offset in the crop's canvas of taps x0 and x0 + 1 (-1
// outside) and their weights; fy.
struct Taps {
  bool row_ok[2];
  int off[2][2];
  float w0[2], w1[2];
  float fy;
};

__device__ __forceinline__ void taps(const Params& p, int S, int C, float gx,
                                     float gy, Taps& t) {
  const float Y = p.b * gx + p.a * gy + p.ty;
  const float y0f = floorf(Y);
  t.fy = Y - y0f;
  const float ux = p.u * gx;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float yf = y0f + (float)k;
    t.row_ok[k] = yf >= 0.f && yf <= (float)(S - 1);
    t.off[k][0] = t.off[k][1] = -1;
    t.w0[k] = t.w1[k] = 0.f;
    if (!t.row_ok[k]) continue;
    const int y = (int)yf;
    const float X = ux - p.r * yf + p.txr;
    const float x0f = floorf(X);
    const float fx = X - x0f;
    t.w0[k] = 1.f - fx;
    t.w1[k] = fx;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float xf = x0f + (float)e;
      if (xf >= 0.f && xf <= (float)(S - 1)) {
        const int x = (int)xf;
        // (y, x) of the conditioned canvas -> element offset in I
        t.off[k][e] = (p.swap ? x * S + (S - 1 - y) : y * S + x) * C;
      }
    }
  }
}

// One output pixel: every tap load first, then the plain version's sums;
// channels to d[0..C). A pixel that is not `on` (past the crop's edge)
// loads and stores nothing; it is predicated, not branched around, so
// the compiler may start one pixel's loads before the last one's stores.
template <int CT, typename T>
__device__ __forceinline__ void pixel(const T* __restrict__ src, int S,
                                      int C, const Params& p, float gx,
                                      float gy, bool on, float* d) {
  Taps t;
  taps(p, S, C, gx, gy, t);
  if (CT > 0) {
    float g[2][2][CT > 0 ? CT : 1];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int ch = 0; ch < CT; ++ch)
          g[k][e][ch] = on && t.off[k][e] >= 0
                            ? load(src + t.off[k][e] + ch) : 0.f;
    if (!on) return;
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) {
      float h[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        h[k] = t.row_ok[k] ? g[k][0][ch] * t.w0[k] + g[k][1][ch] * t.w1[k]
                           : 0.f;
      d[ch] = h[0] * (1.f - t.fy) + h[1] * t.fy;
    }
  } else {
    if (!on) return;
    for (int ch = 0; ch < C; ++ch) {
      float h[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float g[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          g[e] = t.off[k][e] >= 0 ? load(src + t.off[k][e] + ch) : 0.f;
        h[k] = t.row_ok[k] ? g[0] * t.w0[k] + g[1] * t.w1[k] : 0.f;
      }
      d[ch] = h[0] * (1.f - t.fy) + h[1] * t.fy;
    }
  }
}

// A block is 8 warps and owns crop k0 + blockIdx.z, output tile
// (blockIdx.x, blockIdx.y); warp w makes lines w, w + 8, w + 16, w + 24.
// A turned crop's lines run along y' and its tile is staged in shared
// memory, then written by rows with bulk copies (stage_ok: DW*C a
// multiple of 4 and the tile fits); other lines store as they go.
template <int CT, typename T>
__global__ void __launch_bounds__(kWarps * 32)
warp_two_pass_kernel(const T* __restrict__ images, int S, int C,
                     const float* __restrict__ params, int k0, int DH,
                     int DW, int stage_ok, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];  // the output tile
  __shared__ float s_par[7];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = k0 + blockIdx.z;
  const int tx0 = blockIdx.x * kTile, ty0 = blockIdx.y * kTile;
  const int tw = min(kTile, DW - tx0), th = min(kTile, DH - ty0);
  if (tid < 7) s_par[tid] = params[(long long)n * 8 + tid];
  __syncthreads();
  const Params p{s_par[0], s_par[1], s_par[2], s_par[3],
                 s_par[4], s_par[5], s_par[6] != 0.f};
  const T* src = images + (long long)n * S * S * C;
  const int nc = CT > 0 ? CT : C;
  const int pitch = kTile * nc + 4;  // tile row, floats; 16-byte multiple
  const bool cols = p.swap;          // block-uniform
  const bool staged = cols && stage_ok;

  for (int l = warp; l < kTile; l += kWarps) {
    const int x = cols ? l : lane, y = cols ? lane : l;
    float* d = staged ? smem + y * pitch + x * nc
                      : out + (((long long)n * DH + ty0 + y) * DW + tx0 + x) *
                                  nc;
    pixel<CT, T>(src, S, C, p, (float)(tx0 + x), (float)(ty0 + y),
                 x < tw && y < th, d);
  }

  if (staged) {
    // the tile's generic-proxy writes, then one async-proxy copy per row
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid < th) {
      const uint32_t bytes = (uint32_t)(tw * nc * 4);
      float* dst = out + (((long long)n * DH + ty0 + tid) * DW + tx0) * nc;
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(dst), "r"(smem_u32(smem + tid * pitch)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // shared memory must outlive the copy's reads
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int CT, typename T>
cudaError_t launch(const T* images, int N, int S, int C, const float* params,
                   int DH, int DW, float* out, cudaStream_t stream) {
  const size_t tile_bytes = (size_t)kTile * (kTile * C + 4) * 4;
  const int stage_ok = (DW * C) % 4 == 0 && tile_bytes <= kMaxTileBytes;
  const size_t smem = stage_ok ? tile_bytes : 0;
  auto kernel = warp_two_pass_kernel<CT, T>;
  const dim3 block(kWarps * 32);
  for (int k0 = 0; k0 < N; k0 += kMaxGridZ) {
    const dim3 grid((DW + kTile - 1) / kTile, (DH + kTile - 1) / kTile,
                    min(N - k0, kMaxGridZ));
    kernel<<<grid, block, smem, stream>>>(images, S, C, params, k0, DH, DW,
                                          stage_ok, out);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const T* images, int N, int S, int C, const float* params,
             int DH, int DW, float* out, void* stream) {
  if (N == 0 || DH == 0 || DW == 0 || C == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(C == 3 ? launch<3>(images, N, S, C, params, DH, DW, out, s)
                      : launch<0>(images, N, S, C, params, DH, DW, out, s));
}

}  // namespace

// Returns a cudaError_t.
extern "C" int warp_two_pass_u8_launch(const uint8_t* images, int N, int S,
                                       int C, const float* params, int DH,
                                       int DW, float* out, void* stream) {
  return dispatch(images, N, S, C, params, DH, DW, out, stream);
}

extern "C" int warp_two_pass_f32_launch(const float* images, int N, int S,
                                        int C, const float* params, int DH,
                                        int DW, float* out, void* stream) {
  return dispatch(images, N, S, C, params, DH, DW, out, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
