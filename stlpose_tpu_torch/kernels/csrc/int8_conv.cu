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
// K6 is an implicit GEMM: M = N*Ho*Wo output pixels, N = C_out, K =
// kh*kw*C_in taps x channels, padded with zero weights to Kpad, a multiple
// of 32. The codes are int8 NHWC (K-contiguous per pixel), the weights
// int8 (C_out, Kpad) in (C_out, kh, kw, C_in) order (K-contiguous per
// channel): both are K-major as they lie, as wgmma wants 8-bit operands.
// Taps outside the image read the pad byte: 0 for "int8", -zp for
// "int8u". The epilogue: (float)acc * (sx * sw[o]) + bias[o] (the product
// sx * sw[o] rounded first, as XLA forms the vector sx * sw; no FMA), an
// optional ReLU, then f32 or bf16 (round to nearest even), NCHW.
//
// K6, int8_conv_wgmma_kernel (C_in % 16 == 0: every convolution of the
//   ResNet trunk and of HRNet but HRNet's 3-channel stem). Replaces PR
//   15's mma.sync kernel (below) on those shapes. A block is one or two
//   consumer warpgroups (BM = 64 or 128 output pixels, over BN = 32, 64
//   or 128 output channels) and one producer warpgroup. Blocks are
//   persistent (as many as fit on the SMs), each walking output tiles
//   pixels first. The operands go through a ring of kStages = 4 stages in
//   shared memory, each 128 bytes of K deep (one 128-byte-swizzled row
//   per pixel and per channel); producer warp w fills slot w, completes it
//   on its "full" mbarrier and waits for its "empty" one, so the four
//   slots are in flight independently and run on across tiles:
//   - weights (B) by TMA, a 2-D tensor map over (C_out, Kpad) with the
//     128-byte swizzle; the box past Kpad or past C_out reads zeros;
//   - codes (A) of a 1x1 stride-1 convolution, a plain (M, C_in) matrix,
//     by TMA too (rows past M and columns past C_in read zeros);
//   - codes of a 3x3 or strided convolution gathered by the slot's warp,
//     one 16-byte cp.async per (pixel, tap, 16 channels), 8 lanes to a
//     pixel's 128 bytes, into the same swizzled layout; each pixel's tap-0
//     offset and in-image taps come from a table the warp writes in
//     shared memory once per tile. A tap outside the image gets the pad
//     word stored directly (never cp.async's or TMA's zero fill, since
//     int8u pads with -zp), as do K past K and pixels past M. The warp
//     waits for its copies, fences them to the async proxy and arrives.
//   The consumers run wgmma.mma_async m64nBNk32 s32.s8.s8 from shared
//   memory, 4 a stage, the first product of a tile overwriting the
//   accumulator, and hand each slot back when its products are done. The
//   epilogue dequantizes the accumulator in registers, stages the tile in
//   shared memory channel-major (its own buffer, so the producers load the
//   next tile meanwhile), and stores NCHW: a thread keeps one run of 16
//   bytes of pixels and walks the channels, so each warp writes
//   contiguous runs of one channel's pixels, 16 bytes a thread where the
//   image's pixel count keeps every run aligned, element by element
//   otherwise and at image boundaries and the M tail.
//   Tiles (chosen per convolution in wgmma_conv): BN = 32 for C_out <=
//   32, 64 for <= 64, else 128; BM = 128 when that gives at least one
//   wave of 132 tiles, else BM = 64 and, if still under a wave, BN <= 64.
//   No split-K: the smaller tiles give the trunk's smallest layer (M =
//   1,352, K = 4,608) 176 tiles and HRNet's branch 3 (M = 3,072) 192.
//   Bound: bytes (the codes read once, the weights once, the output
//   written once) for every convolution of the two networks but the
//   largest-K ones, where int8 tensor-core operations (1,979 TOP/s) are
//   close. What bounds this design on the card (timed variants, PERF.md):
//   the consumers run the epilogue after their mainloop, so its stores do
//   not overlap the tensor-core work of their block (1x1 convolutions,
//   f32 out); on 3x3 convolutions the per-stage cost of the gather's
//   shared-memory writes and of the slot hand-offs, not its bytes.
// K6, int8_conv_mma_sync_kernel (the first design; C_in % 16 != 0, i.e.
//   HRNet's 3-channel stem, and the parent timed beside the new one): 4
//   warps on a 64 x 64 tile, mma.sync.m16n8k32 s8 on 64 x 32 slices staged
//   in shared memory, one stage of register prefetch, NCHW stores straight
//   from the fragments; C_in % 16 != 0 gathers byte by byte.
// K6q, act_quant_tile_kernel (C % 16 == 0): NCHW f32 or bf16 activations
//   -> NHWC int8 codes, q = clip(rint(x / sx), lo, hi) - zp, a correctly
//   rounded f32 division and round half to even (the "signed" flavor: lo
//   -127, hi 127, zp 0). A block of 256 threads takes 64 channels x 64
//   pixels (f32) or 128 pixels (bf16): each thread reads 16 bytes along
//   the pixels of 4 channels, packs each pixel's 4 codes into a word in a
//   shared int8 tile ([pixel][64 channels], 16-byte chunks swizzled by
//   pixel), then writes one pixel's 16 channel bytes with one 16-byte
//   store. Bound: bytes (the input read once, a quarter or half of it
//   written). act_quant_bytes_kernel keeps the first 32 x 32 transpose with
//   byte stores for C % 16 != 0 (the stem's 3-channel input).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------ shared helpers (K6, K6q)
template <typename Out>
__device__ __forceinline__ Out to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float as_f32(T v);
template <>
__device__ __forceinline__ float as_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// the pad byte -zp (0 without a zero point), four times
__device__ __forceinline__ uint32_t pad_word(const Conv& p) {
  return p.zp ? (uint32_t)(uint8_t)(int8_t)(int)(-*p.zp) * 0x01010101u : 0u;
}

// (float)acc * (sx * sw[o]) + bias[o], each step rounded, then ReLU
__device__ __forceinline__ float dequant(int acc, float s, float b,
                                         int relu) {
  const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  return relu ? fmaxf(v, 0.0f) : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------- K6: wgmma, TMA, mbarrier
constexpr int kStages = 4;          // ring depth: one producer warp a slot
constexpr int kStageK = 128;        // K bytes of a stage: one swizzled row
constexpr int kWave = 132;          // SMs of an H100 SXM

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of ``bar`` with this parity to complete. A stage that
// never completes ends the kernel with an error instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 22)) __trap();
  }
}

// A 2-D TMA box (coordinates: K byte, row) into shared memory, completing
// on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
               :: "r"(dst), "r"(v) : "memory");
}

// wgmma's shared-memory matrix descriptor: K-major, 128-byte swizzle,
// 8-row groups 1,024 bytes apart (the leading offset is unused there)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = a * b, or d += a * b with ``accumulate``; a is 64 x 32, b kBN x 32
template <int kBN>
__device__ __forceinline__ void wgmma_k32(int (&d)[kBN / 2], uint64_t da,
                                          uint64_t db, int accumulate) {
  if constexpr (kBN == 32) {
    wgmma_n32(d, da, db, accumulate);
  } else if constexpr (kBN == 64) {
    wgmma_n64(d, da, db, accumulate);
  } else {
    wgmma_n128(d, da, db, accumulate);
  }
}

// Keep the compiler from moving reads of the accumulator above the
// wgmma.wait_group that completes it.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Shared memory of one block: the ring, then the output tile, then the
// barriers (dynamic, 1,024-byte aligned for the swizzle).
template <int kWG, int kBN, typename Out>
struct Layout {
  static constexpr int BM = 64 * kWG;
  static constexpr int A_BYTES = BM * kStageK, B_BYTES = kBN * kStageK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int VEC = 16 / (int)sizeof(Out);  // outputs a 16-byte store
  static constexpr int LD = BM + VEC;                 // a channel's row, padded
  static constexpr int TILE = (kBN * LD * (int)sizeof(Out) + 127) / 128 * 128;
  static constexpr int ROWS = kStages * STAGE + TILE;  // gather row tables
  static constexpr int BARS = ROWS + kStages * BM * 16;
  static constexpr int BYTES = BARS + 2 * kStages * 8 + 1024;
};

// A gathered row's pixel: (pixel, tap 0) in the codes, and which taps lie
// in the image (bit ky * k + kx); none for a pixel past M.
struct RowTap {
  long long off;
  uint32_t taps, unused;
};

// Persistent: block b takes output tiles b, b + gridDim.x, ... (pixels
// fastest, so the blocks in flight share weights and neighbouring input
// rows in L2). Warpgroups 0 .. kWG-1 consume (wgmma, epilogue), warpgroup
// kWG produces (TMA, gathers); the ring runs on across tiles, so the
// producer loads the next tile while the consumers store this one.
template <int kWG, int kBN, typename Out>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap, Conv p,
                       int tma_a, Out* __restrict__ out) {
  using L = Layout<kWG, kBN, Out>;
  constexpr int BM = L::BM, A_BYTES = L::A_BYTES, STAGE = L::STAGE;
  static_assert(kStages == 4, "one producer warp per ring slot");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  Out* tile = reinterpret_cast<Out*>(ring + kStages * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::BARS);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  const int mtiles = (p.M + BM - 1) / BM;
  const int ntiles = mtiles * ((p.O + kBN - 1) / kBN);
  const int nk = (p.Kpad + kStageK - 1) / kStageK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // gathers: the slot's 32 producer lanes + the weights' expect_tx
      mbar_init(&full[s], tma_a ? 1 : 32 + 1);
      mbar_init(&empty[s], 4 * kWG);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128 * kWG) {
    // ------------------------------------------------------- producer
    // warp w fills ring slot w: k-stages w, w + kStages, ... of this
    // block's tiles, so a warp waiting for its gathers holds up no other
    // slot and every slot can be in flight at once
    const int w = (tid >> 5) - 4 * kWG, lane = tid & 31;
    const int stages = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x * nk;
    uint64_t* bar = &full[w];
    uint8_t* st = ring + w * STAGE;
    // lane: chunk c = lane % 8 of rows lane / 8 + 4 i, so 8 lanes store
    // one row's 128 bytes; the rows' pixels come from the warp's table
    RowTap* rows = reinterpret_cast<RowTap*>(ring + L::ROWS) + w * BM;
    const int c = lane & 7, r0 = lane >> 3;
    const uint32_t pad = pad_word(p);
    const int hw = p.Ho * p.Wo;
    int decoded = -1;
    for (int it = w; it < stages; it += kStages) {
      const int tt = it / nk, kt = it - tt * nk;
      const int t = (int)blockIdx.x + tt * (int)gridDim.x;
      const int m0 = (t % mtiles) * BM, n0 = (t / mtiles) * kBN;
      mbar_wait(&empty[w], ((it / kStages) & 1) ^ 1);
      if (tma_a) {
        if (lane == 0) {
          mbar_expect_tx(bar, STAGE);
          tma_load(st, &xmap, bar, kt * kStageK, m0);
          tma_load(st + A_BYTES, &wmap, bar, kt * kStageK, n0);
        }
        continue;
      }
      if (lane == 0) {
        mbar_expect_tx(bar, L::B_BYTES);
        tma_load(st + A_BYTES, &wmap, bar, kt * kStageK, n0);
      }
      if (tt != decoded) {
        decoded = tt;
        __syncwarp();                  // the last tile's rows are read
        for (int r = lane; r < BM; r += 32) {
          const int m = m0 + r;
          RowTap rt = {0, 0u, 0u};
          if (m < p.M) {
            const int n = m / hw;
            const int q = m - n * hw;
            const int oy = q / p.Wo;
            const int iy0 = oy * p.stride - p.pad;
            const int ix0 = (q - oy * p.Wo) * p.stride - p.pad;
            rt.off = (((long long)n * p.H + iy0) * p.W + ix0) * p.C;
            uint32_t cols = 0u;
            for (int kx = 0; kx < p.k; ++kx)
              if (ix0 + kx >= 0 && ix0 + kx < p.W) cols |= 1u << kx;
            for (int ky = 0; ky < p.k; ++ky)
              if (iy0 + ky >= 0 && iy0 + ky < p.H)
                rt.taps |= cols << (ky * p.k);
          }
          rows[r] = rt;
        }
        __syncwarp();
      }
      const int k = kt * kStageK + 16 * c;
      const bool kin = k < p.K;
      int tap = 0;
      long long toff = 0;
      if (kin) {
        tap = k / p.C;
        const int ky = tap / p.k;
        toff = (long long)(ky * p.W + tap - ky * p.k) * p.C +
               (k - tap * p.C);
      }
      const uint32_t a0 = smem_u32(st);
#pragma unroll 4
      for (int r = r0; r < BM; r += 4) {
        const RowTap rt = rows[r];
        const uint32_t dst = a0 + r * kStageK + ((c ^ (r & 7)) << 4);
        if (kin && ((rt.taps >> tap) & 1u))
          cp_async16(dst, p.x + rt.off + toff);
        else
          st_shared16(dst, pad);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar);
    }
    return;
  }

  // --------------------------------------------------------- consumers
  const int wg = tid >> 7, lane = tid & 31;
  // wgmma's accumulator: warp w of the warpgroup holds rows 16 w .. +15;
  // acc[4 j + 2 h + e] is row lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
  const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int hw = p.Ho * p.Wo;
  const float sx = *p.sx;
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int m0 = (t % mtiles) * BM, n0 = (t / mtiles) * kBN;
    // no instruction but wgmma writes the accumulator (its first product
    // of a tile overwrites it), so ptxas keeps the wgmmas asynchronous
    int acc[kBN / 2];
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      __syncwarp();
      const uint8_t* st = ring + s * STAGE;
      const uint64_t da = sw128_desc(st + wg * 64 * kStageK);
      const uint64_t db = sw128_desc(st + A_BYTES);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk)   // +32 bytes of K each
        wgmma_k32<kBN>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // hand the slot back as soon as its products are done (holding it
      // until the next stage has landed would tie each slot to two stage
      // latencies)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fence_acc(acc);

    // epilogue: dequantize into the output tile, [channel][pixel]; the
    // barrier first lets the last tile's stores finish reading it
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kWG) : "memory");
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + e;
        const int o = n0 + col;
        float sc = 0.0f, b = 0.0f;
        if (o < p.O) {
          sc = __fmul_rn(sx, p.sw[o]);
          b = p.bias[o];
        }
        tile[col * L::LD + row] = to_out<Out>(dequant(acc[4 * j + e], sc, b,
                                                      p.relu));
        tile[col * L::LD + row + 8] = to_out<Out>(
            dequant(acc[4 * j + 2 + e], sc, b, p.relu));
      }
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(128 * kWG) : "memory");
    // NCHW stores: a thread keeps one run of VEC pixels and walks the
    // channels, so a warp writes runs of one channel's pixels; 16 bytes a
    // thread where every channel's run is aligned and inside one image
    constexpr int VEC = L::VEC, PER_COL = BM / VEC;
    constexpr int STEP = 128 * kWG / PER_COL;   // channels per pass
    const int m = m0 + (tid % PER_COL) * VEC;
    if (m >= p.M) continue;
    const int n = m / hw;
    const int r = m - n * hw;
    const bool whole = hw % VEC == 0 && m + VEC <= p.M;
    Out* dst = out + ((long long)n * p.O + n0) * hw + r;
    const Out* src = tile + (m - m0);
    for (int col = tid / PER_COL; col < kBN && n0 + col < p.O;
         col += STEP) {
      if (whole) {
        *reinterpret_cast<uint4*>(dst + (long long)col * hw) =
            *reinterpret_cast<const uint4*>(src + col * L::LD);
      } else {
        for (int e = 0; e < VEC && m + e < p.M; ++e) {
          const int ne = (m + e) / hw;
          out[((long long)ne * p.O + n0 + col) * hw + (m + e - ne * hw)] =
              src[col * L::LD + e];
        }
      }
    }
  }
}

// ------------------------------------ K6: the first design, mma.sync
constexpr int kSyncBM = 64;       // output pixels of a block tile
constexpr int kSyncBN = 64;       // output channels of a block tile
constexpr int kSyncBK = 32;       // K of one mma and one shared stage
constexpr int kSyncRow = 48;      // bytes per staged row: 32 data + 16 pad
constexpr int kSyncThreads = 128; // 4 warps, 2 x 2 over the tile

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

template <bool kVec, typename Out>
__global__ void __launch_bounds__(kSyncThreads)
int8_conv_mma_sync_kernel(Conv p, Out* __restrict__ out) {
  __shared__ __align__(16) uint8_t As[2][kSyncBM * kSyncRow];
  __shared__ __align__(16) uint8_t Bs[2][kSyncBN * kSyncRow];
  const int tid = threadIdx.x;
  const uint32_t pad4 = pad_word(p);
  const int m0 = blockIdx.x * kSyncBM;
  const int n0 = blockIdx.y * kSyncBN;

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

  const int nk = p.Kpad / kSyncBK;
  uint4 a_next = load_a<kVec>(p, pad4, m_ok, n, iy0, ix0, half);
  uint4 b_next = o_ok ? *reinterpret_cast<const uint4*>(wrow)
                      : make_uint4(0u, 0u, 0u, 0u);
  *reinterpret_cast<uint4*>(&As[0][row * kSyncRow + half]) = a_next;
  *reinterpret_cast<uint4*>(&Bs[0][row * kSyncRow + half]) = b_next;
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
      const int k = (kt + 1) * kSyncBK + half;
      a_next = load_a<kVec>(p, pad4, m_ok, n, iy0, ix0, k);
      b_next = o_ok ? *reinterpret_cast<const uint4*>(wrow + (kt + 1) *
                                                                 kSyncBK)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    const uint8_t* A = As[buf];
    const uint8_t* Bt = Bs[buf];
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = A + (wm + i * 16 + g) * kSyncRow + t4;
      const uint8_t* r1 = r0 + 8 * kSyncRow;
      a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[i][1] = *reinterpret_cast<const uint32_t*>(r1);
      a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* c0 = Bt + (wn + j * 8 + g) * kSyncRow + t4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 16);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
    if (more) {
      *reinterpret_cast<uint4*>(&As[buf ^ 1][row * kSyncRow + half]) = a_next;
      *reinterpret_cast<uint4*>(&Bs[buf ^ 1][row * kSyncRow + half]) = b_next;
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
          const float s = __fmul_rn(sx, p.sw[o]);
          out[pix + (long long)o * hw] = to_out<Out>(
              dequant(acc[i][j][h * 2 + c], s, p.bias[o], p.relu));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ K6q
__device__ __forceinline__ uint32_t quant_byte(float x, float sx, float zp,
                                               float lo, float hi) {
  const float f = fminf(fmaxf(rintf(__fdiv_rn(x, sx)), lo), hi) - zp;
  return (uint32_t)(uint8_t)(int8_t)(int)f;
}

// grid (pixel tiles, 64-channel tiles, N), 256 threads; C % 16 == 0
template <typename T>
__global__ void __launch_bounds__(256)
act_quant_tile_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                      int C, int HW, int vec_ok, const float* sx_p,
                      const float* zp_p, const float* lo_p,
                      const float* hi_p) {
  constexpr int VEC = 16 / (int)sizeof(T);  // pixels of one 16-byte load
  constexpr int PX = 16 * VEC;              // pixels of the tile
  // [pixel][64 channel bytes]; pixel row's 16-byte chunk g sits at chunk
  // g ^ ((row / VEC) & 3), so a warp's word writes spread over 4 chunks
  __shared__ __align__(16) uint32_t tile[PX * 16];
  const float sx = *sx_p;
  const float zp = zp_p ? *zp_p : 0.0f;
  const float lo = lo_p ? *lo_p : -127.0f;
  const float hi = hi_p ? *hi_p : 127.0f;
  const int n = blockIdx.z;
  const int p0 = blockIdx.x * PX, c0 = blockIdx.y * 64;
  const int t = threadIdx.x, pv = t & 15, cg = t >> 4;
  const T* xn = x + (long long)n * C * HW;
  const int p = p0 + pv * VEC;

  // this thread: channels c0 + 4 cg .. +3 at pixels p .. p + VEC - 1
  uint32_t word[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) word[e] = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + 4 * cg + j;
    float f[VEC];
    if (c < C && vec_ok && p + VEC <= HW) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          xn + (long long)c * HW + p);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = as_f32<T>(v[e]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        f[e] = (c < C && p + e < HW) ? as_f32<T>(xn[(long long)c * HW + p +
                                                    e])
                                     : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      word[e] |= quant_byte(f[e], sx, zp, lo, hi) << (8 * j);
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    tile[(pv * VEC + e) * 16 + ((((cg >> 2) ^ (pv & 3))) << 2) + (cg & 3)] =
        word[e];
  __syncthreads();
  int8_t* qn = q + (long long)n * HW * C;
  for (int v = t; v < 4 * PX; v += 256) {
    const int row = v >> 2, g = v & 3;
    const int pp = p0 + row, c = c0 + 16 * g;
    if (pp < HW && c < C)
      *reinterpret_cast<uint4*>(qn + (long long)pp * C + c) =
          *reinterpret_cast<const uint4*>(
              &tile[row * 16 + ((g ^ ((row / VEC) & 3)) << 2)]);
  }
}

// The first design's 32 x 32 transpose with byte stores, for C % 16 != 0.
// grid (pixel tiles, channel tiles, N), block (32, 8)
constexpr int kTile = 32;

template <typename T>
__global__ void act_quant_bytes_kernel(const T* __restrict__ x,
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
    if (c < C && pix < HW)
      v = (int8_t)quant_byte(as_f32<T>(xn[(long long)c * HW + pix]), sx, zp,
                             lo, hi);
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

// -------------------------------------------------------------- launches
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query (the
// library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tensor map over a row-major int8 (rows, cols) matrix: boxes of 128
// bytes x box_rows rows, 128-byte swizzle, zeros outside the matrix.
bool int8_map(CUtensorMap* map, const void* base, long long rows,
              long long cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kStageK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1u, 1u};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kWG, int kBN, typename Out>
int wgmma_launch(const Conv& p, const CUtensorMap& wmap,
                 const CUtensorMap& xmap, int tma_a, Out* out,
                 cudaStream_t st) {
  using L = Layout<kWG, kBN, Out>;
  auto kern = int8_conv_wgmma_kernel<kWG, kBN, Out>;
  constexpr int threads = 128 * (kWG + 1);
  // the shared-memory limit and the blocks that fit, once per device (a
  // query on every launch cost more host time than the kernel takes)
  static int ready_dev = -1;
  static long long resident = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != ready_dev) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
             L::BYTES)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, threads, L::BYTES)) != cudaSuccess)
      return (int)err;
    resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    ready_dev = dev;
  }
  const long long tiles = (long long)((p.M + L::BM - 1) / L::BM) *
                          ((p.O + kBN - 1) / kBN);
  const int grid = (int)(tiles < resident ? tiles : resident);
  kern<<<grid, threads, L::BYTES, st>>>(wmap, xmap, p, tma_a, out);
  return (int)cudaGetLastError();
}

template <typename Out>
int wgmma_conv(const Conv& p, Out* out, cudaStream_t st) {
  const int tma_a = p.k == 1 && p.stride == 1;
  auto blocks = [&](int bm, int bn) {
    return (long long)((p.M + bm - 1) / bm) * ((p.O + bn - 1) / bn);
  };
  int bn = p.O <= 32 ? 32 : p.O <= 64 ? 64 : 128;
  const int bm = blocks(128, bn) >= kWave ? 128 : 64;
  if (bm == 64 && bn == 128 && blocks(64, bn) < kWave) bn = 64;
  CUtensorMap wmap, xmap;
  if (!int8_map(&wmap, p.w, p.O, p.Kpad, bn))
    return (int)cudaErrorInvalidValue;
  if (tma_a) {
    if (!int8_map(&xmap, p.x, p.M, p.C, bm))
      return (int)cudaErrorInvalidValue;
  } else {
    xmap = wmap;   // not read
  }
  if (bm == 128) {
    if (bn == 32) return wgmma_launch<2, 32>(p, wmap, xmap, tma_a, out, st);
    if (bn == 64) return wgmma_launch<2, 64>(p, wmap, xmap, tma_a, out, st);
    return wgmma_launch<2, 128>(p, wmap, xmap, tma_a, out, st);
  }
  if (bn == 32) return wgmma_launch<1, 32>(p, wmap, xmap, tma_a, out, st);
  if (bn == 64) return wgmma_launch<1, 64>(p, wmap, xmap, tma_a, out, st);
  return wgmma_launch<1, 128>(p, wmap, xmap, tma_a, out, st);
}

template <typename Out>
int conv_launch(const int8_t* x, const int8_t* w, const float* sx,
                const float* sw, const float* bias, const float* zp,
                int N, int H, int W, int C, int O, int k, int stride,
                int relu, void* out, void* stream, int wgmma) {
  Conv p;
  p.x = x; p.w = w; p.sx = sx; p.sw = sw; p.bias = bias;
  p.N = N; p.H = H; p.W = W; p.C = C; p.O = O; p.k = k;
  p.stride = stride; p.pad = k / 2;
  p.Ho = (H + 2 * p.pad - k) / stride + 1;
  p.Wo = (W + 2 * p.pad - k) / stride + 1;
  p.K = k * k * C;
  p.Kpad = (p.K + kSyncBK - 1) / kSyncBK * kSyncBK;
  p.M = N * p.Ho * p.Wo;
  p.relu = relu;
  p.zp = zp;
  cudaStream_t st = (cudaStream_t)stream;
  Out* o = static_cast<Out*>(out);
  if (wgmma) {
    if (C % 16 != 0) return (int)cudaErrorInvalidValue;
    return wgmma_conv<Out>(p, o, st);
  }
  dim3 grid((p.M + kSyncBM - 1) / kSyncBM, (O + kSyncBN - 1) / kSyncBN);
  if (C % 16 == 0)
    int8_conv_mma_sync_kernel<true, Out><<<grid, kSyncThreads, 0, st>>>(p, o);
  else
    int8_conv_mma_sync_kernel<false, Out><<<grid, kSyncThreads, 0, st>>>(p,
                                                                         o);
  return (int)cudaGetLastError();
}

template <typename T>
int quantize_launch(const void* x, void* q, int N, int C, int HW,
                    const float* sx, const float* zp, const float* lo,
                    const float* hi, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  if (C % 16 == 0) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int vec_ok = HW % VEC == 0 && (uintptr_t)x % 16 == 0;
    dim3 grid((HW + 16 * VEC - 1) / (16 * VEC), (C + 63) / 64, N);
    act_quant_tile_kernel<T><<<grid, 256, 0, st>>>(xt, qt, C, HW, vec_ok, sx,
                                                   zp, lo, hi);
  } else {
    dim3 grid((HW + kTile - 1) / kTile, (C + kTile - 1) / kTile, N);
    act_quant_bytes_kernel<T><<<grid, dim3(kTile, 8), 0, st>>>(
        xt, qt, C, HW, sx, zp, lo, hi);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ``wgmma``: 1 for the wgmma kernel (C % 16 == 0), 0 for the mma.sync
// kernel; the wrapper chooses.
extern "C" int int8_conv_f32(const int8_t* x, const int8_t* w,
                             const float* sx, const float* sw,
                             const float* bias, const float* zp, int N, int H,
                             int W, int C, int O, int k, int stride, int relu,
                             void* out, void* stream, int wgmma) {
  return conv_launch<float>(x, w, sx, sw, bias, zp, N, H, W, C, O, k, stride,
                            relu, out, stream, wgmma);
}

extern "C" int int8_conv_bf16(const int8_t* x, const int8_t* w,
                              const float* sx, const float* sw,
                              const float* bias, const float* zp, int N,
                              int H, int W, int C, int O, int k, int stride,
                              int relu, void* out, void* stream, int wgmma) {
  return conv_launch<__nv_bfloat16>(x, w, sx, sw, bias, zp, N, H, W, C, O, k,
                                    stride, relu, out, stream, wgmma);
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
