// K5: pick-argmax greedy NMS for Hopper (sm_90a), the whole loop in one
// launch.
//
// Has no Pallas original: it replaces the jax.lax.fori_loop of
// stlpose_tpu/ops/nms.py::_box_nms_topk (:194-228), which XLA runs on the
// TPU as one on-device loop, and which plain PyTorch runs as ~27 ops per
// pick. Per image (a row of the (B, M) batch):
//   area  = clamp(x2 - x1, 0) * clamp(y2 - y1, 0)
//   alive = valid & (score > -inf)
//   max_keep times: i = the alive candidate with the largest score, the
//   lowest index among equal scores (torch.argmax); stop if none is alive
//   (later picks would change nothing); keep i; remove i and every alive
//   box with
//     inter = clamp(min(x2, bx2) - max(x1, bx1), 0) *
//             clamp(min(y2, by2) - max(y1, by1), 0)
//     iou   = inter / clamp((area + area_i) - inter, 1e-9) > thr
// in f32, IEEE division, NaN propagated through min, max and clamp as
// torch does (PTX min.NaN / max.NaN), built with --fmad=false: the keep
// mask is the plain version's bit for bit.
//
// Bound: not bytes (the inputs and the mask are ~0.4 MB at the proposal
// shape) but latency: the picks are serial. So:
// - one block per image; each thread owns candidates tid, tid + T, ...,
//   their boxes and areas in registers (shared memory above 3 * 1024
//   candidates) and each one's score as an order-preserving uint32 key,
//   0 once the candidate is dead, so a dead candidate costs one compare;
// - one pass per pick over a thread's candidates fuses the previous pick's
//   suppression with the next argmax;
// - the argmax over the block is two redux.sync per warp (max of the
//   keys, then min of the indices holding it), the warps' results through
//   a double-buffered slot in shared memory, one barrier, and the same two
//   redux.sync in every warp: one barrier per pick;
// - the pick's box is read from a copy of all boxes in shared memory.
// The block leaves the loop once no candidate is alive.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // index sentinel: no candidate

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Order-preserving, non-zero key of an alive score (> -inf, not NaN):
// a larger score has a larger key. -0.0 becomes +0.0 first, so scores
// that compare equal share a key and tie on the index, as in argmax.
__device__ __forceinline__ uint32_t score_key(float s) {
  if (s == 0.f) s = 0.f;
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float load_score(const float* p) { return *p; }
__device__ __forceinline__ float load_score(const uint16_t* p) {
  return __uint_as_float((uint32_t)*p << 16);  // bf16 -> f32, exact
}

__device__ __forceinline__ float box_area(float4 b) {
  return max_nan(b.z - b.x, 0.f) * max_nan(b.w - b.y, 0.f);
}

// Block-wide (key, index) argmax of the threads' best candidates: the
// largest key, the lowest index holding it; every thread gets it. The
// warps' results go through red[buf]; callers alternate buf, so one
// barrier per call suffices (a warp writes red[buf] again only two calls
// later, after every warp has passed the barrier between).
template <int T>
__device__ __forceinline__ uint2 block_argmax(uint32_t key, uint32_t idx,
                                              uint2 (*red)[T / 32], int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t k = __reduce_max_sync(kFull, key);
  uint32_t i = __reduce_min_sync(kFull, key == k ? idx : kNone);
  if (lane == 0) red[buf][warp] = make_uint2(k, i);
  __syncthreads();
  const uint2 e = lane < T / 32 ? red[buf][lane] : make_uint2(0u, kNone);
  k = __reduce_max_sync(kFull, e.x);
  i = __reduce_min_sync(kFull, e.x == k ? e.y : kNone);
  return make_uint2(k, i);
}

// One block of T threads per image; PER candidates a thread; kSmem keeps
// the candidates' boxes and areas in shared memory instead of registers.
// S: the score type (float or bf16 bits).
template <int T, int PER, bool kSmem, typename S>
__global__ void __launch_bounds__(T)
nms_kernel(const float* __restrict__ boxes, const S* __restrict__ scores,
           const uint8_t* __restrict__ valid, int M, int max_keep,
           float thr, uint8_t* __restrict__ keep) {
  extern __shared__ float4 s_box[];  // [M] boxes, then kSmem: [T * PER] areas
  __shared__ uint2 s_red[2][T / 32];
  float* s_area = reinterpret_cast<float*>(s_box + M);
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * M;
  boxes += row * 4;
  scores += row;
  keep += row;
  if (valid != nullptr) valid += row;

  constexpr int R = kSmem ? 1 : PER;  // candidates held in registers
  float4 rbox[R];
  float rarea[R];
  uint32_t key[PER];
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int j = c * T + tid;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    key[c] = 0u;
    if (j < M) {
      b = make_float4(boxes[4 * j], boxes[4 * j + 1], boxes[4 * j + 2],
                      boxes[4 * j + 3]);
      s_box[j] = b;
      const float s = load_score(scores + j);
      if ((valid == nullptr || valid[j] != 0) &&
          s > __uint_as_float(0xff800000u))  // -inf
        key[c] = score_key(s);
    }
    if (kSmem) {
      s_area[j] = box_area(b);
    } else {
      rbox[c % R] = b;
      rarea[c % R] = box_area(b);
    }
  }

  uint32_t kept = 0u;  // bit c: candidate c * T + tid was kept
  uint32_t prev = kNone;
  float4 pb = make_float4(0.f, 0.f, 0.f, 0.f);
  float parea = 0.f;
  for (int p = 0; p < max_keep; ++p) {
    uint32_t bk = 0u, bi = kNone;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      if (key[c] == 0u) continue;
      const uint32_t j = (uint32_t)(c * T + tid);
      if (prev != kNone) {
        const float4 b = kSmem ? s_box[j] : rbox[c % R];
        const float area = kSmem ? s_area[j] : rarea[c % R];
        const float iw = max_nan(min_nan(b.z, pb.z) - max_nan(b.x, pb.x), 0.f);
        const float ih = max_nan(min_nan(b.w, pb.w) - max_nan(b.y, pb.y), 0.f);
        const float inter = iw * ih;
        const float denom = max_nan((area + parea) - inter, 1e-9f);
        // no overlap (inter +-0, the common case): the quotient is +-0
        // unless denom is NaN, so the division is skipped
        bool over;
        if (inter == 0.f && denom == denom)
          over = 0.f > thr;
        else
          over = inter / denom > thr;
        if (j == prev || over) {
          key[c] = 0u;
          continue;
        }
      }
      if (key[c] > bk) {  // candidates in increasing index: ties keep the first
        bk = key[c];
        bi = j;
      }
    }
    const uint2 pick = block_argmax<T>(bk, bi, s_red, p & 1);
    if (pick.x == 0u) break;  // nothing alive: the mask is final
    prev = pick.y;
    if ((prev & (T - 1)) == (uint32_t)tid) kept |= 1u << (prev / T);
    pb = s_box[prev];
    parea = box_area(pb);
  }

#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int j = c * T + tid;
    if (j < M) keep[j] = (kept >> c) & 1u;
  }
}

template <int T, int PER, bool kSmem, typename S>
cudaError_t launch(const float* boxes, const S* scores, const uint8_t* valid,
                   int B, int M, int max_keep, float thr, uint8_t* keep,
                   cudaStream_t stream) {
  auto kernel = nms_kernel<T, PER, kSmem, S>;
  const size_t smem = (size_t)M * 16 + (kSmem ? (size_t)T * PER * 4 : 0);
  if (smem > 40 * 1024) {  // with the static shared memory, over 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, T, smem, stream>>>(boxes, scores, valid, M, max_keep, thr,
                                 keep);
  return cudaGetLastError();
}

// The design's sizes: the smallest of three that holds M.
template <typename S>
int dispatch(const float* boxes, const S* scores, const uint8_t* valid, int B,
             int M, int max_keep, float thr, uint8_t* keep, void* stream) {
  if (B == 0 || M == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaErrorInvalidValue;
  if (M <= 256)  // detections
    e = launch<256, 1, false>(boxes, scores, valid, B, M, max_keep, thr,
                              keep, s);
  else if (M <= 3072)  // proposals at test budgets
    e = launch<1024, 3, false>(boxes, scores, valid, B, M, max_keep, thr,
                               keep, s);
  else if (M <= 5120)  // proposals at training budgets
    e = launch<1024, 5, true>(boxes, scores, valid, B, M, max_keep, thr,
                              keep, s);
  return (int)e;
}

// The latency floor of the loop: `rounds` block-wide argmax rounds with no
// candidate work (block_argmax on a key that changes every round).
template <int T>
__global__ void __launch_bounds__(T) argmax_rounds_kernel(int rounds,
                                                           uint32_t* out) {
  __shared__ uint2 s_red[2][T / 32];
  uint32_t acc = 0u;
  const uint32_t key = (threadIdx.x * 2654435761u) | 1u;
  for (int p = 0; p < rounds; ++p) {
    const uint2 r = block_argmax<T>(key ^ acc, threadIdx.x, s_red, p & 1);
    acc += r.y + 1u;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

// Keep mask (B, M) uint8 of greedy NMS; boxes (B, M, 4) f32, scores (B, M)
// f32 or bf16, valid (B, M) uint8 or null. Returns a cudaError_t
// (cudaErrorInvalidValue for M > 5120).
extern "C" int nms_f32_launch(const float* boxes, const float* scores,
                              const uint8_t* valid, int B, int M,
                              int max_keep, float thr, uint8_t* keep,
                              void* stream) {
  return dispatch(boxes, scores, valid, B, M, max_keep, thr, keep, stream);
}

extern "C" int nms_bf16_launch(const float* boxes, const uint16_t* scores,
                               const uint8_t* valid, int B, int M,
                               int max_keep, float thr, uint8_t* keep,
                               void* stream) {
  return dispatch(boxes, scores, valid, B, M, max_keep, thr, keep, stream);
}

// `blocks` blocks of `threads` (256 or 1024) threads, each running
// `rounds` empty argmax rounds; out: `blocks` uint32.
extern "C" int nms_argmax_rounds_launch(int threads, int blocks, int rounds,
                                        uint32_t* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (threads == 256)
    argmax_rounds_kernel<256><<<blocks, 256, 0, s>>>(rounds, out);
  else if (threads == 1024)
    argmax_rounds_kernel<1024><<<blocks, 1024, 0, s>>>(rounds, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
