// K5: greedy NMS for Hopper (sm_90a) as a score-sorted IoU bitmask plus
// one scan.
//
// Has no Pallas original: it replaces the jax.lax.fori_loop of
// stlpose_tpu/ops/nms.py::_box_nms_topk (:194-228), which XLA runs on the
// TPU as one on-device loop, and which plain PyTorch runs as ~27 ops per
// pick. Per image (a row of the (B, M) batch):
//   area  = clamp(x2 - x1, 0) * clamp(y2 - y1, 0)
//   alive = valid & (score > -inf)
//   max_keep times: i = the alive candidate with the largest score, the
//   lowest index among equal scores (torch.argmax); stop if none is alive;
//   keep i; remove i and every alive box with
//     inter = clamp(min(x2, bx2) - max(x1, bx1), 0) *
//             clamp(min(y2, by2) - max(y1, by1), 0)
//     iou   = inter / clamp((area + area_i) - inter, 1e-9) > thr
// in f32, IEEE division, NaN propagated through min, max and clamp as
// torch does (PTX min.NaN / max.NaN), built with --fmad=false: the keep
// mask is the plain version's bit for bit.
//
// The same mask is the JAX package's full formulation
// (stlpose_tpu/ops/nms.py::box_nms_jax, :168-191) cut at max_keep
// survivors: visit the alive candidates by descending score, the lowest
// index first on ties, and keep each one that no kept candidate before it
// suppresses, until max_keep are kept.
//
// Bound: not bytes (the inputs and the mask are ~0.4 MB at the proposal
// shape) but the serial part of greedy NMS. The pick-argmax form puts
// that on one SM per image, a block-wide argmax per pick. Here the
// parallel work is split from the serial one, three launches a call:
// 1. nms_sort_kernel, a block per image: the alive candidates' score keys
//    (dead ones 0) sorted descending and stable by CUB's block radix sort
//    (up to kMaxBlockSort candidates; above it a bitonic network over
//    (key << 32 | ~index) in the workspace); writes the order, the boxes in
//    that order and the count of alive candidates.
// 2. nms_mask_kernel over the whole card: a block per (image, row block
//    of 64 sorted candidates, column block of 64 at or after it); row
//    candidate r is the pick against the column block's boxes staged in
//    shared memory (one thread a row, or four of 16 columns each where
//    the grid is small), and one uint64 of "IoU > thr" bits is written
//    per row. Blocks past the image's
//    alive candidates return at once.
// 3. nms_scan_kernel, a block per image, over the sorted candidates in
//    chunks of 64. Warp 0 resolves chunk c from its removed word and its
//    rows' diagonal words, in rounds of one ballot each, a round per row
//    that suppresses a later candidate; meanwhile warps 1-7 OR the words
//    of chunk c + 1 of every row kept before chunk c, and load chunk
//    c + 1's diagonal; after one barrier the block adds the rows kept in
//    chunk c (one load each) and reduces the OR into chunk c + 1's removed
//    word. Stops at max_keep keeps or when no alive candidate is left;
//    scatters the keep bits back to candidate order, every element
//    written once.
// The serial part is a chunk of 64 candidates per step (a resolve, one
// dependent load, two barriers), not a pick.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // index sentinel: no candidate
constexpr int kSortThreads = 1024;     // bitonic sort above kMaxBlockSort
constexpr int kMaxBlockSort = 32768;   // CUB block radix sort up to here
constexpr int kMaskSmallGrid = 132 * 16;  // mask blocks: fewer fill no card
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;

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

// Whether candidate b (area `area`) is suppressed by the pick pb (area
// `parea`): the plain version's expression, operand for operand.
__device__ __forceinline__ bool suppresses(float4 pb, float parea, float4 b,
                                           float area, float thr) {
  const float iw = max_nan(min_nan(b.z, pb.z) - max_nan(b.x, pb.x), 0.f);
  const float ih = max_nan(min_nan(b.w, pb.w) - max_nan(b.y, pb.y), 0.f);
  const float inter = iw * ih;
  const float denom = max_nan((area + parea) - inter, 1e-9f);
  // no overlap (inter +-0, the common case): the quotient is +-0 unless
  // denom is NaN, so the division is skipped
  if (inter == 0.f && denom == denom) return 0.f > thr;
  return inter / denom > thr;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The scratch of one call, carved from one workspace (nms_workspace_bytes):
// the order (B, M) int32, the sorted boxes (B, M) float4, the alive counts
// (B) int32, the kept rows (B, M) int32, the bitmask (B, M, W) uint64 and,
// above kMaxBlockSort candidates, the bitonic sort's keys (B, N) uint64.
struct Workspace {
  int* order;
  float4* sbox;
  int* n_alive;
  int* list;
  uint64_t* mask;
  uint64_t* keys;
};

__host__ __device__ inline size_t align_up(size_t n) {
  return (n + 255) & ~(size_t)255;
}

__host__ inline size_t workspace_layout(int B, int M, char* base,
                                        Workspace* ws) {
  const int W = (M + 63) / 64, N = pow2_at_least(M);
  size_t off = 0;
  const size_t o_order = off;
  off = align_up(off + (size_t)B * M * 4);
  const size_t o_sbox = off;
  off = align_up(off + (size_t)B * M * 16);
  const size_t o_alive = off;
  off = align_up(off + (size_t)B * 4);
  const size_t o_list = off;
  off = align_up(off + (size_t)B * M * 4);
  const size_t o_mask = off;
  off = align_up(off + (size_t)B * M * W * 8);
  const size_t o_keys = off;
  if (M > kMaxBlockSort) off = align_up(off + (size_t)B * N * 8);
  if (ws != nullptr) {
    ws->order = reinterpret_cast<int*>(base + o_order);
    ws->sbox = reinterpret_cast<float4*>(base + o_sbox);
    ws->n_alive = reinterpret_cast<int*>(base + o_alive);
    ws->list = reinterpret_cast<int*>(base + o_list);
    ws->mask = reinterpret_cast<uint64_t*>(base + o_mask);
    ws->keys = M > kMaxBlockSort
                   ? reinterpret_cast<uint64_t*>(base + o_keys)
                   : nullptr;
  }
  return off;
}

// Score key of candidate j: score_key of an alive score, 0 for a dead one.
template <typename S>
__device__ __forceinline__ uint32_t candidate_key(const S* scores,
                                                  const uint8_t* valid,
                                                  int j) {
  const float s = load_score(scores + j);
  return (valid == nullptr || valid[j] != 0) &&
                 s > __uint_as_float(0xff800000u)  // -inf
             ? score_key(s)
             : 0u;
}

// The sorted order's outputs: order[r] = j and its box, r < M.
__device__ __forceinline__ void put_sorted(const float* boxes, int r, int j,
                                           long long row, Workspace ws) {
  ws.order[row + r] = j;
  ws.sbox[row + r] = make_float4(boxes[4 * j], boxes[4 * j + 1],
                                 boxes[4 * j + 2], boxes[4 * j + 3]);
}

// 1. One block of T threads per image, IPT candidates a thread (T * IPT
// >= M): keys loaded in index order (thread t holds t * IPT ...), sorted
// descending by CUB's block radix sort, which is stable: equal keys keep
// the index order (lowest index first, as argmax), dead candidates (key
// 0) come after the alive ones and the padding (index >= M) last.
template <int T, int IPT, typename S>
__global__ void __launch_bounds__(T)
nms_sort_kernel(const float* __restrict__ boxes, const S* __restrict__ scores,
                const uint8_t* __restrict__ valid, int M, Workspace ws) {
  using Sort = cub::BlockRadixSort<uint32_t, T, IPT, int>;
  extern __shared__ __align__(16) unsigned char s_raw[];
  typename Sort::TempStorage& temp =
      *reinterpret_cast<typename Sort::TempStorage*>(s_raw);
  __shared__ int s_alive;
  const long long row = (long long)blockIdx.x * M;
  boxes += row * 4;
  scores += row;
  if (valid != nullptr) valid += row;
  if (threadIdx.x == 0) s_alive = 0;
  uint32_t keys[IPT];
  int idx[IPT];
  int alive = 0;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int j = threadIdx.x * IPT + i;
    keys[i] = j < M ? candidate_key(scores, valid, j) : 0u;
    idx[i] = j;
    alive += keys[i] != 0u;
  }
  __syncthreads();
  alive = __reduce_add_sync(kFull, alive);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_alive, alive);
  Sort(temp).SortDescendingBlockedToStriped(keys, idx);
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int r = i * T + threadIdx.x;
    if (r < M) put_sorted(boxes, r, idx[i], row, ws);
  }
  __syncthreads();
  if (threadIdx.x == 0) ws.n_alive[blockIdx.x] = s_alive;
}

// 1, above kMaxBlockSort candidates: one block per image, a bitonic
// network over unique keys (key << 32) | ~index (0 for the padding up to
// the power of two N) in the workspace: the same order.
template <typename S>
__global__ void __launch_bounds__(kSortThreads)
nms_sort_global_kernel(const float* __restrict__ boxes,
                       const S* __restrict__ scores,
                       const uint8_t* __restrict__ valid, int M, int N,
                       Workspace ws) {
  __shared__ int s_alive;
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * M;
  uint64_t* keys = ws.keys + (long long)blockIdx.x * N;
  boxes += row * 4;
  scores += row;
  if (valid != nullptr) valid += row;
  if (tid == 0) s_alive = 0;
  __syncthreads();
  int alive = 0;
  for (int j = tid; j < N; j += kSortThreads) {
    uint64_t k = 0;
    if (j < M) {
      const uint32_t key = candidate_key(scores, valid, j);
      alive += key != 0u;
      k = ((uint64_t)key << 32) | (uint32_t)~(uint32_t)j;
    }
    keys[j] = k;
  }
  alive = __reduce_add_sync(kFull, alive);
  if ((tid & 31) == 0) atomicAdd(&s_alive, alive);
  __syncthreads();
  // descending: a pair (lo, lo + j) is put in descending order where bit
  // k of lo is clear, ascending where it is set
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < N / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (j - 1));
        const uint64_t a = keys[lo], b = keys[lo + j];
        if ((a < b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < M; r += kSortThreads)
    put_sorted(boxes, r, (int)~(uint32_t)keys[r], row, ws);
  if (tid == 0) ws.n_alive[blockIdx.x] = s_alive;
}

// 2. One block per (upper-triangle block t, image): row block rb of 64
// sorted candidates against column block cb >= rb. Bit c of
// mask[image][64 rb + r][cb] = the pick 64 rb + r suppresses candidate
// 64 cb + c. kParts threads a row, each testing 64 / kParts columns, their
// bits ORed in shared memory: 4 where the grid is too small to fill the
// card (as at 256 candidates), 1 otherwise. Only alive rows and columns
// are computed; the scan reads nothing else.
template <int kParts>
__global__ void __launch_bounds__(64 * kParts)
nms_mask_kernel(int M, int W, float thr, Workspace ws) {
  __shared__ float4 s_box[64];
  __shared__ float s_area[64];
  __shared__ uint64_t s_part[kParts][64];
  const int img = blockIdx.y, tid = threadIdx.x;
  const int row = tid & 63, part = tid >> 6;
  const int n = ws.n_alive[img];
  // t counts the W (W + 1) / 2 blocks backwards from the last row, whose
  // one block comes first: row W - 1 - q holds q + 1 blocks
  const long long t = (long long)W * (W + 1) / 2 - 1 - blockIdx.x;
  long long q = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) / 2.0);
  while (q * (q + 1) / 2 > t) --q;
  while ((q + 1) * (q + 2) / 2 <= t) ++q;
  const int rb = W - 1 - (int)q;
  const int cb = W - 1 - (int)(t - q * (q + 1) / 2);
  if (rb * 64 >= n || cb * 64 >= n) return;
  const long long base = (long long)img * M;
  if (tid < 64) {
    const int j = cb * 64 + tid;
    const float4 bj = j < n ? ws.sbox[base + j]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    s_box[tid] = bj;
    s_area[tid] = box_area(bj);
  }
  __syncthreads();
  const int i = rb * 64 + row;
  uint64_t bits = 0;
  if (i < n) {
    const float4 pb = ws.sbox[base + i];
    const float parea = box_area(pb);
    const int c0 = 64 / kParts * part;
    const int c1 = min(c0 + 64 / kParts, n - cb * 64);
    if (thr >= 0.f) {
      // an overlap of width 0 gives inter +-0 (not above thr) or NaN (no
      // comparison holds): the bit is 0 without the rest of the expression
      for (int c = c0; c < c1; ++c) {
        const float4 b = s_box[c];
        if (max_nan(min_nan(b.z, pb.z) - max_nan(b.x, pb.x), 0.f) == 0.f)
          continue;
        if (suppresses(pb, parea, b, s_area[c], thr)) bits |= 1ull << c;
      }
    } else {
      for (int c = c0; c < c1; ++c)
        if (suppresses(pb, parea, s_box[c], s_area[c], thr))
          bits |= 1ull << c;
    }
  }
  if (kParts == 1) {
    if (i < n) ws.mask[(base + i) * W + cb] = bits;
    return;
  }
  s_part[part][row] = bits;
  __syncthreads();
  if (tid < 64 && i < n) {
#pragma unroll
    for (int p = 1; p < kParts; ++p) bits |= s_part[p][tid];
    ws.mask[(base + i) * W + cb] = bits;
  }
}

// The bits above bit k of a word (k < 64).
__device__ __forceinline__ uint64_t above(int k) {
  return k == 63 ? 0ull : ~0ull << (k + 1);
}

// Greedy NMS within chunk c, by warp 0: `left` alive candidates from the
// chunk's start (its last chunk may hold fewer than 64), `rem` those that
// earlier chunks' kept rows removed, diag[k] the chunk's bits that row k
// suppresses. In rounds: the sources are the candidates whose row
// suppresses a later candidate still alive; every candidate up to the
// first source is kept (none before it removes anything alive), then the
// source's row removes its later candidates. Appends the kept rows to
// list[nk0...] in order and their bits to kept[c], stops at max_keep and
// publishes the kept count in *s_nk.
__device__ __forceinline__ void resolve_chunk(const uint64_t* diag,
                                              uint64_t rem, int left, int c,
                                              int nk0, int max_keep,
                                              int* list, uint64_t* kept,
                                              int* s_nk) {
  const int lane = threadIdx.x & 31;
  const uint64_t d0 = diag[lane], d1 = diag[32 + lane];
  const uint64_t avail = left >= 64 ? ~0ull : (1ull << left) - 1;
  uint64_t cand = avail & ~rem, bits = 0;
  int nk = nk0;
  while (cand != 0 && nk < max_keep) {
    const bool s0 = ((cand >> lane) & 1) && (d0 & cand & above(lane));
    const bool s1 =
        ((cand >> (32 + lane)) & 1) && (d1 & cand & above(32 + lane));
    const uint64_t src = (uint64_t)__ballot_sync(kFull, s0) |
                         (uint64_t)__ballot_sync(kFull, s1) << 32;
    const int k = src == 0 ? 64 : __ffsll((long long)src) - 1;
    uint64_t take = k == 64 ? cand : cand & ~above(k);
    const int room = max_keep - nk;
    if (__popcll(take) > room) {  // the first `room` of them
      uint64_t first = 0;
      for (int i = 0; i < room; ++i) {
        const uint64_t b = take & (~take + 1);
        first |= b;
        take ^= b;
      }
      take = first;
    }
    bits |= take;
    nk += __popcll(take);
    if (k == 64 || nk >= max_keep) break;
    const uint64_t dk = __shfl_sync(kFull, k < 32 ? d0 : d1, k & 31);
    cand &= ~dk & above(k);
  }
  for (int i = 0; i < 2; ++i) {
    const int k = 32 * i + lane;
    if ((bits >> k) & 1)
      list[nk0 + __popcll(bits & ((1ull << k) - 1))] = c * 64 + k;
  }
  if (lane == 0) {
    kept[c] = bits;
    *s_nk = nk;
  }
}

// 3. One block per image: the greedy scan over the sorted candidates in
// chunks of 64, then the keep bits scattered back to candidate order.
// The kept rows, in order, go to the workspace.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(int M, int W, int max_keep, Workspace ws,
                uint8_t* __restrict__ keep) {
  extern __shared__ uint64_t kept[];      // the kept bits, W words
  __shared__ uint64_t s_diag[2][64];
  __shared__ uint64_t s_red[kScanWarps];
  __shared__ int s_nk;
  const int img = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)img * M;
  const uint64_t* mask = ws.mask + base * W;
  int* list = ws.list + base;
  const int n = ws.n_alive[img];
  const int chunks = (n + 63) / 64;
  for (int w = tid; w < W; w += kScanThreads) kept[w] = 0;
  if (tid < 64 && chunks > 0) s_diag[0][tid] = tid < n ? mask[tid * W] : 0;
  __syncthreads();

  uint64_t rem = 0;  // warp 0: the removed word of chunk c
  int nk0 = 0;       // rows kept before chunk c
  for (int c = 0; c < chunks; ++c) {
    const bool more = c + 1 < chunks;
    uint64_t acc = 0, next = 0;
    if (warp != 0 && more) {
      // chunk c + 1's diagonal, and the rows kept before chunk c
      const int r = (c + 1) * 64 + tid - 32;
      if (tid < 96 && r < n) next = mask[(long long)r * W + c + 1];
#pragma unroll 4
      for (int i = tid - 32; i < nk0; i += kScanThreads - 32)
        acc |= mask[(long long)list[i] * W + c + 1];
    }
    if (warp == 0) resolve_chunk(s_diag[c & 1], rem, n - c * 64, c, nk0,
                                 max_keep, list, kept, &s_nk);
    __syncthreads();
    const int nk1 = s_nk;
    if (nk1 >= max_keep || !more) break;
    // the rows kept in chunk c
    for (int i = nk0 + tid; i < nk1; i += kScanThreads)
      acc |= mask[(long long)list[i] * W + c + 1];
    const uint32_t lo = __reduce_or_sync(kFull, (uint32_t)acc);
    const uint32_t hi = __reduce_or_sync(kFull, (uint32_t)(acc >> 32));
    if (lane == 0) s_red[warp] = ((uint64_t)hi << 32) | lo;
    if (warp != 0 && tid < 96) s_diag[(c + 1) & 1][tid - 32] = next;
    __syncthreads();
    if (warp == 0) {
      rem = 0;
#pragma unroll
      for (int w = 0; w < kScanWarps; ++w) rem |= s_red[w];
    }
    nk0 = nk1;
  }
  __syncthreads();
  for (int r = tid; r < M; r += kScanThreads)
    keep[base + ws.order[base + r]] =
        r < n ? (uint8_t)((kept[r >> 6] >> (r & 63)) & 1) : 0;
}

template <int T, int IPT, typename S>
cudaError_t launch_sort(const float* boxes, const S* scores,
                        const uint8_t* valid, int B, int M, Workspace ws,
                        cudaStream_t stream) {
  auto kernel = nms_sort_kernel<T, IPT, S>;
  const size_t smem =
      sizeof(typename cub::BlockRadixSort<uint32_t, T, IPT, int>::TempStorage);
  if (smem > 40 * 1024) {  // with the static shared memory, over 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, T, smem, stream>>>(boxes, scores, valid, M, ws);
  return cudaGetLastError();
}

template <typename S>
int run(const float* boxes, const S* scores, const uint8_t* valid, int B,
        int M, int max_keep, float thr, uint8_t* keep, void* workspace,
        void* stream) {
  if (B == 0 || M == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  Workspace ws;
  workspace_layout(B, M, static_cast<char*>(workspace), &ws);
  const int W = (M + 63) / 64;
  cudaError_t e;
  if (M <= 1024)
    e = launch_sort<128, 8>(boxes, scores, valid, B, M, ws, s);
  else if (M <= 4096)
    e = launch_sort<256, 16>(boxes, scores, valid, B, M, ws, s);
  else if (M <= 8192)
    e = launch_sort<512, 16>(boxes, scores, valid, B, M, ws, s);
  else if (M <= 16384)
    e = launch_sort<1024, 16>(boxes, scores, valid, B, M, ws, s);
  else if (M <= kMaxBlockSort)
    e = launch_sort<1024, 32>(boxes, scores, valid, B, M, ws, s);
  else {
    nms_sort_global_kernel<S><<<B, kSortThreads, 0, s>>>(
        boxes, scores, valid, M, pow2_at_least(M), ws);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  const long long tri = (long long)W * (W + 1) / 2;
  if (tri > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tri, B);
  if (tri * B < kMaskSmallGrid)
    nms_mask_kernel<4><<<grid, 256, 0, s>>>(M, W, thr, ws);
  else
    nms_mask_kernel<1><<<grid, 64, 0, s>>>(M, W, thr, ws);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t smem = (size_t)W * 8;
  if (smem > 40 * 1024) {  // with the static shared memory, over 48 KB
    e = cudaFuncSetAttribute(nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_scan_kernel<<<B, kScanThreads, smem, s>>>(M, W, max_keep, ws, keep);
  return (int)cudaGetLastError();
}

// Block-wide (key, index) argmax of the threads' best candidates, the step
// of the pick-argmax form of greedy NMS: kept for that form's latency
// floor, which K5's records carry beside this design's
// (argmax_rounds_kernel below).
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

// The pick-argmax form's latency floor: `rounds` block-wide argmax rounds
// with no candidate work (block_argmax on a key that changes every round).
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

// Bytes of the workspace that nms_f32_launch / nms_bf16_launch take for
// B images of M candidates.
extern "C" long long nms_workspace_bytes(int B, int M) {
  return (long long)workspace_layout(B, M, nullptr, nullptr);
}

// Keep mask (B, M) uint8 of greedy NMS; boxes (B, M, 4) f32, scores (B, M)
// f32 or bf16, valid (B, M) uint8 or null, workspace of
// nms_workspace_bytes(B, M) bytes. Three launches. Returns a cudaError_t.
extern "C" int nms_f32_launch(const float* boxes, const float* scores,
                              const uint8_t* valid, int B, int M,
                              int max_keep, float thr, uint8_t* keep,
                              void* workspace, void* stream) {
  return run(boxes, scores, valid, B, M, max_keep, thr, keep, workspace,
             stream);
}

extern "C" int nms_bf16_launch(const float* boxes, const uint16_t* scores,
                               const uint8_t* valid, int B, int M,
                               int max_keep, float thr, uint8_t* keep,
                               void* workspace, void* stream) {
  return run(boxes, scores, valid, B, M, max_keep, thr, keep, workspace,
             stream);
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
