// K2 — FAST9: the full score map and flag, the detector's score image, and
// the tracker's cull scores.
//
// Replaces vpp_tpu/algorithms/fast.py: fast9_score (:81), fast9_detect
// (:72) and fast9_score_image (:116), which the JAX package writes as a
// 16-slice shifted-view stencil (_circle_diffs) plus the doubled-ring bit
// trick (_has_9_contiguous) for the TPU's vector unit, and the tracker's
// cull, fast9_score(img, th)[clip(round(positions))]
// (vpp_tpu/algorithms/video_extruder.py:140-143), for which the JAX package
// scores every pixel because lockstep beats pointer-chasing on the TPU.
//
// Bound on the H100: device-memory bytes. The full map reads the float32
// frame once and writes an int32 score and, when asked, a uint8 flag a
// pixel (~2.8 MB at 640x480, ~0.85 us at 3.35 TB/s). The score image reads
// the frame and the mask bytes and writes (h+2)(w+2) bytes (~1.85 MB,
// ~0.55 us). The cull reads 8 bytes of position, 17 float32 samples and
// writes 4 bytes a slot (~0.33 MB at 4096 slots, ~0.1 us). The arithmetic
// is ~130 integer operations a pixel, below the memory time; at these sizes
// every mode sits near the time of one launch.
//
// Design.
// * The stencil (full map and score image) is tiled: a CTA of 128 threads
//   stages its 16x32 output tile (kTileH x kTileW) plus the 3-pixel halo from the bordered
//   frame into shared memory, truncating each value to int32 once (as
//   astype(int32) does). Each thread computes 4 neighbouring pixels of a
//   row with compile-time circle offsets into shared memory; a warp covers
//   8 threads x 4 rows and the shared row stride is 1 mod 4, so its loads
//   touch 32 distinct banks. Stores are int4 for scores and 4 bytes at a
//   time for flags and the score image wherever the address allows (two
//   2-byte stores, or bytes, elsewhere).
// * The score image is computed in its own (h+2) x (w+2) coordinates: the
//   kernel writes the zero border itself and min(score / 16, 255) where the
//   flag and the mask (bytes, optional) are non-zero, 0 elsewhere, so
//   neither the int32 map nor a padded copy is ever written. A pixel that
//   the mask closes, or whose four compass points rule out a 9-arc (as the
//   classic FAST test does), is written 0 without the rest of the circle.
// * The cull gives one thread to each slot: it rounds the float position
//   half to even (__float2int_rn, as torch.round and jnp.round do), clamps
//   it into the domain, and scores the pixel from its 17 samples. Those are
//   the samples the full map scores that pixel from, so the values are
//   identical; 4096 slots read ~70k samples instead of scoring 307k pixels.
// Both polarities' ring codes are built in one pass over the circle, and
// the 9-contiguous test is the same four shift-AND rounds on a uint32 (bit
// 31 is written, so the type is unsigned).
// Streams: the score image and the cull take S frames in one launch, the
// stream in blockIdx.z (tiles) or blockIdx.y (slots); each stream reads
// its own frame, mask and positions and writes its own output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;               // output tile, kTileH x kTileW
constexpr int kTileH = 16;               // 16 rows: 600 CTAs at 640x480
constexpr int kPx = 4;                   // neighbouring pixels a thread
constexpr int kThreads = kTileW * kTileH / kPx;
constexpr int kHaloW = kTileW + 6;       // staged columns and rows
constexpr int kHaloH = kTileH + 6;
constexpr int kStride = kHaloW + 3;      // 41 = 1 mod 4: conflict-free warps
constexpr int kLoads = (kHaloH * kHaloW + kThreads - 1) / kThreads;
static_assert(kTileW / kPx == 8, "a warp covers 8 threads x 4 rows");

// The 16 circle offsets (dr, dc), bit k = CIRCLE[k] of
// vpp_tpu/algorithms/fast.py.
#define FAST9_CIRCLE(X)                                                    \
  X(0, -3, -1) X(1, -3, 0) X(2, -3, 1) X(3, -2, 2) X(4, -1, 3) X(5, 0, 3)  \
  X(6, 1, 3) X(7, 2, 2) X(8, 3, 1) X(9, 3, 0) X(10, 3, -1) X(11, 2, -2)    \
  X(12, 1, -3) X(13, 0, -3) X(14, -1, -3) X(15, -2, -2)

__device__ __forceinline__ bool has_9_contiguous(unsigned int code) {
  unsigned int c = code | (code << 16);  // two copies of the 16-bit ring
  unsigned int r2 = c & (c << 1);
  unsigned int r4 = r2 & (r2 << 2);
  unsigned int r8 = r4 & (r4 << 4);
  unsigned int r9 = r8 & (c << 8);       // bit i: AND of bits i-8..i
  return (r9 & 0xFFFF0000u) != 0u;
}

// FAST9 at one pixel; at(dr, dc) gives the truncated value at the offset.
template <typename At>
__device__ __forceinline__ int fast9_at(At at, int th, bool* corner) {
  const int v = at(0, 0);
  int sup = 0, inf = 0;
  unsigned int bright = 0u, dark = 0u;
#define FAST9_STEP(k, dr, dc)      \
  {                                \
    const int d = at(dr, dc) - v;  \
    if (d > th) {                  \
      sup += d;                    \
      bright |= 1u << (k);         \
    }                              \
    if (d < -th) {                 \
      inf -= d;                    \
      dark |= 1u << (k);           \
    }                              \
  }
  FAST9_CIRCLE(FAST9_STEP)
#undef FAST9_STEP
  *corner = has_9_contiguous(bright) || has_9_contiguous(dark);
  return sup > inf ? sup : inf;
}

// Whether a 9-arc may exist: at least two of the four compass points
// brighter than v + th, or at least two darker than v - th.
template <typename At>
__device__ __forceinline__ bool compass_may_pass(At at, int th) {
  const int v = at(0, 0);
  const int d1 = at(-3, 0) - v, d5 = at(0, 3) - v, d9 = at(3, 0) - v,
            d13 = at(0, -3) - v;
  const int nb = (d1 > th) + (d5 > th) + (d9 > th) + (d13 > th);
  const int nd = (d1 < -th) + (d5 < -th) + (d9 < -th) + (d13 < -th);
  return nb >= 2 || nd >= 2;
}

// Four bytes at p, as wide as p's alignment allows; only n < 4 of them at
// the right edge.
__device__ __forceinline__ void store4_u8(uint8_t* p, const int (&v)[kPx],
                                          int n) {
  const uintptr_t a = (uintptr_t)p;
  if (n == kPx && (a & 3u) == 0u) {
    *(uint32_t*)p = (uint32_t)v[0] | ((uint32_t)v[1] << 8) |
                    ((uint32_t)v[2] << 16) | ((uint32_t)v[3] << 24);
  } else if (n == kPx && (a & 1u) == 0u) {
    ((uint16_t*)p)[0] = (uint16_t)(v[0] | (v[1] << 8));
    ((uint16_t*)p)[1] = (uint16_t)(v[2] | (v[3] << 8));
  } else {
    for (int i = 0; i < n; ++i) p[i] = (uint8_t)v[i];
  }
}

__device__ __forceinline__ void store4_i32(int* p, const int (&v)[kPx],
                                           int n) {
  if (n == kPx && ((uintptr_t)p & 15u) == 0u) {
    *(int4*)p = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < n; ++i) p[i] = v[i];
  }
}

// One kTileH x kTileW tile of the output. kImage: the score image, in its own
// (h+2) x (w+2) coordinates (pixel (y, x) of the frame at (y+1, x+1));
// else the full map, score and optional flag in frame coordinates.
template <bool kImage>
__global__ void __launch_bounds__(kThreads)
fast9_tile_kernel(const float* __restrict__ img, int wb, int b, int h, int w,
                  int th, int* __restrict__ score, uint8_t* __restrict__ flag,
                  const uint8_t* __restrict__ mask,
                  uint8_t* __restrict__ image) {
  __shared__ int tile[kHaloH * kStride];
  constexpr int o = kImage ? 1 : 0;      // output offset of frame pixel 0
  const int oh = h + 2 * o, ow = w + 2 * o;
  // stream blockIdx.z: its frame, mask and image (the full map takes one)
  img += (size_t)blockIdx.z * (h + 2 * b) * wb;
  if (mask != nullptr) mask += (size_t)blockIdx.z * h * w;
  if (image != nullptr) image += (size_t)blockIdx.z * oh * ow;
  const int oy0 = blockIdx.y * kTileH, ox0 = blockIdx.x * kTileW;
  // stage frame rows oy0-o-3 .. +kHaloH and columns likewise, as buffer
  // rows/columns (+b); outside the buffer only border outputs read them
  // (all of a thread's loads are issued before the first is used, so the
  // staging waits on one load latency, not on kLoads of them)
  const int hb = h + 2 * b;
  const int by0 = oy0 - o - 3 + b, bx0 = ox0 - o - 3 + b;
  float vals[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kHaloW, c = i - r * kHaloW;
    const int gy = by0 + r, gx = bx0 + c;
    vals[j] = 0.0f;
    if (i < kHaloH * kHaloW && gy >= 0 && gy < hb && gx >= 0 && gx < wb)
      vals[j] = __ldg(img + (size_t)gy * wb + gx);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kHaloW, c = i - r * kHaloW;
    if (i < kHaloH * kHaloW) tile[r * kStride + c] = (int)vals[j];
  }
  __syncthreads();

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int oy = oy0 + ty, ox = ox0 + kPx * tx;
  if (oy >= oh || ox >= ow) return;
  const int n = ow - ox < kPx ? ow - ox : kPx;
  const int y = oy - o;
  int sv[kPx], fv[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    const int x = ox + p - o;
    sv[p] = 0;
    fv[p] = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const int* s = tile + (ty + 3) * kStride + (kPx * tx + p + 3);
      const auto at = [s](int dr, int dc) { return s[dr * kStride + dc]; };
      // the score image is 0 where the mask is 0 and where no 9-arc can
      // exist: fewer than two of the four compass points (bits 1, 5, 9,
      // 13; any 9 contiguous bits hold two of them) brighter, and fewer
      // than two darker
      if (kImage && ((mask != nullptr && mask[(size_t)y * w + x] == 0) ||
                     !compass_may_pass(at, th)))
        continue;
      bool corner;
      const int sc = fast9_at(at, th, &corner);
      if (kImage) {
        // the score is never negative: >> 4 is the floor division by 16
        sv[p] = corner ? (sc >> 4 < 255 ? sc >> 4 : 255) : 0;
      } else {
        sv[p] = sc;
        fv[p] = corner ? 1 : 0;
      }
    }
  }
  const size_t at = (size_t)oy * ow + ox;
  if (kImage) {
    store4_u8(image + at, sv, n);
  } else {
    store4_i32(score + at, sv, n);
    if (flag != nullptr) store4_u8(flag + at, fv, n);
  }
}

__global__ void fast9_cull_kernel(const float* __restrict__ img, int wb,
                                  int b, int h, int w, int th,
                                  const float* __restrict__ pos, int k,
                                  int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  // stream blockIdx.y: its frame, positions and scores
  img += (size_t)blockIdx.y * (h + 2 * b) * wb;
  pos += (size_t)blockIdx.y * 2 * k;
  out += (size_t)blockIdx.y * k;
  // round half to even; a position beyond the int32 range saturates
  int r = __float2int_rn(pos[2 * i]), c = __float2int_rn(pos[2 * i + 1]);
  r = r < 0 ? 0 : (r > h - 1 ? h - 1 : r);
  c = c < 0 ? 0 : (c > w - 1 ? w - 1 : c);
  const float* p = img + (size_t)(r + b) * wb + (c + b);
  bool corner;
  out[i] = fast9_at(
      [p, wb](int dr, int dc) { return (int)p[dr * wb + dc]; }, th, &corner);
}

template <bool kImage>
int launch_tile(const float* img, int wb, int b, int h, int w, int th,
                int* score, uint8_t* flag, const uint8_t* mask,
                uint8_t* image, int n_streams, cudaStream_t st) {
  const int o = kImage ? 1 : 0;
  dim3 grid((w + 2 * o + kTileW - 1) / kTileW,
            (h + 2 * o + kTileH - 1) / kTileH, n_streams);
  fast9_tile_kernel<kImage><<<grid, kThreads, 0, st>>>(
      img, wb, b, h, w, th, score, flag, mask, image);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* vpp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// In every entry, img is the (h + 2b) x wb float32 bordered frame,
// row-major, with b >= 3 (S of them back to back where n_streams is
// given); each returns cudaGetLastError() after its one launch.

// The full map: score h x w int32; flag h x w uint8 or null.
extern "C" int vpp_fast9(const float* img, int wb, int b, int h, int w,
                         int th, int* score, unsigned char* flag,
                         void* stream) {
  if (h <= 0 || w <= 0) return 0;
  return launch_tile<false>(img, wb, b, h, w, th, score, flag, nullptr,
                            nullptr, 1, (cudaStream_t)stream);
}

// The score image of S frames: out S x (h + 2) x (w + 2) uint8, border
// included; mask S x h x w bytes (uint8 or bool) or null.
extern "C" int vpp_fast9_image(const float* img, int wb, int b, int h, int w,
                               int th, const unsigned char* mask,
                               int n_streams, unsigned char* out,
                               void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (n_streams < 1 || n_streams > 65535) return (int)cudaErrorInvalidValue;
  return launch_tile<true>(img, wb, b, h, w, th, nullptr, nullptr, mask, out,
                           n_streams, (cudaStream_t)stream);
}

// The cull of S frames: pos S x k x 2 float32 (row, col) in frame
// coordinates; out S x k int32, the score at each rounded, clamped position.
extern "C" int vpp_fast9_cull(const float* img, int wb, int b, int h, int w,
                              int th, const float* pos, int k, int n_streams,
                              int* out, void* stream) {
  if (k <= 0) return 0;
  if (h <= 0 || w <= 0 || n_streams < 1 || n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  fast9_cull_kernel<<<dim3((k + threads - 1) / threads, n_streams), threads,
                      0, (cudaStream_t)stream>>>(img, wb, b, h, w, th, pos, k,
                                                 out);
  return (int)cudaGetLastError();
}
