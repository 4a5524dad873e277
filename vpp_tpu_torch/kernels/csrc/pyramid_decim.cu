// K4 — the whole float pyramid from the frame in one launch: level 0 as the
// frame's bordered copy, and every further level as the 1-4-6-4-1/16 filter
// with stride 2 of the level before, each written with its symmetric border.
//
// Replaces vpp_tpu/algorithms/pyramid.py:pyramid (:187) on its float,
// factor-2 path: the symmetric pads (:200, :205) and _binomial_decimate
// (:171, with _decim_matrix :148), which recast the separable filter and
// the stride-2 pick as two banded float32 matrix products A @ x @ B^T so
// that they ride the TPU's matrix unit, one product pair and one pad a
// level. Here one launch writes every level into one buffer.
//
// What it computes, exactly as the matrices do:
//   - output row i reads source rows 2i-2 .. 2i+2 with weights 1,4,6,4,1 /16;
//     a source index below 0 mirrors to -src-1, one at or past n to
//     2n-src-1 (the input is mirrored, not the filtered values);
//   - where two taps land on one source pixel their weights are added first,
//     as _decim_matrix accumulates them into one matrix entry;
//   - the vertical pass is rounded to float32 per intermediate column, then
//     the horizontal pass runs over those five values (t = A x, out = t B^T),
//     each with __fmul_rn / __fadd_rn in tap order;
//   - border pixels take the value of the interior pixel that numpy's
//     "symmetric" pad maps them to (period 2n, edge repeated).
// On integer-valued frames every partial sum at level l <= 2 is a multiple of
// 2^-8l below 256 and fits float32's significand, so the result is bit-equal
// to the products whatever the summation order.
//
// Bound on the H100: device-memory bytes (the frame read once, every
// bordered level written once: ~3.0 MB for a 640x480 frame and three levels
// with border 9, ~0.9 us at 3.35 TB/s). The work is small, so what costs is
// waiting: a launch, a memory latency, a grid barrier. Design: every level
// up to 2 comes out of one phase, with no barrier, from the frame itself:
//   - a level-1 tile (kTH x kTW outputs) stages the (2 kTH + 3) x (2 kTW + 3)
//     source pixels it reads in shared memory once (mirrored indices; every
//     load of a thread in flight before its first store, so that the phase
//     waits one memory latency and not one a pixel), runs the vertical pass
//     into a shared intermediate, then the horizontal pass, and writes each
//     output to every place of the bordered level that maps to it;
//   - a level-2 tile (kFH x kFW outputs) computes the level-1 region it reads
//     (at most (2 kFH + 3) x (2 kFW + 3) pixels) from the frame into shared
//     memory, with the same arithmetic as the level-1 tiles, and decimates
//     that: the halo is computed twice, and bit-equal both times;
//   - level 0's bordered copy goes in chunks of kRows0 rows, each thread's
//     loads issued before its stores.
// Levels 3 and beyond (pyramids deeper than the tracker's three) each follow
// one grid barrier and read the level before from the output buffer, which
// L2 still holds; only such a launch is cooperative, its grid sized from the
// occupancy asked once per device. With `fuse` 0 level 2 takes that route
// too (a barrier after level 1): the design the fused tiles replaced, kept
// so that `call_times.py` can time the two side by side.
//
// Streams: one launch builds the pyramids of S frames, blockIdx.y the
// stream; every stream's CTAs walk its own items, and a grid barrier waits
// for all of them (a stream's output is a function of its frame alone).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 32;   // a level of 2 cannot be decimated: ints end
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 16, kTW = 32;    // a level tile's outputs
constexpr int kFH = 4, kFW = 16;     // a fused level-2 tile's outputs
constexpr int kRH = 2 * kFH + 3, kRW = 2 * kFW + 3;  // its level-1 region
constexpr int kRows0 = 4;        // level-0 rows a copy item takes
constexpr int kCols0 = 3;        // level-0 columns a thread copies at once
constexpr int kMaxDevices = 64;

// the sources that t outputs read
__host__ __device__ constexpr int span(int t) { return 2 * t + 3; }
// shared floats: a level tile's stage and intermediate, or a fused tile's
// stage, intermediate, level-1 region and second intermediate
constexpr int kTileFloats = span(kTH) * span(kTW) + kTH * span(kTW);
constexpr int kFusedFloats = span(kRH) * span(kRW) + kRH * span(kRW) +
                             kRH * kRW + kFH * kRW;
constexpr int kSmemFloats =
    kTileFloats > kFusedFloats ? kTileFloats : kFusedFloats;

struct Levels {
  int n;          // levels of the pyramid
  int first;      // first level written: 0, or 1 (level 0 left unwritten)
  int border;     // every written level's border
  int fused;      // level 2 from the frame in the first phase (else barrier)
  int h[kMaxLevels], w[kMaxLevels];
  long long off[kMaxLevels];  // level l's bordered buffer in out (l >= first)
};

__device__ __forceinline__ int mirror_src(int s, int n) {
  if (s < 0) s = -s - 1;
  if (s >= n) s = 2 * n - s - 1;
  return s;
}

// numpy "symmetric" pad: index into [0, n) of padded position p (may be < 0)
__device__ __forceinline__ int symmetric(int p, int n) {
  if (p >= 0 && p < n) return p;
  int m = p % (2 * n);
  if (m < 0) m += 2 * n;
  return m >= n ? 2 * n - 1 - m : m;
}

// The five weights of output index i over n sources, with the weights of
// taps that land on one (mirrored) source merged into the first of them.
__device__ __forceinline__ void tap_weights(int i, int n, float* wt) {
  const float kw[5] = {1.0f / 16, 4.0f / 16, 6.0f / 16, 4.0f / 16, 1.0f / 16};
#pragma unroll
  for (int t = 0; t < 5; ++t) wt[t] = kw[t];
  if (i >= 1 && 2 * i + 2 < n) return;     // five distinct sources
  int src[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) src[t] = mirror_src(2 * i + t - 2, n);
#pragma unroll
  for (int t = 1; t < 5; ++t) {
#pragma unroll
    for (int u = 0; u < t; ++u) {
      if (wt[t] != 0.0f && wt[u] != 0.0f && src[u] == src[t]) {
        wt[u] += wt[t];
        wt[t] = 0.0f;
      }
    }
  }
}

// Stores v at every place (r, c) of the bordered (n + 2 ob) level whose
// symmetric pad maps to interior pixel (i, j): the pixel itself, and its
// mirror images in the border (more than one a side where ob > n).
__device__ __forceinline__ void store_images(float* dst, int stride, int ob,
                                             int oh, int ow, int i, int j,
                                             float v) {
  if (i >= ob && i < oh - ob && j >= ob && j < ow - ob) {
    dst[(size_t)(i + ob) * stride + j + ob] = v;
    return;
  }
#pragma unroll
  for (int kr = 0; kr < 2; ++kr) {
    const int br = kr == 0 ? i : 2 * oh - 1 - i;
    for (int r = br - ((br + ob) / (2 * oh)) * (2 * oh); r < oh + ob;
         r += 2 * oh) {
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const int bc = kc == 0 ? j : 2 * ow - 1 - j;
        for (int c = bc - ((bc + ob) / (2 * ow)) * (2 * ow); c < ow + ob;
             c += 2 * ow)
          dst[(size_t)(r + ob) * stride + c + ob] = v;
      }
    }
  }
}

// The interval of mirror_src(p, n) over p in [a, b] (-n <= a <= b < 2n,
// a < n, b >= 0): contiguous, and no longer than b - a + 1.
__device__ __forceinline__ void mirrored_range(int a, int b, int n, int* lo,
                                               int* hi) {
  int l = max(a, 0), u = min(b, n - 1);
  if (a < 0) {
    l = min(l, -min(b, -1) - 1);
    u = max(u, -a - 1);
  }
  if (b >= n) {
    l = min(l, 2 * n - 1 - b);
    u = max(u, 2 * n - 1 - max(a, n));
  }
  *lo = l;
  *hi = u;
}

// Stages the sources that outputs [i0, i0 + nr) x [j0, j0 + nc) of a
// (h, w) source read, positions 2 i0 - 2 .. 2 (i0 + nr - 1) + 2 mirrored
// into the source, into `stage` (row stride span(TW)). A warp takes rows,
// a lane columns; every load is issued before the first store.
template <int TH, int TW>
__device__ __forceinline__ void stage_source(const float* src, int sstride,
                                             int h, int w, int i0, int j0,
                                             int nr, int nc, float* stage) {
  constexpr int SW = span(TW);
  constexpr int RPW = (span(TH) + kWarps - 1) / kWarps;
  constexpr int CPL = (SW + 31) / 32;
  const int sr = span(nr), sc = span(nc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cols[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    cols[c] = mirror_src(2 * j0 - 2 + min(lane + 32 * c, sc - 1), w);
  float v[RPW][CPL];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int y = warp + kWarps * k;
    const float* row =
        src + (size_t)mirror_src(2 * i0 - 2 + min(y, sr - 1), h) * sstride;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      v[k][c] = y < sr && lane + 32 * c < sc ? row[cols[c]] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int y = warp + kWarps * k;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (y < sr && lane + 32 * c < sc) stage[y * SW + lane + 32 * c] = v[k][c];
  }
}

// Where tap t of output i reads its input row (or column) in shared memory:
// a staged array holds positions 2 i0 - 2 .. unmirrored (a position and its
// mirror hold the same value, so a merged weight reads the first tap's); a
// region holds the source's own indices lo .. (mirrored first).
template <bool kRegion>
__device__ __forceinline__ int tap_at(int i, int i0, int t, int n, int lo) {
  return kRegion ? mirror_src(2 * i + t - 2, n) - lo : 2 * (i - i0) + t;
}

// Vertical pass: mid[ry][x] = sum_t rw_t in[row of tap t][x] for ry < nr,
// x < ncols, rows of an (n-row) source; `in` and `mid` have row stride S.
template <bool kRegion, int S>
__device__ __forceinline__ void vertical(const float* in, int nr, int ncols,
                                         int i0, int n, int lo, float* mid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ry = warp; ry < nr; ry += kWarps) {
    float rw[5];
    tap_weights(i0 + ry, n, rw);
    int rows[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      rows[t] = tap_at<kRegion>(i0 + ry, i0, t, n, lo);
    for (int x = lane; x < ncols; x += 32) {
      float v = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t)
        if (rw[t] != 0.0f)
          v = __fadd_rn(v, __fmul_rn(rw[t], in[rows[t] * S + x]));
      mid[ry * S + x] = v;
    }
  }
}

// Horizontal pass: emit(ry, cx, sum_t cw_t mid[ry][column of tap t]) for
// ry < nr, cx < nc, columns of an (n-column) source; mid has row stride S.
template <bool kRegion, int S, typename Emit>
__device__ __forceinline__ void horizontal(const float* mid, int nr, int nc,
                                           int j0, int n, int lo, Emit emit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int cx = lane; cx < nc; cx += 32) {
    float cw[5];
    tap_weights(j0 + cx, n, cw);
    int cols[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      cols[t] = tap_at<kRegion>(j0 + cx, j0, t, n, lo);
    for (int ry = warp; ry < nr; ry += kWarps) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 5; ++t)
        if (cw[t] != 0.0f)
          acc = __fadd_rn(acc, __fmul_rn(mid[ry * S + cols[t]], cw[t]));
      emit(ry, cx, acc);
    }
  }
}

__host__ __device__ __forceinline__ int tiles_of(int oh, int ow, int th,
                                                 int tw) {
  return ((oh + th - 1) / th) * ((ow + tw - 1) / tw);
}

// One kTH x kTW tile of the level (oh, ow) below the (h, w) source `src`,
// into the bordered level `dst`.
__device__ void level_tile(const float* src, int sstride, int h, int w,
                           float* dst, int oh, int ow, int ob, int tile,
                           float* smem) {
  const int tiles_w = (ow + kTW - 1) / kTW;
  const int i0 = (tile / tiles_w) * kTH, j0 = (tile % tiles_w) * kTW;
  const int nr = min(kTH, oh - i0), nc = min(kTW, ow - j0);
  constexpr int SW = span(kTW);
  float* stage = smem;
  float* mid = smem + span(kTH) * SW;
  stage_source<kTH, kTW>(src, sstride, h, w, i0, j0, nr, nc, stage);
  __syncthreads();
  vertical<false, SW>(stage, nr, span(nc), i0, h, 0, mid);
  __syncthreads();
  const int dstride = ow + 2 * ob;
  horizontal<false, SW>(mid, nr, nc, j0, w, 0, [&](int ry, int cx, float v) {
    store_images(dst, dstride, ob, oh, ow, i0 + ry, j0 + cx, v);
  });
  __syncthreads();   // the CTA's next item reuses the shared memory
}

// One kFH x kFW tile of level 2 (oh2, ow2) from the frame (h0, w0) through
// the level-1 region it reads, computed here, into the bordered `dst2`.
__device__ void fused_tile(const float* src, int sstride, int h0, int w0,
                           int h1, int w1, float* dst2, int oh2, int ow2,
                           int ob, int tile, float* smem) {
  const int tiles_w = (ow2 + kFW - 1) / kFW;
  const int i0 = (tile / tiles_w) * kFH, j0 = (tile % tiles_w) * kFW;
  const int nr = min(kFH, oh2 - i0), nc = min(kFW, ow2 - j0);
  int rlo, rhi, clo, chi;
  mirrored_range(2 * i0 - 2, 2 * (i0 + nr - 1) + 2, h1, &rlo, &rhi);
  mirrored_range(2 * j0 - 2, 2 * (j0 + nc - 1) + 2, w1, &clo, &chi);
  const int nr1 = rhi - rlo + 1, nc1 = chi - clo + 1;  // <= kRH, kRW
  constexpr int SW = span(kRW);
  float* stage = smem;                         // span(kRH) x SW
  float* mid1 = stage + span(kRH) * SW;        // kRH x SW
  float* region = mid1 + kRH * SW;             // kRH x kRW: level 1
  float* mid2 = region + kRH * kRW;            // kFH x kRW
  stage_source<kRH, kRW>(src, sstride, h0, w0, rlo, clo, nr1, nc1, stage);
  __syncthreads();
  vertical<false, SW>(stage, nr1, span(nc1), rlo, h0, 0, mid1);
  __syncthreads();
  horizontal<false, SW>(mid1, nr1, nc1, clo, w0, 0,
                        [&](int ry, int cx, float v) {
                          region[ry * kRW + cx] = v;
                        });
  __syncthreads();
  vertical<true, kRW>(region, nr, nc1, i0, h1, rlo, mid2);
  __syncthreads();
  const int dstride = ow2 + 2 * ob;
  horizontal<true, kRW>(mid2, nr, nc, j0, w1, clo,
                        [&](int ry, int cx, float v) {
                          store_images(dst2, dstride, ob, oh2, ow2, i0 + ry,
                                       j0 + cx, v);
                        });
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ src, int sstride,
               long long src_streams, Levels lv, float* out,
               long long out_streams) {
  __shared__ float smem[kSmemFloats];
  src += blockIdx.y * src_streams;
  out += blockIdx.y * out_streams;
  const int b = lv.border;
  // one phase: level 1's tiles, level 2's fused tiles, level 0's copy in
  // row chunks
  const int n1 = lv.n > 1 ? tiles_of(lv.h[1], lv.w[1], kTH, kTW) : 0;
  const int n2 = lv.n > 2 && lv.fused ? tiles_of(lv.h[2], lv.w[2], kFH, kFW)
                                       : 0;
  const int bh0 = lv.h[0] + 2 * b, bw0 = lv.w[0] + 2 * b;
  const int n0 = lv.first == 0 ? (bh0 + kRows0 - 1) / kRows0 : 0;
  float* dst0 = out + lv.off[0];
  for (int item = blockIdx.x; item < n1 + n2 + n0; item += gridDim.x) {
    if (item < n1) {
      level_tile(src, sstride, lv.h[0], lv.w[0], out + lv.off[1], lv.h[1],
                 lv.w[1], b, item, smem);
    } else if (item < n1 + n2) {
      fused_tile(src, sstride, lv.h[0], lv.w[0], lv.h[1], lv.w[1],
                 out + lv.off[2], lv.h[2], lv.w[2], b, item - n1, smem);
    } else {
      // kRows0 rows, kCols0 columns a thread at a time, loads before stores
      const int r0 = (item - n1 - n2) * kRows0;
      const float* rows[kRows0];
#pragma unroll
      for (int k = 0; k < kRows0; ++k)
        rows[k] = src + (size_t)symmetric(min(r0 + k, bh0 - 1) - b, lv.h[0]) *
                            sstride;
      for (int c0 = threadIdx.x; c0 < bw0; c0 += kThreads * kCols0) {
        int cs[kCols0];
#pragma unroll
        for (int j = 0; j < kCols0; ++j)
          cs[j] = symmetric(min(c0 + kThreads * j, bw0 - 1) - b, lv.w[0]);
        float v[kRows0][kCols0];
#pragma unroll
        for (int k = 0; k < kRows0; ++k)
#pragma unroll
          for (int j = 0; j < kCols0; ++j)
            v[k][j] = r0 + k < bh0 && c0 + kThreads * j < bw0 ? rows[k][cs[j]]
                                                               : 0.0f;
#pragma unroll
        for (int k = 0; k < kRows0; ++k)
#pragma unroll
          for (int j = 0; j < kCols0; ++j)
            if (r0 + k < bh0 && c0 + kThreads * j < bw0)
              dst0[(size_t)(r0 + k) * bw0 + c0 + kThreads * j] = v[k][j];
      }
    }
  }
  // each deeper level from the one before it, after every CTA wrote that
  for (int l = lv.fused ? 3 : 2; l < lv.n; ++l) {
    cg::this_grid().sync();
    const int pw = lv.w[l - 1] + 2 * b;
    const float* prev = out + lv.off[l - 1] + (size_t)b * pw + b;
    const int nt = tiles_of(lv.h[l], lv.w[l], kTH, kTW);
    for (int item = blockIdx.x; item < nt; item += gridDim.x)
      level_tile(prev, pw, lv.h[l - 1], lv.w[l - 1], out + lv.off[l],
                 lv.h[l], lv.w[l], b, item, smem);
  }
}

}  // namespace

// src: S float32 frame (or level) interiors, h0 x w0 with row stride
// `sstride` elements (a raw frame, or the interior view of a bordered one),
// stream s at src + s * src_streams; stream s's levels at out + s *
// out_streams.
// levels: n rows of (h, w, offset) on the host, level 0 first; offset is
// where level l's (h + 2 border) x (w + 2 border) buffer starts in `out`
// (floats; levels >= first). Writes levels first .. n-1; first is 0 or 1.
// Every level l >= 1 must be a decimation of level l - 1 (2 h_l <= 2 h_{l-1}
// - 1), and with `fuse` 1 level 2 must halve level 1 (2 h_2 <= h_1 + 2), as
// pyramid()'s levels do; `fuse` 0 computes level 2 after a grid barrier.
extern "C" int vpp_pyramid(const float* src, int sstride,
                           long long src_streams, const long long* levels,
                           int n, int first, int border, int fuse,
                           int n_streams, float* out, long long out_streams,
                           void* stream) {
  if (n < 1 || n > kMaxLevels || first < 0 || first > 1 || first >= n ||
      border < 0 || fuse < 0 || fuse > 1 || n_streams < 1 ||
      n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  Levels lv = {};
  lv.n = n;
  lv.first = first;
  lv.border = border;
  lv.fused = fuse;
  for (int l = 0; l < n; ++l) {
    lv.h[l] = (int)levels[3 * l];
    lv.w[l] = (int)levels[3 * l + 1];
    lv.off[l] = levels[3 * l + 2];
    if (lv.h[l] < 1 || lv.w[l] < 1) return (int)cudaErrorInvalidValue;
    // the taps of the last output reach 2 (oh - 1) + 2 <= 2 h - 1
    if (l > 0 && (lv.h[l - 1] < 2 || lv.w[l - 1] < 2 ||
                  2 * lv.h[l] > 2 * lv.h[l - 1] - 1 ||
                  2 * lv.w[l] > 2 * lv.w[l - 1] - 1))
      return (int)cudaErrorInvalidValue;
  }
  // a fused tile's level-1 region fits its shared memory where level 2
  // halves level 1, as pyramid() makes it (1 + h / 2)
  if (fuse && n > 2 &&
      (2 * lv.h[2] > lv.h[1] + 2 || 2 * lv.w[2] > lv.w[1] + 2))
    return (int)cudaErrorInvalidValue;
  const int barrier0 = fuse ? 3 : 2;   // the first level after a barrier
  int work = n > 1 ? tiles_of(lv.h[1], lv.w[1], kTH, kTW) : 0;
  if (n > 2 && fuse) work += tiles_of(lv.h[2], lv.w[2], kFH, kFW);
  if (first == 0) work += (lv.h[0] + 2 * border + kRows0 - 1) / kRows0;
  for (int l = barrier0; l < n; ++l) {
    const int t = tiles_of(lv.h[l], lv.w[l], kTH, kTW);
    work = work > t ? work : t;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  int G = work;
  if (n > barrier0) {
    // grid barriers: a cooperative launch, no more CTAs than can be resident
    // at once. The SM count and the occupancy are asked once per device (0:
    // not yet asked).
    static int sms_of[kMaxDevices], per_sm_of[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (sms_of[dev] == 0) {
      int sms = 0, per_sm = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pyramid_kernel, kThreads, 0);
      if (e != cudaSuccess) return (int)e;
      per_sm_of[dev] = per_sm;
      sms_of[dev] = sms;
    }
    // every stream's CTAs at once: a stream gets its share of the card
    const int resident = sms_of[dev] * per_sm_of[dev] / n_streams;
    if (resident < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    G = work < resident ? work : resident;
    cfg.numAttrs = 1;
  }
  cfg.gridDim = dim3(G, n_streams, 1);
  cudaError_t e = cudaLaunchKernelEx(&cfg, pyramid_kernel, src, sstride,
                                     src_streams, lv, out, out_streams);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
