// K4 — pyramid decimation: 1-4-6-4-1/16 filter with stride 2, written into
// the next level's bordered buffer.
//
// Replaces vpp_tpu/algorithms/pyramid.py:_binomial_decimate (:171, with
// _decim_matrix :148), which recast the separable filter and the stride-2
// pick as two banded float32 matrix products A @ x @ B^T so that they ride
// the TPU's matrix unit, followed by a separate symmetric pad per level
// (pyramid() :200, :205). Here each output pixel sums its 5 x 5 taps
// directly, and the kernel writes the padded level at once.
//
// What it computes, exactly as the matrices do:
//   - output row i reads source rows 2i-2 .. 2i+2 with weights 1,4,6,4,1 /16;
//     a source index below 0 mirrors to -src-1, one at or past n to
//     2n-src-1 (the input is mirrored, not the filtered values);
//   - where two taps land on one source pixel their weights are added first,
//     as _decim_matrix accumulates them into one matrix entry;
//   - the vertical pass is rounded to float32 per intermediate column, then
//     the horizontal pass runs over those five values (t = A x, out = t B^T);
//   - border pixels of the output take the value of the interior pixel that
//     numpy's "symmetric" pad maps them to (period 2n, edge repeated).
// On integer-valued frames every partial sum at level l <= 2 is a multiple of
// 2^-8l below 256 and fits float32's significand, so the result is bit-equal
// to the products whatever the summation order.
//
// Bound on the H100: device-memory bytes (the level read once, the smaller
// level written once; ~1.5 MB at 640x480, ~0.45 us at 3.35 TB/s). Design: one
// thread per output pixel, 32 x 8 blocks; the 25 reads of neighbouring
// threads overlap and are served by L1 through the read-only path, so the
// source is fetched from device memory about once.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int mirror_src(int s, int n) {
  if (s < 0) s = -s - 1;
  if (s >= n) s = 2 * n - s - 1;
  return s;
}

// numpy "symmetric" pad: index into [0, n) of padded position p (may be < 0)
__device__ __forceinline__ int symmetric(int p, int n) {
  int m = p % (2 * n);
  if (m < 0) m += 2 * n;
  return m >= n ? 2 * n - 1 - m : m;
}

// The five (source, weight) taps of output index i over n sources, with the
// weights of coinciding sources merged into the first of them.
__device__ __forceinline__ void taps(int i, int n, int* src, float* wt) {
  const float kw[5] = {1.0f / 16, 4.0f / 16, 6.0f / 16, 4.0f / 16, 1.0f / 16};
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    src[t] = mirror_src(2 * i + t - 2, n);
    wt[t] = kw[t];
  }
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

__global__ void pyramid_decim_kernel(const float* __restrict__ src,
                                     int stride, int border, int h, int w,
                                     float* __restrict__ out, int oh, int ow,
                                     int ob) {
  const int obw = ow + 2 * ob;
  const int obh = oh + 2 * ob;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= obh || c >= obw) return;
  const int ir = symmetric(r - ob, oh);
  const int ic = symmetric(c - ob, ow);
  int rs[5], cs[5];
  float rw[5], cw[5];
  taps(ir, h, rs, rw);
  taps(ic, w, cs, cw);
  const float* base = src + (size_t)border * stride + border;
  float acc = 0.0f;
#pragma unroll
  for (int tc = 0; tc < 5; ++tc) {
    if (cw[tc] == 0.0f) continue;
    float v = 0.0f;
#pragma unroll
    for (int tr = 0; tr < 5; ++tr) {
      if (rw[tr] == 0.0f) continue;
      v = __fadd_rn(v, __fmul_rn(rw[tr],
                                 __ldg(base + (size_t)rs[tr] * stride + cs[tc])));
    }
    acc = __fadd_rn(acc, __fmul_rn(v, cw[tc]));
  }
  out[(size_t)r * obw + c] = acc;
}

}  // namespace

// src: float32 bordered level (row stride `stride` elements, interior h x w
// at offset `border`); out: (oh + 2 ob) x (ow + 2 ob) float32.
extern "C" int vpp_pyramid_decim(const float* src, int stride, int border,
                                 int h, int w, float* out, int oh, int ow,
                                 int ob, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((ow + 2 * ob + block.x - 1) / block.x,
                  (oh + 2 * ob + block.y - 1) / block.y);
  pyramid_decim_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      src, stride, border, h, w, out, oh, ow, ob);
  return (int)cudaGetLastError();
}
