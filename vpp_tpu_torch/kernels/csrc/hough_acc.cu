// K7 — dense Hough accumulator.
//
// Replaces vpp_tpu/algorithms/hough_pallas.py:hough_accumulator_pallas (:68,
// body _kernel :42), the drop-in for hough.py:hough_accumulator (:60). On
// the TPU the votes were recast as chunked rank-1 tent-weight products in
// bf16 so that they ride the matrix unit, with the (t, r) accumulator kept
// in VMEM across the sequential grid. Here each pixel scatters its four
// bilinear votes directly: sum_p w_p max(0, 1-|t-th_p|) max(0, 1-|r-rho_p|)
// with the clipping of hough.py:87-93.
//
// Inputs are the same (theta_n, rho_n, w) vectors as the Pallas kernel;
// entries of weight 0 (non-edge pixels, padding) cast no vote.
//
// Determinism: the reference made its transform deterministic on purpose
// (hough.py:19-24), and float atomicAdd is not. Each weighted vote is
// rounded to a 64-bit fixed-point integer at 2^24 scale and added with
// 64-bit integer atomics, which commute; a second launch converts the
// scratch to float32. The result is bit-identical from run to run and
// differs from the exact float32 scatter by at most 2^-25 per vote plus
// that scatter's own rounding.
// Overflow bound: a cell's sum is at most n * max|w| * 2^24 < 2^63, i.e.
// n * max|w| < 2^39 (5.5e11). Binary votes (w <= 1) never overflow; with
// vote_weight="magnitude" the Sobel magnitude of an 8-bit-range image is at
// most sqrt(2) * 1020 < 1443, safe up to 3.8e8 voting pixels.
//
// Bound on the H100: device-memory bytes. At 640x480 the three float32
// vectors are 3.7 MB in and the 255 x 800 float32 accumulator 0.8 MB out,
// ~1.4 us at 3.35 TB/s; only edge pixels issue atomics.
//
// Design: one thread per pixel; the scratch is cleared with an async memset
// on the caller's stream; one thread per cell converts.

#include <cuda_runtime.h>

namespace {

constexpr float kScale = 16777216.0f;  // 2^24

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void vote(unsigned long long* acc, int idx,
                                     float v) {
  const long long q = __float2ll_rn(v * kScale);
  if (q != 0) atomicAdd(acc + idx, (unsigned long long)q);
}

__global__ void hough_vote_kernel(const float* __restrict__ th,
                                  const float* __restrict__ rho,
                                  const float* __restrict__ w, int n,
                                  int t_theta, int rho_bins,
                                  unsigned long long* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wt = w[i];
  if (!(wt != 0.0f)) return;
  const float tn = th[i], rn = rho[i];
  const float t0f = floorf(tn), r0f = floorf(rn);
  const float ft = tn - t0f, fr = rn - r0f;
  const int t0 = clampi((int)t0f, 0, t_theta - 1);
  const int r0 = clampi((int)r0f, 0, rho_bins - 1);
  const int t1 = min(t0 + 1, t_theta - 1);
  const int r1 = min(r0 + 1, rho_bins - 1);
  const float a0 = wt * (1.0f - ft), a1 = wt * ft;
  vote(acc, t0 * rho_bins + r0, a0 * (1.0f - fr));
  vote(acc, t0 * rho_bins + r1, a0 * fr);
  vote(acc, t1 * rho_bins + r0, a1 * (1.0f - fr));
  vote(acc, t1 * rho_bins + r1, a1 * fr);
}

__global__ void hough_convert_kernel(const unsigned long long* __restrict__ acc,
                                     int cells, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  out[i] = (float)((double)(long long)acc[i] * (1.0 / 16777216.0));
}

}  // namespace

// th, rho, w: n float32; scratch: t_theta * rho_bins int64 (cleared here);
// out: t_theta x rho_bins float32.
extern "C" int vpp_hough_acc(const float* th, const float* rho,
                             const float* w, int n, int t_theta,
                             int rho_bins, long long* scratch, float* out,
                             void* stream) {
  const int cells = t_theta * rho_bins;
  if (cells <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(long long) * cells, s);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  unsigned long long* acc = (unsigned long long*)scratch;
  if (n > 0) {
    hough_vote_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        th, rho, w, n, t_theta, rho_bins, acc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  hough_convert_kernel<<<(cells + threads - 1) / threads, threads, 0, s>>>(
      acc, cells, out);
  return (int)cudaGetLastError();
}
