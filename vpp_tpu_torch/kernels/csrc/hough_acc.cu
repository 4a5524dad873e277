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
// 64-bit integer atomics, which commute; the scratch is then converted to
// float32. The result is bit-identical from run to run and differs from the
// exact float32 scatter by at most 2^-25 per vote plus that scatter's own
// rounding.
// Overflow bound: a cell's sum is at most n * max|w| * 2^24 < 2^63, i.e.
// n * max|w| < 2^39 (5.5e11). Binary votes (w <= 1) never overflow; with
// vote_weight="magnitude" the Sobel magnitude of an 8-bit-range image is at
// most sqrt(2) * 1020 < 1443, safe up to 3.8e8 voting pixels.
//
// Bound on the H100: device-memory bytes. At 640x480, w is 1.2 MB in, th
// and rho are read only in the 32-byte sectors that hold an edge pixel
// (the only pixels that vote), and the 255 x 800 float32 accumulator is
// 0.8 MB out: ~0.6 us at 3.35 TB/s on a frame with a few thousand edge
// pixels (chip_smoke.py counts the sectors of its frame).
//
// Design: one cooperative launch, the grid sized from the work and capped
// by the occupancy asked once per device, in three phases over grid-stride
// loops: zero the caller's scratch with 16-byte stores; one grid barrier;
// the votes (w read with 16-byte loads, a scalar head and tail where the
// vector is not 16-byte aligned or a multiple of 4 long); one grid
// barrier; convert, two cells a thread. No state is kept between calls:
// the scratch is the caller's, zeroed by every launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kScale = 16777216.0f;  // 2^24
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void vote(unsigned long long* acc, int idx,
                                     float v) {
  const long long q = __float2ll_rn(v * kScale);
  if (q != 0) atomicAdd(acc + idx, (unsigned long long)q);
}

// The four bilinear votes of pixel i, weight wt != 0.
__device__ __forceinline__ void votes(const float* __restrict__ th,
                                      const float* __restrict__ rho, int i,
                                      float wt, int t_theta, int rho_bins,
                                      unsigned long long* acc) {
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

__global__ void __launch_bounds__(kThreads)
hough_acc_kernel(const float* __restrict__ th, const float* __restrict__ rho,
                 const float* __restrict__ w, int n, int head, int t_theta,
                 int rho_bins, unsigned long long* __restrict__ acc,
                 float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int cells = t_theta * rho_bins;
  const int pairs = cells / 2;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  // 1. zero the scratch (torch.empty's base is 256-byte aligned)
  for (int p = tid; p < pairs; p += nthreads)
    reinterpret_cast<ulonglong2*>(acc)[p] = make_ulonglong2(0ull, 0ull);
  if ((cells & 1) && tid == 0) acc[cells - 1] = 0ull;
  grid.sync();
  // 2. votes: the body four pixels a thread from one 16-byte load of w,
  // then the head (until w is 16-byte aligned) and the tail one pixel a
  // thread
  const int body = (n - head) / 4;
  const float4* w4 = reinterpret_cast<const float4*>(w + head);
  for (int q = tid; q < body; q += nthreads) {
    const float4 v = __ldg(w4 + q);
    const int px = head + 4 * q;
    if (v.x != 0.0f) votes(th, rho, px, v.x, t_theta, rho_bins, acc);
    if (v.y != 0.0f) votes(th, rho, px + 1, v.y, t_theta, rho_bins, acc);
    if (v.z != 0.0f) votes(th, rho, px + 2, v.z, t_theta, rho_bins, acc);
    if (v.w != 0.0f) votes(th, rho, px + 3, v.w, t_theta, rho_bins, acc);
  }
  const int tail0 = head + 4 * body;
  for (int i = tid; i < head + (n - tail0); i += nthreads) {
    const int px = i < head ? i : tail0 + (i - head);
    const float wt = w[px];
    if (wt != 0.0f) votes(th, rho, px, wt, t_theta, rho_bins, acc);
  }
  grid.sync();
  // 3. convert to float32, two cells a thread (out is 256-byte aligned)
  const double inv = 1.0 / 16777216.0;
  for (int p = tid; p < pairs; p += nthreads) {
    const ulonglong2 q = reinterpret_cast<const ulonglong2*>(acc)[p];
    reinterpret_cast<float2*>(out)[p] =
        make_float2((float)((double)(long long)q.x * inv),
                    (float)((double)(long long)q.y * inv));
  }
  if ((cells & 1) && tid == 0)
    out[cells - 1] = (float)((double)(long long)acc[cells - 1] * inv);
}

}  // namespace

// th, rho, w: n float32; scratch: t_theta * rho_bins int64, 16-byte aligned
// (zeroed here); out: t_theta x rho_bins float32, 8-byte aligned.
extern "C" int vpp_hough_acc(const float* th, const float* rho,
                             const float* w, int n, int t_theta,
                             int rho_bins, long long* scratch, float* out,
                             void* stream) {
  const int cells = t_theta * rho_bins;
  if (cells <= 0) return 0;
  if (n < 0 || ((uintptr_t)scratch & 15) || ((uintptr_t)out & 7))
    return (int)cudaErrorInvalidValue;
  // G: enough threads for the largest phase, no more than can be resident
  // at once (a cooperative launch needs them all). The SM count and the
  // occupancy are asked once per device (0: not yet asked).
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
        &per_sm, hough_acc_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    per_sm_of[dev] = per_sm;
    sms_of[dev] = sms;
  }
  const long long resident = (long long)sms_of[dev] * per_sm_of[dev];
  if (resident < 1) return (int)cudaErrorInvalidValue;
  // pixels until w is 16-byte aligned (w is at least 4-byte aligned)
  int head = (int)(((16 - ((uintptr_t)w & 15)) & 15) / 4);
  if (head > n) head = n;
  const long long items = (n + 3) / 4 > (cells + 1) / 2 ? (n + 3) / 4
                                                        : (cells + 1) / 2;
  long long G = (items + kThreads - 1) / kThreads;
  if (G > resident) G = resident;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, hough_acc_kernel, th, rho, w, n, head,
                         t_theta, rho_bins, (unsigned long long*)scratch,
                         out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
