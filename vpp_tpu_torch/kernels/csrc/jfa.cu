// K11 — one jump-flooding pass of the Euclidean distance transform, in one
// cooperative launch: the pass's 8 neighbour steps at stride s, one after
// another over the whole image, grid barriers between them.
//
// Replaces vpp_tpu/algorithms/distance_transform.py:jfa_pass (:209), inside
// euclidean_distance_transform (:185). The JAX pass is 8 whole-image steps,
// not one read of 8 neighbours: each step rolls the closest-seed planes
// *as the previous step left them* by one neighbour offset, and every
// pixel takes the rolled coordinates where they are strictly closer. XLA
// fused each step into a few whole-image operations on the TPU; in plain
// PyTorch on the card a pass is ~130 launches, ~1,500 a 960x540 transform
// of 11 passes. Here a pass is one launch.
//
// Bound on the H100: device-memory bytes, the pass's two int32 planes read
// and two written (960x540: 8.3 MB, ~2.5 us at 3.35 TB/s). Each step reads
// a pixel's own coordinates and its neighbour's (both planes) and writes
// its own, so a pass moves ~8x that between the SMs and L2, where the
// planes and the two ping-pong buffers (16 MB at 960x540) stay resident;
// the 7 grid barriers are the rest. Design: persistent CTAs, as many as
// the card holds at once (a cooperative launch), each taking pixels in a
// grid-stride loop, so neighbouring threads read and write neighbouring
// addresses; steps alternate between a scratch pair and the output pair
// (the input is only read, by the first step), and the eighth step lands
// in the output.
//
// Bits. The JAX package's order: neighbours dr over (-s, 0, s), then dc,
// (0, 0) skipped; the neighbour (dr, dc) of (r, c) is the pixel (r - dr,
// c - dc) (jnp.roll's direction), no candidate outside the domain; "none"
// is -(1 << 20) with distance 1e9; a neighbour is taken where its distance
// is strictly smaller. The JAX loop carries d = min(d, nd), which always
// equals the distance of the coordinates it keeps, so each step recomputes
// it from them. Every distance is a float32 sum of two squared int32
// differences below 2^24, exact, so the pass equals the plain version and
// the JAX package bit for bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNone = -(1 << 20);
constexpr float kInf = 1e9f;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float dist2(int br, int bc, int r, int c) {
  if (br <= kNone) return kInf;
  const float dr = (float)(br - r), dc = (float)(bc - c);
  return __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc));
}

__global__ void __launch_bounds__(kThreads)
jfa_kernel(const int* __restrict__ in_r, const int* __restrict__ in_c, int h,
           int w, int s, int* a_r, int* a_c, int* out_r, int* out_c) {
  cg::grid_group grid = cg::this_grid();
  const int n = h * w;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  int k = 0;
  for (int a = -1; a <= 1; ++a) {
    for (int b = -1; b <= 1; ++b) {
      if (a == 0 && b == 0) continue;
      // step k: the input, then the pair the last step wrote
      const int* src_r = k == 0 ? in_r : ((k & 1) ? a_r : out_r);
      const int* src_c = k == 0 ? in_c : ((k & 1) ? a_c : out_c);
      int* dst_r = (k & 1) ? out_r : a_r;
      int* dst_c = (k & 1) ? out_c : a_c;
      const int dr = a * s, dc = b * s;
      for (int i = first; i < n; i += stride) {
        const int r = i / w, c = i - (i / w) * w;
        int br = src_r[i], bc = src_c[i];
        const int sr = r - dr, sc = c - dc;
        if (sr >= 0 && sr < h && sc >= 0 && sc < w) {
          const int j = sr * w + sc;
          const int nr = src_r[j], nc = src_c[j];
          if (dist2(nr, nc, r, c) < dist2(br, bc, r, c)) {
            br = nr;
            bc = nc;
          }
        }
        dst_r[i] = br;
        dst_c[i] = bc;
      }
      if (++k < 8) grid.sync();
    }
  }
}

}  // namespace

// One pass at stride s. in_r, in_c: contiguous (h, w) int32 closest-seed
// coordinates (kNone where none yet), only read; a_r, a_c: scratch planes;
// out_r, out_c: the pass's result. The five pairs of buffers are distinct;
// h * w < 2^31.
extern "C" int vpp_jfa_pass(const void* in_r, const void* in_c, int h, int w,
                            int s, void* a_r, void* a_c, void* out_r,
                            void* out_c, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (s < 1) return (int)cudaErrorInvalidValue;
  // as many CTAs as the card holds at once (asked once per device)
  static int ctas_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (ctas_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jfa_kernel,
                                                      kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    ctas_of[dev] = sms * per_sm;
  }
  if (ctas_of[dev] < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = ((long long)h * w + kThreads - 1) / kThreads;
  const int G = want < ctas_of[dev] ? (int)want : ctas_of[dev];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, jfa_kernel, (const int*)in_r, (const int*)in_c,
                         h, w, s, (int*)a_r, (int*)a_c, (int*)out_r,
                         (int*)out_c);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
