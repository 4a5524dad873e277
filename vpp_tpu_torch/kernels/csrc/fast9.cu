// K2 — FAST9 score and detection stencil.
//
// Replaces vpp_tpu/algorithms/fast.py: fast9_score (:81) and fast9_detect
// (:72), which the JAX package writes as a 16-slice shifted-view stencil
// (_circle_diffs) plus the doubled-ring bit trick (_has_9_contiguous) for
// the TPU's vector unit.
//
// Bound on the H100: device-memory bytes. Per interior pixel it reads one
// float32 centre (the 16 circle reads hit the same rows, served from L1/L2)
// and writes one int32 score and, when asked, one uint8 flag: about 9 bytes
// a pixel, ~2.8 MB at 640x480, ~0.9 us at 3.35 TB/s. The arithmetic is ~130
// integer operations a pixel, below the memory time.
//
// Design: one thread per interior pixel, 32x8 blocks so a warp reads 32
// consecutive floats of a row. The pixel values are truncated to int32
// exactly as the JAX package's astype(int32) does; both polarities' ring
// codes are built in one pass over the circle, and the 9-contiguous test is
// the same four shift-AND rounds on a uint32 (bit 31 is written, so the
// type is unsigned). One launch gives both the score (the tracker's cull)
// and the flag (fast9_score_image's detection mask).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The 16 circle offsets, bit k = CIRCLE[k] of vpp_tpu/algorithms/fast.py.
__constant__ int kDr[16] = {-3, -3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2};
__constant__ int kDc[16] = {-1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2};

__device__ __forceinline__ bool has_9_contiguous(unsigned int code) {
  unsigned int c = code | (code << 16);  // two copies of the 16-bit ring
  unsigned int r2 = c & (c << 1);
  unsigned int r4 = r2 & (r2 << 2);
  unsigned int r8 = r4 & (r4 << 4);
  unsigned int r9 = r8 & (c << 8);       // bit i: AND of bits i-8..i
  return (r9 & 0xFFFF0000u) != 0u;
}

__global__ void fast9_kernel(const float* __restrict__ img, int wb, int b,
                             int h, int w, int th, int* __restrict__ score,
                             uint8_t* __restrict__ detect) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* p = img + (size_t)(y + b) * wb + (x + b);
  const int v = (int)p[0];
  int sup = 0, inf = 0;
  unsigned int bright = 0u, dark = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int d = (int)p[kDr[k] * wb + kDc[k]] - v;
    if (d > th) {
      sup += d;
      bright |= 1u << k;
    }
    if (d < -th) {
      inf -= d;
      dark |= 1u << k;
    }
  }
  const size_t o = (size_t)y * w + x;
  score[o] = sup > inf ? sup : inf;
  if (detect != nullptr)
    detect[o] = (has_9_contiguous(bright) || has_9_contiguous(dark)) ? 1 : 0;
}

}  // namespace

extern "C" const char* vpp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// img: (h + 2b) x wb float32, row-major; score: h x w int32; detect: h x w
// uint8 or null. Returns cudaGetLastError() after the launch.
extern "C" int vpp_fast9(const float* img, int wb, int b, int h, int w,
                         int th, int* score, unsigned char* detect,
                         void* stream) {
  if (h <= 0 || w <= 0) return 0;
  dim3 block(32, 8);
  dim3 grid((w + 31) / 32, (h + 7) / 8);
  fast9_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, wb, b, h, w, th, score, detect);
  return (int)cudaGetLastError();
}
