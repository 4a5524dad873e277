// K5 — patch extraction: N exact size x size patches at integer top-lefts.
//
// Replaces vpp_tpu/core/interp.py:extract_patches_at_tl (:61). On the TPU
// the gather was recast as one-hot selector matrix products (rows via an
// (N*size, H) @ (H, W*C) product, columns via a batched einsum), exact at
// Precision.HIGHEST because every selector row holds a single 1.0; integer
// types took a vmapped dynamic_slice. Here it is the gather itself: one
// thread per output element (n, i, j, c) copies
// data[tl_r + i, tl_c + j, c]. Elements are moved as raw 1, 2, 4 or 8-byte
// words, so every dtype is bit-exact, 2-D data being the case C = 1.
// Top-lefts are clamped into the buffer, as dynamic_slice clamps them (the
// callers clamp already).
//
// Bound on the H100: device-memory bytes (N*size*size*C elements written and
// as many read; 1024 x 7 x 7 float32 is 0.4 MB, ~0.12 us), far below one
// launch: the kernel sits at launch latency.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void patches_kernel(const T* __restrict__ data, int h, int w,
                               int ch, const int* __restrict__ tl, int n,
                               int size, T* __restrict__ out) {
  const long long total = (long long)n * size * size * ch;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)(e % ch);
  long long q = e / ch;
  const int j = (int)(q % size);
  q /= size;
  const int i = (int)(q % size);
  const int p = (int)(q / size);
  int r0 = tl[2 * p], c0 = tl[2 * p + 1];
  r0 = r0 < 0 ? 0 : (r0 > h - size ? h - size : r0);
  c0 = c0 < 0 ? 0 : (c0 > w - size ? w - size : c0);
  out[e] = data[((size_t)(r0 + i) * w + (c0 + j)) * ch + c];
}

template <typename T>
int launch(const void* data, int h, int w, int ch, const int* tl, int n,
           int size, void* out, cudaStream_t st) {
  const long long total = (long long)n * size * size * ch;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  patches_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      (const T*)data, h, w, ch, tl, n, size, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// data: contiguous (h, w, ch) elements of esize bytes; tl: (n, 2) int32;
// out: (n, size, size, ch) elements.
extern "C" int vpp_patches(const void* data, int h, int w, int ch, int esize,
                           const int* tl, int n, int size, void* out,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  switch (esize) {
    case 1: return launch<uint8_t>(data, h, w, ch, tl, n, size, out, st);
    case 2: return launch<uint16_t>(data, h, w, ch, tl, n, size, out, st);
    case 4: return launch<uint32_t>(data, h, w, ch, tl, n, size, out, st);
    case 8: return launch<uint64_t>(data, h, w, ch, tl, n, size, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
