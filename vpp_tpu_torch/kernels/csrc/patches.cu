// K5 — patch extraction: N exact size x size patches around integer
// centres (or at integer top-lefts), in one launch.
//
// Replaces vpp_tpu/core/interp.py:extract_patches (:99) and
// extract_patches_at_tl (:61). On the TPU the gather was recast as one-hot
// selector matrix products (rows via an (N*size, H) @ (H, W*C) product,
// columns via a batched einsum), exact at Precision.HIGHEST because every
// selector row holds a single 1.0; integer types took a vmapped
// dynamic_slice. Here it is the gather itself, and the centre arithmetic
// comes with it: the kernel reads the (N, 2) centres as they come (int32 or
// int64, a template on the index type), subtracts `off` (size // 2 for
// centres, 0 for top-lefts) and clamps each top-left to [0, h - size] x
// [0, w - size], as interp.py:109-111 clips and as dynamic_slice clamps. So
// the wrapper makes one launch into one torch.empty, with no conversion or
// clamp before it.
//
// Bound on the H100: device-memory bytes, N x 8 for the centres plus twice
// N x size^2 x C elements (1024 x 7x7 float32: ~0.41 MB, ~0.12 us), far
// below the time of one launch: the design aims at the launch floor. One
// warp takes one patch (a CTA of 8 warps, 8 patches): a patch is `size`
// row spans of size*C contiguous elements, and the lanes walk the
// patch's size*size*C elements row by row, so neighbouring lanes read
// neighbouring addresses of one span and write neighbouring addresses of
// the output. Index arithmetic is 32-bit (the wrapper refuses buffers of
// 2^31 elements or more) and elements move as raw 1, 2, 4 or 8-byte words,
// so every dtype is bit-exact, 2-D data being the case C = 1. Spans start at
// any column, so no wider aligned move is taken.
// Streams: S buffers and (S, N, 2) centres in one launch; warp p takes patch
// p of the S x N, from buffer p / N.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

template <typename T, typename I>
__global__ void __launch_bounds__(kWarps * 32)
patches_kernel(const T* __restrict__ data, int h, int w, int ch,
               const I* __restrict__ ctr, int off, int n, int n_streams,
               int size, T* __restrict__ out) {
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (p >= n * n_streams) return;
  data += (p / n) * h * w * ch;               // the patch's stream
  const int lane = threadIdx.x & 31;
  // every lane reads the same two words: one broadcast transaction
  I r0 = ctr[2 * p] - (I)off, c0 = ctr[2 * p + 1] - (I)off;
  r0 = r0 < 0 ? 0 : (r0 > (I)(h - size) ? (I)(h - size) : r0);
  c0 = c0 < 0 ? 0 : (c0 > (I)(w - size) ? (I)(w - size) : c0);
  const int span = size * ch;                 // elements of one patch row
  const int stride = w * ch;                  // elements of one data row
  const T* src = data + ((int)r0 * w + (int)c0) * ch;
  T* dst = out + p * size * span;
  const int total = size * span;
  int i = lane / span, j = lane - (lane / span) * span;
  const int di = 32 / span, dj = 32 - di * span;
  for (int e = lane; e < total; e += 32) {
    dst[e] = src[i * stride + j];
    i += di;
    j += dj;
    if (j >= span) {
      j -= span;
      ++i;
    }
  }
}

template <typename T, typename I>
int launch(const void* data, int h, int w, int ch, const void* ctr, int off,
           int n, int ns, int size, void* out, cudaStream_t st) {
  const int blocks = (n * ns + kWarps - 1) / kWarps;
  patches_kernel<T, I><<<blocks, kWarps * 32, 0, st>>>(
      (const T*)data, h, w, ch, (const I*)ctr, off, n, ns, size, (T*)out);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch(const void* data, int h, int w, int ch, int esize,
             const void* ctr, int off, int n, int ns, int size, void* out,
             cudaStream_t st) {
  switch (esize) {
    case 1: return launch<uint8_t, I>(data, h, w, ch, ctr, off, n, ns, size, out, st);
    case 2: return launch<uint16_t, I>(data, h, w, ch, ctr, off, n, ns, size, out, st);
    case 4: return launch<uint32_t, I>(data, h, w, ch, ctr, off, n, ns, size, out, st);
    case 8: return launch<uint64_t, I>(data, h, w, ch, ctr, off, n, ns, size, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// data: contiguous (ns, h, w, ch) elements of esize bytes, fewer than 2^31
// of them; ctr: contiguous (ns, n, 2) int32 (ibytes 4) or int64 (ibytes 8)
// centres or top-lefts, stream s's into buffer s; each top-left is ctr -
// off, clamped into the buffer. out: (ns, n, size, size, ch) elements.
extern "C" int vpp_patches(const void* data, int h, int w, int ch, int esize,
                           const void* ctr, int ibytes, int off, int n,
                           int ns, int size, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (size < 1 || size > h || size > w || ns < 1)
    return (int)cudaErrorInvalidValue;
  if (ibytes == 4)
    return dispatch<int32_t>(data, h, w, ch, esize, ctr, off, n, ns, size, out,
                             st);
  if (ibytes == 8)
    return dispatch<int64_t>(data, h, w, ch, esize, ctr, off, n, ns, size, out,
                             st);
  return (int)cudaErrorInvalidValue;
}
