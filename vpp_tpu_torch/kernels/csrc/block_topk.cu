// K3 — blockwise FAST keypoint selection: per-block first-max argmax, then
// the top k of the block winners.
//
// Replaces vpp_tpu/algorithms/fast.py:_blockwise_keypoints (:185). On the
// TPU the score image was padded, reshaped into (nbr, nbc, bs*bs) blocks,
// reduced with argmax/max, and the nb = nbr*nbc winners went through
// lax.top_k. Here:
//   launch A — one warp per block: lanes stride over the block's bs*bs
//     pixels in row-major order (pixels outside the image read -1), keep
//     their first maximum, and a shuffle reduction picks the block's first
//     maximum (larger score, or equal score and smaller index). Lane 0
//     writes the winner's position and score and its sort key;
//   launch B — every block stages the nb keys in shared memory; eight
//     lanes per key count the keys above it (each an eighth of them, then
//     a shuffle adds the counts): that count is its place in the
//     descending order. The first min(k, nb) places are written, padded to
//     k with zeros, as fast.py:211-221 does.
// Keys are all distinct, so the order is fully determined:
//   score*nb + (nb-1-i) where score > 0 (JAX's key: equal scores extract in
//   block-row-major order), and -1-i elsewhere (lax.top_k puts tied -1 keys
//   lower index first; -1-i sorted descending does the same).
// Scores are at most 255 (the uint8 score image) and nb <= 32768 (the keys
// of a block fit its shared memory), so keys fit int32.
//
// Bound on the H100: device-memory bytes (the score image read once: 0.3 MB
// at 640x480 as uint8, ~0.1 us). Launch B's counting is nb^2 comparisons
// (9.4 M at 3072 blocks, 384 serial steps a lane over 96 blocks); a
// single-CTA bitonic sort of the same keys measured 45 us (78 barrier
// stages on one SM), and one lane per key 25 us (3072 serial steps).

#include <climits>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void block_argmax_kernel(const T* __restrict__ data, int stride,
                                    int border, int h, int w, int bs,
                                    int nbc, int nb, int* __restrict__ keys,
                                    int* __restrict__ cand_pos,
                                    int* __restrict__ cand_score) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= nb) return;  // whole warps leave together
  const int br = b / nbc, bc = b % nbc;
  const int area = bs * bs;
  int best = INT_MIN, best_i = INT_MAX;
  for (int i = lane; i < area; i += 32) {
    const int r = br * bs + i / bs, c = bc * bs + i % bs;
    const int v = (r < h && c < w)
        ? (int)data[(size_t)(r + border) * stride + c + border] : -1;
    if (v > best) {  // lanes visit ascending i: the first max stays
      best = v;
      best_i = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    const int score = best > 0 ? best : 0;
    keys[b] = score > 0 ? score * nb + (nb - 1 - b) : -1 - b;
    cand_pos[2 * b] = br * bs + best_i / bs;
    cand_pos[2 * b + 1] = bc * bs + best_i % bs;
    cand_score[b] = score;
  }
}

constexpr int kRankLanes = 8;     // threads that count for one key
constexpr int kRankThreads = 256;

__global__ void __launch_bounds__(kRankThreads)
topk_rank_kernel(const int* __restrict__ keys, int nb, int k,
                 const int* __restrict__ cand_pos,
                 const int* __restrict__ cand_score,
                 int* __restrict__ pos_out, int* __restrict__ score_out,
                 unsigned char* __restrict__ valid_out) {
  extern __shared__ int s[];
  for (int j = threadIdx.x; j < nb; j += blockDim.x) s[j] = keys[j];
  __syncthreads();
  // kRankLanes neighbouring lanes share a key and split its count over the
  // keys (lane q takes j = q, q + kRankLanes, ...), then add their counts
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kRankLanes;
  const int q = threadIdx.x % kRankLanes;
  const int key = i < nb ? s[i] : INT_MAX;
  int rank = 0;
  for (int j = q; j < nb; j += kRankLanes) rank += s[j] > key;
#pragma unroll
  for (int off = kRankLanes / 2; off > 0; off >>= 1)
    rank += __shfl_xor_sync(0xffffffffu, rank, off, kRankLanes);
  if (q != 0) return;
  // keys are distinct: the number of larger keys is this key's place in
  // the descending order
  const int kk = k < nb ? k : nb;
  if (i < nb) {
    if (rank < kk) {
      const bool valid = key >= 0;
      pos_out[2 * rank] = cand_pos[2 * i];
      pos_out[2 * rank + 1] = cand_pos[2 * i + 1];
      score_out[rank] = valid ? cand_score[i] : 0;
      valid_out[rank] = valid ? 1 : 0;
    }
  } else if (i < k) {  // k > nb: pad with zeros
    pos_out[2 * i] = 0;
    pos_out[2 * i + 1] = 0;
    score_out[i] = 0;
    valid_out[i] = 0;
  }
}

}  // namespace

// data: uint8 (elem_bytes 1) or int32 (4) bordered score image, row stride
// `stride` elements, interior h x w at offset `border`. Scratch: keys (nb),
// cand_pos (nb, 2), cand_score (nb) int32. Out: pos (k, 2) int32, score (k)
// int32, valid (k) bytes. nb = ceil(h/bs) * ceil(w/bs) <= max_keys.
extern "C" int vpp_block_topk(const void* data, int elem_bytes, int stride,
                              int border, int h, int w, int bs, int k,
                              int* keys, int* cand_pos, int* cand_score,
                              int* pos_out, int* score_out,
                              unsigned char* valid_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nbr = (h + bs - 1) / bs, nbc = (w + bs - 1) / bs;
  const int nb = nbr * nbc;
  const int warps = 8;
  const int grid_a = (nb + warps - 1) / warps;
  if (elem_bytes == 1) {
    block_argmax_kernel<unsigned char><<<grid_a, warps * 32, 0, st>>>(
        (const unsigned char*)data, stride, border, h, w, bs, nbc, nb, keys,
        cand_pos, cand_score);
  } else if (elem_bytes == 4) {
    block_argmax_kernel<int><<<grid_a, warps * 32, 0, st>>>(
        (const int*)data, stride, border, h, w, bs, nbc, nb, keys, cand_pos,
        cand_score);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = nb * (int)sizeof(int);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(topk_rank_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_out = (long long)(nb > k ? nb : k) * kRankLanes;
  topk_rank_kernel<<<(unsigned)((n_out + kRankThreads - 1) / kRankThreads),
                     kRankThreads, smem, st>>>(
      keys, nb, k, cand_pos, cand_score, pos_out, score_out, valid_out);
  return (int)cudaGetLastError();
}
