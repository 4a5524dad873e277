// K3 — blockwise FAST keypoint selection: per-block first-max argmax, then
// the top k of the block winners, in one cooperative launch over the card.
//
// Replaces vpp_tpu/algorithms/fast.py:_blockwise_keypoints (:185). On the
// TPU the score image was padded, reshaped into (nbr, nbc, bs*bs) blocks,
// reduced with argmax/max, and the nb = nbr*nbc winners went through
// lax.top_k on the keys score*nb + (nb-1-i) (score > 0) and -1-i (else).
// That order is fully determined: winners in descending score, equal
// scores in ascending block index, then the score-0 winners in ascending
// index. The scores are the FAST score/16 image, 0..255, so the top k is a
// stable counting sort over 256 buckets. G CTAs (one per kBlocksPerCta
// blocks, at most one per SM), each owning a contiguous range of blocks, so
// that CTA order is index order:
//   1. a warp takes 32 / bs blocks side by side, bs lanes each (lanes own
//      columns and walk down the rows, so a row is one span of loads), two
//      such sets at once; each lane keeps the first maximum of its column
//      (pixels outside the image read -1), and a segmented shuffle
//      reduction picks the block's first maximum (larger score, or equal
//      score and smaller row-major index). The segment's first lane writes
//      the winner (score and in-block index) to device memory and counts
//      its score in the CTA's 256-bin histogram (shared memory), which then
//      goes to device memory as row g of a (G, 256) table;
//   2. one grid barrier (the launch is cooperative, so every CTA is
//      resident); each CTA reads the table, two threads a score, each
//      walking half the rows with its loads unrolled: for each score s, the
//      winners of s in all CTAs and in the CTAs before it, and from those,
//      by a scan over the scores, where its first winner of score s places;
//   3. the CTA walks its winners in index order, a chunk of blockDim at a
//      time: __match_any_sync and a popcount rank each winner among the
//      equal scores of its warp, per-warp counts among the warps before
//      it, and a running count per score among the chunks before. Its
//      place is the sum; places below min(k, nb) are written;
//   4. slots min(k, nb) .. k are padded with zeros, as fast.py:211-221.
// Only integers are summed, so two launches give the same bits. A score
// outside 0..255 (possible only for an int32 score image) traps: a CUDA
// error at the next synchronisation, never a wrong order. The JAX key
// itself needs nb <= 2^31 / 256; the wrapper checks it.
//
// Streams: one launch takes the score images of S frames, blockIdx.y the
// stream, each with its own G CTAs, winners, table and outputs; the one
// grid barrier is shared. The whole grid must be co-resident, so G is
// sized per stream: at most one CTA per SM and per stream, and G * S no
// more than the card holds at once (a cooperative launch of more is
// refused).
//
// Bound on the H100: device-memory bytes (the score image read once: 0.3 MB
// at 640x480 as uint8, ~0.1 us). The launch sits at the latency of its
// argmax loads and of the grid barrier.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kGroups = 2;          // sets of blocks a warp reduces at once
constexpr int kBlocksPerCta = 64;   // the fewest blocks a CTA takes
constexpr int kMaxDevices = 64;
static_assert(kThreads == 2 * kBins, "phase 2 takes two threads a score");

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const T* __restrict__ data, long long data_streams,
                  int stride, int border, int h, int w, int bs, int nbc,
                  int nb, int k, int* __restrict__ scratch,
                  long long scratch_streams, int* __restrict__ pos_out,
                  int* __restrict__ score_out,
                  unsigned char* __restrict__ valid_out) {
  cg::grid_group grid = cg::this_grid();
  const int g = blockIdx.x, G = gridDim.x;
  // stream blockIdx.y: its image, winners, histogram table and outputs
  data += blockIdx.y * data_streams;
  int* const cand_score = scratch + blockIdx.y * scratch_streams;
  int* const cand_idx = cand_score + nb;
  int* const table = cand_score + 2 * nb;
  pos_out += (size_t)blockIdx.y * 2 * k;
  score_out += (size_t)blockIdx.y * k;
  valid_out += (size_t)blockIdx.y * k;
  __shared__ int hist[kBins];          // this CTA's, then every CTA's, count
  __shared__ int base[kBins];          // where score s places next
  __shared__ int wcnt[kWarps][kBins];  // a chunk's count per warp and score
  __shared__ int scan[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int s = tid; s < kBins; s += blockDim.x) hist[s] = 0;
  for (int i = tid; i < kWarps * kBins; i += blockDim.x) (&wcnt[0][0])[i] = 0;
  __syncthreads();
  const int per = (nb + G - 1) / G;
  const int lo = min(nb, g * per), hi = min(nb, lo + per);

  // 1. per-block first maximum. A warp takes bpw blocks side by side, a
  // segment of bs lanes each (bs <= 32; else one block, its lanes striding
  // over the columns), kGroups such sets at once. Each lane walks its
  // column down the block's rows, so that a row's loads are one span and no
  // pixel index is divided, and keeps its first maximum; pixels outside the
  // image read -1, folded in as the block's first outside pixel.
  const int seg = bs <= 32 ? bs : 32;           // lanes a block
  const int bpw = 32 / seg;                     // blocks a warp at once
  const int sub = lane / seg, pc0 = lane - sub * seg;
  const int seg_end = (sub + 1) * seg;          // past this segment's lanes
  const bool active = sub < bpw;
  for (int b0 = lo + warp * bpw * kGroups; b0 < hi;
       b0 += kWarps * bpw * kGroups) {
    int best[kGroups], best_i[kGroups], r0[kGroups], c0[kGroups];
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int b = b0 + q * bpw + sub;
      const int rb = b / nbc;
      r0[q] = active && b < hi ? rb * bs : h;   // h: not a block of this CTA
      c0[q] = (b - rb * nbc) * bs;
      best[q] = INT_MIN;
      best_i[q] = INT_MAX;
    }
    for (int pc = pc0; pc < bs; pc += 32) {
      const T* p[kGroups];
      int nr[kGroups];
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        const int c = c0[q] + pc;
        nr[q] = c < w ? min(bs, h - r0[q]) : 0;    // rows inside the image
        p[q] = data + (size_t)(r0[q] + border) * stride + c + border;
      }
#pragma unroll 2
      for (int pr = 0; pr < bs; ++pr) {
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          if (pr < nr[q]) {
            const int v = (int)p[q][pr * stride];
            const int i = pr * bs + pc;
            if (v > best[q] || (v == best[q] && i < best_i[q])) {
              best[q] = v;
              best_i[q] = i;
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      if (pc0 == 0 && r0[q] < h) {
        const int out_r = h - r0[q] < bs ? (h - r0[q]) * bs : INT_MAX;
        const int out_c = w - c0[q] < bs ? w - c0[q] : INT_MAX;
        const int io = min(out_r, out_c);
        if (io != INT_MAX
            && (-1 > best[q] || (-1 == best[q] && io < best_i[q]))) {
          best[q] = -1;
          best_i[q] = io;
        }
      }
      // the segment's first lane gathers its lanes' (larger score, or equal
      // score and smaller index)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ov = __shfl_down_sync(0xffffffffu, best[q], off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i[q], off);
        if (lane + off < seg_end
            && (ov > best[q] || (ov == best[q] && oi < best_i[q]))) {
          best[q] = ov;
          best_i[q] = oi;
        }
      }
      const int b = b0 + q * bpw + sub;
      if (pc0 == 0 && r0[q] < h) {
        if (best[q] > kBins - 1) __trap();
        const int score = best[q] > 0 ? best[q] : 0;
        cand_score[b] = score;
        cand_idx[b] = best_i[q];
        atomicAdd(&hist[score], 1);
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < kBins; s += blockDim.x) table[g * kBins + s] = hist[s];
  grid.sync();

  // 2. per score: the winners in every CTA (hist) and in the CTAs before
  // this one (base); thread t sums score t % 256 over the rows of its half
  {
    const int s = tid & (kBins - 1), half = tid >> 8;
    int tot = 0, low = 0;
#pragma unroll 8
    for (int q = half; q < G; q += 2) {
      const int c = __ldcg(table + q * kBins + s);
      tot += c;
      low += q < g ? c : 0;
    }
    if (half == 1) {          // wcnt's first two rows as scratch
      wcnt[0][s] = tot;
      wcnt[1][s] = low;
    }
    __syncthreads();
    if (half == 0) {
      hist[s] = tot + wcnt[0][s];
      base[s] = low + wcnt[1][s];
      wcnt[0][s] = 0;
      wcnt[1][s] = 0;
    }
  }
  __syncthreads();
  // base[s] += the winners of higher scores: a scan over the bins in
  // reverse (threads 0..255 take bins 255..0)
  const int s_of = kBins - 1 - tid;
  const int tot = tid < kBins ? hist[s_of] : 0;
  int incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (tid < kBins) {
    int above = incl - tot;
    for (int w2 = 0; w2 < warp; ++w2) above += scan[w2];
    base[s_of] += above;
  }
  __syncthreads();

  // 3. stable places, a chunk of blockDim winners at a time
  const int kk = min(k, nb);
  const unsigned below = (1u << lane) - 1u;
  for (int c0 = lo; c0 < hi; c0 += blockDim.x) {
    const int b = c0 + tid;
    const int s = b < hi ? cand_score[b] : -1;
    const unsigned grp = __match_any_sync(0xffffffffu, s);
    const int before = __popc(grp & below);
    if (s >= 0 && before == 0) wcnt[warp][s] = __popc(grp);
    __syncthreads();
    if (s >= 0) {
      int place = base[s] + before;
      for (int w2 = 0; w2 < warp; ++w2) place += wcnt[w2][s];
      if (place < kk) {
        const int i = cand_idx[b];
        pos_out[2 * place] = (b / nbc) * bs + i / bs;
        pos_out[2 * place + 1] = (b % nbc) * bs + i % bs;
        score_out[place] = s;
        valid_out[place] = s > 0 ? 1 : 0;
      }
    }
    __syncthreads();
    if (tid < kBins) {
      int add = 0;
      for (int w2 = 0; w2 < kWarps; ++w2) {
        add += wcnt[w2][tid];
        wcnt[w2][tid] = 0;
      }
      base[tid] += add;
    }
    __syncthreads();
  }

  // 4. k > nb: pad with zeros
  for (int i = kk + g * blockDim.x + tid; i < k; i += G * blockDim.x) {
    pos_out[2 * i] = 0;
    pos_out[2 * i + 1] = 0;
    score_out[i] = 0;
    valid_out[i] = 0;
  }
}

template <typename T>
cudaError_t launch(const T* data, long long data_streams, int stride,
                   int border, int h, int w, int bs, int nbc, int nb, int k,
                   int n_streams, int* scratch, long long scratch_ints,
                   int* pos_out, int* score_out, unsigned char* valid_out,
                   cudaStream_t stream) {
  // G a stream: one CTA per pass of its warps, at most one per SM, and no
  // more than the card holds at once for all S streams (a cooperative
  // launch needs them all resident). The SM count and the occupancy are
  // asked once per device (0: not yet asked).
  static int sms_of[kMaxDevices], per_sm_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, block_topk_kernel<T>, kThreads, 0);
    if (e != cudaSuccess) return e;
    per_sm_of[dev] = per_sm;
    sms_of[dev] = sms;
  }
  const int sms = sms_of[dev];
  const int share = sms * per_sm_of[dev] / n_streams;
  if (share < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int want = (nb + kBlocksPerCta - 1) / kBlocksPerCta;
  int G = want < sms ? want : sms;
  G = G < share ? G : share;
  if (2LL * nb + (long long)kBins * G > scratch_ints)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, n_streams, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, block_topk_kernel<T>, data, data_streams,
                         stride, border, h, w, bs, nbc, nb, k, scratch,
                         scratch_ints, pos_out, score_out, valid_out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// data: S uint8 (elem_bytes 1) or int32 (4) bordered score images, row
// stride `stride` elements, interior h x w at offset `border`, stream s at
// data + s * data_streams elements. Scratch: int32, `scratch_ints` a
// stream (stream s at scratch + s * scratch_ints), at least 2 nb + 256
// min(SMs, ceil(nb / 64)), with nb = ceil(h/bs) * ceil(w/bs). Out: pos
// (S, k, 2) int32, score (S, k) int32, valid (S, k) bytes.
extern "C" int vpp_block_topk(const void* data, int elem_bytes, int stride,
                              int border, int h, int w, int bs, int k,
                              int n_streams, long long data_streams,
                              int* scratch, long long scratch_ints,
                              int* pos_out, int* score_out,
                              unsigned char* valid_out, void* stream) {
  if (bs < 1 || k < 1 || h < 1 || w < 1 || n_streams < 1 ||
      n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  const int nbr = (h + bs - 1) / bs, nbc = (w + bs - 1) / bs;
  const int nb = nbr * nbc;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem_bytes == 1)
    return (int)launch((const unsigned char*)data, data_streams, stride,
                       border, h, w, bs, nbc, nb, k, n_streams, scratch,
                       scratch_ints, pos_out, score_out, valid_out, st);
  if (elem_bytes == 4)
    return (int)launch((const int*)data, data_streams, stride, border, h, w,
                       bs, nbc, nb, k, n_streams, scratch, scratch_ints,
                       pos_out, score_out, valid_out, st);
  return (int)cudaErrorInvalidValue;
}
