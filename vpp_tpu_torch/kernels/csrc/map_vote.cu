// K8 — one round of the map vote: the 4 nearest detections of every map
// entry, their translation votes, the 3x3-smoothed vote histogram's peak,
// and each pair's squared distance to it, in one launch.
//
// Replaces vote_round in vpp_tpu/slam/pipeline.py:_map_vote_pnp (:369-409),
// from after the projection: on the TPU a dense (A, Q) distance table, four
// argmin-and-mask passes over it, a scatter-add histogram of 33x33 bins, a
// padded 3x3 sum and an argmax, about 30 separate operations a round in
// plain PyTorch. The plain version is slam/map_vote.py:_vote_round_plain,
// and this kernel is bit-equal to it on the card.
//
// Bound on the H100 at A 1024 map entries and Q 512 detections: the inputs
// (~30 KB) and outputs (~100 KB) are ~0.04 us of device memory; the round
// needs each of the A*Q squared distances once (5 float operations) and
// about one compare a pair to keep a top-4, ~3M operations, ~0.05 us at
// 67 TFLOP/s. Far below one launch: the design aims at one launch with a
// short tail, and recomputes every distance in each of its four passes
// (four times the distance work, design overhead, not part of the bound).
//
// Design. One warp per map entry (8 a CTA): the lanes stride over the Q
// detections, recomputing each squared distance in every one of the four
// passes (no (A, Q) table in memory), and each pass is a warp argmin under
// torch.argmin's order — a NaN first, then the smaller value, then the
// lower index — over the distances with the entries already picked set to
// 1e30 (_HUGE), exactly the JAX sequence of argmin, min and
// `.at[rows, j].set(_HUGE)`. A row whose pred is NaN therefore picks its
// first valid detections, and a row with fewer than 4 valid detections
// repeats an index at 1e30. Lanes 0-3 write js, ds and cand_uv. Every CTA
// then takes a ticket from a global counter after a fence; the last to
// arrive reads every pair back (L2 loads), builds the histogram in shared
// memory (atomicAdd of 1.0: counts below 2^24 add exactly in any order),
// smooths it 3x3, takes the first maximum, writes (tx0, ty0) and every
// pair's dd, and resets the counter for the next launch. The counter is
// the caller's one int32, zeroed once; launches that share it must share
// a stream.
//
// Bits. The plain version computes in separate PyTorch kernels, so each
// product and sum here is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: no FMA contraction under -O3), in the JAX order
// ((cand - pred) * z) / f; bins round half to even (rintf, as torch.round
// and jnp.round) and convert with saturation (as PyTorch's cast on the
// card); bmax, step and r_wide^2 arrive as the float32 values the plain
// version computes with.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kC = 4;
constexpr int kNb = 33;     // histogram bins a side (slam/map_vote.py NB)
constexpr float kHuge = 1e30f;

// torch.argmin's order: a NaN before any number (the lower index among
// NaNs), else the smaller value, else the lower index.
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;
  if (an || bn) return an && (!bn || ai < bi);
  return av < bv || (av == bv && ai < bi);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Args {
  const float* pred;
  const float* z;
  const float* posf;
  const unsigned char* valid;
  const unsigned char* base;
  const float* intr;
  int A, Q;
  float r2, bmax, step;
  int* js;
  float* ds;
  float* cand;
  float* dd;
  float* txy;
  unsigned int* counter;
};

// Pair e = a * kC + c, read back by the last CTA: its translation vote
// (tx, ty) and whether it votes.
__device__ __forceinline__ bool pair_vote(const Args& p, int e, float fx,
                                          float fy, float* tx, float* ty) {
  const int a = e / kC;
  const float pr = p.pred[2 * a], pc = p.pred[2 * a + 1], zz = p.z[a];
  const float cr = __ldcg(p.cand + 2 * e), cc = __ldcg(p.cand + 2 * e + 1);
  *tx = __fdiv_rn(__fmul_rn(__fsub_rn(cc, pc), zz), fx);
  *ty = __fdiv_rn(__fmul_rn(__fsub_rn(cr, pr), zz), fy);
  return p.base[a] && __ldcg(p.ds + e) <= p.r2 && zz > 0.1f;
}

__global__ void __launch_bounds__(kThreads) map_vote_kernel(Args p) {
  __shared__ float hist[kNb * kNb];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + warp;

  if (a < p.A) {
    const float pr = p.pred[2 * a], pc = p.pred[2 * a + 1];
    int picked[kC];
    float pickv[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float bv = __int_as_float(0x7f800000);   // +inf at index INT_MAX:
      int bi = INT_MAX;                        // after every real entry
      for (int j = lane; j < p.Q; j += 32) {
        float v = kHuge;
        if (p.valid[j]) {
          const float dr = __fsub_rn(pr, p.posf[2 * j]);
          const float dc = __fsub_rn(pc, p.posf[2 * j + 1]);
          v = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc));
        }
#pragma unroll
        for (int q = 0; q < c; ++q)
          if (picked[q] == j) v = kHuge;
        if (before(v, j, bv, bi)) {
          bv = v;
          bi = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (before(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      picked[c] = bi;
      pickv[c] = bv;
    }
    if (lane < kC) {
      int j = picked[0];
      float v = pickv[0];
#pragma unroll
      for (int c = 1; c < kC; ++c)
        if (lane == c) {
          j = picked[c];
          v = pickv[c];
        }
      const int e = a * kC + lane;
      p.js[e] = j;
      p.ds[e] = v;
      p.cand[2 * e] = p.posf[2 * j];
      p.cand[2 * e + 1] = p.posf[2 * j + 1];
    }
  }

  // the last CTA to arrive sees every pair
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) *p.counter = 0u;

  const float fx = p.intr[0], fy = p.intr[1];
  constexpr int nbin = kNb * kNb;
  const int total = p.A * kC;
  for (int k = threadIdx.x; k < nbin; k += kThreads) hist[k] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += kThreads) {
    float tx, ty;
    if (pair_vote(p, e, fx, fy, &tx, &ty)) {
      const int bx = clampi(
          (int)rintf(__fdiv_rn(__fadd_rn(tx, p.bmax), p.step)), 0, kNb - 1);
      const int by = clampi(
          (int)rintf(__fdiv_rn(__fadd_rn(ty, p.bmax), p.step)), 0, kNb - 1);
      atomicAdd(&hist[by * kNb + bx], 1.0f);
    }
  }
  __syncthreads();

  // 3x3 smoothing (zero padding) and the first maximum
  float best = -1.0f;
  int bidx = INT_MAX;
  for (int k = threadIdx.x; k < nbin; k += kThreads) {
    const int r = k / kNb, c = k - r * kNb;
    float s = 0.0f;
    for (int dr = -1; dr <= 1; ++dr)
      for (int dc = -1; dc <= 1; ++dc) {
        const int rr = r + dr, cc = c + dc;
        if (rr >= 0 && rr < kNb && cc >= 0 && cc < kNb)
          s += hist[rr * kNb + cc];
      }
    if (s > best) {   // k ascends: a thread keeps its first maximum
      best = s;
      bidx = k;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
    if (ov > best || (ov == best && oi < bidx)) {
      best = ov;
      bidx = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  best = red_v[0];
  bidx = red_i[0];
  for (int w = 1; w < kWarps; ++w)
    if (red_v[w] > best || (red_v[w] == best && red_i[w] < bidx)) {
      best = red_v[w];
      bidx = red_i[w];
    }
  const bool any = best > 0.0f;
  const float tx0 =
      any ? __fsub_rn(__fmul_rn((float)(bidx % kNb), p.step), p.bmax) : 0.0f;
  const float ty0 =
      any ? __fsub_rn(__fmul_rn((float)(bidx / kNb), p.step), p.bmax) : 0.0f;
  if (threadIdx.x == 0) {
    p.txy[0] = tx0;
    p.txy[1] = ty0;
  }
  for (int e = threadIdx.x; e < total; e += kThreads) {
    float tx, ty;
    const bool m = pair_vote(p, e, fx, fy, &tx, &ty);
    const float ex = __fsub_rn(tx, tx0), ey = __fsub_rn(ty, ty0);
    p.dd[e] = m ? __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) : kHuge;
  }
}

}  // namespace

extern "C" int vpp_map_vote(const float* pred, const float* z,
                            const float* posf, const unsigned char* valid,
                            const unsigned char* base, const float* intr,
                            int A, int Q, float r2, float bmax, float step,
                            int* js, float* ds, float* cand,
                            float* dd, float* txy, unsigned int* counter,
                            void* stream) {
  if (A < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  Args p{pred, z,    posf, valid, base, intr, A,      Q,      r2,
         bmax, step, js,   ds,    cand, dd,   txy,   counter};
  const int blocks = (A + kWarps - 1) / kWarps;
  map_vote_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
