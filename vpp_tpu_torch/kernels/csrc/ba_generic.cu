// K9 — bundle adjustment on the generic tracks layout: every
// Levenberg-Marquardt iteration of ba_solve_tracks(ring_layout=False), where
// obs_pose (N, K) names any pose for each observation slot.
//
// Replaces vpp_tpu/slam/ba.py:ba_solve_tracks (:568) on the generic layout:
// the gather of each observation's pose (_obs_poses :403), the analytic
// Jacobians (_track_jacobians :414), the per-landmark Hll, bl, damped
// inverse, U and W, the scatter-add assembly of the generic branch
// (_tracks_assemble :512-526: Hpp and bp scattered by pose, the per-landmark
// (N, K, K, 6, 6) pair tensor -W_k U_l^T scattered into S[pose_k, pose_l],
// and rhs), the back-substitution (_tracks_backsub :563), the candidate's
// cost (_tracks_cost :445) and the accept test. On the TPU the assembly was
// an XLA scatter of N K^2 6x6 blocks; here an index built once a call makes
// the sparsity of S free:
//   index (one CTA, once a call) — each slot's scatter pose (the JAX rule:
//     a negative index counts from the end, one still outside [0, M) is
//     dropped; an invalid slot goes to pose 0, where its weight is 0), a
//     stable counting sort of the slots by that pose (per-warp counts, a
//     scan, then ranks from __match_any_sync in slot order), the flags of
//     the non-empty 6x6 blocks of S (every diagonal block included), and
//     those blocks compacted into a list in row-major order;
//   landmarks (a thread a landmark) — per slot the residual, the Jacobians
//     Jp (2x6) and Jl (2x3) in float32 with proj_jacobians' |z| < 1e-6 clamp
//     at the gathered pose (negative indices from the end, then clamped into
//     [0, M), as JAX gathers), the Huber weight masked by obs_valid and the
//     float32 cost term; then in float64 Hll, bl, seen, Hll + (lam + 1e-6) I
//     (I where unseen), its inverse (_inv3 for linalg="chol", a pivoted 3x3
//     for "lu"), U = Jp_w^T Jl and W = U Hll_inv, all to device memory;
//   blocks (a warp a non-empty block of S) — the lanes share the slots that
//     scatter to the block's row pose, in slot order, and for each add
//     -W_k U_l^T for every slot l of the same landmark that scatters to the
//     column pose, plus Jp_w^T Jp and rhs (bp - W bl) on the diagonal
//     blocks; a butterfly of shuffles sums the lanes. Warp 0 also sums the
//     landmark kernel's per-CTA costs. S, rhs and the cost are rounded to
//     float32 from float64 sums;
//   prep (a thread an entry of S) — _tracks_solve_poses' damping lam I,
//     identity rows and columns for fixed poses, and Jacobi scaling;
//   the pose solve is the library's dense LU or Cholesky (cuSOLVER through
//     torch.linalg, outside this file), as in the plain version;
//   step (a thread a landmark) — dp = d x (NaN where the factorisation
//     failed), se3_exp(dp_k) @ T_k for every free pose (each CTA its own
//     copy), dl = Hll_inv (bl - sum_k U_k^T dp_k) (zero where unseen), the
//     candidate landmark and its Huber cost over its valid slots;
//   decide (a thread a landmark) — every CTA sums the step kernel's per-CTA
//     costs in the same order, so each takes the same decision: accept
//     where new < old (NaN rejects); CTA 0 records the cost, the trace and
//     lam = accept ? max(0.3 lam, 1e-8) : min(4 lam, 1e4) and moves the
//     poses, every CTA its landmarks.
// No float atomics anywhere: every sum runs in an order fixed by the inputs,
// so two calls on the same inputs give the same bits (the accept test
// compares two costs). No host read between launches: lam, the costs and
// the decisions stay on the device.
//
// Precision, as in the plain version (slam/ba.py): residuals and Jacobians
// in float32; the landmark blocks (Hll, its inverse, U, W, bl, dl) and the
// sums of S, rhs and the costs in float64, rounded to float32; the pose
// solve and the pose step in float32. Invalid slots run the same arithmetic
// with weight 0, so a non-finite obs_uv there makes the cost and bl NaN as
// in the plain version (and in the JAX package).
//
// Bound on the H100 at N 10240, M 128, K 4 (the JAX package's production
// scale): an iteration is ~0.2 M float32 Jacobian operations, ~20 M float64
// operations of landmark algebra and pairs, and the (6M)^3 / 3 = 1.5e8 of
// the pose factorisation, against ~0.8 MB of inputs. The kernels sit at
// latency: one thread a landmark, and a warp a block of S walks its slots
// one after another; the dense factorisation is the library's.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "pose_math.cuh"

namespace {

constexpr int kMaxPoses = 512;
constexpr int kMaxSlots = 32;
constexpr int kIndexThreads = 512;
constexpr int kIndexWarps = kIndexThreads / 32;
constexpr int kThreads = 128;        // landmark, step and decide kernels
constexpr int kBlockThreads = 256;   // blocks kernel: 8 warps a CTA
constexpr int kPrepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_index(int p, int m) {
  return p < 0 ? p + m : p;
}
// the pose a slot is gathered at (projection, Jacobians, cost): JAX's
// gather rule, negative from the end, then clamped into [0, m)
__device__ __forceinline__ int gather_pose(int p, int m) {
  const int w = wrap_index(p, m);
  return w < 0 ? 0 : (w >= m ? m - 1 : w);
}
// the pose a slot is scattered to (Hpp, bp, S, rhs): 0 for an invalid slot
// (its weight is 0), else JAX's scatter rule: -1 (dropped) outside [0, m)
// after wrapping
__device__ __forceinline__ int scatter_pose(int p, bool valid, int m) {
  if (!valid) return 0;
  const int w = wrap_index(p, m);
  return (w >= 0 && w < m) ? w : -1;
}
// the pose of a slot's back-substitution term dp[pose_idx]: pose_idx is 0
// for an invalid slot and gathered (clamped) otherwise
__device__ __forceinline__ int backsub_pose(int p, bool valid, int m) {
  return valid ? gather_pose(p, m) : 0;
}

// max(x, lo) that keeps a NaN x, as torch.clamp and jnp.maximum do
__device__ __forceinline__ float nan_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// the Huber weight of a residual norm, NaN for a NaN norm (slam/ba.py:_huber)
__device__ __forceinline__ float huber_of_norm(float nrm, float huber) {
  return nrm <= huber ? 1.0f : huber / nan_max(nrm, 1e-12f);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A CTA's sum of one double a thread: a butterfly in each warp, then the
// warps in order by thread 0. Returns the sum in thread 0.
__device__ double block_sum(double v, double* warp_part) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_part[wid] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_part[w];
  return s;
}

// The same sum of parts[0, count) in every CTA that asks: lanes stride,
// then a butterfly. Called by one whole warp.
__device__ double parts_sum(const double* parts, int count) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int i = lane; i < count; i += 32) acc += parts[i];
  return warp_sum(acc);
}

// Exclusive scan of one int a thread over the CTA, and the total.
__device__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, t, off);
      if (lane >= off) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  const int excl = (wid == 0 ? 0 : warp_tot[wid - 1]) + x - v;
  *total = warp_tot[nw - 1];
  __syncthreads();
  return excl;
}

// ---------------------------------------------------------------------------
// index: once a call, one CTA.
__global__ void __launch_bounds__(kIndexThreads)
k9_index(const int* __restrict__ obs_pose,
         const unsigned char* __restrict__ obs_valid, int n, int kk, int m,
         float lam0, int* __restrict__ plist, int* __restrict__ poff,
         unsigned char* __restrict__ flags, int* __restrict__ blist,
         int* __restrict__ nb, float* __restrict__ state) {
  __shared__ int cnt[kIndexWarps][kMaxPoses];
  __shared__ int warp_tot[kIndexWarps];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nk = n * kk, mm = m * m;
  if (tid == 0) state[0] = lam0;
  for (int i = tid; i < kIndexWarps * kMaxPoses; i += blockDim.x)
    (&cnt[0][0])[i] = 0;
  for (int i = tid; i < mm; i += blockDim.x) flags[i] = 0;
  __syncthreads();
  for (int a = tid; a < m; a += blockDim.x) flags[a * m + a] = 1;
  // each warp a contiguous segment of the slots, 32 at a time in order
  const int seg = (nk + kIndexWarps - 1) / kIndexWarps;
  const int o0 = min(nk, wid * seg), o1 = min(nk, o0 + seg);
  for (int base = o0; base < o1; base += 32) {
    const int o = base + lane;
    int a = -1;
    if (o < o1) {
      a = scatter_pose(obs_pose[o], obs_valid[o], m);
      if (a >= 0) {
        const int row = o - o % kk;
        for (int l = 0; l < kk; ++l) {
          const int b = scatter_pose(obs_pose[row + l], obs_valid[row + l], m);
          if (b >= 0) flags[a * m + b] = 1;
        }
      }
    }
    const unsigned peers = __match_any_sync(kFull, a);
    if (a >= 0 && lane == __ffs(peers) - 1) cnt[wid][a] += __popc(peers);
  }
  __syncthreads();
  // per pose: the warps' counts to exclusive prefixes, the pose's total
  int tot = 0;
  if (tid < m) {
    for (int w = 0; w < kIndexWarps; ++w) {
      const int c = cnt[w][tid];
      cnt[w][tid] = tot;
      tot += c;
    }
  }
  int all = 0;
  const int off = block_scan(tot, warp_tot, &all);   // blockDim >= kMaxPoses
  if (tid < m) {
    poff[tid] = off;
    for (int w = 0; w < kIndexWarps; ++w) cnt[w][tid] += off;
  }
  if (tid == 0) poff[m] = all;
  __syncthreads();
  // placement: rank among equal poses in slot order
  for (int base = o0; base < o1; base += 32) {
    const int o = base + lane;
    const int a = o < o1 ? scatter_pose(obs_pose[o], obs_valid[o], m) : -1;
    const unsigned peers = __match_any_sync(kFull, a);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (a >= 0) plist[cnt[wid][a] + rank] = o;
    __syncwarp();
    if (a >= 0 && lane == __ffs(peers) - 1) cnt[wid][a] += __popc(peers);
    __syncwarp();
  }
  // the non-empty blocks, row-major
  const int chunk = (mm + blockDim.x - 1) / blockDim.x;
  const int f0 = min(mm, tid * chunk), f1 = min(mm, f0 + chunk);
  int c = 0;
  for (int i = f0; i < f1; ++i) c += flags[i];
  int nblocks = 0;
  int w = block_scan(c, warp_tot, &nblocks);
  for (int i = f0; i < f1; ++i)
    if (flags[i]) blist[w++] = i;
  if (tid == 0) *nb = nblocks;
}

// ---------------------------------------------------------------------------
// landmarks: a thread a landmark, every iteration.
struct Slots {
  float* jp;       // (N K, 2, 6) float32
  float* jl;       // (N K, 2, 3)
  float* res;      // (N K, 2)
  float* wt;       // (N K)
  double* U;       // (N K, 6, 3) float64
  double* W;       // (N K, 6, 3)
  double* hinv;    // (N, 3, 3)
  double* bl;      // (N, 3)
  unsigned char* seen;  // (N)
  double* part;    // per-CTA costs of the landmark kernel
  double* part2;   // per-CTA costs of the step kernel
  float* cand_lms;    // (N, 3)
  float* cand_poses;  // (M, 4, 4)
};

__global__ void __launch_bounds__(kThreads)
k9_landmarks(const float* __restrict__ poses_in, float* __restrict__ poses,
             const float* __restrict__ lms_in, float* __restrict__ lms,
             const int* __restrict__ obs_pose,
             const float* __restrict__ obs_uv,
             const unsigned char* __restrict__ obs_valid,
             const float* __restrict__ intr, int n, int kk, int m,
             float huber, int use_lu, int it,
             const float* __restrict__ state, Slots sl) {
  extern __shared__ float sposes[];               // (M, 4, 4)
  __shared__ double warp_part[kThreads / 32];
  const int tid = threadIdx.x;
  const float* src = it == 0 ? poses_in : poses;
  for (int i = tid; i < 16 * m; i += blockDim.x) {
    sposes[i] = src[i];
    if (it == 0 && blockIdx.x == 0) poses[i] = poses_in[i];
  }
  __syncthreads();
  const float lam = state[0];
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const int gn = blockIdx.x * blockDim.x + tid;
  double cost = 0.0;
  if (gn < n) {
    float X[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      X[i] = it == 0 ? lms_in[3 * gn + i] : lms[3 * gn + i];
      if (it == 0) lms[3 * gn + i] = X[i];
    }
    double H[9], b[3] = {0.0, 0.0, 0.0}, wsum = 0.0;
#pragma unroll
    for (int i = 0; i < 9; ++i) H[i] = 0.0;
    for (int k = 0; k < kk; ++k) {
      const size_t o = (size_t)gn * kk + k;
      const float* T = sposes + 16 * gather_pose(obs_pose[o], m);
      const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
      const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
      const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
      const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
      const float iz = 1.0f / z;
      const float u = fx * p0 * iz + cx;
      const float v = fy * p1 * iz + cy;
      const float r0 = v - obs_uv[2 * o], r1 = u - obs_uv[2 * o + 1];
      const float rr = r0 * r0 + r1 * r1;
      const float wt = obs_valid[o] ? huber_of_norm(sqrtf(rr), huber) : 0.0f;
      cost += (double)(wt * rr);
      const float d[2][3] = {{0.0f, fy * iz, -fy * p1 * iz * iz},
                             {fx * iz, 0.0f, -fx * p0 * iz * iz}};
      const float nh[3][3] = {{0.0f, p2, -p1}, {-p2, 0.0f, p0},
                              {p1, -p0, 0.0f}};
      float Jp[12], Jl[6];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Jp[6 * q + c] = d[q][0] * nh[0][c] + d[q][1] * nh[1][c]
                          + d[q][2] * nh[2][c];
          Jp[6 * q + 3 + c] = d[q][c];
          Jl[3 * q + c] = d[q][0] * T[c] + d[q][1] * T[4 + c]
                          + d[q][2] * T[8 + c];
        }
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) sl.jp[12 * o + i] = Jp[i];
#pragma unroll
      for (int i = 0; i < 6; ++i) sl.jl[6 * o + i] = Jl[i];
      sl.res[2 * o] = r0;
      sl.res[2 * o + 1] = r1;
      sl.wt[o] = wt;
      const double w = wt;
      wsum += w;
      const double rd[2] = {r0, r1};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const double jw = (double)Jl[3 * q + i] * w;
#pragma unroll
          for (int j = 0; j < 3; ++j) H[3 * i + j] += jw * Jl[3 * q + j];
          b[i] -= jw * rd[q];
        }
      }
    }
    const bool seen = wsum > 0.0;
    if (seen) {
      const double dmp = (double)(lam + 1e-6f);
      H[0] += dmp;
      H[4] += dmp;
      H[8] += dmp;
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) H[i] = (i % 4 == 0) ? 1.0 : 0.0;
      b[0] = b[1] = b[2] = 0.0;
    }
    double Hi[9];
    if (use_lu) inv3_lu(H, Hi); else inv3_chol(H, Hi);
#pragma unroll
    for (int i = 0; i < 9; ++i) sl.hinv[9 * (size_t)gn + i] = Hi[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sl.bl[3 * (size_t)gn + i] = b[i];
    sl.seen[gn] = seen ? 1 : 0;
    // U = Jp_w^T Jl and W = U Hll_inv per slot
    for (int k = 0; k < kk; ++k) {
      const size_t o = (size_t)gn * kk + k;
      const double w = sl.wt[o];
      double U[18];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const double j0 = (double)sl.jp[12 * o + i] * w;
        const double j1 = (double)sl.jp[12 * o + 6 + i] * w;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          U[3 * i + j] = j0 * sl.jl[6 * o + j] + j1 * sl.jl[6 * o + 3 + j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          sl.W[18 * o + 3 * i + c] = U[3 * i] * Hi[c] + U[3 * i + 1] * Hi[3 + c]
                                     + U[3 * i + 2] * Hi[6 + c];
      }
#pragma unroll
      for (int i = 0; i < 18; ++i) sl.U[18 * o + i] = U[i];
    }
  }
  const double s = block_sum(cost, warp_part);
  if (tid == 0) sl.part[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// blocks: a warp a non-empty 6x6 block of S, every iteration.
__global__ void __launch_bounds__(kBlockThreads)
k9_blocks(const int* __restrict__ blist, const int* __restrict__ nb,
          const int* __restrict__ plist, const int* __restrict__ poff,
          const int* __restrict__ obs_pose,
          const unsigned char* __restrict__ obs_valid, int kk, int m,
          int n_part, Slots sl, float* __restrict__ S,
          float* __restrict__ rhs, float* __restrict__ state) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  const int D = 6 * m;
  if (warp == 0) {
    const double c = parts_sum(sl.part, n_part);
    if (lane == 0) state[1] = (float)c;
  }
  const int count = *nb;
  for (int bi = warp; bi < count; bi += nwarps) {
    const int a = blist[bi] / m, bcol = blist[bi] % m;
    const bool diag = a == bcol;
    double acc[36], racc[6];
#pragma unroll
    for (int e = 0; e < 36; ++e) acc[e] = 0.0;
#pragma unroll
    for (int e = 0; e < 6; ++e) racc[e] = 0.0;
    const int j1 = poff[a + 1];
    for (int j = poff[a] + lane; j < j1; j += 32) {
      const int o = plist[j];
      const int row = o - o % kk;
      const double* Wo = sl.W + 18 * (size_t)o;
      for (int l = 0; l < kk; ++l) {
        const int ol = row + l;
        if (scatter_pose(obs_pose[ol], obs_valid[ol], m) != bcol) continue;
        const double* Ul = sl.U + 18 * (size_t)ol;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int q = 0; q < 6; ++q)
            acc[6 * i + q] -= Wo[3 * i] * Ul[3 * q] + Wo[3 * i + 1] * Ul[3 * q + 1]
                              + Wo[3 * i + 2] * Ul[3 * q + 2];
        }
      }
      if (diag) {
        const double w = sl.wt[o];
        const float* jp = sl.jp + 12 * (size_t)o;
        const double r0 = sl.res[2 * o], r1 = sl.res[2 * o + 1];
        const double* bn = sl.bl + 3 * (size_t)(o / kk);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const double a0 = (double)jp[i] * w, a1 = (double)jp[6 + i] * w;
#pragma unroll
          for (int q = 0; q < 6; ++q)
            acc[6 * i + q] += a0 * jp[q] + a1 * jp[6 + q];
          racc[i] -= a0 * r0 + a1 * r1;
          racc[i] -= Wo[3 * i] * bn[0] + Wo[3 * i + 1] * bn[1]
                     + Wo[3 * i + 2] * bn[2];
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 36; ++e) acc[e] = warp_sum(acc[e]);
    if (diag) {
#pragma unroll
      for (int e = 0; e < 6; ++e) racc[e] = warp_sum(racc[e]);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int q = 0; q < 6; ++q)
          S[(size_t)(6 * a + i) * D + 6 * bcol + q] = (float)acc[6 * i + q];
        if (diag) rhs[6 * a + i] = (float)racc[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// prep: the damped, gauge-fixed, Jacobi-scaled system for the library solve.
__global__ void __launch_bounds__(kPrepThreads)
k9_prep(const float* __restrict__ S, const float* __restrict__ rhs,
        const unsigned char* __restrict__ fixed, int m,
        const float* __restrict__ state, float* __restrict__ Sp,
        float* __restrict__ bs, float* __restrict__ dsc) {
  const int D = 6 * m;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)D * D) return;
  const int i = (int)(idx / D), j = (int)(idx % D);
  const float lam = state[0];
  const bool fi = fixed[i / 6], fj = fixed[j / 6];
  const float di = rsqrtf(nan_max(fi ? 1.0f : S[(size_t)i * D + i] + lam,
                                  1e-12f));
  const float dj = rsqrtf(nan_max(fj ? 1.0f : S[(size_t)j * D + j] + lam,
                                  1e-12f));
  float v = S[idx] + (i == j ? lam : 0.0f);
  if (fi || fj) v = i == j ? 1.0f : 0.0f;
  Sp[idx] = v * di * dj;
  if (j == 0) {
    bs[i] = di * (fi ? 0.0f : rhs[i]);
    dsc[i] = di;
  }
}

// ---------------------------------------------------------------------------
// step: the pose step, the back-substitution and the candidate's cost.
__global__ void __launch_bounds__(kThreads)
k9_step(const float* __restrict__ x, const int* __restrict__ info,
        const float* __restrict__ dsc, const unsigned char* __restrict__ fixed,
        const float* __restrict__ poses, const float* __restrict__ lms,
        const int* __restrict__ obs_pose, const float* __restrict__ obs_uv,
        const unsigned char* __restrict__ obs_valid,
        const float* __restrict__ intr, int n, int kk, int m, float huber,
        Slots sl, float* __restrict__ dp_out) {
  extern __shared__ float sm[];
  float* sdp = sm;               // (M, 6)
  float* scand = sm + 6 * m;     // (M, 4, 4)
  __shared__ double warp_part[kThreads / 32];
  const int tid = threadIdx.x, D = 6 * m;
  const bool ok = *info == 0;
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < D; i += blockDim.x) sdp[i] = ok ? dsc[i] * x[i] : nan;
  __syncthreads();
  for (int k = tid; k < m; k += blockDim.x) {
    if (fixed[k]) {
#pragma unroll
      for (int i = 0; i < 16; ++i) scand[16 * k + i] = poses[16 * k + i];
    } else {
      se3_exp_apply(sdp + 6 * k, poses + 16 * k, scand + 16 * k);
    }
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int i = tid; i < 16 * m; i += blockDim.x) sl.cand_poses[i] = scand[i];
    for (int i = tid; i < D; i += blockDim.x) dp_out[i] = sdp[i];
  }
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const int gn = blockIdx.x * blockDim.x + tid;
  double cost = 0.0;
  if (gn < n) {
    float X[3] = {lms[3 * gn], lms[3 * gn + 1], lms[3 * gn + 2]};
    if (sl.seen[gn]) {
      double udp[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < kk; ++k) {
        const size_t o = (size_t)gn * kk + k;
        const double* Uk = sl.U + 18 * o;
        const float* dk = sdp + 6 * backsub_pose(obs_pose[o], obs_valid[o], m);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const double dd = dk[i];
#pragma unroll
          for (int j = 0; j < 3; ++j) udp[j] += Uk[3 * i + j] * dd;
        }
      }
      double r[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) r[j] = sl.bl[3 * (size_t)gn + j] - udp[j];
      const double* Hi = sl.hinv + 9 * (size_t)gn;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        X[i] += (float)(Hi[3 * i] * r[0] + Hi[3 * i + 1] * r[1]
                        + Hi[3 * i + 2] * r[2]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) sl.cand_lms[3 * (size_t)gn + i] = X[i];
    for (int k = 0; k < kk; ++k) {
      const size_t o = (size_t)gn * kk + k;
      if (!obs_valid[o]) continue;
      const float* T = scand + 16 * gather_pose(obs_pose[o], m);
      const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
      const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
      const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
      const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
      const float r0 = fy * p1 / z + cy - obs_uv[2 * o];
      const float r1 = fx * p0 / z + cx - obs_uv[2 * o + 1];
      const float rr = r0 * r0 + r1 * r1;
      cost += (double)(huber_of_norm(sqrtf(rr), huber) * rr);
    }
  }
  const double s = block_sum(cost, warp_part);
  if (tid == 0) sl.part2[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// decide: the accept test, the damping update and the move, the same
// decision in every CTA.
__global__ void __launch_bounds__(kThreads)
k9_decide(int n, int m, int it, int n_part, Slots sl,
          float* __restrict__ state, float* __restrict__ poses,
          float* __restrict__ lms, float* __restrict__ costs,
          float* __restrict__ trace_row) {
  __shared__ int accept;
  const int tid = threadIdx.x, D = 6 * m;
  if (tid < 32) {
    const double s = parts_sum(sl.part2, n_part);
    if (tid == 0) {
      const float new_cost = (float)s, old = state[1];
      const bool acc = new_cost < old;
      accept = acc ? 1 : 0;
      if (blockIdx.x == 0) {
        const float lam = state[0];
        costs[it] = acc ? new_cost : old;
        trace_row[D] = lam;
        trace_row[D + 1] = old;
        trace_row[D + 2] = new_cost;
        trace_row[D + 3] = acc ? 1.0f : 0.0f;
        state[0] = acc ? fmaxf(lam * 0.3f, 1e-8f) : fminf(lam * 4.0f, 1e4f);
      }
    }
  }
  __syncthreads();
  if (!accept) return;
  if (blockIdx.x == 0)
    for (int i = tid; i < 16 * m; i += blockDim.x) poses[i] = sl.cand_poses[i];
  const int gn = blockIdx.x * blockDim.x + tid;
  if (gn < n)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      lms[3 * (size_t)gn + i] = sl.cand_lms[3 * (size_t)gn + i];
}

// The scratch of one call, carved from one workspace (256-byte aligned).
struct Layout {
  size_t plist, poff, flags, blist, nb, jp, jl, res, wt, U, W, hinv, bl,
      seen, part, part2, cand_lms, cand_poses, total;
};

size_t carve(size_t* at, size_t bytes) {
  const size_t here = *at;
  *at += (bytes + 255) / 256 * 256;
  return here;
}

Layout layout_of(int n, int kk, int m) {
  Layout L;
  const size_t nk = (size_t)n * kk, g = (n + kThreads - 1) / kThreads;
  size_t at = 0;
  L.plist = carve(&at, nk * 4);
  L.poff = carve(&at, (size_t)(m + 1) * 4);
  L.flags = carve(&at, (size_t)m * m);
  L.blist = carve(&at, (size_t)m * m * 4);
  L.nb = carve(&at, 4);
  L.jp = carve(&at, nk * 12 * 4);
  L.jl = carve(&at, nk * 6 * 4);
  L.res = carve(&at, nk * 2 * 4);
  L.wt = carve(&at, nk * 4);
  L.U = carve(&at, nk * 18 * 8);
  L.W = carve(&at, nk * 18 * 8);
  L.hinv = carve(&at, (size_t)n * 9 * 8);
  L.bl = carve(&at, (size_t)n * 3 * 8);
  L.seen = carve(&at, (size_t)n);
  L.part = carve(&at, g * 8);
  L.part2 = carve(&at, g * 8);
  L.cand_lms = carve(&at, (size_t)n * 3 * 4);
  L.cand_poses = carve(&at, (size_t)m * 16 * 4);
  L.total = at;
  return L;
}

Slots slots_of(unsigned char* ws, const Layout& L) {
  Slots s;
  s.jp = (float*)(ws + L.jp);
  s.jl = (float*)(ws + L.jl);
  s.res = (float*)(ws + L.res);
  s.wt = (float*)(ws + L.wt);
  s.U = (double*)(ws + L.U);
  s.W = (double*)(ws + L.W);
  s.hinv = (double*)(ws + L.hinv);
  s.bl = (double*)(ws + L.bl);
  s.seen = ws + L.seen;
  s.part = (double*)(ws + L.part);
  s.part2 = (double*)(ws + L.part2);
  s.cand_lms = (float*)(ws + L.cand_lms);
  s.cand_poses = (float*)(ws + L.cand_poses);
  return s;
}

bool sizes_ok(int n, int kk, int m) {
  return n >= 1 && kk >= 1 && kk <= kMaxSlots && m >= 1 && m <= kMaxPoses &&
         (long long)n * kk <= (1LL << 22);
}

int landmark_grid(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// The workspace bytes of one call at n landmarks, kk slots, m poses.
extern "C" int vpp_ba_generic_workspace(int n, int kk, int m,
                                        long long* bytes) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)layout_of(n, kk, m).total;
  return 0;
}

// Once a call: lam := lam0 and the index (slots by scatter pose, the list
// of non-empty blocks of S). obs_pose (n, kk) int32, obs_valid (n, kk)
// bytes, state (2) float32 [lam, cost].
extern "C" int vpp_ba_generic_index(const int* obs_pose,
                                    const unsigned char* obs_valid, int n,
                                    int kk, int m, float lam0,
                                    unsigned char* ws, float* state,
                                    void* stream) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, kk, m);
  k9_index<<<1, kIndexThreads, 0, (cudaStream_t)stream>>>(
      obs_pose, obs_valid, n, kk, m, lam0, (int*)(ws + L.plist),
      (int*)(ws + L.poff), ws + L.flags, (int*)(ws + L.blist),
      (int*)(ws + L.nb), state);
  return (int)cudaGetLastError();
}

// Iteration it: the landmark blocks and the iterate's cost terms. At it 0
// poses (m, 4, 4) and lms (n, 3) are first copied from poses_in/lms_in.
extern "C" int vpp_ba_generic_landmarks(
    const float* poses_in, float* poses, const float* lms_in, float* lms,
    const int* obs_pose, const float* obs_uv, const unsigned char* obs_valid,
    const float* intr, int n, int kk, int m, float huber, int use_lu, int it,
    const float* state, unsigned char* ws, void* stream) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, kk, m);
  k9_landmarks<<<landmark_grid(n), kThreads, (size_t)m * 16 * 4,
                 (cudaStream_t)stream>>>(
      poses_in, poses, lms_in, lms, obs_pose, obs_uv, obs_valid, intr, n, kk,
      m, huber, use_lu, it, state, slots_of(ws, L));
  return (int)cudaGetLastError();
}

// Iteration it: S (6m, 6m) and rhs (6m) float32 on the index's blocks (S's
// other blocks are left as they are: zero them once a call) and the
// iterate's cost into state[1].
extern "C" int vpp_ba_generic_blocks(const int* obs_pose,
                                     const unsigned char* obs_valid, int n,
                                     int kk, int m, unsigned char* ws,
                                     float* S, float* rhs, float* state,
                                     void* stream) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, kk, m);
  // enough warps for the most blocks there can be, up to 16 a SM
  const long long most = std::min<long long>((long long)m * m,
                                             (long long)n * kk * kk + m);
  const int warps = (int)std::min<long long>(most, 132LL * 16);
  const int ctas = (warps * 32 + kBlockThreads - 1) / kBlockThreads;
  k9_blocks<<<ctas, kBlockThreads, 0, (cudaStream_t)stream>>>(
      (int*)(ws + L.blist), (int*)(ws + L.nb), (int*)(ws + L.plist),
      (int*)(ws + L.poff), obs_pose, obs_valid, kk, m, landmark_grid(n),
      slots_of(ws, L), S, rhs, state);
  return (int)cudaGetLastError();
}

// Iteration it: Sp (6m, 6m), bs and d (6m) for the library solve.
extern "C" int vpp_ba_generic_prep(const float* S, const float* rhs,
                                   const unsigned char* fixed, int m,
                                   const float* state, float* Sp, float* bs,
                                   float* dsc, void* stream) {
  if (m < 1 || m > kMaxPoses) return (int)cudaErrorInvalidValue;
  const size_t entries = (size_t)36 * m * m;
  const int ctas = (int)((entries + kPrepThreads - 1) / kPrepThreads);
  k9_prep<<<ctas, kPrepThreads, 0, (cudaStream_t)stream>>>(
      S, rhs, fixed, m, state, Sp, bs, dsc);
  return (int)cudaGetLastError();
}

// Iteration it: dp from the library's x and info (int32, 0 where it
// solved), the candidate and its cost; dp_out (6m) float32 the trace's.
extern "C" int vpp_ba_generic_step(
    const float* x, const int* info, const float* dsc,
    const unsigned char* fixed, const float* poses, const float* lms,
    const int* obs_pose, const float* obs_uv, const unsigned char* obs_valid,
    const float* intr, int n, int kk, int m, float huber, unsigned char* ws,
    float* dp_out, void* stream) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, kk, m);
  k9_step<<<landmark_grid(n), kThreads, (size_t)m * 22 * 4,
            (cudaStream_t)stream>>>(x, info, dsc, fixed, poses, lms, obs_pose,
                                    obs_uv, obs_valid, intr, n, kk, m, huber,
                                    slots_of(ws, L), dp_out);
  return (int)cudaGetLastError();
}

// Iteration it: accept or reject, costs[it], the trace row's lam, costs
// and decision (after its 6m dp), lam, and the move of poses and lms.
extern "C" int vpp_ba_generic_decide(int n, int kk, int m, int it,
                                     unsigned char* ws, float* state,
                                     float* poses, float* lms, float* costs,
                                     float* trace_row, void* stream) {
  if (!sizes_ok(n, kk, m)) return (int)cudaErrorInvalidValue;
  const Layout L = layout_of(n, kk, m);   // the workspace's offsets
  k9_decide<<<landmark_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      n, m, it, landmark_grid(n), slots_of(ws, L), state, poses, lms, costs,
      trace_row);
  return (int)cudaGetLastError();
}
