// K6 — the whole window bundle adjustment on the ring layout: every
// Levenberg-Marquardt iteration of ba_solve_tracks (Schur assembly, pose
// solve, pose step, back-substitution, candidate cost, accept test and
// damping update) in one thread-block-cluster launch.
//
// Replaces vpp_tpu/slam/ba.py:ba_solve_tracks (:568, its LM scan :646) with
// _tracks_assemble (:453), _inv3 (:46), _tracks_solve_poses (:530),
// _tracks_backsub (:558) and _tracks_cost (:445), ring layout
// (obs_pose[n, j] == j, K == M). On the TPU each stage was a chain of dense
// einsums over (N, K, 6, 3) tensors for the matrix unit, and the pose solve
// went to the library. Here one cluster of kCluster CTAs runs the LM loop
// on-chip, each CTA owning a contiguous range of landmarks:
//   assembly — the CTA walks its range in tiles of 32 landmarks (16 above
//     8 poses): per observation the residual, the analytic Jacobians Jp
//     (2x6) and Jl (2x3) of proj_jacobians (with its |z| < 1e-6 -> 1e-6
//     clamp), the Huber weight, the obs_valid mask and the cost term; per
//     landmark Hll, bl, seen, Hll + (lam + 1e-6) I (I where unseen) and its
//     inverse (_inv3's scaled closed-form Cholesky, or a pivoted 3x3
//     Gauss-Jordan for linalg="lu"); per observation U = Jp_w^T Jl and
//     W = U Hll_inv. Hll_inv, bl, U and seen go to device memory (L2) for
//     the back-substitution. The tile's Schur product sum W_k U_l^T runs on
//     the float64 tensor cores (mma m8n8k4, each warp its 8x8 blocks of
//     S); Hpp, rhs (bp minus sum W_k bl) and the cost are summed by
//     threads that own fixed entries. All go into the CTA's partial S
//     (M,6,M,6), rhs and cost in shared memory;
//   reduction — after cluster.sync() each CTA sums its slice of the entries
//     over the ranks' partials in rank order through distributed shared
//     memory and writes them, rounded to float32, into rank 0's pose-solve
//     workspace. No float atomics: the accept test compares two costs, so
//     they must be the same bits on every run;
//   pose solve — rank 0, in shared memory, as _tracks_solve_poses: lam I,
//     identity rows and columns for fixed poses, Jacobi scaling, then a
//     float32 Cholesky (linalg="chol": the block, one barrier a column,
//     with the forward substitution carried along) or LU with partial
//     pivoting ("lu": one warp), and the back substitution in one warp. A
//     non-positive Cholesky pivot or an exactly zero LU pivot makes dp NaN,
//     as chol_solve/lu_solve do, and the step is rejected. Then
//     se3_exp(dp_k) @ T_k for every free pose;
//   back-substitution and cost — every CTA copies dp and the candidate
//     poses from rank 0, computes dl = Hll_inv (bl - sum_k U_k^T dp_k)
//     (zero where unseen) and the candidate's Huber cost for its landmarks;
//     rank 0 sums the ranks' costs in rank order, accepts where new < old
//     (NaN rejects), and every CTA takes the candidate where accepted and
//     updates lam = accept ? max(0.3 lam, 1e-8) : min(4 lam, 1e4).
// The kernel also writes a trace: the first iteration's S, rhs and cost,
// and per iteration dp, lam, the cost, the candidate's cost and accept.
//
// Precision, as in the plain version (slam/ba.py): residuals and Jacobians
// in float32; each landmark's block algebra (Hll, its damped inverse, U, W,
// its Schur terms and back-substitution) in float64, and S, rhs and the
// costs summed in float64 and rounded to float32; the pose solve and the
// pose step in float32.
//
// Bound on the H100: at N = 1024, M = 6, 3 iterations about 12 M float64
// multiply-adds (~0.7 us at 34 TFLOP/s) and 0.1 MB moved. The launch sits
// at latency: each CTA walks its tiles one after another with few warps,
// rank 0's pose factorisation takes a block barrier a column, and every
// iteration passes five cluster barriers.
//
// Streams: one launch solves S problems of one shape, a cluster each
// (grid kCluster x S, blockIdx.y the problem), each with its own inputs,
// outputs, costs, trace and scratch; the intrinsics, lam0 and huber are
// shared. The clusters are of a non-portable size: the card holds only a
// few at once (vpp_ba_max_active_clusters), and the rest queue.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pose_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPoses = 16;
// CTAs in the cluster: 16, above the portable 8 (16 ran the SLAM window's
// call faster than 8 on the H100)
constexpr int kCluster = 16;

// landmarks per assembly tile: 32 up to 8 poses, 16 above (the tile and
// the partial sums then fit a CTA's shared memory up to kMaxPoses)
__host__ __device__ inline int tile_landmarks(int m) {
  return m <= 8 ? 32 : 16;
}

// the assembly tile of L landmarks and M poses: float64 U, W (per
// observation), Hll_inv, bl (per landmark); float32 Jp, Jl, r, w and the
// cost terms
__host__ __device__ inline int tile_doubles(int m) {
  const int L = tile_landmarks(m);
  return L * m * (18 + 18) + L * (9 + 3);
}
__host__ __device__ inline size_t tile_bytes(int m) {
  return (size_t)tile_doubles(m) * 8
         + (size_t)tile_landmarks(m) * m * (12 + 6 + 2 + 1 + 1) * 4;
}
// rank 0's pose-solve workspace (aliases its tile): float32 A (D*D), rhs
// (D), cost (1) — the layout of the partial sums — then the scales, the
// scaled rhs, the solution and the Cholesky column scales (D each) and the
// scaled system with rows padded to D + 1 (no bank conflicts down a column)
__host__ __device__ inline size_t solve_bytes(int m) {
  const int D = 6 * m;
  return (size_t)(D * D + D + 1 + 4 * D + D * (D + 1)) * 4;
}
__host__ __device__ inline size_t region_bytes(int m) {
  const size_t t = tile_bytes(m), s = solve_bytes(m);
  return ((t > s ? t : s) + 15) / 16 * 16;
}
__host__ __device__ inline int n_entries(int m) {
  return 36 * m * m + 6 * m + 1;
}

// Per-CTA state. Each CTA keeps its own copy of the poses and of lam and
// applies the same updates, so the copies stay bit-identical.
struct LmState {
  double warp_cost[kWarps];
  double cost_part;                 // this CTA's share of the candidate cost
  float poses[kMaxPoses * 16];      // the current iterate
  float cand[kMaxPoses * 16];       // the candidate (rank 0 computes it)
  float dp[kMaxPoses * 6];
  float lam;
  float cost;                       // rank 0: the current iterate's cost
  int accept;                       // rank 0: this iteration's decision
  unsigned char fixed[kMaxPoses];
};

struct Problem {
  const float* obs_uv;
  const unsigned char* obs_valid;
  float fx, fy, cx, cy, huber;
  int m, use_lu;
};

// One tile of landmarks [n0, n0 + L) clipped at `hi`: the landmark
// blocks go to device memory and the tile's Schur terms are added to the
// CTA's partial sums `part` (each thread its own entries, in tile order).
__device__ void assemble_tile(const Problem& pb, const LmState& st,
                              const float* __restrict__ lms, int n0, int hi,
                              float lam, unsigned char* smem,
                              double* __restrict__ part,
                              double* __restrict__ hinv_out,
                              double* __restrict__ bl_out,
                              double* __restrict__ u_out,
                              unsigned char* __restrict__ seen_out) {
  const int m = pb.m, L = tile_landmarks(m), LM = L * m;
  double* sU = (double*)smem;           // (L*M, 6, 3)
  double* sW = sU + LM * 18;            // (L*M, 6, 3)
  double* sHinv = sW + LM * 18;         // (L, 3, 3)
  double* sbl = sHinv + L * 9;          // (L, 3)
  float* sJp = (float*)(sbl + L * 3);   // (L*M, 2, 6)
  float* sJl = sJp + LM * 12;           // (L*M, 2, 3)
  float* sr = sJl + LM * 6;             // (L*M, 2)
  float* sw = sr + LM * 2;              // (L*M)
  float* sc = sw + LM;                  // (L*M) cost terms
  const float fx = pb.fx, fy = pb.fy, cx = pb.cx, cy = pb.cy;

  // 1a. residual, Jacobians and weight per observation
  for (int o = threadIdx.x; o < LM; o += blockDim.x) {
    const int gn = n0 + o / m, k = o % m;
    float Jp[12], Jl[6], r0 = 0.0f, r1 = 0.0f, wt = 0.0f;
#pragma unroll
    for (int i = 0; i < 12; ++i) Jp[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) Jl[i] = 0.0f;
    if (gn < hi) {
      const float* T = st.poses + 16 * k;
      const float X0 = lms[3 * gn], X1 = lms[3 * gn + 1], X2 = lms[3 * gn + 2];
      const float p0 = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
      const float p1 = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
      const float p2 = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
      const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
      const float iz = 1.0f / z;
      const float u = fx * p0 * iz + cx;
      const float v = fy * p1 * iz + cy;
      const size_t ob = (size_t)gn * m + k;
      r0 = v - pb.obs_uv[2 * ob];
      r1 = u - pb.obs_uv[2 * ob + 1];
      wt = pb.obs_valid[ob] ? huber_weight(r0, r1, pb.huber) : 0.0f;
      // dproj rows: d(row)/d(pc) and d(col)/d(pc)
      const float d[2][3] = {{0.0f, fy * iz, -fy * p1 * iz * iz},
                             {fx * iz, 0.0f, -fx * p0 * iz * iz}};
      // -[pc]x
      const float nh[3][3] = {{0.0f, p2, -p1}, {-p2, 0.0f, p0},
                              {p1, -p0, 0.0f}};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          Jp[6 * rr + c] = d[rr][0] * nh[0][c] + d[rr][1] * nh[1][c]
                           + d[rr][2] * nh[2][c];
          Jp[6 * rr + 3 + c] = d[rr][c];
          Jl[3 * rr + c] = d[rr][0] * T[c] + d[rr][1] * T[4 + c]
                           + d[rr][2] * T[8 + c];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 12; ++i) sJp[12 * o + i] = Jp[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) sJl[6 * o + i] = Jl[i];
    sr[2 * o] = r0;
    sr[2 * o + 1] = r1;
    sw[o] = wt;
    sc[o] = wt * (r0 * r0 + r1 * r1);   // float32 per observation
  }
  __syncthreads();

  // 1b. per landmark: Hll, bl, seen, damped inverse
  for (int nl = threadIdx.x; nl < L; nl += blockDim.x) {
    double H[9], b[3] = {0.0, 0.0, 0.0}, wsum = 0.0;
#pragma unroll
    for (int i = 0; i < 9; ++i) H[i] = 0.0;
    for (int k = 0; k < m; ++k) {
      const int o = nl * m + k;
      const double wt = sw[o];
      wsum += wt;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const double jw = (double)sJl[6 * o + 3 * rr + i] * wt;
#pragma unroll
          for (int j = 0; j < 3; ++j)
            H[3 * i + j] += jw * sJl[6 * o + 3 * rr + j];
          b[i] -= jw * sr[2 * o + rr];
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
    if (pb.use_lu) inv3_lu(H, Hi); else inv3_chol(H, Hi);
#pragma unroll
    for (int i = 0; i < 9; ++i) sHinv[9 * nl + i] = Hi[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sbl[3 * nl + i] = b[i];
    const int gn = n0 + nl;
    if (gn < hi) {
#pragma unroll
      for (int i = 0; i < 9; ++i) hinv_out[9 * (size_t)gn + i] = Hi[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) bl_out[3 * (size_t)gn + i] = b[i];
      seen_out[gn] = seen ? 1 : 0;
    }
  }
  __syncthreads();

  // 1c. U = Jp_w^T Jl and W = U Hll_inv per observation
  for (int o = threadIdx.x; o < LM; o += blockDim.x) {
    const int nl = o / m;
    const double wt = sw[o];
    const double* Hi = sHinv + 9 * nl;
    double U[18];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const double j0 = (double)sJp[12 * o + i] * wt;
      const double j1 = (double)sJp[12 * o + 6 + i] * wt;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        U[3 * i + j] = j0 * sJl[6 * o + j] + j1 * sJl[6 * o + 3 + j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        sW[18 * o + 3 * i + c] = U[3 * i] * Hi[c] + U[3 * i + 1] * Hi[3 + c]
                                 + U[3 * i + 2] * Hi[6 + c];
      }
    }
#pragma unroll
    for (int i = 0; i < 18; ++i) sU[18 * o + i] = U[i];
  }
  __syncthreads();
  // the tile's U to device memory in one coalesced copy
  {
    const int count = 18 * m * min(L, hi - n0);
    double* dst = u_out + 18 * (size_t)n0 * m;
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x)
      dst[idx] = sU[idx];
  }

  // 2a. S -= sum over the tile's landmarks of W_k U_l^T, an (D x 3L) by
  // (3L x D) product, on the float64 tensor cores: each warp owns 8x8
  // blocks of S and steps through the 3L inner terms four at a time
  // (mma m8n8k4). Rows and columns past D, and masked observations (their
  // U and W are zero), contribute zeros.
  const int D = 6 * m, nb8 = (D + 7) / 8, K3 = 3 * L;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int fr = lane >> 2, fc = lane & 3;
  for (int blk = wid; blk < nb8 * nb8; blk += blockDim.x >> 5) {
    const int r = 8 * (blk / nb8) + fr;      // this lane's row of A
    const int c = 8 * (blk % nb8) + fr;      // this lane's column of B
    const double* wrow = sW + 18 * (r / 6) + 3 * (r % 6);
    const double* ucol = sU + 18 * (c / 6) + 3 * (c % 6);
    double d0 = 0.0, d1 = 0.0;
    for (int kk = fc; kk < K3; kk += 4) {
      const int off = 18 * m * (kk / 3) + kk % 3;   // landmark kk/3, term kk%3
      const double a = r < D ? wrow[off] : 0.0;
      const double bb = c < D ? ucol[off] : 0.0;
      asm volatile(
          "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
          "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
          : "+d"(d0), "+d"(d1) : "d"(a), "d"(bb));
    }
    const int row = 8 * (blk / nb8) + fr, col = 8 * (blk % nb8) + 2 * fc;
    if (row < D) {
      if (col < D) part[row * D + col] -= d0;
      if (col + 1 < D) part[row * D + col + 1] -= d1;
    }
  }
  __syncthreads();

  // 2b. Hpp on the diagonal blocks (a task owns six entries of a row) and
  // rhs (one entry a task), each walking the tile's landmarks in order;
  // masked observations are skipped (their weight is zero). Then warp 0
  // sums the cost terms (a fixed pattern of lanes and shuffles).
  const int nT = 2 * D;
  for (int t = threadIdx.x; t < nT; t += blockDim.x) {
    if (t < D) {
      const int k = t / 6, i = t % 6;
      double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      for (int nl = 0; nl < L; ++nl) {
        const int o = nl * m + k;
        const double wt = sw[o];
        if (wt == 0.0) continue;
        const double a0 = (double)sJp[12 * o + i] * wt;
        const double a1 = (double)sJp[12 * o + 6 + i] * wt;
#pragma unroll
        for (int q = 0; q < 6; ++q)
          acc[q] += a0 * sJp[12 * o + q] + a1 * sJp[12 * o + 6 + q];
      }
      double* dst = part + t * D + 6 * k;
#pragma unroll
      for (int q = 0; q < 6; ++q) dst[q] += acc[q];
    } else if (t < 2 * D) {
      const int k = (t - D) / 6, i = (t - D) % 6;
      double acc = 0.0;
      for (int nl = 0; nl < L; ++nl) {
        const int o = nl * m + k;
        const double wt = sw[o];
        if (wt == 0.0) continue;
        const double* Wk = sW + 18 * o + 3 * i;
        const double* bn = sbl + 3 * nl;
        acc -= (double)sJp[12 * o + i] * wt * sr[2 * o]
               + (double)sJp[12 * o + 6 + i] * wt * sr[2 * o + 1];
        acc -= Wk[0] * bn[0] + Wk[1] * bn[1] + Wk[2] * bn[2];
      }
      part[D * D + (t - D)] += acc;
    }
  }
  if (wid == 0) {
    double acc = 0.0;
    for (int o = lane; o < LM; o += 32) acc += sc[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) part[D * D + D] += acc;
  }
  __syncthreads();
}

// One warp: float32 LU with partial pivoting (the first largest |pivot|)
// in place in P (row stride ld), rows of b swapped alongside, and the
// solution x of P x = b. False where a pivot is exactly zero, as LAPACK's
// getrf reports it.
__device__ bool lu_solve_warp(float* P, int ld, float* b, float* x, int D) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < D; ++k) {
    float best = -1.0f;
    int bi = D;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = lane + 32 * s;
      if (i >= k && i < D) {
        const float v = fabsf(P[i * ld + k]);
        if (v > best) {
          best = v;
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (bi >= D) return false;              // a column of NaN
    if (bi != k) {
      for (int j = lane; j < D; j += 32) {
        const float t = P[k * ld + j];
        P[k * ld + j] = P[bi * ld + j];
        P[bi * ld + j] = t;
      }
      if (lane == 0) {
        const float t = b[k];
        b[k] = b[bi];
        b[bi] = t;
      }
    }
    __syncwarp();
    const float pv = P[k * ld + k];
    if (pv == 0.0f) return false;
    const float bk = b[k];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = lane + 32 * s;
      if (i > k && i < D) {
        const float lik = P[i * ld + k] / pv;
        P[i * ld + k] = lik;
#pragma unroll 4
        for (int j = k + 1; j < D; ++j) P[i * ld + j] -= lik * P[k * ld + j];
        b[i] -= lik * bk;
      }
    }
    __syncwarp();
  }
  for (int j = D - 1; j >= 0; --j) {        // U x = y
    const float xj = b[j] / P[j * ld + j];
    if (lane == 0) x[j] = xj;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = lane + 32 * s;
      if (i < j) b[i] -= P[i * ld + j] * xj;
    }
    __syncwarp();
  }
  return true;
}

// Rank 0: the damped, gauge-fixed, Jacobi-scaled pose solve of the reduced
// system in `ws` (the block scales it into a padded copy and factors it;
// "lu" is one warp's), dp, and the candidate poses.
__device__ void pose_step(LmState& st, float* ws, int m, int use_lu,
                          float lam) {
  __shared__ int solved;
  const int D = 6 * m, ld = D + 1;
  const float* A = ws;
  const float* b = A + D * D;
  float* d = ws + D * D + D + 1;
  float* bs = d + D;
  float* x = bs + D;
  float* rs = x + D;
  float* P = rs + D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = st.fixed[i / 6] ? 1.0f : A[i * D + i] + lam;
    d[i] = 1.0f / sqrtf(fmaxf(v, 1e-12f));
    bs[i] = d[i] * (st.fixed[i / 6] ? 0.0f : b[i]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < D * D; idx += blockDim.x) {
    const int i = idx / D, j = idx % D;
    float v = A[idx];
    if (i == j) v += lam;
    if (st.fixed[i / 6] || st.fixed[j / 6]) v = (i == j) ? 1.0f : 0.0f;
    P[i * ld + j] = v * d[i] * d[j];
  }
  __syncthreads();
  if (use_lu) {
    if (threadIdx.x < 32) {
      const bool ok = lu_solve_warp(P, ld, bs, x, D);
      if (threadIdx.x == 0) solved = ok ? 1 : 0;
    }
  } else {
    // rows a warp and column slots a lane for this window's size
    const bool ok =
        D <= 40 ? chol_solve_block<kWarps, 5, 2>(P, ld, bs, rs, x, D)
        : D <= 64 ? chol_solve_block<kWarps, 8, 2>(P, ld, bs, rs, x, D)
                  : chol_solve_block<kWarps, 12, 3>(P, ld, bs, rs, x, D);
    if (threadIdx.x == 0) solved = ok ? 1 : 0;
  }
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    st.dp[i] = solved ? d[i] * x[i] : nan;
  __syncthreads();
  if (threadIdx.x < m) {
    const int k = threadIdx.x;
    if (st.fixed[k]) {
#pragma unroll
      for (int i = 0; i < 16; ++i) st.cand[16 * k + i] = st.poses[16 * k + i];
    } else {
      se3_exp_apply(st.dp + 6 * k, st.poses + 16 * k, st.cand + 16 * k);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
ba_lm_kernel(const float* __restrict__ poses_in,
             const float* __restrict__ lms_in,
             const float* __restrict__ obs_uv,
             const unsigned char* __restrict__ obs_valid,
             const float* __restrict__ intr,
             const unsigned char* __restrict__ fixed, float lam0,
             float huber, int n, int m, int iters, int use_lu,
             float* __restrict__ poses_out, float* __restrict__ lms_out,
             float* __restrict__ costs, float* __restrict__ trace,
             double* __restrict__ hinv, double* __restrict__ bl,
             double* __restrict__ U, unsigned char* __restrict__ seen,
             float* __restrict__ cand_lms) {
  {  // problem blockIdx.y: its inputs, outputs, trace and scratch
    const size_t q = blockIdx.y, nm = (size_t)n * m;
    poses_in += q * 16 * m;
    lms_in += q * 3 * n;
    obs_uv += q * 2 * nm;
    obs_valid += q * nm;
    fixed += q * m;
    poses_out += q * 16 * m;
    lms_out += q * 3 * n;
    costs += q * iters;
    trace += q * ((size_t)n_entries(m) + (size_t)iters * (6 * m + 4));
    hinv += q * 9 * n;
    bl += q * 3 * n;
    U += q * 18 * nm;
    seen += q * n;
    cand_lms += q * 3 * n;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = (float*)smem;                        // rank 0's workspace
  double* part = (double*)(smem + region_bytes(m));
  __shared__ LmState st;
  const int tid = threadIdx.x;
  const int D = 6 * m, P = n_entries(m);
  const int per = (n + csize - 1) / csize;
  const int lo = min(n, rank * per), hi = min(n, lo + per);
  const Problem pb{obs_uv, obs_valid, intr[0], intr[1], intr[2], intr[3],
                   huber, m, use_lu};

  for (int i = tid; i < 16 * m; i += blockDim.x) st.poses[i] = poses_in[i];
  for (int i = tid; i < m; i += blockDim.x) st.fixed[i] = fixed[i];
  for (int g = 3 * lo + tid; g < 3 * hi; g += blockDim.x)
    lms_out[g] = lms_in[g];
  if (tid == 0) st.lam = lam0;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float lam = st.lam;
    float* tr = trace + P + it * (D + 4);   // dp, lam, cost, new cost, accept
    for (int e = tid; e < P; e += blockDim.x) part[e] = 0.0;
    for (int n0 = lo; n0 < hi; n0 += tile_landmarks(m))
      assemble_tile(pb, st, lms_out, n0, hi, lam, smem, part, hinv, bl, U,
                    seen);
    cluster.sync();
    // this CTA's slice of the entries, summed over the ranks in rank order
    float* ws0 = cluster.map_shared_rank(ws, 0);
    for (int e = rank * blockDim.x + tid; e < P; e += csize * blockDim.x) {
      double acc = 0.0;
      for (int q = 0; q < csize; ++q)
        acc += cluster.map_shared_rank(part, q)[e];
      ws0[e] = (float)acc;
    }
    cluster.sync();
    if (rank == 0) {
      if (it == 0)
        for (int e = tid; e < P; e += blockDim.x) trace[e] = ws[e];
      if (tid == 0) st.cost = ws[P - 1];
      __syncthreads();
      pose_step(st, ws, m, use_lu, lam);
      for (int i = tid; i < D; i += blockDim.x) tr[i] = st.dp[i];
      if (tid == 0) tr[D] = lam;
    }
    cluster.sync();
    if (rank != 0) {
      const float* c0 = cluster.map_shared_rank(st.cand, 0);
      const float* d0 = cluster.map_shared_rank(st.dp, 0);
      for (int i = tid; i < 16 * m; i += blockDim.x) st.cand[i] = c0[i];
      for (int i = tid; i < D; i += blockDim.x) st.dp[i] = d0[i];
    }
    __syncthreads();
    // back-substitution and the candidate's cost, one thread a landmark
    double cost = 0.0;
    for (int gn = lo + tid; gn < hi; gn += blockDim.x) {
      float X[3] = {lms_out[3 * gn], lms_out[3 * gn + 1], lms_out[3 * gn + 2]};
      if (seen[gn]) {
        double udp[3] = {0.0, 0.0, 0.0};
        for (int k = 0; k < m; ++k) {
          if (!obs_valid[(size_t)gn * m + k]) continue;   // U_k is zero
          const double* Uk = U + 18 * ((size_t)gn * m + k);
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const double dd = st.dp[6 * k + i];
#pragma unroll
            for (int j = 0; j < 3; ++j) udp[j] += Uk[3 * i + j] * dd;
          }
        }
        double rhs[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) rhs[j] = bl[3 * (size_t)gn + j] - udp[j];
        const double* Hi = hinv + 9 * (size_t)gn;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          X[i] += (float)(Hi[3 * i] * rhs[0] + Hi[3 * i + 1] * rhs[1]
                          + Hi[3 * i + 2] * rhs[2]);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) cand_lms[3 * (size_t)gn + i] = X[i];
      for (int k = 0; k < m; ++k) {
        const size_t ob = (size_t)gn * m + k;
        if (!obs_valid[ob]) continue;
        const float* T = st.cand + 16 * k;
        const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
        const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
        const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
        const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
        const float r0 = pb.fy * p1 / z + pb.cy - obs_uv[2 * ob];
        const float r1 = pb.fx * p0 / z + pb.cx - obs_uv[2 * ob + 1];
        cost += huber_weight(r0, r1, huber) * (r0 * r0 + r1 * r1);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cost += __shfl_down_sync(0xffffffffu, cost, off);
    if ((tid & 31) == 0) st.warp_cost[tid >> 5] = cost;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += st.warp_cost[w];
      st.cost_part = s;
    }
    cluster.sync();
    if (rank == 0 && tid == 0) {
      double s = 0.0;
      for (int q = 0; q < csize; ++q)
        s += *cluster.map_shared_rank(&st.cost_part, q);
      const float new_cost = (float)s, old = st.cost;
      const bool accept = new_cost < old;
      costs[it] = accept ? new_cost : old;
      tr[D + 1] = old;
      tr[D + 2] = new_cost;
      tr[D + 3] = accept ? 1.0f : 0.0f;
      st.accept = accept ? 1 : 0;
    }
    cluster.sync();
    const int accept = *cluster.map_shared_rank(&st.accept, 0);
    if (accept) {
      for (int i = tid; i < 16 * m; i += blockDim.x) st.poses[i] = st.cand[i];
      for (int gn = lo + tid; gn < hi; gn += blockDim.x)
#pragma unroll
        for (int i = 0; i < 3; ++i)
          lms_out[3 * (size_t)gn + i] = cand_lms[3 * (size_t)gn + i];
    }
    __syncthreads();
    if (tid == 0)
      st.lam = accept ? fmaxf(lam * 0.3f, 1e-8f) : fminf(lam * 4.0f, 1e4f);
    __syncthreads();
  }
  if (rank == 0)
    for (int i = tid; i < 16 * m; i += blockDim.x) poses_out[i] = st.poses[i];
  cluster.sync();   // no CTA leaves while another may still read its memory
}

size_t smem_of(int m) {
  return region_bytes(m) + (size_t)n_entries(m) * 8;
}

// Once, for the largest window, so that no later call (one inside a CUDA
// graph capture among them) sets an attribute.
cudaError_t set_attributes() {
  static cudaError_t attr_err = [] {
    size_t most = 0;
    for (int mm = 1; mm <= kMaxPoses; ++mm) {
      const size_t b = smem_of(mm);
      most = b > most ? b : most;
    }
    cudaError_t err = cudaFuncSetAttribute(
        ba_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        ba_lm_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return attr_err;
}

cudaLaunchConfig_t launch_config(int m, int n_streams, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, n_streams, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_of(m);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The whole LM solve of S problems in one launch of S clusters of kCluster
// CTAs. Problem s's poses (m, 4, 4), lms (n, 3), obs_uv (n, m, 2) float32,
// obs_valid (n, m) and fixed (m) bytes at s times those sizes; intr (4)
// float32, shared. Out, per problem: poses_out (m, 4, 4), lms_out (n, 3),
// costs (iters) float32; trace (P + iters * (6m + 4)) float32 with P = 36
// m^2 + 6 m + 1. Scratch, per problem: hinv (n, 3, 3), bl (n, 3), U (n, m,
// 6, 3) float64, seen (n) bytes, cand_lms (n, 3) float32.
extern "C" int vpp_ba_lm(const float* poses, const float* lms,
                         const float* obs_uv, const unsigned char* obs_valid,
                         const float* intr, const unsigned char* fixed,
                         float lam0, float huber, int n, int m, int iters,
                         int use_lu, int n_streams, float* poses_out,
                         float* lms_out, float* costs, float* trace,
                         double* hinv, double* bl, double* U,
                         unsigned char* seen, float* cand_lms, void* stream) {
  if (m < 1 || m > kMaxPoses || n < 0 || iters < 0 || n_streams < 1 ||
      n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(m, n_streams, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, ba_lm_kernel, poses, lms, obs_uv, obs_valid,
                         intr, fixed, lam0, huber, n, m, iters, use_lu,
                         poses_out, lms_out, costs, trace, hinv, bl, U, seen,
                         cand_lms);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of K6 at windows of m poses the card holds at once.
extern "C" int vpp_ba_max_active_clusters(int m, int* out) {
  if (m < 1 || m > kMaxPoses) return (int)cudaErrorInvalidValue;
  cudaError_t e = set_attributes();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(m, 1, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, ba_lm_kernel, &cfg);
}
