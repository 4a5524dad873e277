// K9 — bundle adjustment on the generic tracks layout: a whole
// ba_solve_tracks(ring_layout=False) call, every Levenberg-Marquardt
// iteration and the pose solve included, in one cooperative launch. obs_pose
// (N, K) names any pose for each observation slot.
//
// Replaces vpp_tpu/slam/ba.py:ba_solve_tracks (:568) on the generic layout:
// the gather of each observation's pose (_obs_poses :403), the analytic
// Jacobians (_track_jacobians :414), the per-landmark Hll, bl, damped
// inverse, U and W, the scatter-add assembly of the generic branch
// (_tracks_assemble :512-526: Hpp and bp scattered by pose, the per-landmark
// (N, K, K, 6, 6) pair tensor -W_k U_l^T scattered into S[pose_k, pose_l],
// and rhs), the damped, gauge-fixed, Jacobi-scaled pose solve
// (_tracks_solve_poses :530), the back-substitution (_tracks_backsub :563),
// the candidate's cost (_tracks_cost :445) and the accept test. On the TPU
// the assembly was an XLA scatter of N K^2 6x6 blocks and the pose solve a
// dense (6M)^3 factorisation. Here an index built once a call makes the
// sparsity of S free, and the pose solve factorises only S's band: each
// landmark couples the poses that see it, so S is block-banded, and its
// block half-bandwidth beta (the widest pose span of one landmark's valid
// slots) is known from the index.
//
// Stages, separated by grid barriers (the launch is cooperative: the grid
// is sized to what the card holds at once, and every loop strides over it;
// a CTA takes a contiguous chunk of the landmarks, the same in every stage):
//   index, once a call — each CTA counts its contiguous segment of the slots
//     by scatter pose (the JAX rule: a negative index counts from the end,
//     one still outside [0, M) is dropped; an invalid slot goes to pose 0,
//     where its weight is 0), per warp with __match_any_sync; a barrier;
//     the flags of the non-empty 6x6 blocks of S (every diagonal one
//     included) and, a warp a pose, the CTAs' counts scanned into offsets;
//     a barrier; every CTA scans the poses' totals and places its slots,
//     stable in slot order, and a warp a row counts its non-empty blocks; a
//     barrier; every CTA scans the row counts, and a warp a row compacts its
//     blocks into a list in row-major order. beta comes from the landmarks'
//     valid, in-range slots only: a masked slot's block with pose 0 holds
//     exact zeros (its weight is 0) and does not widen the band;
//   landmarks (a thread a landmark) — after the previous iteration's
//     decision (below): per slot the residual, the Jacobians Jp (2x6) and
//     Jl (2x3) in float32 with proj_jacobians' |z| < 1e-6 clamp at the
//     gathered pose (negative indices from the end, then clamped into
//     [0, M), as JAX gathers), the Huber weight masked by obs_valid and the
//     float32 cost term; then in float64 Hll, bl, seen, Hll + (lam + 1e-6) I
//     (I where unseen), its inverse (_inv3 for linalg="chol", a pivoted 3x3
//     for "lu"), U = Jp_w^T Jl and W = U Hll_inv, all to device memory,
//     and, where the problem has a masked slot (the index notes it), a
//     flag on each slot of weight 0 whose every term is an exact zero (the
//     landmark's U, W and bl and the slot's residual finite);
//   blocks (a warp a non-empty block of S) — the lanes share the slots that
//     scatter to the block's row pose, in slot order, and for each add -W_k
//     U_l^T for every slot l of the same landmark that scatters to the column
//     pose, plus Jp_w^T Jp and rhs (bp - W bl) on the diagonal blocks,
//     skipping the flagged slots (every masked slot scatters to pose 0, so
//     without the flag pose 0's blocks would sum the zeros of all of them;
//     the sums are the same); a butterfly of shuffles sums the lanes; S's
//     blocks inside the band go to device memory, rounded to float32 from
//     float64 sums (and the whole of S to the trace at the first iteration,
//     where asked); a block outside the band with both poses free raises a
//     flag where it is not finite (the dense solve's result would then be
//     NaN);
//   solve — _tracks_solve_poses on the band: lam I added once, identity rows
//     and columns for fixed poses, the Jacobi scaling d = rsqrt(max(diag,
//     1e-12)), the band in LAPACK-like column storage, then for linalg="lu"
//     an LU with partial pivoting (gbtrf's algorithm, kl = ku = 6 beta + 5,
//     U's band widening to kl + ku) and for "chol" a band Cholesky (pbtrf's),
//     by 6-column panels, one a pose: CTA 0's warp 0 factors a panel of up
//     to 64 rows in registers (lane l rows l, l + 32), the pivot search by
//     two warp reductions (the first largest |v|), the row swaps across the
//     panel by shuffles, the multipliers and the panel's own update; a
//     taller panel (a wide band) is loaded into shared memory and factored
//     by all of CTA 0 the same way; then the panel is applied to
//     the trailing band, the right-hand side carried as one more column (LU:
//     a warp a column, the swaps, the unit lower solve of the U rows and the
//     rank-6 update below; Cholesky: a warp a column of the lower band); then
//     back-substitution panel by panel, lanes 0-5 the panel's rows, by
//     shuffles and the diagonal's reciprocals. Where the band fits CTA 0's
//     shared memory (a narrow band: on the H100 at M 128 up to beta 3 for lu,
//     10 for chol) CTA 0 alone solves, the other CTAs waiting at the next
//     grid barrier: one panel's update is a few thousand entries, less work
//     than a grid barrier costs. Where it does not (a wide band, a loop
//     closure's, or many poses) the band sits in the workspace and every warp
//     of the grid takes trailing columns, with a grid barrier after each
//     panel's factorisation and after its update; the same operations in the
//     same order, so the same bits. The entries skipped are zeros, so the
//     pivots are the dense factorisation's, and where the band spans the
//     whole matrix (beta = M - 1) the same code is the dense factorisation.
//     dp = d x, NaN everywhere where a pivot is zero (lu), a pivot is not
//     positive (chol), the flag above is raised or x is not finite;
//   step (a thread a landmark) — se3_exp(dp_k) @ T_k for every free pose
//     (each CTA its own copy), dl = Hll_inv (bl - sum_k U_k^T dp_k) (zero
//     where unseen), the candidate landmark and its Huber cost;
//   decide (at the start of the next iteration's landmark stage, and after
//     the last) — every CTA sums the per-CTA costs of the iterate and of the
//     candidate in the same order, so each takes the same decision: accept
//     where new < old (NaN rejects), lam = accept ? max(0.3 lam, 1e-8) :
//     min(4 lam, 1e4); CTA 0 records the costs and the trace and moves the
//     poses, every CTA its landmarks.
// No float atomics anywhere: every sum runs in an order fixed by the inputs
// and the grid, so two calls give the same bits. No host read inside the
// call.
//
// Sizes and routes. Any pose count M, slot count K and landmark count N:
// K bounds loops only, and every offset that grows with M or with N K is
// 64-bit (a slot's own index is 32-bit: N K <= INT_MAX, past any card's
// memory at ~380 workspace bytes a slot). What grows with M is staged in a
// CTA's shared memory where it fits the CTA's budget (the dynamic shared
// memory less kHead) and read in the workspace in device memory where it
// does not (routes_of; the launch reports the routes it took): the index's
// per-warp counts and scan (36 M bytes; else each CTA's part of the
// workspace), the landmark stage's poses (64 M; else read where they lie),
// the step's dp and candidate poses (88 M; else dp read in the workspace
// and each CTA's candidates in its part of it), and the pose solve (CTA 0
// with the band in shared memory; else the grid with the band in the
// workspace and each panel, 24 (6 + kl) bytes, in each CTA's shared memory;
// else that panel, factored and read, in the workspace). Each route reads
// the same values and sums them in the same order, so the bits do not
// depend on the route. On the H100 (232,448 bytes a CTA) the index leaves
// shared memory past M 6453, the landmark stage past M 3630, the step past
// M 2640; the pose solve leaves CTA 0 past M 131 (lu) or 356 (chol) at a
// chain band (beta 3) and past M 38 (lu) or 39 (chol) at a full band, and
// its panel leaves shared memory past M 1612 at a full band (never at a
// chain band). S's blocks and the band are (6M)^2 float32 each in the
// workspace: past ~M 16000 on an 80 GB card the workspace's allocation is
// what fails.
//
// Precision, as in the plain version (slam/ba.py): residuals and Jacobians
// in float32; the landmark blocks (Hll, its inverse, U, W, bl, dl) and the
// sums of S, rhs and the costs in float64, rounded to float32; the pose
// solve and the pose step in float32. Invalid slots run the same arithmetic
// with weight 0, so a non-finite obs_uv there makes the cost and bl NaN as
// in the plain version (and in the JAX package).
//
// Bound on the H100 at N 10240, M 128, K 4 (the JAX package's production
// scale): an iteration is ~0.2 M float32 Jacobian operations and ~20 M
// float64 operations of landmark algebra and pairs against ~0.8 MB of
// inputs; the band factorisation is ~2e6 operations (beta 3). The launch
// sits at latency: the grid barriers, the landmark and block stages (a
// thread a landmark and a warp a block of S: 10240 threads and 884 warps,
// fewer than the 132 resident CTAs hold, so a second CTA an SM would add
// no parallel work; its ~240 registers a thread hold it to one), and the pose
// solve's M serial panel steps in one CTA, each a chain of warp
// reductions, shuffles and barriers of a few microseconds (measured by
// the stamps; see PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "pose_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kHead = 128;          // bytes of reduction slots in shared memory

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

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

// the device's nanosecond clock, for the stage stamps
__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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
  __syncthreads();
  if (lane == 0) warp_part[wid] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
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

// The CTA's largest of one int a thread, in every thread.
__device__ int block_max(int v, int* warp_int) {
  v = __reduce_max_sync(kFull, v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) warp_int[wid] = v;
  __syncthreads();
  int r = warp_int[0];
  for (int w = 1; w < kWarps; ++w) r = max(r, warp_int[w]);
  return r;
}

// out[0, cnt] = the exclusive scan of in[0, cnt) and its total, by one CTA
// (each thread a contiguous run of the entries). Ends with a barrier.
__device__ void scan_into(const int* in, int cnt, int* out, int* warp_int) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int run = (cnt + kThreads - 1) / kThreads;
  const int i0 = min(cnt, tid * run), i1 = min(cnt, i0 + run);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += in[i];
  int x = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) warp_int[wid] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < wid; ++w) before += warp_int[w];
  int at = before + x - mine;
  for (int i = i0; i < i1; ++i) {
    out[i] = at;
    at += in[i];
  }
  if (tid == kThreads - 1) out[cnt] = at;
  __syncthreads();
}

// The scratch of one call, carved from one workspace (256-byte aligned).
struct Work {
  int* cnt;        // (G, M) per-CTA slot counts by pose, then offsets
  int* ptot;       // (M) slots a pose
  int* poff;       // (M + 1) each pose's first slot in plist
  int* rcnt;       // (M) non-empty blocks a row
  int* bpart;      // (G) per-CTA widest pose span
  int* mpart;      // (G) per-CTA: a masked slot
  int* plist;      // (N K) slots sorted by scatter pose
  unsigned char* flags;  // (M, M) non-empty blocks
  int* blist;      // (M M) their list, row-major: a M + b, below 2^31
                   // while rb's 144 M^2 bytes fit any card
  int* nonfin;     // (iters) a non-finite block outside the band
  float* jp;       // (N K, 2, 6) float32
  float* jl;       // (N K, 2, 3)
  float* res;      // (N K, 2)
  float* wt;       // (N K)
  double* U;       // (N K, 6, 3) float64
  double* W;       // (N K, 6, 3)
  unsigned char* quiet;  // (N K) a slot every term of which is an exact 0
  double* hinv;    // (N, 3, 3)
  double* bl;      // (N, 3)
  unsigned char* seen;  // (N)
  double* part;    // (2, G) per-CTA costs of the iterate, by parity
  double* part2;   // (2, G) per-CTA costs of the candidate, by parity
  float* cand_lms;    // (N, 3)
  float* cand_poses;  // (M, 4, 4)
  float* rb;       // (M, M, 6, 6) S's blocks inside the band, raw
  float* rhs;      // (6M)
  float* dp;       // (6M) the pose step
  float* ab;       // (6M, 6M) the band where it does not fit shared memory
  float* gy;       // (6M) there: the rhs, then x
  float* gd;       // (6M) there: the Jacobi scales
  float* grinv;    // (6M) there: 1 / the diagonal
  float* gpn;      // (6M, 6) there: the factored panel
  int* gint;       // (64) there: the pivot flag, the swaps' rows
  int* icnt;       // (G, (kWarps + 1) M + 1) the index's per-warp counts and
                   // scan, where they do not fit shared memory
  float* gcand;    // (G, M, 4, 4) each CTA's candidate poses, where the
                   // step's do not fit shared memory
};

// Where each stage keeps what it stages by M (Routes below): shared memory,
// or device memory where it does not fit the CTA's budget of smem bytes.
// The bytes a stage stages: the index's per-warp counts and scan, the
// landmark stage's poses, the step's dp and candidate poses.
__host__ __device__ inline size_t index_bytes(int m) {
  return (size_t)4 * ((size_t)(kWarps + 1) * m + 1);
}
__host__ __device__ inline size_t lms_bytes(int m) { return (size_t)64 * m; }
__host__ __device__ inline size_t step_bytes(int m) { return (size_t)88 * m; }
// the pose solve by CTA 0 alone, the band in its shared memory: the
// scratch (rhs, scales, indices, panel, U rows, reciprocals) and the band
__host__ __device__ inline size_t solve_cta_bytes(int m, int beta, bool lu) {
  const int n = 6 * m;
  const int kl = imin(6 * beta + 5, n - 1);
  const int up = lu ? imin(2 * kl, n - 1) : 0;
  const int ld = up + kl + 1 >= n ? n : up + kl + 1;
  const size_t head = ((size_t)4 * (2 * n + 120 + 6 * imin(n, 6 + kl)
                                    + 6 * (up + 1) + n) + 15) / 16 * 16;
  return head + (size_t)n * ld * sizeof(float);
}
// the grid's pose solve: the pivots and reductions, then the factored
// panel (rows of 6) where it is staged
__host__ __device__ inline size_t solve_panel_bytes(int m, int beta) {
  const int n = 6 * m;
  return 128 + (size_t)24 * imin(n, 6 + imin(6 * beta + 5, n - 1));
}

// A call's routes: 1 where a stage stages in shared memory, 0 where it
// reads and writes device memory; the solve 2 (CTA 0, the band in shared
// memory), 1 (the grid, the panel in shared memory) or 0 (the grid, the
// panel in device memory).
struct Routes {
  int index, lms, step, solve;
};
__host__ __device__ inline Routes routes_of(int m, int beta, bool lu,
                                            size_t smem) {
  Routes r;
  r.index = index_bytes(m) <= smem;
  r.lms = lms_bytes(m) <= smem;
  r.step = step_bytes(m) <= smem;
  r.solve = solve_cta_bytes(m, beta, lu) <= smem ? 2
            : solve_panel_bytes(m, beta) <= smem ? 1 : 0;
  return r;
}

struct Args {
  const float* poses_in;
  const float* lms_in;
  const int* obs_pose;
  const float* obs_uv;
  const unsigned char* obs_valid;
  const float* intr;
  const unsigned char* fixed;
  int n, kk, m, iters, use_lu, smem_bytes;
  float* routes;   // (4) out: the index's, landmarks', step's and solve's
                   // routes (Routes)
  float huber, lam0;
  float* poses;    // (M, 4, 4) out
  float* lms;      // (N, 3) out
  float* costs;    // (iters) out
  float* per;      // (iters, 6M + 4) out: dp, lam, cost, candidate, accept
  float* s0;       // (6M, 6M) the first iteration's S, or null
  float* extra;    // (3 (6M) + 2): the first iteration's rhs, x, d, cost;
                   // beta
  long long* stamps;  // (8 iters + 3) stage ends in ns, then per iteration
                      // the pose solve's sub-stages in SM cycles; or null
};

// The band of the scaled pose system in column storage: entry (i, c) of
// column c at row offset i - c + up, for up rows above the diagonal and lo
// below; or the whole (dense) column where the band spans the matrix.
struct Band {
  float* p;
  int n, ld, up, lo;
  bool dense;
  __device__ bool in(int i, int c) const {
    return dense || (c - i <= up && i - c <= lo);
  }
  __device__ float& at(int i, int c) const {
    return p[(size_t)c * ld + (dense ? i : i - c + up)];
  }
  __device__ float get(int i, int c) const { return in(i, c) ? at(i, c) : 0.0f; }
  // the upper triangular factor's (i, c): U's for lu, L's transpose for chol
  __device__ float ut(bool lu, int i, int c) const {
    return lu ? get(i, c) : get(c, i);
  }
};

// The panel of LU's columns j0..j0+5 (rows j0..j0+R-1, R <= 32 Q) held in
// registers by warp 0, lane l holding rows l, l + 32, ...: partial pivoting
// (the first largest |v| by two warp reductions), the row swaps across the
// panel by shuffles, the multipliers and the panel's own update. Writes the
// factored panel to pn and the pivots' rows to piv; returns whether a pivot
// was zero.
template <int Q>
__device__ bool lu_panel_regs(const Band& B, int j0, int R, float* pn,
                              int* piv) {
  const int lane = threadIdx.x & 31;
  float v[Q][6];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = lane + 32 * q;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      v[q][c] = r < R ? B.get(j0 + r, j0 + c) : 0.0f;
  }
  bool zero = false;
#pragma unroll
  for (int jj = 0; jj < 6; ++jj) {
    unsigned bb = 0u;
    int bi = INT_MAX;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + 32 * q;
      if (r >= jj && r < R) {
        const unsigned u = __float_as_uint(fabsf(v[q][jj]));
        if (bi == INT_MAX || u > bb) {
          bb = u;
          bi = r;
        }
      }
    }
    const unsigned mx = __reduce_max_sync(kFull, bb);
    const int pr = __reduce_min_sync(
        kFull, (bi != INT_MAX && bb == mx) ? bi : INT_MAX);
    const int pq = pr >> 5, pl = pr & 31;
    if (lane == 0) piv[jj] = j0 + pr;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float pv = v[0][c];
#pragma unroll
      for (int q = 1; q < Q; ++q)
        if (pq == q) pv = v[q][c];
      const float top = __shfl_sync(kFull, v[0][c], jj);
      pv = __shfl_sync(kFull, pv, pl);
      if (lane == pl) {
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if (pq == q) v[q][c] = top;
      }
      if (lane == jj) v[0][c] = pv;
    }
    float urow[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) urow[c] = __shfl_sync(kFull, v[0][c], jj);
    zero |= urow[jj] == 0.0f;
    const float inv = 1.0f / urow[jj];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + 32 * q;
      if (r > jj && r < R) {
        const float l = v[q][jj] * inv;
        v[q][jj] = l;
#pragma unroll
        for (int c = jj + 1; c < 6; ++c) v[q][c] -= l * urow[c];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = lane + 32 * q;
    if (r < R)
#pragma unroll
      for (int c = 0; c < 6; ++c) pn[6 * r + c] = v[q][c];
  }
  return zero;
}

// The panel's columns j0..j0+5, rows j0..j0+R-1, into pn (rows of 6) by
// threads t, t + nt, ..., four loads in flight each; with upper, the
// entries above the diagonal zero (Cholesky's lower triangle).
__device__ void panel_load(const Band& B, bool upper, int j0, int R,
                           float* pn, int t, int nt) {
  for (int e0 = t; e0 < 6 * R; e0 += 4 * nt) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = e0 + q * nt, rr = e / 6, jj = e - 6 * rr;
      v[q] = e < 6 * R && (!upper || rr >= jj) ? B.get(j0 + rr, j0 + jj)
                                               : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (e0 + q * nt < 6 * R) pn[e0 + q * nt] = v[q];
  }
}

// The forward solve of the rhs's six rows of a factored Cholesky panel (pn,
// rows of 6), by a warp, by shuffles.
__device__ __forceinline__ void chol_panel_rhs(int j0, const float* pn,
                                               float* y) {
  const int lane = threadIdx.x & 31;
  float yv = lane < 6 ? y[j0 + lane] : 0.0f;
  for (int jj = 0; jj < 6; ++jj) {
    if (lane == jj) yv = yv / pn[6 * jj + jj];
    const float yj = __shfl_sync(kFull, yv, jj);
    if (lane > jj && lane < 6) yv -= pn[6 * lane + jj] * yj;
  }
  if (lane < 6) y[j0 + lane] = yv;
  __syncwarp();
}

// The Cholesky panel (columns j0..j0+5, rows j0..j0+R-1, R <= 32 Q) in
// registers by warp 0, right-looking, then the forward solve of the rhs's
// six rows of the panel (y). Writes the panel's L to pn; returns whether a
// pivot was not positive.
template <int Q>
__device__ bool chol_panel_regs(const Band& B, int j0, int R, float* pn,
                                float* y) {
  const int lane = threadIdx.x & 31;
  float v[Q][6];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = lane + 32 * q;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      v[q][c] = (r < R && r >= c) ? B.get(j0 + r, j0 + c) : 0.0f;
  }
  bool bad = false;
#pragma unroll
  for (int jj = 0; jj < 6; ++jj) {
    const float dv = __shfl_sync(kFull, v[0][jj], jj);
    bad |= !(dv > 0.0f);
    const float l = sqrtf(dv), il = 1.0f / l;
    if (lane == jj) v[0][jj] = l;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + 32 * q;
      if (r > jj && r < R) v[q][jj] *= il;
    }
    float lc[6];
#pragma unroll
    for (int c = jj + 1; c < 6; ++c) lc[c] = __shfl_sync(kFull, v[0][jj], c);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int r = lane + 32 * q;
      if (r > jj && r < R)
#pragma unroll
        for (int c = jj + 1; c < 6; ++c)
          if (c <= r) v[q][c] -= v[q][jj] * lc[c];
    }
  }
  float yv = lane < 6 ? y[j0 + lane] : 0.0f;
#pragma unroll
  for (int jj = 0; jj < 6; ++jj) {
    if (lane == jj) yv = yv / v[0][jj];
    const float yj = __shfl_sync(kFull, yv, jj);
    if (lane > jj && lane < 6) yv -= v[0][jj] * yj;
  }
  if (lane < 6) y[j0 + lane] = yv;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int r = lane + 32 * q;
    if (r < R)
#pragma unroll
      for (int c = 0; c < 6; ++c) pn[6 * r + c] = v[q][c];
  }
  return bad;
}

// LU's panel for more than 64 rows, already in shared memory (pn, rows of
// 6), by the CTA: the pivot search (the first largest |v|) by warp
// reductions and one across the warps (red: 2 kWarps ints), the row swap,
// the multipliers and the panel's own update by every thread; the pivots'
// rows to piv. Returns whether a pivot was zero.
__device__ bool lu_panel_cta(int j0, int R, float* pn, int* piv, int* red) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  bool zero = false;
  for (int jj = 0; jj < 6; ++jj) {
    unsigned bb = 0u;
    int bi = INT_MAX;
    for (int rr = jj + tid; rr < R; rr += kThreads) {
      const unsigned v = __float_as_uint(fabsf(pn[6 * rr + jj]));
      if (bi == INT_MAX || v > bb) {
        bb = v;
        bi = rr;
      }
    }
    const unsigned mx = __reduce_max_sync(kFull, bb);
    const int pw = __reduce_min_sync(
        kFull, (bi != INT_MAX && bb == mx) ? bi : INT_MAX);
    if (lane == 0) {
      red[wid] = (int)mx;
      red[kWarps + wid] = pw;
    }
    __syncthreads();
    unsigned gm = 0u;
    for (int q = 0; q < kWarps; ++q)
      if (red[kWarps + q] != INT_MAX && (unsigned)red[q] > gm)
        gm = (unsigned)red[q];
    int pr = INT_MAX;
    for (int q = 0; q < kWarps; ++q)
      if (red[kWarps + q] != INT_MAX && (unsigned)red[q] == gm)
        pr = min(pr, red[kWarps + q]);
    if (tid == 0) piv[jj] = j0 + pr;
    if (pr != jj && tid < 6) {
      const float t = pn[6 * jj + tid];
      pn[6 * jj + tid] = pn[6 * pr + tid];
      pn[6 * pr + tid] = t;
    }
    __syncthreads();
    const float pv = pn[6 * jj + jj];
    zero |= pv == 0.0f;
    const float inv = 1.0f / pv;
    for (int rr = jj + 1 + tid; rr < R; rr += kThreads) {
      const float l = pn[6 * rr + jj] * inv;
      pn[6 * rr + jj] = l;
      for (int c = jj + 1; c < 6; ++c) pn[6 * rr + c] -= l * pn[6 * jj + c];
    }
    __syncthreads();
  }
  return zero;
}

// The Cholesky panel for more than 64 rows, already in shared memory (pn),
// by the CTA: each column's scaling and the panel's own update by every
// thread, then warp 0 the forward solve of the rhs's six rows. Returns
// whether a pivot was not positive.
__device__ bool chol_panel_cta(int j0, int R, float* pn, float* y) {
  const int tid = threadIdx.x;
  bool bad = false;
  for (int jj = 0; jj < 6; ++jj) {
    const float dv = pn[6 * jj + jj];
    bad |= !(dv > 0.0f);
    const float l = sqrtf(dv), il = 1.0f / l;
    __syncthreads();
    if (tid == 0) pn[6 * jj + jj] = l;
    for (int rr = jj + 1 + tid; rr < R; rr += kThreads) pn[6 * rr + jj] *= il;
    __syncthreads();
    for (int rr = jj + 1 + tid; rr < R; rr += kThreads) {
      const float lr = pn[6 * rr + jj];
      for (int c = jj + 1; c < 6 && c <= rr; ++c)
        pn[6 * rr + c] -= lr * pn[6 * c + jj];
    }
    __syncthreads();
  }
  if (tid < 32) chol_panel_rhs(j0, pn, y);
  return bad;
}

// Panel j0 (rows j0..j0+R-1), called by every thread of a CTA: up to 64
// rows warp 0 factors it in registers straight from the band; more rows are
// loaded into pn and factored by the CTA. Then, for LU, thread 0 works out
// the rows the six swaps move: the panel's own first, then the pivot rows
// below it, aff[0, 12) the rows, aff[12, 24) the row whose value each
// receives, aff[24] how many; with srcrow (up to 64 rows), each panel
// row's source row. A zero (lu) or non-positive (chol) pivot sets *bad.
// Ends with a CTA barrier.
__device__ void factor_panel(const Band& B, bool lu, int j0, int R,
                             float* pn, int* piv, int* red, float* y,
                             int* aff, int* bad, int* srcrow) {
  const int tid = threadIdx.x, wid = tid >> 5;
  bool b = false;
  if (R <= 64) {
    if (wid == 0) {
      if (lu)
        b = R <= 32 ? lu_panel_regs<1>(B, j0, R, pn, piv)
                    : lu_panel_regs<2>(B, j0, R, pn, piv);
      else
        b = R <= 32 ? chol_panel_regs<1>(B, j0, R, pn, y)
                    : chol_panel_regs<2>(B, j0, R, pn, y);
    }
  } else {
    panel_load(B, !lu, j0, R, pn, tid, kThreads);
    __syncthreads();
    b = lu ? lu_panel_cta(j0, R, pn, piv, red) : chol_panel_cta(j0, R, pn, y);
  }
  if (tid == 0) {
    if (b) *bad = 1;
    if (lu) {
      int* aff_dst = aff;
      int* aff_src = aff + 12;
      int na = 6;
      for (int k = 0; k < 6; ++k) aff_dst[k] = aff_src[k] = j0 + k;
      for (int jj = 0; jj < 6; ++jj) {
        const int pr = piv[jj];
        int q = pr - j0;
        if (pr >= j0 + 6) {
          q = 6;
          while (q < na && aff_dst[q] != pr) ++q;
          if (q == na) {
            aff_dst[na] = aff_src[na] = pr;
            ++na;
          }
        }
        const int t = aff_src[jj];
        aff_src[jj] = aff_src[q];
        aff_src[q] = t;
      }
      aff[24] = na;
      if (srcrow && R <= 64) {
        for (int rr = 0; rr < R; ++rr) srcrow[rr] = j0 + rr;
        for (int a = 0; a < na; ++a) srcrow[aff_dst[a] - j0] = aff_src[a];
      }
    }
  }
  __syncthreads();
}

// LU's trailing columns j0 + 6 .. j0 + 5 + T of panel j0 and the rhs
// (t == T), a warp a column, lane l holding the panel rows l, l + 32, ...
// (R <= 32 Q): each row's value after the panel's swaps (srcrow), then the
// unit lower solve of the six U rows and the rank-6 update of the rows
// below, by shuffles, written back in place.
template <int Q>
__device__ void lu_trailing_regs(const Band& B, int j0, int R, int T,
                                 const float* pn, const int* srcrow,
                                 float* y) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int t = wid; t <= T; t += kWarps) {
    const bool isy = t == T;
    const int c = j0 + 6 + t;
    float v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int rr = lane + 32 * q;
      v[q] = rr >= R ? 0.0f : isy ? y[srcrow[rr]] : B.get(srcrow[rr], c);
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) {
      const float u = __shfl_sync(kFull, v[0], jj);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int rr = lane + 32 * q;
        if (rr > jj && rr < R) v[q] -= pn[6 * rr + jj] * u;
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int rr = lane + 32 * q;
      if (rr < R) {
        if (isy) y[j0 + rr] = v[q];
        else if (B.in(j0 + rr, c)) B.at(j0 + rr, c) = v[q];
      }
    }
  }
}

// The back-substitution's upper triangular solve of panel j0's six rows, by
// a warp: lanes 0-5 the rows, by shuffles, multiplying by the diagonal's
// reciprocals; y's six rows become x's, and xb holds them in every lane.
__device__ __forceinline__ void panel_backsub(const Band& B, bool lu, int j0,
                                              float* y, const float* rinv,
                                              float xb[6]) {
  const int lane = threadIdx.x & 31;
  float urow[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    urow[c] = lane < 6 && c > lane ? B.ut(lu, j0 + lane, j0 + c) : 0.0f;
  float xv = lane < 6 ? y[j0 + lane] * rinv[j0 + lane] : 0.0f;
#pragma unroll
  for (int jj = 5; jj >= 0; --jj) {
    xb[jj] = __shfl_sync(kFull, xv, jj);
    if (lane < jj) xv -= urow[jj] * rinv[j0 + lane] * xb[jj];
  }
  if (lane < 6) y[j0 + lane] = xv;
}

// _tracks_solve_poses on the band, by CTA 0: dp (and the trace's row, and
// the first iteration's x and d) from S's raw band blocks and rhs. With
// cyc, thread 0 writes the SM cycles of its sub-stages: the system, the
// panels' factorisation (warp 0), the trailing updates, the
// back-substitution.
__device__ void solve_poses_in(const Args& A, const Work& w, float lam,
                               int beta, int it, unsigned char* smem,
                               long long* cyc) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int m = A.m, n = 6 * m;
  const bool lu = A.use_lu != 0;
  const int kl = min(6 * beta + 5, n - 1);
  Band B;
  B.n = n;
  B.lo = kl;
  B.up = lu ? min(2 * kl, n - 1) : 0;
  B.dense = B.up + kl + 1 >= n;
  B.ld = B.dense ? n : B.up + kl + 1;
  const int rmax = min(n, 6 + kl);          // rows of a panel
  const int tmax = B.up + 1;                // trailing columns, the rhs too
  float* y = reinterpret_cast<float*>(smem);   // (n) rhs, then x
  float* d = y + n;                            // (n) Jacobi scales
  int* sint = reinterpret_cast<int*>(d + n);   // (120) see below
  int* piv = sint;           // [0, 6) the panel's pivot rows
  int* aff = sint + 8;       // [8, 33) the rows its swaps move, their
                             // sources, how many (factor_panel)
  const int* aff_dst = aff;
  const int* aff_src = aff + 12;
  int* red = sint + 36;      // [36, 52) the pivot search across warps
  int* flag = sint + 52;     // [52, 54) a zero or non-positive pivot, the
                             // blocks' flag
  int* srcrow = sint + 56;   // [56, 120) each panel row's source row
  float* pn = reinterpret_cast<float*>(sint + 120);  // (rmax, 6) the panel
  float* u12 = pn + 6 * rmax;                  // (6, tmax) its U rows
  float* rinv = u12 + 6 * tmax;                // (n) 1 / the diagonal
  // the band, 16-byte aligned
  const size_t head = ((size_t)(reinterpret_cast<unsigned char*>(
                           rinv + n) - smem) + 15) / 16 * 16;
  B.p = reinterpret_cast<float*>(smem + head);
  const unsigned char* fixed = A.fixed;
  long long t0 = 0, t_sys = 0, t_fac = 0, t_trail = 0, t_back = 0;
  const bool timed = cyc != nullptr && tid == 0;
  if (timed) t0 = clock64();

  // damping, gauge and scaling: d, bs (into y), then the band: zero, and
  // S's blocks inside it damped, fixed and scaled, a thread a block
  for (int i = tid; i < n; i += kThreads) {
    const int a = i / 6;
    const float s = w.rb[((size_t)a * m + a) * 36 + (i % 6) * 7];
    const float di = rsqrtf(nan_max(fixed[a] ? 1.0f : s + lam, 1e-12f));
    d[i] = di;
    y[i] = di * (fixed[a] ? 0.0f : w.rhs[i]);
  }
  const int total = n * B.ld;
  for (int e = tid; e < total; e += kThreads) B.p[e] = 0.0f;
  if (tid == 0) {
    flag[0] = 0;
    flag[1] = w.nonfin[it];
  }
  __syncthreads();
  const int span = 2 * beta + 1;
  for (long long bi = tid; bi < (long long)m * span; bi += kThreads) {
    const int a = (int)(bi / span), b = a - beta + (int)(bi % span);
    if (b < 0 || b >= m) continue;
    const bool listed = w.flags[(size_t)a * m + b] != 0;
    const bool fx = fixed[a] || fixed[b];
    const float* rbk = w.rb + ((size_t)a * m + b) * 36;
    for (int i = 0; i < 6; ++i) {
      const int r = 6 * a + i;
      for (int q = 0; q < 6; ++q) {
        const int c = 6 * b + q;
        if (!lu && r < c) continue;
        float v = listed ? rbk[6 * i + q] : 0.0f;
        v += r == c ? lam : 0.0f;
        if (fx) v = r == c ? 1.0f : 0.0f;
        B.at(r, c) = v * d[r] * d[c];
      }
    }
  }
  __syncthreads();
  if (timed) {
    const long long t = clock64();
    t_sys += t - t0;
    t0 = t;
  }

  for (int p = 0; p < m; ++p) {
    const int j0 = 6 * p;
    const int rend = min(n, j0 + 6 + kl), R = rend - j0;
    // LU's trailing columns j0 + 6 .. j0 + 5 + T and the rhs (t == T)
    const int T = lu ? min(n - 1, j0 + 5 + B.up) - (j0 + 5) : 0;
    factor_panel(B, lu, j0, R, pn, piv, red, y, aff, flag, srcrow);
    if (timed) {
      const long long t = clock64();
      t_fac += t - t0;
      t0 = t;
    }
    if (lu) {
      // U11 and 1 / its diagonal into the band's and rinv's places
      for (int e = tid; e < 36; e += kThreads) {
        const int rr = e / 6, c = e - 6 * rr;
        if (rr <= c) B.at(j0 + rr, j0 + c) = pn[e];
        if (rr == c) rinv[j0 + rr] = 1.0f / pn[e];
      }
    }
    if (lu && R <= 64) {
      // the trailing columns (and the rhs, t == T), a warp a column, a
      // lane a row: the panel's row swaps, then its unit lower solve for
      // the U rows and the rank-6 update below, by shuffles
      if (R <= 32) lu_trailing_regs<1>(B, j0, R, T, pn, srcrow, y);
      else lu_trailing_regs<2>(B, j0, R, T, pn, srcrow, y);
    } else if (lu) {
      // the trailing columns (a thread a column): the panel's row swaps,
      // and the unit lower solve for their U rows
      const int na = aff[24];
      for (int t = tid; t <= T; t += kThreads) {
        const bool isy = t == T;
        const int c = j0 + 6 + t;
        float val[12];
#pragma unroll
        for (int q = 0; q < 12; ++q)
          val[q] = q >= na ? 0.0f
                   : isy ? y[aff_src[q]] : B.get(aff_src[q], c);
#pragma unroll
        for (int q = 6; q < 12; ++q) {
          if (q < na) {
            if (isy) y[aff_dst[q]] = val[q];
            else B.at(aff_dst[q], c) = val[q];
          }
        }
        float u[6];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          float v = val[jj];
#pragma unroll
          for (int kq = 0; kq < jj; ++kq) v -= pn[6 * jj + kq] * u[kq];
          u[jj] = v;
          u12[jj * tmax + t] = v;
          if (isy) y[j0 + jj] = v;
          else if (B.in(j0 + jj, c)) B.at(j0 + jj, c) = v;
        }
      }
      __syncthreads();
      // the rank-6 update of the rows below the panel: a warp a column,
      // a lane a row
      for (int t = wid; t <= T; t += kWarps) {
        const bool isy = t == T;
        const int c = j0 + 6 + t;
        float uu[6];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) uu[jj] = u12[jj * tmax + t];
        for (int r = j0 + 6 + lane; r < rend; r += 32) {
          const float* lr = pn + 6 * (r - j0);
          float* dst = isy ? &y[r] : &B.at(r, c);
          float v = *dst;
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) v -= lr[jj] * uu[jj];
          *dst = v;
        }
      }
    } else {
      // L of the panel into the band, 1 / its diagonal into rinv; the
      // trailing lower band (a warp a column, a lane a row) and the rhs
      for (int e = tid; e < 6 * R; e += kThreads) {
        const int rr = e / 6, jj = e - 6 * rr;
        if (rr >= jj && B.in(j0 + rr, j0 + jj)) B.at(j0 + rr, j0 + jj) = pn[e];
        if (rr == jj) rinv[j0 + rr] = 1.0f / pn[e];
      }
      for (int c = j0 + 6 + wid; c < rend; c += kWarps) {
        const float* lc = pn + 6 * (c - j0);
        float lcv[6];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) lcv[jj] = lc[jj];
        const int r1 = B.dense ? rend : min(rend, c + kl + 1);
        for (int r = c + lane; r < r1; r += 32) {
          const float* lr = pn + 6 * (r - j0);
          float v = B.at(r, c);
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) v -= lr[jj] * lcv[jj];
          B.at(r, c) = v;
        }
      }
      for (int r = j0 + 6 + tid; r < rend; r += kThreads) {
        const float* lr = pn + 6 * (r - j0);
        float v = y[r];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) v -= lr[jj] * y[j0 + jj];
        y[r] = v;
      }
    }
    __syncthreads();
    if (timed) {
      const long long t = clock64();
      t_trail += t - t0;
      t0 = t;
    }
  }

  // back-substitution by panels, last first (warp 0): the panel's upper
  // triangular solve by shuffles (lanes 0-5 its rows, multiplying by the
  // diagonal's reciprocals), then its columns out of the rows above
  if (wid == 0) {
    const int wdt = lu ? B.up : kl;
    for (int p = m - 1; p >= 0; --p) {
      const int j0 = 6 * p;
      float xb[6];
      panel_backsub(B, lu, j0, y, rinv, xb);
      for (int i = max(0, j0 - wdt) + lane; i < j0; i += 32) {
        float v = y[i];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) v -= B.ut(lu, i, j0 + jj) * xb[jj];
        y[i] = v;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (timed) {
    const long long t = clock64();
    t_back += t - t0;
    cyc[0] = t_sys;
    cyc[1] = t_fac;
    cyc[2] = t_trail;
    cyc[3] = t_back;
  }
  int bad = 0;
  for (int i = tid; i < n; i += kThreads) bad |= isfinite(y[i]) ? 0 : 1;
  const bool ok = !__syncthreads_or(bad | flag[0] | flag[1]);
  const float nan = __int_as_float(0x7fc00000);
  float* row = A.per + (size_t)it * (n + 4);
  for (int i = tid; i < n; i += kThreads) {
    const float v = ok ? d[i] * y[i] : nan;
    w.dp[i] = v;
    row[i] = v;
    if (it == 0) {
      A.extra[n + i] = y[i];
      A.extra[2 * n + i] = d[i];
    }
  }
}

// _tracks_solve_poses where the band does not fit CTA 0's shared memory (a
// wide band, or many poses), called by every CTA: the band, the right-hand
// side, the scales, the reciprocals of the diagonal and the factored panel
// live in the workspace, and the grid shares each panel's trailing update. Per
// panel: CTA 0 factors it (factor_panel) and publishes it; a grid barrier;
// every warp of the grid takes trailing columns, a column each (LU: the swaps,
// the U rows and the rank-6 update below, the right-hand side one more column;
// Cholesky: the lower band, and every thread rows of the right-hand side); a
// grid barrier. Then CTA 0 back-substitutes (warp 0 each panel's triangle, its
// threads the rows above). Every entry sees the operations of solve_poses_in
// in their order, so the bits are the same.
__device__ void solve_poses_grid(const Args& A, const Work& w, float lam,
                                 int beta, int it, unsigned char* smem,
                                 bool panel_shared, long long* cyc,
                                 cg::grid_group& grid) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = blockIdx.x;
  const int gt = g * kThreads + tid, GT = gridDim.x * kThreads;
  const int gw = g * kWarps + wid, GW = gridDim.x * kWarps;
  const int m = A.m, n = 6 * m;
  const bool lu = A.use_lu != 0;
  const int kl = min(6 * beta + 5, n - 1);
  Band B;
  B.n = n;
  B.lo = kl;
  B.up = lu ? min(2 * kl, n - 1) : 0;
  B.dense = B.up + kl + 1 >= n;
  B.ld = B.dense ? n : B.up + kl + 1;
  B.p = w.ab;
  float* y = w.gy;         // (n) rhs, then x
  float* d = w.gd;         // (n) Jacobi scales
  float* rinv = w.grinv;   // (n) 1 / the diagonal
  float* pn = w.gpn;       // (rows, 6) the factored panel, published
  int* gi = w.gint;        // [0] a zero or non-positive pivot; [8, 33)
                           // the rows the swaps move (factor_panel)
  // shared memory: the pivots, the back-substitution's six x, the pivot
  // search's reductions, then each CTA's copy of the panel (CTA 0: while
  // it is factored) where it fits (panel_shared); else every CTA reads
  // the published panel, and CTA 0 factors it, in device memory
  int* piv = reinterpret_cast<int*>(smem);
  float* xbs = reinterpret_cast<float*>(piv + 8);
  int* red = reinterpret_cast<int*>(xbs + 8);   // (2 kWarps)
  float* pns = panel_shared ? reinterpret_cast<float*>(smem + 128) : pn;
  const unsigned char* fixed = A.fixed;
  long long t0 = 0, t_sys = 0, t_fac = 0, t_trail = 0, t_back = 0;
  const bool timed = cyc != nullptr && g == 0 && tid == 0;
  if (timed) t0 = clock64();

  // damping, gauge and scaling: d, bs (into y) and the band zeroed; a
  // barrier; S's blocks inside the band damped, fixed and scaled; a barrier
  for (int i = gt; i < n; i += GT) {
    const int a = i / 6;
    const float s = w.rb[((size_t)a * m + a) * 36 + (i % 6) * 7];
    const float di = rsqrtf(nan_max(fixed[a] ? 1.0f : s + lam, 1e-12f));
    d[i] = di;
    y[i] = di * (fixed[a] ? 0.0f : w.rhs[i]);
  }
  const size_t total = (size_t)n * B.ld;
  for (size_t e = gt; e < total; e += GT) B.p[e] = 0.0f;
  if (gt == 0) gi[0] = 0;
  grid.sync();
  const int span = 2 * beta + 1;
  for (long long bi = gt; bi < (long long)m * span; bi += GT) {
    const int a = (int)(bi / span), b = a - beta + (int)(bi % span);
    if (b < 0 || b >= m) continue;
    const bool listed = w.flags[(size_t)a * m + b] != 0;
    const bool fx = fixed[a] || fixed[b];
    const float* rbk = w.rb + ((size_t)a * m + b) * 36;
    for (int i = 0; i < 6; ++i) {
      const int r = 6 * a + i;
      for (int q = 0; q < 6; ++q) {
        const int c = 6 * b + q;
        if (!lu && r < c) continue;
        float v = listed ? rbk[6 * i + q] : 0.0f;
        v += r == c ? lam : 0.0f;
        if (fx) v = r == c ? 1.0f : 0.0f;
        B.at(r, c) = v * d[r] * d[c];
      }
    }
  }
  grid.sync();
  if (timed) {
    const long long t = clock64();
    t_sys += t - t0;
    t0 = t;
  }

  for (int p = 0; p < m; ++p) {
    const int j0 = 6 * p;
    const int rend = min(n, j0 + 6 + kl), R = rend - j0;
    const int T = lu ? min(n - 1, j0 + 5 + B.up) - (j0 + 5) : 0;
    if (g == 0) {
      factor_panel(B, lu, j0, R, pns, piv, red, y, gi + 8, gi, nullptr);
      // the panel out to the grid; LU's U11 or Cholesky's L into the band,
      // 1 / the diagonal into rinv
      for (int e = tid; e < 6 * R; e += kThreads) {
        const int rr = e / 6, c = e - 6 * rr;
        if (panel_shared) pn[e] = pns[e];
        if (lu ? rr <= c : rr >= c && B.in(j0 + rr, j0 + c))
          B.at(j0 + rr, j0 + c) = pns[e];
        if (rr == c) rinv[j0 + rr] = 1.0f / pns[e];
      }
      if (timed) {
        const long long t = clock64();
        t_fac += t - t0;
        t0 = t;
      }
    }
    grid.sync();
    // the published panel into the shared memory of each CTA with trailing
    // work (CTA 0 holds it), which reads it for every row of every column
    float* pl = pns;
    const int cols = lu ? T + 1 : rend - j0 - 6;
    if (panel_shared && g != 0 && g * kWarps < cols) {
      for (int e0 = tid; e0 < 6 * R; e0 += 4 * kThreads) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = e0 + q * kThreads;
          v[q] = e < 6 * R ? pn[e] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (e0 + q * kThreads < 6 * R) pl[e0 + q * kThreads] = v[q];
      }
      __syncthreads();
    }
    if (lu) {
      // a warp a column (t == T: the right-hand side): lane q < na holds
      // the value row aff_src[q] gives row aff_dst[q]
      const int na = gi[8 + 24];
      const int* aff_dst = gi + 8;
      const int* aff_src = gi + 20;
      for (int t = gw; t <= T; t += GW) {
        const bool isy = t == T;
        const int c = j0 + 6 + t;
        float val = 0.0f;
        if (lane < na) val = isy ? y[aff_src[lane]] : B.get(aff_src[lane], c);
        __syncwarp();
        if (lane >= 6 && lane < na) {
          if (isy) y[aff_dst[lane]] = val;
          else B.at(aff_dst[lane], c) = val;
        }
        float u[6];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          float v = __shfl_sync(kFull, val, jj);
#pragma unroll
          for (int kq = 0; kq < jj; ++kq) v -= pl[6 * jj + kq] * u[kq];
          u[jj] = v;
          if (lane == jj) {
            if (isy) y[j0 + jj] = v;
            else if (B.in(j0 + jj, c)) B.at(j0 + jj, c) = v;
          }
        }
        __syncwarp();
        // the rank-6 update of the rows below, four rows in flight a lane
        for (int r0 = j0 + 6 + lane; r0 < rend; r0 += 128) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 32 * q;
            v[q] = r < rend ? (isy ? y[r] : B.at(r, c)) : 0.0f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 32 * q;
            if (r < rend) {
              const float* lr = pl + 6 * (r - j0);
#pragma unroll
              for (int jj = 0; jj < 6; ++jj) v[q] -= lr[jj] * u[jj];
              if (isy) y[r] = v[q];
              else B.at(r, c) = v[q];
            }
          }
        }
      }
    } else {
      // the trailing lower band, a warp a column, four rows in flight a
      // lane; the right-hand side's rows, a thread each
      for (int c = j0 + 6 + gw; c < rend; c += GW) {
        const float* lc = pl + 6 * (c - j0);
        float lcv[6];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) lcv[jj] = lc[jj];
        const int r1 = B.dense ? rend : min(rend, c + kl + 1);
        for (int r0 = c + lane; r0 < r1; r0 += 128) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 32 * q;
            v[q] = r < r1 ? B.at(r, c) : 0.0f;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 32 * q;
            if (r < r1) {
              const float* lr = pl + 6 * (r - j0);
#pragma unroll
              for (int jj = 0; jj < 6; ++jj) v[q] -= lr[jj] * lcv[jj];
              B.at(r, c) = v[q];
            }
          }
        }
      }
      for (int r = j0 + 6 + gt; r < rend; r += GT) {
        const float* lr = pl + 6 * (r - j0);
        float v = y[r];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) v -= lr[jj] * y[j0 + jj];
        y[r] = v;
      }
    }
    grid.sync();
    if (timed) {
      const long long t = clock64();
      t_trail += t - t0;
      t0 = t;
    }
  }
  if (g != 0) return;

  // back-substitution by panels, last first: warp 0 the panel's triangle,
  // then the CTA its columns out of the rows above
  const int wdt = lu ? B.up : kl;
  for (int p = m - 1; p >= 0; --p) {
    const int j0 = 6 * p;
    if (wid == 0) {
      float xb[6];
      panel_backsub(B, lu, j0, y, rinv, xb);
      if (lane < 6) xbs[lane] = xb[lane];
    }
    __syncthreads();
    for (int i = max(0, j0 - wdt) + tid; i < j0; i += kThreads) {
      float v = y[i];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) v -= B.ut(lu, i, j0 + jj) * xbs[jj];
      y[i] = v;
    }
    __syncthreads();
  }
  if (timed) {
    const long long t = clock64();
    t_back += t - t0;
    cyc[0] = t_sys;
    cyc[1] = t_fac;
    cyc[2] = t_trail;
    cyc[3] = t_back;
  }
  int bad = 0;
  for (int i = tid; i < n; i += kThreads) bad |= isfinite(y[i]) ? 0 : 1;
  const bool ok = !__syncthreads_or(bad | gi[0] | w.nonfin[it]);
  const float nan = __int_as_float(0x7fc00000);
  float* row = A.per + (size_t)it * (n + 4);
  for (int i = tid; i < n; i += kThreads) {
    const float v = ok ? d[i] * y[i] : nan;
    w.dp[i] = v;
    row[i] = v;
    if (it == 0) {
      A.extra[n + i] = y[i];
      A.extra[2 * n + i] = d[i];
    }
  }
}

// _tracks_solve_poses on the band, called by every CTA: by CTA 0 alone
// with the band in its shared memory where it fits after the solve's other
// buffers (route 2), else by the grid with the band in the workspace, the
// panel in each CTA's shared memory (1) or in the workspace (0).
__device__ void solve_poses(const Args& A, const Work& w, float lam, int beta,
                            int it, unsigned char* smem, int route,
                            long long* cyc, cg::grid_group& grid) {
  if (route == 2) {
    if (blockIdx.x == 0) solve_poses_in(A, w, lam, beta, it, smem, cyc);
  } else {
    solve_poses_grid(A, w, lam, beta, it, smem, route == 1, cyc, grid);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
k9_lm(Args A, Work w) {
  cg::grid_group grid = cg::this_grid();
  // the CTA's shared memory: a few reduction slots, then each stage's own
  // buffers from kHead on (the pose solve's band where it fits)
  extern __shared__ __align__(16) unsigned char shared_all[];
  double* warp_part = reinterpret_cast<double*>(shared_all);   // (kWarps)
  int* warp_int = reinterpret_cast<int*>(warp_part + kWarps);  // (kWarps)
  float* sh_cost = reinterpret_cast<float*>(warp_int + kWarps);  // (2)
  unsigned char* smem = shared_all + kHead;
  const size_t budget = (size_t)(A.smem_bytes - kHead);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = blockIdx.x, G = gridDim.x;
  const int n = A.n, kk = A.kk, m = A.m, D = 6 * m, nk = n * kk;
  const int gt = g * kThreads + tid, GT = G * kThreads;
  const int gw = g * kWarps + wid, GW = G * kWarps;
  // this CTA's landmarks, the same in every stage
  const int lchunk = (n + G - 1) / G;
  const int l0 = min(n, g * lchunk), l1 = min(n, l0 + lchunk);
  // this CTA's slots for the index, each warp a contiguous part of them
  const int seg = (nk + G - 1) / G;
  const int s0 = min(nk, g * seg), s1 = min(nk, s0 + seg);
  const int wseg = (s1 - s0 + kWarps - 1) / kWarps;
  const int w0 = min(s1, s0 + wid * wseg), w1 = min(s1, w0 + wseg);
  const float fx = A.intr[0], fy = A.intr[1], cx = A.intr[2], cy = A.intr[3];
  const float huber = A.huber;
  // the stage stamps: the start, the index, then four an iteration (its
  // landmarks, blocks, solve and step), then the end
  const bool stamp = A.stamps != nullptr && g == 0 && tid == 0;
  int ns = 0;
  if (stamp) A.stamps[ns++] = now_ns();

  // -- index 1: zero the flags, count the slots by pose, the band's width
  // (the per-warp counts and their scan in shared memory where they fit,
  // else in this CTA's part of the workspace)
  int* wcnt = index_bytes(m) <= budget
                  ? reinterpret_cast<int*>(smem)
                  : w.icnt + (size_t)g * ((kWarps + 1) * (size_t)m + 1);
  int* sscan = wcnt + kWarps * m;               // (M + 1)
  for (size_t i = gt; i < (size_t)m * m; i += GT) w.flags[i] = 0;
  for (int i = gt; i < A.iters; i += GT) w.nonfin[i] = 0;
  if (g == 0)
    for (int i = tid; i < 16 * m; i += kThreads) A.poses[i] = A.poses_in[i];
  for (int i = tid; i < kWarps * m; i += kThreads) wcnt[i] = 0;
  __syncthreads();
  for (int base = w0; base < w1; base += 32) {
    const int o = base + lane;
    const int a = o < w1 ? scatter_pose(A.obs_pose[o], A.obs_valid[o], m) : -1;
    const unsigned peers = __match_any_sync(kFull, a);
    if (a >= 0 && lane == __ffs(peers) - 1) wcnt[wid * m + a] += __popc(peers);
  }
  __syncthreads();
  for (int a = tid; a < m; a += kThreads) {
    int s = 0;
    for (int ww = 0; ww < kWarps; ++ww) s += wcnt[ww * m + a];
    w.cnt[(size_t)g * m + a] = s;
  }
  int span = 0, masked = 0;
  for (int l = l0 + tid; l < l1; l += kThreads) {
    int lo = INT_MAX, hi = -1;
    for (int k = 0; k < kk; ++k) {
      const int o = l * kk + k;
      if (!A.obs_valid[o]) {
        masked = 1;
        continue;
      }
      const int a = scatter_pose(A.obs_pose[o], true, m);
      if (a < 0) continue;
      lo = min(lo, a);
      hi = max(hi, a);
    }
    if (hi >= 0) span = max(span, hi - lo);
  }
  span = block_max(span, warp_int);
  masked = __syncthreads_or(masked);
  if (tid == 0) {
    w.bpart[g] = span;
    w.mpart[g] = masked;
  }
  grid.sync();

  // -- index 2: the flags; per pose the CTAs' counts to offsets
  for (int a = gt; a < m; a += GT) w.flags[(size_t)a * m + a] = 1;
  for (int o = gt; o < nk; o += GT) {
    const int a = scatter_pose(A.obs_pose[o], A.obs_valid[o], m);
    if (a < 0) continue;
    const int row = o - o % kk;
    for (int l = 0; l < kk; ++l) {
      const int b = scatter_pose(A.obs_pose[row + l], A.obs_valid[row + l], m);
      if (b >= 0) w.flags[(size_t)a * m + b] = 1;
    }
  }
  for (int a = gw; a < m; a += GW) {
    int carry = 0;
    for (int c0 = 0; c0 < G; c0 += 32) {
      const int gg = c0 + lane;
      const int v = gg < G ? w.cnt[(size_t)gg * m + a] : 0;
      int x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (gg < G) w.cnt[(size_t)gg * m + a] = carry + x - v;
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) w.ptot[a] = carry;
  }
  grid.sync();

  // -- index 3: the slots placed, stable in slot order; blocks a row counted
  scan_into(w.ptot, m, sscan, warp_int);
  if (g == 0)
    for (int a = tid; a <= m; a += kThreads) w.poff[a] = sscan[a];
  for (int a = tid; a < m; a += kThreads) {
    int run = sscan[a] + w.cnt[(size_t)g * m + a];
    for (int ww = 0; ww < kWarps; ++ww) {
      const int t = wcnt[ww * m + a];
      wcnt[ww * m + a] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int base = w0; base < w1; base += 32) {
    const int o = base + lane;
    const int a = o < w1 ? scatter_pose(A.obs_pose[o], A.obs_valid[o], m) : -1;
    const unsigned peers = __match_any_sync(kFull, a);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (a >= 0) w.plist[wcnt[wid * m + a] + rank] = o;
    __syncwarp();
    if (a >= 0 && lane == __ffs(peers) - 1) wcnt[wid * m + a] += __popc(peers);
    __syncwarp();
  }
  for (int a = gw; a < m; a += GW) {
    int c = 0;
    for (int b = lane; b < m; b += 32) c += w.flags[(size_t)a * m + b];
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) w.rcnt[a] = c;
  }
  grid.sync();

  // -- index 4: the list of the non-empty blocks, row-major; beta
  scan_into(w.rcnt, m, sscan, warp_int);
  const int nb = sscan[m];
  for (int a = gw; a < m; a += GW) {
    int at = sscan[a];
    for (int b0 = 0; b0 < m; b0 += 32) {
      const int b = b0 + lane;
      const bool f = b < m && w.flags[(size_t)a * m + b] != 0;
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) w.blist[at + __popc(bal & ((1u << lane) - 1u))] = a * m + b;
      at += __popc(bal);
    }
  }
  int beta = 0, any_masked = 0;
  for (int i = lane; i < G; i += 32) {
    beta = max(beta, w.bpart[i]);
    any_masked |= w.mpart[i];
  }
  beta = __reduce_max_sync(kFull, beta);
  // (where no slot is masked, no slot is flagged below: skip the flags)
  any_masked = __reduce_max_sync(kFull, any_masked);
  const Routes rt = routes_of(m, beta, A.use_lu != 0, budget);
  if (g == 0 && tid == 0) {
    A.extra[3 * D + 1] = (float)beta;
    A.routes[0] = (float)rt.index;
    A.routes[1] = (float)rt.lms;
    A.routes[2] = (float)rt.step;
    A.routes[3] = (float)rt.solve;
  }
  grid.sync();
  if (stamp) A.stamps[ns++] = now_ns();

  float lam = A.lam0;
  bool acc = false;
  for (int it = 0; it <= A.iters; ++it) {
    // -- decide on the previous iteration's candidate
    if (it > 0) {
      const int q = (it - 1) & 1;
      if (wid == 0) {
        const double c_old = parts_sum(w.part + q * G, G);
        const double c_new = parts_sum(w.part2 + q * G, G);
        if (lane == 0) {
          sh_cost[0] = (float)c_old;
          sh_cost[1] = (float)c_new;
        }
      }
      __syncthreads();
      const float old = sh_cost[0], cand = sh_cost[1];
      __syncthreads();
      acc = cand < old;
      if (g == 0 && tid == 0) {
        A.costs[it - 1] = acc ? cand : old;
        float* row = A.per + (size_t)(it - 1) * (D + 4);
        row[D] = lam;
        row[D + 1] = old;
        row[D + 2] = cand;
        row[D + 3] = acc ? 1.0f : 0.0f;
        if (it == 1) A.extra[3 * D] = old;
      }
      if (acc) {
        if (g == 0)
          for (int i = tid; i < 16 * m; i += kThreads)
            A.poses[i] = w.cand_poses[i];
        for (int l = l0 + tid; l < l1; l += kThreads)
#pragma unroll
          for (int i = 0; i < 3; ++i)
            A.lms[3 * (size_t)l + i] = w.cand_lms[3 * (size_t)l + i];
      }
      lam = acc ? fmaxf(lam * 0.3f, 1e-8f) : fminf(lam * 4.0f, 1e4f);
    }
    if (it == A.iters) {
      if (stamp) A.stamps[ns++] = now_ns();
      break;
    }

    // -- landmarks (the poses staged in shared memory where they fit)
    {
      const float* src = it == 0 ? A.poses_in : (acc ? w.cand_poses : A.poses);
      const float* sposes = src;                         // (M, 4, 4)
      if (rt.lms) {
        float* st = reinterpret_cast<float*>(smem);
        for (int i = tid; i < 16 * m; i += kThreads) st[i] = src[i];
        sposes = st;
      }
      __syncthreads();
      double cost = 0.0;
      for (int gn = l0 + tid; gn < l1; gn += kThreads) {
        float X[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          X[i] = it == 0 ? A.lms_in[3 * (size_t)gn + i]
                         : A.lms[3 * (size_t)gn + i];
          if (it == 0) A.lms[3 * (size_t)gn + i] = X[i];
        }
        double H[9], b[3] = {0.0, 0.0, 0.0}, wsum = 0.0;
#pragma unroll
        for (int i = 0; i < 9; ++i) H[i] = 0.0;
        for (int k = 0; k < kk; ++k) {
          const size_t o = (size_t)gn * kk + k;
          const float* T = sposes + 16 * gather_pose(A.obs_pose[o], m);
          const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
          const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
          const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
          const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
          const float iz = 1.0f / z;
          const float u = fx * p0 * iz + cx;
          const float v = fy * p1 * iz + cy;
          const float r0 = v - A.obs_uv[2 * o], r1 = u - A.obs_uv[2 * o + 1];
          const float rr = r0 * r0 + r1 * r1;
          const float wt =
              A.obs_valid[o] ? huber_of_norm(sqrtf(rr), huber) : 0.0f;
          cost += (double)(wt * rr);
          const float dd[2][3] = {{0.0f, fy * iz, -fy * p1 * iz * iz},
                                  {fx * iz, 0.0f, -fx * p0 * iz * iz}};
          const float nh[3][3] = {{0.0f, p2, -p1}, {-p2, 0.0f, p0},
                                  {p1, -p0, 0.0f}};
          float Jp[12], Jl[6];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              Jp[6 * q + c] = dd[q][0] * nh[0][c] + dd[q][1] * nh[1][c]
                              + dd[q][2] * nh[2][c];
              Jp[6 * q + 3 + c] = dd[q][c];
              Jl[3 * q + c] = dd[q][0] * T[c] + dd[q][1] * T[4 + c]
                              + dd[q][2] * T[8 + c];
            }
          }
#pragma unroll
          for (int i = 0; i < 12; ++i) w.jp[12 * o + i] = Jp[i];
#pragma unroll
          for (int i = 0; i < 6; ++i) w.jl[6 * o + i] = Jl[i];
          w.res[2 * o] = r0;
          w.res[2 * o + 1] = r1;
          w.wt[o] = wt;
          const double wd = wt;
          wsum += wd;
          const double rd[2] = {r0, r1};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const double jw = (double)Jl[3 * q + i] * wd;
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
        if (A.use_lu) inv3_lu(H, Hi); else inv3_chol(H, Hi);
#pragma unroll
        for (int i = 0; i < 9; ++i) w.hinv[9 * (size_t)gn + i] = Hi[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) w.bl[3 * (size_t)gn + i] = b[i];
        w.seen[gn] = seen ? 1 : 0;
        // U = Jp_w^T Jl and W = U Hll_inv per slot
        bool fin = isfinite(b[0]) && isfinite(b[1]) && isfinite(b[2]);
        for (int k = 0; k < kk; ++k) {
          const size_t o = (size_t)gn * kk + k;
          const double wd = w.wt[o];
          double U[18];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const double j0 = (double)w.jp[12 * o + i] * wd;
            const double j1 = (double)w.jp[12 * o + 6 + i] * wd;
#pragma unroll
            for (int j = 0; j < 3; ++j)
              U[3 * i + j] = j0 * w.jl[6 * o + j] + j1 * w.jl[6 * o + 3 + j];
          }
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const double v = U[3 * i] * Hi[c] + U[3 * i + 1] * Hi[3 + c]
                               + U[3 * i + 2] * Hi[6 + c];
              w.W[18 * o + 3 * i + c] = v;
              fin &= isfinite(v) && isfinite(U[3 * i + c]);
            }
          }
#pragma unroll
          for (int i = 0; i < 18; ++i) w.U[18 * o + i] = U[i];
        }
        // a slot of weight 0 (a masked one) where the landmark's U, W and
        // bl and the slot's residual are finite adds exact zeros to S and
        // rhs (its U and W are 0, and so is every product with them): the
        // blocks stage skips it, with the same sums
        if (any_masked) {
          for (int k = 0; k < kk; ++k) {
            const size_t o = (size_t)gn * kk + k;
            w.quiet[o] = fin && w.wt[o] == 0.0f && isfinite(w.res[2 * o])
                         && isfinite(w.res[2 * o + 1]);
          }
        }
      }
      const double s = block_sum(cost, warp_part);
      if (tid == 0) w.part[(it & 1) * G + g] = s;
    }
    grid.sync();
    if (stamp) A.stamps[ns++] = now_ns();

    // -- S's non-empty blocks, a warp each, and rhs
    {
      bool nonfin = false;
      for (int bi = gw; bi < nb; bi += GW) {
        const int a = w.blist[bi] / m, bcol = w.blist[bi] % m;
        const bool diag = a == bcol;
        double acc6[36], racc[6];
#pragma unroll
        for (int e = 0; e < 36; ++e) acc6[e] = 0.0;
#pragma unroll
        for (int e = 0; e < 6; ++e) racc[e] = 0.0;
        const int j1 = w.poff[a + 1];
        for (int j = w.poff[a] + lane; j < j1; j += 32) {
          const int o = w.plist[j];
          if (any_masked && w.quiet[o]) continue;
          const int row = o - o % kk;
          const double* Wo = w.W + 18 * (size_t)o;
          for (int l = 0; l < kk; ++l) {
            const int ol = row + l;
            if (scatter_pose(A.obs_pose[ol], A.obs_valid[ol], m) != bcol
                || (any_masked && w.quiet[ol]))
              continue;
            const double* Ul = w.U + 18 * (size_t)ol;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
#pragma unroll
              for (int q = 0; q < 6; ++q)
                acc6[6 * i + q] -= Wo[3 * i] * Ul[3 * q]
                                   + Wo[3 * i + 1] * Ul[3 * q + 1]
                                   + Wo[3 * i + 2] * Ul[3 * q + 2];
            }
          }
          if (diag) {
            const double wd = w.wt[o];
            const float* jp = w.jp + 12 * (size_t)o;
            const double r0 = w.res[2 * (size_t)o];
            const double r1 = w.res[2 * (size_t)o + 1];
            const double* bn = w.bl + 3 * (size_t)(o / kk);
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const double a0 = (double)jp[i] * wd, a1 = (double)jp[6 + i] * wd;
#pragma unroll
              for (int q = 0; q < 6; ++q)
                acc6[6 * i + q] += a0 * jp[q] + a1 * jp[6 + q];
              racc[i] -= a0 * r0 + a1 * r1;
              racc[i] -= Wo[3 * i] * bn[0] + Wo[3 * i + 1] * bn[1]
                         + Wo[3 * i + 2] * bn[2];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 36; ++e) acc6[e] = warp_sum(acc6[e]);
        if (diag) {
#pragma unroll
          for (int e = 0; e < 6; ++e) racc[e] = warp_sum(racc[e]);
        }
        if (lane == 0) {
          const bool inband = abs(a - bcol) <= beta;
          const bool free2 = !A.fixed[a] && !A.fixed[bcol];
          float* rbk = w.rb + ((size_t)a * m + bcol) * 36;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int q = 0; q < 6; ++q) {
              const float v = (float)acc6[6 * i + q];
              if (it == 0 && A.s0)
                A.s0[(size_t)(6 * a + i) * D + 6 * bcol + q] = v;
              if (inband) rbk[6 * i + q] = v;
              else if (free2 && !isfinite(v)) nonfin = true;
            }
            if (diag) {
              const float r = (float)racc[i];
              w.rhs[6 * a + i] = r;
              if (it == 0) A.extra[6 * a + i] = r;
            }
          }
        }
      }
      if (nonfin) w.nonfin[it] = 1;
    }
    grid.sync();
    if (stamp) A.stamps[ns++] = now_ns();

    // -- the pose solve
    solve_poses(A, w, lam, beta, it, smem, rt.solve,
                A.stamps && g == 0 ? A.stamps + 4 * A.iters + 3 + 4 * it
                                   : nullptr, grid);
    grid.sync();
    if (stamp) A.stamps[ns++] = now_ns();

    // -- the step: candidate poses and landmarks, the candidate's cost (dp
    // and the CTA's candidate poses in shared memory where they fit, else
    // dp read in the workspace and the candidates in the CTA's part of it)
    {
      const float* sdp = w.dp;                       // (M, 6)
      float* scand = w.gcand + (size_t)g * 16 * m;   // (M, 4, 4)
      if (rt.step) {
        float* st = reinterpret_cast<float*>(smem);
        for (int i = tid; i < D; i += kThreads) st[i] = w.dp[i];
        sdp = st;
        scand = st + D;
      }
      const float* cur = it == 0 ? A.poses_in : A.poses;
      __syncthreads();
      for (int k = tid; k < m; k += kThreads) {
        if (A.fixed[k]) {
#pragma unroll
          for (int i = 0; i < 16; ++i) scand[16 * k + i] = cur[16 * k + i];
        } else {
          se3_exp_apply(sdp + 6 * k, cur + 16 * k, scand + 16 * k);
        }
      }
      __syncthreads();
      if (g == 0)
        for (int i = tid; i < 16 * m; i += kThreads) w.cand_poses[i] = scand[i];
      double cost = 0.0;
      for (int gn = l0 + tid; gn < l1; gn += kThreads) {
        float X[3] = {A.lms[3 * (size_t)gn], A.lms[3 * (size_t)gn + 1],
                      A.lms[3 * (size_t)gn + 2]};
        if (w.seen[gn]) {
          double udp[3] = {0.0, 0.0, 0.0};
          for (int k = 0; k < kk; ++k) {
            const size_t o = (size_t)gn * kk + k;
            const double* Uk = w.U + 18 * o;
            const float* dk =
                sdp + 6 * backsub_pose(A.obs_pose[o], A.obs_valid[o], m);
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const double dd = dk[i];
#pragma unroll
              for (int j = 0; j < 3; ++j) udp[j] += Uk[3 * i + j] * dd;
            }
          }
          double r[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) r[j] = w.bl[3 * (size_t)gn + j] - udp[j];
          const double* Hi = w.hinv + 9 * (size_t)gn;
#pragma unroll
          for (int i = 0; i < 3; ++i)
            X[i] += (float)(Hi[3 * i] * r[0] + Hi[3 * i + 1] * r[1]
                            + Hi[3 * i + 2] * r[2]);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) w.cand_lms[3 * (size_t)gn + i] = X[i];
        for (int k = 0; k < kk; ++k) {
          const size_t o = (size_t)gn * kk + k;
          if (!A.obs_valid[o]) continue;
          const float* T = scand + 16 * gather_pose(A.obs_pose[o], m);
          const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
          const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
          const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
          const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
          const float r0 = fy * p1 / z + cy - A.obs_uv[2 * o];
          const float r1 = fx * p0 / z + cx - A.obs_uv[2 * o + 1];
          const float rr = r0 * r0 + r1 * r1;
          cost += (double)(huber_of_norm(sqrtf(rr), huber) * rr);
        }
      }
      const double s = block_sum(cost, warp_part);
      if (tid == 0) w.part2[(it & 1) * G + g] = s;
    }
    grid.sync();
    if (stamp) A.stamps[ns++] = now_ns();
  }
}

size_t carve(size_t* at, size_t bytes) {
  const size_t here = *at;
  *at += (bytes + 255) / 256 * 256;
  return here;
}

// The workspace's offsets at n landmarks, kk slots, m poses, iters
// iterations, G CTAs and a CTA's budget of smem bytes (the routes that
// stage in device memory take their buffers here); with ws, the pointers.
size_t layout(int n, int kk, int m, int iters, int G, size_t smem,
              unsigned char* ws, Work* w) {
  const size_t nk = (size_t)n * kk, D = 6 * (size_t)m;
  size_t at = 0;
  size_t o[35];
  o[0] = carve(&at, (size_t)G * m * 4);
  o[1] = carve(&at, (size_t)m * 4);
  o[2] = carve(&at, (size_t)(m + 1) * 4);
  o[3] = carve(&at, (size_t)m * 4);
  o[4] = carve(&at, (size_t)G * 4);
  o[5] = carve(&at, nk * 4);
  o[6] = carve(&at, (size_t)m * m);
  o[7] = carve(&at, (size_t)m * m * 4);
  o[8] = carve(&at, (size_t)iters * 4);
  o[9] = carve(&at, nk * 12 * 4);
  o[10] = carve(&at, nk * 6 * 4);
  o[11] = carve(&at, nk * 2 * 4);
  o[12] = carve(&at, nk * 4);
  o[13] = carve(&at, nk * 18 * 8);
  o[14] = carve(&at, nk * 18 * 8);
  o[15] = carve(&at, (size_t)n * 9 * 8);
  o[16] = carve(&at, (size_t)n * 3 * 8);
  o[17] = carve(&at, (size_t)n);
  o[18] = carve(&at, (size_t)2 * G * 8);
  o[19] = carve(&at, (size_t)2 * G * 8);
  o[20] = carve(&at, (size_t)n * 3 * 4);
  o[21] = carve(&at, (size_t)m * 16 * 4);
  o[22] = carve(&at, (size_t)m * m * 36 * 4);
  o[23] = carve(&at, D * 4);
  o[24] = carve(&at, D * 4);
  o[25] = carve(&at, D * D * 4);
  o[26] = carve(&at, nk);
  o[27] = carve(&at, D * 4);
  o[28] = carve(&at, D * 4);
  o[29] = carve(&at, D * 4);
  o[30] = carve(&at, D * 6 * 4);
  o[31] = carve(&at, 64 * 4);
  o[32] = carve(&at, (size_t)G * 4);
  o[33] = carve(&at, index_bytes(m) <= smem
                         ? 0 : (size_t)G * index_bytes(m));
  o[34] = carve(&at, step_bytes(m) <= smem ? 0 : (size_t)G * m * 16 * 4);
  if (w) {
    w->cnt = (int*)(ws + o[0]);
    w->ptot = (int*)(ws + o[1]);
    w->poff = (int*)(ws + o[2]);
    w->rcnt = (int*)(ws + o[3]);
    w->bpart = (int*)(ws + o[4]);
    w->plist = (int*)(ws + o[5]);
    w->flags = ws + o[6];
    w->blist = (int*)(ws + o[7]);
    w->nonfin = (int*)(ws + o[8]);
    w->jp = (float*)(ws + o[9]);
    w->jl = (float*)(ws + o[10]);
    w->res = (float*)(ws + o[11]);
    w->wt = (float*)(ws + o[12]);
    w->U = (double*)(ws + o[13]);
    w->W = (double*)(ws + o[14]);
    w->hinv = (double*)(ws + o[15]);
    w->bl = (double*)(ws + o[16]);
    w->seen = ws + o[17];
    w->part = (double*)(ws + o[18]);
    w->part2 = (double*)(ws + o[19]);
    w->cand_lms = (float*)(ws + o[20]);
    w->cand_poses = (float*)(ws + o[21]);
    w->rb = (float*)(ws + o[22]);
    w->rhs = (float*)(ws + o[23]);
    w->dp = (float*)(ws + o[24]);
    w->ab = (float*)(ws + o[25]);
    w->quiet = ws + o[26];
    w->gy = (float*)(ws + o[27]);
    w->gd = (float*)(ws + o[28]);
    w->grinv = (float*)(ws + o[29]);
    w->gpn = (float*)(ws + o[30]);
    w->gint = (int*)(ws + o[31]);
    w->mpart = (int*)(ws + o[32]);
    w->icnt = (int*)(ws + o[33]);
    w->gcand = (float*)(ws + o[34]);
  }
  return at;
}

// One problem's sizes: any pose, slot and landmark count. The slots'
// indices are 32-bit: N K <= INT_MAX, which no card's memory reaches first
// (the workspace holds ~380 bytes a slot, ~800 GB at 2^31 slots).
bool sizes_ok(int n, int kk, int m, int iters) {
  return n >= 1 && kk >= 1 && m >= 1 && iters >= 1 &&
         (long long)n * kk <= INT_MAX;
}

// The dynamic shared memory of a CTA (all a block may take, less the
// kernel's static shared memory) and the CTAs the card holds at once, asked
// once per device (0: not yet asked).
cudaError_t device_limits(int* smem_bytes, int* resident) {
  static int smem_of[kMaxDevices], resident_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident_of[dev] == 0) {
    int sms = 0, optin = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, k9_lm);
    if (e != cudaSuccess) return e;
    const int dyn = (optin - (int)fa.sharedSizeBytes) / 16 * 16;
    e = cudaFuncSetAttribute(k9_lm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k9_lm, kThreads,
                                                      dyn);
    if (e != cudaSuccess) return e;
    smem_of[dev] = dyn;
    resident_of[dev] = sms * per_sm;
  }
  *smem_bytes = smem_of[dev];
  *resident = resident_of[dev];
  return resident_of[dev] < 1 ? cudaErrorInvalidValue : cudaSuccess;
}

// The grid: enough CTAs for the landmarks (32 a CTA) and for the most
// blocks S can have (a warp each), no more than the card holds at once.
int grid_of(int n, int kk, int m, int resident) {
  const long long most = std::min<long long>((long long)m * m,
                                             (long long)n * kk * kk + m);
  long long G = std::max<long long>((n + 31) / 32, (most + kWarps - 1) / kWarps);
  if (G > resident) G = resident;
  return (int)std::max<long long>(G, 1);
}

}  // namespace

// The shared memory the stages' routes are chosen for: the device's, or
// smem_limit where that is smaller and positive (a test's way to the
// device-memory routes at small sizes; the launch still gets the device's).
int route_smem(int smem, int smem_limit) {
  return smem_limit > kHead && smem_limit < smem ? smem_limit : smem;
}

// The workspace bytes of one call at n landmarks, kk slots, m poses and
// iters iterations, routes chosen for smem_limit as route_smem says (any
// sizes: where they exceed the card, the allocation of these bytes is
// what fails).
extern "C" int vpp_ba_generic_workspace(int n, int kk, int m, int iters,
                                        int smem_limit, long long* bytes) {
  if (n < 1 || kk < 1 || m < 1 || iters < 1)
    return (int)cudaErrorInvalidValue;
  int smem = 0, resident = 0;
  const cudaError_t e = device_limits(&smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int rs = route_smem(smem, smem_limit);
  *bytes = (long long)layout(n, kk, m, iters, grid_of(n, kk, m, resident),
                             (size_t)(rs - kHead), nullptr, nullptr);
  return 0;
}

// The dynamic shared memory a CTA of K9 takes on this device, its stages'
// budget being that less kHead (routes_of).
extern "C" int vpp_ba_generic_smem(int* bytes) {
  int resident = 0;
  return (int)device_limits(bytes, &resident);
}

// One ba_solve_tracks call on the generic layout: poses_in (m, 4, 4),
// lms_in (n, 3), obs_pose (n, kk) int32, obs_uv (n, kk, 2), obs_valid (n, kk)
// bytes, intr (4), fixed (m) bytes; smem_limit: route_smem; out poses (m, 4, 4), lms (n, 3), costs
// (iters), per (iters, 6m + 4) (dp, lam, cost, the candidate's cost, accept),
// s0 (6m, 6m) the first iteration's S where not null (its entries outside
// the non-empty blocks are left as they are: zero them), extra (18m + 2):
// the first iteration's rhs, x, d and cost, then S's block half-bandwidth;
// routes (4): the stages' routes (Routes); stamps (8 iters + 3) int64 where not null: the device clock (ns) at the
// start, after the index, after each iteration's four stages and at the
// end, then per iteration the SM cycles of the pose solve's system,
// panels, trailing updates and back-substitution. ws: the workspace's
// bytes.
extern "C" int vpp_ba_generic_lm(
    const float* poses_in, const float* lms_in, const int* obs_pose,
    const float* obs_uv, const unsigned char* obs_valid, const float* intr,
    const unsigned char* fixed, int n, int kk, int m, int iters, int use_lu,
    int smem_limit, float huber, float lam0, float* poses, float* lms,
    float* costs,
    float* per, float* s0, float* extra, float* routes, long long* stamps,
    unsigned char* ws, void* stream) {
  if (!sizes_ok(n, kk, m, iters)) return (int)cudaErrorInvalidValue;
  int smem = 0, resident = 0;
  cudaError_t e = device_limits(&smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int G = grid_of(n, kk, m, resident);
  Args a;
  a.poses_in = poses_in;
  a.lms_in = lms_in;
  a.obs_pose = obs_pose;
  a.obs_uv = obs_uv;
  a.obs_valid = obs_valid;
  a.intr = intr;
  a.fixed = fixed;
  a.n = n;
  a.kk = kk;
  a.m = m;
  a.iters = iters;
  a.use_lu = use_lu;
  a.smem_bytes = route_smem(smem, smem_limit);
  a.huber = huber;
  a.lam0 = lam0;
  a.poses = poses;
  a.lms = lms;
  a.costs = costs;
  a.per = per;
  a.s0 = s0;
  a.extra = extra;
  a.routes = routes;
  a.stamps = stamps;
  Work w;
  layout(n, kk, m, iters, G, (size_t)(a.smem_bytes - kHead), ws, &w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k9_lm, a, w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
