// K8 — the map-vote PnP: for B match sets that share one frame's
// detections, the whole of _map_vote_pnp after the detection patches, in
// one thread-block-cluster launch: the translation-consensus vote rounds
// (each entry's 4 nearest detections, their translation votes, the
// 3x3-smoothed 33x33 histogram's first peak, the pose shift), the pair
// pick, the appearance gate, both Huber Gauss-Newton PnP solves, the mean
// reprojection error and the count of distinct inlier detections.
//
// Replaces vpp_tpu/slam/pipeline.py:_map_vote_pnp (:325-444), one jitted
// XLA program on the TPU. In plain PyTorch (slam/map_vote.py:
// _map_vote_pnp_plain) it is ~30 operations a vote round and ~1000 a PnP
// solve (einsum, a cuSOLVER Cholesky, se3_exp), ~4000 launches for the
// two match sets of a recovery keyframe. Here it is one launch.
//
// Bound on the H100, B = 2 sets at A 1024 entries, Q 512 detections, P 7
// (chip_smoke.py:k8_bound): X, pos, valid, base and the outputs, and of
// desc and the (9, Q, P^2) detection patches only the rows the gate reads
// (the pairs before the gate, their distinct detections), ~0.84 MB,
// ~0.00025 ms at 3.35 TB/s; 2 sets x 2 rounds x A x (valid Q) squared
// distances (5 operations and one compare each), the gate (9 x P^2
// abs-diff-sums a pair) and 2 solves x 6 PnP iterations over each set's
// inliers (~190 operations an inlier), ~1.4e7 operations, ~0.0002 ms at
// 67 TFLOP/s. The launch sits at latency: 18 serial cluster barriers
// (each a GPU-scope fence), the lanes' serial top-4 scans, and 12
// one-warp 6x6 factorisations.
//
// Design. One cluster of kCluster CTAs of 512 threads per match set
// (blockIdx.y), the entries split into contiguous ranges across its CTAs.
// Each CTA stages the detections (float positions, valid bytes) in shared
// memory once and keeps its own copy of the pose, to which every CTA
// applies the same updates, so the copies stay bit-identical.
//   vote round — 8 lanes an entry (4 entries a warp): the entry projects
//     under the pose (elementwise, in the plain version's order); each
//     lane keeps the 4 first of its strided share of the Q distances (each
//     computed once) under torch.argmin's order — a NaN first, then the
//     smaller value, then the lower index — as 64-bit keys (no branch),
//     and the 8 lanes merge their lists by shuffles. The 4 argmin-and-mask
//     passes of the JAX body are then replayed on that list: a pass takes
//     the next entry of the list unless an entry already picked, at 1e30
//     after its pass, comes first (a short row repeats an index at 1e30, a
//     NaN row picks its first valid detections). Lanes 0-3 vote: integer
//     counts in the CTA's shared histogram (exact in any order). After
//     cluster.sync() the CTAs add their non-zero bins into rank 0's
//     histogram through distributed shared memory, and after a second
//     cluster.sync() every CTA reads the 1089 bins back, smooths them 3x3,
//     takes the first maximum and shifts its pose. The histograms
//     alternate between two buffers by round, so rank 0 clears one while
//     the other may still be read.
//   pick and gate — one thread an entry: the pair nearest the last peak
//     (torch.argmin's order over the 4), its detection j1 and uv1, the
//     inlier test; then, for the inliers gathered in shared memory, the
//     min over the 9 shifted detection patches of the sum of |patch -
//     desc| in index order (a thread an inlier and shift, 16 columns'
//     loads in flight), against 2 gate x max(sum |desc|, 1). Each inlier
//     sets its detection's bit in the CTA's Q-bit set.
//   PnP — one thread an entry (held in registers across the iterations):
//     the residual, the analytic Jacobian of proj_jacobians and the Huber
//     weight (masked by the inlier flag, so a NaN entry poisons the system
//     as in the plain version), the 21 + 6 normal-equation terms summed in
//     float64 in a fixed order and reduced in the block. Each CTA stores
//     its sums into every rank's shared memory; after one cluster.sync()
//     every CTA adds them in rank order, rounds them to float32, adds
//     1e-4 I, factors the 6x6 by one warp (pose_math.cuh, NaN where a
//     pivot is not positive, as chol_solve) and applies se3_exp(dp) @ T
//     itself: one barrier an iteration. The sums alternate between two
//     buffers by iteration for the same reason as the histograms. (Rank 0
//     alone solving after one barrier measured slower: its 16 warps'
//     reduction and two entries a thread cost more than the barriers.)
//   end — the error sum and inlier count a CTA, and its bit set; rank 0
//     adds them in rank order and writes T, err and n.
//
// Bits. Up to the PnP the kernel is bit-equal to the plain version: each
// product and sum rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn: no FMA contraction), in the plain order; bins round half to
// even (rintf, as torch.round) and convert with saturation; the scalars
// arrive as the float32 values the plain version compares with. The PnP
// sums in another order than einsum and factors without cuSOLVER, so it
// agrees with the plain version to rounding, and launches repeat their
// bits (no float atomics).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pose_math.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;     // lanes that scan one entry's detections
constexpr int kPerWarp = 32 / kGroup;
constexpr int kC = 4;
constexpr int kNb = 33;       // histogram bins a side (slam/map_vote.py NB)
constexpr int kNbin = kNb * kNb;
constexpr int kShifts = 9;    // the gate's +-1 px shifted patches
constexpr int kGateRows = kThreads / kShifts;
constexpr int kTerms = 27;    // 21 of H's upper triangle, then 6 of b
constexpr int kMaxQ = 16384;  // slam/map_vote.py MAX_DETECTIONS
constexpr int kCluster = 16;  // CTAs a match set: a non-portable size
constexpr unsigned kVotes = 0x40000000u;  // a pair's code: it votes
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

// `before`'s order as one unsigned 64-bit key, for values that are NaN
// or >= +0 (squared distances): a NaN (high word 0) before every number,
// a number by its bits plus one (they ascend with the value), then the
// index. kNoKey comes after every entry.
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ unsigned long long order_key(float v, int j) {
  const unsigned hi = v != v ? 0u : __float_as_uint(v) + 1u;
  return ((unsigned long long)hi << 32) | (unsigned)j;
}

__device__ __forceinline__ void key_value(unsigned long long k, float* v,
                                          int* j) {
  const unsigned hi = (unsigned)(k >> 32);
  *v = k == kNoKey ? __int_as_float(0x7f800000)
                   : (hi == 0u ? __int_as_float(0x7fc00000)
                               : __uint_as_float(hi - 1u));
  *j = k == kNoKey ? INT_MAX : (int)(unsigned)k;
}

// x into the ascending 4 keys, without a branch.
__device__ __forceinline__ void key4_insert(unsigned long long (&k)[kC],
                                            unsigned long long x) {
  bool c[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) c[i] = x < k[i];
#pragma unroll
  for (int i = kC - 1; i > 0; --i)
    k[i] = c[i - 1] ? k[i - 1] : (c[i] ? x : k[i]);
  k[0] = c[0] ? x : k[0];
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[kC], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : (k == 2 ? a[2] : a[3]));
}

// The camera-frame point of X under the 3x4 rows of T, each coordinate
// ((T[i][0] X0 + T[i][1] X1) + T[i][2] X2) + T[i][3], rounded step by
// step as the plain version's separate operations.
__device__ __forceinline__ void to_camera(const float* T, const float* X,
                                          float (&xc)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xc[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(T[4 * i], X[0]),
                            __fmul_rn(T[4 * i + 1], X[1])),
                  __fmul_rn(T[4 * i + 2], X[2])),
        T[4 * i + 3]);
}

// pinhole: (row, col) = (fy y / z + cy, fx x / z + cx), z clamped away
// from 0, each step rounded on its own (a true division).
__device__ __forceinline__ void pinhole(const float (&xc)[3], const float* in,
                                        float* row, float* col) {
  const float zc = fabsf(xc[2]) < 1e-6f ? 1e-6f : xc[2];
  *row = __fadd_rn(__fdiv_rn(__fmul_rn(in[1], xc[1]), zc), in[3]);
  *col = __fadd_rn(__fdiv_rn(__fmul_rn(in[0], xc[0]), zc), in[2]);
}

struct Args {
  const float* X;              // (A, 3)
  const float* desc;           // (A, P2)
  const unsigned char* base;   // (B, A)
  const int* pos;              // (Q, 2) (row, col)
  const unsigned char* valid;  // (Q,)
  const float* det;            // (9, Q, P2)
  const float* T_prior;        // (4, 4)
  const float* intr;           // (4,) fx, fy, cx, cy
  int A, Q, P2, rounds, iters;
  float r2, bmax, step, inl_r2, gate2, huber1, huber2;
  float* T_out;                // (B, 4, 4)
  float* err;                  // (B,)
  int* n;                      // (B,)
  float* txy;                  // (B, rounds, 2)
  int* j1;                     // (B, A)
  float* uv1;                  // (B, A, 2)
  unsigned char* inl;          // (B, A)
  unsigned* pair_code;         // scratch (B, A, 4): j | kVotes
  float* pair_t;               // scratch (B, A, 4, 2): (tx, ty)
};

struct Shared {
  int hist[2][kNbin];
  double recv[2][kCluster][kTerms];      // every rank's PnP sums
  double warp_part[kWarps][kTerms];
  double err_part;
  int cnt_part;
  int red_v[kWarps];
  int red_i[kWarps];
  float T[16];
  float Tn[16];
  float P[6 * 7];              // the 6x6 system, rows padded to 7
  float b[6], rs[6], x[6];
  float sad[kThreads];
  float energy[kGateRows];
  int gate[kThreads];          // a pass's inliers, for the gate
  int n_gate;
};

// Dynamic shared memory: the detections as float (row, col), their bit
// set, their valid bytes.
__host__ __device__ inline size_t dyn_bytes(int q) {
  return (size_t)q * 8 + (size_t)((q + 31) / 32) * 4 + (size_t)q;
}

// The sum of `acc` over the block's first `nw` warps (those that hold
// entries), in a fixed order: a shuffle tree a term in each warp, then the
// warps in order. Thread t < kTerms returns term t.
__device__ __forceinline__ double block_terms(Shared& sh,
                                              const double (&acc)[kTerms],
                                              int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < nw) {
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      double v = acc[t];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) sh.warp_part[warp][t] = v;
    }
  }
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < kTerms)
    for (int w = 0; w < nw; ++w) s += sh.warp_part[w][threadIdx.x];
  return s;
}

// One entry's share of the PnP normal equations under the pose T: the
// residual, the analytic Jacobian of proj_jacobians (pred = (row, col),
// wrt the left-multiplied twist [w | v]) and the Huber weight, masked by
// `inl` (a NaN entry poisons the sums even at weight 0, as in the plain
// einsum); the upper triangle of J^T w J and -J^T w r added in float64.
__device__ __forceinline__ void normal_terms(const float* T, const float* in,
                                             const float* X, const float* uv,
                                             bool inl, float hub,
                                             double (&acc)[kTerms]) {
  const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
  const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
  const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
  const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
  const float iz = 1.0f / z;
  const float u = in[0] * p0 * iz + in[2];
  const float v = in[1] * p1 * iz + in[3];
  const float res[2] = {v - uv[0], u - uv[1]};
  const float w = inl ? huber_weight(res[0], res[1], hub) : 0.0f;
  // d(row)/d(pc) and d(col)/d(pc), then J = dproj [-[pc]x | I]
  const float d[2][3] = {{0.0f, in[1] * iz, -in[1] * p1 * iz * iz},
                         {in[0] * iz, 0.0f, -in[0] * p0 * iz * iz}};
  const float nh[3][3] = {{0.0f, p2, -p1}, {-p2, 0.0f, p0}, {p1, -p0, 0.0f}};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float J[6], jw[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      J[c] = d[rr][0] * nh[0][c] + d[rr][1] * nh[1][c] + d[rr][2] * nh[2][c];
      J[3 + c] = d[rr][c];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) jw[i] = J[i] * w;
    int t = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) acc[t++] += (double)jw[i] * J[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] -= (double)jw[i] * res[rr];
  }
}

__global__ void __launch_bounds__(kThreads) map_vote_pnp_kernel(Args p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int A = p.A, Q = p.Q, nwords = (Q + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sdet = (float2*)smem;                       // (Q,) (row, col)
  unsigned* sbits = (unsigned*)(sdet + Q);            // Q bits
  unsigned char* svalid = (unsigned char*)(sbits + nwords);
  __shared__ Shared sh;

  const int per = (A + csize - 1) / csize;
  const int lo = min(A, rank * per), hi = min(A, lo + per);
  const int nw = min(kWarps, (hi - lo + 31) / 32);   // warps with entries
  const unsigned char* base = p.base + (size_t)b * A;
  const size_t ab = (size_t)b * A;
  float in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) in[i] = p.intr[i];

  for (int j = tid; j < Q; j += kThreads) {
    sdet[j] = make_float2((float)p.pos[2 * j], (float)p.pos[2 * j + 1]);
    svalid[j] = p.valid[j];
  }
  for (int w = tid; w < nwords; w += kThreads) sbits[w] = 0u;
  if (tid < 16) sh.T[tid] = p.T_prior[tid];

  // -- vote rounds ----------------------------------------------------------
  float tx0 = 0.0f, ty0 = 0.0f;
  for (int r = 0; r < p.rounds; ++r) {
    int* h = sh.hist[r & 1];
    for (int k = tid; k < kNbin; k += kThreads) h[k] = 0;
    __syncthreads();
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
    const bool last_round = r == p.rounds - 1;
    // kGroup lanes an entry, kWarps * 32 / kGroup entries at a time
    const int grp = lane / kGroup, gl = lane % kGroup;
    for (int a0 = lo + warp * kPerWarp; a0 < hi; a0 += kWarps * kPerWarp) {
      const int a = a0 + grp;
      const bool live = a < hi;
      float pr = 0.0f, pc = 0.0f, z = 0.0f;
      if (live) {
        const float X[3] = {p.X[3 * a], p.X[3 * a + 1], p.X[3 * a + 2]};
        float xc[3];
        to_camera(T, X, xc);
        pinhole(xc, in, &pr, &pc);
        z = xc[2];
      }
      unsigned long long key[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) key[c] = kNoKey;
#pragma unroll 4
      for (int j = gl; live && j < Q; j += kGroup) {
        float d = kHuge;
        if (svalid[j]) {
          const float2 q = sdet[j];
          const float dr = __fsub_rn(pr, q.x), dc = __fsub_rn(pc, q.y);
          d = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc));
        }
        key4_insert(key, order_key(d, j));
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1) {
        unsigned long long ok[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          ok[c] = __shfl_xor_sync(0xffffffffu, key[c], off);
#pragma unroll
        for (int c = 0; c < kC; ++c) key4_insert(key, ok[c]);
      }
      float v[kC];
      int ix[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) key_value(key[c], &v[c], &ix[c]);
      if (!live || gl >= kC) continue;
      // replay the 4 argmin-and-mask passes on the merged list; lane gl
      // keeps pass gl's pick
      int k = 0, pmin = INT_MAX, j = 0;
      float d = kHuge;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int ia = k < kC ? pick4(ix, k) : INT_MAX;
        const float va = k < kC ? pick4(v, k) : kHuge;
        int jc;
        float dc;
        if (ia != INT_MAX && (c == 0 || before(va, ia, kHuge, pmin))) {
          jc = ia;
          dc = va;
          ++k;
        } else {
          jc = pmin;
          dc = kHuge;
        }
        pmin = min(pmin, jc);
        if (c == gl) {
          j = jc;
          d = dc;
        }
      }
      const float2 q = sdet[j];
      const float tx = __fdiv_rn(__fmul_rn(__fsub_rn(q.y, pc), z), in[0]);
      const float ty = __fdiv_rn(__fmul_rn(__fsub_rn(q.x, pr), z), in[1]);
      const bool m = base[a] && d <= p.r2 && z > 0.1f;
      if (m) {
        const int bx = clampi(
            (int)rintf(__fdiv_rn(__fadd_rn(tx, p.bmax), p.step)), 0, kNb - 1);
        const int by = clampi(
            (int)rintf(__fdiv_rn(__fadd_rn(ty, p.bmax), p.step)), 0, kNb - 1);
        atomicAdd(&h[by * kNb + bx], 1);
      }
      if (last_round) {
        const size_t e = (ab + a) * kC + gl;
        p.pair_code[e] = (unsigned)j | (m ? kVotes : 0u);
        p.pair_t[2 * e] = tx;
        p.pair_t[2 * e + 1] = ty;
      }
    }
    cluster.sync();                       // every CTA's counts are in
    if (rank != 0) {
      int* h0 = cluster.map_shared_rank(h, 0);
      for (int k = tid; k < kNbin; k += kThreads)
        if (h[k]) atomicAdd(&h0[k], h[k]);
    }
    cluster.sync();                       // rank 0 holds the totals
    if (rank != 0) {
      const int* h0 = cluster.map_shared_rank(h, 0);
      constexpr int kLoads = (kNbin + kThreads - 1) / kThreads;
      int hv[kLoads];           // every load in flight before the stores
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = tid + i * kThreads;
        hv[i] = k < kNbin ? h0[k] : 0;
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i)
        if (tid + i * kThreads < kNbin) h[tid + i * kThreads] = hv[i];
      __syncthreads();
    }
    // 3x3 smoothing (zero padding) and the first maximum
    int best = -1, bidx = INT_MAX;
    for (int k = tid; k < kNbin; k += kThreads) {
      const int rr = k / kNb, cc = k - rr * kNb;
      int s = 0;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc) {
          const int r2 = rr + dr, c2 = cc + dc;
          if (r2 >= 0 && r2 < kNb && c2 >= 0 && c2 < kNb)
            s += h[r2 * kNb + c2];
        }
      if (s > best) {   // k ascends: a thread keeps its first maximum
        best = s;
        bidx = k;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
      if (ov > best || (ov == best && oi < bidx)) {
        best = ov;
        bidx = oi;
      }
    }
    if (lane == 0) {
      sh.red_v[warp] = best;
      sh.red_i[warp] = bidx;
    }
    __syncthreads();
    best = sh.red_v[0];
    bidx = sh.red_i[0];
    for (int w = 1; w < kWarps; ++w)
      if (sh.red_v[w] > best || (sh.red_v[w] == best && sh.red_i[w] < bidx)) {
        best = sh.red_v[w];
        bidx = sh.red_i[w];
      }
    const bool any = best > 0;
    tx0 = any ? __fsub_rn(__fmul_rn((float)(bidx % kNb), p.step), p.bmax)
              : 0.0f;
    ty0 = any ? __fsub_rn(__fmul_rn((float)(bidx / kNb), p.step), p.bmax)
              : 0.0f;
    __syncthreads();
    if (tid == 0) {
      sh.T[3] = __fadd_rn(sh.T[3], tx0);
      sh.T[7] = __fadd_rn(sh.T[7], ty0);
      if (rank == 0) {
        p.txy[((size_t)b * p.rounds + r) * 2] = tx0;
        p.txy[((size_t)b * p.rounds + r) * 2 + 1] = ty0;
      }
    }
  }

  // -- the pick and the appearance gate, kThreads entries a pass -----------
  const int P2 = p.P2;
  for (int a0 = lo; a0 < hi; a0 += kThreads) {
    if (tid == 0) sh.n_gate = 0;
    __syncthreads();
    const int a = a0 + tid;
    if (a < hi) {   // the pair nearest the last peak
      float bd = 0.0f;
      int bc = 0;
      unsigned bcode = 0u;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const size_t e = (ab + a) * kC + c;
        const unsigned code = p.pair_code[e];
        const float ex = __fsub_rn(p.pair_t[2 * e], tx0);
        const float ey = __fsub_rn(p.pair_t[2 * e + 1], ty0);
        const float dd = (code & kVotes)
                             ? __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey))
                             : kHuge;
        if (c == 0 || before(dd, c, bd, bc)) {
          bd = dd;
          bc = c;
          bcode = code;
        }
      }
      const int j = (int)(bcode & ~kVotes);
      const float2 q = sdet[j];
      const bool in0 = base[a] && bd <= p.inl_r2;
      p.j1[ab + a] = j;
      p.uv1[2 * (ab + a)] = q.x;
      p.uv1[2 * (ab + a) + 1] = q.y;
      p.inl[ab + a] = in0 ? 1 : 0;
      if (in0) sh.gate[atomicAdd(&sh.n_gate, 1)] = a;   // any order
    }
    __syncthreads();
    // the gate of the pass's inliers, a thread an entry and shift
    const int ng = sh.n_gate;
    for (int g0 = 0; g0 < ng; g0 += kGateRows) {
      const int t = tid / kShifts, sft = tid - t * kShifts;
      if (t < kGateRows && g0 + t < ng) {
        const int ae = sh.gate[g0 + t];
        const float* q = p.det + ((size_t)sft * Q + p.j1[ab + ae]) * P2;
        const float* d = p.desc + (size_t)ae * P2;
        float sad = 0.0f, en = 0.0f;
        int k = 0;
        for (; k + 16 <= P2; k += 16) {   // 32 loads in flight, sums in order
          float qv[16], dv[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            qv[i] = q[k + i];
            dv[i] = d[k + i];
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            sad = __fadd_rn(sad, fabsf(__fsub_rn(qv[i], dv[i])));
            if (sft == 0) en = __fadd_rn(en, fabsf(dv[i]));
          }
        }
        for (; k < P2; ++k) {
          const float dk = d[k];
          sad = __fadd_rn(sad, fabsf(__fsub_rn(q[k], dk)));
          if (sft == 0) en = __fadd_rn(en, fabsf(dk));
        }
        sh.sad[tid] = sad;
        if (sft == 0) sh.energy[t] = en;
      }
      __syncthreads();
      if (tid < kGateRows && g0 + tid < ng) {
        const int ae = sh.gate[g0 + tid];
        float best = sh.sad[tid * kShifts];
        for (int s2 = 1; s2 < kShifts; ++s2) {   // a NaN propagates
          const float v = sh.sad[tid * kShifts + s2];
          if (v != v || v < best) best = v;
        }
        const float es = sh.energy[tid];
        const float energy = es < 1.0f ? 1.0f : es;   // NaN stays NaN
        if (best < __fmul_rn(energy, p.gate2)) {
          const int j = p.j1[ab + ae];
          atomicOr(&sbits[j >> 5], 1u << (j & 31));
        } else {
          p.inl[ab + ae] = 0;
        }
      }
      __syncthreads();
    }
  }

  // -- two Huber Gauss-Newton PnP solves on the same pairs ------------------
  // each thread's first entry stays in registers across the iterations
  const int am = lo + tid;
  float mX[3] = {0.0f, 0.0f, 0.0f}, muv[2] = {0.0f, 0.0f};
  bool minl = false;
  if (am < hi) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mX[i] = p.X[3 * am + i];
    muv[0] = p.uv1[2 * (ab + am)];
    muv[1] = p.uv1[2 * (ab + am) + 1];
    minl = p.inl[ab + am] != 0;
  }
  for (int g = 0; g < 2 * p.iters; ++g) {
    const float hub = g < p.iters ? p.huber1 : p.huber2;
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
    double acc[kTerms];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) acc[t] = 0.0;
    if (am < hi) normal_terms(T, in, mX, muv, minl, hub, acc);
    for (int a = am + kThreads; a < hi; a += kThreads) {
      const float X[3] = {p.X[3 * a], p.X[3 * a + 1], p.X[3 * a + 2]};
      const float uv[2] = {p.uv1[2 * (ab + a)], p.uv1[2 * (ab + a) + 1]};
      normal_terms(T, in, X, uv, p.inl[ab + a] != 0, hub, acc);
    }
    // the CTA's sums go to every rank, which adds them in rank order
    double (*recv)[kTerms] = sh.recv[g & 1];
    const double mine = block_terms(sh, acc, nw);
    if (tid < kTerms)
      for (int q = 0; q < csize; ++q)
        cluster.map_shared_rank(&recv[rank][tid], q)[0] = mine;
    cluster.sync();                       // every CTA's sums are in
    if (tid < kTerms) {
      double s = 0.0;
      for (int q = 0; q < csize; ++q) s += recv[q][tid];
      const float f = (float)s;
      if (tid < 21) {
        int i = 0, rem = tid;
        while (rem >= 6 - i) {
          rem -= 6 - i;
          ++i;
        }
        const int j = i + rem;
        const float hv = i == j ? __fadd_rn(f, 1e-4f) : f;
        sh.P[i * 7 + j] = hv;
        sh.P[j * 7 + i] = hv;
      } else {
        sh.b[tid - 21] = f;
      }
    }
    __syncthreads();
    if (warp == 0) {   // the 6x6 by one warp, then the pose step
      const bool ok =
          chol_solve_block<1, 6, 1, true>(sh.P, 7, sh.b, sh.rs, sh.x, 6);
      if (lane == 0) {
        const float nan = __int_as_float(0x7fc00000);
        float dp[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) dp[i] = ok ? sh.x[i] : nan;
        se3_exp_apply(dp, sh.T, sh.Tn);
#pragma unroll
        for (int i = 0; i < 16; ++i) sh.T[i] = sh.Tn[i];
      }
    }
    __syncthreads();
  }

  // -- the mean reprojection error and the distinct inlier detections -------
  {
    float T[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) T[i] = sh.T[i];
    double es = 0.0;
    int cnt = 0;
    for (int a = lo + tid; a < hi; a += kThreads) {
      if (!p.inl[ab + a]) continue;
      const float X[3] = {p.X[3 * a], p.X[3 * a + 1], p.X[3 * a + 2]};
      float xc[3], pr, pc;
      to_camera(T, X, xc);
      pinhole(xc, in, &pr, &pc);
      const float r0 = pr - p.uv1[2 * (ab + a)];
      const float r1 = pc - p.uv1[2 * (ab + a) + 1];
      es += (double)sqrtf(r0 * r0 + r1 * r1);
      ++cnt;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      es += __shfl_down_sync(0xffffffffu, es, off);
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    }
    if (lane == 0) {
      sh.warp_part[warp][0] = es;
      sh.red_i[warp] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      int c = 0;
      for (int w = 0; w < kWarps; ++w) {
        s += sh.warp_part[w][0];
        c += sh.red_i[w];
      }
      sh.err_part = s;
      sh.cnt_part = c;
    }
  }
  cluster.sync();                         // every CTA's sums and bits are in
  if (rank == 0) {
    int pop = 0;
    for (int w = tid; w < nwords; w += kThreads) {
      unsigned bits = 0u;
      for (int q = 0; q < csize; ++q)
        bits |= cluster.map_shared_rank(sbits, q)[w];
      pop += __popc(bits);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      pop += __shfl_down_sync(0xffffffffu, pop, off);
    if (lane == 0) sh.red_v[warp] = pop;
    if (tid < 16) p.T_out[(size_t)b * 16 + tid] = sh.T[tid];
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int w = 0; w < kWarps; ++w) n += sh.red_v[w];
      double s = 0.0;
      int c = 0;
      for (int q = 0; q < csize; ++q) {
        s += *cluster.map_shared_rank(&sh.err_part, q);
        c += *cluster.map_shared_rank(&sh.cnt_part, q);
      }
      p.n[b] = n;
      p.err[b] = __fdiv_rn((float)s, (float)(c > 1 ? c : 1));
    }
  }
  cluster.sync();   // no CTA leaves while rank 0 may still read its memory
}

}  // namespace

// One cluster launch of kCluster CTAs per match set. X (A, 3),
// desc (A, P2), det (9, Q, P2), T_prior (4, 4), intr (4) float32; base
// (B, A), valid (Q) bytes; pos (Q, 2) int32. Out: T (B, 4, 4), err (B),
// txy (B, rounds, 2), uv1 (B, A, 2) float32; n (B), j1 (B, A) int32; inl
// (B, A) bytes. Scratch: pair_code (B, A, 4) uint32, pair_t (B, A, 4, 2)
// float32.
extern "C" int vpp_map_vote_pnp(
    const float* X, const float* desc, const unsigned char* base,
    const int* pos, const unsigned char* valid, const float* det,
    const float* T_prior, const float* intr, int A, int Q, int B, int P2,
    int rounds, int iters, float r2, float bmax, float step, float inl_r2,
    float gate2, float huber1, float huber2, float* T_out, float* err, int* n,
    float* txy, int* j1, float* uv1, unsigned char* inl, unsigned* pair_code,
    float* pair_t, void* stream) {
  if (A < 1 || Q < 1 || Q > kMaxQ || B < 1 || B > 65535 || P2 < 1
      || rounds < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  // once, for the largest Q, so that no later call (one inside a CUDA
  // graph capture among them) sets an attribute
  static cudaError_t attr_err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        map_vote_pnp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn_bytes(kMaxQ));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        map_vote_pnp_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  }();
  if (attr_err != cudaSuccess) return (int)attr_err;
  Args p{X,      desc,  base,   pos,    valid, det,    T_prior, intr,
         A,      Q,     P2,     rounds, iters, r2,     bmax,    step,
         inl_r2, gate2, huber1, huber2, T_out, err,    n,       txy,
         j1,     uv1,   inl,    pair_code, pair_t};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dyn_bytes(Q);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, map_vote_pnp_kernel, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
