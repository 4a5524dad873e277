// K6 — window bundle adjustment on the ring layout: the landmark Schur
// assembly, its block-ordered reduction, and back-substitution with the
// candidate step's cost.
//
// Replaces vpp_tpu/slam/ba.py:_tracks_assemble (:453) with _inv3 (:46),
// _tracks_backsub (:558) and _tracks_cost (:445), ring layout
// (obs_pose[n, j] == j, K == M). On the TPU the per-landmark algebra was a
// chain of dense einsums over (N, K, 6, 3) tensors so that it rides the
// matrix unit. Here one block owns a tile of landmarks and keeps every
// intermediate in shared memory:
//   launch A (ba_assemble): per (landmark, observation) the residual, the
//     analytic Jacobians Jp (2x6) and Jl (2x3) of proj_jacobians (with its
//     |z| < 1e-6 -> 1e-6 clamp), the Huber weight and the obs_valid mask;
//     per landmark Hll, bl, seen, Hll + (lam + 1e-6) I (I where unseen), its
//     inverse (_inv3's scaled closed-form Cholesky, or a pivoted 3x3
//     Gauss-Jordan for linalg="lu"); per observation U = Jp_w^T Jl and
//     W = U Hll_inv. Hll_inv, bl, U and seen go to device memory for
//     launch C. Then each thread owns fixed entries of the block's partial
//     S (M,6,M,6: Hpp on the diagonal blocks minus sum W_k U_l^T), rhs
//     (bp minus sum W_k bl) and cost, and walks the block's landmarks in
//     order;
//   launch B (ba_reduce): one thread per entry sums the partials in block
//     order. No float atomics: the LM accept test compares two costs, so
//     they must be the same bits on every run;
//   launch C (ba_backsub_cost): per landmark dl = Hll_inv (bl - sum_k U_k^T
//     dp_k) (zero where unseen), the candidate X + dl, and its Huber cost
//     under the candidate poses, as per-block partials that launch B sums.
//
// Precision, as in the plain version (slam/ba.py): residuals and Jacobians
// in float32; each landmark's block algebra (Hll, its damped inverse, U, W,
// its Schur terms and back-substitution) in float64, and S, rhs and the
// costs summed in float64 and rounded to float32. A landmark seen once, or
// with little parallax, has a damped Hll past float32's range of condition
// numbers, where float32 Schur terms are rounding noise.
//
// Bound on the H100: at N = 1024, M = 6 about 4 M float64 multiply-adds for
// the Schur blocks (~0.24 us at 34 TFLOP/s) and 0.6 MB moved (~0.18 us):
// each launch sits at launch latency, far above either.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBacksubThreads = 128;

// shared memory of a block of L landmarks and M poses: float64 U, W (per
// observation), Hll_inv, bl (per landmark); float32 Jp, Jl, r, w
__host__ __device__ inline int smem_doubles(int L, int m) {
  return L * m * (18 + 18) + L * (9 + 3);
}
__host__ __device__ inline int smem_bytes(int L, int m) {
  return smem_doubles(L, m) * 8 + L * m * (12 + 6 + 2 + 1) * 4;
}

// _inv3: scaled closed-form Cholesky inverse of a damped SPD 3x3 matrix.
__device__ void inv3_chol(const double* A, double* out) {
  double s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = rsqrt(fmax(fabs(A[4 * i]), 1e-30));
  double a[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[3 * i + j] = A[3 * i + j] * s[i] * s[j];
  const double tiny = 1e-30;
  const double l11 = sqrt(fmax(a[0], tiny));
  const double il11 = 1.0 / l11;
  const double l21 = a[3] * il11;
  const double l31 = a[6] * il11;
  const double l22 = sqrt(fmax(a[4] - l21 * l21, tiny));
  const double il22 = 1.0 / l22;
  const double l32 = (a[7] - l31 * l21) * il22;
  const double l33 = sqrt(fmax(a[8] - l31 * l31 - l32 * l32, tiny));
  const double il33 = 1.0 / l33;
  const double m11 = il11;
  const double m21 = -l21 * il11 * il22;
  const double m31 = (l21 * l32 - l31 * l22) * il11 * il22 * il33;
  const double m22 = il22;
  const double m32 = -l32 * il22 * il33;
  const double m33 = il33;
  const double i11 = m11 * m11 + m21 * m21 + m31 * m31;
  const double i12 = m21 * m22 + m31 * m32;
  const double i13 = m31 * m33;
  const double i22 = m22 * m22 + m32 * m32;
  const double i23 = m32 * m33;
  const double i33 = m33 * m33;
  const double inv[9] = {i11, i12, i13, i12, i22, i23, i13, i23, i33};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = inv[3 * i + j] * s[i] * s[j];
}

// Pivoted Gauss-Jordan inverse of a 3x3 matrix; NaN where it is singular.
__device__ void inv3_lu(const double* A, double* out) {
  double a[3][6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = A[3 * i + j];
      a[i][3 + j] = i == j ? 1.0 : 0.0;
    }
  bool singular = false;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int p = c;
#pragma unroll
    for (int r = c + 1; r < 3; ++r)
      if (fabs(a[r][c]) > fabs(a[p][c])) p = r;
    if (a[p][c] == 0.0) singular = true;
    if (p != c) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const double t = a[c][j];
        a[c][j] = a[p][j];
        a[p][j] = t;
      }
    }
    const double ip = 1.0 / a[c][c];
#pragma unroll
    for (int j = 0; j < 6; ++j) a[c][j] *= ip;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r == c) continue;
      const double f = a[r][c];
#pragma unroll
      for (int j = 0; j < 6; ++j) a[r][j] -= f * a[c][j];
    }
  }
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = singular ? nan : a[i][3 + j];
}

__device__ __forceinline__ float huber_weight(float r0, float r1,
                                              float huber) {
  const float nrm = sqrtf(r0 * r0 + r1 * r1);
  return nrm <= huber ? 1.0f : huber / fmaxf(nrm, 1e-12f);
}

__global__ void __launch_bounds__(kThreads)
ba_assemble_kernel(const float* __restrict__ poses,
                   const float* __restrict__ lms,
                   const float* __restrict__ obs_uv,
                   const unsigned char* __restrict__ obs_valid,
                   const float* __restrict__ intr,
                   const float* __restrict__ lam_p, float huber, int n, int m,
                   int L, int use_lu, double* __restrict__ hinv_out,
                   double* __restrict__ bl_out, double* __restrict__ u_out,
                   unsigned char* __restrict__ seen_out,
                   double* __restrict__ partials) {
  extern __shared__ double smd[];
  const int LM = L * m;
  double* sU = smd;              // (L*M, 6, 3)
  double* sW = sU + LM * 18;     // (L*M, 6, 3)
  double* sHinv = sW + LM * 18;  // (L, 3, 3)
  double* sbl = sHinv + L * 9;   // (L, 3)
  float* sJp = (float*)(smd + smem_doubles(L, m));  // (L*M, 2, 6)
  float* sJl = sJp + LM * 12;    // (L*M, 2, 3)
  float* sr = sJl + LM * 6;      // (L*M, 2)
  float* sw = sr + LM * 2;       // (L*M)
  const int n0 = blockIdx.x * L;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const float lam = *lam_p;

  // 1a. residual, Jacobians and weight per observation
  for (int o = threadIdx.x; o < LM; o += blockDim.x) {
    const int gn = n0 + o / m, k = o % m;
    float Jp[12], Jl[6], r0 = 0.0f, r1 = 0.0f, wt = 0.0f;
#pragma unroll
    for (int i = 0; i < 12; ++i) Jp[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) Jl[i] = 0.0f;
    if (gn < n) {
      const float* T = poses + 16 * k;
      const float X0 = lms[3 * gn], X1 = lms[3 * gn + 1], X2 = lms[3 * gn + 2];
      const float p0 = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
      const float p1 = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
      const float p2 = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
      const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
      const float iz = 1.0f / z;
      const float u = fx * p0 * iz + cx;
      const float v = fy * p1 * iz + cy;
      const size_t ob = (size_t)gn * m + k;
      r0 = v - obs_uv[2 * ob];
      r1 = u - obs_uv[2 * ob + 1];
      wt = obs_valid[ob] ? huber_weight(r0, r1, huber) : 0.0f;
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
          for (int j = 0; j < 3; ++j) H[3 * i + j] += jw * sJl[6 * o + 3 * rr + j];
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
    if (use_lu) inv3_lu(H, Hi); else inv3_chol(H, Hi);
#pragma unroll
    for (int i = 0; i < 9; ++i) sHinv[9 * nl + i] = Hi[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sbl[3 * nl + i] = b[i];
    const int gn = n0 + nl;
    if (gn < n) {
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
    const int nl = o / m, gn = n0 + nl;
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
    if (gn < n) {
#pragma unroll
      for (int i = 0; i < 18; ++i) u_out[18 * ((size_t)gn * m + o % m) + i] = U[i];
    }
  }
  __syncthreads();

  // 2. the block's partial S, rhs and cost; each thread owns fixed entries
  const int ns = m * m * 36, nr = m * 6, P = ns + nr + 1;
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    double acc = 0.0;
    if (e < ns) {
      const int k = e / (36 * m), rem = e % (36 * m);
      const int i = rem / (6 * m), rem2 = rem % (6 * m);
      const int l = rem2 / 6, q = rem2 % 6;
      if (k == l) {
        for (int nl = 0; nl < L; ++nl) {
          const int o = nl * m + k;
          const double wt = sw[o];
          acc += (double)sJp[12 * o + i] * wt * sJp[12 * o + q]
                 + (double)sJp[12 * o + 6 + i] * wt * sJp[12 * o + 6 + q];
        }
      }
      for (int nl = 0; nl < L; ++nl) {
        const double* Wk = sW + 18 * (nl * m + k) + 3 * i;
        const double* Ul = sU + 18 * (nl * m + l) + 3 * q;
        acc -= Wk[0] * Ul[0] + Wk[1] * Ul[1] + Wk[2] * Ul[2];
      }
    } else if (e < ns + nr) {
      const int k = (e - ns) / 6, i = (e - ns) % 6;
      for (int nl = 0; nl < L; ++nl) {
        const int o = nl * m + k;
        const double wt = sw[o];
        acc -= (double)sJp[12 * o + i] * wt * sr[2 * o]
               + (double)sJp[12 * o + 6 + i] * wt * sr[2 * o + 1];
      }
      for (int nl = 0; nl < L; ++nl) {
        const double* Wk = sW + 18 * (nl * m + k) + 3 * i;
        const double* b = sbl + 3 * nl;
        acc -= Wk[0] * b[0] + Wk[1] * b[1] + Wk[2] * b[2];
      }
    } else {
      for (int o = 0; o < LM; ++o)  // float32 per observation, as the plain
        acc += sw[o] * (sr[2 * o] * sr[2 * o] + sr[2 * o + 1] * sr[2 * o + 1]);
    }
    partials[(size_t)blockIdx.x * P + e] = acc;
  }
}

__global__ void ba_reduce_kernel(const double* __restrict__ partials,
                                 int nblocks, int p, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p) return;
  double acc = 0.0;
  for (int b = 0; b < nblocks; ++b) acc += partials[(size_t)b * p + e];
  out[e] = (float)acc;
}

__global__ void __launch_bounds__(kBacksubThreads)
ba_backsub_cost_kernel(const float* __restrict__ cand_poses,
                       const float* __restrict__ lms,
                       const float* __restrict__ obs_uv,
                       const unsigned char* __restrict__ obs_valid,
                       const float* __restrict__ intr, float huber,
                       const double* __restrict__ hinv,
                       const double* __restrict__ bl,
                       const double* __restrict__ U,
                       const unsigned char* __restrict__ seen,
                       const float* __restrict__ dp, int n, int m,
                       float* __restrict__ cand_lms,
                       double* __restrict__ partials) {
  __shared__ double sc[kBacksubThreads];
  const int gn = blockIdx.x * blockDim.x + threadIdx.x;
  double cost = 0.0;
  if (gn < n) {
    float X[3] = {lms[3 * gn], lms[3 * gn + 1], lms[3 * gn + 2]};
    if (seen[gn]) {
      double udp[3] = {0.0, 0.0, 0.0};
      for (int k = 0; k < m; ++k) {
        const double* Uk = U + 18 * ((size_t)gn * m + k);
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const double d = dp[6 * k + i];
#pragma unroll
          for (int j = 0; j < 3; ++j) udp[j] += Uk[3 * i + j] * d;
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
    const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
    for (int k = 0; k < m; ++k) {
      const size_t ob = (size_t)gn * m + k;
      if (!obs_valid[ob]) continue;
      const float* T = cand_poses + 16 * k;
      const float p0 = T[0] * X[0] + T[1] * X[1] + T[2] * X[2] + T[3];
      const float p1 = T[4] * X[0] + T[5] * X[1] + T[6] * X[2] + T[7];
      const float p2 = T[8] * X[0] + T[9] * X[1] + T[10] * X[2] + T[11];
      const float z = fabsf(p2) < 1e-6f ? 1e-6f : p2;
      const float r0 = fy * p1 / z + cy - obs_uv[2 * ob];
      const float r1 = fx * p0 / z + cx - obs_uv[2 * ob + 1];
      cost += huber_weight(r0, r1, huber) * (r0 * r0 + r1 * r1);
    }
  }
  sc[threadIdx.x] = cost;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int t = 0; t < kBacksubThreads; ++t) s += sc[t];
    partials[blockIdx.x] = s;
  }
}

}  // namespace

// Launch A. poses (m, 4, 4), lms (n, 3), obs_uv (n, m, 2) float32; obs_valid
// (n, m) bytes; intr (4); lam (1) float32 on the device. Out: hinv (n, 3, 3),
// bl (n, 3), U (n, m, 6, 3) float64, seen (n) bytes, partials
// (ceil(n / L), m*m*36 + m*6 + 1) float64.
extern "C" int vpp_ba_assemble(const float* poses, const float* lms,
                               const float* obs_uv,
                               const unsigned char* obs_valid,
                               const float* intr, const float* lam,
                               float huber, int n, int m, int L, int use_lu,
                               double* hinv, double* bl, double* U,
                               unsigned char* seen, double* partials,
                               void* stream) {
  const int blocks = (n + L - 1) / L;
  if (blocks == 0) return 0;
  const int smem = smem_bytes(L, m);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ba_assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  ba_assemble_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      poses, lms, obs_uv, obs_valid, intr, lam, huber, n, m, L, use_lu, hinv,
      bl, U, seen, partials);
  return (int)cudaGetLastError();
}

// Launch B: out[e] = sum over b of float64 partials[b, e], in block order,
// rounded to float32.
extern "C" int vpp_ba_reduce(const double* partials, int nblocks, int p,
                             float* out, void* stream) {
  const int threads = 256;
  ba_reduce_kernel<<<(p + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(partials, nblocks, p, out);
  return (int)cudaGetLastError();
}

// Launch C. cand_poses (m, 4, 4); dp (m, 6) float32; the float64
// landmark-local arrays of launch A. Out: cand_lms (n, 3) float32, partials
// (ceil(n / 128)) float64.
extern "C" int vpp_ba_backsub_cost(const float* cand_poses, const float* lms,
                                   const float* obs_uv,
                                   const unsigned char* obs_valid,
                                   const float* intr, float huber,
                                   const double* hinv, const double* bl,
                                   const double* U, const unsigned char* seen,
                                   const float* dp, int n, int m,
                                   float* cand_lms, double* partials,
                                   void* stream) {
  const int blocks = (n + kBacksubThreads - 1) / kBacksubThreads;
  if (blocks == 0) return 0;
  ba_backsub_cost_kernel<<<blocks, kBacksubThreads, 0,
                           (cudaStream_t)stream>>>(
      cand_poses, lms, obs_uv, obs_valid, intr, huber, hinv, bl, U, seen, dp,
      n, m, cand_lms, partials);
  return (int)cudaGetLastError();
}

// Landmarks a block of launch C takes (one thread each).
extern "C" int vpp_ba_backsub_threads(void) { return kBacksubThreads; }
