// Pose math shared by the hand kernels that solve for camera poses: K6
// (ba_tracks.cu, the window BA), K8 (map_vote.cu, the map-vote PnP) and
// K9 (ba_generic.cu, the generic-layout BA). One copy, included by all
// three: the Huber weight of a 2-D residual, a float32 Cholesky solve by a
// whole block or by one warp, the float64 3x3 landmark inverses of
// ba.py's linalg="chol" and "lu", and se3_exp(xi) @ T with slam/se3.py's
// small-angle branches.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float huber_weight(float r0, float r1,
                                              float huber) {
  const float nrm = sqrtf(r0 * r0 + r1 * r1);
  return nrm <= huber ? 1.0f : huber / fmaxf(nrm, 1e-12f);
}

// The owner lane's value of row k, where a lane keeps rows lane + 32 s.
__device__ __forceinline__ float row_of(const float (&v)[3], int k) {
  const int s = k >> 5;
  const float mine = s == 0 ? v[0] : (s == 1 ? v[1] : v[2]);
  return __shfl_sync(0xffffffffu, mine, k & 31);
}

// float32 Cholesky of the D x D matrix P (row stride ld) and the solution
// x of P x = b, by the whole block of kWarps warps (kOneWarp: by warp 0
// alone, kWarps = 1, with warp barriers): right-looking, one barrier a
// column. At column k the warps update the rows of the trailing lower
// triangle, and b (the forward substitution), by l_ik l_jk with
// l_ik = P[i][k] / sqrt(P[k][k]); column k itself is left unscaled and
// its scale kept in `rs`. Then warp 0 substitutes backwards
// in registers (lane owns rows lane, lane + 32, lane + 64; D <= 96). False
// (uniformly) where a pivot is not positive, as LAPACK's potrf reports it.
template <int kWarps, int kRows, int kCols, bool kOneWarp = false>
__device__ bool chol_solve_block(float* P, int ld, float* b, float* rs,
                                 float* x, int D) {
  static_assert(!kOneWarp || kWarps == 1, "one warp is kWarps = 1");
  // warp w updates rows w + kWarps r (r < kRows), its lanes columns
  // lane + 32 c (c < kCols): every operand of a column step is loaded
  // before the first store, so the loads of a thread overlap
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int k = 0; k < D; ++k) {
    const float p = P[k * ld + k];
    if (!(p > 0.0f)) return false;
    const float il = 1.0f / sqrtf(p);
    const float yk = b[k] * il;
    float lc[kCols], lr[kRows], v[kRows][kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = lane + 32 * c;
      lc[c] = (j > k && j < D) ? P[j * ld + k] * il : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = wid + kWarps * r;
      lr[r] = (i > k && i < D) ? P[i * ld + k] * il : 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = lane + 32 * c;
        v[r][c] = (i > k && i < D && j > k && j <= i) ? P[i * ld + j] : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = wid + kWarps * r;
      if (!(i > k && i < D)) continue;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = lane + 32 * c;
        if (j > k && j <= i) P[i * ld + j] = v[r][c] - lr[r] * lc[c];
      }
      if (lane == 0) b[i] -= lr[r] * yk;
    }
    if (threadIdx.x == 0) {
      rs[k] = il;
      x[k] = yk;                            // y, until the back substitution
    }
    if (kOneWarp) __syncwarp(); else __syncthreads();
  }
  if (threadIdx.x < 32) {                   // L^T x = y
    float y[3], ri[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int i = lane + 32 * s;
      y[s] = i < D ? x[i] : 0.0f;
      ri[s] = i < D ? rs[i] : 0.0f;
    }
    __syncwarp();
    for (int j = D - 1; j >= 0; --j) {
      const float xj = row_of(y, j) * rs[j];
      if (lane == (j & 31)) x[j] = xj;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int i = lane + 32 * s;
        if (i < j) y[s] -= (P[j * ld + i] * ri[s]) * xj;
      }
    }
  }
  if (kOneWarp) __syncwarp(); else __syncthreads();
  return true;
}

// _inv3: scaled closed-form Cholesky inverse of a damped SPD 3x3 matrix.
__device__ inline void inv3_chol(const double* A, double* out) {
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
__device__ inline void inv3_lu(const double* A, double* out) {
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

// se3_exp(xi) @ T in float32, with se3.py's small-angle branches.
__device__ inline void se3_exp_apply(const float* xi, const float* T,
                                     float* out) {
  const float w0 = xi[0], w1 = xi[1], w2 = xi[2];
  const float v0 = xi[3], v1 = xi[4], v2 = xi[5];
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = t2 < 1e-8f;
  const float t2s = small ? 1.0f : t2;
  const float th = sqrtf(t2s);
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.0f - t2 / 6.0f : sn / th;
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cs) / t2s;
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f : (th - sn) / (t2s * th);
  const float K[9] = {0.0f, -w2, w1, w2, 0.0f, -w0, -w1, w0, 0.0f};
  float KK[9], R[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j]
                      + K[3 * i + 2] * K[6 + j];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.0f : 0.0f;
    R[i] = e + a * K[i] + b * KK[i];
    V[i] = e + b * K[i] + c * KK[i];
  }
  float E[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) E[4 * i + j] = R[3 * i + j];
    E[4 * i + 3] = V[3 * i] * v0 + V[3 * i + 1] * v1 + V[3 * i + 2] * v2;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j]
                       + E[4 * i + 2] * T[8 + j] + E[4 * i + 3] * T[12 + j];
  // the row (0, 0, 0, 1) times T, as the matrix product takes it: T's
  // last row where T is finite, NaN where a column of T holds one
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[12 + j] = 0.0f * T[j] + 0.0f * T[4 + j] + 0.0f * T[8 + j] + T[12 + j];
}

}  // namespace
