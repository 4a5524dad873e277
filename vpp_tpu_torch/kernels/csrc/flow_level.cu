// K1 — one pyramid level of semi-dense optical flow.
//
// Replaces vpp_tpu/algorithms/flow.py:_flow_level_xla (:224) with
// _warp_by_cell_flow (:102), _cost_volume (:156) and _volume_lookup (:196).
// The JAX package builds the level from masked-roll warps, a stack of
// shifted bf16 |diff| slices and 0/1 banded matmuls that ride the TPU's
// matrix unit; none of that carries over. Here each cost is summed where
// it is needed.
//
// What it computes, per grid cell (gy, gx) and displacement k of the
// displacement table (smallest first, flow.py:_displacement_table):
//   cost[k] = sum over the ws x ws window at (r0 + gy*patch, r0 + gx*patch)
//             of bf16(|bf16(a1[y, x]) - bf16(a2w[y + dr_k, x + dc_k])|),
//             summed in float32, coordinates clamped to the buffer (the JAX
//             edge padding), where a2w is a2 backward-warped by the clipped
//             per-cell prediction: the column shift first, then the row
//             shift read at the shifted column, both wrapping like jnp.roll;
//   best    = first k of minimum cost (strict <), flow = pred + d_best,
//   and the in-domain rejection of the matched window centre.
// It writes flow (gh, gw, 2) int32, dist (gh, gw) float32 and the volume
// (D^2, gh, gw) float32 that the propagation passes read.
//
// Bound on the H100: at the tracker's finest level (640x480, border 9) the
// kernel must read the two float32 level buffers once, 2.6 MB, ~0.8 us at
// 3.35 TB/s; the coarsest level (R = 5, 121 displacements) is bound by its
// ~32 M float operations instead. Both are far below the launch cost.
//
// Design: one block per cell, one thread per displacement (D^2 rounded up
// to a warp), so the top level's 121-way search and the finer levels' 9-way
// refinements both fill a block; the window's a1 reads are common to the
// block and hit L1. Thread 0 takes the ordered argmin from shared memory,
// which reproduces the first-minimum tie-break exactly. The Jacobi
// propagation is a second kernel, one thread per cell, run prop_iters times
// on double buffers by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kMaxD2 = 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int wrap(int v, int n) {
  int m = v % n;
  return m < 0 ? m + n : m;
}

struct LevelGeom {
  int hb, wb, b, h, w;
  int patch, gh, gw, ph, pw;  // ph/pw: pixel extent of the cell repeat
  int pred_bound;
};

// a2 backward-warped by the clipped per-cell prediction, read at buffer
// pixel (y, x). Mirrors flow.py:_warp_by_cell_flow: the row pass, then the
// column pass over the row-warped buffer, each a select over even shifts k
// in [-pred_bound, pred_bound], k != 0, rolled with wrap-around.
__device__ __forceinline__ float warped(const float* __restrict__ a2,
                                       const int* __restrict__ pred,
                                       const LevelGeom& g, int y, int x) {
  if (g.pred_bound == 0) return a2[(size_t)y * g.wb + x];
  const int pb = g.pred_bound;
  const int cy = clampi(y - g.b, 0, g.ph - 1) / g.patch;
  const int cx = clampi(x - g.b, 0, g.pw - 1) / g.patch;
  const int s1 = clampi(pred[(cy * g.gw + cx) * 2 + 1], -pb, pb);
  int x1 = x;
  if (s1 != 0 && ((s1 + pb) & 1) == 0) x1 = wrap(x + s1, g.wb);
  const int cx1 = clampi(x1 - g.b, 0, g.pw - 1) / g.patch;
  const int s0 = clampi(pred[(cy * g.gw + cx1) * 2 + 0], -pb, pb);
  int y1 = y;
  if (s0 != 0 && ((s0 + pb) & 1) == 0) y1 = wrap(y + s0, g.hb);
  return a2[(size_t)y1 * g.wb + x1];
}

__global__ void flow_level_kernel(const float* __restrict__ a1,
                                  const float* __restrict__ a2,
                                  const int* __restrict__ pred,
                                  const int* __restrict__ disp, int d2,
                                  LevelGeom g, int ws, int r0,
                                  int* __restrict__ flow,
                                  float* __restrict__ dist,
                                  float* __restrict__ vol) {
  __shared__ float s_cost[kMaxD2];
  const int gx = blockIdx.x, gy = blockIdx.y;
  const int cell = gy * g.gw + gx;
  const int ncell = g.gh * g.gw;
  const int k = threadIdx.x;
  if (k < d2) {
    const int dr = disp[2 * k], dc = disp[2 * k + 1];
    const int y0 = r0 + gy * g.patch, x0 = r0 + gx * g.patch;
    float sad = 0.0f;
    for (int i = 0; i < ws; ++i) {
      const int ya = clampi(y0 + i, 0, g.hb - 1);
      const int yb = clampi(y0 + i + dr, 0, g.hb - 1);
      for (int j = 0; j < ws; ++j) {
        const int xa = clampi(x0 + j, 0, g.wb - 1);
        const int xb = clampi(x0 + j + dc, 0, g.wb - 1);
        const float va = bf16_round(a1[(size_t)ya * g.wb + xa]);
        const float vb = bf16_round(warped(a2, pred, g, yb, xb));
        sad += bf16_round(fabsf(va - vb));
      }
    }
    s_cost[k] = sad;
    vol[(size_t)k * ncell + cell] = sad;
  }
  __syncthreads();
  if (k != 0) return;
  int best = 0;
  float bv = s_cost[0];
  for (int q = 1; q < d2; ++q) {
    if (s_cost[q] < bv) {
      bv = s_cost[q];
      best = q;
    }
  }
  const int p0 = pred[cell * 2], p1 = pred[cell * 2 + 1];
  const int f0 = p0 + disp[2 * best], f1 = p1 + disp[2 * best + 1];
  const int tr = gy * g.patch + g.patch / 2 + f0;
  const int tc = gx * g.patch + g.patch / 2 + f1;
  const bool in_dom = tr >= 0 && tr <= g.h - 1 && tc >= 0 && tc <= g.w - 1;
  flow[cell * 2] = in_dom ? f0 : p0;
  flow[cell * 2 + 1] = in_dom ? f1 : p1;
  dist[cell] = in_dom ? bv : kInf;
}

// One Jacobi pass (flow.py:271-284): every cell scores its 8 neighbours'
// current flows against its own volume, in _C8 order, adopting a strictly
// better one that differs by more than 2 px.
__global__ void flow_propagate_kernel(const int* __restrict__ flow_in,
                                      const float* __restrict__ dist_in,
                                      const int* __restrict__ pred,
                                      const float* __restrict__ vol,
                                      const int* __restrict__ flat_to_k,
                                      int gh, int gw, int R,
                                      int* __restrict__ flow_out,
                                      float* __restrict__ dist_out) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  const int ncell = gh * gw;
  if (cell >= ncell) return;
  const int gy = cell / gw, gx = cell % gw;
  const int dd = 2 * R + 1;
  const int f0 = flow_in[cell * 2], f1 = flow_in[cell * 2 + 1];
  const int p0 = pred[cell * 2], p1 = pred[cell * 2 + 1];
  int b0 = f0, b1 = f1;
  float bd = dist_in[cell];
  const int c8r[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int c8c[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int ry = gy + c8r[n], rx = gx + c8c[n];
    const bool inside = ry >= 0 && ry < gh && rx >= 0 && rx < gw;
    const int nc = wrap(ry, gh) * gw + wrap(rx, gw);
    const int n0 = flow_in[nc * 2], n1 = flow_in[nc * 2 + 1];
    const int q0 = n0 - p0, q1 = n1 - p1;
    float cand = kInf;
    if (q0 >= -R && q0 <= R && q1 >= -R && q1 <= R)
      cand = vol[(size_t)flat_to_k[(q0 + R) * dd + (q1 + R)] * ncell + cell];
    const int e0 = f0 - n0, e1 = f1 - n1;
    const bool far = e0 * e0 + e1 * e1 > 4;
    if (inside && far && cand < bd) {
      b0 = n0;
      b1 = n1;
      bd = cand;
    }
  }
  flow_out[cell * 2] = b0;
  flow_out[cell * 2 + 1] = b1;
  dist_out[cell] = bd;
}

}  // namespace

// a1, a2: hb x wb float32 level buffers with border b around an h x w
// domain; pred, flow: gh x gw x 2 int32; disp: d2 x 2 int32 displacement
// table; dist: gh x gw float32; vol: d2 x gh x gw float32.
extern "C" int vpp_flow_level(const float* a1, const float* a2,
                              const int* pred, const int* disp, int d2,
                              int hb, int wb, int b, int h, int w, int ws,
                              int patch, int gh, int gw, int pred_bound,
                              int* flow, float* dist, float* vol,
                              void* stream) {
  if (gh <= 0 || gw <= 0) return 0;
  if (d2 <= 0 || d2 > kMaxD2) return (int)cudaErrorInvalidValue;
  LevelGeom g;
  g.hb = hb;
  g.wb = wb;
  g.b = b;
  g.h = h;
  g.w = w;
  g.patch = patch;
  g.gh = gh;
  g.gw = gw;
  g.ph = h < gh * patch ? h : gh * patch;
  g.pw = w < gw * patch ? w : gw * patch;
  g.pred_bound = pred_bound;
  const int r0 = b - (ws / 2 - patch / 2);
  const int threads = (d2 + 31) / 32 * 32;
  dim3 grid(gw, gh);
  flow_level_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      a1, a2, pred, disp, d2, g, ws, r0, flow, dist, vol);
  return (int)cudaGetLastError();
}

// flat_to_k: (2R+1)^2 int32, row-major displacement id -> volume index.
extern "C" int vpp_flow_propagate(const int* flow_in, const float* dist_in,
                                  const int* pred, const float* vol,
                                  const int* flat_to_k, int gh, int gw,
                                  int R, int* flow_out, float* dist_out,
                                  void* stream) {
  const int ncell = gh * gw;
  if (ncell <= 0) return 0;
  const int threads = 128;
  flow_propagate_kernel<<<(ncell + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
      flow_in, dist_in, pred, vol, flat_to_k, gh, gw, R, flow_out, dist_out);
  return (int)cudaGetLastError();
}
