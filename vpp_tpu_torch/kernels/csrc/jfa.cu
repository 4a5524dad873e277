// K11 — the jump-flooding Euclidean distance transform in one cooperative
// launch: the seed init from the bool mask, every pass as tile-local
// replays of its 8 neighbour steps in shared memory, one grid barrier
// between passes, and the squared distance and the vectors as the last
// pass's epilogue. Asked for one pass, it is that pass from two planes to
// two planes, with no barrier.
//
// Replaces vpp_tpu/algorithms/distance_transform.py:jfa_pass (:209) and its
// loop in euclidean_distance_transform (:185). The JAX pass is 8 whole-image
// steps, not one read of 8 neighbours: each step rolls the closest-seed
// planes *as the previous step left them* by one neighbour offset (dr, dc)
// in {-s, 0, s}^2 \ (0, 0), and every pixel takes the rolled coordinates
// where they are strictly closer. XLA fused each step into a few
// whole-image operations on the TPU.
//
// Bound on the H100, for the transform from the mask: operations, 44 a
// pixel a pass (8 steps of 2 products, a sum and a compare, and 12 shifts
// of a displacement; 960x540: 2.5e8, ~3.7 us at 67 TFLOP/s), above its
// device-memory bytes (the mask read, the distance and vectors written: 13
// a pixel, 6.7 MB, ~2.0 us at 3.35 TB/s; the scratch planes between passes
// stay in the 50 MB L2). One pass asked alone also reads two int32 planes
// and writes two. What holds this design above the bound is a tile's
// latency: one or two tiles a CTA a pass at 960x540, each its decode,
// loads, 8 steps between block barriers and stores in sequence (PERF.md).
//
// Design. After the pass at stride s, pixel (r, c) depends only on the 7x7
// lattice {(r + i s, c + j s) : i, j in [-3, 3]}: the step offsets' row
// parts are -s three times, 0 twice and +s three times, and so are the
// column parts. So the pixels split into residue classes (r mod s, c mod s)
// that never meet, each a stride-1 problem on its lattice, and a CTA
// replays a pass on a tile of lattice points with a halo of 3 lattice
// points on each side (clamped to the image) in shared memory: a tile
// point's result reads only region points whose own reads stayed inside
// the region (each step moves a dependency by at most one lattice point),
// so what a halo point computes from a neighbour outside the region (no
// candidate) never reaches the tile. A tile covers Lr consecutive row
// residues x Tr lattice rows by Lc consecutive column residues x Tc lattice
// columns (Lr, Lc powers of two, so the shared layout decodes by shifts);
// where the residues fill the stride the runs abut and the tile is a
// contiguous block. The wrapper (distance_transform.py:_jfa_plan) chooses
// the four numbers a pass from a cost model (halo overhead, load sectors,
// waves of tiles over the CTA slots). Each point's state stays in its
// thread's registers through the 8 steps (a thread owns region points tid
// + 256 k, k < 8); a step reads every neighbour from shared memory with
// no test (the layout below), and between two block barriers the points
// that took their neighbour write back. Every load of a tile is issued
// before any is used.
//
// State as displacements. A point holds its closest seed as the float32
// displacement (seed - position) and its squared distance d. The neighbour
// at (r - dr, c - dc) holds seed - (r - dr, c - dc), so the candidate's
// displacement from (r, c) is the neighbour's minus (dr, dc), the same for
// every point of the step: no point needs its own position. Between the
// passes of a transform the state goes through two scratch planes of
// float2 displacements, so only the first pass (the mask) and the last
// (distance and vectors) convert anything. "None" is the displacement
// (-inf, y): it stays -inf under any shift and its squared distance is
// +inf, never taken. The JAX loop gives a neighbour outside the image, or
// "none", the distance 1e9, which is never taken either where every real
// distance is below 1e9: the wrapper refuses images whose diagonal squared
// reaches 1e9 (there the JAX loop takes a wrapped-around neighbour), and
// below it every displacement and shifted displacement is an integer below
// 2^24, exact in float32, and equals the float32 of the int32 difference
// the JAX package converts.
//
// Bits. The JAX package's order: neighbours dr over (-s, 0, s), then dc,
// (0, 0) skipped; the neighbour (dr, dc) of (r, c) is the pixel (r - dr,
// c - dc) (jnp.roll's direction), no candidate outside the image; "none"
// is -(1 << 20) with distance 1e9; a neighbour is taken where its distance
// is strictly smaller. The JAX loop carries d = min(d, nd), which always
// equals the distance of the coordinates it keeps. Each distance is the
// same float32 products and sum (__fmul_rn, __fadd_rn), so the transform
// and every pass equal the plain version and the JAX package bit for bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNone = -(1 << 20);
constexpr float kInf = 1e9f;
// The tile shape: 256 threads a CTA, 2 CTAs an SM, 8 region points a
// thread. vpp_jfa_shape reports it to the wrapper's plan.
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 2;
constexpr int kPer = 8;                        // region points a thread
constexpr int kRegion = kThreads * kPer;       // a tile's region points
constexpr int kPadded = 2 * kRegion;           // with its ring
constexpr int kSmem = kPadded * 8;             // float2 each
constexpr int kMaxPasses = 40;
constexpr int kMaxDevices = 64;
constexpr int kHalo = 3;

struct Pass {
  int s;                 // stride
  int lg_lr, tr;         // log2 of the row residues a tile, lattice rows
  int lg_lc, tc;         // log2 of the column residues a tile, lattice cols
};

struct Plan {
  int n;                 // passes
  Pass p[kMaxPasses];
};

// A tile's region: lattice rows [i_lo, i_lo + rr) of the row residues
// [r0, r0 + Lr), lattice columns [j_lo, j_lo + rc) of the column residues
// [c0, c0 + Lc); the tile's own lattice rows start at i_t, columns at j_t.
struct Region {
  int r0, i_lo, rr, i_t, i_e;
  int c0, j_lo, rc, j_t, j_e;
  int lr, lc, wl, points;
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// tiles along one axis: residue blocks x lattice blocks
__device__ __forceinline__ void axis_counts(int n, int s, int l, int t,
                                            int& nres, int& nlat) {
  nres = cdiv(min(s, n), l);
  nlat = cdiv(cdiv(n, s), t);
}

// the region of residue block k, lattice block b along one axis; false if
// the block holds no lattice point
__device__ __forceinline__ bool axis_region(int n, int s, int l, int t, int k,
                                            int b, int& r0, int& lo,
                                            int& len, int& t0, int& t1) {
  r0 = k * l;
  const int e = cdiv(n - r0, s);     // lattice extent of the block's first
  t0 = b * t;                        // residue (the largest)
  if (t0 >= e) return false;
  t1 = min(t0 + t, e);
  lo = max(t0 - kHalo, 0);
  len = min(t1 + kHalo, e) - lo;
  return true;
}

__device__ __forceinline__ float dist2(float x, float y) {
  return __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
}

// Walks a thread's region points in order: (lr, lc) of point tid + kThreads k.
struct Walker {
  int lr, lc, q, rem, wl;
  __device__ __forceinline__ Walker(int wl_) : wl(wl_) {
    lr = threadIdx.x / wl;
    lc = threadIdx.x - lr * wl;
    q = kThreads / wl;
    rem = kThreads - q * wl;
  }
  __device__ __forceinline__ void next() {
    lc += rem;
    lr += q;
    if (lc >= wl) {
      lc -= wl;
      ++lr;
    }
  }
};

// global (r, c) of local (lr, lc); false outside the image
__device__ __forceinline__ bool position(const Region& R, const Pass& P,
                                         int h, int w, int lr, int lc, int& r,
                                         int& c, int& ir, int& jc) {
  ir = lr >> P.lg_lr;
  jc = lc >> P.lg_lc;
  const int ra = R.r0 + (lr & (R.lr - 1));
  const int cb = R.c0 + (lc & (R.lc - 1));
  r = ra + (R.i_lo + ir) * P.s;
  c = cb + (R.j_lo + jc) * P.s;
  return ra < P.s && cb < P.s && r < h && c < w;
}

// What a pass reads and writes: the caller's planes of seed coordinates
// (kNone where none), the bool mask, a scratch plane of float2
// displacements (-inf where none; between the passes of a transform, so
// nothing is converted there), or the squared distance and the vectors.
struct Io {
  const uint8_t* mask;
  const int *in_r, *in_c;
  const float2* in_d;
  int *out_r, *out_c;
  float2* out_d;
  float* dist;
  int* vec;
};

// One pass over every tile this CTA owns. A scratch plane a pass reads was
// written by the pass before, in this launch, so it is read through L2
// (__ldcg), never from a stale L1 line.
//
// Shared layout: the region, row-major, inside a ring of one lattice point
// (Lr rows, Lc columns) that holds "none". So every point reads its 8
// neighbours with no test: a neighbour outside the image or the region
// is "none", whose distance is +inf and never taken, which is what the JAX
// loop does with it as long as every real distance is below its 1e9 (the
// wrapper's bound on the image). A point outside the image has distance
// -inf, so it never changes and stays "none".
__device__ void run_pass(const Pass& P, int h, int w, const Io& io,
                         float2* sm) {
  const float2 none = make_float2(-CUDART_INF_F, 0.f);
  int nrr, nlr, nrc, nlc;
  axis_counts(h, P.s, 1 << P.lg_lr, P.tr, nrr, nlr);
  axis_counts(w, P.s, 1 << P.lg_lc, P.tc, nrc, nlc);
  const int tiles = nrr * nlr * nrc * nlc;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int u = t;
    const int jb = u % nlc;
    u /= nlc;
    const int kc = u % nrc;
    u /= nrc;
    const int ib = u % nlr;
    const int kr = u / nlr;
    Region R;
    R.lr = 1 << P.lg_lr;
    R.lc = 1 << P.lg_lc;
    if (!axis_region(h, P.s, R.lr, P.tr, kr, ib, R.r0, R.i_lo, R.rr, R.i_t,
                     R.i_e) ||
        !axis_region(w, P.s, R.lc, P.tc, kc, jb, R.c0, R.j_lo, R.rc, R.j_t,
                     R.j_e))
      continue;                                  // uniform across the CTA
    R.wl = R.rc * R.lc;
    R.points = R.rr * R.lr * R.wl;
    const int wp = R.wl + 2 * R.lc;              // a padded row
    const int ring = R.lr * wp;                  // the top (bottom) ring
    const int mid = (R.rr + 1) * ring;           // the bottom ring's start
    __syncthreads();                             // the last tile's reads

    // the ring: top and bottom bands, then the side columns of the rest
    for (int i = threadIdx.x; i < 2 * ring; i += kThreads) {
      const int at = i < ring ? i : mid + i - ring;
      sm[at] = none;
    }
    for (int i = threadIdx.x; i < 2 * R.lc * R.rr * R.lr; i += kThreads) {
      const int row = R.lr + (i >> (P.lg_lc + 1));
      const int col = i & (2 * R.lc - 1);
      const int at = row * wp + (col < R.lc ? col : col + R.wl);
      sm[at] = none;
    }

    // positions, then every load in flight, then the state
    int at[kPer], sidx[kPer];
    {
      Walker wk(R.wl);
#pragma unroll
      for (int k = 0; k < kPer; ++k, wk.next()) {
        int r, c, ir, jc;
        const bool mine = threadIdx.x + k * kThreads < R.points;
        const bool ok =
            mine && position(R, P, h, w, wk.lr, wk.lc, r, c, ir, jc);
        at[k] = ok ? r * w + c : -1;
        // in bytes; a point past the region works on a ring cell whose
        // neighbours are all in the buffer (the first right-ring cell of
        // the first region row), writing the "none" it holds
        sidx[k] = 8 * (mine ? (wk.lr + R.lr) * wp + wk.lc + R.lc
                            : ring + wp - R.lc);
      }
    }
    float sx[kPer], sy[kPer], sd[kPer];
    if (io.mask) {
      uint8_t m[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) m[k] = at[k] >= 0 ? io.mask[at[k]] : 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        sx[k] = m[k] ? 0.f : -CUDART_INF_F;
        sy[k] = 0.f;
        sd[k] = m[k] ? 0.f : (at[k] >= 0 ? kInf : -CUDART_INF_F);
      }
    } else if (io.in_d) {
      float2 v[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) v[k] = at[k] >= 0 ? __ldcg(io.in_d + at[k]) : none;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        sx[k] = v[k].x;
        sy[k] = v[k].y;
        sd[k] = at[k] < 0 ? -CUDART_INF_F
                          : (v[k].x == -CUDART_INF_F ? kInf
                                                     : dist2(v[k].x, v[k].y));
      }
    } else {
      int br[kPer], bc[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        br[k] = at[k] >= 0 ? io.in_r[at[k]] : kNone;
        bc[k] = at[k] >= 0 ? io.in_c[at[k]] : kNone;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        // at[k] = r * w + c: the displacement from (r, c)
        const int r = at[k] / w, c = at[k] - (at[k] / w) * w;
        const bool real = br[k] > kNone;
        sx[k] = real ? (float)(br[k] - r) : -CUDART_INF_F;
        sy[k] = real ? (float)(bc[k] - c) : 0.f;
        sd[k] = at[k] < 0 ? -CUDART_INF_F
                          : (real ? dist2(sx[k], sy[k]) : kInf);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      *reinterpret_cast<float2*>(reinterpret_cast<char*>(sm) + sidx[k]) =
          make_float2(sx[k], sy[k]);
    __syncthreads();

    // the 8 steps in the JAX order: every point reads its neighbour, then
    // the points that took theirs write back, between two block barriers
    // (shifting a displacement by 0 is skipped: it leaves its bits)
    const int row = R.lr * wp;
    int step = 0;
#pragma unroll
    for (int a = -1; a <= 1; ++a) {
#pragma unroll
      for (int b = -1; b <= 1; ++b) {
        if (a == 0 && b == 0) continue;
        const char* src = reinterpret_cast<const char*>(sm) -
                          8 * (a * row + b * R.lc);
        const float fdr = (float)(a * P.s), fdc = (float)(b * P.s);
        unsigned took = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float2 v = *reinterpret_cast<const float2*>(src + sidx[k]);
          const float x = a ? __fsub_rn(v.x, fdr) : v.x;
          const float y = b ? __fsub_rn(v.y, fdc) : v.y;
          const float nd = dist2(x, y);
          if (nd < sd[k]) {
            sx[k] = x;
            sy[k] = y;
            sd[k] = nd;
            took |= 1u << k;
          }
        }
        if (step < 7) {
          __syncthreads();
#pragma unroll
          for (int k = 0; k < kPer; ++k)
            if (took & (1u << k))
              *reinterpret_cast<float2*>(reinterpret_cast<char*>(sm) +
                                         sidx[k]) = make_float2(sx[k], sy[k]);
          __syncthreads();
        }
        ++step;
      }
    }

    // store the tile's points
    Walker wk(R.wl);
#pragma unroll
    for (int k = 0; k < kPer; ++k, wk.next()) {
      if (at[k] < 0) continue;
      const int lr = wk.lr, lc = wk.lc;
      const int gi = R.i_lo + (lr >> P.lg_lr), gj = R.j_lo + (lc >> P.lg_lc);
      if (gi < R.i_t || gi >= R.i_e || gj < R.j_t || gj >= R.j_e) continue;
      const int i = at[k];
      const bool none = sx[k] == -CUDART_INF_F;
      const int vx = none ? 0 : (int)sx[k], vy = none ? 0 : (int)sy[k];
      if (io.out_d) {
        io.out_d[i] = make_float2(sx[k], sy[k]);
      } else if (io.dist) {
        io.dist[i] = sd[k];
        reinterpret_cast<int2*>(io.vec)[i] = make_int2(vx, vy);
      } else {
        const int r = i / w, c = i - (i / w) * w;
        io.out_r[i] = none ? kNone : r + vx;
        io.out_c[i] = none ? kNone : c + vy;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
jfa_kernel(const uint8_t* __restrict__ mask, const int* in_r,
           const int* in_c, int h, int w, Plan plan, float2* x, float2* y,
           int* out_r, int* out_c, float* dist, int* vec) {
  extern __shared__ float2 sm[];                 // kPadded points
  cg::grid_group grid = cg::this_grid();
  for (int q = 0; q < plan.n; ++q) {
    const bool first = q == 0, last = q == plan.n - 1;
    // pass q reads what pass q - 1 wrote: x after even passes, y after odd
    Io io{};
    if (first) {
      io.mask = mask;
      io.in_r = in_r;
      io.in_c = in_c;
    } else {
      io.in_d = (q & 1) ? x : y;
    }
    if (last) {
      io.out_r = out_r;
      io.out_c = out_c;
      io.dist = dist;
      io.vec = vec;
    } else {
      io.out_d = (q & 1) ? y : x;
    }
    run_pass(plan.p[q], h, w, io, sm);
    if (!last) grid.sync();
  }
}

}  // namespace

// As many CTAs as the current card holds at once (asked once a device).
static cudaError_t ctas_here(int* ctas) {
  static int ctas_of[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ctas_of[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(jfa_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, jfa_kernel,
                                                      kThreads, kSmem);
    if (e != cudaSuccess) return e;
    ctas_of[dev] = sms * per_sm;
  }
  *ctas = ctas_of[dev];
  return ctas_of[dev] < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

// The tile shape the plan must keep to, into shape[3]: a tile's region
// points at most, with its ring at most, and the CTAs the current card
// holds at once.
extern "C" int vpp_jfa_shape(int* shape) {
  int ctas = 0;
  const cudaError_t e = ctas_here(&ctas);
  if (e != cudaSuccess) return (int)e;
  shape[0] = kRegion;
  shape[1] = kPadded;
  shape[2] = ctas;
  return 0;
}

// The transform or one pass. plan: a host array of npasses rows (s, log2
// Lr, Tr, log2 Lc, Tc), each tile's region (min(Tr + 6, ceil(h / s)) Lr
// by min(Tc + 6, ceil(w / s)) Lc points) within vpp_jfa_shape's region,
// and within its ring size with a ring of one more lattice point a side.
// Source: mask, a
// contiguous (h, w) bool/uint8 seed mask, or (mask null) in_r, in_c, (h, w)
// int32 closest-seed coordinates (kNone where none; others inside the
// image). Destination: out_r, out_c, (h, w) int32 planes, or (out_r null)
// dist (h, w) float32 squared distances (1e9 where no seed) and vec (h, w,
// 2) int32 vectors (0 there). x, y: (h, w) float2 scratch planes, used
// only between passes (null for one pass; y too for two). (h - 1)^2 + (w -
// 1)^2 < 1e9; every buffer distinct.
extern "C" int vpp_jfa(const void* mask, const void* in_r, const void* in_c,
                       int h, int w, const int* plan, int npasses, void* x,
                       void* y, void* out_r, void* out_c, void* dist,
                       void* vec, void* stream) {
  if (h <= 0 || w <= 0 || npasses <= 0) return 0;
  if (npasses > kMaxPasses ||
      (long long)(h - 1) * (h - 1) + (long long)(w - 1) * (w - 1) >=
          1000000000ll || (!mask && (!in_r || !in_c)) ||
      (!out_r && (!dist || !vec)) || (out_r && !out_c) ||
      (npasses > 1 && !x) || (npasses > 2 && !y))
    return (int)cudaErrorInvalidValue;
  Plan P{};
  P.n = npasses;
  long long most = 0;
  for (int q = 0; q < npasses; ++q) {
    Pass& p = P.p[q];
    p = Pass{plan[5 * q], plan[5 * q + 1], plan[5 * q + 2], plan[5 * q + 3],
             plan[5 * q + 4]};
    if (p.s < 1 || p.tr < 1 || p.tc < 1 || p.lg_lr < 0 || p.lg_lc < 0 ||
        p.lg_lr > 20 || p.lg_lc > 20)
      return (int)cudaErrorInvalidValue;
    const long long er = (h + (long long)p.s - 1) / p.s;
    const long long ec = (w + (long long)p.s - 1) / p.s;
    const long long rr = p.tr + 2 * kHalo < er ? p.tr + 2 * kHalo : er;
    const long long rc = p.tc + 2 * kHalo < ec ? p.tc + 2 * kHalo : ec;
    if ((rr << p.lg_lr) * (rc << p.lg_lc) > kRegion ||
        ((rr + 2) << p.lg_lr) * ((rc + 2) << p.lg_lc) > kPadded)
      return (int)cudaErrorInvalidValue;
    const long long lr = 1ll << p.lg_lr, lc = 1ll << p.lg_lc;
    const long long res_r = p.s < h ? p.s : h, res_c = p.s < w ? p.s : w;
    const long long tiles = ((res_r + lr - 1) / lr) * ((er + p.tr - 1) / p.tr) *
                            ((res_c + lc - 1) / lc) * ((ec + p.tc - 1) / p.tc);
    if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    most = tiles > most ? tiles : most;
  }
  int ctas = 0;
  const cudaError_t e = ctas_here(&ctas);
  if (e != cudaSuccess) return (int)e;
  const int G = most < ctas ? (int)most : ctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, jfa_kernel, (const uint8_t*)mask, (const int*)in_r,
      (const int*)in_c, h, w, P, (float2*)x, (float2*)y, (int*)out_r,
      (int*)out_c, (float*)dist, (int*)vec);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}
