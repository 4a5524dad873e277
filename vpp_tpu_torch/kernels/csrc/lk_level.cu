// K10 — pyramidal Lucas-Kanade for N keypoints, coarse to fine in one
// launch: at each pyramid level the template and gradient windows, the 2x2
// gradient system and its min-eigenvalue gate, the Newton iterations in a
// search patch around the prediction, the normalised-SAD residual with its
// domain and patch gates, and the level glue of the caller (the prediction
// times the pyramid factor; the level's flow adopted always, or only where
// its residual is below max_err).
//
// Replaces vpp_tpu/algorithms/lk.py:lk_match_batch (:102), with
// _sample_windows_local (:70) and _extract_patches_tl (:52), and the level
// loops of pyrlk_match (:311) and lucas_kanade (:348). On the TPU the
// windows were sampled inside integer patches by a select over the k
// integer shifts of the patch, elementwise work that XLA fused into the
// iteration loop; in plain PyTorch on the card that form is ~300 launches a
// window. Here a whole lucas_kanade or pyrlk_match call is one launch; asked
// for one level (lk_level, lk_match_batch), it is that level.
//
// Bound on the H100, 1024 keypoints at VGA, winsize 11, 3 levels
// (chip_smoke.py counts it from the run's inputs): the distinct 32-byte
// sectors of A, B and the gradient level that the windows touch, ~1.6 MB a
// level, and 17 operations a sample a Newton step over the steps each
// keypoint takes, ~4e7 operations, ~0.6 us a level at 67 TFLOP/s. What
// bounds a launch is latency: each keypoint's Newton loop is serial (up to
// 21 steps, each a window of samples, two warp reductions and a square
// root). The previous design (a launch a level, every sample gathered from
// the level buffers with a runtime division a sample) took ~1.1 us a Newton
// step whatever the keypoint count (K10's split in PERF.md).
//
// Design. One warp a keypoint, 4 keypoints a CTA, every level in the
// launch: the keypoint's prediction and flow stay in registers between
// levels. At each level the warp stages its template, gradient and search
// patches (13x13, 13x13x2 and 37x37 floats at winsize 11, pad 12) in
// shared memory with cp.async copies, all in flight at once, so the Newton
// steps' 4 taps a sample come from shared memory. Lane l holds window
// samples e = l, l + 32, ... (kPer of them, a template parameter: winsize
// 11 is 4) in registers, with their patch offsets computed once, no
// division in the loop, and lanes past the window compute on a valid
// sample and add nothing (selects, no divergent branch). The 2x2 sums, the
// template's mean and deviation (before the Newton loop: they depend on
// the template alone), each Newton step's right-hand side and the residual
// are reduced by xor shuffles, so every lane holds the same bits and takes
// the same branch. A step's norm is held against the convergence delta as
// its square against the least float32 whose correctly rounded square root
// reaches the delta (the wrapper finds it once), the same decision without
// a square root in the loop. A keypoint leaves the loop once its step is
// below the delta (the JAX loop runs the fixed count with the keypoint
// masked: v is unchanged after that point, so the function is the same).
//
// Bits. The top-lefts follow jnp.round (half to even: rintf) and are
// clamped into the buffer as _extract_patches_tl clamps them; the sample
// offsets clip the integer shift to [0, k - 2] and the fraction to [0, 1]
// as _sample_windows_local does, so a sample that leaves the search patch
// reads the patch's edge. Each sample is rows first, then columns, as
// 0 + (1 - f) * p0 + f * p1 with every product and sum rounded on its own
// (__fmul_rn, __fadd_rn: nvcc would contract to FMA, which changes the
// bits), which is the plain version's arithmetic and the JAX package's
// outside a compiled loop. The scalar steps (the eigenvalue gate, the 1e-12
// guard of 1/det, the Newton update, the gates, the level glue) are the
// plain version's operations in its order, correctly rounded. The plain
// version sums the ws^2 terms in this kernel's lane order (lk.py:_lane_sum),
// so the two are bit-equal on the same inputs.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxLevels = 16;
constexpr int kMaxWs = 15;                        // ws^2 <= 256: 8 a lane
constexpr int kMaxPad = 12;
constexpr int kMaxPt = kMaxWs + 2;                // template patch side
constexpr int kMaxPb = kMaxWs + 2 * kMaxPad + 2;  // search patch side
constexpr int kWarpFloats = 3 * kMaxPt * kMaxPt + kMaxPb * kMaxPb;
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLevelInts = 16;                    // a level's host row

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fadd(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// top-left of a size x size patch around float centre c (buffer coords):
// round half to even, minus size / 2, clamped to [0, lim]
__device__ __forceinline__ int patch_tl(float c, int size, int lim) {
  int t = (int)rintf(c) - size / 2;
  return t < 0 ? 0 : (t > lim ? lim : t);
}

// the sampler's integer shift (clipped to [0, k - 2]) and fraction
// (clipped to [0, 1]) for a window start s in patch coordinates
struct Axis {
  int i;
  float f0, f1;                     // 1 - f, f
};

__device__ __forceinline__ Axis axis_of(float s, int k) {
  float is = floorf(s);
  is = fminf(fmaxf(is, 0.f), (float)(k - 2));
  const float f = fminf(fmaxf(fsub(s, is), 0.f), 1.f);
  return {(int)is, fsub(1.f, f), f};
}

// one window sample from its top-left tap q: rows rs apart, columns cs
__device__ __forceinline__ float sample(const float* q, int rs, int cs,
                                        Axis ar, Axis ac) {
  const float r0 = fadd(fadd(0.f, fmul(q[0], ar.f0)), fmul(q[rs], ar.f1));
  const float r1 = fadd(fadd(0.f, fmul(q[cs], ar.f0)),
                        fmul(q[rs + cs], ar.f1));
  return fadd(fadd(0.f, fmul(r0, ac.f0)), fmul(r1, ac.f1));
}

// copy a rows x cols block (row stride ld floats) into shared memory,
// packed; the warp's lanes split it, every copy in flight at once
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int cols, int ld, int lane) {
  int r = 0, c = lane;
  while (c >= cols && r < rows) {
    c -= cols;
    ++r;
  }
  for (int i = lane; i < rows * cols; i += 32) {
    __pipeline_memcpy_async(dst + i, src + (size_t)r * ld + c, 4);
    c += 32;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

struct Level {
  const float* a;                   // (ha, wa) template level
  const float* b;                   // (hb, wb) search level
  const float* g;                   // (hg, wg, 2) gradient level
  int ha, wa, ba, hb, wb, bb, hg, wg, bg;
  int h, w;                         // the interior extent of a
  int pad;                          // the search patch's travel
  int s;                            // the level: positions are p / 2^s
};

struct Levels {
  int n;                            // coarsest first
  Level l[kMaxLevels];
};

struct Out {
  float* tr;                        // (n, 2) the last level's prediction
  float* dist;                      // (n,) the last level's residual
  float* flow;                      // (L, n, 2) each level's flow, or null
  float* err;                       // (L, n)
  float* windows;                   // (L, n, 4, ws^2)
  int* iters;                       // (L, n) Newton steps
};

template <int kPer>
__global__ void __launch_bounds__(kWarps * 32)
lk_kernel(Levels LV, const float* __restrict__ p, const float* __restrict__ tr0,
          int n, int ws, float min_ev, int niter, float conv_sq,
          int adopt_below, float max_err, float factor, Out out) {
  __shared__ float smem[kWarps * kWarpFloats];
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n) return;
  const int lane = threadIdx.x & 31;
  const int nw = ws * ws, hws = ws / 2, pt = ws + 2;
  const float cnt = (float)nw;
  float* As = smem + (threadIdx.x >> 5) * kWarpFloats;
  float* Gs = As + kMaxPt * kMaxPt;
  float* Bs = Gs + 2 * kMaxPt * kMaxPt;

  // this lane's samples: window row i, column j, and their template and
  // gradient patch offsets
  int wi[kPer], wj[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int e = lane + 32 * m;
    wi[m] = e / ws;
    wj[m] = e - wi[m] * ws;
  }

  const float p0 = p[2 * q], p1 = p[2 * q + 1];
  float trr = tr0[2 * q], trc = tr0[2 * q + 1];
  float dist = 0.f;
  for (int lv = 0; lv < LV.n; ++lv) {
    const Level& L = LV.l[lv];
    const float scale = ldexpf(1.f, -L.s);
    const float pr = fmul(p0, scale), pc = fmul(p1, scale);
    trr = fmul(trr, factor);
    trc = fmul(trc, factor);
    const float v0r = fadd(pr, trr), v0c = fadd(pc, trc);
    const int pb = ws + 2 * L.pad + 2, kb = pb - ws + 1;

    // patch top-lefts: template and gradient around p, search around v0
    const float ar_c = fadd(pr, (float)L.ba), ac_c = fadd(pc, (float)L.ba);
    const int atr = patch_tl(ar_c, pt, L.ha - pt);
    const int atc = patch_tl(ac_c, pt, L.wa - pt);
    const float gr_c = fadd(pr, (float)L.bg), gc_c = fadd(pc, (float)L.bg);
    const int gtr = patch_tl(gr_c, pt, L.hg - pt);
    const int gtc = patch_tl(gc_c, pt, L.wg - pt);
    const float br_c = fadd(v0r, (float)L.bb), bc_c = fadd(v0c, (float)L.bb);
    const int btr = patch_tl(br_c, pb, L.hb - pb);
    const int btc = patch_tl(bc_c, pb, L.wb - pb);
    __syncwarp();                   // the last level's reads of the patches
    stage(As, L.a + (size_t)atr * L.wa + atc, pt, pt, L.wa, lane);
    stage(Gs, L.g + 2 * ((size_t)gtr * L.wg + gtc), pt, 2 * pt, 2 * L.wg,
          lane);
    stage(Bs, L.b + (size_t)btr * L.wb + btc, pb, pb, L.wb, lane);
    __pipeline_commit();
    const Axis ta_r = axis_of(fsub(fsub(ar_c, (float)atr), (float)hws), 3);
    const Axis ta_c = axis_of(fsub(fsub(ac_c, (float)atc), (float)hws), 3);
    const Axis tg_r = axis_of(fsub(fsub(gr_c, (float)gtr), (float)hws), 3);
    const Axis tg_c = axis_of(fsub(fsub(gc_c, (float)gtc), (float)hws), 3);
    int ob[kPer];                   // search patch offsets (0 past the
#pragma unroll                      // window)
    for (int m = 0; m < kPer; ++m)
      ob[m] = lane + 32 * m < nw ? wi[m] * pb + wj[m] : 0;
    __pipeline_wait_prior(0);
    __syncwarp();

    // template and gradient windows, the 2x2 system and the template's
    // mean absolute deviation (lanes past the window compute on the
    // patch's first sample and add nothing: no divergent branch)
    float as[kPer], gr[kPer], gc[kPer];
    float s11 = 0.f, s12 = 0.f, s22 = 0.f, sa = 0.f;
    const float* A0 = As + ta_r.i * pt + ta_c.i;
    const float* G0 = Gs + 2 * (tg_r.i * pt + tg_c.i);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const bool on = lane + 32 * m < nw;
      const int ot = on ? wi[m] * pt + wj[m] : 0;
      const float ta = sample(A0 + ot, pt, 1, ta_r, ta_c);
      const float tgr = sample(G0 + 2 * ot, 2 * pt, 2, tg_r, tg_c);
      const float tgc = sample(G0 + 2 * ot + 1, 2 * pt, 2, tg_r, tg_c);
      as[m] = on ? ta : 0.f;
      gr[m] = on ? tgr : 0.f;
      gc[m] = on ? tgc : 0.f;
      s11 = on ? fadd(s11, fmul(tgr, tgr)) : s11;
      s12 = on ? fadd(s12, fmul(tgr, tgc)) : s12;
      s22 = on ? fadd(s22, fmul(tgc, tgc)) : s22;
      sa = on ? fadd(sa, ta) : sa;
    }
    const float a11 = warp_sum(s11), a12 = warp_sum(s12), a22 = warp_sum(s22);
    const float avg = __fdiv_rn(warp_sum(sa), cnt);
    float dev = 0.f;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const float t = fadd(dev, fabsf(fsub(as[m], avg)));
      dev = lane + 32 * m < nw ? t : dev;
    }
    const float stddev = __fdiv_rn(warp_sum(dev), cnt);

    // min eigenvalue of G / cnt, and G's inverse with the 1e-12 guard
    const float tr_g = __fdiv_rn(fadd(a11, a22), cnt);
    const float x = __fdiv_rn(fsub(a11, a22), cnt), y = __fdiv_rn(a12, cnt);
    const float det_part =
        __fsqrt_rn(fmaxf(fadd(fmul(x, x), fmul(4.f, fmul(y, y))), 0.f));
    const bool ok = fmul(0.5f, fsub(tr_g, det_part)) >= min_ev;
    const float det = fsub(fmul(a11, a22), fmul(a12, a12));
    const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.f, det) : 0.f;
    const float i11 = fmul(a22, inv_det), i12 = fmul(-a12, inv_det);
    const float i22 = fmul(a11, inv_det);

    // Newton steps in the search patch; a step's norm against the
    // convergence delta is its squared norm against conv_sq, the least
    // float32 whose correctly rounded square root reaches the delta
    const float bb_f = (float)L.bb, btr_f = (float)btr, btc_f = (float)btc;
    float vr = v0r, vc = v0c;
    bool active = ok;
    int it = 0;
    for (; it < niter && active; ++it) {
      const Axis sr = axis_of(fsub(fsub(fadd(vr, bb_f), btr_f), (float)hws),
                              kb);
      const Axis sc = axis_of(fsub(fsub(fadd(vc, bb_f), btc_f), (float)hws),
                              kb);
      const float* B0 = Bs + sr.i * pb + sc.i;
      float b1 = 0.f, b2 = 0.f;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const bool on = lane + 32 * m < nw;
        const float dt = fsub(as[m], sample(B0 + ob[m], pb, 1, sr, sc));
        const float t1 = fadd(b1, fmul(gr[m], dt));
        const float t2 = fadd(b2, fmul(gc[m], dt));
        b1 = on ? t1 : b1;
        b2 = on ? t2 : b2;
      }
      const float bk1 = warp_sum(b1), bk2 = warp_sum(b2);
      const float nk1 = fadd(fmul(i11, bk1), fmul(i12, bk2));
      const float nk2 = fadd(fmul(i12, bk1), fmul(i22, bk2));
      vr = fadd(vr, nk1);
      vc = fadd(vc, nk2);
      active = fadd(fmul(nk1, nk1), fmul(nk2, nk2)) >= conv_sq;
    }

    // gates and the normalised SAD residual at the final v
    const bool in_domain = vr >= 0.f && vr <= (float)(L.h - 1) && vc >= 0.f &&
                           vc <= (float)(L.w - 1);
    const bool in_patch = fabsf(fsub(vr, v0r)) <= (float)L.pad &&
                          fabsf(fsub(vc, v0c)) <= (float)L.pad;
    const Axis sr = axis_of(fsub(fsub(fadd(vr, bb_f), btr_f), (float)hws), kb);
    const Axis sc = axis_of(fsub(fsub(fadd(vc, bb_f), btc_f), (float)hws), kb);
    const float* B0 = Bs + sr.i * pb + sc.i;
    float sad = 0.f;
    float* win = out.windows
                     ? out.windows + ((size_t)lv * n + q) * 4 * nw
                     : nullptr;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = lane + 32 * m;
      const float bs = sample(B0 + ob[m], pb, 1, sr, sc);
      const float t = fadd(sad, fabsf(fsub(as[m], bs)));
      sad = e < nw ? t : sad;
      if (win && e < nw) {
        win[e] = as[m];
        win[nw + e] = gr[m];
        win[2 * nw + e] = gc[m];
        win[3 * nw + e] = bs;
      }
    }
    const float e_val = __fdiv_rn(warp_sum(sad),
                                  fmul(cnt, fmaxf(stddev, 1e-6f)));
    const float err = (ok && in_domain && in_patch) ? e_val : kBig;
    const float fr = fsub(vr, pr), fc = fsub(vc, pc);

    // the level glue: adopt the flow always, or where err < max_err
    if (!adopt_below || err < max_err) {
      trr = fr;
      trc = fc;
    }
    dist = err;
    if (lane == 0 && out.flow) {
      const size_t k = (size_t)lv * n + q;
      out.flow[2 * k] = fr;
      out.flow[2 * k + 1] = fc;
      out.err[k] = err;
      out.iters[k] = it;
    }
  }
  if (lane == 0) {
    out.tr[2 * q] = trr;
    out.tr[2 * q + 1] = trc;
    out.dist[q] = dist;
  }
}

template <int kPer>
cudaError_t launch(const Levels& LV, const float* p, const float* tr0, int n,
                   int ws, float min_ev, int niter, float conv_sq,
                   int adopt_below, float max_err, float factor,
                   const Out& out, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  lk_kernel<kPer><<<blocks, kWarps * 32, 0, stream>>>(
      LV, p, tr0, n, ws, min_ev, niter, conv_sq, adopt_below, max_err,
      factor, out);
  return cudaGetLastError();
}

}  // namespace

// LK for n keypoints over nlev pyramid levels, coarsest first, in one
// launch. levels: a host array of nlev rows of kLevelInts int64s: a, ha,
// wa, ba, b, hb, wb, bb, g, hg, wg, bg (the template level with its
// border, the search level, the 2-channel gradient level; contiguous
// float32), h, w (a's interior extent), pad (the search patch's travel, the
// patch side ws + 2 pad + 2), s (the level's keypoints are p / 2^s), then
// padding. p: (n, 2) float32 finest-level positions; tr0: (n, 2) float32
// the prediction before the first level's factor. conv_sq: the least
// float32 whose correctly rounded square root reaches the convergence
// delta (a step's squared norm at or above it continues the loop). At each level tr =
// tr * factor, then the level's flow replaces tr always (adopt_below 0) or
// where its err < max_err (1); dist is the level's err. Outputs: tr (n, 2)
// and dist (n,); flow (L, n, 2), err (L, n), windows (L, n, 4, ws^2) and
// iters (L, n) int32, each level's flow, residual, template, row- and
// column-gradient and final search windows and Newton steps, or all null.
extern "C" int vpp_lk(const long long* levels, int nlev, const void* p,
                      const void* tr0, int n, int ws, float min_ev, int niter,
                      float conv_sq, int adopt_below, float max_err,
                      float factor, void* tr, void* dist, void* flow,
                      void* err, void* windows, void* iters, void* stream) {
  if (n <= 0 || nlev <= 0) return 0;
  if (nlev > kMaxLevels || ws < 1 || ws > kMaxWs || !tr || !dist ||
      (flow && (!err || !windows || !iters)))
    return (int)cudaErrorInvalidValue;
  Levels LV{};
  LV.n = nlev;
  const int pt = ws + 2;
  for (int i = 0; i < nlev; ++i) {
    const long long* r = levels + (size_t)i * kLevelInts;
    Level& L = LV.l[i];
    L = Level{(const float*)r[0], (const float*)r[4], (const float*)r[8],
              (int)r[1], (int)r[2], (int)r[3], (int)r[5], (int)r[6],
              (int)r[7], (int)r[9], (int)r[10], (int)r[11], (int)r[12],
              (int)r[13], (int)r[14], (int)r[15]};
    const int pb = ws + 2 * L.pad + 2;
    if (L.pad < 1 || L.pad > kMaxPad || L.s < 0 || L.s > 100 || pt > L.ha ||
        pt > L.wa || pt > L.hg || pt > L.wg || pb > L.hb || pb > L.wb)
      return (int)cudaErrorInvalidValue;
  }
  const Out out{(float*)tr, (float*)dist, (float*)flow, (float*)err,
                (float*)windows, (int*)iters};
  const float* pp = (const float*)p;
  const float* tt = (const float*)tr0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch ((ws * ws + 31) / 32) {
    case 1: e = launch<1>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 2: e = launch<2>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 3: e = launch<3>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 4: e = launch<4>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 5: e = launch<5>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 6: e = launch<6>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    case 7: e = launch<7>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
    default: e = launch<8>(LV, pp, tt, n, ws, min_ev, niter, conv_sq, adopt_below, max_err, factor, out, st); break;
  }
  return (int)e;
}
