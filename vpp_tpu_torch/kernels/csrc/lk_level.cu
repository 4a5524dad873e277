// K10 — one pyramid level of Lucas-Kanade for N keypoints: the template
// and gradient windows, the 2x2 gradient system and its min-eigenvalue
// gate, the Newton iterations in a search patch around the prediction, and
// the normalised-SAD residual with its domain and patch gates.
//
// Replaces vpp_tpu/algorithms/lk.py:lk_match_batch (:102), with
// _sample_windows_local (:70) and _extract_patches_tl (:52). On the TPU the
// windows were sampled inside integer patches by a select over the k
// integer shifts of the patch (two Python loops of k = 27 terms at VGA),
// elementwise work that XLA fused into the iteration loop; in plain
// PyTorch on the card that form is ~300 launches a window, and a two-tap
// gather still ~1,500 launches a 3-level lucas_kanade call. Here a level is
// one launch.
//
// Bound on the H100, a level of 1024 keypoints at VGA, winsize 11, 21
// iterations (chip_smoke.py counts it from the run's inputs): the
// distinct 32-byte sectors of A, B and the gradient level that the windows
// touch, ~1.6 MB a level, and 17 operations a sample a Newton step
// (two-tap rows and columns, the difference, two products and sums) over
// the steps each keypoint takes, ~4e7 operations, ~0.6 us at 67 TFLOP/s.
// What bounds a launch is latency: each keypoint's Newton loop is serial
// (up to 21 steps of gathers and two shuffle reductions), and the design
// keeps it in registers.
//
// Design. One warp a keypoint, 4 keypoints a CTA. Lane l holds window
// samples e = l, l + 32, ... (< ws^2, at most kMaxPer) in registers: the
// template sample and the two gradient samples, read straight from the
// level buffers (no staging: every sample reads 4 pixels, L1-resident
// across the iterations). The 2x2 sums, the right-hand side of every
// Newton step and the residual are reduced by xor shuffles, so every lane
// holds the same bits and takes the same branch. A keypoint leaves the
// loop once its step is below the convergence delta (the JAX loop runs the
// fixed count with the keypoint masked: v is unchanged after that point,
// so the function is the same).
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
// guard of 1/det, the Newton update, the gates) are the plain version's
// operations in its order, correctly rounded. The plain version sums the
// ws^2 terms in this kernel's lane order (lk.py:_lane_sum), so the two
// are bit-equal on the same inputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPer = 8;          // ws^2 <= 256: winsize <= 15
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;

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

// one window sample: patch element (a, b) at P[a * rs + b * cs]
__device__ __forceinline__ float sample(const float* __restrict__ P, int rs,
                                        int cs, Axis ar, Axis ac, int i,
                                        int j) {
  const float* q = P + (ar.i + i) * rs + (ac.i + j) * cs;
  const float r0 = fadd(fadd(0.f, fmul(q[0], ar.f0)), fmul(q[rs], ar.f1));
  const float r1 = fadd(fadd(0.f, fmul(q[cs], ar.f0)),
                        fmul(q[rs + cs], ar.f1));
  return fadd(fadd(0.f, fmul(r0, ac.f0)), fmul(r1, ac.f1));
}

struct Level {
  const float* a;                   // (ha, wa) template level
  const float* b;                   // (hb, wb) search level
  const float* g;                   // (hg, wg, 2) gradient level
  int ha, wa, ba, hb, wb, bb, hg, wg, bg;
};

__global__ void __launch_bounds__(kWarps * 32)
lk_level_kernel(Level L, const float* __restrict__ p,
                const float* __restrict__ tr, int n, int ws, int pad, int h,
                int w, float min_ev, int niter, float conv_delta,
                float* __restrict__ flow, float* __restrict__ err,
                float* __restrict__ windows, int* __restrict__ iters) {
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= n) return;
  const int lane = threadIdx.x & 31;
  const int nw = ws * ws, hws = ws / 2;
  const int pt = ws + 2, pb = ws + 2 * pad + 2;
  const float cnt = (float)nw;
  const float p0 = p[2 * q], p1 = p[2 * q + 1];
  const float v0r = fadd(p0, tr[2 * q]), v0c = fadd(p1, tr[2 * q + 1]);

  // template and gradient patches around p (13x13 at winsize 11)
  const float ar_c = fadd(p0, (float)L.ba), ac_c = fadd(p1, (float)L.ba);
  const int atr = patch_tl(ar_c, pt, L.ha - pt);
  const int atc = patch_tl(ac_c, pt, L.wa - pt);
  const float gr_c = fadd(p0, (float)L.bg), gc_c = fadd(p1, (float)L.bg);
  const int gtr = patch_tl(gr_c, pt, L.hg - pt);
  const int gtc = patch_tl(gc_c, pt, L.wg - pt);
  const Axis ta_r = axis_of(fsub(fsub(ar_c, (float)atr), (float)hws), 3);
  const Axis ta_c = axis_of(fsub(fsub(ac_c, (float)atc), (float)hws), 3);
  const Axis tg_r = axis_of(fsub(fsub(gr_c, (float)gtr), (float)hws), 3);
  const Axis tg_c = axis_of(fsub(fsub(gc_c, (float)gtc), (float)hws), 3);
  const float* A = L.a + atr * L.wa + atc;
  const float* G = L.g + 2 * (gtr * L.wg + gtc);

  float as[kMaxPer], gr[kMaxPer], gc[kMaxPer];
  float s11 = 0.f, s12 = 0.f, s22 = 0.f, sa = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int e = lane + 32 * m;
    as[m] = gr[m] = gc[m] = 0.f;
    if (e < nw) {
      const int i = e / ws, j = e - (e / ws) * ws;
      as[m] = sample(A, L.wa, 1, ta_r, ta_c, i, j);
      gr[m] = sample(G, 2 * L.wg, 2, tg_r, tg_c, i, j);
      gc[m] = sample(G + 1, 2 * L.wg, 2, tg_r, tg_c, i, j);
      s11 = fadd(s11, fmul(gr[m], gr[m]));
      s12 = fadd(s12, fmul(gr[m], gc[m]));
      s22 = fadd(s22, fmul(gc[m], gc[m]));
      sa = fadd(sa, as[m]);
    }
  }
  const float a11 = warp_sum(s11), a12 = warp_sum(s12), a22 = warp_sum(s22);

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

  // search patch around the prediction (37x37 at winsize 11, pad 12)
  const int kb = pb - ws + 1;
  const float br_c = fadd(v0r, (float)L.bb), bc_c = fadd(v0c, (float)L.bb);
  const int btr = patch_tl(br_c, pb, L.hb - pb);
  const int btc = patch_tl(bc_c, pb, L.wb - pb);
  const float* B = L.b + btr * L.wb + btc;
  const float btr_f = (float)btr, btc_f = (float)btc;

  float vr = v0r, vc = v0c;
  bool active = ok;
  int it = 0;
  for (; it < niter && active; ++it) {
    const Axis sr = axis_of(fsub(fsub(fadd(vr, (float)L.bb), btr_f),
                                 (float)hws), kb);
    const Axis sc = axis_of(fsub(fsub(fadd(vc, (float)L.bb), btc_f),
                                 (float)hws), kb);
    float b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      const int e = lane + 32 * m;
      if (e < nw) {
        const int i = e / ws, j = e - (e / ws) * ws;
        const float dt = fsub(as[m], sample(B, L.wb, 1, sr, sc, i, j));
        b1 = fadd(b1, fmul(gr[m], dt));
        b2 = fadd(b2, fmul(gc[m], dt));
      }
    }
    const float bk1 = warp_sum(b1), bk2 = warp_sum(b2);
    const float nk1 = fadd(fmul(i11, bk1), fmul(i12, bk2));
    const float nk2 = fadd(fmul(i12, bk1), fmul(i22, bk2));
    vr = fadd(vr, nk1);
    vc = fadd(vc, nk2);
    active = __fsqrt_rn(fadd(fmul(nk1, nk1), fmul(nk2, nk2))) >= conv_delta;
  }

  // gates and the normalised SAD residual at the final v
  const bool in_domain = vr >= 0.f && vr <= (float)(h - 1) && vc >= 0.f &&
                         vc <= (float)(w - 1);
  const bool in_patch = fabsf(fsub(vr, v0r)) <= (float)pad &&
                        fabsf(fsub(vc, v0c)) <= (float)pad;
  const float avg = __fdiv_rn(warp_sum(sa), cnt);
  const Axis sr = axis_of(fsub(fsub(fadd(vr, (float)L.bb), btr_f),
                               (float)hws), kb);
  const Axis sc = axis_of(fsub(fsub(fadd(vc, (float)L.bb), btc_f),
                               (float)hws), kb);
  float dev = 0.f, sad = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int e = lane + 32 * m;
    if (e < nw) {
      const int i = e / ws, j = e - (e / ws) * ws;
      const float bs = sample(B, L.wb, 1, sr, sc, i, j);
      dev = fadd(dev, fabsf(fsub(as[m], avg)));
      sad = fadd(sad, fabsf(fsub(as[m], bs)));
      if (windows) {
        float* o = windows + (size_t)q * 4 * nw + e;
        o[0] = as[m];
        o[nw] = gr[m];
        o[2 * nw] = gc[m];
        o[3 * nw] = bs;
      }
    }
  }
  const float stddev = __fdiv_rn(warp_sum(dev), cnt);
  const float e_val = __fdiv_rn(warp_sum(sad),
                                fmul(cnt, fmaxf(stddev, 1e-6f)));
  if (lane == 0) {
    flow[2 * q] = fsub(vr, p0);
    flow[2 * q + 1] = fsub(vc, p1);
    err[q] = (ok && in_domain && in_patch) ? e_val : kBig;
    if (iters) iters[q] = it;
  }
}

}  // namespace

// One LK level for n keypoints. a: (ha, wa) float32 template level with
// border ba; b: (hb, wb) search level with border bb; g: (hg, wg, 2)
// gradient level with border bg, all contiguous. p, tr: (n, 2) float32
// interior positions and predictions; h, w: the interior extent of a. pad:
// the search patch's travel (patch side ws + 2 pad + 2). Outputs flow (n,
// 2) and err (n,); windows (n, 4, ws^2) or null: the template, row- and
// column-gradient windows and the search window at the final position;
// iters (n,) int32 or null: the Newton steps each keypoint took.
extern "C" int vpp_lk_level(const void* a, int ha, int wa, int ba,
                            const void* b, int hb, int wb, int bb,
                            const void* g, int hg, int wg, int bg,
                            const void* p, const void* tr, int n, int ws,
                            int pad, int h, int w, float min_ev, int niter,
                            float conv_delta, void* flow, void* err,
                            void* windows, void* iters, void* stream) {
  if (n <= 0) return 0;
  const int pt = ws + 2, pb = ws + 2 * pad + 2;
  if (ws < 1 || ws * ws > 32 * kMaxPer || pad < 1 || pt > ha || pt > wa ||
      pt > hg || pt > wg || pb > hb || pb > wb)
    return (int)cudaErrorInvalidValue;
  const Level L{(const float*)a, (const float*)b, (const float*)g, ha, wa, ba,
                hb, wb, bb, hg, wg, bg};
  const int blocks = (n + kWarps - 1) / kWarps;
  lk_level_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      L, (const float*)p, (const float*)tr, n, ws, pad, h, w, min_ev, niter,
      conv_delta, (float*)flow, (float*)err, (float*)windows, (int*)iters);
  return (int)cudaGetLastError();
}
