"""K10's and K1's CUDA sources run on the CPU under AddressSanitizer.

The routes that lift the kernels' size limits are compiled with g++ against
``tests/cuda_cpu_shim.h`` (a std::thread a CUDA thread, std::barrier for
the block and warp barriers, shuffles through a per-warp exchange array)
and run on buffers of exactly their size, shared memory included, so that
any read or write outside a buffer stops the run:

* K10's ``lk_any_kernel`` (``lk_level.cu``), staged and global, at winsizes
  past the 15 of its registers route and on pyramid levels whose patches
  are larger than their buffers (read as 0 outside them); held bit-equal to
  ``lk_levels_plain`` (flow, err, every window sample, the Newton steps);
* K1's launch A at its 2-cell tile and on its global route
  (``flow_volume_global_kernel``), at more than 1024 displacements, then
  launch B with its flat_to_k table in shared or in device memory; held
  bit-equal to the plain level (volume, flow, dist) on integer-valued
  buffers (up to 2047, past what bf16 holds exactly), where every window
  sum is exact.

Needs g++ with AddressSanitizer; the card tests hold the same kernels on
the H100.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

tlk = importlib.import_module("vpp_tpu_torch.algorithms.lk")
tfl = importlib.import_module("vpp_tpu_torch.algorithms.flow")
tpy = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
from vpp_tpu_torch.core.image import from_array  # noqa: E402
from vpp_tpu_torch.utils.clips import make_clip  # noqa: E402

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "vpp_tpu_torch" / "kernels" / "csrc"

# main(in, out): int32 header (nlev, n, ws, niter, adopt_below, global,
# warps, pb_max), float32 (min_ev, conv_sq, max_err, factor), per level 13
# int32 (ha, wa, ba, hb, wb, bb, hg, wg, bg, h, w, pad, s), then each
# level's a, b, g floats, then p and tr0; writes tr, dist, flow, err,
# windows and iters.
LK_DRIVER = r"""
#include <cstdio>
template <class T> static void rd(FILE* f, T* x, size_t n) {
  if (fread(x, sizeof(T), n, f) != n) exit(2);
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int hd[8];
  float fp[4];
  rd(f, hd, 8);
  rd(f, fp, 4);
  const int nl = hd[0], n = hd[1], ws = hd[2], warps = hd[6];
  Levels LV{};
  LV.n = nl;
  std::vector<std::vector<float>> bufs;
  std::vector<int> rows(13 * nl);
  rd(f, rows.data(), rows.size());
  for (int i = 0; i < nl; ++i) {
    const int* r = &rows[13 * i];
    for (size_t sz : {(size_t)r[0] * r[1], (size_t)r[3] * r[4],
                      (size_t)r[6] * r[7] * 2}) {
      bufs.emplace_back(sz);
      rd(f, bufs.back().data(), sz);
    }
    const float* a = bufs[bufs.size() - 3].data();
    const float* b = bufs[bufs.size() - 2].data();
    const float* g = bufs[bufs.size() - 1].data();
    LV.l[i] = Level{a, b, g, r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                    r[8], r[9], r[10], r[11], r[12]};
  }
  std::vector<float> p(2 * n), tr0(2 * n);
  rd(f, p.data(), p.size());
  rd(f, tr0.data(), tr0.size());
  fclose(f);
  const size_t nw = (size_t)ws * ws;
  std::vector<float> tr(2 * n), dist(n), flow(2 * nl * n), err(nl * n),
      win(4 * nw * nl * n);
  std::vector<int> iters(nl * n);
  const Out out{tr.data(), dist.data(), flow.data(), err.data(), win.data(),
                iters.data()};
  const size_t smem = hd[5] ? 0
      : 4 * (size_t)warps * (3 * (ws + 2) * (ws + 2) + hd[7] * hd[7]);
  shim_launch(dim3((n + warps - 1) / warps), 32 * warps, smem, [&] {
    if (hd[5])
      lk_any_kernel<true>(LV, p.data(), tr0.data(), n, ws, hd[7], fp[0],
                          hd[3], fp[1], hd[4], fp[2], fp[3], out);
    else
      lk_any_kernel<false>(LV, p.data(), tr0.data(), n, ws, hd[7], fp[0],
                           hd[3], fp[1], hd[4], fp[2], fp[3], out);
  }, true);
  FILE* o = fopen(argv[2], "wb");
  fwrite(tr.data(), 4, tr.size(), o);
  fwrite(dist.data(), 4, dist.size(), o);
  fwrite(flow.data(), 4, flow.size(), o);
  fwrite(err.data(), 4, err.size(), o);
  fwrite(win.data(), 4, win.size(), o);
  fwrite(iters.data(), 4, iters.size(), o);
  fclose(o);
  return 0;
}
"""

# main(in, out): int32 header (hb, wb, b, h, w, ws, patch, gh, gw, R,
# pred_bound, d2, a_global, tile, threads, kc, kb, a_smem, iters,
# ftk_shared, b_smem), then a1, a2 (float32), pred, disp, flat_to_k
# (int32); writes vol, flow and dist.
K1_DRIVER = r"""
#include <cstdio>
template <class T> static void rd(FILE* f, T* x, size_t n) {
  if (fread(x, sizeof(T), n, f) != n) exit(2);
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[21];
  rd(f, h, 21);
  const int hb = h[0], wb = h[1], ws = h[5], patch = h[6], gh = h[7],
            gw = h[8], R = h[9], d2 = h[11], tile = h[13], threads = h[14],
            kc = h[15], kb = h[16], iters = h[18];
  std::vector<float> a1((size_t)hb * wb), a2((size_t)hb * wb);
  std::vector<int> pred(2 * gh * gw), disp(2 * d2), ftk(d2);
  rd(f, a1.data(), a1.size());
  rd(f, a2.data(), a2.size());
  rd(f, pred.data(), pred.size());
  rd(f, disp.data(), disp.size());
  rd(f, ftk.data(), ftk.size());
  fclose(f);
  LevelGeom g;
  g.hb = hb;
  g.wb = wb;
  g.b = h[2];
  g.h = h[3];
  g.w = h[4];
  g.patch = patch;
  g.gh = gh;
  g.gw = gw;
  g.ph = g.h < gh * patch ? g.h : gh * patch;
  g.pw = g.w < gw * patch ? g.w : gw * patch;
  g.pred_bound = h[10];
  g.inv_patch = 1.0f / (float)patch;
  const int r0 = g.b - (ws / 2 - patch / 2);
  const int nchunk = (d2 + kc - 1) / kc;
  std::vector<float> vol((size_t)d2 * gh * gw), pc((size_t)nchunk * gh * gw);
  std::vector<int> pk((size_t)nchunk * gh * gw);
  const dim3 ga((gw + tile - 1) / tile, (gh + tile - 1) / tile, nchunk);
  shim_launch(ga, threads, h[17], [&] {
    if (h[12])
      flow_volume_global_kernel(a1.data(), a2.data(), pred.data(),
                                disp.data(), d2, g, ws, r0, tile, kc, nchunk,
                                vol.data(), pc.data(), pk.data());
    else if (tile == 2)
      flow_volume_kernel<2, 64>(a1.data(), a2.data(), pred.data(),
                                disp.data(), d2, g, ws, r0, R, kc, kb, nchunk,
                                vol.data(), pc.data(), pk.data());
    else
      flow_volume_kernel<4, 128>(a1.data(), a2.data(), pred.data(),
                                 disp.data(), d2, g, ws, r0, R, kc, kb,
                                 nchunk, vol.data(), pc.data(), pk.data());
  }, true);
  std::vector<int> flow(2 * gh * gw);
  std::vector<float> dist(gh * gw);
  shim_launch(dim3((gw + 7) / 8, (gh + 7) / 8, 1), kSelectThreads, h[20], [&] {
    flow_select_kernel(vol.data(), pc.data(), pk.data(), nchunk, pred.data(),
                       disp.data(), ftk.data(), nullptr, nullptr, R, gh, gw,
                       g.h, patch, 0, g.w, 8, iters, h[19], flow.data(),
                       dist.data());
  }, true);
  FILE* o = fopen(argv[2], "wb");
  fwrite(vol.data(), 4, vol.size(), o);
  fwrite(flow.data(), 4, flow.size(), o);
  fwrite(dist.data(), 4, dist.size(), o);
  fclose(o);
  return 0;
}
"""


def _kernels_of(name: str, replace) -> str:
    """The kernels of ``csrc/<name>`` (its anonymous namespace, cut where
    the host code begins, with spans that hold launches taken out) with
    the CUDA-only lines ``replace`` maps rewritten for the shim."""
    src = (CSRC / name).read_text().split("namespace {", 1)[1]
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    return src


def _compile(tmp_path_factory, name: str, body: str, driver: str) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp(name)
    (d / f"{name}.cpp").write_text(
        '#include "cuda_cpu_shim.h"\nnamespace {\n' + body
        + "\n}  // namespace\n" + driver)
    exe = d / name
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-g", "-fsanitize=address",
         "-fno-omit-frame-pointer", "-ffp-contract=off", "-pthread",
         f"-I{TESTS}", str(d / f"{name}.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def lk_cpu(tmp_path_factory):
    src = _kernels_of("lk_level.cu", [
        ("extern __shared__ float dsm[];",
         "float* dsm = static_cast<float*>(shim_smem);")])
    # the registers route's launch and the host helpers hold CUDA launches
    a = src.index("template <int kPer>\ncudaError_t launch(")
    b = src.index("// -- the staged and global routes")
    c = src.index("// Opts a kernel into more than 48 KB")
    return _compile(tmp_path_factory, "lk_cpu", src[:a] + src[b:c],
                    LK_DRIVER)


@pytest.fixture(scope="module")
def k1_cpu(tmp_path_factory):
    src = _kernels_of("flow_level.cu", [
        ('asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));',
         "n = shim_smem_bytes;"),
        ("extern __shared__ __align__(16) unsigned char smem[];",
         "unsigned char* smem = static_cast<unsigned char*>(shim_smem);")])
    c = src.index("// Opts a kernel into more than 48 KB")
    return _compile(tmp_path_factory, "k1_cpu", src[:c], K1_DRIVER)


def _run(exe, tmp: Path, parts):
    with open(tmp / "in.bin", "wb") as f:
        for x in parts:
            np.ascontiguousarray(x).tofile(f)
    r = subprocess.run([str(exe), str(tmp / "in.bin"), str(tmp / "out.bin")],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "AddressSanitizer" not in r.stderr, \
        r.stderr[-4000:]
    return np.fromfile(tmp / "out.bin", np.int32)


def _lk_frames(h, w, border):
    clip = make_clip(w, h, 3, seed=h)
    return [from_array(torch.from_numpy(f), border=border,
                       border_mode="mirror") for f in (clip[0], clip[2])]


# (h, w, nscales, n keypoints, winsize, route): past the registers route's
# winsize 15 staged and global, and pyramids whose coarse levels are
# smaller than the patches (the 2x2 levels of a deep pyramid)
LK_CASES = [
    (48, 64, 2, 9, 21, "staged"),
    (48, 64, 2, 7, 17, "global"),
    (40, 56, 7, 6, 11, "staged"),
    (40, 56, 7, 5, 9, "global"),
]


@pytest.mark.parametrize("h,w,nscales,n,ws,route", LK_CASES)
def test_lk_any_route_in_bounds_and_bit_equal(lk_cpu, tmp_path, h, w,
                                              nscales, n, ws, route):
    """``lk_any_kernel`` over a whole pyramid in one launch, from a
    prediction, with the adopt-below rule: no access outside a buffer, and
    the plain level loop's bits in every output."""
    border = max(3, ws // 2)
    i1, i2 = _lk_frames(h, w, border)
    pp = tpy.pyramid(i1, nscales, border=border)
    pn = tpy.pyramid(i2, nscales, border=border)
    pg = tlk.gradient_pyramid(pp)
    scales = list(range(nscales - 1, -1, -1))
    levels = [(pp[s], pn[s], pg[s]) for s in scales]
    rng = np.random.RandomState(n)
    p = (rng.rand(n, 2) * [h - 1, w - 1]).astype(np.float32)
    p[0] = [0.0, w - 1.0]
    tr0 = (rng.randn(n, 2) * 0.5).astype(np.float32)
    kw = dict(winsize=ws, min_ev=1e-4, niterations=21,
              convergence_delta=0.1)
    want = tlk.lk_levels_plain(levels, scales, torch.from_numpy(p),
                               torch.from_numpy(tr0), adopt="below",
                               factor=2.0, max_err=2.0, windows=True, **kw)
    rows, data, pads, fits = [], [], [], []
    for (A, B, G), s in zip(levels, scales):
        pad = tlk._search_pad(B, ws)
        pads.append(pad)
        fits.append(ws + 2 <= min(*A.data.shape, *G.data.shape[:2])
                    and ws + 2 * pad + 2 <= min(B.data.shape))
        rows += [*A.data.shape, A.border, *B.data.shape, B.border,
                 *G.data.shape[:2], G.border, *A.shape, pad, s]
        data += [A.data.numpy(), B.data.numpy(), G.data.numpy()]
    if nscales > 2:
        assert not all(fits)        # a level smaller than its patches
    plan = tlk._k10_plan(ws, max(pads), all(fits))
    assert plan[0] == "staged"
    warps = plan[1] if route == "staged" else 4
    pb_max = ws + 2 * max(pads) + 2
    raw = _run(lk_cpu, tmp_path, [
        np.array([len(levels), n, ws, 21, 1, route == "global", warps,
                  pb_max], np.int32),
        np.array([1e-4, tlk._sqrt_at_least(0.1), 2.0, 2.0], np.float32),
        np.array(rows, np.int32), *data, p, tr0])
    nl, nw = len(levels), ws * ws
    sizes = [2 * n, n, 2 * nl * n, nl * n, 4 * nw * nl * n, nl * n]
    got = np.split(raw, np.cumsum(sizes)[:-1])
    for g, x in zip(got, want):
        x = x.numpy()
        np.testing.assert_array_equal(g, x.reshape(-1).view(np.int32))


def _k1_case(hb, wb, b, ws, patch, R, pred_bound, seed):
    rng = np.random.RandomState(seed)
    h, w = hb - 2 * b, wb - 2 * b
    gh, gw = max(h // patch, 1), max(w // patch, 1)
    # integers up to 2047: bf16 holds 8 bits, so the rounding of the level
    # values and of the |diffs| is exercised, and every sum stays exact
    a1 = rng.randint(0, 2048, (hb, wb)).astype(np.float32)
    a2 = (np.roll(a1, (2, -1), (0, 1))
          + rng.randint(0, 24, (hb, wb))).astype(np.float32)
    pred = np.zeros((gh, gw, 2), np.int32)
    if pred_bound:
        pred = (rng.randint(-pred_bound // 2 - 1, pred_bound // 2 + 2,
                            (gh, gw, 2)) * 2).astype(np.int32)
    g = tfl.LevelGeometry(b=b, h=h, w=w, ws=ws, patch=patch, gh=gh, gw=gw,
                          R=R, pred_bound=pred_bound)
    return a1, a2, pred, g


# (hb, wb, border, winsize, patch, R, pred_bound, route): the 2-cell tile
# and the global route at 1089 displacements (search_niters 16), a warp,
# and launch B with its table in device memory
K1_CASES = [
    (46, 54, 9, 9, 5, 16, 0, "tile2"),
    (46, 54, 9, 9, 5, 16, 0, "global"),
    (52, 60, 9, 9, 5, 3, 10, "global"),
    (42, 50, 11, 15, 4, 2, 6, "tile2"),
]


@pytest.mark.parametrize("hb,wb,b,ws,patch,R,pred_bound,route", K1_CASES)
@pytest.mark.parametrize("table", ["shared", "global"])
def test_k1_routes_in_bounds_and_bit_equal(k1_cpu, tmp_path, hb, wb, b, ws,
                                           patch, R, pred_bound, route,
                                           table):
    """Launch A at its 2-cell tile or on its global route, then launch B
    (2 passes) with flat_to_k in shared or in device memory, on one
    integer-valued level: no access outside a buffer, and the volume, flow
    and dist of the plain level, bit for bit."""
    a1, a2, pred, g = _k1_case(hb, wb, b, ws, patch, R, pred_bound,
                               seed=hb + R)
    iters = 2
    sms = 3                          # a few blocks, a few chunks
    if route == "global":
        plan = tfl._global_volume(g, iters, sms)
    else:
        plan = tfl._k1_plan(g, iters, sms, (tfl._VOLUME_SHAPES[-1],))
        assert (plan.a_tile, plan.a_route) == (2, "shared")
    d2 = (2 * R + 1) ** 2
    b_smem = tfl._select_smem(8, iters, R, table == "shared")
    raw = _run(k1_cpu, tmp_path, [
        np.array([hb, wb, b, g.h, g.w, ws, patch, g.gh, g.gw, R, pred_bound,
                  d2, route == "global", plan.a_tile, plan.a_threads,
                  plan.chunk, plan.batch, plan.a_smem, iters,
                  table == "shared", b_smem], np.int32),
        a1, a2, pred, tfl._displacement_table(R)[0], tfl._flat_to_k(R)])
    n = g.gh * g.gw
    vol = raw[:d2 * n].view(np.float32).reshape(d2, g.gh, g.gw)
    flow = raw[d2 * n:d2 * n + 2 * n].reshape(g.gh, g.gw, 2)
    dist = raw[d2 * n + 2 * n:].view(np.float32).reshape(g.gh, g.gw)
    f, d, v = tfl.flow_match_plain(*map(torch.from_numpy, (a1, a2, pred)), g)
    for _ in range(iters):
        f, d = tfl.flow_propagate_plain(f, d, torch.from_numpy(pred), v, R)
    np.testing.assert_array_equal(vol, v.numpy())
    np.testing.assert_array_equal(flow, f.numpy())
    np.testing.assert_array_equal(dist.view(np.int32),
                                  d.numpy().view(np.int32))
