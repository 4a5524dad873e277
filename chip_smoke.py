#!/usr/bin/env python3
"""Smoke run of vpp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. the card's name and power limit;
2. build the CUDA kernels from ``vpp_tpu_torch/kernels/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (640x480, the bench clip recipe): K2 fast9 bit-equal;
   K1 flow level on every pyramid level, dist within rtol 1e-5 and flow
   equal wherever the best and second-best SAD differ by more than 1e-5
   relative, propagation passes exactly equal on equal inputs; K7 Hough
   accumulator bit-identical across two launches, within 1e-4 * max of
   the float32 scatter, and in every cell within its fixed-point rounding
   bound of a float64 scatter. Each is timed with CUDA events after warm-up;
4. the tracker main path: ``video_extruder_run`` at 640x480 with the bench
   config on 60 frames already on the card, frames/s under
   ``torch.cuda.synchronize``, launch
   counts of K1 and K2, and the first 10 frames against the plain CPU path
   (alive counts within 1%);
5. the Hough path: ``hough_tracker_update`` on 30 frames of the two-line
   clip at 640x480, ms/frame, K7's launch count, and the same frames on the
   plain CPU path (the same live tracks at the same (θ, ρ));
6. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Bounds use the H100 SXM data sheet (3.35 TB/s device memory, 67 TFLOP/s
float32 outside the tensor cores, applied to every scalar operation).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
W, H = 640, 480
TRACK_FRAMES = 60
CPU_CHECK_FRAMES = 10
HOUGH_FRAMES = 30


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bilinear_votes(torch, th_n, rho_n, w, t_theta: int, rho_bins: int):
    """The four bilinear votes of every pixel as flat cell indices and
    float32 values, computed as K7 computes them: (idx (4N,), votes (4N,))."""
    t0f, r0f = torch.floor(th_n), torch.floor(rho_n)
    ft, fr = th_n - t0f, rho_n - r0f
    t0 = t0f.long().clamp(0, t_theta - 1)
    r0 = r0f.long().clamp(0, rho_bins - 1)
    t1, r1 = (t0 + 1).clamp(max=t_theta - 1), (r0 + 1).clamp(max=rho_bins - 1)
    a0, a1 = w * (1 - ft), w * ft
    idx = torch.cat([t0 * rho_bins + r0, t0 * rho_bins + r1,
                     t1 * rho_bins + r0, t1 * rho_bins + r1])
    return idx, torch.cat([a0 * (1 - fr), a0 * fr, a1 * (1 - fr), a1 * fr])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    import vpp_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from vpp_tpu_torch.algorithms import fast as F
    from vpp_tpu_torch.algorithms import flow as FL
    from vpp_tpu_torch.algorithms import hough as HG
    from vpp_tpu_torch.algorithms import hough_cuda as HC
    from vpp_tpu_torch.algorithms.hough_tracker import (
        HoughTrackerConfig, hough_tracker_init, hough_tracker_update)
    from vpp_tpu_torch.algorithms.pyramid import level_shapes, pyramid
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig, video_extruder_run)
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.kernels import (_build, launch_counts,
                                       reset_launch_counts)
    from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}")
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------------
    _build.build()
    print(_build.build_log)
    _build.load()
    print(f"phase 2: kernels built in {_build.build_seconds:.2f} s")

    cfg = VideoExtruderConfig(capacity=4096, detect_k=2048, nscales=3,
                              winsize=9, keypoint_spacing=10,
                              detector_period=5, detector_th=10)
    b = max(3, cfg.winsize)
    clip = make_clip(W, H, TRACK_FRAMES, seed=0)
    results = {}

    # -- 3a. K2 fast9 ---------------------------------------------------------
    img = from_array(torch.from_numpy(clip[3]).to(dev), border=b,
                     border_mode="mirror")
    sk, dk = F.fast9_cuda(img, cfg.detector_th, detect=True)
    sp, dp = F.fast9_plain(img, cfg.detector_th, detect=True)
    torch.cuda.synchronize()
    k2_err = int((sk - sp).abs().max())
    check(torch.equal(sk, sp) and torch.equal(dk, dp),
          "K2 fast9 differs from its plain version")
    k2_bytes = img.data.numel() * 4 + H * W * (4 + 1)
    k2_ops = H * W * (16 * 8 + 20)
    results["fast9"] = dict(
        name="fast9", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/fast9.cu",
        replaces="vpp_tpu/algorithms/fast.py:81",
        max_abs_err=float(k2_err),
        ms=cuda_ms(torch, lambda: F.fast9_cuda(img, cfg.detector_th), 200),
        plain_ms=cuda_ms(torch, lambda: F.fast9_plain(img, cfg.detector_th),
                         20),
        library_ms=None)
    results["fast9"]["bound_ms"], results["fast9"]["bound_by"] = bound_ms(
        k2_bytes, k2_ops)
    print("phase 3: K2 fast9 bit-equal; "
          f"{int(dk.sum())} corners, {results['fast9']['ms']:.4f} ms")

    # -- 3b. K1 flow level, every level of a 640x480 pyramid ------------------
    p1 = pyramid(from_array(torch.from_numpy(clip[0]).to(dev), border=b,
                            border_mode="mirror"), cfg.nscales, border=b)
    p2 = pyramid(from_array(torch.from_numpy(clip[2]).to(dev), border=b,
                            border_mode="mirror"), cfg.nscales, border=b)
    grid = level_shapes((H // cfg.patchsize, W // cfg.patchsize),
                        cfg.nscales)
    radii = FL._level_radii(cfg.nscales, 5, 1)
    bounds = FL._level_bounds(cfg.nscales, radii)
    level_args, k1_err, k1_ties = [], 0.0, 0
    k1_bytes = k1_ops = 0
    pred = None
    for s in range(cfg.nscales - 1, -1, -1):
        h, w = p1[s].shape
        gh, gw = grid[s]
        if pred is None:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)
        else:
            cgh, cgw = grid[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flow_k[ir[:, None], ic[None, :]]
        g = FL.LevelGeometry(b=b, h=h, w=w, ws=cfg.winsize,
                             patch=cfg.patchsize, gh=gh, gw=gw, R=radii[s],
                             pred_bound=0 if s == cfg.nscales - 1
                             else 2 * bounds[s + 1])
        a1, a2 = p1[s].data, p2[s].data
        fk, dk1, vk = FL.flow_match(a1, a2, pred, g)
        fp, dp1, vp = FL.flow_match_plain(a1, a2, pred, g)
        torch.cuda.synchronize()
        two = torch.topk(vp, 2, dim=0, largest=False).values
        clear = (two[1] - two[0]) > 1e-5 * two[0].abs().clamp(min=1e-30)
        k1_ties += int((~clear).sum())
        check(bool(((fk == fp).all(-1) | ~clear).all()),
              f"K1 flow differs from its plain version at level {s}")
        check(torch.equal((dk1 >= 1e29)[clear], (dp1 >= 1e29)[clear]),
              f"K1 in-domain rejection differs at level {s}")
        fin = clear & (dp1 < 1e29)
        rel = ((dk1 - dp1).abs() / dp1.abs().clamp(min=1e-30))[fin]
        check(rel.numel() == 0 or float(rel.max()) <= 1e-5,
              f"K1 dist off by rtol {float(rel.max())} at level {s}")
        check(bool(((vk - vp).abs()
                    <= 1e-5 * vp.abs().clamp(min=1e-30)).all()),
              f"K1 volume differs at level {s}")
        if fin.any():
            k1_err = max(k1_err, float((dk1 - dp1).abs()[fin].max()))
        # propagation: equal inputs must give equal outputs
        f_in, d_in = fp, dp1
        for _ in range(cfg.propagation):
            fpk, dpk = FL.flow_propagate(f_in, d_in, pred, vp, g.R)
            fpp, dpp = FL.flow_propagate_plain(f_in, d_in, pred, vp, g.R)
            check(torch.equal(fpk, fpp) and torch.equal(dpk, dpp),
                  f"K1 propagation differs at level {s}")
            f_in, d_in = fpp, dpp
        flow_k, _ = FL.flow_level(a1, a2, pred, g, cfg.propagation)
        level_args.append((a1, a2, pred, g))
        d2 = (2 * g.R + 1) ** 2
        k1_bytes += a1.numel() * 4 * 2 + gh * gw * (8 + 8 + 4)
        k1_ops += d2 * gh * gw * cfg.winsize ** 2 * 6 \
            + cfg.propagation * gh * gw * 8 * 12

    def k1_frame(fn):
        def run():
            for a1, a2, pr, g in level_args:
                fn(a1, a2, pr, g)
        return run

    def plain_level(a1, a2, pr, g):
        f, d, v = FL.flow_match_plain(a1, a2, pr, g)
        for _ in range(cfg.propagation):
            f, d = FL.flow_propagate_plain(f, d, pr, v, g.R)

    results["flow_level"] = dict(
        name="flow_level", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/flow_level.cu",
        replaces="vpp_tpu/algorithms/flow.py:224",
        max_abs_err=k1_err,
        ms=cuda_ms(torch, k1_frame(
            lambda a1, a2, pr, g: FL.flow_level(a1, a2, pr, g,
                                                cfg.propagation)), 50),
        plain_ms=cuda_ms(torch, k1_frame(plain_level), 5),
        library_ms=None)
    results["flow_level"]["bound_ms"], results["flow_level"]["bound_by"] = \
        bound_ms(k1_bytes, k1_ops)
    print(f"phase 3: K1 flow level holds on {cfg.nscales} levels "
          f"({k1_ties} near-tie cells excluded), "
          f"{results['flow_level']['ms']:.4f} ms/frame")

    # -- 3c. K7 Hough accumulator ---------------------------------------------
    lines = synthetic_line_clip(W, H, HOUGH_FRAMES)
    hcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    himg = from_array(torch.from_numpy(lines[5]).to(dev), border=3,
                      border_mode="mirror")
    t0i, r0i, ft, fr, wgt, rho_bins = HG._vote_bins(
        himg, hcfg.t_theta, None, hcfg.grad_threshold, "binary", None)
    th_n = (t0i.float() + ft).reshape(-1)
    rho_n = (r0i.float() + fr).reshape(-1)
    wv = wgt.reshape(-1).contiguous()
    tt = hcfg.t_theta
    acc1 = HC.hough_acc(th_n, rho_n, wv, tt, rho_bins)
    acc2 = HC.hough_acc(th_n, rho_n, wv, tt, rho_bins)
    accp = HC.hough_acc_plain(th_n, rho_n, wv, tt, rho_bins)
    torch.cuda.synchronize()
    check(torch.equal(acc1, acc2), "K7 is not bit-reproducible")
    k7_err = float((acc1 - accp).abs().max())
    check(k7_err <= 1e-4 * float(accp.max()),
          f"K7 off by {k7_err} (max {float(accp.max())})")
    # per cell against a float64 sum of the same float32 votes: the fixed
    # point rounds each of the cell's n votes by at most 2^-25 and the
    # conversion to float32 by at most 2^-24 relative; any vote lost or sent
    # to another cell shows above that
    idx, vals = bilinear_votes(torch, th_n, rho_n, wv, tt, rho_bins)
    voting = (wv != 0).repeat(4)
    k7_exact = torch.zeros((tt * rho_bins,), dtype=torch.float64,
                           device=dev).index_add_(0, idx[voting],
                                                  vals[voting].double())
    k7_nvotes = torch.bincount(idx[voting], minlength=tt * rho_bins)
    k7_slack = k7_nvotes * 2.0 ** -25 + k7_exact.abs() * 2.0 ** -24 + 1e-12
    k7_dev = (acc1.double().reshape(-1) - k7_exact).abs()
    k7_over = float((k7_dev - k7_slack).max())
    check(k7_over <= 0.0,
          f"K7 exceeds its fixed-point error bound by {k7_over}")
    # the library yardstick: one index_put_ of the 4N votes
    lib_acc = torch.zeros((tt * rho_bins,), dtype=torch.float32, device=dev)
    n_edge = int((wv != 0).sum())
    results["hough_acc"] = dict(
        name="hough_acc", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/hough_acc.cu",
        replaces="vpp_tpu/algorithms/hough_pallas.py:68",
        max_abs_err=k7_err,
        ms=cuda_ms(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt,
                                               rho_bins), 200),
        plain_ms=cuda_ms(torch, lambda: HC.hough_acc_plain(
            th_n, rho_n, wv, tt, rho_bins), 50),
        library_ms=cuda_ms(torch, lambda: lib_acc.index_put_(
            (idx,), vals, accumulate=True), 50))
    results["hough_acc"]["bound_ms"], results["hough_acc"]["bound_by"] = \
        bound_ms(th_n.numel() * 4 * 3 + tt * rho_bins * 4, n_edge * 20)
    print(f"phase 3: K7 hough_acc reproducible, err {k7_err:.3g} of max "
          f"{float(accp.max()):.1f}, {n_edge} voting pixels, "
          f"{results['hough_acc']['ms']:.4f} ms; off the float64 scatter "
          f"by {float(k7_dev.max()):.3g}, every cell within its bound "
          f"(largest bound {float(k7_slack.max()):.3g})")

    # -- 4. tracker main path -------------------------------------------------
    clip_dev = torch.from_numpy(clip).to(dev)   # upload outside the timing
    video_extruder_run(clip_dev[:6], cfg, device="cuda")     # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, (hist_pos, hist_alive) = video_extruder_run(clip_dev, cfg,
                                                       device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    track_counts = launch_counts()
    fps = TRACK_FRAMES / dt
    live = int(state.keypoints.alive.sum())
    print(f"phase 4: tracker {W}x{H}: {fps:.2f} frames/s over "
          f"{TRACK_FRAMES} frames, {live} live keypoints, launches "
          f"{track_counts}")
    check(track_counts["flow_level"] > 0 and track_counts["fast9"] > 0,
          "the tracker did not launch K1 and K2")
    check(tuple(hist_pos.shape) == (TRACK_FRAMES, cfg.capacity, 2)
          and bool(torch.isfinite(hist_pos).all()), "bad tracker output")
    check(live > 0, "no live keypoints")
    cpu_state, (_, cpu_alive) = video_extruder_run(
        clip[:CPU_CHECK_FRAMES], cfg, device="cpu")
    n_gpu = int(hist_alive[CPU_CHECK_FRAMES - 1].sum())
    n_cpu = int(cpu_alive[-1].sum())
    print(f"phase 4: alive after {CPU_CHECK_FRAMES} frames: card {n_gpu}, "
          f"plain CPU {n_cpu}")
    check(abs(n_gpu - n_cpu) <= 0.01 * max(n_cpu, 1),
          "tracker alive counts differ from the plain CPU path by > 1%")

    # -- 5. Hough path --------------------------------------------------------
    lines_dev = torch.from_numpy(lines).to(dev)  # upload outside the timing
    hst = hough_tracker_init(hcfg, device="cuda")
    hough_tracker_update(hst, from_array(lines_dev[0], border=3,
                                         border_mode="mirror"),
                         hcfg)                             # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for f in lines_dev:
        hst, _ = hough_tracker_update(
            hst, from_array(f, border=3, border_mode="mirror"), hcfg)
    torch.cuda.synchronize()
    hough_ms = (time.perf_counter() - t0) * 1e3 / HOUGH_FRAMES
    hough_counts = launch_counts()
    n_tracks = int((hst.age > 0).sum())
    print(f"phase 5: hough tracker {W}x{H}: {hough_ms:.3f} ms/frame, "
          f"{n_tracks} live tracks, launches {hough_counts}")
    check(n_tracks >= 2, "fewer than 2 live line tracks")
    check(hough_counts["hough_acc"] > 0, "the Hough path did not launch K7")
    cst = hough_tracker_init(hcfg, device="cpu")
    for f in lines:
        cst, _ = hough_tracker_update(
            cst, from_array(f, border=3, border_mode="mirror"), hcfg)
    same = (torch.equal(hst.age.cpu(), cst.age)
            and torch.equal(hst.theta.cpu(), cst.theta)
            and torch.equal(hst.rho.cpu(), cst.rho))
    check(same, "Hough tracks differ from the plain CPU path")

    # -- 6. results -----------------------------------------------------------
    per_frame = {"fast9": track_counts["fast9"] / TRACK_FRAMES,
                 "flow_level": track_counts["flow_level"] / TRACK_FRAMES,
                 "hough_acc": hough_counts["hough_acc"] / HOUGH_FRAMES}
    launches = {"fast9": track_counts["fast9"],
                "flow_level": track_counts["flow_level"],
                "hough_acc": hough_counts["hough_acc"]}
    kernels = []
    for key in ("flow_level", "fast9", "hough_acc"):
        r = results[key]
        r["launches"] = launches[key]
        r["launches_per_frame"] = per_frame[key]
        kernels.append(r)
    print(json.dumps({"tracker_fps": fps, "tracker_live": live,
                      "hough_ms_per_frame": hough_ms, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
