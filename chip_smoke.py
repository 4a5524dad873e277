#!/usr/bin/env python3
"""Smoke run of vpp_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and prints no result:

1. the card's name and power limit;
2. build the CUDA kernels from ``vpp_tpu_torch/kernels/csrc`` (nvcc);
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (640x480, the bench clip recipe): K2 fast9 bit-equal
   in its three modes, each one launch a call (the full map; the cull at
   the tracker's 4096 slots after 6 frames; the score image of the SLAM
   frame after the 24-frame warm-up, with that warm-up's occupancy mask),
   each mode timed as below (``*_per_mode``);
   K1 flow level on every pyramid level, volume and dist within rtol 1e-5
   and flow equal wherever the best and second-best SAD differ by more
   than 1e-5 relative, the whole level (volume, flow, dist) bit-equal on
   the level buffers rounded to integers, propagation (pass by pass and
   all passes in one launch) exactly equal on equal inputs; K7 Hough
   accumulator one device kernel a call (the profiler shows no memset),
   bit-identical across two launches, within 1e-4 * max of the float32
   scatter, and in every cell within its fixed-point rounding bound of a
   float64 scatter. Each is timed as called (``ms``: CUDA
   events around the Python calls, host work included) and on the device
   (``device_ms``: CUDA events around replays of a CUDA graph of the
   calls, captured after warm-up; the profiler's device time where
   capture is refused; ``device_ms_by`` names which). K1 is timed per
   level and per frame. Then K3 block top-K bit-equal at the 640x480 SLAM
   frame's score image (one launch a call), at 40000 and 82944 blocks
   (a 4K frame at 10 px) and on images of long runs of tied scores, uint8
   and int32, with its device time at each size; K4, the whole pyramid in
   one launch from the raw frame and from a bordered frame's interior, at
   640x480 and 357x493, 3 levels with border 9: bit-equal to the plain
   chain on integer-valued frames and within 1e-6 relative on float ones,
   one device kernel, timed beside the library route (``index_select``
   pads and banded ``torch.matmul`` pairs) and the parent's route (the
   frame image, a second pad of level 0 and one K4 launch a level); K5
   patches bit-equal at 1024 x 7x7 from int32
   and int64 centres in the bordered VGA frame and on a 3-channel buffer,
   one launch a call, beside the library's advanced indexing from the same
   centres (index preparation and gather, each also timed alone); K6, the
   whole window-BA
   call in one launch, on a keyframe problem of a 24-frame SLAM warm-up
   run: its trace's first-iteration S and cost within 1e-4 of the plain
   assembly relative to their largest magnitude, rhs within 1e-4 of the
   magnitude of its terms, the first pose solve's backward error within
   1e-5, two launches bit-identical (trace included), and poses within
   1e-4, every landmark's reprojections into its observing keyframes
   within 1e-3 px and costs within 1e-4 of the plain LM loop on the same
   problem; the same with every step rejected and with the pose
   factorisation failing; and ``ba_solve_tracks(iters=0)`` returning the
   problem bit-equal with empty costs and no launch. K6 is timed per ``ba_solve_tracks`` call. Each
   row with a library call (K3, K4, K5, K7) also carries the library's
   ``library_device_ms`` from the same CUDA-graph replays;
4. the tracker main path: ``video_extruder_run`` at 640x480 with the bench
   config on 60 frames already on the card, frames/s under
   ``torch.cuda.synchronize``, launch counts of K1 (two per level and
   frame), K2 (72: a cull a frame, a score image every 5th) and K4 (61:
   one pyramid a frame and the first frame's), and the
   first 10 frames against the plain CPU path
   (alive counts within 1%);
5. the Hough path: ``hough_tracker_update`` on 30 frames of the two-line
   clip at 640x480, ms/frame, K7's launch count (one a frame), and the
   same frames on the
   plain CPU path (the same live tracks at the same (θ, ρ));
6. the SLAM tracking+BA path: ``slam_run`` at the matched 640x480
   configuration of ``benchmarks/bench_slam.py`` (2000-point cloud, lateral
   dolly, capacity 1024, ring 6, 3 LM iterations, recovery off) on 240
   frames rendered by ``vpp_tpu_torch/utils/synth.py`` (seed 1) and already
   on the card: frames/s under ``torch.cuda.synchronize``, launch counts of
   K1-K6 (K2 two a frame, K3 one a frame, K4 241, K5 and K6 one a
   keyframe),
   keyframes (60), live landmarks (> 200) and ATE (< 0.10). The
   state just before keyframe 30 is copied to the CPU and ``_do_keyframe``
   runs on both (poses within 1e-3, ``lm_valid`` agreeing on >= 99% of
   slots), the card's call under ``torch.cuda.set_sync_debug_mode("error")``
   (no host synchronisation); the first 40 frames on the plain CPU path
   give the card's keyframe count, landmark counts within 5% and ATE within
   0.02;
7. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.

Bounds use the H100 SXM data sheet (3.35 TB/s device memory, 67 TFLOP/s
float32 outside the tensor cores, applied to every scalar operation; for
K6, 34 TFLOP/s for its scalar float64 landmark algebra and 67 TFLOP/s for
its Schur products on the float64 tensor cores). K1's
bound counts its least work: both level buffers read once, flow and dist
written once, and the separable window sums (one |diff| per region pixel
and displacement, ws - 1 additions per column sum and per window). The
phase-3 line prints beside it the bound that counts every window summed in
full, six operations a pixel, as this script counted before the separable
sums; the kernels line carries only ``bound_ms``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12       # float64 outside the tensor cores
FP64_MMA_OPS_PER_S = 67e12   # float64 on the tensor cores
W, H = 640, 480
TRACK_FRAMES = 60
CPU_CHECK_FRAMES = 10
HOUGH_FRAMES = 30
SLAM_FRAMES = 240
SLAM_WARMUP = 24
SLAM_CPU_FRAMES = 40
SLAM_CHECK_KF = 30
SLAM_INTR = (640.0, 640.0, 320.0, 240.0)


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


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(torch, fn, calls: int = 20, replays: int = 20):
    """Device ms per call of ``fn``: CUDA events around ``replays`` replays
    of a CUDA graph of ``calls`` calls, captured after a warm-up (the
    device tables are cached by then). Where capture is refused, the
    profiler's device time of ``calls`` calls. Returns (ms, method)."""
    fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as exc:
        print(f"chip_smoke: graph capture refused ({exc}); using the "
              "profiler's device time")
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(_device_us(e) for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU)
        return us / 1e3 / calls, "profiler"
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls), "cuda_graph"


def device_kernels(torch, fn) -> dict:
    """The device operations (kernels, memsets, copies) one call of ``fn``
    runs, by name and count, from ``torch.profiler``, after a warm-up call
    under a profiler session of its own (a process's first session can
    miss device events)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU}


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


def slam_config():
    """The matched tracking+BA configuration of benchmarks/bench_slam.py at
    640x480 (geometry vga_640x480, recovery off)."""
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    from vpp_tpu_torch.slam.pipeline import SlamConfig
    return SlamConfig(
        intrinsics=SLAM_INTR, keyframe_period=4, ring=6, ba_iters=3,
        pnp_iters=6, min_parallax=2.0, max_reproj=2.0, prune_reproj=2.5,
        history=64, lc_min_gap=60, enable_recovery=False,
        tracker=VideoExtruderConfig(capacity=1024, detect_k=512, nscales=3,
                                    winsize=9, keypoint_spacing=10,
                                    detector_period=1, detector_th=10))


def slam_clip(frames: int):
    """``frames`` frames of the SLAM clip (2000-point cloud, lateral dolly,
    seed 1) as a numpy array, and the ground-truth poses."""
    from vpp_tpu_torch.utils.synth import (camera_path, make_cloud,
                                           render_frames)
    cloud = make_cloud(2000, seed=1, extent=(16.0, 5.0, 3.5),
                       center=(3.2, 0.0, 5.0))
    gt_poses = camera_path(frames, step=(0.02, 0.0, 0.0))
    return render_frames(cloud, gt_poses, SLAM_INTR, (H, W), seed=1,
                         sigma=(1.2, 2.2)), gt_poses


def same_bits(torch, a, b) -> bool:
    """Bit-identical float32 tensors (NaN included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import numpy as np
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
    from vpp_tpu_torch import convert
    from vpp_tpu_torch.algorithms import pyramid as PY
    from vpp_tpu_torch.algorithms.pyramid import level_shapes, pyramid
    from vpp_tpu_torch.algorithms import video_extruder as VE
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig, video_extruder_run)
    from vpp_tpu_torch.core import interp as IP
    from vpp_tpu_torch.core.image import Image2d, from_array, pad_index
    from vpp_tpu_torch.kernels import (_build, launch_counts,
                                       reset_launch_counts)
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.slam import ba_cuda as BC
    from vpp_tpu_torch.slam import pipeline as SP
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

    # -- 3a. K2 fast9: the full map and the cull (the score image follows the
    # SLAM warm-up in 3g, with that frame's occupancy mask) ----------------
    th = cfg.detector_th
    img = from_array(torch.from_numpy(clip[3]).to(dev), border=b,
                     border_mode="mirror")
    reset_launch_counts()
    sk, dk = F.fast9_cuda(img, th, detect=True)
    check(launch_counts()["fast9"] == 1, "K2's full map is not one launch")
    sp, dp = F.fast9_plain(img, th, detect=True)
    torch.cuda.synchronize()
    k2_err = int((sk - sp).abs().max())
    check(torch.equal(sk, sp) and torch.equal(dk, dp),
          "K2 fast9 differs from its plain version")
    # the cull at the tracker's 4096 slots, after 6 frames of the clip
    cull_state, _ = video_extruder_run(clip[:6], cfg, device="cuda")
    cull_pos = cull_state.keypoints.position
    cull_img = from_array(torch.from_numpy(clip[5]).to(dev), border=b,
                          border_mode="mirror")
    reset_launch_counts()
    ck = F.fast9_cull_scores(cull_img, cull_pos, th)
    check(launch_counts()["fast9"] == 1, "K2's cull is not one launch")
    cp = F.fast9_cull_scores_plain(cull_img, cull_pos, th)
    check(torch.equal(ck, cp), "K2's cull differs from its plain version")
    k2_err = max(k2_err, int((ck - cp).abs().max()))
    n_slots = cull_pos.shape[0]
    k2_pixel_ops = H * W * (16 * 8 + 20)
    k2_modes = {
        "full": (lambda: F.fast9_cuda(img, th),
                 lambda: F.fast9_plain(img, th),
                 img.data.numel() * 4 + H * W * (4 + 1), k2_pixel_ops),
        "cull": (lambda: F.fast9_cull_scores(cull_img, cull_pos, th),
                 lambda: F.fast9_cull_scores_plain(cull_img, cull_pos, th),
                 n_slots * (8 + 17 * 4 + 4), n_slots * (16 * 8 + 30))}

    def k2_time(mode, fn, plain, nbytes, ops):
        r = results["fast9"]
        r["ms_per_mode"][mode] = cuda_ms(torch, fn, 200)
        r["plain_ms_per_mode"][mode] = cuda_ms(torch, plain, 20)
        r["bound_ms_per_mode"][mode] = bound_ms(nbytes, ops)[0]
        r["device_ms_per_mode"][mode], r["device_ms_by"] = device_ms(
            torch, fn)

    results["fast9"] = dict(
        name="fast9", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/fast9.cu",
        replaces="vpp_tpu/algorithms/fast.py:81",
        max_abs_err=float(k2_err),
        modes="ms, device_ms, plain_ms and bound_ms are the full map's; "
              "each mode's under *_per_mode",
        ms_per_mode={}, plain_ms_per_mode={}, bound_ms_per_mode={},
        device_ms_per_mode={}, library_ms=None)
    for mode, args in k2_modes.items():
        k2_time(mode, *args)
    k2 = results["fast9"]
    k2["ms"], k2["plain_ms"] = k2["ms_per_mode"]["full"], \
        k2["plain_ms_per_mode"]["full"]
    k2["device_ms"] = k2["device_ms_per_mode"]["full"]
    k2["bound_ms"], k2["bound_by"] = bound_ms(*k2_modes["full"][2:])
    print("phase 3: K2 fast9 full map and cull bit-equal, one launch each; "
          f"{int(dk.sum())} corners, {n_slots} slots; "
          + ", ".join(f"{m} {k2['ms_per_mode'][m]:.4f} ms as called, "
                      f"{k2['device_ms_per_mode'][m]:.4f} on the device "
                      f"(bound {k2['bound_ms_per_mode'][m]:.5f})"
                      for m in k2_modes))

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
    k1_bytes = k1_ops = k1_ops_full = 0
    props = cfg.propagation
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
        # propagation: equal inputs must give equal outputs, pass by pass
        # and with every pass in one launch
        f_in, d_in = fp, dp1
        for _ in range(props):
            fpk, dpk = FL.flow_propagate(f_in, d_in, pred, vp, g.R)
            fpp, dpp = FL.flow_propagate_plain(f_in, d_in, pred, vp, g.R)
            check(torch.equal(fpk, fpp) and torch.equal(dpk, dpp),
                  f"K1 propagation differs at level {s}")
            f_in, d_in = fpp, dpp
        fpk, dpk = FL.flow_propagate(fp, dp1, pred, vp, g.R, iters=props)
        check(torch.equal(fpk, f_in) and torch.equal(dpk, d_in),
              f"K1 fused propagation differs at level {s}")
        # integer-valued buffers make every sum exact: the whole level must
        # be bit-equal, ties included
        i1, i2 = a1.round(), a2.round()
        fik, dik, vik = FL.flow_match(i1, i2, pred, g)
        fip, dip, vip = FL.flow_match_plain(i1, i2, pred, g)
        check(torch.equal(vik, vip) and torch.equal(fik, fip)
              and torch.equal(dik, dip),
              f"K1 match not bit-equal on integer buffers at level {s}")
        for _ in range(props):
            fip, dip = FL.flow_propagate_plain(fip, dip, pred, vip, g.R)
        fik, dik = FL.flow_level(i1, i2, pred, g, props)
        check(torch.equal(fik, fip) and torch.equal(dik, dip),
              f"K1 level not bit-equal on integer buffers at level {s}")
        flow_k, _ = FL.flow_level(a1, a2, pred, g, props)
        level_args.append((s, a1, a2, pred, g))
        d2 = (2 * g.R + 1) ** 2
        ws = cfg.winsize
        lr, lc = (gh - 1) * g.patch + ws, (gw - 1) * g.patch + ws
        k1_bytes += a1.numel() * 4 * 2 + gh * gw * (8 + 8 + 4)
        k1_ops += (d2 * (lr * lc * 2 + gh * lc * (ws - 1)
                         + gh * gw * (ws - 1))
                   + gh * gw * (d2 - 1) + props * gh * gw * 8 * 12)
        k1_ops_full += d2 * gh * gw * ws ** 2 * 6 + props * gh * gw * 8 * 12

    def k1_frame(fn):
        def run():
            for _, a1, a2, pr, g in level_args:
                fn(a1, a2, pr, g)
        return run

    def plain_level(a1, a2, pr, g):
        f, d, v = FL.flow_match_plain(a1, a2, pr, g)
        for _ in range(props):
            f, d = FL.flow_propagate_plain(f, d, pr, v, g.R)

    k1_levels = {}
    for s, a1, a2, pr, g in level_args:
        k1_levels[f"level{s}_{g.gh}x{g.gw}"], k1_by = device_ms(
            torch, lambda a1=a1, a2=a2, pr=pr, g=g: FL.flow_level(
                a1, a2, pr, g, props))
    results["flow_level"] = dict(
        name="flow_level", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/flow_level.cu",
        replaces="vpp_tpu/algorithms/flow.py:224",
        max_abs_err=k1_err,
        ms=cuda_ms(torch, k1_frame(
            lambda a1, a2, pr, g: FL.flow_level(a1, a2, pr, g, props)), 50),
        plain_ms=cuda_ms(torch, k1_frame(plain_level), 5),
        library_ms=None,
        device_ms=sum(k1_levels.values()), device_ms_by=k1_by,
        device_ms_per_level=k1_levels)
    results["flow_level"]["bound_ms"], results["flow_level"]["bound_by"] = \
        bound_ms(k1_bytes, k1_ops)
    k1_bound_full = bound_ms(k1_bytes, k1_ops_full)[0]
    print(f"phase 3: K1 flow level holds on {cfg.nscales} levels "
          f"({k1_ties} near-tie cells excluded), bit-equal on integer "
          f"buffers; per frame {results['flow_level']['ms']:.4f} ms as "
          f"called, {results['flow_level']['device_ms']:.4f} ms on the "
          f"device ({k1_by}; per level "
          + ", ".join(f"{k} {v:.4f}" for k, v in k1_levels.items())
          + f"), bound {results['flow_level']['bound_ms']:.5f} ms "
          f"({results['flow_level']['bound_by']}; every window in full: "
          f"{k1_bound_full:.5f} ms)")

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
    k7_ops = device_kernels(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt,
                                                         rho_bins))
    check(sum(k7_ops.values()) == 1 and "hough" in next(iter(k7_ops)),
          f"K7 is not one device kernel a call: {k7_ops}")
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
    # the bytes K7 must move: w in full, th and rho only in the 32-byte
    # sectors that hold a voting pixel, the float32 accumulator out
    voters = torch.nonzero(wv != 0).reshape(-1)
    k7_sectors = sum(
        int(torch.unique((t.data_ptr() % 32 // 4 + voters) // 8).numel())
        for t in (th_n, rho_n))
    k7_bytes = wv.numel() * 4 + k7_sectors * 32 + tt * rho_bins * 4
    results["hough_acc"]["bound_ms"], results["hough_acc"]["bound_by"] = \
        bound_ms(k7_bytes, n_edge * 20)
    results["hough_acc"]["device_ms"], results["hough_acc"]["device_ms_by"] = \
        device_ms(torch, lambda: HC.hough_acc(th_n, rho_n, wv, tt, rho_bins))
    results["hough_acc"]["library_device_ms"] = device_ms(
        torch, lambda: lib_acc.index_put_((idx,), vals, accumulate=True))[0]
    results["hough_acc"]["device_ops"] = k7_ops
    print(f"phase 3: K7 hough_acc one device kernel a call "
          f"({next(iter(k7_ops))}, no memset), reproducible, err "
          f"{k7_err:.3g} of max "
          f"{float(accp.max()):.1f}, {n_edge} voting pixels "
          f"({k7_sectors} sectors of th and rho; bound "
          f"{results['hough_acc']['bound_ms']:.5f} ms for {k7_bytes} "
          "bytes), "
          f"{results['hough_acc']['ms']:.4f} ms as called, "
          f"{results['hough_acc']['device_ms']:.4f} ms on the device; off "
          "the float64 scatter "
          f"by {float(k7_dev.max()):.3g}, every cell within its bound "
          f"(largest bound {float(k7_slack.max()):.3g})")

    # -- 3d-3g: the SLAM path's kernels, on the SLAM clip ---------------------
    slam_cfg = slam_config()
    t0 = time.perf_counter()
    slam_frames, gt_poses = slam_clip(SLAM_FRAMES)
    print(f"phase 3: rendered {SLAM_FRAMES} SLAM frames in "
          f"{time.perf_counter() - t0:.1f} s")
    sb = max(3, slam_cfg.tracker.winsize)
    sframe = from_array(torch.from_numpy(slam_frames[100]).to(dev), border=sb,
                        border_mode="mirror")

    # -- 3d. K3 block top-K ---------------------------------------------------
    bs, kdet = slam_cfg.tracker.keypoint_spacing, slam_cfg.tracker.detect_k
    simg = F.fast9_score_image(sframe, slam_cfg.tracker.detector_th)
    reset_launch_counts()
    k3_out = F._blockwise_keypoints(simg, bs, kdet)
    check(launch_counts()["block_topk"] == 1, "K3 is not one launch a call")
    k3_plain = F._blockwise_keypoints_plain(simg, bs, kdet)
    check(all(torch.equal(a, b) for a, b in zip(k3_out, k3_plain)),
          "K3 block top-K differs from its plain version (640x480)")
    rng = np.random.RandomState(3)

    def score_image(h, w, kind):
        if kind == "random":
            a = rng.randint(1, 256, (h, w)) * (rng.rand(h, w) > 0.5)
        else:   # three scores: long runs of ties across the CTAs' ranges
            a = rng.choice([0, 0, 7, 200], (h, w))
        return from_array(torch.from_numpy(a.astype(np.uint8)).to(dev),
                          border=1)

    k3_sizes = {}
    for h, w, b3, kind in ((400, 400, 2, "random"), (400, 400, 2, "ties"),
                           (2160, 3840, 10, "random"),
                           (2160, 3840, 10, "ties")):
        big = score_image(h, w, kind)
        nb3 = -(-h // b3) * -(-w // b3)
        for dt in (torch.uint8, torch.int32):
            img3 = from_array(big.interior.to(dt), border=1)
            check(all(torch.equal(a, b) for a, b in zip(
                F._blockwise_keypoints(img3, b3, 4096),
                F._blockwise_keypoints_plain(img3, b3, 4096))),
                  f"K3 differs from its plain version at {nb3} blocks "
                  f"({kind}, {dt})")
        if kind == "random":
            k3_sizes[f"device_ms_{nb3}_blocks"] = device_ms(
                torch, lambda big=big, b3=b3: F._blockwise_keypoints(
                    big, b3, 4096))[0]
    nbr, nbc = -(-H // bs), -(-W // bs)
    nb = nbr * nbc
    pad_scores = PY.pad2d(simg.interior.to(torch.int32), 0, nbr * bs - H, 0,
                          nbc * bs - W, "constant", -1)
    keys = torch.randint(-nb, 255 * nb, (nb,), dtype=torch.int32, device=dev)

    def k3_library():
        pad_scores.view(nbr, bs, nbc, bs).permute(0, 2, 1, 3).reshape(
            nbr, nbc, bs * bs).argmax(-1)
        torch.topk(keys, kdet, sorted=True)

    results["block_topk"] = dict(
        name="block_topk", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/block_topk.cu",
        replaces="vpp_tpu/algorithms/fast.py:185", max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: F._blockwise_keypoints(simg, bs, kdet),
                   200),
        plain_ms=cuda_ms(torch, lambda: F._blockwise_keypoints_plain(
            simg, bs, kdet), 50),
        library_ms=cuda_ms(torch, k3_library, 50))
    results["block_topk"]["bound_ms"], results["block_topk"]["bound_by"] = \
        bound_ms(simg.data.numel() + kdet * 13, H * W + nb)
    results["block_topk"]["device_ms"], \
        results["block_topk"]["device_ms_by"] = device_ms(
            torch, lambda: F._blockwise_keypoints(simg, bs, kdet))
    results["block_topk"]["library_device_ms"] = device_ms(torch,
                                                           k3_library)[0]
    results["block_topk"].update(k3_sizes)
    print(f"phase 3: K3 block top-K bit-equal, one launch a call "
          f"({int(k3_out[2].sum())} valid of {kdet}; and at 40000 and 82944 "
          f"blocks, random and tied scores, uint8 and int32), "
          f"{results['block_topk']['ms']:.4f} ms as called, "
          f"{results['block_topk']['device_ms']:.4f} ms on the device at "
          f"{nb} blocks; " + ", ".join(f"{k} {v:.4f}"
                                       for k, v in k3_sizes.items()))

    # -- 3e. K4: the whole pyramid from the raw frame in one launch -------
    shapes3 = level_shapes((H, W), 3)
    k4_err = 0.0
    rng4 = np.random.RandomState(4)
    for hh, ww in ((H, W), (357, 493)):
        shp = level_shapes((hh, ww), 3)
        for kind in ("integer", "float"):
            a = torch.from_numpy(
                rng4.randint(0, 256, (hh, ww)).astype(np.float32)
                if kind == "integer" else
                slam_frames[100] if (hh, ww) == (H, W) else
                (rng4.rand(hh, ww) * 255 + 1).astype(np.float32)).to(dev)
            want = PY.pyramid_plain(a, shp, sb)
            for src in ("raw", "bordered"):
                src_img = (Image2d(data=a, border=0) if src == "raw" else
                           from_array(a, border=sb, border_mode="mirror"))
                reset_launch_counts()
                got = pyramid(src_img, 3, border=sb)
                check(launch_counts()["pyramid_decim"] == 1,
                      f"K4 is not one launch a pyramid ({hh}x{ww}, {src})")
                for lvl, (g, wl) in enumerate(zip(got.levels, want)):
                    if kind == "integer":
                        check(torch.equal(g.data, wl.data),
                              f"K4 not bit-equal on integer frames at level "
                              f"{lvl} ({hh}x{ww}, {src})")
                        continue
                    rel = float(((g.data - wl.data).abs()
                                 / wl.data.abs().clamp(min=1e-30)).max())
                    check(rel <= 1e-6, f"K4 off by {rel} relative at level "
                          f"{lvl} ({hh}x{ww}, {src})")
                    k4_err = max(k4_err, float((g.data - wl.data).abs()
                                               .max()))
    raw = torch.from_numpy(slam_frames[100]).to(dev)
    raw_img = Image2d(data=raw, border=0)
    decim_mats = [(PY._decim_tensor(ph, oh, dev), PY._decim_tensor(pw, ow, dev))
                  for (ph, pw), (oh, ow) in zip(shapes3, shapes3[1:])]
    pad_idx = [(pad_index(oh, sb, sb, "symmetric", dev),
                pad_index(ow, sb, sb, "symmetric", dev))
               for oh, ow in shapes3]

    def k4_call():
        return pyramid(raw_img, 3, border=sb)

    def k4_library():
        """The PyTorch route: the index_select pad pair (index tensors made
        beforehand), and per level the banded matmul pair and the pad."""
        ri, ci = pad_idx[0]
        raw.index_select(0, ri).index_select(1, ci)
        cur = raw
        for (a, bm), (ri, ci) in zip(decim_mats, pad_idx[1:]):
            cur = a @ cur @ bm.T
            cur.index_select(0, ri).index_select(1, ci)

    def k4_parent_route():
        """The run loops' route before this kernel took the raw frame: the
        frame image (``from_array``), level 0 padded again, and one K4
        launch a level."""
        f = from_array(raw, border=sb, border_mode="mirror")
        lvl = Image2d(data=PY.pad2d(f.interior, sb, sb, sb, sb, "symmetric"),
                      border=sb)
        for oh, ow in shapes3[1:]:
            lvl = PY.decimate_level(lvl, oh, ow, sb)

    k4_bytes = 4 * (H * W + sum((oh + 2 * sb) * (ow + 2 * sb)
                                for oh, ow in shapes3))
    k4_ops = sum(2 * 5 * oh * (pw + ow)
                 for (ph, pw), (oh, ow) in zip(shapes3, shapes3[1:]))
    results["pyramid_decim"] = dict(
        name="pyramid_decim", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/pyramid_decim.cu",
        replaces="vpp_tpu/algorithms/pyramid.py:171",
        per="pyramid of a raw 640x480 frame, 3 levels, border 9",
        max_abs_err=k4_err, ms=cuda_ms(torch, k4_call, 200),
        plain_ms=cuda_ms(torch, lambda: PY.pyramid_plain(raw, shapes3, sb),
                         50),
        library="index_select pads and banded torch.matmul pairs",
        library_ms=cuda_ms(torch, k4_library, 50),
        parent_route="from_array, a second pad of level 0, one K4 launch a "
                     "level",
        parent_route_ms=cuda_ms(torch, k4_parent_route, 200),
        device_ops=sum(device_kernels(torch, k4_call).values()),
        parent_route_device_ops=sum(device_kernels(
            torch, k4_parent_route).values()))
    r4 = results["pyramid_decim"]
    r4["bound_ms"], r4["bound_by"] = bound_ms(k4_bytes, k4_ops)
    r4["device_ms"], r4["device_ms_by"] = device_ms(torch, k4_call)
    r4["library_device_ms"] = device_ms(torch, k4_library)[0]
    r4["parent_route_device_ms"] = device_ms(torch, k4_parent_route)[0]
    check(r4["device_ops"] == 1, f"K4's pyramid ran {r4['device_ops']} "
          "device operations, not one kernel")
    print(f"phase 3: K4 whole pyramid one launch, bit-equal on integer "
          f"frames (640x480 and 357x493, raw and bordered), float err "
          f"{k4_err:.3g}; {r4['ms']:.4f} ms as called, "
          f"{r4['device_ms']:.4f} ms on the device (bound "
          f"{r4['bound_ms']:.5f}); the library route "
          f"{r4['library_device_ms']:.4f} on the device; the parent's route "
          f"({r4['parent_route_device_ops']} device ops) "
          f"{r4['parent_route_ms']:.4f} ms as called, "
          f"{r4['parent_route_device_ms']:.4f} on the device")

    # -- 3f. K5 patches, from centres ----------------------------------------
    psize = slam_cfg.desc_patch
    ctr64 = torch.from_numpy(np.stack(
        [rng.randint(-4, H + 4, 1024), rng.randint(-4, W + 4, 1024)],
        -1)).to(dev) + sb
    ctr = ctr64.to(torch.int32)       # the SLAM path's centres are int32
    hb, wb = sframe.data.shape
    tl = IP._clamp_tl(ctr64 - psize // 2, hb, wb, psize)
    want = IP.extract_patches_at_tl_plain(sframe.data, tl, psize)
    for c in (ctr, ctr64):
        reset_launch_counts()
        got = IP.extract_patches(sframe.data, c, psize)
        check(launch_counts()["patches"] == 1,
              "K5 is not one launch a call")
        check(torch.equal(got, want) and torch.equal(
            IP.extract_patches_plain(sframe.data, c, psize), want),
              f"K5 patches differ from the plain version (1024 x 7x7, "
              f"{c.dtype} centres)")
    rgb = torch.from_numpy(rng.randint(0, 256, (hb, wb, 3)).astype(
        np.uint8)).to(dev)
    check(torch.equal(IP.extract_patches(rgb, ctr, psize),
                      IP.extract_patches_at_tl_plain(rgb, tl, psize)),
          "K5 patches differ from the plain version (3 channels)")
    ar = torch.arange(psize, device=dev)

    def k5_index():
        """The library call's index preparation from the same centres."""
        t = IP._clamp_tl(ctr.long() - psize // 2, hb, wb, psize)
        return (t[:, 0, None] + ar)[:, :, None], (t[:, 1, None] + ar)[:, None,
                                                                      :]

    rows, cols = k5_index()

    def k5_library():
        r, c = k5_index()
        return sframe.data[r, c]

    k5_call = lambda: IP.extract_patches(sframe.data, ctr, psize)  # noqa: E731
    results["patches"] = dict(
        name="patches", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/patches.cu",
        replaces="vpp_tpu/core/interp.py:61", max_abs_err=0.0,
        ms=cuda_ms(torch, k5_call, 200),
        plain_ms=cuda_ms(torch, lambda: IP.extract_patches_plain(
            sframe.data, ctr, psize), 50),
        library="advanced indexing from the same centres (index "
                "preparation and gather)",
        library_ms=cuda_ms(torch, k5_library, 200),
        library_index_ms=cuda_ms(torch, k5_index, 200),
        library_gather_ms=cuda_ms(torch, lambda: sframe.data[rows, cols],
                                  200))
    results["patches"]["bound_ms"], results["patches"]["bound_by"] = \
        bound_ms(1024 * (8 + 2 * 4 * psize * psize), 0)
    results["patches"]["device_ms"], results["patches"]["device_ms_by"] = \
        device_ms(torch, k5_call)
    results["patches"]["library_device_ms"] = device_ms(torch,
                                                        k5_library)[0]
    results["patches"]["library_gather_device_ms"] = device_ms(
        torch, lambda: sframe.data[rows, cols])[0]
    k5 = results["patches"]
    print(f"phase 3: K5 patches bit-equal from int32 and int64 centres, one "
          f"launch a call (1024 x {psize}x{psize}, and 3 channels); "
          f"{k5['ms']:.4f} ms as called, {k5['device_ms']:.4f} ms on the "
          f"device; the library from the same centres {k5['library_ms']:.4f} "
          f"ms as called (index preparation {k5['library_index_ms']:.4f}, "
          f"gather {k5['library_gather_ms']:.4f}), "
          f"{k5['library_device_ms']:.4f} ms on the device")

    # -- 3g. K6 window BA, on a keyframe problem of a SLAM warm-up run --------
    slam_dev = torch.from_numpy(slam_frames).to(dev)  # upload outside timing
    boot = gt_poses[[0, slam_cfg.keyframe_period]]
    problems = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        problems.append(prob)
        return solve(prob, **kw)

    SP.ba_solve_tracks = capture
    try:
        warm = SP.slam_run(slam_dev[:SLAM_WARMUP], slam_cfg,
                           bootstrap_poses=boot, device="cuda")
    finally:
        SP.ba_solve_tracks = solve
    torch.cuda.synchronize()

    # K2's score image on the next SLAM frame, with the warm-up's occupancy
    # mask (the detection of the SLAM step)
    tcfg = slam_cfg.tracker
    occ = VE._occupancy_mask(warm.tracker.keypoints, (H, W),
                             tcfg.keypoint_spacing)
    nframe = from_array(slam_dev[SLAM_WARMUP], border=sb,
                        border_mode="mirror")
    reset_launch_counts()
    si_k = F.fast9_score_image(nframe, tcfg.detector_th, mask=occ)
    check(launch_counts()["fast9"] == 1, "K2's score image is not one launch")
    si_p = F.fast9_score_image_plain(nframe, tcfg.detector_th, mask=occ)
    check(si_k.border == 1 and torch.equal(si_k.data, si_p.data),
          "K2's score image differs from its plain version")
    # and on the textured tracker frame of 3a, with no mask and a bool mask
    rmask = torch.from_numpy(rng.rand(H, W) > 0.3).to(dev)
    for m in (None, rmask):
        check(torch.equal(F.fast9_score_image(img, th, mask=m).data,
                          F.fast9_score_image_plain(img, th, mask=m).data),
              "K2's score image differs from its plain version on the "
              "tracker frame")
    k2_time("score_image",
            lambda: F.fast9_score_image(nframe, tcfg.detector_th, mask=occ),
            lambda: F.fast9_score_image_plain(nframe, tcfg.detector_th,
                                              mask=occ),
            nframe.data.numel() * 4 + H * W + (H + 2) * (W + 2),
            k2_pixel_ops)
    print(f"phase 3: K2 score image bit-equal with the SLAM frame's "
          f"occupancy mask ({int(occ.sum())} of {H * W} pixels open, "
          f"{int(si_k.data.count_nonzero())} scores), one launch; "
          f"{k2['ms_per_mode']['score_image']:.4f} ms as called, "
          f"{k2['device_ms_per_mode']['score_image']:.4f} on the device "
          f"(bound {k2['bound_ms_per_mode']['score_image']:.5f})")
    prob = problems[-1]
    n_lm, m_kf = prob.obs_valid.shape
    iters, lam0 = slam_cfg.ba_iters, slam_cfg.ba_lam0
    huber, linalg = slam_cfg.ba_huber, slam_cfg.ba_linalg
    fixed = prob.fixed_poses

    def k6_check(pr, lam_0, what):
        """One fused call on ``pr``: one launch, the same bits twice, its
        trace's first-iteration system against the plain assembly, its
        first pose solve's backward error, and the result against the plain
        LM loop. Returns (numbers, trace)."""
        reset_launch_counts()
        out = BC.lm_tracks(pr, iters, huber, lam_0, linalg)
        check(launch_counts()["ba_tracks"] == 1,
              f"K6 ({what}) is not one launch a call")
        again = BC.lm_tracks(pr, iters, huber, lam_0, linalg)
        check(all(same_bits(torch, a, b) for a, b in zip(
            out[:3] + tuple(out[3]), again[:3] + tuple(again[3]))),
              f"K6 ({what}) is not bit-identical across two launches")
        poses, lms, costs, tr = out
        lam = torch.full((), lam_0, device=dev)
        (Sp, rp, cp), _ = BA._tracks_assemble(pr, lam, huber, True, linalg)
        s_rel = float((tr.S - Sp).abs().max()) / float(Sp.abs().max())
        c_rel = float((tr.cost - cp).abs()) / float(cp.abs())
        r_rel = float((tr.rhs - rp).abs().max()) / BA.rhs_term_scale(
            pr, huber, True)
        check(s_rel <= 1e-4 and c_rel <= 1e-4 and r_rel <= 1e-4,
              f"K6 ({what}) assembly off the plain one: S {s_rel}, rhs "
              f"{r_rel} of its terms, cost {c_rel}")
        # the first pose solve on the kernel's own system: the backward
        # error of the Jacobi-scaled solve in float64, and dp against the
        # plain solve (cuSOLVER) of the same system
        D = 6 * m_kf
        Sd = tr.S.reshape(D, D).double() + lam_0 * torch.eye(
            D, dtype=torch.float64, device=dev)
        fx = fixed[:, None].expand(m_kf, 6).reshape(-1)
        Sd = torch.where(fx[:, None] | fx[None, :], torch.eye(
            D, dtype=torch.float64, device=dev), Sd)
        rhs_g = torch.where(fx, 0.0, tr.rhs.reshape(-1).double())
        d = Sd.diagonal().clamp(min=1e-12).rsqrt()
        Sps, y = Sd * d[:, None] * d[None, :], tr.dp[0].reshape(-1) / d
        dp_plain = BA._tracks_solve_poses(tr.S, tr.rhs, fixed, lam, linalg)
        failed = bool(torch.isnan(tr.dp[0]).all())
        if failed:
            back_err = dp_err = float("nan")
            check(bool(torch.isnan(dp_plain).all()),
                  f"K6 ({what}): the kernel's pose solve failed, the plain "
                  "one did not")
        else:
            back_err = float((Sps @ y - d * rhs_g).abs().max() / (
                Sps.abs().sum(1).max() * y.abs().max()
                + (d * rhs_g).abs().max()))
            dp_err = float((tr.dp[0] - dp_plain).abs().max()
                           / dp_plain.abs().max())
            check(back_err <= 1e-5, f"K6 ({what}) pose solve backward error "
                  f"{back_err}")
        sp_, cp_ = BA._lm_tracks(pr, iters, huber, lam_0, True, linalg,
                                 kernel=False)
        sk = pr._replace(poses=poses, landmarks=lms)
        pose_err = float((poses - sp_.poses).abs().max())
        lm_err = float((lms - sp_.landmarks).abs().max())
        # landmarks in the metric of their observations: the depth of a
        # point seen with little parallax is not determined by the window,
        # and there a 1e-7 change of the poses moves it along its ray by
        # orders more without moving any of its reprojections
        reproj_err = float((BA.track_residuals(sk, True) - BA.track_residuals(
            sk._replace(landmarks=sp_.landmarks), True)).abs().max())
        cost_err = float((costs - cp_).abs().max() / cp_.abs().max())
        check(pose_err <= 1e-4 and reproj_err <= 1e-3 and cost_err <= 1e-4,
              f"K6 ({what}) LM solve off the plain one: poses {pose_err}, "
              f"landmark reprojections {reproj_err} px, costs {cost_err}")
        check(torch.equal(costs, torch.where(tr.accept != 0, tr.cost_after,
                                             tr.cost_before)),
              f"K6 ({what}): costs are not the accepted ones")
        return dict(S_rel_err=s_rel, rhs_err_of_terms=r_rel,
                    cost_rel_err=c_rel, pose_solve_backward_err=back_err,
                    dp_rel_err_vs_plain_solve=dp_err, lm_pose_err=pose_err,
                    lm_landmark_err=lm_err, lm_reprojection_err_px=reproj_err,
                    lm_cost_rel_err=cost_err,
                    accept=[float(a) for a in tr.accept.cpu()]), tr

    k6_main, tr_main = k6_check(prob, lam0, "warm-up window")
    # every step rejected: the first free pose's observations displaced
    # 2000 px, then one plain LM step; from there each candidate costs ~40%
    # more (a CPU run of this window), and lam grows
    free = int(torch.nonzero(~fixed)[0])
    uv6 = prob.obs_uv.clone()
    uv6[:, free] += 2000.0
    rej, _ = BA._lm_tracks(prob._replace(obs_uv=uv6), 1, huber, 1e-8, True,
                           linalg, kernel=False)
    k6_rej, tr_rej = k6_check(rej, 1e-8, "rejected")
    check(not bool((tr_rej.accept != 0).any())
          and bool((tr_rej.lam[1:] > tr_rej.lam[:-1]).all())
          and bool((tr_rej.cost_before == tr_rej.cost).all()),
          "K6: the rejected-step case accepted a step")
    # the pose factorisation fails: no damping and no observation of the
    # first free pose, so S has a zero row and column and dp is NaN
    valid6 = prob.obs_valid.clone()
    valid6[:, free] = False
    k6_fail, tr_fail = k6_check(prob._replace(obs_valid=valid6), 0.0,
                                "failed factorisation")
    check(not bool((tr_fail.accept != 0).any())
          and bool(torch.isnan(tr_fail.dp).all()),
          "K6: the failed-factorisation case took a step")

    # no iteration: the problem back unchanged, empty costs, no launch
    reset_launch_counts()
    s0, c0 = BA.ba_solve_tracks(prob, iters=0, huber=huber, lam0=lam0,
                                ring_layout=True, linalg=linalg)
    check(launch_counts()["ba_tracks"] == 0 and tuple(c0.shape) == (0,)
          and same_bits(torch, s0.poses, prob.poses)
          and same_bits(torch, s0.landmarks, prob.landmarks),
          "K6's route at iters=0 does not return its problem unchanged")

    def k6_call():
        return BA.ba_solve_tracks(prob, iters=iters, huber=huber, lam0=lam0,
                                  ring_layout=True, linalg=linalg)

    def k6_plain():
        return BA._lm_tracks(prob, iters, huber, lam0, True, linalg,
                             kernel=False)

    # per iteration, each part at its rate and the sum expressed in float32
    # operations: float32 Jacobians (~60 operations an observation); the
    # scalar float64 landmark algebra (~486 an observation); the Schur
    # product W_k U_l^T (216 a pair of observations of one landmark, k <= l:
    # S is symmetric) on the float64 tensor cores; the (6M)^3 / 3 of the
    # float32 pose factorisation
    cnt = prob.obs_valid.sum(1).double()
    D = 6 * m_kf
    k6_ops = iters * float(
        60 * cnt.sum() + D ** 3 / 3
        + 486 * cnt.sum() * SCALAR_OPS_PER_S / FP64_OPS_PER_S
        + 216 * (cnt * (cnt + 1) / 2).sum()
        * SCALAR_OPS_PER_S / FP64_MMA_OPS_PER_S)
    k6_bytes = (4 * (2 * m_kf * 16 + n_lm * 3 * 2 + n_lm * m_kf * 2 + 4
                     + iters + D * D + D + 1 + iters * (D + 4))
                + n_lm * m_kf + m_kf)
    results["ba_tracks"] = dict(
        name="ba_tracks", route="cuda",
        source="vpp_tpu_torch/kernels/csrc/ba_tracks.cu",
        replaces="vpp_tpu/slam/ba.py:568", per="ba_solve_tracks call",
        max_abs_err=float(k6_main["lm_pose_err"]), **k6_main,
        rejected_case=k6_rej, failed_case=k6_fail,
        problem=dict(n=n_lm, m=m_kf, iters=iters, obs=int(cnt.sum()),
                     seen_once=int((cnt == 1).sum())),
        ms=cuda_ms(torch, k6_call, 100), plain_ms=cuda_ms(torch, k6_plain, 20),
        library_ms=None)
    results["ba_tracks"]["bound_ms"], results["ba_tracks"]["bound_by"] = \
        bound_ms(k6_bytes, k6_ops)
    results["ba_tracks"]["device_ms"], \
        results["ba_tracks"]["device_ms_by"] = device_ms(torch, k6_call)
    print(f"phase 3: K6 window BA on keyframe {len(problems)} of the warm-up "
          f"(N {n_lm}, M {m_kf}, {int(cnt.sum())} observations, {iters} "
          f"iterations in one launch): S off by {k6_main['S_rel_err']:.3g}, "
          f"rhs {k6_main['rhs_err_of_terms']:.3g} of its terms, cost "
          f"{k6_main['cost_rel_err']:.3g}; pose solve backward error "
          f"{k6_main['pose_solve_backward_err']:.3g} (dp off cuSOLVER's by "
          f"{k6_main['dp_rel_err_vs_plain_solve']:.3g}); bit-identical twice; "
          f"LM poses {k6_main['lm_pose_err']:.3g}, landmarks "
          f"{k6_main['lm_landmark_err']:.3g} "
          f"({k6_main['lm_reprojection_err_px']:.3g} px in their "
          f"observations), accepts {k6_main['accept']}; rejected-step and "
          f"failed-factorisation cases agree with the plain loop; iters=0 "
          f"returns the problem unchanged with no launch; per call "
          f"{results['ba_tracks']['ms']:.4f} ms as called, "
          f"{results['ba_tracks']['device_ms']:.4f} ms on the device, bound "
          f"{results['ba_tracks']['bound_ms']:.5f} ms")

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
    check(track_counts["flow_level"] == 2 * cfg.nscales * TRACK_FRAMES,
          "the tracker did not launch K1 twice per level and frame")
    check(track_counts["pyramid_decim"] == TRACK_FRAMES + 1,
          f"the tracker launched K4 {track_counts['pyramid_decim']} times, "
          f"not {TRACK_FRAMES + 1} (one pyramid a frame, and the first's)")
    k2_track = TRACK_FRAMES + -(-TRACK_FRAMES // cfg.detector_period)
    check(track_counts["fast9"] == k2_track,
          f"the tracker launched K2 {track_counts['fast9']} times, not "
          f"{k2_track} (one cull a frame, one score image a detection)")
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
    check(hough_counts["hough_acc"] == HOUGH_FRAMES,
          f"the Hough path launched K7 {hough_counts['hough_acc']} times, "
          f"not once a frame")
    cst = hough_tracker_init(hcfg, device="cpu")
    for f in lines:
        cst, _ = hough_tracker_update(
            cst, from_array(f, border=3, border_mode="mirror"), hcfg)
    same = (torch.equal(hst.age.cpu(), cst.age)
            and torch.equal(hst.theta.cpu(), cst.theta)
            and torch.equal(hst.rho.cpu(), cst.rho))
    check(same, "Hough tracks differ from the plain CPU path")

    # -- 6. SLAM tracking+BA path ---------------------------------------------
    kf_states = {}
    do_kf = SP._do_keyframe

    def keep_state(state, frame2, cfg_, **kw):
        if state.n_keyframes == SLAM_CHECK_KF:
            kf_states["state"], kf_states["frame"] = state, frame2
        return do_kf(state, frame2, cfg_, **kw)

    torch.cuda.synchronize()
    SP._do_keyframe = keep_state
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        sst = SP.slam_run(slam_dev, slam_cfg, bootstrap_poses=boot,
                          device="cuda")
        torch.cuda.synchronize()
        slam_dt = time.perf_counter() - t0
        slam_counts = launch_counts()
    finally:
        SP._do_keyframe = do_kf
    slam_fps = SLAM_FRAMES / slam_dt
    est, fids = SP.keyframe_trajectory(sst)
    slam_ate = float(SP.ate_rmse(est.cpu(), torch.from_numpy(
        gt_poses[fids.cpu().numpy()])))
    slam_lms = int(sst.lm_valid.sum())
    slam_live = int(sst.tracker.keypoints.alive.sum())
    print(f"phase 6: SLAM {W}x{H}: {slam_fps:.2f} frames/s over "
          f"{SLAM_FRAMES} frames, {sst.n_keyframes} keyframes, {slam_lms} "
          f"landmarks, {slam_live} live keypoints, ATE {slam_ate:.4f}; "
          f"launches {slam_counts}")
    for key in ("flow_level", "fast9", "block_topk", "pyramid_decim",
                "patches", "ba_tracks"):
        check(slam_counts[key] > 0, f"the SLAM path did not launch {key}")
    check(sst.n_keyframes == SLAM_FRAMES // slam_cfg.keyframe_period,
          f"{sst.n_keyframes} keyframes, expected 60")
    check(slam_counts["ba_tracks"] == sst.n_keyframes,
          f"K6 launched {slam_counts['ba_tracks']} times, not once a keyframe")
    check(slam_counts["pyramid_decim"] == SLAM_FRAMES + 1,
          f"K4 launched {slam_counts['pyramid_decim']} times, not "
          f"{SLAM_FRAMES + 1} (one pyramid a frame, and the first's)")
    check(slam_counts["block_topk"] == SLAM_FRAMES,
          f"K3 launched {slam_counts['block_topk']} times, not once a frame")
    check(slam_counts["fast9"] == 2 * SLAM_FRAMES,
          f"K2 launched {slam_counts['fast9']} times, not twice a frame")
    check(slam_counts["patches"] == sst.n_keyframes,
          f"K5 launched {slam_counts['patches']} times, not once a keyframe")
    check(slam_lms > 200, f"only {slam_lms} landmarks")
    check(slam_ate < 0.10, f"SLAM ATE {slam_ate} >= 0.10")
    check(bool(torch.isfinite(est).all()), "non-finite keyframe poses")

    # the back end alone, from one state on both devices
    kst, kframe = kf_states["state"], kf_states["frame"]
    cst = convert.slam_state_from_numpy(convert.slam_state_to_numpy(kst),
                                        device="cpu")
    ckf = SP._do_keyframe(cst, Image2d(data=kframe.data.cpu(),
                                       border=kframe.border), slam_cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gkf = SP._do_keyframe(kst, kframe, slam_cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kf_err = float((gkf.kf_pose.cpu() - ckf.kf_pose).abs().max())
    lm_agree = float((gkf.lm_valid.cpu() == ckf.lm_valid).double().mean())
    print(f"phase 6: keyframe {SLAM_CHECK_KF} from one state: card and plain "
          f"CPU poses within {kf_err:.3g}, lm_valid agrees on "
          f"{100 * lm_agree:.2f}% of slots; the card's call made no host "
          "synchronisation")
    check(kf_err <= 1e-3, f"keyframe poses differ by {kf_err}")
    check(lm_agree >= 0.99, f"lm_valid agrees on only {lm_agree}")

    # the whole path, card against the plain CPU path
    ga = SP.slam_run(slam_dev[:SLAM_CPU_FRAMES], slam_cfg,
                     bootstrap_poses=boot, device="cuda")
    ca = SP.slam_run(slam_frames[:SLAM_CPU_FRAMES], slam_cfg,
                     bootstrap_poses=boot, device="cpu")

    def ate_of(st):
        e, f = SP.keyframe_trajectory(st)
        return float(SP.ate_rmse(e.cpu(), torch.from_numpy(
            gt_poses[f.cpu().numpy()])))

    g_lm, c_lm = int(ga.lm_valid.sum()), int(ca.lm_valid.sum())
    g_ate, c_ate = ate_of(ga), ate_of(ca)
    print(f"phase 6: first {SLAM_CPU_FRAMES} frames: card {ga.n_keyframes} "
          f"keyframes, {g_lm} landmarks, ATE {g_ate:.4f}; plain CPU "
          f"{ca.n_keyframes}, {c_lm}, {c_ate:.4f}")
    check(ga.n_keyframes == ca.n_keyframes, "keyframe counts differ")
    check(abs(g_lm - c_lm) <= 0.05 * max(c_lm, 1),
          "landmark counts differ by more than 5%")
    check(abs(g_ate - c_ate) <= 0.02, "ATE differs by more than 0.02")

    # -- 7. results -----------------------------------------------------------
    launches = {"fast9": track_counts["fast9"],
                "flow_level": track_counts["flow_level"],
                "hough_acc": hough_counts["hough_acc"]}
    per_frame = {"fast9": track_counts["fast9"] / TRACK_FRAMES,
                 "flow_level": track_counts["flow_level"] / TRACK_FRAMES,
                 "hough_acc": hough_counts["hough_acc"] / HOUGH_FRAMES}
    for key in ("block_topk", "pyramid_decim", "patches", "ba_tracks"):
        launches[key] = slam_counts[key]
        per_frame[key] = slam_counts[key] / SLAM_FRAMES
    kernels = []
    for key in ("flow_level", "fast9", "hough_acc", "block_topk",
                "pyramid_decim", "patches", "ba_tracks"):
        r = results[key]
        r["launches"] = launches[key]
        r["launches_per_frame"] = per_frame[key]
        kernels.append(r)
    print(json.dumps({"tracker_fps": fps, "tracker_live": live,
                      "hough_ms_per_frame": hough_ms, "slam_fps": slam_fps,
                      "slam_ate": slam_ate, "slam_landmarks": slam_lms,
                      "slam_keyframes": sst.n_keyframes,
                      "slam_launches": slam_counts, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
