#!/usr/bin/env python3
"""Device time of the SLAM keyframe's whole window-BA call (K6,
``ba_solve_tracks``), of the SLAM frame's block top-K call (K3,
``_blockwise_keypoints``), of a frame's pyramid as the run loops build it
(K4), of the Hough accumulator (K7) and of a keyframe's archive PnP (K8's
caller), on one CUDA card, for this checkout or against another one.

    python3 call_times.py                   # this checkout
    python3 call_times.py --compare DIR     # DIR's checkout against this
    python3 call_times.py --slice-c [--compare DIR]   # K10's, K11's callers

The BA problem is the last keyframe window of a 24-frame warm-up of
``chip_smoke.py``'s SLAM configuration (640x480, ring 6, 3 LM iterations,
"chol"), made by the plain CPU path so that every checkout gets the same
bits; the K3 input is the FAST score image of that warm-up's last frame
(3072 blocks of 10 px), and a random 4K score image (82944 blocks; null
where the checkout refuses it). K3's host time a call is also broken down
(``block_topk_host_us``: the whole wrapper, its checks, allocations,
stream query and C entry, host clock over 500 calls that only enqueue).
The pyramid is that frame's, 3 levels with border 9, by both routes a run
loop has taken: the frame image (``from_array``, mirror) then ``pyramid``
of it (``frame_pyramid_*``), and ``pyramid`` of the unbordered frame
(``raw_pyramid_*``); each with its device time, its device operations
under the profiler and its K4 launches. Where the checkout's K4 can take
level 2 after a grid barrier instead of from the frame (``_k4``'s
``fuse``), the raw frame's pyramid is also timed both ways, fused,
barrier, barrier, fused (``k4_fused_device_ms``, ``k4_barrier_device_ms``),
after a check that both give the same bits. K7's input is the vote vectors of
the 640x480 two-line Hough clip's frame 5 (``hough_acc_*``: device time,
as called, device operations). The archive PnP (K8's caller, with FAST and
the patches) runs on the warm-up's last keyframe state at the full
engine's configuration (``archive_pnp_*``), with K8's device time split
by rounds and PnP iterations where the checkout has ``map_vote_pnp``.
Each measurement prints one JSON line:
``device_ms`` (CUDA events around replays of a CUDA graph of 20 calls, or
the profiler's device time where capture is refused, as ``chip_smoke.py``
times its kernels), the as-called ``ms`` (CUDA events around the Python
calls), and the device kernels one BA call runs (``torch.profiler``).
``--compare`` measures DIR, this checkout, this checkout, DIR, each in its
own process, and prints the card's name and power limit first.
``--slice-c`` measures only ``slice_c``: ``lucas_kanade``, ``pyrlk_match``
and ``euclidean_distance_transform`` at ``chip_smoke.py`` phase 12's
workloads, with K10's own launches of one ``lucas_kanade`` call (one
launch a level, or the whole pass in one, as the checkout has it).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WARMUP = 24


def make_problem(path: str) -> None:
    """Save the warm-up's last window and score images, from the plain CPU
    path."""
    import numpy as np
    import torch
    import chip_smoke as CS
    from vpp_tpu_torch.algorithms import fast as F
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.slam import pipeline as SP
    cfg = CS.slam_config()
    clip, gt = CS.slam_clip(WARMUP)
    problems, keyframes = [], []
    solve, do_kf = SP.ba_solve_tracks, SP._do_keyframe

    def capture(prob, **kw):
        problems.append(prob)
        return solve(prob, **kw)

    def keep(state, frame2, cfg_, **kw):
        keyframes.append((state, frame2))
        return do_kf(state, frame2, cfg_, **kw)

    SP.ba_solve_tracks, SP._do_keyframe = capture, keep
    try:
        SP.slam_run(clip, cfg, bootstrap_poses=gt[[0, cfg.keyframe_period]],
                    device="cpu")
    finally:
        SP.ba_solve_tracks, SP._do_keyframe = solve, do_kf
    from vpp_tpu_torch import convert
    kf_state, kf_frame = keyframes[-1]
    frame = from_array(torch.from_numpy(clip[-1]),
                       border=max(3, cfg.tracker.winsize),
                       border_mode="mirror")
    scores = F.fast9_score_image(frame, cfg.tracker.detector_th)
    rng = np.random.RandomState(3)
    big = rng.randint(1, 256, (2160, 3840)) * (rng.rand(2160, 3840) > 0.5)
    from vpp_tpu_torch.algorithms import hough as HG
    from vpp_tpu_torch.utils.clips import synthetic_line_clip
    himg = from_array(torch.from_numpy(synthetic_line_clip(640, 480, 6)[5]),
                      border=3, border_mode="mirror")
    t0i, r0i, ft, fr, wgt, rho_bins = HG._vote_bins(himg, 255, None, 40.0,
                                                    "binary", None)
    torch.save({"ba": tuple(problems[-1]), "scores": scores.data,
                "kf_state": _tensors(convert.slam_state_to_numpy(kf_state)),
                "kf_frame": kf_frame.data, "kf_border": kf_frame.border,
                "border": scores.border,
                "scores_4k": torch.from_numpy(big.astype(np.uint8)),
                "frame": torch.from_numpy(clip[-1]),
                "hough": ((t0i.float() + ft).reshape(-1),
                          (r0i.float() + fr).reshape(-1),
                          wgt.reshape(-1).contiguous(), 255, rho_bins)}, path)


def _tensors(m):
    """A ``state_to_numpy`` mapping with its arrays as tensors (what
    ``torch.load`` reads back by default)."""
    import numpy as np
    import torch
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)) for k, v in m.items()}


def archive_pnp(torch, CS, saved) -> dict:
    """The archive PnP of the warm-up's last keyframe (``_archive_pnp`` at
    the full engine's configuration: FAST, patches, both match sets' vote
    rounds, gates and PnPs): device time, as called, device operations and
    K8 launches a call. Where the checkout has K8 as ``map_vote_pnp``, also
    its device time on that call's operands with fewer rounds and no PnP
    iteration (``k8_device_ms_split``)."""
    import dataclasses
    from vpp_tpu_torch import convert
    from vpp_tpu_torch.core.image import Image2d
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.slam import pipeline as SP
    cfg = dataclasses.replace(CS.slam_config(), enable_recovery=True)
    st = convert.slam_state_from_numpy(saved["kf_state"], device="cuda")
    frame = Image2d(data=saved["kf_frame"].cuda(), border=saved["kf_border"])
    intr = torch.tensor(cfg.intrinsics, device="cuda")
    T0 = st.kf_pose[(st.n_keyframes - 1) % cfg.ring]

    def call():
        return SP._archive_pnp(st, frame, cfg, T0, intr, cfg.lc_min_gap)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    out = {"archive_pnp_map_vote_launches": launch_counts()["map_vote"],
           "archive_pnp_device_ms": CS.device_ms(torch, call, calls=5)[0],
           "archive_pnp_ms": CS.cuda_ms(torch, call, 20),
           "archive_pnp_device_ops": _device_ops(torch, CS, call)}
    if hasattr(SP, "map_vote_pnp"):
        kept, mvp = [], SP.map_vote_pnp

        def keep(*a, **kw):
            kept.append((a, kw))
            return mvp(*a, **kw)

        SP.map_vote_pnp = keep
        try:
            call()
        finally:
            SP.map_vote_pnp = mvp
        a, kw = kept[-1]
        out["k8_device_ms_split"] = {
            f"rounds{r}_iters{i}": CS.device_ms(torch, lambda: mvp(
                *a, **dict(kw, rounds=r, pnp_iters=i)))[0]
            for r, i in ((kw["rounds"], kw["pnp_iters"]),
                         (kw["rounds"], 0), (1, 0))}
    return out


def measure(root: str, path: str) -> dict:
    """Time ``ba_solve_tracks`` and ``_blockwise_keypoints`` of the checkout
    at ``root`` on the saved inputs."""
    import torch
    import chip_smoke as CS          # this checkout's, before the path moves
    sys.path.insert(0, root)
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.slam import ba as BA
    from vpp_tpu_torch.algorithms import fast as F
    from vpp_tpu_torch.core.image import Image2d, from_array
    cfg = CS.slam_config()
    saved = torch.load(path)
    prob = BA.BATracks(*(t.cuda() for t in saved["ba"]))

    def call():
        return BA.ba_solve_tracks(prob, iters=cfg.ba_iters, huber=cfg.ba_huber,
                                  lam0=cfg.ba_lam0, ring_layout=True,
                                  linalg=cfg.ba_linalg)

    call()
    torch.cuda.synchronize()
    reset_launch_counts()
    call()
    launches = launch_counts()["ba_tracks"]
    dev_ms, by = CS.device_ms(torch, call)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU
                  and CS._device_us(e) > 0)
    scores = Image2d(data=saved["scores"].cuda(), border=saved["border"])
    bs, kdet = cfg.tracker.keypoint_spacing, cfg.tracker.detect_k
    reset_launch_counts()
    F._blockwise_keypoints(scores, bs, kdet)
    k3 = {"block_topk_launches": launch_counts()["block_topk"],
          "block_topk_device_ms": CS.device_ms(
              torch, lambda: F._blockwise_keypoints(scores, bs, kdet))[0],
          "block_topk_ms": CS.cuda_ms(
              torch, lambda: F._blockwise_keypoints(scores, bs, kdet), 200)}
    k3["block_topk_host_us"] = host_breakdown(torch, scores, bs, kdet)
    big = from_array(saved["scores_4k"].cuda(), border=1)
    try:
        k3["block_topk_82944_blocks_device_ms"] = CS.device_ms(
            torch, lambda: F._blockwise_keypoints(big, 10, 4096))[0]
    except ValueError:      # a checkout that caps the block count
        k3["block_topk_82944_blocks_device_ms"] = None
    k4k7 = pyramid_and_hough(torch, CS, saved)
    k8 = archive_pnp(torch, CS, saved)
    import vpp_tpu_torch
    return {"root": root, "package": os.path.dirname(vpp_tpu_torch.__file__),
            "n": int(prob.landmarks.shape[0]), "m": int(prob.poses.shape[0]),
            "obs": int(prob.obs_valid.sum()), "iters": cfg.ba_iters,
            "device_ms": dev_ms, "device_ms_by": by,
            "ms": CS.cuda_ms(torch, call, 50),
            "ba_tracks_launches": launches, "device_kernels": kernels,
            **k3, **k4k7, **k8}


def slice_c(root: str) -> dict:
    """K10's and K11's callers at ``chip_smoke.py`` phase 12's workloads in
    the checkout at ``root``: ``lucas_kanade`` (1024 keypoints at 640x480,
    winsize 11, 3 levels), ``pyrlk_match`` on 4096 FAST slots, and
    ``euclidean_distance_transform`` at 960x540; each call's device and
    as-called ms and K10's or K11's launches, and K10's own device ms (its
    launches of one ``lucas_kanade`` call on the same pyramids)."""
    import numpy as np
    import torch
    import chip_smoke as CS          # this checkout's, before the path moves
    sys.path.insert(0, root)
    from vpp_tpu_torch.algorithms import distance_transform as DT
    from vpp_tpu_torch.algorithms import lk as LK
    from vpp_tpu_torch.algorithms.fast import fast9
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.core.keypoints import keypoints_from_positions
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    from vpp_tpu_torch.utils.clips import make_clip
    PY = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    dev = torch.device("cuda")
    i1, i2 = [from_array(torch.from_numpy(f).to(dev), border=9,
                         border_mode="mirror")
              for f in make_clip(CS.W, CS.H, 2, seed=0)]
    rng = np.random.RandomState(0)
    kp = torch.from_numpy((rng.rand(CS.SLICE_C_KP, 2)
                           * [CS.H - 20, CS.W - 20] + 10)
                          .astype(np.float32)).to(dev)
    pp, pn = PY.pyramid(i1, 3, border=5), PY.pyramid(i2, 3, border=5)
    pg = LK.gradient_pyramid(pp)
    if hasattr(LK, "lk_levels"):           # one launch a call
        def k10():
            LK.lk_levels([(pp[s], pn[s], pg[s]) for s in (2, 1, 0)],
                         [2, 1, 0], kp, torch.zeros_like(kp),
                         adopt="always", factor=2.0, **CS.LK_KW)
    else:                                  # one launch a level
        def k10():
            CS.lk_chain(torch, pp, pn, pg, kp, LK.lk_level)
    pos, _, valid = fast9(i1, 10, k=CS.PYRLK_SLOTS)
    kps = keypoints_from_positions(pos, valid)
    tp, tn = PY.pyramid(i1, 3, border=9), PY.pyramid(i2, 3, border=9)
    tg = LK.gradient_pyramid(tp)
    mask = torch.from_numpy(np.random.RandomState(0).rand(*CS.DT_SHAPE)
                            < 0.001).to(dev)
    calls = {"lucas_kanade": lambda: LK.lucas_kanade(i1, i2, kp, winsize=11,
                                                     nscales=3),
             "pyrlk_match": lambda: LK.pyrlk_match(tp, tg, tn, kps),
             "euclidean_distance_transform":
                 lambda: DT.euclidean_distance_transform(mask),
             "k10": k10}
    out = {"root": root}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_launches"] = {k: v for k, v in launch_counts().items()
                                   if v}
        out[f"{name}_device_ms"] = CS.device_ms(torch, fn)[0]
        out[f"{name}_ms"] = CS.cuda_ms(torch, fn, 50)
    return out


def _device_ops(torch, CS, fn) -> int:
    """Device operations one call of ``fn`` runs (the nodes of a CUDA
    graph of the call, ``chip_smoke.graph_ops``)."""
    return sum(CS.graph_ops(torch, fn).values())


def pyramid_and_hough(torch, CS, saved) -> dict:
    """K4 by both run-loop routes and K7, on the saved inputs."""
    from vpp_tpu_torch.algorithms import hough_cuda as HC
    P = importlib.import_module("vpp_tpu_torch.algorithms.pyramid")
    from vpp_tpu_torch.algorithms.pyramid import pyramid
    from vpp_tpu_torch.core.image import Image2d, from_array
    from vpp_tpu_torch.kernels import launch_counts, reset_launch_counts
    frame = saved["frame"].cuda()
    routes = {
        "frame_pyramid": lambda: pyramid(
            from_array(frame, border=9, border_mode="mirror"), 3, border=9),
        "raw_pyramid": lambda: pyramid(Image2d(data=frame, border=0), 3,
                                       border=9)}
    out = {}
    for name, fn in routes.items():
        fn()
        reset_launch_counts()
        fn()
        out[f"{name}_k4_launches"] = launch_counts()["pyramid_decim"]
        out[f"{name}_device_ms"] = CS.device_ms(torch, fn)[0]
        out[f"{name}_ms"] = CS.cuda_ms(torch, fn, 200)
        out[f"{name}_device_ops"] = _device_ops(torch, CS, fn)
    k4 = getattr(P, "_k4", None)     # a checkout older than the fused K4
    if k4 is not None and "fuse" in inspect.signature(k4).parameters:
        shapes = P.level_shapes(tuple(frame.shape), 3)
        designs = {"fused": lambda: P._k4(frame, shapes, 9, first=0),
                   "barrier": lambda: P._k4(frame, shapes, 9, first=0,
                                            fuse=False)}
        for a, b in zip(designs["fused"](), designs["barrier"]()):
            if not torch.equal(a.data, b.data):
                raise RuntimeError("K4's fused and barrier designs differ")
        for name in ("fused", "barrier"):
            out[f"k4_{name}_device_ms"] = []
        for name in ("fused", "barrier", "barrier", "fused"):
            out[f"k4_{name}_device_ms"].append(
                CS.device_ms(torch, designs[name])[0])
    th, rho, w, tt, rb = saved["hough"]
    th, rho, w = th.cuda(), rho.cuda(), w.cuda()

    def k7():
        return HC.hough_acc(th, rho, w, tt, rb)

    out["hough_acc_device_ms"] = CS.device_ms(torch, k7)[0]
    out["hough_acc_ms"] = CS.cuda_ms(torch, k7, 200)
    out["hough_acc_device_ops"] = _device_ops(torch, CS, k7)
    return out


def _host_us(torch, fn, reps: int = 500) -> float:
    """Host microseconds a call: the host clock around ``reps`` calls that
    only enqueue work (one synchronisation after the clock stops)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def host_breakdown(torch, scores, bs: int, k: int) -> dict:
    """Where the host time of one K3 call goes: the whole wrapper, and
    apart its operand checks, its four output and scratch allocations, the
    stream query and the C entry alone (ctypes and the cooperative launch,
    on buffers allocated once); ``rest`` is what those parts leave of the
    whole (Python between them). ``one_empty`` prices one ``torch.empty``."""
    from vpp_tpu_torch.algorithms import fast as F
    from vpp_tpu_torch.kernels import _build, require_cuda, stream_handle
    data = scores.data
    b = scores.border
    h, w = data.shape[0] - 2 * b, data.shape[1] - 2 * b
    nb = -(-h // bs) * -(-w // bs)
    n_scratch = 2 * nb + 256 * -(-nb // 64)
    dev = data.device

    def alloc():
        torch.empty((n_scratch,), dtype=torch.int32, device=dev)
        torch.empty((k, 2), dtype=torch.int32, device=dev)
        torch.empty((k,), dtype=torch.int32, device=dev)
        torch.empty((k,), dtype=torch.bool, device=dev)

    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=dev)
    pos = torch.empty((k, 2), dtype=torch.int32, device=dev)
    score = torch.empty((k,), dtype=torch.int32, device=dev)
    valid = torch.empty((k,), dtype=torch.bool, device=dev)
    lib = _build.load()
    stream = stream_handle(data)

    def launch():
        lib.vpp_block_topk(data.data_ptr(), data.element_size(),
                           data.shape[1], b, h, w, bs, k, scratch.data_ptr(),
                           n_scratch, pos.data_ptr(), score.data_ptr(),
                           valid.data_ptr(), stream)

    out = {
        "call": _host_us(torch, lambda: F._blockwise_keypoints(scores, bs,
                                                               k)),
        "checks": _host_us(torch, lambda: require_cuda(
            "block_topk", data.contiguous(), dtypes=(data.dtype,))),
        "allocations": _host_us(torch, alloc),
        "stream": _host_us(torch, lambda: stream_handle(data)),
        "one_empty": _host_us(torch, lambda: torch.empty(
            (k,), dtype=torch.int32, device=dev)),
        "launch": _host_us(torch, launch)}
    out["rest"] = out["call"] - sum(out[n] for n in (
        "checks", "allocations", "stream", "launch"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compare", metavar="DIR")
    ap.add_argument("--root", default=HERE, help=argparse.SUPPRESS)
    ap.add_argument("--problem", help=argparse.SUPPRESS)
    ap.add_argument("--slice-c", action="store_true",
                    help="time only K10's and K11's callers (phase 12's "
                    "workloads), no SLAM warm-up")
    ap.add_argument("--slice-c-root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("call_times: CUDA is not available", file=sys.stderr)
        return 2
    if args.problem:
        print(json.dumps(measure(os.path.abspath(args.root), args.problem)))
        return 0
    if args.slice_c_root:
        print(json.dumps(slice_c(os.path.abspath(args.slice_c_root))))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.pt")
        if not args.slice_c:
            make_problem(path)
        roots = [HERE] if not args.compare else [
            os.path.abspath(args.compare), HERE, HERE,
            os.path.abspath(args.compare)]
        for root in roots:
            what = (["--slice-c-root", root] if args.slice_c
                    else ["--root", root, "--problem", path])
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), *what],
                cwd=HERE if args.slice_c else root, capture_output=True,
                text=True, timeout=900)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                print(f"call_times: {root} failed", file=sys.stderr)
                return 1
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
