#!/usr/bin/env python3
"""Device time of the SLAM keyframe's whole window-BA call (K6,
``ba_solve_tracks``) and of the SLAM frame's block top-K call (K3,
``_blockwise_keypoints``), on one CUDA card, for this checkout or against
another one.

    python3 call_times.py                   # this checkout
    python3 call_times.py --compare DIR     # DIR's checkout against this

The BA problem is the last keyframe window of a 24-frame warm-up of
``chip_smoke.py``'s SLAM configuration (640x480, ring 6, 3 LM iterations,
"chol"), made by the plain CPU path so that every checkout gets the same
bits; the K3 input is the FAST score image of that warm-up's last frame
(3072 blocks of 10 px), and a random 4K score image (82944 blocks; null
where the checkout refuses it). K3's host time a call is also broken down
(``block_topk_host_us``: the whole wrapper, its checks, allocations,
stream query and C entry, host clock over 500 calls that only enqueue).
Each measurement prints one JSON line:
``device_ms`` (CUDA events around replays of a CUDA graph of 20 calls, or
the profiler's device time where capture is refused, as ``chip_smoke.py``
times its kernels), the as-called ``ms`` (CUDA events around the Python
calls), and the device kernels one BA call runs (``torch.profiler``).
``--compare`` measures DIR, this checkout, this checkout, DIR, each in its
own process, and prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
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
    problems = []
    solve = SP.ba_solve_tracks

    def capture(prob, **kw):
        problems.append(prob)
        return solve(prob, **kw)

    SP.ba_solve_tracks = capture
    try:
        SP.slam_run(clip, cfg, bootstrap_poses=gt[[0, cfg.keyframe_period]],
                    device="cpu")
    finally:
        SP.ba_solve_tracks = solve
    frame = from_array(torch.from_numpy(clip[-1]),
                       border=max(3, cfg.tracker.winsize),
                       border_mode="mirror")
    scores = F.fast9_score_image(frame, cfg.tracker.detector_th)
    rng = np.random.RandomState(3)
    big = rng.randint(1, 256, (2160, 3840)) * (rng.rand(2160, 3840) > 0.5)
    torch.save({"ba": tuple(problems[-1]), "scores": scores.data,
                "border": scores.border,
                "scores_4k": torch.from_numpy(big.astype(np.uint8))}, path)


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
    import vpp_tpu_torch
    return {"root": root, "package": os.path.dirname(vpp_tpu_torch.__file__),
            "n": int(prob.landmarks.shape[0]), "m": int(prob.poses.shape[0]),
            "obs": int(prob.obs_valid.sum()), "iters": cfg.ba_iters,
            "device_ms": dev_ms, "device_ms_by": by,
            "ms": CS.cuda_ms(torch, call, 50),
            "ba_tracks_launches": launches, "device_kernels": kernels,
            **k3}


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
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("call_times: CUDA is not available", file=sys.stderr)
        return 2
    if args.problem:
        print(json.dumps(measure(os.path.abspath(args.root), args.problem)))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.pt")
        make_problem(path)
        roots = [HERE] if not args.compare else [
            os.path.abspath(args.compare), HERE, HERE,
            os.path.abspath(args.compare)]
        for root in roots:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--root", root,
                 "--problem", path], cwd=root, capture_output=True,
                text=True, timeout=900)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                print(f"call_times: {root} failed", file=sys.stderr)
                return 1
            print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
