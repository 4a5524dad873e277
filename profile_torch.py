#!/usr/bin/env python3
"""Where the time goes on the card: vpp_tpu_torch's tracker, Hough tracker
and SLAM tracking+BA path under ``torch.profiler``.

    python3 profile_torch.py

Every path runs at 640x480 on 32 frames already on the card: the tracker
with the bench config, the Hough tracker on the two-line clip, and
``slam_run`` at the matched configuration of ``benchmarks/bench_slam.py``
(geometry vga_640x480, recovery off; 8 keyframes) on the first frames of
the clip ``chip_smoke.py`` renders. For each: a
warm-up, then 7 timed runs under ``torch.cuda.synchronize`` without the
profiler, then one run under the profiler. It reports the wall ms/frame
(median of the 7, with min and max), the device's busy time (the sum of
device-side event time: one stream, so kernels do not overlap) and its
share of the profiled and of the unprofiled wall time, and the kernels that
take the most device time. Prints the card's name and power limit, then one
JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

from vpp_tpu_torch import resolve_device
from vpp_tpu_torch.algorithms.hough_tracker import (HoughTrackerConfig,
                                                    hough_tracker_init,
                                                    hough_tracker_update)
from vpp_tpu_torch.algorithms.video_extruder import (VideoExtruderConfig,
                                                     video_extruder_run)
from vpp_tpu_torch.core.image import from_array
from vpp_tpu_torch.slam.pipeline import SlamConfig, slam_run
from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip
from vpp_tpu_torch.utils.synth import camera_path, make_cloud, render_frames

FRAMES = 32
REPEATS = 7
TOP = 12


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile(run) -> dict:
    run()                                          # warm-up
    walls = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / FRAMES)
    walls.sort()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    # device-side events only (kernels, memsets, copies): host ops also
    # carry their kernels' device time and would count it twice
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU]
    rows = [r for r in rows if r[2] > 0]
    busy_us = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[2])
    median = walls[len(walls) // 2]
    busy_ms = busy_us / 1e3 / FRAMES
    return {
        "ms_per_frame": median,
        "ms_per_frame_min_max": [walls[0], walls[-1]],
        "profiled_ms_per_frame": pwall * 1e3 / FRAMES,
        "device_busy_ms_per_frame": busy_ms,
        "busy_share_profiled": busy_us / 1e6 / pwall,
        "busy_share_unprofiled": busy_ms / median,
        "kernels_per_frame": sum(r[1] for r in rows) / FRAMES,
        "top": [{"name": k[:90], "calls_per_frame": c / FRAMES,
                 "device_ms_per_frame": us / 1e3 / FRAMES,
                 "share_of_busy": us / busy_us if busy_us else 0.0}
                for k, c, us in rows[:TOP]],
    }


def main() -> None:
    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])

    cfg = VideoExtruderConfig(capacity=4096, detect_k=2048, nscales=3,
                              winsize=9, keypoint_spacing=10,
                              detector_period=5, detector_th=10)
    clip = torch.from_numpy(make_clip(640, 480, FRAMES)).to(dev)
    tracker = _profile(lambda: video_extruder_run(clip, cfg, device=dev))

    hcfg = HoughTrackerConfig(m_first_lines=8, acc_threshold=10.0)
    lines = torch.from_numpy(synthetic_line_clip(640, 480, FRAMES)).to(dev)

    def hough_run():
        st = hough_tracker_init(hcfg, device=dev)
        for f in lines:
            st, _ = hough_tracker_update(
                st, from_array(f, border=3, border_mode="mirror"), hcfg)

    intr = (640.0, 640.0, 320.0, 240.0)
    scfg = SlamConfig(
        intrinsics=intr, keyframe_period=4, ring=6, ba_iters=3, pnp_iters=6,
        min_parallax=2.0, max_reproj=2.0, prune_reproj=2.5, history=64,
        lc_min_gap=60, enable_recovery=False,
        tracker=VideoExtruderConfig(capacity=1024, detect_k=512, nscales=3,
                                    winsize=9, keypoint_spacing=10,
                                    detector_period=1, detector_th=10))
    poses = camera_path(FRAMES, step=(0.02, 0.0, 0.0))
    sclip = torch.from_numpy(render_frames(
        make_cloud(2000, seed=1, extent=(16.0, 5.0, 3.5),
                   center=(3.2, 0.0, 5.0)), poses, intr, (480, 640), seed=1,
        sigma=(1.2, 2.2))).to(dev)
    slam = _profile(lambda: slam_run(sclip, scfg,
                                     bootstrap_poses=poses[[0, 4]],
                                     device=dev))

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "frames": FRAMES, "tracker": tracker,
                      "hough": _profile(hough_run), "slam": slam}))


if __name__ == "__main__":
    main()
