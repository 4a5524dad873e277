#!/usr/bin/env python3
"""Where the time goes on the card: vpp_tpu_torch's tracker, Hough tracker,
SLAM tracking+BA path and full SLAM engine under ``torch.profiler``.

    python3 profile_torch.py

Every path runs at 640x480 on 32 frames already on the card: the tracker
with the bench config, the Hough tracker on the two-line clip, and
``slam_run`` at the matched configuration of ``benchmarks/bench_slam.py``
(geometry vga_640x480, recovery off; 8 keyframes) on the first frames of
the clip ``chip_smoke.py`` renders, and the same run with recovery on (the
full engine: archive PnP with kernel K8, loop closure, smoother), and
``slam_run_streams`` at the matched configuration on S = 4 such clips
(seeds 1-4) at once (``slam_streams``: its per-frame numbers are per step
of all four streams, ``ms_per_stream_frame`` the wall a frame of one
stream). For each: a warm-up, then 7 timed runs under ``torch.cuda.synchronize``
without the profiler, then one run under the profiler. It reports the
wall ms/frame (median of the 7, with min and max), the device's busy time
(the sum of device-side event time: one stream, so kernels do not
overlap) and its share of the profiled and of the unprofiled wall time,
the kernels that take the most device time, and the operators with the
most host self time (``top_host``, under the profiler, which lengthens
them). Last, one ``pnp_gn`` call at the archive PnP's size (``pnp_gn``:
wall ms and device operations a call). Prints the card's name and power
limit, then one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
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
from vpp_tpu_torch.slam.ba import project
from vpp_tpu_torch.slam.pipeline import (SlamConfig, pnp_gn, slam_run,
                                         slam_run_streams)
from vpp_tpu_torch.slam.se3 import se3_exp
from vpp_tpu_torch.utils.clips import make_clip, synthetic_line_clip
from vpp_tpu_torch.utils.synth import camera_path, make_cloud, render_frames

FRAMES = 32
STREAMS = 4
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
    # host side: the operators with the most self time on the host (the
    # time each spends outside the operators it calls)
    host = [(e.key, e.count, e.self_cpu_time_total)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    host.sort(key=lambda r: -r[2])
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
        "top_host": [{"name": k[:90], "calls_per_frame": c / FRAMES,
                      "host_self_ms_per_frame": us / 1e3 / FRAMES}
                     for k, c, us in host[:TOP]],
    }


def _pnp_call(dev) -> dict:
    """One ``pnp_gn`` call at the archive PnP's size (1024 map points, 6
    iterations; a recovery keyframe makes five calls): its device
    operations under the profiler and its wall ms (median of 7 runs of 20
    calls under ``torch.cuda.synchronize``)."""
    g = torch.Generator().manual_seed(0)
    X = (torch.rand((1024, 3), generator=g) * torch.tensor([4.0, 3.0, 2.0])
         + torch.tensor([-2.0, -1.5, 4.0])).to(dev)
    T = se3_exp(torch.tensor([0.01, -0.02, 0.01, 0.05, 0.02, -0.03])).to(dev)
    intr = torch.tensor([640.0, 640.0, 320.0, 240.0], device=dev)
    uv = project(T[None], X, intr)
    valid = torch.ones((1024,), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)

    def call():
        return pnp_gn(eye, X, uv, valid, intr, iters=6)

    call()
    walls = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 20)
    walls.sort()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU)
    return {"ms_per_call": walls[len(walls) // 2],
            "ms_per_call_min_max": [walls[0], walls[-1]],
            "device_ops_per_call": ops}


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

    def render(seed):
        return torch.from_numpy(render_frames(
            make_cloud(2000, seed=seed, extent=(16.0, 5.0, 3.5),
                       center=(3.2, 0.0, 5.0)), poses, intr, (480, 640),
            seed=seed, sigma=(1.2, 2.2)))

    sclip = render(1).to(dev)
    clips = torch.stack([render(s) for s in range(1, STREAMS + 1)]).to(dev)
    boots = torch.from_numpy(poses[[0, 4]]).expand(STREAMS, 2, 4, 4)
    slam = _profile(lambda: slam_run(sclip, scfg,
                                     bootstrap_poses=poses[[0, 4]],
                                     device=dev))
    fcfg = dataclasses.replace(scfg, enable_recovery=True)
    slam_full = _profile(lambda: slam_run(sclip, fcfg,
                                          bootstrap_poses=poses[[0, 4]],
                                          device=dev))

    streams = _profile(lambda: slam_run_streams(clips, scfg, boots,
                                                device=dev))
    streams["streams"] = STREAMS
    streams["ms_per_stream_frame"] = streams["ms_per_frame"] / STREAMS

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "frames": FRAMES, "tracker": tracker,
                      "hough": _profile(hough_run), "slam": slam,
                      "slam_full": slam_full, "slam_streams": streams,
                      "pnp_gn": _pnp_call(dev)}))


if __name__ == "__main__":
    main()
