#!/usr/bin/env python3
"""K1's tile plan against each of launch A's tile shapes, on the tracker's
three flow levels of a 640x480 frame, timed in alternating order on one
CUDA card.

    python3 k1_tiles.py

Builds the levels as ``chip_smoke.py`` does (bench clip frames 0 and 2,
bench config, each finer level predicted from the coarser one's flow). For
every level it captures a CUDA graph of 20 level calls (launch A, then
launch B) under each configuration: the plan ``flow._k1_plan`` chooses,
and each (tile, threads) shape of ``flow._VOLUME_SHAPES`` forced at every
level. Every configuration must give the same volume, flow and dist bits.
It then replays the graphs in rounds whose order runs through the
configurations and back (P A B B A P): each reading is CUDA events around
20 replays, in ms per level call. Prints the card's name and power limit,
then one JSON line: per configuration the median per level and per frame,
and each round's per-frame difference of every forced shape from the
plan.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

ROUNDS = 8
CALLS = 20
REPLAYS = 20
W, H = 640, 480


def main() -> None:
    from vpp_tpu_torch.algorithms import flow as FL
    from vpp_tpu_torch.algorithms.pyramid import level_shapes, pyramid
    from vpp_tpu_torch.algorithms.video_extruder import VideoExtruderConfig
    from vpp_tpu_torch.core.image import from_array
    from vpp_tpu_torch.utils.clips import make_clip

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    cfg = VideoExtruderConfig(capacity=4096, detect_k=2048, nscales=3,
                              winsize=9, keypoint_spacing=10,
                              detector_period=5, detector_th=10)
    b = max(3, cfg.winsize)
    clip = make_clip(W, H, 3, seed=0)
    p1, p2 = (pyramid(from_array(torch.from_numpy(clip[i]).to(dev), border=b,
                                 border_mode="mirror"), cfg.nscales, border=b)
              for i in (0, 2))
    grid = level_shapes((H // cfg.patchsize, W // cfg.patchsize), cfg.nscales)
    radii = FL._level_radii(cfg.nscales, 5, 1)
    bounds = FL._level_bounds(cfg.nscales, radii)
    iters, sms = cfg.propagation, FL._sm_count(dev)
    configs = {"plan": None}
    configs.update({f"tile{t}_threads{n}": ((t, n),)
                    for t, n in FL._VOLUME_SHAPES})

    levels, flow = [], None
    for s in range(cfg.nscales - 1, -1, -1):
        h, w = p1[s].shape
        gh, gw = grid[s]
        if flow is None:
            pred = torch.zeros((gh, gw, 2), dtype=torch.int32, device=dev)
        else:
            cgh, cgw = grid[s + 1]
            ir = (torch.arange(gh, device=dev) // 2).clamp(0, cgh - 1)
            ic = (torch.arange(gw, device=dev) // 2).clamp(0, cgw - 1)
            pred = 2 * flow[ir[:, None], ic[None, :]]
        g = FL.LevelGeometry(b=b, h=h, w=w, ws=cfg.winsize,
                             patch=cfg.patchsize, gh=gh, gw=gw, R=radii[s],
                             pred_bound=0 if s == cfg.nscales - 1
                             else 2 * bounds[s + 1])
        a1, a2, pred, _ = FL._level_operands(p1[s].data, p2[s].data, pred, g,
                                             iters)
        flow, _ = FL.flow_level(a1, a2, pred, g, iters)
        levels.append((f"level{s}_{gh}x{gw}", a1, a2, pred, g))

    def level_call(a1, a2, pred, g, plan):
        vol, part = FL._launch_volume(a1, a2, pred, g, plan)
        f, d = FL._launch_select(vol, pred, g.R, iters, plan.b_tile, part,
                                 domain=(g.h, g.w, g.patch))
        return vol, f, d

    graphs, plans = {}, {}
    for name, a1, a2, pred, g in levels:
        outs = []
        for key, shapes in configs.items():
            plan = (FL._k1_plan(g, iters, sms) if shapes is None
                    else FL._k1_plan(g, iters, sms, shapes))
            plans[name, key] = dict(a_tile=plan.a_tile, a_grid=plan.a_grid,
                                    chunk=plan.chunk, batch=plan.batch,
                                    a_smem=plan.a_smem)
            outs.append(level_call(a1, a2, pred, g, plan))
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(CALLS):
                    level_call(a1, a2, pred, g, plan)
            graph.replay()
            graphs[name, key] = graph
        for other in outs[1:]:
            if not all(torch.equal(x, y) for x, y in zip(outs[0], other)):
                raise SystemExit(f"k1_tiles: configurations disagree at "
                                 f"{name}")
    torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def reading(name, key) -> float:
        start.record()
        for _ in range(REPLAYS):
            graphs[name, key].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (REPLAYS * CALLS)

    keys = list(configs)
    times = {(name, key): [] for name, *_ in levels for key in keys}
    diffs = {key: [] for key in keys[1:]}
    for _ in range(ROUNDS):
        frame = dict.fromkeys(keys, 0.0)
        for key in keys + keys[::-1]:
            for name, *_ in levels:
                t = reading(name, key)
                times[name, key].append(t)
                frame[key] += t / 2
        for key in keys[1:]:
            diffs[key].append(frame[key] - frame["plan"])

    report = {}
    for key in keys:
        per_level = {name: statistics.median(times[name, key])
                     for name, *_ in levels}
        report[key] = {"ms_per_level": per_level,
                       "ms_per_frame": sum(per_level.values()),
                       "plan": {name: plans[name, key]
                                for name, *_ in levels}}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "rounds": ROUNDS,
        "configs": report,
        "minus_plan_ms_per_frame_by_round": diffs}))


if __name__ == "__main__":
    main()
