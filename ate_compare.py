#!/usr/bin/env python3
"""The port's SLAM trajectory against the JAX package's, on the CPU.

    python3 ate_compare.py [--seeds 1-8] [--frames 240] [--workers 4]

Runs ``slam_run`` of ``vpp_tpu`` (jit, one ``lax.scan``) and of
``vpp_tpu_torch`` (``device="cpu"``, the kernels' plain versions) at
``chip_smoke.py``'s matched 640x480 configuration (``slam_config``: the
tracking+BA path of ``benchmarks/bench_slam.py``, recovery off) on the
clip recipe of ``chip_smoke.slam_clip`` for each seed (2000-point cloud,
lateral dolly, frames rendered by the port's copy of ``utils/synth.py``,
which is bit-equal to the JAX package's), bootstrapped from the true poses
of frames 0 and 4. Three more runs per seed tell a systematic gap from a
chaotic one:
- ``port_f32``: the port with its landmark algebra in float32,
  ``slam/ba.py``'s ``_tracks_assemble`` rebuilt inside this script without
  its float64 casts (the Hll blocks, their inverses, U, W, bl, the Schur
  sums and the cost in float32, as the JAX package sums them); the package
  itself has no such option;
- ``jax_nudged`` and ``port_nudged``: each package with the x translation
  of the second bootstrap pose moved by one float32 ulp, which no
  measurement can tell apart.

Prints, per seed and run: ATE against the true poses, keyframes, live
landmarks, and the frame of the first keyframe whose final pose differs
by more than 1e-3 (largest entry of the 4x4 matrix) from the JAX run's
(for a nudged run: from its own package's run); each run's mean ATE; then
one JSON line with every number. Each run is a process of its own,
``--workers`` at a time, one thread each (the JAX runs with XLA's CPU
thread pool off).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

RUNS = ("jax", "jax_nudged", "port", "port_f32", "port_nudged")
PART = 1e-3


def _clip(frames: int, seed: int):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    return chip_smoke.slam_clip(frames, seed)


def _port_f32(tba) -> None:
    """Rebuild ``tba._tracks_assemble`` with its float64 casts taken out,
    in the module's own namespace (``_lm_tracks`` looks it up there)."""
    src = inspect.getsource(tba._tracks_assemble)
    cast = "r, Jp, Jl, w = r.double(), Jp.double(), Jl.double(), w.double()"
    cost = "dim=(-2, -1), dtype=torch.float64)"
    assert src.count(cast) == 1 and src.count(cost) == 1, (
        "slam/ba.py:_tracks_assemble changed: update ate_compare.py")
    src = src.replace(cast, "pass").replace(cost, "dim=(-2, -1))")
    ns = {}
    exec(compile(src, tba.__file__, "exec"), tba.__dict__, ns)
    tba._tracks_assemble = ns["_tracks_assemble"]


def run_one(kind: str, seed: int, frames: int) -> dict:
    """One ``slam_run``; returns its trajectory, ATE and counts."""
    import numpy as np
    clip, gt = _clip(frames, seed)
    boot = gt[[0, 4]].astype(np.float32)
    if kind.endswith("_nudged"):
        boot[1, 0, 3] = np.nextafter(boot[1, 0, 3], np.float32(np.inf))
    t0 = time.perf_counter()
    if kind.startswith("jax"):
        import jax
        import jax.numpy as jnp
        from vpp_tpu.algorithms.video_extruder import VideoExtruderConfig
        from vpp_tpu.slam import pipeline as P
        import chip_smoke
        tc = chip_smoke.slam_config()
        cfg = P.SlamConfig(
            tracker=VideoExtruderConfig(**{
                f: getattr(tc.tracker, f)
                for f in VideoExtruderConfig.__dataclass_fields__}),
            **{f: getattr(tc, f) for f in P.SlamConfig.__dataclass_fields__
               if f != "tracker"})
        st = jax.jit(lambda f, b: P.slam_run(f, cfg, bootstrap_poses=b))(
            jnp.asarray(clip), jnp.asarray(boot))
        est, fid = P.keyframe_trajectory(st)
        est, fid = np.asarray(est), np.asarray(fid)
        lms = int(np.asarray(st.lm_valid).sum())
        n_kf = int(st.n_keyframes)
    else:
        import torch
        torch.set_num_threads(1)
        from vpp_tpu_torch.slam import ba as tba
        from vpp_tpu_torch.slam import pipeline as P
        import chip_smoke
        if kind == "port_f32":
            _port_f32(tba)
        st = P.slam_run(clip, chip_smoke.slam_config(),
                        bootstrap_poses=boot, device="cpu")
        est, fid = P.keyframe_trajectory(st)
        est, fid = est.numpy(), fid.numpy()
        lms = int(st.lm_valid.sum())
        n_kf = int(st.n_keyframes)
    c_est = -np.einsum("nji,nj->ni", est[:, :3, :3], est[:, :3, 3])
    g = gt[fid]
    c_gt = -np.einsum("nji,nj->ni", g[:, :3, :3], g[:, :3, 3])
    ate = float(np.sqrt(np.mean(np.sum((c_est - c_gt) ** 2, axis=1))))
    return dict(kind=kind, seed=seed, ate=ate, keyframes=n_kf,
                landmarks=lms, frames=fid.tolist(),
                poses=est.astype(float).tolist(),
                seconds=time.perf_counter() - t0)


def _child(kind: str, seed: int, frames: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--one", kind,
         str(seed), "--frames", str(frames)],
        capture_output=True, text=True, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"{kind} seed {seed} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def first_parting_frame(a: dict, b: dict):
    """The frame of the first keyframe whose poses differ by more than
    ``PART``, or None."""
    import numpy as np
    n = min(len(a["frames"]), len(b["frames"]))
    pa, pb = np.asarray(a["poses"][:n]), np.asarray(b["poses"][:n])
    if a["frames"][:n] != b["frames"][:n]:
        k = next(i for i in range(n) if a["frames"][i] != b["frames"][i])
        return a["frames"][k]
    d = np.abs(pa - pb).reshape(n, -1).max(axis=1)
    hit = np.nonzero(d > PART)[0]
    return int(a["frames"][hit[0]]) if hit.size else None


def _seeds(text: str):
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1-8")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--one", nargs=2, metavar=("RUN", "SEED"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one[0], int(args.one[1]),
                                 args.frames)))
        return 0
    jobs = [(k, s) for s in _seeds(args.seeds) for k in RUNS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.workers) as ex:
        done = list(ex.map(lambda j: _child(j[0], j[1], args.frames), jobs))
    res = {(r["kind"], r["seed"]): r for r in done}
    rows = []
    print(f"{'seed':>4} | " + " | ".join(
        f"{k}: ATE kf lms part" for k in RUNS))
    for s in _seeds(args.seeds):
        j = res[("jax", s)]
        row = dict(seed=s)
        for k in RUNS:
            r = res[(k, s)]
            # a nudged run against its own package's run; the others
            # against the JAX package's
            ref = res[(k.replace("_nudged", ""), s)] if k.endswith(
                "_nudged") else j
            row[k] = dict(ate=r["ate"], keyframes=r["keyframes"],
                          landmarks=r["landmarks"], seconds=r["seconds"],
                          parts_at=(None if k == "jax" else
                                    first_parting_frame(ref, r)))
        rows.append(row)
        print(f"{s:>4} | " + " | ".join(
            f"{row[k]['ate']:.4f} {row[k]['keyframes']} "
            f"{row[k]['landmarks']} {row[k]['parts_at']}" for k in RUNS))
    mean = {k: sum(r[k]["ate"] for r in rows) / len(rows) for k in RUNS}
    print("mean | " + " | ".join(f"{mean[k]:.4f}" for k in RUNS))
    print(json.dumps(dict(frames=args.frames, part_threshold=PART,
                          rows=rows, mean_ate=mean,
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
