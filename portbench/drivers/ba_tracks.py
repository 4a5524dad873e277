"""Driver of the ``ba_map`` cells: ``ba_solve_tracks`` on the generic
layout (kernel K9 on the card), called back to back by one caller that
waits for each result, over a pool of problems made from the seed.

``correct`` holds a sample of the window's answers, drawn from the seed,
to the plain reference (``reference/ba.py`` in float64) on the same
problems (the per-iteration costs, the poses and the landmarks), and the
answers' errors against the ground truth to the reference's.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.counts import k9
from portbench.inputs import ba_recipe
from portbench.reference import ba as ref

FIELDS = ("poses", "landmarks", "obs_pose", "obs_uv", "obs_valid", "fixed",
          "intrinsics")


def cost64(p: Dict[str, torch.Tensor], poses, lms, huber: float) -> float:
    """The reference's float64 cost of an answer (poses, landmarks) on
    problem ``p``."""
    return float(ref.cost(poses.double(), lms.double(), p["obs_pose"],
                          p["obs_uv"].double(), p["obs_valid"],
                          p["intrinsics"].double(), huber))


def truth_errors(poses, lms, p) -> Tuple[float, float]:
    """(widest pose-entry error, RMS landmark error) of an answer against
    the problem's ground truth: the true poses are the start's, the true
    landmarks those the observations were made from."""
    dp = (poses[..., :3, :] - p["poses"][..., :3, :].double()).abs().max()
    dl = torch.linalg.norm(lms - p["landmarks_true"].double(), dim=-1)
    return float(dp), float(dl.square().mean().sqrt())


def residuals(p, poses, lms) -> Tuple[float, float]:
    """(99th percentile over landmarks, largest over the poses that move)
    of the RMS reprojection residual in pixels of an answer's observations,
    in float64: each landmark and each pose held to its own observations,
    whichever way LM went along the problem's weak modes."""
    valid = p["obs_valid"]
    idx = p["obs_pose"].long()
    r = ref.project(poses[idx], lms[:, None, :], p["intrinsics"].double()) \
        - p["obs_uv"].double()
    e2 = torch.where(valid, r.square().sum(-1), torch.zeros_like(r[..., 0]))
    nv = valid.sum(-1).clamp(min=1)
    per_lm = (e2.sum(-1) / nv).sqrt()
    m = poses.shape[0]
    se = torch.zeros(m, dtype=e2.dtype, device=e2.device).index_add_(
        0, idx[valid], e2[valid])
    cnt = torch.zeros(m, dtype=e2.dtype, device=e2.device).index_add_(
        0, idx[valid], torch.ones_like(e2[valid]))
    per_pose = (se / cnt.clamp(min=1)).sqrt()[~p["fixed"] & (cnt > 0)]
    return float(torch.quantile(per_lm, 0.99)), float(per_pose.max())


def numbers(got, want, p, huber: float) -> Dict[str, float]:
    """The compared numbers of one answer ``got`` = (poses, landmarks,
    costs) against the reference's ``want`` on problem ``p``, each over the
    starting cost or in world units: how far the answer's own cost (the
    reference's float64 cost of its poses and landmarks) lies above the
    reference answer's; the gap between the answer's last reported cost and
    its own cost; the widest gap of the per-iteration costs; the widest
    pose-entry gap; the 99th percentile and the largest landmark gap; the
    answer's landmark and pose residuals in pixels (``residuals``); how
    far the answer's pose error and RMS landmark error against the ground
    truth lie above the reference answer's, the latter over the start's
    (and, for the record, the errors themselves). A non-finite answer reads
    NaN."""
    pg, lg, cg = (t.double() for t in got)
    pw, lw, cw = (t.double() for t in want)
    c0 = cost64(p, p["poses"], p["landmarks"], huber)
    own = cost64(p, pg, lg, huber)
    d = torch.linalg.norm(lg - lw, dim=-1)
    finite = all(bool(torch.isfinite(t).all()) for t in (pg, lg, cg))
    tp, tl = truth_errors(pg, lg, p)
    rp, rl = truth_errors(pw, lw, p)
    _, sl = truth_errors(p["poses"].double(), p["landmarks"].double(), p)
    rl_px, rp_px = residuals(p, pg, lg)
    out = {
        "cost_excess": (own - cost64(p, pw, lw, huber)) / c0,
        "cost_report": abs(float(cg[..., -1]) - own) / c0,
        "cost_gap": float((cg - cw).abs().max()) / c0,
        "pose_gap": float((pg[..., :3, :] - pw[..., :3, :]).abs().max()),
        "landmark_gap_p99": float(torch.quantile(d, 0.99)),
        "landmark_gap_max": float(d.max()),
        "landmark_residual_p99": rl_px,
        "pose_residual_max": rp_px,
        "truth_pose_excess": tp - rp,
        "truth_landmark_excess": (tl - rl) / sl,
        "truth_pose_err": tp, "truth_pose_err_ref": rp,
        "truth_landmark_rms": tl, "truth_landmark_rms_ref": rl}
    return out if finite else {k: float("nan") for k in out}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest reading over the answers (NaN wins)."""
    return {k: max((r[k] for r in rows),
                   key=lambda v: float("inf") if v != v else v)
            for k in rows[0]}


class Job:
    steps_per_call = 1

    def __init__(self, config: dict, traffic: dict, seed: int,
                 dev: torch.device):
        from vpp_tpu_torch.slam.ba import BATracks, ba_solve_tracks
        self.config, self.traffic, self.dev = config, traffic, dev
        s = config["settings"]
        self.iters, self.huber = s["iters"], s["huber"]
        self.lam0, self.linalg = s["lam0"], s["linalg"]
        m, n, k = traffic["poses"], traffic["landmarks"], traffic["slots"]
        self.host = [ba_recipe.problem(m, n, k, seed, i)
                     for i in range(traffic["pool"])]
        self.pool = [{f: torch.from_numpy(h[f]).to(dev)
                      for f in FIELDS + ("landmarks_true",)}
                     for h in self.host]
        self.problems = [BATracks(
            poses=p["poses"], landmarks=p["landmarks"],
            obs_pose=p["obs_pose"], obs_uv=p["obs_uv"],
            obs_valid=p["obs_valid"], intrinsics=p["intrinsics"],
            fixed_poses=p["fixed"]) for p in self.pool]
        self.solve = ba_solve_tracks
        rng = ba_recipe.rng_of(seed, 1 << 20)
        self.stride = traffic["check_stride"]
        self.offset = int(rng.randint(self.stride))
        self.kept = collections.deque(maxlen=traffic["check_calls"])
        self._bounds: Dict[int, float] = {}
        self.cuda = dev.type == "cuda"
        for p in self.problems[:2]:            # warm-up: build, load, plan
            self._solve(p)
        if self.cuda:
            torch.cuda.synchronize(dev)

    def _solve(self, p):
        return self.solve(p, iters=self.iters, huber=self.huber,
                          lam0=self.lam0, linalg=self.linalg)

    def call(self, i: int) -> None:
        j = i % len(self.problems)
        out, costs = self._solve(self.problems[j])
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        if i % self.stride == self.offset or not self.kept:
            self.kept.append((j, (out.poses, out.landmarks, costs)))

    def end_to_end(self, window_s: float, calls: int, call_s) -> dict:
        return {"ba_call_ms": (window_s * 1e3 / calls, "ms"),
                "ba_call_ms_p95": (float(np.percentile(call_s, 95)) * 1e3,
                                   "ms")}

    def k9_bound_s(self, j: int) -> float:
        """The least seconds of a call on pool problem ``j``."""
        if j not in self._bounds:
            h = self.host[j]
            n, kk = h["obs_pose"].shape
            self._bounds[j] = k9.k9_bound_s(
                n, kk, h["poses"].shape[0], h["obs_valid"].sum(1),
                self.iters, k9.band_of(h["obs_pose"]), self.linalg)
        return self._bounds[j]

    def reference(self, j: int, arith: str = "float64"):
        return ref.lm(self.pool[j], self.iters, self.huber, self.lam0,
                      arith=arith)

    def readings(self, kind: str = "program") -> Dict[str, float]:
        """The compared numbers over the kept answers: of the program's
        answers, or of the reference in another arithmetic in the
        program's place (``control``: float32 with TF32 products;
        ``float32``: float32, a witness for the readings)."""
        rows, cache = [], {}
        for j, got in self.kept:
            if j not in cache:
                cache[j] = self.reference(j)
            if kind != "program":
                got = self.reference(j, "tf32" if kind == "control"
                                     else kind)
            rows.append(numbers(got, cache[j], self.pool[j], self.huber))
        return worst(rows)

    def check(self):
        self.problems = None
        lim = self.traffic["limits"]
        r = self.readings()
        return [(k, r[k], v) for k, v in lim.items()]


def setup(config: dict, traffic: dict, seed: int, dev: torch.device) -> Job:
    return Job(config, traffic, seed, dev)
