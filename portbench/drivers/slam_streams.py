"""Driver of the ``slam_vga`` cells: ``slam_run_streams`` over S clips
rendered on the card from the seed, whole calls back to back (one caller
that waits for each result).

``correct`` follows the program step by step from its own state, since a
SLAM run is chaotic over hundreds of frames (one float32 ulp moves its
trajectory): the program's state after the first ``follow_from`` frames
of the window's clips (a call of the entry point on that prefix, after the
window) is stepped by the plain reference (``reference/slam.py``) through
the last frames, the last keyframe included, and compared with the last
window call's output; and the start is checked by itself: the reference
from the empty state over the first ``start_frames`` frames against the
program's call on them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from portbench.counts import k1
from portbench import peaks
from portbench.inputs import ba_recipe, synth
from portbench.reference import slam as ref


def stream_seed(seed: int, s: int) -> int:
    """The scene seed of stream ``s`` (below 2^31, as ``synth`` takes)."""
    return int(ba_recipe.rng_of(seed, 2, s).randint(2 ** 31 - 2))


def ref_config(config: dict) -> ref.Config:
    names = {f.name for f in dataclasses.fields(ref.Config)}
    kw = {k: v for sec in ("slam", "tracker") for k, v in config[sec].items()
          if k in names}
    kw["intrinsics"] = tuple(kw["intrinsics"])
    return ref.Config(**kw)


def compare(got: ref.State, want: ref.State) -> Dict[str, float]:
    """The compared numbers of S streams' states: the share of keypoint
    slots whose life, position or age differ; the widest gap of a valid
    keyframe pose's entries; the shares of landmark slots whose validity
    differs and of observations whose validity differs; the 99th
    percentile of the landmark gaps where both hold one."""
    g, w = got.t, want.t
    ag, aw = g["age"] > 0, w["age"] > 0
    same = (ag == aw) & (~ag | ((g["position"] == w["position"]).all(-1)
                                & (g["age"] == w["age"])))
    kv = g["kf_valid"] & w["kf_valid"]
    dpose = (g["kf_pose"][..., :3, :] - w["kf_pose"][..., :3, :]).abs() \
        .amax((-2, -1))
    dpose = torch.where(kv, dpose, torch.zeros_like(dpose))
    both = g["lm_valid"] & w["lm_valid"]
    dl = torch.linalg.norm(g["lm_X"] - w["lm_X"], dim=-1)[both].double()
    return {
        "slots": float((~same).double().mean()),
        "pose_gap": float(dpose.max()),
        "lm_valid": float((g["lm_valid"] != w["lm_valid"]).double().mean()),
        "obs_valid": float((g["obs_valid"] != w["obs_valid"]).double()
                           .mean()),
        "landmark_gap": float(torch.quantile(dl, 0.99)) if dl.numel()
        else 0.0}


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 dev: torch.device):
        from vpp_tpu_torch.algorithms.video_extruder import \
            VideoExtruderConfig
        from vpp_tpu_torch.slam.pipeline import SlamConfig, slam_run_streams
        self.config, self.traffic, self.dev = config, traffic, dev
        s, t = traffic["streams"], traffic["frames"]
        h, w = config["frame"]["height"], config["frame"]["width"]
        sl = dict(config["slam"], intrinsics=tuple(config["slam"]
                                                   ["intrinsics"]))
        self.cfg = SlamConfig(**sl, tracker=VideoExtruderConfig(
            **config["tracker"]))
        self.rcfg = ref_config(config)
        self.run = slam_run_streams
        self.steps_per_call = t
        sc = config["scene"]
        poses = synth.camera_path(t, sc["step"])
        self.frames = torch.empty((s, t, h, w), dtype=torch.float32,
                                  device=dev)
        for i in range(s):
            ss = stream_seed(seed, i)
            cloud = synth.make_cloud(sc["points"], ss, sc["extent"],
                                     sc["center"])
            synth.render(cloud, poses, sl["intrinsics"], (h, w),
                         sc["sigma"], ss, dev, out=self.frames[i])
        period = self.cfg.keyframe_period
        self.boot = torch.from_numpy(poses[[0, period]]).to(dev).expand(
            s, 2, 4, 4).contiguous()
        self.last = None
        self._sync()
        self.run(self.frames[:, :traffic["warm_frames"]], self.cfg,
                 self.boot, device=dev)
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def call(self, i: int) -> None:
        self.last = self.run(self.frames, self.cfg, self.boot,
                             device=self.dev)
        self._sync()

    def end_to_end(self, window_s: float, calls: int, call_s) -> dict:
        s, t = self.frames.shape[:2]
        return {"frames_per_s": (calls * s * t / window_s, "frames/s")}

    def k1_bound_s_per_step(self) -> float:
        """The least seconds of one step's flow levels (K1)."""
        c = self.config
        lv = k1.tracker_levels(c["frame"]["height"], c["frame"]["width"],
                               c["tracker"]["nscales"],
                               c["tracker"]["patchsize"],
                               c["tracker"]["winsize"])
        b = max(3, c["tracker"]["winsize"])
        return sum(peaks.bound_s(*k1.level_work(
            x, b, c["tracker"]["propagation"], self.frames.shape[0]))
            for x in lv)

    def states(self, control: bool = False):
        """(got, want) for the follow check and for the start check; with
        ``control`` the reference with TF32 products and a float32 window
        BA stands in the program's place."""
        tr = self.traffic
        f0, t = tr["follow_from"], self.frames.shape[1]
        prefix = self.run(self.frames[:, :f0], self.cfg, self.boot,
                          device=self.dev)
        if control:
            prog_follow = ref.run(ref.from_program(prefix), self.frames, f0,
                                  t, self.rcfg, control=True)
        else:
            prog_follow = ref.from_program(self.last)
        want_follow = ref.run(ref.from_program(prefix), self.frames, f0, t,
                              self.rcfg)
        del prefix
        n0 = tr["start_frames"]
        if control:
            prog_start = ref.run(ref.init(self.rcfg, self.boot), self.frames,
                                 0, n0, self.rcfg, control=True)
        else:
            prog_start = ref.from_program(self.run(
                self.frames[:, :n0], self.cfg, self.boot, device=self.dev))
        want_start = ref.run(ref.init(self.rcfg, self.boot), self.frames, 0,
                             n0, self.rcfg)
        return (prog_follow, want_follow), (prog_start, want_start)

    def readings(self, kind: str = "program") -> Dict[str, float]:
        """The compared numbers of the program (``kind`` "program") or of
        the control in its place ("control")."""
        follow, start = self.states(kind == "control")
        out = {}
        for what, (got, want) in (("follow", follow), ("start", start)):
            for k, v in compare(got, want).items():
                out[f"{what}.{k}"] = v
        return out

    def check(self):
        lim = self.traffic["limits"]
        r = self.readings()
        return [(k, r[k], v) for k, v in lim.items()]


def setup(config: dict, traffic: dict, seed: int, dev: torch.device) -> Job:
    return Job(config, traffic, seed, dev)
