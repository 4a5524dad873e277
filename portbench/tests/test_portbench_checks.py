"""The comparison that decides ``correct``, on the CPU: a whole run of each
cell (the harness's look for a card skipped, tiny sizes) comes out correct
with the program as it is, and not correct with the timed path broken
underneath: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced. (Every cell runs on one
card, so no exchange between cards can be left out.) On the card, the
control (the reference in the nearest precision below the
configuration's, in the program's place) comes out not correct."""

import dataclasses
from pathlib import Path

import pytest
import torch

from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _ba_fault(kind):
    import vpp_tpu_torch.slam.ba as BA
    real = BA.ba_solve_tracks

    def broken(p, **kw):
        out, costs = real(p, **kw)
        if kind == "unchanged":
            return p, costs
        if kind == "half":
            n = p.landmarks.shape[0] // 2
            lms = torch.cat([out.landmarks[:n], p.landmarks[n:]])
            return out._replace(landmarks=lms), costs
        poses = out.poses.clone()
        poses[-1, 0, 3] += 0.01
        return out._replace(poses=poses), costs
    return BA, "ba_solve_tracks", broken


def _slam_fault(kind):
    import vpp_tpu_torch.slam.pipeline as SP
    if kind == "unchanged":
        def step(state, *args, **kw):
            return state
        return SP, "_slam_step_streams", step
    real = SP.slam_run_streams

    def broken(frames, cfg, boot, device="cuda"):
        if kind == "half":
            # the second half of the streams left as they started
            from vpp_tpu_torch.core.streams import stack
            h = frames.shape[0] // 2
            a = real(frames[:h], cfg, boot[:h], device=device)
            b = stack([SP.slam_init(cfg, x, device=device) for x in boot[h:]])
            return _cat(a, b)
        out = real(frames, cfg, boot, device=device)
        out.kf_pose[0, (out.n_keyframes - 1) % cfg.ring, 0, 3] += 0.01
        return out
    return SP, "slam_run_streams", broken


def _cat(a, b):
    """Two stream-stacked states as one (host ints from the first)."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            out[f.name] = torch.cat([x, y])
        elif dataclasses.is_dataclass(x):
            out[f.name] = _cat(x, y)
        else:
            out[f.name] = x
    return dataclasses.replace(a, **out)


# every cell with a traffic file: the manifest's, and those kept for a
# later benchmark
CELLS = sorted(p.stem for p in
               (ROOT / "portbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_is_correct(cell):
    res, lines = tiny.run(cell)
    assert res["correct"], lines


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    fault = _slam_fault if cell.startswith("slam_vga.") else _ba_fault
    mod, name, broken = fault(kind)
    monkeypatch.setattr(mod, name, broken)
    res, lines = tiny.run(cell)
    assert not res["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell, cuda):
    from portbench import calibrate, harness
    _, _, traffic, _ = harness.load_cell(cell)
    over = {"traffic": {"streams": 4}} if cell.startswith("slam") else {}
    for row in calibrate.readings(cell, [101, 102, 103], 2, True, cuda,
                                  over):
        bad = [k for k, v in traffic["limits"].items()
               if not row["control"][k] <= v]
        assert bad, row
