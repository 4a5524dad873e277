"""The port's tracing on the CPU: ``utils.profiler.span`` (nothing outside
a ``torch.profiler`` session, a nested ``vpp.`` user annotation inside
one), the span of ``ba_solve_tracks`` on CPU tensors (one a call, the same
bits with and without a session), K9's stamps layout decoded by
``ba_generic_cuda.k9_stage_ms`` from hand-made vectors, and the bounded
stage record. Imports neither JAX nor vpp_tpu.

Tolerance: the decoded stage ms equal the hand sums to 1e-12 ms; results
with and without a session bit-equal."""

import numpy as np
import pytest
import torch

from vpp_tpu_torch.slam import ba_generic_cuda as BG
from vpp_tpu_torch.slam.ba import BATracks, ba_solve_tracks, project
from vpp_tpu_torch.slam.se3 import se3_exp
from vpp_tpu_torch.utils import profiler as P

CPU = [torch.profiler.ProfilerActivity.CPU]


def _vpp_events(prof):
    return [e for e in prof.events() if e.name.startswith("vpp.")]


def test_span_is_a_no_op_outside_a_session():
    # the guard is the private flag torch.profiler's session sets: an
    # upgrade that drops or renames it fails here
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert not P.profiling()
    a, b = P.span("outer"), P.span("inner")
    assert a is b
    with a:
        with b:
            pass
    with torch.profiler.profile(activities=CPU) as prof:
        pass
    assert _vpp_events(prof) == []


def test_span_records_nested_user_annotations_in_a_session():
    with torch.profiler.profile(activities=CPU) as prof:
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert P.profiling()
        with P.span("outer"):
            with P.span("inner"):
                torch.ones(4).sum()
    assert not P.profiling()
    ev = {e.name: e for e in _vpp_events(prof)}
    assert set(ev) == {"vpp.outer", "vpp.inner"}
    outer, inner = ev["vpp.outer"], ev["vpp.inner"]
    for e in (outer, inner):
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert getattr(e, "is_user_annotation", True)
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def _problem(n=60, m=5, k=3, seed=0):
    """A chain of m poses stepping 0.1 in x, each landmark seen by k
    consecutive poses, 0.3 px of noise, landmarks 0.03 off, poses 0 and 1
    fixed."""
    rng = np.random.RandomState(seed)
    xi = np.zeros((m, 6), np.float32)
    xi[1:, 3] = -0.1
    xi[1:, :3] = rng.randn(m - 1, 3) * 0.01
    steps = se3_exp(torch.from_numpy(xi))
    poses = [torch.eye(4)]
    for i in range(1, m):
        poses.append(steps[i] @ poses[-1])
    poses = torch.stack(poses)
    start = rng.randint(0, m - k + 1, size=n)
    op = torch.from_numpy((start[:, None] + np.arange(k)).astype(np.int32))
    X = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    X[:, 0] += 0.1 * start
    X = torch.from_numpy(X.astype(np.float32))
    intr = torch.tensor([300.0, 300.0, 160.0, 120.0])
    uv = project(poses[op.long()], X[:, None], intr) + torch.from_numpy(
        (rng.randn(n, k, 2) * 0.3).astype(np.float32))
    lms = X + torch.from_numpy((rng.randn(n, 3) * 0.03).astype(np.float32))
    fixed = torch.zeros(m, dtype=torch.bool)
    fixed[:2] = True
    return BATracks(poses=poses, landmarks=lms, obs_pose=op, obs_uv=uv,
                    obs_valid=torch.ones((n, k), dtype=torch.bool),
                    intrinsics=intr, fixed_poses=fixed)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_ba_solve_tracks_span_one_a_call_and_the_same_bits():
    p = _problem()
    kw = dict(iters=3, lam0=1e-4, linalg="chol")
    ref = ba_solve_tracks(p, **kw)
    with torch.profiler.profile(activities=CPU) as prof:
        outs = [ba_solve_tracks(p, **kw) for _ in range(3)]
    names = [e.name for e in _vpp_events(prof)]
    assert names.count("vpp.ba_solve_tracks") == 3
    assert set(names) == {"vpp.ba_solve_tracks"}   # K9 is CUDA's alone
    for out, costs in outs:
        for a, b in ((out.poses, ref[0].poses),
                     (out.landmarks, ref[0].landmarks), (costs, ref[1])):
            assert torch.equal(_bits(a), _bits(b))


def _stamps(index, stages, tail, cycles, t0=1_760_000_000_123_456_789):
    """A stamps vector in K9's layout: the start ``t0`` (ns, as large as
    the device clock reads), the index's and each iteration's four stage
    durations and the tail after the last step (ns), then per iteration
    the solve's four cycle counts."""
    d = [index] + [x for it in stages for x in it] + [tail]
    ns = np.cumsum([t0] + d, dtype=np.int64)
    return torch.from_numpy(np.concatenate(
        [ns, np.asarray(cycles, np.int64).ravel()]))


@pytest.mark.parametrize("iters", [2, 5])
def test_k9_stage_ms_decodes_the_stamps(iters):
    rng = np.random.RandomState(iters)
    index, tail = 12_345, 789
    stages = rng.randint(1_000, 900_000, size=(iters, 4))
    cycles = rng.randint(1, 50_000, size=(iters, 4))
    got = BG.k9_stage_ms(_stamps(index, stages, tail, cycles), iters)
    want = {"index": index / 1e6,
            "landmarks": stages[:, 0].sum() / 1e6,
            "blocks": stages[:, 1].sum() / 1e6,
            "solve": stages[:, 2].sum() / 1e6,
            "step": (stages[:, 3].sum() + tail) / 1e6,
            "span": (index + stages.sum() + tail) / 1e6}
    share = cycles / cycles.sum(1, keepdims=True)
    for j, name in enumerate(BG.SOLVE_PARTS):
        want[name] = float((stages[:, 2] * share[:, j]).sum() / 1e6)
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=0, abs=1e-12), key
    five = sum(got[k] for k in ("index", "landmarks", "blocks", "solve",
                                "step"))
    assert five == pytest.approx(got["span"], rel=0, abs=1e-12)
    with pytest.raises(ValueError):
        BG.k9_stage_ms(_stamps(index, stages, tail, cycles)[:-1], iters)


def test_k9_stage_records_are_bounded_and_reset():
    BG.reset_k9_stage_records()
    try:
        assert BG.k9_stage_records() == []
        extra = 7
        for i in range(BG.STAGE_RECORDS + extra):
            BG._STAGES.append((2, torch.full((19,), i, dtype=torch.int64)))
        recs = BG.k9_stage_records()
        assert len(recs) == BG.STAGE_RECORDS
        assert [int(st[0]) for _, st in recs[:2]] == [extra, extra + 1]
        assert int(recs[-1][1][0]) == BG.STAGE_RECORDS + extra - 1
        assert len(BG.k9_stage_records()) == BG.STAGE_RECORDS
    finally:
        BG.reset_k9_stage_records()
    assert BG.k9_stage_records() == []
