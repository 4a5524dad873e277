"""The port's utilities against vpp_tpu's on the CPU: the section
profiler's tree and report (``Profiler``, on the sequence of
tests/test_draw_utils.py:58 and a deeper one), the device trace
(``xla_trace``) written as a Chrome trace, and the native CPU baseline
(``utils/native.py``) built under ``build/`` with ``native/`` left as it
was. The JAX ``build_native`` is not called: it rebuilds into ``native/``.

Tolerance: the trees' names, nesting and call counts equal, durations
within the sleeps they wrap; the report's header and every row's name and
call columns equal."""

import hashlib
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

jprof = importlib.import_module("vpp_tpu.utils.profiler")
tprof = importlib.import_module("vpp_tpu_torch.utils.profiler")
tutils = importlib.import_module("vpp_tpu_torch.utils")
native = importlib.import_module("vpp_tpu_torch.utils.native")

ROOT = Path(__file__).resolve().parents[1]


def _drive(prof, sync):
    """test_draw_utils.py:58's sequence, then a deeper tree through
    begin/end and a sync value."""
    with prof("frame"):
        with prof("inner"):
            time.sleep(0.002)
        with prof("inner"):
            time.sleep(0.002)
    for _ in range(3):
        prof.begin("step")
        with prof("detect", sync=sync):
            pass
        with prof("flow"):
            with prof("pyramid"):
                prof.sync(sync)
        prof.end("step", sync=sync)


def _tree(node):
    return (node.name, node.ncalls,
            [_tree(c) for c in node.children.values()])


def test_profiler_tree_and_report():
    sync = {"a": (torch.zeros(2), [torch.ones(1)])}
    p_t, p_j = tprof.Profiler(), jprof.Profiler()
    _drive(p_t, sync)
    _drive(p_j, None)
    assert _tree(p_t.root) == _tree(p_j.root)
    node = p_t.root.children["frame"].children["inner"]
    assert node.ncalls == 2 and node.duration >= 0.004
    rt, rj = p_t.report().splitlines(), p_j.report().splitlines()
    assert rt[0] == rj[0] and len(rt) == len(rj) == 7
    for a, b in zip(rt[1:], rj[1:]):
        assert a[:40] == b[:40] and a[50:58] == b[50:58]
        assert a.count("%") == b.count("%") == 3
    p_t.reset()
    assert _tree(p_t.root) == ("root", 0, [])
    off = tprof.Profiler(enabled=False)
    _drive(off, sync)
    assert off.root.children == {}
    with pytest.raises(ValueError):
        p_t.begin("a")
        p_t.end("b")


def test_profiler_finds_nested_tensors():
    """The sync walk reaches tensors in tuples, lists, dicts and
    dataclasses (an Image2d, a tracker state); on the CPU none is on a
    card."""
    from vpp_tpu_torch.algorithms.video_extruder import (
        VideoExtruderConfig, video_extruder_init)
    from vpp_tpu_torch.core.image import Image2d
    state = video_extruder_init(VideoExtruderConfig(capacity=8),
                                device="cpu")
    value = ([Image2d(torch.zeros(3, 3), 1)], {"s": state}, (1, None))
    assert tprof._cuda_devices(value, set()) == set()
    p = tprof.Profiler()
    with p("x", sync=value):
        p.sync(value)
    assert p.root.children["x"].ncalls == 1
    assert tutils.Profiler is tprof.Profiler


def test_xla_trace_writes_a_chrome_trace(tmp_path):
    with tutils.xla_trace(str(tmp_path)):
        x = torch.arange(1000.0).reshape(10, 100)
        (x @ x.T).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def _native_files():
    return {p.name: p.read_bytes() for p in (ROOT / "native").iterdir()}


def test_native_baseline_builds_under_build():
    before = _native_files()
    lib = native.build_native()
    assert lib is not None and lib.exists()
    assert lib.resolve().is_relative_to(ROOT / "build")
    tag = lib.with_name(lib.name + ".srchash")
    assert tag.read_text().strip() == hashlib.sha256(
        (ROOT / "native" / "cpu_baseline.cpp").read_bytes()).hexdigest()
    assert native.build_native() == lib          # reused, not rebuilt
    fps, live = native.cpu_tracker_fps_stats(160, 120, 8)
    assert fps > 0 and live > 0
    # two runs on one OpenMP thread track the same keypoints (with more
    # threads the detections' order, and so a few merges, can vary)
    code = ("from vpp_tpu_torch.utils import native as n\n"
            "print([n.cpu_tracker_fps_stats(160, 120, 20)[1] "
            "for _ in range(2)])\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    live1, live2 = json.loads(run.stdout)
    assert live1 == live2 > 0
    assert native.cpu_tracker_fps(160, 120, 4) > 0
    assert native.cpu_pyrlk_ms(160, 120, 64, 1) > 0
    assert _native_files() == before


def test_native_build_failure_returns_none(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "cpu_baseline.cpp").write_text("not C++ at all\n")
    monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path / "src")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    assert native.build_native() is None
    assert native.load_cpu_baseline() is None
    assert native.cpu_tracker_fps_stats(64, 48, 2) == (None, None)
    assert native.cpu_tracker_fps(64, 48, 2) is None
    assert native.cpu_slam_fps(None, None, None, kf_period=4,
                               ring=6) == (None, None)
    assert not list((tmp_path / "out").glob("*.so"))
