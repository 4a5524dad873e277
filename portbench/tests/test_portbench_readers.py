"""The readers of the program's spans and K9's stage records, each fed a
hand-made ``Trace`` (and hand-made stage records): the expected number, and
nothing (None, no error) where the program records none, as a checkout
before them does."""

import importlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.trace import Trace

STAGES = ("index", "landmarks", "blocks", "solve", "step")


def reader(name):
    return harness.load_module(harness.reader_path(name), f"test_{name}")


def trace(host=(), ops=()):
    return Trace(ops=list(ops), host=list(host), window_s=1e-3, calls=2,
                 steps=2, kernels={})


# two calls: K9 busy 100-1100 and 1500-2500 us, the port's spans 50-1200
# and 1300-1600 (the second call's launched after the caller's wait)
OPS = [("k9_lm", 100.0, 1100.0), ("k9_lm", 1500.0, 2500.0)]
HOST = [("portbench.call", 40.0, 1290.0),
        ("vpp.ba_solve_tracks", 50.0, 1200.0),
        ("vpp.unread", 90.0, 95.0),
        ("cudaDeviceSynchronize", 1200.0, 1280.0),
        ("portbench.call", 1295.0, 2600.0),
        ("vpp.ba_solve_tracks", 1300.0, 1600.0)]


def test_port_host_ms():
    assert reader("port_host_ms").read(trace(HOST, OPS), None) == \
        pytest.approx((1150.0 + 300.0) / 2 / 1e3)


def test_device_idle_in_port_ms():
    # the one gap, 1100-1500, lies under the spans for 100 + 200 us
    got = reader("device_idle_in_port_ms").read(trace(HOST, OPS), None)
    assert got == pytest.approx(300.0 / 2 / 1e3)
    idle_ms = sum(b - a for a, b in trace(HOST, OPS).gaps()) / 2 / 1e3
    assert got <= idle_ms


@pytest.mark.parametrize("name", ["port_host_ms", "device_idle_in_port_ms"])
def test_span_readers_read_nothing_without_spans(name):
    host = [h for h in HOST if not h[0].startswith("vpp.")]
    assert reader(name).read(trace(host, OPS), None) is None


def _stamps(durations, cycles, t0=1_760_000_000_000_000_000):
    ns = np.cumsum([t0] + list(durations), dtype=np.int64)
    return torch.from_numpy(np.concatenate(
        [ns, np.asarray(cycles, np.int64).ravel()]))


@pytest.fixture
def records():
    """Two launches of 2 iterations: stage durations (ns) index, then
    landmarks, blocks, solve, step twice, then the last decision."""
    bg = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
    runs = [[1000, 20000, 30000, 40000, 5000, 21000, 31000, 41000, 6000,
             700],
            [3000, 22000, 32000, 42000, 7000, 23000, 33000, 43000, 8000,
             900]]
    bg.reset_k9_stage_records()
    for d in runs:
        bg._STAGES.append((2, _stamps(d, [[1, 1, 1, 1], [1, 2, 3, 4]])))
    yield runs
    bg.reset_k9_stage_records()


@pytest.mark.parametrize("key", STAGES)
def test_k9_stage_readers(key, records):
    d = np.asarray(records, np.float64)
    per_call = {"index": d[:, 0], "landmarks": d[:, 1] + d[:, 5],
                "blocks": d[:, 2] + d[:, 6], "solve": d[:, 3] + d[:, 7],
                "step": d[:, 4] + d[:, 8] + d[:, 9]}[key]
    got = reader(f"k9_{key}_ms").read(trace(HOST, OPS), None)
    assert got == pytest.approx(per_call.mean() / 1e6, rel=1e-12)
    # the five add up to the whole span
    total = sum(reader(f"k9_{k}_ms").read(trace(), None) for k in STAGES)
    assert total == pytest.approx(d.sum(1).mean() / 1e6, rel=1e-12)


@pytest.mark.parametrize("key", STAGES)
def test_k9_stage_readers_read_nothing_without_records(key, monkeypatch):
    bg = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
    bg.reset_k9_stage_records()
    assert reader(f"k9_{key}_ms").read(trace(HOST, OPS), None) is None
    # a program that has no stage records at all
    monkeypatch.delattr(bg, "k9_stage_records")
    assert reader(f"k9_{key}_ms").read(trace(HOST, OPS), None) is None
