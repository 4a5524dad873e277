"""Package rules of vpp_tpu_torch: no JAX and nothing of vpp_tpu, the card
as the default device with no silent fallback, a kernel loader that raises
without nvcc, and config dataclasses equal to the JAX package's."""

import ast
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vpp_tpu_torch
from vpp_tpu_torch import convert
from vpp_tpu_torch.algorithms import fast as t_fast
from vpp_tpu_torch.algorithms import flow as t_flow
from vpp_tpu_torch.algorithms import hough_cuda as t_hough_cuda
from vpp_tpu_torch.algorithms import hough_tracker as t_ht
from vpp_tpu_torch.algorithms import ukf as t_ukf
from vpp_tpu_torch.algorithms import video_extruder as t_ve
from vpp_tpu_torch.core.image import Image2d
from vpp_tpu_torch.kernels import _build

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vpp_tpu"}


def test_import_without_jax_loads_no_vpp_tpu_module():
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import vpp_tpu_torch\n"
        "for m in pkgutil.walk_packages(vpp_tpu_torch.__path__,\n"
        "                               'vpp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, profile_torch\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'vpp_tpu' or m.startswith('vpp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    files = sorted((REPO / "vpp_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py", REPO / "profile_torch.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_vpp_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not FORBIDDEN.intersection(roots), (path, node.lineno, roots)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vpp_tpu_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        t_ve.video_extruder_init(t_ve.VideoExtruderConfig(capacity=8))
    with pytest.raises(RuntimeError):
        t_ve.video_extruder_run(np.zeros((2, 32, 32), np.float32),
                                t_ve.VideoExtruderConfig(capacity=8))
    with pytest.raises(RuntimeError):
        t_ht.hough_tracker_init(t_ht.HoughTrackerConfig())
    with pytest.raises(RuntimeError):
        t_ukf.ukf_init()
    with pytest.raises(RuntimeError):
        convert.ukf_state_from_numpy({"x": np.zeros(5, np.float32),
                                      "P": np.eye(5, dtype=np.float32)})
    with pytest.raises(RuntimeError):
        convert.keypoints_from_numpy({
            "position": np.zeros((2, 2), np.float32),
            "velocity": np.zeros((2, 2), np.float32),
            "age": np.zeros((2,), np.int32)})
    assert t_ve.video_extruder_init(t_ve.VideoExtruderConfig(capacity=8),
                                    device="cpu").traj.device.type == "cpu"


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "TOOLKIT_ROOT", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None


def test_non_cpu_tensors_never_take_the_plain_path():
    """A tensor off the CPU launches the kernel or raises: here a 'meta'
    tensor reaches each wrapper's checks and is refused."""
    img = Image2d(data=torch.empty((20, 20), device="meta"), border=3)
    with pytest.raises(ValueError):
        t_fast.fast9_cuda(img, 10)
    g = t_flow.LevelGeometry(b=3, h=14, w=14, ws=7, patch=5, gh=2, gw=2,
                             R=1, pred_bound=0)
    a = torch.empty((20, 20), device="meta")
    with pytest.raises(ValueError):
        t_flow.flow_match(a, a, torch.empty((2, 2, 2), dtype=torch.int32,
                                            device="meta"), g)
    v = torch.empty((16,), device="meta")
    with pytest.raises(ValueError):
        t_hough_cuda.hough_acc(v, v, v, 8, 8)


@pytest.mark.parametrize("names", [
    ("vpp_tpu.algorithms.video_extruder",
     "vpp_tpu_torch.algorithms.video_extruder", "VideoExtruderConfig"),
    ("vpp_tpu.algorithms.hough_tracker",
     "vpp_tpu_torch.algorithms.hough_tracker", "HoughTrackerConfig"),
])
def test_config_dataclasses_equal_the_jax_ones(names):
    jmod, tmod, cls = names
    jc = getattr(importlib.import_module(jmod), cls)
    tc = getattr(importlib.import_module(tmod), cls)
    jf = [(f.name, f.default, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.default, f.type) for f in dataclasses.fields(tc)]
    assert jf == tf
    assert tc.__dataclass_params__.frozen and jc.__dataclass_params__.frozen


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
