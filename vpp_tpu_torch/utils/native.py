"""The native C++/OpenMP CPU baseline, loaded with ctypes (port of
``vpp_tpu.utils.native``).

``native/cpu_baseline.cpp`` is an independent scalar implementation of the
tracker (and of pyramidal LK and a tracking+BA engine): the denominator
that says what the same work costs on the host's CPU. It is built on
demand with the reference's flags (``g++ -O3 -march=native -fopenmp``)
into ``build/vpp_tpu_torch_native/`` at the root of the checkout, under a
name keyed by the source's content hash; the files under ``native/`` are
only read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[2]
_NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "vpp_tpu_torch_native"


def build_native(name: str = "cpu_baseline",
                 out: str = "libvppcpu.so") -> Optional[Path]:
    """Build (or reuse) ``native/<name>.cpp`` as ``BUILD_DIR/<out>``.

    Staleness is decided by the source's content hash, stored beside the
    library (``<out>.srchash``): mtimes are reset by checkouts and copies.
    The library is compiled under a temporary name and renamed into place,
    so a concurrent build never loads half a file. Returns None where the
    build fails."""
    src = _NATIVE_DIR / f"{name}.cpp"
    lib = BUILD_DIR / out
    tag = BUILD_DIR / f"{out}.srchash"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    if lib.exists() and tag.exists() and tag.read_text().strip() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{out}.", suffix=".so")
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-o", tmp, str(src)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, lib)
    tag_tmp = f"{tmp}.srchash"
    Path(tag_tmp).write_text(digest)
    os.replace(tag_tmp, tag)
    return lib


def load_cpu_baseline() -> Optional[ctypes.CDLL]:
    lib = build_native()
    if lib is None:
        return None
    dll = ctypes.CDLL(str(lib))
    dll.tracker_fps.restype = ctypes.c_double
    dll.tracker_fps.argtypes = [ctypes.c_int] * 4
    dll.tracker_fps_stats.restype = ctypes.c_double
    dll.tracker_fps_stats.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    dll.pyrlk_ms.restype = ctypes.c_double
    dll.pyrlk_ms.argtypes = [ctypes.c_int] * 5
    d = ctypes.c_double
    pd = ctypes.POINTER(d)
    pf = ctypes.POINTER(ctypes.c_float)
    dll.slam_fps.restype = d
    dll.slam_fps.argtypes = [pf] + [ctypes.c_int] * 3 + [d] * 4 + [pd] + \
        [ctypes.c_int] * 7 + [d] * 3 + [pd, pd]
    return dll


def cpu_tracker_fps(width: int, height: int, frames: int,
                    seed: int = 0) -> Optional[float]:
    dll = load_cpu_baseline()
    if dll is None:
        return None
    return float(dll.tracker_fps(width, height, frames, seed))


def cpu_tracker_fps_stats(width: int, height: int, frames: int,
                          seed: int = 0):
    """(fps, n_live_keypoints) of the native tracker on its own copy of the
    moving-texture clip: the denominator with its own workload size.
    (None, None) where the library does not build."""
    dll = load_cpu_baseline()
    if dll is None:
        return None, None
    n = ctypes.c_int(0)
    fps = dll.tracker_fps_stats(width, height, frames, seed,
                                ctypes.byref(n))
    return float(fps), int(n.value)


def cpu_pyrlk_ms(width: int = 640, height: int = 480, nkp: int = 1024,
                 iters: int = 10, seed: int = 0) -> Optional[float]:
    """ms per pyramidal-LK pass (pyramids, Scharr gradients and LK of
    ``nkp`` keypoints) of the native scalar engine."""
    dll = load_cpu_baseline()
    if dll is None:
        return None
    return float(dll.pyrlk_ms(width, height, nkp, iters, seed))


def cpu_slam_fps(frames, intrinsics, boot, *, kf_period: int, ring: int,
                 ba_iters: int = 3, pnp_iters: int = 6, spacing: int = 8,
                 detector_th: int = 8, detector_period: int = 1,
                 min_parallax: float = 2.0, max_reproj: float = 2.0,
                 prune_reproj: float = 1.5, gt=None):
    """The scalar C++ tracking+BA engine (``cpu_baseline.cpp:slam_fps``).

    ``frames``: (T, H, W) float array; ``boot``: (2, 4, 4) poses of the
    engine's first two keyframes (frames kf_period and 2*kf_period);
    ``gt``: optional (T, 4, 4) ground truth for the ATE. Returns (fps,
    stats dict), or (None, None) where the library does not build."""
    import numpy as np
    dll = load_cpu_baseline()
    if dll is None:
        return None, None
    fr = np.ascontiguousarray(frames, np.float32)
    t, h, w = fr.shape
    bt = np.ascontiguousarray(boot, np.float64)
    out = np.zeros(5, np.float64)
    pd = ctypes.POINTER(ctypes.c_double)
    # the gt buffer stays referenced for the duration of the call
    gt_arr = (np.ascontiguousarray(gt, np.float64)
              if gt is not None else None)
    gt_ptr = (gt_arr.ctypes.data_as(pd) if gt_arr is not None
              else ctypes.cast(None, pd))
    fx, fy, cx, cy = [float(v) for v in intrinsics]
    fps = dll.slam_fps(
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, h, w,
        fx, fy, cx, cy, bt.ctypes.data_as(pd), kf_period, ring, ba_iters,
        pnp_iters, spacing, detector_th, detector_period,
        float(min_parallax), float(max_reproj), float(prune_reproj),
        gt_ptr, out.ctypes.data_as(pd))
    stats = {"ate": float(out[0]), "n_live": int(out[1]),
             "n_landmarks": int(out[2]), "n_keyframes": int(out[3]),
             "mean_reproj": float(out[4])}
    return float(fps), stats
