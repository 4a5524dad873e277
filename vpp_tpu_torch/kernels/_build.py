"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by its own
``nvcc -c``, all started together (the headers of ``csrc/`` are included
from there), and the objects are linked into one shared library with a
plain C interface. The library goes into ``build/vpp_tpu_torch/`` at the
root of the checkout, under a name keyed by the contents of the sources
and headers, and is built at first use: nothing is compiled when
the package is imported, and a machine without nvcc raises instead of
loading anything else.

Run ``python -m vpp_tpu_torch.kernels._build`` to build and print the
compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vpp_tpu_torch"
SOURCES = ("fast9.cu", "flow_level.cu", "hough_acc.cu", "block_topk.cu",
           "pyramid_decim.cu", "patches.cu", "ba_tracks.cu", "map_vote.cu",
           "ba_generic.cu", "lk_level.cu", "jfa.cu")
# included by ba_tracks.cu, map_vote.cu and ba_generic.cu
HEADERS = ("pose_math.cuh",)
TOOLKIT_ROOT = "/usr/local/cuda"       # the CUDA toolkit's default install
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: name -> argtypes (every function returns a cudaError_t).
_SIGNATURES = {
    "vpp_fast9": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vpp_fast9_image": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _P],
    "vpp_fast9_cull": [_P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P],
    "vpp_flow_volume": [_P] * 4 + [_I] * 18 + [_P] * 4,
    "vpp_flow_select": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 13 + [_P] * 3,
    "vpp_hough_acc": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vpp_block_topk": [_P] + [_I] * 8 + [_L, _P, _L] + [_P] * 4,
    "vpp_pyramid": [_P, _I, _L, ctypes.POINTER(_L)] + [_I] * 5
    + [_P, _L, _P],
    "vpp_patches": [_P] + [_I] * 4 + [_P] + [_I] * 5 + [_P, _P],
    "vpp_ba_lm": [_P] * 6 + [_F] * 2 + [_I] * 5 + [_P] * 10,
    "vpp_ba_max_active_clusters": [_I, _P],
    "vpp_map_vote_pnp": [_P] * 8 + [_I] * 6 + [_F] * 7 + [_P] * 10
    + [_I, _P],
    "vpp_map_vote_smem": [_P],
    "vpp_ba_generic_workspace": [_I] * 5 + [_P],
    "vpp_ba_generic_lm": [_P] * 7 + [_I] * 6 + [_F] * 2 + [_P] * 10,
    "vpp_ba_generic_smem": [_P],
    "vpp_lk": [ctypes.POINTER(_L), _I, _P, _P, _I, _I, _F, _I, _F, _I, _F,
               _F, _I, _I] + [_P] * 7,
    "vpp_jfa": [_P, _P, _P, _I, _I, ctypes.POINTER(_I), _I] + [_P] * 7,
    "vpp_jfa_shape": [ctypes.POINTER(_I)],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""            # the compiler's output from the last build
build_seconds = 0.0       # wall time of this process's build (0: cached)


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under $CUDA_HOME or the toolkit's default root."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), TOOLKIT_ROOT):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _sources_key() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources in parallel and link the shared library; returns
    its path. Raises ``RuntimeError`` if nvcc is absent or fails."""
    global build_log, build_seconds
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "vpp_tpu_torch kernels: nvcc not found (PATH, $CUDA_HOME); the "
            "CUDA kernels cannot be built on this machine")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libvpp_kernels_{_sources_key()}.so"
    if out.is_file():
        return out
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        os.replace(tmp_so, out)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vpp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vpp_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = load().vpp_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")


if __name__ == "__main__":
    path = build()
    print(build_log)
    print(f"built {path} in {build_seconds:.1f} s")
