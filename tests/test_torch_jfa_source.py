"""K11's CUDA source run on the CPU under AddressSanitizer.

The kernel of ``vpp_tpu_torch/kernels/csrc/jfa.cu`` is compiled with g++
against ``tests/cuda_cpu_shim.h`` (a std::thread a CUDA thread, std::barrier
for the block and grid barriers) and run on buffers of exactly their size,
shared memory included, so that any read or write outside a buffer stops
the run. Its results are held bit-equal to ``jfa_pass_plain`` pass by pass
and to the plain transform, with the plan the wrapper makes for the H100,
with smaller tiles, and with tiles smaller than their halo. Needs g++ with
AddressSanitizer; the card tests hold the same kernel on the H100.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

tdt = importlib.import_module("vpp_tpu_torch.algorithms.distance_transform")

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "vpp_tpu_torch" / "kernels" / "csrc"

# main(): "shape" prints the kernel's region and ring sizes; else it reads
# (h, w, passes, mode) int32, the plan rows, then the mask (mode 0) or the
# two int32 planes (mode 1), runs one launch of G CTAs and writes the
# distance and vectors (mode 0) or the two planes out.
DRIVER = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "shape")) {
    printf("%d %d\n", kRegion, kPadded);
    return 0;
  }
  FILE* f = fopen(argv[1], "rb");
  int hdr[4];
  if (fread(hdr, 4, 4, f) != 4) return 2;
  const int h = hdr[0], w = hdr[1], n = hdr[2], mode = hdr[3];
  std::vector<int> rows(5 * n);
  if (fread(rows.data(), 4, 5 * n, f) != (size_t)(5 * n)) return 2;
  Plan P{};
  P.n = n;
  for (int q = 0; q < n; ++q)
    P.p[q] = Pass{rows[5 * q], rows[5 * q + 1], rows[5 * q + 2],
                  rows[5 * q + 3], rows[5 * q + 4]};
  const size_t N = (size_t)h * w;
  std::vector<uint8_t> mask(mode == 0 ? N : 0);
  std::vector<int> in_r(mode ? N : 0), in_c(mode ? N : 0);
  std::vector<int> out_r(mode ? N : 0), out_c(mode ? N : 0);
  std::vector<int> vec(mode ? 0 : 2 * N);
  std::vector<float> dist(mode ? 0 : N);
  std::vector<float2> x(n > 1 ? N : 0), y(n > 2 ? N : 0);
  size_t got = mode == 0 ? fread(mask.data(), 1, N, f)
                         : fread(in_r.data(), 4, N, f) +
                               fread(in_c.data(), 4, N, f) - N;
  fclose(f);
  if (got != N) return 2;
  shim_launch(atoi(argv[3]), kThreads, kSmem, [&] {
    jfa_kernel(mode ? nullptr : mask.data(), mode ? in_r.data() : nullptr,
               mode ? in_c.data() : nullptr, h, w, P,
               n > 1 ? x.data() : nullptr, n > 2 ? y.data() : nullptr,
               mode ? out_r.data() : nullptr, mode ? out_c.data() : nullptr,
               mode ? nullptr : dist.data(), mode ? nullptr : vec.data());
  });
  FILE* o = fopen(argv[2], "wb");
  if (mode == 0) {
    fwrite(dist.data(), 4, N, o);
    fwrite(vec.data(), 4, 2 * N, o);
  } else {
    fwrite(out_r.data(), 4, N, o);
    fwrite(out_c.data(), 4, N, o);
  }
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def jfa_cpu(tmp_path_factory):
    """(the compiled kernel, its (region, ring) sizes, a scratch dir)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    body = (CSRC / "jfa.cu").read_text().split("}  // namespace")[0]
    for old, new in (("#include <cooperative_groups.h>", ""),
                     ("#include <cuda_runtime.h>", ""),
                     ("#include <math_constants.h>", ""),
                     ("extern __shared__ float2 sm[];",
                      "float2* sm = static_cast<float2*>(shim_smem);")):
        assert old in body, old
        body = body.replace(old, new)
    d = tmp_path_factory.mktemp("jfa_cpu")
    (d / "jfa_cpu.cpp").write_text(
        '#include "cuda_cpu_shim.h"\n' + body + "}  // namespace\n" + DRIVER)
    exe = d / "jfa_cpu"
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-g", "-fsanitize=address",
         "-fno-omit-frame-pointer", "-ffp-contract=off", "-pthread",
         f"-I{TESTS}", str(d / "jfa_cpu.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    region, padded = map(int, subprocess.run(
        [str(exe), "shape"], capture_output=True, text=True, check=True,
        timeout=60).stdout.split())
    return exe, (region, padded), d


def _launch(jfa_cpu, h, w, rows, ctas, mask=None, planes=None):
    exe, _, d = jfa_cpu
    n = len(rows) // 5
    with open(d / "in.bin", "wb") as f:
        np.array([h, w, n, 0 if mask is not None else 1], np.int32).tofile(f)
        np.array(rows, np.int32).tofile(f)
        if mask is not None:
            mask.astype(np.uint8).tofile(f)
        else:
            for p in planes:
                p.astype(np.int32).tofile(f)
    r = subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin"),
                        str(ctas)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0 and "AddressSanitizer" not in r.stderr, \
        r.stderr[-4000:]
    raw = np.fromfile(d / "out.bin", np.int32)
    if mask is not None:
        return (raw[:h * w].view(np.float32).reshape(h, w),
                raw[h * w:].reshape(h, w, 2))
    return raw[:h * w].reshape(h, w), raw[h * w:].reshape(h, w)


SHAPES = [(1, 1, 1.0), (1, 5, 0.3), (5, 1, 0.3), (2, 3, 0.0),
          (33, 17, 0.05), (7, 90, 0.02), (45, 60, 0.004)]


@pytest.mark.parametrize(
    "h,w,p,tiles",
    [case + (tiles,) for tiles in ("h100", "small") for case in SHAPES]
    + [case + ("smaller_than_halo",) for case in
       SHAPES[1:4] + [(9, 13, 0.05)]])
def test_jfa_source_in_bounds_and_bit_equal(jfa_cpu, h, w, p, tiles):
    """The transform in one launch of 2 CTAs (a grid barrier between
    passes) and each pass asked alone from random claims in one CTA, at
    every stride of ``_steps`` and one beyond both sides: no access
    outside a buffer, and the plain version's bits. ``h100``
    plans as the wrapper does on the H100 (132 SMs x 2 CTAs), ``small``
    planned for 256-point regions and 16 CTA slots, ``smaller_than_halo``
    one lattice row by two lattice columns of one residue a tile."""
    region, padded = jfa_cpu[1]
    shape = {"h100": (region, padded, 264), "small": (256, 512, 16)}

    def rows(steps):
        if tiles in shape:
            return tdt._jfa_rows(h, w, steps, shape[tiles])
        return [x for s in steps for x in (min(s, max(h, w)), 0, 1, 0, 2)]

    rng = np.random.RandomState(h * 100 + w)
    m = rng.rand(h, w) < p
    steps = tdt._steps(h, w)
    d, v = _launch(jfa_cpu, h, w, rows(steps), 2, mask=m)
    pd, pv = tdt._jump_flood(torch.from_numpy(m), tdt.jfa_pass_plain)
    np.testing.assert_array_equal(d.view(np.int32),
                                  pd.numpy().view(np.int32))
    np.testing.assert_array_equal(v, pv.numpy())
    gone = rng.rand(h, w) < 0.2
    claims = tuple(np.where(gone, -(1 << 20), rng.randint(0, n, (h, w)))
                   .astype(np.int32) for n in (h, w))
    for s in steps + (max(h, w) + 3,):
        got = _launch(jfa_cpu, h, w, rows((s,)), 1, planes=claims)
        want = tdt.jfa_pass_plain(*map(torch.from_numpy, claims), s)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
