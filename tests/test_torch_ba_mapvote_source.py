"""K9's and K8's CUDA sources run on the CPU under AddressSanitizer, on the
routes that lift their size limits.

Each source is compiled with g++ against ``tests/cuda_cpu_shim.h`` (a
std::thread a CUDA thread; std::barrier for the block, warp, grid and
cluster barriers; shuffles, votes and warp reductions through a per-warp
exchange; a cluster's shared memory mapped CTA to CTA) and run on shared
memory of exactly the launch's size, so that a stage that stages more than
its route allows stops the run:

* K9's ``k9_lm`` (``ba_generic.cu``), its block cut to 64 threads
  (``kThreads``, which only sets strides, loop bounds and the index's
  per-warp rows) and two CTAs so that a launch is 128 threads, with the
  shared-memory budget that the routes are chosen for set to the H100's
  and to small ones, so that the
  index, the landmark stage, the step and the pose solve's panel take their
  device-memory routes at a few tens of poses: the routes it reports are
  ``ba_generic_cuda.k9_routes``'s, every output (the result, the trace,
  the first iteration's S) is the same bits on every route, and the result
  is held to the plain LM loop (``ba._lm_tracks(kernel=False)``) as
  ``chip_smoke.k9_check`` holds the loop: the first cost within 1e-5, the
  last no more than 1e-4 of the first above the plain loop's (a float32
  pose solve of a long chain leaves the poses undetermined along its weak
  gauge, so two solves' poses part while their costs agree);
* K8's ``map_vote_pnp_kernel`` on its staged route and on its device route
  (the detections and the inlier bit sets in device memory), with the
  block shrunk to 64 threads and the cluster to 2 CTAs (``kThreads`` and
  ``kCluster``, which only bound loops and strides) so that a launch is
  128 threads a match set: the shifts, ``j1``, ``uv1``, ``inl`` and ``n``
  bit-equal to ``_map_vote_pnp_plain`` on both routes, T and err within
  1e-4 of it and bit-equal between the routes.

Needs g++ with AddressSanitizer; the card tests and ``chip_smoke.py``
phase 16 hold the same kernels on the H100.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lk_flow_source import _run

tba = importlib.import_module("vpp_tpu_torch.slam.ba")
tbg = importlib.import_module("vpp_tpu_torch.slam.ba_generic_cuda")
tmv = importlib.import_module("vpp_tpu_torch.slam.map_vote")
from vpp_tpu_torch.slam.se3 import se3_exp  # noqa: E402

TESTS = Path(__file__).resolve().parent
K9_WARPS = 2          # the warps of a CTA of the K9 build here
CSRC = TESTS.parent / "vpp_tpu_torch" / "kernels" / "csrc"

# main(in, out): int32 (n, kk, m, iters, use_lu, smem, G), float32 (huber,
# lam0), then poses (m,4,4), landmarks (n,3), obs_pose (n,kk) int32, obs_uv
# (n,kk,2), obs_valid (n,kk) bytes, intrinsics (4), fixed (m) bytes; writes
# poses, landmarks, costs, per, S (6m, 6m), extra and the routes.
K9_DRIVER = r"""
#include <cstdio>
template <class T> static void rd(FILE* f, T* x, size_t n) {
  if (fread(x, sizeof(T), n, f) != n) exit(2);
}
template <class T> static void wr(FILE* f, const std::vector<T>& x) {
  fwrite(x.data(), sizeof(T), x.size(), f);
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[7];
  float fl[2];
  rd(f, h, 7);
  rd(f, fl, 2);
  const int n = h[0], kk = h[1], m = h[2], iters = h[3], smem = h[5],
            G = h[6];
  const size_t nk = (size_t)n * kk, D = 6 * (size_t)m;
  std::vector<float> poses_in(16 * m), lms_in(3 * n), uv(2 * nk), intr(4);
  std::vector<int> op(nk);
  std::vector<unsigned char> valid(nk), fixed(m);
  rd(f, poses_in.data(), poses_in.size());
  rd(f, lms_in.data(), lms_in.size());
  rd(f, op.data(), op.size());
  rd(f, uv.data(), uv.size());
  rd(f, valid.data(), valid.size());
  rd(f, intr.data(), 4);
  rd(f, fixed.data(), fixed.size());
  fclose(f);
  std::vector<float> poses(16 * m), lms(3 * n), costs(iters),
      per(iters * (D + 4)), s0(D * D, 0.0f), extra(3 * D + 2), routes(4);
  Args a{};
  a.poses_in = poses_in.data();
  a.lms_in = lms_in.data();
  a.obs_pose = op.data();
  a.obs_uv = uv.data();
  a.obs_valid = valid.data();
  a.intr = intr.data();
  a.fixed = fixed.data();
  a.n = n;
  a.kk = kk;
  a.m = m;
  a.iters = iters;
  a.use_lu = h[4];
  a.smem_bytes = smem;
  a.routes = routes.data();
  a.huber = fl[0];
  a.lam0 = fl[1];
  a.poses = poses.data();
  a.lms = lms.data();
  a.costs = costs.data();
  a.per = per.data();
  a.s0 = s0.data();
  a.extra = extra.data();
  a.stamps = nullptr;
  const size_t budget = (size_t)(smem - kHead);
  std::vector<unsigned char> ws(layout(n, kk, m, iters, G, budget, nullptr,
                                       nullptr));
  Work w;
  layout(n, kk, m, iters, G, budget, ws.data(), &w);
  shim_launch(G, kThreads, smem, [&] { k9_lm(a, w); });
  FILE* o = fopen(argv[2], "wb");
  wr(o, poses);
  wr(o, lms);
  wr(o, costs);
  wr(o, per);
  wr(o, s0);
  wr(o, extra);
  wr(o, routes);
  fclose(o);
  return 0;
}
"""

# main(in, out): int32 (A, Q, B, P2, rounds, iters, staged), float32 (r2,
# bmax, step, inl_r2, gate2, huber1, huber2), then X, desc, base (bytes),
# pos (int32), valid (bytes), det, T_prior, intr; writes T, err, n, txy,
# j1, uv1, inl (as int32).
K8_DRIVER = r"""
#include <cstdio>
template <class T> static void rd(FILE* f, T* x, size_t n) {
  if (fread(x, sizeof(T), n, f) != n) exit(2);
}
template <class T> static void wr(FILE* f, const std::vector<T>& x) {
  fwrite(x.data(), sizeof(T), x.size(), f);
}
int main(int, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  int h[7];
  float fl[7];
  rd(f, h, 7);
  rd(f, fl, 7);
  const int A = h[0], Q = h[1], B = h[2], P2 = h[3], staged = h[6];
  std::vector<float> X(3 * A), desc((size_t)A * P2), det((size_t)9 * Q * P2),
      T_prior(16), intr(4);
  std::vector<unsigned char> base((size_t)B * A), valid(Q);
  std::vector<int> pos(2 * Q);
  rd(f, X.data(), X.size());
  rd(f, desc.data(), desc.size());
  rd(f, base.data(), base.size());
  rd(f, pos.data(), pos.size());
  rd(f, valid.data(), valid.size());
  rd(f, det.data(), det.size());
  rd(f, T_prior.data(), 16);
  rd(f, intr.data(), 4);
  fclose(f);
  const int nwords = (Q + 31) / 32;
  std::vector<float> T(16 * B), err(B), txy(2 * B * h[4]), uv1(2 * B * A),
      pair_t(8 * (size_t)B * A);
  std::vector<int> n(B), j1((size_t)B * A);
  std::vector<unsigned char> inl((size_t)B * A);
  std::vector<unsigned> code(4 * (size_t)B * A),
      bits(staged ? 0 : (size_t)B * kCluster * nwords);
  Args p{};
  p.X = X.data();
  p.desc = desc.data();
  p.base = base.data();
  p.pos = pos.data();
  p.valid = valid.data();
  p.det = det.data();
  p.T_prior = T_prior.data();
  p.intr = intr.data();
  p.A = A;
  p.Q = Q;
  p.P2 = P2;
  p.rounds = h[4];
  p.iters = h[5];
  p.r2 = fl[0];
  p.bmax = fl[1];
  p.step = fl[2];
  p.inl_r2 = fl[3];
  p.gate2 = fl[4];
  p.huber1 = fl[5];
  p.huber2 = fl[6];
  p.T_out = T.data();
  p.err = err.data();
  p.n = n.data();
  p.txy = txy.data();
  p.j1 = j1.data();
  p.uv1 = uv1.data();
  p.inl = inl.data();
  p.pair_code = code.data();
  p.pair_t = pair_t.data();
  p.bits = staged ? nullptr : bits.data();
  const size_t smem = kShimStatic + (staged ? dyn_bytes(Q) : 0);
  shim_launch(dim3(kCluster, B), kThreads, smem, [&] {
    if (staged) map_vote_pnp_kernel<true>(p);
    else map_vote_pnp_kernel<false>(p);
  }, false, kCluster);
  std::vector<int> inl32(inl.begin(), inl.end());
  FILE* o = fopen(argv[2], "wb");
  wr(o, T);
  wr(o, err);
  wr(o, n);
  wr(o, txy);
  wr(o, j1);
  wr(o, uv1);
  wr(o, inl32);
  fclose(o);
  return 0;
}
"""


def _source(name: str, cut: str, replace) -> str:
    """``csrc/<name>`` for the shim: pose_math.cuh inlined, the CUDA
    headers dropped, cut where ``cut`` begins (the host code) and its
    anonymous namespace closed, the lines ``replace`` maps rewritten."""
    math = (CSRC / "pose_math.cuh").read_text().replace(
        "#pragma once", "").replace("#include <cuda_runtime.h>", "")
    src = (CSRC / name).read_text()
    src = src[:src.index(cut)] + "}  // namespace\n"
    for old, new in [("#include <cooperative_groups.h>", ""),
                     ("#include <cuda_runtime.h>", ""),
                     ('#include "pose_math.cuh"', math)] + list(replace):
        assert old in src, old
        src = src.replace(old, new)
    return src


def _compile(tmp_path_factory, name: str, src: str, driver: str) -> Path:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    d = tmp_path_factory.mktemp(name)
    (d / f"{name}.cpp").write_text(
        '#include "cuda_cpu_shim.h"\n' + src + driver)
    exe = d / name
    r = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-g", "-fsanitize=address",
         "-fno-omit-frame-pointer", "-ffp-contract=off", "-pthread",
         f"-I{TESTS}", str(d / f"{name}.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return exe


@pytest.fixture(scope="module")
def k9_cpu(tmp_path_factory):
    src = _source("ba_generic.cu",
                  "// The dynamic shared memory of a CTA (all a block", [
                      ("extern __shared__ __align__(16) unsigned char "
                       "shared_all[];",
                       "unsigned char* shared_all = "
                       "static_cast<unsigned char*>(shim_smem);"),
                      ('asm volatile("mov.u64 %0, %%globaltimer;" : '
                       '"=l"(t));', "t = 0;"),
                      ("constexpr int kThreads = 256;",
                       f"constexpr int kThreads = {32 * K9_WARPS};")])
    return _compile(tmp_path_factory, "k9_cpu", src, K9_DRIVER)


@pytest.fixture(scope="module")
def k8_cpu(tmp_path_factory):
    src = _source("map_vote.cu", "// -- host ---", [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 64;"),
        ("constexpr int kCluster = 16;", "constexpr int kCluster = 2;"),
        ("extern __shared__ __align__(16) unsigned char smem[];",
         "unsigned char* smem = static_cast<unsigned char*>(shim_smem) "
         "+ kShimStatic;"),
        ("  __shared__ Shared sh;\n",
         "  Shared& sh = *static_cast<Shared*>(shim_smem);\n"),
        ("// Dynamic shared memory of the staged route",
         "constexpr size_t kShimStatic = (sizeof(Shared) + 15) / 16 * 16;\n"
         "// Dynamic shared memory of the staged route")])
    return _compile(tmp_path_factory, "k8_cpu", src, K8_DRIVER)


def _k9_problem(m, k, n, seed, case):
    """A chain of m poses stepping 0.1 in x, each landmark seen by k
    consecutive poses (``closure``: landmark 3 also by poses 0 and m - 1,
    a full band; ``ring``: k = m, every pose sees every landmark, 40% of
    the slots masked), 0.3 px of noise, the landmarks perturbed by 0.03,
    poses 0 and 1 fixed."""
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
    X = rng.rand(n, 3) * [2.0, 1.5, 1.0] + [-1.0, -0.75, 3.0]
    X[:, 0] += 0.1 * start
    op = start[:, None] + np.arange(k)[None]
    valid = np.ones((n, k), bool)
    if case == "closure":
        op[3, 0], op[3, k - 1] = 0, m - 1
        X[3] = [0.05 * (m - 1), 0.0, 3.0 + 0.12 * (m - 1)]
    if case == "ring":
        valid = rng.rand(n, k) > 0.4
    X = torch.from_numpy(X.astype(np.float32))
    op = torch.from_numpy(op.astype(np.int32))
    intr = torch.tensor((300.0, 300.0, 160.0, 120.0))
    uv = tba.project(poses[op.long()], X[:, None], intr) + torch.from_numpy(
        (rng.randn(n, k, 2) * 0.3).astype(np.float32))
    fixed = torch.zeros(m, dtype=torch.bool)
    fixed[:2] = True
    lms = X + torch.from_numpy((rng.randn(n, 3) * 0.03).astype(np.float32))
    return tba.BATracks(poses=poses, landmarks=lms, obs_pose=op, obs_uv=uv,
                        obs_valid=torch.from_numpy(valid), intrinsics=intr,
                        fixed_poses=fixed)


def _k9(exe, tmp, p, iters, lam0, linalg, smem, ctas=2):
    n, k = p.obs_valid.shape
    m = p.poses.shape[0]
    D = 6 * m
    raw = _run(exe, tmp, [
        np.array([n, k, m, iters, linalg == "lu", smem, ctas], np.int32),
        np.array([4.0, lam0], np.float32), p.poses.numpy(),
        p.landmarks.numpy(), p.obs_pose.numpy(), p.obs_uv.numpy(),
        p.obs_valid.numpy().astype(np.uint8),
        p.intrinsics.numpy(), p.fixed_poses.numpy().astype(np.uint8)])
    sizes = [16 * m, 3 * n, iters, iters * (D + 4), D * D, 3 * D + 2, 4]
    out = np.split(raw, np.cumsum(sizes)[:-1])
    code = [int(v) for v in out[6].view(np.float32)]
    routes = dict(index=("device", "shared")[code[0]],
                  landmarks=("device", "shared")[code[1]],
                  step=("device", "shared")[code[2]],
                  solve=("grid_device", "grid", "cta")[code[3]])
    return out[:6], routes


# (m, k, n, case, iters, lam0): a chain and a full band (a closure); the
# slot count, which only bounds loops, is held past 32 on the card
K9_CASES = [(24, 4, 96, "chain", 3, 1e-3), (12, 3, 64, "closure", 3, 1e-2)]
# the shared-memory budgets the routes are chosen for: the H100's; 2 KB,
# where at these sizes some stages stage and the band and the step or the
# panel go to device memory; 256 bytes, where every stage reads device
# memory
K9_SMEM = {"h100": tbg.SMEM_H100, "mixed": 128 + 2048, "device": 128 + 256}


@pytest.mark.parametrize("m,k,n,case,iters,lam0", K9_CASES)
@pytest.mark.parametrize("linalg", ["lu", "chol"])
def test_k9_routes_in_bounds_same_bits(k9_cpu, tmp_path, m, k, n, case,
                                       iters, lam0, linalg):
    """K9 on every route of each stage: no access outside a buffer, the
    routes ``k9_routes`` names, the same bits on every route (the result,
    the trace, S), and the plain LM loop's costs (module doc)."""
    p = _k9_problem(m, k, n, seed=m + k, case=case)
    beta = int(tba.scatter_index(p.obs_pose, m).where(
        p.obs_valid, torch.full_like(p.obs_pose, -1)).max(1).values.sub(
        tba.scatter_index(p.obs_pose, m).where(
            p.obs_valid, torch.full_like(p.obs_pose, m)).min(1).values
    ).clamp(min=0).max())
    outs = {}
    for name, smem in K9_SMEM.items():
        if name == "mixed" and (case, linalg) != ("chain", "lu"):
            continue
        out, routes = _k9(k9_cpu, tmp_path, p, iters, lam0, linalg, smem)
        assert routes == tbg.k9_routes(m, beta, linalg, smem,
                                       warps=K9_WARPS), name
        assert int(out[5].view(np.float32)[-1]) == beta
        outs[name] = (out, routes)
    seen = {v for _, r in outs.values() for v in r.values()}
    assert {"shared", "device", "grid_device"} <= seen
    ref = outs["h100"][0]
    for name, (out, _) in outs.items():
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)
    sp, cp = tba._lm_tracks(p, iters, 4.0, lam0, False, linalg,
                            kernel=False)
    costs, cp = ref[2].view(np.float32), cp.numpy()
    first = float(ref[5].view(np.float32)[3 * 6 * m])
    assert abs(first - float(tba._tracks_cost(p, 4.0))) <= 1e-5 * first
    assert costs[-1] < 0.5 * first
    assert (costs[-1] - cp[-1]) / first <= 1e-4, (costs, cp)


def _k8_inputs(a_n, q_n, b_n, seed, w=640, h=480, p=7):
    """chip_smoke.py's ``pnp_inputs`` recipe on the CPU: map points in
    front of the camera, detections at the projections of three quarters
    of them under the true pose (rounded) and outliers, 10% of the
    detections invalid, the prior pose off by a drift, binary descriptors
    that the true detection's centre patch repeats."""
    rng = np.random.RandomState(seed)
    intr = np.asarray((640.0, 640.0, 320.0, 240.0), np.float32)
    z = rng.uniform(3.0, 8.0, a_n)
    X = np.stack([(rng.uniform(0, w, a_n) - w / 2) * z / intr[0],
                  (rng.uniform(0, h, a_n) - h / 2) * z / intr[1], z], 1)
    T_true = np.eye(4)
    T_true[:3, 3] = [0.05, -0.03, 0.02]
    T_prior = T_true.copy()
    T_prior[:2, 3] += [0.12, -0.08]
    xc = X @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([intr[1] * xc[:, 1] / xc[:, 2] + intr[3],
                   intr[0] * xc[:, 0] / xc[:, 2] + intr[2]], 1)
    src = rng.permutation(a_n)[:min(q_n, a_n) * 3 // 4]
    pos = np.stack([rng.randint(0, h, q_n), rng.randint(0, w, q_n)], 1)
    pos[:len(src)] = np.round(uv[src])
    pos = np.clip(pos, 0, [h - 1, w - 1])
    valid = rng.rand(q_n) > 0.1
    desc = (rng.rand(a_n, p * p) > 0.5) * 8.0
    det = (rng.rand(9, q_n, p * p) > 0.5) * 8.0
    det[4, :len(src)] = desc[src] + rng.normal(0, 0.1, (len(src), p * p))
    base = rng.rand(b_n, a_n) > np.linspace(0.1, 0.5, b_n)[:, None]
    return tuple(torch.from_numpy(v) for v in (
        X.astype(np.float32), desc.astype(np.float32), base,
        pos.astype(np.int32), valid, det.astype(np.float32),
        T_prior.astype(np.float32), intr))


K8_KW = dict(r_wide=40.0, bmax=0.4, gate=0.35, rounds=2, pnp_iters=6,
             huber=4.0)


def _k8(exe, tmp, ops, staged):
    X, desc, base, pos, valid, det, T_prior, intr = ops
    a_n, q_n, b_n, p2 = X.shape[0], pos.shape[0], base.shape[0], \
        desc.shape[1]
    kw = K8_KW
    bmax_f, step_f = tmv._vote_steps(kw["bmax"])
    raw = _run(exe, tmp, [
        np.array([a_n, q_n, b_n, p2, kw["rounds"], kw["pnp_iters"], staged],
                 np.int32),
        np.array([kw["r_wide"] ** 2, bmax_f, step_f,
                  (2.0 * tmv.vote_step(kw["bmax"])) ** 2, 2.0 * kw["gate"],
                  kw["huber"], kw["huber"] / 2], np.float32),
        X.numpy(), desc.numpy(), base.numpy().astype(np.uint8), pos.numpy(),
        valid.numpy().astype(np.uint8), det.numpy(), T_prior.numpy(),
        intr.numpy()])
    sizes = [16 * b_n, b_n, b_n, 2 * b_n * kw["rounds"], b_n * a_n,
             2 * b_n * a_n, b_n * a_n]
    T, err, n, txy, j1, uv1, inl = np.split(raw, np.cumsum(sizes)[:-1])
    return dict(T=T.view(np.float32).reshape(b_n, 4, 4),
                err=err.view(np.float32), n=n,
                txy=txy.view(np.float32).reshape(b_n, -1, 2),
                j1=j1.reshape(b_n, a_n),
                uv1=uv1.view(np.float32).reshape(b_n, a_n, 2),
                inl=inl.reshape(b_n, a_n).astype(bool))


# (A, Q, B): Q past the staged route's size at a small budget
K8_CASES = [(300, 200, 2), (160, 700, 1)]


@pytest.mark.parametrize("a_n,q_n,b_n", K8_CASES)
def test_k8_routes_in_bounds_and_bit_equal(k8_cpu, tmp_path, a_n, q_n, b_n):
    """K8 staged and on its device route, one cluster launch of every
    match set: no access outside a buffer, the plain version's shifts,
    ``j1``, ``uv1``, ``inl`` and ``n`` bit for bit on both, T and err
    within 1e-4 of it, and the two routes' T and err the same bits. The
    route the wrapper takes at this Q with a budget of a few hundred
    detections is the device one, at the H100's the staged one."""
    ops = _k8_inputs(a_n, q_n, b_n, seed=q_n)
    assert tmv.k8_route(q_n, tmv.staged_bytes(128)) == "device"
    assert tmv.k8_route(q_n, 208000) == "shared"
    want = tmv._map_vote_pnp_plain(*ops, **K8_KW)
    got = {staged: _k8(k8_cpu, tmp_path, ops, staged) for staged in (1, 0)}
    for g in got.values():
        np.testing.assert_array_equal(g["txy"].view(np.int32),
                                      want.txy.numpy().view(np.int32))
        np.testing.assert_array_equal(g["uv1"].view(np.int32),
                                      want.uv1.numpy().view(np.int32))
        np.testing.assert_array_equal(g["j1"], want.j1.numpy())
        np.testing.assert_array_equal(g["inl"], want.inl.numpy())
        np.testing.assert_array_equal(g["n"], want.n.numpy())
        np.testing.assert_allclose(g["T"], want.T.numpy(), atol=1e-4)
        np.testing.assert_allclose(g["err"], want.err.numpy(), atol=1e-4)
    assert int(want.inl.sum()) > 0 and int(want.n.min()) > 0
    for key in ("T", "err"):
        np.testing.assert_array_equal(got[0][key].view(np.int32),
                                      got[1][key].view(np.int32))


def test_k8_route_by_detection_count():
    """The route ``map_vote_pnp`` takes for a detection count, where the
    card's 16384 cap raised before: staged up to what a CTA's shared
    memory holds beside the kernel's own (~208 KB on the H100: the 1080p
    tracker's 20736 detections stage), in device memory past it."""
    h100 = 232448 - 24 * 1024           # a CTA's dynamic bytes, about
    assert tmv.staged_bytes(16384) == 16384 * 8 + 512 * 4 + 16384
    assert tmv.k8_route(16384, h100) == "shared"
    assert tmv.k8_route(20736, h100) == "shared"
    assert tmv.k8_route(65536, h100) == "device"
    assert tmv.k8_route(1 << 24, h100) == "device"
