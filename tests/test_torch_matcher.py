"""Parity of vpp_tpu_torch's matchers with vpp_tpu's on the CPU.

SAD and Hamming are bit-equal on integer-valued descriptors (every sum is
an integer below 2^24, exact in any order), and so are the indices and
``found`` of every matcher over them. On the float descriptors of
tests/test_geometry_matcher.py:56-105 the SAD sums round in another order:
indices equal, distances within 1e-6 relative. Squared L2 goes through a
float32 product whose terms cancel: indices equal, distances within
1e-6 of |q|² + |t|² (a few float32 ulps of the terms that cancel).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jm = importlib.import_module("vpp_tpu.algorithms.matcher")
tm = importlib.import_module("vpp_tpu_torch.algorithms.matcher")

torch.set_num_threads(1)


def _desc(kind, n, d, seed):
    rng = np.random.RandomState(seed)
    if kind == "uint8":
        return rng.randint(0, 256, (n, d)).astype(np.uint8)
    return rng.randint(0, 255, (n, d)).astype(np.float32)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def test_sad_and_hamming_distance_bit_equal():
    rng = np.random.RandomState(2)                  # :83
    a = rng.randint(0, 256, (8,), dtype=np.uint8)
    b = rng.randint(0, 256, (8,), dtype=np.uint8)
    expect = sum(bin(int(x) ^ int(y)).count("1") for x, y in zip(a, b))
    assert int(tm.hamming_distance(torch.from_numpy(a),
                                   torch.from_numpy(b))) == expect
    assert int(jm.hamming_distance(jnp.asarray(a), jnp.asarray(b))) == expect
    for kind in ("uint8", "float32"):
        q, t = _desc(kind, 2, 49, 3)
        js = np.asarray(jm.sad_distance(jnp.asarray(q), jnp.asarray(t)))
        ts = tm.sad_distance(torch.from_numpy(q), torch.from_numpy(t))
        np.testing.assert_array_equal(js, ts.numpy())


@pytest.mark.parametrize("distance,kind,d", [
    ("sad", "uint8", 49), ("sad", "float32", 16), ("hamming", "uint8", 32),
    ("hamming", "uint8", 1)])
def test_pairwise_bit_equal(distance, kind, d):
    q = _desc(kind, 37, d, 4)
    t = _desc(kind, 53, d, 5)
    (jq, tq), (jt, tt) = _pair(q), _pair(t)
    j = np.asarray(jm.pairwise_distances(jq, jt, distance))
    g = tm.pairwise_distances(tq, tt, distance)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(j, g.numpy())


@pytest.mark.parametrize("distance,block", [
    ("sad", None), ("sad", 17), ("sad", 100), ("hamming", None),
    ("hamming", 7)])
def test_bruteforce_bit_equal(distance, block):
    """Integer descriptors with repeated rows (ties: the first minimum, and
    with blocks the first best block)."""
    kind = "uint8" if distance == "hamming" else "float32"
    t = _desc(kind, 100, 16, 1)
    t[50:60] = t[10:20]                             # exact ties
    rng = np.random.RandomState(6)
    q = t[rng.permutation(100)[:30]].copy()
    if kind == "float32":
        q = q + rng.randint(-2, 3, q.shape).astype(np.float32)
    (jq, tq), (jt, tt) = _pair(q), _pair(t)
    ji, jd = jm.bruteforce_match(jq, jt, distance=distance,
                                 train_block=block)
    ti, td = tm.bruteforce_match(tq, tt, distance=distance,
                                 train_block=block)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_bruteforce_float_descriptors():
    """tests/test_geometry_matcher.py:56's inputs (float SAD and L2)."""
    rng = np.random.RandomState(1)
    train = rng.randint(0, 255, (100, 16)).astype(np.float32)
    query = (train[rng.permutation(100)[:20]]
             + rng.randn(20, 16)).astype(np.float32)
    (jq, tq), (jt, tt) = _pair(query), _pair(train)
    mag = (query ** 2).sum(1)[:, None] + (train ** 2).sum(1)[None, :]
    for distance, block in (("sad", None), ("sad", 17), ("l2", None)):
        ji, jd = jm.bruteforce_match(jq, jt, distance=distance,
                                     train_block=block)
        ti, td = tm.bruteforce_match(tq, tt, distance=distance,
                                     train_block=block)
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        tol = (1e-6 * np.asarray(jd) if distance == "sad"
               else 1e-6 * mag[np.arange(20), np.asarray(ji)])
        assert (np.abs(td.numpy() - np.asarray(jd)) <= tol).all()
    jl = np.asarray(jm.pairwise_distances(jq, jt, "l2"))
    tl = tm.pairwise_distances(tq, tt, "l2").numpy()
    assert (np.abs(tl - jl) <= 1e-6 * mag).all()


@pytest.mark.parametrize("shift", [0.0, 1000.0])
def test_local_match_radius(shift):
    """tests/test_geometry_matcher.py:87's inputs on integer descriptors,
    near and far (nothing found: index 0, distance _INF)."""
    rng = np.random.RandomState(3)
    train = rng.randint(0, 255, (50, 8)).astype(np.float32)
    tpos = rng.rand(50, 2).astype(np.float32) * 100
    query = train + 1.0
    qpos = (tpos + shift).astype(np.float32)
    tvalid = rng.rand(50) > 0.2
    qvalid = rng.rand(50) > 0.2
    for kw in ({}, {"train_valid": tvalid, "query_valid": qvalid}):
        jo = jm.local_match(*(jnp.asarray(x) for x in
                              (query, qpos, train, tpos)),
                            search_radius=5.0,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        to = tm.local_match(*(torch.from_numpy(x) for x in
                              (query, qpos, train, tpos)),
                            search_radius=5.0,
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
        for j, t in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(j), t.numpy())
    if shift:
        assert not to[2].any() and (to[0] == 0).all()


def test_cross_check_bit_equal():
    """tests/test_geometry_matcher.py:105, and integer descriptors with
    ties."""
    eye = np.eye(8, dtype=np.float32) * 10
    for q, t in ((eye + 0.01, eye), (_desc("float32", 40, 16, 8),
                                     _desc("float32", 40, 16, 8)[::-1])):
        t = np.ascontiguousarray(t)
        jo = jm.cross_check_match(jnp.asarray(q), jnp.asarray(t))
        to = tm.cross_check_match(torch.from_numpy(q), torch.from_numpy(t))
        for j, g in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(j), g.numpy())
