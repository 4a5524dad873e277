"""Parity of the port's host interop and video input (``vpp_tpu_torch.io``)
with vpp_tpu's on the CPU: the synthetic clip, the numpy bridge with its
border modes, ``open_clip`` from an ndarray and from ``.npy`` / ``.npz``
files, and the frame pumps (``clip_prefetch``, ``foreach_videoframe``),
which on the CPU pass the frames through as tensors.

Tolerance: bit-equal throughout (copies and float32 means of the same
numpy values)."""

import importlib

import numpy as np
import pytest
import torch

jio = importlib.import_module("vpp_tpu.io")
tio = importlib.import_module("vpp_tpu_torch.io")
jvideo = importlib.import_module("vpp_tpu.io.video")
tvideo = importlib.import_module("vpp_tpu_torch.io.video")

torch.set_num_threads(1)
CPU = "cpu"


def _eq(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t, j, strict=True)


@pytest.mark.parametrize("w,h,n,seed,speed", [(64, 48, 5, 0, 1),
                                               (33, 17, 3, 7, 2),
                                               (640, 480, 2, 0, 1)])
def test_synthetic_clip_bit_equal(w, h, n, seed, speed):
    t = tio.synthetic_clip(w, h, n, seed=seed, speed=speed)
    j = jio.synthetic_clip(w, h, n, seed=seed, speed=speed)
    assert t.shape == (n, h, w)
    _eq(t, j)


@pytest.mark.parametrize("border,mode", [(0, "mirror"), (2, "mirror"),
                                         (3, "closest"), (1, "zero")])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.float64])
def test_from_numpy_round_trip(border, mode, dtype):
    rng = np.random.RandomState(border)
    a = (rng.rand(7, 9, 3) * 255).astype(dtype)
    t = tio.from_numpy(a, border=border, border_mode=mode, device=CPU)
    j = jio.from_numpy(a, border=border, border_mode=mode)
    assert t.border == j.border == border
    _eq(t.data, j.data)
    _eq(tio.to_numpy(t), jio.to_numpy(j))
    back = tio.to_opencv(tio.from_opencv(a[..., 0], border=border,
                                         border_mode=mode, device=CPU))
    _eq(back, jio.to_numpy(jio.from_numpy(a[..., 0], border=border,
                                          border_mode=mode)))
    assert tio.from_opencv is tio.from_numpy


def test_from_numpy_defaults_to_the_card():
    a = np.zeros((2, 2), np.float32)
    if torch.cuda.is_available():
        assert tio.from_numpy(a).data.is_cuda
    else:
        with pytest.raises(RuntimeError):
            tio.from_numpy(a)


def _clip():
    rng = np.random.RandomState(3)
    return (rng.rand(6, 8, 10, 3) * 255).astype(np.uint8)


def _sources(tmp_path):
    clip = _clip()
    np.save(tmp_path / "clip.npy", clip)
    np.savez(tmp_path / "clip.npz", frames=clip, other=clip[:1])
    return [clip, str(tmp_path / "clip.npy"), str(tmp_path / "clip.npz")]


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("max_frames", [None, 4, 0])
def test_open_clip_sources(tmp_path, gray, max_frames):
    for src in _sources(tmp_path):
        t = list(tio.open_clip(src, max_frames=max_frames, gray=gray))
        j = list(jio.open_clip(src, max_frames=max_frames, gray=gray))
        assert len(t) == len(j) == (6 if max_frames is None else max_frames)
        for a, b in zip(t, j):
            assert isinstance(a, np.ndarray)
            assert a.shape == ((8, 10) if gray else (8, 10, 3))
            _eq(a, b)


def test_open_clip_without_opencv(monkeypatch):
    """A video path where OpenCV is missing (as on the card's machine)
    raises the JAX module's RuntimeError."""
    for mod in (jvideo, tvideo):
        monkeypatch.setattr(mod, "_try_cv2", lambda: None)
        with pytest.raises(RuntimeError, match="cv2 unavailable"):
            list(mod.open_clip("clip.mp4"))


@pytest.mark.parametrize("n", [0, 1, 5])
def test_clip_prefetch_frames(n):
    frames = list(np.random.RandomState(n).rand(n, 6, 7).astype(np.float32))
    t = list(tio.clip_prefetch(iter(frames), device=CPU))
    j = list(jio.clip_prefetch(iter(frames)))
    assert len(t) == len(j) == n
    for a, b in zip(t, j):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        _eq(a, b)


@pytest.mark.parametrize("prefetch", [True, False])
def test_foreach_videoframe(tmp_path, prefetch):
    for src in _sources(tmp_path):
        got, want = [], []
        nt = tio.foreach_videoframe(src, got.append, max_frames=5,
                                    prefetch=prefetch, device=CPU)
        nj = jio.foreach_videoframe(src, want.append, max_frames=5,
                                    prefetch=prefetch)
        assert nt == nj == len(got) == 5
        for a, b in zip(got, want):
            assert isinstance(a, torch.Tensor)
            _eq(a, b)
