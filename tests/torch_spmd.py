"""Run SPMD cases of the port on a gloo process group on the CPU.

``run_group(world, module, names, payload)`` spawns ``world`` ranks (the
``spawn`` start method: the test process has JAX's threads running), each
of which joins a gloo group through a ``file://`` store in a temporary
directory (so parallel test workers never contend for a TCP port), calls
``module.<name>()`` (``module.<name>(payload)`` where a payload of numpy
inputs is given) for each name in order, and saves what it returns. With
``init=False`` the ranks join no group: the cases do (rank and a store
path in ``SPMD_RANK``, ``SPMD_STORE``). The
ranks import only ``torch``, ``numpy`` and ``vpp_tpu_torch`` (``module``
must do the same). Returns one {name: result} dict a rank, in rank order; a
case that raised on any rank fails the call with its traceback.

The inputs of the cases come from the numpy recipes below, which the test
files also feed to the JAX package.
"""

from __future__ import annotations

import importlib
import os
import tempfile
import traceback

import numpy as np


def _rank_main(rank: int, world: int, store: str, module: str, names,
               out_dir: str, payload, init: bool) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["SPMD_RANK"], os.environ["SPMD_STORE"] = str(rank), store
    if init:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
    results = {}
    try:
        mod = importlib.import_module(module)
        for name in names:
            fn = getattr(mod, name)
            results[name] = fn() if payload is None else fn(payload)
    except BaseException:  # reported by the parent with the rank's trace
        results = {"__error__": traceback.format_exc()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    if dist.is_initialized():
        if "__error__" not in results:
            dist.barrier()
        dist.destroy_process_group()


def run_group(world: int, module: str, names, payload=None,
              timeout: float = 300.0, init: bool = True):
    import torch
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   module, list(names), tmp, payload,
                                   init))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        out = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            assert os.path.exists(path), (
                f"rank {r} left no result (exit codes "
                f"{[p.exitcode for p in procs]})")
            res = torch.load(path, weights_only=False)
            assert "__error__" not in res, f"rank {r}:\n{res['__error__']}"
            out.append(res)
    return out


def scene(shift, seed=0, h=64, w=320):
    """Two integer-valued frames of a smoothed random texture, the second
    shifted by ``shift`` (tests/test_sharded_tracker.py's ``_scene``)."""
    from numpy.lib.stride_tricks import sliding_window_view
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (h * 2, w * 2)).astype(np.float32)
    sm = sliding_window_view(np.pad(base, 1, mode="wrap"), (3, 3))
    sm = (sm.sum(axis=(2, 3)) // 9).astype(np.float32)
    f1 = sm[32:32 + h, 32:32 + w]
    f2 = sm[32 + shift[0]:32 + shift[0] + h,
            32 + shift[1]:32 + shift[1] + w]
    return np.ascontiguousarray(f1), np.ascontiguousarray(f2)


def points(n, seed=1, h=64, w=320):
    """Keypoints away from the column margins (``_pts``)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(8, h - 8, n),
                     rng.randint(40, w - 56, n)], -1).astype(np.float32)
