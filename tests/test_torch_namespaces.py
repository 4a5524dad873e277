"""The port's package namespaces mirror vpp_tpu's: every name in the JAX
``core``, ``algorithms``, ``slam``, ``draw``, ``ops``, ``io``, ``utils``
and ``parallel`` ``__all__``
resolves in the port with the same kind (class, function, module or
value), except the names that ``ROADMAP.md`` queue 1 still lists as not
ported. That list may only shrink: a listed name that resolves fails the
test, so that it leaves the list when its module lands."""

import importlib
import inspect
import subprocess
import sys

import pytest

# name -> the queue-1 item of ROADMAP.md that ports it
NOT_YET_PORTED = {
    "core": {},
    "algorithms": {},
    "slam": {},
    "draw": {},
    "ops": {},
    "io": {},
    "utils": {},
    "parallel": {},
}


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else "value"


@pytest.mark.parametrize("sub", ["core", "algorithms", "slam", "draw", "ops",
                                 "io", "utils", "parallel"])
def test_jax_names_resolve_in_the_port(sub):
    jax_pkg = importlib.import_module(f"vpp_tpu.{sub}")
    port = importlib.import_module(f"vpp_tpu_torch.{sub}")
    missing = NOT_YET_PORTED[sub]
    assert set(missing) <= set(jax_pkg.__all__), set(missing) - set(
        jax_pkg.__all__)
    for name in jax_pkg.__all__:
        if name in missing:
            assert not hasattr(port, name), (
                f"{sub}.{name} is ported: take it off NOT_YET_PORTED")
            continue
        assert name in port.__all__, f"{sub}.{name} is not in __all__"
        assert _kind(getattr(port, name)) == _kind(getattr(jax_pkg, name)), (
            sub, name)
    for name in port.__all__:
        getattr(port, name)


def test_bare_import_reaches_the_subpackages():
    """A fresh interpreter: ``import vpp_tpu_torch`` alone reaches the
    subpackages' names, and ``algorithms.pyramid`` is the function."""
    code = (
        "import inspect, vpp_tpu_torch as v\n"
        "assert inspect.isfunction(v.algorithms.video_extruder_run)\n"
        "assert inspect.isclass(v.core.Image2d)\n"
        "assert inspect.isfunction(v.slam.slam_run)\n"
        "assert inspect.isfunction(v.algorithms.pyramid)\n"
        "assert inspect.isfunction(v.draw.draw_line)\n"
        "assert inspect.isfunction(v.ops.hsv_to_rgb)\n"
        "assert inspect.isfunction(v.ops.pixel_wise)\n"
        "assert inspect.isfunction(v.io.foreach_videoframe)\n"
        "assert inspect.isfunction(v.algorithms.lucas_kanade)\n"
        "assert inspect.isfunction(v.slam.vanishing_points)\n"
        "assert inspect.isfunction(v.parallel.make_mesh)\n"
        "import importlib\n"
        "m = importlib.import_module('vpp_tpu_torch.algorithms.pyramid')\n"
        "assert inspect.ismodule(m) and m.pyramid is v.algorithms.pyramid\n"
        "try:\n"
        "    v.no_such_subpackage\n"
        "except AttributeError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('no AttributeError')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
