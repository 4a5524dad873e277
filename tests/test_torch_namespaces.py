"""The port's package namespaces mirror vpp_tpu's: every name in the JAX
``core``, ``algorithms`` and ``slam`` ``__all__`` resolves in the port with
the same kind (class, function or module), except the names that
``ROADMAP.md`` queue 1 still lists as not ported. That list may only
shrink: a listed name that resolves fails the test, so that it leaves the
list when its module lands."""

import importlib
import inspect
import subprocess
import sys

import pytest

# name -> the queue-1 item of ROADMAP.md that ports it
NOT_YET_PORTED = {
    "core": {
        **{n: "1.1 helpers" for n in (
            "pad_to_multiple", "copy", "copy_with_border",
            "bilinear_image")},
        **{n: "3 core/imagend.py" for n in (
            "BoxNd", "ImageNd", "from_array_nd", "image3d", "imagend",
            "make_box3d", "make_boxNd")},
    },
    "algorithms": {
        **{n: "1.1 helpers" for n in (
            "antialias_subsample2", "pyramid_update")},
        **{n: "1.1 ukf.py" for n in (
            "UKFState", "ukf_init", "ukf_predict", "ukf_update",
            "ukf_predict_update_rho_theta")},
        **{n: "1.1 the rest of hough.py" for n in (
            "accumulator_to_lines", "hough_adaptive_threshold",
            "hough_lines", "hough_peaks_clustered", "hough_sparse_revote",
            "hough_top_k", "line_endpoints")},
        **{n: "2 scharr.py, lbp.py" for n in (
            "scharr", "scharr_point", "lbp_hamming_distance",
            "lbp_transform")},
        **{n: "2 lk.py" for n in (
            "gradient_pyramid", "lk_match_batch", "lucas_kanade",
            "oriented_lk_match_batch", "pyrlk_match")},
        **{n: "2 sparse_flow.py" for n in (
            "SparseFlow", "sparse_optical_flow")},
        **{n: "2 matcher.py" for n in (
            "bruteforce_match", "cross_check_match", "hamming_distance",
            "local_match", "pairwise_distances", "sad_distance")},
        **{n: "2 distance_transform.py" for n in (
            "chamfer_distance_transform", "euclidean_distance_transform",
            "d3_4", "d4", "d5_7_11", "d8")},
    },
    "slam": {n: "2 slam/sfm.py" for n in (
        "plucker_from_points", "plucker_transform", "plucker_point_distance",
        "pose_from_line_correspondences", "vanishing_points",
        "image_line_normals")},
}


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else "value"


@pytest.mark.parametrize("sub", ["core", "algorithms", "slam"])
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
