"""The benchmark's inputs and counts on the CPU: the PyTorch renderer
against ``vpp_tpu_torch/utils/synth.py`` at a tiny size, the BA recipe by
seed, and the frozen K1 and K9 counts against hand counts at tiny
shapes."""

import numpy as np
import pytest
import torch

from portbench.counts import k1, k9
from portbench.inputs import ba_recipe, synth

INTR = (64.0, 64.0, 32.0, 24.0)


@pytest.mark.parametrize("seed", [0, 7])
def test_renderer_equals_utils_synth(seed):
    from vpp_tpu_torch.utils import synth as port_synth
    cloud = port_synth.make_cloud(150, seed=seed, extent=(16.0, 5.0, 3.5),
                                  center=(3.2, 0.0, 5.0))
    poses = port_synth.camera_path(6, step=(0.02, 0.0, 0.0))
    want = port_synth.render_frames(cloud, poses, INTR, (48, 64), seed=seed,
                                    sigma=(1.2, 2.2))
    mine_cloud = synth.make_cloud(150, seed, (16.0, 5.0, 3.5),
                                  (3.2, 0.0, 5.0))
    mine_poses = synth.camera_path(6, (0.02, 0.0, 0.0))
    np.testing.assert_array_equal(mine_cloud, cloud)
    np.testing.assert_array_equal(mine_poses, poses)
    got = synth.render(mine_cloud, mine_poses, INTR, (48, 64), (1.2, 2.2),
                       seed, torch.device("cpu"), chunk=4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_ba_recipe_is_deterministic_by_seed():
    a = ba_recipe.problem(12, 200, 4, 2 ** 31 + 11, 3)
    b = ba_recipe.problem(12, 200, 4, 2 ** 31 + 11, 3)
    c = ba_recipe.problem(12, 200, 4, 2 ** 31 + 11, 4)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["landmarks"], c["landmarks"])
    # exact observations of the true landmarks, in front of the cameras
    uv = ba_recipe.project(a["poses"][a["obs_pose"]].astype(np.float64),
                           a["landmarks_true"][:, None].astype(np.float64),
                           ba_recipe.INTRINSICS)
    np.testing.assert_allclose(uv, a["obs_uv"], atol=1e-3)
    assert a["fixed"][:2].all() and not a["fixed"][2:].any()


def test_k1_count_by_hand():
    # one 8x12 level, border 2, a 2x3 grid of 4 px cells, 3x3 windows, R 1,
    # no propagation, one stream
    lv = dict(h=8, w=12, gh=2, gw=3, R=1, ws=3, patch=4)
    nbytes, ops = k1.level_work(lv, 2, 0, 1)
    assert nbytes == 12 * 16 * 4 * 2 + 6 * 20
    # 9 displacements x (|diff| and sum over the 7x11 span: 154, column
    # sums 2 rows x 11 cols x 2: 44, window sums 6 cells x 2: 12) + argmin
    assert ops == 9 * (154 + 44 + 12) + 6 * 8
    assert k1.level_work(lv, 2, 1, 3)[1] == 3 * (ops + 6 * 8 * 12)
    lvs = k1.tracker_levels(480, 640, 3, 5, 9)
    assert [(x["h"], x["w"], x["gh"], x["gw"], x["R"]) for x in lvs] == [
        (480, 640, 96, 128, 1), (241, 321, 49, 65, 1), (121, 161, 25, 33, 5)]


def test_k9_count_by_hand():
    # 12 unknowns (2 poses) at block half-bandwidth 1: Cholesky band of
    # scalar half-width min(11, 11) = 11, a dense factorisation
    want = sum(min(11, 11 - j) * (min(11, 11 - j) + 2) + 4 * min(11, 11 - j)
               for j in range(12))
    assert k9.band_ops(12, 1, "chol") == want
    assert k9.band_of(np.array([[0, 1], [3, 5], [2, 2]])) == 2
    t = k9.k9_bound_s(3, 2, 2, [2, 2, 1], 1, 1, "chol")
    cnt, pairs = 5, 3 + 3 + 1
    ops = (60 * cnt + 486 * cnt * 67 / 34 + 216 * pairs * 67 / 67
           + want)
    nbytes = 2 * 2 * 64 + 2 * 3 * 12 + 3 * 2 * 13 + 16 + 2 + 4
    assert t == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
