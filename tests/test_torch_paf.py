"""The port's OpenPose PAF module (``cvpytorch_tpu_torch/ops/paf.py``)
against the JAX package's ``ops/paf.py`` on the CPU, function by function,
on shared inputs made from numpy seeds.

Tolerances: ``add_neck``, the reorder and ``_remove_illegal`` equal; the
rendered PAFs and the gaussians' support equal in float64 and the
gaussians within 1e-15 (the boundary tests ``expo <= 4.6052``, ``dist <
1`` and the rounded limb boxes flip on one ulp, so float32 is held to
1e-6, and XLA's float64 ``exp`` differs from torch's in the last bit); the peaks' scores, validity and grid cells equal and their
sub-pixel positions within 1e-5 (XLA's and torch's ``log`` differ in the
last bit); the sample positions equal ``jnp.linspace``'s; pair scores
within 1e-6 and the ``ok`` mask equal in float64; the greedy matches
equal on shared scores with ties; the decoded people and their eval dict
within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.ops import paf as J
from cvpytorch_tpu_torch.ops import paf as P


def random_people(rng, B, M, hw, vis=(0, 1, 2)):
    """(B, M, 17, 3) keypoints, some off the frame, some on the grid's
    half-stride positions (the rounded limb boxes' ties)."""
    kp = np.zeros((B, M, 17, 3), np.float64)
    kp[..., 0] = rng.uniform(-20, hw[1] + 20, (B, M, 17))
    kp[..., 1] = rng.uniform(-20, hw[0] + 20, (B, M, 17))
    kp[..., 2] = rng.choice(vis, (B, M, 17))
    snap = rng.rand(B, M, 17) < 0.3
    kp[..., 0] = np.where(snap, np.round(kp[..., 0] / 4) * 4, kp[..., 0])
    kp[..., 1] = np.where(snap, np.round(kp[..., 1] / 4) * 4, kp[..., 1])
    return kp


def skeleton(cx, cy, scale=1.0):
    """A roughly anatomical 17-keypoint COCO skeleton around (cx, cy)."""
    pts = np.array([
        [0, -60], [-6, -66], [6, -66], [-14, -62], [14, -62],
        [-22, -40], [22, -40], [-32, -10], [32, -10], [-36, 18], [36, 18],
        [-14, 20], [14, 20], [-16, 60], [16, 60], [-18, 96], [18, 96]],
        np.float32) * scale
    kp = np.zeros((17, 3), np.float32)
    kp[:, 0] = cx + pts[:, 0]
    kp[:, 1] = cy + pts[:, 1]
    kp[:, 2] = 2
    return kp


def test_add_neck_reorder_and_illegal_match_jax():
    kp = random_people(np.random.RandomState(0), 2, 3, (64, 64))
    kp[0, 0, 5:7, 2] = 2  # a neck of visibility 2
    got = P.add_neck(torch.from_numpy(kp))
    with jax.enable_x64(True):
        want = np.asarray(J.add_neck(jnp.asarray(kp)))
        back = np.asarray(J.openpose18_to_coco17(jnp.asarray(want)))
        ill = np.asarray(J._remove_illegal(jnp.asarray(want), 60, 50))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.openpose18_to_coco17(got).numpy(), back)
    np.testing.assert_array_equal(P._remove_illegal(got, 60, 50).numpy(), ill)


@pytest.mark.parametrize("seed,hw,stride", [(0, (64, 64), 8), (1, (96, 64), 8),
                                            (2, (64, 48), 4)])
def test_render_targets_match_jax(seed, hw, stride):
    """Float64 equal, float32 within 1e-6, padded rows inert."""
    rng = np.random.RandomState(seed)
    kp = random_people(rng, 2, 4, hw)
    valid = np.array([[1, 1, 1, 0], [1, 0, 1, 0]], np.float64)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in J.render_openpose_targets(
            jnp.asarray(kp), jnp.asarray(valid), hw, stride=stride)]
    got = P.render_openpose_targets(torch.from_numpy(kp), torch.from_numpy(valid), hw,
                                    stride=stride)
    assert got[0].dtype == got[1].dtype == torch.float64
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    # XLA's and torch's float64 exp differ in the last bit: the gaussians'
    # support (the 4.6052 cut) is equal, their values within 1e-15
    np.testing.assert_array_equal(got[0].numpy()[..., :18] > 0, want[0][..., :18] > 0)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-15, rtol=0)
    assert want[1].any() and (want[0][..., :18] > 0).any()
    want32 = [np.asarray(a) for a in J.render_openpose_targets(
        jnp.asarray(kp, jnp.float32), jnp.asarray(valid, jnp.float32), hw, stride=stride)]
    got32 = P.render_openpose_targets(torch.from_numpy(kp).float(),
                                      torch.from_numpy(valid).float(), hw, stride=stride)
    for g, w in zip(got32, want32):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)


def peak_maps(seed, B=2, hw=(23, 17), K=18):
    """Random maps quantised to 1/8 (plateaus and equal peaks), gaussian
    bumps on some channels, and channels with no peak above 0.1."""
    rng = np.random.RandomState(seed)
    m = np.round(rng.rand(B, *hw, K) * 8) / 8 * 0.6
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    for b in range(B):
        for k in range(0, K, 3):
            cy, cx = rng.uniform(2, hw[0] - 2), rng.uniform(2, hw[1] - 2)
            m[b, :, :, k] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4)
    m[:, :, :, 4] = 0.05
    return m.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_find_peaks_matches_jax(seed):
    maps = peak_maps(seed)
    want = [np.asarray(a) for a in J.find_peaks(jnp.asarray(maps))]
    got = [t.numpy() for t in P.find_peaks(torch.from_numpy(maps))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[2].sum() > 40 and not want[2].all()
    err = np.abs(got[0] - want[0]).max()
    assert err <= 1e-5, err


def test_sample_positions_equal_jnp_linspace():
    """``torch.linspace`` differs from ``jnp.linspace`` in the last bit."""
    for n in (10, 7):
        np.testing.assert_array_equal(P.sample_positions(n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))
        with jax.enable_x64(True):
            np.testing.assert_array_equal(P.sample_positions(n, torch.float64).numpy(),
                                          np.asarray(jnp.linspace(0.0, 1.0, n)))


def limb_inputs(seed, dtype=np.float64):
    """Peaks from rendered targets of three skeletons, the PAFs with
    noise, in ``dtype``."""
    rng = np.random.RandomState(seed)
    kp = np.stack([skeleton(60, 100, 0.6), skeleton(130, 110, 0.6), skeleton(95, 60, 0.4)])
    kp[..., :2] += rng.uniform(-3, 3, kp[..., :2].shape)
    hm, pafs = J.render_openpose_targets(jnp.asarray(kp)[None], jnp.ones((1, 3)), (184, 184))
    pafs = np.asarray(pafs) + rng.randn(*pafs.shape).astype(np.float32) * 0.05
    xy, _, valid = J.find_peaks(hm[..., :18])
    return np.asarray(xy, dtype), np.asarray(valid), pafs.astype(dtype)


def test_score_limb_pairs_matches_jax():
    xy, valid, pafs = limb_inputs(0)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in J.score_limb_pairs(
            jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(pafs))]
    got = [t.numpy() for t in P.score_limb_pairs(torch.from_numpy(xy), torch.from_numpy(valid),
                                                 torch.from_numpy(pafs))]
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum() >= 40
    np.testing.assert_allclose(got[0], want[0], atol=1e-12, rtol=0)
    xy32, valid, pafs32 = limb_inputs(0, np.float32)
    want32 = np.asarray(J.score_limb_pairs(jnp.asarray(xy32), jnp.asarray(valid),
                                           jnp.asarray(pafs32))[0])
    got32 = P.score_limb_pairs(torch.from_numpy(xy32), torch.from_numpy(valid),
                               torch.from_numpy(pafs32))[0].numpy()
    np.testing.assert_allclose(got32, want32, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_limb_match_matches_jax(seed):
    """Scores quantised to 1/16 (ties across rows and columns), about
    half the pairs ok, and one problem with none."""
    rng = np.random.RandomState(seed)
    scores = (np.round(rng.rand(2, 19, 20, 20) * 16) / 16).astype(np.float32)
    ok = rng.rand(2, 19, 20, 20) < 0.5
    ok[1, 3] = False
    want = np.asarray(jax.jit(J.greedy_limb_match)(jnp.asarray(scores), jnp.asarray(ok)))
    got = P.greedy_limb_match(torch.from_numpy(scores), torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[..., 0] >= 0).sum() > 500 and (want[1, 3] == -1).all()


def test_decode_and_eval_dict_match_jax():
    """Three skeletons' rendered maps through ``openpose_decode`` and
    ``instances_to_eval`` (letterboxed by pads and scales): the people,
    their scores and the eval dict."""
    kp = np.stack([skeleton(60, 100, 0.6), skeleton(130, 110, 0.6), skeleton(95, 60, 0.4)])
    hm, pafs = J.render_openpose_targets(jnp.asarray(kp)[None].repeat(2, 0),
                                         jnp.ones((2, 3)), (184, 184))
    want = J.openpose_decode(hm, pafs)
    got = P.openpose_decode(torch.from_numpy(np.asarray(hm)), torch.from_numpy(np.asarray(pafs)))
    assert len(got) == 2 and len(got[0][0]) == len(want[0][0]) >= 3
    for (gp, gs), (wp, ws) in zip(got, want):
        np.testing.assert_allclose(gp, wp, atol=1e-5, rtol=0)
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    t = {"pads": np.array([[3.0, 7.0], [0.0, 0.0]], np.float32),
         "scales": np.array([[0.5, 0.5], [1.0, 1.0]], np.float32)}
    w_eval = J.instances_to_eval(want, 8.0, t)
    g_eval = P.instances_to_eval(got, 8.0, t)
    assert set(g_eval) == set(w_eval)
    for k in w_eval:
        np.testing.assert_allclose(g_eval[k], w_eval[k], atol=1e-5, rtol=0, err_msg=k)
