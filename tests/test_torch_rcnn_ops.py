"""The ops and modules under the port's Mask R-CNN against the JAX package
on the CPU, float32, from numpy-seeded inputs: the weight carry of the
three leaves that a shape check cannot tell apart (a square ``Dense``, a
``ConvTranspose`` with as many inputs as outputs, the NHWC flatten before
``fc1``), ResNet and FPN features, anchors and deltas, ROIAlign in each of
its forms, the mask-target crop, mask pasting and class-agnostic NMS."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models import rcnn as jrcnn
from cvpytorch_tpu.models.backbones.resnet import ResNet as JaxResNet
from cvpytorch_tpu.models.necks.fcos_fpn import FPN as JaxFPN
from cvpytorch_tpu.models.necks.fcos_fpn import _upsample_to as jax_upsample_to
from cvpytorch_tpu.ops import masks as jmasks
from cvpytorch_tpu.ops import roi_align as jroi
from cvpytorch_tpu.ops.nms import batched_nms as jax_batched_nms
from cvpytorch_tpu_torch.models import rcnn
from cvpytorch_tpu_torch.models.backbones.resnet import ResNet
from cvpytorch_tpu_torch.models.necks.fcos_fpn import FPN, _upsample_to
from cvpytorch_tpu_torch.ops import masks, roi_align
from cvpytorch_tpu_torch.ops.nms import batched_nms
from cvpytorch_tpu_torch.utils.porting import _convert, load_jax_variables
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

STRIDES = (4, 8, 16, 32)


def fill_tree(shapes, seed: int):
    """Seeded numpy values for a Flax variable tree of shapes: lecun-normal
    kernels, BN scale/var in [0.5, 1.5], biases and means ~ N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_tree(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return fill_tree(shapes, seed)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


# -- the weight carry: the three leaves a shape check cannot tell apart -----
class _JaxDense(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(16, name="fc")(x)


class _PortDense(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(16, 16)


class _JaxDeconv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(8, (2, 2), strides=(2, 2), name="deconv")(x)


class _PortDeconv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.deconv = torch.nn.ConvTranspose2d(8, 8, 2, 2)


def test_square_dense_kernel_is_transposed():
    """A 16×16 Dense kernel fits ``nn.Linear.weight`` either way round; the
    carry transposes it, and the untransposed copy would be wrong."""
    x = np.random.RandomState(0).randn(5, 16).astype(np.float32)
    variables = init_tree(_JaxDense(), jnp.zeros((1, 16)), seed=1)
    want = np.asarray(_JaxDense().apply(variables, jnp.asarray(x)))
    port = load_jax_variables(_PortDense(), variables)
    with torch.no_grad():
        got = port.fc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    kernel = variables["params"]["fc"]["kernel"]
    naive = x @ kernel.T + variables["params"]["fc"]["bias"]
    assert np.abs(naive - want).max() > 0.1


def test_square_conv_transpose_kernel_is_flipped():
    """Flax's ConvTranspose does not flip its kernel and torch's does: the
    (2, 2, 8, 8) kernel carries as K[::-1, ::-1].transpose(2, 3, 0, 1).
    The plain conv rule (transpose(3, 2, 0, 1)) passes the shape check and
    computes another deconvolution."""
    x = np.random.RandomState(1).randn(2, 5, 6, 8).astype(np.float32)
    variables = init_tree(_JaxDeconv(), jnp.zeros((1, 5, 6, 8)), seed=2)
    want = np.asarray(_JaxDeconv().apply(variables, jnp.asarray(x)))
    port = load_jax_variables(_PortDeconv(), variables)
    with torch.no_grad():
        got = nhwc(port.deconv(nchw(x)))
    assert got.shape == want.shape == (2, 10, 12, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    kernel = variables["params"]["deconv"]["kernel"]
    as_conv = _convert("deconv.weight", kernel, port.deconv.weight)  # no owner
    with torch.no_grad():
        port.deconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(as_conv)))
        wrong = nhwc(port.deconv(nchw(x)))
    assert np.abs(wrong - want).max() > 0.1


def test_box_head_flattens_roi_features_as_nhwc():
    """``fc1`` reads the 7·7·C ROI features in (H, W, C) order, as the JAX
    Dense does: the port's head on NHWC ROI features equals the JAX head
    with the kernel carried only by transposition."""
    C, N, classes = 256, 6, 3
    x = np.random.RandomState(2).randn(N, 7, 7, C).astype(np.float32)
    jhead = jrcnn.BoxHead(classes)
    variables = init_tree(jhead, jnp.zeros((1, 7, 7, C)), seed=3)
    jcls, jreg = jhead.apply(variables, jnp.asarray(x))
    port = load_jax_variables(rcnn.BoxHead(classes), variables)
    with torch.no_grad():
        cls, reg = port(torch.from_numpy(x))
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=1e-5, rtol=1e-5)
    with torch.no_grad():  # the same head fed (C, H, W)-flattened features
        chw = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(N, 7, 7, C)
        assert (port(chw)[0].numpy() - np.asarray(jcls)).__abs__().max() > 1e-2


def test_mask_head_matches_jax():
    classes = 3
    x = np.random.RandomState(3).randn(4, 14, 14, 256).astype(np.float32)
    jhead = jrcnn.MaskHead(classes)
    variables = init_tree(jhead, jnp.zeros((1, 14, 14, 256)), seed=4)
    want = np.asarray(jhead.apply(variables, jnp.asarray(x)))
    port = load_jax_variables(rcnn.MaskHead(classes), variables)
    with torch.no_grad():
        got = nhwc(port(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# -- backbone and neck --------------------------------------------------------
def test_upsample_is_nearest_exact():
    """``jax.image.resize(..., "nearest")`` is torch's ``nearest-exact`` at
    a ratio that is not an integer (7 → 13), and at 2×."""
    rng = np.random.RandomState(4)
    for src, dst in ((7, 13), (25, 50), (13, 25)):
        x = rng.randn(1, src, src + 1, 3).astype(np.float32)
        ref = np.zeros((1, dst, dst + 2, 3), np.float32)
        want = np.asarray(jax_upsample_to(jnp.asarray(x), jnp.asarray(ref)))
        got = nhwc(_upsample_to(nchw(x), nchw(ref)))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("subtype", ["resnet18", "resnet50"])
def test_resnet_fpn_features_match_jax(subtype):
    """ResNet and the FPN at 64², BN in eval mode: C2–C5 and P2–P6 within
    1e-4.  In train mode BN normalises C5 of a 64² pair by the statistics
    of 8 values a channel, which amplifies each framework's f32 rounding:
    there the port is held to a float64 run of itself, and must be at least
    as close to it as JAX is (ResNet-50, measured: C5 port 1.5e-3 and JAX
    7.3e-3 off float64; ResNet-18 within 1e-4 of JAX)."""
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    jbb = JaxResNet(subtype=subtype, out_stages=(1, 2, 3, 4))
    bb_vars = init_tree(jbb, jnp.zeros((1, 64, 64, 3)), seed=6)
    bb = load_jax_variables(ResNet(subtype=subtype, out_stages=(1, 2, 3, 4)), bb_vars)
    jfeats = jbb.apply(bb_vars, jnp.asarray(x))
    with torch.no_grad():
        feats = bb.eval()(nchw(x))
    assert len(feats) == 4
    for g, w in zip(feats, jfeats):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)

    jtrain, _ = jbb.apply(bb_vars, jnp.asarray(x), train=True, mutable=["batch_stats"])
    f64 = ResNet(subtype=subtype, out_stages=(1, 2, 3, 4)).double()
    f64.load_state_dict(bb.state_dict())
    with torch.no_grad():
        got = bb.train()(nchw(x))
        exact = f64.train()(nchw(x).double())
    for g, w, e in zip(got, jtrain, exact):
        port_err = np.abs(nhwc(g) - nhwc(e)).max()
        jax_err = np.abs(np.asarray(w) - nhwc(e)).max()
        assert port_err <= max(jax_err, 1e-4), (port_err, jax_err)

    jfpn = JaxFPN(out_channels=256, num_outs=5)
    fpn_vars = init_tree(jfpn, [jnp.asarray(f) for f in jfeats], seed=7)
    jp = jfpn.apply(fpn_vars, [jnp.asarray(f) for f in jfeats])
    fpn = load_jax_variables(FPN(bb.channels, 256, 5), fpn_vars)
    with torch.no_grad():
        p = fpn([nchw(np.asarray(f)) for f in jfeats])
    assert [t.shape[-1] for t in p] == [16, 8, 4, 2, 1]
    for g, w in zip(p, jp):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)


# -- anchors, deltas ------------------------------------------------------------
def test_anchors_equal_jax():
    shapes = [(200, 200), (100, 100), (50, 50), (25, 25), (12, 12)]
    got = rcnn.make_anchors(shapes).numpy()
    want = np.asarray(jrcnn.make_anchors(shapes))
    assert got.shape == (159807, 4)
    np.testing.assert_array_equal(got, want)


def test_encode_decode_match_jax():
    rng = np.random.RandomState(6)
    anchors = np.concatenate([rng.uniform(0, 60, (50, 2)), rng.uniform(60, 200, (50, 2))],
                             -1).astype(np.float32)
    anchors[:3, 2:] = anchors[:3, :2]  # zero-size, as padded proposals are
    boxes = (anchors + rng.randn(50, 4) * 8).astype(np.float32)
    deltas = (rng.randn(50, 4) * 2).astype(np.float32)
    enc = rcnn.encode_deltas(torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(
        enc, np.asarray(jrcnn.encode_deltas(jnp.asarray(boxes), jnp.asarray(anchors))),
        rtol=1e-6, atol=1e-6)
    dec = rcnn.decode_deltas(torch.from_numpy(deltas), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(
        dec, np.asarray(jrcnn.decode_deltas(jnp.asarray(deltas), jnp.asarray(anchors))),
        rtol=1e-6, atol=1e-4)
    ok = (boxes[:, 2:] > boxes[:, :2]).all(-1) & (anchors[:, 2:] - anchors[:, :2] >= 1).all(-1)
    rec = rcnn.decode_deltas(torch.from_numpy(enc), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(rec[ok], boxes[ok], atol=1e-3)


# -- ROIAlign ---------------------------------------------------------------------
def roi_boxes(rng, n, lo=-30, span=200, size=(4, 250)):
    xy = rng.rand(n, 2) * span + lo  # some leave the image
    wh = rng.rand(n, 2) * (size[1] - size[0]) + size[0]
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_roi_align_and_batched_roi_align_match_jax():
    rng = np.random.RandomState(7)
    feats = rng.randn(3, 24, 32, 8).astype(np.float32)
    boxes = np.concatenate([roi_boxes(rng, 16, -10, 50, (2, 40)), np.array(
        [[-12, 4, 10, 20], [30, -9, 50, 14], [40, 8, 80, 30], [10, 30, 34, 70]],
        np.float32)])  # each exits the (48, 64)-px image on one axis only
    idx = rng.randint(0, 3, len(boxes))
    got = roi_align.batched_roi_align(torch.from_numpy(feats), torch.from_numpy(boxes),
                                      torch.from_numpy(idx), 7, 0.5).numpy()
    want = np.asarray(jroi.batched_roi_align(jnp.asarray(feats), jnp.asarray(boxes),
                                             jnp.asarray(idx), 7, 0.5))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    got1 = roi_align.roi_align(torch.from_numpy(feats[1]), torch.from_numpy(boxes),
                               output_size=5, spatial_scale=0.5, aligned=False).numpy()
    want1 = np.asarray(jroi.roi_align(jnp.asarray(feats[1]), jnp.asarray(boxes),
                                      output_size=5, spatial_scale=0.5, aligned=False))
    np.testing.assert_allclose(got1, want1, atol=1e-5, rtol=1e-5)


def fpn_inputs(seed=8, B=2, C=5, n=24):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, 64 // s * 4, 64 // s * 4, C).astype(np.float32)
             for s in STRIDES]
    return feats, roi_boxes(rng, n), rng.randint(0, B, n)


def test_multiscale_roi_align_matches_jax_and_the_masked_form():
    """The single-gather form equals JAX's, and the align-on-every-level
    form, forward and backward (1e-5)."""
    feats, boxes, idx = fpn_inputs()
    want = np.asarray(jroi.multiscale_roi_align(
        [jnp.asarray(f) for f in feats], STRIDES, jnp.asarray(boxes), jnp.asarray(idx)))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tb, ti = torch.from_numpy(boxes), torch.from_numpy(idx)
    got = roi_align.multiscale_roi_align(tf, STRIDES, tb, ti)
    masked = roi_align._multiscale_roi_align_masked(tf, STRIDES, tb, ti)
    assert got.shape == (24, 7, 7, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(masked.detach().numpy(), want, atol=1e-5, rtol=1e-5)
    ga = torch.autograd.grad(got.sum(), tf)
    gb = torch.autograd.grad(masked.sum(), tf)
    jg = jax.grad(lambda fs: jroi.multiscale_roi_align(
        fs, STRIDES, jnp.asarray(boxes), jnp.asarray(idx)).sum())(
        [jnp.asarray(f) for f in feats])
    for a, b, j in zip(ga, gb, jg):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


def test_crop_resize_separable_matches_jax():
    rng = np.random.RandomState(9)
    planes = rng.rand(12, 40, 40).astype(np.float32)
    boxes = roi_boxes(rng, 12, -10, 50, (2, 45))
    got = roi_align.crop_resize_separable(torch.from_numpy(planes),
                                          torch.from_numpy(boxes), 8).numpy()
    want = np.asarray(jroi.crop_resize_separable(jnp.asarray(planes),
                                                 jnp.asarray(boxes), 8))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_paste_masks_matches_jax():
    rng = np.random.RandomState(10)
    probs = rng.rand(2, 6, 28, 28).astype(np.float32)
    xy = rng.uniform(-10, 60, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 60, (2, 6, 2))], -1).astype(np.float32)
    hs, ws = np.array([64, 48], np.int32), np.array([80, 64], np.int32)
    args = (probs, boxes, hs, ws)
    got = masks.paste_masks(*map(torch.from_numpy, args), out_size=56).numpy()
    want = np.asarray(jmasks.paste_masks(*map(jnp.asarray, args), out_size=56))
    assert got.shape == (2, 6, 56, 56)
    # a canvas value within float rounding of the 0.5 threshold may flip
    canvas = np.asarray(jnp.einsum("bkon,bkpn->bkop", jnp.einsum(
        "bkom,bkmn->bkon", jmasks._axis_weights(
            (jnp.arange(56.0) + 0.5)[None, None] * (jnp.asarray(hs, jnp.float32)[:, None, None] / 56),
            jnp.asarray(boxes[..., 1]), jnp.asarray(boxes[..., 3]), 28), jnp.asarray(probs)),
        jmasks._axis_weights(
            (jnp.arange(56.0) + 0.5)[None, None] * (jnp.asarray(ws, jnp.float32)[:, None, None] / 56),
            jnp.asarray(boxes[..., 0]), jnp.asarray(boxes[..., 2]), 28)))
    near = np.abs(canvas - 0.5) < 1e-5
    assert ((got != want) <= near).all()
    assert 0.05 < want.mean() < 0.95


# -- NMS ------------------------------------------------------------------------
def test_class_agnostic_batched_nms_equals_jax():
    """The RPN's call: K = pre_nms_topk candidates, class_aware=False,
    score_threshold 0, thr 0.7; exact on the plain path."""
    rng = np.random.RandomState(11)
    B, K = 3, 300
    xy = rng.uniform(0, 200, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 80, (B, K, 2))], -1).astype(np.float32)
    scores = np.sort(rng.rand(B, K).astype(np.float32), -1)[:, ::-1].copy()
    scores[:, 40:44] = scores[:, 40:41]  # ties
    labels = rng.randint(0, 5, (B, K)).astype(np.int32)
    for class_aware in (False, True):
        kw = dict(max_det=64, iou_threshold=0.7, score_threshold=0.0, max_nms=K,
                  class_aware=class_aware)
        got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                          torch.from_numpy(labels), **kw)
        want = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                               jnp.asarray(labels), use_pallas=False, **kw)
        for key in ("boxes", "scores", "labels", "valid", "num"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)
        assert int(got["num"].min()) > 10
