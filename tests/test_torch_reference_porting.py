"""The port's copy of the reference (CvPytorch) checkpoint porter against
the JAX package's on the CPU.

For every rule table, a synthetic reference ``state_dict`` holds one
module path made to match each rule (conv weights and biases, or a BN's
four tensors, by what the rule maps to), and the port's
``port_state_dict`` must give JAX's tree bit for bit, transposed
convolutions included.  Then two whole models: a CvPytorch-named
ResNet-18 and YOLOv5-n state dict load straight into port models through
``load_reference_state_dict``, with the weights that JAX's
``port_state_dict`` followed by ``load_jax_variables`` gives, and the
ResNet's logits equal the JAX model's on the JAX tree within 1e-5 of
their largest value.
"""
import re
import re._parser as sre

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpytorch_tpu.models.backbones.resnet import ResNet as JaxResNet
from cvpytorch_tpu.utils import porting as jp
from cvpytorch_tpu_torch.models.backbones.resnet import ResNet
from cvpytorch_tpu_torch.models.yolov5 import YOLOv5
from cvpytorch_tpu_torch.utils import porting as tp
from cvpytorch_tpu_torch.utils.porting import _flatten, load_jax_variables
from tests.test_torch_train_loss import one_torch_thread  # noqa: F401  (autouse)

TABLES = sorted(n for n in dir(jp) if n.endswith("_RULES"))
TRANSPOSED = {"ENET_RULES": jp.ENET_TRANSPOSED, "YOLOV6_RULES": jp.YOLOV6_TRANSPOSED}


def example(pattern: str) -> str:
    """A string the regex ``pattern`` matches in full: the first branch of
    each alternation, '1' for a digit, 'x' for any character, one
    repetition."""
    def walk(tokens):
        out = []
        for op, av in tokens:
            name = str(op)
            if name == "LITERAL":
                out.append(chr(av))
            elif name == "SUBPATTERN":
                out.append(walk(av[-1]))
            elif name in ("MAX_REPEAT", "MIN_REPEAT"):
                out.append(walk(av[2]) * max(av[0], 1))
            elif name == "BRANCH":
                out.append(walk(av[1][0]))
            elif name == "IN":
                kind, val = av[0]
                if str(kind) == "CATEGORY":
                    out.append("1" if "DIGIT" in str(val) else "a")
                else:
                    out.append(chr(val[0] if str(kind) == "RANGE" else val))
            elif name == "ANY":
                out.append("x")
            else:
                raise ValueError(f"no example for {name} in {pattern}")
        return "".join(out)

    return walk(sre.parse(pattern))


def reference_state_dict(rules, seed=0):
    rng = np.random.RandomState(seed)
    sd = {}
    for pattern, repl in rules:
        path = example(pattern)
        if not re.fullmatch(pattern, path):
            continue
        target = next((re.fullmatch(p, path).expand(r) for p, r in rules
                       if re.fullmatch(p, path)), "")
        leaf = target.rsplit("/", 1)[-1]
        if re.search(r"(bn|gn|norm)\w*$", leaf) or leaf in ("bnid", "rbr_identity"):
            for k in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{path}.{k}"] = torch.from_numpy(rng.rand(6).astype(np.float32))
            sd[f"{path}.num_batches_tracked"] = torch.tensor(3)
        else:
            sd[f"{path}.weight"] = torch.from_numpy(rng.randn(6, 4, 3, 3).astype(np.float32))
            sd[f"{path}.bias"] = torch.from_numpy(rng.randn(6).astype(np.float32))
    return sd


@pytest.mark.parametrize("table", TABLES)
def test_rule_table_ports_like_jax(table):
    rules = getattr(tp, table)
    assert rules == getattr(jp, table)
    sd = reference_state_dict(rules)
    assert sd, table
    kw = {"transposed_patterns": TRANSPOSED.get(table, ())}
    want = jp.port_state_dict(sd, getattr(jp, table), **kw)
    got = tp.port_state_dict(sd, rules, **kw)
    want_leaves, got_leaves = dict(_flatten(want)), dict(_flatten(got))
    assert set(got_leaves) == set(want_leaves)
    for k, v in want_leaves.items():
        assert got_leaves[k].dtype == v.dtype
        np.testing.assert_array_equal(got_leaves[k], v, err_msg=str(k))


def test_convert_tensor_equals_jax():
    rng = np.random.RandomState(1)
    for name, shape, transposed in (("a.weight", (6, 4, 3, 3), False),
                                    ("a.weight", (6, 4, 2, 2), True),
                                    ("a.weight", (6, 4, 5), False), ("fc.weight", (5, 7), False),
                                    ("bn.weight", (6,), False), ("bn.running_var", (6,), False),
                                    ("m.bias", (6,), False), ("m.scale_x", (2,), False)):
        t = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        got, want = tp.convert_tensor(name, t, transposed), jp.convert_tensor(name, t, transposed)
        assert got[0] == want[0] and got[2] == want[2]
        np.testing.assert_array_equal(got[1], want[1])


def resnet_reference_names(port_name: str) -> str:
    """The CvPytorch ResNet wrapper's name of a port ResNet tensor."""
    for pat, rep in ((r"stem_conv\.(.*)", r"stem.0.\1"), (r"stem_bn\.(.*)", r"stem.1.\1"),
                     (r"layer(\d)_block(\d+)\.ds_conv\.(.*)", r"layer\1.\2.downsample.0.\3"),
                     (r"layer(\d)_block(\d+)\.ds_bn\.(.*)", r"layer\1.\2.downsample.1.\3"),
                     (r"layer(\d)_block(\d+)\.(.*)", r"layer\1.\2.\3")):
        if re.fullmatch(pat, port_name):
            return re.sub(pat, rep, port_name)
    return port_name


def yolov5_reference_names(port_name: str) -> str:
    """The CvPytorch YOLOv5 modules' name of a port YOLOv5 tensor (the
    inverse of ``YOLOV5_RULES``)."""
    for pat, rep in (
            (r"backbone\.stage(\d)_down\.(.*)", r"backbone.stage\1.0.\2"),
            (r"backbone\.stage(\d)_csp\.m(\d+)\.conv(\d)\.(.*)", r"backbone.stage\1.1.m.\2.conv\3.\4"),
            (r"backbone\.stage(\d)_csp\.conv(\d)\.(.*)", r"backbone.stage\1.1.conv\2.\3"),
            (r"backbone\.sppf\.conv(\d)\.(.*)", r"backbone.stage4.2.conv\1.\2"),
            (r"neck\.up(\d)\.reduce\.(.*)", r"neck.up_\1.conv.\2"),
            (r"neck\.up(\d)\.csp\.m(\d+)\.conv(\d)\.(.*)", r"neck.up_\1.fuse.m.\2.cv\3.\4"),
            (r"neck\.up(\d)\.csp\.conv(\d)\.(.*)", r"neck.up_\1.fuse.cv\2.\3"),
            (r"neck\.down(\d)\.down\.(.*)", r"neck.down_\1.down.\2"),
            (r"neck\.down(\d)\.csp\.m(\d+)\.conv(\d)\.(.*)", r"neck.down_\1.fuse.m.\2.cv\3.\4"),
            (r"neck\.down(\d)\.csp\.conv(\d)\.(.*)", r"neck.down_\1.fuse.cv\2.\3"),
            (r"detect\.m(\d)\.(.*)", r"detect.m.\1.\2")):
        if re.fullmatch(pat, port_name):
            return re.sub(pat, rep, port_name)
    return port_name


def randomised(model, seed):
    rng = np.random.RandomState(seed)
    return {k: (torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1
                                 + (1.0 if k.endswith(("running_var", "bn.weight")) else 0.0))
                if v.is_floating_point() else v)
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("family", ["resnet18", "yolov5_n"])
def test_reference_state_dict_loads_straight_into_a_port_model(family):
    if family == "resnet18":
        make = lambda: ResNet(subtype="resnet18", classifier=True, num_classes=5)  # noqa: E731
        rules, rename = tp.RESNET_WRAPPER_RULES, resnet_reference_names
    else:
        make = lambda: YOLOv5(dictionary=({"a": 1.0}, {"b": 1.0}),  # noqa: E731
                              model_cfg={"TYPE": "yolov5_n"})
        rules, rename = tp.YOLOV5_RULES, yolov5_reference_names
    source = randomised(make(), seed=2)
    reference = {rename(k): v for k, v in source.items()}
    if family == "yolov5_n":
        reference["detect.anchors"] = torch.zeros(3, 3, 2)  # a buffer the rules drop
    got = tp.load_reference_state_dict(make(), reference, rules).state_dict()
    tree = jp.port_state_dict(reference, rules, strict=True)
    want = load_jax_variables(make(), tree).state_dict()
    for k, v in source.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v) and torch.equal(want[k], v), k
    if family == "resnet18":
        x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
        jm = JaxResNet(subtype="resnet18", classifier=True, num_classes=5)
        jout = np.asarray(jm.apply(tree, jnp.asarray(x)))
        model = make()
        model.load_state_dict(got)
        with torch.no_grad():
            tout = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        assert np.abs(tout - jout).max() <= 1e-5 * np.abs(jout).max()
    with pytest.raises(KeyError, match="unmatched"):
        tp.load_reference_state_dict(make(), {**reference, "extra.weight": torch.zeros(2)}, rules)
