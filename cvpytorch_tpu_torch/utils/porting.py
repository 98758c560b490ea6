"""Weights carried from the JAX package into the port.

``load_jax_variables(model, variables)`` copies a Flax ``{'params',
'batch_stats'}`` tree (nested mappings of arrays) into a port module whose
submodules carry the Flax names, so the key map is a join of the path:

  params/…/conv/kernel (HWIO)     → ….conv.weight (OIHW, transpose(3,2,0,1))
  params/…/fc/kernel (in, out)    → ….fc.weight (out, in), transposed
  params/…/linear/kernel (in, out) → ….linear.weight (out, in, 1, 1) where
                                    the port's module is a 1×1 conv
  params/…/conv/kernel (k, I, O)  → ….conv.weight (O, I, k) where the
                                    port's module is an ``nn.Conv1d``
  params/…/deconv/kernel (HWIO)   → ….deconv.weight (in, out, kh, kw),
                                    flipped: K[::-1, ::-1].transpose(2,3,0,1)
  params/…/<layer>/bias           → ….bias
  params/…/bn/scale | bn/bias     → ….bn.weight | ….bn.bias
  batch_stats/…/bn/mean | bn/var  → ….bn.running_mean | ….bn.running_var
  params/…/query|key|value/kernel (C, H, D) → (C, H·D) → ….weight (H·D, C),
      …/bias (H, D) → (H·D,)      where the port's module is a
  params/…/out/kernel (H, D, C) → (H·D, C) → ….weight (C, H·D),
      …/bias (C,) as is            ``MultiHeadDense`` (Flax's attention
                                    ``DenseGeneral``s; its ``split`` says
                                    which, the exact 3-D shape is checked)
  params/…/<name> (any other leaf) → ….<name>, where the port holds an
                                    ``nn.Parameter`` of that name (MSCAN's
                                    layer scales ``ls1``/``ls2``, TAN's
                                    ``pos_embed``, BiFPN's fusion weights
                                    ``p6_w1`` …), as is; a 0-d ``scale``
                                    (GFLv2's ``ScaleLayer``) → the 0-d
                                    ``weight``

The kernel rule follows the type of the port module that owns the tensor
(``MultiHeadDense``, ``nn.Linear``, a 1×1 ``nn.Conv2d`` given a Dense
kernel, ``nn.ConvTranspose2d``, otherwise a convolution), because
they cannot be told apart by shape: a square Dense kernel and a
ConvTranspose kernel with as many inputs as outputs pass the shape check
under the wrong rule.  Flax's ``ConvTranspose`` (``transpose_kernel=False``)
does not flip its kernel; ``nn.ConvTranspose2d`` is the gradient of a
convolution and does, hence the spatial flip.

The JAX YOLOv5 stem is a 3×3 conv over a 2×2 space-to-depth input, kernel
(3, 3, 4C, O); where the port's conv is 6×6 over C channels, that kernel is
mapped back with ``s2d_to_stem6_kernel``.  Strict: any tree key without a
port tensor, any port tensor without a tree key, or any shape mismatch
raises ``KeyError``.

``flax_layout`` reads the same rules backwards: where a port tensor's Flax
leaf keeps its trailing dim, which tensor parallelism shards
(``parallel.mesh``).

CvPytorch's own ``.pth`` state dicts come in through the second half of
this module, a copy of the JAX package's porter: ``port_state_dict`` maps
torch names to the Flax tree by a family's rule table (``RESNET_WRAPPER_RULES``,
``YOLOV5_RULES`` …) and ``load_reference_state_dict`` loads the result into
a port model.
"""
from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from ..models.bricks import MultiHeadDense
from ..parallel.tensor import shards

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def s2d_to_stem6_kernel(k3: np.ndarray) -> np.ndarray:
    """(3, 3, 4C, O) kernel over a space-to-depth input (channel =
    (2·dy + dx)·C + c) → the equivalent (6, 6, C, O) stride-2 kernel:
    k6[2a + dy, 2b + dx, c, o] = k3[a, b, (2dy + dx)·C + c, o]."""
    kh, kw, c4, O = k3.shape
    if (kh, kw) != (3, 3) or c4 % 4:
        raise ValueError(f"not a space-to-depth stem kernel: {k3.shape}")
    C = c4 // 4
    out = np.zeros((6, 6, C, O), k3.dtype)
    for a in range(3):
        for b in range(3):
            for dy in range(2):
                for dx in range(2):
                    out[2 * a + dy, 2 * b + dx] = \
                        k3[a, b, (2 * dy + dx) * C:(2 * dy + dx + 1) * C]
    return out


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(name: str, arr: np.ndarray, target: torch.Tensor,
             owner: nn.Module | None = None) -> np.ndarray:
    """The tree's leaf ``arr`` in the layout of the port tensor ``target``;
    ``owner`` is the port module holding it (None: a convolution or BN)."""
    if isinstance(owner, MultiHeadDense):
        leaf = "kernel" if target.ndim == 2 else "bias"
        if tuple(arr.shape) != owner.flax_shape(leaf):
            raise KeyError(f"shape mismatch at {name}: tree {arr.shape} vs the "
                           f"{owner.split} DenseGeneral {leaf} {owner.flax_shape(leaf)}")
        if leaf == "kernel":
            arr = (arr.reshape(arr.shape[0], -1) if owner.split == "heads"
                   else arr.reshape(-1, arr.shape[-1])).T
        else:
            arr = arr.reshape(-1)
    elif isinstance(owner, nn.Linear) and arr.ndim == 2:  # (in, out) → (out, in)
        arr = arr.T
    elif (isinstance(owner, nn.Conv2d) and owner.kernel_size == (1, 1)
          and owner.groups == 1 and arr.ndim == 2):  # Dense (in, out) → (out, in, 1, 1)
        arr = arr.T[:, :, None, None]
    elif isinstance(owner, nn.Conv1d) and arr.ndim == 3:  # (k, in, out) → (out, in, k)
        arr = arr.transpose(2, 1, 0)
    elif isinstance(owner, nn.ConvTranspose2d) and arr.ndim == 4:
        arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # HWIO → (I, O, kh, kw)
    elif arr.ndim == 4 and name.endswith(".weight"):  # conv kernel HWIO → OIHW
        if tuple(target.shape[2:]) == (6, 6) and arr.shape[:2] == (3, 3):
            arr = s2d_to_stem6_kernel(arr)
        arr = arr.transpose(3, 2, 0, 1)
    if tuple(arr.shape) != tuple(target.shape):
        raise KeyError(f"shape mismatch at {name}: tree {arr.shape} "
                       f"vs port {tuple(target.shape)}")
    return arr


def _flax_shape(name: str, target: torch.Tensor, owner: nn.Module | None) -> tuple:
    """The shape of the Flax leaf that ``_convert`` carries onto ``target``
    (the 6×6 stem as its own HWIO kernel)."""
    shape = tuple(target.shape)
    if isinstance(owner, MultiHeadDense):
        return owner.flax_shape("kernel" if target.ndim == 2 else "bias")
    if isinstance(owner, nn.Linear) and target.ndim == 2:
        return shape[::-1]
    if isinstance(owner, nn.Conv1d) and target.ndim == 3:
        return shape[::-1]
    if isinstance(owner, nn.ConvTranspose2d) and target.ndim == 4:
        return shape[2:] + shape[:2]
    if target.ndim == 4 and name.endswith(".weight"):
        return shape[2:] + (shape[1], shape[0])
    return shape


def flax_layout(name: str, target: torch.Tensor, owner: nn.Module | None = None
                ) -> tuple[tuple, tuple | None]:
    """``(flax_shape, (dim, outer))`` of the port tensor ``target``: the
    shape of its Flax leaf, and where that leaf's trailing dim lies in the
    port layout, as ``_convert`` itself lays it out (an index probe is
    carried across): ``dim`` of ``target`` read as (``outer``, trailing)
    blocks, ``outer`` 1 unless a ``DenseGeneral`` kernel folds the heads
    into that dim.  The second item is None where the trailing dim does
    not land on one port dim so."""
    fshape = _flax_shape(name, target, owner)
    if not fshape:
        return fshape, None
    t = fshape[-1]
    probe = _convert(name, np.broadcast_to(np.arange(t, dtype=np.int32), fshape),
                     target, owner)
    varying = [d for d in range(probe.ndim)
               if probe.shape[d] > 1 and (probe != probe.take([0], axis=d)).any()]
    if t == 1 or len(varying) != 1:
        return fshape, None
    d = varying[0]
    line = np.moveaxis(probe, d, 0).reshape(probe.shape[d], -1)[:, 0]
    outer = len(line) // t
    if not np.array_equal(line, np.tile(np.arange(t), outer)):
        return fshape, None
    return fshape, (d, outer)


def port_name(coll: str, path: tuple, parameters) -> str | None:
    """The port's name of the tree leaf ``coll``/``path``: by the leaf
    tables, else (``params`` only) the path itself where ``parameters``
    (the port's parameter names) holds it; None where neither applies."""
    leaf = (_PARAM_LEAVES if coll == "params" else _STAT_LEAVES).get(path[-1])
    if leaf:
        return ".".join(path[:-1] + (leaf,))
    name = ".".join(path)
    return name if coll == "params" and name in parameters else None


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a Flax ``{'params', 'batch_stats'}`` tree into ``model`` in place;
    into a model laid out for tensor parallelism, each leaf is carried in
    full and this rank's block of it kept."""
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    parameters = dict(model.named_parameters())
    owners = dict(model.named_modules())
    blocks = shards(model)  # laid out for tensor parallelism: each rank's block
    unmatched, seen = [], set()
    for coll in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(coll, {})):
            name = port_name(coll, path, parameters)
            if name not in state:
                unmatched.append("/".join((coll,) + path))
                continue
            target, s = state[name], blocks.get(name)
            full = target if s is None else torch.empty(s.full_shape, device="meta")
            arr = _convert(name, arr, full, owners.get(".".join(path[:-1])))
            # a 0-d leaf (a scalar param) stays 0-d: ascontiguousarray makes it 1-d
            value = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
            with torch.no_grad():
                target.copy_(value if s is None else s.take(value))
            seen.add(name)
    missing = sorted(set(state) - seen)
    if unmatched or missing:
        raise KeyError(f"JAX tree keys without a port tensor: {unmatched[:10]}; "
                       f"port tensors without a tree key: {missing[:10]}")
    return model


# -- reference (CvPytorch) state dicts ---------------------------------------------
# A copy of the JAX package's reference-checkpoint porter and its rule
# tables: a CvPytorch ``state_dict`` becomes the Flax tree the JAX package
# loads, and ``load_reference_state_dict`` carries that tree into a port
# model with ``load_jax_variables``.

def convert_tensor(name: str, t, transposed: bool = False
                   ) -> tuple[str, np.ndarray, str]:
    """Returns (leaf_name, array, collection) for one torch tensor.

    ``transposed`` marks ConvTranspose2d weights, whose torch layout is
    (in, out, kH, kW) — NOT the Conv2d (out, in, kH, kW) — so they need
    (2,3,0,1) to reach flax's HWIO, not the default (2,3,1,0) (which would
    silently swap in/out channels whenever in == out).  They are also
    spatially FLIPPED: torch ConvTranspose2d is the conv gradient
    (kernel scattered as-is), while flax ConvTranspose convolves the
    dilated input with the kernel unflipped — verified numerically in
    tests/test_fidelity_models.py (ENet) against k3/s2/p1/op1.
    """
    a = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    if name.endswith(".running_mean"):
        return "mean", a, "batch_stats"
    if name.endswith(".running_var"):
        return "var", a, "batch_stats"
    if name.endswith(".num_batches_tracked"):
        return "", a, "skip"
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight":
        if a.ndim == 4:  # conv OIHW → HWIO; deconv IOHW → flipped HWIO
            return ("kernel",
                    a.transpose(2, 3, 0, 1)[::-1, ::-1].copy() if transposed
                    else a.transpose(2, 3, 1, 0),
                    "params")
        if a.ndim == 3:  # conv1d (out,in,k) → flax (k,in,out)
            return "kernel", a.transpose(2, 1, 0), "params"
        if a.ndim == 2:  # linear
            return "kernel", a.T, "params"
        return "scale", a, "params"  # norm affine weight
    if leaf == "bias":
        return "bias", a, "params"
    return leaf, a, "params"


def _set_path(tree: dict, path: Sequence[str], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def stem6_to_s2d_kernel(k_hwio: "np.ndarray") -> "np.ndarray":
    """(6, 6, C, O) stride-2 conv kernel → the equivalent (3, 3, 4C, O)
    kernel over a 2×2 space-to-depth input (channel = (2·dy + dx)·C + c):
    y[i,j] = Σ k6[u,v]·x[2i−2+u, 2j−2+v] with u = 2a + dy, v = 2b + dx.
    Exact — see backbones/csp_darknet.py stem."""
    kh, kw, C, O = k_hwio.shape
    assert (kh, kw) == (6, 6), k_hwio.shape
    out = np.zeros((3, 3, 4 * C, O), k_hwio.dtype)
    for a in range(3):
        for b in range(3):
            for dy in range(2):
                for dx in range(2):
                    out[a, b, (2 * dy + dx) * C:(2 * dy + dx + 1) * C] = \
                        k_hwio[2 * a + dy, 2 * b + dx]
    return out


def port_state_dict(
    state_dict: Mapping[str, "np.ndarray"],
    rules: Iterable[tuple[str, str]],
    strict: bool = False,
    transposed_patterns: Iterable[str] = (),
    transforms: Mapping[str, callable] | None = None,
) -> dict:
    """Map torch ``state_dict`` into flax {'params', 'batch_stats'} trees.

    rules: ordered (regex, replacement) applied to each torch key's module
    path (without the trailing .weight/.bias/...); the result is the flax
    path joined by '/'.  A rule mapping to '' drops the entry.
    transposed_patterns: regexes over the module path marking
    ConvTranspose2d modules (IOHW weight layout).
    """
    params: dict = {}
    batch_stats: dict = {}
    unmatched = []
    transposed_patterns = list(transposed_patterns)
    for name, tensor in state_dict.items():
        module_path = name.rsplit(".", 1)[0]
        is_transposed = any(
            re.fullmatch(p, module_path) for p in transposed_patterns)
        leaf, arr, coll = convert_tensor(name, tensor,
                                         transposed=is_transposed)
        if coll == "skip":
            continue
        flax_path = None
        for pattern, repl in rules:
            m = re.fullmatch(pattern, module_path)
            if m:
                flax_path = m.expand(repl)
                break
        if flax_path is None:
            unmatched.append(name)
            continue
        if flax_path == "":
            continue
        parts = flax_path.split("/") + [leaf]
        if transforms:
            full = "/".join(parts)
            for pat, fn in transforms.items():
                if re.fullmatch(pat, full):
                    arr = fn(arr)
                    break
        _set_path(params if coll == "params" else batch_stats, parts, arr)
    if strict and unmatched:
        raise KeyError(f"unmatched torch keys: {unmatched[:10]}"
                       f"{'...' if len(unmatched) > 10 else ''}")
    return {"params": params, "batch_stats": batch_stats}


def load_reference_state_dict(model: nn.Module, state_dict: Mapping, rules,
                              transposed_patterns: Iterable[str] = (),
                              transforms: Mapping[str, callable] | None = None) -> nn.Module:
    """A CvPytorch ``state_dict`` (torch tensors or arrays) into ``model`` in
    place: ``port_state_dict`` by ``rules`` (strict), then
    ``load_jax_variables`` (strict both ways)."""
    tree = port_state_dict(state_dict, rules, strict=True,
                           transposed_patterns=transposed_patterns, transforms=transforms)
    return load_jax_variables(model, tree)


def verify_tree_shapes(ported: dict, target: dict, path=""):
    """Recursively compare a ported tree against a model's init tree;
    returns list of mismatch strings (empty = compatible)."""
    errs = []
    t_keys = set(target)
    p_keys = set(ported)
    for k in sorted(t_keys - p_keys):
        errs.append(f"missing {path}/{k}")
    for k in sorted(p_keys - t_keys):
        errs.append(f"extra {path}/{k}")
    for k in sorted(t_keys & p_keys):
        tv, pv = target[k], ported[k]
        if isinstance(tv, dict):
            errs.extend(verify_tree_shapes(pv, tv, f"{path}/{k}"))
        else:
            if tuple(np.shape(pv)) != tuple(np.shape(tv)):
                errs.append(
                    f"shape {path}/{k}: ported {np.shape(pv)} vs model {np.shape(tv)}")
    return errs


# -- per-family rule tables (extend as checkpoints become available) -------
CONVBNACT_RULES = [
    # torch 'conv' / 'bn' submodules inside a module path map 1:1
    (r"(.*)\.conv", r"\1/conv"),
    (r"(.*)\.bn", r"\1/bn"),
]

# reference src/models/unet.py:91-109 → cvpytorch_tpu/models/unet.py
UNET_RULES = [
    (r".*criterion.*", r""),  # loss-module buffers (class weights) — drop
    (r"conv\.double_conv\.(\d)\.0", r"conv/conv\1"),
    (r"conv\.double_conv\.(\d)\.1", r"conv/bn\1"),
    (r"(down\d)\.double_conv\.double_conv\.(\d)\.0", r"\1/conv\2"),
    (r"(down\d)\.double_conv\.double_conv\.(\d)\.1", r"\1/bn\2"),
    (r"(up\d)\.conv\.double_conv\.(\d)\.0", r"\1/conv\2"),
    (r"(up\d)\.conv\.double_conv\.(\d)\.1", r"\1/bn\2"),
    (r"outconv", r"outconv"),
]

# reference src/models/backbones/resnet.py:46-110 wrapper (stem = Sequential
# (conv1, bn1, relu); layer1..4 from torchvision) → backbones/resnet.py
RESNET_WRAPPER_RULES = [
    (r"stem\.0", r"stem_conv"),
    (r"stem\.1", r"stem_bn"),
    (r"layer(\d)\.(\d+)\.conv(\d)", r"layer\1_block\2/conv\3"),
    (r"layer(\d)\.(\d+)\.bn(\d)", r"layer\1_block\2/bn\3"),
    (r"layer(\d)\.(\d+)\.downsample\.0", r"layer\1_block\2/ds_conv"),
    (r"layer(\d)\.(\d+)\.downsample\.1", r"layer\1_block\2/ds_bn"),
    (r"fc", r"fc"),
]

# reference src/models/backbones/mobilenet_v2.py:41-52 wrapper (stages slice
# torchvision features) → backbones/mobilenetv2.py
MBV2_WRAPPER_RULES = [
    (r"stem\.0\.0", r"stem/conv"),
    (r"stem\.0\.1", r"stem/bn"),
    # group 1 has expand_ratio 1 → conv = [dw-ConvBNReLU, pw, bn]
    (r"stage1\.0\.conv\.0\.0", r"stage1_block0/dw/conv"),
    (r"stage1\.0\.conv\.0\.1", r"stage1_block0/dw/bn"),
    (r"stage1\.0\.conv\.1", r"stage1_block0/project/conv"),
    (r"stage1\.0\.conv\.2", r"stage1_block0/project/bn"),
    # groups 2-7: conv = [expand, dw, pw, bn]
    (r"stage(\d)\.(\d+)\.conv\.0\.0", r"stage\1_block\2/expand/conv"),
    (r"stage(\d)\.(\d+)\.conv\.0\.1", r"stage\1_block\2/expand/bn"),
    (r"stage(\d)\.(\d+)\.conv\.1\.0", r"stage\1_block\2/dw/conv"),
    (r"stage(\d)\.(\d+)\.conv\.1\.1", r"stage\1_block\2/dw/bn"),
    (r"stage(\d)\.(\d+)\.conv\.2", r"stage\1_block\2/project/conv"),
    (r"stage(\d)\.(\d+)\.conv\.3", r"stage\1_block\2/project/bn"),
    (r"last_conv\.0\.0", r"head_conv/conv"),
    (r"last_conv\.0\.1", r"head_conv/bn"),
    (r"fc\.1", r"fc"),
    (r"fc\.0", r""),  # dropout has no params; defensive
]


# reference src/models/backbones/det/yolov5_csp_darknet.py +
# src/models/necks/yolov5_neck.py + src/models/detects/yolov5_detect.py
# (the reference's top-level YOLOv5 wrapper is unbuildable upstream — it
# injects depth_mul/width_mul kwargs no registered backbone accepts — so
# porting targets the three chained modules) → models/yolov5.py
YOLOV5_RULES = [
    (r"backbone\.stem\.(conv|bn)", r"backbone/stem/\1"),
    (r"backbone\.stage(\d)\.0\.(conv|bn)", r"backbone/stage\1_down/\2"),
    (r"backbone\.stage(\d)\.1\.conv(\d)\.(conv|bn)",
     r"backbone/stage\1_csp/conv\2/\3"),
    (r"backbone\.stage(\d)\.1\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"backbone/stage\1_csp/m\2/conv\3/\4"),
    (r"backbone\.stage4\.2\.conv(\d)\.(conv|bn)", r"backbone/sppf/conv\1/\2"),
    (r"neck\.up_(\d)\.conv\.(conv|bn)", r"neck/up\1/reduce/\2"),
    (r"neck\.up_(\d)\.fuse\.cv(\d)\.(conv|bn)", r"neck/up\1/csp/conv\2/\3"),
    (r"neck\.up_(\d)\.fuse\.m\.(\d+)\.cv(\d)\.(conv|bn)",
     r"neck/up\1/csp/m\2/conv\3/\4"),
    (r"neck\.down_(\d)\.down\.(conv|bn)", r"neck/down\1/down/\2"),
    (r"neck\.down_(\d)\.fuse\.cv(\d)\.(conv|bn)",
     r"neck/down\1/csp/conv\2/\3"),
    (r"neck\.down_(\d)\.fuse\.m\.(\d+)\.cv(\d)\.(conv|bn)",
     r"neck/down\1/csp/m\2/conv\3/\4"),
    (r"detect\.m\.(\d)", r"detect/m\1"),
    (r"detect", r""),  # anchors buffer — constants in our decode
]


# reference src/models/heads/seg/deeplabv3plus_head.py:33 (+ parent
# deeplabv3_head.py:50) → models/heads/seg_heads.py Deeplabv3(Plus)Head
DEEPLABV3PLUS_RULES = [
    (r"proj\.1\.(conv|bn)", r"proj/\1"),
    (r"aspp\.(\d)\.depthwise_conv\.(conv|bn)", r"aspp\1/dw/\2"),
    (r"aspp\.(\d)\.pointwise_conv\.(conv|bn)", r"aspp\1/pw/\2"),
    (r"aspp\.(\d)\.(conv|bn)", r"aspp\1/\2"),
    (r"reduce\.(conv|bn)", r"reduce/\1"),
    (r"low_proj\.(conv|bn)", r"low_proj/\1"),
    (r"fuse\.(\d)\.depthwise_conv\.(conv|bn)", r"fuse\1/dw/\2"),
    (r"fuse\.(\d)\.pointwise_conv\.(conv|bn)", r"fuse\1/pw/\2"),
    (r"cls_seg", r"cls"),
]


# reference src/models/heads/nanodetplus_head.py:54-183 (DepthwiseConvModule
# stacks + per-level gfl_cls 1×1) → models/heads/nanodet_head.py
NANODETPLUS_HEAD_RULES = [
    (r"cls_convs\.(\d)\.(\d)\.depthwise", r"convs\1_\2_dw/conv"),
    (r"cls_convs\.(\d)\.(\d)\.dwnorm", r"convs\1_\2_dw/bn"),
    (r"cls_convs\.(\d)\.(\d)\.pointwise", r"convs\1_\2_pw/conv"),
    (r"cls_convs\.(\d)\.(\d)\.pwnorm", r"convs\1_\2_pw/bn"),
    (r"gfl_cls\.(\d)", r"gfl_cls\1"),
    (r"distribution_project", r""),  # Integral buffer — ours is a constant
]


# reference src/models/segnet.py:71-160 → models/segnet_enet.py SegNet
SEGNET_RULES = [
    (r"(encoder\d)\.(?:double|triple)_conv\.(\d)\.0", r"\1_\2/conv"),
    (r"(encoder\d)\.(?:double|triple)_conv\.(\d)\.1", r"\1_\2/bn"),
    (r"(decoder[2-5])\.(?:double|triple)_conv\.(\d)\.0", r"\1_\2/conv"),
    (r"(decoder[2-5])\.(?:double|triple)_conv\.(\d)\.1", r"\1_\2/bn"),
    (r"decoder1\.0", r"decoder1_0/conv"),
    (r"decoder1\.1", r"decoder1_0/bn"),
    (r"outconv", r"outconv"),
]


def _enet_rules():
    """reference src/models/enet.py:152-254 → models/segnet_enet.py ENet.
    Bottlenecks live unwrapped (stage1_1), in Sequentials (stage1_2.0) or
    under stage3.i; each prefix form gets the same inner mapping."""
    inner = [
        (r"bottleneck\.0\.0", "c0/conv"), (r"bottleneck\.0\.1", "c0/bn"),
        (r"bottleneck\.0\.2", "c0/act"),
        (r"bottleneck\.1\.0", "c1a/conv"), (r"bottleneck\.1\.1", "c1a/bn"),
        (r"bottleneck\.1\.2", "c1a/act"),
        (r"bottleneck\.1\.3", "c1b/conv"), (r"bottleneck\.1\.4", "c1b/bn"),
        (r"bottleneck\.1\.5", "c1b/act"),
        (r"bottleneck\.2\.0", "c2/conv"), (r"bottleneck\.2\.1", "c2/bn"),
        (r"bottleneck\.2\.2", "c2/act"),
        (r"upsample_conv\.0", "up_conv/conv"),
        (r"upsample_conv\.1", "up_conv/bn"),
        (r"relu", "act"),
    ]
    rules = [
        (r"initialBlock\.conv", r"init_conv"),
        (r"initialBlock\.bn", r"init_bn"),
        (r"initialBlock\.relu", r"init_act"),
        (r"final_conv", r"final_conv"),
        (r".*criterion.*", r""),           # loss-module weight buffers
    ]
    for pat, rep in inner:
        rules.append((rf"stage(\d)_(\d)\.(\d)\.{pat}",
                      rf"stage\1_\2_\3/{rep}"))
        rules.append((rf"stage3\.(\d)\.{pat}", rf"stage3_\1/{rep}"))
        rules.append((rf"stage(\d)_(\d)\.{pat}", rf"stage\1_\2/{rep}"))
    return rules


ENET_RULES = _enet_rules()
# torch ConvTranspose2d weights are IOHW, not OIHW (enet.py:50,202)
ENET_TRANSPOSED = (r"stage[45]_1\.bottleneck\.1\.0", r"final_conv")


# reference src/models/backbones/det/yolox_csp_darknet.py +
# necks/yolox_neck.py + heads/yolox_head.py → models/yolox.py
# (the reference's YOLOX wrapper has the same unbuildable depth_mul
# injection as YOLOv5's, so the three modules are chained directly)
YOLOX_RULES = [
    (r"backbone\.stem\.conv\.(conv|bn)", r"backbone/stem/conv/\1"),
    (r"backbone\.stage(\d)\.0\.(conv|bn)", r"backbone/stage\1_down/\2"),
    (r"backbone\.stage4\.1\.conv(\d)\.(conv|bn)", r"backbone/sppf/conv\1/\2"),
    (r"backbone\.stage4\.2\.conv(\d)\.(conv|bn)",
     r"backbone/stage4_csp/conv\1/\2"),
    (r"backbone\.stage4\.2\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"backbone/stage4_csp/m\1/conv\2/\3"),
    (r"backbone\.stage(\d)\.1\.conv(\d)\.(conv|bn)",
     r"backbone/stage\1_csp/conv\2/\3"),
    (r"backbone\.stage(\d)\.1\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"backbone/stage\1_csp/m\2/conv\3/\4"),
    (r"neck\.lateral_conv0\.(conv|bn)", r"neck_up1/reduce/\1"),
    (r"neck\.C3_p4\.conv(\d)\.(conv|bn)", r"neck_up1/csp/conv\1/\2"),
    (r"neck\.C3_p4\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"neck_up1/csp/m\1/conv\2/\3"),
    (r"neck\.reduce_conv1\.(conv|bn)", r"neck_up2/reduce/\1"),
    (r"neck\.C3_p3\.conv(\d)\.(conv|bn)", r"neck_up2/csp/conv\1/\2"),
    (r"neck\.C3_p3\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"neck_up2/csp/m\1/conv\2/\3"),
    (r"neck\.bu_conv2\.(conv|bn)", r"neck_down1/down/\1"),
    (r"neck\.C3_n3\.conv(\d)\.(conv|bn)", r"neck_down1/csp/conv\1/\2"),
    (r"neck\.C3_n3\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"neck_down1/csp/m\1/conv\2/\3"),
    (r"neck\.bu_conv1\.(conv|bn)", r"neck_down2/down/\1"),
    (r"neck\.C3_n4\.conv(\d)\.(conv|bn)", r"neck_down2/csp/conv\1/\2"),
    (r"neck\.C3_n4\.m\.(\d+)\.conv(\d)\.(conv|bn)",
     r"neck_down2/csp/m\1/conv\2/\3"),
    (r"head\.stems\.(\d)\.(conv|bn)", r"head/stem\1/\2"),
    (r"head\.cls_convs\.(\d)\.(\d)\.(conv|bn)", r"head/cls\1_\2/\3"),
    (r"head\.reg_convs\.(\d)\.(\d)\.(conv|bn)", r"head/reg\1_\2/\3"),
    (r"head\.cls_preds\.(\d)", r"head/cls_out\1"),
    (r"head\.reg_preds\.(\d)", r"head/reg_out\1"),
    (r"head\.obj_preds\.(\d)", r"head/obj_out\1"),
]


def _repvgg_rules(pat: str, rep: str):
    """Torch RepVGGBlock children (yolo_modules.py:268: rbr_dense /
    rbr_1x1 / rbr_identity) → our conv3/bn3, conv1/bn1, bnid."""
    return [
        (pat + r"\.rbr_dense\.conv", rep + r"/conv3"),
        (pat + r"\.rbr_dense\.bn", rep + r"/bn3"),
        (pat + r"\.rbr_1x1\.conv", rep + r"/conv1"),
        (pat + r"\.rbr_1x1\.bn", rep + r"/bn1"),
        (pat + r"\.rbr_identity", rep + r"/bnid"),
    ]


# reference src/models/backbones/det/yolov6_efficient_rep.py (v6-3.0:
# RepVGG stages + SimCSPSPPF) + necks/det/yolov6_repbipan.py (BiC fusion)
# → models/yolov6.py EfficientRep + RepBiPAN
YOLOV6_RULES = (
    _repvgg_rules(r"backbone\.stem", r"backbone/stem")
    + _repvgg_rules(r"backbone\.stage(\d)\.0", r"backbone/stage\1_down")
    + _repvgg_rules(r"backbone\.stage(\d)\.1\.conv1",
                    r"backbone/stage\1_conv1")
    + _repvgg_rules(r"backbone\.stage(\d)\.1\.block\.(\d+)",
                    r"backbone/stage\1_block\2")
    + [(r"backbone\.stage4\.2\.cv(\d)\.(conv|bn)",
        r"backbone/sppf/cv\1/\2"),
       (r"neck\.reduce_layer(\d)\.(conv|bn)", r"neck/reduce_layer\1/\2"),
       (r"neck\.bifusion(\d)\.upsample", r"neck/bifusion\1/upsample"),
       (r"neck\.bifusion(\d)\.cv(\d)\.(conv|bn)", r"neck/bifusion\1/cv\2/\3"),
       (r"neck\.bifusion(\d)\.downsample\.(conv|bn)",
        r"neck/bifusion\1/downsample/\2"),
       (r"neck\.downsample(\d)\.(conv|bn)", r"neck/downsample\1/\2")]
    + _repvgg_rules(r"neck\.(Rep_[pn]\d)\.conv1", r"neck/\1_conv1")
    + _repvgg_rules(r"neck\.(Rep_[pn]\d)\.block\.(\d+)", r"neck/\1_block\2")
)
# BiFusion upsamplers are raw ConvTranspose2d (yolo_modules.py:255)
YOLOV6_TRANSPOSED = (r"neck\.bifusion\d\.upsample",)


def _ghost_bottleneck_rules(pat: str, rep: str):
    """Torch GhostBottleneck children (ghostnet.py:109-147)."""
    return [
        (pat + r"\.ghost1\.primary_conv\.0", rep + r"/ghost1/primary/conv"),
        (pat + r"\.ghost1\.primary_conv\.1", rep + r"/ghost1/primary/bn"),
        (pat + r"\.ghost1\.cheap_operation\.0", rep + r"/ghost1/cheap/conv"),
        (pat + r"\.ghost1\.cheap_operation\.1", rep + r"/ghost1/cheap/bn"),
        (pat + r"\.conv_dw", rep + r"/dw/conv"),
        (pat + r"\.bn_dw", rep + r"/dw/bn"),
        (pat + r"\.ghost2\.primary_conv\.0", rep + r"/ghost2/primary/conv"),
        (pat + r"\.ghost2\.primary_conv\.1", rep + r"/ghost2/primary/bn"),
        (pat + r"\.ghost2\.cheap_operation\.0", rep + r"/ghost2/cheap/conv"),
        (pat + r"\.ghost2\.cheap_operation\.1", rep + r"/ghost2/cheap/bn"),
        (pat + r"\.shortcut\.0", rep + r"/sc_dw/conv"),
        (pat + r"\.shortcut\.1", rep + r"/sc_dw/bn"),
        (pat + r"\.shortcut\.2", rep + r"/sc_pw/conv"),
        (pat + r"\.shortcut\.3", rep + r"/sc_pw/bn"),
    ]


def _dw_module_rules(pat: str, rep: str):
    """Torch DepthwiseConvModule children (nanodet modules/convs.py:136)."""
    return [
        (pat + r"\.depthwise", rep + r"/dw/conv"),
        (pat + r"\.dwnorm", rep + r"/dw/bn"),
        (pat + r"\.pointwise", rep + r"/pw/conv"),
        (pat + r"\.pwnorm", rep + r"/pw/bn"),
    ]


# reference src/models/necks/ghost_pan.py:14-222 → models/necks/ghost_pan.py
# (3 pyramid levels: top_down_blocks.k fuses level n-1-k, hence td2/td1)
GHOSTPAN_RULES = (
    [(r"reduce_layers\.(\d)\.(conv|bn)", r"reduce\1/\2")]
    + _ghost_bottleneck_rules(r"top_down_blocks\.0\.blocks\.(\d)",
                              r"td2_b\1")
    + _ghost_bottleneck_rules(r"top_down_blocks\.1\.blocks\.(\d)",
                              r"td1_b\1")
    + _ghost_bottleneck_rules(r"bottom_up_blocks\.(\d)\.blocks\.(\d)",
                              r"bu\1_b\2")
    + _dw_module_rules(r"downsamples\.(\d)", r"down\1")
    + _dw_module_rules(r"extra_lvl_in_conv\.(\d)", r"extra_in\1")
    + _dw_module_rules(r"extra_lvl_out_conv\.(\d)", r"extra_out\1")
)


# reference src/models/heads/det/yolov6_effidehead.py:17-147
# → models/yolov6.py Effidehead
YOLOV6_HEAD_RULES = [
    (r"stems\.(\d)\.(conv|bn)", r"stem\1/\2"),
    (r"cls_convs\.(\d)\.(conv|bn)", r"cls_conv\1/\2"),
    (r"reg_convs\.(\d)\.(conv|bn)", r"reg_conv\1/\2"),
    (r"cls_preds\.(\d)", r"cls_out\1"),
    (r"reg_preds\.(\d)", r"reg_out\1"),
    (r"proj_conv", r""),   # DFL projection — constant in our decode
    (r"proj", r""),        # registered DFL buffer (effidehead.py:93)
]


# reference src/models/backbones/shufflenet_v2.py:20-78 (slices torchvision
# shufflenet_v2_* children) → backbones/shufflenetv2.py
SHUFFLENETV2_RULES = [
    (r"stem\.0", r"stem/conv"),
    (r"stem\.1", r"stem/bn"),
    (r"layer(\d)\.(\d+)\.branch1\.0", r"stage\1_unit\2/b1_dw/conv"),
    (r"layer(\d)\.(\d+)\.branch1\.1", r"stage\1_unit\2/b1_dw/bn"),
    (r"layer(\d)\.(\d+)\.branch1\.2", r"stage\1_unit\2/b1_pw/conv"),
    (r"layer(\d)\.(\d+)\.branch1\.3", r"stage\1_unit\2/b1_pw/bn"),
    (r"layer(\d)\.(\d+)\.branch2\.0", r"stage\1_unit\2/b2_pw1/conv"),
    (r"layer(\d)\.(\d+)\.branch2\.1", r"stage\1_unit\2/b2_pw1/bn"),
    (r"layer(\d)\.(\d+)\.branch2\.3", r"stage\1_unit\2/b2_dw/conv"),
    (r"layer(\d)\.(\d+)\.branch2\.4", r"stage\1_unit\2/b2_dw/bn"),
    (r"layer(\d)\.(\d+)\.branch2\.5", r"stage\1_unit\2/b2_pw2/conv"),
    (r"layer(\d)\.(\d+)\.branch2\.6", r"stage\1_unit\2/b2_pw2/bn"),
    (r"conv5\.0", r"last_conv/conv"),
    (r"conv5\.1", r"last_conv/bn"),
    (r"fc", r"fc"),
]


# reference src/models/heads/fcos_head.py:22-90 → models/heads/fcos_head.py
FCOS_HEAD_RULES = (
    [(rf"cls_conv\.{i * 3}", rf"cls_conv{i}") for i in range(4)]
    + [(rf"cls_conv\.{i * 3 + 1}", rf"cls_gn{i}") for i in range(4)]
    + [(rf"reg_conv\.{i * 3}", rf"reg_conv{i}") for i in range(4)]
    + [(rf"reg_conv\.{i * 3 + 1}", rf"reg_gn{i}") for i in range(4)]
    + [(r"cls_logits", r"cls_out"), (r"cnt_logits", r"cnt_out"),
       (r"reg_pred", r"reg_out"),
       (r"scale_exp\.(\d)", r"scale\1")]
)


YOLOV7_NECK_RULES = [
    # reference necks/yolov7_neck.py → models/yolov7.py::YOLOv7Neck
    (r"spp\.cv(\d)\.(conv|bn)", r"spp/cv\1/\2"),
    (r"up1_(\d)\.conv(\d)\.(conv|bn)", r"up1_\1/conv\2/\3"),
    # FeatureFusion: the reference forward reuses conv4 three times —
    # conv5/conv6 are dead parameters (yolov7_modules.py:111-119): drop.
    (r"featurefusion(\d_\d)\.conv[56]\.(conv|bn)", r""),
    (r"featurefusion(\d_\d)\.conv(\d)\.(conv|bn)",
     r"featurefusion\1/conv\2/\3"),
    (r"down2_(\d)\.branch1\.1\.(conv|bn)", r"down2_\1/b1/\2"),
    (r"down2_(\d)\.branch2\.0\.(conv|bn)", r"down2_\1/b2a/\2"),
    (r"down2_(\d)\.branch2\.1\.(conv|bn)", r"down2_\1/b2b/\2"),
]

YOLOV7_HEAD_RULES = [
    # reference heads/yolov7_head.py (RepConv ×3) → YOLOv7Head
    (r"conv(\d)\.rbr_dense\.0", r"conv\1/rbr_dense_conv"),
    (r"conv(\d)\.rbr_dense\.1", r"conv\1/rbr_dense_bn"),
    (r"conv(\d)\.rbr_1x1\.0", r"conv\1/rbr_1x1_conv"),
    (r"conv(\d)\.rbr_1x1\.1", r"conv\1/rbr_1x1_bn"),
    (r"conv(\d)\.rbr_identity", r"conv\1/rbr_identity"),
]
