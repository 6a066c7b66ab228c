"""Weights across from the JAX package (port's copy of ``utils/torch_interop.py``).

The port's modules carry the reference PyTorch state-dict keys, so a JAX
variables tree maps onto them by the same name translation the JAX package
uses to export reference checkpoints, plus layout conversion:

  - conv kernels: flax HWIO -> torch OIHW;
  - ``Dense`` kernels (multitask_unet's class head): flax (in, out) -> torch
    (out, in);
  - BatchNorm: params ``.../bn.scale|bias`` + batch_stats ``.../bn.mean|var``
    -> ``weight``/``bias``/``running_mean``/``running_var``, with
    ``num_batches_tracked`` emitted as 0.

The name maps of all five models are here. Pure numpy in, torch tensors
out: this module imports no JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _backbone_rules(prefix: str) -> list[tuple[str, str]]:
    """``layer{L}_block{B}`` -> ``layer{L}.{B}``; the projection shortcut is Sequential[conv, bn]."""
    p = re.escape(prefix)
    return [
        (rf"^({p})layer(\d)_block(\d+)\.", r"\1layer\2.\3."),
        (rf"^({p}layer\d\.\d+)\.downsample_conv$", r"\1.downsample.0"),
        (rf"^({p}layer\d\.\d+)\.downsample_bn$", r"\1.downsample.1"),
    ]


# Full-resolution head: Sequential[up, conv, relu, conv, relu] -> indices 1/3.
_UP_CONV_RULES = [
    (r"^up_conv\.conv1$", "up_conv.1"),
    (r"^up_conv\.conv2$", "up_conv.3"),
]

# DoubleConv: Sequential[conv, bn, relu, conv, bn, relu] -> indices 0/1/3/4.
_DC = {"conv1": "net.0", "norm1": "net.1", "conv2": "net.3", "norm2": "net.4"}
_DC_GROUP = "(conv1|norm1|conv2|norm2)"


def _double_conv_rules(down_slot: str) -> list:
    """``inc``, ``down{i}`` (its DoubleConv at ``down{i}.<down_slot>``) and ``up{i}.conv``."""
    return [
        (rf"^inc\.{_DC_GROUP}$", lambda m: f"inc.{_DC[m.group(1)]}"),
        (rf"^down(\d)\.conv\.{_DC_GROUP}$",
         lambda m: f"down{m.group(1)}.{down_slot}.{_DC[m.group(2)]}"),
        (rf"^up(\d)\.conv\.{_DC_GROUP}$", lambda m: f"up{m.group(1)}.conv.{_DC[m.group(2)]}"),
    ]


# A dense layer is Sequential[bn, relu, conv] -> 0/2; the 1x1 transition
# Sequential[conv, bn] -> 0/1.
_DENSE_RULES = [
    (r"dense\.norm(\d+)$", r"dense.layers.\1.net.0"),
    (r"dense\.conv(\d+)$", r"dense.layers.\1.net.2"),
    (r"trans_conv$", "trans.0"),
    (r"trans_bn$", "trans.1"),
]

_MODEL_RULES = {
    "unet_resnet50": _backbone_rules("resnet.") + _UP_CONV_RULES,
    # Down: a module whose ``net`` is Sequential[maxpool, DoubleConv].
    "unet_plain": _double_conv_rules("net.1"),
    # Down: Sequential[maxpool, DoubleConv]; gate branches Sequential[conv, bn].
    "attention_unet": _double_conv_rules("1") + [
        (r"^(up\d\.attn\.(?:theta|phi|psi))_bn$", r"\1.1"),
        (r"^(up\d\.attn\.(?:theta|phi|psi))$", r"\1.0"),
    ],
    # Down: Sequential[maxpool, DenseConvBlock].
    "dualdense_unet": [(r"^down(\d)\.", r"down\1.1.")] + _DENSE_RULES,
    # cls head: Sequential[gap, flatten, linear, relu, dropout, linear] -> 2/5.
    "multitask_unet": _backbone_rules("encoder.") + _UP_CONV_RULES + [
        (r"^cls_fc1$", "cls_head.2"),
        (r"^cls_fc2$", "cls_head.5"),
    ],
}

# (collection, JAX path suffix, torch suffix)
_LEAVES = [
    ("params", ".bn.scale", ".weight"),
    ("params", ".bn.bias", ".bias"),
    ("params", ".kernel", ".weight"),
    ("params", ".bias", ".bias"),
    ("batch_stats", ".bn.mean", ".running_mean"),
    ("batch_stats", ".bn.var", ".running_var"),
]


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def torch_key(model_name: str, collection: str, path: str) -> str:
    """Reference state-dict key of one JAX (collection, dotted path) leaf."""
    if model_name not in _MODEL_RULES:
        raise ValueError(f"no name map for model {model_name!r} in the port yet")
    for col, suffix, torch_suffix in _LEAVES:
        if col == collection and path.endswith(suffix):
            module = path[: -len(suffix)]
            for pattern, repl in _MODEL_RULES[model_name]:
                module = re.sub(pattern, repl, module)
            return module + torch_suffix
    raise ValueError(f"unmappable leaf {collection}:{path}")


def _to_torch_layout(v: np.ndarray) -> np.ndarray:
    if v.ndim == 4:  # HWIO -> OIHW
        return np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
    if v.ndim == 2:  # (in, out) -> (out, in)
        return np.ascontiguousarray(v.T)
    return v


def state_dict_from_jax(model_name: str, variables: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a JAX ``{'params', 'batch_stats'}`` tree of numpy arrays.

    Loads into the port's model with ``strict=True``.
    """
    out: dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(col, {})).items():
            key = torch_key(model_name, col, path)
            out[key] = torch.tensor(_to_torch_layout(np.asarray(v, dtype=np.float32)))
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
