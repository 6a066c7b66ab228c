"""Weights across from the JAX package (port's copy of ``utils/torch_interop.py``).

The port's modules carry the reference PyTorch state-dict keys, so a JAX
variables tree maps onto them by the same name translation the JAX package
uses to export reference checkpoints, plus layout conversion:

  - conv kernels: flax HWIO -> torch OIHW;
  - BatchNorm: params ``.../bn.scale|bias`` + batch_stats ``.../bn.mean|var``
    -> ``weight``/``bias``/``running_mean``/``running_var``, with
    ``num_batches_tracked`` emitted as 0.

Only the unet_resnet50 name map is here; the other families come with
their models. Pure numpy in, torch tensors out: this module imports no JAX.
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

_MODEL_RULES = {
    "unet_resnet50": _backbone_rules("resnet.") + _UP_CONV_RULES,
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
