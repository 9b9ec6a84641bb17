"""The JAX package's parameters as the port's ``state_dict``.

:func:`from_jax_params` maps the flax ``params`` and ``batch_stats`` trees
(nested dicts of arrays) of the JAX ``InterNet``, or of one of its
submodules wrapped under its top-level name, onto the port's module names.
Those are the reference checkpoints' names, so the JAX package's own
``convert_reference_state_dict(sd, strict=True)`` turns a port
``state_dict`` back into the same trees.

Layouts: flax conv ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``; flax
``ConvTranspose`` ``[kh, kw, I, O]`` (which does not flip its kernel) ->
torch ``ConvTranspose2d`` ``[I, O, kh, kw]`` spatially flipped; flax Dense
``[I, O]`` -> torch ``[O, I]``; BN ``scale/bias`` + ``mean/var`` ->
``weight/bias`` + ``running_mean/running_var``.

It is strict: a flax leaf that maps to no port name raises. Loading the
result with ``load_state_dict(strict=True)`` checks the other direction,
that every port parameter and buffer was filled.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# flax module path -> port module name (regular expressions, full match)
_MODULES = (
    (r"backbone/c1_conv", r"fpn.C1.0"),
    (r"backbone/c1_bn", r"fpn.C1.1"),
    (r"backbone/c(\d)/block(\d+)/proj_conv", r"fpn.C\1.\2.downsample.0"),
    (r"backbone/c(\d)/block(\d+)/proj_bn", r"fpn.C\1.\2.downsample.1"),
    (r"backbone/c(\d)/block(\d+)/((?:conv|bn)\d)", r"fpn.C\1.\2.\3"),
    (r"fpn/p(\d)_lateral", r"fpn.P\1_conv1"),
    (r"fpn/p(\d)_out", r"fpn.P\1_conv2.1"),
    (r"rpn/shared", r"rpn.conv_shared"),
    (r"rpn/cls", r"rpn.conv_class"),
    (r"rpn/bbox", r"rpn.conv_bbox"),
    (r"classifier/fc(\d)", r"classifier.conv\1"),
    (r"classifier/(bn\d|linear_class|linear_bbox)", r"classifier.\1"),
    (r"mask/upsample", r"mask.deconv"),
    (r"mask/logits", r"mask.conv5"),
    (r"mask/((?:conv|bn)\d)", r"mask.\1"),
    (r"dev/upsample(\d)/conv", r"dev_roi.upsample.\1.0"),
    (r"dev/upsample(\d)/bn", r"dev_roi.upsample.\1.1"),
    (r"dev/critic/conv1", r"dev_roi.feat_extract.0"),
    (r"dev/critic/bn1", r"dev_roi.feat_extract.1"),
    (r"dev/critic/conv2", r"dev_roi.feat_extract.3"),
    (r"dev/critic/bn2", r"dev_roi.feat_extract.4"),
    (r"dev/critic/conv3", r"dev_roi.feat_extract.6"),
    (r"dev/critic/bn3", r"dev_roi.feat_extract.7"),
)
_TRANSPOSED = {"mask.deconv"}   # flax ConvTranspose layers
_BN_LEAVES = {"scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flatten(value, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = np.asarray(value)
    return out


def _port_module(path: str) -> str:
    for pattern, template in _MODULES:
        m = re.fullmatch(pattern, path)
        if m:
            return m.expand(template)
    raise ValueError(f"from_jax_params: no port module for flax {path!r}")


def _port_tensor(module: str, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if value.ndim == 2:                            # Dense [I, O]
        return value.T
    if module in _TRANSPOSED:                      # ConvTranspose
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(value, (3, 2, 0, 1))       # Conv


def from_jax_params(params, batch_stats) -> Dict[str, torch.Tensor]:
    """flax (params, batch_stats) trees -> the port's state_dict (float32)."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, value in _flatten(tree).items():
            *mod, leaf = path
            is_bn = bool(mod) and mod[-1] == "BatchNorm_0"
            if is_bn:
                mod = mod[:-1]
            module = _port_module("/".join(mod))
            if is_bn:
                name = _BN_LEAVES[leaf]
                sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
            elif leaf in ("kernel", "bias"):
                name = "weight" if leaf == "kernel" else "bias"
            else:
                raise ValueError(f"from_jax_params: unknown leaf {'/'.join(path)!r}")
            arr = np.ascontiguousarray(_port_tensor(module, leaf, value), dtype=np.float32)
            sd[f"{module}.{name}"] = torch.from_numpy(arr)
    return sd
