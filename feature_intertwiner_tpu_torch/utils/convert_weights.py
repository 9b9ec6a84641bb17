"""The JAX package's parameters as the port's ``state_dict``.

:func:`from_jax_params` maps the flax ``params`` and ``batch_stats`` trees
(nested dicts of arrays) of the JAX ``InterNet``, or of one of its
submodules wrapped under its top-level name, onto the port's module names.
Those are the reference checkpoints' names, so the JAX package's own
``convert_reference_state_dict(sd, strict=True)`` turns a port
``state_dict`` back into the same trees.

Layouts: flax conv ``[kh, kw, I, O]`` -> torch ``[O, I, kh, kw]``; flax
1-D conv ``[k, I, O]`` -> torch ``Conv1d`` ``[O, I, k]``; flax
``ConvTranspose`` ``[kh, kw, I, O]`` (which does not flip its kernel) ->
torch ``ConvTranspose2d`` ``[I, O, kh, kw]`` spatially flipped; flax Dense
``[I, O]`` -> torch ``[O, I]``; BN ``scale/bias`` + ``mean/var`` ->
``weight/bias`` + ``running_mean/running_var``; the make-up layer's
``gate`` as it is. The layout follows the flax path: the port name
``dev_roi.upsample.{m}.0`` holds a conv at ``UPSAMPLE_FAC`` 1 (flax
``dev/upsample{m}/conv``) and a transposed conv at 2 (``.../deconv``), as
the reference checkpoints name both.

It is strict: a flax leaf that maps to no port name raises. Loading the
result with ``load_state_dict(strict=True)`` checks the other direction,
that every port parameter and buffer was filled.

:func:`flax_module_path` is the inverse map, from a port module name to its
flax path (the trainer applies the JAX package's stage regexes to it), and
:func:`from_jax_train_state` turns a JAX ``TrainState`` (params, BN
statistics, the optimizer's state, the intertwiner buffer) into the port
trainer's state. :func:`apply_cross_name_init` copies one parameter into
another by their flax paths (``DEV.BIG_FC_INIT_LIST``).
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
    (r"dev/upsample(\d)/(?:de)?conv", r"dev_roi.upsample.\1.0"),
    (r"dev/upsample(\d)/bn", r"dev_roi.upsample.\1.1"),
    (r"dev/upsample(\d)", r"dev_roi.upsample.\1"),
    (r"dev/critic/conv1", r"dev_roi.feat_extract.0"),
    (r"dev/critic/bn1", r"dev_roi.feat_extract.1"),
    (r"dev/critic/conv2", r"dev_roi.feat_extract.3"),
    (r"dev/critic/bn2", r"dev_roi.feat_extract.4"),
    (r"dev/critic/conv3", r"dev_roi.feat_extract.6"),
    (r"dev/critic/bn3", r"dev_roi.feat_extract.7"),
    (r"dev/big_fc", r"dev_roi.big_fc_layer"),
    (r"ot_loss/g_conv", r"ot_loss.G_net.0"),
    (r"ot_loss/critic_conv", r"ot_loss.critic.0"),
    (r"ot_loss/critic_fc", r"ot_loss.critic"),
    (r"fpn/p(\d)_ot/g_deconv", r"fpn.p\1_ot.G_net.0"),
    (r"fpn/p(\d)_ot/g_bn", r"fpn.p\1_ot.G_net.1"),
    (r"fpn/p(\d)_ot/critic_conv1", r"fpn.p\1_ot.critic.0"),
    (r"fpn/p(\d)_ot/critic_bn1", r"fpn.p\1_ot.critic.1"),
    (r"fpn/p(\d)_ot/critic_conv2", r"fpn.p\1_ot.critic.3"),
    (r"fpn/p(\d)_ot/critic_bn2", r"fpn.p\1_ot.critic.4"),
)
# port module name -> flax module path: the inverse of _MODULES (mask.conv5
# before mask.conv\d, which would take it)
_FLAX_MODULES = (
    (r"fpn\.C1\.0", r"backbone/c1_conv"),
    (r"fpn\.C1\.1", r"backbone/c1_bn"),
    (r"fpn\.C(\d)\.(\d+)\.downsample\.0", r"backbone/c\1/block\2/proj_conv"),
    (r"fpn\.C(\d)\.(\d+)\.downsample\.1", r"backbone/c\1/block\2/proj_bn"),
    (r"fpn\.C(\d)\.(\d+)\.((?:conv|bn)\d)", r"backbone/c\1/block\2/\3"),
    (r"fpn\.P(\d)_conv1", r"fpn/p\1_lateral"),
    (r"fpn\.P(\d)_conv2\.1", r"fpn/p\1_out"),
    (r"rpn\.conv_shared", r"rpn/shared"),
    (r"rpn\.conv_class", r"rpn/cls"),
    (r"rpn\.conv_bbox", r"rpn/bbox"),
    (r"classifier\.conv(\d)", r"classifier/fc\1"),
    (r"classifier\.(bn\d|linear_class|linear_bbox)", r"classifier/\1"),
    (r"mask\.deconv", r"mask/upsample"),
    (r"mask\.conv5", r"mask/logits"),
    (r"mask\.((?:conv|bn)\d)", r"mask/\1"),
    (r"dev_roi\.upsample\.(\d)\.0", r"dev/upsample\1/conv"),
    (r"dev_roi\.upsample\.(\d)\.1", r"dev/upsample\1/bn"),
    (r"dev_roi\.upsample\.(\d)", r"dev/upsample\1"),
    (r"dev_roi\.feat_extract\.0", r"dev/critic/conv1"),
    (r"dev_roi\.feat_extract\.1", r"dev/critic/bn1"),
    (r"dev_roi\.feat_extract\.3", r"dev/critic/conv2"),
    (r"dev_roi\.feat_extract\.4", r"dev/critic/bn2"),
    (r"dev_roi\.feat_extract\.6", r"dev/critic/conv3"),
    (r"dev_roi\.feat_extract\.7", r"dev/critic/bn3"),
    (r"dev_roi\.big_fc_layer", r"dev/big_fc"),
    (r"ot_loss\.G_net\.0", r"ot_loss/g_conv"),
    (r"ot_loss\.critic\.0", r"ot_loss/critic_conv"),
    (r"ot_loss\.critic", r"ot_loss/critic_fc"),
    (r"fpn\.p(\d)_ot\.G_net\.0", r"fpn/p\1_ot/g_deconv"),
    (r"fpn\.p(\d)_ot\.G_net\.1", r"fpn/p\1_ot/g_bn"),
    (r"fpn\.p(\d)_ot\.critic\.0", r"fpn/p\1_ot/critic_conv1"),
    (r"fpn\.p(\d)_ot\.critic\.1", r"fpn/p\1_ot/critic_bn1"),
    (r"fpn\.p(\d)_ot\.critic\.3", r"fpn/p\1_ot/critic_conv2"),
    (r"fpn\.p(\d)_ot\.critic\.4", r"fpn/p\1_ot/critic_bn2"),
)
# the transposed convs whose port name also holds a conv: their flax path
_FLAX_TRANSPOSED = ((r"dev_roi\.upsample\.(\d)\.0", r"dev/upsample\1/deconv"),)
# flax ConvTranspose layers (flax module paths, full match)
_TRANSPOSED = r"mask/upsample|fpn/p\d_ot/g_deconv|dev/upsample\d/deconv"
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


def flax_module_path(module: str, transposed: bool = False) -> str:
    """The flax module path of a port module name (``fpn.C4.0.conv1`` ->
    ``backbone/c4/block0/conv1``); ``transposed`` for a transposed conv
    (``dev_roi.upsample.0.0`` -> ``dev/upsample0/deconv``)."""
    for pattern, template in (_FLAX_TRANSPOSED if transposed else ()) + _FLAX_MODULES:
        m = re.fullmatch(pattern, module)
        if m:
            return m.expand(template)
    raise ValueError(f"flax_module_path: no flax module for port {module!r}")


def _port_tensor(path: str, leaf: str, value: np.ndarray) -> np.ndarray:
    """A flax leaf of module ``path`` in the port's layout."""
    if leaf != "kernel":
        return value
    if value.ndim == 2:                            # Dense [I, O]
        return value.T
    if value.ndim == 3:                            # 1-D Conv [k, I, O]
        return np.transpose(value, (2, 1, 0))
    if re.fullmatch(_TRANSPOSED, path):            # ConvTranspose
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
            flax_path = "/".join(mod)
            module = _port_module(flax_path)
            if is_bn:
                name = _BN_LEAVES[leaf]
                sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
            elif leaf in ("kernel", "bias"):
                name = "weight" if leaf == "kernel" else "bias"
            elif leaf == "gate" and re.fullmatch(r"dev/upsample\d", flax_path):
                name = "gate"
            else:
                raise ValueError(f"from_jax_params: unknown leaf {'/'.join(path)!r}")
            arr = np.ascontiguousarray(_port_tensor(flax_path, leaf, value), dtype=np.float32)
            sd[f"{module}.{name}"] = torch.from_numpy(arr)
    return sd


def _param_tree(tree) -> Dict[str, torch.Tensor]:
    """A parameter-shaped optax state tree as port parameter name -> tensor."""
    return {k: v for k, v in from_jax_params(tree, {}).items()
            if not k.endswith("num_batches_tracked")}


def from_jax_train_state(state) -> Dict[str, object]:
    """A JAX ``TrainState`` (``feature_intertwiner_tpu/train/step.py``) ->
    the port trainer's state: ``model`` (a state_dict, from ``params`` and
    ``batch_stats``), ``optim`` (the optimizer's state per slot, port
    parameter name -> tensor laid out as the parameter), ``buffer``,
    ``buffer_cnt`` and ``step``. ``optim`` reads the chain of the JAX
    ``make_optimizer``: SGD's ``masked(add_decayed_weights) -> trace`` gives
    ``momentum_buffer`` (the trace); Adam's ``add_decayed_weights ->
    scale_by_adam`` ``mu``, ``nu`` and its step ``count``; RMSprop's
    ``add_decayed_weights -> scale_by_stddev -> trace`` ``mu``, ``nu`` and
    ``trace``. Load it with ``train/step.py::load_trainer_state``."""
    model = from_jax_params(state.params, state.batch_stats)
    chain = state.opt_state
    if "nu" in chain[-1]._fields:                       # scale_by_adam
        optim = {"mu": _param_tree(chain[-1].mu), "nu": _param_tree(chain[-1].nu),
                 "count": int(np.asarray(chain[-1].count))}
    elif len(chain) == 3:                               # scale_by_stddev -> trace
        optim = {"mu": _param_tree(chain[1].mu), "nu": _param_tree(chain[1].nu),
                 "trace": _param_tree(chain[2].trace)}
    else:                                               # masked decay -> trace
        optim = {"momentum_buffer": _param_tree(chain[1].trace)}
    return {
        "model": model,
        "optim": optim,
        "buffer": torch.from_numpy(np.asarray(state.buffer, np.float32)),
        "buffer_cnt": torch.from_numpy(np.asarray(state.buffer_cnt, np.float32)),
        "step": int(np.asarray(state.step)),
    }


def apply_cross_name_init(model: torch.nn.Module, init_list: Dict[str, str], paths: Dict[str, str],
                          log_fn=print) -> None:
    """Copy parameters between differently named leaves of ``model``, in
    place: ``init_list`` maps flax parameter paths {target: source} (the JAX
    ``apply_cross_name_init`` over ``DEV.BIG_FC_INIT_LIST``, e.g.
    ``dev/big_fc/kernel`` from ``classifier/linear_class/kernel``), and
    ``paths`` is each port parameter's flax path (``train/optim.py::
    flax_paths``). A pair whose leaf is missing, or whose shapes differ, is
    skipped and logged, as there."""
    by_path = {path: name for name, path in paths.items()}
    params = dict(model.named_parameters())
    for dst, src in (init_list or {}).items():
        if src not in by_path or dst not in by_path:
            log_fn(f"[cross-init] skip {dst} <- {src} (missing)")
            continue
        target, source = params[by_path[dst]], params[by_path[src]]
        if target.shape != source.shape:
            log_fn(f"[cross-init] skip {dst} <- {src} (shape mismatch)")
            continue
        with torch.no_grad():
            target.copy_(source)
        log_fn(f"[cross-init] {dst} <- {src}")
