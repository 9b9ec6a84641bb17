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

Pretrained files (JAX ``utils/convert_weights.py``) come in as flat
(params, batch_stats) dicts keyed by flax leaf path
(``classifier/fc1/kernel``, ``classifier/bn1/BatchNorm_0/mean``), the JAX
trees flattened, in the JAX layouts:

- :func:`load_reference_checkpoint` reads a reference ``.pth`` (``module.``
  stripped) and its ``save_model`` extras (epoch, iter, buffer,
  buffer_cnt, loss_data); :func:`convert_reference_state_dict` maps its
  state_dict as the JAX converter does, reporting (or, ``strict``,
  refusing) every key it leaves unmapped;
- :func:`convert_keras_h5` maps a Matterport keras ``.h5`` (``h5py``,
  imported when it reads one; :func:`write_keras_h5` writes one);
- :func:`load_converted_npz` reads the npz of either package's converter
  command line (``params/<path>`` and ``batch_stats/<path>`` keys).

:func:`merge_pretrained` overlays them on a model by flax path, through
the layouts of :func:`from_jax_params`: a strict=False load that logs, per
tree, the JAX ``merge_pretrained`` line (loaded, from-scratch,
shape-mismatch, unused) and then names every mismatched and unused leaf.
The command line writes the JAX converter's npz::

    python -m feature_intertwiner_tpu_torch.utils.convert_weights \
        --input weights.h5|ckpt.pth --format keras|reference \
        --arch resnet101 --output converted.npz
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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


# --- pretrained files ----------------------------------------------------------------------
Flat = Dict[str, np.ndarray]            # flax leaf path -> array, JAX layout
BOTTLENECKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
_BN_FLAX = {"weight": "BatchNorm_0/scale", "bias": "BatchNorm_0/bias",
            "running_mean": "BatchNorm_0/mean", "running_var": "BatchNorm_0/var"}


def flax_leaves(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """Port state_dict name -> (its JAX tree, ``params`` or
    ``batch_stats``; its flax leaf path): ``fpn.C1.1.running_mean`` ->
    (``batch_stats``, ``backbone/c1_bn/BatchNorm_0/mean``). BN's
    ``num_batches_tracked`` has no JAX leaf."""
    out = {}
    for name in model.state_dict():
        mod_name, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        mod = model.get_submodule(mod_name)
        if isinstance(mod, nn.BatchNorm2d):
            flax_leaf = _BN_FLAX[leaf]
        else:
            flax_leaf = {"weight": "kernel", "bias": "bias", "gate": "gate"}[leaf]
        tree = "batch_stats" if leaf.startswith("running_") else "params"
        path = flax_module_path(mod_name, isinstance(mod, nn.ConvTranspose2d))
        out[name] = (tree, f"{path}/{flax_leaf}")
    return out


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """A reference ``.pth``: (its state_dict as name -> numpy, ``module.``
    stripped; the extras of its ``save_model`` payload, of ``epoch``,
    ``iter``, ``buffer``, ``buffer_cnt`` and ``loss_data`` those present)."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    out = {re.sub(r"^module\.", "", k): v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    extras = {}
    if isinstance(payload, dict):
        for k in ("epoch", "iter", "buffer", "buffer_cnt", "loss_data"):
            if k in payload:
                v = payload[k]
                extras[k] = v.numpy() if hasattr(v, "numpy") else v
    return out, extras


def _bn(p: Flat, s: Flat, path: str, sd, src: str) -> None:
    """A torch BN at ``src`` into the flax BN at ``path``."""
    p[f"{path}/BatchNorm_0/scale"] = np.asarray(sd[f"{src}.weight"])
    p[f"{path}/BatchNorm_0/bias"] = np.asarray(sd[f"{src}.bias"])
    if f"{src}.running_mean" in sd:
        s[f"{path}/BatchNorm_0/mean"] = np.asarray(sd[f"{src}.running_mean"])
        s[f"{path}/BatchNorm_0/var"] = np.asarray(sd[f"{src}.running_var"])


class _TrackedSD(dict):
    """A state_dict that records the keys read from it."""

    def __init__(self, sd):
        super().__init__(sd)
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return super().__getitem__(key)


def _conv(w):                        # torch [O, I, kh, kw] -> flax [kh, kw, I, O]
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _deconv(w):                      # torch [I, O, kh, kw] -> flax [kh, kw, I, O], flipped
    return np.transpose(np.asarray(w), (2, 3, 0, 1))[::-1, ::-1]


def _linear(w):                      # torch [O, I] -> flax [I, O]
    return np.transpose(np.asarray(w), (1, 0))


def _conv1d(w):                      # torch [O, I, k] -> flax [k, I, O]
    return np.transpose(np.asarray(w), (2, 1, 0))


def convert_reference_state_dict(sd: Dict[str, np.ndarray], arch: str = "resnet101",
                                 upsample_fac: float = 1.0, log_fn=None,
                                 strict: bool = False) -> Tuple[Flat, Flat]:
    """A reference state_dict -> (params, batch_stats) by flax leaf path,
    as the JAX ``convert_reference_state_dict`` maps it: the ``arch``'s
    backbone blocks, the FPN, RPN, heads, the Dev (``upsample_fac`` 2: its
    make-up layer a transposed conv), the meta OT and the FPN OT. Every
    source key the map does not read (``num_batches_tracked`` aside) is
    logged through ``log_fn``, and raises with ``strict``."""
    sd = _TrackedSD(sd)
    p: Flat = {}
    s: Flat = {}

    def conv_pair(dst, src):
        if f"{src}.weight" in sd:
            p[f"{dst}/kernel"] = _conv(sd[f"{src}.weight"])
            if f"{src}.bias" in sd:
                p[f"{dst}/bias"] = np.asarray(sd[f"{src}.bias"])

    conv_pair("backbone/c1_conv", "fpn.C1.0")
    if "fpn.C1.1.weight" in sd:
        _bn(p, s, "backbone/c1_bn", sd, "fpn.C1.1")
    for stage, blocks in zip((2, 3, 4, 5), BOTTLENECKS[arch]):
        for b in range(blocks):
            src, dst = f"fpn.C{stage}.{b}", f"backbone/c{stage}/block{b}"
            for i in (1, 2, 3):
                conv_pair(f"{dst}/conv{i}", f"{src}.conv{i}")
                if f"{src}.bn{i}.weight" in sd:
                    _bn(p, s, f"{dst}/bn{i}", sd, f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in sd:
                conv_pair(f"{dst}/proj_conv", f"{src}.downsample.0")
                _bn(p, s, f"{dst}/proj_bn", sd, f"{src}.downsample.1")
    for lvl in (2, 3, 4, 5):
        conv_pair(f"fpn/p{lvl}_lateral", f"fpn.P{lvl}_conv1")
        conv_pair(f"fpn/p{lvl}_out", f"fpn.P{lvl}_conv2.1")
    conv_pair("rpn/shared", "rpn.conv_shared")
    conv_pair("rpn/cls", "rpn.conv_class")
    conv_pair("rpn/bbox", "rpn.conv_bbox")
    conv_pair("classifier/fc1", "classifier.conv1")
    conv_pair("classifier/fc2", "classifier.conv2")
    for i in (1, 2):
        if f"classifier.bn{i}.weight" in sd:
            _bn(p, s, f"classifier/bn{i}", sd, f"classifier.bn{i}")
    for name in ("linear_class", "linear_bbox"):
        if f"classifier.{name}.weight" in sd:
            p[f"classifier/{name}/kernel"] = _linear(sd[f"classifier.{name}.weight"])
            p[f"classifier/{name}/bias"] = np.asarray(sd[f"classifier.{name}.bias"])
    for i in (1, 2, 3, 4):
        conv_pair(f"mask/conv{i}", f"mask.conv{i}")
        if f"mask.bn{i}.weight" in sd:
            _bn(p, s, f"mask/bn{i}", sd, f"mask.bn{i}")
    if "mask.deconv.weight" in sd:
        p["mask/upsample/kernel"] = _deconv(sd["mask.deconv.weight"])
        p["mask/upsample/bias"] = np.asarray(sd["mask.deconv.bias"])
    conv_pair("mask/logits", "mask.conv5")
    # the make-up conv: a Conv2d at UPSAMPLE_FAC 1, a ConvTranspose2d at 2,
    # of equal shapes, so the factor picks the layout
    for m in range(4):
        src = f"dev_roi.upsample.{m}.0"
        if f"{src}.weight" in sd:
            w = sd[f"{src}.weight"]
            kind, layout = ("deconv", _deconv) if upsample_fac == 2.0 else ("conv", _conv)
            p[f"dev/upsample{m}/{kind}/kernel"] = layout(w)
            p[f"dev/upsample{m}/{kind}/bias"] = np.asarray(sd[f"{src}.bias"])
            _bn(p, s, f"dev/upsample{m}/bn", sd, f"dev_roi.upsample.{m}.1")
    for idx, name in {0: "conv1", 1: "bn1", 3: "conv2", 4: "bn2", 6: "conv3", 7: "bn3"}.items():
        src = f"dev_roi.feat_extract.{idx}"
        if name.startswith("conv"):
            conv_pair(f"dev/critic/{name}", src)
        elif f"{src}.weight" in sd:
            _bn(p, s, f"dev/critic/{name}", sd, src)
    if "dev_roi.big_fc_layer.weight" in sd:
        p["dev/big_fc/kernel"] = _linear(sd["dev_roi.big_fc_layer.weight"])
        p["dev/big_fc/bias"] = np.asarray(sd["dev_roi.big_fc_layer.bias"])
    for dst, src, layout in (("ot_loss/g_conv", "ot_loss.G_net.0", _conv1d),
                             ("ot_loss/critic_conv", "ot_loss.critic.0", _conv1d),
                             ("ot_loss/critic_fc", "ot_loss.critic", _linear)):
        if f"{src}.weight" in sd:
            p[f"{dst}/kernel"] = layout(sd[f"{src}.weight"])
            p[f"{dst}/bias"] = np.asarray(sd[f"{src}.bias"])
    for lvl in (2, 3, 4):
        src, dst = f"fpn.p{lvl}_ot", f"fpn/p{lvl}_ot"
        if f"{src}.G_net.0.weight" not in sd:
            continue
        p[f"{dst}/g_deconv/kernel"] = _deconv(sd[f"{src}.G_net.0.weight"])
        p[f"{dst}/g_deconv/bias"] = np.asarray(sd[f"{src}.G_net.0.bias"])
        _bn(p, s, f"{dst}/g_bn", sd, f"{src}.G_net.1")
        for i, (conv, bn) in enumerate(((0, 1), (3, 4)), start=1):
            conv_pair(f"{dst}/critic_conv{i}", f"{src}.critic.{conv}")
            _bn(p, s, f"{dst}/critic_bn{i}", sd, f"{src}.critic.{bn}")

    unmapped = sorted(k for k in sd if k not in sd.used and not k.endswith("num_batches_tracked"))
    if unmapped:
        msg = (f"convert_reference_state_dict: {len(unmapped)} source keys have no mapping:\n"
               + "\n".join(f"  UNMAPPED {k}  {tuple(np.shape(sd[k]))}" for k in unmapped))
        if strict:
            raise ValueError(msg)
        (log_fn or print)(msg)
    return p, s


def keras_layers(arch: str = "resnet101") -> List[Tuple[str, str, str]]:
    """The layers of a Matterport Mask R-CNN keras file, as (kind, flax
    module path, keras layer name), kind ``conv`` (a kernel already HWIO,
    and a bias), ``deconv`` or ``bn``: the backbone (block letters a, b, c,
    ... in every stage, the JAX ``_keras_block_name``), FPN, RPN,
    classifier and mask head, as the JAX ``convert_keras_h5`` reads them."""
    out = [("conv", "backbone/c1_conv", "conv1"), ("bn", "backbone/c1_bn", "bn_conv1")]
    for stage, blocks in zip((2, 3, 4, 5), BOTTLENECKS[arch]):
        for b in range(blocks):
            letter, dst = "abcdefghijklmnopqrstuvwxyz"[b], f"backbone/c{stage}/block{b}"
            for i, branch in ((1, "2a"), (2, "2b"), (3, "2c")):
                out += [("conv", f"{dst}/conv{i}", f"res{stage}{letter}_branch{branch}"),
                        ("bn", f"{dst}/bn{i}", f"bn{stage}{letter}_branch{branch}")]
            if b == 0:
                out += [("conv", f"{dst}/proj_conv", f"res{stage}{letter}_branch1"),
                        ("bn", f"{dst}/proj_bn", f"bn{stage}{letter}_branch1")]
    for lvl in (5, 4, 3, 2):
        out += [("conv", f"fpn/p{lvl}_lateral", f"fpn_c{lvl}p{lvl}"),
                ("conv", f"fpn/p{lvl}_out", f"fpn_p{lvl}")]
    out += [("conv", "rpn/shared", "rpn_conv_shared"), ("conv", "rpn/cls", "rpn_class_raw"),
            ("conv", "rpn/bbox", "rpn_bbox_pred"),
            ("conv", "classifier/fc1", "mrcnn_class_conv1"),
            ("bn", "classifier/bn1", "mrcnn_class_bn1"),
            ("conv", "classifier/fc2", "mrcnn_class_conv2"),
            ("bn", "classifier/bn2", "mrcnn_class_bn2"),
            ("conv", "classifier/linear_class", "mrcnn_class_logits"),
            ("conv", "classifier/linear_bbox", "mrcnn_bbox_fc")]
    for i in (1, 2, 3, 4):
        out += [("conv", f"mask/conv{i}", f"mrcnn_mask_conv{i}"),
                ("bn", f"mask/bn{i}", f"mrcnn_mask_bn{i}")]
    return out + [("deconv", "mask/upsample", "mrcnn_mask_deconv"),
                  ("conv", "mask/logits", "mrcnn_mask")]


_KERAS_BN = (("BatchNorm_0/scale", "gamma"), ("BatchNorm_0/bias", "beta"),
             ("BatchNorm_0/mean", "moving_mean"), ("BatchNorm_0/var", "moving_variance"))


def _h5py(path: str):
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(f"{path}: keras .h5 files need h5py, which is not installed") from exc
    return h5py


def convert_keras_h5(h5_path: str, arch: str = "resnet101") -> Tuple[Flat, Flat]:
    """Matterport Mask R-CNN keras weights -> (params, batch_stats) by flax
    leaf path (:func:`keras_layers`). The keras transposed conv
    ``[kh, kw, OUT, IN]`` (torch's semantics) becomes flax's ``[kh, kw, IN,
    OUT]``, flipped spatially. Raises ``ImportError`` without ``h5py``."""
    h5py = _h5py(h5_path)
    p: Flat = {}
    s: Flat = {}
    with h5py.File(h5_path, "r") as f:
        layers = f["model_weights"] if "model_weights" in f else f

        def get(layer, weight):
            grp = layers[layer]
            if layer in grp:                 # keras nests layer/layer/weight
                grp = grp[layer]
            return np.asarray(grp[f"{weight}:0"])

        for kind, path, layer in keras_layers(arch):
            if kind == "bn":
                for leaf, weight in _KERAS_BN:
                    (s if leaf.endswith(("mean", "var")) else p)[f"{path}/{leaf}"] = \
                        get(layer, weight)
                continue
            kernel = get(layer, "kernel")
            if kind == "deconv":
                kernel = np.ascontiguousarray(np.transpose(kernel, (0, 1, 3, 2))[::-1, ::-1])
            p[f"{path}/kernel"] = kernel
            p[f"{path}/bias"] = get(layer, "bias")
    return p, s


def write_keras_h5(h5_path: str, params: Flat, stats: Flat, arch: str = "resnet101") -> None:
    """The inverse of :func:`convert_keras_h5`: (params, batch_stats) by
    flax leaf path as a Matterport keras file
    (``model_weights/<layer>/<layer>/<weight>:0``)."""
    h5py = _h5py(h5_path)
    with h5py.File(h5_path, "w") as f:
        root = f.create_group("model_weights")
        for kind, path, layer in keras_layers(arch):
            grp = root.create_group(layer).create_group(layer)
            if kind == "bn":
                for leaf, weight in _KERAS_BN:
                    tree = stats if leaf.endswith(("mean", "var")) else params
                    grp[f"{weight}:0"] = np.asarray(tree[f"{path}/{leaf}"])
                continue
            kernel = np.asarray(params[f"{path}/kernel"])
            if kind == "deconv":
                kernel = np.ascontiguousarray(np.transpose(kernel[::-1, ::-1], (0, 1, 3, 2)))
            grp["kernel:0"] = kernel
            grp["bias:0"] = np.asarray(params[f"{path}/bias"])


def load_converted_npz(path: str) -> Tuple[Flat, Flat]:
    """The npz of either package's converter command line ->
    (params, batch_stats) by flax leaf path."""
    p: Flat = {}
    s: Flat = {}
    with np.load(path) as data:
        for key in data.files:
            tree, _, leaf = key.partition("/")
            if tree == "params":
                p[leaf] = data[key]
            elif tree == "batch_stats":
                s[leaf] = data[key]
    return p, s


def merge_pretrained(model: nn.Module, state: Tuple[Flat, Flat], log_fn=print) -> None:
    """Overlay loaded (params, batch_stats) on ``model``'s tensors in place,
    a strict=False load by flax leaf path, each leaf in the port's layout
    (:func:`from_jax_params`) and cast to the tensor's dtype. Per tree it
    logs the JAX ``merge_pretrained`` line, ``[params] loaded N,
    from-scratch N, shape-mismatch N, unused N``, then one line for every
    mismatched leaf (both shapes, JAX layout) and every unused one."""
    leaves = flax_leaves(model)
    tensors = dict(model.state_dict(keep_vars=True))
    for label, src in zip(("params", "batch_stats"), state):
        dst = {path: name for name, (tree, path) in leaves.items() if tree == label}
        loaded, missing, mismatched = 0, [], []
        for path, name in dst.items():
            if path not in src:
                missing.append(path)
                continue
            target, value = tensors[name], np.asarray(src[path])
            module, leaf = path.rsplit("/", 1)
            if value.ndim == target.ndim:
                value = _port_tensor(module.removesuffix("/BatchNorm_0"), leaf, value)
            if tuple(value.shape) != tuple(target.shape):
                mismatched.append(f"{path}: file {tuple(np.shape(src[path]))}, "
                                  f"model {tuple(target.shape)} (port layout)")
                continue
            with torch.no_grad():
                target.copy_(torch.from_numpy(np.ascontiguousarray(value, np.float32)))
            loaded += 1
        unused = [k for k in src if k not in dst]
        log_fn(f"[{label}] loaded {loaded}, from-scratch {len(missing)}, "
               f"shape-mismatch {len(mismatched)}, unused {len(unused)}")
        for line in mismatched:
            log_fn(f"[{label}] shape-mismatch {line}")
        for k in unused:
            log_fn(f"[{label}] unused {k} {tuple(np.shape(src[k]))}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """The converter command line (module docstring)."""
    ap = argparse.ArgumentParser(description="Convert pretrained weights to the JAX npz")
    ap.add_argument("--input", required=True)
    ap.add_argument("--format", choices=["keras", "reference"], required=True)
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--upsample_fac", type=float, default=1.0)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    if args.format == "keras":
        params, stats = convert_keras_h5(args.input, args.arch)
    else:
        params, stats = convert_reference_state_dict(
            load_reference_checkpoint(args.input)[0], args.arch, upsample_fac=args.upsample_fac)
    np.savez(args.output, **{f"params/{k}": v for k, v in params.items()},
             **{f"batch_stats/{k}": v for k, v in stats.items()})
    print(f"wrote {len(params)} params + {len(stats)} stats to {args.output}")


if __name__ == "__main__":
    main()
