"""Starting from pretrained files in the port against the JAX package, on
the CPU.

Every file is written here from random JAX parameters of the tiny
ResNet-50 model of ``test_torch_trainer.py`` (nothing is downloaded): a
reference ``.pth`` (``module.`` names, the ``save_model`` payload), the
npz of each package's converter command line, and a Matterport keras
``.h5``. Each file starts a ``Trainer`` of both packages from the same
initial weights (``MODEL.INIT_FILE_CHOICE``), and the port's state_dict
after ``Trainer.resume`` is bit-equal to ``from_jax_params`` of the JAX
trainer's merged trees. Also held:

- the payload's intertwiner buffer, ``buffer_cnt`` and epoch and iteration
  counters restored as JAX restores them; a buffer of another shape raises
  ``ValueError`` under ``TRAIN.STRICT_RESUME`` in both packages and is
  otherwise left as initialised, with the log line;
- on a partial ``.pth`` (missing, mismatched, unmapped and unused keys) the
  four counts of each tree's overlay line equal JAX's, and the port names
  each mismatched and unused leaf;
- the two command lines write the same npz, key for key and bit for bit,
  from a ``.pth`` and from an ``.h5``; the JAX package reads back the
  ``.h5`` that the port's ``write_keras_h5`` writes;
- another suffix raises ``ValueError`` in both.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models.detector import InterNet as JInterNet
from feature_intertwiner_tpu.train import workflow as jax_workflow
from feature_intertwiner_tpu.utils import convert_weights as jax_cw
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train import workflow
from feature_intertwiner_tpu_torch.utils import convert_weights as cw
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_model import KEY, _redraw
from test_torch_trainer import TRAIN_OPTS

OVERLAY = re.compile(r"\[(params|batch_stats)\] loaded (\d+), from-scratch (\d+), "
                     r"shape-mismatch (\d+), unused (\d+)")


def _random(tree, rng):
    """A tree of the shapes of ``tree`` drawn from N(0, 0.1²)."""
    return {k: _random(v, rng) if hasattr(v, "items") else
            (rng.randn(*np.shape(v)) * 0.1).astype(np.float32) for k, v in tree.items()}


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its initial variables, and random JAX parameters:
    their trees and a reference state_dict of them (the reference names are
    the port's)."""
    jcfg = jax_build_config(opts=TRAIN_OPTS)
    jm = JInterNet.from_config(jcfg, dtype=jnp.float32)
    init = jax.jit(lambda: jm.init({"params": KEY}, jnp.zeros((1, 128, 128, 3)),
                                   mode="inference",
                                   windows=jnp.asarray([[0, 0, 128, 128]], jnp.float32)))()
    rng = np.random.RandomState(50)
    variables = {"params": _redraw(init["params"], rng),
                 "batch_stats": _redraw(init["batch_stats"], rng)}
    other = {k: _random(v, rng) for k, v in variables.items()}
    sd = from_jax_params(other["params"], other["batch_stats"])
    return jm, variables, {k: v.numpy() for k, v in sd.items()}, other


def _write_pth(path, sd, **payload):
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}, **payload}, path)
    return str(path)


def _resume(setup, folder, path, package, opts=()):
    """A trainer of ``package`` ('jax' or 'port') started from ``path``,
    logging under ``folder/package``: (trainer, its log)."""
    jm, variables = setup[:2]
    cfg = (jax_build_config if package == "jax" else build_config)(opts=TRAIN_OPTS + list(opts))
    cfg.MODEL.INIT_FILE_CHOICE = str(path)
    cfg.MISC.RESULT_FOLDER = str(folder / package)
    cfg.MISC.LOG_FILE = str(folder / package / "log.txt")
    (folder / package).mkdir(parents=True, exist_ok=True)
    if package == "jax":
        trainer = jax_workflow.Trainer(jm, cfg, variables).resume()
    else:
        model = InterNet.from_config(cfg)
        model.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]),
                              strict=True)
        trainer = workflow.Trainer(model.to(memory_format=torch.channels_last), cfg).resume()
    return trainer, (folder / package / "log.txt").read_text()


def _resume_both(setup, folder, path, opts=()):
    """Both trainers started from ``path``: (JAX trainer, port trainer, JAX
    log, port log)."""
    (jt, jlog), (pt, plog) = (_resume(setup, folder, path, p, opts) for p in ("jax", "port"))
    return jt, pt, jlog, plog


def _assert_same_weights(jt, pt):
    want = from_jax_params(jt.state.params, jt.state.batch_stats)
    got = pt.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _counts(log):
    return {m.group(1): tuple(int(x) for x in m.groups()[1:]) for m in OVERLAY.finditer(log)}


def _buffers(state):
    return np.asarray(state.buffer), np.asarray(state.buffer_cnt)


def test_reference_payload_restores_weights_buffer_and_counters(setup, tmp_path):
    sd = setup[2]
    rng = np.random.RandomState(52)
    buf = rng.randn(1, 1024, 4).astype(np.float32)
    cnt = rng.randint(0, 5, (1, 1, 4)).astype(np.float32)
    path = _write_pth(tmp_path / "ref.pth", sd, epoch=3, iter=5, buffer=torch.from_numpy(buf),
                      buffer_cnt=torch.from_numpy(cnt), loss_data=[1.0, 2.0])
    jt, pt, jlog, plog = _resume_both(setup, tmp_path, path)
    _assert_same_weights(jt, pt)
    for got, want, value in zip(_buffers(pt.state), _buffers(jt.state), (buf, cnt)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, value)
    assert (pt.epoch, pt.iter) == (jt.epoch, jt.iter) == (3, 6)
    assert _counts(plog) == _counts(jlog)
    p_loaded = _counts(plog)["params"]
    assert p_loaded[0] > 0 and p_loaded[1:] == (0, 0, 0)
    for line in ("restored intertwiner buffer (1, 1024, 4)",
                 "resumed counters from payload (ep 3, iter 5)",
                 f"initialized from pretrained weights: {path}"):
        assert line in plog and line in jlog


def test_a_buffer_of_another_shape_raises_under_strict_resume(setup, tmp_path):
    sd = setup[2]
    path = _write_pth(tmp_path / "ref.pth", sd, epoch=2, iter=0,
                      buffer=torch.ones(2, 1024, 4), buffer_cnt=torch.ones(2, 1, 4))
    errors = []
    for package in ("jax", "port"):
        with pytest.raises(ValueError, match="TRAIN.STRICT_RESUME forbids") as err:
            _resume(setup, tmp_path / "strict", path, package, ["TRAIN.STRICT_RESUME", "True"])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    jt, pt, jlog, plog = _resume_both(setup, tmp_path / "lenient", path)
    _assert_same_weights(jt, pt)
    for got, want in zip(_buffers(pt.state), _buffers(jt.state)):
        np.testing.assert_array_equal(got, want)
        assert not got.any()
    line = ("payload buffer not restored: buffer (2, 1024, 4) vs (1, 1024, 4), buffer_cnt "
            "(2, 1, 4) vs (1, 1, 4); reinitialized")
    assert line in plog and line in jlog
    assert (pt.epoch, pt.iter) == (jt.epoch, jt.iter) == (2, 1)


def test_partial_reference_file_reports_what_jax_reports(setup, tmp_path):
    sd = setup[2]
    part = dict(sd)
    for key in ("classifier.conv2.weight", "fpn.C2.0.bn1.running_mean",
                "fpn.C2.0.bn1.running_var", "mask.bn3.weight", "mask.bn3.bias"):
        del part[key]                                   # from scratch
    part["rpn.conv_class.weight"] = np.zeros((8, 512, 1, 1), np.float32)      # mismatched
    part["classifier.linear_class.weight"] = np.zeros((5, 1024), np.float32)
    part["mask.conv5.bias"] = np.zeros((4, 1), np.float32)
    part["fpn.C3.0.bn2.running_var"] = np.ones(7, np.float32)
    part["dev_roi.big_fc_layer.weight"] = np.zeros((4, 1024), np.float32)     # unused
    part["dev_roi.big_fc_layer.bias"] = np.zeros(4, np.float32)
    part["ot_loss.G_net.0.weight"] = np.zeros((1, 1, 1), np.float32)
    part["ot_loss.G_net.0.bias"] = np.zeros(1, np.float32)
    part["extra.head.weight"] = np.zeros(3, np.float32)                       # unmapped
    path = _write_pth(tmp_path / "part.pth", part)
    jt, pt, jlog, plog = _resume_both(setup, tmp_path, path)
    _assert_same_weights(jt, pt)
    counts = _counts(plog)
    assert counts == _counts(jlog)
    assert counts["params"][1:] == (4, 3, 4) and counts["batch_stats"][1:] == (4, 1, 0)
    for name in ("rpn/cls/kernel", "classifier/linear_class/kernel", "mask/logits/bias"):
        assert f"[params] shape-mismatch {name}:" in plog
    assert "[batch_stats] shape-mismatch backbone/c3/block0/bn2/BatchNorm_0/var:" in plog
    for name in ("dev/big_fc/kernel", "dev/big_fc/bias", "ot_loss/g_conv/kernel",
                 "ot_loss/g_conv/bias"):
        assert f"[params] unused {name}" in plog
    for log in (plog, jlog):
        assert "UNMAPPED extra.head.weight" in log and "UNMAPPED classifier.conv2.bias" in log


def _cli_pair(tmp_path, monkeypatch, src, fmt, name):
    """Both converter command lines on ``src``: the two npz paths."""
    jax_out, port_out = str(tmp_path / f"{name}_jax.npz"), str(tmp_path / f"{name}_port.npz")
    monkeypatch.setattr(sys, "argv", ["convert_weights", "--input", src, "--format", fmt,
                                      "--arch", "resnet50", "--output", jax_out])
    jax_cw._cli()
    cw.main(["--input", src, "--format", fmt, "--arch", "resnet50", "--output", port_out])
    with np.load(jax_out) as a, np.load(port_out) as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for key in a.files:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    return jax_out, port_out


def test_converter_npz_of_either_package_loads_in_both(setup, tmp_path, monkeypatch):
    sd = setup[2]
    pth = _write_pth(tmp_path / "ref.pth", sd)
    jax_npz, port_npz = _cli_pair(tmp_path, monkeypatch, pth, "reference", "ref")
    jt, pt, jlog, plog = _resume_both(setup, tmp_path / "a", jax_npz)
    _assert_same_weights(jt, pt)
    assert _counts(plog) == _counts(jlog)
    _, pt2, _, _ = _resume_both(setup, tmp_path / "b", port_npz)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(pt2.model.state_dict()[k], v), k


def _write_h5(path, params, stats):
    """A Matterport keras file (``model_weights/<layer>/<layer>/<weight>``)
    holding the flax trees ``params``/``stats`` under the keras names the
    converters read (the JAX ``tests/test_convert_weights.py`` layout)."""
    import h5py

    def leaf(tree, p):
        for k in p.split("/"):
            tree = tree[k]
        return np.asarray(tree, np.float32)

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")

        def put(layer, **weights):
            grp = g.create_group(layer).create_group(layer)
            for k, v in weights.items():
                grp[f"{k}:0"] = v

        def conv(layer, p):
            put(layer, kernel=leaf(params, f"{p}/kernel"), bias=leaf(params, f"{p}/bias"))

        def bn(layer, p):
            put(layer, gamma=leaf(params, f"{p}/BatchNorm_0/scale"),
                beta=leaf(params, f"{p}/BatchNorm_0/bias"),
                moving_mean=leaf(stats, f"{p}/BatchNorm_0/mean"),
                moving_variance=leaf(stats, f"{p}/BatchNorm_0/var"))

        conv("conv1", "backbone/c1_conv")
        bn("bn_conv1", "backbone/c1_bn")
        for stage, blocks in zip((2, 3, 4, 5), cw.BOTTLENECKS["resnet50"]):
            for b in range(blocks):
                letter, dst = "abcdefghijklmnopqrstuvwxyz"[b], f"backbone/c{stage}/block{b}"
                for i, branch in ((1, "2a"), (2, "2b"), (3, "2c")):
                    conv(f"res{stage}{letter}_branch{branch}", f"{dst}/conv{i}")
                    bn(f"bn{stage}{letter}_branch{branch}", f"{dst}/bn{i}")
                if b == 0:
                    conv(f"res{stage}{letter}_branch1", f"{dst}/proj_conv")
                    bn(f"bn{stage}{letter}_branch1", f"{dst}/proj_bn")
        for lvl in (2, 3, 4, 5):
            conv(f"fpn_c{lvl}p{lvl}", f"fpn/p{lvl}_lateral")
            conv(f"fpn_p{lvl}", f"fpn/p{lvl}_out")
        for layer, p in (("rpn_conv_shared", "rpn/shared"), ("rpn_class_raw", "rpn/cls"),
                         ("rpn_bbox_pred", "rpn/bbox"), ("mrcnn_class_conv1", "classifier/fc1"),
                         ("mrcnn_class_conv2", "classifier/fc2"),
                         ("mrcnn_class_logits", "classifier/linear_class"),
                         ("mrcnn_bbox_fc", "classifier/linear_bbox"), ("mrcnn_mask", "mask/logits")):
            conv(layer, p)
        bn("mrcnn_class_bn1", "classifier/bn1")
        bn("mrcnn_class_bn2", "classifier/bn2")
        for i in range(1, 5):
            conv(f"mrcnn_mask_conv{i}", f"mask/conv{i}")
            bn(f"mrcnn_mask_bn{i}", f"mask/bn{i}")
        # keras Conv2DTranspose [kh, kw, OUT, IN] of the flax [kh, kw, IN, OUT]
        kernel = leaf(params, "mask/upsample/kernel")
        put("mrcnn_mask_deconv", kernel=np.ascontiguousarray(
            np.transpose(kernel[::-1, ::-1], (0, 1, 3, 2))), bias=leaf(params, "mask/upsample/bias"))


def test_keras_h5_loads_as_in_jax(setup, tmp_path, monkeypatch):
    pytest.importorskip("h5py")
    other = setup[3]
    path = str(tmp_path / "keras.h5")
    _write_h5(path, other["params"], other["batch_stats"])
    jt, pt, jlog, plog = _resume_both(setup, tmp_path, path)
    _assert_same_weights(jt, pt)
    counts = _counts(plog)
    assert counts == _counts(jlog)
    assert counts["params"][0] > 0 and counts["params"][1] > 0     # the Dev stays from scratch
    _cli_pair(tmp_path, monkeypatch, path, "keras", "keras")
    # the port's writer inverts its reader: JAX reads back what it wrote
    params, stats = cw.convert_keras_h5(path, "resnet50")
    back = str(tmp_path / "back.h5")
    cw.write_keras_h5(back, params, stats, "resnet50")
    for got, want in zip(jax_cw.convert_keras_h5(back, "resnet50"), (params, stats)):
        got = {"/".join(k): v for k, v in traverse_util.flatten_dict(got).items()}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_another_suffix_raises_in_both(setup, tmp_path):
    path = tmp_path / "weights.bin"
    path.write_bytes(b"\0")
    for package in ("jax", "port"):
        with pytest.raises(ValueError, match="unrecognized pretrained weight format"):
            _resume(setup, tmp_path, path, package)
