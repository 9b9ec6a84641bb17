"""The training options of ``ROADMAP.md`` A5 in a train step, the port
against the jitted JAX step on the CPU, with the harness of
``test_torch_makeup_train.py`` (the ``TINY`` model with the train set-up of
``test_torch_train.py``, weights drawn by the JAX package's laws, the same
batch, draws and proposals, these kept ``EDGE`` inside the image):

- set A: ``TRAIN.OPTIM_METHOD adam``, ``TRAIN.BN_LEARN``,
  ``DEV.BIG_SUPERVISE`` and ``DEV.BIG_FEAT_DETACH False``, one 'all' step
  in float32, and in bfloat16 held to JAX's own bfloat16 error as
  ``test_torch_bf16_slice.py`` holds the flagship's;
- set B: ``TRAIN.OPTIM_METHOD rmsprop``, ``DEV.DIS_REG_LOSS`` and
  ``DEV.BASELINE`` with ``DEV.DIS_UPSAMPLER`` (the JAX package's own
  variant test pairs the two), one 'all' step in float32.

Bounds in float32: the losses, ``big_loss`` among them, within 1e-4
relative; the buffer within 1e-4; BN running statistics within 1e-4 of
each tensor's largest magnitude; the optimizer's state (Adam's ``mu``,
``nu`` and count; RMSprop's ``mu``, ``nu`` and trace) within 1e-5 of each
tensor's largest magnitude (``nu``, a squared gradient, as its square
root); the parameters within 1e-5 of each tensor's
largest magnitude of those the JAX package's optimizer gives from the
port's own gradients. Under ``DIS_REG_LOSS`` the RPN box, box and mask
losses read 0 while the mask head moves as JAX moves it.

Three things the float32 comparison works around, each measured and
recorded in ``ROADMAP.md`` §C ("Not faults"; ``PYTHONPATH=. python
tests/test_torch_train_options_step.py`` prints the numbers):

- Adam's and RMSprop's first step divide each gradient by its own size,
  so a gradient's last bits, where it is near 0, move its parameter by up
  to the learning rate: the parameters are held against the JAX optimizer
  on the port's gradients, and the gradients against JAX's through the
  optimizer's state;
- flax learns its batch statistics with XLA's float32 reductions, about 10x
  less accurate than the port's against float64 (``test_torch_train_options
  .py``), and the error compounds through the backbone: set A's JAX step
  runs with flax's batch moments taken from float64 (its formula and its
  gradient kept), :func:`exact_flax_moments`;
- under BN learning some gradients of this tiny batch move by several
  percent of their tensor's magnitude when only the rounding of the batch
  moments changes (channels nearly constant over the batch, normalised by
  ``sqrt(var + eps)``), and no bound per tensor against JAX's float32 step
  holds: a port step whose convolutions, dense layers and batch moments
  all run in float64 still lies 16% of a tensor's magnitude from JAX's,
  and on the critic JAX's step lies 8x further from that step than the
  port's does (ROADMAP §C). Set A's ``mu`` and ``nu`` are held as one
  vector, its distance from JAX's within 1e-5 of its norm plus four times
  the port's own float32 error, measured by a port step whose batch
  moments come from float64 (``train/optim.py::within_own_error``,
  ``models/common.py::float64_moments``). The gradient paths this option
  set adds (``big_fc`` and the attached big class means) are held per
  tensor where they are well-conditioned, in
  ``test_torch_train_options_dev.py``. In bfloat16
  the same makes single losses move by up to 11% in JAX's own bfloat16
  step, so set A's bfloat16 losses are held as one vector (its norm), as
  the updates are.

Set B's step and set A through the command line (one epoch, then a
resume) are in ``test_torch_train_options_b.py``, so that ``--dist
loadfile`` gives them another worker. Three jitted JAX train steps in all
(set A in float32 and bfloat16, set B).
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import contextlib

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.train import optim as joptim
from feature_intertwiner_tpu_torch.models import common
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.train.optim import (moment_slots, set_trainable,
                                                        within_own_error)
from feature_intertwiner_tpu_torch.train.step import LOSS_KEYS, create_train_state, train_step
from feature_intertwiner_tpu_torch.utils.convert_weights import (from_jax_params,
                                                                 from_jax_train_state)
from test_torch_bf16_slice import assert_within_jax_bf16_error
from test_torch_makeup_train import makeup_steps

SET_A = dict(
    model_kw=dict(dev_big_supervise=True, dev_big_feat_detach=False),
    opts=["TRAIN.OPTIM_METHOD", "adam", "TRAIN.BN_LEARN", "True", "DEV.BIG_SUPERVISE", "True",
          "DEV.BIG_FEAT_DETACH", "False", "DEV.BIG_FC_INIT", "coco_pretrain"])
SET_B = dict(
    model_kw=dict(dev_baseline=True, dev_dis_upsampler=True),
    opts=["TRAIN.OPTIM_METHOD", "rmsprop", "DEV.DIS_REG_LOSS", "True", "DEV.BASELINE", "True",
          "DEV.DIS_UPSAMPLER", "True"])
BN_STATS = ("running_mean", "running_var")
LR = 0.01               # the harness's learning rate


def _exact_stats(x, axes, dtype, axis_name=None, axis_index_groups=None, use_mean=True,
                 use_fast_variance=True, mask=None, force_float32_reductions=True):
    """flax's ``_compute_stats`` (float32, ``E[x²] - E[x]²`` clipped at 0)
    with ``E[x]`` and ``E[x²]`` the float32 roundings of their float64
    values; the gradient is flax's own."""
    x = x.astype(jnp.float32)
    axes = flax_norm._canonicalize_axes(x.ndim, axes)
    shape = jax.ShapeDtypeStruct(tuple(s for i, s in enumerate(x.shape) if i not in axes),
                                 jnp.float32)

    def moments(a):
        a = np.asarray(a, np.float64)
        return a.mean(axes).astype(np.float32), (a * a).mean(axes).astype(np.float32)

    m1, m2 = jax.pure_callback(moments, (shape, shape), jax.lax.stop_gradient(x))
    mu, mu2 = x.mean(axes), (x * x).mean(axes)
    mu = mu + jax.lax.stop_gradient(m1 - mu)
    mu2 = mu2 + jax.lax.stop_gradient(m2 - mu2)
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


@contextlib.contextmanager
def exact_flax_moments():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_norm, "_compute_stats", _exact_stats)
        yield


def further_port_step(step, context):
    """The harness's float32 port step again, from the same weights, batch,
    draws and proposals, inside ``context``: its TrainState."""
    model = InterNet(**step["model_kw"])
    model.load_state_dict(step["before"], strict=True)
    model.eval()
    model._propose = step["propose"]
    state = create_train_state(step["cfg"], model)
    set_trainable(model, step["layers"])
    with context():
        train_step(state, step["cfg"], {k: torch.from_numpy(v) for k, v in step["batch"].items()},
                   LR, 1.0, draws=step["draws"])
    return state


@pytest.fixture(scope="module")
def set_a():
    with exact_flax_moments():
        step = makeup_steps("set_a", (torch.bfloat16, torch.float32), **SET_A)
    step["port64"] = further_port_step(step, common.float64_moments)
    return step


def _max_rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def jax_optimizer_params(step, state):
    """The parameters after the step by the JAX package's optimizer
    (``make_optimizer``, jitted, first step) on the port's own gradients
    (as clipped), and its updates (RMSprop's first trace), in the port's
    layout: Adam and RMSprop are elementwise."""
    cfg = step["cfg"]
    jcfg = jax_build_config(opts=["TRAIN.OPTIM_METHOD", cfg.TRAIN.OPTIM_METHOD,
                                  "TRAIN.WEIGHT_DECAY", str(cfg.TRAIN.WEIGHT_DECAY),
                                  "TRAIN.MOMENTUM", str(cfg.TRAIN.MOMENTUM)])
    p0 = {n: step["before"][n].numpy() for n, _ in state.model.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in state.model.named_parameters()}
    tx = joptim.make_optimizer(jcfg, p0)

    @jax.jit
    def apply(p, g):
        updates, new = tx.update(g, tx.init(p), p)
        return jax.tree_util.tree_map(lambda a, u: a + -jnp.float32(LR) * u, p, updates), updates

    params, updates = apply(p0, grads)
    return ({n: torch.from_numpy(np.asarray(v)) for n, v in params.items()},
            {n: torch.from_numpy(np.asarray(v)) for n, v in updates.items()})


def check_step(step, optim_slots, own=None):
    """The float32 step against JAX's at the bounds of the module docstring;
    ``own``: the port's state after a step of float64 batch moments, whose
    distance from the port's sets the floor of the optimizer state's bound.
    Returns the port's metrics, state and the JAX step's converted
    state_dict."""
    (pm, state), (jm, js) = step["port"][torch.float32], step["jax"][torch.float32]
    assert pm["positive_rois"] > 0
    for k in LOSS_KEYS + ("meta_loss", "big_loss", "total_loss"):
        got, want = pm[k], jm[k]
        assert abs(got - want) <= 1e-4 * max(abs(want), 1e-6), (k, got, want)
    got_sd, want_sd = state.model.state_dict(), from_jax_params(js.params, js.batch_stats)
    assert got_sd.keys() == want_sd.keys()
    for k in [k for k in want_sd if k.endswith(BN_STATS)]:
        assert _max_rel(got_sd[k], want_sd[k]) <= 1e-4, (k, _max_rel(got_sd[k], want_sd[k]))
    np.testing.assert_allclose(state.buffer.numpy(), np.asarray(js.buffer), rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.buffer_cnt.numpy(), np.asarray(js.buffer_cnt), rtol=0,
                               atol=1e-4)
    ref, ref_trace = jax_optimizer_params(step, state)
    opt = state.optimizer
    for name, p in state.model.named_parameters():
        assert _max_rel(p.detach(), ref[name]) <= 1e-5, (name, _max_rel(p.detach(), ref[name]))
        if "trace" in optim_slots:        # RMSprop's trace is its update
            err = _max_rel(opt.state[p]["trace"], ref_trace[name])
            assert err <= 1e-5, ("trace", name, err)
    jopt = from_jax_train_state(js)["optim"]
    assert set(jopt) == set(optim_slots)
    if own is None:
        for name, p in state.model.named_parameters():
            for slot in ("mu", "nu"):
                got, want = opt.state[p][slot].double(), jopt[slot][name].double()
                if slot == "nu":               # a squared gradient: held as its root
                    got, want = got.sqrt(), want.sqrt()
                assert _max_rel(got, want) <= 1e-5, (slot, name, _max_rel(got, want))
    else:
        got = moment_slots(state.model, opt)
        want = {slot: jopt[slot] for slot in ("mu", "nu")}
        held, gap, floor, size = within_own_error(got, want,
                                                  moment_slots(own.model, own.optimizer), got)
        assert held, (gap, floor, size)
    if "count" in optim_slots:
        assert opt.param_groups[0]["count"] == jopt["count"] == 1
    return pm, state, want_sd


def test_set_a_step_matches_jax_in_float32(set_a):
    """Adam, BN learning, the big set supervised and attached: the critic's,
    big_fc's and the backbone's weights and every BN's statistics move as
    in JAX."""
    pm, state, _ = check_step(set_a, ("mu", "nu", "count"), own=set_a["port64"])
    assert pm["big_loss"] > 0 and pm["meta_loss"] > 0
    before, after = set_a["before"], state.model.state_dict()
    for k in ("dev_roi.big_fc_layer.weight", "dev_roi.feat_extract.0.weight",
              "fpn.C2.0.conv1.weight", "fpn.C1.1.running_mean",
              "dev_roi.feat_extract.4.running_var", "classifier.bn1.running_mean"):
        assert not torch.equal(after[k], before[k]), k
    assert all(m.training is False for m in state.model.modules())


def test_set_a_step_in_bf16_is_within_jax_bf16_error(set_a):
    step = set_a
    (pm, state), (pm32, state32) = step["port"][torch.bfloat16], step["port"][torch.float32]
    (jm16, js16), (jm32, js32) = step["jax"][torch.bfloat16], step["jax"][torch.float32]
    assert pm["positive_rois"] > 0 and pm["big_loss"] > 0
    keys = LOSS_KEYS + ("meta_loss", "big_loss", "total_loss")
    got, got32, j16, j32 = (np.array([m[k] for k in keys]) for m in (pm, pm32, jm16, jm32))
    norm = np.linalg.norm
    own, d = norm(j16 - j32), norm(got32 - j32)
    assert norm(got - j32) <= 2 * own + d and norm(got - j16) <= 2 * own + d, (got, j16, j32)
    before = step["before"]
    sds = (state.model.state_dict(), state32.model.state_dict(),
           from_jax_params(js16.params, js16.batch_stats),
           from_jax_params(js32.params, js32.batch_stats))
    updates = {k: [(sd[k].double() - p0.double()).numpy().ravel() for sd in sds]
               for k, p0 in before.items() if torch.is_floating_point(p0)}
    moved = {k: u for k, u in updates.items() if np.abs(u[3]).max() > 0}
    assert "dev_roi.big_fc_layer.weight" in moved and "fpn.C1.1.running_var" in moved
    u16, u32p, j16, j32 = (np.concatenate([u[i] for u in moved.values()]) for i in range(4))
    own, d = norm(j16 - j32), norm(u32p - j32)
    assert norm(u16 - j32) <= 1.5 * own + d, (norm(u16 - j32), own, d)
    assert norm(u16 - j16) <= 2.0 * own + d, (norm(u16 - j16), own, d)
    rel_port = np.array([norm(u[0] - u[3]) / norm(u[3]) for u in moved.values()])
    rel_jax = np.array([norm(u[2] - u[3]) / norm(u[3]) for u in moved.values()])
    assert rel_port.max() <= 2 * rel_jax.max(), (rel_port.max(), rel_jax.max())
    assert np.median(rel_port) <= 1.5 * np.median(rel_jax)
    for name, got, got32, a, b in (
            ("buffer", state.buffer, state32.buffer, js32.buffer, js16.buffer),
            ("buffer_cnt", state.buffer_cnt, state32.buffer_cnt, js32.buffer_cnt,
             js16.buffer_cnt)):
        assert_within_jax_bf16_error(name, got.numpy(), got32.numpy(), np.asarray(a),
                                     np.asarray(b))
    assert all(v.dtype in (torch.float32, torch.int64) for v in state.model.state_dict().values())
    assert all(t.dtype == torch.float32 for s in state.optimizer.state.values()
               for t in s.values())


@contextlib.contextmanager
def float64_layers():
    """Every convolution and dense layer of the port computed in float64
    and rounded to float32 at its output (its gradient likewise), and BN's
    batch moments from float64: a step run so measures how far the port's
    float32 step lies from its own arithmetic done exactly."""
    def conv2d(self, x):
        bias = None if self.bias is None else self.bias.double()
        return self._conv_forward(x.double(), self.weight.double(), bias).to(x.dtype)

    def conv_t(self, x):
        return torch.nn.functional.conv_transpose2d(
            x.double(), self.weight.double(), self.bias.double(), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation).to(x.dtype)

    def conv1d(self, x):
        return self._conv_forward(x.double(), self.weight.double(),
                                  self.bias.double()).to(x.dtype)

    def linear(self, x):
        return torch.nn.functional.linear(x.double(), self.weight.double(),
                                          self.bias.double()).to(x.dtype)

    with pytest.MonkeyPatch.context() as mp, common.float64_moments():
        for cls, fn in ((common.Conv2d, conv2d), (common.ConvTranspose2d, conv_t),
                        (common.Conv1d, conv1d), (common.Linear, linear)):
            mp.setattr(cls, "forward", fn)
        yield


def _norm(a, b):
    return float((a.double() - b.double()).norm())


if __name__ == "__main__":
    # the float32 gaps the module docstring works around: each step against
    # the jitted JAX step as it is
    for name, opts in (("set_a", SET_A), ("set_b", SET_B)):
        step = makeup_steps(name, **opts)
        (pm, state), (jm, js) = step["port"][torch.float32], step["jax"][torch.float32]
        want = from_jax_params(js.params, js.batch_stats)
        print(name, "losses, relative:", {k: "%.3g" % (abs(pm[k] - jm[k]) / max(abs(jm[k]), 1e-6))
                                          for k in LOSS_KEYS + ("big_loss", "meta_loss")})
        params = max((_max_rel(p.detach(), want[n]), n) for n, p in state.model.named_parameters())
        print(name, "parameters against JAX's, of their magnitude: %.3g (%s)" % params)
        ref = jax_optimizer_params(step, state)[0]
        print(name, "against the JAX optimizer on the port's gradients: %.3g (%s)" % max(
            (_max_rel(p.detach(), ref[n]), n) for n, p in state.model.named_parameters()))
        jopt = from_jax_train_state(js)["optim"]
        print(name, "mu against JAX's: %.3g (%s)" % max(
            (_max_rel(state.optimizer.state[p]["mu"], jopt["mu"][n]), n)
            for n, p in state.model.named_parameters()))
        if name == "set_a":
            own = further_port_step(step, common.float64_moments)
            q = dict(own.model.named_parameters())
            print(name, "mu, the port against itself with float64 batch moments: %.3g (%s)" % max(
                (_max_rel(state.optimizer.state[p]["mu"], own.optimizer.state[q[n]]["mu"]), n)
                for n, p in state.model.named_parameters()))
            stats = max((_max_rel(state.model.state_dict()[k], want[k]), k) for k in want
                        if k.endswith(BN_STATS))
            print(name, "BN statistics against JAX's: %.3g (%s)" % stats)

    # set A per tensor, JAX's batch moments from float64 as in the test: each
    # tensor's distance from JAX's against 1e-5 of its norm plus four times
    # its own float32 error, that error measured by float64 batch moments and
    # by float64 layers (:func:`float64_layers`)
    with exact_flax_moments():
        step = makeup_steps("set_a", **SET_A)
    state, js = step["port"][torch.float32][1], step["jax"][torch.float32][1]
    got, want = moment_slots(state.model, state.optimizer), from_jax_train_state(js)["optim"]
    own = {}
    for key, context in (("moments", common.float64_moments), ("layers", float64_layers)):
        st = further_port_step(step, context)
        own[key] = moment_slots(st.model, st.optimizer)
    for key in own:
        rows = sorted(((_norm(got[s][n], want[s][n])
                        / (1e-5 * float(want[s][n].double().norm())
                           + 4 * _norm(got[s][n], own[key][s][n])), s, n)
                       for s in ("mu", "nu") for n in got[s]), reverse=True)
        print(f"set_a per tensor, floor from float64 {key}: {sum(r[0] > 1 for r in rows)} of "
              f"{len(rows)} tensors beyond; worst %.3g x its bound (%s %s)" % rows[0])
    exact = own["layers"]
    worst = max((_max_rel(exact["mu"][n], want["mu"][n]), n) for n in want["mu"])
    print("set_a mu, the port's float64-layer step against JAX's: %.3g of the tensor's magnitude "
          "(%s)" % worst)
    for n in ("dev_roi.feat_extract.6.weight", "dev_roi.feat_extract.3.weight"):
        print(f"set_a mu {n}: |port - JAX| %.3g, |port - float64 layers| %.3g, "
              "|JAX - float64 layers| %.3g, |JAX| %.3g" % (
                  _norm(got["mu"][n], want["mu"][n]), _norm(got["mu"][n], exact["mu"][n]),
                  _norm(want["mu"][n], exact["mu"][n]), float(want["mu"][n].double().norm())))

    # the flagship's SGD step (no option): its gradients (SGD's trace) per
    # tensor against JAX's, and each against the port's float64-layer step
    step = makeup_steps("flagship", model_kw={}, opts=[])
    state, js = step["port"][torch.float32][1], step["jax"][torch.float32][1]
    exact = further_port_step(step, float64_layers)
    q = dict(exact.model.named_parameters())
    want = from_jax_train_state(js)["optim"]["momentum_buffer"]
    rows = sorted(((_max_rel(state.optimizer.state[p]["momentum_buffer"], want[n]),
                    _max_rel(state.optimizer.state[p]["momentum_buffer"],
                             exact.optimizer.state[q[n]]["momentum_buffer"]),
                    _max_rel(want[n], exact.optimizer.state[q[n]]["momentum_buffer"]), n)
                   for n, p in state.model.named_parameters()), reverse=True)
    print("flagship SGD trace, of the tensor's magnitude: port against JAX %.3g, port against "
          "its float64-layer step %.3g, JAX against that step %.3g (%s)" % rows[0])
