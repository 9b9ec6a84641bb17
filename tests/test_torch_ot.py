"""The OT meta loss and the FPN OT loss of the port against the JAX package,
on the CPU, at small shapes from seeded numpy inputs.

- ``ops/sinkhorn.py``: the cost matrix (cosine and L2), ``sinkhorn_ot``
  with uniform and with masked marginals, ``sinkhorn_divergence`` debiased
  and not, and the gradients of each against ``jax.grad``, within 1e-5 of
  the largest gradient. The debiased divergence ``2 OT(x, y) - OT(x, x) -
  OT(y, y)`` can be far smaller than its terms, so each term is held within
  1e-5 relative and the divergence within 1e-5 of its largest term.
- flax's ``ConvTranspose(3, stride 2, 'SAME')`` (the generator of the FPN
  OT, and of ``DEV.UPSAMPLE_FAC`` 2) against ``SameConvTranspose2d``
  within 1e-5; torch's usual ``padding=1, output_padding=1`` is a pixel off.
- ``OptTrans1D`` (``conv``, ``fc``) and ``OptTrans2D`` against their flax
  twins with the same weights (``from_jax_params``): in float32 the
  critic's embeddings within 1e-4 relative and the loss within 1e-4 of its
  largest term; in bfloat16 the loss and the embeddings within ``2 e +
  1e-3`` of the largest value, ``e`` JAX's own bfloat16 error (as
  ``test_torch_bf16.py``).
- The init laws of the OT layers against flax's draws, and the strict
  round trip of their weights through the JAX reference-name converter,
  with the stage and weight-decay sets.
- Where the port differs on purpose: the gradient at a zero row, which is
  NaN in JAX (``jnp.linalg.norm`` at 0) and zero here for a row of weight 0.

The train steps and the command line are in ``test_torch_ot_train.py``.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import math
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from feature_intertwiner_tpu.models.common import deconv as jax_deconv
from feature_intertwiner_tpu.models.ot import OptTrans1D as JOptTrans1D
from feature_intertwiner_tpu.models.ot import OptTrans2D as JOptTrans2D
from feature_intertwiner_tpu.ops import sinkhorn as jsk
from feature_intertwiner_tpu.train import optim as joptim
from feature_intertwiner_tpu.utils.convert_weights import convert_reference_state_dict
from feature_intertwiner_tpu_torch.models.common import (TRUNC_STD, ConvTranspose2d,
                                                         SameConvTranspose2d, init_weights)
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.ot import OptTrans1D, OptTrans2D
from feature_intertwiner_tpu_torch.ops import sinkhorn as sk
from feature_intertwiner_tpu_torch.train import optim
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_bf16 import assert_bf16_module
from test_torch_model import KEY, TINY, init_pair

T = torch.from_numpy
BF16 = jnp.bfloat16


def _sets(seed, b=3, n=6, d=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, d).astype(np.float32), rng.randn(b, n, d).astype(np.float32))


def _masked_marginals(seed, b=3, n=6):
    """Row weights ``mask / count``, two rows of each sample masked out."""
    mask = np.ones((b, n), np.float32)
    rng = np.random.RandomState(seed)
    for i in range(b):
        mask[i, rng.choice(n, 2, replace=False)] = 0.0
    return mask / mask.sum(1, keepdims=True)


def _grad_port(fn, *arrays):
    ts = [T(a.copy()).requires_grad_() for a in arrays]
    fn(*ts).sum().backward()
    return [t.grad.numpy() for t in ts]


def assert_grads(got, want, tol=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.isfinite(w).all()
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(g - w).max() <= tol * scale, (np.abs(g - w).max(), scale)


def assert_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (got, want)


# --- ops/sinkhorn.py ----------------------------------------------------------------------
@pytest.mark.parametrize("form", ["cosine", "l2"])
def test_cost_matrix_matches_jax(form):
    x, y = _sets(0)
    want = jax.vmap(lambda a, b: jsk.cost_matrix(a, b, form))(x, y)
    assert_rel(sk.cost_matrix(T(x), T(y), form).numpy(), want, 1e-5)
    jgrad = jax.grad(lambda a, b: jax.vmap(lambda p, q: jsk.cost_matrix(p, q, form))(a, b)
                     .sum(), argnums=(0, 1))(x, y)
    assert_grads(_grad_port(lambda a, b: sk.cost_matrix(a, b, form), x, y), jgrad)


@pytest.mark.parametrize("masked", [False, True], ids=["uniform", "masked"])
@pytest.mark.parametrize("form", ["cosine", "l2"])
def test_sinkhorn_ot_matches_jax(form, masked):
    x, y = _sets(1)
    w = _masked_marginals(2) if masked else None

    def jax_ot(a, b):
        if w is None:
            return jax.vmap(lambda p, q: jsk.sinkhorn_ot(p, q, cost_form=form))(a, b)
        return jax.vmap(lambda p, q, r: jsk.sinkhorn_ot(p, q, cost_form=form, weights=r))(
            a, b, w)

    def port_ot(a, b):
        return sk.sinkhorn_ot(a, b, cost_form=form, weights=None if w is None else T(w))

    assert_rel(port_ot(T(x), T(y)).numpy(), jax_ot(x, y), 1e-5)
    jgrad = jax.grad(lambda a, b: jax_ot(a, b).sum(), argnums=(0, 1))(x, y)
    assert_grads(_grad_port(port_ot, x, y), jgrad)


@pytest.mark.parametrize("debiased", [True, False], ids=["debiased", "biased"])
def test_sinkhorn_divergence_matches_jax(debiased):
    """The terms within 1e-5 relative, the divergence within 1e-5 of its
    largest term, the gradients within 1e-5 of the largest."""
    x, y = _sets(3, b=4, n=8, d=6)
    terms = [(x, y), (x, x), (y, y)]
    for a, b in terms:
        want = jax.vmap(lambda p, q: jsk.sinkhorn_ot(p, q))(a, b)
        assert_rel(sk.sinkhorn_ot(T(a), T(b)).numpy(), want, 1e-5)
    largest = max(float(np.abs(jax.vmap(lambda p, q: jsk.sinkhorn_ot(p, q))(a, b)).max())
                  for a, b in terms)
    got = sk.sinkhorn_divergence(T(x), T(y), debiased=debiased).numpy()
    want = np.asarray(jsk.sinkhorn_divergence(x, y, debiased=debiased))
    assert np.abs(got - want).max() <= 1e-5 * largest, (got, want, largest)
    jgrad = jax.grad(lambda a, b: jsk.sinkhorn_divergence(a, b, debiased=debiased).sum(),
                     argnums=(0, 1))(x, y)
    assert_grads(_grad_port(lambda a, b: sk.sinkhorn_divergence(a, b, debiased=debiased),
                            x, y), jgrad)


def test_zero_row_gets_no_gradient_where_jax_gives_nan():
    """A zero row (a ReLU critic's or an absent class's output) has no
    direction: ``jnp.linalg.norm``'s gradient there is NaN, and a row
    weight of 0 does not remove it; the port's gradient is 0."""
    x, y = _sets(4, b=2, n=5, d=1)
    x[:, 0] = 0.0
    w = np.ones((2,), np.float32)
    w[1] = 0.0
    jgrad = jax.grad(lambda a: (jsk.sinkhorn_divergence(a, y) * w).sum())(x)
    assert np.isnan(np.asarray(jgrad)[1]).any()
    got = _grad_port(lambda a: sk.sinkhorn_divergence(a, T(y)) * T(w), x)[0]
    assert np.isfinite(got).all() and (got[1] == 0).all()


# --- the 3x3 stride-2 SAME transposed conv ---------------------------------------------------
@pytest.mark.parametrize("stride", [2, 1])
def test_same_transposed_conv_matches_flax(stride):
    x = np.random.RandomState(5).randn(2, 6, 7, 8).astype(np.float32)
    jm = jax_deconv(4, 3, strides=stride, name="g_deconv")
    pm = SameConvTranspose2d(8, 4, 3, stride)
    v = init_pair(jm, pm, (jnp.asarray(x),), lambda t: {"fpn": {"p4_ot": {"g_deconv": t}}},
                  "fpn.p4_ot.G_net.0.")
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 6 * stride, 7 * stride, 4)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if stride == 2:
        # the usual torch padding for a 2x "same" transposed conv pads the
        # dilated input 1 before and 2 after, where flax pads 2 and 1
        usual = ConvTranspose2d(8, 4, 3, 2, padding=1, output_padding=1)
        usual.load_state_dict(pm.state_dict())
        with torch.no_grad():
            off = usual(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert off.shape == want.shape and np.abs(off - want).max() > 0.1 * np.abs(want).max()


# --- OptTrans1D and OptTrans2D against flax -------------------------------------------------
def _captured(intermediates, name):
    """The outputs a flax submodule gave, in call order."""
    return list(intermediates[name]["__call__"])


def _one_dim_case(form):
    rng = np.random.RandomState({"conv": 6, "fc": 7}[form])
    n, ch = 5, 64
    x = np.abs(rng.randn(n, ch)).astype(np.float32)
    y = np.abs(rng.randn(n, ch)).astype(np.float32)
    w = np.array([1, 1, 0, 1, 1], np.float32)
    jm = JOptTrans1D(ch, one_dim_form=form)
    pm = OptTrans1D(ch, form)
    v = init_pair(jm, pm, (jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)),
                  lambda t: {"ot_loss": t}, "ot_loss.", seed=8)
    return x, y, w, jm, pm, v


def _port_embeddings_1d(pm, x, y):
    return pm.embed(pm.G_net(x[:, :, None])), pm.embed(y[:, :, None])


def _jax_terms(cx, cy):
    return [np.asarray(jax.vmap(lambda p, q: jsk.sinkhorn_ot(p, q))(a, b))
            for a, b in ((cx, cy), (cx, cx), (cy, cy))]


@pytest.mark.parametrize("form", ["conv", "fc"])
def test_opt_trans_1d_matches_flax(form):
    x, y, w, jm, pm, v = _one_dim_case(form)
    want, state = jm.apply(v, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                           capture_intermediates=True)
    crit = _captured(state["intermediates"], f"critic_{form}")
    jcx, jcy = (np.asarray(c).transpose(0, 2, 1).astype(np.float32) for c in crit)
    if form == "conv":
        jcx, jcy = np.maximum(jcx, 0), np.maximum(jcy, 0)   # the ReLU after the conv
    with torch.no_grad():
        cx, cy = _port_embeddings_1d(pm, T(x), T(y))
        got = pm(T(x), T(y), T(w))
    assert_rel(cx.numpy(), jcx, 1e-4)
    assert_rel(cy.numpy(), jcy, 1e-4)
    largest = max(np.abs(t).max() for t in _jax_terms(jcx, jcy))
    assert abs(float(got) - float(want)) <= 1e-4 * largest, (float(got), float(want), largest)


def _two_dim_case():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 4, 16).astype(np.float32)
    y = rng.randn(2, 8, 8, 16).astype(np.float32)
    jm = JOptTrans2D(16, upsample=True)
    pm = OptTrans2D(16)
    v = init_pair(jm, pm, (jnp.asarray(x), jnp.asarray(y)),
                  lambda t: {"fpn": {"p4_ot": t}}, "fpn.p4_ot.", seed=10)
    return x, y, jm, pm, v


def test_opt_trans_2d_matches_flax():
    x, y, jm, pm, v = _two_dim_case()
    want, state = jm.apply(v, jnp.asarray(x), jnp.asarray(y), capture_intermediates=True)
    inter = state["intermediates"]
    bn2 = _captured(inter, "critic_bn2")
    jcx, jcy = (np.maximum(np.asarray(c), 0).reshape(2, -1, 4).transpose(0, 2, 1) for c in bn2)
    xt, yt = T(x).permute(0, 3, 1, 2), T(y).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = pm(xt, yt).numpy()
        cx = pm.critic(pm.G_net(xt)).reshape(2, 4, -1).numpy()
        cy = pm.critic(yt).reshape(2, 4, -1).numpy()
    assert_rel(cx, jcx, 1e-4)
    assert_rel(cy, jcy, 1e-4)
    largest = max(np.abs(t).max() for t in _jax_terms(jcx, jcy))
    assert got.shape == (2,)
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * largest, (got, want, largest)


@pytest.mark.parametrize("name", ["1d_conv", "1d_fc", "2d"])
def test_opt_trans_in_bf16_matches_flax(name):
    """The module computing in bfloat16 (its inputs cast, the embeddings
    cast to float32 before the Sinkhorn loop, as flax's ``dtype``): the
    critic's embeddings and the loss within ``2 e + 1e-3`` of the largest
    value, ``e`` JAX's own bfloat16 error."""
    if name == "2d":
        x, y, jm, pm, v = _two_dim_case()
        args = (jnp.asarray(x), jnp.asarray(y))
        jm16 = JOptTrans2D(16, upsample=True, dtype=BF16)
        critic = "critic_bn2"
        with torch.no_grad():
            xt, yt = (T(a).bfloat16().permute(0, 3, 1, 2) for a in (x, y))
            got = pm(xt, yt)
            emb = [pm.critic[:5](pm.G_net(xt)), pm.critic[:5](yt)]     # before the last ReLU
    else:
        form = name[3:]
        x, y, w, jm, pm, v = _one_dim_case(form)
        args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
        jm16 = JOptTrans1D(64, one_dim_form=form, dtype=BF16)
        critic = f"critic_{form}"
        with torch.no_grad():
            xt, yt = T(x).bfloat16(), T(y).bfloat16()
            got = pm(xt, yt, T(w))
            xg = pm.G_net(xt[:, :, None])
            emb = [pm.critic[0](xg), pm.critic[0](yt[:, :, None])] \
                if form == "conv" else [pm.critic(xg[:, :, 0]), pm.critic(yt)]
    j32, s32 = jm.apply(v, *args, capture_intermediates=True)
    j16, s16 = jm16.apply(v, *args, capture_intermediates=True)
    for g, a, b in zip(emb, _captured(s32["intermediates"], critic),
                       _captured(s16["intermediates"], critic)):
        if name == "2d":
            g = g.permute(0, 2, 3, 1)
        elif name == "1d_conv":
            g = g.permute(0, 2, 1)
        else:
            g = g[:, None, :]
        assert_bf16_module(g, a, b)
    got, j32, j16 = got.numpy(), np.asarray(j32), np.asarray(j16)
    bound = 2 * np.abs(j16 - j32).max() + 1e-3 * np.abs(j32).max()
    for ref in (j32, j16):
        assert np.abs(got - ref).max() <= bound, (got, j32, j16)
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# --- init laws, weights and stage sets ------------------------------------------------------
def _moments(w):
    w = np.asarray(w, np.float64).ravel()
    var = (w ** 2).mean()
    return var, (w ** 4).mean() / var ** 2


def test_ot_layers_draw_as_flax_does():
    """Conv1d ``g_conv``/``critic_conv`` Xavier-uniform (the fourth moment
    of a uniform, 1.8, no draw past the bound), ``critic_fc`` N(0, 0.01),
    the FPN OT's transposed conv a normal cut at two standard deviations and
    its convs Xavier-uniform, zero biases; each variance as flax's own draw
    of the same shape gives it."""
    one, fc, two = OptTrans1D(1024, "conv"), OptTrans1D(1024, "fc"), OptTrans2D(256)
    for m in (one, fc, two):
        init_weights(m, torch.Generator().manual_seed(0))
    xavier_u, xavier_n = fnn.initializers.xavier_uniform(), fnn.initializers.xavier_normal()
    for w, flax_shape in ((one.G_net[0].weight, (3, 1024, 1024)),
                          (one.critic[0].weight, (3, 1024, 256)),
                          (two.critic[0].weight, (3, 3, 256, 128)),
                          (two.critic[3].weight, (3, 3, 128, 64))):
        w = w.detach().numpy()
        fans = (w.shape[0] + w.shape[1]) * np.prod(w.shape[2:])
        var, kurt = _moments(w)
        jvar, jkurt = _moments(xavier_u(KEY, flax_shape))
        for v_, k_ in ((var, kurt), (jvar, jkurt)):
            assert abs(v_ / (2.0 / fans) - 1) < 0.02 and abs(k_ - 1.8) < 0.03
        assert np.abs(w).max() <= math.sqrt(6.0 / fans)
    dw = two.G_net[0].weight.detach().numpy()
    fans = (256 + 256) * 9
    var, kurt = _moments(dw)
    jvar, jkurt = _moments(xavier_n(KEY, (3, 3, 256, 256)))
    for v_, k_ in ((var, kurt), (jvar, jkurt)):
        assert abs(v_ / (2.0 / fans) - 1) < 0.01 and abs(k_ - 2.3786) < 0.03
    assert np.abs(dw).max() <= 2 * math.sqrt(2.0 / fans) / TRUNC_STD * (1 + 1e-6)
    fw = fc.critic.weight.detach().numpy()
    assert abs(fw.std() / 0.01 - 1) < 0.02 and abs(fw.mean()) < 1e-3
    for m in (one, fc, two):
        for layer in m.modules():
            if isinstance(layer, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                  torch.nn.Linear)):
                assert not layer.bias.detach().any()


def _flat(tree, prefix=()):
    out = {}
    for k, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flat(val, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(val)
    return out


def _random_tree(tree, rng):
    """Numpy random values in the shapes of a tree of shapes."""
    return {k: _random_tree(v, rng) if isinstance(v, Mapping)
            else rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}


@pytest.fixture(scope="module", params=["conv", "fc"])
def ot_models(request):
    """The parameter and BN statistic trees of a tiny JAX InterNet with the
    OT meta loss and the FPN OT (shapes from ``jax.eval_shape``, values
    random), and the port model loaded from them."""
    from test_torch_model import JInterNet

    form = request.param
    kw = dict(post_nms_train=64, rois_per_image=24, dev_loss_choice="ot")
    jm = JInterNet(**TINY, **kw, dev_ot_one_dim_form=form, fpn_ot_loss=True)
    zeros = {"gt_class_ids": jnp.zeros((1, 6), jnp.int32), "gt_boxes": jnp.zeros((1, 6, 4)),
             "gt_masks": jnp.zeros((1, 6, 14, 14))}
    shapes = jax.eval_shape(lambda: jm.init({"params": KEY, "sampling": KEY},
                                            jnp.zeros((1, 128, 128, 3)), mode="train", **zeros))
    rng = np.random.RandomState(11)
    v = {"params": _random_tree(shapes["params"], rng),
         "batch_stats": _random_tree(shapes["batch_stats"], rng)}
    pm = InterNet(**TINY, **kw, dev_ot_one_dim_form=form, fpn_ot_loss=True)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    return form, v, pm


def test_ot_weights_round_trip_through_reference_names(ot_models):
    """``from_jax_params`` fills every OT parameter and BN statistic, and the
    JAX converter of reference checkpoints (strict) reads the port's
    ``state_dict`` back into the same trees."""
    form, v, pm = ot_models
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    assert any(k.startswith("ot_loss.critic") for k in sd)
    assert {f"fpn.p{lvl}_ot.G_net.0.weight" for lvl in (2, 3, 4)} <= sd.keys()
    params, stats = convert_reference_state_dict(sd, arch="resnet50", upsample_fac=1.0,
                                                 strict=True)
    for got, want in ((_flat(params), _flat(v["params"])),
                      (_flat(stats), _flat(v["batch_stats"]))):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))


@pytest.mark.parametrize("layers", ["heads", "4+", "all"])
def test_ot_stage_and_decay_sets_match_jax(ot_models, layers):
    """``ot_loss/*`` and ``fpn/p*_ot/*`` train in every stage; their BN
    parameters take no weight decay; name for name as the JAX masks."""
    _, v, pm = ot_models
    paths = optim.flax_paths(pm)
    flat = {"/".join(k): val for k, val in _flat(v["params"]).items()}
    assert sorted(paths.values()) == sorted(flat)
    want = {"/".join(p) for p, m in _flat(joptim.trainable_mask(v["params"], layers)).items()
            if m}
    got = {paths[n] for n in optim.trainable_names(pm, layers)}
    assert got == want
    assert {p for p in flat if "_ot/" in p or p.startswith("ot_loss/")} <= got
    decay = {"/".join(p) for p, m in _flat(joptim.bn_mask(v["params"])).items() if m}
    assert {paths[n] for n in optim.decay_names(pm)} == decay

