"""The pieces of the training options of ``ROADMAP.md`` A5, the port against
the JAX package on the CPU, at tiny sizes:

- Adam and centred RMSprop (``train/optim.py::OptaxChain``) against the
  JAX ``make_optimizer`` chains with ``freeze_opt_state``, over 60 steps
  whose trainable set grows from 'heads' to 'all' after 20: parameters and
  ``mu``/``nu``/trace within 1e-6 of each tensor's largest magnitude, the
  same step count. RMSprop also under a constant gradient (no decay), where
  eps inside the square root matters (JAX ``test_train_step.py``);
- BN learning batch statistics (``models/common.py::BatchNorm2d`` in
  ``bn_learning``) against flax ``BN(train_bn=True)``, on a 2×2 map at
  batch 2 and on a wide map, at both BN sites' epsilon and momentum: in
  float32 the output and the input's gradient within 1e-5 relative, the
  running mean and variance within 1e-6 relative; in bfloat16 within twice
  JAX's own bfloat16 error;
- the weight-decay sets of SGD (with and without ``TRAIN.BN_LEARN``), Adam
  and RMSprop against the JAX masks;
- ``big_fc`` through ``from_jax_params`` and back through the JAX
  ``convert_reference_state_dict(strict=True)``; its stage sets;
- ``DEV.BIG_FC_INIT coco_pretrain`` through ``Trainer.resume``, and the
  shape-mismatch skip of the cross-name copy;
- a checkpoint with Adam's state and BN statistics learnt: a run restored
  from it takes the next step bit for bit as one that never stopped;
- the big-set crop's gradient, ``crop_and_resize_fused(...,
  positions="xla")`` (K4 forward, K3 backward in its ``xla`` mode, plain
  versions here), against ``jax.grad`` of the jitted JAX
  ``crop_and_resize`` within 1e-5 of its largest value, with boxes that end
  at exactly 1.0 at H = 32, 64 and 256 and crop 14; the backward's sample
  positions (``tap_rows``, ``bwd_work_plan``) equal to
  ``_single_level_positions(..., "xla")`` bit for bit.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models.common import BN as JBN
from feature_intertwiner_tpu.ops import roi_align as jroi
from feature_intertwiner_tpu.train import optim as joptim
from feature_intertwiner_tpu.train.step import freeze_opt_state
from feature_intertwiner_tpu.utils.convert_weights import convert_reference_state_dict
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.models.common import BatchNorm2d, bn_learning
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.ops import roi_align as roi_ops
from feature_intertwiner_tpu_torch.train import checkpoint as ckpt
from feature_intertwiner_tpu_torch.train import optim, workflow
from feature_intertwiner_tpu_torch.train.step import TrainState, init_buffer
from feature_intertwiner_tpu_torch.utils.convert_weights import (apply_cross_name_init,
                                                                 from_jax_params)
from test_torch_bf16 import f32
from test_torch_model import KEY, TINY, JInterNet
from test_torch_ot import _flat, _random_tree

T = torch.from_numpy


# --- Adam and RMSprop against optax ------------------------------------------------------
# a parameter tree with a stage regex's worth of paths: 'heads' trains fpn/ and
# mask/ (a BN scale among them), 'all' the backbone too
SHAPES = {"backbone": {"c2": {"block0": {"conv1": {"kernel": (3, 3, 4, 8)},
                                         "bn1": {"BatchNorm_0": {"scale": (8,)}}}}},
          "fpn": {"p2_out": {"kernel": (3, 3, 8, 8), "bias": (8,)}},
          "mask": {"bn1": {"BatchNorm_0": {"scale": (8,), "bias": (8,)}}}}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


@pytest.mark.parametrize("method, constant, wd", [
    ("adam", False, 1e-4), ("rmsprop", False, 1e-4), ("rmsprop", True, 0.0)])
def test_adaptive_optimizers_match_optax_across_a_stage_change(method, constant, wd):
    rng = np.random.RandomState(3)
    params = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    opts = ["TRAIN.OPTIM_METHOD", method, "TRAIN.WEIGHT_DECAY", str(wd)]
    jcfg, cfg = jax_build_config(opts=opts), build_config(opts=opts)
    tx = joptim.make_optimizer(jcfg, params)
    masks = {s: joptim.trainable_mask(params, s) for s in ("heads", "all")}

    @functools.partial(jax.jit, static_argnums=3)
    def jax_step(p, st, g, stage):
        # as the JAX train step: masked gradients, the chain, frozen state
        # kept, -lr on the trainable updates
        mask = masks[stage]
        g = jax.tree_util.tree_map(lambda a, m: jnp.where(m, a, 0.0), g, mask)
        up, new = tx.update(g, st, p)
        new = freeze_opt_state(new, st, mask)
        up = jax.tree_util.tree_map(lambda u, m: jnp.where(m, -jnp.float32(1e-3) * u, 0.0),
                                    up, mask)
        return optax.apply_updates(p, up), new

    flat = {"/".join(k): v for k, v in _flat(params).items()}
    port = {path: torch.nn.Parameter(T(v.copy())) for path, v in flat.items()}
    opt = optim.OptaxChain(list(port.values()), method, cfg.TRAIN.WEIGHT_DECAY,
                           cfg.TRAIN.MOMENTUM)
    jp, st = params, tx.init(params)
    const = _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
    for i in range(60):
        stage = "heads" if i < 20 else "all"
        g = const if constant else _tree(SHAPES, lambda s: rng.randn(*s).astype(np.float32))
        jp, st = jax_step(jp, st, g, stage)
        gflat = {"/".join(k): v for k, v in _flat(g).items()}
        trained = {"/".join(k) for k, m in _flat(masks[stage]).items() if m}
        for path, p in port.items():
            p.grad = T(gflat[path].copy()) if path in trained else None
        opt.param_groups[0]["lr"] = 1e-3
        opt.step()

    def near(got, want, what):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-6, (what, err)

    slots = {"mu": st[1].mu, "nu": st[1].nu}
    if method == "rmsprop":
        slots["trace"] = st[2].trace
    for path, p in port.items():
        key = tuple(path.split("/"))
        near(p, _flat(jp)[key], path)
        for slot, tree in slots.items():
            near(opt.state[p][slot], _flat(tree)[key], f"{slot} {path}")
    # the frozen backbone kept its first 20 steps' zero moments
    if method == "adam":
        assert opt.param_groups[0]["count"] == int(st[1].count) == 60


# --- BN learning batch statistics against flax --------------------------------------------
def _bn_case(shape, site, seed):
    """A map [B, H, W, C] with per-channel offsets, BN parameters and
    statistics, a cotangent; the flax BN of the site (epsilon, momentum)."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * rng.uniform(0.5, 2.0, c) + rng.randn(c)).astype(np.float32)
    v = {"params": {"BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                    "bias": (rng.randn(c) * 0.2).astype(np.float32)}},
         "batch_stats": {"BatchNorm_0": {"mean": (rng.randn(c) * 0.2).astype(np.float32),
                                         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}}
    eps, momentum = site
    return x, v, rng.randn(*shape).astype(np.float32), JBN(epsilon=eps, momentum=momentum)


def _jax_bn(jm, v, x, gy, dtype):
    """flax BN(train_bn=True) in ``dtype``: output, input gradient, the new
    running statistics."""
    jm = jm.clone(dtype=dtype)

    def f(x):
        y, mut = jm.apply(v, x, True, mutable=["batch_stats"])
        return jnp.vdot(y.astype(jnp.float32), gy), (y, mut["batch_stats"]["BatchNorm_0"])

    (_, (y, st)), gx = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x, dtype))
    return f32(y), f32(gx), np.asarray(st["mean"]), np.asarray(st["var"])


def _port_bn(v, x, gy, site, dtype):
    eps, momentum = site
    bn = BatchNorm2d(x.shape[-1], eps=eps, momentum=1.0 - momentum).eval()
    bn.load_state_dict(_bn_state(v), strict=True)
    xt = T(x).to(dtype).permute(0, 3, 1, 2).requires_grad_()
    with bn_learning(bn):
        y = bn(xt)
    assert not bn.training and y.dtype == dtype
    (y.float() * T(gy).permute(0, 3, 1, 2)).sum().backward()
    return (y.detach().float().permute(0, 2, 3, 1).numpy(),
            xt.grad.float().permute(0, 2, 3, 1).numpy(),
            bn.running_mean.numpy(), bn.running_var.numpy())


def _bn_state(v):
    p, s = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    return {"weight": T(p["scale"]), "bias": T(p["bias"]), "running_mean": T(s["mean"]),
            "running_var": T(s["var"]), "num_batches_tracked": torch.tensor(0)}


BN_CASES = {"2x2_batch2": (2, 2, 2, 16), "wide": (4, 16, 16, 64)}
BN_SITES = {"backbone": (1e-3, 0.99), "dev": (1e-5, 0.9)}


@pytest.mark.parametrize("case", BN_CASES)
@pytest.mark.parametrize("site", BN_SITES)
def test_bn_learning_matches_flax_in_float32(case, site):
    x, v, gy, jm = _bn_case(BN_CASES[case], BN_SITES[site], seed=len(case) + len(site))
    want = _jax_bn(jm, v, x, gy, jnp.float32)
    got = _port_bn(v, x, gy, BN_SITES[site], torch.float32)
    for name, a, b, tol in zip(("y", "grad x", "mean", "var"), got, want,
                               (1e-5, 1e-5, 1e-6, 1e-6)):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (name, err)
    # the biased variance moves the running one, not torch's n/(n-1) one
    n = x.size // x.shape[-1]
    if n < 100:
        m = 1.0 - BN_SITES[site][1]
        var = x.reshape(-1, x.shape[-1]).astype(np.float64).var(0)
        unbiased = (1 - m) * v["batch_stats"]["BatchNorm_0"]["var"] + m * var * n / (n - 1)
        assert np.abs(got[3] - unbiased).max() > 100 * np.abs(got[3] - want[3]).max()


@pytest.mark.parametrize("case", BN_CASES)
def test_bn_learning_matches_flax_in_bf16(case):
    site = BN_SITES["backbone"]
    x, v, gy, jm = _bn_case(BN_CASES[case], site, seed=7)
    x = f32(jnp.asarray(x, jnp.bfloat16))                 # the same bf16 input to both
    j32, j16 = _jax_bn(jm, v, x, gy, jnp.float32), _jax_bn(jm, v, x, gy, jnp.bfloat16)
    got = _port_bn(v, x, gy, site, torch.bfloat16)
    for name, a, b32, b16 in zip(("y", "grad x", "mean", "var"), got, j32, j16):
        own = np.abs(b16 - b32).max()
        assert np.abs(a - b32).max() <= 2 * own + 1e-6 * np.abs(b32).max(), (name, own)


# --- the decay and stage sets ------------------------------------------------------------
@pytest.fixture(scope="module")
def big_models():
    """Tiny JAX and port InterNets with ``big_fc`` (``DEV.BIG_SUPERVISE``):
    random trees in the flax shapes, the port loaded from them."""
    kw = dict(post_nms_train=64, rois_per_image=24, dev_loss_choice="l2",
              dev_big_supervise=True)
    jm = JInterNet(**TINY, **kw)
    zeros = {"gt_class_ids": jnp.zeros((1, 6), jnp.int32), "gt_boxes": jnp.zeros((1, 6, 4)),
             "gt_masks": jnp.zeros((1, 6, 14, 14))}
    shapes = jax.eval_shape(lambda: jm.init({"params": KEY, "sampling": KEY},
                                            jnp.zeros((1, 128, 128, 3)), mode="train", **zeros))
    rng = np.random.RandomState(12)
    v = {"params": _random_tree(shapes["params"], rng),
         "batch_stats": _random_tree(shapes["batch_stats"], rng)}
    pm = InterNet(**TINY, **kw)
    pm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    return v, pm


def test_big_fc_weights_round_trip_through_reference_names(big_models):
    v, pm = big_models
    assert v["params"]["dev"]["big_fc"]["kernel"].shape == (1024, 8)
    np.testing.assert_array_equal(pm.dev_roi.big_fc_layer.weight.detach().numpy(),
                                  v["params"]["dev"]["big_fc"]["kernel"].T)
    sd = {k: t.numpy() for k, t in pm.state_dict().items()}
    params, stats = convert_reference_state_dict(sd, arch="resnet50", upsample_fac=1.0,
                                                 strict=True)
    for got, want in ((_flat(params), _flat(v["params"])),
                      (_flat(stats), _flat(v["batch_stats"]))):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg="/".join(key))


@pytest.mark.parametrize("method, bn_learn", [
    ("sgd", False), ("sgd", True), ("adam", False), ("rmsprop", True)])
def test_decay_sets_match_jax(big_models, method, bn_learn):
    """SGD decays all but the BN parameters (all under BN_LEARN), Adam and
    RMSprop every parameter (their JAX chains are not masked), name for
    name; ``heads`` trains ``dev/big_fc``."""
    v, pm = big_models
    paths = optim.flax_paths(pm)
    opts = ["TRAIN.OPTIM_METHOD", method, "TRAIN.BN_LEARN", str(bn_learn)]
    cfg, jcfg = build_config(opts=opts), jax_build_config(opts=opts)
    opt = optim.make_optimizer(cfg, pm)
    decayed = {paths[n] for n, p in pm.named_parameters() for g in opt.param_groups
               if g["weight_decay"] > 0 and any(p is q for q in g["params"])}
    if method == "sgd":
        want = {"/".join(k) for k, m in _flat(
            joptim.bn_mask(v["params"], exclude_bn=not jcfg.TRAIN.BN_LEARN)).items() if m}
        assert isinstance(opt, torch.optim.SGD)
    else:
        want = set(paths.values())
        assert isinstance(opt, optim.OptaxChain) and len(opt.param_groups) == 1
    assert decayed == want
    assert {"dev/big_fc/kernel", "dev/big_fc/bias"} <= {
        paths[n] for n in optim.trainable_names(pm, "heads")}


# --- DEV.BIG_FC_INIT coco_pretrain --------------------------------------------------------
def test_big_fc_init_seeds_big_fc_from_the_classifier_on_resume(tmp_path):
    opts = ["MODEL.BACKBONE", "resnet50", "DATASET.NUM_CLASSES", "8", "DATA.IMAGE_MIN_DIM",
            "96", "DATA.IMAGE_MAX_DIM", "128", "DEV.SWITCH", "True", "DEV.BIG_SUPERVISE", "True",
            "DEV.BIG_FC_INIT", "coco_pretrain", "DEV.UPSAMPLE_FAC", "1.0"]
    cfg = build_config(opts=opts)
    assert cfg.DEV.BIG_FC_INIT_LIST == jax_build_config(opts=opts).DEV.BIG_FC_INIT_LIST
    cfg.MISC.RESULT_FOLDER, cfg.MISC.LOG_FILE = str(tmp_path), str(tmp_path / "log.txt")
    model = InterNet.from_config(cfg)
    big, cls = model.dev_roi.big_fc_layer, model.classifier.linear_class
    assert not torch.equal(big.weight, cls.weight)
    workflow.Trainer(model, cfg).resume()
    assert torch.equal(big.weight, cls.weight) and torch.equal(big.bias, cls.bias)
    assert "[cross-init] dev/big_fc/kernel <- classifier/linear_class/kernel" in (
        tmp_path / "log.txt").read_text()
    # a pair of other shapes is skipped, as in JAX
    seen = []
    before = big.weight.detach().clone()
    apply_cross_name_init(model, {"dev/big_fc/kernel": "classifier/linear_bbox/kernel"},
                          optim.flax_paths(model), log_fn=seen.append)
    assert seen == ["[cross-init] skip dev/big_fc/kernel <- classifier/linear_bbox/kernel "
                    "(shape mismatch)"]
    assert torch.equal(big.weight, before)


# --- a checkpoint with Adam's state --------------------------------------------------------
def _toy_state(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), BatchNorm2d(4, momentum=0.1),
                                torch.nn.Conv2d(4, 2, 1)).eval()
    opt = optim.OptaxChain(list(model.parameters()), "adam", 1e-4)
    buf, cnt = init_buffer(1, 3, feat_dim=4)
    return TrainState(model, opt, buf, cnt)


def _toy_step(state, i):
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(i))
    state.optimizer.zero_grad(set_to_none=True)
    with bn_learning(state.model):
        state.model(x).square().mean().backward()
    state.optimizer.param_groups[0]["lr"] = 1e-2
    state.optimizer.step()
    state.step += 1


def test_checkpoint_with_adam_state_resumes_the_same_next_step(tmp_path):
    whole = _toy_state(0)
    for i in range(3):
        _toy_step(whole, i)
    cut = _toy_state(0)
    for i in range(2):
        _toy_step(cut, i)
    path = ckpt.save_checkpoint(str(tmp_path), cut, epoch=1, iter_ind=2)
    resumed, epoch, it = ckpt.restore_checkpoint(path, _toy_state(1))
    assert (epoch, it, resumed.step) == (1, 2, 2)
    assert resumed.optimizer.param_groups[0]["count"] == 2
    _toy_step(resumed, 2)
    sd, want = resumed.model.state_dict(), whole.model.state_dict()
    assert not torch.equal(want["1.running_var"], torch.ones(4))
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        for slot in ("mu", "nu"):
            assert torch.equal(resumed.optimizer.state[p][slot], whole.optimizer.state[q][slot])
    assert resumed.optimizer.param_groups[0]["count"] == 3


# --- the big-set crop's gradient ------------------------------------------------------------
def _edge_boxes(rng, b, nb):
    """[B, NB, 4] boxes, a third of them ending at exactly 1.0 in y, a third
    in x, the rest inside."""
    y1x1 = rng.uniform(0.0, 0.9, (b, nb, 2)).astype(np.float32)
    y2x2 = np.minimum(y1x1 + rng.uniform(0.02, 0.6, (b, nb, 2)), 1.0).astype(np.float32)
    y2x2[:, : nb // 3, 0] = 1.0
    y2x2[:, nb // 3: 2 * nb // 3, 1] = 1.0
    return np.concatenate([y1x1, y2x2], -1)


@pytest.mark.parametrize("h", [32, 64, 256])
def test_big_set_crop_gradient_matches_the_jitted_jax_crop(h):
    rng = np.random.RandomState(h)
    b, nb, c, crop = 2, 60, 4, 14
    image = rng.randn(b, h, h + 5, c).astype(np.float32)
    boxes = _edge_boxes(rng, b, nb)
    g = rng.randn(b, nb, crop, crop, c).astype(np.float32)
    idx = np.repeat(np.arange(b, dtype=np.int32), nb)

    def loss(img):
        out = jroi.crop_and_resize(img, jnp.asarray(boxes.reshape(-1, 4)), jnp.asarray(idx),
                                   (crop, crop))
        return jnp.vdot(out, jnp.asarray(g.reshape(-1, crop, crop, c)))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(image)))
    img = T(image.copy()).requires_grad_()
    out = roi_ops.crop_and_resize_fused(img, T(boxes), (crop, crop), positions="xla")
    np.testing.assert_array_equal(
        out.detach().numpy(), roi_ops.crop_and_resize_grouped_plain(
            T(image), T(boxes), (crop, crop), positions="xla").numpy())
    (out * T(g)).sum().backward()
    err = np.abs(img.grad.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err
    # K1's rounding taps another last row for some of these boxes
    k1 = roi_ops.multilevel_gather_bwd_plain(
        T(g.reshape(-1, crop, crop, c)), [image.shape], T(boxes.reshape(-1, 4)),
        T(idx), torch.zeros(b * nb, dtype=torch.int32), (crop, crop))[0]
    assert np.abs(k1.numpy() - want).max() / np.abs(want).max() > 1e-3


@pytest.mark.parametrize("h", [32, 64, 256])
def test_backward_sample_positions_are_the_jitted_crops(h):
    """What K3's ``xla`` mode plans from (``_sample_positions`` through
    ``tap_rows`` and ``bwd_work_plan``) equals ``_single_level_positions(...,
    "xla")``, the forward K4's, bit for bit; K1's rounding differs."""
    rng = np.random.RandomState(h + 1)
    boxes = T(_edge_boxes(rng, 1, 3000)[0])
    dims = torch.full((3000,), float(h))
    for lo, hi in ((0, 2), (1, 3)):
        got = roi_ops._sample_positions(boxes[:, lo], boxes[:, hi], 14, dims, xla=True)
        want = roi_ops._single_level_positions(boxes[:, lo], boxes[:, hi], 14, h, "xla")
        assert torch.equal(got, want)
        k1 = roi_ops._sample_positions(boxes[:, lo], boxes[:, hi], 14, dims)
        assert (k1 != want).any()
    shapes = [(1, h, h, 8)]
    idx, lvl = torch.zeros(3000, dtype=torch.int32), torch.zeros(3000, dtype=torch.int32)
    (tl, _, _, br), ly, lx, valid = roi_ops.tap_rows(shapes, boxes, idx, lvl, (14, 14), xla=True)
    pos_y = roi_ops._single_level_positions(boxes[:, 0], boxes[:, 2], 14, h, "xla")
    np.testing.assert_array_equal(ly.numpy(), (pos_y - torch.floor(pos_y)).numpy())
    # the plan's tile cover: the (box, tile) pairs of the cells the forward's
    # valid samples tap
    ty, by, _, vy = roi_ops._grouped_axis(boxes[None, :, 0], boxes[None, :, 2], 14, h, "xla")
    lx, rx, _, vx = roi_ops._grouped_axis(boxes[None, :, 1], boxes[None, :, 3], 14, h, "xla")
    pairs = 0
    for k in range(3000):
        if vy[0, k].any() and vx[0, k].any():
            rows = int(by[0, k][vy[0, k]].max() - ty[0, k][vy[0, k]].min()) + 1
            cols = (int(rx[0, k][vx[0, k]].max()) // roi_ops.BWD_TILE_W
                    - int(lx[0, k][vx[0, k]].min()) // roi_ops.BWD_TILE_W + 1)
            pairs += rows * cols
    plan = roi_ops.bwd_work_plan(shapes, boxes, idx, lvl, (14, 14), xla=True)
    assert plan["pairs"] == pairs
    with pytest.raises(ValueError, match="positions"):
        roi_ops.crop_and_resize_fused(torch.zeros(1, h, h, 8), boxes[None, :1], (14, 14),
                                      positions="multilevel")


def test_plain_crops_of_a_nan_box_extrapolate_as_the_kernels():
    """A diverged model's NaN box: the plain RoIAlign, its gradient and the
    plain grouped crop give the extrapolation value and no gradient there,
    as the kernels (which clamp a NaN tap to cell 0) do, and raise
    nothing (ROADMAP C.6)."""
    rng = np.random.RandomState(5)
    image = T(rng.randn(1, 16, 16, 4).astype(np.float32))
    boxes = T(np.array([[0.1, 0.2, 0.6, 0.7], [np.nan, 0.2, 0.6, 0.7]], np.float32))
    zero = torch.zeros(2, dtype=torch.int32)
    out = roi_ops.multilevel_gather_plain([image], boxes, zero, zero, (7, 7), -1.5)
    assert torch.isfinite(out).all() and (out[1] == -1.5).all()
    grad = roi_ops.multilevel_gather_bwd_plain(torch.ones(2, 7, 7, 4), [image.shape], boxes,
                                               zero, zero, (7, 7))[0]
    want = roi_ops.multilevel_gather_bwd_plain(torch.ones(1, 7, 7, 4), [image.shape], boxes[:1],
                                               zero[:1], zero[:1], (7, 7))[0]
    assert torch.equal(grad, want)
    crop = roi_ops.crop_and_resize_grouped_plain(image, boxes[None], (5, 5), positions="xla")
    assert torch.isfinite(crop).all() and (crop[0, 1] == 0).all()
