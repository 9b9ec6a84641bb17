"""The gradient paths that ``DEV.BIG_SUPERVISE`` and ``DEV.BIG_FEAT_DETACH
False`` add (``ROADMAP.md`` A5), the port's ``Dev.forward_train`` against
``jax.grad`` of the jitted JAX ``Dev`` on the CPU, where they are
well-conditioned: tiny P2-P5 maps, RoIs of levels 2-5, BN in eval mode.

Every parameter's and map's gradient of a loss over the Dev's statistics
lies within 1e-5 of its largest magnitude of JAX's, with the big class
means attached and detached. The loss has three parts (``big_loss``, the
big class means, the small side), each differentiated apart in JAX:
``big_fc``'s cross-entropy and the attached means each reach the critic
and P2-P4 (through K3's ``xla`` mode, its plain version here) by more
than 1e-3 of their magnitude, so the bound sees either path missing, and
the detached means reach nothing. A train step cannot show the attached
means: the JAX step's meta loss stops the gradient of the buffer they
feed (``train/step.py::intertwiner_meta``), as the port's does.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.models.intertwiner import Dev as JDev
from feature_intertwiner_tpu_torch.models.intertwiner import Dev
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_model import init_pair

T = torch.from_numpy


# the three parts of the test's loss: BIG_SUPERVISE's cross-entropy, the big
# class means (attached under BIG_FEAT_DETACH False) and the small side
DEV_PARTS = ("big_loss", "big_feat", "small")


def _dev_losses(stats, w):
    """The parts of :data:`DEV_PARTS`, each a scalar of the Dev statistics
    weighed by the fixed random ``w``."""
    return (stats["big_loss"].sum(), (stats["big_feat"] * w["big_feat"]).sum(),
            (stats["small_feat"] * w["small_feat"]).sum()
            + (stats["small_out"] * w["small_out"]).sum())


def _dev_gradients(detach):
    """A tiny ``Dev`` (``BIG_SUPERVISE``, make-up factor 1, BN in eval mode)
    on random P2-P5 maps and RoIs of levels 2-5, its weights drawn in flax's
    shapes: the port's gradients of the sum of :data:`DEV_PARTS` (every
    parameter by name, and each map's, NHWC), and ``jax.grad`` of each part
    of the jitted JAX Dev, in the port's layout."""
    rng = np.random.RandomState(14)
    feats = [rng.randn(2, s, s, 32).astype(np.float32) for s in (32, 16, 8, 4)]
    side = np.exp(rng.uniform(np.log(0.02), np.log(0.5), (2, 24, 1)))
    y1x1 = rng.uniform(0, 1, (2, 24, 2)) * (1 - side)
    rois = np.concatenate([y1x1, y1x1 + side], -1).astype(np.float32)
    roi_gt = rng.randint(0, 4, (2, 24)).astype(np.int32)
    kw = dict(upsample_fac=1.0, num_classes=8, image_size=1024, loss_choice="l2",
              big_supervise=True, big_feat_detach=detach)
    jm, pm = JDev(**kw), Dev(32, **kw)
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.",
                  roi_gt=jnp.asarray(roi_gt), train=True)
    w = {"big_feat": rng.randn(3, 1024, 8), "small_feat": rng.randn(3, 1024, 8),
         "small_out": rng.randn(48, 1024)}
    w = {k: a.astype(np.float32) for k, a in w.items()}

    def part(i, params, maps):
        _, _, stats = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, maps,
                               jnp.asarray(rois), roi_gt=jnp.asarray(roi_gt), train=True)
        return _dev_losses(stats, w)[i]

    grads = jax.jit(lambda p, f: [jax.grad(functools.partial(part, i), argnums=(0, 1))(p, f)
                                  for i in range(len(DEV_PARTS))])(v["params"], jf)
    want = []
    for g_params, g_maps in grads:
        sd = from_jax_params({"dev": g_params}, {})
        want.append(dict({k[len("dev_roi."):]: t.double() for k, t in sd.items()
                          if not k.endswith("num_batches_tracked")},
                         **{f"P{i + 2}": torch.from_numpy(np.asarray(g)).double()
                            for i, g in enumerate(g_maps)}))
    maps = [T(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    _, _, stats = pm.forward_train(maps, T(rois), T(roi_gt))
    sum(_dev_losses(stats, {k: T(a) for k, a in w.items()})).backward()
    got = dict({n: p.grad.double() for n, p in pm.named_parameters()},
               **{f"P{i + 2}": m.grad.permute(0, 2, 3, 1).double() for i, m in enumerate(maps)})
    return got, want


@pytest.mark.parametrize("detach", [False, True], ids=["attached", "detached"])
def test_dev_big_set_gradients_match_jax(detach):
    got, want = _dev_gradients(detach)
    total = {k: sum(w[k] for w in want) for k in want[0]}
    assert got.keys() == total.keys()
    for k, t in total.items():
        scale = float(t.abs().max())
        err = float((got[k] - t).abs().max()) / max(scale, 1e-30)
        assert err <= 1e-5, (k, err, scale)
    reach = {part: {k: float(w[k].abs().max() / total[k].abs().max().clamp_min(1e-30))
                    for k in ("feat_extract.0.weight", "P2", "P3", "P4")}
             for part, w in zip(DEV_PARTS, want)}
    assert min(reach["big_loss"].values()) > 1e-3, reach
    assert min(reach["big_feat"].values()) > 1e-3 if not detach else \
        max(reach["big_feat"].values()) == 0.0, reach
    assert float(total["big_fc_layer.weight"].abs().max()) > 0
