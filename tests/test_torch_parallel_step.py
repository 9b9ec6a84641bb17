"""One 2-rank train step of the port against the JAX package's
``make_parallel_train_step`` on a 2-device mesh, on the CPU.

The flagship-shaped tiny step of ``test_torch_train.py`` (Dev on, L2 meta
loss, the clip on, stage 'all') over a global batch of 2 images, one per
rank and device. The port's ranks are spawned gloo processes that import
no JAX (``tests/torch_dist_ranks.py``); the JAX step runs here on 2 of
the 8 virtual CPU devices, jitted (about 70 s to compile). What each JAX
device's proposal layer and targets see inside the step comes back per
device (``jax.debug.callback`` with ``axis_index("data")``), and each rank
is fed its device's proposals and uniform draws.

Tolerances, as the single-process step's: the losses within 1e-4
relative, the parameters after the step within 1e-5 of each tensor's
largest magnitude, the buffer within 1e-4; both ranks hold the same bits
after the step.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models import detector as jax_detector
from feature_intertwiner_tpu.parallel import (make_mesh, make_parallel_train_step, replicate,
                                              shard_batch)
from feature_intertwiner_tpu.train.step import create_train_state as jax_create_train_state
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.utils.convert_weights import from_jax_params
from test_torch_model import TINY, JInterNet, _redraw
from test_torch_train import (FPN_SCALES, IMG, STEP_MODEL, STEP_OPTS, _assert_step_equal,
                              _batch)
from test_torch_train_ops import jax_draws

T = torch.from_numpy
WORLD = 2


class MeshRecorder:
    """``test_torch_train.StepRecorder`` under ``shard_map``: what each
    device's proposal layer and targets see, keyed by its
    ``axis_index("data")``."""

    def __init__(self, monkeypatch):
        self.seen = {}
        for name in ("rpn_targets", "detection_targets"):
            monkeypatch.setattr(jax_detector, name, self._keys(name, getattr(jax_detector, name)))
        propose = jax_detector.proposal_layer

        def proposals(*args, **kwargs):
            out = propose(*args, **kwargs)
            self._record("proposals", out)
            return out
        monkeypatch.setattr(jax_detector, "proposal_layer", proposals)

    def _record(self, name, value):
        def keep(v, device):
            self.seen.setdefault(name, {})[int(device)] = np.asarray(v)
        jax.debug.callback(keep, value, jax.lax.axis_index("data"))

    def _keys(self, name, fn):
        def wrapper(key, *args, **kwargs):
            self._record(name, key)
            return fn(key, *args, **kwargs)
        return wrapper

    def per_device(self, anchors: int):
        """[device] proposals and {"rpn", "det"} [device] draws of the step."""
        jax.effects_barrier()
        proposals = [self.seen["proposals"][d] for d in range(WORLD)]
        draws = {"rpn": [jax_draws(self.seen["rpn_targets"][d], 1, anchors)
                         for d in range(WORLD)],
                 "det": [jax_draws(self.seen["detection_targets"][d], 1, proposals[d].shape[1])
                         for d in range(WORLD)]}
        return np.stack(proposals), {k: np.stack(v) for k, v in draws.items()}


def test_the_rank_helpers_hold_the_step_tests_sizes():
    assert ranks.TINY == TINY and ranks.STEP_MODEL == STEP_MODEL
    assert ranks.STEP_OPTS == STEP_OPTS and ranks.FPN_SCALES == FPN_SCALES and ranks.IMG == IMG


@pytest.fixture(scope="module")
def mesh_pair(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        rng = np.random.RandomState(0)
        images = (rng.randn(WORLD, IMG, IMG, 3) * 40).astype(np.float32)
        jm = JInterNet(**TINY, **STEP_MODEL, post_nms_train=64, strict_quirks=True)
        zeros = {"gt_class_ids": jnp.zeros((WORLD, 6), jnp.int32),
                 "gt_boxes": jnp.zeros((WORLD, 6, 4)), "gt_masks": jnp.zeros((WORLD, 6, 14, 14))}
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda: jm.init({"params": key, "sampling": key},
                                            jnp.asarray(images), mode="train", **zeros))()
        variables = {"params": _redraw(variables["params"], rng),
                     "batch_stats": _redraw(variables["batch_stats"], rng)}
        for level, scale in FPN_SCALES.items():
            out = variables["params"]["fpn"][f"p{level}_out"]
            out["kernel"], out["bias"] = out["kernel"] * scale, out["bias"] * scale
        weights = from_jax_params(variables["params"], variables["batch_stats"])
        model = InterNet(**TINY, **STEP_MODEL)
        model.load_state_dict(weights)
        model.eval()
        with torch.no_grad():
            proposals = model.first_stage(T(images))[3].numpy()
        batch = dict(_batch(proposals, rng), images=images)
        n_anchors = int(model.anchors.shape[0])
        del model

        jcfg = jax_build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
        jcfg.TRAIN.BATCH_SIZE = WORLD
        mesh = make_mesh(WORLD)
        recorder = MeshRecorder(mp)
        state = replicate(jax_create_train_state(
            jcfg, jax.tree_util.tree_map(jnp.copy, variables)), mesh)
        step = make_parallel_train_step(jm, jcfg, "all", mesh)
        jstate, jmetrics = step(state, shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                                   mesh),
                                jnp.float32(0.01), jnp.float32(1.0), jax.random.PRNGKey(1))
        jstate, jmetrics = jax.device_get((jstate, jmetrics))
        proposals, draws = recorder.per_device(n_anchors)
        got = ranks.spawn(ranks.mesh_step, tmp_path_factory.mktemp("mesh_step"), weights, batch,
                          draws, proposals)
        return got, jstate, jmetrics


def test_two_rank_step_matches_the_jax_mesh_step(mesh_pair):
    got, jstate, jmetrics = mesh_pair
    metrics = got[0]["metrics"]
    assert float(metrics["meta_loss"]) > 0 and float(metrics["positive_rois"]) > 0
    _assert_step_equal(metrics, jmetrics, got[0]["state"], jstate)
    assert int(jstate.step) == 1
    # the clip saw the averaged gradient: the same global norm
    assert abs(float(metrics["grad_norm"]) - float(jmetrics["grad_norm"])) <= 1e-4 * float(
        jmetrics["grad_norm"])


def test_both_ranks_hold_the_same_bits_after_the_step(mesh_pair):
    got, _, _ = mesh_pair
    assert got[1]["digest"] == got[0]["digest"]
    for k, v in got[0]["metrics"].items():
        assert torch.equal(got[1]["metrics"][k], v), k
