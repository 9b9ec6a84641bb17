"""The port's training ops against the JAX package's, on the CPU.

Box encoding, the RPN and second-stage targets (fed the JAX package's own
uniform draws), the five losses, the RoIAlign gradient (the plain version of
the CUDA kernel ``csrc/roi_align_bwd.cu``), single-level and separable
``crop_and_resize``, the intertwiner buffer and meta loss, Dev in train
mode, and the stage and weight-decay sets of the optimizer.

Tolerances: box math, targets and losses within 1e-6 relative (the same
float32 operations in the same order); the RoIAlign gradient within 1e-5
absolute of ``jax.grad`` (XLA's scatter-add sums in another order) and 1e-4
of the window kernel in interpret mode, as its own tests hold it; Dev within
1e-4 relative (convolutions).
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.config import LAYER_REGEX as JAX_LAYER_REGEX
from feature_intertwiner_tpu.config import build_config as jax_build_config
from feature_intertwiner_tpu.models.intertwiner import Dev as JDev
from feature_intertwiner_tpu.models.intertwiner import class_mean as jax_class_mean
from feature_intertwiner_tpu.ops import boxes as jboxes
from feature_intertwiner_tpu.ops import roi_align as jroi
from feature_intertwiner_tpu.ops import targets as jtargets
from feature_intertwiner_tpu.ops.roi_align_window import window_origins_and_fits
from feature_intertwiner_tpu.ops.roi_align_window_bwd import multilevel_roi_align_window_bwd
from feature_intertwiner_tpu.train import losses as jlosses
from feature_intertwiner_tpu.train import optim as joptim
from feature_intertwiner_tpu.train.step import intertwiner_meta as jax_intertwiner_meta
from feature_intertwiner_tpu_torch.config import build_config
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.intertwiner import Dev, class_mean
from feature_intertwiner_tpu_torch.ops import boxes
from feature_intertwiner_tpu_torch.ops import roi_align as roi
from feature_intertwiner_tpu_torch.ops import targets
from feature_intertwiner_tpu_torch.train import losses
from feature_intertwiner_tpu_torch.train import optim
from feature_intertwiner_tpu_torch.train.step import intertwiner_meta
from test_torch_model import TINY, assert_rel, init_pair

T = torch.from_numpy
KEY = jax.random.PRNGKey(0)


def jax_draws(key, batch: int, n: int) -> np.ndarray:
    """The uniform scores ``targets.py::_random_topk_mask`` draws inside
    the JAX package's vmapped ``per_sample``: key split per sample, then
    into the positive and the negative key. [B, 2, n] float32."""
    out = []
    for k in jax.random.split(key, batch):
        kp, kn = jax.random.split(k)
        out.append([np.asarray(jax.random.uniform(kp, (n,))),
                    np.asarray(jax.random.uniform(kn, (n,)))])
    return np.asarray(out, np.float32)


def random_boxes(rng, shape, lo, hi, min_size, max_size):
    y1x1 = rng.uniform(lo, hi, shape + (2,))
    hw = rng.uniform(min_size, max_size, shape + (2,))
    return np.concatenate([y1x1, y1x1 + hw], -1).astype(np.float32)


# --- boxes --------------------------------------------------------------------------
def test_box_encode_area_iou_match_jax():
    rng = np.random.RandomState(0)
    a = random_boxes(rng, (2, 40), 0, 100, 1, 60)
    b = random_boxes(rng, (2, 40), 0, 100, 1, 60)
    a[:, -3:] = 0.0                       # zero-padded rows, as the targets see them
    assert_rel(boxes.encode(T(a), T(b), eps=1e-8), jboxes.encode(a, b, eps=1e-8), 1e-6)
    c = a[:, :-3]
    assert_rel(boxes.encode(T(b[:, :-3]), T(c)), jboxes.encode(b[:, :-3], c), 1e-6)
    assert_rel(boxes.area(T(a)), jboxes.area(a), 1e-6)
    assert_rel(boxes.iou_matrix(T(a), T(b)), jboxes.iou_matrix(a, b), 1e-6)


# --- targets ------------------------------------------------------------------------
def _gt(rng, b=2, g=6, size=128.0, mini=14):
    gt_boxes = random_boxes(rng, (b, g), 0, size * 0.6, 8, size * 0.4)
    gt_cls = rng.randint(1, 8, (b, g)).astype(np.int32)
    gt_cls[0, 1] = -3                     # a crowd
    gt_cls[:, -1] = 0                     # padding
    gt_boxes[:, -1] = 0.0
    gt_masks = (rng.rand(b, g, mini, mini) > 0.5).astype(np.float32)
    return gt_cls, gt_boxes, gt_masks


def test_rpn_targets_match_jax_with_the_same_draws():
    rng = np.random.RandomState(1)
    anchors = random_boxes(rng, (600,), -10, 110, 4, 60)
    gt_cls, gt_boxes, _ = _gt(rng)
    std = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    want = jtargets.rpn_targets(KEY, anchors, gt_cls, gt_boxes, std, 64)
    got = targets.rpn_targets(T(anchors), T(gt_cls), T(gt_boxes), T(std), 64,
                              draws=T(jax_draws(KEY, 2, 600)))
    np.testing.assert_array_equal(got.match.numpy(), np.asarray(want.match))
    assert (got.match.numpy() == 1).any() and (got.match.numpy() == -1).any()
    assert_rel(got.deltas, want.deltas, 1e-6)


@pytest.mark.parametrize("use_mini_mask", [True, False])
def test_detection_targets_match_jax_with_the_same_draws(use_mini_mask):
    rng = np.random.RandomState(2)
    gt_cls, gt_boxes, gt_masks = _gt(rng, mini=14 if use_mini_mask else 32)
    gt_boxes /= 128.0
    # proposals near the GT boxes (positives), elsewhere, and zero padding
    near = np.repeat(gt_boxes, 5, axis=1) + rng.normal(0, 0.03, (2, 30, 4)).astype(np.float32)
    props = np.concatenate([near, random_boxes(rng, (2, 20), 0, 0.7, 0.02, 0.3),
                            np.zeros((2, 10, 4), np.float32)], 1).astype(np.float32)
    std = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    want = jtargets.detection_targets(KEY, props, gt_cls, gt_boxes, gt_masks, std, 24,
                                      use_mini_mask=use_mini_mask, mask_shape=(28, 28))
    got = targets.detection_targets(T(props), T(gt_cls), T(gt_boxes), T(gt_masks), T(std), 24,
                                    use_mini_mask=use_mini_mask, mask_shape=(28, 28),
                                    draws=T(jax_draws(KEY, 2, props.shape[1])))
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    np.testing.assert_array_equal(got.class_ids.numpy(), np.asarray(want.class_ids))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(want.masks))
    np.testing.assert_array_equal(got.pos_mask.numpy(), np.asarray(want.pos_mask))
    np.testing.assert_array_equal(got.valid_mask.numpy(), np.asarray(want.valid_mask))
    assert_rel(got.deltas, want.deltas, 1e-6)
    assert got.pos_mask.numpy().any() and (got.valid_mask & ~got.pos_mask).numpy().any()
    assert got.masks.numpy().any()


def test_targets_draw_from_a_generator():
    """The main path draws its own scores; a generator seeded alike gives
    the same targets."""
    rng = np.random.RandomState(3)
    anchors = T(random_boxes(rng, (300,), 0, 100, 4, 60))
    gt_cls, gt_boxes, _ = (T(x) for x in _gt(rng))
    std = torch.tensor([0.1, 0.1, 0.2, 0.2])
    runs = [targets.rpn_targets(anchors, gt_cls, gt_boxes, std, 64,
                                generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(runs[0].match, runs[1].match)
    with pytest.raises(ValueError, match="generator or draws"):
        targets.rpn_targets(anchors, gt_cls, gt_boxes, std, 64)


# --- losses -------------------------------------------------------------------------
def test_losses_match_jax():
    rng = np.random.RandomState(4)
    b, a, r, k = 2, 50, 12, 8
    match = rng.choice([-1, 0, 1], (b, a)).astype(np.int32)
    cls = rng.randint(0, k, (b, r)).astype(np.int32)
    cls[:, -3:] = 0
    cases = [
        (losses.rpn_class_loss, jlosses.rpn_class_loss, (match, rng.randn(b, a, 2))),
        (losses.rpn_bbox_loss, jlosses.rpn_bbox_loss,
         (rng.randn(b, a, 4), match, rng.randn(b, a, 4) * 2)),
        (losses.mrcnn_class_loss, jlosses.mrcnn_class_loss, (cls, rng.randn(b, r, k))),
        (losses.mrcnn_bbox_loss, jlosses.mrcnn_bbox_loss,
         (rng.randn(b, r, 4), cls, rng.randn(b, r, k, 4) * 2)),
        (losses.mrcnn_mask_loss, jlosses.mrcnn_mask_loss,
         ((rng.rand(b, r, 28, 28) > 0.5), cls, rng.rand(b, r, 28, 28, k))),
    ]
    for port_fn, jax_fn, args in cases:
        args = [np.asarray(x, np.float32) if x.dtype == np.float64 else x for x in args]
        got = port_fn(*[T(x) for x in args])
        want = jax_fn(*[jnp.asarray(x) for x in args])
        assert_rel(got, want, 1e-6)
    zeros = np.zeros((b, r), np.int32)
    assert float(losses.mrcnn_class_loss(T(zeros), torch.randn(b, r, k))) == 0.0


# --- RoIAlign gradient ------------------------------------------------------------------
SHAPES = ((2, 32, 32, 8), (2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8))


def _pooling_inputs(rng, n=40, shapes=SHAPES, image=128):
    feats = [rng.randn(*s).astype(np.float32) for s in shapes]
    b = random_boxes(rng, (n,), -0.1, 1.0, 0.0, 0.5)     # some past the map
    bidx = rng.randint(0, shapes[0][0], n).astype(np.int32)
    lvl = np.asarray(jroi.assign_fpn_level(jnp.asarray(b), (image, image)) - 2, np.int32)
    return feats, b, bidx, lvl


def _crowd(layout, rng, n=40, image=128):
    """The second stage's crowds: ``zero_padded``, 30 of 40 slots the zero
    box (every sample taps cell (0, 0) of P2); ``cluster``, 40 distinct boxes
    of image 0 jittered around one object (they meet the same few tiles)."""
    if layout == "zero_padded":
        b = np.zeros((n, 4), np.float32)
        b[:10] = random_boxes(rng, (10,), 0.0, 0.7, 0.05, 0.3)
        bidx = np.repeat(np.arange(2, dtype=np.int32), n // 2)
        rng.shuffle(b)
    else:
        obj = np.array([0.40, 0.35, 0.52, 0.50], np.float32)
        b = np.clip(obj + rng.normal(0, 0.01, (n, 4)), 0, 1).astype(np.float32)
        bidx = np.zeros(n, np.int32)
    lvl = np.asarray(jroi.assign_fpn_level(jnp.asarray(b), (image, image)) - 2, np.int32)
    return b, bidx, lvl


@pytest.mark.parametrize("crop, layout", [
    pytest.param(7, "random", id="7"), pytest.param(14, "random", id="14"),
    pytest.param(1, "random", id="1"),
    pytest.param(7, "zero_padded", id="7-zero_padded"),
    pytest.param(14, "zero_padded", id="14-zero_padded"),
    pytest.param(7, "cluster", id="7-cluster"), pytest.param(14, "cluster", id="14-cluster")])
def test_roi_align_gradient_matches_jax_grad(crop, layout):
    rng = np.random.RandomState(10 + crop)
    feats, b, bidx, lvl = _pooling_inputs(rng)
    if layout != "random":
        b, bidx, lvl = _crowd(layout, rng)
    g = rng.randn(len(b), crop, crop, 8).astype(np.float32)

    def f(fs):
        out = jroi.multilevel_crop_and_resize(list(fs), jnp.asarray(b), jnp.asarray(bidx),
                                              (crop, crop), (128, 128), level_idx=jnp.asarray(lvl))
        return jnp.sum(out * g)

    want = jax.grad(f)(tuple(jnp.asarray(x) for x in feats))
    tf = [T(x).requires_grad_() for x in feats]
    out = roi.multilevel_crop_and_resize(tf, T(b), T(bidx), (crop, crop), (128, 128),
                                         level_idx=T(lvl.copy()))
    out.backward(T(g))
    # a crowded cell sums hundreds of samples, in another order than XLA's
    # scatter-add: held, as on the card, to 1e-5 of the largest gradient
    top = max(float(np.abs(np.asarray(w)).max()) for w in want)
    atol = 1e-5 if layout == "random" else 1e-5 * top
    for t, w in zip(tf, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=atol)
    assert any(float(t.grad.abs().sum()) > 0 for t in tf)


TRAIN_SHAPES = tuple((4, s, s, 8) for s in (256, 128, 64, 32))   # P2-P5 of 1024², 4 images


@pytest.mark.parametrize("crop", [7, 14])
def test_float32_plain_backward_is_as_near_the_exact_sum_as_jax_grad(crop):
    """The train step's zero-padded crowd at 8 channels: 800 slots of 4
    images, 740 of them the zero box, whose samples all add into cell (0, 0)
    of P2 (9,065 terms per image at 7², 36,260 at 14²). The port's float32
    plain backward (its CPU path) and ``jax.grad`` in float32 both lie
    within 1e-5 of the largest gradient of the exact sum (the float64 plain
    backward), and within 1e-7 of it of each other: both add the crowded
    cell's terms in slot order."""
    rng = np.random.RandomState(60 + crop)
    b = np.zeros((4, 200, 4), np.float32)
    b[:, :15] = random_boxes(rng, (4, 15), 0.0, 0.7, 0.02, 0.27)
    b = b.reshape(-1, 4)
    bidx = np.repeat(np.arange(4, dtype=np.int32), 200)
    lvl = np.array(jroi.assign_fpn_level(jnp.asarray(b), (1024, 1024)) - 2, np.int32)
    assert int((np.abs(b).sum(1) == 0).sum()) == 740
    g = rng.randn(len(b), crop, crop, 8).astype(np.float32)

    def f(fs):
        out = jroi.multilevel_crop_and_resize(list(fs), jnp.asarray(b), jnp.asarray(bidx),
                                              (crop, crop), (1024, 1024),
                                              level_idx=jnp.asarray(lvl))
        return jnp.sum(out * g)

    feats = tuple(jnp.zeros(s, jnp.float32) for s in TRAIN_SHAPES)
    jax32 = [np.asarray(w, np.float64) for w in jax.grad(f)(feats)]
    args = (TRAIN_SHAPES, T(b), T(bidx), T(lvl), (crop, crop))
    port32 = [d.double().numpy() for d in roi.roi_align_bwd(T(g), *args)]
    exact = [d.numpy() for d in roi.multilevel_gather_bwd_plain(T(g).double(), *args)]
    top = max(np.abs(e).max() for e in exact)

    def err(xs, ys):
        return max(np.abs(x - y).max() for x, y in zip(xs, ys)) / top

    found = {"port": err(port32, exact), "jax": err(jax32, exact), "apart": err(port32, jax32)}
    assert found["port"] <= 1e-5 and found["jax"] <= 1e-5, found
    assert found["apart"] <= 1e-7, found


@pytest.mark.parametrize("crop", [7, 14])
@pytest.mark.parametrize("channels", [1, 256, 1586, 1587, 4096])
def test_bwd_channel_chunks_fit_shared_memory_and_cover_the_channels(channels, crop):
    chunks = roi.bwd_channel_chunks(channels, (crop, crop))
    assert chunks[0][0] == 0 and chunks[-1][1] == channels
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(c1 > c0 and roi.bwd_shared_bytes(c1 - c0, (crop, crop)) <= 200 * 1024
               for c0, c1 in chunks)
    # one chunk while the whole map fits (up to 1,586 channels at 7², 1,572 at 14²)
    fits = roi.bwd_shared_bytes(channels, (crop, crop)) <= 200 * 1024
    assert (len(chunks) == 1) == fits
    assert fits == (channels <= {7: 1586, 14: 1572}[crop])


@pytest.mark.parametrize("crop", [7, 14, 1])
def test_roi_align_plain_backward_matches_autograd_of_plain_forward(crop):
    rng = np.random.RandomState(20 + crop)
    feats, b, bidx, lvl = _pooling_inputs(rng)
    g = T(rng.randn(len(b), crop, crop, 8).astype(np.float32))
    tf = [T(x).requires_grad_() for x in feats]
    roi.multilevel_gather_plain(tf, T(b), T(bidx), T(lvl), (crop, crop)).backward(g)
    got = roi.roi_align_bwd(g, SHAPES, T(b), T(bidx), T(lvl), (crop, crop))
    for d, t in zip(got, tf):
        assert d.shape == t.shape
        np.testing.assert_allclose(d.numpy(), t.grad.numpy(), rtol=0, atol=1e-5)


WSHAPES = ((2, 256, 256, 16), (2, 128, 128, 16), (2, 64, 64, 16), (2, 32, 32, 16))


@pytest.mark.parametrize("crop", [7, 14])
def test_roi_align_backward_matches_window_kernel_on_fit_boxes(crop):
    """Against the TPU kernel itself (``_bwd_kernel`` in interpret mode), on
    the boxes its window holds, as ``tests/test_roi_align_window_bwd.py``
    does."""
    rng = np.random.RandomState(30 + crop)
    n = 120
    yx = rng.rand(n, 2) * 0.7
    b = np.concatenate([yx, np.minimum(yx + rng.rand(n, 2) * 0.2 + 0.02, 1.0)], 1).astype(np.float32)
    bidx = rng.randint(0, 2, n).astype(np.int32)
    lvl = jnp.clip(jroi.assign_fpn_level(jnp.asarray(b), (1024, 1024)) - 2, 0, 3)
    heights = jnp.array([s[1] for s in WSHAPES], jnp.int32)
    widths = jnp.array([s[2] for s in WSHAPES], jnp.int32)
    _, _, fits = window_origins_and_fits(jnp.asarray(b), lvl, heights, widths,
                                         (crop, crop), (32, 32))
    fits = np.asarray(fits)
    assert 0 < fits.sum() < n
    g = (rng.randn(n, crop, crop, 16) * fits[:, None, None, None]).astype(np.float32)
    want = multilevel_roi_align_window_bwd(jnp.asarray(g), jnp.asarray(b), jnp.asarray(bidx),
                                           lvl, WSHAPES, (crop, crop), (32, 32), interpret=True)
    got = roi.roi_align_bwd(T(g), WSHAPES, T(b), T(bidx), T(np.asarray(lvl)), (crop, crop))
    for d, w in zip(got, want):
        np.testing.assert_allclose(d.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_roi_align_backward_across_the_window_kernels_strip_boundary():
    """A box whose window straddles the TPU kernel's 128-row strips of P2
    (its halo-spill path)."""
    y1 = 120.5 / 255.0
    b = np.array([[y1, 0.2, y1 + 20 / 255.0, 0.28]], np.float32)
    bidx, lvl = np.zeros(1, np.int32), np.zeros(1, np.int32)
    g = np.ones((1, 7, 7, 16), np.float32)
    want = multilevel_roi_align_window_bwd(jnp.asarray(g), jnp.asarray(b), jnp.asarray(bidx),
                                           jnp.asarray(lvl), WSHAPES, (7, 7), (32, 32),
                                           interpret=True)
    got = roi.roi_align_bwd(T(g), WSHAPES, T(b), T(bidx), T(lvl), (7, 7))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    assert float(got[0][:, 128:].abs().sum()) > 0 and float(got[0][:, :128].abs().sum()) > 0


def test_roi_align_function_gives_boxes_no_gradient():
    """As the JAX custom VJP ``_hybrid_bwd`` (zeros for the boxes)."""
    rng = np.random.RandomState(40)
    feats, b, bidx, lvl = _pooling_inputs(rng, n=6)
    tb = T(b).requires_grad_()
    tf = [T(f).requires_grad_() for f in feats]
    roi.roi_align(tf, tb, T(bidx), T(lvl), (7, 7)).sum().backward()
    assert tb.grad is None and all(t.grad is not None for t in tf)


def test_bwd_work_plan_splits_the_zero_padded_tile():
    """Every sample of the zero box taps cell (0, 0) of P2: that tile of
    each image gets one work item per 4 of its zero slots (a partial tile
    each), every other tile one item."""
    b = torch.zeros((40, 4))
    bidx = torch.tensor([0] * 17 + [1] * 23, dtype=torch.int32)
    lvl = roi.assign_fpn_level(b, (128, 128)) - 2
    assert int(lvl.max()) == 0
    tiles = 2 * (32 + 16 + 8 + 4)        # one 32-column tile per row
    for crop in (7, 14):
        plan = roi.bwd_work_plan(SHAPES, b, bidx, lvl, (crop, crop), chunk_boxes=4,
                                 split_above=0)
        assert plan == {"tiles": tiles, "items": tiles - 2 + 5 + 6, "partials": 11,
                        "multi_tiles": 2, "max_chunks": 6, "pairs": 40}
    # only a tile that more than split_above boxes meet is split
    assert roi.bwd_work_plan(SHAPES, b, bidx, lvl, (7, 7), chunk_boxes=4, split_above=20) == {
        "tiles": tiles, "items": tiles - 1 + 6, "partials": 6, "multi_tiles": 1,
        "max_chunks": 6, "pairs": 40}
    assert roi.bwd_work_plan(SHAPES, b, bidx, lvl, (7, 7), chunk_boxes=64, split_above=0) == {
        "tiles": tiles, "items": tiles, "partials": 0, "multi_tiles": 0, "max_chunks": 1,
        "pairs": 40}
    assert 1 <= roi.BWD_CHUNK_BOXES <= 64 and 0 <= roi.BWD_SPLIT_ABOVE <= 64
    assert roi.bwd_work_plan(SHAPES, b, bidx, lvl, (7, 7)) == roi.bwd_work_plan(
        SHAPES, b, bidx, lvl, (7, 7), chunk_boxes=roi.BWD_CHUNK_BOXES,
        split_above=roi.BWD_SPLIT_ABOVE)


def test_roi_align_bwd_with_plan_runs_the_plain_version_on_the_cpu():
    """On CPU tensors there is no kernel, so no plan: the gradients are the
    plain version's, and ``roi_align_bwd`` returns the same."""
    rng = np.random.RandomState(45)
    _, b, bidx, lvl = _pooling_inputs(rng)
    g = T(rng.randn(len(b), 7, 7, 8).astype(np.float32))
    args = (g, SHAPES, T(b), T(bidx), T(lvl), (7, 7))
    grads, plan = roi.roi_align_bwd_with_plan(*args)
    assert plan is None
    for d, p, w in zip(grads, roi.roi_align_bwd(*args), roi.multilevel_gather_bwd_plain(*args)):
        assert torch.equal(d, w) and torch.equal(p, w)


PSHAPES = ((2, 96, 80, 4), (2, 48, 40, 4), (2, 24, 20, 4), (2, 12, 10, 4))


@pytest.mark.parametrize("layout", ["random", "cluster"])
@pytest.mark.parametrize("chunk, split", [(1, 0), (3, 4)])
def test_bwd_work_plan_matches_a_count_box_by_box(layout, chunk, split):
    """The plan against the tiles each box's taps span, found box by box
    from the plain gather's own tap rows (several column tiles per row)."""
    rng = np.random.RandomState(50 + chunk)
    if layout == "random":
        b = random_boxes(rng, (40,), -0.1, 1.0, 0.0, 0.5)
        bidx = rng.randint(0, 2, 40).astype(np.int32)
        lvl = np.asarray(jroi.assign_fpn_level(jnp.asarray(b), (128, 128)) - 2, np.int32)
    else:
        b, bidx, lvl = _crowd(layout, rng)
    crop = (7, 5)
    taps, _, _, valid = roi.tap_rows(PSHAPES, T(b), T(bidx), T(lvl), crop)
    sizes = [s[1] * s[2] for s in PSHAPES]
    starts = np.cumsum([0] + sizes)
    counts = {}
    for k in range(len(b)):
        rows = np.concatenate([t[k][valid[k]].numpy() for t in taps])
        if rows.size == 0:
            continue
        level = int(lvl[k])
        _, h, w, _ = PSHAPES[level]
        cell = rows % starts[-1] - starts[level]
        ys, xs = cell // w, cell % w
        for y in range(ys.min(), ys.max() + 1):
            for x in range(xs.min() // roi.BWD_TILE_W, xs.max() // roi.BWD_TILE_W + 1):
                key = (level, int(bidx[k]), y, x)
                counts[key] = counts.get(key, 0) + 1
    tiles = sum(s[0] * s[1] * -(-s[2] // roi.BWD_TILE_W) for s in PSHAPES)
    chunks = [1 if c <= split else -(-c // chunk) for c in counts.values()]
    want = {"tiles": tiles, "items": tiles - len(chunks) + sum(chunks),
            "partials": sum(c for c in chunks if c > 1),
            "multi_tiles": sum(c > 1 for c in chunks), "max_chunks": max(chunks),
            "pairs": sum(counts.values())}
    assert roi.bwd_work_plan(PSHAPES, T(b), T(bidx), T(lvl), crop, chunk_boxes=chunk,
                             split_above=split) == want
    assert want["max_chunks"] > 1


def test_single_level_and_separable_crops_match_jax():
    """The JAX single-level crop writes its sample positions and lerps
    without the multilevel gather's fused multiply-adds, which the port's
    kernel and plain version reproduce: within 1e-5 of the largest value."""
    rng = np.random.RandomState(41)
    image = rng.randn(2, 32, 32, 8).astype(np.float32)
    b = random_boxes(rng, (40,), -0.1, 1.0, 0.0, 0.5)
    bidx = rng.randint(0, 2, 40).astype(np.int32)
    for crop in (14, 7, 1):
        got = roi.crop_and_resize(T(image), T(b), T(bidx), (crop, crop))
        want = jroi.crop_and_resize(jnp.asarray(image), jnp.asarray(b), jnp.asarray(bidx),
                                    (crop, crop))
        assert_rel(got, want, 1e-5)
    srcs = (rng.rand(40, 56, 56, 1) > 0.5).astype(np.float32)
    got = roi.crop_and_resize_separable(T(srcs), T(b), (28, 28))
    want = jroi.crop_and_resize_separable(jnp.asarray(srcs), jnp.asarray(b), (28, 28))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# --- the intertwiner ------------------------------------------------------------------
def _stats(rng, s=3, d=16, k=6, n=20, empty_small=False):
    cnt = rng.randint(0, 3, (s, 1, k)).astype(np.float32)
    small_cnt = rng.randint(0, 3, (s, 1, k)).astype(np.float32)
    small_feat = rng.rand(s, d, k).astype(np.float32) * (small_cnt > 0)
    if empty_small:
        small_feat[:] = 0.0
    return {"big_feat": rng.rand(s, d, k).astype(np.float32) * (cnt > 0), "big_cnt": cnt,
            "small_feat": small_feat, "small_cnt": small_cnt,
            "small_out": rng.rand(n, d).astype(np.float32),
            "small_gt": rng.randint(0, k, n).astype(np.float32),
            "big_loss": np.zeros(s, np.float32)}


@pytest.mark.parametrize("buffer_size", [1, 3])
@pytest.mark.parametrize("loss_choice", ["l1", "l2", "kl"])
@pytest.mark.parametrize("inst_loss", [False, True])
def test_intertwiner_meta_matches_jax(buffer_size, loss_choice, inst_loss):
    rng = np.random.RandomState(50 + buffer_size)
    cfg = {"buffer_size": buffer_size, "loss_choice": loss_choice, "inst_loss": inst_loss}
    d, k = 16, 6
    buf = rng.rand(buffer_size, d, k).astype(np.float32)
    cnt = rng.randint(0, 2, (buffer_size, 1, k)).astype(np.float32)
    for empty in (False, True):
        stats = _stats(rng, d=d, k=k, empty_small=empty)
        want = jax_intertwiner_meta(cfg, jnp.asarray(buf), jnp.asarray(cnt),
                                    {key: jnp.asarray(v) for key, v in stats.items()})
        got = intertwiner_meta(cfg, T(buf), T(cnt), {key: T(v) for key, v in stats.items()})
        for g, w in zip(got, want):
            assert_rel(g, w, 1e-6)
        if empty:       # no small statistics: no loss, the buffer stays
            assert float(got[0]) == 0.0
            np.testing.assert_array_equal(got[1].numpy(), buf)
        else:
            assert float(got[0]) > 0.0


def test_class_mean_matches_jax():
    rng = np.random.RandomState(55)
    vecs = rng.rand(30, 16).astype(np.float32)
    gts = rng.randint(0, 6, 30)
    mask = rng.rand(30) > 0.4
    for g, w in zip(class_mean(T(vecs), T(gts), T(mask), 6),
                    jax_class_mean(jnp.asarray(vecs), jnp.asarray(gts), jnp.asarray(mask), 6)):
        assert_rel(g, w, 1e-6)


def test_dev_in_train_mode_matches_flax():
    """Levels 2 to 5 all occur (image_size 1024 over 32² to 4² maps), so
    every meta level has a small set and a reliable set."""
    rng = np.random.RandomState(60)
    feats = [rng.randn(2, s, s, 256).astype(np.float32) for s in (32, 16, 8, 4)]
    side = np.exp(rng.uniform(np.log(0.02), np.log(0.5), (2, 24, 1)))
    y1x1 = rng.uniform(0, 1, (2, 24, 2)) * (1 - side)
    rois = np.concatenate([y1x1, y1x1 + side], -1).astype(np.float32)
    roi_gt = rng.randint(0, 4, (2, 24)).astype(np.int32)
    jm = JDev(num_classes=8, image_size=1024, use_dev=True, upsample_fac=1.0, loss_choice="l2")
    pm = Dev(256, image_size=1024, use_dev=True, upsample_fac=1.0, num_classes=8,
             loss_choice="l2")
    jf = [jnp.asarray(f) for f in feats]
    v = init_pair(jm, pm, (jf, jnp.asarray(rois)), lambda t: {"dev": t}, "dev_roi.",
                  roi_gt=jnp.asarray(roi_gt), train=True)
    want_cls, want_mask, want = jm.apply(v, jf, jnp.asarray(rois), roi_gt=jnp.asarray(roi_gt),
                                         train=True)
    lvl = np.asarray(jroi.assign_fpn_level(jnp.asarray(rois.reshape(-1, 4)), (1024, 1024)))
    assert set(lvl) == {2, 3, 4, 5}
    got_cls, got_mask, got = pm.forward_train([T(f).permute(0, 3, 1, 2) for f in feats],
                                              T(rois), T(roi_gt))
    assert_rel(got_cls, want_cls)
    assert_rel(got_mask, want_mask)
    for key in ("big_feat", "big_cnt", "small_feat", "small_cnt", "small_out", "small_gt",
                "big_loss"):
        assert_rel(got[key], want[key])
    assert float(got["big_cnt"].sum()) > 0 and float(got["small_cnt"].sum()) > 0
    # the reliable side carries no gradient; the small side does
    assert not got["big_feat"].requires_grad and got["small_out"].requires_grad


# --- the optimizer --------------------------------------------------------------------
def _flat(tree, prefix=()):
    out = {}
    for k, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flat(val, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = val
    return out


@pytest.fixture(scope="module")
def tiny_params():
    from test_torch_model import JInterNet

    jm = JInterNet(**TINY, post_nms_train=64, rois_per_image=24, dev_loss_choice="l2")
    images = jnp.zeros((1, 128, 128, 3))
    # the parameter tree's structure is all the masks read
    variables = jax.eval_shape(lambda: jm.init(
        {"params": KEY}, images, mode="inference",
        windows=jnp.asarray([[0, 0, 128, 128]], jnp.float32)))
    return variables["params"], InterNet(**TINY, rois_per_image=24, dev_loss_choice="l2")


@pytest.mark.parametrize("layers", ["heads", "3+", "4+", "5+", "all"])
def test_trainable_set_per_stage_matches_jax_mask(tiny_params, layers):
    params, model = tiny_params
    paths = optim.flax_paths(model)
    assert sorted(paths.values()) == sorted(_flat(params))
    want = {p for p, m in _flat(joptim.trainable_mask(params, layers)).items() if m}
    got = {paths[n] for n in optim.trainable_names(model, layers)}
    assert got == want
    assert optim.LAYER_REGEX == JAX_LAYER_REGEX
    optim.set_trainable(model, layers)
    assert {paths[n] for n, p in model.named_parameters() if p.requires_grad} == want


def test_weight_decay_set_matches_jax_bn_mask(tiny_params):
    params, model = tiny_params
    paths = optim.flax_paths(model)
    want = {p for p, m in _flat(joptim.bn_mask(params)).items() if m}
    assert {paths[n] for n in optim.decay_names(model)} == want
    cfg = build_config()
    opt = optim.make_optimizer(cfg, model)
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    for n, p in model.named_parameters():
        assert (id(p) in decayed) == (paths[n] in want), n
    assert opt.param_groups[0]["weight_decay"] == cfg.TRAIN.WEIGHT_DECAY
    assert opt.param_groups[1]["weight_decay"] == 0.0
    assert not opt.defaults["nesterov"] and opt.defaults["dampening"] == 0.0


def test_learning_rate_and_clip_match_jax():
    for warm in (False, True):
        cfg, jcfg = build_config(), jax_build_config()
        for c in (cfg, jcfg):
            c.TRAIN.SCHEDULE = [2, 3, 1]
            c.TRAIN.LR_WARM_UP = warm
            c.TRAIN.LR_WP_ITER = 5
        for epoch in range(1, 8):
            for it in (1, 3, 5, 9):
                assert optim.learning_rate(cfg, epoch, it) == joptim.learning_rate(jcfg, epoch, it)
    rng = np.random.RandomState(70)
    for scale in (0.01, 10.0):
        grads = [rng.randn(*s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
        tg = [T(g.copy()) for g in grads]
        norm = optim.clip_global_norm(tg, 5.0)
        jg, jnorm = joptim.clip_global_norm([jnp.asarray(g) for g in grads], 5.0)
        assert_rel(norm, jnorm, 1e-6)
        for a, b in zip(tg, jg):
            assert_rel(a, b, 1e-6)
