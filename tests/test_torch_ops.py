"""The PyTorch port's ops against the JAX package's, on the CPU.

The same numpy inputs, drawn from a seed, go through both; on the CPU the
port runs its kernels' plain versions. Tolerances:

- anchors, FPN levels, box clipping, NMS keep masks and indices: exact;
- box decoding and proposals: exact where the deltas leave ``exp`` exact
  (zero log-size deltas), else within float32 rounding, because XLA's and
  torch's CPU ``exp`` round differently in the last bit;
- RoIAlign: 1e-5 absolute.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_intertwiner_tpu.ops import anchors as jax_anchors
from feature_intertwiner_tpu.ops import boxes as jax_boxes
from feature_intertwiner_tpu.ops.detection import detection_layer as jax_detection_layer
from feature_intertwiner_tpu.ops.nms import _greedy_alive_sorted
from feature_intertwiner_tpu.ops.nms import class_aware_nms as jax_class_aware_nms
from feature_intertwiner_tpu.ops.nms import nms as jax_nms
from feature_intertwiner_tpu.ops.nms_pallas import nms_alive_pallas_batched
from feature_intertwiner_tpu.ops.proposals import proposal_layer as jax_proposal_layer
from feature_intertwiner_tpu.ops.roi_align import _multilevel_gather, flatten_pyramid
from feature_intertwiner_tpu.ops.roi_align import assign_fpn_level as jax_assign_fpn_level
from feature_intertwiner_tpu.ops.roi_align import (
    multilevel_crop_and_resize as jax_multilevel_crop_and_resize)
from feature_intertwiner_tpu.ops.roi_align_window import (
    hybrid_unfit_overflow, multilevel_crop_and_resize_window)
from feature_intertwiner_tpu_torch.ops import anchors, boxes
from feature_intertwiner_tpu_torch.ops.detection import detection_layer
from feature_intertwiner_tpu_torch.ops import cuda_build
from feature_intertwiner_tpu_torch.ops.nms import (
    LIST_BYTES, SHARED_BYTES, STAGES, TILE, _pairwise_iou, _suppresses, batched_nms,
    class_aware_nms, greedy_alive_sorted_plain, nms, nms_alive, sweep_plan)
from feature_intertwiner_tpu_torch.ops.proposals import proposal_layer
from feature_intertwiner_tpu_torch.ops.roi_align import (
    FWD_COL_BYTES, FWD_ROW_BYTES, FWD_SHARED_BYTES, FWD_THREADS, FWD_VECTORS, _fma,
    assign_fpn_level, fwd_plan, fwd_shared_bytes, fwd_vector_width, multilevel_crop_and_resize,
    multilevel_gather_plain, reciprocal, roi_align_fwd)

T = torch.from_numpy


def _random_boxes(rng, n, size=100.0, min_hw=2.0, max_hw=40.0):
    yx = rng.rand(n, 2) * size
    hw = rng.rand(n, 2) * (max_hw - min_hw) + min_hw
    return np.concatenate([yx, yx + hw], 1).astype(np.float32)


# --- boxes and anchors ------------------------------------------------------
def test_decode_exact_when_exp_is_exact():
    rng = np.random.RandomState(0)
    b = _random_boxes(rng, 500)
    d = rng.randn(500, 4).astype(np.float32)
    d[:, 2:] = 0.0
    np.testing.assert_array_equal(boxes.decode(T(b), T(d)).numpy(),
                                  np.asarray(jax_boxes.decode(b, d)))


def test_decode_random_deltas_within_rounding():
    rng = np.random.RandomState(1)
    b = _random_boxes(rng, 500)
    d = (rng.randn(500, 4) * 0.3).astype(np.float32)
    np.testing.assert_allclose(boxes.decode(T(b), T(d)).numpy(),
                               np.asarray(jax_boxes.decode(b, d)), rtol=1e-6, atol=1e-5)


def test_clip_exact_shared_and_per_sample_windows():
    rng = np.random.RandomState(2)
    b = (rng.randn(3, 50, 4) * 80).astype(np.float32)
    win = np.array([0.0, 0.0, 64.0, 96.0], np.float32)
    np.testing.assert_array_equal(boxes.clip(T(b), T(win)).numpy(),
                                  np.asarray(jax_boxes.clip(b, win)))
    wins = (rng.rand(3, 1, 4) * 50).astype(np.float32)
    np.testing.assert_array_equal(boxes.clip(T(b), T(wins)).numpy(),
                                  np.asarray(jax_boxes.clip(b, wins)))


@pytest.mark.parametrize("image", [128, 1024])
def test_anchors_bit_equal(image):
    scales = (8, 16, 32, 64, 128) if image == 128 else (32, 64, 128, 256, 512)
    strides = (4, 8, 16, 32, 64)
    shapes = [[int(np.ceil(image / s))] * 2 for s in strides]
    got = anchors.generate_pyramid_anchors(scales, (0.5, 1, 2), shapes, strides)
    want = jax_anchors.generate_pyramid_anchors(scales, (0.5, 1, 2), shapes, strides)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if image == 1024:
        assert got.shape == (261888, 4)


@pytest.mark.parametrize("image", [128, 1024])
def test_assign_fpn_level_exact(image):
    rng = np.random.RandomState(3)
    b = _random_boxes(rng, 2000, size=0.8, min_hw=0.0, max_hw=1.0) / np.float32(1.0)
    b[:20, 2:] = b[:20, :2]                      # zero-area boxes
    got = assign_fpn_level(T(b), (image, image)).numpy()
    want = np.asarray(jax_assign_fpn_level(jnp.asarray(b), (image, image)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


# --- NMS ----------------------------------------------------------------------
def _nms_case(kind, rng, n):
    b = _random_boxes(rng, n, size=120.0, min_hw=4.0, max_hw=50.0)
    scores = rng.rand(n).astype(np.float32)
    valid = np.ones(n, bool)
    if kind == "ties":
        # runs of identical boxes and identical scores
        b = np.repeat(np.round(b[: n // 4]), 4, axis=0)
        scores = np.repeat(np.round(scores[: n // 4] * 8) / 8, 4).astype(np.float32)
    elif kind == "padded":
        valid = rng.rand(n) > 0.3
        valid[-n // 4:] = False
        b[-n // 4:] = 0.0
    elif kind == "disjoint":
        # each box inside a cell of its own: all kept, 64 per tile
        side = int(np.ceil(np.sqrt(n)))
        cell = rng.permutation(n)
        y, x = (cell // side) * 10.0, (cell % side) * 10.0
        b = np.stack([y, x, y + 8, x + 8], 1).astype(np.float32)
    elif kind == "one":
        # copies of one 50-px box moved by less than 1 px: the first suppresses all
        b = (np.float32([20, 30, 70, 80]) + rng.rand(n, 4)).astype(np.float32)
    return b, scores, valid


@pytest.mark.parametrize("plus_one,strict", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("kind", ["random", "ties", "padded"])
def test_nms_keep_bit_exact(kind, plus_one, strict):
    rng = np.random.RandomState(4)
    n, max_out = 200, 64
    b, s, v = _nms_case(kind, rng, n)
    got_idx, got_ok = nms(T(b), T(s), 0.5, max_out, valid=T(v),
                          plus_one=plus_one, strict=strict)
    want_idx, want_ok = jax_nms(jnp.asarray(b), jnp.asarray(s), 0.5, max_out,
                                valid=jnp.asarray(v), plus_one=plus_one, strict=strict)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


@pytest.mark.parametrize("plus_one,strict", [(True, True), (False, False)])
@pytest.mark.parametrize("kind", ["random", "ties", "padded"])
def test_nms_alive_matches_pallas_kernel_and_sweep(kind, plus_one, strict):
    """The alive mask over score-sorted boxes, as the kernel computes it,
    against the Pallas kernel (interpret mode) and the XLA sweep."""
    rng = np.random.RandomState(5)
    bsz, n = 2, 128
    cases = [_nms_case(kind, rng, n) for _ in range(bsz)]
    bx = np.stack([c[0][np.argsort(-c[1], kind="stable")] for c in cases])
    va = np.stack([c[2][np.argsort(-c[1], kind="stable")] for c in cases])
    got = nms_alive(T(bx), T(va), 0.6, plus_one=plus_one, strict=strict).numpy()
    pallas = np.asarray(nms_alive_pallas_batched(
        jnp.asarray(bx), jnp.asarray(va), 0.6, plus_one=plus_one, strict=strict,
        block=64, interpret=True))
    sweep = np.stack([np.asarray(_greedy_alive_sorted(
        jnp.asarray(bx[i]), jnp.asarray(va[i]), 0.6, plus_one, strict, 64))
        for i in range(bsz)])
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, sweep)
    # the sweep does not depend on its block size: the JAX sweep at twice
    # the plain version's block agrees too
    np.testing.assert_array_equal(greedy_alive_sorted_plain(T(bx), T(va), 0.6, plus_one, strict).numpy(),
                                  np.stack([np.asarray(_greedy_alive_sorted(
                                      jnp.asarray(bx[i]), jnp.asarray(va[i]), 0.6, plus_one, strict, 128))
                                      for i in range(bsz)]))


# A numpy model of csrc/nms.cu, word for word: the mask pass's 64-bit words
# in their upper-triangle runs, then the sweep with its staged window.
WORD = (1 << 64) - 1


def _tile_offset(c, tiles):
    return TILE * (c * tiles - c * (c - 1) // 2)


def _mask_runs(boxes, thr, plus_one, strict):
    """The mask pass for one image: bit t of word (row i, tile k) is set when
    row i suppresses column k * 64 + t > i; tile c's rows hold words
    c..tiles-1, row after row, tile after tile. Python ints."""
    n = boxes.shape[0]
    tiles = n // TILE
    supp = np.triu(_suppresses(_pairwise_iou(T(boxes), T(boxes), plus_one), thr, strict).numpy(), 1)
    words = np.packbits(supp.reshape(n, tiles, TILE), axis=-1, bitorder="little")
    words = words.view("<u8")[..., 0]                                   # [n, tiles]
    runs = [words[c * TILE:(c + 1) * TILE, c:].reshape(-1) for c in range(tiles)]
    return [int(w) for w in np.concatenate(runs)]


def _rows_or(rows, words):
    """A warp reduction: the OR of ``words[r]`` over the rows r of ``rows``."""
    acc = 0
    for r in range(TILE):
        if rows >> r & 1:
            acc |= words[r]
    return acc


def _sweep_model(runs, valid, words):
    """The sweep for one image with ``words`` staged words per row: the
    removed bitset starts as the invalid rows; per tile the rounds (the
    lowest candidate and every candidate that no candidate suppresses are
    kept, and drop what they suppress) over the staged diagonal words, then
    per later word the OR over the list of kept rows, from the stage buffer
    or, past the window, from the mask."""
    n = valid.shape[0]
    tiles = n // TILE
    removed = [WORD & ~sum(1 << t for t in range(TILE) if valid[k * TILE + t])
               for k in range(tiles)]
    alive = np.zeros(n, bool)
    for c in range(tiles):
        off, later = _tile_offset(c, tiles), tiles - c
        staged = min(words, later)
        buf = [runs[off + r * later:off + r * later + staged] for r in range(TILE)]
        diag = [row[0] for row in buf]
        cand, keep = WORD & ~removed[c], 0
        while cand:
            k = (cand & ~_rows_or(cand, diag)) | (cand & -cand)
            keep |= k
            cand &= ~k
            if cand:
                cand &= ~_rows_or(k, diag)
        alive[c * TILE:(c + 1) * TILE] = [(keep >> t) & 1 for t in range(TILE)]
        kept = [r for r in range(TILE) if keep >> r & 1]
        for j in range(1, later):
            acc = 0
            for r in kept:
                acc |= buf[r][j] if j < staged else runs[off + r * later + j]
            removed[c + j] |= acc
    return alive


@pytest.mark.parametrize("plus_one,strict", [(True, True), (False, False)])
@pytest.mark.parametrize("kind", ["random", "ties", "padded", "disjoint", "one"])
def test_nms_kernel_model_matches_plain_jax_and_pallas(kind, plus_one, strict):
    """The kernel's algorithm (numpy model, the plan's window and two
    narrower ones) against the plain version, the XLA sweep and the Pallas
    kernel (interpret mode), bit for bit."""
    rng = np.random.RandomState(7)
    bsz, n = 2, 1024 if kind != "ties" else 512
    cases = [_nms_case(kind, rng, n) for _ in range(bsz)]
    bx = np.stack([c[0][np.argsort(-c[1], kind="stable")] for c in cases])
    va = np.stack([c[2][np.argsort(-c[1], kind="stable")] for c in cases])
    plain = greedy_alive_sorted_plain(T(bx), T(va), 0.6, plus_one, strict).numpy()
    pallas = np.asarray(nms_alive_pallas_batched(
        jnp.asarray(bx), jnp.asarray(va), 0.6, plus_one=plus_one, strict=strict,
        block=64, interpret=True))
    sweep = np.stack([np.asarray(_greedy_alive_sorted(
        jnp.asarray(bx[i]), jnp.asarray(va[i]), 0.6, plus_one, strict, 64))
        for i in range(bsz)])
    np.testing.assert_array_equal(pallas, plain)
    np.testing.assert_array_equal(sweep, plain)
    runs = [_mask_runs(bx[i], 0.6, plus_one, strict) for i in range(bsz)]
    for words in (sweep_plan(n)[0], 3, 1):
        model = np.stack([_sweep_model(runs[i], va[i], words) for i in range(bsz)])
        np.testing.assert_array_equal(model, plain)
    if kind == "disjoint":
        assert plain.all()
    elif kind == "one":
        assert plain.sum(1).tolist() == [1] * bsz


@pytest.mark.parametrize("thr,strict", [(0.7, True), (0.0, False), (0.0, True), (-0.5, False)])
def test_mask_pass_decides_a_zero_intersection_without_dividing(thr, strict):
    """The mask kernel skips the division where the intersection is +-0: the
    quotient is then +-0, or NaN where the union is 0 or NaN. Its rule
    equals the plain test on every pair, degenerate, inverted and
    zero-area boxes included."""
    rng = np.random.RandomState(8)
    b = _random_boxes(rng, 96, size=60.0, min_hw=0.0, max_hw=30.0)
    b[:8, 2:] = b[:8, :2]                      # zero-area boxes
    b[8:16] = b[8:16][:, [2, 3, 0, 1]]          # inverted boxes
    b[16:20] = 0.0                              # the padding's zero box
    for plus_one in (True, False):
        a, c = T(b), T(b)
        off = 1.0 if plus_one else 0.0
        y1 = torch.maximum(a[:, None, 0], c[None, :, 0])
        x1 = torch.maximum(a[:, None, 1], c[None, :, 1])
        y2 = torch.minimum(a[:, None, 2], c[None, :, 2])
        x2 = torch.minimum(a[:, None, 3], c[None, :, 3])
        inter = (x2 - x1 + off).clamp_min(0.0) * (y2 - y1 + off).clamp_min(0.0)
        area = (a[:, 2] - a[:, 0] + off) * (a[:, 3] - a[:, 1] + off)
        uni = area[:, None] + area[None, :] - inter
        zero_passes = (0.0 > thr) if strict else (0.0 >= thr)
        rule = torch.where(inter == 0, zero_passes & (uni == uni) & (uni != 0),
                           _suppresses(inter / uni, thr, strict))
        want = _suppresses(_pairwise_iou(a, c, plus_one), thr, strict)
        assert bool((inter == 0).any()) and bool((inter > 0).any())
        assert torch.equal(rule, want)


@pytest.mark.parametrize("n", [64, 1024, 6016, 14336, 14400, 16384, 65536, 393216])
def test_sweep_plan_fits_shared_memory_and_covers_every_word(n):
    words, nbytes = sweep_plan(n)
    tiles = n // TILE
    assert 1 <= words <= tiles
    assert nbytes == tiles * 8 + LIST_BYTES + STAGES * words * TILE * 8 <= SHARED_BYTES == 227 * 1024
    # each row of tile c's run holds words c..tiles-1: the first `words` are
    # staged, the rest read from device memory, none twice, the diagonal staged
    later = tiles - np.arange(tiles)
    staged = np.minimum(words, later)
    rest = later - words
    assert (staged >= 1).all()
    assert (staged + np.maximum(rest, 0) == later).all()
    # whole runs are double-buffered up to 224 tiles (N = 14,336)
    assert (words == tiles) == (n <= 14336)
    if n == 6016:
        assert (STAGES, words, nbytes) == (2, 94, 97_520)
    # the C entry holds the kernel to the same limit and stages
    source = (cuda_build.CSRC_DIR / "nms.cu").read_text()
    assert f"kSharedLimit = {SHARED_BYTES};" in source and f"kStages = {STAGES};" in source


def test_nms_alive_checks_its_inputs():
    with pytest.raises(ValueError):
        nms_alive(torch.zeros(1, 100, 4), torch.ones(1, 100, dtype=torch.bool), 0.5)
    with pytest.raises(TypeError):
        nms_alive(torch.zeros(1, 64, 4, dtype=torch.float64),
                  torch.ones(1, 64, dtype=torch.bool), 0.5)


def test_batched_and_class_aware_nms_match_per_sample_jax():
    rng = np.random.RandomState(6)
    bsz, n, max_out = 3, 150, 40
    b = np.stack([_random_boxes(rng, n, size=200.0) for _ in range(bsz)])
    s = rng.rand(bsz, n).astype(np.float32)
    cls = rng.randint(0, 5, (bsz, n))
    v = rng.rand(bsz, n) > 0.2
    idx, ok = batched_nms(T(b), T(s), 0.3, max_out, valid=T(v))
    cidx, cok = class_aware_nms(T(b), T(s), T(cls), 0.3, max_out, valid=T(v))
    for i in range(bsz):
        want_idx, want_ok = jax_nms(jnp.asarray(b[i]), jnp.asarray(s[i]), 0.3, max_out,
                                    valid=jnp.asarray(v[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(ok[i].numpy(), np.asarray(want_ok))
        want_idx, want_ok = jax_class_aware_nms(
            jnp.asarray(b[i]), jnp.asarray(s[i]), jnp.asarray(cls[i]), 0.3, max_out,
            valid=jnp.asarray(v[i]))
        np.testing.assert_array_equal(cidx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(cok[i].numpy(), np.asarray(want_ok))


# --- proposals ------------------------------------------------------------------
IMG = 128
SCALES = (8, 16, 32, 64, 128)


def _rpn_outputs(rng, zero_size_deltas):
    shapes = [[IMG // s] * 2 for s in (4, 8, 16, 32, 64)]
    anc = anchors.generate_pyramid_anchors(SCALES, (0.5, 1, 2), shapes, (4, 8, 16, 32, 64))
    a = anc.shape[0]
    logits = rng.randn(2, a, 2).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    deltas = (rng.randn(2, a, 4) * 0.5).astype(np.float32)
    if zero_size_deltas:
        deltas[..., 2:] = 0.0
    return probs.astype(np.float32), deltas, anc


@pytest.mark.parametrize("zero_size_deltas", [True, False])
def test_proposal_layer_matches_jax(zero_size_deltas):
    rng = np.random.RandomState(7)
    probs, deltas, anc = _rpn_outputs(rng, zero_size_deltas)
    # tied scores exercise the top-k tie order
    probs[:, 100:140, 1] = probs[:, 100:101, 1]
    std = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    got = proposal_layer(T(probs), T(deltas), T(anc), std, (IMG, IMG),
                         pre_nms_limit=300, proposal_count=60, nms_threshold=0.7).numpy()
    want = np.asarray(jax_proposal_layer(
        jnp.asarray(probs), jnp.asarray(deltas), jnp.asarray(anc), jnp.asarray(std),
        (IMG, IMG), pre_nms_limit=300, proposal_count=60, nms_threshold=0.7))
    np.testing.assert_array_equal((got != 0).any(-1), (want != 0).any(-1))
    if zero_size_deltas:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# --- RoIAlign -------------------------------------------------------------------
def _pyramid(rng, b=2, c=16, sizes=(32, 16, 8, 4)):
    return [rng.randn(b, s, s, c).astype(np.float32) for s in sizes]


def _roi_boxes(rng, n):
    b = np.concatenate([rng.rand(n, 2) * 0.8, np.zeros((n, 2))], 1)
    b[:, 2:] = b[:, :2] + rng.rand(n, 2) * 0.5
    b[: n // 8] = rng.rand(n // 8, 4) * 1.6 - 0.3         # out of range, any order
    b[n // 8: n // 4, 2:] = b[n // 8: n // 4, :2]         # degenerate
    return b.astype(np.float32)


@pytest.mark.parametrize("crop", [7, 14, 1])
def test_multilevel_crop_and_resize_matches_jax(crop):
    rng = np.random.RandomState(8)
    feats = _pyramid(rng)
    bx = _roi_boxes(rng, 120)
    bidx = rng.randint(0, 2, 120).astype(np.int32)
    got = multilevel_crop_and_resize([T(f) for f in feats], T(bx), T(bidx),
                                     (crop, crop), (IMG, IMG)).numpy()
    want = np.asarray(jax_multilevel_crop_and_resize(
        [jnp.asarray(f) for f in feats], jnp.asarray(bx), jnp.asarray(bidx),
        (crop, crop), (IMG, IMG)))
    assert got.shape == (120, crop, crop, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extrapolation_value_and_given_levels_match_jax():
    rng = np.random.RandomState(9)
    feats = _pyramid(rng)
    bx = _roi_boxes(rng, 64)
    bidx = rng.randint(0, 2, 64).astype(np.int32)
    lvl = rng.randint(0, 4, 64).astype(np.int32)
    got = roi_align_fwd([T(f) for f in feats], T(bx), T(bidx), T(lvl), (5, 9),
                        extrapolation_value=-1.5).numpy()
    flat, hs, ws, offs = flatten_pyramid([jnp.asarray(f) for f in feats])
    want = np.asarray(_multilevel_gather(flat, hs, ws, offs, jnp.asarray(bx),
                                         jnp.asarray(bidx), jnp.asarray(lvl), (5, 9),
                                         extrapolation_value=-1.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got == -1.5).any()


def test_roi_align_matches_jax_window_kernel_where_exact():
    """Against the JAX main path's pooling, the window kernel (interpret
    mode), on a pyramid large enough to run it. Its values are exact only
    when no box overflows the hybrid's fallback budget, so the test holds
    the box set to that."""
    rng = np.random.RandomState(10)
    image = 256
    feats = _pyramid(rng, b=2, c=8, sizes=(64, 32, 16, 8))
    yx = rng.rand(48, 2) * 0.7
    bx = np.concatenate([yx, yx + rng.rand(48, 2) * 0.25 + 0.02], 1).astype(np.float32)
    bidx = rng.randint(0, 2, 48).astype(np.int32)
    jf = [jnp.asarray(f) for f in feats]
    lvl = jax_assign_fpn_level(jnp.asarray(bx), (image, image)) - 2
    assert int(hybrid_unfit_overflow(jf, jnp.asarray(bx), lvl, (7, 7))) == 0
    want = np.asarray(multilevel_crop_and_resize_window(
        jf, jnp.asarray(bx), jnp.asarray(bidx), (7, 7), (image, image), interpret=True))
    got = multilevel_crop_and_resize([T(f) for f in feats], T(bx), T(bidx), (7, 7),
                                     (image, image)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_roi_align_checks_its_inputs():
    f = [torch.zeros(1, 8, 8, 4)]
    with pytest.raises(ValueError):
        roi_align_fwd(f, torch.zeros(3, 5), torch.zeros(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32), (7, 7))
    with pytest.raises(TypeError):
        roi_align_fwd([torch.zeros(1, 8, 8, 4, dtype=torch.float64)], torch.zeros(3, 4),
                      torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                      (7, 7))


def test_plain_gather_is_the_cpu_path():
    rng = np.random.RandomState(11)
    feats = [T(f) for f in _pyramid(rng)]
    bx = T(_roi_boxes(rng, 16))
    bidx = torch.zeros(16, dtype=torch.int32)
    lvl = assign_fpn_level(bx, (IMG, IMG)) - 2
    torch.testing.assert_close(
        roi_align_fwd(feats, bx, bidx, lvl, (7, 7)),
        multilevel_gather_plain(feats, bx, bidx, lvl, (7, 7)), rtol=0, atol=0)


# --- the forward kernel's plan, vector width and algorithm -----------------------------
INT_MAX = 2 ** 31 - 1


@pytest.mark.parametrize("channels", [3, 8, 256, 2048])
@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (14, 14), (5, 9)])
def test_fwd_plan_covers_every_sample_row_once_within_the_launch_limits(crop, channels):
    ch, cw = crop
    for vec in (1, 4) if channels % 4 == 0 else (1,):
        for n in (1, 2, 7, 100, 2000, 100_000):
            rows, blocks, shared = fwd_plan(n, crop, channels, vec)
            first = np.arange(blocks, dtype=np.int64) * rows
            count = np.minimum(rows, n * ch - first)
            # every (box, sample row) in exactly one block
            cover = np.zeros(n * ch + 1, np.int64)
            np.add.at(cover, first, 1)
            np.add.at(cover, first + count, -1)
            assert (count >= 1).all() and (np.cumsum(cover)[:-1] == 1).all()
            # the staged taps of each block fit the shared memory of the launch
            boxes_here = (first + count - 1) // ch - first // ch + 1
            assert (count * FWD_ROW_BYTES + boxes_here * cw * FWD_COL_BYTES <= shared).all()
            assert shared == fwd_shared_bytes(rows, crop) <= FWD_SHARED_BYTES
            # the grid and the block's flat indices fit an int
            assert blocks <= INT_MAX and n * ch <= INT_MAX
            assert rows * cw * (channels // vec) <= INT_MAX - 4 * FWD_THREADS
            # about FWD_VECTORS output vectors, at least one row, unless shared
            # memory is the limit
            row = cw * (channels // vec)
            assert (rows == max(1, FWD_VECTORS // row)
                    or fwd_shared_bytes(rows + 1, crop) > FWD_SHARED_BYTES)
    for name in ("roi_align_fwd", "crop_and_resize"):   # K1, and K4/K5, which stage alike
        source = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        assert f"kThreads = {FWD_THREADS};" in source
        assert f"kSharedLimit = {FWD_SHARED_BYTES // 1024} * 1024;" in source
        assert "fwd_shared_bytes counts 32 and 16 bytes" in source


def _at(offset_floats, shape):
    """A contiguous float32 tensor of ``shape`` that starts ``offset_floats``
    floats into a fresh buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset_floats)[offset_floats:].view(*shape)


@pytest.mark.parametrize("offsets, channels, width", [
    ((0, 0, 0), 256, 4), ((4, 8, 0), 8, 4),     # every level and the crops 16-byte aligned
    ((0, 0, 0), 3, 1), ((0, 0, 0), 6, 1),       # channel counts that are not a multiple of 4
    ((1, 0, 0), 256, 1),                         # a level 4 bytes off a 16-byte boundary
    ((0, 0, 2), 256, 1)])                        # the crops 8 bytes off one
def test_fwd_vector_width(offsets, channels, width):
    *levels, out = offsets
    features = [_at(o, (1, s, s, channels)) for o, s in zip(levels, (8, 4))]
    crops = _at(out, (5, 7, 7, channels))
    assert [(f.data_ptr() % 16 == 0) for f in features] == [o % 4 == 0 for o in levels]
    assert fwd_vector_width(features, crops) == width


def _kernel_taps(c0, c1, crop, idx, dim):
    """roi_align_taps.cuh: ``sample_position`` then ``corner_taps`` for
    sample ``idx`` of each staged entry -> lo, hi (int64), lerp, valid."""
    dm1 = dim - 1.0
    if crop > 1:
        step = ((c1 - c0) * dm1) * reciprocal(crop)
        pos = _fma(idx.float(), step, c0 * dm1)
    else:
        pos = (0.5 * (c0 + c1)) * dm1
    lo = torch.floor(pos)
    clamp = lambda v: torch.minimum(torch.maximum(v, torch.zeros_like(v)), dm1).long()  # noqa: E731
    return clamp(lo), clamp(torch.ceil(pos)), pos - lo, (pos >= 0.0) & (pos <= dm1)


def _fwd_kernel_model(features, boxes, bidx, lidx, crop, extrap, vec):
    """csrc/roi_align_fwd.cu in torch: the plan's blocks; each block's staged
    row taps (map rows as vector offsets into its level) and the x taps of
    the boxes it touches; then each thread's outputs, index for index, with
    the kernel's roundings. Returns the crops and how often each output
    vector was written."""
    n, (ch, cw) = boxes.shape[0], crop
    nb, _, _, c = features[0].shape
    cv = c // vec
    rows_pb, blocks, _ = fwd_plan(n, crop, c, vec)
    maps = [f.reshape(-1, vec) for f in features]
    heights = torch.tensor([float(f.shape[1]) for f in features])
    widths = torch.tensor([f.shape[2] for f in features])
    out = torch.full((n * ch * cw * cv, vec), float("nan"))
    written = torch.zeros(n * ch * cw * cv, dtype=torch.int64)
    lvl = lidx.long().clamp(0, len(features) - 1)
    img = bidx.long().clamp(0, nb - 1)
    for block in range(blocks):
        first = block * rows_pb
        count = min(rows_pb, n * ch - first)
        box0 = first // ch
        boxes_here = (first + count - 1) // ch - box0 + 1
        # staged y taps of the block's rows
        r = torch.arange(count) + first
        rn, ri = r // ch, r % ch
        ylo, yhi, ly, vy = _kernel_taps(boxes[rn, 0], boxes[rn, 2], ch, ri, heights[lvl[rn]])
        row = widths[lvl[rn]] * cv
        base = img[rn] * heights[lvl[rn]].long() * row
        top, bot, cols = base + ylo * row, base + yhi * row, (rn - box0) * cw
        # staged x taps of the boxes it touches
        u = torch.arange(boxes_here * cw)
        un, uj = box0 + u // cw, u % cw
        xlo, xhi, lx, vx = _kernel_taps(boxes[un, 1], boxes[un, 3], cw, uj,
                                        widths[lvl[un]].float())
        xlo, xhi = xlo * cv, xhi * cv
        # thread t takes outputs t, t + 256, ...: it divides once for its
        # first (row, column, vector) and then steps them by the digits of
        # 256, one carry per digit at most
        total, row_vecs = count * cw * cv, cw * cv
        t = torch.arange(FWD_THREADS)
        dr = FWD_THREADS // row_vecs
        dj = (FWD_THREADS - dr * row_vecs) // cv
        dk = FWD_THREADS - dr * row_vecs - dj * cv
        er, j, k = t // row_vecs, t % row_vecs // cv, t % cv
        steps = []
        for step in range(-(-total // FWD_THREADS)):
            e = t + step * FWD_THREADS
            live = e < total
            steps.append((e[live], er[live], j[live], k[live]))
            k, j, er = k + dk, j + dj, er + dr
            j, k = j + (k >= cv).long(), torch.where(k >= cv, k - cv, k)
            er, j = er + (j >= cw).long(), torch.where(j >= cw, j - cw, j)
        e, er, j, k = (torch.cat(v) for v in zip(*steps))
        assert torch.equal((er * cw + j) * cv + k, e) and bool((k < cv).all() & (j < cw).all())
        col = cols[er] + j
        level = lvl[rn[er]]
        ok = vy[er] & vx[col]
        vals = []
        for rows_at, xs in ((top, xlo), (top, xhi), (bot, xlo), (bot, xhi)):
            at = rows_at[er] + xs[col] + k
            v = torch.zeros((e.numel(), vec))
            for lv, m in enumerate(maps):
                sel = ok & (level == lv)
                v[sel] = m[at[sel]]
            vals.append(v)
        tl, tr, bl, br = vals
        lxe, lye = lx[col][:, None], ly[er][:, None]
        t = _fma(tr - tl, lxe, tl)
        d = _fma(br - bl, lxe, bl)
        v = torch.where(ok[:, None], _fma(d - t, lye, t), torch.tensor(float(extrap)))
        out[first * cw * cv + e] = v
        written[first * cw * cv + e] += 1
    return out.reshape(n, ch, cw, c), written


@pytest.mark.parametrize("crop, channels, extrap, vec, levels", [
    ((7, 7), 16, 0.0, 4, 4), ((14, 14), 16, 0.0, 4, 4), ((1, 1), 16, 0.0, 4, 4),
    ((5, 9), 16, -1.5, 4, 4), ((7, 7), 3, 0.0, 1, 4), ((5, 9), 6, -1.5, 1, 4),
    ((14, 14), 16, 0.0, 1, 4), ((14, 14), 8, 0.0, 4, 1)])
def test_fwd_kernel_model_matches_plain_and_jax(crop, channels, extrap, vec, levels):
    """The kernel's algorithm, walked block by block and thread by thread
    (:func:`_fwd_kernel_model`), equals the plain version bit for bit and
    the JAX gather within 1e-5, on boxes out of range, inverted and
    degenerate, over four levels or one."""
    rng = np.random.RandomState(13)
    feats = _pyramid(rng, c=channels)[:levels]
    bx = _roi_boxes(rng, 120)
    bidx = rng.randint(0, 2, 120).astype(np.int32)
    lvl = rng.randint(0, levels, 120).astype(np.int32)
    tf = [T(f) for f in feats]
    got, written = _fwd_kernel_model(tf, T(bx), T(bidx), T(lvl), crop, extrap, vec)
    assert bool((written == 1).all())
    plain = multilevel_gather_plain(tf, T(bx), T(bidx), T(lvl), crop, extrap)
    assert torch.equal(got, plain)
    flat, hs, ws, offs = flatten_pyramid([jnp.asarray(f) for f in feats])
    want = np.asarray(_multilevel_gather(flat, hs, ws, offs, jnp.asarray(bx), jnp.asarray(bidx),
                                         jnp.asarray(lvl), crop, extrapolation_value=extrap))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if extrap:
        assert bool((got == extrap).any())


# --- detection layer ------------------------------------------------------------------
def test_detection_layer_matches_jax():
    rng = np.random.RandomState(12)
    b, r, k = 2, 48, 8
    rois = np.sort(rng.rand(b, r, 4).astype(np.float32).reshape(b, r, 2, 2), axis=2)
    rois = rois.transpose(0, 1, 3, 2).reshape(b, r, 4)
    logits = rng.randn(b, r, k).astype(np.float32) * 2
    probs = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    probs[0, :4] = probs[0, 4]                    # tied rows
    deltas = (rng.randn(b, r, k, 4) * 0.3).astype(np.float32)
    windows = np.array([[0, 0, 128, 128], [16, 0, 112, 128]], np.float32)
    std = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    got = detection_layer(T(rois), T(probs), T(deltas), T(windows), std, (IMG, IMG),
                          max_instances=10, nms_threshold=0.3, min_confidence=0.0)
    want = jax_detection_layer(jnp.asarray(rois), jnp.asarray(probs), jnp.asarray(deltas),
                               jnp.asarray(windows), jnp.asarray(std), (IMG, IMG),
                               max_instances=10, nms_threshold=0.3, min_confidence=0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any()
