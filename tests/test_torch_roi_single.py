"""The port's single-level RoI pooling (K4, K5, the fused gradient), its
window sum (K6) and ``tools/profile_roi.py``, against the JAX package on the
CPU.

The JAX Pallas kernels run in interpret mode, as ``tests/test_roi_align.py``
runs them; the window probe's ``window_dma_checksum`` is imported from
``scripts/profile_window_dma.py`` by path. On CPU tensors the port's
wrappers run their kernels' plain versions.

Tolerances: K4 and K5 within 1e-5 absolute (the JAX kernels' sample
positions and products may round differently under XLA); the fused
gradient within 1e-5 absolute; K6 within 1e-6 (float32) and 1e-5
(bfloat16) of each window's sum of magnitudes.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import feature_intertwiner_tpu.ops.roi_align as jax_ra
from feature_intertwiner_tpu_torch.ops import cuda_build
from feature_intertwiner_tpu_torch.ops import roi_align as ra
from feature_intertwiner_tpu_torch.ops import window_sum as ws
from feature_intertwiner_tpu_torch.ops.window_sum import window_sum, window_sum_plain
from feature_intertwiner_tpu_torch.tools import profile_roi

T = torch.from_numpy
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "profile_window_dma", os.path.join(ROOT, "scripts", "profile_window_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grouped_boxes(rng, b, nb, lo=-0.3, hi=1.1):
    """Boxes per image with out-of-range, inverted and degenerate ones."""
    y1x1 = rng.uniform(lo, hi, (b, nb, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(-0.3, 0.6, (b, nb, 2))], -1)
    boxes[0, 0] = [0.3, 0.3, 0.3, 0.3]          # a point
    boxes[0, 1] = [0.8, 0.8, 0.2, 0.2]          # inverted
    boxes[1, 0] = [0.0, 0.0, 1.0, 1.0]          # the whole map
    boxes[1, 1] = [-1.0, -1.0, -0.5, -0.5]      # fully outside
    return boxes.astype(np.float32)


@pytest.fixture(scope="module")
def crop_case():
    rng = np.random.RandomState(11)
    image = rng.randn(2, 16, 20, 8).astype(np.float32)
    return image, _grouped_boxes(rng, 2, 8)


@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (5, 9)])
@pytest.mark.parametrize("extrap", [0.0, -1.5])
def test_grouped_crop_matches_pallas_kernel(crop_case, crop, extrap):
    image, boxes = crop_case
    want = np.asarray(jax_ra.crop_and_resize_pallas(
        jnp.asarray(image), jnp.asarray(boxes), crop, extrap, box_tile=4, channel_tile=8,
        interpret=True))
    got = ra.crop_and_resize_grouped(T(image), T(boxes), crop, extrap).numpy()
    assert got.shape == want.shape == (2, 8, *crop, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if extrap:
        assert (got == extrap).any()


@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (5, 9)])
def test_grouped_mm_crop_matches_pallas_kernel(crop_case, crop):
    image, boxes = crop_case
    want = np.asarray(jax_ra.crop_and_resize_pallas_mm(
        jnp.asarray(image), jnp.asarray(boxes), crop, box_tile=4, channel_tile=8,
        interpret=True))
    got = ra.crop_and_resize_grouped_mm(T(image), T(boxes), crop).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the same function as K4 with extrapolation 0
    k4 = ra.crop_and_resize_grouped(T(image), T(boxes), crop).numpy()
    np.testing.assert_allclose(got, k4, rtol=0, atol=1e-5)


def _grouped_axis_taps(c0, c1, crop, idx, dim):
    """csrc/crop_and_resize.cu: ``sample_pos`` (a true division, no fused
    multiply-add) then ``axis_taps`` for sample ``idx`` of each staged entry
    -> lo, hi (int64), frac, valid."""
    dm1 = torch.tensor(float(dim - 1))
    if crop > 1:
        step = ((c1 - c0) * dm1) / torch.tensor(float(crop - 1))
        pos = c0 * dm1 + idx.float() * step
    else:
        pos = (0.5 * (c0 + c1)) * dm1
    lo = torch.floor(pos)
    clamp = lambda v: torch.minimum(torch.maximum(v, torch.zeros_like(v)), dm1).long()  # noqa: E731
    return clamp(lo), clamp(torch.ceil(pos)), pos - lo, (pos >= 0.0) & (pos <= dm1)


def _grouped_kernel_model(image, boxes, crop, extrap, vec):
    """csrc/crop_and_resize.cu in torch, as K4 (``extrap`` a float) or K5
    (``extrap`` None): the ``fwd_plan`` blocks over the flat (box, sample
    row) list; each block's staged row taps (map rows as vector offsets into
    the flat image) and the x taps of the boxes it touches; then each
    thread's outputs, stepped by the digits of 256 as the kernel steps them,
    V-wide loads and the kernel's lerps. Returns the crops and how often each
    output vector was written."""
    b, h, w, c = image.shape
    nb, (ch, cw) = boxes.shape[1], crop
    assert vec == 1 or (c % 4 == 0 and image.data_ptr() % 16 == 0)   # the entry refuses it
    cv, map_row = c // vec, w * (c // vec)
    rows_pb, blocks, shared = ra.fwd_plan(b * nb, crop, c, vec)
    pixels = image.reshape(-1, vec)
    flat = boxes.reshape(-1, 4)
    out = torch.full((b * nb * ch * cw * cv, vec), float("nan"))
    written = torch.zeros(out.shape[0], dtype=torch.int64)
    for block in range(blocks):
        first = block * rows_pb
        count = min(rows_pb, b * nb * ch - first)
        box0 = first // ch
        boxes_here = (first + count - 1) // ch - box0 + 1
        assert count * ra.FWD_ROW_BYTES + boxes_here * cw * ra.FWD_COL_BYTES <= shared
        # staged y taps of the block's rows, x taps of the boxes it touches
        rn = torch.arange(first, first + count) // ch
        ylo, yhi, fy, vy = _grouped_axis_taps(flat[rn, 0], flat[rn, 2], ch,
                                              torch.arange(first, first + count) - rn * ch, h)
        img = (rn // nb) * h * map_row
        top, bot, cols = img + ylo * map_row, img + yhi * map_row, (rn - box0) * cw
        u = torch.arange(boxes_here * cw)
        xlo, xhi, fx, vx = _grouped_axis_taps(flat[box0 + u // cw, 1], flat[box0 + u // cw, 3],
                                              cw, u % cw, w)
        xlo, xhi = xlo * cv, xhi * cv
        # thread t takes outputs t, t + 256, ...: one division for its first
        # (row, column, vector), then a step by the digits of 256
        total, row_vecs = count * cw * cv, cw * cv
        t = torch.arange(ra.FWD_THREADS)
        dr = ra.FWD_THREADS // row_vecs
        dj = (ra.FWD_THREADS - dr * row_vecs) // cv
        dk = ra.FWD_THREADS - dr * row_vecs - dj * cv
        r, j, k = t // row_vecs, t % row_vecs // cv, t % cv
        steps = []
        for step in range(-(-total // ra.FWD_THREADS)):
            live = t + step * ra.FWD_THREADS < total
            steps.append((t[live] + step * ra.FWD_THREADS, r[live], j[live], k[live]))
            k, j, r = k + dk, j + dj, r + dr
            j, k = j + (k >= cv).long(), torch.where(k >= cv, k - cv, k)
            r, j = r + (j >= cw).long(), torch.where(j >= cw, j - cw, j)
        e, r, j, k = (torch.cat(v) for v in zip(*steps))
        assert torch.equal((r * cw + j) * cv + k, e)
        col = cols[r] + j
        ok = vy[r] & vx[col]
        tl, tr, bl, br = (torch.where(ok[:, None], pixels[torch.where(ok, at, 0)], 0.0)
                          for at in (top[r] + xlo[col] + k, top[r] + xhi[col] + k,
                                     bot[r] + xlo[col] + k, bot[r] + xhi[col] + k))
        ly, lx = fy[r][:, None], fx[col][:, None]
        if extrap is None:   # K5: the top (left) tap alone where its lerp is 0
            wy = 1.0 - ly
            rl = torch.where(ly == 0.0, tl, wy * tl + ly * bl)
            rr = torch.where(ly == 0.0, tr, wy * tr + ly * br)
            v = torch.where(lx == 0.0, rl, (1.0 - lx) * rl + lx * rr)
        else:
            rl = tl + (bl - tl) * ly
            rr = tr + (br - tr) * ly
            v = (1.0 - lx) * rl + lx * rr
        out[first * row_vecs + e] = torch.where(ok[:, None], v, torch.tensor(extrap or 0.0))
        written[first * row_vecs + e] += 1
    return out.reshape(b, nb, ch, cw, c), written


@pytest.mark.parametrize("crop", [(1, 1), (7, 7), (5, 9)])
@pytest.mark.parametrize("extrap", [0.0, -1.5, None], ids=["K4-0", "K4-1.5", "K5"])
@pytest.mark.parametrize("channels, vec", [(5, 1), (64, 4)])
def test_grouped_kernel_model_matches_plain(crop, extrap, channels, vec):
    """The shared K4/K5 body, walked block by block and thread by thread
    (:func:`_grouped_kernel_model`), equals the plain version bit for bit and
    writes every output once: boxes out of range, inverted and degenerate,
    a ragged last block, and (crops taller than 1) a box whose sample rows
    span two blocks."""
    rng = np.random.RandomState(16)
    image = T(rng.randn(2, 12, 15, channels).astype(np.float32))
    boxes = T(_grouped_boxes(rng, 2, 11))
    rows, blocks, _ = ra.fwd_plan(22, crop, channels, vec)
    assert 22 * crop[0] % rows                                    # a ragged last block
    assert crop[0] == 1 or rows % crop[0]                         # a box over two blocks
    got, written = _grouped_kernel_model(image, boxes, crop, extrap, vec)
    assert bool((written == 1).all())
    if extrap is None:
        want = ra.crop_and_resize_grouped_mm_plain(image, boxes, crop)
    else:
        want = ra.crop_and_resize_grouped_plain(image, boxes, crop, extrap)
        assert not extrap or bool((got == extrap).any())
    assert torch.equal(got, want)


@pytest.mark.parametrize("extrap", [0.0, -1.5])
def test_fused_gradient_matches_jax(monkeypatch, extrap):
    """``jax.grad`` through JAX's ``crop_and_resize_fused`` (its Pallas
    forward in interpret mode) and the port's autograd gradient."""
    real = jax_ra.crop_and_resize_pallas

    def interpreted(image, boxes, crop_size, extrapolation_value=0.0):
        return real(image, boxes, crop_size, extrapolation_value, box_tile=4, channel_tile=4,
                    interpret=True)

    monkeypatch.setattr(jax_ra, "crop_and_resize_pallas", interpreted)
    rng = np.random.RandomState(12)
    image = rng.randn(2, 10, 12, 4).astype(np.float32)
    y1x1 = rng.uniform(-0.1, 0.6, (2, 4, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(0.2, 0.5, (2, 4, 2))], -1).astype(np.float32)
    weight = rng.randn(2, 4, 5, 6, 4).astype(np.float32)

    def loss(img):
        return jnp.sum(jax_ra.crop_and_resize_fused(img, jnp.asarray(boxes), (5, 6), extrap)
                       * weight)

    want = np.asarray(jax.grad(loss)(jnp.asarray(image)))
    x = T(image.copy()).requires_grad_(True)
    out = ra.crop_and_resize_fused(x, T(boxes), (5, 6), extrap)
    (out * T(weight)).sum().backward()
    assert x.grad.shape == image.shape
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("window", [(8, 8), (8, 16), (4, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_sum_matches_jax_probe(window, dtype):
    probe = _probe_module()
    rng = np.random.RandomState(13)
    b, h, w, c, n = 2, 20, 40, 16, 8
    sy, sx = window
    jimg = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32), getattr(jnp, dtype))
    origins = np.stack([rng.randint(0, b, n), rng.randint(0, h - sy + 1, n),
                        rng.randint(0, (w - sx) // 8 + 1, n)], 1).astype(np.int32)
    want = np.asarray(probe.window_dma_checksum(jimg, jnp.asarray(origins), sy, sx, bt=4,
                                                interpret=True))
    img = T(np.array(jimg.astype(jnp.float32))).to(getattr(torch, dtype))
    got = window_sum(img, T(origins), sy, sx).numpy()
    mag = window_sum_plain(img.abs(), T(origins), sy, sx).numpy()
    tol = 1e-6 if dtype == "float32" else 1e-5
    assert got.shape == (n, c) and got.dtype == np.float32
    assert (np.abs(got - want) / mag).max() <= tol


def test_window_sum_plain_order_and_edges():
    """The plain version adds row-major, pixel by pixel; a window that
    leaves the map gives NaN."""
    rng = np.random.RandomState(14)
    img = T(rng.randn(1, 6, 16, 4).astype(np.float32))
    origins = T(np.array([[0, 1, 1], [0, 4, 0], [1, 0, 0]], np.int32))
    got = window_sum(img, origins, 3, 5)
    want = torch.zeros(4)
    for y in range(3):
        for x in range(5):
            want = want + img[0, 1 + y, 8 + x]
    assert torch.equal(got[0], want)
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()   # y past H, b past B


def _window_kernel_model(img, origins, sy, sx, plan):
    """csrc/window_sum.cu in torch. A group of one: each window's warp adds
    its pixels row by row from the map. A larger group: the windows sorted
    by ``b * H + y0`` (leavers last), then per (group, chunk) block the union
    of its windows' row ranges and its x range, the staged pieces (two
    buffers, the next piece loaded while one is summed), and each
    thread's (window, V channels) items adding the pixels of their window in
    each piece, in the kernel's order. Returns the sums and how often each
    (window, V channels) was written."""
    b, h, w, c = img.shape
    n, g, piece, vec = origins.shape[0], plan.group, plan.piece, plan.vec
    chunk, lanes = plan.chunk, ws.WINDOW_LANES
    assert chunk == lanes * vec and c % vec == 0
    o = origins.long()
    bi, y0, x0 = o[:, 0], o[:, 1], 8 * o[:, 2]
    inside = (bi >= 0) & (bi < b) & (y0 >= 0) & (y0 + sy <= h) & (x0 >= 0) & (x0 + sx <= w)
    rows = img.reshape(b * h, w, c)
    out = torch.full((n, c), float("nan"))
    written = torch.zeros((n, c // vec), dtype=torch.int64)
    lane_ch = vec * torch.arange(lanes)[:, None] + torch.arange(vec)      # [lanes, vec]
    if g == 1:                                                            # read directly
        per_block = ws.WINDOW_THREADS // lanes
        assert plan.blocks == -(-n // per_block) * -(-c // chunk) and plan.shared == 0
        for j in range(n):
            for c0 in range(0, c, chunk):
                live = c0 + lane_ch[:, 0] < c
                acc = torch.zeros((lanes, vec))
                if inside[j]:
                    for y in range(sy):
                        for x in range(sx):
                            px = rows[bi[j] * h + y0[j] + y, x0[j] + x]
                            acc = acc + px[(c0 + lane_ch).clamp(max=c - 1)].float()
                else:
                    acc[:] = float("nan")
                ch = c0 + lane_ch[live]
                out[j, ch] = acc[live]
                written[j, ch[:, 0] // vec] += 1
        return out, written
    assert plan.shared == ws.window_shared_bytes(g, chunk, piece, img.element_size())
    key = torch.where(inside, bi * h + y0, torch.full_like(bi, b * h))
    order = torch.argsort(key, stable=True)
    assert 1 < g <= ws.WINDOW_GROUP
    i = torch.arange(ws.WINDOW_GROUP * lanes)              # item k * kThreads + thread
    j, p = i // lanes, i % lanes
    assert plan.blocks == -(-n // g) * -(-c // chunk)
    for g0 in range(0, n, g):
        win = order[g0:g0 + g]
        count = win.shape[0]
        start = torch.where(inside[win], key[win], torch.full_like(win, 2 ** 31 - 1))
        wx = torch.where(inside[win], x0[win], torch.zeros_like(win))
        segs = []                                           # thread 0's union of row ranges
        for s in start.tolist():
            if s == 2 ** 31 - 1:
                continue
            if segs and s <= segs[-1][1]:
                segs[-1][1] = max(segs[-1][1], s + sy)
            else:
                segs.append([s, s + sy])
        valid = start != 2 ** 31 - 1
        xlo = int(wx[valid].min()) if segs else 0
        xhi = int(wx[valid].max()) + sx if segs else 0
        units = [(r, xa) for lo, hi in segs for r in range(lo, hi) for xa in range(xlo, xhi, piece)]
        for c0 in range(0, c, chunk):
            cc = min(chunk, c - c0)
            live = (j < count) & (vec * p < cc)
            jj, pp = torch.where(live, j, 0), torch.where(live, p, 0)
            acc = torch.zeros((i.shape[0], vec))
            ring = [None] * 2

            def issue(u):
                if u < len(units):
                    r, xa = units[u]
                    ring[u % 2] = (u, rows[r, xa:min(xa + piece, xhi), c0:c0 + cc].clone())

            issue(0)
            for u, (r, xa) in enumerate(units):
                issue(u + 1)                                # into piece u - 1's buffer
                tag, buf = ring[u % 2]
                assert tag == u and buf.shape[0] <= piece
                s = start[jj]
                cover = live & (r >= s) & (r < s + sy)
                a = torch.maximum(wx[jj], torch.tensor(xa))
                e = torch.minimum(wx[jj] + sx, torch.tensor(xa + buf.shape[0]))
                for dx in range(buf.shape[0]):
                    m = cover & (a + dx < e)
                    at = torch.where(m, a + dx - xa, 0)
                    lane = buf[at[:, None], (vec * pp)[:, None] + torch.arange(vec)].float()
                    acc[m] = acc[m] + lane[m]
            n_of = win[jj[live]]
            ch = c0 + vec * p[live]
            val = torch.where(inside[n_of][:, None], acc[live], torch.tensor(float("nan")))
            out[n_of[:, None], ch[:, None] + torch.arange(vec)] = val
            written[n_of, ch // vec] += 1
    return out, written


def _window_case(name):
    """(map, origins, sy, sx, plan) of one hard case of the window kernel."""
    rng = np.random.RandomState(17)
    dtype = torch.float32 if name.startswith("fp32") else torch.bfloat16
    item = 4 if dtype == torch.float32 else 2
    b, h, w, c, sy, sx = 2, 10, 32, 8, 3, 5
    if name.endswith("straddle"):       # one group over both images, touching and with a gap
        org = [[1, 5, 1], [0, 6, 1], [1, 0, 2], [0, 0, 2], [1, 1, 0], [0, 7, 0]]
        group = 4
    elif name.endswith("leavers"):      # six out of the map (b, y, x, each side) among valid ones
        org = [[0, 1, 0], [-1, 0, 0], [0, 8, 0], [1, 2, 3], [2, 0, 0], [0, -1, 1], [1, 0, 4],
               [0, 3, -1], [1, 4, 1]]
        group = 4
    elif name.endswith("repeats"):
        org = [[1, 2, 1]] * 5 + [[0, 2, 1], [1, 2, 1]]
        group = 4
    elif name.endswith("sx12"):         # pieces of 8 pixels; runs of 8 loads and fewer
        sx, sy = 12, 4
        org = rng.randint(0, [b, h - sy + 1, (w - sx) // 8 + 1], (11, 3)).tolist()
        group = 8
    elif name.endswith("c66"):          # V = 2 and a ragged last chunk of 2 channels
        c = 66
        org = rng.randint(0, [b, h - sy + 1, (w - sx) // 8 + 1], (9, 3)).tolist()
        group = 4
    elif "direct-one" in name:          # one channel a lane: C = 3, or a map off a channel pair
        c = 3 if name.endswith("c3") else 8
        sy, sx = (24, 24) if "big" in name else (2, 3)     # 576 pixels: staged were C even
        h, w = 30, 40
        org = rng.randint(0, [b, h - sy + 1, (w - sx) // 8 + 1], (7, 3)).tolist()
        org[2] = [1, h - sy + 1, 0]                         # leaves the map
        origins = T(np.array(org, np.int32))
        n = b * h * w * c
        flat = T(rng.randn(n + 1).astype(np.float32)).to(dtype)
        img = (flat[1:] if name.endswith("odd") else flat[:n]).view(b, h, w, c)
        vec = ws.window_vec(img)
        assert vec == 1 and img.is_contiguous()
        return img, origins, sy, sx, ws.window_plan(len(org), sy, sx, c, dtype, w, vec)
    else:                               # the plan's own: read directly, 66 channels for V = 2
        sy, sx = 2, 3
        c = 66 if name.endswith("66") else 8
        org = rng.randint(0, [b, h - sy + 1, (w - sx) // 8 + 1], (5, 3)).tolist()
        org[1] = [0, h - 1, 0]                              # leaves the map
        origins = T(np.array(org, np.int32))
        img = T(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
        return img, origins, sy, sx, ws.window_plan(len(org), sy, sx, c, dtype, w)
    n = len(org)
    piece = 8 if name.endswith("sx12") else 16
    vec = 4 if c % 4 == 0 else 2
    plan = ws.WindowPlan(group, piece, vec, 32 * vec, -(-n // group) * -(-c // (32 * vec)),
                         ws.window_shared_bytes(group, 32 * vec, piece, item))
    origins = T(np.array(org, np.int32).reshape(n, 3))
    img = T(rng.randn(b, h, w, c).astype(np.float32)).to(dtype)
    return img, origins, sy, sx, plan


@pytest.mark.parametrize("name", ["bf16-straddle", "fp32-straddle", "bf16-leavers", "bf16-repeats",
                                  "bf16-sx12", "fp32-sx12", "bf16-c66", "fp32-c66", "bf16-direct",
                                  "fp32-direct", "bf16-direct66", "bf16-direct-one-c3",
                                  "fp32-direct-one-c3", "bf16-direct-one-big-c3",
                                  "bf16-direct-one-odd", "fp32-direct-one-big-odd"])
def test_window_kernel_model_matches_plain(name):
    """The window kernel walked block by block (:func:`_window_kernel_model`)
    equals the plain version bit for bit, NaN included, and writes every
    (window, pair) once: a group over two images (touching rows and a gap),
    windows that leave the map among valid ones, repeated origins, sx 5 and
    12 over several pieces, C = 66 (V = 2, a ragged last chunk), N not a
    multiple of the group, float32 and bfloat16, and the plan's groups of
    one, read directly; and one channel a lane (V = 1, read directly at
    any window size) on C = 3 and on a map one channel off a pair."""
    img, origins, sy, sx, plan = _window_case(name)
    n = origins.shape[0]
    assert n % plan.group or plan.group == 1
    assert (plan.group == 1) == ("direct" in name)
    got, written = _window_kernel_model(img, origins, sy, sx, plan)
    want = window_sum_plain(img, origins, sy, sx)
    assert bool((written == 1).all())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if name.endswith("leavers"):
        assert int(torch.isnan(got[:, 0]).sum()) == 6
    if name.endswith("straddle"):     # the first group holds windows of both images
        key = origins[:, 0] * img.shape[1] + origins[:, 1]
        assert set(origins[torch.argsort(key, stable=True)[:4], 0].tolist()) == {0, 1}


def test_window_kernel_model_no_windows():
    img = torch.zeros((1, 4, 8, 4), dtype=torch.bfloat16)
    origins = torch.zeros((0, 3), dtype=torch.int32)
    for sy in (2, 16):                  # read directly; staged
        plan = ws.window_plan(0, sy, sy, 4, img.dtype, 8)
        got, written = _window_kernel_model(img, origins, sy, sy, plan)
        assert plan.blocks == 0 and got.shape == (0, 4) and written.numel() == 0
    assert window_sum(img, origins, 2, 2).shape == (0, 4)


@pytest.mark.parametrize("channels", [2, 66, 256, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_plan_fits_and_covers(channels, dtype):
    """The plan's shared memory fits the card, its chunks cover C, its
    blocks cover N, and its threads hold at most the kernel's items, for
    windows 1x1 to 64x64 and maps 16 to 4,096 pixels wide; the constants
    are those of csrc/window_sum.cu."""
    item = torch.empty((), dtype=dtype).element_size()
    for sy, sx in [(1, 1), (1, 64), (64, 1), (5, 12), (8, 8), (8, 16), (16, 16), (16, 32),
                   (32, 32), (32, 64), (64, 64)]:
        for w in (16, 256, 4096):
            for n in (1, 63, 4096, 100_000):
                for vec in (2, 4):
                    plan = ws.window_plan(n, sy, sx, channels, dtype, w, vec)
                    staged = sy * sx >= ws.WINDOW_GROUP_AREA
                    assert plan.vec == (vec if channels % 4 == 0 and staged else 2)
                    assert (plan.group > 1) == staged
                    assert plan.chunk == ws.WINDOW_LANES * plan.vec
                    chunks = -(-channels // plan.chunk)
                    assert chunks * plan.chunk >= channels > (chunks - 1) * plan.chunk
                    assert chunks <= 65535
                    per_block = plan.group if plan.group > 1 else ws.WINDOW_THREADS // 32
                    assert plan.blocks == -(-n // per_block) * chunks
                    assert plan.blocks * per_block >= n * chunks
                    assert plan.group in (1, ws.WINDOW_GROUP)
                    if plan.group == 1:
                        assert plan.shared == 0 and sy * sx < ws.WINDOW_GROUP_AREA
                        continue
                    assert plan.shared <= ws.WINDOW_SHARED_BYTES
                    assert plan.shared == window_shared(plan, item)
                    assert 1 <= plan.piece <= w
    source = (cuda_build.CSRC_DIR / "window_sum.cu").read_text()
    assert f"kThreads = {ws.WINDOW_THREADS};" in source
    assert f"kLanes = {ws.WINDOW_LANES};" in source
    assert f"kGroup = {ws.WINDOW_GROUP};" in source
    assert f"kSharedLimit = {ws.WINDOW_SHARED_BYTES};" in source
    assert f"kMetaInts = {ws.WINDOW_META_INTS};" in source
    assert "window_shared_bytes counts the same" in source


def window_shared(plan, item):
    return ws.window_shared_bytes(plan.group, plan.chunk, plan.piece, item)


@pytest.mark.parametrize("offset, channels, vec", [
    (0, 256, 4), (4, 8, 4),            # 4-channel aligned
    (0, 6, 2), (0, 66, 2),             # C not a multiple of 4
    (2, 256, 2), (6, 8, 2),            # views 2 and 6 channels off a 4-channel boundary
    (0, 3, 1), (2, 5, 1),              # C odd
    (1, 8, 1), (3, 256, 1)])           # views 1 and 3 channels off a channel pair
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_vec(offset, channels, vec, dtype):
    n = 2 * 3 * channels
    img = torch.zeros(n + offset, dtype=dtype)[offset:].view(1, 2, 3, channels)
    paired = img.data_ptr() % (2 * img.element_size()) == 0
    assert img.is_contiguous() and paired == (offset % 2 == 0)
    assert ws.window_vec(img) == vec


@pytest.mark.parametrize("channels", [1, 3, 8, 257])
def test_window_plan_one_channel_a_lane(channels):
    """V = 1 (C odd, or a map off a channel pair) reads every window
    directly, 32 channels a chunk, at any window size; the C entry takes
    V = 1 only without staging."""
    for sy, sx in [(1, 1), (8, 8), (24, 24), (64, 64)]:
        for n in (1, 63, 100_000):
            plan = ws.window_plan(n, sy, sx, channels, torch.bfloat16, 256, 1)
            assert plan == ws.WindowPlan(1, 0, 1, ws.WINDOW_LANES,
                                         -(-n // 16) * -(-channels // ws.WINDOW_LANES), 0)
    source = (cuda_build.CSRC_DIR / "window_sum.cu").read_text()
    assert "(staged && vec == 1)" in source and "launch_direct<T, 1>" in source


def test_wrappers_run_plain_on_the_cpu_and_check_their_arguments():
    rng = np.random.RandomState(15)
    image = T(rng.randn(2, 8, 8, 4).astype(np.float32))
    boxes = T(_grouped_boxes(rng, 2, 3))
    cuda_build.launches.clear()
    assert torch.equal(ra.crop_and_resize_grouped(image, boxes, (3, 3), 2.0),
                       ra.crop_and_resize_grouped_plain(image, boxes, (3, 3), 2.0))
    assert torch.equal(ra.crop_and_resize_grouped_mm(image, boxes, (3, 3)),
                       ra.crop_and_resize_grouped_mm_plain(image, boxes, (3, 3)))
    origins = T(np.array([[0, 0, 0], [1, 2, 0]], np.int32))
    window_sum(image, origins, 4, 4)
    assert sum(cuda_build.launches.values()) == 0

    for fn in (ra.crop_and_resize_grouped, ra.crop_and_resize_grouped_mm):
        with pytest.raises(TypeError):
            fn(image.double(), boxes, (3, 3))
        # a bfloat16 map: the float32 crop of the widened map, rounded once
        got = fn(image.bfloat16(), boxes, (3, 3))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, fn(image.bfloat16().float(), boxes, (3, 3)).bfloat16())
        with pytest.raises(ValueError):
            fn(image, boxes.reshape(-1, 4), (3, 3))
        with pytest.raises(ValueError):
            fn(image, boxes[:1], (3, 3))
        with pytest.raises(ValueError):
            fn(image, boxes.to("meta"), (3, 3))
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(image.to("meta"), boxes.to("meta"), (3, 3))
    with pytest.raises(TypeError):
        window_sum(image.double(), origins, 2, 2)
    with pytest.raises(ValueError):
        window_sum(image, origins.long(), 2, 2)
    with pytest.raises(ValueError):
        window_sum(image, origins.to("meta"), 2, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_sum(image.to("meta"), origins.to("meta"), 2, 2)


def _map_at(offset_floats, channels, h=4, w=5):
    """A contiguous [1, h, w, channels] float32 map that starts
    ``offset_floats`` floats into a fresh buffer."""
    n = h * w * channels
    return torch.zeros(n + offset_floats)[offset_floats:].view(1, h, w, channels)


@pytest.mark.parametrize("offset, channels, width", [
    (0, 256, 4), (4, 8, 4),            # 16-byte aligned rows
    (0, 3, 1), (0, 6, 1),              # rows that start anywhere
    (1, 256, 1), (2, 256, 1), (3, 8, 1)])  # views 4, 8 and 12 bytes off a 16-byte boundary
def test_mm_vector_width(offset, channels, width):
    image = _map_at(offset, channels)
    assert image.is_contiguous() and image.shape[-1] == channels
    assert (image.data_ptr() % 16 == 0) == (offset % 4 == 0)
    assert ra.mm_vector_width(image) == width


# --- tools/profile_roi.py ------------------------------------------------------------
@pytest.mark.parametrize("command", ["crop", "stage", "window", "bwd", "nms", "fwd"])
def test_profile_roi_runs_small_on_the_cpu(command, capsys):
    rows = profile_roi.main([command, "--device", "cpu", "--batch", "2", "--boxes", "128",
                             "--size", "64", "--reps", "1"])
    text = capsys.readouterr().out
    assert text.startswith(f"{command} on cpu")
    assert rows and all(r["ms"] > 0 for r in rows)
    routes = " ".join(r["route"] for r in rows)
    if command == "crop":
        assert "(K4)" in routes and "(K5)" in routes and "grid_sample" in routes
    elif command == "stage":
        assert routes.count("(K1)") == 2 and "(K5) on P4 4², 128 per image" in routes
    elif command == "bwd":
        assert routes.count("K3)") == 4 and routes.count("(yardstick)") == 2
        assert "multilevel_gather_bwd_plain 14x14" in routes
        k3 = rows[0]["fn"](*rows[0]["args"])
        both = rows[1]["fn"](*rows[1]["args"])
        plain = rows[2]["fn"](*rows[2]["args"])
        assert [tuple(d.shape) for d in k3] == [(2, 16, 16, 256), (2, 8, 8, 256), (2, 4, 4, 256),
                                                 (2, 2, 2, 256)]
        for a, b2, c in zip(k3, both, plain):
            torch.testing.assert_close(a, c, rtol=0, atol=0)
            torch.testing.assert_close(b2, c, rtol=0, atol=1e-5)
        assert rows[3]["fn"](*rows[3]["args"]).shape == (2, 256, 16, 16)
    elif command == "nms":
        assert [r["route"] for r in rows] == [
            "nms_alive (K2) proposals [2, 128] thr 0.7",
            "greedy_alive_sorted_plain proposals [2, 128] thr 0.7",
            "nms_alive (K2) detections [2, 128] thr 0.3",
            "greedy_alive_sorted_plain detections [2, 128] thr 0.3"]
        for k2, plain in (rows[:2], rows[2:]):
            assert all(a is b for a, b in zip(k2["args"], plain["args"]))   # the same tensors
            assert torch.equal(k2["fn"](*k2["args"]), plain["fn"](*plain["args"]))
            assert k2["kept"] == plain["kept"]
        # clustered boxes: a share of the proposals survives, as on the inference path
        assert 0.2 < rows[0]["kept"] / 256 < 0.8
    elif command == "fwd":
        assert [r["route"] for r in rows][::3] == [
            "roi_align_fwd (K1) 7x7 on 256 proposals over P2-P5",
            "roi_align_fwd (K1) 14x14 on 200 detections over P2-P5"]
        for k1, plain, yardstick in (rows[:3], rows[3:]):
            assert k1["args"] is plain["args"]                     # the same tensors
            torch.testing.assert_close(k1["fn"](*k1["args"]), plain["fn"](*plain["args"]),
                                       rtol=0, atol=0)
            n, crop = k1["args"][1].shape[0], k1["args"][4]
            assert yardstick["fn"](*yardstick["args"]).shape == (2, 256, n // 2 * crop[0], crop[1])
        for r in (rows[0], rows[3]):                               # each box on its FPN level
            torch.testing.assert_close(r["args"][3], ra.assign_fpn_level(r["args"][1], (64, 64)) - 2)
    else:
        assert "(K6) 8x8" in routes and "(K6) 32x32" in routes and "(K6) 64x64" not in routes
        assert all(r["GB/s"] > 0 for r in rows)
        assert "row_gather_checksum 784 rows" in routes


def test_profile_roi_trace_measures_nothing_off_the_card(capsys):
    rows = profile_roi.main(["crop", "--device", "cpu", "--batch", "1", "--boxes", "8",
                             "--size", "16", "--reps", "1", "--trace"])
    assert len(rows) == 4
    assert all(r["trace"] == {"host_ms": None, "kernels": []} for r in rows)
    assert capsys.readouterr().out.count("no device kernels (not measured off the card)") == 4


def test_profile_roi_defaults_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_roi.main(["crop", "--batch", "1", "--boxes", "1", "--size", "8"])
