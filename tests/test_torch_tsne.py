"""The port's t-SNE tool against the JAX package's, on the CPU.

The case is the JAX tests' two blobs (``tests/test_utils_misc.py``,
``test_tsne_embed_and_plot``): 20 points around +5 and 20 around -5 in 32
dimensions, perplexity 5.

- ``joint_affinities`` (host float64 in both) within 1e-12 of JAX's.
- ``tsne_embed`` at 1 and 10 iterations within 1e-5 of the embedding's
  largest magnitude of JAX's jitted ``fori_loop``.
- At the default 150 iterations the two embeddings part, and the blobs
  separate in both (silhouette above 0.3, the check of the JAX package's
  ``tests/test_tsne.py``). Where they part: the descent amplifies a
  float32 rounding about twofold per iteration through the exaggeration
  phase; the gains rule first takes another branch in the two packages
  where a gradient element is a cancellation to within 1e-4 of the
  magnitude of its summands, with the two signs opposite, and from there the
  two runs differ at O(1). The port's own float32 loop parts from its
  float64 loop in the same way, so float32 cannot hold 150 iterations
  to a tolerance (ROADMAP §C, not a fault).
- ``plot_embedding`` draws the JAX package's picture.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from sklearn.metrics import silhouette_score

from feature_intertwiner_tpu.utils import tsne as jax_tsne
from feature_intertwiner_tpu_torch.utils import tsne


def _blobs():
    rng = np.random.RandomState(0)          # the JAX tests' ``rng`` fixture
    feats = np.concatenate([rng.randn(20, 32) + 5, rng.randn(20, 32) - 5]).astype(np.float32)
    return feats, np.repeat([0, 1], 20)


def test_joint_affinities_match_jax():
    feats, _ = _blobs()
    for perplexity, metric in ((5.0, "euclidean"), (30.0, "cosine")):
        got = tsne.joint_affinities(feats, perplexity, metric)
        want = jax_tsne.joint_affinities(feats, perplexity, metric)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_iter", [1, 10])
def test_tsne_embed_matches_jax(n_iter):
    feats, _ = _blobs()
    got = tsne.tsne_embed(feats, perplexity=5, n_iter=n_iter, device="cpu")
    want = jax_tsne.tsne_embed(feats, perplexity=5, n_iter=n_iter)
    assert got.shape == want.shape == (40, 2) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tsne_embed_separates_the_blobs_at_150_iterations():
    feats, labels = _blobs()
    got = tsne.tsne_embed(feats, perplexity=5, device="cpu")
    want = jax_tsne.tsne_embed(feats, perplexity=5)
    assert np.isfinite(got).all()
    assert silhouette_score(got, labels) > 0.3 and silhouette_score(want, labels) > 0.3
    assert tsne.tsne_embed(feats[:1], device="cpu").shape == (1, 2)


def _jax_step(P, lr, exaggeration_end):
    """The JAX ``tsne_embed`` loop body, copied (jax_tsne closes over it),
    also returning the gradient and the gains rule's branch."""
    n = P.shape[0]

    def step(i, y, vel, gains):
        sq = jnp.sum(y * y, axis=1)
        num = 1.0 / (1.0 + sq[:, None] + sq[None, :] - 2.0 * (y @ y.T))
        num = num * (1.0 - jnp.eye(n))
        Q = jnp.maximum(num / jnp.sum(num), 1e-12)
        Pe = jnp.where(i < exaggeration_end, P * 12.0, P)
        W = (Pe - Q) * num
        grad = 4.0 * ((jnp.diag(jnp.sum(W, axis=1)) - W) @ y)
        momentum = jnp.where(i < exaggeration_end, 0.5, 0.8)
        flip = jnp.sign(grad) != jnp.sign(vel)
        gains = jnp.maximum(jnp.where(flip, gains + 0.2, gains * 0.8), 0.01)
        vel = momentum * vel - lr * gains * grad
        y = y + vel
        return y - jnp.mean(y, axis=0), vel, gains, grad, flip

    return jax.jit(step)


def _summands(y, P, early):
    """The magnitude of each gradient element's summands,
    4 (|diag(sum W) - W| @ |y|), at embedding ``y``."""
    sq = (y * y).sum(1)
    num = (1.0 / (1.0 + sq[:, None] + sq[None, :] - 2.0 * (y @ y.T))) * (1.0 - torch.eye(len(y)))
    W = ((P * 12.0 if early else P) - torch.clamp(num / num.sum(), min=1e-12)) * num
    return 4.0 * ((torch.diag(W.sum(1)) - W).abs() @ y.abs())


def lockstep(n_iter=150):
    """The port's loop, the jitted copy of JAX's and the port's loop in
    float64, step by step from one start. Returns (the final embeddings:
    port, JAX, float64; the relative gap port-JAX after each iteration; the
    first iteration where the gains rule branches otherwise in the two, and
    there each such element's (row, column, port gradient, JAX gradient,
    summands' magnitude))."""
    feats, _ = _blobs()
    P, y, vel, gains, lr, end = tsne.tsne_start(feats, perplexity=5, n_iter=n_iter, device="cpu")
    jstep = _jax_step(jnp.asarray(P.numpy()), lr, end)
    jy, jvel, jgains = jnp.asarray(y.numpy()), jnp.zeros(y.shape), jnp.ones(y.shape)
    y64, vel64, gains64 = y.double(), vel.double(), gains.double()
    P64 = torch.from_numpy(tsne.joint_affinities(feats, 5))
    parted, elements, gaps = None, [], []
    for i in range(n_iter):
        y_in, vel_in = y, vel
        y, vel, gains, grad = tsne.tsne_step(i, y_in, vel_in, gains, P, lr, end)
        flip = (torch.sign(grad) != torch.sign(vel_in)).numpy()
        jy, jvel, jgains, jgrad, jflip = jstep(i, jy, jvel, jgains)
        y64, vel64, gains64, _ = tsne.tsne_step(i, y64, vel64, gains64, P64, lr, end)
        gaps.append(float(np.abs(y.numpy() - np.asarray(jy)).max() / np.abs(np.asarray(jy)).max()))
        differ = flip != np.asarray(jflip)
        if parted is None and differ.any():
            parted, scale = i, _summands(y_in, P, i < end)
            elements = [(r, c, float(grad[r, c]), float(jgrad[r, c]), float(scale[r, c]))
                        for r, c in zip(*np.nonzero(differ))]
    return (y.numpy(), np.asarray(jy), y64.numpy()), gaps, parted, elements


def test_the_150_iteration_runs_part_at_a_gains_flip_within_rounding():
    (y, jy, y64), gaps, parted, elements = lockstep()
    # the jitted copy is JAX's loop: the same embedding as jax_tsne.tsne_embed
    np.testing.assert_array_equal(jy, jax_tsne.tsne_embed(_blobs()[0], perplexity=5))
    assert parted is not None and parted > 10
    assert max(gaps[:parted]) <= 1e-2 and gaps[-1] > 0.1
    for r, c, g, jg, scale in elements:
        assert g * jg < 0 and max(abs(g), abs(jg)) <= 1e-4 * scale, (parted, r, c, g, jg, scale)
    # the float32 loop parts from float64 the same way
    assert np.abs(y - y64).max() / np.abs(y64).max() > 0.1


def test_plot_embedding_draws_the_jax_picture(tmp_path):
    emb = np.random.RandomState(2).randn(30, 2).astype(np.float32)
    ids = np.repeat(np.arange(3), 10)
    got = tsne.plot_embedding(emb, ids, class_names=["a", "b", "c"],
                              out_path=str(tmp_path / "port.png"))
    want = jax_tsne.plot_embedding(emb, ids, class_names=["a", "b", "c"],
                                   out_path=str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(got)), np.asarray(Image.open(want)))


if __name__ == "__main__":
    (y, jy, y64), gaps, parted, elements = lockstep()
    print("relative gap port - JAX after iterations 1, 2, 5, 10, 15, 20, 150:",
          [f"{gaps[i - 1]:.3g}" for i in (1, 2, 5, 10, 15, 20, 150)])
    print(f"first gains branch that differs: iteration {parted} (0-based)")
    for r, c, g, jg, scale in elements:
        print(f"  element ({r}, {c}): gradient port {g:.3g}, JAX {jg:.3g}, summands {scale:.3g}")
    print(f"port float32 against float64 after 150: "
          f"{np.abs(y - y64).max() / np.abs(y64).max():.3g} of the largest magnitude")
