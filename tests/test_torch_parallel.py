"""The port's data parallelism (``parallel/data_parallel.py``) on 2 gloo
ranks on the CPU, against the JAX package's ``shard_map`` and against the
single process.

The ranks are spawned processes that import no JAX
(``tests/torch_dist_ranks.py``); the JAX side runs here, on 2 of the 8
virtual CPU devices of ``tests/conftest.py``.

- The statistics merge alone: ``intertwiner_meta`` over 2 ranks against
  the JAX ``intertwiner_meta(..., axis_name="data")`` under ``shard_map``
  on a 2-device mesh, for L2, L1 and KL, ``INST_LOSS``, ``BUFFER_SIZE`` 1
  and 2, small statistics on one rank only and on none: the loss, the new
  buffer and counts, and each rank's gradient of the loss with respect to
  its ``small_feat`` and ``small_out``, within 1e-6 of each tensor's
  largest magnitude. The gradient pins the differentiable all-reduce: its
  backward sums over ranks as the transpose of ``psum`` does, where a plain
  ``dist.all_reduce`` would give each rank 1/N of it.
- Port-only oracles of the 2-rank train step, as the JAX package's mesh
  tests (``tests/test_parallel.py``) hold its step: with the Dev off and no
  clip the SGD step equals the mean of the per-shard single-process steps
  (parameters within 1e-6 of each tensor's largest magnitude: SGD's update
  is linear in the gradient, so only rounding separates them); under
  ``TRAIN.BN_LEARN`` the BN running statistics equal the mean of the
  per-shard ones (within 1e-6 of each tensor's largest magnitude); after
  each of 2 steps both ranks hold bit-identical weights, momentum and
  buffer, and a second run gives the same bits; a group of rank 0 alone
  gives the no-group step bit for bit (weights, BN statistics, momentum,
  buffer and metrics); a batch that the rank count does not divide raises
  ``ValueError``. Bit-equality is held on SHA-1 digests of the tensors
  (``torch_dist_ranks.digest``).
- ``test_model`` over 2 ranks: the single process's detections (classes
  equal, boxes within 1 px, scores within 1e-4) and 12 bbox stats within
  0.02, one cache file.
- ``torchrun --nproc_per_node 2 -m feature_intertwiner_tpu_torch.main
  --phase train --synthetic_data --device cpu``: two finite loss lines from
  rank 0, one checkpoint file; a trainer over 2 ranks resumed from it holds
  its weights, momentum and buffer on both ranks.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from feature_intertwiner_tpu.parallel import make_mesh
from feature_intertwiner_tpu.train.step import intertwiner_meta as jax_intertwiner_meta
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.data.loader import DetectionDataset, Loader
from feature_intertwiner_tpu_torch.data.coco_dataset import make_loader
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.parallel import shard_batch, shard_rows
from feature_intertwiner_tpu_torch.train.workflow import iteration_seed
from test_torch_eval import match_detections

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max(initial=0.0) / max(np.abs(want).max(initial=0.0), 1e-12))


# --- the statistics merge against JAX under shard_map ------------------------------------
S, D, K, N = 3, 16, 6, 5     # meta levels, feature width, classes, small RoIs per rank


def _merge_case(seed, loss_choice, buffer_size, inst_loss, small_on=(True, True)):
    """(cfg_dev, buffer, buffer_cnt, stats stacked over the ranks): features
    in [0.1, 1) (KL takes their logs), counts 0-2 with the feature 0 where
    its count is."""
    rng = np.random.RandomState(seed)

    def feats(shape):
        cnt = rng.randint(0, 3, shape[:1] + (1,) + shape[2:]).astype(np.float32)
        return (rng.uniform(0.1, 1.0, shape) * (cnt > 0)).astype(np.float32), cnt

    big_feat, big_cnt = feats((WORLD * S, D, K))
    small_feat, small_cnt = feats((WORLD * S, D, K))
    for r, on in enumerate(small_on):
        if not on:
            small_feat[r * S:(r + 1) * S] = 0
            small_cnt[r * S:(r + 1) * S] = 0
    buffer, buffer_cnt = feats((buffer_size, D, K))
    stats = {"big_feat": big_feat, "big_cnt": big_cnt, "small_feat": small_feat,
             "small_cnt": small_cnt,
             "small_out": rng.uniform(0.1, 1.0, (WORLD * N, D)).astype(np.float32),
             "small_gt": rng.randint(0, K, WORLD * N).astype(np.int32)}
    cfg_dev = {"buffer_size": buffer_size, "loss_choice": loss_choice, "inst_loss": inst_loss}
    return cfg_dev, buffer, buffer_cnt, stats


MERGE_CASES = {
    "l2_buffer1": (1, "l2", 1, False),
    "l2_buffer2": (2, "l2", 2, False),
    "l1_buffer1": (3, "l1", 1, False),
    "kl_buffer2": (4, "kl", 2, False),
    "inst_l2_buffer1": (5, "l2", 1, True),
    "inst_l1_buffer2": (6, "l1", 2, True),
    "small_on_rank0_only": (7, "l2", 2, False, (True, False)),
    "no_small_stats": (8, "l2", 1, False, (False, False)),
}


def _jax_merge(case, mesh):
    """JAX ``intertwiner_meta`` per device under ``shard_map``, with the
    gradient each device's train step takes of it (before its ``pmean``)."""
    cfg_dev, buffer, buffer_cnt, stats = case

    def per_device(buffer, buffer_cnt, stats):
        def loss_fn(small_feat, small_out):
            st = dict(stats, small_feat=small_feat, small_out=small_out)
            loss, new_buf, new_cnt = jax_intertwiner_meta(cfg_dev, buffer, buffer_cnt, st,
                                                          axis_name="data")
            return loss, (new_buf, new_cnt)

        (loss, (new_buf, new_cnt)), grads = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(stats["small_feat"], stats["small_out"])
        return loss[None], new_buf[None], new_cnt[None], *grads

    fn = jax.jit(shard_map(per_device, mesh=mesh, in_specs=(P(), P(), P("data")),
                           out_specs=P("data"), check_vma=False))
    return [np.asarray(x) for x in jax.device_get(fn(buffer, buffer_cnt, stats))]


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    cases = {name: _merge_case(*args) for name, args in MERGE_CASES.items()}
    mesh = make_mesh(WORLD)
    want = {name: _jax_merge(case, mesh) for name, case in cases.items()}
    got = ranks.spawn(ranks.merge_cases, tmp_path_factory.mktemp("merge"), cases)
    return got, want


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_over_ranks_matches_jax_shard_map(merged, name):
    got, want = merged
    loss, new_buf, new_cnt, grad_feat, grad_out = want[name]
    for rank, per_rank in enumerate(got):
        g = [t.numpy() for t in per_rank[name]]
        assert rel_err(g[0], loss[rank]) <= 1e-6, (rank, float(g[0]), float(loss[rank]))
        assert rel_err(g[1], new_buf[rank]) <= 1e-6, rank
        assert rel_err(g[2], new_cnt[rank]) <= 1e-6, rank
        assert rel_err(g[3], grad_feat[rank * S:(rank + 1) * S]) <= 1e-6, rank
        assert rel_err(g[4], grad_out[rank * N:(rank + 1) * N]) <= 1e-6, rank
    if name == "no_small_stats":
        assert (loss == 0).all()
        np.testing.assert_array_equal(new_buf[0], _merge_case(*MERGE_CASES[name])[1])
    else:
        assert (loss > 0).all() and np.abs(grad_feat if "inst" not in name else grad_out).max() > 0


# --- the 2-rank step against the single process -----------------------------------------
@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    batch = ranks.step_batch()
    return ranks.spawn(ranks.step_scenarios, tmp_path_factory.mktemp("steps"), batch)


def test_sgd_step_over_ranks_is_the_mean_of_the_shard_steps(scenarios):
    """Dev off, no clip: SGD with momentum and weight decay is linear in the
    gradient, so the step on the averaged gradient is the mean of the steps
    each rank takes alone on its rows."""
    errors = scenarios[0]["sgd_err"]
    assert len(errors) > 100 and max(errors.values()) <= 1e-6, max(errors.items(),
                                                                   key=lambda kv: kv[1])
    shards = [s["sgd_digest"] for s in scenarios]
    assert sum(shards[0][k] != shards[1][k] for k in shards[0]) > 100


def test_bn_learn_statistics_over_ranks_are_the_mean_of_the_shards(scenarios):
    errors = scenarios[0]["bn_err"]
    assert len(errors) > 100 and max(errors.values()) <= 1e-6, max(errors.items(),
                                                                   key=lambda kv: kv[1])
    first = [s["single"][0][0]["model"] for s in scenarios]
    moved = [k for k in errors if first[0][k] != first[1][k]]
    assert len(moved) > len(errors) // 2


def test_ranks_stay_bit_identical_and_runs_repeat(scenarios):
    """Two steps with the Dev on, L2, the clip and BN learning: after each,
    both ranks hold the same bits (weights, BN statistics, momentum,
    buffer), as do the metrics, the meta loss is positive, and a second run
    gives the same bits."""
    for step in range(2):
        digests = [s["runs"][run][step][0] for s in scenarios for run in range(2)]
        assert all(d == digests[0] for d in digests[1:]), step
        metrics = [s["runs"][0][step][1] for s in scenarios]
        assert metrics[0].keys() == metrics[1].keys()
        for k, v in metrics[0].items():
            assert torch.equal(metrics[1][k], v), (step, k)
    first = scenarios[0]["runs"][0][0][1]
    assert float(first["meta_loss"]) > 0 and float(first["positive_rois"]) > 0
    # the steps moved what they train, and the buffer
    assert digests[0]["buffer"] != scenarios[0]["runs"][0][0][0]["buffer"]
    assert digests[0]["momentum"] != scenarios[0]["runs"][0][0][0]["momentum"]


def test_a_group_of_one_rank_is_the_single_process(scenarios):
    grouped, alone = scenarios[0]["world1"], scenarios[0]["single"]
    assert len(grouped) == len(alone) == 1
    for (g_digest, g_metrics), (a_digest, a_metrics) in zip(grouped, alone):
        assert g_digest == a_digest
        assert g_metrics.keys() == a_metrics.keys()
        for k, v in a_metrics.items():
            assert torch.equal(g_metrics[k], v), k


def test_rank_rows_and_seeds():
    """Rank r's rows are ``[r·B/N, (r+1)·B/N)``; a batch the rank count does
    not divide raises in ``shard_batch``, the loaders and ``make_loader``;
    rank 0's sampling seed is the single process's, other ranks' differ."""
    batch = {"images": np.arange(8).reshape(4, 2), "gt_class_ids": np.arange(4)}
    np.testing.assert_array_equal(shard_batch(batch, 1, 2)["images"], [[4, 5], [6, 7]])
    assert shard_rows(4, 3, 4) == slice(3, 4)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch({"images": np.zeros((3, 2))}, 0, 2)
    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + ranks.SMALL_OPTS + [
        "TRAIN.BATCH_SIZE", "3"])
    data = synthetic.generate(num_images=6, size=(128, 128), seed=1, max_instances=2)
    with pytest.raises(ValueError, match="does not split"):
        make_loader(data, cfg, rank=0, world=2)
    ds = DetectionDataset(data, cfg, augment=True, seed=0)
    with pytest.raises(ValueError, match="does not split"):
        Loader(ds, 3, rank=1, world=2)
    assert iteration_seed(5, 2, 7) == ((5 + 1009 * 2) * 1_000_003 + 7) % (2 ** 63)
    assert iteration_seed(5, 2, 7, rank=0) == iteration_seed(5, 2, 7)
    seeds = {iteration_seed(5, 2, it, r) for it in range(1, 4) for r in range(4)}
    assert len(seeds) == 12


def test_loader_ranks_collate_their_rows_of_each_batch():
    """The union of the ranks' batches is the single process's batch, in
    order, from the in-process and the thread loader alike."""
    from feature_intertwiner_tpu_torch.data.loader import PrefetchLoader

    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + ranks.SMALL_OPTS)
    data = synthetic.generate(num_images=8, size=(128, 128), seed=2, max_instances=2)
    ds = DetectionDataset(data, cfg, augment=True, seed=0)
    whole = Loader(ds, 4, seed=0)
    whole.set_epoch(1)
    want = list(whole)
    for make in (lambda r: Loader(ds, 4, seed=0, rank=r, world=2),
                 lambda r: PrefetchLoader(ds, 4, num_workers=2, seed=0, rank=r, world=2)):
        parts = []
        for r in range(2):
            loader = make(r)
            loader.set_epoch(1)
            assert len(loader) == len(whole) == 2
            parts.append(list(loader))
        for b, w in enumerate(want):
            for k in w:
                np.testing.assert_array_equal(np.concatenate([parts[0][b][k], parts[1][b][k]]),
                                              w[k])


# --- evaluation ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    folders = {n: str(tmp_path_factory.mktemp(f"eval_{n}")) for n in ("group", "single")}
    got = ranks.spawn(ranks.evaluate, tmp_path_factory.mktemp("eval"), folders)
    return got, folders


def test_test_model_over_ranks_matches_the_single_process(evaluated):
    got, folders = evaluated
    for per_rank in got:
        np.testing.assert_array_equal(per_rank["group"], got[0]["group"])
    np.testing.assert_allclose(got[0]["group"], got[0]["single"], rtol=0, atol=0.02)
    results = {}
    for name, folder in folders.items():
        caches = [f for f in os.listdir(folder) if f.startswith("det_result_")]
        assert caches == ["det_result_ep0001_n5_masks.json"], caches
        with open(os.path.join(folder, caches[0])) as f:
            results[name] = json.load(f)
    assert len(results["single"]) > 0
    assert len(results["group"]) == len(results["single"])
    assert {r["image_id"] for r in results["group"]} == {r["image_id"] for r in
                                                         results["single"]}
    assert match_detections(results["group"], results["single"]) == []


# --- the command line over 2 ranks, its checkpoint, a resume -----------------------------
CLI_OPTS = ranks.SMALL_OPTS + ["TRAIN.SCHEDULE", "[0, 0, 1]", "TRAIN.KEEP_CHECKPOINTS", "1",
                               "TRAIN.DO_VALIDATION", "False", "CTRL.SHOW_INTERVAL", "1"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(ranks.RANK_THREADS))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "feature_intertwiner_tpu_torch.main", "--phase", "train", "--synthetic_data",
         "--device", "cpu", "--config_name", "dp", *FLAGSHIP_OVERRIDES, *CLI_OPTS],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return cwd / "results" / "dp" / "train", proc.stdout


def test_cli_over_two_ranks_trains_and_writes_one_checkpoint(cli_run):
    folder, stdout = cli_run
    with open(folder / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    losses = [r for r in lines if "total_loss" in r]
    assert [r["iter"] for r in losses] == [1, 2]
    assert all(np.isfinite(r[k]) for r in losses for k in r if k.endswith("_loss"))
    assert os.listdir(folder / "checkpoints") == ["ckpt_ep0001_iter000002.pt"]
    log = (folder / "log.txt").read_text()
    assert "2 rank(s)" in log and log.count("[ALL][Ep 001/1][iter 0002/2]") == 1
    assert stdout.count("[ALL][Ep 001/1][iter 0002/2]") == 1


def test_a_trainer_over_two_ranks_resumes_from_the_checkpoint(cli_run, tmp_path):
    folder, _ = cli_run
    payload = torch.load(folder / "checkpoints" / "ckpt_ep0001_iter000002.pt",
                         weights_only=True)
    n_classes = synthetic.generate(num_images=8).num_classes
    opts = list(FLAGSHIP_OVERRIDES) + CLI_OPTS + ["DATASET.NUM_CLASSES", str(n_classes)]
    got = ranks.spawn(ranks.resume, tmp_path, str(folder), opts)
    want = ranks.digest({
        "model": payload["model"],
        "buffer": {"buffer": payload["buffer"], "buffer_cnt": payload["buffer_cnt"]},
        "optim": {str(i): v["momentum_buffer"] for i, v in payload["optimizer"]["state"].items()}})
    assert want["optim"]
    for snap, epoch, it in got:
        assert (epoch, it) == (1, 3)
        assert snap["model"] == want["model"] and snap["buffer"] == want["buffer"]
        assert snap["optim"] == want["optim"]
        assert snap["momentum"] == got[0][0]["momentum"]
