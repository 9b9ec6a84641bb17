"""The rank side of the port's data-parallel tests (``test_torch_parallel*.py``).

:func:`spawn` runs a function of this module on N gloo ranks, spawned
processes joined through a ``FileStore`` in the test's temporary folder (a
fixed ``MASTER_PORT`` would collide between xdist workers), each running
torch on :data:`RANK_THREADS` threads (``test_torch_workers.TORCH_MIN_THREADS``:
at one thread oneDNN takes another convolution path). What each rank
returns comes back to the test, in rank order. This module imports torch,
numpy and the port, never JAX: the JAX side of a comparison runs in the
pytest process.
"""

from __future__ import annotations

import copy
import hashlib
import os
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from feature_intertwiner_tpu_torch import build_model
from feature_intertwiner_tpu_torch.config import FLAGSHIP_OVERRIDES, build_config
from feature_intertwiner_tpu_torch.data import synthetic
from feature_intertwiner_tpu_torch.evaluation import COCO
from feature_intertwiner_tpu_torch.models.common import init_weights
from feature_intertwiner_tpu_torch.models.detector import InterNet
from feature_intertwiner_tpu_torch.models.resnet import Bottleneck
from feature_intertwiner_tpu_torch.parallel import shard_batch, shard_rows
from feature_intertwiner_tpu_torch.train.optim import set_trainable
from feature_intertwiner_tpu_torch.train.step import (create_train_state, intertwiner_meta,
                                                      train_step)
from feature_intertwiner_tpu_torch.train.workflow import Trainer, iteration_seed, test_model

RANK_THREADS = 2
T = torch.from_numpy

# test_torch_model.TINY with test_torch_train.STEP_MODEL, FPN_SCALES and
# STEP_OPTS (test_torch_parallel_step.py holds the copies equal)
IMG = 128
TINY = dict(backbone="resnet50", num_classes=8, image_size=IMG,
            anchor_scales=(8, 16, 32, 64, 128), pre_nms_limit=200,
            post_nms_inference=48, det_max_instances=8, dev_switch=True,
            dev_upsample_fac=1.0)
STEP_MODEL = dict(rois_per_image=24, dev_loss_choice="l2", assign_base=56.0)
FPN_SCALES = {2: 0.1, 3: 0.2, 4: 0.5}
STEP_OPTS = ["DATASET.NUM_CLASSES", "8", "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2",
             "DEV.BUFFER_SIZE", "1", "DEV.LOSS_FAC", "10.0", "TRAIN.CLIP_GRAD", "True"]
# the small model of the command line and evaluation tests (128² synthetic
# images, which molding neither scales nor pads); the global batch is 4
SMALL_OPTS = ["MODEL.BACKBONE", "resnet50", "DATA.IMAGE_MIN_DIM", "128",
              "DATA.IMAGE_MAX_DIM", "128", "DATA.MAX_GT_INSTANCES", "8",
              "RPN.ANCHOR_SCALES", "(8, 16, 32, 64, 128)", "RPN.PRE_NMS_LIMIT", "200",
              "RPN.POST_NMS_ROIS_INFERENCE", "48", "ROIS.TRAIN_ROIS_PER_IMAGE", "24",
              "TEST.DET_MAX_INSTANCES", "8", "MRCNN.MINI_MASK_SHAPE", "(14, 14)",
              "TRAIN.BATCH_SIZE", "4"]


# --- spawning ---------------------------------------------------------------------------
def _entry(rank, world, store, out_dir, fn, args):
    torch.set_num_threads(RANK_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = fn(rank, world, dist.group.WORLD, *args)
        torch.save(result, os.path.join(out_dir, f"{os.path.basename(store)}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, folder, *args, world: int = 2):
    """``fn(rank, world, group, *args)`` on ``world`` gloo ranks; their
    results in rank order. ``folder`` holds the store and the results."""
    store = os.path.join(str(folder), f"store-{uuid.uuid4().hex}")
    mp.spawn(_entry, args=(world, store, str(folder), fn, args), nprocs=world)
    return [torch.load(f"{store}.rank{r}.pt", weights_only=False) for r in range(world)]


# --- the model and batch of the step tests ------------------------------------------------
def tiny_model(**overrides) -> InterNet:
    """The tiny model of the step tests from seeded weights (0), tempered as
    ``chip_smoke.py::seeded_model`` and ``temper_fpn`` temper the flagship:
    each bottleneck's last BN scale 0.1, the RPN's class and box convs and
    the P2-P4 output convs scaled down, so that some proposals are
    positives on FPN levels 3 and 4."""
    model = InterNet(**dict(TINY, **STEP_MODEL, **overrides))
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
        model.rpn.conv_class.weight.mul_(0.1)
        model.rpn.conv_bbox.weight.mul_(0.1)
        for level, scale in FPN_SCALES.items():
            conv = getattr(model.fpn, f"P{level}_conv2")[1]
            conv.weight.mul_(scale)
            conv.bias.mul_(scale)
    return model.eval()


def gt_batch(proposals: np.ndarray, rng) -> dict:
    """``test_torch_train.py::_batch``: each image's three largest proposals
    (classes 1-3 and 4-6), a random box, a crowd and a padding row; random
    14² mini-masks."""
    b, g = proposals.shape[0], 6
    boxes = np.zeros((b, g, 4), np.float32)
    cls = np.zeros((b, g), np.int32)
    for i in range(b):
        area = (proposals[i, :, 2] - proposals[i, :, 0]) * (proposals[i, :, 3] - proposals[i, :, 1])
        boxes[i, :3] = proposals[i, np.argsort(-area)[:3]] * IMG
        cls[i, :3] = np.arange(1, 4) + 3 * i
    y1x1 = rng.uniform(0, 64, (b, 2, 2))
    boxes[:, 3:5] = np.concatenate([y1x1, y1x1 + rng.uniform(16, 60, (b, 2, 2))], -1)
    cls[:, 3], cls[:, 4] = 7, -2
    masks = (rng.rand(b, g, 14, 14) > 0.4).astype(np.float32)
    return {"gt_class_ids": cls, "gt_boxes": boxes, "gt_masks": masks}


def step_batch(n_images: int = 2, seed: int = 0) -> dict:
    """A global batch for :func:`tiny_model`: images of N(0, 40²) and the
    ground truth of :func:`gt_batch` from the model's own proposals."""
    rng = np.random.RandomState(seed)
    images = (rng.randn(n_images, IMG, IMG, 3) * 40).astype(np.float32)
    with torch.no_grad():
        proposals = tiny_model().first_stage(T(images))[3].numpy()
    return dict(gt_batch(proposals, rng), images=images)


def snapshot(state) -> dict:
    """What a step changes: weights and BN statistics, SGD's momentum by
    parameter name, the buffer and its counts."""
    opt = state.optimizer
    return {"model": dict(state.model.state_dict()),
            "momentum": {n: opt.state[p]["momentum_buffer"]
                         for n, p in state.model.named_parameters()
                         if opt.state.get(p, {}).get("momentum_buffer") is not None},
            "buffer": {"buffer": state.buffer, "buffer_cnt": state.buffer_cnt}}


def digest(snap: dict) -> dict:
    """A :func:`snapshot` (or any {part: {name: tensor}}) as a SHA-1 of each
    tensor's dtype, shape and bytes: what the tests compare bit for bit,
    where the tensors themselves would fill the disk."""
    return {part: {k: hashlib.sha1(f"{v.dtype}{tuple(v.shape)}".encode()
                                   + v.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
                   for k, v in tensors.items()}
            for part, tensors in snap.items()}


def mean_errors(got: dict, mine: dict, group) -> dict:
    """{name: |got - mean over ranks of mine| / max |mean|} per tensor, the
    mean taken in float64 over ``group``."""
    out = {}
    world = dist.get_world_size(group)
    for k, v in mine.items():
        mean = v.detach().double().clone()
        dist.all_reduce(mean, group=group)
        mean /= world
        out[k] = float((got[k].double() - mean).abs().max() / mean.abs().max().clamp_min(1e-12))
    return out


def _rank_batch(batch: dict, rank: int, world: int) -> dict:
    return {k: T(np.ascontiguousarray(v)) for k, v in shard_batch(batch, rank, world).items()}


def bn_statistics(snap: dict) -> dict:
    """Copies of the BN running statistics of a :func:`snapshot`."""
    return {k: v.clone() for k, v in snap["model"].items()
            if k.endswith(("running_mean", "running_var"))}


def _steps(cfg, model, batch, seeds, group, pick=lambda snap: None):
    """Train steps of a copy of ``model`` on ``batch`` (this rank's rows),
    one per seed of the sampling generator. Returns ([(digest, metrics,
    ``pick(snapshot)``)] per step, the last snapshot)."""
    model = copy.deepcopy(model)
    state = create_train_state(cfg, model)
    set_trainable(model, "all")
    out = []
    for seed in seeds:
        metrics = train_step(state, cfg, batch, 0.01, 1.0, torch.Generator().manual_seed(seed),
                             group=group)
        snap = snapshot(state)
        out.append((digest(snap), {k: v.clone() for k, v in metrics.items()}, pick(snap)))
    return out, snap


# --- rank functions -----------------------------------------------------------------------
def merge_cases(rank, world, group, cases):
    """``intertwiner_meta`` over the ranks on each case: {name: (loss, new
    buffer, new counts, d loss / d small_feat, d loss / d small_out)} of
    this rank. A case is (cfg_dev, buffer, buffer_cnt, stats), every stat
    stacked over the ranks on axis 0."""
    out = {}
    for name, (cfg_dev, buffer, buffer_cnt, stats) in cases.items():
        mine = {k: T(np.ascontiguousarray(v[shard_rows(len(v), rank, world)]))
                for k, v in stats.items()}
        for k in ("small_feat", "small_out"):
            mine[k].requires_grad_(True)
        loss, new_buf, new_cnt = intertwiner_meta(cfg_dev, T(buffer), T(buffer_cnt), mine,
                                                  group=group)
        loss.backward()
        grads = [mine[k].grad if mine[k].grad is not None else torch.zeros_like(mine[k])
                 for k in ("small_feat", "small_out")]
        out[name] = (loss.detach(), new_buf.detach(), new_cnt.detach(), *grads)
    return out


def step_scenarios(rank, world, group, batch):
    """The port-only oracles of the 2-rank step, on this rank's rows of
    ``batch`` with rank seeds ``iteration_seed(0, 1, it, rank)``, each from
    the weights of :func:`tiny_model`:

    - ``runs``: two steps over the ranks (Dev on, L2, clip on, BN learning),
      twice: each step's digest and metrics;
    - ``single``: the first step without a group on the rank's rows;
      ``bn_err``: the BN running statistics of the first step over the
      ranks against the mean of the ranks' single steps
      (:func:`mean_errors`);
    - ``sgd_err``: Dev off, no clip, no BN learning: the weights of one step
      over the ranks against the mean of one step without a group on each
      rank's rows, ``sgd_digest`` the latter's;
    - ``world1``: on rank 0, the first step of ``runs`` in a group of rank
      0 alone."""
    mine = _rank_batch(batch, rank, world)
    seeds = [iteration_seed(0, 1, it, rank) for it in (1, 2)]
    base = list(FLAGSHIP_OVERRIDES) + STEP_OPTS
    cfg = build_config(opts=base + ["TRAIN.BN_LEARN", "True"])
    model = model_bn = tiny_model()
    runs = [_steps(cfg, model, mine, seeds, group, bn_statistics)[0] for _ in range(2)]
    single = _steps(cfg, model, mine, seeds[:1], None, bn_statistics)[0]
    out = {"runs": runs, "single": single,
           "bn_err": mean_errors(runs[0][0][2], single[0][2], group)}
    sgd = build_config(opts=base + ["DEV.SWITCH", "False", "TRAIN.CLIP_GRAD", "False"])
    model = tiny_model(dev_switch=False)
    grouped = _steps(sgd, model, mine, seeds[:1], group)[1]["model"]
    alone = _steps(sgd, model, mine, seeds[:1], None)[1]["model"]
    out["sgd_err"] = mean_errors(grouped, alone, group)
    out["sgd_digest"] = digest({"model": alone})["model"]
    for steps in [out["single"]] + runs:
        for i, (dig, metrics, _) in enumerate(steps):
            steps[i] = (dig, metrics)
    one = dist.new_group([0])
    if rank == 0:
        out["world1"] = [step[:2] for step in _steps(cfg, model_bn, mine, seeds[:1], one)[0]]
    return out


def small_model(cfg):
    """The small model of ``cfg`` on the CPU from seeded weights, tempered
    as ``chip_smoke.py::seeded_model`` (else it detects nothing)."""
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.fill_(0.1)
        model.rpn.conv_class.weight.mul_(0.1)
        model.rpn.conv_bbox.weight.mul_(0.1)
    return model


def eval_set():
    """Five 128² synthetic images and their COCO index."""
    data = synthetic.generate(num_images=5, size=(128, 128), seed=6, max_instances=3)
    return data, COCO(dataset=data.coco_dataset())


def evaluate(rank, world, group, folders):
    """``test_model`` with masks over the ranks into ``folders["group"]``,
    then on rank 0 alone without a group into ``folders["single"]``: the
    12 bbox stats of each (chunks of 4 images: 2 per rank, then the fifth
    image on rank 0 and none on rank 1)."""
    data, api = eval_set()
    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + SMALL_OPTS + [
        "DATASET.NUM_CLASSES", str(data.num_classes)])
    model = small_model(cfg)
    out = {}
    for name, g in (("group", group), ("single", None)):
        if g is None and rank != 0:
            continue
        cfg.MISC.RESULT_FOLDER = folders[name]
        cfg.MISC.LOG_FILE = os.path.join(folders[name], "log.txt") if rank == 0 else None
        out[name] = test_model(model, cfg, data, api, epoch=1, eval_masks=True, group=g)
    return out


def resume(rank, world, group, folder, opts):
    """A trainer over the ranks resumed from the newest checkpoint in
    ``folder``: (the :func:`digest` of its snapshot with the optimizer's
    momentum by its state_dict's index, epoch, iteration)."""
    cfg = build_config(opts=list(opts))
    cfg.MISC.RESULT_FOLDER = folder
    cfg.MISC.LOG_FILE = None
    trainer = Trainer(build_model(cfg, device="cpu", seed=1), cfg, group).resume()
    optim = trainer.state.optimizer.state_dict()["state"]
    return (digest(dict(snapshot(trainer.state),
                        optim={str(i): v["momentum_buffer"] for i, v in optim.items()})),
            trainer.epoch, trainer.iter)


def mesh_step(rank, world, group, weights, batch, draws, proposals):
    """One 'all' step over the ranks of :data:`TINY` with
    :data:`STEP_MODEL` from ``weights`` (a state_dict), each rank's
    second stage fed its ``proposals[rank]`` and its targets ``draws[rank]``
    (those of the JAX step's device ``rank``): {"metrics", "digest"} and,
    on rank 0, "state" (state_dict, buffer, buffer_cnt)."""
    cfg = build_config(opts=list(FLAGSHIP_OVERRIDES) + STEP_OPTS)
    model = InterNet(**TINY, **STEP_MODEL)
    model.load_state_dict(weights)
    model.eval()
    state = create_train_state(cfg, model)
    set_trainable(model, "all")
    mine = T(proposals[rank])
    model._propose = lambda *args: mine
    metrics = train_step(state, cfg, _rank_batch(batch, rank, world), 0.01, 1.0,
                         draws={k: T(v[rank]) for k, v in draws.items()}, group=group)
    snap = snapshot(state)
    out = {"metrics": metrics, "digest": digest(snap)}
    if rank == 0:
        out["state"] = ({k: v.clone() for k, v in snap["model"].items()}, state.buffer,
                        state.buffer_cnt)
    return out
