"""The training loop (stages, epochs, iterations, checkpoints) and the
COCO evaluation.

Port of ``feature_intertwiner_tpu/train/workflow.py``:

- :class:`Trainer` holds the model, the :class:`TrainState` and the
  epoch/iteration counters, and writes the live dashboard into the run's
  folder (``utils/monitor.py``; served under ``MISC.USE_VISDOM``);
  :meth:`Trainer.resume` seeds ``big_fc`` from
  the classifier under ``DEV.BIG_FC_INIT coco_pretrain``, then restarts
  from the newest checkpoint, or starts from a pretrained ``.npz``,
  ``.pth`` or ``.h5`` file;
- :func:`train_model` runs one stage ('heads', '4+', 'all') over the epochs
  the cumulative ``TRAIN.SCHEDULE`` gives it, skipping a stage a resumed run
  has finished;
- :func:`train_epoch` runs the iterations: the learning rate per
  iteration, the meta-loss gate after ``EFFECT_AFER_EP_PERCENT`` of epoch 1,
  the loss line every ``SHOW_INTERVAL``, and ``SAVE_FREQ_WITHIN_EPOCH``
  saves per epoch. Each iteration's sampling generator is seeded from
  (seed, epoch, iteration, rank), so a run resumed mid-epoch skips the
  iterations it has done and replays nothing. Under ``CTRL.PROFILE_ANALYSIS`` the
  loader's ``next()`` ("fetch") and the step ("step", ended by a
  synchronisation on the card) are timed and reported with each loss line
  (``utils/profiling.py::PhaseTimer``). With ``TRAIN.DO_VALIDATION`` and a
  validation set, a stage ends with :func:`test_model`;
- :func:`test_model` evaluates a model on a dataset: inference in chunks of
  ``TEST.BATCH_SIZE`` images through ``inference.detect`` (one scale, or
  every ``TEST.MULTI_SCALE`` scale fused per image by :func:`fuse_multiscale`),
  COCO-format results with RLE masks, the det-result cache (inference is
  skipped when the cache of the same epoch, image count, mask mode, dtype
  and scales exists), the bbox (and with masks the segm) COCOeval, the
  AP line in ``metrics.jsonl`` and, with ``TEST.SAVE_IM``, each image's
  detections drawn to a PNG. The JAX package's ``roi_unfit_overflow``
  counter belongs to its TPU window kernel and has no counterpart here.

Over ranks (a ``torch.distributed`` group, ``parallel/data_parallel.py``):
each rank trains on its rows of every batch (``data/loader.py`` collates
only the rank's rows), with its own sampling seed; the loss lines,
``metrics.jsonl``, the dashboard and its server, the ``[profile]`` report
and the checkpoints are rank 0's, and every rank waits for a checkpoint to
be written. :func:`test_model` rounds
``TEST.BATCH_SIZE`` up to a multiple of the rank count (JAX
``_detect_stream``), gives each rank its share of each chunk, gathers the
detections to rank 0, which writes the cache and runs COCOeval, and returns
the same 12 stats on every rank.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..evaluation import COCOeval
from ..evaluation.rle import RLE
from ..inference import detect
from ..parallel.data_parallel import rank_and_world, replicate, shard_rows
from ..utils import convert_weights as cw
from ..utils import monitor
from ..utils.logging import MetricsLogger, format_loss_line, print_log
from ..utils.profiling import PhaseTimer
from ..utils.visualize import display_instances, require_matplotlib
from . import checkpoint as ckpt
from .optim import flax_paths, learning_rate, set_trainable
from .step import create_train_state, train_step

STAGE_ORDER = {"heads": 1, "4+": 2, "all": 3}


def iteration_seed(seed: int, epoch: int, iteration: int, rank: int = 0) -> int:
    """The sampling seed of one iteration on one rank, a function of (seed,
    epoch, iteration, rank) only; rank 0's is the single process's."""
    base = ((seed + 1009 * epoch) * 1_000_003 + iteration) % (2 ** 63)
    if rank == 0:
        return base
    return (base * 6364136223846793005 + rank * 1442695040888963407) % (2 ** 63)


class Trainer:
    """The model, its :class:`TrainState` and the epoch and iteration
    counters, across stages. The model stays in ``eval()``: BN uses its
    running statistics in training (the JAX package's ``strict_quirks``),
    but within a step under ``TRAIN.BN_LEARN`` (``train/step.py``), so that
    validation and inference read the running statistics.

    ``group``: the ranks it trains over (``parallel/data_parallel.py``);
    only rank 0 logs, writes ``metrics.jsonl`` and the dashboard."""

    def __init__(self, model: torch.nn.Module, cfg, group=None):
        self.model = model.eval()
        self.cfg = cfg
        self.group = group
        self.rank, self.world = rank_and_world(group)
        self.device = next(model.parameters()).device
        self.state = create_train_state(cfg, model)
        self.epoch = 1
        self.iter = 1
        self.metrics_logger = MetricsLogger(
            os.path.join(cfg.MISC.RESULT_FOLDER or ".", "metrics.jsonl") if self.rank == 0
            else None)
        # the live dashboard: the page beside metrics.jsonl, served under
        # MISC.USE_VISDOM
        self._monitor = None
        if cfg.MISC.RESULT_FOLDER and self.rank == 0:
            monitor.write_dashboard(cfg.MISC.RESULT_FOLDER, config=cfg)
            self._monitor = monitor.maybe_serve(cfg, cfg.MISC.RESULT_FOLDER)

    def log(self, msg: str) -> None:
        """A line on the console and in the log, from rank 0 only."""
        if self.rank == 0:
            print_log(msg, self.cfg.MISC.LOG_FILE)

    def resume(self) -> "Trainer":
        """Apply ``DEV.BIG_FC_INIT_LIST`` (``coco_pretrain``: ``big_fc``
        from the classifier's ``linear_class``, JAX ``Trainer.resume``),
        then start from what ``train/checkpoint.py::resolve_init`` names:
        a checkpoint of the run restores the whole trainer state; a
        pretrained file is overlaid on the weights
        (``utils/convert_weights.py::merge_pretrained``, a strict=False load
        that logs what it loaded, left from scratch, found mismatched and
        left unused), as the JAX ``Trainer.resume`` reads it:

        - ``.npz``, either package's converter output;
        - ``.pth`` / ``.pt``, a reference checkpoint. A ``save_model``
          payload also restores the intertwiner buffer and ``buffer_cnt``
          where both shapes match the state's; where they do not,
          ``TRAIN.STRICT_RESUME`` raises ``ValueError`` and otherwise the
          buffer stays as initialised and a line says so. Its epoch and
          iteration counters are restored;
        - ``.h5`` / ``.hdf5``, Matterport keras weights (needs ``h5py``).

        Any other suffix raises ``ValueError``. ``TRAIN.FORCE_START_EPOCH``
        then applies whatever the source. Every rank of a group reads the
        same file, then takes rank 0's state (``replicate``)."""
        log = self.log
        if self.cfg.DEV.SWITCH and self.cfg.DEV.BIG_FC_INIT_LIST:
            cw.apply_cross_name_init(self.model, self.cfg.DEV.BIG_FC_INIT_LIST,
                                     flax_paths(self.model), log_fn=log)
        path = ckpt.resolve_init(self.cfg, self.cfg.MISC.RESULT_FOLDER)
        if path and ckpt.CKPT_RE.search(os.path.basename(path)):
            self.state, epoch, it = ckpt.restore_checkpoint(path, self.state)
            self.epoch, self.iter = epoch, it + 1
            log(f"resumed from {path} (ep {epoch}, iter {it})")
        elif path:
            cw.merge_pretrained(self.model, self._read_pretrained(path), log_fn=log)
            log(f"initialized from pretrained weights: {path}")
        if self.cfg.TRAIN.FORCE_START_EPOCH:
            self.epoch = self.cfg.TRAIN.FORCE_START_EPOCH
            self.iter = 1
            log(f"FORCE_START_EPOCH={self.epoch}: schedule restarted there")
        replicate(self.model, self.state, self.group)
        return self

    def _read_pretrained(self, path: str):
        """(params, batch_stats) by flax leaf path from a pretrained file;
        a reference payload's buffer and counters go into the trainer."""
        cfg = self.cfg
        log = self.log
        if path.endswith(".npz"):
            return cw.load_converted_npz(path)
        if path.endswith((".h5", ".hdf5")):
            return cw.convert_keras_h5(path, cfg.MODEL.BACKBONE)
        if not path.endswith((".pth", ".pt")):
            raise ValueError(f"unrecognized pretrained weight format: {path!r} "
                             "(expected .npz from the converter CLI, .pth, or .h5)")
        sd, extras = cw.load_reference_checkpoint(path)
        loaded = cw.convert_reference_state_dict(sd, arch=cfg.MODEL.BACKBONE,
                                                 upsample_fac=cfg.DEV.UPSAMPLE_FAC, log_fn=log)
        buf, cnt = extras.get("buffer"), extras.get("buffer_cnt")
        state = self.state
        if (buf is not None and np.size(buf) and np.shape(buf) == tuple(state.buffer.shape)
                and cnt is not None and np.shape(cnt) == tuple(state.buffer_cnt.shape)):
            state.buffer = torch.as_tensor(np.asarray(buf, np.float32), device=self.device)
            state.buffer_cnt = torch.as_tensor(np.asarray(cnt, np.float32), device=self.device)
            log(f"restored intertwiner buffer {np.shape(buf)}")
        elif buf is not None and np.size(buf):
            msg = (f"payload buffer not restored: buffer {np.shape(buf)} vs "
                   f"{tuple(state.buffer.shape)}, buffer_cnt "
                   f"{np.shape(cnt) if cnt is not None else None} vs "
                   f"{tuple(state.buffer_cnt.shape)}")
            if cfg.TRAIN.STRICT_RESUME:
                raise ValueError(msg + " — TRAIN.STRICT_RESUME forbids silently reinitializing "
                                 "the intertwiner buffer (set it False to accept the "
                                 "reference's fallback, tools/utils.py:374-389)")
            log(msg + "; reinitialized")
        if extras.get("epoch") is not None:
            self.epoch = int(extras["epoch"])
            self.iter = int(extras.get("iter", 0)) + 1
            log(f"resumed counters from payload (ep {self.epoch}, iter {self.iter - 1})")
        return loaded


def train_model(trainer: Trainer, loader, layers: str, val_api=None, val_dataset=None) -> None:
    """One stage; its epochs end at the cumulative SCHEDULE of the stage.
    With ``TRAIN.DO_VALIDATION`` and a ``val_dataset`` (and its COCO index
    ``val_api``), the stage ends with an evaluation of its last epoch."""
    cfg = trainer.cfg
    stage_name = layers.upper()
    if trainer.iter > len(loader):
        # resumed from an end-of-epoch checkpoint: start the next epoch
        trainer.epoch += 1
        trainer.iter = 1
    total_ep = int(np.sum(cfg.TRAIN.SCHEDULE[:STAGE_ORDER[layers]]))
    if trainer.epoch > total_ep:
        trainer.log(f"skip {stage_name} stage ...")
        return
    trainer.log(f"\n[Stage {stage_name}] start at epoch {trainer.epoch}, "
                f"iter {trainer.iter}; stage ends at epoch {total_ep}.")
    for ep in range(trainer.epoch, total_ep + 1):
        epoch_str = f"[Ep {ep:03d}/{total_ep}]"
        trainer.log(epoch_str)
        train_epoch(trainer, loader, layers, ep, start_iter=trainer.iter,
                    stage_name=stage_name, epoch_str=epoch_str)
        ckpt.save_checkpoint(cfg.MISC.RESULT_FOLDER, trainer.state, ep, len(loader),
                             keep=cfg.TRAIN.KEEP_CHECKPOINTS, group=trainer.group)
        trainer.iter = 1
        trainer.epoch = ep
    trainer.epoch += 1
    if cfg.TRAIN.DO_VALIDATION and val_dataset is not None:
        trainer.log(f"\nValidation at end of stage [{stage_name}] ...")
        test_model(trainer.model, cfg, val_dataset, val_api, epoch=trainer.epoch - 1,
                   group=trainer.group)


BATCH_KEYS = ("images", "gt_class_ids", "gt_boxes", "gt_masks")


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays of a loader batch the train step reads, as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device) for k in BATCH_KEYS}


def train_epoch(trainer: Trainer, loader, layers: str, epoch: int,
                start_iter: int = 1, stage_name: str = "", epoch_str: str = "") -> None:
    cfg = trainer.cfg
    set_trainable(trainer.model, layers)
    total_iter = len(loader)
    save_base = max(1, math.floor(total_iter / cfg.TRAIN.SAVE_FREQ_WITHIN_EPOCH))
    # the meta loss takes effect after a fraction of epoch 1
    if epoch == 1 and cfg.DEV.SWITCH:
        do_meta_after = math.floor(cfg.DEV.EFFECT_AFER_EP_PERCENT * total_iter)
    else:
        do_meta_after = -1

    loader.set_epoch(epoch)
    # CTRL.PROFILE_ANALYSIS: the wall time of the loader's next() ("fetch")
    # and of the step up to its last kernel ("step"), reported with the loss
    timer = PhaseTimer(enabled=bool(cfg.CTRL.PROFILE_ANALYSIS))
    on_card = trainer.device.type == "cuda"
    it = 0
    t_iter = time.time()
    batches = iter(loader)
    while True:
        with timer.phase("fetch"):
            batch = next(batches, None)
        if batch is None:
            break
        it += 1
        if it > total_iter:
            break
        if it < start_iter:
            continue
        lr = learning_rate(cfg, epoch, it)
        meta_gate = 1.0 if it > do_meta_after else 0.0
        generator = torch.Generator(device=trainer.device)
        generator.manual_seed(iteration_seed(cfg.MISC.SEED, epoch, it, trainer.rank))
        try:
            device_batch = to_device(batch, trainer.device)
            with timer.phase("step"):
                metrics = train_step(trainer.state, cfg, device_batch, lr, meta_gate, generator,
                                     group=trainer.group)
                if on_card and timer.enabled:
                    torch.cuda.synchronize(trainer.device)
        except Exception as exc:
            trainer.metrics_logger.log(epoch=epoch, iter=it,
                                       error=f"{type(exc).__name__}: {exc}")
            print_log(f"[ERROR] ep {epoch} iter {it}: {exc}", cfg.MISC.LOG_FILE)
            raise
        if trainer.rank == 0 and (it % cfg.CTRL.SHOW_INTERVAL == 0 or it == start_iter
                                  or it == total_iter):
            host = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t_iter
            trainer.log(format_loss_line(stage_name, epoch_str, it, total_iter, lr, host,
                                         dt / max(1, cfg.CTRL.SHOW_INTERVAL)))
            trainer.metrics_logger.log(epoch=epoch, iter=it, lr=lr, **host)
            timer.report(trainer.log)
            t_iter = time.time()
        if it % save_base == 0:
            ckpt.save_checkpoint(cfg.MISC.RESULT_FOLDER, trainer.state, epoch, it,
                                 keep=cfg.TRAIN.KEEP_CHECKPOINTS, group=trainer.group)
    trainer.iter = 1


# --- evaluation -----------------------------------------------------------------------
def _np_greedy_nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> np.ndarray:
    """Host greedy NMS over (y1, x1, y2, x2) boxes -> kept indices, for the
    fusion of several test scales."""
    order = np.argsort(-scores, kind="stable")
    areas = (np.maximum(boxes[:, 2] - boxes[:, 0], 0)
             * np.maximum(boxes[:, 3] - boxes[:, 1], 0))
    suppressed = np.zeros(len(boxes), bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        yy1 = np.maximum(boxes[i, 0], boxes[:, 0])
        xx1 = np.maximum(boxes[i, 1], boxes[:, 1])
        yy2 = np.minimum(boxes[i, 2], boxes[:, 2])
        xx2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(yy2 - yy1, 0) * np.maximum(xx2 - xx1, 0)
        iou = inter / np.maximum(areas[i] + areas - inter, 1e-9)
        suppressed |= iou > thresh
    return np.asarray(keep, np.int64)


def fuse_multiscale(per_scale, max_instances: int, thresh: float):
    """One image's detections from several test scales, each (boxes,
    class_ids, scores, full_masks) in original-image pixels: per-class greedy
    NMS across the scales, then the ``max_instances`` best by score."""
    boxes = np.concatenate([p[0] for p in per_scale]).astype(np.float32)
    cls = np.concatenate([p[1] for p in per_scale])
    scores = np.concatenate([p[2] for p in per_scale])
    masks = [m for p in per_scale for m in p[3]]
    keep_all = []
    for c in np.unique(cls):
        idx = np.where(cls == c)[0]
        keep_all.extend(idx[_np_greedy_nms(boxes[idx], scores[idx], thresh)])
    keep = np.asarray(sorted(keep_all, key=lambda i: -scores[i])[:max_instances], np.int64)
    return (boxes[keep].astype(np.int32), cls[keep], scores[keep], [masks[i] for i in keep])


def _detect_stream(model, cfg, val_dataset, image_ids: Sequence[int], eval_masks: bool,
                   dims, combine, group=None):
    """Inference in chunks of ``TEST.BATCH_SIZE`` images. ``dims`` are
    (min_dim, max_dim) scales, None for the config's: each chunk is decoded
    once and detected at every scale; ``combine`` reduces an image's
    per-scale (boxes, class_ids, scores, full_masks) list to one. Yields
    (index, image, boxes, class_ids, scores, full_masks) in original-image
    pixels. Over the ranks of ``group`` the chunk is rounded up to a
    multiple of their count, and each rank decodes and detects only its
    share of it (the last chunk's shares may be short or empty) and yields
    those images."""
    rank, world = rank_and_world(group)
    bs = max(1, int(cfg.TEST.BATCH_SIZE), world)
    bs += (-bs) % world
    for start in range(0, len(image_ids), bs):
        chunk = image_ids[start:start + bs][shard_rows(bs, rank, world)]
        if not chunk:
            continue
        images = [val_dataset.load_image(int(i)) for i in chunk]
        per_scale = [detect(model, images, cfg, with_masks=eval_masks, min_dim=lo, max_dim=hi)
                    for lo, hi in dims]
        for k, idx in enumerate(chunk):
            per_image = [(r[k]["rois"], r[k]["class_ids"], r[k]["scores"], r[k]["masks"])
                         for r in per_scale]
            yield (idx, images[k], *combine(per_image))


def _detect_images(model, cfg, val_dataset, image_ids, eval_masks: bool, group=None):
    """One scale, the config's: detections pass through unchanged."""
    yield from _detect_stream(model, cfg, val_dataset, image_ids, eval_masks, [(None, None)],
                              combine=lambda per: per[0], group=group)


def _detect_images_multiscale(model, cfg, val_dataset, image_ids, eval_masks: bool,
                              scales: Sequence[int], group=None):
    """Every scale ``s`` of ``scales`` (images molded to ``s``² with the
    config's aspect of min to max dim), fused per image with cross-scale
    per-class NMS."""
    ratio = cfg.DATA.IMAGE_MIN_DIM / cfg.DATA.IMAGE_MAX_DIM
    dims = [(int(round(s * ratio)), int(s)) for s in scales]

    def combine(per_image):
        return fuse_multiscale(per_image, cfg.TEST.DET_MAX_INSTANCES,
                               cfg.TEST.MULTI_SCALE_NMS_THRESHOLD)

    yield from _detect_stream(model, cfg, val_dataset, image_ids, eval_masks, dims, combine,
                              group)


def cache_path(cfg, epoch: int, n_images: int, eval_masks: bool) -> str:
    """The det-result cache of an evaluation; its name carries everything
    the results depend on: epoch, image count, mask mode, dtype and scales."""
    tags = f"_n{n_images}"
    if eval_masks:
        tags += "_masks"
    if cfg.TEST.DTYPE:
        tags += f"_{cfg.TEST.DTYPE}"
    if cfg.TEST.MULTI_SCALE:
        tags += "_ms" + "-".join(str(int(s)) for s in cfg.TEST.MULTI_SCALE)
    return os.path.join(cfg.MISC.RESULT_FOLDER or ".", f"det_result_ep{epoch:04d}{tags}.json")


def coco_stats(coco_api, results: List[dict], img_ids: Sequence[int], iou_type: str = "bbox",
               log_file: Optional[str] = None) -> np.ndarray:
    """The 12 COCOeval stats of COCO-format ``results`` on ``img_ids``."""
    ev = COCOeval(coco_api, coco_api.loadRes(results), iou_type)
    ev.params.img_ids = sorted(img_ids)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize(log_file)


def _broadcast(obj, group):
    """Rank 0's ``obj`` on every rank of ``group`` (``obj`` itself without
    one)."""
    if group is None:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(box, src=torch.distributed.get_global_rank(group, 0),
                                            group=group)
    return box[0]


def test_model(model, cfg, val_dataset, coco_api, epoch: int = 0, limit: Optional[int] = None,
               eval_masks: bool = False, group=None) -> np.ndarray:
    """COCO evaluation of ``model`` on ``val_dataset`` against ``coco_api``
    (its ground truth); returns the 12 bbox stats, and prints them (and the
    segm stats with ``eval_masks``) to the console and the log.

    ``val_dataset`` has ``image_ids``, ``load_image``, ``image_info`` (with
    each image's COCO ``id``) and ``get_source_class_id``. Detections are
    cached in the run's folder and read back when the cache exists. The
    model evaluates in its own dtype (``InterNet.dtype``), as the JAX
    ``test_model`` does; ``main.py`` re-types it for ``TEST.DTYPE``.

    ``TEST.SAVE_IM`` draws each evaluated image's detections (full-size
    boxes, class names, scores) to ``<folder>/images/det_<coco id>.png``
    (``utils/visualize.py::display_instances``); it needs ``matplotlib``
    and raises ``ImportError`` before any inference without it.

    Over the ranks of ``group`` every rank detects its share of each chunk
    (and draws its own images); rank 0 gathers the detections in image
    order, writes the cache, logs and runs COCOeval; every rank returns
    its stats."""
    if cfg.TEST.SAVE_IM:
        require_matplotlib("TEST.SAVE_IM")
    rank, _ = rank_and_world(group)
    folder = cfg.MISC.RESULT_FOLDER or "."
    os.makedirs(folder, exist_ok=True)
    log_file = cfg.MISC.LOG_FILE
    image_ids = list(val_dataset.image_ids)
    if limit:
        image_ids = image_ids[:limit]
    cache = cache_path(cfg, epoch, len(image_ids), eval_masks)
    from_cache = _broadcast(os.path.exists(cache), group)
    results = None
    if from_cache and rank == 0:
        print_log(f"loading cached detections: {cache}", log_file)
        with open(cache) as f:
            results = json.load(f)
    elif not from_cache:
        t0 = time.time()
        scales = [int(s) for s in (cfg.TEST.MULTI_SCALE or [])]
        if scales:
            stream = _detect_images_multiscale(model, cfg, val_dataset, image_ids, eval_masks,
                                               scales, group=group)
        else:
            stream = _detect_images(model, cfg, val_dataset, image_ids, eval_masks, group=group)
        position = {int(i): n for n, i in enumerate(image_ids)}
        per_image = []
        for idx, image, boxes, class_ids, scores, full_masks in stream:
            coco_id = int(val_dataset.image_info[int(idx)]["id"])
            if cfg.TEST.SAVE_IM:
                display_instances(image, boxes, class_ids,
                                  getattr(val_dataset, "class_names", None), scores=scores,
                                  save_path=os.path.join(folder, "images", f"det_{coco_id}.png"))
            found = []
            for j in range(len(class_ids)):
                y1, x1, y2, x2 = boxes[j]
                result = {
                    "image_id": coco_id,
                    "category_id": val_dataset.get_source_class_id(int(class_ids[j]), "coco"),
                    "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                    "score": float(scores[j]),
                }
                if eval_masks and full_masks[j] is not None:
                    result["segmentation"] = RLE.encode(full_masks[j]).to_coco()
                found.append(result)
            per_image.append((position[int(idx)], found))
        if group is not None:
            gathered = [None] * torch.distributed.get_world_size(group)
            torch.distributed.all_gather_object(gathered, per_image, group=group)
            per_image = sorted(p for part in gathered for p in part)
        dt = time.time() - t0
        if rank == 0:
            results = [r for _, found in per_image for r in found]
            print_log(f"prediction time: {dt:.2f}s ({dt / max(len(image_ids), 1):.3f} s/im)",
                      log_file)
            MetricsLogger(os.path.join(folder, "metrics.jsonl")).log(
                eval_epoch=epoch, n_images=len(image_ids), prediction_s=dt)
            with open(cache, "w") as f:
                json.dump(results, f)
    stats = None
    if rank == 0:
        stats = _report(cfg, coco_api, val_dataset, image_ids, results, epoch, from_cache,
                        eval_masks)
    return _broadcast(stats, group)


def _report(cfg, coco_api, val_dataset, image_ids, results, epoch: int, from_cache: bool,
            eval_masks: bool) -> np.ndarray:
    """COCOeval of ``results``, logged, with the epoch's AP line."""
    folder = cfg.MISC.RESULT_FOLDER or "."
    log_file = cfg.MISC.LOG_FILE
    if not results:
        print_log("no detections produced; skipping COCOeval", log_file)
        return np.zeros(12)
    img_ids = [val_dataset.image_info[int(i)]["id"] for i in image_ids]
    stats = coco_stats(coco_api, results, img_ids, "bbox", log_file)
    # one AP line per epoch: a re-evaluation from the cache logs none when
    # the first evaluation of the epoch already did
    mpath = os.path.join(folder, "metrics.jsonl")
    have_epoch = False
    if from_cache and os.path.exists(mpath):
        with open(mpath) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "AP" in rec and rec.get("epoch") == epoch:
                    have_epoch = True
                    break
    if not have_epoch:
        MetricsLogger(mpath).log(epoch=epoch, AP=stats[0], AP50=stats[1], AP75=stats[2],
                                 AP_small=stats[3], AP_medium=stats[4], AP_large=stats[5])
    if eval_masks:
        coco_stats(coco_api, results, img_ids, "segm", log_file)
    return stats
