"""Data parallelism over ``torch.distributed``: one process (rank) per card.

Port of ``feature_intertwiner_tpu/parallel/data_parallel.py``, whose
``shard_map`` over a 1-D ``data`` mesh becomes N processes started by
``torchrun``:

- the global batch (``TRAIN.BATCH_SIZE``) is split on its leading axis,
  rank r taking rows ``[r·B/N, (r+1)·B/N)`` (:func:`shard_batch`; the loader
  collates only those rows, ``data/loader.py``); N must divide B;
- the model, its optimizer state and the intertwiner buffer are the same
  on every rank: :func:`replicate` broadcasts rank 0's at start, and every
  step applies the same averaged update;
- the train step (``train/step.py``) sums the Dev's per-level statistics
  over ranks with :func:`all_reduce_sum`, whose backward is a sum over ranks
  too, as the transpose of JAX's ``psum``; it averages the gradients in one
  flat bucket (:func:`mean_gradients`) before the clip, the losses over
  ranks and sums the RoI counts (:func:`reduce_metrics`), and under
  ``TRAIN.BN_LEARN`` averages the BN running statistics
  (:func:`mean_bn_statistics`);
- each rank's sampling generator is seeded from (seed, epoch, iteration,
  rank), the counterpart of JAX's ``fold_in(rng, axis_index)``
  (``train/workflow.py::iteration_seed``).

The collectives are the backend's (NCCL on the card, gloo on the CPU, or
gloo on a card that several ranks share). The gradients are averaged
explicitly rather than by ``DistributedDataParallel``: the step gives
every trainable parameter a gradient itself, averages the BN statistics
where DDP would copy rank 0's, and reduces exactly where JAX's ``pmean``
sits. Without ``torchrun``'s environment there is no group, and every
function here that takes one does nothing when it is None.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# the metrics the step averages over ranks (JAX ``pmean``); the RoI counts
# are whole-batch totals and are summed
MEAN_METRICS = ("rpn_class_loss", "rpn_bbox_loss", "mrcnn_class_loss", "mrcnn_bbox_loss",
                "mrcnn_mask_loss", "total_loss", "meta_loss", "big_loss", "fpn_ot_loss")


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> Tuple[torch.device, Optional[dist.ProcessGroup]]:
    """(this rank's device, the group) from ``torchrun``'s ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``.

    Without them: ``(device, None)``, a single process. Under ``torchrun``
    (at any world size, 1 included, so that the collectives run) the rank
    joins the default group: ``backend`` NCCL for a CUDA ``device`` and gloo
    for the CPU unless given (gloo lets several ranks share one card). A
    CUDA rank runs on ``cuda:LOCAL_RANK`` modulo the cards present. A group
    that is already initialised is joined as it is."""
    dev = torch.device(device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return dev, None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu for gloo ranks "
                               "on the CPU")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev, dist.group.WORLD


def rank_and_world(group: Optional[dist.ProcessGroup]) -> Tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows ``[r·n/N, (r+1)·n/N)`` of ``n``; raises
    ``ValueError`` when ``world`` does not divide ``n`` (JAX: "batch leading
    dim must divide by mesh size")."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks: "
                         f"TRAIN.BATCH_SIZE is the global batch and the rank count must divide it")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: Dict[str, object], rank: int, world: int) -> Dict[str, object]:
    """This rank's rows of every array of a global batch (leading axis)."""
    rows = shard_rows(len(next(iter(batch.values()))), rank, world)
    return {k: v[rows] for k, v in batch.items()}


def replicate(model: torch.nn.Module, state, group: Optional[dist.ProcessGroup]) -> None:
    """Broadcast rank 0's parameters, buffers (BN statistics), optimizer
    state, intertwiner buffer and counts to every rank of ``group``, in
    place."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    tensors = [t.data for t in model.parameters()] + [t for t in model.buffers()]
    opt = state.optimizer
    for p in model.parameters():
        tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                    if isinstance(v, torch.Tensor)]
    tensors += [state.buffer, state.buffer_cnt]
    for t in tensors:
        dist.broadcast(t, src, group=group)


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its gradient is the sum over ranks of the
    gradients (the transpose of ``psum`` under JAX's ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # autograd may hand in an expanded (stride 0) gradient
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``x`` itself without one),
    differentiable: each rank's gradient is the sum of all ranks'."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def _mean_flat(tensors: Iterable[torch.Tensor], group: dist.ProcessGroup) -> None:
    """Average ``tensors`` over ranks in place, through one flat bucket per
    dtype (a sum, then a division by the world size, as ``pmean``)."""
    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def mean_gradients(params: Iterable[torch.nn.Parameter],
                   group: Optional[dist.ProcessGroup]) -> None:
    """Average the ``.grad`` of ``params`` over ranks, in place."""
    if group is not None:
        _mean_flat([p.grad for p in params], group)


def mean_bn_statistics(model: torch.nn.Module, group: Optional[dist.ProcessGroup]) -> None:
    """Average every BN module's running mean and variance over ranks (JAX
    ``pmean`` of ``batch_stats`` under ``TRAIN.BN_LEARN``)."""
    if group is None:
        return
    stats = [t for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)
             for t in (m.running_mean, m.running_var) if t is not None]
    _mean_flat(stats, group)


def reduce_metrics(metrics: Dict[str, torch.Tensor], group: Optional[dist.ProcessGroup]
                   ) -> Dict[str, torch.Tensor]:
    """The step's metrics over ranks, in one all-reduce: those of
    :data:`MEAN_METRICS` averaged, the rest (RoI counts) summed; each keeps
    its dtype."""
    if group is None:
        return metrics
    world = dist.get_world_size(group)
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(flat, group=group)
    return {k: (v / world if k in MEAN_METRICS else v).to(metrics[k].dtype)
            for k, v in zip(keys, flat)}
