"""The make-up layer's variants in training, and the command line with the
make-up layer at ``UPSAMPLE_FAC`` 2 and ``CLS_MERGE_FEAT``, on the CPU.

- One float32 train step of stage 'heads' against the jitted JAX step,
  as ``test_torch_makeup_train.py`` sets it up and holds it (losses within
  1e-4 relative, parameters within 1e-5 of each tensor's largest
  magnitude, the buffer within 1e-4), for ``multi_residual`` (one make-up
  block per level at factor 2, the gated residual, ``linear_add``) and
  ``dis_merge`` (no make-up layer, the merge on P2-P5). 'heads' trains all
  that the variants change (the FPN, the Dev layers, the heads) and leaves
  the backbone's gradient, which 'all' in ``test_torch_makeup_train.py``
  holds, out of the JAX step's compilation (a fifth of its time).
- ``--phase train`` and then ``--phase inference`` at the README's small
  sizes with ``DEV.UPSAMPLE_FAC 2.0 DEV.CLS_MERGE_FEAT True``: the model has
  the transposed make-up conv and the merge, the metrics are finite, the
  evaluation gives its 12 stats.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json

import numpy as np
import pytest
import torch

from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.models.common import ConvTranspose2d
from test_torch_makeup_train import check_float32_step, makeup_steps
from test_torch_trainer import CLI_OPTS


@pytest.mark.parametrize("name", ["multi_residual", "dis_merge"])
def test_variant_train_step_matches_jax_in_float32(name):
    check_float32_step(makeup_steps(name, layers="heads"))


def test_cli_trains_and_evaluates_at_factor_2_with_the_merge(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--synthetic_data", "--device", "cpu", "--config_name", "up2", *CLI_OPTS,
            "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2", "DEV.BUFFER_SIZE", "1",
            "DEV.UPSAMPLE_FAC", "2.0", "DEV.CLS_MERGE_FEAT", "True"]
    trainer = port_main.main(["--phase", "train", *base, "TRAIN.BATCH_SIZE", "4",
                              "TRAIN.SCHEDULE", "[1, 0, 0]", "TRAIN.DO_VALIDATION", "False"])
    model = trainer.model
    assert trainer.cfg.DEV.UPSAMPLE_FAC == 2.0 and model.classifier.merge_feat
    assert isinstance(model.dev_roi.upsample[0][0], ConvTranspose2d)
    assert trainer.state.step == 2
    lines = [json.loads(x) for x in (tmp_path / "results/up2/train/metrics.jsonl").read_text()
             .splitlines()]
    steps = [x for x in lines if "total_loss" in x]
    assert steps and all(np.isfinite(x["total_loss"]) and np.isfinite(x["meta_loss"])
                         for x in steps)
    stats = port_main.main(["--phase", "inference", *base])
    assert stats.shape == (12,) and np.isfinite(stats).all()
    assert all(p.dtype == torch.float32 for p in model.parameters())
