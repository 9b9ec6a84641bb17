"""Set B of ``test_torch_train_options_step.py`` (``TRAIN.OPTIM_METHOD
rmsprop``, ``DEV.DIS_REG_LOSS``, ``DEV.BASELINE`` with ``DEV.DIS_UPSAMPLER``)
in a float32 train step against the jitted JAX step, held as that module's
docstring says; then set A (Adam, ``BN_LEARN``, ``BIG_SUPERVISE``,
``BIG_FEAT_DETACH False``, ``BIG_FC_INIT coco_pretrain``) through the command
line on the CPU at the README's small sizes in float32 (bfloat16 convolutions
are slow on the CPU): one epoch of one step, then a resume for a second
one from its checkpoint, with Adam's step count carried over and ``big_fc``
seeded from the classifier; and set B through the command line for one
epoch.
"""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import json

import numpy as np
import torch

from feature_intertwiner_tpu_torch import main as port_main
from feature_intertwiner_tpu_torch.train.step import REG_LOSS_KEYS
from test_torch_makeup_train import makeup_steps
from test_torch_train_options_step import SET_A, SET_B, check_step
from test_torch_trainer import CLI_OPTS


def test_set_b_step_matches_jax_in_float32():
    """RMSprop, the regression losses' values dropped, the baseline Dev (no
    critic, no statistics, no meta loss) without a make-up layer."""
    step = makeup_steps("set_b", **SET_B)
    pm, state, want_sd = check_step(step, ("mu", "nu", "trace"))
    for k in REG_LOSS_KEYS:
        assert pm[k] == 0.0 and step["jax"][torch.float32][0][k] == 0.0, k
    assert pm["meta_loss"] == pm["big_loss"] == 0.0
    assert not any(k.startswith("dev_roi.") for k in want_sd)
    before, after = step["before"], state.model.state_dict()
    moved = [k for k in after if k.startswith("mask.") and not torch.equal(after[k], before[k])]
    assert "mask.conv5.weight" in moved and "mask.deconv.weight" in moved


def test_cli_trains_set_a_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--phase", "train", "--synthetic_data", "--device", "cpu", "--config_name", "set_a",
            *CLI_OPTS, "TRAIN.BATCH_SIZE", "8", "TRAIN.DO_VALIDATION", "False",
            "TRAIN.INIT_LR", "0.0001", "TPU.COMPUTE_DTYPE", "float32",
            "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2", "DEV.BUFFER_SIZE", "1",
            *SET_A["opts"]]
    first = port_main.main([*base, "TRAIN.SCHEDULE", "[1, 0, 0]"])
    assert first.state.step == 1 and first.state.optimizer.param_groups[0]["count"] == 1
    resumed = port_main.main([*base, "TRAIN.SCHEDULE", "[2, 0, 0]"])
    assert resumed.state.step == 2 and resumed.state.optimizer.param_groups[0]["count"] == 2
    log = (tmp_path / "results/set_a/train/log.txt").read_text()
    assert "resumed from" in log and "[cross-init] dev/big_fc/kernel <- " in log
    lines = [json.loads(x) for x in (tmp_path / "results/set_a/train/metrics.jsonl").read_text()
             .splitlines()]
    steps = [x for x in lines if "total_loss" in x]
    assert len(steps) == 2 and all(np.isfinite(x["total_loss"]) and np.isfinite(x["big_loss"])
                                   for x in steps)
    assert all(m.training is False for m in resumed.model.modules())


def test_cli_trains_set_b(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = port_main.main([
        "--phase", "train", "--synthetic_data", "--device", "cpu", "--config_name", "set_b",
        *CLI_OPTS, "TRAIN.BATCH_SIZE", "8", "TRAIN.DO_VALIDATION", "False",
        "TRAIN.INIT_LR", "0.0001", "TPU.COMPUTE_DTYPE", "float32",
        "TRAIN.SCHEDULE", "[1, 0, 0]", "DEV.SWITCH", "True", "DEV.LOSS_CHOICE", "l2",
        "DEV.BUFFER_SIZE", "1", *SET_B["opts"]])
    assert trainer.state.step == 1 and not hasattr(trainer.model.dev_roi, "feat_extract")
    assert trainer.model.dev_roi.upsample is None                 # DIS_UPSAMPLER
    lines = [json.loads(x) for x in (tmp_path / "results/set_b/train/metrics.jsonl").read_text()
             .splitlines()]
    steps = [x for x in lines if "total_loss" in x]
    assert steps and all(x[k] == 0.0 for x in steps for k in REG_LOSS_KEYS)
    assert all(np.isfinite(x["total_loss"]) and x["meta_loss"] == 0.0 for x in steps)
    state = trainer.state.optimizer.state
    assert all(set(s) == {"mu", "nu", "trace"} for s in state.values())
