"""The OT meta loss in its ``fc`` form (``DEV.OT_ONE_DIM_FORM fc``): one
float32 'all' train step of the port against the jitted JAX step, held as
``test_torch_ot_train.py`` holds its ``conv_fpn`` case (that module's
docstring gives the setup and the tolerances)."""

import test_torch_workers  # noqa: F401  (first: sizes this xdist worker's thread pools)

import pytest

from test_torch_ot_train import _steps, check_float32_step


@pytest.fixture(scope="module")
def fc_step():
    return _steps("fc")


def test_fc_train_step_matches_jax_in_float32(fc_step):
    check_float32_step(fc_step)
