"""Training through xLSTM's layers on the CPU: mLSTM's and sLSTM's
train-mode gradients against jax.grad through the reference's layers, and
one train step of REDUCED xlstm-350m (grad_accum 2, so two microbatches
at B = 2) against the reference's within its 2e-3 (tolerances in
tests/torch_train_ref.py). Split from tests/test_torch_train_ssm.py to
keep each file under ~90 s on one worker.
"""

import pytest
import torch

from torch_train_ref import check_layer_train_gradients, check_train_step

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_layer_train_gradients_match_reference(kind):
    check_layer_train_gradients(kind)


def test_xlstm_train_step_matches_reference():
    check_train_step("xlstm_350m")
