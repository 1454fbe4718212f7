"""Training through the recurrent layers (`repro_torch.models.ssm`) on the
CPU: `chunked_scan`'s per-chunk checkpoint against the plain scan, the
layers' train-mode gradients against the reference's, and one train step
of REDUCED jamba-v0.1-52b (here) and xlstm-350m
(tests/test_torch_train_xlstm.py; the split keeps each file under ~90 s
on one worker) against the reference's
(`torch_train_ref.check_train_step`). Both configs accumulate gradients
over microbatches (grad_accum 16 and 2, so M = gcd(grad_accum, B) = 2
at B = 2).

Tolerances: chunked against plain, bitwise (the same ops; checkpointing
only recomputes them); a layer's output and gradients within
`torch_train_ref.LAYER_TOL` of jax.grad through the reference's layer;
the train steps the reference's 2e-3.
"""

import numpy as np
import pytest
import torch

from repro_torch.models import ssm as S
from torch_train_ref import check_layer_train_gradients, check_train_step

torch.set_num_threads(1)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("chunk", [1, 5, 8, 64])
def test_chunked_scan_gradients_equal_the_plain_scan(chunk):
    """An mLSTM-cell scan over T = 24 steps: the state, outputs and every
    gradient with `chunk` (5 does not divide 24: gcd 1, as the
    reference's) bitwise equal to the plain scan's."""
    B, H, dh, Tn = 2, 2, 4, 24
    xs = [torch.from_numpy(_np(s, 30 + i)) for i, s in enumerate(
        [(Tn, B, H, dh)] * 3 + [(Tn, B, H)] * 2)]
    xs[4] = torch.nn.functional.logsigmoid(xs[4] + 2.0)
    runs = []
    for ck in (None, chunk):
        leaves = [x.clone().requires_grad_() for x in xs]
        state0 = (torch.zeros(B, H, dh, dh), torch.zeros(B, H, dh),
                  torch.full((B, H), -float("inf")))
        (C, n, m), hs = S.chunked_scan(S._mlstm_cell, state0, tuple(leaves),
                                       ck)
        loss = (hs * torch.linspace(-1, 1, hs.numel()).reshape(
            hs.shape)).sum() + C.square().sum() + n.sum()
        runs.append([C, n, m, hs] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert runs[0][4].abs().sum() > 0


def test_chunked_scan_without_autograd_is_the_plain_loop():
    x = torch.arange(12.0).reshape(6, 2)
    step = lambda c, x_t: (c + x_t, c * x_t)  # noqa: E731
    with torch.no_grad():
        got = S.chunked_scan(step, torch.zeros(2), x, 4)
    want = S.chunked_scan(step, torch.zeros(2), x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mamba_train_gradients_match_reference():
    check_layer_train_gradients("mamba")


def test_jamba_train_step_matches_reference():
    check_train_step("jamba_v01_52b")
