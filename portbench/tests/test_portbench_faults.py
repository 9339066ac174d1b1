"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision below the configuration's, in the program's
place) and each fault a cell can have, planted under a whole run of the
harness (the look for a card skipped, the narrow cells on the CPU)."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import SERVE, TRAIN, bench, narrow_cell
from portbench import sides
from portbench.run import run_cell

SEED = 2**31 + 77


def _run(workload, hook, device="cpu", cell=None):
    cell = cell or narrow_cell(workload)
    line, _ = run_cell(bench(), workload, SEED, 0.2, False, device, time.perf_counter(), program_hook=hook,
                       say=lambda s: None, cell=cell)
    return line


def test_serve_sound_run_is_correct():
    assert _run(SERVE, None)["correct"]


def test_serve_control_is_not_correct():
    """The reference in fp8 (matmul and convolution operands in e4m3 under
    the bf16 policy) served in the program's place."""
    cell = narrow_cell(SERVE)
    line = _run(SERVE, lambda prog: sides.serve_reference(cell.config["config"], SEED, "cpu", "fp8"), cell=cell)
    assert not line["correct"], line["checks"]


class _AlteredColours:
    """The served colours altered where they are produced: the first
    target view comes back as the background alone, a view never rendered."""

    def __init__(self, prog):
        self.prog = prog

    def encode(self, context):
        return self.prog.encode(context)

    def decode(self, gaussians, target, shape):
        color = self.prog.decode(gaussians, target, shape).clone()
        color[:, 0] = 0.0
        return color


def test_serve_altered_answer_is_not_correct():
    line = _run(SERVE, _AlteredColours)
    assert not line["correct"], line["checks"]


class _Unchanged:
    """A step that returns its state unchanged: the parameters put back and
    the optimizer's state dropped after every step."""

    def __init__(self, side):
        self.side = side

    def step(self, batch):
        keep = {k: p.detach().clone() for k, p in self.side.named_parameters().items()}
        logs = self.side.step(batch)
        with torch.no_grad():
            for k, p in self.side.named_parameters().items():
                p.copy_(keep[k])
        self.side.state.optimizer.state.clear()
        return logs

    def named_parameters(self):
        return self.side.named_parameters()

    def first_gradient_norms(self):
        return self.side.first_gradient_norms()


class _HalfBatch(_Unchanged):
    """Half of the batch left out, the mean taken over the rest."""

    def step(self, batch):
        half = {side: {k: v[: v.shape[0] // 2] for k, v in views.items()} for side, views in batch.items()}
        return self.side.step(half)


def test_train_sound_run_is_correct():
    assert _run(TRAIN, None)["correct"]


@pytest.mark.parametrize("fault", [_Unchanged, _HalfBatch], ids=["state-unchanged", "half-batch"])
def test_train_fault_is_not_correct(fault):
    line = _run(TRAIN, fault)
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
def test_train_control_is_not_correct(card):
    """The reference with TF32 on (matmuls and cuDNN convolutions), in the
    program's place, on the card: float32 as the configuration states it
    has TF32 off."""
    cell = narrow_cell(TRAIN)

    class _Tf32(_Unchanged):
        def step(self, batch):
            flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                return self.side.step(batch)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    line = _run(TRAIN, lambda prog: _Tf32(sides.train_reference(cell.config["config"], SEED, card)), card, cell)
    assert not line["correct"], line["checks"]
