"""The comparison that decides `correct` fails what it must, at a CPU
test's size: its control (the reference with TF32 products put in the
port's place), and a run whose timed path is broken underneath, once for
each fault the cell can have (a step that returns its state unchanged;
half of the batch left out, the mean taken over the rest; an answer
altered where it is produced). One card cell has no exchange between
chips, so that fault has no case."""

import pytest
import torch

import json
import os

from portbench import check, readings, run

TRAIN = ["dense_qm9.train_resident", "sparse_qm9.train_resident",
         "sparse_qm9.train_stream"]


@pytest.mark.parametrize("name", TRAIN + ["sparse_qm9.score_batch"])
def test_control_fails(tiny_cell, name):
    cell = tiny_cell(name)
    got = readings.readings(cell, 2**31 + 23, 0.2, True,
                            torch.device("cpu"))
    assert check.verdict(got["program"], cell.limits)
    assert not check.verdict(got["control"], cell.limits), got
    if name in TRAIN:
        assert not check.verdict(got["half_batch"], cell.limits), got


def _run(cell):
    return run.run_cell(cell, 2**31 + 29, 0.2, False, torch.device("cpu"),
                        started=0.0)


@pytest.mark.parametrize("name", TRAIN)
def test_state_left_unchanged_fails(tiny_cell, monkeypatch, name):
    from ggnn_tpu_torch.training.optimizer import TFAdam
    step = TFAdam.step

    def unchanged(self, grads):
        # Adam's moments still move, so the gradient reads as usual;
        # the parameters do not.
        saved = [p.detach().clone() for p in self.params.values()]
        step(self, grads)
        with torch.no_grad():
            for p, s in zip(self.params.values(), saved):
                p.copy_(s)

    monkeypatch.setattr(TFAdam, "step", unchanged)
    result = _run(tiny_cell(name))
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_fails(tiny_cell, monkeypatch, name):
    from ggnn_tpu_torch.training import runner as runner_module
    loss = runner_module.masked_regression_loss

    def half(computed, targets, target_mask, *args, **kwargs):
        keep = torch.ones_like(target_mask)
        real = int(target_mask.shape[1])
        keep[:, real // 2:] = 0.0
        return loss(computed, targets, target_mask * keep, *args, **kwargs)

    monkeypatch.setattr(runner_module, "masked_regression_loss", half)
    result = _run(tiny_cell(name))
    assert not result["correct"]


def test_altered_answer_fails(tiny_cell, monkeypatch):
    from ggnn_tpu_torch.serving import Predictor
    forward = Predictor._forward

    def altered(self, batch):
        out = forward(self, batch).copy()
        out[0, 0] += 1e-3
        return out

    monkeypatch.setattr(Predictor, "_forward", altered)
    result = _run(tiny_cell("sparse_qm9.score_batch"))
    assert not result["correct"]


@pytest.mark.cuda
def test_cell_on_the_card(tiny_cell, cuda):
    result = run.run_cell(tiny_cell("sparse_qm9.train_resident"), 7, 0.5,
                          True, cuda, started=0.0)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def test_window_driver_names():
    """Every mix names a driver file, and every driver file serves a
    mix."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    entries = set()
    for f in os.listdir(os.path.join(here, "traffic")):
        with open(os.path.join(here, "traffic", f)) as fh:
            entries.add(json.load(fh)["entry"])
    drivers = {f[:-3] for f in os.listdir(os.path.join(here, "drivers"))
               if f.endswith(".py")}
    assert entries == drivers == {"train_resident", "train_stream", "score"}
