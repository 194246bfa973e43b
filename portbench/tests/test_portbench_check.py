"""The check fails a broken timed path and its control.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, window, check) with the timed path broken underneath, once
for each fault a sampling cell can have:

* a step that returns its state unchanged (every DDIM step gives back
  its x: the draws are the prior draw);
* half of the batch left out (half of the members computed, the others
  copies of them, so the statistics are over half the members);
* an answer altered where it is produced (one survey's draws are
  another's);

and sees `correct` come out False; the sound run comes out True. On the
CPU at a tiny size (`tiny.py`); the tests marked gpu run them, and the
control, at the cells' own sizes on the card. (A cell on one card has
no exchange between chips to leave out.)
"""
import time

import pytest
import torch

import ertdx_torch.sample as port_sample
import ertdx_torch.serve as port_serve
from portbench import cells, control, harness
from portbench.tests.tiny import tiny_root

CELLS = ["ddim_ensemble.serve8", "v5e8_dp.sweep32"]


def _frozen_steps(denoise_fn, shape, schedule, *args, x_T=None, device=None,
                  rows=None, **kw):
    return x_T.to(device).clone()


def _wrap(fault):
    def wrapped(*args, **kw):
        u = _ORIGINAL(*args, **kw)         # (R, B, P)
        return fault(u.clone())
    return wrapped


def _half_members(u):
    half = u.shape[0] // 2
    u[half:2 * half] = u[:half]
    return u


def _altered_answer(u):
    u[:, 0] = u[:, 1]
    return u


_ORIGINAL = port_sample.posterior_ensemble
FAULTS = {
    "sound": None,
    "step returns its state": ("sample_ddim", _frozen_steps),
    "half the members": ("posterior_ensemble", _wrap(_half_members)),
    "one survey's answer altered": ("posterior_ensemble",
                                    _wrap(_altered_answer)),
}


def _run(monkeypatch, cell, fault, device, root, seconds):
    if FAULTS[fault] is not None:
        name, fn = FAULTS[fault]
        for module in (port_sample, port_serve):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, fn)
    return harness.run_cell(cell, 2 ** 34 + 17, seconds, False,
                            t_start=time.perf_counter(), device=device,
                            root=root, log=lambda m: None)


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail_the_check(monkeypatch, tmp_path, cell, fault):
    out = _run(monkeypatch, cell, fault, "cpu", tiny_root(tmp_path), 0.3)
    assert out["correct"] is (fault == "sound"), out["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(tmp_path, cell):
    """At the tiny size the control (the reference at the control's
    precisions) reads far above the program's CPU path (float32 or bf16
    module path)."""
    root = tiny_root(tmp_path)
    out = _run(pytest.MonkeyPatch(), cell, "sound", "cpu", root, 0.3)
    low = control.control_numbers(cell, 2 ** 34 + 17, torch.device("cpu"),
                                  root=root)
    for name, t in low["check"].items():
        assert t["value"] > 3 * out["check"][name]["value"], (name, t)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail_the_check_on_the_card(monkeypatch, cell, fault):
    _card()
    out = _run(monkeypatch, cell, fault, "cuda", cells.ROOT, 3.0)
    assert out["correct"] is (fault == "sound"), out["check"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 3 * 10 ** 9 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, seed):
    out = control.control_numbers(cell, seed, _card())
    assert out["correct"] is False, out
