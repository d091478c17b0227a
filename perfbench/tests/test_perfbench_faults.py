"""A run with the timed path broken underneath has to come out not
correct, and the control has to read worse than the program: on the CPU
at a tiny size of every cell, past the look for a chip.

The faults are those each cell can have: a step that returns its state
unchanged; half of the batch left out; an answer altered where it is
produced.  The control is the one the cell's chip readings were set from
(the references in fp8, the audit by size alone).  One chip, so no
exchange between chips can be left out.
"""
from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

from perfbench import faults  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))


FAULTS = [(cell, f) for cell, fs in faults.FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    c = tiny.cell(cell)
    sound = tiny.run(cell, seed=11, c=c)
    # the cell's limits are set for its full size; at this size a number
    # is held to three times the sound run's reading (an exact one to 0)
    c.limits = {k: 3 * v for k, v in sound["_outcome"].readings.items()}
    fault(monkeypatch.setattr)
    res = tiny.run(cell, seed=11, c=c)
    assert res["correct"] is False, (sound["_outcome"].readings,
                                      res["_outcome"].readings)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_reads_worse_than_the_program(cell):
    for seed in (3, 4, 5):
        out = tiny.run(cell, seed=seed, control=True)["_outcome"]
        assert out.control
        assert any(out.control[k] > max(out.readings[k], 0)
                   for k in out.control), (out.readings, out.control)
