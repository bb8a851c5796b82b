"""On the card: each fault a cell can have, planted underneath a short run
of the cell at its own size, makes ``correct`` false; and the control (the
reference at the precision below the configuration's in the program's
place) fails the cell's limit. Skips without a card."""

import json

import pytest

from perfbench.harness import spec
from perfbench.tests import faults

pytestmark = pytest.mark.cuda
CELLS = [c["name"] for c in spec.load()["workloads"]]


@pytest.fixture
def card():
    import torch

    from perfbench.harness.device import Card

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return Card(1)


def _faults(cell):
    kind = json.loads(spec.traffic_path(spec.cell(spec.load(), cell)["traffic"]).read_text())["kind"]
    table = ({**faults.TRAIN_FAULTS, **faults.REPLAY_FAULTS} if kind == "train_steps"
             else faults.SERVE_FAULTS)
    return [(cell, name, source[0]) for name, source in table.items()]


@pytest.mark.parametrize("cell, name, source", [f for c in CELLS for f in _faults(c)])
def test_fault_at_the_cells_size_is_caught(card, cell, name, source, monkeypatch):
    import time

    from perfbench.harness.session import execute

    scope = {}
    with monkeypatch.context():
        exec(source, scope)  # noqa: S102 - the fault's own source, from faults.py
        result = execute(spec.load(), cell, 2 ** 31 + 99, 2.0, False, card, time.perf_counter())
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(card, cell):
    import time

    from perfbench.harness.session import Run
    from perfbench.reference.common import CONTROL_DTYPE

    run = Run(spec.load(), cell, 2 ** 31 + 98, 0.0, False, card, time.perf_counter())
    got = run.kind.control(run, CONTROL_DTYPE)
    limits = run.config["limits"][run.traffic["kind"]]
    got = got if isinstance(got, dict) else {"logit_gap": got}
    assert any(got[k] > limits[k] for k in got), (got, limits)
