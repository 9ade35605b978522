"""On the card: one short run of each cell ends correct, with every
metric its cell names. Skips where no card is visible."""

import pytest

from portbench import run as R
from portbench.spec import Spec

CELLS = ("triage_tiny.stage3_chat", "triage_tiny.bulk_triage")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct_on_the_card(card, name, traced):
    spec = Spec()
    result = R.execute(spec, name, 2**31 + 5, 5.0, traced)
    assert result["correct"] is True
    want = {m["name"] for m in spec.metrics(spec.cell(name), traced)}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
