"""The check against planted faults and against its control, on the
dense cell at a reduced size: a run whose timed path is broken underneath
(state left unchanged, half the batch left out, a token altered where it
is produced) comes out not correct, and so does the reference computed
in float8 put in the program's place.  One card: no exchange between
chips to leave out."""
import pytest

pytest.importorskip("torch")

import portbench_testkit as K  # noqa: E402

CELL = "minicpm-2b.agentic"


@pytest.mark.parametrize("fault", sorted(K.FAULTS))
def test_a_planted_fault_fails_the_check(fault, monkeypatch):
    plant = K.FAULTS[fault](monkeypatch)
    out, _, _ = K.run_reduced(CELL, fault=plant)
    assert not out.correct, out.compared


def test_the_float8_control_fails_the_check():
    out, _, _ = K.run_reduced(CELL, check_mode="fp8", seed=2 ** 31 + 5)
    assert not out.correct, out.compared
    sound, _, _ = K.run_reduced(CELL, seed=2 ** 31 + 5)
    assert sound.correct, sound.compared
    kind = next(k for k in out.compared if k != "tokens_checked")
    assert out.compared[kind]["value"] > 3 * sound.compared[kind]["value"]
