"""On the card, at each cell's own sizes (marked ``cuda``; skipped
without a card): whole batches of the cell's traffic through the timed
path, as many as hold the requests a run judges, read every number the
cell compares within its limit, and the
reference in float8 products put in the program's place reads at least
one of them over its limit."""
import pytest

from portbench.harness import load_benchmark

CELLS = [c["name"] for c in load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_over_the_limit(cell, card):
    from portbench.harness import Session
    seed = 2**31 + 101
    s = Session(cell, card)
    s.load_weights(seed)
    s.warm(seed)
    w = s.window(seed, 0.0, batches=s.check_batches)
    judged = s.judge(seed, w, ("fp8",))
    assert all(judged[k] <= limit for k, limit in s.limits.items()), judged
    assert any(judged[f"{k}.fp8"] > limit
               for k, limit in s.limits.items()), judged
