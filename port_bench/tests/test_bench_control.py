"""The control: the plain net in float8 e4m3 standing in for the program
fails the cell's limits, and reads its priors' gap at least three times
the program's in bfloat16, on the same positions (the CPU at a small size;
the chip at the cells' own sizes with port_bench/control.py, where the
program also passes the limits)."""

import pytest

from port_bench import control


@pytest.mark.parametrize("cell", ["selfplay-b6c96-19x19"])
def test_control_fails_where_the_program_passes(cell, tiny):
    h = tiny(cell, dtype="bfloat16")
    prog, ctrl = control.readings(h, 0.5, "fp8", lambda: None)
    exact = [k for k, v in h.limits.items() if v == 0]
    assert all(prog[k] == 0 for k in exact), prog
    tv = next(k for k in prog if k.startswith("prior_tv"))
    assert ctrl[tv] >= 3 * prog[tv], (prog, ctrl)
    assert not h.judge(ctrl)[0], ctrl
