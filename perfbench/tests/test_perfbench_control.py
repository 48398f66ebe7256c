"""The control comes out not correct: the reference put in the port's
place and computed in bfloat16, one precision below the configuration's
float32, read as the check reads the port and judged by the cell's
limits through ``checks.verdict``, at a size a test run holds (the tiny
cells on the CPU). The port passes the same limits."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, registry
from perfbench.tests import tiny


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_control_fails_where_the_port_passes(tmp_path, cell):
    bj = tiny.setup(tmp_path)
    b = registry.resolve(cell, 2**31 + 31, tiny.SECONDS, False, torch.device("cpu"),
                         bj, tmp_path)
    out = registry.generator(b.traffic).run(b)
    out.session.release()
    got = control.readings(out.session, out.done, b.seed, b.limits)
    assert got["port_correct"] is True
    assert got["control_correct"] is False
    assert any(got[f"control_{name}"] > 3 * lim["max"]
               for name, lim in b.limits.items())
