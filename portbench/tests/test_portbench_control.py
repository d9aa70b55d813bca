"""The control at a size a test run holds: the reference with its products
in fp8 (reference/model.py), read at the positions a run compares, fails
the cell's limits where the program passes them. On the card the same
readings, and those of the program's int8 weight-only path and of planted
faults, come from calibrate.py at each cell's own size."""

from pathlib import Path

import pytest
import torch

from portbench import layout, weights
from portbench.calibrate import judge, readings
from portbench.run import Jobs

DATA = Path(__file__).resolve().parent / "data"


@pytest.mark.parametrize("cell", ["tiny-mistral.snapkv", "tiny-qwen.snapkv"])
def test_control_fails_where_the_programjudge(cell):
    c = layout.load_cell(cell, DATA / "BENCHMARK.json", DATA)
    sz, tr = c.sizes, c.traffic
    dev = torch.device("cpu")
    for seed in (1, 2, 3):
        params = weights.make(sz, seed, dev)
        jobs = Jobs(c, params, seed, dev)
        rec = jobs.run(jobs.engine(tr["prompt_len"], tr["new_tokens"]), 0,
                       tr["prompt_len"], tr["new_tokens"])
        g = readings(rec, tr["check_rows"], seed, params, sz, dev,
                     ("f32", "fp8"))
        assert judge(g["f32"], c.limits) is True, (seed, g)
        assert judge(g["fp8"], c.limits) is False, (seed, g)
