"""The harness on the card at tiny sizes: a traced run reads every
per-layer metric its cell lists from the device trace, no share passes
100%, and the result carries the device fields. Marked `cuda`; skips
without a card (decided in the fixture, never at import).

    python -m pytest portbench/tests -q -m cuda
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import run

DATA = Path(__file__).resolve().parent / "data"
SHARES = ("decode_mfu", "prefill_mfu", "flash_decode_roofline",
          "flash_prefill_roofline", "gemm_roofline.decode")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _line(cell, trace, device):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(2**32 + 5),
                       "--seconds", "0.5", "--trace", str(trace)],
                      device=device, bench_file=DATA / "BENCHMARK.json",
                      root=DATA)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-mistral.snapkv", "tiny-qwen.prefill"])
def test_traced_run_on_the_card(card, cell):
    line = _line(cell, 1, card)
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert line["breakdown"]["device_ops"]
    for name in SHARES:
        if name in line["metrics"]:
            assert 0 < line["metrics"][name]["value"] <= 100


@pytest.mark.cuda
def test_untraced_run_on_the_card(card):
    line = _line("tiny-mistral.ar", 0, card)
    assert line["correct"] is True
    assert {"decode_tok_s", "setup_s"} <= set(line["metrics"])
    assert line["device"]["memory_peak_bytes"] > 0
