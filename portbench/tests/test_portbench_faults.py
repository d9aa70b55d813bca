"""A whole run of the harness on the CPU at tiny sizes (the look for a card
skipped), with the program's timed path broken underneath: `correct` comes
out false for each fault a served model on one card can have. The
exchange between chips has no fault here: every cell runs on one card
with tensor parallelism 1."""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import run

DATA = Path(__file__).resolve().parent / "data"
CELLS = ["tiny-mistral.snapkv", "tiny-mistral.ar", "tiny-qwen.snapkv",
         "tiny-qwen.prefill"]


def _runner_up(argmax):
    def fn(logits):
        return torch.topk(logits, 2, dim=-1).indices[..., 1].to(torch.int32)
    return fn


def _half_batch(argmax):
    def fn(logits):
        tok = argmax(logits).clone()
        tok[tok.shape[0] // 2:] = 0            # the second half never computed
        return tok
    return fn


def _break(monkeypatch, fault):
    from magicdec_tpu_torch import cache
    from magicdec_tpu_torch.engine import spec
    if fault == "state_unchanged":
        # decode steps return the cache as it was: no K/V row is written
        monkeypatch.setattr(cache, "write_slots", lambda *a, **k: None)
    elif fault == "half_batch":
        monkeypatch.setattr(spec, "argmax_tokens", _half_batch(spec.argmax_tokens))
    elif fault == "token_altered":
        monkeypatch.setattr(spec, "argmax_tokens", _runner_up(spec.argmax_tokens))


def _result(cell: str, seed: int) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.3", "--trace", "0"], device=torch.device("cpu"),
                      bench_file=DATA / "BENCHMARK.json", root=DATA)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = _result(cell, 2**33 + 7)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == {"max_logit_gap", "mean_logit_gap",
                                   "short_rows"}
    assert line["failed"] == 0 and line["attempted"] >= 4


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, fault)
    line = _result(cell, 2**33 + 7)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
