"""The port's tail against the JAX package's: RULER tasks, the analysis
helpers, profiling, the dataset converters, LongBench preprocessing and
the downloaders.

Nothing is downloaded: where the JAX function calls `datasets` or
`huggingface_hub`, both packages run under the same stub module
(monkeypatch.setitem(sys.modules, ...)) and must make the same calls and
give the same arrays and files. selection_fidelity runs on
tests/test_analysis.py's shapes and must be within 1e-5 of JAX's; the
scalar analysis functions within 1e-12 on a grid.
"""

import importlib.machinery
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu import analysis as janalysis
from magicdec_tpu.checkpoint import download as jdownload
from magicdec_tpu.checkpoint import store as jstore
from magicdec_tpu.data import converters as jconv
from magicdec_tpu.data import longbench as jlongbench
from magicdec_tpu.data import ruler as jruler
from magicdec_tpu.utils import profiling as jprofiling
from magicdec_tpu_torch import analysis as tanalysis
from magicdec_tpu_torch.checkpoint import download as tdownload
from magicdec_tpu_torch.checkpoint import store as tstore
from magicdec_tpu_torch.data import converters as tconv
from magicdec_tpu_torch.data import longbench as tlongbench
from magicdec_tpu_torch.data import ruler as truler
from magicdec_tpu_torch.utils import profiling as tprofiling

# _require_hf imports transformers' AutoTokenizer: import it before any
# test stubs `datasets`, which transformers inspects when it is imported
AutoTokenizer = pytest.importorskip("transformers").AutoTokenizer

# --------------------------------------------------------------------------
# RULER
# --------------------------------------------------------------------------

# (task, seq_len): common_words_extraction also past the vocab cap
# (~12.5k at vocab 4096), where the uncommon words are capped and tiled
RULER_CASES = [(t, 512) for t in sorted(truler.TASKS)] + [
    ("common_words_extraction", 16384)]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("task,seq_len", RULER_CASES)
def test_ruler_tasks_equal_jax(task, seq_len, seed):
    got = truler.prepare(task, seq_len, 3, seed=seed)
    want = jruler.prepare(task, seq_len, 3, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("task", sorted(truler.TASKS))
def test_ruler_score_equals_jax(task):
    """On generated streams that hit, miss, permute and run past the
    answer: order-strict for retrieval, set-equal for word extraction."""
    _, answers = truler.prepare(task, 512, 6, seed=2)
    rng = np.random.default_rng(0)
    gen = np.concatenate([answers, rng.integers(16, 4096, (6, 5))], axis=1)
    gen[1, 0] += 1                                  # a miss
    gen[2, :answers.shape[1]] = answers[2, ::-1]    # a permutation
    gen[3] = rng.integers(16, 4096, gen.shape[1])   # noise
    got = truler.score(task, gen, answers)
    assert got == jruler.score(task, gen, answers)
    assert 0.0 < got < 1.0
    assert set(truler.TASKS) == set(jruler.TASKS)
    assert truler._SET_TASKS == jruler._SET_TASKS


# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------

ALPHAS = [0.0, 0.1, 0.3, 0.5, 0.8, 0.95, 0.999, 1.0]
GAMMAS = [1, 2, 3, 6, 16]


@pytest.mark.parametrize("fn", ["expected_accepted", "find_alpha",
                                "speedup_model", "best_gamma"])
def test_scalar_analysis_equals_jax(fn):
    for a in ALPHAS:
        for g in GAMMAS:
            if fn == "expected_accepted":
                args = [(a, g)]
            elif fn == "find_alpha":
                args = [(g, (janalysis.expected_accepted(a, g) - 1) / g)]
            elif fn == "speedup_model":
                args = [(a, g, r, v) for r in (0.05, 0.3, 1.0)
                        for v in (1.0, 1.5)]
            else:
                args = [(a, r, g) for r in (0.05, 0.3, 1.0)]
            for arg in args:
                got = getattr(tanalysis, fn)(*arg)
                want = getattr(janalysis, fn)(*arg)
                assert np.allclose(got, want, rtol=0, atol=1e-12), (arg, got,
                                                                    want)


@pytest.mark.parametrize("n_pages", [1, 2, 3])
def test_selection_fidelity_equals_jax(n_pages):
    """tests/test_analysis.py's shapes (a ragged second row) on numpy inputs
    of several scales, the q as bf16 too; the ordering holds."""
    B, Hq, Hkv, D, S = 2, 4, 2, 16, 512
    rng = np.random.default_rng(n_pages)
    lengths = np.asarray([S, S - 100], np.int32)
    for q_scale in (1.0, 4.0):
        q = (rng.standard_normal((B, Hq, D)) * q_scale).astype(np.float32)
        k = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
        want = janalysis.selection_fidelity(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(lengths), page=128,
                                            n_pages=n_pages)
        got = tanalysis.selection_fidelity(torch.from_numpy(q),
                                           torch.from_numpy(k),
                                           torch.from_numpy(lengths),
                                           page=128, n_pages=n_pages)
        assert got.keys() == want.keys()
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-5, (key, got, want)
            assert 0.0 <= got[key] <= 1.0 + 1e-6
        assert got["perhead_true"] >= got["joint"] - 1e-6
        assert got["perhead_true"] >= got["perhead_box"] - 1e-6
    bf = tanalysis.selection_fidelity(torch.from_numpy(q).bfloat16(),
                                      torch.from_numpy(k).bfloat16(),
                                      lengths, page=128, n_pages=n_pages)
    assert all(0.0 <= v <= 1.0 + 1e-6 for v in bf.values())


def test_plot_acceptance_vs_budget_writes_a_png(tmp_path):
    rows = [{"budget": b, "prefix": p, "rate": r}
            for p in (1024, 4096) for b, r in ((128, 0.6), (512, 0.8),
                                               (1024, 0.9))]
    out = tmp_path / "acc.png"
    assert tanalysis.plot_acceptance_vs_budget(rows, str(out)) == str(out)
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------

def _clock_report(mod, arr):
    clock = mod.PhaseClock()
    for name, n in (("draft", 3), ("verify", 2), ("loop", 1)):
        for _ in range(n):
            with clock.phase(name, sync_on=arr):
                pass
    with clock.phase("nosync"):
        pass
    return clock


def test_phase_clock_report_has_jaxs_keys_and_counts():
    jc = _clock_report(jprofiling, jnp.ones(3))
    tc = _clock_report(tprofiling, {"a": [torch.ones(3)], "b": (None, 2)})
    assert tc.counts == jc.counts == {"draft": 3, "verify": 2, "loop": 1,
                                      "nosync": 1}
    jr, tr = jc.report(), tc.report()
    assert list(tr) == list(jr)
    for name in tr:
        assert tr[name].keys() == jr[name].keys() == {"total_s", "avg_ms"}
        assert tr[name]["total_s"] == round(tc.buckets[name], 4)
        assert tr[name]["avg_ms"] == round(
            tc.buckets[name] / tc.counts[name] * 1e3, 3)


def test_step_cost_report_has_jaxs_shape():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    got = tprofiling.step_cost_report(fn, torch.ones(4), iters=5, label="ar")
    want = jprofiling.step_cost_report(lambda x: x * 2, jnp.ones(4), iters=5,
                                       label="ar")
    assert got.keys() == want.keys() == {"ar"}
    assert got["ar"].keys() == want["ar"].keys() == {"ms"}
    assert isinstance(got["ar"]["ms"], float) and got["ar"]["ms"] >= 0
    assert len(calls) == 6                  # one warm call + iters


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprofiling.device_trace(str(tmp_path)):
        torch.mm(torch.ones(64, 64), torch.ones(64, 64)).sum()
    traces = [p for p in tmp_path.iterdir() if p.name.endswith(".json")]
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# --------------------------------------------------------------------------
# converters and LongBench
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(skip=5), dict(repeat=3),
                                dict(skip=3, repeat=2)])
def test_chunk_token_stream_equals_jax(kw):
    tokens = np.arange(100, 203, dtype=np.int32)
    got = tconv._chunk_token_stream(tokens, 16, 1, **kw)
    want = jconv._chunk_token_stream(tokens, 16, 1, **kw)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_save_tokens_equals_jax(tmp_path):
    x = np.arange(24, dtype=np.int64).reshape(3, 8)
    tconv.save_tokens(str(tmp_path / "t.npy"), x)
    jconv.save_tokens(str(tmp_path / "j.npy"), x)
    assert ((tmp_path / "t.npy").read_bytes()
            == (tmp_path / "j.npy").read_bytes())


class StubTok:
    """A tokenizer stand-in: one id a character, bos 1."""
    bos_token_id = 1

    def __call__(self, text):
        return types.SimpleNamespace(
            input_ids=[2 + ord(c) % 97 for c in text])


class LengthTok:
    """tests/test_data_and_store.py's stub tokenizer."""
    bos_token_id = 1

    def __call__(self, text):
        class R:
            input_ids = [7] * (17 + len(text) % 5)
        return R()


@pytest.mark.parametrize("summary", [False, True])
def test_longbench_v2_converters_equal_jax(tmp_path, summary):
    rows = [{"instruction": "x" * 40}, {"prompt": "y" * 10},
            {"instruction": "abc" * 30}]
    p = tmp_path / "lb2.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows))
    for tok in (LengthTok(), StubTok()):
        if summary:
            got = tconv.convert_longbench_v2_sum_dataset(8, tok, str(p))
            want = jconv.convert_longbench_v2_sum_dataset(8, tok, str(p))
        else:
            got = tconv.convert_longbench_v2_dataset(8, tok, str(p))
            want = jconv.convert_longbench_v2_dataset(8, tok, str(p))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] == 1).all()


def _rows(name):
    """What the stub `datasets` returns for a dataset name."""
    rng = np.random.default_rng(len(name))

    def text(n):
        return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, n))

    if name == "THUDM/LongBench-v2":
        return [{"context": text(60), "question": text(8), "choice_A": "a",
                 "choice_B": "b", "choice_C": "c", "choice_D": "d",
                 "answer": "B"} for _ in range(4)]
    if name == "THUDM/LongBench":
        return [{"context": text(n), "input": text(9), "answers": [text(3)]}
                for n in (10, 80, 200)]
    key = "article" if name == "cnn_dailymail" else "text"
    return [{key: text(n)} for n in (40, 300, 150, 500)]


def _stub_datasets(monkeypatch):
    """A `datasets` module whose load_dataset records its calls and returns
    _rows(name)."""
    calls = []

    def load_dataset(name, *args, **kw):
        calls.append((name, args, kw))
        return _rows(name)

    stub = types.ModuleType("datasets")
    stub.__spec__ = importlib.machinery.ModuleSpec("datasets", None)
    stub.load_dataset = load_dataset
    monkeypatch.setitem(sys.modules, "datasets", stub)
    return calls


CONVERTERS = {
    "pg19": lambda m: m.convert_pg19_dataset(16, StubTok(), num_books=3,
                                             skip=20, repeat=2),
    "c4": lambda m: m.convert_c4_dataset(16, StubTok(), num_docs=3),
    "wiki": lambda m: m.convert_wiki_dataset(16, StubTok(), num_docs=3),
    "cnn": lambda m: m.convert_cnn_dataset(16, StubTok(), num_docs=2),
    "longbench_v1": lambda m: m.convert_longbench_v1_dataset(
        "qasper", 64, StubTok(), max_ctx=180),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_hf_dataset_converters_equal_jax_under_a_stub(monkeypatch, name):
    calls = _stub_datasets(monkeypatch)
    got = CONVERTERS[name](tconv)
    port_calls = list(calls)
    calls.clear()
    want = CONVERTERS[name](jconv)
    assert port_calls == calls and len(calls) == 1
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 0 and (got[:, 0] == 1).all()


def test_pg19_falls_back_to_the_synthetic_corpus(monkeypatch):
    """Where _require_hf raises (no `datasets`), PG-19 is synthetic_dataset,
    as in the JAX package; the other converters raise."""
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets"):
        tconv._require_hf("x")
    got = tconv.convert_pg19_dataset(64)
    np.testing.assert_array_equal(got, tconv.synthetic_dataset(64))
    np.testing.assert_array_equal(got, jconv.convert_pg19_dataset(64))
    with pytest.raises(RuntimeError, match="convert_c4_dataset"):
        tconv.convert_c4_dataset(64, StubTok())


def test_longbench_templates_equal_jax():
    for name in ("TEMPLATE_V1", "TEMPLATE_V2_COT", "TEMPLATE_V2_NO_COT",
                 "TEMPLATE_SUMMARY"):
        assert getattr(tlongbench, name) == getattr(jlongbench, name)
    v1 = _rows("THUDM/LongBench")[0]
    v2 = _rows("THUDM/LongBench-v2")[0]
    assert tlongbench.build_prompt_v1(v1) == jlongbench.build_prompt_v1(v1)
    for cot in (True, False):
        assert (tlongbench.build_prompt_v2(v2, cot)
                == jlongbench.build_prompt_v2(v2, cot))
    assert (tlongbench.build_prompt_summary(v2)
            == jlongbench.build_prompt_summary(v2))


PREPROCESS = {
    "v1": lambda m, out: m.preprocess_longbench_v1("qasper", out, limit=2),
    "v2": lambda m, out: m.preprocess_longbench_v2(out, limit=3),
    "v2_no_cot": lambda m, out: m.preprocess_longbench_v2(out, cot=False),
    "v2_summary": lambda m, out: m.preprocess_longbench_v2_summary(out),
}


@pytest.mark.parametrize("name", sorted(PREPROCESS))
def test_longbench_preprocess_writes_jaxs_jsonl(monkeypatch, tmp_path, name):
    calls = _stub_datasets(monkeypatch)
    t, j = str(tmp_path / "t.jsonl"), str(tmp_path / "j.jsonl")
    assert PREPROCESS[name](tlongbench, t) == t
    assert PREPROCESS[name](jlongbench, j) == j
    assert calls[0] == calls[1]
    text = open(t).read()
    assert text == open(j).read() and text.count("\n") >= 2


# --------------------------------------------------------------------------
# downloaders
# --------------------------------------------------------------------------

DOWNLOADERS = {
    "download": (lambda m, **kw: m.hf_download("org/model", **kw),
                 tdownload, jdownload, "hf_token"),
    "store": (lambda m, **kw: m.hf_download("org/model", **kw),
              tstore, jstore, "token"),
}


@pytest.mark.parametrize("name", sorted(DOWNLOADERS))
def test_hf_download_makes_jaxs_call(monkeypatch, name):
    call, port, jax_mod, token_kw = DOWNLOADERS[name]
    calls = []

    def snapshot_download(repo_id, **kw):
        calls.append((repo_id, kw))
        return "/stub/" + repo_id

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=snapshot_download))
    monkeypatch.delenv("HF_TOKEN", raising=False)
    for kw in ({}, {"local_dir": "ckpt"}, {token_kw: "tok"}):
        assert call(port, **kw) == call(jax_mod, **kw) == "/stub/org/model"
        assert calls[-1] == calls[-2]
    if name == "download":
        monkeypatch.setenv("HF_TOKEN", "env-token")
        call(port)
        call(jax_mod)
        assert calls[-1] == calls[-2]
        assert calls[-1][1]["token"] == "env-token"
        assert calls[-1][1]["local_dir"] == os.path.join("checkpoints",
                                                          "org--model")


@pytest.mark.parametrize("name", sorted(DOWNLOADERS))
def test_hf_download_raises_without_huggingface_hub(monkeypatch, name):
    call, port, jax_mod, _ = DOWNLOADERS[name]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for mod in (port, jax_mod):
        with pytest.raises(RuntimeError, match="huggingface_hub"):
            call(mod)
