"""A cell over a tensor-parallel world (portbench/world.py): the ranks'
weights are the blocks of the whole draw, a world of gloo CPU ranks serves
tokens the reference passes and every rank serves the same, a fault planted
in every rank reads not correct, a rank that raises or hangs fails the run
within the world's timeout, and the roofline readers set a cell's work
against all of its cards. The card test runs a world of one nccl rank
against the same cell in one process (marked `cuda`; skips without a card).
"""

import contextlib
import io
import json
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import layout, roofline, run, weights, world
from portbench.calibrate import FAULTS
from portbench.metrics import reader
from portbench.record import JobRecord, Run
from portbench.trace import Trace

DATA = Path(__file__).resolve().parent / "data"
BENCH = DATA / "BENCHMARK.json"
TP_CELLS = ["tiny-mistral-tp.snapkv", "tiny-qwen-tp.snapkv"]
SEED = 2        # a seed at which no_kv_write shows in both tiny tp models
CPU2 = ["cpu", "cpu"]


def _cell(name):
    return layout.load_cell(name, BENCH, DATA)


def _leaf(params, name):
    return params["layers"][name] if name in weights.LAYER_LEAVES \
        else params[name]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("config", ["tiny-mistral-tp", "tiny-qwen-tp"])
def test_a_ranks_draw_is_its_block_of_the_whole_draw(config, tp):
    from magicdec_tpu_torch.parallel import sharding
    cell = _cell(f"{config}.snapkv")
    sz, cfg = cell.sizes, run.model_args(cell.config)
    cpu = torch.device("cpu")
    whole = weights.make(sz, SEED, cpu)
    names = set(weights.shapes(sz)) | {"attn_norm", "ffn_norm", "norm"}
    assert {"output"} <= names and ("bqkv" in names) == sz.qkv_bias
    for rank in range(tp):
        mine = world.rank_params(sz, cfg, SEED, tp, rank, cpu)
        mesh = sharding.Mesh(tp=tp, rank=rank, backend="gloo", device=cpu)
        cut = sharding.shard_params(whole, mesh, cfg)
        for name in names:
            assert torch.equal(_leaf(mine, name), _leaf(cut, name)), name
            assert _leaf(mine, name).is_contiguous()


@pytest.mark.parametrize("config", ["tiny-mistral-tp", "tiny-qwen-tp"])
def test_the_int8_leaves_are_quantize_params_bit_for_bit(config):
    from magicdec_tpu_torch.quant.int8 import quantize_params
    cell = _cell(f"{config}.snapkv")
    sz, cfg = cell.sizes, run.model_args(cell.config)
    cpu = torch.device("cpu")
    want = quantize_params(weights.make(sz, SEED, cpu), "int8")
    got = world.rank_params(sz, cfg, SEED, 2, 1, cpu, int8=True)
    for name in world.INT8_LEAVES:
        for part in ("qT", "s"):
            assert torch.equal(got["layers"][name][part],
                               want["layers"][name][part]), (name, part)


def _main(cell, **kw):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.3", "--trace", "0"], bench_file=BENCH, root=DATA,
                      **kw)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cell", TP_CELLS)
def test_a_world_of_gloo_cpu_ranks_is_correct(cell):
    rc, out, _ = _main(cell, backend="gloo", devices=CPU2)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    # every rank served rank 0's tokens
    assert line["checks"]["rank_mismatch_rows"] == {"value": 0, "limit": 0}
    assert line["device"]["count"] == 2 and line["attempted"] >= 4
    assert line["metrics"]["setup_s"]["value"] > 0
    assert line["metrics"]["decode_tok_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["no_kv_write", "no_all_reduce"])
@pytest.mark.parametrize("cell", TP_CELLS)
def test_a_fault_planted_in_every_rank_is_not_correct(cell, fault):
    rc, out, _ = _main(cell, backend="gloo", devices=CPU2,
                       plant=FAULTS[fault])
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@contextlib.contextmanager
def _raises_in_encode(prompt_len):
    from magicdec_tpu_torch.engine.backend import Engine

    def encode(self, ids):
        raise ValueError("planted: encode raises")
    old, Engine.encode = Engine.encode, encode
    try:
        yield
    finally:
        Engine.encode = old


@contextlib.contextmanager
def _rank_1_hangs(prompt_len):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        time.sleep(3600)
    yield


def test_a_rank_that_raises_fails_the_run():
    with pytest.raises(RuntimeError, match="planted: encode raises"):
        _main(TP_CELLS[0], backend="gloo", devices=CPU2, timeout_s=120,
              plant=_raises_in_encode)


def test_a_rank_that_hangs_fails_the_run_within_the_timeout():
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="world:"):
        _main(TP_CELLS[0], backend="gloo", devices=CPU2, timeout_s=25,
              plant=_rank_1_hangs)
    assert time.monotonic() - t < 25 + 40


def test_the_command_refuses_a_machine_with_fewer_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _main(TP_CELLS[0])
    assert rc == 2 and out == ""
    assert "needs 2 CUDA device(s); found 1" in err


def test_mismatch_rows_counts_the_sequences_a_rank_served_otherwise():
    a = np.zeros((4, 3), dtype=np.int32)
    b = a.copy()
    b[1, 2] = b[3, 0] = 7
    res = [{"outputs": [a, a]}, {"outputs": [a, b]}, {"outputs": [b, a]}]
    assert world.mismatch_rows(res) == 4


def test_the_processes_share_perf_counters_clock(monkeypatch):
    world._check_clock(time.perf_counter())
    with pytest.raises(RuntimeError, match="before the world started"):
        world._check_clock(time.perf_counter() + 60)
    monkeypatch.setattr(time, "get_clock_info",
                        lambda name: type("I", (), {"implementation": "x"}))
    with pytest.raises(RuntimeError, match="cannot be timed"):
        world._check_clock()


# -- the roofline readers over a cell's cards ---------------------------------

def _job(**kw):
    base = dict(entry="selfspec", batch=2, prompt_len=256, new_tokens=4,
                chunk=128, gamma=3, budget=64, job_s=3.0, encode_s=1.0,
                counts=[5, 4], rounds=3, accepted=3, drafted=18)
    base.update(kw)
    return JobRecord(**base)


OPS = [("void decode_split_mma_kernel<128>(x)", 0, 100),
       ("decode_merge_kernel", 100, 150),
       ("nvjet_tst_64x8_64x16_1x2_h_bz_TNT", 200, 600),
       ("void mdt::block_gemm_kernel<3>(x)", 600, 650),
       ("prefill_mma_kernel", 700, 900)]


def _parent_readings(sz, jobs, t):
    """The readers as they read before a cell could span several cards:
    one H100's peaks."""
    pk = roofline.PEAKS["H100"]
    dec = [f for j in jobs for f in roofline.decode_forwards(j)]
    enc = [f for j in jobs for f in roofline.job_encode_forwards(j)]
    tdec, tenc = (roofline.decode_forwards(t.job),
                  roofline.job_encode_forwards(t.job))
    gemm = 450e-9       # nvjet and block_gemm_kernel
    return {
        "decode_mfu": 100 * sum(roofline.forward_bound_s(sz, f, pk)
                                for f in dec) / sum(j.decode_s for j in jobs),
        "prefill_mfu": 100 * sum(roofline.forward_cost(sz, f)[0]
                                 for f in enc) / pk["flops"]
        / sum(j.encode_s for j in jobs),
        "flash_decode_roofline": 100 * sum(
            roofline.bound_s(roofline.attention_parts(sz, f), pk)
            for f in tdec) / 150e-9,
        "gemm_roofline.decode": 100 * sum(
            roofline.bound_s(roofline.gemm_parts(sz, f), pk)
            for f in tdec) / gemm,
        "flash_prefill_roofline": 100 * sum(
            roofline.bound_s(roofline.attention_parts(sz, f), pk)
            for f in tenc) / 200e-9,
    }


SHARES = ["decode_mfu", "prefill_mfu", "flash_decode_roofline",
          "gemm_roofline.decode", "flash_prefill_roofline", "decode_mfu.ar",
          "flash_decode_roofline.ar", "gemm_roofline.ar"]


@pytest.mark.parametrize("entry", ["selfspec", "autoregressive"])
@pytest.mark.parametrize("name", SHARES)
def test_a_share_sets_the_work_against_all_of_a_cells_cards(name, entry):
    sz = _cell("tiny-qwen-tp.snapkv").sizes
    jobs = [_job(entry=entry), _job(entry=entry, encode_s=2.0)]
    part = "encode" if "prefill" in name else "decode"

    def recorded(chips):
        return Run(cell=type("C", (), {"sizes": sz})(), chips=chips,
                   jobs=jobs, device_name="NVIDIA H100 80GB HBM3",
                   trace=Trace(part, 0, 1000, device_ops=OPS, job=jobs[0]))
    one, four = reader(name)(recorded(1)), reader(name)(recorded(4))
    original = name.removesuffix(".ar")
    assert one == pytest.approx(_parent_readings(sz, jobs, recorded(1).trace)[
        "gemm_roofline.decode" if original == "gemm_roofline" else original],
        rel=1e-12)
    assert four == pytest.approx(one / 4, rel=1e-12)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-mistral.snapkv", "tiny-mistral.ar"])
def test_a_world_of_one_nccl_rank_serves_what_one_process_serves(card, cell):
    """Proof (a) at a tiny size: one job each (--seconds 0), on the same
    seed: bit-equal served tokens, equal check numbers (a tp=1 mesh takes
    the fused route, as the plain path does)."""
    c = _cell(cell)
    one, checks = run.run_cell(c, 2**31 + 11, 0, False, card)
    torch.cuda.empty_cache()
    many, wchecks, loaded = world.run_cell(c, 2**31 + 11, 0, False, "nccl",
                                           ["cuda:0"], run.T0)
    assert loaded == [] and len(one.jobs) == len(many.jobs) == 1
    assert torch.equal(one.jobs[0].output, many.jobs[0].output)
    assert one.jobs[0].counts == many.jobs[0].counts
    assert {k: v for k, v in wchecks.items() if k != "rank_mismatch_rows"} \
        == checks
    assert many.peak_bytes > 0 and many.device_name == one.device_name


def test_calibrate_plants_each_variant_in_every_rank(capsys):
    from portbench import calibrate
    rc = calibrate.main(["--workload", TP_CELLS[1], "--seeds", str(SEED),
                         "--control-seeds", str(SEED), "--int8-seeds",
                         str(SEED), "--fault-seeds", str(SEED), "--faults",
                         "no_kv_write,no_all_reduce"], bench_file=BENCH,
                        root=DATA, backend="gloo", devices=CPU2,
                        timeout_s=300)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["tp"] == 2 and line["seed"] == SEED
    assert line["program"]["passes"] is True
    assert line["fp8"]["passes"] is False
    assert line["no_kv_write"]["passes"] is False
    assert line["no_all_reduce"]["passes"] is False
    # the int8 path ran in the ranks (at this size it reads like the program)
    assert line["int8"]["max_logit_gap"] >= 0
