"""The FLOP and byte counts of portbench/roofline.py and the metric readers
against hand-worked shapes."""

import pytest

from portbench import roofline
from portbench.layout import Sizes
from portbench.metrics import reader
from portbench.record import JobRecord, Run
from portbench.trace import Trace

MISTRAL = Sizes(n_layer=32, dim=4096, n_head=32, n_kv_head=8, head_dim=128,
                intermediate=14336, vocab=32768, rope_theta=1e6,
                norm_eps=1e-5, qkv_bias=False, tied=False,
                max_positions=32768)
QWEN = Sizes(n_layer=28, dim=3584, n_head=28, n_kv_head=4, head_dim=128,
             intermediate=18944, vocab=152064, rope_theta=1e6, norm_eps=1e-6,
             qkv_bias=True, tied=False, max_positions=131072)
PK = roofline.PEAKS["H100"]


def test_weight_bytes_are_the_published_parameter_counts():
    # Mistral-7B-v0.3: 7,248,023,552 parameters; Qwen2.5-7B: 7,615,616,512;
    # a forward reads only its own rows of the input embedding table
    for s, n in ((MISTRAL, 7_248_023_552), (QWEN, 7_615_616_512)):
        assert roofline.weight_bytes(s) + 2 * s.vocab * s.dim == 2 * n


def test_kv_bytes_per_token():
    # 128 KiB a token for Mistral, 56 KiB for Qwen (all layers)
    assert roofline.kv_bytes_per_row(MISTRAL) * 32 == 128 * 1024
    assert roofline.kv_bytes_per_row(QWEN) * 28 == 56 * 1024


def test_gemm_parts_of_one_token_row():
    f = roofline.Forward(rows=1, logit_rows=1, query_keys=0, kv_read=0,
                         kv_written=0)
    parts = roofline.gemm_parts(MISTRAL, f)
    k, n = 4096, 6144                      # wqkv: 32 + 2 * 8 heads of 128
    assert parts[0] == (2 * k * n, 2 * (k * n + k + n), 32)
    fl, b, c = parts[-1]                   # the unembedding, logits in f32
    assert (fl, c) == (2 * 4096 * 32768, 1)
    assert b == 2 * (4096 * 32768 + 4096) + 4 * 32768
    # every weight once: the parts' weight bytes are the model's
    weights = sum(c * 2 * kk * nn for (kk, nn), (_, _, c)
                  in zip(roofline.products(MISTRAL), parts))
    assert weights + 2 * 4096 * 32768 == roofline.weight_bytes(MISTRAL) \
        - 2 * (32 * 2 * 4096 + 4096)


def test_encode_forwards_count_the_causal_keys():
    B, P, C = 3, 512, 128
    fw = roofline.encode_forwards(B, P, C)
    assert len(fw) == 4
    assert sum(f.query_keys for f in fw) == B * P * (P + 1) // 2
    assert [f.kv_read for f in fw] == [B * 128, B * 256, B * 384, B * 512]
    assert [f.logit_rows for f in fw] == [0, 0, 0, B]
    assert all(f.rows == B * C and f.kv_written == B * C for f in fw)


def test_ar_forwards():
    fw = roofline.ar_forwards(2, 100, 4)
    assert [f.query_keys for f in fw] == [202, 204, 206]
    assert all(f.rows == 2 and f.logit_rows == 2 for f in fw)


def test_snapkv_forwards_without_acceptance():
    B, P, budget, gamma, R = 2, 1000, 64, 3, 5
    fw = roofline.snapkv_forwards(B, P, budget, gamma, R, accepted_rows=0)
    assert len(fw) == R * (gamma + 1)
    drafts, verify = fw[:gamma], fw[gamma]
    assert [d.kv_read for d in drafts] == [B * 65, B * 66, B * 67]
    T = gamma + 1
    assert verify.rows == B * T and verify.logit_rows == B * T
    assert verify.query_keys == B * sum(P + t + 1 for t in range(T))
    assert verify.kv_read == B * (P + T) and verify.kv_written == 2 * B * T


def test_snapkv_forwards_interpolate_the_appended_length():
    fw = roofline.snapkv_forwards(1, 1000, 64, 1, rounds=4,
                                  accepted_rows=8)
    verifies = fw[1::2]
    assert [v.kv_read for v in verifies] == [1002, 1004, 1006, 1008]


def test_forward_bound_is_the_larger_of_flops_and_bytes():
    decode = roofline.ar_forwards(32, 8192, 2)[0]
    fl, b = roofline.forward_cost(MISTRAL, decode)
    assert b / PK["bytes"] > fl / PK["flops"]          # decode: memory
    assert roofline.forward_bound_s(MISTRAL, decode, PK) == b / PK["bytes"]
    chunk = roofline.encode_forwards(8, 32768, 128)[-1]
    fl, b = roofline.forward_cost(QWEN, chunk)
    assert fl / PK["flops"] > b / PK["bytes"]          # prefill: compute


def _job(**kw):
    base = dict(entry="selfspec", batch=2, prompt_len=256, new_tokens=4,
                chunk=128, gamma=3, budget=64, job_s=3.0, encode_s=1.0,
                counts=[5, 4], rounds=3, accepted=3, drafted=18)
    base.update(kw)
    return JobRecord(**base)


class _Cell:
    sizes = MISTRAL


def test_end_to_end_readers():
    run = Run(cell=_Cell(), jobs=[_job(), _job(encode_s=2.0)],
              setup_s=12.5, device_name="NVIDIA H100 80GB HBM3")
    # delivered: (4 - 1) + (4 - 1) a job; decode seconds 2 + 1
    assert reader("decode_tok_s")(run) == pytest.approx(12 / 3.0)
    assert reader("prefill_tok_s")(run) == pytest.approx(2 * 2 * 256 / 3.0)
    assert reader("setup_s")(run) == 12.5
    assert reader("acceptance")(run) == pytest.approx(100 * 6 / 36)


def test_acceptance_is_left_out_without_drafts():
    run = Run(cell=_Cell(), jobs=[_job(entry="autoregressive", drafted=0,
                                       accepted=0)])
    assert reader("acceptance")(run) is None


def test_mfu_readers_divide_the_bound_by_the_phase_seconds():
    job = _job(entry="autoregressive", counts=[4, 4], job_s=2.0,
               encode_s=0.5)
    run = Run(cell=_Cell(), jobs=[job], device_name="NVIDIA H100 80GB HBM3")
    bound = sum(roofline.forward_bound_s(MISTRAL, f, PK)
                for f in roofline.ar_forwards(2, 256, 4))
    assert reader("decode_mfu")(run) == pytest.approx(100 * bound / 1.5)
    flops = sum(roofline.forward_cost(MISTRAL, f)[0]
                for f in roofline.encode_forwards(2, 256, 128))
    assert reader("prefill_mfu")(run) == pytest.approx(
        100 * flops / PK["flops"] / 0.5)
    run.device_name = "cpu"
    assert reader("decode_mfu")(run) is None


def _trace(part, ops, start=0, end=1000, job=None):
    t = Trace(part, start, end, device_ops=ops, job=job)
    return t


def test_kernel_readers_and_idle():
    job = _job(entry="autoregressive", counts=[4, 4])
    ops = [("void decode_split_mma_kernel<128>(x)", 0, 100),
           ("decode_merge_kernel", 100, 150),
           ("nvjet_tst_64x8_64x16_1x2_h_bz_TNT", 200, 600),
           ("elementwise_kernel", 700, 800)]
    run = Run(cell=_Cell(), jobs=[job], device_name="NVIDIA H100 80GB HBM3",
              trace=_trace("decode", ops, job=job))
    att = sum(roofline.bound_s(roofline.attention_parts(MISTRAL, f), PK)
              for f in roofline.ar_forwards(2, 256, 4))
    assert reader("flash_decode_roofline")(run) == pytest.approx(
        100 * att / 150e-9)
    gem = sum(roofline.bound_s(roofline.gemm_parts(MISTRAL, f), PK)
              for f in roofline.ar_forwards(2, 256, 4))
    assert reader("gemm_roofline.decode")(run) == pytest.approx(
        100 * gem / 400e-9)
    assert reader("device_idle.decode")(run) == pytest.approx(100 * 0.35)
    assert reader("device_idle.prefill")(run) is None
    assert reader("flash_prefill_roofline")(run) is None



@pytest.mark.parametrize("name,original", [
    ("ar_decode_tok_s", "decode_tok_s"), ("decode_mfu.ar", "decode_mfu"),
    ("flash_decode_roofline.ar", "flash_decode_roofline"),
    ("gemm_roofline.ar", "gemm_roofline.decode"),
    ("device_idle.ar", "device_idle.decode"),
    ("peak_mem_gib.ar", "peak_mem_gib.decode")])
def test_the_autoregressive_cells_readers_read_as_their_originals(name,
                                                                  original):
    job = _job(entry="autoregressive", counts=[4, 4])
    ops = [("void decode_split_mma_kernel<128>(x)", 0, 100),
           ("decode_merge_kernel", 100, 150),
           ("nvjet_tst_64x8_64x16_1x2_h_bz_TNT", 200, 600)]
    run = Run(cell=_Cell(), jobs=[job], device_name="NVIDIA H100 80GB HBM3",
              trace=_trace("decode", ops, job=job), peak_bytes=3 * 2**30)
    value = reader(name)(run)
    assert value is not None and value == reader(original)(run)

def test_trace_union_gaps_and_host_names():
    t = _trace("decode", [("a", 100, 300), ("b", 200, 400), ("c", 600, 700),
                          ("d", 900, 1200)])
    assert t.busy_intervals() == [[100, 400], [600, 700], [900, 1000]]
    assert t.busy_s == pytest.approx(500e-9)
    assert t.idle_gaps() == [(0, 100), (400, 600), (700, 900)]
    t.host_ops = [("outer", 0, 1000), ("cudaLaunchKernel", 450, 550),
                  ("aten::item", 750, 850)]
    assert t.host_names_at([50, 500, 800, 5000]) == [
        "outer", "cudaLaunchKernel", "aten::item", "(none)"]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["d", pytest.approx(300e-9)]
    assert dict((n, v) for n, v in bd["idle_gaps"]) == {
        "outer": pytest.approx(100e-9), "cudaLaunchKernel": pytest.approx(200e-9),
        "aten::item": pytest.approx(200e-9)}


class _Event:
    def __init__(self, name, device, start, duration):
        self._n, self._d, self._s, self._u = name, device, start, duration

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def test_reduce_events_splits_device_and_host():
    from portbench.trace import reduce_events
    t = reduce_events([_Event("cudaLaunchKernel", "DeviceType.CPU", 90, 5),
                       _Event("k1", "DeviceType.CUDA", 100, 50),
                       _Event("", "DeviceType.CUDA", 300, 10)], "decode")
    assert (t.start_ns, t.end_ns) == (90, 310)
    assert t.device_ops == [("k1", 100, 150), ("(unnamed)", 300, 310)]
    assert t.host_ops == [("cudaLaunchKernel", 90, 95)]
    assert t.busy_s == pytest.approx(60e-9)
    assert reduce_events([], "decode").device_ops == []
