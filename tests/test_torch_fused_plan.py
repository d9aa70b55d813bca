"""The bf16 fused_post_attn kernel's launch plan (ops/fused_block.py
`launch_plan`), on the CPU.

The plan cuts K into the splits whose f32 partials the kernel sums in
order through a thread-block cluster. A row's bits depend on that order, so
the plan must come from K and N alone, never from the row count, and its
ranges must tile K in whole 64-row stages. Checked here for the wo,
gate/up and down products of every configuration in models/config.py; the
card checks the kernel's bits against it (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import inspect

import pytest

from magicdec_tpu_torch.models.config import TRANSFORMER_CONFIGS, ModelArgs
from magicdec_tpu_torch.ops import fused_block as fb


def _products(cfg):
    """(name, K, N) of fused_post_attn's three products (models/llama.py):
    wo [Hq*Dh, D], w_gate_up [D, 2I] and w_down [I, D]."""
    D, I = cfg.dim, cfg.intermediate_size
    return (("wo", cfg.n_head * cfg.head_dim, D), ("w_gate_up", D, 2 * I),
            ("w_down", I, D))


def test_the_plan_reads_no_row_count():
    """The plan's only inputs are K and N, and it is a pure function of
    them, so every M of a product gets the same splits."""
    assert list(inspect.signature(fb.launch_plan).parameters) == ["K", "N"]
    assert fb.launch_plan(14336, 4096) == fb.launch_plan(14336, 4096)


@pytest.mark.parametrize("name", sorted(TRANSFORMER_CONFIGS))
def test_plan_tiles_k_in_whole_stages(name):
    """Each product's ranges tile K in whole stages, in order, balanced
    (sizes differ by at most one stage), with 1 to MAX_SPLITS splits, and
    give every column block at least one CTA."""
    cfg = ModelArgs.from_name(name)
    for product, K, N in _products(cfg):
        assert K % fb.STAGE_K == 0 and N % fb.KERNEL_K == 0, (product, K, N)
        plan = fb.launch_plan(K, N)
        assert 1 <= len(plan) <= fb.MAX_SPLITS, (product, plan)
        assert plan[0][0] == 0 and plan[-1][1] == K, (product, plan)
        for (k0, k1), (n0, _) in zip(plan, plan[1:] + ((K, K),)):
            assert k0 % fb.STAGE_K == 0 and k1 % fb.STAGE_K == 0
            assert k0 < k1 == n0, (product, plan)
        sizes = {(k1 - k0) // fb.STAGE_K for k0, k1 in plan}
        assert max(sizes) - min(sizes) <= 1, (product, plan)
        assert len(plan) == 1 or min(sizes) >= fb.PLAN_STAGES, (product, plan)
        ctas = fb.column_blocks(N) * len(plan)
        assert ctas >= fb.column_blocks(N) >= 1, (product, ctas)


@pytest.mark.parametrize("name", sorted(TRANSFORMER_CONFIGS))
def test_gate_up_pairs_cover_i_exactly(name):
    """The gate/up pass's column blocks (64 gate columns and the matching 64
    up columns, I apart) cover each of gate and up once: column_blocks(2I)
    blocks of TILE_COLS / 2 columns make exactly I, with no partial block."""
    I = ModelArgs.from_name(name).intermediate_size
    assert I % fb.KERNEL_K == 0, I
    half = fb.TILE_COLS // 2
    starts = [half * c for c in range(fb.column_blocks(2 * I))]
    gate = {col for c in starts for col in range(c, c + half)}
    up = {I + col for col in gate}
    assert gate == set(range(I)) and up == set(range(I, 2 * I))


def test_plan_at_the_timed_widths():
    """The split counts PERF.md's times were taken at: llama-3.2-1b wo 4
    (16 column blocks x 4 = 64 CTAs), gate/up 1 (128 CTAs), w_down 8 (128
    CTAs); llama-3.1-8b wo and w_down 4 (128 CTAs), gate/up 1 (224 CTAs)."""
    for name, counts in (("llama-3.2-1b", (4, 1, 8)),
                         ("llama-3.1-8b", (4, 1, 4))):
        cfg = ModelArgs.from_name(name)
        assert tuple(len(fb.launch_plan(K, N))
                     for _, K, N in _products(cfg)) == counts, name


def _qkv_width(cfg):
    """fused_qkv's product [M, D] @ [D, O]: O = (Hq + 2 Hkv) * head_dim."""
    return cfg.dim, (cfg.n_head + 2 * cfg.n_kv_head) * cfg.head_dim


@pytest.mark.parametrize("name", sorted(TRANSFORMER_CONFIGS))
def test_qkv_plan_tiles_k_in_whole_stages(name):
    """The bf16 fused_qkv product's plan, qkv_plan(D, O), tiles D in whole
    stages, in order, balanced, with 1 to MAX_SPLITS splits of at least
    PLAN_STAGES stages, and keeps the product within QKV_PLAN_CTAS CTAs at
    one 64-row tile."""
    D, O = _qkv_width(ModelArgs.from_name(name))
    assert D % fb.STAGE_K == 0 and O % fb.KERNEL_COLS == 0, (D, O)
    plan = fb.qkv_plan(D, O)
    assert 1 <= len(plan) <= fb.MAX_SPLITS, plan
    assert [k for r in plan for k in r][1:-1:2] == [k for r in plan
                                                   for k in r][2::2]
    assert plan[0][0] == 0 and plan[-1][1] == D, plan
    assert all(k0 % fb.STAGE_K == 0 and k1 % fb.STAGE_K == 0 and k0 < k1
               for k0, k1 in plan), plan
    sizes = {(k1 - k0) // fb.STAGE_K for k0, k1 in plan}
    assert max(sizes) - min(sizes) <= 1, plan
    assert len(plan) == 1 or min(sizes) >= fb.PLAN_STAGES, plan
    assert (len(plan) == 1
            or fb.column_blocks(O) * len(plan) <= fb.QKV_PLAN_CTAS)


@pytest.mark.parametrize("name,splits,ctas", [("llama-3.2-1b", 4, 96),
                                              ("llama-3.1-8b", 4, 192)])
def test_qkv_plan_at_the_timed_widths(name, splits, ctas):
    """The QKV product's split count and CTAs at one 64-row tile where
    PERF.md's times were taken: llama-3.2-1b D=2048, O=3072 (24 column
    blocks x 4 splits); llama-3.1-8b D=4096, O=6144 (48 x 4)."""
    D, O = _qkv_width(ModelArgs.from_name(name))
    plan = fb.qkv_plan(D, O)
    assert len(plan) == splits and fb.column_blocks(O) * splits == ctas


def test_qkv_plan_reads_no_row_count():
    """qkv_plan's only inputs are K and N, and _qkv_launch calls it with
    (D, O), so x[:8] and x[:56] get the same splits."""
    assert list(inspect.signature(fb.qkv_plan).parameters) == ["K", "N"]
    assert "qkv_plan(D, O)" in inspect.getsource(fb._qkv_launch)
