"""The bf16 int4_matmul kernel's launch plan (ops/int4_matmul.py
`launch_plan`), on the CPU.

The plan cuts K into the splits whose f32 partials the kernel sums in
order. A row's bits depend on that order, so the plan must come from K and
N/2 alone, never from the row count, and its ranges must tile K in whole
128-row scale groups. Checked here for every weight product of every
configuration in models/config.py that the kernel takes (K a multiple of
128, N/2 a multiple of 16); the card checks the kernel's bits against it
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import inspect

import pytest

from magicdec_tpu_torch.models.config import TRANSFORMER_CONFIGS, ModelArgs
from magicdec_tpu_torch.ops import int4_matmul as im


def _products(cfg):
    """(name, K, N) of a layer's four weight products (models/llama.py)."""
    Dh, Hq, Hkv = cfg.head_dim, cfg.n_head, cfg.n_kv_head
    D, I = cfg.dim, cfg.intermediate_size
    return (("wqkv", D, (Hq + 2 * Hkv) * Dh), ("wo", Hq * Dh, D),
            ("w_gate_up", D, 2 * I), ("w_down", I, D))


def test_the_plan_reads_no_row_count():
    """The plan's only inputs are K and N/2, and it is a pure function of
    them, so every M of a product gets the same splits."""
    assert list(inspect.signature(im.launch_plan).parameters) == ["K", "N2"]
    assert im.launch_plan(14336, 2048) == im.launch_plan(14336, 2048)


@pytest.mark.parametrize("name", sorted(TRANSFORMER_CONFIGS))
def test_plan_tiles_k_in_whole_groups(name):
    cfg = ModelArgs.from_name(name)
    taken = 0
    for product, K, N in _products(cfg):
        N2 = N // 2
        if K % im.KERNEL_GROUP or N % 2 or N2 % im.KERNEL_COLS:
            continue
        taken += 1
        plan = im.launch_plan(K, N2)
        assert 1 <= len(plan) <= im.MAX_SPLITS, (product, plan)
        assert plan[0][0] == 0 and plan[-1][1] == K, (product, plan)
        for (k0, k1), (n0, _) in zip(plan, plan[1:] + ((K, K),)):
            assert k0 % im.KERNEL_GROUP == 0 and k1 % im.KERNEL_GROUP == 0
            assert k0 < k1 == n0, (product, plan)
        # balanced: split sizes differ by at most one group
        sizes = {(k1 - k0) // im.KERNEL_GROUP for k0, k1 in plan}
        assert max(sizes) - min(sizes) <= 1, (product, plan)
    assert taken == 4, f"{name}: the kernel takes {taken} of 4 products"
