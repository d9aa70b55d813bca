"""The centroid_scores kernel's launch plan (ops/gemm_softmax.py
`scores_plan`), on the CPU.

The kernel splits a (sequence, KV head)'s C centroids over a thread-block
cluster; each CTA's (max, sum of exp) partials are combined in rank order,
so a head's bits depend on the plan. The plan must come from C and D alone,
never from B, Hkv or T, so that the per-shard form (centroid_scores_sharded)
gives a head the bits of the whole kernel; and its chunks must tile C with
at most 8 CTAs a cluster (the portable cluster size). The card checks the
kernel against the plain version at the plan (tests/test_torch_cuda_kernels.py,
chip_smoke.py).
"""

import inspect

import pytest
import torch

from magicdec_tpu_torch.ops import gemm_softmax as gs

# C = max_len / 32 clusters: 32 (P=1024), 130 (the main path's P=4096), 520,
# 1024 (P=32768, bench.py's prompt) and 4096
CLUSTERS = (32, 130, 520, 1024, 4096)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("C", CLUSTERS)
def test_chunks_tile_c(C, D):
    """1 to MAX_SPLITS (<= 8) CTAs a cluster; the chunks [s chunk, (s + 1)
    chunk) cut at C cover every centroid once and none is empty; each CTA
    stays within SCORES_CTA_FLOATS centroid floats unless the cluster is
    full."""
    S, chunk = gs.scores_plan(C, D)
    assert 1 <= S <= gs.MAX_SPLITS <= 8
    owned = [range(s * chunk, min(C, (s + 1) * chunk)) for s in range(S)]
    assert all(len(r) > 0 for r in owned), (S, chunk)
    assert [c for r in owned for c in r] == list(range(C))
    assert S == gs.MAX_SPLITS or chunk * D <= gs.SCORES_CTA_FLOATS


@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("C", CLUSTERS)
def test_a_cta_fits_shared_memory(C, D, T):
    """A CTA's query rows (T*G = 4 T at 32 query over 8 KV heads), staged
    tile and logits fit the kernel's shared memory at every plan."""
    S, chunk = gs.scores_plan(C, D)
    assert 4 * gs._smem_floats(4 * T, D, chunk) <= gs._SMEM_LIMIT


def test_the_plan_reads_c_and_d_only():
    """scores_plan's only inputs are C and D, and the launch takes it from
    the centroids' C and D: B, Hkv and T are in none of them."""
    assert list(inspect.signature(gs.scores_plan).parameters) == ["C", "D"]
    assert "scores_plan(C, D)" in inspect.getsource(gs._scores_launch)


@pytest.mark.parametrize("C", CLUSTERS)
def test_the_plan_is_the_same_at_any_b_hkv_t(C):
    """The plan of q [B, T, Hq, D] and centroids [B, Hkv, C, D] is the same
    for a tp shard's heads, another batch and another query length: only
    the shapes' C and D reach it."""
    D = 64
    plans = set()
    for B, T, Hkv in ((8, 1, 8), (1, 7, 4), (3, 29, 2), (16, 4, 1)):
        q = torch.empty((B, T, 4 * Hkv, D))
        cent = torch.empty((B, Hkv, C, D))
        plans.add(gs.scores_plan(cent.shape[2], q.shape[3]))
    assert plans == {gs.scores_plan(C, D)}


def test_plan_at_the_timed_clusters():
    """The cluster sizes of PERF.md's times at D=64: C = 32, 130, 520 and
    1024 take 1, 2, 5 and 8 CTAs a cluster."""
    assert [gs.scores_plan(C, 64)[0] for C in (32, 130, 520, 1024)] == [
        1, 2, 5, 8]
