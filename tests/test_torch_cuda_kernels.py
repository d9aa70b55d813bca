"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked `cuda` and skips
without an NVIDIA GPU. This file imports torch only (the machine with the
card has no JAX); run it there with
`python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda`.
"""

import numpy as np
import pytest
import torch

from magicdec_tpu_torch.ops import flash_decode as tfd
from magicdec_tpu_torch.ops.attention import decode_valid_upto

torch.backends.cuda.matmul.allow_tf32 = False


def _mk(L, B, S, Hkv, G, D, T, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L, B, S, Hkv * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hkv * D)).astype(np.float32)
    q = (rng.standard_normal((B, T, Hkv * G, D)) * q_scale).astype(np.float32)
    return q, k, v


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(dev, dtype, L=2, B=3, S=1100, Hkv=2, G=4, T=7, seed=0,
                 q_scale=1.0):
    q, k, v = _mk(L, B, S, Hkv, G, 64, T, seed, q_scale)
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(k).to(dev, dtype),
            torch.from_numpy(v).to(dev, dtype))


def _assert_within_limit(out, q, k, v, layer, valid, s_cap=None):
    """out against the plain version in f32, element by element, with the
    limit the kernels' rounding allows (tfd.plain_f32_and_limit: 2e-5 in
    f32; in bf16 the bound of rounding P and the output, which scales with
    the output)."""
    ref, limit = tfd.plain_f32_and_limit(q, k, v, layer, valid, s_cap)
    diff = (out.float() - ref).abs()
    assert bool((diff <= limit).all()), float((diff / limit).max())


# q scales: logits of std 0.5 (flat softmax) and of std 3 (peaked)
_Q_SCALES = [1.0, 6.0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7])
def test_card_decode_kernel_matches_plain(cuda, dtype, T):
    for q_scale in _Q_SCALES:
        q, k, v = _card_inputs(cuda, dtype, T=T, q_scale=q_scale)
        lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
        valid = decode_valid_upto(lens, T)
        for layer in range(2):
            out = tfd.flash_decode_stacked(q, k, v, layer, valid)
            _assert_within_limit(out, q, k, v, layer, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_decode_rows_and_capacity_bitexact(cuda, dtype):
    """A T=1 row equals the same row inside T=7, and a cache of capacity
    1088 gives the bits of one of capacity 2112 holding the same prefix."""
    q, k, v = _card_inputs(cuda, dtype, S=2112, T=7)
    lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
    valid = decode_valid_upto(lens, 7)
    full = tfd.flash_decode_stacked(q, k, v, 1, valid)
    for t in range(7):
        one = tfd.flash_decode_stacked(q[:, t:t + 1].contiguous(), k, v, 1,
                                       valid[:, t:t + 1].contiguous())
        assert torch.equal(one, full[:, t:t + 1])
    small = tfd.flash_decode_stacked(q, k[:, :, :1088].contiguous(),
                                     v[:, :, :1088].contiguous(), 1, valid)
    assert torch.equal(small, full)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_prefill_kernel_matches_plain(cuda, dtype):
    for q_scale in _Q_SCALES:
        q, k, v = _card_inputs(cuda, dtype, S=1024, T=128, q_scale=q_scale)
        lens = torch.tensor([640, 0, 300], dtype=torch.int32, device=cuda)
        valid = decode_valid_upto(lens, 128)
        for cap in (512, 1024):
            v_cap = torch.clamp(valid, max=cap)
            out = tfd.flash_prefill(q, k, v, 1, v_cap, s_cap=cap)
            _assert_within_limit(out, q, k, v, 1, v_cap, s_cap=cap)


def _flat_intervals(dev, dtype, S, T, seed, q_scale, sink=128, B=3):
    """Flat [B, S, Hkv*64] caches and the bounds of a sink + gap + window
    draft: a 128-slot sink (two full tiles), window starts leaving gaps of
    whole tiles, windows of 200+ slots (full tiles inside), T rows."""
    q, k, v = _card_inputs(dev, dtype, L=1, B=B, S=S, T=T, seed=seed,
                           q_scale=q_scale)
    lo = torch.tensor([320, 700, 130][:B], dtype=torch.int32, device=dev)
    hi = lo[:, None] + 200 + torch.arange(T, dtype=torch.int32, device=dev)
    hi = torch.clamp(hi + torch.tensor([0, 300, 0][:B], dtype=torch.int32,
                                       device=dev)[:, None], max=S)
    a = torch.full_like(hi, sink)
    return q, k[0], v[0], a, lo[:, None].expand_as(hi).contiguous(), hi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2])
def test_card_intervals_kernel_matches_plain(cuda, dtype, T):
    """Sink + gap + window rows, with and without separate sink K rows."""
    for q_scale in _Q_SCALES:
        q, k, v, a, lo, hi = _flat_intervals(cuda, dtype, 1088, T, 3, q_scale)
        twisted = (k[:, :128].float() * -0.5).to(dtype).contiguous()
        for k_sink in (None, twisted):
            out = tfd.flash_decode_intervals(q, k, v, a, lo, hi, k_sink=k_sink)
            ref, limit = tfd.intervals_plain_f32_and_limit(q, k, v, a, lo, hi,
                                                           k_sink)
            diff = (out.float() - ref).abs()
            assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_intervals_bitexact_with_stacked_on_a_prefix(cuda, dtype):
    """When the intervals reduce to [0, hi) — a = min(sink, hi), lo = sink,
    the full-budget StreamingLLM draft — T=1 and T=2 rows on a flat cache of
    1088 or 4224 slots give the bits of the same rows of a T=7
    flash_decode_stacked over the 4224-slot stacked cache."""
    S, sink = 4224, 16
    q, k, v = _card_inputs(cuda, dtype, S=S, T=7)
    lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
    valid = decode_valid_upto(lens, 7)
    full = tfd.flash_decode_stacked(q, k, v, 1, valid)
    for cap in (1088, S):
        kc, vc = k[1, :, :cap].contiguous(), v[1, :, :cap].contiguous()
        for t0, T in ((0, 2), (2, 1), (5, 2)):
            hi = valid[:, t0:t0 + T].contiguous()
            a = torch.clamp(hi, max=sink)
            lo = torch.full_like(hi, sink)
            qt = q[:, t0:t0 + T].contiguous()
            for k_sink in (None, kc[:, :sink].contiguous()):
                out = tfd.flash_decode_intervals(qt, kc, vc, a, lo, hi,
                                                 k_sink=k_sink)
                assert torch.equal(out, full[:, t0:t0 + T]), (cap, t0, T)
