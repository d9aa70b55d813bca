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
                 q_scale=1.0, D=64):
    q, k, v = _mk(L, B, S, Hkv, G, D, T, seed, q_scale)
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
# the head dims the attention kernels are built for
_HEAD_DIMS = [64, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7])
def test_card_decode_kernel_matches_plain(cuda, dtype, T, D):
    for q_scale in _Q_SCALES:
        q, k, v = _card_inputs(cuda, dtype, T=T, q_scale=q_scale, D=D)
        lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
        valid = decode_valid_upto(lens, T)
        for layer in range(2):
            out = tfd.flash_decode_stacked(q, k, v, layer, valid)
            _assert_within_limit(out, q, k, v, layer, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_decode_rows_and_capacity_bitexact(cuda, dtype, D):
    """A T=1 row equals the same row inside T=7, and a cache of capacity
    1088 gives the bits of one of capacity 2112 holding the same prefix."""
    q, k, v = _card_inputs(cuda, dtype, S=2112, T=7, D=D)
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
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_prefill_kernel_matches_plain(cuda, dtype, D):
    for q_scale in _Q_SCALES:
        q, k, v = _card_inputs(cuda, dtype, S=1024, T=128, q_scale=q_scale,
                               D=D)
        lens = torch.tensor([640, 0, 300], dtype=torch.int32, device=cuda)
        valid = decode_valid_upto(lens, 128)
        for cap in (512, 1024):
            v_cap = torch.clamp(valid, max=cap)
            out = tfd.flash_prefill(q, k, v, 1, v_cap, s_cap=cap)
            _assert_within_limit(out, q, k, v, 1, v_cap, s_cap=cap)


def _flat_intervals(dev, dtype, S, T, seed, q_scale, sink=128, B=3, D=64):
    """Flat [B, S, Hkv*D] caches and the bounds of a sink + gap + window
    draft: a 128-slot sink (two full tiles), window starts leaving gaps of
    whole tiles, windows of 200+ slots (full tiles inside), T rows."""
    q, k, v = _card_inputs(dev, dtype, L=1, B=B, S=S, T=T, seed=seed,
                           q_scale=q_scale, D=D)
    lo = torch.tensor([320, 700, 130][:B], dtype=torch.int32, device=dev)
    hi = lo[:, None] + 200 + torch.arange(T, dtype=torch.int32, device=dev)
    hi = torch.clamp(hi + torch.tensor([0, 300, 0][:B], dtype=torch.int32,
                                       device=dev)[:, None], max=S)
    a = torch.full_like(hi, sink)
    return q, k[0], v[0], a, lo[:, None].expand_as(hi).contiguous(), hi


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2])
def test_card_intervals_kernel_matches_plain(cuda, dtype, T, D):
    """Sink + gap + window rows, with and without separate sink K rows."""
    for q_scale in _Q_SCALES:
        q, k, v, a, lo, hi = _flat_intervals(cuda, dtype, 1088, T, 3, q_scale,
                                             D=D)
        twisted = (k[:, :128].float() * -0.5).to(dtype).contiguous()
        for k_sink in (None, twisted):
            out = tfd.flash_decode_intervals(q, k, v, a, lo, hi, k_sink=k_sink)
            ref, limit = tfd.intervals_plain_f32_and_limit(q, k, v, a, lo, hi,
                                                           k_sink)
            diff = (out.float() - ref).abs()
            assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_intervals_bitexact_with_stacked_on_a_prefix(cuda, dtype, D):
    """When the intervals reduce to [0, hi) — a = min(sink, hi), lo = sink,
    the full-budget StreamingLLM draft — T=1 and T=2 rows on a flat cache of
    1088 or 4224 slots give the bits of the same rows of a T=7
    flash_decode_stacked over the 4224-slot stacked cache."""
    S, sink = 4224, 16
    q, k, v = _card_inputs(cuda, dtype, S=S, T=7, D=D)
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


def _round_buffer(dev, dtype, T, q_scale, NS=896, Wcap=192, seed=4, D=64):
    """The Quest draft's round buffer [2, 3, NS + Wcap, Hkv*D]: a 70%
    colmask over the top region (one page of all-zero bits, one of all-one
    bits), tail bits 1, ragged tails; rows attend [0, NS) u [NS, hi)."""
    R = NS + Wcap
    q, k, v = _card_inputs(dev, dtype, S=R, T=T, seed=seed, q_scale=q_scale,
                           D=D)
    g = torch.Generator(device=dev).manual_seed(seed)
    cm = (torch.rand((2, 3, 1, R), generator=g, device=dev) < 0.7).to(torch.int32)
    cm[..., 128:256] = 0
    cm[..., 256:384] = 1
    cm[..., NS:] = 1
    tail = torch.tensor([128, 3, Wcap - T], dtype=torch.int32, device=dev)
    hi = NS + tail[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                           device=dev)
    return q, k, v, cm, torch.full_like(hi, NS), hi


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2])
def test_card_masked_kernel_matches_plain(cuda, dtype, T, D):
    """Within the plain version's limit; the kernel run with an all-ones
    colmask (a kernel that ignores the bits) fails it."""
    for q_scale in _Q_SCALES:
        q, k, v, cm, ns, hi = _round_buffer(cuda, dtype, T, q_scale, D=D)
        for layer in range(2):
            ref, limit = tfd.stacked_masked_plain_f32_and_limit(
                q, k, v, layer, cm, ns, ns, hi)
            out = tfd.flash_decode_stacked_masked(q, k, v, layer, cm, ns, ns, hi)
            diff = (out.float() - ref).abs()
            assert bool((diff <= limit).all()), float((diff / limit).max())
            ones = tfd.flash_decode_stacked_masked(
                q, k, v, layer, torch.ones_like(cm), ns, ns, hi)
            assert not bool(((ones.float() - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_masked_all_ones_is_the_stacked_kernel(cuda, dtype, D):
    """With an all-ones colmask and a = lo = 0 the masked kernel gives the
    bits of flash_decode_stacked on the same rows (one shared kernel)."""
    q, k, v = _card_inputs(cuda, dtype, S=1088, T=2, D=D)
    lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
    valid = decode_valid_upto(lens, 2)
    zero = torch.zeros_like(valid)
    ones = torch.ones((2, 3, 1, 1088), dtype=torch.int32, device=cuda)
    for layer in range(2):
        assert torch.equal(
            tfd.flash_decode_stacked_masked(q, k, v, layer, ones, zero, zero,
                                            valid),
            tfd.flash_decode_stacked(q, k, v, layer, valid))


def _sentinel(t):
    """Fill t with 0xFF bytes (a NaN in bf16 and f32, never the right
    answer), so a chunk the kernel skips shows; returns t."""
    t.view(torch.uint8).fill_(255)
    return t


def _untouched(t):
    return bool((t.view(torch.uint8) == 255).all())


def _from_sentinel_blocks(like, call):
    """call() (a gather without out, allocating one output like each tensor
    of `like`) right after sentinel-filled blocks of those sizes were
    freed, so the caching allocator hands them back as the outputs."""
    blocks = [_sentinel(torch.empty_like(t)) for t in like]
    ptrs = [t.data_ptr() for t in blocks]
    del blocks
    res = call()
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    assert [t.data_ptr() for t in res] == ptrs, "sentinel blocks not reused"
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("page", [128, 66])
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_page_gather_bitexact(cuda, dtype, D, page):
    """Repeated and out-of-order pages, the last page and indices past both
    ends (clamped), pages of 128 rows and of 66 (no multiple of the kernel's
    16 KB chunk), into new tensors and into a round buffer's top region, every
    destination sentinel-filled first; the planted fault (each unit's last
    chunk dropped) fails the same checks."""
    from magicdec_tpu_torch.ops import page_gather as pg

    _, k, v = _card_inputs(cuda, dtype, S=8 * page, T=1, D=D)
    pages = torch.tensor([[7, 0, 3], [2, 2, 8], [-1, 0, 40]],
                         dtype=torch.int32, device=cuda)
    top = 3 * page
    for layer in range(2):
        want = pg.page_gather_plain(k, v, layer, pages, page)
        got = _from_sentinel_blocks(
            want, lambda: pg.page_gather(k, v, layer, pages, page))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        bufs = _sentinel(torch.empty((2, 2, 3, top + 64, k.shape[-1]),
                                     dtype=dtype, device=cuda))
        tops = [buf[layer, :, :top].view(3, 3, page, -1) for buf in bufs]
        pg.page_gather(k, v, layer, pages, page, out=tops)
        for t, w in zip(tops, want):
            assert torch.equal(t, w)
        assert _untouched(bufs[:, layer, :, top:])
        assert _untouched(bufs[:, 1 - layer])
        _sentinel(bufs)
        pg._gather_launch(k, v, layer, pages, page, tops, fault=1)
        assert not all(torch.equal(t, w) for t, w in zip(tops, want))


@pytest.mark.cuda
@pytest.mark.parametrize("page", [64, 66])
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_page_gather_single_bitexact(cuda, dtype, D, page):
    """Whole clusters of a KV-fused store (page = 2cap = 64 rows, and 66),
    repeated and out-of-order, the last one and indices past both ends,
    into a new tensor and split into the K and V top regions of a round
    buffer, every destination sentinel-filled first; the planted fault
    fails the same checks in both forms."""
    from magicdec_tpu_torch.ops import page_gather as pg

    cap = page // 2
    _, store, _ = _card_inputs(cuda, dtype, S=10 * page, T=1, D=D)
    pages = torch.tensor([[9, 0, 3, 3], [2, 2, 5, 1], [-2, 0, 6, 10]],
                         dtype=torch.int32, device=cuda)
    NS = 4 * cap
    for layer in range(2):
        want = pg.page_gather_single_plain(store, layer, pages, page)
        (got,) = _from_sentinel_blocks(
            [want], lambda: pg.page_gather_single(store, layer, pages, page))
        assert torch.equal(got, want)
        bufs = _sentinel(torch.empty((2, 2, 3, NS + 64, store.shape[-1]),
                                     dtype=dtype, device=cuda))
        tops = [buf[layer, :, :NS].view(3, 4, cap, -1) for buf in bufs]
        pg.page_gather_single(store, layer, pages, page, out=tops)
        assert torch.equal(tops[0], want[:, :, :cap])
        assert torch.equal(tops[1], want[:, :, cap:])
        assert _untouched(bufs[:, layer, :, NS:])
        assert _untouched(bufs[:, 1 - layer])
        _sentinel(bufs)
        pg._single_launch(store, layer, pages, page, tops, fault=1)
        assert not (torch.equal(tops[0], want[:, :, :cap])
                    and torch.equal(tops[1], want[:, :, cap:]))
        fresh = _sentinel(torch.empty_like(want))
        pg._single_launch(store, layer, pages, page, (fresh,), fault=1)
        assert not torch.equal(fresh, want)


@pytest.mark.cuda
def test_card_page_gather_refuses_a_ring_beyond_its_limits(cuda):
    """The C entry alone holds the ring's limits (2 to 16 stages, at most
    200 KB): a geometry beyond them raises instead of launching."""
    from magicdec_tpu_torch.ops import page_gather as pg

    _, k, v = _card_inputs(cuda, torch.bfloat16, S=8 * 128, T=1, D=128)
    pages = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    out = [torch.empty((3, 2, 128, k.shape[-1]), dtype=k.dtype, device=cuda)
           for _ in range(2)]
    for knobs in (dict(stages=1), dict(stages=17, chunk_bytes=4096),
                  dict(chunk_bytes=64 * 1024, stages=4)):
        with pytest.raises(RuntimeError):
            pg._gather_launch(k, v, 0, pages, 128, out, **knobs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("C", [130, 1000])
@pytest.mark.parametrize("D", [64, 128])
def test_card_centroid_scores_matches_plain(cuda, dtype, T, C, D):
    """q in the working type, float32 centroids read through a strided view
    of [B, C, Hkv*D] (130 clusters: not a multiple of 32, one staged tile;
    1000: several tiles), both head dims the kernel is built for, against
    the plain version on the same inputs within 1e-5 + 1e-5 |ref| (float32
    sums in another order, expf)."""
    from magicdec_tpu_torch.ops.gemm_softmax import (centroid_scores,
                                                     centroid_scores_plain)

    B, Hkv, G = 3, 8, 4
    rng = np.random.default_rng(T)
    q = torch.from_numpy(rng.standard_normal((B, T, Hkv * G, D)).astype(
        np.float32)).to(cuda, dtype)
    for scale in (0.2, 2.0):            # a flat and a peaked softmax
        cent = torch.from_numpy((rng.standard_normal((B, C, Hkv * D)) * scale
                                 ).astype(np.float32)).to(cuda)
        view = cent.view(B, C, Hkv, D).transpose(1, 2)
        ref = centroid_scores_plain(q, view)
        out = centroid_scores(q, view)
        assert bool(((out - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all()), \
            float((out - ref).abs().max())
        torch.testing.assert_close(out.sum(-1),
                                   torch.full((B, Hkv), float(T * G),
                                              device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("C", [130, 1024])
@pytest.mark.parametrize("D", [64, 128])
def test_card_centroid_scores_cluster_split(cuda, T, C, D):
    """The centroid_scores kernel with C split over a cluster by
    scores_plan(C, D) (C=130: 2 CTAs at D=64, 3 at 128; C=1024: 8), bf16 q,
    against the plain version within 1e-5 + 1e-5 |ref|; and the limit
    rejects the scores with the last rank left out of the rows' (max, sum
    of exp) combine (`_scores_launch(fault=1)`)."""
    from magicdec_tpu_torch.ops import gemm_softmax as gs

    assert gs.scores_plan(C, D)[0] > 1
    B, Hkv, G = 2, 8, 4
    rng = np.random.default_rng(C + D + T)
    q = torch.from_numpy(rng.standard_normal((B, T, Hkv * G, D)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    for scale in (0.2, 2.0):            # a flat and a peaked softmax
        cent = torch.from_numpy((rng.standard_normal((B, C, Hkv * D)) * scale
                                 ).astype(np.float32)).to(cuda)
        view = cent.view(B, C, Hkv, D).transpose(1, 2)
        ref = gs.centroid_scores_plain(q, view)
        limit = 1e-5 + 1e-5 * ref.abs()
        out = gs.centroid_scores(q, view)
        assert bool(((out - ref).abs() <= limit).all()), \
            float((out - ref).abs().max())
        faulty = gs._scores_launch(q, view, fault=1)
        assert not bool(((faulty - ref).abs() <= limit).all())


def _rand(rng, dev, dtype, *shape, s=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * s).astype(
        np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N2", [(256, 2816), (2048, 1536), (1024, 1040),
                                  (4096, 3072), (4096, 2048), (4096, 14336),
                                  (14336, 2048)])
def test_card_int4_matmul_matches_plain(cuda, dtype, K, N2):
    """int4_matmul against its plain version within the stated limit
    (int4_matmul_plain_f32_and_limit) at M in {8, 56, 64, 100, 256, 1024};
    rows at M=8 bit-equal to the same rows inside M = 56, 256 and 1024; the
    output with one group's -8 rowsum correction left out, and the output
    with the last K split's partial (launch_plan) left out, fail the limit.
    Shapes: a ragged N/2 (1040, no multiple of the 128-column tile), and
    llama-3.1-8b's four products (K = 14336 takes 8 splits)."""
    from magicdec_tpu_torch.ops import int4_matmul as im

    rng = np.random.default_rng(K + N2)
    q4, s4 = im.pack_int4_cols(_rand(rng, cuda, torch.float32, K, 2 * N2,
                                     s=0.02))
    x = _rand(rng, cuda, dtype, 1024, K)
    first = im.int4_matmul(x[:8], q4, s4)
    for M in (8, 56, 64, 100, 256, 1024):
        out = im.int4_matmul(x[:M], q4, s4)
        ref, limit = im.int4_matmul_plain_f32_and_limit(x[:M], q4, s4)
        assert out.dtype == dtype and out.shape == (M, 2 * N2)
        assert bool(((out.float() - ref).abs() <= limit).all())
        if M in (56, 256, 1024):
            assert torch.equal(first, out[:8])
    faulty = out.float() + 8.0 * x[:, :128].float().sum(1, keepdim=True) * s4[0]
    assert not bool(((faulty - ref).abs() <= limit).all())
    k0, k1 = im.launch_plan(K, N2)[-1]
    faulty = out.float() - im.int4_matmul_plain(
        x[:, k0:k1].float(), q4[k0:k1], s4[k0 // 128:k1 // 128])
    assert not bool(((faulty - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(256, 256, 704, 512), (1024, 1024, 2816, 1536)],
                         ids=["D256", "D1024"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_fused_block_matches_plain(cuda, dtype, widths):
    """fused_qkv (with and without a bias) and fused_post_attn against their
    plain versions within the stated limits (per element, and the mean
    error in bf16), M in {8, 56}; rows at M=8 bit-equal to the same rows
    inside M=56; in bf16 the limit rejects fused_post_attn with the last K
    split's partial left out of each split pass's sum. Widths (D = HqD, I,
    O): tests/test_fused_block.py's (no product long enough to split), and
    a wider set whose launch_plan splits every product's K (wo and gate/up
    in 2, w_down in 5)."""
    from magicdec_tpu_torch.ops import fused_block as fb

    D, HqD, I, O = widths
    rng = np.random.default_rng(9)
    x, ctx = _rand(rng, cuda, dtype, 56, D), _rand(rng, cuda, dtype, 56, HqD)
    n = 1.0 + _rand(rng, cuda, dtype, D, s=0.1)
    wqkv, b = _rand(rng, cuda, dtype, D, O, s=0.3), _rand(rng, cuda, dtype, O)
    wo = _rand(rng, cuda, dtype, HqD, D, s=0.3)
    gu = _rand(rng, cuda, dtype, D, 2, I, s=0.3)
    wd = _rand(rng, cuda, dtype, I, D, s=0.3)

    def hold(out, ref, limit):
        err = (out.float() - ref).abs()
        assert bool((err <= limit).all()), float((err / limit).max())
        assert float(err.mean()) <= fb.MEAN_LIMIT * float(ref.abs().mean())

    for M in (8, 56):
        for bias in (None, b):
            out = fb.fused_qkv(x[:M], n, wqkv, bias)
            hold(out, *fb.fused_qkv_plain_f32_and_limit(x[:M], n, wqkv, bias))
        ref, limit = fb.fused_post_attn_plain_f32_and_limit(x[:M], ctx[:M], wo,
                                                            n, gu, wd)
        hold(fb.fused_post_attn(x[:M], ctx[:M], wo, n, gu, wd), ref, limit)
        if dtype == torch.bfloat16 and D > 256:
            faulty = fb._post_attn_launch(x[:M], ctx[:M], wo, n, gu, wd,
                                          fault=1)[0]
            assert not bool(((faulty.float() - ref).abs() <= limit).all())
    assert torch.equal(fb.fused_qkv(x[:8], n, wqkv, b),
                       fb.fused_qkv(x, n, wqkv, b)[:8])
    assert torch.equal(fb.fused_post_attn(x[:8], ctx[:8], wo, n, gu, wd),
                       fb.fused_post_attn(x, ctx, wo, n, gu, wd)[:8])


@pytest.mark.cuda
@pytest.mark.parametrize("D,O", [(1024, 1536), (1024, 1040), (2048, 3072),
                                 (4096, 6144)],
                         ids=["D1024", "O1040", "1b", "8b"])
def test_card_fused_qkv_split_matches_plain(cuda, D, O):
    """The bf16 fused_qkv (sums of squares, then the TMA/wgmma product with
    K split by qkv_plan(D, O)) at widths whose plan splits K (2, 2, 4 and 4
    splits; O=1040 ends on a partial column block with no second
    weight box), with and without a bias, against the plain version within
    the per-element limit and MEAN_LIMIT; rows at M=8 bit-equal to the
    same rows inside M=56; and the limit rejects the output with the last
    split's partial left out of the sum (`_qkv_launch(fault=1)`)."""
    from magicdec_tpu_torch.ops import fused_block as fb

    assert len(fb.qkv_plan(D, O)) > 1
    dtype = torch.bfloat16
    rng = np.random.default_rng(D + O)
    x = _rand(rng, cuda, dtype, 56, D)
    n = 1.0 + _rand(rng, cuda, dtype, D, s=0.1)
    wqkv, b = _rand(rng, cuda, dtype, D, O, s=0.02), _rand(rng, cuda, dtype, O)
    for M in (8, 56):
        for bias in (None, b):
            out = fb.fused_qkv(x[:M], n, wqkv, bias)
            ref, limit = fb.fused_qkv_plain_f32_and_limit(x[:M], n, wqkv, bias)
            err = (out.float() - ref).abs()
            assert out.dtype == dtype and out.shape == (M, O)
            assert bool((err <= limit).all()), float((err / limit).max())
            assert float(err.mean()) <= fb.MEAN_LIMIT * float(ref.abs().mean())
            faulty = fb._qkv_launch(x[:M], n, wqkv, bias, fault=1)[0]
            assert not bool(((faulty.float() - ref).abs() <= limit).all())
    assert torch.equal(fb.fused_qkv(x[:8], n, wqkv, b),
                       fb.fused_qkv(x, n, wqkv, b)[:8])


@pytest.mark.cuda
def test_card_fused_rows_bitexact_at_verify_sizes(cuda):
    """At Mistral-7B's widths (D = HqD = 4096, I = 14336, O = 6144), bf16:
    fused_qkv and fused_post_attn rows at M=32 (an AR or draft step of 32
    sequences) equal the same rows inside M=160 (a gamma 4 verify: three
    64-row tiles) and M=928 (a GliDe tree verify of 29 nodes: fifteen) bit
    for bit; at M=160 each output holds its plain f32 limit and
    MEAN_LIMIT, and the limit rejects each launched with the last K
    split's partial left out of its sum (wo, w_down and the qkv product
    split K in 4 at these widths)."""
    from magicdec_tpu_torch.ops import fused_block as fb

    D, HqD, I, O = 4096, 4096, 14336, 6144
    dtype = torch.bfloat16
    rng = np.random.default_rng(22)
    x, ctx = _rand(rng, cuda, dtype, 928, D), _rand(rng, cuda, dtype, 928, HqD)
    n = 1.0 + _rand(rng, cuda, dtype, D, s=0.1)
    wqkv = _rand(rng, cuda, dtype, D, O, s=0.02)
    wo = _rand(rng, cuda, dtype, HqD, D, s=0.02)
    gu = _rand(rng, cuda, dtype, D, 2, I, s=0.02)
    wd = _rand(rng, cuda, dtype, I, D, s=0.02)
    step_qkv = fb.fused_qkv(x[:32], n, wqkv)
    step_post = fb.fused_post_attn(x[:32], ctx[:32], wo, n, gu, wd)
    for M in (160, 928):
        assert torch.equal(fb.fused_qkv(x[:M], n, wqkv)[:32], step_qkv)
        assert torch.equal(fb.fused_post_attn(x[:M], ctx[:M], wo, n, gu,
                                              wd)[:32], step_post)
    M = 160
    for launch, plain in (
            (lambda **kw: fb._qkv_launch(x[:M], n, wqkv, **kw)[0],
             lambda: fb.fused_qkv_plain_f32_and_limit(x[:M], n, wqkv)),
            (lambda **kw: fb._post_attn_launch(x[:M], ctx[:M], wo, n, gu, wd,
                                               **kw)[0],
             lambda: fb.fused_post_attn_plain_f32_and_limit(
                 x[:M], ctx[:M], wo, n, gu, wd))):
        ref, limit = plain()
        err = (launch().float() - ref).abs()
        assert bool((err <= limit).all()), float((err / limit).max())
        assert float(err.mean()) <= fb.MEAN_LIMIT * float(ref.abs().mean())
        faulty = launch(fault=1).float()
        assert not bool(((faulty - ref).abs() <= limit).all())


def _assert_lse(got, want, dtype):
    """(ctx, m, l) of a return_lse kernel against the plain f32 (m, l): m
    where the row is not empty, l everywhere (tfd.lse_limits); empty rows
    give l == 0 and ctx == 0 in both."""
    ctx, m, l = got
    _, m_ref, l_ref = want
    lim_m, lim_l = tfd.lse_limits(m_ref, l_ref, dtype)
    live = l_ref > 0
    assert bool(((m - m_ref).abs() <= lim_m)[live].all())
    assert bool(((l - l_ref).abs() <= lim_l).all()), float((l - l_ref).abs().max())
    assert bool((l[~live] == 0).all()) and bool((ctx.float()[~live] == 0).all())
    assert bool(torch.isfinite(ctx.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 7])
def test_card_decode_lse_matches_plain(cuda, dtype, T, D):
    """flash_decode_stacked(return_lse=True): ctx within the plain limit and
    bit-equal to the call without the flag, (m, l) within tfd.lse_limits,
    and an empty row (sequence 2's first query) gives l = 0 and ctx = 0."""
    for q_scale in _Q_SCALES:
        q, k, v = _card_inputs(cuda, dtype, T=T, q_scale=q_scale, D=D)
        lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
        valid = decode_valid_upto(lens, T)
        valid[2, 0] = 0
        for layer in range(2):
            got = tfd.flash_decode_stacked(q, k, v, layer, valid,
                                           return_lse=True)
            assert torch.equal(got[0], tfd.flash_decode_stacked(q, k, v, layer,
                                                                valid))
            want = tfd.attention_plain_lse(q.float(), k.float(), v.float(),
                                           layer, valid)
            _assert_lse(got, want, dtype)
            # ctx of the live rows (the plain softmax of an empty row is
            # uniform, not 0)
            ref, limit = tfd.plain_f32_and_limit(q, k, v, layer, valid)
            live = want[2] > 0
            assert bool(((got[0].float() - ref).abs() <= limit)[live].all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 4, 16])
def test_card_intervals_lse_matches_plain(cuda, dtype, T, D):
    """flash_decode_intervals(return_lse=True) over a flat own cache's
    prefix [0, hi) (the GliDe tree draft; T=16 is the leaf level of tree
    (4,2,2): 64 rows) and over sink + gap + window rows; one empty row."""
    for q_scale in _Q_SCALES:
        q, k, v, a, lo, hi = _flat_intervals(cuda, dtype, 1088, T, 5, q_scale,
                                             D=D)
        zero = torch.zeros_like(hi)
        base = torch.tensor([1000, 700, 0], dtype=torch.int32, device=cuda)
        prefix = base[:, None].expand_as(hi).contiguous()
        for rows in ((zero, zero, prefix), (a, lo, hi)):
            got = tfd.flash_decode_intervals(q, k, v, *rows, return_lse=True)
            assert torch.equal(got[0], tfd.flash_decode_intervals(q, k, v,
                                                                  *rows))
            want = tfd.intervals_plain_lse(q.float(), k.float(), v.float(),
                                           *rows)
            _assert_lse(got, want, dtype)
            ref, limit = tfd.intervals_plain_f32_and_limit(q, k, v, *rows)
            live = want[2] > 0          # the plain softmax of an empty row
            assert bool(((got[0].float() - ref).abs() <= limit)[live].all())


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_chunked_stacked_lse_rows_bitexact(cuda, dtype, D):
    """attention_impls.flash_stacked_lse at T=29, G=4 (tree (4,2,2)'s
    verify: two launches of 16 and 13 rows) gives each row the bits of that
    row launched alone."""
    from magicdec_tpu_torch.engine.attention_impls import flash_stacked_lse

    q, k, v = _card_inputs(cuda, dtype, S=2112, T=29, D=D)
    lens = torch.tensor([1000, 511, 3], dtype=torch.int32, device=cuda)
    hi = lens[:, None].expand(3, 29).contiguous()
    before = tfd.flash_decode_stacked.launches_lse
    full = flash_stacked_lse(q, k, v, 1, hi)
    assert tfd.flash_decode_stacked.launches_lse == before + 2
    for t in (0, 15, 16, 28):
        one = tfd.flash_decode_stacked(q[:, t:t + 1].contiguous(), k, v, 1,
                                       hi[:, t:t + 1].contiguous(),
                                       return_lse=True)
        for a, b in zip(one, full):
            assert torch.equal(a, b[:, t:t + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
def test_card_limit_rejects_a_dropped_ring_stage(cuda, D):
    """The bf16 kernels with a planted pipeline fault (fault=1: the last
    tile of each decode split, and of each prefill CTA's walk, is copied
    into its ring stage but never computed) fail the plain version's limit
    on peaked inputs, while the same launch without the fault holds it."""
    q, k, v = _card_inputs(cuda, torch.bfloat16, S=1100, T=7, q_scale=6.0,
                           D=D)
    valid = decode_valid_upto(
        torch.tensor([1000, 511, 300], dtype=torch.int32, device=cuda), 7)
    ref, limit = tfd.plain_f32_and_limit(q, k, v, 1, valid)
    for fault in (0, 1):
        out = tfd._decode_launch(q, k, v, 1, valid, k.shape[2], fault=fault)
        assert bool(((out.float() - ref).abs() <= limit).all()) == (fault == 0)
    q, k, v = _card_inputs(cuda, torch.bfloat16, S=1024, T=128, q_scale=6.0,
                           D=D)
    valid = decode_valid_upto(
        torch.tensor([640, 200, 300], dtype=torch.int32, device=cuda), 128)
    ref, limit = tfd.plain_f32_and_limit(q, k, v, 1, valid, 1024)
    for fault in (0, 1):
        out = tfd._prefill_launch(q, k, v, 1, valid, 1024, fault=fault)
        assert bool(((out.float() - ref).abs() <= limit).all()) == (fault == 0)


# the per-shard forms of tensor parallelism: each on every rank's contiguous
# head shard, the shards concatenated against the kernel on the whole tensors
_SHARDED_FORMS = ["_flash_stacked", "_flash_prefill_dispatch",
                  "_flash_intervals", "_tail_attend", "flash_stacked_lse",
                  "page_gather_sharded", "page_gather_single_sharded",
                  "centroid_scores_sharded"]


def _bits(t):
    t = t.contiguous()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.cuda
@pytest.mark.parametrize("D", _HEAD_DIMS)
@pytest.mark.parametrize("form", _SHARDED_FORMS)
def test_card_sharded_form_bitequal_to_whole(cuda, form, D):
    """At tp = 2 and 4 (Hkv=4 KV heads, G=2, bf16), each rank's form on its
    contiguous head shard, concatenated, gives the whole kernel's bits:
    attention, the gathers and the scores are per head."""
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.engine.retro import _tail_attend
    from magicdec_tpu_torch.ops import gemm_softmax as gs
    from magicdec_tpu_torch.ops import page_gather as pg
    from magicdec_tpu_torch.parallel.sharding import Mesh

    Hkv, S, T = 4, 1152, 7
    q, k, v = _card_inputs(cuda, torch.bfloat16, S=S, T=T, Hkv=Hkv, G=2, D=D)
    q128 = _card_inputs(cuda, torch.bfloat16, S=S, T=128, Hkv=Hkv, G=2,
                        D=D, seed=1)[0]
    Bk = q.shape[0]
    valid = decode_valid_upto(
        torch.tensor([1000, 511, 300], dtype=torch.int32, device=cuda), T)
    valid128 = decode_valid_upto(
        torch.tensor([512, 600, 130], dtype=torch.int32, device=cuda), 128)
    a = torch.full_like(valid, 4)
    lo = torch.full_like(valid, 200)
    q1, hi1 = q[:, :1].contiguous(), valid[:, :1].contiguous()
    ns = torch.full_like(hi1, 256)
    cm = (torch.rand((2, Bk, 1, S), device=cuda) < 0.7).to(torch.int32)
    pages = torch.tensor([[3, 0, 8], [7, 7, 1], [8, 2, 5]], dtype=torch.int32,
                         device=cuda)
    cents = torch.randn((Bk, 9, Hkv * D), device=cuda)

    def cut(x, tp, r, axis):
        n = x.shape[axis] // tp
        return x.narrow(axis, r * n, n).contiguous()

    def cview(c):
        return c.view(Bk, 9, -1, D).transpose(1, 2)

    calls = {   # form -> (on rank r of tp, on the whole tensors, out axis)
        "_flash_stacked": (
            lambda m, tp, r: impls._flash_stacked(
                cut(q, tp, r, 2), cut(k, tp, r, 3), cut(v, tp, r, 3), 1,
                valid, m),
            lambda: tfd.flash_decode_stacked(q, k, v, 1, valid), 2),
        "_flash_prefill_dispatch": (
            lambda m, tp, r: impls._flash_prefill_dispatch(
                cut(q128, tp, r, 2), cut(k, tp, r, 3), cut(v, tp, r, 3), 0,
                valid128, m, s_cap=768),
            lambda: tfd.flash_prefill(q128, k, v, 0, valid128, s_cap=768), 2),
        "_flash_intervals": (
            lambda m, tp, r: impls._flash_intervals(
                cut(q, tp, r, 2), cut(k[1], tp, r, 2), cut(v[1], tp, r, 2), a,
                lo, valid, m, k_sink=cut(k[0, :, :4], tp, r, 2)),
            lambda: tfd.flash_decode_intervals(
                q, k[1], v[1], a, lo, valid, k_sink=k[0, :, :4].contiguous()),
            2),
        "_tail_attend": (
            lambda m, tp, r: _tail_attend(
                cut(q1, tp, r, 2), cut(k, tp, r, 3), cut(v, tp, r, 3), cm, 1,
                ns, hi1, m),
            lambda: tfd.flash_decode_stacked_masked(q1, k, v, 1, cm, ns, ns,
                                                    hi1), 2),
        "flash_stacked_lse": (
            lambda m, tp, r: torch.cat([x.float().reshape(Bk, T, -1) for x in
                                        impls.flash_stacked_lse(
                cut(q, tp, r, 2), cut(k, tp, r, 3), cut(v, tp, r, 3), 1,
                valid, mesh=m)], dim=2),
            None, 2),
        "page_gather_sharded": (
            lambda m, tp, r: torch.stack(pg.page_gather_sharded(
                cut(k, tp, r, 3), cut(v, tp, r, 3), 1, pages, 128, mesh=m)),
            lambda: torch.stack(pg.page_gather(k, v, 1, pages, 128)), 4),
        "page_gather_single_sharded": (
            lambda m, tp, r: pg.page_gather_single_sharded(
                cut(k, tp, r, 3), 1, pages, 128, mesh=m),
            lambda: pg.page_gather_single(k, 1, pages, 128), 3),
        "centroid_scores_sharded": (
            lambda m, tp, r: gs.centroid_scores_sharded(
                cut(q, tp, r, 2), cview(cut(cents, tp, r, 2)), mesh=m),
            lambda: gs.centroid_scores(q, cview(cents)), 1),
    }
    on_rank, whole, axis = calls[form]
    for tp in (2, 4):
        outs = [on_rank(Mesh(tp, r, "gloo", cuda), tp, r) for r in range(tp)]
        if form == "flash_stacked_lse":     # (ctx, m, l) per head, by head
            ctx, m_, l_ = tfd.flash_decode_stacked(q, k, v, 1, valid,
                                                   return_lse=True)
            hq = q.shape[2] // tp
            for r, o in enumerate(outs):
                heads = slice(r * hq, (r + 1) * hq)
                want = torch.cat([ctx[:, :, heads].float().reshape(Bk, T, -1),
                                  m_[:, :, heads], l_[:, :, heads]], dim=2)
                assert torch.equal(_bits(o), _bits(want))
            continue
        assert torch.equal(_bits(torch.cat(outs, dim=axis)), _bits(whole()))


# ---------------------------------------------------------------------------
# training on the card (magicdec_tpu_torch/train.py): plain ops and cuBLAS
# products, and flash_prefill in the frozen target's forward
# ---------------------------------------------------------------------------

def _on(tree, dev):
    """A params tree (dicts of tensors, None leaves) on dev."""
    if tree is None or torch.is_tensor(tree):
        return None if tree is None else tree.to(dev)
    return {k: _on(v, dev) for k, v in tree.items()}


def _three_train_steps(dev, cfg, batches):
    """Three make_train_step steps from seed-0 f32 params (scale 0.1) on
    dev, TF32 off: (params before, params after, losses, first moments)."""
    from magicdec_tpu_torch import train
    from magicdec_tpu_torch.models import llama

    params = llama.init_params(cfg, torch.float32, scale=0.1, seed=0,
                               device="cpu")
    p0 = [p.clone() for p in train.leaves_of(params)]
    params = _on(params, dev)
    opt = train.make_optimizer(1e-2, 40)
    step = train.make_train_step(cfg, opt)
    state = opt.init(train.leaves_of(params))
    losses = []
    with train.highest_precision():
        for toks in batches:
            params, state, loss = step(params, state, toks.to(dev))
            losses.append(float(loss))
    return (p0, [p.detach().cpu() for p in train.leaves_of(params)], losses,
            [m.cpu() for m in state["mu"]])


@pytest.mark.cuda
def test_card_three_train_steps_match_cpu(cuda):
    """Three f32 steps on the card against the same steps on the CPU: the
    losses within 1e-5 relative, each leaf's first moment (the gradients'
    average) within 1e-4 of its largest element, each leaf's params within
    1e-4 of its update (mean error over mean update, as
    tests/test_torch_train.py holds the port to JAX)."""
    from magicdec_tpu_torch.data.converters import mixed_markov_dataset
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("test-tiny").replace(tie_word_embeddings=True)
    batches = [torch.from_numpy(mixed_markov_dataset(
        seq_len=64, num_seqs=4, vocab_size=cfg.vocab_size, seed=10 + i))
        for i in range(3)]
    p0, cpu, cpu_loss, cpu_mu = _three_train_steps("cpu", cfg, batches)
    _, card, card_loss, card_mu = _three_train_steps(cuda, cfg, batches)
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    for a, b in zip(card_mu, cpu_mu):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    for a, b, s in zip(card, cpu, p0):
        assert float((a - b).abs().mean() / (b - s).abs().mean()) <= 1e-4


@pytest.mark.cuda
def test_card_target_last_kv_takes_flash_prefill(cuda, monkeypatch):
    """_target_last_kv of a bf16 target over a whole 1024-token sequence on
    the card: one flash_prefill launch a layer, each output within the
    kernel's per-element limit of its plain version on the same inputs,
    and the returned K/V the last layer of the cache those launches read."""
    from magicdec_tpu_torch import train
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b").replace(
        n_layer=2, dim=512, n_head=8, n_kv_head=4, intermediate_size=1024,
        vocab_size=1024)
    params = llama.init_params(cfg, torch.bfloat16, scale=0.1, seed=0,
                               device=cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1024)).astype(np.int32))
    calls = []
    real = impls.flash_prefill

    def spy(q, ck, cv, l, valid, s_cap=None):
        out = real(q, ck, cv, l, valid, s_cap=s_cap)
        ref, limit = tfd.plain_f32_and_limit(q, ck, cv, l, valid, s_cap)
        calls.append((ck, cv, bool(((out.float() - ref).abs()
                                    <= limit).all())))
        return out

    monkeypatch.setattr(impls, "flash_prefill", spy)
    before = tfd.flash_prefill.launches
    k, v = train._target_last_kv(params, cfg, toks, device=cuda)
    assert tfd.flash_prefill.launches - before == cfg.n_layer
    assert len(calls) == cfg.n_layer and all(ok for _, _, ok in calls)
    ck, cv, _ = calls[-1]
    assert k.dtype == torch.bfloat16 and k.shape == (2, 1024, 4 * 64)
    assert torch.equal(k, ck[-1]) and torch.equal(v, cv[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_pinned_fetch_gives_the_store_bytes(cuda, dtype):
    """HostBlockStore.fetch on the card: the wave buffer's gather into a
    pinned buffer and its non-blocking copy give the stored blocks bit for
    bit, across alternating staging buffers and a staging buffer that
    grows, with the host gather of the next fetch overlapping the copy of
    the one before."""
    from magicdec_tpu_torch.engine.wave_buffer import HostBlockStore

    L, B, C, cap, HD = 2, 3, 16, 32, 128
    g = torch.Generator().manual_seed(0)
    blocks = torch.randn((L, B, C, 2, cap, HD), generator=g).to(dtype)
    store = HostBlockStore(L, B, C, cap, HD, dtype)
    for l in range(L):
        store.put_layer(l, blocks[l].to(cuda))
    rng = np.random.default_rng(1)
    got, want = [], []
    for i, n in enumerate((4, 4, 9, 2, 16, 16)):
        top = rng.integers(0, C, (B, n))
        got.append(store.fetch(i % L, top, cuda))
        want.append(blocks[i % L][torch.arange(B)[:, None],
                                  torch.from_numpy(top)])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == dtype
        assert torch.equal(a.cpu(), b)
    staging = store._staging[cuda]
    assert staging.copies == 6 and staging.bytes == sum(
        b.numel() * b.element_size() for b in want)
    assert all(buf.is_pinned() for buf in staging._bufs)


@pytest.mark.cuda
def test_card_full_budget_serving_accepts_exactly_one(cuda):
    """A small f32 ServeEngine on the card at full budget (budget = prompt):
    every live row accepts every draft, and each served stream equals the
    solo stream of its prompt on the card."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.serve import Request, ServeEngine
    from magicdec_tpu_torch.engine.spec import generate_selfspec
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b").replace(
        n_layer=2, dim=256, n_head=4, n_kv_head=2, intermediate_size=512,
        vocab_size=512)
    params = llama.init_params(cfg, torch.float32, scale=0.3, seed=0,
                               device=cuda)
    rng = np.random.default_rng(3)
    P, new_lens = 256, [24, 40, 16, 32, 8]
    prompts = [rng.integers(0, cfg.vocab_size, (P,)).astype(np.int32)
               for _ in new_lens]
    srv = ServeEngine(cfg, params, batch_size=2, max_len=P + 64,
                      draft_budget=P, gamma=4, max_new_cap=40)
    done = srv.run([Request(i, p, n) for i, (p, n)
                    in enumerate(zip(prompts, new_lens))])
    assert srv.acceptance_rate == 1.0 and srv.admissions == 5
    for c in done:
        eng = Engine(cfg, params, batch_size=1, max_len=P + 64,
                     spec="snapkv", draft_budget=P)
        out, _, _ = generate_selfspec(eng, prompts[c.req_id][None], 4,
                                      new_lens[c.req_id])
        assert np.array_equal(c.tokens, out[0, :new_lens[c.req_id]].cpu())
