"""The port's attention kernels: plain versions against the JAX kernels, and
(on a card) the CUDA kernels against their plain versions.

On the CPU the JAX kernels run in Pallas interpret mode, as
tests/test_flash_decode.py runs them, and the port's wrappers run their
plain version (tensors on the CPU). float32 against JAX; the tolerance is
the JAX kernel tests' own 2e-5 (online softmax over blocks vs one softmax).
The limit the card holds the bf16 kernels to (plain_f32_and_limit) is
checked here against an emulation of their rounding. The CUDA kernels
themselves are tested on the card by tests/test_torch_cuda_kernels.py.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdec_tpu.ops.pallas import flash_decode as jfd
from magicdec_tpu_torch.ops import _build
from magicdec_tpu_torch.ops import flash_decode as tfd
from magicdec_tpu_torch.ops.attention import decode_valid_upto

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-5, atol=2e-5)


def _mk(L, B, S, Hkv, G, D, T, seed):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((L, B, S, Hkv * D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((L, B, S, Hkv * D)).astype(np.float32)
    q = rng.standard_normal((B, T, Hkv * G, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,T,lens,D", [
    pytest.param(264, 1, [200, 263, 3, 130], 16, id="264-1-lens0"),
    pytest.param(264, 4, [200, 259, 3, 129], 16, id="264-4-lens1"),
    pytest.param(136, 1, [135, 100, 1, 129], 16, id="136-1-lens2"),
    pytest.param(264, 4, [200, 259, 3, 129], 128, id="264-4-d128")])
def test_decode_plain_matches_jax_kernel(S, T, lens, D):
    """Ragged lengths, partial last block (s_block=128), both layers; the
    head dims 16 and 128 (the kernels' larger build)."""
    L, B, Hkv, G = 2, 4, 2, 2
    q, k, v = _mk(L, B, S, Hkv, G, D, T, seed=S + T)
    valid = decode_valid_upto(torch.tensor(lens, dtype=torch.int32), T)
    for layer in range(L):
        ref = jfd.flash_decode_stacked(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.int32(layer),
                                       jnp.asarray(valid.numpy()), s_block=128,
                                       interpret=True)
        out = tfd.flash_decode_stacked(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), layer, valid)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S,T,cap,lens,D", [
    pytest.param(384, 16, 256, [240, 100, 3, 235], 16, id="384-16-256-lens0"),
    pytest.param(256, 32, 128, [96, 64, 0, 90], 16, id="256-32-128-lens1"),
    pytest.param(256, 32, 128, [96, 64, 0, 90], 128, id="256-32-128-d128")])
def test_prefill_plain_matches_jax_kernel(S, T, cap, lens, D):
    """Causal chunk attention with s_cap < S (the walk stops at the cap);
    the head dims 16 and 128."""
    L, B, Hkv, G = 2, 4, 2, 2
    q, k, v = _mk(L, B, S, Hkv, G, D, T, seed=S + T + cap)
    valid = decode_valid_upto(torch.tensor(lens, dtype=torch.int32), T)
    for layer in range(L):
        ref = jfd.flash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(layer), jnp.asarray(valid.numpy()),
                                s_block=128, s_cap=cap, interpret=True)
        out = tfd.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), layer, valid, s_cap=cap)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cpu_wrappers_run_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _mk(1, 2, 64, 2, 2, 16, 2, seed=1))
    valid = decode_valid_upto(torch.tensor([30, 62], dtype=torch.int32), 2)
    before = (tfd.flash_decode_stacked.launches, tfd.flash_prefill.launches)
    plain = tfd.attention_plain(q, k, v, 0, valid)
    torch.testing.assert_close(tfd.flash_decode_stacked(q, k, v, 0, valid), plain,
                               rtol=0, atol=0)
    torch.testing.assert_close(tfd.flash_prefill(q, k, v, 0, valid), plain,
                               rtol=0, atol=0)
    assert (tfd.flash_decode_stacked.launches, tfd.flash_prefill.launches) == before


def test_kernel_libraries_are_named_by_source_digest():
    paths = {name: _build.lib_path(name) for name in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}-")
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        assert _build.lib_path(name) == p
    # the build directory is ignored by git: the checkout holds only sources
    repo = Path(__file__).resolve().parents[1]
    rel = _build.BUILD_DIR.relative_to(repo).as_posix() + "/"
    assert rel in (repo / ".gitignore").read_text().split()


def _bf16_kernel_numerics(q, k, v, layer, valid):
    """What the bf16 kernels compute: f32 logits and softmax, P rounded to
    bf16 for P@V while l sums the unrounded P, the output rounded to bf16."""
    _, B, S, HD = k.shape
    D = q.shape[-1]
    Hkv, T = HD // D, q.shape[1]
    kk = k[layer].float().reshape(B, S, Hkv, D)
    vv = v[layer].float().reshape(B, S, Hkv, D)
    qq = q.float().reshape(B, T, Hkv, -1, D)
    s = torch.einsum("btkgd,bskd->btkgs", qq, kk) / D ** 0.5
    mask = (torch.arange(S)[None, None, :] < valid[:, :, None])[:, :, None, None]
    p = torch.exp(s.masked_fill(~mask, -1e30) - s.masked_fill(~mask, -1e30)
                  .amax(-1, keepdim=True)) * mask
    out = torch.einsum("btkgs,bskd->btkgd", p.bfloat16().float(), vv)
    return (out / p.sum(-1)[..., None]).reshape(q.shape).bfloat16()


@pytest.mark.parametrize("q_scale,D", [
    pytest.param(1.0, 64, id="1.0"), pytest.param(6.0, 64, id="6.0"),
    pytest.param(1.0, 128, id="1.0-d128"), pytest.param(6.0, 128, id="6.0-d128")])
def test_bf16_limit_admits_kernel_rounding_and_rejects_a_missed_tile(q_scale,
                                                                     D):
    """plain_f32_and_limit admits the bf16 kernels' own rounding and rejects
    an output that misses each row's last 64-slot tile (peaked softmax: the
    rejection must hold; flat: the limit still scales with the output), at
    both head dims of the kernels."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _mk(2, 2, 1100, 2, 4, D, 7, seed=5))
    q = (q.float() * q_scale).bfloat16()
    valid = decode_valid_upto(torch.tensor([1090, 700], dtype=torch.int32), 7)
    ref, limit = tfd.plain_f32_and_limit(q, k, v, 1, valid)
    assert ref.dtype == torch.float32 and limit.shape == ref.shape
    out = _bf16_kernel_numerics(q, k, v, 1, valid)
    assert bool(((out.float() - ref).abs() <= limit).all())
    missed = tfd.attention_plain(q.float(), k.float(), v.float(), 1,
                                 (valid - 1) // 64 * 64).bfloat16()
    rejected = bool(((missed.float() - ref).abs() > limit).any())
    assert rejected or q_scale == 1.0
    assert float(limit.max()) < 0.05 * float(ref.abs().max()) + 1e-3
    _, f32_limit = tfd.plain_f32_and_limit(q.float(), k.float(), v.float(), 1,
                                           valid)
    torch.testing.assert_close(f32_limit, 2e-5 + 2e-5 * ref.abs())
