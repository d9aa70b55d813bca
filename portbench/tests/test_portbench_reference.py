"""The plain reference (portbench/reference/model.py) against the program,
magicdec_tpu_torch, on the CPU at tiny Mistral-like (GQA group 4) and
Qwen-like (group 7, qkv bias) sizes, in float32: the same weights and ids
give the same logits at every position."""

import json
from pathlib import Path

import pytest
import torch

from portbench import layout, weights
from portbench.reference import model as ref
from portbench.run import model_args

DATA = Path(__file__).resolve().parent / "data"


def _config(name: str) -> dict:
    return json.loads((DATA / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["tiny-mistral", "tiny-qwen"])
def test_reference_logits_equal_the_programs_in_f32(name):
    from magicdec_tpu_torch.cache import KVCache
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.models import llama

    config = _config(name)
    sz = layout.sizes(config)
    assert sz.group == (4 if name == "tiny-mistral" else 7)
    params = weights.make(sz, 20, "cpu", torch.float32)
    S = 192
    ids = weights.prompts(20, 0, 1, S, sz.vocab, "cpu")
    cfg = model_args(config)
    cache = KVCache.create(sz.n_layer, 1, 256, sz.n_kv_head, sz.head_dim,
                           torch.float32, "cpu")
    impl = impls.target_attn(cfg, cache.lengths, S, uniform_start=0)
    prog = llama.forward(params, cfg, ids, impl, (cache.k, cache.v))[0]
    mine = ref.logits_at(params, sz, ids[0], range(S), score_elems=4096)
    assert mine.shape == prog.shape
    scale = prog.abs().max()
    assert (mine - prog).abs().max() <= 1e-4 * scale


def test_reference_attention_blocks_do_not_change_the_logits():
    sz = layout.sizes(_config("tiny-qwen"))
    params = weights.make(sz, 21, "cpu", torch.float32)
    ids = weights.prompts(21, 0, 1, 160, sz.vocab, "cpu")[0]
    whole = ref.logits_at(params, sz, ids, [0, 77, 159])
    blocked = ref.logits_at(params, sz, ids, [0, 77, 159], row_block=64,
                            score_elems=7 * 160 * 64)
    assert torch.allclose(whole, blocked, rtol=1e-5, atol=1e-5)


def test_fp8_control_rounds_to_e4m3():
    x = torch.tensor([[1.0, 0.3, -448.0 / 7]])
    q = ref._fp8(x, 1)
    assert q[0, 2] == x[0, 2]                  # the amax maps to 448 exactly
    assert 0 < (q - x).abs().max() <= x.abs().max() / 448 * 16
