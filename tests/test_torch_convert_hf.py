"""The port's HF checkpoint loader against the JAX package's and HF's.

Tiny random `transformers` models are built here (nothing is downloaded):
tests/test_hf_parity.py's five llama cases and its Qwen2 qkv-bias model.
The port's params_from_hf_state_dict must give the JAX package's leaves bit
for bit (in float32), and the port's logits must be HF's within the bound
test_hf_parity uses (rtol = atol = 2e-4). The port's own safetensors reader
is held against files the `safetensors` package writes; the .bin branch
against the safetensors branch. The slice end to end: a tiny HF llama
saved as sharded safetensors, loaded by both packages, RULER niah prompts
through SnapKV self-speculation in both: the port's stream equals its AR
stream and the JAX stream, the RULER scores are equal, and at full budget
acceptance is exactly 1.0.
"""

import dataclasses
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from magicdec_tpu.checkpoint import convert_hf as jconv
from magicdec_tpu.data import ruler as jruler
from magicdec_tpu.engine.backend import Engine as JEngine
from magicdec_tpu.engine.spec import generate_selfspec as j_spec
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu_torch.checkpoint import convert_hf as tconv
from magicdec_tpu_torch.checkpoint.store import flatten_params
from magicdec_tpu_torch.data import ruler as truler
from magicdec_tpu_torch.engine import attention_impls as timpls
from magicdec_tpu_torch.engine.backend import Engine as TEngine
from magicdec_tpu_torch.engine.spec import (generate_autoregressive as t_ar,
                                            generate_selfspec as t_spec)
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from test_hf_parity import CASES, hf_logits, make_hf_llama  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

QWEN = JArgs(block_size=512, vocab_size=128, n_layer=2, n_head=4,
             n_kv_head=2, dim=64, intermediate_size=128, qkv_bias=True,
             norm_eps=1e-6, rope_base=1000000.0)


def make_hf_qwen(config):
    """tests/test_hf_parity.py's Qwen2 qkv-bias model."""
    hf_cfg = transformers.Qwen2Config(
        vocab_size=config.vocab_size, hidden_size=config.dim,
        intermediate_size=config.intermediate_size,
        num_hidden_layers=config.n_layer, num_attention_heads=config.n_head,
        num_key_value_heads=config.n_kv_head, rms_norm_eps=config.norm_eps,
        rope_theta=config.rope_base, max_position_embeddings=config.block_size,
        tie_word_embeddings=False)
    torch.manual_seed(1)
    return transformers.Qwen2ForCausalLM(hf_cfg).eval()


MODELS = sorted(CASES) + ["qwen_qkv_bias"]


def _model(name):
    """(HF model, JAX config, the port's config) of a case."""
    if name == "qwen_qkv_bias":
        jcfg, model = QWEN, make_hf_qwen(QWEN)
    else:
        jcfg, rope_scaling = CASES[name]
        model = make_hf_llama(jcfg, rope_scaling)
    return model, jcfg, TArgs(**dataclasses.asdict(jcfg))


def _state(model, config):
    """The model's state dict as test_hf_parity hands it over: float32, the
    tied lm_head left out."""
    state = {k: v.detach().float() for k, v in model.state_dict().items()}
    if config.tie_word_embeddings:
        state.pop("lm_head.weight", None)
    return state


def _assert_leaves_equal(tparams, jparams):
    """Leaf for leaf, after float32 conversion; the same leaves None."""
    assert (tparams["output"] is None) == (jparams["output"] is None)
    jflat = {k: np.asarray(v, np.float32) for k, v in
             flatten_params(jparams).items()}
    tflat = flatten_params(tparams)
    assert sorted(tflat) == sorted(jflat)
    for key, t in tflat.items():
        assert tuple(t.shape) == jflat[key].shape, key
        np.testing.assert_array_equal(t.float().numpy(), jflat[key],
                                      err_msg=key)


def _port_logits(params, config, tokens):
    """Logits of every position, one forward from an empty cache."""
    B, T = tokens.shape
    shape = (config.n_layer, B, T, config.n_kv_head * config.head_dim)
    caches = (torch.zeros(shape), torch.zeros(shape))
    impl = timpls.target_attn(config, torch.zeros(B, dtype=torch.int32), T)
    return tllama.forward(params, config, torch.from_numpy(tokens), impl,
                          caches).numpy()


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_equal_jax_leaf_for_leaf(name, dtype):
    model, jcfg, tcfg = _model(name)
    state = _state(model, jcfg)
    jp = jconv.params_from_hf_state_dict(
        {k: v.numpy() for k, v in state.items()}, jcfg,
        dtype=getattr(jnp, dtype))
    tp = tconv.params_from_hf_state_dict(state, tcfg,
                                         dtype=getattr(torch, dtype),
                                         device="cpu")
    assert all(t.dtype == getattr(torch, dtype)
               for t in flatten_params(tp).values())
    _assert_leaves_equal(tp, jp)


@pytest.mark.parametrize("name", MODELS)
def test_logits_match_hf(name):
    model, jcfg, tcfg = _model(name)
    params = tconv.params_from_hf_state_dict(_state(model, jcfg), tcfg,
                                             device="cpu")
    rng = np.random.default_rng(0 if name != "qwen_qkv_bias" else 1)
    T = 96 if name != "qwen_qkv_bias" else 64
    tokens = rng.integers(0, tcfg.vocab_size, size=(2, T), dtype=np.int64)
    np.testing.assert_allclose(_port_logits(params, tcfg, tokens),
                               hf_logits(model, tokens), rtol=2e-4, atol=2e-4)


def _tensors(dtype):
    """Tensors of several shapes (a scalar and an empty one among them)."""
    g = torch.Generator().manual_seed(3)
    shapes = {"a.weight": (7, 5), "b": (3,), "c.scalar": (), "d.empty": (0, 4),
              "e.cube": (2, 3, 4)}
    return {k: (torch.randn(s, generator=g) * 100).to(dtype)
            for k, s in shapes.items()}


def _bits(t):
    """A tensor's bytes as a numpy array (bf16 has no numpy dtype)."""
    return t.reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_reader_gives_the_safetensors_packages_bytes(tmp_path, dtype):
    want = _tensors(dtype)
    path = tmp_path / "x.safetensors"
    safetensors_torch.save_file(want, str(path), metadata={"format": "pt"})
    got = tconv.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == dtype and got[k].shape == w.shape, k
        assert np.array_equal(_bits(got[k]), _bits(w)), k
    assert got["b"].device.type == "cpu"


def _write_header(path, header, data=b""):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["unknown_dtype", "offsets_past_the_end",
                                  "offsets_not_the_shape"])
def test_reader_refuses_what_it_cannot_read(tmp_path, case):
    path = tmp_path / "x.safetensors"
    if case == "unknown_dtype":
        _write_header(path, {"w": {"dtype": "F8_E4M3", "shape": [4],
                                   "data_offsets": [0, 4]}}, bytes(4))
        match = "F8_E4M3"
    elif case == "offsets_past_the_end":
        _write_header(path, {"w": {"dtype": "F32", "shape": [4],
                                   "data_offsets": [0, 16]}}, bytes(8))
        match = "offsets"
    else:
        _write_header(path, {"w": {"dtype": "F32", "shape": [3],
                                   "data_offsets": [0, 16]}}, bytes(16))
        match = "offsets"
    with pytest.raises(ValueError, match=match):
        tconv.read_safetensors(path)


@pytest.fixture(scope="module")
def gqa_model():
    return _model("gqa_plain")


@pytest.mark.parametrize("layout", ["single", "sharded", "bin"])
def test_load_hf_checkpoint_layouts(tmp_path, gqa_model, layout):
    """A single model.safetensors, the sharded index layout and
    pytorch_model.bin all load the params of the state dict itself."""
    model, jcfg, tcfg = gqa_model
    kw = {"single": dict(safe_serialization=True),
          "sharded": dict(safe_serialization=True, max_shard_size="40KB"),
          "bin": dict(safe_serialization=False)}[layout]
    model.save_pretrained(tmp_path, **kw)
    files = sorted(p.name for p in tmp_path.iterdir())
    if layout == "sharded":
        assert "model.safetensors.index.json" in files
        assert sum(f.endswith(".safetensors") for f in files) > 1
    elif layout == "bin":
        assert "pytorch_model.bin" in files and not any(
            f.endswith(".safetensors") for f in files)
    got, cfg = tconv.load_hf_checkpoint(tmp_path, config=tcfg,
                                        dtype=torch.float32, device="cpu")
    assert cfg is tcfg
    want = tconv.params_from_hf_state_dict(_state(model, jcfg), tcfg,
                                           device="cpu")
    for key, t in flatten_params(want).items():
        assert torch.equal(flatten_params(got)[key], t), key


def test_load_resolves_the_config_from_the_directory_name(tmp_path):
    """No config: ModelArgs.from_name of the directory's name, as the JAX
    package does (a name it does not know raises)."""
    d = tmp_path / "test-tiny"
    d.mkdir()
    cfg = TArgs.from_name("test-tiny")
    params = tllama.init_params(cfg, device="cpu")
    safetensors_torch.save_file(chip_smoke.hf_state_dict(torch, params, cfg),
                                str(d / "model.safetensors"))
    got, got_cfg = tconv.load_hf_checkpoint(d, dtype=torch.float32,
                                            device="cpu")
    assert got_cfg == cfg
    for key, t in flatten_params(params).items():
        assert torch.equal(flatten_params(got)[key], t), key
    (tmp_path / "no-such-model").mkdir()
    with pytest.raises(ValueError, match="no config matching"):
        tconv.load_hf_checkpoint(tmp_path / "no-such-model", device="cpu")
    with pytest.raises(FileNotFoundError):
        tconv.load_hf_checkpoint(tmp_path / "no-such-model", config=cfg,
                                 device="cpu")


# the slice end to end: test_torch_engine's model widths, vocab 512, and
# RULER niah prompts over the first 256 ids
E2E = JArgs(block_size=512, vocab_size=512, n_layer=2, n_head=4, n_kv_head=2,
            dim=64, intermediate_size=128)
E2E_B, E2E_P, E2E_NEW = 2, 128, 24
E2E_KW = dict(batch_size=E2E_B, max_len=256, prefill_chunk=32)


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The tiny HF llama saved as sharded safetensors, loaded by both
    packages, the niah prompts and answers, and the port's AR stream."""
    d = tmp_path_factory.mktemp("hf") / "tiny-llama"
    make_hf_llama(E2E).save_pretrained(d, max_shard_size="200KB")
    assert (d / "model.safetensors.index.json").exists()
    tcfg = TArgs(**dataclasses.asdict(E2E))
    jp, _ = jconv.load_hf_checkpoint(str(d), config=E2E, dtype=jnp.float32)
    tp, _ = tconv.load_hf_checkpoint(d, config=tcfg, dtype=torch.float32,
                                     device="cpu")
    _assert_leaves_equal(tp, jp)
    prompts, answers = truler.prepare("niah", E2E_P, E2E_B, vocab_size=256,
                                      seed=4)
    jprompts, janswers = jruler.prepare("niah", E2E_P, E2E_B, vocab_size=256,
                                        seed=4)
    np.testing.assert_array_equal(prompts, jprompts)
    np.testing.assert_array_equal(answers, janswers)
    ar, _ = t_ar(TEngine(tcfg, tp, device="cpu", **E2E_KW), prompts, E2E_NEW)
    return dict(tcfg=tcfg, tp=tp, jp=jp, prompts=prompts, answers=answers,
                ar=ar.numpy())


@pytest.mark.parametrize("budget", [32, E2E_P])
def test_hf_checkpoint_ruler_snapkv_slice_end_to_end(e2e, budget):
    gamma, window = 3, 16
    eng = TEngine(e2e["tcfg"], e2e["tp"], spec="snapkv", draft_budget=budget,
                  window_size=window, device="cpu", **E2E_KW)
    out, counts, stats = t_spec(eng, e2e["prompts"], gamma, E2E_NEW)
    out, counts = out.numpy(), counts.numpy()
    jeng = JEngine(E2E, e2e["jp"], spec="snapkv", draft_budget=budget,
                   window_size=window, **E2E_KW)
    jout, jcounts, jstats = j_spec(jeng, jnp.asarray(e2e["prompts"]), gamma,
                                   E2E_NEW)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(out, np.asarray(jout))
    assert stats.total_accepted_drafts == jstats.total_accepted_drafts
    for b in range(E2E_B):
        n = min(counts[b], E2E_NEW)
        assert n > 0
        np.testing.assert_array_equal(out[b, :n], e2e["ar"][b, :n])
    score = truler.score("niah", out, e2e["answers"])
    assert score == jruler.score("niah", np.asarray(jout), e2e["answers"])
    assert score == truler.score("niah", e2e["ar"], e2e["answers"])
    if budget == E2E_P:
        assert stats.acceptance_rate == 1.0, stats
