"""The port's trainer on the CPU against the JAX package.

The four synthetic corpora element for element; checkpoints written by one
package and read by the other (f32, bf16, a tied output, int8 weights);
causal_attn, lm_loss and its gradient per leaf (with and without remat,
tied and untied embeddings); the learning-rate schedule at every step
against optax's and AdamW against optax.adamw over 40 steps; three
make_train_step steps against JAX's on the same batches, with three planted
faults of the optimizer rejected by the same tolerance; _target_last_kv,
glide_loss and the glide gradients (also with a bf16 target and an f32
block, the card's mixed dtypes); train and train_glide lowering the loss.
float32 at test-tiny size, JAX matmuls at "highest" precision
(conftest.py), TF32 off in torch.

Tolerances: 1e-5 on attention outputs and losses; a gradient or K/V leaf
within 1e-5 of its largest element (1e-4 for the mixed dtypes); 3
optimizer steps within STEP_TOL of the JAX update per leaf, mean error
over mean update (see test_three_train_steps_match_jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from magicdec_tpu import train as jtrain
from magicdec_tpu.checkpoint import store as jstore
from magicdec_tpu.data import converters as jconv
from magicdec_tpu.models import glide as jglide
from magicdec_tpu.models import llama as jllama
from magicdec_tpu.models.config import ModelArgs as JArgs
from magicdec_tpu.quant import int8 as jint8
from magicdec_tpu_torch import train as ttrain
from magicdec_tpu_torch.checkpoint import store as tstore
from magicdec_tpu_torch.data import converters as tconv
from magicdec_tpu_torch.models import llama as tllama
from magicdec_tpu_torch.models.config import ModelArgs as TArgs
from magicdec_tpu_torch.models.llama import params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)
JCFG, TCFG = JArgs.from_name("test-tiny"), TArgs.from_name("test-tiny")
B, T = 2, 48


def _cfgs(tied):
    if not tied:
        return JCFG, TCFG
    return (JCFG.replace(tie_word_embeddings=True),
            TCFG.replace(tie_word_embeddings=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jcfg, seed=0, scale=0.1, dtype=jnp.float32):
    return jllama.init_params(jax.random.PRNGKey(seed), jcfg, dtype,
                              scale=scale)


def _tokens(seed, n=B, t=T):
    return tconv.mixed_markov_dataset(seq_len=t, num_seqs=n,
                                      vocab_size=JCFG.vocab_size, seed=seed)


def _jit_grad(loss_fn, config_arg=1):
    """jax.value_and_grad of loss_fn, jitted with the config static (eager
    JAX takes ~15 s here to run it once)."""
    return jax.jit(jax.value_and_grad(loss_fn), static_argnums=config_arg)


def _leaf_err(got: torch.Tensor, want) -> float:
    """max |got - want| over max |want|: an error on the leaf's own scale."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# corpora and checkpoints
# ---------------------------------------------------------------------------

_CORPORA = {
    "synthetic": dict(seq_len=96, num_seqs=6, vocab_size=512),
    "motif": dict(seq_len=100, num_seqs=5),
    "markov": dict(seq_len=120, num_seqs=4),
    "mixed_markov": dict(seq_len=300, num_seqs=5),
}


@pytest.mark.parametrize("seed", [0, 7, 10_000])
@pytest.mark.parametrize("name", sorted(_CORPORA))
def test_corpora_equal_jax(name, seed):
    fn = f"{name}_dataset"
    got = getattr(tconv, fn)(seed=seed, **_CORPORA[name])
    want = getattr(jconv, fn)(seed=seed, **_CORPORA[name])
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _checkpoint_tree(kind):
    """A JAX params tree of one kind of leaf the writer handles: f32, bf16
    with a tied (None) output, int8 {"qT", "s"} dicts (tied, f32 scales)."""
    if kind == "f32":
        return _jax_params(JCFG)
    jcfg = JCFG.replace(tie_word_embeddings=True)
    if kind == "bf16_tied":
        return _jax_params(jcfg, dtype=jnp.bfloat16)
    return jint8.quantize_params(_jax_params(jcfg, seed=1), "int8")


def _assert_trees_bit_equal(port, jax_tree):
    flat_t = tstore.flatten_params(port)
    flat_j = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  jax_tree)[0]}
    assert list(flat_t) == list(flat_j)
    for key, leaf in flat_j.items():
        leaf = np.asarray(leaf)
        t = flat_t[key]
        if leaf.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          leaf.view(np.int16), err_msg=key)
        else:
            assert t.numpy().dtype == leaf.dtype, key
            np.testing.assert_array_equal(t.numpy(), leaf, err_msg=key)


@pytest.mark.parametrize("kind", ["f32", "bf16_tied", "int8"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_round_trips_between_packages(tmp_path, writer, kind):
    """Written by one package, read by the other, every leaf bit-equal and
    of its dtype; a tied output comes back as None in the port's tree and
    is absent from JAX's file."""
    jtree = _checkpoint_tree(kind)
    path = str(tmp_path / "ckpt.npz")
    if writer == "port":
        tstore.save_params(path, params_from_numpy(_np_tree(jtree),
                                                   device="cpu"))
        back = jstore.load_params(path, like=jtree)
        assert jax.tree.structure(back) == jax.tree.structure(jtree)
        for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                          np.asarray(b).view(np.uint8))
    else:
        jstore.save_params(path, jtree)
        back = tstore.load_params(path)
        assert (back["output"] is None) == (kind != "f32")
        _assert_trees_bit_equal(back, jtree)
    with np.load(path) as data:
        assert "output" not in data.files or kind == "f32"
        assert any(k.endswith("@dtype") for k in data.files) == (
            kind == "bf16_tied")


def test_port_save_params_round_trips_itself(tmp_path):
    """save_params then the port's load_params gives every tensor back bit
    for bit, a tied output as None."""
    cfg = TCFG.replace(tie_word_embeddings=True)
    params = tllama.init_params(cfg, torch.bfloat16, seed=3, device="cpu")
    path = str(tmp_path / "p.npz")
    tstore.save_params(path, params)
    back = tstore.load_params(path)
    assert back["output"] is None
    for key, t in tstore.flatten_params(params).items():
        got = tstore.flatten_params(back)[key]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), t.view(torch.int16)), key


# ---------------------------------------------------------------------------
# the LM half
# ---------------------------------------------------------------------------

def test_causal_attn_matches_jax():
    rng = np.random.default_rng(0)
    Hq, Hkv, D = JCFG.n_head, JCFG.n_kv_head, JCFG.head_dim
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    want, _ = jtrain.causal_attn(JCFG)(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), (), 0)
    got = ttrain.causal_attn(TCFG)(*(torch.from_numpy(x) for x in (q, k, v)),
                                   (), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _port_loss(params, cfg, tokens, remat):
    logits = tllama.forward(params, cfg, tokens[:, :-1],
                            ttrain.causal_attn(cfg), (), fused=False,
                            remat=remat)
    return ttrain._nll(logits, tokens[:, 1:])


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_and_gradients_match_jax(remat, tied):
    """The loss within 1e-5 of JAX's lm_loss and each gradient leaf within
    1e-5 of its largest element (a tied embedding's gradient sums its
    lookup and unembedding uses); remat changes neither the loss nor the
    forward's bits."""
    jcfg, tcfg = _cfgs(tied)
    jp = _jax_params(jcfg)
    toks = _tokens(1)
    jloss, jgrads = _jit_grad(jtrain.lm_loss)(jp, jcfg, jnp.asarray(toks))
    tp = params_from_numpy(_np_tree(jp), device="cpu")
    leaves = ttrain.leaves_of(tp)
    for p in leaves:
        p.requires_grad_(True)
    tt = torch.from_numpy(toks)
    loss = _port_loss(tp, tcfg, tt, remat)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    flat_j = {"/".join(str(p.key) for p in path): g for path, g in
              jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    names = list(tstore.flatten_params(tp))
    assert names == list(flat_j)
    for name, g in zip(names, grads):
        assert _leaf_err(g, flat_j[name]) <= 1e-5, name
    with torch.no_grad():
        assert float(ttrain.lm_loss(tp, tcfg, tt)) == float(
            _port_loss(tp, tcfg, tt, remat))
        one = [tllama.forward(tp, tcfg, tt, ttrain.causal_attn(tcfg), (),
                              remat=r) for r in (False, True)]
    assert torch.equal(one[0], one[1])


@pytest.mark.parametrize("steps", [40, 400])
def test_lr_schedule_equals_optax_at_every_step(steps):
    lr = 1e-3
    warmup = min(max(steps // 20, 10), max(steps // 2, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps,
                                              lr * 0.05)
    mine = ttrain.lr_schedule(lr, steps)
    got = np.asarray([mine(c) for c in range(steps + 5)])
    ref = np.asarray([float(want(c)) for c in range(steps + 5)])
    assert got[0] == 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


def test_adamw_equals_optax_adamw_over_40_steps():
    """The port's AdamW on random gradients, every step against optax's
    adamw with the same schedule and weight decay, within the f32 rounding
    that 40 updates of params of order 1 gather (2e-6)."""
    steps, lr = 40, 1e-2
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (11,), (3, 2, 4)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.integers(-4, 1)).astype(
        np.float32) for s in shapes] for _ in range(steps)]
    warmup = min(max(steps // 20, 10), max(steps // 2, 1))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup, steps, lr * 0.05), weight_decay=0.01)
    jp = [jnp.asarray(p) for p in p0]
    jstate = opt.init(jp)
    mine = ttrain.make_optimizer(lr, steps)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tstate = mine.init(tp)
    for step in range(steps):
        upd, jstate = opt.update([jnp.asarray(g) for g in grads[step]],
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = mine.update([torch.from_numpy(g) for g in grads[step]],
                             tstate, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=2e-6, err_msg=f"step {step}")
    assert tstate["count"] == steps


# three steps of make_train_step against JAX's, and the planted faults
STEP_LR, STEP_SCHEDULE, STEP_TOL = 1e-2, 40, 1e-4


class _NoBiasCorrection(ttrain.AdamW):
    def bias_corrections(self, count):
        return 1.0, 1.0


def _optimizers():
    sched = ttrain.lr_schedule(STEP_LR, STEP_SCHEDULE)
    return {
        "right": ttrain.make_optimizer(STEP_LR, STEP_SCHEDULE),
        "schedule_shifted": ttrain.AdamW(lambda c: sched(c + 1)),
        "no_weight_decay": ttrain.AdamW(sched, weight_decay=0.0),
        "no_bias_correction": _NoBiasCorrection(sched),
    }


@pytest.fixture(scope="module")
def three_steps():
    """JAX's make_train_step three times from the same params on the same
    batches (tied embeddings, so the decay reaches the shared table too)."""
    jcfg, _ = _cfgs(True)
    jp = _jax_params(jcfg, seed=4, scale=0.02)
    p0 = _np_tree(jp)
    batches = [_tokens(10 + i, n=4) for i in range(3)]
    warmup = min(max(STEP_SCHEDULE // 20, 10), max(STEP_SCHEDULE // 2, 1))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, STEP_LR, warmup, STEP_SCHEDULE, STEP_LR * 0.05),
        weight_decay=0.01)
    step = jtrain.make_train_step(jcfg, opt)
    state = opt.init(jp)
    losses = []
    for toks in batches:
        jp, state, loss = step(jp, state, jnp.asarray(toks))
        losses.append(float(loss))
    return dict(p0=p0, batches=batches, losses=losses, params=_np_tree(jp))


def _port_three_steps(ref, optimizer):
    _, tcfg = _cfgs(True)
    params = params_from_numpy(ref["p0"], device="cpu")
    step = ttrain.make_train_step(tcfg, optimizer)
    state = optimizer.init(ttrain.leaves_of(params))
    losses = []
    for toks in ref["batches"]:
        params, state, loss = step(params, state, torch.from_numpy(toks))
        losses.append(float(loss))
    return params, losses


def _step_err(ref, params) -> float:
    """The worst leaf's mean |port - JAX| over the mean size of the JAX
    update (params after the steps minus before)."""
    p0 = tstore.flatten_params(params_from_numpy(ref["p0"], device="cpu"))
    want = tstore.flatten_params(params_from_numpy(ref["params"],
                                                   device="cpu"))
    got = tstore.flatten_params(params)
    return max(float((got[k].detach() - want[k]).abs().mean()
                     / (want[k] - p0[k]).abs().mean()) for k in want)


def test_three_train_steps_match_jax(three_steps):
    """Params after 3 steps within STEP_TOL of the JAX update (each leaf's
    mean error over its mean update; ~7e-6 here, the f32 rounding of the
    params) and the three losses within 1e-5. The mean, not the largest
    element: Adam divides each element by its own gradient's size, so an
    element whose gradient is 1e-3 of the leaf's largest carries that
    gradient's f32 error 1e3-fold into its update (1.5e-4 of the largest
    update here, 3e-3 for the card against the CPU). The first step's rate
    is 0, so one step would prove nothing."""
    params, losses = _port_three_steps(three_steps, _optimizers()["right"])
    np.testing.assert_allclose(losses, three_steps["losses"], **TOL)
    assert _step_err(three_steps, params) <= STEP_TOL


@pytest.mark.parametrize("fault", ["schedule_shifted", "no_weight_decay",
                                   "no_bias_correction"])
def test_three_train_steps_reject_planted_faults(three_steps, fault):
    """The same tolerance rejects the optimizer with its schedule read one
    step late (error ~1.2), with the weight decay left out (~1.6e-2, on the
    norm weights of 1; ~2.6e-4 on the others) and with the bias correction
    left out (~3.6)."""
    params, _ = _port_three_steps(three_steps, _optimizers()[fault])
    assert _step_err(three_steps, params) > STEP_TOL


def test_train_lowers_the_loss():
    data = tconv.mixed_markov_dataset(seq_len=64, num_seqs=64,
                                      vocab_size=TCFG.vocab_size, seed=7)
    history = []
    params, loss = ttrain.train(TCFG, data, steps=30, batch=4, lr=3e-3,
                                device="cpu", history=history)
    assert len(history) == 30 and loss == float(history[-1])
    assert loss < 0.6 * float(history[0])
    assert not any(p.requires_grad for p in ttrain.leaves_of(params))


# ---------------------------------------------------------------------------
# the GliDe half
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def glide_models():
    jp = _jax_params(JCFG, scale=0.3)
    jg = jglide.init_glide_params(jax.random.PRNGKey(5), JCFG, scale=0.1)
    return dict(jp=jp, jg=jg, tp=params_from_numpy(_np_tree(jp), device="cpu"),
                tg=params_from_numpy(_np_tree(jg), device="cpu"),
                toks=_tokens(2))


def test_target_last_kv_matches_jax(glide_models):
    toks = glide_models["toks"]
    jk, jv = jax.jit(jtrain._target_last_kv, static_argnums=1)(
        glide_models["jp"], JCFG, jnp.asarray(toks))
    tk, tv = ttrain._target_last_kv(glide_models["tp"], TCFG,
                                    torch.from_numpy(toks), device="cpu")
    assert tk.shape == (B, T, TCFG.n_kv_head * TCFG.head_dim)
    assert _leaf_err(tk, jk) <= 1e-5 and _leaf_err(tv, jv) <= 1e-5


def _glide_loss_and_grads(tg, tp, toks):
    leaves = ttrain.leaves_of(tg)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.glide_loss(tg, tp, TCFG, torch.from_numpy(toks))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), dict(zip(tstore.flatten_params(tg), grads))


def _assert_glide_matches(loss, grads, jloss, jgrads, grad_tol=1e-5):
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        assert _leaf_err(g, jgrads[name]) <= grad_tol, name


def test_glide_loss_and_gradients_match_jax(glide_models):
    """glide_loss within 1e-5 of JAX's and each glide gradient leaf within
    1e-5 of its largest element (the port appends the own cache in place
    under autograd, JAX functionally)."""
    m = glide_models
    jloss, jgrads = _jit_grad(jtrain.glide_loss, 2)(
        m["jg"], m["jp"], JCFG, jnp.asarray(m["toks"]))
    loss, grads = _glide_loss_and_grads(m["tg"], m["tp"], m["toks"])
    _assert_glide_matches(loss, grads, jloss, jgrads)


def test_glide_loss_bf16_target_f32_block_matches_jax(glide_models,
                                                      monkeypatch):
    """The card's dtypes: a bf16 target and an f32 block, which JAX
    promotes without a cast. The target's last-layer K/V are JAX's own
    (both packages' bf16 forwards round differently on the CPU). The loss
    is held within 1e-5 and each gradient leaf within 1e-4 of its largest
    element: the block still rounds to bf16 where JAX does (the RMSNorm of
    the bf16 embedding rows), and an f32 value the packages compute one
    ulp apart can round to neighbouring bf16 values there (~5e-5)."""
    m = glide_models
    jp16 = jtrain.cast_params(m["jp"], jnp.bfloat16)
    toks = jnp.asarray(m["toks"])
    jloss, jgrads = _jit_grad(jtrain.glide_loss, 2)(m["jg"], jp16, JCFG,
                                                    toks)
    jk, jv = jax.jit(jtrain._target_last_kv, static_argnums=1)(jp16, JCFG,
                                                               toks)
    kv = tuple(params_from_numpy(np.asarray(x), device="cpu")
               for x in (jk, jv))
    assert kv[0].dtype == torch.bfloat16
    monkeypatch.setattr(ttrain, "_target_last_kv",
                        lambda params, config, tokens, device=None: kv)
    tp16 = params_from_numpy(_np_tree(jp16), device="cpu")
    loss, grads = _glide_loss_and_grads(m["tg"], tp16, m["toks"])
    _assert_glide_matches(loss, grads, jloss, jgrads, grad_tol=1e-4)


def test_train_glide_lowers_the_loss(glide_models):
    data = tconv.mixed_markov_dataset(seq_len=64, num_seqs=64,
                                      vocab_size=TCFG.vocab_size, seed=8)
    target = ttrain.cast_params(glide_models["tp"], torch.bfloat16)
    history = []
    gp, loss = ttrain.train_glide(target, TCFG, data, steps=30, batch=4,
                                  lr=3e-3, device="cpu", history=history)
    assert loss < 0.8 * float(history[0])
    assert set(gp) == set(glide_models["tg"])
    assert all(p.dtype == torch.float32 for p in gp.values())
    assert not any(t.requires_grad for t in ttrain.leaves_of(target))
