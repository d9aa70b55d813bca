"""Causal-LM and GliDe training (port of magicdec_tpu/train.py).

There are no downloadable checkpoints, and a speculative draft's acceptance
means something only for a model with sharp, context-dependent argmax, so
the port trains its own weights on the card: `train` fits a Llama on a
synthetic corpus (data/converters.mixed_markov_dataset) from random init,
`train_glide` fits the one-layer GliDe block against the frozen target.

Training runs plain PyTorch ops (cuBLAS f32 products, the attention as two
einsums); the JAX package has no backward kernel either. Each step's
gradient comes from torch.autograd with every layer checkpointed
(llama.forward(remat=True)), and the optimizer is optax's
adamw(warmup_cosine_decay_schedule(...), weight_decay=0.01), rebuilt here
with the same arithmetic (AdamW, lr_schedule). f32 products run at full
precision for the whole run: TF32 is switched off around the loop, as the
JAX package sets default_matmul_precision("highest").
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from magicdec_tpu_torch.cache import KVCache
from magicdec_tpu_torch.checkpoint.store import flatten_params
from magicdec_tpu_torch.device import resolve_device
from magicdec_tpu_torch.engine import attention_impls as impls
from magicdec_tpu_torch.models import glide as glide_lib
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.ops.rope import apply_rope, rope_cos_sin

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_attn(config: ModelArgs):
    """Cache-free causal self-attention impl for training forwards: f32
    logits, a NEG_INF causal mask, probabilities cast to v's dtype before
    the P @ V product (the JAX package's einsums; no SDPA)."""
    def impl(q, k, v, caches, l):
        B, T, Hq, D = q.shape
        Hkv = config.n_kv_head
        G = Hq // Hkv
        cos, sin = rope_cos_sin(config, torch.arange(
            T, dtype=torch.int32, device=q.device)[None, :])
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        qg = q.reshape(B, T, Hkv, G, D)
        logits = torch.einsum("bthgd,bshd->bthgs", qg.float(),
                              k.float()) * (D ** -0.5)
        causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~causal[None, :, None, None, :], NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bthgs,bshd->bthgd", probs.to(v.dtype).float(),
                           v.float())
        return out.reshape(B, T, Hq * D).to(q.dtype)

    return impl


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of logits [B, T, V] at targets [B, T]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None]).mean()


def lm_loss(params, config: ModelArgs, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens [B, T], every layer
    checkpointed (remat), as the JAX package's lm_loss."""
    logits = llama.forward(params, config, tokens[:, :-1], causal_attn(config),
                           (), fused=False, remat=True)
    return _nll(logits, tokens[:, 1:])


def lr_schedule(lr: float, steps: int):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, steps, lr * 0.05)
    with warmup = min(max(steps // 20, 10), max(steps // 2, 1)), as a
    function of the update count (0 at the first update)."""
    warmup = min(max(steps // 20, 10), max(steps // 2, 1))
    decay, alpha = steps - warmup, 0.05

    def schedule(count: int) -> float:
        if count < warmup:                  # optax's linear_schedule
            return -lr * (1 - count / warmup) + lr
        c = min(count - warmup, decay)      # optax's cosine_decay_schedule
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay) over a list of
    tensors, which update() changes in place.

    As optax: the schedule is read at the update count before it
    increments, so the first update has the rate schedule(0) (0 for
    lr_schedule) yet fills m and v; the moments are bias-corrected from
    count 1; eps sits outside the square root (no eps_root); the decay
    lr_t * weight_decay * p is decoupled and applies to every tensor given
    (optax's mask None: norms, stacked layer weights and a tied embedding
    alike)."""

    def __init__(self, schedule, weight_decay: float = 0.01, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.weight_decay = schedule, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: list[torch.Tensor]) -> dict:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return {"count": 0, "mu": zeros,
                "nu": [torch.zeros_like(z) for z in zeros]}

    def bias_corrections(self, count: int) -> tuple[float, float]:
        """The moments' divisors after `count` updates (count >= 1)."""
        return 1 - self.b1 ** count, 1 - self.b2 ** count

    @torch.no_grad()
    def update(self, grads, state: dict, leaves: list[torch.Tensor]) -> dict:
        count, mu, nu = state["count"], state["mu"], state["nu"]
        grads = [g.float() for g in grads]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1 - self.b2)
        c1, c2 = self.bias_corrections(count + 1)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, [p.float() for p in leaves],
                            alpha=self.weight_decay)
        lr = self.schedule(count)
        for p, u in zip(leaves, upd):
            p.add_(u.to(p.dtype), alpha=-lr)
        return {"count": count + 1, "mu": mu, "nu": nu}


def make_optimizer(lr: float, steps: int) -> AdamW:
    """The optimizer of train and train_glide: optax's
    adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps, lr * 0.05),
    weight_decay=0.01)."""
    return AdamW(lr_schedule(lr, steps), weight_decay=0.01)


def leaves_of(params) -> list[torch.Tensor]:
    """The tensors of a params tree in the checkpoint's key order (None
    leaves skipped): what the optimizer updates."""
    return list(flatten_params(params).values())


def _make_step(loss_fn, optimizer):
    """(params, opt_state, tokens) -> (params, opt_state, loss) for a
    loss_fn(params, tokens): the loss and its gradient at the params as
    given, then one optimizer update of the params in place."""
    def step(params, opt_state, tokens):
        leaves = leaves_of(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        opt_state = optimizer.update(grads, opt_state, leaves)
        return params, opt_state, loss.detach()

    return step


def make_train_step(config: ModelArgs, optimizer):
    """(params, opt_state, tokens) -> (params, opt_state, loss) of lm_loss;
    the params are updated in place (opt_state = optimizer.init(
    leaves_of(params)))."""
    return _make_step(lambda p, tokens: lm_loss(p, config, tokens), optimizer)


@contextlib.contextmanager
def highest_precision():
    """f32 products at full precision inside (TF32 off), the previous
    settings restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _fit(params, step_fn, optimizer, data, *, steps, batch, seed, log_every,
         history, device, what):
    """The training loop of train and train_glide: batch rows of data drawn
    from a torch.Generator seeded seed + 1 (all steps' rows at once, so the
    loop never waits on the host), `steps` updates of params in place.
    history (a list) receives each step's loss as a 0-d tensor on the
    device. Returns the last step's loss."""
    leaves = leaves_of(params)
    opt_state = optimizer.init(leaves)
    data = torch.as_tensor(np.asarray(data), dtype=torch.int32).to(device)
    gen = torch.Generator().manual_seed(seed + 1)
    rows = torch.randint(0, data.shape[0], (steps, batch),
                         generator=gen).to(device)
    loss = torch.tensor(math.inf)
    with highest_precision():
        for step in range(steps):
            params, opt_state, loss = step_fn(params, opt_state,
                                              data[rows[step]])
            if history is not None:
                history.append(loss)
            if log_every and step % log_every == 0:
                print(f"{what}step {step}: loss {float(loss):.4f}", flush=True)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss)


def train(config: ModelArgs, data, *, steps: int = 400, batch: int = 16,
          lr: float = 3e-3, seed: int = 0, dtype=torch.float32,
          log_every: int = 0, device=None, history: list | None = None):
    """Train from random init (llama.init_params(seed=seed)) on `data`
    [N, T] int; returns (params, last loss). Params train in float32 (bf16
    master weights destabilize adamw at this scale); cast them to bf16 for
    inference afterwards (cast_params). Runs on the card unless device
    says otherwise; history: see _fit."""
    device = resolve_device(device)
    params = llama.init_params(config, dtype, seed=seed, device=device)
    optimizer = make_optimizer(lr, steps)
    loss = _fit(params, make_train_step(config, optimizer), optimizer, data,
                steps=steps, batch=batch, seed=seed, log_every=log_every,
                history=history, device=device, what="")
    return params, loss


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cast_params(params, dtype):
    """The params tree with every tensor detached and cast to dtype; None
    leaves stay None."""
    return _tree_map(lambda t: t.detach().to(dtype), params)


# ---------------------------------------------------------------------------
# GliDe draft training (the target stays frozen)
# ---------------------------------------------------------------------------

def _target_last_kv(params, config: ModelArgs, tokens: torch.Tensor,
                    device=None):
    """Run the frozen target over tokens [B, T] (no gradient), returning its
    last-layer K/V [B, T, Hkv*D], rotated as the cache stores them. The
    cache is in the params' dtype; on the card the attention is
    flash_prefill over the whole sequence, one launch a layer (T*G >
    FLASH_MAX_TG)."""
    device = resolve_device(device)
    tokens = tokens.to(device)
    B, T = tokens.shape
    cache = KVCache.create(config.n_layer, B, T, config.n_kv_head,
                           config.head_dim, params["layers"]["wqkv"].dtype,
                           device)
    with torch.no_grad():
        llama.forward(params, config, tokens,
                      impls.target_attn(config, cache.lengths, T),
                      (cache.k, cache.v), last_only=True)
    return cache.k[-1], cache.v[-1]


def glide_loss(glide_params, target_params, config: ModelArgs,
               tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of the GliDe block over tokens [B, T]:
    the target's last-layer K/V of the whole sequence, then glide_forward's
    dense route over its T - 1 inputs with an own cache of T f32 slots.

    A block training in f32 against a bf16 target meets bf16 tensors where
    JAX promotes them to f32 without a cast; the port casts in glide_forward
    (the attention contexts into the wo and wo_cross products in the
    block's dtype; the dense attention reads the bf16 target K/V in f32)
    and in llama._matmul_f32 (the f32 rows against the bf16 unembedding)."""
    B, T = tokens.shape
    dev = tokens.device
    tgt_k, tgt_v = _target_last_kv(target_params, config, tokens, device=dev)
    own_k = torch.zeros((B, T, config.n_kv_head * config.head_dim),
                        dtype=torch.float32, device=dev)
    own_v = torch.zeros_like(own_k)
    pos = torch.arange(T - 1, dtype=torch.int32, device=dev)[None, :].expand(
        B, T - 1)
    logits = glide_lib.glide_forward(
        glide_params, target_params, config, tokens[:, :-1], pos, own_k,
        own_v, torch.zeros((B,), dtype=torch.int32, device=dev), tgt_k, tgt_v,
        pos + 1)
    return _nll(logits, tokens[:, 1:])


def train_glide(target_params, config: ModelArgs, data, *, steps: int = 600,
                batch: int = 8, lr: float = 1e-3, seed: int = 0,
                log_every: int = 0, device=None,
                history: list | None = None):
    """Fit the one-layer GliDe block (init_glide_params(seed=seed), f32)
    against the frozen target; only the block's tensors take gradients and
    optimizer state. Returns (glide params, last loss); history: see
    _fit."""
    device = resolve_device(device)
    target = _tree_map(torch.Tensor.detach, target_params)  # no gradient
    gp = glide_lib.init_glide_params(config, torch.float32, seed=seed,
                                     device=device)
    optimizer = make_optimizer(lr, steps)
    step_fn = _make_step(lambda p, tokens: glide_loss(p, target, config,
                                                      tokens), optimizer)
    loss = _fit(gp, step_fn, optimizer, data, steps=steps, batch=batch,
                seed=seed, log_every=log_every, history=history,
                device=device, what="glide ")
    return gp, loss
