"""Plain float32 reference of the decoder the configs describe (Mistral,
Qwen2: pre-norm RMSNorm, rotary positions in HF's half-split layout,
grouped-query causal attention with an optional qkv bias, SwiGLU, an
untied or tied unembedding), computed layer by layer in plain PyTorch.

It reads the benchmark's weights (the layout of weights.py) and nothing
the program made, and runs with TF32 off so that every product is float32.
Rotary angles are computed in float64 and rounded to float32 once. Memory
stays bounded: the weights are widened to float32 one layer at a time, the
MLP runs in row blocks and attention in query blocks, so it fits beside
the benchmark's bf16 weights once the program's state is freed.

products="fp8" is the control: the same forward with both operands of
every weight product (the layer products and the unembedding) rounded to
float8 e4m3, scaled per row of the activations and per output column of
the weights (amax / 448), as an fp8 serving path would compute them.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per slice along `dim`."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, products: str) -> torch.Tensor:
    """x [M, K] @ w [K, N] in float32 (w already float32)."""
    if products == "fp8":
        return _fp8(x, 1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _rope_tables(n: int, head_dim: int, theta: float, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                       device=device) / head_dim)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [S, H, D] rotated at positions 0..S-1 (half-split layout)."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def _attention(q, k, v, group: int, score_elems: int) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: q [S, Hq, D],
    k, v [S, Hkv, D] -> [S, Hq*D], in query blocks of at most
    score_elems logits."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    kt = k.permute(1, 2, 0)                                # [Hkv, D, S]
    vt = v.permute(1, 0, 2)                                # [Hkv, S, D]
    qg = q.reshape(S, Hkv, group, D).permute(1, 2, 0, 3)   # [Hkv, G, S, D]
    block = max(64, min(S, score_elems // (Hq * S)))
    out = torch.empty(S, Hkv, group, D, dtype=q.dtype, device=q.device)
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        qb = qg[:, :, q0:q1].reshape(Hkv, group * (q1 - q0), D)
        logits = (qb @ kt[:, :, :q1]) / math.sqrt(D)       # [Hkv, G*n, q1]
        logits = logits.reshape(Hkv, group, q1 - q0, q1)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(q1, device=q.device)[None, :]
        logits.masked_fill_(kpos > qpos, float("-inf"))
        p = torch.softmax(logits, dim=-1).reshape(Hkv, group * (q1 - q0), q1)
        ctx = (p @ vt[:, :q1]).reshape(Hkv, group, q1 - q0, D)
        out[q0:q1] = ctx.permute(2, 0, 1, 3)
    return out.reshape(S, Hq * D)


@torch.no_grad()
def logits_at(weights: dict, sz, ids: torch.Tensor, positions,
              products: str = "f32", row_block: int = 4096,
              score_elems: int = 1 << 29) -> torch.Tensor:
    """Float32 logits [len(positions), V] of one sequence ids [S] at the
    given positions (the logits there predict the next token).

    weights: the benchmark's params (weights.py layout, any float dtype);
    sz: layout.Sizes. products: "f32" (the reference) or "fp8" (the
    control)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(weights, sz, ids, positions, products, row_block,
                        score_elems)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _forward(weights, sz, ids, positions, products, row_block, score_elems):
    lw = weights["layers"]
    S = ids.shape[0]
    D, Dh, G = sz.dim, sz.head_dim, sz.group
    Hq, Hkv = sz.n_head, sz.n_kv_head
    cos, sin = _rope_tables(S, Dh, sz.rope_theta, ids.device)
    x = weights["tok_embeddings"][ids.long()].float()       # [S, D]
    for l in range(sz.n_layer):
        h = _rms(x, lw["attn_norm"][l], sz.norm_eps)
        qkv = _mm(h, lw["wqkv"][l].float(), products)
        if sz.qkv_bias:
            qkv = qkv + lw["bqkv"][l].float()
        # KV-head-major columns: [q heads of KV head j | k_j | v_j] per j
        qkv = qkv.reshape(S, Hkv, G + 2, Dh)
        q = _rotate(qkv[:, :, :G].reshape(S, Hq, Dh), cos, sin)
        k = _rotate(qkv[:, :, G], cos, sin)
        v = qkv[:, :, G + 1]
        del qkv, h
        ctx = _attention(q, k, v, G, score_elems)
        del q, k, v
        x = x + _mm(ctx, lw["wo"][l].float(), products)
        del ctx
        w_gu = lw["w_gate_up"][l].float().reshape(D, 2 * sz.intermediate)
        w_d = lw["w_down"][l].float()
        for r0 in range(0, S, row_block):
            xb = x[r0:r0 + row_block]
            h = _rms(xb, lw["ffn_norm"][l], sz.norm_eps)
            gu = _mm(h, w_gu, products).reshape(-1, 2, sz.intermediate)
            act = torch.nn.functional.silu(gu[:, 0]) * gu[:, 1]
            x[r0:r0 + row_block] = xb + _mm(act, w_d, products)
        del w_gu, w_d
    pos = torch.as_tensor(list(positions), device=ids.device)
    h = _rms(x[pos], weights["norm"], sz.norm_eps)
    w_out = (weights["tok_embeddings"].t() if sz.tied else weights["output"])
    return _mm(h, w_out.float(), products)
