"""Acceptance-rate analysis: per-token alpha solver and speedup model (port
of magicdec_tpu/analysis.py; selection_fidelity in torch, the rest a copy).

Parity with the reference's find_alpha.py (bisection solve of
(1 - a^(g+1)) / (1 - a) - 1 = g * r for per-token acceptance a, given the
measured total acceptance rate r at speculation length g; find_alpha.py:4-30)
and figure.py (acceptance-vs-budget curves). Adds the standard speculative
decoding speedup model for choosing gamma.
"""

from __future__ import annotations

import torch


def expected_accepted(alpha: float, gamma: int) -> float:
    """E[# emitted tokens per round] = sum_{i=0..gamma} alpha^i
    = (1 - alpha^(gamma+1)) / (1 - alpha)   (the +bonus-token form)."""
    if alpha >= 1.0:
        return float(gamma + 1)
    return (1 - alpha ** (gamma + 1)) / (1 - alpha)


def find_alpha(gamma: int, rate: float, tol: float = 1e-6) -> float:
    """Invert rate -> alpha by bisection (reference find_alpha.py:4-30):
    total accepted drafts per round = expected_accepted(alpha) - 1 and the
    measured rate is that divided by gamma."""
    target = gamma * rate
    lo, hi = 0.0, 1.0
    while hi - lo > tol:
        mid = (lo + hi) / 2
        if expected_accepted(mid, gamma) - 1 < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def speedup_model(alpha: float, gamma: int, draft_cost_ratio: float,
                  verify_overhead: float = 1.0) -> float:
    """Expected speedup of one speculative round over autoregressive decode.

    draft_cost_ratio r = (one draft step) / (one target step); verify of
    gamma+1 tokens costs ~verify_overhead target steps (KV-bound decode makes
    this ~1 — MagicDec's central observation). Speedup =
    E[emitted] / (gamma * r + verify_overhead).
    """
    return expected_accepted(alpha, gamma) / (gamma * draft_cost_ratio
                                              + verify_overhead)


def best_gamma(alpha: float, draft_cost_ratio: float, max_gamma: int = 16
               ) -> tuple[int, float]:
    """argmax_gamma of speedup_model — the reference finds this by grid sweep
    (run_files/*.sh gamma in {2..16})."""
    best = (1, 0.0)
    for g in range(1, max_gamma + 1):
        s = speedup_model(alpha, g, draft_cost_ratio)
        if s > best[1]:
            best = (g, s)
    return best


def plot_acceptance_vs_budget(rows, out_path: str = "acceptance.png"):
    """rows: iterable of dicts with keys budget, prefix, rate (reference
    figure.py reads data.csv with the fork's Qwen2.5-14B measurements)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_prefix: dict = {}
    for r in rows:
        by_prefix.setdefault(r["prefix"], []).append((r["budget"], r["rate"]))
    fig, ax = plt.subplots(figsize=(6, 4))
    for prefix, pts in sorted(by_prefix.items()):
        pts.sort()
        ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o",
                label=f"prefix {prefix}")
    ax.set_xlabel("draft KV budget (fraction or tokens)")
    ax.set_ylabel("acceptance rate")
    ax.set_xscale("log")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    return out_path


# ---------------------------------------------------------------------------
# Selection fidelity: joint-over-heads vs per-head oracle
# ---------------------------------------------------------------------------
# Upstream Quest/RetroInfer select pages/clusters PER ATTENTION HEAD; this
# framework selects one shared set per sequence (summed-over-heads scores),
# as the JAX package does (its engine/quest.py docstring gives the reason: a
# per-head gather on a TPU needs a full-cache relayout). This quantifies the
# cost of that deviation: the fraction of each head's true softmax mass
# captured by the selected budget, joint vs a per-head oracle.


def selection_fidelity(q, k, lengths, *, page: int = 128, n_pages: int):
    """q [B, Hq, D] (rotated, the position-after-prefix query), k [B, S,
    Hkv*D] one layer's cache, lengths [B]; S a multiple of `page`. Returns
    dict of mean per-head softmax-mass recall for: JOINT page selection
    (summed-over-heads min/max-box scores, the quest rule), a per-head box
    selection (upstream Quest's rule), and a per-head TRUE-mass oracle
    (upper bound). Runs on the device of k, in float32."""
    B, Hq, D = q.shape
    S = k.shape[1]
    Hkv = k.shape[2] // D
    G = Hq // Hkv
    P = S // page
    dev = k.device
    kh = k.reshape(B, S, Hkv, D).float()
    qf = torch.as_tensor(q, device=dev).float()
    lengths = torch.as_tensor(lengths, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < lengths[:, None]  # [B, S]

    # per-page min/max key boxes (quest metadata)
    kp = kh.reshape(B, P, page, Hkv, D)
    vp = valid.reshape(B, P, page)[..., None, None]
    kmin = torch.where(vp, kp, 3e38).amin(dim=2)
    kmax = torch.where(vp, kp, -3e38).amax(dim=2)
    qg = qf.reshape(B, Hkv, G, D)
    box = torch.maximum(torch.einsum("bkgd,bpkd->bkgp", qg, kmin),
                        torch.einsum("bkgd,bpkd->bkgp", qg, kmax))
    joint_pages = torch.topk(box.sum(dim=(1, 2)), n_pages).indices  # [B, n]

    # true per-head softmax mass per page (head h = kv head h // G)
    lg = torch.einsum("bkgd,bskd->bkgs", qg, kh).reshape(B, Hq, S) * (D ** -0.5)
    lg = torch.where(valid[:, None], lg, -1e30)
    probs = torch.softmax(lg, dim=-1)                        # [B, Hq, S]
    page_mass = probs.reshape(B, Hq, P, page).sum(-1)        # [B, Hq, P]

    def recall(pages):
        if pages.ndim == 2:
            pages = pages[:, None].expand(B, Hq, n_pages)
        return torch.gather(page_mass, 2, pages).sum(-1)     # [B, Hq]

    box_h = box.reshape(B, Hq, P)
    return {
        "joint": float(recall(joint_pages).mean()),
        "perhead_box": float(recall(torch.topk(box_h, n_pages).indices).mean()),
        "perhead_true": float(recall(
            torch.topk(page_mass, n_pages).indices).mean()),
    }
