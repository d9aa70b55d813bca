"""The chip's peaks and the work a forward needs: the yardstick of every
roofline and mfu metric.

A roofline share is the least time the chip could take for the work the
algorithm needs, max(FLOPs / peak FLOP/s, bytes / peak bytes/s), divided by
the time measured. The work is counted from shapes, for token rows only
(never the rows the program pads), with each weight read once a forward,
the K/V rows each sequence's queries attend read once, each K/V row written
once, and the logits the algorithm uses written once in float32. A job is
cut into its forwards by the program's algorithm (chunked prefill,
autoregressive steps, SnapKV rounds), so a change to the program that does
the same work faster moves the share and one that does less work does not
inflate it.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench.layout import Sizes

# Published dense peaks (NVIDIA H100 SXM data sheet; 700 W): bf16 tensor-core
# FLOP/s and HBM3 bytes/s. The port serves bf16 weights and a bf16 KV cache.
PEAKS = {"H100": {"flops": 989e12, "bytes": 3.35e12}}
ELEM = 2            # bytes of a bf16 weight or KV element
LOGIT = 4           # the logits are float32


def peaks(device_name: str, chips: int = 1):
    """The peaks of `chips` cards named device_name, or None for a card not
    in the table (its roofline metrics are then left out). A cell over a
    tensor-parallel world of several cards sets the whole model's work
    against all of them: the same share as rank 0's block of the work
    against its one card, where tp cuts the work evenly."""
    pk = next((p for k, p in PEAKS.items() if k in device_name), None)
    return None if pk is None else {k: chips * v for k, v in pk.items()}


@dataclass(frozen=True)
class Forward:
    """One forward of B sequences. Per layer: `rows` token rows; the sum
    over token rows of the keys each attends (`query_keys`); the sum over
    sequences of the keys read once (`kv_read`); K/V rows written
    (`kv_written`). `logit_rows`: rows unembedded that the algorithm uses."""
    rows: float
    logit_rows: float
    query_keys: float
    kv_read: float
    kv_written: float


def products(s: Sizes):
    """(K, N) of each layer's weight product, in the layer's order."""
    return ((s.dim, s.qkv_out), (s.n_head * s.head_dim, s.dim),
            (s.dim, 2 * s.intermediate), (s.intermediate, s.dim))


def kv_bytes_per_row(s: Sizes) -> int:
    """Bytes of one token's K and V in one layer."""
    return 2 * s.n_kv_head * s.head_dim * ELEM


# -- per-part costs: lists of (flops, bytes, count) --------------------------

def gemm_parts(s: Sizes, f: Forward):
    """The weight products of a forward: each layer product and the
    unembedding, with the weight read once and the token rows' inputs and
    outputs."""
    parts = [(2 * f.rows * k * n, ELEM * (k * n + f.rows * (k + n)), s.n_layer)
             for k, n in products(s)]
    if f.logit_rows:
        m = f.logit_rows
        parts.append((2 * m * s.dim * s.vocab,
                      ELEM * (s.dim * s.vocab + m * s.dim)
                      + LOGIT * m * s.vocab, 1))
    return parts


def attention_parts(s: Sizes, f: Forward):
    """A forward's attention, one part a layer: QK and PV over the keys
    each query attends; the K/V it reads once and q and the output once."""
    flops = 4 * s.head_dim * s.n_head * f.query_keys
    q_out = 2 * f.rows * s.n_head * s.head_dim * ELEM
    return [(flops, f.kv_read * kv_bytes_per_row(s) + q_out, s.n_layer)]


def weight_bytes(s: Sizes) -> float:
    """Every weight of the model once (norms and the qkv bias included)."""
    layer = sum(k * n for k, n in products(s)) + 2 * s.dim
    if s.qkv_bias:
        layer += s.qkv_out
    return ELEM * (s.n_layer * layer + s.dim * s.vocab + s.dim)


def forward_cost(s: Sizes, f: Forward) -> tuple[float, float]:
    """(FLOPs, bytes) the whole forward needs: the products on token rows
    and the attention; every weight once, the embedding rows, the K/V read
    and written, the logits used."""
    flops = (sum(fl * c for fl, _, c in gemm_parts(s, f))
             + sum(fl * c for fl, _, c in attention_parts(s, f)))
    nbytes = (weight_bytes(s) + f.rows * s.dim * ELEM
              + s.n_layer * (f.kv_read + f.kv_written) * kv_bytes_per_row(s)
              + f.logit_rows * s.vocab * LOGIT)
    return flops, nbytes


def bound_s(parts, pk) -> float:
    """Least seconds for (flops, bytes, count) parts at peaks pk."""
    return sum(c * max(fl / pk["flops"], b / pk["bytes"])
               for fl, b, c in parts)


def forward_bound_s(s: Sizes, f: Forward, pk) -> float:
    return bound_s([(*forward_cost(s, f), 1)], pk)


# -- a job cut into its forwards --------------------------------------------

def encode_forwards(B: int, P: int, chunk: int) -> list:
    """Chunked prefill: chunk c's queries sit at c*chunk + t and attend the
    keys up to their own position; only the last chunk's logits are used
    (the first generated token)."""
    n = P // chunk
    return [Forward(rows=B * chunk, logit_rows=B if c == n - 1 else 0,
                    query_keys=B * (chunk * c * chunk
                                    + chunk * (chunk + 1) // 2),
                    kv_read=B * (c + 1) * chunk, kv_written=B * chunk)
            for c in range(n)]


def ar_forwards(B: int, P: int, new_tokens: int) -> list:
    """Autoregressive decode: step s (1 .. new_tokens - 1) feeds one token a
    sequence at cache length P + s - 1, which attends P + s keys."""
    return [Forward(rows=B, logit_rows=B, query_keys=B * (P + s),
                    kv_read=B * (P + s), kv_written=B)
            for s in range(1, new_tokens)]


def snapkv_forwards(B: int, P: int, budget: int, gamma: int, rounds: int,
                    accepted_rows: float) -> list:
    """SnapKV self-speculation: each round drafts gamma tokens one at a
    time on the draft cache (budget slots plus what earlier rounds
    appended), then verifies gamma + 1 tokens on the target cache, writing
    both caches. accepted_rows: the sum over sequences of the tokens
    appended over all rounds (each row's count less its final bonus). The
    appended length a round starts at is interpolated linearly over the
    rounds; it shifts each round's lengths by at most the new tokens, a
    small share of P."""
    out, T = [], gamma + 1
    for r in range(rounds):
        a = accepted_rows * r / rounds          # summed over the B rows
        for i in range(gamma):
            keys = B * (budget + i + 1) + a
            out.append(Forward(rows=B, logit_rows=B, query_keys=keys,
                               kv_read=keys, kv_written=B))
        out.append(Forward(rows=B * T, logit_rows=B * T,
                           query_keys=T * (B * P + a) + B * T * (T + 1) / 2,
                           kv_read=B * (P + T) + a, kv_written=2 * B * T))
    return out


def decode_forwards(job) -> list:
    """The forwards of a job's decode part (after encode)."""
    if job.entry == "selfspec":
        accepted = sum(c - 1 for c in job.counts)
        return snapkv_forwards(job.batch, job.prompt_len, job.budget,
                               job.gamma, job.rounds, accepted)
    return ar_forwards(job.batch, job.prompt_len, job.new_tokens)


def job_encode_forwards(job) -> list:
    return encode_forwards(job.batch, job.prompt_len, job.chunk)
