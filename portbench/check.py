"""The comparison that decides `correct`.

After the window has closed and the program's state is freed, a sample of
the window's sequences, drawn from the seed, is run through the plain
reference (reference/model.py) over its prompt and its served tokens
(teacher forcing). At every served position the reference's logits say how
far the token the program served lies below the reference's best. Two
numbers are compared: the widest such gap over the sample
(`max_logit_gap`), which a single altered token passes, and the mean gap
over every sampled position (`mean_logit_gap`), which error running
through every position raises (lower-precision products, attention that
misses keys) where a bf16 near-tie alone sets the widest. The sample takes
one sequence from each of `rows` equal slices of the batch (a fault
confined to part of the batch is met), each from a job drawn from the
seed. Every sequence of every job is also checked for having served
the tokens asked for, with ids inside the vocabulary (`short_rows`).
"""

from __future__ import annotations

import random

import torch

from portbench.reference import model as ref
from portbench.weights import derive


def sample(jobs: list, rows: int, seed: int) -> list:
    """[(job index, row)]: one row from each of `rows` slices of the batch,
    each from a job, drawn from the seed."""
    rng = random.Random(derive(seed, "sample"))
    B = jobs[0].batch
    cuts = [B * i // rows for i in range(rows + 1)]
    return [(rng.randrange(len(jobs)), rng.randrange(cuts[i], cuts[i + 1]))
            for i in range(rows)]


def served(job, row: int) -> torch.Tensor:
    """The first new_tokens tokens the program served to sequence row."""
    return job.output[row, :job.new_tokens].long()


def short_rows(jobs: list, vocab: int) -> int:
    """Sequences that served fewer tokens than asked for, or an id outside
    the vocabulary."""
    bad = 0
    for j in jobs:
        out = j.output[:, :j.new_tokens]
        counts = torch.as_tensor(j.counts)
        bad += int(((counts < j.new_tokens)
                    | ((out < 0) | (out >= vocab)).any(dim=1)).sum())
    return bad


def gaps(weights: dict, sz, prompt: torch.Tensor, tokens: torch.Tensor,
         products=("f32",), device=None) -> dict:
    """For each forward in `products` ("f32", the reference; "fp8", the
    control), the reference's gap at every served position [N]: f32 gives
    the gap of the served tokens, fp8 of the tokens the control puts
    first."""
    ids = torch.cat([prompt.long(), tokens[:-1]]).to(device)
    P, N = prompt.shape[0], tokens.shape[0]
    positions = range(P - 1, P - 1 + N)
    best = ref.logits_at(weights, sz, ids, positions)
    top = best.max(dim=-1).values
    out = {}
    for p in products:
        if p == "f32":
            pick = tokens.to(best.device)
        else:
            pick = ref.logits_at(weights, sz, ids, positions,
                                 products=p).argmax(dim=-1)
        out[p] = (top - best.gather(1, pick[:, None])[:, 0]).cpu()
    return out


def summary(per_row: list) -> dict:
    """{"max_logit_gap", "mean_logit_gap"} of the gaps [N] of each sampled
    sequence."""
    allg = torch.cat([g.float() for g in per_row])
    return {"max_logit_gap": float(allg.max()),
            "mean_logit_gap": float(allg.mean())}


def compare(jobs: list, weights: dict, sz, rows: int, seed: int,
            limits: dict, device=None) -> dict:
    """The numbers compared, each {"value", "limit"}: max_logit_gap and
    mean_logit_gap over the sample, short_rows over every sequence."""
    per_row = [gaps(weights, sz, jobs[j].prompts[r], served(jobs[j], r),
                    device=device)["f32"]
               for j, r in sample(jobs, rows, seed)]
    out = {name: {"value": value, "limit": limits[name]}
           for name, value in summary(per_row).items()}
    out["short_rows"] = {"value": short_rows(jobs, sz.vocab), "limit": 0}
    return out


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
