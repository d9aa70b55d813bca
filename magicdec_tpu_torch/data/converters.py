"""Synthetic token corpora (port of the numpy-only part of
magicdec_tpu/data/converters.py:18-155).

The port imports nothing of the JAX package, so it keeps its own copy of
the four synthetic corpora; for a given seed each returns the JAX
package's array element for element (numpy int32 [num_seqs, seq_len]).
The HF-dataset converters need the network and are not ported.
mixed_markov_dataset is the corpus the trainer fits (train.train) and the
source of held-out prompts.
"""

from __future__ import annotations

import numpy as np


def synthetic_dataset(seq_len: int, num_seqs: int = 32, vocab_size: int = 32000,
                      seed: int = 0, bos_id: int = 1) -> np.ndarray:
    """Hermetic PG-19 stand-in: text-like token streams with Zipfian unigram
    frequencies and short-range repetition (so KV-compression drafts see
    realistic locality), split into fixed-length chunks with a forced BOS —
    the same shaping the reference applies to PG-19 books."""
    rng = np.random.default_rng(seed)
    # Zipf over the vocab, clipped into range
    total = seq_len * num_seqs
    stream = rng.zipf(1.3, size=total).astype(np.int64) % vocab_size
    # splice in short-range copies to create learnable/attendable structure
    n_copies = total // 64
    src = rng.integers(0, total - 128, n_copies)
    dst = np.minimum(src + rng.integers(16, 96, n_copies), total - 32)
    for s, d in zip(src, dst):
        stream[d:d + 16] = stream[s:s + 16]
    out = stream[: num_seqs * seq_len].reshape(num_seqs, seq_len)
    out[:, 0] = bos_id
    return out.astype(np.int32)


def motif_dataset(seq_len: int, num_seqs: int, vocab_size: int = 4096,
                  motif_len: int = 16, n_motifs: int = 24, seed: int = 0,
                  bos_id: int = 1) -> np.ndarray:
    """Induction-task corpus: each sequence concatenates motifs drawn (with
    repetition) from a per-sequence library of random token strings.

    Continuing a motif after its first occurrence requires attending back to
    that occurrence — arbitrarily far — so a model trained on this data has
    sharp, genuinely context-dependent argmax, and KV-budget drafts show
    realistic, budget-sensitive acceptance. Fresh seeds generate fresh motifs:
    a model can only solve held-out sequences by in-context copying, not by
    memorization. Used by bench.py to manufacture REAL weights on-device
    (no checkpoints are downloadable in the benchmark environment).
    """
    rng = np.random.default_rng(seed)
    n_chunks = -(-seq_len // motif_len)
    out = np.empty((num_seqs, n_chunks * motif_len), np.int64)
    for i in range(num_seqs):
        lib = rng.integers(2, vocab_size, (n_motifs, motif_len))
        order = rng.integers(0, n_motifs, n_chunks)
        out[i] = lib[order].reshape(-1)
    out = out[:, :seq_len]
    out[:, 0] = bos_id
    return out.astype(np.int32)


def markov_dataset(seq_len: int, num_seqs: int, vocab_size: int = 4096,
                   active: int = 128, p_follow: float = 0.85, seed: int = 0,
                   bos_id: int = 1) -> np.ndarray:
    """In-context Markov (bigram-induction) corpus.

    Each sequence draws its own active alphabet (`active` tokens) and its own
    deterministic successor table T; the stream follows x_{i+1} = T[x_i] with
    probability p_follow, else jumps to a uniform active token. A model
    trained on held-out sequences can only predict by in-context induction:
    find the previous occurrence of the current token, copy its successor.
    The previous occurrence is usually a few hundred tokens back (Zipf-free
    uniform usage of `active` tokens), so prediction is mostly LOCAL — the
    locality profile that makes KV-budget drafting (MagicDec's regime) show
    realistic, budget-graded acceptance, unlike motif_dataset where every
    token needs one specific faraway key.
    """
    rng = np.random.default_rng(seed)
    out = np.empty((num_seqs, seq_len), np.int64)
    for i in range(num_seqs):
        alphabet = rng.choice(np.arange(2, vocab_size), size=active,
                              replace=False)
        succ = alphabet[rng.integers(0, active, active)]  # T[a_j] = succ[j]
        table = np.zeros(vocab_size, np.int64)
        table[alphabet] = succ
        x = np.empty(seq_len, np.int64)
        x[0] = alphabet[0]
        follow = rng.random(seq_len) < p_follow
        jumps = alphabet[rng.integers(0, active, seq_len)]
        for t in range(1, seq_len):
            x[t] = table[x[t - 1]] if follow[t] else jumps[t]
        out[i] = x
    out[:, 0] = bos_id
    return out.astype(np.int32)


def mixed_markov_dataset(seq_len: int, num_seqs: int, vocab_size: int = 4096,
                         global_active: int = 512, local_active: int = 64,
                         f_global: float = 0.75, segment_len: int = 24,
                         p_follow: float = 0.9, seed: int = 0,
                         corpus_seed: int = 1234, bos_id: int = 1
                         ) -> np.ndarray:
    """Language-model-like synthetic corpus for honest acceptance benchmarks.

    The stream alternates segments of two regimes:
      * GLOBAL (fraction f_global): a Markov table shared by the whole corpus
        (fixed by corpus_seed) — a trained model absorbs it into its weights,
        so these tokens are predictable from the last token alone and survive
        ANY KV compression (the "local/low-entropy" bulk of natural text);
      * LOCAL: a per-sequence Markov table over a per-sequence alphabet —
        predictable only by in-context retrieval of the previous occurrence
        (the long-range-dependent tail of natural text).
    Acceptance of a KV-budget draft then lands between f_global and 1,
    graded by how well the budget covers the retrieval keys — the realistic
    profile (BASELINE.md: 0.79-0.99 depending on budget/context) that neither
    pure-Zipf (degenerate) nor pure-retrieval (collapsing) corpora produce.
    """
    global_active = min(global_active, vocab_size // 2 - 2)
    local_active = min(local_active, vocab_size // 2 - 2)
    rng_c = np.random.default_rng(corpus_seed)
    g_alpha = rng_c.choice(np.arange(2, vocab_size // 2), global_active,
                           replace=False)
    g_table = np.zeros(vocab_size, np.int64)
    g_table[g_alpha] = g_alpha[rng_c.integers(0, global_active, global_active)]

    rng = np.random.default_rng(seed)
    out = np.empty((num_seqs, seq_len), np.int64)
    for i in range(num_seqs):
        l_alpha = rng.choice(np.arange(vocab_size // 2, vocab_size),
                             local_active, replace=False)
        l_table = np.zeros(vocab_size, np.int64)
        l_table[l_alpha] = l_alpha[rng.integers(0, local_active, local_active)]
        x = np.empty(seq_len, np.int64)
        mode_global = True
        x[0] = g_alpha[rng.integers(global_active)]
        seg_left = segment_len
        follow = rng.random(seq_len) < p_follow
        for t in range(1, seq_len):
            seg_left -= 1
            if seg_left == 0:
                mode_global = rng.random() < f_global
                seg_left = max(int(rng.exponential(segment_len)), 4)
                x[t] = (g_alpha[rng.integers(global_active)] if mode_global
                        else l_alpha[rng.integers(local_active)])
                continue
            table, alpha, n = ((g_table, g_alpha, global_active) if mode_global
                               else (l_table, l_alpha, local_active))
            x[t] = table[x[t - 1]] if follow[t] else alpha[rng.integers(n)]
        out[i] = x
    out[:, 0] = bos_id
    return out.astype(np.int32)
