"""Token corpora and dataset converters (port of
magicdec_tpu/data/converters.py).

The port imports nothing of the JAX package, so it keeps its own copy of
the four synthetic corpora; for a given seed each returns the JAX
package's array element for element (numpy int32 [num_seqs, seq_len]).
mixed_markov_dataset is the corpus the trainer fits (train.train) and the
source of held-out prompts.

The HF-dataset converters (PG-19, C4, wikitext, CNN/DailyMail, LongBench
v1 and v2; reference Data/data_converter.py) are the JAX package's
`datasets` and `transformers` calls behind the same gate (_require_hf):
they need the network, and PG-19 and LongBench fall back to
synthetic_dataset where they find nothing. LongBench v2 is hermetic given
a jsonl_path and a tokenizer.
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


def _chunk_token_stream(tokens: np.ndarray, seq_len: int, bos_id: int,
                        skip: int = 0, repeat: int = 1) -> np.ndarray:
    tokens = tokens[skip:]
    n = len(tokens) // seq_len
    out = tokens[: n * seq_len].reshape(n, seq_len).copy()
    out[:, 0] = bos_id
    return np.tile(out, (repeat, 1)).astype(np.int32)


def _require_hf(name: str):
    try:
        import datasets  # noqa: F401
        from transformers import AutoTokenizer  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"{name} requires the `datasets` library and network access; use "
            f"synthetic_dataset() or a pre-tokenized .npy for hermetic runs"
        ) from e


def convert_pg19_dataset(seq_len: int, tokenizer=None, num_books: int = 50,
                         skip: int = 8000, repeat: int = 20) -> np.ndarray:
    """PG-19 books -> [N, seq_len] int32 (reference data_converter.py:62-76:
    skip the first 8000 tokens of each book, x20 repeat, forced BOS)."""
    try:
        _require_hf("convert_pg19_dataset")
        import datasets
        ds = datasets.load_dataset("emozilla/pg19", split="test",
                                   streaming=True)
        tok = tokenizer or _default_tokenizer()
        chunks = []
        for i, row in enumerate(ds):
            if i >= num_books:
                break
            ids = np.asarray(tok(row["text"]).input_ids, np.int32)
            if len(ids) > skip + seq_len:
                chunks.append(_chunk_token_stream(ids, seq_len,
                                                  tok.bos_token_id, skip,
                                                  repeat))
        return np.concatenate(chunks) if chunks else synthetic_dataset(seq_len)
    except RuntimeError:
        return synthetic_dataset(seq_len)


def convert_c4_dataset(seq_len: int, tokenizer=None, num_docs: int = 2000
                       ) -> np.ndarray:
    """C4-en concatenated stream -> fixed chunks (data_converter.py:12-30)."""
    _require_hf("convert_c4_dataset")
    import datasets
    ds = datasets.load_dataset("allenai/c4", "en", split="validation",
                               streaming=True)
    tok = tokenizer or _default_tokenizer()
    ids = []
    for i, row in enumerate(ds):
        if i >= num_docs:
            break
        ids.extend(tok(row["text"]).input_ids)
    return _chunk_token_stream(np.asarray(ids, np.int32), seq_len,
                               tok.bos_token_id)


def convert_wiki_dataset(seq_len: int, tokenizer=None, num_docs: int = 2000
                         ) -> np.ndarray:
    """wikitext-103 stream -> fixed chunks (reference data_converter.py:32-45)."""
    _require_hf("convert_wiki_dataset")
    import datasets
    ds = datasets.load_dataset("wikitext", "wikitext-103-raw-v1",
                               split="test")
    tok = tokenizer or _default_tokenizer()
    ids = []
    for i, row in enumerate(ds):
        if i >= num_docs:
            break
        ids.extend(tok(row["text"]).input_ids)
    return _chunk_token_stream(np.asarray(ids, np.int32), seq_len,
                               tok.bos_token_id)


def convert_cnn_dataset(seq_len: int, tokenizer=None, num_docs: int = 2000
                        ) -> np.ndarray:
    """CNN/DailyMail articles -> fixed chunks (reference data_converter.py:47-60)."""
    _require_hf("convert_cnn_dataset")
    import datasets
    ds = datasets.load_dataset("cnn_dailymail", "3.0.0", split="test")
    tok = tokenizer or _default_tokenizer()
    ids = []
    for i, row in enumerate(ds):
        if i >= num_docs:
            break
        ids.extend(tok(row["article"]).input_ids)
    return _chunk_token_stream(np.asarray(ids, np.int32), seq_len,
                               tok.bos_token_id)


def convert_longbench_v1_dataset(task: str, seq_len: int, tokenizer=None,
                                 max_ctx: int = 128 * 1024) -> np.ndarray:
    """LongBench v1 task -> prompts truncated middle-out to seq_len, 128-token
    aligned (reference data_converter.py:78-122 + preprocess_longbench.py)."""
    _require_hf("convert_longbench_v1_dataset")
    import datasets
    ds = datasets.load_dataset("THUDM/LongBench", task, split="test")
    tok = tokenizer or _default_tokenizer()
    rows = []
    for row in ds:
        prompt = f"{row['context']}\n\n{row['input']}"
        ids = np.asarray(tok(prompt).input_ids, np.int32)[:max_ctx]
        if len(ids) >= seq_len:
            # middle-out truncation keeps the head and the tail, the
            # convention LongBench uses to preserve the question
            half = seq_len // 2
            ids = np.concatenate([ids[:half], ids[-(seq_len - half):]])
            rows.append(ids)
    if not rows:
        return synthetic_dataset(seq_len)
    out = np.stack(rows)
    out[:, 0] = tok.bos_token_id
    return out.astype(np.int32)


def convert_longbench_v2_dataset(seq_len: int, tokenizer=None,
                                 jsonl_path: str | None = None,
                                 summary: bool = False,
                                 limit: int = 50) -> np.ndarray:
    """LongBench-v2 instruction jsonl -> fixed-length token blocks.

    Reference Data/data_converter.py:124-170 (convert_longbench_v2_dataset /
    convert_longbench_v2_sum_dataset): read the preprocessed jsonl
    (data.longbench.preprocess_longbench_v2 writes it; `summary=True` for
    the summarization-template variant), tokenize each row's 'instruction',
    split into FULL seq_len chunks (remainder dropped) and force BOS at
    every chunk start. `jsonl_path` + `tokenizer` make it hermetic for
    tests; without them the jsonl is built from HF (network required)."""
    import json
    import os

    if jsonl_path is None:
        from magicdec_tpu_torch.data import longbench
        tag = "longbench_v2_sum.jsonl" if summary else "longbench_v2.jsonl"
        jsonl_path = os.path.join(os.path.dirname(__file__), tag)
        if not os.path.exists(jsonl_path):
            _require_hf("convert_longbench_v2_dataset")
            if summary:
                longbench.preprocess_longbench_v2_summary(jsonl_path,
                                                          limit=limit)
            else:
                longbench.preprocess_longbench_v2(jsonl_path, limit=limit)
    tok = tokenizer or _default_tokenizer()
    rows = [json.loads(line) for line in open(jsonl_path)][:limit]
    chunks = []
    for row in rows:
        text = row.get("instruction") or row["prompt"]
        ids = np.asarray(tok(text).input_ids, np.int64)
        n_full = len(ids) // seq_len
        for c in range(n_full):
            blk = ids[c * seq_len:(c + 1) * seq_len].copy()
            blk[0] = getattr(tok, "bos_token_id", None) or 1
            chunks.append(blk)
    if not chunks:
        return synthetic_dataset(seq_len)
    return np.stack(chunks).astype(np.int32)


def convert_longbench_v2_sum_dataset(seq_len: int, tokenizer=None,
                                     jsonl_path: str | None = None,
                                     limit: int = 50) -> np.ndarray:
    """Summarization-template variant (reference data_converter.py:149-170)."""
    return convert_longbench_v2_dataset(seq_len, tokenizer, jsonl_path,
                                        summary=True, limit=limit)


def save_tokens(path: str, tokens: np.ndarray):
    np.save(path, tokens.astype(np.int32))


def _default_tokenizer():
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained("meta-llama/Llama-3.1-8B")
