"""RULER-style synthetic long-context task generators (token-level, hermetic;
the port's copy of magicdec_tpu/data/ruler.py, numpy only: for a given seed
each generator returns the JAX package's arrays element for element).

Counterpart of the reference's vendored NVIDIA RULER suite
(Data/Ruler/synthetic/{niah,qa,variable_tracking,common_words_extraction,
freq_words_extraction}.py, reachable only through the commented-out converter
data_converter.py:172-206). The reference generates English text through HF
tokenizers; these generators emit TOKEN sequences directly with the same
task structure — they exercise exactly what
the benchmarks need (long-context retrieval under KV-budget drafting) and
need no downloads. Each generator returns (prompts [N, seq_len] int32,
answers [N, answer_len] int32).
"""

from __future__ import annotations

import numpy as np

_QUERY, _SEP, _BOS = 2, 3, 1  # reserved marker tokens


def niah(seq_len: int, num_seqs: int, vocab_size: int = 4096,
         needle_len: int = 8, seed: int = 0):
    """Needle-in-a-haystack: a (key, value) pair buried in filler; the prompt
    ends with [QUERY, key...] and the answer is the value tokens."""
    rng = np.random.default_rng(seed)
    prompts = np.empty((num_seqs, seq_len), np.int64)
    answers = np.empty((num_seqs, needle_len), np.int64)
    for i in range(num_seqs):
        hay = rng.integers(16, vocab_size, seq_len)
        key = rng.integers(16, vocab_size, needle_len)
        val = rng.integers(16, vocab_size, needle_len)
        pos = rng.integers(1, seq_len - 4 * needle_len - 4)
        hay[pos:pos + needle_len] = key
        hay[pos + needle_len] = _SEP
        hay[pos + needle_len + 1:pos + 2 * needle_len + 1] = val
        hay[-(needle_len + 1):-1] = key
        hay[-needle_len - 2] = _QUERY
        hay[-1] = _SEP
        hay[0] = _BOS
        prompts[i] = hay
        answers[i] = val
    return prompts.astype(np.int32), answers.astype(np.int32)


def variable_tracking(seq_len: int, num_seqs: int, vocab_size: int = 4096,
                      chain_len: int = 4, seed: int = 0):
    """Chains of variable assignments X1 = v, X2 = X1, ...; query the last
    variable's value."""
    rng = np.random.default_rng(seed)
    prompts = np.full((num_seqs, seq_len), 0, np.int64)
    answers = np.empty((num_seqs, 1), np.int64)
    for i in range(num_seqs):
        hay = rng.integers(16, vocab_size, seq_len)
        names = rng.choice(np.arange(16, vocab_size), chain_len + 1,
                           replace=False)
        value = rng.integers(16, vocab_size)
        positions = np.sort(rng.choice(
            np.arange(1, seq_len - 8), chain_len, replace=False))
        for j, p in enumerate(positions):
            hay[p] = names[j + 1]
            hay[p + 1] = _SEP
            hay[p + 2] = names[j] if j > 0 else value
        hay[-3] = _QUERY
        hay[-2] = names[chain_len]
        hay[-1] = _SEP
        hay[0] = _BOS
        prompts[i] = hay
        answers[i] = value
    return prompts.astype(np.int32), answers.astype(np.int32)


def freq_words_extraction(seq_len: int, num_seqs: int, vocab_size: int = 4096,
                          top_n: int = 3, seed: int = 0):
    """The prompt is filler with `top_n` tokens planted at elevated
    frequencies; the answer lists them in frequency order."""
    rng = np.random.default_rng(seed)
    prompts = np.empty((num_seqs, seq_len), np.int64)
    answers = np.empty((num_seqs, top_n), np.int64)
    for i in range(num_seqs):
        hay = rng.integers(16, vocab_size, seq_len)
        special = rng.choice(np.arange(16, vocab_size), top_n, replace=False)
        for rank, tok in enumerate(special):
            n = seq_len // 20 * (top_n - rank + 1)
            hay[rng.choice(np.arange(1, seq_len - 2), n)] = tok
        hay[-2] = _QUERY
        hay[-1] = _SEP
        hay[0] = _BOS
        prompts[i] = hay
        answers[i] = special
    return prompts.astype(np.int32), answers.astype(np.int32)


def qa(seq_len: int, num_seqs: int, vocab_size: int = 4096,
       num_docs: int = 8, answer_len: int = 4, seed: int = 0):
    """Multi-document QA (reference Data/Ruler/synthetic/qa.py): the context
    is `num_docs` documents, each carrying its own (key, value) fact; the
    query names ONE document's key and the answer is that document's value —
    retrieval among distractor facts, the squad/hotpotqa structure at token
    level."""
    rng = np.random.default_rng(seed)
    prompts = np.empty((num_seqs, seq_len), np.int64)
    answers = np.empty((num_seqs, answer_len), np.int64)
    doc_len = (seq_len - answer_len - 4) // num_docs
    for i in range(num_seqs):
        hay = rng.integers(16, vocab_size, seq_len)
        keys = rng.choice(np.arange(16, vocab_size), (num_docs, answer_len),
                          replace=False).reshape(num_docs, answer_len)
        vals = rng.integers(16, vocab_size, (num_docs, answer_len))
        for d in range(num_docs):
            p = 1 + d * doc_len          # fact at each document's head
            hay[p] = _SEP
            hay[p + 1:p + 1 + answer_len] = keys[d]
            hay[p + 1 + answer_len] = _SEP
            hay[p + 2 + answer_len:p + 2 + 2 * answer_len] = vals[d]
        target = rng.integers(0, num_docs)
        hay[-(answer_len + 2)] = _QUERY
        hay[-(answer_len + 1):-1] = keys[target]
        hay[-1] = _SEP
        hay[0] = _BOS
        prompts[i] = hay
        answers[i] = vals[target]
    return prompts.astype(np.int32), answers.astype(np.int32)


def common_words_extraction(seq_len: int, num_seqs: int,
                            vocab_size: int = 4096, num_cw: int = 10,
                            freq_cw: int = 30, freq_ucw: int = 3,
                            seed: int = 0):
    """Common-words extraction (reference common_words_extraction.py:
    -freq_cw 30 --freq_ucw 3 --num_cw 10): the context is a shuffled list in
    which `num_cw` words appear freq_cw times each and the rest freq_ucw
    times; the answer is the common words (canonical sorted order — the
    reference lists them in sample order, equivalent up to permutation)."""
    rng = np.random.default_rng(seed)
    prompts = np.empty((num_seqs, seq_len), np.int64)
    answers = np.empty((num_seqs, num_cw), np.int64)
    body = seq_len - 3
    num_ucw = max((body - num_cw * freq_cw) // freq_ucw, 1)
    # long contexts would ask for more distinct uncommon words than the
    # vocab holds (seq_len ~12.5k+ at the 4096 default); cap at the vocab
    # and let np.resize tile the shuffled list — tiling preserves the
    # freq_cw:freq_ucw ratio, so the common words stay dominant
    num_ucw = min(num_ucw, vocab_size - 16 - num_cw)
    for i in range(num_seqs):
        words = rng.choice(np.arange(16, vocab_size), num_cw + num_ucw,
                           replace=False)
        common, uncommon = words[:num_cw], words[num_cw:]
        wlist = np.concatenate([np.repeat(common, freq_cw),
                                np.repeat(uncommon, freq_ucw)])
        rng.shuffle(wlist)
        hay = np.empty(seq_len, np.int64)
        hay[0] = _BOS
        fill = np.resize(wlist, body)
        hay[1:1 + body] = fill
        hay[-2] = _QUERY
        hay[-1] = _SEP
        prompts[i] = hay
        answers[i] = np.sort(common)
    return prompts.astype(np.int32), answers.astype(np.int32)


TASKS = {"niah": niah, "variable_tracking": variable_tracking,
         "freq_words_extraction": freq_words_extraction, "qa": qa,
         "common_words_extraction": common_words_extraction}

# tasks whose answer is a SET of tokens (any order counts — the reference
# lists common/frequent words in sample order, equivalent up to permutation)
_SET_TASKS = frozenset({"freq_words_extraction", "common_words_extraction"})


def prepare(task: str, seq_len: int, num_seqs: int, **kw):
    """RULER prepare.py analog: dispatch by task name."""
    return TASKS[task](seq_len, num_seqs, **kw)


def score(task: str, generated, answers) -> float:
    """Exact-match accuracy over sequences (the reference's RULER scoring:
    string containment of the expected answer — here token-level: the first
    answer_len generated tokens must reproduce the answer, order-strict for
    retrieval tasks, as a set for the word-extraction tasks). Closes the
    quality-eval loop the losslessness invariant cannot: lossless engines
    must score IDENTICALLY to the baseline; approximate modes (GliDe tree
    verification on TPU) are quantified by their score delta.

    generated [N, >= answer_len] int tokens, answers [N, answer_len].
    Returns mean per-sequence accuracy in [0, 1].
    """
    gen = np.asarray(generated)
    ans = np.asarray(answers)
    n, alen = ans.shape
    assert gen.shape[0] == n and gen.shape[1] >= alen, (gen.shape, ans.shape)
    gen = gen[:, :alen]
    if task in _SET_TASKS:
        hits = [np.array_equal(np.sort(g), np.sort(a))
                for g, a in zip(gen, ans)]
        return float(np.mean(hits))
    return float(np.mean(np.all(gen == ans, axis=1)))
