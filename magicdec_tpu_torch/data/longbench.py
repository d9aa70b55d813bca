"""LongBench v1/v2 prompt preprocessing (instruction templates; the port's
copy of magicdec_tpu/data/longbench.py).

Counterpart of the reference's Data/preprocess_longbench.py: builds
instruction prompts from THUDM/LongBench and LongBench-v2 rows with
CoT / no-CoT / summary templates (preprocess_longbench.py:19-60,
preprocess_longbenchv2 L107, preprocess_longbenchv1 L189). Network-gated:
dataset download happens only when `datasets` is importable and online;
the template logic itself is pure and unit-testable.
"""

from __future__ import annotations

TEMPLATE_V1 = (
    "You are a helpful assistant. Read the following context and answer "
    "the question.\n\nContext:\n{context}\n\nQuestion: {input}\nAnswer:")

TEMPLATE_V2_COT = (
    "Please read the following text and answer the question below.\n\n"
    "<text>\n{context}\n</text>\n\nWhat is the correct answer to this "
    "question: {question}\nChoices:\n(A) {choice_A}\n(B) {choice_B}\n"
    "(C) {choice_C}\n(D) {choice_D}\n\nLet's think step by step:")

TEMPLATE_V2_NO_COT = (
    "Please read the following text and answer the question below.\n\n"
    "<text>\n{context}\n</text>\n\nWhat is the correct answer to this "
    "question: {question}\nChoices:\n(A) {choice_A}\n(B) {choice_B}\n"
    "(C) {choice_C}\n(D) {choice_D}\n\nFormat your response as follows: "
    '"The correct answer is (insert answer here)".')

TEMPLATE_SUMMARY = (
    "Please summarize the following text concisely.\n\n<text>\n{context}\n"
    "</text>\n\nSummary:")


def build_prompt_v1(row: dict) -> str:
    return TEMPLATE_V1.format(context=row["context"], input=row["input"])


def build_prompt_v2(row: dict, cot: bool = True) -> str:
    t = TEMPLATE_V2_COT if cot else TEMPLATE_V2_NO_COT
    return t.format(**{k: row[k] for k in
                       ("context", "question", "choice_A", "choice_B",
                        "choice_C", "choice_D")})


def build_prompt_summary(row: dict) -> str:
    return TEMPLATE_SUMMARY.format(context=row["context"])


def preprocess_longbench_v1(task: str, out_jsonl: str, limit: int = 0):
    """Download + template a LongBench v1 task into jsonl (network required)."""
    import json

    import datasets
    ds = datasets.load_dataset("THUDM/LongBench", task, split="test")
    with open(out_jsonl, "w") as f:
        for i, row in enumerate(ds):
            if limit and i >= limit:
                break
            f.write(json.dumps({"prompt": build_prompt_v1(row),
                                "answers": row.get("answers")}) + "\n")
    return out_jsonl


def preprocess_longbench_v2(out_jsonl: str, cot: bool = True, limit: int = 0):
    import json

    import datasets
    ds = datasets.load_dataset("THUDM/LongBench-v2", split="train")
    with open(out_jsonl, "w") as f:
        for i, row in enumerate(ds):
            if limit and i >= limit:
                break
            f.write(json.dumps({"prompt": build_prompt_v2(row, cot),
                                "answer": row.get("answer")}) + "\n")
    return out_jsonl


def preprocess_longbench_v2_summary(out_jsonl: str, limit: int = 0):
    """Summarization-template variant (reference preprocess_longbench.py's
    *_sum jsonl, consumed by data_converter.py:149-170)."""
    import json

    import datasets
    ds = datasets.load_dataset("THUDM/LongBench-v2", split="train")
    with open(out_jsonl, "w") as f:
        for i, row in enumerate(ds):
            if limit and i >= limit:
                break
            f.write(json.dumps({"prompt": build_prompt_summary(row)}) + "\n")
    return out_jsonl
