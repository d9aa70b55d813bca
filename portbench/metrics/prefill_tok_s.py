"""prefill_tok_s: prompt tokens of the window's jobs over the sum of their
encode seconds, on the harness clock."""


def read(run):
    seconds = sum(j.encode_s for j in run.jobs)
    tokens = sum(j.batch * j.prompt_len for j in run.jobs)
    return tokens / seconds if seconds > 0 else None
