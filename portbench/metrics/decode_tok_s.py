"""decode_tok_s: tokens the window's jobs delivered in their decode parts
(each sequence's asked-for tokens less the first, which encode gives),
over the sum of their decode seconds (job time less the encode span), on
the harness clock."""


def read(run):
    seconds = sum(j.decode_s for j in run.jobs)
    tokens = sum(j.delivered for j in run.jobs)
    return tokens / seconds if tokens and seconds > 0 else None
