"""ar_decode_tok_s: decode_tok_s (metrics/decode_tok_s.py) in the
autoregressive decode cells, under a bound of its own: their runs spread
otherwise than the SnapKV cells' (PERF.md, section 2)."""

from portbench.metrics import reader

read = reader("decode_tok_s")
