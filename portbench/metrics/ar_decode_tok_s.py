"""ar_decode_tok_s: decode_tok_s (metrics/decode_tok_s.py) in the
autoregressive decode cells, whose runs spread far less than the SnapKV
cells' host-paced rounds, so it has a bound of its own."""

from portbench.metrics import reader

read = reader("decode_tok_s")
