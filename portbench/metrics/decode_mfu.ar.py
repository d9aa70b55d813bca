"""decode_mfu.ar: metrics/decode_mfu.py, read the same way, in the
autoregressive decode cells, where it moves ar_decode_tok_s."""

from portbench.metrics import reader

read = reader("decode_mfu")
