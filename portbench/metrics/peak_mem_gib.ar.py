"""peak_mem_gib.ar: metrics/peak_mem_gib.decode.py, read the same way, in the
autoregressive decode cells, where it moves ar_decode_tok_s."""

from portbench.metrics import reader

read = reader("peak_mem_gib.decode")
