"""flash_decode_roofline.ar: metrics/flash_decode_roofline.py, read the same way, in the
autoregressive decode cells, where it moves ar_decode_tok_s."""

from portbench.metrics import reader

read = reader("flash_decode_roofline")
