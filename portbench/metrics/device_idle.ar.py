"""device_idle.ar: metrics/device_idle.decode.py, read the same way, in the
autoregressive decode cells, where it moves ar_decode_tok_s."""

from portbench.metrics import reader

read = reader("device_idle.decode")
