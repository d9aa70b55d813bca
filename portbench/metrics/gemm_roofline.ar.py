"""gemm_roofline.ar: metrics/gemm_roofline.decode.py, read the same way, in the
autoregressive decode cells, where it moves ar_decode_tok_s."""

from portbench.metrics import reader

read = reader("gemm_roofline.decode")
