"""portbench: the benchmark of magicdec_tpu_torch on NVIDIA GPUs.

One command runs one cell once (see README.md). Everything that belongs to
one configuration, traffic mix, cell or metric sits in a file of its own,
found by the name BENCHMARK.json gives it:

    configs/<config>.json    published sizes of a model, its source, cuts
    traffic/<traffic>.json   the jobs: entry point, batch, lengths, warm-up
    cells/<cell>.json        the cell's correctness limits and their readings
    metrics/<metric>.py      a metric's reader: read(run) -> value or None

The yardstick (peaks, FLOP and byte counts, the plain reference, the
comparison that decides `correct`) lives here and imports nothing of JAX or
of the JAX package; only run.py imports the program, magicdec_tpu_torch.
"""
