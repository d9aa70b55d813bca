"""peak_mem_gib.prefill: torch.cuda.max_memory_allocated() over the run up
to the window's close (weights, caches, activations), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
