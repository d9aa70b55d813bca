"""setup_s: seconds from process start to the first timed job (imports,
weights, engine and caches, the warm-up job, any kernel build)."""


def read(run):
    return run.setup_s
