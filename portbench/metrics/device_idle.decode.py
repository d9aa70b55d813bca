"""device_idle.decode: share of the traced decode part in which no device
operation ran, in %."""


def read(run):
    t = run.trace
    if t is None or t.part != "decode" or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
