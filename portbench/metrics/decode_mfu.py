"""decode_mfu: the decode parts' share of the roofline of the cell's cards
(roofline.peaks), in %: the least time of every decode forward of the
window's jobs, each max(FLOPs / peak FLOP/s, bytes / peak bytes/s) for
the work it needs (roofline.forward_cost), over the window's decode
seconds."""

from portbench import roofline


def read(run):
    pk = roofline.peaks(run.device_name, run.chips)
    seconds = sum(j.decode_s for j in run.jobs)
    if pk is None or seconds <= 0:
        return None
    bound = sum(roofline.forward_bound_s(run.sizes, f, pk)
                for j in run.jobs for f in roofline.decode_forwards(j))
    return 100.0 * bound / seconds if bound else None
