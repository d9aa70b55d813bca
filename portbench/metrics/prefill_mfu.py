"""prefill_mfu: FLOPs the window's encode spans need (products on token
rows and causal attention, roofline.forward_cost) at the peak FLOP/s of
the cell's cards (roofline.peaks), over their seconds, in %."""

from portbench import roofline


def read(run):
    pk = roofline.peaks(run.device_name, run.chips)
    seconds = sum(j.encode_s for j in run.jobs)
    if pk is None or seconds <= 0:
        return None
    flops = sum(roofline.forward_cost(run.sizes, f)[0]
                for j in run.jobs for f in roofline.job_encode_forwards(j))
    return 100.0 * flops / pk["flops"] / seconds
