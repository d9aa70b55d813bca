"""flash_decode_roofline: the decode attention kernel's share of its
roofline over the traced decode part, in %: the least time of every
decode-phase attention (the K/V each sequence's queries attend read once,
q and the output once; roofline.attention_parts) over the device time of
decode_split_mma_kernel and decode_merge_kernel."""

from portbench import roofline

KERNELS = ("decode_split_mma_kernel", "decode_merge_kernel")


def read(run):
    t, pk = run.trace, roofline.peaks(run.device_name, run.chips)
    if t is None or t.part != "decode" or pk is None:
        return None
    seconds = t.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    if seconds <= 0:
        return None
    bound = sum(roofline.bound_s(roofline.attention_parts(run.sizes, f), pk)
                for f in roofline.decode_forwards(t.job))
    return 100.0 * bound / seconds
