"""gemm_roofline.decode: the weight products' share of their roofline over
the traced decode part, in %: each layer product and the unembedding on
token rows only, the weight read once a forward with the rows' inputs and
outputs (roofline.gemm_parts), over the device time of the GEMM kernels
whose names data/gemm_kernels.json lists."""

import json
from pathlib import Path

from portbench import roofline

PATTERNS = json.loads((Path(__file__).resolve().parents[1] / "data"
                       / "gemm_kernels.json").read_text())["name_contains"]


def is_gemm(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def read(run):
    t, pk = run.trace, roofline.peaks(run.device_name, run.chips)
    if t is None or t.part != "decode" or pk is None:
        return None
    seconds = t.kernel_seconds(is_gemm)
    if seconds <= 0:
        return None
    bound = sum(roofline.bound_s(roofline.gemm_parts(run.sizes, f), pk)
                for f in roofline.decode_forwards(t.job))
    return 100.0 * bound / seconds
