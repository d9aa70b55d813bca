"""The page gather kernel's launch geometry (ops/page_gather.py `geometry`),
on the CPU.

The wrapper computes the geometry and passes it to the CUDA kernel
(csrc/page_gather.cu): each unit (part, sequence, page) is chunks_per_unit
chunks of chunk_bytes, the last one tail_bytes, and CTA c of the grid
walks the launch's chunks c, c + grid, ... These tests check that the
chunks cover every unit's bytes exactly once, within the rules of the bulk
copies (16-byte sizes, a tail no longer than a chunk, no CTA without a
chunk), at the main path's Quest and RetroInfer shapes of both head dims
and at odd sizes. How the kernel turns a chunk index into addresses is
checked on the card only (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest

from magicdec_tpu_torch.ops import page_gather as pg

SMS = 132   # the H100's SMs
ROW = 8 * 2   # bytes of one head_dim element of 8 KV heads in bf16


# (units, unit_bytes, chunks_per_unit, grid) of the main path's gathers at
# B=8 in bf16 (7 of 33 Quest pages of 128 rows, K and V; 28 of 130
# clusters split into halves of 32 rows), and odd sizes
_CASES = {
    "quest_d64": (2 * 8 * 7, 128 * 64 * ROW, 8, SMS),
    "quest_d128": (2 * 8 * 7, 128 * 128 * ROW, 16, SMS),
    "retro_split_d64": (2 * 8 * 28, 32 * 64 * ROW, 2, SMS),
    "retro_split_d128": (2 * 8 * 28, 32 * 128 * ROW, 4, SMS),
    "page48_d64": (2 * 8 * 7, 48 * 64 * ROW, 3, SMS),     # 1.5 chunks
    "below_one_chunk": (5, 272, 1, 5),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_chunks_cover_every_unit_once(name):
    units, unit_bytes, per_unit, grid = _CASES[name]
    g = pg.geometry(units, unit_bytes, SMS)
    assert (g.chunks_per_unit, g.grid, g.stages) == (per_unit, grid,
                                                     pg.STAGES)
    assert g.chunk_bytes == min(pg.CHUNK_BYTES, unit_bytes)
    assert g.chunk_bytes % 16 == 0 and g.tail_bytes % 16 == 0
    assert 0 < g.tail_bytes <= g.chunk_bytes
    # each unit's chunks [k * chunk, k * chunk + size) tile its bytes
    sizes = [g.chunk_bytes] * (g.chunks_per_unit - 1) + [g.tail_bytes]
    assert sum(sizes) == unit_bytes
    # the CTAs' strided walks take every chunk of the launch exactly once
    total = units * g.chunks_per_unit
    taken = np.zeros(total, np.int32)
    for cta in range(g.grid):
        walk = np.arange(cta, total, g.grid)
        assert walk.size, "every CTA has a chunk"
        taken[walk] += 1
    assert (taken == 1).all()


def test_geometry_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        pg.geometry(4, 24, SMS)                        # not 16-byte rows
    with pytest.raises(ValueError):
        pg.geometry(4, 1024, SMS, chunk_bytes=1000)    # not 16-byte chunks
