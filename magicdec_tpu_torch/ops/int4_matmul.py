"""x @ W for int4 weights packed as biased column-pair nibbles, with its
plain PyTorch version and a launch count.

`int4_matmul` replaces magicdec_tpu/ops/pallas/int4_matmul.py int4_matmul
(pallas_call at :131) with a hand-written CUDA C++ kernel for sm_90a
(csrc/int4_matmul.cu, built by ops/_build.py). qmatmul (quant/int8.py) runs
it for every product of an int4-quantized layer: the four weight products
of every forward, prefill chunks included.

Layout (pack_int4_cols): for a weight [K, N] quantized in groups of g rows
of K, q4 [K, N/2] int8 holds column n in the low nibble and column n + N/2
in the high nibble of byte q4[k, n], each nibble biased by +8 (the code
q + 8 in [0, 15]); scales [K/g, N] float32. Per group the product is
s_g * (x_g @ Qu_g - 8 * rowsum(x_g)), Qu the biased nibbles, summed over the
groups in float32 and returned in x's dtype.

On tensors on the CPU the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises. `launch_plan` is the bf16 kernel's cut of K
into splits, from K and N/2 alone.
"""

from __future__ import annotations

import ctypes

import torch

from magicdec_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_GROUP = 128      # K rows per scale group of the kernel's build
KERNEL_COLS = 16        # N/2 must be a multiple (the f32 kernel's CTA width)
TILE_COLS = 128         # packed columns per CTA of the bf16 kernel
TILE_ROWS = 64          # rows per CTA of the bf16 kernel
MAX_SPLITS = 8          # the splits of a tile form one thread-block cluster
PLAN_ROWS = 256         # the rows the plan is made for: the B=8 decode bucket
PLAN_CTAS = 96          # CTAs the split count aims for at PLAN_ROWS


def launch_plan(K: int, N2: int) -> tuple[tuple[int, int], ...]:
    """The K ranges [k0, k1) of the bf16 kernel's splits, in the order
    their partials are summed: whole 128-row groups, tiling K. Chosen from
    K and N/2 alone, never from the row count, so a row's bits do not
    depend on how many rows share the call. The count S is the fewest
    splits that give PLAN_CTAS CTAs at PLAN_ROWS rows, where the model's
    decode steps run: on the H100 a CTA costs a fixed ~8 us beside ~1 us a
    group, so more splits than that cost waves and partial sums at 256
    rows and more (PERF.md, PR 12); fewer rows get fewer CTAs than the
    card has SMs."""
    G = K // KERNEL_GROUP
    ctas = -(-N2 // TILE_COLS) * -(-PLAN_ROWS // TILE_ROWS)
    S = max(1, min(MAX_SPLITS, G, -(-PLAN_CTAS // ctas)))
    return tuple((KERNEL_GROUP * (i * G // S), KERNEL_GROUP * ((i + 1) * G // S))
                 for i in range(S))


def pack_int4_cols(w: torch.Tensor, group_size: int = 128):
    """Quantize [..., K, N] -> (q4 [..., K, N/2] int8 packing column pairs
    (n, n + N/2) as biased nibbles, scales [..., K/g, N] float32). Symmetric
    per group of g rows: scale = max(absmax, 1e-8) / 7, codes
    round-half-to-even of w / scale clipped to [-8, 7]."""
    wf = w.float()
    K, N = wf.shape[-2:]
    if K % group_size or N % 2:
        raise ValueError(f"K={K}, N={N}: need K a multiple of the group "
                         f"size {group_size} and N even")
    lead = wf.shape[:-2]
    grouped = wf.reshape(*lead, K // group_size, group_size, N)
    absmax = grouped.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(grouped / scale), -8, 7).to(torch.int32)
    qb = (q + 8).reshape(*lead, K, N)
    q4 = (qb[..., N // 2:] << 4) | qb[..., :N // 2]
    return (q4.to(torch.uint8).view(torch.int8),
            scale.reshape(*lead, K // group_size, N))


def unpack_int4_cols(q4: torch.Tensor) -> torch.Tensor:
    """q4 [K, N/2] int8 -> the biased codes [K, N] int32 in [0, 15]. The
    byte is read unsigned, or the high nibble would sign-extend."""
    qu = q4.to(torch.int32) & 0xFF
    return torch.cat([qu & 0xF, qu >> 4], dim=1)


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """The plain version: what the kernel computes, group by group in
    float32, returned in x's dtype. x [M, K], q4 [K, N/2], scales [K/g, N]
    -> [M, N]."""
    M, K = x.shape
    G = scales.shape[0]
    g = K // G
    qw = unpack_int4_cols(q4).float()
    xf = x.float()
    acc = torch.zeros((M, qw.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(G):
        xg = xf[:, i * g:(i + 1) * g]
        p = xg @ qw[i * g:(i + 1) * g]
        acc += (p - 8.0 * xg.sum(dim=1, keepdim=True)) * scales[i]
    return acc.to(x.dtype)


def int4_matmul_plain_f32_and_limit(x: torch.Tensor, q4: torch.Tensor,
                                    scales: torch.Tensor):
    """What a kernel output is held against: the plain version in float32
    from the same inputs, and the per-element limit on |kernel - plain|.

    Both sum exact products (bf16 or f32 x times a nibble) in float32 in
    other orders: per group g products and a row sum, then G group terms,
    each within (g + G + 4) * 2^-24 of sum_g s_g sum_k |x_k| (q_k + 8) =
    ref_abs (the plain version on |x| and q + 8); twice that for the two
    sides. bfloat16 outputs add one rounding of at most 2^-9 |out|, taken
    as 2^-8 |ref|. Returns (ref f32, limit f32), both [M, N]."""
    G = scales.shape[0]
    g = x.shape[1] // G
    ref = int4_matmul_plain(x.float(), q4, scales)
    qw = unpack_int4_cols(q4).float() + 8.0
    ref_abs = (x.float().abs().reshape(x.shape[0], G, g).transpose(0, 1)
               @ qw.reshape(G, g, -1) * scales[:, None]).sum(0)
    limit = 2.0 * (g + G + 4) * 2.0 ** -24 * ref_abs
    if x.dtype == torch.bfloat16:
        limit = limit + 2.0 ** -8 * ref.abs()
    return ref, limit + 1e-30


def _lib() -> ctypes.CDLL:
    lib = _build.load("int4_matmul")
    fn = lib.mdt_int4_matmul
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, I, I, I, I, P, P]
        fn.restype = I
    return lib


def int4_matmul(x: torch.Tensor, q4: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """x [M, K] (float32 or bfloat16) @ the packed int4 weight (q4 [K, N/2]
    int8, scales [K/128, N] float32) -> [M, N] in x's dtype.

    Replaces the TPU kernel int4_matmul (pallas_call at
    magicdec_tpu/ops/pallas/int4_matmul.py:131). Bound by the packed weight's
    bytes up to ~64 rows (0.5 byte per weight plus the scales) and by the
    tensor cores' operations from ~128 rows on (the model's padded decode
    rows, prefill chunks). bf16 x runs on wgmma: TMA loads the x and q4
    tiles, the nibbles are unpacked in registers to signed codes (the
    register operand), each CTA computes 64 rows and 256 outputs of one K
    split of `launch_plan`, and the splits' partials are summed in order in
    a thread-block cluster. f32 x runs on CUDA cores, each CTA 64 rows and
    32 outputs over all of K. Nothing is chosen from M, so a row's bits do
    not depend on how many rows share the call (csrc/int4_matmul.cu). One
    call is one launch of one kernel.
    """
    if x.device.type == "cpu" and q4.device.type == "cpu" \
            and scales.device.type == "cpu":
        return int4_matmul_plain(x, q4, scales)
    if not (x.is_cuda and q4.is_cuda and scales.is_cuda) or len(
            {x.device, q4.device, scales.device}) != 1:
        raise ValueError("int4_matmul needs every operand on one CUDA device "
                         "(or every operand on the CPU)")
    if x.dim() != 2 or q4.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)}, q4 {tuple(q4.shape)}, scales "
                         f"{tuple(scales.shape)}: need 2-D operands")
    M, K = x.shape
    N2 = q4.shape[1]
    if (q4.shape[0] != K or scales.shape[0] * KERNEL_GROUP != K
            or scales.shape[1] != 2 * N2):
        raise ValueError(f"x {tuple(x.shape)}, q4 {tuple(q4.shape)}, scales "
                         f"{tuple(scales.shape)}: need q4 [K, N/2] and scales "
                         f"[K/{KERNEL_GROUP}, N] (the kernel's group size)")
    if N2 % KERNEL_COLS:
        raise ValueError(f"N/2 = {N2}: the kernel needs a multiple of "
                         f"{KERNEL_COLS}")
    if (x.dtype not in _DTYPE_CODES or q4.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise ValueError(f"x {x.dtype}, q4 {q4.dtype}, scales {scales.dtype}: "
                         f"need x float32 or bfloat16, q4 int8, scales float32")
    for name, t in (("x", x), ("q4", q4), ("scales", scales)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((M, 2 * N2), dtype=x.dtype, device=x.device)
    plan = launch_plan(K, N2)
    bounds = (ctypes.c_int * (len(plan) + 1))(
        0, *(k1 // KERNEL_GROUP for _, k1 in plan))
    rc = _lib().mdt_int4_matmul(
        _DTYPE_CODES[x.dtype], x.data_ptr(), q4.data_ptr(), scales.data_ptr(),
        out.data_ptr(), M, K, N2, len(plan), bounds,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int4_matmul launch failed with cudaError_t {rc}")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
