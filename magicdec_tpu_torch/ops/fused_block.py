"""The fused decode block: the weight products around a decoder layer's
attention, each with its plain PyTorch version and a launch count.

  fused_qkv:       qkv = rmsnorm(x) @ wqkv (+ bqkv)
  fused_post_attn: t = x + ctx @ wo;  out = t + swiglu(rmsnorm(t)) @ w_down

`fused_qkv` and `fused_post_attn` replace magicdec_tpu/ops/pallas/
fused_block.py fused_qkv (pallas_call at :96) and fused_post_attn
(pallas_call at :191) with hand-written CUDA C++ kernels for sm_90a
(csrc/fused_block.cu, built by ops/_build.py). models/llama.py routes every
forward of T <= 32 tokens with plain weights on the card and no
tensor-parallel mesh through them (the fused mode "auto", its default).

Rounding points, as the TPU kernels (x's dtype is bf16 on the card's main
path, f32 in the exact tests): RMSNorm normalizes in f32, rounds to x's
dtype and multiplies by the norm weight in x's dtype; each product sums in
f32 and rounds to x's dtype; the qkv bias is added in x's dtype; the
residual of the attention output is t = x + round(acc - x) with acc = x +
ctx @ wo in f32; the SwiGLU operand is round(silu(gate)) * round(up), a
product in x's dtype; the output is t + round(a @ w_down).

Every row is computed by a fixed sequence of operations that does not
depend on the number of rows in the call, so a draft row (M = B) and the
same row inside a verify (M = B * (gamma + 1)) get the same bits: the
kernels never choose a tile or a split from M (`launch_plan` and
`qkv_plan` read K and N alone; M sets only the number of 64-row tiles,
which a column block runs side by side so they share its weight in L2),
and the plain versions run at rows padded to a multiple of ROW_BUCKET
(PyTorch's CPU GEMM and row reductions pick their blocking from the
shape).

On tensors on the CPU a wrapper runs the plain version; on CUDA tensors it
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from magicdec_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROW_BUCKET = 64
KERNEL_K = 64       # every contraction length must be a multiple
KERNEL_COLS = 16    # every fused_qkv output width must be a multiple
# the bf16 products (fused_qkv's, and fused_post_attn's three passes): a
# CTA owns 64 rows and TILE_COLS output columns (gate/up: 64 gate and the
# matching 64 up columns) and walks its split of K in stages of STAGE_K
# rows; a column block's splits form one thread-block cluster of at most
# MAX_SPLITS CTAs
STAGE_K = 64
TILE_COLS = 128
MAX_SPLITS = 8
PLAN_CTAS = 128     # the most CTAs a split pass of fused_post_attn aims for
QKV_PLAN_CTAS = 192  # ... and fused_qkv's product (one 64-row tile)
PLAN_STAGES = 8     # the fewest stages a split walks
# the per-element limit of a bf16 output is loose (see
# fused_post_attn_plain_f32_and_limit); the mean |kernel - plain| over a
# call's outputs must also stay within this share of the mean |plain|
MEAN_LIMIT = 2.0 ** -8


def _pad(*tensors):
    """Pad each [M, ...] tensor to a multiple of ROW_BUCKET rows (zeros)."""
    pad = -tensors[0].shape[0] % ROW_BUCKET
    return [F.pad(t, (0, 0, 0, pad)) if pad else t for t in tensors]


def _rms(xf: torch.Tensor, weight: torch.Tensor, eps: float, dtype):
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight.to(dtype)


def _qkv_parts(x, attn_norm, wqkv, bqkv, eps):
    """(h, out) of fused_qkv at padded rows."""
    (xp,) = _pad(x)
    h = _rms(xp.float(), attn_norm, eps, x.dtype)
    out = (h.float() @ wqkv.float()).to(x.dtype)
    if bqkv is not None:
        out = out + bqkv.to(x.dtype)
    return h, out


def fused_qkv_plain(x: torch.Tensor, attn_norm: torch.Tensor,
                    wqkv: torch.Tensor, bqkv: torch.Tensor | None = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """The plain version: rmsnorm(x) @ wqkv (+ bqkv) with the TPU kernel's
    rounding points. x [M, D], wqkv [D, O] -> [M, O] in x's dtype."""
    return _qkv_parts(x, attn_norm, wqkv, bqkv, eps)[1][:x.shape[0]]


def _post_parts(x, ctx, wo, ffn_norm, w_gate_up, w_down, eps):
    """(t, a, out) of fused_post_attn at padded rows."""
    dt = x.dtype
    xp, cp = _pad(x, ctx)
    xf = xp.float()
    acc = xf + cp.float() @ wo.float()
    t = (xf + (acc - xf).to(dt).float()).to(dt)
    h = _rms(t.float(), ffn_norm, eps, dt)
    D, _, I = w_gate_up.shape
    gu = h.float() @ w_gate_up.reshape(D, 2 * I).float()
    gate, up = gu[:, :I], gu[:, I:]
    a = (torch.sigmoid(gate) * gate).to(dt) * up.to(dt)
    out = t + (a.float() @ w_down.float()).to(dt)
    return t, a, out


def fused_post_attn_plain(x: torch.Tensor, ctx: torch.Tensor,
                          wo: torch.Tensor, ffn_norm: torch.Tensor,
                          w_gate_up: torch.Tensor, w_down: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """The plain version: t = x + ctx @ wo; t + swiglu(rmsnorm(t)) @ w_down
    with the TPU kernel's rounding points. x [M, D], ctx [M, HqD], wo
    [HqD, D], w_gate_up [D, 2, I], w_down [I, D] -> [M, D] in x's dtype."""
    return _post_parts(x, ctx, wo, ffn_norm, w_gate_up, w_down,
                       eps)[2][:x.shape[0]]


def _limit(ref: torch.Tensor, ref_abs: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return 2.0 ** -14 * (ref.abs() + ref_abs) + 1e-30
    return 2.0 ** -7 * (ref.abs() + ref_abs) + 1e-30


def fused_qkv_plain_f32_and_limit(x, attn_norm, wqkv, bqkv=None, eps=1e-5):
    """What a fused_qkv output is held against: the plain version (as f32)
    and a per-element limit on |kernel - plain|, both [M, O].

    The kernel and the plain version sum in other orders (the RMSNorm mean
    over D, the product over D). float32: within 2^-14 of ref_abs = |h| @
    |wqkv| + |bqkv| (f32 sums of D terms) plus |ref|. bfloat16: where an f32
    sum lands near a rounding point the two round h, the product or the
    bias sum to neighbouring values, each at most one step (2^-7 of itself)
    apart, so |kernel - plain| <= 2^-7 (|ref| + ref_abs). That bound is
    loose where outputs cancel; MEAN_LIMIT checks the mean error too."""
    M = x.shape[0]
    h, out = _qkv_parts(x, attn_norm, wqkv, bqkv, eps)
    ref_abs = (h.float().abs() @ wqkv.float().abs())[:M]
    if bqkv is not None:
        ref_abs = ref_abs + bqkv.float().abs()
    ref = out[:M].float()
    return ref, _limit(ref, ref_abs, x.dtype)


def fused_post_attn_plain_f32_and_limit(x, ctx, wo, ffn_norm, w_gate_up,
                                        w_down, eps=1e-5):
    """fused_qkv_plain_f32_and_limit for fused_post_attn: ref_abs = |x| +
    |ctx| @ |wo| + |a| @ |w_down|, the magnitudes of every term of the
    output (a neighbouring rounding of t, of h and so of a, or of the
    output, moves it by at most 2^-7 of such a term)."""
    M = x.shape[0]
    t, a, out = _post_parts(x, ctx, wo, ffn_norm, w_gate_up, w_down, eps)
    ref_abs = (x.float().abs() + ctx.float().abs() @ wo.float().abs()
               + (a.float().abs() @ w_down.float().abs())[:M])
    ref = out[:M].float()
    return ref, _limit(ref, ref_abs, x.dtype)


def column_blocks(N: int) -> int:
    """The column blocks of a product of N output columns (for gate/up N =
    2I: block c holds gate columns 64c.. and up columns I + 64c..)."""
    return -(-N // TILE_COLS)


def _split_plan(K: int, N: int, ctas: int) -> tuple[tuple[int, int], ...]:
    """The most splits (at most MAX_SPLITS) that keep a product within
    `ctas` CTAs at one 64-row tile and give each split at least
    PLAN_STAGES stages, as K ranges of whole STAGE_K-row stages, tiling K,
    balanced."""
    stages = K // STAGE_K
    S = max(1, min(MAX_SPLITS, stages // PLAN_STAGES,
                   ctas // column_blocks(N)))
    return tuple((STAGE_K * (i * stages // S), STAGE_K * ((i + 1) * stages // S))
                 for i in range(S))


def launch_plan(K: int, N: int) -> tuple[tuple[int, int], ...]:
    """The K ranges [k0, k1) of the bf16 fused_post_attn kernel's splits
    for a product [M, K] @ [K, N], in the order their f32 partials are
    summed: whole STAGE_K-row stages, tiling K, balanced. Chosen from K and
    N alone, never from the row count, so a row's bits do not depend on how
    many rows share the call. The count is the most splits (at most
    MAX_SPLITS) that keep a pass within PLAN_CTAS CTAs at one 64-row tile
    and give each split at least PLAN_STAGES stages (on the H100 a CTA
    costs a few microseconds beside its stages). Whole calls ran fastest
    at 128 to 256, though a wo or w_down pass alone ran fastest at about
    64 CTAs (chip_smoke `fused_split_sweep`, PERF.md). llama-3.2-1b:
    wo 4 splits (64 CTAs), w_down 8 (128); llama-3.1-8b: wo and w_down 4
    (128); the gate/up products (128 and 224 column blocks) none."""
    return _split_plan(K, N, PLAN_CTAS)


def qkv_plan(K: int, N: int) -> tuple[tuple[int, int], ...]:
    """launch_plan for fused_qkv's product [M, K] @ [K, N], aimed at
    QKV_PLAN_CTAS: from K and N alone. llama-3.2-1b (K=2048, N=3072): 4
    splits x 24 column blocks; llama-3.1-8b (4096, 6144): 4 x 48. The QKV
    product is one pass with nothing after it in the call, so it takes
    more CTAs than a fused_post_attn pass (chip_smoke `fused_split_sweep`,
    PERF.md)."""
    return _split_plan(K, N, QKV_PLAN_CTAS)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    if lib.mdt_fused_qkv.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mdt_fused_qkv.argtypes = [I, P, P, P, P, P, P, P, I, I, I, Fl,
                                      I, P, I, I, P]
        lib.mdt_fused_qkv.restype = I
        lib.mdt_fused_post_attn.argtypes = [I, P, P, P, P, P, P, P, P, P, P,
                                            P, I, I, I, I, Fl, P, P, I, I, P]
        lib.mdt_fused_post_attn.restype = I
        lib.mdt_graph_edges.argtypes = [P, P, P]
        lib.mdt_graph_edges.restype = I
    return lib


def _check(what: str, x: torch.Tensor, *operands):
    """Validate the kernels' operands: one CUDA device, x's dtype, and
    contiguous, 16-byte aligned storage."""
    ops = [t for t in operands if t is not None]
    if not all(t.is_cuda for t in (x, *ops)) or len(
            {t.device for t in (x, *ops)}) != 1:
        raise ValueError(f"{what} needs every operand on one CUDA device "
                         f"(or every operand on the CPU)")
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype for t in ops):
        raise ValueError(f"{what}: x {x.dtype} and the weights "
                         f"{[t.dtype for t in ops]} must share float32 or "
                         f"bfloat16")
    for t in (x, *ops):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and "
                             f"16-byte aligned")


def _check_widths(what: str, **widths):
    for name, (n, quantum) in widths.items():
        if n % quantum:
            raise ValueError(f"{what}: {name}={n} must be a multiple of "
                             f"{quantum} (the kernel's tiles)")


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _plan_bounds(plans) -> tuple:
    """The C entries' form of K split plans: (split counts, stage bounds
    [len(plans)][MAX_SPLITS + 1], each plan's bounds from 0 to its K / 64)."""
    nsplit = (ctypes.c_int * len(plans))(*(len(p) for p in plans))
    bounds = (ctypes.c_int * (len(plans) * (MAX_SPLITS + 1)))()
    for i, plan in enumerate(plans):
        for s, (_, k1) in enumerate(plan):
            bounds[i * (MAX_SPLITS + 1) + s + 1] = k1 // STAGE_K
    return nsplit, bounds


def _qkv_launch(x, attn_norm, wqkv, bqkv=None, eps=1e-5, *, fault=0,
                passes=3, scratch=None):
    """Check the operands (CUDA tensors) and launch fused_qkv's kernels;
    returns (out, ssq). For the checks and timings of chip_smoke.py: fault=1
    leaves the last split's partial out of the product's sum (a planted
    fault the limit must reject); passes (1 the sums of squares, 2 the
    product) launches only those kernels (bf16); scratch = (out, ssq) reuses
    those tensors (ssq: x's sums of squares by 128-column block, which the
    product's RMSNorm reads). Counts no launch."""
    _check("fused_qkv", x, attn_norm, wqkv, bqkv)
    M, D = x.shape
    O = wqkv.shape[1]
    if (tuple(attn_norm.shape) != (D,) or wqkv.shape[0] != D
            or (bqkv is not None and tuple(bqkv.shape) != (O,))):
        raise ValueError(f"fused_qkv: x {tuple(x.shape)}, attn_norm "
                         f"{tuple(attn_norm.shape)}, wqkv {tuple(wqkv.shape)}")
    _check_widths("fused_qkv", D=(D, KERNEL_K), O=(O, KERNEL_COLS))
    if scratch is None:
        scratch = (torch.empty((M, O), dtype=x.dtype, device=x.device),
                   torch.empty((M, column_blocks(D)), dtype=torch.float32,
                               device=x.device))
    out, ssq = scratch
    h = torch.empty_like(x) if x.dtype == torch.float32 else None
    nsplit, bounds = _plan_bounds([qkv_plan(D, O)])
    rc = _lib().mdt_fused_qkv(
        _DTYPE_CODES[x.dtype], x.data_ptr(), attn_norm.data_ptr(),
        wqkv.data_ptr(), None if bqkv is None else bqkv.data_ptr(),
        None if h is None else h.data_ptr(), ssq.data_ptr(), out.data_ptr(),
        M, D, O, eps, nsplit[0], bounds, fault, passes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_qkv launch failed with cudaError_t {rc}")
    return scratch


def fused_qkv(x: torch.Tensor, attn_norm: torch.Tensor, wqkv: torch.Tensor,
              bqkv: torch.Tensor | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm(x) @ wqkv (+ bqkv): x [M, D], attn_norm [D], wqkv [D, O],
    bqkv [O] -> [M, O] in x's dtype.

    Replaces the TPU kernel fused_qkv (pallas_call at
    magicdec_tpu/ops/pallas/fused_block.py:96). Bound by wqkv's bytes at
    decode. A bf16 call issues two kernels (csrc/fused_block.cu): x's sums
    of squares by 128-column block, then the product on fused_post_attn's
    weight-streaming design (TMA weight boxes through a 4-stage ring,
    wgmma, K split by `qkv_plan(D, O)` over a thread-block cluster whose
    CTAs sum their partials in split order), the RMSNorm folded into each
    stage's activation box and the bias into the epilogue; the product is
    launched with programmatic dependent launch, so it fetches its first
    weight stages while the sums of squares run. f32 (the exact checks)
    keeps two CUDA-core kernels (the RMSNorm, the product). `launches`
    counts calls."""
    if _on_cpu(x, attn_norm, wqkv, bqkv):
        return fused_qkv_plain(x, attn_norm, wqkv, bqkv, eps)
    out = _qkv_launch(x, attn_norm, wqkv, bqkv, eps)[0]
    fused_qkv.launches += 1
    return out


fused_qkv.launches = 0


def _post_attn_launch(x, ctx, wo, ffn_norm, w_gate_up, w_down, eps=1e-5, *,
                      fault=0, passes=7, scratch=None):
    """Check the operands (CUDA tensors) and launch fused_post_attn's
    kernels; returns (out, t, a, ssq). For the checks and timings of
    chip_smoke.py: fault=1 leaves the last split's partial out of each split
    pass's sum (a planted fault the limit must reject); passes (1 wo, 2
    gate/up, 4 down) launches only those passes (bf16); scratch = (out, t,
    a, ssq) reuses those tensors (ssq: t's sums of squares by 128-column
    block, which the wo pass leaves for the gate/up pass's RMSNorm).
    Counts no launch."""
    _check("fused_post_attn", x, ctx, wo, ffn_norm, w_gate_up, w_down)
    M, D = x.shape
    HqD = wo.shape[0]
    I = w_down.shape[0]
    if (ctx.shape != (M, HqD) or tuple(wo.shape) != (HqD, D)
            or tuple(ffn_norm.shape) != (D,)
            or tuple(w_gate_up.shape) != (D, 2, I)
            or tuple(w_down.shape) != (I, D)):
        raise ValueError(f"fused_post_attn: x {tuple(x.shape)}, ctx "
                         f"{tuple(ctx.shape)}, wo {tuple(wo.shape)}, w_gate_up "
                         f"{tuple(w_gate_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    _check_widths("fused_post_attn", D=(D, KERNEL_K), HqD=(HqD, KERNEL_K),
                  I=(I, KERNEL_K))
    if scratch is None:
        scratch = (torch.empty_like(x), torch.empty_like(x),
                   torch.empty((M, I), dtype=x.dtype, device=x.device),
                   torch.empty((M, column_blocks(D)), dtype=torch.float32,
                               device=x.device))
    out, t, a, ssq = scratch
    h = torch.empty_like(x) if x.dtype == torch.float32 else None
    nsplit, bounds = _plan_bounds([launch_plan(K, N) for K, N in
                                   ((HqD, D), (D, 2 * I), (I, D))])
    rc = _lib().mdt_fused_post_attn(
        _DTYPE_CODES[x.dtype], x.data_ptr(), ctx.data_ptr(), wo.data_ptr(),
        ffn_norm.data_ptr(), w_gate_up.data_ptr(), w_down.data_ptr(),
        t.data_ptr(), None if h is None else h.data_ptr(), a.data_ptr(),
        ssq.data_ptr(), out.data_ptr(), M, D, HqD, I, eps, nsplit, bounds,
        fault, passes,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_post_attn launch failed with cudaError_t "
                           f"{rc}")
    return scratch


def fused_post_attn(x: torch.Tensor, ctx: torch.Tensor, wo: torch.Tensor,
                    ffn_norm: torch.Tensor, w_gate_up: torch.Tensor,
                    w_down: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """t = x + ctx @ wo; out = t + swiglu(rmsnorm(t) @ w_gate_up) @ w_down:
    x [M, D], ctx [M, HqD], wo [HqD, D], ffn_norm [D], w_gate_up [D, 2, I],
    w_down [I, D] -> [M, D] in x's dtype.

    Replaces the TPU kernel fused_post_attn (pallas_call at
    magicdec_tpu/ops/pallas/fused_block.py:191). Bound by the bytes of wo,
    w_gate_up and w_down at decode. The TPU kernel carries t, h and the
    accumulator across a sequential grid; Hopper's CTAs run in no order, so
    a bf16 call issues three kernels of one weight-streaming design
    (csrc/fused_block.cu): t (the wo product with the residual; its
    epilogue also leaves t's sums of squares by column block), a (the
    gate/up product, the RMSNorm of t folded into its operand, SwiGLU in
    the epilogue) and out (the w_down product with the residual). Each
    streams its weight by TMA through a 4-stage ring, runs on the tensor
    cores, and splits K by `launch_plan` over a thread-block cluster whose
    CTAs sum their partials in split order; programmatic dependent launch
    lets each pass fetch its first weight stages while the pass before it
    drains. f32 (the exact checks) keeps four CUDA-core kernels (wo, the
    RMSNorm, gate/up, w_down). `launches` counts calls."""
    if _on_cpu(x, ctx, wo, ffn_norm, w_gate_up, w_down):
        return fused_post_attn_plain(x, ctx, wo, ffn_norm, w_gate_up, w_down,
                                     eps)
    out = _post_attn_launch(x, ctx, wo, ffn_norm, w_gate_up, w_down, eps)[0]
    fused_post_attn.launches += 1
    return out


fused_post_attn.launches = 0


def graph_edges(graph) -> tuple[int, int]:
    """(edges, programmatic edges) of a torch.cuda.CUDAGraph captured with
    keep_graph=True: whether stream capture kept the programmatic
    dependent launches between the kernels of a fused call."""
    total, prog = ctypes.c_int(), ctypes.c_int()
    rc = _lib().mdt_graph_edges(graph.raw_cuda_graph(), ctypes.byref(total),
                                ctypes.byref(prog))
    if rc != 0:
        raise RuntimeError(f"cudaGraphGetEdges failed with cudaError_t {rc}")
    return total.value, prog.value
