#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (magicdec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers (all must pass, or the script
exits non-zero):
  1. build      nvcc builds every kernel of csrc/ (one process per source)
  2. decode     flash_decode_stacked vs its plain version at llama-3.2-1b
                heads (Hq=32, Hkv=8, D=64), B=8, S=4224, ragged lengths,
                T in {1, 7}, bf16 and f32, flat and peaked softmax; then
                bit-exact row independence (T=1 rows vs the same rows in T=7)
                and capacity independence (caches of S=1088, 1152 (the
                main path's draft cache) and 4224 holding the same prefix)
  3. prefill    flash_prefill vs its plain version, T=128 chunks at several
                s_cap buckets, bf16 and f32, flat and peaked softmax.
                Both phases hold each output against the plain version in f32
                with the per-element limit of fd.plain_f32_and_limit, and
                check that the limit rejects an output that misses each long
                row's last 64-slot tile.
  4. reference  a small f32 model: logits of the card's path (kernels, cuBLAS)
                vs the CPU plain path
  5. gemm rows  each row-wise product of a decode step at llama-3.2-1b
                widths: do M=B rows get the bits of the same rows inside
                M=B*(gamma+1), unpadded and padded to 64 rows, and the ms of
                each (the padding's cost)
  6. main path  llama-3.2-1b at full width (random bf16 weights from a seeded
                torch.Generator), B=8, P=4096, 64 new tokens, gamma=6:
                generate_autoregressive, generate_selfspec (SnapKV, budget
                1024), generate_selfspec at full budget (budget = P). Both
                speculative streams must equal the AR stream, full budget
                must accept exactly 1.0, and the kernels' launch counts must
                be those the path implies.
  7. times      each kernel at the main path's shapes: kernel, plain version,
                bound (bytes / 3.35 TB/s vs FLOPs / 989 TFLOP/s bf16) and
                scaled_dot_product_attention as a yardstick (the port never
                calls it)
  8. profile    device-busy share of AR decode steps (torch.profiler)
Then the card's name and power limit (nvidia-smi), one JSON line of the
kernels, and the last line {"ok": true, "device": {...}}.

Exits non-zero without printing a result when no GPU is available or when
the repository's package is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

B, P, NEW, GAMMA, BUDGET, WINDOW = 8, 4096, 64, 6, 1024, 32
MAX_LEN = P + NEW + 2 * GAMMA + 16          # Engine rounds this up to 4224
# query scales of the kernel checks: logits of std 0.5 (a flat softmax over
# thousands of slots, outputs ~0.02) and of std 3 (a peaked one, outputs ~1)
Q_SCALES = {"flat": 1.0, "peaked": 6.0}
# rows longer than this lose their last 64-slot tile in the planted fault
FAULT_MIN_LEN = 1024


def line(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "magicdec_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(magicdec_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from magicdec_tpu_torch.ops import _build
    line(phase="build", seconds=_build.build(), sources=list(_build.SOURCES))

    decode = check_decode(torch, dev)
    prefill = check_prefill(torch, dev)
    check_reference(torch, dev)
    gemm_rows(torch, dev)
    launches = main_path(torch, dev)
    kernels = time_kernels(torch, dev, decode, prefill, launches)
    step_profile(torch, dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phases 2-3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cache_inputs(torch, dev, dtype, S, T, seed, q_scale=1.0, L=2, Hkv=8,
                  G=4, D=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((L, B, S, Hkv * D), generator=g, device=dev) * 0.5
    v = torch.randn((L, B, S, Hkv * D), generator=g, device=dev)
    q = torch.randn((B, T, Hkv * G, D), generator=g, device=dev) * q_scale
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _hold(torch, fd, out, q, k, v, layer, valid, s_cap=None):
    """out against the plain version in f32: (max abs err, max err / limit,
    within the limit everywhere)."""
    ref, limit = fd.plain_f32_and_limit(q, k, v, layer, valid, s_cap)
    diff = (out.float() - ref).abs()
    return (float(diff.max()), float((diff / limit).max()),
            bool((diff <= limit).all()))


def _fault_rejected(torch, fd, q, k, v, layer, valid, s_cap=None) -> bool:
    """Whether the check rejects the output of a faulty kernel that skips
    the last (diagonal) 64-slot tile of every row longer than
    FAULT_MIN_LEN: the plain version over the slots below that tile,
    rounded to the cache dtype."""
    cut = torch.where(valid > FAULT_MIN_LEN, (valid - 1) // 64 * 64, valid)
    faulty = fd.attention_plain(q.float(), k.float(), v.float(), layer,
                                cut.to(torch.int32), s_cap).to(k.dtype)
    return not _hold(torch, fd, faulty, q, k, v, layer, valid, s_cap)[2]


def _check_case(torch, fd, what, out, q, k, v, layer, valid, s_cap, scale,
                errs, ratios, faults):
    """Hold one kernel output against its plain version; for bf16 with rows
    longer than FAULT_MIN_LEN also check that the limit catches a missed
    tile (it must on peaked inputs, where outputs are O(1); on flat ones it
    is reported)."""
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite output")
    errs[what], ratios[what], ok = _hold(torch, fd, out, q, k, v, layer,
                                         valid, s_cap)
    if not ok:
        fail(f"{what}: max abs err {errs[what]} exceeds the limit "
             f"({ratios[what]} times it)")
    if k.dtype == torch.bfloat16 and bool((valid > FAULT_MIN_LEN).any()):
        faults[what] = _fault_rejected(torch, fd, q, k, v, layer, valid, s_cap)
        if scale == "peaked" and not faults[what]:
            fail(f"{what}: the limit does not reject a missed diagonal tile")


def check_decode(torch, dev):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    S = 4224
    lens = torch.tensor([4100, 4160, 3, 511, 512, 2049, 4096, 1000],
                        dtype=torch.int32, device=dev)
    errs, ratios, faults = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for T in (1, 7):
            for scale, qs in Q_SCALES.items():
                q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=T,
                                        q_scale=qs)
                valid = decode_valid_upto(lens, T)
                for layer in (0, 1):
                    out = fd.flash_decode_stacked(q, k, v, layer, valid)
                    _check_case(torch, fd, f"{name}_T{T}_{scale}_l{layer}", out,
                                q, k, v, layer, valid, None, scale, errs,
                                ratios, faults)
        # bit-exact: rows and capacity
        q, k, v = _cache_inputs(torch, dev, dtype, S, 7, seed=11)
        small_lens = torch.tensor([1000, 1081, 0, 511, 512, 7, 1024, 64],
                                  dtype=torch.int32, device=dev)
        for lens_case in (lens.clamp(max=S - 7), small_lens):
            valid = decode_valid_upto(lens_case, 7)
            full = fd.flash_decode_stacked(q, k, v, 1, valid)
            for t in range(7):
                one = fd.flash_decode_stacked(q[:, t:t + 1].contiguous(), k, v,
                                              1, valid[:, t:t + 1].contiguous())
                if not torch.equal(one, full[:, t:t + 1]):
                    fail(f"decode {name}: T=1 row {t} differs from the T=7 row")
        valid = decode_valid_upto(small_lens, 7)
        big = fd.flash_decode_stacked(q, k, v, 1, valid)
        # BUDGET + 64, and the main path's draft capacity BUDGET + S - P
        for cap in (1088, BUDGET + S - P):
            small = fd.flash_decode_stacked(q, k[:, :, :cap].contiguous(),
                                            v[:, :, :cap].contiguous(), 1,
                                            valid)
            if not torch.equal(big, small):
                fail(f"decode {name}: capacity {cap} and {S} give different "
                     f"bits")
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="decode_vs_plain", max_abs_err=errs, max_err_over_limit=ratios,
         missed_tile_rejected=faults, rows_bitexact=True,
         capacity_bitexact=True)
    return main_err


def check_prefill(torch, dev):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    S, T = 4224, 128
    errs, ratios, faults = {}, {}, {}
    # (s_cap, per-sequence chunk starts): a first chunk, a partly filled
    # bucket (frontier 896 of 1024), ragged starts, the last chunk of P=4096
    cases = [(128, [0] * B), (1024, [768] * B),
             (2048, [1920, 1800, 0, 5, 1000, 1500, 1900, 128]),
             (4096, [P - T] * B)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for scale, qs in Q_SCALES.items():
            q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=21,
                                    q_scale=qs)
            for cap, starts in cases:
                valid = decode_valid_upto(
                    torch.tensor(starts, dtype=torch.int32, device=dev), T)
                out = fd.flash_prefill(q, k, v, 1, valid, s_cap=cap)
                _check_case(torch, fd, f"{name}_{scale}_cap{cap}", out, q, k,
                            v, 1, valid, cap, scale, errs, ratios, faults)
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="prefill_vs_plain", max_abs_err=errs,
         max_err_over_limit=ratios, missed_tile_rejected=faults)
    return main_err


# ---------------------------------------------------------------------------
# phase 4: the card's path against the CPU plain path on a small model
# ---------------------------------------------------------------------------

def check_reference(torch, dev):
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b").replace(
        n_layer=2, dim=256, n_head=4, n_kv_head=2, intermediate_size=512,
        vocab_size=1024)
    params = llama.init_params(cfg, torch.float32, scale=0.1, seed=1,
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(2))
    logits = {}
    for d in ("cpu", dev):
        p = {k: (v.to(d) if torch.is_tensor(v) else
                 {n: t.to(d) for n, t in v.items()} if isinstance(v, dict)
                 else v) for k, v in params.items()}
        shape = (cfg.n_layer, 2, 256, cfg.n_kv_head * cfg.head_dim)
        caches = (torch.zeros(shape, device=d), torch.zeros(shape, device=d))
        lens = torch.zeros(2, dtype=torch.int32, device=d)
        pre = llama.forward(p, cfg, tokens.to(d),
                            impls.target_attn(cfg, lens, 128, cap=128,
                                              uniform_start=0), caches)
        dec = llama.forward(p, cfg, tokens[:, :7].to(d),
                            impls.target_attn(cfg, lens + 128, 7), caches)
        logits[str(d)] = (pre.cpu(), dec.cpu())
    cpu, gpu = logits["cpu"], logits[str(dev)]
    errs = [float((a - b).abs().max()) for a, b in zip(cpu, gpu)]
    # f32 on both sides (TF32 off); different summation orders
    if not all(e < 1e-3 for e in errs):
        fail(f"card path vs CPU plain path: max abs logits err {errs}")
    line(phase="reference_small_f32", prefill_logits_err=errs[0],
         decode_logits_err=errs[1], tol=1e-3)


# ---------------------------------------------------------------------------
# phases 5-6: row-count numerics, the main path at llama-3.2-1b full width
# ---------------------------------------------------------------------------

def _counts(fd):
    return {"flash_decode_stacked": fd.flash_decode_stacked.launches,
            "flash_prefill": fd.flash_prefill.launches}


def gemm_rows(torch, dev, L=16):
    """Why models/llama.py pads rows to ROW_BUCKET, and what it costs: for
    each row-wise product of a decode step at llama-3.2-1b widths, whether
    the AR/draft rows (M=B) get the bits of the same rows inside a verify
    (M=B*(gamma+1)) unpadded and padded, and the ms of one product at each
    row count (16 layers of weights cycled, so they are read from HBM as in
    a step). Fails if padded rows differ: the invariants rest on them. On an
    H100 with cuBLAS of CUDA 12.8 the w_down rows differ unpadded, and the
    main path without the padding breaks invariant 1."""
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.ops.norms import rms_norm

    g = torch.Generator(device=dev).manual_seed(3)
    Mv = B * (GAMMA + 1)
    res, extra_ms = {}, 0.0
    for name, K, N in (("wqkv", 2048, 3072), ("wo", 2048, 2048),
                       ("w_gate_up", 2048, 16384), ("w_down", 8192, 2048),
                       ("unembed", 2048, 128256)):
        n_w = 1 if name == "unembed" else L
        w = (torch.randn((n_w, K, N), generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        x = torch.randn((Mv, K), generator=g, device=dev, dtype=torch.bfloat16)
        if name == "unembed":
            def mm(a, i):
                return torch.mm(a, w[i], out_dtype=torch.float32)
        else:
            def mm(a, i):
                return a @ w[i]
        pad = llama._pad_rows
        res[name] = {
            "unpadded_rows_equal": torch.equal(mm(x[:B], 0), mm(x, 0)[:B]),
            "padded_rows_equal": torch.equal(mm(pad(x[:B]), 0)[:B],
                                             mm(pad(x), 0)[:B]),
            "ms_unpadded_M8": _time_ms(torch, lambda i: mm(x[:B], i), n_w),
            "ms_unpadded_M56": _time_ms(torch, lambda i: mm(x, i), n_w),
            "ms_padded_M64": _time_ms(torch, lambda i: mm(pad(x[:B]), i), n_w)}
        per_step = 1 if name == "unembed" else L
        extra_ms += per_step * (res[name]["ms_padded_M64"]
                                - res[name]["ms_unpadded_M8"])
        del w
    x = torch.randn((Mv, 2048), generator=g, device=dev, dtype=torch.bfloat16)
    w = torch.ones(2048, device=dev, dtype=torch.bfloat16)
    res["rms_norm"] = {
        "unpadded_rows_equal": torch.equal(rms_norm(x[:B], w),
                                           rms_norm(x, w)[:B]),
        "padded_rows_equal": torch.equal(
            rms_norm(llama._pad_rows(x[:B]), w)[:B],
            rms_norm(llama._pad_rows(x), w)[:B])}
    line(phase="gemm_rows", M_ar=B, M_verify=Mv, M_padded=llama.ROW_BUCKET,
         padding_ms_per_ar_step=extra_ms, **res)
    bad = [k for k, r in res.items() if not r["padded_rows_equal"]]
    if bad:
        fail(f"padded rows differ across row counts in {bad}")


def main_path(torch, dev):
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.ops import flash_decode as fd

    cfg = ModelArgs.from_name("llama-3.2-1b")
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    chunks = P // 128
    L = cfg.n_layer

    fd.flash_decode_stacked.launches = 0
    fd.flash_prefill.launches = 0
    runs = {}

    def run(name, spec, budget):
        before = _counts(fd)
        eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN, spec=spec,
                     draft_budget=budget, window_size=WINDOW)
        t = time.perf_counter()
        if spec is None:
            out, stats = generate_autoregressive(eng, prompt, NEW)
            counts = torch.full((B,), NEW, dtype=torch.int32)
        else:
            out, counts, stats = generate_selfspec(eng, prompt, GAMMA, NEW)
        total_s = time.perf_counter() - t
        after = _counts(fd)
        del eng
        torch.cuda.empty_cache()
        used = {k: after[k] - before[k] for k in after}
        decode_expect = (L * (NEW - 1) if spec is None
                         else L * (GAMMA + 1) * stats.rounds)
        expect = {"flash_prefill": L * chunks,
                  "flash_decode_stacked": decode_expect}
        if used != expect:
            fail(f"{name}: kernel launches {used}, the path implies {expect}")
        out = out.cpu()
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"{name}: token ids out of range")
        runs[name] = dict(out=out, counts=counts.cpu(), stats=stats,
                          total_s=total_s, launches=used)

    run("ar", None, 0)
    run("snapkv", "snapkv", BUDGET)
    run("snapkv_full", "snapkv", P)
    launches = _counts(fd)

    ar = runs["ar"]["out"]
    for name in ("snapkv", "snapkv_full"):
        out, counts = runs[name]["out"], runs[name]["counts"]
        for b in range(B):
            n = min(int(counts[b]), NEW)
            if n <= 0 or not torch.equal(out[b, :n], ar[b, :n]):
                fail(f"{name}: stream of sequence {b} differs from the AR "
                     f"stream (invariant 1)")
    acc_full = runs["snapkv_full"]["stats"].acceptance_rate
    if acc_full != 1.0:
        fail(f"full-budget acceptance {acc_full} != 1.0 (invariant 2)")

    def rate(r):
        s = r["stats"]
        return s.generated_tokens / s.wall_time_s

    line(phase="main_path", model="llama-3.2-1b", dtype="bfloat16", B=B, P=P,
         new_tokens=NEW, gamma=GAMMA, budget=BUDGET, init_s=init_s,
         ar_tok_s=rate(runs["ar"]), snapkv_tok_s=rate(runs["snapkv"]),
         snapkv_full_tok_s=rate(runs["snapkv_full"]),
         snapkv_acceptance=runs["snapkv"]["stats"].acceptance_rate,
         snapkv_full_acceptance=acc_full,
         snapkv_rounds=runs["snapkv"]["stats"].rounds,
         snapkv_full_rounds=runs["snapkv_full"]["stats"].rounds,
         run_s={k: r["total_s"] for k, r in runs.items()},
         decode_s={k: r["stats"].wall_time_s for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         invariant1=True, invariant2=True)
    return launches


# ---------------------------------------------------------------------------
# phase 7: times at the main path's shapes
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, n_layers, reps=3, iters=32):
    """Mean ms per call over `iters` calls cycling through the layers (the
    caller's layers do not fit the 50 MB L2 together); best of `reps`."""
    for i in range(n_layers):
        fn(i)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i % n_layers)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _sdpa(torch, q, k_cache, v_cache, layer, valid, ext):
    """scaled_dot_product_attention on the same work (the yardstick)."""
    import torch.nn.functional as F
    Bq, T, Hq, D = q.shape
    Hkv = k_cache.shape[-1] // D
    k = k_cache[layer, :, :ext].view(Bq, ext, Hkv, D).transpose(1, 2)
    v = v_cache[layer, :, :ext].view(Bq, ext, Hkv, D).transpose(1, 2)
    slot = torch.arange(ext, device=q.device)
    mask = (slot[None, None, :] < valid[:, :, None])[:, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask, enable_gqa=True)


def time_kernels(torch, dev, decode_err, prefill_err, launches):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    L, S, Hq, Hkv, D = 16, 4224, 32, 8, 64
    item = 2                                     # bf16
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((L, B, S, Hkv * D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((L, B, S, Hkv * D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    saved = _counts(fd)
    rows = []

    def bound(bytes_, flops):
        tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    # decode: the AR step of the main path at mid-generation (T=1, every
    # sequence at P + 32 cached tokens); also the verify (T=7) and draft
    # (T=1 over the draft cache of BUDGET + S - P slots, as Engine sizes it)
    # shapes on the phase line
    shapes = {"ar": (1, P + 32, S), "verify": (7, P + 32, S),
              "draft": (1, BUDGET + 32, BUDGET + S - P)}
    extra = {}
    for name, (T, length, S_c) in shapes.items():
        q = torch.randn((B, T, Hq, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        kc = k[:, :, :S_c].contiguous() if S_c != S else k
        vc = v[:, :, :S_c].contiguous() if S_c != S else v
        valid = decode_valid_upto(
            torch.full((B,), length - T, dtype=torch.int32, device=dev), T)
        span = int(valid.max())
        bytes_ = (B * span * Hkv * D * 2 + 2 * q.numel()) * item + valid.numel() * 4
        flops = 4 * int(valid.sum()) * Hq * D
        t_k = _time_ms(torch, lambda l: fd.flash_decode_stacked(q, kc, vc, l, valid), L)
        t_p = _time_ms(torch, lambda l: fd.attention_plain(q, kc, vc, l, valid), L)
        t_l = _time_ms(torch, lambda l: _sdpa(torch, q, kc, vc, l, valid, S_c), L)
        b_ms, b_by = bound(bytes_, flops)
        extra[name] = dict(T=T, cached=length, S=S_c, ms=t_k, plain_ms=t_p,
                           library_ms=t_l, bound_ms=b_ms, bound_by=b_by)
    ar = extra["ar"]
    rows.append({"name": "flash_decode_stacked", "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_decode.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:488",
                 "launches": launches["flash_decode_stacked"],
                 "max_abs_err": decode_err, "ms": ar["ms"],
                 "plain_ms": ar["plain_ms"], "bound_ms": ar["bound_ms"],
                 "bound_by": ar["bound_by"], "library_ms": ar["library_ms"]})

    # prefill: the last 128-token chunk of P=4096 (s_cap 4096), the chunk
    # with the most work; every earlier chunk is a shorter walk
    T = 128
    q = torch.randn((B, T, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
    valid = decode_valid_upto(
        torch.full((B,), P - T, dtype=torch.int32, device=dev), T)
    span = int(valid.max())
    bytes_ = (B * span * Hkv * D * 2 + 2 * q.numel()) * item + valid.numel() * 4
    flops = 4 * int(valid.sum()) * Hq * D
    t_k = _time_ms(torch, lambda l: fd.flash_prefill(q, k, v, l, valid, s_cap=P), L)
    t_p = _time_ms(torch, lambda l: fd.attention_plain(q, k, v, l, valid, s_cap=P), L)
    t_l = _time_ms(torch, lambda l: _sdpa(torch, q, k, v, l, valid, P), L)
    b_ms, b_by = bound(bytes_, flops)
    rows.append({"name": "flash_prefill", "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_prefill.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:646",
                 "launches": launches["flash_prefill"],
                 "max_abs_err": prefill_err, "ms": t_k, "plain_ms": t_p,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l})
    # the timing launches are not the main path's
    fd.flash_decode_stacked.launches = saved["flash_decode_stacked"]
    fd.flash_prefill.launches = saved["flash_prefill"]
    line(phase="times", decode_shapes=extra,
         prefill_last_chunk=dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                 bound_ms=b_ms, bound_by=b_by))
    return rows


def step_profile(torch, dev, steps=8):
    """Device-busy share of AR decode steps at the main path's shape: the
    union of the kernel intervals torch.profiler records over the host wall
    time of `steps` steps (after prefill); the wall time per step is also
    taken without the profiler. Launch counts made here are not the main
    path's."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.ops import flash_decode as fd

    saved = _counts(fd)
    cfg = ModelArgs.from_name("llama-3.2-1b")
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN)
    tok = eng.encode(np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P)))
    for _ in range(2):
        tok = eng.inference(tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = eng.inference(tok)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = eng.inference(tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, float] = {}
    for e in kernels:
        key = e.name[:50]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    fd.flash_decode_stacked.launches = saved["flash_decode_stacked"]
    fd.flash_prefill.launches = saved["flash_prefill"]
    line(phase="step_profile", steps=steps,
         wall_ms_per_step=plain_wall_ms / steps,
         profiled_wall_ms_per_step=wall_ms / steps,
         kernels_per_step=len(kernels) / steps,
         device_busy_ms_per_step=busy_us / 1e3 / steps,
         device_busy_share=busy_us / 1e3 / wall_ms,
         top_kernel_ms_per_step={k: v / 1e3 / steps for k, v in top.items()})


if __name__ == "__main__":
    sys.exit(main())
