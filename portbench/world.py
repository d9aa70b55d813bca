"""A cell over a tensor-parallel world of its cards.

A cell whose `chips` is above 1 runs over a world of that many ranks, one
process a card (the program's parallel/launch.run_world, nccl), each rank
with its Engine on its own tp mesh:

  - weights: each rank draws every leaf whole on its own card, exactly as
    weights.make draws it (the same shape, generator and one normal_), keeps
    its contiguous block along the program's sharding.param_axes and frees
    the whole leaf before drawing the next (rank_params); norms are whole;
  - jobs: every rank draws the same prompts and runs the same jobs (run.Jobs,
    the one generator of traffic); rank 0 decides, between jobs, whether
    another starts and tells the others (_agree);
  - clocks: job and encode spans are rank 0's, as on one card; set-up runs
    from the parent's process start to rank 0's first timed job, on
    CLOCK_MONOTONIC, which every process of the machine shares (_check_clock);
  - trace: with --trace 1 every rank profiles the traced job; rank 0's trace
    feeds the readers, and busy and window seconds are averaged over ranks;
  - memory: the fullest rank's peak, read from after the weights are drawn
    (the whole leaf a rank draws and frees is the harness's, not the
    program's);
  - the check: once the world has exited and freed its cards, the parent
    draws the whole model with weights.make on the first device and judges
    rank 0's served tokens (check.compare), and counts the sequences on which
    any rank served other tokens than rank 0 (`rank_mismatch_rows`, limit 0).

calibrate.py runs its variants through the same world (calibrate_rank): each
is planted inside every rank before that rank's engine is built.

The functions run in the ranks are module-level here, so a spawned rank
imports them by name.
"""

from __future__ import annotations

import contextlib
import gc
import signal
import sys
import time

import torch

from portbench import check, weights
from portbench.record import Run

# perf_counter's clock must be one the parent and its ranks share
CLOCK = "clock_gettime(CLOCK_MONOTONIC)"
# the product leaves the program's int8 path quantizes (quant/int8.py)
INT8_LEAVES = ("wqkv", "wo", "w_gate_up", "w_down")


def _check_clock(launched: float | None = None) -> None:
    """Raise unless perf_counter reads CLOCK_MONOTONIC (system-wide on
    Linux) and, in a rank, reads no earlier than the parent's `launched`."""
    impl = time.get_clock_info("perf_counter").implementation
    if impl != CLOCK:
        raise RuntimeError(f"perf_counter reads {impl}, not {CLOCK}: set-up "
                           f"cannot be timed across processes")
    if launched is not None and time.perf_counter() < launched:
        raise RuntimeError("a rank's clock reads before the world started: "
                           "the processes do not share perf_counter's clock")


def leaf_axes(cfg) -> dict:
    """Leaf name -> the axis tp cuts it along (None: whole), from the
    program's sharding.param_axes."""
    from magicdec_tpu_torch.parallel.sharding import param_axes
    axes = param_axes(cfg)
    return {**{k: v for k, v in axes.items() if k != "layers"},
            **axes["layers"]}


def _int8(w: torch.Tensor) -> dict:
    """The program's int8 form of one whole product leaf (quantize_params'
    {"qT": [L, prod(out), K], "s": [L, 1, *out]}), a layer at a time: the
    scales reduce over the contraction axis only, so the layers are
    independent and the result is quantize_params' bit for bit."""
    from magicdec_tpu_torch.quant.int8 import quantize_int8
    L, K = w.shape[0], w.shape[1]   # a layer's contraction axis is first
    out = w.shape[2:]
    qT = torch.empty((L, w[0].numel() // K, K), dtype=torch.int8,
                     device=w.device)
    s = torch.empty((L, 1, *out), dtype=torch.float32, device=w.device)
    for layer in range(L):
        qw = quantize_int8(w[layer], reduce_axes=(0,))
        qT[layer] = qw["q"].reshape(K, -1).t()
        s[layer] = qw["s"]
    return {"qT": qT, "s": s}


def rank_params(s, cfg, seed: int, tp: int, rank: int, device,
                dtype=torch.bfloat16, int8: bool = False) -> dict:
    """Rank `rank` of `tp`'s params for seed: every leaf drawn whole on
    device as weights.make draws it, its contiguous block along leaf_axes
    kept and the whole leaf freed before the next is drawn; norms whole.
    int8: the product leaves are kept whole in the program's int8 form
    instead, which Engine cuts (a quantized leaf is cut whole)."""
    axes = leaf_axes(cfg)
    params = {"layers": {}}
    for name, shape in weights.shapes(s).items():
        t = torch.empty(shape, dtype=dtype, device=device)
        weights.fill(t, name, seed)
        axis = axes[name]
        if int8 and name in INT8_LEAVES:
            t = _int8(t)
        elif axis is not None and tp > 1:
            n = shape[axis] // tp
            t = t.narrow(axis, rank * n, n).clone()
        leaves = params["layers"] if name in weights.LAYER_LEAVES else params
        leaves[name] = t
    params["layers"]["attn_norm"] = torch.ones((s.n_layer, s.dim), dtype=dtype,
                                               device=device)
    params["layers"]["ffn_norm"] = torch.ones_like(
        params["layers"]["attn_norm"])
    params["norm"] = torch.ones(s.dim, dtype=dtype, device=device)
    params["output"] = params.get("output")
    return params


def _agree(flag: bool, mesh) -> bool:
    """Rank 0's flag, on every rank (a broadcast, then a read on the host)."""
    import torch.distributed as dist
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.broadcast(t, src=0)
    return bool(t.item())


def _share_threads() -> None:
    """Split the host's threads among the ranks of this machine, so that no
    rank's intra-op threads wait on cores another rank holds."""
    import torch.distributed as dist
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // dist.get_world_size()))


def _rank_jobs(mesh, cell, seed: int, int8: bool = False):
    """The rank's Jobs over its blocks of seed's weights. The whole leaves
    it drew go back to the card, where the other ranks of a shared card
    can take them."""
    from portbench import run as harness
    dtype = getattr(torch, cell.config["torch_dtype"])
    params = rank_params(cell.sizes, harness.model_args(cell.config), seed,
                         mesh.tp, mesh.rank, mesh.device, dtype, int8)
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return harness.Jobs(cell, params, seed, mesh.device, mesh=mesh)


def _warm_up(jobs) -> None:
    warm = jobs.tr["warmup"]
    engine = jobs.engine(warm["prompt_len"], warm["new_tokens"])
    jobs.run(engine, "warmup", warm["prompt_len"], warm["new_tokens"])
    del engine
    gc.collect()


def _portable(rec):
    """rec with its tensors as numpy arrays: tensors sent between processes
    would go through shared memory that the exiting rank takes with it."""
    if rec is not None:
        rec.prompts = None if rec.prompts is None else rec.prompts.numpy()
        rec.output = rec.output.numpy()
    return rec


def _tensors(rec):
    if rec is not None:
        rec.prompts = (None if rec.prompts is None
                       else torch.from_numpy(rec.prompts))
        rec.output = torch.from_numpy(rec.output)
    return rec


def _planted(plant, prompt_len: int):
    return plant(prompt_len) if plant else contextlib.nullcontext()


def run_rank(mesh, cell, seed: int, seconds: float, trace: bool,
             launched: float, plant=None) -> dict:
    """One rank of a run (run.run_cell's steps over the world). plant: a
    module-level callable (prompt_len) -> context manager (calibrate.FAULTS)
    entered before the rank's weights and engine are made."""
    from portbench import run as harness
    _check_clock(launched)
    _share_threads()
    dev = mesh.device
    tr = cell.traffic
    P, N = tr["prompt_len"], tr["new_tokens"]
    marks = [("imports", time.perf_counter())]
    with _planted(plant, P):
        jobs = _rank_jobs(mesh, cell, seed)
        harness._sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        marks.append(("weights", time.perf_counter()))
        _warm_up(jobs)
        marks.append(("warm-up", time.perf_counter()))
        engine = jobs.engine(P, N)
        harness._sync(dev)
        marks.append(("engine", time.perf_counter()))
        _agree(True, mesh)                  # every rank's engine is built
        start = time.perf_counter()
        recs = []
        while True:
            recs.append(jobs.run(engine, len(recs), P, N))
            if not _agree(time.perf_counter() - start < seconds, mesh):
                break
        window_s = time.perf_counter() - start
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        t = time.perf_counter()
        traced = None
        if trace:
            part = harness._TracedPart(tr["trace"]["part"])
            rec = jobs.run(engine, "trace", P, tr["trace"]["new_tokens"], part)
            part.after_job()
            traced = part.trace
            traced.job = _portable(rec)
        trace_s = time.perf_counter() - t
        del engine, jobs
        gc.collect()
    out = {"peak": peak, "forbidden": harness.forbidden_modules(),
           "outputs": [r.output.numpy() for r in recs]}
    if trace:
        out["busy"] = (traced.busy_s, traced.window_s)
    if mesh.rank == 0:
        out.update(jobs=[_portable(r) for r in recs], trace=traced,
                   marks=marks, start=start, window_s=window_s,
                   trace_s=trace_s,
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"))
    return out


def _exit_on_term(signum, frame):
    sys.exit(128 + signum)      # unwinds run_world, which ends the ranks


def start_world(fn, devices, backend: str, args: tuple, timeout_s: float):
    """run_world(fn) over tp = len(devices) ranks. A SIGTERM to this
    process ends the ranks before it exits; a rank that raises, dies or
    outlasts timeout_s fails the call with its traceback."""
    from magicdec_tpu_torch.parallel.launch import run_world
    signal.signal(signal.SIGTERM, _exit_on_term)
    return run_world(fn, tp=len(devices), backend=backend,
                     devices=[str(d) for d in devices], args=args,
                     timeout_s=timeout_s)


def mismatch_rows(results: list) -> int:
    """Sequences, over the window's jobs, on which some rank served other
    tokens than rank 0."""
    first = results[0]["outputs"]
    bad = 0
    for r in results[1:]:
        for a, b in zip(first, r["outputs"]):
            bad += int((a != b).any(axis=1).sum()) if a.shape == b.shape \
                else a.shape[0]
    return bad


def run_cell(cell, seed: int, seconds: float, trace: bool, backend: str,
             devices: list, t0: float, timeout_s: float | None = None,
             plant=None) -> tuple:
    """(Run, checks, forbidden modules of any rank) of one run of `cell`
    over a world of len(devices) ranks. The world's timeout covers set-up,
    the window and the traced job with a margin (default seconds + 240)."""
    _check_clock()
    res = start_world(run_rank, devices, backend,
                      (cell, seed, seconds, trace, time.perf_counter(), plant),
                      seconds + 240 if timeout_s is None else timeout_s)
    r0 = res[0]
    run = Run(cell=cell, chips=cell.chips, device_name=r0["device_name"],
              jobs=[_tensors(j) for j in r0["jobs"]],
              window_s=r0["window_s"], trace_s=r0["trace_s"],
              peak_bytes=max(r["peak"] for r in res))
    run.setup_s = r0["start"] - t0
    marks = r0["marks"]
    run.setup_parts = {name: t - prev for (name, t), prev in
                       zip(marks, [t0] + [t for _, t in marks[:-1]])}
    if trace:
        run.trace = r0["trace"]
        _tensors(run.trace.job)
        run.rank_busy = [r["busy"] for r in res]
    forbidden = sorted({m for r in res for m in r["forbidden"]})

    device = torch.device(devices[0])
    dtype = getattr(torch, cell.config["torch_dtype"])
    params = weights.make(cell.sizes, seed, device, dtype)
    t = time.perf_counter()
    checks = check.compare(run.jobs, params, cell.sizes,
                           cell.traffic["check_rows"], seed, cell.limits,
                           device)
    checks["rank_mismatch_rows"] = {"value": mismatch_rows(res), "limit": 0}
    run.check_s = time.perf_counter() - t
    return run, checks, forbidden


def calibrate_rank(mesh, cell, plan: list) -> dict:
    """One rank of calibrate.py's world: plan [(seed, [variant, ...])], a
    variant "program", "int8" (the program's int8 weight-only path) or a
    name of calibrate.FAULTS, planted before the rank's weights and engine
    are made. Rank 0 returns {(seed, variant): its JobRecord} of the first
    job at the cell's size; the others {}."""
    from portbench import run as harness
    from portbench.calibrate import FAULTS
    tr = cell.traffic
    P, N = tr["prompt_len"], tr["new_tokens"]
    dev = mesh.device
    _share_threads()
    t = time.perf_counter()
    _warm_up(_rank_jobs(mesh, cell, plan[0][0]))
    _progress(mesh, f"warm-up {time.perf_counter() - t:.1f} s")
    out = {}
    for seed, names in plan:
        for name in names:
            with _planted(FAULTS.get(name), P):
                jobs = _rank_jobs(mesh, cell, seed, int8=(name == "int8"))
                engine = jobs.engine(P, N)
                jobs.params = None      # the engine holds the rank's blocks
                rec = jobs.run(engine, 0, P, N)
                del engine, jobs
                gc.collect()
                harness._sync(dev)
            _progress(mesh, f"seed {seed} {name}: job {rec.job_s:.1f} s "
                            f"(encode {rec.encode_s:.1f} s)")
            if mesh.rank == 0:
                out[(seed, name)] = _portable(rec)
    return out


def _progress(mesh, text: str) -> None:
    """A line on stderr from rank 0: a calibration's world runs for minutes
    and returns its records only at its end."""
    if mesh.rank == 0:
        print(f"calibrate: tp={mesh.tp} {text}", file=sys.stderr, flush=True)


def calibrate(cell, plan: list, backend: str, devices: list,
              timeout_s: float) -> dict:
    """calibrate_rank over a world: {(seed, variant): rank 0's JobRecord}."""
    _check_clock()
    res = start_world(calibrate_rank, devices, backend, (cell, plan),
                      timeout_s)
    return {k: _tensors(v) for k, v in res[0].items()}
