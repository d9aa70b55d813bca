"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of one chip runs in this process as below; a cell of several runs
the same steps over a tensor-parallel world of its cards, one process a
card (world.py).

Set-up (imports, the weights drawn on the card from the seed, a warm-up job
on a small engine at the cell's batch and chunk, the run's Engine) is timed
from process start. The window then runs whole jobs back to back, each one
call of the program's entry on the run's Engine with fresh prompts, and
starts no job once --seconds have passed. With --trace 1 one more short
job follows, part of it under torch.profiler. Once the window's memory peak
is read and the program's state is freed, the plain reference judges a
sample of the served tokens (check.py). The last line on stdout is one JSON
object; the numbers compared, each beside its limit, are the last lines on
stderr and the result's last key.
"""

import time

T0 = time.perf_counter()        # set-up is timed from here, before torch

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, layout, weights  # noqa: E402
from portbench.metrics import reader  # noqa: E402
from portbench.record import JobRecord, Run  # noqa: E402
from portbench.trace import Profiler  # noqa: E402

# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "magicdec_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: magicdec_tpu_torch is not magicdec_tpu."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_args(config: dict):
    """The program's ModelArgs for a config file (published HF keys)."""
    from magicdec_tpu_torch.models.config import ModelArgs
    if config.get("rope_scaling"):
        raise ValueError("rope_scaling is not mapped onto the program")
    sz = layout.sizes(config)
    return ModelArgs(block_size=sz.max_positions, vocab_size=sz.vocab,
                     n_layer=sz.n_layer, n_head=sz.n_head, dim=sz.dim,
                     intermediate_size=sz.intermediate,
                     n_kv_head=sz.n_kv_head, head_dim=sz.head_dim,
                     rope_base=sz.rope_theta, norm_eps=sz.norm_eps,
                     qkv_bias=sz.qkv_bias,
                     tie_word_embeddings=sz.tied)


class Jobs:
    """The cell's traffic (traffic/<name>.json) on the program: engines and
    jobs."""

    def __init__(self, cell, params, seed: int, device, mesh=None):
        self.cell, self.params, self.seed, self.device = cell, params, seed, device
        self.mesh = mesh    # a rank's tp mesh (world.py); None on one card
        self.tr = cell.traffic
        self.entry = self.tr["entry"]
        self.cfg = model_args(cell.config)

    def engine(self, prompt_len: int, new_tokens: int):
        from magicdec_tpu_torch.engine.backend import Engine
        tr = self.tr
        if self.entry == "selfspec":
            # a round appends at most gamma + 1 tokens a sequence, so every
            # sequence gets its new tokens before any cache is full
            max_len = prompt_len + (tr["gamma"] + 1) * (new_tokens + 1)
        else:
            max_len = prompt_len + new_tokens
        return Engine(self.cfg, self.params, batch_size=tr["batch"],
                      max_len=max_len, spec=tr.get("spec"),
                      draft_budget=tr.get("draft_budget", 0),
                      window_size=tr.get("window_size", 32),
                      prefill_chunk=tr.get("prefill_chunk", 128),
                      device=self.device, mesh=self.mesh)

    def run(self, engine, job, prompt_len: int, new_tokens: int,
            hooks=None) -> JobRecord:
        """One job: prompts drawn for (seed, job), one call of the entry,
        timed on the host clock up to a synchronize; the encode span is
        timed by a wrapper on the engine instance. hooks: an object with
        after_encode() and before_encode() (the traced job)."""
        from magicdec_tpu_torch.engine import spec as spec_lib
        tr, dev = self.tr, self.device
        B = tr["batch"]
        ids = weights.prompts(self.seed, job, B, prompt_len,
                              self.cell.sizes.vocab, dev)
        spans = []
        encode = engine.encode

        def timed_encode(input_ids):
            if hooks:
                hooks.before_encode()
            t = time.perf_counter()
            tok = encode(input_ids)
            _sync(dev)
            spans.append(time.perf_counter() - t)
            if hooks:
                hooks.after_encode()
            return tok

        engine.encode = timed_encode
        engine.clear_kv()           # the engine's buffers serve every job
        _sync(dev)
        try:
            t0 = time.perf_counter()
            if self.entry == "selfspec":
                out, counts, stats = spec_lib.generate_selfspec(
                    engine, ids, tr["gamma"], new_tokens)
                counts = counts.tolist()
            else:
                out, stats = spec_lib.generate_autoregressive(
                    engine, ids, new_tokens)
                # no end-of-text ids: every sequence runs the same steps
                counts = [stats.generated_tokens // B] * B
            _sync(dev)
            job_s = time.perf_counter() - t0
        finally:
            del engine.encode
        return JobRecord(
            entry=self.entry, batch=B, prompt_len=prompt_len,
            new_tokens=new_tokens, chunk=tr.get("prefill_chunk", 128),
            gamma=tr.get("gamma", 0), budget=tr.get("draft_budget", 0),
            job_s=job_s, encode_s=spans[0], counts=counts,
            rounds=stats.rounds, accepted=stats.total_accepted_drafts,
            drafted=stats.total_drafted, prompts=ids.cpu(), output=out.cpu())


class _TracedPart:
    """Hooks that put the decode part (after encode) or the encode span of
    one job under the profiler."""

    def __init__(self, part: str):
        self.part, self.prof, self.trace = part, Profiler(), None

    def before_encode(self):
        if self.part == "encode":
            self.prof.start()

    def after_encode(self):
        if self.part == "encode":
            self.trace = self.prof.stop("encode")
        else:
            self.prof.start()

    def after_job(self):
        if self.part == "decode":
            self.trace = self.prof.stop("decode")


def run_cell(cell, seed: int, seconds: float, trace: bool, device) -> tuple:
    """(Run, checks) of one run of `cell`."""
    import torch
    tr = cell.traffic
    P, N = tr["prompt_len"], tr["new_tokens"]
    marks = [("imports", time.perf_counter())]
    dtype = getattr(torch, cell.config["torch_dtype"])
    params = weights.make(cell.sizes, seed, device, dtype)
    jobs = Jobs(cell, params, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))

    warm = tr["warmup"]
    engine = jobs.engine(warm["prompt_len"], warm["new_tokens"])
    jobs.run(engine, "warmup", warm["prompt_len"], warm["new_tokens"])
    del engine
    gc.collect()
    marks.append(("warm-up", time.perf_counter()))
    engine = jobs.engine(P, N)
    _sync(device)
    marks.append(("engine", time.perf_counter()))

    run = Run(cell=cell, chips=cell.chips,
              device_name=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
    run.setup_s = time.perf_counter() - T0
    run.setup_parts = {name: t - prev for (name, t), prev in
                       zip(marks, [T0] + [t for _, t in marks[:-1]])}
    start = time.perf_counter()
    while not run.jobs or time.perf_counter() - start < seconds:
        run.jobs.append(jobs.run(engine, len(run.jobs), P, N))
    run.window_s = time.perf_counter() - start
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)

    t = time.perf_counter()
    if trace:
        part = _TracedPart(tr["trace"]["part"])
        rec = jobs.run(engine, "trace", P, tr["trace"]["new_tokens"], part)
        part.after_job()
        run.trace = part.trace
        run.trace.job = rec
    run.trace_s = time.perf_counter() - t

    del engine, jobs
    gc.collect()
    t = time.perf_counter()
    checks = check.compare(run.jobs, params, cell.sizes, tr["check_rows"],
                           seed, cell.limits, device)
    run.check_s = time.perf_counter() - t
    return run, checks


def result_line(run: Run, checks: dict, trace: bool, device) -> dict:
    """The contract's result object; "checks" is its last key."""
    metrics = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_name, "count": run.cell.chips,
           "memory_peak_bytes": run.peak_bytes}
    line = {"correct": check.passes(checks),
            "attempted": sum(j.batch for j in run.jobs),
            "failed": checks["short_rows"]["value"],
            "metrics": metrics, "device": dev}
    if trace:
        # over a world, the mean of every rank's traced part
        busy = run.rank_busy or [(run.trace.busy_s, run.trace.window_s)]
        dev["busy_s"] = sum(b for b, _ in busy) / len(busy)
        dev["window_s"] = sum(w for _, w in busy) / len(busy)
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line


def main(argv=None, device=None, bench_file=None, root=None, backend=None,
         devices=None, timeout_s=None, plant=None) -> int:
    """The command. device None: the card, refused without enough of them;
    a cell of one chip runs in this process on cuda:0, a cell of several
    over a tensor-parallel world of nccl ranks on cuda:0 .. (world.py). A
    test passes device (in this process) or devices and backend (a world:
    gloo ranks on the CPU or sharing a card, an nccl world of one), and for
    its own files bench_file and root; timeout_s and plant (a callable
    planted in every rank, world.run_rank) reach the world."""
    args = parse_args(argv)
    import torch
    cell = layout.load_cell(args.workload, bench_file, root)
    if device is None and devices is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"portbench: {cell.name} needs {cell.chips} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        if cell.chips > 1:
            backend, devices = "nccl", [f"cuda:{i}" for i in range(cell.chips)]
        else:
            device = torch.device("cuda", 0)
    if devices is None:
        run, checks = run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), device)
        ranks_loaded = []
    else:
        from portbench import world
        run, checks, ranks_loaded = world.run_cell(
            cell, args.seed, args.seconds, bool(args.trace), backend or "nccl",
            devices, T0, timeout_s, plant)
        device = torch.device(devices[0])
    line = result_line(run, checks, bool(args.trace), device)
    bad = sorted(set(forbidden_modules()) | set(ranks_loaded))
    if bad:
        print(f"portbench: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    parts = ", ".join(f"{k} {v:.2f}" for k, v in run.setup_parts.items())
    print(f"portbench: {cell.name} seed {args.seed}: set-up "
          f"{run.setup_s:.2f} s ({parts}), {len(run.jobs)} jobs in {run.window_s:.2f} s "
          f"(encode {[round(j.encode_s, 3) for j in run.jobs]}, job "
          f"{[round(j.job_s, 3) for j in run.jobs]}), trace {run.trace_s:.2f} s, "
          f"reference {run.check_s:.2f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
