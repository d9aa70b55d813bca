"""Readings that the limits of cells/<cell>.json are set from; not part of
a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 11,12,13] [--int8-seeds 11,12,13] \
        [--fault-seeds 11,12,13 --faults no_kv_write,prompt_keys_only] \
        [--out file.jsonl]

For each seed, in one process: the weights drawn for it, one job of the
cell at its own size on the program (the window's first job), and the
sample a run of that seed compares, judged by the plain reference with
check.summary: the program's numbers (the lower readings). The upper
readings come from the controls and the faults, each judged at the same
sampled sequences:
  - fp8 (--control-seeds): the reference with its products in fp8
    (reference/model.py), read at the program's positions: the gaps of the
    tokens it puts first;
  - int8 (--int8-seeds): the program once more with its own int8
    weight-only path switched on (quant/int8.quantize_params), its served
    tokens judged like the program's;
  - faults (--fault-seeds, --faults): the program once more with its timed
    path broken underneath (FAULTS), its served tokens judged the same way.
With the cell's limits in place each line also says whether each variant
passes them. One JSON line a seed goes to stdout and to --out.

A cell of several chips runs its jobs over a tensor-parallel world of its
cards (world.calibrate): each rank draws its blocks of the seed's weights,
each variant (int8, a fault) is planted inside every rank before its engine
is built, and rank 0's served tokens come back here, where the readings are
taken once the world has exited. no_all_reduce, the exchange between the
ranks left out, is a fault of such a cell.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, layout, weights  # noqa: E402
from portbench.run import Jobs, _sync  # noqa: E402


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _no_kv_write(prompt_len):
    """Decode and verify steps write no K/V row (the state left unchanged);
    chunked prefill still fills the prompt's slots."""
    from magicdec_tpu_torch import cache
    return _patched(cache, "write_slots", lambda old: lambda *a, **k: None)


def _prompt_keys_only(prompt_len):
    """Decode attention (AR steps, verify) over the prompt's keys only: the
    generated tokens' keys are never read."""
    from magicdec_tpu_torch.engine import attention_impls as ai

    def make(old):
        def fn(q, ck, cv, l, valid, **kw):
            return old(q, ck, cv, l, valid.clamp(max=prompt_len), **kw)
        return fn
    return _patched(ai, "flash_decode_stacked", make)


def _prefill_half_keys(prompt_len):
    """Chunked prefill whose attention reads only the first half of the
    prompt's keys: queries past the middle miss every key after it."""
    from magicdec_tpu_torch.engine import attention_impls as ai

    def make(old):
        def fn(q, ck, cv, l, valid, **kw):
            return old(q, ck, cv, l, valid.clamp(max=prompt_len // 2), **kw)
        return fn
    return _patched(ai, "flash_prefill", make)


def _no_all_reduce(prompt_len):
    """The exchange between tp ranks left out: the row-parallel products
    (wo, w_down) and the vocab-parallel embedding keep each rank's partial
    sum (a no-op on one card, where nothing is exchanged)."""
    from magicdec_tpu_torch.models import llama
    return _patched(llama, "all_reduce_tp", lambda old: lambda x, mesh: x)


FAULTS = {"no_kv_write": _no_kv_write, "prompt_keys_only": _prompt_keys_only,
          "prefill_half_keys": _prefill_half_keys,
          "no_all_reduce": _no_all_reduce}


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def readings(job, rows, seed, params, sz, device, products=("f32",)):
    """{product: check.summary} over the seed's sample of one job."""
    per_row = {p: [] for p in products}
    for j, r in check.sample([job], rows, seed):
        g = check.gaps(params, sz, job.prompts[r], check.served(job, r),
                       products, device)
        for p in products:
            per_row[p].append(g[p])
    return {p: check.summary(v) for p, v in per_row.items()}


def judge(numbers: dict, limits: dict):
    """check.passes on the numbers beside the cell's limits; None before
    the limits are set."""
    if not all(k in limits for k in numbers):
        return None
    return check.passes({k: {"value": v, "limit": limits[k]}
                         for k, v in numbers.items()})


def _device_name(device) -> str:
    import torch
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def _read_into(line: dict, name: str, rec, cell, seed: int, params, device,
               control_seeds) -> None:
    """The readings of variant `name`'s job on seed (the fp8 control's too,
    for the program on a control seed), judged at the cell's limits."""
    sz, rows = cell.sizes, cell.traffic["check_rows"]
    products = (("f32", "fp8") if name == "program" and seed in control_seeds
                else ("f32",))
    t = time.perf_counter()
    got = readings(rec, rows, seed, params, sz, device, products)
    if name == "program":
        line.update(job_s=rec.job_s, encode_s=rec.encode_s,
                    reference_s=time.perf_counter() - t,
                    acceptance=(rec.accepted / rec.drafted
                                if rec.drafted else None))
    line[name] = got["f32"]
    line[name]["passes"] = judge(got["f32"], cell.limits)
    if "fp8" in got:
        line["fp8"] = got["fp8"]
        line["fp8"]["passes"] = judge(got["fp8"], cell.limits)


def main(argv=None, bench_file=None, root=None, backend=None, devices=None,
         timeout_s=None):
    """The command: a cell of one chip in this process on cuda:0, a cell of
    several over a tensor-parallel world of nccl ranks on cuda:0 ..
    (world.calibrate), each variant planted inside every rank before its
    engine is built, the readings taken here. A test or a rehearsal passes
    devices and backend (gloo ranks on the CPU or sharing a card, an nccl
    world of one), and bench_file and root for its own files."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--int8-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="no_kv_write,prompt_keys_only")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    cell = layout.load_cell(args.workload, bench_file, root)
    sz, tr = cell.sizes, cell.traffic
    P, N = tr["prompt_len"], tr["new_tokens"]
    faults = [f for f in args.faults.split(",") if f]
    seeds = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.int8_seeds) | set(args.fault_seeds))
    if devices is None and cell.chips > 1:
        backend, devices = "nccl", [f"cuda:{i}" for i in range(cell.chips)]
    out = open(args.out, "a") if args.out else None

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    if devices is not None:
        from portbench import world
        plan = [(seed, ["program"]
                 + (["int8"] if seed in args.int8_seeds else [])
                 + (faults if seed in args.fault_seeds else []))
                for seed in seeds]
        recs = world.calibrate(
            cell, plan, backend or "nccl", devices,
            timeout_s or 600 + 300 * sum(len(v) for _, v in plan))
        device = torch.device(devices[0])
        dtype, params = getattr(torch, cell.config["torch_dtype"]), None
        for seed, names in plan:
            if params is None:
                params = weights.make(sz, seed, device, dtype)
            else:
                weights.redraw(params, sz, seed)
            line = {"cell": cell.name, "seed": seed,
                    "device": _device_name(device), "tp": len(devices)}
            for name in names:
                _read_into(line, name, recs.pop((seed, name)), cell, seed,
                           params, device, args.control_seeds)
            emit(line)
        return 0

    device = torch.device("cuda", 0)
    params = weights.make(sz, args.seeds[0], device,
                          getattr(torch, cell.config["torch_dtype"]))
    warm = tr["warmup"]
    jobs = Jobs(cell, params, args.seeds[0], device)
    engine = jobs.engine(warm["prompt_len"], warm["new_tokens"])
    jobs.run(engine, "warmup", warm["prompt_len"], warm["new_tokens"])
    del engine
    for seed in seeds:
        weights.redraw(params, sz, seed)
        line = {"cell": cell.name, "seed": seed,
                "device": torch.cuda.get_device_name(device)}
        variants = [("program", params, contextlib.nullcontext())]
        if seed in args.int8_seeds:
            from magicdec_tpu_torch.quant.int8 import quantize_params
            variants.append(("int8", quantize_params(params, "int8"),
                             contextlib.nullcontext()))
        if seed in args.fault_seeds:
            variants += [(f, params, FAULTS[f](P)) for f in faults]
        for name, prm, planted in variants:
            with planted:
                jobs = Jobs(cell, prm, seed, device)
                engine = jobs.engine(P, N)
                rec = jobs.run(engine, 0, P, N)
                del engine
                gc.collect()
                _sync(device)
            _read_into(line, name, rec, cell, seed, params, device,
                       args.control_seeds)
            del rec
        del variants, prm
        emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
