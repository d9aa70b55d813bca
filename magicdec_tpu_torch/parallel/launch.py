"""Start a world of processes for a dp x tp mesh and collect what each rank
returns.

    results = run_world(fn, tp=2, backend="gloo", devices=["cuda:0"] * 2,
                        args=(...,), rendezvous_dir=path, timeout_s=600)
    run_world(fn, tp=2, dp=2, backend="gloo", devices=["cpu"] * 4)
    run_world(fn, tp=2, backend="gloo", devices=["cpu"] * 4)  # sub-mesh
    run_world(fn, tp=2, backend="gloo", devices=["cpu"] * 4,
              local_size=2)                                   # two hosts

starts one process per entry of `devices` (rank r on devices[r]) in a
spawn context. Each rendezvous through a FileStore in a fresh file under
rendezvous_dir (no TCP port, so concurrent worlds never contend for one),
runs torch.distributed.init_process_group(backend) with timeout_s, sets
its device, builds its mesh and calls fn(mesh, *args, **kwargs); the
ranks' return values come back in rank order. The mesh is
parallel/sharding.make_mesh(dp, tp) over the first dp*tp ranks (a rank
past them, in a larger world, gets mesh None and runs fn all the same, so
it can take part in what every rank of the world must call). With
local_size, each rank's LOCAL_RANK and LOCAL_WORLD_SIZE are set as
torchrun sets them on hosts of local_size ranks, and the mesh is
make_multihost_mesh(tp): one machine emulates the hosts. A rank that raises fails the whole call with its traceback; a world
that does not finish within timeout_s is terminated and fails the call, so
no fault hangs. fn must be a module-level function of a module that the children
can import by name (the spawned child imports it afresh), and its return
value must pickle. The kernels are built in the parent first (ops/_build),
so the ranks do not each run nvcc.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch


def _rank_main(fn, rank: int, world: int, dp: int, tp: int,
               local_size: int | None, backend: str, device: str,
               store_path: str, timeout_s: float, args: tuple, kwargs: dict,
               results):
    """A rank's process: rendezvous, mesh, fn; its outcome goes on
    `results` as (rank, ok, value or traceback)."""
    import torch.distributed as dist

    from magicdec_tpu_torch.parallel.sharding import (make_mesh,
                                                      make_multihost_mesh)

    try:
        if local_size:
            os.environ["LOCAL_RANK"] = str(rank % local_size)
            os.environ["LOCAL_WORLD_SIZE"] = str(local_size)
        dev = torch.device(device)
        if dev.type == "cuda":      # "cuda" alone: the process's first card
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            if local_size:
                mesh = make_multihost_mesh(tp, backend=backend, device=dev)
            else:
                mesh = make_mesh(dp, tp, backend=backend, device=dev)
            out = fn(mesh, *args, **kwargs)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn, tp: int, backend: str, devices, args: tuple = (),
              kwargs: dict | None = None, rendezvous_dir: str | None = None,
              timeout_s: float = 600.0, *, dp: int = 1,
              local_size: int | None = None) -> list:
    """Run fn(mesh, *args, **kwargs) in each rank of a world of
    len(devices) processes (rank r on devices[r]) with a dp x tp mesh over
    its first dp*tp ranks, or with local_size the multi-host mesh of tp
    ranks a host (dp: the number of hosts); returns the ranks' results in
    rank order. Raises RuntimeError with the failing rank's traceback, or
    on a timeout (the world is then terminated)."""
    devices = [str(d) for d in devices]
    world = len(devices)
    if local_size:
        if world % local_size or not 1 <= tp <= local_size:
            raise ValueError(f"{world} ranks on hosts of {local_size} with "
                             f"tp={tp} a host")
    elif dp * tp > world:
        raise ValueError(f"{world} devices for a dp={dp} x tp={tp} mesh")
    if any(d.startswith("cuda") for d in devices):
        from magicdec_tpu_torch.ops import _build
        _build.build()
    root = tempfile.mkdtemp(prefix="world_", dir=rendezvous_dir)
    store_path = os.path.join(root, "store")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, dp, tp, local_size, backend,
                               devices[r], store_path, timeout_s, tuple(args),
                               kwargs or {}, results),
                         name=f"rank_{r}") for r in range(world)]
    deadline = time.monotonic() + timeout_s
    got: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            try:        # drain the queue before joining the writers
                rank, ok, value = results.get(
                    timeout=1.0 if dead else max(min(left, 5.0), 0.01))
            except queue.Empty:
                if dead:    # exited without a report (killed, out of memory)
                    raise RuntimeError(
                        f"world: {dead[0].name} died with exit code "
                        f"{dead[0].exitcode} before reporting") from None
                if left <= 0:
                    raise RuntimeError(f"world: no result from ranks "
                                       f"{sorted(set(range(world)) - set(got))} "
                                       f"within {timeout_s} s") from None
                continue
            if not ok:
                raise RuntimeError(f"world: rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"world: {p.name} exited with "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        for name in os.listdir(root):
            os.unlink(os.path.join(root, name))
        os.rmdir(root)
    return [got[r] for r in range(world)]
