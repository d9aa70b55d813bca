"""ctypes binding for the host wave buffer, and the pinned staging that
carries its gathers to the card (port of magicdec_tpu/engine/wave_buffer.py).

The buffer is csrc/wave_buffer.cpp, plain C++ with a C interface, built
with g++ at first use into magicdec_tpu_torch/build/ by ops/_build.py; the
JAX package's native/ directory is never built or loaded. Bytes cross the
interface raw, so a bfloat16 tensor travels as its bytes and needs no
numpy bfloat16 type.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from magicdec_tpu_torch.ops import _build

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("wave_buffer")
        lib.wave_create.restype = ctypes.c_void_p
        lib.wave_create.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int]
        lib.wave_destroy.argtypes = [ctypes.c_void_p]
        lib.wave_put.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_void_p]
        lib.wave_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64, ctypes.c_void_p]
        lib.wave_stats_gathered.restype = ctypes.c_int64
        lib.wave_stats_gathered.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def as_bytes(data) -> np.ndarray:
    """A numpy array or a tensor (on any device) as a contiguous uint8
    numpy array [n, bytes of one row along the first axis]."""
    if isinstance(data, torch.Tensor):
        t = data.detach().cpu().contiguous()
        return t.reshape(t.shape[0], -1).view(torch.uint8).numpy()
    arr = np.ascontiguousarray(data)
    return arr.view(np.uint8).reshape(arr.shape[0], -1)


class HostWaveBuffer:
    """Fixed-slot host store: `n_slots` slots of `slot_bytes` bytes each."""

    def __init__(self, n_slots: int, slot_bytes: int,
                 n_threads: int | None = None):
        lib = _load()
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8)
        self._lib = lib
        self._h = lib.wave_create(n_slots, slot_bytes, n_threads)
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes

    def put(self, first_slot: int, data):
        """Upload contiguous slots: `data` has one slot per row of its first
        axis (a numpy array or a tensor whose rows are slot_bytes long)."""
        arr = as_bytes(data)
        if arr.shape[1] != self.slot_bytes:
            raise ValueError(f"rows of {arr.shape[1]} bytes, slots of "
                             f"{self.slot_bytes}")
        if first_slot < 0 or first_slot + arr.shape[0] > self.n_slots:
            raise ValueError(f"slots [{first_slot}, "
                             f"{first_slot + arr.shape[0]}) outside "
                             f"[0, {self.n_slots})")
        self._lib.wave_put(self._h, first_slot, arr.shape[0],
                           arr.ctypes.data)

    def gather(self, slot_ids, out: torch.Tensor | None = None
               ) -> np.ndarray:
        """Parallel gather of slots into contiguous bytes, returned as uint8
        [n, slot_bytes] numpy. `out`: a contiguous CPU tensor (a pinned
        staging buffer) of at least n * slot_bytes bytes to gather into;
        None gathers into a new array."""
        ids = np.ascontiguousarray(slot_ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_slots):
            raise ValueError(f"slot ids outside [0, {self.n_slots})")
        n = len(ids)
        if out is None:
            arr = np.empty((n, self.slot_bytes), np.uint8)
        elif (out.is_cuda or not out.is_contiguous()
              or out.numel() * out.element_size() < n * self.slot_bytes):
            raise ValueError("out must be a contiguous CPU tensor of at "
                             f"least {n * self.slot_bytes} bytes")
        else:
            arr = out.view(torch.uint8).reshape(-1)[:n * self.slot_bytes]
            arr = arr.numpy().reshape(n, self.slot_bytes)
        self._lib.wave_gather(self._h, ids.ctypes.data, n, arr.ctypes.data)
        return arr

    @property
    def gathered_slots(self) -> int:
        return int(self._lib.wave_stats_gathered(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                self._lib.wave_destroy(self._h)
            except Exception:
                pass
            self._h = None


class PinnedStaging:
    """Host-to-device transfers of gathered bytes through two pinned host
    buffers that take turns: a gather writes into one buffer while the copy
    out of the other may still run. Before a buffer is written again, the
    event recorded after its last copy is waited on, so no copy ever reads
    bytes of a later gather. On a CPU device the bytes stay in a new host
    tensor and nothing is copied.

    `copies` and `bytes` count the transfers to the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._events: list[torch.cuda.Event | None] = [None, None]
        self._turn = 0
        self.copies = 0
        self.bytes = 0

    def upload(self, nbytes: int, fill) -> torch.Tensor:
        """fill(host) writes nbytes bytes into the uint8 CPU tensor `host`;
        returns a uint8 tensor of them on the device (the copy is
        asynchronous on the current stream, which orders every later kernel
        after it)."""
        if self.device.type != "cuda":
            host = torch.empty(nbytes, dtype=torch.uint8)
            fill(host)
            return host
        i = self._turn
        self._turn ^= 1
        if self._events[i] is not None:
            self._events[i].synchronize()
        if self._bufs[i] is None or self._bufs[i].numel() < nbytes:
            self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
        host = self._bufs[i][:nbytes]
        fill(host)
        out = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
        out.copy_(host, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = event
        self.copies += 1
        self.bytes += nbytes
        return out


class HostBlockStore:
    """HostWaveBuffer with the (layer, batch, cluster) slot layout of the
    offload path (engine/offload.py) and of retro.HostClusterStore: one
    slot per (l, b, c) holds the cluster's K block [cap, HD] followed by
    its V block, in `dtype`'s bytes.

    gather_clusters returns blocks on the host; fetch carries them to a
    device through PinnedStaging (one staging per device). `fetches`
    counts the host gathers and `bytes_fetched` their bytes."""

    def __init__(self, L: int, B: int, C: int, cap: int, HD: int,
                 dtype: torch.dtype):
        self.L, self.B, self.C, self.cap, self.HD = L, B, C, cap, HD
        self.dtype = dtype
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.slot_bytes = 2 * cap * HD * itemsize
        self.buf = HostWaveBuffer(L * B * C, self.slot_bytes)
        self._staging: dict[torch.device, PinnedStaging] = {}
        self.fetches = 0
        self.bytes_fetched = 0

    def put_layer(self, l: int, blocks):
        """blocks [B, C, 2, cap, HD] of this store's dtype (on any
        device)."""
        # gather_clusters strides by the constructor's C: a clustering pass
        # that yielded another cluster count would lay rows out desynced
        # from that stride and gather wrong bytes
        want = (self.B, self.C, 2, self.cap, self.HD)
        if tuple(blocks.shape) != want:
            raise ValueError(f"blocks {tuple(blocks.shape)}, the store "
                             f"holds {want} a layer")
        if blocks.dtype != self.dtype:
            raise ValueError(f"blocks of {blocks.dtype}, the store holds "
                             f"{self.dtype}")
        self.buf.put(l * self.B * self.C, blocks.reshape(self.B * self.C, -1))

    def slot_ids(self, l: int, top_c) -> np.ndarray:
        """Cluster ids [B, n] of layer l -> the store's slot ids [B * n]."""
        top_c = np.asarray(top_c, np.int64)
        if top_c.ndim != 2 or top_c.shape[0] != self.B:
            raise ValueError(f"cluster ids {top_c.shape}: need [{self.B}, n]")
        if top_c.size and (top_c.min() < 0 or top_c.max() >= self.C):
            raise ValueError(f"cluster ids outside [0, {self.C})")
        return ((l * self.B + np.arange(self.B)[:, None]) * self.C
                + top_c).reshape(-1)

    def _view(self, raw: torch.Tensor, n: int) -> torch.Tensor:
        return raw.view(self.dtype).reshape(n, 2, self.cap, self.HD)

    def gather_slots(self, ids: np.ndarray) -> torch.Tensor:
        """Slots by id -> blocks [n, 2, cap, HD] on the host."""
        raw = torch.from_numpy(self.buf.gather(ids).reshape(-1))
        self.fetches += 1
        self.bytes_fetched += raw.numel()
        return self._view(raw, len(ids))

    def fetch_slots(self, ids: np.ndarray, device) -> torch.Tensor:
        """Slots by id -> blocks [n, 2, cap, HD] on `device`: gathered into
        a pinned buffer and copied with one asynchronous copy."""
        device = torch.device(device)
        if device not in self._staging:
            self._staging[device] = PinnedStaging(device)
        ids = np.ascontiguousarray(ids, np.int64)
        nbytes = len(ids) * self.slot_bytes
        raw = self._staging[device].upload(
            nbytes, lambda host: self.buf.gather(ids, out=host))
        self.fetches += 1
        self.bytes_fetched += nbytes
        return self._view(raw, len(ids))

    def gather_clusters(self, l: int, top_c) -> torch.Tensor:
        """top_c [B, n] -> K/V blocks [B, n, 2, cap, HD] on the host."""
        n = np.shape(top_c)[-1]
        return self.gather_slots(self.slot_ids(l, top_c)).reshape(
            self.B, n, 2, self.cap, self.HD)

    def fetch(self, l: int, top_c, device) -> torch.Tensor:
        """top_c [B, n] -> K/V blocks [B, n, 2, cap, HD] on `device`."""
        n = np.shape(top_c)[-1]
        return self.fetch_slots(self.slot_ids(l, top_c), device).reshape(
            self.B, n, 2, self.cap, self.HD)
