"""What a run records, for the metric readers (metrics/<name>.py)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class JobRecord:
    """One job: one call of the program's entry on the run's Engine."""
    entry: str                  # "selfspec" or "autoregressive"
    batch: int
    prompt_len: int
    new_tokens: int
    chunk: int
    gamma: int
    budget: int
    job_s: float                # harness clock, call to synchronize
    encode_s: float             # the encode span, up to its synchronize
    counts: list                # tokens each sequence generated
    rounds: int = 0             # SnapKV rounds (SpecStats)
    accepted: int = 0           # accepted drafts (SpecStats)
    drafted: int = 0            # drafted tokens (SpecStats)
    prompts: object = None      # [B, P] int32 (host), for the check
    output: object = None       # [B, >= new_tokens] int32 (host)

    @property
    def decode_s(self) -> float:
        return self.job_s - self.encode_s

    @property
    def delivered(self) -> int:
        """Tokens the decode part delivered of those asked for: each
        sequence's first new_tokens, less the first (encode's)."""
        return sum(min(c, self.new_tokens) - 1 for c in self.counts)


@dataclass
class Run:
    """A run of one cell: its files, the window's jobs, set-up, memory and,
    with --trace 1, the traced part. Over a world of several cards (world.py)
    the jobs, clocks and trace are rank 0's and the peak the fullest rank's."""
    cell: object                # layout.Cell
    chips: int = 1              # cards the cell runs on; the peaks scale by it
    jobs: list = field(default_factory=list)
    setup_s: float = 0.0
    setup_parts: dict = field(default_factory=dict)   # seconds by phase
    window_s: float = 0.0
    peak_bytes: int = 0
    device_name: str = ""
    trace: object = None        # trace.Trace
    # traced over a world: [(busy_s, window_s)] of each rank's traced part
    rank_busy: list = field(default_factory=list)
    trace_s: float = 0.0        # the traced job, profiler included
    check_s: float = 0.0        # the reference's comparison

    @property
    def sizes(self):
        return self.cell.sizes
