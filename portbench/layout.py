"""Find a cell's files by name and turn a configuration file into sizes.

BENCHMARK.json (at the root of the checkout) names each cell's config and
traffic; the files themselves sit under portbench/ by those names. A later
cell, config or metric is new files and new BENCHMARK.json entries only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
REPO_DIR = PKG_DIR.parent


@dataclass(frozen=True)
class Sizes:
    """A decoder's sizes, read from a config file's published keys."""
    n_layer: int
    dim: int
    n_head: int
    n_kv_head: int
    head_dim: int
    intermediate: int
    vocab: int
    rope_theta: float
    norm_eps: float
    qkv_bias: bool
    tied: bool
    max_positions: int

    @property
    def group(self) -> int:
        return self.n_head // self.n_kv_head

    @property
    def qkv_out(self) -> int:
        return (self.n_head + 2 * self.n_kv_head) * self.head_dim


def sizes(config: dict) -> Sizes:
    """The sizes of an HF-style config dict (the keys of the model's own
    config.json). head_dim, where the source does not give it, is
    hidden_size // num_attention_heads."""
    n_head = config["num_attention_heads"]
    return Sizes(
        n_layer=config["num_hidden_layers"], dim=config["hidden_size"],
        n_head=n_head, n_kv_head=config["num_key_value_heads"],
        head_dim=config.get("head_dim") or config["hidden_size"] // n_head,
        intermediate=config["intermediate_size"], vocab=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        qkv_bias=bool(config.get("qkv_bias", False)),
        tied=bool(config.get("tie_word_embeddings", False)),
        max_positions=config["max_position_embeddings"])


@dataclass
class Cell:
    """One entry of BENCHMARK.json's workloads with its files loaded."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict            # cells/<cell>.json
    end_to_end: list        # BENCHMARK.json metric entries reported here
    per_layer: list

    @property
    def sizes(self) -> Sizes:
        return sizes(self.config)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path | None = None,
              root: Path | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (bench_file; default the one at the
    root of the checkout) with its config (the entry's `file`, relative to
    bench_file), traffic and limit files (under `root`, default portbench/).
    Raises FileNotFoundError or KeyError for a name that is not there."""
    bench_file = bench_file or REPO_DIR / "BENCHMARK.json"
    bench = _load_json(bench_file)
    root = root or PKG_DIR
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, config_name=entry["config"],
        traffic_name=entry["traffic"], chips=entry["chips"],
        config=_load_json(bench_file.parent / conf["file"]),
        traffic=_load_json(root / "traffic" / f"{entry['traffic']}.json"),
        limits=_load_json(root / "cells" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
