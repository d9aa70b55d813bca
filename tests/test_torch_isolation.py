"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never quietly fall back to the CPU."""

import os
import pkgutil
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import magicdec_tpu_torch

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        magicdec_tpu_torch.__path__, "magicdec_tpu_torch."))


def test_port_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert "magicdec_tpu_torch.engine.spec" in mods
    assert "magicdec_tpu_torch.ops.flash_decode" in mods
    assert "magicdec_tpu_torch.engine.longspec" in mods
    assert "magicdec_tpu_torch.engine.quest" in mods
    assert "magicdec_tpu_torch.ops.page_gather" in mods
    assert "magicdec_tpu_torch.engine.squeeze" in mods
    assert "magicdec_tpu_torch.ops.kmeans" in mods
    assert "magicdec_tpu_torch.ops.gemm_softmax" in mods
    assert "magicdec_tpu_torch.quant.int8" in mods
    assert "magicdec_tpu_torch.ops.int4_matmul" in mods
    assert "magicdec_tpu_torch.ops.fused_block" in mods
    assert "magicdec_tpu_torch.models.glide" in mods
    assert "magicdec_tpu_torch.engine.glide_engine" in mods
    assert "magicdec_tpu_torch.train" in mods
    assert "magicdec_tpu_torch.data.converters" in mods
    assert "magicdec_tpu_torch.engine.serve" in mods
    assert "magicdec_tpu_torch.engine.offload" in mods
    assert "magicdec_tpu_torch.engine.wave_buffer" in mods
    for tail in ("checkpoint.convert_hf", "checkpoint.download", "data.ruler",
                 "data.longbench", "analysis", "utils.profiling"):
        assert "magicdec_tpu_torch." + tail in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["magicdec_tpu"] = None
        sys.modules["safetensors"] = None
        sys.path.insert(0, {str(REPO)!r})
        for name in {mods!r} + ["chip_smoke"]:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if (m == "jax" or m.startswith(("jax.", "jaxlib", "magicdec_tpu.",
                                               "safetensors")))
               and sys.modules[m] is not None]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from magicdec_tpu_torch import train
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.models import glide, llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("test-tiny")
    params = llama.init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, batch_size=1, max_len=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.params_from_numpy({"w": params["norm"].numpy()})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        glide.init_glide_params(cfg)
    assert glide.init_glide_params(cfg, device="cpu")["wqkv"].device.type == "cpu"
    data = np.ones((4, 16), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(cfg, data, steps=2, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train_glide(params, cfg, data, steps=2, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train._target_last_kv(params, cfg,
                              torch.ones((1, 8), dtype=torch.int32))
    # an explicit CPU request is honoured
    assert Engine(cfg, params, batch_size=1, max_len=128,
                  device="cpu").device.type == "cpu"


def test_serve_and_offload_raise_without_a_gpu(monkeypatch):
    """ServeEngine, the offload entry points and ClusterLRU run on the card
    unless given device='cpu'; with no GPU and no device they raise."""
    from magicdec_tpu_torch.engine import offload
    from magicdec_tpu_torch.engine.serve import ServeEngine
    from magicdec_tpu_torch.engine.wave_buffer import HostBlockStore
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("test-tiny")
    params = llama.init_params(cfg, device="cpu")
    HD = cfg.n_kv_head * cfg.head_dim
    store = HostBlockStore(cfg.n_layer, 1, 4, 32, HD, torch.float32)
    tokens = np.ones((1, 128), np.int32)
    kw = dict(n_clusters=4, cap=32, tail_keep=32)
    state, buffer0 = offload.offload_prefill(params, cfg, store, tokens,
                                             device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params, batch_size=1, max_len=256, draft_budget=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offload.offload_prefill(params, cfg, store, tokens, **kw)
    gen = dict(nprobe=2, cap=32)
    for fn in (offload.offload_generate, offload.offload_generate_hostloop):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(params, cfg, state, store, buffer0, 4, **gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offload.offload_generate_spec(params, cfg, state, store, buffer0, 4,
                                      gamma=2, **gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offload.ClusterLRU(store, 8)
    # an explicit CPU request is honoured
    srv = ServeEngine(cfg, params, batch_size=1, max_len=256,
                      draft_budget=64, device="cpu")
    assert srv.frame.device.type == srv.stage.device.type == "cpu"
    out, _ = offload.offload_generate(params, cfg, state, store, buffer0, 4,
                                      device="cpu", **gen)
    assert out.shape == (1, 4) and out.device.type == "cpu"


def test_checkpoint_loading_raises_without_a_gpu(monkeypatch, tmp_path):
    """load_hf_checkpoint and params_from_hf_state_dict run on the card
    unless given device='cpu'; with no GPU they raise before reading a
    file."""
    from magicdec_tpu_torch.checkpoint import convert_hf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_hf.load_hf_checkpoint(tmp_path / "llama-3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_hf.params_from_hf_state_dict({}, None)
    with pytest.raises(FileNotFoundError):
        convert_hf.load_hf_checkpoint(tmp_path / "llama-3.2-1b", device="cpu")


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    res = _run_smoke(REPO)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
