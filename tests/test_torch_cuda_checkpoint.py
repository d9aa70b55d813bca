"""The tail on the card: an HF checkpoint directory loaded to the GPU, and
PhaseClock's synchronisation.

Marked `cuda` and skipped without an NVIDIA GPU. This file imports torch
and the port only (the card's machine has neither JAX nor the safetensors
package: the directory is written by chip_smoke's own writer); run it
there with
`python -m pytest tests/test_torch_cuda_checkpoint.py -q -m cuda --noconftest`.
"""

import pytest
import torch

import chip_smoke
from magicdec_tpu_torch.checkpoint.convert_hf import load_hf_checkpoint
from magicdec_tpu_torch.checkpoint.store import flatten_params
from magicdec_tpu_torch.models import llama
from magicdec_tpu_torch.models.config import ModelArgs
from magicdec_tpu_torch.utils.profiling import PhaseClock


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it loads weights onto the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_loads_sharded_safetensors_and_phase_clock_syncs(
        cuda, tmp_path, monkeypatch):
    cfg = ModelArgs.from_name("test-tiny")
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, device=cuda)
    d = tmp_path / "test-tiny"
    chip_smoke.write_hf_dir(torch, d, chip_smoke.hf_state_dict(
        torch, params, cfg), shards=3)
    assert len(list(d.glob("*.safetensors"))) == 3

    # no config, no device: the directory's name and the current card
    loaded, got_cfg = load_hf_checkpoint(d)
    assert got_cfg == cfg
    want, got = flatten_params(params), flatten_params(loaded)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].device == cuda and got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key

    synced = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: (synced.append(device),
                                             sync(device)))
    clock = PhaseClock()
    with clock.phase("card", sync_on={"w": [loaded["norm"]], "x": None}):
        loaded["norm"].float().sum()
    assert synced == [cuda]
    with clock.phase("host", sync_on=torch.ones(2)):
        pass
    assert synced == [cuda] and clock.counts == {"card": 1, "host": 1}

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hf_checkpoint(d)
