"""The port's Trainer refuses every config knob whose JAX behaviour it has
not ported, rather than running a different job without a word; since
elastic scale-up (Queue A8b-ii) no knob of this table is refused: the
defaults (and ``data_axis_size = -1``, all of one device) still train, as
does each knob ported since it was refused (elastic membership among them:
on one process its controller is inactive). A mesh axis wider than the
ranks present is refused as the JAX ``make_mesh`` refuses it (the mesh
itself is ported)."""

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.resilience import Chaos
from crosscoder_tpu_torch.train.trainer import Trainer

BASE = dict(d_in=16, dict_size=64, batch_size=8, num_tokens=16, log_backend="null")
# one process, no process group: a 2-wide axis does not fit one rank
_MESH_WIDER_THAN_WORLD = {"model_axis_size": (ValueError, "must divide device count 1"),
                          "data_axis_size": (ValueError, "mesh 2x1 != 1 devices")}
# knobs this table refused before their port; each now trains
_PORTED_SINCE = {"shard_sources", "harvest_timeout_s", "profile_dir", "profile_steps", "obs",
                 "chaos", "elastic"}


@pytest.mark.parametrize("knob,value", [
    ("harvest_timeout_s", 30.0),
    ("profile_dir", "/nonexistent/profile"),
    ("profile_steps", "3:5"),
    ("model_axis_size", 2),
    ("data_axis_size", 2),
    ("shard_sources", True),
    ("obs", "on"),
    ("chaos", "stall@1:0.01,nan@9"),
    ("elastic", "on"),
])
def test_unported_knob_raises(knob, value, tmp_path):
    extra = {"obs_dir": str(tmp_path)} if knob == "obs" else {}
    cfg = CrossCoderConfig(**BASE, **{knob: value}, **extra)
    if knob in _PORTED_SINCE:       # shard_sources on one device: the whole source axis on it
        tr = Trainer(cfg, device="cpu", chaos=Chaos.from_cfg_env(cfg))
        try:
            for _ in range(2):
                assert torch.isfinite(tr.step()["loss"])
        finally:
            tr.close()
        return
    exc, match = _MESH_WIDER_THAN_WORLD.get(knob, (NotImplementedError,
                                                   f"cfg.{knob} is not ported"))
    with pytest.raises(exc, match=match):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"data_axis_size": -1}, {"data_axis_size": 1},
                                {"model_axis_size": 1}, {"prefetch": False},
                                {"remat": True}, {"compile_cache_dir": "unused"}])
def test_defaults_and_speed_only_knobs_construct(kw):
    tr = Trainer(CrossCoderConfig(**BASE, **kw), device="cpu")
    assert torch.isfinite(tr.step()["loss"])


@pytest.mark.parametrize("kw", [
    {"guard_loss": True},
    {"resample_every": 2, "aux_dead_steps": 1},
    {"activation": "topk", "topk_k": 4, "l1_coeff": 0.0, "sparse_decode": True},
    {"activation": "jumprelu", "l0_coeff": 0.1},
], ids=["guard_loss", "resample_every", "sparse_decode", "jumprelu_l0"])
def test_ported_recovery_and_numerics_knobs_construct_and_step(kw):
    tr = Trainer(CrossCoderConfig(**BASE, **kw), device="cpu")
    for _ in range(3):
        assert torch.isfinite(tr.step()["loss"])
