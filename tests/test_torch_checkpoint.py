"""The port's checkpoints (crosscoder_tpu_torch/checkpoint/), mirroring
tests/test_checkpoint.py for what this package ports: the versioned
layout, bit-exact resume, background saves, torn and corrupt saves,
retention, strict restore, bf16 masters, the meta, the reference ``.pt``
layout; and interop with the JAX package's Checkpointer both ways.

Bars: resume and every cross-package leaf bitwise; the port's 5 steps from
a JAX save against the JAX Trainer's 5 under the Lyapunov bar of
tests/test_torch_trainer.py (twice a control trainer's divergence from a
1e-6 relative W_enc perturbation, plus 1e-6·|loss|)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.checkpoint import torch_compat as jtc
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import crosscoder as jcc
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.checkpoint import ckpt, torch_compat
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils.dtypes import dtype_of

BASE = dict(d_in=16, dict_size=64, batch_size=64, num_tokens=64 * 100, enc_dtype="fp32",
            lr=1e-3, l1_coeff=0.1, log_backend="null", prefetch=False)
TOPK = dict(activation="topk", topk_k=8, l1_coeff=0.0, sparse_bwd="on", fused_encoder="off",
            aux_k=16, aux_dead_steps=2, aux_every=2, aux_mask_every=2, aux_exact_rank=True)


@pytest.fixture(autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _cfg(tmp_path, **kw):
    return CrossCoderConfig(**{**BASE, "checkpoint_dir": str(tmp_path), **kw})


def _trainer(cfg, **kw):
    return Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", **kw)


def _leaves(state):
    """The state's leaves as numpy, keyed as on disk (bf16 as V2)."""
    return {k: ckpt._numpy(v) for k, v in ckpt.flatten_state(state).items()}


def _assert_leaves_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype.itemsize == b[k].dtype.itemsize, k
        assert np.shape(a[k]) == np.shape(b[k]), k
        np.testing.assert_array_equal(np.asarray(a[k]).reshape(-1).view(np.uint8),
                                      np.asarray(b[k]).reshape(-1).view(np.uint8), err_msg=k)


def test_versioned_layout(tmp_path):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    tr.save()
    vdir = tmp_path / "version_0"
    for v in (0, 1):
        for name in (f"{v}.npz", f"{v}_cfg.json", f"{v}_train_state.npz", f"{v}_meta.json"):
            assert (vdir / name).exists(), name
    tr2 = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr2.save()
    assert (tmp_path / "version_1" / "0.npz").exists()
    assert CrossCoderConfig.from_json(vdir / "0_cfg.json") == cfg
    with np.load(vdir / "0.npz") as z:
        assert sorted(z.files) == ["W_dec", "W_enc", "b_dec", "b_enc"]
        assert all(z[k].dtype == np.float32 for k in z.files)
    assert not list(vdir.glob("*.tmp"))


@pytest.mark.parametrize("kw", [{}, TOPK], ids=["relu", "topk_auxk"])
def test_resume_is_bit_exact(tmp_path, kw):
    """10 steps, save, 5 more; against restore + 5: every leaf the same."""
    cfg = _cfg(tmp_path, **kw)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    for _ in range(10):
        tr.step()
    tr.save()
    for _ in range(5):
        tr.step()
    tr2 = _trainer(cfg, checkpointer=Checkpointer(base_dir=tmp_path))
    meta = tr2.restore()
    assert meta["step"] == 10 and tr2.step_counter == 10 and tr2.buffer.counter == 10
    for _ in range(5):
        tr2.step()
    _assert_leaves_equal(_leaves(tr.state), _leaves(tr2.state))
    if kw:
        assert set(tr2.state.aux) == {"steps_since_fired", "dead_mask"}


def test_background_save_lands_and_resumes(tmp_path, monkeypatch):
    """The writer thread serializes the state as it was at the save, while
    steps go on (slowed here so a view of live tensors would lose the race)."""
    import time

    real = ckpt._atomic_savez
    monkeypatch.setattr(ckpt, "_atomic_savez", lambda p, a: (time.sleep(0.2), real(p, a))[1])
    cfg = _cfg(tmp_path)
    ck = Checkpointer(cfg=cfg)
    tr = _trainer(cfg, checkpointer=ck)
    for _ in range(3):
        tr.step()
    at_save = _leaves(tr.state)
    tr.save(background=True)
    for _ in range(4):
        tr.step()
    ck.wait()
    vdir = tmp_path / "version_0"
    assert json.loads((vdir / "0_meta.json").read_text())["step"] == 3
    assert not list(vdir.glob("*.tmp"))
    with np.load(vdir / "0_train_state.npz") as z:
        _assert_leaves_equal(at_save, {k: z[k] for k in z.files})
    tr.save(background=True)                   # restore on the same instance waits for it
    tr2 = _trainer(cfg, checkpointer=ck)
    assert tr2.restore()["step"] == 7
    tr.close()
    tr2.close()


def test_background_write_error_raises_on_wait(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path)
    ck = Checkpointer(cfg=cfg)
    tr = _trainer(cfg, checkpointer=ck)
    tr.step()

    def broken(path, arrays):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_atomic_savez", broken)
    tr.save(background=True)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    assert Checkpointer.complete_saves(tmp_path / "version_0") == []


def test_torn_save_is_skipped(tmp_path):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    vdir = tmp_path / "version_0"
    (vdir / "1.npz").write_bytes((vdir / "0.npz").read_bytes())       # torn: no meta
    assert Checkpointer.latest_save(vdir) == 0
    assert _trainer(cfg, checkpointer=Checkpointer(base_dir=tmp_path)).restore()["step"] == 1
    # a fresh run killed in its first save: fall back to version_0
    v1 = tmp_path / "version_1"
    v1.mkdir()
    (v1 / "0.npz").write_bytes((vdir / "0.npz").read_bytes())
    (v1 / "0_train_state.npz").write_bytes((vdir / "0_train_state.npz").read_bytes())
    assert _trainer(cfg, checkpointer=Checkpointer(base_dir=tmp_path)).restore()["step"] == 1
    with pytest.raises(FileNotFoundError, match="torn"):
        Checkpointer.latest_save(v1)
    with pytest.raises(FileNotFoundError, match="complete"):
        Checkpointer(base_dir=tmp_path).restore(cfg, version_dir=v1, device="cpu")


def test_corrupt_checksum_falls_back_to_older_save(tmp_path, capsys):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    tr.step()
    tr.save()
    vdir = tmp_path / "version_0"
    blob = bytearray((vdir / "1_train_state.npz").read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (vdir / "1_train_state.npz").write_bytes(bytes(blob))
    assert not Checkpointer.verify_save(vdir, 1) and Checkpointer.verify_save(vdir, 0)
    ck = Checkpointer(base_dir=tmp_path)
    state, meta = ck.restore(cfg, device="cpu")
    assert meta["step"] == 1 and state.step == 1 and ck.save_version == 1
    assert "failed checksum verification" in capsys.readouterr().err
    with pytest.raises(ValueError, match="checksum"):
        Checkpointer(base_dir=tmp_path).restore(cfg, version_dir=vdir, save=1, device="cpu")


def test_keep_saves_and_discard_after(tmp_path):
    cfg = _cfg(tmp_path, keep_saves=2)
    ck = Checkpointer(cfg=cfg)
    tr = _trainer(cfg, checkpointer=ck)
    for _ in range(4):
        tr.step()
        tr.save(background=True)
    tr.close()
    vdir = tmp_path / "version_0"
    assert Checkpointer.complete_saves(vdir) == [2, 3]
    assert sorted(p.name for p in vdir.iterdir()) == sorted(
        f"{v}{s}" for v in (2, 3) for s in (".npz", "_cfg.json", "_train_state.npz", "_meta.json"))
    ck.discard_saves_after(vdir, 2)
    assert Checkpointer.complete_saves(vdir) == [2]


def test_restore_rejects_mismatched_shapes_and_missing_leaves(tmp_path):
    cfg = _cfg(tmp_path, **TOPK)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    vdir = tmp_path / "version_0"
    with pytest.raises(ValueError, match="shape"):
        Checkpointer(base_dir=tmp_path).restore(cfg.replace(dict_size=128), device="cpu")
    with pytest.raises(ValueError, match="leaves but state expects"):
        Checkpointer(base_dir=tmp_path).restore(cfg.replace(aux_mask_every=1), device="cpu")
    with np.load(vdir / "0_train_state.npz") as z:
        leaves = {k: z[k] for k in z.files}
    leaves[".opt_state[0].mu['W_enc']"] = leaves.pop(".opt_state[1].mu['W_enc']")
    with pytest.raises(ValueError, match="missing state leaf"):
        ckpt.unflatten_state(leaves, cfg, device="cpu")
    leaves[".opt_state[1].mu['W_enc']"] = leaves.pop(".opt_state[0].mu['W_enc']")
    leaves[".opt_state[2].count"] = np.array(7, np.int32)
    with pytest.raises(ValueError, match="schedule count"):
        ckpt.unflatten_state(leaves, cfg, device="cpu")


def test_bf16_master_checkpoint_round_trip(tmp_path):
    cfg = _cfg(tmp_path, enc_dtype="bf16", master_dtype="bf16")
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    with np.load(tmp_path / "version_0" / "0_train_state.npz") as z:
        assert z[".params['W_enc']"].dtype == np.dtype("V2")
        assert z[".opt_state[1].nu['b_dec']"].dtype == np.dtype("V2")
    state, _ = Checkpointer(base_dir=tmp_path).restore(cfg, device="cpu")
    assert state.params["W_enc"].dtype == torch.bfloat16
    _assert_leaves_equal(_leaves(state), _leaves(tr.state))


def test_meta_records_step_and_buffer(tmp_path):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    for _ in range(3):
        tr.step()
    tr.save()
    vdir = tmp_path / "version_0"
    meta = json.loads((vdir / "0_meta.json").read_text())
    assert meta["step"] == 3 and meta["buffer"] == {"counter": 3}
    assert meta["save_version"] == 0 and meta["format"] == "crosscoder_tpu/v1"
    assert set(meta["checksums"]) == {"0.npz", "0_cfg.json", "0_train_state.npz"}


def test_load_weights_analysis_path(tmp_path):
    cfg = _cfg(tmp_path)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    tr.step()
    tr.save()
    params, loaded = Checkpointer.load_weights(tmp_path / "version_0", device="cpu")
    assert set(params) == {"W_enc", "W_dec", "b_enc", "b_dec"}
    assert params["W_enc"].shape == (2, cfg.d_in, cfg.dict_size) and loaded.d_in == cfg.d_in
    for k, v in params.items():
        assert torch.equal(v, tr.state.params[k])


@pytest.mark.parametrize("enc_dtype", ["bf16", "fp32"])
def test_torch_compat_round_trips_and_matches_jax(tmp_path, enc_dtype):
    cfg = CrossCoderConfig(d_in=16, dict_size=64, enc_dtype=enc_dtype)
    params = cc.init_params(cfg.replace(enc_dtype="fp32"), seed=3, device="cpu")
    sd = torch_compat.params_to_torch_state_dict(params, cfg)
    jsd = jtc.params_to_torch_state_dict({k: v.numpy() for k, v in params.items()},
                                         JCfg(d_in=16, dict_size=64, enc_dtype=enc_dtype))
    for k in ("W_enc", "W_dec", "b_enc", "b_dec"):
        assert sd[k].dtype == jsd[k].dtype and sd[k].device.type == "cpu"
        assert torch.equal(sd[k], jsd[k])
    assert tuple(sd["W_enc"].shape) == (2, 16, 64) and tuple(sd["W_dec"].shape) == (64, 2, 16)
    path = tmp_path / "cc_weights.pt"
    torch_compat.save_torch_checkpoint(params, cfg, path)
    back = torch_compat.load_torch_checkpoint(path, cfg, device="cpu")
    want = jtc.load_torch_checkpoint(path, JCfg(d_in=16, dict_size=64, enc_dtype=enc_dtype))
    for k in params:
        assert back[k].dtype == dtype_of(enc_dtype)
        np.testing.assert_array_equal(back[k].float().numpy(),
                                      np.asarray(want[k], np.float32), err_msg=k)
        assert torch.equal(back[k].float(), params[k].to(back[k].dtype).float())


# ---------------------------------------------------------------------------
# interop with the JAX package's Checkpointer

INTEROP = dict(d_in=64, n_models=2, dict_size=512, batch_size=32, num_tokens=32 * 20,
               enc_dtype="fp32", log_backend="null", prefetch=False, seed=7, lr=5e-3,
               dec_init_norm=0.5, **{**TOPK, "aux_mask_every": 1})


def _jax_trainer(cfg, **kw):
    return jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(devices=jax.devices()[:1]),
                            **kw)


def _jax_leaves(state):
    paths = jax.tree_util.tree_flatten_with_path(jax.device_get(state))[0]
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in paths}


@pytest.mark.parametrize("kw", [dict(aux_mask_every=2), dict(aux_k=0), {}],
                         ids=["dead_mask", "no_aux", "aux"])
def test_train_state_keys_are_the_jax_saves(tmp_path, kw):
    jcfg = JCfg(**{**INTEROP, **kw, "checkpoint_dir": str(tmp_path / "j")})
    jtr = _jax_trainer(jcfg, checkpointer=JCheckpointer(cfg=jcfg))
    jtr.save()
    jtr.close()
    with np.load(tmp_path / "j" / "version_0" / "0_train_state.npz") as z:
        want = {k: (z[k].shape, z[k].dtype) for k in z.files}
    cfg = CrossCoderConfig(**{**INTEROP, **kw})
    spec = ckpt.state_spec(cfg)
    assert set(spec) == set(want)
    for k, (shape, dtype) in spec.items():
        assert shape == want[k][0], k
        assert torch.empty(0, dtype=dtype).numpy().dtype == want[k][1], k


def test_jax_save_restores_in_port_and_trains_like_jax(tmp_path):
    jcfg = JCfg(**{**INTEROP, "checkpoint_dir": str(tmp_path)})
    jtr = _jax_trainer(jcfg, checkpointer=JCheckpointer(cfg=jcfg))
    for _ in range(4):
        jtr.step()
    jtr.save()
    cfg = CrossCoderConfig(**{**INTEROP, "checkpoint_dir": str(tmp_path)})
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    meta = tr.restore()
    assert meta["step"] == 4 and tr.step_counter == 4 and tr.buffer.counter == 4
    _assert_leaves_equal(_leaves(tr.state), _jax_leaves(jtr.state))
    # control: the JAX trainer from the same save, W_enc perturbed by 1e-6
    ctl = _jax_trainer(jcfg, checkpointer=JCheckpointer(base_dir=tmp_path))
    ctl.restore()
    noise = np.random.default_rng(11).standard_normal((2, 64, 512)).astype(np.float32) * 1e-6
    p = dict(ctl.state.params)
    p["W_enc"] = jnp.asarray(np.asarray(p["W_enc"]) * (1 + noise))
    ctl.state = jax.device_put(ctl.state._replace(params=p), ctl._state_shardings)
    want = np.array([float(jtr.step()["loss"]) for _ in range(5)])
    got = np.array([float(tr.step()["loss"]) for _ in range(5)])
    control = np.array([float(ctl.step()["loss"]) for _ in range(5)])
    jtr.close()
    ctl.close()
    assert np.isfinite(got).all()
    bar = 2 * np.abs(control - want) + 1e-6 * np.abs(want)
    assert (np.abs(got - want) <= bar).all(), (got - want, bar)


@pytest.mark.parametrize("master_dtype", ["fp32", "bf16"])
def test_port_save_restores_in_jax(tmp_path, master_dtype):
    kw = {**INTEROP, "master_dtype": master_dtype, "aux_mask_every": 2,
          "checkpoint_dir": str(tmp_path)}
    cfg = CrossCoderConfig(**kw)
    tr = _trainer(cfg, checkpointer=Checkpointer(cfg=cfg))
    for _ in range(3):
        tr.step()
    tr.save()
    vdir = JCheckpointer.latest_version_dir(tmp_path)
    assert JCheckpointer.verify_save(vdir, 0)
    jcfg = JCfg(**kw)
    jtr = _jax_trainer(jcfg, checkpointer=JCheckpointer(base_dir=tmp_path))
    meta = jtr.restore()
    assert meta["step"] == 3 and jtr.step_counter == 3 and jtr.buffer.counter == 3
    _assert_leaves_equal(_jax_leaves(jtr.state), _leaves(tr.state))
    params, loaded = JCheckpointer.load_weights(vdir)
    assert loaded.dict_size == cfg.dict_size
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(v), tr.state.params[k].float().numpy())
    jtr.close()
