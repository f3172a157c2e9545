"""The mesh's last refusals lifted, on gloo ranks, against the JAX package
on its 8-device CPU mesh and against the port's own single-device runs.

One launch of 8 gloo ranks (``tests/_torch_parallel_child.py``, kind
``mesh_rest``; the rank work in ``tests/_torch_mesh_rest_child.py``) runs
every case while the JAX oracles and the single-device runs compute here:

- the refill overlap where collectives run: the mesh-sharded stores (bf16
  and int8 through K11) at ``data`` 2 and 4 over a stubbed harvest, a
  ``shard_lm`` harvest (4 × 2) and a ``seq_shards`` 2 harvest of the tiny
  LMs: no dispatcher thread, each rank's served stream byte-identical to
  overlap off, the global stream bitwise JAX's mesh store with the overlap
  on (``tests/test_refill_overlap.py:130-145``);
- the paged harvest over tensor-parallel params at ``model`` 2 and 4 in
  f32: against the port's padded TP harvest on the valid positions and
  against JAX's paged harvest over ``shard_params_tp`` params (at
  ``model`` 2: it does not depend on the width beyond rounding), 1e-5;
- head counts the model axis does not divide: the TP forward (logits and
  capture) and the paged harvest at ``model`` 8 with 4 heads on 2 KV heads
  and with Gemma-2-2B's ratio, 8 on 4, against JAX's TP forward and paged
  harvest on 8 devices, rtol 1e-4 / atol 1e-5;
- the mesh trainer's knobs on 1 × 2, 2 × 1 and 2 × 2 grids (and the fused
  tiers and ``sparse_decode`` under ``shard_sources`` on 1 × 2): fused TopK
  (K2's plain version), ``quant_encoder`` (K3's), fused BatchTopK (K4's
  select, count and emit), ``sparse_decode``, resampling (the same drawn
  rows handed to both packages) and the loss guard (a NaN serve, one
  rollback past a poisoned save), against the JAX mesh trainer on 2 × 2
  devices (the fused
  legs: its ``fused_encoder="off"`` tiers, which its fused kernels equal
  bitwise, so no Pallas interpret mode runs under GSPMD; ``quant_encoder``
  has no such twin and is held to the port's single-device run alone,
  which ``tests/test_torch_fused_topk_int8.py`` holds to JAX) and against
  the port's single-device Trainer, rtol 2e-4 / atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import paged_attention as jpa
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.resilience.chaos import Chaos
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.checkpoint import Checkpointer
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.train import resample
from crosscoder_tpu_torch.train.trainer import Trainer

from _torch_harvest_child import Stub
from _torch_mesh_rest_child import PoisonedSource
from _torch_parallel_child import finish_ranks, start_ranks

TP_RTOL, TP_ATOL = 1e-4, 1e-5
PAGED_TOL = 1e-5
RTOL, ATOL = 2e-4, 2e-5
STORE = dict(kw=dict(batch_size=32, buffer_mult=16, seq_len=17, d_in=32, n_models=2,
                     model_batch_size=4, norm_calib_batches=2,
                     hook_point="blocks.2.hook_resid_pre", seed=3, quant_block=16),
             vocab=257, serves=10)          # 8 serves a cycle: a shadow cycle swaps in
LM_STORE = dict(d_in=32, n_models=2, batch_size=16, buffer_mult=8, seq_len=17,
                model_batch_size=8, norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre",
                buffer_device="hbm")
LM_SERVES = 10                              # 4 serves a cycle
HOOKS = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out")
PAGE, S = 8, 16
LENGTHS = [16, 5, 11, 1, 16, 9]
TP8_HEADS = {"h4kv2": (4, 2), "h8kv4": (8, 4)}
STEPS = 5
BASE = dict(d_in=16, n_models=2, dict_size=64, batch_size=32, num_tokens=32 * STEPS,
            enc_dtype="fp32", log_backend="null", prefetch=False, seed=7, lr=5e-3,
            dec_init_norm=0.5)
_TOPK = dict(activation="topk", topk_k=4, l1_coeff=0.0)
CONFIGS = {
    "fused_topk": dict(_TOPK, sparse_bwd="on", fused_encoder="on"),
    "quant": dict(_TOPK, sparse_bwd="on", fused_encoder="on", quant_encoder=True, d_in=64,
                  quant_block=128),
    "fused_bt": dict(activation="batchtopk", topk_k=4, l1_coeff=0.0, fused_encoder="on"),
    "sparse_decode": dict(_TOPK, sparse_decode=True),
    "resample": dict(_TOPK, topk_k=2, resample_every=3, resample_dead_steps=1),
    "guard": dict(activation="relu", l1_coeff=0.1, num_tokens=32 * 8, guard_loss=True,
                  log_every=2, save_every=2, max_rollbacks=2),
}
# the JAX oracle of each config: a fused tier's dense twin
JAX_CONFIG = {"fused_topk": dict(fused_encoder="off"), "fused_bt": dict(fused_encoder="off")}
# the NaN lands in step 3, before the save after it: the rollback skips that
# poisoned save for the one before it, agreed over the ranks
NAN_SERVES = (3,)
GRIDS = ((1, 2), (2, 1), (2, 2))
LEGS = ([(name, g, False) for name in CONFIGS for g in GRIDS]
        + [(name, (1, 2), True) for name in ("fused_topk", "quant", "fused_bt",
                                              "sparse_decode")])


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    jpa.set_interpret(False)            # the JAX paged path's XLA attention
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


# ---------------------------------------------------------------------------
# the JAX side


def _stub_jax(mp, stub):
    mp.setattr(jbuf.PairedActivationBuffer, "_harvest_dev",
               lambda self, p: jnp.asarray(stub(p)).astype(jnp.bfloat16))
    mp.setattr(jbuf.PairedActivationBuffer, "_harvest_job",
               lambda self, p: jbuf._SingleDispatchJob(self._harvest_dev(p)))
    mp.setattr(jbuf.PairedActivationBuffer, "_segs_per_chunk", lambda self: 1)


def _u16(x):
    return np.asarray(x).view(np.uint16)


def _jax_overlap_streams(tokens):
    """JAX's mesh store with the overlap on, over the stub, at ``data`` 2
    and 4, bf16 and int8: the raw global serves."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stub_jax(mp, Stub(2, STORE["kw"]["d_in"], STORE["vocab"], STORE["kw"]["seq_len"]))
        for n in (2, 4):
            sh = NamedSharding(jmesh.make_mesh(n, 1, devices=jax.devices()[:n]),
                               P("data", None))
            for quant in (False, True):
                cfg = JCfg(**STORE["kw"], buffer_device="hbm", quant_buffer=quant,
                           refill_overlap="on")
                jb = jbuf.make_buffer(cfg, None, [{}, {}], tokens, batch_sharding=sh)
                assert "Mesh" in type(jb).__name__ and jb._dispatcher is None
                out[(n, quant)] = ([_u16(jb.next_raw()) for _ in range(STORE["serves"])],
                                   jb.state_dict())
                jb.close()
    return out


def _tp_mesh(m):
    return JMesh(np.array(jax.devices()[:m]).reshape(1, m), ("data", "model"))


def _lm_params(lcfg, seed):
    """Tiny LM params as numpy leaves (the port's init), for both packages."""
    p = lm.init_params(lcfg, seed=seed, device="cpu")
    return {k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict) else v.numpy())
            for k, v in p.items()}


def _jax_paged_tp(jparams, lcfg, tokens, lengths, m):
    tp = [jlm.shard_params_tp(jax.tree_util.tree_map(jnp.asarray, p), _tp_mesh(m))
          for p in jparams]
    return np.asarray(jlm.run_with_cache_multi_paged(tp, tokens, lengths, lcfg, HOOKS,
                                                     page_size=PAGE), np.float32)


def _jax_tp8(jp, lcfg, toks):
    tp = jlm.shard_params_tp(jax.tree_util.tree_map(jnp.asarray, jp), _tp_mesh(8))
    logits, cache = jax.jit(lambda p, t: jlm.forward(p, t, lcfg, capture=HOOKS))(
        tp, jnp.asarray(toks))
    return np.asarray(logits), {k: np.asarray(v) for k, v in cache.items()}


def _jcfg(name, **kw):
    return JCfg(**{**BASE, **CONFIGS[name], **JAX_CONFIG.get(name, {}), "aux_exact_rank": True,
                   "data_axis_size": 2, "model_axis_size": 2, **kw})


def _jax_trainer(name, tmp):
    if name == "guard":
        cfg = _jcfg(name, checkpoint_dir=str(tmp / "jax_guard"))
        return jtrainer.Trainer(cfg, JSource(cfg), mesh=jmesh.make_mesh(
            2, 2, devices=jax.devices()[:4]), checkpointer=JCheckpointer(cfg=cfg),
            chaos=Chaos.parse(",".join(f"nan@{s}" for s in NAN_SERVES)))
    # quant: the state alone (the dense twin's init is the same)
    cfg = _jcfg(name, **(dict(quant_encoder=False, fused_encoder="off") if name == "quant"
                         else {}))
    return jtrainer.Trainer(cfg, JSource(cfg),
                            mesh=jmesh.make_mesh(2, 2, devices=jax.devices()[:4]))


def _jax_train(name, tr, ridx):
    """The JAX oracle's steps' losses and final params (``quant``: none)."""
    if name == "quant":
        tr.close()
        return None
    if name == "guard":
        out = tr.train()
        res = {"steps": [{"loss": out["loss"]}], "step": tr.step_counter,
               "resilience": tr.resilience.snapshot()}
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "categorical",
                       lambda key, logits, shape=None: jnp.asarray(ridx, jnp.int32))
            steps = []
            for _ in range(STEPS):
                m = tr.step()
                steps.append({k: float(jax.device_get(m[k])) for k in ("loss", "resampled")
                              if k in m})
        res = {"steps": steps}
    res["params"] = {k: np.asarray(v, np.float32)
                     for k, v in jax.device_get(tr.state.params).items()}
    tr.close()
    return res


# ---------------------------------------------------------------------------
# the port's single-device runs


def _single(name, state, tmp):
    cfg = CrossCoderConfig(**{**BASE, **CONFIGS[name]})
    if cfg.guard_loss:
        cfg = cfg.replace(checkpoint_dir=str(tmp / "single_guard"))
        tr = Trainer(cfg, PoisonedSource(SyntheticActivationSource(cfg), NAN_SERVES),
                     device="cpu", state=state, checkpointer=Checkpointer(cfg=cfg))
        out = tr.train()
        res = {"steps": [{"loss": out["loss"]}], "step": tr.step_counter,
               "resilience": tr.resilience.snapshot(), "serves": tr._serve_count}
    else:
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", state=state)
        res = {"steps": [{k: float(v) for k, v in tr.step().items()
                          if not torch.is_tensor(v) or v.dim() == 0} for _ in range(STEPS)]}
    res["params"] = {k: v.float().numpy() for k, v in tr.state.params.items()}
    return res


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the launch, and what the port is held to, computed here
    while the ranks run."""
    tmp = tmp_path_factory.mktemp("mesh_rest")
    rng = np.random.default_rng(0)
    lcfg = jlm.LMConfig.tiny()
    jparams = [_lm_params(lm.LMConfig.tiny(), i) for i in (0, 1)]
    tp8_cfg = {name: dataclasses.replace(lcfg, n_heads=h, n_kv_heads=kv)
               for name, (h, kv) in TP8_HEADS.items()}
    tp8_params = {name: _lm_params(dataclasses.replace(lm.LMConfig.tiny(), n_heads=h,
                                                       n_kv_heads=kv), 5)
                  for name, (h, kv) in TP8_HEADS.items()}
    paged_tokens = rng.integers(1, 257, (len(LENGTHS), S))
    for d, n in enumerate(LENGTHS):
        paged_tokens[d, n:] = 0
    trainers = {name: _jax_trainer(name, tmp) for name in CONFIGS}
    states = {name: convert.train_state_from_numpy(jax.device_get(tr.state), device="cpu")
              for name, tr in trainers.items()}
    ridx = rng.integers(0, BASE["batch_size"], BASE["dict_size"])
    inputs = {
        "lm": [convert.lm_params_from_numpy(p, device="cpu") for p in jparams],
        "tp8": {k: convert.lm_params_from_numpy(p, device="cpu") for k, p in tp8_params.items()},
        "store_tokens": rng.integers(1, 257, (256, 17)),
        "paged_tokens": paged_tokens, "paged_lengths": np.asarray(LENGTHS),
        "tp_tokens": rng.integers(0, 257, (4, 24)), "states": states, "ridx": ridx,
    }
    path = tmp / "inputs.pt"
    torch.save(inputs, path)
    task = {"kind": "mesh_rest", "inputs": str(path), "store": STORE, "lm_store": LM_STORE,
            "lm_serves": LM_SERVES, "hooks": HOOKS, "page": PAGE, "tp8_heads": TP8_HEADS,
            "grids": GRIDS, "base": BASE, "configs": CONFIGS, "steps": STEPS,
            "nan_serves": NAN_SERVES, "ckpt_root": str(tmp / "ckpt"),
            "legs": [{"config": n, "grid": g, "shard_sources": s} for n, g, s in LEGS],
            "sections": ["overlap", "overlap_lm", "paged_tp", "tp8", "train"]}
    started = start_ranks(8, task, tmp / "r8")
    jax_res = {
        "overlap": _jax_overlap_streams(inputs["store_tokens"]),
        # one TP width: the JAX harvest does not depend on it beyond rounding
        "paged_tp": _jax_paged_tp(jparams, lcfg, paged_tokens, LENGTHS, 2),
        "tp8": {name: _jax_tp8(tp8_params[name], tp8_cfg[name], inputs["tp_tokens"])
                for name in TP8_HEADS},
        "tp8_paged": {name: _jax_paged_tp([tp8_params[name]], tp8_cfg[name], paged_tokens,
                                          LENGTHS, 8) for name in TP8_HEADS},
        "train": {name: _jax_train(name, tr, ridx) for name, tr in trainers.items()},
    }
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample, "_draw", lambda e2, n, generator: torch.as_tensor(ridx))
        single = {name: _single(name, states[name], tmp) for name in CONFIGS}
    ranks = finish_ranks(started, timeout=400)
    return dict(inputs=inputs, jax=jax_res, single=single, ranks=ranks)


# ---------------------------------------------------------------------------
# 4a: the refill overlap where collectives run


def _global(ranks, section, key, i):
    """Serve ``i`` as the global batch: the data ranks' rows in order
    (model replicas hold the same rows)."""
    by_rank = {}
    for res in ranks:
        got = res[section][key]
        if got["data_rank"] in by_rank:
            np.testing.assert_array_equal(by_rank[got["data_rank"]], got["raw"][i])
        by_rank[got["data_rank"]] = got["raw"][i]
    return np.concatenate([by_rank[r] for r in range(len(by_rank))])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_overlap_on_a_mesh_store_serves_the_overlap_off_and_the_jax_stream(case, n, quant):
    ranks = case["ranks"]
    on, off = (ranks[0]["overlap"][(n, quant, o)] for o in ("on", "off"))
    assert on["cls"] == ("QuantMeshPairedActivationBuffer" if quant
                         else "MeshPairedActivationBuffer")
    assert not on["thread"]                         # pumped inline, never a thread
    jraw, jstate = case["jax"]["overlap"][(n, quant)]
    for res in ranks:
        a, b = res["overlap"][(n, quant, "on")], res["overlap"][(n, quant, "off")]
        for i in range(STORE["serves"]):
            np.testing.assert_array_equal(a["raw"][i], b["raw"][i], err_msg=i)
        assert a["token_pointer"] == b["token_pointer"]
        assert a["state"]["token_pointer"] == b["state"]["token_pointer"] == \
            jstate["token_pointer"]
    for i in range(STORE["serves"]):
        np.testing.assert_array_equal(
            _global(ranks, "overlap", (n, quant, "on"), i).view(np.uint16), jraw[i],
            err_msg=i)
    assert on["state"]["rng_state"] == off["state"]["rng_state"]


@pytest.mark.parametrize("name", ["shard_lm", "seq_shards"])
def test_overlap_with_a_collective_harvest_serves_the_overlap_off_stream(case, name):
    for res in case["ranks"]:
        a, b = res["overlap_lm"][(name, "on")], res["overlap_lm"][(name, "off")]
        assert a["cls"] == "MeshPairedActivationBuffer" and not a["thread"]
        for i in range(LM_SERVES):
            np.testing.assert_array_equal(a["raw"][i], b["raw"][i], err_msg=i)
        assert a["state"]["token_pointer"] == b["state"]["token_pointer"]


# ---------------------------------------------------------------------------
# 4b: the paged harvest under shard_lm


def _valid(x):
    """Positions below each document's length."""
    return np.arange(S)[None, :] < np.asarray(LENGTHS)[:, None]


@pytest.mark.parametrize("m", [2, 4])
def test_paged_tp_harvest_matches_the_padded_and_the_jax_paged_one(case, m):
    want = case["jax"]["paged_tp"]
    valid = _valid(want)
    for res in case["ranks"]:
        got = res["paged_tp"][m]
        kd = lm.LMConfig.tiny().n_kv_heads * lm.LMConfig.tiny().head_dim
        assert got["wk"][-1] == kd // m                 # this rank's k/v width
        assert got["paged"].shape == want.shape == (len(LENGTHS), S, 4, 32)
        np.testing.assert_allclose(got["paged"], want, rtol=PAGED_TOL, atol=PAGED_TOL)
        np.testing.assert_allclose(got["paged"][valid], got["padded"][valid], rtol=PAGED_TOL,
                                   atol=PAGED_TOL)


# ---------------------------------------------------------------------------
# 4c: head counts the model axis does not divide


@pytest.mark.parametrize("name", sorted(TP8_HEADS))
def test_tp_over_8_ranks_with_heads_it_does_not_divide_matches_jax(case, name):
    logits, cache = case["jax"]["tp8"][name]
    paged = case["jax"]["tp8_paged"][name]
    h = TP8_HEADS[name][0]
    for res in case["ranks"]:
        got = res["tp8"][name]
        assert got["wq"][-1] == h * 8 // 8             # JAX's flat slice: h·hd / 8
        np.testing.assert_allclose(got["logits"], logits, rtol=TP_RTOL, atol=TP_ATOL)
        for hp in HOOKS:
            np.testing.assert_allclose(got["cache"][hp], cache[hp], rtol=TP_RTOL, atol=TP_ATOL,
                                       err_msg=hp)
        np.testing.assert_allclose(got["paged"], paged, rtol=TP_RTOL, atol=TP_ATOL)


# ---------------------------------------------------------------------------
# 5: the mesh trainer's knobs


def _close(got, want, what):
    for key in want["steps"][0]:
        np.testing.assert_allclose([s[key] for s in got["steps"]],
                                   [s[key] for s in want["steps"]], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {key}")
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {k}")
    for key in ("step", "resilience", "serves"):
        if key in want:
            assert got[key] == want[key], (what, key)


@pytest.mark.parametrize("name,grid,sources", LEGS, ids=[
    f"{n}-{g[0]}x{g[1]}{'-shard_sources' if s else ''}" for n, g, s in LEGS])
def test_mesh_trainer_knob_matches_jax_and_the_single_device_run(case, name, grid, sources):
    d, m = grid
    ranks = [res["train"][(name, d, m, sources)] for res in case["ranks"][:d * m]]
    single, want = case["single"][name], case["jax"]["train"][name]
    for r, got in enumerate(ranks):
        _close(got, single, f"rank {r} vs single device")
        if want is not None:
            _close(got, want, f"rank {r} vs JAX")
    if name == "resample":
        assert [s["resampled"] for s in single["steps"] if "resampled" in s] == \
            [s["resampled"] for s in want["steps"] if "resampled" in s]
        assert any(s.get("resampled", 0) > 0 for s in single["steps"])
    if name == "guard":
        assert single["resilience"]["resilience/rollbacks"] == 1
        assert single["resilience"]["resilience/poisoned_save_skips"] == 1
        assert want["step"] == single["step"] == 8
