"""The port's parallel harvest on gloo ranks against the JAX package on its
8-device CPU mesh.

One launch of 8 gloo ranks (``tests/_torch_parallel_child.py``, kind
``harvest``; the 2 × 4, 4 × 2 and 8 × 1 grids over the same ranks) runs
every case; the JAX side runs here:

- ring attention over 2, 4 and 8 ranks against JAX ``ring_attention``
  under ``shard_map`` on as many devices (``tests/test_ring_attention.py``
  shapes), rtol 1e-5 in f32; one shard against the dense reference;
- the sequence-parallel forward (logits, sub-layer hooks) and the
  multi-model harvest at 2 and 4 ranks against JAX's on a mesh of the
  same size, at the TP bar;
- the tensor-parallel LM at ``model`` 2 (forward with logits and capture,
  ``run_with_cache_multi``, ``ce_loss``) against JAX ``shard_params_tp``
  (``tests/test_scaleout.py``), rtol 1e-4 / atol 1e-5, and the
  CE-recovered eval on TP params against the whole params' at the same
  bar; the ``from_torch_state_dict(tp=)`` load bitwise the sliced whole
  load;
- the mesh-sharded stores (bf16 and int8) at ``data`` 2 and 4 over a
  stubbed harvest: the served global stream (every rank's rows, in data
  rank order) bitwise the port's one-rank device store and JAX's
  ``MeshPairedActivationBuffer``/``QuantMeshPairedActivationBuffer``,
  through a mid-cycle save and restore; a ``shard_lm`` buffer's stream
  and a ``seq_shards`` buffer's against the dense one at JAX's bf16 bar
  (rtol/atol 1e-2), the ``seq_shards`` one also against JAX's
  ``seq_shards`` buffer (``tests/test_buffer.py:386``) at the same bar;
- ``shard_sources`` training on the 2 × 4 grid (one source a rank)
  against the JAX mesh trainer (``tests/test_backends.py:168``,
  ``tests/test_auxk.py:208``) at rtol 2e-4 / atol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data import buffer as jbuf
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.models import lm as jlm
from crosscoder_tpu.ops import fused_encoder_topk as jfek
from crosscoder_tpu.ops import sparse_grad as jsg
from crosscoder_tpu.ops import topk_pallas as jtp
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.parallel import shard_map_compat as shard_map
from crosscoder_tpu.parallel.ring_attention import ring_attention as jring
from crosscoder_tpu.train import trainer as jtrainer
from crosscoder_tpu_torch import convert
from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data import buffer as buf
from crosscoder_tpu_torch.analysis import ce_eval
from crosscoder_tpu_torch.models import crosscoder as cc
from crosscoder_tpu_torch.models import lm
from crosscoder_tpu_torch.parallel.ring_attention import ring_attention

from _torch_harvest_child import Stub
from _torch_parallel_child import finish_ranks, start_ranks

TP_RTOL, TP_ATOL = 1e-4, 1e-5
SRC_RTOL, SRC_ATOL = 2e-4, 2e-5
RING = dict(scale=0.35, softcap=50.0, window=16)
SEQ_HOOKS = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out", "blocks.2.hook_mlp_out",
             "blocks.3.hook_resid_post")
MULTI_HOOKS = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out")
TP_HOOKS = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out", "blocks.2.hook_mlp_out")
STORE = dict(kw=dict(batch_size=32, buffer_mult=32, seq_len=17, d_in=32, n_models=2,
                     model_batch_size=4, norm_calib_batches=2,
                     hook_point="blocks.2.hook_resid_pre", seed=3, quant_block=16),
             vocab=257, n_first=12, n_after=10)
TP_STORE = dict(d_in=32, dict_size=64, n_models=2, batch_size=16, buffer_mult=8, seq_len=17,
                model_batch_size=8, norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre",
                num_tokens=16 * 6, enc_dtype="fp32", buffer_device="hbm", shard_lm=True,
                log_backend="null")
SEQ_STORE = dict(d_in=32, n_models=2, batch_size=16, buffer_mult=8, seq_len=16,
                 model_batch_size=4, norm_calib_batches=1, hook_point="blocks.2.hook_resid_pre",
                 buffer_device="hbm")
SOURCES = {   # tests/test_backends.py:168 and tests/test_auxk.py:208, data 2 x model 4
    "backends": dict(d_in=16, dict_size=64, n_models=2,
                     hook_points=("blocks.1.hook_resid_pre", "blocks.2.hook_resid_pre"),
                     batch_size=32, enc_dtype="fp32", log_backend="null", prefetch=False),
    "auxk": dict(d_in=16, dict_size=64, n_models=2, batch_size=32, num_tokens=32 * 1000,
                 enc_dtype="fp32", log_backend="null", aux_k=8, aux_dead_steps=1, l1_coeff=0.0,
                 activation="topk", topk_k=4,
                 hook_points=("blocks.1.hook_resid_pre", "blocks.2.hook_resid_pre"),
                 prefetch=False),
}
SOURCE_STEPS = 3
MAIN_STEPS = 3
CC_CFG = CrossCoderConfig(d_in=32, dict_size=64, batch_size=16, enc_dtype="fp32",
                          hook_point="blocks.2.hook_resid_pre")


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    for m in (jtp, jsg, jfek):
        m.set_interpret(True)
    yield
    for m in (jtp, jsg, jfek):
        m.set_interpret(False)


def _hf_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    D, F = cfg.d_model, cfg.d_ff
    qd, kd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.normal(size=(cfg.vocab_size, D)).astype(np.float32),
          "model.norm.weight": rng.normal(size=(D,)).astype(np.float32) * 0.1}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for name, shape in (("input_layernorm.weight", (D,)),
                            ("post_attention_layernorm.weight", (D,)),
                            ("pre_feedforward_layernorm.weight", (D,)),
                            ("post_feedforward_layernorm.weight", (D,)),
                            ("self_attn.q_proj.weight", (qd, D)),
                            ("self_attn.k_proj.weight", (kd, D)),
                            ("self_attn.v_proj.weight", (kd, D)),
                            ("self_attn.o_proj.weight", (D, qd)),
                            ("mlp.gate_proj.weight", (F, D)),
                            ("mlp.up_proj.weight", (F, D)),
                            ("mlp.down_proj.weight", (D, F))):
            sd[p + name] = (rng.normal(size=shape) * 0.2).astype(np.float32)
    return sd


def _jax_sources_trainer(name):
    cfg = JCfg(**SOURCES[name], data_axis_size=2, model_axis_size=4, shard_sources=True,
               aux_exact_rank=True)
    return jtrainer.Trainer(cfg, JSource(cfg),
                            mesh=jmesh.make_mesh(2, 4, devices=jax.devices()[:8]))


def _jax_sources_run(tr):
    steps = []
    for _ in range(SOURCE_STEPS):
        m = tr.step()
        steps.append({k: float(jax.device_get(m[k])) for k in ("loss", "aux_loss") if k in m})
    params = {k: np.asarray(v) for k, v in jax.device_get(tr.state.params).items()}
    aux = jax.device_get(tr.state.aux)
    since = None if aux is None else np.asarray(aux["steps_since_fired"])
    tr.close()
    return steps, params, since


def _jax_seq(jparams, toks, n):
    lcfg = jlm.LMConfig.tiny()
    toks = jnp.asarray(toks)

    @jax.jit                    # one program: the forward and the harvest share a compile
    def run(params, toks):
        logits, cache = jlm.forward_seq_parallel(params[0], toks, lcfg, _jmesh(n),
                                                 capture=SEQ_HOOKS, return_logits=True)
        return logits, cache, jlm.run_with_cache_multi_seq_parallel(params, toks, lcfg,
                                                                     MULTI_HOOKS, _jmesh(n))

    logits, cache, multi = run([jax.tree_util.tree_map(jnp.asarray, p) for p in jparams], toks)
    return (np.asarray(logits), {hp: np.asarray(cache[hp]) for hp in SEQ_HOOKS},
            np.asarray(multi))


def _jax_tp(jparams, toks):
    lcfg = jlm.LMConfig.tiny()
    jm = JMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    tp = [jlm.shard_params_tp(jax.tree_util.tree_map(jnp.asarray, p), jm) for p in jparams]
    toks = jnp.asarray(toks)

    @jax.jit                    # one program: forward, capture and CE share a compile
    def run(tp, toks):
        logits, cache = jlm.forward(tp[0], toks, lcfg, capture=TP_HOOKS)
        return (logits, cache, jlm.run_with_cache_multi(tp, toks, lcfg, TP_HOOKS[:1]),
                jlm.ce_loss(tp[0], toks, lcfg))

    logits, cache, multi, ce = run(tp, toks)
    return (np.asarray(logits), {hp: np.asarray(cache[hp]) for hp in TP_HOOKS},
            np.asarray(multi), float(ce))


def _jax_seq_store(jparams, tokens):
    """JAX's ``seq_shards`` buffer on a 4-device data axis: its class, its
    first 4 serves and its norm factors."""
    sh = NamedSharding(jmesh.make_mesh(4, 1, devices=jax.devices()[:4]), P("data", None))
    b = jbuf.make_buffer(JCfg(**SEQ_STORE, seq_shards=4), jlm.LMConfig.tiny(),
                         [jax.tree_util.tree_map(jnp.asarray, p) for p in jparams], tokens,
                         batch_sharding=sh)
    return {"cls": type(b).__name__, "rows": [np.asarray(b.next()) for _ in range(4)],
            "factor": np.asarray(b.normalisation_factor)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the launch, and the JAX results the port is held to,
    computed here while the ranks run."""
    tmp = tmp_path_factory.mktemp("harvest")
    rng = np.random.default_rng(0)
    B, S, H, KV, hd = 2, 64, 4, 2, 8
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32) for n in (H, KV, KV))
    lcfg = jlm.LMConfig.tiny()
    jparams = [jax.device_get(jlm.init_params(jax.random.key(i), lcfg)) for i in (0, 1)]
    trainers = {name: _jax_sources_trainer(name) for name in SOURCES}
    states0 = {name: jax.device_get(tr.state) for name, tr in trainers.items()}
    inputs = {
        "q": torch.from_numpy(q), "k": torch.from_numpy(k), "v": torch.from_numpy(v),
        **RING, "lm": [convert.lm_params_from_numpy(p, device="cpu") for p in jparams],
        "seq_tokens": rng.integers(0, 257, (2, 64)), "seq_hooks": SEQ_HOOKS,
        "multi_hooks": MULTI_HOOKS, "tp_tokens": rng.integers(0, 257, (8, 24)),
        "sd": _hf_state_dict(lm.LMConfig.tiny(), 9),
        "store_tokens": rng.integers(1, 257, (256, 17)),
        "seq_store_tokens": rng.integers(1, 257, (128, 16)),
        "states": {name: convert.train_state_from_numpy(st, device="cpu")
                   for name, st in states0.items()},
        "cc_cfg": CC_CFG, "cc_params": cc.init_params(CC_CFG, seed=3, device="cpu"),
    }
    path = tmp / "inputs.pt"
    torch.save(inputs, path)
    np.save(tmp / "pile-lmsys-mix-1m-tokenized-gemma-2.npy", inputs["store_tokens"])
    task = {"kind": "harvest", "inputs": str(path), "store": STORE,
            "tp_store": dict(TP_STORE, data_dir=str(tmp)), "ckpt_root": str(tmp / "ckpt"),
            "seq_store": SEQ_STORE, "sources": SOURCES, "source_steps": SOURCE_STEPS}
    task["main_argv"] = [
        "--data-source", "gemma", "--model-names", "a,b", "--data-dir", str(tmp),
        "--hook-point", "blocks.2.hook_resid_pre", "--seq-len", "17", "--batch-size", "16",
        "--buffer-mult", "8",
        "--model-batch-size", "8", "--norm-calib-batches", "1", "--dict-size", "64",
        "--num-tokens", str(16 * MAIN_STEPS), "--enc-dtype", "fp32",
        "--data-axis-size", "4", "--model-axis-size", "2", "--shard-lm", "true",
        "--buffer-device", "hbm", "--log-every", "1", "--log-backend", "jsonl",
        "--checkpoint-dir", str(tmp / "main")]
    started = start_ranks(8, dict(task, sections=[
        "ring", "seq", "tp", "store", "tp_store", "seq_store", "sources", "main"]), tmp / "r8")
    qkv = tuple(jnp.asarray(x) for x in (q, k, v))
    jax_res = {
        "ring": {(n, loc): out for n in (2, 4, 8)
                 for loc, out in zip((False, True), _jax_ring(*qkv, n))},
        "seq": {n: _jax_seq(jparams, inputs["seq_tokens"], n) for n in (2, 4)},
        "tp": _jax_tp(jparams, inputs["tp_tokens"]),
        "sources": {name: _jax_sources_run(tr) for name, tr in trainers.items()},
        "seq_store": _jax_seq_store(jparams, inputs["seq_store_tokens"]),
    }
    ranks = finish_ranks(started, timeout=400)
    return dict(inputs=inputs, jparams=jparams, jax=jax_res, ranks=ranks, tmp=tmp)


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


# ---------------------------------------------------------------------------
# ring attention


def _jax_ring(q, k, v, n):
    """JAX's ring over ``n`` devices, global then local (one program)."""
    def both(q, k, v):
        return tuple(jring(q, k, v, axis_name="data", n_shards=n, scale=RING["scale"],
                           softcap=RING["softcap"], sliding_window=RING["window"],
                           is_local=loc) for loc in (False, True))

    ring = shard_map(both, mesh=_jmesh(n), in_specs=(P(None, "data"),) * 3,
                     out_specs=(P(None, "data"),) * 2, check_vma=False)
    return [np.asarray(o) for o in jax.jit(ring)(q, k, v)]


@pytest.mark.parametrize("is_local", [False, True], ids=["global", "local"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_matches_the_jax_ring(case, n, is_local):
    ranks = case["ranks"]
    blocks = {}
    for res in ranks:
        got = res["ring"][(n, is_local)]
        blocks[got["rank"]] = got["out"]
        assert got["hops"] == n - 1            # no n-th hop
    out = np.concatenate([blocks[r] for r in range(n)], axis=1)
    np.testing.assert_allclose(out, case["jax"]["ring"][(n, is_local)], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("is_local", [False, True], ids=["global", "local"])
def test_ring_single_shard_is_dense_attention(is_local):
    from crosscoder_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, n, 4)).astype(np.float32))
               for n in (2, 1, 1))
    got = ring_attention(q, k, v, group=None, n_shards=1, scale=0.5, softcap=30.0,
                         sliding_window=8, is_local=is_local)
    want = pa.ragged_attention_reference(q, k, v, None, scale=0.5, softcap=30.0, window=8,
                                         is_local=is_local)
    np.testing.assert_allclose(got.reshape(1, 16, -1).numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_seq_parallel_refuses_an_indivisible_length(case):
    for res in case["ranks"]:
        assert res["seq"]["indivisible"] == "seq len 63 not divisible by 2 sequence shards"


# ---------------------------------------------------------------------------
# the sequence-parallel forward


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_forward_matches_jax(case, n):
    lcfg = jlm.LMConfig.tiny()
    logits, cache, multi = case["jax"]["seq"][n]
    for res in case["ranks"]:
        got = res["seq"][n]
        np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=TP_RTOL,
                                   atol=TP_ATOL)
        for hp in SEQ_HOOKS:
            np.testing.assert_allclose(got["cache"][hp], np.asarray(cache[hp]), rtol=TP_RTOL,
                                       atol=TP_ATOL, err_msg=hp)
            np.testing.assert_array_equal(got["capture_only"][hp], got["cache"][hp])
        assert got["multi"].shape == (2, 64, 4, lcfg.d_model)
        np.testing.assert_allclose(got["multi"], np.asarray(multi), rtol=TP_RTOL, atol=TP_ATOL)


# ---------------------------------------------------------------------------
# the tensor-parallel LM


def test_tp_forward_capture_and_ce_match_jax(case):
    lcfg = jlm.LMConfig.tiny()
    logits, cache, multi, ce = case["jax"]["tp"]
    for res in case["ranks"]:
        got = res["tp"]
        assert got["wq_shape"] == (lcfg.n_layers, lcfg.d_model,
                                   lcfg.n_heads * lcfg.head_dim // 2)
        np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=TP_RTOL,
                                   atol=TP_ATOL)
        for hp in TP_HOOKS:
            np.testing.assert_allclose(got["cache"][hp], np.asarray(cache[hp]), rtol=TP_RTOL,
                                       atol=TP_ATOL, err_msg=hp)
        np.testing.assert_allclose(got["multi"], np.asarray(multi), rtol=TP_RTOL, atol=TP_ATOL)
        np.testing.assert_allclose(got["ce"], ce, rtol=TP_RTOL, atol=TP_ATOL)


def test_tp_params_run_the_ce_recovered_eval(case):
    inp = case["inputs"]
    want = ce_eval.get_ce_recovered_metrics(
        np.asarray(inp["tp_tokens"]), lm.LMConfig.tiny(), inp["lm"], "blocks.2.hook_resid_pre",
        ce_eval.crosscoder_reconstruct_fn(inp["cc_params"], CC_CFG), chunk=4)
    for res in case["ranks"]:
        got = res["tp"]["ce_metrics"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=TP_RTOL, atol=TP_ATOL, err_msg=k)


def test_tp_load_slices_as_shard_params_tp(case):
    assert all(res["tp"]["loaded_equal"] for res in case["ranks"])


# ---------------------------------------------------------------------------
# the mesh-sharded stores


def _stub_jax(monkeypatch, stub):
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_dev",
                        lambda self, p: jnp.asarray(stub(p)).astype(jnp.bfloat16))
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_harvest_job",
                        lambda self, p: jbuf._SingleDispatchJob(self._harvest_dev(p)))
    monkeypatch.setattr(jbuf.PairedActivationBuffer, "_segs_per_chunk", lambda self: 1)


def _stub_port(monkeypatch, stub):
    def harvest(self, p):
        return torch.from_numpy(stub(p)).to(torch.bfloat16)

    monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_dev", harvest)
    monkeypatch.setattr(buf.PairedActivationBuffer, "_harvest_job",
                        lambda self, p: buf._SingleDispatchJob(harvest(self, p)))
    monkeypatch.setattr(buf.PairedActivationBuffer, "_segs_per_chunk", lambda self: 1)


def _u16(x):
    return np.asarray(x).view(np.uint16) if not torch.is_tensor(x) else \
        x.contiguous().view(torch.int16).numpy().view(np.uint16)


def _global(ranks, key, n, quant, i):
    """Serve ``i`` of ``key`` as the global batch: the data ranks' rows in
    order (model replicas hold the same rows)."""
    by_rank = {}
    for res in ranks:
        got = res["store"][(n, quant)]
        rows = got[key][i]
        if got["data_rank"] in by_rank:
            np.testing.assert_array_equal(by_rank[got["data_rank"]], rows)
        by_rank[got["data_rank"]] = rows
    return np.concatenate([by_rank[r] for r in range(n)])


def _stub():
    return Stub(2, STORE["kw"]["d_in"], STORE["vocab"], STORE["kw"]["seq_len"])


@pytest.fixture(scope="module")
def one_rank(case):
    """The port's one-rank device store over the stubbed harvest, bf16 and
    int8 (the data axis does not change it): its class, the serves of the
    mesh stores' stream (half raw, half scaled), its norm factors, bytes
    and mid-cycle state, and the raw serves of a fresh lazy store restored
    from that state."""
    tokens = np.asarray(case["inputs"]["store_tokens"])
    n_raw = STORE["n_first"] // 2
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _stub_port(mp, _stub())
        for quant in (False, True):
            cfg = CrossCoderConfig(**STORE["kw"], buffer_device="hbm", quant_buffer=quant)
            one = buf.make_buffer(cfg, None, [{}, {}], tokens, device="cpu")
            got = {"cls": type(one).__name__,
                   "raw": [_u16(one.next_raw()).copy() for _ in range(n_raw)],
                   "scaled": [one.next().numpy().copy()
                              for _ in range(STORE["n_first"] - n_raw)],
                   "factor": one.normalisation_factor, "nbytes": one.store_nbytes(),
                   "state": one.state_dict()}
            one2 = buf.make_buffer(cfg, None, [{}, {}], tokens, device="cpu", lazy=True)
            one2.load_state_dict(got["state"])
            got["after"] = [_u16(one2.next_raw()).copy() for _ in range(STORE["n_after"])]
            out[quant] = got
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_store_serves_the_one_rank_and_the_jax_stream(case, one_rank, monkeypatch, n,
                                                           quant):
    tokens = np.asarray(case["inputs"]["store_tokens"])
    _stub_jax(monkeypatch, _stub())
    kw = dict(STORE["kw"], buffer_device="hbm", quant_buffer=quant)
    one = one_rank[quant]
    assert one["cls"] == ("QuantPairedActivationBuffer" if quant else "PairedActivationBuffer")
    sh = NamedSharding(jmesh.make_mesh(n, 1, devices=jax.devices()[:n]), P("data", None))
    jb = jbuf.make_buffer(JCfg(**kw), None, [{}, {}], tokens, batch_sharding=sh)
    assert "Mesh" in type(jb).__name__
    ranks = case["ranks"]
    got0 = ranks[0]["store"][(n, quant)]
    assert got0["cls"] == ("QuantMeshPairedActivationBuffer" if quant
                           else "MeshPairedActivationBuffer")
    n_raw = STORE["n_first"] // 2
    for i in range(n_raw):
        mine = _global(ranks, "raw", n, quant, i)
        np.testing.assert_array_equal(mine.view(np.uint16), one["raw"][i], err_msg=i)
        np.testing.assert_array_equal(mine.view(np.uint16), _u16(jb.next_raw()), err_msg=i)
    for i in range(STORE["n_first"] - n_raw):
        mine = _global(ranks, "scaled", n, quant, i)
        np.testing.assert_array_equal(mine, one["scaled"][i], err_msg=i)
        np.testing.assert_allclose(mine, np.asarray(jb.next()), rtol=1e-6, err_msg=i)
    np.testing.assert_array_equal(got0["factor"], one["factor"])
    np.testing.assert_allclose(got0["factor"], jb.normalisation_factor, rtol=1e-6)
    state = one["state"]
    assert got0["state"]["token_pointer"] == state["token_pointer"] == \
        jb.state_dict()["token_pointer"]
    assert got0["state"]["rng_state"] == state["rng_state"]
    # the restore: a fresh store from the same state serves the same rows
    jb2 = jbuf.make_buffer(JCfg(**kw), None, [{}, {}], tokens, batch_sharding=sh, lazy=True)
    jb2.load_state_dict(jb.state_dict())
    for i in range(STORE["n_after"]):
        mine = _global(ranks, "after", n, quant, i)
        np.testing.assert_array_equal(mine.view(np.uint16), one["after"][i], err_msg=i)
        np.testing.assert_array_equal(mine.view(np.uint16), _u16(jb2.next_raw()), err_msg=i)
    # each rank holds its shard: about 1/n of the one-rank store
    assert got0["nbytes"] * n >= one["nbytes"] > got0["nbytes"] * (n - 1)


def _dense_buffer(kw, params, tokens):
    cfg = CrossCoderConfig(**{k: v for k, v in kw.items() if k not in ("shard_lm",
                                                                        "seq_shards")})
    return buf.make_buffer(cfg, lm.LMConfig.tiny(), params, tokens, device="cpu")


def _stitched(ranks, section, n, i):
    by_rank = {res[section]["data_rank"]: res[section]["rows"][i] for res in ranks}
    return np.concatenate([by_rank[r] for r in range(n)])


def test_tp_harvest_buffer_matches_the_dense_one(case):
    ranks = case["ranks"]
    dense = _dense_buffer(TP_STORE, case["inputs"]["lm"],
                          np.asarray(case["inputs"]["store_tokens"]))
    assert {res["tp_store"]["cls"] for res in ranks} == {"MeshPairedActivationBuffer"}
    for res in ranks:
        np.testing.assert_allclose(res["tp_store"]["factor"], dense.normalisation_factor,
                                   rtol=1e-5)
        assert np.isfinite(res["tp_store"]["loss"])
    for i in range(4):
        np.testing.assert_allclose(_stitched(ranks, "tp_store", 4, i), dense.next().numpy(),
                                   rtol=1e-2, atol=1e-2)


def test_tp_harvest_buffer_resumes_through_the_checkpointer(case):
    """The primary's save, restored on every rank into a fresh mesh store
    and Trainer: the saved params, and the rows a store given the saved
    stream state by hand serves."""
    for res in case["ranks"]:
        got = res["tp_store"]
        assert got["same_state"]
        for a, b in zip(got["restored"], got["direct"]):
            np.testing.assert_array_equal(a, b)


def test_seq_sharded_buffer_matches_the_dense_one(case):
    ranks = case["ranks"]
    dense = _dense_buffer(SEQ_STORE, case["inputs"]["lm"],
                          np.asarray(case["inputs"]["seq_store_tokens"]))
    assert {res["seq_store"]["cls"] for res in ranks} == {"MeshPairedActivationBuffer"}
    for res in ranks:
        np.testing.assert_allclose(res["seq_store"]["factor"], dense.normalisation_factor,
                                   rtol=1e-5)
    for i in range(4):
        np.testing.assert_allclose(_stitched(ranks, "seq_store", 4, i), dense.next().numpy(),
                                   rtol=1e-2, atol=1e-2)


def test_seq_sharded_buffer_matches_the_jax_one(case):
    """The same ``seq_shards`` buffer in JAX (``tests/test_buffer.py:386``
    builds it on the whole 8-device axis; here on the port's 4): the mesh
    store, the same norm factors and the same served stream."""
    want = case["jax"]["seq_store"]
    ranks = case["ranks"]
    assert want["cls"] == "MeshPairedActivationBuffer"
    for res in ranks:
        np.testing.assert_allclose(res["seq_store"]["factor"], want["factor"], rtol=1e-5)
    for i in range(4):
        np.testing.assert_allclose(_stitched(ranks, "seq_store", 4, i), want["rows"][i],
                                   rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# shard_sources


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_shard_sources_matches_the_jax_mesh_trainer(case, name):
    jsteps, jparams, jsince = case["jax"]["sources"][name]
    for res in case["ranks"]:
        got = res["sources"][name]
        assert got["W_enc_local"][0] == 1       # one of the four sources a rank
        for key in jsteps[0]:
            np.testing.assert_allclose([s[key] for s in got["steps"]],
                                       [s[key] for s in jsteps], rtol=SRC_RTOL, atol=SRC_ATOL,
                                       err_msg=key)
        for k, v in jparams.items():
            np.testing.assert_allclose(got["params"][k], v.astype(np.float32), rtol=SRC_RTOL,
                                       atol=SRC_ATOL, err_msg=k)
        if jsince is not None:
            np.testing.assert_array_equal(got["since"], jsince)
    if name == "auxk":
        assert any(s["aux_loss"] > 0 for s in jsteps)


def test_train_main_runs_shard_lm_over_the_grid(case):
    """``train.main`` on 8 gloo ranks with ``--shard-lm true`` and an HBM
    store on a 4 × 2 grid: each model loads tensor-parallel over
    ``model``, the buffer is the store sharded over ``data``, the trainer
    takes the same grid, and only the primary logs."""
    import json

    for res in case["ranks"]:
        got = res["main"]
        assert got["cls"] == "MeshPairedActivationBuffer" and got["grid"] == (4, 2)
        assert got["tp_loads"] == [True, True] and got["wq"][-1] == 4 * 8 // 2
        assert got["step"] == MAIN_STEPS
    logs = list((case["tmp"] / "main").rglob("metrics.jsonl"))
    assert len(logs) == 1
    rows = [json.loads(line) for line in logs[0].read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(MAIN_STEPS))
    assert all(np.isfinite(r["loss"]) for r in rows)
