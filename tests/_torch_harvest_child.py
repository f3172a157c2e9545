"""The parallel-harvest cases a gloo rank runs (``kind: harvest`` of
``tests/_torch_parallel_child.py``). Imports no JAX.

``task["inputs"]`` is a ``torch.save`` dict made by the test: the ring's
q/k/v, two tiny LMs' params, token ids, an HF-layout state dict. On 8
ranks the task builds three grids over the same ranks, ``data`` ×
``model`` = 2 × 4, 4 × 2 and 8 × 1, so one launch runs the ring at 2, 4
and 8, the tensor-parallel LM at ``model`` 2 and the stores at ``data`` 2
and 4. Each section returns what this rank computed (whole, stitched
arrays for the forwards; this rank's served rows for the stores):

- ``ring``: :func:`ring_attention` over each grid's ``data`` group, local
  and global layers, this rank's output block;
- ``seq``: :func:`lm.forward_seq_parallel` (logits and sub-layer hooks)
  and :func:`lm.run_with_cache_multi_seq_parallel`;
- ``tp``: the tensor-parallel forward, ``run_with_cache_multi``,
  ``ce_loss``, the CE-recovered eval and ``from_torch_state_dict(tp=)``
  (what ``from_hf(tp=)`` loads through);
- ``store``: the mesh-sharded stores (bf16, int8) over a stubbed harvest,
  served through a mid-cycle save and restore;
- ``tp_store``: a ``shard_lm`` buffer harvesting the tiny LMs
  tensor-parallel (``train.main.build_buffer`` over the local token
  cache), one Trainer step on it, a save mid-cycle and its restore into
  a fresh buffer and Trainer;
- ``seq_store``: a ``seq_shards`` buffer on the 4 × 2 grid;
- ``sources``: ``shard_sources`` Trainers from given states;
- ``main``: ``train.main.main`` on the 4 × 2 grid with ``--shard-lm
  true`` and a device store, each model loaded tensor-parallel (``from_hf``
  stands in with the tiny LMs' params, so no HF checkpoint is read).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

# the stand-in harvest: acts[c, s] = E[token] + P[s], exact in bf16
STUB_SEED = 0


class Stub:
    def __init__(self, n_sources, d, vocab, seq):
        rng = np.random.default_rng(STUB_SEED)
        self.E = rng.normal(size=(vocab, n_sources, d)).astype(np.float32) * 3
        self.P = rng.normal(size=(seq, n_sources, d)).astype(np.float32)

    def __call__(self, padded):
        return self.E[np.asarray(padded)] + self.P[None, : padded.shape[1]]


def install_stub(buf, stub):
    """The stub as the harvest of every port buffer class (the mesh stores
    cut each chunk to this rank's share before it); returns the undo."""
    base = buf.PairedActivationBuffer
    names = ("_harvest_dev", "_harvest_job", "_segs_per_chunk")
    saved = {n: base.__dict__[n] for n in names}

    def harvest(self, p):
        return torch.from_numpy(stub(p)).to(torch.bfloat16)

    base._harvest_dev = harvest
    base._harvest_job = lambda self, p: buf._SingleDispatchJob(harvest(self, p))
    base._segs_per_chunk = lambda self: 1

    def undo():
        for n, f in saved.items():
            setattr(base, n, f)

    return undo


def _raw(t):
    return t.contiguous().view(torch.int16).numpy().copy()


def serve_stream(buf_mod, cfg, tokens, mesh, n_first, n_after):
    """``n_first`` serves, a mid-cycle ``state_dict``, a fresh lazy buffer
    restored from it, ``n_after`` more serves: this rank's raw rows, the f32
    batches of the first serves, the norm factors and the saved state."""
    b = buf_mod.make_buffer(cfg, None, [{}, {}], tokens, mesh=mesh, device="cpu")
    raw = [_raw(b.next_raw()) for _ in range(n_first // 2)]
    scaled = [b.next().numpy() for _ in range(n_first - n_first // 2)]
    state = b.state_dict()
    b2 = buf_mod.make_buffer(cfg, None, [{}, {}], tokens, mesh=mesh, device="cpu", lazy=True)
    b2.load_state_dict(state)
    after = [_raw(b2.next_raw()) for _ in range(n_after)]
    return {"cls": type(b).__name__, "raw": raw, "scaled": scaled, "after": after,
            "factor": np.asarray(b.normalisation_factor), "state": state,
            "nbytes": b.store_nbytes(), "pointer": b.pointer, "token_pointer": b.token_pointer}


def run(task, rank):
    import torch.distributed as dist

    from crosscoder_tpu_torch.parallel import mesh as mesh_lib

    assert dist.get_world_size() == 8
    meshes = {"m24": mesh_lib.make_mesh(2, 4), "m42": mesh_lib.make_mesh(4, 2),
              "m81": mesh_lib.make_mesh(8, 1)}
    inp = torch.load(task["inputs"], weights_only=False)
    return {section: globals()["_" + section](task, inp, meshes)
            for section in task["sections"]}


def _ring(task, inp, meshes):
    from crosscoder_tpu_torch.parallel import collectives as coll
    from crosscoder_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = inp["q"], inp["k"], inp["v"]
    res = {}
    for mesh in meshes.values():
        n, r = mesh.data_size, mesh.data_rank
        S = q.shape[1] // n
        blk = slice(r * S, (r + 1) * S)
        for is_local in (False, True):
            coll.reset_counts()
            o = ring_attention(q[:, blk], k[:, blk], v[:, blk], group=mesh.data_group,
                               n_shards=n, scale=inp["scale"], softcap=inp["softcap"],
                               sliding_window=inp["window"], is_local=is_local)
            res[(n, is_local)] = {"rank": r, "out": o.numpy(),
                                  "hops": coll.calls["ring_shift"]}
    return res


def _seq(task, inp, meshes):
    from crosscoder_tpu_torch.models import lm

    cfg = lm.LMConfig.tiny()
    res = {}
    for mesh in (meshes["m24"], meshes["m42"]):
        p0 = inp["lm"][0]
        logits, cache = lm.forward_seq_parallel(p0, inp["seq_tokens"], cfg, mesh,
                                                capture=inp["seq_hooks"], return_logits=True)
        multi = lm.run_with_cache_multi_seq_parallel(inp["lm"], inp["seq_tokens"], cfg,
                                                     inp["multi_hooks"], mesh)
        _, capture_only = lm.forward_seq_parallel(p0, inp["seq_tokens"], cfg, mesh,
                                                  capture=inp["seq_hooks"])
        res[mesh.data_size] = {"logits": logits.numpy(),
                               "cache": {k: v.numpy() for k, v in cache.items()},
                               "capture_only": {k: v.numpy() for k, v in capture_only.items()},
                               "multi": multi.numpy()}
    try:
        lm.forward_seq_parallel(inp["lm"][0], inp["seq_tokens"][:, :63], cfg, meshes["m24"])
    except ValueError as e:
        res["indivisible"] = str(e)
    return res


def _tp(task, inp, meshes):
    from crosscoder_tpu_torch.analysis import ce_eval
    from crosscoder_tpu_torch.models import lm

    mesh = meshes["m42"]
    cfg = lm.LMConfig.tiny()
    tp = [lm.shard_params_tp(p, mesh, cfg) for p in inp["lm"]]
    toks = torch.as_tensor(inp["tp_tokens"])
    hooks = ("blocks.2.hook_resid_pre", "blocks.1.hook_attn_out", "blocks.2.hook_mlp_out")
    with torch.no_grad():
        logits, cache = lm.forward(tp[0], toks, cfg, capture=hooks)
        multi = lm.run_with_cache_multi(tp, toks, cfg, hooks[:1])
        ce = float(lm.ce_loss(tp[0], toks, cfg))
    ce_metrics = ce_eval.get_ce_recovered_metrics(
        np.asarray(inp["tp_tokens"]), cfg, tp, "blocks.2.hook_resid_pre",
        ce_eval.crosscoder_reconstruct_fn(inp["cc_params"], inp["cc_cfg"]), chunk=4)
    loaded = lm.from_torch_state_dict(inp["sd"], cfg, device="cpu", tp=mesh)
    whole = lm.shard_params_tp(lm.from_torch_state_dict(inp["sd"], cfg, device="cpu"), mesh, cfg)
    same = all(torch.equal(loaded["layers"][k], whole["layers"][k]) for k in whole["layers"])
    same = same and torch.equal(loaded["embed"], whole["embed"])
    return {"logits": logits.numpy(), "cache": {k: v.numpy() for k, v in cache.items()},
            "multi": multi.numpy(), "ce": ce, "loaded_equal": bool(same),
            "ce_metrics": ce_metrics,
            "wq_shape": tuple(tp[0]["layers"]["wq"].shape)}


def _store(task, inp, meshes):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf

    sc = task["store"]
    undo = install_stub(buf, Stub(2, sc["kw"]["d_in"], sc["vocab"], sc["kw"]["seq_len"]))
    res = {}
    try:
        for mesh in (meshes["m24"], meshes["m42"]):
            for quant in (False, True):
                cfg = CrossCoderConfig(**sc["kw"], buffer_device="hbm", quant_buffer=quant,
                                       data_axis_size=mesh.data_size,
                                       model_axis_size=mesh.model_size)
                got = serve_stream(buf, cfg, inp["store_tokens"], mesh, sc["n_first"],
                                   sc["n_after"])
                got["data_rank"] = mesh.data_rank
                res[(mesh.data_size, quant)] = got
    finally:
        undo()
    return res


def _tp_store(task, inp, meshes):
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.train.main import build_buffer
    from crosscoder_tpu_torch.train.trainer import Trainer

    mesh = meshes["m42"]
    lcfg = lm.LMConfig.tiny()
    cfg = CrossCoderConfig(**task["tp_store"], data_axis_size=mesh.data_size,
                           model_axis_size=mesh.model_size)
    tp = [lm.shard_params_tp(p, mesh, lcfg) for p in inp["lm"]]
    # as train.main builds it: the local token cache, the grid's buffer
    b, cfg = build_buffer(cfg, device="cpu", model_params=tp, lm_cfg=lcfg, mesh=mesh)
    rows = [b.next().numpy() for _ in range(4)]
    tr = Trainer(cfg, b, device="cpu", mesh=mesh, checkpointer=Checkpointer(task["ckpt_root"]))
    loss = float(tr.step()["loss"])
    # a save mid-cycle (the primary writes the stream state), then a fresh
    # buffer and Trainer restore it on every rank
    tr.save()
    torch.distributed.barrier()         # the primary's files are written
    saved = b.state_dict()

    def fresh():
        return buf.make_buffer(cfg, lcfg, tp, inp["store_tokens"], mesh=mesh, device="cpu",
                               lazy=True)

    tr2 = Trainer(cfg, fresh(), device="cpu", mesh=mesh,
                  checkpointer=Checkpointer(task["ckpt_root"]))
    tr2.restore()
    same_state = all(torch.equal(v, tr2.state.params[k]) for k, v in tr.state.params.items())
    restored = [_raw(tr2.buffer.next_raw()) for _ in range(3)]
    direct = fresh()                    # the same stream state, loaded by hand
    direct.load_state_dict(saved)
    return {"cls": type(b).__name__, "rows": rows, "factor": np.asarray(b.normalisation_factor),
            "data_rank": mesh.data_rank, "loss": loss, "restored": restored,
            "direct": [_raw(direct.next_raw()) for _ in range(3)], "same_state": same_state}


def _seq_store(task, inp, meshes):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm

    mesh = meshes["m42"]
    cfg = CrossCoderConfig(**task["seq_store"], seq_shards=4, data_axis_size=4,
                           model_axis_size=2)
    b = buf.make_buffer(cfg, lm.LMConfig.tiny(), inp["lm"], inp["seq_store_tokens"],
                        mesh=mesh, device="cpu")
    return {"cls": type(b).__name__, "rows": [b.next().numpy() for _ in range(4)],
            "factor": np.asarray(b.normalisation_factor), "data_rank": mesh.data_rank}


def _sources(task, inp, meshes):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer

    mesh = meshes["m24"]
    res = {}
    for name, kw in task["sources"].items():
        cfg = CrossCoderConfig(**kw, data_axis_size=mesh.data_size,
                               model_axis_size=mesh.model_size, shard_sources=True)
        tr = Trainer(cfg, SyntheticActivationSource(cfg), device="cpu", mesh=mesh,
                     state=inp["states"][name])
        steps = []
        for _ in range(task["source_steps"]):
            mt = tr.step()
            steps.append({k: float(v) for k, v in mt.items()
                          if not torch.is_tensor(v) or v.dim() == 0})
        full = mesh_lib.gather_state(tr.mesh, tr.state, shard_sources=True)
        res[name] = {"steps": steps, "W_enc_local": tuple(tr.state.params["W_enc"].shape),
                     "params": {k: v.float().numpy() for k, v in full.params.items()},
                     "since": None if full.aux is None else
                     full.aux["steps_since_fired"].numpy()}
    return res


def _main(task, inp, meshes):
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.train import main as tmain

    tiny = lm.LMConfig.tiny()
    by_name = dict(zip(("a", "b"), inp["lm"]))
    loads = []

    def from_hf(path, cfg=None, device=None, tp=None):
        loads.append(tp is not None)
        p = by_name[path]
        return (lm.shard_params_tp(p, tp, tiny) if tp is not None else p), tiny

    saved, lm.from_hf = lm.from_hf, from_hf
    try:
        tr = tmain.main(task["main_argv"], device="cpu")
    finally:
        lm.from_hf = saved
    return {"cls": type(tr.buffer).__name__, "grid": (tr.mesh.data_size, tr.mesh.model_size),
            "step": tr.step_counter, "tp_loads": loads,
            "wq": tuple(tr.buffer.model_params[0]["layers"]["wq"].shape)}
