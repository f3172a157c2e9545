"""The cases of the mesh's last refusals a gloo rank runs (``kind:
mesh_rest`` of ``tests/_torch_parallel_child.py``). Imports no JAX.

``task["inputs"]`` is a ``torch.save`` dict made by the test. On 8 ranks
the task builds the grids ``data`` × ``model`` = 2 × 4, 4 × 2 and 1 × 8
over every rank, and the sub-grids 1 × 2, 2 × 1 and 2 × 2 over the first
ranks (the others idle through those sections). Each section returns what
this rank computed:

- ``overlap``: the mesh-sharded stores (bf16, int8) at ``data`` 2 and 4
  over a stubbed harvest, with ``refill_overlap`` on and off: this rank's
  raw serves;
- ``overlap_lm``: the tiny LMs harvested tensor-parallel (``shard_lm``,
  4 × 2) and sequence-parallel (``seq_shards`` 2, 2 × 4) into the mesh
  store, the overlap on and off: this rank's raw serves;
- ``paged_tp``: the paged harvest (and the padded one) over tensor-parallel
  params at ``model`` 2 and 4;
- ``tp8``: the tensor-parallel forward and paged harvest at ``model`` 8
  with 4 heads on 2 KV heads and with 8 on 4 (neither split head-local);
- ``train``: Trainers on the sub-grids for each named config, from given
  states (steps' losses, the gathered params; ``train()`` with the guard).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from _torch_harvest_child import Stub, install_stub


def _raw(t):
    return t.contiguous().view(torch.int16).numpy().copy()


def sub_mesh(d: int, m: int):
    """A ``d`` × ``m`` grid over ranks ``[0, d·m)`` (every rank joins the
    group creation; the others get ``None``)."""
    from crosscoder_tpu_torch.parallel.mesh import Mesh

    r = dist.get_rank()
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    world = dist.new_group(list(range(d * m)))
    if r >= d * m:
        return None
    return Mesh(data_size=d, model_size=m, data_rank=r // m, model_rank=r % m,
                data_group=data_groups[r % m], model_group=model_groups[r // m],
                world_group=world)


def run(task, rank):
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib

    assert dist.get_world_size() == 8
    meshes = {"m24": mesh_lib.make_mesh(2, 4), "m42": mesh_lib.make_mesh(4, 2),
              "m18": mesh_lib.make_mesh(1, 8)}
    for d, m in task["grids"]:
        meshes[(d, m)] = sub_mesh(d, m)
    inp = torch.load(task["inputs"], weights_only=False)
    return {section: globals()["_" + section](task, inp, meshes)
            for section in task["sections"]}


def _stream(buf_mod, cfg, lm_cfg, params, tokens, mesh, n):
    b = buf_mod.make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh, device="cpu")
    out = {"cls": type(b).__name__, "thread": b._dispatcher is not None,
           "raw": [_raw(b.next_raw()) for _ in range(n)], "token_pointer": b.token_pointer,
           "state": b.state_dict()}
    b.close()
    return out


def _overlap(task, inp, meshes):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf

    sc = task["store"]
    undo = install_stub(buf, Stub(2, sc["kw"]["d_in"], sc["vocab"], sc["kw"]["seq_len"]))
    res = {}
    try:
        for mesh in (meshes["m24"], meshes["m42"]):
            for quant in (False, True):
                for overlap in ("off", "on"):
                    cfg = CrossCoderConfig(**sc["kw"], buffer_device="hbm", quant_buffer=quant,
                                           refill_overlap=overlap,
                                           data_axis_size=mesh.data_size,
                                           model_axis_size=mesh.model_size)
                    got = _stream(buf, cfg, None, [{}, {}], inp["store_tokens"], mesh,
                                  sc["serves"])
                    got["data_rank"] = mesh.data_rank
                    res[(mesh.data_size, quant, overlap)] = got
    finally:
        undo()
    return res


def _overlap_lm(task, inp, meshes):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm

    lcfg = lm.LMConfig.tiny()
    res = {}
    for name, mesh, extra in (("shard_lm", meshes["m42"], dict(shard_lm=True)),
                              ("seq_shards", meshes["m24"], dict(seq_shards=2, seq_len=16))):
        params = inp["lm"]
        if name == "shard_lm":
            params = [lm.shard_params_tp(p, mesh, lcfg) for p in params]
        tokens = inp["store_tokens"][:, :extra.get("seq_len", 17)]
        for overlap in ("off", "on"):
            cfg = CrossCoderConfig(**{**task["lm_store"], **extra}, refill_overlap=overlap,
                                   data_axis_size=mesh.data_size,
                                   model_axis_size=mesh.model_size)
            got = _stream(buf, cfg, lcfg, params, tokens, mesh, task["lm_serves"])
            got["data_rank"] = mesh.data_rank
            res[(name, overlap)] = got
    return res


def _paged_tp(task, inp, meshes):
    from crosscoder_tpu_torch.models import lm

    lcfg = lm.LMConfig.tiny()
    tokens, lengths = inp["paged_tokens"], inp["paged_lengths"]
    res = {}
    for mesh in (meshes["m42"], meshes["m24"]):
        tp = [lm.shard_params_tp(p, mesh, lcfg) for p in inp["lm"]]
        paged = lm.run_with_cache_multi_paged(tp, tokens, lengths, lcfg, task["hooks"],
                                              page_size=task["page"], pad_mode="zero")
        padded = lm.run_with_cache_multi(tp, torch.as_tensor(tokens), lcfg, task["hooks"])
        res[mesh.model_size] = {"paged": paged.numpy(), "padded": padded.numpy(),
                                "wk": tuple(tp[0]["layers"]["wk"].shape)}
    return res


def _tp8(task, inp, meshes):
    from crosscoder_tpu_torch.models import lm

    mesh = meshes["m18"]
    res = {}
    for name, heads in task["tp8_heads"].items():
        lcfg = dataclasses.replace(lm.LMConfig.tiny(), n_heads=heads[0], n_kv_heads=heads[1])
        tp = lm.shard_params_tp(inp["tp8"][name], mesh, lcfg)
        toks = torch.as_tensor(inp["tp_tokens"])
        with torch.no_grad():
            logits, cache = lm.forward(tp, toks, lcfg, capture=task["hooks"])
        paged = lm.run_with_cache_multi_paged([tp], inp["paged_tokens"], inp["paged_lengths"],
                                              lcfg, task["hooks"], page_size=task["page"])
        res[name] = {"logits": logits.numpy(), "cache": {k: v.numpy() for k, v in cache.items()},
                     "paged": paged.numpy(), "wq": tuple(tp["layers"]["wq"].shape)}
    return res


class PoisonedSource:
    """The synthetic source with row 0 of the serves in ``nan_serves``
    (counted from 0) set to NaN; it checkpoints the inner source's
    position."""

    def __init__(self, inner, nan_serves):
        self.inner, self.nan_serves, self.serves = inner, set(nan_serves), 0

    def next(self):
        b = np.array(self.inner.next(), copy=True)
        if self.serves in self.nan_serves:
            b[0] = np.nan
        self.serves += 1
        return b

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, d):
        self.inner.load_state_dict(d)


def _train(task, inp, meshes):
    from crosscoder_tpu_torch.checkpoint import Checkpointer
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train import resample
    from crosscoder_tpu_torch.train.trainer import Trainer

    ridx = torch.as_tensor(inp["ridx"])
    resample._draw = lambda e2, n, generator: ridx          # the rows JAX is handed too
    res = {}
    for leg in task["legs"]:
        name, (d, m), sources = leg["config"], tuple(leg["grid"]), leg.get("shard_sources", False)
        mesh = meshes[(d, m)]
        if mesh is None:
            continue
        cfg = CrossCoderConfig(**{**task["base"], **task["configs"][name]},
                               data_axis_size=d, model_axis_size=m, shard_sources=sources)
        src = SyntheticActivationSource(cfg)
        state = inp["states"][name]
        if cfg.guard_loss:
            root = f"{task['ckpt_root']}/{name}_{d}x{m}"
            cfg = cfg.replace(checkpoint_dir=root)
            tr = Trainer(cfg, PoisonedSource(src, task["nan_serves"]), device="cpu", mesh=mesh,
                         state=state, checkpointer=Checkpointer(cfg=cfg))
            out = tr.train()
            steps = [{"loss": out["loss"]}]
            extra = {"step": tr.step_counter, "resilience": tr.resilience.snapshot(),
                     "serves": tr._serve_count}
        else:
            tr = Trainer(cfg, src, device="cpu", mesh=mesh, state=state)
            steps = []
            for _ in range(task["steps"]):
                mt = tr.step()
                steps.append({k: float(v) for k, v in mt.items()
                              if not torch.is_tensor(v) or v.dim() == 0})
            extra = {}
        full = mesh_lib.gather_state(mesh, tr.state, cfg.shard_sources)
        res[(name, d, m, sources)] = {
            "steps": steps, **extra,
            "params": {k: v.float().numpy() for k, v in full.params.items()}}
    return res
