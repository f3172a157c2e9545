"""The buffer's reshard across a survivor shrink on real gloo ranks (``kind:
elastic`` of ``tests/_torch_parallel_child.py``). Imports no JAX.

Every rank builds each variant of ``task["variants"]`` (a config of the
mesh store) over the tiny LM on the ``task["grid"]`` grid and serves
``task["serves"]`` batches; the coordinator host's ranks (``task["local"]``
a host) then take each variant's stream position, shrink the world through
the elastic controller, reshard each buffer onto the survivors' grid with
``refill=True`` and serve ``task["after"]`` batches beside a fresh buffer
built on that grid and restored from the position. The other ranks leave
after their serves.
"""

from __future__ import annotations

import numpy as np


def run(task, rank):
    import torch

    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.parallel import multihost
    from crosscoder_tpu_torch.resilience.elastic import ElasticController
    from crosscoder_tpu_torch.utils.logging import ResilienceCounters

    lm_cfg = lm.LMConfig.tiny()
    whole = [lm.init_params(lm_cfg, seed=s, device="cpu") for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(1, 257, size=(256, 17), dtype=np.int64)
    d, m = task["grid"]
    mesh = mesh_lib.make_mesh(d, m)
    cfgs, bufs = {}, {}
    for name, kw in task["variants"].items():
        cfg = CrossCoderConfig(**task["base"], **kw, data_axis_size=d, model_axis_size=m)
        params = ([lm.shard_params_tp(p, mesh, lm_cfg) for p in whole] if cfg.shard_lm
                  else whole)
        b = buf.make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh, device="cpu")
        for _ in range(task["serves"]):
            b.next_raw()
        cfgs[name], bufs[name] = cfg, b
    out = {"classes": {n: type(b).__name__ for n, b in bufs.items()}}
    if rank >= task["local"]:
        return out
    snaps = {n: b.state_dict() for n, b in bufs.items()}
    for b in bufs.values():
        b.prepare_reshard()
    counters = ResilienceCounters()
    ctl = ElasticController(next(iter(cfgs.values())).replace(elastic="on"),
                            counters=counters)
    new_mesh = ctl.shrink()
    out.update(epoch=ctl.epoch(), world=multihost.world_size(), counters=counters.snapshot(),
               grid=(new_mesh.data_size, new_mesh.model_size), streams={},
               address=multihost.membership().coordinator_address)
    for name, b in bufs.items():
        b.reshard(new_mesh, refill=True)
        cfg = cfgs[name].replace(data_axis_size=new_mesh.data_size)
        params = ([lm.shard_params_tp(p, new_mesh, lm_cfg) for p in whole] if cfg.shard_lm
                  else whole)
        ref = buf.make_buffer(cfg, lm_cfg, params, tokens, mesh=new_mesh, device="cpu",
                              lazy=True)
        ref.load_state_dict(snaps[name])
        got, want = [], []
        for _ in range(task["after"]):
            got.append(b.next_raw().view(torch.int16).numpy())
            want.append(ref.next_raw().view(torch.int16).numpy())
        out["streams"][name] = {"got": np.stack(got), "want": np.stack(want),
                                "ref_class": type(ref).__name__}
    return out
