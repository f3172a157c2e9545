"""The trainer's prefetch on gloo ranks (``kind: prefetch`` of
``tests/_torch_parallel_child.py``). Imports no JAX.

On 2 ranks, for each grid ``data`` × ``model`` of ``task["grids"]`` and
each store of ``task["stores"]`` (``bf16``, ``int8``; ``buffer_device
"hbm"``, the mesh store when ``data`` > 1) over the tiny LMs: a Trainer
with prefetch off, then one with it on, each on a freshly built store from
the same tokens, ``task["steps"]`` BatchTopK steps. Returns per run the
losses, the gathered params, the store's token pointer afterwards (the
worker drained), the store's class and the tickets the launch sequencer
handed out (``None`` without one).
"""

from __future__ import annotations

import numpy as np


def run(task, rank):
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as buf
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer

    lm_cfg = lm.LMConfig.tiny()
    params = [lm.init_params(lm_cfg, seed=s, device="cpu") for s in (0, 1)]
    tokens = np.random.default_rng(7).integers(0, 257, size=(256, 17), dtype=np.int64)
    out = {}
    for d, m in task["grids"]:
        mesh = mesh_lib.make_mesh(d, m)
        for store in task["stores"]:
            for pf in (False, True):
                cfg = CrossCoderConfig(
                    batch_size=32, buffer_mult=16, seq_len=17, d_in=32, n_models=2,
                    model_batch_size=4, norm_calib_batches=2, hook_point="blocks.2.hook_resid_pre",
                    seed=3, dict_size=128, activation="batchtopk", topk_k=4, l1_coeff=0.0,
                    log_backend="null", buffer_device="hbm", quant_buffer=store == "int8",
                    quant_block=16, data_axis_size=d, model_axis_size=m, prefetch=pf)
                b = buf.make_buffer(cfg, lm_cfg, params, tokens, mesh=mesh, device="cpu")
                tr = Trainer(cfg, b, device="cpu", mesh=mesh)
                losses = [float(tr.step()["loss"]) for _ in range(task["steps"])]
                tr._drain_prefetch()
                tickets = None if tr._sequencer is None else tr._sequencer._next
                full = mesh_lib.gather_state(mesh, tr.state)
                out[f"{d}x{m} {store} {pf}"] = {
                    "losses": losses, "cls": type(b).__name__, "tickets": tickets,
                    "token_pointer": (tr._buffer_snapshot or b.state_dict())["token_pointer"],
                    "params": {k: v.float().numpy() for k, v in full.params.items()}}
                tr.close()
    return out
