"""The telemetry plane on real gloo ranks (``kind: obs`` of
``tests/_torch_parallel_child.py``). Imports no JAX.

On 2 ranks: the DP train program of ``comm_model.program_config`` at
``task["shape"]`` on a 2 × 1 grid with ``obs="on"``, one bare step; the
comm gauges the step's counted collectives give, the directory the ranks'
traces went to, and whether a harvest watchdog was built (it must not be, on more
than one rank).
"""

from __future__ import annotations

import os


def run(task, rank):
    from crosscoder_tpu_torch.parallel import comm_model as cm
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer

    cfg = cm.program_config("train_dp", 2, 1, **task["shape"]).replace(
        obs="on", obs_dir=os.path.join(task["out"], "obs"), harvest_timeout_s=5.0)
    tr = Trainer(cfg, device="cpu", mesh=mesh_lib.make_mesh(2, 1))
    watchdog = tr._watchdog is not None
    tr.step(full_metrics=False)
    snap = tr._obs.registry.snapshot()
    tr.close()
    return {"comm": {k: v for k, v in snap.items() if k.startswith("comm/")},
            "obs_dir": cfg.obs_dir, "watchdog": watchdog}
