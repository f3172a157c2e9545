"""The fleet on a rank grid (``kind: fleet_mesh`` of
``tests/_torch_parallel_child.py``). Imports no JAX.

On 4 ranks, for each grid ``data`` × ``model`` of ``task["grids"]`` (2 × 1
over ranks 0 and 1, the others idle; 2 × 2 over all four), the fleet of
``task["spec"]`` over the synthetic source of ``task["base"]``, every
tenant starting from the full state of ``task["states"]`` (a
``torch.save`` file, one state a tenant): ``task["rounds"]`` rounds; each
tenant's solo mesh Trainer from the same state over the same stream; and
``save_all`` after ``task["save_at"]`` rounds, then a fresh fleet's
``restore_all``, continued to the end. Returns per grid the losses (fleet,
solo, restored) and the gathered final params (fleet, solo, restored).
"""

from __future__ import annotations


def run(task, rank):
    import torch

    from _torch_mesh_rest_child import sub_mesh
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.models import stacked
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.fleet import FleetScheduler, parse_tenants, tenant_config
    from crosscoder_tpu_torch.train.trainer import Trainer

    states = torch.load(task["states"], weights_only=False)
    base = CrossCoderConfig(**task["base"])
    specs = {s.name: s for s in parse_tenants(task["spec"])}

    def fleet(mesh, d, m, ckpt=None):
        cfg = base.replace(fleet="on", fleet_tenants=task["spec"], data_axis_size=d,
                           model_axis_size=m, checkpoint_dir=ckpt or "")
        fl = FleetScheduler(cfg, checkpoint=ckpt is not None, device="cpu", mesh=mesh)
        for co in fl._cohorts:
            co.state = stacked.stack_states([
                mesh_lib.shard_state(mesh, states[t.name], t.cfg.shard_sources)
                for t in co.members])
        for b in fl._buckets:
            b.state = mesh_lib.shard_state(mesh, states[b.tenant.name], b.tenant.cfg.shard_sources)
        return fl

    def rounds(fl, n, out):
        for _ in range(n):
            for name, md in fl.step_all().items():
                out.setdefault(name, []).append(float(md["loss"]))
        return out

    def params(mesh, state):
        full = mesh_lib.gather_state(mesh, state)
        return {k: v.numpy() for k, v in full.params.items()}

    out = {}
    for (d, m), grid_mesh in zip(task["grids"], task["meshes"]):
        mesh = sub_mesh(d, m) if grid_mesh == "sub" else mesh_lib.make_mesh(d, m)
        if mesh is None:
            continue
        res = {}
        fl = fleet(mesh, d, m)
        res["fleet"] = rounds(fl, task["rounds"], {})
        res["cohorts"] = [[t.name for t in co.members] for co in fl._cohorts]
        res["buckets"] = [b.tenant.name for b in fl._buckets]
        res["fleet_params"] = {n: params(mesh, fl.tenant_state(n)) for n in fl.active()}
        res["solo"], res["solo_params"] = {}, {}
        for name, spec in specs.items():
            tcfg = tenant_config(base, spec).replace(data_axis_size=d, model_axis_size=m)
            tr = Trainer(tcfg, SyntheticActivationSource(base), device="cpu", mesh=mesh,
                         state=states[name])
            res["solo"][name] = [float(tr.step()["loss"]) for _ in range(task["rounds"])]
            res["solo_params"][name] = params(mesh, tr.state)
            tr.close()
        ckpt = f"{task['root']}/{d}x{m}"
        fl = fleet(mesh, d, m, ckpt)
        rounds(fl, task["save_at"], {})
        fl.save_all()
        fl.quiesce()
        fresh = fleet(mesh, d, m, ckpt)
        res["restored_at"] = fresh.restore_all()
        res["restored"] = rounds(fresh, task["rounds"] - task["save_at"], {})
        res["restored_params"] = {n: params(mesh, fresh.tenant_state(n)) for n in fresh.active()}
        out[f"{d}x{m}"] = res
    return out
