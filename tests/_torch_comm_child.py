"""The counted wire on real gloo ranks (``kind: comm`` of
``tests/_torch_parallel_child.py``). Imports no JAX.

On 8 ranks, for each ``(program, n, model)`` of ``task["cases"]``: a
``n / model`` × ``model`` grid over ranks ``[0, n)`` (the others idle),
one bare step of the program :func:`comm_model.program_config` gives at
``task["shape"]``, and the bytes this rank's collectives delivered, by op
under JAX's names. Then ``profile_width`` beside the joined group, which
must refuse.
"""

from __future__ import annotations


def run(task, rank):
    from _torch_mesh_rest_child import sub_mesh

    from crosscoder_tpu_torch.parallel import comm_model as cm

    out = {}
    for program, n, m in task["cases"]:
        mesh = sub_mesh(n // m, m)
        if mesh is None:
            continue
        cfg = cm.program_config(program, n, m, **task["shape"])
        cm._train_step(cfg, mesh, "cpu")
        out[f"{program} {n}x{m}"] = cm.counted_profile(program, n, m).bytes_by_op
    try:
        cm.profile_width(2, programs=("train",), device="cpu", **task["shape"])
        out["refused"] = None
    except RuntimeError as e:
        out["refused"] = str(e)
    return out
