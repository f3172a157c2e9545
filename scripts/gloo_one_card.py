"""Two gloo ranks sharing one card: whether gloo takes the CUDA tensors that
the mesh trainer's collectives pass (``all_reduce`` and
``all_gather_into_tensor``, through ``parallel/collectives.py``), and, when
it takes both, the mesh Trainer at ``data`` 1 × ``model`` 2 with the fused
TopK (K2) and the fused BatchTopK (K4 select, count, emit) tiers at the
training shape, against the single-device Trainer on the same batches.

NCCL refuses two ranks on one device, so this is the only way one card can
run a kernel on a sharded dictionary. Run on a machine with one card:

    python scripts/gloo_one_card.py [--out build/gloo_one_card.json]

Rank 0 writes what each probe and leg did (gloo's own words on a refusal)
to the JSON file and prints it.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRAIN = dict(d_in=2304, n_models=2, dict_size=2 ** 15, topk_k=32, batch_size=4096,
             enc_dtype="bf16", master_dtype="fp32", l1_coeff=0.0, aux_k=0, lr=1e-3,
             log_backend="null")
LEGS = {"K2": dict(activation="topk", sparse_bwd="on", fused_encoder="on"),
        "K4": dict(activation="batchtopk", sparse_bwd="off", fused_encoder="on")}
STEPS = 2


def _probe(fn) -> str:
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 — the refusal's words are the result
        return f"{type(e).__name__}: {e}"[:400]


class _Serve:
    """Serves recorded batches in order."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]


def _references(torch) -> dict:
    """Each leg's batches, start state and single-device losses, made
    before the group exists (a Trainer built inside a group takes its grid)."""
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state
    from crosscoder_tpu_torch.train.trainer import Trainer

    refs = {}
    for name, kw in LEGS.items():
        cfg = CrossCoderConfig(**TRAIN, **kw, num_tokens=TRAIN["batch_size"] * STEPS)
        src = SyntheticActivationSource(cfg)
        batches = [torch.from_numpy(src.next()).cuda() for _ in range(STEPS)]
        state = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
        single = Trainer(cfg, _Serve(batches), device="cuda", state=state)
        refs[name] = dict(cfg=cfg, batches=batches, state=state,
                          loss=[float(single.step()["loss"]) for _ in range(STEPS)])
        del single
    return refs


def _legs(torch, refs) -> dict:
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.parallel import mesh as mesh_lib
    from crosscoder_tpu_torch.train.trainer import Trainer

    mesh = mesh_lib.make_mesh(1, 2)
    counters = (fek.fused_topk_encode, fek.fused_batchtopk_select, fek.fused_batchtopk_count,
                fek.fused_batchtopk_emit)
    out = {}
    for name, ref in refs.items():
        before = [c.launches for c in counters]
        tr = Trainer(ref["cfg"], _Serve(ref["batches"]), device="cuda", state=ref["state"],
                     mesh=mesh)
        got = [float(tr.step()["loss"]) for _ in range(STEPS)]
        torch.cuda.synchronize()
        out[name] = {"mesh_loss": got, "single_loss": ref["loss"],
                     "max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(got, ref["loss"])),
                     "launches": {c.__name__: c.launches - b
                                  for c, b in zip(counters, before) if c.launches > b}}
        del tr
    return out


def rank_main(rank: int, port: int, out_path: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = _references(torch)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    res = {"rank": rank, "device": torch.cuda.get_device_name(0), "probes": {}}
    for dt in (torch.float32, torch.int32, torch.int64):
        t = torch.full((8,), rank + 1, dtype=dt, device="cuda")
        res["probes"][f"all_reduce {dt}"] = _probe(lambda: dist.all_reduce(t))
    for dt in (torch.bfloat16, torch.float32, torch.int64):
        t = torch.full((4, 3), rank + 1, dtype=dt, device="cuda")
        o = torch.empty((8, 3), dtype=dt, device="cuda")
        res["probes"][f"all_gather_into_tensor {dt}"] = _probe(
            lambda: dist.all_gather_into_tensor(o, t))
    ok = all(v == "ok" for v in res["probes"].values())
    if ok:
        try:
            res["legs"] = _legs(torch, refs)
        except Exception:  # noqa: BLE001 — reported
            res["legs_error"] = traceback.format_exc()[-2000:]
    gathered = [None, None]
    dist.all_gather_object(gathered, res)
    if rank == 0:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(gathered, indent=1, default=str))
        print(json.dumps(gathered, indent=1, default=str), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "gloo_one_card.json"))
    args = ap.parse_args()
    import multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, port, args.out)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
            p.join()
    return max(p.exitcode or 0 for p in procs)


if __name__ == "__main__":
    sys.exit(main())
