"""Elastic membership on the card. Every test needs a CUDA device and skips
without one; the file imports no JAX:

    python -m pytest -m cuda tests/test_torch_elastic_cuda.py

- the preempt drill on two gloo ranks sharing the card at a small width
  (TopK with the sparse backward and AuxK, bf16 compute): rank 1 dies, rank
  0 shrinks to one rank on the card, restores and finishes, bitwise a clean
  one-rank restart; K5, K8, K10 and O1 launch on both sides of the re-mesh;
- the autoscale drill at 2 x 1 on gloo ranks sharing the card at the same
  width: rank 1 dies, rank 0 shrinks, the returned host rejoins and the
  world grows back to 2 x 1; the survivor after the grow bitwise a clean 2
  x 1 world's from the same boundary save, the joiner bitwise the
  survivor; K5, K8, K10 and O1 launch on both sides of the grow, on the
  joiner too;
- the NCCL shrink at the one world size one card holds: an elastic world
  of one NCCL rank leaves its groups through the abort path and joins
  epoch 1, whose all-reduce runs.

Bars: bitwise."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from crosscoder_tpu_torch.resilience import elastic_drill as drill

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(d_in=256, dict_size=4096, batch_size=1024, num_tokens=1024 * 200,
             activation="topk", topk_k=16, l1_coeff=0.0, sparse_bwd="on", aux_k=32,
             aux_every=2, aux_dead_steps=2, enc_dtype="bf16", master_dtype="fp32")
KERNELS = ("topk_mask", "sparsify", "scatter_add_rows", "adam_update")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")


def test_preempt_drill_shrinks_on_the_card(cuda, tmp_path):
    report = drill.run_drill(workdir=str(tmp_path), timeout=300.0, device="cuda",
                             overrides=SMALL)
    assert report["bitwise_equal"], (report["post_losses"], report["restart_losses"])
    surv = report["survivor"]
    assert surv["remesh"]["epoch"] == 1 and surv["grid"] == [1, 1]
    before, total = surv["launches_before"], surv["launches"]
    for k in KERNELS:
        assert before[k] > 0 and total[k] > before[k], (k, before, total)


def test_autoscale_drill_grows_on_the_card(cuda, tmp_path):
    report = drill.run_autoscale_drill(workdir=str(tmp_path), timeout=300.0, device="cuda",
                                       overrides=SMALL)
    assert report["bitwise_equal"], (report["post_losses"], report["clean_losses"])
    assert report["joiner_equal"], (report["post_losses"], report["joiner_losses"])
    surv = report["survivor"]
    assert surv["counters"].get("resilience/grows") == 1 and report["epoch"] == 2
    assert surv["grid"] == [2, 1] and report["joiner"]["grid"] == [2, 1]
    before, total = surv["launches_before_grow"], surv["launches"]
    for k in KERNELS:
        assert before[k] > 0 and total[k] > before[k], (k, before, total)
        assert report["joiner"]["launches"][k] > 0, (k, report["joiner"]["launches"])


def test_nccl_shrink_at_world_size_one(cuda, tmp_path):
    script = textwrap.dedent("""
        import json, socket, sys
        import torch
        from crosscoder_tpu_torch.parallel import collectives as coll
        from crosscoder_tpu_torch.parallel import mesh as mesh_lib
        from crosscoder_tpu_torch.parallel import multihost

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        m0 = multihost.elastic_initialize(f"127.0.0.1:{port}", 1, 0, device="cuda:0",
                                          local_world_size=1)
        backend0 = torch.distributed.get_backend()
        mesh = mesh_lib.make_mesh(1, 1)
        t = torch.ones(8, device="cuda")
        coll.all_reduce_(t, mesh.world_group)
        m1 = multihost.shrink_to_local()
        mesh = mesh_lib.make_mesh(1, 1)
        t2 = torch.full((8,), 3.0, device="cuda")
        coll.all_reduce_(t2, mesh.world_group)
        torch.cuda.synchronize()
        print(json.dumps({"epochs": [m0.epoch, m1.epoch], "backend": [
            backend0, torch.distributed.get_backend()], "sum": t2.sum().item()}))
        multihost.shutdown()
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"epochs": [0, 1], "backend": ["nccl", "nccl"], "sum": 24.0}
