"""The port's autoscale drill at 2 x 1 over the harvested mesh store (the
tiny LM pair) on the CPU: the survivor's store goes through
``prepare_reshard``, ``reshard(refill=False)`` and the restore onto 1 x 1
and back onto 2 x 1, the joiner builds its store lazy and fills it from the
boundary save's stream position; bitwise a clean 2 x 1 world's."""

from crosscoder_tpu_torch.resilience import elastic_drill as drill

from _torch_autoscale_check import check_autoscale


def test_autoscale_drill_over_the_harvested_mesh_store(tmp_path):
    report = drill.run_autoscale_drill(workdir=str(tmp_path), timeout=90.0, device="cpu",
                                       source="harvest")
    check_autoscale(report, grid=[2, 1])
    for r in (report["survivor"], report["joiner"], report["clean"]):
        assert r["buffer"] == "MeshPairedActivationBuffer"
