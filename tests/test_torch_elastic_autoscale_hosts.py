"""The port's autoscale drill at two hosts of two gloo ranks on the CPU,
data 2 x model 2 -> 1 x 2 -> 2 x 2 (the TP width kept, as the JAX drill's
2 x 4 -> 1 x 4 -> 2 x 4): host 1 dies, host 0's ranks shrink and replay,
rank 0 alone reads the board and shares its answer and the admit record
(ROADMAP C15), the returned host of two ranks comes back whole (one
announce for both) at ranks 2 and 3, and the grown world's losses are
bitwise a clean 2 x 2 world's from the same boundary save."""

from crosscoder_tpu_torch.resilience import elastic_drill as drill

from _torch_autoscale_check import check_autoscale


def test_autoscale_drill_two_hosts_of_two_ranks(tmp_path):
    report = drill.run_autoscale_drill(workdir=str(tmp_path), timeout=120.0, world=4,
                                       local=2, model=2, device="cpu")
    check_autoscale(report, grid=[2, 2])
    assert len(report["survivors"]) == len(report["joiners"]) == 2
    # both survivors went through the same shrink and grow
    s0, s1 = report["survivors"]
    for k in ("step", "save", "epoch", "grown", "n_data", "version_dir"):
        assert s0["grow"][k] == s1["grow"][k], k
    assert s0["losses"] == s1["losses"]
