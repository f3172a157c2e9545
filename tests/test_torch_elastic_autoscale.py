"""The port's autoscale drill (crosscoder_tpu_torch/resilience/elastic_drill.py,
``run_autoscale_drill``) at 2 x 1 on gloo ranks on the CPU, the case of
tests/test_elastic.py::test_autoscale_drill_bitwise_cycle: rank 1 dies at
serve 6, rank 0 shrinks (epoch 1) and replays, ``return@10`` opens the
rejoin window, the parked returned host passes the debounce and rank 0
grows the world back to 2 x 1 (epoch 2) at a step boundary; its losses
after the grow are bitwise a clean 2 x 1 world's restoring the same
boundary save, and the joiner's bitwise its own. The Trainer's defaults
(the batch prefetch on). Bars: bitwise.

The drill at two hosts of two ranks, over the harvested mesh store and the
abort case each have a file of their own, so that the test workers run
them side by side."""

from crosscoder_tpu_torch.resilience import elastic_drill as drill

from _torch_autoscale_check import check_autoscale


def test_autoscale_drill_2x1_bitwise_cycle(tmp_path):
    report = drill.run_autoscale_drill(workdir=str(tmp_path), timeout=90.0, keep_logs=True,
                                       device="cpu")
    assert drill._autoscale_cfg(str(tmp_path), n_data=2, model=1).prefetch
    check_autoscale(report, grid=[2, 1])
    split = report["survivor"]["grow_split"]
    assert set(split) == {"save_ms", "regroup_ms", "restore_ms"}
