"""The autoscale drill's abort case on the CPU: the returned host passes
the debounce and is admitted, then dies before the rendezvous. The
survivor waits out the arrival barrier (twice the collective bound, 4 s
here), counts one ``grow_abort``, burns the failed epoch (2), re-forms
narrow at epoch 3, restores the boundary save there and finishes the run."""

from crosscoder_tpu_torch.resilience import elastic_drill as drill


def test_autoscale_drill_a_vanished_joiner_aborts_the_grow(tmp_path):
    report = drill.run_autoscale_drill(workdir=str(tmp_path), timeout=90.0, device="cpu",
                                       vanish=True, collective_timeout_s=4.0)
    surv = report["survivor"]
    counters = surv["counters"]
    assert counters.get("resilience/grow_aborts") == 1
    assert counters.get("resilience/grows") is None
    assert counters.get("resilience/remeshes") == 1          # the shrink alone
    grow = surv["grow"]
    assert grow["grown"] is False and grow["n_data"] == 1
    # the epochs stay monotone: the shrink's 1, the burned 2, the narrow 3
    assert surv["remesh"]["epoch"] == 1 and grow["epoch"] == surv["epoch"] == 3
    assert surv["grid"] == [1, 1] and surv["final_step"] == report["steps"]
    assert report["resume_step"] == grow["step"]
    assert [s for s, _ in report["post_losses"]] == list(range(grow["step"], report["steps"]))
    assert report["bitwise_equal"] is None and report["joiner"] is None
    # the failed admission's record is gone from the board
    assert not (tmp_path / "elastic_board" / "admit_2.json").exists()
