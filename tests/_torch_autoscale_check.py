"""The JAX autoscale drill's assertions (tests/test_elastic.py::
test_autoscale_drill_bitwise_cycle) on a report of the port's
``run_autoscale_drill``, shared by the drill's test files. Imports no JAX."""

from crosscoder_tpu_torch.resilience import elastic_drill as drill


def check_autoscale(report, grid):
    """The JAX drill's assertions on a port report, at the grown ``grid``."""
    assert report["bitwise_equal"], {"post": report["post_losses"],
                                     "clean": report["clean_losses"]}
    assert report["joiner_equal"], {"post": report["post_losses"],
                                    "joiner": report["joiner_losses"]}
    assert report["remesh_ms"] > 0 and report["grow_ms"] > 0
    surv, join = report["survivor"], report["joiner"]
    # one shrink and one grow: two remeshes, one of them a grow
    assert surv["counters"].get("resilience/remeshes") == 2
    assert surv["counters"].get("resilience/grows") == 1
    assert surv["counters"].get("resilience/grow_aborts") is None
    # the grow: the shrink's epoch (1) + 1, back to the wide data width
    assert surv["grow"]["epoch"] == 2 == report["epoch"]
    assert surv["grow"]["n_data"] == 2
    # every member finishes the whole run: no lost steps, no restart
    for r in (*report["survivors"], *report["joiners"]):
        assert r["final_step"] == report["steps"]
        assert r["grid"] == grid and r["epoch"] == 2
    # hydration restored the grow's boundary save on every member
    assert report["resume_step"] == surv["grow"]["step"]
    assert [s for s, _ in report["post_losses"]] == list(
        range(report["resume_step"], report["steps"]))
    # the survivor resumed narrow from the newest save before the death,
    # and the dwell held the grow off for at least elastic_dwell_steps
    assert surv["remesh"]["step"] < drill._AUTOSCALE["die_serve"]
    assert surv["grow"]["step"] >= surv["remesh"]["step"] + drill._AUTOSCALE["dwell"]
    # the joiners took the ranks after the survivors', in admit order
    admit = join["admit"]
    local = len(report["survivors"])
    assert admit["assignments"] == {drill._REJOIN_ID: local}
    assert sorted(j["rank"] for j in report["joiners"]) == list(range(local, 2 * local))
    assert admit["save"] == surv["grow"]["save"] and admit["epoch"] == 2
