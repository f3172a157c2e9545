"""The fleet on a rank grid (``crosscoder_tpu_torch/train/fleet.py``,
``models/stacked.py``) on gloo ranks, at the shapes of
``tests/test_torch_fleet.py`` (``d_in`` 16, dict 64): a cohort of a and b
(seed and ``l1_coeff`` apart) and a bucket w (dict 128), no resampling, on
a 2 × 1 grid (ranks 0 and 1 of 4) and a 2 × 2 grid (all four), one
4-rank launch for the file (``tests/_torch_fleet_mesh_child.py``):

- every tenant's losses and final params against the JAX
  ``FleetScheduler`` on its CPU mesh of the same shape, from the same
  initial states, at the mesh trainer's bars (rtol 2e-4 / atol 2e-5);
- every tenant BITWISE its solo mesh ``Trainer`` on the same grid over the
  same stream;
- ``save_all`` on the grid after 2 rounds, then a fresh fleet's
  ``restore_all``, continuing bitwise the uninterrupted fleet.
"""

import numpy as np
import pytest
import torch

import jax

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.models import stacked as jstacked
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import fleet as jfleet
from crosscoder_tpu_torch import convert

from _torch_parallel_child import finish_ranks, start_ranks

RTOL, ATOL = 2e-4, 2e-5
BASE = dict(d_in=16, dict_size=64, batch_size=64, num_tokens=64 * 1000, enc_dtype="fp32",
            log_backend="null", seed=11, resample_every=0)
SPEC = "a:seed=1;b:seed=2,l1_coeff=0.05;w:seed=1,dict_size=128"
GRIDS = {"2x1": (2, 1), "2x2": (2, 2)}
ROUNDS, SAVE_AT = 4, 2


def _jax_fleet(d, m):
    return jfleet.FleetScheduler(JCfg(**BASE, fleet="on", fleet_tenants=SPEC), checkpoint=False,
                                 mesh=jmesh.make_mesh(d, m, devices=jax.devices()[:d * m]))


def _jax_states(jfl):
    out = {b.tenant.name: b.state for b in jfl._buckets}
    for co in jfl._cohorts:
        for i, t in enumerate(co.members):
            out[t.name] = jstacked.unstack_state(co.state, i)
    return {n: jax.device_get(s) for n, s in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port on the gloo ranks and the JAX fleets on their meshes, the
    JAX side computed while the ranks run."""
    tmp = tmp_path_factory.mktemp("fleet_mesh")
    jfls = {g: _jax_fleet(*dm) for g, dm in GRIDS.items()}
    init = _jax_states(jfls["2x1"])
    states = {n: convert.train_state_from_numpy(s, device="cpu") for n, s in init.items()}
    torch.save(states, tmp / "states.pt")
    task = dict(kind="fleet_mesh", base=BASE, spec=SPEC, states=str(tmp / "states.pt"),
                grids=list(GRIDS.values()), meshes=["sub", "full"], rounds=ROUNDS,
                save_at=SAVE_AT, root=str(tmp / "ckpt"))
    started = start_ranks(4, task, tmp / "ranks")
    want = {}
    for g, jfl in jfls.items():
        losses = {}
        for _ in range(ROUNDS):
            for name, md in jfl.step_all().items():
                losses.setdefault(name, []).append(float(jax.device_get(md["loss"])))
        want[g] = (losses, {n: s.params for n, s in _jax_states(jfl).items()})
    return finish_ranks(started, timeout=300), want


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_fleet_on_a_grid_matches_the_jax_fleet(runs, grid):
    got, want = runs
    w_losses, w_params = want[grid]
    for r, res in enumerate(got):
        if grid not in res:
            assert grid == "2x1" and r >= 2            # idle ranks of the sub-grid
            continue
        assert res[grid]["cohorts"] == [["a", "b"]] and res[grid]["buckets"] == ["w"]
        assert sorted(res[grid]["fleet"]) == sorted(w_losses)
        for name in w_losses:
            np.testing.assert_allclose(res[grid]["fleet"][name], w_losses[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{grid} rank {r} {name}")
            for k, v in res[grid]["fleet_params"][name].items():
                np.testing.assert_allclose(v, w_params[name][k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{grid} rank {r} {name} {k}")


def test_the_jax_fleet_is_the_same_on_both_grids(runs):
    _, want = runs
    for name, ls in want["2x1"][0].items():
        np.testing.assert_allclose(want["2x2"][0][name], ls, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_every_tenant_is_bitwise_its_solo_mesh_trainer(runs, grid):
    got, _ = runs
    for res in got:
        if grid not in res:
            continue
        res = res[grid]
        for name, ls in res["solo"].items():
            assert res["fleet"][name] == ls, name
            for k, v in res["solo_params"][name].items():
                np.testing.assert_array_equal(res["fleet_params"][name][k], v, err_msg=name)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_restore_all_after_save_all_on_the_grid_continues_bitwise(runs, grid):
    got, _ = runs
    for res in got:
        if grid not in res:
            continue
        res = res[grid]
        assert res["restored_at"] == {n: SAVE_AT for n in ("a", "b", "w")}
        for name, ls in res["restored"].items():
            assert ls == res["fleet"][name][SAVE_AT:], name
            for k, v in res["restored_params"][name].items():
                np.testing.assert_array_equal(v, res["fleet_params"][name][k], err_msg=name)


def test_every_rank_holds_the_same_roster_and_losses(runs):
    got, _ = runs
    for grid in GRIDS:
        ranks = [res[grid] for res in got if grid in res]
        assert len(ranks) == GRIDS[grid][0] * GRIDS[grid][1]
        for res in ranks[1:]:
            assert res["fleet"] == ranks[0]["fleet"]
            assert (res["cohorts"], res["buckets"]) == (ranks[0]["cohorts"], ranks[0]["buckets"])


def test_quant_grads_stays_refused_under_the_fleet():
    from crosscoder_tpu_torch.config import CrossCoderConfig

    with pytest.raises(ValueError) as got:
        CrossCoderConfig(**BASE, fleet="on", quant_grads=True)
    with pytest.raises(ValueError) as want:
        JCfg(**BASE, fleet="on", quant_grads=True)
    assert str(got.value) == str(want.value)
