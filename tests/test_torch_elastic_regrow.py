"""Restore and stream parity across the elastic grow, on gloo ranks through
the fork server (``kind: grow``, ``tests/_torch_grow_child.py``); the cases
follow tests/test_restore_respec.py's grow cases and tests/test_torch_fleet.py:

- a narrow-to-wide restore, and a wide -> narrow -> wide cycle over a real
  shrink and ``grow_to``: the params exact, the step kept, the
  ``quant_grads`` error feedback dropped at data width 1 and re-created
  (zeros) at width 2, as the JAX Trainer restoring the same save on a 2 x
  1 mesh has them;
- the mesh store's stream after a shrink-then-grow reshard: bitwise a
  fresh wide store restored from the same position;
- ``FleetScheduler.remesh`` onto another grid over the same ranks (1 x 2
  <-> 2 x 1): losses and params bitwise a fresh fleet on the target grid
  restoring the same save.
"""

import numpy as np
import pytest

import jax

from crosscoder_tpu.checkpoint import Checkpointer as JCheckpointer
from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu.data.synthetic import SyntheticActivationSource as JSource
from crosscoder_tpu.parallel import mesh as jmesh
from crosscoder_tpu.train import trainer as jtrainer

from _torch_grow_child import BASE
from _torch_parallel_child import run_ranks

FLEET_SPEC = "a:seed=1;b:seed=2,l1_coeff=0.05;w:seed=3,dict_size=128"


@pytest.fixture(scope="module")
def respec(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("respec")
    return run_ranks(2, {"kind": "grow", "case": "respec", "local": 1, "root": str(tmp)},
                     tmp, timeout=120.0), tmp


def test_grow_narrow_to_wide_restore(respec):
    """A save the narrow world wrote restores on the grown grid: params
    exact, the step kept, ``quant_ef`` created at the new width, zero."""
    ranks, tmp = respec
    r0 = ranks[0]
    assert r0["narrow_ef"] is None                  # width 1 keeps no residuals
    for r in ranks:
        assert r["epoch"] == 2
        assert r["wide_step"] == 3                  # 2 wide steps, 1 narrow
        assert r["regrown_ef"] == [2] and r["regrown_ef_zero"]
        for k, v in r0["narrow_params"].items():
            np.testing.assert_array_equal(r["regrown_params"][k].numpy(), v.numpy(),
                                          err_msg=k)
        assert np.isfinite(r["regrown_loss"])
    assert ranks[0]["regrown_loss"] == ranks[1]["regrown_loss"]
    # the JAX Trainer restoring the narrow save on a 2 x 1 mesh: the same
    # params, the same fresh residuals
    jcfg = JCfg(**BASE, checkpoint_dir=str(tmp / "jax"), quant_grads=True, quant_block=32,
                data_axis_size=2)
    jtr = jtrainer.Trainer(jcfg, JSource(jcfg), mesh=jmesh.make_mesh(2, 1,
                                                                   devices=jax.devices()[:2]),
                           checkpointer=JCheckpointer(base_dir=tmp))
    meta = jtr.restore(version_dir=tmp / "version_0", save=r0["save"])
    assert int(meta["step"]) == r0["wide_step"]
    widths = {int(np.asarray(v).shape[0]) for v in jtr.state.aux["quant_ef"].values()}
    assert widths == {2}
    for k, v in r0["regrown_params"].items():
        np.testing.assert_array_equal(
            np.asarray(JCheckpointer._fetch_global(jtr.state.params[k]), np.float32),
            v.numpy(), err_msg=k)
    jtr.close()


def test_grow_cycle_wide_narrow_wide(respec):
    """Wide (2 x 1) -> the narrow survivor (1 x 1, ``quant_ef`` dropped) ->
    wide again (re-created): each hop keeps the params and steps finite."""
    ranks, _ = respec
    r0 = ranks[0]
    assert r0["wide_ef"] == [2]
    assert r0["narrow_step"] == 2 and np.isfinite(r0["narrow_loss"])
    assert r0["regrown_ef"] == [2]


def test_buffer_stream_bitwise_across_shrink_then_grow_reshard(tmp_path):
    ranks = run_ranks(2, {"kind": "grow", "case": "stream", "local": 1,
                          "root": str(tmp_path)}, tmp_path, timeout=120.0)
    for r in ranks:
        assert r["class"] == r["ref_class"] == "MeshPairedActivationBuffer"
        assert r["epoch"] == 2
        np.testing.assert_array_equal(r["got"], r["want"])
    # each rank served its own rows of the same batches
    assert not np.array_equal(ranks[0]["got"], ranks[1]["got"])


@pytest.mark.parametrize("src,dst", [((1, 2), (2, 1)), ((2, 1), (1, 2))],
                         ids=["1x2-to-2x1", "2x1-to-1x2"])
def test_fleet_remesh_restores_bitwise_a_fresh_fleet(tmp_path, src, dst):
    ranks = run_ranks(2, {"kind": "grow", "case": "fleet", "local": 1, "root": str(tmp_path),
                          "spec": FLEET_SPEC, "from": list(src), "to": list(dst)},
                      tmp_path, timeout=120.0)
    for r in ranks:
        assert r["grid"] == tuple(dst)
        assert r["cohorts"] == [["a", "b"]] and r["buckets"] == ["w"]
        assert r["restored"] == {"a": 3, "b": 3, "w": 3}
        assert r["after"] == r["fresh"]
        assert r["stream"][0] == r["stream"][1]
        for name, params in r["params"].items():
            for k, v in params.items():
                np.testing.assert_array_equal(v.numpy(), r["fresh_params"][name][k].numpy(),
                                              err_msg=f"{name}.{k}")
    assert ranks[0]["after"] == ranks[1]["after"]
