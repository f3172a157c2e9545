"""The fleet's kernel work on the card: O1 (``csrc/adam_update.cu``) over a
cohort's stacked leaves with one global norm a tenant, bitwise against
its plain version and against one solo launch a tenant, over f32 leaves
and over bf16 masters beside an f32 ``log_theta``, each tenant on either
side of the clip; and a small fleet (a cohort of three TopK tenants and a
BatchTopK bucket) whose every tenant is bitwise its solo Trainer on the
card, with O1 launched once a cohort and once a bucket a round. Every
test needs a CUDA device and skips without one; the file imports no JAX:

    python -m pytest -m cuda tests/test_torch_fleet_cuda.py

Bars: bitwise."""

import dataclasses

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
from crosscoder_tpu_torch.ops import adam
from crosscoder_tpu_torch.train.fleet import FleetScheduler, TenantSpec
from crosscoder_tpu_torch.train.trainer import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("master", [torch.float32, torch.bfloat16], ids=["f32", "bf16_mixed"])
@pytest.mark.parametrize("norms", [(0.5, 4.0, 0.999), (4.0, 0.25, 1.0)],
                         ids=["one_clipped", "two_clipped"])
@pytest.mark.parametrize("H", [1000, 4096 + 3])
def test_cohort_adam_bitwise_plain_and_solo_launches(cuda, master, norms, H):
    n = len(norms)
    gen = torch.Generator(device="cuda").manual_seed(H)
    shapes = {"W_enc": (n, 2, 64, H), "W_dec": (n, H, 2, 64), "b_enc": (n, H),
              "b_dec": (n, 2, 64)}
    if master == torch.bfloat16:
        shapes["log_theta"] = (n, H)

    def leaves(scale, positive=False):
        out = {}
        for k, s in shapes.items():
            t = torch.randn(s, generator=gen, device="cuda") * scale
            out[k] = (t.abs() if positive else t).to(torch.float32 if k == "log_theta" else master)
        return out

    p, g, m, v = leaves(0.1), leaves(1.0), leaves(0.01), leaves(1e-4, positive=True)
    norm = torch.tensor(norms, dtype=torch.float32, device="cuda")
    kw = dict(max_norm=1.0, b1=0.9, b2=0.999, eps=1e-8, bc1=0.271, bc2=0.002997,
              step_size=-1e-3)
    outs = [tuple({k: torch.empty_like(t) for k, t in p.items()} for _ in range(3))
            for _ in range(2)]
    before, cohort = adam.adam_update.launches, adam.adam_update.cohort_launches
    adam.adam_update(p, g, m, v, norm, out=outs[0], **kw)
    adam.adam_update_plain(p, g, m, v, norm, out=outs[1], **kw)
    assert adam.adam_update.launches == before + 1
    assert adam.adam_update.cohort_launches == cohort + 1
    for a, b in zip(*outs):
        for k in p:
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
    for t in range(n):
        solo = tuple({k: torch.empty_like(x[t]) for k, x in p.items()} for _ in range(3))
        adam.adam_update(*({k: x[t] for k, x in d.items()} for d in (p, g, m, v)), norm[t],
                         out=solo, **kw)
        for a, b in zip(outs[0], solo):
            for k in p:
                assert torch.equal(_bits(a[k][t]), _bits(b[k])), (t, k)
    assert adam.adam_update.cohort_launches == cohort + 1


def test_small_fleet_round_is_bitwise_its_solo_runs(cuda):
    base = dict(d_in=64, n_models=2, dict_size=1024, batch_size=256, num_tokens=256 * 6,
                enc_dtype="bf16", log_backend="null", seed=11, activation="topk", topk_k=16,
                aux_k=32, aux_every=2, aux_dead_steps=2, lr=1e-3)
    spec = "a:seed=1,l1_coeff=0;b:seed=2,l1_coeff=0;c:seed=3,l1_coeff=0.001"
    late = TenantSpec("bt", {"seed": 4, "activation": "batchtopk", "dict_size": 512,
                             "aux_k": 0})
    fl = FleetScheduler(CrossCoderConfig(**base, fleet="on", fleet_tenants=spec),
                        checkpoint=False)
    before, cohort = adam.adam_update.launches, adam.adam_update.cohort_launches
    got: dict[str, list[float]] = {}

    def run(n):
        for _ in range(n):
            for name, md in fl.step_all().items():
                got.setdefault(name, []).append(float(md["loss"]))

    run(2)
    fl.admit(late)
    run(2)
    bt_state = fl.tenant_state("bt")
    fl.retire("bt", save=False)
    run(2)
    assert adam.adam_update.cohort_launches - cohort == 6
    assert adam.adam_update.launches - before == 6 + 2
    cfg = CrossCoderConfig(**base)
    for name, ov, skip, steps in (("a", dict(seed=1, l1_coeff=0.0), 0, 6),
                                  ("b", dict(seed=2, l1_coeff=0.0), 0, 6),
                                  ("c", dict(seed=3, l1_coeff=0.001), 0, 6),
                                  ("bt", late.overrides, 2, 2)):
        src = SyntheticActivationSource(cfg)
        for _ in range(skip):
            src.next()
        tr = Trainer(dataclasses.replace(cfg, **ov), src)
        assert [float(tr.step()["loss"]) for _ in range(steps)] == got[name], name
        st = bt_state if name == "bt" else fl.tenant_state(name)
        for a, b in ((st.params, tr.state.params), (st.opt_state.mu, tr.state.opt_state.mu),
                     (st.opt_state.nu, tr.state.opt_state.nu)):
            for k in a:
                assert torch.equal(_bits(a[k]), _bits(b[k])), (name, k)
