"""The compile tier on the card: every kernel library built with ``nvcc``
through a fresh tier in one process, loaded from it in a second process with
no ``nvcc`` run, and each library's kernel there bitwise the kernel of the
``build/kernels/`` library (the tier off) on one input each. Every test
needs a CUDA device and skips without one; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_compile_cache_cuda.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crosscoder_tpu_torch.ops import _build
from crosscoder_tpu_torch.utils import compile_cache

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def battery() -> dict[str, list[torch.Tensor]]:
    """One call of each library's kernel on seeded inputs: ``{library:
    [outputs on the host]}``."""
    from crosscoder_tpu_torch.ops import adam, quant, sparse_grad
    from crosscoder_tpu_torch.ops import fused_encoder_topk as fek
    from crosscoder_tpu_torch.ops import paged_attention as pa
    from crosscoder_tpu_torch.ops import topk_pallas as tp

    gen = torch.Generator().manual_seed(24)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).cuda()

    out: dict[str, list[torch.Tensor]] = {}
    q, k, v = randn(2, 128, 8, 256, dtype=torch.bfloat16), randn(
        2, 128, 4, 256, dtype=torch.bfloat16), randn(2, 128, 4, 256, dtype=torch.bfloat16)
    lens = torch.tensor([100, 128], dtype=torch.int32, device="cuda")
    out["paged_attention"] = [pa.paged_attention(q, k, v, lens, page_size=64,
                                                 scale=256 ** -0.5, softcap=50.0)]
    x, W, b = (randn(64, 256, dtype=torch.bfloat16), randn(256, 2048, dtype=torch.bfloat16),
               randn(2048))
    out["fused_topk"] = list(fek.fused_topk_encode(x, W, b, 32))
    out["fused_topk_q"] = list(fek.fused_topk_encode_q(x, W, b, 32, 128))
    out["fused_batchtopk"] = [fek.fused_batchtopk_encode(x, W, b, 8)]
    h = randn(64, 4096, dtype=torch.bfloat16)
    out["topk_mask"] = [tp.topk_mask(h, 32)]
    out["topk_mask_f32"] = [tp.topk_mask_f32(h.float(), 32)]
    out["topk_chunked"] = [tp.topk_chunked(randn(16, 2 ** 17, dtype=torch.bfloat16), 32)]
    out["sparsify"] = list(tp.sparsify(tp.topk_plain(h, 32), 32))
    kth = tp.batchtopk_select(h, 256)
    out["batchtopk"] = [kth, tp.batchtopk_emit(h, kth)]
    coeff = randn(64, 8)
    idx = torch.randint(0, 512, (64, 8), generator=gen, dtype=torch.int32).cuda()
    out["scatter_rows"] = [sparse_grad.scatter_add_rows(coeff, idx, randn(64, 256), 512)]
    out["quantize_rows"] = list(quant.quantize_rows(randn(256, 1024, dtype=torch.bfloat16), 128))
    leaves = [{"W": randn(256, 512, scale=s), "b": randn(512, scale=s)}
              for s in (0.1, 1.0, 0.01, 0.01)]
    params, grads, mu, nu = leaves
    nu = {key: t.abs() for key, t in nu.items()}
    adam.adam_update(params, grads, mu, nu, torch.tensor(2.0, device="cuda"), max_norm=1.0,
                     b1=0.9, b2=0.999, eps=1e-8, bc1=0.271, bc2=0.002997, step_size=-1e-3)
    out["adam_update"] = [t for d in (params, mu, nu) for t in d.values()]
    torch.cuda.synchronize()
    return {name: [t.cpu() for t in ts] for name, ts in out.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else (
        t.view(torch.int32) if t.element_size() == 4 else t)


_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[4])
from crosscoder_tpu_torch.ops import _build
from crosscoder_tpu_torch.utils import compile_cache

compile_cache.configure(cache_dir=sys.argv[1])
_build.build_all()
report = {"runs": dict(_build.nvcc_runs), "stats": compile_cache.disk_stats()}
if sys.argv[2] == "run":
    import test_torch_compile_cache_cuda as t
    torch.save(t.battery(), sys.argv[3])
    report["paths"] = {n: _build.load(n)._name for n in _build.kernel_names()}
print(json.dumps(report))
"""


def _child(tmp_path, tier, mode):
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, str(script), str(tier), mode, str(tmp_path / "out.pt"),
                        str(ROOT / "tests")], capture_output=True, text=True, cwd=str(ROOT),
                       env=env, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_libraries_from_the_tier_are_the_kernels_of_build_kernels(cuda, tmp_path):
    tier = tmp_path / "tier"
    names = _build.kernel_names()
    cold = _child(tmp_path, tier, "build")
    assert cold["runs"] == {n: 1 for n in names}, cold
    assert cold["stats"] == {"disk_hit": 0, "disk_miss": len(names), "evictions": 0}
    warm = _child(tmp_path, tier, "run")
    assert warm["runs"] == {}, warm                  # no nvcc in the second process
    assert warm["stats"] == {"disk_hit": len(names), "disk_miss": 0, "evictions": 0}
    root = tier / f"v{compile_cache.DISK_FORMAT}"
    assert all(Path(p).parent == root for p in warm["paths"].values()), warm["paths"]
    got = torch.load(tmp_path / "out.pt")
    # this process: the tier off, the libraries of build/kernels/
    compile_cache.configure(cache_dir="")
    want = battery()
    assert all(Path(_build.load(n)._name).parent == _build.BUILD_DIR for n in names)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert torch.equal(_bits(g), _bits(w)), name
    # the sidecars carry ptxas's report of every entry point
    for n in names:
        side = compile_cache.DiskCache(tier).cost(compile_cache.disk_key(_build._key(n)))
        assert side and any("registers" in e for e in side["entries"].values()), (n, side)
