"""The port's compile tier (crosscoder_tpu_torch/utils/compile_cache.py and
ops/_build.py routed through it), on the CPU.

There is no nvcc here, so the tier's logic runs over a stand-in: a shell
script in ``$CUDA_HOME/bin/nvcc`` that compiles the stand-in sources (C
under ``.cu`` names) with the system ``cc`` into real shared libraries and
prints a ptxas-style report; ``_build`` runs it, ``dlopen``s its output and
calls into it through ctypes. The tests skip where ``cc`` is missing.

Held against the JAX tier where JAX's case passes: ``variant_key``, the
manifest's schema, eviction's survivors and ``warm_start``'s report keys.
Held against the port's own cold and warm runs where JAX's case is red (C0:
the roundtrip with its sidecar, the cross-process claim): the corrupt, stale
and tampered entries rebuilt, two real processes building once, the tier
off by default with ``_lib_path`` unchanged, the memo, and
``KernelBuildError`` from a failed build."""

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.obs import Observability
from crosscoder_tpu_torch.ops import _build
from crosscoder_tpu_torch.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]

STANDIN_NVCC = r"""#!/bin/sh
# stand-in nvcc: the system cc on C sources named .cu, a ptxas-style report
if [ "$1" = "--version" ]; then
  echo "nvcc: the stand-in compiler"
  echo "Cuda compilation tools, release 0.0, V0.0.0"
  echo "Build stand-in"
  exit 0
fi
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift 2;;
    *.cu) src="$1"; shift;;
    *) shift;;
  esac
done
name=$(basename "$src" .cu)
echo "$name" >> "$STANDIN_NVCC_LOG"
sleep "${STANDIN_NVCC_SLEEP:-0}"
if grep -q NOT_A_LIBRARY "$src"; then echo "not an ELF file" > "$out"; exit 0; fi
cc -shared -fPIC -x c -I "$(dirname "$src")" -o "$out" "$src" || exit 1
echo "ptxas info    : 0 bytes gmem"
echo "ptxas info    : Compiling entry function '${name}_kernel' for 'sm_90a'"
echo "ptxas info    : Function properties for ${name}_kernel"
echo "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads"
echo "ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem"
"""

SOURCES = {
    "alpha": '#include "common.cuh"\nint alpha_value(void) { return BASE + 1; }\n',
    "beta": '#include "common.cuh"\nint beta_value(void) { return BASE + 2; }\n',
    "gamma": '#include "common.cuh"\nint gamma_value(void) { return BASE + 3; }\n',
}
HEADER = "#define BASE 40\n"


def _value(lib, name):
    fn = getattr(lib, f"{name}_value")
    fn.restype = ctypes.c_int
    return fn()


@pytest.fixture(autouse=True)
def _fresh_tier(monkeypatch):
    """Every module-level table of the tier and of _build fresh, and put back."""
    for name, empty in (("_AOT_CACHE", type(compile_cache._AOT_CACHE)()),
                        ("_COST_CACHE", {}), ("_INFLIGHT", {}), ("_OBSERVERS", [])):
        monkeypatch.setattr(compile_cache, name, empty)
    monkeypatch.setattr(compile_cache, "_DISK", None)
    monkeypatch.setattr(compile_cache, "_VERIFY", "off")
    monkeypatch.delenv("CROSSCODER_COMPILE_CACHE_DIR", raising=False)
    yield


@pytest.fixture
def standin(tmp_path, monkeypatch):
    """The stand-in toolkit and sources; ``_build`` pointed at them."""
    if shutil.which("cc") is None:
        pytest.skip("needs the system cc to build stand-in libraries")
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(STANDIN_NVCC)
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name, text in SOURCES.items():
        (csrc / f"{name}.cu").write_text(text)
    (csrc / "common.cuh").write_text(HEADER)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setenv("STANDIN_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc_runs", Counter())

    class Kit:
        root = tmp_path

        @staticmethod
        def runs():
            return Counter(log.read_text().split())

    return Kit


def _fresh_process():
    """What a new process has: no memo, no loaded library in _build."""
    with compile_cache._LOCK:
        compile_cache._AOT_CACHE.clear()
        compile_cache._COST_CACHE.clear()
    _build._libs.clear()


def _entry(tier):
    [path] = sorted((tier / f"v{compile_cache.DISK_FORMAT}").glob("*.so"))
    return path


def _replace(path, data: bytes):
    """Rewrite an entry file as the tier itself would: a new file renamed
    over it, never in place."""
    tmp = path.with_name(path.name + ".test")
    tmp.write_bytes(data)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# off by default: _build as it was


def test_tier_off_by_default_and_lib_path_unchanged(standin):
    compile_cache.configure(CrossCoderConfig(d_in=16, dict_size=64))
    assert not compile_cache.disk_enabled()
    assert compile_cache.disk_entry_count() == 0
    assert compile_cache.disk_stats() == {"disk_hit": 0, "disk_miss": 0, "evictions": 0}
    # the library's name: source, every header and the flags, hashed as before
    src = (_build.CSRC / "alpha.cu").read_bytes() + HEADER.encode()
    want = hashlib.sha256(src + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert _build._lib_path("alpha") == _build.BUILD_DIR / f"alpha-{want}.so"
    lib = _build.load("alpha", {"alpha_value": []})
    assert lib.alpha_value() == 41
    assert _build._lib_path("alpha").is_file()
    assert _build.library_cost("alpha")["entries"]["alpha_kernel"]["registers"] == 40
    logs = _build.build_all()
    assert sorted(logs) == ["beta", "gamma"] and "Used 40 registers" in logs["beta"]
    assert _build.build_all() == {}
    assert standin.runs() == Counter(alpha=1, beta=1, gamma=1)
    assert sorted(p.name for p in _build.BUILD_DIR.iterdir()) == sorted(
        _build._lib_path(n).name for n in SOURCES)


def test_the_real_libraries_keep_their_names():
    """The checkout's own kernels: named by the formula of the tier-less
    build, whatever the tier."""
    for name in _build.kernel_names():
        src = (_build.CSRC / f"{name}.cu").read_bytes()
        headers = b"".join(p.read_bytes() for p in sorted(_build.CSRC.glob("*.cuh")))
        key = hashlib.sha256(src + headers + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()
        assert _build._lib_path(name) == _build.BUILD_DIR / f"{name}-{key[:16]}.so"
        assert _build._key(name) == (name, key)
    assert len(_build.kernel_names()) == 12


# ---------------------------------------------------------------------------
# lifecycle: miss -> store -> hit (JAX's roundtrip case is red, C0)


def test_cold_then_warm_roundtrip_with_cost_sidecar(standin):
    tier = standin.root / "tier"
    disk = compile_cache.configure(cache_dir=str(tier))
    assert disk is not None and compile_cache.disk_enabled()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=1) and _build.compiles() == 1
    assert compile_cache.disk_entry_count() == 1
    assert compile_cache.disk_stats() == {"disk_hit": 0, "disk_miss": 1, "evictions": 0}
    assert not (_build.BUILD_DIR).exists()          # the tier, not build/kernels
    cost = _build.library_cost("alpha")
    assert cost == {"entries": {"alpha_kernel": {
        "stack_bytes": 8, "spill_stores": 4, "spill_loads": 12, "registers": 40,
        "smem_bytes": 1024, "barriers": 1}}}
    meta = json.loads(_entry(tier).with_suffix(".meta.json").read_text())
    assert meta["format"] == compile_cache.DISK_FORMAT
    assert meta["fingerprint"] == compile_cache.backend_fingerprint()
    assert meta["src_sha"] == _build.source_hash("alpha")
    assert meta["lib_sha"] == hashlib.sha256(_entry(tier).read_bytes()).hexdigest()
    assert "release 0.0" in compile_cache.backend_fingerprint()
    # a second process: a cold memo over the same tier loads without nvcc,
    # and the sidecar answers for the cost
    _fresh_process()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=1)
    assert compile_cache.disk_stats()["disk_hit"] == 1
    assert _build.library_cost("alpha") == cost
    _fresh_process()
    assert compile_cache.cost_of(_build._key("alpha")) == cost   # no library touched


def test_build_all_acquires_every_library_through_the_tier(standin):
    compile_cache.configure(cache_dir=str(standin.root / "tier"))
    logs = _build.build_all()
    assert sorted(logs) == sorted(SOURCES) and all("registers" in t for t in logs.values())
    assert standin.runs() == Counter(alpha=1, beta=1, gamma=1)
    assert compile_cache.disk_entry_count() == 3
    # loaded by build_all, prototyped by load, no second acquisition
    stats = compile_cache.disk_stats()
    lib = _build.load("gamma", {"gamma_value": []})
    assert lib.gamma_value() == 43 and compile_cache.disk_stats() == stats
    _fresh_process()
    assert _build.build_all() == {}
    assert compile_cache.disk_stats()["disk_hit"] == 3
    assert standin.runs() == Counter(alpha=1, beta=1, gamma=1)


def test_build_all_builds_in_parallel_through_the_tier(standin, monkeypatch):
    """Three sources of 1 s each: one thread a source, so about 1 s, not 3."""
    monkeypatch.setenv("STANDIN_NVCC_SLEEP", "1")
    compile_cache.configure(cache_dir=str(standin.root / "tier"))
    t0 = time.perf_counter()
    _build.build_all()
    assert time.perf_counter() - t0 < 2.5
    assert standin.runs() == Counter(alpha=1, beta=1, gamma=1)


def test_eviction_respects_byte_cap(standin):
    disk = compile_cache.configure(cache_dir=str(standin.root / "tier"))
    _build.build_all()
    one = max(p.stat().st_size for p in disk.root.glob("*.so"))
    disk.max_bytes = int(2.5 * one)
    digests = []
    for i, name in enumerate(sorted(SOURCES)):
        path = disk.lib_path(compile_cache.disk_key(_build._key(name)))
        os.utime(path, (1000.0 + i, 1000.0 + i))
        digests.append(path.name[:-len(".so")])
    (standin.root / "csrc" / "delta.cu").write_text("int delta_value(void) { return 4; }\n")
    _build.load("delta")            # the fourth entry pushes the oldest out
    total = sum(p.stat().st_size for p in disk.root.glob("*.so"))
    assert total <= int(2.5 * one)
    assert not disk.has(digests[0]) and disk.has(digests[2])
    assert disk.stats["evictions"] >= 1
    assert digests[0] not in disk.manifest()["entries"]
    assert not disk.root.joinpath(f"{digests[0]}.meta.json").exists()


# ---------------------------------------------------------------------------
# the gates: a corrupt, stale or tampered entry is built anew by nvcc


def test_corrupt_entry_is_rebuilt(standin):
    tier = standin.root / "tier"
    compile_cache.configure(cache_dir=str(tier))
    _build.load("alpha")
    _replace(_entry(tier), b"\x00garbage" * 16)
    _fresh_process()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=2)          # rebuilt, not served from a plain op
    assert compile_cache.disk_stats()["disk_miss"] == 2
    # the rebuild placed a healthy entry: the next cold lookup loads it
    _fresh_process()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=2)
    assert compile_cache.disk_stats()["disk_hit"] == 1


def test_entry_without_metadata_is_rebuilt(standin):
    tier = standin.root / "tier"
    compile_cache.configure(cache_dir=str(tier))
    _build.load("beta")
    _entry(tier).with_suffix(".meta.json").unlink()
    _fresh_process()
    assert _value(_build.load("beta"), "beta") == 42
    assert standin.runs() == Counter(beta=2)


def test_fingerprint_mismatch_is_rebuilt(standin):
    tier = standin.root / "tier"
    compile_cache.configure(cache_dir=str(tier))
    _build.load("alpha")
    meta_path = _entry(tier).with_suffix(".meta.json")
    meta = json.loads(meta_path.read_text())
    meta["fingerprint"] = "torch=0.0,cuda=0.0,nvcc=an older release,device=another card"
    _replace(meta_path, json.dumps(meta).encode())
    _fresh_process()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=2)          # a stale entry never loads
    assert compile_cache.disk_stats()["disk_miss"] >= 2
    meta = json.loads(meta_path.read_text())
    assert meta["fingerprint"] == compile_cache.backend_fingerprint()


def test_strict_verify_rejects_a_tampered_entry(standin):
    tier = standin.root / "tier"
    disk = compile_cache.configure(cache_dir=str(tier), verify="strict")
    _build.load("alpha")
    digest = _entry(tier).name[:-len(".so")]
    lower = lambda: _build.source_hash("alpha")   # noqa: E731
    # an honest entry passes
    assert disk.load(digest, lower=lower, verify="strict") is not None
    # the library swapped for another that loads: off mode takes it, strict does not
    other = standin.root / "other.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-x", "c", "-o", str(other), "-"],
                   input="int alpha_value(void) { return 7; }\n", text=True, check=True)
    _replace(_entry(tier), other.read_bytes())
    path = _entry(tier)
    assert disk.load(digest, lower=lower, verify="strict") is None
    assert not path.exists()                        # rejected AND discarded
    # a strict process rebuilds it with nvcc
    _fresh_process()
    assert _value(_build.load("alpha"), "alpha") == 41
    assert standin.runs() == Counter(alpha=2)
    # the stored source hash lies: rejected too
    meta_path = _entry(tier).with_suffix(".meta.json")
    meta = json.loads(meta_path.read_text())
    meta["src_sha"] = "0" * 64
    _replace(meta_path, json.dumps(meta).encode())
    assert disk.load(digest, lower=lower, verify="strict") is None
    # an entry it cannot verify (no live hash) misses under strict
    assert disk.load(digest, lower=None, verify="strict") is None


def test_nvcc_failure_still_raises_kernel_build_error(standin):
    (standin.root / "csrc" / "broken.cu").write_text("#error the stand-in build fails\n")
    with pytest.raises(_build.KernelBuildError, match="nvcc failed on csrc/broken.cu"):
        _build.load("broken")
    tier = standin.root / "tier"
    disk = compile_cache.configure(cache_dir=str(tier))
    with pytest.raises(_build.KernelBuildError, match="nvcc failed on csrc/broken.cu"):
        _build.load("broken")
    with pytest.raises(_build.KernelBuildError):
        _build.build_all()
    assert not list(disk.root.glob("broken*"))       # no entry, no claim, no scratch left
    assert not list(disk.root.glob("*.claim"))
    assert "broken" not in _build._libs


def test_a_fresh_build_that_does_not_load_raises(standin):
    (standin.root / "csrc" / "hollow.cu").write_text("/* NOT_A_LIBRARY */\n")
    disk = compile_cache.configure(cache_dir=str(standin.root / "tier"))
    with pytest.raises(_build.KernelBuildError, match="does not load"):
        _build.load("hollow")
    assert standin.runs() == Counter(hollow=1)
    assert not list(disk.root.glob("*.so")) and not list(disk.root.glob("*.tmp"))


# ---------------------------------------------------------------------------
# two real processes: one nvcc a library (JAX's case is red, C0)

_RACE = r"""
import json, sys
from pathlib import Path
from crosscoder_tpu_torch.ops import _build
from crosscoder_tpu_torch.utils import compile_cache

_build.CSRC = Path(sys.argv[2])
compile_cache.configure(cache_dir=sys.argv[1])
_build.build_all()
values = {n: getattr(_build.load(n), f"{n}_value")() for n in _build.kernel_names()}
print(json.dumps({"runs": dict(_build.nvcc_runs), "values": values,
                  "stats": compile_cache.disk_stats()}))
"""


def test_two_processes_build_each_library_once(standin, monkeypatch):
    """Two cold processes racing over one tier: each source is claimed by
    one of them, built once, and loaded by the other from the tier."""
    monkeypatch.setenv("STANDIN_NVCC_SLEEP", "1")
    tier = standin.root / "tier"
    script = standin.root / "race.py"
    script.write_text(_RACE)
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(tier), str(_build.CSRC)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(ROOT), env=env) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    reports = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    runs = sum((Counter(r["runs"]) for r in reports), Counter())
    assert runs == Counter(alpha=1, beta=1, gamma=1), reports
    assert standin.runs() == runs
    assert all(r["values"] == {"alpha": 41, "beta": 42, "gamma": 43} for r in reports)
    # every library a process did not build, it loaded from the tier
    for r in reports:
        assert r["stats"]["disk_hit"] == 3 - sum(r["runs"].values()), reports
    assert compile_cache.configure(cache_dir=str(tier)) is not None
    assert compile_cache.disk_entry_count() == 3


def test_a_loser_of_the_claim_loads_the_leaders_entry(standin):
    """In one process: the claim held by another leader, the loser waits and
    loads what the leader placed, with no nvcc of its own."""
    tier = standin.root / "tier"
    disk = compile_cache.configure(cache_dir=str(tier))
    key = _build._key("alpha")
    dk = compile_cache.disk_key(key)
    assert disk.claim(dk) and not disk.claim(dk)

    def leader():
        time.sleep(0.3)
        built = _build._build_scratch("alpha", None)
        disk.store(dk, built, lower=lambda: _build.source_hash("alpha"))
        disk.release(dk)

    t = threading.Thread(target=leader)
    t.start()
    runs_before = _build.compiles()
    lib = compile_cache.aot_get(key, lambda: pytest.fail("the loser built"),
                                lower=lambda: _build.source_hash("alpha"))
    t.join()
    assert _value(lib, "alpha") == 41
    assert _build.compiles() == runs_before + 1        # the leader's build alone
    assert compile_cache.disk_stats()["disk_hit"] == 1


def test_a_stale_claim_is_stolen(standin, monkeypatch):
    disk = compile_cache.configure(cache_dir=str(standin.root / "tier"))
    dk = compile_cache.disk_key(_build._key("alpha"))
    assert disk.claim(dk)
    claim = disk.root / f"{dk}.claim"
    os.utime(claim, (time.time() - 3600, time.time() - 3600))
    monkeypatch.setattr(compile_cache, "_CLAIM_TTL_S", 600.0)
    assert disk.claim(dk)


# ---------------------------------------------------------------------------
# the in-process memo: bounded, thread-safe, one build a key


def test_memo_hammer_one_build_per_key():
    """8 threads hammering the same 32 keys: concurrent misses coalesce onto
    ONE build each, every caller gets the same object."""
    n_keys, n_threads = 32, 8
    builds = {k: 0 for k in range(n_keys)}
    build_lock = threading.Lock()
    barrier = threading.Barrier(n_threads)
    errors = []

    def worker(seed):
        try:
            barrier.wait()
            for j in range(n_keys):
                k = (j + seed) % n_keys

                def build(k=k):
                    with build_lock:
                        builds[k] += 1
                    return ("lib", k)
                assert compile_cache.aot_get(("hammer", k), build) == ("lib", k)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert all(builds[k] == 1 for k in range(n_keys)), builds


def test_memo_is_bounded_and_costs_survive_eviction(monkeypatch):
    monkeypatch.setattr(compile_cache, "_AOT_CACHE_CAP", 8)
    built = compile_cache.Built(Path("unused.so"), "ptxas info    : Function properties for k\n"
                                "ptxas info    : Used 17 registers, used 0 barriers\n")
    for k in range(32):
        compile_cache.aot_get(("bounded", k), lambda: built)
    assert len(compile_cache._AOT_CACHE) <= 8
    assert compile_cache.cost_of(("bounded", 0)) == {"entries": {"k": {"registers": 17,
                                                                       "barriers": 0}}}


def test_ptxas_report_is_parsed_per_function():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 127 registers, used 1 barriers, 18448 bytes smem
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size, 128 bytes smem
"""
    assert compile_cache.parse_ptxas(log) == {
        "_Z6kernelPf": {"stack_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 127, "barriers": 1, "smem_bytes": 18448},
        "_Z5otherv": {"stack_bytes": 8, "spill_stores": 4, "spill_loads": 4,
                      "registers": 64, "barriers": 1, "smem_bytes": 128}}


# ---------------------------------------------------------------------------
# the compile events and the wiring


def test_compile_events_reach_the_telemetry_plane(standin, tmp_path):
    cfg = CrossCoderConfig(d_in=16, dict_size=64, obs="on", obs_dir=str(tmp_path / "obs"),
                           compile_cache_dir=str(standin.root / "tier"))
    obs = Observability(cfg)
    try:
        compile_cache.configure(cfg, registry=obs.registry)
        _build.load("alpha")
        _fresh_process()
        _build.load("alpha")
        snap = obs.registry.snapshot()
        assert snap["perf/compiles"] == 1 and snap["perf/compile_s_n"] == 1
        assert snap["compile/disk_miss"] == 1 and snap["compile/disk_hit"] == 1
        assert "perf/compile_flops" not in snap and "perf/compile_bytes_accessed" not in snap
        spans = [(e["args"]["variant"], e["args"]["source"]) for e in obs.tracer.events()
                 if e["name"] == "compile"]
        assert spans == [("alpha", "disk"), ("alpha", "build"), ("alpha", "disk")]
    finally:
        obs.close()
    _fresh_process()
    compile_cache.configure(cache_dir="")
    _build.load("beta")                 # the plane is closed: nothing reported to it
    assert obs.registry.snapshot()["perf/compiles"] == 1


def test_the_engine_trainer_fleet_and_tuner_configure_the_tier(tmp_path, monkeypatch):
    from crosscoder_tpu_torch.serve.smoke import build_engine
    from crosscoder_tpu_torch.train.fleet import FleetScheduler
    from crosscoder_tpu_torch.train.trainer import Trainer
    from crosscoder_tpu_torch.tune import autotune

    seen = []
    real = compile_cache.configure
    monkeypatch.setattr(compile_cache, "configure",
                        lambda cfg=None, **kw: seen.append(cfg.compile_cache_dir) or real(cfg, **kw))
    d = str(tmp_path / "tier")
    eng = build_engine(device="cpu", compile_cache_dir=d)[0]
    assert compile_cache.disk_cache().root == Path(d) / f"v{compile_cache.DISK_FORMAT}"
    assert eng.registry is compile_cache.disk_cache().registry
    tiny = dict(d_in=16, dict_size=64, batch_size=16, num_tokens=64, log_backend="null",
                compile_cache_dir=d)
    Trainer(CrossCoderConfig(**tiny), device="cpu").close()
    FleetScheduler(CrossCoderConfig(**tiny, fleet="on"), device="cpu", checkpoint=False)
    autotune.tune(CrossCoderConfig(**tiny), "train", axes={"prefetch": (False, True)},
                  measure=lambda c, **kw: {"score": 1.0}, gate=lambda c, knobs=None: (True, []),
                  device="cpu")
    assert seen == [d] * 4
    Trainer(CrossCoderConfig(**{**tiny, "compile_cache_dir": ""}), device="cpu").close()
    assert not compile_cache.disk_enabled()        # an empty directory turns it off, as JAX


def test_configure_falls_back_to_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("CROSSCODER_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    disk = compile_cache.configure(CrossCoderConfig(d_in=16, dict_size=64))
    assert disk is not None and disk.root == tmp_path / "env" / f"v{compile_cache.DISK_FORMAT}"
    # idempotent a directory: the counters survive, the cap rebinds
    disk.stats["disk_hit"] = 5
    again = compile_cache.configure(cache_dir=str(tmp_path / "env"), max_bytes=123)
    assert again is disk and disk.max_bytes == 123 and compile_cache.disk_stats()["disk_hit"] == 5


# ---------------------------------------------------------------------------
# held against the JAX tier


@pytest.fixture
def jax_tier():
    """The JAX tier's module, its disk state put back afterwards."""
    from crosscoder_tpu.utils import compile_cache as jcc

    saved = (jcc._DISK, jcc._VERIFY)
    yield jcc
    jcc._DISK, jcc._VERIFY = saved


@pytest.mark.parametrize("enc", ["dense", "fused", "fused-int8"])
@pytest.mark.parametrize("tenant", ["", "c0", "bucket-3"])
def test_variant_key_is_jaxs(jax_tier, enc, tenant):
    for metrics in (False, True):
        for aux in (False, True):
            for refresh in (False, True):
                assert (compile_cache.variant_key(metrics, aux, refresh, enc=enc, tenant=tenant)
                        == jax_tier.variant_key(metrics, aux, refresh, enc=enc, tenant=tenant))
    assert compile_cache.variant_key(True, False, True) == jax_tier.variant_key(True, False, True)


def _schema(o):
    if isinstance(o, dict):
        return {k: _schema(v) for k, v in o.items()}
    return type(o).__name__


def test_manifest_schema_is_jaxs(standin, jax_tier):
    import jax
    import jax.numpy as jnp

    jdisk = jax_tier.DiskCache(standin.root / "jax")
    exe = jax.jit(lambda v: v * 2.0).lower(jnp.arange(4.0)).compile()
    assert jdisk.store("d" * 64, exe, variant="kernel", topology="one card")
    disk = compile_cache.configure(cache_dir=str(standin.root / "tier"))
    _build.load("alpha")
    jman, man = jdisk.manifest(), disk.manifest()
    assert man["version"] == jman["version"] == compile_cache.DISK_FORMAT
    [jrow], [row] = jman["entries"].values(), man["entries"].values()
    assert _schema(man) | {"entries": None} == _schema(jman) | {"entries": None}
    assert _schema(row) == _schema(jrow)
    assert row["variant"] == "alpha" and row["bytes"] == _entry(standin.root / "tier").stat().st_size
    assert jax_tier.DISK_FORMAT == compile_cache.DISK_FORMAT


@pytest.mark.parametrize("cap", [0, 250, 520, 1000, 10_000])
def test_eviction_keeps_jaxs_survivors(tmp_path, jax_tier, cap):
    """The same entry sizes and recencies in both tiers: the same entries
    survive the byte cap (JAX's executables are ``.exec``, the port's
    libraries ``.so``)."""
    sizes = [300, 120, 90, 260, 10, 200]
    mtimes = [1005.0, 1001.0, 1003.0, 1002.0, 1006.0, 1004.0]
    jdisk = jax_tier.DiskCache(tmp_path / "jax", max_bytes=cap)
    disk = compile_cache.DiskCache(tmp_path / "port", max_bytes=cap)
    for i, (n, t) in enumerate(zip(sizes, mtimes)):
        for root, ext in ((jdisk.root, "exec"), (disk.root, "so")):
            p = root / f"e{i}.{ext}"
            p.write_bytes(b"\x00" * n)
            os.utime(p, (t, t))
    jdisk._evict()
    disk._evict()
    survivors = sorted(p.stem for p in disk.root.glob("*.so"))
    assert survivors == sorted(p.stem for p in jdisk.root.glob("*.exec"))
    assert disk.stats["evictions"] == jdisk.stats["evictions"] == len(sizes) - len(survivors)


def test_warm_start_report_keys_are_jaxs(tmp_path, jax_tier):
    from crosscoder_tpu.serve import warm_start as jws
    from crosscoder_tpu_torch.serve import warm_start

    report = warm_start.run(str(tmp_path / "port"), serve_max_batch=2, device="cpu")
    jreport = jws.run(str(tmp_path / "jax"), serve_max_batch=2)
    assert list(report) == list(jreport)
    assert {k: type(v) for k, v in report.items()} == {k: type(v) for k, v in jreport.items()}
    # on the CPU nothing is built: no library compiled, none loaded
    assert report["compiles"] == 0 and report["zero_compiles"] is True
    assert report["disk_hits"] == report["disk_misses"] == report["disk_entries"] == 0


def test_warm_start_cli_prints_one_line(tmp_path, capsys):
    from crosscoder_tpu_torch.serve import warm_start

    assert warm_start.main(["--cache-dir", str(tmp_path / "cc"), "--device", "cpu",
                            "--expect-zero-compiles"]) == 0
    line = capsys.readouterr().out.strip().splitlines()
    assert len(line) == 1
    assert set(json.loads(line[0])["warm_start"]) == {
        "warmup_ms", "compiles", "disk_hits", "disk_misses", "disk_entries", "zero_compiles"}
    assert (tmp_path / "cc").is_dir()


def test_warm_start_runs_on_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is taken")
    from crosscoder_tpu_torch.serve import warm_start

    with pytest.raises(RuntimeError, match="no CUDA device"):
        warm_start.run(str(tmp_path / "cc"))
