#!/usr/bin/env python3
"""Where the telemetry plane's cost a step comes from, on the card.

    python3 scripts/obs_overhead_probe.py [--steps 12] [--rounds 3]

Leg A of ``chip_smoke.py`` (d_in 2304, two models, dict 2^15, TopK k 32,
batch 4096, bf16 compute, f32 masters, sparse backward, AuxK 64 every 2
steps; prefetch on) over 4 synthetic batches made ahead onto the card, in
one process: ``--rounds`` rounds of three variants in turn from one
initial state (obs off; obs on; obs on with the spans' ``record_function``
left out), then one ``torch.profiler`` window over two steps, then
``--rounds`` rounds of obs off and on again (whether a profiler that has
run in the process changes either).
Each step is followed by a read of its loss (the log point's sync), and
its time is taken loss to loss on the host clock. Prints, per variant,
the median over steps 2 on of every round, bare and AuxK steps apart, and
whether each run's losses equal the first's. Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from crosscoder_tpu_torch.config import CrossCoderConfig  # noqa: E402
from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource  # noqa: E402
from crosscoder_tpu_torch.obs import trace  # noqa: E402
from crosscoder_tpu_torch.train.state import Optimizer, init_train_state  # noqa: E402
from crosscoder_tpu_torch.train.trainer import Trainer  # noqa: E402

LEG_A = dict(d_in=2304, n_models=2, hook_point="blocks.14.hook_resid_pre", dict_size=2 ** 15,
             topk_k=32, batch_size=4096, enc_dtype="bf16", master_dtype="fp32",
             activation="topk", l1_coeff=0.0, sparse_bwd="on", aux_k=64, aux_every=2,
             aux_dead_steps=4, aux_exact_rank=True, lr=1e-3, log_backend="null",
             fused_encoder="off", prefetch=True)


class Batches:
    """Batches already on the card, served in order from the start."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def next(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return b


@contextlib.contextmanager
def spans_without_record_function():
    """The real tracer's spans, their ``record_function`` left out."""
    enter, exit_ = trace._Span.__enter__, trace._Span.__exit__

    def _enter(self):
        self._t0 = time.perf_counter_ns()
        return self

    def _exit(self, *exc):
        self._tracer._record(self._name, self._t0, time.perf_counter_ns() - self._t0, self._args)
        return False

    trace._Span.__enter__, trace._Span.__exit__ = _enter, _exit
    try:
        yield
    finally:
        trace._Span.__enter__, trace._Span.__exit__ = enter, exit_


def run(cfg, batches, state0, steps):
    """``steps`` steps from a copy of ``state0``: (loss-to-loss ms, losses)."""
    state = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
    for tree, src in ((state.params, state0.params), (state.opt_state.mu, state0.opt_state.mu),
                      (state.opt_state.nu, state0.opt_state.nu), (state.aux, state0.aux)):
        for k in tree:
            tree[k].copy_(src[k])
    tr = Trainer(cfg, Batches(batches), device="cuda", state=state)
    torch.cuda.synchronize()
    ms, losses = [], []
    t = time.perf_counter()
    for _ in range(steps):
        losses.append(float(tr.step(full_metrics=False)["loss"]))
        now = time.perf_counter()
        ms.append((now - t) * 1e3)
        t = now
    tr.close()
    return ms, losses


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("obs_overhead_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    d = tempfile.mkdtemp(prefix="obs_probe_", dir=str(ROOT / "build"))
    base = CrossCoderConfig(**LEG_A, checkpoint_dir=d)
    src = SyntheticActivationSource(base)
    batches = [torch.from_numpy(src.next()).cuda() for _ in range(4)]
    state0 = init_train_state(base, Optimizer(base, lambda s: 0.0), device="cuda")
    before = {"off": (base, contextlib.nullcontext),
              "on": (base.replace(obs="on"), contextlib.nullcontext),
              "on, no record_function": (base.replace(obs="on"), spans_without_record_function)}
    after = {"off after a profiler window": before["off"],
             "on after a profiler window": before["on"]}
    results = {name: {"bare": [], "aux": []} for name in (*before, *after)}
    ref = None
    for phase, variants in (("before", before), ("after", after)):
        if phase == "after":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                run(base, batches, state0, 2)
        for rnd in range(args.rounds):
            for name, (cfg, ctx) in variants.items():
                with ctx():
                    ms, losses = run(cfg, batches, state0, args.steps)
                ref = losses if ref is None else ref
                for i, t in enumerate(ms[1:], 1):
                    results[name]["aux" if i % 2 == 0 else "bare"].append(t)
                print(f"round {rnd} {name}: loss to loss ms {[round(x, 3) for x in ms]}; losses "
                      f"{'equal to' if losses == ref else 'DIFFERENT from'} the first run's",
                      flush=True)
    for name, r in results.items():
        print(f"{name}: bare median {np.median(r['bare']):.3f} ms ({len(r['bare'])} steps), "
              f"AuxK median {np.median(r['aux']):.3f} ms ({len(r['aux'])} steps) ({card})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
