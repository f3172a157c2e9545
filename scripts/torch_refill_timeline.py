#!/usr/bin/env python3
"""Where the refill's harvest lands in the train steps, with the refill
overlap off and on, on one card.

    python3 scripts/torch_refill_timeline.py [--steps N] [--out FILE]

from the root of a checkout, on a machine with an H100 and ``nvcc``. Two
random-init Gemma-2-2B models (bf16) feed the replay buffer of
``chip_smoke.py``'s leg H (BatchTopK, a 2^15-latent crosscoder, batch
4096, ``buffer_mult`` 8: a refill every 3 serves, 4 chunks of 4 x 1024
tokens a refill, paced as ``SegmentedHarvest`` quanta) over its seeded
corpus. Three variants, each a fresh buffer and Trainer: overlap off (the
quanta dispatched on the serving thread); overlap on (the quanta
dispatched by the refill dispatcher's thread); overlap on with the
interpreter's switch interval cut from 5 ms to 0.1 ms for the run (a
thread waiting for the global interpreter lock gets it 50 times sooner).
Each variant runs N steps synced one by one (host clock from one step's
loss read back to the next one's, as ``chip_smoke.py`` times legs S and
P), then N steps back to back with one sync at the end (the training loop's regime: its host clock at each step's
return, and the total). With overlap on, each dispatcher pump's start and
end and the credit it spent are logged against the clock of the steps'
starts. Prints a
line per variant and writes every number to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(torch, cfg, lm_cfg, params, tokens, steps, switch):
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.train.trainer import Trainer

    buffer = bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda")
    tr = Trainer(cfg, buffer, device="cuda")
    pumps = []
    t_zero = time.perf_counter()
    if buffer._dispatcher is not None:
        real = buffer._overlap_pump

        def logged(credit):
            t0 = time.perf_counter() - t_zero
            real(credit)
            pumps.append((round(t0 * 1e3, 3), round((time.perf_counter() - t_zero) * 1e3, 3),
                          credit))

        buffer._overlap_pump = logged
    old = sys.getswitchinterval()
    if switch:
        sys.setswitchinterval(switch)
    starts = []
    try:
        synced = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            starts.append(round((t0 - t_zero) * 1e3, 3))
            float(tr.step(full_metrics=False)["loss"])
            now = time.perf_counter()
            synced.append((now - t0) * 1e3)
            t0 = now
        torch.cuda.synchronize()
        buffer._quiesce_dispatch()
        t_loop = time.perf_counter()
        returns = []
        for _ in range(steps):
            starts.append(round((time.perf_counter() - t_zero) * 1e3, 3))
            tr.step(full_metrics=False)
            returns.append((time.perf_counter() - t_loop) * 1e3)
        buffer._quiesce_dispatch()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t_loop) * 1e3
    finally:
        sys.setswitchinterval(old)
        tr.close()
    return {"synced_step_ms": synced, "loop_return_ms": returns, "loop_total_ms": total,
            "pumps_ms": pumps, "step_starts_ms": starts}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=9)
    ap.add_argument("--out", default=str(ROOT / "build" / "refill_timeline.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the refill on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.models import lm

    card = torch.cuda.get_device_name(0)
    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = cs.harvest_tokens(np, 256, cs.HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    base = CrossCoderConfig(**cs.HARVEST, activation="batchtopk", buffer_device="hbm",
                            num_tokens=cs.HARVEST["batch_size"] * 2 * args.steps)
    variants = {"overlap off": (base, 0.0), "overlap on": (base.replace(refill_overlap="on"), 0.0),
                "overlap on, switch interval 0.1 ms": (base.replace(refill_overlap="on"), 1e-4)}
    out = {"card": card, "steps": args.steps}
    for name, (cfg, switch) in variants.items():
        r = out[name] = run(torch, cfg, lm_cfg, params, tokens, args.steps, switch)
        s = r["synced_step_ms"]
        print(f"[refill_timeline] {name}: synced steps {[round(t, 1) for t in s]} ms "
              f"(median {np.median(s):.1f}, max {max(s):.1f}); back to back: returns "
              f"{[round(t, 1) for t in r['loop_return_ms']]} ms, {args.steps} steps in "
              f"{r['loop_total_ms']:.1f} ms; pumps (start, end, credit) {r['pumps_ms'][:12]}",
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"[refill_timeline] {card}; written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
