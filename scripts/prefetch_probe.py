"""The trainer's one-deep prefetch on the card, in a fresh process: leg A's
config (synthetic source) and leg H's BatchTopK config (host bf16 store of
two random-init Gemma-2-2B) of ``chip_smoke.py``, each way in turn for a
number of rounds, every run from the same state over the same stream.

Per run and way it prints the median over steps 2 on of the loss-to-loss
time and of its parts on the host clock: the serve (on whichever thread
served), the copy call, the main thread's wait for the batch, the
``step()`` call and the loss read. ``pin`` is the prefetch with the rows
pinned on the worker before the copy. Run on a machine with one card,
from the root of a checkout (``ROOT`` may be another checkout, so two
trees compare in one call):

    python scripts/prefetch_probe.py [--root ROOT] [--steps 10] [--rounds 2] \\
        [--ways off,on,pin] [--in-smoke]

The last line is one JSON object: each leg and way's medians of loss to
loss, one a round. First it prints what a serve costs on the main thread
and on a worker thread of this process (host wall, user and system ms of
leg A's synthetic serve and of filling a new 75 MB array, three times
each). ``--in-smoke`` prints that instead before and after leg PF of a
whole ``chip_smoke.py`` run in this process (a long-lived process, where
the two threads' allocations can differ), and exits with its code.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path


def thread_costs(tag: str) -> None:
    """Host ms (wall, user, system) of leg A's synthetic serve and of
    filling a new [4096, 2, 2304] f32 array, three times on this thread
    and three times on a new worker thread."""
    import numpy as np

    import chip_smoke as c
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

    src = SyntheticActivationSource(CrossCoderConfig(**c.TRAIN))

    def fill():
        np.empty((4096, 2, 2304), np.float32).fill(1.0)

    def timed(fn):
        r0, t = resource.getrusage(resource.RUSAGE_THREAD), time.perf_counter()
        fn()
        wall, r1 = (time.perf_counter() - t) * 1e3, resource.getrusage(resource.RUSAGE_THREAD)
        return (round(wall, 1), round((r1.ru_utime - r0.ru_utime) * 1e3, 1),
                round((r1.ru_stime - r0.ru_stime) * 1e3, 1))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        for name, fn in (("synthetic serve", src.next), ("new 75 MB array", fill)):
            main_t = [timed(fn) for _ in range(3)]
            worker_t = [pool.submit(timed, fn).result() for _ in range(3)]
            print(f"[{tag}] {name} (wall, user, system ms): main thread {main_t}, worker "
                  f"{worker_t}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ways", default="off,on,pin")
    ap.add_argument("--in-smoke", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    if args.in_smoke:
        import chip_smoke as c

        leg = c.prefetch_leg

        def measured_leg(*a, **kw):
            thread_costs("before leg PF")
            out = leg(*a, **kw)
            thread_costs("after leg PF")
            return out

        c.prefetch_leg = measured_leg
        return c.main()

    import numpy as np
    import torch

    import chip_smoke as c
    from crosscoder_tpu_torch.config import CrossCoderConfig
    from crosscoder_tpu_torch.data import buffer as bufmod
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource
    from crosscoder_tpu_torch.models import lm
    from crosscoder_tpu_torch.ops import _build
    from crosscoder_tpu_torch.train import trainer as T
    from crosscoder_tpu_torch.train.state import Optimizer, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}; tree {args.root}", flush=True)
    _build.build_all()
    thread_costs("fresh process")

    def run(cfg, src, state0, way):
        rec = {k: [] for k in ("serve", "copy", "wait", "step_call", "loss_wait", "l2l")}
        real = T.to_device

        def to_device(b, device):
            t = time.perf_counter()
            worker = torch.cuda.current_stream(device) != torch.cuda.default_stream(device)
            if way == "pin" and worker:
                if not torch.is_tensor(b):
                    b = torch.from_numpy(np.ascontiguousarray(b))
                b = b.pin_memory()
            out = real(b, device)
            rec["copy"].append((time.perf_counter() - t) * 1e3)
            return out

        def timed(fn, key):
            def wrapped(*a, **kw):
                t = time.perf_counter()
                r = fn(*a, **kw)
                rec[key].append((time.perf_counter() - t) * 1e3)
                return r
            return wrapped

        T.to_device = to_device
        try:
            tr = T.Trainer(cfg, src, device="cuda", state=state0)
            tr._serve_once = timed(tr._serve_once, "serve")
            tr._next_batch = timed(tr._next_batch, "wait")
            torch.cuda.synchronize()
            losses, t = [], time.perf_counter()
            for _ in range(args.steps):
                a = time.perf_counter()
                m = tr.step(full_metrics=False)
                b = time.perf_counter()
                losses.append(float(m["loss"]))
                now = time.perf_counter()
                rec["step_call"].append((b - a) * 1e3)
                rec["loss_wait"].append((now - b) * 1e3)
                rec["l2l"].append((now - t) * 1e3)
                t = now
            tr.close()
        finally:
            T.to_device = real
        return losses, rec

    def med(x):
        return round(statistics.median(x[1:]), 2)

    lm_cfg = lm.LMConfig.gemma2_2b()
    params = [lm.init_params(lm_cfg, seed=s, device="cuda") for s in (1, 2)]
    tokens = c.harvest_tokens(np, 256, c.HARVEST["seq_len"], lm_cfg.vocab_size, 6)
    out: dict[str, list[float]] = {}
    for leg, kw in (("A", dict(c.TRAIN, fused_encoder="off")), ("H", c.PF_H)):
        state0 = ref = None
        for rnd in range(args.rounds):
            for way in args.ways.split(","):
                cfg = CrossCoderConfig(**{**kw, "prefetch": way != "off",
                                          "num_tokens": kw["batch_size"] * 100})
                if state0 is None:
                    state0 = init_train_state(cfg, Optimizer(cfg, lambda s: 0.0), device="cuda")
                src = (SyntheticActivationSource(cfg) if leg == "A" else
                       bufmod.make_buffer(cfg, lm_cfg, params, tokens, device="cuda"))
                losses, rec = run(cfg, src, state0, way)
                ref = losses if ref is None else ref
                print(f"{leg} round {rnd} {way}: losses the first run's {losses == ref}; "
                      f"medians {({k: med(v) for k, v in rec.items()})}; loss to loss "
                      f"{[round(x, 1) for x in rec['l2l']]}", flush=True)
                out.setdefault(f"{leg} {way}", []).append(med(rec["l2l"]))
                torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
