"""Training entry point, ported from :mod:`crosscoder_tpu.train.main`
(the reference's ``train.py:main``):

    python -m crosscoder_tpu_torch.train.main --data-source synthetic \\
        --num-tokens 8192 --batch-size 512 --dict-size 4096 --d-in 256 ...

Config from the command line (every field a flag,
:meth:`CrossCoderConfig.from_cli`), the synthetic activation source, the
single-device :class:`Trainer` and its :class:`MetricsLogger`. The Gemma
harvest (``--data-source gemma``) comes with the data-plane slice, and
``--resume`` with checkpoints; both raise :class:`NotImplementedError`.
"""

from __future__ import annotations

from crosscoder_tpu_torch.config import CrossCoderConfig
from crosscoder_tpu_torch.train.trainer import Trainer
from crosscoder_tpu_torch.utils.logging import MetricsLogger


def main(argv: list[str] | None = None, device=None) -> Trainer:
    """Train from ``argv`` (default: the process's arguments). Runs on
    ``cuda`` unless ``device`` names another device."""
    cfg = CrossCoderConfig.from_cli(argv)
    if cfg.data_source != "synthetic":
        raise NotImplementedError(
            "--data-source gemma needs the Gemma harvest and the activation "
            "buffer, which come with the data-plane slice (ROADMAP Queue A 6-7); "
            "use --data-source synthetic")
    from crosscoder_tpu_torch.data.synthetic import SyntheticActivationSource

    trainer = Trainer(cfg, SyntheticActivationSource(cfg), logger=MetricsLogger(cfg),
                      device=device)
    try:
        trainer.train()
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
