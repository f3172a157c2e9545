"""Checkpointing: versioned layout, full train-state resume, the
reference's ``.pt`` layout."""

from crosscoder_tpu_torch.checkpoint.ckpt import Checkpointer  # noqa: F401
