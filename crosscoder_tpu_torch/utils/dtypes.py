"""Dtype-name mapping, mirroring the reference's DTYPES table
(reference ``crosscoder.py:12``, ``train.py:5``) in torch terms."""

from __future__ import annotations

import torch

DTYPES = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


def dtype_of(name: str) -> torch.dtype:
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype name {name!r}; expected one of {list(DTYPES)}") from None
