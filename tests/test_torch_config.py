"""The port's CrossCoderConfig (crosscoder_tpu_torch/config.py) keeps every
field name and default of the JAX package's, round-trips through
to_dict/from_dict with it in both directions, and ports the validation of
the fields the serve slice reads."""

import dataclasses

import pytest
import torch

from crosscoder_tpu import config as jconfig
from crosscoder_tpu_torch import config
from crosscoder_tpu_torch.utils.dtypes import DTYPES, dtype_of


def _defaults(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
            for f in dataclasses.fields(cls)]


def test_fields_and_defaults_equal_jax():
    assert _defaults(config.CrossCoderConfig) == _defaults(jconfig.CrossCoderConfig)


def test_to_dict_round_trips_both_ways():
    kw = dict(hook_points=("blocks.1.hook_resid_pre", "blocks.3.hook_resid_pre"),
              activation="topk", topk_k=8, serve="on", serve_max_batch=4, page_size=8,
              seq_len=16, dict_size=64)
    mine = config.CrossCoderConfig(**kw)
    theirs = jconfig.CrossCoderConfig(**kw)
    assert mine.to_dict() == theirs.to_dict()
    assert config.CrossCoderConfig.from_dict(theirs.to_dict()) == mine
    assert jconfig.CrossCoderConfig.from_dict(mine.to_dict()) == theirs
    extra = config.CrossCoderConfig.from_dict({**mine.to_dict(), "future_knob": 3})
    assert extra.extras == {"future_knob": 3} and extra.to_dict()["future_knob"] == 3
    assert mine.n_sources == theirs.n_sources == 4
    assert mine.resolved_hook_points() == theirs.resolved_hook_points()
    assert config.parse_hook_point("blocks.14.hook_resid_pre") == (14, "resid_pre")


# the last entries are checks the port adds for fields the serve path reads
@pytest.mark.parametrize("kw,match", [
    (dict(enc_dtype="fp8"), "enc_dtype"),
    (dict(activation="gelu"), "activation"),
    (dict(page_size=12), "page_size"),
    (dict(harvest_runtime="paged", seq_len=20, page_size=8), "divide"),
    (dict(harvest_runtime="paged", seq_len=4, page_size=8), "smaller than page_size"),
    (dict(serve="on", serve_max_batch=6), "serve_max_batch"),
    (dict(serve="on", serve_queue=4, serve_max_batch=8), "serve_queue"),
    (dict(serve="on", serve_max_wait_ms=-1.0), "serve_max_wait_ms"),
    (dict(serve="on", serve_shed_ms=-1.0), "serve_shed_ms"),
    (dict(serve="maybe"), "serve"),
    (dict(topk_k=0), "topk_k"),
    (dict(seq_len=0), "seq_len"),
])
def test_validation_of_serve_fields(kw, match):
    with pytest.raises(ValueError, match=match):
        config.CrossCoderConfig(**kw)
    if "topk_k" not in kw and set(kw) != {"seq_len"}:
        with pytest.raises(ValueError):
            jconfig.CrossCoderConfig(**kw)
    with pytest.raises(ValueError, match="unsupported hook point"):
        config.parse_hook_point("layers.3")


def test_dtype_names():
    assert dtype_of("bf16") is torch.bfloat16 and dtype_of("fp32") is torch.float32
    assert set(DTYPES) == {"fp32", "fp16", "bf16"}
    with pytest.raises(ValueError, match="unknown dtype"):
        dtype_of("int4")
