"""The port's config refuses the compile tier's knobs as the JAX config
does: ``compile_cache_verify`` outside off|strict, a byte cap <= 0, and a
``compile_cache_dir`` that cannot be created (created at construction).
Each ``ValueError`` is held to JAX's on the same arguments, message and all."""

import pytest

from crosscoder_tpu.config import CrossCoderConfig as JCfg
from crosscoder_tpu_torch.config import CrossCoderConfig

BASE = dict(d_in=16, dict_size=64, batch_size=32, enc_dtype="fp32", log_backend="null")


def _error(cls, kw):
    with pytest.raises(ValueError) as e:
        cls(**BASE, **kw)
    return str(e.value)


@pytest.mark.parametrize("kw", [
    {"compile_cache_verify": "strictest"},
    {"compile_cache_verify": "on"},
    {"compile_cache_verify": ""},
    {"compile_cache_max_bytes": 0},
    {"compile_cache_max_bytes": -1},
    {"compile_cache_dir": "<tmp>/cc", "compile_cache_max_bytes": 0},
    {"compile_cache_dir": "<file>/cc"},
], ids=["verify-strictest", "verify-on", "verify-empty", "max-bytes-0", "max-bytes-negative",
        "max-bytes-0-with-dir", "dir-under-a-file"])
def test_config_refuses_what_jax_refuses(tmp_path, kw):
    (tmp_path / "file").write_text("a file, not a directory")
    kw = {k: v.replace("<tmp>", str(tmp_path)).replace("<file>", str(tmp_path / "file"))
          if isinstance(v, str) else v for k, v in kw.items()}
    want = _error(JCfg, kw)
    assert _error(CrossCoderConfig, kw) == want
    assert next(iter(k for k in kw if k in want))


def test_config_creates_the_tier_directory(tmp_path):
    for cls, sub in ((JCfg, "jax"), (CrossCoderConfig, "port")):
        cfg = cls(**BASE, compile_cache_dir=str(tmp_path / sub / "deep" / "cc"),
                  compile_cache_verify="strict", compile_cache_max_bytes=1 << 20)
        assert (tmp_path / sub / "deep" / "cc").is_dir()
        assert cfg.compile_cache_verify == "strict"
    assert CrossCoderConfig(**BASE).compile_cache_verify == "off"
    assert not CrossCoderConfig(**BASE).compile_cache_dir
