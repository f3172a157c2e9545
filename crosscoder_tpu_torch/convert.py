"""Carry weights from the JAX package's params into the port's.

Both packages use the same leaf names and layouts (LM layer leaves stacked
``[n_layers, ...]``, matmul weights ``[in, out]``; crosscoder ``W_enc [n,
d_in, H]``, ``W_dec [H, n, d_in]``), so conversion is a leaf-by-leaf copy
of host numpy arrays (``jax.device_get`` of a params pytree) into tensors
on a device. bfloat16 numpy arrays (the ``ml_dtypes`` type) go through
float32, which holds every bfloat16 value exactly.
:func:`train_state_from_numpy` carries a whole JAX ``TrainState`` (params,
Adam moments and count, step, AuxK state) over, so both trainers can start
from the same point.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from crosscoder_tpu_torch.utils.device import resolve_device

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _tensor(a, device: torch.device, dtype: torch.dtype | None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif a.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(np.array(a, copy=True))    # own, writable memory
    else:
        raise ValueError(f"unsupported leaf dtype {a.dtype}")
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _tree(tree: Mapping[str, Any], device: torch.device, dtype) -> dict[str, Any]:
    """Leaf by leaf; a JumpReLU ``log_theta`` stays f32 whatever ``dtype``
    (the JAX package keeps it f32 beside weights of any dtype)."""
    return {k: _tree(v, device, dtype) if isinstance(v, Mapping)
            else _tensor(v, device, None if k == "log_theta" else dtype)
            for k, v in tree.items()}


def lm_params_from_numpy(tree: Mapping[str, Any], device=None,
                         dtype: torch.dtype | None = None) -> dict[str, Any]:
    """The port's LM params from the JAX package's LM params pytree (nested
    dict of numpy leaves). ``dtype`` None keeps each leaf's dtype. Runs on
    ``cuda`` unless ``device`` names another device."""
    return _tree(tree, resolve_device(device), dtype)


def crosscoder_params_from_numpy(params: Mapping[str, Any], device=None,
                                 dtype: torch.dtype | None = None) -> dict[str, torch.Tensor]:
    """The port's crosscoder params from the JAX package's crosscoder
    params dict of numpy leaves; ``log_theta`` (JumpReLU) keeps its f32."""
    return _tree(params, resolve_device(device), dtype)


def train_state_from_numpy(state: Any, device=None):
    """The port's :class:`~crosscoder_tpu_torch.train.state.TrainState` from
    a JAX ``TrainState`` with numpy leaves (``jax.device_get(state)``):
    params, the Adam moments ``mu``/``nu`` and their count (found in the
    optax chain state), the step and ``aux`` (``steps_since_fired``,
    ``dead_mask``). Leaves keep their dtypes."""
    from crosscoder_tpu_torch.train.state import AdamState, TrainState

    dev = resolve_device(device)
    adam = next((s for s in state.opt_state if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if adam is None:
        raise ValueError("no Adam state (mu, nu) in the JAX TrainState's opt_state")
    params = _tree(state.params, dev, None)
    aux = None if state.aux is None else _tree(state.aux, dev, None)
    return TrainState(params=params,
                      opt_state=AdamState(int(np.asarray(adam.count)), _tree(adam.mu, dev, None),
                                          _tree(adam.nu, dev, None)),
                      step=int(np.asarray(state.step)), aux=aux)
