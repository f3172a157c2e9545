"""The optimizer update as one pass: global-norm clip + Adam + learning rate.

The JAX package runs optax's ``clip_by_global_norm → scale_by_adam →
scale_by_learning_rate`` (``crosscoder_tpu/train/state.py``
``make_optimizer``) inside its jitted step, where XLA fuses the chain into
one pass a leaf. Eager PyTorch runs it as some 36 elementwise passes over
each leaf. Two implementations of one function behind :func:`adam_update`:

- :func:`adam_update_plain`: the port's Optimizer op sequence, with the
  clip chosen by ``torch.where`` on the device (no host sync). The
  wrapper takes it for CPU tensors only;
- ``csrc/adam_update.cu``, O1: one launch over every leaf, each element
  read and written once, every step rounded as the plain version's eager
  ops round (f32 or bf16 leaves, each leaf in its own dtype: bf16 masters
  beside a JumpReLU crosscoder's f32 ``log_theta``), so the two are
  bitwise equal on the card given the same norm.

The global norm is not computed here: the caller passes it as a 0-d f32
tensor on the leaves' device (:meth:`crosscoder_tpu_torch.train.state.Optimizer.global_norm`,
a sum of squares in sorted-name order), so both implementations clip by
the same value.

A fleet cohort (:mod:`crosscoder_tpu_torch.train.fleet`) of N tenants
updates in the same one launch: every leaf is its tenants' leaves stacked
on a leading axis of N, and ``norm`` is an ``[N]`` f32 vector, tenant
``t``'s global norm clipping the elements of slice ``t`` of every leaf.
The bias corrections and the learning rate are the cohort's. A 0-d (or
one-element) norm is the solo update.
"""

from __future__ import annotations

import ctypes

import torch

Params = dict[str, torch.Tensor]

_MAX_LEAVES = 8     # csrc kMaxLeaves
_PROTOTYPES = {
    "adam_update_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_float] * 9 + [ctypes.c_void_p]),
}


def adam_update_plain(params: Params, grads: Params, mu: Params, nu: Params,
                      norm: torch.Tensor, *, max_norm: float, b1: float, b2: float, eps: float,
                      bc1: float, bc2: float, step_size: float,
                      out: tuple[Params, Params, Params] | None = None) -> None:
    """The plain version of :func:`adam_update`: writes ``p' = p +
    step_size · m̂ / (sqrt(v̂) + eps)``, ``m'`` and ``v'`` into ``out =
    (params', mu', nu')`` (None: in place into ``params``, ``mu``,
    ``nu``). ``bc1``, ``bc2``: the bias corrections ``1 - b**t`` in f32;
    ``step_size``: ``-lr``. ``norm``: 0-d, or ``[N]`` for a cohort of N
    tenants stacked on every leaf's leading axis (slice ``t`` clipped by
    ``norm[t]``)."""
    n = tenants(params, norm)
    for k in sorted(params):
        g = grads[k]
        nk = norm if n == 1 else norm.reshape(n, *[1] * (g.dim() - 1))
        g = torch.where(nk < max_norm, g, (g / nk.to(g.dtype)) * max_norm)
        m = (1 - b1) * g + b1 * mu[k]
        v = (1 - b2) * torch.square(g) + b2 * nu[k]
        m_hat = m / torch.tensor(bc1, dtype=m.dtype, device=g.device)
        v_hat = v / torch.tensor(bc2, dtype=v.dtype, device=g.device)
        upd = m_hat / (torch.sqrt(v_hat) + eps)
        upd = torch.tensor(step_size, dtype=upd.dtype, device=g.device) * upd
        p = (params[k] + upd).to(params[k].dtype)
        po, mo, vo = (params, mu, nu) if out is None else out
        po[k].copy_(p)
        mo[k].copy_(m)
        vo[k].copy_(v)


def tenants(params: Params, norm: torch.Tensor) -> int:
    """The tenants ``norm`` clips for: 1 for a 0-d or one-element norm,
    else ``N`` of an ``[N]`` norm, every leaf's leading axis N
    (:class:`ValueError` otherwise)."""
    if norm.dim() == 0 or norm.numel() == 1:
        return 1
    if norm.dim() != 1:
        raise ValueError(f"norm must be 0-d or [N], got {tuple(norm.shape)}")
    n = norm.shape[0]
    for k, v in params.items():
        if v.dim() == 0 or v.shape[0] != n:
            raise ValueError(f"leaf {k}: a cohort of {n} tenants needs the tenant axis "
                             f"{n} leading every leaf, got {tuple(v.shape)}")
    return n


def adam_update(params: Params, grads: Params, mu: Params, nu: Params, norm: torch.Tensor, *,
                max_norm: float, b1: float, b2: float, eps: float, bc1: float, bc2: float,
                step_size: float, out: tuple[Params, Params, Params] | None = None) -> None:
    """Clip by ``norm``, Adam, ``step_size`` for every leaf: the plain
    version on CPU tensors, O1 (``csrc/adam_update.cu``, one launch for
    all leaves, each in its own dtype) on CUDA tensors, or
    :class:`ValueError` for leaves the kernel does not take (a leaf's dtype
    other than f32/bf16, a gradient, moment or output whose dtype is not
    its param's, non-contiguous params or moments, more than 8 leaves; a
    strided gradient is copied). ``out`` and ``norm`` (0-d, or ``[N]`` for
    a cohort) as :func:`adam_update_plain`'s. Counts its launches on
    ``adam_update.launches``, those of a cohort also on
    ``adam_update.cohort_launches``."""
    kw = dict(max_norm=max_norm, b1=b1, b2=b2, eps=eps, bc1=bc1, bc2=bc2, step_size=step_size)
    names = sorted(params)
    first = params[names[0]]
    n_tenants = tenants(params, norm)
    if first.device.type == "cpu":
        adam_update_plain(params, grads, mu, nu, norm, out=out, **kw)
        return
    if first.device.type != "cuda":
        raise ValueError(f"adam_update runs on cpu or cuda, got {first.device}")
    from crosscoder_tpu_torch.ops import _build

    po, mo, vo = (params, mu, nu) if out is None else out
    if len(names) > _MAX_LEAVES:
        raise ValueError(f"adam_update kernel takes at most {_MAX_LEAVES} leaves, got "
                         f"{len(names)}")
    if norm.device != first.device or norm.dtype != torch.float32 or not norm.is_contiguous():
        raise ValueError(f"norm must be f32 values on {first.device}, got "
                         f"{tuple(norm.shape)} {norm.dtype} on {norm.device}")
    ptrs, sizes, tags, keep = [], [], [], []
    for k in names:
        dtype = params[k].dtype
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"leaf {k}: the adam_update kernel takes f32 or bf16 leaves, "
                             f"got {dtype}")
        # a gradient is only read: a strided one (autograd may return an
        # expanded or transposed view) is copied into a contiguous one
        g = grads[k].contiguous()
        keep.append(g)
        ts = (g, params[k], mu[k], nu[k], po[k], mo[k], vo[k])
        for t in ts:
            if t.dtype != dtype or t.device != first.device or t.shape != params[k].shape:
                raise ValueError(f"leaf {k}: every tensor must be {dtype} "
                                 f"{tuple(params[k].shape)} on {first.device}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {k}: the adam_update kernel writes params and moments "
                                 f"in place and takes contiguous ones")
        ptrs += [t.data_ptr() for t in ts]
        sizes.append(params[k].numel())
        tags.append(int(dtype == torch.bfloat16))
    lib = _build.load("adam_update", _PROTOTYPES)
    code = lib.adam_update_launch(
        (ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_longlong * len(sizes))(*sizes),
        (ctypes.c_int * len(tags))(*tags), len(names), norm.data_ptr(), n_tenants,
        float(max_norm),
        float(1 - b1), float(b1), float(1 - b2), float(b2), float(eps), float(bc1), float(bc2),
        float(step_size), _build.stream(first.device))
    _build.check(code, "adam_update kernel")
    adam_update.launches += 1
    if n_tenants > 1:
        adam_update.cohort_launches += 1


adam_update.launches = 0
adam_update.cohort_launches = 0
