"""Numerical sanitizers: the port of ``lfm_quant_tpu/utils/debug.py``.

The JAX package's ``sanitized()`` turns on ``jax_debug_nans`` /
``jax_debug_infs``: a NaN or Inf made inside a jitted step raises at the
op that made it. The torch twin has two halves, both on while
:func:`sanitized` is:

* ``torch.autograd.detect_anomaly``: a backward op that returns NaN
  raises, with the forward op that recorded it in the traceback;
* a finiteness check at the step boundary (:func:`check_step`, which the
  trainers call after every optimizer update): the step's loss, its
  gradients and the updated params, each NaN and Inf leaf named.

Both raise (``FloatingPointError`` from the check); neither cleans a
value. Slow (anomaly mode records a traceback per op, the check waits for
the device): debug and CI only, never a measured path
(``python -m lfm_quant_tpu_torch.train --debug``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch

#: (nans, infs) while :func:`sanitized` is on, else None.
_MODE = None


@contextlib.contextmanager
def sanitized(nans: bool = True, infs: bool = True):
    """Raise on any NaN (``nans``) or Inf (``infs``) a train step makes
    inside the block: anomaly detection for the backward and the step
    boundary's check (:func:`check_step`)."""
    global _MODE
    prev = _MODE
    _MODE = (nans, infs)
    try:
        with torch.autograd.detect_anomaly(check_nan=nans):
            yield
    finally:
        _MODE = prev


def active() -> bool:
    """Whether :func:`sanitized` is on."""
    return _MODE is not None


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif tree is not None:
        yield path, tree


def _bad(leaf: Any, nans: bool, infs: bool) -> bool:
    a = (leaf.detach().float().cpu().numpy() if torch.is_tensor(leaf)
         else np.asarray(leaf, dtype=np.float64))
    return bool((nans and np.isnan(a).any()) or (infs and np.isinf(a).any()))


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Host-side finiteness check over nested dicts / lists of tensors or
    arrays: raises ``FloatingPointError`` naming every leaf holding a NaN
    or an Inf."""
    _raise_bad(tree, name, True, True)


def _raise_bad(tree: Any, name: str, nans: bool, infs: bool) -> None:
    bad: List[str] = [p for p, leaf in _leaves(tree)
                      if _bad(leaf, nans, infs)]
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")


def check_step(tree: Any, name: str = "train step") -> None:
    """The step boundary's check under :func:`sanitized` (a no-op
    otherwise): the step's ``{"loss", "grads", "params"}``."""
    if _MODE is not None:
        _raise_bad(tree, name, *_MODE)
