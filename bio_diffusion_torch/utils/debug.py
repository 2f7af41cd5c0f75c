"""Debug-mode runtime invariant checks (off by default).

Port of ``bio_diffusion_tpu/utils/debug.py``: ``check_correctly_masked``,
``check_mean_zero_with_mask`` and ``check_finite`` with the JAX package's
tolerances and message texts.  Each check takes an ``enabled`` flag; when
it is false the check returns at once (no tensor op, no sync).

When enabled, a check does not read its result back: it records a device
flag, its message and the tensors the message names into the innermost
``collecting()`` block, and ``Recorder.throw()`` reads all of them in one
transfer after the step and raises ``InvariantError`` with the first failed
check's message (JAX's ``checkify`` pattern: error values carried through
the step, thrown on the host afterwards; ``train/step.py`` wraps its train
and eval steps so).  An enabled check outside any block raises at once
(``checked_call`` runs a function in a block of its own).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor

MASK_TOL = 1e-4
# relative tolerance on the masked mean (the reference's
# assert_mean_zero_with_mask bound is largest_value * 1e-2 / N)
MEAN_ZERO_REL_TOL = 1e-2


class InvariantError(RuntimeError):
    """A debug invariant failed (counterpart of checkify's JaxRuntimeError)."""


class Recorder:
    """The checks recorded in one ``collecting()`` block."""

    def __init__(self):
        self.checks: List[Tuple[Tensor, str, Dict[str, Tensor]]] = []

    def throw(self, reduce_max: Optional[Callable[[Tensor], object]] = None) -> None:
        """Read every recorded flag and value in one transfer; raise the
        first failed check's message.  ``reduce_max`` replaces the flat
        buffer of failure flags and values by its maximum over the ranks of
        a data-parallel group first (every value a check names is a
        magnitude), so that every rank raises the same failure."""
        if not self.checks:
            return
        parts = []
        for ok, _, values in self.checks:
            parts.append(1.0 - ok.reshape(1).float())
            parts.extend(v.reshape(1).float() for v in values.values())
        flat = torch.cat(parts)
        if reduce_max is not None:
            reduce_max(flat)
        flat = flat.tolist()
        pos = 0
        for ok, message, values in self.checks:
            failed, read = flat[pos], flat[pos + 1: pos + 1 + len(values)]
            pos += 1 + len(values)
            if failed:
                raise InvariantError(message.format(**dict(zip(values, read))))


_state = threading.local()


@contextlib.contextmanager
def collecting():
    """Record the enabled checks run inside the block (see ``Recorder``)."""
    stack = _state.__dict__.setdefault("stack", [])
    rec = Recorder()
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()


def _record(ok: Tensor, message: str, **values: Tensor) -> None:
    stack = getattr(_state, "stack", None)
    values = {k: v.detach() for k, v in values.items()}
    if stack:
        stack[-1].checks.append((ok.detach(), message, values))
        return
    rec = Recorder()
    rec.checks.append((ok.detach(), message, values))
    rec.throw()


def check_correctly_masked(enabled: bool, value: Tensor, node_mask: Tensor, name: str = "tensor") -> None:
    """Padded rows of ``value`` must be zero (within ``MASK_TOL``).

    ``node_mask`` is [..., N]; ``value`` is [..., N, C] or [..., N].
    """
    if not enabled:
        return
    mask = node_mask
    if value.dim() == mask.dim() + 1:
        mask = mask[..., None]
    bad = torch.max(torch.abs(value * (1.0 - mask.to(value.dtype))))
    _record(bad < MASK_TOL, f"{name} is not correctly masked (max |pad| = {{b}})", b=bad)


def check_mean_zero_with_mask(enabled: bool, x: Tensor, node_mask: Tensor, name: str = "positions") -> None:
    """Masked mean of ``x`` over the node axis must be ~0 (CoM-free subspace):
    |mean| < max|x| * 1e-2 / N, the reference's relative bound."""
    if not enabled:
        return
    m = node_mask.to(x.dtype)[..., None]
    n = torch.clamp(m.sum(dim=-2, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=-2, keepdim=True) / n
    largest = torch.clamp(x.abs().max(), min=1e-8)
    bound = largest * MEAN_ZERO_REL_TOL / n.max()
    err = mean.abs().max()
    _record(err < bound, f"{name} violates zero-CoM invariant (max |masked mean| = {{e}}, bound {{b}})",
            e=err, b=bound)


def check_finite(enabled: bool, value: Tensor, name: str = "tensor") -> None:
    if not enabled:
        return
    _record(torch.isfinite(value).all(), f"{name} contains non-finite values")


def checked_call(fn, *args, reduce_max: Optional[Callable[[Tensor], object]] = None, **kwargs):
    """Run ``fn`` with its enabled checks recorded, then raise the first one
    that failed (one read-back after the call; ``reduce_max`` as in
    ``Recorder.throw``)."""
    with collecting() as rec:
        out = fn(*args, **kwargs)
    rec.throw(reduce_max)
    return out

