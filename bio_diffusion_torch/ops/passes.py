"""Per-pass cost probe: one elementwise op repeated k times (plain version and kernel).

Counterpart of the Pallas probe in ``scripts/bench_vpu_passes.py``
(``main.build``) with its nine ops (``OPS``, the lambdas of
``bench_vpu_passes.py:54-65``).  :func:`repeat_op` runs :func:`repeat_op_plain`
for tensors on the CPU and the CUDA kernel (``csrc/elementwise_passes.cu``)
for tensors on a CUDA device; it raises for anything else.

The plain version makes one PyTorch call per pass where one computes the op
(``torch.tanh``, ``torch.exp``, ``torch.sigmoid`` for both sigmoid forms,
``F.silu``, ``torch.add``, ``torch.mul``); ``rsqrt`` takes three calls and the
bf16 round trip two.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from bio_diffusion_torch.ops.message_layer import launch_counts

Tensor = torch.Tensor

# the op names, in the order of the kernel's op ids
OPS = ("tanh", "exp", "sigmoid_exp", "sigmoid_tanh", "silu_tanh", "add", "mul", "rsqrt", "cast_roundtrip")

PLAIN: Dict[str, Callable[[Tensor], Tensor]] = {
    "tanh": torch.tanh,
    "exp": torch.exp,
    "sigmoid_exp": torch.sigmoid,
    "sigmoid_tanh": torch.sigmoid,  # 0.5 * (tanh(0.5 y) + 1) is sigmoid(y)
    "silu_tanh": F.silu,
    "add": lambda y: torch.add(y, 1.0),
    "mul": lambda y: torch.mul(y, 1.0001),
    "rsqrt": lambda y: torch.rsqrt(torch.abs(y) + 1e-8),
    "cast_roundtrip": lambda y: y.to(torch.bfloat16).to(torch.float32),
}


def _check(x: Tensor, op: str, k: int) -> None:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; the probe has {OPS}")
    if x.dtype != torch.float32:
        raise TypeError(f"the pass probe takes float32, not {x.dtype}")
    if not isinstance(k, int) or k < 0:
        raise ValueError(f"k must be a non-negative int, not {k!r}")


def repeat_op_plain(x: Tensor, op: str, k: int) -> Tensor:
    """``op`` applied ``k`` times to every element of ``x``, in plain PyTorch."""
    _check(x, op, k)
    fn = PLAIN[op]
    y = x.clone()
    for _ in range(k):
        y = fn(y)
    return y


def _repeat_op_cuda(x: Tensor, op: str, k: int) -> Tensor:
    from bio_diffusion_torch.ops.build import load_library

    _check(x, op, k)
    if x.numel() == 0:
        raise ValueError("the pass probe needs a non-empty tensor")
    fn = load_library("elementwise_passes").elementwise_passes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    x = x.contiguous()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(OPS.index(op), x.data_ptr(), out.data_ptr(), x.numel(), k, stream)
    if err != 0:
        raise RuntimeError(f"pass-probe kernel launch failed with CUDA error {err}")
    launch_counts["elementwise_passes"] += 1
    return out


def repeat_op(x: Tensor, op: str, k: int) -> Tensor:
    """``op`` applied ``k`` times to every element of float32 ``x``: the CUDA
    kernel for CUDA tensors (one launch), :func:`repeat_op_plain` for CPU
    tensors; any other device raises."""
    if x.device.type == "cuda":
        return _repeat_op_cuda(x, op, k)
    if x.device.type == "cpu":
        return repeat_op_plain(x, op, k)
    raise RuntimeError(f"no pass-probe implementation for device {x.device}")
