"""Per-pass cost probe: one elementwise op repeated k times (plain version and kernel).

Counterpart of the Pallas probe in ``scripts/bench_vpu_passes.py``
(``main.build``) with its nine ops (``OPS``, the lambdas of
``bench_vpu_passes.py:54-65``).  :func:`repeat_op` runs :func:`repeat_op_plain`
for tensors on the CPU and the CUDA kernel (``csrc/elementwise_passes.cu``)
for tensors on a CUDA device; it raises for anything else.  The kernel walks
its input as a scalar head up to a 16-byte boundary, a body of float4s and a
scalar tail (:func:`split_for_vectors`) on a persistent grid
(:func:`kernel_grid`) whose blocks take the body's tiles in order from a
counter that the launch zeroes (one a device and stream).

The plain version makes one PyTorch call per pass where one computes the op
(``torch.tanh``, ``torch.exp``, ``torch.sigmoid`` for both sigmoid forms,
``F.silu``, ``torch.add``, ``torch.mul``); ``rsqrt`` takes three calls and the
bf16 round trip two.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

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


def split_for_vectors(ptr_mod_16: int, n: int) -> Tuple[int, int, int]:
    """``(head, body, tail)`` of ``n`` float32 elements whose first lies at an
    address of remainder ``ptr_mod_16`` modulo 16: the scalar head up to the
    first 16-byte boundary, a body of whole float4s, the scalar tail.  The
    kernel walks the three in this layout."""
    if ptr_mod_16 not in (0, 4, 8, 12):
        raise ValueError(f"a float32 address has a remainder 0, 4, 8 or 12 modulo 16, not {ptr_mod_16!r}")
    head = min(n, (16 - ptr_mod_16) % 16 // 4)
    body = (n - head) // 4 * 4
    return head, body, n - head - body


# (library, device index, op) -> (blocks an SM, SMs)
_grids: Dict[Tuple[str, int, str], Tuple[int, int]] = {}
# (device index, stream) -> the tile counter of the launches on that stream
# (each launch zeroes it first, in stream order)
_counters: Dict[Tuple[int, int], Tensor] = {}


def _grid(lib: ctypes.CDLL, device: torch.device, op: str) -> Tuple[int, int]:
    key = (lib._name, device.index, op)
    if key not in _grids:
        fn = lib.elementwise_passes_occupancy
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        per_sm, sms = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(OPS.index(op), ctypes.byref(per_sm), ctypes.byref(sms))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"pass-probe occupancy query failed with CUDA error {err} "
                               f"({per_sm.value} blocks an SM)")
        _grids[key] = (per_sm.value, sms.value)
    return _grids[key]


def kernel_grid(device: torch.device, op: str) -> Tuple[int, int]:
    """``(blocks an SM, SMs)`` of the kernel for ``op`` on ``device``, from
    the occupancy API, read once a library; the launch grid is their
    product."""
    from bio_diffusion_torch.ops.build import load_library

    return _grid(load_library("elementwise_passes"), device, op)


def _empty_aligned_as(x: Tensor) -> Tensor:
    """An empty tensor of ``x``'s shape whose address has ``x``'s remainder
    modulo 16, so that both split alike (a view into 3 spare elements)."""
    buf = torch.empty(x.numel() + 3, device=x.device, dtype=x.dtype)
    pad = (x.data_ptr() - buf.data_ptr()) % 16 // 4
    return buf[pad:pad + x.numel()].view(x.shape)


def _repeat_op_cuda(x: Tensor, op: str, k: int) -> Tensor:
    from bio_diffusion_torch.ops.build import load_library

    _check(x, op, k)
    if x.numel() == 0:
        raise ValueError("the pass probe needs a non-empty tensor")
    lib = load_library("elementwise_passes")
    fn = lib.elementwise_passes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    x = x.contiguous()
    # the per-call host work stays small: at the probe's default shape one
    # launch of a few passes takes ~66 us, and a slower host would starve it
    out = torch.empty_like(x) if x.data_ptr() % 16 == 0 else _empty_aligned_as(x)
    per_sm, sms = _grid(lib, x.device, op)
    head, body, _ = split_for_vectors(x.data_ptr() % 16, x.numel())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counter = _counters.get((x.device.index, stream))
    if counter is None:
        counter = _counters[(x.device.index, stream)] = torch.empty(1, dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(OPS.index(op), x.data_ptr(), out.data_ptr(), x.numel(), head, body, k, per_sm * sms,
                 counter.data_ptr(), stream)
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
