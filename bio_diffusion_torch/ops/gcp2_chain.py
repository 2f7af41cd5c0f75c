"""The residual GCP2 chain and scalar attention over flat edge rows: plain version and kernel.

Counterpart of ``bio_diffusion_tpu/ops/pallas/gcp_kernel.py::fused_gcp2_chain``,
with its signature and layouts: ``s [E, S]``, ``v [E, 3V]`` coords-major
(column k*V+c is coordinate k of channel c), ``frames_t [E, 9]`` transposed
and flattened k*3+a, and the chain's weights stacked and unpacked as
``gcpnet_fast.py::_stack_chain_weights`` gives them.  The TPU-only ``block``
and ``interpret`` arguments are not taken.

:func:`fused_gcp2_chain` runs :func:`gcp2_chain_plain` for tensors on the CPU
and the CUDA kernel (``csrc/gcp2_chain.cu``) for tensors on a CUDA device; it
raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from bio_diffusion_torch.ops.message_layer import chain_blocks, chain_plain, frame_tiles, launch_counts

Tensor = torch.Tensor

_C_FUNCTIONS = {torch.float32: "gcp2_chain_f32", torch.bfloat16: "gcp2_chain_bf16"}


def _check_inputs(s, v, frames_t, wd, wdf, ws, bs, wu, wg, bg, wattn, battn) -> Tuple[int, ...]:
    """Shapes, dtype and device of a chain call -> ``(E, S, V, H, G)``; raises
    ValueError or TypeError on anything the kernel does not take."""
    if s.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the GCP2 chain takes float32 or bfloat16, not {s.dtype}")
    if s.dim() != 2 or wd.dim() != 3:
        raise ValueError(f"s must be [E, S] and wd [G, V, H], not {tuple(s.shape)} and {tuple(wd.shape)}")
    e, s_dim = s.shape
    g, v_dim, h = wd.shape
    if e < 1 or g < 1:
        raise ValueError(f"the GCP2 chain needs at least one row and one stage (E={e}, G={g})")
    expected = {
        "v": (v, (e, 3 * v_dim)), "frames_t": (frames_t, (e, 9)),
        "wdf": (wdf, (g, v_dim, 3)), "ws": (ws, (g, s_dim + h + 9, s_dim)), "bs": (bs, (g, s_dim)),
        "wu": (wu, (g, h, v_dim)), "wg": (wg, (g, s_dim, v_dim)), "bg": (bg, (g, v_dim)),
        "wattn": (wattn, (s_dim, 1)), "battn": (battn, (1,)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != s.device or t.dtype != s.dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {s.dtype} on {s.device}")
    return e, s_dim, v_dim, h, g


def gcp2_chain_plain(s: Tensor, v: Tensor, frames_t: Tensor, wd: Tensor, wdf: Tensor, ws: Tensor,
                     bs: Tensor, wu: Tensor, wg: Tensor, bg: Tensor, wattn: Tensor, battn: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of :func:`fused_gcp2_chain` -> ``(s [E, S], v [E, 3V])``."""
    w_comb, wu_bd = chain_blocks(wd, wdf, wu)
    s, v = chain_plain(s, v, frame_tiles(frames_t), w_comb, ws, bs, wu_bd, wg, bg)
    return s * torch.sigmoid(s @ wattn + battn), v


def _kernel_function(dtype):
    from bio_diffusion_torch.ops.build import load_library

    fn = getattr(load_library("gcp2_chain"), _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _gcp2_chain_cuda(s, v, frames_t, wd, wdf, ws, bs, wu, wg, bg, wattn, battn):
    e, s_dim, v_dim, h, g = _check_inputs(s, v, frames_t, wd, wdf, ws, bs, wu, wg, bg, wattn, battn)
    w_comb, wu_bd = chain_blocks(wd, wdf, wu)
    ins = [t.contiguous() for t in (s, v, frames_t, w_comb, ws, bs, wu_bd, wg, bg, wattn, battn)]
    s_out = torch.empty_like(ins[0])
    v_out = torch.empty_like(ins[1])
    ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    fn = _kernel_function(s.dtype)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    with torch.cuda.device(s.device):
        err = fn(ctypes.addressof(ptrs), s_out.data_ptr(), v_out.data_ptr(), e, s_dim, v_dim, h, g, stream)
    if err != 0:
        raise RuntimeError(f"GCP2 chain kernel launch failed with CUDA error {err}")
    launch_counts["gcp2_chain"] += 1
    return s_out, v_out


def fused_gcp2_chain(s: Tensor, v: Tensor, frames_t: Tensor, wd: Tensor, wdf: Tensor, ws: Tensor,
                     bs: Tensor, wu: Tensor, wg: Tensor, bg: Tensor, wattn: Tensor, battn: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """G residual GCP2 stages, then sigmoid scalar attention on s, over flat
    edge rows -> ``(s [E, S], v [E, 3V])`` in the input dtype.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    :func:`gcp2_chain_plain`; any other device raises."""
    args = (s, v, frames_t, wd, wdf, ws, bs, wu, wg, bg, wattn, battn)
    if s.device.type == "cuda":
        return _gcp2_chain_cuda(*args)
    if s.device.type == "cpu":
        _check_inputs(*args)
        return gcp2_chain_plain(*args)
    raise RuntimeError(f"no GCP2-chain implementation for device {s.device}")
