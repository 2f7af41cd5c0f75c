"""One GCPNet message-passing layer on packed inputs: packing, plain version, kernel.

Counterpart of ``bio_diffusion_tpu/ops/pallas/gcp_kernel.py``
(``pack_gcp1_weights``, ``pack_chain_weights``, ``fused_message_layer``) and
of its plain math ``models/gcpnet_fast.py::message_layer_reference``.

Layouts (shared with the JAX package):

* ``s_node [B, N, S]``; ``v_node [B, N, 3V]`` coords-major (column k*V+c is
  coordinate k of channel c).
* ``epack [B, N*N, Se + 3Ve + 10]``: per edge (i, j) at row i*N+j, the
  embedded edge scalars | edge vectors coords-major | frames transposed and
  flattened k*3+a | edge mask.  Unlike the TPU layout it is not padded to 128
  columns.
* The packed weights are ``[in, out]`` matrices; the rep3 expansion of the
  frame projection is folded into them, so a stage's scalarized features are
  column c*3+a = sum_k vdf9_k[c*3+a] * frames_t[3k+a].

:func:`fused_message_layer` runs the plain version for tensors on the CPU and
the CUDA kernel (``csrc/message_layer.cu``) for tensors on a CUDA device; it
raises for anything else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# launches of each hand-written kernel, counted where the launch happens
launch_counts: Dict[str, int] = {"message_layer": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _rep3(dtype) -> Tensor:
    """[3, 9] repeat selector: rep3[c, c*3+a] = 1."""
    col = torch.arange(9)[None, :]
    row = torch.arange(3)[:, None]
    return (col // 3 == row).to(dtype)


def _bd3(m: Tensor) -> Tensor:
    """[a, b] -> [3a, 3b] block diagonal."""
    return torch.block_diag(m, m, m)


def _t(w: Tensor, dtype) -> Tensor:
    """A torch ``[out, in]`` weight as a contiguous ``[in, out]`` matrix."""
    return w.detach().t().to(dtype).contiguous()


def pack_gcp1_weights(gcp, s_dim: int, v_dim: int, ve_dim: int,
                      dtype=torch.float32) -> Dict[str, Tensor]:
    """Split and block-diagonalize the first message GCP's weights.

    ``gcp`` is the ``message_fusion.0`` GCP2 module (the same weights serve
    the virtual concat [node_i | edge | node_j]).  Returns contiguous
    ``[in, out]`` matrices keyed as in the JAX package."""
    wd = _t(gcp.vector_down.weight, dtype)  # [2V+Ve, H]
    wdf = _t(gcp.vector_down_frames.weight, dtype)  # [2V+Ve, 3]
    ws = _t(gcp.scalar_out.weight, dtype)  # [2S+Se+H+9, S]
    h = wd.shape[1]
    se_dim = ws.shape[0] - 2 * s_dim - h - 9
    rep = _rep3(dtype).to(wd.device)
    parts_d = (wd[:v_dim], wd[v_dim:v_dim + ve_dim], wd[v_dim + ve_dim:])
    parts_f = (wdf[:v_dim] @ rep, wdf[v_dim:v_dim + ve_dim] @ rep, wdf[v_dim + ve_dim:] @ rep)
    wvi, wve, wvj = (torch.cat([_bd3(d), _bd3(f)], dim=1) for d, f in zip(parts_d, parts_f))
    return {
        "wvi": wvi,  # [3V, 3H+27]
        "wvj": wvj,
        "wve": wve,  # [3Ve, 3H+27]
        "wsi": ws[:s_dim].contiguous(),
        "wsj": ws[s_dim + se_dim: 2 * s_dim + se_dim].contiguous(),
        # [e | vnorm | schid] rows of the scalar weight, for one product
        "wsx": torch.cat([
            ws[s_dim: s_dim + se_dim],
            ws[2 * s_dim + se_dim: 2 * s_dim + se_dim + h],
            ws[2 * s_dim + se_dim + h:],
        ], dim=0),
        "bs": gcp.scalar_out.bias.detach().to(dtype),
        "wu_bd": _bd3(_t(gcp.vector_up.weight, dtype)),  # [3H, 3V]
        "wg": _t(gcp.vector_out_scale.weight, dtype),  # [S, V]
        "bg": gcp.vector_out_scale.bias.detach().to(dtype),
    }


def pack_chain_weights(gcps, attention: torch.nn.Linear, dtype=torch.float32) -> Tuple[Tensor, ...]:
    """Stack the residual chain GCPs (``message_fusion.1..``) and the
    attention head into ``(w_comb, ws, bs, wu_bd, wg, bg, wattn, battn)``:
    ``w_comb [G, 3V, 3H+27]`` = [bd3(vector_down) | bd3(vector_down_frames @
    rep3)], ``wu_bd [G, 3H, 3V]`` = bd3(vector_up)."""
    def t(w):
        return _t(w, dtype)

    rep = None
    w_comb, ws, bs, wu_bd, wg, bg = [], [], [], [], [], []
    for gcp in gcps:
        wd = t(gcp.vector_down.weight)
        if rep is None:
            rep = _rep3(dtype).to(wd.device)
        w_comb.append(torch.cat([_bd3(wd), _bd3(t(gcp.vector_down_frames.weight) @ rep)], dim=1))
        ws.append(t(gcp.scalar_out.weight))
        bs.append(gcp.scalar_out.bias.detach().to(dtype))
        wu_bd.append(_bd3(t(gcp.vector_up.weight)))
        wg.append(t(gcp.vector_out_scale.weight))
        bg.append(gcp.vector_out_scale.bias.detach().to(dtype))
    return (
        torch.stack(w_comb), torch.stack(ws), torch.stack(bs), torch.stack(wu_bd),
        torch.stack(wg), torch.stack(bg), t(attention.weight), attention.bias.detach().to(dtype),
    )


def _safe_norm_last(x2_sum: Tensor, eps: float = 1e-8) -> Tensor:
    return torch.sqrt(x2_sum + eps) + eps


def message_layer_plain(s_node: Tensor, v_node: Tensor, epack: Tensor,
                        g1: Dict[str, Tensor], chain: tuple, *, ve_dim: int
                        ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the layer (port of ``message_layer_reference``).

    Returns ``(s_agg [B, N, S], v_agg [B, N, 3V])``."""
    b, n, _ = s_node.shape
    dt = s_node.dtype
    h1 = g1["wu_bd"].shape[0] // 3
    se = g1["wsx"].shape[0] - h1 - 9
    h3 = 3 * h1
    ve3 = 3 * ve_dim

    ep = epack.reshape(b, n, n, epack.shape[-1])
    e_feat = ep[..., :se]
    xi = ep[..., se: se + ve3]
    ft = ep[..., se + ve3: se + ve3 + 9]
    emask = ep[..., se + ve3 + 9: se + ve3 + 10]
    # lane-tiled frame factors: ftiles[k][..., c*3+a] = frames_t[..., 3k+a]
    ftiles = [torch.cat([ft[..., 3 * k: 3 * (k + 1)]] * 3, dim=-1) for k in range(3)]

    def scalarize(vdfrep):  # [..., 27] -> [..., 9]
        return sum(vdfrep[..., 9 * k: 9 * (k + 1)] * ftiles[k] for k in range(3))

    # ---- first GCP over the virtual concat (node_i | edge | node_j) ----
    vhd = (v_node @ g1["wvi"])[:, :, None] + (v_node @ g1["wvj"])[:, None, :] + xi @ g1["wve"]
    vnorm = _safe_norm_last(sum(vhd[..., k * h1:(k + 1) * h1] ** 2 for k in range(3)))
    schid = scalarize(vhd[..., h3:])
    cat1 = torch.cat([e_feat, vnorm.to(dt), schid.to(dt)], dim=-1)
    s2 = (
        (s_node @ g1["wsi"])[:, :, None]
        + (s_node @ g1["wsj"])[:, None, :]
        + cat1 @ g1["wsx"]
        + g1["bs"]
    )
    s = F.silu(s2)
    gate = torch.sigmoid(s @ g1["wg"] + g1["bg"])
    v = (vhd[..., :h3] @ g1["wu_bd"]) * torch.cat([gate] * 3, dim=-1)

    # ---- residual chain of GCP2 stages ----
    w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn = chain
    hc = (w_comb.shape[2] - 27) // 3
    for g in range(w_comb.shape[0]):
        vhd_g = v @ w_comb[g]
        vnorm_g = _safe_norm_last(sum(vhd_g[..., k * hc:(k + 1) * hc] ** 2 for k in range(3)))
        merged = torch.cat([s, vnorm_g.to(dt), scalarize(vhd_g[..., 3 * hc:]).to(dt)], dim=-1)
        silu_g = F.silu(merged @ wsc[g] + bsc[g])
        gate_g = torch.sigmoid(silu_g @ wgc[g] + bgc[g])
        s = s + silu_g
        v = v + (vhd_g[..., :3 * hc] @ wu_bd[g]) * torch.cat([gate_g] * 3, dim=-1)

    attn = torch.sigmoid(s @ wattn + battn)
    s = s * attn * emask.to(dt)
    v = v * emask.to(dt)
    return s.sum(dim=2), v.sum(dim=2)


_C_FUNCTIONS = {torch.float32: "message_layer_f32", torch.bfloat16: "message_layer_bf16"}


def _kernel_function(dtype):
    from bio_diffusion_torch.ops.build import load_library

    lib = load_library("message_layer")
    fn = getattr(lib, _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _message_layer_cuda(s_node, v_node, epack, g1, chain, ve_dim):
    b, n, s_dim = s_node.shape
    dt = s_node.dtype
    if dt not in _C_FUNCTIONS:
        raise TypeError(f"the message-layer kernel takes float32 or bfloat16, not {dt}")
    v3 = v_node.shape[-1]
    v_dim = v3 // 3
    h1 = g1["wu_bd"].shape[0] // 3
    se = g1["wsx"].shape[0] - h1 - 9
    w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn = chain
    num_gcps = w_comb.shape[0]
    hc = (w_comb.shape[2] - 27) // 3
    p = epack.shape[-1]
    expected = {
        "v_node": (v_node, (b, n, v3)),
        "epack": (epack, (b, n * n, se + 3 * ve_dim + 10)),
        "wsi": (g1["wsi"], (s_dim, s_dim)), "wsj": (g1["wsj"], (s_dim, s_dim)),
        "wvi": (g1["wvi"], (v3, 3 * h1 + 27)), "wvj": (g1["wvj"], (v3, 3 * h1 + 27)),
        "wve": (g1["wve"], (3 * ve_dim, 3 * h1 + 27)),
        "wsx": (g1["wsx"], (se + h1 + 9, s_dim)), "bs": (g1["bs"], (s_dim,)),
        "wu_bd": (g1["wu_bd"], (3 * h1, v3)),
        "wg": (g1["wg"], (s_dim, v_dim)), "bg": (g1["bg"], (v_dim,)),
        "w_comb": (w_comb, (num_gcps, v3, 3 * hc + 27)),
        "wsc": (wsc, (num_gcps, s_dim + hc + 9, s_dim)), "bsc": (bsc, (num_gcps, s_dim)),
        "wubd": (wu_bd, (num_gcps, 3 * hc, v3)),
        "wgc": (wgc, (num_gcps, s_dim, v_dim)), "bgc": (bgc, (num_gcps, v_dim)),
        "wattn": (wattn, (s_dim, 1)), "battn": (battn, (1,)),
    }
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != s_node.device or t.dtype != dt:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dt} on {s_node.device}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid range")

    # node-side projections, O(B N S^2): outside the kernel as in the TPU wrapper
    proj_i = torch.cat([s_node @ g1["wsi"], v_node @ g1["wvi"]], dim=-1).contiguous()
    proj_j = torch.cat([s_node @ g1["wsj"], v_node @ g1["wvj"]], dim=-1).contiguous()
    tensors = [proj_i, proj_j, epack.contiguous(), g1["wve"], g1["wsx"], g1["bs"], g1["wu_bd"],
               g1["wg"], g1["bg"], w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel weights must be contiguous")
    s_agg = torch.empty((b, n, s_dim), dtype=dt, device=s_node.device)
    v_agg = torch.empty((b, n, v3), dtype=dt, device=s_node.device)
    fn = _kernel_function(dt)
    stream = torch.cuda.current_stream(s_node.device).cuda_stream
    with torch.cuda.device(s_node.device):
        err = fn(*[t.data_ptr() for t in tensors], s_agg.data_ptr(), v_agg.data_ptr(),
                 b, n, p, s_dim, v_dim, se, ve_dim, h1, hc, num_gcps, stream)
    if err != 0:
        raise RuntimeError(f"message-layer kernel launch failed with CUDA error {err}")
    launch_counts["message_layer"] += 1
    return s_agg, v_agg


def fused_message_layer(s_node: Tensor, v_node: Tensor, epack: Tensor,
                        g1: Dict[str, Tensor], chain: tuple, *, ve_dim: int
                        ) -> Tuple[Tensor, Tensor]:
    """One message-passing layer -> ``(s_agg [B, N, S], v_agg [B, N, 3V])``.

    CUDA tensors go through the hand-written kernel, CPU tensors through
    :func:`message_layer_plain`; any other device raises."""
    if s_node.device.type == "cuda":
        return _message_layer_cuda(s_node, v_node, epack, g1, chain, ve_dim)
    if s_node.device.type == "cpu":
        return message_layer_plain(s_node, v_node, epack, g1, chain, ve_dim=ve_dim)
    raise RuntimeError(f"no message-layer implementation for device {s_node.device}")
