"""One GCPNet message-passing layer on packed inputs: packing, plain version, kernel.

Counterpart of ``bio_diffusion_tpu/ops/pallas/gcp_kernel.py``
(``pack_gcp1_weights``, ``fused_message_layer``, ``fused_message_layer_bwd``)
and of ``models/gcpnet_fast.py`` (``pack_gcp1_weights_jnp``,
``pack_chain_weights_jnp``, the plain math ``message_layer_reference``).

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
raises for anything else.  :func:`fused_message_layer_bwd` does the same
with the backward kernel (``csrc/message_layer_bwd.cu``), which it runs over
a large batch in chunks of whole molecules to bound the kernel's per-row
scratch (``BWD_SCRATCH_BUDGET``).  Two of the backward kernel's reductions
also run alone on a scratch of its layout (:func:`bwd_row_layout`), for
comparison with their plain twins: :func:`bwd_proj_sums` and
:func:`bwd_weight_grads`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# launches of each hand-written kernel of the port (this module's two,
# ops/gcp2_chain.py's and ops/passes.py's), counted where the launch happens
launch_counts: Dict[str, int] = {
    "message_layer": 0, "message_layer_bwd": 0, "gcp2_chain": 0, "elementwise_passes": 0,
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def chain_stage_macs(s_dim: int, v_dim: int, hc: int) -> int:
    """Multiply-adds of one residual GCP2 stage per edge row (block-diagonal
    zeros included): v @ w_comb, merged @ ws, silu @ wg, vh @ wu_bd."""
    return 3 * v_dim * (3 * hc + 27) + (s_dim + hc + 9) * s_dim + s_dim * v_dim + 3 * hc * 3 * v_dim


def layer_macs_per_row(s_dim: int, v_dim: int, se: int, ve: int, h1: int, hc: int, num_gcps: int) -> int:
    """Multiply-adds of the message layer's forward per edge row: the first
    GCP's edge-side products, ``num_gcps`` chain stages and the attention
    (the node-side projections are O(B N) and outside)."""
    gcp1 = 3 * ve * (3 * h1 + 27) + (se + h1 + 9) * s_dim + s_dim * v_dim + 3 * h1 * 3 * v_dim
    return gcp1 + num_gcps * chain_stage_macs(s_dim, v_dim, hc) + s_dim


def _rep3(dtype) -> Tensor:
    """[3, 9] repeat selector: rep3[c, c*3+a] = 1."""
    col = torch.arange(9)[None, :]
    row = torch.arange(3)[:, None]
    return (col // 3 == row).to(dtype)


def _bd3(m: Tensor) -> Tensor:
    """[a, b] -> [3a, 3b] block diagonal."""
    return torch.block_diag(m, m, m)


def _t(w: Tensor) -> Tensor:
    """A torch ``[out, in]`` weight as an ``[in, out]`` matrix (differentiable)."""
    return w.t()


def pack_gcp1(w: Dict[str, Tensor], s_dim: int, v_dim: int, ve_dim: int) -> Dict[str, Tensor]:
    """Split and block-diagonalize the first message GCP's weights, keeping
    the autograd graph (counterpart of ``gcpnet_fast.py::pack_gcp1_weights_jnp``).

    ``w`` maps the GCP2's state_dict names to tensors already in the compute
    dtype (e.g. its live parameters, cast).  Returns ``[in, out]`` matrices
    keyed as in the JAX package."""
    wd = _t(w["vector_down.weight"])  # [2V+Ve, H]
    wdf = _t(w["vector_down_frames.weight"])  # [2V+Ve, 3]
    ws = _t(w["scalar_out.weight"])  # [2S+Se+H+9, S]
    h = wd.shape[1]
    se_dim = ws.shape[0] - 2 * s_dim - h - 9
    rep = _rep3(wd.dtype).to(wd.device)
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
        "bs": w["scalar_out.bias"],
        "wu_bd": _bd3(_t(w["vector_up.weight"])),  # [3H, 3V]
        "wg": _t(w["vector_out_scale.weight"]).contiguous(),  # [S, V]
        "bg": w["vector_out_scale.bias"],
    }


def stack_chain(gcps: Sequence[Dict[str, Tensor]], attention: Dict[str, Tensor]) -> Tuple[Tensor, ...]:
    """The residual chain GCPs' weights (state_dict names -> tensors) and the
    attention head's (``weight``, ``bias``) as ``[in, out]`` matrices stacked
    over the chain: ``(wd [G, V, H], wdf [G, V, 3], ws [G, S+H+9, S], bs [G, S],
    wu [G, H, V], wg [G, S, V], bg [G, V], wattn [S, 1], battn [1])``, the
    layout of ``gcpnet_fast.py::_stack_chain_weights`` (differentiable)."""
    def stack(name, transpose=True):
        return torch.stack([_t(w[name]) if transpose else w[name] for w in gcps])

    return (stack("vector_down.weight"), stack("vector_down_frames.weight"),
            stack("scalar_out.weight"), stack("scalar_out.bias", False), stack("vector_up.weight"),
            stack("vector_out_scale.weight"), stack("vector_out_scale.bias", False),
            _t(attention["weight"]), attention["bias"])


def chain_blocks(wd: Tensor, wdf: Tensor, wu: Tensor) -> Tuple[Tensor, Tensor]:
    """Stacked ``wd [G, V, H]``, ``wdf [G, V, 3]``, ``wu [G, H, V]`` ->
    ``(w_comb [G, 3V, 3H+27], wu_bd [G, 3H, 3V])``: w_comb = [bd3(wd) |
    bd3(wdf @ rep3)], wu_bd = bd3(wu) (counterpart of
    ``gcp_kernel.py::pack_chain_weights``, differentiable)."""
    rep = _rep3(wd.dtype).to(wd.device)
    w_comb = torch.stack([torch.cat([_bd3(d), _bd3(f @ rep)], dim=1) for d, f in zip(wd, wdf)])
    return w_comb, torch.stack([_bd3(u) for u in wu])


def pack_chain(gcps: Sequence[Dict[str, Tensor]], attention: Dict[str, Tensor]) -> Tuple[Tensor, ...]:
    """Stack the residual chain GCPs' weights (state_dict names -> tensors in
    the compute dtype) and the attention head's (``weight``, ``bias``) into
    ``(w_comb, ws, bs, wu_bd, wg, bg, wattn, battn)``, keeping the autograd
    graph (counterpart of ``gcpnet_fast.py::pack_chain_weights_jnp``)."""
    wd, wdf, ws, bs, wu, wg, bg, wattn, battn = stack_chain(gcps, attention)
    w_comb, wu_bd = chain_blocks(wd, wdf, wu)
    return (w_comb, ws, bs, wu_bd, wg, bg, wattn.contiguous(), battn)


def cast_parameters(module: torch.nn.Module, dtype) -> Dict[str, Tensor]:
    """A module's parameters by state_dict name, cast to ``dtype`` (live: the
    cast is part of the autograd graph)."""
    return {k: p.to(dtype) for k, p in module.named_parameters()}


def pack_message_stack(mp: torch.nn.Module, s_dim: int, v_dim: int, ve_dim: int,
                       dtype=torch.float32) -> Tuple[Dict[str, Tensor], Tuple[Tensor, ...]]:
    """A message stack's (``GCPMessagePassing``) live parameters cast to
    ``dtype`` -> ``(g1, chain)`` for the layer, keeping the autograd graph."""
    g1 = pack_gcp1(cast_parameters(mp.message_fusion[0], dtype), s_dim, v_dim, ve_dim)
    chain = pack_chain([cast_parameters(g, dtype) for g in mp.message_fusion[1:]],
                       cast_parameters(mp.scalar_message_attention[0], dtype))
    return g1, chain


def detached(tree):
    """A nest of dicts, lists and tuples of tensors, detached and contiguous."""
    if isinstance(tree, dict):
        return {k: detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(detached(v) for v in tree)
    return tree.detach().contiguous()


def _safe_norm_last(x2_sum: Tensor, eps: float = 1e-8) -> Tensor:
    return torch.sqrt(x2_sum + eps) + eps


def frame_tiles(ft: Tensor):
    """Lane-tiled frame factors of transposed frames ``[..., 9]``:
    ``tiles[k][..., c*3+a] = frames_t[..., 3k+a]``."""
    return [torch.cat([ft[..., 3 * k: 3 * (k + 1)]] * 3, dim=-1) for k in range(3)]


def _scalarize(vdfrep: Tensor, ftiles) -> Tensor:  # [..., 27] -> [..., 9]
    return sum(vdfrep[..., 9 * k: 9 * (k + 1)] * ftiles[k] for k in range(3))


def chain_plain(s: Tensor, v: Tensor, ftiles, w_comb: Tensor, wsc: Tensor, bsc: Tensor,
                wu_bd: Tensor, wgc: Tensor, bgc: Tensor) -> Tuple[Tensor, Tensor]:
    """The residual GCP2 stages in plain PyTorch over rows of ``s [..., S]``,
    ``v [..., 3V]`` (the chain of ``message_layer_reference``)."""
    dt = s.dtype
    hc = (w_comb.shape[2] - 27) // 3
    for g in range(w_comb.shape[0]):
        vhd_g = v @ w_comb[g]
        vnorm_g = _safe_norm_last(sum(vhd_g[..., k * hc:(k + 1) * hc] ** 2 for k in range(3)))
        merged = torch.cat([s, vnorm_g.to(dt), _scalarize(vhd_g[..., 3 * hc:], ftiles).to(dt)], dim=-1)
        silu_g = F.silu(merged @ wsc[g] + bsc[g])
        gate_g = torch.sigmoid(silu_g @ wgc[g] + bgc[g])
        s = s + silu_g
        v = v + (vhd_g[..., :3 * hc] @ wu_bd[g]) * torch.cat([gate_g] * 3, dim=-1)
    return s, v


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
    ftiles = frame_tiles(ep[..., se + ve3: se + ve3 + 9])
    emask = ep[..., se + ve3 + 9: se + ve3 + 10]

    # ---- first GCP over the virtual concat (node_i | edge | node_j) ----
    vhd = (v_node @ g1["wvi"])[:, :, None] + (v_node @ g1["wvj"])[:, None, :] + xi @ g1["wve"]
    vnorm = _safe_norm_last(sum(vhd[..., k * h1:(k + 1) * h1] ** 2 for k in range(3)))
    schid = _scalarize(vhd[..., h3:], ftiles)
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
    wattn, battn = chain[6], chain[7]
    s, v = chain_plain(s, v, ftiles, *chain[:6])

    attn = torch.sigmoid(s @ wattn + battn)
    s = s * attn * emask.to(dt)
    v = v * emask.to(dt)
    return s.sum(dim=2), v.sum(dim=2)


G1_KEYS = ("wvi", "wvj", "wve", "wsi", "wsj", "wsx", "bs", "wu_bd", "wg", "bg")
CHAIN_KEYS = ("w_comb", "wsc", "bsc", "wu_bd", "wgc", "bgc", "wattn", "battn")


def bwd_outputs(out) -> list:
    """The backward's five outputs as one list of ``(name, tensor)``: the node
    and edge cotangents, then the 18 weight grads."""
    d_s, d_v, d_ep, d_g1, d_chain = out
    return ([("d_s_node", d_s), ("d_v_node", d_v), ("d_epack", d_ep)]
            + [(f"d_g1[{k}]", d_g1[k]) for k in G1_KEYS]
            + [(f"d_chain[{k}]", t) for k, t in zip(CHAIN_KEYS, d_chain)])


# The backward kernel keeps a per-edge-row scratch in device memory
# (``RowLayout::width`` floats a row, csrc/message_layer_bwd.cu, and
# :func:`bwd_row_layout`: 6,040 at GEOM width).  A batch whose scratch would outgrow this budget is walked in
# chunks of whole molecules, one call of the kernel a chunk, with the scratch
# and the weight-grad partials allocated once at the chunk's size.  4 GiB
# keeps QM9's training shape (B=64, N=29: 1.3 GB) one chunk and GEOM's
# largest bucket (B=64, N=192: 57 GB whole) to 16 chunks of 4 molecules.
BWD_SCRATCH_BUDGET = 4 << 30  # bytes


def bwd_row_layout(s_dim: int, v_dim: int, se: int, ve: int, h1: int, hc: int, g: int) -> Dict[str, int]:
    """Column offsets of the backward kernel's per-edge-row scratch, a copy
    of ``RowLayout`` in ``csrc/message_layer_bwd.cu`` (the ``stage_*``
    offsets are relative to ``stage0 + k * stage_w`` for chain stage k), and
    its ``width``."""
    v3, w1, wc = 3 * v_dim, 3 * h1 + 27, 3 * hc + 27
    first = [("xi", 3 * ve), ("cat1", se + h1 + 9), ("silu1", s_dim), ("dvhd1", w1), ("ds2_1", s_dim),
             ("dvu1", v3), ("dzg1", v_dim), ("vhd1", w1), ("root1", h1), ("s2_1", s_dim), ("gate1", v_dim),
             ("vu1", v3)]
    stage = [("vin", v3), ("merged", s_dim + hc + 9), ("silu", s_dim), ("dvhd", wc), ("ds2", s_dim), ("dvu", v3),
             ("dzg", v_dim), ("vhd", wc), ("root", hc), ("s2", s_dim), ("gate", v_dim), ("vu", v3)]
    out, o = {}, 0
    for name, w in first:
        out[name], o = o, o + w
    q = 0
    for name, w in stage:
        out["stage_" + name], q = q, q + w
    out["stage0"], out["stage_w"] = o, q
    o += g * q
    for name, w in (("sfin", s_dim), ("attn", 1), ("dzattn", 1)):
        out[name], o = o, o + w
    out["width"] = -(-o // 4) * 4
    return out


def bwd_widths(g1: Dict[str, Tensor], chain: tuple, ve_dim: int) -> Tuple[int, ...]:
    """``(s_dim, v_dim, se, ve, h1, hc, g)`` of a layer's packed weights: the
    widths that fix the backward's scratch layout and weight grads."""
    s_dim, v_dim = g1["wg"].shape
    h1 = g1["wu_bd"].shape[0] // 3
    return (s_dim, v_dim, g1["wsx"].shape[0] - h1 - 9, ve_dim, h1, (chain[0].shape[2] - 27) // 3,
            chain[0].shape[0])


def bwd_grad_shapes(widths: Sequence[int]) -> list:
    """Shapes of the 14 edge-row weight grads the backward kernel writes, in
    its order: GCP1 wve, wsx, bs, wu_bd, wg, bg; the chain's w_comb, wsc, bsc,
    wu_bd, wgc, bgc; wattn, battn."""
    s_dim, v_dim, se, ve, h1, hc, g = widths
    v3, w1, wc = 3 * v_dim, 3 * h1 + 27, 3 * hc + 27
    return [(3 * ve, w1), (se + h1 + 9, s_dim), (s_dim,), (3 * h1, v3), (s_dim, v_dim), (v_dim,),
            (g, v3, wc), (g, s_dim + hc + 9, s_dim), (g, s_dim), (g, 3 * hc, v3), (g, s_dim, v_dim), (g, v_dim),
            (s_dim, 1), (1,)]


def bwd_weight_grad_products(widths: Sequence[int]) -> list:
    """The weight grads as products over the scratch's edge rows, one entry
    per product: ``(grad, bias grad or None, chain stage or None, x offset,
    K, dY offset, Nn)`` -> grad[stage] = X[:, x:x+K]^T dY[:, y:y+Nn] and
    bias[stage] = dY[:, y:y+Nn].sum(0), indices into :func:`bwd_grad_shapes`
    (the kernel's problem list)."""
    s_dim, v_dim, se, ve, h1, hc, g = widths
    rl = bwd_row_layout(*widths)
    v3, w1, wc = 3 * v_dim, 3 * h1 + 27, 3 * hc + 27
    out = [(0, None, None, rl["xi"], 3 * ve, rl["dvhd1"], w1), (1, 2, None, rl["cat1"], se + h1 + 9, rl["ds2_1"], s_dim),
           (3, None, None, rl["vhd1"], 3 * h1, rl["dvu1"], v3), (4, 5, None, rl["silu1"], s_dim, rl["dzg1"], v_dim)]
    for k in range(g):
        sb = rl["stage0"] + k * rl["stage_w"]
        out += [(6, None, k, sb + rl["stage_vin"], v3, sb + rl["stage_dvhd"], wc),
                (7, 8, k, sb + rl["stage_merged"], s_dim + hc + 9, sb + rl["stage_ds2"], s_dim),
                (9, None, k, sb + rl["stage_vhd"], 3 * hc, sb + rl["stage_dvu"], v3),
                (10, 11, k, sb + rl["stage_silu"], s_dim, sb + rl["stage_dzg"], v_dim)]
    out.append((12, 13, None, rl["sfin"], s_dim, rl["dzattn"], 1))  # the attention weight and its bias
    return out


def bwd_proj_sums_plain(rows: Tensor, b: int, n: int, widths: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """Plain twin of the backward's node sums on a scratch ``rows [b*n*n,
    width]`` (edge row (b, i, j) at (b*n + i)*n + j): GCP1's cotangent columns
    ``dvhd1 | ds2_1`` summed over the targets j (``d_proj_i``) and over the
    sources i (``d_proj_j``) by ``torch.sum``, each ``[b, n, S + W1]`` in the
    order ``ds2_1 | dvhd1``."""
    s_dim, w1 = widths[0], 3 * widths[4] + 27
    rl = bwd_row_layout(*widths)
    edge = rows.view(b, n, n, rl["width"])[..., rl["dvhd1"]: rl["dvhd1"] + w1 + s_dim]
    d_i, d_j = edge.sum(2), edge.sum(1)
    return torch.cat([d_i[..., w1:], d_i[..., :w1]], -1), torch.cat([d_j[..., w1:], d_j[..., :w1]], -1)


def bwd_weight_grads_plain(rows: Tensor, widths: Sequence[int], out=None) -> list:
    """Plain twin of the backward's weight grads on a scratch ``rows``:
    ``torch.mm`` of each product's column slices and ``sum(0)`` of each
    bias's (:func:`bwd_weight_grad_products`) -> the 14 grads in float32,
    written or, given ``out``, added onto it."""
    grads = [torch.empty(s, dtype=torch.float32, device=rows.device) for s in bwd_grad_shapes(widths)]
    for gi, bi, stage, xo, k, yo, nn in bwd_weight_grad_products(widths):
        dy = rows[:, yo: yo + nn]
        parts = [(gi, torch.mm(rows[:, xo: xo + k].t(), dy))] + ([(bi, dy.sum(0))] if bi is not None else [])
        for idx, val in parts:
            (grads[idx] if stage is None else grads[idx][stage]).copy_(val.reshape(grads[idx].shape[stage is not None:]))
    if out is None:
        return grads
    for t, gr in zip(out, grads):
        t.add_(gr)
    return list(out)


def bwd_chunk_molecules(n: int, row_floats: int, budget: int = BWD_SCRATCH_BUDGET) -> int:
    """Molecules a chunk of the backward: as many molecules of ``n * n``
    edge rows of ``row_floats`` float32 scratch as ``budget`` bytes hold,
    at least one."""
    return max(1, budget // (n * n * row_floats * 4))


def message_layer_bwd_plain(s_node: Tensor, v_node: Tensor, epack: Tensor, g1: Dict[str, Tensor],
                            chain: tuple, cotangents: Tuple[Tensor, Tensor], *, ve_dim: int):
    """Plain PyTorch backward of the layer: autograd through
    :func:`message_layer_plain`, a recompute (as the JAX fallback VJP).

    Returns ``(d_s_node, d_v_node, d_epack, d_g1 dict, d_chain tuple)`` with
    each cotangent in its primal's dtype."""
    prim = [s_node, v_node, epack] + [g1[k] for k in G1_KEYS] + list(chain)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in prim]
        out = message_layer_plain(leaves[0], leaves[1], leaves[2], dict(zip(G1_KEYS, leaves[3:13])),
                                  tuple(leaves[13:]), ve_dim=ve_dim)
        grads = torch.autograd.grad(out, leaves, cotangents, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return grads[0], grads[1], grads[2], dict(zip(G1_KEYS, grads[3:13])), tuple(grads[13:])


def _check_layer_inputs(s_node, v_node, epack, g1, chain, ve_dim, cotangents=None):
    """Shapes, dtype and device of a layer call (and of its output
    cotangents) -> its widths; raises ValueError on anything the kernels do
    not take."""
    b, n, s_dim = s_node.shape
    dt = s_node.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the message-layer kernels take float32 or bfloat16, not {dt}")
    v3 = v_node.shape[-1]
    v_dim = v3 // 3
    h1 = g1["wu_bd"].shape[0] // 3
    se = g1["wsx"].shape[0] - h1 - 9
    w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn = chain
    num_gcps = w_comb.shape[0]
    hc = (w_comb.shape[2] - 27) // 3
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
    if cotangents is not None:
        expected["d_s_agg"] = (cotangents[0], (b, n, s_dim))
        expected["d_v_agg"] = (cotangents[1], (b, n, v3))
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.device != s_node.device or t.dtype != dt:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dt} on {s_node.device}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside the kernel's grid range")
    return b, n, s_dim, v_dim, se, h1, hc, num_gcps


def _node_projections(s_node, v_node, g1):
    """s@wsi | v@wvi and s@wsj | v@wvj, O(B N S^2): outside the kernels, as in
    the TPU wrapper."""
    proj_i = torch.cat([s_node @ g1["wsi"], v_node @ g1["wvi"]], dim=-1).contiguous()
    proj_j = torch.cat([s_node @ g1["wsj"], v_node @ g1["wvj"]], dim=-1).contiguous()
    return proj_i, proj_j


_C_FUNCTIONS = {torch.float32: "message_layer_f32", torch.bfloat16: "message_layer_bf16"}
_C_BWD_FUNCTIONS = {torch.float32: "message_layer_bwd_f32", torch.bfloat16: "message_layer_bwd_bf16"}


def _kernel_function(dtype):
    from bio_diffusion_torch.ops.build import load_library

    lib = load_library("message_layer")
    fn = getattr(lib, _C_FUNCTIONS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _message_layer_cuda(s_node, v_node, epack, g1, chain, ve_dim):
    b, n, s_dim, v_dim, se, h1, hc, num_gcps = _check_layer_inputs(s_node, v_node, epack, g1, chain, ve_dim)
    w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn = chain
    dt = s_node.dtype
    p = epack.shape[-1]
    proj_i, proj_j = _node_projections(s_node, v_node, g1)
    tensors = [proj_i, proj_j, epack.contiguous(), g1["wve"], g1["wsx"], g1["bs"], g1["wu_bd"],
               g1["wg"], g1["bg"], w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn]
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel weights must be contiguous")
    s_agg = torch.empty((b, n, s_dim), dtype=dt, device=s_node.device)
    v_agg = torch.empty((b, n, 3 * v_dim), dtype=dt, device=s_node.device)
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


def _bwd_library():
    from bio_diffusion_torch.ops.build import load_library

    lib = load_library("message_layer_bwd")
    if lib.message_layer_bwd_workspace.argtypes is None:
        lib.message_layer_bwd_workspace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.message_layer_bwd_workspace.restype = ctypes.c_int
        # (ins, outs, rows, partials, tile counters, dims, accumulate, stream)
        for name in _C_BWD_FUNCTIONS.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.message_layer_bwd_proj_sums.argtypes = [ctypes.c_void_p] * 5
        lib.message_layer_bwd_proj_sums.restype = ctypes.c_int
        lib.message_layer_bwd_weight_grads.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        lib.message_layer_bwd_weight_grads.restype = ctypes.c_int
    return lib


def _bwd_workspace(lib, dims) -> Tuple[int, int, int, int]:
    """(scratch floats, weight-grad partial floats, shared-memory bytes a
    block, weight-grad tiles) of the backward kernel at ``dims``; raises for
    widths it does not take."""
    sizes = (ctypes.c_longlong * 4)()
    err = lib.message_layer_bwd_workspace(ctypes.addressof(dims), ctypes.addressof(sizes))
    if err != 0:
        raise ValueError(f"message-layer backward kernel does not take these widths (code {err})")
    return tuple(sizes)


def _bwd_dims(b: int, n: int, widths: Sequence[int]):
    s_dim, v_dim, se, ve, h1, hc, g = widths
    return (ctypes.c_int * 10)(b, n, se + 3 * ve + 10, s_dim, v_dim, se, ve, h1, hc, g)


# the weight-grad kernel's tile counters (int32, one a tile), by device and
# stream: allocated zeroed once, and 0 again after every launch (the last
# block of a tile resets its counter)
_bwd_tickets: Dict[Tuple[int, int], Tensor] = {}


def bwd_tickets(device: torch.device, stream: int, count: int) -> Tensor:
    """At least ``count`` zeroed tile counters for launches on ``stream``."""
    key = (device.index, stream)
    t = _bwd_tickets.get(key)
    if t is None or t.numel() < count:
        t = _bwd_tickets[key] = torch.zeros(count, dtype=torch.int32, device=device)
    return t


def _check_scratch(rows: Tensor, b: int, n: int, widths: Sequence[int]) -> None:
    rl = bwd_row_layout(*widths)
    if rows.dtype != torch.float32 or tuple(rows.shape) != (b * n * n, rl["width"]) or not rows.is_contiguous():
        raise ValueError(f"scratch: {rows.dtype} {tuple(rows.shape)}, expected contiguous float32 "
                         f"({b * n * n}, {rl['width']})")


def bwd_proj_sums(rows: Tensor, b: int, n: int, widths: Sequence[int]) -> Tuple[Tensor, Tensor]:
    """The backward kernel's node sums alone (``proj_sum_kernel``) on a
    scratch of its layout: ``(d_proj_i, d_proj_j)`` as
    :func:`bwd_proj_sums_plain` gives them.  CUDA tensors go through the
    kernel, CPU tensors through the plain twin.  For comparison and
    measurement; not counted in ``launch_counts``."""
    _check_scratch(rows, b, n, widths)
    if rows.device.type == "cpu":
        return bwd_proj_sums_plain(rows, b, n, widths)
    c = widths[0] + 3 * widths[4] + 27
    d_i, d_j = (torch.empty((b, n, c), dtype=torch.float32, device=rows.device) for _ in range(2))
    dims = _bwd_dims(b, n, widths)
    with torch.cuda.device(rows.device):
        err = _bwd_library().message_layer_bwd_proj_sums(
            rows.data_ptr(), ctypes.addressof(dims), d_i.data_ptr(), d_j.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"proj_sum_kernel launch failed with CUDA error {err}")
    return d_i, d_j


def bwd_weight_grads(rows: Tensor, b: int, n: int, widths: Sequence[int], out=None) -> list:
    """The backward kernel's weight grads alone (``weight_grad_kernel`` with
    its folded split reduction) on a scratch of its layout: the 14 grads of
    :func:`bwd_grad_shapes` in float32, written or, given ``out``, added onto
    it.  CUDA tensors go through the kernel, CPU tensors through the plain
    twin.  For comparison and measurement; not counted in ``launch_counts``."""
    _check_scratch(rows, b, n, widths)
    if rows.device.type == "cpu":
        return bwd_weight_grads_plain(rows, widths, out)
    dev = rows.device
    grads = list(out) if out is not None else [torch.empty(s, dtype=torch.float32, device=dev)
                                                for s in bwd_grad_shapes(widths)]
    lib = _bwd_library()
    dims = _bwd_dims(b, n, widths)
    _, partial_floats, _, tiles = _bwd_workspace(lib, dims)
    partials = torch.empty(partial_floats, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = bwd_tickets(dev, stream, tiles)
    ptrs = (ctypes.c_void_p * len(grads))(*[t.data_ptr() for t in grads])
    with torch.cuda.device(dev):
        err = lib.message_layer_bwd_weight_grads(rows.data_ptr(), ctypes.addressof(dims), ctypes.addressof(ptrs),
                                                 partials.data_ptr(), tickets.data_ptr(), int(out is not None),
                                                 stream)
    if err != 0:
        raise RuntimeError(f"weight_grad_kernel launch failed with CUDA error {err}")
    return grads


def bwd_chunks(s_node: Tensor, v_node: Tensor, epack: Tensor, g1: Dict[str, Tensor], chain: tuple, *,
               ve_dim: int) -> Tuple[int, int, int]:
    """The plan by which the kernel's wrapper walks this batch: ``(molecules
    a chunk, chunks, scratch bytes a molecule)``.  For tests and
    measurement; the wrapper itself makes the same arithmetic."""
    b, n, s_dim, v_dim, se, h1, hc, num_gcps = _check_layer_inputs(s_node, v_node, epack, g1, chain, ve_dim)
    dims = _bwd_dims(1, n, (s_dim, v_dim, se, ve_dim, h1, hc, num_gcps))
    row_floats = _bwd_workspace(_bwd_library(), dims)[0] // (n * n)
    chunk = min(b, bwd_chunk_molecules(n, row_floats))
    return chunk, -(-b // chunk), 4 * n * n * row_floats


def _message_layer_bwd_cuda(s_node, v_node, epack, g1, chain, cotangents, ve_dim, chunk_molecules=None):
    """The kernel over the batch in chunks of whole molecules, one call of
    the kernel a chunk: at most ``BWD_SCRATCH_BUDGET`` bytes of scratch, or
    ``chunk_molecules`` a chunk."""
    ds_agg, dv_agg = (c.contiguous() for c in cotangents)
    b, n, s_dim, v_dim, se, h1, hc, num_gcps = _check_layer_inputs(
        s_node, v_node, epack, g1, chain, ve_dim, cotangents)
    w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn = chain
    dt, dev = s_node.dtype, s_node.device
    v3, w1 = 3 * v_dim, 3 * h1 + 27
    p = epack.shape[-1]
    lib = _bwd_library()

    def dims(molecules):
        return _bwd_dims(molecules, n, (s_dim, v_dim, se, ve_dim, h1, hc, num_gcps))

    sizes = _bwd_workspace(lib, dims(b))
    if chunk_molecules is None:
        chunk_molecules = bwd_chunk_molecules(n, sizes[0] // (b * n * n))
    chunk = min(b, chunk_molecules)
    if chunk < b:
        sizes = _bwd_workspace(lib, dims(chunk))
    row_floats, partial_floats, smem, tiles = sizes
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"message-layer backward needs {smem} B of shared memory per block; "
                         f"the device allows {limit}")

    proj_i, proj_j = _node_projections(s_node, v_node, g1)
    epack = epack.contiguous()
    # every weight the kernel multiplies by in the backward, transposed once
    # here (O(weights)) so that each product reads its weight row-major
    def tr(w):
        return w.transpose(-1, -2).contiguous()

    weights = [g1["wve"], g1["wsx"], g1["bs"], g1["wu_bd"], g1["wg"], g1["bg"],
               w_comb, wsc, bsc, wu_bd, wgc, bgc, wattn, battn,
               tr(g1["wve"]), tr(g1["wsx"]), tr(g1["wu_bd"]), tr(g1["wg"]),
               tr(w_comb), tr(wsc), tr(wu_bd), tr(wgc)]
    for t in weights:
        if not t.is_contiguous():
            raise ValueError("kernel weights must be contiguous")
    f32 = dict(dtype=torch.float32, device=dev)
    d_epack = torch.empty((b, n * n, p), dtype=dt, device=dev)
    d_proj_i = torch.empty((b, n, s_dim + w1), **f32)
    d_proj_j = torch.empty((b, n, s_dim + w1), **f32)
    d_g1 = {k: torch.empty(g1[k].shape, **f32) for k in ("wve", "wsx", "bs", "wu_bd", "wg", "bg")}
    d_chain = [torch.empty(c.shape, **f32) for c in chain]
    grads = [d_g1[k] for k in ("wve", "wsx", "bs", "wu_bd", "wg", "bg")] + d_chain
    rows = torch.empty(row_floats, **f32)
    partials = torch.empty(partial_floats, **f32)
    fn = getattr(lib, _C_BWD_FUNCTIONS[dt])
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = bwd_tickets(dev, stream, tiles)

    # the first chunk writes the weight grads, each later one adds its sums
    # onto them in the kernel's final write (chunk order, float32, no
    # atomics: deterministic)
    for b0 in range(0, b, chunk):
        b1 = min(b, b0 + chunk)
        ins = [proj_i[b0:b1], proj_j[b0:b1], epack[b0:b1], ds_agg[b0:b1], dv_agg[b0:b1]] + weights
        outs = [d_epack[b0:b1], d_proj_i[b0:b1], d_proj_j[b0:b1]] + grads
        # the ctypes arrays stay referenced until the call returns
        ptrs_in = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
        ptrs_out = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
        chunk_dims = dims(b1 - b0)
        with torch.cuda.device(dev):
            err = fn(ctypes.addressof(ptrs_in), ctypes.addressof(ptrs_out), rows.data_ptr(),
                     partials.data_ptr(), tickets.data_ptr(), ctypes.addressof(chunk_dims), int(b0 > 0), stream)
        if err != 0:
            raise RuntimeError(f"message-layer backward kernel launch failed with CUDA error {err}")
        launch_counts["message_layer_bwd"] += 1

    # node-side products, O(B N S^2), in float32 as in the TPU kernel
    dpi_s, dpi_v = d_proj_i[..., :s_dim], d_proj_i[..., s_dim:]
    dpj_s, dpj_v = d_proj_j[..., :s_dim], d_proj_j[..., s_dim:]
    sn = s_node.float().reshape(b * n, s_dim)
    vn = v_node.float().reshape(b * n, v3)
    d_s_node = dpi_s @ g1["wsi"].float().t() + dpj_s @ g1["wsj"].float().t()
    d_v_node = dpi_v @ g1["wvi"].float().t() + dpj_v @ g1["wvj"].float().t()
    d_g1["wsi"] = sn.t() @ dpi_s.reshape(b * n, s_dim)
    d_g1["wsj"] = sn.t() @ dpj_s.reshape(b * n, s_dim)
    d_g1["wvi"] = vn.t() @ dpi_v.reshape(b * n, w1)
    d_g1["wvj"] = vn.t() @ dpj_v.reshape(b * n, w1)
    return (d_s_node.to(dt), d_v_node.to(dt), d_epack,
            {k: d_g1[k].to(g1[k].dtype) for k in G1_KEYS},
            tuple(d.to(c.dtype) for d, c in zip(d_chain, chain)))


def fused_message_layer_bwd(s_node: Tensor, v_node: Tensor, epack: Tensor, g1: Dict[str, Tensor],
                            chain: tuple, cotangents: Tuple[Tensor, Tensor], *, ve_dim: int):
    """Backward of :func:`fused_message_layer` given ``(d_s_agg, d_v_agg)`` ->
    ``(d_s_node, d_v_node, d_epack, d_g1 dict, d_chain tuple)`` in the primal
    dtypes.  CUDA tensors go through the hand-written kernel
    (``csrc/message_layer_bwd.cu``), in chunks of whole molecules where the
    batch's scratch would outgrow ``BWD_SCRATCH_BUDGET``; CPU tensors through
    :func:`message_layer_bwd_plain`; any other device raises."""
    if s_node.device.type == "cuda":
        return _message_layer_bwd_cuda(s_node, v_node, epack, g1, chain, cotangents, ve_dim)
    if s_node.device.type == "cpu":
        return message_layer_bwd_plain(s_node, v_node, epack, g1, chain, cotangents, ve_dim=ve_dim)
    raise RuntimeError(f"no message-layer implementation for device {s_node.device}")


class MessageLayerFunction(torch.autograd.Function):
    """The layer with its own backward (counterpart of the custom VJP in
    ``gcpnet_fast.py::make_message_layer_fn``): forward by
    :func:`fused_message_layer`, backward by :func:`fused_message_layer_bwd`.
    Only the inputs are saved; the backward recomputes the forward."""

    @staticmethod
    def forward(ctx, ve_dim, s_node, v_node, epack, *weights):
        ctx.ve_dim = ve_dim
        ctx.save_for_backward(s_node, v_node, epack, *weights)
        return fused_message_layer(s_node, v_node, epack, dict(zip(G1_KEYS, weights[:10])),
                                   tuple(weights[10:]), ve_dim=ve_dim)

    @staticmethod
    def backward(ctx, d_s_agg, d_v_agg):
        s_node, v_node, epack, *weights = ctx.saved_tensors
        d_s, d_v, d_ep, d_g1, d_chain = fused_message_layer_bwd(
            s_node, v_node, epack, dict(zip(G1_KEYS, weights[:10])), tuple(weights[10:]),
            (d_s_agg.contiguous(), d_v_agg.contiguous()), ve_dim=ctx.ve_dim)
        return (None, d_s, d_v, d_ep, *[d_g1[k] for k in G1_KEYS], *d_chain)


def message_layer(s_node: Tensor, v_node: Tensor, epack: Tensor, g1: Dict[str, Tensor],
                  chain: tuple, *, ve_dim: int) -> Tuple[Tensor, Tensor]:
    """Differentiable :func:`fused_message_layer` (the kernels in both directions on CUDA)."""
    return MessageLayerFunction.apply(ve_dim, s_node, v_node, epack,
                                      *[g1[k] for k in G1_KEYS], *chain)
