"""Frozen yardsticks: the model's FLOPs over real atoms, the message
layer's FLOPs and bytes for its roofline, and the card's published peaks.

Every count is of the work the inputs need: a molecule of ``n`` real atoms
has ``n`` nodes and ``n * n`` edges (self-loops included), whatever it is
padded to.  A FLOP is one multiply or one add of a matrix product (a
multiply-add counts 2), as ``torch.utils.flop_counter.FlopCounterMode``
counts them over ``reference/gcdm.py``; elementwise work is not counted.
The tests hold :func:`denoiser_flops` to that counter.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

ROOT = Path(__file__).resolve().parent
SV = 3  # frame projection channels
SCALARIZE = 3 * 3 * SV  # frames [3, 3] against 3 projected channels


def widths(config: Dict) -> Dict[str, int]:
    """The widths a configuration file fixes, by the names used below."""
    m, mod, lay = config["model_cfg"], config["module_cfg"], config["layer_cfg"]
    features = config["num_atom_types"] + int(config["include_charges"])
    return dict(S=m["h_hidden_dim"], V=m["chi_hidden_dim"], Se=m["e_hidden_dim"], Ve=m["xi_hidden_dim"],
                e_in=m["e_input_dim"], xi_in=m["xi_input_dim"], chi_in=m["chi_input_dim"],
                h_in=features + 1, L=m["num_encoder_layers"], M=lay["mp_cfg"]["num_message_layers"],
                b=mod["bottleneck"], db=mod["default_bottleneck"])


def gcp2_macs(s_in: int, v_in: int, s_out: int, v_out: int, hidden: int, ff_out: bool = False) -> int:
    """Multiply-adds of one GCP2 on one row."""
    macs = 3 * v_in * hidden + 3 * v_in * SV + SCALARIZE + (s_in + hidden + 3 * SV) * s_out
    if ff_out:
        macs += s_out * s_out
    if v_out:
        macs += s_out * v_out + 3 * hidden * v_out
    return macs


def message_layer_macs(w: Dict[str, int]) -> Dict[str, int]:
    """One message layer's multiply-adds: ``node`` a real atom, ``edge`` a real edge."""
    S, V, Se, Ve, M = w["S"], w["V"], w["Se"], w["Ve"], w["M"]
    h1 = (2 * V + Ve) // w["db"]
    node = 2 * (3 * V * h1 + 3 * V * SV) + 2 * S * S
    edge = (3 * Ve * h1 + 3 * Ve * SV + Se * S + h1 * S + SCALARIZE + 3 * SV * S + S * V + 3 * h1 * V)
    for i in range(M - 1):
        bott = w["db"] if i == M - 2 else w["b"]
        edge += gcp2_macs(S, V, S, V, V // bott)
    edge += S  # scalar message attention
    return {"node": node, "edge": edge}


def denoiser_macs(w: Dict[str, int]) -> Dict[str, int]:
    """One denoiser call's multiply-adds: ``node`` a real atom, ``edge`` a real edge."""
    S, V, Se, Ve = w["S"], w["V"], w["Se"], w["Ve"]
    ml = message_layer_macs(w)
    node = gcp2_macs(w["h_in"], w["chi_in"], S, V, max(w["chi_in"], V))
    node += w["L"] * (ml["node"] + gcp2_macs(2 * S, 2 * V, S, V, 2 * V // w["b"], ff_out=True)
                      + gcp2_macs(S, V, S, 1, V // w["b"]))
    node += gcp2_macs(S, V, w["h_in"], 0, V)
    edge = gcp2_macs(w["e_in"], w["xi_in"], Se, Ve, max(w["xi_in"], Ve)) + w["L"] * ml["edge"]
    return {"node": node, "edge": edge}


def _over(per: Dict[str, int], sizes: Sequence[int]) -> int:
    return sum(per["node"] * int(n) + per["edge"] * int(n) * int(n) for n in sizes)


def denoiser_flops(config: Dict, sizes: Sequence[int]) -> int:
    """FLOPs of one denoiser call over molecules of ``sizes`` real atoms."""
    return 2 * _over(denoiser_macs(widths(config)), sizes)


def message_layer_flops(config: Dict, sizes: Sequence[int]) -> int:
    """FLOPs of one message layer's forward over molecules of ``sizes`` real atoms."""
    return 2 * _over(message_layer_macs(widths(config)), sizes)


def message_layer_weights(config: Dict) -> int:
    """Parameters of one message stack (first message GCP, chain, attention)."""
    w = widths(config)
    S, V, Se, Ve, M = w["S"], w["V"], w["Se"], w["Ve"], w["M"]
    h1 = (2 * V + Ve) // w["db"]
    count = (2 * V + Ve) * (h1 + SV) + (2 * S + Se + h1 + 3 * SV + 1) * S + h1 * V + (S + 1) * V
    for i in range(M - 1):
        h = V // (w["db"] if i == M - 2 else w["b"])
        count += V * (h + SV) + (S + h + 3 * SV + 1) * S + h * V + (S + 1) * V
    return count + S + 1


def message_layer_bytes(config: Dict, sizes: Sequence[int], backward: bool, itemsize: int = 4) -> int:
    """Bytes one message layer call needs to move: each input read once, each
    output written once, over real rows.  Forward: node scalars and vectors,
    the packed edges (embedding, frames, mask) and the weights in; the
    aggregated scalars and vectors out.  Backward: the same inputs and the
    output cotangents in; the node and edge-embedding gradients and the
    weight gradients out."""
    w = widths(config)
    S, V, Se, Ve = w["S"], w["V"], w["Se"], w["Ve"]
    node = S + 3 * V
    edge_in = Se + 3 * Ve + 10
    weights = message_layer_weights(config)
    total = 0
    for n in sizes:
        n = int(n)
        total += n * node + n * n * edge_in + n * node  # inputs, outputs (or cotangents)
        if backward:
            total += n * node + n * n * (Se + 3 * Ve)  # node and edge gradients written
    total += weights * (2 if backward else 1)
    return total * itemsize


def peaks(device_name: str) -> Optional[Dict]:
    """The published peaks of the card ``device_name`` from ``peaks.json``, or None."""
    table = json.loads((ROOT / "peaks.json").read_text())
    for row in table["cards"]:
        if row["name"] == device_name:
            return row
    return None


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` prints it, or "unknown"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
