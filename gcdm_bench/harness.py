"""What ties a run together: the manifest, the files it names, the weights
made from the seed, the per-layer readers and the result line.

Everything that belongs to one configuration, traffic mix, limit set or
per-layer metric sits in a file of its own, found by the name
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``,
``drivers/<kind>.py`` for the traffic file's ``kind`` (a ``drive(run)``
that fills ``run.out``), ``metrics/<metric>.py`` (a ``read(ctx)`` that
returns a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bio_diffusion_tpu")


def load_manifest(path: Optional[Path] = None) -> Dict:
    return json.loads(Path(path or REPO / "BENCHMARK.json").read_text())


def cell(manifest: Dict, workload: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"unknown workload {workload!r}")


def read_json(kind: str, name: str, root: Path = ROOT) -> Dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(manifest: Dict, workload: str) -> List[Dict]:
    return [m for m in manifest["end_to_end"] if applies(m, workload)]


def per_layer(manifest: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics a cell reports: those whose ``workloads`` list it."""
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def load(kind: str, name: str, root: Path = ROOT):
    """The module ``<root>/<kind>/<name>.py`` (a driver or a metric's reader)."""
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gcdm_bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def read_per_layer(manifest: Dict, workload: str, ctx: Dict, root: Path = ROOT) -> Dict[str, Dict]:
    """Each per-layer metric the cell lists.  One that reads nothing there
    means its span or counter was not reached: an error, not a gap."""
    out, silent = {}, []
    for m in per_layer(manifest, workload):
        value = load("metrics", m["name"], root).read(ctx)
        if value is None:
            silent.append(m["name"])
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if silent:
        raise SystemExit(f"{workload} lists per-layer metrics that read nothing: {', '.join(silent)}")
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit; a number passes when it is
    finite and at most its limit."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def make_weights(named_shapes: Dict[str, tuple], seed: int, device, scales: Optional[Dict[str, float]] = None
                 ) -> Dict:
    """Every Linear's weight and bias uniform in +-1/sqrt(fan_in), drawn on
    ``device`` in one call from a generator seeded by ``seed``; a leaf whose
    name starts with a key of ``scales`` is multiplied by its value."""
    import torch

    from gcdm_bench.traffic import torch_seed

    total = sum(math.prod(s) for s in named_shapes.values())
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32).mul_(2.0).sub_(1.0)
    out, off = {}, 0
    for name, shape in named_shapes.items():
        size = math.prod(shape)
        fan_in = shape[1] if len(shape) == 2 else named_shapes[name[: -len("bias")] + "weight"][1]
        scale = next((v for k, v in (scales or {}).items() if name.startswith(k)), 1.0)
        out[name] = flat[off: off + size].view(shape).mul_(scale / math.sqrt(fan_in))
        off += size
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict, device: Dict,
                checks: Dict, breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
