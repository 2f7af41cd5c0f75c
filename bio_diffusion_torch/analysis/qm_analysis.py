"""QM property recomputation (psi4 / xtb via crest), host-side.

The PyTorch package's copy of ``bio_diffusion_tpu/analysis/qm_analysis.py``
(host side: numpy, pandas, scipy, matplotlib; nothing of the JAX package).

Counterpart of the reference's src/analysis/qm_analysis.py: recompute
isotropic polarizability for generated molecules with psi4 (B3LYP/6-31G(2df,p),
QM9's level of theory) or GFN2-xTB single points via crest for drug-size
molecules.  Both tools are optional external dependencies.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import List, Optional

from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def compute_polarizability_psi4(xyz_path: str) -> Optional[float]:
    """Isotropic polarizability at B3LYP/6-31G(2df,p) (QM9 protocol)."""
    try:
        import psi4
    except ImportError:
        log.warning("psi4 not installed — cannot recompute polarizability")
        return None
    with open(xyz_path) as f:
        lines = f.readlines()
    geom = "".join(lines[2:])
    mol = psi4.geometry(geom)
    psi4.set_options({"basis": "6-31G(2df,p)"})
    psi4.properties("b3lyp", properties=["dipole_polarizabilities"], molecule=mol)
    try:
        return float(psi4.core.variable("DIPOLE POLARIZABILITY ISOTROPIC"))
    except Exception:
        return None


def compute_xtb_energy_crest(xyz_path: str) -> Optional[float]:
    """GFN2-xTB single-point energy via the crest CLI (GEOM protocol)."""
    if shutil.which("crest") is None:
        log.warning("crest not installed — cannot run GFN2-xTB single points")
        return None
    result = subprocess.run(
        ["crest", xyz_path, "--single-point", "GFN2-xTB"],
        capture_output=True, text=True,
    )
    for line in result.stdout.splitlines():
        if "total energy" in line.lower():
            try:
                return float(line.split()[-2])
            except (ValueError, IndexError):
                continue
    return None


def recompute_directory(xyz_dir: str, method: str = "psi4") -> List[Optional[float]]:
    files = sorted(glob.glob(os.path.join(xyz_dir, "*.xyz")))
    fn = compute_polarizability_psi4 if method == "psi4" else compute_xtb_energy_crest
    return [fn(f) for f in files]
