"""Molecule post-processing analysis: xyz->sdf conversion + PoseBusters scoring.

The PyTorch package's copy of ``bio_diffusion_tpu/analysis/molecule_analysis.py``
(host side: numpy, pandas, scipy, matplotlib; nothing of the JAX package).

Counterpart of the reference's src/analysis/molecule_analysis.py: convert
generated xyz files to SDF (OpenBabel CLI when available, else the
distance-based RDKit construction) and run PoseBusters' `bust` over them.
External tools are optional; everything degrades with clear messages.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import Any, Dict, List, Optional

from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)


def xyz_to_sdf_obabel(xyz_path: str, sdf_path: str) -> bool:
    """Convert via the OpenBabel CLI (reference molecule_analysis.py:31-48)."""
    if shutil.which("obabel") is None:
        return False
    result = subprocess.run(
        ["obabel", xyz_path, "-O", sdf_path], capture_output=True, text=True
    )
    return result.returncode == 0 and os.path.exists(sdf_path)


def convert_xyz_dir_to_sdf(
    xyz_dir: str,
    dataset_info: Optional[Dict[str, Any]] = None,
    prefer_obabel: bool = True,
) -> List[str]:
    """Convert every .xyz in a directory to .sdf."""
    out = []
    for xyz in sorted(glob.glob(os.path.join(xyz_dir, "*.xyz"))):
        sdf = xyz[:-4] + ".sdf"
        ok = prefer_obabel and xyz_to_sdf_obabel(xyz, sdf)
        if not ok:
            if dataset_info is None:
                log.warning(f"obabel unavailable and no dataset_info for {xyz}; skipping")
                continue
            from bio_diffusion_torch.chem.molecule import (
                RDKIT_AVAILABLE, build_molecule, load_molecule_xyz, write_sdf_file,
            )

            if not RDKIT_AVAILABLE:
                log.warning("Neither obabel nor RDKit available; cannot convert xyz->sdf")
                break
            positions, one_hot = load_molecule_xyz(xyz, dataset_info)
            mol = build_molecule(positions, one_hot.argmax(-1), dataset_info)
            write_sdf_file(sdf, [mol])
        out.append(sdf)
    return out


def bust_molecules(sdf_paths: List[str], output_csv: str) -> Optional[str]:
    """Run PoseBusters over generated molecules (requires `posebusters`)."""
    try:
        from posebusters import PoseBusters
    except ImportError:
        log.warning("posebusters not installed — skipping bust analysis")
        return None
    import pandas as pd

    buster = PoseBusters(config="mol")
    df = buster.bust(sdf_paths, None, None)
    df.to_csv(output_csv)
    return output_csv


def main(argv=None):
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        print("usage: molecule_analysis <xyz_dir> [out.csv]")
        return
    sdfs = convert_xyz_dir_to_sdf(args[0])
    print(f"converted {len(sdfs)} molecules")
    if len(args) > 1 and sdfs:
        bust_molecules(sdfs, args[1])


if __name__ == "__main__":
    main()
