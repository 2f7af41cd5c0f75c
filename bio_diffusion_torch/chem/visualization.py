"""Molecule visualization: 3D matplotlib plots and denoising-chain GIFs.

Copy of ``bio_diffusion_tpu/chem/visualization.py`` (the port imports
nothing of the JAX package): ``draw_sphere``, ``plot_molecule``,
``plot_data3d``, ``visualize_mols``, ``visualize_chain`` and
``save_chain_frames``.  Host-side only.  matplotlib (Agg backend) and
imageio are imported inside the render functions, so this module imports
without them; callers that render best-effort (the chain and sweep CLIs,
the Trainer's media) ask ``can_render`` first.  ``save_chain_frames`` is numpy only.
"""

from __future__ import annotations

import glob
import importlib.util
import os
from typing import Any, Dict, List, Optional

import numpy as np

from bio_diffusion_torch.chem.molecule import load_molecule_xyz, save_xyz_files
from bio_diffusion_torch.chem.stability import get_bond_order
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

RENDER_PACKAGES = ("matplotlib", "imageio")
_explained = False


def can_render() -> bool:
    """Whether matplotlib and imageio are installed (neither is imported
    here); the first time in a process that one is missing, log which
    (callers still write their xyz files)."""
    global _explained
    missing = [p for p in RENDER_PACKAGES if importlib.util.find_spec(p) is None]
    if missing and not _explained:
        log.warning("No PNG or GIF renderings: %s not installed (the xyz files are written)", ", ".join(missing))
        _explained = True
    return not missing


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_sphere(ax, x: float, y: float, z: float, size: float, color, alpha: float):
    u = np.linspace(0, 2 * np.pi, 100)
    v = np.linspace(0, np.pi, 100)
    xs = size * np.outer(np.cos(u), np.sin(v))
    ys = size * np.outer(np.sin(u), np.sin(v)) * 0.8
    zs = size * np.outer(np.ones(np.size(u)), np.cos(v))
    ax.plot_surface(x + xs, y + ys, z + zs, rstride=2, cstride=2, color=color,
                    linewidth=0, alpha=alpha)


def plot_molecule(ax, positions: np.ndarray, atom_types: np.ndarray, dataset_info: Dict[str, Any],
                  alpha: float = 1.0, spheres_3d: bool = False, hex_bg_color: str = "#FFFFFF"):
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    colors_dic = np.array(dataset_info["colors_dic"])
    radius_dic = np.array(dataset_info["radius_dic"])
    areas = 1500 * radius_dic[atom_types] ** 2
    radii = radius_dic[atom_types]
    colors = colors_dic[atom_types]

    if spheres_3d:
        for xi, yi, zi, s, c in zip(x, y, z, radii, colors):
            draw_sphere(ax, float(xi), float(yi), float(zi), 0.7 * s, c, alpha)
    else:
        ax.scatter(x, y, z, s=areas, alpha=0.9 * alpha, c=colors)

    decoder = dataset_info["atom_decoder"]
    n = len(x)
    for i in range(n):
        for j in range(i + 1, n):
            dist = float(np.linalg.norm(positions[i] - positions[j]))
            order = get_bond_order(decoder[atom_types[i]], decoder[atom_types[j]], dist)
            if order > 0:
                ax.plot([x[i], x[j]], [y[i], y[j]], [z[i], z[j]],
                        linewidth=2 * (1.5 if order == 4 else 1), c=hex_bg_color, alpha=alpha)


def plot_data3d(positions: np.ndarray, atom_types: np.ndarray, dataset_info: Dict[str, Any],
                save_path: Optional[str] = None, camera_elev: int = 0, camera_azim: int = 0,
                spheres_3d: bool = False, bg: str = "black", alpha: float = 1.0):
    plt = _pyplot()
    hex_bg_color = "#FFFFFF" if bg == "black" else "#666666"
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.set_aspect("auto")
    ax.view_init(elev=camera_elev, azim=camera_azim)
    ax.set_facecolor((0, 0, 0) if bg == "black" else (1, 1, 1))
    ax.xaxis.pane.set_alpha(0)
    ax.yaxis.pane.set_alpha(0)
    ax.zaxis.pane.set_alpha(0)
    ax._axis3don = False

    plot_molecule(ax, positions, atom_types, dataset_info, alpha=alpha, spheres_3d=spheres_3d,
                  hex_bg_color=hex_bg_color)

    max_value = float(np.abs(positions).max()) if len(positions) else 1.0
    axis_lim = min(40.0, max(max_value / 1.5 + 0.3, 3.2))
    ax.set_xlim(-axis_lim, axis_lim)
    ax.set_ylim(-axis_lim, axis_lim)
    ax.set_zlim(-axis_lim, axis_lim)

    dpi = 120 if spheres_3d else 50
    if save_path is not None:
        plt.savefig(save_path, bbox_inches="tight", pad_inches=0.0, dpi=dpi)
    plt.close(fig)


def visualize_mols(path: str, dataset_info: Dict[str, Any], max_num: int = 25,
                   spheres_3d: bool = False) -> List[str]:
    """Render a PNG for up to max_num xyz files in ``path``."""
    files = sorted(glob.glob(os.path.join(path, "*.xyz")))[:max_num]
    out = []
    for f in files:
        positions, one_hot = load_molecule_xyz(f, dataset_info)
        png = f[:-4] + ".png"
        plot_data3d(positions, one_hot.argmax(-1), dataset_info, save_path=png, spheres_3d=spheres_3d)
        out.append(png)
    return out


def visualize_chain(path: str, dataset_info: Dict[str, Any], spheres_3d: bool = False) -> Optional[str]:
    """Render every xyz frame in ``path`` and assemble an output.gif."""
    import imageio.v2 as imageio

    files = sorted(glob.glob(os.path.join(path, "*.xyz")))
    if not files:
        return None
    pngs = []
    for f in files:
        positions, one_hot = load_molecule_xyz(f, dataset_info)
        png = f[:-4] + ".png"
        plot_data3d(positions, one_hot.argmax(-1), dataset_info, save_path=png, spheres_3d=spheres_3d,
                    alpha=1.0)
        pngs.append(png)
    gif_path = os.path.join(os.path.dirname(pngs[0]), "output.gif")
    imgs = [imageio.imread(p) for p in pngs]
    imageio.mimsave(gif_path, imgs, subrectangles=True)
    log.info(f"Wrote chain GIF with {len(imgs)} frames to {gif_path}")
    return gif_path


def chain_frame_steps(num_steps: int, keep_frames: int) -> np.ndarray:
    """Indices of the reverse steps whose states ``save_chain_frames``
    keeps: every ``max(1, T // keep_frames)``-th step from the first."""
    return np.arange(0, num_steps, max(1, num_steps // keep_frames))


def save_chain_frames(frames_xh: np.ndarray, node_mask: np.ndarray, dataset_info: Dict[str, Any],
                      out_dir: str, keep_frames: int = 100) -> List[str]:
    """Subsample one molecule's denoising chain ``frames_xh [T, N, 3+F]``
    (the state after each reverse step, first step first) and write
    per-frame xyz files: the frames of ``chain_frame_steps``, then the last
    of those repeated 10 times.  As in the JAX package, the repeated frame is
    the last *selected* one (at T=1000, keep_frames=100 the state after
    step 990), not the last step's state nor the decoded molecule.  Frames
    that were selected already pass through with ``keep_frames=len``."""
    sel = frames_xh[chain_frame_steps(len(frames_xh), keep_frames)]
    sel = np.concatenate([sel, np.repeat(sel[-1:], 10, axis=0)], axis=0)
    k = len(dataset_info["atom_decoder"])
    masks = np.repeat(node_mask[None], len(sel), axis=0)
    return save_xyz_files(out_dir, sel[..., :3], sel[..., 3:3 + k], masks, dataset_info, name="chain")
