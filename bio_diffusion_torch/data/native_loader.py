"""ctypes bindings for the host-side C++ data loading (``csrc/xyz_parser.cc``).

Port of ``bio_diffusion_tpu/data/native_loader.py``:

  * :func:`parse_gdb9_records` — bulk GDB9 xyz parsing (the QM9
    preparation's hot host loop);
  * :func:`collate_dense_native` — one-pass padded batch collation, which
    ``data/batch.py::iterate_dense_batches`` uses.

The library is the package's own copy of ``native/xyz_parser.cc``, built on
first use with ``g++`` into the git-ignored ``bio_diffusion_torch/build/``
(``ops/build.py::compile_host_source``); nothing is written into
``native/``.  A failed build raises with the compiler's message: there is
no Python fallback (only a machine without a host compiler collates with
numpy, after a warning).  As in the JAX package, a collation whose source arrays
are not float64 / int64 and C-contiguous returns None (the caller collates
with numpy then), so that no call copies the whole dataset.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bio_diffusion_torch.ops import build
from bio_diffusion_torch.utils.logging import get_logger

log = get_logger(__name__)

SOURCE = build.SOURCE_DIR / "xyz_parser.cc"

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_warned = False  # the missing compiler has been reported


def load_native() -> ctypes.CDLL:
    """Build ``csrc/xyz_parser.cc`` unless it is built, load it and declare
    its two C functions -> the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build.compile_host_source(SOURCE)))
            lib.parse_gdb9_batch.restype = ctypes.c_int64
            lib.parse_gdb9_batch.argtypes = [
                ctypes.c_char_p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
                _f64p, _i64p, _f64p, _i64p,
            ]
            lib.collate_dense_batch.restype = None
            lib.collate_dense_batch.argtypes = [
                _f64p, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64,
                _i64p, ctypes.c_int64, _f32p, _f32p, _f32p, _f32p,
            ]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library is loaded or a host C++ compiler can build it
    (nothing is compiled here); without a compiler it warns once."""
    global _warned
    if _lib is not None:
        return True
    try:
        build.find_gxx()
    except RuntimeError as e:
        if not _warned:
            log.warning("%s: batches collate with numpy", e)
            _warned = True
        return False
    return True


GDB9_PROP_NAMES = [
    "index", "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2",
    "zpve", "U0", "U", "H", "G", "Cv", "omega1",
]


def parse_gdb9_records(records: Sequence[bytes], max_atoms: int = 29) -> Dict[str, np.ndarray]:
    """Parse a batch of raw GDB9 xyz records -> padded arrays
    ``{positions [M, max, 3], charges [M, max], num_atoms [M], <prop> [M]}``;
    a record that fails to parse gets ``num_atoms == -1`` (the caller
    filters)."""
    lib = load_native()
    m = len(records)
    buf = b"".join(records)
    lengths = np.array([len(r) for r in records], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    positions = np.zeros((m, max_atoms, 3), np.float64)
    charges = np.zeros((m, max_atoms), np.int64)
    props = np.zeros((m, 17), np.float64)
    n_atoms = np.zeros(m, np.int64)
    lib.parse_gdb9_batch(buf, offsets, lengths, m, max_atoms, positions, charges, props, n_atoms)
    out = {"positions": positions, "charges": charges, "num_atoms": n_atoms}
    for i, name in enumerate(GDB9_PROP_NAMES):
        out[name] = props[:, i].copy()
    return out


def collate_dense_native(
    positions: np.ndarray,  # [M, n_src, 3] float64
    charges: np.ndarray,  # [M, n_src] int64
    sel: np.ndarray,  # [B] int64
    n_pad: int,
    species: np.ndarray,  # [K] int64
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """One-pass padded collation of the molecules ``sel`` -> ``(x [B, n_pad,
    3], one_hot [B, n_pad, K], charges [B, n_pad], mask [B, n_pad])``, float32;
    None when the source arrays are not float64 / int64 and C-contiguous."""
    if not (positions.dtype == np.float64 and positions.flags.c_contiguous
            and charges.dtype == np.int64 and charges.flags.c_contiguous):
        return None
    lib = load_native()
    sel = np.ascontiguousarray(sel, np.int64)
    species = np.ascontiguousarray(species, np.int64)
    b, k = len(sel), len(species)
    x = np.zeros((b, n_pad, 3), np.float32)
    one_hot = np.zeros((b, n_pad, k), np.float32)
    ch = np.zeros((b, n_pad), np.float32)
    mask = np.zeros((b, n_pad), np.float32)
    lib.collate_dense_batch(positions, charges, positions.shape[1], sel, b, n_pad, species, k, x, one_hot, ch, mask)
    return x, one_hot, ch, mask
