"""Build the sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` on first use into ``bio_diffusion_torch/build/lib<name>-<digest>.so``
(the directory is git-ignored; the digest covers the source, every header it
includes with ``#include "..."`` and the flags, so an edited source or header
never loads a stale library).  The host-side C++ sources (``csrc/<name>.cc``:
the xyz parser and batch collation of ``data/native_loader.py``) are
compiled the same way with ``g++`` (:func:`compile_host_source`).  Nothing
is built when a module is imported; a failed build raises with the
compiler's message.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
# name -> another build of that source's C interface, while a
# library_override block is open
_overrides: Dict[str, ctypes.CDLL] = {}
# per source built in this process: the compiler's report (registers,
# spills), for the record of a run
build_log: Dict[str, str] = {}


def find_nvcc() -> str:
    candidates: List[str] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def source_digest(src: Path, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of a source, the local headers it includes (transitively) and the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    seen, todo = set(), [Path(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(str(path.name).encode() + b"\0" + text)
        for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
            todo.append(path.parent / inc.decode())
    return h.hexdigest()[:16]


def _compile(src: Path, find_compiler, flags: Sequence[str], build_dir: Path) -> Tuple[Path, str]:
    """Compile ``src`` with the compiler ``find_compiler()`` and ``flags`` into
    ``build_dir/lib<stem>-<digest>.so`` unless that library is built -> (its
    path, the compiler's report, empty if it was built already); a failed
    compile raises ``RuntimeError`` with the compiler's message."""
    src, build_dir = Path(src), Path(build_dir)
    out = build_dir / f"lib{src.stem}-{source_digest(src, flags)}.so"
    if out.exists():
        return out, ""
    compiler = find_compiler()
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, (proc.stdout + proc.stderr).strip()


def compile_source(src: Path, defines: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile one CUDA source with ``-D`` for each of ``defines`` into the
    build directory unless that library is built -> ``(its path, the
    compiler's report, empty if it was built already)``."""
    return _compile(src, find_nvcc, NVCC_FLAGS + [f"-D{d}" for d in defines], BUILD_DIR)


def find_gxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the path."""
    for cand in (os.environ.get("CXX"), "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("g++ not found (set CXX); the host-side C++ sources cannot be built")


def compile_host_source(src: Path, build_dir: Path = BUILD_DIR) -> Path:
    """Compile one host C++ source with ``g++`` (``GXX_FLAGS``) into
    ``build_dir`` unless that library is built -> its path."""
    return _compile(src, find_gxx, GXX_FLAGS, build_dir)[0]


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is built -> its path."""
    path, report = compile_source(SOURCE_DIR / f"{name}.cu")
    if report:
        build_log[name] = report
    return path


def load_libraries(*names: str) -> List[ctypes.CDLL]:
    """Compile ``csrc/<name>.cu`` for each name that needs it, one nvcc per
    source, all started together; return the loaded libraries.  A failed
    build raises once every compiler has ended."""
    with _lock:
        todo = [n for n in names if n not in _libraries and n not in _overrides]
        with ThreadPoolExecutor(max_workers=max(1, len(todo))) as pool:
            paths = list(pool.map(_build, todo))
        for name, path in zip(todo, paths):
            _libraries[name] = ctypes.CDLL(str(path))
        return [_overrides[n] if n in _overrides else _libraries[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    return load_libraries(name)[0]


@contextlib.contextmanager
def library_override(name: str, lib: ctypes.CDLL) -> Iterator[None]:
    """Inside the block, ``load_library(name)`` returns ``lib``: another build
    of ``csrc/<name>.cu``'s C interface (another version of the source, or
    the source built with a probe), so the ops modules launch its kernels."""
    with _lock:
        if name in _overrides:
            raise RuntimeError(f"{name} is already overridden")
        _overrides[name] = lib
    try:
        yield
    finally:
        with _lock:
            del _overrides[name]
