"""Build and load the port's CUDA kernels.

Each library is one ``.cu`` file under ``repro_torch/csrc`` with a plain C
interface. At first use it is compiled with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

into ``build/repro_torch/`` at the repository root, keyed by a hash of the
source, of every header under ``csrc`` it includes (``#include "..."``,
followed through headers) and of the flags, and loaded with ``ctypes``. ``-Xptxas -v``'s report
(registers, shared memory, spills) is kept beside the library
(:func:`build_log`). A missing ``nvcc`` or a failed build raises; nothing
falls back. Several libraries build in parallel (:func:`build`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIBRARIES = ("gru_sequence", "gru_sequence_q8", "gru_cell_q8",
             "slstm_cell", "flash_attn", "decode_attn", "gru_cell",
             "rowwise_matvec", "gru_shard")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "port's CUDA kernels cannot be built")


def _source(name: str) -> Path:
    if name not in LIBRARIES:
        raise KeyError(f"unknown kernel library {name!r}; known {LIBRARIES}")
    return CSRC / f"{name}.cu"


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _inputs(path: Path, seen=None) -> list:
    """``path`` and the local headers it includes, transitively, in a fixed
    order (each file once)."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        header = path.parent / inc.decode()
        if header.exists():
            _inputs(header, seen)
    return seen


def library_path(name: str) -> Path:
    """Where the built library for the current source, its headers and the
    flags lives: editing a header gives a new path, never a stale build."""
    h = hashlib.sha256()
    for path in _inputs(_source(name)):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``) from the build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Iterable[str] = LIBRARIES) -> Dict[str, Path]:
    """Build every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    failures = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{out}")
            continue
        paths[n].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[n])           # atomic: readers see whole files
    if failures:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
