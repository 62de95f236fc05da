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
import time
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
BUILD_SECONDS: Dict[str, float] = {}     # library -> nvcc wall seconds
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
    per source, all started together. Returns name -> library path; each
    build's wall seconds go to :data:`BUILD_SECONDS`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    results = {}

    def run(n, cmd, tmp):
        t0 = time.monotonic()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        results[n] = (proc, tmp, cmd, time.monotonic() - t0)

    threads = []
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(n))]
        threads.append(threading.Thread(target=run, args=(n, cmd, tmp)))
        threads[-1].start()
    for t in threads:
        t.join()
    failures = []
    for n, (proc, tmp, cmd, seconds) in results.items():
        if proc.returncode != 0:
            failures.append(f"{' '.join(cmd)}\n{proc.stdout}")
            continue
        BUILD_SECONDS[n] = seconds
        paths[n].with_suffix(".log").write_text(proc.stdout)
        os.replace(tmp, paths[n])           # atomic: readers see whole files
    if failures:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failures))
    return paths


def sass(name: str) -> Dict[str, str]:
    """The SASS of each kernel of the built library ``name``
    (``cuobjdump -sass``, from the toolkit beside ``nvcc``): mangled
    function name -> its instructions."""
    tool = shutil.which("cuobjdump") or str(
        Path(nvcc_path()).with_name("cuobjdump"))
    out = subprocess.run([tool, "-sass", str(build([name])[name])],
                         capture_output=True, text=True, check=True).stdout
    functions = {}
    for part in out.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        functions[head.strip()] = body
    return functions


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (once per
    process)."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
