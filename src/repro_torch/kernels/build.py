"""Build and load the port's CUDA sources.

Each ``csrc/*.cu`` file has a plain C interface.  It is compiled with
``nvcc`` into a shared library under ``build/repro_torch/`` at the repo
root (listed in ``.gitignore``) at first use, named by a hash of the
source, every header (``*.cuh``, ``*.h``) beside it in its ``csrc/``
directory and the flags, and loaded with ``ctypes``.  A library built for
the same sources is reused.  nvcc's log (with ``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside the library
(``build_log``).  Nothing is compiled on import, and nothing falls back:
a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels of repro_torch build on a CUDA machine only")


def library_path(source: Path) -> Path:
    """The library of ``source``, named by a hash of the source, the headers
    it may include from its own directory, and the flags."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    headers = sorted(p for p in source.parent.iterdir() if p.suffix in (".cuh", ".h"))
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_log(source: Path) -> str:
    """nvcc's output for the library of ``source`` (built or cached)."""
    return library_path(source).with_suffix(".log").read_text()


def build(*sources: Path) -> List[Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; returns the library paths in order."""
    todo = [(Path(s), library_path(s)) for s in sources
            if not library_path(s).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src, lib in todo:
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         src, tmp, lib))
        failed = []
        for proc, src, tmp, lib in jobs:
            log = proc.communicate()[0]
            if proc.returncode:
                failed.append(f"{src}:\n{log}")
            else:
                lib.with_suffix(".log").write_text(log)
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [library_path(s) for s in sources]


@functools.lru_cache(maxsize=None)
def load_library(source: Path) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(source)[0]))


def bind(source: Path, signatures: Dict[str, Tuple[list, Any]]) -> ctypes.CDLL:
    """The library of ``source`` with each symbol's ``(argtypes, restype)``
    set: every pointer and the stream as ``c_void_p``, or ctypes would cut
    them to 32 bits."""
    lib = load_library(source)
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str, prefix: str) -> None:
    """Raise if a launch returned a CUDA error: a refused launch never runs,
    and a later synchronize would not report it."""
    if err:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
