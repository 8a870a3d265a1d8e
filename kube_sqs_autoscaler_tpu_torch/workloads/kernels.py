"""Build and load the port's hand-written CUDA kernels.

Each source under ``kube_sqs_autoscaler_tpu_torch/csrc/`` is compiled by
``nvcc`` into its own shared library with a plain C interface and loaded
with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).  The
library lands in ``build/kernels/`` at the root of the checkout, named by
a hash of its source, every header beside it (``csrc/*.cuh``) and the
flags, so an edited source or header is never served from a stale build.

Nothing is built when this module is imported: :func:`load` builds on
first use, and :func:`build_all` builds every source at once, one
``nvcc`` process per source, all started together (a first :func:`load`
calls it, so the serving path's first run builds its flash and decode
kernels side by side).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def toolkit_binary(tool: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else in /usr/local/cuda/bin."""
    found = shutil.which(tool)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / tool
    if default.exists():
        return str(default)
    raise RuntimeError(
        f"{tool} not found: the CUDA kernels build only where the CUDA "
        "toolkit is installed (PATH or /usr/local/cuda/bin)"
    )


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``; headers are not
    sources)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile each named source (default: all) that has no current
    build, one ``nvcc`` per source in parallel; raises with the
    compiler's output if any fails.  Returns ``{name: library path}``."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    nvcc = toolkit_binary()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{output}")
            continue
        os.replace(tmp, todo[name])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use: a
    first use builds every source without a current build at once
    (:func:`build_all`), so the others' builds run beside this one's."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
