"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel directory ``kernels/<name>/csrc`` holds ``.cu`` sources with a
plain C interface. At first use they are compiled for Hopper into one
shared library per kernel,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/*.cu

under the checkout's ``build/kernels`` directory. The file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already there. No ``nvcc``, or a failed
build, raises: there is no fallback.

``ptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside each library as ``<name>-<hash>.log``. :func:`call` invokes a loaded
entry point on a device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]
# Every kernel directory with CUDA sources; chip_smoke.py builds them all.
KERNELS = ("decode_attention", "kmeans", "rmsnorm", "sdpa_estimator")

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    home = os.environ.get("CUDA_HOME") or CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def _csrc(name: str) -> Path:
    csrc = KERNELS_DIR / name / "csrc"
    if not any(csrc.glob("*.cu")):
        raise KernelBuildError(f"no CUDA sources for kernel {name!r}")
    return csrc


def library_path(name: str) -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_csrc(name).glob("*")):
        h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, one ``nvcc`` per
    kernel, all started together. Returns the library paths."""
    paths = {n: library_path(n) for n in names}
    jobs = []
    for name, out in paths.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent builder never
        # loads a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
        cmd += [str(s) for s in sorted(_csrc(name).glob("*.cu"))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((out, tmp, cmd, proc))
    errors = []
    for out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    if errors:
        raise KernelBuildError("\n".join(errors))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for the current library of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def call(fn, device: torch.device, *args) -> int:
    """Call a kernel's C entry point for ``device``, passing that device's
    current CUDA stream as the last argument (the entry launches there).
    The stream handle is read raw and the device is made current only if it
    is not already: building a ``torch.cuda.Stream`` and entering
    ``torch.cuda.device`` cost more host time than the launch itself."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)
