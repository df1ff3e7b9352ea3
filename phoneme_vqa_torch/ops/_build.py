"""One build path for the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface. At
first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library
``_build/<name>_<digest>.so``, keyed by a hash of the source, the headers
it may include (``csrc/*.cuh``) and the flags, and bound with ``ctypes`` by
its wrapper module. :func:`build` starts one ``nvcc`` per source that is not
built yet, all together, and waits for them all; :func:`call` is how a
wrapper calls a built kernel's entry point.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(PACKAGE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

BUILD_LOGS: Dict[str, str] = {}  # kernel name -> what nvcc printed (-Xptxas -v)
ERR_TENSOR_MAP = 1000  # csrc/attention_core.cuh: a layout TMA refuses


def call(fn, device, *args) -> int:
    """``fn(*args, stream)`` with ``device`` (a CUDA ``torch.device``) the
    current device and ``stream`` its current stream. The device is switched
    only when another one is current, and the stream is read as a raw handle
    (no ``torch.cuda.Stream`` object is built): both cost host time on every
    launch."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def describe(err: int) -> str:
    """A kernel source's launch error code in words."""
    if err == ERR_TENSOR_MAP:
        return "cuTensorMapEncodeTiled refused a tensor map (layout or driver)"
    return f"CUDA error {err}"


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [source(name), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build(*names: str) -> List[str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` each,
    all started together; return the library paths in the order given.
    Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    libs = [_lib_path(n) for n in names]
    running = []
    for name, lib in zip(names, libs):
        if os.path.isfile(lib):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {source(name)}:\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs
