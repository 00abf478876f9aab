"""Build ``csrc/*.cu`` with ``nvcc`` and bind the result with ``ctypes``.

Each source compiles on first use into its own shared library with a
plain C interface under ``build/tsr_tpu_torch_kernels/`` at the root of
the checkout. The library name carries a hash of the source and the
flags, so an edited source never loads a stale build. :func:`build`
compiles several sources at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tsr_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
KERNELS: List["Kernel"] = []


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def hashed_library(sources: Sequence[Path], flags: Sequence[str],
                   build_dir: Path) -> Path:
    """Library path of ``sources`` (every file the build reads, headers
    included) built with ``flags``, named after the first: its name carries
    a hash of all of them, so an edited file or a new flag never loads a
    stale build."""
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                            + " ".join(flags).encode()).hexdigest()
    return build_dir / f"{sources[0].stem}-{digest[:12]}.so"


def library_path(source: str) -> Path:
    return hashed_library([CSRC / source], NVCC_FLAGS, BUILD_DIR)


def build(sources: Iterable[str]) -> Dict[str, dict]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source: {"seconds": s, "ptxas": text}}`` for the sources
    compiled by this call (``ptxas`` holds the register and shared-memory
    report of ``-Xptxas -v``). Raises with the compiler's output when one
    fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    report = {}
    failures = []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{source}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        report[source] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    with _LOCK:
        if source not in _LIBS:
            path = library_path(source)
            if not path.exists():
                build([source])
            _LIBS[source] = ctypes.CDLL(str(path))
        return _LIBS[source]


class Kernel:
    """One launchable C entry point with its own launch count.

    The C function returns ``cudaGetLastError()`` after its launch; a
    non-zero code raises here. ``launches`` counts successful launches
    only, so a run can show that it went through the kernel.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = lib.tsr_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._err_str = err_str
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"kernel {self.name} ({self.source}) failed to launch: "
                f"CUDA error {err}: {self._err_str(err).decode()}")
        self.launches += 1


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device is refused."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"unsupported device {t.device}")


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
