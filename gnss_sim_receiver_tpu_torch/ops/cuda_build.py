"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``build/torch_kernels/`` at the
repository root, then loaded with ctypes.  A library is named after its
source and a hash of the source text and flags, so an edited kernel is
rebuilt and a stale one is never loaded.  Builds happen at first use (or all
at once, one ``nvcc`` per source in parallel, through :func:`build_all`);
importing this module builds nothing.

No ``--use_fast_math``: the block correlator's angles reach ~2*pi*(1 +
|f|/2N) and ``__sinf`` would lose the accuracy its int32 angle reduction
keeps; the FIR kernel's LO phase reaches millions of radians and the device
generator's carrier phase ~130 rad within an anchor block.

``block_step.cu`` (K8a, K8b) and ``epoch_step.cu`` (K9) are built with
``--fmad=false``: they repeat the plain PyTorch version operation by
operation, where every torch op rounds on its own, so no ``a*b+c`` may be
contracted into an FMA.  The other sources keep nvcc's default.
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

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("block_correlator", "multicorrelator", "fir_decim", "notch",
           "device_generator", "block_step", "epoch_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source beyond NVCC_FLAGS
SOURCE_FLAGS = {"block_step": ("--fmad=false",),
                "epoch_step": ("--fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card, at first use")


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(nvcc_flags(name)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the seconds each
    build took (0.0 for a library already built); raises with the compiler
    output when a build fails.  The ptxas report (registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
