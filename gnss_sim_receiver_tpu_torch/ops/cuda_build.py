"""Build and load the port's CUDA C++ kernels (``csrc/*.cu``).

Each library has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` under ``build/torch_kernels/`` at the repository root, then
loaded with ctypes.  A library is named after itself and a hash of every
source it is built from (its ``.cu`` translation units and every file they
include) and of every flag, so an edited kernel is rebuilt and
a stale one is never loaded.  Builds happen at first use (or all at once,
one ``nvcc`` per translation unit in parallel, through :func:`build_all`);
importing this module builds nothing.

No ``--use_fast_math``: the block correlator's angles reach ~2*pi*(1 +
|f|/2N) and ``__sinf`` would lose the accuracy its int32 angle reduction
keeps; the FIR kernel's LO phase reaches millions of radians and the device
generator's carrier phase ~130 rad within an anchor block.

``epoch_step.cu`` (K9's closure) is built with ``--fmad=false``: it
repeats the plain PyTorch version operation by operation, where every
torch op rounds on its own, so no ``a*b+c`` may be contracted into an FMA.
The correlators, ``multicorrelator.cu`` (K2) and ``block_correlator.cu``
(K1), keep nvcc's default contraction, which their accumulations were
measured with.  The per-epoch chunk kernel (``epoch_chunk.cu``) calls K2's
slab body and K9's closure, so a single translation unit under either flag
would change the rounding of the other body.  So the per-epoch library is
built from several translation units, each compiled with relocatable
device code (``-rdc=true``) and its own flags, joined by ``nvcc -dlink``
and linked into one shared library (:data:`LIBRARIES`).  Device LTO would
inline across the units, but nvlink refuses to join units whose ``-fmad``
differ.  Relocatable device code has a cost: a function called across
units keeps the calling convention's registers, so the per-epoch library's
units are capped at 128 registers (:data:`EPOCH_REGS`).

The block library needs none of that.  ``block_step.cu`` (K8a, K8b)
writes every rounding of its float arithmetic out as a round-to-nearest
intrinsic, which no flag contracts, so it gives the same bits under either
``-fmad``; ``block_correlator.cu`` includes it and the library is one
translation unit built with the default flags: K1 with the closure and
the next block's prologue fused is a whole program, with no call across
units (under ``-rdc=true`` K1 ran its E1 shape 1.8 times slower, with the
same bits; ``PERF.md``).  :func:`build_all` and :func:`load` also
build a library with extra flags into a directory of its own, for checks
that compare two builds.  The sigma-point filters' kernels (``sigma.cu``,
K10a and K10b) are one more unit with the default flags, and so are the
PCPS wipeoff and QuickSync's fold (``pcps_wipe.cu``, K3, K3b and K4b),
QuickSync's resolve (``quicksync_resolve.cu``, K4b), pulse blanking
(``pulse_blank.cu``, K5c), and K3c's plain form with K7's fold
(``pcps_rows.cu``).
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

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# each library's translation units (csrc/<unit>.cu); a library of several
# is built with relocatable device code and one device link
LIBRARIES = {
    "epoch_kernels": ("multicorrelator", "epoch_step", "epoch_chunk"),
    "block_kernels": ("block_correlator",),
    "fir_decim": ("fir_decim",),
    "notch": ("notch",),
    "device_generator": ("device_generator",),
    "sigma_kernels": ("sigma",),
    "pcps_wipe": ("pcps_wipe",),
    "quicksync_resolve": ("quicksync_resolve",),
    "pulse_blank": ("pulse_blank",),
    "pcps_rows": ("pcps_rows",),
}
SOURCES = tuple(u for units in LIBRARIES.values() for u in units)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")
# the per-epoch library's registers: with relocatable device code the
# chunk kernel takes the most any function it calls takes (188 on sm_90a
# uncapped: one CTA per SM, and clusters of 13 CTAs no longer all resident
# for 10 channels); 128 fits two CTAs per SM
EPOCH_REGS = ("-maxrregcount=128",)
# flags of one translation unit beyond NVCC_FLAGS
SOURCE_FLAGS = {"epoch_step": ("--fmad=false",) + EPOCH_REGS,
                "multicorrelator": EPOCH_REGS,
                "epoch_chunk": EPOCH_REGS}
RDC_FLAGS = ("-rdc=true",)
LINK_FLAGS = ARCH + ("-Xcompiler", "-fPIC")

_libs: dict[tuple, ctypes.CDLL] = {}
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


def library_of(unit: str) -> str:
    """The library a translation unit is built into."""
    for lib, units in LIBRARIES.items():
        if unit in units:
            return lib
    raise KeyError(unit)


def nvcc_flags(unit: str, extra: tuple[str, ...] = ()) -> tuple[str, ...]:
    """The flags one translation unit is compiled with: relocatable device
    code in a library of several, then the unit's own and `extra`."""
    rdc = RDC_FLAGS if len(LIBRARIES[library_of(unit)]) > 1 else ()
    return NVCC_FLAGS + rdc + SOURCE_FLAGS.get(unit, ()) + tuple(extra)


def included(unit: str) -> list[str]:
    """The files of csrc/ that `unit`.cu includes, directly or through
    another (``#include "name.cu"`` or ``"name.cuh"``)."""
    seen, todo = set(), [f"{unit}.cu"]
    while todo:
        text = (CSRC_DIR / todo.pop()).read_text()
        for name in re.findall(r'#include "(\w+\.cuh?)"', text):
            if name not in seen:
                seen.add(name)
                todo.append(name)
    return sorted(seen)


def library_path(name: str, extra: tuple[str, ...] = (),
                 build_dir: Path | None = None) -> Path:
    """The shared library `name` of LIBRARIES (built with `extra` flags
    into `build_dir`, by default BUILD_DIR), named by a hash of its
    translation units, the files they include and every flag."""
    h = hashlib.sha256()
    units = LIBRARIES[name]
    for unit in units:
        h.update((CSRC_DIR / f"{unit}.cu").read_bytes())
        h.update(" ".join(nvcc_flags(unit, extra)).encode())
        for header in included(unit):
            h.update((CSRC_DIR / header).read_bytes())
    if len(units) > 1:
        h.update(" ".join(LINK_FLAGS).encode())
    return (build_dir or BUILD_DIR) / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(cmd: list[str]) -> tuple[subprocess.Popen, float]:
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT), time.perf_counter())


def _finish(proc: subprocess.Popen, what: str) -> bytes:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n"
                           + log.decode(errors="replace"))
    return log


def _finish_all(jobs, name: str) -> list[bytes]:
    """Wait for every compile of library `name`; raise for the first that
    failed."""
    done = [(unit, proc.communicate()[0], proc.returncode)
            for unit, proc, _, _ in jobs]
    for unit, log, rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {name} ({unit}.cu):\n"
                               + log.decode(errors="replace"))
    return [log for _, log, _ in done]


def build_all(names=tuple(LIBRARIES), extra: tuple[str, ...] = (),
              build_dir: Path | None = None) -> dict[str, float]:
    """Build every named library that is missing (with `extra` flags into
    `build_dir`, by default BUILD_DIR): every translation unit compiled at
    once, one ``nvcc`` process each, then the device link and the link of
    each library of several.  Returns the seconds each build took (0.0 for
    a library already built); raises with the compiler output when a build
    fails.  The ptxas report (registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    (build_dir or BUILD_DIR).mkdir(parents=True, exist_ok=True)
    seconds = {}
    compiles = {}                      # library -> [(unit, proc, t0, out)]
    for name in names:
        out = library_path(name, extra, build_dir)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        units = LIBRARIES[name]
        jobs = []
        for unit in units:
            src = str(CSRC_DIR / f"{unit}.cu")
            if len(units) == 1:
                target, cmd = tmp, ["-shared", "-o", str(tmp), src]
            else:
                target = tmp.with_suffix(f".{unit}.o")
                cmd = ["-c", "-o", str(target), src]
            jobs.append((unit, *_start([nvcc_path(), *nvcc_flags(unit, extra),
                                        *cmd]), target))
        compiles[name] = (jobs, tmp, out)
    failed = []
    for name, (jobs, tmp, out) in compiles.items():
        logs = []
        try:
            logs += _finish_all(jobs, name)
            if len(jobs) > 1:
                objs = [str(o) for *_, o in jobs]
                dlink = tmp.with_suffix(".dlink.o")
                logs.append(_finish(_start(
                    [nvcc_path(), *LINK_FLAGS, "-dlink", "-o", str(dlink),
                     *objs])[0], f"{name} (device link)"))
                logs.append(_finish(_start(
                    [nvcc_path(), *LINK_FLAGS, "-shared", "-o", str(tmp),
                     *objs, str(dlink)])[0], f"{name} (link)"))
                for o in (*objs, str(dlink)):
                    os.remove(o)
        except RuntimeError as e:
            failed.append(str(e))
            continue
        finally:
            out.with_suffix(".log").write_bytes(b"".join(logs))
        seconds[name] = time.perf_counter() - min(t0 for _, _, t0, _ in jobs)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str, extra: tuple[str, ...] = (),
         build_dir: Path | None = None) -> ctypes.CDLL:
    """The loaded library `name` of LIBRARIES, built on first use (with
    `extra` flags into `build_dir`, by default BUILD_DIR)."""
    key = (name, tuple(extra), build_dir)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_all((name,), extra, build_dir)
            lib = ctypes.CDLL(str(library_path(name, extra, build_dir)))
            _libs[key] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
