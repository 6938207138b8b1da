"""Count the SASS instructions of K5a (``csrc/fir_decim.cu``: the blocked
kernel at each decimation and the kernel before its redesign) and of the
PCPS wipeoff (``csrc/pcps_wipe.cu``).

    python3 tools/k5a_wipe_sass.py

Builds both libraries as the port does (``cuda_build``, into
``build/torch_kernels/``) and reads them with ``cuobjdump -sass``. For
each kernel it prints the static count of every instruction class that
sets its pace: shared-memory loads and stores (LDS, STS), global loads and
stores (LDG, STG, with their widths), FFMA, FMUL/FADD, MUFU, branches and
the total. The blocked FIR kernel's tap loop is unrolled, so its tap
block's body appears twice (all S taps, and the last block's first T mod
S): the first is S taps x R outputs x 2 planes of FFMA and 2 W + S LDS,
W = (R - 1) dec + S. The whole listing goes beside each library as
``<library>.sass``.

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not the card; imports
nothing of JAX.
"""

from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = ("LDS", "STS", "LDG", "STG", "FFMA", "FMUL", "FADD", "MUFU", "BRA",
           "BAR")


def kernels(text: str) -> dict:
    """{function name: [instruction]} of a ``cuobjdump -sass`` listing."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        out[fn.split()[0]] = [m[1].strip() for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+([^;]*?)\s*;", fn)]
    return out


def census(insts) -> Counter:
    """Instructions by class, loads and stores by their width too."""
    c = Counter()
    for ins in insts:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        base = op.split(".")[0]
        if base in CLASSES:
            c[base] += 1
            if base in ("LDS", "STS", "LDG", "STG"):
                width = re.search(r"\.(64|128)\b", op)
                c[f"{base}.{width[1] if width else 32}"] += 1
    c["total"] = len(insts)
    return c


def main() -> int:
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    cuda_build.build_all(("fir_decim", "pcps_wipe"))
    for lib in ("fir_decim", "pcps_wipe"):
        path = cuda_build.library_path(lib)
        text = subprocess.run([str(cuobjdump), "-sass", str(path)],
                              check=True, capture_output=True,
                              text=True).stdout
        path.with_suffix(".sass").write_text(text)
        for name, insts in sorted(kernels(text).items()):
            m = re.search(r"fir_decim_blocked_kernelILi(\d+)ELi(\d+)E", name)
            label = (f"fir_decim_blocked_kernel<dec {m[1]}, R {m[2]}>" if m
                     else next((k for k in ("fir_decim_reference_kernel",
                                            "pcps_wipe_kernel") if k in name),
                               name))
            c = census(insts)
            print(f"{lib} {label}: " + ", ".join(
                f"{k} {v}" for k, v in sorted(c.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
