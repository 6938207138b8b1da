"""Count the SASS instructions of K6's satellite loop, in the tiled kernel
(``device_generator_kernel``) and in the kernel before its redesign
(``device_generator_reference_kernel``), both in
``csrc/device_generator.cu``.

    python3 tools/k6_sass.py

Builds the device generator's library as the port does (``cuda_build``,
into ``build/torch_kernels/``) and reads it with ``cuobjdump -sass``. For
each kernel it prints the instructions of the satellite loop (the widest
backward branch) and of its straight path (every forward branch in the
loop taken: each skips a rare case, sincosf's slow reduction or an index
fallback), per (sample, satellite): the tiled kernel's loop makes
kPerThread samples a satellite, read from the source. The straight path's
commonest opcodes follow; the whole listing goes beside the library as
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


def parse_sass(text: str) -> dict:
    """{kernel: [(address, instruction)]} of a ``cuobjdump -sass``
    listing, the kernels named "reference" and "tiled"."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        kernel = "reference" if "reference" in fn.split()[0] else "tiled"
        out[kernel] = [(int(m[1], 16), m[2].strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", fn)]
    return out


def branch(ins: str):
    """(target address, conditional) of a branch, else None."""
    m = re.match(r"(@!?U?P\w+\s+)?BRA\S*\s+(0x[0-9a-f]+)", ins)
    return (int(m[2], 16), m[1] is not None) if m else None


def straight_path(insts, lo: int, hi: int) -> list:
    """The instructions of the loop [lo, hi] that run when every forward
    branch inside it is taken and no backward branch before the loop's
    own is."""
    at = {a: k for k, (a, _) in enumerate(insts)}
    k, path = at[lo], []
    while True:
        addr, ins = insts[k]
        path.append(ins)
        br = branch(ins)
        if addr == hi or ins.startswith("EXIT"):
            return path
        if br and addr < br[0] <= hi:
            k = at[br[0]]
        else:
            k += 1


def report_loops(text: str, per_thread: int) -> None:
    for kernel, insts in parse_sass(text).items():
        loops = [(br[0], a) for a, ins in insts
                 if (br := branch(ins)) and br[0] <= a]
        lo, hi = max(loops, key=lambda lh: lh[1] - lh[0])
        body = [ins for a, ins in insts if lo <= a <= hi]
        run = straight_path(insts, lo, hi)
        samples = 1 if kernel == "reference" else per_thread
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
                      .split(".")[0] for ins in run)
        print(f"  SASS {kernel}: {len(insts)} instructions; the satellite "
              f"loop [{lo:#06x}, {hi:#06x}] holds {len(body)}, its straight "
              f"path {len(run)} for {samples} sample(s): "
              f"{len(run) / samples:.1f} a (sample, satellite)")
        print("    straight path by opcode: " + ", ".join(
            f"{k} {v}" for k, v in ops.most_common(14)))


def main() -> int:
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC_DIR / "device_generator.cu").read_text()
    per_thread = int(re.search(r"constexpr int kPerThread = (\d+);",
                               src)[1])
    cuda_build.build_all(("device_generator",))
    lib = cuda_build.library_path("device_generator")
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lib.with_suffix(".sass").write_text(text)
    print(f"K6 SASS ({lib.name}, kPerThread = {per_thread}):")
    report_loops(text, per_thread)
    return 0


if __name__ == "__main__":
    sys.exit(main())
