"""Probe, on one CUDA card, two rounding rules of torch's own CUDA kernels
that the port's hand-written closures must repeat bit for bit.

    python3 tools/probe_torch_rounding.py

Prints, with the card's name and power limit and torch's version:

1. the order in which torch.sum and torch.mean add a contiguous row of
   E = 5 and E = 20 floats (the block closure's means over a block's
   epochs): for 20,000 random rows each, how many differ in bits from
   four candidate orders written out with float32 ops on the card (the
   butterfly of csrc/block_step.cu's row_sum; a shuffle tree from the
   largest power of two <= E at increasing or decreasing offsets;
   sequential);
2. how a card tensor divided by a Python float, and by a 0-d float32
   tensor, rounds: for 100,000 random floats, how many differ in bits
   from a * float32(1 / float32(b)), a * float32(1 / b) with the
   reciprocal taken in double, the double quotient, and the float32
   quotient.

Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def butterfly(x: torch.Tensor) -> torch.Tensor:
    """Lane 0's sum of a warp's xor butterfly over 32 lanes, lanes >= E
    holding 0, each value first added to 0."""
    t = torch.zeros(x.shape[0], 32, device=x.device)
    t[:, :x.shape[1]] = x
    t = 0.0 + t
    for o in (16, 8, 4, 2, 1):
        t = t[:, :o] + t[:, o:2 * o]
    return t[:, 0]


def tree(x: torch.Tensor, ascending: bool) -> torch.Tensor:
    """Element x + W folded into element x (W the largest power of two <=
    E), then a shuffle-down tree over the W lanes, lane 0's sum."""
    n = x.shape[1]
    w = 1
    while 2 * w <= n:
        w *= 2
    t = x[:, :w].clone()
    t[:, :n - w] = t[:, :n - w] + x[:, w:]
    if ascending:
        o = 1
        while o < w:
            idx = torch.arange(0, w, 2 * o, device=x.device)
            t[:, idx] = t[:, idx] + t[:, idx + o]
            o *= 2
        return t[:, 0]
    o = w // 2
    while o >= 1:
        t = t[:, :o] + t[:, o:2 * o]
        o //= 2
    return t[:, 0]


def sequential(x: torch.Tensor) -> torch.Tensor:
    s = torch.zeros(x.shape[0], device=x.device)
    for i in range(x.shape[1]):
        s = s + x[:, i]
    return s


def differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_rounding: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = 20000
    for e in (5, 20):
        x = (rng.standard_normal((rows, e))
             * 10.0 ** rng.uniform(-3, 3, (rows, e))).astype(np.float32)
        xt = torch.from_numpy(x).to(dev)
        ref = torch.sum(xt, dim=1)
        inv = float(np.float32(1) / np.float32(e))
        mean = torch.mean(xt, dim=1)
        for name, got in (("butterfly", butterfly(xt)),
                          ("tree, increasing offsets", tree(xt, True)),
                          ("tree, decreasing offsets", tree(xt, False)),
                          ("sequential", sequential(xt))):
            print(f"E={e}, {rows} rows, {name}: sum differs in "
                  f"{differ(got, ref)}, mean (sum x float(1/E)) in "
                  f"{differ(got * inv, mean)}")
    a = (rng.standard_normal(100000)
         * 10.0 ** rng.uniform(-3, 3, 100000)).astype(np.float32)
    at = torch.from_numpy(a).to(dev)
    for b in (0.53, 0.7845, 6.283185307179586, 1575.42e6):
        for what, divisor in (("Python float", b),
                              ("0-d float32 tensor",
                               torch.tensor(b, dtype=torch.float32))):
            got = torch.from_numpy((at / divisor).cpu().numpy())
            bf = np.float32(b) if what != "Python float" else b
            cands = {
                "a * float32(1 / float32(b))":
                    a * (np.float32(1) / np.float32(b)),
                "a * float32(1 / b), in double":
                    a * np.float32(np.float64(1) / np.float64(bf)),
                "the double quotient":
                    (a.astype(np.float64) / np.float64(bf)).astype(np.float32),
                "the float32 quotient": a / np.float32(b)}
            print(f"a / {b!r} as a {what}: " + "; ".join(
                f"{n} differs in {differ(got, torch.from_numpy(v))}"
                for n, v in cands.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
