"""Write the PyTorch port's Galileo E5b-I code table,
gnss_sim_receiver_tpu_torch/data/galileo_e5b_codes.npz, from the JAX
package's gnss_sim_receiver_tpu/data/galileo_codes.npz.

The port ships its own copy of the rows it reads and never opens the JAX
package's asset.  The file holds the same packed rows: ``e5bi``, the
10230-chip E5b-I primary codes of PRN 1..50 ([50, 1279] uint8,
np.packbits; reference table Galileo_E5b.h:57), and ``e5bi_sec``, the
4-chip CS4 secondary code as bits (Galileo OS SIS ICD table 37).  Chip
convention bit 0 -> +1, bit 1 -> -1.  E5b-Q and its secondary codes stay
out: no chain of the port tracks them.

Run once from the repository root (the file is committed):
    python3 tools/port_galileo_e5b_codes.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "gnss_sim_receiver_tpu", "data", "galileo_codes.npz")
DST = os.path.join(ROOT, "gnss_sim_receiver_tpu_torch", "data",
                   "galileo_e5b_codes.npz")
KEYS = ("e5bi", "e5bi_sec")


def main() -> int:
    with np.load(SRC) as z:
        rows = {k: np.ascontiguousarray(z[k]) for k in KEYS}
    if rows["e5bi"].shape != (50, 1279) or rows["e5bi_sec"].shape != (4,):
        print(f"unexpected shapes: {[(k, v.shape) for k, v in rows.items()]}",
              file=sys.stderr)
        return 1
    np.savez(DST, **rows)
    print(f"wrote {DST}:",
          [(k, v.shape, str(v.dtype)) for k, v in rows.items()])
    return 0


if __name__ == "__main__":
    sys.exit(main())
