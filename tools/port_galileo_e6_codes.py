"""Write the PyTorch port's Galileo E6-B code table,
gnss_sim_receiver_tpu_torch/data/galileo_e6_codes.npz, from the JAX
package's gnss_sim_receiver_tpu/data/galileo_codes.npz.

The port ships its own copy of the rows it reads and never opens the JAX
package's asset.  The file holds the same packed rows: ``e6b``, the
5115-chip E6-B primary codes of PRN 1..50 ([50, 640] uint8, np.packbits;
reference table Galileo_E6.h:45, E6-B/C Codes Technical Note).  Chip
convention bit 0 -> +1, bit 1 -> -1.  E6-C and its secondary codes stay
out: no chain of the port tracks them.

Run once from the repository root (the file is committed):
    python3 tools/port_galileo_e6_codes.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "gnss_sim_receiver_tpu", "data", "galileo_codes.npz")
DST = os.path.join(ROOT, "gnss_sim_receiver_tpu_torch", "data",
                   "galileo_e6_codes.npz")
KEYS = ("e6b",)


def main() -> int:
    with np.load(SRC) as z:
        rows = {k: np.ascontiguousarray(z[k]) for k in KEYS}
    if rows["e6b"].shape != (50, 640):
        print(f"unexpected shapes: {[(k, v.shape) for k, v in rows.items()]}",
              file=sys.stderr)
        return 1
    np.savez(DST, **rows)
    print(f"wrote {DST}:",
          [(k, v.shape, str(v.dtype)) for k, v in rows.items()])
    return 0


if __name__ == "__main__":
    sys.exit(main())
