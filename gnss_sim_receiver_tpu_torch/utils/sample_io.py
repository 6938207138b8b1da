"""Raw IF sample file IO (the port's own copy of the plain-format part of
``gnss_sim_receiver_tpu.utils.sample_io``).

Covers the item formats of the reference file signal sources and data-type
adapters (src/algorithms/signal_source/adapters/file_signal_source.cc,
src/algorithms/data_type_adapter/): interleaved byte/short IQ, real
byte/short, and gr_complex float32 files.  Interleaved integers are
de-interleaved with NumPy.  A capture that lives on the card is quantized
there (:func:`quantize_interleaved`) and only its integers come to the host.
The timestamp, NSR, SPIR and LabSat readers are not ported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

# item_type string -> (numpy dtype, complex interleaved?)
_FORMATS = {
    "gr_complex": (np.complex64, False),
    "cshort": (np.int16, True),
    "cbyte": (np.int8, True),
    "ishort": (np.int16, True),   # interleaved I/Q shorts (reference 'ishort')
    "ibyte": (np.int8, True),     # interleaved I/Q bytes
    "short": (np.int16, False),
    "byte": (np.int8, False),
    "float": (np.float32, False),
}


def read_samples(path: str | Path, item_type: str = "gr_complex",
                 count: int = -1, offset_items: int = 0) -> np.ndarray:
    """Read a raw capture file into complex64 baseband samples."""
    dtype, interleaved = _FORMATS[item_type]
    raw_per_sample = 2 if interleaved and dtype != np.complex64 else 1
    raw = np.fromfile(path, dtype=dtype,
                      count=-1 if count < 0 else count * raw_per_sample,
                      offset=offset_items * raw_per_sample
                      * np.dtype(dtype).itemsize)
    if dtype == np.complex64:
        return raw.astype(np.complex64)
    if interleaved:
        out = np.empty(len(raw) // 2, np.complex64)
        planes = out.view(np.float32)
        planes[0::2] = raw[0:2 * len(out):2]
        planes[1::2] = raw[1:2 * len(out):2]
        return out
    return raw.astype(np.float32).astype(np.complex64)


def quantize_interleaved(x: torch.Tensor, item_type: str, scale: float,
                         chunk: int = 1 << 24) -> torch.Tensor:
    """The interleaved integer samples of an interleaved integer format
    ("ibyte", "ishort", ...) for a complex64 tensor, computed on the
    tensor's device as :func:`write_samples` computes them on the host:
    rint(scale * x) (half to even), clipped to the type's range.  Chunked,
    so that no float copy of the whole capture is made."""
    dtype, interleaved = _FORMATS[item_type]
    if not interleaved or dtype == np.complex64:
        raise ValueError(f"{item_type} is not an interleaved integer format")
    info = np.iinfo(dtype)
    tdtype = {np.int8: torch.int8, np.int16: torch.int16}[dtype]
    planes = torch.view_as_real(x.to(torch.complex64)).reshape(-1)
    out = torch.empty(planes.shape, dtype=tdtype, device=x.device)
    for i in range(0, len(planes), 2 * chunk):
        part = torch.round(planes[i:i + 2 * chunk] * float(np.float32(scale)))
        out[i:i + 2 * chunk] = part.clamp_(info.min, info.max).to(tdtype)
    return out


def write_samples(path: str | Path, x, item_type: str = "gr_complex",
                  scale: float = 1.0) -> None:
    """Write complex64 baseband (a NumPy array, or a tensor on any device)
    to a raw capture file in the given format.  A tensor in an interleaved
    integer format is quantized on its device and only the integers cross
    to the host."""
    dtype, interleaved = _FORMATS[item_type]
    if isinstance(x, torch.Tensor):
        if interleaved and dtype != np.complex64:
            quantize_interleaved(x, item_type, scale).cpu().numpy().tofile(
                path)
            return
        x = x.cpu().numpy()
    x = np.asarray(x)
    if dtype == np.complex64:
        (x.astype(np.complex64) * scale).tofile(path)
        return
    info = np.iinfo(dtype)
    if interleaved:
        out = np.empty(2 * len(x), dtype=np.float32)
        out[0::2] = x.real * scale
        out[1::2] = x.imag * scale
        np.clip(np.rint(out), info.min, info.max).astype(dtype).tofile(path)
        return
    np.clip(np.rint(x.real * scale), info.min, info.max).astype(dtype).tofile(
        path)
