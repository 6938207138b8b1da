"""Input-filter kernels (K5a-K5c): FIR, frequency-translating decimating
FIR, IIR notch, pulse blanking.

PyTorch port of ``gnss_sim_receiver_tpu.ops.filters``, the conditioner's
input_filter stage (reference src/algorithms/input_filter/adapters/:
Fir_Filter, Freq_Xlating_Fir_Filter, Notch_Filter, Notch_Filter_Lite,
Pulse_Blanking_Filter).

- K5a :func:`fir_decim` serves :func:`fir_filter` and
  :func:`freq_xlating_fir_filter`: LO mix, real-tap FIR and decimation in
  one hand-written CUDA kernel (``csrc/fir_decim.cu``: R outputs a thread
  from a register window at decimation 1, 2 and 4; the one-output-a-thread
  kernel it replaced stays as :func:`_fir_decim_reference`, and takes any
  other decimation).
- K5b :func:`notch_filter`: the sequential second-order recurrence as a
  single-pass scan with a decoupled look-back (``csrc/notch.cu``, one
  launch; the three-launch blocked scan it replaced stays as
  :func:`_notch_reference`).
- K5c :func:`pulse_blanking`: three launches of ``csrc/pulse_blank.cu``
  (window powers and the copy of x in one read, with a histogram of the
  powers' top bits; the median by radix select in one thread-block
  cluster; the zeroing), no library call; the two Triton kernels with a
  torch sort between them that it replaced stay as
  :func:`_blank_reference`.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (``_fir_plain``, ``_mix_plain``, ``_notch_plain``, ``_blank_plain``;
line for line with the JAX functions) for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require
from gnss_sim_receiver_tpu_torch.ops import cuda_build


def design_lowpass(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Host-side FIR design (windowed sinc), the role of the reference's
    gr::filter::firdes usage.  cutoff_norm in (0, 1), 1 = Nyquist."""
    from scipy import signal as sps
    return sps.firwin(num_taps, cutoff_norm).astype(np.float32)


def lo_step(center_freq_hz: float, fs: float) -> float:
    """The LO's phase step per sample as a float32 value.  The JAX function
    writes -2 pi * float32(fc / fs); compiled, XLA folds its two constants
    into float32(fc) * (float32(-2 pi) / float32(fs)), which can differ in
    the last bit.  The port takes the compiled form: one ulp of the step is
    a phase error of 6e-8 of the whole LO phase, 0.1 rad after a million
    samples at a quarter-rate IF."""
    return float(np.float32(center_freq_hz)
                 * (np.float32(-2.0 * math.pi) / np.float32(fs)))


def notch_coefficients(f0_norm, bw_norm):
    """(b1, a1, a2, g) of the notch as float32 scalars, in the JAX
    function's float32 operation order."""
    f0, bw = np.float32(f0_norm), np.float32(bw_norm)
    w0 = np.float32(2.0 * math.pi) * f0
    r = np.float32(1.0) - np.float32(math.pi) * bw
    b1 = np.float32(-2.0) * np.cos(w0)
    a1 = np.float32(2.0) * r * np.cos(w0)
    a2 = -(r * r)
    one = np.float32(1.0)
    g = (one + b1 + one) / (one - a1 - a2)
    return b1, a1, a2, g


# ---- plain versions --------------------------------------------------------

def _mix_plain(x, w: float):
    n = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)
    ph = w * n
    return x * torch.complex(torch.cos(ph), torch.sin(ph))


def _fir_plain(x, taps, decimation: int):
    """'Same'-aligned decimating FIR: y[k] = sum_i t[T-1-i] xp[k dec + i]
    over the zero-padded stream, the planes filtered apart."""
    t = taps.to(torch.float32)
    n_taps = t.shape[0]
    pad = n_taps // 2
    n_out = -(-x.shape[0] // decimation)
    xp = torch.nn.functional.pad(torch.view_as_real(x),
                                 (0, 0, pad, n_taps - 1 - pad))
    acc = torch.zeros((n_out, 2), dtype=torch.float32, device=x.device)
    span = (n_out - 1) * decimation + 1
    for i in range(n_taps):
        acc += t[n_taps - 1 - i] * xp[i:i + span:decimation]
    return torch.view_as_complex(acc)


def _notch_plain(x, b1, a1, a2, g):
    """The sequential recurrence, one sample per step."""
    b1, a1, a2, g = float(b1), float(a1), float(a2), float(g)
    xp = torch.cat([x.new_zeros(2), x])
    v = (x + b1 * xp[1:-1]) + xp[:-2]
    y = torch.empty_like(x)
    y1 = y2 = x.new_zeros(())
    for n in range(x.shape[0]):
        yn = (v[n] + a1 * y1) + a2 * y2
        y[n] = yn
        y2, y1 = y1, yn
    return y / g


def _median(v):
    """Median as jnp.median gives it: the two middle values averaged for an
    even count (torch.median would return the lower one)."""
    s, _ = torch.sort(v)
    n = s.shape[0]
    return s[(n - 1) // 2] * 0.5 + s[n // 2] * 0.5


def _blank_threshold(pw, threshold_sigmas: float):
    th = np.float32(threshold_sigmas)
    return float(th * th) * _median(pw)


def _blank_plain(x, threshold_sigmas: float, window: int):
    p = x.real ** 2 + x.imag ** 2
    n = p.shape[0] - p.shape[0] % window
    pw = p[:n].reshape(-1, window).mean(dim=1)
    keep = pw <= _blank_threshold(pw, threshold_sigmas)
    keep_full = torch.cat([
        keep.repeat_interleave(window),
        torch.ones(p.shape[0] - n, dtype=torch.bool, device=x.device)])
    return torch.where(keep_full, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


# ---- K5a: LO mix + FIR + decimation (CUDA) ---------------------------------

def fir_decim(x: torch.Tensor, taps: torch.Tensor, decimation: int = 1,
              lo_step_rad: float = 0.0) -> torch.Tensor:
    """K5a wrapper: x * exp(j lo_step n) -> real-tap FIR -> keep every
    `decimation`-th output; [N] complex64 -> [ceil(N / decimation)].
    lo_step_rad == 0 means no mixing."""
    decimation = int(decimation)
    if x.dim() != 1 or taps.dim() != 1 or decimation < 1:
        raise ValueError("fir_decim: x [N], taps [T], decimation >= 1")
    if not check_kernel_device(x, "fir_decim"):
        if lo_step_rad != 0.0:
            x = _mix_plain(x, lo_step_rad)
        return _fir_plain(x, taps, decimation)
    out = _fir_launch("fir_decim", x, taps, decimation, lo_step_rad)
    fir_decim.launches += 1
    return out


fir_decim.launches = 0


def _fir_decim_reference(x: torch.Tensor, taps: torch.Tensor,
                         decimation: int = 1,
                         lo_step_rad: float = 0.0) -> torch.Tensor:
    """K5a before its redesign (one thread an output): the bit-for-bit
    reference of :func:`fir_decim` on the card, CUDA tensors only; on no
    path, not counted."""
    return _fir_launch("fir_decim_reference", x, taps, int(decimation),
                       lo_step_rad)


def _fir_launch(symbol, x, taps, decimation, lo_step_rad):
    """Check the CUDA tensors and launch the library's `symbol`."""
    require(x, torch.complex64, x.device, "fir_decim: x")
    require(taps, torch.float32, x.device, "fir_decim: taps")
    n = x.shape[0]
    n_out = -(-n // decimation)
    out = torch.empty(n_out, dtype=torch.complex64, device=x.device)
    err = getattr(_fir_lib(), symbol)(
        x.data_ptr(), n, taps.data_ptr(), taps.shape[0], decimation,
        lo_step_rad, int(lo_step_rad != 0.0), out.data_ptr(), n_out,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, symbol)
    return out


def _fir_lib():
    lib = cuda_build.load("fir_decim")
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    for fn in (lib.fir_decim, lib.fir_decim_reference):
        if fn.argtypes is None:
            fn.argtypes = [p, ll, p, i, i, f, i, p, ll, p]
            fn.restype = ctypes.c_int
    return lib


def fir_filter(x: torch.Tensor, taps: torch.Tensor, decimation: int = 1):
    """Decimating FIR on a complex stream ('same' alignment: output k is
    the filter centered at input k*decimation)."""
    return fir_decim(x, taps, decimation)


def freq_xlating_fir_filter(x: torch.Tensor, taps: torch.Tensor,
                            center_freq_hz: float, fs: float,
                            decimation: int = 1):
    """Down-convert by center_freq then low-pass + decimate (the
    reference's Freq_Xlating_Fir_Filter)."""
    return fir_decim(x, taps, decimation, lo_step(center_freq_hz, fs))


# ---- K5b: IIR notch (CUDA) -------------------------------------------------

def notch_filter(x: torch.Tensor, f0_norm, bw_norm) -> torch.Tensor:
    """K5b wrapper: second-order IIR notch at normalized frequency f0 (of
    fs), -3 dB width bw (the role of Notch_Filter_Lite):
    y[n] = x[n] - 2cos(w0) x[n-1] + x[n-2] + 2r cos(w0) y[n-1] - r^2 y[n-2]
    with r = 1 - pi*bw, divided by the passband gain.  On the card: one
    launch of the single-pass scan (``csrc/notch.cu``), which keeps its
    tiles' status in a scratch of the device's (:func:`_notch_status`);
    calls on one device must not run on two streams at once."""
    if x.dim() != 1:
        raise ValueError("notch_filter: x must be one-dimensional")
    b1, a1, a2, g = notch_coefficients(f0_norm, bw_norm)
    if not check_kernel_device(x, "notch_filter"):
        return _notch_plain(x, b1, a1, a2, g)
    out = _notch_scan(_notch_lib(), x, b1, a1, a2, g)
    notch_filter.launches += 1
    return out


notch_filter.launches = 0


def _notch_scan(lib, x, b1, a1, a2, g, sub=None):
    """Launch `lib`'s single-pass notch on the CUDA tensor x, with tiles of
    `sub` sub-tiles (by default :func:`notch_sub_tiles`)."""
    require(x, torch.complex64, x.device, "notch_filter: x")
    threads, per_thread = lib.notch_tile_threads(), lib.notch_per_thread()
    n = x.shape[0]
    sub = notch_sub_tiles(n, threads * per_thread) if sub is None else sub
    n_tiles = -(-n // (sub * threads * per_thread))
    tables = _notch_tables_on(float(a1), float(a2), per_thread, threads,
                              lib.notch_lookback(), sub, x.device)
    status = _notch_status(lib, x.device, n_tiles)
    out = torch.empty_like(x)
    err = lib.notch_filter(
        x.data_ptr(), n, float(b1), float(a1), float(a2), float(g),
        tables.data_ptr(), sub, status.data_ptr(), status.capacity,
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "notch_filter")
    return out


def notch_sub_tiles(n: int, sub_tile: int) -> int:
    """Sub-tiles a tile of the scan at N samples (sub-tiles of `sub_tile`
    samples): 4 where the stream holds NOTCH_LONG sub-tiles or more (the
    capture's 104 M samples: 0.7065 ms against 0.8373 with tiles of one,
    tools/probe_notch.py on an H100), else 1 (4 M samples: 0.0406 ms
    against 0.0431; 1 M + 5: 0.0105 against 0.0118)."""
    return 4 if n >= NOTCH_LONG * sub_tile else 1


NOTCH_LONG = 8192


def _notch_tables(a1: float, a2: float, per_thread: int, threads: int,
                  lookback: int, sub: int = 1) -> np.ndarray:
    """[threads + lookback + 2, 4] float32: the powers of
    M = [[a1, a2], [1, 0]] the single-pass scan composes its carries with,
    each a 2x2 matrix row major: rows j <= threads hold A^j with
    A = M^per_thread (a thread's samples; A^threads carries a sub-tile),
    then rows threads + 1 + d, d <= lookback, hold (M^T)^d with
    T = sub threads per_thread (a tile's).  Formed in float64, rounded to
    float32 once."""
    m = np.array([[a1, a2], [1.0, 0.0]])
    a = np.linalg.matrix_power(m, per_thread)
    tile = np.linalg.matrix_power(a, threads * sub)
    rows = ([np.linalg.matrix_power(a, j) for j in range(threads + 1)]
            + [np.linalg.matrix_power(tile, i) for i in range(lookback + 1)])
    return np.stack([r.reshape(4) for r in rows]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _notch_tables_on(a1, a2, per_thread, threads, lookback, sub, device):
    """:func:`_notch_tables` on `device`, cached: a repeated call uploads
    nothing."""
    return torch.from_numpy(_notch_tables(a1, a2, per_thread, threads,
                                          lookback, sub)).to(device)


# the tile status scratches of each (library, device), newest last; an older
# one is kept alive, since a captured CUDA graph may still launch on it
_notch_scratches: dict = {}


def _notch_status(lib, device, n_tiles: int) -> torch.Tensor:
    """The status scratch of `lib`'s scan on `device` for at least `n_tiles`
    tiles (its ``capacity``): allocated zeroed once, then reused, since
    each launch leaves it as it found it (the kernel resets its ticket and
    advances its generation)."""
    key = (lib._name, str(device))
    have = _notch_scratches.setdefault(key, [])
    if have and have[-1].capacity >= n_tiles:
        return have[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("notch_filter: call it once outside a CUDA graph "
                           "capture first, at the longest length")
    capacity = max(n_tiles, 2 * have[-1].capacity if have else 1024)
    status = torch.zeros(lib.notch_status_bytes(capacity), dtype=torch.uint8,
                         device=device)
    status.capacity = capacity
    have.append(status)
    return status


def _notch_reference(x: torch.Tensor, f0_norm, bw_norm) -> torch.Tensor:
    """K5b before its redesign (a chunk pass from zero state, a one-warp
    carry scan, the chunk pass again: three launches, x read twice): the
    reference of :func:`notch_filter` on the card, CUDA tensors only; on
    no path, not counted."""
    require(x, torch.complex64, x.device, "notch_filter: x")
    b1, a1, a2, g = notch_coefficients(f0_norm, bw_norm)
    lib = _notch_lib()
    chunk = lib.notch_chunk_len()
    n = x.shape[0]
    n_chunks = -(-n // chunk)
    powers = _notch_powers(float(a1), float(a2), chunk, x.device)
    scratch = torch.empty((2 * n_chunks, 4), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    err = lib.notch_filter_reference(
        x.data_ptr(), n, float(b1), float(a1), float(a2), float(g),
        powers.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "notch_filter_reference")
    return out


@functools.lru_cache(maxsize=16)
def _notch_powers(a1: float, a2: float, chunk: int, device) -> torch.Tensor:
    """[32, 4] float32 on `device` for :func:`_notch_reference`: A^(j+1)
    row major, j < 32, with A = M^chunk the state transition over one chunk
    of samples and M = [[a1, a2], [1, 0]]; computed in float64.  Cached, so
    a repeated call uploads nothing."""
    m = np.array([[a1, a2], [1.0, 0.0]])
    a = np.linalg.matrix_power(m, chunk)
    powers = np.stack([np.linalg.matrix_power(a, j + 1).reshape(4)
                       for j in range(32)]).astype(np.float32)
    return torch.from_numpy(powers).to(device)


def _notch_lib(extra: tuple[str, ...] = (), build_dir=None):
    """The notch library (with `extra` nvcc flags into `build_dir`: the
    probe builds of tools/probe_notch.py), its entry points typed."""
    lib = cuda_build.load("notch", extra, build_dir)
    if lib.notch_filter.argtypes is None:
        p, f, ll, i = (ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong,
                       ctypes.c_int)
        lib.notch_filter.argtypes = [p, ll, f, f, f, f, p, i, p, ll, p, p]
        lib.notch_filter_reference.argtypes = [p, ll, f, f, f, f, p, p, p, p]
        lib.notch_status_bytes.argtypes = [ll]
        lib.notch_status_bytes.restype = ll
        for fn in (lib.notch_filter, lib.notch_filter_reference):
            fn.restype = i
        for fn in (lib.notch_chunk_len, lib.notch_tile_threads,
                   lib.notch_per_thread, lib.notch_lookback):
            fn.argtypes = []
            fn.restype = i
    return lib


# ---- K5c: pulse blanking (CUDA) --------------------------------------------

def pulse_blanking(x: torch.Tensor, threshold_sigmas: float = 4.0,
                   window: int = 64) -> torch.Tensor:
    """K5c wrapper: zero out the whole `window`-sample windows whose mean
    power exceeds threshold_sigmas^2 x the stream's median window power
    (the reference Pulse_Blanking_Filter); the ragged tail is kept.  On the
    card: three launches of ``csrc/pulse_blank.cu`` (:func:`_blank_cuda`);
    calls on one device must not run on two streams at once (they share
    the histogram scratch of :func:`_blank_hist`)."""
    if x.dim() != 1:
        raise ValueError("pulse_blanking: x must be one-dimensional")
    if x.shape[0] // window == 0:
        return x.clone()
    if not check_kernel_device(x, "pulse_blanking"):
        return _blank_plain(x, threshold_sigmas, window)
    out, _, _ = _blank_cuda(x, threshold_sigmas, window)
    pulse_blanking.launches += 1
    return out


pulse_blanking.launches = 0


def _blank_check(x, window: int) -> None:
    require(x, torch.complex64, x.device, "pulse_blanking: x")
    if window & (window - 1) or 2 * x.shape[0] >= 2 ** 31:
        raise ValueError("pulse_blanking: the kernel needs a power-of-two "
                         "window and fewer than 2^30 samples")


def _blank_cuda(x: torch.Tensor, threshold_sigmas: float, window: int):
    """Launch K5c on the CUDA tensor x (at least one whole window) ->
    (out, the [n // window] window powers, the [1] threshold), all on the
    card; not counted."""
    _blank_check(x, window)
    lib = _blank_lib()
    n = x.shape[0]
    th = np.float32(threshold_sigmas)
    out = torch.empty_like(x)
    pw = torch.empty(n // window, dtype=torch.float32, device=x.device)
    thr = torch.empty(1, dtype=torch.float32, device=x.device)
    err = lib.pulse_blank(
        x.data_ptr(), n, window, float(th * th), out.data_ptr(),
        pw.data_ptr(), thr.data_ptr(), _blank_hist(lib, x.device).data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "pulse_blank")
    return out, pw, thr


# the top-digit histogram of each device, allocated zeroed once
_blank_hists: dict = {}


def _blank_hist(lib, device) -> torch.Tensor:
    """The global histogram K5c counts the window powers' top bits into:
    allocated zeroed once per device, then reused, since each call leaves
    it zeroed (the selection launch clears it as it reads it)."""
    key = str(device)
    if key not in _blank_hists:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pulse_blanking: call it once outside a CUDA "
                               "graph capture first")
        _blank_hists[key] = torch.zeros(lib.pulse_blank_bins(),
                                        dtype=torch.int32, device=device)
    return _blank_hists[key]


def _blank_lib():
    lib = cuda_build.load("pulse_blank")
    if lib.pulse_blank.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.pulse_blank.argtypes = [p, ll, i, ctypes.c_float, p, p, p, p, p]
        lib.pulse_blank.restype = i
        lib.pulse_blank_bins.argtypes = []
        lib.pulse_blank_bins.restype = i
    return lib


@functools.cache
def _kernels():
    """Define the Triton kernels of :func:`_blank_reference` (imported here,
    never at module import: the CPU machines that run the tests have no
    triton)."""
    import triton
    import triton.language as tl

    @triton.jit
    def window_power_kernel(x_ptr, pw_ptr, n_win, WINDOW2: tl.constexpr,
                            BW: tl.constexpr):
        # x as interleaved float32: a window of W samples is 2W floats, and
        # its mean power is the sum of their squares over W
        w = tl.program_id(0) * BW + tl.arange(0, BW)
        mask = w < n_win
        offs = w[:, None] * WINDOW2 + tl.arange(0, WINDOW2)[None, :]
        v = tl.load(x_ptr + offs, mask=mask[:, None], other=0.0)
        tl.store(pw_ptr + w, tl.sum(v * v, axis=1) / (WINDOW2 // 2),
                 mask=mask)

    @triton.jit
    def blank_kernel(x_ptr, pw_ptr, thr_ptr, out_ptr, n_full2, n2,
                     WINDOW2: tl.constexpr, BLOCK: tl.constexpr):
        # zero the floats of every whole window whose power exceeds the
        # threshold; the ragged tail past n_full2 is kept
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n2
        tail = offs >= n_full2
        v = tl.load(x_ptr + offs, mask=mask, other=0.0)
        pw = tl.load(pw_ptr + offs // WINDOW2, mask=mask & (offs < n_full2),
                     other=0.0)
        keep = (pw <= tl.load(thr_ptr)) | tail
        tl.store(out_ptr + offs, tl.where(keep, v, 0.0), mask=mask)

    return window_power_kernel, blank_kernel


def _blank_reference(x: torch.Tensor, threshold_sigmas: float = 4.0,
                     window: int = 64) -> torch.Tensor:
    """K5c before its redesign: the window powers (Triton), their median
    (a torch sort and four small torch operations), the blanking (Triton),
    x read twice.  The reference of :func:`pulse_blanking` on the card,
    CUDA tensors with at least one whole window only; on no path, not
    counted."""
    out, stages = _blank_reference_stages(x, threshold_sigmas, window)
    for stage in stages:
        stage()
    return out


def _blank_reference_stages(x, threshold_sigmas: float, window: int):
    """:func:`_blank_reference` as (out, its three stages: power,
    threshold, blank), callables run in that order to fill out;
    tools/probe_blanking.py times them apart."""
    _blank_check(x, window)
    import triton
    window_power_kernel, blank_kernel = _kernels()
    n = x.shape[0]
    n_win = n // window
    xf = torch.view_as_real(x)
    pw = torch.empty(n_win, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    thr = [None]
    bw, block = 16, 2048

    def power():
        window_power_kernel[(triton.cdiv(n_win, bw),)](
            xf, pw, n_win, WINDOW2=2 * window, BW=bw, num_warps=4)

    def threshold():
        thr[0] = _blank_threshold(pw, threshold_sigmas).reshape(1)

    def blank():
        blank_kernel[(triton.cdiv(2 * n, block),)](
            xf, pw, thr[0], torch.view_as_real(out), 2 * n_win * window,
            2 * n, WINDOW2=2 * window, BLOCK=block, num_warps=4)

    return out, (power, threshold, blank)
