"""Hybrid GNSS + pseudolite navigation (the fork's headline feature),
PyTorch port's copy of ``gnss_sim_receiver_tpu.models.hybrid``: host-side
float64 NumPy, no kernel.

The host-side equivalent of the pseudolite ("pseudo satellite") machinery
the reference fork adds to rtklib_pvt_gs (rtklib_pvt_gs.cc:2334-2425 AOWR
estimation, :2770-2780 clock-difference output) and hybrid_observables_gs
(:550-556 pseudolite pseudorange exception, in the port's
models/observables.py):

- A designated channel tracks a ground/pseudolite transmitter whose clock
  is NOT GNSS-synchronized.  Its "pseudorange" rho_ps = (T_rx - TOW_ps)*c
  measures range + (rx clock - ps clock)*c, i.e. a one-way-ranging (AOWR)
  time-transfer observable, not a navigation observable.
- `AowrTimeTransfer` robustly averages dt = rho_ps/c with the reference's
  integer/fraction split (to avoid accumulation round-off), carrier-phase
  aiding (dt_by_cp = smoothed code offset + instantaneous carrier phase),
  deviation gating at 3 m, and jump acceptance after `dev_count_thresh`
  consistent epochs of a new value.
- After a GNSS fix, the receiver emits
    clock_diff_s = -dt_by_cp + rx_clock_offset_s      (GNSS rx vs ps clock)
    est_tx_tow   = rx_time - dt_by_cp                 (ps transmit time)
  the "dt_GNSSR-AOWR" time-transfer products used for cislunar one-way
  ranging experiments.
- `RingFileWriter` reproduces the mmap ring-file CSV records the reference
  uses to share rx clock bias / clock difference with the co-hosted
  simulator (write_rx_clock_bias / write_clock_difference,
  rtklib_pvt_gs.cc:2070-2165).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants

C = constants.SPEED_OF_LIGHT_M_S


@dataclasses.dataclass
class AowrConf:
    r_ps_true_m: float = 0.4          # known receiver<->pseudolite range
    carrier_freq_hz: float = constants.GPS_L1_FREQ_HZ
    dev_thresh_s: float = 3.0 / C     # 3 m deviation gate
    dev_count_thresh: int = 100       # epochs to accept a dt jump


class AowrTimeTransfer:
    """One-way-ranging time-transfer estimator for the pseudolite channel
    (reference semantics of rtklib_pvt_gs.cc:2334-2425)."""

    def __init__(self, conf: AowrConf = AowrConf()):
        self.conf = conf
        self.dt_int_s: int | None = None
        self._frac_total = 0.0
        self._count = 0
        self._dt0_frac_sum = 0.0
        self.dt_s = 0.0               # averaged code one-way delay
        self.dt0_s = 0.0              # carrier-referenced offset average
        self.dt_by_cp_s = 0.0         # dt0 + instantaneous carrier phase
        self._cp_dev_thresh = 3.0 / C
        self._diff_total = 0.0
        # jump detection
        self._dev_count = 0
        self._new_frac_total = 0.0
        self._new_count = 0
        self._new_diff_total = 0.0
        self.observed = False

    def update(self, pseudorange_m: float,
               carrier_phase_cycles: float) -> None:
        """Feed one pseudolite observable epoch."""
        cf = self.conf
        dt_current = pseudorange_m / C
        if self.dt_int_s is None:
            self.dt_int_s = int(round(dt_current))
        ci = carrier_phase_cycles / cf.carrier_freq_hz
        dt0_current = dt_current - cf.r_ps_true_m / C - ci

        deviated = (self.dt_s != 0.0
                    and (abs(dt_current - self.dt_s) > cf.dev_thresh_s
                         or abs(dt0_current - self.dt0_s) > cf.dev_thresh_s
                         or abs(self.dt0_s + ci - self.dt_by_cp_s)
                         > self._cp_dev_thresh))
        if deviated:
            # candidate new dt (observation jumped, e.g. ps clock step)
            self._dev_count += 1
            self._new_frac_total += dt_current - self.dt_int_s
            dt_new = self.dt_int_s + self._new_frac_total / self._dev_count
            diff_new = abs(dt_current - dt_new)
            self._new_diff_total += diff_new
            if dt_new != 0.0 and diff_new < cf.dev_thresh_s:
                self._new_count += 1
            else:
                self._new_count = 0
        else:
            self._dev_count = 0
            self._frac_total += dt_current - self.dt_int_s
            self._count += 1
            self.dt_s = self.dt_int_s + self._frac_total / self._count
            self._dt0_frac_sum += dt0_current - self.dt_int_s
            self.dt0_s = self.dt_int_s + self._dt0_frac_sum / self._count
            if self.dt_by_cp_s != 0.0:
                self._diff_total += abs(self.dt0_s + ci - self.dt_by_cp_s)
                self._cp_dev_thresh = 3.0 * self._diff_total / self._count
            self.dt_by_cp_s = self.dt0_s + ci

        if self._dev_count >= cf.dev_count_thresh:
            if self._new_count >= cf.dev_count_thresh:
                # the new dt is stable: adopt it (reference reset logic)
                self._frac_total = self._new_frac_total
                self._count = self._new_count
                self.dt_s = self.dt_int_s + self._frac_total / self._count
                self._new_count = 0
                self._diff_total = self._new_diff_total
                self._new_diff_total = 0.0
                self._cp_dev_thresh = 3.0 / C
            self._dev_count = 0
        self.observed = True

    def clock_products(self, rx_clock_offset_s: float, rx_time_s: float
                       ) -> tuple[float, float]:
        """(clock_diff_s, est_tx_tow_s) after a GNSS fix — the quantities
        the reference writes via write_clock_difference
        (rtklib_pvt_gs.cc:2770-2780)."""
        clock_diff_s = -self.dt_by_cp_s + rx_clock_offset_s
        est_tx_tow_s = rx_time_s - self.dt_by_cp_s
        return clock_diff_s, est_tx_tow_s


class RingFileWriter:
    """Fixed-record ring file of CSV lines — the role of the reference's
    mmap clock-sharing files (rtklib_pvt_gs.cc write_rx_clock_bias /
    write_clock_difference): each line has a fixed byte length so an
    external reader can poll by offset."""

    def __init__(self, path, line_len: int, n_lines: int = 256):
        self.path = path
        self.line_len = line_len
        self.length = line_len * n_lines
        self.offset = 0
        with open(path, "wb") as fh:
            fh.write(b" " * self.length)
        self._fh = open(path, "r+b")

    def write_line(self, text: str) -> None:
        data = text.encode()
        if len(data) != self.line_len:
            raise ValueError(f"record must be {self.line_len} bytes, "
                             f"got {len(data)}")
        self._fh.seek(self.offset)
        self._fh.write(data)
        self._fh.flush()
        self.offset = (self.offset + self.line_len) % self.length

    def close(self) -> None:
        self._fh.close()


def format_rx_clock_bias_line(rx_time_s: float, tag_tow_s: float,
                              rx_clock_bias_s: float, prn: int) -> str:
    """'rx_time,tag_tow,bias,prn\\n' with the reference's fixed widths
    (9 + 17 + 17 + 2 chars, rtklib_pvt_gs.cc:2070-2126)."""
    rx = f"{rx_time_s:.2f}"
    rx = "0" * max(0, 9 - len(rx)) + rx
    tow = f"{tag_tow_s:.15g}"[:17].ljust(17)
    bias = f"{rx_clock_bias_s:.15g}"[:17].ljust(17)
    return f"{rx},{tow},{bias},{prn:02d}\n"


def format_clock_difference_line(tag_tow_s: float,
                                 clock_diff_s: float) -> str:
    """'tag_tow,clock_diff\\n' with 16-char fields
    (rtklib_pvt_gs.cc:2127-2165)."""
    tow = f"{tag_tow_s:16.9f}"[:16]
    diff = f"{clock_diff_s:16.12f}"[:16]
    return f"{tow},{diff}\n"
