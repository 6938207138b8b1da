"""Per-block .mat dump files, the reference's de-facto trace mechanism.

Equivalent of the reference dump paths (dll_pll_veml_tracking.cc:1475
save_matfile, pcps_acquisition.cc:393 dump_results, observables
save_matfile): MATLAB-compatible .mat files with the same variable names,
so the reference's MATLAB/Python analysis scripts (src/utils/matlab,
src/utils/python) plot these dumps unchanged.  Host-side NumPy and SciPy:
the port's copy of ``gnss_sim_receiver_tpu.models.dumps``.  The tracking
dump takes a receiver run's ``track_outputs`` (collect_track_outputs=True).
"""

from __future__ import annotations

import numpy as np
from scipy import io as sio


def dump_tracking_mat(path, outs: dict, channel: int, cn0_window: int = 20
                      ) -> None:
    """Tracking dump for one channel (variable names per
    dll_pll_veml_tracking.cc save_matfile)."""
    c = channel
    prompt = outs["prompt"][:, c]
    sio.savemat(str(path), {
        "abs_E": np.abs(outs["early_mag"][:, c]).astype(np.float32),
        "abs_P": np.abs(prompt).astype(np.float32),
        "abs_L": np.abs(outs["late_mag"][:, c]).astype(np.float32),
        "Prompt_I": prompt.real.astype(np.float32),
        "Prompt_Q": prompt.imag.astype(np.float32),
        "PRN_start_sample_count": outs["sample_counter"][:, c]
            .astype(np.uint64),
        "acc_carrier_phase_rad": (outs["acc_phase_cycles"][:, c]
                                  * 2.0 * np.pi).astype(np.float64),
        "carrier_doppler_hz": outs["carrier_doppler_hz"][:, c]
            .astype(np.float64),
        "code_freq_chips": outs["code_freq_cps"][:, c].astype(np.float64),
        "rem_code_phase_sample": outs["code_phase_samples"][:, c]
            .astype(np.float64),
        "CN0_SNV_dB_Hz": outs["cn0_db_hz"][:, c].astype(np.float64),
    }, do_compression=True)


def dump_acquisition_mat(path, grid, doppler_max, doppler_step,
                         test_stat, threshold, delay_samples, doppler_hz,
                         prn, n_dwells) -> None:
    """Acquisition grid dump (variable names per pcps_acquisition.cc
    dump_results)."""
    sio.savemat(str(path), {
        "acq_grid": np.asarray(grid, np.float32),
        "doppler_max": np.float32(doppler_max),
        "doppler_step": np.float32(doppler_step),
        "test_statistic": np.float32(test_stat),
        "threshold": np.float32(threshold),
        "acq_delay_samples": np.float32(delay_samples),
        "acq_doppler_hz": np.float32(doppler_hz),
        "PRN": np.int32(prn),
        "num_dwells": np.int32(n_dwells),
    }, do_compression=True)


def dump_observables_mat(path, epochs, n_channels: int) -> None:
    """Observables dump (hybrid_observables_gs.cc save_matfile layout:
    [C, T] arrays)."""
    t = len(epochs)
    rx_time = np.zeros((n_channels, t))
    tow = np.zeros((n_channels, t))
    pr = np.zeros((n_channels, t))
    dop = np.zeros((n_channels, t))
    ph = np.zeros((n_channels, t))
    valid = np.zeros((n_channels, t))
    for i, ep in enumerate(epochs):
        rx_time[:, i] = ep.rx_time_s
        tow[:, i] = ep.interp_tow_ms
        pr[:, i] = ep.pseudorange_m
        dop[:, i] = ep.carrier_doppler_hz
        ph[:, i] = ep.carrier_phase_cycles * 2.0 * np.pi
        valid[:, i] = ep.valid
    sio.savemat(str(path), {
        "RX_time": rx_time,
        "TOW_at_current_symbol_s": tow / 1e3,
        "Pseudorange_m": pr,
        "Carrier_Doppler_hz": dop,
        "Acc_carrier_phase_hz": ph,
        "valid_pseudoranges": valid,
    }, do_compression=True)


def load_mat(path) -> dict:
    return sio.loadmat(str(path))
