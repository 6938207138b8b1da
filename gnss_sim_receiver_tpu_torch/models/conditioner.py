"""Signal conditioner: DataTypeAdapter -> InputFilter -> Resampler.

PyTorch port of ``gnss_sim_receiver_tpu.models.conditioner``, the reference
SignalConditioner composite
(src/algorithms/conditioner/adapters/signal_conditioner.cc), driven by the
same Role.implementation config strings, so reference conf files select the
same chains:

  DataTypeAdapter.implementation: Ibyte_To_Complex / Ishort_To_Complex /
      Byte_To_Short / Pass_Through ... (byte/short IQ -> complex64, done
      during sample IO on the host)
  InputFilter.implementation: Fir_Filter / Freq_Xlating_Fir_Filter /
      Notch_Filter / Notch_Filter_Lite / Pulse_Blanking_Filter /
      Beamformer_Filter / Pass_Through
  Resampler.implementation: Direct_Resampler / Mmse_Resampler /
      Pass_Through

`process` uploads a host capture once and returns a complex64 tensor on the
device, which ``Receiver.process_array`` takes as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import resolve_device, upload
from gnss_sim_receiver_tpu_torch.ops import filters, resampler
from gnss_sim_receiver_tpu_torch.utils.config import Configuration


class SignalConditioner:
    """Config-driven conditioning chain operating on complex64 streams.
    `device=None` means the CUDA card and raises without one; pass
    device="cpu" for the plain versions of the kernels."""

    def __init__(self, config: Configuration, fs_in: float, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.fs_in = fs_in
        self.fs_out = fs_in

        self.filter_impl = config.property("InputFilter.implementation",
                                           "Pass_Through")
        self.resampler_impl = config.property("Resampler.implementation",
                                              "Pass_Through")
        self._taps = None
        self._decim = 1
        self._xlate_freq = 0.0
        if self.filter_impl in ("Fir_Filter", "Freq_Xlating_Fir_Filter"):
            n_taps = config.property("InputFilter.number_of_taps", 5)
            # reference configs specify band edges; we design a lowpass at
            # the configured normalized cutoff (default 0.45)
            cutoff = config.property("InputFilter.cutoff", 0.45)
            self._taps = upload(filters.design_lowpass(
                max(n_taps, 5), min(max(cutoff, 0.01), 0.99)), self.device)
            self._decim = config.property("InputFilter.decimation_factor", 1)
            self._xlate_freq = config.property("InputFilter.IF", 0.0)
            self.fs_out = self.fs_in / self._decim
        if self.filter_impl == "Beamformer_Filter":
            # reference beamformer.cc: weighted sum over array elements
            # (GNSS_SDR_BEAMFORMER_CHANNELS inputs -> 1 output); weights
            # from InputFilter.weight_<k>_real/imag, default (1,0) as the
            # reference's constructor initializes them
            n_el = int(config.property("InputFilter.number_of_channels", 8))
            w = np.empty(n_el, np.complex64)
            for k in range(n_el):
                w[k] = complex(
                    float(config.property(f"InputFilter.weight_{k}_real",
                                          1.0)),
                    float(config.property(f"InputFilter.weight_{k}_imag",
                                          0.0)))
            self._beam_weights = upload(w, self.device)
        if self.resampler_impl in ("Direct_Resampler", "Mmse_Resampler"):
            self._res_fs_out = config.property("Resampler.sample_freq_out",
                                               self.fs_out)
            self._res_ratio = self.fs_out / self._res_fs_out
            self.fs_out = self._res_fs_out

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.complex64)
        return upload(np.asarray(x, dtype=np.complex64), self.device)

    def process(self, x) -> torch.Tensor:
        """Condition a capture (NumPy array or tensor); the result is a
        complex64 tensor on the conditioner's device."""
        impl = self.filter_impl
        y = self._to_device(x)
        if impl == "Beamformer_Filter":
            # [n_elements, N] multichannel capture -> beamformed [N]
            if y.dim() != 2:
                raise ValueError(
                    "Beamformer_Filter needs an [n_elements, N] array")
            y = torch.einsum("e,en->n", self._beam_weights[: y.shape[0]], y)
            impl = "Pass_Through"
        if impl == "Fir_Filter":
            y = filters.fir_filter(y, self._taps, self._decim)
        elif impl == "Freq_Xlating_Fir_Filter":
            y = filters.freq_xlating_fir_filter(
                y, self._taps, self._xlate_freq, self.fs_in, self._decim)
        elif impl in ("Notch_Filter", "Notch_Filter_Lite"):
            f0 = self.config.property("InputFilter.f0_norm", 0.25)
            bw = self.config.property("InputFilter.bw_norm", 0.01)
            y = filters.notch_filter(y, f0, bw)
        elif impl == "Pulse_Blanking_Filter":
            th = self.config.property("InputFilter.pfa_sigmas", 4.0)
            y = filters.pulse_blanking(y, th)
        elif impl != "Pass_Through":
            raise ValueError(f"unknown InputFilter {impl}")
        if self.resampler_impl == "Direct_Resampler":
            n_out = resampler.output_length(
                y.shape[0], 1.0, 1.0 / self._res_ratio)
            y = resampler.direct_resampler(y, self._res_ratio, n_out)
        elif self.resampler_impl == "Mmse_Resampler":
            n_out = resampler.output_length(
                y.shape[0], 1.0, 1.0 / self._res_ratio)
            y = resampler.linear_resampler(y, self._res_ratio, n_out)
        elif self.resampler_impl != "Pass_Through":
            raise ValueError(f"unknown Resampler {self.resampler_impl}")
        return y
