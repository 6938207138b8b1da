"""Block-processing tracking, PyTorch port of
``gnss_sim_receiver_tpu.models.tracking_block`` (dll_pll: GPS L1 C/A, and
Galileo E1-B data with 5 taps).

One step per BLOCK of `e_block` epochs (~20 ms: 20 GPS epochs, 5 E1
epochs), with the loops closing at block cadence:

- the chunk is cut into a fixed grid of overlapping windows (length
  :func:`block_fft_size`, stride one code period) and FFT'd ONCE for all
  channels: ``torch.fft`` over an ``as_strided`` view of the padded chunk;
- the carrier wipeoff lives in the replica: each channel's band-limited
  code times its Doppler ramp exp(+j w n) is FFT'd per block ([C, F]);
- kernel K1 (:func:`block_correlate`, ``csrc/block_correlator.cu``)
  contracts window spectrum x replica spectrum x exact DTFT fractional-lag
  phasor x tap phasor over the F bins into the E/P/L correlations
  [C, E, K], building both phasors in registers — the [C, E, F] phasor and
  product tensors of the JAX program never reach device memory;
- the DLL closes on the taps next to the prompt, E - L, whatever the tap
  count: with the 5 VEML taps [VE, E, P, L, VL] of E1 the block closure
  reads taps 1 and 3, as the JAX block closure does (tracking_block.py
  :296-299,360-363; the per-epoch path closes the VEMLP discriminator);
- the loop closure per block is torch ops on [C] tensors in a Python loop
  over the blocks.

Epoch boundaries are closed-form within a block (the code NCO rate is
constant there): the cumulative sample count of epoch e is exactly
round(e*S - u0).  The kernel consumes and produces the same TrackState as
the per-epoch scan, so chunks can alternate between the two.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import check_kernel_device, require
from gnss_sim_receiver_tpu_torch.models.tracking import (
    F32, I32, TrackState, TrackingConf, code_rate_from_doppler, f32,
    pack_decim)
from gnss_sim_receiver_tpu_torch.ops import cuda_build, discriminators
from gnss_sim_receiver_tpu_torch.ops import loop_filters as lf

# window grid lead: windows start LEAD samples before their s0-grid point
# so small negative epoch-start excursions stay inside the window
_LEAD = 16


def good_size(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n (fast FFT sizes)."""
    best = 1 << int(np.ceil(np.log2(max(n, 1))))
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


def block_fft_size(conf: TrackingConf) -> int:
    """Shared-window FFT length: any epoch that STARTS inside window w's
    first period (plus the LEAD margin and rounding drift) must fit — one
    period for the start offset + one period of replica + tap margin."""
    s0 = conf.nominal_epoch_samples
    return good_size(2 * s0 + 2 * _LEAD + 32)


def code_spectra(conf: TrackingConf, code_tables: np.ndarray,
                 device) -> torch.Tensor:
    """fs-sampled band-limited replica over one code period, zero-padded to
    the window FFT length -> [C, F] float32 on `device` (time domain: each
    block applies its Doppler ramp and FFTs it).  `code_tables` are the
    band-limited tables [C, L*K] of TrackingEngine."""
    nfft = block_fft_size(conf)
    s0 = conf.nominal_epoch_samples
    tables = np.asarray(code_tables, np.float32)
    k = tables.shape[1] // conf.code_length_chips
    idx = (np.floor(np.arange(s0, dtype=np.float64)
                    * (conf.code_rate_cps / conf.fs) * k).astype(np.int64)
           % tables.shape[1])
    z = np.zeros((tables.shape[0], nfft), np.float32)
    z[:, :s0] = tables[:, idx]
    return torch.from_numpy(z).to(device)


def _window_spectra(x_chunk: torch.Tensor, s0: int, nfft: int):
    """Overlapping fixed-grid windows (start w*s0 - LEAD, length nfft) over
    the whole chunk, FFT'd in one batch -> [W, F] complex64."""
    lead = _LEAD
    n = x_chunk.shape[0] + lead
    w = max(1, (n - nfft) // s0 + 1)
    k = (nfft + s0 - 1) // s0
    pad_to = (w + k) * s0
    xp = torch.cat([
        torch.zeros(lead, dtype=x_chunk.dtype, device=x_chunk.device),
        x_chunk,
        torch.zeros(max(0, pad_to - n), dtype=x_chunk.dtype,
                    device=x_chunk.device)])[:pad_to]
    wins = xp.as_strided((w, nfft), (s0, 1))
    return torch.fft.fft(wins, dim=-1)


# ---- kernel K1 -------------------------------------------------------------

def _block_correlate_plain(xf_all, rf, w0, lag_int, lag_frac, ph_sc,
                           tap_samps, omega):
    """Plain version of K1, the JAX program's [C, E, F] form."""
    c, e = lag_int.shape
    nfft = xf_all.shape[1]
    n_wins = xf_all.shape[0]
    two_pi = f32(2.0 * np.pi)
    f_raw = torch.arange(nfft, dtype=F32, device=xf_all.device)
    f_bins = torch.where(f_raw >= nfft // 2, f_raw - nfft, f_raw)
    rows = torch.clamp(w0.long(), 0, max(n_wins - e, 0))[:, None] \
        + torch.arange(e, device=xf_all.device)[None, :]
    xf = xf_all[rows]                                          # [C, E, F]
    f_int = f_bins.to(I32)
    prod_mod = torch.remainder(f_int[None, None, :] * lag_int[..., None],
                               nfft).to(F32)
    ang_l = (two_pi * (prod_mod + f_bins[None, None, :] * lag_frac[..., None])
             / f32(nfft) - ph_sc[..., None])                  # [C, E, F]
    pl = torch.complex(torch.cos(ang_l), torch.sin(ang_l))
    ang_t = (two_pi * f_bins[None, None, :] * tap_samps[..., None]
             / f32(nfft) - (omega[:, None] * tap_samps)[..., None])
    pt = torch.complex(torch.cos(ang_t), torch.sin(ang_t))    # [C, K, F]
    z = xf * rf[:, None, :] * pl
    return torch.einsum("cef,ckf->cek", z, pt) / f32(nfft)


def block_correlate(xf_all: torch.Tensor, rf: torch.Tensor,
                    w0: torch.Tensor, lag_int: torch.Tensor,
                    lag_frac: torch.Tensor, ph_sc: torch.Tensor,
                    tap_samps: torch.Tensor,
                    omega: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: E/P/L correlations [C, E, K] complex64 of one block.

    corr[c,e,k] = 1/F sum_f xf_all[w0[c]+e, f] rf[c,f] e^{j ang_l[c,e,f]}
    e^{j ang_t[c,k,f]}, with ang_l = 2 pi ((f lag_int mod F) + f lag_frac)/F
    - ph_sc[c,e] (the int32 product reduced exactly) and ang_t = 2 pi f
    tap_samps[c,k]/F - omega[c] tap_samps[c,k]; f runs over the signed bins.
    Launches ``csrc/block_correlator.cu`` for CUDA tensors, runs the plain
    version for CPU tensors."""
    if not check_kernel_device(xf_all, "block_correlate"):
        return _block_correlate_plain(xf_all, rf, w0, lag_int, lag_frac,
                                      ph_sc, tap_samps, omega)
    dev = xf_all.device
    c, e = lag_int.shape
    k = tap_samps.shape[1]
    n_wins, nfft = xf_all.shape
    for name, t, dt in (("xf_all", xf_all, torch.complex64),
                        ("rf", rf, torch.complex64), ("w0", w0, I32),
                        ("lag_int", lag_int, I32), ("lag_frac", lag_frac, F32),
                        ("ph_sc", ph_sc, F32), ("tap_samps", tap_samps, F32),
                        ("omega", omega, F32)):
        require(t, dt, dev, f"block_correlate: {name}")
    if rf.shape != (c, nfft) or n_wins < e:
        raise ValueError("block_correlate: shape mismatch")
    out = torch.empty((c, e, k), dtype=torch.complex64, device=dev)
    err = _lib().block_correlate(
        xf_all.data_ptr(), rf.data_ptr(), w0.data_ptr(), lag_int.data_ptr(),
        lag_frac.data_ptr(), ph_sc.data_ptr(), tap_samps.data_ptr(),
        omega.data_ptr(), out.data_ptr(), c, e, k, n_wins, nfft,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "block_correlate")
    block_correlate.launches += 1
    return out


block_correlate.launches = 0


def _lib():
    lib = cuda_build.load("block_correlator")
    fn = lib.block_correlate
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


# ---- one block of the scan -------------------------------------------------

def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the mean of the two middle values for an
    even count (jnp.median's midpoint rule; torch.median takes the lower)."""
    v = torch.sort(x, dim=-1).values
    n = v.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def _block_body(conf: TrackingConf, e_block: int, codes_rep, taps, xf_all,
                st: TrackState):
    """Advance every channel by one block of e_block epochs."""
    fs = conf.fs
    dev = xf_all.device
    s0 = conf.nominal_epoch_samples
    nfft = block_fft_size(conf)
    n_wins = xf_all.shape[0]
    c_ch = codes_rep.shape[0]
    l_chips = f32(conf.code_length_chips)
    e_idx = torch.arange(e_block, dtype=F32, device=dev)          # [E]
    two_pi = f32(2.0 * np.pi)
    m_axis = torch.arange(nfft, dtype=F32, device=dev)[None, :]   # [1, F]
    fs32 = f32(fs)
    prompt_i = taps.shape[0] // 2

    act = st.active
    rate = st.code_freq                                        # [C] chips/s
    dop = st.carrier_doppler                                   # [C]
    s_per = l_chips / rate * fs32                              # [C] samples
    u0 = st.rem_code_phase / rate * fs32                       # [C] samples
    # closed-form epoch boundaries: cumulative samples of epoch e
    ecs = e_idx[None, :] * s_per[:, None] - u0[:, None]        # [C, E]
    n_cum = torch.round(ecs)
    n_next = torch.round((e_idx[None, :] + 1.0) * s_per[:, None]
                         - u0[:, None])
    n_len = n_next - n_cum
    # residual code phase at each epoch END (the per-epoch output convention)
    rem_end = (n_next - ((e_idx[None, :] + 1.0) * s_per[:, None]
                         - u0[:, None])) * rate[:, None] / fs32
    n_total = torch.round(f32(e_block) * s_per - u0)           # [C]
    rem_new = (n_total - (f32(e_block) * s_per - u0)) * rate / fs32

    # ---- replica spectra with the Doppler ramp (cuFFT) ----------------
    omega = two_pi * dop / fs32                                # rad/sample
    ramp = omega[:, None] * m_axis                             # [C, F]
    rep_t = torch.complex(codes_rep * torch.cos(ramp),
                          codes_rep * torch.sin(ramp))
    rf = torch.conj_physical(torch.fft.fft(rep_t, dim=-1))    # [C, F]

    # ---- window selection: epoch e of channel c reads window w0_c + e --
    w0 = torch.clamp(torch.div(st.pos, s0, rounding_mode="floor"), 0,
                     max(n_wins - e_block, 0)).to(I32)

    # ---- fractional replica lag within the window ---------------------
    d_int = (st.pos - w0 * s0).to(F32)                         # [C]
    lag = (d_int[:, None] + (ecs - e_idx[None, :] * f32(s0))
           + f32(_LEAD))                                       # [C, E]
    # half-stretch correction (code Doppler within one epoch)
    stretch = l_chips * dop / f32(conf.carrier_freq_hz)       # chips
    lag = lag - 0.5 * stretch[:, None] / rate[:, None] * fs32
    # a POSITIVE tap advances the replica: NEGATIVE lag
    tap_samps = (-taps[None, :] / rate[:, None] * fs32)        # [C, K]
    ph_sc = st.rem_carr_phase[:, None] + omega[:, None] * (
        ecs - 0.5 * stretch[:, None] / rate[:, None] * fs32)
    lag_int = torch.round(lag)
    lag_frac = lag - lag_int

    corr = block_correlate(xf_all, rf, w0, lag_int.to(I32).contiguous(),
                           lag_frac.contiguous(), ph_sc.contiguous(),
                           tap_samps.contiguous(), omega.contiguous())
    prompt = corr[:, :, prompt_i]                              # [C, E]
    early = corr[:, :, prompt_i - 1]
    late = corr[:, :, prompt_i + 1]
    epoch_g = st.epoch[:, None] + torch.arange(e_block, device=dev)[None, :]

    # ---- per-epoch discriminators, block-averaged closure -------------
    carr_err = discriminators.pll_costas(prompt) / two_pi       # [C, E]
    code_err = discriminators.dll_nc_e_minus_l_normalized(
        torch.abs(early), torch.abs(late), f32(conf.early_late_space_chips))
    carr_err_m = torch.mean(carr_err, dim=1)
    code_err_m = torch.mean(code_err, dim=1)
    t_blk = n_total / fs32                                      # [C]
    # two-stage loops: WIDE DLL for the first 50 blocks, then narrow;
    # ext_n doubles as the blocks-in-mode counter
    settle = st.ext_n < 50
    dll_bw_eff = torch.where(settle, float(np.float32(conf.dll_bw_hz)),
                             float(np.float32(conf.dll_bw_narrow_hz)))
    # the PLL stays at the NARROW bandwidth (BL*T stability at ~20 ms)
    pll_new, pll_out = lf.third_order_step(
        st.pll, carr_err_m, f32(conf.pll_bw_narrow_hz), t_blk)
    dll_new, dll_out = lf.second_order_step(
        st.dll, code_err_m, dll_bw_eff, t_blk)
    doppler_new = pll_out
    # FLL-assisted pull-in at block cadence: the MEDIAN of the block's
    # per-epoch-pair cross-dot errors (a nav-bit flip rails one pair)
    if conf.enable_fll_pullin:
        prev_prompts = torch.cat([st.prompt_prev[:, None], prompt[:, :-1]],
                                 dim=1)
        t_pair = n_len / fs32                                   # [C, E]
        # data chains whose symbols flip every epoch (E1-B) take the
        # two-quadrant decision-directed form
        fll_fn = (discriminators.fll_cross_dot_decision
                  if conf.fll_decision_directed
                  else discriminators.fll_cross_dot)
        f_err_m = _median(fll_fn(prev_prompts, prompt, t_pair))
        # engaged during pull-in AND whenever carrier lock is missing
        in_pullin = ((st.epoch < conf.fll_pullin_epochs)
                     | (st.carrier_lock < f32(conf.carrier_lock_threshold)))
        g_fll = torch.clamp(4.0 * f32(conf.fll_bw_hz) * t_blk,
                            max=float(np.float32(0.5)))
        g_eff = torch.where(st.epoch < conf.fll_pullin_epochs,
                            g_fll, 0.3 * g_fll)
        fll_nudge = torch.where(in_pullin, g_eff * f_err_m,
                                torch.zeros_like(f_err_m))
        doppler_new = doppler_new + fll_nudge
        pll_new = lf.LoopFilterState(vel=pll_new.vel + fll_nudge,
                                     acc=pll_new.acc)
    code_freq_new = code_rate_from_doppler(conf, doppler_new) + dll_out

    # ---- lock / C/N0 over the block (sign-insensitive per-prompt forms)
    pi_ = prompt.real
    pq_ = prompt.imag
    p2 = pi_ * pi_ + pq_ * pq_
    carrier_lock = torch.mean((pi_ * pi_ - pq_ * pq_)
                              / torch.clamp(p2, min=1e-12), dim=1)
    mean_abs_i = torch.mean(torch.abs(pi_), dim=1)
    total = torch.mean(p2, dim=1)
    sig = mean_abs_i * mean_abs_i
    noise = torch.clamp(total - sig, min=1e-12)
    t_sym = t_blk / f32(e_block)
    cn0_lin = torch.clamp(sig / noise, min=1e-6) / t_sym
    cn0_db = 10.0 * torch.log10(cn0_lin)
    in_transitory = st.epoch < conf.fll_pullin_epochs
    bad = (((carrier_lock < f32(conf.carrier_lock_threshold))
            | (cn0_db < f32(conf.cn0_min_db_hz))) & ~in_transitory)
    fail = torch.where(bad, st.lock_fail + 1.0,
                       torch.clamp(st.lock_fail - 1.0, min=0.0))
    lost = fail > f32(conf.max_lock_fail)

    # ---- bit-sync histogram (data channels) ----------------------------
    sign_e = torch.where(pi_ >= 0, 1.0, -1.0)
    prev = torch.cat([st.prev_sign[:, None], sign_e[:, :-1]], dim=1)
    tr = (prev != 0.0) & (sign_e != prev)                      # [C, E]
    phase_mod = torch.remainder(epoch_g, 20)
    hist_inc = torch.sum(
        tr.to(F32)[:, :, None]
        * (phase_mod[:, :, None]
           == torch.arange(20, device=dev)[None, None, :]).to(F32), dim=1)
    hist = st.bit_hist + hist_inc
    total = torch.sum(hist, dim=1)
    top = torch.argmax(hist, dim=1)
    peak = torch.amax(hist, dim=1)
    sync_ok = ((total >= f32(conf.bit_sync_min_transitions))
               & (peak >= 0.8 * total))
    newly_bit = sync_ok & ~st.bit_synced & act
    bit_synced = st.bit_synced | newly_bit
    bit_phase = torch.where(newly_bit, top.to(I32), st.bit_phase)

    # ---- carrier phase bookkeeping (Kahan over blocks, not re-associated)
    cyc_blk = dop * t_blk
    y_k = cyc_blk - st.acc_phase_comp
    t_sum = st.acc_phase_cycles + y_k
    comp = (t_sum - st.acc_phase_cycles) - y_k
    rem_carr_new = torch.remainder(st.rem_carr_phase + two_pi * dop * t_blk,
                                   two_pi)
    # per-epoch acc phase at epoch END (affine within the block)
    acc_e = ((st.acc_phase_cycles - st.acc_phase_comp)[:, None]
             + dop[:, None] * (n_next / fs32))                 # [C, E]

    def sel(new, old):
        return torch.where(act, new, old)

    pos_new = torch.where(act, st.pos + n_total.to(I32),
                          st.pos + e_block * s0)
    new_state = st._replace(
        active=act & ~lost,
        pos=pos_new,
        rem_code_phase=sel(rem_new, st.rem_code_phase),
        code_freq=sel(code_freq_new, st.code_freq),
        carrier_doppler=sel(doppler_new, st.carrier_doppler),
        rem_carr_phase=sel(rem_carr_new, st.rem_carr_phase),
        acc_phase_cycles=sel(t_sum, st.acc_phase_cycles),
        acc_phase_comp=sel(comp, st.acc_phase_comp),
        dll=lf.LoopFilterState(*map(sel, dll_new, st.dll)),
        pll=lf.LoopFilterState(*map(sel, pll_new, st.pll)),
        prompt_prev=sel(prompt[:, -1], st.prompt_prev),
        epoch=torch.where(act, st.epoch + e_block, st.epoch),
        cn0_db_hz=sel(cn0_db, st.cn0_db_hz),
        carrier_lock=sel(carrier_lock, st.carrier_lock),
        lock_fail=sel(fail, st.lock_fail),
        lock_lost=sel(lost, st.lock_lost),
        bit_hist=torch.where(act[:, None], hist, st.bit_hist),
        prev_sign=sel(sign_e[:, -1], st.prev_sign),
        bit_synced=sel(bit_synced, st.bit_synced),
        bit_phase=sel(bit_phase, st.bit_phase),
        ext_n=torch.where(act, torch.clamp(st.ext_n + 1, max=10000),
                          st.ext_n),
    )
    outs = {
        "prompt": prompt.T,                                    # [E, C]
        "early_mag": torch.abs(early).T,
        "late_mag": torch.abs(late).T,
        "carrier_doppler_hz": dop[None, :].expand(e_block, c_ch),
        "code_freq_cps": rate[None, :].expand(e_block, c_ch),
        "rem_code_phase_chips": rem_end.T,
        "acc_phase_cycles": acc_e.T,
        "code_phase_samples": (rem_end / rate[:, None] * fs32).T,
        "pos_start": (st.pos[:, None] + n_cum.to(I32)).T,
        "n_samples": n_len.to(I32).T,
        "cn0_db_hz": cn0_db[None, :].expand(e_block, c_ch),
        "valid": act[None, :].expand(e_block, c_ch),
    }
    return new_state, outs


def track_chunk_blocks(conf: TrackingConf, n_blocks: int, e_block: int,
                       codes_rep: torch.Tensor, taps: torch.Tensor,
                       x_chunk: torch.Tensor, state: TrackState):
    """Run n_blocks blocks of e_block epochs each.  Returns (new_state,
    outs) with the same per-epoch [T, C] output planes as track_chunk
    (T = n_blocks*e_block).  `codes_rep` is the [C, F] time-domain block
    replica of code_spectra()."""
    xf_all = _window_spectra(x_chunk, conf.nominal_epoch_samples,
                             block_fft_size(conf))
    outs = []
    for _ in range(n_blocks):
        state, o = _block_body(conf, e_block, codes_rep, taps, xf_all, state)
        outs.append(o)
    return state, {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def track_chunk_blocks_packed_decim(conf: TrackingConf, n_blocks: int,
                                    e_block: int, decim: int,
                                    codes_rep: torch.Tensor,
                                    taps: torch.Tensor,
                                    x_chunk: torch.Tensor,
                                    state: TrackState):
    """Block kernel + the same rate-split single-buffer transfer format as
    tracking.track_chunk_packed_decim."""
    new_state, outs = track_chunk_blocks(conf, n_blocks, e_block, codes_rep,
                                         taps, x_chunk, state)
    return new_state, pack_decim(outs, new_state, n_blocks * e_block, decim)
