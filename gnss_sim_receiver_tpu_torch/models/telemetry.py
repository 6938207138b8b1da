"""GPS L1 C/A telemetry decoding engine (host-side).

Equivalent of the reference gps_l1_ca_telemetry_decoder_gs
(src/algorithms/telemetry_decoder/gnuradio_blocks/
gps_l1_ca_telemetry_decoder_gs.cc): consumes the tracking engine's
per-epoch prompt outputs (device-produced, 1 kHz per channel), performs
bit synchronization, 50 bps bit decisions, LNAV subframe sync/parity
(nav.lnav), ephemeris assembly, and stamps every epoch with
TOW_at_current_symbol_ms.  Bit-level work is 50 bps x channels — host work
by design (SURVEY.md section 7: "decode host-side from device-produced
prompt-symbol batches").

GPS LNAV, Galileo E1-B I/NAV, GPS L2C and L5 CNAV, Galileo E5a F/NAV,
Galileo E5b I/NAV, GLONASS GNAV, Galileo E6-B C/NAV (HAS, with the
cross-band Galileo TOW map), BeiDou D1/D2 and SBAS L1 decoders copied
from ``gnss_sim_receiver_tpu.models.telemetry`` for the PyTorch port."""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch import constants, signals
from gnss_sim_receiver_tpu_torch.nav import lnav
from gnss_sim_receiver_tpu_torch.nav.cnav import (CnavDecoder,
                                                  messages_to_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.cnav_e6 import CnavPageDecoder
from gnss_sim_receiver_tpu_torch.nav.dnav import (
    D2SubframeDecoder, DnavSubframeDecoder, d2_pages_to_beidou_ephemeris,
    is_geo_prn, subframes_to_beidou_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.ephemeris import (
    GpsEphemeris, fields_to_ephemeris, words_to_galileo_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.fnav import (FnavPageDecoder,
                                                  fnav_words_to_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.gnav import (
    GnavStringDecoder, strings_to_glonass_ephemeris)
from gnss_sim_receiver_tpu_torch.nav.has import HasMessageAssembler
from gnss_sim_receiver_tpu_torch.nav.inav import InavPageDecoder
from gnss_sim_receiver_tpu_torch.nav.sbas import (SbasMessageDecoder,
                                                  parse_mt12)
from gnss_sim_receiver_tpu_torch.ops.prn_codes_multi import BEIDOU_NH20

CODES_PER_BIT = 20
E1B_EPOCH_MS = 4.0   # one 250-sps INAV symbol per 4 ms E1B code epoch


def _collect_column(st, prompts_col, valid_col) -> tuple:
    """Vectorized per-epoch collection for one channel: returns (pi, base,
    v) — the valid epochs' prompt-I values in order (float64), the batch's
    global base epoch index, and the validity mask — while advancing
    st.epoch_count and latching st.symbol_base on the first valid epoch.
    Replaces the per-epoch Python loop (1 kHz x channels) with batched
    NumPy."""
    v = np.asarray(valid_col, bool)
    base = st.epoch_count
    st.epoch_count = base + len(v)
    if not v.any():
        return np.empty(0, np.float64), base, v
    if st.symbol_base < 0:
        st.symbol_base = base + int(np.argmax(v))
    pi = np.real(np.asarray(prompts_col))[v].astype(np.float64)
    return pi, base, v


def _stamp_tow_column(tow_col, v, base, st, epoch_ms: float,
                      after_anchor: bool, anchor0=None) -> None:
    """Vectorized TOW stamping: tow_col[e] = anchor + (idx+1-anchor_epoch)
    * epoch_ms for valid epochs.

    after_anchor=True gates on `anchor0` — the anchor the channel had
    BEFORE this batch's decodes.  Gating on the current (post-decode)
    anchor would un-stamp every epoch before the LATEST in-batch
    word/subframe: on a 30 s adaptive chunk that silently dropped all
    but the last few seconds of observables.  TOW is linear in the
    epoch index, so the whole batch extrapolates exactly from the
    newest anchor; only a channel's FIRST-ever anchor limits the gate
    (no TOW claim before the first decoded timestamp)."""
    if st.anchor_epoch is None:
        return
    idx = base + np.arange(len(v))
    gate = anchor0 if anchor0 is not None else st.anchor_epoch
    m = v if not after_anchor else (v & (idx >= gate))
    tow_col[m] = (st.anchor_tow_ms
                  + (idx[m] + 1 - st.anchor_epoch) * epoch_ms)


@dataclasses.dataclass
class _ChannelTlmState:
    prompts_i: list = dataclasses.field(default_factory=list)
    epoch_count: int = 0
    n_seen: int = 0                # valid epochs since channel (re)start
    prompt_base: int = -1          # global epoch index of prompts_i[0]
    bit_phase: int | None = None        # epoch index mod 20 of bit starts
    transition_hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(CODES_PER_BIT, np.int64))
    last_sign: float = 0.0
    n_bits_emitted: int = 0
    frame: lnav.LnavFrameDecoder = dataclasses.field(
        default_factory=lnav.LnavFrameDecoder)
    # TOW anchor: epoch index of a subframe's first epoch + its TOW (ms)
    anchor_epoch: int | None = None
    anchor_tow_ms: float = 0.0
    # PLL locked 180 deg off (inverted preamble) — half-cycle phase flag
    polarity_inverted: bool = False
    # ephemeris assembly
    sf_fields: dict = dataclasses.field(default_factory=dict)
    ephemeris: GpsEphemeris | None = None


@dataclasses.dataclass
class TelemetryOutputs:
    tow_at_epoch_ms: np.ndarray      # [T, C] float64, nan if unknown
    tow_valid: np.ndarray            # [T, C] bool
    new_ephemerides: list            # [(channel, GpsEphemeris), ...]
    # [C] half-cycle carrier-phase correction (0.0 or 0.5 cycles): 0.5 when
    # the channel's PLL is known (from frame sync) to be locked 180 deg off
    # — the reference's Flag_PLL_180_deg_phase_locked + GPS_PI correction
    # (gps_l1_ca_telemetry_decoder_gs.cc).  None = no correction known.
    phase_half_cycles: np.ndarray | None = None


class TelemetryDecoder:
    def __init__(self, prns):
        self.prns = [int(p) for p in prns]
        self.ch = [_ChannelTlmState() for _ in self.prns]
        # assistance data from subframes 4/5 (gps_navigation_message.cc
        # almanac / iono / UTC decode, :494+): prn -> almanac field dict,
        # plus the broadcast iono/UTC parameter set
        self.almanac: dict[int, dict] = {}
        self.iono_utc: dict | None = None

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        """Restart a channel's bit/frame sync after satellite reassignment."""
        st = _ChannelTlmState()
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        """Consume tracking outputs ([T, C] arrays from
        TrackingEngine.process) and extend each channel's bit stream."""
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            base = st.epoch_count
            v = np.asarray(valid[:, c], bool)
            vi = np.flatnonzero(v)
            st.epoch_count = base + t_len
            if vi.size:
                pi = np.real(np.asarray(prompts[:, c]))[vi].astype(
                    np.float64)
                s = np.where(pi >= 0.0, 1.0, -1.0)
                prev = np.concatenate(([st.last_sign], s[:-1]))
                tr = (prev != 0.0) & (s != prev)
                np.add.at(st.transition_hist,
                          (base + vi[tr]) % CODES_PER_BIT, 1)
                st.last_sign = float(s[-1])
                if not st.prompts_i:
                    st.prompt_base = base + int(vi[0])
                st.prompts_i.extend(pi.tolist())
                st.n_seen += int(vi.size)
            if st.bit_phase is None and st.n_seen >= 200:
                self._try_bit_sync(st)
            # TOW gating anchor BEFORE this batch's decodes: _emit_bits
            # advances anchor_epoch to the LATEST in-batch subframe, and
            # gating on that would un-stamp every epoch before it — on a
            # 30 s adaptive chunk that silently dropped all but the last
            # ~6 s of observables (the r4 batch-vs-streaming fix-count
            # divergence).  TOW is linear in epoch, so once ANY anchor
            # exists the whole batch extrapolates from the latest one;
            # only a channel's FIRST-ever anchor limits the gate.
            anchor0 = st.anchor_epoch
            if st.bit_phase is not None:
                self._emit_bits(st, c, new_eph)
            if st.anchor_epoch is not None:
                gate = anchor0 if anchor0 is not None else st.anchor_epoch
                idx = base + np.arange(t_len)
                m = v & (idx >= gate)
                tow[m, c] = (st.anchor_tow_ms
                             + (idx[m] + 1 - st.anchor_epoch) * 1.0)
        half = np.array([0.5 if st.polarity_inverted else 0.0
                         for st in self.ch])
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph,
                                phase_half_cycles=half)

    # -- internals ----------------------------------------------------------
    def _try_bit_sync(self, st: _ChannelTlmState) -> None:
        """Bit edge = dominant transition phase (the histogram equivalent of
        the reference's 20-symbol sign-pattern sync,
        dll_pll_veml_tracking.cc:1852-1867)."""
        h = st.transition_hist
        total = h.sum()
        if total < 8:
            return
        top = int(h.argmax())
        if h[top] < 0.8 * total:
            return
        st.bit_phase = top  # bits start at epochs where idx % 20 == top

    def _emit_bits(self, st: _ChannelTlmState, c: int, new_eph: list) -> None:
        # local list index of the first bit boundary: prompts_i[i] belongs
        # to global epoch prompt_base + i (valid epochs are contiguous
        # while a channel holds lock)
        phase = (st.bit_phase - st.prompt_base) % CODES_PER_BIT
        nbits_avail = (len(st.prompts_i) - phase) // CODES_PER_BIT
        if nbits_avail <= st.n_bits_emitted:
            return
        seg = np.asarray(st.prompts_i[phase + st.n_bits_emitted
                                      * CODES_PER_BIT:
                                      phase + nbits_avail * CODES_PER_BIT])
        acc = seg.reshape(-1, CODES_PER_BIT).sum(axis=1)
        bits = (acc >= 0).astype(np.int64).tolist()
        st.n_bits_emitted = nbits_avail
        for ev in st.frame.push_bits(bits):
            sf_start_epoch = (st.prompt_base + phase
                              + ev.bit_index * CODES_PER_BIT)
            tow_sf_start_s = ev.tow_next_s - lnav.SUBFRAME_SECONDS
            st.anchor_epoch = sf_start_epoch
            st.anchor_tow_ms = tow_sf_start_s * 1000.0
            st.polarity_inverted = bool(ev.inverted)
            if ev.sf_id in (4, 5) and ev.fields:
                sv = int(ev.fields.get("sv_id", 0))
                if sv == lnav.IONO_SV_ID:
                    self.iono_utc = dict(ev.fields)
                elif 1 <= sv <= 32:
                    self.almanac[sv] = dict(ev.fields)
            if ev.sf_id in (1, 2, 3):
                st.sf_fields[ev.sf_id] = ev.fields
                if all(k in st.sf_fields for k in (1, 2, 3)):
                    f1, f2, f3 = (st.sf_fields[1], st.sf_fields[2],
                                  st.sf_fields[3])
                    if int(f2["iode"]) == int(f3["iode_sf3"]) and \
                       int(f1["iodc"]) % 256 == int(f2["iode"]):
                        eph = fields_to_ephemeris(self.prns[c], f1, f2, f3)
                        if (st.ephemeris is None
                                or st.ephemeris.iode != eph.iode
                                or st.ephemeris.toe != eph.toe):
                            st.ephemeris = eph
                            new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# Galileo E1B INAV telemetry (the reference's unified
# galileo_telemetry_decoder_gs with frame_type=1, host-side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _GalChannelTlmState:
    epoch_count: int = 0
    symbol_base: int = -1       # global epoch index of the first symbol fed
    decoder: object = None      # nav.inav.InavPageDecoder
    words: dict = dataclasses.field(default_factory=dict)  # wt -> fields
    words_iod: dict = dataclasses.field(default_factory=dict)
    anchor_epoch: int | None = None
    anchor_tow_ms: float = 0.0
    ephemeris: object = None
    iono: dict | None = None


class GalileoE1bTelemetryDecoder:
    """Consumes TrackingEngine outputs for E1B channels (4 ms epochs = one
    250-sps INAV symbol each) and produces TOW stamps + Galileo ephemerides.

    Same process() interface as TelemetryDecoder; page/word logic lives in
    nav.inav (galileo_telemetry_decoder_gs.cc / galileo_inav_message.cc
    equivalents).  TOW anchoring follows the reference's
    TOW_at_Preamble = TOW_5 semantics (galileo_telemetry_decoder_gs.cc:1109):
    word 5's page-start symbol is transmitted at GST TOW_5."""

    def __init__(self, prns):
        self._mk = InavPageDecoder
        self.prns = [int(p) for p in prns]
        self.ch = [_GalChannelTlmState(decoder=InavPageDecoder())
                   for _ in self.prns]

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _GalChannelTlmState(decoder=self._mk())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            anchor0 = st.anchor_epoch
            for ev in st.decoder.push_symbols(pi.tolist()):
                if not ev.crc_ok:
                    continue
                self._handle_word(st, c, ev, new_eph,
                                  words_to_galileo_ephemeris)
            _stamp_tow_column(tow[:, c], v, base, st, E1B_EPOCH_MS,
                              after_anchor=True, anchor0=anchor0)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _handle_word(self, st, c, ev, new_eph, to_eph) -> None:
        wt = ev.word_type
        if wt in (1, 2, 3, 4):
            st.words[wt] = ev.fields
            st.words_iod[wt] = int(ev.fields["iod_nav"])
        elif wt == 5:
            st.words[5] = ev.fields
            # TOW anchor: page start symbol was transmitted at TOW_5
            st.anchor_epoch = st.symbol_base + ev.page_start_symbol
            st.anchor_tow_ms = ev.fields["tow"] * 1000.0
            st.iono = {k: ev.fields.get(k, 0.0)
                       for k in ("ai0", "ai1", "ai2")}
        if all(k in st.words for k in (1, 2, 3, 4)):
            iods = {st.words_iod[k] for k in (1, 2, 3, 4)}
            if len(iods) == 1:
                eph = to_eph(self.prns[c], st.words)
                if (st.ephemeris is None
                        or st.ephemeris.iod_nav != eph.iod_nav
                        or st.ephemeris.toe != eph.toe):
                    st.ephemeris = eph
                    new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# GPS L5I CNAV telemetry (the reference's gps_l5_telemetry_decoder_gs on top
# of libswiftcnav, here nav.cnav)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CnavChannelTlmState:
    epoch_count: int = 0
    symbol_base: int = -1        # global epoch index of decoder symbol 0
    decoder: object = None       # CnavDecoder or FnavPageDecoder
    msgs: dict = dataclasses.field(default_factory=dict)
    anchor_epoch: int | None = None
    anchor_tow_ms: float = 0.0
    ephemeris: object = None
    # secondary-code (NH10 / CS20) synchronization
    nh_buf: list = dataclasses.field(default_factory=list)
    nh_off: int | None = None    # epoch index mod len(code) of symbol starts
    pend: list = dataclasses.field(default_factory=list)


def _fold_secondary(st: _CnavChannelTlmState, pattern: np.ndarray,
                    margin: float = 1.2, min_symbols: int = 20) -> list:
    """Shared secondary-code / symbol-boundary synchronizer: consume
    st.pend per-epoch prompts and emit soft symbols spanning len(pattern)
    epochs each, wiped by `pattern` (+-1).  The phase offset is found by
    group-coherence voting — the winning cyclic offset maximizes
    sum |group-coherent sum| and must beat the runner-up by `margin` — and
    st.symbol_base shifts accordingly."""
    n_cs = len(pattern)
    if st.nh_off is None:
        st.nh_buf.extend(st.pend)
        st.pend = []
        if len(st.nh_buf) < min_symbols * n_cs:
            return []
        s = np.sign(np.asarray(st.nh_buf, np.float64))
        n = (len(s) // n_cs) * n_cs
        best, best_score, second = 0, -1.0, -1.0
        for off in range(n_cs):
            w = s[off:off + n - n_cs].reshape(-1, n_cs) * pattern
            score = float(np.abs(w.sum(axis=1)).sum())
            if score > best_score:
                best, best_score, second = off, score, best_score
            elif score > second:
                second = score
        if best_score < margin * max(second, 1e-9):
            return []                 # ambiguous, wait for more
        st.nh_off = best
        # symbol 0 starts at buffered epoch `best`
        st.symbol_base += best
        st.pend = list(st.nh_buf[best:])
        st.nh_buf = []
    n_av = len(st.pend) // n_cs
    if not n_av:
        return []
    arr = np.asarray(st.pend[:n_av * n_cs], np.float64).reshape(n_av, n_cs)
    del st.pend[:n_av * n_cs]
    return (arr * pattern).sum(axis=1).tolist()


class GpsCnavTelemetryDecoder:
    """Consumes TrackingEngine outputs for GPS L2C CM ("2S": one 50-sps
    CNAV symbol per 20 ms epoch) or L5I ("L5": 1 ms epochs, 100-sps symbols
    spread by NH10) channels and produces TOW stamps + CNAV ephemerides.

    Same process() interface as TelemetryDecoder.  TOW semantics: each
    message's TOW field is the GPS time of the NEXT message start
    (IS-GPS-705 20.3.3.1 / nav.cnav), i.e. of symbol start_symbol + 600.
    """

    EPOCHS_PER_SYMBOL = {"2S": 1, "L5": 10}
    EPOCH_MS = {"2S": 20.0, "L5": 1.0}

    def __init__(self, prns, signal: str = "2S"):
        self.signal = signal
        self.prns = [int(p) for p in prns]
        self.ch = [_CnavChannelTlmState(decoder=CnavDecoder())
                   for _ in self.prns]
        self._nh = 1.0 - 2.0 * np.asarray(constants.GPS_L5I_NH_CODE,
                                          np.float64)

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _CnavChannelTlmState(decoder=CnavDecoder())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        epb = self.EPOCHS_PER_SYMBOL[self.signal]
        epoch_ms = self.EPOCH_MS[self.signal]
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            st.pend.extend(pi.tolist())
            if self.signal == "L5":
                soft = _fold_secondary(st, self._nh)
            else:
                # L2C CM: one symbol per epoch, no secondary code
                soft, st.pend = st.pend, []
            for ev in st.decoder.push_symbols(soft):
                if not ev.crc_ok or ev.msg_type not in (10, 11, 30):
                    continue
                st.msgs[ev.msg_type] = ev.fields
                # TOW anchor at the next message boundary
                st.anchor_epoch = (st.symbol_base
                                   + (ev.start_symbol + 600) * epb)
                st.anchor_tow_ms = ev.tow_s * 1000.0
                self._try_ephemeris(st, c, new_eph)
            _stamp_tow_column(tow[:, c], v, base, st, epoch_ms,
                              after_anchor=False)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _try_ephemeris(self, st, c, new_eph) -> None:
        if not all(mt in st.msgs for mt in (10, 11, 30)):
            return
        if st.msgs[10]["toe"] != st.msgs[11]["toe"]:
            return   # CNAV consistency gate (gps_cnav_navigation_message)
        eph = messages_to_ephemeris(self.prns[c], st.msgs)
        if (st.ephemeris is None or st.ephemeris.toe != eph.toe):
            st.ephemeris = eph
            new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# Galileo E5a F/NAV telemetry (the reference's galileo_telemetry_decoder_gs
# with frame_type=2, host-side)
# ---------------------------------------------------------------------------

class GalileoE5aTelemetryDecoder:
    """Consumes TrackingEngine outputs for E5a-I channels (1 ms epochs;
    50-sps F/NAV symbols spread by the 20-chip secondary code CS20),
    synchronizes the secondary code, forms soft symbols, decodes F/NAV
    pages (nav.fnav) and produces TOW stamps + Galileo ephemerides.

    TOW semantics: every F/NAV word's TOW field is the GST of its own
    page's first symbol."""

    def __init__(self, prns):
        self.prns = [int(p) for p in prns]
        self.ch = [_CnavChannelTlmState(decoder=FnavPageDecoder())
                   for _ in self.prns]
        # CS20 is the same for every satellite (Galileo_E5a.h:3581)
        self._cs = signals.e5a_secondary_code(0, "I").astype(np.float64)

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _CnavChannelTlmState(decoder=FnavPageDecoder())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            st.pend.extend(pi.tolist())
            soft = _fold_secondary(st, self._cs, margin=1.2, min_symbols=10)
            for ev in st.decoder.push_symbols(soft):
                if not ev.crc_ok or ev.word_type not in (1, 2, 3, 4):
                    continue
                st.msgs[ev.word_type] = ev.fields
                # TOW anchor: page start symbol transmitted at the word's
                # TOW; symbols are 20 epochs each
                st.anchor_epoch = (st.symbol_base
                                   + ev.page_start_symbol * 20)
                st.anchor_tow_ms = ev.fields["tow"] * 1000.0
                self._try_ephemeris(st, c, new_eph)
            _stamp_tow_column(tow[:, c], v, base, st, 1.0,
                              after_anchor=False)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _try_ephemeris(self, st, c, new_eph) -> None:
        if not all(w in st.msgs for w in (1, 2, 3)):
            return
        iods = {int(st.msgs[w]["iod_nav"]) for w in (1, 2, 3)}
        if len(iods) != 1:
            return
        eph = fnav_words_to_ephemeris(self.prns[c], st.msgs)
        if (st.ephemeris is None or st.ephemeris.iod_nav != eph.iod_nav
                or st.ephemeris.toe != eph.toe):
            st.ephemeris = eph
            new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# Galileo E5b I/NAV telemetry (the reference's unified
# galileo_telemetry_decoder_gs with frame_type=3, E5b-I, host-side)
# ---------------------------------------------------------------------------

class GalileoE5bTelemetryDecoder:
    """Consumes TrackingEngine outputs for E5b-I channels (1 ms code epochs;
    250-sps I/NAV symbols spread by the fixed 4-chip CS4 secondary code),
    synchronizes CS4, forms soft symbols, decodes I/NAV pages (nav.inav,
    the same word layer as E1-B) and produces TOW stamps + Galileo
    ephemerides.

    TOW semantics follow the E1-B decoder: word 5's page-start symbol is
    transmitted at GST TOW_5 (galileo_telemetry_decoder_gs.cc frame_type=3
    branch); symbols span 4 epochs, so the anchor epoch is
    symbol_base + 4 * page_start_symbol.  An ephemeris carries
    tgd = BGD(E1,E5b) * (f_E1 / f_E5b)^2, the E5b single-frequency group
    delay."""

    EPOCHS_PER_SYMBOL = 4
    EPOCH_MS = 1.0

    def __init__(self, prns):
        self.prns = [int(p) for p in prns]
        self.ch = [_CnavChannelTlmState(decoder=InavPageDecoder())
                   for _ in self.prns]
        self._cs = signals.e5b_secondary_code().astype(np.float64)
        self._words = [dict() for _ in self.prns]
        self._words_iod = [dict() for _ in self.prns]

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _CnavChannelTlmState(decoder=InavPageDecoder())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        self._words[c] = {}
        self._words_iod[c] = {}
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            anchor0 = st.anchor_epoch
            st.pend.extend(pi.tolist())
            symbols = _fold_secondary(st, self._cs, margin=1.15,
                                      min_symbols=60)
            for ev in st.decoder.push_symbols(symbols):
                if not ev.crc_ok:
                    continue
                self._handle_word(st, c, ev, new_eph)
            _stamp_tow_column(tow[:, c], v, base, st, self.EPOCH_MS,
                              after_anchor=True, anchor0=anchor0)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _handle_word(self, st, c, ev, new_eph) -> None:
        wt = ev.word_type
        words, words_iod = self._words[c], self._words_iod[c]
        if wt in (1, 2, 3, 4):
            words[wt] = ev.fields
            words_iod[wt] = int(ev.fields["iod_nav"])
        elif wt == 5:
            words[5] = ev.fields
            # word 5's page start (in 250-sps symbols) at 4 epochs a symbol
            st.anchor_epoch = (st.symbol_base
                               + ev.page_start_symbol
                               * self.EPOCHS_PER_SYMBOL)
            st.anchor_tow_ms = ev.fields["tow"] * 1000.0
        if all(k in words for k in (1, 2, 3, 4)):
            iods = {words_iod[k] for k in (1, 2, 3, 4)}
            if len(iods) == 1:
                eph = words_to_galileo_ephemeris(self.prns[c], words)
                # E5b single-frequency users apply BGD(E1,E5b)*(f1/f7)^2
                if getattr(eph, "bgd_e1e5b", 0.0):
                    ratio = (1575.42 / 1207.14) ** 2
                    eph = dataclasses.replace(
                        eph, tgd=eph.bgd_e1e5b * ratio)
                if (st.ephemeris is None
                        or st.ephemeris.iod_nav != eph.iod_nav
                        or st.ephemeris.toe != eph.toe):
                    st.ephemeris = eph
                    new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# GLONASS L1/L2 C/A GNAV telemetry (the reference's
# glonass_l1_ca_telemetry_decoder_gs, host-side)
# ---------------------------------------------------------------------------

class GlonassTelemetryDecoder:
    """Consumes TrackingEngine outputs for GLONASS C/A channels (1 ms code
    epochs; 100-sps GNAV meander-half symbols spanning 10 epochs each),
    synchronizes the 10-epoch symbol boundary by group-coherence voting,
    decodes GNAV strings (nav.gnav) and produces TOW stamps + ECEF-state
    ephemerides.

    TOW semantics: string 1's tk field is the (compressed) frame start
    time-of-day; `day_base_s` restores full seconds (the reference derives
    it from the receiver date)."""

    STRING_IDS = (1, 2, 3, 4, 5)

    def __init__(self, prns, freq_slots=None, day_base_s: float = 0.0):
        self.prns = [int(p) for p in prns]
        self.freq_slots = dict(freq_slots or {})
        self.day_base_s = float(day_base_s)
        self.ch = [_CnavChannelTlmState(decoder=GnavStringDecoder())
                   for _ in self.prns]
        self._ones = np.ones(10, np.float64)

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _CnavChannelTlmState(decoder=GnavStringDecoder())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def _symbols(self, st) -> list:
        """st.pend epochs -> soft 100-sps symbols once boundary-locked
        (all-ones pattern: the meander guarantees a sign flip at every
        mid-bit symbol boundary, so group-coherence voting still works)."""
        return _fold_secondary(st, self._ones, margin=1.1, min_symbols=40)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            st.pend.extend(pi.tolist())
            for ev in st.decoder.push_symbols(self._symbols(st)):
                if not ev.kx_ok or ev.string_id not in self.STRING_IDS:
                    continue
                st.msgs[ev.string_id] = ev.fields
                if ev.string_id == 1:
                    # string 1 starts the frame at time-of-day tk
                    st.anchor_epoch = (st.symbol_base
                                       + ev.string_start_symbol * 10)
                    st.anchor_tow_ms = (self.day_base_s
                                        + ev.fields["tk_s"]) * 1000.0
                self._try_ephemeris(st, c, new_eph)
            _stamp_tow_column(tow[:, c], v, base, st, 1.0,
                              after_anchor=False)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _try_ephemeris(self, st, c, new_eph) -> None:
        if not all(s in st.msgs for s in (1, 2, 3, 4)):
            return
        prn = self.prns[c]
        eph = strings_to_glonass_ephemeris(
            prn, st.msgs,
            day_base_s=np.floor(self.day_base_s / 86400.0) * 86400.0,
            freq_slot=self.freq_slots.get(prn, 0))
        if st.ephemeris is None or st.ephemeris.tb_s != eph.tb_s:
            st.ephemeris = eph
            new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# Galileo E6-B C/NAV telemetry (the E6 arm of the reference's
# galileo_telemetry_decoder_gs with its HAS message receiver, host-side)
# ---------------------------------------------------------------------------

class GalileoTowMap:
    """Shared PRN -> (TOW, sample counter) map: channels that decode TOW on
    any Galileo band publish it; E6-B channels, whose C/NAV pages carry no
    TOW, stamp their epochs from it (role of the reference's
    galileo_tow_map.cc and the telemetry decoder's d_E6_TOW_set path,
    galileo_telemetry_decoder_gs.cc:1273-1290)."""

    # extrapolation bound: a stamp older than this (in sample time) no
    # longer produces a TOW: the reference re-validates TOW against fresh
    # pages instead of extrapolating forever (galileo_tow_map.cc)
    MAX_AGE_S = 30.0

    def __init__(self, fs: float, max_age_s: float | None = None):
        self.fs = float(fs)
        self.max_age_s = float(max_age_s if max_age_s is not None
                               else self.MAX_AGE_S)
        self._m: dict[int, tuple[float, float]] = {}

    def update(self, prn: int, tow_ms: float, sample_counter: float) -> None:
        self._m[int(prn)] = (float(tow_ms), float(sample_counter))

    def tow_at_sample(self, prn: int, sample_counter: float) -> float | None:
        hit = self._m.get(int(prn))
        if hit is None:
            return None
        tow_ms, sc_ref = hit
        age_s = (float(sample_counter) - sc_ref) / self.fs
        if age_s > self.max_age_s:
            return None
        return tow_ms + age_s * 1e3


class GalileoE6bTelemetryDecoder:
    """Galileo E6-B C/NAV telemetry: one 1000-sps HAS symbol per 1 ms code
    epoch; pages decode through nav.cnav_e6.CnavPageDecoder and feed the
    shared nav.has.HasMessageAssembler (decoded HAS messages accumulate in
    `self.has.messages`).  TOW comes from the cross-band GalileoTowMap:
    C/NAV itself is timeless (reference E6 arm of
    galileo_telemetry_decoder_gs.cc:253,682-778 + the HAS msg receiver)."""

    EPOCH_MS = 1.0

    def __init__(self, prns, tow_map: GalileoTowMap | None = None):
        self.prns = [int(p) for p in prns]
        self.ch = [_GalChannelTlmState(decoder=CnavPageDecoder())
                   for _ in self.prns]
        self.has = HasMessageAssembler()
        self.tow_map = tow_map
        self.pages = []            # (channel, HasPageEvent), CRC-clean

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = _GalChannelTlmState(decoder=CnavPageDecoder())
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        sc = np.asarray(track_outs["sample_counter"], np.float64)
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            for ev in st.decoder.push_symbols(pi.tolist()):
                if not ev.crc_ok:
                    continue
                self.pages.append((c, ev))
                self.has.push_page(ev)
            if self.tow_map is not None and v.any():
                for e in np.flatnonzero(v):
                    t_ms = self.tow_map.tow_at_sample(self.prns[c], sc[e, c])
                    if t_ms is not None:
                        tow[e, c] = t_ms
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=[])


# ---------------------------------------------------------------------------
# BeiDou B1I / B3I telemetry (the reference's beidou_b1i_telemetry_decoder_gs,
# host-side): D1 on the MEO/IGSO PRNs, D2 on the GEO ones
# ---------------------------------------------------------------------------

class BeidouB1iTelemetryDecoder:
    """Consumes TrackingEngine outputs for B1I (and B3I, the same D1 / NH20
    structure) channels.  MEO/IGSO PRNs carry D1 (1 ms code epochs; 50-bps
    bits spread by NH20): synchronize NH20, fold 20-epoch bits, decode D1
    subframes (nav.dnav).  GEO PRNs (1-5, >58) carry D2 at 500 bps with no
    NH: per-epoch prompts feed the D2 page decoder directly (2 symbols per
    bit), the reference's per-satellite mode switch
    (beidou_b1i_telemetry_decoder_gs.cc set_satellite :368-420, decode
    dispatch :268-276).

    TOW semantics: every subframe's SOW field is the BDT of its own first
    bit (BDS ICD 5.2.4.2), for both D1 and D2; it goes into the stamps as
    it is, with no BDT - GPST offset."""

    def __init__(self, prns):
        self.prns = [int(p) for p in prns]
        self.ch = [_CnavChannelTlmState(decoder=self._decoder(p))
                   for p in self.prns]
        self._nh = 1.0 - 2.0 * np.asarray(BEIDOU_NH20, np.float64)

    @staticmethod
    def _decoder(prn: int):
        return D2SubframeDecoder() if is_geo_prn(prn) \
            else DnavSubframeDecoder()

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        if prn is not None:
            self.prns[c] = int(prn)
        st = _CnavChannelTlmState(decoder=self._decoder(self.prns[c]))
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        new_eph = []
        for c in range(n_ch):
            st = self.ch[c]
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            if is_geo_prn(self.prns[c]):
                # D2: 1 ms prompts straight into the page decoder
                for ev in st.decoder.push_symbols(pi):
                    if not ev.ok or ev.fra_id != 1:
                        continue
                    st.msgs[ev.pnum] = ev.fields
                    self._try_ephemeris_d2(st, c, new_eph)
                    # SOW stamps the frame's first bit, subframe 1's first
                    # symbol (BDS ICD 5.3.2 D2)
                    st.anchor_epoch = st.symbol_base + ev.subframe_start_sym
                    st.anchor_tow_ms = ev.fields["sow"] * 1000.0
            else:
                st.pend.extend(pi.tolist())
                soft_bits = _fold_secondary(st, self._nh, margin=1.2,
                                            min_symbols=10)
                for ev in st.decoder.push_bits(soft_bits):
                    if not ev.ok or ev.fra_id not in (1, 2, 3):
                        continue
                    st.msgs[ev.fra_id] = ev.fields
                    # SOW stamps the subframe's own first bit (20 ep/bit)
                    st.anchor_epoch = (st.symbol_base
                                       + ev.subframe_start_bit * 20)
                    st.anchor_tow_ms = ev.fields["sow"] * 1000.0
                    self._try_ephemeris(st, c, new_eph)
            _stamp_tow_column(tow[:, c], v, base, st, 1.0,
                              after_anchor=False)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=new_eph)

    def _try_ephemeris_d2(self, st, c, new_eph) -> None:
        if not all(p in st.msgs for p in range(1, 11)):
            return
        self._new_ephemeris(
            st, c, new_eph, d2_pages_to_beidou_ephemeris(self.prns[c],
                                                         st.msgs))

    def _try_ephemeris(self, st, c, new_eph) -> None:
        if not all(s in st.msgs for s in (1, 2, 3)):
            return
        self._new_ephemeris(
            st, c, new_eph, subframes_to_beidou_ephemeris(self.prns[c],
                                                          st.msgs))

    @staticmethod
    def _new_ephemeris(st, c, new_eph, eph) -> None:
        if st.ephemeris is None or st.ephemeris.toe != eph.toe:
            st.ephemeris = eph
            new_eph.append((c, eph))


# ---------------------------------------------------------------------------
# SBAS L1 telemetry — sbas_l1_telemetry_decoder_gs role
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SbasChannelTlmState:
    epoch_count: int = 0
    symbol_base: int = -1
    # epoch->symbol pairing resolved by correlating adjacent epoch
    # products at both alignments (the reference's Sample_Aligner,
    # sbas_l1_telemetry_decoder_gs.cc:115-170): the aligned pairing
    # multiplies two epochs of the SAME symbol (positive product), the
    # misaligned one straddles symbol boundaries; epochs buffer in `pend`
    # until the vote has enough margin, then one decoder runs
    decoder: object = None
    pend: list = dataclasses.field(default_factory=list)
    corr_paired: float = 0.0     # sum e[2k]   * e[2k+1]
    corr_shift: float = 0.0      # sum e[2k+1] * e[2k+2]
    n_voted: int = 0
    phase: int | None = None
    pend_base: int = -1          # global epoch index of pend[0]
    n_sym_fed: int = 0           # symbols fed to the message decoder
    # MT12-anchored GPS time (enables ranging on the GEO): epoch index +
    # TOW of a message-start second boundary
    anchor_epoch: int | None = None
    anchor_tow_ms: float = 0.0


class SbasL1TelemetryDecoder:
    """Consumes TrackingEngine outputs for SBAS L1 channels (1 ms code
    epochs; 500-sps rate-1/2-coded symbols spanning 2 epochs each) and
    produces decoded SBAS messages (self.messages: (channel, prn,
    SbasMessageEvent)) + per-channel MT9 GEO navigation (self.geo_nav).

    TOW: a channel stamps its epochs once an MT12 (GPS time) message has
    anchored it, from the epoch its message starts on; before that, and
    without MT12, tow_at_epoch_ms stays NaN (the reference's SBAS
    channels only publish messages)."""

    EPOCHS_PER_SYMBOL = 2
    EPOCH_MS = 1.0

    def __init__(self, prns):
        self.prns = [int(p) for p in prns]
        self.ch = [self._new_state() for _ in self.prns]
        self.messages = []

    @staticmethod
    def _new_state():
        return _SbasChannelTlmState(decoder=SbasMessageDecoder())

    def reset_channel(self, c: int, prn: int | None = None,
                      epoch_base: int | None = None) -> None:
        st = self._new_state()
        if epoch_base is not None:
            st.epoch_count = epoch_base
        self.ch[c] = st
        if prn is not None:
            self.prns[c] = int(prn)

    def geo_nav(self, c: int):
        """Latest MT9 GEO navigation decoded on channel c (or None)."""
        return self.ch[c].decoder.geo_nav

    def process(self, track_outs: dict) -> TelemetryOutputs:
        prompts = track_outs["prompt"]
        valid = track_outs["valid"]
        t_len, n_ch = prompts.shape
        tow = np.full((t_len, n_ch), np.nan)
        for c in range(n_ch):
            st = self.ch[c]
            # anchor BEFORE this batch's decodes: gating must be
            # row-exact whatever the chunk sizes (same rule as the
            # LNAV/INAV/GNAV decoders' anchor0)
            anchor0 = st.anchor_epoch
            pi, base, v = _collect_column(st, prompts[:, c], valid[:, c])
            if len(pi) and not st.pend:
                st.pend_base = base + int(np.argmax(v))
            st.pend.extend(pi.tolist())
            if st.phase is None:
                # pairing vote over the buffered epochs (Sample_Aligner)
                e = np.asarray(st.pend, np.float64)
                if len(e) >= 3:
                    st.corr_paired = float(
                        (e[0:-1:2] * e[1::2]).sum())
                    st.corr_shift = float(
                        (e[1:-1:2] * e[2::2]).sum())
                    st.n_voted = len(e)
                if st.n_voted < 64:
                    continue
                hi = max(st.corr_paired, st.corr_shift)
                lo = min(st.corr_paired, st.corr_shift)
                if hi <= 0 or hi - lo < 0.5 * abs(hi):
                    continue             # ambiguous, keep buffering
                st.phase = 0 if st.corr_paired >= st.corr_shift else 1
                del st.pend[:st.phase]   # odd pairing drops one epoch
                st.pend_base += st.phase
            n_sym = len(st.pend) // 2
            if not n_sym:
                continue
            syms = np.asarray(st.pend[:2 * n_sym], np.float64
                              ).reshape(-1, 2).sum(axis=1)
            # decoder symbol s starts at global epoch sym_epoch0 + 2 s
            sym_epoch0 = st.pend_base - 2 * st.n_sym_fed
            del st.pend[:2 * n_sym]
            st.pend_base += 2 * n_sym
            st.n_sym_fed += n_sym
            for ev in st.decoder.push_symbols(syms):
                self.messages.append((c, self.prns[c], ev))
                if ev.crc_ok and ev.msg_type == 12:
                    # MT12 GPS-time anchor: the message starts on a whole
                    # SBAS-network second == its broadcast GPS TOW
                    tow_s, _wk = parse_mt12(ev.payload)
                    st.anchor_epoch = sym_epoch0 + 2 * ev.start_symbol
                    st.anchor_tow_ms = tow_s * 1000.0
            _stamp_tow_column(tow[:, c], v, base, st, self.EPOCH_MS,
                              after_anchor=True, anchor0=anchor0)
        return TelemetryOutputs(tow_at_epoch_ms=tow,
                                tow_valid=~np.isnan(tow),
                                new_ephemerides=[])
