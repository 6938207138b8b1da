"""Galileo HAS (High Accuracy Service) message assembly and MT1 codec.

Receiver side mirrors the reference's galileo_e6_has_msg_receiver.cc:
pages with the same message ID fill a 255x53 octet C-matrix (row = PID-1);
once `message_size` distinct PIDs arrive, every 53 columns is
erasure-decoded with RS(255,32) (reed_solomon.py) and the recovered
`message_size` x 53 octet M-matrix is parsed as an MT1 message
(read_MT1_header / read_MT1_body): satellite/signal masks, orbit
corrections, clock full-set / subset corrections, code and phase biases
(HAS SIS ICD 1.0 Tables 13-40).

The encoder half (MT1 pack + page generation) replaces an uplink tool the
reference lacks — the simulator uses it to put a HAS message on E6-B.

Copy of ``gnss_sim_receiver_tpu.nav.has`` for the PyTorch port (the port
imports nothing from the JAX package).  Its assembler decodes the 53
columns of a message in one call (``reed_solomon.decode_columns``), with
the words the JAX module decodes column by column.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnss_sim_receiver_tpu_torch.nav import reed_solomon as rs
from gnss_sim_receiver_tpu_torch.nav.cnav_e6 import (
    HasPageEvent, HasPageHeader, OCTETS_PER_PAGE, encode_page)

# field scale factors (Galileo_CNAV.h:86-91)
SCALE_RADIAL = 0.0025       # m
SCALE_IN_TRACK = 0.008      # m
SCALE_CROSS_TRACK = 0.008   # m
SCALE_CLOCK = 0.0025        # m
SCALE_CODE_BIAS = 0.02      # m
SCALE_PHASE_BIAS = 0.01     # cycles
GPS_SYSTEM = 0
GALILEO_SYSTEM = 2
MAX_TOH = 3599


class _BitReader:
    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, np.int64)
        self.pos = 0

    def u(self, n: int) -> int:
        out = 0
        for b in self.bits[self.pos:self.pos + n]:
            out = (out << 1) | int(b)
        self.pos += n
        return out

    def s(self, n: int) -> int:
        v = self.u(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, value: int, n: int) -> None:
        self.bits.extend((int(value) >> (n - 1 - i)) & 1 for i in range(n))

    def s(self, value: int, n: int) -> None:
        self.u(int(value) & ((1 << n) - 1), n)

    def array(self) -> np.ndarray:
        return np.array(self.bits, np.int64)


@dataclasses.dataclass
class HasHeader:
    """MT1 message header (HAS SIS ICD Table 13; 32 bits)."""
    toh: int = 0
    mask_flag: bool = False
    orbit_correction_flag: bool = False
    clock_fullset_flag: bool = False
    clock_subset_flag: bool = False
    code_bias_flag: bool = False
    phase_bias_flag: bool = False
    reserved: int = 0
    mask_id: int = 0
    iod_set_id: int = 0


@dataclasses.dataclass
class HasData:
    """Decoded MT1 content (reference Galileo_HAS_data,
    galileo_has_data.h).  Per-system arrays are indexed by the mask order;
    per-satellite arrays by the flattened mask order."""
    header: HasHeader = dataclasses.field(default_factory=HasHeader)
    tow: int | None = None
    # mask section
    nsys: int = 0
    gnss_id_mask: list = dataclasses.field(default_factory=list)
    satellite_mask: list = dataclasses.field(default_factory=list)   # u40
    signal_mask: list = dataclasses.field(default_factory=list)      # u16
    cell_mask_flag: list = dataclasses.field(default_factory=list)
    cell_mask: list = dataclasses.field(default_factory=list)  # [sys][sat][sig]
    nav_message: list = dataclasses.field(default_factory=list)
    # orbit corrections (per masked satellite)
    validity_orbit: int = 0
    gnss_iod: list = dataclasses.field(default_factory=list)
    delta_radial_m: list = dataclasses.field(default_factory=list)
    delta_in_track_m: list = dataclasses.field(default_factory=list)
    delta_cross_track_m: list = dataclasses.field(default_factory=list)
    # clock full-set
    validity_clock: int = 0
    delta_clock_multiplier: list = dataclasses.field(default_factory=list)
    delta_clock_m: list = dataclasses.field(default_factory=list)
    # clock subset
    validity_clock_subset: int = 0
    nsys_sub: int = 0
    gnss_id_clock_subset: list = dataclasses.field(default_factory=list)
    multiplier_clock_subset: list = dataclasses.field(default_factory=list)
    satellite_submask: list = dataclasses.field(default_factory=list)
    delta_clock_subset_m: list = dataclasses.field(default_factory=list)
    # code / phase biases [sat][signal-in-cell]
    validity_code_bias: int = 0
    code_bias_m: list = dataclasses.field(default_factory=list)
    validity_phase_bias: int = 0
    phase_bias_cycles: list = dataclasses.field(default_factory=list)
    phase_discontinuity: list = dataclasses.field(default_factory=list)

    def sats_per_system(self) -> list[int]:
        return [bin(int(m)).count("1") for m in self.satellite_mask]

    def prns(self, sys_idx: int) -> list[int]:
        """PRNs flagged in system sys_idx's 40-bit mask (MSB = PRN 1)."""
        m = int(self.satellite_mask[sys_idx])
        return [i + 1 for i in range(40) if (m >> (39 - i)) & 1]

    def system_of_sat(self, flat_idx: int) -> int:
        """gnss_id owning flattened masked-satellite index flat_idx."""
        n = 0
        for i, c in enumerate(self.sats_per_system()):
            if flat_idx < n + c:
                return int(self.gnss_id_mask[i])
            n += c
        raise IndexError(flat_idx)


# ---------------------------------------------------------------------------
# MT1 body codec
# ---------------------------------------------------------------------------

def _signals_per_cell(d: HasData, sys_idx: int, sat_in_sys: int) -> int:
    nsig = bin(int(d.signal_mask[sys_idx])).count("1")
    if d.cell_mask_flag[sys_idx]:
        return int(np.sum(d.cell_mask[sys_idx][sat_in_sys]))
    return nsig


def parse_mt1(bits: np.ndarray) -> HasData:
    """Decode an MT1 message (header + body) from its bit array
    (reference read_MT1_header/read_MT1_body)."""
    r = _BitReader(bits)
    h = HasHeader(
        toh=r.u(12), mask_flag=bool(r.u(1)),
        orbit_correction_flag=bool(r.u(1)),
        clock_fullset_flag=bool(r.u(1)), clock_subset_flag=bool(r.u(1)),
        code_bias_flag=bool(r.u(1)), phase_bias_flag=bool(r.u(1)),
        reserved=r.u(4), mask_id=r.u(5), iod_set_id=r.u(5))
    d = HasData(header=h)
    if h.toh > MAX_TOH:
        raise ValueError(f"TOH {h.toh} out of range")

    if h.mask_flag:
        d.nsys = r.u(4)
        for _ in range(d.nsys):
            d.gnss_id_mask.append(r.u(4))
            sat_mask = r.u(40)
            d.satellite_mask.append(sat_mask)
            n_sat = bin(sat_mask).count("1")
            sig_mask = r.u(16)
            d.signal_mask.append(sig_mask)
            n_sig = bin(sig_mask).count("1")
            flag = bool(r.u(1))
            d.cell_mask_flag.append(flag)
            if flag:
                cm = np.array([[r.u(1) for _ in range(n_sig)]
                               for _ in range(n_sat)], bool)
            else:
                cm = np.ones((n_sat, n_sig), bool)
            d.cell_mask.append(cm)
            d.nav_message.append(r.u(3))
        r.u(6)   # mask-section reserved
    nsat = sum(d.sats_per_system())

    if h.orbit_correction_flag:
        d.validity_orbit = r.u(4)
        for i in range(nsat):
            gnss = d.system_of_sat(i)
            d.gnss_iod.append(r.u(8 if gnss == GPS_SYSTEM else 10))
            d.delta_radial_m.append(r.s(13) * SCALE_RADIAL)
            d.delta_in_track_m.append(r.s(12) * SCALE_IN_TRACK)
            d.delta_cross_track_m.append(r.s(12) * SCALE_CROSS_TRACK)

    if h.clock_fullset_flag:
        d.validity_clock = r.u(4)
        for _ in range(d.nsys):
            d.delta_clock_multiplier.append(r.u(2) + 1)
        mult_of_sat = []
        for i, c in enumerate(d.sats_per_system()):
            mult_of_sat.extend([d.delta_clock_multiplier[i]] * c)
        for i in range(nsat):
            d.delta_clock_m.append(r.s(13) * SCALE_CLOCK * mult_of_sat[i])

    if h.clock_subset_flag:
        d.validity_clock_subset = r.u(4)
        d.nsys_sub = r.u(4)
        if d.nsys_sub == 0:
            raise ValueError("clock subset with Nsys_sub == 0")
        for _ in range(d.nsys_sub):
            gid = r.u(4)
            d.gnss_id_clock_subset.append(gid)
            mult = r.u(2) + 1
            d.multiplier_clock_subset.append(mult)
            sys_idx = d.gnss_id_mask.index(gid)
            n_in_sys = d.sats_per_system()[sys_idx]
            submask = r.u(n_in_sys)
            d.satellite_submask.append(submask)
            vals = [r.s(13) * SCALE_CLOCK * mult
                    for _ in range(bin(submask).count("1"))]
            d.delta_clock_subset_m.append(vals)

    if h.code_bias_flag:
        d.validity_code_bias = r.u(4)
        flat = 0
        for si, c in enumerate(d.sats_per_system()):
            for s in range(c):
                d.code_bias_m.append(
                    [r.s(11) * SCALE_CODE_BIAS
                     for _ in range(_signals_per_cell(d, si, s))])
                flat += 1

    if h.phase_bias_flag:
        d.validity_phase_bias = r.u(4)
        for si, c in enumerate(d.sats_per_system()):
            for s in range(c):
                pb, pd = [], []
                for _ in range(_signals_per_cell(d, si, s)):
                    pb.append(r.s(11) * SCALE_PHASE_BIAS)
                    pd.append(r.u(2))
                d.phase_bias_cycles.append(pb)
                d.phase_discontinuity.append(pd)
    return d


def pack_mt1(d: HasData) -> np.ndarray:
    """Encode a HasData into MT1 bits (inverse of parse_mt1)."""
    h = d.header
    w = _BitWriter()
    w.u(h.toh, 12)
    for f in (h.mask_flag, h.orbit_correction_flag, h.clock_fullset_flag,
              h.clock_subset_flag, h.code_bias_flag, h.phase_bias_flag):
        w.u(int(f), 1)
    w.u(h.reserved, 4)
    w.u(h.mask_id, 5)
    w.u(h.iod_set_id, 5)

    if h.mask_flag:
        w.u(d.nsys, 4)
        for i in range(d.nsys):
            w.u(d.gnss_id_mask[i], 4)
            w.u(int(d.satellite_mask[i]), 40)
            w.u(int(d.signal_mask[i]), 16)
            w.u(int(d.cell_mask_flag[i]), 1)
            if d.cell_mask_flag[i]:
                for row in np.asarray(d.cell_mask[i], bool):
                    for b in row:
                        w.u(int(b), 1)
            w.u(d.nav_message[i], 3)
        w.u(0, 6)
    nsat = sum(d.sats_per_system())

    if h.orbit_correction_flag:
        w.u(d.validity_orbit, 4)
        for i in range(nsat):
            gnss = d.system_of_sat(i)
            w.u(int(d.gnss_iod[i]), 8 if gnss == GPS_SYSTEM else 10)
            w.s(round(d.delta_radial_m[i] / SCALE_RADIAL), 13)
            w.s(round(d.delta_in_track_m[i] / SCALE_IN_TRACK), 12)
            w.s(round(d.delta_cross_track_m[i] / SCALE_CROSS_TRACK), 12)

    if h.clock_fullset_flag:
        w.u(d.validity_clock, 4)
        for i in range(d.nsys):
            w.u(int(d.delta_clock_multiplier[i]) - 1, 2)
        mult_of_sat = []
        for i, c in enumerate(d.sats_per_system()):
            mult_of_sat.extend([d.delta_clock_multiplier[i]] * c)
        for i in range(nsat):
            w.s(round(d.delta_clock_m[i] / (SCALE_CLOCK * mult_of_sat[i])),
                13)

    if h.clock_subset_flag:
        w.u(d.validity_clock_subset, 4)
        w.u(d.nsys_sub, 4)
        for i in range(d.nsys_sub):
            w.u(d.gnss_id_clock_subset[i], 4)
            mult = d.multiplier_clock_subset[i]
            w.u(mult - 1, 2)
            sys_idx = d.gnss_id_mask.index(d.gnss_id_clock_subset[i])
            n_in_sys = d.sats_per_system()[sys_idx]
            w.u(int(d.satellite_submask[i]), n_in_sys)
            for v in d.delta_clock_subset_m[i]:
                w.s(round(v / (SCALE_CLOCK * mult)), 13)

    if h.code_bias_flag:
        w.u(d.validity_code_bias, 4)
        for sat in d.code_bias_m:
            for v in sat:
                w.s(round(v / SCALE_CODE_BIAS), 11)

    if h.phase_bias_flag:
        w.u(d.validity_phase_bias, 4)
        for pb, pd in zip(d.phase_bias_cycles, d.phase_discontinuity):
            for v, disc in zip(pb, pd):
                w.s(round(v / SCALE_PHASE_BIAS), 11)
                w.u(disc, 2)
    return w.array()


# ---------------------------------------------------------------------------
# Page-level encode (simulator) / assemble (receiver)
# ---------------------------------------------------------------------------

def mt1_to_pages(d: HasData, message_id: int, pids=None,
                 has_status: int = 1) -> list[np.ndarray]:
    """Encode a HasData into C/NAV page symbol blocks (1000 symbols each).

    The MT1 bits are padded to `message_size` 53-octet rows (M-matrix);
    each of the 53 columns is RS(255,32)-encoded; page PID p transmits
    C-matrix row p-1.  `pids` selects which rows go on air (default
    1..message_size, i.e. the systematic information pages); passing PIDs
    > 32 exercises true Reed-Solomon recovery from parity pages.
    """
    bits = pack_mt1(d)
    n_oct = (len(bits) + 7) // 8
    size = (n_oct + OCTETS_PER_PAGE - 1) // OCTETS_PER_PAGE
    if size > rs.K:
        raise ValueError(f"message needs {size} pages > {rs.K}")
    padded = np.zeros(size * OCTETS_PER_PAGE * 8, np.int64)
    padded[:len(bits)] = bits
    m_matrix = np.packbits(padded.astype(np.uint8)).reshape(
        size, OCTETS_PER_PAGE)
    info = np.zeros((rs.K, OCTETS_PER_PAGE), np.int64)
    info[:size] = m_matrix
    c_matrix = np.stack(
        [rs.encode(info[:, col]) for col in range(OCTETS_PER_PAGE)],
        axis=1)                                     # [255, 53]
    if pids is None:
        pids = list(range(1, size + 1))
    pages = []
    for pid in pids:
        hdr = HasPageHeader(has_status=has_status, message_type=1,
                            message_id=message_id, message_size=size,
                            message_page_id=int(pid))
        pages.append(encode_page(hdr, c_matrix[pid - 1]))
    return pages


class HasMessageAssembler:
    """Collects CRC-clean HAS pages across all E6 channels and reassembles
    MT1 messages (the galileo_e6_has_msg_receiver block's role)."""

    def __init__(self):
        self._c = {}         # mid -> {pid: octets[53]}
        self.messages: list[HasData] = []

    def push_page(self, ev: HasPageEvent) -> HasData | None:
        h = ev.header
        if not ev.crc_ok or h.message_type != 1 or h.message_page_id == 0:
            return None
        if h.has_status == 3:   # do not use
            return None
        rows = self._c.setdefault(h.message_id, {})
        rows.setdefault(h.message_page_id, np.asarray(ev.octets, np.int64))
        if len(rows) < h.message_size:
            return None
        out = self._decode(h.message_id, h.message_size)
        self._c.pop(h.message_id, None)
        if out is not None:
            self.messages.append(out)
        return out

    def _decode(self, mid: int, size: int) -> HasData | None:
        rows = self._c[mid]
        received = sorted(rows)
        erasures = [p - 1 for p in range(1, rs.N + 1) if p not in rows]
        # PIDs in (size, 32] are structurally zero (info rows beyond the
        # message) — not erasures (reference decode_message_type1:309-315)
        known_zero = [p - 1 for p in range(size + 1, rs.K + 1)]
        erasures = [e for e in erasures if e not in set(known_zero)]
        if len(erasures) > rs.NROOTS:
            return None
        words = np.zeros((OCTETS_PER_PAGE, rs.N), np.int64)
        for pid in received:
            words[:, pid - 1] = rows[pid]
        decoded = rs.decode_columns(words, erasures)   # every column at once
        if decoded is None:
            return None
        m_matrix = decoded[:, :rs.K].T             # [32, 53]
        bits = np.unpackbits(
            m_matrix[:size].astype(np.uint8).reshape(-1)[:, None],
            axis=1).reshape(-1).astype(np.int64)
        try:
            return parse_mt1(bits)
        except (ValueError, IndexError):
            return None
