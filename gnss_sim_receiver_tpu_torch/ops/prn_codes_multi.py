"""GLONASS C/A, BeiDou B1I and B3I, GPS L2C (CM) and L5 I/Q PRN code
generation, the GLONASS, BeiDou, L2C and L5 parts of
``gnss_sim_receiver_tpu.ops.prn_codes_multi`` for the PyTorch port.

Host-side NumPy generation (the device sees constant tables), the
functional equivalents of the reference replica generators
(src/algorithms/libs/glonass_l1_signal_replica.cc,
beidou_b1i_signal_replica.cc, beidou_b3i_signal_replica.cc,
gps_l2c_signal_replica.cc and gps_l5_signal_replica.cc).  Register
polynomials and per-PRN constants are public ICD data (GLONASS ICD 5.1,
BeiDou ICD 5.1.3, BDS-SIS-ICD-B3I table 4-4, IS-GPS-200 table 3-II,
IS-GPS-705 table 3-I).

Codes are returned as +-1 float32 with bit b -> 2b-1 (the GPS C/A
convention of ops.prn_codes).
"""

from __future__ import annotations

import functools

import numpy as np

GLONASS_CA_LENGTH = 511
BEIDOU_B1I_LENGTH = 2046
BEIDOU_B3I_LENGTH = 10230
GPS_L2C_M_LENGTH = 10230
GPS_L5_LENGTH = 10230

# BeiDou B1I G2 phase-selector taps per PRN 1..63 (BeiDou ICD table 4;
# same data as beidou_b1i_signal_replica.cc:27-29). phase3 == 0 -> 2-tap.
_BDS_PHASE1 = (1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4,
               4, 4, 5, 5, 5, 5, 5, 6, 6, 6, 6, 8, 8, 8, 9, 9, 10, 2, 3, 3,
               3, 3, 3, 4, 4, 5, 5, 5, 5, 6, 8, 9, 9, 3, 5, 7, 4, 4, 5, 5,
               5, 5, 6)
_BDS_PHASE2 = (3, 4, 5, 6, 8, 9, 10, 11, 7, 4, 5, 6, 8, 9, 10, 11, 5, 6, 8,
               9, 10, 11, 6, 8, 9, 10, 11, 8, 9, 10, 11, 9, 10, 11, 10, 11,
               11, 7, 4, 6, 8, 10, 11, 5, 9, 6, 8, 10, 11, 9, 9, 10, 11, 7,
               7, 9, 5, 9, 6, 8, 10, 11, 9)
_BDS_PHASE3 = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
               0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3,
               3, 3, 3)

# BeiDou Neuman-Hofman secondary code (20 bits, D1 message channels)
BEIDOU_NH20 = (0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 1, 1, 0)

# B3I G2 per-PRN initial register phases (BDS-SIS-ICD-B3I table 4-4),
# bit i of the value = register cell i (cell 12 = MSB); the reference
# equivalent is beidou_b3i_signal_replica.cc:46-109.
_B3I_G2_INIT = (
    0x15FF, 0x1E2B, 0x178A, 0x1FFB, 0x191F, 0x1264, 0x1FD2,
    0x1DFD, 0x1402, 0x041B, 0x1D70, 0x059E, 0x0C95, 0x0E26,
    0x1189, 0x1C7C, 0x04C5, 0x00EC, 0x1157, 0x02DE, 0x042D,
    0x058A, 0x02CF, 0x0662, 0x0748, 0x0929, 0x16D3, 0x15E2,
    0x02F5, 0x0FFF, 0x0D8F, 0x1589, 0x12AB, 0x19A5, 0x1A5D,
    0x1F74, 0x0567, 0x1D10, 0x1B90, 0x1ACE, 0x1034, 0x0BD9,
    0x0DBC, 0x1A71, 0x0722, 0x0AC5, 0x13E6, 0x1F48, 0x0149,
    0x10AC, 0x1E4C, 0x098F, 0x0018, 0x1004, 0x06A6, 0x1646,
    0x0E78, 0x05CA, 0x19F6, 0x1245, 0x0E20, 0x0642, 0x044E)

# GPS L2C CM-code shift-register initial states, PRN 1..37
# (IS-GPS-200 table 3-II; GPS_L2C.h GPS_L2C_M_INIT_REG)
_L2CM_INIT = (
    0o742417664, 0o756014035, 0o002747144, 0o066265724, 0o601403471,
    0o703232733, 0o124510070, 0o617316361, 0o047541621, 0o733031046,
    0o713512145, 0o024437606, 0o021264003, 0o230655351, 0o001314400,
    0o222021506, 0o540264026, 0o205521705, 0o064022144, 0o120161274,
    0o044023533, 0o724744327, 0o045743577, 0o741201660, 0o700274134,
    0o010247261, 0o713433445, 0o737324162, 0o311627434, 0o710452007,
    0o722462133, 0o050172213, 0o500653703, 0o755077436, 0o136717361,
    0o756675453, 0o435506112)

# XB code advance (chips) per PRN 1..37, IS-GPS-705 table 3-I (reference
# GPS_L5.h GPS_L5I_INIT_REG / GPS_L5Q_INIT_REG)
_L5I_XB_ADV = (266, 365, 804, 1138, 1509, 1559, 1756, 2084, 2170, 2303,
               2527, 2687, 2930, 3471, 3940, 4132, 4332, 4924, 5343, 5443,
               5641, 5816, 5898, 5918, 5955, 6243, 6345, 6477, 6518, 6875,
               7168, 7187, 7329, 7577, 7720, 7777, 8057)
_L5Q_XB_ADV = (1701, 323, 5292, 2020, 5429, 7136, 1041, 5947, 4315, 148,
               535, 1939, 5206, 5910, 3595, 5135, 6082, 6990, 3546, 1523,
               4548, 4484, 1893, 3961, 7106, 5299, 4660, 276, 4389, 3783,
               1591, 1601, 749, 1387, 1661, 3210, 708)


def _pm1(bits: np.ndarray) -> np.ndarray:
    return (2.0 * bits - 1.0).astype(np.float32)


@functools.lru_cache(maxsize=1)
def glonass_l1_ca_code() -> np.ndarray:
    """GLONASS L1/L2 C/A 511-chip m-sequence (shared by all satellites:
    FDMA; glonass_l1_signal_replica.cc:25-49): 9-stage register, all-ones
    init, output tap 3, feedback taps 5 and 9."""
    reg = np.ones(9, dtype=np.int64)
    out = np.empty(GLONASS_CA_LENGTH, dtype=np.int8)
    for i in range(GLONASS_CA_LENGTH):
        out[i] = reg[2]
        fb = reg[4] ^ reg[0]
        reg[:-1] = reg[1:]
        reg[8] = fb
    return _pm1(out)


@functools.lru_cache(maxsize=80)
def beidou_b1i_code(prn: int) -> np.ndarray:
    """BeiDou B1I 2046-chip code, PRN 1..63 (beidou_b1i_signal_replica.cc:
    26-76): 11-stage G1/G2 with init 01010101010, G2 output from the
    per-PRN phase-selector taps.  Cached: the registers run 2046 steps in
    Python once per PRN."""
    if not 1 <= prn <= 63:
        raise ValueError(f"B1I PRN out of range: {prn}")
    p1 = _BDS_PHASE1[prn - 1]
    p2 = _BDS_PHASE2[prn - 1]
    p3 = _BDS_PHASE3[prn - 1]
    g1 = [i % 2 for i in range(11)]          # cell i = 1 where i is odd
    g2 = list(g1)
    out = np.empty(BEIDOU_B1I_LENGTH, dtype=np.int8)
    for i in range(BEIDOU_B1I_LENGTH):
        g2_out = g2[11 - p1] ^ g2[11 - p2]
        if p3:
            g2_out ^= g2[11 - p3]
        out[i] = g1[0] ^ g2_out
        fb1 = g1[0] ^ g1[1] ^ g1[2] ^ g1[3] ^ g1[4] ^ g1[10]
        fb2 = (g2[0] ^ g2[2] ^ g2[3] ^ g2[6] ^ g2[7] ^ g2[8] ^ g2[9]
               ^ g2[10])
        g1 = g1[1:] + [fb1]
        g2 = g2[1:] + [fb2]
    return _pm1(out)


@functools.lru_cache(maxsize=80)
def beidou_b3i_code(prn: int) -> np.ndarray:
    """BeiDou B3I 10230-chip code, PRN 1..63 (BDS-SIS-ICD-B3I 5.2.3;
    reference behavior beidou_b3i_signal_replica.cc:26-165): two 13-stage
    LFSRs, output = cell 0, shift toward cell 0.  G1 (all-ones init,
    feedback cells 0,9,10,12) restarts to all-ones whenever it reaches the
    truncation state (cells 2..12 set, cells 0..1 clear); G2 (per-PRN init
    phase, feedback cells 0,1,3,4,6,7,8,12) runs free.  Chip = G1 xor G2.
    Both registers are held as integers (bit i = cell i).  Cached: they
    run 10230 steps in Python once per PRN."""
    if not 1 <= prn <= 63:
        raise ValueError(f"B3I PRN out of range: {prn}")
    g1, g2 = 0x1FFF, _B3I_G2_INIT[prn - 1]
    out = np.empty(BEIDOU_B3I_LENGTH, dtype=np.int8)
    for i in range(BEIDOU_B3I_LENGTH):
        out[i] = (g1 ^ g2) & 1
        fb1 = (g1 ^ (g1 >> 9) ^ (g1 >> 10) ^ (g1 >> 12)) & 1
        fb2 = (g2 ^ (g2 >> 1) ^ (g2 >> 3) ^ (g2 >> 4) ^ (g2 >> 6)
               ^ (g2 >> 7) ^ (g2 >> 8) ^ (g2 >> 12)) & 1
        g1 = (g1 >> 1) | (fb1 << 12)
        g2 = (g2 >> 1) | (fb2 << 12)
        if g1 == 0x1FFC:          # cells 2..12 set, cells 0..1 clear
            g1 = 0x1FFF
    return _pm1(out)


@functools.lru_cache(maxsize=64)
def gps_l2c_m_code(prn: int) -> np.ndarray:
    """GPS L2C CM code, 10230 chips at 511.5 kcps, PRN 1..37
    (gps_l2c_signal_replica.cc:25-40): 27-stage modular LFSR
    x' = (x >> 1) ^ (x & 1) * 0o445112474, per-PRN initial state.  Cached:
    the register runs 10230 steps in Python once per PRN."""
    if not 1 <= prn <= len(_L2CM_INIT):
        raise ValueError(f"L2C PRN out of range: {prn}")
    x = _L2CM_INIT[prn - 1]
    out = np.empty(GPS_L2C_M_LENGTH, dtype=np.int8)
    for i in range(GPS_L2C_M_LENGTH):
        out[i] = x & 1
        x = (x >> 1) ^ ((x & 1) * 0o445112474)
    return _pm1(out)


def _l5_xa() -> np.ndarray:
    """XA sequence over 10230 chips: 13-stage register, taps 13,12,10,9,
    output stage 13, short-cycled at state 1111111111101 -> all ones
    (gps_l5_signal_replica.cc:24-33)."""
    reg = np.ones(13, dtype=np.int64)
    reset_state = np.array([1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1],
                           np.int64)
    out = np.empty(GPS_L5_LENGTH, dtype=np.int64)
    for i in range(GPS_L5_LENGTH):
        out[i] = reg[12]
        if (reg == reset_state).all():
            reg[:] = 1
        else:
            fb = reg[12] ^ reg[11] ^ reg[9] ^ reg[8]
            reg[1:] = reg[:-1]
            reg[0] = fb
    return out


def _l5_xb() -> np.ndarray:
    """XB sequence over 10230 chips: taps 13,12,8,7,6,4,3,1, free-running
    (gps_l5_signal_replica.cc:49-55)."""
    reg = np.ones(13, dtype=np.int64)
    out = np.empty(GPS_L5_LENGTH, dtype=np.int64)
    for i in range(GPS_L5_LENGTH):
        out[i] = reg[12]
        fb = reg[12] ^ reg[11] ^ reg[7] ^ reg[6] ^ reg[5] ^ reg[3] \
            ^ reg[2] ^ reg[0]
        reg[1:] = reg[:-1]
        reg[0] = fb
    return out


@functools.lru_cache(maxsize=2)
def _l5_bases():
    return _l5_xa(), _l5_xb()


@functools.lru_cache(maxsize=80)
def gps_l5_code(prn: int, quadrature: bool = False) -> np.ndarray:
    """GPS L5 I (data) or Q (pilot) code, 10230 chips at 10.23 Mcps:
    code[n] = XA[n] ^ XB[(n + advance_prn) % 10230]."""
    adv_table = _L5Q_XB_ADV if quadrature else _L5I_XB_ADV
    if not 1 <= prn <= len(adv_table):
        raise ValueError(f"L5 PRN out of range: {prn}")
    xa, xb = _l5_bases()
    n = np.arange(GPS_L5_LENGTH)
    bits = xa ^ xb[(n + adv_table[prn - 1]) % GPS_L5_LENGTH]
    return _pm1(bits)
