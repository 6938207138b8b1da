"""The port's RTCM 3.x codec against the JAX package's (both host NumPy).

For tests/test_rtcm.py's inputs, the port's payloads and frames are the
JAX package's bytes: CRC-24Q and framing, the 1019 / 1045 / 1042
ephemerides, the 1005 station, MSM4 and MSM7 on GPS, GLONASS (FDMA slots)
and SBAS, and a base encoder's whole stream; each package decodes the
other's frames to the same fields; the loopback transport delivers the
stream unchanged and joins its thread on close.
"""

import dataclasses
import socket

import numpy as np
import pytest

from gnss_sim_receiver_tpu.models import rtcm as jrtcm
from gnss_sim_receiver_tpu.models import rtk as jrtk
from gnss_sim_receiver_tpu.models.observables import \
    ObservationEpoch as JaxEpoch
from gnss_sim_receiver_tpu.nav import ephemeris as jeph
from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models import rtcm as prtcm
from gnss_sim_receiver_tpu_torch.models.receiver import ReceiverRun
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from tests.test_rtcm import _sky_eph


def _port_eph(e):
    return peph.GpsEphemeris(**dataclasses.asdict(e))


def _same_fields(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], k)


def test_crc24q_and_framing_like_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 40, 1023):
        payload = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert prtcm.crc24q(payload) == jrtcm.crc24q(payload)
        f = prtcm.frame(payload)
        assert f == jrtcm.frame(payload)
        assert list(prtcm.iter_frames(f)) == list(jrtcm.iter_frames(f))
    f = jrtcm.frame(bytes(range(40)))
    corrupted = bytearray(f)
    corrupted[10] ^= 0xFF
    stream = b"\xd3junk" + bytes(corrupted) + b"\x00\xd3" + f + b"tail"
    assert list(prtcm.iter_frames(stream)) == [bytes(range(40))]


def test_bit_writer_reader_like_jax():
    rng = np.random.default_rng(1)
    fields = [(int(n), int(rng.integers(0, 2 ** n)))
              for n in rng.integers(1, 38, 60)]
    pw, jw = prtcm.BitWriter(), jrtcm.BitWriter()
    for n, v in fields:
        for w in (pw, jw):
            w.u(v, n)
            w.s(v - 2 ** (n - 1), n + 1)
    assert pw.nbits == jw.nbits
    assert pw.tobytes() == jw.tobytes()
    r = prtcm.BitReader(jw.tobytes())
    for n, v in fields:
        assert r.u(n) == v
        assert r.s(n + 1) == v - 2 ** (n - 1)


@pytest.mark.parametrize("system", ["GPS", "Galileo", "BeiDou"])
def test_ephemeris_bytes_like_jax(system):
    eph = _sky_eph(system)
    payload = jrtcm.encode_ephemeris(eph)
    assert prtcm.encode_ephemeris(_port_eph(eph)) == payload
    assert prtcm.message_number(payload) == jrtcm.message_number(payload)
    _same_fields(prtcm.decode_ephemeris(payload),
                 jrtcm.decode_ephemeris(payload))


def test_station_bytes_like_jax():
    ecef = np.array([1112189.9031, -4842955.0319, 3985352.2376])
    payload = jrtcm.encode_station(ecef, station_id=42)
    assert prtcm.encode_station(ecef, station_id=42) == payload
    pp, ps = prtcm.decode_station(payload)
    jp, js = jrtcm.decode_station(payload)
    assert ps == js
    np.testing.assert_array_equal(pp, jp)


def _gps_obs(mod, rng):
    out = []
    for prn in (2, 9, 17, 23):
        pr = 2.1e7 + rng.uniform(0, 5e6)
        lam = mod.C / mod._SIG_FREQ[("GPS", "1C")]
        out.append(mod.MsmObservation(
            prn=prn, system="GPS", signal="1C", pseudorange_m=pr,
            carrier_phase_cycles=(pr + rng.uniform(-20, 20)) / lam,
            doppler_hz=rng.uniform(-4000, 4000), cn0_db_hz=44.5))
    return out


def _glonass_obs(mod):
    return [mod.MsmObservation(
        prn=prn, system="GLONASS", signal="1G", pseudorange_m=pr,
        carrier_phase_cycles=pr / mod._sig_lambda("GLONASS", "1G", k),
        doppler_hz=dop, cn0_db_hz=cn0, lock_s=60.0, freq_slot=k)
        for prn, pr, k, dop, cn0 in ((5, 2.1234567e7, 3, 1234.5, 44.5),
                                     (12, 2.3456789e7, -4, -2500.25, 41.0))]


def _sbas_obs(mod):
    return [mod.MsmObservation(
        prn=20, system="SBAS", signal="S1", pseudorange_m=3.8123456e7,
        carrier_phase_cycles=3.8123456e7 / mod._sig_lambda("SBAS", "S1"),
        doppler_hz=150.0, cn0_db_hz=38.5, lock_s=30.0)]


@pytest.mark.parametrize("case,msm", [("GPS", 4), ("GPS", 7),
                                      ("GLONASS", 7), ("SBAS", 7),
                                      ("GLONASS", 4)])
def test_msm_bytes_like_jax(case, msm):
    tow = {"GPS": 345600123, "GLONASS": 34567000, "SBAS": 12345000}[case]
    make = {"GPS": lambda m: _gps_obs(m, np.random.default_rng(5)),
            "GLONASS": _glonass_obs, "SBAS": _sbas_obs}[case]
    payload = jrtcm.encode_msm(case, tow, make(jrtcm), msm=msm,
                               station_id=3)
    assert prtcm.encode_msm(case, tow, make(prtcm), msm=msm,
                            station_id=3) == payload
    pe, je = prtcm.decode_msm(payload), jrtcm.decode_msm(payload)
    assert (pe.system, pe.tow_ms) == (je.system, je.tow_ms)
    assert [dataclasses.asdict(o) for o in pe.obs] == \
        [dataclasses.asdict(o) for o in je.obs]


def _base_run():
    """A base receiver's result: two GPS channels and a Galileo one over
    50 epochs at 20 ms, phase in the chain's sign convention, with the
    sky's ephemerides."""
    rng = np.random.default_rng(9)
    n, epochs = 4, []
    for k in range(50):
        t = 345600.0 + 0.02 * k
        pr = 2.1e7 + 1e6 * np.arange(n) + 0.7 * k
        epochs.append(JaxEpoch(
            rx_time_s=t, tick_sample=0,
            valid=np.array([True, True, k % 7 != 3, False]),
            pseudorange_m=pr, interp_tow_ms=t * 1e3 - pr / 299792.458,
            carrier_doppler_hz=rng.uniform(-3000, 3000, n),
            carrier_phase_cycles=-(pr / 0.19029367) + rng.uniform(-9, 9, n),
            cn0_db_hz=rng.uniform(38, 50, n)))
    ephs = {e.prn: e for e in jeph.make_sky_constellation(
        40.0, -75.0, toe=346560.0)[:3]}
    return epochs, [3, 9, 11, 0], ["GPS", "GPS", "Galileo", "GPS"], ephs


@pytest.mark.parametrize("msm", [4, 7])
def test_base_stream_like_jax_and_cross_decoded(msm):
    """RtcmBaseEncoder.encode_run of the same base run: the same byte
    stream; each package's decoder gives the same BaseObservations and
    ephemerides from it."""
    epochs, prns, systems, ephs = _base_run()
    base = np.array([1112189.9031, -4842955.0319, 3985352.2376])
    jrun = type("Run", (), dict(observation_epochs=epochs,
                                channel_prns=prns, channel_systems=systems))
    prun = ReceiverRun(
        solutions=[], observation_epochs=[interop.observation_epoch_from(e)
                                          for e in epochs],
        channel_prns=prns, channel_states=[], ephemerides={}, events=[],
        channel_systems=systems)
    stream = jrtcm.RtcmBaseEncoder(base, station_id=7, msm=msm).encode_run(
        jrun, ephemerides=ephs)
    got = prtcm.RtcmBaseEncoder(base, station_id=7, msm=msm).encode_run(
        prun, ephemerides={k: _port_eph(e) for k, e in ephs.items()})
    assert got == stream
    pdec, jdec = prtcm.RtcmBaseDecoder(), jrtcm.RtcmBaseDecoder()
    pdec.feed(stream)
    jdec.feed(stream)
    assert pdec.ephemerides.keys() == jdec.ephemerides.keys() == ephs.keys()
    for k in ephs:
        _same_fields(pdec.ephemerides[k], jdec.ephemerides[k])
    pb, jb = pdec.base_observations(), jdec.base_observations()
    assert isinstance(jb, jrtk.BaseObservations)
    cross = interop.base_observations_from(jb)
    assert (pb.prns, pb.systems) == (cross.prns, cross.systems)
    np.testing.assert_array_equal(pb.base_ecef_m, cross.base_ecef_m)
    assert len(pb.epochs) == len(cross.epochs) == 50
    for a, b in zip(pb.epochs, cross.epochs):
        for f in dataclasses.fields(JaxEpoch):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), f.name)


def test_loopback_transport():
    data = prtcm.frame(prtcm.encode_station([10.0, 20.0, 30.0])) * 3
    port, srv = prtcm.serve_frames(data)
    try:
        got = prtcm.read_frames("127.0.0.1", port, timeout_s=5.0)
        # a second client gets the stream again, through JAX's reader
        again = jrtcm.read_frames("127.0.0.1", port, timeout_s=5.0)
    finally:
        srv.close()
    assert got == again == data
    assert len(list(prtcm.iter_frames(got))) == 3
    assert not srv._thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
    with pytest.raises(ValueError, match="loopback"):
        prtcm.serve_frames(data, host="0.0.0.0")
