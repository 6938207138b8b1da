"""The live session of the PyTorch port on the CPU: streaming input, the
control plane and the TCP telecommand server, against the JAX package.

- Streaming against batch: the port's ``feed`` in 1 s blocks, then
  ``run_to_end``, against its ``process_array`` on the first 10 s of
  ``tests.fixtures.control_scenario_capture`` (warm start from the
  scenario's ephemerides), under tests/test_control_plane.py's bounds: fix
  counts within 2, the first four fixes within 0.5 m, the last within 3 m.
- Streaming against JAX's streaming: after each of the first five feeds
  the cursor, the buffer's base and length are equal, and so is every
  acquisition window's absolute start (the window is searched exactly
  where JAX's host-buffer path searches it).
- The control plane on both packages' sessions after those feeds:
  standby, the dropped inflow, warm, hot and cold start leave the same
  channel states and PRNs, acquisition pools, ephemerides, cursor and
  buffer; status_text is the same line; prioritize_visible gives the same
  order from a planted almanac and from a planted fix.
- tests/test_tcp_cmd.py's two cases against the port's server, a port
  session driven over the socket, and eight client threads' commands
  beside the main thread's feeds.
- The refusals: feed with a chain on RF channel 1; collect_track_outputs
  and base_observations, once refused, accepted (the base stream is used
  by an RTK mode only, which refuses to start without one, as JAX's).
"""

import dataclasses
import socket
import sys
import threading
import types

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu.models import acquisition as jacq
from gnss_sim_receiver_tpu.models import receiver as jrx
from gnss_sim_receiver_tpu_torch.models import acquisition as pacq
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.monitor.tcp_cmd import TcpCmdServer
from gnss_sim_receiver_tpu_torch.nav import ephemeris as peph
from tests.fixtures import (FS, control_scenario_capture, rx_true_ecef,
                            scenario_ephemerides)

STREAM_S = 10
JAX_FEEDS = 5
STEP = int(FS)


def _conf(mod):
    return mod.ReceiverConf(fs=FS, prns=tuple(range(1, 11)), max_channels=8)


def _port_ephs():
    return {p: peph.GpsEphemeris(**dataclasses.asdict(e))
            for p, e in scenario_ephemerides().items()}


@pytest.fixture(scope="module")
def capture():
    x, _ = control_scenario_capture()
    return np.ascontiguousarray(x[:int(FS * STREAM_S)])


@pytest.fixture(scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _feed_logged(name, capture, n_feeds):
    """A warm-started streaming session of one package fed `n_feeds` 1 s
    blocks: the session, (cursor, base, buffer length) after each feed and
    the absolute start of every acquisition window."""
    acq_mod, rx_mod = (pacq, prx) if name == "port" else (jacq, jrx)
    starts, marks = [], []
    eng = acq_mod.PcpsAcquisitionEngine
    with pytest.MonkeyPatch.context() as mp:
        def acquire_from(self, x, start, _f=eng.acquire_from):
            starts.append(int(start) + s._base)
            return _f(self, x, start)
        mp.setattr(eng, "acquire_from", acquire_from)
        if name == "port":
            s = prx.Receiver(_conf(prx), device="cpu").start_session(
                ephemerides=_port_ephs())
        else:
            s = jrx.Receiver(_conf(jrx)).start_session(
                ephemerides=dict(scenario_ephemerides()))
        for k in range(n_feeds):
            s.feed(capture[k * STEP:(k + 1) * STEP])
            marks.append((s.cursor, s._base, len(s._buf)))
    return s, marks, starts


@pytest.fixture(scope="module")
def fed(capture, threads):
    return {name: _feed_logged(name, capture, JAX_FEEDS)
            for name in ("port", "jax")}


def _state(s):
    return dict(
        channels=[(c.state.name, c.prn) for rt in s.chains
                  for c in rt.mgr.channels],
        pools=[list(rt.mgr.pool) for rt in s.chains],
        ephemerides=sorted(s.ephemerides),
        input=(s.cursor, s._base, len(s._buf), s._end_abs, s._standby),
        active=[rt.trk.active_host.tolist() for rt in s.chains])


def test_streaming_matches_batch(capture, threads):
    """tests/test_control_plane.py::test_streaming_session_matches_batch on
    the port."""
    batch = prx.Receiver(_conf(prx), device="cpu").process_array(
        capture, ephemerides=_port_ephs())
    s = prx.Receiver(_conf(prx), device="cpu").start_session(
        ephemerides=_port_ephs())
    for k in range(0, len(capture), STEP):
        s.feed(capture[k:k + STEP])
    s.run_to_end()
    run = s.result()
    assert len(run.solutions) > 0
    assert abs(len(run.solutions) - len(batch.solutions)) <= 2
    d0 = max(np.linalg.norm(run.solutions[i].rx_ecef_m
                            - batch.solutions[i].rx_ecef_m)
             for i in range(min(4, len(run.solutions))))
    assert d0 < 0.5, d0
    d = np.linalg.norm(run.solutions[-1].rx_ecef_m
                       - batch.solutions[-1].rx_ecef_m)
    assert d < 3.0, d
    err = np.linalg.norm(run.solutions[-1].rx_ecef_m - rx_true_ecef())
    assert err < 20.0, err


def test_streaming_windows_match_jax(fed):
    (ps, pmarks, pstarts), (js, jmarks, jstarts) = fed["port"], fed["jax"]
    assert pmarks == jmarks
    assert pstarts == jstarts and len(pstarts) >= 2
    assert _state(ps) == _state(js)
    assert ps.status_text() == js.status_text()
    # the tracked channels' positions and the chains' epoch counts
    for prt, jrt in zip(ps.chains, js.chains):
        assert (prt.done, prt.total) == (jrt.done, jrt.total)
        act = prt.trk.active_host
        assert act.any()
        assert np.array_equal(prt.trk.abs_start[act], jrt.trk.abs_start[act])


def test_control_plane_matches_jax(fed, capture):
    """Standby (and the inflow it drops), warm, hot and cold start on the
    fed sessions leave the same state in both packages."""
    (ps, _, _), (js, _, _) = fed["port"], fed["jax"]
    for cmd in ("standby",):
        assert ps.on_command(cmd) == js.on_command(cmd) == "OK standby"
    assert _state(ps) == _state(js)
    assert all(st == "IDLE" for st, _ in _state(ps)["channels"])
    assert ps.status_text() == js.status_text()
    assert ps.status_text().startswith("standby")
    k = JAX_FEEDS * STEP
    for s in (ps, js):
        s.feed(capture[k:k + 2 * STEP])        # dropped
    assert _state(ps) == _state(js)
    assert ps.cursor == ps._base == (JAX_FEEDS + 2) * STEP
    assert ps.on_command("warmstart") == js.on_command("warmstart")
    assert _state(ps) == _state(js)
    assert ps.status_text().startswith("running")
    # a planted fix: hotstart orders the pools by elevation from it
    for s, ephs in ((ps, _port_ephs()), (js, scenario_ephemerides())):
        s.last_fix = types.SimpleNamespace(rx_ecef_m=rx_true_ecef(),
                                           n_sats=6)
        s.last_fix_time = 345600.0 + 10.0
        s.ephemerides.update(ephs)
    assert ps.status_text() == js.status_text()
    assert ps.on_command("hotstart") == js.on_command("hotstart")
    assert _state(ps) == _state(js)
    assert _state(ps)["pools"][0][:6] != list(range(1, 7))
    assert ps.on_command("coldstart") == js.on_command("coldstart")
    assert _state(ps) == _state(js)
    assert not ps.ephemerides and ps.last_fix is None
    assert ps.on_command("bogus") == js.on_command("bogus")


def test_prioritize_visible_from_almanac_matches_jax():
    """A planted broadcast almanac (subframe 4/5 fields of the scenario's
    satellites and of two more) and a receiver position: the same visible
    list and pool order in both packages."""
    from gnss_sim_receiver_tpu.nav.ephemeris import make_sky_constellation
    ephs = make_sky_constellation(40.0, -75.0, toe=345600.0 + 600)[:10]
    alm = {e.prn: dict(toa=e.toe, af0=e.af0, af1=e.af1, sqrt_a=e.sqrt_a,
                       ecc=e.ecc, m0=e.m0_sc, omega=e.omega_sc,
                       omega0=e.omega0_sc, omega_dot=e.omega_dot_sc,
                       delta_i=e.i0_sc - 0.3) for e in ephs}
    out = []
    for s in (prx.ReceiverSession(_conf(prx), device="cpu"),
              jrx.ReceiverSession(_conf(jrx))):
        s.chains[0].tlm.almanac = dict(alm)
        vis = s.prioritize_visible(rx_ecef=rx_true_ecef(),
                                   t_gps_s=345600.0 + 30.0)
        out.append((vis, list(s.chains[0].mgr.pool)))
    assert out[0] == out[1]
    assert len(out[0][0]) >= 4
    eph = peph.almanac_to_ephemeris(3, alm[3])
    from gnss_sim_receiver_tpu.nav.ephemeris import almanac_to_ephemeris
    assert dataclasses.asdict(eph) == dataclasses.asdict(
        almanac_to_ephemeris(3, alm[3]))


def test_save_load_ephemerides_round_trip(tmp_path):
    ephs = _port_ephs()
    peph.save_ephemerides(tmp_path / "eph.json", ephs)
    back = peph.load_ephemerides(tmp_path / "eph.json")
    assert back == ephs
    from gnss_sim_receiver_tpu.nav.ephemeris import load_ephemerides
    jback = load_ephemerides(tmp_path / "eph.json")
    assert {p: dataclasses.asdict(e) for p, e in jback.items()} == \
        {p: dataclasses.asdict(e) for p, e in back.items()}


class _FakeControl:
    def __init__(self):
        self.commands = []

    def status_text(self):
        return "Current receiver status: 3 channels tracking, PVT valid"

    def on_command(self, name):
        self.commands.append(name)
        return f"OK: {name} executed"


def _send(port, lines):
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        fh = s.makefile("rw", newline="\n")
        out = []
        for line in lines:
            fh.write(line + "\n")
            fh.flush()
            out.append(fh.readline().strip())
        fh.write("exit\n")
        fh.flush()
        return out


def test_tcp_commands_roundtrip():
    ctl = _FakeControl()
    srv = TcpCmdServer(ctl)
    try:
        replies = _send(srv.port, ["status", "coldstart", "standby", "bogus"])
        assert "tracking" in replies[0]
        assert replies[1] == "OK: coldstart executed"
        assert replies[2] == "OK: standby executed"
        assert replies[3].startswith("ERROR")
        assert ctl.commands == ["coldstart", "standby"]
    finally:
        srv.close()


def test_tcp_multiple_clients():
    ctl = _FakeControl()
    srv = TcpCmdServer(ctl)
    try:
        a = _send(srv.port, ["reset"])
        b = _send(srv.port, ["hotstart"])
        assert a == ["OK: reset executed"]
        assert b == ["OK: hotstart executed"]
    finally:
        srv.close()


def test_tcp_drives_a_port_session():
    s = prx.Receiver(_conf(prx), device="cpu").start_session(
        ephemerides=_port_ephs())
    srv = TcpCmdServer(s)
    try:
        status, standby, again, hot = _send(
            srv.port, ["status", "standby", "status", "hotstart"])
        assert status.startswith("running") and "fix=none" in status
        assert standby == "OK standby" and again.startswith("standby")
        assert hot == "OK hotstart" and not s._standby
        assert len(s.ephemerides) == 6
    finally:
        srv.close()


def test_commands_beside_feeds(capture, threads):
    """Commands from eight client threads (more than the interpreter runs
    at once) while the main thread feeds 4 s, with a short switch
    interval: every reply is well formed and every command waits
    for the feed in progress (the session's lock), so after each feed the
    channels the manager tracks are the tracking engine's active ones."""
    s = prx.Receiver(_conf(prx), device="cpu").start_session(
        ephemerides=_port_ephs())
    srv = TcpCmdServer(s)
    replies, stop = [], threading.Event()

    def client(k):
        while not stop.is_set():
            replies.extend(_send(srv.port, [("status", "warmstart",
                                             "status", "hotstart")[k % 4]]))
    workers = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in workers:
            w.start()
        for k in range(4):
            s.feed(capture[k * STEP:(k + 1) * STEP])
            with s._lock:
                for rt in s.chains:
                    trk = [c.state == ChannelState.TRACKING
                           for c in rt.mgr.channels]
                    assert trk == rt.trk.active_host.tolist()
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30)
        sys.setswitchinterval(interval)
        srv.close()
    assert not any(w.is_alive() for w in workers)
    assert replies and all(r.startswith(("running", "OK warmstart",
                                         "OK hotstart")) for r in replies)


def test_refusals():
    l5 = dataclasses.replace(prx.gps_l5_chain(12.5e6, prns=(1,),
                                              n_channels=1),
                             rf_channel_id=1)
    conf = prx.ReceiverConf(fs=FS, rf_fs={1: 12.5e6}, chains=(l5,))
    s = prx.Receiver(conf, device="cpu").start_session()
    with pytest.raises(NotImplementedError, match="RF channel 1"):
        s.feed(np.zeros(1000, np.complex64))
    rx = prx.Receiver(_conf(prx), device="cpu")
    # collect_track_outputs is ported: every chain pulls every epoch's full
    # planes, and a run that tracked nothing collects none
    s = rx.start_session(collect_track_outputs=True)
    assert s.collected == [] and s.max_mult == 8
    assert all(rt.trk.full_outputs and rt.decim == 1 for rt in s.chains)
    run = rx.process_array(np.zeros(10, np.complex64),
                           collect_track_outputs=True)
    assert run.track_outputs is None and not run.solutions
    # base_observations is ported: a single-point session keeps it unused,
    # as JAX's; an RTK session needs it, and DGPS is implemented in neither
    s = rx.start_session(base_observations=object())
    assert s.rtk_eng is None and s.ppp_eng is None and s.pvt_ekf is None
    rtk_conf = _conf(prx)
    rtk_conf.pvt = dataclasses.replace(rtk_conf.pvt,
                                       positioning_mode="RTK_Static")
    with pytest.raises(ValueError, match="base_observations"):
        prx.Receiver(rtk_conf, device="cpu").start_session()
    rtk_conf.pvt = dataclasses.replace(rtk_conf.pvt, positioning_mode="DGPS")
    with pytest.raises(NotImplementedError, match="not implemented"):
        prx.Receiver(rtk_conf, device="cpu").start_session()
    s = rx.start_session()
    s.attach_array(np.zeros(1000, np.complex64))
    with pytest.raises(RuntimeError, match="array mode"):
        s.feed(np.zeros(10, np.complex64))
