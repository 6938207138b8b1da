"""Channel FSM + acquisition manager (host-side control plane).

Mirrors the reference's per-channel state machine and satellite scheduling
(SURVEY.md section 2.2): channel states 0=idle, 1=acquiring, 2=tracking
(gnss_flowgraph.cc:1812-1878), events 0=ACQ_FAIL, 1=ACQ_SUCCESS,
2=TRK_LOST (gnss_flowgraph.cc:1882-1903, dll_pll event 3 mapped in), a cap
on concurrent acquisitions (Channels.in_acquisition -> max_acq_channels_),
and round-robin PRN reassignment from a per-signal availability deque
(set_signals_list / search_next_signal, gnss_flowgraph.cc:2158-2750).

Copy of ``gnss_sim_receiver_tpu.models.control`` for the PyTorch port, with
the standard ``logging`` module in place of the JAX package's glog shim.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging

_log = logging.getLogger("gnss_sim_receiver_tpu_torch.control")


class ChannelState(enum.IntEnum):
    IDLE = 0
    ACQUIRING = 1
    TRACKING = 2


class ChannelEvent(enum.IntEnum):
    ACQ_FAIL = 0
    ACQ_SUCCESS = 1
    TRK_LOST = 2


@dataclasses.dataclass
class ChannelStatus:
    state: ChannelState = ChannelState.IDLE
    prn: int = 0
    acq_doppler_hz: float = 0.0
    acq_fail_count: int = 0


class AcquisitionManager:
    """Assigns satellites to channels and reacts to channel events.

    The availability deque rotates front->back like the reference's
    search_next_signal(); a satellite lost from tracking is pushed back to
    the pool (apply_action event 2, gnss_flowgraph.cc:1924-1989)."""

    def __init__(self, prns, n_channels: int, max_acq_channels: int = 2,
                 max_acq_fails_per_prn: int = 3, pinned: dict | None = None):
        """`pinned` maps channel index -> PRN for channels dedicated to one
        satellite (the reference's Channel<i>.satellite pinning,
        gnss_flowgraph.cc:1391-1415 assign_channels): a pinned channel only
        ever acquires its own PRN, and that PRN never enters the shared
        rotation pool."""
        self.pinned = {int(c): int(p) for c, p in (pinned or {}).items()}
        pinned_prns = set(self.pinned.values())
        self.pool = collections.deque(int(p) for p in prns
                                      if int(p) not in pinned_prns)
        self.channels = [ChannelStatus() for _ in range(n_channels)]
        self.max_acq = max_acq_channels
        self.max_fails = max_acq_fails_per_prn
        self.events: list[tuple[int, ChannelEvent]] = []

    # -- queries -------------------------------------------------------------
    def tracking_channels(self):
        return [i for i, c in enumerate(self.channels)
                if c.state == ChannelState.TRACKING]

    def acquiring_channels(self):
        return [i for i, c in enumerate(self.channels)
                if c.state == ChannelState.ACQUIRING]

    def in_use_prns(self):
        return {c.prn for c in self.channels
                if c.state != ChannelState.IDLE}

    # -- scheduling ----------------------------------------------------------
    def schedule(self) -> list[int]:
        """Move idle channels into ACQUIRING (up to max_acq concurrent),
        assigning the next available PRN each (acquisition_manager,
        gnss_flowgraph.cc:1797-1878).  Returns newly armed channels."""
        armed = []
        busy = len(self.acquiring_channels())
        # pinned channels first (assign_channels puts them ahead of the
        # rotation, gnss_flowgraph.cc:1391-1415)
        for i, prn in self.pinned.items():
            ch = self.channels[i]
            if busy >= self.max_acq:
                break
            if ch.state == ChannelState.IDLE:
                ch.state = ChannelState.ACQUIRING
                ch.prn = prn
                ch.acq_fail_count = 0
                armed.append(i)
                busy += 1
        for i, ch in enumerate(self.channels):
            if busy >= self.max_acq or not self.pool:
                break
            if ch.state == ChannelState.IDLE and i not in self.pinned:
                prn = self._next_prn()
                if prn is None:
                    break
                ch.state = ChannelState.ACQUIRING
                ch.prn = prn
                ch.acq_fail_count = 0
                armed.append(i)
                busy += 1
        return armed

    def _next_prn(self):
        used = self.in_use_prns()
        for _ in range(len(self.pool)):
            prn = self.pool[0]
            self.pool.rotate(-1)
            if prn not in used:
                return prn
        return None

    # -- event handling (apply_action analogue) ------------------------------
    def on_acq_result(self, channel: int, detected: bool,
                      doppler_hz: float = 0.0) -> ChannelEvent:
        ch = self.channels[channel]
        if detected:
            ch.state = ChannelState.TRACKING
            ch.acq_doppler_hz = doppler_hz
            ev = ChannelEvent.ACQ_SUCCESS
            _log.info("ch %d PRN %d acquisition OK (doppler %.0f Hz)",
                      channel, ch.prn, doppler_hz)
        else:
            ch.acq_fail_count += 1
            _log.debug("ch %d PRN %d acquisition failed (%d)",
                       channel, ch.prn, ch.acq_fail_count)
            if ch.acq_fail_count >= self.max_fails:
                # rotate to another satellite (failed_acquisition_no_repeat)
                ch.state = ChannelState.IDLE
                ch.prn = 0
            ev = ChannelEvent.ACQ_FAIL
        self.events.append((channel, ev))
        return ev

    def on_tracking_lost(self, channel: int) -> ChannelEvent:
        """Loss-of-lock: satellite returns to the pool, channel re-enters
        acquisition scheduling (event 2 path)."""
        ch = self.channels[channel]
        _log.warning("ch %d PRN %d loss of lock", channel, ch.prn)
        ch.state = ChannelState.IDLE
        ch.prn = 0
        self.events.append((channel, ChannelEvent.TRK_LOST))
        return ChannelEvent.TRK_LOST
