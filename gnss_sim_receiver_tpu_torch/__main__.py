"""CLI: run the receiver on a CUDA card from a GNSS-SDR-style configuration
file.

PyTorch port of ``gnss_sim_receiver_tpu.__main__`` for a conf with any of
the JAX factory's signal chains: a GPS L1 C/A chain, a Galileo E1-B chain
or both (the hybrid operating point), GPS L5I and Galileo E5a-I chains
(the wideband operating point), and the L2C, E5b-I, E6-B, GLONASS,
BeiDou and SBAS L1 chains, with the PVT keys of the single-point fix
(iono and tropo models, RAIM, the PVT Kalman filter, Hatch smoothing) and
the PVT modes beyond it: PPP_Static / PPP_Kinematic, and RTK_Static /
RTK_Kinematic against a base station's RINEX observation file
(PVT.rtk_base_rinex_obs) at a known position (PVT.rtk_base_position_ecef
= "x,y,z" metres ECEF); the reference binary interface,
src/main/main.cc:119.  Like the JAX CLI it
attaches one stream, RF channel 0: a conf that puts a chain on another RF
channel (Channels_<sig>.RF_channel_ID) builds, then stops with "no stream
for RF channel(s)"; the session API (ReceiverSession.attach_arrays) takes
several.

  python -m gnss_sim_receiver_tpu_torch --config_file=rx.conf
        [--duration_s=N] [--signal_file=...] [--device=cpu]

conf file -> capture file -> SignalConditioner -> Receiver -> position.
Ephemerides print as the JAX CLI prints them: PRN ints for GPS,
("Galileo", prn) tuples for Galileo, sorted by their text.
Exit codes: 0 a position fix, 1 none, 2 a source, a conf key or an output
product that is not ported (the message names the key), the DGPS mode
(implemented in neither package), or an RTK conf without its base file or
base position (the JAX CLI's messages).  Without
``--device`` the run needs a CUDA card and raises when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from gnss_sim_receiver_tpu_torch.device import resolve_device
from gnss_sim_receiver_tpu_torch.models.conditioner import SignalConditioner
from gnss_sim_receiver_tpu_torch.models.control import ChannelState
from gnss_sim_receiver_tpu_torch.models.factory import (make_receiver,
                                                        source_from_config)
from gnss_sim_receiver_tpu_torch.models.outputs import read_rinex_obs
from gnss_sim_receiver_tpu_torch.models.receiver import \
    check_positioning_mode
from gnss_sim_receiver_tpu_torch.models.rtk import BaseObservations
from gnss_sim_receiver_tpu_torch.utils import geodesy
from gnss_sim_receiver_tpu_torch.utils.config import FileConfiguration
from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples

# keys that switch on what the port's CLI does not carry yet: assistance,
# the UDP monitors and every output product of the JAX CLI
_UNPORTED_FLAGS = (
    "GNSS-SDR.AGNSS_XML_enabled", "GNSS-SDR.SUPL_gps_enabled",
    "Monitor.enable_monitor", "NavDataMonitor.enable_monitor",
    "PVT.enable_monitor", "PVT.enable_monitor_ephemeris",
    "PVT.flag_nmea_tty_port", "PVT.nmea_output_file_enabled",
    "PVT.kml_output_enabled", "PVT.flag_kml",
    "PVT.gpx_output_enabled", "PVT.flag_gpx",
    "PVT.geojson_output_enabled", "PVT.flag_geojson",
    "PVT.xml_output_enabled", "PVT.rtcm_output_file_enabled",
    "PVT.rinex_output_enabled", "PVT.flag_rinex",
)
_UNPORTED_PRESENT = ("PVT.nmea_dump_filename",
                     "SignalSource.timestamp_filename")


@dataclasses.dataclass
class CliRun:
    """What one CLI run did: the exit code, the receiver's result (None
    when the run stopped before the receiver) and the seconds spent reading
    the file, uploading and conditioning it, and in the receiver."""
    exit_code: int
    run: object = None
    seconds: dict = dataclasses.field(default_factory=dict)


def unported_key(config) -> str | None:
    """The first conf key that enables something this CLI lacks."""
    for key in _UNPORTED_FLAGS:
        if config.property(key, False):
            return key
    for key in _UNPORTED_PRESENT:
        if config.is_present(key):
            return key
    return None


def run_cli(argv=None) -> CliRun:
    ap = argparse.ArgumentParser(prog="gnss_sim_receiver_tpu_torch")
    ap.add_argument("--config_file", "-c", required=True)
    ap.add_argument("--signal_file", default=None,
                    help="override SignalSource.filename")
    ap.add_argument("--duration_s", type=float, default=0.0,
                    help="limit processed signal duration")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises "
                         "without one); 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)

    config = FileConfiguration(args.config_file)
    device = resolve_device(args.device)
    src = source_from_config(config)
    if args.signal_file:
        src.filename = args.signal_file
    if src.implementation != "File_Signal_Source":
        print(f"SignalSource.implementation={src.implementation} is not "
              "ported; use File_Signal_Source", file=sys.stderr)
        return CliRun(2)
    key = unported_key(config)
    if key is not None:
        print(f"{key} enables a feature that is not ported", file=sys.stderr)
        return CliRun(2)
    try:
        rx = make_receiver(config, device=device)
        check_positioning_mode(rx.conf.pvt.positioning_mode)
    except NotImplementedError as e:
        print(e, file=sys.stderr)
        return CliRun(2)
    # RTK: the base observables from a RINEX obs file and the known base
    # position, with the JAX CLI's messages
    base_obs = None
    if rx.conf.pvt.positioning_mode.startswith("RTK"):
        base_path = config.property("PVT.rtk_base_rinex_obs", "")
        if not base_path:
            print("RTK mode needs PVT.rtk_base_rinex_obs", file=sys.stderr)
            return CliRun(2)
        if rx.conf.rtk_base_ecef_m is None:
            print("RTK mode needs PVT.rtk_base_position_ecef",
                  file=sys.stderr)
            return CliRun(2)
        epochs, prns_b, sys_b = read_rinex_obs(base_path)
        base_obs = BaseObservations(
            epochs=epochs, prns=prns_b, systems=sys_b,
            base_ecef_m=np.asarray(rx.conf.rtk_base_ecef_m))

    count = -1
    if args.duration_s > 0:
        count = int(args.duration_s * src.sampling_frequency)
    seconds = {}
    print(f"Reading {src.filename} ({src.item_type}) ...")
    t0 = time.perf_counter()
    x = read_samples(src.filename, src.item_type, count=count)
    seconds["read"] = time.perf_counter() - t0
    print(f"  {len(x)} samples at {src.sampling_frequency/1e6:.3f} Msps")

    t0 = time.perf_counter()
    cond = SignalConditioner(config, fs_in=src.sampling_frequency,
                             device=device)
    x = cond.process(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds["condition"] = time.perf_counter() - t0
    print(f"  conditioned -> {len(x)} samples at {cond.fs_out/1e6:.3f} Msps")

    t0 = time.perf_counter()
    run = rx.process_array(x, base_observations=base_obs)
    dt = seconds["receiver"] = time.perf_counter() - t0
    if run.rtk_solutions:
        n_fix = sum(1 for _, s in run.rtk_solutions if s.fixed)
        _, last = run.rtk_solutions[-1]
        print(f"RTK: {len(run.rtk_solutions)} epochs, {n_fix} fixed; "
              f"last baseline {last.baseline_m} (ratio {last.ratio:.1f})")
    tracked = [p for p, s in zip(run.channel_prns, run.channel_states)
               if s == ChannelState.TRACKING]
    print(f"Channels: PRNs {tracked}")
    print(f"Ephemerides decoded: {sorted(run.ephemerides, key=str)}")
    print(f"Processed {len(x)/cond.fs_out:.1f} s of signal in {dt:.1f} s "
          f"({len(x)/cond.fs_out/dt:.1f}x realtime)")
    print(f"Timing: read {seconds['read']:.3f} s, upload and conditioning "
          f"{seconds['condition']:.3f} s, receiver {dt:.3f} s")
    if not run.solutions:
        print("No position fix.")
        return CliRun(1, run, seconds)
    for s in run.solutions[-5:]:
        lat, lon, h = geodesy.ecef_to_llh(s.rx_ecef_m)
        print(f"  t={s.rx_time_corrected_s:.2f}  "
              f"lat={np.degrees(lat):.7f} lon={np.degrees(lon):.7f} "
              f"h={h:.1f}  sats={s.n_sats} gdop={s.gdop:.1f}")
    mean = np.mean([s.rx_ecef_m for s in run.solutions], axis=0)
    lat, lon, h = geodesy.ecef_to_llh(mean)
    print(f"Mean position: lat={np.degrees(lat):.7f} "
          f"lon={np.degrees(lon):.7f} h={h:.2f} m "
          f"({len(run.solutions)} fixes)")
    return CliRun(0, run, seconds)


def main(argv=None) -> int:
    return run_cli(argv).exit_code


if __name__ == "__main__":
    sys.exit(main())
