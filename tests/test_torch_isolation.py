"""Guards of the PyTorch port: it stands alone, it never runs quietly on the
CPU, and its state carries across intact.

- no file of gnss_sim_receiver_tpu_torch/ nor chip_smoke.py imports jax or
  gnss_sim_receiver_tpu (an AST scan);
- the port acquires and tracks in a process where both names cannot be
  imported;
- the entry points raise without a card unless device="cpu" is passed;
- chip_smoke.py fails, printing no result line, without a card and in a
  directory that holds nothing else of the repo;
- interop round-trips a TrackState and the acquisition tables exactly.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnss_sim_receiver_tpu_torch import interop
from gnss_sim_receiver_tpu_torch.models.acquisition import (
    AcqConf, PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu_torch.models.receiver import Receiver, ReceiverConf
from gnss_sim_receiver_tpu_torch.models.tracking import (TrackingConf,
                                                         TrackingEngine,
                                                         _arm_channel,
                                                         _init_state)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "gnss_sim_receiver_tpu")


def _port_files():
    files = sorted((ROOT / "gnss_sim_receiver_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "gnss_sim_receiver_tpu"):
    sys.modules[name] = None          # any import of them now raises
import numpy as np, torch
from gnss_sim_receiver_tpu_torch.models.acquisition import (
    AcqConf, PcpsAcquisitionEngine)
from gnss_sim_receiver_tpu_torch.models import tracking as trk
from gnss_sim_receiver_tpu_torch.sim.signal_generator import (
    SatelliteSignalParams, generate_baseband)
fs = 2e6
sat = SatelliteSignalParams(prn=7, cn0_db_hz=50.0, doppler_hz=1500.0,
                            delay_chips=300.0, nav_bits=np.ones(4, np.int8))
x = generate_baseband([sat], fs, 60000, noise=True, seed=3)
eng = PcpsAcquisitionEngine(AcqConf(fs_in=fs, max_dwells=2), [7, 8],
                            device="cpu")
res = eng.acquire_from(x, 0)
assert list(res.detected) == [True, False], res
te = trk.TrackingEngine(trk.TrackingConf(fs=fs), [7], device="cpu")
te.start_tracking(0, float(res.doppler_hz[0]), int(res.delay_samples[0]))
outs = te.process_end(te.process_begin(x, 0, 20, decim=10))
assert outs["valid_full"].all() and outs["sample_counter"].shape == (2, 1)
# the conf-driven path: CLI module, factory, conditioner and its kernels'
# plain versions
from gnss_sim_receiver_tpu_torch import __main__ as cli
from gnss_sim_receiver_tpu_torch.models.conditioner import SignalConditioner
from gnss_sim_receiver_tpu_torch.models.factory import (
    receiver_conf_from_config)
from gnss_sim_receiver_tpu_torch.utils.config import InMemoryConfiguration
conf = InMemoryConfiguration({
    "InputFilter.implementation": "Freq_Xlating_Fir_Filter",
    "InputFilter.decimation_factor": "2", "InputFilter.IF": "250000",
    "Resampler.implementation": "Mmse_Resampler",
    "Resampler.sample_freq_out": "750000",
    "Acquisition_1C.make_two_steps": "true"})
y = SignalConditioner(conf, fs_in=fs, device="cpu").process(x)
assert y.shape == (22500,) and bool(torch.isfinite(y.abs()).all())
assert receiver_conf_from_config(conf).acq.make_two_steps
assert cli.unported_key(conf) is None
assert not any(m.split(".")[0] in ("jax", "jaxlib")
               for m in sys.modules if sys.modules[m] is not None)
print("OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


@pytest.mark.parametrize("entry", ["receiver", "acquisition", "tracking"])
def test_entry_points_need_a_card_or_cpu_by_name(entry):
    """device=None means the card: without one the entry point raises
    instead of running the plain versions quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is the "
                    "CPU machines'")
    make = {"receiver": lambda d: Receiver(ReceiverConf(fs=2e6), device=d),
            "acquisition": lambda d: PcpsAcquisitionEngine(
                AcqConf(fs_in=2e6), [1], device=d),
            "tracking": lambda d: TrackingEngine(TrackingConf(), [1],
                                                 device=d)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(None)
    assert make("cpu").device.type == "cpu"


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_interop_round_trip():
    st = _init_state(3, "cpu")
    st = _arm_channel(st, 1, -1234.5, 1.023e6 - 0.8)
    st = st._replace(pos=torch.tensor([5, -7, 123456], dtype=torch.int32),
                     prompt_prev=torch.tensor([1 + 2j, -3j, 0.5],
                                              dtype=torch.complex64))
    arrays = interop.track_state_to_numpy(st)
    assert "dll.vel" in arrays and "cn0_acc.sum_m4" in arrays
    back = interop.track_state_from_numpy(arrays, "cpu")
    for a, b in zip(interop.track_state_to_numpy(back).values(),
                    arrays.values()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back.pos.dtype == torch.int32
    assert back.prompt_prev.dtype == torch.complex64
    tables = {"code_fft_conj": np.array([[1 + 1j, 2 - 1j]], np.complex64),
              "dopplers": np.array([-250.0, 0.0, 250.0], np.float32)}
    t = interop.acq_tables_from_numpy(tables, "cpu")
    back = interop.acq_tables_to_numpy(t)
    for k in tables:
        assert back[k].dtype == tables[k].dtype
        assert np.array_equal(back[k], tables[k])
