"""Probe, on one CUDA card, where the block step's time goes inside the fused
launch (K1 with K8b's closure and the next block's prologue).

    python3 tools/probe_block_step.py

Builds a copy of the block library (csrc/block_correlator.cu, which
includes csrc/block_step.cu) under build/probe_block_step/ with clock64
stamps added, as ops/cuda_build.py builds it (one whole-program unit), and
prints, with the card's name and power limit, at phase 4's GPS shape (2
Msps, C = 8, E = 20, K = 3) and phase 5's Galileo E1 shape (20 Msps, C =
10, E = 5, K = 5):

1. the fused kernel's registers and CTAs per SM;
2. cycles on channel 0's last-arriving CTA, averaged over 18 folded
   launches: the ordered sum of the slabs, the closure (warp 0's sections:
   discriminators and means, loop filters, FLL median, lock and C/N0,
   carrier phase, commit; warp 1's bit sync; warp 2's plane rows; when
   warp 0 published the next omega) and the next block's vectors; on the
   channel's first CTA to arrive, its wait for the next omega and its
   share of the next replica;
3. the same closure sections in the standalone K8b, for comparison.

The stamps are taken on lane 0 of each warp of channel 0; every stamp is
a clock64 read, so each section is a difference on one SM.  Needs the
card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gnss_sim_receiver_tpu_torch import signals  # noqa: E402
from gnss_sim_receiver_tpu_torch.models import tracking as trk  # noqa: E402
from gnss_sim_receiver_tpu_torch.models import tracking_block as tb  # noqa: E402
from gnss_sim_receiver_tpu_torch.models.receiver import \
    galileo_e1b_chain  # noqa: E402
from gnss_sim_receiver_tpu_torch.ops import cuda_build, prn_codes  # noqa: E402

OUT = ROOT / "build" / "probe_block_step"
N_STAMPS = 24
REPS = 20
# warp 0's sections of block_close: a stamp before each of these comments,
# and one at its end (6)
CLOSE_AT = ("  // ---- per-epoch discriminators", "  // ---- loop filters",
            "  // ---- FLL pull-in", "  // ---- lock / C/N0",
            "  // ---- carrier phase", "  // ---- masked commit")
CLOSE_SECTIONS = ("discriminators, means", "loop filters", "FLL median",
                  "lock, C/N0", "carrier phase", "commit")


def add_stamps(d: Path) -> None:
    """clock64 stamps on channel 0: warp 0's sections of block_close
    (stamps 0-6), warp 1's bit sync (7, 8), warp 2's plane rows (9, 10),
    the fold's publication of the next omega (11), and the fused tail: the
    ordered sum (12, 13), the closure's end (14), the next vectors (15);
    on the first CTA of channel 0 to arrive, its wait for the next omega
    (16, 17) and its share of the next replica (17, 18); and the entry
    points that read them and the fused kernel's attributes."""
    def insert(s, anchor, text, after=False):
        assert s.count(anchor) == 1, anchor
        return s.replace(anchor, anchor + text if after else text + anchor)
    p = d / "block_step.cu"
    s = p.read_text()
    s = s.replace("namespace {\n", f"""__device__ long long g_stamps[{N_STAMPS}];
#define STAMPT(i, t) if (c == 0 && threadIdx.x == (t)) g_stamps[i] = clock64();
#define STAMP(i) STAMPT(i, 0)
namespace {{
""", 1)
    for i, anchor in enumerate(CLOSE_AT):
        s = insert(s, anchor, f"  STAMP({i})\n")
    s = insert(s, "  d.ext_n[c] = act ? (ext_n + 1 < 10000 ? ext_n + 1 : 10000) "
               ": ext_n;\n", "  STAMP(6)\n", after=True)
    s = insert(s, "  const float sign_e = l.prompt.x >= 0.0f", "  STAMPT(7, 32)\n")
    s = insert(s, "  d.bit_phase[c] = newly_bit ? top : s.bit_phase[c];\n",
               "  STAMPT(8, 32)\n", after=True)
    s = insert(s, "  const float cn0_db = close_lock(a, l).y;\n",
               "  STAMPT(9, 64)\n")
    s = insert(s, "  a.planes.valid[o] = l.act ? 1 : 0;\n", "  STAMPT(10, 64)\n",
               after=True)
    s = insert(s, '"r"(gen + 1u) : "memory");\n', "    STAMP(11)\n", after=True)
    p.write_text(s)
    p = d / "block_correlator.cu"
    s = p.read_text()
    s = insert(s, "  __threadfence();\n  for (int i = threadIdx.x; i < 2 * row_len;",
               "  STAMP(12)\n")
    s = insert(s, "  if (threadIdx.x == 0) arrivals[c] = 0u;", "  STAMP(13)\n")
    s = insert(s, "      __syncthreads();                 // the next state is "
               "committed\n", "      STAMP(14)\n", after=True)
    s = insert(s, "      prologue_vectors(next, c, threadIdx.x, "
               "prologue_state(next, c));\n",
               "      STAMP(15)\n", after=True)
    first = "if (c == 0 && threadIdx.x == 0 && ticket == 0) g_stamps[{}] = clock64();\n"
    s = insert(s, "        while (ld_acquire(flags + c) == gen) __nanosleep(64);\n",
               "        " + first.format(16))
    s = insert(s, "        s_omega = __ldcg(next.out.omega + c);\n",
               "        " + first.format(17), after=True)
    s = insert(s, "(int)((long long)(t + 1) * nfft / (n_slabs - 1)),\n"
               "                       threadIdx.x, kThreads);\n",
               "      " + first.format(18), after=True)
    s += '''
extern "C" int probe_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
extern "C" int probe_attrs(int n_taps, int* out) {
  auto k = n_taps <= 3 ? block_corr_kernel<kEpochsPerPass, 3, true>
                       : block_corr_kernel<kEpochsPerPass, 5, true>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, kThreads, 0);
  return (int)e;
}
'''
    p.write_text(s)


def build() -> ctypes.CDLL:
    d = OUT / "stamped"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, d)
    add_stamps(d)
    lib = d / "libprobe_block_step.so"
    r = subprocess.run([cuda_build.nvcc_path(),
                        *cuda_build.nvcc_flags("block_correlator"), "-shared",
                        "-o", str(lib), str(d / "block_correlator.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stdout + r.stderr)
    return tb.bind(ctypes.CDLL(str(lib)))


def case(dev, conf, c: int, taps, provider, n_wins: int):
    """K8a's outputs, a state, window spectra and the replica spectrum of
    a noise chunk at `conf`'s block shape."""
    rng = np.random.default_rng(7)
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        provider(p), conf.fs, conf.code_rate_cps, s0, 8)
        for p in range(1, c + 1)])
    codes_rep = tb.code_spectra(conf, tables, dev)
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
    st = trk._init_state(c, dev)
    dop = rng.uniform(-4000, 4000, c).astype(np.float32)
    st = st._replace(
        active=torch.ones(c, dtype=torch.bool, device=dev),
        pos=torch.from_numpy(rng.integers(0, (n_wins - e - 1) * s0, c)
                             .astype(np.int32)).to(dev),
        carrier_doppler=torch.from_numpy(dop).to(dev),
        code_freq=torch.from_numpy((conf.code_rate_cps * (
            1 + dop / conf.carrier_freq_hz)).astype(np.float32)).to(dev))
    x = torch.from_numpy(rng.standard_normal(2 * (n_wins * s0 + nfft))
                         .astype(np.float32)).view(torch.complex64).to(dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    pro = tb.block_prologue(conf, e, codes_rep, taps_t, xf_all.shape[0], st)
    rf = torch.fft.fft(pro.rep_t, dim=-1)
    return e, codes_rep, taps_t, st, xf_all, pro, rf


def probe(dev, lib, label, conf, c, taps, provider, n_wins) -> None:
    e, codes_rep, taps_t, st, xf_all, pro, rf = case(dev, conf, c, taps,
                                                     provider, n_wins)
    k = len(taps)
    nfft = codes_rep.shape[1]
    attrs = (ctypes.c_int * 3)()
    lib.probe_attrs(k, attrs)
    sc = tb.k1_scratch(c, e, k, nfft, dev)
    corr = torch.empty((c, e, k), dtype=torch.complex64, device=dev)
    planes = tb._empty_planes(e, c, dev)
    new = tb._empty_state(st)
    nxt = tb._empty_prologue(c, e, nfft, k, dev)
    k1 = tb._k1_args(xf_all, rf, pro.w0, pro.lag_int, pro.lag_frac,
                     pro.ph_sc, pro.tap_samps, pro.omega, corr, sc)
    close = tb._closure_args(conf, e, corr, pro, st, new, planes)
    fold = ctypes.pointer(tb._prologue_args(conf, e, codes_rep, taps_t,
                                            xf_all.shape[0], new, nxt))
    stamps = np.zeros(N_STAMPS, np.int64)
    fused, alone = [], []
    for _ in range(REPS):
        cuda_build.check(lib.block_correlate_close(
            *k1[:-1], close, 0, fold, sc.flags.data_ptr(), k1[-1]),
            "probe fused")
        torch.cuda.synchronize()
        assert lib.probe_stamps(stamps.ctypes.data) == 0
        fused.append(stamps.copy())
        cuda_build.check(lib.block_closure(close, 0, k1[-1]), "probe K8b")
        torch.cuda.synchronize()
        assert lib.probe_stamps(stamps.ctypes.data) == 0
        alone.append(stamps.copy())
    f = np.mean(fused[2:], 0)
    a = np.mean(alone[2:], 0)
    print(f"{label} (C={c}, E={e}, K={k}, F={nfft}, "
          f"S={sc.partials.shape[1]}): fused kernel {attrs[0]} registers, "
          f"{attrs[1]} B local, {attrs[2]} CTAs per SM")
    print(f"  fused, last CTA of channel 0, cycles: ordered sum of the slabs "
          f"{f[13] - f[12]:.0f}, closure {f[14] - f[13]:.0f} (the next omega "
          f"published {f[11] - f[13]:.0f} in), next vectors "
          f"{f[15] - f[14]:.0f}; the first CTA to arrive waits "
          f"{f[17] - f[16]:.0f} for the next omega, then writes its share "
          f"of the next replica in {f[18] - f[17]:.0f}")
    for what, v in (("fused", f), ("standalone K8b", a)):
        print(f"  closure in the {what}, cycles: warp 0 {v[6] - v[0]:.0f} ("
              + ", ".join(f"{n} {x:.0f}" for n, x in
                          zip(CLOSE_SECTIONS, np.diff(v[:7])))
              + f"), warp 1 bit sync {v[8] - v[7]:.0f}, warp 2 plane rows "
              f"{v[10] - v[9]:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_block_step: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    lib = build()
    e1 = galileo_e1b_chain(20e6).trk
    probe(dev, lib, "GPS L1 C/A at 2 Msps", trk.TrackingConf(fs=2e6), 8,
          (0.25, 0.0, -0.25), prn_codes.gps_l1_ca_code, 1000)
    d, dv = e1.early_late_space_chips, e1.very_early_late_space_chips
    e1_taps = (dv, d / 2, 0.0, -d / 2, -dv)
    probe(dev, lib, "Galileo E1-B at 20 Msps", e1, 10, e1_taps,
          signals.CodeProvider("1B"), 250)
    return 0


if __name__ == "__main__":
    sys.exit(main())
