"""Probe, on one CUDA card, what the register cap costs the per-epoch chunk
kernel, and where an epoch of it goes.

    python3 tools/probe_epoch_chunk.py

Builds variants of the port's tracking libraries under
build/probe_epoch_chunk/ (one nvcc per unit, as ops/cuda_build.py does)
and prints, with the card's name and power limit:

1. the chunk kernel (csrc/epoch_chunk.cu) with and without the 128-register
   cap: its registers, CTAs per SM, cudaOccupancyMaxActiveClusters by
   cluster size for C = 10 channels, and microseconds per epoch at phase
   8's GPS chain (20 Msps, k_ext 20, T = 200) for clusters of 7, 8 and 13
   CTAs, every variant's planes and state bit-equal to the library's;
2. a clock64 breakdown of one epoch on the leader of channel 0 (the slabs,
   the first cluster barrier, the ordered sum, the closure, the second
   barrier), from a copy of the source with time stamps added.

(tools/probe_block_step.py probes the block step's fused launch.)

Needs the card; imports nothing of JAX.
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

from gnss_sim_receiver_tpu_torch.models import tracking as trk  # noqa: E402
from gnss_sim_receiver_tpu_torch.ops import cuda_build  # noqa: E402

OUT = ROOT / "build" / "probe_epoch_chunk"
C = 10
P, I = ctypes.c_void_p, ctypes.c_int

STAMPS = '''
__device__ long long g_stamps[64 * 6];
#define STAMP(i) if (c == 0 && leader && tid == 0 && e < 64) \\
    g_stamps[e * 6 + (i)] = clock64();
'''


def time_ms(fn, reps: int) -> float:
    """Median over 5 CUDA-graph replays of `reps` calls, per call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def build(tag: str, units, flags_of, edit=None) -> ctypes.CDLL:
    """Units of csrc/ (copied, optionally edited) compiled with
    flags_of(unit); with -rdc=true in the flags, device-linked."""
    d = OUT / tag
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, d)
    if edit:
        edit(d)
    nvcc = cuda_build.nvcc_path()
    lib = d / f"lib{tag}.so"
    rdc = "-rdc=true" in flags_of(units[0])
    procs = []
    for u in units:
        out = ["-c", "-o", str(d / f"{u}.o")] if rdc else [
            "-shared", "-o", str(lib)]
        procs.append(subprocess.Popen(
            [nvcc, *flags_of(u), *out, str(d / f"{u}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(log)
    if rdc:
        objs = [str(d / f"{u}.o") for u in units]
        subprocess.run([nvcc, *cuda_build.LINK_FLAGS, "-dlink", "-o",
                        str(d / "dlink.o"), *objs], check=True)
        subprocess.run([nvcc, *cuda_build.LINK_FLAGS, "-shared", "-o",
                        str(lib), *objs, str(d / "dlink.o")], check=True)
    return ctypes.CDLL(str(lib))


def epoch_flags(cap: bool):
    def flags(u):
        extra = cuda_build.SOURCE_FLAGS.get(u, ())
        if not cap:
            extra = tuple(f for f in extra if f not in cuda_build.EPOCH_REGS)
        return cuda_build.NVCC_FLAGS + cuda_build.RDC_FLAGS + extra
    return flags


def add_queries(d: Path) -> None:
    """The chunk kernel's registers and CTAs per SM, and the stamps."""
    p = d / "epoch_chunk.cu"
    s = p.read_text()
    s = s.replace("namespace cg = cooperative_groups;",
                  "namespace cg = cooperative_groups;\n" + STAMPS)
    s = s.replace("    const Inputs v = *lead_in;\n",
                  "    STAMP(0)\n    const Inputs v = *lead_in;\n")
    s = s.replace("    cluster_sync(cluster, n_cta);\n    if (leader && tid",
                  "    STAMP(1)\n    cluster_sync(cluster, n_cta);\n"
                  "    STAMP(2)\n    if (leader && tid")
    s = s.replace("      __syncwarp();\n      epoch_close<kForm>(",
                  "      __syncwarp();\n      STAMP(3)\n"
                  "      epoch_close<kForm>(")
    s = s.replace("      if (tid == 0) publish(in, st);\n    }\n"
                  "    cluster_sync(cluster, n_cta);\n  }",
                  "      if (tid == 0) publish(in, st);\n      STAMP(4)\n"
                  "    }\n    cluster_sync(cluster, n_cta);\n    STAMP(5)\n"
                  "  }")
    s += '''
extern "C" int probe_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, epoch_chunk_kernel<kFormLoop3>);
  out[0] = a.numRegs;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], epoch_chunk_kernel<kFormLoop3>, 256, 4096);
  return (int)e;
}
extern "C" int probe_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
'''
    p.write_text(s)


def chunk_case(dev):
    """Phase 8's GPS chain: tables, a state of C tracking channels, a noise
    capture of T = 200 epochs."""
    conf = trk.TrackingConf(fs=20e6, extend_correlation_symbols=20)
    eng = trk.TrackingEngine(conf, range(1, C + 1), device=dev)
    rng = np.random.default_rng(5)
    st = trk._init_state(C, dev)
    dop = rng.uniform(-4000, 4000, C).astype(np.float32)
    st = st._replace(
        active=torch.ones(C, dtype=torch.bool, device=dev),
        pos=torch.from_numpy(rng.integers(0, 1 << 20, C).astype(np.int32)
                             ).to(dev),
        carrier_doppler=torch.from_numpy(dop).to(dev),
        code_freq=torch.from_numpy((conf.code_rate_cps * (
            1 + dop / conf.carrier_freq_hz)).astype(np.float32)).to(dev))
    t = 200
    x = torch.from_numpy((rng.standard_normal(2 * ((1 << 20) + (t + 2)
                                                   * conf.block_size))
                          .astype(np.float32))).view(torch.complex64).to(dev)
    return conf, eng, st, x, t


def probe_chunk(dev) -> None:
    conf, eng, st, x, t = chunk_case(dev)
    ref = None
    for cap in (True, False):
        lib = build("chunk_cap" if cap else "chunk_nocap",
                    cuda_build.LIBRARIES["epoch_kernels"], epoch_flags(cap),
                    add_queries)
        lib.epoch_chunk.argtypes = [trk._EpochChunkArgs, I, I, P]
        lib.epoch_chunk_max_clusters.argtypes = [I, I, I, I,
                                                 ctypes.POINTER(I)]
        attrs = (I * 2)()
        lib.probe_attrs(attrs)
        launch = trk.chunk_launch(conf, t, eng.codes, eng.taps, x, st)
        k2, a = launch.plan.k2, launch.args
        n_out = eng.taps.shape[0]
        occ = {}
        for cl in range(1, 17):
            n = I()
            lib.epoch_chunk_max_clusters(cl, C, trk.epoch_chunk_smem(
                k2, n_out, cl), trk.FORM_LOOP3, ctypes.byref(n))
            occ[cl] = n.value
        label = "capped at 128" if cap else "uncapped"
        print(f"chunk kernel, registers {label}: {attrs[0]} registers, "
              f"{attrs[1]} CTAs per SM; max active clusters of C={C} by "
              f"size: {occ}")
        def stream():     # read inside a captured call: its side stream
            return torch.cuda.current_stream(dev).cuda_stream
        for cl in (7, 8, 13):
            smem = trk.epoch_chunk_smem(k2, n_out, cl)
            launch.n_c.copy_(trk._epoch_length(conf, st))  # rewritten
            assert lib.epoch_chunk(a, cl, smem, stream()) == 0
            torch.cuda.synchronize()
            got = [launch.planes[k].clone() for k, _ in trk.EPOCH_PLANES]
            got += [v.clone() for v in launch.state
                    if isinstance(v, torch.Tensor)]
            ref = ref or got
            same = all(torch.equal(g.view(torch.uint8), r.view(torch.uint8))
                       for g, r in zip(got, ref))
            ms = time_ms(lambda: lib.epoch_chunk(a, cl, smem, stream()), 2)
            stamps = np.zeros(64 * 6, np.int64)
            assert lib.probe_stamps(stamps.ctypes.data) == 0
            s = stamps.reshape(64, 6)[8:]
            part = np.diff(s, axis=1).mean(0)
            print(f"  S'={cl} ({-(-k2.slabs // cl)} rounds): "
                  f"{1e3 * ms / t:.2f} us per epoch, bits "
                  f"{'equal' if same else 'DIFFERENT'}; cycles per epoch "
                  f"{(s[1:, 0] - s[:-1, 0]).mean():.0f}: slabs {part[0]:.0f},"
                  f" barrier {part[1]:.0f}, ordered sum {part[2]:.0f}, "
                  f"closure {part[3]:.0f}, barrier {part[4]:.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_epoch_chunk: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    OUT.mkdir(parents=True, exist_ok=True)
    probe_chunk(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
