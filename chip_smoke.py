#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the GNSS receiver on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions;
2. build every kernel from the sources in this checkout (the CUDA C++
   libraries, one ``nvcc`` per source in parallel, and the block library
   a second time with ``--fmad=false`` into a directory of its own; the
   Triton kernels compile at their first launch).  Two child processes
   meanwhile synthesize the captures of phases 4 and 4c into ``build/``
   (outside every timed window);
3. each kernel (the per-epoch closure K9 first, at four shapes, with
   K2's data-table form; then the chunk kernel, K9 redesigned as one
   launch per chunk, against the two-launch chunk, K2 then K9 per epoch,
   bit for bit over 50 epochs at four shapes, timed per chunk and per
   epoch by graph replay and on the host, then at C = 300 channels, more
   than the card keeps resident, in waves of clusters, and a 50-epoch
   chunk of phase 8's E1 pilot chain through it and through the plain
   loop; the block
   step K8a and K8b next, at four shapes, bit for bit against their plain
   versions and against the --fmad=false build, each with K1 and K8b
   fused held bit for bit against K1 then K8b, and with the next block's
   prologue folded in against K1, K8b, then K8a; the two-launch block
   chunk (K8a once, then the cuFFT and the folded launch per block)
   against the three-launch chunk and the plain chunk, bit for bit over
   50 blocks at the same four shapes; the same checks of the pilot form
   (K8a's two replica families, K1's data prompt, K8b's CS25 sync; K8b
   and the chunk within their tolerances of the plain versions where the
   bits part) at phase 8c's E1 shape and at 4 Msps, a planted CS25 sync
   that the fused launch must reach at the same block, offset and
   polarity as the plain step, then the same from a planted sign history
   one and two signs off the code (the sync threshold: they must sync at
   blocks 3 and 2, not earlier), and of the GPS block step at phase 10's
   3 Msps and phase 11's 8 Msps; the assisted search at phase 11's L5
   shape (the K3b wipe on a [C, 9] table and K3's row kernel, with the
   mean-pool decimation's time beside); K1 and
   K2 with the GPS and the Galileo E1 tables, K3 wipeoff and peak, K3b,
   K4a in both modes, K4b fold and resolve (the resolve, one CUDA launch,
   also against the Triton kernel it replaced, at C=8, fold 4 and at
   C=10, fold 8 with an exact tie, beside an empty kernel's launch
   floor), K4c with and without its
   Doppler boxcar, K3c (the first-vs-second-peak statistic) in its plain,
   dual and CAF forms on K3's, K4a's and K4c's correlations (the plain
   form, one CUDA launch, also bit for bit the three Triton launches it
   replaced, at phase 4's shape, N = 4000, the ROC harness's C = 384,
   N = 20000, 40000, 2001 and 800001, and on planted ties, peaks at the
   row's ends and zones covering the row), K5a, K5b
   (the single-pass scan, also at a narrow notch and, at 4 M and 104 M
   samples, against the three-launch kernel it replaced, both timed),
   K5c, K5d in both modes, K6 (also bit for bit the kernel before its
   redesign, one thread per sample, noiseless and with the phases' noise
   key, on the first and the last chunk of the hybrid, full-chain and
   wideband scenarios; both timed), K3's row kernel alone at phase 9's
   Doppler-sharded shape, K7's overlap-save fold (CUDA, bit for bit the
   Triton kernel it replaced) at phase 9's shape, at L = 4 N, at an odd N
   and at L = N, K10a and K10b, the sigma-point filters' kernels, at
   4096 filters of 4 and of 9 states under both rules, of 1 state
   (phase 9b's tanh filters), of 32 and of 16 states and measurements,
   at 4097 filters, on a P that is not positive definite, a pivot tie
   and the unscented rule's negative centre weight, each also bit for
   bit the one-warp-a-filter kernels they replaced and timed beside
   them in turns, beside an empty kernel on their grid and beside
   torch.linalg.cholesky_ex and solve_ex) against its
   plain PyTorch version on the card at the shape its path
   launches it at, with the stated tolerance, and its time there beside
   the plain version's and its bound (K1 and K2, which split each channel
   over S CTAs and reduce in-launch, also launched twice for bit-identical
   results, their arrival counters read back at 0 after the timing, K1
   with two window starts out of range, K2's staged-table misses
   printed); other shapes of the same kernels
   (the ``other_shapes`` line: among them K1, K2, K3, K3b and K6 at phase
   7's shapes, and K3's peak at phase 5's GPS search, N = 20000); once
   phase 4's capture is written, one 50-block chunk of
   phase 4's path through the kernels and through the plain block body;
4. the main path, conf-driven: the repo's 26 s static scenario at 4 Msps
   (synthesized by the port's own simulator, written as an ``ishort``
   file) goes through ``python -m gnss_sim_receiver_tpu_torch
   --config_file=...`` called in process: file -> SignalConditioner (x2
   decimating FIR, K5a) -> Receiver with two-step acquisition (K3, K3b)
   and tracking (K8a once a chunk, K1 with K8b and the next block's
   prologue fused; the chunk kernel on the chunk tails) -> position,
   with every launch counter set to 0 just before and read just after;
   the tracked PRNs, the fix count and the mean position error are
   checked against the scenario;
4b. the conditioner alone on the first 4 M samples, through pulse
   blanking (K5c), FIR + direct resampler and the linear resampler (K5d),
   and on the 1 M samples of phase 3's notch check through the notch (K5b):
   counters read the same way, every output held against the plain
   versions on the same input;
4c. the array entry point, ``Receiver(ReceiverConf(fs=2e6, prns=1..10,
   max_channels=8)).process_array(x)`` on an 8 s capture at 2 Msps: the
   tracked set and the launches of K1, K2 and K3 are checked;
4d. phase 4's conf and capture with QuickSync acquisition (K4b) through the
   CLI to a position; then the Tong and Fine Doppler engines on the
   card-resident 2 Msps capture: the scenario's PRNs detected, each result
   equal to the same engine's plain run on the same samples;
4e. phase 4's conf with use_CFAR_algorithm=false, pfa=0 and a fixed
   threshold through the CLI to a position (K3c on the coarse searches,
   K3's peak kernel on the narrow grids); phase 4's checks; then the Tong
   and Fine Doppler engines under that statistic, with
   bit_transition_flag under CFAR, and with both, each equal to its plain
   run;
4f. the ROC harness (models/acq_performance.py, the trials as K3's
   channel axis) at tests/test_acq_performance.py's size under its
   bounds, and one 384-trial batch under the first-vs-second statistic
   against the plain statistic;
5. the hybrid path at the reference conf's 20 Msps: the 26 s hybrid
   scenario (GPS PRNs 1, 3, 4, 5 and Galileo PRNs 11-15) synthesized on the
   card by the device generator (K6), quantized there and written as an
   ``ibyte`` file, then through the CLI with a GPS L1 C/A + Galileo E1-B
   conf (10 + 10 channels, CCCWSR acquisition on E1, K4a; 5-tap VEML
   tracking through K1 and K2) to a joint position: the tracked sets, the
   ephemerides, the fixes and the mean position error are checked, the
   counters read as in phase 4;
5b. the E1 chain's 8 ms acquisition (K4a) on the card-resident hybrid
   capture: PRNs 11-15 detected, every cell equal to the plain version's;
5c. its CCCWSR and 8 ms acquisitions with use_CFAR_algorithm=false and the
   fixed threshold (K3c's dual form) on the same capture, the same
   checks;
6. the full chain of bench.py: the 12-satellite, 120 s scenario at 2 Msps
   made on the card by the device generator (K6) and kept there, through
   ``Receiver(ReceiverConf(fs=2e6, prns=1..12, max_channels=12,
   max_acq_channels=12, pvt_rate_ms=500)).process_array(x)`` once: the
   tracked set, the fixes and the mean position error are checked, the
   real-time factor printed;
7. the wideband path at 20 Msps: a GPS L5 + Galileo E5a scenario (GPS
   PRNs 1, 3, 4, 5 on L5 with CNAV, Galileo PRNs 11-15 on E5a-I with
   F/NAV, phase 5's geometry, 48 dB-Hz) made on the card by the device
   generator (K6) for 60 s (an F/NAV page carries one word every 10 s and
   words 1-4 repeat every 40 s), written as an ``ibyte`` file, then
   through the CLI with a GPS L5I + Galileo E5a conf (10 + 10 channels,
   Galileo_E5a_Noncoherent_IQ_Acquisition_CAF with a 500 Hz CAF window,
   K4c; two-step PCPS on L5, K3 and K3b; tracking through K1 and K2) to a
   joint position: the tracked sets, the CNAV and F/NAV ephemerides, the
   fixes and the mean position error checked, the counters read as in
   phase 4;
8. the hybrid pilot path at 20 Msps: phase 5's scenario with E1-B and E1-C
   (CS25) on every Galileo satellite, each at -3 dB, made on the card by
   K6 and kept there, through the array entry point's session with phase
   5's conf, GPS tracking at extend_correlation_symbols=20 and the E1
   chain galileo_e1b_chain(track_pilot=True,
   extend_correlation_symbols=5) (E1-C pilot loops with CS25 sync, the
   E1-B data prompt for I/NAV): per-epoch tracking, one launch of the
   chunk kernel per chunk; phase 5's checks, every channel synced, the
   chunk kernel's epochs = the epochs run and its launches = the chunks
   dispatched, the real-time factor printed;
8c. phase 8's capture again, both chains at extend_correlation_symbols=1:
   GPS on the block kernels, the E1 chain
   (galileo_e1b_chain(track_pilot=True)) on their pilot form; phase 8's
   checks and its tracked sets, ephemerides and fixes kept, every tracked
   E1 channel secondary-synced, the pilot form's launches on the E1 chain
   and the chunk kernel on the chunk tails only;
8b. phase 4's conf with Tracking_1C.extend_correlation_symbols=20 through
   the CLI on phase 4's file: phase 4's checks, the chunk kernel alone;
9. the sharded steps (parallel.shard_steps, K7) on one rank over NCCL,
   the process group made once: per-epoch tracking (the chunk kernel) and
   block tracking (K8a, then cuFFT and the fused launch per block) of
   192 GPS L1 C/A channels at 2 Msps (50 epochs, 50 blocks of 20), the
   Doppler-sharded cold start over all 32 PRNs (2 dwells of 1 ms, 41 bins
   of 250 Hz; K3's wipe and row kernel) and the time-sharded overlap-save
   grid over 127 code periods of PRN 7 (K3's wipe, cuFFT, K7's fold),
   and the block step's pilot form (phase 8c's E1 chain, 10 channels, 20
   blocks).
   One card is a world of one (NCCL refuses two ranks on one card), so
   every collective is a copy: each step must equal the unsharded call of
   the same port functions bit for bit; nothing here shows scaling.  The
   Doppler search's cells must be the plain grid's at the scenario's
   satellites, the overlap-save grid within 2e-4 of its plain version and
   at the injected delay and Doppler; each step's counters (its kernels,
   the NCCL calls) and host seconds are printed;
9b. the sigma-point filters (ops.nonlinear, K10a and K10b around
   torch.func.vmap of the model): 40 steps of 4096 independent filters
   of tests/test_nonlinear.py's linear system under both rules, within
   1e-2 of the exact Kalman filter and 1e-4 of the plain versions' run on
   the CPU, then 4096 tanh-measurement filters converging;
10. the fork's hybrid operating point (BASELINE.md): GPS L1 C/A, 9
   channels, 3 Msps, 26 s of phase 4's sky and a pseudolite (PRN 17, 0 Hz,
   50 dB-Hz, its clock 2.5 ms off GPS time, its own LNAV) made by K6 and
   written as ibyte, through the CLI with the hybrid keys (channel 8 the
   pseudolite, rx clock propagation and bias sharing on): the position,
   no fix on channel 8, no bias record with its PRN, one clock
   difference per fix once it is observed, the AOWR product within 5 ns
   of the planted offset against the true receiver clock (the raw
   median printed beside it);
11. the multi-band front end: phase 4's sky with L5 on four of its six
   satellites, 30 s made by K6 as two RF streams, GPS L1 C/A at 8 Msps
   (RF 0, 8 channels, acquisition on the x4 mean-pooled stream) and GPS
   L5I at 20 Msps (RF 1, 8 channels, assist-gated), through
   ReceiverSession.attach_arrays: every L5 acquisition assisted (the log,
   no cold L5 search), each center within 50 Hz of the true L1 Doppler x
   f_L5 / f_L1, no L5 channel on a PRN without L5, the position, a fix
   using both bands, |PR_L5 - PR_L1| < 30 m per PRN, and the launches at
   the assisted shape and at 8 and 20 Msps;
12. the live session: phase 4's capture, conditioned, through feed() in
   1 s host blocks against process_array (fix counts within 2, the first
   four fixes within 0.5 m, the last within 3 m), the streaming
   real-time factor printed beside phase 4's; then a warm-started
   session under the TCP telecommand server on 127.0.0.1: status,
   standby (2 s dropped, no fix), hotstart (a refix), coldstart (the
   ephemerides cleared);
13. the Kalman trackers and the full planes on phase 4's capture and
   conf: the KF (``Tracking_1C.implementation=GPS_L1_CA_KF_Tracking``)
   through the CLI, its real-time factor printed; the gaussian mode on
   the conditioned capture through a Receiver session, every tracking
   channel's posterior count above 50; ``collect_track_outputs=True`` in
   dll_pll mode and with ``Tracking_1C.order=2``: the 13 planes [T, C],
   the sample counters, each tracking channel's ``.mat`` dump read back
   equal.  Each is held to phase 4's tracked set, fixes and position
   error, its every chunk on the chunk kernel's form and none on the
   block kernels (phase 3 holds the KF, gaussian and second-order forms
   of K9 and of the chunk kernel, ``K9_epoch_chunk_kf``, ``_gaussian``
   and ``_pll2``, to the plain closure and the two-launch chunk at GPS
   2 Msps, C = 8, from edge states with a singular innovation matrix and
   the posterior's floors);
14. the GPS L2C (CM) and Galileo E5b-I chains: (a) phase 4's six
   satellites on L2C alone (45 dB-Hz, CNAV at 25 bps), 54 s made by K6
   at 4 Msps and written as ishort, through the CLI with phase 4's
   conditioner and 8 L2C channels: the cold search on the L2C grid (K3 at
   M=1, D=168, N=80000, then K3b), the tracked set, >= 5 CNAV
   ephemerides, >= 5 fixes (2D < 2 m, 3D < 5 m), every chunk on the chunk
   kernel (decim 1), the real-time factor; (b) GPS L1 C/A and L2C on two
   RF streams at 4 Msps (54 s, L2C on four of the six) through
   attach_arrays twice: at a 100 ms observable interval the L2C blocks on
   the block step at E = 2 (where the L2C loops lose lock, as JAX's do:
   printed, not held), every L2C search assisted within 50 Hz of the L1
   Doppler x f_L2 / f_L1, the position; at the default 20 ms the same and
   each L2C Doppler within 1 Hz of its L1 channel's scaled over the last
   second, CNAV decoded on each L2C channel, |PR_L2 - PR_L1| < 30 m, a fix
   of both bands; (c) GPS L1 C/A at 4 Msps and Galileo E5b-I at 20 Msps (the
   hybrid sky, 30 s): E5b searched cold, phase 5's checks on the joint
   run, the E5b blocks on the block step.  Phase 3 holds the kernels at
   these new shapes (the cold L2C search's wipeoff and peak, with the
   search's time and peak memory; step two's and the 4 Msps assisted
   search's K3b; the chunk kernel at L2C's 40000 and 80000 samples an
   epoch; K8a, K8b and K1 at L2C's E = 2, at GPS L1 C/A 4 Msps and with
   E5b-I's codes at phase 7's shape; K6 on the L2C and E5b skies);
15. the BeiDou B1I and B3I chains (its own seconds printed): (a) phase
   4's six satellites as BeiDou MEO PRNs on B1I alone (46 dB-Hz, D1
   with NH20), 36.5 s made by K6 at 8 Msps and written as ishort, through
   the CLI with phase 4's x2 conditioner and 8 B1I channels: the cold
   search on the B1I grid, the tracked set, >= 5 D1 ephemerides, >= 5
   fixes (2D < 2 m, 3D < 5 m), the block step and the chunk kernel at
   B1I's shapes, the real-time factor; (b) B1I at 4 Msps on RF 0 and B3I
   at 12.5 Msps on RF 1 (20 s, B3I on four of the six, warm-started)
   through attach_arrays: every B3I search assisted within 50 Hz of the
   B1I Doppler x f_B3 / f_B1, B3I on its four PRNs alone, |PR_B3 -
   PR_B1| < 30 m, a fix of both bands, the launches at B3I's shapes; (c)
   tests/test_d2.py's GEO run (PRN 2, D2 at 500 bps) at 8.192 Msps, 31.5
   s on the per-epoch path with the rectified lock test: the Doppler
   within 5 Hz, no loss of lock, the D2 ephemeris, the SOW ramp of 1 ms
   an epoch, the chunk kernel's rectify form launched once per chunk.
   Phase 3 holds K9's rectify form alone (against its plain closure, and
   against the coherent form on the card) and in the chunk kernel, and
   the kernels at the new shapes (the cold B1I and GEO searches, the
   assisted B3I one, the chunk kernel at B1I's and B3I's epochs, K8a, K8b
   and K1 at both E = 20 shapes, K6 on the three skies);
16. the Galileo E6-B chain (its own seconds printed): (a) the hybrid
   sky's Galileo PRNs 11-15 on E1-B and E6-B, each E6 satellite sending
   one row of a two-page HAS message's C-matrix, 26 s made by K6 at
   12.5 Msps and written as ibyte, through the CLI (`E6_CONF`, 5 + 5
   pinned channels): E1 and E6 on the five PRNs, every E6 search assisted
   within 50 Hz of the E1 Doppler x f_E6 / f_E1, the E6 TOW from the map
   1 ms an epoch, PR_E6 - PR_E1 within 30 m of the map's extrapolation
   (-age x range rate, the reference's; check_e6_observables), E1's fix
   (2D < 2 m, 3D < 5 m), the HAS message rebuilt by Reed-Solomon erasure
   decoding, equal to the planted one; (b) E6 alone, 5 s, through the
   receiver: the cold search (D = 41, the doubled FFT), the Doppler
   within 5 Hz, no loss of lock, the HAS message, and no TOW, observable
   or fix.  The E6 chain's tail chunk raises KeyError('sample_counter')
   at the end of a run, as the JAX receiver does (e6_tail: the result up
   to it is checked);
17. the GLONASS L1 and L2 C/A chains (its own seconds printed): (a) three
   satellites on slots -7, 0 and +6, 16.5 s at 10 Msps as ibyte, through
   the CLI with `Channels_1G.count=24` (the 13 slot chains): each on its
   slot's chain, the Doppler within 3 Hz of the slot offset plus the
   truth, three GNAV ephemerides within 3 m and 2 ns at tb + 200 s, the
   TOW within 1 ms, the pseudorange differences within 30 m of the
   planted delays', no fix (three satellites), the FDMA bias form of K8a,
   K1 with K8b and K8a and the chunk kernel launched; (b) L1 at 10 Msps
   and L2 at 8 Msps through attach_arrays: every L2 search assisted
   within 50 Hz of the L1 Doppler x 7/9, |PR_L2 - PR_L1| < 30 m.  Phase 3
   holds the bias form at slots -7 and +6 (and on L2), the GLONASS, E6
   and E1 12.5 Msps searches, E6's block step and chunk kernel, and K6 on
   the new skies;
18. SBAS L1 and the corrected single-point fix (its own seconds printed):
   (a) phase 4's six satellites with planted range biases, one
   satellite's long-term error and a thin-shell iono delay in their code
   delays, and two GEOs (PRNs 131, 133, 45 dB-Hz) sending MT1, MT2 (PRC =
   -bias), MT25, MT18/MT26 (the grid) and MT9, 26 s made by K6 at 4 Msps
   as ishort, through the CLI with phase 4's conditioner, 8 GPS and 2
   pinned S1 channels: the GEOs tracked, every decoded message's CRC
   passed and each one planted, every cycle entry decoded, the
   corrections state the planted one, each GEO's MT9 ephemeris, the
   corrected fix within 3 m and under half the error of the capture run
   with Channels_S1.count=0 (the fixed epochs solved cold with the
   session's corrections: the receiver's warm-started fixes skip the iono
   grid, as the reference's do); (b) eight satellites at 2 Msps with the
   Klobuchar delay of their own page-18 parameters, the Saastamoinen
   delay and a 60 m fault planted, through the factory's receiver with
   PVT.iono_model=Broadcast, trop_model=Saastamoinen and raim_fde=true
   (the fault excluded in every fix, within 12 m; solved cold within
   3 m), with them OFF (the fault in every fix, beyond 12 m), and with
   Observables.smoothing_factor=100 and PVT.enable_pvt_kf=true (valid
   fixes; the Hatch filter runs away, as the reference's does).  Phase 3
   holds the S1 search at 2 Msps, the block step at the S1 chain's C=2,
   the chunk kernel's rectify form at 2000 samples an epoch and K6 on
   both skies.
19. the PVT modes beyond the single-point fix (its own seconds printed),
   on phase 4's sky at 2 Msps made by K6: (a) RTK through the CLI, a 44 s
   base at 55 dB-Hz through process_array, its observables written as a
   RINEX obs file, a 40 s rover 6, 3, 0.5 m east, north, up of it written
   as ishort, through PVT.positioning_mode=RTK_Static with the base file
   and position (the rover decodes its own ephemerides): at the last
   fixed epoch the fixed baseline within 5 cm (tests/test_rtk_e2e.py's
   bound) and its float within 1.1 times the JAX receiver's on this
   capture, which is over the test's 0.8 m there (the float climbs,
   ROADMAP.md queue 3); (b) the base run as RTCM MSM7, 1019 and 1005
   frames over 127.0.0.1, decoded (the same bytes, the station within
   1 mm, the same ephemerides) and fed to the rover's first 20 s through
   process_array: fixed within 5 cm, its float within 0.8 m; (c)
   PPP_Static on 16 s at 50 dB-Hz with the sky's ephemerides: the last
   solution within 10 m; (d) the orbital EKF on the same capture: its
   3D error (mean, largest, mean after 2 s) within 1.25 times the JAX
   receiver's on this capture, and after 2 s under 0.9 of its own LS
   fixes'.  The JAX figures come from the captures as the card makes
   them, rebuilt on the CPU (python -m tests.test_torch_rtk).  Its
   receivers run phase 4's GPS shapes (phase 3 holds them); their
   launches join those rows.

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Needs one card; imports nothing
of JAX.  Every block-tracking phase checks that K1 with K8b fused ran
once per block (= K1's launches), the next block's prologue folded into
it but after each chunk's last block and K8a once per chunk (where the
planner folds), and the chunk kernel on the chunk tails; on every path
the standalone K2, K9 and K8b read 0 (they are held against in phase 3
only).  ``--profile`` adds a torch.profiler breakdown of a
second run of the paths of phases 5, 6, 7 and 8 (device busy share,
kernel launch calls, time by kernel).
``--witness`` adds, after phase 6, the hybrid receiver on variants of
phase 5's capture (rate, chips, quantization, noise seed) to show what moves
its position error.  ``--kernels-only`` stops after phase 3 and prints no
result line: the quick check of a new kernel.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM rate and the float32 rate
# outside the tensor cores; the bounds below are stated against these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SCENARIO_PRNS = (1, 3, 4, 5, 9, 10)
T0 = 345600.0
DUR = 26.0
FS = 2_000_000.0
FS_FILE = 4_000_000.0          # the capture file's rate (phase 4)
DIRECT_DUR = 8.0               # phase 4c runs the array entry point this deep
COND_SAMPLES = 4_000_000       # phase 4b: the conditioner alone
# the notch (phases 3 and 4b): its sequential plain version takes about a
# minute per million samples on the card, so both phases use this length
NOTCH_SAMPLES = (1 << 20) + 5
NOTCH_F0, NOTCH_BW = 0.1, 0.01
# phase 3's narrow notch: its state lasts thousands of samples
NOTCH_NARROW_SAMPLES, NOTCH_NARROW_BW = (1 << 18) + 3, 0.0005
RX_LLH = (40.0, -75.0, 100.0)
# phase 5: the hybrid scenario of tests/test_hybrid_position.py (4 GPS and
# 5 Galileo satellites, 48 dB-Hz, seed 17), 26 s at the reference hybrid
# conf's 20 Msps, written as ibyte (noise sigma 14 LSB per component)
HYB_GPS_PRNS = (1, 3, 4, 5)
HYB_GAL_PRNS = (11, 12, 13, 14, 15)
FS_REF_HYBRID = 20_000_000.0
HYB_BYTE_SCALE = 20.0
# phase 6: bench.py:_bench_full_chain's scenario (bench.py:128-155): 12
# satellites at these offsets (bench.py:136-139), 47 dB-Hz, seed 3, 120 s
# at 2 Msps, 12 channels, PVT every 500 ms
FULL_OFFSETS = [(0.0, 0.0), (40.0, 15.0), (-35.0, 20.0), (15.0, 55.0),
                (-20.0, -50.0), (45.0, -25.0), (-45.0, -15.0), (5.0, -60.0),
                (30.0, 40.0), (-10.0, 62.0), (25.0, -42.0), (-28.0, 47.0)]
FULL_DUR = 120.0
FULL_PRNS = tuple(range(1, 13))
K6_CHUNK = 1 << 22             # the device generator's launch (its default)
K6_TILE = 2048                 # its samples a CTA (kThreads * kPerThread)
# phase 7: the wideband scenario, phase 5's satellites on L5 and E5a, 60 s
# at 20 Msps (the shortest length at which every F/NAV ephemeris decodes:
# a channel that locks in its first seconds has words 2, 3, 4 and 1 by
# 50 s), toe and toc on the CNAV 300 s and F/NAV 60 s grids
FS_WIDEBAND = 20_000_000.0
WB_DUR = 60.0
WB_TOE = T0 + 600.0
F_L5 = 1_176.45e6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def sm_clock_during(fn, seconds: float = 3.0) -> str:
    """The card's SM clock (MHz; `nvidia-smi` every 100 ms) while `fn`
    runs back to back for `seconds`: "min / median / max of k readings
    (max clock M)", or "not read" when nvidia-smi gives nothing."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [ln.split(",") for ln in out.splitlines()
            if "," in ln and ln.split(",")[0].strip().isdigit()]
    if not rows:
        return "not read"
    # the first readings may come before the launches reach the card
    mhz = sorted(int(r[0]) for r in (rows[3:] or rows))
    top = rows[0][1].strip()
    return (f"{mhz[0]} / {mhz[len(mhz) // 2]} / {mhz[-1]} MHz of "
            f"{len(mhz)} readings (max clock {top} MHz)")


def time_ms(fn, reps: int = 20) -> float:
    """Device milliseconds of one call of `fn`: `reps` calls captured in a
    CUDA graph and replayed (so the host's launch cost is not counted),
    the median of 5 replays by CUDA events, over `reps`."""
    import torch
    fn()                                  # compiles, cuFFT plans, pool
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def device_ops(fn, reps: int = 5) -> dict:
    """What one call of `fn` runs on the card, by torch.profiler over
    `reps` calls after a warm one: {name: [launches, device us]} a call
    (kernels, memsets and copies); {} where the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = {}
    for evt in prof.events():
        if "CUDA" not in str(evt.device_type):
            continue
        op = ops.setdefault(evt.name, [0.0, 0.0])
        op[0] += 1.0 / reps
        op[1] += evt.time_range.elapsed_us() / reps
    return ops


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def compare(name, got, want, rtol: float) -> float:
    """Max abs error of `got` against `want`; fails above rtol * max|want|
    for floats, on any difference for integers."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        if not torch.isfinite(g.to(torch.complex64)).all():
            fail(f"{name}: non-finite output")
        if not (g.is_floating_point() or g.is_complex()):
            if not torch.equal(g, w):
                fail(f"{name}: integer outputs differ: {g} vs {w}")
            continue
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        print(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, "
              f"tolerance {rtol:g} x that)")
        if err > rtol * scale:
            fail(f"{name}: error {err:.3e} above {rtol * scale:.3e}")
        worst = max(worst, err)
    return worst


# ---- phase 3: each kernel against its plain version ------------------------

def _row(name, route, source, replaces, err, ms, plain_ms, n_bytes, n_ops,
         shape, library_ms=None):
    """One kernel's entry of the `kernels` line.  `shape` says at what
    shape `ms`, `plain_ms`, `bound_ms` and `library_ms` were taken: the one
    the kernel's path launches it at."""
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"  {name} [{shape}]: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {b_by}"
          + ("" if library_ms is None else f", library {library_ms:.4f} ms"))
    return dict(name=name, route=route, source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, shape=shape)


def _cnoise(rng, n, dev):
    import torch
    x = torch.from_numpy(rng.standard_normal((n, 2)).astype(np.float32))
    return torch.view_as_complex(x).to(dev)


def check_k1(dev, rng, conf, c: int, e: int, taps, chunk_epochs: int,
             name: str, label: str):
    """K1 against its plain version at `conf`'s FFT length, C channels, E
    epochs per block, the given taps (in chips), the window spectra of a
    `chunk_epochs`-epoch chunk; timed there."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    fs, rate = conf.fs, conf.code_rate_cps
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    k = len(taps)
    n = chunk_epochs * s0 + nfft + 512
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    rf = torch.from_numpy((rng.standard_normal((c, nfft))
                           + 1j * rng.standard_normal((c, nfft))
                           ).astype(np.complex64)).to(dev)
    w0_np = rng.integers(0, n_wins - e, c).astype(np.int32)
    w0_np[:2] = (-2, n_wins)       # both clamps: the start below 0, past W-E
    w0 = torch.from_numpy(w0_np).to(dev)
    lag = rng.uniform(16.0, 16.0 + s0, (c, e)).astype(np.float32)
    lag_int = np.round(lag).astype(np.int32)
    w_max = 2 * np.pi * 5000.0 / fs          # +-5 kHz of Doppler
    args = (xf_all, rf, w0, torch.from_numpy(lag_int).to(dev),
            torch.from_numpy((lag - lag_int).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 650, (c, e)).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(np.outer(rng.uniform(0.97, 0.99, c),
                                      -np.asarray(taps)).astype(np.float32)
                             * np.float32(fs / rate)).to(dev),
            torch.from_numpy(rng.uniform(-w_max, w_max, c).astype(np.float32)
                             ).to(dev))
    scratch = tb.k1_scratch(c, e, k, nfft, dev)
    slabs = scratch.partials.shape[1]
    got = tb.block_correlate(*args, scratch=scratch)
    again = tb.block_correlate(*args, scratch=scratch)
    want = tb._block_correlate_plain(*args)
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-4)
    same_bits(f"{name} ({label})", got, again)
    ms = time_ms(lambda: tb.block_correlate(*args, scratch=scratch))
    counters_at_zero(f"{name} ({label})", scratch.arrivals)
    plain = time_ms(lambda: tb._block_correlate_plain(*args), reps=3)
    rows = len({min(max(int(w), 0), n_wins - e) + i for w in w0_np
                for i in range(e)})
    n_bytes = rows * nfft * 8 + c * nfft * 8 + c * e * (4 * 3) + c * e * k * 8
    # per (c, k, f): tap angle 3, sincos 2; per (c, e, f): lag angle 4,
    # sincos 2, two complex products 12, a complex multiply-accumulate 8
    # per tap
    n_ops = c * nfft * (k * 5 + e * (18 + k * 8))
    return _row(name, "cuda",
                "gnss_sim_receiver_tpu_torch/csrc/block_correlator.cu",
                "gnss_sim_receiver_tpu/models/tracking_block.py:149",
                err, ms, plain, n_bytes, n_ops,
                f"{label}: C={c} channels, E={e} epochs, K={k} taps, "
                f"F={nfft} bins, S={slabs} slabs")


def same_bits(name, a, b) -> None:
    """Fails unless two launches on the same inputs gave the same bits."""
    import torch
    if not torch.equal(torch.view_as_real(a), torch.view_as_real(b)):
        fail(f"{name}: two launches on the same inputs differ")
    print(f"  {name}: two launches bit-identical")


def counters_at_zero(name, arrivals) -> None:
    """Fails unless every arrival counter is back at 0 (after the timing's
    CUDA-graph replays)."""
    import torch
    torch.cuda.synchronize()
    if bool(arrivals.ne(0).any()):
        fail(f"{name}: arrival counters not reset: {arrivals.tolist()}")
    print(f"  {name}: arrival counters at 0 after the timed replays")


def block_state(rng, conf, c: int, e: int, n_wins: int, dev,
                pilot: bool = False):
    """A TrackState of C channels with every field the block step reads
    spread over the range its paths give it: the last channel inactive,
    epochs on both sides of the FLL pull-in edge, ext_n on both sides of
    the DLL switch (50), lock_fail up to max_lock_fail, integer bit-sync
    histograms (one channel a transition short of sync), prev_sign in
    {-1, 0, 1}, negative carrier phases; with `pilot` the secondary-code
    fields too: a sign history in {-1, 0, 1}, some channels synced at
    random offsets and polarities."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    s0 = conf.nominal_epoch_samples
    st = interop.track_state_to_numpy(trk._init_state(c, "cpu"))
    # the Doppler around the chain's FDMA bias (0 but on GLONASS: adding
    # and taking off 0.0 leaves every draw's bits)
    bias = conf.doppler_bias_hz
    dop = bias + rng.uniform(-4500.0, 4500.0, c)
    hist = rng.integers(0, 3, (c, 20)).astype(np.float32)
    hist[0] = 0.0
    hist[0, rng.integers(0, 20)] = conf.bit_sync_min_transitions - 1
    ep = conf.fll_pullin_epochs

    def f(a):
        return np.asarray(a, np.float32)
    st.update({
        "active": np.arange(c) < c - 1,
        "pos": rng.integers(-8, (n_wins - e - 1) * s0, c).astype(np.int32),
        "rem_code_phase": f(rng.uniform(-0.5, 0.5, c)),
        "code_freq": f(conf.code_rate_cps
                       * (1.0 + (dop - bias) / conf.carrier_freq_hz)
                       + rng.uniform(-0.05, 0.05, c)),
        "carrier_doppler": f(dop),
        "rem_carr_phase": f(rng.uniform(-1.0, 2.0 * np.pi, c)),
        "acc_phase_cycles": f(rng.uniform(-1e5, 1e5, c)),
        "acc_phase_comp": f(rng.uniform(-1e-3, 1e-3, c)),
        "dll.vel": f(rng.uniform(-0.5, 0.5, c)),
        "pll.vel": f(dop + rng.uniform(-1.0, 1.0, c)),
        "pll.acc": f(rng.uniform(-5.0, 5.0, c)),
        "prompt_prev": (rng.standard_normal(c) + 1j * rng.standard_normal(c)
                        ).astype(np.complex64) * 1000,
        "epoch": rng.integers(max(ep - 3 * e, 0), ep + 3 * e, c
                              ).astype(np.int32),
        "carrier_lock": f(rng.uniform(0.3, 1.0, c)),
        "lock_fail": f(rng.integers(0, conf.max_lock_fail + 1, c)),
        "bit_hist": hist,
        "prev_sign": f(rng.choice([-1.0, 0.0, 1.0], c)),
        "bit_synced": rng.random(c) < 0.3,
        "bit_phase": rng.integers(0, 20, c).astype(np.int32),
        "ext_n": rng.integers(45, 55, c).astype(np.int32)})
    if pilot:
        st.update({
            "sec_buf": f(rng.choice([-1.0, 0.0, 1.0], (c, 32))),
            "sec_synced": rng.random(c) < 0.3,
            "sec_off": rng.integers(0, 25, c).astype(np.int32),
            "sec_polarity": f(rng.choice([-1.0, 1.0], c))})
    return interop.track_state_from_numpy(st, dev)


def block_corr(rng, c: int, e: int, taps, dev, data: bool = False):
    """[C, E, K] correlations shaped like a tracked channel's: a triangle
    over the taps, a carrier phase error, nav-bit sign flips and noise;
    with `data` (the pilot form) the data prompt as one more column, its
    own symbols on the same phase."""
    import torch
    amp = rng.uniform(200.0, 2000.0, (c, 1, 1))
    tri = np.maximum(1.0 - np.abs(np.asarray(taps)) * 2.0, 0.1)[None, None]
    if data:
        tri = np.concatenate([tri, [[[0.7]]]], axis=2)
    bits = np.where(rng.random((c, e, 1)) < 0.2, -1.0, 1.0)
    if data:
        bits = np.concatenate([np.repeat(bits, len(taps), 2), np.where(
            rng.random((c, e, 1)) < 0.5, -1.0, 1.0)], axis=2)
    ph = rng.normal(0.0, 0.3, (c, e, 1))
    noise = rng.standard_normal((c, e, len(taps) + data, 2)) @ [1.0, 1j] \
        * 60.0
    return torch.from_numpy((amp * tri * bits * np.exp(1j * ph) + noise
                             ).astype(np.complex64)).to(dev)


def ulps(got, want):
    """|got - want| in units of want's float32 ulp."""
    import torch
    a = want.abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got - want).abs() / ulp).max().item()


def closure_flips(conf, got, want) -> list:
    """The integer and bool state fields in which K8b's next state differs
    from the plain version's, per channel, each with the plain version's
    margin to the thresholds that decide it (carrier lock and C/N0, the
    only float comparisons upstream of lock_fail, lock_lost and active),
    relative to the threshold."""
    from gnss_sim_receiver_tpu_torch import interop
    g = interop.track_state_to_numpy(got)
    w = interop.track_state_to_numpy(want)
    flips = []
    for k in ("active", "pos", "epoch", "lock_fail", "lock_lost",
              "bit_synced", "bit_phase", "ext_n", "bit_hist", "sec_synced",
              "sec_off"):
        diff = g[k] != w[k]
        for ch in np.flatnonzero(diff.reshape(diff.shape[0], -1).any(1)):
            margin = None
            if k in ("active", "lock_fail", "lock_lost"):
                margin = min(
                    abs(w["carrier_lock"][ch] - conf.carrier_lock_threshold)
                    / conf.carrier_lock_threshold,
                    abs(w["cn0_db_hz"][ch] - conf.cn0_min_db_hz)
                    / conf.cn0_min_db_hz)
            flips.append((k, int(ch), margin))
    return flips


K8_RTOL = 1e-5          # K8b's float fields, of max |plain|
# the block library built a second time with --fmad=false, into a
# directory of its own: block_step.cu rounds explicitly, so its K8a and
# K8b must give the same bits under either flag
FMAD_FALSE = ("--fmad=false",)


def fmad_false_dir():
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    return cuda_build.BUILD_DIR / "fmad_false"


def pilot_tables(conf, c: int, provider, data_provider, dev, prns=None):
    """The block step's replica tables of PRNs 1..C (or `prns`) at `conf`'s
    shape:
    [C, F], or with `data_provider` (the pilot form) [2, C, F] with the
    data code's second, and the +-1 secondary code on the card (else
    None)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import prn_codes

    def rep(prov):
        return tb.code_spectra(conf, np.stack([
            prn_codes.bandlimited_table_normalized(
                prov(p), conf.fs, conf.code_rate_cps,
                conf.nominal_epoch_samples, 8)
            for p in (prns or range(1, c + 1))]), dev)
    if data_provider is None:
        return rep(provider), None
    return (torch.stack([rep(provider), rep(data_provider)]),
            torch.from_numpy(trk.secondary_pm1(conf)).to(dev))


def check_k8(dev, rng, conf, c: int, taps, provider, n_wins: int,
             names, label: str, data_provider=None):
    """K8a and K8b against their plain versions at `conf`'s FFT length, C
    channels, E = the conf's block epochs, the given taps (chips), the
    block replica of `provider`'s band-limited codes, a chunk of `n_wins`
    windows; timed there.  K8a: the integer outputs exact, the float ones
    within 2 ulp, the replica within 1e-6 of its row's largest modulus.
    K8b: the float fields of the next state and the block's plane rows
    within K8_RTOL of max |plain|; the integer and bool fields exact, or
    flipped only where the plain version's carrier lock or C/N0 lies
    within K8_RTOL of its threshold.  Then both bit for bit: against their
    plain versions, and against the same kernels of the block library
    built with --fmad=false.  With `data_provider` the pilot form: both
    replica families (the data code's second), the data prompt as K1's
    last column, the secondary code's sync in K8b, the sec_* fields of
    the state among those held."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    nfft = tb.block_fft_size(conf)
    e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
    k = len(taps)
    codes_rep, sec = pilot_tables(conf, c, provider, data_provider, dev)
    pilot = sec is not None
    fam = 1 + pilot
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
    st = block_state(rng, conf, c, e, n_wins, dev, pilot)
    shape = (f"{label}: C={c} channels, E={e} epochs, K={k} taps, "
             f"F={nfft} bins" + (", with the data family" if pilot else ""))

    # ---- K8a ----------------------------------------------------------
    got = tb.block_prologue(conf, e, codes_rep, taps_t, n_wins, st)
    want = tb._block_prologue_plain(conf, e, codes_rep, taps_t, n_wins, st)
    torch.cuda.synchronize()
    for name in ("n_cum", "n_next", "n_len", "n_total", "w0", "lag_int"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"K8a ({label}): {name} differs from the plain version")
    worst_ulp = 0.0
    for name in ("rem_end", "rem_new", "lag_frac", "ph_sc", "tap_samps",
                 "omega"):
        u = ulps(getattr(got, name), getattr(want, name))
        worst_ulp = max(worst_ulp, u)
        if u > 2.0:
            fail(f"K8a ({label}): {name} {u:g} ulp from the plain version")
    rep_err = ((got.rep_t - want.rep_t).abs().amax(-1)
               / want.rep_t.abs().amax(-1).clamp(min=1e-30)).max().item()
    print(f"  K8a_block_prologue ({label}): integer outputs identical, "
          f"floats within {worst_ulp:g} ulp (tolerance 2), replica within "
          f"{rep_err:.2e} of its row's max modulus (tolerance 1e-6)")
    if rep_err > 1e-6:
        fail(f"K8a ({label}): replica error {rep_err:.2e}")
    a_err = float((got.rep_t - want.rep_t).abs().max())
    a_ms = time_ms(lambda: tb.block_prologue(conf, e, codes_rep, taps_t,
                                             n_wins, st))
    a_plain = time_ms(lambda: tb._block_prologue_plain(
        conf, e, codes_rep, taps_t, n_wins, st))
    # reads: the replica table and 5 state fields; writes: the complex
    # replica, 6 [C, E] and 4 [C] vectors and the taps;
    # per (c, m): angle 1, sincos 2, two products 2
    a_bytes = fam * c * nfft * (4 + 8) + c * 5 * 4 + c * e * 6 * 4 \
        + c * 4 * 4 + c * k * 4
    a_ops = c * nfft * (3 + 2 * fam) + c * e * 30
    row_a = _row(names[0], "cuda",
                 "gnss_sim_receiver_tpu_torch/csrc/block_step.cu",
                 "gnss_sim_receiver_tpu/models/tracking_block.py:204",
                 a_err, a_ms, a_plain, a_bytes, a_ops, shape)

    # ---- K8b ----------------------------------------------------------
    corr = block_corr(rng, c, e, taps, dev, pilot)
    t = 3 * e
    planes = tb._empty_planes(t, c, dev)
    planes_p = tb._empty_planes(t, c, dev)
    for pl in (planes, planes_p):
        for v in pl.values():
            v.zero_()
    new_k = tb.block_closure(conf, e, corr, want, st, planes, 1, sec)
    new_p, outs = tb._block_closure_plain(conf, e, corr, want, st, sec)
    tb._write_rows(planes_p, outs, 1, e)
    torch.cuda.synchronize()
    flips = closure_flips(conf, new_k, new_p)
    for field, ch, margin in flips:
        print(f"  K8b ({label}): {field} of channel {ch} differs; plain "
              f"margin to its threshold {margin}")
        if margin is None or margin > K8_RTOL:
            fail(f"K8b ({label}): {field} of channel {ch} differs outside "
                 "the float tolerance of its threshold")
    gk = interop.track_state_to_numpy(new_k)
    gp = interop.track_state_to_numpy(new_p)
    b_err = 0.0
    for key in gp:
        if key in ("active", "pos", "epoch", "lock_fail", "lock_lost",
                   "bit_synced", "bit_phase", "ext_n", "bit_hist",
                   "sec_synced", "sec_off"):
            continue
        if not np.array_equal(gk[key], gp[key]):
            b_err = max(b_err, compare(
                f"K8b ({label}) state {key}", torch.from_numpy(gk[key]),
                torch.from_numpy(gp[key]), K8_RTOL))
    for key, _ in tb.PLANES:
        if not torch.equal(planes[key], planes_p[key]):
            b_err = max(b_err, compare(f"K8b ({label}) plane {key}",
                                       planes[key], planes_p[key], K8_RTOL))
    print(f"  K8b_block_closure ({label}): {len(flips)} integer or bool "
          f"fields flipped at a threshold; state and plane rows within "
          f"{b_err:.3e} (tolerance {K8_RTOL:g} x max |plain|)")
    same_k8_bits(dev, conf, e, codes_rep, taps_t, n_wins, st, corr, got,
                 want, new_k, new_p, planes, planes_p, label, sec)
    b_ms = time_ms(lambda: tb.block_closure(conf, e, corr, want, st,
                                            planes, 1, sec))

    def plain_closure():
        _, o = tb._block_closure_plain(conf, e, corr, want, st, sec)
        tb._write_rows(planes_p, o, 1, e)
    b_plain = time_ms(plain_closure)
    # reads: 23 state fields (bit_hist 20 wide), the correlations, 6 of
    # K8a's vectors; writes: the next state and E rows of the 12 planes;
    # per (c, e): discriminators 30, FLL 20, lock 10, bit sync 20 + 2E
    # (rank and bin counts); per c: loop filters and commit 80
    # (the pilot form: 35 more state floats, the data column, and per
    # (c, e) the sync's 25-term match and the wipe, 60)
    st_bytes = c * (22 * 4 + 8 + 20 * 4 + pilot * (32 * 4 + 9))
    b_bytes = 2 * st_bytes + c * e * (k + pilot) * 8 + c * e * 4 * 4 \
        + c * 2 * 4 + e * c * (8 + 9 * 4 + 2 * 4 + 1)
    b_ops = c * e * (80 + 2 * e + pilot * 60) + c * 80
    row_b = _row(names[1], "cuda",
                 "gnss_sim_receiver_tpu_torch/csrc/block_step.cu",
                 "gnss_sim_receiver_tpu/models/tracking_block.py:359",
                 b_err, b_ms, b_plain, b_bytes, b_ops, shape)
    rows_f = check_block_close(dev, rng, conf, c, e, got, st, n_wins,
                               names[2:],
                               label, shape, (codes_rep, taps_t),
                               (a_bytes, a_ops), (b_ms, b_bytes, b_ops), sec)
    return (row_a, row_b, *rows_f)


def same_k8_bits(dev, conf, e, codes_rep, taps_t, n_wins, st, corr, got,
                 want, new_k, new_p, planes, planes_p, label,
                 sec=None) -> None:
    """K8a's outputs `got` and K8b's next state `new_k` and plane rows
    `planes` bit for bit those of the plain versions (`want`, `new_p`,
    `planes_p`) and of the block library built with --fmad=false on the
    same inputs."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import cuda_build
    alt = tb.bind(cuda_build.load("block_kernels", FMAD_FALSE,
                                  fmad_false_dir()))
    c, nfft = codes_rep.shape[-2:]
    stream = torch.cuda.current_stream(dev).cuda_stream
    got_f = tb._empty_prologue(c, e, nfft, taps_t.shape[0], dev,
                               1 + (sec is not None))
    cuda_build.check(alt.block_prologue(tb._prologue_args(
        conf, e, codes_rep, taps_t, n_wins, st, got_f), c, stream),
        "block_prologue (--fmad=false)")
    new_f = tb._empty_state(st, sec is not None)
    planes_f = tb._empty_planes(planes["prompt"].shape[0], c, dev)
    for v in planes_f.values():
        v.zero_()
    cuda_build.check(alt.block_closure(tb._closure_args(
        conf, e, corr, want, st, new_f, planes_f, sec), 1, stream),
        "block_closure (--fmad=false)")
    torch.cuda.synchronize()
    fields = tb.BlockPrologue._fields
    plain_diff = []
    for other, what in ((want, "the plain version"),
                        (got_f, "the --fmad=false build")):
        diff = [n for n in fields if not torch.equal(
            bits(getattr(got, n)), bits(getattr(other, n)))]
        if diff:
            fail(f"K8a ({label}): {diff} differ in bits from {what}")
    for st_o, pl_o, what in ((new_p, planes_p, "the plain version"),
                             (new_f, planes_f, "the --fmad=false build")):
        diff = differing(new_k, st_o, planes, pl_o)
        if diff and (sec is None or st_o is new_f):
            fail(f"K8b ({label}): {diff} differ in bits from {what}")
        if diff:        # the pilot form: held to the plain version above
            plain_diff = diff
    print(f"  K8a and K8b ({label}): every output bit for bit that of the "
          + ("plain version and of " if not plain_diff else "")
          + "the --fmad=false build"
          + (f"; K8b's {plain_diff} within the tolerance of the plain "
             "version, not bit for bit" if plain_diff else ""))


def bits(t):
    """`t` as integers of its bit pattern (floats and complex floats)."""
    import torch
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def differing(got_state, want_state, got_planes, want_planes) -> list:
    """The state fields and planes whose bits differ."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    gs = interop.track_state_to_numpy(got_state)
    ws = interop.track_state_to_numpy(want_state)
    out = [f"state {k}" for k in ws
           if gs[k].tobytes() != ws[k].tobytes()]
    return out + [f"plane {k}" for k in want_planes
                  if not torch.equal(bits(got_planes[k]),
                                     bits(want_planes[k]))]


def check_block_close(dev, rng, conf, c: int, e: int, pro, st, n_wins: int,
                      names, label: str, shape: str, fold_in, k8a, k8b,
                      sec=None):
    """K1 with K8b's closure in its epilogue (block_correlate_close, on the
    replica spectrum as the FFT leaves it) against K1 on the conjugated
    spectrum followed by the standalone K8b, from K8a's outputs `pro` and
    the state `st`, on the window spectra of an `n_wins`-window noise
    chunk: the correlations, the next state and the block's plane rows
    bit for bit, two launches bit-identical.  Then with the fold (`fold_in` = the
    replica table and the taps): the same, and the next block's prologue
    bit for bit the standalone K8a's on the next state, the fold flags
    counting the two launches (S > 1) and the arrival counters at 0.
    Timed beside K1 alone on the same inputs (the fused launch less K1's
    is what the closure costs there) and the standalone K8a.  `k8a` and
    `k8b` are (bytes, operations) and (ms, bytes, operations) of the
    standalone kernels.  `sec` (the secondary code; `pro` with both replica
    families) selects the pilot form.  Returns the rows of the fused launch
    without and with the fold."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    x = _cnoise(rng, n_wins * s0 + nfft, dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    rf = torch.fft.fft(pro.rep_t, dim=-1)
    rf_c = torch.conj_physical(rf)
    k = pro.tap_samps.shape[1]
    pilot = sec is not None
    scratch = tb.k1_scratch(c, e, k + pilot, nfft, dev)
    slabs = scratch.partials.shape[1]
    k1_in = (pro.w0, pro.lag_int, pro.lag_frac, pro.ph_sc, pro.tap_samps,
             pro.omega)
    codes_rep, taps_t = fold_in

    def planes():
        pl = tb._empty_planes(3 * e, c, dev)
        for v in pl.values():
            v.zero_()
        return pl

    def next_pro():
        return tb._empty_prologue(c, e, nfft, k, dev, 1 + pilot)
    corr_r = tb.block_correlate(xf_all, rf_c, *k1_in, scratch=scratch)
    pl_r = planes()
    new_r = tb.block_closure(conf, e, corr_r, pro, st, pl_r, 1, sec)
    nxt_r = tb.block_prologue(conf, e, codes_rep, taps_t, n_wins, new_r)
    outs = []
    for fold in (None, None, next_pro(), next_pro()):
        corr_f, pl_f = torch.empty_like(corr_r), planes()
        new_f = tb.block_correlate_close(
            conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f,
            scratch=scratch,
            fold=None if fold is None else (codes_rep, taps_t, fold),
            sec_code=sec)
        outs.append((corr_f, new_f, pl_f, fold))
    torch.cuda.synchronize()
    flags = scratch.flags.tolist()
    if flags != [2 if slabs > 1 else 0] * c:
        fail(f"{names[1]} ({label}): fold flags {flags} after two folded "
             f"launches of S={slabs} slabs")
    counters_at_zero(f"{names[1]} ({label})", scratch.arrivals)
    for i, (corr_f, new_f, pl_f, fold) in enumerate(outs):
        diff = differing(new_f, new_r, pl_f, pl_r)
        if not torch.equal(bits(corr_f), bits(corr_r)):
            diff.insert(0, "correlations")
        if fold is not None:
            diff += [f"next prologue {n}" for n in tb.BlockPrologue._fields
                     if not torch.equal(bits(getattr(fold, n)),
                                        bits(getattr(nxt_r, n)))]
        if diff:
            fail(f"{names[i // 2]} ({label}): launch {i % 2 + 1} differs "
                 f"from K1 then K8b{' then K8a' if fold else ''} in {diff}")
    print(f"  {names[0]} ({label}): correlations, next state and plane "
          "rows bit for bit those of K1 then K8b; two launches "
          f"bit-identical; with the fold ({names[1]}, S={slabs}) also the "
          "next block's prologue bit for bit the standalone K8a's on K8b's "
          f"state, fold flags {flags[0]} after two launches")
    pl_f, corr_f, nxt = planes(), torch.empty_like(corr_r), next_pro()
    ms = time_ms(lambda: tb.block_correlate_close(
        conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f, scratch=scratch,
        sec_code=sec))
    ms_fold = time_ms(lambda: tb.block_correlate_close(
        conf, e, xf_all, rf, pro, st, pl_f, 1, corr=corr_f, scratch=scratch,
        fold=(codes_rep, taps_t, nxt), sec_code=sec))
    k1_ms = time_ms(lambda: tb.block_correlate(
        xf_all, rf_c, *k1_in, out=corr_r, scratch=scratch))
    k8a_ms = time_ms(lambda: tb.block_prologue(conf, e, codes_rep, taps_t,
                                               n_wins, new_r))
    counters_at_zero(f"{names[0]} ({label})", scratch.arrivals)

    def plain():
        corr = tb._block_correlate_plain(xf_all, torch.conj_physical(rf),
                                         *k1_in)
        _, o = tb._block_closure_plain(conf, e, corr, pro, st, sec)
        tb._write_rows(pl_r, o, 1, e)
    plain_ms = time_ms(plain, reps=3)

    def plain_fold():
        _, _, o, _ = tb._step_plain(conf, e, xf_all, rf, pro, st,
                                    codes_rep, taps_t, sec_code=sec)
        tb._write_rows(pl_r, o, 1, e)
    plain_fold_ms = time_ms(plain_fold, reps=3)
    print(f"  {names[0]} ({label}): fused {ms:.4f} ms, K1 alone {k1_ms:.4f} "
          f"ms in the same build: the closure adds {ms - k1_ms:.4f} ms "
          f"(standalone K8b {k8b[0]:.4f} ms); with the fold {ms_fold:.4f} "
          f"ms: the next prologue adds {ms_fold - ms:.4f} ms (standalone "
          f"K8a {k8a_ms:.4f} ms; the fold "
          f"{'saves' if ms_fold < ms + k8a_ms else 'costs'} "
          f"{abs(ms + k8a_ms - ms_fold):.4f} ms of device time a block)")
    rows = len({min(max(int(w), 0), n_wins - e) + i
                for w in pro.w0.tolist() for i in range(e)})
    # the pilot form: the data spectrum read once (C F 8 bytes), per
    # (c, e, f) two complex products and an accumulate, 14
    n_bytes = rows * nfft * 8 + (1 + pilot) * c * nfft * 8 + c * e * 12 \
        + c * e * (k + pilot) * 8 + k8b[1]
    n_ops = c * nfft * (k * 5 + e * (18 + k * 8 + 14 * pilot)) + k8b[2]
    src = "gnss_sim_receiver_tpu_torch/csrc/block_correlator.cu"
    at = "gnss_sim_receiver_tpu/models/tracking_block.py:149"
    row = _row(names[0], "cuda", src, at, 0.0, ms, plain_ms, n_bytes, n_ops,
               shape + f", S={slabs} slabs")
    row_fold = _row(names[1], "cuda", src, at, 0.0, ms_fold, plain_fold_ms,
                    n_bytes + k8a[0], n_ops + k8a[1],
                    shape + f", S={slabs} slabs")
    row["k1_ms"] = row_fold["k1_ms"] = k1_ms
    row_fold["k8a_ms"] = k8a_ms
    return row, row_fold


BLOCK_CHUNK_BLOCKS = 50


def check_block_chunk_bits(dev, rng, conf, c: int, taps, provider,
                           label: str, data_provider=None) -> dict:
    """The two-launch chunk (K8a for the first block, then per block the
    cuFFT and K1 with K8b's closure and the next block's prologue fused)
    against the three-launch chunk (per block K8a, the cuFFT, K1 with K8b)
    and the plain chunk (the plain K8a and K8b around K1's kernel) over
    BLOCK_CHUNK_BLOCKS blocks at `conf`'s shape with C channels, from
    block_state's edge states on a noise capture: every plane and the final
    state bit for bit; the arrival counters back at 0 and the fold flags at
    the chunk's folded launches (with S > 1).  Timed per chunk by graph
    replay and on the host per block, both forms.  With `data_provider`
    the pilot form (both replica families, the secondary code)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    s0, nfft = conf.nominal_epoch_samples, tb.block_fft_size(conf)
    e = max(2, int(round(0.02 / conf.t_epoch_nominal_s)))
    n = BLOCK_CHUNK_BLOCKS
    codes_rep, sec = pilot_tables(conf, c, provider, data_provider, dev)
    pilot = sec is not None
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)
    st = block_state(rng, conf, c, e, 2 * e + 2, dev, pilot)
    x = _cnoise(rng, (n * e + 2 * e + 4) * s0 + nfft, dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    args = (conf, n, e, codes_rep, taps_t, xf_all, st)
    k1 = tb.k1_scratch(c, e, len(taps) + pilot, nfft, dev)
    slabs = k1.partials.shape[1]
    two_st, two = tb._chunk_cuda(*args, fold=True, k1=k1, sec_code=sec)
    three_st, three = tb._chunk_cuda(*args, fold=False, sec_code=sec)
    plain_st, plain = tb._chunk_plain(*args, sec)
    torch.cuda.synchronize()
    flags = k1.flags.tolist()
    if flags != [n - 1 if slabs > 1 else 0] * c:
        fail(f"two-launch chunk ({label}): fold flags {flags} after "
             f"{n - 1} folded launches of S={slabs} slabs")
    counters_at_zero(f"two-launch chunk ({label})", k1.arrivals)
    plain_note = "and of the plain chunk"
    for ref_st, ref, what in ((three_st, three, "the three-launch chunk"),
                              (plain_st, plain, "the plain chunk")):
        diff = differing(two_st, ref_st, two, ref)
        if diff and pilot and ref is plain:
            # the pilot form: held to the plain chunk as phase 3's 50-block
            # chunk of phase 4's path is, where their bits part
            plain_note = pilot_chunk_within(conf, two_st, two, plain_st,
                                            plain, label)
        elif diff:
            fail(f"two-launch chunk ({label}): {diff} differ in bits from "
                 f"{what}")
    active = int(two_st.active.sum())

    def host_ms(fold):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb._chunk_cuda(*args, fold=fold, sec_code=sec)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n
    # the median of 5 runs of each, in turns
    runs = [(host_ms(True), host_ms(False)) for _ in range(5)]
    h_two, h_three = (float(np.median(r)) for r in zip(*runs))
    ms_two = time_ms(lambda: tb._chunk_cuda(*args, fold=True, sec_code=sec),
                     reps=2)
    ms_three = time_ms(lambda: tb._chunk_cuda(*args, fold=False,
                                              sec_code=sec), reps=2)
    print(f"  two-launch chunk ({label}: C={c}, E={e}, F={nfft}, S={slabs}): "
          f"{n} blocks, planes and final state bit for bit those of the "
          f"three-launch chunk {plain_note} ({active} channels "
          f"still active); fold flags {flags[0]}; device {ms_two:.4f} ms a "
          f"chunk ({ms_two / n:.5f} a block) against {ms_three:.4f} "
          f"({ms_three / n:.5f}); host {h_two:.4f} ms a block against "
          f"{h_three:.4f} (medians of 5)")
    return dict(name="block_chunk", shape=f"{label}: C={c}, E={e}, "
                f"F={nfft}, S={slabs}, {n} blocks",
                ms_two_launch=ms_two, ms_three_launch=ms_three,
                host_ms_per_block_two_launch=h_two,
                host_ms_per_block_three_launch=h_three)


PILOT_SYNC_PRNS = tuple(range(11, 21))
PILOT_SYNC_BLOCKS = 8
# the planted sign histories (tests/test_torch_block_pilot.py): channel ->
# its wrong epochs before the arm, and the block at which it must sync
SYNC_WRONG = {0: (-10,), 1: (-20, -15)}
SYNC_BLOCK = {0: 3, 1: 2}


def check_pilot_sync(dev, conf, label: str) -> dict:
    """Phase 3, the pilot form: a planted CS25 sync.  Ten Galileo
    satellites carrying E1-B (random symbols) and E1-C (the CS25 tiled), 45
    dB-Hz each, made by K6 with noise; every channel armed on truth three
    epochs in, its sign history empty.  PILOT_SYNC_BLOCKS blocks through
    the fused launch with the fold (from one K8a) and through the plain
    step (_step_plain), each from its own state: every channel must sync,
    in both at the same block with the same sec_off and polarity."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    fs, s0 = conf.fs, conf.nominal_epoch_samples
    nfft = tb.block_fft_size(conf)
    e, nb, start = 5, PILOT_SYNC_BLOCKS, 3
    c = len(PILOT_SYNC_PRNS)
    rng = np.random.default_rng(25)
    dops = rng.uniform(-3000.0, 3000.0, c)
    delays = rng.integers(100, s0 - 100, c)
    cs25 = signals.e1c_secondary_code().astype(np.int8)
    sats = []
    for p, d, n in zip(PILOT_SYNC_PRNS, dops, delays):
        kw = dict(prn=p, system="Galileo", cn0_db_hz=45.0,
                  doppler_hz=float(d), delay_chips=float(n) * 1.023e6 / fs)
        sats += [SatelliteSignalParams(
                     signal="1B", nav_bits=rng.choice([-1, 1], 40).astype(
                         np.int8), **kw),
                 SatelliteSignalParams(signal="1P", nav_bits=np.tile(cs25, 3),
                                       **kw)]
    n = int(delays.max()) + (start + nb * e + 4) * s0 + nfft
    x = generate_baseband_device_resident(sats, fs, n, noise=True, seed=25,
                                          device=dev)
    xf_all = tb._window_spectra(x, s0, nfft).contiguous()
    n_wins = xf_all.shape[0]
    codes_rep, sec = pilot_tables(conf, c, signals.CodeProvider("1B", "C"),
                                  signals.CodeProvider("1B"), dev,
                                  PILOT_SYNC_PRNS)
    st = trk._init_state(c, dev)
    for ch, d in enumerate(dops):
        st = trk._arm_channel(st, ch, float(d), conf.code_rate_cps
                              * (1.0 + float(d) / conf.carrier_freq_hz))
    pos = delays.astype(np.int64) + start * s0
    st = st._replace(
        pos=torch.from_numpy(pos.astype(np.int32)).to(dev),
        rem_carr_phase=torch.from_numpy(np.mod(
            2.0 * np.pi * dops * pos / fs, 2.0 * np.pi).astype(
                np.float32)).to(dev))
    taps_t = torch.tensor(conf_taps(conf), dtype=torch.float32, device=dev)
    k = taps_t.shape[0]
    scratch = tb.k1_scratch(c, e, k + 1, nfft, dev)
    planes = tb._empty_planes(nb * e, c, dev)

    def first_syncs(st0):
        """(block, sec_off, polarity) of each channel's first sync, through
        the fused launch and through the plain step, from `st0`."""
        pro_k = tb.block_prologue(conf, e, codes_rep, taps_t, n_wins, st0)
        pro_p = tb._block_prologue_plain(conf, e, codes_rep, taps_t, n_wins,
                                         st0)
        st_k = st_p = st0
        first = {}
        for b in range(nb):
            nxt = tb._empty_prologue(c, e, nfft, k, dev, 2)
            st_k = tb.block_correlate_close(
                conf, e, xf_all, torch.fft.fft(pro_k.rep_t, dim=-1), pro_k,
                st_k, planes, b, scratch=scratch,
                fold=(codes_rep, taps_t, nxt), sec_code=sec)
            pro_k = nxt
            _, st_p, _, pro_p = tb._step_plain(
                conf, e, xf_all, torch.fft.fft(pro_p.rep_t, dim=-1), pro_p,
                st_p, codes_rep, taps_t, sec_code=sec)
            for name, s_ in (("kernel", st_k), ("plain", st_p)):
                synced = s_.sec_synced.cpu().numpy()
                off = s_.sec_off.cpu().numpy()
                pol = s_.sec_polarity.cpu().numpy()
                for ch in np.flatnonzero(synced):
                    first.setdefault((name, int(ch)),
                                     (b, int(off[ch]), float(pol[ch])))
        return ([first.get(("kernel", ch)) for ch in range(c)],
                [first.get(("plain", ch)) for ch in range(c)])

    got, want = first_syncs(st)
    print(f"  planted CS25 ({label}, {c} channels, {nb} blocks): the fused "
          f"launch syncs at (block, sec_off, polarity) {got}; the plain "
          f"step at {want}")
    if None in want or got != want:
        fail(f"planted CS25 ({label}): the fused launch syncs at {got}, "
             f"the plain step at {want}")
    # the sync threshold (n_sec): on SYNC_WRONG's channels the sign history
    # of the 20 epochs before the arm planted right but for the listed
    # signs holds the best match at n_sec - 2 (n_sec - 4) until they leave
    # the last n_sec epochs; the other channels' histories stay empty
    hist = np.zeros((c, trk.N_SEC_MAX), np.float32)
    sec_h = sec.cpu().numpy()
    k_ep = np.arange(-20, 0)
    for ch, wrong in SYNC_WRONG.items():
        _, off, pol = want[ch]
        hist[ch, -20:] = pol * sec_h[(k_ep + off) % len(sec_h)]
        for w in wrong:
            hist[ch, w] *= -1.0
    got_p, want_p = first_syncs(st._replace(
        sec_buf=torch.from_numpy(hist).to(dev)))
    print(f"  planted CS25 history ({label}; channel -> wrong epochs "
          f"{SYNC_WRONG}): the fused launch syncs at {got_p}; the plain "
          f"step at {want_p}")
    # a planted channel's block is known where its first n_sec signs were
    # right unplanted (it synced at the earliest block, 4)
    expect = {ch: SYNC_BLOCK[ch] for ch in SYNC_WRONG if want[ch][0] == 4}
    if (got_p != want_p or not expect
            or any(want_p[ch][0] != b for ch, b in expect.items())
            or any(want_p[ch][1:] != want[ch][1:] for ch in range(c))
            or any(want_p[ch] != want[ch] for ch in range(c)
                   if ch not in SYNC_WRONG)):
        fail(f"planted CS25 history ({label}): the fused launch syncs at "
             f"{got_p}, the plain step at {want_p}; channels {expect} must "
             "sync at those blocks, every channel at its unplanted offset "
             "and polarity, the unplanted ones at their unplanted blocks")
    return dict(name="planted_cs25_sync", shape=f"{label}: C={c}, E={e}, "
                f"F={nfft}, {nb} blocks", sync=got, planted_sync=got_p)


def pilot_chunk_within(conf, got_st, got, want_st, want, label) -> str:
    """The pilot-form chunk `got` against the plain chunk `want` where
    their bits part: the active and secondary-sync sets identical, the
    code boundary of every epoch within 1e-3 chip, the Doppler within 0.5
    Hz and the prompts within 1e-3 of their largest modulus (the bounds of
    phase 3's 50-block chunk of phase 4's path).  Returns what it found,
    for the log."""
    import torch
    valid = want["valid"]

    def boundary(o):
        end = (o["pos_start"] + o["n_samples"]).double()
        return ((end - o["code_phase_samples"].double())
                * o["code_freq_cps"].double() / conf.fs)
    d_code = (boundary(got) - boundary(want))[valid].abs().max().item()
    d_dop = (got["carrier_doppler_hz"] - want["carrier_doppler_hz"]
             ).abs().max().item()
    d_prompt = ((got["prompt"] - want["prompt"]).abs().max()
                / want["prompt"].abs().max()).item()
    same = all(torch.equal(getattr(got_st, k), getattr(want_st, k))
               for k in ("active", "sec_synced", "sec_off"))
    if not (same and torch.equal(got["valid"], valid) and d_code < 1e-3
            and d_dop < 0.5 and d_prompt < 1e-3):
        fail(f"two-launch chunk ({label}): departs from the plain chunk: "
             f"sets {'identical' if same else 'DIFFERENT'}, code {d_code}, "
             f"Doppler {d_dop}, prompts {d_prompt}")
    return (f"and within the plain chunk's bounds (code {d_code:.2e} chip, "
            f"Doppler {d_dop:.2e} Hz, prompts {d_prompt:.2e}; active and "
            "sync sets identical)")


def check_k2(dev, rng, conf, c: int, taps, provider, name: str,
             label: str, data_provider=None):
    """K2 against its plain version at `conf`'s block size, C channels, the
    given taps (chips) and the band-limited tables of `provider`'s codes
    (8 entries per chip); timed there.  With `data_provider`, K2's data
    form: one more zero-offset tap on that provider's tables in the same
    pass, against a second plain correlation."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import correlator, prn_codes
    fs, s0, b = conf.fs, conf.nominal_epoch_samples, conf.block_size
    n = max(1 << 18, 4 * b)
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                          ).astype(np.complex64)).to(dev)

    def tables(prov):
        return torch.from_numpy(np.stack([
            prn_codes.bandlimited_table_normalized(
                prov(p), fs, conf.code_rate_cps, s0, 8)
            for p in range(1, c + 1)])).to(dev)
    codes = tables(provider)
    data = None if data_provider is None else tables(data_provider)
    taps_t = torch.tensor(taps, dtype=torch.float32, device=dev)

    def t(a, dt=np.float32):
        return torch.from_numpy(np.asarray(a, dt)).to(dev)
    args = (x, t(rng.integers(0, n - b, c), np.int32), b, codes, taps_t,
            t(rng.uniform(0, 1, c)),
            t(conf.code_rate_cps + rng.uniform(-5, 5, c)),
            t(rng.uniform(0, 2 * np.pi, c)), t(rng.uniform(-5000, 5000, c)),
            t(rng.integers(s0 - 1, s0 + 2, c), np.int32), fs, 8)

    scratch = correlator.k2_scratch(codes, len(taps), b, 8, data, 8)

    def kernel():
        return correlator.multicorrelate(*args, data_codes=data,
                                         data_oversample=8, scratch=scratch)

    def plain():
        blocks = correlator.gather_blocks(x, args[1], b)
        corr = correlator.correlate_multitap(blocks, codes, taps_t,
                                             *args[5:])
        if data is None:
            return corr
        zero = torch.zeros(1, dtype=torch.float32, device=dev)
        return torch.cat([corr, correlator.correlate_multitap(
            blocks, data, zero, *args[5:])], 1)
    got = kernel()
    again = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-4)
    same_bits(f"{name} ({label})", got, again)
    print(f"  {name} ({label}): S={scratch.plan.slabs} slabs, staged "
          f"{scratch.plan.stage} + {scratch.plan.data_stage} table entries, "
          f"{int(scratch.misses)} reads outside them in two launches")
    ms = time_ms(kernel)
    counters_at_zero(f"{name} ({label})", scratch.arrivals)
    n_samp = int(args[9].sum())
    k = len(taps) + (data is not None)
    n_bytes = c * b * 8 + codes.numel() * 4 * (1 + (data is not None)) \
        + c * k * 8
    # per sample: phase 3, sincos 2, wipeoff 6, chips 3; per tap: index 3,
    # multiply-accumulate 4
    n_ops = n_samp * (14 + k * 7)
    return _row(name, "cuda",
                "gnss_sim_receiver_tpu_torch/csrc/multicorrelator.cu",
                "gnss_sim_receiver_tpu/ops/correlator.py:39"
                if data is None else
                "gnss_sim_receiver_tpu/models/tracking.py:398",
                err, ms, time_ms(plain), n_bytes, n_ops,
                f"{label}: C={c} channels, B={b}-sample blocks, K={len(taps)}"
                f" taps{' + the data tap' if data is not None else ''}, "
                f"table{'s' if data is not None else ''} {codes.shape[1]} "
                f"float32, S={scratch.plan.slabs} slabs")


K9_RTOL = 1e-5          # K9's float fields where not identical, of max |plain|


def conf_taps(conf):
    """The engine's taps for `conf`, chips: E, P, L or VE, E, P, L, VL."""
    d, dv = conf.early_late_space_chips, conf.very_early_late_space_chips
    return (dv, d / 2, 0.0, -d / 2, -dv) if dv > 0 else (d / 2, 0.0, -d / 2)


def epoch_corr(rng, c: int, taps, data: bool, dev):
    """[C, K] correlations shaped like a tracked channel's (a triangle over
    the taps, a carrier phase error, sign flips, noise) and, with `data`,
    the data prompt as one more column."""
    import torch
    amp = rng.uniform(200.0, 2000.0, (c, 1))
    tri = np.maximum(1.0 - np.abs(np.asarray(taps)) * 2.0, 0.1)[None]
    bits = np.where(rng.random((c, 1)) < 0.5, -1.0, 1.0)
    ph = rng.normal(0.0, 0.3, (c, 1))
    cols = [amp * tri * bits * np.exp(1j * ph)]
    if data:
        cols.append(0.9 * amp * np.where(rng.random((c, 1)) < 0.5, -1.0, 1.0)
                    * np.exp(1j * ph))
    z = np.concatenate(cols, 1)
    z = z + (rng.standard_normal(z.shape + (2,)) @ [1.0, 1j]) * 60.0
    return torch.from_numpy(z.astype(np.complex64)).to(dev)


def epoch_state(rng, conf, c: int, sign, dev, kalman_edges: bool = True):
    """A TrackState of C >= 6 channels on the per-epoch closure's edges,
    every other field spread over the range its paths give it (consistent
    C/N0 sums, ext sums of ext_n prompts).  `sign` [C]: the sign of each
    channel's prompt-I in the correlations it will meet.  Channel 0: the
    secondary sync about to hit (pilot) or a bit-sync histogram one
    transition short of dominance (GPS); 1: synced (pilot polarity -1), a
    coherent group that closes; 2: a group that restarts at its boundary,
    on the C/N0 window's last epoch; 3: a lock loss on that epoch; 4:
    inactive; 5: in the FLL pull-in.  A Kalman conf's (kf, gaussian)
    covariances are random positive definite ones, its Doppler rates and
    posteriors spread; with `kalman_edges` (C >= 8) channel 6's covariance
    makes the innovation matrix S singular (its determinant floored at
    1e-20) and channel 7's posterior has nu < 3 and scale sums under the
    floors of R (the gaussian mode's floors)."""
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    st = interop.track_state_to_numpy(trk._init_state(c, "cpu"))
    bias = conf.doppler_bias_hz          # as block_state's
    dop = bias + rng.uniform(-4500.0, 4500.0, c)
    ep, w = conf.fll_pullin_epochs, conf.cn0_window_epochs
    k = max(conf.extend_correlation_symbols, 1)
    n = len(conf.secondary_code)
    epoch = rng.integers(ep + 1, ep + 400, c).astype(np.int32)
    epoch[2] = epoch[3] = (ep // w + 3) * w - 1
    epoch[5] = 5
    count = (epoch % w).astype(np.float32)
    amp = rng.uniform(500.0, 2000.0, c)
    lock_i = np.where(np.arange(c) == 3, 0.01, 0.9)

    def f(a):
        return np.asarray(a, np.float32)
    ext_n = rng.integers(0, k, c).astype(np.int32)
    ext_n[1] = k - 1
    ext = (amp * ext_n * np.exp(1j * rng.normal(0, 0.3, c))).astype(
        np.complex64)
    st.update({
        "active": np.arange(c) != 4,
        "pos": rng.integers(0, 1 << 20, c).astype(np.int32),
        "rem_code_phase": f(rng.uniform(-0.5, 0.5, c)),
        "code_freq": f(conf.code_rate_cps
                       * (1.0 + (dop - bias) / conf.carrier_freq_hz)
                       + rng.uniform(-0.05, 0.05, c)),
        "carrier_doppler": f(dop),
        "rem_carr_phase": f(rng.uniform(-1.0, 2.0 * np.pi, c)),
        "acc_phase_cycles": f(rng.uniform(-1e5, 1e5, c)),
        "acc_phase_comp": f(rng.uniform(-1e-3, 1e-3, c)),
        "dll.vel": f(rng.uniform(-0.5, 0.5, c)),
        "pll.vel": f(dop + rng.uniform(-1.0, 1.0, c)),
        "pll.acc": f(rng.uniform(-5.0, 5.0, c)),
        "prompt_prev": ((rng.standard_normal(c) + 1j * rng.standard_normal(c))
                        * amp).astype(np.complex64),
        "epoch": epoch,
        "cn0_acc.count": count,
        "cn0_acc.sum_abs_i": f(count * amp), "cn0_acc.sum_abs_q": f(
            count * amp * 0.2),
        "cn0_acc.sum_m2": f(count * amp ** 2 * 1.05),
        "cn0_acc.sum_m4": f(count * amp ** 4 * 1.2),
        "cn0_acc.sum_i": f(count * amp * lock_i * sign),
        "cn0_acc.sum_q": f(count * amp * 0.3),
        "cn0_db_hz": f(rng.uniform(30.0, 50.0, c)),
        "carrier_lock": f(np.where(np.arange(c) == 3, 0.3,
                                   rng.uniform(0.8, 1.0, c))),
        "lock_fail": f(np.where(np.arange(c) == 3, conf.max_lock_fail,
                                rng.integers(0, 5, c))),
        "prev_sign": f(rng.choice([-1.0, 1.0], c)),
        "bit_hist": f(rng.integers(0, 4, (c, 20))),
        "bit_synced": np.arange(c) != 0,
        "bit_phase": rng.integers(0, 20, c).astype(np.int32),
        "ext_p": ext, "ext_e": (ext * 0.6).astype(np.complex64),
        "ext_l": (ext * 0.5).astype(np.complex64), "ext_n": ext_n,
        "sec_synced": np.arange(c) != 0,
        "sec_polarity": f(np.where(np.arange(c) == 1, -1.0, 1.0)),
    })
    idx0 = epoch[0] % 20
    st["bit_hist"][0, idx0] = conf.bit_sync_min_transitions - 1
    st["prev_sign"][0] = -sign[0]
    st["bit_phase"][1] = (epoch[1] + 7) % 20
    st["bit_phase"][2] = epoch[2] % 20
    if n:
        from gnss_sim_receiver_tpu_torch.models.tracking import secondary_pm1
        sec = secondary_pm1(conf)
        st["sec_buf"][:, :n] = np.where(rng.random((c, n)) < 0.5, 1.0, -1.0)
        st["sec_off"] = rng.integers(0, n, c).astype(np.int32)
        off0 = int(st["sec_off"][0])
        pol0 = sign[0] * sec[(epoch[0] % n + off0) % n]
        st["sec_buf"][0, :n] = pol0 * sec[(np.arange(n) + off0) % n]
        st["sec_off"][1] = (3 - epoch[1]) % n
        st["sec_off"][2] = (-epoch[2]) % n
    if conf.kalman:
        scale = np.sqrt([1e-2, 1e-2, 30.0, 3.0])
        m = rng.standard_normal((c, 4, 4)) * scale[None, :, None]
        st["kf_p"] = f(m @ m.transpose(0, 2, 1) / 4.0
                       + np.diag([1e-4, 1e-5, 1.0, 0.1])[None])
        st["kf_fdot"] = f(rng.uniform(-5.0, 5.0, c))
        nu = rng.uniform(30.0, 200.0, c)
        st["bayes_nu"] = f(nu)
        st["bayes_psi_code"] = f(nu * rng.uniform(1e-3, 1e-2, c))
        st["bayes_psi_carr"] = f(nu * rng.uniform(1e-4, 1e-3, c))
        if kalman_edges:
            # P[:2, :2] not positive definite: S's determinant < 0
            st["kf_p"][6] = f(np.diag([0.05, 0.05, 100.0, 10.0]))
            st["kf_p"][6, 0, 1] = st["kf_p"][6, 1, 0] = 0.2
            st["bayes_nu"][7] = 2.5
            st["bayes_psi_code"][7] = 1e-7
            st["bayes_psi_carr"][7] = 1e-8
    return interop.track_state_from_numpy(st, dev)


def state_bytes(conf) -> int:
    """Bytes of one channel's state that the closure moves each way: the
    Kalman trackers' fields in their modes only."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    return sum(torch.empty(0, dtype=dt).element_size() * trk._WIDE.get(f, 1)
               for f, dt in trk._EPOCH_STATE_FIELDS
               if conf.kalman or f not in trk._KALMAN_FIELDS)


def closure_ops(conf) -> int:
    """The closure's operations per channel: ~300, the n_sec x n_sec shift
    correlation, and in the Kalman modes the 4x4 products F P F^T and
    (I - K H) P' (3 x 64 products, 3 x 48 sums) and the gain (~50)."""
    n_sec = len(conf.secondary_code)
    return 300 + 2 * n_sec * n_sec + (386 if conf.kalman else 0)


def check_k9(dev, rng, conf, c: int, name: str, label: str):
    """K9 against its plain version, one epoch of C channels from the edge
    states of epoch_state on correlations of epoch_corr (with the data
    prompt on a track_pilot conf); timed there.  The target is bit
    equality of the next state, the plane row and the next epoch's
    lengths; integer and bool fields must be identical, float fields where
    not identical within K9_RTOL of max |plain|.  Fails unless the edges
    were reached."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    taps = conf_taps(conf)
    k = len(taps)
    data = conf.track_pilot
    corr = epoch_corr(rng, c, taps, data, dev)
    sign = np.where(corr[:, k // 2].real.cpu().numpy() >= 0, 1.0, -1.0)
    st = epoch_state(rng, conf, c, sign, dev)
    n_c = trk._epoch_length(conf, st)
    planes = trk._empty_planes(3, c, dev, trk.EPOCH_PLANES)
    planes_p = trk._empty_planes(3, c, dev, trk.EPOCH_PLANES)
    for pl in (planes, planes_p):
        for v in pl.values():
            v.zero_()
    nc_k = n_c.clone()
    new_k = trk.epoch_closure(conf, corr, nc_k, st, planes, 1)
    dcol = corr[:, k] if data else None
    new_p, outs = trk._epoch_closure_plain(conf, st, corr[:, :k], dcol, n_c)
    trk._write_row(planes_p, outs, 1)
    nc_p = trk._epoch_length(conf, new_p)
    torch.cuda.synchronize()
    gk = interop.track_state_to_numpy(new_k)
    gp = interop.track_state_to_numpy(new_p)
    pairs = [(f"state {key}", torch.from_numpy(gk[key]),
              torch.from_numpy(gp[key])) for key in gp]
    pairs += [(f"plane {key}", planes[key], planes_p[key])
              for key, _ in trk.EPOCH_PLANES]
    pairs.append(("next n_c", nc_k, nc_p))
    differ, err, worst_ulp = [], 0.0, 0.0
    for what, g, w in pairs:
        if torch.equal(g, w):
            continue
        differ.append(what)
        if not (g.is_floating_point() or g.is_complex()):
            fail(f"{name} ({label}): {what} differs: {g} vs {w}")
        if not g.is_complex():
            worst_ulp = max(worst_ulp, ulps(g, w))
        err = max(err, compare(f"{name} ({label}) {what}", g, w, K9_RTOL))
    # the edges were reached
    k_ext = conf.extend_correlation_symbols
    edges = {"inactive": gp["pos"][4] == int(st.pos[4])
             + conf.nominal_epoch_samples,
             "lock loss": bool(gp["lock_lost"][3]) and not gp["active"][3],
             "window": gp["cn0_acc.count"][2] == 0}
    if conf.secondary_code:
        edges["secondary hit"] = bool(gp["sec_synced"][0])
    elif k_ext > 1:
        edges["bit sync"] = bool(gp["bit_synced"][0])
    if k_ext > 1 and not conf.kalman:
        edges["group closes"] = gp["ext_n"][1] == 0
        edges["group restarts"] = gp["ext_n"][2] == 1
    if conf.kalman:
        # S = P'[:2, :2] + R of channel 6, from the plain prediction
        pred = trk._kf_predict(conf, st.kf_p, n_c.to(torch.float32)
                               / np.float32(conf.fs)).cpu().numpy()[6]
        r = (conf.kf_r_code_chips2, conf.kf_r_phase_cyc2)
        if conf.tracking_mode == "gaussian":
            r = tuple(float(v[6]) for v in trk._bayes_r(st))
        det = ((pred[0, 0] + r[0]) * (pred[1, 1] + r[1])
               - pred[0, 1] * pred[0, 1])
        edges["determinant floor"] = det <= 1e-20
        edges["covariance updated"] = not np.array_equal(
            gp["kf_p"][0], interop.track_state_to_numpy(st)["kf_p"][0])
        if conf.tracking_mode == "gaussian":
            nu7 = float(st.bayes_nu[7])
            edges["posterior floors"] = (nu7 - 2.0 < 1.0 and all(
                float(v[7]) in (np.float32(1e-5), np.float32(1e-6))
                for v in trk._bayes_r(st)))
    missed = [e for e, ok in edges.items() if not ok]
    if missed:
        fail(f"{name} ({label}): edges not reached: {missed}")
    print(f"  {name} ({label}): edges {sorted(edges)} reached; "
          + ("next state, plane row and next lengths bit for bit"
             if not differ else f"{len(differ)} fields not identical, "
             f"worst {worst_ulp:g} ulp, within {err:.3e} (tolerance "
             f"{K9_RTOL:g} x max |plain|)"))
    out = trk._empty_epoch_state(st, conf.kalman)
    nc_t = n_c.clone()
    args = trk._epoch_args(conf, corr, nc_t, trk._sec_device(conf, dev), st,
                           out, planes)
    ms = time_ms(lambda: trk._launch_closure(
        args, 1, torch.cuda.current_stream(dev).cuda_stream))
    plain = time_ms(lambda: trk._epoch_closure_plain(conf, st, corr[:, :k],
                                                     dcol, n_c))
    # reads and writes the state fields, reads the correlations, reads and
    # writes n_c, writes one row of the 13 planes; per channel the
    # closure's operations (closure_ops)
    st_bytes = c * state_bytes(conf)
    row_bytes = c * (2 * 8 + 8 * 4 + 2 * 4 + 1)
    n_bytes = 2 * st_bytes + corr.numel() * 8 + 2 * c * 4 + row_bytes
    n_sec = len(conf.secondary_code)
    n_ops = c * closure_ops(conf)
    return _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/epoch_step.cu",
                "gnss_sim_receiver_tpu/models/tracking.py:376", err, ms, plain,
                n_bytes, n_ops,
                f"{label}: C={c} channels, K={k} taps"
                + (" + data tap" if data else "")
                + (f", secondary {n_sec}" if n_sec else "")
                + f", k_ext={k_ext}" + form_label(conf))


def form_label(conf) -> str:
    """The closure form of a shape's label, but the third-order loops'."""
    if conf.kalman:
        return f", {conf.tracking_mode}"
    return ", second-order PLL" if conf.pll_filter_order != 3 else ""


CHUNK_CHECK_EPOCHS = 50


def chunk_bytes(x, st0, st1, codes, data, planes, conf) -> float:
    """The bytes one chunk must move: the samples of `x` that its channels
    read (the union of each channel's window, from its position in `st0`
    to its position in `st1`), each code table once (they stay in L2),
    the state in and out once and the planes written once."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    p0, p1 = (s.pos.cpu().numpy().astype(np.int64) for s in (st0, st1))
    lo, hi = np.minimum(p0, p1), np.maximum(p0, p1)
    order = np.argsort(lo)
    n_samp, end = 0, 0
    for a, b in zip(lo[order], hi[order]):      # the union's length
        a = max(a, end)
        if b > a:
            n_samp += b - a
            end = b
    st_bytes = codes.shape[0] * state_bytes(conf)
    return float(n_samp * x.element_size()
                 + sum(t.numel() * t.element_size() for t in
                       (codes, *(() if data is None else (data,))))
                 + 2 * st_bytes
                 + sum(v.numel() * v.element_size() for v in planes.values()))


def check_epoch_chunk_bits(dev, rng, conf, c: int, name: str, label: str,
                           path_epochs: int, chain=None):
    """The chunk kernel (epoch_chunk) against the two-launch chunk
    (standalone K2 then K9 per epoch) over CHUNK_CHECK_EPOCHS epochs from
    epoch_state's edge states on a noise capture: every plane and the
    final state bit for bit, two launches bit-identical, K2's staged-table
    misses printed; the first epoch's prompts against the plain loop's
    within K2's tolerance.  `chain` gives the code providers (a receiver
    chain; GPS L1 C/A without).  Timed: the chunk of CHUNK_CHECK_EPOCHS
    epochs and the path's chunk of `path_epochs` by graph replay, the
    two-launch chunk and the plain loop of CHUNK_CHECK_EPOCHS; the host
    time per epoch of the chunk kernel and of the two-launch chunk."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    t = CHUNK_CHECK_EPOCHS
    if chain is None:
        eng = trk.TrackingEngine(conf, range(1, c + 1), device=dev)
    else:
        eng = trk.TrackingEngine(conf, range(11, 11 + c),
                                 code_provider=chain.code_provider,
                                 data_code_provider=chain.data_code_provider,
                                 device=dev)
    codes, taps, dcodes = eng.codes, eng.taps, eng.data_codes
    k = taps.shape[0]
    # (a Kalman conf's covariances all positive definite: a singular S would
    # send the channel's loops off over the epochs)
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev,
                     kalman_edges=False)
    x = _cnoise(rng, (1 << 20) + (path_epochs + 2) * conf.block_size, dev)
    args = (conf, t, codes, taps, x, st, dcodes)
    trk.epoch_chunk(*args)                       # builds, plans
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [trk.epoch_chunk(*args, misses=misses) for _ in range(2)]
    ref_st, ref = trk._chunk_two_launch(*args)
    torch.cuda.synchronize()
    for i, (got_st, got) in enumerate(runs):
        diff = differing(got_st, ref_st, got, ref)
        if diff:
            fail(f"{name} ({label}): launch {i + 1} differs from the "
                 f"two-launch chunk in {diff}")
    data, _, _, k2 = trk._chunk_inputs(conf, codes, taps, dcodes)
    n_out = k + int(data is not None)
    plan = trk._chunk_plan(c, k2, n_out, trk.epoch_form(conf))
    print(f"  {name} ({label}): {t} epochs, planes and final state bit for "
          "bit those of the two-launch chunk (K2 then K9 per epoch); two "
          f"launches bit-identical; S={k2.slabs} slabs on clusters of "
          f"S'={plan.cluster} CTAs ({plan.rounds} per CTA, {plan.smem} B of "
          f"dynamic shared memory); {int(misses)} staged-table misses in "
          "two launches")
    plain_t0 = time.perf_counter()
    _, plain = trk._chunk_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - plain_t0)
    err = compare(f"{name} ({label}) first epoch's prompts",
                  (runs[0][1]["prompt"][0], runs[0][1]["pilot_prompt"][0]),
                  (plain["prompt"][0], plain["pilot_prompt"][0]), 1e-4)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / t
    h_chunk = host_ms(lambda: trk.epoch_chunk(*args))
    h_two = host_ms(lambda: trk._chunk_two_launch(*args))

    def fixed(n_ep):
        """A launch of n_ep epochs with its arguments built once."""
        launch = trk.chunk_launch(conf, n_ep, codes, taps, x, st, dcodes,
                                  misses)
        return lambda: trk.launch_chunk(launch)
    ms = time_ms(fixed(t), reps=5)
    ms_path = time_ms(fixed(path_epochs), reps=2)
    two_ms = time_ms(lambda: trk._chunk_two_launch(*args), reps=1)
    print(f"  {name} ({label}): {ms:.4f} ms per chunk of {t} epochs "
          f"({ms / t:.5f} per epoch), {ms_path:.3f} ms per chunk of "
          f"{path_epochs} ({ms_path / path_epochs:.5f} per epoch); the "
          f"two-launch chunk {two_ms:.4f} ms ({two_ms / t:.5f} per epoch); "
          f"host time per epoch: chunk kernel {h_chunk:.4f} ms, two-launch "
          f"{h_two:.4f} ms; plain loop {plain_ms / t:.3f} ms per epoch")
    # per epoch K2's operations (check_k2) and K9's (check_k9)
    n_samp = float(trk._epoch_length(conf, st).sum())
    n_ops = n_samp * (14 + n_out * 7) + c * closure_ops(conf)
    n_bytes = chunk_bytes(x, st, runs[0][0], codes, data, runs[0][1],
                          conf)
    row = _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/epoch_chunk.cu",
               "gnss_sim_receiver_tpu/models/tracking.py:712", err, ms,
               plain_ms, n_bytes, t * n_ops,
               f"{label}: C={c} channels, K={k} taps"
               + (" + data tap" if data is not None else "")
               + f", k_ext={conf.extend_correlation_symbols}, T={t} epochs,"
               f" S={k2.slabs} slabs, S'={plan.cluster}" + form_label(conf))
    row["ms_per_epoch"] = ms / t
    row["ms_path_chunk"] = ms_path
    row["path_epochs"] = path_epochs
    return row


WAVES_CHANNELS = 300


def check_epoch_chunk_waves(dev, rng):
    """The chunk kernel at GPS 2 Msps (S' = 1) with C = WAVES_CHANNELS,
    more channels than the card keeps clusters resident at once: the
    planner's wave count and the card's resident count printed; over
    CHUNK_CHECK_EPOCHS epochs from epoch_state's edge states every plane
    and the final state bit for bit those of the two-launch chunk, two
    launches bit-identical.  Timed per chunk by graph replay.  Returns its
    row (for the other_shapes line)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    c, t = WAVES_CHANNELS, CHUNK_CHECK_EPOCHS
    conf = trk.TrackingConf(fs=FS)
    eng = trk.TrackingEngine(conf, [1 + i % 32 for i in range(c)],
                             device=dev)
    codes, taps = eng.codes, eng.taps
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev)
    x = _cnoise(rng, (1 << 20) + (t + 2) * conf.block_size, dev)
    args = (conf, t, codes, taps, x, st, None)
    _, _, _, k2 = trk._chunk_inputs(conf, codes, taps, None)
    plan = trk._chunk_plan(c, k2, taps.shape[0])
    resident = trk._card_max_clusters(c, plan.cluster, plan.smem)
    print(f"  chunk kernel at C={c}: S={k2.slabs}, S'={plan.cluster}, "
          f"{resident} clusters resident on the card, {plan.waves} waves")
    if resident >= c or plan.waves != -(-c // resident):
        fail(f"chunk kernel at C={c}: {resident} resident, plan {plan}")
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    runs = [trk.epoch_chunk(*args, misses=misses) for _ in range(2)]
    ref_st, ref = trk._chunk_two_launch(*args)
    torch.cuda.synchronize()
    for i, (got_st, got) in enumerate(runs):
        diff = differing(got_st, ref_st, got, ref)
        if diff:
            fail(f"chunk kernel at C={c} (waves): launch {i + 1} differs "
                 f"from the two-launch chunk in {diff}")
    print(f"  chunk kernel at C={c}: {t} epochs, planes and final state bit "
          "for bit those of the two-launch chunk; two launches "
          f"bit-identical; {int(misses)} staged-table misses")
    launch = trk.chunk_launch(conf, t, codes, taps, x, st, None, misses)
    ms = time_ms(lambda: trk.launch_chunk(launch), reps=2)
    two_ms = time_ms(lambda: trk._chunk_two_launch(*args), reps=1)
    print(f"  chunk kernel at C={c}: {ms:.4f} ms per chunk of {t} epochs "
          f"({ms / t:.5f} per epoch); the two-launch chunk {two_ms:.4f} ms")
    n_samp = float(trk._epoch_length(conf, st).sum())
    k = taps.shape[0]
    n_ops = n_samp * (14 + k * 7) + c * 300
    row = _row("K9_epoch_chunk", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/epoch_chunk.cu",
               "gnss_sim_receiver_tpu/models/tracking.py:712", 0.0, ms,
               two_ms, chunk_bytes(x, st, runs[0][0], codes, None,
                                   runs[0][1], conf), t * n_ops,
               f"GPS L1 C/A at 2 Msps: C={c} channels, K={k} taps, T={t} "
               f"epochs, S={k2.slabs}, S'={plan.cluster}, {plan.waves} waves "
               f"({resident} clusters resident); plain_ms: the two-launch "
               "chunk")
    row["waves"] = plan.waves
    row["resident"] = resident
    return row


WAVES_MODEL_FS = 20e6
WAVES_MODEL_SLABS = 8


def check_epoch_chunk_cluster_sizes(dev, rng) -> None:
    """The planner's waves rule where it chooses among cluster sizes: GPS
    L1 C/A at 20 Msps, C = WAVES_CHANNELS, K2's plan forced to S =
    WAVES_MODEL_SLABS slabs (plan_k2 gives S = 1 above as many channels as
    the card has SMs, so no path reaches this case).  Every size S'
    that fits is launched over CHUNK_CHECK_EPOCHS epochs; planes and final
    state must be bit for bit equal across sizes (the leader sums the
    slabs in slab order whatever S').  Per size the card's resident
    clusters, waves, rounds, the rule's cost waves x rounds and the time
    per chunk (graph replay) are printed, then the planner's pick beside
    the fastest size."""
    import functools
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.ops import correlator
    c, t, s = WAVES_CHANNELS, CHUNK_CHECK_EPOCHS, WAVES_MODEL_SLABS
    conf = trk.TrackingConf(fs=WAVES_MODEL_FS)
    eng = trk.TrackingEngine(conf, [1 + i % 32 for i in range(c)],
                             device=dev)
    codes, taps = eng.codes, eng.taps
    n_out = taps.shape[0]
    st = epoch_state(rng, conf, c, rng.choice([-1.0, 1.0], c), dev)
    x = _cnoise(rng, (1 << 20) + (t + 2) * conf.block_size, dev)
    path_s = trk._chunk_inputs(conf, codes, taps, None)[3].slabs
    k2 = correlator.plan_k2(c, conf.block_size, codes.shape[1],
                            codes.shape[1] // conf.code_length_chips,
                            sms=-(-s * c // 2))
    if k2.slabs != s:
        fail(f"chunk kernel cluster sizes: forced plan {k2}, not S={s}")
    fits = functools.partial(trk._card_max_clusters, c)
    pick = trk.plan_epoch_chunk(c, k2, n_out, fits)
    misses = torch.zeros(1, dtype=torch.int64, device=dev)
    launches = []
    for cl in range(1, min(trk.EPOCH_CHUNK_MAX_CLUSTER, s) + 1):
        smem = trk.epoch_chunk_smem(k2, n_out, cl)
        if smem + trk.EPOCH_CHUNK_STATIC_SMEM > trk.SMEM_PER_CTA:
            continue
        resident = fits(cl, smem)
        if resident == 0:
            continue
        plan = trk.EpochChunkPlan(k2, cl, -(-s // cl), smem,
                                  -(-c // resident))
        launches.append((trk.chunk_launch(conf, t, codes, taps, x, st, None,
                                          misses, plan), resident))
        trk.launch_chunk(launches[-1][0])
    torch.cuda.synchronize()
    # compared before any is timed: a launch writes the lengths after the
    # chunk into its n_c, so its replays start from other lengths
    ref = launches[0][0]
    for launch, _ in launches[1:]:
        diff = differing(launch.state, ref.state, launch.planes, ref.planes)
        if diff:
            fail(f"chunk kernel at C={c}, S={s}: S'={launch.plan.cluster} "
                 f"differs from S'={ref.plan.cluster} in {diff}")
    timed = []
    for launch, resident in launches:
        ms = time_ms(lambda: trk.launch_chunk(launch), reps=2)
        plan = launch.plan
        timed.append((ms, plan))
        print(f"  chunk kernel at 20 Msps, C={c}, S={s} (the path's plan: "
              f"S={path_s}): S'={plan.cluster}: {resident} clusters "
              f"resident, {plan.waves} waves x {plan.rounds} rounds = "
              f"{plan.waves * plan.rounds}, {ms:.4f} ms per chunk of {t} "
              "epochs")
    best_ms, best = min(timed, key=lambda m: m[0])
    pick_ms = next(m for m, p in timed if p.cluster == pick.cluster)
    print(f"  chunk kernel at 20 Msps, C={c}, S={s}: {len(timed)} sizes bit "
          f"for bit equal; the planner picks S'={pick.cluster} "
          f"({pick.waves} waves x {pick.rounds} rounds), {pick_ms:.4f} ms; "
          f"the fastest is S'={best.cluster}, {best_ms:.4f} ms "
          f"({pick_ms / best_ms:.3f} x); {int(misses)} staged-table misses")


def acq_dwells(dev, m: int = 2):
    """`m` ms of the static scenario (6 satellites) as [m, 2000] dwells, for
    the K3 and K4b checks."""
    import torch
    x = synthesize(FS, m * 1e-3)
    return torch.from_numpy(x.astype(np.complex64)).to(dev).reshape(m, 2000)


def check_k3(dev):
    """K3 (both kernels) at the main-path shape: M=2 dwells, D=41 Doppler bins,
    N=2000 samples, C=8 channels (PRNs 1-8)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    acq = AcqConf(fs_in=FS, max_dwells=2)
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(acq, range(1, 9))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    m, n, d, c = 2, 2000, dops.shape[0], cfc.shape[0]
    out = []

    out.append(wipe_case(x, dops, t, f"GPS L1 C/A at {FS / 1e6:g} Msps",
                         k3_search(cfc, m)))
    want = pcps._wipe_plain(x, dops, t)
    spec = torch.fft.fft(want, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    out.append(k3_peak_row(corr, m, None, 20))

    # the whole search: port (wipeoff, cuFFT, peak) beside torch.fft + torch ops
    port = time_ms(lambda: pcps.pcps_search(x, cfc, dops, t))
    torch_ops = time_ms(lambda: pcps.max_to_input_power_stat(
        pcps.pcps_grid(x, cfc, dops, FS), 2.0))
    got = pcps.pcps_search(x, cfc, dops, t)
    want = pcps.max_to_input_power_stat(pcps.pcps_grid(x, cfc, dops, FS), 2.0)
    compare("K3 pcps_search", got, want, 1e-4)
    print(f"  K3 search (M={m}, D={d}, N={n}, C={c}): port {port:.4f} ms, "
          f"torch.fft + torch ops yardstick {torch_ops:.4f} ms")
    # K3c's plain form on the same correlations (the main path's coarse
    # search under use_CFAR_algorithm=false), and the whole search so
    spc = 2
    out.append(check_k3c("K3c_pcps_second_peak", corr, m, spc, "plain", 0,
                         f"M={m} dwells, C={c} channels, D={d} Doppler "
                         f"bins, N={n} samples"))
    got = pcps.pcps_search(x, cfc, dops, t, use_cfar=False,
                           samples_per_chip=spc)
    want = pcps.first_vs_second_peak_stat(pcps.pcps_grid(x, cfc, dops, FS),
                                          spc)
    compare("K3c pcps_search (first vs second) statistic", got[0], want[0],
            1e-4)
    compare("K3c pcps_search (first vs second) cells", got[1:], want[1:],
            0.0)
    return out


def k3_peak_row(corr, m: int, label, plain_reps: int):
    """K3's peak (the row kernel, then the stat kernel) on the [M, C, D, N]
    correlations `corr` against its plain version: the statistic within
    1e-4 of its scale, the Doppler and delay cells exact; timed beside the
    plain version (`plain_reps` calls a replay)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    _, c, d, n = corr.shape
    where = "" if label is None else f" ({label})"
    got = pcps.pcps_peak(corr, m)
    want = pcps._peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare(f"K3 pcps_peak{where} statistic", got[0], want[0], 1e-4)
    compare(f"K3 pcps_peak{where} cells", got[1:], want[1:], 0.0)
    shape = (f"M={m} dwells, C={c} channels, D={d} Doppler bins, N={n} "
             "samples")
    tile, warps = pcps.row_plan(n, "plain")
    return _row(
        "K3_pcps_peak", "triton", "gnss_sim_receiver_tpu_torch/ops/pcps.py",
        "gnss_sim_receiver_tpu/ops/pcps.py:107", err,
        time_ms(lambda: pcps.pcps_peak(corr, m)),
        time_ms(lambda: pcps._peak_plain(corr, m), reps=plain_reps),
        m * c * d * n * 8 + c * 12,
        m * c * d * n * 3 + c * d * n * 2,      # |.|^2 3, sum + compare 2
        (shape if label is None else f"{label}: {shape}")
        + f", tile {tile} lanes in {warps} warps")


def narrow_table(eng, step=None):
    """A [C, D2] narrow Doppler table of `eng`'s two-step search: every
    channel's 2 n2 + 1 bins, doppler_step2 apart (or `step`: the assisted
    search's 62.5 Hz), around a bin of the coarse grid (channel c at bin
    4 c, modulo the grid)."""
    import torch
    acq, dops = eng.conf, eng.dopplers
    c, d2 = eng.code_fft_conj.shape[0], 2 * acq.num_doppler_bins_step2 + 1
    centers = dops[(torch.arange(c, device=dops.device) * 4) % dops.shape[0]]
    offs = (torch.arange(d2, device=dops.device) - d2 // 2) \
        * float(acq.doppler_step2 if step is None else step)
    return (centers[:, None] + offs[None, :]).to(torch.float32).contiguous()


def check_k3_search_shapes(dev, extra: list) -> None:
    """The wipeoff (its engine's grid and a [C, 9] narrow table, by
    wipe_case) and K3's peak at three more searches of the phases, each on
    the correlations its engine makes of its own scenario (wipeoff, cuFFT,
    the code replicas), C=10; the rows go to `extra`:
    - phase 5's GPS L1 C/A search at 20 Msps (phase 8 runs the same):
      M=2 dwells of the hybrid scenario made by K6, PRNs 1-10, N=20000
      (one code period, no doubled FFT);
    - phase 8's E1 two-step search (pilot_receiver_conf's E1 chain): M=2
      dwells of phase 8's scenario made by K6, PRNs 11-20, N=80000;
    - phase 4e's GPS L1 C/A search with bit_transition_flag: M=2 dwells of
      the static scenario at 2 Msps, PRNs 1-10, N=4000 (the doubled
      FFT);
    - phase 10's GPS L1 C/A search at 3 Msps: M=2 dwells of its scenario
      made by K6, PRNs 1-10, N=3000."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration

    def dwells(sats, eng, m):
        return generate_baseband_device_resident(
            sats, FS_REF_HYBRID, m * eng.fft_size, noise=True, seed=17,
            device=dev).reshape(m, eng.fft_size)

    def search(eng, x, label):
        m, cfc = x.shape[0], eng.code_fft_conj
        extra.append(wipe_case(x, eng.dopplers, eng._t, label,
                               k3_search(cfc, m), 3))
        extra.append(wipe_case(x, narrow_table(eng), eng._t, label,
                               k3_search(cfc, m), 3))
        spec = torch.fft.fft(pcps.pcps_wipe(x, eng.dopplers, eng._t), dim=-1)
        corr = torch.fft.ifft(
            spec[:, None] * eng.code_fft_conj[None, :, None], dim=-1)
        del spec
        extra.append(k3_peak_row(corr, x.shape[0], label, 3))
        del corr
        torch.cuda.empty_cache()

    acq = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        HYBRID_CONF.format(capture="", fs=int(FS_REF_HYBRID))))).acq
    eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
    search(eng, dwells(hybrid_sats(), eng, acq.max_dwells),
           f"GPS L1 C/A at {FS_REF_HYBRID / 1e6:g} Msps")
    e1 = pilot_receiver_conf().chains[0]
    eng = PcpsAcquisitionEngine(e1.acq, tuple(range(11, 21)),
                                code_provider=e1.code_provider,
                                sc_rate=e1.sc_rate, device=dev)
    search(eng, dwells(pilot_sats(), eng, e1.acq.max_dwells),
           f"phase 8's E1 two-step search at {FS_REF_HYBRID / 1e6:g} Msps")
    props = conf_properties(CONF.format(capture=""))
    props.update(BIT_PROPS)
    acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
    eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
    m, n = acq.max_dwells, eng.fft_size
    x = torch.from_numpy(synthesize(FS, 0.01, m * n).astype(np.complex64))
    search(eng, x.to(dev).reshape(m, n),
           f"GPS L1 C/A at {FS / 1e6:g} Msps, bit_transition_flag")
    acq = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        PS_CONF.format(capture="")))).acq
    eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
    m, n = acq.max_dwells, eng.fft_size
    search(eng, generate_baseband_device_resident(
        ps_sats(), FS_PS, m * n, noise=True, seed=29, device=dev).reshape(
            m, n), f"phase 10's GPS L1 C/A search at {FS_PS / 1e6:g} Msps")


def check_wipe_path_shapes(dev, extra: list) -> None:
    """The wipeoff at the paths' shapes that the searches above do not
    launch it at, each held by wipe_case; the rows go to `extra`:
    - Tong's 10 single-dwell searches (phases 4d and 4e): 10 ms of the
      static scenario at 2 Msps as [10, N], N = 2000 and, with
      bit_transition_flag, 4000; PRNs 1-10;
    - the ROC harness's trials as dwells (phase 4f): 384 trials of one and
      of two dwells, M = 384 and 768, N = 2000, PRN 1 at 45 dB-Hz in
      unit noise (models/acq_performance.py:trial_signal), the trials
      searched as channels;
    - the time-sharded search's segment with its halo (phase 9): one dwell
      of L + N = 256000 samples of noise, D = 41 (no search: the path
      folds the correlations, K7)."""
    import torch
    from gnss_sim_receiver_tpu_torch import constants
    from gnss_sim_receiver_tpu_torch.models import acq_performance as perf
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    for keys, label in (({}, "Tong"), (BIT_PROPS,
                                        "Tong, bit_transition_flag")):
        props = conf_properties(CONF.format(capture=""))
        props["Acquisition_1C.implementation"] = \
            "GPS_L1_CA_PCPS_Tong_Acquisition"
        props.update(keys)
        acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
        eng = PcpsAcquisitionEngine(acq, tuple(range(1, 11)), device=dev)
        m, n = acq.tong_max_dwells, eng.fft_size
        x = torch.from_numpy(synthesize(FS, m * n / FS).astype(
            np.complex64)).to(dev).reshape(m, n)
        extra.append(wipe_case(x, eng.dopplers, eng._t,
                               f"GPS L1 C/A at {FS / 1e6:g} Msps, {label}",
                               k3_search(eng.code_fft_conj, m), 3))
        torch.cuda.empty_cache()
    n, trials = 2000, 384
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(1), FS,
                                 constants.GPS_L1_CA_CODE_RATE_CPS, n)
    cfc = torch.from_numpy(
        np.conj(np.fft.fft(code))[None].astype(np.complex64)).to(dev)
    code_t = torch.from_numpy(code.astype(np.float32)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    amp = float(np.sqrt(2.0 * 10.0 ** 4.5 / FS))
    for m in (1, 2):
        x = perf.trial_signal(gen, code_t, amp, 1375.0, 700, n, trials, FS,
                              m).reshape(m * trials, n)

        def trials_search(w, m=m):
            corr = torch.fft.ifft(torch.fft.fft(w, dim=-1) * cfc[0],
                                  dim=-1).reshape(m, trials, -1, n)
            return pcps.pcps_peak(corr, m)
        extra.append(wipe_case(x, dops, pcps.time_axis(n, FS, dev),
                               f"the ROC harness, {trials} trials of {m} "
                               f"dwell{'s' if m > 1 else ''}",
                               trials_search, 3))
        del x
        torch.cuda.empty_cache()
    n = OS_PERIODS * 2000 + 2000
    x = _cnoise(np.random.default_rng(15), n, dev).reshape(1, n)
    extra.append(wipe_case(x, dops, pcps.time_axis(n, FS, dev),
                           "the time-sharded search's segment and halo",
                           None, 3))
    torch.cuda.empty_cache()


def check_k3c(name: str, corr, m: int, spc: int, form: str, caf_bins: int,
              shape: str):
    """K3c (pcps_second_peak) in the grid form `form` on the correlations
    its search gives it, against its plain version (the grid materialised,
    then first_vs_second_peak_stat): the statistic to 1e-4 of its scale,
    the cells exact.  The plain form (one CUDA launch, csrc/pcps_rows.cu)
    also bit for bit the three Triton launches it replaced
    (_second_peak_reference), one device operation a call, timed beside
    them in turns and beside an empty kernel on its grid.  Every form is
    timed whole and against its Triton row kernel alone, whose difference
    is what K3c adds to a row pass; bound: the correlations read once
    (that of the added part: the peak row's planes read again)."""
    from gnss_sim_receiver_tpu_torch.ops import pcps
    label = f"{form} form, spc={spc}" + (f", b={caf_bins}" if form == "caf"
                                         else "")
    err = k3c_case(corr, m, spc, form, caf_bins, label)
    plain_form = form == "plain"

    def call():
        return pcps.pcps_second_peak(corr, m, spc, form, caf_bins)

    def ref():
        return pcps._second_peak_reference(corr, m, spc)
    if plain_form:
        ref_ms = [time_ms(ref)]
    ms = time_ms(call)
    if plain_form:
        ref_ms.append(time_ms(ref))
    row_ms = time_ms(lambda: pcps._row_pass(corr, m, form, caf_bins, "K3c"))
    plain = time_ms(lambda: pcps._second_peak_plain(corr, spc, form,
                                                    caf_bins), reps=3)
    c, d, n = corr.shape[1], corr.shape[2], corr.shape[-1]
    planes = 1 if form == "plain" else 2
    k = 2 * caf_bins + 1 if form == "caf" else 1
    row_bytes = m * c * n * 8 * planes * k
    added_bound, _ = bound_ms(row_bytes, 0)
    print(f"  K3c ({label}): {ms:.4f} ms, {ms - row_ms:.4f} ms over the "
          f"Triton row kernel's {row_ms:.4f} ms; the added part's bound "
          f"{added_bound:.4f} ms (the peak row's planes read again, "
          f"{row_bytes / 1e6:.3f} MB)")
    # per (dwell, cell): |.|^2 3 (plain), the sign hypotheses 12 (dual),
    # two |.|^2 and their sum 8 per boxcar row (CAF); per cell compare,
    # sum 2; the plain form's zone 4 and max 1 per cell of every row, the
    # others' per cell of the peak row, formed again
    per = {"plain": 3, "dual": 12, "caf": 8 * k}[form]
    n_ops = m * c * d * n * per + c * d * n * (2 + (k if k > 1 else 0))
    n_ops += (c * d * n * 5 if plain_form
              else m * c * n * per + c * n * 5)
    row = _row(name, "cuda" if plain_form else "triton",
               "gnss_sim_receiver_tpu_torch/"
               + ("csrc/pcps_rows.cu" if plain_form else "ops/pcps.py"),
               "gnss_sim_receiver_tpu/ops/pcps.py:123", err, ms, plain,
               corr.numel() * 8 + c * 12, n_ops, f"{label}: {shape}")
    row["added_ms"] = ms - row_ms
    row["added_bound_ms"] = added_bound
    if plain_form:
        one_device_op(f"K3c ({label})", call)
        floor_ms = time_ms(lambda: pcps._second_peak_empty(c, d,
                                                           corr.device))
        print(f"  K3c ({label}): the replaced form {ref_ms[0]:.4f} / "
              f"{ref_ms[1]:.4f} ms, an empty kernel on its grid "
              f"{floor_ms:.4f} ms ({ms / floor_ms:.2f} x)")
        row.update(reference_ms=float(np.mean(ref_ms)),
                   launch_floor_ms=floor_ms)
    return row


def k3c_case(corr, m: int, spc: int, form: str, caf_bins: int,
             label: str) -> float:
    """K3c against its plain version (the statistic within 1e-4 of its
    scale, the Doppler and delay cells exact) and, in the plain form,
    against the replaced three Triton launches bit for bit (statistic and
    both indices).  Returns the statistic's error."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    got = pcps.pcps_second_peak(corr, m, spc, form, caf_bins)
    want = pcps._second_peak_plain(corr, spc, form, caf_bins)
    torch.cuda.synchronize()
    err = compare(f"K3c pcps_second_peak ({label}) statistic", got[0],
                  want[0], 1e-4)
    compare(f"K3c pcps_second_peak ({label}) cells", got[1:], want[1:], 0.0)
    if form == "plain":
        ref = pcps._second_peak_reference(corr, m, spc)
        torch.cuda.synchronize()
        if not (torch.equal(got[0].view(torch.int32),
                            ref[0].view(torch.int32))
                and torch.equal(got[1], ref[1])
                and torch.equal(got[2], ref[2])):
            fail(f"K3c ({label}): differs from the replaced kernels: "
                 f"{got} vs {ref}")
        print(f"  K3c ({label}): statistic and indices bit for bit the "
              "replaced kernels'")
    return err


def _plants(rng, m: int, c: int, d: int, n: int, dev):
    """[M, C, D, N] integer correlations (every |.|^2 and sum exact) with
    planted cells: channel 0 the max in rows 1 and 3 (a tie across rows,
    row 1 first); 1 the max twice in row 2, at delays 700 and 10; 2 the
    max at delay 0 with a near peak at N - 1 (inside the zone across the
    wrap); 3 the max at N - 1 with a near peak at 0 and the second at
    N - 4; 4 noise alone; 5 the max at 321, its zone across a 64-cell
    tile edge.  Returns (corr, {channel: (d*, k*)})."""
    import torch
    x = (rng.integers(-3, 4, (m, c, d, n))
         + 1j * rng.integers(-3, 4, (m, c, d, n))).astype(np.complex64)
    for ci, di, k, v in ((0, 1, 100, 9), (0, 3, 50, 9), (1, 2, 700, 9),
                         (1, 2, 10, 9), (2, 0, 0, 9), (2, 0, n - 1, 8),
                         (3, 4, n - 1, 9), (3, 4, 0, 8), (3, 4, n - 4, 6),
                         (5, 2, 321, 9), (5, 2, 319, 8), (5, 2, 324, 7)):
        x[:, ci, di, k] = v + 1j * v
    want = {0: (1, 100), 1: (2, 10), 2: (0, 0), 3: (4, n - 1), 5: (2, 321)}
    return torch.from_numpy(x).to(dev), want


def check_k3c_shapes(dev, extra: list) -> None:
    """K3c's plain form (csrc/pcps_rows.cu) at the other shapes the paths
    give it and at planted edge cases, each by k3c_case (bit for bit the
    replaced kernels, 1e-4 of the plain version, cells exact): noise
    correlations at N = 4000 (bit_transition_flag's doubled FFT), the ROC
    harness's M = 1, C = 384 (phase 4f), N = 20000 and 40000 (GPS at 20
    Msps, L5I; rows of several rounds, the tile maxima), N = 2001 (odd,
    8-byte loads) and N = 800001 (more tiles than shared memory holds:
    the planes read again); integer correlations with planted ties,
    peaks at delays 0 and N - 1 and a zone across a tile edge at N = 2000
    and 6000, at spc = 2, 0 and >= N / 2.  The four path shapes are timed
    beside the replaced form; their rows go to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    rng = np.random.default_rng(18)
    for m, c, d, n in ((2, 10, 41, 4000), (1, 384, 41, 2000),
                       (2, 10, 41, 20000), (2, 10, 41, 40000)):
        corr = _cnoise(rng, m * c * d * n, dev).reshape(m, c, d, n)
        extra.append(check_k3c("K3c_pcps_second_peak", corr, m, 2, "plain",
                               0, f"M={m} dwells, C={c} channels, D={d} "
                               f"Doppler bins, N={n} samples (noise)"))
        del corr
    for m, c, d, n in ((2, 3, 5, 2001), (1, 2, 3, 800001)):
        corr = _cnoise(rng, m * c * d * n, dev).reshape(m, c, d, n)
        k3c_case(corr, m, 2, "plain", 0, f"M={m}, C={c}, D={d}, N={n}")
    for n in (2000, 6000):
        corr, want = _plants(rng, 2, 6, 5, n, dev)
        for spc in (2, 0, n // 2):
            k3c_case(corr, 2, spc, "plain", 0,
                     f"planted, N={n}, spc={spc}")
            stat, di, de = pcps.pcps_second_peak(corr, 2, spc)
            got = {ci: (int(di[ci]), int(de[ci])) for ci in want}
            if got != want:
                fail(f"K3c planted, N={n}, spc={spc}: cells {got}, not "
                     f"{want}")
            if spc < n // 2 and float(stat[1]) != 1.0:
                fail(f"K3c planted, N={n}, spc={spc}: a tie within a row "
                     f"gave {float(stat[1])}, not 1")
    torch.cuda.empty_cache()


def check_k5a(dev, rng):
    """K5a against its plain version at N = 4 M (+3, an odd length):
    decimation 1, 2, 4 x taps 5, 31, 63 without mixing, and three of those
    with a nonzero IF (N < 2^24, where float32(n) holds every integer).
    Then against its plain version, and timed, at the main path's shape:
    the 26 s capture at 4 Msps (104 M samples), 31 taps, decimation 2, no
    mixing."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    x = _cnoise(rng, COND_SAMPLES + 3, dev)
    worst = 0.0
    cases = [(d, t, 0.0) for d in (1, 2, 4) for t in (5, 31, 63)]
    cases += [(2, 31, 1.0e6), (1, 5, -412.5e3), (4, 63, 1.0e6)]
    for dec, n_taps, fc in cases:
        taps = torch.from_numpy(filters.design_lowpass(n_taps, 0.45)).to(dev)
        w = filters.lo_step(fc, FS_FILE)
        xs = x if fc == 0.0 else x[:COND_SAMPLES]
        got = filters.fir_decim(xs, taps, dec, w)
        want = filters._fir_plain(
            xs if fc == 0.0 else filters._mix_plain(xs, w), taps, dec)
        ref = filters._fir_decim_reference(xs, taps, dec, w)
        torch.cuda.synchronize()
        what = f"K5a fir_decim dec={dec} T={n_taps} IF={fc:g}"
        # 1e-5 of the scale: the kernel sums the taps by fused multiply-adds
        worst = max(worst, compare(what, got, want, 1e-5))
        fir_bits(what, got, ref)
    del x, got, want, ref
    n, n_taps, dec = int(FS_FILE * DUR), 31, 2
    x = _cnoise(rng, n, dev)
    taps = torch.from_numpy(filters.design_lowpass(n_taps, 0.45)).to(dev)
    got = filters.fir_decim(x, taps, dec)
    want = filters._fir_plain(x, taps, dec)
    ref = filters._fir_decim_reference(x, taps, dec)
    torch.cuda.synchronize()
    what = f"K5a fir_decim N={n} dec={dec} T={n_taps} (the main path's shape)"
    worst = max(worst, compare(what, got, want, 1e-5))
    fir_bits(what, got, ref)
    del want, ref
    ms = time_ms(lambda: filters.fir_decim(x, taps, dec), reps=3)
    ref_ms = time_ms(lambda: filters._fir_decim_reference(x, taps, dec),
                     reps=3)
    print(f"  K5a fir_decim (the main path's shape): {ms:.4f} ms, the "
          f"kernel before its redesign {ref_ms:.4f} ms; "
          f"{sm_clock_during(lambda: filters.fir_decim(x, taps, dec))}")
    plain = time_ms(lambda: filters._fir_plain(x, taps, dec), reps=1)
    # the library yardstick: one conv1d over the two planes, given them
    # already split and padded (float32, TF32 off); the port never calls it
    pad = n_taps // 2
    planes = torch.nn.functional.pad(
        torch.view_as_real(x).T.contiguous(), (pad, n_taps - 1 - pad))[:, None]
    kern = taps.flip(0)[None, None].contiguous()
    lib = torch.nn.functional.conv1d(planes, kern, stride=dec)
    compare("K5a conv1d yardstick against the kernel",
            torch.view_as_complex(lib[:, 0].T.contiguous()), got, 1e-5)
    del lib, got
    library = time_ms(lambda: torch.nn.functional.conv1d(planes, kern,
                                                         stride=dec), reps=3)
    n_out = -(-n // dec)
    row = _row("K5a_fir_decim", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/fir_decim.cu",
               "gnss_sim_receiver_tpu/ops/filters.py:29", worst, ms, plain,
               8 * n + 4 * n_taps + 8 * n_out, 4 * n_taps * n_out,
               f"N={n} samples, T={n_taps} taps, decimation {dec}, no mixing",
               library)
    row["reference_ms"] = ref_ms
    return row


def fir_bits(what: str, got, ref) -> None:
    """K5a's output bit for bit that of the kernel before its redesign."""
    import torch
    if not torch.equal(bits(got), bits(ref)):
        fail(f"{what}: differs from the kernel before its redesign in "
             f"{int((bits(got) != bits(ref)).sum())} words")
    print(f"  {what}: bit for bit the kernel before its redesign")


def check_k5b(dev, rng):
    """K5b, the single-pass scan, at the length, notch frequency and width
    that phase 4b gives it (N = 1 M + 5: 513 tiles of one sub-tile, so the
    carries cross hundreds of tiles) and at a narrow notch (bw = 0.0005,
    whose state lasts thousands of samples) on 256 K + 3 samples, each
    against the sequential plain version run on the card over the whole
    stream, with a strong continuous wave on the notch; then, after the
    timing's CUDA graph replays (the tile status is reused), at phase 4b's
    length again.  At 4 M (tiles of one sub-tile) and 104 M samples (the
    capture's length; tiles of 4) against the three-launch kernel it
    replaced.  All within 1e-4 of the output's scale; the new and the
    replaced kernel timed at the three lengths.  Returns the row and the
    (input, plain output) pair, which phase 4b sends through the
    conditioner."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    n, f0, bw = NOTCH_SAMPLES, NOTCH_F0, NOTCH_BW

    def with_tone(x, f0):
        return x + 10.0 * torch.exp(2j * np.pi * f0 * torch.arange(
            x.shape[0], device=dev, dtype=torch.float64)).to(torch.complex64)
    # 1e-4 of the scale: the carries round apart from the sequential scan;
    # the pole radius 1 - pi*bw forgets them
    xn = with_tone(_cnoise(rng, NOTCH_NARROW_SAMPLES, dev), f0)
    got = filters.notch_filter(xn, f0, NOTCH_NARROW_BW)
    want = filters._notch_plain(
        xn, *filters.notch_coefficients(f0, NOTCH_NARROW_BW))
    torch.cuda.synchronize()
    err = compare(f"K5b notch_filter N={xn.shape[0]} f0={f0} "
                  f"bw={NOTCH_NARROW_BW} (the narrow notch)", got, want, 1e-4)
    del xn, got, want
    x = with_tone(_cnoise(rng, n, dev), f0)
    got = filters.notch_filter(x, f0, bw)
    ref = filters._notch_reference(x, f0, bw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = filters._notch_plain(x, *filters.notch_coefficients(f0, bw))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max(err, compare(f"K5b notch_filter N={n} f0={f0} bw={bw}", got,
                           want, 1e-4))
    compare(f"K5b the replaced kernel N={n}", ref, want, 1e-4)
    lengths = []
    for n_at in (n, COND_SAMPLES, int(FS_FILE * DUR)):
        xb = x if n_at == n else _cnoise(rng, n_at, dev)
        reps = 20 if n_at == n else 3
        if n_at != n:
            err = max(err, compare(
                f"K5b notch_filter N={n_at} against the replaced kernel",
                filters.notch_filter(xb, f0, bw),
                filters._notch_reference(xb, f0, bw), 1e-4))
        ref_ms = [time_ms(lambda: filters._notch_reference(xb, f0, bw), reps)]
        ms = time_ms(lambda: filters.notch_filter(xb, f0, bw), reps)
        ref_ms.append(time_ms(lambda: filters._notch_reference(xb, f0, bw),
                              reps))
        b_ms = bound_ms(16 * n_at, 16 * n_at)[0]
        print(f"  K5b notch_filter at N={n_at}: {ms:.4f} ms, the replaced "
              f"kernel {ref_ms[0]:.4f} / {ref_ms[1]:.4f} ms, bound "
              f"{b_ms:.4f} ms ({ms / b_ms:.2f} x)")
        lengths.append(dict(n=n_at, ms=ms, reference_ms=ref_ms, bound_ms=b_ms))
        if n_at == n:
            row_ms, row_ref_ms = ms, float(np.mean(ref_ms))
        del xb
    again = filters.notch_filter(x, f0, bw)
    torch.cuda.synchronize()
    compare(f"K5b notch_filter N={n} after the graph replays", again, want,
            1e-4)
    row = _row("K5b_notch_filter", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/notch.cu",
               "gnss_sim_receiver_tpu/ops/filters.py:58", err, row_ms, plain,
               16 * n, 16 * n,
               f"N={n} samples, f0={f0}, bw={bw}; plain_ms is one eager run, "
               "host-timed")
    row.update(reference_ms=row_ref_ms, lengths=lengths)
    return row, (x, want)


def blank_case(x, label: str, th: float = 4.0, window: int = 64) -> None:
    """K5c on x against the plain version and the replaced form (every
    sample identical), and its threshold against _blank_threshold of its
    own window powers (the same bits)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    got, pw, thr = filters._blank_cuda(x, th, window)
    want = filters._blank_plain(x, th, window)
    ref = filters._blank_reference(x, th, window)
    thr_want = filters._blank_threshold(pw, th).reshape(1)
    torch.cuda.synchronize()
    n, n_win = x.shape[0], x.shape[0] // window
    d_plain, d_ref = int((got != want).sum()), int((got != ref).sum())
    same_thr = torch.equal(thr.view(torch.int32), thr_want.view(torch.int32))
    print(f"  K5c pulse_blanking {label}: N={n}, {n_win} windows of "
          f"{window}{' (odd)' if n_win % 2 else ''}, tail {n % window}: "
          f"{int((want == 0).sum())} samples blanked; {d_plain} differ from "
          "the plain version, "
          f"{d_ref} from the replaced form; threshold {float(thr):.6g}, "
          f"{'the' if same_thr else 'NOT the'} bits of _blank_threshold of "
          "its window powers")
    if d_plain or d_ref or not same_thr:
        fail(f"K5c pulse_blanking {label}: {d_plain} samples differ from the "
             f"plain version, {d_ref} from the replaced form, threshold "
             f"{'equal' if same_thr else 'differs'}")


def blank_stream(rng, dev, n: int, kind: str):
    """n samples for K5c: noise (unit power over the two planes) with 150-
    sample pulses of amplitude 40; "tie-heavy": a third of the windows all
    zero and a third constant at 1 + 1j (many equal powers), with the
    pulses; "zero-majority": three windows in five all zero (the median is
    0, so every window with power is blanked)."""
    import torch
    x = _cnoise(rng, n, dev) * float(np.sqrt(0.5))
    n_win = n // 64
    pick = rng.random(n_win)
    whole = x[: n_win * 64].view(-1, 64)
    if kind == "tie-heavy":
        whole[torch.from_numpy(pick < 1 / 3).to(dev)] = 0
        whole[torch.from_numpy((pick >= 1 / 3) & (pick < 2 / 3)).to(dev)] = (
            1 + 1j)
    elif kind == "zero-majority":
        whole[torch.from_numpy(pick < 0.6).to(dev)] = 0
        return x
    for start in rng.integers(0, n - 200, max(1, n // 80_000)):
        x[start:start + 150] += 40.0
    return x


def check_k5c(dev, rng):
    """K5c, three launches of csrc/pulse_blank.cu, against the plain version
    and the replaced form (the two Triton kernels and the torch sort) on
    every case: phase 4b's 4 M samples (an even window count) and with an
    odd count and a ragged tail, x not 16-byte aligned, a tie-heavy stream,
    a zero-majority one, windows of 1, 2, 128 and 1024, and the capture's
    104 M samples.  The outputs identical, the threshold the bits of
    _blank_threshold of the kernel's own window powers.  Its launches a
    call from its counter and torch.profiler (at most 3, no library call).
    Times at 4 M and 104 M beside the replaced form's and the bound (16 N
    bytes and the powers)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import filters
    n = COND_SAMPLES
    x = blank_stream(rng, dev, n, "pulses")
    blank_case(x, "pulses")
    blank_case(x[1:], "pulses, x not 16-byte aligned")
    xo = blank_stream(rng, dev, n - 64 + 17, "pulses")
    blank_case(xo, "pulses")
    del xo
    for kind in ("tie-heavy", "zero-majority"):
        blank_case(blank_stream(rng, dev, 64 * 20001 + 33, kind), kind)
        blank_case(blank_stream(rng, dev, 64 * 20000, kind), kind)
    for window in (1, 2, 128, 1024):
        xw = blank_stream(rng, dev, 100_003, "pulses")
        blank_case(xw, f"window {window}", 3.0, window)
    before = filters.pulse_blanking.launches
    ops = device_ops(lambda: filters.pulse_blanking(x, 4.0, 64))
    counted = filters.pulse_blanking.launches - before
    kernels = sum(c for c, _ in ops.values())
    print(f"  K5c pulse_blanking: {counted / 6:.0f} counted launch a call, "
          f"{kernels:.0f} device operations a call in torch.profiler: "
          + ", ".join(f"{c:.0f} x {name[:40]}" for name, (c, _) in
                      ops.items()))
    if counted != 6 or (ops and (kernels > 3 or any(
            "blank_" not in name for name in ops))):
        fail("K5c pulse_blanking: more than its three launches a call")
    lengths = []
    for n_at in (n, int(FS_FILE * DUR)):
        xb = x if n_at == n else blank_stream(rng, dev, n_at, "pulses")
        if n_at != n:
            blank_case(xb, "pulses (the capture's length)")
        reps = 20 if n_at == n else 5
        ref_ms = [time_ms(lambda: filters._blank_reference(xb, 4.0, 64),
                          reps)]
        ms = time_ms(lambda: filters.pulse_blanking(xb, 4.0, 64), reps)
        ref_ms.append(time_ms(lambda: filters._blank_reference(xb, 4.0, 64),
                              reps))
        b_ms = bound_ms(16 * n_at + 8 * (n_at // 64), 5 * n_at)[0]
        print(f"  K5c pulse_blanking at N={n_at}: {ms:.4f} ms, the replaced "
              f"form {ref_ms[0]:.4f} / {ref_ms[1]:.4f} ms, bound {b_ms:.4f} "
              f"ms ({ms / b_ms:.2f} x)")
        lengths.append(dict(n=n_at, ms=ms, reference_ms=ref_ms,
                            bound_ms=b_ms))
        if n_at == n:
            row_ms, row_ref_ms = ms, float(np.mean(ref_ms))
        del xb
    plain = time_ms(lambda: filters._blank_plain(x, 4.0, 64), reps=5)
    row = _row("K5c_pulse_blanking", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/pulse_blank.cu",
               "gnss_sim_receiver_tpu/ops/filters.py:82", 0.0, row_ms, plain,
               16 * n + 8 * (n // 64), 5 * n,
               f"N={n} samples, {n // 64} windows of 64")
    row.update(reference_ms=row_ref_ms, lengths=lengths)
    return row


def check_k5d(dev, rng):
    """K5d, both modes at ratios 2.0 and 4/3 from 4 M samples.  Direct
    must be identical (the same float32 index picks the same sample);
    linear to 1e-6 of the scale (multiply-add contraction).  One row per
    mode: each has its wrapper, its counter and its compiled kernel."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import resampler
    n = COND_SAMPLES
    x = _cnoise(rng, n, dev)
    worst = 0.0
    for ratio in (2.0, 4.0 / 3.0):
        n_out = resampler.output_length(n, ratio, 1.0)
        got = resampler.direct_resampler(x, ratio, n_out)
        want = resampler._direct_plain(x, float(np.float32(ratio)), n_out)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K5d direct_resampler ratio {ratio}: outputs differ")
        print(f"  K5d direct_resampler ratio {ratio:.4f}: identical")
        got = resampler.linear_resampler(x, ratio, n_out)
        want = resampler._linear_plain(x, float(np.float32(ratio)), n_out)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"K5d linear_resampler ratio {ratio:.4f}", got, want, 1e-6))
    # both modes timed as phase 4b launches them: direct 4 M -> 2 M (ratio
    # 2), linear 4 M -> 3 M (ratio 4/3)
    src = "gnss_sim_receiver_tpu_torch/ops/resampler.py"
    n_d = resampler.output_length(n, 2.0, 1.0)
    n_l = resampler.output_length(n, 4.0 / 3.0, 1.0)
    r32 = float(np.float32(4.0 / 3.0))
    return [
        _row("K5d_direct_resampler", "triton", src,
             "gnss_sim_receiver_tpu/ops/resampler.py:25", 0.0,
             time_ms(lambda: resampler.direct_resampler(x, 2.0, n_d)),
             time_ms(lambda: resampler._direct_plain(x, 2.0, n_d), reps=5),
             8 * n_d + 8 * n_d, 3 * n_d,
             f"{n} -> {n_d} samples, ratio 2 (reads every second sample)"),
        _row("K5d_linear_resampler", "triton", src,
             "gnss_sim_receiver_tpu/ops/resampler.py:35", worst,
             time_ms(lambda: resampler.linear_resampler(x, 4.0 / 3.0, n_l)),
             time_ms(lambda: resampler._linear_plain(x, r32, n_l), reps=5),
             8 * n + 8 * n_l, 10 * n_l,
             f"{n} -> {n_l} samples, ratio 4/3")]


def check_k3b(dev):
    """K3b at the main-path shape: M=2 dwells, C=8 channels, D2=2*4+1=9
    Doppler rows per channel, N=2000; then the whole two-step search
    against its plain composition."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    acq = AcqConf(fs_in=FS, max_dwells=2)
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(acq, range(1, 9))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    m, n, c, d2 = 2, 2000, 8, 9
    centers = dops[torch.arange(c, device=dev) * 5]
    dops2 = (centers[:, None] + (torch.arange(d2, device=dev) - 4)[None, :]
             * 125.0).to(torch.float32).contiguous()
    row = wipe_case(x, dops2, t, f"GPS L1 C/A at {FS / 1e6:g} Msps",
                    k3_search(cfc, m))

    def plain_search():
        stat, di, de = pcps.max_to_input_power_stat(
            pcps.pcps_grid(x, cfc, dops, FS), 2.0)
        hz = dops[di.long()]
        d2s = hz[:, None] + ((torch.arange(d2, device=dev) - 4)
                             * 125.0).to(torch.float32)[None, :]
        stat2, di2, _ = pcps.max_to_input_power_stat(
            pcps.pcps_grid_per_channel(x, cfc, d2s, FS), 2.0)
        return torch.stack([stat, torch.gather(d2s, 1, di2.long()[:, None]
                                               )[:, 0],
                            de.to(torch.float32), stat2])
    got = pcps.pcps_search_two_steps(x, cfc, dops, t, True, 4, 125.0)
    want = plain_search()
    compare("K3b two-step search [4, C]", got, want, 1e-4)
    port = time_ms(lambda: pcps.pcps_search_two_steps(x, cfc, dops, t, True,
                                                      4, 125.0))
    print(f"  K3b two-step search (M={m}, C={c}, D=41 then D2={d2}, N={n}): "
          f"port {port:.4f} ms, torch.fft + torch ops yardstick "
          f"{time_ms(plain_search):.4f} ms")
    return row


def hybrid_chain(fs: float, impl: str = "CCCWSR", keys: dict | None = None):
    """The Galileo E1-B chain that the factory builds from phase 5's conf
    text at rate `fs` with Galileo_E1_PCPS_<impl>_Ambiguous_Acquisition
    and the conf `keys`: the path's acquisition and tracking confs."""
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    props = conf_properties(HYBRID_CONF.format(capture="", fs=int(fs)))
    props["Acquisition_1B.implementation"] = \
        f"Galileo_E1_PCPS_{impl}_Ambiguous_Acquisition"
    props.update(keys or {})
    (chain,) = receiver_conf_from_config(InMemoryConfiguration(props)).chains
    return chain


def check_k4a(dev, fs: float, variant: str, extra: list,
              k3c: list):
    """K4a on the planes its path gives it: the hybrid scenario's first
    dwells at rate `fs`, the E1 chain's acquisition conf (M=2 dwells, D=81
    Doppler bins, N = 4 ms of samples), C=10 channels (PRNs 11-20, of which
    11-15 are present).  The kernel against its plain version on the same
    planes (statistic to 1e-4 of its scale, cells exact), and the whole
    search against the JAX-form grid (pcps_cccwsr_grid / pcps_8ms_grid) and
    statistic.  Returns the row of phase 5's shape (CCCWSR at 20 Msps); the
    other results go to `extra`.  At that shape K3c's dual form is held on
    the same planes too, its row appended to `k3c`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    chain = hybrid_chain(fs, {"cccwsr": "CCCWSR", "8ms": "8ms"}[variant])
    acq = chain.acq
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        acq, prns, code_provider=chain.code_provider, sc_rate=chain.sc_rate,
        code_provider2=chain.data_code_provider)
    m, need, n = acq.max_dwells, eng.n_samples_needed, eng.fft_size
    x = torch.from_numpy(synthesize_hybrid(fs, need)).to(dev).reshape(m, -1)
    cfc = eng.code_fft_conj
    cfc2 = eng.code2_fft_conj if eng.code2_fft_conj is not None else cfc
    label = f"{variant} at {fs / 1e6:g} Msps"
    if fs == FS_REF_HYBRID:
        extra.append(wipe_case(
            x, eng.dopplers, eng._t, f"Galileo E1 {label}",
            lambda w: pcps.pcps_dual_peak(pcps.dual_from_wiped(
                w, cfc, cfc2, variant), m), 3))
    corr = pcps.dual_correlations(x, cfc, cfc2, eng.dopplers, eng._t,
                                  variant)
    got = pcps.pcps_dual_peak(corr, m)
    want = pcps._dual_peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare(f"K4a pcps_dual_peak ({label}) statistic", got[0], want[0],
                  1e-4)
    compare(f"K4a pcps_dual_peak ({label}) cells", got[1:], want[1:], 0.0)
    # the whole search against the JAX functions' form, line for line
    buf = pcps.pcps_search_dual(x, cfc, cfc2, eng.dopplers, eng._t, variant)
    if variant == "cccwsr":
        grid = pcps.pcps_cccwsr_grid(x, cfc2, cfc, eng.dopplers, fs)
    else:
        grid = pcps.pcps_8ms_grid(x, cfc, eng.dopplers, fs)
    stat, di, de = pcps.max_to_input_power_stat(grid, float(2 * m))
    del grid
    compare(f"K4a search ({label}) statistic", buf[0], stat, 1e-4)
    compare(f"K4a search ({label}) Doppler and delay",
            buf[1:3].to(torch.int64),
            torch.stack([eng.dopplers[di.long()], de.float()]).to(
                torch.int64), 0.0)
    found = [p for p, v in zip(prns, buf[0].tolist()) if v > eng.threshold]
    print(f"  K4a search ({label}): detected PRNs {found} (threshold "
          f"{eng.threshold:.2f})")
    if found != [11, 12, 13, 14, 15]:
        fail(f"K4a search ({label}) detected {found}")
    ms = time_ms(lambda: pcps.pcps_dual_peak(corr, m))
    plain = time_ms(lambda: pcps._dual_peak_plain(corr, m), reps=3)
    c, d = len(prns), len(eng.dopplers)
    # per (dwell, cell): sums and differences 4, two |.|^2 6, max 1,
    # accumulate 1; per cell: compare and sum 2
    row = _row("K4a_pcps_dual_peak", "triton",
               "gnss_sim_receiver_tpu_torch/ops/pcps.py",
               "gnss_sim_receiver_tpu/ops/pcps.py:"
               + ("242" if variant == "cccwsr" else "213"), err, ms, plain,
               corr.numel() * 8 + c * 12, m * c * d * n * 12 + c * d * n * 2,
               f"{label}: M={m} dwells, C={c} channels, D={d} Doppler bins, "
               f"N={n} samples, two [M, C, D, N] complex64 planes "
               f"({corr.numel() * 8 / 1e6:.1f} MB)")
    if variant == "cccwsr" and fs == FS_REF_HYBRID:
        k3c.append(check_k3c(
            "K3c_pcps_second_peak_dual", corr, m, eng.samples_per_chip,
            "dual", 0, f"{label}: M={m} dwells, C={c} channels, D={d} "
            f"Doppler bins, N={n} samples"))
    del corr
    torch.cuda.empty_cache()
    if variant == "cccwsr" and fs == FS_REF_HYBRID:
        return row
    extra.append(row)
    return None


def check_k4c(dev, extra: list, k3c: list):
    """K4c on the planes its path gives it: phase 7's first dwells (the
    device generator's, seed 17), the E5a chain's acquisition conf (M=2
    dwells, D=41 Doppler bins of 250 Hz, N = 2 ms = 40000 samples: the
    doubled FFT of bit_transition_flag), C=10 channels (PRNs 11-20, of
    which 11-15 are present), with the CAF boxcar of phase 7's conf (b=1)
    and without it (b=0).  The kernel against its plain version on the
    same planes (statistic to 1e-4 of its scale, cells exact), the whole
    search against the JAX-form grid (pcps_e5a_noncoherent_iq_grid) and
    statistic, and the detection decision: the same PRNs above the
    threshold as the plain version, at least 3 of them, none absent.
    Returns the row of phase 7's shape (b=1); the b=0 row goes to
    `extra`.  At b=1 K3c's CAF form is held on the same planes too, its
    row appended to `k3c`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    _, e5a = wideband_chains()
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        e5a.acq, prns, code_provider=e5a.code_provider, sc_rate=e5a.sc_rate,
        code_provider2=e5a.data_code_provider)
    m, need, n = e5a.acq.max_dwells, eng.n_samples_needed, eng.fft_size
    x = wideband_dwells(dev, need).reshape(m, n)
    cfi, cfq = eng.code_fft_conj, eng.code2_fft_conj
    if n != 2 * eng.n_coherent:
        fail("K4c: phase 7's E5a search does not double its FFT")
    corr = pcps.dual_correlations(x, cfi, cfq, eng.dopplers, eng._t,
                                  "iq_caf")
    c, d = len(prns), len(eng.dopplers)
    row = None
    for b in (0, e5a.acq.caf_bins):
        label = f"E5a I/Q, b={b}, at {FS_WIDEBAND / 1e6:g} Msps"
        got = pcps.pcps_caf_peak(corr, m, b)
        want = pcps._caf_peak_plain(corr, m, b)
        torch.cuda.synchronize()
        err = compare(f"K4c pcps_caf_peak ({label}) statistic", got[0],
                      want[0], 1e-4)
        compare(f"K4c pcps_caf_peak ({label}) cells", got[1:], want[1:], 0.0)
        buf = pcps.pcps_search_iq_caf(x, cfi, cfq, eng.dopplers, eng._t, b)
        stat, di, de = pcps.max_to_input_power_stat(
            pcps.pcps_e5a_noncoherent_iq_grid(x, cfi, cfq, eng.dopplers,
                                              FS_WIDEBAND, b), float(2 * m))
        compare(f"K4c search ({label}) statistic", buf[0], stat, 1e-4)
        compare(f"K4c search ({label}) Doppler and delay",
                buf[1:3].to(torch.int64),
                torch.stack([eng.dopplers[di.long()], de.float()]).to(
                    torch.int64), 0.0)
        found = [p for p, v in zip(prns, buf[0].tolist())
                 if v > eng.threshold]
        plain = [p for p, v in zip(prns, stat.tolist()) if v > eng.threshold]
        print(f"  K4c search ({label}): detected PRNs {found}, the plain "
              f"version {plain} (threshold {eng.threshold:.2f})")
        if found != plain or not set(found) <= set(HYB_GAL_PRNS) \
                or len(found) < 3:
            fail(f"K4c search ({label}) detected {found}, plain {plain}")
        ms = time_ms(lambda: pcps.pcps_caf_peak(corr, m, b))
        plain = time_ms(lambda: pcps._caf_peak_plain(corr, m, b), reps=3)
        # per (dwell, cell): two |.|^2 6, accumulate 2; per cell: the
        # boxcar's 2b + 1 multiply-adds, compare and sum 2
        r = _row("K4c_pcps_caf_peak", "triton",
                 "gnss_sim_receiver_tpu_torch/ops/pcps.py",
                 "gnss_sim_receiver_tpu/ops/pcps.py:269", err, ms, plain,
                 corr.numel() * 8 + c * 12,
                 m * c * d * n * 8 + c * d * n * (2 * (2 * b + 1) + 2),
                 f"{label}: M={m} dwells, C={c} channels, D={d} Doppler "
                 f"bins, N={n} samples, the I and Q [M, C, D, N] complex64 "
                 f"planes ({corr.numel() * 8 / 1e6:.1f} MB)")
        if b == e5a.acq.caf_bins:
            row = r
            k3c.append(check_k3c(
                "K3c_pcps_second_peak_caf", corr, m, eng.samples_per_chip,
                "caf", b, f"E5a I/Q at {FS_WIDEBAND / 1e6:g} Msps: M={m} "
                f"dwells, C={c} channels, D={d} Doppler bins, N={n} "
                "samples"))
        else:
            extra.append(r)
    del corr
    torch.cuda.empty_cache()
    return row


def check_wideband_shapes(dev, rng, extra: list) -> None:
    """K1 and K2 with the 10230-chip E5a-I tables of phase 7's E5a chain,
    and K3 (both kernels) and K3b at its L5 chain's acquisition shape
    (M=2, C=10 PRNs 1-10, D=41, N=20000; D2=9), each against its plain
    version, timed; the rows go to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    l5, e5a = wideband_chains()
    taps = (0.25, 0.0, -0.25)
    label = f"Galileo E5a-I at {FS_WIDEBAND / 1e6:g} Msps"
    extra += [check_k1(dev, rng, e5a.trk, 10, 20, taps, 250,
                       "K1_block_correlate", label),
              check_k2(dev, rng, e5a.trk, 10, taps, e5a.code_provider,
                       "K2_multicorrelate", label)]
    torch.cuda.empty_cache()
    eng = PcpsAcquisitionEngine(l5.acq, tuple(range(1, 11)),
                                code_provider=l5.code_provider,
                                sc_rate=l5.sc_rate)
    m, n = l5.acq.max_dwells, eng.fft_size
    x = wideband_dwells(dev, eng.n_samples_needed).reshape(m, n)
    dops, t, cfc = eng.dopplers, eng._t, eng.code_fft_conj
    c, d = cfc.shape[0], dops.shape[0]
    label = f"GPS L5I at {FS_WIDEBAND / 1e6:g} Msps"
    extra.append(wipe_case(x, dops, t, label, k3_search(cfc, m), 3))
    want = pcps._wipe_plain(x, dops, t)
    spec = torch.fft.fft(want, dim=-1)
    del want
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    del spec
    extra.append(k3_peak_row(corr, m, label, 3))
    del corr
    d2 = 2 * l5.acq.num_doppler_bins_step2 + 1
    dops2 = (dops[torch.arange(c, device=dev) * 4][:, None]
             + (torch.arange(d2, device=dev) - d2 // 2)[None, :]
             * float(l5.acq.doppler_step2)).to(torch.float32).contiguous()
    extra.append(wipe_case(x, dops2, t, label, k3_search(cfc, m), 3))
    torch.cuda.empty_cache()


def check_k4b(dev, extra: list):
    """K4b (both kernels) at the GPS 2 Msps shape that phase 4d launches:
    M=8 dwells of the static scenario (QUICKSYNC_CONF's max_dwells), D=41
    Doppler bins, N=2000, fold 4, C=8 channels (PRNs 1-8).  The fold kernel
    against its plain version (1e-5 of the scale); the K3 peak kernel that
    follows it, on the [M, C, D, N/fold] planes, against its plain version
    (1e-4; its row at this shape goes to `extra`); the resolve kernel
    against its plain version at the folded search's own peaks (delays
    identical, magnitudes to 1e-4); then the whole search against the
    JAX-form grid, statistic and resolve at M=8.  The fold is also held to
    the Triton kernel it replaced bit for bit, there and at M=10, fold 8
    (its row goes to `extra`)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                sampled_codes)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    fold = 4
    props = conf_properties(QUICKSYNC_CONF)
    m = int(props["Acquisition_1C.max_dwells"])
    if fold != int(props["Acquisition_1C.folding_factor"]):
        fail("K4b: the check's fold is not phase 4d's")
    acq = AcqConf(fs_in=FS, max_dwells=m)
    x = acq_dwells(dev, m)
    codes_h = sampled_codes(acq, range(1, 9))
    codes = torch.from_numpy(codes_h).to(dev)
    cffc = torch.from_numpy(pcps.fold_codes(codes_h, fold)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    t = pcps.time_axis(2000, FS, dev)
    n, d, c = 2000, dops.shape[0], codes.shape[0]
    nf = n // fold
    src = "gnss_sim_receiver_tpu_torch/ops/pcps.py"
    rows = [check_fold(x, dops, t, fold, "phase 4d's shape")]
    extra.append(check_fold(acq_dwells(dev, 10), dops, t, 8,
                            "more dwells than a CTA's slice of 8"))
    want = pcps._fold_plain(x, dops, t, fold)
    # the K3 peak kernel on the folded planes, as the search launches it
    spec = torch.fft.fft(want, dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cffc[None, :, None], dim=-1)
    peak = pcps.pcps_peak(corr, m)
    peak_plain = pcps._peak_plain(corr, m)
    torch.cuda.synchronize()
    err = compare("K3 pcps_peak (QuickSync planes)", peak, peak_plain, 1e-4)
    extra.append(_row(
        "K3_pcps_peak", "triton", src, "gnss_sim_receiver_tpu/ops/pcps.py:107",
        err, time_ms(lambda: pcps.pcps_peak(corr, m)),
        time_ms(lambda: pcps._peak_plain(corr, m)),
        m * c * d * nf * 8 + c * 12, m * c * d * nf * 3 + c * d * nf * 2,
        f"GPS L1 C/A QuickSync: M={m} dwells, C={c} channels, D={d} Doppler "
        f"bins, N/fold={nf} folded lags"))
    # the resolve at the folded search's peaks, then at C=10, fold 8
    stat, di, lag = peak
    dop_hz = dops[di.long()].contiguous()
    err, ms, ref_ms, plain, floor_ms = check_resolve(x[0], codes, dop_hz, lag,
                                                     t, fold)
    rows.append(_row(
        "K4b_quicksync_resolve", "cuda",
        "gnss_sim_receiver_tpu_torch/csrc/quicksync_resolve.cu",
        "gnss_sim_receiver_tpu/ops/pcps.py:182", err, ms, plain,
        *resolve_work(c, n, fold),
        f"C={c} channels x {fold} candidates, N={n} samples (dwell 0)"))
    rows[-1].update(reference_ms=ref_ms, launch_floor_ms=floor_ms)
    extra.append(resolve_fold8(dev, x, acq, dops, t))
    del corr, spec
    # the whole search against the JAX functions' form
    buf = pcps.pcps_search_quicksync(x, codes, cffc, dops, t, fold)
    grid = pcps.pcps_quicksync_grid(x, codes, dops, FS, fold)
    ws, wd, wl = pcps.max_to_input_power_stat(grid, float(m))
    wdel, _ = pcps.quicksync_resolve(x[0], codes, dops[wd.long()], wl, FS,
                                     fold)
    compare("K4b search statistic", buf[0], ws, 1e-4)
    compare("K4b search Doppler and delay", buf[1:3].to(torch.int64),
            torch.stack([dops[wd.long()], (wdel % n).float()]).to(
                torch.int64), 0.0)
    found = [p for p, v in zip(range(1, 9), buf[0].tolist())
             if v > pcps.cfar_threshold(0.01, nf * d, m)]
    print(f"  K4b search: detected PRNs {found} at fold {fold}, {m} dwells "
          f"(port {time_ms(lambda: pcps.pcps_search_quicksync(x, codes, cffc, dops, t, fold)):.4f} ms)")
    return rows


def check_fold(x, dops, t, fold: int, label: str) -> dict:
    """K4b's fold (csrc/pcps_wipe.cu) on the dwells x: within 1e-5 of the
    scale of its plain version, bit for bit the Triton kernel it replaced
    (_fold_reference); timed beside that kernel (in turns), the plain
    version and an empty kernel on its grid.  Returns its row."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    (m, n), d = x.shape, dops.shape[0]
    nf = n // fold
    what = f"K4b pcps_quicksync_fold M={m} fold {fold}"
    got = pcps.pcps_quicksync_fold(x, dops, t, fold)
    ref = pcps._fold_reference(x, dops, t, fold)
    err = compare(what, got, pcps._fold_plain(x, dops, t, fold), 1e-5)
    same_bits(f"{what} against the replaced kernel", got, ref)
    ref_ms = [time_ms(lambda: pcps._fold_reference(x, dops, t, fold))]
    ms = time_ms(lambda: pcps.pcps_quicksync_fold(x, dops, t, fold))
    ref_ms.append(time_ms(lambda: pcps._fold_reference(x, dops, t, fold)))
    floor_ms = time_ms(lambda: pcps._fold_empty(m, d, nf, x.device))
    print(f"  {what}: {ms:.4f} ms, the replaced kernel {ref_ms[0]:.4f} / "
          f"{ref_ms[1]:.4f} ms, an empty kernel on its grid {floor_ms:.4f} "
          f"ms ({ms / floor_ms:.2f} x)")
    row = _row(
        "K4b_quicksync_fold", "cuda",
        "gnss_sim_receiver_tpu_torch/csrc/pcps_wipe.cu",
        "gnss_sim_receiver_tpu/ops/pcps.py:152", err, ms,
        time_ms(lambda: pcps._fold_plain(x, dops, t, fold)),
        m * n * 8 + n * 4 + d * 4 + m * d * nf * 8,
        # per (bin, sample): phase 2, sincos 2; per (dwell, bin, sample):
        # product 6, fold sum 2
        d * n * 4 + m * d * n * 8,
        f"M={m} dwells, D={d} Doppler bins, N={n} samples, fold {fold} "
        f"-> N/fold={nf} ({label})")
    row.update(reference_ms=float(np.mean(ref_ms)), launch_floor_ms=floor_ms)
    return row


def resolve_work(c: int, n: int, fold: int) -> tuple[int, int]:
    """The resolve's bytes (x, t, the codes and the per-channel inputs
    read once, delays and magnitudes written once) and operations (per
    (channel, sample): phase 2, sincos 2, wipeoff 6; per candidate: index
    2, multiply-accumulate 4)."""
    return (n * 8 + n * 4 + c * n * 4 + c * 8 + c * 8,
            c * n * 10 + c * fold * n * 6)


def check_resolve(x0, codes, dop_hz, lag, t, fold):
    """K4b's resolve kernel against its plain version and the Triton
    kernel it replaced (with its torch tail): delays identical, magnitudes
    within 1e-4 of the scale.  Returns (error, ms, the replaced kernel's
    ms, plain ms, the launch floor: an empty kernel on the same grid,
    timed the same way)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    c = codes.shape[0]
    got = pcps.pcps_quicksync_resolve(x0, codes, dop_hz, lag, t, fold)
    want = pcps._resolve_plain(x0, codes, dop_hz, lag, t, fold)
    ref = pcps._resolve_reference(x0, codes, dop_hz, lag, t, fold)
    torch.cuda.synchronize()
    what = f"K4b pcps_quicksync_resolve C={c} fold {fold}"
    compare(f"{what} delays", got[0], want[0], 0.0)
    compare(f"{what} delays against the replaced kernel", got[0], ref[0],
            0.0)
    err = compare(f"{what} magnitudes", got[1], want[1], 1e-4)
    compare(f"{what} magnitudes against the replaced kernel", got[1], ref[1],
            1e-4)
    floor_ms = time_ms(lambda: pcps._resolve_empty(c, x0.device))
    ms = time_ms(lambda: pcps.pcps_quicksync_resolve(x0, codes, dop_hz, lag,
                                                     t, fold))
    ref_ms = time_ms(lambda: pcps._resolve_reference(x0, codes, dop_hz, lag,
                                                     t, fold))
    plain = time_ms(lambda: pcps._resolve_plain(x0, codes, dop_hz, lag, t,
                                                fold))
    print(f"  {what}: {ms:.4f} ms, the replaced kernel {ref_ms:.4f} ms, an "
          f"empty kernel on its grid {floor_ms:.4f} ms ({ms / floor_ms:.2f} "
          "x that floor)")
    return err, ms, ref_ms, plain, floor_ms


def resolve_fold8(dev, x, acq, dops, t):
    """The resolve at C=10 (PRNs 1-10), fold 8, at the fold-8 search's own
    peaks on phase 4d's dwells; PRN 10's code replaced by its first N/8
    samples 8 times, so that its 8 candidates tie exactly and the first
    must win.  Returns its row (for the other_shapes line)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import sampled_codes
    from gnss_sim_receiver_tpu_torch.ops import pcps
    fold, m = 8, x.shape[0]
    codes_h = sampled_codes(acq, range(1, 11))
    n = codes_h.shape[1]
    nf = n // fold
    codes_h[9] = np.tile(codes_h[9][:nf], fold)
    codes = torch.from_numpy(codes_h).to(dev)
    cffc = torch.from_numpy(pcps.fold_codes(codes_h, fold)).to(dev)
    folded = pcps.pcps_quicksync_fold(x, dops, t, fold)
    corr = torch.fft.ifft(torch.fft.fft(folded, dim=-1)[:, None]
                          * cffc[None, :, None], dim=-1)
    _, di, lag = pcps.pcps_peak(corr, m)
    dop_hz = dops[di.long()].contiguous()
    c = codes.shape[0]
    err, ms, ref_ms, plain, floor_ms = check_resolve(x[0], codes, dop_hz, lag,
                                                     t, fold)
    got = pcps.pcps_quicksync_resolve(x[0], codes, dop_hz, lag, t, fold)
    if int(got[0][9]) != int(lag[9]):
        fail(f"K4b resolve: the tie of PRN 10's {fold} candidates went to "
             f"delay {int(got[0][9])}, not the first's {int(lag[9])}")
    row = _row("K4b_quicksync_resolve", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/quicksync_resolve.cu",
               "gnss_sim_receiver_tpu/ops/pcps.py:182", err, ms, plain,
               *resolve_work(c, n, fold),
               f"C={c} channels x {fold} candidates, N={n} samples (dwell 0; "
               "PRN 10 an exact tie)")
    row.update(reference_ms=ref_ms, launch_floor_ms=floor_ms)
    return row


def check_k6(dev, fs: float, sats, dur: float, seed: int, label: str):
    """K6 at the shape its path launches it at: the scenario `sats` at rate
    `fs`, `dur` seconds, one launch of K6_CHUNK samples.  Noiseless against
    its plain version on the card (1e-5 of the scale) on the first chunk
    (its first blocks gather at sub-chip indices k < 0) and on the last;
    on both chunks and on the path's own last chunk (n_total mod
    K6_CHUNK samples, which ends in a partial tile), noiseless and with
    the noise key the path draws from `seed`, bit for bit the kernel
    before its redesign (the reference, one thread per sample); then the
    noise: zero mean and unit variance (+-0.02), and the same samples
    whether the chunk is made in one launch or in two.  Both kernels timed
    noiseless and noisy, and the SM clock read while the new one runs."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim import device_generator as dg
    b = 8192
    dg._fill_nav_bits(sats, seed)
    n_total = int(fs * dur)
    tabs = dg._prepare(sats, fs, n_total, 0, dev)
    n = K6_CHUNK
    n_sat = len(sats)
    neg = int((tabs[5][:, : n // b] < 0).sum())
    print(f"  K6 ({label}): {n_sat} satellites, {neg} of the first chunk's "
          f"{n_sat * (n // b)} (satellite, block) anchors have base < 0")
    if not neg:
        fail("K6: the first chunk has no negative sub-chip index")
    worst = 0.0
    path_key, _ = dg._noise_key(True, seed, None)

    def plain(blk0, n_s):
        sl = slice(blk0, blk0 + -(-n_s // b))
        return dg._expand_plain(*tabs[:5], *(a[:, sl] for a in tabs[5:10]),
                                tabs[10], n_s)
    # the path's own last chunk ends in a partial tile of the kernel
    tail = n_total % n
    if tail % K6_TILE == 0:
        fail(f"K6 ({label}): the last chunk ({tail} samples) fills whole "
             "tiles")
    for blk0, n_s in ((0, n), ((n_total - n) // b, n),
                      ((n_total - tail) // b, tail)):
        got = dg.expand(*tabs, n_s, blk0=blk0)
        want = plain(blk0, n_s)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"K6 device_generator ({label}, block {blk0}, {n_s} samples)",
            got, want, 1e-5))
        for key in (None, path_key):
            kw = dict(blk0=blk0, noise_key=key, sample0=blk0 * b)
            got = dg.expand(*tabs, n_s, **kw)
            ref = dg._expand_reference(*tabs, n_s, **kw)
            what = (f"K6 ({label}, block {blk0}, {n_s} samples, "
                    f"{'noiseless' if key is None else 'noisy'})")
            if not torch.equal(bits(got), bits(ref)):
                fail(f"{what}: {int((bits(got) != bits(ref)).sum())} words "
                     "differ from the reference kernel's")
            print(f"  {what}: bit for bit the reference kernel")
    clean = dg.expand(*tabs, n)
    key = 0x5EED0000 + seed
    noisy = dg.expand(*tabs, n, noise_key=key)
    half = n // 2
    split = torch.cat([dg.expand(*tabs, half, noise_key=key),
                       dg.expand(*tabs, half, blk0=half // b, noise_key=key,
                                 sample0=half)])
    z = (noisy - clean).to(torch.complex128)
    mean = complex(z.mean())
    var = float((z.abs() ** 2).mean())
    print(f"  K6 noise ({label}): mean {mean:.2e}, variance {var:.5f}; "
          f"two launches {'identical' if torch.equal(split, noisy) else 'DIFFER'}")
    if abs(mean) > 0.01 or abs(var - 1.0) > 0.02 or \
            not torch.equal(split, noisy):
        fail(f"K6 noise ({label})")
    del clean, noisy, split, z, got, want, ref
    ms = time_ms(lambda: dg.expand(*tabs, n))
    noisy_ms = time_ms(lambda: dg.expand(*tabs, n, noise_key=path_key))
    ref_ms = time_ms(lambda: dg._expand_reference(*tabs, n))
    ref_noisy_ms = time_ms(lambda: dg._expand_reference(
        *tabs, n, noise_key=path_key))
    clock = sm_clock_during(lambda: dg.expand(*tabs, n))
    print(f"  K6 ({label}): noiseless {ms:.4f} ms (reference kernel "
          f"{ref_ms:.4f}), noisy {noisy_ms:.4f} ms (reference kernel "
          f"{ref_noisy_ms:.4f}); SM clock over back-to-back noiseless "
          f"launches {clock}")
    plain_ms = time_ms(lambda: plain(0, n), reps=3)
    nblk = -(-n // b)
    n_bytes = (8 * n + 20 * n_sat * nblk + tabs[0].numel()
               + tabs[2].numel() + 16 * n_sat)
    # per (sample, satellite): chip offset 2, floor and index 2, two
    # floor-mods and a floor-div 6, chip x symbol x amplitude 2, phase 2,
    # sincos 2, accumulate 4
    n_ops = n * n_sat * 20
    row = _row("K6_device_generator", "cuda",
               "gnss_sim_receiver_tpu_torch/csrc/device_generator.cu",
               "gnss_sim_receiver_tpu/sim/device_generator.py:32", worst,
               ms, plain_ms, n_bytes, n_ops,
               f"{label}: S={n_sat} satellites, one launch of {n} samples "
               f"(of {n_total}), tables {tuple(tabs[0].shape)} and "
               f"{tuple(tabs[2].shape)} int8, noiseless")
    row.update(noisy_ms=noisy_ms, reference_ms=ref_ms,
               reference_noisy_ms=ref_noisy_ms, sm_clock=clock)
    return row


# K7 at phase 9's time-sharded shape (127 code periods of PRN 7 at 2 Msps,
# L + N = 256000, a smooth cuFFT size, D = 41 bins) and at L = 4 periods
OS_PERIODS = 127
OS_PRN = 7
OS_DELAY, OS_DOPPLER = 777, 1500.0


def check_k7(dev, rng, extra: list) -> dict:
    """K7 (pcps_window_fold, csrc/pcps_rows.cu) on the card: [D, L + N]
    complex64 correlations folded to [D, N], 1e-5 of the plain grid's
    largest value (the windows are summed in order, torch.sum in its own)
    and bit for bit the Triton kernel it replaced (_window_fold_reference),
    at phase 9's D = 41, L = 127 N, at D = 4, L = 4 N (both timed beside
    that kernel in turns), at an odd N and at L = N.  Returns the row of
    phase 9's shape; the L = 4 N row goes to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    out = []
    for d, periods, n in ((41, OS_PERIODS, 2000), (4, 4, 2000),
                          (5, 4, 1999), (3, 1, 2000)):
        row_len = (periods + 1) * n
        corr = _cnoise(rng, d * row_len, dev).reshape(d, row_len)
        got = pcps.pcps_window_fold(corr, n)
        want = pcps._window_fold_plain(corr, n)
        what = f"K7 pcps_window_fold (D={d}, L={periods} N, N={n})"
        err = compare(what, got, want, 1e-5)
        ref = pcps._window_fold_reference(corr, n)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            fail(f"{what}: differs from the replaced Triton kernel")
        print(f"  {what}: bit for bit the replaced Triton kernel")
        if n % 2 or periods == 1:
            continue
        ref_ms = [time_ms(lambda: pcps._window_fold_reference(corr, n))]
        ms = time_ms(lambda: pcps.pcps_window_fold(corr, n))
        ref_ms.append(time_ms(lambda: pcps._window_fold_reference(corr, n)))
        print(f"  {what}: {ms:.4f} ms, the replaced kernel {ref_ms[0]:.4f} "
              f"/ {ref_ms[1]:.4f} ms")
        n_lags = periods * n
        row = _row(
            "K7_pcps_window_fold", "cuda",
            "gnss_sim_receiver_tpu_torch/csrc/pcps_rows.cu",
            "gnss_sim_receiver_tpu/parallel/shard_steps.py:226", err, ms,
            time_ms(lambda: pcps._window_fold_plain(corr, n)),
            d * n_lags * 8 + d * n * 4, d * n_lags * 4,
            f"D={d} Doppler bins, L={n_lags} lags of {periods} periods, "
            f"N={n}")
        row["reference_ms"] = float(np.mean(ref_ms))
        out.append(row)
        del corr, got, want, ref
    extra.append(out[1])
    return out[0]


def check_k3_rows(dev) -> dict:
    """K3's row kernel alone (pcps_rows: per channel and Doppler row the
    max, first argmax and sum of the grid), the Doppler-sharded search's
    reduction, at phase 9's shape: the static scenario's 2 dwells against
    all 32 PRNs' replicas, 41 bins.  Against its plain version: the maxima
    and sums within 1e-5 of the largest; each row's argmax a cell of the
    plain grid holding the row's max within that tolerance (two cells a
    rounding apart may swap)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps
    x = acq_dwells(dev)
    cfc = torch.from_numpy(code_replicas(AcqConf(fs_in=FS, max_dwells=2),
                                         range(1, 33))).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    spec = torch.fft.fft(pcps.pcps_wipe(x, dops, pcps.time_axis(2000, FS,
                                                                dev)), dim=-1)
    corr = torch.fft.ifft(spec[:, None] * cfc[None, :, None], dim=-1)
    m, c, d, n = corr.shape
    got, want = pcps.pcps_rows(corr, m), pcps._rows_plain(corr)
    err = compare("K3 pcps_rows (max, sum)", (got[0], got[2]),
                  (want[0], want[2]), 1e-5)
    at = torch.gather(pcps._plain_grid(corr), -1,
                      got[1].long()[..., None])[..., 0]
    compare("K3 pcps_rows, the plain grid at each row's argmax", at,
            want[0], 1e-5)
    print(f"  K3 pcps_rows: {int((got[1] != want[1]).sum())} of {c * d} row "
          "argmaxes differ from the plain version's")
    return _row("K3_pcps_rows", "triton",
                "gnss_sim_receiver_tpu_torch/ops/pcps.py",
                "gnss_sim_receiver_tpu/parallel/shard_steps.py:164", err,
                time_ms(lambda: pcps.pcps_rows(corr, m)),
                time_ms(lambda: pcps._rows_plain(corr)),
                m * c * d * n * 8 + c * d * 12,
                m * c * d * n * 3 + c * d * n * 2,
                f"M={m} dwells, C={c} channels, D={d} Doppler bins, "
                f"N={n} samples")


SIGMA_BATCH = 4096


def _spd(rng, b: int, n: int, dev, scale: float = 1.0):
    import torch
    a = rng.standard_normal((b, n, n))
    m = scale * (a @ np.swapaxes(a, -1, -2) / n + 0.5 * np.eye(n))
    return torch.from_numpy(m.astype(np.float32)).to(dev)


def same_sigma_bits(what: str, got, ref) -> None:
    """Fails unless each tensor of `got` has the bits of `ref`'s (NaN
    included: the card's arithmetic gives one NaN)."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        if not torch.equal(bits(g), bits(r)):
            n = int((bits(g) != bits(r)).sum())
            fail(f"{what}: {n} of {g.numel()} values differ from the "
                 "replaced kernel's")
    print(f"  {what}: bit for bit the replaced kernel")


def in_turns(call, ref, floor=None) -> tuple:
    """(ms of `call`, [ms of `ref` before and after it], ms of `floor`):
    the replaced kernel timed on both sides of the new one."""
    ref_ms = [time_ms(ref)]
    ms = time_ms(call)
    ref_ms.append(time_ms(ref))
    return ms, ref_ms, None if floor is None else time_ms(floor)


def graph_ops(fn) -> int:
    """The device operations one call of `fn` issues (kernels, memsets,
    copies): the nodes of a CUDA graph that captures it after a warm
    call, as cuGraphGetNodes counts them.  Unlike torch.profiler it
    cannot lose a record."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        fail(f"cuGraphGetNodes: CUresult {err}")
    return n.value


def one_device_op(what: str, call) -> None:
    """Fails unless one call of `call` issues one device operation (the
    nodes of a CUDA graph of it, graph_ops)."""
    n_dev = graph_ops(call)
    print(f"  {what}: {n_dev} device operation(s) a call (the nodes of a "
          "CUDA graph of one call)")
    if n_dev != 1:
        fail(f"{what}: {n_dev} device operations a call, not 1")


# (rule, nx, nz, filters, square H): phase 9b's shape first (the rows),
# its tanh filters' (a row of its own under other_shapes), an 8-state PVT
# filter plus one, an 8-state PVT filter over 12 pseudoranges (nz > nx:
# lanes nx to nz - 1 hold LU columns and no row of K), the wrappers' limit
# (the one-warp route), a square 16-state LU, and a last warp holding part
# of a CTA's filters
SIGMA_SHAPES = (("cubature", 4, 2, SIGMA_BATCH, False),
                ("unscented", 4, 2, SIGMA_BATCH, False),
                ("cubature", 1, 1, SIGMA_BATCH, False),
                ("cubature", 9, 2, SIGMA_BATCH, False),
                ("unscented", 9, 2, SIGMA_BATCH, False),
                ("cubature", 8, 12, SIGMA_BATCH, False),
                ("cubature", 32, 2, SIGMA_BATCH, False),
                ("cubature", 16, 16, SIGMA_BATCH, True),
                ("cubature", 4, 2, SIGMA_BATCH + 1, False))


def check_k10(dev, rng, extra: list) -> list:
    """K10a (sigma_points) and K10b (sigma_moments, the time and the
    measurement update) on the card at SIGMA_SHAPES: against their plain
    versions within 1e-5 of the largest plain value (the factor, the sums
    and the solve run in other orders: cuSOLVER's and cuBLAS's), and bit
    for bit the one-warp-a-filter kernels they replaced
    (_sigma_points_reference, _sigma_moments_reference), which each shape
    times on both sides of the new kernels, beside an empty kernel on the
    new grid, torch.linalg.cholesky_ex on [B, nx, nx] and
    torch.linalg.solve_ex on [B, nz, nz] (the library reference times; the
    _ex forms skip the host sync of the error check).  Then the planted
    cases (check_k10_planted).  Returns the rows of phase 9b's shape
    (cubature, nx = 4, nz = 2); the others go to `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    rows = []
    for rule, nx, nz, b, square in SIGMA_SHAPES:
        shape = f"B={b} filters, nx={nx}, nz={nz}, {rule}"
        pre, post, centre = nl._rule(nx, rule, None, torch.float32)
        x = torch.from_numpy(rng.standard_normal((b, nx)).astype(
            np.float32)).to(dev)
        P = _spd(rng, b, nx, dev)
        w = nl.sigma_weights(nx, rule, None, torch.float32, dev)
        n_pts = w.shape[0]
        pts = nl.sigma_points(x, P, rule)
        err = compare(f"K10a sigma_points ({shape})", pts,
                      nl._sigma_points_plain(x, P, pre, post, centre), 1e-5)
        same_sigma_bits(f"K10a sigma_points ({shape})", pts,
                        nl._sigma_points_reference(x, P, rule))
        plain_ms = time_ms(
            lambda: nl._sigma_points_plain(x, P, pre, post, centre))
        lib_ms = time_ms(lambda: torch.linalg.cholesky_ex(P))
        ms, ref_ms, floor_ms = in_turns(
            lambda: nl.sigma_points(x, P, rule),
            lambda: nl._sigma_points_reference(x, P, rule),
            lambda: nl._sigma_empty(b, nx, n_pts, dev))
        print(f"  K10a ({shape}): {ms:.4f} ms, the replaced kernel "
              f"{ref_ms[0]:.4f} / {ref_ms[1]:.4f} ms, an empty kernel on "
              f"the grid {floor_ms:.4f} ms")
        # operations: the factor n^3/3 multiply-adds, n square roots and
        # n^2/2 divisions; the points a multiply and an add per element
        ops = b * (2 * nx ** 3 / 3 + nx * nx / 2 + nx + 4 * nx * nx)
        k10a = _row("K10a_sigma_points", "cuda",
                    "gnss_sim_receiver_tpu_torch/csrc/sigma.cu",
                    "gnss_sim_receiver_tpu/ops/nonlinear.py:64", err, ms,
                    plain_ms, 4 * b * (nx + nx * nx + n_pts * nx), ops,
                    shape, lib_ms)
        k10a.update(reference_ms=float(np.mean(ref_ms)),
                    launch_floor_ms=floor_ms)
        F = torch.from_numpy(np.eye(nx, dtype=np.float32) + 0.05 * rng.
                             standard_normal((nx, nx)).astype(np.float32))
        H = rng.standard_normal((nz, nx)).astype(np.float32)
        if square:
            H = np.eye(nz, dtype=np.float32) + 0.1 * H
        H = torch.from_numpy(H)
        ypts = (pts @ F.to(dev).T).contiguous()
        # a linear measurement: P_zz is H P H^T + R under either rule (the
        # unscented centre weight is negative at nx > 3), so the solve is
        # well conditioned and the check measures the kernel's rounding;
        # at nz > nx H P H^T has rank nx, and R at unit scale keeps P_zz's
        # condition near 100 (at 0.1 float32 alone is 2e-5 off float64)
        zpts = (pts @ H.to(dev).T).contiguous()
        Q = 0.01 * torch.eye(nx, device=dev)
        R = _spd(rng, b, nz, dev, 1.0 if nz > nx else 0.1)
        z = torch.from_numpy(rng.standard_normal((b, nz)).astype(
            np.float32)).to(dev)
        got = nl.sigma_moments(ypts, w, Q)
        compare(f"K10b sigma_moments, time update ({shape})", got,
                nl._sigma_moments_plain(ypts, w, Q), 1e-5)
        same_sigma_bits(f"K10b sigma_moments, time update ({shape})", got,
                        nl._sigma_moments_reference(ypts, w, Q))
        upd = dict(z=z, x_pred=x, P_pred=P, pts=pts)
        got = nl.sigma_moments(zpts, w, R, **upd)
        err = compare(f"K10b sigma_moments, measurement update ({shape})",
                      got, nl._sigma_moments_plain(zpts, w, R, **upd), 1e-5)
        same_sigma_bits(f"K10b sigma_moments, measurement update ({shape})",
                        got, nl._sigma_moments_reference(zpts, w, R, **upd))
        plain_ms = time_ms(
            lambda: nl._sigma_moments_plain(zpts, w, R, **upd))
        pzz = _spd(rng, b, nz, dev)
        rhs = torch.from_numpy(rng.standard_normal((b, nz, nx)).astype(
            np.float32)).to(dev)
        lib_ms = time_ms(lambda: torch.linalg.solve_ex(pzz, rhs))
        t_ms, t_ref, _ = in_turns(
            lambda: nl.sigma_moments(ypts, w, Q),
            lambda: nl._sigma_moments_reference(ypts, w, Q))
        ms, ref_ms, floor_ms = in_turns(
            lambda: nl.sigma_moments(zpts, w, R, **upd),
            lambda: nl._sigma_moments_reference(zpts, w, R, **upd),
            lambda: nl._sigma_empty(b, max(nx, nz), n_pts, dev))
        print(f"  K10b ({shape}): the measurement update {ms:.4f} ms (the "
              f"replaced kernel {ref_ms[0]:.4f} / {ref_ms[1]:.4f}), the time "
              f"update {t_ms:.4f} ms ({t_ref[0]:.4f} / {t_ref[1]:.4f}); an "
              f"empty kernel on the update's grid {floor_ms:.4f} ms")
        # the measurement update: the z mean and deviations, P_zz, P_xz,
        # the LU and the substitutions, K P_zz K^T, x, the symmetrisation
        ops = b * (3 * n_pts * nz + n_pts * nx + 3 * n_pts * nz * nz
                   + 3 * n_pts * nx * nz + 2 * nz ** 3 / 3
                   + 2 * nz * nz * nx + 2 * nx * nz * nz + 2 * nx * nx * nz
                   + 2 * nx * nz + 3 * nx * nx)
        n_bytes = 4 * (b * (nz + 2 * nx + 2 * nx * nx + n_pts * (nx + nz)
                            + nz * nz) + n_pts)
        k10b = _row("K10b_sigma_moments", "cuda",
                    "gnss_sim_receiver_tpu_torch/csrc/sigma.cu",
                    "gnss_sim_receiver_tpu/ops/nonlinear.py:80", err, ms,
                    plain_ms, n_bytes, ops,
                    shape + ", the measurement update", lib_ms)
        k10b.update(reference_ms=float(np.mean(ref_ms)),
                    launch_floor_ms=floor_ms, time_update_ms=t_ms,
                    time_update_reference_ms=float(np.mean(t_ref)))
        if rows:
            extra += [k10a, k10b]
        else:
            one_device_op(f"K10a ({shape})",
                          lambda: nl.sigma_points(x, P, rule))
            one_device_op(f"K10b, time update ({shape})",
                          lambda: nl.sigma_moments(ypts, w, Q))
            one_device_op(f"K10b, measurement update ({shape})",
                          lambda: nl.sigma_moments(zpts, w, R, **upd))
            rows = [k10a, k10b]
    check_k10_planted(dev, rng)
    return rows


def check_k10_planted(dev, rng) -> None:
    """K10a and K10b bit for bit their replaced kernels on planted inputs:
    under the unscented rule (its centre weight negative at nx = 4) a P
    that is not positive definite in every third filter, which must give
    NaN points but the centre, x itself; and P_zz^T's first column tied
    in |.| across its two rows (zero-mean z points (1, 1) and (-1, -1)
    and R with R[0][0] + 0.25 = -(R[1][0] + 0.25)), where the first row
    pivots."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    b, nx, nz = SIGMA_BATCH, 4, 2
    x = torch.from_numpy(rng.standard_normal((b, nx)).astype(
        np.float32)).to(dev)
    P = _spd(rng, b, nx, dev)
    bad = torch.arange(b, device=dev) % 3 == 0
    P[bad] = P[bad] - 4.0 * torch.eye(nx, device=dev)
    what = "K10a sigma_points (unscented, nx=4, P not positive definite)"
    pts = nl.sigma_points(x, P, "unscented")
    same_sigma_bits(what, pts, nl._sigma_points_reference(x, P,
                                                          "unscented"))
    nan_rows = torch.isnan(pts[:, 1:]).all(dim=(1, 2))
    finite = torch.isfinite(pts).all(dim=(1, 2))
    if not (torch.equal(pts[:, 0], x) and bool(nan_rows[bad].all())
            and bool(finite[~bad].all())):
        fail(f"{what}: not NaN points but the centre exactly where the "
             "factor fails, and finite elsewhere")
    w = nl.sigma_weights(nx, "unscented", None, torch.float32, dev)
    zpts = torch.from_numpy(rng.standard_normal((b, 2 * nx + 1, nz)).astype(
        np.float32)).to(dev)
    R = _spd(rng, b, nz, dev, 0.1)
    upd = dict(z=zpts[:, 0].contiguous(), x_pred=x, P_pred=P, pts=pts)
    same_sigma_bits("K10b sigma_moments (unscented, nx=4, on those points)",
                    nl.sigma_moments(zpts, w, R, **upd),
                    nl._sigma_moments_reference(zpts, w, R, **upd))
    print(f"  K10a: {int(bad.sum())} of {b} filters not positive definite "
          "give NaN points but the centre")
    # the tie: cubature weights 1/8, so P_zz = [[.25, .25], [.25, .25]] + R
    # exactly; with R = [[s - .25, -s - .25], [-s - .25, 3 s]], s = 1 .. 8
    # a filter, P_zz = [[s, -s], [-s, 3 s + .25]]
    w = nl.sigma_weights(nx, "cubature", None, torch.float32, dev)
    P = _spd(rng, b, nx, dev)
    pts = nl.sigma_points(x, P, "cubature")
    zpts = torch.zeros((b, 2 * nx, nz), device=dev)
    zpts[:, 0] = 1.0
    zpts[:, 1] = -1.0
    s = torch.from_numpy(rng.integers(1, 9, b).astype(np.float32)).to(dev)
    R = torch.zeros((b, nz, nz), device=dev)
    R[:, 0, 0] = s - 0.25
    R[:, 1, 0] = R[:, 0, 1] = -s - 0.25
    R[:, 1, 1] = 3.0 * s
    upd = dict(z=torch.ones((b, nz), device=dev), x_pred=x, P_pred=P,
               pts=pts)
    got = nl.sigma_moments(zpts, w, R, **upd)
    compare("K10b sigma_moments (P_zz^T's first column tied)", got,
            nl._sigma_moments_plain(zpts, w, R, **upd), 1e-5)
    same_sigma_bits("K10b sigma_moments (P_zz^T's first column tied)", got,
                    nl._sigma_moments_reference(zpts, w, R, **upd))
    check_k10_many_points(dev, rng)


def check_k10_many_points(dev, rng) -> None:
    """K10b where the points outnumber 2 G + 1 of the filter's own
    dimensions, so that the lane group follows the points: time updates to
    fewer outputs than states (ny = 1 of nx = 4 under the cubature rule,
    8 points; ny = 2 of nx = 9 under the unscented, 19 points) and a
    measurement update at nx = 2, nz = 1 on 8 points of a 4-state set;
    each within 1e-5 of the plain version and bit for bit the replaced
    kernel."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    b = SIGMA_BATCH
    for rule, nx, ny in (("cubature", 4, 1), ("unscented", 9, 2)):
        what = f"K10b sigma_moments, time update ({rule}, nx={nx}, ny={ny})"
        x = torch.from_numpy(rng.standard_normal((b, nx)).astype(
            np.float32)).to(dev)
        pts = nl.sigma_points(x, _spd(rng, b, nx, dev), rule)
        w = nl.sigma_weights(nx, rule, None, torch.float32, dev)
        A = torch.from_numpy(rng.standard_normal((ny, nx)).astype(
            np.float32)).to(dev)
        ypts = torch.tanh(pts @ A.T).contiguous()
        Q = 0.01 * torch.eye(ny, device=dev)
        got = nl.sigma_moments(ypts, w, Q)
        compare(what, got, nl._sigma_moments_plain(ypts, w, Q), 1e-5)
        same_sigma_bits(what, got, nl._sigma_moments_reference(ypts, w, Q))
    what = "K10b sigma_moments, measurement update (nx=2, nz=1, 8 points)"
    w = nl.sigma_weights(4, "cubature", None, torch.float32, dev)
    x = torch.from_numpy(rng.standard_normal((b, 2)).astype(
        np.float32)).to(dev)
    pts = x[:, None] + torch.from_numpy(rng.standard_normal(
        (b, 8, 2)).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.standard_normal((1, 2)).astype(
        np.float32)).to(dev)
    zpts = (pts @ h.T).contiguous()
    R = _spd(rng, b, 1, dev, 0.1)
    upd = dict(z=torch.from_numpy(rng.standard_normal((b, 1)).astype(
        np.float32)).to(dev), x_pred=x, P_pred=_spd(rng, b, 2, dev),
        pts=pts)
    got = nl.sigma_moments(zpts, w, R, **upd)
    compare(what, got, nl._sigma_moments_plain(zpts, w, R, **upd), 1e-5)
    same_sigma_bits(what, got, nl._sigma_moments_reference(zpts, w, R,
                                                           **upd))


# ---- phases 4, 4b, 4c: the main paths --------------------------------------

def rx_true_ecef():
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    return geodesy.llh_to_ecef(np.radians(RX_LLH[0]), np.radians(RX_LLH[1]),
                               RX_LLH[2])


CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=4000000
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.number_of_taps=31
InputFilter.cutoff=0.45
InputFilter.decimation_factor=2
InputFilter.IF=0
Resampler.implementation=Pass_Through
Channels_1C.count=8
Channels.in_acquisition=8
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.coherent_integration_time_ms=1
Acquisition_1C.pfa=0.01
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


# phase 5: the reference's hybrid operating point (conf/gnss-sdr_Hybrid_
# byte.conf as tests/test_cli.py:78-95 records it: an ibyte file at 20 Msps,
# 10 + 10 channels, E1 Doppler step 125 Hz, PLL 15 Hz, very-early-late 0.6
# chips), with CCCWSR acquisition on the E1 chain; every PRN unpinned
HYBRID_CONF = """\
GNSS-SDR.internal_fs_sps={fs}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs}
Channels_1C.count=10
Channels_1B.count=10
Channels.in_acquisition=20
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Acquisition_1B.implementation=Galileo_E1_PCPS_CCCWSR_Ambiguous_Acquisition
Acquisition_1B.doppler_step=125
Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking
Tracking_1B.very_early_late_space_chips=0.6
Tracking_1B.pll_bw_hz=15
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
"""


# phase 7: the wideband operating point (BASELINE.json config 4: GPS L5 and
# Galileo E5a on one 20 Msps RF stream, 10 + 10 channels), the E5a chain on
# the non-coherent I/Q search with a 500 Hz CAF window (one 250 Hz Doppler
# bin each side); every PRN unpinned.  Both searches double their FFT
# (bit_transition_flag): the L5I and E5a-I data signals change sign at every
# 1 ms code epoch (NH10, CS20), and a 1 ms dwell cut by such an edge puts
# the Doppler peak up to ~800 Hz off, where the tracking FLL (decision-
# directed, +-250 Hz at 1 ms) locks 500 Hz off
WIDEBAND_CONF = """\
GNSS-SDR.internal_fs_sps={fs}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs}
Channels_L5.count=10
Channels_5X.count=10
Channels.in_acquisition=20
Acquisition_L5.implementation=GPS_L5i_PCPS_Acquisition
Acquisition_L5.bit_transition_flag=true
Tracking_L5.implementation=GPS_L5_DLL_PLL_Tracking
Acquisition_5X.implementation=Galileo_E5a_Noncoherent_IQ_Acquisition_CAF
Acquisition_5X.CAF_window_hz=500
Acquisition_5X.bit_transition_flag=true
Tracking_5X.implementation=Galileo_E5a_DLL_PLL_Tracking
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
"""


# phase 4d: phase 4's conf with QuickSync acquisition.  Folding the 1 ms
# dwell by 4 folds the noise of four segments into each lag; at the
# scenario's 47 dB-Hz two dwells leave most satellites under the threshold
# (the JAX engine's statistics are the same), so the search takes 8.
QUICKSYNC_CONF = CONF.replace(
    "Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition",
    "Acquisition_1C.implementation=GPS_L1_CA_PCPS_QuickSync_Acquisition\n"
    "Acquisition_1C.folding_factor=4").replace(
    "Acquisition_1C.max_dwells=2", "Acquisition_1C.max_dwells=8")


def conf_properties(text: str) -> dict:
    """key -> value of a conf text's `key=value` lines."""
    return dict(line.split("=", 1) for line in text.splitlines()
                if "=" in line)


def synthesize(fs: float, dur: float, n_samples=None) -> np.ndarray:
    """The static scenario (6 satellites, 47 dB-Hz) at rate `fs`: all
    `dur` seconds of it, or its first `n_samples` samples."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, dur,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    return generate_baseband(
        sats, fs, int(fs * dur) if n_samples is None else n_samples,
        noise=True, seed=42, bandlimit_oversample=4)


def hybrid_ephemerides():
    """The hybrid scenario's broadcast ephemerides: GPS PRNs 1, 3, 4, 5 of
    the sky at toe = T0 + 600 and Galileo PRNs 11-15 on the other
    satellites' orbits (toe on the 60 s I/NAV grid, BGD(E1,E5b) 0)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    base = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    gps = [e for e in base if e.prn in HYB_GPS_PRNS]
    toe60 = round((T0 + 600) / 60.0) * 60.0   # INAV toe LSB is 60 s
    gal = [dataclasses.replace(e, system="Galileo", prn=prn, toe=toe60,
                               toc=toe60, iod_nav=137, bgd_e1e5b=0.0)
           for prn, e in zip(HYB_GAL_PRNS, (e for e in base
                                            if e.prn not in HYB_GPS_PRNS))]
    return gps, gal


def hybrid_sats():
    """The hybrid scenario's satellites: GPS PRNs 1, 3, 4, 5 (LNAV) and
    Galileo PRNs 11-15 (E1-B, I/NAV pages), 48 dB-Hz, the 26 s geometry
    (tests/test_hybrid_position.py:25-58)."""
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    gps, gal = hybrid_ephemerides()
    return build_static_scenario(gps + gal, rx_true_ecef(), T0, DUR,
                                 cn0_db_hz=48.0, subframe_cycle=(1, 2, 3))


def pilot_sats():
    """Phase 8's satellites: phase 5's scenario with both E1 components on
    every Galileo satellite, E1-B (its I/NAV pages) and E1-C (CS25 tiled,
    one chip per 4 ms code period), each at -3 dB, as
    tests/test_track_pilot.py:24-53 builds them."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch import signals
    split = 10.0 * np.log10(0.5)
    chips = np.tile(signals.e1c_secondary_code().astype(np.int8),
                    int(np.ceil(DUR * 250 / 25)) + 2)
    out = []
    for s in hybrid_sats():
        if s.system == "Galileo":
            s = dataclasses.replace(s, cn0_db_hz=s.cn0_db_hz + split)
            out += [s, dataclasses.replace(s, signal="1P", nav_bits=chips)]
        else:
            out.append(s)
    return out


def synthesize_hybrid(fs: float, n_samples: int) -> np.ndarray:
    """The first `n_samples` of the hybrid scenario at rate `fs`, by the
    host simulator (band-limited, seed 17)."""
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        generate_baseband
    return generate_baseband(hybrid_sats(), fs, n_samples, noise=True,
                             seed=17, bandlimit_oversample=4)


def offband_satellites(ephs, rx_ecef, t0: float, dur: float, cn0: float,
                       signal: str, f_c: float, nav_bits):
    """`signal` signals on the carrier `f_c` for ephemerides `ephs`, as the
    scenario's L5 branch builds GPS L5 ones (the scenario builder has no
    other band): the light-time delay fitted by a quadratic over `dur`,
    Doppler, code Doppler and carrier phase on `f_c`, `nav_bits(eph)` the
    satellite's signs (per symbol, or per code epoch where a secondary
    code spreads the symbols)."""
    from gnss_sim_receiver_tpu_torch.sim import scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    ts = np.array([0.0, dur / 2.0, dur])
    out = []
    for eph in ephs:
        d = np.array([scenario._light_time_delay(eph, rx_ecef, t0 + t)
                      for t in ts])
        d0 = d[0]
        d2 = (d[2] - 2.0 * d[1] + d[0]) / (dur / 2.0) ** 2
        d1 = (d[2] - d[0]) / dur - d2 * dur / 2.0
        out.append(SatelliteSignalParams(
            prn=eph.prn, system=eph.system, signal=signal, cn0_db_hz=cn0,
            doppler_hz=-f_c * d1, doppler_rate_hz_s=-f_c * d2,
            delay_sec=d0, delay_chips=0.0,
            carrier_phase_rad=float(np.mod(-2.0 * np.pi * f_c * d0,
                                           2.0 * np.pi)),
            code_doppler_hz=-f_c * d1, carrier_ref_hz=f_c,
            nav_bits=nav_bits(eph)))
    return out


def e5a_satellites(ephs, rx_ecef, t0: float, dur: float, cn0: float):
    """Galileo E5a-I signals for Galileo ephemerides: F/NAV pages from `t0`
    spread by CS20 as per-epoch signs."""
    from gnss_sim_receiver_tpu_torch.nav import fnav
    n_rep = int(np.ceil((dur + 20.0) / 40.0))
    return offband_satellites(
        ephs, rx_ecef, t0, dur, cn0, "5X", F_L5,
        lambda e: fnav.e5a_epoch_signs(
            fnav.pages_for_ephemeris(e, t0, n_repeats=n_rep), e.prn))


def wideband_sats():
    """Phase 7's satellites: phase 5's geometry with toe = toc = WB_TOE,
    GPS PRNs 1, 3, 4, 5 on L5 (CNAV at 50 bps, NH10) and Galileo PRNs 11-15
    on E5a-I (F/NAV, CS20), 48 dB-Hz."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    base = [dataclasses.replace(e, toe=WB_TOE, toc=WB_TOE)
            for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                            toe=WB_TOE)]
    gps = [e for e in base if e.prn in HYB_GPS_PRNS]
    gal = [dataclasses.replace(e, system="Galileo", prn=prn, iod_nav=137,
                               bgd_e1e5a=0.0)
           for prn, e in zip(HYB_GAL_PRNS, (e for e in base
                                            if e.prn not in HYB_GPS_PRNS))]
    sats = build_static_scenario(gps, rx_true_ecef(), T0, WB_DUR,
                                 cn0_db_hz=48.0, band="L5")
    sats += e5a_satellites(gal, rx_true_ecef(), T0, WB_DUR, 48.0)
    if [(s.signal, s.prn) for s in sats] != (
            [("L5", p) for p in HYB_GPS_PRNS]
            + [("5X", p) for p in HYB_GAL_PRNS]):
        fail(f"wideband scenario: {[(s.signal, s.prn) for s in sats]}")
    return sats


# (M, table form, N) of every wipeoff phase 3 held to its reference
WIPE_CHECKED: set = set()


def wipe_key(shape: tuple) -> tuple:
    """(M, "grid" or "table", N) of a wipeoff launch's (M, *table, N): the
    kernel's code paths and grid depend on M and N, its rows only repeat
    (the narrow tables' channel counts follow the acquisitions pending)."""
    return shape[0], "table" if len(shape) == 4 else "grid", shape[-1]


def max_ulps(got, ref) -> int:
    """The largest difference in units in the last place between two
    float32 (or complex64) tensors of the same signs."""
    import torch
    a, b = bits(got).to(torch.int64), bits(ref).to(torch.int64)
    return int((a - b).abs().max())


def k3_search(cfc, m: int):
    """The search after the wipeoff: cuFFT, the product with the code
    replicas [C, N] (one family, or the [C, D2] table's channel's own),
    cuFFT, K3's peak -> (stat, Doppler index, delay index)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps

    def search(wiped):
        spec = torch.fft.fft(wiped, dim=-1)
        if wiped.dim() == 3:
            spec = spec[:, None]
        return pcps.pcps_peak(torch.fft.ifft(
            spec * cfc[None, :, None], dim=-1), m)
    return search


def wipe_case(x, dops, t, label: str, search=None, plain_reps: int = 20):
    """The wipeoff (pcps_wipe, csrc/pcps_wipe.cu) at one shape its paths
    launch it at: within 1e-5 of the plain version's scale; bit for bit
    the Triton kernel it replaced (_wipe_reference), or else the largest
    difference in ulps printed; with `search` (wiped dwells -> stat,
    Doppler index, delay index), the search's outputs from both kernels'
    dwells: cells exact, the statistic within 1e-4 of its scale.  The
    kernel, the reference and the plain version timed in the same call;
    returns the row (reference_ms beside ms)."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    per_channel = dops.dim() == 2
    name = "K3b_pcps_wipe_per_channel" if per_channel else "K3_pcps_wipe"
    plain = (pcps._wipe_per_channel_plain if per_channel
             else pcps._wipe_plain)
    m, n = x.shape
    got = pcps.pcps_wipe(x, dops, t)
    ref = pcps._wipe_reference(x, dops, t)
    want = plain(x, dops, t)
    torch.cuda.synchronize()
    err = compare(f"{name} ({label})", got, want, 1e-5)
    del want
    same = torch.equal(bits(got), bits(ref))
    ulps = 0 if same else max_ulps(got, ref)
    print(f"  {name} ({label}): "
          + ("bit for bit the Triton reference" if same else
             f"differs from the Triton reference by up to {ulps} ulps"))
    if search is not None:
        a, b = search(got), search(ref)
        torch.cuda.synchronize()
        compare(f"{name} ({label}) search statistic against the "
                "reference's", a[0], b[0], 1e-4)
        compare(f"{name} ({label}) search cells against the reference's",
                a[1:], b[1:], 0.0)
        del a, b
    del got, ref
    torch.cuda.empty_cache()
    WIPE_CHECKED.add(wipe_key((m, *dops.shape, n)))
    rows = dops.numel()
    ms = time_ms(lambda: pcps.pcps_wipe(x, dops, t))
    ref_ms = time_ms(lambda: pcps._wipe_reference(x, dops, t))
    plain_ms = time_ms(lambda: plain(x, dops, t), reps=plain_reps)
    table = (f"C={dops.shape[0]} channels, D2={dops.shape[1]} Doppler rows "
             "each" if per_channel else f"D={rows} Doppler bins")
    out_mb = m * rows * n * 8 / 1e6
    row = _row(name, "cuda", "gnss_sim_receiver_tpu_torch/csrc/pcps_wipe.cu",
               "gnss_sim_receiver_tpu/ops/pcps.py:"
               + ("65" if per_channel else "33"), err, ms, plain_ms,
               m * n * 8 + rows * 4 + n * 4 + m * rows * n * 8,
               m * rows * n * 10,        # phase 2, sincos 2, product 6
               f"{label}: M={m} dwells, {table}, N={n} samples "
               f"({out_mb:.1f} MB out)")
    print(f"  {name} ({label}): reference {ref_ms:.4f} ms")
    if out_mb >= 10 and ms > 2 * row["bound_ms"]:
        fail(f"{name} ({label}): {ms:.4f} ms, above twice its bound "
             f"{row['bound_ms']:.4f} ms")
    row.update(reference_ms=ref_ms, bit_for_bit=same, max_ulps=ulps)
    return row


def wideband_dwells(dev, n: int):
    """The first `n` samples of phase 7's scenario on the card, by the
    device generator (seed 17), for the phase 3 checks."""
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    return generate_baseband_device_resident(wideband_sats(), FS_WIDEBAND, n,
                                             noise=True, seed=17, device=dev)


def wideband_chains(fs: float = FS_WIDEBAND):
    """The (L5, E5a) chains that the factory builds from phase 7's conf."""
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    props = conf_properties(WIDEBAND_CONF.format(capture="", fs=int(fs)))
    return receiver_conf_from_config(InMemoryConfiguration(props)).chains


def full_chain_sats():
    """bench.py:_bench_full_chain's scenario (bench.py:128-155): 12
    satellites for a 12-channel receiver, 47 dB-Hz, LNAV subframes 1-3,
    120 s."""
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600,
                                  offsets_deg=FULL_OFFSETS)
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, FULL_DUR,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    if tuple(s.prn for s in sats) != FULL_PRNS:
        fail(f"full-chain scenario: satellites {[s.prn for s in sats]}")
    return sats


def capture_paths(root: str) -> dict:
    build = os.path.join(root, "build")
    return {"file": os.path.join(build, "static_scenario_26s_4msps_v1.ishort"),
            "direct": os.path.join(build, "static_scenario_8s_2msps_v1.npy"),
            "hybrid": os.path.join(build,
                                   "hybrid_scenario_26s_20msps_v1.ibyte"),
            "wideband": os.path.join(build,
                                     "wideband_scenario_60s_20msps_v1.ibyte")}


SYNTHESIZED = ("file", "direct")        # by the child processes


def make_capture(root: str, which: str) -> None:
    """Synthesize one capture into ``build/`` unless it is there: "file",
    the 26 s scenario at 4 Msps as interleaved int16 (104 M samples,
    416 MB), or "direct", its first 8 s at 2 Msps as complex64."""
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)[which]
    if os.path.exists(path):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    if which == "file":
        write_samples(tmp, synthesize(FS_FILE, DUR), "ishort", scale=200.0)
    else:
        with open(tmp, "wb") as fh:
            np.save(fh, synthesize(FS, DIRECT_DUR))
    os.replace(tmp, path)


def start_synthesis(root: str) -> dict:
    """One child process per host-synthesized capture, so that the
    synthesis runs beside phases 2 and 3."""
    return {which: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--synthesize", which],
        cwd=root) for which in SYNTHESIZED}


def wait_for(procs: dict, which: str) -> None:
    t0 = time.perf_counter()
    rc = procs[which].wait()
    if rc != 0:
        fail(f"synthesis of the {which!r} capture exited with {rc}")
    print(f"  waited {time.perf_counter() - t0:.1f} s for the {which!r} "
          "capture (synthesis, not timed)", flush=True)


def launch_wrappers() -> dict:
    """Each kernel's name -> (its wrapper, the wrapper's launch counter)."""
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import (correlator, filters,
                                                 nonlinear, pcps, resampler)
    from gnss_sim_receiver_tpu_torch.sim import device_generator
    return {
        "K1_block_correlate": (tb.block_correlate, "launches"),
        "K8a_block_prologue": (tb.block_prologue, "launches"),
        "K8b_block_closure": (tb.block_closure, "launches"),
        "K1_K8b_block_correlate_close": (tb.block_correlate_close,
                                         "launches"),
        "K1_K8b_K8a_block_step": (tb.block_correlate_close, "folds"),
        "K8a_block_prologue_E1_pilot": (tb.block_prologue, "launches_pilot"),
        "K1_K8b_block_correlate_close_E1_pilot": (tb.block_correlate_close,
                                                  "launches_pilot"),
        "K1_K8b_K8a_block_step_E1_pilot": (tb.block_correlate_close,
                                           "folds_pilot"),
        "K8a_block_prologue_bias": (tb.block_prologue, "launches_bias"),
        "K1_K8b_block_correlate_close_bias": (tb.block_correlate_close,
                                              "launches_bias"),
        "K1_K8b_K8a_block_step_bias": (tb.block_correlate_close,
                                       "folds_bias"),
        "block_chunks": (tb.track_chunk_blocks, "chunks"),
        "K9_epoch_closure": (trk.epoch_closure, "launches"),
        "K2_multicorrelate": (correlator.multicorrelate, "launches"),
        "K9_epoch_chunk": (trk.epoch_chunk, "launches"),
        "K9_epoch_chunk_epochs": (trk.epoch_chunk, "epochs"),
        "K9_epoch_chunk_kf": (trk.epoch_chunk, "launches_kf"),
        "K9_epoch_chunk_gaussian": (trk.epoch_chunk, "launches_gaussian"),
        "K9_epoch_chunk_pll2": (trk.epoch_chunk, "launches_pll2"),
        "K9_epoch_chunk_rectify": (trk.epoch_chunk, "launches_rectify"),
        "K9_epoch_chunk_bias": (trk.epoch_chunk, "launches_bias"),
        "K3_pcps_wipe": (pcps.pcps_wipe, "launches"),
        "K3_pcps_peak": (pcps.pcps_peak, "launches"),
        "K3b_pcps_wipe_per_channel": (pcps.pcps_wipe,
                                      "launches_per_channel"),
        "K4a_pcps_dual_peak": (pcps.pcps_dual_peak, "launches"),
        "K4b_quicksync_fold": (pcps.pcps_quicksync_fold, "launches"),
        "K4b_quicksync_resolve": (pcps.pcps_quicksync_resolve, "launches"),
        "K4c_pcps_caf_peak": (pcps.pcps_caf_peak, "launches"),
        "K3c_pcps_second_peak": (pcps.pcps_second_peak, "launches"),
        "K3c_pcps_second_peak_dual": (pcps.pcps_second_peak,
                                      "launches_dual"),
        "K3c_pcps_second_peak_caf": (pcps.pcps_second_peak, "launches_caf"),
        "K5a_fir_decim": (filters.fir_decim, "launches"),
        "K5b_notch_filter": (filters.notch_filter, "launches"),
        "K5c_pulse_blanking": (filters.pulse_blanking, "launches"),
        "K5d_direct_resampler": (resampler.direct_resampler, "launches"),
        "K5d_linear_resampler": (resampler.linear_resampler, "launches"),
        "K6_device_generator": (device_generator.expand, "launches"),
        "K3_pcps_rows": (pcps.pcps_rows, "launches"),
        "K7_pcps_window_fold": (pcps.pcps_window_fold, "launches"),
        "K10a_sigma_points": (nonlinear.sigma_points, "launches"),
        "K10b_sigma_moments": (nonlinear.sigma_moments, "launches")}


def reset(wrappers) -> None:
    """Set every launch counter to 0; `wrappers` maps a kernel's name to
    its wrapper and the wrapper's counter attribute."""
    for fn, attr in wrappers.values():
        setattr(fn, attr, 0)


def read_launches(wrappers, needed) -> dict:
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in wrappers.items()}
    print(f"  launches: {launches}")
    for name in needed:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on this path")
    return launches


def check_run(run, min_fixes: int) -> None:
    """The tracked set and, with `min_fixes`, the fixes and the mean
    position error against the scenario."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    tracked = sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                     if s == ChannelState.TRACKING)
    print(f"  tracked PRNs {tracked}, {len(run.ephemerides)} ephemerides, "
          f"{len(run.solutions)} fixes")
    if tracked != list(SCENARIO_PRNS):
        fail(f"tracked PRNs {tracked}, expected {list(SCENARIO_PRNS)}")
    if not min_fixes:
        return
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    rx_true = rx_true_ecef()
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true, ref)
                    for s in run.solutions]).reshape(-1, 3)
    if not np.isfinite(enu).all():
        fail("non-finite position")
    if len(run.solutions) < min_fixes:
        fail(f"only {len(run.solutions)} fixes")
    err_2d = float(np.linalg.norm(enu.mean(0)[:2]))
    err_3d = float(np.linalg.norm(enu.mean(0)))
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def check_block_chunk(root: str) -> None:
    """Phase 3, continued, once phase 4's capture is written: one chunk of
    50 blocks (1 s) of phase 4's GPS path, through the kernel path (K8a
    once, then per block the cuFFT and K1 with K8b and the next block's
    prologue), through the three-launch chunk (K8a, cuFFT, K1 with K8b per
    block) and through the plain block body (K1 through its kernel in
    each) on the card, from the same state: channels armed on the first
    1.5 s of the capture, conditioned by phase 4's conf, by that conf's
    own acquisition (PRNs 1-10, 8 channels).  The kernel path must equal
    the three-launch chunk bit for bit; against the plain body it prints
    whether the bits are equal and holds the active sets identical, the
    code boundary of every epoch (sample counter at the epoch end minus
    the replica's code phase, as the observables read it) within 1e-3
    chip, the Doppler within 0.5 Hz and the prompts within 1e-3 of their
    largest modulus."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingEngine
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    capture = capture_paths(root)["file"]
    config = InMemoryConfiguration(conf_properties(CONF.format(
        capture=capture)))
    rconf = receiver_conf_from_config(config)
    x = SignalConditioner(config, fs_in=FS_FILE).process(
        read_samples(capture, "ishort", count=int(1.5 * FS_FILE)))
    prns = tuple(range(1, 11))
    res = PcpsAcquisitionEngine(rconf.acq, prns).acquire_from(x, 0)
    found = [(p, float(d), int(res.samplestamp + dl))
             for p, ok, d, dl in zip(prns, res.detected, res.doppler_hz,
                                     res.delay_samples) if ok][:8]
    if [p for p, _, _ in found] != list(SCENARIO_PRNS):
        fail(f"50-block chunk: acquisition found {found}")
    conf = rconf.trk
    eng = TrackingEngine(conf, [p for p, _, _ in found] + [0, 0])
    for ch, (_, dop, start) in enumerate(found):
        eng.start_tracking(ch, dop, start)
    st = eng.state._replace(pos=torch.tensor(
        eng.abs_start.astype(np.int32), device=x.device))
    eng._ensure_block_tables()
    e_blk, n_blk = eng.block_epochs, 50
    args = (conf, n_blk, e_blk, eng._codes_rep, eng.taps)
    xf_all = tb._window_spectra(x, conf.nominal_epoch_samples,
                                tb.block_fft_size(conf))
    tb.track_chunk_blocks(*args, x, st)          # builds, plans the FFTs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_st, got = tb.track_chunk_blocks(*args, x, st)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_st, want = tb._chunk_plain(*args, xf_all, st)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    three_st, three = tb._chunk_cuda(*args, xf_all, st, fold=False)
    torch.cuda.synchronize()
    diff = differing(got_st, three_st, got, three)
    if diff:
        fail(f"50-block chunk: {diff} differ in bits from the three-launch "
             "chunk")
    plain_diff = differing(got_st, want_st, got, want)

    def boundary(o):
        end = (o["pos_start"] + o["n_samples"]).double()
        return ((end - o["code_phase_samples"].double())
                * o["code_freq_cps"].double() / conf.fs)     # chips
    valid = want["valid"]
    d_code = (boundary(got) - boundary(want))[valid].abs().max().item()
    d_dop = (got["carrier_doppler_hz"] - want["carrier_doppler_hz"]
             ).abs().max().item()
    d_prompt = ((got["prompt"] - want["prompt"]).abs().max()
                / want["prompt"].abs().max()).item()
    same = (torch.equal(got_st.active, want_st.active)
            and torch.equal(got["valid"], valid))
    print(f"  50-block chunk of phase 4's path (PRNs {list(SCENARIO_PRNS)} "
          f"armed by acquisition, 2 idle channels): active sets "
          f"{'identical' if same else 'DIFFERENT'}; code boundary within "
          f"{d_code:.2e} chip (tolerance 1e-3), Doppler within {d_dop:.3e} "
          f"Hz (0.5), prompts within {d_prompt:.2e} of the largest (1e-3); "
          "bit for bit the three-launch chunk's; against the plain body "
          + ("bit for bit" if not plain_diff else f"{plain_diff} differ"))
    print(f"  host time: kernel path {1e3 * t_k / n_blk:.3f} ms per block, "
          f"plain block body {1e3 * t_p / n_blk:.3f} ms per block")
    if not (same and d_code < 1e-3 and d_dop < 0.5 and d_prompt < 1e-3):
        fail("50-block chunk: the kernel path departs from the plain path")


BLOCK_STEP_KERNELS = ("K8a_block_prologue", "K1_K8b_block_correlate_close",
                      "K1_K8b_K8a_block_step")
# the standalone kernels that the fused ones replace on every path
STANDALONE_KERNELS = ("K2_multicorrelate", "K9_epoch_closure",
                      "K8b_block_closure")
EPOCH_KERNELS = ("K9_epoch_chunk",)


def check_block_launches(launches: dict, receiver_s: float) -> None:
    """K1 with K8b's closure fused ran once per block of the path (= K1's
    launches); K8a once per chunk (its first block) and the fold for every
    other block; the standalone K2, K9 and K8b never ran; the chunk tails
    ran the chunk kernel (its epochs counted beside its launches); the
    receiver's milliseconds per block."""
    k1 = launches["K1_block_correlate"]
    fused, k8a, folds = (launches[n] for n in (
        "K1_K8b_block_correlate_close", "K8a_block_prologue",
        "K1_K8b_K8a_block_step"))
    chunks = launches["block_chunks"]
    if (not k1 or fused != k1 or k8a != chunks or k8a + folds != k1
            or not chunks):
        fail(f"K1 with K8b fused ran {fused} times, K1 {k1}, K8a {k8a}, the "
             f"fold {folds}, in {chunks} chunks")
    if any(launches[n] for n in STANDALONE_KERNELS):
        fail(f"standalone kernels launched on a block path: {launches}")
    epochs = launches["K9_epoch_chunk_epochs"]
    ep_chunks = launches["K9_epoch_chunk"]
    if epochs < ep_chunks or (ep_chunks == 0) != (epochs == 0):
        fail(f"the chunk tails ran {ep_chunks} chunk launches of {epochs} "
             "epochs")
    print(f"  block step: {k1} blocks in {chunks} chunks: K1 with K8b fused "
          f"{fused} (= K1 launches), with the next prologue folded {folds}, "
          f"K8a {k8a} (= chunks); standalone K2, K9, K8b "
          f"0; receiver {1e3 * receiver_s / k1:.3f} ms per block; chunk "
          f"tails {epochs} epochs in {ep_chunks} launches of the chunk "
          "kernel")


BLOCK_PATH_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step",
                      "K9_epoch_chunk")
ACQUISITION_KERNELS = ("K3_pcps_wipe", "K3_pcps_peak")
MAIN_PATH_KERNELS = (BLOCK_PATH_KERNELS + ACQUISITION_KERNELS
                     + ("K3b_pcps_wipe_per_channel", "K5a_fir_decim"))


def main_path(root: str, wrappers) -> dict:
    """Phase 4: conf file -> ishort capture -> conditioner -> receiver ->
    position, through the port's CLI called in process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["file"]
    conf = os.path.join(root, "build", "chip_smoke_rx.conf")
    with open(conf, "w") as fh:
        fh.write(CONF.format(capture=capture))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ishort at "
          f"{FS_FILE / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, MAIN_PATH_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f} ({100 * sec['condition'] / wall:.1f} % of "
          f"the wall time), receiver {sec['receiver']:.3f}")
    check_block_launches(launches, sec["receiver"])
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f}")
    main_path.rtf = DUR / wall
    return launches


COND_KERNELS = ("K5a_fir_decim", "K5b_notch_filter", "K5c_pulse_blanking",
                "K5d_direct_resampler", "K5d_linear_resampler")


def conditioner_path(root: str, wrappers, notch_case) -> dict:
    """Phase 4b: SignalConditioner.process alone, once per configuration,
    on the first 4 M samples of the capture file (the notch: on the
    `notch_case` input of phase 3, whose sequential plain output is at
    hand).  Every K5 kernel must be launched through it, and every output
    is held against the plain versions composed on the same input."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.ops import filters, resampler
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    x = read_samples(capture_paths(root)["file"], "ishort",
                     count=COND_SAMPLES)
    xd = torch.from_numpy(x).cuda()
    x_notch, want_notch = notch_case
    taps = torch.from_numpy(filters.design_lowpass(31, 0.45)).cuda()
    # the output lengths as the conditioner computes them
    n_half = resampler.output_length(COND_SAMPLES, 1.0, 1.0 / (4e6 / 2e6))
    n_3m = resampler.output_length(COND_SAMPLES, 1.0, 1.0 / (4e6 / 3e6))
    # name: (conf keys, input, plain version of the chain, tolerance as in
    # phase 3; 0 means identical)
    configs = {
        "Notch_Filter": (
            {"InputFilter.implementation": "Notch_Filter",
             "InputFilter.f0_norm": str(NOTCH_F0),
             "InputFilter.bw_norm": str(NOTCH_BW)},
            x_notch.cpu().numpy(), lambda: want_notch, 1e-4),
        "Pulse_Blanking_Filter": (
            {"InputFilter.implementation": "Pulse_Blanking_Filter"},
            x, lambda: filters._blank_plain(xd, 4.0, 64), 0.0),
        "Fir_Filter + Direct_Resampler": (
            {"InputFilter.implementation": "Fir_Filter",
             "InputFilter.number_of_taps": "31",
             "Resampler.implementation": "Direct_Resampler",
             "Resampler.sample_freq_out": "2000000"},
            x, lambda: resampler._direct_plain(
                filters._fir_plain(xd, taps, 1), 2.0, n_half), 1e-5),
        "Mmse_Resampler": (
            {"Resampler.implementation": "Mmse_Resampler",
             "Resampler.sample_freq_out": "3000000"},
            x, lambda: resampler._linear_plain(
                xd, float(np.float32(4e6 / 3e6)), n_3m), 1e-6),
    }
    reset(wrappers)
    outputs = {}
    for name, (props, x_in, _, _) in configs.items():
        cond = SignalConditioner(InMemoryConfiguration(props), fs_in=FS_FILE)
        t0 = time.perf_counter()
        y = cond.process(x_in)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (y.is_cuda and y.dtype == torch.complex64):
            fail(f"conditioner {name}: output {y.device} {y.dtype}")
        print(f"  {name}: {len(x_in)} -> {len(y)} samples at "
              f"{cond.fs_out / 1e6:.3f} Msps, {dt:.3f} s with the upload")
        outputs[name] = y
    launches = read_launches(wrappers, COND_KERNELS)
    for name, (_, _, plain, rtol) in configs.items():
        want = plain()
        if rtol:
            compare(f"conditioner {name} against the plain chain",
                    outputs[name], want, rtol)
        elif not torch.equal(outputs[name], want):
            fail(f"conditioner {name}: differs from the plain chain")
        else:
            print(f"  conditioner {name} against the plain chain: identical "
                  f"({int((want == 0).sum())} samples blanked)")
    return launches


def direct_path(root: str, wrappers) -> dict:
    """Phase 4c: the array entry point, Receiver.process_array on a
    complex64 array at 2 Msps, 8 s of the scenario: long enough to acquire
    and track, too short for a fix."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    x = np.load(capture_paths(root)["direct"])
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = rx.process_array(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, BLOCK_PATH_KERNELS
                             + ACQUISITION_KERNELS)
    check_run(run, min_fixes=0)
    print(f"  wall {wall:.3f} s for {DIRECT_DUR:.0f} s of signal: real-time "
          f"factor {DIRECT_DUR / wall:.3f}")
    check_block_launches(launches, wall)
    return launches


HYBRID_KERNELS = ("K1_block_correlate", "K9_epoch_chunk", "K3_pcps_wipe",
                  "K3_pcps_peak", "K4a_pcps_dual_peak")


def mean_error(run) -> tuple[float, float]:
    """The 2D and 3D norms of the mean ENU error of a run's fixes."""
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true_ecef(), ref)
                    for s in run.solutions])
    if not np.isfinite(enu).all():
        fail("non-finite position")
    return (float(np.linalg.norm(enu.mean(0)[:2])),
            float(np.linalg.norm(enu.mean(0))))


# phase 8's GPS floor: the JAX receiver on a 4 Msps CPU cut of phase 8's
# scenario (GPS at extend_correlation_symbols=20, its default 15 Hz narrow
# PLL) loses GPS PRN 4 six times and ends with 3 of the 4 satellites tracked
# and decoded, and the port there does the same (ROADMAP.md queue 3); the
# phase holds the port to that result
PILOT_GPS_MIN = 3


def check_hybrid_run(run, gps_min: int = len(HYB_GPS_PRNS)) -> None:
    """Phase 5's checks (tests/test_hybrid_position.py:67-97): the tracked
    set of each system, the ephemerides decoded, the fixes and the mean
    position error.  With `gps_min` below 4, that many of the GPS
    satellites (tracked and decoded) will do."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    tracked = {"GPS": [], "Galileo": []}
    for p, st, sy in zip(run.channel_prns, run.channel_states,
                         run.channel_systems):
        if st == ChannelState.TRACKING:
            tracked[sy].append(p)
    gps_eph = sorted(k for k in run.ephemerides if isinstance(k, int))
    gal_eph = sorted(k[1] for k in run.ephemerides if isinstance(k, tuple))
    n_last = run.solutions[-1].n_sats if run.solutions else 0
    print(f"  tracked GPS {sorted(tracked['GPS'])}, Galileo "
          f"{sorted(tracked['Galileo'])}; ephemerides GPS {gps_eph}, "
          f"Galileo {gal_eph}; {len(run.solutions)} fixes, the last with "
          f"{n_last} satellites")
    def gps_ok(prns):
        return set(prns) <= set(HYB_GPS_PRNS) and len(prns) >= gps_min
    if not gps_ok(tracked["GPS"]) \
            or sorted(tracked["Galileo"]) != list(HYB_GAL_PRNS):
        fail(f"tracked {tracked}")
    if not gps_ok(gps_eph) or gal_eph != list(HYB_GAL_PRNS):
        fail(f"ephemerides GPS {gps_eph}, Galileo {gal_eph}")
    if len(run.solutions) < 5 or n_last < 7:
        fail(f"{len(run.solutions)} fixes, the last with {n_last} "
             "satellites")
    err_2d, err_3d = mean_error(run)
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def make_hybrid_capture(root: str, wrappers) -> dict:
    """Phase 5's capture: the 26 s hybrid scenario at 20 Msps (520 M
    samples) made on the card by the device generator (K6, seed 17 for the
    noise), quantized there and written as an ibyte file (1.04 GB), outside
    every timed window.  Returns K6's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)["hybrid"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = int(FS_REF_HYBRID * DUR)
    sats = hybrid_sats()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_REF_HYBRID, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    launches = read_launches(wrappers, ("K6_device_generator",))
    t0 = time.perf_counter()
    tmp = path + f".{os.getpid()}.tmp"
    write_samples(tmp, x, "ibyte", scale=HYB_BYTE_SCALE)
    os.replace(tmp, path)
    wrote = time.perf_counter() - t0
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites, "
          f"{8 * n / 1e9:.2f} GB on the card) in {gen:.3f} s; quantized on "
          f"the card and written as ibyte ({os.path.getsize(path) / 1e9:.2f} "
          f"GB) in {wrote:.3f} s (not timed)")
    del x
    torch.cuda.empty_cache()
    return launches


def hybrid_path(root: str, wrappers, card: str) -> dict:
    """Phase 5: the hybrid conf (GPS L1 C/A + Galileo E1-B, 10 + 10
    channels, CCCWSR on E1) at 20 Msps -> the 26 s ibyte capture ->
    receiver -> a joint position, through the port's CLI called in
    process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["hybrid"]
    conf = os.path.join(root, "build", "chip_smoke_hybrid.conf")
    with open(conf, "w") as fh:
        fh.write(HYBRID_CONF.format(capture=capture, fs=int(FS_REF_HYBRID)))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ibyte at "
          f"{FS_REF_HYBRID / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, HYBRID_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_hybrid_run(res.run)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} "
          f"({card})")
    check_block_launches(launches, sec["receiver"])
    return launches


def hybrid_acquisition(root: str, wrappers, impl: str = "8ms",
                       keys: dict | None = None) -> dict:
    """Phases 5b and 5c: the E1 chain's acquisition engine of phase 5's conf
    with Galileo_E1_PCPS_<impl>_Ambiguous_Acquisition and the conf `keys`,
    on the first second of the hybrid capture resident on the card (a
    window that starts off the 128-sample grid), PRNs 11-20.  PRNs 11-15
    must be detected, the detections must equal those of the plain
    version (the JAX-form grid materialised, then its statistic: CFAR, or
    first-vs-second with use_CFAR_algorithm=false) and each channel's
    (Doppler, delay) must equal its, the statistic to 1e-4 of it."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    chain = hybrid_chain(FS_REF_HYBRID, impl, keys)
    acq = chain.acq
    x = torch.from_numpy(read_samples(capture_paths(root)["hybrid"],
                                      "ibyte",
                                      count=int(FS_REF_HYBRID))).cuda()
    prns = tuple(range(11, 21))
    eng = PcpsAcquisitionEngine(
        acq, prns, code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, code_provider2=chain.data_code_provider)
    start = 100_003
    stat_kernel = ("K4a_pcps_dual_peak" if acq.use_cfar_algorithm
                   else "K3c_pcps_second_peak_dual")
    reset(wrappers)
    torch.cuda.synchronize()
    res = eng.acquire_from(x, start)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, (stat_kernel,))
    found = [p for p, d in zip(prns, res.detected) if d]
    print(f"  {impl} acquisition at sample {start}: detected PRNs {found} "
          f"(threshold {res.threshold:.2f}), statistic "
          f"{np.round(res.test_stat, 3).tolist()}, Doppler "
          f"{res.doppler_hz[:5].tolist()} Hz, delay "
          f"{res.delay_samples[:5].tolist()}")
    if not set(HYB_GAL_PRNS) <= set(found):
        fail(f"{impl} acquisition detected {found}")
    m, n = acq.max_dwells, eng.fft_size
    x_dw = x[start:start + eng.n_samples_needed].reshape(m, -1)
    if acq.variant == "8ms":
        grid = pcps.pcps_8ms_grid(x_dw, eng.code_fft_conj, eng.dopplers,
                                  FS_REF_HYBRID)
    else:
        grid = pcps.pcps_cccwsr_grid(x_dw, eng.code2_fft_conj,
                                     eng.code_fft_conj, eng.dopplers,
                                     FS_REF_HYBRID)
    if acq.use_cfar_algorithm:
        stat, di, de = pcps.max_to_input_power_stat(grid, float(2 * m))
    else:
        stat, di, de = pcps.first_vs_second_peak_stat(grid,
                                                      eng.samples_per_chip)
    del grid
    want_dop = eng.dopplers[di.long()].double().cpu().numpy()
    want_del = np.mod(de.double().cpu().numpy(), eng.n_coherent)
    want_stat = stat.double().cpu().numpy()
    if not (np.array_equal(res.detected, want_stat > res.threshold)
            and np.array_equal(res.doppler_hz, want_dop)
            and np.array_equal(res.delay_samples, want_del)):
        fail(f"{impl} acquisition against its plain version: Doppler "
             f"{res.doppler_hz} vs {want_dop}, delay {res.delay_samples} vs "
             f"{want_del}, statistic {res.test_stat} vs {want_stat}")
    rel = np.abs(res.test_stat - want_stat) / np.abs(want_stat)
    print(f"  against the plain version: detections, Doppler and delay "
          f"identical, statistic within {rel.max():.2e} (tolerance 1e-4)")
    if rel.max() > 1e-4:
        fail(f"{impl} acquisition statistic differs from the plain version")
    torch.cuda.empty_cache()
    return launches


QUICKSYNC_KERNELS = ("K4b_quicksync_fold", "K4b_quicksync_resolve",
                     "K3_pcps_peak", "K1_block_correlate", "K5a_fir_decim")


def quicksync_path(root: str, wrappers) -> dict:
    """Phase 4d, first half: phase 4's conf with
    GPS_L1_CA_PCPS_QuickSync_Acquisition (folding_factor=4) and phase 4's
    capture through the CLI to a position; the same checks as phase 4."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    conf = os.path.join(root, "build", "chip_smoke_quicksync.conf")
    with open(conf, "w") as fh:
        fh.write(QUICKSYNC_CONF.format(capture=capture_paths(root)["file"]))
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, QUICKSYNC_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}; "
          f"real-time factor {DUR / wall:.3f}")
    check_block_launches(launches, sec["receiver"])
    return launches


# the acquisition tail's conf keys (phases 4e and 5c): the first-vs-second-
# peak statistic against a fixed threshold, at which the JAX receiver
# acquires exactly the static scenario's PRNs (tests/test_torch_acq_tail.py
# THRESHOLD); and the doubled FFT of bit_transition_flag
RATIO_THRESHOLD = 2.5


def ratio_props(sig: str) -> dict:
    return {f"Acquisition_{sig}.use_CFAR_algorithm": "false",
            f"Acquisition_{sig}.pfa": "0",
            f"Acquisition_{sig}.threshold": str(RATIO_THRESHOLD)}


BIT_PROPS = {"Acquisition_1C.bit_transition_flag": "true"}
# phase 4d's engines under the CFAR statistic, and phase 4e's: the ratio,
# the doubled FFT, both; (label, conf keys, what Tong and Fine Doppler
# detect: "exact" the scenario's PRNs, "any" whatever the plain run
# detects).  The fixed threshold is sized for two-dwell searches: Tong's
# single 1 ms dwells can put a present satellite's ratio under it (PRN 3
# on phase 4's capture, in the kernel run and the plain run alike).  That
# JAX does the same is inferred from tests/test_torch_acq_tail.py, which
# holds the port's Tong to JAX's under the ratio on its own capture; JAX
# is not run on this one.  With
# the ratio and the doubled FFT the peak repeats one code period later and
# the ratio stays near 1 (acquisition.py:45-48) unless a bit edge cuts one
# of the two periods
CFAR_CASES = (("CFAR", {}, dict(tong="exact", fine_doppler="exact")),)
TAIL_CASES = (("first vs second", ratio_props("1C"),
               dict(tong="any", fine_doppler="exact")),
              ("CFAR, bit_transition_flag", BIT_PROPS,
               dict(tong="exact", fine_doppler="exact")),
              ("first vs second, bit_transition_flag",
               {**ratio_props("1C"), **BIT_PROPS},
               dict(tong="any", fine_doppler="any")))


def tong_fine_doppler(root: str, wrappers, cases=CFAR_CASES) -> None:
    """Phase 4d, second half (and phase 4e's with TAIL_CASES): the
    acquisition engines that the factory builds from phase 4's conf with
    GPS_L1_CA_PCPS_Tong_Acquisition and
    GPS_L1_CA_PCPS_Acquisition_Fine_Doppler and each case's keys, PRNs
    1-10, on the 2 Msps capture resident on the card (a window off the
    128-sample grid).  The scenario's PRNs must be detected as the case
    says; every result must equal the same engine's plain run on the same
    samples (detections identical, Doppler and delay identical where
    detected and on the scenario's PRNs, the statistic to 1e-4 on every
    channel)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    x = torch.from_numpy(np.load(capture_paths(root)["direct"])[: int(FS)]
                         ).cuda()
    prns = tuple(range(1, 11))
    start = 100_003
    for label, keys, expect in cases:
        for impl in ("GPS_L1_CA_PCPS_Tong_Acquisition",
                     "GPS_L1_CA_PCPS_Acquisition_Fine_Doppler"):
            props = conf_properties(CONF.format(capture=""))
            props["Acquisition_1C.implementation"] = impl
            props.update(keys)
            acq = receiver_conf_from_config(InMemoryConfiguration(props)).acq
            eng = PcpsAcquisitionEngine(acq, prns)
            stat_kernel = ("K3_pcps_peak" if acq.use_cfar_algorithm
                           else "K3c_pcps_second_peak")
            needed = ("K3_pcps_wipe", stat_kernel) + (
                ("K3b_pcps_wipe_per_channel", "K3_pcps_peak")
                if acq.variant == "fine_doppler" else ())
            reset(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.acquire_from(x, start)
            dt = time.perf_counter() - t0
            print(f"  {impl} ({label}; threshold {res.threshold:.3f}):")
            read_launches(wrappers, needed)
            want = PcpsAcquisitionEngine(acq, prns, device="cpu"
                                         ).acquire_from(x.cpu(), start)
            found = [p for p, d in zip(prns, res.detected) if d]
            print(f"  detected PRNs {found} in {dt * 1e3:.1f} ms (one pull);"
                  f" statistic {np.round(res.test_stat, 3).tolist()}")
            if expect[acq.variant] == "exact" \
                    and found != list(SCENARIO_PRNS):
                fail(f"{impl} ({label}) detected {found}")
            det = want.detected | np.isin(prns, SCENARIO_PRNS)
            if not (np.array_equal(res.detected, want.detected)
                    and np.array_equal(res.doppler_hz[det],
                                       want.doppler_hz[det])
                    and np.array_equal(res.delay_samples[det],
                                       want.delay_samples[det])):
                fail(f"{impl} ({label}) against its plain run: {res} vs "
                     f"{want}")
            rel = np.abs(res.test_stat - want.test_stat) / want.test_stat
            print(f"  against the plain run: detections, Doppler and delay "
                  f"identical, statistic within {rel.max():.2e} (tolerance "
                  f"1e-4)")
            if rel.max() > 1e-4:
                fail(f"{impl} ({label}): statistic differs from the plain "
                     "run")


RATIO_CONF = CONF.replace(
    "Acquisition_1C.pfa=0.01\n",
    "".join(f"{k}={v}\n" for k, v in ratio_props("1C").items()))
RATIO_KERNELS = ("K3c_pcps_second_peak", "K3_pcps_wipe", "K3_pcps_peak",
                 "K3b_pcps_wipe_per_channel", "K1_block_correlate",
                 "K5a_fir_decim")


def ratio_path(root: str, wrappers) -> dict:
    """Phase 4e, first part: phase 4's conf with use_CFAR_algorithm=false,
    pfa=0 and threshold=RATIO_THRESHOLD and phase 4's capture through the
    CLI to a position; phase 4's checks.  Every coarse search takes K3c
    (its launches = the coarse wipeoffs), every narrow grid K3's peak
    kernel (= the narrow wipeoffs)."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    conf = os.path.join(root, "build", "chip_smoke_ratio.conf")
    with open(conf, "w") as fh:
        fh.write(RATIO_CONF.format(capture=capture_paths(root)["file"]))
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, RATIO_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    k3c, coarse = launches["K3c_pcps_second_peak"], launches["K3_pcps_wipe"]
    peak = launches["K3_pcps_peak"]
    narrow = launches["K3b_pcps_wipe_per_channel"]
    print(f"  acquisition: {coarse} coarse searches through K3c ({k3c}), "
          f"{narrow} narrow grids through K3's peak kernel ({peak})")
    if k3c != coarse or peak != narrow:
        fail("K3c and K3's peak kernel do not take the coarse and the narrow "
             "searches one each")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}; "
          f"real-time factor {DUR / wall:.3f}")
    check_block_launches(launches, sec["receiver"])
    return launches


ROC_KERNELS = ("K3_pcps_wipe", "K3_pcps_peak", "K3c_pcps_second_peak")


def roc_path(wrappers) -> dict:
    """Phase 4f: the ROC harness (models/acq_performance.py) at
    tests/test_acq_performance.py's size and seeds, its bounds asserted:
    sweep over 30, 40, 45 dB-Hz (Pfa 0.05, 384 trials), the dwell-gain
    pair at 38 dB-Hz (1 and 2 dwells), then one _trial_stats of 384 trials
    under the first-vs-second-peak statistic, held against the plain
    statistic of the same trials.  Each sweep's seconds printed."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import acq_performance as perf
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    reset(wrappers)
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out
    pfa_hat, pd, thr = timed("roc", lambda: perf.sweep(
        cn0_db_hz=(30.0, 40.0, 45.0), pfa=0.05, n_trials=384, seed=2))
    print(f"  ROC sweep (384 trials, Pfa 0.05, threshold {thr:.3f}): "
          f"pfa_hat {pfa_hat:.4f}, pd {pd} in {secs['roc']:.3f} s")
    if not (0.002 <= pfa_hat <= 0.075 and pd[30.0] <= 0.2
            and pd[45.0] >= 0.95 and pd[30.0] <= pd[40.0] <= pd[45.0]):
        fail(f"ROC sweep outside tests/test_acq_performance.py's bounds: "
             f"{pfa_hat}, {pd}")
    _, pd1, _ = timed("dwells 1", lambda: perf.sweep(
        cn0_db_hz=(38.0,), pfa=0.01, n_trials=384, max_dwells=1, seed=5))
    _, pd2, _ = timed("dwells 2", lambda: perf.sweep(
        cn0_db_hz=(38.0,), pfa=0.01, n_trials=384, max_dwells=2, seed=5))
    print(f"  dwell gain at 38 dB-Hz: pd {pd1[38.0]:.4f} (1 dwell, "
          f"{secs['dwells 1']:.3f} s), {pd2[38.0]:.4f} (2 dwells, "
          f"{secs['dwells 2']:.3f} s)")
    if not (pd2[38.0] >= pd1[38.0]
            and (pd2[38.0] - pd1[38.0] > 0.05 or pd1[38.0] > 0.9)):
        fail(f"dwell gain outside tests/test_acq_performance.py's bounds: "
             f"{pd1}, {pd2}")
    dev = torch.device("cuda")
    n, t_n = 2000, 384
    code = prn_codes.sample_code(prn_codes.gps_l1_ca_code(1), FS, 1.023e6, n)
    code_t = torch.from_numpy(code.astype(np.float32)).to(dev)
    cfc = torch.from_numpy(np.conj(np.fft.fft(code))[None].astype(
        np.complex64)).to(dev)
    dops = torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev)
    amp = float(np.sqrt(2.0 * 10.0 ** 4.0 / FS))            # 40 dB-Hz
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    stat = timed("ratio trials", lambda: perf._trial_stats(
        gen, code_t, cfc, dops, amp, 1375.0, 700, n, t_n, FS, False, 2, 1))
    launches = read_launches(wrappers, ROC_KERNELS)

    def plain(x):
        """The same statistic through the plain versions: the wipeoff, the
        grid materialised, first_vs_second_peak_stat."""
        corr = torch.fft.ifft(torch.fft.fft(pcps._wipe_plain(
            x.reshape(t_n, n), dops, pcps.time_axis(n, FS, dev)), dim=-1)
            * cfc[0], dim=-1).reshape(1, t_n, len(dops), n)
        return pcps.first_vs_second_peak_stat(pcps._plain_grid(corr), 2)[0]
    gen.manual_seed(7)
    x = perf.trial_signal(gen, code_t, amp, 1375.0, 700, n, t_n, FS, 1)
    compare("4f _trial_stats (first vs second, 384 trials) against the "
            "plain statistic", stat, plain(x), 1e-4)
    # warm, host-timed to the synchronize: one batch through the kernels
    # (the noise drawn too) and the plain statistic of the same batch
    timed("ratio trials warm", lambda: perf._trial_stats(
        gen, code_t, cfc, dops, amp, 1375.0, 700, n, t_n, FS, False, 2, 1))
    timed("ratio trials plain", lambda: plain(x))
    print(f"  _trial_stats (first vs second, 40 dB-Hz, 384 trials) in "
          f"{secs['ratio trials'] * 1e3:.1f} ms (first at its shape), "
          f"{secs['ratio trials warm'] * 1e3:.3f} ms warm, the plain "
          f"statistic of the batch {secs['ratio trials plain'] * 1e3:.3f} "
          f"ms: median ratio {float(stat.median()):.3f}, "
          f"{int((stat > RATIO_THRESHOLD).sum())} of {t_n} above "
          f"{RATIO_THRESHOLD}")
    print(f"  seconds: {json.dumps(secs)}")
    return dict(launches=launches, seconds=secs)


def hybrid_witness() -> None:
    """--witness: what moves phase 5's position error.  The hybrid conf's
    receiver (`Receiver.process_array` on a card tensor, as the CLI runs
    it after its pass-through conditioner) on variants of phase 5's
    capture that differ in one thing each: the same K6 capture (seed 17)
    quantized as ibyte (phase 5's samples) or left in float32; other noise
    seeds; the rate (4 Msps); and the host simulator's band-limited chips
    (seed 17, 4 Msps, the capture of the earlier 4 Msps phase 5).  Prints
    the tracked count, fixes and mean 2D/3D error of each; checks nothing."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.factory import make_receiver
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import \
        quantize_interleaved

    def k6(fs, seed):
        return generate_baseband_device_resident(
            hybrid_sats(), fs, int(fs * DUR), noise=True, seed=seed)

    def ibyte(x):
        q = quantize_interleaved(x, "ibyte", HYB_BYTE_SCALE)
        return torch.view_as_complex(q.view(-1, 2).float())

    def host4():
        return torch.from_numpy(
            synthesize_hybrid(FS_FILE, int(FS_FILE * DUR))).cuda()
    hi, lo = FS_REF_HYBRID, FS_FILE
    cases = [("K6, ibyte", hi, 17, lambda: ibyte(k6(hi, 17))),
             ("K6, float32", hi, 17, lambda: k6(hi, 17)),
             ("K6, float32", hi, 18, lambda: k6(hi, 18)),
             ("K6, float32", hi, 19, lambda: k6(hi, 19)),
             ("K6, float32", lo, 17, lambda: k6(lo, 17)),
             ("K6, float32", lo, 18, lambda: k6(lo, 18)),
             ("host band-limited, float32", lo, 17, host4)]
    for what, fs, seed, make in cases:
        props = conf_properties(HYBRID_CONF.format(capture="", fs=int(fs)))
        rx = make_receiver(InMemoryConfiguration(props))
        x = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = rx.process_array(x)
        wall = time.perf_counter() - t0
        n_trk = sum(1 for st in run.channel_states
                    if st == ChannelState.TRACKING)
        e2, e3 = mean_error(run) if run.solutions else (float("nan"),) * 2
        print(f"  witness {what} at {fs / 1e6:g} Msps, seed {seed}: "
              f"{n_trk} tracked, {len(run.solutions)} fixes, mean error 2D "
              f"{e2:.3f} m, 3D {e3:.3f} m (receiver {wall:.1f} s)",
              flush=True)
        del x, rx, run
        torch.cuda.empty_cache()


FULL_CHAIN_KERNELS = ("K1_block_correlate", "K9_epoch_chunk",
                      "K3_pcps_wipe", "K3_pcps_peak")


def full_chain(wrappers, card: str) -> dict:
    """Phase 6: bench.py:_bench_full_chain's scenario made on the card by
    the device generator (K6) and kept there, through
    Receiver.process_array once.  All 12 PRNs tracked, >= 5 fixes, 3D < 5 m
    (the mean over the fixes from the 6th on, as bench.py reports it)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    sats = full_chain_sats()
    n = int(FS * FULL_DUR)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS, n, noise=True, seed=3)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites) on "
          f"the card in {gen:.3f} s")
    rx = Receiver(ReceiverConf(fs=FS, prns=FULL_PRNS, max_channels=12,
                               max_acq_channels=12, pvt_rate_ms=500))
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = rx.process_array(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, FULL_CHAIN_KERNELS)
    tracked = sorted(p for p, st in zip(run.channel_prns, run.channel_states)
                     if st == ChannelState.TRACKING)
    rx_true = rx_true_ecef()
    n_fix = len(run.solutions)
    err = float("nan")
    if n_fix > 5:
        pos = np.mean([s.rx_ecef_m for s in run.solutions[5:]], axis=0)
        err = float(np.linalg.norm(pos - rx_true))
    print(f"  tracked PRNs {tracked}, {len(run.ephemerides)} ephemerides, "
          f"{n_fix} fixes; mean position error (fixes 6 on) {err:.3f} m")
    print(f"  receiver wall {wall:.3f} s for {FULL_DUR:.0f} s of signal: "
          f"real-time factor {FULL_DUR / wall:.3f} ({card})")
    check_block_launches(launches, wall)
    if tracked != list(FULL_PRNS):
        fail(f"tracked PRNs {tracked}, expected {list(FULL_PRNS)}")
    if n_fix < 5 or not err < 5.0:
        fail(f"{n_fix} fixes, mean position error {err:.3f} m")
    if "--profile" in sys.argv[1:]:
        print("== profile of the full chain", flush=True)

        def again():
            t0 = time.perf_counter()
            rx.process_array(x)
            torch.cuda.synchronize()
            return f"receiver wall {time.perf_counter() - t0:.3f} s"
        profile_path(again)
    del x
    torch.cuda.empty_cache()
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


WIDEBAND_KERNELS = ("K1_block_correlate", "K9_epoch_chunk",
                    "K3_pcps_wipe", "K3_pcps_peak",
                    "K3b_pcps_wipe_per_channel", "K4c_pcps_caf_peak")


def make_wideband_capture(root: str, wrappers) -> dict:
    """Phase 7's capture: the 60 s wideband scenario at 20 Msps (1.2 G
    samples, 9.6 GB on the card) made by the device generator (K6, seed 17
    for the noise), quantized there and written as an ibyte file (2.4 GB),
    outside every timed window.  Returns K6's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = capture_paths(root)["wideband"]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    n = int(FS_WIDEBAND * WB_DUR)
    sats = wideband_sats()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_WIDEBAND, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    launches = read_launches(wrappers, ("K6_device_generator",))
    t0 = time.perf_counter()
    tmp = path + f".{os.getpid()}.tmp"
    write_samples(tmp, x, "ibyte", scale=HYB_BYTE_SCALE)
    os.replace(tmp, path)
    wrote = time.perf_counter() - t0
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} satellites, "
          f"{8 * n / 1e9:.2f} GB on the card) in {gen:.3f} s; quantized on "
          f"the card and written as ibyte ({os.path.getsize(path) / 1e9:.2f} "
          f"GB) in {wrote:.3f} s (not timed)")
    del x
    torch.cuda.empty_cache()
    return launches


def check_wideband_run(run) -> None:
    """Phase 7's checks: the tracked set of each system, 4 CNAV and 5 F/NAV
    ephemerides, >= 5 fixes with the last on >= 7 satellites, and the mean
    position error (2D < 2 m, 3D < 5 m, the thresholds of phase 5)."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    tracked = {"GPS": [], "Galileo": []}
    for p, st, sy in zip(run.channel_prns, run.channel_states,
                         run.channel_systems):
        if st == ChannelState.TRACKING:
            tracked[sy].append(p)
    gps_eph = sorted(k for k in run.ephemerides if isinstance(k, int))
    gal_eph = sorted(k[1] for k in run.ephemerides if isinstance(k, tuple))
    n_last = run.solutions[-1].n_sats if run.solutions else 0
    print(f"  tracked GPS L5 {sorted(tracked['GPS'])}, Galileo E5a "
          f"{sorted(tracked['Galileo'])}; CNAV ephemerides {gps_eph}, F/NAV "
          f"ephemerides {gal_eph}; {len(run.solutions)} fixes, the last with "
          f"{n_last} satellites")
    if sorted(tracked["GPS"]) != list(HYB_GPS_PRNS) \
            or sorted(tracked["Galileo"]) != list(HYB_GAL_PRNS):
        fail(f"tracked {tracked}")
    if gps_eph != list(HYB_GPS_PRNS) or gal_eph != list(HYB_GAL_PRNS):
        fail(f"ephemerides GPS {gps_eph}, Galileo {gal_eph}")
    if len(run.solutions) < 5 or n_last < 7:
        fail(f"{len(run.solutions)} fixes, the last with {n_last} "
             "satellites")
    err_2d, err_3d = mean_error(run)
    print(f"  mean error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


def wideband_path(root: str, wrappers, card: str) -> dict:
    """Phase 7: the wideband conf (GPS L5I + Galileo E5a, 10 + 10
    channels, the E5a I/Q search with its CAF boxcar) at 20 Msps -> the
    60 s ibyte capture -> receiver -> a joint position, through the port's
    CLI called in process."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["wideband"]
    conf = os.path.join(root, "build", "chip_smoke_wideband.conf")
    with open(conf, "w") as fh:
        fh.write(WIDEBAND_CONF.format(capture=capture, fs=int(FS_WIDEBAND)))
    print(f"  capture: {os.path.getsize(capture) / 1e6:.0f} MB ibyte at "
          f"{FS_WIDEBAND / 1e6:.0f} Msps; conf: {conf}")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, WIDEBAND_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_wideband_run(res.run)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{WB_DUR:.0f} s of signal: real-time factor {WB_DUR / wall:.3f} "
          f"({card})")
    check_block_launches(launches, sec["receiver"])
    if "--profile" in sys.argv[1:]:
        argv = [f"--config_file={conf}"]
        print("== profile of the wideband path", flush=True)
        profile_path(lambda: f"seconds {run_cli(argv).seconds}")
    return launches


def pilot_receiver_conf(fs: float = FS_REF_HYBRID, gps_extend: int = 20,
                        e1_extend: int = 5):
    """Phase 8's receiver: phase 5's conf (GPS acquisition, observables,
    PVT.output_rate_ms=20) with GPS tracking at extend_correlation_symbols
    20 and, in place of its E1-B chain, galileo_e1b_chain(fs,
    n_channels=10, track_pilot=True, extend_correlation_symbols=5) with
    phase 5's E1 tracking keys (very-early-late 0.6 chips, PLL 15 Hz) and
    the chain's own two-step PCPS acquisition.  Phase 8c's: both chains at
    extend_correlation_symbols 1 (`gps_extend`, `e1_extend`), where both
    close on the block kernels, the E1 chain on their pilot form."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e1b_chain
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    rconf = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        HYBRID_CONF.format(capture="", fs=int(fs)))))
    (e1,) = rconf.chains
    pilot = galileo_e1b_chain(
        fs, n_channels=e1.n_channels, track_pilot=True,
        extend_correlation_symbols=e1_extend,
        very_early_late_space_chips=e1.trk.very_early_late_space_chips,
        pll_bw_hz=e1.trk.pll_bw_hz)
    return dataclasses.replace(
        rconf, trk=dataclasses.replace(
            rconf.trk, extend_correlation_symbols=gps_extend),
        chains=(pilot,))


def check_epoch_chunk(dev) -> None:
    """Phase 3, continued: one 50-epoch chunk of phase 8's E1 pilot chain
    (10 channels, PRNs 11-20) through the chunk kernel and through the
    plain loop (K2 through its kernel) on the card, from the same state: the
    channels that the chain's own acquisition finds on the first 0.3 s of
    phase 8's scenario (made by K6) armed there.  Planes and states must
    be identical; if not, the code boundary of every epoch within 1e-3
    chip, the Doppler within 0.5 Hz and the prompts within 1e-3 of their
    largest modulus.  Prints the host time per epoch of both."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    chain = pilot_receiver_conf().chains[0]
    conf = chain.trk
    x = generate_baseband_device_resident(
        pilot_sats(), FS_REF_HYBRID, int(0.3 * FS_REF_HYBRID), noise=True,
        seed=17, device=dev)
    prns = tuple(range(11, 21))
    res = PcpsAcquisitionEngine(
        chain.acq, prns, code_provider=chain.code_provider,
        sc_rate=chain.sc_rate, device=dev).acquire_from(x, 0)
    found = [p for p, ok in zip(prns, res.detected) if ok]
    if found != list(HYB_GAL_PRNS):
        fail(f"50-epoch chunk: acquisition found {found}")
    eng = trk.TrackingEngine(conf, prns, code_provider=chain.code_provider,
                             data_code_provider=chain.data_code_provider,
                             device=dev)
    for ch, ok in enumerate(res.detected):
        if ok:
            eng.start_tracking(ch, float(res.doppler_hz[ch]),
                               int(res.samplestamp + res.delay_samples[ch]))
    st = eng.state._replace(pos=torch.tensor(
        eng.abs_start.astype(np.int32), device=dev))
    n_ep = 50
    args = (conf, n_ep, eng.codes, eng.taps, x, st, eng.data_codes)
    trk.track_chunk(*args)                    # builds the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_st, got = trk.track_chunk(*args)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_st, want = trk._chunk_plain(*args)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    gs = interop.track_state_to_numpy(got_st)
    ws = interop.track_state_to_numpy(want_st)
    same = (all(torch.equal(got[k], want[k]) for k in want)
            and all(np.array_equal(gs[k], ws[k]) for k in ws))
    valid = want["valid"]

    def boundary(o):
        end = (o["pos_start"] + o["n_samples"]).double()
        return ((end - o["code_phase_samples"].double())
                * o["code_freq_cps"].double() / conf.fs)
    d_code = (boundary(got) - boundary(want))[valid].abs().max().item()
    d_dop = (got["carrier_doppler_hz"] - want["carrier_doppler_hz"]
             ).abs().max().item()
    d_prompt = ((got["prompt"] - want["prompt"]).abs().max()
                / want["prompt"].abs().max()).item()
    print(f"  50-epoch chunk of phase 8's E1 pilot chain (PRNs {found} armed "
          f"by acquisition, {len(prns) - len(found)} idle channels): planes "
          f"and states {'identical' if same else 'NOT identical'}; code "
          f"boundary within {d_code:.2e} chip (1e-3), Doppler within "
          f"{d_dop:.3e} Hz (0.5), prompts within {d_prompt:.2e} (1e-3); "
          f"sec_synced {gs['sec_synced'].tolist()}")
    print(f"  host time: the chunk kernel {1e3 * t_k / n_ep:.4f} ms per "
          f"epoch, plain loop {1e3 * t_p / n_ep:.3f} ms per epoch")
    if not (same or (torch.equal(got["valid"], valid) and d_code < 1e-3
                     and d_dop < 0.5 and d_prompt < 1e-3)):
        fail("50-epoch chunk: the kernel path departs from the plain loop")


UNUSED_ON_EPOCH_PATHS = ("K1_block_correlate", *BLOCK_STEP_KERNELS,
                         *STANDALONE_KERNELS)


def check_epoch_launches(launches: dict, epochs: int, receiver_s: float):
    """The chunk kernel ran the path's epochs (`epochs`, when not None),
    one launch per chunk; the standalone K2, K9 and K8b and the block
    kernels never."""
    chunks, ran = launches["K9_epoch_chunk"], launches["K9_epoch_chunk_epochs"]
    if not chunks or ran < chunks or (epochs is not None and ran != epochs):
        fail(f"the chunk kernel ran {chunks} launches of {ran} epochs, "
             f"{epochs} epochs run")
    if any(launches[n] for n in UNUSED_ON_EPOCH_PATHS):
        fail(f"other tracking kernels launched on a per-epoch path: "
             f"{launches}")
    print(f"  per-epoch path: {ran} epochs in {chunks} launches of the chunk "
          f"kernel ({ran / chunks:.1f} epochs a launch; K2, K9, K1, K8a, "
          f"K8b 0), receiver {1e3 * receiver_s / ran:.4f} ms per epoch")


def check_pilot_states(session) -> None:
    """Every tracking GPS channel bit-synced and every tracking Galileo
    channel secondary-synced, each in extended mode with its symbol count
    inside the group and the counts cycling (not all equal) per chain."""
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    for rt in session.chains:
        st = rt.trk.state
        k = rt.spec.trk.extend_correlation_symbols
        chans = [c for c in range(rt.spec.n_channels)
                 if rt.mgr.channels[c].state == ChannelState.TRACKING]
        flag = "sec_synced" if rt.spec.trk.secondary_code else "bit_synced"
        synced = getattr(st, flag).cpu().numpy()[chans]
        ext_n = st.ext_n.cpu().numpy()[chans]
        print(f"  {rt.spec.signal} chain: {flag} {synced.tolist()}, ext_n "
              f"{ext_n.tolist()} (groups of {k})")
        if not synced.all() or not ((0 <= ext_n) & (ext_n < k)).all() \
                or len(set(ext_n.tolist())) < 2:
            fail(f"{rt.spec.signal} chain: {flag} {synced}, ext_n {ext_n}")


def pilot_path(wrappers, card: str, then=None) -> dict:
    """Phase 8: phase 8's scenario (phase 5's, each Galileo satellite with
    E1-B and E1-C) made on the card by K6 for 26 s at 20 Msps and kept
    there, through the array entry point's session (ReceiverSession,
    attach_array, run_to_end, result: Receiver.process_array's body, kept
    to read the engines' states after) with pilot_receiver_conf: the
    tracked sets, ephemerides (I/NAV from the data prompt), fixes and mean
    position error as phase 5 (GPS held to PILOT_GPS_MIN), every tracking
    channel synced, and K2 and K9 once per epoch of the two chains.  With
    `then`, then(x, run) runs on the same capture before it is freed (phase
    8c); its result is returned under "then"."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.receiver import ReceiverSession
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    sats = pilot_sats()
    n = int(FS_REF_HYBRID * DUR)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_REF_HYBRID, n, noise=True,
                                          seed=17)
    torch.cuda.synchronize()
    gen = time.perf_counter() - t0
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made {n / 1e6:.0f} M samples ({len(sats)} signals) on the "
          f"card in {gen:.3f} s (not timed)")
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = ReceiverSession(pilot_receiver_conf())
    session.attach_array(x)
    session.run_to_end()
    run = session.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, EPOCH_KERNELS + (
        "K3_pcps_wipe", "K3_pcps_peak", "K3b_pcps_wipe_per_channel"))
    check_hybrid_run(run, gps_min=PILOT_GPS_MIN)
    check_pilot_states(session)
    epochs = {rt.spec.signal: rt.trk.epochs_dispatched
              for rt in session.chains}
    chunks = {rt.spec.signal: rt.trk._dispatch_seq for rt in session.chains}
    print(f"  epochs run: {epochs}; chunks dispatched: {chunks}")
    check_epoch_launches(launches, sum(epochs.values()), wall)
    if sum(chunks.values()) != launches["K9_epoch_chunk"]:
        fail(f"{chunks} chunks dispatched, the chunk kernel launched "
             f"{launches['K9_epoch_chunk']} times")
    print(f"  receiver wall {wall:.3f} s for {DUR:.0f} s of signal: "
          f"real-time factor {DUR / wall:.3f} ({card})")
    if "--profile" in sys.argv[1:]:
        print("== profile of the pilot path", flush=True)

        def again():
            t0 = time.perf_counter()
            s = ReceiverSession(pilot_receiver_conf())
            s.attach_array(x)
            s.run_to_end()
            torch.cuda.synchronize()
            return f"receiver wall {time.perf_counter() - t0:.3f} s"
        profile_path(again)
    del session
    if then is not None:
        launches["then"] = then(x, run)
    del x
    torch.cuda.empty_cache()
    launches["K9_epoch_chunk"] = chunks["1C"]
    launches["K9_epoch_chunk_E1"] = chunks["1B"]
    launches["K9_epoch_closure_E1"] = launches["K9_epoch_closure"]
    launches["K2_multicorrelate_E1_data"] = launches["K2_multicorrelate"]
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


PILOT_BLOCK_KERNELS = ("K8a_block_prologue_E1_pilot",
                       "K1_K8b_K8a_block_step_E1_pilot")


def pilot_block_path(wrappers, card: str, x, phase8) -> dict:
    """Phase 8c: phase 8's capture (made by K6 for phase 8, still on the
    card) through the array entry point's session with both chains at
    extend_correlation_symbols 1 (pilot_receiver_conf(gps_extend=1,
    e1_extend=1)): GPS L1 C/A on the block kernels, the E1 chain on their
    pilot form (both replica families, the data prompt for I/NAV, the
    block's CS25 sync).  Phase 8's checks and its tracked sets,
    ephemerides and fixes kept (`phase8` is its run); every tracked E1
    channel secondary-synced; the block launches as on every block path
    (K1 with K8b fused once per block, K8a once per chunk, the fold on the
    others, the chunk kernel on the chunk tails), the pilot form on the E1
    chain (its K8a and folds adding up to its fused launches, fewer than
    all the fused launches)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import ReceiverSession
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = ReceiverSession(pilot_receiver_conf(gps_extend=1, e1_extend=1))
    session.attach_array(x)
    session.run_to_end()
    run = session.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, BLOCK_PATH_KERNELS
                             + PILOT_BLOCK_KERNELS)
    check_hybrid_run(run, gps_min=PILOT_GPS_MIN)

    def tracked(r):
        return {(sy, p) for p, st, sy in zip(r.channel_prns,
                                              r.channel_states,
                                              r.channel_systems)
                if st == ChannelState.TRACKING}
    lost = tracked(phase8) - tracked(run)
    lost_eph = set(phase8.ephemerides) - set(run.ephemerides)
    print(f"  phase 8's tracked set {sorted(tracked(phase8))}, here "
          f"{sorted(tracked(run))}; phase 8's ephemerides kept: "
          f"{not lost_eph}; fixes {len(run.solutions)} (phase 8: "
          f"{len(phase8.solutions)})")
    if lost or lost_eph or len(run.solutions) < min(
            len(phase8.solutions), 5):
        fail(f"phase 8c loses phase 8's {sorted(lost)}, ephemerides "
             f"{sorted(lost_eph, key=str)} or fixes")
    for rt in session.chains:
        if rt.spec.signal != "1B":
            continue
        chans = [c for c in range(rt.spec.n_channels)
                 if rt.mgr.channels[c].state == ChannelState.TRACKING]
        synced = rt.trk.state.sec_synced.cpu().numpy()[chans]
        print(f"  E1 pilot chain: sec_synced {synced.tolist()} on the "
              f"tracked channels {chans}")
        if not len(chans) or not synced.all():
            fail(f"E1 pilot chain: sec_synced {synced} on {chans}")
    check_block_launches(launches, wall)
    fused = launches["K1_K8b_block_correlate_close"]
    fused_p = launches["K1_K8b_block_correlate_close_E1_pilot"]
    k8a_p, folds_p = (launches[n] for n in PILOT_BLOCK_KERNELS)
    print(f"  pilot form on the E1 chain: {fused_p} fused launches of "
          f"{fused}, K8a {k8a_p}, with the fold {folds_p}")
    if not (0 < fused_p < fused and k8a_p + folds_p == fused_p):
        fail(f"the pilot form ran {fused_p} of {fused} fused launches, "
             f"K8a {k8a_p}, folds {folds_p}")
    print(f"  receiver wall {wall:.3f} s for {DUR:.0f} s of signal: "
          f"real-time factor {DUR / wall:.3f} ({card})")
    del session
    return launches


def pilot_conf_path(root: str, wrappers, card: str) -> None:
    """Phase 8b: phase 4's conf with Tracking_1C.extend_correlation_symbols
    =20 and phase 4's ishort capture through the CLI: the conditioner
    (K5a), acquisition (K3, K3b), then per-epoch tracking (K2 + K9) to a
    position; phase 4's checks."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    capture = capture_paths(root)["file"]
    conf = os.path.join(root, "build", "chip_smoke_rx_ext20.conf")
    with open(conf, "w") as fh:
        fh.write(CONF.format(capture=capture)
                 + "Tracking_1C.extend_correlation_symbols=20\n")
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, EPOCH_KERNELS + MAIN_PATH_KERNELS[3:])
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    check_epoch_launches(launches, None, sec["receiver"])
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} "
          f"({card})")


# ---- phases 9 and 9b: the sharded steps and the sigma-point filters -------

# phase 9's operating point: bench.py's largest block row (192 channels of
# GPS L1 C/A at 2 Msps), a cold start over all 32 PRNs (2 dwells of 1 ms,
# 41 bins of 250 Hz), 127 code periods of PRN 7 time-sharded
SHARD_CHANNELS = 192
SHARD_EPOCHS = 50
SHARD_BLOCKS, SHARD_E = 50, 20
SHARD_KERNELS = {
    "per-epoch tracking": ("K9_epoch_chunk",),
    "block tracking": ("K8a_block_prologue", "K1_K8b_block_correlate_close",
                       "K1_K8b_K8a_block_step"),
    "block tracking, pilot form": PILOT_BLOCK_KERNELS,
    "Doppler-sharded acquisition": ("K3_pcps_wipe", "K3_pcps_rows"),
    "time-sharded acquisition": ("K3_pcps_wipe", "K7_pcps_window_fold")}


def shard_inputs(dev, rng):
    """Phase 9's inputs: the 192 channels' tables (PRNs 1-32 six times),
    states armed on a Doppler ramp, noise captures for both scans; the
    static scenario's first 2 ms with all 32 PRNs' replicas; 127 periods
    of PRN 7 (delay OS_DELAY, OS_DOPPLER Hz) in noise."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import (AcqConf,
                                                                code_replicas)
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    conf = trk.TrackingConf(fs=FS)
    c, s0 = SHARD_CHANNELS, conf.nominal_epoch_samples
    prns = [(i % 32) + 1 for i in range(c)]
    tables = np.stack([prn_codes.bandlimited_table_normalized(
        prn_codes.gps_l1_ca_code(p), FS, conf.code_rate_cps, s0, 8)
        for p in prns])
    st = trk._init_state(c, dev)._replace(
        active=torch.ones(c, dtype=torch.bool, device=dev),
        carrier_doppler=torch.linspace(-4500.0, 4500.0, c, device=dev))
    n = 2000
    n_os = OS_PERIODS * n
    code7 = prn_codes.sample_code(prn_codes.gps_l1_ca_code(OS_PRN), FS,
                                  conf.code_rate_cps, n)
    t = np.arange(n_os) / FS
    sig = np.roll(np.tile(code7, OS_PERIODS + 1)[:n_os], OS_DELAY)
    os_x = (0.4 * sig * np.exp(2j * np.pi * OS_DOPPLER * t)
            + 0.5 * (rng.standard_normal(n_os)
                     + 1j * rng.standard_normal(n_os))).astype(np.complex64)
    return dict(
        conf=conf, codes=torch.from_numpy(tables).to(dev),
        codes_rep=tb.code_spectra(conf, tables, dev),
        taps=torch.tensor([0.25, 0.0, -0.25], device=dev), state=st,
        x_epoch=_cnoise(rng, (SHARD_EPOCHS + 1) * s0 + conf.block_size, dev),
        x_block=_cnoise(rng, (SHARD_BLOCKS * SHARD_E + 2 * SHARD_E + 4) * s0
                        + tb.block_fft_size(conf), dev),
        acq_x=acq_dwells(dev),
        acq_cfc=torch.from_numpy(code_replicas(
            AcqConf(fs_in=FS, max_dwells=2), range(1, 33))).to(dev),
        dops=torch.from_numpy(pcps.doppler_grid(5000.0, 250.0)).to(dev),
        os_x=torch.from_numpy(os_x).to(dev),
        os_code=torch.from_numpy(np.asarray(code7, np.float32)).to(dev))


SHARD_PILOT_BLOCKS = 20


def pilot_shard_inputs(dev, rng):
    """Phase 9's pilot-form block step: phase 8c's E1 pilot chain at 20
    Msps, its 10 channels on PRNs 11-20 (both replica families), armed on
    a Doppler ramp, a noise capture of SHARD_PILOT_BLOCKS blocks."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    conf = pilot_receiver_conf(gps_extend=1, e1_extend=1).chains[0].trk
    c, s0 = len(PILOT_SYNC_PRNS), conf.nominal_epoch_samples
    reps, sec = pilot_tables(conf, c, signals.CodeProvider("1B", "C"),
                             signals.CodeProvider("1B"), dev,
                             PILOT_SYNC_PRNS)
    st = trk._init_state(c, dev)._replace(
        active=torch.ones(c, dtype=torch.bool, device=dev),
        carrier_doppler=torch.linspace(-3000.0, 3000.0, c, device=dev))
    return dict(conf=conf, reps=reps, sec=sec, state=st,
                taps=torch.tensor(conf_taps(conf), dtype=torch.float32,
                                  device=dev),
                x=_cnoise(rng, (SHARD_PILOT_BLOCKS * 5 + 14) * s0
                          + tb.block_fft_size(conf), dev))


def _sharded_step(name, wrappers, ss, run, unsharded, same) -> dict:
    """One sharded step: its counters at 0 just before, read just after
    (its kernels and at least one collective launched), its seconds on the
    host; then the unsharded call of the same port functions, which `same`
    holds it to, and the seconds of both a second time (warm: the first
    call includes NCCL's communicator, plans and compiles).  Returns the
    step's launches."""
    import torch
    reset(wrappers)
    for k in ss.collectives:
        ss.collectives[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers, SHARD_KERNELS[name])
    calls = dict(ss.collectives)
    if calls["all_gather"] + calls["all_reduce"] < 1:
        fail(f"{name}: no NCCL collective was called")
    same(got, unsharded())
    torch.cuda.synchronize()
    warm = []
    for fn in (run, unsharded):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"  {name}: {secs:.4f} s sharded, {warm[0]:.4f} s a second time, "
          f"the unsharded call {warm[1]:.4f} s (host, one rank); NCCL calls "
          f"{calls}; equal to the unsharded call")
    return launches


def sharded_path(wrappers) -> dict:
    """Phase 9: the four sharded steps on one rank over NCCL.  One process
    on one card is a world of one (NCCL refuses two ranks on one card):
    every collective is a copy, so each step equals the unsharded call bit
    for bit, and nothing here shows scaling.  The overlap-save grid is also
    held to its plain version (the plain wipe and fold around the same
    cuFFT calls) within 2e-4 of its largest value (tests/test_shard_map.py's
    tolerance) and must peak at the injected delay and Doppler.  Returns
    the launches of K3's row kernel alone and of K7."""
    import torch
    import torch.distributed as dist
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.parallel import (make_mesh, replicate,
                                                      shard_channel_axis)
    from gnss_sim_receiver_tpu_torch.parallel import shard_steps as ss
    from gnss_sim_receiver_tpu_torch.parallel.mesh import backend_for
    # one rank on this host's loopback: NCCL needs no other interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    mesh = make_mesh()
    print(f"  mesh: rank {mesh.rank} of {mesh.world} on {mesh.device}, "
          f"backend {mesh.backend} ({time.perf_counter() - t0:.2f} s); a "
          "world of one card: every collective is a copy, no scaling is "
          "shown")
    if mesh.world != 1 or mesh.backend != backend_for(mesh.device):
        fail("phase 9 needs one rank, NCCL on a card")
    inp = shard_inputs(mesh.device, np.random.default_rng(99))
    conf, taps = inp["conf"], replicate(inp["taps"], mesh)

    def same_tracking(got, want):
        diff = differing(got[0], want[0], got[1], want[1])
        if diff:
            fail(f"sharded tracking: {diff} differ from the unsharded call")

    def same_tensors(got, want):
        for g, w in zip(got, want):
            if not torch.equal(bits(g), bits(w)):
                fail("sharded acquisition differs from the unsharded call")
    codes = shard_channel_axis(inp["codes"], mesh)
    st = shard_channel_axis(inp["state"], mesh)
    x = replicate(inp["x_epoch"], mesh)
    _sharded_step(
        "per-epoch tracking", wrappers, ss,
        lambda: ss.tracking_step_sharded(mesh, conf, SHARD_EPOCHS, codes,
                                         taps, x, st),
        lambda: trk.track_chunk(conf, SHARD_EPOCHS, codes, taps, x, st),
        same_tracking)
    rep = shard_channel_axis(inp["codes_rep"], mesh)
    xb = replicate(inp["x_block"], mesh)
    _sharded_step(
        "block tracking", wrappers, ss,
        lambda: ss.tracking_block_step_sharded(mesh, conf, SHARD_BLOCKS,
                                               SHARD_E, rep, taps, xb, st),
        lambda: tb.track_chunk_blocks(conf, SHARD_BLOCKS, SHARD_E, rep, taps,
                                      xb, st), same_tracking)
    pil = pilot_shard_inputs(mesh.device, np.random.default_rng(98))
    p_rep, p_data, p_st = (shard_channel_axis(t, mesh) for t in (
        pil["reps"][0], pil["reps"][1], pil["state"]))
    p_x, p_taps, p_sec = replicate((pil["x"], pil["taps"], pil["sec"]),
                                   mesh)
    _sharded_step(
        "block tracking, pilot form", wrappers, ss,
        lambda: ss.tracking_block_step_sharded(
            mesh, pil["conf"], SHARD_PILOT_BLOCKS, 5, p_rep, p_taps, p_x,
            p_st, sec_code=p_sec, data_codes_rep=p_data),
        lambda: tb.track_chunk_blocks(pil["conf"], SHARD_PILOT_BLOCKS, 5,
                                      p_rep, p_taps, p_x, p_st, p_sec,
                                      p_data), same_tracking)
    del pil, p_x
    dops_l = shard_channel_axis(inp["dops"], mesh)
    acq_x, cfc = replicate((inp["acq_x"], inp["acq_cfc"]), mesh)
    rows = _sharded_step(
        "Doppler-sharded acquisition", wrappers, ss,
        lambda: ss.acquisition_doppler_sharded(mesh, acq_x, cfc, dops_l, FS),
        lambda: ss.acquisition_doppler(acq_x, cfc, inp["dops"], FS),
        same_tensors)["K3_pcps_rows"]
    peak, dop_hz, delay, noise = ss.acquisition_doppler_sharded(
        mesh, acq_x, cfc, dops_l, FS)
    grid = pcps.pcps_grid(acq_x, cfc, inp["dops"], FS)
    want = pcps.grid_peak(grid)
    sats = [p - 1 for p in SCENARIO_PRNS]
    if not (torch.equal(delay[sats], want[2][sats]) and torch.equal(
            dop_hz[sats], inp["dops"][want[1].long()][sats])):
        fail("Doppler-sharded acquisition: the scenario's cells differ from "
             "the plain grid's peaks")
    compare("Doppler-sharded acquisition, peak (scenario PRNs)", peak[sats],
            want[0][sats], 1e-4)
    compare("Doppler-sharded acquisition, noise floor", noise,
            grid.mean(dim=(1, 2)), 1e-4)
    del grid
    os_x = shard_channel_axis(inp["os_x"], mesh)
    os_code, dops = replicate((inp["os_code"], inp["dops"]), mesh)
    k7 = _sharded_step(
        "time-sharded acquisition", wrappers, ss,
        lambda: (ss.overlap_save_acq_grid(mesh, os_x, os_code, dops, FS),),
        lambda: (ss.overlap_save_grid(os_x, os_code, dops, FS),),
        same_tensors)["K7_pcps_window_fold"]
    grid = ss.overlap_save_acq_grid(mesh, os_x, os_code, dops, FS)
    n = os_code.shape[0]
    ext = torch.cat([os_x, os_x[:n]])
    t = ((torch.arange(ext.shape[0], dtype=torch.float32, device=ext.device))
         / float(np.float32(FS)))
    corr = torch.fft.ifft(torch.fft.fft(pcps._wipe_plain(ext[None], dops, t)[0],
                                        dim=-1)
                          * ss._code_fft_padded(os_code, os_x.shape[0])[None],
                          dim=-1)
    compare("time-sharded acquisition grid against its plain version", grid,
            pcps._window_fold_plain(corr, n), 2e-4)
    di, li = divmod(int(torch.argmax(grid)), n)
    print(f"  time-sharded acquisition: [{grid.shape[0]}, {n}] grid over "
          f"{OS_PERIODS} periods, peak at {float(dops[di]):g} Hz, delay "
          f"{li} (injected {OS_DOPPLER:g} Hz, {OS_DELAY})")
    if float(dops[di]) != OS_DOPPLER or li != OS_DELAY:
        fail("time-sharded acquisition: the peak is not at the injected "
             "delay and Doppler")
    del corr, grid, ext
    dist.destroy_process_group()
    return {"K3_pcps_rows": rows, "K7_pcps_window_fold": k7}


def _linear_filters(rng, b: int, nx: int = 4, nz: int = 2, steps: int = 40):
    """tests/test_nonlinear.py's linear-Gaussian system, B independent
    trajectories of it: (F, H, Q, R, zs [steps, B, nz])."""
    F = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    H = rng.standard_normal((nz, nx))
    Q, R = 0.01 * np.eye(nx), 0.1 * np.eye(nz)
    x = rng.standard_normal((b, nx))
    zs = []
    for _ in range(steps):
        x = x @ F.T + rng.multivariate_normal(np.zeros(nx), Q, b)
        zs.append(x @ H.T + rng.multivariate_normal(np.zeros(nz), R, b))
    return F, H, Q, R, np.array(zs)


def _kalman(F, H, Q, R, zs, x0, P0):
    """The exact Kalman filter over the batch (its covariance is the same
    for every filter)."""
    x, P = x0.copy(), P0.copy()
    for z in zs:
        x = x @ F.T
        P = F @ P @ F.T + Q
        S = H @ P @ H.T + R
        K = np.linalg.solve(S.T, H @ P).T
        x = x + (z - x @ H.T) @ K.T
        P = P - K @ S @ K.T
    return x, P


def filters_path(wrappers, dev) -> dict:
    """Phase 9b: SIGMA_BATCH independent filters on the card through K10a,
    torch.func.vmap of the model and K10b: 40 steps of
    tests/test_nonlinear.py's linear system under both rules, each within
    1e-2 of the exact Kalman filter (that test's bound) and within 1e-4 of
    the largest value of the plain versions' run on the CPU; then the tanh
    measurement of test_cubature_converges_nonlinear_measurement, 150 steps
    of SIGMA_BATCH random walks, converging as that test demands (on the
    mean error over the filters).  Returns K10a's and K10b's launches."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import nonlinear as nl
    rng = np.random.default_rng(3)
    b = SIGMA_BATCH
    F, H, Q, R, zs = _linear_filters(rng, b)
    x_kf, P_kf = _kalman(F, H, Q, R, zs, np.zeros((b, 4)), np.eye(4))
    Ft, Ht = (torch.from_numpy(m.astype(np.float32)) for m in (F, H))
    zt = torch.from_numpy(zs.astype(np.float32))

    def run(rule, device):
        f, h = Ft.to(device), Ht.to(device)
        q, r = (torch.from_numpy(m.astype(np.float32)).to(device)
                for m in (Q, R))
        x = torch.zeros(b, 4, device=device)
        P = torch.eye(4, device=device).repeat(b, 1, 1)
        z_all = zt.to(device)
        for k in range(zs.shape[0]):
            x, P = nl.sigma_predict(x, P, lambda s: f @ s, q, rule=rule)
            x, P = nl.sigma_update(z_all[k], x, P, lambda s: h @ s, r,
                                   rule=rule)
        return x, P
    reset(wrappers)
    for rule in ("cubature", "unscented"):
        run(rule, dev)                              # builds, warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, P = run(rule, dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # the largest norm over the filters, as the test's per filter
        ex = float(np.linalg.norm(x.cpu().numpy() - x_kf, axis=1).max())
        ep = float(np.linalg.norm(P.cpu().numpy() - P_kf, axis=(1, 2)).max())
        print(f"  {rule}: {zs.shape[0]} steps of {b} filters in {secs:.4f} s "
              f"({1e3 * secs / zs.shape[0]:.3f} ms a step, host); against "
              f"the Kalman filter: x {ex:.2e}, P {ep:.2e}")
        if ex > 1e-2 or ep > 1e-2:
            fail(f"phase 9b ({rule}): off the Kalman filter")
        x_cpu, P_cpu = run(rule, "cpu")
        compare(f"phase 9b ({rule}) against the plain versions",
                (x.cpu(), P.cpu()), (x_cpu, P_cpu), 1e-4)
    # the tanh measurement: scalar random walks
    steps = 150
    truth = np.cumsum(0.05 * rng.standard_normal((steps, b)), axis=0) + 1.0
    zs = np.tanh(truth) + rng.normal(0, 0.1, (steps, b))
    q = torch.tensor([[0.05 ** 2]], device=dev)
    r = torch.tensor([[0.01]], device=dev)
    x = torch.zeros(b, 1, device=dev)
    P = torch.full((b, 1, 1), 4.0, device=dev)
    z_all = torch.from_numpy(zs.astype(np.float32)).to(dev)
    est = []
    for k in range(steps):
        x, P = nl.sigma_predict(x, P, lambda s: s, q)
        x, P = nl.sigma_update(z_all[k], x, P, torch.tanh, r)
        est.append(x[:, 0])
    errs = np.abs(torch.stack(est).cpu().numpy() - truth).mean(axis=1)
    print(f"  tanh measurement, {b} filters: mean error {errs[:10].mean():.4f}"
          f" over the first 10 steps, {errs[-30:].mean():.4f} over the last "
          "30")
    if not (errs[-30:].mean() < 0.5 * errs[:10].mean()
            and errs[-30:].mean() < 0.4):
        fail("phase 9b: the tanh filters did not converge")
    launches = read_launches(wrappers, ("K10a_sigma_points",
                                        "K10b_sigma_moments"))
    return {k: launches[k] for k in ("K10a_sigma_points",
                                     "K10b_sigma_moments")}


# ---- phase 10: the fork's hybrid operating point ---------------------------

# BASELINE.md's "Fork hybrid operating point" (the fork's bladeRF2 hybrid
# navigation conf, GPS L1 C/A, 9 channels of which one tracks a pseudolite,
# 3 Msps), made by K6 from phase 4's sky: the pseudolite is one more GPS
# signal on a PRN no sky satellite uses, at 0 Hz and 50 dB-Hz, with its own
# LNAV stream (so that its TOW decodes) and a clock PS_DT_S off GPS time:
# it is received PS_RANGE_M / c - PS_DT_S after it leaves, and the AOWR
# clock difference it yields after each fix is PS_DT_S
FS_PS = 3_000_000.0
PS_PRN = 17
PS_CHANNEL = 8
PS_RANGE_M = 0.4
PS_DT_S = -2.5e-3
PS_CN0 = 50.0
# The clock difference after a fix is -dt_by_cp + the fix's rx clock bias:
# PS_DT_S plus the fix's own clock error less the pseudolite's ranging
# error.  With PVT.enable_rx_clock_propagation the clock is held from the
# 10th fix on, so the first term is one least-squares fix's clock error
# for the rest of the run.  tools/probe_hybrid_ps.py's CPU run of this
# scenario (the port's plain versions, the same 26 s) puts the median 11.5
# ns from PS_DT_S: the held clock 8.7 ns off (the 10th fix's), the
# pseudolite's range 2.7 ns (0.8 m).  That is past the AOWR's own 3 m
# gate (10 ns) and is reported, not allowed: phase 10 holds the AOWR
# product against the scenario's true receiver clock (the clock
# difference less the fix's clock error, which the scenario knows from
# each epoch's sample counter) within PS_CLOCK_TOL_S, twice the CPU
# run's 2.7 ns, and prints the raw median and the held clock's error
PS_CLOCK_TOL_S = 5e-9
PS_CONF = """\
GNSS-SDR.internal_fs_sps=3000000
GNSS-SDR.hybrid_mode=true
GNSS-SDR.pseudo_sat_ch_id=8
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency=3000000
Channels_1C.count=9
Channels.in_acquisition=9
Channel8.satellite=17
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.coherent_integration_time_ms=1
Acquisition_1C.pfa=0.01
Acquisition_1C.doppler_max=5000
Acquisition_1C.doppler_step=250
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
PVT.enable_rx_clock_propagation=true
PVT.share_rx_clock_bias=true
"""
PS_KERNELS = BLOCK_PATH_KERNELS + ACQUISITION_KERNELS


def ps_sats():
    """Phase 10's signals: phase 4's sky (its 6 satellites, 47 dB-Hz, the
    26 s geometry) and the pseudolite."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch import constants
    from gnss_sim_receiver_tpu_torch.nav import lnav
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    sky = make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0 + 600)
    if PS_PRN in {e.prn for e in sky}:
        raise ValueError("the pseudolite's PRN is a sky satellite's")
    sats = build_static_scenario([e for e in sky if e.prn in SCENARIO_PRNS],
                                 rx_true_ecef(), T0, DUR, cn0_db_hz=47.0,
                                 subframe_cycle=(1, 2, 3))
    cycle = (1, 2, 3)
    stream = lnav.frames_for_ephemeris(
        dataclasses.replace(sky[1], prn=PS_PRN), T0,
        n_frames=int(np.ceil((DUR + 60.0) / (6.0 * len(cycle)))),
        subframe_cycle=cycle)
    return sats + [SatelliteSignalParams(
        prn=PS_PRN, system="GPS", signal="1C", cn0_db_hz=PS_CN0,
        doppler_hz=0.0,
        delay_sec=PS_RANGE_M / constants.SPEED_OF_LIGHT_M_S - PS_DT_S,
        delay_chips=0.0, nav_bits=(2 * stream - 1).astype(np.int8))]


def make_ps_capture(path: str, device) -> None:
    """Phase 10's 26 s capture at 3 Msps made by K6 (noise seed 29) on
    `device`, quantized there and written as ibyte."""
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    x = generate_baseband_device_resident(ps_sats(), FS_PS, int(FS_PS * DUR),
                                          noise=True, seed=29, device=device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".{os.getpid()}.tmp"
    write_samples(tmp, x, "ibyte", scale=HYB_BYTE_SCALE)
    os.replace(tmp, path)


def check_ps_run(run) -> dict:
    """Phase 10's checks on a run of PS_CONF: the mean position error
    (2D < 2 m, 3D < 5 m), no fix on the pseudolite's channel, no bias
    record tagged with its PRN and one per fix, one clock difference per
    fix from the first epoch that observes the pseudolite, and the median
    AOWR product against the true receiver clock (each clock difference
    less its fix's clock error: the scenario's sample 0 is GPS time T0,
    so an epoch's true receiver clock offset is its rx time less T0 +
    its sample counter over FS_PS) within PS_CLOCK_TOL_S of PS_DT_S.
    Returns the numbers, the raw median and the fixes' clock errors
    among them."""
    sols = run.solutions
    if run.channel_prns[PS_CHANNEL] != PS_PRN or len(sols) < 5:
        fail(f"channel {PS_CHANNEL} holds PRN {run.channel_prns[PS_CHANNEL]}"
             f", {len(sols)} fixes")
    err_2d, err_3d = mean_error(run)
    used = sorted({int(c) for s in sols for c in s.used_channels})
    tags = sorted({prn for *_, prn in run.rx_clock_bias_log})
    true_clock = {round(e.rx_time_s, 3):
                  e.rx_time_s - (T0 + e.tick_sample / FS_PS)
                  for e in run.observation_epochs}
    seen = [e.rx_time_s for e in run.observation_epochs
            if e.valid[PS_CHANNEL]]
    fix_t = [round(s.rx_time_corrected_s + s.rx_clock_bias_s, 3)
             for s in sols]
    clock_err = np.array([s.rx_clock_bias_s - true_clock[t]
                          for s, t in zip(sols, fix_t)])
    after = [t >= round(seen[0], 3) for t in fix_t] if seen else []
    diffs = np.array([d for d, _ in run.clock_differences])
    med = float(np.median(diffs)) if len(diffs) else float("nan")
    aowr = float(np.median(diffs - clock_err[after])) \
        if len(diffs) == sum(after) else float("nan")
    out = dict(fixes=len(sols), err_2d=err_2d, err_3d=err_3d,
               used_channels=used, bias_tags=tags,
               clock_differences=len(diffs), fixes_after_ps=sum(after),
               median_clock_difference_s=med,
               raw_gap_s=med - PS_DT_S,
               median_fix_clock_error_s=float(np.median(clock_err)),
               aowr_gap_s=aowr - PS_DT_S)
    print(f"  {len(sols)} fixes on channels {used}; mean error 2D "
          f"{err_2d:.3f} m, 3D {err_3d:.3f} m; bias records tagged {tags}; "
          f"{len(diffs)} clock differences for {sum(after)} fixes since "
          f"the pseudolite was first observed; their median {med!r} s "
          f"against {PS_DT_S!r}: {med - PS_DT_S:.3e} s off, of which the "
          f"fixes' clock error (median {np.median(clock_err):.3e} s; held "
          f"from the 10th fix: {clock_err[-1]:.3e} s); against the true "
          f"receiver clock {aowr - PS_DT_S:.3e} s (tolerance "
          f"{PS_CLOCK_TOL_S:g})")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")
    if PS_CHANNEL in used or PS_PRN in tags \
            or len(run.rx_clock_bias_log) != len(sols):
        fail(f"the pseudolite's channel in a fix ({used}) or its PRN in "
             f"a bias record ({tags})")
    if not seen or len(diffs) != sum(after):
        fail(f"{len(diffs)} clock differences, {sum(after)} fixes after "
             "the pseudolite was observed")
    if not abs(aowr - PS_DT_S) < PS_CLOCK_TOL_S:
        fail(f"the AOWR product against the true receiver clock {aowr!r} "
             f"s, planted {PS_DT_S!r} s")
    return out


def ps_path(root: str, wrappers, card: str) -> dict:
    """Phase 10: the hybrid operating point through the CLI (the port's
    factory reads PS_CONF's hybrid keys) on the card: K6 makes the capture
    (its launches counted apart), then the counters are set to 0 just
    before the CLI and read just after; the block path's kernels and the
    acquisition's must run (GPS at 3 Msps: K1 with K8b and the fold, the
    chunk kernel on the tails); check_ps_run's checks."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    path = os.path.join(root, "build", "ps_scenario_26s_3msps_v1.ibyte")
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    make_ps_capture(path, "cuda")
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ibyte "
          f"at {FS_PS / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    conf = os.path.join(root, "build", "chip_smoke_ps.conf")
    with open(conf, "w") as fh:
        fh.write(PS_CONF.format(capture=path))
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, PS_KERNELS)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_ps_run(res.run)
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    check_block_launches(launches, sec["receiver"])
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} "
          f"({card})")
    os.remove(path)
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


# ---- phases 11 and 12: the multi-band front end and the live session ------

FS_MB_L1 = 8_000_000.0         # phase 11: GPS L1 C/A on RF channel 0
FS_MB_L5 = FS_WIDEBAND         # phase 11: GPS L5I on RF channel 1
MB_DEC = 4                     # acquisition at 2 Msps (acq_decim)
MB_DUR = 30.0
# on the grids of both LNAV's toe (16 s) and CNAV's (300 s): make_sky's
# T0 + 600 rounds to 346208 s, which CNAV carries as 346200 s, and the
# decoded CNAV ephemeris then replaces the LNAV one under its PRN (as in
# JAX), moving the fix by kilometres.  At T0 the six satellites' Dopplers
# lie at least 129 Hz apart; at T0 + 1200 s PRNs 4 and 10 fall 4.2 Hz
# apart and their C/A codes' cross-correlation walks through both
# trackers, moving the fix ~10 m for a few seconds
# (tools/probe_multiband.py shows all three).
MB_TOE = T0
MB_L5_PRNS = (1, 3, 4, 5)      # the four of phase 4's six with L5 signals
MB_CHANNELS = 8
MB_ASSIST_TOL_HZ = 50.0        # tests/test_assisted_acq.py's bound
MB_PR_TOL_M = 30.0             # tests/test_multiband.py's bound
MB_PVT_RATE_MS = 200
MB_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step", "K3_pcps_wipe",
              "K3_pcps_peak", "K3b_pcps_wipe_per_channel")


def multiband_sats():
    """Phase 11's sky: phase 4's six satellites on L1 C/A (47 dB-Hz, the
    30 s geometry) and four of them, MB_L5_PRNS, on L5I (48 dB-Hz; the
    other two have no L5 signal, as older GPS satellites).  One ephemeris
    per satellite, toe = toc = MB_TOE, which both LNAV (16 s) and CNAV
    (300 s) carry exactly: the receiver stores either band's decoded
    ephemeris under the PRN, as JAX's does."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = [dataclasses.replace(e, toe=MB_TOE, toc=MB_TOE)
            for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                            toe=MB_TOE)
            if e.prn in SCENARIO_PRNS]
    l1 = build_static_scenario(ephs, rx_true_ecef(), T0, MB_DUR,
                               cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    l5 = build_static_scenario([e for e in ephs if e.prn in MB_L5_PRNS],
                               rx_true_ecef(), T0, MB_DUR, cn0_db_hz=48.0,
                               band="L5")
    if sorted(s.prn for s in l1) != list(SCENARIO_PRNS) \
            or sorted(s.prn for s in l5) != list(MB_L5_PRNS):
        fail(f"multi-band sky: {[s.prn for s in l1]}, {[s.prn for s in l5]}")
    return {e.prn: e for e in ephs}, l1, l5


def multiband_conf():
    """Phase 11's receiver: GPS L1 C/A at 8 Msps on RF 0 with acquisition on
    the x4 mean-pooled stream (tests/test_multiband.py:110-116's chain:
    gps_chain=False and an explicit "1C" chain), GPS L5I at 20 Msps on
    RF 1 (gps_l5_chain, assist-gated, bit_transition_flag), 8 channels
    each."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
    from gnss_sim_receiver_tpu_torch.models.receiver import (ReceiverConf,
                                                             SignalChainConf,
                                                             gps_l5_chain)
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingConf
    prns = tuple(range(1, 11))
    l1 = SignalChainConf(
        signal="1C", system="GPS", prns=prns, n_channels=MB_CHANNELS,
        max_acq_channels=MB_CHANNELS,
        acq=AcqConf(fs_in=FS_MB_L1 / MB_DEC, max_dwells=2),
        trk=TrackingConf(fs=FS_MB_L1), acq_decim=MB_DEC)
    l5 = dataclasses.replace(
        gps_l5_chain(FS_MB_L5, prns=SCENARIO_PRNS, n_channels=MB_CHANNELS),
        rf_channel_id=1)
    # the doubled FFT, as phase 7's conf sets it (ROADMAP queue 3: NH10
    # flips the sign every 1 ms epoch).  With the chain's defaults the
    # assisted search finds all four, but an NH10 flip cuts PRN 4's dwell
    # and its loop locks 493 Hz off (-1494.5 against -1987.6 Hz): its
    # CNAV never decodes (tools/probe_multiband.py, "nh10")
    l5.acq = dataclasses.replace(l5.acq, bit_transition_flag=True)
    return ReceiverConf(fs=FS_MB_L1, prns=prns, gps_chain=False,
                        rf_fs={1: FS_MB_L5}, chains=(l1, l5),
                        pvt_rate_ms=MB_PVT_RATE_MS)


def check_assisted(dev) -> tuple:
    """Phase 3: the assisted search at phase 11's L5 shape: M=2 dwells,
    C=8 channels (PRNs 1-8), D2=9 Doppler rows each (+-250 Hz in 62.5 Hz
    steps), N=the chain's FFT (40000 at 20 Msps: 1 ms doubled by
    bit_transition_flag), on 4 ms of phase 11's L5 stream made by K6.
    The K3b wipe (wipe_case) and K3's row kernel (k3_peak_row) on its
    correlations, each against its plain version; the whole search
    (pcps_search_assisted) against its plain composition; the mean-pool
    decimation of phase 11's L1 window (4000 x 4 samples, one PyTorch
    call) timed beside.  Returns the two rows and the decimation's entry
    for the other shapes."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    chain = multiband_conf().chains[1]
    eng = PcpsAcquisitionEngine(chain.acq, tuple(range(1, 9)),
                                code_provider=chain.code_provider,
                                sc_rate=chain.sc_rate, device=dev)
    m, n = chain.acq.max_dwells, eng.fft_size
    x = generate_baseband_device_resident(
        multiband_sats()[2], FS_MB_L5, m * n, noise=True, seed=41,
        device=dev).reshape(m, n)
    table = narrow_table(eng)
    cfc = eng.code_fft_conj
    label = f"phase 11's assisted L5 search at {FS_MB_L5 / 1e6:g} Msps"
    wipe = wipe_case(x, table, eng._t, label, k3_search(cfc, m), 3)
    wipe["name"] = "K3b_pcps_wipe_per_channel_assisted"
    corr = torch.fft.ifft(torch.fft.fft(pcps.pcps_wipe(x, table, eng._t),
                                        dim=-1) * cfc[None, :, None],
                          dim=-1)
    peak = k3_peak_row(corr, m, label, 3)
    peak["name"] = "K3_pcps_peak_assisted"
    del corr
    got = pcps.pcps_search_assisted(x, cfc, table, eng._t)
    stat, di, de = pcps.max_to_input_power_stat(
        pcps.pcps_grid_per_channel(x, cfc, table, FS_MB_L5), float(m))
    want = torch.stack([stat, torch.gather(table, 1, di.long()[:, None])[:, 0],
                        de.to(torch.float32)])
    torch.cuda.synchronize()
    compare("pcps_search_assisted statistic", got[0], want[0], 1e-4)
    compare("pcps_search_assisted cells", got[1:], want[1:], 0.0)
    torch.cuda.empty_cache()
    xd = _cnoise(np.random.default_rng(43), 4000 * MB_DEC, dev)
    pool_ms = time_ms(lambda: xd.reshape(-1, MB_DEC).mean(dim=1))
    print(f"  mean-pool decimation (phase 11's L1 acquisition window, "
          f"{4000 * MB_DEC} samples x{MB_DEC}, one PyTorch call): "
          f"{pool_ms:.4f} ms")
    return [wipe, peak], dict(
        name="mean_pool_decimation", route="torch", ms=pool_ms,
        shape=f"{4000 * MB_DEC} complex64 samples, reshape(-1, {MB_DEC})"
              ".mean(1)")


def multiband_path(wrappers, card: str) -> dict:
    """Phase 11: the multi-band front end at full width.  K6 makes the two
    RF streams of one sky (its launches counted apart); the counters are
    set to 0 just before ReceiverSession.attach_arrays({0: L1, 1: L5}) +
    run_to_end (warm-started with the scenario's ephemerides, as
    tests/test_multiband.py's dual-band run) and read just after.  Checks:
    every L5 acquisition took the assisted path (the assist log lists each
    tracked L5 PRN as detected; no cold L5 search), each center within
    50 Hz of the true L1 Doppler scaled by f_L5 / f_L1 at its window, no L5
    channel on a PRN without L5, 2D < 2 m and 3D < 5 m, a fix using both
    bands, |PR_L5 - PR_L1| < 30 m per PRN at the common epochs, and the
    launch counters: K3b and K3 at the assisted shape, the block step at
    8 and 20 Msps."""
    import torch
    from gnss_sim_receiver_tpu_torch import constants
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    ephs, l1_sats, l5_sats = multiband_sats()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x1 = generate_baseband_device_resident(l1_sats, FS_MB_L1,
                                           int(FS_MB_L1 * MB_DUR),
                                           noise=True, seed=41, device="cuda")
    x5 = generate_baseband_device_resident(l5_sats, FS_MB_L5,
                                           int(FS_MB_L5 * MB_DUR),
                                           noise=True, seed=42, device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made {len(x1) / 1e6:.0f} M samples at {FS_MB_L1 / 1e6:g} "
          f"Msps and {len(x5) / 1e6:.0f} M at {FS_MB_L5 / 1e6:g} Msps in "
          f"{time.perf_counter() - t0:.3f} s (not timed)")
    conf = multiband_conf()
    f_ratio = constants.GPS_L5_FREQ_HZ / constants.GPS_L1_FREQ_HZ
    # each observation epoch's channel -> PRN map, as the session holds it
    # when the epoch is formed (re-acquisitions move PRNs between
    # channels; a re-armed channel's history is cleared): logged_session
    session, run, launches, windows, wall, wipe, peak = assisted_session(
        wrappers, conf, {0: x1, 1: x5}, ephs, MB_KERNELS, FS_MB_L5)
    del x1, x5
    torch.cuda.empty_cache()
    # the assisted searches
    n1 = conf.chains[0].n_channels
    states = list(zip(run.channel_prns, run.channel_states))
    l1_trk = sorted(p for p, s in states[:n1] if s == ChannelState.TRACKING)
    l5_trk = sorted(p for p, s in states[n1:] if s == ChannelState.TRACKING)
    print(f"  L1 tracks {l1_trk}, L5 tracks {l5_trk}")
    if l1_trk != list(SCENARIO_PRNS) or l5_trk != list(MB_L5_PRNS):
        fail(f"tracked L1 {l1_trk}, L5 {l5_trk}: expected "
             f"{list(SCENARIO_PRNS)} and {list(MB_L5_PRNS)}")
    check_assisted_centres(session, windows, l1_sats, f_ratio, "L5", l5_trk)
    # the fix and the two bands' observables
    check_run_position(run, min_fixes=5)
    both = [s for s in run.solutions if s.used_channels is not None
            and (s.used_channels < n1).any()
            and (s.used_channels >= n1).any()]
    if not both:
        fail("no fix used observables of both bands")
    diffs = band_pr_diffs(run, session.epoch_prns, n1)
    worst_pr = {p: float(np.abs(d).max()) for p, d in diffs.items()}
    print(f"  {len(both)} of {len(run.solutions)} fixes use both bands; "
          f"max |PR_L5 - PR_L1| by PRN {worst_pr} m over "
          f"{sum(len(d) for d in diffs.values())} pairs")
    if sorted(diffs) != list(MB_L5_PRNS) \
            or max(worst_pr.values()) >= MB_PR_TOL_M:
        fail(f"L5 against L1 pseudoranges: {worst_pr}")
    # the launch counters at the new shapes
    n5 = PcpsAcquisitionEngine(conf.chains[1].acq, (1,), device="cuda"
                               ).fft_size
    k3b = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n5)
    k3 = sum(v for s, v in peak.items() if s[2] == 9 and s[-1] == n5)
    f8 = tb.block_fft_size(conf.chains[0].trk)
    f20 = tb.block_fft_size(conf.chains[1].trk)
    by_f = {f: block_counts(f, 20) for f in (f8, f20)}
    print(f"  assisted shape: K3b {k3b} launches at N={n5} ({dict(wipe)}), "
          f"K3's peak {k3} ({dict(peak)}); block step (K8a, folds) at "
          f"F={f8} (8 Msps) {by_f[f8]}, at F={f20} (20 Msps) {by_f[f20]}")
    if not (k3b and k3 == k3b and all(all(v) for v in by_f.values())):
        fail("phase 11 did not launch K3b and K3 at the assisted shape and "
             "the block step at 8 and 20 Msps")
    print(f"  wall {wall:.3f} s for {MB_DUR:.0f} s of two RF streams: "
          f"real-time factor {MB_DUR / wall:.3f} ({card})")
    launches.update({
        "K6_device_generator": k6["K6_device_generator"],
        "K3b_pcps_wipe_per_channel_assisted": k3b,
        "K3_pcps_peak_assisted": k3,
        "K8a_block_prologue_8Msps": by_f[f8][0],
        "K1_K8b_K8a_block_step_8Msps": by_f[f8][1]})
    return launches


# phase 13's forms: (TrackingConf keys, row suffix, label)
KALMAN_FORMS = (({"tracking_mode": "kf"}, "_kf", "KF"),
                ({"tracking_mode": "gaussian"}, "_gaussian", "gaussian"),
                ({"pll_filter_order": 2}, "_pll2", "second-order PLL"))
TRACK_OUTPUT_KEYS = ("prompt", "valid", "carrier_doppler_hz",
                     "acc_phase_cycles", "code_phase_samples", "cn0_db_hz",
                     "early_mag", "late_mag", "code_freq_cps",
                     "rem_code_phase_chips", "pos_start", "n_samples",
                     "sample_counter")


def epoch_path_launches(wrappers, form, receiver_s: float) -> dict:
    """The launches of a per-epoch path whose every chunk ran the closure
    form `form` (a wrapper name, or None for the third-order loops): the
    chunk kernel and acquisition launched, no block kernel, no standalone
    K2, K9 or K8b, and every chunk launch counted under the form."""
    launches = read_launches(wrappers, EPOCH_KERNELS + ACQUISITION_KERNELS)
    check_epoch_launches(launches, None, receiver_s)
    forms = ("K9_epoch_chunk_kf", "K9_epoch_chunk_gaussian",
             "K9_epoch_chunk_pll2")
    for name in forms:
        want = launches["K9_epoch_chunk"] if name == form else 0
        if launches[name] != want:
            fail(f"{name}: {launches[name]} launches, {want} expected")
    return launches


def check_track_outputs(session, run, root: str, label: str) -> None:
    """collect_track_outputs: all 13 planes [T, C], T the epochs of every
    chunk the session dispatched; on each tracking channel's last run of
    valid epochs the sample counter rises by each epoch's length; each
    tracking channel's dump_tracking_mat written under build/ and read back
    equal to its planes."""
    from gnss_sim_receiver_tpu_torch.models import dumps
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    outs = run.track_outputs
    (rt,) = session.chains
    t, c = rt.trk.epochs_dispatched, rt.spec.n_channels
    if outs is None or sorted(outs) != sorted(TRACK_OUTPUT_KEYS):
        fail(f"{label}: track_outputs keys "
             f"{None if outs is None else sorted(outs)}")
    shapes = {k: v.shape for k, v in outs.items()}
    if any(v != (t, c) for v in shapes.values()):
        fail(f"{label}: plane shapes {shapes}, expected {(t, c)}")
    tracking = [ch for ch, st in enumerate(run.channel_states)
                if st == ChannelState.TRACKING]
    sc, n_s, valid = (outs[k] for k in ("sample_counter", "n_samples",
                                        "valid"))
    runs = []
    for ch in tracking:
        bad = np.flatnonzero(~valid[:, ch])
        first = int(bad[-1]) + 1 if bad.size else 0
        steps = np.diff(sc[first:, ch])
        if len(steps) < 500 or not np.array_equal(steps,
                                                   n_s[first + 1:, ch]):
            fail(f"{label}: channel {ch}'s sample counter over its last "
                 f"{len(steps) + 1} valid epochs does not rise by the epoch "
                 "lengths")
        runs.append(len(steps) + 1)
    d = os.path.join(root, "build", "phase13_dumps")
    os.makedirs(d, exist_ok=True)
    for ch in tracking:
        path = os.path.join(d, f"trk_ch{ch}.mat")
        dumps.dump_tracking_mat(path, outs, channel=ch)
        m = dumps.load_mat(path)
        want = {"Prompt_I": outs["prompt"][:, ch].real,
                "Prompt_Q": outs["prompt"][:, ch].imag,
                "abs_E": outs["early_mag"][:, ch],
                "abs_L": outs["late_mag"][:, ch],
                "PRN_start_sample_count": outs["sample_counter"][:, ch],
                "carrier_doppler_hz": outs["carrier_doppler_hz"][:, ch],
                "code_freq_chips": outs["code_freq_cps"][:, ch],
                "rem_code_phase_sample": outs["code_phase_samples"][:, ch],
                "CN0_SNV_dB_Hz": outs["cn0_db_hz"][:, ch]}
        for k, v in want.items():
            if not np.array_equal(m[k].ravel(), np.asarray(v).astype(
                    m[k].dtype)):
                fail(f"{label}: {path}: {k} read back differs")
    print(f"  {label}: track_outputs {len(outs)} planes of [{t}, {c}]; "
          f"tracking channels {tracking}: the sample counter rises by the "
          f"epoch length over their last {runs} valid epochs; {len(tracking)}"
          f" tracking dumps written to {d} and read back equal")


def kalman_path(root: str, wrappers, card: str) -> dict:
    """Phase 13 on phase 4's capture and conf: (a) the KF
    (Tracking_1C.implementation=GPS_L1_CA_KF_Tracking) through the CLI,
    every chunk on the chunk kernel's KF form, the real-time factor
    printed; (b) the gaussian mode on the conditioned capture through
    Receiver.process_array's session, every tracking channel's
    posterior count above 50 at the end; (c) collect_track_outputs in
    dll_pll mode: no block launch, the planes and dumps of
    check_track_outputs; (d) (c) with Tracking_1C.order=2, the
    second-order PLL on every chunk.  Each is held to phase 4's tracked set,
    fixes and position error, with its counters set to 0 just before it
    and read just after."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.utils.config import FileConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    capture = capture_paths(root)["file"]
    text = CONF.format(capture=capture)
    kf_conf = os.path.join(root, "build", "chip_smoke_rx_kf.conf")
    with open(kf_conf, "w") as fh:
        fh.write(text.replace("GPS_L1_CA_DLL_PLL_Tracking",
                              "GPS_L1_CA_KF_Tracking"))
    pll2_conf = os.path.join(root, "build", "chip_smoke_rx_pll2.conf")
    with open(pll2_conf, "w") as fh:
        fh.write(text + "Tracking_1C.order=2\n")
    print("  (a) the KF through the CLI", flush=True)
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={kf_conf}"])
    torch.cuda.synchronize()
    launches = epoch_path_launches(wrappers, "K9_epoch_chunk_kf",
                                   res.seconds["receiver"])
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    check_run(res.run, min_fixes=5)
    sec = res.seconds
    wall = sum(sec.values())
    ep = launches["K9_epoch_chunk_epochs"]
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f} "
          f"({1e3 * sec['receiver'] / ep:.4f} ms per epoch, {ep} epochs in "
          f"{launches['K9_epoch_chunk']} chunks); wall {wall:.3f} s for "
          f"{DUR:.0f} s of signal: real-time factor {DUR / wall:.3f} ({card})")
    out = {"K9_epoch_chunk_kf": launches["K9_epoch_chunk_kf"]}

    config = FileConfiguration(os.path.join(root, "build",
                                            "chip_smoke_rx.conf"))
    y = SignalConditioner(config, fs_in=FS_FILE).process(
        read_samples(capture, "ishort"))
    torch.cuda.synchronize()
    base = receiver_conf_from_config(config)

    def session_run(conf, collect: bool, form, label: str):
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session = Receiver(conf).start_session(collect_track_outputs=collect)
        session.attach_array(y)
        session.run_to_end()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = epoch_path_launches(wrappers, form, wall)
        run = session.result()
        check_run(run, min_fixes=5)
        print(f"  {label}: receiver {wall:.3f} s for {DUR:.0f} s of signal: "
              f"real-time factor {DUR / wall:.3f} ({card})")
        return session, run, launches

    print("  (b) the gaussian mode through process_array's session",
          flush=True)
    gauss = dataclasses.replace(base, trk=dataclasses.replace(
        base.trk, tracking_mode="gaussian"))
    session, run, launches = session_run(gauss, False,
                                         "K9_epoch_chunk_gaussian",
                                         "gaussian")
    out["K9_epoch_chunk_gaussian"] = launches["K9_epoch_chunk_gaussian"]
    nu = session.chains[0].trk.state.bayes_nu.cpu().numpy()
    tracking = [ch for ch, st in enumerate(run.channel_states)
                if st == ChannelState.TRACKING]
    print(f"  posterior counts bayes_nu of the tracking channels "
          f"{tracking}: {nu[tracking].round(3).tolist()}")
    if not (nu[tracking] > 50.0).all():
        fail(f"bayes_nu {nu[tracking]} not above 50 on every tracking "
             "channel")
    print("  (c) collect_track_outputs (dll_pll)", flush=True)
    session, run, _ = session_run(base, True, None, "collect_track_outputs")
    check_track_outputs(session, run, root, "collect_track_outputs")
    print("  (d) collect_track_outputs with Tracking_1C.order=2", flush=True)
    pll2 = receiver_conf_from_config(FileConfiguration(pll2_conf))
    if pll2.trk.pll_filter_order != 2:
        fail(f"Tracking_1C.order=2 gave order {pll2.trk.pll_filter_order}")
    session, run, launches = session_run(pll2, True, "K9_epoch_chunk_pll2",
                                         "second-order PLL")
    check_track_outputs(session, run, root, "second-order PLL")
    out["K9_epoch_chunk_pll2"] = launches["K9_epoch_chunk_pll2"]
    del y
    return out


def check_run_position(run, min_fixes: int) -> None:
    """check_run's position checks without its tracked set."""
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true_ecef(), ref)
                    for s in run.solutions]).reshape(-1, 3)
    if len(run.solutions) < min_fixes or not np.isfinite(enu).all():
        fail(f"{len(run.solutions)} fixes, finite: {np.isfinite(enu).all()}")
    err_2d = float(np.linalg.norm(enu.mean(0)[:2]))
    err_3d = float(np.linalg.norm(enu.mean(0)))
    print(f"  {len(run.solutions)} fixes, mean error 2D {err_2d:.3f} m, 3D "
          f"{err_3d:.3f} m")
    if not (err_2d < 2.0 and err_3d < 5.0):
        fail(f"position error 2D {err_2d:.3f} m, 3D {err_3d:.3f} m")


LIVE_STEP_S = 1.0               # feed blocks (tests/test_control_plane.py)
LIVE_WARM_S = 12                # fed before standby
LIVE_STANDBY_S = 2              # dropped in standby
LIVE_FIX_COUNT_TOL = 2          # tests/test_control_plane.py's bounds
LIVE_FIRST_TOL_M = 0.5
LIVE_LAST_TOL_M = 3.0
LIVE_REFIX_TOL_M = 20.0


def _cmd(port: int, line: str) -> str:
    import socket
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        fh = s.makefile("rw", newline="\n")
        fh.write(line + "\nexit\n")
        fh.flush()
        return fh.readline().strip()


def live_path(root: str, wrappers, card: str, batch_rtf: float) -> dict:
    """Phase 12: the live session.  Phase 4's capture, conditioned as phase
    4 conditions it (GPS L1 C/A, 2 Msps, 26 s), through process_array and
    through feed() in 1 s host blocks + run_to_end (cold, both), on the
    receiver of tests/test_control_plane.py (PRNs 1-10, 8 channels: with
    phase 4's 32 PRNs the re-acquisition waves land on other chunk
    boundaries in the two modes before the first fix), held to each other
    under that test's bounds; the counters are set to 0 just before the
    streaming run and read just after.  Then
    a session warm-started with the batch run's ephemerides, fed in 1 s
    blocks, under a TcpCmdServer on 127.0.0.1: `status` answers running,
    `standby` drops the next 2 s with no fix from them, `hotstart` refixes
    within the capture's remaining 12 s (the JAX test's window), within
    20 m, the ephemerides kept; `coldstart` clears them."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.conditioner import \
        SignalConditioner
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import (Receiver,
                                                             ReceiverConf)
    from gnss_sim_receiver_tpu_torch.monitor.tcp_cmd import TcpCmdServer
    from gnss_sim_receiver_tpu_torch.utils.config import FileConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import read_samples
    config = FileConfiguration(os.path.join(root, "build",
                                            "chip_smoke_rx.conf"))
    x = read_samples(capture_paths(root)["file"], "ishort")
    y = SignalConditioner(config, fs_in=FS_FILE).process(x)
    torch.cuda.synchronize()
    y_host = y.cpu().numpy()
    rx = Receiver(ReceiverConf(fs=FS, prns=tuple(range(1, 11)),
                               max_channels=8))
    t0 = time.perf_counter()
    batch = rx.process_array(y)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    del y
    torch.cuda.empty_cache()
    step = int(FS * LIVE_STEP_S)
    session = rx.start_session()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(0, len(y_host), step):
        session.feed(y_host[k:k + step])
    session.run_to_end()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches = read_launches(wrappers, BLOCK_PATH_KERNELS
                             + ACQUISITION_KERNELS)
    run = session.result()
    check_run(batch, min_fixes=5)
    check_run(run, min_fixes=5)
    n_b, n_s = len(batch.solutions), len(run.solutions)
    d0 = max(np.linalg.norm(run.solutions[i].rx_ecef_m
                            - batch.solutions[i].rx_ecef_m)
             for i in range(min(4, n_s)))
    d_last = float(np.linalg.norm(run.solutions[-1].rx_ecef_m
                                  - batch.solutions[-1].rx_ecef_m))
    print(f"  streaming {n_s} fixes, batch {n_b}; the first four within "
          f"{d0:.4f} m, the last {d_last:.4f} m apart")
    if abs(n_s - n_b) > LIVE_FIX_COUNT_TOL or d0 >= LIVE_FIRST_TOL_M \
            or d_last >= LIVE_LAST_TOL_M:
        fail(f"streaming against batch: {n_s} against {n_b} fixes, first "
             f"four {d0:.4f} m, last {d_last:.4f} m")
    dur = len(y_host) / FS
    print(f"  receiver {batch_s:.3f} s batch (real-time factor "
          f"{dur / batch_s:.3f}), {stream_s:.3f} s streaming in "
          f"{LIVE_STEP_S:g} s host blocks (real-time factor "
          f"{dur / stream_s:.3f}); phase 4's batch real-time factor "
          f"{batch_rtf:.3f} ({card})")
    # the warm-started session under the TCP server
    live = rx.start_session(ephemerides=dict(batch.ephemerides))
    srv = TcpCmdServer(live)
    try:
        status = _cmd(srv.port, "status")
        if not status.startswith("running"):
            fail(f"status: {status!r}")
        pos = 0

        def feed(seconds):
            nonlocal pos
            for _ in range(seconds):
                live.feed(y_host[pos:pos + step])
                pos += step
        feed(LIVE_WARM_S)
        n_warm = len(live.solutions)
        if not n_warm:
            fail(f"no warm fix within {LIVE_WARM_S} s")
        reply = _cmd(srv.port, "standby")
        feed(LIVE_STANDBY_S)
        idle = all(c.state == ChannelState.IDLE for rt in live.chains
                   for c in rt.mgr.channels)
        status = _cmd(srv.port, "status")
        if (reply != "OK standby" or not idle or len(live.solutions) != n_warm
                or not status.startswith("standby")):
            fail(f"standby: {reply!r}, channels idle {idle}, fixes "
                 f"{len(live.solutions)} after {n_warm}, status {status!r}")
        reply = _cmd(srv.port, "hotstart")
        t_hot = pos / FS
        feed(int(len(y_host) / step) - LIVE_WARM_S - LIVE_STANDBY_S)
        live.run_to_end()
        refix = len(live.solutions) - n_warm
        err = float(np.linalg.norm(live.solutions[-1].rx_ecef_m
                                   - rx_true_ecef()))
        print(f"  TCP: warm fixes {n_warm} in {LIVE_WARM_S} s, standby "
              f"dropped {LIVE_STANDBY_S} s with none, hotstart at "
              f"{t_hot:.0f} s: {refix} fixes after it, the last {err:.3f} m "
              f"off; {len(live.ephemerides)} ephemerides kept")
        if reply != "OK hotstart" or refix <= 0 or err >= LIVE_REFIX_TOL_M \
                or len(live.ephemerides) < len(SCENARIO_PRNS):
            fail(f"hotstart: {reply!r}, {refix} fixes after it, the last "
                 f"{err:.3f} m off, {len(live.ephemerides)} ephemerides")
        reply = _cmd(srv.port, "coldstart")
        if reply != "OK coldstart" or live.ephemerides:
            fail(f"coldstart: {reply!r}, {len(live.ephemerides)} "
                 "ephemerides left")
    finally:
        srv.close()
    return launches


# ---- phase 14: the GPS L2C (CM) and Galileo E5b-I chains -------------------

F_L2 = 1_227.6e6
F_E5B = 1_207.14e6
# (a): L2C alone, 54 s.  A channel feeds the observables only after
# fll_pullin_epochs + 2500 epochs of tracking (receiver.py's settle gate,
# counted in epochs as JAX's: 2.5 s at 1 ms, 50.5 s at L2C's 20 ms; ROADMAP
# queue 3), so the fixes start ~51 s in.  And channels acquired in a later
# cold search are armed at the chain's front (~1 s) and miss the first
# message (MT 10, 0-12 s): the decoder wants 400 bits (16 s) of symbols
# behind a message's start (nav/cnav.py WINDOW_BITS), so their MT 10 of
# 36-48 s decodes at ~51.5 s
L2C_DUR = 54.0
L2C_CN0 = 45.0
L2C_CHANNELS = 8
# (b): L1 C/A + L2C on two RF streams at 4 Msps, 54 s (the settle gate, as
# (a)'s).  At a 100 ms observable interval the 20 ms L2C epoch is
# decimated by 4 (receiver.py's min(interval, 90) // epoch) and runs on the
# block step at E = 2, whose loops close once a 40 ms block: the L2C
# channels lose lock within seconds of each acquisition, in the JAX package
# too (with the FLL pull-in off they walk tens of Hz off within a second of
# moving to the block step; ROADMAP.md queue 3).  So (b) runs the capture
# twice: at 100 ms for the block step's launches, and at the default 20 ms
# (decim 1, the chunk kernel) for the L2C chain's checks
FS_L2C_MB = FS_FILE
L2C_MB_DUR = 54.0
L2C_MB_INTERVAL_MS = 100
L2C_MB_PRNS = MB_L5_PRNS        # the four of phase 4's six with L2C signals
L2C_DOPPLER_TOL_HZ = 1.0
# (c): GPS L1 C/A + Galileo E5b-I, E5b at 20 Msps with phase 7's channels
FS_E5B = FS_WIDEBAND
E5B_DUR = 30.0
E5B_CHANNELS = 10
# Acquisition_7X.max_dwells: at the chain's 2 dwells of 1 ms (doubled), 4
# of 60 searches of (c)'s sky at 48 dB-Hz put the Doppler 200 to 606 Hz
# off; the decision-directed FLL (+-250 Hz at 1 ms, flip-proof for CS4)
# then locks the channel 500 Hz off and its I/NAV never decodes, in JAX
# too (ROADMAP.md queue 3).  8 dwells: none of 60 beyond 81 Hz (a CPU
# count at 12.5 Msps)
E5B_DWELLS = 8
L2C_KERNELS = ("K9_epoch_chunk", "K3_pcps_wipe", "K3_pcps_peak",
               "K3b_pcps_wipe_per_channel", "K5a_fir_decim")
L2C_MB_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step",
                  "K3_pcps_wipe", "K3_pcps_peak", "K3b_pcps_wipe_per_channel")
E5B_KERNELS = L2C_MB_KERNELS

# (a)'s conf: phase 4's conditioner and the L2C chain alone (no 1C channel:
# the factory then drops the GPS L1 chain, as JAX's does)
L2C_CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=4000000
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.number_of_taps=31
InputFilter.cutoff=0.45
InputFilter.decimation_factor=2
InputFilter.IF=0
Resampler.implementation=Pass_Through
Channels_2S.count=8
Channels.in_acquisition=8
Acquisition_2S.implementation=GPS_L2_M_PCPS_Acquisition
Tracking_2S.implementation=GPS_L2_M_DLL_PLL_Tracking
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


def l2c_satellites(ephs, dur: float, cn0: float):
    """GPS L2C CM signals: CNAV at 25 bps (one 50-sps symbol per 20 ms code
    epoch) from T0, MT 10, 11, 30 cycling."""
    from gnss_sim_receiver_tpu_torch.nav import cnav
    n_rep = int(np.ceil((dur + 36.0) / 36.0))
    return offband_satellites(
        ephs, rx_true_ecef(), T0, dur, cn0, "2S", F_L2,
        lambda e: (2 * cnav.symbols_for_ephemeris(
            e, T0, n_repeats=n_rep, bps=25.0) - 1).astype(np.int8))


def e5b_satellites(ephs, dur: float, cn0: float):
    """Galileo E5b-I signals: I/NAV pages from T0 spread by CS4 as per-epoch
    signs (nav.inav.e5b_epoch_signs)."""
    from gnss_sim_receiver_tpu_torch.nav import inav
    n_rep = int(np.ceil((dur + 12.0) / (5 * inav.PAGE_SECONDS)))
    return offband_satellites(
        ephs, rx_true_ecef(), T0, dur, cn0, "7X", F_E5B,
        lambda e: inav.e5b_epoch_signs(
            inav.pages_for_ephemeris(e, t0_gst_s=T0, n_repeats=n_rep)))


def l2c_ephemerides():
    """Phase 4's six satellites with toe = toc = T0, on both CNAV's 300 s
    grid and LNAV's 16 s one (multiband_sats)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    return [dataclasses.replace(e, toe=T0, toc=T0)
            for e in make_sky_constellation(RX_LLH[0], RX_LLH[1], toe=T0)
            if e.prn in SCENARIO_PRNS]


def l2c_multiband_sats():
    """(b)'s sky: phase 4's six satellites on L1 C/A (47 dB-Hz) and four of
    them, L2C_MB_PRNS, on L2C (45 dB-Hz); one ephemeris each."""
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = l2c_ephemerides()
    l1 = build_static_scenario(ephs, rx_true_ecef(), T0, L2C_MB_DUR,
                               cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    l2 = l2c_satellites([e for e in ephs if e.prn in L2C_MB_PRNS],
                        L2C_MB_DUR, L2C_CN0)
    return {e.prn: e for e in ephs}, l1, l2


def e5b_sky():
    """(c)'s sky: the hybrid sky's GPS satellites on L1 C/A (LNAV, 48 dB-Hz)
    and its Galileo satellites on E5b-I (48 dB-Hz)."""
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    gps, gal = hybrid_ephemerides()
    l1 = build_static_scenario(gps, rx_true_ecef(), T0, E5B_DUR,
                               cn0_db_hz=48.0, subframe_cycle=(1, 2, 3))
    return gal, l1, e5b_satellites(gal, E5B_DUR, 48.0)


def l1_chain_4msps():
    """GPS L1 C/A on RF 0 at 4 Msps, 8 channels, acquisition on the x2
    mean-pooled stream (phase 11's L1 chain at half its rate)."""
    from gnss_sim_receiver_tpu_torch.models.acquisition import AcqConf
    from gnss_sim_receiver_tpu_torch.models.receiver import SignalChainConf
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingConf
    dec = int(FS_L2C_MB // FS)
    return SignalChainConf(
        signal="1C", system="GPS", prns=tuple(range(1, 11)),
        n_channels=MB_CHANNELS, max_acq_channels=MB_CHANNELS,
        acq=AcqConf(fs_in=FS_L2C_MB / dec, max_dwells=2),
        trk=TrackingConf(fs=FS_L2C_MB), acq_decim=dec)


def l2c_multiband_conf():
    """(b)'s receiver: l1_chain_4msps on RF 0 and gps_l2c_chain at 4 Msps on
    RF 1 (8 channels, assist-gated), observables every 100 ms."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.receiver import (ReceiverConf,
                                                             gps_l2c_chain)
    l2 = dataclasses.replace(
        gps_l2c_chain(FS_L2C_MB, prns=SCENARIO_PRNS, n_channels=MB_CHANNELS),
        rf_channel_id=1)
    return ReceiverConf(fs=FS_L2C_MB, prns=tuple(range(1, 11)),
                        gps_chain=False, rf_fs={1: FS_L2C_MB},
                        chains=(l1_chain_4msps(), l2),
                        output_rate_ms=L2C_MB_INTERVAL_MS)


def e5b_conf():
    """(c)'s receiver: l1_chain_4msps on RF 0 and galileo_e5b_chain at
    20 Msps on RF 1 (10 channels; no other Galileo band, so its assist gate
    stays open and it searches cold), with the doubled FFT (CS4 flips the
    sign at code epochs, and a 1 ms dwell cut by a flip puts the Doppler
    peak off; phase 7's note) and E5B_DWELLS dwells."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.receiver import (
        ReceiverConf, galileo_e5b_chain)
    e5b = dataclasses.replace(
        galileo_e5b_chain(FS_E5B, n_channels=E5B_CHANNELS), rf_channel_id=1)
    e5b.acq = dataclasses.replace(e5b.acq, bit_transition_flag=True,
                                  max_dwells=E5B_DWELLS)
    return ReceiverConf(fs=FS_L2C_MB, prns=tuple(range(1, 11)),
                        gps_chain=False, rf_fs={1: FS_E5B},
                        chains=(l1_chain_4msps(), e5b))


def search_dwells(sats, fs: float, eng, seed: int, dev):
    """`eng`'s M dwells of N samples of the sky `sats` at `fs`, made by K6
    with noise from `seed` on `dev` ([M, N])."""
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    m, n = eng.conf.max_dwells, eng.fft_size
    return generate_baseband_device_resident(
        sats, fs, m * n, noise=True, seed=seed, device=dev).reshape(m, n)


def peak_case(rows: list, extra: list, x, table, t, cfc, label: str,
              name=None) -> None:
    """K3's peak (k3_peak_row) on the correlations of the dwells `x` wiped
    by `table`: a row named `name` into `rows`, without a name into
    `extra`."""
    import torch
    from gnss_sim_receiver_tpu_torch.ops import pcps
    spec = torch.fft.fft(pcps.pcps_wipe(x, table, t), dim=-1)
    if table.dim() == 1:
        spec = spec[:, None]
    corr = torch.fft.ifft(spec * cfc[None, :, None], dim=-1)
    del spec
    row = k3_peak_row(corr, x.shape[0], label, 3)
    del corr
    torch.cuda.empty_cache()
    if name is None:
        extra.append(row)
    else:
        row["name"] = name
        rows.append(row)


def check_l2c_e5b_shapes(dev, card: str, rows: list, extra: list) -> None:
    """Phase 3 at phase 14's new shapes, each against its plain version
    with its kernel's tolerance (the wipeoff also bit for bit its Triton
    reference and the searches after it, wipe_case); rows named with
    _L2C and _E5b go to `rows`, the others to `extra`:
    - (a)'s cold L2C search at 2 Msps (gps_l2c_chain: one 20 ms dwell, the
      doubled FFT of bit_transition_flag, 60 Hz steps over +-5 kHz): the
      K3 wipeoff and K3's peak at M=1, C=8 (PRNs 1-8), D=168, N=80000 on
      (a)'s sky made by K6; the whole two-step search timed and its peak
      memory read (torch.cuda.max_memory_allocated above what is held,
      the cuFFT plans' workspace included); step two's K3b (D2=9, 15 Hz)
      and K3's peak there;
    - (b)'s assisted L2C search at 4 Msps: K3b and K3's peak at M=1, C=8,
      D2=9 (62.5 Hz), N=160000, the whole pcps_search_assisted against its
      plain composition;
    - (c)'s cold E5b search at 20 Msps: the wipeoff, K3b and K3's peak at
      M=8 (E5B_DWELLS), C=10, D=41 and D2=9, N=40000;
    - the chunk kernel at (a)'s shape (C=8, 40000 samples an epoch, the
      path's chunk T=50) and at (b)'s (4 Msps, 80000 samples an epoch);
    - K8a, K8b, K1 with both and the two-launch chunk at (b)'s L2C shape
      (4 Msps, C=8, E=2) and at its L1 chain's (GPS L1 C/A at 4 Msps,
      C=8, E=20); the same with E5b-I's code table at phase 7's shape
      (20 Msps, C=10, E=20);
    - K6 on (a)'s and (c)'s E5b skies."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.receiver import (
        galileo_e5b_chain, gps_l2c_chain)
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingConf
    from gnss_sim_receiver_tpu_torch.ops import pcps, prn_codes
    rng = np.random.default_rng(14)
    l2c_sats = l2c_satellites(l2c_ephemerides(), L2C_DUR, L2C_CN0)

    # (a)'s cold search and its step two
    l2c = gps_l2c_chain(FS, n_channels=L2C_CHANNELS)
    eng = PcpsAcquisitionEngine(l2c.acq, tuple(range(1, L2C_CHANNELS + 1)),
                                code_provider=l2c.code_provider,
                                sc_rate=l2c.sc_rate, device=dev)
    x = search_dwells(l2c_sats, FS, eng, 53, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = f"(a)'s cold L2C search at {FS / 1e6:g} Msps"
    row = wipe_case(x, eng.dopplers, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3_pcps_wipe_L2C"
    rows.append(row)
    peak_case(rows, extra, x, eng.dopplers, eng._t, cfc, label,
              "K3_pcps_peak_L2C")
    search = (lambda: pcps.pcps_search_two_steps(
        x, cfc, eng.dopplers, eng._t, two_steps=True,
        n_side=int(l2c.acq.num_doppler_bins_step2),
        step2=float(l2c.acq.doppler_step2), **eng._statistic()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.backends.cuda.cufft_plan_cache.clear()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    buf = search()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
    del buf
    search_ms = time_ms(search, reps=3)
    print(f"  the cold L2C search (M=1, C={cfc.shape[0]}, "
          f"D={eng.dopplers.shape[0]}, N={eng.fft_size}, both steps, one "
          f"packed buffer): {search_ms:.4f} ms, peak memory {peak_mb:.1f} MB "
          f"above the {held / 1e6:.0f} MB held ({card})")
    extra.append(dict(name="L2C_cold_search", route="cuda+cufft",
                      ms=search_ms, peak_mb=peak_mb,
                      shape=f"M=1, C={cfc.shape[0]}, D="
                            f"{eng.dopplers.shape[0]}, N={eng.fft_size}, "
                            "two steps"))
    torch.cuda.empty_cache()
    table = narrow_table(eng)
    label2 = f"(a)'s L2C step two at {FS / 1e6:g} Msps"
    row = wipe_case(x, table, eng._t, label2, k3_search(cfc, m), 3)
    row["name"] = "K3b_pcps_wipe_per_channel_L2C"
    rows.append(row)
    peak_case(rows, extra, x, table, eng._t, cfc, label2)
    del x
    torch.cuda.empty_cache()
    # (b)'s assisted search at 4 Msps
    l2c4 = gps_l2c_chain(FS_L2C_MB, n_channels=L2C_CHANNELS)
    eng = PcpsAcquisitionEngine(l2c4.acq, tuple(range(1, L2C_CHANNELS + 1)),
                                code_provider=l2c4.code_provider,
                                sc_rate=l2c4.sc_rate, device=dev)
    x = search_dwells(l2c_multiband_sats()[2], FS_L2C_MB, eng, 55, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    table = narrow_table(eng, 62.5)
    label = f"(b)'s assisted L2C search at {FS_L2C_MB / 1e6:g} Msps"
    row = wipe_case(x, table, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3b_pcps_wipe_per_channel_assisted_L2C"
    rows.append(row)
    peak_case(rows, extra, x, table, eng._t, cfc, label,
              "K3_pcps_peak_assisted_L2C")
    got = pcps.pcps_search_assisted(x, cfc, table, eng._t)
    stat, di, de = pcps.max_to_input_power_stat(
        pcps.pcps_grid_per_channel(x, cfc, table, FS_L2C_MB), float(m))
    want = torch.stack([stat, torch.gather(table, 1, di.long()[:, None])[:, 0],
                        de.to(torch.float32)])
    torch.cuda.synchronize()
    compare(f"pcps_search_assisted ({label}) statistic", got[0], want[0],
            1e-4)
    compare(f"pcps_search_assisted ({label}) cells", got[1:], want[1:], 0.0)
    del x, got, want, stat, di, de
    torch.cuda.empty_cache()
    # (c)'s cold E5b search at 20 Msps: E5B_DWELLS dwells, doubled FFT
    e5c = e5b_conf().chains[1]
    eng = PcpsAcquisitionEngine(e5c.acq, tuple(range(11, 11 + E5B_CHANNELS)),
                                code_provider=e5c.code_provider,
                                sc_rate=e5c.sc_rate, device=dev)
    x = search_dwells(e5b_sky()[2], FS_E5B, eng, 59, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = f"(c)'s cold E5b search at {FS_E5B / 1e6:g} Msps"
    for table, lab in ((eng.dopplers, label),
                       (narrow_table(eng), label + ", step two")):
        extra.append(wipe_case(x, table, eng._t, lab, k3_search(cfc, m), 3))
        peak_case(rows, extra, x, table, eng._t, cfc, lab)
    del x
    torch.cuda.empty_cache()
    # the chunk kernel at (a)'s shape and at (b)'s L2C chain's
    rows.append(check_epoch_chunk_bits(
        dev, rng, l2c.trk, L2C_CHANNELS, "K9_epoch_chunk_L2C",
        f"GPS L2C CM at {FS / 1e6:g} Msps", 50, chain=l2c))
    torch.cuda.empty_cache()
    l2mb = l2c_multiband_conf().chains[1]
    extra.append(check_epoch_chunk_bits(
        dev, rng, l2mb.trk, L2C_CHANNELS, "K9_epoch_chunk_L2C",
        f"GPS L2C CM at {FS_L2C_MB / 1e6:g} Msps", 50, chain=l2mb))
    torch.cuda.empty_cache()
    # the block step at (b)'s two shapes and with E5b's table at phase 7's
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    taps = (0.25, 0.0, -0.25)
    gps4 = TrackingConf(fs=FS_L2C_MB)
    e5b = galileo_e5b_chain(FS_E5B, n_channels=E5B_CHANNELS).trk
    for conf_, c_, prov, n_wins, suffix, lab in (
            (l2c4.trk, L2C_CHANNELS, l2c4.code_provider, 50, "_L2C",
             f"GPS L2C CM at {FS_L2C_MB / 1e6:g} Msps"),
            (gps4, MB_CHANNELS, prn_codes.gps_l1_ca_code, 1000, "_4Msps",
             f"GPS L1 C/A at {FS_L2C_MB / 1e6:g} Msps"),
            (e5b, E5B_CHANNELS, signals.CodeProvider("7X"), 1000, "_E5b",
             f"Galileo E5b-I at {FS_E5B / 1e6:g} Msps")):
        got = check_k8(dev, rng, conf_, c_, taps, prov, n_wins,
                       tuple(n + suffix for n in k8), lab)
        if suffix == "_4Msps":
            extra += got
        else:
            rows += [got[0], got[3]]
            extra += got[1:3]
        torch.cuda.empty_cache()
        extra.append(check_block_chunk_bits(dev, rng, conf_, c_, taps, prov,
                                            lab))
        torch.cuda.empty_cache()
    # K6 on the new skies
    for fs, sats, dur, seed, name, lab in (
            (FS_FILE, l2c_sats, L2C_DUR, 51, "K6_device_generator_L2C",
             f"(a)'s L2C sky at {FS_FILE / 1e6:g} Msps"),
            (FS_E5B, e5b_sky()[2], E5B_DUR, 57, "K6_device_generator_E5b",
             f"(c)'s E5b sky at {FS_E5B / 1e6:g} Msps")):
        row = check_k6(dev, fs, sats, dur, seed, lab)
        row["name"] = name
        rows.append(row)
        torch.cuda.empty_cache()


def shape_counts() -> tuple:
    """The wipeoff's and K3's peak's launch counters by shape, copied."""
    from gnss_sim_receiver_tpu_torch.ops import pcps
    return (collections.Counter(pcps.pcps_wipe.shapes),
            collections.Counter(pcps.pcps_peak.shapes))


def block_counts(f: int, e: int) -> tuple:
    """(K8a launches, folded K1 launches) at FFT length `f` and E = `e`
    since the shape counters were cleared."""
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    pro = sum(v for s, v in tb.block_prologue.shapes.items()
              if s[1] == e and s[2] == f)
    fold = sum(v for s, v in tb.block_correlate_close.fold_shapes.items()
               if s[1] == e and s[2] == f)
    return pro, fold


def l2c_path(root: str, wrappers, card: str) -> dict:
    """Phase 14(a): L2C alone through the CLI.  K6 makes (a)'s sky (phase
    4's six satellites on L2C CM, 45 dB-Hz, CNAV at 25 bps, toe = toc =
    T0) at 4 Msps for L2C_DUR seconds and it is written as ishort (its
    launches counted apart); the counters are set to 0 just before
    run_cli(L2C_CONF) and read just after.  Checks: the cold search on the
    L2C grid (the wipeoff at M=1, D=168, N=80000, K3's peak there, K3b at
    step two) and no assisted one, phase 4's tracked set, >= 5 CNAV
    ephemerides, >= 5 fixes with 2D < 2 m and 3D < 5 m, every chunk on
    the chunk kernel and none on the block kernels (decim 1 at the 20 ms
    interval); the real-time factor printed."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = os.path.join(root, "build", "l2c_scenario_54s_4msps_v1.ishort")
    sats = l2c_satellites(l2c_ephemerides(), L2C_DUR, L2C_CN0)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(sats, FS_FILE,
                                          int(FS_FILE * L2C_DUR), noise=True,
                                          seed=51, device="cuda")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_samples(path, x, "ishort", scale=200.0)
    del x
    torch.cuda.empty_cache()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ishort "
          f"at {FS_FILE / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    conf = os.path.join(root, "build", "chip_smoke_l2c.conf")
    with open(conf, "w") as fh:
        fh.write(L2C_CONF.format(capture=path))
    shapes0 = shape_counts()
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, L2C_KERNELS)
    os.remove(path)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    run = res.run
    check_run(run, min_fixes=5)
    n_eph = len(run.ephemerides)
    print(f"  CNAV ephemerides of PRNs {sorted(run.ephemerides)}")
    if n_eph < 5:
        fail(f"{n_eph} CNAV ephemerides")
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    n = 2 * int(round(FS * 0.02))
    cold = sum(v for s, v in wipe.items() if len(s) == 3 and s[0] == 1
               and s[-1] == n and s[1] == 168)
    step2 = sum(v for s, v in wipe.items() if len(s) == 4 and s[0] == 1
                and s[2] == 9 and s[-1] == n)
    cold_peak = sum(v for s, v in peak.items() if s[2] == 168 and s[-1] == n)
    print(f"  the wipeoff by shape {dict(wipe)}, K3's peak {dict(peak)}")
    if not (cold and step2 and cold_peak == cold):
        fail(f"(a) did not search cold on the L2C grid: {dict(wipe)}")
    blocks = [launches[k] for k in ("K1_block_correlate",
                                    "K8a_block_prologue",
                                    "K1_K8b_K8a_block_step")]
    if any(blocks):
        fail(f"(a) launched the block kernels {blocks} at decim 1")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  K9's chunk kernel: {launches['K9_epoch_chunk']} launches, "
          f"{launches['K9_epoch_chunk_epochs']} epochs; seconds: read "
          f"{sec['read']:.3f}, upload and conditioning {sec['condition']:.3f}"
          f", receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{L2C_DUR:.0f} s of signal: real-time factor "
          f"{L2C_DUR / wall:.3f} ({card})")
    launches.update({"K6_device_generator": k6["K6_device_generator"],
                     "K6_device_generator_L2C": k6["K6_device_generator"],
                     "K3_pcps_wipe_L2C": cold, "K3_pcps_peak_L2C": cold_peak,
                     "K3b_pcps_wipe_per_channel_L2C": step2,
                     "K9_epoch_chunk_L2C": launches["K9_epoch_chunk"]})
    return launches


def band_pr_diffs(run, epoch_prns, n1: int) -> dict:
    """PRN -> [PR_band2 - PR_band1] at the observation epochs where both of
    its channels are valid: channels [0, n1) the first band's, the rest
    the second's, `epoch_prns` each epoch's channel -> PRN map."""
    diffs = collections.defaultdict(list)
    for ep, prns in zip(run.observation_epochs, epoch_prns):
        for c2 in range(n1, len(prns)):
            prn = prns[c2]
            if not ep.valid[c2] or prn not in prns[:n1]:
                continue
            c1 = prns[:n1].index(prn)
            if ep.valid[c1]:
                diffs[prn].append(ep.pseudorange_m[c2] - ep.pseudorange_m[c1])
    return diffs


def logged_session(conf, ephemerides=None):
    """A session of `conf` whose observation epochs are logged with the
    channel -> PRN map the session holds when each is formed."""
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    return log_epochs(Receiver(conf).start_session(ephemerides=ephemerides))


def log_epochs(session):
    """`session` with its observation epochs logged in
    session.epoch_prns, each with the channel -> PRN map it was formed
    under."""
    session.epoch_prns = []
    solve = session._solve

    def solve_logged(bound):
        n0 = len(session.obs_epochs)
        prns = [c.prn for rt in session.chains for c in rt.mgr.channels]
        solve(bound)
        session.epoch_prns.extend([prns] * (len(session.obs_epochs) - n0))
    session._solve = solve_logged
    return session


def assisted_session(wrappers, conf, arrays: dict, ephs, kernels,
                     fs2: float) -> tuple:
    """One run of `conf` through attach_arrays(arrays) + run_to_end,
    warm-started with `ephs` (logged_session): the counters set to 0 just
    before and read just after; each assisted search's window (seconds at
    the assisted chain's rate `fs2`) and centres logged.  Returns
    (session, run, launches, windows, wall seconds, the wipeoff's and K3's
    peak's launches by shape in the run); the block step's shape counters
    hold the run's alone."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    windows = []
    assisted = PcpsAcquisitionEngine.acquire_assisted

    def acquire_assisted(self, x, start, centers, *a, **k):
        windows.append((start / fs2, list(centers)))
        return assisted(self, x, start, centers, *a, **k)
    PcpsAcquisitionEngine.acquire_assisted = acquire_assisted
    shapes0 = shape_counts()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    try:
        session = logged_session(conf, dict(ephs))
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.attach_arrays(arrays)
        session.run_to_end()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        PcpsAcquisitionEngine.acquire_assisted = assisted
    launches = read_launches(wrappers, kernels)
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    return session, session.result(), launches, windows, wall, wipe, peak


def check_assisted_centres(session, windows, l1_sats, f_ratio: float,
                           sig: str, tracked=None,
                           primary: str = "L1") -> None:
    """The secondary band `sig`'s searches: every one assisted (none
    cold), each centre within 50 Hz of the true Doppler of the `primary`
    band (`l1_sats`) at its window x `f_ratio`
    (tests/test_assisted_acq.py's bound), and with `tracked` each tracked
    PRN among the assisted detections."""
    print(f"  searches {dict(session.searches)}; assist log "
          f"{session.assist_log}")
    if session.searches[(sig, "cold")] or not session.assist_log:
        fail(f"{sig} searches: {dict(session.searches)}")
    truth = {s.prn: s for s in l1_sats}
    centers = [(t_win, c) for t_win, cs in windows for c in cs]
    if len(centers) != len(session.assist_log):
        fail(f"{len(centers)} assisted centres, {len(session.assist_log)} "
             "log entries")
    worst = 0.0
    for (t_win, c), (_, prn, center, _) in zip(centers, session.assist_log):
        sat = truth[prn]
        want = f_ratio * (sat.doppler_hz + sat.doppler_rate_hz_s * t_win)
        worst = max(worst, abs(center - want))
    print(f"  {len(session.assist_log)} assisted searches; the largest "
          f"centre error against the true {primary} Doppler x "
          f"f_{sig}/f_{primary} {worst:.3f} Hz")
    if worst >= MB_ASSIST_TOL_HZ:
        fail(f"an assisted centre {worst:.3f} Hz off the scaled {primary} "
             "Doppler")
    if tracked is not None:
        detected = {p for s, p, _, d in session.assist_log
                    if s == sig and d}
        if not set(tracked) <= detected:
            fail(f"{sig} PRNs {tracked} tracked, assisted detections "
                 f"{detected}")


def l2c_multiband_path(wrappers, card: str) -> dict:
    """Phase 14(b): L1 C/A + L2C on two RF streams at 4 Msps, as phase 11
    builds its receiver (warm-started with the sky's ephemerides).  K6
    makes both streams of (b)'s sky once (its launches counted apart);
    two runs on them, each with the counters set to 0 just before
    attach_arrays({0: L1, 1: L2C}) + run_to_end and read just after:
    - at a 100 ms observable interval, the L2C blocks on the block step at
      E = 2 (checked by its launches at L2C's F and E), every L2C search
      assisted within 50 Hz, L1 on phase 4's six and the position.  There
      the L2C loops lose lock again and again, as JAX's do (ROADMAP.md
      queue 3): their loss-of-lock events and their last Dopplers are
      printed, not held;
    - at the default 20 ms interval (decim 1, the chunk kernel): the same
      checks, L2C on its four PRNs, each L2C channel's Doppler within 1 Hz
      of its L1 channel's x f_L2 / f_L1 (the mean over the last second of
      observation epochs), CNAV decoded on each, |PR_L2 - PR_L1| < 30 m
      and a fix of both bands."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import (ChannelEvent,
                                                            ChannelState)
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    ephs, l1_sats, l2_sats = l2c_multiband_sats()
    reset(wrappers)
    n = int(FS_L2C_MB * L2C_MB_DUR)
    x1 = generate_baseband_device_resident(l1_sats, FS_L2C_MB, n, noise=True,
                                           seed=61, device="cuda")
    x2 = generate_baseband_device_resident(l2_sats, FS_L2C_MB, n, noise=True,
                                           seed=62, device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    conf = l2c_multiband_conf()
    n1 = conf.chains[0].n_channels
    f_ratio = F_L2 / 1_575.42e6
    n2 = PcpsAcquisitionEngine(conf.chains[1].acq, (1,), device="cuda"
                               ).fft_size
    f2 = tb.block_fft_size(conf.chains[1].trk)

    def tracked(run):
        states = list(zip(run.channel_prns, run.channel_states))
        return [sorted(p for p, s in part if s == ChannelState.TRACKING)
                for part in (states[:n1], states[n1:])]

    # the block step at E = 2
    print(f"  (b1) observables every {L2C_MB_INTERVAL_MS} ms: L2C decim "
          f"{min(L2C_MB_INTERVAL_MS, 90) // 20} on the block step at E = 2",
          flush=True)
    session, run, launches, windows, wall, _, _ = assisted_session(
        wrappers, conf, {0: x1, 1: x2}, ephs, L2C_MB_KERNELS, FS_L2C_MB)
    l1_trk, l2_trk = tracked(run)
    check_assisted_centres(session, windows, l1_sats, f_ratio, "2S")
    if l1_trk != list(SCENARIO_PRNS):
        fail(f"tracked L1 {l1_trk}, expected {list(SCENARIO_PRNS)}")
    check_run_position(run, min_fixes=5)
    pro, fold = block_counts(f2, 2)
    rt2 = session.chains[1]
    lost = sum(1 for c, ev in run.events
               if c >= n1 and ev == ChannelEvent.TRK_LOST)
    print(f"  the L2C block step at E=2, F={f2}: K8a {pro}, folds {fold}; "
          f"L2C tracks {l2_trk} at the end after {lost} losses of lock, CNAV "
          f"messages {[sorted(st.msgs) for st in rt2.tlm.ch]} (reproduced: "
          f"JAX's block step at E = 2 holds no L2C lock either)")
    if not (pro and fold):
        fail("(b1) did not run the L2C blocks on the block step at E = 2")
    print(f"  wall {wall:.3f} s for {L2C_MB_DUR:.0f} s of two RF streams: "
          f"real-time factor {L2C_MB_DUR / wall:.3f} ({card})")
    block_launches = {"K8a_block_prologue_L2C": pro,
                      "K1_K8b_K8a_block_step_L2C": fold}
    torch.cuda.empty_cache()
    # the chunk kernel at the default interval
    print("  (b2) observables every 20 ms: L2C decim 1 on the chunk kernel",
          flush=True)
    conf = dataclasses.replace(conf, output_rate_ms=20, obs=None)
    session, run, launches, windows, wall, wipe, peak = assisted_session(
        wrappers, conf, {0: x1, 1: x2}, ephs, L2C_KERNELS[:4], FS_L2C_MB)
    del x1, x2
    torch.cuda.empty_cache()
    l1_trk, l2_trk = tracked(run)
    print(f"  L1 tracks {l1_trk}, L2C tracks {l2_trk}")
    if l1_trk != list(SCENARIO_PRNS) or l2_trk != list(L2C_MB_PRNS):
        fail(f"tracked L1 {l1_trk}, L2C {l2_trk}: expected "
             f"{list(SCENARIO_PRNS)} and {list(L2C_MB_PRNS)}")
    check_assisted_centres(session, windows, l1_sats, f_ratio, "2S", l2_trk)
    # each L2C channel's Doppler against its L1 channel's, the mean over
    # the last second of observation epochs where both are valid
    rt2 = session.chains[1]
    cnav = {ch.prn: sorted(rt2.tlm.ch[c].msgs)
            for c, ch in enumerate(rt2.mgr.channels)
            if ch.state == ChannelState.TRACKING}
    pairs = collections.defaultdict(list)
    for ep, prns in zip(run.observation_epochs, session.epoch_prns):
        for c2 in range(n1, len(prns)):
            if ep.valid[c2] and prns[c2] in prns[:n1]:
                c1 = prns[:n1].index(prns[c2])
                if ep.valid[c1]:
                    pairs[prns[c2]].append(
                        ep.carrier_doppler_hz[c2]
                        - ep.carrier_doppler_hz[c1] * f_ratio)
    last = 1000 // 20
    errs = {p: float(np.mean(d[-last:])) for p, d in pairs.items()}
    print(f"  L2C Doppler - L1 Doppler x f_L2/f_L1 over the last second by "
          f"PRN {errs} Hz; CNAV messages decoded by PRN {cnav}")
    if sorted(errs) != list(L2C_MB_PRNS) or any(
            len(pairs[p]) < last or abs(v) >= L2C_DOPPLER_TOL_HZ
            for p, v in errs.items()):
        fail(f"L2C Dopplers off the scaled L1 ones: {errs}")
    if sorted(p for p, m in cnav.items() if m) != list(L2C_MB_PRNS):
        fail(f"CNAV decoded on {cnav}")
    check_run_position(run, min_fixes=5)
    both = [s for s in run.solutions if s.used_channels is not None
            and (s.used_channels < n1).any()
            and (s.used_channels >= n1).any()]
    diffs = band_pr_diffs(run, session.epoch_prns, n1)
    worst_pr = {p: float(np.abs(d).max()) for p, d in diffs.items()}
    print(f"  {len(both)} of {len(run.solutions)} fixes use both bands; "
          f"max |PR_L2 - PR_L1| by PRN {worst_pr} m")
    if not both or sorted(diffs) != list(L2C_MB_PRNS) \
            or max(worst_pr.values()) >= MB_PR_TOL_M:
        fail(f"both-band fixes {len(both)}, L2C against L1 pseudoranges "
             f"{worst_pr}")
    k3b = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n2)
    k3 = sum(v for s, v in peak.items() if s[2] == 9 and s[-1] == n2)
    print(f"  assisted shape: K3b {k3b} launches at N={n2}, K3's peak {k3}; "
          f"K9's chunk kernel {launches['K9_epoch_chunk']} launches, "
          f"{launches['K9_epoch_chunk_epochs']} epochs (both chains' tails)")
    if not (k3b and k3 == k3b):
        fail("(b2) did not launch K3b and K3 at the assisted shape")
    print(f"  wall {wall:.3f} s for {L2C_MB_DUR:.0f} s of two RF streams: "
          f"real-time factor {L2C_MB_DUR / wall:.3f} ({card})")
    launches.update({
        "K6_device_generator": k6["K6_device_generator"],
        "K3b_pcps_wipe_per_channel_assisted_L2C": k3b,
        "K3_pcps_peak_assisted_L2C": k3, **block_launches})
    return launches


def e5b_path(wrappers, card: str) -> dict:
    """Phase 14(c): GPS L1 C/A on RF 0 at 4 Msps and Galileo E5b-I on RF 1
    at 20 Msps, E5B_DUR seconds of (c)'s sky made by K6 (the E5b stream's
    launches counted apart), through attach_arrays + run_to_end from a
    cold start (no ephemerides).  Checks: E5b searched cold, phase 5's
    checks (GPS PRNs 1, 3, 4, 5 and Galileo PRNs 11-15 tracked, their
    LNAV and I/NAV ephemerides, >= 5 fixes, the last with >= 7
    satellites, 2D < 2 m, 3D < 5 m), the E5b blocks on the block step."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    gal, l1_sats, e5b_sats = e5b_sky()
    print(f"  the sky's BGD(E1,E5b) by Galileo PRN "
          f"{ {e.prn: e.bgd_e1e5b for e in gal} } s")
    reset(wrappers)
    x1 = generate_baseband_device_resident(
        l1_sats, FS_L2C_MB, int(FS_L2C_MB * E5B_DUR), noise=True, seed=71,
        device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    reset(wrappers)
    x2 = generate_baseband_device_resident(
        e5b_sats, FS_E5B, int(FS_E5B * E5B_DUR), noise=True, seed=57,
        device="cuda")
    torch.cuda.synchronize()
    k6_e5b = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    conf = e5b_conf()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    session = logged_session(conf)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.attach_arrays({0: x1, 1: x2})
    session.run_to_end()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, E5B_KERNELS)
    run = session.result()
    del x1, x2
    torch.cuda.empty_cache()
    print(f"  searches {dict(session.searches)}")
    if not session.searches[("7X", "cold")] \
            or session.searches[("7X", "assisted")]:
        fail(f"E5b did not search cold alone: {dict(session.searches)}")
    check_hybrid_run(run)
    f2 = tb.block_fft_size(conf.chains[1].trk)
    pro, fold = block_counts(f2, 20)
    print(f"  the E5b block step at E=20, F={f2}: K8a {pro}, folds {fold}")
    if not (pro and fold):
        fail("(c) did not run E5b's blocks on the block step")
    print(f"  wall {wall:.3f} s for {E5B_DUR:.0f} s of two RF streams: "
          f"real-time factor {E5B_DUR / wall:.3f} ({card})")
    launches.update({"K6_device_generator": k6 + k6_e5b,
                     "K6_device_generator_E5b": k6_e5b,
                     "K8a_block_prologue_E5b": pro,
                     "K1_K8b_K8a_block_step_E5b": fold})
    return launches


# ---- phase 15: the BeiDou B1I and B3I chains --------------------------------

F_B1 = 1_561.098e6
F_B3 = 1_268.52e6
# phase 4's six satellites as BeiDou MEO/IGSO PRNs, D1 (the chains' default
# PRNs are 6-30: 1-5 are GEO and broadcast D2), on phase 4's geometry with
# toe = toc = T0, TGD1 = 0 (the D1 decoder gives any band tgd = TGD1, so a
# B3I fix would carry a B1I group delay: ROADMAP.md queue 3).  SOW = T0
# at the first bit: no BDT - GPST offset, in JAX neither (queue 3)
BDS_PRNS = (6, 8, 11, 14, 19, 23)
# (a): B1I alone through the CLI: 8 Msps ishort through phase 4's x2 FIR,
# so 4 Msps keep B1I's 2.046 MHz main lobe; 36.5 s: a channel feeds the
# observables 2.6 s after its acquisition (the settle gate) and its D1
# ephemeris needs subframes 1-3 after two preambles (an 18 s frame); the
# half second puts the capture off K6's 2048-sample tiles, so that its
# last launch ends in a partial tile (check_k6 holds that tile)
FS_B1_FILE = 8_000_000.0
FS_B1 = 4_000_000.0
B1_DUR = 36.5
B1_CN0 = 46.0
B1_CHANNELS = 8
# Acquisition_B1.max_dwells: at the chain's 2 dwells of 1 ms (doubled), 7
# of 72 searches of the sky at 46 dB-Hz put the Doppler 300 to 362 Hz off
# (8 of 72 in JAX, up to 382 Hz), past the decision-directed FLL's
# +-250 Hz: the channel locks 500 Hz off, as E5b's did (ROADMAP.md queue
# 3).  8 dwells: none of 72 beyond 85 Hz (103 Hz in JAX; CPU counts at
# 4 Msps)
B1_DWELLS = 8
# (b): B1I on RF 0 at 4 Msps + B3I on RF 1 at 12.5 Msps (tests/test_b3i.py's
# rate) on four of the six, 20 s, warm-started: B3I's first D1 subframe
# decodes ~12 s in, so its pseudoranges come from there on
FS_B3 = 12_500_000.0
B3_PRNS = BDS_PRNS[:4]
B13_DUR = 20.0
B3_CHANNELS = 8
# (c): tests/test_d2.py's GEO PRN 2 (D2 at 500 bps, no NH, 48 dB-Hz,
# 1350 Hz) at 8.192 Msps on the per-epoch path with lock_rectify; 31.5 s
# hold the ten pages of a D2 ephemeris (one a 3 s frame) from any start,
# and the tenth of a millisecond more puts the capture off K6's tiles (a
# whole number of milliseconds at 8.192 Msps fills them)
FS_GEO = 8_192_000.0
GEO_PRN = 2
GEO_DOP = 1350.0
GEO_DUR = 31.5001
GEO_CHUNK = 1000
B1_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step", "K9_epoch_chunk",
              "K3_pcps_wipe", "K3_pcps_peak", "K3b_pcps_wipe_per_channel",
              "K5a_fir_decim")
B13_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step",
               "K3_pcps_wipe", "K3_pcps_peak", "K3b_pcps_wipe_per_channel")
GEO_KERNELS = ("K9_epoch_chunk", "K9_epoch_chunk_rectify", "K3_pcps_wipe",
               "K3_pcps_peak", "K3b_pcps_wipe_per_channel")

# (a)'s conf: phase 4's conditioner at 8 Msps and the B1I chain alone
B1_CONF = """\
GNSS-SDR.internal_fs_sps=4000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=8000000
InputFilter.implementation=Freq_Xlating_Fir_Filter
InputFilter.number_of_taps=31
InputFilter.cutoff=0.45
InputFilter.decimation_factor=2
InputFilter.IF=0
Resampler.implementation=Pass_Through
Channels_B1.count=8
Channels.in_acquisition=8
Acquisition_B1.implementation=BEIDOU_B1I_PCPS_Acquisition
Acquisition_B1.max_dwells=8
Tracking_B1.implementation=BEIDOU_B1I_DLL_PLL_Tracking
Observables.implementation=Hybrid_Observables
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


def bds_ephemerides():
    """Phase 4's six satellites as BeiDou ephemerides (BDS_PRNS), toe = toc
    = T0, TGD1 = 0, AODE = AODC = 21 (what the D1 encoder writes)."""
    import dataclasses
    return [dataclasses.replace(e, prn=p, system="BeiDou", tgd=0.0, iode=21,
                                iodc=21)
            for e, p in zip(l2c_ephemerides(), BDS_PRNS)]


def bds_satellites(ephs, dur: float, cn0: float, signal: str, f_c: float):
    """BeiDou `signal` ("B1" or "B3") signals: D1 subframes 1-3 cycling from
    SOW = T0, spread by NH20 as per-epoch signs (nav.dnav)."""
    from gnss_sim_receiver_tpu_torch.nav import dnav
    n_rep = int(np.ceil((dur + 18.0) / 18.0))
    return offband_satellites(
        ephs, rx_true_ecef(), T0, dur, cn0, signal, f_c,
        lambda e: dnav.b1i_epoch_signs(
            dnav.bits_for_ephemeris(e, T0, n_repeats=n_rep)))


def geo_sky():
    """(c)'s sky: tests/test_d2.py's GEO PRN 2 with the D2 pages of its
    ephemeris from BDT 300 s, and that ephemeris."""
    from gnss_sim_receiver_tpu_torch.nav import dnav
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    eph = make_sky_constellation(30.0, 110.0, toe=7200.0)[0]
    eph.prn, eph.system = GEO_PRN, "BeiDou"
    bits = dnav.d2_bits_for_ephemeris(
        eph, t0_bdt_s=300.0, n_frames=int(np.ceil(GEO_DUR / 3.0)) + 1)
    sat = SatelliteSignalParams(prn=GEO_PRN, system="BeiDou", signal="B1",
                                cn0_db_hz=48.0, doppler_hz=GEO_DOP,
                                delay_chips=512.25,
                                nav_bits=dnav.d2_epoch_signs(bits))
    return [sat], eph


def geo_chain():
    """(c)'s chain: beidou_b1i_chain at 8.192 Msps on the GEO PRN, tracking
    as tests/test_d2.py does (40 Hz PLL, no FLL pull-in, lock_rectify)."""
    from gnss_sim_receiver_tpu_torch.models.receiver import beidou_b1i_chain
    return beidou_b1i_chain(FS_GEO, prns=(GEO_PRN,), n_channels=1,
                            lock_rectify=True, enable_fll_pullin=False)


def b13_conf():
    """(b)'s receiver: beidou_b1i_chain at 4 Msps on RF 0 (B1_DWELLS
    dwells, as (a)'s conf) and beidou_b3i_chain at 12.5 Msps on RF 1 on
    the sky's six PRNs, 8 channels each (B3I assist-gated on B1I: a B3I
    channel waits for B1I's lock of its PRN, so PRNs no B1I channel
    tracks would hold it)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.receiver import (
        ReceiverConf, beidou_b1i_chain, beidou_b3i_chain)
    b1 = beidou_b1i_chain(FS_B1, n_channels=B1_CHANNELS)
    b1.acq = dataclasses.replace(b1.acq, max_dwells=B1_DWELLS)
    b3 = dataclasses.replace(
        beidou_b3i_chain(FS_B3, prns=BDS_PRNS, n_channels=B3_CHANNELS),
        rf_channel_id=1)
    return ReceiverConf(fs=FS_B1, gps_chain=False, rf_fs={1: FS_B3},
                        chains=(b1, b3))


def check_rectify_flag(dev, rng) -> dict:
    """K9's rectify form against its plain closure (check_k9, from the edge
    states: channel 2 closes its C/N0 window) at (c)'s shape with C=8, and
    the flag seen on the card: the same inputs through the coherent form
    give channel 2 another carrier-lock value."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    conf = geo_chain().trk
    row = check_k9(dev, rng, conf, 8, "K9_epoch_closure_rectify",
                   f"BeiDou B1I GEO at {FS_GEO / 1e6:g} Msps, rectified lock")
    taps = conf_taps(conf)
    corr = epoch_corr(rng, 8, taps, False, dev)
    sign = np.where(corr[:, 1].real.cpu().numpy() >= 0, 1.0, -1.0)
    st = epoch_state(rng, conf, 8, sign, dev)
    locks = []
    for rectify in (True, False):
        c_ = dataclasses.replace(conf, lock_rectify=rectify)
        planes = trk._empty_planes(3, 8, dev, trk.EPOCH_PLANES)
        new = trk.epoch_closure(c_, corr, trk._epoch_length(c_, st), st,
                                planes, 1)
        locks.append(float(new.carrier_lock[2]))
    torch.cuda.synchronize()
    print(f"  the rectify flag on the card: channel 2's carrier lock "
          f"{locks[0]:.6f} rectified, {locks[1]:.6f} coherent")
    if locks[0] == locks[1]:
        fail("K9's rectify form gave the coherent lock value")
    return row


def check_beidou_shapes(dev, card: str, rows: list, extra: list) -> None:
    """Phase 3 at phase 15's new shapes, each against its plain version
    with its kernel's tolerance (the wipeoff also bit for bit its Triton
    reference and the searches after it, wipe_case); rows named with
    _B1I, _B3I and _rectify go to `rows`, the others to `extra`:
    - (a)'s cold B1I search at 4 Msps (beidou_b1i_chain at B1_DWELLS 1 ms
      dwells, each the doubled FFT of bit_transition_flag, 250 Hz steps
      over +-5 kHz): the wipeoff and K3's peak at M=8, C=8, D=41, N=8000
      on (a)'s sky made by K6, step two's K3b (D2=9, 62.5 Hz) and K3's
      peak; the whole two-step search timed;
    - (b)'s assisted B3I search at 12.5 Msps: K3b and K3's peak at M=2,
      C=8, D2=9, N=25000, the whole pcps_search_assisted against its
      plain composition;
    - (c)'s cold GEO search at 8.192 Msps: the wipeoff, K3b and K3's peak
      at M=2, C=1, D=41, D2=9, N=16384;
    - K9 in its rectify form alone (check_rectify_flag), the chunk kernel
      at (a)'s and (b)'s B1I shape (C=8, 4000 samples an epoch), (b)'s
      B3I one (C=8, 12500) and in the rectify form at (c)'s (8192; C=8:
      the edge states need six channels);
    - K8a, K8b, K1 with both and the two-launch chunk at B1I's and B3I's
      E = 20 shapes (4 and 12.5 Msps, C=8);
    - K6 on (a)'s, (b)'s B3I and (c)'s skies."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.ops import pcps
    rng = np.random.default_rng(15)
    ephs = bds_ephemerides()
    b1_sats = bds_satellites(ephs, B1_DUR, B1_CN0, "B1", F_B1)
    b3_sats = bds_satellites(ephs[:len(B3_PRNS)], B13_DUR, B1_CN0, "B3",
                             F_B3)
    conf = b13_conf()
    b1, b3 = conf.chains

    # (a)'s cold search and its step two
    eng = PcpsAcquisitionEngine(b1.acq, BDS_PRNS + (7, 9),
                                code_provider=b1.code_provider,
                                sc_rate=b1.sc_rate, device=dev)
    x = search_dwells(b1_sats, FS_B1, eng, 81, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = f"(a)'s cold B1I search at {FS_B1 / 1e6:g} Msps"
    row = wipe_case(x, eng.dopplers, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3_pcps_wipe_B1I"
    rows.append(row)
    peak_case(rows, extra, x, eng.dopplers, eng._t, cfc, label,
              "K3_pcps_peak_B1I")
    search = (lambda: pcps.pcps_search_two_steps(
        x, cfc, eng.dopplers, eng._t, two_steps=True,
        n_side=int(b1.acq.num_doppler_bins_step2),
        step2=float(b1.acq.doppler_step2), **eng._statistic()))
    search()
    search_ms = time_ms(search, reps=5)
    print(f"  the cold B1I search (M={m}, C={cfc.shape[0]}, "
          f"D={eng.dopplers.shape[0]}, N={eng.fft_size}, both steps, one "
          f"packed buffer): {search_ms:.4f} ms ({card})")
    extra.append(dict(name="B1I_cold_search", route="cuda+cufft",
                      ms=search_ms,
                      shape=f"M={m}, C={cfc.shape[0]}, D="
                            f"{eng.dopplers.shape[0]}, N={eng.fft_size}, "
                            "two steps"))
    table = narrow_table(eng)
    label2 = f"(a)'s B1I step two at {FS_B1 / 1e6:g} Msps"
    row = wipe_case(x, table, eng._t, label2, k3_search(cfc, m), 3)
    row["name"] = "K3b_pcps_wipe_per_channel_B1I"
    rows.append(row)
    peak_case(rows, extra, x, table, eng._t, cfc, label2)
    del x
    torch.cuda.empty_cache()
    # (b)'s assisted B3I search at 12.5 Msps
    eng = PcpsAcquisitionEngine(b3.acq, BDS_PRNS + (7, 9),
                                code_provider=b3.code_provider,
                                sc_rate=b3.sc_rate, device=dev)
    x = search_dwells(b3_sats, FS_B3, eng, 83, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    table = narrow_table(eng, 62.5)
    label = f"(b)'s assisted B3I search at {FS_B3 / 1e6:g} Msps"
    row = wipe_case(x, table, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3b_pcps_wipe_per_channel_assisted_B3I"
    rows.append(row)
    peak_case(rows, extra, x, table, eng._t, cfc, label,
              "K3_pcps_peak_assisted_B3I")
    got = pcps.pcps_search_assisted(x, cfc, table, eng._t)
    stat, di, de = pcps.max_to_input_power_stat(
        pcps.pcps_grid_per_channel(x, cfc, table, FS_B3), float(m))
    want = torch.stack([stat, torch.gather(table, 1, di.long()[:, None])[:, 0],
                        de.to(torch.float32)])
    torch.cuda.synchronize()
    compare(f"pcps_search_assisted ({label}) statistic", got[0], want[0],
            1e-4)
    compare(f"pcps_search_assisted ({label}) cells", got[1:], want[1:], 0.0)
    del x, got, want, stat, di, de
    torch.cuda.empty_cache()
    # (c)'s cold GEO search at 8.192 Msps
    gchain = geo_chain()
    eng = PcpsAcquisitionEngine(gchain.acq, (GEO_PRN,),
                                code_provider=gchain.code_provider,
                                sc_rate=gchain.sc_rate, device=dev)
    x = search_dwells(geo_sky()[0], FS_GEO, eng, 85, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = f"(c)'s cold GEO B1I search at {FS_GEO / 1e6:g} Msps"
    for table, lab in ((eng.dopplers, label),
                       (narrow_table(eng), label + ", step two")):
        extra.append(wipe_case(x, table, eng._t, lab, k3_search(cfc, m), 3))
        peak_case(rows, extra, x, table, eng._t, cfc, lab)
    del x
    torch.cuda.empty_cache()
    # K9: the rectify form alone, the chunk kernel at the three shapes
    extra.append(check_rectify_flag(dev, rng))
    for conf_, chain, name, lab, path_epochs in (
            (b1.trk, b1, "K9_epoch_chunk_B1I",
             f"BeiDou B1I at {FS_B1 / 1e6:g} Msps", 19),
            (b3.trk, b3, "K9_epoch_chunk_B3I",
             f"BeiDou B3I at {FS_B3 / 1e6:g} Msps", 19),
            (gchain.trk, gchain, "K9_epoch_chunk_rectify",
             f"BeiDou B1I GEO at {FS_GEO / 1e6:g} Msps, rectified lock",
             GEO_CHUNK)):
        rows.append(check_epoch_chunk_bits(dev, rng, conf_, 8, name, lab,
                                           path_epochs, chain=chain))
        torch.cuda.empty_cache()
    # the block step at the B1I and B3I shapes
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    taps = (0.25, 0.0, -0.25)
    for chain, suffix, lab in (
            (b1, "_B1I", f"BeiDou B1I at {FS_B1 / 1e6:g} Msps"),
            (b3, "_B3I", f"BeiDou B3I at {FS_B3 / 1e6:g} Msps")):
        got = check_k8(dev, rng, chain.trk, 8, taps, chain.code_provider,
                       1000, tuple(n + suffix for n in k8), lab)
        rows += [got[0], got[3]]
        extra += got[1:3]
        torch.cuda.empty_cache()
        extra.append(check_block_chunk_bits(dev, rng, chain.trk, 8, taps,
                                            chain.code_provider, lab))
        torch.cuda.empty_cache()
    # K6 on the new skies
    for fs, sats, dur, seed, name, lab in (
            (FS_B1_FILE, b1_sats, B1_DUR, 91, "K6_device_generator_BDS",
             f"(a)'s B1I sky at {FS_B1_FILE / 1e6:g} Msps"),
            (FS_B3, b3_sats, B13_DUR, 93, None,
             f"(b)'s B3I sky at {FS_B3 / 1e6:g} Msps"),
            (FS_GEO, geo_sky()[0], GEO_DUR, 95, None,
             f"(c)'s GEO sky at {FS_GEO / 1e6:g} Msps")):
        row = check_k6(dev, fs, sats, dur, seed, lab)
        if name is None:
            extra.append(row)
        else:
            row["name"] = name
            rows.append(row)
        torch.cuda.empty_cache()


def epoch_shapes(c: int, nominal: int) -> int:
    """The chunk kernel's launches with C channels of `nominal` samples an
    epoch since its shape counter was cleared."""
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    return trk.epoch_chunk.shapes[(c, nominal)]


def b1_path(root: str, wrappers, card: str) -> dict:
    """Phase 15(a): B1I alone through the CLI.  K6 makes (a)'s sky (the six
    BeiDou satellites on B1I, 46 dB-Hz, D1 from SOW = T0) at 8 Msps for
    B1_DUR seconds and it is written as ishort (its launches counted
    apart); the counters are set to 0 just before run_cli(B1_CONF) and
    read just after.  Checks: the cold search on the B1I grid (the wipeoff
    at M=8, D=41, N=8000, K3's peak there, K3b at step two), the six PRNs
    tracked, >= 5 D1 ephemerides, >= 5 fixes with 2D < 2 m and 3D < 5 m,
    the block step at B1I's E = 20 shape and the chunk kernel at B1I's C
    and epoch for the chunk tails; the real-time factor printed."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = os.path.join(root, "build", "b1i_scenario_8msps_v1.ishort")
    sats = bds_satellites(bds_ephemerides(), B1_DUR, B1_CN0, "B1", F_B1)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(
        sats, FS_B1_FILE, int(FS_B1_FILE * B1_DUR), noise=True, seed=91,
        device="cuda")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_samples(path, x, "ishort", scale=200.0)
    del x
    torch.cuda.empty_cache()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ishort "
          f"at {FS_B1_FILE / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    conf = os.path.join(root, "build", "chip_smoke_b1i.conf")
    with open(conf, "w") as fh:
        fh.write(B1_CONF.format(capture=path))
    chain = b13_conf().chains[0]
    eng = PcpsAcquisitionEngine(chain.acq, (6,), device="cuda")
    n, d = eng.fft_size, eng.dopplers.shape[0]
    f1 = tb.block_fft_size(chain.trk)
    shapes0 = shape_counts()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    trk.epoch_chunk.shapes.clear()
    reset(wrappers)
    torch.cuda.synchronize()
    res = run_cli([f"--config_file={conf}"])
    torch.cuda.synchronize()
    launches = read_launches(wrappers, B1_KERNELS)
    os.remove(path)
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    run = res.run
    tracked = sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                     if s == ChannelState.TRACKING)
    print(f"  tracked PRNs {tracked}; D1 ephemerides of "
          f"{sorted(run.ephemerides)}")
    if tracked != list(BDS_PRNS):
        fail(f"tracked B1I PRNs {tracked}, expected {list(BDS_PRNS)}")
    if len(run.ephemerides) < 5:
        fail(f"{len(run.ephemerides)} D1 ephemerides")
    check_run_position(run, min_fixes=5)
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    cold = sum(v for s, v in wipe.items() if len(s) == 3
               and s[0] == B1_DWELLS and s[1] == d and s[-1] == n)
    step2 = sum(v for s, v in wipe.items() if len(s) == 4
                and s[0] == B1_DWELLS and s[-1] == n)
    cold_peak = sum(v for s, v in peak.items() if s[2] == d and s[-1] == n)
    print(f"  the wipeoff by shape {dict(wipe)}, K3's peak {dict(peak)}")
    if not (cold and step2 and cold_peak == cold):
        fail(f"(a) did not search cold on the B1I grid: {dict(wipe)}")
    pro, fold = block_counts(f1, 20)
    k9 = epoch_shapes(B1_CHANNELS, chain.trk.nominal_epoch_samples)
    print(f"  the B1I block step at E=20, F={f1}: K8a {pro}, folds {fold}; "
          f"K9's chunk kernel {k9} launches at C={B1_CHANNELS}, "
          f"{chain.trk.nominal_epoch_samples} samples an epoch")
    if not (pro and fold and k9):
        fail("(a) did not run the B1I shapes of the block step and the "
             "chunk kernel")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{B1_DUR:g} s of signal: real-time factor "
          f"{B1_DUR / wall:.3f} ({card})")
    launches.update({"K6_device_generator": k6["K6_device_generator"],
                     "K6_device_generator_BDS": k6["K6_device_generator"],
                     "K3_pcps_wipe_B1I": cold, "K3_pcps_peak_B1I": cold_peak,
                     "K3b_pcps_wipe_per_channel_B1I": step2,
                     "K8a_block_prologue_B1I": pro,
                     "K1_K8b_K8a_block_step_B1I": fold,
                     "K9_epoch_chunk_B1I": k9})
    return launches


def b13_path(wrappers, card: str) -> dict:
    """Phase 15(b): B1I on RF 0 at 4 Msps and B3I on RF 1 at 12.5 Msps, K6
    making both streams of the sky (B3I on B3_PRNS; its launches counted
    apart), warm-started with the ephemerides (assisted_session: the
    counters set to 0 just before attach_arrays + run_to_end and read just
    after).  Checks: every B3I search assisted, each centre within 50 Hz
    of the true B1I Doppler x f_B3 / f_B1; B1I on the six PRNs, B3I on
    B3_PRNS and on no PRN without a B3I signal; |PR_B3 - PR_B1| < 30 m per
    PRN; a fix of both bands and the position; the launches at B3I's
    shapes (K3b and K3's peak at its assisted N, the block step at its F
    and E = 20, the chunk kernel at its C and epoch)."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    ephs = bds_ephemerides()
    b1_sats = bds_satellites(ephs, B13_DUR, B1_CN0, "B1", F_B1)
    b3_sats = bds_satellites(ephs[:len(B3_PRNS)], B13_DUR, B1_CN0, "B3",
                             F_B3)
    reset(wrappers)
    x1 = generate_baseband_device_resident(
        b1_sats, FS_B1, int(FS_B1 * B13_DUR), noise=True, seed=92,
        device="cuda")
    x2 = generate_baseband_device_resident(
        b3_sats, FS_B3, int(FS_B3 * B13_DUR), noise=True, seed=93,
        device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    conf = b13_conf()
    n1 = conf.chains[0].n_channels
    b3 = conf.chains[1]
    n2 = PcpsAcquisitionEngine(b3.acq, (6,), device="cuda").fft_size
    f2 = tb.block_fft_size(b3.trk)
    trk.epoch_chunk.shapes.clear()
    session, run, launches, windows, wall, wipe, peak = assisted_session(
        wrappers, conf, {0: x1, 1: x2},
        {("BeiDou", e.prn): e for e in ephs}, B13_KERNELS, FS_B3)
    del x1, x2
    torch.cuda.empty_cache()
    states = list(zip(run.channel_prns, run.channel_states))
    b1_trk, b3_trk = [sorted(p for p, s in part if s == ChannelState.TRACKING)
                      for part in (states[:n1], states[n1:])]
    print(f"  B1I tracks {b1_trk}, B3I tracks {b3_trk}")
    if b1_trk != list(BDS_PRNS) or b3_trk != list(B3_PRNS):
        fail(f"tracked B1I {b1_trk}, B3I {b3_trk}: expected "
             f"{list(BDS_PRNS)} and {list(B3_PRNS)}")
    check_assisted_centres(session, windows, b1_sats, F_B3 / F_B1, "B3",
                           b3_trk, primary="B1")
    check_run_position(run, min_fixes=5)
    both = [s for s in run.solutions if s.used_channels is not None
            and (s.used_channels < n1).any()
            and (s.used_channels >= n1).any()]
    diffs = band_pr_diffs(run, session.epoch_prns, n1)
    worst_pr = {p: float(np.abs(d).max()) for p, d in diffs.items()}
    print(f"  {len(both)} of {len(run.solutions)} fixes use both bands; "
          f"max |PR_B3 - PR_B1| by PRN {worst_pr} m")
    if not both or sorted(diffs) != list(B3_PRNS) \
            or max(worst_pr.values()) >= MB_PR_TOL_M:
        fail(f"both-band fixes {len(both)}, B3I against B1I pseudoranges "
             f"{worst_pr}")
    k3b = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n2)
    k3 = sum(v for s, v in peak.items() if s[2] == 9 and s[-1] == n2)
    pro, fold = block_counts(f2, 20)
    k9 = epoch_shapes(B3_CHANNELS, b3.trk.nominal_epoch_samples)
    print(f"  B3I shapes: K3b {k3b} launches at N={n2}, K3's peak {k3}; the "
          f"block step at E=20, F={f2}: K8a {pro}, folds {fold}; K9's chunk "
          f"kernel {k9} launches at C={B3_CHANNELS}, "
          f"{b3.trk.nominal_epoch_samples} samples an epoch")
    if not (k3b and k3 == k3b and pro and fold and k9):
        fail("(b) did not launch the kernels at B3I's shapes")
    print(f"  wall {wall:.3f} s for {B13_DUR:.0f} s of two RF streams: "
          f"real-time factor {B13_DUR / wall:.3f} ({card})")
    launches.update({
        "K6_device_generator": k6["K6_device_generator"],
        "K3b_pcps_wipe_per_channel_assisted_B3I": k3b,
        "K3_pcps_peak_assisted_B3I": k3, "K8a_block_prologue_B3I": pro,
        "K1_K8b_K8a_block_step_B3I": fold, "K9_epoch_chunk_B3I": k9})
    return launches


def geo_path(wrappers, card: str) -> dict:
    """Phase 15(c): tests/test_d2.py's GEO run on the card at 8.192 Msps:
    K6 makes GEO_DUR seconds of (c)'s sky (launches counted apart), the
    counters set to 0 just before the acquisition, read after the last
    chunk: PcpsAcquisitionEngine (geo_chain's search), then TrackingEngine
    in chunks of GEO_CHUNK epochs on the per-epoch path (lock_rectify:
    the chunk kernel's rectify form) into BeidouB1iTelemetryDecoder's D2
    arm.  Checks: the Doppler within 5 Hz over the last 50 epochs, no
    loss of lock, the D2 ephemeris decoded (its pages against the sky's
    ephemerides' to their scales), the SOW ramp 1 ms an epoch, and the
    rectify form's launches equal to the chunks dispatched."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.tracking import TrackingEngine
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    sats, eph = geo_sky()
    chain = geo_chain()
    reset(wrappers)
    x = generate_baseband_device_resident(
        sats, FS_GEO, int(FS_GEO * GEO_DUR), noise=True, seed=95,
        device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acq = PcpsAcquisitionEngine(chain.acq, (GEO_PRN,),
                                code_provider=chain.code_provider,
                                sc_rate=chain.sc_rate, device="cuda")
    res = acq.acquire(x[:acq.n_samples_needed])
    if not bool(res.detected[0]):
        fail("(c) did not detect the GEO PRN")
    eng = TrackingEngine(chain.trk, (GEO_PRN,),
                         code_provider=chain.code_provider, device="cuda")
    eng.start_tracking(0, float(res.doppler_hz[0]),
                       int(res.samplestamp + res.delay_samples[0]))
    tlm = chain.telemetry_decoder([GEO_PRN])
    tows, ephs, chunks = [], [], 0
    while eng.epochs_that_fit(len(x)) > GEO_CHUNK:
        outs = eng.process(x, 0, GEO_CHUNK)
        chunks += 1
        r = tlm.process(outs)
        tows.append(r.tow_at_epoch_ms[:, 0])
        ephs += [e for _, e in r.new_ephemerides]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, GEO_KERNELS)
    del x
    torch.cuda.empty_cache()
    st = interop.track_state_to_numpy(eng.state)
    dop = float(np.mean(outs["carrier_doppler_hz"][-50:, 0]))
    tows = np.concatenate(tows)
    fin = np.isfinite(tows)
    steps = np.diff(tows[fin])
    print(f"  {chunks} chunks of {GEO_CHUNK} epochs; Doppler {dop:.3f} Hz "
          f"(true {GEO_DOP:g}); lock lost {bool(st['lock_lost'][0])}, "
          f"carrier lock {float(st['carrier_lock'][0]):.4f}; {int(fin.sum())} "
          f"epochs stamped, SOW steps {sorted(set(steps.tolist()))[:4]} ms; "
          f"D2 ephemerides {len(ephs)}")
    if abs(dop - GEO_DOP) >= 5.0:
        fail(f"(c) Doppler {dop:.3f} Hz")
    if st["lock_lost"][0] or not st["active"][0]:
        fail("(c) lost the GEO channel's lock")
    if not ephs:
        fail("(c) decoded no D2 ephemeris")
    for name, tol in (("sqrt_a", 2.0 ** -18), ("m0_sc", 2.0 ** -30),
                      ("ecc", 2.0 ** -32), ("toe", 0.0)):
        if abs(getattr(ephs[0], name) - getattr(eph, name)) > tol:
            fail(f"(c) D2 ephemeris {name} {getattr(ephs[0], name)!r}, "
                 f"sky {getattr(eph, name)!r}")
    if fin.sum() < 5000 or not np.array_equal(steps, np.ones_like(steps)):
        fail(f"(c) SOW ramp: {int(fin.sum())} epochs stamped, steps "
             f"{sorted(set(steps.tolist()))[:8]}")
    rect = launches["K9_epoch_chunk_rectify"]
    print(f"  K9's chunk kernel: {launches['K9_epoch_chunk']} launches, "
          f"{rect} in its rectify form, for {chunks} chunks dispatched")
    if not (rect == chunks == launches["K9_epoch_chunk"]):
        fail(f"(c): {rect} rectify launches for {chunks} chunks")
    print(f"  wall {wall:.3f} s for {GEO_DUR:g} s of signal: real-time "
          f"factor {GEO_DUR / wall:.3f} ({card})")
    launches["K6_device_generator"] = k6["K6_device_generator"]
    return launches


# ---- phase 16: the Galileo E6-B chain (C/NAV, HAS) -------------------------

F_E1 = 1_575.42e6
F_E6 = 1_278.75e6
# (a): Galileo E1-B + E6-B on one stream at 12.5 Msps (tests/test_e6_has.py's
# rate: it holds E6-B's +-5.115 MHz main lobe), the hybrid sky's Galileo
# satellites, 26 s (phase 5's: their I/NAV ephemerides), written as ibyte
# (ishort would be 1.3 GB).  Each satellite sends one row of the HAS
# message's C-matrix once a second (E6_PIDS); the message fills two pages,
# so no satellite holds enough rows alone and the receiver rebuilds it by
# Reed-Solomon erasure decoding of two satellites' rows (the information
# PID 1 and parity PIDs above 32)
FS_E6 = 12_500_000.0
E6_DUR = 26.0
E6_CN0 = 48.0
E6_PRNS = HYB_GAL_PRNS
E6_PIDS = {11: 1, 12: 40, 13: 77, 14: 140, 15: 201}
E6_MESSAGE_ID = 5
E6_CHANNELS = len(E6_PRNS)
# the observables' tick stride on E6's 1 ms epochs at PVT.output_rate_ms=20
# (receiver.py: min(interval, 90) // epoch)
E6_DECIM = 20
# (b): the E6 signals alone, 5 s: two pages a satellite, the cold search
E6_ALONE_DUR = 5.0
# the E6 searches: a C/NAV symbol flips the sign at every 1 ms code epoch,
# and at the chain's 2 dwells of 1 ms (one FFT of N = 12500 each) a dwell
# cut by a flip puts the Doppler peak off: on (b)'s sky 15 of 55 searches
# land 250 to 800 Hz off (CPU counts at 12.5 Msps; the JAX engine gives the
# same cells on the same input), past the decision-directed FLL's +-250 Hz,
# and a channel locks 500 Hz off or loses lock (ROADMAP.md queue 3, as
# E5b's and B1I's).  The doubled FFT (bit_transition_flag) and 8 dwells:
# none of 55 beyond 75 Hz
E6_DWELLS = 8
E6_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step", "K9_epoch_chunk",
              "K9_epoch_chunk_rectify", "K3_pcps_wipe", "K3_pcps_peak",
              "K3b_pcps_wipe_per_channel")
E6_ALONE_KERNELS = E6_KERNELS

# (a)'s conf: E1-B and E6-B, 5 channels each, every channel pinned to its
# satellite (Channel<i>.satellite counts E1's channels first): an E6
# channel's acquisition waits for E1's lock of its PRN (the assist gate),
# so one left on a PRN no E1 channel tracks would wait for good (ROADMAP.md
# queue 3, as B3I's)
E6_CONF = """\
GNSS-SDR.internal_fs_sps={fs:.0f}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs:.0f}
Channels_1B.count=5
Channels_E6.count=5
Channels.in_acquisition=10
Acquisition_1B.implementation=Galileo_E1_PCPS_Ambiguous_Acquisition
Tracking_1B.implementation=Galileo_E1_DLL_PLL_VEML_Tracking
Acquisition_E6.implementation=Galileo_E6_PCPS_Acquisition
Acquisition_E6.bit_transition_flag=true
Acquisition_E6.max_dwells=8
Tracking_E6.implementation=Galileo_E6_DLL_PLL_Tracking
PVT.implementation=RTKLIB_PVT
PVT.positioning_mode=Single
PVT.output_rate_ms=20
""" + "".join(f"Channel{i}.satellite={p}\nChannel{i + 5}.satellite={p}\n"
              for i, p in enumerate(E6_PRNS))


def has_message():
    """The HAS MT1 message the E6 satellites broadcast, of the kind
    tests/test_e6_has.py:_has_fixture builds: every section (mask, orbit,
    clock full set and subset, code and phase biases) over GPS and
    Galileo."""
    from gnss_sim_receiver_tpu_torch.nav import has

    def mask(prns):
        return sum(1 << (40 - p) for p in prns)
    d = has.HasData()
    d.header = has.HasHeader(
        toh=450, mask_flag=True, orbit_correction_flag=True,
        clock_fullset_flag=True, clock_subset_flag=True,
        code_bias_flag=True, phase_bias_flag=True, mask_id=9, iod_set_id=3)
    d.nsys = 2
    d.gnss_id_mask = [has.GPS_SYSTEM, has.GALILEO_SYSTEM]
    d.satellite_mask = [mask([1, 3, 5]), mask([2, 4])]
    d.signal_mask = [0b1100000000000000, 0b1010000000000000]
    d.cell_mask_flag = [False, True]
    d.cell_mask = [np.ones((3, 2), bool), np.array([[1, 0], [1, 1]], bool)]
    d.nav_message = [0, 0]
    d.validity_orbit = 5
    d.gnss_iod = [17, 18, 19, 257, 258]
    d.delta_radial_m = [0.1, -0.2, 0.3, 0.05, -0.0725]
    d.delta_in_track_m = [0.4, -0.8, 0.16, 0.024, -0.032]
    d.delta_cross_track_m = [0.08, 0.016, -0.24, 0.8, 0.056]
    d.validity_clock = 2
    d.delta_clock_multiplier = [1, 2]
    d.delta_clock_m = [0.05, -0.1, 0.0025, 0.01, -0.005]
    d.validity_clock_subset = 1
    d.nsys_sub = 1
    d.gnss_id_clock_subset = [has.GPS_SYSTEM]
    d.multiplier_clock_subset = [2]
    d.satellite_submask = [0b101]
    d.delta_clock_subset_m = [[0.01, -0.02]]
    d.validity_code_bias = 9
    d.code_bias_m = [[0.5, -0.3], [0.2, 0.1], [-0.8, 0.04], [1.2],
                     [0.6, -0.02]]
    d.validity_phase_bias = 11
    d.phase_bias_cycles = [[0.25, -0.1], [0.0, 0.05], [-0.3, 0.12], [0.07],
                           [0.2, -0.01]]
    d.phase_discontinuity = [[0, 1], [2, 3], [1, 0], [2], [3, 0]]
    return d


def check_has(msgs, what: str) -> None:
    """Every decoded message equal to the planted one (its MT1 bits parsed)
    field by field: the masks, flags and lists exactly, the corrections
    within 1e-12 (their scales' multiples)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.nav import has
    want = has.parse_mt1(has.pack_mt1(has_message()))
    if not msgs:
        fail(f"{what}: no HAS message decoded")
    for got in msgs:
        if dataclasses.asdict(got.header) != dataclasses.asdict(want.header):
            fail(f"{what}: HAS header {got.header}")
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "header":
                continue
            if f.name.endswith(("_m", "_cycles")):
                fa = np.concatenate([np.ravel(v) for v in a]) if a else []
                fb = np.concatenate([np.ravel(v) for v in b]) if b else []
                if len(fa) != len(fb) or np.abs(np.subtract(fa, fb)).max(
                        initial=0.0) > 1e-12:
                    fail(f"{what}: HAS {f.name} {a} against {b}")
            elif f.name == "cell_mask":
                if len(a) != len(b) or not all(
                        np.array_equal(x, y) for x, y in zip(a, b)):
                    fail(f"{what}: HAS cell mask {a}")
            elif a != b:
                fail(f"{what}: HAS {f.name} {a!r} against {b!r}")
    print(f"  {len(msgs)} HAS messages decoded, each the planted one field "
          "by field (corrections within 1e-12)")


def e6_sky(dur: float):
    """(a)'s sky: the hybrid sky's Galileo satellites on E1-B (I/NAV,
    48 dB-Hz) and on E6-B (48 dB-Hz, each its row of the HAS message's
    C-matrix once a second, E6_PIDS).  Returns (E1 signals, E6 signals)."""
    from gnss_sim_receiver_tpu_torch.nav import cnav_e6, has
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    _, gal = hybrid_ephemerides()
    e1 = build_static_scenario(gal, rx_true_ecef(), T0, dur,
                               cn0_db_hz=E6_CN0, subframe_cycle=(1, 2, 3))
    msg = has_message()
    n_pages = int(np.ceil(dur)) + 2

    def signs(eph):
        page = has.mt1_to_pages(msg, E6_MESSAGE_ID, pids=[E6_PIDS[eph.prn]])
        return cnav_e6.e6b_epoch_signs(np.concatenate(page * n_pages))
    e6 = offband_satellites(gal, rx_true_ecef(), T0, dur, E6_CN0, "E6", F_E6,
                            signs)
    return e1, e6


def e6_chain():
    """galileo_e6b_chain at 12.5 Msps on the five PRNs, its searches with
    the doubled FFT and E6_DWELLS dwells (E6_CONF's keys)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.receiver import galileo_e6b_chain
    chain = galileo_e6b_chain(FS_E6, prns=E6_PRNS, n_channels=E6_CHANNELS)
    chain.acq = dataclasses.replace(chain.acq, bit_transition_flag=True,
                                    max_dwells=E6_DWELLS)
    return chain


def e6_alone_conf():
    """(b)'s receiver: e6_chain alone (no other Galileo band: the assist
    gate is off)."""
    from gnss_sim_receiver_tpu_torch.models.receiver import ReceiverConf
    return ReceiverConf(fs=FS_E6, gps_chain=False, chains=(e6_chain(),))


def cli_session(argv, log: dict):
    """run_cli(argv) with the session it builds kept in log["session"]:
    its observation epochs logged with the channel -> PRN map
    (logged_session), every assisted search's window (seconds) and centres
    in log["windows"].  Returns the CliRun; an exception of the run
    propagates, `log` filled up to it."""
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    windows = log.setdefault("windows", [])
    start = Receiver.start_session
    assisted = PcpsAcquisitionEngine.acquire_assisted

    def start_logged(self, *a, **k):
        log["session"] = log_epochs(start(self, *a, **k))
        return log["session"]

    def acquire_assisted(eng, x, start_, centers, *a, **k):
        windows.append((start_ / eng.conf.fs_in, list(centers)))
        return assisted(eng, x, start_, centers, *a, **k)
    Receiver.start_session = start_logged
    PcpsAcquisitionEngine.acquire_assisted = acquire_assisted
    try:
        return run_cli(argv)
    finally:
        Receiver.start_session = start
        PcpsAcquisitionEngine.acquire_assisted = assisted


def e6_tail(err: Exception, log: dict) -> None:
    """Accept `err` when it is the JAX receiver's own failure at the E6
    chain's tail chunk: a batch run's last chunk of a chain,
    shorter than one tick stride (20 epochs at 1 ms and a 20 ms observable
    interval), reaches the telemetry without the sample counter
    (receiver.py's tail branch), which the E6-B decoder reads for its TOW
    map, so the run raises KeyError('sample_counter') unless the chain's
    last epochs come to a whole number of strides (ROADMAP.md queue 3;
    JAX's receiver alike).  Any other error is raised again."""
    session = log.get("session")
    if not (isinstance(err, KeyError) and err.args == ("sample_counter",)
            and session is not None
            and any(rt.spec.signal == "E6" for rt in session.chains)):
        raise err
    print("  the run raised KeyError('sample_counter') at the E6 chain's "
          "tail chunk (the reference's behaviour, ROADMAP.md queue 3); the "
          "session's result up to it is checked")


def check_e6_observables(run, session, e1_sats, ages, n1: int) -> None:
    """(a)'s pseudoranges and fixes.  The receiver stamps each E6 epoch
    with the TOW E1 last published for its PRN, moved on by the samples
    since then at the primary rate (GalileoTowMap, as the JAX receiver):
    receive time, where the satellite's transmit time runs slower by its
    range rate over c, so PR_E6 - PR_E1 comes to -age x range rate, the
    age the stamp's samples since the publication (ROADMAP.md queue 3;
    km-sized, as the map is published once a tracking chunk).  Checks:
    per PRN, PR_E6 - PR_E1 within 30 m of that at every common epoch, and
    with the E1 channels alone the fixes' mean error 2D < 2 m, 3D < 5 m
    (solve_pvt on each 50th observation epoch); the both-band fixes'
    error printed.  `ages` PRN -> [(sample counter, age s)] of the stamps
    at the tick rows the observables interpolate."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.pvt import solve_pvt
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    c_light = 299_792_458.0
    truth = {s.prn: s for s in e1_sats}
    arrs = {p: np.array(sorted(v)) for p, v in ages.items()}
    rows = collections.defaultdict(list)     # prn -> [(d, age, rr)]
    for ep, prns in zip(run.observation_epochs, session.epoch_prns):
        t = ep.tick_sample / FS_E6
        for c2 in range(n1, len(prns)):
            p = prns[c2]
            if not ep.valid[c2] or p not in prns[:n1] or p not in arrs:
                continue
            c1 = prns[:n1].index(p)
            if not ep.valid[c1]:
                continue
            # the observables interpolate the stamps bracketing the tick
            # linearly, and the error is linear in the age: its age too
            age = float(np.interp(ep.tick_sample, arrs[p][:, 0],
                                  arrs[p][:, 1]))
            sat = truth[p]
            rr = -(sat.doppler_hz + sat.doppler_rate_hz_s * t) * c_light / F_E1
            rows[p].append((ep.pseudorange_m[c2] - ep.pseudorange_m[c1],
                            age, rr))
    worst_raw, worst = {}, {}
    for p in sorted(rows):
        d, age, rr = (np.asarray(v) for v in zip(*rows[p]))
        res = d + age * rr
        worst_raw[p] = float(np.abs(d).max())
        worst[p] = float(np.abs(res).max())
        slope = (np.polyfit(age, d, 1)[0] if np.ptp(age) > 0 else np.nan)
        print(f"    PRN {p}: {len(d)} epochs, PR_E6 - PR_E1 {d.min():.1f} "
              f"to {d.max():.1f} m; stamp ages {age.min():.3f} to "
              f"{age.max():.3f} s; slope on age {slope:.2f} m/s against "
              f"-range rate {-rr.mean():.2f}; median |residual| "
              f"{np.median(np.abs(res)):.2f} m")
    print(f"  max |PR_E6 - PR_E1| by PRN {worst_raw} m; less the map's "
          f"extrapolation (-age x range rate): {worst} m")
    if sorted(rows) != list(E6_PRNS) or max(worst.values()) >= MB_PR_TOL_M:
        fail(f"E6 against E1 pseudoranges less the map's extrapolation "
             f"{worst}")
    both = [s for s in run.solutions if s.used_channels is not None
            and (s.used_channels < n1).any()
            and (s.used_channels >= n1).any()]
    if not both:
        fail("no fix of both bands")
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))

    def err(sols):
        enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true_ecef(),
                                            ref) for s in sols])
        return (float(np.linalg.norm(enu.mean(0)[:2])),
                float(np.linalg.norm(enu.mean(0))))
    e1_only = []
    for ep in run.observation_epochs[::50]:
        v = ep.valid.copy()
        v[n1:] = False
        sol = solve_pvt(dataclasses.replace(ep, valid=v), run.channel_prns,
                        run.ephemerides, systems=list(run.channel_systems))
        if sol.valid:
            e1_only.append(sol)
    both_2d, both_3d = err(both)
    e1_2d, e1_3d = err(e1_only) if e1_only else (np.inf, np.inf)
    print(f"  {len(both)} of {len(run.solutions)} fixes use both bands "
          f"(mean error 2D {both_2d:.3f} m, 3D {both_3d:.3f} m: the E6 "
          f"extrapolation's); E1 alone on {len(e1_only)} epochs: 2D "
          f"{e1_2d:.3f} m, 3D {e1_3d:.3f} m")
    if len(e1_only) < 5 or not (e1_2d < 2.0 and e1_3d < 5.0):
        fail(f"E1 fixes: {len(e1_only)}, 2D {e1_2d:.3f} m, 3D {e1_3d:.3f} m")


def e6_path(root: str, wrappers, card: str) -> dict:
    """Phase 16(a): E1-B + E6-B through the CLI on one 12.5 Msps stream.  K6
    makes (a)'s sky for E6_DUR seconds, written as ibyte (its launches
    counted apart); the counters set to 0 just before run_cli(E6_CONF) and
    read just after, the session kept (cli_session) and every E6 decoder's
    TOW stamps logged.  Checks: E1 tracks the five PRNs; every E6 search
    assisted, each centre within 50 Hz of the true E1 Doppler x f_E6 /
    f_E1; the E6 TOW stamped from the TOW map, 1 ms an epoch; the
    pseudoranges and fixes as check_e6_observables holds them; the HAS
    message rebuilt, equal to the planted one; the real-time factor and
    the launches at E6's and E1's 12.5 Msps shapes."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.telemetry import (
        GalileoE6bTelemetryDecoder, GalileoTowMap)
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = os.path.join(root, "build", "e6_scenario_12p5msps_v1.ibyte")
    e1_sats, e6_sats = e6_sky(E6_DUR)
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(
        e1_sats + e6_sats, FS_E6, int(FS_E6 * E6_DUR), noise=True, seed=161,
        device="cuda")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_samples(path, x, "ibyte", scale=HYB_BYTE_SCALE)
    del x
    torch.cuda.empty_cache()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ibyte "
          f"at {FS_E6 / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    conf = os.path.join(root, "build", "chip_smoke_e6.conf")
    with open(conf, "w") as fh:
        fh.write(E6_CONF.format(capture=path, fs=FS_E6))
    stamps = []
    process = GalileoE6bTelemetryDecoder.process
    ages = collections.defaultdict(list)     # prn -> [(sample, age s)]
    ticks = collections.defaultdict(set)     # prn -> tick rows' samples
    tow_at = GalileoTowMap.tow_at_sample

    def process_logged(self, outs):
        res = process(self, outs)
        stamps.append(res.tow_at_epoch_ms)
        # the tick rows the observables take (receiver.py's decimation:
        # every E6_DECIM-th epoch of a chunk)
        sc = np.asarray(outs["sample_counter"])
        for c, prn in enumerate(self.prns):
            ticks[int(prn)].update(
                sc[E6_DECIM - 1::E6_DECIM, c].tolist())
        return res

    def tow_at_logged(self, prn, sample_counter):
        hit = self._m.get(int(prn))
        out = tow_at(self, prn, sample_counter)
        if out is not None:
            ages[int(prn)].append((float(sample_counter),
                                   (float(sample_counter) - hit[1])
                                   / self.fs))
        return out
    GalileoE6bTelemetryDecoder.process = process_logged
    GalileoTowMap.tow_at_sample = tow_at_logged
    shapes0 = shape_counts()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    trk.epoch_chunk.shapes.clear()
    log = {}
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = cli_session([f"--config_file={conf}"], log)
    except Exception as err:       # e6_tail raises any other again
        e6_tail(err, log)
        res = None
    finally:
        GalileoE6bTelemetryDecoder.process = process
        GalileoTowMap.tow_at_sample = tow_at
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, E6_KERNELS)
    os.remove(path)
    session, windows = log["session"], log["windows"]
    if res is not None and res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    run = session.result() if res is None else res.run
    n1 = len(E6_PRNS)
    states = list(zip(run.channel_prns, run.channel_states))
    e1_trk, e6_trk = [sorted(p for p, s in part if s == ChannelState.TRACKING)
                      for part in (states[:n1], states[n1:])]
    print(f"  E1 tracks {e1_trk}, E6 tracks {e6_trk}; Galileo ephemerides "
          f"{sorted(k[1] for k in run.ephemerides)}")
    if e1_trk != list(E6_PRNS) or e6_trk != list(E6_PRNS):
        fail(f"tracked E1 {e1_trk}, E6 {e6_trk}: expected {list(E6_PRNS)}")
    check_assisted_centres(session, windows, e1_sats, F_E6 / F_E1, "E6",
                           e6_trk, primary="E1")
    # the E6 TOW: stamped from the map (E1's published TOW), 1 ms an epoch:
    # an epoch lasts one code period at the Doppler'd chip rate, so a step
    # departs from 1 ms by |f_d| / f_E6 (< 3e-6 here) and float rounding
    n_stamped, worst_step = 0, 0.0
    for tow in stamps:
        for c in range(tow.shape[1]):
            col = tow[:, c]
            fin = np.isfinite(col)
            n_stamped += int(fin.sum())
            both = fin[1:] & fin[:-1]
            if both.any():
                worst_step = max(worst_step, float(np.abs(
                    np.diff(col)[both] - 1.0).max()))
    print(f"  {n_stamped} E6 epochs stamped from the TOW map "
          f"({len(session.tow_map._m)} PRNs published), each step within "
          f"{worst_step:.2e} ms of 1 ms")
    if n_stamped < 5 * 5000 or worst_step > 1e-5:
        fail(f"E6 TOW: {n_stamped} epochs stamped, steps within "
             f"{worst_step:.2e} ms of 1 ms")
    check_e6_observables(run, session, e1_sats, {
        p: [(sc, a) for sc, a in v if sc in ticks[p]]
        for p, v in ages.items()}, n1)
    check_has(run.has_messages, "(a)")
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    n6 = PcpsAcquisitionEngine(e6_chain().acq, (11,), device="cuda").fft_size
    k3b = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n6)
    k3 = sum(v for s, v in peak.items() if s[2] == 9 and s[-1] == n6)
    f6 = tb.block_fft_size(e6_alone_conf().chains[0].trk)
    pro, fold = block_counts(f6, 20)
    k9 = epoch_shapes(E6_CHANNELS, int(FS_E6 * 1e-3))
    print(f"  the wipeoff by shape {dict(wipe)}, K3's peak {dict(peak)}; "
          f"the E6 block step at E=20, F={f6}: K8a {pro}, folds {fold}; "
          f"K9's chunk kernel {k9} launches at C={E6_CHANNELS}, "
          f"{int(FS_E6 * 1e-3)} samples an epoch")
    if not (k3b and k3 == k3b and pro and fold and k9):
        fail("(a) did not launch the kernels at E6's shapes")
    if res is not None:
        sec = res.seconds
        print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
              f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from the CLI's start to its end for "
          f"{E6_DUR:g} s of signal: real-time factor {E6_DUR / wall:.3f} "
          f"({card})")
    launches.update({"K6_device_generator": k6,
                     "K6_device_generator_E6": k6,
                     "K3b_pcps_wipe_per_channel_E6": k3b,
                     "K3_pcps_peak_assisted_E6": k3,
                     "K8a_block_prologue_E6": pro,
                     "K1_K8b_K8a_block_step_E6": fold,
                     "K9_epoch_chunk_E6": k9})
    return launches


def e6_alone_path(wrappers, card: str) -> dict:
    """Phase 16(b): (a)'s E6 signals alone for E6_ALONE_DUR seconds, made
    by K6 on the card (launches counted apart), through the receiver alone
    (start_session, attach_array, run_to_end; the counters set to 0 just
    before and read just after).  Checks: the searches cold (D = 41, N =
    12500) and none assisted; the five PRNs tracked, each Doppler within
    5 Hz of the truth, no loss of lock; the HAS message rebuilt; and, the
    TOW map having no publisher, no E6 TOW, no valid observable and no fix,
    as in JAX."""
    import torch
    from gnss_sim_receiver_tpu_torch import interop
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    _, sats = e6_sky(E6_ALONE_DUR)
    reset(wrappers)
    x = generate_baseband_device_resident(
        sats, FS_E6, int(FS_E6 * E6_ALONE_DUR), noise=True, seed=162,
        device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    conf = e6_alone_conf()
    eng = PcpsAcquisitionEngine(conf.chains[0].acq, (11,), device="cuda")
    n, d = eng.fft_size, eng.dopplers.shape[0]
    shapes0 = shape_counts()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    trk.epoch_chunk.shapes.clear()
    session = Receiver(conf).start_session()
    # every chunk's tick-rate Doppler and validity, for the last second's
    # mean (the 50 Hz PLL's jitter is a few Hz an epoch)
    ticks = []
    process_end = trk.TrackingEngine.process_end

    def process_end_logged(eng_, handle):
        outs = process_end(eng_, handle)
        ticks.append((outs["carrier_doppler_hz"], outs["valid"]))
        return outs
    trk.TrackingEngine.process_end = process_end_logged
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session.attach_array(x)
    try:
        session.run_to_end()
    except Exception as err:       # e6_tail raises any other again
        e6_tail(err, {"session": session})
    finally:
        trk.TrackingEngine.process_end = process_end
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers, E6_ALONE_KERNELS)
    run = session.result()
    del x
    torch.cuda.empty_cache()
    print(f"  searches {dict(session.searches)}")
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    cold = sum(v for s, v in wipe.items() if len(s) == 3 and s[1] == d
               and s[-1] == n)
    cold_peak = sum(v for s, v in peak.items() if s[2] == d and s[-1] == n)
    step2 = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n)
    print(f"  the wipeoff by shape {dict(wipe)}, K3's peak {dict(peak)}")
    if session.searches[("E6", "assisted")] or not cold \
            or cold_peak != cold or d != 41 or n != 2 * int(FS_E6 * 1e-3):
        fail(f"(b) did not search cold at D=41, N=2 x 12500: searches "
             f"{dict(session.searches)}, wipeoff {dict(wipe)}")
    tracked = sorted(p for p, s in zip(run.channel_prns, run.channel_states)
                     if s == ChannelState.TRACKING)
    st = interop.track_state_to_numpy(session.chains[0].trk.state)
    truth = {s.prn: s.doppler_hz + s.doppler_rate_hz_s * (E6_ALONE_DUR - 0.5)
             for s in sats}
    dop = np.concatenate([np.asarray(d) for d, _ in ticks])
    ok = np.concatenate([np.asarray(v) for _, v in ticks])
    errs = {}
    for c, p in enumerate(run.channel_prns):
        rows = np.flatnonzero(ok[:, c])[-50:]
        if p and len(rows) == 50:
            errs[int(p)] = float(dop[rows, c].mean() - truth[p])
    print(f"  E6 tracks {tracked}; mean Doppler error over the last 50 "
          f"ticks (1 s) by PRN {errs} Hz; lock lost "
          f"{st['lock_lost'].tolist()}")
    if tracked != list(E6_PRNS) or sorted(errs) != list(E6_PRNS) \
            or max(abs(e) for e in errs.values()) >= 5.0 \
            or st["lock_lost"].any() or not st["active"].all():
        fail(f"(b): tracked {tracked}, Doppler errors {errs}")
    check_has(run.has_messages, "(b)")
    valid = sum(int(ep.valid.any()) for ep in run.observation_epochs)
    print(f"  the TOW map holds {session.tow_map._m}; {valid} observation "
          f"epochs with a valid channel; {len(run.solutions)} fixes")
    if session.tow_map._m or valid or run.solutions:
        fail("(b): an E6 TOW, observable or fix without a TOW publisher")
    pro, fold = block_counts(tb.block_fft_size(conf.chains[0].trk), 20)
    k9 = epoch_shapes(E6_CHANNELS, int(FS_E6 * 1e-3))
    print(f"  the E6 block step: K8a {pro}, folds {fold}; K9's chunk kernel "
          f"{k9} launches at C={E6_CHANNELS}, {int(FS_E6 * 1e-3)} samples an "
          "epoch")
    if not (pro and fold and k9):
        fail("(b) did not run E6's shapes of the block step and the chunk "
             "kernel")
    print(f"  wall {wall:.3f} s for {E6_ALONE_DUR:g} s of signal: real-time "
          f"factor {E6_ALONE_DUR / wall:.3f} ({card})")
    launches.update({"K6_device_generator": k6, "K3_pcps_wipe_E6": cold,
                     "K3_pcps_peak_E6": cold_peak,
                     "K3b_pcps_wipe_per_channel_E6": step2,
                     "K8a_block_prologue_E6": pro,
                     "K1_K8b_K8a_block_step_E6": fold,
                     "K9_epoch_chunk_E6": k9})
    return launches


# ---- phase 17: the GLONASS L1 and L2 C/A chains (GNAV, FDMA slots) ----------

F_G1, DF_G1 = 1_602.0e6, 0.5625e6
F_G2, DF_G2 = 1_246.0e6, 0.4375e6
# three satellites on slots -7, 0 and +6 (PRNs 10, 11 and 4 by
# GLONASS_PRN_SLOT), each a physical Doppler of a few kHz (the code Doppler
# the physical one alone, on the slot's carrier: tests/test_glonass_l2.py)
# and a delay of its own, 46 dB-Hz: (PRN, slot, Doppler Hz, delay s)
GLO_SATS = ((10, -7, 2300.0, 0.0682), (11, 0, -1700.0, 0.0711),
            (4, 6, 900.0, 0.0753))
GLO_CN0 = 46.0
# the GNAV frames start on a 30 s grid of the day; the sky starts 24 s into
# one (its string 13), so the next frame's string 1 (the TOW) comes 6 s in
# and its strings 1-4 (an ephemeris) by 14 s: (a) needs 16.5 s, not the
# 38.5 s of tests/test_glonass_chain.py's capture from a frame start (the
# half second puts K6's last launch in a partial tile).  The TOW is a time
# of day: the factory passes day_base_s = 0
GLO_FRAME_TOD = 43_200.0
GLO_START_S = 24.0
GLO_TB_TOD = GLO_FRAME_TOD + 900.0        # on tb's 15-minute grid
# (a): L1 at 10 Msps holds slot -7's main lobe (-3.94 MHz +- 0.511)
FS_G1 = 10_000_000.0
GLO_DUR = 16.5
# (b): L1 at 10 Msps on RF 0, L2 at 8 Msps on RF 1 (slot -7 at -3.06 MHz
# on L2), 10.5 s: the TOW 8 s in, the pseudoranges over the last 2.5 s
FS_G2 = 8_000_000.0
GLO_MB_DUR = 10.5
GLO_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step", "K9_epoch_chunk",
               "K9_epoch_chunk_rectify", "K3_pcps_wipe", "K3_pcps_peak",
               "K3b_pcps_wipe_per_channel", "K8a_block_prologue_bias",
               "K1_K8b_K8a_block_step_bias", "K9_epoch_chunk_bias")
GLO_MB_KERNELS = GLO_KERNELS

GLO_CONF = """\
GNSS-SDR.internal_fs_sps={fs:.0f}
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ibyte
SignalSource.sampling_frequency={fs:.0f}
Channels_1G.count=24
Acquisition_1G.implementation=GLONASS_L1_CA_PCPS_Acquisition
Tracking_1G.implementation=GLONASS_L1_CA_DLL_PLL_Tracking
PVT.implementation=RTKLIB_PVT
PVT.output_rate_ms=20
"""


def glonass_ephemeris(prn: int, k: int, i: int):
    """Satellite i's broadcast state at tb (PZ-90; tests/test_gnav.py's
    circular orbit, turned by i), tb a time of day."""
    from gnss_sim_receiver_tpu_torch.nav import gnav
    r = 25_508_000.0
    v = np.sqrt(gnav._GM / r)
    a = 0.4 * i
    ca, sa = np.cos(a), np.sin(a)
    return gnav.GlonassEphemeris(
        prn=prn, freq_slot=k, tb_s=GLO_TB_TOD,
        pos_m=(r * (0.6 * ca - 0.64 * sa), r * (0.6 * sa + 0.64 * ca),
               r * 0.48),
        vel_ms=(v * (-0.5 * ca - 0.1 * sa), v * (-0.5 * sa + 0.1 * ca),
                v * 0.49),
        acc_ms2=(1.9e-9, -2.4e-9, 0.9e-9), tau_n=-4.7e-5 + 1e-5 * i,
        gamma_n=1.8e-12)


def glonass_sky(signal: str = "1G"):
    """The three satellites on `signal` ("1G" or "2G"): each slot's carrier
    Doppler (the slot offset plus the physical Doppler scaled by the
    carrier), the code Doppler the physical one, its GNAV strings from
    GLO_START_S into a frame; and the broadcast ephemerides by PRN."""
    from gnss_sim_receiver_tpu_torch.nav import gnav
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    f0, df = (F_G1, DF_G1) if signal == "1G" else (F_G2, DF_G2)
    sats, ephs = [], {}
    for i, (prn, k, dop, delay) in enumerate(GLO_SATS):
        eph = glonass_ephemeris(prn, k, i)
        ephs[prn] = eph
        sym = gnav.strings_for_ephemeris(eph, GLO_FRAME_TOD, n_repeats=2)
        bits = (2 * sym[int(GLO_START_S * 100):] - 1).astype(np.int8)
        f_c = f0 + k * df
        phys = dop * f_c / (F_G1 + k * DF_G1)
        sats.append(SatelliteSignalParams(
            prn=prn, system="GLONASS", signal=signal, cn0_db_hz=GLO_CN0,
            doppler_hz=k * df + phys, code_doppler_hz=phys,
            carrier_ref_hz=f_c, delay_sec=delay, delay_chips=0.0,
            nav_bits=bits))
    return sats, ephs


def glo_delay(prn: int, t):
    """The true delay (s) of the sky's satellite on `prn`'s slot at receive
    time t (s from the capture's start): delay0 - (code Doppler / carrier)
    t."""
    from gnss_sim_receiver_tpu_torch.constants import GLONASS_PRN_SLOT
    k = GLONASS_PRN_SLOT[prn]
    (dop, d0), = [(d, d0) for _, k_, d, d0 in GLO_SATS if k_ == k]
    return d0 - dop / (F_G1 + k * DF_G1) * np.asarray(t)


def glonass_mb_conf():
    """(b)'s receiver: glonass_l1_chain at 10 Msps on RF 0 and
    glonass_l2_chain at 8 Msps on RF 1, one chain of one channel per
    satellite's slot on each band (L2 assist-gated on L1)."""
    import dataclasses
    from gnss_sim_receiver_tpu_torch.models.receiver import (
        ReceiverConf, glonass_l1_chain, glonass_l2_chain)
    l1 = [glonass_l1_chain(FS_G1, prns=(p,), freq_slot=k, n_channels=1)
          for p, k, _, _ in GLO_SATS]
    l2 = [dataclasses.replace(
        glonass_l2_chain(FS_G2, prns=(p,), freq_slot=k, n_channels=1),
        rf_channel_id=1) for p, k, _, _ in GLO_SATS]
    return ReceiverConf(fs=FS_G1, gps_chain=False, rf_fs={1: FS_G2},
                        chains=tuple(l1 + l2))


def check_glonass_observables(run, epoch_prns, fs: float,
                              label: str) -> None:
    """The TOW of every valid channel at every observation epoch within
    1 ms of the truth (the time of day the satellite sent at the tick),
    and the pseudorange differences within 30 m of the planted delays';
    `epoch_prns` each epoch's channel -> PRN map (logged_session)."""
    worst_tow, worst_pr, n = 0.0, 0.0, 0
    for ep, prns in zip(run.observation_epochs, epoch_prns):
        t = ep.tick_sample / fs
        chans = [c for c in range(len(ep.valid)) if ep.valid[c]]
        for c in chans:
            prn = prns[c]
            truth = (GLO_FRAME_TOD + GLO_START_S + t - glo_delay(prn, t)) * 1e3
            worst_tow = max(worst_tow, abs(ep.interp_tow_ms[c] - truth))
            n += 1
        for a in chans:
            for b in chans:
                pa, pb = prns[a], prns[b]
                if pa < pb:
                    want = 299_792_458.0 * (glo_delay(pa, t)
                                            - glo_delay(pb, t))
                    got = ep.pseudorange_m[a] - ep.pseudorange_m[b]
                    worst_pr = max(worst_pr, abs(got - want))
    print(f"  {label}: {n} valid observables; TOW within {worst_tow:.6f} ms "
          f"of the truth, pseudorange differences within {worst_pr:.3f} m of "
          "the planted delays'")
    if n < 100 or worst_tow >= 1.0 or worst_pr >= MB_PR_TOL_M:
        fail(f"{label}: {n} observables, TOW {worst_tow:.4f} ms, "
             f"pseudorange differences {worst_pr:.3f} m")


def glonass_path(root: str, wrappers, card: str) -> dict:
    """Phase 17(a): GLONASS L1 C/A through the CLI, Channels_1G.count=24 (the
    factory's 13 slot chains).  K6 makes the three satellites at 10 Msps
    for GLO_DUR seconds, written as ibyte (launches counted apart); the
    counters set to 0 just before run_cli(GLO_CONF) and read just after.
    Checks: each satellite tracked on its own slot's chain and nothing
    else tracked; the carrier Doppler within 3 Hz of the slot offset plus
    the truth; three GNAV ephemerides, each with its RK4 state within 3 m
    and its clock within 2e-9 s of the broadcast one at tb + 200 s; the
    TOW within 1 ms of the truth and the pseudorange differences within
    30 m of the planted delays'; no fix (three satellites, under
    solve_pvt's four); the bias form of K8a, K1 with K8b and K8a, and the
    chunk kernel launched; the real-time factor."""
    import torch
    from gnss_sim_receiver_tpu_torch.constants import GLONASS_PRN_SLOT
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import FileConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = os.path.join(root, "build", "glonass_scenario_10msps_v1.ibyte")
    sats, ephs = glonass_sky()
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(
        sats, FS_G1, int(FS_G1 * GLO_DUR), noise=True, seed=171,
        device="cuda")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_samples(path, x, "ibyte", scale=HYB_BYTE_SCALE)
    del x
    torch.cuda.empty_cache()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ibyte "
          f"at {FS_G1 / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    conf = os.path.join(root, "build", "chip_smoke_glonass.conf")
    with open(conf, "w") as fh:
        fh.write(GLO_CONF.format(capture=path, fs=FS_G1))
    chains = receiver_conf_from_config(FileConfiguration(conf)).chains
    slot_of = [c.freq_slot for c in chains for _ in range(c.n_channels)]
    print(f"  {len(chains)} slot chains, slots "
          f"{[c.freq_slot for c in chains]}, {len(slot_of)} channels")
    if len(chains) != 13 or len(slot_of) != 24:
        fail("the factory did not build the 13 slot chains of 24 channels")
    shapes0 = shape_counts()
    tb.block_correlate_close.fold_shapes.clear()
    tb.block_prologue.shapes.clear()
    trk.epoch_chunk.shapes.clear()
    reset(wrappers)
    torch.cuda.synchronize()
    log = {}
    res = cli_session([f"--config_file={conf}"], log)
    session = log["session"]
    torch.cuda.synchronize()
    launches = read_launches(wrappers, GLO_KERNELS)
    os.remove(path)
    run = res.run
    if res.exit_code != 1 or run is None:
        fail(f"the CLI returned {res.exit_code} (1: no fix, as three "
             "satellites must give)")
    # every satellite on its own slot's chain; the slots' other PRN (a
    # slot's two satellites share code and carrier, the ICD's antipodal
    # pairs) locks the same signal, in JAX alike (ROADMAP.md queue 3)
    tracked = {p: slot_of[c] for c, (p, s) in enumerate(
        zip(run.channel_prns, run.channel_states))
        if s == ChannelState.TRACKING}
    want = {p: k for p, k, _, _ in GLO_SATS}
    slots = {k for k in want.values()}
    print(f"  tracked PRN -> slot {tracked}; GNAV ephemerides "
          f"{sorted(run.ephemerides)}")
    if set(tracked.values()) != slots or any(
            GLONASS_PRN_SLOT[p] != k for p, k in tracked.items()) \
            or not set(want) <= set(tracked):
        fail(f"tracked {tracked}, expected {want} on their slots alone")
    last = run.observation_epochs[-50:]
    dop_err = {}
    for c, p in enumerate(run.channel_prns):
        if p in tracked and all(ep.valid[c] for ep in last):
            k = tracked[p]
            (dop,) = [d for _, k_, d, _ in GLO_SATS if k_ == k]
            dop_err[p] = float(np.mean([ep.carrier_doppler_hz[c]
                                        for ep in last]) - (k * DF_G1 + dop))
    print(f"  carrier Doppler less the slot offset and the truth, mean of "
          f"the last 50 observation epochs (1 s): {dop_err} Hz")
    if not set(want) <= set(dop_err) \
            or max(abs(e) for e in dop_err.values()) >= 3.0:
        fail(f"carrier Doppler errors {dop_err}")
    worst = {}
    for p in want:
        got = run.ephemerides.get(("GLONASS", p))
        if got is None:
            fail(f"no GNAV ephemeris of PRN {p}")
        pg, cg = got.sat_pos_clock(got.tb_s + 200.0)
        pw, cw = ephs[p].sat_pos_clock(ephs[p].tb_s + 200.0)
        worst[p] = (float(np.linalg.norm(np.asarray(pg) - np.asarray(pw))),
                    abs(cg - cw), got.freq_slot, got.tb_s)
    print(f"  GNAV ephemerides at tb + 200 s: (position m, clock s, slot, "
          f"tb) {worst}")
    if any(m >= 3.0 or c >= 2e-9 or k != want[p] or tb_ != GLO_TB_TOD
           for p, (m, c, k, tb_) in worst.items()):
        fail(f"GNAV ephemerides {worst}")
    check_glonass_observables(run, session.epoch_prns, FS_G1, "(a)")
    if run.solutions:
        fail(f"{len(run.solutions)} fixes from three satellites")
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    n = int(FS_G1 * 1e-3)
    cold = sum(v for s, v in wipe.items() if len(s) == 3 and s[1] == 41
               and s[-1] == n)
    cold_peak = sum(v for s, v in peak.items() if s[2] == 41 and s[-1] == n)
    step2 = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n)
    print(f"  the wipeoff by shape {dict(wipe)}, K3's peak {dict(peak)}; "
          f"the bias form: K8a {launches['K8a_block_prologue_bias']}, K1 "
          f"with K8b {launches['K1_K8b_block_correlate_close_bias']} (folds "
          f"{launches['K1_K8b_K8a_block_step_bias']}), the chunk kernel "
          f"{launches['K9_epoch_chunk_bias']}")
    if not (cold and cold_peak == cold and step2):
        fail(f"(a) did not search the slots' grids: {dict(wipe)}")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the end for {GLO_DUR:g} s "
          f"of signal: real-time factor {GLO_DUR / wall:.3f} ({card})")
    launches.update({"K6_device_generator": k6, "K6_device_generator_GLO": k6,
                     "K3_pcps_wipe_GLO": cold, "K3_pcps_peak_GLO": cold_peak,
                     "K3b_pcps_wipe_per_channel_GLO": step2})
    return launches


def glonass_mb_path(wrappers, card: str) -> dict:
    """Phase 17(b): GLONASS L1 C/A on RF 0 at 10 Msps and L2 C/A on RF 1 at
    8 Msps, the same three satellites, GLO_MB_DUR seconds made by K6 on the
    card (launches counted apart), through attach_arrays + run_to_end from
    a cold start (assisted_session: the counters set to 0 just before and
    read just after).  Checks: every L2 search assisted, each centre within
    50 Hz of the true L1 Doppler x 7/9 (the slot offsets scale alike); each
    satellite tracked on both bands; |PR_L2 - PR_L1| < 30 m per PRN; the
    TOW and the pseudorange differences as (a)'s; no fix."""
    import torch
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    l1, _ = glonass_sky("1G")
    l2, _ = glonass_sky("2G")
    reset(wrappers)
    x1 = generate_baseband_device_resident(
        l1, FS_G1, int(FS_G1 * GLO_MB_DUR), noise=True, seed=172,
        device="cuda")
    x2 = generate_baseband_device_resident(
        l2, FS_G2, int(FS_G2 * GLO_MB_DUR), noise=True, seed=173,
        device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    conf = glonass_mb_conf()
    session, run, launches, windows, wall, wipe, peak = assisted_session(
        wrappers, conf, {0: x1, 1: x2}, {}, GLO_MB_KERNELS, FS_G2)
    del x1, x2
    torch.cuda.empty_cache()
    n1 = len(GLO_SATS)
    states = list(zip(run.channel_prns, run.channel_states))
    l1_trk, l2_trk = [sorted(p for p, s in part if s == ChannelState.TRACKING)
                      for part in (states[:n1], states[n1:])]
    want = sorted(p for p, _, _, _ in GLO_SATS)
    print(f"  L1 tracks {l1_trk}, L2 tracks {l2_trk}")
    if l1_trk != want or l2_trk != want:
        fail(f"tracked L1 {l1_trk}, L2 {l2_trk}: expected {want}")
    check_assisted_centres(session, windows, l1, 7.0 / 9.0, "2G", l2_trk,
                           primary="1G")
    diffs = band_pr_diffs(run, session.epoch_prns, n1)
    worst_pr = {p: float(np.abs(d).max()) for p, d in diffs.items()}
    print(f"  max |PR_L2 - PR_L1| by PRN {worst_pr} m")
    if sorted(diffs) != want or max(worst_pr.values()) >= MB_PR_TOL_M:
        fail(f"L2 against L1 pseudoranges {worst_pr}")
    check_glonass_observables(run, session.epoch_prns, FS_G1, "(b)")
    if run.solutions:
        fail(f"{len(run.solutions)} fixes from three satellites")
    n2 = int(FS_G2 * 1e-3)
    k3b = sum(v for s, v in wipe.items() if len(s) == 4 and s[-1] == n2)
    k3 = sum(v for s, v in peak.items() if s[2] == 9 and s[-1] == n2)
    print(f"  L2's assisted searches: K3b {k3b} launches at N={n2}, K3's "
          f"peak {k3}")
    if not (k3b and k3 == k3b):
        fail("(b) did not run L2's assisted searches on K3b")
    print(f"  wall {wall:.3f} s for {GLO_MB_DUR:g} s of two RF streams: "
          f"real-time factor {GLO_MB_DUR / wall:.3f} ({card})")
    launches["K6_device_generator"] = k6
    return launches


def check_e6_glonass_shapes(dev, card: str, rows: list, extra: list) -> None:
    """Phase 3 at phases 16's and 17's new shapes, each against its plain
    version with its kernel's tolerance (the wipeoff also bit for bit its
    Triton reference and the searches after it, wipe_case); rows named
    with _bias, _E6 and _GLO go to `rows`, the others to `extra`:
    - the FDMA bias form (a per-chain float off the Doppler in K8a's code
      stretch, K8b's code rate and K9's): K8a, K8b and K1 with both at
      slot -7's and +6's offsets (GLONASS L1 at 10 Msps, C=2, E=20) and
      at slot -7 on L2 at 8 Msps; the two-launch chunk at slot -7; K9 and
      the chunk kernel (with the rectified lock test, as the GLONASS
      chains run it) at both slots from the edge states (C=8);
    - the cold GLONASS searches centred at -3.9375 and +3.375 MHz (M=2,
      C=2, D=41, N=10000) and step two's K3b; (b)'s assisted L2 search at
      8 Msps (K3b and K3's peak, D2=9, N=8000);
    - E6: the cold search at 12.5 Msps (M=2, C=5, D=41, N=12500), step
      two's and the assisted search's K3b and K3's peak; K8a, K8b and K1
      at E6's E = 20 (C=5), the chunk kernel's rectify form at 12500
      samples an epoch (C=8); E1-B at 12.5 Msps: its cold search (M=2,
      D=81, N=50000) and step two, K8a, K8b and K1 (C=5, E=5) and the
      chunk kernel (C=8);
    - K6 on (a)'s two skies (16: E1 + E6 at 12.5 Msps, 17: GLONASS L1 at
      10 Msps) and on 17(b)'s L2 sky at 8 Msps."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import (
        glonass_l1_chain, glonass_l2_chain)
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    rng = np.random.default_rng(16)
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    taps = (0.25, 0.0, -0.25)
    glo = signals.CodeProvider("1G")
    # ---- the bias form ----------------------------------------------------
    for k, prns, dest in ((-7, (10, 14), rows), (6, (4, 8), extra)):
        chain = glonass_l1_chain(FS_G1, prns=prns, freq_slot=k)
        lab = (f"GLONASS L1 slot {k:+d} at {FS_G1 / 1e6:g} Msps, bias "
               f"{chain.trk.doppler_bias_hz:g} Hz")
        got = check_k8(dev, rng, chain.trk, 2, taps, glo, 1000,
                       tuple(n + "_bias" for n in k8), lab)
        if dest is rows:
            rows += [got[0], got[3]]
            extra += got[1:3]
            extra.append(check_block_chunk_bits(dev, rng, chain.trk, 2,
                                                taps, glo, lab))
        else:
            extra += got
        extra.append(check_k9(dev, rng, chain.trk, 8,
                              "K9_epoch_closure_bias", lab))
        row = check_epoch_chunk_bits(dev, rng, chain.trk, 8,
                                     "K9_epoch_chunk_bias", lab, 1000,
                                     chain=chain)
        dest.append(row)
        torch.cuda.empty_cache()
    l2 = glonass_l2_chain(FS_G2, prns=(10, 14), freq_slot=-7)
    extra += check_k8(dev, rng, l2.trk, 1, taps, glo, 1000,
                      tuple(n + "_bias" for n in k8),
                      f"GLONASS L2 slot -7 at {FS_G2 / 1e6:g} Msps, bias "
                      f"{l2.trk.doppler_bias_hz:g} Hz")
    torch.cuda.empty_cache()
    # ---- the GLONASS searches ---------------------------------------------
    g_sats, _ = glonass_sky()
    for k, prns, name in ((-7, (10, 14), "_GLO"), (6, (4, 8), None)):
        chain = glonass_l1_chain(FS_G1, prns=prns, freq_slot=k)
        eng = PcpsAcquisitionEngine(chain.acq, prns,
                                    code_provider=chain.code_provider,
                                    sc_rate=chain.sc_rate, device=dev)
        x = search_dwells(g_sats, FS_G1, eng, 170 + k, dev)
        cfc, m = eng.code_fft_conj, x.shape[0]
        label = (f"17(a)'s cold search of slot {k:+d} at "
                 f"{FS_G1 / 1e6:g} Msps, centred at "
                 f"{chain.acq.doppler_center:g} Hz")
        row = wipe_case(x, eng.dopplers, eng._t, label, k3_search(cfc, m), 3)
        if name:
            row["name"] = "K3_pcps_wipe" + name
            rows.append(row)
        else:
            extra.append(row)
        peak_case(rows, extra, x, eng.dopplers, eng._t, cfc, label,
                  name and "K3_pcps_peak" + name)
        table = narrow_table(eng)
        label2 = label.replace("cold search", "step two")
        row = wipe_case(x, table, eng._t, label2, k3_search(cfc, m), 3)
        if name:
            row["name"] = "K3b_pcps_wipe_per_channel" + name
            rows.append(row)
        else:
            extra.append(row)
        peak_case(rows, extra, x, table, eng._t, cfc, label2)
        del x
        torch.cuda.empty_cache()
    l2_sats, _ = glonass_sky("2G")
    eng = PcpsAcquisitionEngine(l2.acq, (10, 11, 4),
                                code_provider=l2.code_provider,
                                sc_rate=l2.sc_rate, device=dev)
    x = search_dwells(l2_sats, FS_G2, eng, 174, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    table = narrow_table(eng, 62.5)
    label = f"17(b)'s assisted L2 search at {FS_G2 / 1e6:g} Msps"
    extra.append(wipe_case(x, table, eng._t, label, k3_search(cfc, m), 3))
    peak_case(rows, extra, x, table, eng._t, cfc, label)
    del x
    torch.cuda.empty_cache()
    # ---- E6 and E1 at 12.5 Msps -------------------------------------------
    e1_sats, e6_sats = e6_sky(E6_DUR)
    e6 = e6_chain()
    eng = PcpsAcquisitionEngine(e6.acq, E6_PRNS,
                                code_provider=e6.code_provider,
                                sc_rate=e6.sc_rate, device=dev)
    x = search_dwells(e6_sats, FS_E6, eng, 163, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = (f"16(b)'s cold E6 search at {FS_E6 / 1e6:g} Msps (the doubled "
             "FFT)")
    row = wipe_case(x, eng.dopplers, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3_pcps_wipe_E6"
    rows.append(row)
    peak_case(rows, extra, x, eng.dopplers, eng._t, cfc, label,
              "K3_pcps_peak_E6")
    for table, lab, wipe_name, peak_name in (
            (narrow_table(eng), "16(b)'s E6 step two",
             "K3b_pcps_wipe_per_channel_E6", None),
            (narrow_table(eng, 62.5), "16(a)'s assisted E6 search", None,
             "K3_pcps_peak_assisted_E6")):
        lab = f"{lab} at {FS_E6 / 1e6:g} Msps"
        row = wipe_case(x, table, eng._t, lab, k3_search(cfc, m), 3)
        if wipe_name:
            row["name"] = wipe_name
            rows.append(row)
        else:
            extra.append(row)
        peak_case(rows, extra, x, table, eng._t, cfc, lab, peak_name)
    del x
    torch.cuda.empty_cache()
    e1 = receiver_conf_from_config(InMemoryConfiguration(conf_properties(
        E6_CONF.format(capture="absent.ibyte", fs=FS_E6)))).chains[0]
    eng = PcpsAcquisitionEngine(e1.acq, E6_PRNS,
                                code_provider=e1.code_provider,
                                sc_rate=e1.sc_rate, device=dev)
    x = search_dwells(e1_sats, FS_E6, eng, 164, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = f"16(a)'s cold E1-B search at {FS_E6 / 1e6:g} Msps"
    for table, lab in ((eng.dopplers, label),
                       (narrow_table(eng), label + ", step two")):
        extra.append(wipe_case(x, table, eng._t, lab, k3_search(cfc, m), 3))
        peak_case(rows, extra, x, table, eng._t, cfc, lab)
    del x
    torch.cuda.empty_cache()
    lab6 = f"Galileo E6-B at {FS_E6 / 1e6:g} Msps, rectified lock"
    got = check_k8(dev, rng, e6.trk, E6_CHANNELS, taps, e6.code_provider,
                   1000, tuple(n + "_E6" for n in k8), lab6)
    rows += [got[0], got[3]]
    extra += got[1:3]
    torch.cuda.empty_cache()
    rows.append(check_epoch_chunk_bits(dev, rng, e6.trk, 8,
                                       "K9_epoch_chunk_E6", lab6, 1000,
                                       chain=e6))
    torch.cuda.empty_cache()
    lab1 = f"Galileo E1-B at {FS_E6 / 1e6:g} Msps"
    extra += check_k8(dev, rng, e1.trk, E6_CHANNELS, conf_taps(e1.trk),
                      e1.code_provider, 250, k8, lab1)
    torch.cuda.empty_cache()
    extra.append(check_epoch_chunk_bits(dev, rng, e1.trk, 8,
                                        "K9_epoch_chunk", lab1, 250,
                                        chain=e1))
    torch.cuda.empty_cache()
    # ---- K6 on the new skies ----------------------------------------------
    for fs, sats, dur, seed, name, lab in (
            (FS_E6, e1_sats + e6_sats, E6_DUR, 161, "K6_device_generator_E6",
             f"16(a)'s E1 + E6 sky at {FS_E6 / 1e6:g} Msps"),
            (FS_G1, g_sats, GLO_DUR, 171, "K6_device_generator_GLO",
             f"17(a)'s GLONASS L1 sky at {FS_G1 / 1e6:g} Msps"),
            (FS_G2, l2_sats, GLO_MB_DUR, 173, None,
             f"17(b)'s GLONASS L2 sky at {FS_G2 / 1e6:g} Msps")):
        row = check_k6(dev, fs, sats, dur, seed, lab)
        if name is None:
            extra.append(row)
        else:
            row["name"] = name
            rows.append(row)
        torch.cuda.empty_cache()


# ---- phase 18: SBAS L1 and the corrected single-point fix -------------------

# 18(a): phase 4's sky and rate (a 4 Msps ishort file, the x2 FIR) with two
# GEOs on the WAAS PRNs 131 and 133 (their longitudes, a small Doppler each,
# 45 dB-Hz): (PRN, longitude deg, Doppler Hz)
SBAS_GEOS = ((131, -117.0, 35.0), (133, -98.0, -60.0))
SBAS_CN0 = 45.0
SBAS_DUR = 26.0
# the degradation the broadcast corrects, planted in the GPS signals' code
# delays (the simulator emits no iono or tropo delay of its own): per
# satellite of SCENARIO_PRNS a range bias (MT2's fast corrections carry
# -bias), one satellite's long-term error (MT25: position and clock
# deltas, (PRN, dpos m, daf0 s)) and a thin-shell iono delay (MT18/MT26's
# grid, vertical 3 m at the receiver, linear in latitude and longitude so
# that the grid's bilinear interpolation holds it exactly; slant by the
# DO-229 obliquity at 350 km)
SBAS_BIAS_M = (3.0, -4.5, 2.25, -1.75, 5.0, -2.5)
SBAS_LT = (4, (1.5, -2.0, 0.625), 21 * 2.0 ** -31)
# no MT12 in the broadcast: with MT12 the GEO channels stamp TOW, range,
# and the fix raises AttributeError in both packages (the GEO's MT9
# ephemeris reaches the Kepler batch; ROADMAP.md queue 3)
SBAS_TOL_M = 3.0                # tests/test_sbas_apply.py's bounds
SBAS_RATIO = 0.5
SBAS_CONF = CONF.replace("Channels_1C.count=8", """\
Channels_1C.count=8
Channels_S1.count=2
Channel8.satellite=131
Channel9.satellite=133
Acquisition_S1.implementation=SBAS_L1_PCPS_Acquisition
Tracking_S1.implementation=SBAS_L1_DLL_PLL_Tracking""")
SBAS_KERNELS = ("K1_block_correlate", "K1_K8b_K8a_block_step",
                "K9_epoch_chunk", "K9_epoch_chunk_rectify", "K3_pcps_wipe",
                "K3_pcps_peak", "K3b_pcps_wipe_per_channel")
# 18(b): eight satellites of the sky at 2 Msps, ephemerides given (an
# assisted start), LNAV subframes 1 and 4 with page 18's iono parameters
# (the typical broadcast set of tests/test_pvt_extras.py); the Klobuchar
# delay of those parameters, the Saastamoinen delay and a 60 m fault on
# PRN 2 planted in the code delays
MODES_PRNS = (1, 2, 3, 4, 5, 6, 9, 10)
MODES_FAULT = (2, 60.0)
MODES_ALPHA = (1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8)
MODES_BETA = (90112.0, 0.0, -196608.0, -65536.0)
MODES_DUR = 16.5              # K6's last launch in a partial tile
# the fixes' bounds: the receiver's warm-started fixes skip the atmosphere
# (the reference's LS loop converges before its atmosphere iteration;
# ROADMAP.md queue 3), so with the fault excluded they sit within 12 m,
# and with the models and RAIM OFF the fault drags them beyond it; the
# run's epochs solved cold with the models apply them: within 3 m
MODES_WARM_TOL_M = 12.0
MODES_COLD_TOL_M = 3.0
MODES_CONF = """\
GNSS-SDR.internal_fs_sps=2000000
Channels_1C.count=8
Channels.in_acquisition=8
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.pfa=0.01
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
PVT.output_rate_ms=20
"""
MODES_ON = {"PVT.iono_model": "Broadcast", "PVT.trop_model": "Saastamoinen",
            "PVT.raim_fde": "true"}
MODES_SMOOTH = {**MODES_ON, "Observables.smoothing_factor": "100",
                "PVT.enable_pvt_kf": "true"}


def _ipp(lat, lon, el, az):
    """The pierce point (deg) at 350 km of a ray at (el, az) from (lat, lon)
    (rad): solve_pvt's formulas (DO-229 A.4.4.10)."""
    re, hi = 6378136.3, 350e3
    psi = np.pi / 2 - el - np.arcsin(re / (re + hi) * np.cos(el))
    lat_i = np.arcsin(np.sin(lat) * np.cos(psi)
                      + np.cos(lat) * np.sin(psi) * np.cos(az))
    lon_i = lon + np.arcsin(np.sin(psi) * np.sin(az) / np.cos(lat_i))
    return np.degrees(lat_i), np.degrees(lon_i)


def sbas_vertical_m(lat_deg, lon_deg):
    """The planted vertical iono delay (m): 3 m at the receiver, a 0.05 m
    per degree gradient north and 0.025 m per degree east (multiples of
    MT26's 0.125 m at every 5-degree IGP)."""
    return 3.0 + (lat_deg - RX_LLH[0]) / 20.0 + (lon_deg - RX_LLH[1]) / 40.0


def _set_field(payload, start: int, n: int, value: int):
    """`payload` with the n-bit field at `start` set to `value` (MSB
    first): the DO-229 fields the packers leave at zero."""
    out = payload.copy()
    out[start:start + n] = [(value >> (n - 1 - i)) & 1 for i in range(n)]
    return out


def sbas_broadcast(ephs):
    """The SBAS message cycle and the per-satellite range errors it
    corrects: (messages without MT9, {PRN: planted error m}, {PRN: fast
    correction m}, the IGPs {(lat, lon): vertical m}).  As a WAAS-like
    broadcast does, the mask holds every GPS PRN (MT2 to MT4 carry their
    fast corrections: -bias on the sky's, a few metres drawn from a seed
    on the others) and the fields the packers leave at zero carry a
    broadcast's values (DO-229 A.4.4): the issues of data (IODP 2, IODF 1,
    IODI 3), the UDREIs (5 on the masked slots, 15 "do not use" on the
    rest), MT25's second satellite (PRN 9, no delta) and MT26's GIVEIs (11
    on the masked IGPs, 15 "not monitored" on the rest).  A sparser cycle
    (the sky's PRNs alone, the zero fields) changes symbol at 22 % of the
    boundaries, under the 25 % the decoder's epoch-pairing vote needs, and
    no message decodes, in JAX alike (ROADMAP.md queue 3)."""
    from gnss_sim_receiver_tpu_torch.nav import sbas
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    rx = rx_true_ecef()
    lat, lon = np.radians(RX_LLH[0]), np.radians(RX_LLH[1])
    prns = [e.prn for e in ephs]
    errors, igps = {}, {}
    for e, bias in zip(ephs, SBAS_BIAS_M):
        pos, _ = e.sat_pos_clock(T0 + SBAS_DUR / 2)
        el, az = geodesy.elevation_azimuth(rx, pos)
        la, lo = _ipp(lat, lon, el, az)
        re, hi = 6378136.3, 350e3
        slant = sbas_vertical_m(la, lo) / np.sqrt(
            1.0 - (re * np.cos(el) / (re + hi)) ** 2)
        errors[e.prn] = bias + slant
        la0, lo0 = 5.0 * np.floor(la / 5.0), 5.0 * np.floor(lo / 5.0)
        for c in ((la0, lo0), (la0 + 5, lo0), (la0, lo0 + 5),
                  (la0 + 5, lo0 + 5)):
            igps[c] = sbas_vertical_m(*c)
        if e.prn == SBAS_LT[0]:
            u = (pos - rx) / np.linalg.norm(pos - rx)
            errors[e.prn] += (float(u @ np.asarray(SBAS_LT[1]))
                              - 299_792_458.0 * SBAS_LT[2])
    mask = list(range(1, 33))
    rng = np.random.default_rng(180)
    prc = {p: float(v) for p, v in zip(
        mask, 0.125 * rng.integers(-40, 41, len(mask)))}
    prc.update({p: -b for p, b in zip(prns, SBAS_BIAS_M)})
    msgs = [(1, sbas.pack_mt1(mask, iodp=2))]
    for k, mt in enumerate((2, 3, 4)):
        slots = mask[13 * k:13 * k + 13]
        pl = sbas.pack_mt2([prc[p] for p in slots], mt=mt, iodf=1, iodp=2)
        for i in range(13):
            pl = _set_field(pl, 160 + 4 * i, 4, 5 if i < len(slots) else 15)
        msgs.append((mt, pl))
    iode = {e.prn: e.iode for e in ephs}
    msgs.append((25, sbas.pack_mt25([
        sbas.SbasLongTerm(slot=SBAS_LT[0], iode=iode[SBAS_LT[0]],
                          dpos_m=SBAS_LT[1], daf0_s=SBAS_LT[2]),
        sbas.SbasLongTerm(slot=9, iode=iode[9])], iodp=2)))
    bands = collections.defaultdict(list)
    for la, lo in sorted(igps):
        band = int((lo + 180.0) // 40.0)
        mer = int(round((lo + 180.0 - 40.0 * band) / 5.0))
        bands[band].append(mer * len(sbas.IGP_LATS)
                           + list(sbas.IGP_LATS).index(int(la)))
    for band, idx in sorted(bands.items()):
        idx.sort()
        msgs.append((18, sbas.pack_mt18(band, idx, n_bands=len(bands),
                                        iodi=3)))
        vals = [igps[sbas.igp_latlon(band, i)] for i in idx]
        for b in range((len(vals) + 14) // 15):
            mt26 = sbas.pack_mt26(band, b, vals[15 * b:15 * b + 15], iodi=3)
            for i in range(15):
                mt26 = _set_field(mt26, 8 + 13 * i + 9, 4,
                                  11 if 15 * b + i < len(vals) else 15)
            msgs.append((26, mt26))
    return msgs, errors, prc, igps


def sbas_geo_nav(lon_deg: float):
    """A GEO's MT9 navigation: its ECEF position at T0 (on the equator at
    35,786 km), at rest."""
    from gnss_sim_receiver_tpu_torch.nav import sbas
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    pos = geodesy.llh_to_ecef(0.0, np.radians(lon_deg), 35_786e3)
    return sbas.parse_mt9(sbas.pack_mt9(sbas.SbasGeoNav(
        iodn=5, t0_s=T0, pos_m=tuple(float(v) for v in pos))))


def sbas_sky(dur: float = SBAS_DUR):
    """18(a)'s sky: phase 4's six GPS satellites with the planted errors in
    their code delays, and the GEOs, each sending the message cycle with
    its own MT9 (message k of the stream is cycle[k % len(cycle)], with
    preamble k % 3), repeated for `dur`: (satellites, the cycle by GEO
    PRN, planted errors, fast corrections, IGPs)."""
    from gnss_sim_receiver_tpu_torch.nav import sbas
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.sim.signal_generator import \
        SatelliteSignalParams
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    cycle, errors, prc, igps = sbas_broadcast(ephs)
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, dur,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 2, 3))
    for s in sats:
        s.delay_sec += errors[s.prn] / 299_792_458.0
    planted = {}
    for prn, lon, dop in SBAS_GEOS:
        nav = sbas_geo_nav(lon)
        planted[prn] = one = cycle + [(9, sbas.pack_mt9(nav))]
        msgs = one * int(np.ceil((dur + 3.0) / len(one)))
        sats.append(SatelliteSignalParams(
            prn=prn, system="SBAS", signal="S1", cn0_db_hz=SBAS_CN0,
            doppler_hz=dop, delay_sec=float(np.linalg.norm(
                np.asarray(nav.pos_m) - rx_true_ecef())) / 299_792_458.0,
            nav_bits=sbas.sbas_epoch_signs(sbas.symbols_for_messages(msgs))))
    return sats, planted, errors, prc, igps


def enu_error(solutions) -> float:
    """The 3D norm of the mean ENU error of `solutions`."""
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ref = (np.radians(RX_LLH[0]), np.radians(RX_LLH[1]))
    enu = np.array([geodesy.ecef_to_enu(s.rx_ecef_m - rx_true_ecef(), ref)
                    for s in solutions]).reshape(-1, 3)
    if not len(enu) or not np.isfinite(enu).all():
        fail(f"{len(enu)} fixes, finite: {np.isfinite(enu).all()}")
    return float(np.linalg.norm(enu.mean(0)))


def cold_fixes(run, session, conf, **kw) -> list:
    """The run's observation epochs that the receiver fixed, solved again
    from no prior position (x0 = None, as the receiver's first fix), with
    the session's channel maps and ephemerides."""
    from gnss_sim_receiver_tpu_torch.models.pvt import solve_pvt_raim
    systems = [rt.spec.system for rt in session.chains
               for _ in range(rt.spec.n_channels)]
    fixed = {round((s.rx_time_corrected_s + s.rx_clock_bias_s) * 1e3)
             for s in run.solutions}
    out = []
    for ep, prns in zip(run.observation_epochs, session.epoch_prns):
        if round(ep.rx_time_s * 1e3) not in fixed:
            continue
        sol = solve_pvt_raim(ep, prns, run.ephemerides, conf,
                             systems=systems,
                             carrier_freq_hz=session.freq_map, **kw)
        if sol.valid:
            out.append(sol)
    return out


def check_sbas_messages(session, planted) -> None:
    """Every decoded message's CRC passed and each one planted: the type,
    payload and preamble of message k of its GEO's stream (cycle entry
    k % L, preamble k % 3); every entry of each GEO's cycle decoded."""
    seen = collections.defaultdict(set)
    msgs = session.chains[1].tlm.messages
    for _, prn, ev in msgs:
        cycle = planted[prn]
        hits = [j for j, (mt, pl) in enumerate(cycle)
                if mt == ev.msg_type and np.array_equal(pl, ev.payload)
                and any(k % 3 == ev.preamble_idx
                        for k in range(j, 3 * len(cycle), len(cycle)))]
        if not ev.crc_ok or not hits:
            fail(f"GEO {prn}: message type {ev.msg_type} at symbol "
                 f"{ev.start_symbol} is not one planted (CRC {ev.crc_ok})")
        seen[prn].update(hits)
    count = collections.Counter(prn for _, prn, _ in msgs)
    whole = {p: f"{len(v)} of {len(planted[p])}" for p, v in seen.items()}
    print(f"  decoded messages by GEO {dict(count)}, every CRC passing and "
          f"each equal to one planted; cycle entries seen {whole}")
    if any(len(seen[p]) != len(planted[p]) for p in planted):
        fail("a GEO's cycle was not decoded whole")


def sbas_path(root: str, wrappers, card: str) -> dict:
    """Phase 18(a): GPS L1 C/A + SBAS L1 through the CLI at phase 4's rate.
    K6 makes sbas_sky for SBAS_DUR seconds at 4 Msps, written as ishort
    (launches counted apart); the counters set to 0 just before
    run_cli(SBAS_CONF) and read just after, the session kept.  Checks: the
    GPS set tracked and both GEOs on their pinned channels; every decoded
    message's CRC passed and each one of those planted, a whole cycle from
    each GEO; the corrections state equal to the planted one (the mask,
    the fast corrections, the long-term deltas, every IGP's vertical delay)
    and each GEO's MT9 ephemeris published; the corrected fix (the run's
    fixed epochs solved from no prior position with the session's
    corrections) within SBAS_TOL_M 3D and under SBAS_RATIO of the error
    of the same capture run with Channels_S1.count=0; the run's own fixes
    (the fast and long-term corrections on, the iono grid skipped after
    the first fix, ROADMAP.md queue 3) printed beside them; the S1 chain's
    launches at its shapes; the real-time factor."""
    import torch
    from gnss_sim_receiver_tpu_torch.__main__ import run_cli
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.models import tracking_block as tb
    from gnss_sim_receiver_tpu_torch.models.control import ChannelState
    from gnss_sim_receiver_tpu_torch.nav.sbas import SbasGeoEphemeris
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    path = os.path.join(root, "build", "sbas_scenario_26s_4msps_v1.ishort")
    sats, planted, errors, prc, igps = sbas_sky()
    print(f"  planted range errors (m) by PRN "
          f"{ {p: round(v, 3) for p, v in errors.items()} }; {len(igps)} "
          f"IGPs; each GEO's cycle of message types "
          f"{[m for m, _ in planted[SBAS_GEOS[0][0]]]}")
    reset(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = generate_baseband_device_resident(
        sats, FS_FILE, int(FS_FILE * SBAS_DUR), noise=True, seed=181,
        device="cuda")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_samples(path, x, "ishort", scale=200.0)
    del x
    torch.cuda.empty_cache()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    print(f"  K6 made and wrote {os.path.getsize(path) / 1e6:.0f} MB ishort "
          f"at {FS_FILE / 1e6:g} Msps in {time.perf_counter() - t0:.3f} s "
          "(not timed)")
    confs = {}
    for name, text in (("sbas", SBAS_CONF), ("gps", CONF)):
        confs[name] = os.path.join(root, "build", f"chip_smoke_{name}18.conf")
        with open(confs[name], "w") as fh:
            fh.write(text.format(capture=path))
    tb.block_prologue.shapes.clear()
    tb.block_correlate_close.fold_shapes.clear()
    trk.epoch_chunk.shapes.clear()
    shapes0 = shape_counts()
    reset(wrappers)
    torch.cuda.synchronize()
    log = {}
    res = cli_session([f"--config_file={confs['sbas']}"], log)
    torch.cuda.synchronize()
    launches = read_launches(wrappers, SBAS_KERNELS)
    session, run = log["session"], res.run
    if res.exit_code != 0:
        fail(f"the CLI returned {res.exit_code}")
    wipe, peak = (a - b for a, b in zip(shape_counts(), shapes0))
    # the S1 chain's shapes: C = 2 on the block step and the chunk kernel,
    # the doubled FFT (N = 4000 at 2 Msps) in its searches
    n2 = 2 * int(FS * 1e-3)
    s1 = {"K8a_block_prologue_S1": sum(
              v for s, v in tb.block_prologue.shapes.items() if s[0] == 2),
          "K1_K8b_K8a_block_step_S1": sum(
              v for s, v in tb.block_correlate_close.fold_shapes.items()
              if s[0] == 2),
          "K9_epoch_chunk_S1": sum(v for s, v in trk.epoch_chunk.shapes.items()
                                   if s[0] == 2),
          "K3_pcps_wipe_S1": sum(v for s, v in wipe.items()
                                 if len(s) == 3 and s[-1] == n2),
          "K3_pcps_peak_S1": sum(v for s, v in peak.items()
                                 if s[2] == 41 and s[-1] == n2),
          "K3b_pcps_wipe_per_channel_S1": sum(
              v for s, v in wipe.items() if len(s) == 4 and s[-1] == n2)}
    tracked = [(p, s == ChannelState.TRACKING)
               for p, s in zip(run.channel_prns, run.channel_states)]
    print(f"  channels (PRN, tracking) {tracked}")
    gps = sorted(p for p, t in tracked[:8] if t and p)
    if gps != list(SCENARIO_PRNS) or tracked[8:] != [(131, True),
                                                      (133, True)]:
        fail(f"tracked {tracked}")
    check_sbas_messages(session, planted)
    corr = session.sbas_corr
    lt = corr.long_term.get(SBAS_LT[0])
    print(f"  corrections: mask {corr.prn_mask}, fast {corr.fast_prc}, "
          f"long-term {lt}, {len(corr.iono)} IGPs held")
    if (corr.prn_mask != list(range(1, 33)) or corr.fast_prc != prc
            or lt is None or tuple(lt.dpos_m) != SBAS_LT[1]
            or abs(lt.daf0_s - SBAS_LT[2]) > 2.0 ** -31
            or sorted(corr.iono) != sorted(igps)
            or max(abs(corr.iono[k] - v) for k, v in igps.items()) > 1e-9):
        fail("the corrections state is not the planted one")
    for prn, lon, _ in SBAS_GEOS:
        geo = run.ephemerides.get(("SBAS", prn))
        if not isinstance(geo, SbasGeoEphemeris) or \
                tuple(geo.nav.pos_m) != tuple(sbas_geo_nav(lon).pos_m):
            fail(f"GEO {prn}'s MT9 ephemeris: {geo}")
    if any(ep.valid[8:].any() for ep in run.observation_epochs):
        fail("a GEO channel gave an observable without MT12")
    cold = cold_fixes(run, session, session.conf.pvt,
                      sbas_corrections=corr)
    cold_raw = cold_fixes(run, session, session.conf.pvt)
    warm = enu_error(run.solutions)
    reset(wrappers)
    base = run_cli([f"--config_file={confs['gps']}"])
    os.remove(path)
    if base.exit_code != 0:
        fail(f"the CLI without SBAS returned {base.exit_code}")
    e_base = enu_error(base.run.solutions)
    e_cold, e_raw = enu_error(cold), enu_error(cold_raw)
    print(f"  mean 3D error: corrected fix (the {len(cold)} fixed epochs "
          f"solved cold with the corrections) {e_cold:.3f} m, the same "
          f"epochs without them {e_raw:.3f} m; Channels_S1.count=0 "
          f"{e_base:.3f} m ({len(base.run.solutions)} fixes); the run's own "
          f"{len(run.solutions)} fixes {warm:.3f} m (the grid skipped after "
          "the first)")
    if not (e_cold < SBAS_TOL_M and e_cold < SBAS_RATIO * e_base):
        fail(f"the corrected fix: {e_cold:.3f} m against {e_base:.3f} m")
    print(f"  the S1 chain's launches {s1}; the wipeoff by shape "
          f"{dict(wipe)}, K3's peak {dict(peak)}")
    if not all(s1.values()):
        fail("the S1 chain did not run its searches, the block step and "
             "the chunk kernel")
    sec = res.seconds
    wall = sum(sec.values())
    print(f"  seconds: read {sec['read']:.3f}, upload and conditioning "
          f"{sec['condition']:.3f}, receiver {sec['receiver']:.3f}")
    print(f"  wall {wall:.3f} s from file open to the last fix for "
          f"{SBAS_DUR:g} s of signal: real-time factor {SBAS_DUR / wall:.3f} "
          f"({card})")
    launches.update(s1, K6_device_generator=k6, K6_device_generator_S1=k6)
    return launches


def modes_sky(dur: float = MODES_DUR):
    """18(b)'s sky: MODES_PRNS of the sky at 47 dB-Hz, LNAV subframes 1
    and 4 (every subframe 4 page 18 with MODES_ALPHA, MODES_BETA) from T0,
    the Klobuchar and Saastamoinen delays at mid-capture and the fault
    planted in the code delays: (satellites, ephemerides by PRN, planted
    delays by PRN)."""
    from gnss_sim_receiver_tpu_torch.models.atmosphere import (
        klobuchar_delay, saastamoinen_delay)
    from gnss_sim_receiver_tpu_torch.nav import lnav
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    from gnss_sim_receiver_tpu_torch.utils import geodesy
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in MODES_PRNS]
    iono = {**{f"alpha{i}": a for i, a in enumerate(MODES_ALPHA)},
            **{f"beta{i}": b for i, b in enumerate(MODES_BETA)}}
    sats = build_static_scenario(ephs, rx_true_ecef(), T0, dur,
                                 cn0_db_hz=47.0, subframe_cycle=(1, 4))
    lat, lon, h = RX_LLH
    lat, lon = np.radians(lat), np.radians(lon)
    delays = {}
    for s, e in zip(sats, ephs):
        s.nav_bits = (2 * lnav.frames_for_ephemeris(
            e, T0, n_frames=int(dur // 12) + 2, subframe_cycle=(1, 4),
            iono_utc=iono) - 1).astype(np.int8)
        t = T0 + dur / 2
        pos, _ = e.sat_pos_clock(t)
        el, az = geodesy.elevation_azimuth(rx_true_ecef(), pos)
        delays[e.prn] = (klobuchar_delay(MODES_ALPHA, MODES_BETA, lat, lon,
                                         el, az, t)
                         + saastamoinen_delay(lat, h, el)
                         + (MODES_FAULT[1] if e.prn == MODES_FAULT[0]
                            else 0.0))
        s.delay_sec += delays[e.prn] / 299_792_458.0
    return sats, {e.prn: e for e in ephs}, delays


def modes_path(wrappers, card: str) -> dict:
    """Phase 18(b): the PVT modes on one GPS capture.  K6 makes modes_sky
    at 2 Msps for MODES_DUR seconds on the card (launches counted apart);
    the receiver is built by the factory from MODES_CONF with (1)
    PVT.iono_model=Broadcast, trop_model=Saastamoinen and raim_fde=true,
    (2) none of them, (3) (1) with Observables.smoothing_factor=100 and
    PVT.enable_pvt_kf=true, each run through process_array with the
    ephemerides given (the counters set to 0 before and read after each).
    Checks: the page-18 parameters fed into the run's PvtConf; (1) every
    fix without the faulty channel, their mean 3D error within
    MODES_WARM_TOL_M, the fixed epochs solved cold with the run's PvtConf
    within MODES_COLD_TOL_M; (2) the faulty channel in every fix, the
    error beyond MODES_WARM_TOL_M; (3) valid, finite fixes, both filters
    on, the smoothed pseudoranges' distance from the raw ones printed (it
    grows: the reference's Hatch filter runs away on the receiver's phase,
    ROADMAP.md queue 3, and RAIM then excludes by the runaway's residuals,
    so the fault's exclusion is printed, not held); the real-time
    factors."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    sats, ephs, delays = modes_sky()
    print(f"  planted delays (m) by PRN "
          f"{ {p: round(v, 3) for p, v in delays.items()} } (PRN "
          f"{MODES_FAULT[0]}: with the {MODES_FAULT[1]:g} m fault)")
    reset(wrappers)
    x = generate_baseband_device_resident(
        sats, FS, int(FS * MODES_DUR), noise=True, seed=182, device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    fault_ch = MODES_PRNS.index(MODES_FAULT[0])
    launches = {}
    runs = {}
    for name, keys in (("on", MODES_ON), ("off", {}),
                       ("smooth", MODES_SMOOTH)):
        conf = receiver_conf_from_config(InMemoryConfiguration(
            {**conf_properties(MODES_CONF), **keys}))
        conf = dataclasses.replace(conf, pinned_channels={
            c: p for c, p in enumerate(MODES_PRNS)})
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session = log_epochs(Receiver(conf).start_session(
            ephemerides=dict(ephs)))
        session.attach_array(x)
        session.run_to_end()
        run = session.result()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(wrappers, BLOCK_PATH_KERNELS)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = (session, run, conf)
        used = [fault_ch in s.used_channels for s in run.solutions]
        err = enu_error(run.solutions)
        print(f"  ({name}) {len(run.solutions)} fixes, the faulty channel in "
              f"{sum(used)}; mean 3D error {err:.3f} m; iono alpha "
              f"{conf.pvt.iono_alpha}; {MODES_DUR / wall:.3f} x real time "
              f"({wall:.3f} s of receiver; {card})")
        if len(run.solutions) < 100:
            fail(f"({name}) {len(run.solutions)} fixes")
        if name == "off" and (not all(used) or err <= MODES_WARM_TOL_M):
            fail(f"(off) the fault in {sum(used)} fixes, {err:.3f} m")
        # page 18 carries alpha in 8 bits at 2^-30 to 2^-24
        if name != "off" and not np.allclose(conf.pvt.iono_alpha,
                                             MODES_ALPHA, rtol=0.01):
            fail(f"({name}) alpha {conf.pvt.iono_alpha}")
        if name == "on" and (any(used) or err >= MODES_WARM_TOL_M):
            fail(f"(on) the fault in {sum(used)} fixes, {err:.3f} m")
    session, run, conf = runs["on"]
    cold = cold_fixes(run, session, conf.pvt)
    e_cold = enu_error(cold)
    excl = sum(fault_ch not in s.used_channels for s in cold)
    print(f"  (on) the {len(cold)} fixed epochs solved cold with the run's "
          f"PvtConf (models applied): mean 3D error {e_cold:.3f} m, the "
          f"faulty channel excluded in {excl}")
    if e_cold >= MODES_COLD_TOL_M or excl != len(cold):
        fail(f"(on) cold: {e_cold:.3f} m, excluded in {excl} of {len(cold)}")
    s_sess, s_run, s_conf = runs["smooth"]
    if s_sess.pvt_kf is None or s_conf.obs.smoothing_factor != 100 \
            or s_sess.obs_eng.conf.smoothing_factor != 100:
        fail("(smooth) the Hatch filter or the PVT Kalman filter is off")
    diff = [np.abs(a.pseudorange_m - b.pseudorange_m)[a.valid & b.valid]
            for a, b in zip(s_run.observation_epochs,
                            runs["on"][1].observation_epochs)]
    drift = [float(d.max()) for d in diff if d.size]
    print(f"  (smooth) the Hatch-smoothed pseudoranges against (on)'s raw "
          f"ones: {drift[0]:.3f} m at the first epoch, {drift[-1]:.3f} m at "
          "the last (the filter adds the loops' phase, which rises as the "
          "range falls: the smoothed range runs away, in JAX alike, "
          "ROADMAP.md queue 3)")
    del x
    torch.cuda.empty_cache()
    launches["K6_device_generator"] = k6
    return launches


def check_sbas_shapes(dev, card: str, rows: list, extra: list) -> None:
    """Phase 3 at phase 18's new shapes, each against its plain version
    with its kernel's tolerance (the wipeoff also bit for bit its Triton
    reference and the searches after it, wipe_case); rows named _S1 go to
    `rows`, the others to `extra`:
    - the S1 chain's cold search at 2 Msps (M=2, the doubled FFT: N=4000,
      D=41, both GEOs' PRNs) and step two's K3b and K3's peak;
    - K8a, K8b and K1 with both at the S1 chain's C=2 (E=20, the rectified
      lock test), the two-launch chunk; the chunk kernel's rectify form at
      C=8 (the edge states take six), 2000 samples an epoch;
    - K6 on 18(a)'s sky (GPS and the GEOs at 4 Msps) and 18(b)'s (2 Msps).
    18(b)'s GPS chain runs at phase 4's shapes (C=8, 2 Msps)."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.models.acquisition import \
        PcpsAcquisitionEngine
    from gnss_sim_receiver_tpu_torch.models.receiver import sbas_l1_chain
    rng = np.random.default_rng(18)
    chain = sbas_l1_chain(FS, prns=tuple(p for p, _, _ in SBAS_GEOS))
    sky = sbas_sky()[0]
    geos = [s for s in sky if s.signal == "S1"]
    eng = PcpsAcquisitionEngine(chain.acq, chain.prns,
                                code_provider=chain.code_provider,
                                sc_rate=chain.sc_rate, device=dev)
    x = search_dwells(geos, FS, eng, 183, dev)
    cfc, m = eng.code_fft_conj, x.shape[0]
    label = (f"18(a)'s cold S1 search at {FS / 1e6:g} Msps (the doubled "
             "FFT)")
    row = wipe_case(x, eng.dopplers, eng._t, label, k3_search(cfc, m), 3)
    row["name"] = "K3_pcps_wipe_S1"
    rows.append(row)
    peak_case(rows, extra, x, eng.dopplers, eng._t, cfc, label,
              "K3_pcps_peak_S1")
    table = narrow_table(eng)
    label2 = label.replace("cold S1 search", "S1 step two")
    row = wipe_case(x, table, eng._t, label2, k3_search(cfc, m), 3)
    row["name"] = "K3b_pcps_wipe_per_channel_S1"
    rows.append(row)
    peak_case(rows, extra, x, table, eng._t, cfc, label2)
    del x
    torch.cuda.empty_cache()
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    taps = (0.25, 0.0, -0.25)
    lab = f"SBAS L1 at {FS / 1e6:g} Msps, C = 2, rectified lock"

    def codes(prn):
        # the SBAS codes in place of the helpers' PRNs 1..C and 11..
        return chain.code_provider(120 + prn % 19)
    got = check_k8(dev, rng, chain.trk, 2, taps, codes, 1000,
                   tuple(n + "_S1" for n in k8), lab)
    rows += [got[0], got[3]]
    extra += got[1:3]
    extra.append(check_block_chunk_bits(dev, rng, chain.trk, 2, taps, codes,
                                        lab))
    torch.cuda.empty_cache()
    # the chunk kernel at C = 8, as phase 3's other chunk rows: epoch_state's
    # edge states take six channels (one cluster a channel; the path runs
    # two)
    rows.append(check_epoch_chunk_bits(
        dev, rng, chain.trk, 8, "K9_epoch_chunk_S1",
        lab.replace("C = 2", "C = 8"), 1000,
        chain=dataclasses.replace(chain, code_provider=codes)))
    torch.cuda.empty_cache()
    row = check_k6(dev, FS_FILE, sky, SBAS_DUR, 181,
                   f"18(a)'s GPS + SBAS sky at {FS_FILE / 1e6:g} Msps")
    row["name"] = "K6_device_generator_S1"
    rows.append(row)
    torch.cuda.empty_cache()
    extra.append(check_k6(dev, FS, modes_sky()[0], MODES_DUR, 182,
                          f"18(b)'s GPS sky at {FS / 1e6:g} Msps"))
    torch.cuda.empty_cache()


# ---- phase 19: the PVT modes beyond the single-point fix --------------------

# tests/fixtures.py's RTK pair, the port's own copy of its constants: phase
# 4's sky (SCENARIO_PRNS at RX_LLH, T0, subframes 1, 2, 3) at a strong 55
# dB-Hz (there the float solution converges within the capture), the rover
# ROVER_ENU metres (east, north, up) from the base, both at 2 Msps
RTK_CN0 = 55.0
ROVER_ENU = (6.0, 3.0, 0.5)
# 19(a): the base 44 s through process_array, the rover 40 s through the
# CLI: the rover decodes its own ephemerides (the CLI has no assistance),
# which takes up to ~24 s (tests/fixtures.py:61), and fixes after them
RTK_BASE_DUR = 44.0
RTK_ROVER_DUR = 40.0
# 19(b): the rover's first 20 s over the RTCM stream, the decoder's
# ephemerides given
RTCM_ROVER_DUR = 20.0
# tests/test_rtk_e2e.py:64-83's bounds on the last fixed epoch: the fixed
# baseline within RTK_FIXED_TOL_M, its float within RTK_FLOAT_TOL_M.  The
# float is code-driven and wanders with the DLL's sub-sample bias at 2 Msps
# (ROADMAP.md queue 3).  On 19(a)'s capture, the card's own (K6's Philox
# noise, reproduced on the CPU by python -m tests.test_torch_rtk), the JAX
# receiver's float at the last fixed epoch is RTK_FLOAT_JAX_M, over
# RTK_FLOAT_TOL_M: there (a) holds its float at the last fixed epoch to
# RTK_FLOAT_MARGIN times the JAX receiver's reading, printed beside
# RTK_FLOAT_TOL_M.  (b), the JAX test's own run (a 20 s rover with
# ephemerides given), holds both bounds at its last fixed epoch.  Both
# print the float over the fixed epochs of the last RTK_FLOAT_WINDOW_S.
# The margin: over those epochs of (a) the port's float on the CPU runs
# 0.096 m under to 0.070 m over the JAX receiver's (0.044 m under at the
# last), on this capture
RTK_FIXED_TOL_M = 0.05
RTK_FLOAT_TOL_M = 0.8
RTK_FLOAT_JAX_M = 0.9157
RTK_FLOAT_MARGIN = 1.1
RTK_FLOAT_WINDOW_S = 16.0
# 19(c), (d): tests/test_ppp.py:79-95's scenario, 16 s at 50 dB-Hz, the
# sky's ephemerides given
PPP_DUR = 16.0
PPP_CN0 = 50.0
PPP_TOL_M = 10.0
# 19(d): the JAX receiver's orbital EKF on the card's capture of (c)'s
# scenario on the CPU (python -m tests.test_torch_rtk): the mean and the
# largest 3D error over its solutions, EKF_JAX_MEAN_M and EKF_JAX_MAX_M
# (the first), each held to EKF_MARGIN times; after its first EKF_SETTLE_S
# its mean error EKF_JAX_LATE_M, EKF_JAX_BEATS_LS times the LS fixes' on
# the same epochs: the port's EKF held to EKF_MARGIN times the former and
# to EKF_BEATS_LS times its own LS fixes' error (an EKF that echoed the
# fixes would read 1).  The port's on the CPU on this capture: 2.4805,
# 6.5006, 2.0589 m and 0.7603 (its pseudoranges are not JAX's,
# ROADMAP.md queue 3)
EKF_JAX_MEAN_M = 2.6567
EKF_JAX_MAX_M = 7.5883
EKF_JAX_LATE_M = 2.1839
EKF_JAX_BEATS_LS = 0.7834
EKF_MARGIN = 1.25
EKF_SETTLE_S = 2.0
EKF_BEATS_LS = 0.9
RTK_KERNELS = ("K6_device_generator", "K3_pcps_wipe", "K3_pcps_peak",
               "K8a_block_prologue", "K1_K8b_K8a_block_step",
               "K9_epoch_chunk")
# the rover's and the PPP runs' conf: phase 4's search and tracking at
# 2 Msps, read from a 2 Msps ishort file with no conditioning
PVT_MODE_CONF = """\
GNSS-SDR.internal_fs_sps=2000000
SignalSource.implementation=File_Signal_Source
SignalSource.filename={capture}
SignalSource.item_type=ishort
SignalSource.sampling_frequency=2000000
Channels_1C.count=8
Channels.in_acquisition=8
Acquisition_1C.implementation=GPS_L1_CA_PCPS_Acquisition
Acquisition_1C.pfa=0.01
Acquisition_1C.max_dwells=2
Acquisition_1C.make_two_steps=true
Acquisition_1C.second_nbins=4
Acquisition_1C.second_doppler_step=125
Tracking_1C.implementation=GPS_L1_CA_DLL_PLL_Tracking
PVT.output_rate_ms=20
"""


def rover_true_ecef():
    """tests/fixtures.py's rover: ROVER_ENU from the base (RX_LLH)."""
    base = np.asarray(rx_true_ecef())
    up = base / np.linalg.norm(base)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    e, n, u = ROVER_ENU
    return base + e * east + n * north + u * up


def sky_capture(wrappers, rx_ecef, dur: float, cn0: float, seed: int):
    """K6's capture of phase 4's sky (LNAV subframes 1, 2, 3 from T0) seen
    at `rx_ecef`, `dur` seconds at 2 Msps on the card, and the sky's
    ephemerides; K6's launches read apart."""
    import torch
    from gnss_sim_receiver_tpu_torch.nav.ephemeris import \
        make_sky_constellation
    from gnss_sim_receiver_tpu_torch.sim.device_generator import \
        generate_baseband_device_resident
    from gnss_sim_receiver_tpu_torch.sim.scenario import \
        build_static_scenario
    ephs = [e for e in make_sky_constellation(RX_LLH[0], RX_LLH[1],
                                              toe=T0 + 600)
            if e.prn in SCENARIO_PRNS]
    sats = build_static_scenario(ephs, rx_ecef, T0, dur, cn0_db_hz=cn0,
                                 subframe_cycle=(1, 2, 3))
    reset(wrappers)
    x = generate_baseband_device_resident(sats, FS, int(FS * dur),
                                          noise=True, seed=seed,
                                          device="cuda")
    torch.cuda.synchronize()
    k6 = read_launches(wrappers, ("K6_device_generator",))[
        "K6_device_generator"]
    return x, {e.prn: e for e in ephs}, k6


def add_launches(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def rtk_check(run, truth, what: str, float_bound: float) -> None:
    """tests/test_rtk_e2e.py's checks on a run's RTK solutions, printed:
    RTK epochs formed, one fixed, the last fixed baseline within
    RTK_FIXED_TOL_M of the truth and its float within `float_bound`; the
    float over the fixed epochs of the last RTK_FLOAT_WINDOW_S printed."""
    if not run.rtk_solutions:
        fail(f"{what}: no RTK epochs formed")
    fixed = [(t, s) for t, s in run.rtk_solutions if s.fixed]
    last = run.rtk_solutions[-1][1]
    if not fixed:
        fail(f"{what}: never fixed; last ratio {last.ratio:.3f}, float "
             f"error {np.linalg.norm(last.float_baseline_m - truth):.4f} m")
    t_end, last_fixed = fixed[-1]
    e_fix = float(np.linalg.norm(last_fixed.baseline_m - truth))
    e_float = float(np.linalg.norm(last_fixed.float_baseline_m - truth))
    window = np.array([np.linalg.norm(s.float_baseline_m - truth)
                       for t, s in fixed if t > t_end - RTK_FLOAT_WINDOW_S])
    print(f"  {what}: {len(run.rtk_solutions)} RTK epochs, {len(fixed)} "
          f"fixed (the first at rx time {fixed[0][0]:.2f} s); last ratio "
          f"{last.ratio:.3f}; the last fixed baseline {e_fix:.4f} m from "
          f"the truth, its float {e_float:.4f} m (bounds {RTK_FIXED_TOL_M} "
          f"m and {float_bound:.4f} m; within {RTK_FLOAT_TOL_M} m: "
          f"{e_float < RTK_FLOAT_TOL_M}); the float over the {window.size} "
          f"fixed epochs of the last {RTK_FLOAT_WINDOW_S:g} s: median "
          f"{np.median(window):.4f} m, {window.min():.4f} to "
          f"{window.max():.4f} m")
    if e_fix >= RTK_FIXED_TOL_M or e_float >= float_bound:
        fail(f"{what}: fixed {e_fix:.4f} m, float {e_float:.4f} m")


def rtk_path(root: str, wrappers, card: str) -> dict:
    """Phase 19(a) and (b): RTK, the base stream by RINEX file and by RTCM.
    (a) K6 makes the base's RTK_BASE_DUR seconds and the rover's
    RTK_ROVER_DUR (their own noise seeds, launches counted apart); the
    base runs through process_array (Single, PVT_MODE_CONF, it decodes its
    ephemerides) and its observables go through write_rinex_obs into a
    file under build/; the rover, written as a 2 Msps ishort file, runs
    through the CLI with PVT.positioning_mode=RTK_Static,
    PVT.AR_ratio_threshold=2.5, PVT.rtk_base_rinex_obs and
    PVT.rtk_base_position_ecef.  (b) RtcmBaseEncoder(base, station_id=7,
    msm=7) encodes the base run with its ephemerides; serve_frames and
    read_frames carry it over 127.0.0.1; the decoder's base stream and
    ephemerides feed the rover's first RTCM_ROVER_DUR seconds through
    process_array.  The counters set to 0 just before each receiver run
    and read just after.  Checks: tests/test_rtk_e2e.py's (RTK epochs
    formed, one fixed, the last fixed baseline within RTK_FIXED_TOL_M, its
    float within RTK_FLOAT_MARGIN times the JAX receiver's on the same
    capture in (a), within RTK_FLOAT_TOL_M in (b);
    over RTCM the bytes received equal the bytes sent, the base position
    within 1 mm, the ephemeris keys equal); the real-time factors.
    Temporary files removed."""
    import torch
    from gnss_sim_receiver_tpu_torch.models import outputs, rtcm
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    from gnss_sim_receiver_tpu_torch.utils.sample_io import write_samples
    launches = {}
    base_true, rover_true = rx_true_ecef(), rover_true_ecef()
    truth = np.asarray(rover_true) - np.asarray(base_true)
    base_str = ",".join(f"{v:.4f}" for v in base_true)
    build = os.path.join(root, "build")
    os.makedirs(build, exist_ok=True)
    obs_path = os.path.join(build, "phase19_base.obs")
    cap = os.path.join(build, "phase19_rover_40s_2msps.ishort")
    conf_path = os.path.join(build, "chip_smoke_rtk19.conf")
    rtk_text = (PVT_MODE_CONF.format(capture=cap)
                + "PVT.positioning_mode=RTK_Static\n"
                  "PVT.AR_ratio_threshold=2.5\n"
                  f"PVT.rtk_base_rinex_obs={obs_path}\n"
                  f"PVT.rtk_base_position_ecef={base_str}\n")
    try:
        x_base, _, k6 = sky_capture(wrappers, base_true, RTK_BASE_DUR,
                                    RTK_CN0, 191)
        x_rover, _, k6_r = sky_capture(wrappers, rover_true, RTK_ROVER_DUR,
                                       RTK_CN0, 192)
        launches["K6_device_generator"] = k6 + k6_r
        write_samples(cap, x_rover, "ishort", scale=200.0)
        conf = receiver_conf_from_config(InMemoryConfiguration(
            conf_properties(PVT_MODE_CONF)))
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base_run = Receiver(conf).process_array(x_base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_launches(launches, read_launches(wrappers, RTK_KERNELS[1:]))
        del x_base
        print(f"  (a) base: {len(base_run.observation_epochs)} observable "
              f"epochs, {len(base_run.solutions)} fixes, ephemerides "
              f"{sorted(base_run.ephemerides)}; {RTK_BASE_DUR / wall:.3f} x "
              f"real time ({wall:.3f} s of receiver; {card})")
        if sorted(base_run.ephemerides) != list(SCENARIO_PRNS):
            fail(f"the base decoded {sorted(base_run.ephemerides)}")
        week = next(iter(base_run.ephemerides.values())).week
        outputs.write_rinex_obs(obs_path, base_run.observation_epochs,
                                base_run.channel_prns, week)
        with open(conf_path, "w") as fh:
            fh.write(rtk_text)
        from gnss_sim_receiver_tpu_torch.__main__ import run_cli
        reset(wrappers)
        torch.cuda.synchronize()
        res = run_cli([f"--config_file={conf_path}"])
        torch.cuda.synchronize()
        add_launches(launches, read_launches(wrappers, RTK_KERNELS[1:]))
        if res.exit_code != 0:
            fail(f"the RTK rover's CLI returned {res.exit_code}")
        sec = res.seconds
        wall = sum(sec.values())
        print(f"  (a) rover through the CLI: read {sec['read']:.3f} s, "
              f"upload and conditioning {sec['condition']:.3f}, receiver "
              f"{sec['receiver']:.3f}; {RTK_ROVER_DUR / wall:.3f} x real "
              f"time from file open to the last epoch ({card}); "
              f"ephemerides {sorted(res.run.ephemerides)}")
        print(f"  (a) the JAX receiver's float at the last fixed epoch on "
              f"this capture on the CPU: {RTK_FLOAT_JAX_M} m; bound "
              f"x{RTK_FLOAT_MARGIN:g}")
        rtk_check(res.run, truth, "(a) RINEX base",
                  RTK_FLOAT_MARGIN * RTK_FLOAT_JAX_M)

        enc = rtcm.RtcmBaseEncoder(base_true, station_id=7, msm=7)
        stream = enc.encode_run(base_run, ephemerides=base_run.ephemerides)
        port, srv = rtcm.serve_frames(stream)
        try:
            received = rtcm.read_frames("127.0.0.1", port)
        finally:
            srv.close()
        dec = rtcm.RtcmBaseDecoder()
        dec.feed(received)
        base_obs = dec.base_observations()
        d_base = float(np.abs(base_obs.base_ecef_m - base_true).max())
        print(f"  (b) RTCM: {len(stream)} bytes sent, {len(received)} "
              f"received, {len(base_obs.epochs)} base epochs decoded, the "
              f"station {d_base * 1e3:.3f} mm from the base, ephemerides "
              f"{sorted(dec.ephemerides)}")
        if received != stream or d_base >= 1e-3 or \
                set(dec.ephemerides) != set(base_run.ephemerides):
            fail("(b) the RTCM stream did not round-trip")
        rconf = receiver_conf_from_config(InMemoryConfiguration(
            conf_properties(rtk_text)))
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = Receiver(rconf).process_array(
            x_rover[:int(FS * RTCM_ROVER_DUR)],
            ephemerides=dict(dec.ephemerides), base_observations=base_obs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_launches(launches, read_launches(wrappers, RTK_KERNELS[1:]))
        print(f"  (b) rover {RTCM_ROVER_DUR:g} s through process_array: "
              f"{RTCM_ROVER_DUR / wall:.3f} x real time ({wall:.3f} s of "
              f"receiver; {card})")
        rtk_check(run, truth, "(b) RTCM base", RTK_FLOAT_TOL_M)
        del x_rover
        torch.cuda.empty_cache()
    finally:
        for path in (obs_path, cap, conf_path):
            if os.path.exists(path):
                os.remove(path)
    return launches


def ekf_stats(run, truth) -> dict:
    """A run's orbital-EKF 3D errors from `truth`: over all its solutions,
    and over those after its first EKF_SETTLE_S beside the LS fixes of the
    same epochs (an LS fix's epoch is its corrected time plus its clock
    bias) and the EKF's mean distance from them."""
    ekf = run.ekf_solutions
    t = np.array([s[0] for s in ekf])
    pos = np.array([s[1] for s in ekf])
    err = np.linalg.norm(pos - truth, axis=1)
    ls = {int(round((s.rx_time_corrected_s + s.rx_clock_bias_s) * 1e3)): s
          for s in run.solutions}
    late = [k for k in range(t.size) if t[k] > t[0] + EKF_SETTLE_S
            and int(round(t[k] * 1e3)) in ls]
    ls_pos = np.array([ls[int(round(t[k] * 1e3))].rx_ecef_m for k in late])
    return {"n": int(t.size), "mean": float(err.mean()),
            "largest": float(err.max()), "last": float(err[-1]),
            "n_late": len(late), "late_mean": float(err[late].mean()),
            "late_ls_mean": float(np.linalg.norm(ls_pos - truth,
                                                 axis=1).mean()),
            "late_from_ls": float(np.linalg.norm(pos[late] - ls_pos,
                                                 axis=1).mean())}


def ppp_ekf_path(wrappers, card: str) -> dict:
    """Phase 19(c) and (d): PPP and the orbital EKF on one capture.  K6
    makes PPP_DUR seconds of the sky at PPP_CN0 at the base position
    (launches counted apart); the factory's PVT_MODE_CONF with (c)
    PVT.positioning_mode=PPP_Static, (d) Single and enable_pvt_ekf, each
    through process_array with the sky's ephemerides, the counters set to
    0 just before and read just after.  Checks: (c) PPP solutions, the
    last within PPP_TOL_M (tests/test_ppp.py:79-95); (d) EKF solutions,
    finite, their mean and largest 3D error within EKF_MARGIN times the
    JAX receiver's on the same capture, and after EKF_SETTLE_S their mean
    within EKF_MARGIN times the JAX receiver's and under EKF_BEATS_LS
    times the LS fixes' on the same epochs; the real-time factors."""
    import dataclasses
    import torch
    from gnss_sim_receiver_tpu_torch.models.factory import \
        receiver_conf_from_config
    from gnss_sim_receiver_tpu_torch.models.receiver import Receiver
    from gnss_sim_receiver_tpu_torch.utils.config import \
        InMemoryConfiguration
    truth = np.asarray(rx_true_ecef())
    x, ephs, k6 = sky_capture(wrappers, truth, PPP_DUR, PPP_CN0, 193)
    launches = {"K6_device_generator": k6}
    runs = {}
    for name, keys, ekf in (("(c) PPP_Static",
                             {"PVT.positioning_mode": "PPP_Static"}, False),
                            ("(d) the orbital EKF", {}, True)):
        conf = receiver_conf_from_config(InMemoryConfiguration(
            {**conf_properties(PVT_MODE_CONF), **keys}))
        conf = dataclasses.replace(conf, enable_pvt_ekf=ekf)
        reset(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = Receiver(conf).process_array(x, ephemerides=dict(ephs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_launches(launches, read_launches(wrappers, RTK_KERNELS[1:]))
        runs[name] = run
        print(f"  {name}: {len(run.solutions)} LS fixes, "
              f"{len(run.ppp_solutions)} PPP and {len(run.ekf_solutions)} "
              f"EKF solutions; {PPP_DUR / wall:.3f} x real time ({wall:.3f} "
              f"s of receiver; {card})")
    ppp = runs["(c) PPP_Static"].ppp_solutions
    if not ppp:
        fail("(c) PPP produced no solutions")
    e_ppp = float(np.linalg.norm(ppp[-1][1].rx_ecef_m - truth))
    e_ls = float(np.linalg.norm(runs["(c) PPP_Static"].solutions[-1]
                                .rx_ecef_m - truth))
    print(f"  (c) the last PPP solution {e_ppp:.4f} m from the truth (bound "
          f"{PPP_TOL_M:g} m; the last LS fix {e_ls:.4f} m)")
    if not e_ppp < PPP_TOL_M:
        fail(f"(c) PPP {e_ppp:.4f} m")
    run = runs["(d) the orbital EKF"]
    if not run.ekf_solutions:
        fail("(d) the EKF produced no solutions")
    if not all(np.isfinite(np.concatenate([np.ravel(v) for v in s[1:]])).all()
               for s in run.ekf_solutions):
        fail("(d) an EKF state is not finite")
    st = ekf_stats(run, truth)
    beats = st["late_mean"] / st["late_ls_mean"]
    print(f"  (d) EKF 3D error over its {st['n']} solutions: mean "
          f"{st['mean']:.4f} m, largest {st['largest']:.4f} m, last "
          f"{st['last']:.4f} m; after {EKF_SETTLE_S:g} s, over "
          f"{st['n_late']}: mean {st['late_mean']:.4f} m against the LS "
          f"fixes' {st['late_ls_mean']:.4f} m on the same epochs ({beats:.4f}"
          f" of it), {st['late_from_ls']:.4f} m from them on average (the "
          f"JAX receiver's on this capture on the CPU: {EKF_JAX_MEAN_M}, "
          f"{EKF_JAX_MAX_M}, after {EKF_SETTLE_S:g} s {EKF_JAX_LATE_M} m, "
          f"{EKF_JAX_BEATS_LS} of LS; bounds x{EKF_MARGIN:g}, and "
          f"{EKF_BEATS_LS} of LS)")
    if (st["mean"] > EKF_MARGIN * EKF_JAX_MEAN_M
            or st["largest"] > EKF_MARGIN * EKF_JAX_MAX_M
            or st["late_mean"] > EKF_MARGIN * EKF_JAX_LATE_M
            or beats > EKF_BEATS_LS):
        fail(f"(d) EKF error mean {st['mean']:.4f} m, largest "
             f"{st['largest']:.4f} m, after {EKF_SETTLE_S:g} s "
             f"{st['late_mean']:.4f} m, {beats:.4f} of LS")
    del x
    torch.cuda.empty_cache()
    return launches


def profile_path(run) -> None:
    """`--profile`: `run()` (one run of a path, returning a line to print)
    twice more, plain and under torch.profiler: wall time, device busy
    share (kernel time over wall), device time by kernel and host time by
    operator."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    print(f"  unprofiled second run: {run()}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device events only (kernels and copies): an operator's entry carries
    # its kernels' device time as well and would count it twice
    from torch.autograd import DeviceType
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    n_ops = sum(e.count for e in avgs if e.key.startswith("aten::"))
    launch_calls = {e.key: e.count for e in avgs
                    if e.key.startswith(("cudaLaunch", "cuLaunch"))}
    print(f"  profiled run: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f} %) in {sum(e.count for e in kernels)} "
          f"kernels and copies, {n_ops} aten operator calls; launch calls "
          f"{launch_calls}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"    {dev_us(e) / 1e3:10.1f} ms  {e.count:8d}x  {e.key[:90]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:10]:
        print(f"    host {e.self_cpu_time_total / 1e3:10.1f} ms  "
              f"{e.count:8d}x  {e.key[:80]}")


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if sys.argv[1:2] == ["--synthesize"]:
        make_capture(root, sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    print("== phase 1: card", flush=True)
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernels_only = "--kernels-only" in sys.argv[1:]
    procs = {} if kernels_only else start_synthesis(root)
    try:
        return run_phases(root, card, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(root: str, card: str, procs: dict) -> int:
    """Phases 2 to 19 and the result lines; `procs` are the synthesis
    children (none with --kernels-only)."""
    import torch
    from gnss_sim_receiver_tpu_torch import signals
    from gnss_sim_receiver_tpu_torch.models import tracking as trk
    from gnss_sim_receiver_tpu_torch.ops import cuda_build, pcps, prn_codes
    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    # the block library a second time with --fmad=false (phase 3 holds its
    # K8a and K8b to the default build's bits), beside the others
    variant = {}

    def build_variant():
        try:
            variant["secs"] = cuda_build.build_all(
                ("block_kernels",), FMAD_FALSE, fmad_false_dir())
        except RuntimeError as err:
            variant["error"] = err
    variant_build = threading.Thread(target=build_variant)
    variant_build.start()
    secs = cuda_build.build_all()
    variant_build.join()
    if "error" in variant:
        raise variant["error"]
    for (name, s), extra, where in (
            *((kv, (), None) for kv in secs.items()),
            (("block_kernels", variant["secs"]["block_kernels"]),
             FMAD_FALSE, fmad_false_dir())):
        log = cuda_build.library_path(name, extra, where).with_suffix(
            ".log").read_text(errors="replace") if s else ""
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}{' ' + ' '.join(extra) if extra else ''}: nvcc "
              f"{s:.1f} s; {'; '.join(regs)}")
    print(f"  CUDA libraries built in {time.perf_counter() - t0:.1f} s "
          "(parallel)", flush=True)

    print("== phase 3: kernels against their plain versions", flush=True)
    rng = np.random.default_rng(1234)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gps = trk.TrackingConf(fs=FS)
    gps_taps = (0.25, 0.0, -0.25)
    gps20 = trk.TrackingConf(fs=FS_REF_HYBRID)
    e1 = hybrid_chain(FS_REF_HYBRID).trk
    e1_taps = conf_taps(e1)
    # the block step first (the newest kernels), at the shapes its paths
    # launch: phase 4 (C=8) and 6 (C=12) at 2 Msps, phase 5's E1 and GPS
    # chains at 20 Msps (phase 7's L5 and E5a chains share the GPS one's
    # E, K and F)
    # the per-epoch closure first (the newest kernel), at phase 8's two
    # chains' shapes, then phase 8b's (GPS at 2 Msps) and the chunk tails'
    rng9 = np.random.default_rng(9)
    gps20_ext = trk.TrackingConf(fs=FS_REF_HYBRID,
                                 extend_correlation_symbols=20)
    e1p = pilot_receiver_conf().chains[0].trk
    rows = [check_k9(dev, rng9, gps20_ext, 10, "K9_epoch_closure",
                     "GPS L1 C/A at 20 Msps"),
            check_k9(dev, rng9, e1p, 10, "K9_epoch_closure_E1",
                     "Galileo E1 pilot at 20 Msps"),
            check_k2(dev, rng9, e1p, 10, conf_taps(e1p),
                     signals.CodeProvider("1B", "C"),
                     "K2_multicorrelate_E1_data",
                     "Galileo E1 pilot at 20 Msps",
                     data_provider=signals.CodeProvider("1B"))]
    extra = [check_k9(dev, rng9, trk.TrackingConf(fs=FS, **kw), 8,
                      "K9_epoch_closure", f"GPS L1 C/A at 2 Msps, {lab}")
             for kw, lab in (({}, "k_ext 1"),
                             ({"extend_correlation_symbols": 20},
                              "k_ext 20"))]
    # the chunk kernel against the two-launch chunk at phase 8's two chains'
    # shapes (1 s chunks: 1000 GPS epochs, 250 E1 epochs), phase 8b's and
    # the 2 Msps chunk tails'
    rows += [check_epoch_chunk_bits(dev, rng9, gps20_ext, 10,
                                    "K9_epoch_chunk",
                                    "GPS L1 C/A at 20 Msps", 1000),
             check_epoch_chunk_bits(dev, rng9, e1p, 10, "K9_epoch_chunk_E1",
                                    "Galileo E1 pilot at 20 Msps", 250,
                                    chain=pilot_receiver_conf().chains[0])]
    extra += [check_epoch_chunk_bits(
        dev, rng9, trk.TrackingConf(fs=FS, **kw), 8, "K9_epoch_chunk",
        f"GPS L1 C/A at 2 Msps, {lab}", n)
        for kw, lab, n in (({}, "k_ext 1", 30),
                           ({"extend_correlation_symbols": 20}, "k_ext 20",
                            1000))]
    extra.append(check_epoch_chunk_waves(dev, rng9))
    check_epoch_chunk_cluster_sizes(dev, np.random.default_rng(11))
    # the closure's Kalman and second-order PLL forms at GPS 2 Msps (phase
    # 13's shape), each alone, then in the chunk kernel (the second-order
    # closure also at k_ext 20, its narrow form)
    rng13 = np.random.default_rng(13)
    for kw, suffix, lab in KALMAN_FORMS:
        conf_ = trk.TrackingConf(fs=FS, **kw)
        extra.append(check_k9(dev, rng13, conf_, 8,
                              "K9_epoch_closure" + suffix,
                              f"GPS L1 C/A at 2 Msps, {lab}"))
        rows.append(check_epoch_chunk_bits(
            dev, rng13, conf_, 8, "K9_epoch_chunk" + suffix,
            f"GPS L1 C/A at 2 Msps, {lab}", 1000))
    extra.append(check_k9(
        dev, rng13, trk.TrackingConf(fs=FS, pll_filter_order=2,
                                     extend_correlation_symbols=20), 8,
        "K9_epoch_closure_pll2", "GPS L1 C/A at 2 Msps, second-order PLL, "
        "k_ext 20"))
    torch.cuda.empty_cache()
    check_epoch_chunk(dev)
    torch.cuda.empty_cache()
    rng8 = np.random.default_rng(8)
    k8 = ("K8a_block_prologue", "K8b_block_closure",
          "K1_K8b_block_correlate_close", "K1_K8b_K8a_block_step")
    k8_e1 = tuple(n + "_E1" for n in k8)
    gps_code = prn_codes.gps_l1_ca_code
    rows += [*check_k8(dev, rng8, gps, 8, gps_taps, gps_code, 1000, k8,
                       "GPS L1 C/A at 2 Msps"),
             *check_k8(dev, rng8, e1, 10, e1_taps,
                       signals.CodeProvider("1B"), 250, k8_e1,
                       "Galileo E1-B at 20 Msps")]
    extra += [*check_k8(dev, rng8, gps, 12, gps_taps, gps_code, 1000, k8,
                        "GPS L1 C/A at 2 Msps, 12 channels"),
              *check_k8(dev, rng8, gps20, 10, gps_taps, gps_code, 250, k8,
                        "GPS L1 C/A at 20 Msps")]
    torch.cuda.empty_cache()
    # the pilot form (a track_pilot chain at extend 1: both replica
    # families, the data prompt, the block's CS25 sync) at phase 8c's E1
    # shape and at 4 Msps, with a planted CS25 sync; the GPS block step at
    # phase 10's 3 Msps
    e1_pilot = pilot_receiver_conf(gps_extend=1, e1_extend=1).chains[0].trk
    e1_code = signals.CodeProvider("1B", "C")
    e1_data = signals.CodeProvider("1B")
    k8_p = tuple(n + "_E1_pilot" for n in k8)
    pil = check_k8(dev, rng8, e1_pilot, 10, conf_taps(e1_pilot), e1_code,
                   250, k8_p, "Galileo E1 pilot at 20 Msps",
                   data_provider=e1_data)
    rows += [pil[0], pil[3]]
    extra += [pil[1], pil[2]]
    e1_pilot4 = pilot_receiver_conf(FS_FILE, 1, 1).chains[0].trk
    extra += check_k8(dev, rng8, e1_pilot4, 10, conf_taps(e1_pilot4),
                      e1_code, 250, k8_p, "Galileo E1 pilot at 4 Msps",
                      data_provider=e1_data)
    extra.append(check_pilot_sync(dev, e1_pilot,
                                  "Galileo E1 pilot at 20 Msps"))
    gps3 = trk.TrackingConf(fs=FS_PS)
    g3 = check_k8(dev, rng8, gps3, 9, gps_taps, gps_code, 1000,
                  tuple(n + "_3Msps" for n in k8), "GPS L1 C/A at 3 Msps")
    rows.append(g3[3])
    extra += g3[:3]
    torch.cuda.empty_cache()
    # phase 11's L1 chain: GPS at 8 Msps, 8 channels
    gps8 = multiband_conf().chains[0].trk
    g8 = check_k8(dev, rng8, gps8, MB_CHANNELS, gps_taps, gps_code, 1000,
                  tuple(n + "_8Msps" for n in k8),
                  f"GPS L1 C/A at {FS_MB_L1 / 1e6:g} Msps")
    rows += [g8[0], g8[3]]
    extra += g8[1:3]
    torch.cuda.empty_cache()
    # the two-launch chunk at the same four shapes
    for conf_, c_, taps_, prov, lab in (
            (gps, 8, gps_taps, gps_code, "GPS L1 C/A at 2 Msps"),
            (gps, 12, gps_taps, gps_code,
             "GPS L1 C/A at 2 Msps, 12 channels"),
            (gps20, 10, gps_taps, gps_code, "GPS L1 C/A at 20 Msps"),
            (e1, 10, e1_taps, signals.CodeProvider("1B"),
             "Galileo E1-B at 20 Msps")):
        extra.append(check_block_chunk_bits(dev, rng8, conf_, c_, taps_,
                                            prov, lab))
        torch.cuda.empty_cache()
    # and the pilot form's and phase 10's
    for conf_, c_, taps_, prov, data, lab in (
            (e1_pilot, 10, conf_taps(e1_pilot), e1_code, e1_data,
             "Galileo E1 pilot at 20 Msps"),
            (e1_pilot4, 10, conf_taps(e1_pilot4), e1_code, e1_data,
             "Galileo E1 pilot at 4 Msps"),
            (gps3, 9, gps_taps, gps_code, None, "GPS L1 C/A at 3 Msps"),
            (gps8, MB_CHANNELS, gps_taps, gps_code, None,
             f"GPS L1 C/A at {FS_MB_L1 / 1e6:g} Msps")):
        extra.append(check_block_chunk_bits(dev, rng8, conf_, c_, taps_,
                                            prov, lab, data))
        torch.cuda.empty_cache()
    k5b_row, notch_case = check_k5b(dev, rng)
    rows += [check_k1(dev, rng, gps, 8, 20, gps_taps, 1000,
                     "K1_block_correlate", "GPS L1 C/A at 2 Msps"),
            check_k2(dev, rng, gps, 8, gps_taps, prn_codes.gps_l1_ca_code,
                     "K2_multicorrelate", "GPS L1 C/A at 2 Msps")]
    # phase 5's GPS chain: 10 channels at 20 Msps
    label = f"GPS L1 C/A at {FS_REF_HYBRID / 1e6:g} Msps"
    extra += [check_k1(dev, rng, gps20, 10, 20, gps_taps, 250,
                       "K1_block_correlate", label),
              check_k2(dev, rng, gps20, 10, gps_taps,
                       prn_codes.gps_l1_ca_code, "K2_multicorrelate", label)]
    torch.cuda.empty_cache()
    for fs in (FS_REF_HYBRID, FS_FILE):
        e1 = hybrid_chain(fs).trk
        e1_taps = conf_taps(e1)
        label = f"Galileo E1-B at {fs / 1e6:g} Msps"
        k1 = check_k1(dev, rng, e1, 10, 5, e1_taps, 250,
                      "K1_block_correlate_E1", label)
        k2 = check_k2(dev, rng, e1, 10, e1_taps, signals.CodeProvider("1B"),
                      "K2_multicorrelate_E1", label)
        if fs == FS_REF_HYBRID:
            rows += [k1, k2]
        else:
            extra += [k1, k2]
        torch.cuda.empty_cache()
    rows += [*check_k3(dev), check_k3b(dev)]
    assisted_rows, pool = check_assisted(dev)
    rows += assisted_rows
    extra.append(pool)
    check_k3c_shapes(dev, extra)
    k3c = []
    for variant in ("cccwsr", "8ms"):
        for fs in (FS_REF_HYBRID, FS_FILE):
            row = check_k4a(dev, fs, variant, extra, k3c)
            if row is not None:
                rows.append(row)
    rows += check_k4b(dev, extra)
    rows.append(check_k4c(dev, extra, k3c))
    rows += k3c
    check_wideband_shapes(dev, rng, extra)
    check_k3_search_shapes(dev, extra)
    check_wipe_path_shapes(dev, extra)
    check_l2c_e5b_shapes(dev, card, rows, extra)
    check_beidou_shapes(dev, card, rows, extra)
    check_e6_glonass_shapes(dev, card, rows, extra)
    check_sbas_shapes(dev, card, rows, extra)
    rows += [check_k5a(dev, rng), k5b_row, check_k5c(dev, rng),
             *check_k5d(dev, rng)]
    torch.cuda.empty_cache()
    rows.append(check_k6(dev, FS_REF_HYBRID, hybrid_sats(), DUR, 17,
                         f"hybrid at {FS_REF_HYBRID / 1e6:g} Msps"))
    extra.append(check_k6(dev, FS, full_chain_sats(), FULL_DUR, 3,
                          f"full chain at {FS / 1e6:g} Msps"))
    extra.append(check_k6(dev, FS_WIDEBAND, wideband_sats(), WB_DUR, 17,
                          f"wideband at {FS_WIDEBAND / 1e6:g} Msps"))
    torch.cuda.empty_cache()
    rng7 = np.random.default_rng(7)
    rows.append(check_k3_rows(dev))
    rows.append(check_k7(dev, rng7, extra))
    rows += check_k10(dev, rng7, extra)
    torch.cuda.empty_cache()
    print(f"  phase 3 took {time.perf_counter() - t0:.1f} s (includes the "
          "Triton compiles)", flush=True)
    print(json.dumps({"other_shapes": extra}))
    if not procs:
        print(json.dumps({"kernels": rows}))
        return 0

    wrappers = launch_wrappers()
    print("== phase 4: main path (conf file -> capture file -> conditioner "
          "-> receiver -> position)", flush=True)
    for which in procs:           # no child may run beside a timed window
        wait_for(procs, which)
    print("== phase 3, continued: a 50-block chunk of phase 4's path on its "
          "capture, kernel path against the plain block body", flush=True)
    check_block_chunk(root)
    torch.cuda.empty_cache()
    pcps.pcps_wipe.shapes.clear()
    launches = main_path(root, wrappers)
    print("== phase 4b: the conditioner alone", flush=True)
    cond = conditioner_path(root, wrappers, notch_case)
    for name in COND_KERNELS[1:]:
        launches[name] = cond[name]
    print("== phase 4c: the array entry point (process_array, "
          f"{DIRECT_DUR:.0f} s at 2 Msps)", flush=True)
    direct_path(root, wrappers)
    print("== phase 4d: QuickSync acquisition through the CLI; Tong and "
          "Fine Doppler on the card", flush=True)
    quick = quicksync_path(root, wrappers)
    for name in QUICKSYNC_KERNELS[:2]:
        launches[name] = quick[name]
    tong_fine_doppler(root, wrappers)
    print("== phase 4e: the first-vs-second-peak statistic and a fixed "
          "threshold through the CLI; Tong and Fine Doppler under it and "
          "with bit_transition_flag", flush=True)
    ratio = ratio_path(root, wrappers)
    launches["K3c_pcps_second_peak"] = ratio["K3c_pcps_second_peak"]
    tong_fine_doppler(root, wrappers, TAIL_CASES)
    print("== phase 4f: the ROC harness (trials as K3's channels)",
          flush=True)
    roc_path(wrappers)
    print("== phase 5: the hybrid path at 20 Msps (device generator -> "
          "ibyte file -> GPS L1 C/A + Galileo E1-B conf -> receiver -> joint "
          "position)", flush=True)
    k6 = make_hybrid_capture(root, wrappers)["K6_device_generator"]
    hybrid = hybrid_path(root, wrappers, card)
    if "--profile" in sys.argv[1:]:
        from gnss_sim_receiver_tpu_torch.__main__ import run_cli
        argv = ["--config_file="
                + os.path.join(root, "build", "chip_smoke_hybrid.conf")]
        print("== profile of the hybrid path", flush=True)
        profile_path(lambda: f"seconds {run_cli(argv).seconds}")
    for name in ("K1_block_correlate", "K2_multicorrelate",
                 "K8b_block_closure", *BLOCK_STEP_KERNELS):
        launches[name + "_E1"] = hybrid[name]
    launches["K4a_pcps_dual_peak"] = hybrid["K4a_pcps_dual_peak"]
    print("== phase 5b: 8 ms acquisition on the hybrid capture", flush=True)
    hybrid_acquisition(root, wrappers)
    print("== phase 5c: CCCWSR and 8 ms acquisition under the "
          "first-vs-second-peak statistic on the hybrid capture",
          flush=True)
    launches["K3c_pcps_second_peak_dual"] = sum(
        hybrid_acquisition(root, wrappers, impl, ratio_props("1B"))[
            "K3c_pcps_second_peak_dual"] for impl in ("CCCWSR", "8ms"))
    print("== phase 6: the full chain (bench.py's 12-satellite, 120 s "
          "scenario made on the card -> process_array)", flush=True)
    full = full_chain(wrappers, card)
    if "--witness" in sys.argv[1:]:
        print("== witness: phase 5's position error by rate, chips, "
              "quantization and noise", flush=True)
        hybrid_witness()
    print("== phase 7: the wideband path at 20 Msps (device generator -> "
          "ibyte file -> GPS L5 + Galileo E5a conf -> receiver -> joint "
          "position)", flush=True)
    k6_wb = make_wideband_capture(root, wrappers)["K6_device_generator"]
    wide = wideband_path(root, wrappers, card)
    os.remove(capture_paths(root)["wideband"])
    launches["K4c_pcps_caf_peak"] = wide["K4c_pcps_caf_peak"]
    print("== phase 8: the hybrid pilot path at 20 Msps (device generator "
          "-> process_array's session -> GPS L1 C/A at 20 ms + Galileo E1-C "
          "pilot with the E1-B data prompt at 20 ms -> joint position)",
          flush=True)
    def phase_8c(x, run):
        print("== phase 8c: phase 8's capture with GPS and the E1 pilot "
              "chain at extend_correlation_symbols=1 (the block kernels, the "
              "E1 chain on their pilot form)", flush=True)
        return pilot_block_path(wrappers, card, x, run)
    pilot = pilot_path(wrappers, card, then=phase_8c)
    for name in PILOT_BLOCK_KERNELS:
        launches[name] = pilot["then"][name]
    for name in ("K9_epoch_closure", "K9_epoch_closure_E1",
                 "K2_multicorrelate_E1_data", "K9_epoch_chunk",
                 "K9_epoch_chunk_E1"):
        launches[name] = pilot[name]
    print("== phase 8b: phase 4's conf with "
          "Tracking_1C.extend_correlation_symbols=20 through the CLI",
          flush=True)
    pilot_conf_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print("== phase 9: the sharded steps on one rank over NCCL (per-epoch "
          "and block tracking of 192 channels, Doppler- and time-sharded "
          "acquisition)", flush=True)
    launches.update(sharded_path(wrappers))
    torch.cuda.empty_cache()
    print("== phase 9b: the sigma-point filters (4096 filters through K10a, "
          "torch.func.vmap and K10b)", flush=True)
    launches.update(filters_path(wrappers, dev))
    torch.cuda.empty_cache()
    print("== phase 10: the fork's hybrid operating point (GPS L1 C/A, 9 "
          "channels, one a pseudolite, 3 Msps: device generator -> ibyte "
          "file -> hybrid conf through the CLI -> position and AOWR clock "
          "differences)", flush=True)
    ps = ps_path(root, wrappers, card)
    launches["K1_K8b_K8a_block_step_3Msps"] = ps["K1_K8b_K8a_block_step"]
    torch.cuda.empty_cache()
    print("== phase 11: the multi-band front end (device generator -> GPS "
          f"L1 C/A at {FS_MB_L1 / 1e6:g} Msps on RF 0 with acquisition on "
          f"the x{MB_DEC} mean-pooled stream + GPS L5I at "
          f"{FS_MB_L5 / 1e6:g} Msps on RF 1, Doppler-assisted -> "
          "attach_arrays -> dual-band position)", flush=True)
    mb = multiband_path(wrappers, card)
    for name in ("K3b_pcps_wipe_per_channel_assisted",
                 "K3_pcps_peak_assisted", "K8a_block_prologue_8Msps",
                 "K1_K8b_K8a_block_step_8Msps"):
        launches[name] = mb[name]
    torch.cuda.empty_cache()
    print("== phase 12: the live session (phase 4's conditioned capture fed "
          f"in {LIVE_STEP_S:g} s host blocks against process_array; a "
          "warm-started session under the TCP telecommand server: status, "
          "standby, hotstart, coldstart)", flush=True)
    live_path(root, wrappers, card, main_path.rtf)
    torch.cuda.empty_cache()
    print("== phase 13: the Kalman trackers and the full planes (phase 4's "
          "capture: the KF through the CLI, the gaussian mode through "
          "process_array, collect_track_outputs with the .mat dumps, the "
          "second-order PLL)", flush=True)
    launches.update(kalman_path(root, wrappers, card))
    torch.cuda.empty_cache()
    print("== phase 14(a): GPS L2C CM alone through the CLI (device "
          f"generator -> {L2C_DUR:.0f} s ishort file at "
          f"{FS_FILE / 1e6:g} Msps -> conditioner -> 8 L2C channels, cold "
          "search -> CNAV -> position)", flush=True)
    l2c = l2c_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print("== phase 14(b): GPS L1 C/A + L2C on two RF streams at "
          f"{FS_L2C_MB / 1e6:g} Msps (attach_arrays, L2C assisted; "
          f"observables every {L2C_MB_INTERVAL_MS} ms: L2C on the block "
          "step at E = 2, then every 20 ms: on the chunk kernel)",
          flush=True)
    l2mb = l2c_multiband_path(wrappers, card)
    torch.cuda.empty_cache()
    print("== phase 14(c): GPS L1 C/A at "
          f"{FS_L2C_MB / 1e6:g} Msps + Galileo E5b-I at "
          f"{FS_E5B / 1e6:g} Msps on two RF streams (attach_arrays, E5b "
          "cold, I/NAV -> joint position)", flush=True)
    e5b = e5b_path(wrappers, card)
    torch.cuda.empty_cache()
    for name in ("K6_device_generator_L2C", "K3_pcps_wipe_L2C",
                 "K3_pcps_peak_L2C", "K3b_pcps_wipe_per_channel_L2C",
                 "K9_epoch_chunk_L2C"):
        launches[name] = l2c[name]
    for name in ("K3b_pcps_wipe_per_channel_assisted_L2C",
                 "K3_pcps_peak_assisted_L2C", "K8a_block_prologue_L2C",
                 "K1_K8b_K8a_block_step_L2C"):
        launches[name] = l2mb[name]
    for name in ("K6_device_generator_E5b", "K8a_block_prologue_E5b",
                 "K1_K8b_K8a_block_step_E5b"):
        launches[name] = e5b[name]
    t15 = time.perf_counter()
    print("== phase 15(a): BeiDou B1I alone through the CLI (device "
          f"generator -> {B1_DUR:g} s ishort file at "
          f"{FS_B1_FILE / 1e6:g} Msps -> conditioner -> 8 B1I channels, cold "
          "search -> D1 -> position)", flush=True)
    bds1 = b1_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 15(b): BeiDou B1I at {FS_B1 / 1e6:g} Msps on RF 0 + "
          f"B3I at {FS_B3 / 1e6:g} Msps on RF 1 (attach_arrays, B3I "
          "assisted, D1 on both -> dual-band position)", flush=True)
    bds13 = b13_path(wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 15(c): a GEO PRN's D2 on B1I at {FS_GEO / 1e6:g} Msps "
          "on the per-epoch path with the rectified lock test (acquisition "
          "-> TrackingEngine -> D2 pages -> ephemeris)", flush=True)
    geo = geo_path(wrappers, card)
    torch.cuda.empty_cache()
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)
    for name in ("K6_device_generator_BDS", "K3_pcps_wipe_B1I",
                 "K3_pcps_peak_B1I", "K3b_pcps_wipe_per_channel_B1I",
                 "K8a_block_prologue_B1I", "K1_K8b_K8a_block_step_B1I",
                 "K9_epoch_chunk_B1I"):
        launches[name] = bds1[name]
    for name in ("K3b_pcps_wipe_per_channel_assisted_B3I",
                 "K3_pcps_peak_assisted_B3I", "K8a_block_prologue_B3I",
                 "K1_K8b_K8a_block_step_B3I", "K9_epoch_chunk_B3I"):
        launches[name] = bds13[name]
    launches["K9_epoch_chunk_rectify"] = geo["K9_epoch_chunk_rectify"]
    t16 = time.perf_counter()
    print("== phase 16(a): Galileo E1-B + E6-B through the CLI (device "
          f"generator -> {E6_DUR:g} s ibyte file at {FS_E6 / 1e6:g} Msps -> "
          "5 + 5 channels, E6 assisted, C/NAV pages of a HAS message from "
          "five satellites -> Reed-Solomon -> HAS; E6 TOW from E1's -> "
          "dual-band position)", flush=True)
    e6a = e6_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 16(b): E6-B alone, {E6_ALONE_DUR:g} s at "
          f"{FS_E6 / 1e6:g} Msps through the receiver (cold search, HAS; "
          "no TOW publisher)", flush=True)
    e6b = e6_alone_path(wrappers, card)
    torch.cuda.empty_cache()
    print(f"  phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)
    t17 = time.perf_counter()
    print("== phase 17(a): GLONASS L1 C/A through the CLI (device generator "
          f"-> {GLO_DUR:g} s ibyte file at {FS_G1 / 1e6:g} Msps -> "
          "Channels_1G.count=24: 13 slot chains, three satellites on slots "
          "-7, 0, +6 -> GNAV -> TOW, ephemerides; no fix)", flush=True)
    g1 = glonass_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 17(b): GLONASS L1 at {FS_G1 / 1e6:g} Msps on RF 0 + L2 "
          f"at {FS_G2 / 1e6:g} Msps on RF 1 (attach_arrays, L2 assisted)",
          flush=True)
    g12 = glonass_mb_path(wrappers, card)
    torch.cuda.empty_cache()
    print(f"  phase 17 took {time.perf_counter() - t17:.1f} s", flush=True)
    t18 = time.perf_counter()
    print("== phase 18(a): GPS L1 C/A + SBAS L1 through the CLI (device "
          f"generator -> {SBAS_DUR:g} s ishort file at {FS_FILE / 1e6:g} Msps "
          "-> conditioner -> 8 GPS + 2 S1 channels, GEOs 131 and 133 -> the "
          "250-bit messages -> corrections -> the corrected fix, against "
          "Channels_S1.count=0)", flush=True)
    s1 = sbas_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 18(b): the PVT modes on one GPS capture ({MODES_DUR:g} "
          f"s at {FS / 1e6:g} Msps: broadcast iono from page 18, "
          "Saastamoinen, RAIM against a 60 m fault; OFF; the Hatch filter "
          "and the PVT Kalman filter)", flush=True)
    modes = modes_path(wrappers, card)
    torch.cuda.empty_cache()
    print(f"  phase 18 took {time.perf_counter() - t18:.1f} s", flush=True)
    t19 = time.perf_counter()
    print(f"== phase 19(a): RTK through the CLI (device generator -> a "
          f"{RTK_BASE_DUR:g} s base through process_array -> RINEX obs file; "
          f"a {RTK_ROVER_DUR:g} s rover {ROVER_ENU} m east/north/up of it -> "
          "ishort file -> RTK_Static conf -> DD carrier phase, LAMBDA -> "
          "fixed baseline)", flush=True)
    print(f"== phase 19(b): RTK over RTCM (the base run -> MSM7, 1019, 1005 "
          f"frames -> 127.0.0.1 -> decoder -> a {RTCM_ROVER_DUR:g} s rover "
          "through process_array)", flush=True)
    rtk = rtk_path(root, wrappers, card)
    torch.cuda.empty_cache()
    print(f"== phase 19(c), (d): PPP_Static and the orbital EKF on "
          f"{PPP_DUR:g} s at {PPP_CN0:g} dB-Hz (process_array, the sky's "
          "ephemerides)", flush=True)
    ppp = ppp_ekf_path(wrappers, card)
    print(f"  phase 19 took {time.perf_counter() - t19:.1f} s", flush=True)
    p19 = {k: rtk.get(k, 0) + ppp.get(k, 0) for k in rtk.keys() | ppp.keys()}
    print(f"  phase 19's launches: {dict(sorted(p19.items()))}")
    for name in ("K6_device_generator_E6", "K3b_pcps_wipe_per_channel_E6",
                 "K3_pcps_peak_assisted_E6", "K8a_block_prologue_E6",
                 "K1_K8b_K8a_block_step_E6", "K9_epoch_chunk_E6"):
        launches[name] = e6a[name] + e6b.get(name, 0)
    for name in ("K3_pcps_wipe_E6", "K3_pcps_peak_E6"):
        launches[name] = e6b[name]
    for name in ("K6_device_generator_GLO", "K3_pcps_wipe_GLO",
                 "K3_pcps_peak_GLO", "K3b_pcps_wipe_per_channel_GLO"):
        launches[name] = g1[name]
    for name in ("K8a_block_prologue_bias", "K1_K8b_K8a_block_step_bias",
                 "K9_epoch_chunk_bias"):
        launches[name] = g1[name] + g12[name]
    for name in ("K6_device_generator_S1", "K3_pcps_wipe_S1",
                 "K3_pcps_peak_S1", "K3b_pcps_wipe_per_channel_S1",
                 "K8a_block_prologue_S1", "K1_K8b_K8a_block_step_S1",
                 "K9_epoch_chunk_S1"):
        launches[name] = s1[name]
    # K6's launches: the captures of phases 5, 6, 7, 8, 10, 11 and 14 to 19
    launches["K6_device_generator"] = (k6 + full["K6_device_generator"]
                                       + k6_wb + pilot["K6_device_generator"]
                                       + ps["K6_device_generator"]
                                       + mb["K6_device_generator"]
                                       + l2c["K6_device_generator"]
                                       + l2mb["K6_device_generator"]
                                       + e5b["K6_device_generator"]
                                       + bds1["K6_device_generator"]
                                       + bds13["K6_device_generator"]
                                       + geo["K6_device_generator"]
                                       + e6a["K6_device_generator"]
                                       + e6b["K6_device_generator"]
                                       + g1["K6_device_generator"]
                                       + g12["K6_device_generator"]
                                       + s1["K6_device_generator"]
                                       + modes["K6_device_generator"]
                                       + p19["K6_device_generator"])
    # phase 19's receivers run phase 4's GPS shapes at 2 Msps: their
    # launches join those rows'
    for name in RTK_KERNELS[1:] + ("K3b_pcps_wipe_per_channel",):
        launches[name] += p19[name]
    for r in rows:
        r["launches"] = launches[r["name"]]

    wipe_shapes = dict(pcps.pcps_wipe.shapes)
    print(f"  the wipeoff's launches in phases 4 to 19 by (M, Doppler table, "
          f"N): {wipe_shapes}")
    missing = sorted({wipe_key(k) for k in wipe_shapes} - WIPE_CHECKED)
    if missing:
        fail(f"the wipeoff ran at shapes phase 3 did not hold to its "
             f"reference: {missing}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    print(card)
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, "reference_ms": r.get("reference_ms"),
         **{k: r[k] for k in ("launch_floor_ms", "lengths", "time_update_ms",
                              "time_update_reference_ms") if k in r}}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
