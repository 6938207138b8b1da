"""The chunk kernel's launch planner (``models/tracking.py:plan_epoch_chunk``,
``csrc/epoch_chunk.cu``): one thread-block cluster of S' CTAs per channel
runs the S slabs of K2's own plan (``ops/correlator.py:plan_k2``), slab s
on CTA s mod S' at its local index s div S', and the leader sums the S
partials in slab order.  The kernel runs only on the card; on the CPU:

- at every shape a tracking path launches it at (GPS L1 C/A at 2, 4 and
  20 Msps, Galileo E1 at 4 and 20 Msps with and without the data table,
  GPS L5 and Galileo E5a at 20 Msps; C = 8, 10 and 12), the plan owns
  every slab on exactly one CTA, the leader's reads run over the slabs in
  slab order, the cluster stays within 16 CTAs (past the portable 8 by
  the opt-in its library sets), the shared memory within a CTA's 227 KB,
  S' = 1 where K2 has one slab, and every cluster is resident at once by
  a model of the card's occupancy (the card is asked on the card); the
  same at bench.py's 48 channels; at 192 and 300 channels, where the
  modelled card holds fewer clusters than channels, the plan runs them in
  the fewest waves times rounds;
- the slab-then-ordered sum that this ownership gives carries the bits
  of the sum over the slabs in order (float32, no reassociation);
- the planner raises where nothing fits and plans waves where too few
  clusters are resident; a hypothesis case over (C, B, table lengths)
  holds the same properties wherever it plans.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gnss_sim_receiver_tpu_torch.device import H100_SMS
from gnss_sim_receiver_tpu_torch.models import receiver as prx
from gnss_sim_receiver_tpu_torch.models import tracking as ptrk
from gnss_sim_receiver_tpu_torch.ops import correlator as pcorr
from gnss_sim_receiver_tpu_torch.ops import cuda_build

OVS = 8                 # table entries per chip (TrackingEngine)
SMEM_PER_SM = 233472    # an H100 SM's shared memory (1 KB of it per CTA)
GPC_SMS = 18            # SMs of a GPC, as the model groups an H100 SXM's
REGS = int(cuda_build.EPOCH_REGS[0].split("=")[1])   # the kernel's cap


def modelled_max_clusters(cluster: int, smem: int,
                          sms: int = H100_SMS) -> int:
    """cudaOccupancyMaxActiveClusters as modelled on the CPU: the CTAs of
    256 threads that fit on an SM by threads, registers and shared memory,
    in whole clusters inside each GPC (7 of 18 SMs and the rest).  It
    matches the card's answers for the kernel within a few clusters at
    C = 10 (tools/probe_epoch_chunk.py prints them)."""
    per_sm = min(2048 // 256, 65536 // (256 * REGS),
                 SMEM_PER_SM // (smem + ptrk.EPOCH_CHUNK_STATIC_SMEM + 1024))
    gpcs, rest = divmod(sms, GPC_SMS)
    return gpcs * (GPC_SMS * per_sm // cluster) + rest * per_sm // cluster

# (signal, fs, data table) of every per-epoch path
SHAPES = [("gps", 2e6, False), ("gps", 4e6, False), ("gps", 20e6, False),
          ("e1", 4e6, False), ("e1", 4e6, True), ("e1", 20e6, False),
          ("e1", 20e6, True), ("l5", 20e6, False), ("e5a", 20e6, False)]


def _conf(sig: str, fs: float) -> ptrk.TrackingConf:
    if sig == "gps":
        return ptrk.TrackingConf(fs=fs)
    chain = {"e1": prx.galileo_e1b_chain, "l5": prx.gps_l5_chain,
             "e5a": prx.galileo_e5a_chain}[sig]
    return chain(fs).trk


def _owners(plan: ptrk.EpochChunkPlan) -> list[list[int]]:
    """The slabs of each CTA of a cluster, in its local order: slab s on
    CTA s mod S' at local index s div S' (csrc/epoch_chunk.cu)."""
    cl = plan.cluster
    return [list(range(r, plan.k2.slabs, cl)) for r in range(cl)]


def _leader_reads(plan: ptrk.EpochChunkPlan) -> list[tuple[int, int]]:
    """(CTA, local index) of each partial the leader adds, in its order."""
    return [(s % plan.cluster, s // plan.cluster)
            for s in range(plan.k2.slabs)]


def _check(plan: ptrk.EpochChunkPlan, n_ch: int, n_out: int) -> None:
    k2 = plan.k2
    owners = _owners(plan)
    owned = sorted(s for slabs in owners for s in slabs)
    assert owned == list(range(k2.slabs))                 # exactly once
    assert all(slabs for slabs in owners)                 # no idle CTA
    assert max(len(slabs) for slabs in owners) == plan.rounds
    reads = _leader_reads(plan)
    assert [owners[r][i] for r, i in reads] == list(range(k2.slabs))
    assert all(i < plan.rounds for _, i in reads)
    assert plan.cluster <= ptrk.EPOCH_CHUNK_MAX_CLUSTER
    assert plan.smem == 4 * (k2.stage + k2.data_stage
                             + plan.rounds * 2 * n_out)
    assert plan.smem + ptrk.EPOCH_CHUNK_STATIC_SMEM <= ptrk.SMEM_PER_CTA
    assert plan.smem + ptrk.EPOCH_CHUNK_STATIC_SMEM <= 227 * 1024
    if k2.slabs == 1:
        assert plan.cluster == 1
    # every channel's cluster resident at once, or the waves that run them
    resident = modelled_max_clusters(plan.cluster, plan.smem)
    assert resident >= 1
    assert plan.waves == -(-n_ch // resident)


def _plan(sig, fs, data, c):
    conf = _conf(sig, fs)
    table = conf.code_length_chips * OVS
    k = 5 if conf.very_early_late_space_chips > 0 else 3
    k2 = pcorr.plan_k2(c, conf.block_size, table, OVS, table if data else 0,
                       OVS)
    n_out = k + int(data)
    return ptrk.plan_epoch_chunk(c, k2, n_out, modelled_max_clusters), n_out


@pytest.mark.parametrize("sig,fs,data", SHAPES)
@pytest.mark.parametrize("c", [8, 10, 12])
def test_plan_covers_every_path(sig, fs, data, c):
    """Every slab on one CTA, the leader's reads in slab order, S' within
    16, the shared memory within 227 KB, S' = 1 where K2 has one slab,
    every cluster resident; a 20 Msps shape spreads its slabs over a
    cluster and runs them in the fewest rounds a cluster of 16 allows."""
    plan, n_out = _plan(sig, fs, data, c)
    _check(plan, c, n_out)
    if fs == 20e6:
        assert plan.k2.slabs > 1 and plan.cluster > 1
        assert plan.rounds == -(-plan.k2.slabs // 16)


@pytest.mark.parametrize("sig,fs,data", SHAPES)
def test_plan_keeps_bench_channel_counts_resident(sig, fs, data):
    """At bench.py's 48 channels K2's plan has fewer slabs per channel and
    the planner a smaller cluster; every property holds and every
    channel's cluster stays resident."""
    plan, n_out = _plan(sig, fs, data, 48)
    _check(plan, 48, n_out)


@pytest.mark.parametrize("slabs", [1, 7, 26, 33])
def test_ordered_sum_carries_the_slab_order_bits(slabs):
    """Partials kept per CTA and read back by the leader in slab order
    give, bit for bit, the float32 sum over the slabs in order (the
    standalone K2's last CTA's), whatever the cluster size."""
    rng = np.random.default_rng(slabs)
    parts = (rng.standard_normal(slabs) * 10.0 ** rng.uniform(-3, 3, slabs)
             ).astype(np.float32)
    want = np.float32(0.0)
    for v in parts:
        want = np.float32(want + v)
    k2 = pcorr.K2Plan(slabs, 1000, 0)
    for cl in range(1, min(16, slabs) + 1):
        plan = ptrk.EpochChunkPlan(k2, cl, -(-slabs // cl),
                                   ptrk.epoch_chunk_smem(k2, 3, cl))
        smem = [[parts[s] for s in slabs_r] for slabs_r in _owners(plan)]
        got = np.float32(0.0)
        for r, i in _leader_reads(plan):
            got = np.float32(got + smem[r][i])
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sig,fs,data", SHAPES)
@pytest.mark.parametrize("c", [192, 300])
def test_plan_runs_large_channel_counts_in_waves(sig, fs, data, c):
    """At 192 channels (the bench's largest count) and 300 every property
    holds; where the modelled card keeps fewer clusters than channels
    resident (GPS at 2 Msps: two single-CTA clusters on each of 132 SMs,
    264) the plan takes waves, and no cluster size takes fewer waves
    times rounds."""
    plan, n_out = _plan(sig, fs, data, c)
    _check(plan, c, n_out)
    if (sig, fs) == ("gps", 2e6):
        assert (plan.cluster, plan.waves) == (1, 1 if c == 192 else 2)
    cost = plan.waves * plan.rounds
    for cl in range(1, min(plan.k2.slabs, ptrk.EPOCH_CHUNK_MAX_CLUSTER) + 1):
        smem = ptrk.epoch_chunk_smem(plan.k2, n_out, cl)
        resident = modelled_max_clusters(cl, smem)
        if smem + ptrk.EPOCH_CHUNK_STATIC_SMEM > ptrk.SMEM_PER_CTA \
                or resident < 1:
            continue
        if plan.waves > 1:
            assert -(-c // resident) * -(-plan.k2.slabs // cl) >= cost


def test_plan_raises_where_nothing_fits():
    k2 = pcorr.K2Plan(26, 2000, 0)
    with pytest.raises(ValueError):       # no cluster resident
        ptrk.plan_epoch_chunk(10, k2, 3, lambda cl, smem: 0)
    # too few resident: two waves of 9 clusters, S' = 13 (two rounds, the
    # fewest, at the smallest size that gives them)
    waves = ptrk.plan_epoch_chunk(10, k2, 3, lambda cl, smem: 9)
    assert (waves.cluster, waves.rounds, waves.waves) == (13, 2, 2)
    # a size that keeps every cluster resident wins over fewer rounds in
    # waves; among sizes that all take waves, waves times rounds decides
    waves = ptrk.plan_epoch_chunk(
        10, k2, 3, lambda cl, smem: 10 if cl <= 4 else 2)
    assert (waves.cluster, waves.rounds, waves.waves) == (4, 7, 1)
    waves = ptrk.plan_epoch_chunk(
        100, k2, 3, lambda cl, smem: 50 if cl <= 4 else 20)
    assert (waves.cluster, waves.rounds, waves.waves) == (13, 2, 5)
    with pytest.raises(ValueError):       # stages past 227 KB
        ptrk.plan_epoch_chunk(10, pcorr.K2Plan(4, 60000, 0), 3,
                              modelled_max_clusters)
    for c, n_out in ((0, 3), (65536, 3), (10, 0), (10, 10)):
        with pytest.raises(ValueError):
            ptrk.plan_epoch_chunk(c, k2, n_out, modelled_max_clusters)


def test_plan_asks_for_residency_of_every_channel():
    """The planner takes the smallest cluster of the fewest rounds that the
    occupancy answer keeps resident for all C channels: a card that holds
    fewer large clusters gets a smaller one."""
    k2 = pcorr.K2Plan(26, 2000, 0)
    assert ptrk.plan_epoch_chunk(10, k2, 3,
                                 lambda cl, smem: 100).cluster == 13
    small = ptrk.plan_epoch_chunk(10, k2, 3,
                                  lambda cl, smem: 10 if cl <= 9 else 5)
    assert small.cluster == 9 and small.rounds == 3


@settings(max_examples=200, deadline=None)
@given(c=st.integers(1, 400), b=st.integers(128, 100_000),
       table=st.integers(1, 70_000), data=st.integers(0, 70_000),
       ovs=st.sampled_from([1, 2, 8]), taps=st.sampled_from([3, 5]))
def test_plan_properties_hold_wherever_it_plans(c, b, table, data, ovs,
                                                taps):
    k2 = pcorr.plan_k2(c, b, table, ovs, data, ovs)
    n_out = taps + int(data > 0)
    plan = ptrk.plan_epoch_chunk(c, k2, n_out, modelled_max_clusters)
    assert plan.k2 == k2
    _check(plan, c, n_out)
    # where every cluster is resident, no cluster size that runs the slabs
    # in fewer rounds, or in as many with fewer CTAs, keeps every channel's
    # cluster resident; where the plan takes waves, no size keeps them all
    # resident, and none takes fewer waves times rounds, or as many with
    # fewer CTAs
    for cl in range(1, min(k2.slabs, ptrk.EPOCH_CHUNK_MAX_CLUSTER) + 1):
        smem = ptrk.epoch_chunk_smem(k2, n_out, cl)
        if smem + ptrk.EPOCH_CHUNK_STATIC_SMEM > ptrk.SMEM_PER_CTA:
            continue
        resident = modelled_max_clusters(cl, smem)
        rounds = -(-k2.slabs // cl)
        if plan.waves == 1:
            if (rounds, cl) < (plan.rounds, plan.cluster):
                assert resident < c
        else:
            assert resident < c
            if resident >= 1:
                assert (-(-c // resident) * rounds, cl) >= (
                    plan.waves * plan.rounds, plan.cluster)
