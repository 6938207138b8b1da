// K9 redesigned: the per-epoch tracking scan of one chunk in one launch,
// written for Hopper.
//
// Replaces the jax.lax.scan of gnss_sim_receiver_tpu/models/tracking.py:
// track_chunk (line 712) over _epoch_step (:376): T epochs of C channels
// in a row, each K2's correlation (the slab body k2_slab of
// csrc/multicorrelator.cu) and then K9's loop closure (epoch_close of
// csrc/epoch_step.cu), the state carried on the card from one epoch to
// the next as the scan carries it: one launch per chunk in place of the
// two-launch loop's 2T (K2 then K9 per epoch, each with its host call).
//
// What bounds it on the H100: each epoch's work is small (at 20 Msps and
// C = 10, K2 reads 1.6 MB and the closure moves ~1 kB per channel) and
// serial: the closure's outputs are the next correlation's inputs.  So an
// epoch takes a chain of latencies, not a rate: the slab work, a cluster
// barrier, the ordered sum, the closure on one warp, a second barrier.
// What the design removes is the two-launch loop's launch latency and the
// host's launch calls, two per epoch.
//
// The design:
// - the grid is (S', C), one thread-block cluster of S' CTAs per channel
//   (S' from the planner in models/tracking.py: at most 16, S' = 1 where
//   K2's plan has one slab; every cluster resident at once where the card
//   holds C of them, else the card runs them in waves: the clusters share
//   nothing but the staged-table miss count, an integer atomicAdd, so no
//   cluster waits for another); CTA r of
//   channel c correlates the slabs s of K2's plan (ops/correlator.py
//   plan_k2, unchanged) with s mod S' == r, each with K2's slab body, and
//   keeps their [K(+1)] partial sums in its own shared memory;
// - after a cluster barrier the leader (rank 0) sums the S partials in
//   slab order, reading the other CTAs' through distributed shared memory:
//   the standalone K2's order (its last CTA's), so the correlations carry
//   the same bits;
// - warp 0 of the leader runs K9's closure on them, with the channel's
//   TrackState held in the leader's shared memory for the whole chunk and
//   committed in place; it writes the epoch's row of the [T, C] planes and
//   publishes the next epoch's NCO inputs and length in its shared memory,
//   which every CTA reads through distributed shared memory after a second
//   cluster barrier;
// - the state is read once from `src` and written once to `dst`; the
//   lengths of the first epoch come in through n_c and those of the epoch
//   after the chunk go out through it.  Inactive channels are correlated
//   and masked by the closure, as in the two-launch loop.
//
// - the kernel is a template on the closure's form (csrc/epoch_step.cuh
//   EpochForm), one instantiation each; the leader holds the Kalman
//   trackers' state fields (covariance, Doppler rate, posterior) and
//   their pointers in the Kalman forms only, so the DLL/PLL forms keep
//   their shared memory (880 bytes of static shared memory on sm_90a).
//
// The barriers (barrier.cluster arrive.release / wait.acquire) order the
// shared and distributed shared memory between the epochs; the planes and
// dst are read only after the launch, so no fence is needed.  This file
// only adds (the ordered sum); the slab body and the closure keep their
// own files' contraction flags in the one library they are linked into
// (relocatable device code, ops/cuda_build.py).
//
// Plain PyTorch version: gnss_sim_receiver_tpu_torch/models/tracking.py:
// _chunk_plain (K2's and K9's plain versions, epoch by epoch).

#include <cooperative_groups.h>

#include "epoch_step.cuh"
#include "multicorrelator.cuh"

// the launch arguments (by value, laid out as the wrapper's ctypes
// Structure): ep.src is the chunk's first state, ep.dst receives its last,
// ep.n_c the lengths in and out; ep.corr is not read
struct EpochChunkArgs {
  K2Args k2;
  EpochArgs ep;
  int32_t n_epochs;                     // T
};

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = kK2Threads;
constexpr int kMaxOut = kK2MaxTaps + 1;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
constexpr int kStateFields = sizeof(EpochStatePtrs) / sizeof(void*);
static_assert(kStateFields == 42, "kFieldBytes lists every field");
// the fields before the Kalman trackers' five, which the DLL/PLL forms
// neither read nor write
constexpr int kLoopFields = 37;

// bytes of one channel's entry of each EpochStatePtrs field, in its order
// (a bool one byte, bit_hist 20 floats, sec_buf 32, kf_p 16)
__constant__ uint8_t kFieldBytes[kStateFields] = {
    1, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 8, 4,   // active .. epoch
    4, 4, 4, 4, 4, 4, 4,                        // the C/N0 accumulators
    4, 4, 4, 1, 80, 4, 1, 4,                    // cn0_db_hz .. bit_phase
    8, 8, 8, 4, 128, 1, 4, 4,                   // ext_p .. sec_polarity
    64, 4, 4, 4, 4};                            // kf_p .. bayes_psi_carr
// the fields a form holds, and their bytes in 8-byte slots
template <int kForm>
constexpr int kFormFields =
    kForm == kFormKf || kForm == kFormGauss ? kStateFields : kLoopFields;
template <int kForm>
constexpr int kStateBytes =
    35 * 8 + 80 + 128 + (kFormFields<kForm> == kLoopFields ? 0 : 64 + 4 * 8);

// one epoch's NCO inputs of a channel, as the leader publishes them
struct Inputs {
  int32_t pos;
  float rem_code;
  float code_freq;
  float rem_carr;
  float dop;
  int32_t n_c;
};

__device__ __forceinline__ void cluster_sync(cg::cluster_group& cl,
                                             unsigned n_cta) {
  if (n_cta > 1)
    cl.sync();
  else
    __syncthreads();
}

__device__ __forceinline__ uint8_t* const& field(const EpochStatePtrs& p,
                                                 int i) {
  return reinterpret_cast<uint8_t* const*>(&p)[i];
}

__device__ __forceinline__ void publish(Inputs& in, const EpochStatePtrs& st) {
  in.pos = st.pos[0];
  in.rem_code = st.rem_code_phase[0];
  in.code_freq = st.code_freq[0];
  in.rem_carr = st.rem_carr_phase[0];
  in.dop = st.carrier_doppler[0];
}

template <int kForm>
__global__ void __launch_bounds__(kThreads)
epoch_chunk_kernel(const __grid_constant__ EpochChunkArgs a) {
  constexpr int kFields = kFormFields<kForm>;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned n_cta = cluster.num_blocks();
  const bool leader = rank == 0;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_slabs = a.k2.n_slabs;
  const int two_n = 2 * (a.k2.n_taps + (a.k2.data ? 1 : 0));
  // this CTA's slabs' partials [ceil(S / S'), 2 K(+1)], after the stages
  float* part = k2_stage + a.k2.stage_cap + a.k2.data_stage_cap;
  __shared__ Inputs in;                         // the leader's, published
  __shared__ __align__(8) float corr[2 * kMaxOut];
  // the slots of st_buf, as the first kFields pointers of EpochStatePtrs
  // (a DLL/PLL form holds none for the Kalman fields, which its closure
  // never touches, so its shared memory is what it was before them)
  __shared__ uint8_t* st_slots[kFields];
  __shared__ __align__(8) uint8_t st_buf[kStateBytes<kForm>];
  const EpochStatePtrs& st =
      *reinterpret_cast<const EpochStatePtrs*>(st_slots);

  if (leader) {
    if (tid < kFields) {
      int off = 0;
      for (int i = 0; i < tid; ++i) off += (kFieldBytes[i] + 7) & ~7;
      const int nb = kFieldBytes[tid];
      uint8_t* slot = st_buf + off;
      st_slots[tid] = slot;
      const uint8_t* src = field(a.ep.src, tid) + (size_t)c * nb;
      for (int b = 0; b < nb; ++b) slot[b] = src[b];
    }
    __syncthreads();
    if (tid == 0) {
      publish(in, st);
      in.n_c = a.ep.n_c[c];
    }
  }
  cluster_sync(cluster, n_cta);
  const Inputs* lead_in = cluster.map_shared_rank(&in, 0);

  for (int e = 0; e < a.n_epochs; ++e) {
    const Inputs v = *lead_in;
    for (int s = rank, i = 0; s < n_slabs; s += n_cta, ++i) {
      const float sum = k2_slab(a.k2, c, s, v.pos, v.rem_code, v.code_freq,
                                v.rem_carr, v.dop, v.n_c);
      if (tid < two_n) part[i * two_n + tid] = sum;
    }
    cluster_sync(cluster, n_cta);
    if (leader && tid < 32) {                    // warp 0 (two_n <= 18)
      if (tid < two_n) {
        // slab order, eight remote reads in flight at a time
        float t = 0.0f;
        int s = 0;
        for (; s + 8 <= n_slabs; s += 8) {
          float p[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            p[u] = cluster.map_shared_rank(part, (s + u) % n_cta)
                       [((s + u) / n_cta) * two_n + tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) t += p[u];
        }
        for (; s < n_slabs; ++s)
          t += cluster.map_shared_rank(part, s % n_cta)
                   [(s / n_cta) * two_n + tid];
        corr[tid] = t;
      }
      __syncwarp();
      epoch_close<kForm>(a.ep, st, st, 0, c,
                         reinterpret_cast<const float2*>(corr), &in.n_c, e);
      if (tid == 0) publish(in, st);
    }
    cluster_sync(cluster, n_cta);
  }

  if (leader) {
    if (tid < kFields) {
      const int nb = kFieldBytes[tid];
      const uint8_t* slot = field(st, tid);
      uint8_t* dst = field(a.ep.dst, tid) + (size_t)c * nb;
      for (int b = 0; b < nb; ++b) dst[b] = slot[b];
    }
    if (tid == 0) a.ep.n_c[c] = in.n_c;
  }
}

cudaLaunchConfig_t launch_config(int cluster, int n_ch, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_ch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the dynamic shared memory a launch of form kForm may take, and clusters
// past the portable 8 CTAs; each set once per form, on the first launch or
// query that needs it (so that a launch captured in a CUDA graph sets
// nothing)
template <int kForm>
cudaError_t allow(int smem, int cluster) {
  static int smem_allowed = -1;
  static bool wide_allowed = false;
  cudaError_t err = cudaSuccess;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(epoch_chunk_kernel<kForm>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess) smem_allowed = smem;
  }
  if (err == cudaSuccess && cluster > kPortableCluster && !wide_allowed) {
    err = cudaFuncSetAttribute(epoch_chunk_kernel<kForm>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    wide_allowed = err == cudaSuccess;
  }
  return err;
}

template <int kForm>
cudaError_t launch(const EpochChunkArgs& a, int cluster, int smem,
                   cudaStream_t stream) {
  cudaError_t err = allow<kForm>(smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, a.ep.n_ch, smem,
                                               stream, &attr);
  return cudaLaunchKernelEx(&cfg, epoch_chunk_kernel<kForm>, a);
}

template <int kForm>
cudaError_t max_clusters(int cluster, int n_ch, int smem, int* n) {
  cudaError_t err = allow<kForm>(smem, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(cluster, n_ch, smem, nullptr,
                                               &attr);
  return cudaOccupancyMaxActiveClusters(n, epoch_chunk_kernel<kForm>, &cfg);
}

// the dynamic shared memory of a launch: the stages and this CTA's slabs'
// partials (models/tracking.py:epoch_chunk_smem repeats it)
size_t chunk_smem(const K2Args& k2, int cluster) {
  const int rounds = (k2.n_slabs + cluster - 1) / cluster;
  return sizeof(float) * ((size_t)k2.stage_cap + k2.data_stage_cap +
                          (size_t)rounds * 2 * (k2.n_taps + (k2.data ? 1 : 0)));
}

}  // namespace

extern "C" int epoch_chunk(EpochChunkArgs a, int cluster, int smem,
                           void* stream) {
  if (k2_args_invalid(a.k2, a.ep.n_ch) || epoch_args_invalid(a.ep) ||
      a.n_epochs < 1 || a.n_epochs > a.ep.n_rows || cluster < 1 ||
      cluster > kMaxCluster || cluster > a.k2.n_slabs ||
      a.k2.n_taps + (a.k2.data ? 1 : 0) != a.ep.n_taps + a.ep.has_data ||
      (size_t)smem < chunk_smem(a.k2, cluster))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (epoch_form(a.ep)) {
    case kFormLoop3: err = launch<kFormLoop3>(a, cluster, smem, st); break;
    case kFormLoop2: err = launch<kFormLoop2>(a, cluster, smem, st); break;
    case kFormKf: err = launch<kFormKf>(a, cluster, smem, st); break;
    default: err = launch<kFormGauss>(a, cluster, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters for the form `form` (EpochForm) in
// clusters of `cluster` CTAs with `smem` bytes of dynamic shared memory
// each, into *n
extern "C" int epoch_chunk_max_clusters(int cluster, int n_ch, int smem,
                                        int form, int* n) {
  if (cluster < 1 || cluster > kMaxCluster || n_ch < 1 || smem < 0 || !n ||
      form < 0 || form >= kEpochForms)
    return (int)cudaErrorInvalidValue;
  switch (form) {
    case kFormLoop3:
      return (int)max_clusters<kFormLoop3>(cluster, n_ch, smem, n);
    case kFormLoop2:
      return (int)max_clusters<kFormLoop2>(cluster, n_ch, smem, n);
    case kFormKf:
      return (int)max_clusters<kFormKf>(cluster, n_ch, smem, n);
    default:
      return (int)max_clusters<kFormGauss>(cluster, n_ch, smem, n);
  }
}
