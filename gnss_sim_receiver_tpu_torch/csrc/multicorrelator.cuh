// K2's slab body as a device function, shared by the standalone K2 kernel
// (csrc/multicorrelator.cu) and the per-epoch chunk kernel
// (csrc/epoch_chunk.cu).  Both live in one library built with
// relocatable device code (ops/cuda_build.py), so that this body keeps
// nvcc's default FMA contraction wherever it runs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the inputs of one K2 correlation that do not change between epochs (by
// value, laid out as the wrapper's ctypes Structure)
struct K2Args {
  const float2* x;                      // the chunk [n_x]
  const float* codes;                   // [C, L]
  const float* taps;                    // [K]
  const float* data;                    // [C, L'] or null
  uint64_t* misses;                     // [1] gathers outside the stage
  int32_t n_x;
  int32_t table_len;
  int32_t n_taps;
  int32_t block_size;
  int32_t data_table_len;
  int32_t n_slabs;                      // S, slabs per channel
  int32_t stage_cap;                    // staged code-table entries
  int32_t data_stage_cap;               // staged data-table entries
  float inv_fs;
  float k_ovs;
  float data_ovs;
};

constexpr int kK2Threads = 256;         // threads of a CTA that calls k2_slab
constexpr int kK2MaxTaps = 8;

// the table spans of the slab body: the first stage_cap + data_stage_cap
// floats of the dynamic shared memory of any kernel that calls k2_slab
extern __shared__ float k2_stage[];

// Slab s of channel c, samples [s B/S, (s+1) B/S) of its block at `pos`
// (clamped to the chunk), with the channel's NCO state: stages the slab's
// table span in the dynamic shared memory's first stage_cap +
// data_stage_cap floats, correlates, and returns in thread j < 2 K(+1) the
// CTA's sum of float j of the [K(+1)] complex row (0 in the other
// threads).  Every thread of the CTA calls it; it synchronizes the CTA.
__device__ float k2_slab(const K2Args& a, int c, int s, int pos,
                         float rem_code, float code_freq, float rem_carr,
                         float dop, int n_samples);

// true where K2's arguments for C = n_ch channels are past what the slab
// body takes
bool k2_args_invalid(const K2Args& a, int n_ch);
