// Holds block_correlator.cu's div_rn (the correctly rounded division by F
// with F's reciprocal hoisted) against __fdiv_rn, bit for bit, over every
// float32 bit pattern a, at each F the tracking paths use and at the other
// F below: 2 to 2048 and 300 drawn from [2049, 2^30).  Not a kernel of the
// receiver and not built by cuda_build.py; run it on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/div_rn_sweep \
//       gnss_sim_receiver_tpu_torch/csrc/div_rn_sweep.cu && build/div_rn_sweep
//
// It prints the divisors tried and the mismatches, and exits 1 on any.

#include <cstdio>

#include "block_correlator.cu"

namespace {

__global__ void sweep(float f, unsigned long long* bad, unsigned* example) {
  const float rf = recip(f);
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float a = __uint_as_float((unsigned)i);
    if (__float_as_uint(div_rn(a, f, rf)) != __float_as_uint(__fdiv_rn(a, f))
        && atomicAdd(bad, 1ull) == 0)
      *example = (unsigned)i;
  }
}

}  // namespace

int main() {
  // F of the block paths: GPS L1 C/A at 2, 4 and 20 Msps, Galileo E1 at 4
  // and 20 Msps, GPS L5 and Galileo E5a at 20 Msps
  int fs[2048 + 8 + 300];
  int n = 0;
  for (int f : {4096, 8100, 40500, 32400, 162000}) fs[n++] = f;
  for (int f = 2; f <= 2048; ++f) fs[n++] = f;
  unsigned x = 12345u;
  for (int i = 0; i < 300; ++i) {
    x = x * 1664525u + 1013904223u;
    fs[n++] = 2049 + (int)(x % ((1u << 30) - 2049));
  }
  unsigned long long* bad;
  unsigned* example;
  if (cudaMallocManaged(&bad, sizeof *bad) != cudaSuccess ||
      cudaMallocManaged(&example, sizeof *example) != cudaSuccess)
    return 2;
  unsigned long long total = 0;
  for (int i = 0; i < n; ++i) {
    *bad = 0;
    sweep<<<132 * 16, 256>>>((float)fs[i], bad, example);
    if (cudaDeviceSynchronize() != cudaSuccess) return 2;
    if (*bad)
      printf("F = %d: %llu mismatches, a = 0x%08x among them\n", fs[i], *bad,
             *example);
    total += *bad;
  }
  printf("div_rn against __fdiv_rn: %d divisors x 2^32 values of a, "
         "%llu mismatches\n", n, total);
  return total ? 1 : 0;
}
