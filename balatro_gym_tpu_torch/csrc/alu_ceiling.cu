// Integer-ALU ceiling probe for Hopper (sm_90a): long chains of dependent
// int32 add, xor-shift and compare-select on every element, to measure the
// card's integer operation rate for the op mix of the env kernels.
//
// Replaces scripts/vpu_ceiling.py:28 kernel, the TPU's vector-unit probe.
// That kernel's block is [1, 8, 8, 128] and it reads x_ref[r] for r in
// 0..7, so each of its 8 "rows" is the whole block: every element of
// x [n_tiles, 8, 8, 128] runs the same chain on its own value, and the 8
// rows are 8 independent chains of one lane. One round of a chain is
//     v += 0x9E3779B9;  v ^= v << 13;  v = v > 0 ? v : v + 7
// (uint32 wrap for the add and the shift, a signed compare), and a run has
// K / (4 * 8) = 128 rounds.
//
// What bounds it on this card: operations, by design. A thread carries the
// 8 row chains of one (tile, sub, lane) element in 8 registers (the
// independent work each issue slot can choose from), reads 32 B and writes
// 32 B once, and between them runs 8 x rounds chain-rounds. The unit the
// probe reports is the script's: 6 source operations a chain-round (add,
// shift, xor, compare, select, add). What the compiler makes of a round
// (LOP3 can fuse the xor with another logic op, IADD3 three-input adds, SEL
// or IMNMX for the select) is read from the SASS of the loop body.
//
// The rounds are a runtime argument; the loop runs 4 rounds an iteration,
// so its overhead (counter, compare, branch) is shared by 32 chain-rounds,
// and a remainder loop takes rounds % 4.

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int kRows = 8, kTile = 8 * 128, kBlock = 256;

__device__ __forceinline__ uint32_t chain_round(uint32_t v) {
  v += 0x9E3779B9u;
  v ^= v << 13;
  return (int32_t)v > 0 ? v : v + 7u;
}

__global__ void __launch_bounds__(kBlock) alu_chains_kernel(
    const int* __restrict__ x, int* __restrict__ out, int n_tiles, int rounds) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_tiles * kTile) return;
  const size_t t = i / kTile, sl = i % kTile;
  uint32_t v[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) v[r] = (uint32_t)x[(t * kRows + r) * kTile + sl];
  int k = 0;
#pragma unroll 1
  for (; k + 4 <= rounds; k += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = chain_round(v[r]);
    }
  }
#pragma unroll 1
  for (; k < rounds; ++k) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = chain_round(v[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[(t * kRows + r) * kTile + sl] = (int)v[r];
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// x, out [n_tiles, 8, 8, 128] i32 (out allocated by the caller); ``rounds``
// rounds of every chain. Runs on ``stream``; returns the cudaError_t.
extern "C" int alu_chains_launch(const int* x, int* out, int n_tiles, int rounds,
                                 void* stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  const long long threads = (long long)n_tiles * kTile;
  alu_chains_kernel<<<(unsigned)((threads + kBlock - 1) / kBlock), kBlock, 0,
                      (cudaStream_t)stream>>>(x, out, n_tiles, rounds);
  return (int)cudaGetLastError();
}
#endif
