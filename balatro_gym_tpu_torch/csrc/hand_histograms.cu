// Masked hand histograms (K5) for Hopper (sm_90a): per env, the rank
// histogram [16] and the suit histogram [8] of its 8 cards under a mask, and
// the masked chip sum (rank histogram . chip table).
//
// Replaces balatro_gym_tpu/ops/pallas_kernels.py:44 _kernel (through
// hand_histograms): the TPU kernel builds one-hots of [TILE_B, 8] cards
// against a lane iota in VMEM and reduces them over the card axis, and the
// chip sum is a [16] x [16, 1] product on the matrix unit.
//
// What bounds it on this card: bytes. An env reads 72 B (8 int32 ranks, 8
// int32 suits, 8 mask bytes) and writes 100 B (16 + 8 + 1 float32); the
// arithmetic (8 cards x 2 bins) is far below the memory's rate.
//
// What the design does about it: one thread per env counts; every memory
// instruction of a warp covers whole sectors.
// - Loads: a thread reads its ranks and suits as two 16 B vectors each and
//   its mask as one 8 B vector, so a warp's pair of loads covers 1 KB of
//   consecutive rows.
// - Counting: rank counts (at most 8) in 4-bit fields of a 64-bit word,
//   suit counts in 4-bit fields of a 32-bit word. A card counts only if its
//   mask is set and its rank lies in [0, 16) (suit in [0, 8)), compared as
//   unsigned, so a card outside every bin counts in none and no shift is
//   out of range or negative.
// - Stores: the block's [256, 16] and [256, 8] float rows are written to
//   shared memory as 16 B chunks (swizzled, so that the eight threads of a
//   store phase hit eight distinct groups of banks) and copied out with
//   consecutive threads on consecutive 16 B: every warp store instruction
//   writes 512 contiguous bytes.
// Every term is a small integer, so the float32 counts and the chip sum
// (added card by card) are exact in any order and equal the plain version's
// bit for bit.

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int kCards = 8, kRanks = 16, kSuits = 8, kBlock = 256;
constexpr int kRankChunks = kRanks / 4, kSuitChunks = kSuits / 4;  // 16 B chunks a row

struct HistSmem {
  float4 rank[kBlock * kRankChunks];
  float4 suit[kBlock * kSuitChunks];
};

// Shared chunk of row t's chunk q: the eight rows of a store phase spread
// over all eight 16 B bank groups.
__device__ __forceinline__ int rank_slot(int t, int q) {
  return t * kRankChunks + (q ^ ((t >> 1) & 3));
}
__device__ __forceinline__ int suit_slot(int t, int q) {
  return t * kSuitChunks + (q ^ ((t >> 2) & 1));
}

__device__ __forceinline__ float4 nibbles4(uint64_t x, int q) {
  const uint32_t v = (uint32_t)(x >> (16 * q));
  return make_float4((float)(v & 15u), (float)((v >> 4) & 15u), (float)((v >> 8) & 15u),
                     (float)((v >> 12) & 15u));
}

// Phase 1: thread t counts env base + t, writes its chip sum and stages its
// rows in shared memory.
__device__ __forceinline__ void hist_count(HistSmem& sm, const int* __restrict__ ranks,
                                           const int* __restrict__ suits,
                                           const uint8_t* __restrict__ mask,
                                           const float* __restrict__ chip_table,
                                           float* __restrict__ chips, int t, int base,
                                           int n_envs) {
  const int e = base + t;
  if (e >= n_envs) return;
  const size_t row = (size_t)e * kCards;
  const int4 r0 = reinterpret_cast<const int4*>(ranks + row)[0];
  const int4 r1 = reinterpret_cast<const int4*>(ranks + row)[1];
  const int4 s0 = reinterpret_cast<const int4*>(suits + row)[0];
  const int4 s1 = reinterpret_cast<const int4*>(suits + row)[1];
  const uint2 m = *reinterpret_cast<const uint2*>(mask + row);
  const int r[kCards] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  const int s[kCards] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint64_t rc = 0ull;
  uint32_t sc = 0u;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kCards; ++c) {
    const bool on = ((c < 4 ? m.x : m.y) >> (8 * (c & 3))) & 0xFFu;
    const uint32_t rr = (uint32_t)r[c], ss = (uint32_t)s[c];
    if (on && rr < (uint32_t)kRanks) {
      rc += 1ull << (4 * rr);
      sum += chip_table[rr];
    }
    if (on && ss < (uint32_t)kSuits) sc += 1u << (4 * ss);
  }
  chips[e] = sum;
#pragma unroll
  for (int q = 0; q < kRankChunks; ++q) sm.rank[rank_slot(t, q)] = nibbles4(rc, q);
#pragma unroll
  for (int q = 0; q < kSuitChunks; ++q) sm.suit[suit_slot(t, q)] = nibbles4(sc, q);
}

// Phase 2: the block's rows copied out, consecutive threads on consecutive
// 16 B chunks.
__device__ __forceinline__ void hist_copy_out(const HistSmem& sm, float* __restrict__ rank_hist,
                                              float* __restrict__ suit_hist, int t, int base,
                                              int n_envs) {
  const int rows = n_envs - base < kBlock ? n_envs - base : kBlock;
  float4* rh = reinterpret_cast<float4*>(rank_hist + (size_t)base * kRanks);
  float4* sh = reinterpret_cast<float4*>(suit_hist + (size_t)base * kSuits);
  for (int i = t; i < rows * kRankChunks; i += kBlock)
    rh[i] = sm.rank[rank_slot(i / kRankChunks, i % kRankChunks)];
  for (int i = t; i < rows * kSuitChunks; i += kBlock)
    sh[i] = sm.suit[suit_slot(i / kSuitChunks, i % kSuitChunks)];
}

__global__ void __launch_bounds__(kBlock) hand_histograms_kernel(
    const int* __restrict__ ranks, const int* __restrict__ suits,
    const uint8_t* __restrict__ mask, const float* __restrict__ chip_table,
    float* __restrict__ rank_hist, float* __restrict__ suit_hist, float* __restrict__ chips,
    int n_envs) {
  __shared__ HistSmem sm;
  const int base = blockIdx.x * kBlock;
  hist_count(sm, ranks, suits, mask, chip_table, chips, threadIdx.x, base, n_envs);
  __syncthreads();
  hist_copy_out(sm, rank_hist, suit_hist, threadIdx.x, base, n_envs);
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// ranks, suits [n_envs, 8] i32 (16 B aligned); mask [n_envs, 8] u8 (8 B
// aligned); chip_table [16] f32 -> rank_hist [n_envs, 16], suit_hist [n_envs,
// 8], chips [n_envs] f32 (outputs allocated by the caller, 16 B aligned).
// Runs on ``stream``; returns the cudaError_t.
extern "C" int hand_histograms_launch(const int* ranks, const int* suits, const uint8_t* mask,
                                      const float* chip_table, float* rank_hist,
                                      float* suit_hist, float* chips, int n_envs,
                                      void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  hand_histograms_kernel<<<(n_envs + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      ranks, suits, mask, chip_table, rank_hist, suit_hist, chips, n_envs);
  return (int)cudaGetLastError();
}

// K5's launch shape: block, shared bytes a block, registers and stack bytes
// a thread, as built for this card.
extern "C" int hand_histograms_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, hand_histograms_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = kBlock;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return (int)cudaSuccess;
}
#endif
