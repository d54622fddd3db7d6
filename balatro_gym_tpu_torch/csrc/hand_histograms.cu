// Masked hand histograms for Hopper (sm_90a): per env, the rank histogram
// [16] and the suit histogram [8] of its 8 cards under a mask, and the
// masked chip sum (rank histogram . chip table).
//
// Replaces balatro_gym_tpu/ops/pallas_kernels.py:44 _kernel (through
// hand_histograms): the TPU kernel builds one-hots of [TILE_B, 8] cards
// against a lane iota in VMEM and reduces them over the card axis, and the
// chip sum is a [16] x [16, 1] product on the matrix unit.
//
// What bounds it on this card: bytes. An env reads 72 B (8 int32 ranks, 8
// int32 suits, 8 mask bytes) and writes 100 B (16 + 8 + 1 float32); the
// arithmetic (8 x 24 compares and adds) is far below the memory's rate.
//
// What the design does about it: one thread per env, so every load and
// store is a whole row of the env (32 B of ranks, 64 B of rank histogram)
// and a warp's accesses cover contiguous memory; the 24 counters live in
// registers, and nothing is written but the outputs. A card is counted by
// comparing it with every bin, as the TPU kernel's one-hot does: a rank
// outside [0, 16) or a suit outside [0, 8) counts in no bin, and no counter
// is indexed by a card's value. Every term is a small integer, so the
// float32 sums are exact in any order and equal the plain version's bit for
// bit.

#ifndef FULL_ROLLOUT_HOST_SHIM
#include <cuda_runtime.h>
#endif
#include <stdint.h>

namespace {

constexpr int kCards = 8, kRanks = 16, kSuits = 8, kBlock = 256;

__global__ void __launch_bounds__(kBlock) hand_histograms_kernel(
    const int* __restrict__ ranks, const int* __restrict__ suits,
    const uint8_t* __restrict__ mask, const float* __restrict__ chip_table,
    float* __restrict__ rank_hist, float* __restrict__ suit_hist, float* __restrict__ chips,
    int n_envs) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n_envs) return;
  float rh[kRanks], sh[kSuits];
  for (int k = 0; k < kRanks; ++k) rh[k] = 0.f;
  for (int k = 0; k < kSuits; ++k) sh[k] = 0.f;
  const size_t row = (size_t)e * kCards;
  for (int c = 0; c < kCards; ++c) {
    const int r = ranks[row + c], s = suits[row + c];
    const float m = mask[row + c] ? 1.f : 0.f;
    for (int k = 0; k < kRanks; ++k) rh[k] += r == k ? m : 0.f;
    for (int k = 0; k < kSuits; ++k) sh[k] += s == k ? m : 0.f;
  }
  float sum = 0.f;
  for (int k = 0; k < kRanks; ++k) {
    sum += rh[k] * chip_table[k];
    rank_hist[(size_t)e * kRanks + k] = rh[k];
  }
  for (int k = 0; k < kSuits; ++k) suit_hist[(size_t)e * kSuits + k] = sh[k];
  chips[e] = sum;
}

}  // namespace

#ifndef FULL_ROLLOUT_HOST_SHIM
// ranks, suits [n_envs, 8] i32; mask [n_envs, 8] u8; chip_table [16] f32 ->
// rank_hist [n_envs, 16], suit_hist [n_envs, 8], chips [n_envs] f32 (outputs
// allocated by the caller). Runs on ``stream``; returns the cudaError_t.
extern "C" int hand_histograms_launch(const int* ranks, const int* suits, const uint8_t* mask,
                                      const float* chip_table, float* rank_hist,
                                      float* suit_hist, float* chips, int n_envs,
                                      void* stream) {
  if (n_envs <= 0) return (int)cudaSuccess;
  hand_histograms_kernel<<<(n_envs + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
      ranks, suits, mask, chip_table, rank_hist, suit_hist, chips, n_envs);
  return (int)cudaGetLastError();
}
#endif
