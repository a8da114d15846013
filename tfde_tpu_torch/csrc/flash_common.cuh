// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile edges of the fp32 kernels, the mask value, the band of in-band
// tiles seen from either side, the tile predicates of the mask-free path,
// the score function, and the rounding of a wgmma accumulator into the A
// fragments of a register product. The Hopper building blocks (TMA,
// mbarrier, wgmma) are in hopper.cuh.
//
// `band` and `q_band` are the JAX package's `_tile_in_band` predicate
// (tfde_tpu/ops/flash_attention.py) turned into loop bounds, for a tile
// shape given as template arguments: `band` gives the K tiles a Q tile
// sees (the forward's and the dQ kernels' loop), `q_band` the Q tiles that
// see a K tile (the dK/dV kernel's loop). `tile_live` says whether a
// warpgroup's part of a tile holds any pair to compute, `tile_unmasked`
// whether every pair of it is visible and in range, so that the tile skips
// the mask. tests/test_torch_flash_tiles.py transcribes all four and holds
// them against the predicate and a brute force over the pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash {

constexpr int BM = 64;         // query rows per tile (the fp32 kernels)
constexpr int BN = 64;         // key columns per tile (the fp32 kernels)
constexpr float NEG = -1e30f;  // the TPU kernels' mask value
// what an entry point returns, plus the CUresult, when the CUDA driver
// refuses a tensor map (above every cudaError_t)
constexpr int TMA_ENCODE_ERROR = 10000;

// The in-band K tiles [kb_begin, kb_end) of the TM-row Q tile starting at
// row q0, with TN-column K tiles. P: any struct with S, causal and window.
template <int TM = BM, int TN = BN, class P>
__device__ __forceinline__ void band(const P& p, int q0, int& kb_begin,
                                     int& kb_end) {
  kb_begin = 0;
  kb_end = (p.S + TN - 1) / TN;
  if (p.causal) {
    kb_end = min(kb_end, (q0 + TM - 1) / TN + 1);
    if (p.window > 0) {
      const int lo = q0 - (p.window - 1);  // oldest column row q0 sees
      kb_begin = lo > 0 ? lo / TN : 0;
    }
  }
}

// The in-band TM-row Q tiles [qb_begin, qb_end) of the TN-column K tile
// starting at column k0: the same predicate as `band`, seen from the K
// side.
template <int TM = BM, int TN = BN, class P>
__device__ __forceinline__ void q_band(const P& p, int k0, int& qb_begin,
                                       int& qb_end) {
  qb_begin = 0;
  qb_end = (p.S + TM - 1) / TM;
  if (p.causal) {
    qb_begin = k0 / TM;  // the first tile whose last row reaches column k0
    if (p.window > 0)    // the last tile whose first row still sees k0+TN-1
      qb_end = min(qb_end, (k0 + TN - 1 + p.window - 1) / TM + 1);
  }
}

// Whether the TM x TN block of pairs (rows = queries r0.., columns = keys
// c0..) may hold a visible pair with both ends inside S. False means every
// pair is masked or lies past S, and the block is skipped: no product, no
// effect on the sums.
template <int TM, int TN, class P>
__device__ __forceinline__ bool tile_live(const P& p, int r0, int c0) {
  if (r0 >= p.S || c0 >= p.S) return false;
  if (!p.causal) return true;
  if (c0 > r0 + TM - 1) return false;  // every column after every row
  return p.window <= 0 || c0 + TN - 1 >= r0 - (p.window - 1);
}

// Whether every pair of the TM x TN block is visible and inside S: then the
// block takes the mask-free path (no mask test, no edge test per score).
// Exact: false means at least one pair is masked or past S.
template <int TM, int TN, class P>
__device__ __forceinline__ bool tile_unmasked(const P& p, int r0, int c0) {
  if (r0 + TM > p.S || c0 + TN > p.S) return false;
  if (!p.causal) return true;
  if (c0 + TN - 1 > r0) return false;  // the last column after the first row
  return p.window <= 0 || r0 + TM - 1 - c0 < p.window;
}

// One score: scale, tanh cap, then the causal/window/ragged-edge mask.
// Returns the masked value; *t gets tanh(z / cap) (0 without a cap), which
// the backward needs for the cap's derivative 1 - t^2.
template <class P>
__device__ __forceinline__ float score(float dot, int row, int col,
                                       const P& p, float* t = nullptr) {
  float z = dot * p.scale;
  float th = 0.f;
  if (p.cap > 0.f) {
    th = tanhf(z / p.cap);
    z = p.cap * th;
  }
  if (t) *t = th;
  bool keep = col < p.S;
  if (p.causal) {
    keep = keep && row >= col;
    if (p.window > 0) keep = keep && (row - col < p.window);
  }
  return keep ? z : NEG;
}

// two floats -> one register of two bf16 (round to nearest even), the
// lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of wgmma k-step kk (accumulator columns 16kk..16kk+15) of
// a register product, from an fp32 wgmma accumulator rounded to bf16
// (hopper.cuh, the accumulator layout): rows g and g + 8 of the thread's
// warp, columns c, c + 1 and c + 8, c + 9 of the k-step.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (&d)[N],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Launch `kernel` on `grid` after raising its dynamic shared memory limit.
template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem,
                   const P& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace flash
