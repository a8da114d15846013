// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile edges of the dQ and fp32 kernels, the mask value, the band of
// in-band tiles seen from either side, the tile predicates of the
// mask-free path, the score function, and the mma.sync / ldmatrix /
// cp.async wrappers of the dQ kernel. The Hopper building blocks (TMA,
// mbarrier, wgmma) are in hopper.cuh.
//
// `band` and `q_band` are the JAX package's `_tile_in_band` predicate
// (tfde_tpu/ops/flash_attention.py) turned into loop bounds, for a tile
// shape given as template arguments: `band` gives the K tiles a Q tile
// sees (the forward's and the dQ kernel's loop), `q_band` the Q tiles that
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

constexpr int BM = 64;         // query rows per tile (dQ and fp32 kernels)
constexpr int BN = 64;         // key columns per tile (dQ and fp32 kernels)
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

// mma.sync m16n8k16 fragment layout (g = lane / 4, c = 2 * (lane % 4)):
// A (16x16, row-major)  a0 = A[g][c..c+1]   a1 = A[g+8][c..c+1]
//                       a2 = A[g][c+8..c+9] a3 = A[g+8][c+8..c+9]
// B (16x8, "col")       b0 = B[c..c+1][g]   b1 = B[c+8..c+9][g]
// C (16x8, fp32)        c0,c1 = C[g][c..c+1]  c2,c3 = C[g+8][c..c+1]
// so two adjacent 8-column C tiles, rounded to bf16, form the A fragment
// of the next product without leaving the registers (`c_to_a`).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 0-7, 8-15, 16-23, 24-31 give
// the row addresses of matrices 0-3; register i holds matrix i's
// (row 2*(lane%4) .. +1, col lane/4) pair
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const __nv_bfloat16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(ptr)));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// two floats -> one register of two bf16 (round to nearest even), the
// lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 rows x 16 k) made of C tiles 2kk and 2kk+1, rounded
// to bf16.
__device__ __forceinline__ void c_to_a(uint32_t* a, float (*c)[4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The A fragment of wgmma k-step kk (accumulator columns 16kk..16kk+15) of
// a register product, from an fp32 wgmma accumulator rounded to bf16: the
// same registers as `c_to_a` (hopper.cuh, the accumulator layout).
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float (&d)[N],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// The A fragment of rows r0..r0+15, k columns k0..k0+15 of a row-major
// bf16 tile in shared memory with row pitch `pitch`.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int pitch, int r0, int k0, int lane) {
  const int g = lane >> 2, c = (lane & 3) * 2;
  const __nv_bfloat16* base = t + (r0 + g) * pitch + k0 + c;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * pitch);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * pitch + 8);
}

// C (16 x 64, eight 8-column tiles) += A (16 x D, rows r0.. of `a_tile`)
// times B^T, B (64 x D) = rows n0.. of `b_tile`: the product of two
// row-major tiles over their contiguous dim (Q K^T, dO V^T, K Q^T, ...).
template <int D>
__device__ __forceinline__ void mma_abt(float (*c)[4],
                                        const __nv_bfloat16* a_tile,
                                        int r0, const __nv_bfloat16* b_tile,
                                        int pitch, int lane) {
  const int g = lane >> 2, cc = (lane & 3) * 2;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a(a, a_tile, pitch, r0, kk * 16, lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const __nv_bfloat16* br = b_tile + (j * 8 + g) * pitch + kk * 16 + cc;
      mma_16816(c[j], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc (16 x D, D/8 tiles) += A (16 x 64, from the C tiles `c` rounded to
// bf16) times B (64 x D), a row-major tile in shared memory read through
// ldmatrix.trans: P V, P^T dO, dS^T Q, dS K.
template <int D>
__device__ __forceinline__ void mma_cb(float (*acc)[4], float (*c)[4],
                                       const __nv_bfloat16* b_tile,
                                       int pitch, int lane) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, c, kk);
#pragma unroll
    for (int t2 = 0; t2 < D / 16; ++t2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, b_tile + (kk * 16 + (lane & 15)) * pitch +
                               t2 * 16 + (lane >> 4) * 8);
      mma_16816(acc[2 * t2], a, b[0], b[1]);
      mma_16816(acc[2 * t2 + 1], a, b[2], b[3]);
    }
  }
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
