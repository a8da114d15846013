// Flash-attention backward for Hopper (sm_90a): the FlashAttention-2 pair.
//
// Replaces: tfde_tpu/ops/flash_attention.py::_dkv_kernel and ::_dq_kernel
// (the Pallas TPU kernels launched by _bwd_pallas). Same function: P is
// recomputed from the forward's lse, P = exp(cap(Q K^T * scale) - lse) with
// the -1e30 mask after the cap, and with delta = rowsum(dO * O) (computed
// by the caller, as _bwd_pallas does)
//   dV = P^T dO
//   dS = P * (dO V^T - delta) [* (1 - tanh^2) under a cap] * scale
//   dK = dS^T Q,   dQ = dS K.
// bf16 inputs round P and dS to bf16 before the products, as the TPU
// kernels cast them to the input dtype; fp32 accumulation throughout.
//
// What differs from the TPU kernels:
// - The TPU grid runs in order and carries dk/dv (dq) accumulators in VMEM
//   scratch across its last axis. Here that axis is a loop inside the
//   block: the dK/dV kernel's block owns one (K tile, KV head, batch) and
//   loops over the query heads of that KV head's group and, for each, over
//   the in-band Q tiles (`q_band`); the dQ kernel's block owns one (Q tile,
//   query head, batch) and loops over the in-band K tiles of KV head
//   h / (H / KV) (`band`, the forward's loop). Looping over the group
//   covers GQA with no cross-block reduction and no atomics; the Pallas
//   pair is MHA only. Two kernels, no atomics, a fixed order of the sums:
//   deterministic run to run.
// - q/k/v/dO are read in the caller's BSHD layout through element strides
//   (head dim contiguous); lse and delta as [B, H, S] fp32 (the TPU's
//   128-lane broadcast is a Mosaic layout, not data).
// - Ragged S: rows and columns past S are masked and never stored.
// - bf16 runs every product on the tensor cores (wgmma); fp32 runs them in
//   fp32 FMA on the CUDA cores (TF32 would miss the fp32 tolerance).
//   head_dim 64 or 128.
//
// Bound on the H100: at the training slice's shape (8 x 1024 tokens, 12
// heads, D = 64, bf16, causal; 50.4 M visible pairs) the dK/dV kernel does
// four products (8 D FLOP a pair, 25.8 GFLOP, ~26 us at 989 TFLOP/s) and
// moves ~76 MB (~23 us at 3.35 TB/s); the dQ kernel three products (19.3
// GFLOP, ~20 us) and ~64 MB (~19 us): both are bound by the operations,
// with the bytes close behind.
//
// Both bf16 kernels have one Hopper shape: 384-thread blocks of two
// consumer warpgroups and a producer warpgroup whose one thread keeps TMA
// loads in flight through an mbarrier ring; every product is a wgmma, the
// operands that stream from shared memory and the ones computed in the
// block (P, dS) from registers; warpgroup blocks with no visible pair are
// skipped and blocks whose every pair is visible skip the mask; no atomics.
// - dK/dV: a block owns 128 keys (64 a warpgroup), so every Q/dO tile
//   streamed serves 128 keys; lse/delta ride beside the Q/dO tiles
//   (cp.async); at D = 128, where the dK and dV accumulators alone take 128
//   of a thread's 168 registers, each Q tile in two halves.
// - dQ: a block owns 128 query rows (64 a warpgroup) with Q, dO, lse and
//   delta stationary, so every K/V tile streamed serves 128 rows; S and dP
//   are issued back to back (no running max sits between them) and P is
//   computed while dP is still on the tensor cores; at D = 64 the dQ
//   product of one tile stays in flight under the next tile's S and dP;
//   the longest causal rows launch first.

#include "flash_common.cuh"

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int causal, window;
  float scale, cap;
};

// dS of one (row, col) pair from its dot products q.k and dO.v: P
// recomputed from lse, then P (dP - delta) [(1 - t^2)] scale. *pe gets P.
__device__ __forceinline__ float grad_score(float qk, float dov, int row,
                                            int col, float lse, float delta,
                                            const Params& p, float* pe) {
  float t = 0.f;  // rows past S are masked and leave t unset
  const float z = row < p.S ? score(qk, row, col, p, &t) : NEG;
  const float pr = expf(z - lse);
  float ds = pr * (dov - delta);
  if (p.cap > 0.f) ds *= 1.f - t * t;
  *pe = pr;
  return ds * p.scale;
}

__device__ __forceinline__ size_t lse_index(const Params& p, int b, int h,
                                            int row) {
  return ((size_t)b * p.H + h) * p.S + row;
}

// ---------------------------------------------------------------- fp32 --
// 256 threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 ..
// ty*4+3 of its block's stationary tile in every phase: score columns
// tx + 16 j, output columns tx + 16 jj. A row's scores are written to
// shared memory and read back by the same half-warp (__syncwarp only).
constexpr int F_THREADS = 256;
constexpr int RPT = 4;  // rows per thread
constexpr int CPT = 4;  // score columns per thread

// rows [r0, r0 + n) of one head of a BSHD fp32 tensor into a tile of pitch
// D + 1 (conflict-free column reads); rows past S are zero
template <int D>
__device__ __forceinline__ void load_rows_fp32(float* dst, const float* src,
                                               long long row_stride, int r0,
                                               int n, int S, int tid) {
  for (int i = tid; i < n * D; i += F_THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? src[row * row_stride + d] : 0.f;
  }
}

template <int D>
constexpr size_t dkv_fp32_smem_bytes() {
  // K, V, Q, dO tiles (pitch D + 1), P^T and dS^T (pitch BM + 4), lse,
  // delta
  return sizeof(float) * (4 * (size_t)BM * (D + 1) +
                          2 * (size_t)BN * (BM + 4) + 2 * BM);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
dkv_fp32_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int TP = D + 1;
  constexpr int PP = BM + 4;
  constexpr int OPT = D / 16;
  float* Ks = smem;
  float* Vs = Ks + BN * TP;
  float* Qs = Vs + BN * TP;
  float* Os = Qs + BM * TP;
  float* Ps = Os + BM * TP;
  float* Ss = Ps + BN * PP;
  float* Ls = Ss + BN * PP;
  float* Ds = Ls + BM;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int grp = p.H / p.KV;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BN;
  load_rows_fp32<D>(Ks, static_cast<const float*>(p.k) + b * p.k_sb +
                            kvh * p.k_sh, p.k_ss, k0, BN, p.S, tid);
  load_rows_fp32<D>(Vs, static_cast<const float*>(p.v) + b * p.v_sb +
                            kvh * p.v_sh, p.v_ss, k0, BN, p.S, tid);
  int qb_begin, qb_end;
  q_band(p, k0, qb_begin, qb_end);

  float dk[RPT][OPT], dv[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  for (int h = kvh * grp; h < (kvh + 1) * grp; ++h) {
    for (int qi = qb_begin; qi < qb_end; ++qi) {
      const int q0 = qi * BM;
      __syncthreads();  // the previous Q tile's reads are done
      load_rows_fp32<D>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                                h * p.q_sh, p.q_ss, q0, BM, p.S, tid);
      load_rows_fp32<D>(Os, static_cast<const float*>(p.dout) +
                                b * p.o_sb + h * p.o_sh, p.o_ss, q0, BM,
                        p.S, tid);
      for (int i = tid; i < BM; i += F_THREADS) {
        const bool ok = q0 + i < p.S;
        Ls[i] = ok ? p.lse[lse_index(p, b, h, q0 + i)] : 0.f;
        Ds[i] = ok ? p.delta[lse_index(p, b, h, q0 + i)] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for keys ty*4+i, queries tx+16j
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Ks[(ty * RPT + i) * TP + d];
          vv[i] = Vs[(ty * RPT + i) * TP + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = Qs[(tx + 16 * j) * TP + d];
          ov[j] = Os[(tx + 16 * j) * TP + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int ql = tx + 16 * j, kl = ty * RPT + i;
          float pe;
          const float ds = grad_score(s[i][j], dp[i][j], q0 + ql,
                                             k0 + kl, Ls[ql], Ds[ql], p, &pe);
          Ps[kl * PP + ql] = pe;
          Ss[kl * PP + ql] = ds;
        }
      __syncwarp();

      // dV += P^T dO, dK += dS^T Q
#pragma unroll 4
      for (int ql = 0; ql < BM; ++ql) {
        float pv[RPT], sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[(ty * RPT + i) * PP + ql];
          sv[i] = Ss[(ty * RPT + i) * PP + ql];
        }
#pragma unroll
        for (int jj = 0; jj < OPT; ++jj) {
          const float ov = Os[ql * TP + tx + 16 * jj];
          const float qv = Qs[ql * TP + tx + 16 * jj];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv[i][jj] = fmaf(pv[i], ov, dv[i][jj]);
            dk[i][jj] = fmaf(sv[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    if (key < p.S) {
      float* dkg = static_cast<float*>(p.dk) + b * p.dk_sb + key * p.dk_ss +
                   kvh * p.dk_sh;
      float* dvg = static_cast<float*>(p.dv) + b * p.dv_sb + key * p.dv_ss +
                   kvh * p.dv_sh;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) {
        dkg[tx + 16 * jj] = dk[i][jj];
        dvg[tx + 16 * jj] = dv[i][jj];
      }
    }
  }
}

template <int D>
constexpr size_t dq_fp32_smem_bytes() {
  // Q, dO, K, V tiles (pitch D + 1), dS (pitch BN + 4)
  return sizeof(float) * (4 * (size_t)BM * (D + 1) + (size_t)BM * (BN + 4));
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
dq_fp32_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int TP = D + 1;
  constexpr int SP = BN + 4;
  constexpr int OPT = D / 16;
  float* Qs = smem;
  float* Os = Qs + BM * TP;
  float* Ks = Os + BM * TP;
  float* Vs = Ks + BN * TP;
  float* Ss = Vs + BN * TP;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BM;
  load_rows_fp32<D>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                            h * p.q_sh, p.q_ss, q0, BM, p.S, tid);
  load_rows_fp32<D>(Os, static_cast<const float*>(p.dout) + b * p.o_sb +
                            h * p.o_sh, p.o_ss, q0, BM, p.S, tid);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb +
                    kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb +
                    kvh * p.v_sh;
  float lse[RPT], delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    lse[i] = row < p.S ? p.lse[lse_index(p, b, h, row)] : 0.f;
    delta[i] = row < p.S ? p.delta[lse_index(p, b, h, row)] : 0.f;
  }
  int kb_begin, kb_end;
  band(p, q0, kb_begin, kb_end);

  float dq[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) dq[i][jj] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous K/V tile's reads are done
    load_rows_fp32<D>(Ks, kg, p.k_ss, k0, BN, p.S, tid);
    load_rows_fp32<D>(Vs, vg, p.v_ss, k0, BN, p.S, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for queries ty*4+i, keys tx+16j
    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * TP + d];
        ov[i] = Os[(ty * RPT + i) * TP + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * TP + d];
        vv[j] = Vs[(tx + 16 * j) * TP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int ql = ty * RPT + i, kl = tx + 16 * j;
        float pe;
        Ss[ql * SP + kl] = grad_score(s[i][j], dp[i][j], q0 + ql,
                                             k0 + kl, lse[i], delta[i], p,
                                             &pe);
      }
    __syncwarp();

    // dQ += dS K
#pragma unroll 4
    for (int kl = 0; kl < BN; ++kl) {
      float sv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = Ss[(ty * RPT + i) * SP + kl];
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) {
        const float kv = Ks[kl * TP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dq[i][jj] = fmaf(sv[i], kv, dq[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < p.S) {
      float* dqg = static_cast<float*>(p.dq) + b * p.dq_sb + row * p.dq_ss +
                   h * p.dq_sh;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) dqg[tx + 16 * jj] = dq[i][jj];
    }
  }
}

using bf16 = __nv_bfloat16;

// -------------------------------------------------------- bf16 dK / dV --
// 384 threads: warpgroups 0 and 1 are the consumers, each owning 64 of the
// block's 128 keys of one KV head, warpgroup 2 the producer. The
// producer loads K and V once, then streams (query head, Q tile) steps
// through a ring of DKV_STAGES stages: Q and dO by TMA (64 rows each),
// lse and delta by its warp's 4-byte cp.async into the same stage (their
// [B, H, S] rows are 4 S bytes apart: no 16-byte pitch for a tensor map at
// a ragged S; rows past S are zero-filled). The full barrier counts the 32
// lanes' cp.async arrivals, the TMA thread's and the TMA bytes; the empty
// barrier the 256 consumer threads. A consumer runs, for its 64 keys x the
// step's 64 queries:
//   S^T = K Q^T                  wgmma, A and B from shared memory, K-major
//   P^T                          in registers, rounded to bf16
//   dV += P^T dO, dP^T = V dO^T  wgmma, P^T from registers, dO MN-major;
//                                V and dO from shared memory, K-major
//   dS^T                         in registers, rounded to bf16
//   dK += dS^T Q                 wgmma, A from registers, B MN-major
// ptxas holds a consumer thread to 168 registers (hopper.cuh, setmaxnreg),
// and at D = 128 the dK and dV accumulators alone take 128: there each Q
// tile is taken in two halves of 32 queries.
constexpr int DKV_BN = 128;     // keys per block
constexpr int DKV_BM = 64;      // query rows per streamed tile
constexpr int DKV_STAGES = 3;   // Q/dO tiles in flight
constexpr int DKV_THREADS = 384;  // 2 consumer warpgroups, then the producer
constexpr int K_SLAB = DKV_BN * 128;  // bytes of a 64-column slab of K or V
constexpr int Q_SLAB = DKV_BM * 128;  // ... of Q or dO
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K and V, then DKV_STAGES x (Q, dO), each D / 64 slabs; 1024 bytes of
  // slack to align the base for the 128-byte swizzle
  return (size_t)(D / 64) * (2 * K_SLAB + 2 * DKV_STAGES * Q_SLAB) + 1024;
}

// P^T of one warpgroup's 64 keys x QN queries from S^T: P = exp(z - lse),
// z the capped, scaled (MASKED: and masked) score, rounded to bf16 into the
// A fragments `pa` of dV's product; s keeps P (1 - tanh^2), the factor dS
// takes from P and the cap (P without a cap; rows past S have tanh 0).
// Element i is (key key0 + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + c +
// (i & 1)); lse holds the lse of queries q0.., from the stage.
template <bool MASKED, int QN>
__device__ __forceinline__ void p_tile(float (&s)[QN / 2], uint32_t* pa,
                                       int key0, int q0, int c,
                                       const float* lse, const Params& p) {
  const float inv_cap = p.cap > 0.f ? p.scale / p.cap : 0.f;
#pragma unroll
  for (int kk = 0; kk < QN / 16; ++kk) {
    float t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      const int ql = 8 * (i >> 2) + c + (i & 1);
      float z;
      t[e] = 0.f;
      if (MASKED) {
        const int row = q0 + ql, col = key0 + 8 * ((i >> 1) & 1);
        z = row < p.S ? score(s[i], row, col, p, &t[e]) : NEG;
      } else if (p.cap > 0.f) {
        t[e] = tanhf(s[i] * inv_cap);
        z = p.cap * t[e];
      } else {
        z = s[i] * p.scale;
      }
      s[i] = exp2_approx(fmaf(z, LOG2E, -lse[ql] * LOG2E));
    }
    acc_to_a(pa + 4 * kk, s, kk);
    if (p.cap > 0.f) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s[8 * kk + e] *= 1.f - t[e] * t[e];
    }
  }
}

// dS^T = P (1 - tanh^2) (dP - delta) scale, from p_tile's s and dP^T, in
// place in dp; dl holds the delta of the same queries.
template <int QN>
__device__ __forceinline__ void ds_tile(const float (&s)[QN / 2],
                                        float (&dp)[QN / 2], int c,
                                        const float* dl, const Params& p) {
#pragma unroll
  for (int i = 0; i < QN / 2; ++i)
    dp[i] = s[i] * (dp[i] - dl[8 * (i >> 2) + c + (i & 1)]) * p.scale;
}

// One (query head, Q tile) step of a consumer warpgroup: its 64 keys x the
// tile's DKV_BM queries in parts of QN, each part skipped where no pair is
// visible. DV: dV += P^T dO; DK: dK += dS^T Q. K/V at k_addr/v_addr (this
// warpgroup's rows), the stage's Q/dO at q_addr/o_addr and its lse/delta.
template <int D, int QN, bool DV, bool DK>
__device__ __forceinline__ void dkv_step(float (&dv)[D / 2], float (&dk)[D / 2],
                                         uint32_t k_addr, uint32_t v_addr,
                                         uint32_t q_addr, uint32_t o_addr,
                                         const float* lse, const float* delta,
                                         int q0, int kw0, int key0, int c,
                                         const Params& p) {
#pragma unroll
  for (int h = 0; h < DKV_BM / QN; ++h) {
    const int qh = q0 + h * QN;
    if (!tile_live<QN, 64>(p, qh, kw0)) continue;
    const uint32_t qa = q_addr + h * QN * 128, oa = o_addr + h * QN * 128;
    // S^T = K Q^T: 64 keys x QN queries; then P^T
    float s[QN / 2], dp[QN / 2];
    uint32_t pa[QN / 4], sa[QN / 4];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * K_SLAB + (kk % 4) * 32;
      const uint32_t qoff = (kk / 4) * Q_SLAB + (kk % 4) * 32;
      wgmma_ss<QN>(s, desc_sw128(k_addr + off, 16, 1024),
                   desc_sw128(qa + qoff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (tile_unmasked<QN, 64>(p, qh, kw0))
      p_tile<false, QN>(s, pa, key0, qh, c, lse + h * QN, p);
    else
      p_tile<true, QN>(s, pa, key0, qh, c, lse + h * QN, p);
    if constexpr (DV) {
      // dV += P^T dO, P rounded to bf16 (the TPU kernels cast it to the
      // input dtype): QN / 16 k-steps of 16 queries = 2048 bytes of dO rows
      // each, dO MN-major
      fence_regs(dv);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        wgmma_rs<D>(dv, pa + 4 * kk, desc_sw128(oa + kk * 2048, Q_SLAB, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(pa);
    }
    if constexpr (DK) {
      // dP^T = V dO^T, dS^T, then dK += dS^T Q with dS rounded to bf16, Q
      // MN-major
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * K_SLAB + (kk % 4) * 32;
        const uint32_t qoff = (kk / 4) * Q_SLAB + (kk % 4) * 32;
        wgmma_ss<QN>(dp, desc_sw128(v_addr + off, 16, 1024),
                     desc_sw128(oa + qoff, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      ds_tile<QN>(s, dp, c, delta + h * QN, p);
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) acc_to_a(sa + 4 * kk, dp, kk);
      fence_regs(dk);
      fence_regs(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk)
        wgmma_rs<D>(dk, sa + 4 * kk, desc_sw128(qa + kk * 2048, Q_SLAB, 1024),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(sa);
    }
  }
}

// rows row0 and row0 + 8 of head hd of a BSHD bf16 tensor (dK, dV, dQ)
// from a thread's wgmma accumulator; rows past S are not stored
template <int D>
__device__ __forceinline__ void store_rows(void* base, long long sb,
                                           long long ss, long long sh, int b,
                                           int hd, int row0, int c,
                                           const float (&acc)[D / 2], int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < S) {
      bf16* out = static_cast<bf16*>(base) + b * sb + row * ss + hd * sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int NS = D / 64;  // slabs per tile
  // queries a product: ptxas holds the consumers to 168 registers a thread
  // (setmaxnreg does not raise its budget), so at D = 128, beside the 128 of
  // the dK and dV accumulators, a Q tile is taken in two halves
  constexpr int QN = D == 64 ? DKV_BM : DKV_BM / 2;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t kv_full, full[DKV_STAGES], empty[DKV_STAGES];
  __shared__ float LD[DKV_STAGES][2][DKV_BM];  // lse, delta
  unsigned char* Ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Vs = Ks + NS * K_SLAB;
  unsigned char* QO = Vs + NS * K_SLAB;  // stage s: Q at 2s, dO at 2s + 1

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * DKV_BN;  // causal: the longest loops first
  const int grp = p.H / p.KV;
  int qb_begin, qb_end;
  q_band<DKV_BM, DKV_BN>(p, k0, qb_begin, qb_end);
  const int nq = max(qb_end - qb_begin, 0);
  const int steps = grp * nq;  // (query head, Q tile) pairs, head-major
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 33);  // 32 lanes' cp.async + the TMA thread
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // -------------------------------------------- producer --
    regs_dealloc<40>();
    if (tid < 256 + 32) {
      const int lane = tid - 256;
      if (lane == 0) {
        mbar_arrive_tx(&kv_full, 2 * NS * K_SLAB);
        for (int s = 0; s < NS; ++s) {
          tma_load(Ks + s * K_SLAB, &map_k, &kv_full, 64 * s, kvh, k0, b);
          tma_load(Vs + s * K_SLAB, &map_v, &kv_full, 64 * s, kvh, k0, b);
        }
      }
      for (int it = 0; it < steps; ++it) {
        const int stage = it % DKV_STAGES;
        const int h = kvh * grp + it / nq, q0 = (qb_begin + it % nq) * DKV_BM;
        mbar_wait(&empty[stage], ((it / DKV_STAGES) & 1) ^ 1);
        const size_t row = ((size_t)b * p.H + h) * p.S + q0;
        for (int i = lane; i < DKV_BM; i += 32) {
          const bool ok = q0 + i < p.S;
          cp_async4(&LD[stage][0][i], p.lse + (ok ? row + i : 0), ok);
          cp_async4(&LD[stage][1][i], p.delta + (ok ? row + i : 0), ok);
        }
        mbar_arrive_cp_async(&full[stage]);
        if (lane == 0) {
          unsigned char* qs = QO + 2 * stage * NS * Q_SLAB;
          mbar_arrive_tx(&full[stage], 2 * NS * Q_SLAB);
          for (int s = 0; s < NS; ++s) {
            tma_load(qs + s * Q_SLAB, &map_q, &full[stage], 64 * s, h, q0, b);
            tma_load(qs + (NS + s) * Q_SLAB, &map_do, &full[stage], 64 * s,
                     h, q0, b);
          }
        }
      }
    }
  } else {  // ------------------------------------------------- consumers --
    regs_alloc<232>();
    const int w = wg, t = tid % 128;
    const int lane = t & 31, g = lane >> 2, c = (lane & 3) * 2;
    const int kw0 = k0 + 64 * w;               // this warpgroup's first key
    const int key0 = kw0 + 16 * (t >> 5) + g;  // this thread's keys: +0, +8
    const uint32_t k_addr = smem_u32(Ks) + w * 64 * 128;
    const uint32_t v_addr = smem_u32(Vs) + w * 64 * 128;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(&kv_full, 0);
    for (int it = 0; it < steps; ++it) {
      const int stage = it % DKV_STAGES;
      const int q0 = (qb_begin + it % nq) * DKV_BM;
      mbar_wait(&full[stage], (it / DKV_STAGES) & 1);
      const uint32_t q_addr = smem_u32(QO) + 2 * stage * NS * Q_SLAB;
      dkv_step<D, QN, true, true>(dv, dk, k_addr, v_addr, q_addr,
                                  q_addr + NS * Q_SLAB, LD[stage][0],
                                  LD[stage][1], q0, kw0, key0, c, p);
      mbar_arrive(&empty[stage]);
    }
    store_rows<D>(p.dv, p.dv_sb, p.dv_ss, p.dv_sh, b, kvh, key0, c, dv, p.S);
    store_rows<D>(p.dk, p.dk_sb, p.dk_ss, p.dk_sh, b, kvh, key0, c, dk, p.S);
  }
}

template <int D>
int launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (int e = hopper::encode_rows_map(&mq, p.q, p.B, p.S, p.H, D, p.q_sb,
                                      p.q_ss, p.q_sh, DKV_BM))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mk, p.k, p.B, p.S, p.KV, D, p.k_sb,
                                      p.k_ss, p.k_sh, DKV_BN))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mv, p.v, p.B, p.S, p.KV, D, p.v_sb,
                                      p.v_ss, p.v_sh, DKV_BN))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mo, p.dout, p.B, p.S, p.H, D, p.o_sb,
                                      p.o_ss, p.o_sh, DKV_BM))
    return TMA_ENCODE_ERROR + e;
  auto kernel = dkv_bf16_kernel<D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.KV, p.B, (p.S + DKV_BN - 1) / DKV_BN);
  kernel<<<grid, DKV_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- bf16 dQ --
// 384 threads: warpgroups 0 and 1 are the consumers, each owning 64 of the
// block's 128 query rows of one query head, warpgroup 2 the producer. The
// producer loads the Q and dO tiles once, then streams the in-band K/V
// tiles of KV head h / (H / KV) through a ring of DQ_STAGES stages (full
// barrier: the TMA bytes; empty barrier: the 256 consumer threads). lse and
// delta are per query row: each consumer thread reads its two rows once,
// before the loop. A consumer runs, for its 64 queries x a tile's 64 keys:
//   S = Q K^T, then dP = dO V^T   wgmma, A and B from shared memory,
//                                 K-major, each its own commit group
//   P [(1 - tanh^2)] scale        in registers, once S is in, while dP runs
//   dS = that (dP - delta)        in registers, rounded to bf16 (A fragments)
//   dQ += dS K                    wgmma, dS from registers, K MN-major
// At D = 64 the dQ product of one tile stays in flight while the next
// tile's S and dP are issued; the wait for S takes it too, and its stage is
// released then. Live in a consumer thread: S and dP 64 registers, dS's
// fragments 16, the dQ accumulator 32 (D = 64) or 64 (D = 128), of
// ptxas's 168. Measured on the H100 (PERF.md): one commit group for
// S and dP ran 0.129 ms at the slice shape, two 0.116; a ping-pong of the
// two warpgroups on named barriers 0.141; 8 stages in place of 4, or the
// dS math under the previous dQ product, no faster.
constexpr int DQ_BM = 128;        // query rows per block
constexpr int DQ_BN = 64;         // keys per K/V tile
constexpr int DQ_STAGES = 4;      // K/V tiles in flight
constexpr int DQ_THREADS = 384;   // 2 consumer warpgroups, then the producer
constexpr int DQ_QO_SLAB = DQ_BM * 128;  // bytes of a 64-column slab of Q or dO
constexpr int DQ_KV_SLAB = DQ_BN * 128;  // ... of K or V

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q and dO, then DQ_STAGES x (K, V), each D / 64 slabs; 1024 bytes of
  // slack to align the base for the 128-byte swizzle
  return (size_t)(D / 64) * (2 * DQ_QO_SLAB + 2 * DQ_STAGES * DQ_KV_SLAB) +
         1024;
}

// P of one warpgroup's 64 queries x DQ_BN keys, in place in s, times the
// factors dS takes besides dP - delta: P = exp(z - lse), z the capped,
// scaled (MASKED: and masked) score, then s = P [* (1 - tanh^2)] * scale.
// Element i is (query row0 + 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + c +
// (i & 1)); lse2 holds the two rows' lse times log2 e. A masked score
// (-1e30) gives P = 0 whatever the row's lse, so a row with no visible key
// gets dS = 0.
template <bool MASKED>
__device__ __forceinline__ void dq_p_tile(float (&s)[DQ_BN / 2], int row0,
                                          int k0, int c, const float* lse2,
                                          const Params& p) {
  const float sl = p.scale * LOG2E;
  const float inv_cap = p.cap > 0.f ? p.scale / p.cap : 0.f;
#pragma unroll
  for (int i = 0; i < DQ_BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float t = 0.f, e;
    if (MASKED) {
      const int row = row0 + 8 * r, col = k0 + 8 * (i >> 2) + c + (i & 1);
      const float z = row < p.S ? score(s[i], row, col, p, &t) : NEG;
      e = fmaf(z, LOG2E, -lse2[r]);
    } else if (p.cap > 0.f) {
      t = tanhf(s[i] * inv_cap);
      e = fmaf(p.cap * t, LOG2E, -lse2[r]);
    } else {
      e = fmaf(s[i], sl, -lse2[r]);
    }
    s[i] = exp2_approx(e) * (p.cap > 0.f ? (1.f - t * t) * p.scale : p.scale);
  }
}

// acc = A B^T over one tile, one commit group, not waited for: A the
// warpgroup's 64 rows of Q or dO at a_addr, B a tile's DQ_BN rows of K or V
// at b_addr, both K-major; D / 16 k-steps of 32 bytes inside a slab (S =
// Q K^T, dP = dO V^T).
template <int D>
__device__ __forceinline__ void dq_ss_product(float (&acc)[DQ_BN / 2],
                                              uint32_t a_addr,
                                              uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t aoff = (kk / 4) * DQ_QO_SLAB + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * DQ_KV_SLAB + (kk % 4) * 32;
    wgmma_ss<DQ_BN>(acc, desc_sw128(a_addr + aoff, 16, 1024),
                    desc_sw128(b_addr + boff, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// dQ += dS K over one tile: DQ_BN / 16 k-steps of 16 keys = 2048 bytes of
// K rows each, K MN-major (the second 64-column slab at D = 128 one slab
// on); committed as one group, not waited for.
template <int D>
__device__ __forceinline__ void dq_product(float (&dq)[D / 2],
                                           const uint32_t (&dsa)[DQ_BN / 4],
                                           uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DQ_BN / 16; ++kk)
    wgmma_rs<D>(dq, dsa + 4 * kk, desc_sw128(k_addr + kk * 2048, DQ_KV_SLAB,
                                             1024),
                1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const __grid_constant__ CUtensorMap map_do, const Params p) {
  constexpr int NS = D / 64;  // slabs per tile
  // D = 128 waits for each dQ product at once: with it in flight beside S,
  // dP and the 64 dQ accumulators, ptxas serializes every wgmma (C7512)
  constexpr bool OVERLAP = D == 64;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qo_full, full[DQ_STAGES], empty[DQ_STAGES];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Os = Qs + NS * DQ_QO_SLAB;
  unsigned char* KV = Os + NS * DQ_QO_SLAB;  // stage s: K at 2s, V at 2s + 1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BM;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  int kb_begin, kb_end;
  band<DQ_BM, DQ_BN>(p, q0, kb_begin, kb_end);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&qo_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // -------------------------------------------- producer --
    regs_dealloc<40>();
    if (tid == 256) {
      mbar_arrive_tx(&qo_full, 2 * NS * DQ_QO_SLAB);
      for (int s = 0; s < NS; ++s) {
        tma_load(Qs + s * DQ_QO_SLAB, &map_q, &qo_full, 64 * s, h, q0, b);
        tma_load(Os + s * DQ_QO_SLAB, &map_do, &qo_full, 64 * s, h, q0, b);
      }
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        const int i = kb - kb_begin, stage = i % DQ_STAGES;
        mbar_wait(&empty[stage], ((i / DQ_STAGES) & 1) ^ 1);
        unsigned char* ks = KV + 2 * stage * NS * DQ_KV_SLAB;
        mbar_arrive_tx(&full[stage], 2 * NS * DQ_KV_SLAB);
        for (int s = 0; s < NS; ++s) {
          tma_load(ks + s * DQ_KV_SLAB, &map_k, &full[stage], 64 * s, kvh,
                   kb * DQ_BN, b);
          tma_load(ks + (NS + s) * DQ_KV_SLAB, &map_v, &full[stage], 64 * s,
                   kvh, kb * DQ_BN, b);
        }
      }
    }
  } else {  // ------------------------------------------------- consumers --
    regs_alloc<232>();
    const int w = wg, t = tid % 128;
    const int lane = t & 31, g = lane >> 2, c = (lane & 3) * 2;
    const int r0 = q0 + 64 * w;               // this warpgroup's first row
    const int row0 = r0 + 16 * (t >> 5) + g;  // this thread's rows: +0, +8
    const uint32_t q_addr = smem_u32(Qs) + w * 64 * 128;
    const uint32_t o_addr = smem_u32(Os) + w * 64 * 128;
    const uint32_t kv_addr = smem_u32(KV);
    float lse2[2], dl[2];  // rows past S: never stored, masked in dS
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < p.S;
      lse2[r] = ok ? p.lse[lse_index(p, b, h, row)] * LOG2E : 0.f;
      dl[r] = ok ? p.delta[lse_index(p, b, h, row)] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    uint32_t dsa[DQ_BN / 4];  // dS rounded to bf16: dQ's A fragments
    int pending = -1;         // the stage whose dQ product is in flight
    mbar_wait(&qo_full, 0);

    for (int kb = kb_begin; kb < kb_end; ++kb) {
      const int i = kb - kb_begin, stage = i % DQ_STAGES;
      const int k0 = kb * DQ_BN;
      mbar_wait(&full[stage], (i / DQ_STAGES) & 1);
      if (!tile_live<64, DQ_BN>(p, r0, k0)) {
        mbar_arrive(&empty[stage]);
        continue;
      }
      const uint32_t k_addr = kv_addr + 2 * stage * NS * DQ_KV_SLAB;  // V next
      // S = Q K^T, then dP = dO V^T, each its own commit group: P is
      // computed while dP is on the tensor cores
      float s[DQ_BN / 2], dp[DQ_BN / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      dq_ss_product<D>(s, q_addr, k_addr);
      dq_ss_product<D>(dp, o_addr, k_addr + NS * DQ_KV_SLAB);
      wgmma_wait<1>();  // S, and the previous tile's dQ product
      fence_regs(s);
      fence_regs(dq);
      fence_regs(dsa);
      if (pending >= 0) mbar_arrive(&empty[pending]);
      if (tile_unmasked<64, DQ_BN>(p, r0, k0))
        dq_p_tile<false>(s, row0, k0, c, lse2, p);
      else
        dq_p_tile<true>(s, row0, k0, c, lse2, p);
      wgmma_wait<0>();  // dP
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < DQ_BN / 2; ++e)
        dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]);
      // dQ += dS K, dS rounded to bf16 (the TPU kernel casts it to the
      // input dtype); left in flight at D = 64
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk) acc_to_a(dsa + 4 * kk, dp, kk);
      fence_regs(dq);
      fence_regs(dsa);
      wgmma_fence();
      dq_product<D>(dq, dsa, k_addr);
      if constexpr (OVERLAP) {
        pending = stage;
      } else {
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);
        mbar_arrive(&empty[stage]);
      }
    }
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dsa);
    if (pending >= 0) mbar_arrive(&empty[pending]);
    store_rows<D>(p.dq, p.dq_sb, p.dq_ss, p.dq_sh, b, h, row0, c, dq, p.S);
  }
}

template <int D>
int launch_dq_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (int e = hopper::encode_rows_map(&mq, p.q, p.B, p.S, p.H, D, p.q_sb,
                                      p.q_ss, p.q_sh, DQ_BM))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mk, p.k, p.B, p.S, p.KV, D, p.k_sb,
                                      p.k_ss, p.k_sh, DQ_BN))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mv, p.v, p.B, p.S, p.KV, D, p.v_sb,
                                      p.v_ss, p.v_sh, DQ_BN))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mo, p.dout, p.B, p.S, p.H, D, p.o_sb,
                                      p.o_ss, p.o_sh, DQ_BM))
    return TMA_ENCODE_ERROR + e;
  auto kernel = dq_bf16_kernel<D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, p.B, (p.S + DQ_BM - 1) / DQ_BM);
  kernel<<<grid, DQ_THREADS, smem, stream>>>(mq, mk, mv, mo, p);
  return (int)cudaGetLastError();
}

int check(const Params& p, int D, int dtype) {
  if (p.H <= 0 || p.KV <= 0 || p.H % p.KV != 0 || p.B <= 0 || p.S <= 0 ||
      (D != 64 && D != 128) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return 0;
}

void set_common(Params& p, const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, int B,
                int S, int H, int KV, const long long* st, int causal,
                int window, float scale, float logit_cap) {
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B; p.S = S; p.H = H; p.KV = KV;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.causal = causal; p.window = window; p.scale = scale; p.cap = logit_cap;
}

}  // namespace

// Plain C entry points, bound with ctypes (tfde_tpu_torch/ops/flash_attention.py).
// dtype: 0 = float32, 1 = bfloat16; q/k/v/dO and the outputs share it.
// lse and delta are [B, H, S] fp32, contiguous. window <= 0 and
// logit_cap <= 0 mean off. Strides are in elements; the head dim is
// contiguous; for bf16 every pointer is 16-byte aligned and every stride a
// multiple of 8 (the tensor maps' 16-byte rule). Each returns the CUDA
// error of its launch (0 on success), or TMA_ENCODE_ERROR + the CUresult of
// a tensor map the CUDA driver refused; the launch does not synchronise.

// dK, dV [B, S, KV, D]: grid (ceil(S / 64), KV, B) for fp32, (KV, B,
// ceil(S / 128)) for bf16.
extern "C" int tfde_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int B, int S, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int causal, int window, float scale, float logit_cap, int dtype,
    void* stream) {
  Params p = {};
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  set_common(p, q, k, v, dout, lse, delta, B, S, H, KV, st, causal, window,
             scale, logit_cap);
  p.dk = dk; p.dv = dv;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  if (int err = check(p, D, dtype)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + BN - 1) / BN, KV, B);
  if (dtype == 0 && D == 64)
    return (int)launch(dkv_fp32_kernel<64>, grid, F_THREADS,
                       dkv_fp32_smem_bytes<64>(), p, s);
  if (dtype == 0)
    return (int)launch(dkv_fp32_kernel<128>, grid, F_THREADS,
                       dkv_fp32_smem_bytes<128>(), p, s);
  if (D == 64) return launch_dkv_bf16<64>(p, s);
  return launch_dkv_bf16<128>(p, s);
}

// dQ [B, S, H, D]: grid (ceil(S / 64), H, B) for fp32, (H, B,
// ceil(S / 128)) for bf16.
extern "C" int tfde_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int B, int S, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    int causal, int window, float scale, float logit_cap, int dtype,
    void* stream) {
  Params p = {};
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  set_common(p, q, k, v, dout, lse, delta, B, S, H, KV, st, causal, window,
             scale, logit_cap);
  p.dq = dq;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  if (int err = check(p, D, dtype)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + BM - 1) / BM, H, B);
  if (dtype == 0 && D == 64)
    return (int)launch(dq_fp32_kernel<64>, grid, F_THREADS,
                       dq_fp32_smem_bytes<64>(), p, s);
  if (dtype == 0)
    return (int)launch(dq_fp32_kernel<128>, grid, F_THREADS,
                       dq_fp32_smem_bytes<128>(), p, s);
  if (D == 64) return launch_dq_bf16<64>(p, s);
  return launch_dq_bf16<128>(p, s);
}
