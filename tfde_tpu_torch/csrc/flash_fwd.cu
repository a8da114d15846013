// Flash-attention forward for Hopper (sm_90a): softmax(cap(Q K^T * scale)) V
// with an online softmax, plus the per-row logsumexp.
//
// Replaces: tfde_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel launched by _flash_forward). Same function, same options: causal,
// sliding `window` (rows - cols < window, causal only), `scale` (default
// 1/sqrt(D), applied by the caller's argument), tanh `logit_cap` applied
// BEFORE the mask, GQA by reading K/V head h / (H / KV) with no expanded
// copy, the -1e30 mask value, P cast to the input dtype before the P V
// product, and lse = m + log(max(l, 1e-20)).
//
// What differs from the TPU kernel:
// - The TPU grid (B, H, S/bq, S/bk) runs in order and carries acc/m/l in
//   VMEM scratch across the K steps. Here one thread block owns one
//   (q-tile, head, batch) and loops over the K tiles itself, from the first
//   to the last IN-BAND tile (the _tile_in_band predicate, turned into loop
//   bounds), so the causal and window skips cost nothing.
// - q/k/v/out are read and written in the caller's BSHD layout through
//   element strides (the head dim must be contiguous); no transpose.
// - S need not divide the tile: the ragged edge is masked (rows past S are
//   never stored, columns past S are masked like the causal triangle).
// - Two kernels behind one entry point, by input dtype: bf16 runs both
//   products on the tensor cores (wgmma, fp32 accumulation); fp32 runs
//   them in fp32 FMA on the CUDA cores, because TF32 tensor-core products
//   would round the inputs to 10 mantissa bits. head_dim 64, 128 or 256.
//
// Bound on the H100: at the slice's shape (8 x 1024 tokens, 12 heads,
// D = 64, bf16, causal) the call moves ~50.7 MB of q/k/v/out/lse (~15 us
// at 3.35 TB/s) and does ~1.29e10 FLOP (~13 us at 989 TFLOP/s on the
// tensor cores): memory-bound at ~15 us, with the math close behind, so
// the kernel has to keep the tensor cores fed from shared memory while
// the copies run. The bf16 design, for Hopper:
// - wgmma for both products (the only path to the tensor cores' full
//   rate): S = Q K^T with Q and K in shared memory, O += P V with P in
//   registers (the accumulator fragment rounded to bf16, no trip through
//   shared memory) and V in shared memory, MN-major;
// - 128-row Q tiles, two consumer warpgroups of 64 rows, so every K/V tile
//   fetched serves 128 rows (half the re-reads of 64-row tiles);
// - a producer warpgroup whose one thread keeps TMA loads of the K/V tiles
//   in flight through an mbarrier ring: no address math or copy
//   instructions on the math threads; the tensor maps zero-fill rows past
//   S, so the loads need no edge predicates;
// - a mask-free path for tiles whose every pair is visible (all but the
//   diagonal, window-edge and ragged-edge tiles of a causal row), and
//   warpgroup blocks with no visible pair skipped;
// - the longest causal rows launch first, so the short ones fill the tail;
// - at D = 256 (Gemma, Gemma-2, GPT-J, Pythia-1B) a 64-row O accumulator
//   alone takes 128 of a consumer thread's 168 registers: the block owns 64
//   rows and its two consumer warpgroups split O by columns (FwdTile).
// Left for later: overlapping one warpgroup's softmax with the next
// product (FA3's ping-pong and intra-warpgroup overlap), and fp8.

#include <time.h>

#include "flash_common.cuh"  // band, tile predicates, score, hopper.cuh

namespace {

using namespace flash;
using namespace hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  int B, S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale, cap;
};

// ---------------------------------------------------------------- fp32 --
// 256 threads. Thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// ty*4 .. ty*4+3 in every phase, so the running max m, sum l and the
// output accumulators of a row stay in the registers of the 16 lanes of
// one half-warp. In the score tile it owns columns tx + 16 j; in the
// output, columns tx + 16 jj.
constexpr int F_THREADS = 256;
constexpr int RPT = 4;  // rows per thread (BM / 16)
constexpr int CPT = 4;  // score columns per thread (BN / 16)

template <int D>
constexpr size_t fp32_smem_bytes() {
  // Q and K rows padded by one float (conflict-free column reads), V
  // unpadded (row reads), P padded by four (the two half-warps of a warp
  // write rows 4 apart into disjoint banks).
  return sizeof(float) * ((size_t)BM * (D + 1) + (size_t)BN * (D + 1) +
                          (size_t)BN * D + (size_t)BM * (BN + 4));
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
flash_fwd_fp32_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int QP = D + 1;
  constexpr int VP = D;
  constexpr int PP = BN + 4;
  constexpr int OPT = D / 16;  // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BM * QP;
  float* Vs = Ks + BN * QP;
  float* Ps = Vs + BN * VP;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BM;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < BM * D; i += F_THREADS) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[r * QP + d] = row < p.S ? qg[row * p.q_ss + d] : 0.f;
  }
  int kb_begin, kb_end;
  band(p, q0, kb_begin, kb_end);

  float m[RPT], l[RPT], acc[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < OPT; ++jj) acc[i][jj] = 0.f;
  }

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BN;
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < BN * D; i += F_THREADS) {
      const int r = i / D, d = i % D, col = k0 + r;
      const bool ok = col < p.S;
      Ks[r * QP + d] = ok ? kg[col * p.k_ss + d] : 0.f;
      Vs[r * VP + d] = ok ? vg[col * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * QP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = score(s[i][j], row, k0 + tx + 16 * j, p);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float pj = expf(s[i][j] - m_new);
        Ps[(ty * RPT + i) * PP + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) acc[i][jj] *= corr;
    }
    // P rows of this row group were written by the same half-warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * PP + c];
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) {
        const float vv = Vs[c * VP + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < p.S) {
      const float ll = fmaxf(l[i], 1e-20f);
      float* og = static_cast<float*>(p.out) + b * p.o_sb + row * p.o_ss +
                  h * p.o_sh;
#pragma unroll
      for (int jj = 0; jj < OPT; ++jj) og[tx + 16 * jj] = acc[i][jj] / ll;
      if (tx == 0)
        p.lse[((long long)b * p.H + h) * p.S + row] = m[i] + logf(ll);
    }
  }
}

// ---------------------------------------------------------------- bf16 --
// 384 threads: warpgroups 0 and 1 are the consumers, each owning 64 of the
// block's 128 query rows (D 64/128), warpgroup 2 the producer (one thread
// issues every TMA load). The producer loads the Q tile once and streams the
// in-band K/V tiles through a ring of STAGES stages (full barrier:
// the TMA bytes; empty barrier: all 256 consumer threads). A consumer runs
// S = Q K^T as a wgmma from shared memory (both K-major), the online
// softmax on the accumulator fragment (the four lanes of a quad hold a
// row's columns), then O += P V as a wgmma with P rounded to bf16 in
// registers and V from shared memory, MN-major. A consumer thread has 168
// registers (hopper.cuh, setmaxnreg): at D 64/128 S takes 64, O 32 (D = 64)
// or 64 (D = 128), P's fragments 32.
//
// At D = 256 a 64 x 256 O accumulator would take 128 registers beside S and
// P, and one 128-row Q tile with a 128-key K/V stage would not fit shared
// memory (64 KB + 128 KB a stage). So the block owns 64 query rows and the
// two consumer warpgroups split O by columns: each runs the same S = Q K^T
// over the whole D and the same softmax (the same values, so the same m and
// l), then O[:, 128 w .. 128 w + 127] += P V[:, 128 w ..]. That costs one
// extra Q K^T a tile (1.5x the tensor-core work) and keeps a consumer at S
// 32, O 64 and P 16 registers; K/V tiles of 64 keys, two stages (Q 32 KB +
// 2 x 64 KB of K/V).
constexpr int FWD_THREADS = 384;  // 2 consumer warpgroups, then the producer
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct FwdTile {
  static constexpr bool SPLIT = D == 256;       // O split by columns
  static constexpr int BM = SPLIT ? 64 : 128;   // query rows per block
  static constexpr int BN = SPLIT ? 64 : 128;   // key columns per K/V tile
  static constexpr int STAGES = SPLIT ? 2 : 3;  // K/V tiles in flight
  static constexpr int DO = SPLIT ? D / 2 : D;  // O columns a warpgroup
  static constexpr int QSLAB = BM * 128;  // a 64-column slab of Q, bytes
  static constexpr int KSLAB = BN * 128;  // ... of K or V
};

template <int D>
constexpr size_t bf16_smem_bytes() {
  // the Q tile and STAGES x (K, V), each D / 64 slabs; 1024 bytes of
  // slack to align the base for the 128-byte swizzle
  using T = FwdTile<D>;
  return (size_t)(D / 64) * (T::QSLAB + 2 * T::STAGES * T::KSLAB) + 1024;
}

// Scale, cap and (MASKED) mask one warpgroup's 64 x BN score tile in
// place, then turn it into P = exp(z - m) with the running max m, sum l
// (this thread's partial: its quad's four partials add up at the end) and
// the rescaling of the warpgroup's DO output columns.
template <bool MASKED, int BN, int DO>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2],
                                             float (&o)[DO / 2], float* m,
                                             float* l, int row0, int k0,
                                             int c, const Params& p) {
  // mask-free without a cap: s stays the raw dot product, and the scale
  // (positive) goes into the row max and the exponent
  const bool raw = !MASKED && p.cap <= 0.f && p.scale > 0.f;
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = score(s[i], row0 + 8 * ((i >> 1) & 1),
                   k0 + 8 * (i >> 2) + c + (i & 1), p);
  } else if (p.cap > 0.f) {
    const float inv = p.scale / p.cap;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = p.cap * tanhf(s[i] * inv);
  } else if (!raw) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= p.scale;
  }
  const float zs = raw ? p.scale : 1.f;  // score = zs * s
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float corr[2], ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * zs);
    corr[r] = exp2_approx((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    // a row with every score so far masked (m = NEG): subtract 0, so its
    // masked scores give exp(NEG) = 0, not exp of fmaf's rounding error
    ml[r] = m_new == NEG ? 0.f : m_new * LOG2E;
    l[r] *= corr[r];
  }
  const float sl = zs * LOG2E;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], sl, -ml[r]));
    l[r] += s[i];
  }
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const Params p) {
  using T = FwdTile<D>;
  constexpr int BN = T::BN, STAGES = T::STAGES, DO = T::DO;
  constexpr int NS = D / 64;  // slabs per tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t q_full, kv_full[STAGES], kv_empty[STAGES];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* KV = Qs + NS * T::QSLAB;  // stage s: K at 2s, V at 2s + 1

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::BM;  // longest rows first
  const int kvh = h / (p.H / p.KV);
  int kb_begin, kb_end;
  band<T::BM, BN>(p, q0, kb_begin, kb_end);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // -------------------------------------------- producer --
    regs_dealloc<40>();
    if (tid == 256) {
      mbar_arrive_tx(&q_full, NS * T::QSLAB);
      for (int s = 0; s < NS; ++s)
        tma_load(Qs + s * T::QSLAB, &map_q, &q_full, 64 * s, h, q0, b);
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        const int i = kb - kb_begin, stage = i % STAGES;
        mbar_wait(&kv_empty[stage], ((i / STAGES) & 1) ^ 1);
        unsigned char* ks = KV + 2 * stage * NS * T::KSLAB;
        mbar_arrive_tx(&kv_full[stage], 2 * NS * T::KSLAB);
        for (int s = 0; s < NS; ++s) {
          tma_load(ks + s * T::KSLAB, &map_k, &kv_full[stage], 64 * s, kvh,
                   kb * BN, b);
          tma_load(ks + (NS + s) * T::KSLAB, &map_v, &kv_full[stage], 64 * s,
                   kvh, kb * BN, b);
        }
      }
    }
  } else {  // ------------------------------------------------- consumers --
    regs_alloc<232>();
    const int w = wg, t = tid % 128;
    const int lane = t & 31, g = lane >> 2, c = (lane & 3) * 2;
    // D 64/128: warpgroup w owns rows 64 w.. and every column; D 256: both
    // own the block's 64 rows, warpgroup w the O columns of slabs 2w, 2w + 1
    const int r0 = q0 + (T::SPLIT ? 0 : 64 * w);  // this warpgroup's first row
    const int row0 = r0 + 16 * (t >> 5) + g;  // this thread's rows: +0, +8
    const int cs = T::SPLIT ? 2 * w : 0;       // its first O column slab
    const uint32_t q_addr = smem_u32(Qs) + (T::SPLIT ? 0 : w * 64 * 128);
    float o[DO / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DO / 2; ++i) o[i] = 0.f;
    mbar_wait(&q_full, 0);

    // D = 64 and 256: P V of one tile runs on the tensor cores while Q K^T
    // of the next is issued; the wait for both comes before the softmax,
    // and the stage of the pending P V is released after it. D = 128 waits
    // for P V at once: S, O and P together (160 registers) leave ptxas too
    // few to keep both products in flight, and it serializes every wgmma.
    uint32_t pa[BN / 4];
    int pending = -1;  // the stage whose P V is in flight
    for (int kb = kb_begin; kb < kb_end; ++kb) {
      const int i = kb - kb_begin, stage = i % STAGES;
      const int k0 = kb * BN;
      mbar_wait(&kv_full[stage], (i / STAGES) & 1);
      if (!tile_live<64, BN>(p, r0, k0)) {
        mbar_arrive(&kv_empty[stage]);
        continue;
      }
      const uint32_t k_addr = smem_u32(KV) + 2 * stage * NS * T::KSLAB;
      const uint32_t v_addr = k_addr + NS * T::KSLAB;
      // S = Q K^T: 64 x BN, D / 16 k-steps of 32 bytes inside a slab
      float s[BN / 2];
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t in = (kk % 4) * 32;
        wgmma_ss<BN>(s, desc_sw128(q_addr + (kk / 4) * T::QSLAB + in, 16, 1024),
                     desc_sw128(k_addr + (kk / 4) * T::KSLAB + in, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(o);
      fence_regs(pa);
      if (pending >= 0) mbar_arrive(&kv_empty[pending]);
      if (tile_unmasked<64, BN>(p, r0, k0))
        softmax_tile<false, BN, DO>(s, o, m, l, row0, k0, c, p);
      else
        softmax_tile<true, BN, DO>(s, o, m, l, row0, k0, c, p);
      // O += P V: P rounded to bf16 (the TPU kernel casts p to v's dtype),
      // BN / 16 k-steps of 16 keys = 2048 bytes of V rows each
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa + 4 * kk, s, kk);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs<DO>(o, pa + 4 * kk,
                     desc_sw128(v_addr + cs * T::KSLAB + kk * 2048, T::KSLAB,
                                1024),
                     1);
      }
      wgmma_commit();
      if constexpr (D == 128) {  // no room for S, O and P at once
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(&kv_empty[stage]);
      } else {
        pending = stage;
      }
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (pending >= 0) mbar_arrive(&kv_empty[pending]);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row < p.S) {
        const float ll = fmaxf(l[r], 1e-20f), inv = 1.f / ll;
        __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) +
                            b * p.o_sb + row * p.o_ss + h * p.o_sh + 64 * cs;
#pragma unroll
        for (int j = 0; j < DO / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(og + 8 * j + c) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                    o[4 * j + 2 * r + 1] * inv);
        if ((lane & 3) == 0 && (!T::SPLIT || w == 0))  // once a row
          p.lse[((long long)b * p.H + h) * p.S + row] = m[r] + logf(ll);
      }
    }
  }
}

template <int D>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = FwdTile<D>;
  CUtensorMap mq, mk, mv;
  if (int e = hopper::encode_rows_map(&mq, p.q, p.B, p.S, p.H, D, p.q_sb,
                                      p.q_ss, p.q_sh, T::BM))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mk, p.k, p.B, p.S, p.KV, D, p.k_sb,
                                      p.k_ss, p.k_sh, T::BN))
    return TMA_ENCODE_ERROR + e;
  if (int e = hopper::encode_rows_map(&mv, p.v, p.B, p.S, p.KV, D, p.v_sb,
                                      p.v_ss, p.v_sh, T::BN))
    return TMA_ENCODE_ERROR + e;
  auto kernel = flash_fwd_bf16_kernel<D>;
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, p.B, (p.S + T::BM - 1) / T::BM);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

dim3 fwd_grid(const Params& p) { return dim3((p.S + BM - 1) / BM, p.H, p.B); }

}  // namespace

// Plain C entry point, bound with ctypes (tfde_tpu_torch/ops/flash_attention.py).
// dtype: 0 = float32, 1 = bfloat16. window <= 0 and logit_cap <= 0 mean off.
// Strides are in elements; the head dim is contiguous; for bf16 every
// pointer is 16-byte aligned and every stride a multiple of 8 (the tensor
// maps' 16-byte rule). Returns the CUDA error of the launch (0 on success),
// or TMA_ENCODE_ERROR + the CUresult of a tensor map the CUDA driver refused;
// the launch does not synchronise.
extern "C" int tfde_flash_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int S, int H, int KV, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, float logit_cap, int dtype,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = static_cast<float*>(lse);
  p.B = B; p.S = S; p.H = H; p.KV = KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.scale = scale; p.cap = logit_cap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H <= 0 || KV <= 0 || H % KV != 0 || B <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return (int)launch(flash_fwd_fp32_kernel<64>, fwd_grid(p), F_THREADS,
                       fp32_smem_bytes<64>(), p, st);
  if (dtype == 0 && D == 128)
    return (int)launch(flash_fwd_fp32_kernel<128>, fwd_grid(p), F_THREADS,
                       fp32_smem_bytes<128>(), p, st);
  if (dtype == 0 && D == 256)
    return (int)launch(flash_fwd_fp32_kernel<256>, fwd_grid(p), F_THREADS,
                       fp32_smem_bytes<256>(), p, st);
  if (dtype == 1 && D == 64) return launch_bf16<64>(p, st);
  if (dtype == 1 && D == 128) return launch_bf16<128>(p, st);
  if (dtype == 1 && D == 256) return launch_bf16<256>(p, st);
  return (int)cudaErrorInvalidValue;
}

// Mean host time of one tensor-map encode, in nanoseconds, over `reps`
// encodes of a map like the forward's Q map over `base` (a 16-byte aligned
// device pointer of at least 8 x 1024 x 12 x 64 bf16): what each launch of
// the bf16 kernels spends per map before it starts.
extern "C" int tfde_flash_tma_encode_ns(const void* base, int reps) {
  CUtensorMap map;
  timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  for (int i = 0; i < reps; ++i)
    hopper::encode_rows_map(&map, base, 8, 1024, 12, 64, 1024 * 12 * 64,
                            12 * 64, 64, FwdTile<64>::BM);
  clock_gettime(CLOCK_MONOTONIC, &t1);
  const double ns =
      (t1.tv_sec - t0.tv_sec) * 1e9 + (double)(t1.tv_nsec - t0.tv_nsec);
  return (int)(ns / (reps > 0 ? reps : 1));
}
