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
//   products on the tensor cores (mma.sync m16n8k16, fp32 accumulation);
//   fp32 runs them in fp32 FMA on the CUDA cores, because TF32 tensor-core
//   products would round the inputs to 10 mantissa bits. head_dim 64 or 128.
//
// Bound on the H100: at the serving slice's shape (8 x 1024 tokens, 12
// heads, D = 64, bf16, causal) the call moves ~50.7 MB of q/k/v/out/lse
// (~15 us at 3.35 TB/s) and does ~1.29e10 FLOP (~13 us at 989 TFLOP/s on
// the tensor cores): memory-bound at ~15 us, with the math close behind.
// What the design does about the bytes: every K/V tile is read from device
// memory once per q-tile and reused by 64 query rows from shared memory,
// the next tile's copy (cp.async, two stages) overlapping this tile's
// math; the score tile never leaves the registers; out-of-band tiles are
// neither loaded nor computed. What it does not do yet: wgmma, TMA, warp
// specialisation, 128-row tiles (half the K/V re-reads) or a mask-free
// path for the tiles below the diagonal — it reaches about a quarter of
// SDPA's speed on the card (PERF.md).

#include "flash_common.cuh"  // tiles, band, score, mma.sync/ldmatrix/cp.async

namespace {

using namespace flash;

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
// 128 threads = 4 warps; warp w owns query rows 16w .. 16w+15 of the tile.
// With the mma.sync fragment layout of flash_common.cuh (g = lane / 4,
// c = 2 * (lane % 4)) a thread holds score rows g and g+8, and two
// adjacent 8-column score tiles form the A fragment of the P V product
// without leaving registers (`mma_cb`).
// K and V are staged row-major by cp.async into two stages, so the copy of
// the next K/V tile runs while this one is computed. For Q K^T,
// B[k][n] = K[n][k] is a contiguous pair of a K row; for P V,
// B[k][n] = V[k][n] comes transposed out of ldmatrix.trans.
constexpr int M_THREADS = 128;

template <int D>
constexpr size_t bf16_smem_bytes() {
  // Q plus two stages of K and V; rows padded by 8 bf16 (16 bytes), so
  // the 8 rows one fragment load or ldmatrix touches fall in distinct
  // banks and every row stays 16-byte aligned
  return sizeof(__nv_bfloat16) * (size_t)(BM + 4 * BN) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(M_THREADS)
flash_fwd_bf16_kernel(const Params p) {
  constexpr int KP = D + 8;  // row pitch of every staged tile
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KV = Qs + BM * KP;  // stage s: K at 2s, V at 2s + 1

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int q0 = blockIdx.x * BM;
  const int wr = warp * 16;
  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int kb_begin, kb_end;
  band(p, q0, kb_begin, kb_end);
  // one commit group per K/V tile; rows past S are zero-filled
  auto load_tile = [&](int kb, int stage) {
    __nv_bfloat16* ks = KV + 2 * stage * BN * KP;
    __nv_bfloat16* vs = ks + BN * KP;
    for (int i = tid; i < BN * CH; i += M_THREADS) {
      const int r = i / CH, ch = i % CH, col = kb * BN + r;
      const bool ok = col < p.S;
      const long long row = ok ? col : 0;
      cp_async16(ks + r * KP + ch * 8, kg + row * p.k_ss + ch * 8, ok);
      cp_async16(vs + r * KP + ch * 8, vg + row * p.v_ss + ch * 8, ok);
    }
    cp_async_commit();
  };
  if (kb_begin < kb_end) load_tile(kb_begin, 0);

  for (int i = tid; i < BM * CH; i += M_THREADS) {
    const int r = i / CH, ch = i % CH, row = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * KP + ch * 8) =
        row < p.S ? *reinterpret_cast<const uint4*>(qg + row * p.q_ss + ch * 8)
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + g) * KP + kk * 16 + c;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * KP);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * KP + 8);
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int t = 0; t < D / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int stage = (kb - kb_begin) & 1;
    // the next tile's copy goes into the stage the previous iteration
    // finished reading (the __syncthreads at the end of the loop)
    if (kb + 1 < kb_end) {
      load_tile(kb + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = KV + 2 * stage * BN * KP;
    const __nv_bfloat16* vs = ks + BN * KP;
    const int k0 = kb * BN;

    // S = Q K^T for this warp's 16 rows x 64 keys: 8 tiles of 16 x 8
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * KP + kk * 16 + c;
        mma_16816(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3); the four
    // lanes of a quad hold one row's 64 columns
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + wr + g + (e >> 1) * 8;
        s[j][e] = score(s[j][e], row, k0 + j * 8 + c + (e & 1), p);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int t = 0; t < D / 8; ++t) {
      o[t][0] *= corr[0];
      o[t][1] *= corr[0];
      o[t][2] *= corr[1];
      o[t][3] *= corr[1];
    }

    // O += P V: P (rounded to bf16, as the TPU kernel casts p to v's
    // dtype) straight from the score registers; V fragments for two
    // 8-dim output tiles per ldmatrix
    mma_cb<D>(o, s, vs, KP, lane);
    __syncthreads();  // this stage is free for the copy after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row < p.S) {
      const float ll = fmaxf(l[r], 1e-20f);
      __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.out) + b * p.o_sb +
                          row * p.o_ss + h * p.o_sh;
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        *reinterpret_cast<__nv_bfloat162*>(og + t * 8 + c) =
            __floats2bfloat162_rn(o[t][2 * r] / ll, o[t][2 * r + 1] / ll);
      if ((lane & 3) == 0)
        p.lse[((long long)b * p.H + h) * p.S + row] = m[r] + logf(ll);
    }
  }
}

dim3 fwd_grid(const Params& p) { return dim3((p.S + BM - 1) / BM, p.H, p.B); }

}  // namespace

// Plain C entry point, bound with ctypes (tfde_tpu_torch/ops/flash_attention.py).
// dtype: 0 = float32, 1 = bfloat16. window <= 0 and logit_cap <= 0 mean off.
// Strides are in elements; the head dim is contiguous; for bf16 every
// pointer is 16-byte aligned and every stride a multiple of 8. Returns the
// CUDA error of the launch (0 on success); the launch does not synchronise.
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
  if (dtype == 1 && D == 64)
    return (int)launch(flash_fwd_bf16_kernel<64>, fwd_grid(p), M_THREADS,
                       bf16_smem_bytes<64>(), p, st);
  if (dtype == 1 && D == 128)
    return (int)launch(flash_fwd_bf16_kernel<128>, fwd_grid(p), M_THREADS,
                       bf16_smem_bytes<128>(), p, st);
  return (int)cudaErrorInvalidValue;
}
