// FlashAttention prefill for Hopper (sm_90a): bf16 on the tensor cores, f32
// on the SIMT units, f32 softmax statistics in both.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _fa_kernel): softmax(q k^T * hd^-0.5 + mask) v for q (B,Sq,nq,hd) and
// k, v (B,Sk,nkv,hd), query head h reading kv head h / (nq/nkv).  Masks: key
// beyond Sk, causal kpos <= qpos, window kpos > qpos - W, with
// qpos = q_offset + row.  A row with no visible key gives 0, as the Pallas
// kernel does.
//
// What bounds it on this card: at prefill lengths (S >= 512, hd >= 64) the
// work is 4*S^2*hd/2 operations per causal head against 4*S*hd elements
// moved, far above the H100's ~295 operations per byte, so operations bound
// it: the bf16 tensor cores' 989 TFLOP/s.  Shorter prompts at batch 1 fill
// few CTAs (16 heads x S/64), so there the latency of one CTA's KV loop
// bounds it.
//
// bf16 (tc::fa_mma_kernel), in the FlashAttention-2 layout:
//  - one CTA of 4 warps per (batch, q head, 64 query rows); a warp owns 16
//    rows and keeps their Q fragments in registers for the whole KV loop;
//  - both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//    f32 accumulate), fed by ldmatrix (.trans for V in P V);
//  - S = Q K^T stays in the accumulator registers; the online softmax runs
//    there in log2 units (row max and sum over the 4 lanes of a quad, the
//    scale folded into the exponent's FMA, ex2.approx), and P is split in
//    registers into a bf16 high part and a bf16 low part, both used
//    directly as A operands of P V: no (Sq, Sk) tile reaches shared or
//    device memory.  The TPU kernel multiplies the f32 P by V and rounds
//    once, at the output; P rounded to bf16 alone (relative error 2^-9 on
//    each weight) put outputs of |o| in [2, 4) up to 0.0255 from the f32
//    attention of the same inputs, more than one bf16 step there, and the
//    low part's product (half again as many mma.sync per tile; its time
//    on an H100 is in PERF.md) brings them back within half a step
//    (tests/test_torch_cuda.py,
//    test_flash_bf16_rounding_margin_at_large_outputs);
//  - K and V tiles of 64 keys move as bf16 with 16-byte cp.async into a
//    3-stage ring (tiles n+1 and n+2 in flight while n computes, one
//    barrier per tile); rows are padded by 16 bytes, so the 8 rows an
//    ldmatrix phase reads fall in 8 different bank groups;
//  - the products of tile n+1's S are issued in the same basic block as
//    tile n's softmax, so that the tensor cores work while the FMA and MUFU
//    units exponentiate;
//  - the KV loop runs only over [window edge, causal horizon), and only the
//    tiles that cross the diagonal, the window's edge or Sk evaluate the
//    mask; interior tiles take the unmasked path;
//  - the longest causal rows of every head are scheduled first (row blocks
//    are the grid's slowest axis, in reverse), so the last wave is short.
// What is left: mma.sync reaches about half of what SDPA (wgmma) reaches on
// this card; wgmma fed by TMA with warp-specialised producers is the next
// step (ROADMAP Queue 2).
//
// bf16 at hd 256 (tc::fa_mma_wide_kernel, recurrentgemma-9b's 16 q heads
// over 1 kv head): the layout above does not fit.  Per thread it would hold
// the Q fragments (HD/16 x 4 = 64 registers), the O accumulators (HD/8 x 4
// = 128 f32) and S of two tiles (2 x 32): more than the 255 registers a
// thread may have, so it would spill.  The wide kernel keeps the CTA shape
// (4 warps x 16 rows, 64-key tiles, the same masks and online softmax) and
// changes three things:
//  - Q stays in its own shared-memory tile for the whole KV loop and each
//    k-step reloads its fragment by ldmatrix, so no register holds Q;
//  - S of the next tile is not computed ahead (one S tile, 32 registers):
//    128 + 32 registers of accumulators and S and the fragments in flight
//    fit the cap of 255 at one CTA per SM (__launch_bounds__(128, 1));
//    ptxas kept it at 245 registers with no spill, and with P's low part
//    (four more fragment registers) at 255 and 76 bytes of spill;
//  - K and V pass through a 2-stage ring (tile n+1 in flight while n
//    computes; two barriers per tile, the second before the stage is
//    refilled).  Shared memory: Q 64 x 264 + 2 stages x (K + V) 64 x 264
//    bf16 = 168,960 bytes, one CTA per SM.  recurrentgemma-9b's prefills
//    (16 heads x S/64 row blocks, at most 128 CTAs at S = 512) fit in one
//    wave of 132 SMs, so one CTA per SM costs no wave there.
//
// hd 112 (kimi-k2's 64 q heads over 8 kv heads): the tensor-core layout
// above takes it as it is (7 k-steps of Q K^T, 7 x 16 output columns of
// P V, 14 x 8 dims of O) except for the copy of a tile.  A bf16 row is 14
// sixteen-byte chunks, which do not divide a pass of 128 threads, so
// load_tile numbers the tile's chunks row-major and gives chunk c to
// thread c % 128, with a guarded last pass where the chunks are not whole
// passes (64 rows x 14 = 896 = 7 passes, so the guard compiles away at
// hd 112).  The alternative, hd padded to 128 in shared memory, would copy
// and multiply 14% of zeros.  Rows of 120 bf16 (240 bytes) keep the 8 rows
// of an ldmatrix phase in 8 bank groups (15 r mod 8).  Shared memory is
// 92,160 bytes a CTA, so two CTAs fit an SM (min_ctas); at that bound ptxas
// keeps the kernel at 255 registers with 20 bytes of spill.  The f32 SIMT body
// divides at hd 112 as it is: 28 four-float chunks a row in a loop that
// does not assume whole passes, and 28 output dims a thread.
//
// f32 (fa_kernel<float>): the SIMT body of the first port, unchanged.  The
// f32 tolerance (2e-5) rules out bf16 or TF32 products, so f32 stays on the
// 67 TFLOP/s SIMT units; one CTA per (batch, q head, 64 rows), 4 threads a
// row, f32 tiles in shared memory, probabilities exchanged by shuffles.  At
// hd 256 its tiles take 4 x (64 x 257 + 64 x 257 + 64 x 256) = 197,120 bytes
// of shared memory (opted in above 48 KB), one CTA per SM.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64;            // query rows per CTA
constexpr int BN = 64;            // keys per KV tile
constexpr int TPR = 4;            // threads per query row
constexpr int NT = BM * TPR;      // threads per CTA

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K rows padded by one float so that the 8 rows (Q) or 4 keys (K)
  // a warp reads at one step fall in different banks.
  return sizeof(float) * (BM * (HD + 1) + BN * (HD + 1) + BN * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int nq, int nkv, int causal, int window,
    int q_offset, float scale_log2) {
  constexpr int HDP = HD + 1;
  constexpr int V4 = HD / 4;      // 4-element chunks per row
  constexpr int KPT = BN / TPR;   // keys of a tile per thread
  constexpr int DPT = HD / TPR;   // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // BM x HDP
  float* Ks = Qs + BM * HDP;      // BN x HDP
  float* Vs = Ks + BN * HDP;      // BN x HD

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x;
  const int r = tid / TPR;        // this thread's query row in the tile
  const int c = tid % TPR;        // its quarter of the keys and head dims
  const int lane = tid % 32;

  const long q_stride = (long)nq * HD;   // elements between positions
  const long kv_stride = (long)nkv * HD;
  const T* qb = q + (long)b * Sq * q_stride + (long)h * HD;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * HD;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * HD;

  for (int idx = tid; idx < BM * V4; idx += NT) {
    const int row = idx / V4, d = (idx % V4) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + row < Sq) load4(qb + (long)(q0 + row) * q_stride + d, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) Qs[row * HDP + d + i] = f[i];
  }

  const int row_q = q0 + r;
  const bool row_ok = row_q < Sq;
  const int qpos = q_offset + row_q;
  // Keys that some row of this tile can see: [k_lo, k_hi).
  const int last_qpos = q_offset + min(q0 + BM, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_qpos + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;

  float m = NEG_INF, l = 0.f;     // running max (log2 units) and sum
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  for (int n0 = k_lo; n0 < k_hi; n0 += BN) {
    __syncthreads();  // Q is stored, and every thread is done with the last tile
    for (int idx = tid; idx < BN * V4; idx += NT) {
      const int row = idx / V4, d = (idx % V4) * 4;
      const int key = n0 + row;
      float fk[4] = {0.f, 0.f, 0.f, 0.f}, fv[4] = {0.f, 0.f, 0.f, 0.f};
      if (key < Sk) {
        load4(kb + (long)key * kv_stride + d, fk);
        load4(vb + (long)key * kv_stride + d, fv);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        Ks[row * HDP + d + i] = fk[i];
        Vs[row * HD + d + i] = fv[i];
      }
    }
    __syncthreads();

    // logits of row r against keys c, c+4, c+8, ... of the tile
    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = Qs[r * HDP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] = fmaf(qd, Ks[(c + TPR * j) * HDP + d], s[j]);
    }
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = n0 + c + TPR * j;
      const bool ok = row_ok && kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      s[j] = ok ? s[j] * scale_log2 : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = group_max(tmax, TPR);
    const float m_new = fmaxf(m, tmax);
    const float alpha = exp2f(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] = is_live(s[j]) ? exp2f(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * alpha + group_sum(psum, TPR);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;

    // acc[i] (dim c + 4i) += sum over keys of p * v; the probability of key
    // cc + 4j sits in register s[j] of the row's lane cc.
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
#pragma unroll
      for (int cc = 0; cc < TPR; ++cc) {
        const float p = __shfl_sync(0xffffffffu, s[j], (lane & ~(TPR - 1)) | cc);
        const float* vrow = Vs + (cc + TPR * j) * HD + c;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vrow[TPR * i], acc[i]);
      }
    }
  }

  if (row_ok) {
    T* ob = o + ((long)b * Sq + row_q) * q_stride + (long)h * HD;
#pragma unroll
    for (int i = 0; i < DPT; ++i) store(ob + c + TPR * i, l > 0.f ? acc[i] / l : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16) in the FlashAttention-2 layout.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;             // warps per CTA, 16 query rows each
constexpr int NT = 32 * NW;
constexpr int NS = 3;             // ring stages of K and V tiles

// Shared-memory row of a tile: hd bf16 and 16 bytes of padding.
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

// NS stages of a K and a V tile each; Q passes through the last V tile on
// its way to the registers
template <int HD>
constexpr size_t smem_bytes() { return sizeof(bf16) * 2 * NS * BN * ld<HD>(); }

// CTAs per SM the registers must allow (shared memory allows as many:
// 3 x 55,296 bytes at hd 64, 2 x 92,160 at hd 112, 2 x 104,448 at hd 128)
template <int HD>
__host__ __device__ constexpr int min_ctas() { return HD >= 112 ? 2 : 3; }

// ROWS rows of hd bf16 from rows [row0, row0 + ROWS) of `src` (`stride`
// elements apart) into `dst`; rows at or past `rows` are zero-filled and
// not read.  Where a row's 16-byte chunks divide a pass of the CTA, each
// thread copies the same column of every RPP-th row, so its addresses
// advance by constant steps; otherwise (hd 112: 14 chunks) chunk c of the
// tile, row-major, goes to thread c % NT, the last pass guarded.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long stride, int row0,
                                          int rows, int tid) {
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  if constexpr (NT % CPR == 0) {
    constexpr int RPP = NT / CPR; // rows per pass of the CTA
    static_assert(ROWS % RPP == 0, "whole passes");
    const int r = tid / CPR, col = (tid % CPR) * 8;
    const bf16* g = src + (long)(row0 + r) * stride + col;
    bf16* sm = dst + r * ld<HD>() + col;
#pragma unroll
    for (int i = 0; i < ROWS / RPP; ++i) {
      const bool ok = row0 + r + i * RPP < rows;
      cp_async16(sm + i * RPP * ld<HD>(), ok ? g + i * RPP * stride : src, ok);
    }
  } else {
    constexpr int CHUNKS = ROWS * CPR;
#pragma unroll
    for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (CHUNKS % NT == 0 || c < CHUNKS) {
        const int r = c / CPR, col = (c % CPR) * 8;
        const bool ok = row0 + r < rows;
        cp_async16(dst + r * ld<HD>() + col, ok ? src + (long)(row0 + r) * stride + col : src,
                   ok);
      }
    }
  }
}

// S = Q K^T of one 64-key tile: x4 matrices (keys 0-7 | 8-15 of a 16-key
// pair) x (dims 0-7 | 8-15)
template <int HD>
__device__ __forceinline__ void qk(float (&s)[BN / 8][4], const uint32_t (&qf)[HD / 16][4],
                                   const bf16* Kt, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int j2 = 0; j2 < BN / 16; ++j2) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld<HD>() + ks * 16 +
                          ((lane >> 3) & 1) * 8);
      mma_bf16_16816(s[2 * j2], qf[ks], kf[0], kf[1]);
      mma_bf16_16816(s[2 * j2 + 1], qf[ks], kf[2], kf[3]);
    }
  }
}

// Masked logits of one S tile to -inf: keys at or past Sk, past the causal
// horizon, or at or before the window's edge.  Rows gid (qpos0) and gid + 8
// (qpos1) of the warp's 16.
__device__ __forceinline__ void mask_tile(float (&s)[BN / 8][4], int n0, int Sk, int causal,
                                          int window, int qpos0, int qpos1, int tig) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = n0 + j * 8 + 2 * tig + (e & 1);
      const int qpos = e < 2 ? qpos0 : qpos1;
      const bool ok = kpos < Sk && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      if (!ok) s[j][e] = -INFINITY;
    }
  }
}

// The online softmax of one S tile over the quad that holds each row (the
// scale goes into the exponent's FMA; m starts finite (-1e30), so a row
// masked so far keeps exp2(-inf) = 0 and alpha = 1), then O += P V: P from
// the S registers as two bf16 A fragments, its high and low parts, each
// multiplied by V (ldmatrix.trans, x4 matrices (keys 0-7 | 8-15) x (dims
// 0-7 | 8-15)) into the same f32 accumulators, so that P V is the product
// of the f32 P, as the TPU kernel's is.
template <int HD>
__device__ __forceinline__ void softmax_pv(float (&s)[BN / 8][4], float (&acc)[HD / 8][4],
                                           float& m0, float& m1, float& l0, float& l1,
                                           const bf16* Vt, float scale_log2, int frag_row,
                                           int frag_col) {
  constexpr int NB = BN / 8;
  constexpr int DB = HD / 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(m0, group_max(mx0, 4) * scale_log2);
  mx1 = fmaxf(m1, group_max(mx1, 4) * scale_log2);
  const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = fast_exp2(fmaf(s[j][0], scale_log2, -mx0));
    s[j][1] = fast_exp2(fmaf(s[j][1], scale_log2, -mx0));
    s[j][2] = fast_exp2(fmaf(s[j][2], scale_log2, -mx1));
    s[j][3] = fast_exp2(fmaf(s[j][3], scale_log2, -mx1));
    ps0 += s[j][0] + s[j][1];
    ps1 += s[j][2] + s[j][3];
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    acc[j][0] *= alpha0; acc[j][1] *= alpha0;
    acc[j][2] *= alpha1; acc[j][3] *= alpha1;
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int d2 = 0; d2 < DB / 2; ++d2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (kk * 16 + frag_row) * ld<HD>() + d2 * 16 + frag_col);
      mma_bf16_16816(acc[2 * d2], ph, vf[0], vf[1]);
      mma_bf16_16816(acc[2 * d2 + 1], ph, vf[2], vf[3]);
      mma_bf16_16816(acc[2 * d2], pl, vf[0], vf[1]);
      mma_bf16_16816(acc[2 * d2 + 1], pl, vf[2], vf[3]);
    }
  }
}

// The normalised output rows gid and gid + 8 of the warp's 16 as bf16.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* ob, const float (&acc)[HD / 8][4], float l0,
                                           float l1, int row0, int Sq, long q_stride) {
  l0 = group_sum(l0, 4);
  l1 = group_sum(l1, 4);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + j * 8) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * q_stride + j * 8) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, min_ctas<HD>()) fa_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int Sq, int Sk, int nq, int nkv, int causal, int window,
    int q_offset, float scale_log2) {
  constexpr int LD = ld<HD>();
  constexpr int KS = HD / 16;     // k-steps of Q K^T
  constexpr int NB = BN / 8;      // 8-key column blocks of S
  constexpr int DB = HD / 8;      // 8-dim column blocks of O
  static_assert(BM == BN, "Q takes one V tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // NS x BN x LD
  bf16* Vs = Ks + NS * BN * LD;                    // NS x BN x LD
  bf16* Qs = Vs + (NS - 1) * BN * LD;              // BM x LD, the last V tile

  // the grid's slowest axis is the row block, last first: every head's
  // longest causal rows start before any shorter ones
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  const long q_stride = (long)nq * HD;
  const long kv_stride = (long)nkv * HD;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * HD;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * HD;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * HD;

  // Keys that some row of this tile can see, from a tile boundary: [k_lo, k_hi).
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BM, Sq) - 1;
  const int k_hi = causal ? min(Sk, qpos_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, qpos_first - window + 1) / BN * BN : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  // Q, tile 0 and tile 1 into stages 0 and 1: one commit group each, empty
  // or not, so that the wait counts stay fixed
  load_tile<HD, BM>(Qs, qb, q_stride, q0, Sq, tid);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < n_tiles) {
      load_tile<HD, BN>(Ks + st * BN * LD, kb, kv_stride, k_lo + st * BN, Sk, tid);
      load_tile<HD, BN>(Vs + st * BN * LD, vb, kv_stride, k_lo + st * BN, Sk, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();        // Q has landed
  __syncthreads();

  // Q fragments of this warp's 16 rows: x4 matrices (rows 0-7 | 8-15) x
  // (dims 0-7 | 8-15) of each 16-dim k-step
  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8, frag_col = (lane >> 4) * 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qf[ks], Qs + (warp * 16 + frag_row) * LD + ks * 16 + frag_col);

  // rows gid and gid + 8 of the warp's 16: running max (log2 units), this
  // lane's part of the running sum, and the output accumulator
  const int qpos0 = qpos_first + warp * 16 + gid, qpos1 = qpos0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // S of tile it+1 is multiplied while the softmax of tile it runs, so the
  // tensor cores and the FMA/MUFU units overlap within a warp
  float s[NB][4];
  if (n_tiles > 0) {
    cp_async_wait<NS - 2>();      // tile 0 has landed
    __syncthreads();
    qk<HD>(s, qf, Ks, lane);
  }
#pragma unroll 2                  // s and sn trade places without moves
  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = k_lo + it * BN;
    cp_async_wait<0>();           // tile it+1 has landed
    // after this barrier every warp sees tile it+1 and is done with tile
    // it-1 (and, at it = 0, with Q), whose stage tile it+2 takes
    __syncthreads();
    if (it + NS - 1 < n_tiles) {
      const int st = (it + NS - 1) % NS;
      load_tile<HD, BN>(Ks + st * BN * LD, kb, kv_stride, n0 + (NS - 1) * BN, Sk, tid);
      load_tile<HD, BN>(Vs + st * BN * LD, vb, kv_stride, n0 + (NS - 1) * BN, Sk, tid);
    }
    cp_async_commit();
    // Only a tile that crosses Sk, the causal diagonal or the window's edge
    // evaluates the mask; a masked logit becomes -inf, so exp2 makes it 0.
    const bool masked = n0 + BN > Sk || (causal && n0 + BN - 1 > qpos_first) ||
                        (window > 0 && n0 <= qpos_last - window);
    if (masked) mask_tile(s, n0, Sk, causal, window, qpos0, qpos1, tig);

    // S of tile it+1 (a stale stage after the last tile, never used): in
    // one basic block with the softmax below, so that the two interleave
    float sn[NB][4];
    qk<HD>(sn, qf, Ks + ((it + 1) % NS) * BN * LD, lane);

    softmax_pv<HD>(s, acc, m0, m1, l0, l1, Vs + (it % NS) * BN * LD, scale_log2, frag_row,
                   frag_col);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sn[j][e];
  }
  cp_async_wait<0>();             // no copy outlives the CTA, even an empty group
  store_rows<HD>(o + (long)b * Sq * q_stride + (long)h * HD + 2 * tig, acc, l0, l1,
                 q0 + warp * 16 + gid, Sq, q_stride);
}

// ---------------------------------------------------------------------------
// bf16 at hd 256: Q in shared memory, one S tile, a 2-stage K/V ring (see
// the note at the top).
// ---------------------------------------------------------------------------
constexpr int NS_WIDE = 2;

template <int HD>
constexpr size_t smem_bytes_wide() { return sizeof(bf16) * (BM + 2 * NS_WIDE * BN) * ld<HD>(); }

template <int HD>
__global__ void __launch_bounds__(NT, 1) fa_mma_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int Sq, int Sk, int nq, int nkv, int causal, int window,
    int q_offset, float scale_log2) {
  constexpr int LD = ld<HD>();
  constexpr int KS = HD / 16;
  constexpr int NB = BN / 8;
  constexpr int DB = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);    // BM x LD, for the whole loop
  bf16* Ks = Qs + BM * LD;                          // NS_WIDE x BN x LD
  bf16* Vs = Ks + NS_WIDE * BN * LD;                // NS_WIDE x BN x LD

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (nq / nkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;

  const long q_stride = (long)nq * HD;
  const long kv_stride = (long)nkv * HD;
  const bf16* qb = q + (long)b * Sq * q_stride + (long)h * HD;
  const bf16* kb = k + (long)b * Sk * kv_stride + (long)kvh * HD;
  const bf16* vb = v + (long)b * Sk * kv_stride + (long)kvh * HD;

  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BM, Sq) - 1;
  const int k_hi = causal ? min(Sk, qpos_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, qpos_first - window + 1) / BN * BN : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  // Q with tile 0, then tile 1: one commit group each, empty or not, so
  // that the wait counts stay fixed
  load_tile<HD, BM>(Qs, qb, q_stride, q0, Sq, tid);
#pragma unroll
  for (int st = 0; st < NS_WIDE; ++st) {
    if (st < n_tiles) {
      load_tile<HD, BN>(Ks + st * BN * LD, kb, kv_stride, k_lo + st * BN, Sk, tid);
      load_tile<HD, BN>(Vs + st * BN * LD, vb, kv_stride, k_lo + st * BN, Sk, tid);
    }
    cp_async_commit();
  }

  const int frag_row = (lane & 7) + ((lane >> 3) & 1) * 8, frag_col = (lane >> 4) * 8;
  // this warp's 16 Q rows at its lane's ldmatrix address; a k-step adds 16
  const bf16* qw = Qs + (warp * 16 + frag_row) * LD + frag_col;
  const int qpos0 = qpos_first + warp * 16 + gid, qpos1 = qpos0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[DB][4];
#pragma unroll
  for (int j = 0; j < DB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = k_lo + it * BN;
    const int st = it % NS_WIDE;
    cp_async_wait<NS_WIDE - 1>();  // Q and tile it have landed; tile it+1 may not have
    __syncthreads();
    const bf16* Kt = Ks + st * BN * LD;
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qf[4];
      ldmatrix_x4(qf, qw + ks * 16);
#pragma unroll
      for (int j2 = 0; j2 < BN / 16; ++j2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16_16816(s[2 * j2], qf, kf[0], kf[1]);
        mma_bf16_16816(s[2 * j2 + 1], qf, kf[2], kf[3]);
      }
    }
    const bool masked = n0 + BN > Sk || (causal && n0 + BN - 1 > qpos_first) ||
                        (window > 0 && n0 <= qpos_last - window);
    if (masked) mask_tile(s, n0, Sk, causal, window, qpos0, qpos1, tig);
    softmax_pv<HD>(s, acc, m0, m1, l0, l1, Vs + st * BN * LD, scale_log2, frag_row, frag_col);
    __syncthreads();              // every warp is done with stage st: refill it
    if (it + NS_WIDE < n_tiles) {
      load_tile<HD, BN>(Ks + st * BN * LD, kb, kv_stride, n0 + NS_WIDE * BN, Sk, tid);
      load_tile<HD, BN>(Vs + st * BN * LD, vb, kv_stride, n0 + NS_WIDE * BN, Sk, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();             // no copy outlives the CTA, even an empty group
  store_rows<HD>(o + (long)b * Sq * q_stride + (long)h * HD + 2 * tig, acc, l0, l1,
                 q0 + warp * 16 + gid, Sq, q_stride);
}

using KernelFn = void (*)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int, int,
                         int, int, int, float);

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Sq, int Sk,
                   int nq, int nkv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  KernelFn kernel;
  size_t smem;
  if constexpr (HD > 128) {       // only the kernel each head size runs is compiled
    kernel = fa_mma_wide_kernel<HD>;
    smem = smem_bytes_wide<HD>();
  } else {
    kernel = fa_mma_kernel<HD>;
    smem = smem_bytes<HD>();
  }
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, B, (Sq + BM - 1) / BM);
  kernel<<<grid, NT, smem, stream>>>(q, k, v, o, Sq, Sk, nq, nkv, causal, window, q_offset,
                                     scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int nq, int nkv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch<HD>(static_cast<const T*>(q), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<T*>(o), B, Sq, Sk, nq, nkv,
                          causal, window, q_offset, scale, stream);
  else {
    constexpr size_t smem = smem_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BM - 1) / BM, nq, B);
    fa_kernel<T, HD><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), Sq, Sk, nq, nkv, causal, window, q_offset, scale * LOG2E);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int nq, int nkv, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's own, or the error of setting the
// device or the kernel's shared-memory limit.  Shapes, dtypes, contiguity
// and alignment are checked by the Python wrapper.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int dtype,
                          int B, int Sq, int Sk, int nq, int nkv, int hd, int causal,
                          int window, int q_offset, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)dispatch<float>(hd, q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, st);
  if (dtype == DTYPE_BF16)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}
