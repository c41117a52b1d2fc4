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
// it: the bf16 tensor cores' 989 TFLOP/s, which only wgmma reaches.  Short
// prompts at batch 1 fill few CTAs (16 heads x S/128 at the main path), so
// there the latency of one CTA's KV loop bounds it.
//
// bf16 at hd <= 128 (tc::fa_wgmma_kernel), built from what Hopper added:
//  - one CTA of three warpgroups per (batch, q head, 128 query rows, the
//    JAX kernel's block_q); warpgroup 2 is the producer, and one of its
//    threads issues every copy; warpgroups 0 and 1 are consumers of 64 rows
//    each.  setmaxnreg moves registers from the producer (24) to the
//    consumers (240), which hold S, O and P in the wgmma accumulators;
//  - copies are TMA loads of 4-D tensor maps (hd, heads, S, B) over the
//    contiguous (B, S, n, hd) tensors, encoded on the host for each call
//    (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda):
//    Q once per CTA, then K and V tiles of BN keys into a ring of 4 stages
//    with a full and an empty mbarrier each; the tensor map's zero fill past
//    Sq, Sk and hd takes the ragged edges, so no copy is guarded;
//  - rows are 64-column boxes of 128 bytes under 128-byte swizzle: hd 64 is
//    one box, hd 128 two; hd 112 (224-byte rows, which no swizzle span
//    divides) takes two boxes, the last 16 columns zero-filled by the
//    tensor map.  No product reads them: Q K^T runs 7 k-steps and P V's
//    second product is n48, so hd 112 costs smem, not work.  hd 16 and 32
//    use one box, zero-filled past hd;
//  - S = Q K^T is wgmma m64nBNk16 with both operands in shared memory
//    (K-major descriptors, 32 bytes a k-step inside the swizzled row);
//  - O += P V is wgmma with A from registers: P's bf16 high part, then its
//    bf16 low part, into the same f32 accumulators, so that P V is the
//    product of the f32 P as the TPU kernel's is (P rounded once to bf16
//    put outputs of |o| in [2, 4) more than one bf16 step from the f32
//    attention); V is MN-major in shared memory (the transpose flag), one
//    wgmma of N <= 64 per box;
//  - the online softmax runs on the accumulators in log2 units (row max and
//    sum over the 4 lanes that share a row, the scale folded into the
//    exponent's FMA, ex2.approx); tile n+1's Q K^T is issued before tile
//    n's P V, and tile n+1's softmax runs while the tensor cores do that
//    P V; a stage goes back to the producer when the P V that read it has
//    completed;
//  - KV tiles of BN = 64 keys at every hd: S, the next S, O and both parts
//    of P stay well within the 240 registers without spill at hd 128, and
//    at the main path's batch-1 prompt, where one CTA's KV loop sets the
//    time, shorter steps overlap the softmax of one tile with the products
//    of the next more finely;
//  - the KV loop runs only over [window edge, causal horizon), and only the
//    tiles that cross the diagonal, the window's edge or Sk for a
//    consumer's rows evaluate the mask; a consumer whose 64 rows all lie
//    at or past Sq (Sq = 1 or 4, a ragged last block) does not run, and
//    the empty barriers count one consumer fewer;
//  - the longest causal rows of every head are scheduled first (row blocks
//    are the grid's slowest axis, in reverse), so the last wave is short;
//  - O / l is rounded to bf16 once and stored from the registers; no row at
//    or past Sq is written.
// One CTA fills an SM (384 threads at 168 registers at launch).
//
// bf16 at hd 256 (tc::fa_mma_wide_kernel, recurrentgemma-9b's 16 q heads
// over 1 kv head): the wgmma kernel would hold O (128 f32) besides S and P
// in each consumer thread, so hd 256 keeps the Ampere-style kernel of the
// first redesign: one CTA of 4 warps x 16 rows, 64-key tiles, mma.sync
// m16n8k16 fed by ldmatrix, Q in its own shared-memory tile for the whole
// KV loop (each k-step reloads its fragment), one S tile at a time (128 +
// 32 registers of accumulators), K and V through a 2-stage cp.async ring
// (two barriers per tile), the same masks, online softmax and P split as
// above.  Shared memory: Q 64 x 264 + 2 stages x (K + V) 64 x 264 bf16 =
// 168,960 bytes, one CTA per SM; ptxas keeps it at 255 registers with 76
// bytes of spill.  recurrentgemma-9b's prefills (16 heads x S/64 row
// blocks, at most 128 CTAs at S = 512) fit in one wave of 132 SMs.
//
// f32 (fa_kernel<float>): the SIMT body of the first port, unchanged.  The
// f32 tolerance (2e-5) rules out bf16 or TF32 products, so f32 stays on the
// 67 TFLOP/s SIMT units; one CTA per (batch, q head, 64 rows), 4 threads a
// row, f32 tiles in shared memory, probabilities exchanged by shuffles.  At
// hd 256 its tiles take 4 x (64 x 257 + 64 x 257 + 64 x 256) = 197,120 bytes
// of shared memory (opted in above 48 KB), one CTA per SM.  hd 112 divides
// as it is: 28 four-float chunks a row, 28 output dims a thread.
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
// bf16: the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

// Masked logits of one S tile of NB 8-key column blocks to -inf: keys at or
// past Sk, past the causal horizon, or at or before the window's edge.
// Rows gid (qpos0) and gid + 8 (qpos1) of the warp's 16.
template <int NB>
__device__ __forceinline__ void mask_tile(float (&s)[NB][4], int n0, int Sk, int causal,
                                          int window, int qpos0, int qpos1, int tig) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
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

// The online softmax of one S tile over the quad that holds each row, in
// log2 units (the scale goes into the exponent's FMA): the running maxima
// m0, m1 move to the tile's, s becomes the tile's exponentials and this
// lane's part of the running sums l0, l1 is rescaled and extended; returns
// the factors alpha0, alpha1 by which the output accumulators must be
// rescaled.  m starts finite (-1e30), so a row masked so far keeps
// exp2(-inf) = 0 and alpha = 1.
template <int NB>
__device__ __forceinline__ void online_softmax(float (&s)[NB][4], float& m0, float& m1, float& l0,
                                               float& l1, float& alpha0, float& alpha1,
                                               float scale_log2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  mx0 = fmaxf(m0, group_max(mx0, 4) * scale_log2);
  mx1 = fmaxf(m1, group_max(mx1, 4) * scale_log2);
  alpha0 = fast_exp2(m0 - mx0);
  alpha1 = fast_exp2(m1 - mx1);
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
}

template <int DB>
__device__ __forceinline__ void rescale(float (&acc)[DB][4], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < DB; ++j) {
    acc[j][0] *= alpha0; acc[j][1] *= alpha0;
    acc[j][2] *= alpha1; acc[j][3] *= alpha1;
  }
}

// P of the 16 keys 16 kk..16 kk + 15 as A fragments: its bf16 high part
// and its bf16 low part (the rounded remainder).  Multiplied by the same V
// into the same f32 accumulators, the two give the product of the f32 P,
// as the TPU kernel's is (one bf16 P put outputs of |o| in [2, 4) more
// than one bf16 step from the f32 attention).
template <int NB>
__device__ __forceinline__ void split_p(const float (&s)[NB][4], int kk, uint32_t (&ph)[4],
                                        uint32_t (&pl)[4]) {
  split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
  split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
  split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
  split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
}

// The normalised output rows gid and gid + 8 of the warp's 16 as bf16;
// rows at or past Sq are not written.
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

// ---------------------------------------------------------------------------
// bf16 at hd <= 128: wgmma on TMA-fed tiles, warp-specialised (see the note
// at the top).
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 384;   // consumer warpgroups 0 and 1, producer 2

template <int HD>
struct Wg {
  static constexpr int BM = 128;                  // query rows a CTA, 64 a consumer
  static constexpr int BN = 64;                   // keys a KV tile
  static constexpr int NS = 4;                    // stages of the K/V ring
  static constexpr int NBOX = (HD + 63) / 64;     // 64-column (128-byte) boxes a row
  static constexpr int BOX_Q = BM * 128;          // bytes of a Q box
  static constexpr int BOX_KV = BN * 128;         // bytes of a K or V box
  static constexpr int Q_BYTES = NBOX * BOX_Q;
  static constexpr int STAGE_BYTES = 2 * NBOX * BOX_KV;   // the K boxes, then the V boxes
  // 1024 bytes to align the tiles to the swizzle's atom, Q, the ring, and
  // the barriers (Q full, NS full, NS empty)
  static constexpr size_t SMEM = 1024 + Q_BYTES + NS * STAGE_BYTES + 8 * (1 + 2 * NS);
};

// S = Q K^T of one tile into s: HD / 16 k-steps; step kk reads 16 columns
// of 64-column box kk / 4 of Q's rows and of the tile's keys, 32 bytes
// into the swizzled row per step.  The first step ignores s's old value.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Wg<HD>::BN / 8][4], uint32_t q_addr,
                                         uint32_t k_addr) {
  using C = Wg<HD>;
  float(&d)[C::BN / 2] = *reinterpret_cast<float(*)[C::BN / 2]>(&s[0][0]);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<C::BN>(d, desc_sw128(q_addr + (kk / 4) * C::BOX_Q + off, 16, 1024),
                    desc_sw128(k_addr + (kk / 4) * C::BOX_KV + off, 16, 1024), kk > 0);
  }
}

// O += P V over one V box (64 columns, fewer in the last box where HD is
// not a multiple of 64) for the 16 keys of k-step kk, P's high part then
// its low part
template <int HD, int BX>
__device__ __forceinline__ void issue_pv_box(float (&acc)[HD / 8][4], const uint32_t (&ph)[4],
                                             const uint32_t (&pl)[4], uint32_t v_addr, int kk) {
  using C = Wg<HD>;
  constexpr int N = HD - 64 * BX < 64 ? HD - 64 * BX : 64;
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&acc[8 * BX][0]);
  const uint64_t b = desc_sw128(v_addr + BX * C::BOX_KV + kk * 16 * 128, 1024, 1024);
  wgmma_rs<N>(d, ph, b);
  wgmma_rs<N>(d, pl, b);
}

template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 8][4],
                                         const uint32_t (&ph)[Wg<HD>::BN / 16][4],
                                         const uint32_t (&pl)[Wg<HD>::BN / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < Wg<HD>::BN / 16; ++kk) {
    issue_pv_box<HD, 0>(acc, ph[kk], pl[kk], v_addr, kk);
    if constexpr (Wg<HD>::NBOX > 1) issue_pv_box<HD, 1>(acc, ph[kk], pl[kk], v_addr, kk);
  }
}

template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1) fa_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int Sq, int Sk, int nq,
    int nkv, int causal, int window, int q_offset, float scale_log2) {
  using C = Wg<HD>;
  constexpr int BN = C::BN, NS = C::NS, NB = BN / 8, KB = BN / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                       // NBOX boxes of BM rows
  unsigned char* ring = base + C::Q_BYTES;        // NS stages: K boxes, V boxes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * C::STAGE_BYTES);
  uint64_t* full = q_full + 1;                    // stage s holds its tile
  uint64_t* empty = full + NS;                    // every consumer is done with stage s

  // the grid's slowest axis is the row block, last first: every head's
  // longest causal rows start before any shorter ones
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (nq / nkv);
  const int wg = threadIdx.x / 128;
  // consumer warpgroups with a row before Sq (the second has none where
  // Sq - q0 <= 64: a decode step's or a ragged last block's rows)
  const int consumers = q0 + 64 < Sq ? 2 : 1;

  // Keys that some row of this CTA can see, from a tile boundary: [k_lo, k_hi).
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + C::BM, Sq) - 1;
  const int k_hi = causal ? min(Sk, qpos_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, qpos_first - window + 1) / BN * BN : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every copy; Q once, then each tile into
    // the next stage once both consumers have released it
    regs_dec<24>();
    if (threadIdx.x == 256) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int bx = 0; bx < C::NBOX; ++bx)
        tma_load_4d(Qs + bx * C::BOX_Q, &tq, q_full, 64 * bx, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % NS;
        if (it >= NS) mbar_wait(empty + st, (it / NS - 1) & 1);
        unsigned char* kv = ring + st * C::STAGE_BYTES;
        mbar_arrive_expect_tx(full + st, C::STAGE_BYTES);
        const int n0 = k_lo + it * BN;
#pragma unroll
        for (int bx = 0; bx < C::NBOX; ++bx) {
          tma_load_4d(kv + bx * C::BOX_KV, &tk, full + st, 64 * bx, kvh, n0, b);
          tma_load_4d(kv + (C::NBOX + bx) * C::BOX_KV, &tv, full + st, 64 * bx, kvh, n0, b);
        }
      }
    }
  } else if (wg < consumers) {
    // consumer: 64 rows, S and O in the wgmma accumulators
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int row0 = q0 + 64 * wg;
    const int qw_first = q_offset + row0;
    const int qw_last = q_offset + min(row0 + 64, Sq) - 1;
    const int qpos0 = qw_first + warp * 16 + gid, qpos1 = qpos0 + 8;
    const uint32_t q_addr = smem_addr(Qs) + wg * 64 * 128;
    const uint32_t ring_addr = smem_addr(ring);

    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, alpha0, alpha1;
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    uint32_t ph[KB][4], pl[KB][4];      // P of the tile before, its high and low parts

    // S of tile `it` with its masks (only where the tile crosses Sk, the
    // causal diagonal or the window's edge for this warpgroup's rows) and
    // the online softmax; the caller waits for the product first
    auto softmax_of = [&](float (&s)[NB][4], int it) {
      const int n0 = k_lo + it * BN;
      const bool masked = n0 + BN > Sk || (causal && n0 + BN - 1 > qw_first) ||
                          (window > 0 && n0 <= qw_last - window);
      if (masked) mask_tile<NB>(s, n0, Sk, causal, window, qpos0, qpos1, tig);
      online_softmax<NB>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
    };

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      float s[NB][4];
      mbar_wait(full, 0);
      wgmma_fence();
      issue_qk<HD>(s, q_addr, ring_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
      softmax_of(s, 0);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) split_p<NB>(s, kk, ph[kk], pl[kk]);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % NS, prev = (it - 1) % NS;
      // zeros: the product ignores them, but the compiler keeps no old
      // value of s alive into it
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mbar_wait(full + st, (it / NS) & 1);
      // S of this tile, then O += P V of the tile before: S completes
      // first, and its softmax runs while the tensor cores do P V
      fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
      fence_regs(reinterpret_cast<float(&)[HD / 2]>(acc));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 4]>(ph));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 4]>(pl));
      wgmma_fence();
      issue_qk<HD>(s, q_addr, ring_addr + st * C::STAGE_BYTES);
      wgmma_commit();
      issue_pv<HD>(acc, ph, pl, ring_addr + prev * C::STAGE_BYTES + C::NBOX * C::BOX_KV);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
      softmax_of(s, it);
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[HD / 2]>(acc));
      if (t == 0) mbar_arrive(empty + prev);    // both reads of stage prev are done
      rescale<HD / 8>(acc, alpha0, alpha1);
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) split_p<NB>(s, kk, ph[kk], pl[kk]);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % NS;
      fence_regs(reinterpret_cast<float(&)[HD / 2]>(acc));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 4]>(ph));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 4]>(pl));
      wgmma_fence();
      issue_pv<HD>(acc, ph, pl, ring_addr + last * C::STAGE_BYTES + C::NBOX * C::BOX_KV);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[HD / 2]>(acc));
      if (t == 0) mbar_arrive(empty + last);
    }
    const long q_stride = (long)nq * HD;
    store_rows<HD>(o + (long)b * Sq * q_stride + (long)h * HD + 2 * tig, acc, l0, l1,
                   row0 + warp * 16 + gid, Sq, q_stride);
  }
}

template <int HD>
cudaError_t launch_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Sq,
                         int Sk, int nq, int nkv, int causal, int window, int q_offset,
                         float scale, cudaStream_t stream) {
  using C = Wg<HD>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tma_encode_bshd(&mq, q, sizeof(bf16), B, Sq, nq, HD, C::BM);
  if (err == cudaSuccess) err = tma_encode_bshd(&mk, k, sizeof(bf16), B, Sk, nkv, HD, C::BN);
  if (err == cudaSuccess) err = tma_encode_bshd(&mv, v, sizeof(bf16), B, Sk, nkv, HD, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(nq, B, (Sq + C::BM - 1) / C::BM);
  fa_wgmma_kernel<HD><<<grid, WG_THREADS, C::SMEM, stream>>>(
      mq, mk, mv, o, Sq, Sk, nq, nkv, causal, window, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at hd 256: mma.sync m16n8k16 fed by ldmatrix, Q in shared memory, one
// S tile, a 2-stage cp.async K/V ring (see the note at the top).
// ---------------------------------------------------------------------------
constexpr int NW = 4;             // warps per CTA, 16 query rows each
constexpr int NT = 32 * NW;
constexpr int NS_WIDE = 2;

// Shared-memory row of a tile: hd bf16 and 16 bytes of padding.
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }

// ROWS rows of hd bf16 from rows [row0, row0 + ROWS) of `src` (`stride`
// elements apart) into `dst`; rows at or past `rows` are zero-filled and
// not read.  Each thread copies the same 16-byte column of every RPP-th
// row, so its addresses advance by constant steps.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long stride, int row0,
                                          int rows, int tid) {
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  static_assert(NT % CPR == 0, "a row's chunks divide a pass of the CTA");
  constexpr int RPP = NT / CPR;   // rows per pass of the CTA
  static_assert(ROWS % RPP == 0, "whole passes");
  const int r = tid / CPR, col = (tid % CPR) * 8;
  const bf16* g = src + (long)(row0 + r) * stride + col;
  bf16* sm = dst + r * ld<HD>() + col;
#pragma unroll
  for (int i = 0; i < ROWS / RPP; ++i) {
    const bool ok = row0 + r + i * RPP < rows;
    cp_async16(sm + i * RPP * ld<HD>(), ok ? g + i * RPP * stride : src, ok);
  }
}

// The online softmax of one S tile, then O += P V: P's high and low parts
// each multiplied by V (ldmatrix.trans, x4 matrices (keys 0-7 | 8-15) x
// (dims 0-7 | 8-15)) into the same f32 accumulators.
template <int HD>
__device__ __forceinline__ void softmax_pv(float (&s)[BN / 8][4], float (&acc)[HD / 8][4],
                                           float& m0, float& m1, float& l0, float& l1,
                                           const bf16* Vt, float scale_log2, int frag_row,
                                           int frag_col) {
  float alpha0, alpha1;
  online_softmax<BN / 8>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
  rescale<HD / 8>(acc, alpha0, alpha1);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t ph[4], pl[4];
    split_p<BN / 8>(s, kk, ph, pl);
#pragma unroll
    for (int d2 = 0; d2 < HD / 16; ++d2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (kk * 16 + frag_row) * ld<HD>() + d2 * 16 + frag_col);
      mma_bf16_16816(acc[2 * d2], ph, vf[0], vf[1]);
      mma_bf16_16816(acc[2 * d2 + 1], ph, vf[2], vf[3]);
      mma_bf16_16816(acc[2 * d2], pl, vf[0], vf[1]);
      mma_bf16_16816(acc[2 * d2 + 1], pl, vf[2], vf[3]);
    }
  }
}

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
    if (masked) mask_tile<NB>(s, n0, Sk, causal, window, qpos0, qpos1, tig);
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

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Sq, int Sk,
                   int nq, int nkv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  if constexpr (HD <= 128) {      // only the kernel each head size runs is compiled
    return launch_wgmma<HD>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale,
                            stream);
  } else {
    constexpr size_t smem = smem_bytes_wide<HD>();
    cudaError_t err = cudaFuncSetAttribute(fa_mma_wide_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(nq, B, (Sq + BM - 1) / BM);
    fa_mma_wide_kernel<HD><<<grid, NT, smem, stream>>>(q, k, v, o, Sq, Sk, nq, nkv, causal,
                                                       window, q_offset, scale * LOG2E);
    return cudaGetLastError();
  }
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
// device, of encoding a tensor map, or of the kernel's shared-memory limit.  Shapes, dtypes, contiguity
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
