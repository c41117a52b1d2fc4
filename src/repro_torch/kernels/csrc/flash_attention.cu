// FlashAttention prefill for Hopper (sm_90a): bf16 and f32 on the tensor
// cores (f32 as three tf32 products a product), f32 softmax statistics.
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
// bf16 (tc::fa_wgmma_kernel, every head dim), built from what Hopper added;
// below hd 256:
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
//    one box, hd 128 two, hd 256 four; hd 112 (224-byte rows, which no
//    swizzle span divides) takes two boxes, the last 16 columns zero-filled
//    by the tensor map.  No product reads them: Q K^T runs 7 k-steps and P
//    V's second product is n48, so hd 112 costs smem, not work.  hd 16 and
//    32 use one box, zero-filled past hd;
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
// At hd 256 (recurrentgemma-9b's local attention, 16 q heads over 1 kv
// head) the same kernel runs with one consumer warpgroup (Wg<256>):
//  - shared memory: a stage of 64 keys is K and V in 4 boxes each, 64 KB; Q
//    is 4 boxes of 64 rows, 32 KB, which leaves room for 3 stages (225 KB of
//    the 227; two consumers' Q of 64 KB would leave room for 2);
//  - rows a CTA: at the served prefill (B=1, S=512, 16 heads) BM 64 makes
//    16 x 8 = 128 CTAs, where two consumers (BM 128) would make 64, half of
//    the 132 SMs.  One consumer still overlaps each tile's softmax with the
//    tile before's P V; on an H100 it was 0.65 of BM 128's time at S = 512
//    and 0.98 at S = 2048 (PERF.md);
//  - registers: a consumer thread holds O (hd / 2 = 128 f32), the next S
//    (32) and both parts of the tile before's P (16 + 16), 192 before
//    addresses and softmax state.  With one consumer the CTA is 256 threads
//    that may each take 255 registers, so no setmaxnreg (ptxas: 241, no
//    spill);
//  - P V is one wgmma m64n256k16 a part and 16-key step, across the four V
//    boxes: the MN-major descriptor's leading offset is the 8 KB between
//    boxes, so P's fragment is read from registers once, not once a box;
//  - what bounds it at the served prefill: 2.15e9 operations (0.00217 ms
//    at 989 TFLOP/s) against 8.9 MB moved (0.00266 ms at 3.35 TB/s), bytes;
//    the longest CTA (rows 448-511) walks 8 tiles of 6.3 MFLOP (Q K^T and
//    P V's two parts), 0.84 us each at one SM's share of the peak.
//
// f32 at hd <= 128 (tc::fa_tf32_kernel, the forward of every training
// step): one tf32 product per f32 product misses the f32 tolerance (2e-5;
// 1.3e-3 at the training shape in ref.flash_tf32_reference), three do not:
// each f32 operand x is big = its top 19 bits (a tf32) plus small = x - big
// (exact in f32), and each product is big.small + small.big + big.big into
// the f32 accumulators (small.small is below 2^-22 of it; the small ones
// first, because the tensor cores truncate each wgmma's sum).  At the training
// shape (B=8, S=512, 16 x 64, causal) operations bound it: 4.3e9 of them,
// three tf32 products each at 495 TFLOP/s, 0.026 ms, against 0.020 ms of
// bytes and 0.064 ms for the SIMT units' 67 TFLOP/s.  The bf16 kernel's
// design, carried over to f32:
//  - the tensor cores read an f32 operand's top 19 bits, truncating (shown
//    on an H100 by the one-tile probe fa_tf32_probe below, from shared
//    memory and from registers; chip_smoke.py phase 1 requires it), so Q
//    and K as TMA lands them are their own big parts;
//  - layouts: a 32-bit type has no transpose flag, so both shared-memory
//    operands of wgmma .tf32 are K-major.  Q and K land K-major over hd in
//    32-float (128-byte) boxes under 128-byte swizzle, and an 8-element
//    k-step is 32 bytes into the row, as a bf16 k-step is, so the bf16
//    kernel's tensor maps (4-byte elements), boxes and descriptors carry
//    over: hd 64 is two boxes, hd 112 four (the last one's second half
//    zero-filled and never read: 14 k-steps), hd 16 one, half zero-filled.
//    V lands MN-major for P V and no copy engine transposes it;
//  - a converter: the producer warpgroup's 128 threads (one of which still
//    issues every TMA load) write Q's small part once, each K tile's small
//    part at the same swizzled offsets, and each V tile as V^T (a row of 32
//    keys a dim), big and small parts, then fence the async proxy and
//    arrive on a "ready" barrier, which the consumers wait on;
//  - P needs no shuffle: a thread's S accumulators hold keys 2 tig and
//    2 tig + 1 of each 8-key step, a tf32 A fragment wants columns tig and
//    tig + 4, and a contraction over keys does not care about their order,
//    so V^T keeps each 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 and
//    P enters P V from registers as it is, split by a mask and a subtract.
//    P V is one wgmma of N = hd an 8-key step (no zero columns at hd 112);
//  - tiles: at hd <= 64, BM 128 (two consumers) and BN 64: Q 32 KB + its
//    small part 32 + 2 stages x (K 16 + small 16) + 2 x (V^T big 16 +
//    small 16) + 2 x V as landed 16 = 224 KB of 227.  At hd 112 and 128
//    each is twice that, so one consumer (BM 64) and BN 32 keep 224 KB
//    (Q's small part in registers would take 64 more a consumer thread
//    beside O's 64, S and P's two parts);
//  - K and V^T are separate two-stage rings: a consumer releases K after
//    its S and V^T after its P V, so the converter works a tile ahead;
//    V lands into two stages of its own, which the converter releases;
//  - registers: at hd <= 64 setmaxnreg moves the consumers to 232 and the
//    producer to 40 (3 x 168 at launch = 2 x 232 + 40: the transpose keeps
//    16 floats of V in flight), at hd 16 and 32 to 216 and 72; at hd 112
//    and 128 the CTA is 256 threads with up to 255 registers each, and no
//    setmaxnreg;
//  - the rest is the bf16 kernel's: mask_tile, online_softmax and rescale,
//    the tile walk [k_lo, k_hi), masks only where a tile needs them,
//    q_offset, windows and GQA, a consumer with no row before Sq does not
//    run, the longest causal rows first, 0 for a row that sees no key,
//    O / l stored in f32 from the registers, no row at or past Sq written.
//
// f32 at hd 256 (recurrentgemma-9b's local attention in f32, its training
// forward among them): the same tf32 kernel over a cluster of two CTAs that
// split the head dims.  One CTA would need twice hd 128's 224 KB (Q and its
// small part 64 KB each, K and V^T rings twice as wide), so:
//  - one cluster of two CTAs per (batch, q head, 64 query rows); rank r
//    owns dims [128 r, 128 r + 128) of Q, K, V and O: its tensor maps'
//    hd coordinate starts at 128 r and each CTA is hd 128's kernel (BM 64,
//    BN 32, the converter warpgroup, its K and V^T rings), with Q's small
//    part in the consumer's registers (64 a thread, loaded once from Q as
//    it landed; Q_small K_big takes A from registers) so that its 32 KB
//    hold two 8 KB slots of partial S instead (209 KB in all);
//  - S: each CTA's consumer computes its partial Q_r K_r^T over its 128
//    dims (three tf32 products, the small ones first), waits for it and
//    sends it into the peer's slot with 16-byte st.async stores, whose
//    bytes complete the transaction count of the peer's x_full mbarrier as
//    a TMA load's do (one local arrive.expect_tx a tile arms it; no remote
//    arrival); then it issues P V of the tile before, waits on its own
//    x_full and adds the peer's partial to its own in f32: a + b = b + a,
//    so both CTAs hold the same S, m, l and P, and each does P V over its
//    own 128 dims of V^T into its half of O and stores those 128 columns;
//  - the send goes between the two products because remote stores that
//    land while the peer's tensor cores read its shared memory wait behind
//    them: on an H100 at the served prefill below, sending after P V's
//    issue, or by st.shared::cluster stores with remote release arrivals,
//    was slower than this placement at every shape timed;
//  - the two slots alternate by tile: a slot is written again only after
//    the peer has the partial of the tile between, which this CTA sends
//    after reading it, so no barrier frees a slot; a cluster barrier after
//    the barriers' initialisation and another before exit keep every
//    remote store inside both CTAs' lifetimes;
//  - launched by cudaLaunchKernelEx with a cluster of (2, 1, 1) over a grid
//    of 2 nq along x, the longest causal rows first as below;
//  - what bounds it at recurrentgemma-9b's prefill (B=1, S=512, 16:1, causal):
//    2.15e9 operations, three tf32 products each at 495 TFLOP/s, 0.0130 ms,
//    against 17.8 MB moved, 0.0053 ms: operations.  The longest cluster
//    walks 16 tiles of 32 keys, each CTA 3.1 MFLOP of tf32 products a tile.
#include <type_traits>

#include "common.cuh"

namespace {

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

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The normalised output rows gid and gid + 8 of the warp's 16 in the
// output's type (bf16 rounded once); rows at or past Sq are not written.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* ob, const float (&acc)[HD / 8][4], float l0,
                                           float l1, int row0, int Sq, long q_stride) {
  l0 = group_sum(l0, 4);
  l1 = group_sum(l1, 4);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (row0 < Sq) store_pair(ob + row0 * q_stride + j * 8, acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < Sq) store_pair(ob + row1 * q_stride + j * 8, acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles, warp-specialised (see the note at the top).
// ---------------------------------------------------------------------------
template <int HD>
struct Wg {
  static constexpr int NC = HD == 256 ? 1 : 2;       // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);     // and the producer's
  static constexpr int BM = 64 * NC;                 // query rows a CTA, 64 a consumer
  static constexpr int BN = 64;                      // keys a KV tile
  static constexpr int NBOX = (HD + 63) / 64;        // 64-column (128-byte) boxes a row
  static constexpr int BOX_Q = BM * 128;             // bytes of a Q box
  static constexpr int BOX_KV = BN * 128;            // bytes of a K or V box
  static constexpr int Q_BYTES = NBOX * BOX_Q;
  static constexpr int STAGE_BYTES = 2 * NBOX * BOX_KV;   // the K boxes, then the V boxes
  // stages of the K/V ring: 4 up to hd 128; at hd 256 (64 KB a stage) as
  // many as fit beside Q, the alignment and the barriers
  static constexpr int NS = HD <= 128 ? 4 : (232448 - 1024 - 256 - Q_BYTES) / STAGE_BYTES;
  // 1024 bytes to align the tiles to the swizzle's atom, Q, the ring, and
  // the barriers (Q full, NS full, NS empty)
  static constexpr size_t SMEM = 1024 + Q_BYTES + NS * STAGE_BYTES + 8 * (1 + 2 * NS);
  static_assert(SMEM <= 232448, "a CTA's shared memory");
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

// O += P V of one tile, k-step by k-step (16 keys), P's high part then its
// low part: at hd 256 one wgmma of N = 256 across the four V boxes, the
// descriptor's leading offset stepping from box to box; below, one wgmma a
// box (at most two)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 8][4],
                                         const uint32_t (&ph)[Wg<HD>::BN / 16][4],
                                         const uint32_t (&pl)[Wg<HD>::BN / 16][4],
                                         uint32_t v_addr) {
  using C = Wg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    if constexpr (HD == 256) {
      float(&d)[HD / 2] = *reinterpret_cast<float(*)[HD / 2]>(&acc[0][0]);
      const uint64_t b = desc_sw128(v_addr + kk * 16 * 128, C::BOX_KV, 1024);
      wgmma_rs<HD>(d, ph[kk], b);
      wgmma_rs<HD>(d, pl[kk], b);
    } else {
      issue_pv_box<HD, 0>(acc, ph[kk], pl[kk], v_addr, kk);
      if constexpr (C::NBOX > 1) issue_pv_box<HD, 1>(acc, ph[kk], pl[kk], v_addr, kk);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Wg<HD>::THREADS, 1) fa_wgmma_kernel(
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
  // consumer warpgroups with a row before Sq (a second has none where
  // Sq - q0 <= 64: a decode step's or a ragged last block's rows)
  const int consumers = C::NC == 2 && q0 + 64 < Sq ? 2 : 1;

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

  if (wg == C::NC) {
    // producer: one thread issues every copy; Q once, then each tile into
    // the next stage once every consumer has released it
    if constexpr (C::NC == 2) regs_dec<24>();
    if (threadIdx.x == 128 * C::NC) {
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
    if constexpr (C::NC == 2) regs_inc<240>();
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
  fa_wgmma_kernel<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, o, Sq, Sk, nq, nkv, causal, window, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 at hd <= 128: three tf32 wgmma products a product, on TMA-fed tiles,
// with a converter warpgroup (see the note at the top).
// ---------------------------------------------------------------------------
template <int HD>
struct Tf {
  // CTAs of a cluster that split the head dims: two of 128 at hd 256
  static constexpr int CLUSTER = HD == 256 ? 2 : 1;
  static constexpr int HDC = HD / CLUSTER;           // head dims a CTA
  static constexpr int NC = HDC <= 64 ? 2 : 1;       // consumer warpgroups
  static constexpr int THREADS = 128 * (NC + 1);     // and the producer's
  static constexpr int BM = 64 * NC;                 // query rows a CTA
  static constexpr int BN = HDC <= 64 ? 64 : 32;     // keys a KV tile
  static constexpr int NBOX = (HDC + 31) / 32;       // 32-float (128-byte) boxes a row
  static constexpr int BOX_Q = BM * 128;             // bytes of a Q box
  static constexpr int BOX_K = BN * 128;             // bytes of a K or V box
  static constexpr int Q_BYTES = NBOX * BOX_Q;
  static constexpr int K_BYTES = NBOX * BOX_K;       // a K or V tile as it lands
  static constexpr int VT_BOX = HDC * 128;           // V^T: every dim's row of 32 keys
  static constexpr int VT_BYTES = BN / 32 * VT_BOX;
  // Q's small part: in shared memory, or in a cluster in the consumers'
  // registers; in a cluster, two slots of a tile's partial S (64 x BN f32)
  // that the peer CTA writes
  static constexpr int QS_BYTES = CLUSTER == 1 ? Q_BYTES : 0;
  static constexpr int X_BYTES = CLUSTER == 1 ? 0 : 64 * BN * 4;
  // Q, Q's small part; 2 stages of (K, K's small part); 2 of (V^T's big
  // part, its small part); 2 of V as it lands; the S slots; the barriers
  static constexpr int OFF_QS = Q_BYTES;
  static constexpr int OFF_K = Q_BYTES + QS_BYTES;
  static constexpr int OFF_VT = OFF_K + 4 * K_BYTES;
  static constexpr int OFF_V = OFF_VT + 4 * VT_BYTES;
  static constexpr int OFF_X = OFF_V + 2 * K_BYTES;
  static constexpr int OFF_BAR = OFF_X + 2 * X_BYTES;
  static constexpr int NBAR = CLUSTER == 1 ? 16 : 18;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * NBAR;
  // setmaxnreg at NC = 2: 3 x 168 registers a thread at launch = 2 x
  // consumer + producer; below hd 64 a consumer's O and S need fewer
  static constexpr int REGS_CONSUMER = HD <= 32 ? 216 : 232;
  static constexpr int REGS_PRODUCER = 3 * 168 - 2 * REGS_CONSUMER;
  static_assert(SMEM <= 232448, "a CTA's shared memory");
};

constexpr uint32_t TF32_MASK = 0xffffe000u;        // the 19 bits a tf32 keeps

__device__ __forceinline__ float tf32_small(float x) {
  return x - __uint_as_float(__float_as_uint(x) & TF32_MASK);
}

__device__ __forceinline__ float4 tf32_big4(float4 x) {
  return make_float4(__uint_as_float(__float_as_uint(x.x) & TF32_MASK),
                     __uint_as_float(__float_as_uint(x.y) & TF32_MASK),
                     __uint_as_float(__float_as_uint(x.z) & TF32_MASK),
                     __uint_as_float(__float_as_uint(x.w) & TF32_MASK));
}

// The small part of every f32 of a landed tile (Q or K), written at the same
// swizzled offset of `dst`: 16 bytes a thread at a time, a warp over 512
// consecutive bytes.
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* dst, const unsigned char* src, int t) {
#pragma unroll 4
  for (int off = t * 16; off < BYTES; off += 128 * 16) {
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    *reinterpret_cast<float4*>(dst + off) =
        make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z), tf32_small(x.w));
  }
}

// V^T's big and small parts from a landed V tile (keys x dims, 32-dim boxes
// under 128-byte swizzle) into rows of 32 keys a dim, one 128-byte-swizzled
// box per 32 keys.  Within each 8-key group the keys go in the order
// 0, 2, 4, 6, 1, 3, 5, 7: the order in which a thread's S accumulators
// (columns 2 tig, 2 tig + 1) sit in P's tf32 A fragment (columns tig,
// tig + 4), so that P enters P V without a shuffle.  A job of 8 lanes moves
// 4 keys x 4 dims of each lane (4 loads, 4 + 4 stores of 16 bytes); its
// lanes take 8 consecutive dim quads l of one box, key half (l1 ^ h) and
// group 2G + (l2 ^ q): the 8 lanes then hit 8 distinct 16-byte bank groups
// on every load and every store.
template <int HD>
__device__ __forceinline__ void transpose_v(unsigned char* vt_big, unsigned char* vt_small,
                                            const unsigned char* v, int t) {
  using C = Tf<HD>;
  constexpr int JOBS = C::NBOX * (C::BN / 16) * 4;
  const int l = t & 7;
#pragma unroll 1
  for (int job = t >> 3; job < JOBS; job += 16) {
    const int bx = job % C::NBOX, r = job / C::NBOX;
    const int dq = 8 * bx + l;                       // this lane's 4 dims 4 dq..4 dq + 3
    if (dq >= C::HDC / 4) continue;                  // the zero-filled end of hd 16 or 112
    const int half = ((l >> 1) & 1) ^ (r & 1);
    const int g = 2 * (r >> 2) + (((l >> 2) & 1) ^ ((r >> 1) & 1));
    float4 x[4];                                     // keys 8 g + 2 s + half
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int key = 8 * g + 2 * s + half;
      x[s] = *reinterpret_cast<const float4*>(v + bx * C::BOX_K + key * 128 +
                                              ((l ^ (key & 7)) << 4));
    }
    const int chunk = 2 * (g & 3) + half;            // slots 4 half .. 4 half + 3 of group g
    unsigned char* big_box = vt_big + (g >> 2) * C::VT_BOX;
    unsigned char* small_box = vt_small + (g >> 2) * C::VT_BOX;
    const float4 y[4] = {make_float4(x[0].x, x[1].x, x[2].x, x[3].x),
                         make_float4(x[0].y, x[1].y, x[2].y, x[3].y),
                         make_float4(x[0].z, x[1].z, x[2].z, x[3].z),
                         make_float4(x[0].w, x[1].w, x[2].w, x[3].w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * dq + i;
      const int off = d * 128 + ((chunk ^ (d & 7)) << 4);
      const float4 big = tf32_big4(y[i]);
      *reinterpret_cast<float4*>(big_box + off) = big;
      *reinterpret_cast<float4*>(small_box + off) =
          make_float4(y[i].x - big.x, y[i].y - big.y, y[i].z - big.z, y[i].w - big.w);
    }
  }
}

// S = Q K^T of one tile into s: Q_big K_small + Q_small K_big + Q_big K_big,
// HDC / 8 k-steps each (the CTA's head dims); step kk reads 8 columns of
// 32-column box kk / 4, 32 bytes into the swizzled row.  The first step
// ignores s's old value.  The tensor cores add each wgmma's products to the
// accumulators truncated (the tests' model: ref.tf32_product), so the small
// products go first, while the sum is small: added after the big one they
// cost two more truncations at its size (in that order, S and P V put the
// outputs of ref.large_output_inputs 1.7-2.1 times as far as the plain f32
// version from a float64 attention on an H100).
template <int HD>
__device__ __forceinline__ void issue_qk_tf32(float (&s)[Tf<HD>::BN / 8][4], uint32_t q,
                                              uint32_t q_small, uint32_t k, uint32_t k_small) {
  using C = Tf<HD>;
  float(&d)[C::BN / 2] = *reinterpret_cast<float(*)[C::BN / 2]>(&s[0][0]);
  const uint32_t as[3] = {q, q_small, q}, bs[3] = {k_small, k, k};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int kk = 0; kk < C::HDC / 8; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss_tf32<C::BN>(d, desc_sw128(as[p] + (kk / 4) * C::BOX_Q + off, 16, 1024),
                           desc_sw128(bs[p] + (kk / 4) * C::BOX_K + off, 16, 1024),
                           p > 0 || kk > 0);
    }
  }
}

// The same in a cluster, where Q's small part is in registers: qs holds it
// as tf32 A fragments, one an 8-column k-step, and Q_small K_big takes A
// from them.
template <int HD>
__device__ __forceinline__ void issue_qk_tf32(float (&s)[Tf<HD>::BN / 8][4], uint32_t q,
                                              const uint32_t (&qs)[Tf<HD>::HDC / 8][4],
                                              uint32_t k, uint32_t k_small) {
  using C = Tf<HD>;
  float(&d)[C::BN / 2] = *reinterpret_cast<float(*)[C::BN / 2]>(&s[0][0]);
#pragma unroll
  for (int kk = 0; kk < C::HDC / 8; ++kk) {
    const uint32_t off = (kk / 4) * C::BOX_Q + (kk % 4) * 32;
    wgmma_ss_tf32<C::BN>(d, desc_sw128(q + off, 16, 1024),
                         desc_sw128(k_small + (kk / 4) * C::BOX_K + (kk % 4) * 32, 16, 1024),
                         kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < C::HDC / 8; ++kk)
    wgmma_rs_tf32<C::BN>(d, qs[kk], desc_sw128(k + (kk / 4) * C::BOX_K + (kk % 4) * 32, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < C::HDC / 8; ++kk)
    wgmma_ss_tf32<C::BN>(d, desc_sw128(q + (kk / 4) * C::BOX_Q + (kk % 4) * 32, 16, 1024),
                         desc_sw128(k + (kk / 4) * C::BOX_K + (kk % 4) * 32, 16, 1024), 1);
}

// Q's small part as tf32 A fragments (a0..a3: rows gid, gid + 8 at columns
// tig, tig + 4 of each 8-column k-step), read from Q as it landed (32-float
// boxes of 64 rows under 128-byte swizzle) by a consumer thread of warp
// `warp`.
template <int HD>
__device__ __forceinline__ void load_q_small(uint32_t (&qs)[Tf<HD>::HDC / 8][4],
                                             const unsigned char* q, int warp, int gid, int tig) {
  using C = Tf<HD>;
#pragma unroll
  for (int kk = 0; kk < C::HDC / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 16 * warp + gid + 8 * (i & 1), col = 8 * kk + tig + 4 * (i >> 1);
      const int c = col % 32;
      const float x = *reinterpret_cast<const float*>(
          q + (col / 32) * C::BOX_Q + row * 128 + (((c / 4) ^ (row & 7)) << 4) + (c % 4) * 4);
      qs[kk][i] = __float_as_uint(tf32_small(x));
    }
  }
}

// P of each 8-key step as tf32 A fragments (a0..a3 = s[kk][0], s[kk][2],
// s[kk][1], s[kk][3]: keys 2 tig and 2 tig + 1 at columns tig and tig + 4),
// its big part (the top 19 bits) and its small part (the exact remainder).
template <int NB>
__device__ __forceinline__ void split_p_tf32(const float (&s)[NB][4], uint32_t (&pb)[NB][4],
                                             uint32_t (&ps)[NB][4]) {
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pb[kk][i] = __float_as_uint(a[i]) & TF32_MASK;
      ps[kk][i] = __float_as_uint(a[i] - __uint_as_float(pb[kk][i]));
    }
  }
}

// O += P V over one tile: P_big V_small + P_small V_big + P_big V_big, in
// that order as in S, one wgmma of N = the CTA's head dims a product and
// 8-key step (keys contiguous in V^T's rows).
template <int HD>
__device__ __forceinline__ void issue_pv_tf32(float (&acc)[Tf<HD>::HDC / 8][4],
                                              const uint32_t (&pb)[Tf<HD>::BN / 8][4],
                                              const uint32_t (&ps)[Tf<HD>::BN / 8][4],
                                              uint32_t vt_big, uint32_t vt_small) {
  using C = Tf<HD>;
  float(&d)[C::HDC / 2] = *reinterpret_cast<float(*)[C::HDC / 2]>(&acc[0][0]);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int kk = 0; kk < C::BN / 8; ++kk) {
      const uint32_t off = (kk / 4) * C::VT_BOX + (kk % 4) * 32;
      wgmma_rs_tf32<C::HDC>(d, p == 1 ? ps[kk] : pb[kk],
                            desc_sw128((p == 0 ? vt_small : vt_big) + off, 16, 1024));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Tf<HD>::THREADS, 1) fa_tf32_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, int Sq, int Sk, int nq,
    int nkv, int causal, int window, int q_offset, float scale_log2) {
  using C = Tf<HD>;
  constexpr int BN = C::BN, NB = BN / 8, NC = C::NC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* q_full = bars;        // Q has landed
  uint64_t* q_ready = bars + 1;   // Q's small part is written
  uint64_t* k_full = bars + 2;    // per stage: K has landed
  uint64_t* k_ready = bars + 4;   //   K's small part is written
  uint64_t* k_empty = bars + 6;   //   every consumer's S of that tile is done
  uint64_t* v_full = bars + 8;    //   V has landed
  uint64_t* v_free = bars + 10;   //   every converter thread has read it
  uint64_t* v_ready = bars + 12;  //   V^T's parts are written
  uint64_t* v_empty = bars + 14;  //   every consumer's P V of that tile is done
  uint64_t* x_full = bars + 16;   // in a cluster, per slot: the peer's partial S is in it

  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BM;   // longest causal rows first
  // in a cluster (C::CLUSTER consecutive CTAs along x) rank r takes the
  // head dims [r HDC, (r + 1) HDC)
  const int rank = blockIdx.x % C::CLUSTER, d0 = rank * C::HDC;
  const int h = blockIdx.x / C::CLUSTER, b = blockIdx.y, kvh = h / (nq / nkv);
  const int wg = threadIdx.x / 128;
  const int consumers = NC == 2 && q0 + 64 < Sq ? 2 : 1;

  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + C::BM, Sq) - 1;
  const int k_hi = causal ? min(Sk, qpos_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, qpos_first - window + 1) / BN * BN : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_ready, 128);
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(k_ready + s, 128);
      mbar_init(k_empty + s, consumers);
      mbar_init(v_full + s, 1);
      mbar_init(v_free + s, 128);
      mbar_init(v_ready + s, 128);
      mbar_init(v_empty + s, consumers);
      if constexpr (C::CLUSTER == 2) mbar_init(x_full + s, 1);
    }
    mbar_fence_init();
  }
  // in a cluster the peer's stores complete x_full: its barriers must
  // exist first
  if constexpr (C::CLUSTER == 2) cluster_sync();
  else __syncthreads();

  unsigned char* Qs = base;
  auto k_stage = [&](int s) { return base + C::OFF_K + s * 2 * C::K_BYTES; };
  auto vt_stage = [&](int s) { return base + C::OFF_VT + s * 2 * C::VT_BYTES; };
  auto v_stage = [&](int s) { return base + C::OFF_V + s * C::K_BYTES; };

  if (wg == NC) {
    // producer: one thread issues every copy; all 128 convert what lands
    if constexpr (NC == 2) regs_dec<C::REGS_PRODUCER>();
    const int t = threadIdx.x - 128 * NC;
    if (n_tiles == 0) {
      if constexpr (C::CLUSTER == 2) cluster_sync();   // the barrier at the end, below
      return;
    }
    auto load_k = [&](int it) {
      const int s = it & 1;
      mbar_arrive_expect_tx(k_full + s, C::K_BYTES);
      for (int bx = 0; bx < C::NBOX; ++bx)
        tma_load_4d(k_stage(s) + bx * C::BOX_K, &tk, k_full + s, d0 + 32 * bx, kvh,
                    k_lo + it * BN, b);
    };
    auto load_v = [&](int it) {
      const int s = it & 1;
      mbar_arrive_expect_tx(v_full + s, C::K_BYTES);
      for (int bx = 0; bx < C::NBOX; ++bx)
        tma_load_4d(v_stage(s) + bx * C::BOX_K, &tv, v_full + s, d0 + 32 * bx, kvh,
                    k_lo + it * BN, b);
    };
    if (t == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int bx = 0; bx < C::NBOX; ++bx)
        tma_load_4d(Qs + bx * C::BOX_Q, &tq, q_full, d0 + 32 * bx, h, q0, b);
      for (int it = 0; it < min(2, n_tiles); ++it) {
        load_k(it);
        load_v(it);
      }
    }
    if constexpr (C::CLUSTER == 1) {   // in a cluster the consumers split Q
      mbar_wait(q_full, 0);
      split_tile<C::Q_BYTES>(base + C::OFF_QS, Qs, t);
      fence_proxy_async_smem();
      mbar_arrive(q_ready);
    }
    // step j: K of tile j (its S is the consumers' next product), then V^T
    // of tile j - 1 (its P V goes with that S); then the copies of tile j + 1
    // into the stages tile j - 1 held
#pragma unroll 1
    for (int j = 0; j <= n_tiles; ++j) {
      if (j < n_tiles) {
        const int s = j & 1;
        mbar_wait(k_full + s, (j >> 1) & 1);
        split_tile<C::K_BYTES>(k_stage(s) + C::K_BYTES, k_stage(s), t);
        fence_proxy_async_smem();
        mbar_arrive(k_ready + s);
      }
      if (j > 0) {
        const int i = j - 1, s = i & 1;
        mbar_wait(v_full + s, (i >> 1) & 1);
        if (i >= 2) mbar_wait(v_empty + s, ((i >> 1) & 1) ^ 1);   // P V of tile i - 2 is done
        transpose_v<HD>(vt_stage(s), vt_stage(s) + C::VT_BYTES, v_stage(s), t);
        fence_proxy_async_smem();
        mbar_arrive(v_ready + s);
        mbar_arrive(v_free + s);
      }
      if (t == 0 && j > 0 && j + 1 < n_tiles) {
        const int s = (j + 1) & 1;
        const uint32_t parity = ((j - 1) >> 1) & 1;
        mbar_wait(k_empty + s, parity);             // S of tile j - 1 is done
        load_k(j + 1);
        mbar_wait(v_free + s, parity);              // V of tile j - 1 is converted
        load_v(j + 1);
      }
    }
  } else if (wg < consumers) {
    // consumer: 64 rows, S and O in the wgmma accumulators
    if constexpr (NC == 2) regs_inc<C::REGS_CONSUMER>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gid = lane / 4, tig = lane % 4;
    const int row0 = q0 + 64 * wg;
    const int qw_first = q_offset + row0;
    const int qw_last = q_offset + min(row0 + 64, Sq) - 1;
    const int qpos0 = qw_first + warp * 16 + gid, qpos1 = qpos0 + 8;
    const uint32_t q_addr = smem_addr(Qs) + wg * 64 * 128;
    const uint32_t qs_addr = q_addr + C::OFF_QS;
    const uint32_t k_addr = smem_addr(k_stage(0)), vt_addr = smem_addr(vt_stage(0));

    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, alpha0, alpha1;
    float acc[C::HDC / 8][4];
#pragma unroll
    for (int j = 0; j < C::HDC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    uint32_t pb[NB][4], ps[NB][4];      // P of the tile before, its big and small parts
    uint32_t qs[C::CLUSTER == 2 ? C::HDC / 8 : 1][4];   // in a cluster: Q's small part

    auto softmax_of = [&](float (&s)[NB][4], int it) {
      const int n0 = k_lo + it * BN;
      const bool masked = n0 + BN > Sk || (causal && n0 + BN - 1 > qw_first) ||
                          (window > 0 && n0 <= qw_last - window);
      if (masked) mask_tile<NB>(s, n0, Sk, causal, window, qpos0, qpos1, tig);
      online_softmax<NB>(s, m0, m1, l0, l1, alpha0, alpha1, scale_log2);
    };
    auto issue_qk = [&](float (&s)[NB][4], int st) {
      const uint32_t k = k_addr + st * 2 * C::K_BYTES;
      if constexpr (C::CLUSTER == 2) issue_qk_tf32<HD>(s, q_addr, qs, k, k + C::K_BYTES);
      else issue_qk_tf32<HD>(s, q_addr, qs_addr, k, k + C::K_BYTES);
    };
    // in a cluster, S of tile `it` is this CTA's partial, over its head
    // dims, plus the peer's: each sends its partial into the other's slot
    // it % 2 by st.async (16 bytes a thread and 8-column block, consecutive
    // threads on consecutive 16 bytes), whose bytes complete the other's
    // x_full as a TMA load's do, then adds the peer's partial to its own in
    // f32 (a + b = b + a: both CTAs hold the same S, so the same m, l and
    // P).  A slot is written again two tiles later, only after the peer has
    // the partial of the tile between, which this CTA sends after reading
    // the slot: no barrier frees a slot.
    auto send = [&](const float (&s)[NB][4], int it) {
      const uint32_t slot = smem_addr(base + C::OFF_X + (it & 1) * C::X_BYTES + t * 16);
      const uint32_t peer = cluster_map(slot, rank ^ 1);
      const uint32_t bar = cluster_map(smem_addr(x_full + (it & 1)), rank ^ 1);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        st_async(peer + j * 128 * 16, make_float4(s[j][0], s[j][1], s[j][2], s[j][3]), bar);
    };
    auto receive = [&](float (&s)[NB][4], int it) {
      if (t == 0) mbar_arrive_expect_tx(x_full + (it & 1), C::X_BYTES);
      mbar_wait(x_full + (it & 1), (it >> 1) & 1);
      const unsigned char* slot = base + C::OFF_X + (it & 1) * C::X_BYTES + t * 16;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(slot + j * 128 * 16);
        s[j][0] += x.x;
        s[j][1] += x.y;
        s[j][2] += x.z;
        s[j][3] += x.w;
      }
    };
    auto issue_pv = [&](int st) {
      const uint32_t vt = vt_addr + st * 2 * C::VT_BYTES;
      issue_pv_tf32<HD>(acc, pb, ps, vt, vt + C::VT_BYTES);
    };

    if (n_tiles > 0) {
      float s[NB][4];
      if constexpr (C::CLUSTER == 2) {
        mbar_wait(q_full, 0);
        load_q_small<HD>(qs, Qs, warp, gid, tig);
      } else {
        mbar_wait(q_ready, 0);
      }
      mbar_wait(k_ready, 0);
      wgmma_fence();
      issue_qk(s, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
      if (t == 0) mbar_arrive(k_empty);
      if constexpr (C::CLUSTER == 2) {
        send(s, 0);
        receive(s, 0);
      }
      softmax_of(s, 0);
      split_p_tf32<NB>(s, pb, ps);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it & 1, prev = st ^ 1;
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mbar_wait(k_ready + st, (it >> 1) & 1);
      // S of this tile, then O += P V of the tile before: S completes
      // first, and its softmax runs while the tensor cores do P V
      fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
      fence_regs(reinterpret_cast<float(&)[C::HDC / 2]>(acc));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 2]>(pb));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 2]>(ps));
      wgmma_fence();
      issue_qk(s, st);
      wgmma_commit();
      if constexpr (C::CLUSTER == 2) {
        // the partial goes to the peer between the two products (see the
        // note at the top)
        wgmma_wait<0>();
        fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
        if (t == 0) mbar_arrive(k_empty + st);
        send(s, it);
        mbar_wait(v_ready + prev, ((it - 1) >> 1) & 1);
        wgmma_fence();
        issue_pv(prev);
        wgmma_commit();
        receive(s, it);
      } else {
        mbar_wait(v_ready + prev, ((it - 1) >> 1) & 1);
        issue_pv(prev);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(reinterpret_cast<float(&)[BN / 2]>(s));
        if (t == 0) mbar_arrive(k_empty + st);
      }
      softmax_of(s, it);
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[C::HDC / 2]>(acc));
      if (t == 0) mbar_arrive(v_empty + prev);
      rescale<C::HDC / 8>(acc, alpha0, alpha1);
      split_p_tf32<NB>(s, pb, ps);
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) & 1;
      fence_regs(reinterpret_cast<float(&)[C::HDC / 2]>(acc));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 2]>(pb));
      fence_regs(reinterpret_cast<uint32_t(&)[BN / 2]>(ps));
      mbar_wait(v_ready + last, ((n_tiles - 1) >> 1) & 1);
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[C::HDC / 2]>(acc));
      if (t == 0) mbar_arrive(v_empty + last);
    }
    const long q_stride = (long)nq * HD;
    store_rows<C::HDC>(o + (long)b * Sq * q_stride + (long)h * HD + d0 + 2 * tig, acc, l0, l1,
                       row0 + warp * 16 + gid, Sq, q_stride);
  }
  // neither CTA of a cluster leaves while the other's stores into its
  // shared memory may be in flight
  if constexpr (C::CLUSTER == 2) cluster_sync();
}

template <int HD>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, float* o, int B, int Sq,
                        int Sk, int nq, int nkv, int causal, int window, int q_offset,
                        float scale, cudaStream_t stream) {
  using C = Tf<HD>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = tma_encode_bshd(&mq, q, sizeof(float), B, Sq, nq, HD, C::BM);
  if (err == cudaSuccess) err = tma_encode_bshd(&mk, k, sizeof(float), B, Sk, nkv, HD, C::BN);
  if (err == cudaSuccess) err = tma_encode_bshd(&mv, v, sizeof(float), B, Sk, nkv, HD, C::BN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::SMEM);
  if (err != cudaSuccess) return err;
  // at hd 256 clusters of two CTAs along x, one a (q head, batch, row block)
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(nq * C::CLUSTER, B, (Sq + C::BM - 1) / C::BM);
  cfg.blockDim = dim3(C::THREADS, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = C::CLUSTER > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, fa_tf32_kernel<HD>, mq, mk, mv, o, Sq, Sk, nq, nkv, causal,
                           window, q_offset, scale * LOG2E);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// One warpgroup, one tile: D = A I for a 64 x 8 f32 A and the 8 x 8 identity,
// A once from shared memory (K-major, 128-byte swizzle) and once from
// registers in the tf32 A fragment's layout.  D shows which of A's bits the
// tensor cores read; the two D agree when the fragment layout is the one
// the kernel assumes.
__global__ void __launch_bounds__(128, 1) tf32_probe_kernel(const float* __restrict__ a,
                                                           float* __restrict__ d_ss,
                                                           float* __restrict__ d_rs) {
  __shared__ __align__(16) unsigned char raw[1024 + 64 * 128 + 8 * 128];
  unsigned char* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    *reinterpret_cast<float*>(sm + r * 128 + (((c / 4) ^ (r & 7)) << 4) + (c % 4) * 4) = a[i];
  }
  if (t < 64) {
    const int n = t / 8, c = t % 8;
    *reinterpret_cast<float*>(sm + 64 * 128 + n * 128 + (((c / 4) ^ (n & 7)) << 4) + (c % 4) * 4) =
        n == c ? 1.f : 0.f;
  }
  fence_proxy_async_smem();
  __syncthreads();
  const uint64_t da = desc_sw128(smem_addr(sm), 16, 1024);
  const uint64_t db = desc_sw128(smem_addr(sm + 64 * 128), 16, 1024);
  const int warp = t / 32, gid = (t % 32) / 4, tig = t % 4;
  const int r0 = 16 * warp + gid, r1 = r0 + 8;
  const uint32_t af[4] = {__float_as_uint(a[r0 * 8 + tig]), __float_as_uint(a[r1 * 8 + tig]),
                          __float_as_uint(a[r0 * 8 + tig + 4]),
                          __float_as_uint(a[r1 * 8 + tig + 4])};
  float d[4], e[4] = {0.f, 0.f, 0.f, 0.f};
  wgmma_fence();
  wgmma_ss_tf32<8>(d, da, db, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  fence_regs(e);
  wgmma_fence();
  wgmma_rs_tf32<8>(e, af, db);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(e);
  const int c = 2 * tig;
  d_ss[r0 * 8 + c] = d[0]; d_ss[r0 * 8 + c + 1] = d[1];
  d_ss[r1 * 8 + c] = d[2]; d_ss[r1 * 8 + c + 1] = d[3];
  d_rs[r0 * 8 + c] = e[0]; d_rs[r0 * 8 + c + 1] = e[1];
  d_rs[r1 * 8 + c] = e[2]; d_rs[r1 * 8 + c + 1] = e[3];
}

}  // namespace tc

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int nq, int nkv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch_wgmma<HD>(static_cast<const T*>(q), static_cast<const T*>(k),
                                static_cast<const T*>(v), static_cast<T*>(o), B, Sq, Sk, nq,
                                nkv, causal, window, q_offset, scale, stream);
  else
    return tc::launch_tf32<HD>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), static_cast<float*>(o), B, Sq, Sk,
                               nq, nkv, causal, window, q_offset, scale, stream);
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

// The one-tile probe of how the tensor cores read f32 operands as tf32
// (tc::tf32_probe_kernel): a is 64 x 8 f32, d_ss and d_rs 64 x 8 f32 on
// the card.  Returns a cudaError_t.
extern "C" int fa_tf32_probe(const void* a, void* d_ss, void* d_rs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  tc::tf32_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(d_ss), static_cast<float*>(d_rs));
  return (int)cudaGetLastError();
}
