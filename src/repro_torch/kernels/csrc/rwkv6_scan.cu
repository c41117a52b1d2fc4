// RWKV-6 WKV recurrence for Hopper (sm_90a), f32 or bf16 in, f32 state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_chunked
// (body _rwkv_kernel).  For r, k, v, w (B,T,H,hd), a bonus u (H,hd) f32 and
// an initial state S (B,H,hd,hd) f32 (null = zeros), per head
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// returning o (in r's type) and the state after token T-1.  In chunks of
// C = 32 tokens, with P[t] = sum_{q<t} log2 w_q (an exclusive prefix per
// state row i) and L the chunk's length,
//   o_t = (r_t 2^P[t]) S_{c-1} + sum_{s<t} A[t,s] v_s + ((r_t u) . k_t) v_t,
//   A[t,s] = sum_i r_ti k_si 2^(P[t,i] - P[s+1,i]),
//   S_c = diag(2^P[L]) S_{c-1} + sum_{s<L} (k_s 2^(P[L] - P[s+1])) v_s^T.
// Every factor 2^(P[b] - P[a]) is formed as the running product of the
// decays w_a .. w_{b-1} (clamped at W_MIN), each <= 1: strong decay
// underflows to 0 instead of overflowing, and no factor is the ratio (the
// difference of two log prefixes) of two large numbers that would cancel.
// Pairs s >= t are never formed.  Rows past T load r = k = v = 0 and w = 1
// (by index: TMA fills them with w = 0, the strongest decay) and are not
// stored (the Pallas wrapper pads T on the host instead).
//
// What bounds it on this card: bytes.  A token costs 4 hd^2 operations per
// head against 5 hd elements moved (r, k, v, w in, o out) plus the state
// read once and written once per call: ~16 operations per byte in bf16 at
// hd 64, far below the H100's ~295.  rwkv6-1.6b's prefill (B=1, T=500,
// H=32, hd 64, bf16) moves 11.3 MB: 3.37 us at 3.35 TB/s; its training
// forward (B=4, T=128, f32) 23.1 MB: 6.89 us; its decode step (8 slots,
// T=1) 8.55 MB, nearly all of it state: 2.55 us.  What holds a call back
// is latency: few sequences at batch 1, the serial carry between chunks,
// and launches.
//
// T > 1, f32 and bf16: cl::scan_kernel, one launch, one thread-block
// cluster per (b, h) sequence (grid (R, H, B), cluster (R, 1, 1)).
//  - ranks: R CTAs, rank q owning a contiguous run of chunks (the first
//    NC % R ranks one more; ref.rwkv6_rank_runs).  rwkv6_scan.cluster_plan
//    picks R <= min(NC, R_MAX = 16) from the card's own count of clusters
//    it holds at once (cudaOccupancyMaxActiveClusters, active_clusters
//    below): among the R whose B H clusters fit in one wave, the fewest
//    chunks a rank, then the fewest ranks; where none fits, the fewest
//    waves x chunks a rank.  On an H100 the served prefill (B=1, T=500,
//    H=32: 32 clusters of 16 chunks) takes 8 ranks of 2 chunks (45
//    clusters of 8 at once in bf16), the f32 training forward (B=4, T=128:
//    128 clusters of 4 chunks) 2 ranks of 2 (132 at once).  The kernel is
//    instantiated twice: for one chunk a rank, whose pass 1 keeps the
//    chunk's tiles for pass 2, and for several; in bf16 up to hd 64 both
//    fit three CTAs to an SM (168 registers).
//  - loads: each chunk's r, k, v and w (C tokens x hd) land by TMA (tensor
//    maps over the (B, T, H, hd) tensors, 128-byte boxes under 128-byte
//    swizzle; hd 16 in one box, its end zero-filled) on one mbarrier.
//  - the chunk's terms on the SIMT units, one thread per (16-token
//    sub-chunk, state row i) holding its sub-chunk's r, k, w in registers
//    (chunk_terms): r 2^P[t], k 2^(P[L]-P[s+1]) and 2^P[L]; and A, factored
//    on five levels: a pair s < t lies in one block of 2h tokens (h = 16,
//    8, 4, 2, 1) with s below its middle e and t at or above it, and
//    A[t,s] = (r_t 2^(P[t]-P[e])) . (k_s 2^(P[e]-P[s+1])), both factors
//    <= 1.  Levels 16 to 2 write those rows (XOR-swizzled f32) and their
//    480 pairs are dot products over i, 2 x 2 pairs a thread (chunk_scores);
//    level 1's 16 pairs (factor 1) and the bonus (r_t u) . k_t, put on A's
//    diagonal, are summed over i by warp shuffles.
//  - products on the tensor cores, wgmma with tf32 operands and the
//    operands swapped so that M = hd value columns j (a chunk has 32
//    tokens, wgmma 64 rows; hd 16 and 32 pad to 64 rows of zeros): with
//    V^T (j x s) and the state S^T (j x i) as A operands in registers and
//    B operands written K-major into swizzled shared tiles,
//      (1) V^T A^T (the bonus term on A's diagonal) (N = 32 tokens, K = 32)
//      (2) S_{c-1}^T (r 2^P)^T                        (N = 32 tokens, K = hd)
//      (3) S_c^T = S_{c-1}^T diag(2^P[L]) + V^T (k 2^(P[L]-P[s+1]))
//                                                     (N = hd, K = 32 tokens),
//    o^T = (1) + (2), each from zero in accumulators of its own and added
//    in f32: the tensor cores truncate each wgmma's sum at the size of the
//    accumulator, and (2)'s 24 small-part steps added on top of (1) put
//    1e-4 on outputs of hd 128 (ref.rwkv6_cluster_reference's model).
//    The state lives in (3)'s accumulators, which (2) reads back as its A
//    fragments: a thread's accumulators hold columns 2 tig and 2 tig + 1
//    of each 8-column step and an A fragment columns tig and tig + 4, so
//    (r 2^P)^T keeps each 8 state rows in the order 0, 2, 4, 6, 1, 3, 5, 7
//    (rt_off), and no shuffle moves the state.
//  - precision: every f32 operand x enters as big = x rounded to the
//    nearest tf32 (its low 13 bits zero, so the tensor cores read it whole)
//    and small = x - big (exact, half a tf32 step of either sign), and each
//    product is big.small + small.big + big.big, the small ones first
//    because the tensor cores add each wgmma's sum truncated
//    (ref.tf32_product, big="round").  A truncated big part leaves
//    small.small with the sign of the product, a bias of ~2^-21 of the sum
//    of |products| (1.1e-5 on the tests' outputs); a rounded one does not.
//    bf16 r, k and v are their own tf32, so V^T's small part is 0 and its
//    product is skipped; A, the decayed k, r 2^P and the state are split in
//    both types, so a bf16 output is rounded once, from an f32-accurate
//    value.
//  - the carry, in two passes and two cluster barriers.  Pass 1: rank q
//    folds its run into its composite (D_q, dS_q) = (the product of its
//    chunks' 2^P[L], the run's state increment from zero) by (3), and
//    publishes it over its own tiles (D; S^T in the threads' own order, a
//    16-byte slot a float4 of a thread).  Barrier 1.  Rank q owns 1/R of
//    the state's slots (ref.rwkv6_carry_owners); for each, a thread reads
//    the 4 elements of s0 (0 where s0 is null) and every rank's composite
//    of them (mapa, ld.shared::cluster: R float4 and R float2 of D, all
//    issued before the first FMA, in groups of 8 ranks where one chunk a
//    rank holds (1) and (2) in registers), runs c_0 = s0, c_{p+1} = D_p
//    c_p + dS_p (fmaf, a serial chain as exact as the composites of a
//    scan), writes each c_p into rank p's carry-in buffer
//    (st.shared::cluster) and c_R to sT.  Barrier 2; each rank reads its
//    carry-in.  A rank moves hd^2 4 bytes in and as many out once (16 KB
//    each at hd 64), whatever R.  Pass 2: each rank walks its run from its carry-in,
//    (1) and (2) per chunk, (3) between chunks.  With one chunk a rank,
//    pass 1 also computes the chunk's A and (1), and rank 0 its (2) from
//    s0, so pass 2 is (2) alone (rank 0: nothing but the store).  R = 1:
//    no carry; one pass from s0 with (3) after every chunk, the last sT.
//    No state touches device memory but s0 in and sT out.
//  - s0 may alias sT (the served path updates the state in place): each
//    element of s0 is read and then written in sT by the same thread of its
//    owner rank, and rank 0 of one chunk a rank reads s0 for its (2)
//    before barrier 1, after which the owners write.
//  - shared memory: the chunk's working set in one region, which the
//    carry's two buffers overlay: the composite (peers read it between the
//    barriers) and, after it, the carry-in (peers write it between the
//    barriers); no rank writes the region again before barrier 2, after
//    which it reads its carry-in first, and one chunk a rank keeps r 2^P's
//    parts for pass 2 outside both.  bf16 at hd 64 is 73,728 bytes a CTA,
//    74,752 with the 1 KB the SM reserves: three an SM (224,256 of
//    233,472); f32 86,016 (two); at hd 128 two warpgroups, one per 64
//    value columns.
//  - where the time goes (chip_scan_phases.py, median cycles of a CTA on
//    an H100 at 700 W): at the served bf16 prefill the 32 clusters of 8
//    run in one wave (256 CTAs on 124 SMs, a CTA 23.4 us, the last done
//    29.3 us after the first starts; 35.6 us in CUDA events).  Of ~42,400
//    cycles, pass 1 over two chunks (copies, terms, (3)) takes 9,011, the
//    carry 8,905 (publish 441, barrier 1 1,379, transfer 4,634, barrier 2
//    2,247, carry-in 204), pass 2 over two chunks 24,319 (copies and terms
//    again, (2), (3), A, (1)).  At 16 ranks of one chunk (two waves) the
//    carry took 13,560 of a CTA's cycles and its first barrier 4,853: a
//    rank waits for the slowest of more peers.
//
// T = 1 (every decode step), f32 and bf16: decode::decode_kernel, no chunk
//  machinery.  Per (b, h): o_j = sum_i r_i (S_ij + u_i k_i v_j) and
//  S'_ij = w_i S_ij + k_i v_j.  Each thread owns 16-byte column quads of a
//  few state rows and issues every load before it computes (16-64 bytes of
//  state in flight per thread, grid (H, B)), writes S' over them in place,
//  and o is reduced over rows by shuffles and a 1-4 KB shared-memory pass.
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "common.cuh"

// Phase stamps of the T > 1 kernel for a timing probe (chip_scan_phases.py
// defines it to record clock64 at each phase's end); empty in the library.
#ifndef RWKV6_STAMP
#define RWKV6_STAMP(k)
#endif

// Every kernel of this library is in namespace rwkv6, so that a profile
// finds them all by that prefix of their names.
namespace rwkv6 {

constexpr int C = 32;             // tokens per chunk
// the smallest decay, as the TPU kernel clamps it (log2 w finite at w = 0)
constexpr float W_MIN = 1e-38f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// T > 1: one launch over a cluster per sequence.
// ---------------------------------------------------------------------------
namespace cl {

using bf16 = __nv_bfloat16;
constexpr int E = C / 2;                  // the sub-chunk edge
constexpr int R_MAX = 16;                 // ranks of a cluster at most (above 8: non-portable)
constexpr uint32_t TF32_MASK = 0xffffe000u;   // the 19 bits a tf32 keeps
constexpr int BOX = C * 128;              // bytes of a 128-byte-wide box of C rows

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Levels of A's factoring: a pair s < t lies in exactly one block of 2h
// tokens (h = 16, 8, 4, 2, 1) with s below the block's middle e and t at or
// above it, and A[t,s] = (r_t 2^(P[t]-P[e])) . (k_s 2^(P[e]-P[s+1])): row t
// of level h holds the first factor where t is in an upper half and row s
// the second where s is in a lower half; 16 h pairs a level, 496 in all.
// Levels 16 to 2 keep rows (LEVELS); level 1's 16 pairs (t = 2 m + 1,
// s = 2 m, factor 1) are summed over the columns by shuffles.
constexpr int LEVELS = 4;
constexpr int PAIRS = 16 * (E + E / 2 + E / 4 + E / 8);   // 480 from rows
constexpr int PAIRS1 = E;                                  // 16 of level 1

// Shared-memory layout, byte offsets from a 1024-byte aligned base (the
// swizzle's atom).  Live through the scan: r 2^P in f32 (its big part
// after the scan), u, the decays, partial sums of the bonus and of level 1.
// Then one region:
//   v; r, k and w as they land | the decayed k^T's parts | A's parts and A
//   in f32; A's level rows; r 2^P's small part
// or, during the carry, the composite and the carry-in (below r 2^P's
// small part, which one chunk a rank keeps for pass 2).
template <typename T, int HD>
struct Cfg {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int BOXC = 128 / ES;                 // columns of a box
  static constexpr int NBOX = (HD * ES + 127) / 128;    // boxes a row
  static constexpr int TILE = NBOX * BOX;               // a (C, HD) tile as TMA lands it
  static constexpr int NWG = HD > 64 ? 2 : 1;           // warpgroups: 64 value columns each
  static constexpr int NT = 128 * NWG;
  static constexpr int RT_PART = (HD + 31) / 32 * BOX;  // r 2^P: C rows, K-major over hd
  static constexpr int KT_PART = HD * 128;              // decayed k^T: hd rows, K-major over C
  static constexpr int AT_PART = BOX;                   // A: C rows, K-major over C
  static constexpr int AF_BYTES = (4 * C * (C + 1) + 1023) / 1024 * 1024;
  static constexpr int cmax(int a, int b) { return a > b ? a : b; }
  static constexpr int RT = 0;                          // r 2^P f32, then its big part
  static constexpr int U = RT + RT_PART;                // f32 [HD]
  static constexpr int DC = U + 4 * HD;                 // this chunk's 2^P[L] [HD]
  static constexpr int DR = DC + 4 * HD;                // the run's decay so far [HD]
  static constexpr int TOTP = DR + 4 * HD;              // sub-chunk products of w [2][HD]
  static constexpr int NWA = (2 * HD + 31) / 32;        // warps of the column threads
  static constexpr int BONP = TOTP + 8 * HD;            // the bonus a warp [NWA][C]
  static constexpr int L1P = BONP + 4 * C * NWA;        // level 1's pairs a warp [NWA][C]
  static constexpr int BAR = L1P + 4 * C * NWA;         // the copies' mbarrier
  static constexpr int REGION = (BAR + 8 + 1023) / 1024 * 1024;
  static constexpr int V = REGION;
  static constexpr int R = V + TILE, K = R + TILE, W = K + TILE, KT = R;
  static constexpr int AT = R, AF = R + 2 * AT_PART;
  static constexpr int X = R + cmax(cmax(3 * TILE, 2 * KT_PART), 2 * AT_PART + AF_BYTES);
  // the carry's two buffers over the chunk's working set: the composite,
  // D [HD] then S^T as the threads hold it (float4 k of thread x at
  // [k][x]), and the carry-in, S^T alone in the same order
  static constexpr int XBUF = 4 * (HD + NT * HD / 2);
  static constexpr int COMP = REGION;
  static constexpr int CARRY = COMP + XBUF;
  // level rows f32 [LEVELS][C][HD]; then r 2^P's small part, which the
  // chunk's terms use first for k times the decays after it in its
  // sub-chunk (KL, f32 [C][HD]), clear of both carry buffers
  static constexpr int RTS = (cmax(X + 4 * LEVELS * C * HD, CARRY + 4 * NT * HD / 2) + 1023) / 1024 * 1024;
  static constexpr int KL = RTS;
  static constexpr int END = RTS + RT_PART;
  static constexpr size_t SMEM = 1024 + END;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static_assert(RT % 1024 == 0 && V % 1024 == 0 && R % 1024 == 0 && AT % 1024 == 0 &&
                    RTS % 1024 == 0, "wgmma operands and TMA boxes on the swizzle's atom");
  static_assert(X % 16 == 0 && XBUF % 16 == 0, "16-byte aligned f32 tiles");
};

// Byte offset of f32 element (row, col < 32) of a K-major wgmma operand:
// rows of 128 bytes under 128-byte swizzle, as desc_sw128 reads them.
__device__ __forceinline__ int sw(int row, int col) {
  return row * 128 + (((col >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// Column i of row t of a level row tile (rows of HD f32, no padding): 16-byte
// quads XOR-swizzled by the row, so that the float4 reads of a warp over 8
// rows at one column fall in distinct banks.
template <int HD>
__device__ __forceinline__ int xpos(int t, int i) {
  return t * HD + (i ^ (((t & 7) << 2) & (HD - 1)));
}

// Element (t, i) of a (C, HD) input tile as TMA landed it, as f32.
template <typename T, int HD>
__device__ __forceinline__ float at(const unsigned char* tile, int t, int i) {
  using G = Cfg<T, HD>;
  const int cb = (i % G::BOXC) * G::ES;
  return to_f(*reinterpret_cast<const T*>(tile + (i / G::BOXC) * BOX + t * 128 +
                                          (((cb >> 4) ^ (t & 7)) << 4) + (cb & 15)));
}

// Column i of r 2^P in its tile: 32-column boxes, and inside each 8-column
// k-step the order 0, 2, 4, 6, 1, 3, 5, 7, in which the state's
// accumulators (columns 2 tig, 2 tig + 1) sit in a tf32 A fragment
// (columns tig, tig + 4).
__device__ __forceinline__ int rt_off(int t, int i) {
  const int c = i % 32, m = c % 8;
  return (i / 32) * BOX + sw(t, (c & ~7) + (m & 1) * 4 + (m >> 1));
}

// x's tf32 big part rounded to nearest (ties away from zero: its low 13
// bits then zero, so the tensor cores read it whole) and the remainder,
// exact in f32 and at most half a tf32 step of either sign
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}
__device__ __forceinline__ uint32_t tf32_small(float x) {
  return __float_as_uint(x - __uint_as_float(tf32_big(x)));
}

// x as its tf32 big part and the exact remainder, into two tiles `part`
// bytes apart
__device__ __forceinline__ void put_split(unsigned char* big, int part, int off, float x) {
  const float b = __uint_as_float(tf32_big(x));
  *reinterpret_cast<float*>(big + off) = b;
  *reinterpret_cast<float*>(big + part + off) = x - b;
}

// quad p of A's pairs from rows: its level and its first t and s (level
// h's 4 h quads of 2 x 2 pairs, block by block, each block's rows in pairs)
__device__ __forceinline__ void quad_of(int p, int& lvl, int& t, int& s) {
  lvl = 0;
  int h = E;
  while (p >= 4 * h) {
    p -= 4 * h;
    h /= 2;
    ++lvl;
  }
  const int hq = h / 2, b = p / (hq * hq), r = p % (hq * hq);
  t = 2 * h * b + h + 2 * (r / hq);
  s = 2 * h * b + 2 * (r % hq);
}

// Rows of level H for one sub-chunk's column i (H <= 8: its blocks of 2H
// tokens lie inside the sub-chunk): upper halves r scaled from the block's
// middle, lower halves k scaled to it.
template <int H, int HD>
__device__ __forceinline__ void level_rows(float* xl, const float (&r)[E], const float (&k)[E],
                                           const float (&w)[E], int t0, int i) {
#pragma unroll
  for (int b0 = 0; b0 < E; b0 += 2 * H) {
    float f = 1.f;
#pragma unroll
    for (int m = 0; m < H; ++m) {
      const int q = b0 + H + m;
      xl[xpos<HD>(t0 + q, i)] = r[q] * f;
      f *= w[q];
    }
    f = 1.f;
#pragma unroll
    for (int m = 0; m < H; ++m) {
      const int q = b0 + H - 1 - m;
      xl[xpos<HD>(t0 + q, i)] = k[q] * f;
      f *= w[q];
    }
  }
}

// Sums over the columns of a 16-slot vector, for a warp whose column
// threads are W = min(32, HD) lanes of one sub-chunk (HD 16: lanes 0-15 and
// 16-31 are the two sub-chunks): four halvings, in each a lane keeps the
// half of its slots that its lane bit names and adds its partner's copy of
// them; then, for W = 32, the pair of lanes that share a slot add.  Returns
// slot slot16(lane)'s sum over the group's lanes.
template <int N, int BIT>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = lane & BIT;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float give = upper ? v[q] : v[q + N];
    const float keep = upper ? v[q + N] : v[q];
    v[q] = keep + __shfl_xor_sync(FULL, give, BIT);
  }
}

template <int W>
__device__ __forceinline__ float fold16(float (&v)[16], int lane) {
  halve<8, W / 2>(v, lane);
  halve<4, W / 4>(v, lane);
  halve<2, W / 8>(v, lane);
  halve<1, W / 16>(v, lane);
  return W == 32 ? v[0] + __shfl_xor_sync(FULL, v[0], 1) : v[0];
}

template <int W>
__device__ __forceinline__ int slot16(int lane) {
  return W == 32 ? (lane >> 1) & 15 : lane & 15;
}

// The chunk's terms from its tiles as they landed, by one thread per
// (sub-chunk, column i) that holds the sub-chunk's r, k and w (clamped at
// W_MIN; 1 for rows >= L, which TMA filled with w = 0, the strongest decay)
// in registers.  Every factor is a running product of the decays between
// its two ends, each <= 1, never a ratio of two prefixes.
//  1. the product of the sub-chunk's w into TOTP; k_s times the decays
//     after s inside its sub-chunk into KL (f32); with_r, r_t times the
//     decays before t inside its sub-chunk into RT (f32), the rows of
//     levels 16 to 2 into X, and the bonus (r_t u) . k_t and level 1's
//     pairs summed over a warp's columns into BONP and L1P;
//  2. after a barrier, by the same threads from shared memory: sub-chunk
//     0's k times sub-chunk 1's product, every k_s 2^(P[L]-P[s+1]) split
//     into the decayed-k^T tile's parts (row i, column s), 2^P[L] into DC;
//     with_r, sub-chunk 1's r 2^P times sub-chunk 0's product, in place.
template <typename T, int HD>
__device__ __forceinline__ void chunk_terms(const unsigned char* Rs, const unsigned char* Ks,
                                            const unsigned char* Ws, const float* US, float* X,
                                            float* BONP, float* L1P, float* TOTP, float* RT,
                                            float* KL, unsigned char* KT, float* DC, int L,
                                            bool with_r, int tid) {
  using G = Cfg<T, HD>;
  constexpr int W = HD < 32 ? HD : 32;
  const bool active = tid < 2 * HD;     // whole warps: 2 HD is a multiple of 32
  const int seg = tid / HD, i = tid % HD, t0 = seg * E, lane = tid % 32;
  auto rt_at = [&](int t) -> float& {
    return *reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(RT) + rt_off(t, i));
  };
  if (active) {
    float r[E], k[E], w[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int t = t0 + q;
      w[q] = t < L ? fmaxf(at<T, HD>(Ws, t, i), W_MIN) : 1.f;
      k[q] = at<T, HD>(Ks, t, i);
      r[q] = with_r ? at<T, HD>(Rs, t, i) : 0.f;
    }
    float f = 1.f;
#pragma unroll
    for (int q = E - 1; q >= 0; --q) {
      KL[(t0 + q) * HD + i] = k[q] * f;
      f *= w[q];
    }
    TOTP[seg * HD + i] = f;
    if (with_r) {
      f = 1.f;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        rt_at(t0 + q) = r[q] * f;
        f *= w[q];
      }
      // level 16: the chunk's halves are the sub-chunks
      f = 1.f;
      if (seg == 1) {
#pragma unroll
        for (int q = 0; q < E; ++q) {
          X[xpos<HD>(E + q, i)] = r[q] * f;
          f *= w[q];
        }
      } else {
#pragma unroll
        for (int q = E - 1; q >= 0; --q) {
          X[xpos<HD>(q, i)] = k[q] * f;
          f *= w[q];
        }
      }
      level_rows<8, HD>(X + 1 * C * HD, r, k, w, t0, i);
      level_rows<4, HD>(X + 2 * C * HD, r, k, w, t0, i);
      level_rows<2, HD>(X + 3 * C * HD, r, k, w, t0, i);
      // the bonus (token t0 + q in slot q) and level 1's pairs (t = t0 + 2 m
      // + 1 in slot m), each summed over the group's columns
      const float ui = US[i];
      float v[16];
#pragma unroll
      for (int q = 0; q < E; ++q) v[q] = r[q] * ui * k[q];
      float sum = fold16<W>(v, lane);
      const int slot = slot16<W>(lane), row = (tid / 32) * C + t0;
      if (W == 16 || (lane & 1) == 0) BONP[row + slot] = sum;
#pragma unroll
      for (int m = 0; m < E; ++m) v[m] = m < E / 2 ? r[2 * m + 1] * k[2 * m] : 0.f;
      sum = fold16<W>(v, lane);
      if ((W == 16 || (lane & 1) == 0) && slot < E / 2) L1P[row + slot] = sum;
    }
  }
  __syncthreads();
  if (active) {
    const float other = TOTP[(1 - seg) * HD + i];
    float f = seg == 0 ? other : 1.f;
#pragma unroll 4
    for (int q = 0; q < E; ++q) put_split(KT, G::KT_PART, sw(i, t0 + q), KL[(t0 + q) * HD + i] * f);
    if (seg == 0) DC[i] = TOTP[i] * other;
    if (with_r && seg == 1) {
#pragma unroll 4
      for (int q = 0; q < E; ++q) rt_at(t0 + q) *= other;
    }
  }
}

// A from the level rows: each of their 480 pairs a dot product over the
// columns in f32, level 1's 16 pairs and the bonus (on the diagonal)
// summed over the warps of their sub-chunk, so that (1) adds the bonus term
// (r_t u . k_t) v_t; then A's tile parts (zero above the diagonal).
template <typename T, int HD>
__device__ __forceinline__ void chunk_scores(const float* X, const float* BONP, const float* L1P,
                                             float* AF, unsigned char* AT, int tid) {
  using G = Cfg<T, HD>;
  constexpr int WPS = HD < 32 ? 1 : HD / 32;     // warps of a sub-chunk's columns
  // partial sums of token (or pair) row x of sub-chunk seg, over its warps
  auto warp_sum = [&](const float* P, int seg, int x) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < WPS; ++m) acc += P[(HD < 32 ? 0 : seg * WPS + m) * C + x];
    return acc;
  };
  // a task: 2 x 2 pairs (rows t, t + 1 against s, s + 1) of one level's
  // block, so that each row read serves two pairs
  for (int p = tid; p < PAIRS / 4 + PAIRS1 + C; p += G::NT) {
    if (p < PAIRS / 4) {
      int lvl, t, s;
      quad_of(p, lvl, t, s);
      const float* xl = X + lvl * C * HD;
      float acc[2][2][2] = {};
#pragma unroll 2
      for (int c = 0; c < HD; c += 4) {
        float4 a[2], b[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m] = *reinterpret_cast<const float4*>(xl + xpos<HD>(t + m, c));
          b[m] = *reinterpret_cast<const float4*>(xl + xpos<HD>(s + m, c));
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            acc[m][n][0] = fmaf(a[m].x, b[n].x, fmaf(a[m].y, b[n].y, acc[m][n][0]));
            acc[m][n][1] = fmaf(a[m].z, b[n].z, fmaf(a[m].w, b[n].w, acc[m][n][1]));
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) AF[(t + m) * (C + 1) + s + n] = acc[m][n][0] + acc[m][n][1];
    } else if (p < PAIRS / 4 + PAIRS1) {
      const int m = p - PAIRS / 4, seg = m / (E / 2);     // pair (2 m + 1, 2 m)
      AF[(2 * m + 1) * (C + 1) + 2 * m] = warp_sum(L1P, seg, seg * E + m % (E / 2));
    } else {
      const int t = p - PAIRS / 4 - PAIRS1;
      AF[t * (C + 1) + t] = warp_sum(BONP, t / E, t);
    }
  }
  __syncthreads();
  RWKV6_STAMP(15);
  for (int e = tid; e < C * C; e += G::NT) {
    const int t = e / C, s = e % C;
    put_split(AT, G::AT_PART, sw(t, s), s <= t ? AF[t * (C + 1) + s] : 0.f);
  }
}

// d += V^T B over the C tokens: V_big B_small + V_small B_big + V_big B_big
// (the small products first; V_small B_big skipped where V is exact in
// tf32, bf16), B K-major over the tokens with its parts `part` bytes apart.
// V^T's tf32 A fragments are formed from V's tile a part at a time (16
// registers): a0..a3 of k-step kk = rows j, j + 8 at columns (tokens)
// 8 kk + tig, + 4; rows past HD are zero (hd 16 and 32 pad the 64 rows of
// a wgmma).  Each part's products are waited for before the next part's
// fragments overwrite them.
template <typename T, int HD, int N>
__device__ __forceinline__ void issue_v(float (&d)[N / 2], const unsigned char* Vs, int j, int tig,
                                        uint32_t b_big, int part) {
  constexpr bool EXACT_V = std::is_same<T, bf16>::value;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    if (EXACT_V && p == 1) continue;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = j + 8 * (e & 1), s = 8 * kk + tig + 4 * (e >> 1);
        const float x = row < HD ? at<T, HD>(Vs, s, row) : 0.f;
        a[kk][e] = p == 1 ? tf32_small(x) : tf32_big(x);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tf32<N>(d, a[kk], desc_sw128(b_big + (p == 0 ? part : 0) + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
  }
}

// o += S^T (r 2^P)^T over the HD state rows, the three products in
// order, each from the part of the state it needs: a0..a3 of k-step kk are
// the accumulators 4 kk, 4 kk + 2, 4 kk + 1, 4 kk + 3 (rt_off's order);
// r 2^P's small part is `part` bytes after its big part.
// Waits for the products.  At most 4 k-steps' fragments (16 registers) are
// held at once.
template <int HD>
__device__ __forceinline__ void issue_state(float (&o)[16], const float (&S)[HD / 2],
                                            uint32_t rt_big, int part) {
  constexpr int KG = HD / 8 < 4 ? HD / 8 : 4;     // k-steps a group
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int g = 0; g < HD / 8; g += KG) {
      uint32_t a[KG][4];
#pragma unroll
      for (int m = 0; m < KG; ++m) {
        const int kk = g + m;
        const float x[4] = {S[4 * kk], S[4 * kk + 2], S[4 * kk + 1], S[4 * kk + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) a[m][e] = p == 1 ? tf32_small(x[e]) : tf32_big(x[e]);
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < KG; ++m) {
        const int kk = g + m;
        wgmma_rs_tf32<32>(o, a[m], desc_sw128(rt_big + (p == 0 ? part : 0) + (kk / 4) * BOX +
                                                  (kk % 4) * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
  }
}

// The state S^T in (3)'s accumulators of a thread: element e at row j0 + 8
// ((e / 2) % 2) (a value column j) and column 8 (e / 4) + 2 tig + e % 2 (a
// state row i).
__device__ __forceinline__ int row_of(int j0, int e) { return j0 + 8 * ((e / 2) % 2); }
__device__ __forceinline__ int col_of(int tig, int e) { return 8 * (e / 4) + 2 * tig + e % 2; }

// Offset of this thread's element e of S^T in the (i, j) state from the
// thread's base s_base + 2 tig HD + j0: a compile-time constant
template <int HD>
__device__ __forceinline__ int state_off(int e) {
  return (8 * (e / 4) + e % 2) * HD + 8 * ((e / 2) % 2);
}

// S^T = s0^T (zeros where s0 is null), this thread's elements
template <int HD>
__device__ __forceinline__ void load_state(float (&S)[HD / 2], const float* s0, long s_base,
                                          int j0, int tig) {
  const float* p = s0 + s_base + 2 * tig * HD + j0;
#pragma unroll
  for (int e = 0; e < HD / 2; ++e)
    S[e] = s0 != nullptr && row_of(j0, e) < HD ? p[state_off<HD>(e)] : 0.f;
}

// sT = S^T's transpose, this thread's elements
template <int HD>
__device__ __forceinline__ void store_state(float* sT, long s_base, const float (&S)[HD / 2],
                                           int j0, int tig) {
  float* p = sT + s_base + 2 * tig * HD + j0;
#pragma unroll
  for (int e = 0; e < HD / 2; ++e)
    if (row_of(j0, e) < HD) p[state_off<HD>(e)] = S[e];
}

// S^T's columns i times D[i] (DC, this chunk's 2^P[L])
template <int HD>
__device__ __forceinline__ void decay_state(float (&S)[HD / 2], const float* DC, int tig) {
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) S[e] *= DC[col_of(tig, e)];
}

// (D, S^T) into the composite buffer x: D; S^T as the threads hold it,
// float4 k of thread `tid` at [k][tid] (a slot), so that the carry's
// owners read 16 bytes a load, a warp's over 512 consecutive bytes
template <int HD, int NT>
__device__ __forceinline__ void publish(float* x, const float (&S)[HD / 2], const float* DR,
                                        int tid) {
  for (int i = tid; i < HD; i += NT) x[i] = DR[i];
#pragma unroll
  for (int k4 = 0; k4 < HD / 8; ++k4)
    *reinterpret_cast<float4*>(x + HD + 4 * (k4 * NT + tid)) =
        make_float4(S[4 * k4], S[4 * k4 + 1], S[4 * k4 + 2], S[4 * k4 + 3]);
}

// x + diag(D) y over S^T's columns, on a slot (columns i, i + 1)
__device__ __forceinline__ float4 fold_in(float4 x, float4 y, float d0, float d1) {
  return make_float4(fmaf(d0, y.x, x.x), fmaf(d1, y.y, x.y), fmaf(d0, y.z, x.z),
                     fmaf(d1, y.w, x.w));
}

// The carry's slots: float4 k4 of thread t holds S^T at rows j = j0(t), j0
// + 8 and columns i = 8 k4 + 2 (t % 4), i + 1, that is the state's
// elements (i, j), (i + 1, j), (i, j + 8), (i + 1, j + 8).  Only threads
// t < TV hold rows below HD (hd 16 and 32 pad wgmma's 64 rows), so the
// state is NV slots, slot v being float4 v / TV of thread v % TV; rank q
// owns slots [q NV / R, (q + 1) NV / R) (ref.rwkv6_carry_owners).
template <int HD, int NT>
struct Slots {
  static constexpr int TV = NT < 2 * HD ? NT : 2 * HD;
  static constexpr int NV = HD / 8 * TV;
};

// Rank q's share of the carry, between the two cluster barriers.  For each
// slot it owns, SB slots at a time: the state's four elements c_0 = s0 (0
// where s0 is null), then for the ranks p in groups of G, every rank's
// composite (D_p, dS_p) of them (ld.shared::cluster, the group's all issued
// before its first FMA; one group where R <= G), c_{p+1} = D_p c_p + dS_p
// (one fmaf each), c_p stored into rank p's carry-in buffer
// (st.shared::cluster); c_R into sT.  The same thread reads an element of
// s0 and then writes it in sT, so s0 may alias sT.
template <int HD, int NT, int G, int SB>
__device__ __forceinline__ void carry_share(int q, int R, uint32_t comp, uint32_t carry,
                                            const float* s0, float* sT, long s_base, int tid) {
  using SL = Slots<HD, NT>;
  const int lo = q * SL::NV / R, hi = (q + 1) * SL::NV / R;
  for (int v0 = lo + tid; v0 < hi; v0 += SB * NT) {
    float4 c[SB];
    int off[SB], col[SB];         // a slot's place in the threads' order, its column i
    long at[SB];                  // its element (i, j) in the state
#pragma unroll
    for (int m = 0; m < SB; ++m) {
      const int v = v0 + m * NT, k4 = v / SL::TV, t = v % SL::TV, lane = t % 32;
      col[m] = v < hi ? 8 * k4 + 2 * (lane % 4) : -1;
      off[m] = k4 * NT + t;
      at[m] = s_base + (long)col[m] * HD + 16 * (t / 32) + lane / 4;
      const float* p = s0 + at[m];
      c[m] = col[m] >= 0 && s0 != nullptr ? make_float4(p[0], p[HD], p[8], p[HD + 8])
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int g0 = 0; g0 < R; g0 += G) {
      float4 ds[SB][G];
      float2 dd[SB][G];
#pragma unroll
      for (int m = 0; m < SB; ++m) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g0 + g < R && col[m] >= 0) {
            const uint32_t peer = cluster_map(comp, g0 + g);
            ds[m][g] = ld_cluster4(peer + 4 * (HD + 4 * off[m]));
            dd[m][g] = ld_cluster2(peer + 4 * col[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < SB; ++m) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g0 + g < R && col[m] >= 0) {
            st_cluster(cluster_map(carry, g0 + g) + 16 * off[m], c[m]);
            c[m] = fold_in(ds[m][g], c[m], dd[m][g].x, dd[m][g].y);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < SB; ++m) {
      if (col[m] >= 0) {
        float* p = sT + at[m];
        p[0] = c[m].x;
        p[HD] = c[m].y;
        p[8] = c[m].z;
        p[HD + 8] = c[m].w;
      }
    }
  }
}

__device__ __forceinline__ void zero16(float (&x)[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) x[e] = 0.f;
}

// CTAs an SM holds of the kernel in bf16 up to hd 64: three, their
// registers capped at 168 to match (rwkv6-1.6b's served prefill then runs
// 8 ranks of 2 chunks, 256 CTAs, in one wave)
template <typename T, int HD, bool ONE>
__host__ __device__ constexpr int min_ctas() {
  return std::is_same<T, __nv_bfloat16>::value && HD <= 64 ? 3 : 1;
}

// S^T = this rank's carry-in as the owners wrote it (threads' order; zeros
// in the rows past HD that hd 16 and 32 pad)
template <int HD, int NT>
__device__ __forceinline__ void load_carry(float (&S)[HD / 2], const float* x, int tid) {
#pragma unroll
  for (int k4 = 0; k4 < HD / 8; ++k4) {
    const float4 c = tid < Slots<HD, NT>::TV
                         ? *reinterpret_cast<const float4*>(x + 4 * (k4 * NT + tid))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    S[4 * k4] = c.x;
    S[4 * k4 + 1] = c.y;
    S[4 * k4 + 2] = c.z;
    S[4 * k4 + 3] = c.w;
  }
}

// One CTA of a cluster of R = gridDim.x ranks over sequence (b = blockIdx.z,
// h = blockIdx.y); rank q = blockIdx.x.  ONE: every rank has one chunk
// (ceil(T / C) == R), and pass 1's tiles serve pass 2.  R = 1: one pass
// over the chunks from s0, (3) after each one, no carry.
template <typename T, int HD, bool ONE>
__global__ void __launch_bounds__(Cfg<T, HD>::NT, (min_ctas<T, HD, ONE>())) scan_kernel(
    const __grid_constant__ CUtensorMap tr, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tw,
    const float* __restrict__ u,
    const float* s0,              // may alias sT: every element is read before it is written
    float* sT, T* __restrict__ o, int Tn, int H) {
  using G = Cfg<T, HD>;
  constexpr int NT = G::NT, NS = HD / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* RT = reinterpret_cast<float*>(base + G::RT);
  float* US = reinterpret_cast<float*>(base + G::U);
  float* DC = reinterpret_cast<float*>(base + G::DC);
  float* DR = reinterpret_cast<float*>(base + G::DR);
  float* TOTP = reinterpret_cast<float*>(base + G::TOTP);
  float* BONP = reinterpret_cast<float*>(base + G::BONP);
  float* L1P = reinterpret_cast<float*>(base + G::L1P);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + G::BAR);
  unsigned char* Vs = base + G::V;
  unsigned char* Rs = base + G::R;
  unsigned char* Ks = base + G::K;
  unsigned char* Ws = base + G::W;
  unsigned char* KT = base + G::KT;
  unsigned char* AT = base + G::AT;
  float* AF = reinterpret_cast<float*>(base + G::AF);
  float* X = reinterpret_cast<float*>(base + G::X);
  float* KL = reinterpret_cast<float*>(base + G::KL);
  float* COMP = reinterpret_cast<float*>(base + G::COMP);
  float* CARRY = reinterpret_cast<float*>(base + G::CARRY);

  const int R = gridDim.x, q = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int j0 = 16 * (tid / 32) + gid;   // this thread's value rows j0, j0 + 8
  const int NC = (Tn + C - 1) / C;
  const int per = NC / R, extra = NC % R;
  const int c_lo = q * per + min(q, extra), n_run = per + (q < extra ? 1 : 0);
  constexpr bool reuse = ONE;
  const bool two_pass = R > 1;
  static_assert(min_ctas<T, HD, ONE>() * (G::SMEM + 1024) <= 233472, "shared memory of an SM");
  const long stride = (long)H * HD;
  const long s_base = ((long)b * H + h) * HD * HD;
  const uint32_t rt_addr = smem_addr(RT), kt_addr = smem_addr(KT), at_addr = smem_addr(AT);

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    tma_prefetch(&tr);
    tma_prefetch(&tk);
    tma_prefetch(&tv);
    tma_prefetch(&tw);
    // every rank reads its share of s0 between the barriers
    if (s0 != nullptr) prefetch_l2(s0 + s_base, 4 * HD * HD);
  }
  for (int i = tid; i < HD; i += NT) US[i] = u[h * HD + i];

  float S[NS];                  // the state S^T (row_of, col_of)
  // (1) V^T A^T and (2) S^T (r 2^P)^T in accumulators of their own, added
  // in f32 at the end: each sum is truncated at its own size
  float O1[16], O2[16];
  __syncthreads();
  RWKV6_STAMP(0);

  uint32_t phase = 0;
  // the chunk's r (with_r), k, v and w by TMA; every thread waits for them
  auto load = [&](int c, bool with_r) {
    fence_proxy_async_smem();   // generic writes to this space before the copies' writes
    __syncthreads();
    if (tid == 0) {
      mbar_arrive_expect_tx(bar, (with_r ? 4 : 3) * G::TILE);
      for (int bx = 0; bx < G::NBOX; ++bx) {
        const int i0 = bx * G::BOXC, off = bx * BOX;
        if (with_r) tma_load_4d(Rs + off, &tr, bar, i0, h, c * C, b);
        tma_load_4d(Ks + off, &tk, bar, i0, h, c * C, b);
        tma_load_4d(Vs + off, &tv, bar, i0, h, c * C, b);
        tma_load_4d(Ws + off, &tw, bar, i0, h, c * C, b);
      }
    }
    mbar_wait(bar, phase & 1);
    ++phase;
  };
  // r 2^P's parts: its big part over the f32 in place, its small part at RTS
  auto split_rt = [&]() {
    __syncthreads();              // every row of r 2^P written, KL (the same space) read
    for (int e = tid; e < G::RT_PART / 4; e += NT) {
      const float x = RT[e];
      const float big = __uint_as_float(tf32_big(x));
      RT[e] = big;
      reinterpret_cast<float*>(base + G::RTS)[e] = x - big;
    }
    fence_proxy_async_smem();
    __syncthreads();
  };

  // ---- pass 1: the composite of this rank's run ----------------------------
  // Two passes: every rank from zero (D = 1).  One chunk a rank: the chunk's
  // A and (1) too, and rank 0 its (2) from s0, its carry-in; with one rank
  // (one chunk) (3) starts from s0 and pass 1 is the only pass.
  if (reuse || two_pass) {
    for (int ci = 0; ci < n_run; ++ci) {
      const int c = c_lo + ci, L = min(C, Tn - c * C);
      load(c, reuse);
      RWKV6_STAMP(1);
      chunk_terms<T, HD>(Rs, Ks, Ws, US, X, BONP, L1P, TOTP, RT, KL, KT, DC, L, reuse, tid);
      RWKV6_STAMP(13);
      fence_proxy_async_smem();   // the decayed k's parts, before the tensor cores read them
      __syncthreads();
      RWKV6_STAMP(2);
      if (ci == 0) {
        if (reuse && q == 0) {
          load_state<HD>(S, s0, s_base, j0, tig);
          split_rt();
          zero16(O2);
          issue_state<HD>(O2, S, rt_addr, G::RTS - G::RT);
        }
        if (two_pass) {
#pragma unroll
          for (int e = 0; e < NS; ++e) S[e] = 0.f;
        }
        for (int i = tid; i < HD; i += NT) DR[i] = 1.f;
      }
      decay_state<HD>(S, DC, tig);
      issue_v<T, HD, HD>(S, Vs, j0, tig, kt_addr, G::KT_PART);   // (3)
      for (int i = tid; i < HD; i += NT) DR[i] *= DC[i];
      if (reuse) {                // A over the decayed k's space, then (1)
        __syncthreads();
        chunk_scores<T, HD>(X, BONP, L1P, AF, AT, tid);
        fence_proxy_async_smem(); // A's parts, before the tensor cores read them
        __syncthreads();
        zero16(O1);
        issue_v<T, HD, 32>(O1, Vs, j0, tig, at_addr, G::AT_PART);   // (1)
      }
      RWKV6_STAMP(3);
    }
  }

  // ---- the carry: two cluster barriers -------------------------------------
  // Every rank publishes its composite (D, S^T) over its own tiles; after
  // the first barrier each rank carries its share of the state's elements
  // through every rank's composite and writes each rank's carry-in into
  // that rank's carry-in buffer, which overlays neither a composite nor
  // anything a rank writes before it has read its carry-in; after the
  // second, no CTA touches another's shared memory again.
  if (two_pass) {
    __syncthreads();              // every warpgroup's products read the tiles the composite overlays
    publish<HD, NT>(COMP, S, DR, tid);
    RWKV6_STAMP(4);
    cluster_sync();
    RWKV6_STAMP(5);
    const uint32_t comp = smem_addr(COMP), carry = smem_addr(CARRY);
    // loads in flight: up to 16 composites' slots; one chunk a rank holds
    // (1) and rank 0's (2) across the carry, so 8
    if (reuse) carry_share<HD, NT, 8, 1>(q, R, comp, carry, s0, sT, s_base, tid);
    else if (R <= 4) carry_share<HD, NT, 4, 4>(q, R, comp, carry, s0, sT, s_base, tid);
    else if (R <= 8) carry_share<HD, NT, 8, 2>(q, R, comp, carry, s0, sT, s_base, tid);
    else carry_share<HD, NT, R_MAX, 1>(q, R, comp, carry, s0, sT, s_base, tid);
    RWKV6_STAMP(6);
    cluster_sync();
    RWKV6_STAMP(7);
    if (!(reuse && q == 0)) load_carry<HD, NT>(S, CARRY, tid);
    RWKV6_STAMP(8);
  } else if (!reuse) {
    load_state<HD>(S, s0, s_base, j0, tig);   // one rank: its run from s0
  }

  // ---- pass 2: this rank's outputs, from its carry-in ----------------------
  // One chunk a rank: (2), A and (1) came with pass 1.  Several: the
  // chunk's terms, (2) from the state and (3) while the decayed k's parts
  // hold (with one rank after every chunk), then A over them and (1).
  for (int ci = 0; ci < n_run; ++ci) {
    const int c = c_lo + ci, L = min(C, Tn - c * C);
    if (!reuse) {
      load(c, true);
      chunk_terms<T, HD>(Rs, Ks, Ws, US, X, BONP, L1P, TOTP, RT, KL, KT, DC, L, true, tid);
    }
    RWKV6_STAMP(10);
    if (!(reuse && q == 0)) {
      split_rt();
      zero16(O2);
      issue_state<HD>(O2, S, rt_addr, G::RTS - G::RT);
    }
    if (!reuse) {
      if (ci < n_run - 1 || !two_pass) {
        decay_state<HD>(S, DC, tig);
        issue_v<T, HD, HD>(S, Vs, j0, tig, kt_addr, G::KT_PART);   // (3)
      }
      __syncthreads();            // the decayed k's parts read: A goes over them
      chunk_scores<T, HD>(X, BONP, L1P, AF, AT, tid);
      fence_proxy_async_smem();   // A's parts, before the tensor cores read them
      __syncthreads();
      zero16(O1);
      issue_v<T, HD, 32>(O1, Vs, j0, tig, at_addr, G::AT_PART);   // (1)
    }
    fence_regs(O1);
    fence_regs(O2);
    T* ob = o + ((long)b * Tn + (long)c * C) * stride + (long)h * HD;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int j = row_of(j0, e), t = 8 * (e / 4) + 2 * tig + e % 2;
      if (j < HD && t < L) store(ob + t * stride + j, O1[e] + O2[e]);
    }
  }
  RWKV6_STAMP(11);
  if (!two_pass) store_state<HD>(sT, s_base, S, j0, tig);   // one rank: its state is sT
  RWKV6_STAMP(12);
}

}  // namespace cl

// ---------------------------------------------------------------------------
// T = 1, f32 and bf16: one streaming pass over the state.
// ---------------------------------------------------------------------------
namespace decode {

// threads per CTA: one per 16-byte column quad of each of 256 / (HD/4) rows
template <int HD>
__host__ __device__ constexpr int threads() { return HD * HD / 4 < 256 ? HD * HD / 4 : 256; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(threads<HD>()) decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* s0,              // may alias sT: each thread reads its elements first
    float* sT, T* __restrict__ o, int H) {
  constexpr int NT_ = threads<HD>();
  constexpr int QC = HD / 4;      // column quads of a row
  constexpr int RG = NT_ / QC;    // row groups: thread rows g, g + RG, ...
  constexpr int RPT = HD / RG;    // rows per thread
  constexpr int NWD = NT_ / 32;
  static_assert(QC <= 32 && 32 % QC == 0 && NT_ % 32 == 0, "column quads tile a warp");
  __shared__ float part[NWD][HD];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int jq = tid % QC, g = tid / QC, j0 = 4 * jq;
  const long xb = ((long)b * H + h) * HD;          // this head's token row (T = 1)
  const long sb = xb * HD;
  // every load first: the state rows, then this thread's r, k, w, u and v
  float4 s[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
    s[m] = s0 != nullptr
               ? *reinterpret_cast<const float4*>(s0 + sb + (long)(g + RG * m) * HD + j0)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  float ri[RPT], ki[RPT], wi[RPT], ui[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = g + RG * m;
    ri[m] = to_f(r[xb + i]);
    ki[m] = to_f(k[xb + i]);
    wi[m] = to_f(w[xb + i]);
    ui[m] = u[h * HD + i];
  }
  float vj[4];
  load4(v + xb + j0, vj);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int m = 0; m < RPT; ++m) {
    const int i = g + RG * m;
    const float uk = ui[m] * ki[m];
    const float sv[4] = {s[m].x, s[m].y, s[m].z, s[m].w};
    float nv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q] = fmaf(ri[m], fmaf(uk, vj[q], sv[q]), acc[q]);
      nv[q] = fmaf(wi[m], sv[q], ki[m] * vj[q]);
    }
    *reinterpret_cast<float4*>(sT + sb + (long)i * HD + j0) =
        make_float4(nv[0], nv[1], nv[2], nv[3]);
  }
  // o_j: sum over the row groups, first within the warp, then across warps
#pragma unroll
  for (int q = 0; q < 4; ++q)
    for (int off = QC; off < 32; off *= 2) acc[q] += __shfl_xor_sync(FULL, acc[q], off);
  const int lane = tid % 32, warp = tid / 32;
  if (lane < QC) {
#pragma unroll
    for (int q = 0; q < 4; ++q) part[warp][j0 + q] = acc[q];
  }
  __syncthreads();
  for (int j = tid; j < HD; j += NT_) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < NWD; ++q) sum += part[q][j];
    store(o + xb + j, sum);
  }
}

template <typename T, int HD>
cudaError_t launch(const T* r, const T* k, const T* v, const T* w, const float* u,
                   const float* s0, float* sT, T* o, int B, int H, cudaStream_t stream) {
  decode_kernel<T, HD><<<dim3(H, B), threads<HD>(), 0, stream>>>(r, k, v, w, u, s0, sT, o, H);
  return cudaGetLastError();
}

}  // namespace decode

// ---------------------------------------------------------------------------
// Host side of the T > 1 kernel.
// ---------------------------------------------------------------------------
namespace cl {

// Tensor maps of r, k, v and w, encoded once per (pointer, shape, dtype): a
// map is a function of these alone (the wrapper checks contiguity).
struct MapKey {
  const void* ptr;
  int B, T, H, hd, es;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && B == o.B && T == o.T && H == o.H && hd == o.hd && es == o.es;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.B, k.T, k.H, k.hd, k.es}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

std::mutex host_cache_mutex;   // the tensor maps' and the occupancy caches'

cudaError_t cached_map(CUtensorMap* out, const void* ptr, int es, int B, int T, int H, int hd) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, B, T, H, hd, es};
  std::lock_guard<std::mutex> lock(host_cache_mutex);
  auto found = maps.find(key);
  if (found != maps.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  const cudaError_t err = tma_encode_bshd(out, ptr, es, B, T, H, hd, C);
  if (err != cudaSuccess) return err;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *out);
  return cudaSuccess;
}

constexpr int MAX_DEVICES = 64;

// The kernel's shared-memory limit and non-portable cluster sizes (above
// 8), set once per device; then the number of clusters of `ranks` CTAs the
// card can hold at once (cudaOccupancyMaxActiveClusters), once per device
// and size.
template <typename T, int HD, bool ONE>
cudaError_t active_clusters(int ranks, int device, int* out) {
  using G = Cfg<T, HD>;
  static bool ready[MAX_DEVICES] = {};
  static int known[MAX_DEVICES][R_MAX + 1] = {};
  if (device < 0 || device >= MAX_DEVICES || ranks < 1 || ranks > R_MAX)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(host_cache_mutex);
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<T, HD, ONE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)G::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scan_kernel<T, HD, ONE>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  if (known[device][ranks] == 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ranks, 1, 1);
    cfg.blockDim = dim3(G::NT, 1, 1);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, scan_kernel<T, HD, ONE>, &cfg);
    if (err != cudaSuccess) return err;
    known[device][ranks] = n + 1;               // 0: not asked yet
  }
  *out = known[device][ranks] - 1;
  return cudaSuccess;
}

template <typename T, int HD, bool ONE>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* sT, void* o, int B, int Tn, int H, int ranks,
                   int device, cudaStream_t stream) {
  using G = Cfg<T, HD>;
  int fits = 0;
  cudaError_t err = active_clusters<T, HD, ONE>(ranks, device, &fits);
  if (err != cudaSuccess) return err;
  if (fits == 0) return cudaErrorInvalidConfiguration;   // the card cannot hold one cluster
  CUtensorMap mr, mk, mv, mw;
  const int es = (int)sizeof(T);
  err = cached_map(&mr, r, es, B, Tn, H, HD);
  if (err == cudaSuccess) err = cached_map(&mk, k, es, B, Tn, H, HD);
  if (err == cudaSuccess) err = cached_map(&mv, v, es, B, Tn, H, HD);
  if (err == cudaSuccess) err = cached_map(&mw, w, es, B, Tn, H, HD);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ranks, H, B);
  cfg.blockDim = dim3(G::NT, 1, 1);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, scan_kernel<T, HD, ONE>, mr, mk, mv, mw,
                           static_cast<const float*>(u), static_cast<const float*>(s0),
                           static_cast<float*>(sT), static_cast<T*>(o), Tn, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace cl

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* sT, void* o, int B, int Tn, int H, int ranks,
                   int device, cudaStream_t stream) {
  if (Tn == 1)
    return decode::launch<T, HD>(static_cast<const T*>(r), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<const T*>(w),
                                 static_cast<const float*>(u), static_cast<const float*>(s0),
                                 static_cast<float*>(sT), static_cast<T*>(o), B, H, stream);
  const int chunks = (Tn + C - 1) / C;
  if (ranks < 1 || ranks > chunks) return cudaErrorInvalidValue;
  return ranks == chunks
             ? cl::launch<T, HD, true>(r, k, v, w, u, s0, sT, o, B, Tn, H, ranks, device, stream)
             : cl::launch<T, HD, false>(r, k, v, w, u, s0, sT, o, B, Tn, H, ranks, device, stream);
}

// fn.template run<T, HD>() of the instantiation a call of (dtype, hd) runs
template <typename F>
cudaError_t with_instance(int dtype, int hd, const F& fn) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  const bool f32 = dtype == DTYPE_F32;
  switch (hd) {
    case 16: return f32 ? fn.template run<float, 16>() : fn.template run<__nv_bfloat16, 16>();
    case 32: return f32 ? fn.template run<float, 32>() : fn.template run<__nv_bfloat16, 32>();
    case 64: return f32 ? fn.template run<float, 64>() : fn.template run<__nv_bfloat16, 64>();
    case 128: return f32 ? fn.template run<float, 128>() : fn.template run<__nv_bfloat16, 128>();
    default: return cudaErrorInvalidValue;
  }
}

struct Forward {
  const void *r, *k, *v, *w, *u, *s0;
  void *sT, *o;
  int B, Tn, H, ranks, device;
  cudaStream_t stream;
  template <typename T, int HD>
  cudaError_t run() const {
    return launch<T, HD>(r, k, v, w, u, s0, sT, o, B, Tn, H, ranks, device, stream);
  }
};

struct ActiveClusters {
  int ranks, one_chunk, device;
  int* out;
  template <typename T, int HD>
  cudaError_t run() const {
    return one_chunk ? cl::active_clusters<T, HD, true>(ranks, device, out)
                     : cl::active_clusters<T, HD, false>(ranks, device, out);
  }
};

}  // namespace rwkv6

// Returns a cudaError_t: the launch's own, or the error of setting the
// device, the kernel's attributes or a tensor map;
// cudaErrorInvalidConfiguration where the card cannot hold one cluster of
// `ranks` CTAs.  s0 may be null (a zero state) and may equal sT (the state
// updated in place).  `ranks` (1..16, at most ceil(T / 32); from
// rwkv6_scan.cluster_plan) is read for T > 1 only.  Shapes, dtypes,
// contiguity and alignment are checked by the Python wrapper.
extern "C" int rwkv6_forward(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, void* sT, void* o, int dtype, int B,
                             int Tn, int H, int hd, int ranks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const rwkv6::Forward fwd{r, k, v, w, u, s0, sT, o, B, Tn, H, ranks, device,
                           static_cast<cudaStream_t>(stream)};
  return (int)rwkv6::with_instance(dtype, hd, fwd);
}

// How many clusters of `ranks` CTAs the card holds at once for the T > 1
// kernel of (dtype, hd), the one for one chunk a rank where one_chunk is
// not 0 and the one for several otherwise, into *out.
extern "C" int rwkv6_max_active_clusters(int dtype, int hd, int ranks, int one_chunk, int device,
                                         int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)rwkv6::with_instance(dtype, hd,
                                   rwkv6::ActiveClusters{ranks, one_chunk, device, out});
}
