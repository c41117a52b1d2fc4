// Flash-decode for Hopper (sm_90a): one query token per sequence against
// its KV cache, f32 or bf16 in, f32 softmax, one launch a call over
// thread-block clusters.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (body _decode_kernel): for q (B,nq,hd), a cache k, v (B,S,nkv,hd) and a
// (B,S) mask `valid` (ring holes, causal horizon, window), the softmax over
// the valid slots of q k^T * hd^-0.5, times v.  A sequence with no valid
// slot gives 0, as the Pallas kernel does.
//
// What bounds it on this card: bytes.  Each cached K/V element is used for
// 2*(nq/nkv) operations, far below the H100's ~295 operations per byte, so
// the least time is the valid part of the cache over 3.35 TB/s.  Reaching
// it takes enough bytes in flight on every SM in one launch, and at decode
// batch sizes there are few (batch, kv head) pairs: 128 for qwen1.5-0.5b at
// 8 slots, 8 for recurrentgemma-9b, on 132 SMs.  What the design does about
// the four things that held the split kernel of the first redesign back:
//  1. the split plan cut S by shape, so a prefix mask left most splits
//     empty: here 64-slot tile t belongs to cluster rank t % C, dealt round
//     robin, so a prefix mask, a ring hole or a window spreads evenly over
//     the C CTAs of a cluster (one per (sequence, kv head, chunk of heads);
//     grid (C, nkv x chunks, B), cluster (C, 1, 1), cudaLaunchKernelEx).
//     The wrapper's cluster_plan picks C from B, nkv, S and the card (about
//     two CTAs an SM, C <= 16, one wave where an SM holds one CTA; never
//     from `valid`, so no host sync).  The producer warp first reads the
//     mask bytes of its CTA's tiles (a 64-bit word a tile, 32 tiles a pass)
//     and issues no copy for an empty tile;
//  2. the combine was a second launch over f32 partials in scratch: here
//     each CTA keeps its state (per head m and l, its accumulators in its
//     idle ring), pushes each rank's slice of the accumulators into that
//     rank's shared memory with 16-byte st.shared::cluster stores (and
//     every head's m and l to every rank), and after one cluster barrier
//     (release/acquire) rank r merges its slice from its own shared memory
//     and writes q's dtype.  A rank that saw no valid slot pushes l = 0; a
//     row whose ranks all saw nothing gives 0; with C = 1 the CTA writes
//     the output itself.  No scratch, no second launch;
//  3. the copies were per-lane cp.async in a ring of 3, 2 or 1 stages:
//     here TMA tensor loads of K and V tiles (tensor maps over the
//     (B, S, nkv, hd) cache, 128-byte boxes under 128-byte swizzle: 1, 2
//     and 4 boxes a bf16 row at hd <= 64, 112/128, 256, hd 112 padded by
//     the map's zero fill; encoded on the host and cached by pointer, shape
//     and dtype) fill a ring of full/empty mbarriers, 4 stages at hd <= 64
//     and 2 above, hd 256 included, kept full by one producer warp beside
//     the consumer warpgroup.  Masked slots inside a loaded tile are read,
//     as the TPU kernel reads whole blocks, and get probability exactly 0
//     (its jnp.where(valid, exp(...), 0)): unlike the split kernel, a
//     masked slot is no longer skipped unread, only a wholly masked tile;
//  4. the mma.sync A operand was 16 rows of heads, one of them live at a
//     group of 1: here, in bf16 with a GQA group <= 16 (every model of the
//     repo), wgmma with the operands swapped, so that its 64 rows are slots
//     and head dims.  S^T (64 slots x N) = K_tile Q^T with N = the group
//     rounded up to 8 or 16 (A = K, B = q, both K-major; q written swizzled
//     into shared memory by the consumers; even and odd k-steps in two
//     accumulators); O^T (hd x 2N) += V^T [P_hi; P_lo]^T with A = the V
//     tile MN-major (the transpose flag) and B = P's bf16 high part in its
//     first N rows and its low part in the next N, which the consumers
//     write to one swizzled shared tile: one product gives both, and their
//     sum keeps P V within one bf16 step of the f32 result, as the TPU
//     kernel's f32 P is.  At hd 256 the O accumulators are 256 x 32 / 128
//     = 64 floats a thread.  A head's max over a tile's 64 rows reduces
//     within a warp, then across the warpgroup's 4 warps through shared
//     memory; its sum stays per thread until the end.  Tile n+1's S^T is
//     issued with tile n's P V.
// f32 (held to 2e-5) and groups > 16 keep the SIMT scoring body (two
// half-warps a slot, 16 slots a warp), fed by the same schedule, copies and
// merge, at a chunk of heads whose outputs the warpgroup holds (heads x hd
// <= 1024), one cluster each; f32 at hd 256 has one ring stage (a stage is
// 128 KB).  Its speed is not an aim.
// What is left (PERF.md §6): a call's fixed latencies (the mask read, then
// the first tile's TMA, then the push and the cluster barrier) and, on a
// long sequence's CTAs, the wgmma issue, softmax and barriers of each
// 64-slot tile, not the bytes.
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                  // cache slots of a tile
constexpr int NCW = 4;                    // consumer warps: one warpgroup
constexpr int NCT = 32 * NCW;             // consumer threads
constexpr int NT = NCT + 32;              // and the producer warp
constexpr int MAX_CLUSTER = 16;
constexpr int SIMT_OUTPUTS = 1024;        // SIMT: heads x hd a CTA at most
constexpr int MAX_PAIRS = SIMT_OUTPUTS / (2 * NCT);   // SIMT: output pairs a thread
constexpr int BAR_CONSUMERS = 1;          // named barrier of the consumer warpgroup
constexpr unsigned FULL = 0xffffffffu;

// The shared-memory layout of one instantiation: T the element type, HD the
// head size, NQ the heads of a tensor-core product (8 or 16; 0 for the SIMT
// path).  Offsets from a 1024-byte aligned base; the tiles and q and P
// boxes stay 1024-byte aligned, the swizzle's atom.  Ring stages: 4 of 16
// KB at hd <= 64 and 2 above on the tensor cores, so that three CTAs fit an
// SM up to hd 128 (the plan's aim of two, with room); the SIMT path keeps
// 4, 3, 2 and 1 of 16, 32, 64 and 128 KB.
template <typename T, int HD, int NQ>
struct Cfg {
  static constexpr bool TC = NQ > 0;
  static constexpr int BOXC = 128 / (int)sizeof(T);                // columns of a box
  static constexpr int NBOX = (HD * (int)sizeof(T) + 127) / 128;   // boxes a row
  static constexpr int BOX = TILE * 128;                           // bytes of a tile's box
  static constexpr int STAGE = 2 * NBOX * BOX;                     // K boxes, then V boxes
  static constexpr int NS = NBOX == 1 ? 4 : TC || NBOX == 4 ? 2 : NBOX == 2 ? 3 : 1;
  // heads a CTA serves at most
  static constexpr int GMAX = TC ? NQ : (SIMT_OUTPUTS / HD < 64 ? SIMT_OUTPUTS / HD : 64);
  static constexpr int QBOX = NQ * 128;   // tensor cores: a box of NQ swizzled q rows
  static constexpr int PBUF = NQ * 128;   // tensor cores: P (NQ heads x 64 slots) in bf16
  static constexpr int QR = HD + 8;       // SIMT: an f32 q row, its halves 4 floats apart
  static constexpr int Q = NS * STAGE;
  static constexpr int P = Q + (TC ? NBOX * QBOX : GMAX * QR * 4);
  // tensor cores: P's high part, then its low part; SIMT: g x 64 f32
  static constexpr int RED = P + (TC ? 2 * PBUF : GMAX * TILE * 4);   // [4 warps][GMAX]
  static constexpr int AUX = RED + NCW * GMAX * 4;   // TC: partial sums [4][GMAX]; SIMT: alpha
  static constexpr int MS = AUX + NCW * GMAX * 4;    // running max [GMAX], log2 units
  static constexpr int LS = MS + GMAX * 4;           // sum [GMAX]
  // the merge: what each rank c pushes into the rank that owns a slice of
  // the g x hd outputs, its accumulators [c][per] (per a multiple of 4, so
  // C x per <= g hd + 4 C), then m [c][GMAX] and l [c][GMAX]
  static constexpr int RCV = (LS + GMAX * 4 + 15) / 16 * 16;
  static constexpr int RCV_ML = RCV + (GMAX * HD + 4 * MAX_CLUSTER) * 4;
  static constexpr int INFO = RCV_ML + 2 * MAX_CLUSTER * GMAX * 4;   // per stage: tile, mask
  static constexpr int BARS = INFO + NS * 16;        // full[NS], empty[NS]
  static constexpr size_t SMEM = 1024 + BARS + 2 * NS * 8;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load_chunk(const float* p, float (&o)[4]) { load4(p, o); }
__device__ __forceinline__ void load_chunk(const bf16* p, float (&o)[8]) {
  uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Element (row, col) of a tile as TMA wrote it: boxes of 128 bytes a row,
// the 16-byte chunks of row r permuted by r % 8 (128-byte swizzle).
template <typename T>
__device__ __forceinline__ const T* tile_at(const unsigned char* tile, int row, int col) {
  constexpr int BOXC = 128 / (int)sizeof(T), EPC = 16 / (int)sizeof(T);
  const int c = col % BOXC;
  return reinterpret_cast<const T*>(tile + (col / BOXC) * TILE * 128 + row * 128 +
                                    (((c / EPC) ^ (row & 7)) << 4)) + c % EPC;
}

// bit i set where byte i of w is not 0
__device__ __forceinline__ uint32_t nonzero_bits4(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u) & 0x08040201u;
  return (t | (t >> 8) | (t >> 16) | (t >> 24)) & 0xFu;
}

// Valid bits of slots [s0, s0 + 64) of one sequence's mask row; slots at
// or past S are invalid and not read.
__device__ __forceinline__ uint64_t tile_mask(const uint8_t* row, int s0, int S) {
  const uint8_t* p = row + s0;
  uint64_t bits = 0;
  if (s0 + TILE <= S && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[c];
      const uint32_t b = nonzero_bits4(w.x) | (nonzero_bits4(w.y) << 4) |
                         (nonzero_bits4(w.z) << 8) | (nonzero_bits4(w.w) << 12);
      bits |= (uint64_t)b << (16 * c);
    }
  } else {
    for (int i = 0; i < TILE; ++i)
      if (s0 + i < S && p[i]) bits |= 1ull << i;
  }
  return bits;
}

// The producer warp: the CTA's tiles rank, rank + C, ..., each non-empty
// one into the next ring stage (its index and mask bits into `info`), then
// a stage with tile -1 that ends the stream.
template <typename T, int HD, int NQ>
__device__ __forceinline__ void produce(const CUtensorMap* tk, const CUtensorMap* tv,
                                        const uint8_t* vrow, unsigned char* ring, int4* info,
                                        uint64_t* full, uint64_t* empty, int S, int rank, int ncl,
                                        int kvh, int b, int lane) {
  using C = Cfg<T, HD, NQ>;
  if (lane == 0) {
    tma_prefetch(tk);
    tma_prefetch(tv);
  }
  const int n_tiles = (S + TILE - 1) / TILE;
  const int mine = rank < n_tiles ? (n_tiles - rank + ncl - 1) / ncl : 0;
  int it = 0;
  for (int j0 = 0; j0 < mine; j0 += 32) {
    const uint64_t bits =
        j0 + lane < mine ? tile_mask(vrow, (rank + (j0 + lane) * ncl) * TILE, S) : 0;
    unsigned pend = __ballot_sync(FULL, bits != 0);
    while (pend) {
      const int i = __ffs(pend) - 1;
      pend &= pend - 1;
      const uint32_t lo = __shfl_sync(FULL, (uint32_t)bits, i);
      const uint32_t hi = __shfl_sync(FULL, (uint32_t)(bits >> 32), i);
      if (lane == 0) {
        const int st = it % C::NS;
        if (it >= C::NS) mbar_wait(empty + st, (it / C::NS - 1) & 1);
        const int t = rank + (j0 + i) * ncl;
        info[st] = make_int4(t, (int)lo, (int)hi, 0);
        unsigned char* kv = ring + st * C::STAGE;
        mbar_arrive_expect_tx(full + st, C::STAGE);
#pragma unroll
        for (int bx = 0; bx < C::NBOX; ++bx) {
          tma_load_4d(kv + bx * C::BOX, tk, full + st, C::BOXC * bx, kvh, t * TILE, b);
          tma_load_4d(kv + (C::NBOX + bx) * C::BOX, tv, full + st, C::BOXC * bx, kvh, t * TILE, b);
        }
      }
      ++it;
    }
  }
  if (lane == 0) {
    const int st = it % C::NS;
    if (it >= C::NS) mbar_wait(empty + st, (it / C::NS - 1) & 1);
    info[st].x = -1;
    mbar_arrive(full + st);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// bf16, a group of <= 16 heads: the consumer warpgroup on the tensor cores.
// Thread (warp w, lane 4 gid + tig) holds rows (slots of S^T, dims of O^T)
// 16 w + gid and + 8 of each 64-row block, and columns (heads) 8 (j / 2) +
// 2 tig + j % 2, j < NQ / 4; element i of an accumulator is column j =
// 2 (i / 4) + i % 2, row + 8 where (i / 2) % 2.
// ---------------------------------------------------------------------------
// S^T = K Q^T of one tile: even k-steps into s, odd ones into s2 (two
// independent chains of products; the caller adds them)
template <int HD, int NQ>
__device__ __forceinline__ void issue_s(float (&s)[NQ / 2], float (&s2)[NQ / 2], uint32_t k_addr,
                                        uint32_t q_addr) {
  using C = Cfg<bf16, HD, NQ>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<NQ>(kk % 2 ? s2 : s, desc_sw128(k_addr + (kk / 4) * C::BOX + off, 16, 1024),
                 desc_sw128(q_addr + (kk / 4) * C::QBOX + off, 16, 1024), kk > 1);
  }
}

// O^T += V^T P^T over the tile's 4 k-steps of 16 slots, for each 64-dim
// block of hd.  B holds P's high part in its first NQ rows and its low part
// in the next NQ (the P tile is those 2 NQ head rows), so one product of N
// = 2 NQ gives both: columns [0, NQ) of o from the high part, [NQ, 2 NQ)
// from the low part, which the caller adds at the end
template <int HD, int NQ>
__device__ __forceinline__ void issue_pv(float (&o)[Cfg<bf16, HD, NQ>::NBOX][NQ], uint32_t v_addr,
                                         uint32_t p_addr) {
  using C = Cfg<bf16, HD, NQ>;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int mb = 0; mb < C::NBOX; ++mb)
      wgmma_ss_at<2 * NQ>(o[mb], desc_sw128(v_addr + mb * C::BOX + kk * 16 * 128, 1024, 1024),
                          desc_sw128(p_addr + kk * 32, 16, 1024));
  }
}

// The end of a CTA's work, by its consumer warpgroup, once its state is in
// shared memory: the accumulators (head, dim) row-major in the idle ring,
// m and l per head.  With one CTA, the outputs o / l; in a cluster, each
// rank's slice of the accumulators pushed into that rank's receiving area
// (16 bytes a store), and every head's m and l into every rank's.
template <typename T, int HD, int NQ>
__device__ __forceinline__ void finish_cta(unsigned char* base, T* ob, int g, int ncl, int rank,
                                           int per, int tid) {
  using C = Cfg<T, HD, NQ>;
  const float* accs = reinterpret_cast<const float*>(base);
  const float* ms = reinterpret_cast<const float*>(base + C::MS);
  const float* ls = reinterpret_cast<const float*>(base + C::LS);
  const int total = g * HD;
  if (ncl == 1) {
    for (int idx = tid; idx < total; idx += NCT) {
      const float l = ls[idx / HD];
      store(ob + idx, l > 0.f ? accs[idx] / l : 0.f);
    }
    return;
  }
  const uint32_t rcv = smem_addr(base + C::RCV), rml = smem_addr(base + C::RCV_ML);
  for (int i = tid; i < total / 4; i += NCT) {
    const int idx = 4 * i, r = idx / per;
    st_cluster(cluster_map(rcv + 4 * (rank * per + idx - r * per), r),
               *reinterpret_cast<const float4*>(accs + idx));
  }
  for (int i = tid; i < ncl * g; i += NCT) {
    const int r = i / g, n = i % g;
    const uint32_t a = rml + 4 * (rank * C::GMAX + n);
    st_cluster(cluster_map(a, r), ms[n]);
    st_cluster(cluster_map(a + 4 * MAX_CLUSTER * C::GMAX, r), ls[n]);
  }
}

template <int HD, int NQ>
__device__ __forceinline__ void consume_tc(const bf16* qh, bf16* ob, int g, unsigned char* base,
                                           const int4* info, uint64_t* full, uint64_t* empty,
                                           float scale_log2, int tid, int ncl, int rank, int per) {
  using C = Cfg<bf16, HD, NQ>;
  constexpr int NS = C::NS, NB = C::NBOX, NC = NQ / 4, NA = NQ / 2;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int r0 = 16 * warp + gid;
  unsigned char* Qs = base + C::Q;
  unsigned char* Pb = base + C::P;
  float* red = reinterpret_cast<float*>(base + C::RED);

  // q: NQ rows of hd in NB boxes, swizzled as TMA writes a tile; rows past
  // the group and columns past hd are zeros
  for (int idx = tid; idx < NB * NQ * 8; idx += NCT) {
    const int bx = idx / (NQ * 8), n = idx / 8 % NQ, ch = idx % 8, d0 = 64 * bx + 8 * ch;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < g && d0 < HD) val = *reinterpret_cast<const uint4*>(qh + n * HD + d0);
    *reinterpret_cast<uint4*>(Qs + bx * C::QBOX + n * 128 + ((ch ^ (n & 7)) << 4)) = val;
  }
  fence_proxy_async_smem();
  named_bar_sync(BAR_CONSUMERS, NCT);

  const uint32_t q_addr = smem_addr(Qs), ring_addr = smem_addr(base), p_addr = smem_addr(Pb);
  // O^T: element i < NA from P's high part, i + NA from its low part, of
  // the same (head, dim)
  float o[NB][NQ];
#pragma unroll
  for (int mb = 0; mb < NB; ++mb)
#pragma unroll
    for (int i = 0; i < NQ; ++i) o[mb][i] = 0.f;
  float m[NC], l[NC], alpha[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    m[j] = NEG_INF;
    l[j] = 0.f;
  }
  auto col = [&](int j) { return 8 * (j / 2) + 2 * tig + j % 2; };

  // the online softmax of one tile's S^T in log2 units, in two halves
  // around the warpgroup's exchange of the heads' tile max: first the
  // masked logits and this warp's column max, then (after the caller's
  // barrier) the new max, alpha, P (in s) and this thread's part of l
  float cm[NC];
  auto softmax_local = [&](float (&s)[NA], int4 inf) {
    const uint64_t mask = (uint64_t)(uint32_t)inf.y | ((uint64_t)(uint32_t)inf.z << 32);
    const bool ok0 = (mask >> r0) & 1u, ok1 = (mask >> (r0 + 8)) & 1u;
#pragma unroll
    for (int i = 0; i < NA; ++i) s[i] = ((i / 2) % 2 ? ok1 : ok0) ? s[i] * scale_log2 : NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int i = 4 * (j / 2) + j % 2;
      cm[j] = fmaxf(s[i], s[i + 2]);
      cm[j] = fmaxf(cm[j], __shfl_xor_sync(FULL, cm[j], 4));
      cm[j] = fmaxf(cm[j], __shfl_xor_sync(FULL, cm[j], 8));
      cm[j] = fmaxf(cm[j], __shfl_xor_sync(FULL, cm[j], 16));
    }
  };
  auto exchange_max = [&]() {
    if (gid == 0) {
#pragma unroll
      for (int j = 0; j < NC; ++j) red[warp * NQ + col(j)] = cm[j];
    }
    named_bar_sync(BAR_CONSUMERS, NCT);
  };
  auto softmax_shared = [&](float (&s)[NA]) {
    float ps[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = col(j);
      const float mx = fmaxf(m[j], fmaxf(fmaxf(red[c], red[NQ + c]),
                                         fmaxf(red[2 * NQ + c], red[3 * NQ + c])));
      alpha[j] = fast_exp2(m[j] - mx);
      m[j] = mx;
      ps[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = 2 * (i / 4) + i % 2;
      const float p = is_live(s[i]) ? fast_exp2(s[i] - m[j]) : 0.f;
      s[i] = p;
      ps[j] += p;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) l[j] = l[j] * alpha[j] + ps[j];
  };

  // P^T as the B operand of P V: head rows of 64 slots in bf16, 128 bytes,
  // swizzled; the high part's NQ rows, then the low part's
  auto write_p = [&](const float (&s)[NA]) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int c = col(2 * (i / 4) + i % 2), row = r0 + 8 * ((i / 2) % 2);
      const int off = c * 128 + (((row >> 3) ^ (c & 7)) << 4) + ((row & 7) << 1);
      const bf16 hi = __float2bfloat16(s[i]);
      *reinterpret_cast<bf16*>(Pb + off) = hi;
      *reinterpret_cast<bf16*>(Pb + C::PBUF + off) = __float2bfloat16(s[i] - __bfloat162float(hi));
    }
    fence_proxy_async_smem();
    named_bar_sync(BAR_CONSUMERS, NCT);
  };

  mbar_wait(full, 0);
  int4 inf = info[0];
  if (inf.x >= 0) {
    {
      float s[NA], s2[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) s[i] = s2[i] = 0.f;
      fence_regs(s);
      fence_regs(s2);
      wgmma_fence();
      issue_s<HD, NQ>(s, s2, ring_addr, q_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s2);
#pragma unroll
      for (int i = 0; i < NA; ++i) s[i] += s2[i];
      softmax_local(s, inf);
      exchange_max();
      softmax_shared(s);
      write_p(s);
    }
    int prev = 0;
    for (int it = 1;; ++it) {
      const int st = it % NS;
      mbar_wait(full + st, (it / NS) & 1);
      inf = info[st];
      if (inf.x < 0) break;
      float s[NA], s2[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) s[i] = s2[i] = 0.f;
      // S^T of this tile, then O^T += V^T P^T of the one before: S^T
      // completes first, and its masking and warp max run while the tensor
      // cores do P V; every warp has waited for P V before the exchange, so
      // after it P and stage prev are free
      fence_regs(s);
      fence_regs(s2);
      fence_regs(reinterpret_cast<float(&)[NB * NQ]>(o));
      wgmma_fence();
      issue_s<HD, NQ>(s, s2, ring_addr + st * C::STAGE, q_addr);
      wgmma_commit();
      issue_pv<HD, NQ>(o, ring_addr + prev * C::STAGE + NB * C::BOX, p_addr);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(s2);
#pragma unroll
      for (int i = 0; i < NA; ++i) s[i] += s2[i];
      softmax_local(s, inf);
      wgmma_wait<0>();
      fence_regs(reinterpret_cast<float(&)[NB * NQ]>(o));
      exchange_max();
      if (tid == 0) mbar_arrive(empty + prev);
      softmax_shared(s);
#pragma unroll
      for (int mb = 0; mb < NB; ++mb)
#pragma unroll
        for (int i = 0; i < NQ; ++i) o[mb][i] *= alpha[2 * (i % NA / 4) + i % 2];
      write_p(s);
      prev = st;
    }
    fence_regs(reinterpret_cast<float(&)[NB * NQ]>(o));
    wgmma_fence();
    issue_pv<HD, NQ>(o, ring_addr + prev * C::STAGE + NB * C::BOX, p_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(reinterpret_cast<float(&)[NB * NQ]>(o));
  }

  // l over the warpgroup (m is the same in every thread of it): over gid
  // by shuffles, over the warps through shared memory; then the state into
  // shared memory, the accumulators into the idle ring
  float* aux = reinterpret_cast<float*>(base + C::AUX);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    l[j] += __shfl_xor_sync(FULL, l[j], 4);
    l[j] += __shfl_xor_sync(FULL, l[j], 8);
    l[j] += __shfl_xor_sync(FULL, l[j], 16);
  }
  if (gid == 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j) aux[warp * NQ + col(j)] = l[j];
  }
  named_bar_sync(BAR_CONSUMERS, NCT);             // and every warp's last P V is done
  if (warp == 0 && gid == 0) {
    float* ms = reinterpret_cast<float*>(base + C::MS);
    float* ls = reinterpret_cast<float*>(base + C::LS);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = col(j);
      ms[c] = m[j];
      ls[c] = aux[c] + aux[NQ + c] + aux[2 * NQ + c] + aux[3 * NQ + c];
    }
  }
  float* accs = reinterpret_cast<float*>(base);
#pragma unroll
  for (int mb = 0; mb < NB; ++mb)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int n = col(2 * (i / 4) + i % 2), d = 64 * mb + r0 + 8 * ((i / 2) % 2);
      if (n < g && d < HD) accs[n * HD + d] = o[mb][i] + o[mb][i + NA];
    }
  named_bar_sync(BAR_CONSUMERS, NCT);
  finish_cta<bf16, HD, NQ>(base, ob, g, ncl, rank, per, tid);
}

// ---------------------------------------------------------------------------
// f32, and bf16 groups > 16: the consumer warpgroup on the SIMT units.  Warp
// w scores slots 16 w .. 16 w + 15 of a tile, lane r % 16 one slot, the two
// half-warps each half of hd; one warp a head forms the tile's P and sums;
// then each thread accumulates its output pairs of the g x hd outputs.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__device__ __forceinline__ void consume_simt(const T* qh, T* ob, int g, unsigned char* base,
                                             const int4* info, uint64_t* full, uint64_t* empty,
                                             float scale_log2, int tid, int ncl, int rank,
                                             int per) {
  using C = Cfg<T, HD, 0>;
  constexpr int NS = C::NS, HALF = HD / 2, EPC = 16 / (int)sizeof(T), QR = C::QR;
  static_assert(HALF % EPC == 0, "a half row is whole chunks");
  const int warp = tid / 32, lane = tid % 32, half = lane / 16;
  const int slot = 16 * warp + lane % 16;
  float* qs = reinterpret_cast<float*>(base + C::Q);
  float* P = reinterpret_cast<float*>(base + C::P);       // [g][64]: scores, then P
  float* red = reinterpret_cast<float*>(base + C::RED);   // [4][g] partial max
  float* alph = reinterpret_cast<float*>(base + C::AUX);  // [g]
  float* ms = reinterpret_cast<float*>(base + C::MS);
  float* ls = reinterpret_cast<float*>(base + C::LS);

  for (int idx = tid; idx < g * HD; idx += NCT) {
    const int h = idx / HD, d = idx % HD;
    qs[h * QR + d + (d >= HALF ? 4 : 0)] = to_float(qh[idx]);
  }
  for (int h = tid; h < g; h += NCT) {
    ms[h] = NEG_INF;
    ls[h] = 0.f;
  }
  named_bar_sync(BAR_CONSUMERS, NCT);

  float acc[MAX_PAIRS][2];
#pragma unroll
  for (int j = 0; j < MAX_PAIRS; ++j) acc[j][0] = acc[j][1] = 0.f;

  for (int it = 0;; ++it) {
    const int st = it % NS;
    mbar_wait(full + st, (it / NS) & 1);
    const int4 inf = info[st];
    if (inf.x < 0) break;
    const uint64_t mask = (uint64_t)(uint32_t)inf.y | ((uint64_t)(uint32_t)inf.z << 32);
    const bool ok = (mask >> slot) & 1u;
    const unsigned char* tk = base + st * C::STAGE;
    const unsigned char* tv = tk + C::NBOX * C::BOX;

    // 1. the logits of this lane's slot, each head's max over the warp's 16
    for (int h = 0; h < g; ++h) {
      const float* qrow = qs + h * QR + half * (HALF + 4);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < HALF; c += EPC) {
        float kf[EPC];
        load_chunk(tile_at<T>(tk, slot, half * HALF + c), kf);
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + c + e);
          part = fmaf(qv.x, kf[e], part);
          part = fmaf(qv.y, kf[e + 1], part);
          part = fmaf(qv.z, kf[e + 2], part);
          part = fmaf(qv.w, kf[e + 3], part);
        }
      }
      part += __shfl_xor_sync(FULL, part, 16);
      const float sv = ok ? part * scale_log2 : NEG_INF;
      const float wm = group_max(sv, 16);
      if (lane == 0) red[warp * g + h] = wm;
      if (half == 0) P[h * TILE + slot] = sv;
    }
    named_bar_sync(BAR_CONSUMERS, NCT);

    // 2. one warp a head: the new running max, P and its sum
    for (int h = warp; h < g; h += NCW) {
      const float m_old = ms[h];
      const float mx = fmaxf(m_old, fmaxf(fmaxf(red[h], red[g + h]),
                                          fmaxf(red[2 * g + h], red[3 * g + h])));
      float sum = 0.f;
      for (int sl = lane; sl < TILE; sl += 32) {
        const float sv = P[h * TILE + sl];
        const float p = is_live(sv) ? exp2f(sv - mx) : 0.f;
        P[h * TILE + sl] = p;
        sum += p;
      }
      sum = group_sum(sum, 32);
      if (lane == 0) {
        const float a = exp2f(m_old - mx);
        ms[h] = mx;
        ls[h] = ls[h] * a + sum;
        alph[h] = a;
      }
    }
    named_bar_sync(BAR_CONSUMERS, NCT);

    // 3. P V: this thread's output pairs e = 2 tid + 256 j of the g x hd
#pragma unroll
    for (int j = 0; j < MAX_PAIRS; ++j) {
      const int e = 2 * tid + 2 * NCT * j;
      if (e < g * HD) {
        const int h = e / HD, d = e % HD;
        const float a = alph[h];
        float a0 = acc[j][0] * a, a1 = acc[j][1] * a;
        const float* ph = P + h * TILE;
#pragma unroll 8
        for (int sl = 0; sl < TILE; ++sl) {
          const float2 vv = load2(tile_at<T>(tv, sl, d));
          a0 = fmaf(ph[sl], vv.x, a0);
          a1 = fmaf(ph[sl], vv.y, a1);
        }
        acc[j][0] = a0;
        acc[j][1] = a1;
      }
    }
    named_bar_sync(BAR_CONSUMERS, NCT);           // the stage, P and alpha are free
    if (tid == 0) mbar_arrive(empty + st);
  }
  // ms and ls are final (the last tile ended with a barrier); the
  // accumulators into the idle ring
  float* accs = reinterpret_cast<float*>(base);
#pragma unroll
  for (int j = 0; j < MAX_PAIRS; ++j) {
    const int e = 2 * tid + 2 * NCT * j;
    if (e < g * HD) *reinterpret_cast<float2*>(accs + e) = make_float2(acc[j][0], acc[j][1]);
  }
  named_bar_sync(BAR_CONSUMERS, NCT);
  finish_cta<T, HD, 0>(base, ob, g, ncl, rank, per, tid);
}

// One CTA of a cluster of C = gridDim.x; rank = blockIdx.x.  Serves q heads
// row0 .. row0 + g - 1 (of all B x nq) of kv head kvh of sequence b.
template <typename T, int HD, int NQ>
__global__ void __launch_bounds__(NT) da_cluster_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const T* __restrict__ q, const uint8_t* __restrict__ valid, T* __restrict__ o, int S,
    int nq, int nkv, int g, float scale_log2) {
  using C = Cfg<T, HD, NQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int ncl = gridDim.x, rank = blockIdx.x;
  const int group = nq / nkv, chunks = group / g;
  const int kvh = blockIdx.y / chunks, b = blockIdx.z;
  const long row0 = (long)b * nq + (long)kvh * group + (long)(blockIdx.y % chunks) * g;
  const int tid = threadIdx.x;
  // rank r merges outputs [r per, (r + 1) per) of the CTA's g x hd, per a
  // multiple of 4 (the pushes are 16 bytes)
  const int total = g * HD, per = ((total + ncl - 1) / ncl + 3) / 4 * 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::BARS);
  uint64_t* empty = full + C::NS;
  int4* info = reinterpret_cast<int4*>(base + C::INFO);

  if (tid == 0) {
    for (int s = 0; s < C::NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  T* ob = o + row0 * HD;
  if (tid >= NCT) {
    produce<T, HD, NQ>(&tk, &tv, valid + (long)b * S, base, info, full, empty, S, rank, ncl,
                       kvh, b, tid % 32);
  } else if constexpr (C::TC) {
    consume_tc<HD, NQ>(q + row0 * HD, ob, g, base, info, full, empty, scale_log2, tid, ncl,
                       rank, per);
  } else {
    consume_simt<T, HD>(q + row0 * HD, ob, g, base, info, full, empty, scale_log2, tid, ncl,
                        rank, per);
  }
  if (ncl == 1) return;                           // the consumers wrote the output

  // merge: every rank has pushed its m, l and its accumulators of this
  // rank's slice here; the barrier's release/acquire makes them visible
  cluster_sync();
  const float* acc = reinterpret_cast<const float*>(base + C::RCV);
  const float* rm = reinterpret_cast<const float*>(base + C::RCV_ML);
  const float* rl = rm + MAX_CLUSTER * C::GMAX;
  const int lo = rank * per, hi = min(total, lo + per);
  for (int idx = lo + tid; idx < hi; idx += NT) {
    const int n = idx / HD;
    float mx = NEG_INF;
    for (int c = 0; c < ncl; ++c) mx = fmaxf(mx, rm[c * C::GMAX + n]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < ncl; ++c) {
      const float f = exp2f(rm[c * C::GMAX + n] - mx);   // 0 for a rank that saw no slot
      l += rl[c * C::GMAX + n] * f;
      a += acc[c * per + idx - lo] * f;
    }
    store(ob + idx, l > 0.f ? a / l : 0.f);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
// Tensor maps of the caches, encoded once per (pointer, shape, dtype): a
// map is a function of these alone (the wrapper checks contiguity).
struct MapKey {
  const void* ptr;
  int B, S, heads, hd, es;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && B == o.B && S == o.S && heads == o.heads && hd == o.hd && es == o.es;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.B, k.S, k.heads, k.hd, k.es}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

std::mutex host_cache_mutex;   // the tensor maps' and the occupancy caches'

cudaError_t cached_map(CUtensorMap* out, const void* ptr, int es, int B, int S, int heads,
                       int hd) {
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{ptr, B, S, heads, hd, es};
  std::lock_guard<std::mutex> lock(host_cache_mutex);
  auto found = maps.find(key);
  if (found != maps.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  const cudaError_t err = tma_encode_bshd(out, ptr, es, B, S, heads, hd, TILE);
  if (err != cudaSuccess) return err;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *out);
  return cudaSuccess;
}

constexpr int MAX_DEVICES = 64;

// The kernel's shared-memory limit and non-portable cluster sizes (above
// 8), set once per device; then the number of clusters of `ncl` CTAs the
// card can hold at once (cudaOccupancyMaxActiveClusters), once per device
// and size.
template <typename T, int HD, int NQ>
cudaError_t active_clusters(int ncl, int device, int* out) {
  using C = Cfg<T, HD, NQ>;
  static bool ready[MAX_DEVICES] = {};
  static int known[MAX_DEVICES][MAX_CLUSTER + 1] = {};
  if (device < 0 || device >= MAX_DEVICES || ncl < 1 || ncl > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(host_cache_mutex);
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(da_cluster_kernel<T, HD, NQ>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)C::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(da_cluster_kernel<T, HD, NQ>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  if (known[device][ncl] == 0) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ncl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ncl, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = C::SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, da_cluster_kernel<T, HD, NQ>, &cfg);
    if (err != cudaSuccess) return err;
    known[device][ncl] = n + 1;                 // 0: not asked yet
  }
  *out = known[device][ncl] - 1;
  return cudaSuccess;
}

template <typename T, int HD, int NQ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* o,
                   int B, int S, int nq, int nkv, int g, int ncl, float scale, int device,
                   cudaStream_t stream) {
  using C = Cfg<T, HD, NQ>;
  int fits = 0;
  cudaError_t err = active_clusters<T, HD, NQ>(ncl, device, &fits);
  if (err != cudaSuccess) return err;
  if (fits == 0) return cudaErrorInvalidConfiguration;   // the card cannot hold one cluster
  CUtensorMap mk, mv;
  err = cached_map(&mk, k, sizeof(T), B, S, nkv, HD);
  if (err == cudaSuccess) err = cached_map(&mv, v, sizeof(T), B, S, nkv, HD);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ncl, nkv * (nq / nkv / g), B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = ncl > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, da_cluster_kernel<T, HD, NQ>, mk, mv, static_cast<const T*>(q),
                           static_cast<const uint8_t*>(valid), static_cast<T*>(o), S, nq, nkv, g,
                           scale * LOG2E);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// heads a CTA serves: the whole group on the tensor cores (bf16, <= 16),
// else the largest divisor of the group whose outputs the SIMT warpgroup
// holds (heads x hd <= 1024)
int heads_per_cta(bool tc, int group, int hd) {
  int g = group;
  if (!tc)
    while (g * hd > SIMT_OUTPUTS || group % g) --g;
  return g;
}

// fn.run<T, HD, NQ>() of the instantiation a call of (dtype, hd, group)
// launches: bf16 groups of <= 8 and <= 16 heads on the tensor cores, the
// rest on the SIMT units
template <typename T, int HD, typename F>
cudaError_t with_path(int group, const F& fn) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (group <= 8) return fn.template run<T, HD, 8>();
    if (group <= 16) return fn.template run<T, HD, 16>();
  }
  return fn.template run<T, HD, 0>();
}

template <typename T, typename F>
cudaError_t with_hd(int hd, int group, const F& fn) {
  switch (hd) {
    case 16: return with_path<T, 16>(group, fn);
    case 32: return with_path<T, 32>(group, fn);
    case 64: return with_path<T, 64>(group, fn);
    case 112: return with_path<T, 112>(group, fn);
    case 128: return with_path<T, 128>(group, fn);
    case 256: return with_path<T, 256>(group, fn);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_instance(int dtype, int hd, int group, const F& fn) {
  if (dtype == DTYPE_F32) return with_hd<float>(hd, group, fn);
  if (dtype == DTYPE_BF16) return with_hd<bf16>(hd, group, fn);
  return cudaErrorInvalidValue;
}

struct Forward {
  const void *q, *k, *v, *valid;
  void* o;
  int B, S, nq, nkv, clusters;
  float scale;
  int device;
  cudaStream_t stream;
  template <typename T, int HD, int NQ>
  cudaError_t run() const {
    return launch<T, HD, NQ>(q, k, v, valid, o, B, S, nq, nkv,
                             heads_per_cta(NQ > 0, nq / nkv, HD), clusters, scale, device, stream);
  }
};

struct ActiveClusters {
  int clusters, device;
  int* out;
  template <typename T, int HD, int NQ>
  cudaError_t run() const {
    return active_clusters<T, HD, NQ>(clusters, device, out);
  }
};

}  // namespace

// Returns a cudaError_t: the launch's own, or the error of setting the
// device, the kernel's attributes or a tensor map;
// cudaErrorInvalidConfiguration where the card cannot hold one cluster of
// `clusters` CTAs.  Shapes, dtypes, contiguity, alignment and the cluster
// size (1..16, from cluster_plan) come from the Python wrapper.
extern "C" int da_forward(const void* q, const void* k, const void* v, const void* valid,
                          void* o, int dtype, int B, int S, int nq, int nkv, int hd, int clusters,
                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Forward fwd{q, k, v, valid, o, B, S, nq, nkv, clusters, scale, device,
                    static_cast<cudaStream_t>(stream)};
  return (int)with_instance(dtype, hd, nq / nkv, fwd);
}

// How many clusters of `clusters` CTAs the card holds at once for the
// instantiation a call of (dtype, hd, group) launches, into *out.
extern "C" int da_max_active_clusters(int dtype, int hd, int group, int clusters, int device,
                                      int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)with_instance(dtype, hd, group, ActiveClusters{clusters, device, out});
}
