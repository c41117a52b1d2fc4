// Flash-decode for Hopper (sm_90a): one query token per sequence against
// its KV cache, f32 or bf16 in, f32 softmax, the cache split across CTAs.
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
// it takes enough bytes in flight on every SM, and at decode batch sizes
// there are few (batch, kv head) pairs: 128 for qwen1.5-0.5b at 8 slots, 64
// for llama3-8b, on 132 SMs.  What the design does about it:
//  - split S: the grid is (splits, nkv, B) and each CTA owns a contiguous
//    range of slots; the wrapper picks the split count from B, nkv, S and
//    the SM count alone (never from `valid`, so no host sync).  Each split
//    writes its f32 partials (running max, sum, unnormalised accumulator
//    per query head) to scratch, and da_combine_kernel merges them per
//    (b, q head); with one split the CTA writes the output itself;
//  - skip what is empty: each warp owns 16 slots of every 64-slot tile of
//    its range and reads the mask of 32 such sub-tiles at once (16 bytes a
//    lane, one ballot); empty sub-tiles are never visited, a split with no
//    valid slot exits after that read, and masked slots inside a sub-tile
//    are zero-filled by cp.async without being read.  Ring holes anywhere
//    in the cache work the same as prefix masks;
//  - loads in flight: each warp streams its non-empty sub-tiles' K and V
//    rows with 16-byte cp.async through its own ring of 3 stages (2 at
//    hd 128 and in f32, 1 at hd 256), so only __syncwarp orders a warp's
//    work and up to 2 sub-tiles per warp are in flight while one computes;
//    no load waits on a probability;
//  - each K/V row is read once and serves the whole GQA group of nq/nkv
//    query heads.  In bf16 a group of <= 16 heads is the 16 rows of
//    mma.sync m16n8k16: q K^T and P V of a 16-slot sub-tile are 2 * hd/16
//    and 2 * hd/8 tensor-core products (P as a bf16 high and a bf16 low
//    part, so that the output is within one bf16 step of the f32
//    attention, as the TPU kernel's f32 P is), with the online softmax in
//    the accumulator registers; f32 (held to 2e-5) and larger groups score on
//    the SIMT units, two half-warps per slot.  A SIMT warp holds at most
//    MAX_PAIRS x 64 = 1024 outputs (heads x hd), so a larger group (f32 at
//    recurrentgemma-9b's 16 heads of 256) is cut into chunks of heads, one
//    CTA each, every chunk reading the K/V rows again;
//  - hd 256 in bf16 (16 q heads over 1 kv head): the P V accumulators take
//    hd/8 x 4 = 128 f32 registers a lane, so the q fragments are reloaded
//    from shared memory at each k-step instead of held (64 registers).
//    Each warp's ring has one stage: shared memory 89,344 bytes (K/V
//    67,584, q 16,896, warp state), two CTAs per SM.  A warp's copy of its
//    next sub-tile then waits for its compute, but at recurrentgemma-9b's
//    decode (32 splits of 64 slots) every warp owns one sub-tile of a
//    split, and the other CTA's warps keep loads in flight;
//  - the warps' online-softmax states merge in shared memory at the end of
//    the range;
//  - hd 112 (kimi-k2's 64 q heads over 8 kv heads, a group of 8): a row
//    is 14 sixteen-byte chunks in bf16 and 28 in f32, which divide no
//    warp, so 28 lanes copy (2 rows of 14 lanes a pass in bf16, 1 row of
//    28 in f32) and 4 lanes idle; the tensor-core path takes hd 112 as it
//    is (7 k-steps of q K^T, 7 x 16 output columns of P V, q fragments
//    held: 28 registers), and the SIMT half-rows are 56 dims, whole chunks
//    of either type.
// What is left: the combine is a second launch whenever S is split; at
// decode's small sizes the two launches and their cold reads (q, the
// mask, K/V, then the partials) are most of the time.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NW = 4;             // warps per CTA
constexpr int NT = 32 * NW;
constexpr int SUB = 16;           // cache slots of a warp's sub-tile
constexpr int TS = NW * SUB;      // slots of a CTA tile
constexpr int MAX_PAIRS = 16;     // SIMT output pairs per lane: heads x hd <= 1024 a CTA
constexpr unsigned FULL = 0xffffffffu;

// ring stages per warp: 3 in bf16 (2 sub-tiles in flight while one
// computes), 2 where 3 would cost CTAs per SM (hd 128, f32), 1 at hd 256,
// where a stage of the 4 warps' K and V rows is 67,584 bytes in bf16 and
// 133,120 in f32 (two would not fit in f32, nor two CTAs an SM in bf16)
template <typename T, int HD>
__host__ __device__ constexpr int stages() {
  return HD >= 256 ? 1 : (sizeof(T) == 2 && HD < 128 ? 3 : 2);
}

// elements per 16-byte chunk, and a shared-memory row: hd and 16 bytes of pad
template <typename T>
__host__ __device__ constexpr int epc() { return 16 / (int)sizeof(T); }
template <typename T, int HD>
__host__ __device__ constexpr int ld() { return HD + epc<T>(); }

template <typename T, int HD>
__host__ __device__ constexpr size_t ring_bytes() {
  return (size_t)NW * stages<T, HD>() * 2 * SUB * ld<T, HD>() * sizeof(T);
}

// q: on the SIMT path f32, two halves of hd per head padded by 4 floats
// (the two half-warps read them in different banks); on the tensor-core
// path 16 rows of hd + 8 bf16, rows past the group zero
template <int HD>
__host__ __device__ constexpr int q_row() { return HD + 8; }

template <typename T, int HD>
size_t smem_bytes(int g) {
  // the ring, reused at the end for the warps' accumulators (NW x g x hd f32)
  const size_t ring = ring_bytes<T, HD>() > (size_t)NW * g * HD * sizeof(float)
                          ? ring_bytes<T, HD>() : (size_t)NW * g * HD * sizeof(float);
  // q, then per warp: probabilities (g x SUB), m, l, alpha (g each)
  return ring + sizeof(float) * ((g > 8 ? g : 8) * q_row<HD>() + NW * (g * SUB + 3 * g));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load_chunk(const float* p, float (&o)[4]) { load4(p, o); }
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&o)[8]) {
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
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// TC: scores and P V on the tensor cores (bf16, a group of <= 16 heads as
// the 16 rows of mma.sync m16n8k16); else on the SIMT units.  The CTA
// serves `g` heads of its kv head's group of nq/nkv (a chunk of the group
// on the SIMT path, the whole group on the tensor cores): grid (splits,
// nkv x chunks, B).
template <typename T, int HD, bool TC>
__global__ void __launch_bounds__(NT) da_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const uint8_t* __restrict__ valid, T* __restrict__ o, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int S, int nq, int nkv, int g, int splits, int chunk,
    float scale_log2) {
  constexpr int EPC = epc<T>();
  constexpr int LD = ld<T, HD>();
  constexpr int CPR = HD / EPC;   // 16-byte chunks per row
  constexpr int LPR = CPR < 32 ? CPR : 32;   // lanes copying one row
  constexpr int CPL = CPR / LPR;  // chunks of a row per lane
  constexpr int RPP = 32 / LPR;   // rows per pass of a warp's copies
  // lanes that copy: all 32 where LPR divides the warp; at hd 112 (14
  // chunks a bf16 row, 28 an f32 row) 28, and the other 4 idle
  constexpr int COPY_LANES = RPP * LPR;
  static_assert(CPR % LPR == 0 && SUB % RPP == 0, "whole passes");
  constexpr int NS = stages<T, HD>();
  constexpr int KS = HD / 16;     // tensor cores: k-steps of q K^T
  constexpr int DB = HD / 8;      // tensor cores: 8-dim blocks of the output
  constexpr bool Q_IN_REGS = HD <= 128;   // tensor cores: q fragments held, else reloaded
  constexpr int HALF = HD / 2;    // dims each half-warp scores
  constexpr int QR = q_row<HD>();
  static_assert(HALF % EPC == 0, "a half row is whole chunks");

  const int group = nq / nkv, chunks = TC ? 1 : group / g;   // the tensor cores take a group whole
  const int split = blockIdx.x, kvh = blockIdx.y / chunks, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  size_t ring_sz = ring_bytes<T, HD>();
  if (ring_sz < (size_t)NW * g * HD * sizeof(float)) ring_sz = (size_t)NW * g * HD * sizeof(float);
  float* qs = reinterpret_cast<float*>(smem_raw + ring_sz);   // max(g, 8) x QR
  float* wst = qs + (g > 8 ? g : 8) * QR;                     // per-warp state
  float* my_p = wst + warp * (g * SUB + 3 * g);               // g x SUB
  float* my_m = my_p + g * SUB;                               // log2 units
  float* my_l = my_m + g;
  float* my_a = my_l + g;

  const int start = split * chunk;
  const int end = split == splits - 1 ? S : start + chunk;
  const long kv_stride = (long)nkv * HD;
  const T* kb = kc + (long)b * S * kv_stride + (long)kvh * HD;
  const T* vb = vc + (long)b * S * kv_stride + (long)kvh * HD;
  const uint8_t* vmask = valid + (long)b * S;
  // the CTA's first q head
  const long row0 = (long)b * nq + (long)kvh * group + (long)(blockIdx.y % chunks) * g;

  if constexpr (TC) {
    T* qt = reinterpret_cast<T*>(qs);
    for (int idx = tid; idx < 16 * HD; idx += NT) {
      const int h = idx / HD, d = idx % HD;
      qt[h * LD + d] = h < g ? q[row0 * HD + idx] : __float2bfloat16(0.f);
    }
  } else {
    for (int idx = tid; idx < g * HD; idx += NT) {
      const int h = idx / HD, d = idx % HD;
      qs[h * QR + d + (d >= HALF ? 4 : 0)] = to_float(q[row0 * HD + idx]);
    }
  }
  for (int h = lane; h < g; h += 32) {
    my_m[h] = NEG_INF;
    my_l[h] = 0.f;
  }
  __syncthreads();

  float acc[MAX_PAIRS][2];         // SIMT: this lane's output pairs
#pragma unroll
  for (int j = 0; j < MAX_PAIRS; ++j) acc[j][0] = acc[j][1] = 0.f;
  // tensor cores: q fragments, and for heads gid and gid + 8 the running
  // max (log2 units), this lane's part of the sum and the output fragments
  const int gid = lane / 4, tig = lane % 4;
  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float oacc[DB][4];
  // this lane's ldmatrix address of the q rows; a k-step adds 16
  const T* qp = reinterpret_cast<const T*>(qs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                (lane >> 4) * 8;
  if constexpr (TC) {
    if constexpr (Q_IN_REGS) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], qp + ks * 16);
    }
#pragma unroll
    for (int j = 0; j < DB; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  }

  const int n_sub = (end - start + TS - 1) / TS;   // sub-tiles of this warp
  T* wring = ring + (size_t)warp * NS * 2 * SUB * LD;
  const int r = lane % SUB, half = lane / SUB;     // scoring: slot r, half of hd
  const int col = (lane % LPR) * EPC;              // copies: this lane's first 16 bytes of a row
  bool any = false;

  for (int g0 = 0; g0 < n_sub; g0 += 32) {
    // valid bits of sub-tile g0 + lane: one mask read per 32 sub-tiles
    unsigned bits = 0;
    if (g0 + lane < n_sub) {
      const int base = start + (g0 + lane) * TS + warp * SUB;
#pragma unroll
      for (int i = 0; i < SUB; ++i)
        if (base + i < end && vmask[base + i]) bits |= 1u << i;
    }
    unsigned pend = __ballot_sync(FULL, bits != 0);   // sub-tiles to visit
    if (!pend) continue;
    any = true;
    unsigned todo = pend;                              // sub-tiles to fetch

    // fetch the next non-empty sub-tile into `stage`; always commit a group,
    // empty or not, so that wait_group counts stay fixed
    auto fetch = [&](int stage) {
      if (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const unsigned bi = __shfl_sync(FULL, bits, i);
        const int base = start + (g0 + i) * TS + warp * SUB;
        T* dk = wring + (size_t)stage * 2 * SUB * LD;
        T* dv = dk + SUB * LD;
        // each copying lane copies CPL 16-byte columns, LPR chunks apart,
        // of every RPP-th row
        if (COPY_LANES == 32 || lane < COPY_LANES) {
#pragma unroll
          for (int i = 0; i < SUB / RPP; ++i) {
            const int rr = lane / LPR + i * RPP;
            const bool ok = (bi >> rr) & 1u;
            const long off = ok ? (long)(base + rr) * kv_stride + col : 0;
#pragma unroll
            for (int c = 0; c < CPL; ++c) {
              cp_async16(dk + rr * LD + col + c * LPR * EPC, kb + off + c * LPR * EPC, ok);
              cp_async16(dv + rr * LD + col + c * LPR * EPC, vb + off + c * LPR * EPC, ok);
            }
          }
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int st = 0; st < NS - 1; ++st) fetch(st);
    int stage = 0;
    while (pend) {
      const int i = __ffs(pend) - 1;
      pend &= pend - 1;
      fetch((stage + NS - 1) % NS);
      cp_async_wait<NS - 1>();                    // sub-tile i has landed
      __syncwarp();
      const unsigned bi = __shfl_sync(FULL, bits, i);
      const T* tk = wring + (size_t)stage * 2 * SUB * LD;
      const T* tv = tk + SUB * LD;
      if constexpr (TC) {
        // S (16 heads x 16 slots) = Q K^T; x4 matrices (slots 0-7 | 8-15) x
        // (dims 0-7 | 8-15) of each k-step
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if constexpr (!Q_IN_REGS) ldmatrix_x4(qf[0], qp + ks * 16);
          const uint32_t(&qa)[4] = qf[Q_IN_REGS ? ks : 0];
          uint32_t kf[4];
          ldmatrix_x4(kf, tk + ((lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16_16816(sc[0], qa, kf[0], kf[1]);
          mma_bf16_16816(sc[1], qa, kf[2], kf[3]);
        }
        // online softmax of rows gid, gid + 8 over the quad that holds them
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = (bi >> (j * 8 + 2 * tig + (e & 1))) & 1u;
            sc[j][e] = ok ? sc[j][e] * scale_log2 : NEG_INF;
          }
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
        mx0 = group_max(mx0, 4);
        mx1 = group_max(mx1, 4);
        const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = is_live(sc[j][e]) ? exp2f(sc[j][e] - (e < 2 ? m0 : m1)) : 0.f;
            sc[j][e] = p;
            if (e < 2) ps0 += p; else ps1 += p;
          }
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
        // O += P V: P as bf16 A fragments from the S registers, split into
        // high and low parts (two products, ~16 bits of P, as the f32 P of
        // the TPU kernel: one bf16 part alone moves o by over a bf16 step
        // where |o| is small and sum p|v| large), V by ldmatrix.trans, x4
        // matrices (slots 0-7 | 8-15) x (dims 0-7 | 8-15)
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[0][0], sc[0][1], ph[0], pl[0]);
        split_bf16x2(sc[0][2], sc[0][3], ph[1], pl[1]);
        split_bf16x2(sc[1][0], sc[1][1], ph[2], pl[2]);
        split_bf16x2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
        for (int d2 = 0; d2 < DB / 2; ++d2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, tv + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + d2 * 16 +
                                    (lane >> 4) * 8);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float* a = oacc[2 * d2 + jj];
            a[0] *= alpha0; a[1] *= alpha0; a[2] *= alpha1; a[3] *= alpha1;
          }
          mma_bf16_16816(oacc[2 * d2], ph, vf[0], vf[1]);
          mma_bf16_16816(oacc[2 * d2 + 1], ph, vf[2], vf[3]);
          mma_bf16_16816(oacc[2 * d2], pl, vf[0], vf[1]);
          mma_bf16_16816(oacc[2 * d2 + 1], pl, vf[2], vf[3]);
        }
        __syncwarp();                             // the stage is free again
        stage = (stage + 1) % NS;
        continue;
      }
      const bool ok = (bi >> r) & 1u;

      // 1. logits of slot r, half-warps on the two halves of hd; then the
      //    online softmax of each head over the sub-tile's 16 slots
      for (int h = 0; h < g; ++h) {
        const T* krow = tk + r * LD + half * HALF;
        const float* qh = qs + h * QR + half * (HALF + 4);
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < HALF; c += EPC) {
          float kf[EPC];
          load_chunk(krow + c, kf);
#pragma unroll
          for (int e = 0; e < EPC; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qh + c + e);
            part = fmaf(qv.x, kf[e], part);
            part = fmaf(qv.y, kf[e + 1], part);
            part = fmaf(qv.z, kf[e + 2], part);
            part = fmaf(qv.w, kf[e + 3], part);
          }
        }
        part += __shfl_xor_sync(FULL, part, 16);
        const float sv = ok ? part * scale_log2 : NEG_INF;
        const float m_old = my_m[h];
        const float m_new = fmaxf(m_old, group_max(sv, SUB));
        const float p = ok ? exp2f(sv - m_new) : 0.f;
        const float psum = group_sum(p, SUB);
        __syncwarp();                             // every lane has read my_m[h]
        if (lane == 0) {
          const float alpha = exp2f(m_old - m_new);
          my_m[h] = m_new;
          my_l[h] = my_l[h] * alpha + psum;
          my_a[h] = alpha;
        }
        if (half == 0) my_p[h * SUB + r] = p;
      }
      __syncwarp();

      // 2. P V: this lane's output pairs e = 2 lane + 64 j of the g x hd
      //    outputs; masked slots have p = 0 and zero-filled rows
#pragma unroll
      for (int j = 0; j < MAX_PAIRS; ++j) {
        const int e = 2 * lane + 64 * j;
        if (e < g * HD) {
          const int h = e / HD, d = e % HD;
          const float alpha = my_a[h];
          float a0 = acc[j][0] * alpha, a1 = acc[j][1] * alpha;
          const float* ph = my_p + h * SUB;
#pragma unroll
          for (int rr = 0; rr < SUB; ++rr) {
            const float2 vv = load2(tv + rr * LD + d);
            a0 = fmaf(ph[rr], vv.x, a0);
            a1 = fmaf(ph[rr], vv.y, a1);
          }
          acc[j][0] = a0;
          acc[j][1] = a1;
        }
      }
      __syncwarp();                               // the stage and my_p are free again
      stage = (stage + 1) % NS;
    }
  }
  cp_async_wait<0>();
  if constexpr (TC) {             // the warp's state of the group's heads to shared memory
    l0 = group_sum(l0, 4);
    l1 = group_sum(l1, 4);
    if (tig == 0 && gid < g) {
      my_m[gid] = m0;
      my_l[gid] = l0;
    }
    if (tig == 0 && gid + 8 < g) {
      my_m[gid + 8] = m1;
      my_l[gid + 8] = l1;
    }
  }

  T* ob = o + row0 * HD;
  if (!__syncthreads_or(any)) {
    // no valid slot in this range: one split writes 0, as the Pallas
    // kernel does; otherwise an empty partial (max -1e30, sum 0)
    if (splits == 1) {
      for (int idx = tid; idx < g * HD; idx += NT) store(ob + idx, 0.f);
    } else {
      for (int h = tid; h < g; h += NT) {
        part_ml[((row0 + h) * splits + split) * 2] = NEG_INF;
        part_ml[((row0 + h) * splits + split) * 2 + 1] = 0.f;
      }
    }
    return;
  }

  // merge the warps' states: accumulators through the (now idle) ring
  float* cs = reinterpret_cast<float*>(smem_raw);
  if constexpr (TC) {
#pragma unroll
    for (int j = 0; j < DB; ++j) {
      const int d = j * 8 + 2 * tig;
      if (gid < g) {
        cs[warp * g * HD + gid * HD + d] = oacc[j][0];
        cs[warp * g * HD + gid * HD + d + 1] = oacc[j][1];
      }
      if (gid + 8 < g) {
        cs[warp * g * HD + (gid + 8) * HD + d] = oacc[j][2];
        cs[warp * g * HD + (gid + 8) * HD + d + 1] = oacc[j][3];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < MAX_PAIRS; ++j) {
      const int e = 2 * lane + 64 * j;
      if (e < g * HD) {
        cs[warp * g * HD + e] = acc[j][0];
        cs[warp * g * HD + e + 1] = acc[j][1];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * HD; idx += NT) {
    const int h = idx / HD;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, wst[w * (g * SUB + 3 * g) + g * SUB + h]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* st = wst + w * (g * SUB + 3 * g) + g * SUB;
      const float f = exp2f(st[h] - m);           // 0 for a warp that saw no slot
      l += st[g + h] * f;
      a += cs[w * g * HD + idx] * f;
    }
    if (splits == 1) {
      store(ob + idx, l > 0.f ? a / l : 0.f);
    } else {
      part_acc[((row0 + h) * splits + split) * HD + idx % HD] = a;
      if (idx % HD == 0) {
        part_ml[((row0 + h) * splits + split) * 2] = m;
        part_ml[((row0 + h) * splits + split) * 2 + 1] = l;
      }
    }
  }
}

// out[row, d] for row = b * nq + h: the splits' partials merged.  A split
// with sum 0 (no valid slot) contributes nothing and its accumulator, never
// written, is not read; a row whose splits are all empty gives 0.
template <typename T>
__global__ void __launch_bounds__(256) da_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc, T* __restrict__ o,
    int rows, int hd, int splits) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)rows * hd) return;
  const long row = idx / hd;
  const int d = idx % hd;
  const float* ml = part_ml + row * splits * 2;
  float m = NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {
      const float f = exp2f(ml[2 * s] - m);
      l += ls * f;
      a += part_acc[(row * splits + s) * hd + d] * f;
    }
  }
  store(o + idx, l > 0.f ? a / l : 0.f);
}

template <typename T, int HD, bool TC>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* valid,
                         void* o, float* part_ml, float* part_acc, int B, int S, int nq,
                         int nkv, int splits, int chunk, float scale, cudaStream_t stream) {
  // heads per CTA: the whole group on the tensor cores (<= 16), else the
  // largest divisor of the group whose outputs a warp holds (<= 1024)
  const int group = nq / nkv;
  int g = group;
  if (!TC)
    while (g * HD > 64 * MAX_PAIRS || group % g) --g;
  const size_t smem = smem_bytes<T, HD>(g);
  cudaError_t err = cudaFuncSetAttribute(
      da_split_kernel<T, HD, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(splits, nkv * (group / g), B);
  da_split_kernel<T, HD, TC><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(o), part_ml, part_acc, S, nq, nkv, g,
      splits, chunk, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* o,
                   void* part, int B, int S, int nq, int nkv, int splits, int chunk,
                   float scale, cudaStream_t stream) {
  float* part_ml = static_cast<float*>(part);
  float* part_acc = part_ml ? part_ml + (size_t)B * nq * splits * 2 : nullptr;
  // bf16 groups of up to 16 heads fill the 16 rows of an mma; f32 (held to
  // 2e-5) and larger groups run on the SIMT units
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = nq / nkv <= 16
              ? launch_split<T, HD, true>(q, k, v, valid, o, part_ml, part_acc, B, S, nq, nkv,
                                          splits, chunk, scale, stream)
              : launch_split<T, HD, false>(q, k, v, valid, o, part_ml, part_acc, B, S, nq, nkv,
                                           splits, chunk, scale, stream);
  } else {
    err = launch_split<T, HD, false>(q, k, v, valid, o, part_ml, part_acc, B, S, nq, nkv,
                                     splits, chunk, scale, stream);
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long n = (long)B * nq * HD;
  da_combine_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(o), B * nq, HD, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* valid,
                     void* o, void* part, int B, int S, int nq, int nkv, int splits, int chunk,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    case 32: return launch<T, 32>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    case 112: return launch<T, 112>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    case 256: return launch<T, 256>(q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the first launch's or the combine's, or the error
// of setting the device or the shared-memory limit.  Shapes, dtypes,
// contiguity, alignment and the split plan (splits ranges of `chunk` slots, the last one to S; scratch
// `part` of B*nq*splits*(hd+2) floats when splits > 1) come from the
// Python wrapper.
extern "C" int da_forward(const void* q, const void* k, const void* v, const void* valid,
                          void* o, void* part, int dtype, int B, int S, int nq, int nkv, int hd,
                          int splits, int chunk, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)dispatch<float>(hd, q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk, scale, st);
  if (dtype == DTYPE_BF16)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, valid, o, part, B, S, nq, nkv, splits, chunk,
                                        scale, st);
  return (int)cudaErrorInvalidValue;
}
