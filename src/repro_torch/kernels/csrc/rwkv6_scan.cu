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
// Every exponent formed is a sum of log-decays, so <= 0: each factor is at
// most 1 and strong decay underflows to 0 instead of overflowing.  Pairs
// s >= t are never formed.  Rows past T load r = k = v = 0 and log w = 0
// and are not stored (the Pallas wrapper pads T on the host instead).
//
// What bounds it on this card: bytes.  A token costs 4 hd^2 operations per
// head against 5 hd elements moved (r, k, v, w in, o out) plus the state
// read once and written once per call: ~16 operations per byte in bf16 at
// hd 64, far below the H100's ~295.  rwkv6-1.6b's prefill (B=1, T=500,
// H=32, hd 64, bf16) moves 11.3 MB: 3.37 us at 3.35 TB/s; its decode step
// (8 slots, T=1) moves 8.55 MB, nearly all of it state: 2.55 us.  What holds
// a call back instead is latency: few CTAs at batch 1, serial chunks, and
// launches.  rwkv6_forward picks one of three designs by T and the dtype.
//
// bf16, T > C (prefill): chunk-parallel, the carry the only serial step.
//  1. tc::chunk_state_kernel, one CTA per (b, h, chunk): the chunk's state
//     increment dS_c = (k 2^(P[L]-P[s+1]))^T v on the tensor cores and its
//     decay 2^P[L], into scratch the wrapper allocates;
//  2. tc::carry_kernel, one thread per 4 state elements: S_c = 2^P[L] S_{c-1}
//     + dS_c over the chunks in order, each dS_c slot overwritten with the
//     carry-in S_{c-1} (chunk 0's with s0) before sT is written.  Its loads
//     do not depend on the carry, so 16 chunks' are in flight at once; each
//     element is read and written by one thread, so s0 may alias sT;
//  3. tc::chunk_out_kernel, one CTA per (b, h, chunk): the chunk's outputs.
//     The chunk splits at e = 16 into two sub-chunks.  Pairs within a
//     sub-chunk (240 of the 496) stay pairwise with the ratio inside the hd
//     reduction; the off-diagonal block factors at the edge,
//     A = (r_t 2^(P[t]-P[e])) . (k_s 2^(P[e]-P[s+1])), both exponents <= 0,
//     and is a tensor-core product over hd, as are A v and dS.  The
//     carry-in term (r 2^P) S_{c-1} is an f32 SIMT product in the mma
//     accumulator layout, each element of S_{c-1} read once per CTA.
//  Kernels 2 and 3 are launched with programmatic dependent launch: kernel
//  3 loads r, k, v, w and computes A, its parts and the edge factors while
//  kernels 1 and 2 still run, and waits only before it reads its carry-in
//  slot (never s0, which may hold sT by then).  Regions of shared memory
//  that no phase uses at once share space, so that at hd 64 four CTAs of
//  kernel 3 fit an SM and the main path's 512 run in one wave.  A T <= C
//  launch is one chunk: chunk_out_kernel alone, also writing the state from
//  s0 (read into shared memory before any of it is written).
//  Exponents: every one is the sum of the log-decays between its two ends,
//  summed directly by a thread that walks the tokens (one thread per
//  (sub-chunk, column); the in-sub-chunk pairs by one warp per (sub-chunk,
//  s) walking t upwards, lanes over columns, its 15 scores summed over the
//  lanes by one reduce-scatter).  None is a difference of two prefixes,
//  which under strong decay are large and would cancel.
//  Precision: the tensor cores take each f32 operand (A, the two edge
//  factors, the decayed k) as three bf16 parts, hi + mid + lo, that hold its
//  24 bits (store_split; v, r and k themselves are bf16 already), so every
//  product keeps f32's precision and the bf16 output is rounded once, from
//  an f32-accurate value, as the plain version rounds it.  One rounding of A
//  to bf16 would put errors of ~1e-2 under outputs of |o| >= 8, where one
//  bf16 step (0.0625) already exceeds the 5e-2 tolerance.
//
// T = 1 (every decode step), f32 and bf16: decode::decode_kernel, no chunk
//  machinery.  Per (b, h): o_j = sum_i r_i (S_ij + u_i k_i v_j) and
//  S'_ij = w_i S_ij + k_i v_j.  Each thread owns 16-byte column quads of a
//  few state rows and issues every load before it computes (16-64 bytes of
//  state in flight per thread, grid (H, B)), writes S' over them in place,
//  and o is reduced over rows by shuffles and a 1-4 KB shared-memory pass.
//
// f32, T > 1: simt::rwkv6_kernel, the SIMT kernel of the first port: the
//  f32 tolerance (1e-4) rules out bf16 or TF32 operands.  Grid (hd/16, H,
//  B): each CTA owns 16 value columns of the state and walks every chunk in
//  shared memory, the (C, C) scores reduced pairwise in f32.  Its
//  exponents are differences of the chunk's prefixes P, so P is summed and
//  kept in double: under strong decay (log2 w down to -80 a token) an f32
//  P reaches ~2,500 within a chunk, where one f32 ulp is ~1e-4 of an
//  exponent, and a pair with little decay between its ends but much
//  before them missed the plain version by 1.7e-4 at T = 500, H = 32
//  (tests/test_torch_cuda.py::test_rwkv6_kernel_f32_strong_decay_at_the_served_shape).
//  Each difference is taken in double and rounded to f32 before exp2f.
#include <type_traits>

#include "common.cuh"

// Every kernel of this library is in namespace rwkv6, so that a profile
// finds them all by that prefix of their names.
namespace rwkv6 {

constexpr int C = 32;             // tokens per chunk: one per lane in the prefix scans
// log of the smallest decay, as the TPU kernel clamps it: keeps log2 finite at w = 0
constexpr float W_MIN = 1e-38f;
constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32, T > 1: the SIMT kernel of the first port, unchanged.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps per CTA
constexpr int VS = 16;            // value columns (of S and o) per CTA
constexpr int VEC = 4;            // elements per 16-byte load
static_assert(NT == C * (VS / 2), "step 5 gives each thread one token and two columns");

template <int HD>
struct Smem {
  static constexpr int LD = HD + 4;                 // row stride of the (C, HD) tiles
  static constexpr int R = 0;                       // r, then r 2^P[t]          (C x LD)
  static constexpr int K = R + C * LD;              // k, then k 2^(P[L]-P[s+1])  (C x LD)
  static constexpr int P = K + C * LD;              // log2 w, then P, double    ((C+1) x LD)
  static constexpr int V = P + 2 * (C + 1) * LD;    // this CTA's v columns      (C x VS)
  static constexpr int S = V + C * VS;              // this CTA's state columns  (HD x VS)
  static constexpr int A = S + HD * VS;             // pair scores               (C x (C+1))
  static constexpr int U = A + C * (C + 1);         // bonus u                   (HD)
  static constexpr int BONUS = U + HD;              // (r_t u) . k_t             (C)
  static constexpr int FLOATS = BONUS + C;
  static_assert(LD % VEC == 0 && K % VEC == 0 && P % VEC == 0 && V % VEC == 0 &&
                    S % VEC == 0, "16-byte aligned tiles");
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) rwkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u,
    const float* s0,              // may alias sT: each CTA reads its slice before writing it
    float* sT, T* __restrict__ o, int Tn, int H) {
  using L_ = Smem<HD>;
  constexpr int LD = L_::LD;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm + L_::R;
  float* ks = sm + L_::K;
  double* ps = reinterpret_cast<double*>(sm + L_::P);
  float* vs = sm + L_::V;
  float* ss = sm + L_::S;
  float* as = sm + L_::A;
  float* us = sm + L_::U;
  float* bonus = sm + L_::BONUS;

  const int j0 = blockIdx.x * VS;   // this CTA's first value column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // state slice: thread owns rows i = item / 4, columns 4 * (item % 4) .. +3
  const long s_base = ((long)b * H + h) * HD * HD + j0;
  for (int item = tid; item < HD * (VS / VEC); item += NT) {
    const int i = item / (VS / VEC), jq = (item % (VS / VEC)) * VEC;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s0 != nullptr) x = *reinterpret_cast<const float4*>(s0 + s_base + (long)i * HD + jq);
    *reinterpret_cast<float4*>(ss + i * VS + jq) = x;
  }
  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];
  for (int i = tid; i < HD; i += NT) ps[i] = 0.0;   // P[0] = 0

  const long row_stride = (long)H * HD;             // between tokens
  const long seq_base = (long)b * Tn * row_stride + (long)h * HD;

  for (int c0 = 0; c0 < Tn; c0 += C) {
    const int L = min(C, Tn - c0);                  // tokens in this chunk
    const long chunk_base = seq_base + (long)c0 * row_stride;

    // 1. stage r, k, log2 w (rows >= L: r = k = 0, log w = 0) and v's columns
    for (int e = tid; e < C * (HD / VEC); e += NT) {
      const int t = e / (HD / VEC), i = (e % (HD / VEC)) * VEC;
      float rf[4] = {0.f, 0.f, 0.f, 0.f}, kf[4] = {0.f, 0.f, 0.f, 0.f};
      float lw[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < L) {
        const long off = chunk_base + (long)t * row_stride + i;
        float wf[4];
        load4(r + off, rf);
        load4(k + off, kf);
        load4(w + off, wf);
#pragma unroll
        for (int q = 0; q < VEC; ++q) lw[q] = log2f(fmaxf(wf[q], W_MIN));
      }
      *reinterpret_cast<float4*>(rs + t * LD + i) = make_float4(rf[0], rf[1], rf[2], rf[3]);
      *reinterpret_cast<float4*>(ks + t * LD + i) = make_float4(kf[0], kf[1], kf[2], kf[3]);
      *reinterpret_cast<double2*>(ps + (t + 1) * LD + i) = make_double2(lw[0], lw[1]);
      *reinterpret_cast<double2*>(ps + (t + 1) * LD + i + 2) = make_double2(lw[2], lw[3]);
    }
    for (int e = tid; e < C * (VS / VEC); e += NT) {
      const int t = e / (VS / VEC), jq = (e % (VS / VEC)) * VEC;
      float vf[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < L) load4(v + chunk_base + (long)t * row_stride + j0 + jq, vf);
      *reinterpret_cast<float4*>(vs + t * VS + jq) = make_float4(vf[0], vf[1], vf[2], vf[3]);
    }
    __syncthreads();

    // 2. P[t+1] = inclusive prefix of log2 w over the chunk: one warp per
    //    state row i, one lane per token
    for (int i = warp; i < HD; i += NW) {
      double x = ps[(lane + 1) * LD + i];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const double y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      ps[(lane + 1) * LD + i] = x;
    }
    __syncthreads();

    // 3a. A[t,s] for s < t < L.  Rows t and 31 - t together hold 31 pairs,
    //     so virtual row vr in 0..15 gives lane e the pair
    //     (vr, e) if e < vr, else (31 - vr, e - vr); lane 31 idles.
    if (L > 1) {
      for (int vr = warp; vr < C / 2; vr += NW) {
        const int t = lane < vr ? vr : C - 1 - vr;
        const int s = lane < vr ? lane : lane - vr;
        if (lane < C - 1 && t < L) {
          const float* rt = rs + t * LD;
          const double* pt = ps + t * LD;
          const float* kq = ks + s * LD;
          const double* pq = ps + (s + 1) * LD;
          float acc = 0.f;
#pragma unroll 4
          for (int i = 0; i < HD; i += VEC) {
            const float4 a = *reinterpret_cast<const float4*>(rt + i);
            const float4 kk = *reinterpret_cast<const float4*>(kq + i);
            const double2 la0 = *reinterpret_cast<const double2*>(pt + i);
            const double2 la1 = *reinterpret_cast<const double2*>(pt + i + 2);
            const double2 lb0 = *reinterpret_cast<const double2*>(pq + i);
            const double2 lb1 = *reinterpret_cast<const double2*>(pq + i + 2);
            acc = fmaf(a.x * kk.x, exp2f(static_cast<float>(la0.x - lb0.x)), acc);
            acc = fmaf(a.y * kk.y, exp2f(static_cast<float>(la0.y - lb0.y)), acc);
            acc = fmaf(a.z * kk.z, exp2f(static_cast<float>(la1.x - lb1.x)), acc);
            acc = fmaf(a.w * kk.w, exp2f(static_cast<float>(la1.y - lb1.y)), acc);
          }
          as[t * (C + 1) + s] = acc;
        }
      }
    }
    // 3b. bonus[t] = (r_t u) . k_t, one warp per token
    for (int t = warp; t < L; t += NW) {
      float part = 0.f;
      for (int i = lane; i < HD; i += 32) part += rs[t * LD + i] * us[i] * ks[t * LD + i];
      part = group_sum(part, 32);
      if (lane == 0) bonus[t] = part;
    }
    __syncthreads();

    // 4. r <- r 2^P[t] (carry-in weights), k <- k 2^(P[L] - P[s+1]) (carry-out)
    const double* pL = ps + L * LD;
    for (int e = tid; e < L * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      rs[t * LD + i] *= exp2f(static_cast<float>(ps[t * LD + i]));
      ks[t * LD + i] *= exp2f(static_cast<float>(pL[i] - ps[(t + 1) * LD + i]));
    }
    __syncthreads();

    // 5. o_t[j] = (r_t 2^P[t]) . S0[:, j] + sum_{s<t} A[t,s] v_s[j] + bonus_t v_t[j]
    //    thread: token t = tid / 8, columns 2 * (tid % 8) and +1
    {
      const int t = tid / (VS / 2), j = (tid % (VS / 2)) * 2;
      if (t < L) {
        float o0 = 0.f, o1 = 0.f;
        const float* rt = rs + t * LD;
#pragma unroll 8
        for (int i = 0; i < HD; ++i) {
          const float2 sv = *reinterpret_cast<const float2*>(ss + i * VS + j);
          o0 = fmaf(rt[i], sv.x, o0);
          o1 = fmaf(rt[i], sv.y, o1);
        }
        const float* at = as + t * (C + 1);
        for (int s = 0; s < t; ++s) {
          const float2 vv = *reinterpret_cast<const float2*>(vs + s * VS + j);
          o0 = fmaf(at[s], vv.x, o0);
          o1 = fmaf(at[s], vv.y, o1);
        }
        const float2 vt = *reinterpret_cast<const float2*>(vs + t * VS + j);
        o0 = fmaf(bonus[t], vt.x, o0);
        o1 = fmaf(bonus[t], vt.y, o1);
        T* ot = o + chunk_base + (long)t * row_stride + j0 + j;
        store(ot, o0);
        store(ot + 1, o1);
      }
    }
    __syncthreads();   // step 6 overwrites the state step 5 read

    // 6. S[i, j] <- 2^P[L,i] S[i, j] + sum_{s<L} k~_si v_s[j], on the owned slice
    for (int item = tid; item < HD * (VS / VEC); item += NT) {
      const int i = item / (VS / VEC), jq = (item % (VS / VEC)) * VEC;
      const float decay = exp2f(static_cast<float>(pL[i]));
      float4 acc = *reinterpret_cast<const float4*>(ss + i * VS + jq);
      acc.x *= decay; acc.y *= decay; acc.z *= decay; acc.w *= decay;
      for (int s = 0; s < L; ++s) {
        const float kv = ks[s * LD + i];
        const float4 vv = *reinterpret_cast<const float4*>(vs + s * VS + jq);
        acc.x = fmaf(kv, vv.x, acc.x);
        acc.y = fmaf(kv, vv.y, acc.y);
        acc.z = fmaf(kv, vv.z, acc.z);
        acc.w = fmaf(kv, vv.w, acc.w);
      }
      *reinterpret_cast<float4*>(ss + i * VS + jq) = acc;
    }
    __syncthreads();   // the next chunk restages r, k, P, v
  }

  // each thread writes the state items it updated
  for (int item = tid; item < HD * (VS / VEC); item += NT) {
    const int i = item / (VS / VEC), jq = (item % (VS / VEC)) * VEC;
    *reinterpret_cast<float4*>(sT + s_base + (long)i * HD + jq) =
        *reinterpret_cast<const float4*>(ss + i * VS + jq);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* sT, void* o, int B, int Tn, int H,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * Smem<HD>::FLOATS;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(HD / VS, H, B);
  rwkv6_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(sT), static_cast<T*>(o), Tn, H);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16, T > 1: chunk-parallel on the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NW = 4;             // warps per CTA
constexpr int NT = 32 * NW;
constexpr int E = C / 2;          // the sub-chunk edge
constexpr int PARTS = 3;          // bf16 parts of an f32 tensor-core operand
constexpr int CARRY_NT = 256;     // threads per CTA of the carry
constexpr int CARRY_U = 16;       // chunks whose loads the carry keeps in flight
constexpr int LDA = C + 8;        // row of an A part: C bf16 and 16 bytes of padding
static_assert(NT == 4 * C, "the bonus takes 4 threads a token");
static_assert(E == 16, "a walk's 15 scores fit the 16 slots of reduce_scatter16");

template <int HD>
__host__ __device__ constexpr int ldb() { return HD + 8; }   // bf16 row: 16 bytes of padding
template <int HD>
__host__ __device__ constexpr int ldf() { return HD + 4; }   // f32 row: 16 bytes of padding

// Fragment addresses of ldmatrix x4 (lane = 8 * matrix + row): a row-major
// A tile or a B tile stored (k, n) through .trans (flash's Q and V); a B
// tile stored (n, k) or an A tile stored (k, m) through .trans (flash's K).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) * 8; }

// x = hi + mid + lo into PARTS bf16 tiles `tile` elements apart: each part
// is x less the parts before it, rounded to bf16 (those differences are
// exact), so the three hold x to ~2^-27
__device__ __forceinline__ void store_split(bf16* dst, int tile, float x) {
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    const bf16 p = __float2bfloat16(x);
    dst[q * tile] = p;
    x -= __bfloat162float(p);
  }
}

// c += a * b over the PARTS parts of a (b exact in bf16), smallest part first
__device__ __forceinline__ void mma_parts(float (&c)[4], const uint32_t (&a)[PARTS][4],
                                          uint32_t b0, uint32_t b1) {
#pragma unroll
  for (int q = PARTS - 1; q >= 0; --q) mma_bf16_16816(c, a[q], b0, b1);
}

// One step of reduce_scatter16: a lane keeps N of its 2N slots (the upper
// ones where its lane bit 2N is set) and adds its partner's copy of them
template <int N>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = lane & (2 * N);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float give = upper ? v[q] : v[q + N];
    const float keep = upper ? v[q + N] : v[q];
    v[q] = keep + __shfl_xor_sync(FULL, give, 2 * N);
  }
}

// v[q] summed over the warp's lanes; lanes 2j and 2j + 1 return the sum of
// slot j (16 shuffles for 16 sums)
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// Rows [0, C) of one head's (C, HD) tile of tokens from `src` (`stride`
// elements apart) into `dst`; rows >= L are zero-filled and not read.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long stride, int L, int tid) {
  constexpr int CPR = HD / 8;     // 16-byte chunks per row
  for (int e = tid; e < C * CPR; e += NT) {
    const int t = e / CPR, col = (e % CPR) * 8;
    const bool ok = t < L;
    cp_async16(dst + t * ldb<HD>() + col, ok ? src + t * stride + col : src, ok);
  }
}

// LW[t][i] = log2 w (0 for rows >= L) and TOT[seg][i] its sum over the rows
// of sub-chunk seg; thread = (sub-chunk, column)
template <int HD>
__device__ __forceinline__ void log_decays(const bf16* Ws, float* LW, float* TOT, int L, int tid) {
  for (int col = tid; col < 2 * HD; col += NT) {
    const int seg = col / HD, i = col % HD;
    float tot = 0.f;
#pragma unroll 4
    for (int q = 0; q < E; ++q) {
      const int t = seg * E + q;
      const float lw =
          t < L ? log2f(fmaxf(__bfloat162float(Ws[t * ldb<HD>() + i]), W_MIN)) : 0.f;
      LW[t * ldf<HD>() + i] = lw;
      tot += lw;
    }
    TOT[seg * HD + i] = tot;
  }
}

// k_s 2^(P[L] - P[s+1]) into PARTS tiles and, by sub-chunk 0's threads,
// 2^P[L] into dec[i]: each sub-chunk walked backwards from its end, the
// exponent a direct sum of the log-decays after s (sub-chunk 0's starts
// from sub-chunk 1's total)
template <int HD>
__device__ __forceinline__ void carry_out_keys(const bf16* Ks, const float* LW, const float* TOT,
                                               bf16* Kt, float* dec, int tid) {
  for (int col = tid; col < 2 * HD; col += NT) {
    const int seg = col / HD, i = col % HD;
    float x = seg == 0 ? TOT[HD + i] : 0.f;
#pragma unroll 4
    for (int q = E - 1; q >= 0; --q) {
      const int s = seg * E + q;
      store_split(Kt + s * ldb<HD>() + i, C * ldb<HD>(),
                  __bfloat162float(Ks[s * ldb<HD>() + i]) * exp2f(x));
      x += LW[s * ldf<HD>() + i];
    }
    if (seg == 0) dec[i] = exp2f(x);
  }
}

// acc(i, j) = sum_s kt[s][i] v[s][j] for the 16 rows i of m-tile mt and all
// HD columns j: A = kt^T from its PARTS tiles, B = v, both by ldmatrix.trans.
// Accumulator n holds (i = 16 mt + gid, j = 8 n + 2 tig ..+1) and row i + 8.
template <int HD>
__device__ __forceinline__ void state_tile(float (&acc)[HD / 8][4], const bf16* Kt,
                                           const bf16* Vs, int mt, int lane) {
  constexpr int LDB = ldb<HD>(), TILE = C * LDB;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t af[PARTS][4];
#pragma unroll
    for (int q = 0; q < PARTS; ++q)
      ldmatrix_x4_trans(af[q], Kt + q * TILE + (ks * 16 + bn_row(lane)) * LDB + mt * 16 +
                                   bn_col(lane));
#pragma unroll
    for (int n2 = 0; n2 < HD / 16; ++n2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vs + (ks * 16 + a_row(lane)) * LDB + n2 * 16 + a_col(lane));
      mma_parts(acc[2 * n2], af, vf[0], vf[1]);
      mma_parts(acc[2 * n2 + 1], af, vf[2], vf[3]);
    }
  }
}

// ---- 1. per-chunk state increments ---------------------------------------
template <int HD>
struct StateSmem {
  static constexpr int TILE = C * ldb<HD>();      // one (C, HD) bf16 tile
  // bf16 tiles, in elements: k, v, w, then k 2^(P[L]-P[s+1]) in PARTS tiles
  static constexpr int K = 0, V = TILE, W = 2 * TILE, KT = 3 * TILE;
  static constexpr size_t F32_OFFSET = sizeof(bf16) * (KT + PARTS * TILE);
  // f32, in floats: log2 w (C x LDF), the sub-chunk totals (2 x HD)
  static constexpr int LW = 0, TOT = C * ldf<HD>();
  static constexpr size_t BYTES = F32_OFFSET + sizeof(float) * (TOT + 2 * HD);
};

template <int HD>
__global__ void __launch_bounds__(NT) chunk_state_kernel(
    const bf16* __restrict__ k, const bf16* __restrict__ v, const bf16* __restrict__ w,
    float* __restrict__ dstate, float* __restrict__ decay, int Tn, int H) {
  using L_ = StateSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sb = reinterpret_cast<bf16*>(smem_raw);
  float* sf = reinterpret_cast<float*>(smem_raw + L_::F32_OFFSET);
  bf16* Ks = sb + L_::K;
  bf16* Vs = sb + L_::V;
  bf16* Ws = sb + L_::W;
  bf16* Kt = sb + L_::KT;
  float* LW = sf + L_::LW;
  float* TOT = sf + L_::TOT;
  allow_next_grid();              // the carry may be scheduled; it waits for this grid
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = min(C, Tn - c * C);
  const long stride = (long)H * HD;
  const long base = ((long)b * Tn + (long)c * C) * stride + (long)h * HD;
  load_rows<HD>(Ks, k + base, stride, L, tid);
  load_rows<HD>(Vs, v + base, stride, L, tid);
  load_rows<HD>(Ws, w + base, stride, L, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const long slot = ((long)b * H + h) * gridDim.x + c;
  log_decays<HD>(Ws, LW, TOT, L, tid);
  __syncthreads();
  carry_out_keys<HD>(Ks, LW, TOT, Kt, decay + slot * HD, tid);
  __syncthreads();

  const int gid = lane / 4, tig = lane % 4;
  float* ds = dstate + slot * HD * HD;
  for (int mt = warp; mt < HD / 16; mt += NW) {
    float acc[HD / 8][4];
    state_tile<HD>(acc, Kt, Vs, mt, lane);
    const int i0 = mt * 16 + gid;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int j = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(ds + i0 * HD + j) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(ds + (i0 + 8) * HD + j) = make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---- 2. the carry ------------------------------------------------------------
// dstate (B*H, NC, HD, HD) and decay (B*H, NC, HD); slot c of dstate leaves
// holding S_{c-1}.  One thread per 4 consecutive state elements.
template <int HD>
__global__ void __launch_bounds__(CARRY_NT) carry_kernel(
    float* __restrict__ dstate, const float* __restrict__ decay,
    const float* s0,              // may alias sT: each thread reads its elements first
    float* sT, int NC, int BH) {
  constexpr int Q = HD * HD / 4;  // float4s per state
  allow_next_grid();              // the output kernel may start its own work
  wait_for_previous_grid();       // every chunk's increment is written
  const long idx = (long)blockIdx.x * CARRY_NT + threadIdx.x;
  if (idx >= (long)BH * Q) return;
  const long bh = idx / Q;
  const int e = (int)(idx % Q), i = e / (HD / 4);
  float4 s = s0 != nullptr ? reinterpret_cast<const float4*>(s0)[idx]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* ds = reinterpret_cast<float4*>(dstate) + bh * NC * Q + e;
  const float* dc = decay + bh * NC * HD + i;
  for (int c0 = 0; c0 < NC; c0 += CARRY_U) {
    float4 x[CARRY_U];
    float d[CARRY_U];
#pragma unroll
    for (int q = 0; q < CARRY_U; ++q) {
      if (c0 + q < NC) {
        x[q] = ds[(long)(c0 + q) * Q];
        d[q] = dc[(long)(c0 + q) * HD];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_U; ++q) {
      if (c0 + q < NC) {
        ds[(long)(c0 + q) * Q] = s;
        s = make_float4(fmaf(d[q], s.x, x[q].x), fmaf(d[q], s.y, x[q].y),
                        fmaf(d[q], s.z, x[q].z), fmaf(d[q], s.w, x[q].w));
      }
    }
  }
  reinterpret_cast<float4*>(sT)[idx] = s;
}

// ---- 3. per-chunk outputs ------------------------------------------------------
// Shared memory, byte offsets: each region starts where the one before
// ends, and "x | y" regions hold x in the early phases and y in the late
// ones (no phase uses both).
template <int HD, bool WITH_STATE>
struct OutSmem {
  static constexpr int LDB = ldb<HD>(), LDF = ldf<HD>();
  static constexpr int TILE = C * LDB, ETILE = E * LDB, ATILE = C * LDA;   // in bf16
  static constexpr size_t TILE_B = 2 * TILE;
  static constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
  // r, k, v: bf16 (C x LDB)
  static constexpr size_t R = 0, K = TILE_B, V = 2 * TILE_B;
  // w bf16 (C x LDB) | A f32 (C x (C+1))
  static constexpr size_t U1 = 3 * TILE_B;
  // log2 w f32 (C x LDF) | A in PARTS bf16 parts (C x LDA each)
  static constexpr size_t U2 = U1 + cmax(TILE_B, 4 * C * (C + 1));
  // r_t 2^(P[t]-P[e]) (t >= e), then k_s 2^(P[e]-P[s+1]) (s < e), PARTS
  // bf16 parts of E x LDB each | S_{c-1} f32 (HD x HD)
  static constexpr size_t U3 = U2 + cmax(4 * C * LDF, 2 * PARTS * ATILE);
  // r 2^P[t] f32 (C x LDF)
  static constexpr size_t RT = U3 + cmax(2 * 2 * PARTS * ETILE, 4 * HD * HD);
  static constexpr size_t BON = RT + 4 * C * LDF;  // (r_t u) . k_t (C)
  static constexpr size_t U = BON + 4 * C;         // u (HD)
  static constexpr size_t TOT = U + 4 * HD;        // sub-chunk sums of log2 w (2 x HD)
  static constexpr size_t DEC = TOT + 8 * HD;      // 2^P[L] (HD)
  static constexpr size_t KT = DEC + 4 * HD;       // k 2^(P[L]-P[s+1]), PARTS bf16 tiles
  static constexpr size_t BYTES = KT + (WITH_STATE ? PARTS * TILE_B : 0);
  static_assert(BYTES <= 232448, "shared memory of one CTA");
  static_assert(U2 % 16 == 0 && U3 % 16 == 0 && RT % 16 == 0 && BON % 16 == 0 &&
                    TOT % 16 == 0 && KT % 16 == 0, "16-byte aligned regions");
};

template <int HD, bool WITH_STATE>
__global__ void __launch_bounds__(NT) chunk_out_kernel(
    const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ w, const float* __restrict__ u,
    const float* carry,           // S_{c-1} of slot (b, h, c); with WITH_STATE s0 (may be null)
    float* sT,                    // WITH_STATE only; may alias carry
    bf16* __restrict__ o, int Tn, int H) {
  using L_ = OutSmem<HD, WITH_STATE>;
  constexpr int LDB = L_::LDB, LDF = L_::LDF;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Rs = reinterpret_cast<bf16*>(smem_raw + L_::R);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L_::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L_::V);
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw + L_::U1);
  float* AF = reinterpret_cast<float*>(smem_raw + L_::U1);
  float* LW = reinterpret_cast<float*>(smem_raw + L_::U2);
  bf16* AP = reinterpret_cast<bf16*>(smem_raw + L_::U2);
  bf16* RH = reinterpret_cast<bf16*>(smem_raw + L_::U3);
  bf16* KH = RH + PARTS * L_::ETILE;
  float* Ss = reinterpret_cast<float*>(smem_raw + L_::U3);
  float* RT = reinterpret_cast<float*>(smem_raw + L_::RT);
  float* BON = reinterpret_cast<float*>(smem_raw + L_::BON);
  float* US = reinterpret_cast<float*>(smem_raw + L_::U);
  float* TOT = reinterpret_cast<float*>(smem_raw + L_::TOT);
  float* DEC = reinterpret_cast<float*>(smem_raw + L_::DEC);
  bf16* KT = reinterpret_cast<bf16*>(smem_raw + L_::KT);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int L = min(C, Tn - c * C);
  const long stride = (long)H * HD;
  const long base = ((long)b * Tn + (long)c * C) * stride + (long)h * HD;
  load_rows<HD>(Rs, r + base, stride, L, tid);
  load_rows<HD>(Ks, k + base, stride, L, tid);
  load_rows<HD>(Vs, v + base, stride, L, tid);
  load_rows<HD>(Ws, w + base, stride, L, tid);
  cp_async_commit();
  for (int i = tid; i < HD; i += NT) US[i] = u[h * HD + i];
  cp_async_wait<0>();
  __syncthreads();

  log_decays<HD>(Ws, LW, TOT, L, tid);
  __syncthreads();

  // Thread = (sub-chunk, column) walks its sub-chunk: r 2^P[t] (sub-chunk
  // 1's from sub-chunk 0's total), r 2^(P[t]-P[e]) for t >= e and, walking
  // back, k 2^(P[e]-P[s+1]) for s < e; every exponent a direct sum
  for (int col = tid; col < 2 * HD; col += NT) {
    const int seg = col / HD, i = col % HD;
    float x = seg == 0 ? 0.f : TOT[i], xe = 0.f;
#pragma unroll 4
    for (int q = 0; q < E; ++q) {
      const int t = seg * E + q;
      const float rv = __bfloat162float(Rs[t * LDB + i]);
      RT[t * LDF + i] = rv * exp2f(x);
      if (seg == 1) store_split(RH + q * LDB + i, L_::ETILE, rv * exp2f(xe));
      x += LW[t * LDF + i];
      xe += LW[t * LDF + i];
    }
    if (seg == 0) {
      float y = 0.f;
#pragma unroll 4
      for (int q = E - 1; q >= 0; --q) {
        store_split(KH + q * LDB + i, L_::ETILE, __bfloat162float(Ks[q * LDB + i]) * exp2f(y));
        y += LW[q * LDF + i];
      }
    }
  }
  if constexpr (WITH_STATE) carry_out_keys<HD>(Ks, LW, TOT, KT, DEC, tid);
  {
    // the bonus (r_t u) . k_t: 4 threads a token
    const int t = tid / 4;
    float part = 0.f;
    for (int i = tid % 4; i < HD; i += 4)
      part += __bfloat162float(Rs[t * LDB + i]) * US[i] * __bfloat162float(Ks[t * LDB + i]);
    part += __shfl_xor_sync(FULL, part, 1);
    part += __shfl_xor_sync(FULL, part, 2);
    if (tid % 4 == 0) BON[t] = part;
  }
  __syncthreads();

  // A within each sub-chunk: warp job (sub-chunk, s) walks t = s+1 .. e-1
  // with lanes over columns, the exponent P[t] - P[s+1] a running direct sum
  // of the log-decays between; each lane keeps its part of the 15 scores,
  // and one reduce-scatter sums them over the columns.  Jobs alternate s
  // so that the walks of the four warps are of nearly equal length.
  constexpr int CPL = (HD + 31) / 32;             // columns per lane
  for (int job = warp; job < 2 * (E - 1); job += NW) {
    const int seg = job & 1, s = seg * E + (job >> 1), n = E - 1 - (job >> 1);
    float kc[CPL], x[CPL];
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int i = lane + 32 * m;
      kc[m] = i < HD ? __bfloat162float(Ks[s * LDB + i]) : 0.f;
      x[m] = 0.f;
    }
    float part[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      part[q] = 0.f;
      if (q < n) {
        const int t = s + 1 + q;
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const int i = lane + 32 * m;
          if (i < HD) {
            if (q > 0) x[m] += LW[(t - 1) * LDF + i];
            part[q] = fmaf(__bfloat162float(Rs[t * LDB + i]) * kc[m], fast_exp2(x[m]), part[q]);
          }
        }
      }
    }
    const float a = reduce_scatter16(part, lane);
    const int q = (lane >> 1) & 15;
    if ((lane & 1) == 0 && q < n) AF[(s + 1 + q) * (C + 1) + s] = a;
  }
  // the off-diagonal block t >= e > s on the tensor cores, by the last warp
  // (its walks are the shortest): (hi + mid + lo)(hi + mid + lo), the six
  // products of order 2^-16 and up
  if (warp == NW - 1) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t ra[PARTS][4], kb[PARTS][4];
#pragma unroll
      for (int q = 0; q < PARTS; ++q) {
        ldmatrix_x4(ra[q], RH + q * L_::ETILE + a_row(lane) * LDB + ks * 16 + a_col(lane));
        ldmatrix_x4(kb[q], KH + q * L_::ETILE + bn_row(lane) * LDB + ks * 16 + bn_col(lane));
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_bf16_16816(acc[n], ra[1], kb[1][2 * n], kb[1][2 * n + 1]);
        mma_bf16_16816(acc[n], ra[0], kb[2][2 * n], kb[2][2 * n + 1]);
        mma_bf16_16816(acc[n], ra[2], kb[0][2 * n], kb[0][2 * n + 1]);
        mma_bf16_16816(acc[n], ra[0], kb[1][2 * n], kb[1][2 * n + 1]);
        mma_bf16_16816(acc[n], ra[1], kb[0][2 * n], kb[0][2 * n + 1]);
        mma_bf16_16816(acc[n], ra[0], kb[0][2 * n], kb[0][2 * n + 1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int t = E + gid, s = n * 8 + 2 * tig;
      AF[t * (C + 1) + s] = acc[n][0];
      AF[t * (C + 1) + s + 1] = acc[n][1];
      AF[(t + 8) * (C + 1) + s] = acc[n][2];
      AF[(t + 8) * (C + 1) + s + 1] = acc[n][3];
    }
  }
  __syncthreads();

  // S_{c-1} over the edge factors, once the carry has written it (the one
  // read that depends on the kernels before), while A (zero on and above
  // the diagonal) is split into PARTS bf16 parts over log2 w
  wait_for_previous_grid();
  const float* s_in = carry + (((long)b * H + h) * gridDim.x + c) * HD * HD;
  for (int e = tid; e < HD * HD / 4; e += NT)
    cp_async16(Ss + 4 * e, carry != nullptr ? s_in + 4 * e : u, carry != nullptr);
  cp_async_commit();
  for (int e = tid; e < C * C; e += NT) {
    const int t = e / C, s = e % C;
    store_split(AP + t * LDA + s, L_::ATILE, s < t ? AF[t * (C + 1) + s] : 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();

  // o = A v (tensor cores) + (r 2^P) S_{c-1} (f32 SIMT) + bonus v: warp =
  // a group of columns over all C rows, so that each element of S_{c-1} is
  // read once per CTA; m-tile 0's rows see only sub-chunk 0's keys.
  // Accumulator [mt][n] holds rows 16 mt + gid (+ 8) and columns
  // j0 + 8 n + 2 tig (+ 1).
  constexpr int NQ = HD / 16 < NW ? HD / 16 : NW;   // column groups of >= 16
  constexpr int NB = HD / 8 / NQ;                   // 8-column n-tiles per warp
  if (warp < NQ) {
    const int j0 = warp * (HD / NQ);
    float acc[2][NB][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int ks = 0; ks <= mt; ++ks) {
        uint32_t af[PARTS][4];
#pragma unroll
        for (int q = 0; q < PARTS; ++q)
          ldmatrix_x4(af[q], AP + q * L_::ATILE + (mt * 16 + a_row(lane)) * LDA + ks * 16 +
                                 a_col(lane));
#pragma unroll
        for (int n2 = 0; n2 < NB / 2; ++n2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vs + (ks * 16 + a_row(lane)) * LDB + j0 + n2 * 16 + a_col(lane));
          mma_parts(acc[mt][2 * n2], af, vf[0], vf[1]);
          mma_parts(acc[mt][2 * n2 + 1], af, vf[2], vf[3]);
        }
      }
    }
    // rows gid + 8 rr, rr = 0..3: accumulator [rr / 2][n][2 (rr % 2) ..]
#pragma unroll 2
    for (int i = 0; i < HD; i += 4) {
      float4 a[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        a[rr] = *reinterpret_cast<const float4*>(RT + (gid + 8 * rr) * LDF + i);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float* srow = Ss + (i + ii) * HD + j0 + 2 * tig;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const float2 sv = *reinterpret_cast<const float2*>(srow + n * 8);
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            const float ar = ii == 0 ? a[rr].x : ii == 1 ? a[rr].y : ii == 2 ? a[rr].z : a[rr].w;
            float* c2 = acc[rr / 2][n] + 2 * (rr % 2);
            c2[0] = fmaf(ar, sv.x, c2[0]);
            c2[1] = fmaf(ar, sv.y, c2[1]);
          }
        }
      }
    }
    bf16* ob = o + base;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int t = gid + 8 * rr;
      const float bt = BON[t];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int j = j0 + n * 8 + 2 * tig;
        const float2 vt =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Vs + t * LDB + j));
        const float* c2 = acc[rr / 2][n] + 2 * (rr % 2);
        if (t < L)
          *reinterpret_cast<__nv_bfloat162*>(ob + t * stride + j) =
              __floats2bfloat162_rn(fmaf(bt, vt.x, c2[0]), fmaf(bt, vt.y, c2[1]));
      }
    }
  }

  // one chunk in all: S_T = 2^P[L] s0 + (k 2^(P[L]-P[s+1]))^T v; every read
  // of s0 went to shared memory before the barrier above
  if constexpr (WITH_STATE) {
    float* st = sT + ((long)b * H + h) * HD * HD;
    for (int m = warp; m < HD / 16; m += NW) {
      float acc[HD / 8][4];
      state_tile<HD>(acc, KT, Vs, m, lane);
      const int i0 = m * 16 + gid, i1 = i0 + 8;
      const float d0 = DEC[i0], d1 = DEC[i1];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int j = n * 8 + 2 * tig;
        const float2 s0v = *reinterpret_cast<const float2*>(Ss + i0 * HD + j);
        const float2 s1v = *reinterpret_cast<const float2*>(Ss + i1 * HD + j);
        *reinterpret_cast<float2*>(st + i0 * HD + j) =
            make_float2(fmaf(d0, s0v.x, acc[n][0]), fmaf(d0, s0v.y, acc[n][1]));
        *reinterpret_cast<float2*>(st + i1 * HD + j) =
            make_float2(fmaf(d1, s1v.x, acc[n][2]), fmaf(d1, s1v.y, acc[n][3]));
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(
                                 kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
                           : cudaSuccess;
}

// Launches `kernel` with programmatic dependent launch: it may be scheduled
// while the kernel before it on the stream still runs (see allow_next_grid)
template <typename... P, typename... A>
cudaError_t launch_after(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int HD>
cudaError_t launch(const bf16* r, const bf16* k, const bf16* v, const bf16* w, const float* u,
                   const float* s0, float* sT, bf16* o, float* dstate, float* decay, int B,
                   int Tn, int H, cudaStream_t stream) {
  const int NC = (Tn + C - 1) / C;
  cudaError_t err;
  if (NC == 1) {
    constexpr size_t smem = OutSmem<HD, true>::BYTES;
    if ((err = allow_smem(chunk_out_kernel<HD, true>, smem)) != cudaSuccess) return err;
    chunk_out_kernel<HD, true><<<dim3(1, H, B), NT, smem, stream>>>(r, k, v, w, u, s0, sT, o,
                                                                    Tn, H);
    return cudaGetLastError();
  }
  if (dstate == nullptr || decay == nullptr) return cudaErrorInvalidValue;
  constexpr size_t smem1 = StateSmem<HD>::BYTES, smem3 = OutSmem<HD, false>::BYTES;
  if ((err = allow_smem(chunk_state_kernel<HD>, smem1)) != cudaSuccess) return err;
  if ((err = allow_smem(chunk_out_kernel<HD, false>, smem3)) != cudaSuccess) return err;
  const dim3 grid(NC, H, B);
  chunk_state_kernel<HD><<<grid, NT, smem1, stream>>>(k, v, w, dstate, decay, Tn, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long items = (long)B * H * HD * HD / 4;
  err = launch_after(carry_kernel<HD>, dim3((unsigned)((items + CARRY_NT - 1) / CARRY_NT)),
                     CARRY_NT, 0, stream, dstate, (const float*)decay, s0, sT, NC, B * H);
  if (err != cudaSuccess) return err;
  return launch_after(chunk_out_kernel<HD, false>, grid, NT, smem3, stream, r, k, v, w, u,
                      (const float*)dstate, (float*)nullptr, o, Tn, H);
}

}  // namespace tc

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

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* s0, void* sT, void* o, void* dstate, void* decay, int B, int Tn,
                   int H, cudaStream_t stream) {
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (Tn == 1)
    return decode::launch<T, HD>(static_cast<const T*>(r), static_cast<const T*>(k),
                                 static_cast<const T*>(v), static_cast<const T*>(w), uf, s0f,
                                 sTf, static_cast<T*>(o), B, H, stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch<HD>(static_cast<const T*>(r), static_cast<const T*>(k),
                          static_cast<const T*>(v), static_cast<const T*>(w), uf, s0f, sTf,
                          static_cast<T*>(o), static_cast<float*>(dstate),
                          static_cast<float*>(decay), B, Tn, H, stream);
  else
    return simt::launch<T, HD>(r, k, v, w, u, s0, sT, o, B, Tn, H, stream);
}

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* sT, void* o, void* dstate, void* decay,
                     int B, int Tn, int H, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, sT, o, dstate, decay, B, Tn, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, sT, o, dstate, decay, B, Tn, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, sT, o, dstate, decay, B, Tn, H, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, sT, o, dstate, decay, B, Tn, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace rwkv6

// Returns a cudaError_t: the first launch's that failed, or the error of
// setting the device or a shared-memory limit.  s0 may be null (a zero
// state) and may equal sT (the state updated in place).  dstate (B*H*NC*hd*hd
// f32) and decay (B*H*NC*hd f32), NC = ceil(T / 32), are scratch for a bf16
// launch of T > 32 tokens and may be null otherwise.  Shapes, dtypes,
// contiguity and alignment are checked by the Python wrapper.
extern "C" int rwkv6_forward(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, void* sT, void* o, void* dstate,
                             void* decay, int dtype, int B, int Tn, int H, int hd, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)rwkv6::dispatch<float>(hd, r, k, v, w, u, s0, sT, o, dstate, decay, B, Tn, H, st);
  if (dtype == DTYPE_BF16)
    return (int)rwkv6::dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, sT, o, dstate, decay, B,
                                               Tn, H, st);
  return (int)cudaErrorInvalidValue;
}
