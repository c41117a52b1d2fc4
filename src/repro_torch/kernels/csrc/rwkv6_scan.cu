// RWKV-6 WKV recurrence for Hopper (sm_90a), in chunks of 32 tokens,
// f32 or bf16 in, f32 arithmetic, f32 state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:rwkv6_chunked
// (body _rwkv_kernel).  For r, k, v, w (B,T,H,hd), a bonus u (H,hd) f32 and
// an initial state S (B,H,hd,hd) f32 (null = zeros), per head
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
// returning o (in r's type) and the state after token T-1.  Inside a chunk,
// with P[t] = sum_{q<t} log2 w_q (an exclusive prefix per state row i),
//   o_t = (r_t 2^P[t]) S0 + sum_{s<t} A[t,s] v_s + ((r_t u) . k_t) v_t,
//   A[t,s] = sum_i r_ti k_si 2^(P[t,i] - P[s+1,i]),
//   S_L = diag(2^P[L]) S0 + sum_{s<L} (k_s 2^(P[L] - P[s+1])) v_s^T.
// Every exponent is a sum of log-decays, so <= 0: each factor is bounded by
// 1 and strong decay underflows to 0 instead of overflowing.  The ratio is
// kept inside the hd reduction of A, as the TPU kernel keeps it, and pairs
// s >= t (whose exponent is positive) are never formed, so no inf meets a
// mask.  The tail chunk is masked here (the Pallas wrapper pads T on the
// host): rows past T load r = k = v = 0 and log w = 0 and are not stored.
// A one-token launch (every decode step) forms no pair at all.
//
// What bounds it on this card: bytes.  A token costs 4 hd^2 operations per
// head against 5 hd elements moved (r, k, v, w in, o out) plus the state read
// once and written once per launch: at hd 64 that is ~16 operations per
// byte in bf16, far below the H100's ~295, so the least time is the bytes
// over 3.35 TB/s.  What the design does about it:
//  - the state is read once at the start and written once at the end of a
//    launch; between chunks it stays in shared memory, as the TPU kernel
//    keeps it in VMEM scratch across its sequential chunk axis.  Blocks run
//    in no order here, so one CTA walks all chunks of its (batch, head) in a
//    loop;
//  - the value columns of S are independent (o[:, j] and S[:, j] need only
//    v[:, j]), so a CTA owns 16 of them: grid (hd/16, H, B) gives 128 CTAs
//    at the prefill of rwkv6-1.6b (B=1, H=32, hd=64) and 1024 in its decode
//    at 8 slots, where one CTA per head would leave most of the 132 SMs idle.
//    The price is that the hd/16 CTAs of a head each recompute the head's
//    (C,C) score matrix A: hd/16 = 4 times the pair work at hd 64;
//  - the TPU kernel builds a (C,C,hd) ratio tile (256 KB at C=32, hd=64),
//    more than the 227 KB a Hopper block can hold; here r, k and P are
//    staged as (C,hd) f32 tiles (rows padded by 4 floats: 16-byte aligned,
//    and a quarter-warp's 16-byte loads of 8 rows hit 8 bank groups) and
//    each A[t,s] is reduced pairwise, ~37 KB in all at hd 64.  No (C,C,hd)
//    tile reaches device memory.
// Not yet done: A is f32 SIMT work (the exp2 of each pair is the cost), and
// A v, r S and the state update are not on the tensor cores.
#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps per CTA
constexpr int C = 32;             // tokens per chunk: one per lane in the prefix scan
constexpr int VS = 16;            // value columns (of S and o) per CTA
constexpr int VEC = 4;            // elements per 16-byte load
// log of the smallest decay, as the TPU kernel clamps it: keeps log2 finite at w = 0
constexpr float W_MIN = 1e-38f;
static_assert(NT == C * (VS / 2), "step 5 gives each thread one token and two columns");

template <int HD>
struct Smem {
  static constexpr int LD = HD + 4;                 // row stride of the (C, HD) tiles
  static constexpr int R = 0;                       // r, then r 2^P[t]          (C x LD)
  static constexpr int K = R + C * LD;              // k, then k 2^(P[L]-P[s+1])  (C x LD)
  static constexpr int P = K + C * LD;              // log2 w, then P            ((C+1) x LD)
  static constexpr int V = P + (C + 1) * LD;        // this CTA's v columns      (C x VS)
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
  float* ps = sm + L_::P;
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
  for (int i = tid; i < HD; i += NT) ps[i] = 0.f;   // P[0] = 0

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
      *reinterpret_cast<float4*>(ps + (t + 1) * LD + i) = make_float4(lw[0], lw[1], lw[2], lw[3]);
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
      float x = ps[(lane + 1) * LD + i];
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float y = __shfl_up_sync(0xffffffffu, x, off);
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
          const float* pt = ps + t * LD;
          const float* kq = ks + s * LD;
          const float* pq = ps + (s + 1) * LD;
          float acc = 0.f;
#pragma unroll 4
          for (int i = 0; i < HD; i += VEC) {
            const float4 a = *reinterpret_cast<const float4*>(rt + i);
            const float4 la = *reinterpret_cast<const float4*>(pt + i);
            const float4 kk = *reinterpret_cast<const float4*>(kq + i);
            const float4 lb = *reinterpret_cast<const float4*>(pq + i);
            acc = fmaf(a.x * kk.x, exp2f(la.x - lb.x), acc);
            acc = fmaf(a.y * kk.y, exp2f(la.y - lb.y), acc);
            acc = fmaf(a.z * kk.z, exp2f(la.z - lb.z), acc);
            acc = fmaf(a.w * kk.w, exp2f(la.w - lb.w), acc);
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
    const float* pL = ps + L * LD;
    for (int e = tid; e < L * HD; e += NT) {
      const int t = e / HD, i = e % HD;
      rs[t * LD + i] *= exp2f(ps[t * LD + i]);
      ks[t * LD + i] *= exp2f(pL[i] - ps[(t + 1) * LD + i]);
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
      const float decay = exp2f(pL[i]);
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

template <typename T>
cudaError_t dispatch(int hd, const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* s0, void* sT, void* o, int B, int Tn, int H,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, sT, o, B, Tn, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, s0, sT, o, B, Tn, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, sT, o, B, Tn, H, stream);
    case 128: return launch<T, 128>(r, k, v, w, u, s0, sT, o, B, Tn, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's own, or the error of setting the
// device or the shared-memory limit.  s0 may be null (a zero state) and may
// equal sT (the state updated in place).  Shapes, dtypes, contiguity and
// alignment are checked by the Python wrapper.
extern "C" int rwkv6_forward(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* s0, void* sT, void* o, int dtype,
                             int B, int Tn, int H, int hd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)dispatch<float>(hd, r, k, v, w, u, s0, sT, o, B, Tn, H, st);
  if (dtype == DTYPE_BF16)
    return (int)dispatch<__nv_bfloat16>(hd, r, k, v, w, u, s0, sT, o, B, Tn, H, st);
  return (int)cudaErrorInvalidValue;
}
