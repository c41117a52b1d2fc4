// Flash-decode for Hopper (sm_90a): one query token per sequence against
// its KV cache, f32 or bf16 in, f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (body _decode_kernel): for q (B,nq,hd), a cache k, v (B,S,nkv,hd) and a
// (B,S) mask `valid` (ring holes, causal horizon, window), the softmax over
// the valid slots of q k^T * hd^-0.5, times v.  A sequence with no valid
// slot gives 0.
//
// What bounds it on this card: bytes.  Each cached K/V element is used for
// 2*(nq/nkv) operations, far below the H100's ~295 operations per byte, so
// the least time is the valid part of the cache over 3.35 TB/s.  What the
// design does about it:
//  - one CTA per (batch, kv head) reads each K/V row once and serves all
//    nq/nkv query heads of the group from it; the TPU index map streams a
//    kv head's cache once per query head;
//  - rows of invalid slots are never read: only the (B,S) byte mask is, so
//    a cache filled to a fraction of its length costs that fraction;
//  - K rows are read 4 elements a lane, a group of hd/4 lanes per row, so a
//    warp reads whole rows; the softmax runs online over 64-slot tiles with
//    m, l per head in shared memory, and the p v product splits the tile's
//    slots over the threads left after the head dims are covered, with one
//    reduction across those slot groups at the end.
// Not yet done: when B * nkv is below the 132 SMs the card is not filled;
// splitting S across CTAs with a second reduction pass is the later step.
#include "common.cuh"

namespace {

constexpr int NT = 256;           // threads per CTA
constexpr int NW = NT / 32;       // warps per CTA
constexpr int TS = 64;            // cache slots per tile (two per lane in the softmax)
constexpr int VEC = 4;            // elements per lane per load

size_t smem_bytes(int g, int hd) {
  // q (g x hd), tile scores (g x TS), per-head m, l, alpha, partial outputs
  return sizeof(float) * (g * hd + g * TS + 3 * g + NT * VEC);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) da_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const uint8_t* __restrict__ valid, T* __restrict__ o, int S, int nq, int nkv,
    float scale_log2) {
  constexpr int LPK = HD / VEC;   // lanes per key row
  constexpr int KPW = 32 / LPK;   // key rows a warp reads at once
  constexpr int ITERS = TS / (NW * KPW);
  static_assert(ITERS * NW * KPW == TS, "tile must split evenly over the warps");
  static_assert(TS == 64, "the softmax gives two slots to each lane");

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = nq / nkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ float sm[];
  float* qs = sm;                 // g x HD
  float* sc = qs + g * HD;        // g x TS logits, then probabilities
  float* st = sc + g * TS;        // per head: m (log2 units), l, alpha
  float* red = st + 3 * g;        // NT x VEC partial outputs

  const long kv_stride = (long)nkv * HD;
  const T* kb = kc + (long)b * S * kv_stride + (long)kvh * HD;
  const T* vb = vc + (long)b * S * kv_stride + (long)kvh * HD;
  const uint8_t* vmask = valid + (long)b * S;
  const T* qb = q + ((long)b * nq + (long)kvh * g) * HD;   // the group's g heads

  for (int idx = tid * VEC; idx < g * HD; idx += NT * VEC) {
    float f[4];
    load4(qb + idx, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[idx + i] = f[i];
  }
  for (int h = tid; h < g; h += NT) {
    st[3 * h] = NEG_INF;
    st[3 * h + 1] = 0.f;
  }

  // p v split: C chunks of VEC output dims (C <= NT, checked by the wrapper),
  // SG groups of slots; thread (pv_sg, pv_chunk) sums slots j = pv_sg mod SG.
  const int C = g * HD / VEC;
  const int SG = NT / C;
  const int pv_chunk = tid % C, pv_sg = tid / C;
  const bool pv_on = pv_sg < SG;
  const int pv_h = pv_chunk * VEC / HD, pv_d = (pv_chunk * VEC) % HD;
  float acc[VEC] = {0.f, 0.f, 0.f, 0.f};

  const int sub = lane / LPK, li = lane % LPK;
  __syncthreads();

  for (int s0 = 0; s0 < S; s0 += TS) {
    // 1. logits: LPK lanes read one K row and score it for every head
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int j = (it * NW + warp) * KPW + sub;
      const int slot = s0 + j;
      const bool ok = slot < S && vmask[slot];
      float kf[4] = {0.f, 0.f, 0.f, 0.f};
      if (ok) load4(kb + (long)slot * kv_stride + li * VEC, kf);
      for (int h = 0; h < g; ++h) {
        const float* qh = qs + h * HD + li * VEC;
        float part = qh[0] * kf[0] + qh[1] * kf[1] + qh[2] * kf[2] + qh[3] * kf[3];
        part = group_sum(part, LPK);
        if (li == 0) sc[h * TS + j] = ok ? part * scale_log2 : NEG_INF;
      }
    }
    __syncthreads();

    // 2. online softmax, one warp per head
    for (int h = warp; h < g; h += NW) {
      const float a0 = sc[h * TS + lane], a1 = sc[h * TS + lane + 32];
      const float m_old = st[3 * h];
      const float m_new = fmaxf(m_old, group_max(fmaxf(a0, a1), 32));
      const float p0 = is_live(a0) ? exp2f(a0 - m_new) : 0.f;
      const float p1 = is_live(a1) ? exp2f(a1 - m_new) : 0.f;
      sc[h * TS + lane] = p0;
      sc[h * TS + lane + 32] = p1;
      const float psum = group_sum(p0 + p1, 32);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        st[3 * h] = m_new;
        st[3 * h + 1] = st[3 * h + 1] * alpha + psum;
        st[3 * h + 2] = alpha;
      }
    }
    __syncthreads();

    // 3. p v over this thread's slots of the tile; masked slots have p = 0
    //    and their V rows are not read
    if (pv_on) {
      const float alpha = st[3 * pv_h + 2];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] *= alpha;
      for (int j = pv_sg; j < TS; j += SG) {
        const float p = sc[pv_h * TS + j];
        if (p != 0.f) {
          float vf[4];
          load4(vb + (long)(s0 + j) * kv_stride + pv_d, vf);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites the scores
  }

  if (pv_on) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) red[(pv_sg * C + pv_chunk) * VEC + i] = acc[i];
  }
  __syncthreads();
  T* ob = o + ((long)b * nq + (long)kvh * g) * HD;
  for (int idx = tid; idx < g * HD; idx += NT) {
    const int chunk = idx / VEC, i = idx % VEC;
    float sum = 0.f;
    for (int sg = 0; sg < SG; ++sg) sum += red[(sg * C + chunk) * VEC + i];
    const float l = st[3 * (idx / HD) + 1];
    store(ob + idx, l > 0.f ? sum / l : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* o,
                   int B, int S, int nq, int nkv, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(nq / nkv, HD);
  dim3 grid(nkv, B);
  da_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(o), S, nq, nkv, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, const void* valid,
                     void* o, int B, int S, int nq, int nkv, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, valid, o, B, S, nq, nkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, valid, o, B, S, nq, nkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, o, B, S, nq, nkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, o, B, S, nq, nkv, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's own, or the error of setting the
// device.  Shapes, dtypes, contiguity, alignment and the group-size limit
// (nq/nkv * hd <= 1024) are checked by the Python wrapper.
extern "C" int da_forward(const void* q, const void* k, const void* v, const void* valid,
                          void* o, int dtype, int B, int S, int nq, int nkv, int hd,
                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return (int)dispatch<float>(hd, q, k, v, valid, o, B, S, nq, nkv, scale, st);
  if (dtype == DTYPE_BF16)
    return (int)dispatch<__nv_bfloat16>(hd, q, k, v, valid, o, B, S, nq, nkv, scale, st);
  return (int)cudaErrorInvalidValue;
}
