// FlashAttention prefill for Hopper (sm_90a), f32 or bf16 in, f32 softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (body _fa_kernel): softmax(q k^T * hd^-0.5 + mask) v for q (B,Sq,nq,hd) and
// k, v (B,Sk,nkv,hd), query head h reading kv head h / (nq/nkv).  Masks: key
// beyond Sk, causal kpos <= qpos, window kpos > qpos - W, with
// qpos = q_offset + row.  A row with no visible key gives 0.
//
// What bounds it on this card: at prefill lengths (S >= 512) the work is
// 4*S^2*hd/2 operations per causal head against 4*S*hd elements moved, far
// above the H100's ~295 operations per byte, so operations bound it.  This
// first version runs the two products on the f32 SIMT units (67 TFLOP/s),
// not the bf16 tensor cores (989), so it sits well above its bound; wgmma
// with TMA-fed tiles is the later step.  What the design does about the
// bound today:
//  - one CTA per (batch, q head, 64 query rows) walks the KV tiles in a loop
//    (the TPU's sequential grid axis), keeping m, l and the output
//    accumulator in registers, so no (Sq, Sk) matrix reaches device memory;
//  - the loop runs only over the keys some row of the tile can see: it stops
//    at the causal horizon and starts at the window's edge, skipping the
//    fully masked tiles the TPU grid visits and masks;
//  - each K/V tile is read once from device memory into shared memory and
//    serves all 64 query rows; 4 threads share a row, split the tile's keys
//    for q k^T and the head dim for p v, and exchange probabilities by
//    warp shuffles instead of shared memory;
//  - ragged Sq/Sk are masked in the kernel, without padding on the host.
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int nq, int nkv, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
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

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o, int B,
                     int Sq, int Sk, int nq, int nkv, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, nq, nkv, causal, window, q_offset, scale, stream);
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
