// Helpers shared by the kernels: element types, 4-wide loads
// into f32 registers, stores back to the element type, warp reductions,
// and the Ampere/Hopper instructions written as inline PTX (cp.async,
// ldmatrix, mma.sync, griddepcontrol) so that no header beyond the
// toolkit's is needed.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Masked logits.  The same finite value as the JAX kernels, so that a
// fully masked tile keeps exp(NEG_INF - NEG_INF) = 1 finite; the kernels
// zero masked probabilities explicitly.
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// dtype codes shared with the Python wrappers
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ bool is_live(float s) { return s > 0.5f * NEG_INF; }

// Four consecutive elements (16 bytes of f32, 8 bytes of bf16; the
// wrappers check the 16-byte alignment of every base pointer, and every
// offset used here is a multiple of 4 elements).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  uint2 t = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Reductions over aligned groups of `width` lanes (width a power of two <= 32).
__device__ __forceinline__ float group_max(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x, int width) {
  for (int off = width / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Asynchronous copies (cp.async, sm_80+): 16 bytes from device memory to
// shared memory.  With `pred` false nothing is read and the 16 bytes are
// filled with zeros (src-size 0), so a masked row is never fetched and
// never holds stale bits.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Tensor cores through mma.sync (m16n8k16, bf16 in, f32 accumulate) fed by
// ldmatrix.  Fragment layouts (lane = 4 * gid + tig):
//   A 16x16 row-major: a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid,
//     2tig+8..), a3 (gid+8, 2tig+8..);
//   B 16x8 "col": b0 (k 2tig..+1, n gid), b1 (k 2tig+8..+9, n gid);
//   C 16x8 f32: c0, c1 (gid, 2tig..+1), c2, c3 (gid+8, 2tig..+1).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a * b (registers only: not volatile, so the compiler may schedule it)
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Programmatic dependent launch (sm_90): a kernel launched with the
// programmatic-serialization attribute may start while the kernel before it
// on the stream runs, once every CTA of that kernel has called
// allow_next_grid() (or exited); it must call wait_for_previous_grid()
// before it reads what that kernel writes.  Without the attribute both are
// no-ops.
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_previous_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 2^x by the MUFU instruction alone, subnormal results flushed to 0 (a
// softmax's arguments are <= 0, so only weights below 2^-126 flush)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 and packed, the first in the low half: the
// order of a fragment's element pair.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Two floats split into a bf16 high part (rounded) and a bf16 low part (the
// rounded remainder), each pair packed as pack_bf16x2 packs it: hi + lo
// carries about 16 significant bits where hi alone carries 8, so two
// products (hi, then lo, against the same bf16 operand) summed in f32 give
// the product of the f32 value to about 2^-17 of it.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
