// Shared pieces of the three flash-attention kernels (fwd, dQ, dK/dV): the
// argument struct, and the mma.sync/ldmatrix/cp.async helpers of the dQ
// kernel (the forward and dK/dV kernels' Hopper pieces are in
// hopper_common.cuh).
//
// Layout: [batch, heads, seq, head_dim] ("BHSD") addressed through element
// strides, so the model's transposed views [B,S,H,D] -> [B,H,S,D] reach the
// kernels without a copy. The last dimension must be contiguous. GQA maps
// q-head h to kv-head h / (H / Hk).
//
// The dQ kernel's products run on the tensor cores with mma.sync m16n8k16
// (bf16 inputs, f32 accumulation). Its inputs of either bf16 or f32 are
// rounded to bf16 when they are staged into shared memory; softmax state
// and accumulators are f32.
//
// The host side is a plain C interface (one `FlashParams` struct by
// pointer plus the CUDA stream), bound from Python with ctypes; the struct
// must match `ray_tpu_torch/ops/_ext.py:FlashParams` field for field.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

struct FlashParams {
    const void* q;
    const void* k;
    const void* v;
    void* o;          // fwd output [B,H,Sq,D], q's dtype
    const void* dout; // dO [B,H,Sq,D], q's dtype
    float* lse;       // [B,H,Sq] contiguous f32 (fwd writes, bwd reads)
    const float* delta;  // [B,H,Sq] contiguous f32, rowsum(dO * O)
    void* dq;         // [B,H,Sq,D]
    void* dk;         // [B,Hk,Sk,D], already summed over the GQA group
    void* dv;
    long long q_sb, q_sh, q_ss;
    long long k_sb, k_sh, k_ss;
    long long v_sb, v_sh, v_ss;
    long long o_sb, o_sh, o_ss;
    long long do_sb, do_sh, do_ss;
    long long dq_sb, dq_sh, dq_ss;
    long long dk_sb, dk_sh, dk_ss;
    long long dv_sb, dv_sh, dv_ss;
    int B, H, Hk, Sq, Sk, D;
    float scale;
    int causal;
    int in_f32;   // 0: q/k/v/dO are bf16, 1: f32 (dQ only; fwd, dK/dV: 0)
    int out_f32;  // 1 writes the outputs in f32 (keep_f32, or f32 inputs)
};

namespace flash {

constexpr float NEG_INF = -1e30f;   // same sentinel as the reference
constexpr int THREADS = 128;        // 4 warps, 16 rows of a 64-row tile each

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col).
// Fragment ownership (lane = 4*g + t): A a0 (g, 2t..2t+1), a1 (g+8, 2t..),
// a2 (g, 2t+8..), a3 (g+8, 2t+8..); B b0 (k=2t..2t+1, n=g), b1 (k=2t+8..,
// n=g); C c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix: four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses
// of matrix i, and lane 4g+t receives row g, elements 2t..2t+1 of each
// (with .trans, element [2t..2t+1][g]).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// A fragment of the 16x16 tile at (r0, k0) of a row-major smem matrix X[r][k].
__device__ __forceinline__ void frag_a(const bf16* s, int ld, int r0, int k0,
                                       uint32_t a[4]) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(a, s + (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two 16x8 tiles (k0, n0) and (k0, n0 + 8) when smem holds
// Bt[n][k] (k contiguous): b[0..1] for n0, b[2..3] for n0 + 8.
__device__ __forceinline__ void frag_b_nk2(const bf16* s, int ld, int n0,
                                           int k0, uint32_t b[4]) {
    const int lane = threadIdx.x & 31;
    ldsm_x4(b, s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                   ((lane >> 3) & 1) * 8);
}

// The same two B tiles when smem holds B[k][n] (n contiguous), through the
// transposing load.
__device__ __forceinline__ void frag_b_kn2(const bf16* s, int ld, int k0,
                                           int n0, uint32_t b[4]) {
    const int lane = threadIdx.x & 31;
    ldsm_x4_t(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                     (lane >> 4) * 8);
}

// The accumulator tiles 2kc and 2kc+1 of a 16xN f32 product, rounded to
// bf16, are the A fragment of the 16x16 chunk kc: the product's output
// feeds the next product from registers (P in P.V, dS in dS.K).
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4],
                                         uint32_t a[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

// Eight f32 values rounded to bf16, as one 16-byte chunk.
__device__ __forceinline__ uint4 load8_as_bf16(const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                      pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    // src-size 0 zero-fills the 16 bytes: rows past the length read nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Stage rows [row0, row0 + rows) of a strided [seq, D] matrix into smem
// (row pitch D + 8 bf16, which keeps ldmatrix free of bank conflicts).
// Rows at or past `len` are written as zeros: the ragged edge is masked
// here, not by the hardware. bf16 rows are copied with cp.async (the
// caller commits and waits); f32 rows are converted to bf16 on the way.
template <typename T, int D>
__device__ __forceinline__ void load_tile(bf16* s, const T* g,
                                          long long row_stride, int row0,
                                          int len, int rows) {
    constexpr int CPR = D / 8;
    for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
        const int r = c / CPR, col = (c % CPR) * 8;
        const bool valid = row0 + r < len;
        // an invalid row copies nothing but still needs a legal address
        const T* src = g + (long long)(valid ? row0 + r : 0) * row_stride + col;
        bf16* dst = s + r * (D + 8) + col;
        if constexpr (sizeof(T) == 2) {
            cp_async16(dst, src, valid);
        } else {
            *reinterpret_cast<uint4*>(dst) =
                valid ? load8_as_bf16(src) : make_uint4(0u, 0u, 0u, 0u);
        }
    }
}

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sets the dynamic shared memory limit and launches; returns the CUDA error
// code of the launch (0 on success) so the Python wrapper can raise.
template <typename Kernel>
inline int launch(Kernel kern, dim3 grid, size_t smem, cudaStream_t stream,
                  const FlashParams& p) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace flash
