// Shared pieces of the three flash-attention kernels (fwd, dQ, dK/dV): the
// argument struct and a few register helpers. Their Hopper building blocks
// (TMA, mbarriers, wgmma, setmaxnreg, tensor maps) are in hopper_common.cuh.
//
// Layout: [batch, heads, seq, head_dim] ("BHSD") addressed through element
// strides, so the model's transposed views [B,S,H,D] -> [B,H,S,D] reach the
// kernels without a copy. The last dimension must be contiguous. GQA maps
// q-head h to kv-head h / (H / Hk).
//
// The kernels read bf16 (the wrapper rounds f32 inputs to bf16) and run
// their products on the tensor cores with f32 accumulation; softmax state
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
    void* o;          // fwd output [B,H,Sq,D]
    const void* dout; // dO [B,H,Sq,D]
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
    int out_f32;  // 1 writes the outputs in f32 (keep_f32, or f32 inputs)
};

namespace flash {

constexpr float NEG_INF = -1e30f;   // same sentinel as the reference

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Two 8-column groups of an f32 accumulator row pair (c0: columns 8j..8j+7,
// c1: the next 8), rounded to bf16, as the A registers of one k16 step:
// the output of one product feeds the next from registers (P in P V, dS in
// dS K, P^T and dS^T in the dK/dV products). See hopper_common.cuh for the
// wgmma layouts that make this a plain repacking.
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4],
                                         uint32_t a[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

// max and sum over the four threads (t = 0..3) that share a row
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace flash
