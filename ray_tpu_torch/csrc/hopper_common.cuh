// Hopper building blocks of the three flash kernels (forward, dQ, dK/dV):
// TMA tile loads that complete on mbarriers, wgmma (warpgroup matrix multiply-
// accumulate) with its shared-memory descriptors, the register hand-over
// between warpgroups (setmaxnreg), and the host-side tensor maps.
//
// sm_90a only: wgmma and setmaxnreg exist for no other target.
// cuTensorMapEncodeTiled is a driver-API call, reached through the runtime's
// cudaGetDriverEntryPoint, so the kernel libraries link no -lcuda.
//
// Shared-memory tiles are what TMA writes: rows of one swizzle span (64
// bf16 = 128 B under SWIZZLE_128B, 32 bf16 = 64 B under SWIZZLE_64B), in
// 8-row atoms of 8 * span bytes. A tile wider than 64 columns (head_dim
// 128) is loaded as several 64-column boxes, one after the other.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"   // FlashParams, pack_bf16, acc_to_a, quad_*

namespace hopper {

constexpr float LOG2E = 1.4426950408889634f;
// returned by a launcher whose tensor map could not be encoded: + CUresult
constexpr int ERR_TENSOR_MAP = 10000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed. A barrier starts
// in phase 0, so waiting on parity 1 passes at once (an empty ring slot).
// A wait that never ends (a protocol fault) traps after ~2^30 polls, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done, polls = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
        if (++polls == (1u << 30)) __trap();
    } while (!done);
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 4-D map at coordinates (c0 innermost .. c3); completes on
// `bar`. Out-of-range rows are written as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
    asm volatile(
        "cp.async.bulk.tensor.1d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0)
        : "memory");
}

// ---- warpgroup registers ---------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Registers that an asynchronous wgmma writes or reads: the compiler may
// neither read them early nor reuse them before the wait that follows.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
    return (uint64_t)((addr >> 4) & 0x3FFF) |
           ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}

template <int ROWB>
__host__ __device__ constexpr uint32_t swizzle_mode() {
    static_assert(ROWB == 128 || ROWB == 64, "rows of 64 or 128 bytes");
    return ROWB == 128 ? 1u : 2u;
}

// K-major operand (the reduction dimension contiguous, as Q and K rows
// are): `tile` points at an 8-row-aligned row of a box with ROWB-byte rows;
// `kk` picks the 16-column chunk of the product's depth. Inside a swizzle
// atom the chunk is a 32-byte step of the start address; 8-row groups are
// one atom (8 * ROWB bytes) apart.
template <int ROWB>
__device__ __forceinline__ uint64_t desc_k(const void* tile, int kk) {
    return make_desc(smem_u32(tile) + kk * 32, 16, 8 * ROWB,
                     swizzle_mode<ROWB>());
}

// MN-major operand (the output columns contiguous, as V and dO rows are in
// P.V and P^T.dO; read through the descriptor's transpose bit): `kc` picks
// the 16-row chunk of the depth, two atoms of 8 rows. The box is one
// swizzle span wide, so the stride between 8-row groups is the only one
// the hardware walks; both offsets are set to it.
template <int ROWB>
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int kc) {
    return make_desc(smem_u32(tile) + kc * 16 * ROWB, 8 * ROWB, 8 * ROWB,
                     swizzle_mode<ROWB>());
}

// `d` with its start address moved by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
    return d + (bytes >> 4);
}

// A loop-invariant value hidden from the compiler, so that what is derived
// from it (a descriptor per k step) is recomputed where it is used instead
// of being held in registers across the loop, where the accumulators live.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
    asm volatile("" : "+l"(x));
    return x;
}

// The accumulator of a 64xN wgmma holds, per thread of warp w (lane 4g+t),
// rows 16w+g and 16w+g+8 at columns 8j+2t, 8j+2t+1: d[4j..4j+1] and
// d[4j+2..4j+3]. The A registers of a 64x16 step from registers hold, per
// thread, the same rows at columns 2t, 2t+1 (a[0], a[1]: rows g, g+8) and
// 2t+8, 2t+9 (a[2], a[3]). So flash::acc_to_a(d + 8 kc, d + 8 kc + 4, a)
// turns the 16-column chunk kc of an accumulator, rounded to bf16, into
// the A registers of a k16 step: P and dS go from one product into the
// next without shared memory.

// D (64xN f32) (+)= A * B, one k16 step; scale_d = 0 overwrites D. ss: A
// and B from shared memory, both K-major (S = Q K^T, S^T = K Q^T,
// dP^T = V dO^T). rs: A from registers, B MN-major through the transpose
// bit (O += P V, dV += P^T dO, dK += dS^T Q).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
    static_assert(N == 64 || N == 128, "S tiles are 64 or 128 wide");
    if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
    else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
    static_assert(N == 32 || N == 64, "one TMA box of columns: 32 or 64");
    if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
    else wgmma_rs_n64(d, a, db, scale_d);
}

// Named barriers (0 is __syncthreads) between the two consumer
// warpgroups, 256 threads: one side waits, the other only arrives.
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// 2^x by the hardware's approximation (flushing denormals), the exp of
// the online softmax and of P in the backward.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Row r (0: this thread's row g, 1: row g + 8) of a 64xN accumulator d,
// times `scale`, stored from `row` (the row's first column): the pairs of
// columns 8j + 2t, 8j + 2t + 1 in the output's dtype.
template <int N>
__device__ __forceinline__ void store_acc_row(__nv_bfloat16* row, const float* d,
                                              int r, float scale) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) = flash::pack_bf16(
            d[4 * j + 2 * r] * scale, d[4 * j + 2 * r + 1] * scale);
}

template <int N>
__device__ __forceinline__ void store_acc_row(float* row, const float* d,
                                              int r, float scale) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * t) = make_float2(
            d[4 * j + 2 * r] * scale, d[4 * j + 2 * r + 1] * scale);
}

// Warp-specialised CTA: warpgroup 0 is the producer (one thread issues the
// TMA loads), warpgroups 1 and 2 the consumers (64 rows each). setmaxnreg
// moves registers from the producer to the consumers at run time
// (128 * 40 + 256 * 232 <= 65536), but ptxas still allots the consumers'
// code no more than the 168 a thread that __launch_bounds__(384, 1)
// leaves: the kernels are sized to fit 168 without spills.
constexpr int WS_THREADS = 384;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// A tile base inside dynamic shared memory rounded up to 1024 bytes, the
// alignment of a 128-byte swizzle atom (the launch asks 1024 bytes extra).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    const uint32_t a = smem_u32(p);
    return p + (((a + 1023u) & ~1023u) - a);
}

// Item of round r of a persistent CTA: rounds of gridDim.x items, taken
// forwards and backwards in turn, so that with items sorted heaviest first
// a CTA given a heavy item in one round gets a light one in the next.
// -1 past the last item.
__device__ __forceinline__ int zigzag_item(int r, int n_items) {
    const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    const int w = r * gridDim.x + c;
    return w < n_items ? w : -1;
}

// The card's SM count: the size of a persistent grid.
inline int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess)
            n = 132;
    }
    return n;
}

template <typename Kernel, typename... Args>
inline int launch_ws(Kernel kern, dim3 grid, size_t smem, cudaStream_t stream,
                     const Args&... args) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, WS_THREADS, smem, stream>>>(args...);
    return (int)cudaGetLastError();
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(ptr);
    }
    return fn;
}

// A bf16 tensor [B,H,S,D] with element strides (sb, sh, ss) and D
// contiguous, as a 4-D map over (D, S, H, B): one box is `box_rows` rows
// of `box_cols` columns (one swizzle span) of one (head, batch). The
// strides come from the tensor as it is, so transposed views need no copy.
inline int map_bhsd(CUtensorMap* m, const void* ptr, int B, int H, int S,
                    int D, long long sb, long long sh, long long ss,
                    int box_cols, int box_rows) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return ERR_TENSOR_MAP + 999;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1,
                               1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = enc(
        m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

// A contiguous f32 vector of n elements (lse or delta [B,H,Sq] flattened)
// as a 1-D map with `box` elements a box; reads past n are zeros. A box
// must start at a multiple of 4 elements (16 bytes).
inline int map_f32_rows(CUtensorMap* m, const float* ptr, long long n,
                        int box) {
    EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return ERR_TENSOR_MAP + 999;
    const cuuint64_t dims[1] = {(cuuint64_t)n};
    const cuuint64_t strides[1] = {0};   // rank 1: no strides are read
    const cuuint32_t boxd[1] = {(cuuint32_t)box};
    const cuuint32_t elem[1] = {1};
    const CUresult r = enc(
        m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
        strides, boxd, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

}  // namespace hopper
