// Flash-attention backward for dQ on Hopper:
//   P = exp(S*scale - lse), dS = P * (dO V^T - delta), dQ = scale * dS K.
//
// Replaces: ray_tpu/ops/attention.py `_bwd_dq_kernel` (launched from
// `_bwd_pallas`), the TPU Pallas kernel.
//
// Bound on the H100: tensor-core operations (three products of 2*D flops
// per live score: S, dP, dQ).
//
// Design (warp-specialised, the forward's shape): a persistent grid of one
// CTA per SM walks the (q-tile of 128 rows, q-head, batch) items, the
// heaviest causal q-tiles first, so that one item's epilogue overlaps the
// next item's loads. A CTA has three warpgroups. Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one of its threads
// issues TMA loads: an item's Q and dO, then its K and V tiles of BN rows
// into a ring of STAGES slots, K and V on barriers of their own, so that
// V's slot is given back once dP is done and K's only once dS K is.
// Warpgroups 1 and 2 each own 64 q rows, keep their rows' lse and delta
// and the dQ accumulator in f32 registers, and per K/V tile issue
// S = Q K^T and dP = dO V^T as two wgmma chains (two commit groups) with
// both operands in swizzled shared memory, form P in place in the S
// accumulator while dP is still in flight, then dS, and feed dS (rounded
// to bf16) from registers into dQ += dS K, whose B operand is the same K
// tile read through the descriptor's transpose bit. (Waiting for V between
// the two chains, with S in flight, made ptxas serialise the wgmmas:
// C7520.) `scale` is applied once, in the epilogue. K/V tiles are 64 rows:
// at 128, the S and dP accumulators alone would take 128 of the 168
// registers ptxas allots a thread of a 384-thread CTA.
// The causal and ragged-edge masks run only on the tiles that cross the
// end-aligned diagonal k_len - q_len of the warpgroup's rows or the end of
// K; tiles wholly above the diagonal are never loaded (for the CTA) or
// skipped (for its first warpgroup). A q row past Sq has zero Q and dO
// (TMA zero-fill) and lse = delta = 0, so its dS is 0; it is not stored.
// Inputs are bf16 (the wrapper rounds f32 inputs to bf16); dQ is written
// in bf16 or f32. The products run in a fixed order: dQ is deterministic.
#include "hopper_common.cuh"

namespace {
using namespace hopper;

constexpr int BM = 128;      // q rows per item, 64 per consumer warpgroup
constexpr int BN = 64;       // k/v rows per tile

template <int D>
struct Cfg {
    static constexpr int COLS = D < 64 ? D : 64;   // columns per TMA box
    static constexpr int BOXES = D / COLS;
    static constexpr int ROWB = COLS * 2;          // bytes per box row
    static constexpr int Q_BYTES = BM * D * 2;
    static constexpr int KV_BYTES = BN * D * 2;
    // K/V ring slots (measured at D = 64: 2 slower, 6 no faster)
    static constexpr int STAGES = D == 128 ? 3 : 4;
    static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES +
                                   (2 + 4 * STAGES) * sizeof(uint64_t);
};

// Work item w of a CTA -> (q-tile start, head, batch), the heaviest causal
// q-tile (the last) first, and its live K/V tiles [0, n_tiles).
struct Item {
    int q0, h, b, n_tiles;
};

__device__ __forceinline__ Item item(const FlashParams& p, int w) {
    const int hb = p.H * p.B;
    const int n_qt = (p.Sq + BM - 1) / BM;
    Item it;
    it.q0 = (n_qt - 1 - w / hb) * BM;
    it.h = (w % hb) % p.H;
    it.b = (w % hb) / p.H;
    it.n_tiles = (p.Sk + BN - 1) / BN;
    if (p.causal) {
        // K/V tile j is live iff j*BN <= last row of the q-tile + off
        const int last = it.q0 + BM - 1 + (p.Sk - p.Sq);
        it.n_tiles = last < 0 ? 0 : min(it.n_tiles, last / BN + 1);
    }
    return it;
}

template <int D, typename TO>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ FlashParams p,
                    const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmdO) {
    using C = Cfg<D>;
    constexpr int COLS = C::COLS, BOXES = C::BOXES, ROWB = C::ROWB;
    constexpr int STAGES = C::STAGES;
    extern __shared__ unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // [box][BM][COLS]
    bf16* sdO = sQ + BM * D;
    bf16* sK = sdO + BM * D;               // [stage][box][BN][COLS]
    bf16* sV = sK + STAGES * BN * D;
    uint64_t* fullQ = reinterpret_cast<uint64_t*>(sV + STAGES * BN * D);
    uint64_t* emptyQ = fullQ + 1;
    uint64_t* fullK = emptyQ + 1;
    uint64_t* emptyK = fullK + STAGES;
    uint64_t* fullV = emptyK + STAGES;
    uint64_t* emptyV = fullV + STAGES;
    const int n_items = (p.Sq + BM - 1) / BM * p.H * p.B;
    const int group = p.H / p.Hk;
    const int off = p.Sk - p.Sq;           // end-aligned causal offset

    if (threadIdx.x == 0) {
        mbar_init(fullQ, 1);
        mbar_init(emptyQ, 8);                   // one arrival per consumer warp
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(fullK + s, 1);
            mbar_init(fullV + s, 1);
            mbar_init(emptyK + s, 8);
            mbar_init(emptyV + s, 8);
        }
        mbar_fence_init();
    }
    __syncthreads();

    // Persistent: each CTA takes one item a round (zigzag_item). Both
    // roles walk the same items and count the Q/dO loads (nq) and K/V ring
    // slots (ring) the same way, which gives every barrier wait its phase.
    if (threadIdx.x < 128) {
        // ---- producer warpgroup ----
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            tma_prefetch(&tmQ);
            tma_prefetch(&tmdO);
            tma_prefetch(&tmK);
            tma_prefetch(&tmV);
            int nq = 0, ring = 0;
            for (int rd = 0, w; (w = zigzag_item(rd, n_items)) >= 0; ++rd) {
                const Item it = item(p, w);
                if (it.n_tiles == 0) continue;
                const int hk = it.h / group;
                // Q and dO of this item once the consumers are done with
                // the last item's
                mbar_wait(emptyQ, (nq++ & 1) ^ 1);
                mbar_expect_tx(fullQ, 2 * C::Q_BYTES);
                for (int c = 0; c < BOXES; ++c) {
                    tma_load_4d(sQ + c * BM * COLS, &tmQ, fullQ, c * COLS, it.q0,
                                it.h, it.b);
                    tma_load_4d(sdO + c * BM * COLS, &tmdO, fullQ, c * COLS,
                                it.q0, it.h, it.b);
                }
                for (int j = 0; j < it.n_tiles; ++j, ++ring) {
                    const int s = ring % STAGES;
                    const uint32_t ph = ((ring / STAGES) & 1) ^ 1;
                    mbar_wait(emptyK + s, ph);
                    mbar_expect_tx(fullK + s, C::KV_BYTES);
                    for (int c = 0; c < BOXES; ++c)
                        tma_load_4d(sK + (s * BOXES + c) * BN * COLS, &tmK,
                                    fullK + s, c * COLS, j * BN, hk, it.b);
                    mbar_wait(emptyV + s, ph);
                    mbar_expect_tx(fullV + s, C::KV_BYTES);
                    for (int c = 0; c < BOXES; ++c)
                        tma_load_4d(sV + (s * BOXES + c) * BN * COLS, &tmV,
                                    fullV + s, c * COLS, j * BN, hk, it.b);
                }
            }
        }
    } else {
        // ---- consumer warpgroups ----
        regs_inc<CONSUMER_REGS>();
        const int cw = threadIdx.x / 128 - 1;          // 0 or 1
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t = lane & 3;
        const float sl2 = p.scale * LOG2E;
        int nq = 0, ring = 0;

        for (int rd = 0, w; (w = zigzag_item(rd, n_items)) >= 0; ++rd) {
            const Item it = item(p, w);
            const int q_first = it.q0 + cw * 64;        // this warpgroup's rows
            const int row0 = q_first + warp * 16 + g;   // this thread's: +0, +8
            // lse (as a base-2 exponent) and delta of the thread's two rows
            const long long rows = ((long long)it.b * p.H + it.h) * p.Sq;
            float lse2[2], dl[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const bool in = row0 + 8 * r < p.Sq;
                lse2[r] = in ? p.lse[rows + row0 + 8 * r] * LOG2E : 0.f;
                dl[r] = in ? p.delta[rows + row0 + 8 * r] : 0.f;
            }
            float dq[D / 2];
#pragma unroll
            for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

            if (it.n_tiles > 0) mbar_wait(fullQ, nq++ & 1);
            for (int j = 0; j < it.n_tiles; ++j, ++ring) {
                const int s = ring % STAGES;
                const uint32_t ph = (ring / STAGES) & 1;
                const int k0 = j * BN;
                const bf16* tK = sK + s * BOXES * BN * COLS;
                const bf16* tV = sV + s * BOXES * BN * COLS;

                // a causal tile wholly above this warpgroup's diagonal (the
                // first warpgroup's last tile): nothing to add, only the
                // slot to give back once it has landed
                if (p.causal && k0 > q_first + 63 + off) {
                    mbar_wait(fullK + s, ph);
                    mbar_wait(fullV + s, ph);
                    __syncwarp();
                    if (lane == 0) {
                        mbar_arrive(emptyV + s);
                        mbar_arrive(emptyK + s);
                        if (j == it.n_tiles - 1) mbar_arrive(emptyQ);
                    }
                    continue;
                }

                // S = Q K^T, dP = dO V^T
                float sc[BN / 2], dp[BN / 2];
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] = dp[i] = 0.f;
                const uint64_t qd = opaque(desc_k<ROWB>(sQ + cw * 64 * COLS, 0));
                const uint64_t od = opaque(desc_k<ROWB>(sdO + cw * 64 * COLS, 0));
                const uint64_t kd = opaque(desc_k<ROWB>(tK, 0));
                const uint64_t vd = opaque(desc_k<ROWB>(tV, 0));
                mbar_wait(fullK + s, ph);
                mbar_wait(fullV + s, ph);
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < D / 16; ++kc) {
                    const int c = kc / (COLS / 16), kk = kc % (COLS / 16);
                    wgmma_ss<BN>(sc, desc_add(qd, c * BM * ROWB + kk * 32),
                                 desc_add(kd, c * BN * ROWB + kk * 32), kc > 0);
                }
                wgmma_commit();
#pragma unroll
                for (int kc = 0; kc < D / 16; ++kc) {
                    const int c = kc / (COLS / 16), kk = kc % (COLS / 16);
                    wgmma_ss<BN>(dp, desc_add(od, c * BM * ROWB + kk * 32),
                                 desc_add(vd, c * BN * ROWB + kk * 32), kc > 0);
                }
                wgmma_commit();

                // P = exp(S scale - lse) in place in sc (column
                // k0 + 8(i/4) + 2t + i%2 of row row0 + 8((i/2)%2)) while dP
                // is in flight. The mask selects 0: a fully masked row has
                // lse = -1e30, where exp(S scale - lse) is inf.
                wgmma_wait<1>();
                fence_regs<BN / 2>(sc);
                const bool masked =
                    (p.causal && k0 + BN - 1 > q_first + off) || k0 + BN > p.Sk;
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) {
                    const int r = (i >> 1) & 1;
                    float pr = ex2(fmaf(sc[i], sl2, -lse2[r]));
                    if (masked) {
                        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
                        const int row = row0 + 8 * r;
                        const bool ok = col < p.Sk && (!p.causal || col <= row + off);
                        pr = ok ? pr : 0.f;
                    }
                    sc[i] = pr;
                }
                wgmma_wait<0>();
                fence_regs<BN / 2>(dp);
                __syncwarp();
                if (lane == 0) {
                    mbar_arrive(emptyV + s);
                    if (j == it.n_tiles - 1) mbar_arrive(emptyQ);
                }

                // dS = P (dP - delta), in place
#pragma unroll
                for (int i = 0; i < BN / 2; ++i)
                    sc[i] *= dp[i] - dl[(i >> 1) & 1];
                uint32_t sa[BN / 16][4];
#pragma unroll
                for (int kc = 0; kc < BN / 16; ++kc)
                    flash::acc_to_a(sc + 8 * kc, sc + 8 * kc + 4, sa[kc]);

                // dQ += dS K, K read MN-major from the same tile
                const uint64_t km = opaque(desc_mn<ROWB>(tK, 0));
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
                    for (int c = 0; c < BOXES; ++c)
                        wgmma_rs<COLS>(dq + c * COLS / 2, sa[kc],
                                       desc_add(km, (c * BN + kc * 16) * ROWB), 1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs<D / 2>(dq);
                fence_regs<BN / 4>(&sa[0][0]);
                __syncwarp();
                if (lane == 0) mbar_arrive(emptyK + s);
            }

            // epilogue, while the producer loads the next item's Q, dO, K, V
            TO* dQ = static_cast<TO*>(p.dq) + it.b * p.dq_sb + it.h * p.dq_sh;
#pragma unroll
            for (int r = 0; r < 2; ++r)
                if (row0 + 8 * r < p.Sq)
                    store_acc_row<D>(dQ + (long long)(row0 + 8 * r) * p.dq_ss, dq,
                                     r, p.scale);
        }
    }
}

template <int D, typename TO>
int launch_dq(const FlashParams& p, cudaStream_t stream) {
    using C = Cfg<D>;
    CUtensorMap tq, tk, tv, tdo;
    int e = map_bhsd(&tq, p.q, p.B, p.H, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                     C::COLS, BM);
    if (!e) e = map_bhsd(&tdo, p.dout, p.B, p.H, p.Sq, D, p.do_sb, p.do_sh,
                         p.do_ss, C::COLS, BM);
    if (!e) e = map_bhsd(&tk, p.k, p.B, p.Hk, p.Sk, D, p.k_sb, p.k_sh,
                         p.k_ss, C::COLS, BN);
    if (!e) e = map_bhsd(&tv, p.v, p.B, p.Hk, p.Sk, D, p.v_sb, p.v_sh,
                         p.v_ss, C::COLS, BN);
    if (e) return e;
    const int n_items = (p.Sq + BM - 1) / BM * p.H * p.B;
    const dim3 grid(min(n_items, sm_count()));
    return launch_ws(flash_bwd_dq_kernel<D, TO>, grid, C::SMEM, stream, p, tq,
                     tk, tv, tdo);
}

template <typename TO>
int dispatch_d(const FlashParams& p, cudaStream_t stream) {
    switch (p.D) {
        case 32: return launch_dq<32, TO>(p, stream);
        case 64: return launch_dq<64, TO>(p, stream);
        case 128: return launch_dq<128, TO>(p, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/dO are bf16; out_f32 picks dQ's dtype.
extern "C" int rtt_flash_bwd_dq(const FlashParams* p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return p->out_f32 ? dispatch_d<float>(*p, s) : dispatch_d<bf16>(*p, s);
}
