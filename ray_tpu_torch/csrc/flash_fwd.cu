// Flash-attention forward on Hopper: O = softmax(Q K^T * scale) V and the
// row logsumexp.
//
// Replaces: ray_tpu/ops/attention.py `_fwd_kernel` (launched by
// `_fwd_pallas`), the TPU Pallas kernel.
//
// Bound on the H100: at the GPT-2 medium shape (causal, S=1024, D=64) the
// two products cost 4*D flops per live score, ~254 flop per byte of Q/K/V
// read once and O/lse written once: just under the card's ~295 flop/byte
// ridge, so bytes bound it (0.030 ms against 0.026 ms of tensor-core time
// for B=12, H=16); longer sequences and D=128 cross into operations.
//
// Design (warp-specialised, FlashAttention-3 style): a persistent grid of
// one CTA per SM walks the (q-tile of 128 rows, q-head, batch) items, the
// heaviest causal q-tiles first, so that one item's epilogue overlaps the
// next item's loads. A CTA has three warpgroups. Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one of its threads
// issues TMA loads: an item's Q, then its K and V tiles of BN rows into a
// ring of STAGES slots, K and V on barriers of their own, so that
// S = Q K^T starts before V has landed. Warpgroups 1 and 2 each own 64 q
// rows and keep their online-softmax state (running max m, partial sum l,
// O accumulator) in f32 registers. S = Q K^T is one wgmma chain with both
// operands in swizzled shared memory; P goes from the S accumulator to the
// A registers of O += P V, whose B operand is V read through the
// descriptor's transpose bit. The causal and ragged-edge masks run only on
// the tiles that need them (those crossing the end-aligned diagonal
// k_len - q_len, and the last K tile); causal tiles wholly above the
// diagonal are never loaded. Inputs are bf16 (the wrapper rounds f32
// inputs to bf16); O is written in bf16 or f32, lse [B,H,Sq] in f32. A
// fully masked row gives O = 0 and lse = -1e30.
#include "hopper_common.cuh"

namespace {
using namespace hopper;
using flash::NEG_INF;
using flash::quad_max;
using flash::quad_sum;

constexpr int BM = 128;      // q rows per CTA, 64 per consumer warpgroup
constexpr int BN = 128;      // k/v rows per tile
constexpr int STAGES = 2;    // K/V ring slots

template <int D>
struct Cfg {
    static constexpr int COLS = D < 64 ? D : 64;   // columns per TMA box
    static constexpr int BOXES = D / COLS;
    static constexpr int ROWB = COLS * 2;          // bytes per box row
    static constexpr int Q_BYTES = BM * D * 2;
    static constexpr int KV_BYTES = BN * D * 2;
    static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                                   (2 + 4 * STAGES) * sizeof(uint64_t);
};

// Work item w of a CTA -> (q-tile start, head, batch): the q-tiles of all
// heads and batches, the heaviest causal q-tile (the last) first.
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

// Online softmax of one tile of raw scores S (this thread's rows row0 and
// row0 + 8, columns k0 + 8j + 2t (+1)): the running max m and sum l of the
// two rows move on, alpha is the factor that rescales O, and P = exp(S - m)
// goes, rounded to bf16, into the A registers `pa` of the P V product. The
// causal and ragged-edge mask runs only on a tile that crosses the
// end-aligned diagonal of the warpgroup's rows (from q_first) or the end
// of K.
__device__ __forceinline__ void online_softmax(
    float* sc, const FlashParams& p, int k0, int q_first, int row0, int t,
    int off, float sl2, float* m, float* l, float* alpha, uint32_t (*pa)[4]) {
    const bool masked =
        (p.causal && k0 + BN - 1 > q_first + off) || k0 + BN > p.Sk;
    float mx[2] = {NEG_INF, NEG_INF};
    if (masked) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
            const int r = (i >> 1) & 1;
            const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
            const bool ok =
                col < p.Sk && (!p.causal || col <= row0 + 8 * r + off);
            sc[i] = ok ? sc[i] : NEG_INF;
            mx[r] = fmaxf(mx[r], sc[i]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
            mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float msc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = ex2((m[r] - m_new) * sl2);
        m[r] = m_new;
        msc[r] = m_new * sl2;
        l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pr = ex2(fmaf(sc[i], sl2, -msc[r]));
        // a masked score is exactly NEG_INF: probability 0, also while the
        // whole row is still masked (m == NEG_INF)
        if (masked) pr = sc[i] == NEG_INF ? 0.f : pr;
        sc[i] = pr;
        l[r] += pr;
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
        flash::acc_to_a(sc + 8 * kc, sc + 8 * kc + 4, pa[kc]);
}

template <int D, typename TO>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ FlashParams p,
                 const __grid_constant__ CUtensorMap tmQ,
                 const __grid_constant__ CUtensorMap tmK,
                 const __grid_constant__ CUtensorMap tmV) {
    using C = Cfg<D>;
    constexpr int COLS = C::COLS, BOXES = C::BOXES, ROWB = C::ROWB;
    extern __shared__ unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // [box][BM][COLS]
    bf16* sK = sQ + BM * D;                // [stage][box][BN][COLS]
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
    // roles walk the same items and count the Q loads (nq) and K/V ring slots (ring)
    // the same way, which gives every barrier wait its phase.
    if (threadIdx.x < 128) {
        // ---- producer warpgroup ----
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            tma_prefetch(&tmQ);
            tma_prefetch(&tmK);
            tma_prefetch(&tmV);
            int nq = 0, ring = 0;
            for (int r = 0, w; (w = zigzag_item(r, n_items)) >= 0; ++r) {
                const Item it = item(p, w);
                if (it.n_tiles == 0) continue;
                const int hk = it.h / group;
                // Q of this item once the consumers are done with the last
                mbar_wait(emptyQ, (nq++ & 1) ^ 1);
                mbar_expect_tx(fullQ, C::Q_BYTES);
                for (int c = 0; c < BOXES; ++c)
                    tma_load_4d(sQ + c * BM * COLS, &tmQ, fullQ, c * COLS, it.q0,
                                it.h, it.b);
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

        for (int r = 0, w; (w = zigzag_item(r, n_items)) >= 0; ++r) {
            const Item it = item(p, w);
            const int q_first = it.q0 + cw * 64;        // this warpgroup's rows
            const int row0 = q_first + warp * 16 + g;   // this thread's: +0, +8
            float o[D / 2];
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
            float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

            if (it.n_tiles > 0) mbar_wait(fullQ, nq++ & 1);
            for (int j = 0; j < it.n_tiles; ++j, ++ring) {
                const int s = ring % STAGES;
                const uint32_t ph = (ring / STAGES) & 1;
                const bf16* tK = sK + s * BOXES * BN * COLS;
                const bf16* tV = sV + s * BOXES * BN * COLS;

                // S = Q K^T (raw scores)
                float sc[BN / 2];
#pragma unroll
                for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
                const uint64_t qd = opaque(desc_k<ROWB>(sQ + cw * 64 * COLS, 0));
                const uint64_t kd = opaque(desc_k<ROWB>(tK, 0));
                mbar_wait(fullK + s, ph);
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < D / 16; ++kc) {
                    const int c = kc / (COLS / 16), kk = kc % (COLS / 16);
                    wgmma_ss<BN>(sc, desc_add(qd, c * BM * ROWB + kk * 32),
                                    desc_add(kd, c * BN * ROWB + kk * 32), kc > 0);
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs<BN / 2>(sc);
                __syncwarp();
                if (lane == 0) {
                    mbar_arrive(emptyK + s);
                    if (j == it.n_tiles - 1) mbar_arrive(emptyQ);
                }

                uint32_t pa[BN / 16][4];
                float alpha[2];
                online_softmax(sc, p, j * BN, q_first, row0, t, off, sl2, m, l,
                               alpha, pa);
#pragma unroll
                for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

                // O += P V
                const uint64_t vd = opaque(desc_mn<ROWB>(tV, 0));
                mbar_wait(fullV + s, ph);
                wgmma_fence();
#pragma unroll
                for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
                    for (int c = 0; c < BOXES; ++c)
                        wgmma_rs<COLS>(o + c * COLS / 2, pa[kc],
                                          desc_add(vd, (c * BN + kc * 16) * ROWB),
                                          1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs<D / 2>(o);
                fence_regs<BN / 4>(&pa[0][0]);
                __syncwarp();
                if (lane == 0) mbar_arrive(emptyV + s);
            }

            // epilogue, while the producer loads the next item's Q and K/V
            float inv[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] = quad_sum(l[r]);
                inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];   // fully masked: O = 0
            }
            TO* O = static_cast<TO*>(p.o) + it.b * p.o_sb + it.h * p.o_sh;
#pragma unroll
            for (int r = 0; r < 2; ++r)
                if (row0 + 8 * r < p.Sq)
                    store_acc_row<D>(O + (long long)(row0 + 8 * r) * p.o_ss, o,
                                     r, inv[r]);
            if (t == 0) {
                float* LSE = p.lse + ((long long)it.b * p.H + it.h) * p.Sq;
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    if (row0 + 8 * r < p.Sq)
                        LSE[row0 + 8 * r] =
                            l[r] == 0.f ? NEG_INF : m[r] * p.scale + logf(l[r]);
            }
        }
    }
}

template <int D, typename TO>
int launch_fwd(const FlashParams& p, cudaStream_t stream) {
    using C = Cfg<D>;
    CUtensorMap tq, tk, tv;
    int e = map_bhsd(&tq, p.q, p.B, p.H, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                     C::COLS, BM);
    if (!e) e = map_bhsd(&tk, p.k, p.B, p.Hk, p.Sk, D, p.k_sb, p.k_sh,
                         p.k_ss, C::COLS, BN);
    if (!e) e = map_bhsd(&tv, p.v, p.B, p.Hk, p.Sk, D, p.v_sb, p.v_sh,
                         p.v_ss, C::COLS, BN);
    if (e) return e;
    const int n_items = (p.Sq + BM - 1) / BM * p.H * p.B;
    const dim3 grid(min(n_items, sm_count()));
    return launch_ws(flash_fwd_kernel<D, TO>, grid, C::SMEM, stream, p, tq,
                     tk, tv);
}

template <typename TO>
int dispatch_d(const FlashParams& p, cudaStream_t stream) {
    switch (p.D) {
        case 32: return launch_fwd<32, TO>(p, stream);
        case 64: return launch_fwd<64, TO>(p, stream);
        case 128: return launch_fwd<128, TO>(p, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v are bf16; out_f32 picks O's dtype.
extern "C" int rtt_flash_fwd(const FlashParams* p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return p->out_f32 ? dispatch_d<float>(*p, s) : dispatch_d<bf16>(*p, s);
}
