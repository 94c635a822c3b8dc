// Flash-attention backward for dK and dV on Hopper:
//   dV = sum_h P_h^T dO_h,  dK = sum_h dS_h^T Q_h  over the q-heads h of a
//   kv-head's GQA group.
//
// Replaces: ray_tpu/ops/attention.py `_bwd_dkv_kernel` (launched from
// `_bwd_pallas`) and the group sum that follows it there.
//
// Bound on the H100: tensor-core operations (four products of 2*D flops
// per live score: S, dP, dV, dK).
//
// Design (warp-specialised): a persistent grid of one CTA per SM walks the
// (kv-tile, kv-head, batch) items, the kv tiles from k0 = 0 up (the
// heaviest causal work first), so that one item's epilogue overlaps the
// next item's loads. A CTA has three warpgroups. Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one of its threads
// loads an item's K and V, then keeps a ring of STAGES slots filled with
// Q and dO tiles of BQ rows and their lse and delta rows (TMA, completing
// on one mbarrier per slot; lse/delta by a 1-D map whose box starts at a
// 16-byte boundary). Warpgroups 1 and 2 keep
// dK and dV in f32 registers while the CTA walks the live (q-head of the
// group, q-tile) pairs: the TPU's sequential q grid axis and the GQA group
// sum both happen in registers, with no atomics and a deterministic order.
// The products are formed transposed: S^T = K Q^T and dP^T = V dO^T are
// wgmma chains with both operands in swizzled shared memory; P^T and dS^T,
// rounded to bf16, go from their accumulators to the A registers of
// dV += P^T dO and dK += dS^T Q, whose B operands (dO, Q) are read through
// the descriptor's transpose bit.
//   D <= 64: a kv tile of 128 rows, 64 per consumer warpgroup, each doing
// all four products for its rows.
//   D = 128: dK and dV alone would take 128 registers a thread, more than
// the 168 that ptxas allots a thread of a 384-thread CTA. So the kv tile is
// 64 rows and the two consumer warpgroups split the work: the first forms
// S^T, P^T and dV, the second dP^T, dS^T and dK, taking P^T (f32) from the
// first through shared memory under two named barriers. Each holds one
// accumulator, and the products stay balanced, two each.
// The masks run only on the tiles that need them: those crossing the
// end-aligned causal diagonal and the ragged last q tile (TMA zero-fills Q
// rows past the length, where lse = delta = 0 would give P = 1). Causal q
// tiles wholly below the diagonal are skipped. Inputs are bf16 (the
// wrapper rounds f32 inputs to bf16); dK/dV are written in bf16 or f32.
#include "hopper_common.cuh"

namespace {
using namespace hopper;

constexpr int BQ = 64;      // q rows per ring slot

// what a consumer warpgroup computes
enum Role { BOTH, DV_ONLY, DK_ONLY };

template <int D>
struct Cfg {
    static constexpr bool SPLIT = D == 128;
    // Q/dO ring slots (measured best: 3 at D <= 64, 2 at D = 128)
    static constexpr int STAGES = SPLIT ? 2 : 3;
    static constexpr int BN = SPLIT ? 64 : 128;    // kv rows per CTA
    static constexpr int COLS = D < 64 ? D : 64;   // columns per TMA box
    static constexpr int BOXES = D / COLS;
    static constexpr int ROWB = COLS * 2;
    static constexpr int KV_BYTES = BN * D * 2;
    static constexpr int Q_BYTES = BQ * D * 2;
    // lse/delta rows come as a box of BQ + 4 floats from the 16-byte
    // boundary at or before the tile's first row (TMA starts a box only
    // there); slots are ROWS_PITCH floats apart (128-byte aligned)
    static constexpr int ROWS_BOX = BQ + 4;
    static constexpr int ROWS_PITCH = BQ + 32;
    static constexpr int SLOT_BYTES = 2 * Q_BYTES + 2 * ROWS_BOX * 4;
    // P^T handed from the dV warpgroup to the dK one: two buffers of
    // BQ/2 floats per thread
    static constexpr int XCH_FLOATS = SPLIT ? 2 * (BQ / 2) * 128 : 0;
    static constexpr size_t SMEM = 1024 + 2 * KV_BYTES +
                                   STAGES * (2 * Q_BYTES + 2 * ROWS_PITCH * 4) +
                                   XCH_FLOATS * 4 +
                                   (2 + 2 * STAGES) * sizeof(uint64_t);
};

struct Smem {
    bf16 *k, *v, *q, *dout;    // q/dout: [stage][box][BQ][COLS]
    float *lse, *delta, *xch;  // lse/delta: [stage][ROWS_PITCH]
    uint64_t *full, *empty;    // the Q/dO ring
    uint64_t *full_kv, *empty_kv;
};

// Work item w of a CTA -> (kv-tile, kv-head, batch), the kv tiles from
// k0 = 0 up (the heaviest causal work first), and its live (q-head of the
// group, q-tile) pairs: q-tile qt is live iff its last row + off reaches
// the tile's first key; liveness grows with qt, so the live q-tiles are
// [qt_first, n_qt) for each of the group's q-heads.
struct Item {
    int k0, hk, b, qt_first, n_live, n_iter;
};

template <int BN>
__device__ __forceinline__ Item item(const FlashParams& p, int w) {
    const int hb = p.Hk * p.B;
    Item it;
    it.k0 = w / hb * BN;
    it.hk = (w % hb) % p.Hk;
    it.b = (w % hb) / p.Hk;
    const int n_qt = (p.Sq + BQ - 1) / BQ;
    it.qt_first = 0;
    if (p.causal) {
        const int x = it.k0 - (p.Sk - p.Sq) - BQ + 1;
        it.qt_first = x <= 0 ? 0 : min(n_qt, (x + BQ - 1) / BQ);
    }
    it.n_live = n_qt - it.qt_first;
    it.n_iter = p.H / p.Hk * it.n_live;
    return it;
}

// named barriers of the P^T hand-over (0 is __syncthreads): buffer b full
// (both sides wait) and free (the dK side arrives, the dV side waits)
constexpr int BAR_FULL = 1, BAR_FREE = 3;

// One consumer warpgroup's work on item `w`, its kv rows from kw0; `ring`
// counts the Q/dO slots consumed before it.
template <int D, typename TO, int ROLE>
__device__ __forceinline__ void consume(const FlashParams& p, const Smem& sm,
                                        const Item& w, int kw0, int ring) {
    const int b = w.b, hk = w.hk, qt_first = w.qt_first, n_live = w.n_live,
              n_iter = w.n_iter;
    using C = Cfg<D>;
    constexpr int COLS = C::COLS, BOXES = C::BOXES, ROWB = C::ROWB;
    constexpr bool WITH_P = ROLE != DK_ONLY;    // S^T, P^T, dV
    constexpr bool WITH_DS = ROLE != DV_ONLY;   // dP^T, dS^T, dK
    const int group = p.H / p.Hk;
    const int off = p.Sk - p.Sq;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kv0 = kw0 + warp * 16 + g;        // this thread's rows: +0, +8
    const int kr = kw0 - w.k0;                  // first row in the K/V tile
    const float sl2 = p.scale * LOG2E;

    float dk[WITH_DS ? D / 2 : 2], dv[WITH_P ? D / 2 : 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
        if constexpr (WITH_DS) dk[i] = 0.f;
        if constexpr (WITH_P) dv[i] = 0.f;
    }

    for (int it = 0; it < n_iter; ++it) {
        const int s = (ring + it) % C::STAGES;
        const int h = hk * group + it / n_live;
        const int q0 = (qt_first + it % n_live) * BQ;
        const bf16* tQ = sm.q + s * BOXES * BQ * COLS;
        const bf16* tdO = sm.dout + s * BOXES * BQ * COLS;
        const int shift = ((b * p.H + h) * p.Sq + q0) & 3;   // see the box
        const float* tLse = sm.lse + s * C::ROWS_PITCH + shift;
        const float* tDelta = sm.delta + s * C::ROWS_PITCH + shift;
        float* xch = sm.xch + (it & 1) * (BQ / 2) * 128 + tid;

        // S^T = K Q^T, dP^T = V dO^T
        float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
        const uint64_t kd = opaque(desc_k<ROWB>(sm.k + kr * COLS, 0));
        const uint64_t vd = opaque(desc_k<ROWB>(sm.v + kr * COLS, 0));
        const uint64_t qd = opaque(desc_k<ROWB>(tQ, 0));
        const uint64_t od = opaque(desc_k<ROWB>(tdO, 0));
        mbar_wait(sm.full + s, ((ring + it) / C::STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
            const int c = kc / (COLS / 16), kk = kc % (COLS / 16);
            if constexpr (WITH_P)
                wgmma_ss<BQ>(st, desc_add(kd, c * C::BN * ROWB + kk * 32),
                                desc_add(qd, c * BQ * ROWB + kk * 32), kc > 0);
            if constexpr (WITH_DS)
                wgmma_ss<BQ>(dpt, desc_add(vd, c * C::BN * ROWB + kk * 32),
                                desc_add(od, c * BQ * ROWB + kk * 32), kc > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (WITH_P) fence_regs<BQ / 2>(st);
        if constexpr (WITH_DS) fence_regs<BQ / 2>(dpt);
        if (it == n_iter - 1) {   // K and V are read for the last time
            __syncwarp();
            if (threadIdx.x % 32 == 0) mbar_arrive(sm.empty_kv);
        }

        // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale
        if constexpr (ROLE == DK_ONLY) named_sync(BAR_FULL + (it & 1));
        const bool masked = (p.causal && kw0 + 63 > q0 + off) ||
                            q0 + BQ > p.Sq;
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn) {
            const int qc = 8 * jn + 2 * t;          // column in the tile
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = 4 * jn + e;
                float pr;
                if constexpr (ROLE == DK_ONLY) {
                    pr = xch[i * 128];
                } else {
                    pr = ex2(fmaf(st[i], sl2, -tLse[qc + (e & 1)] * LOG2E));
                    if (masked) {
                        const int kv = kv0 + 8 * (e >> 1);
                        const int qi = q0 + qc + (e & 1);
                        const bool ok = qi < p.Sq && kv < p.Sk &&
                                        (!p.causal || kv <= qi + off);
                        pr = ok ? pr : 0.f;
                    }
                    st[i] = pr;                                    // P^T
                }
                if constexpr (WITH_DS)                                       // dS^T
                    dpt[i] = pr * (dpt[i] - tDelta[qc + (e & 1)]) * p.scale;
            }
        }
        if constexpr (ROLE == DV_ONLY) {   // hand P^T over once the buffer is free
            if (it >= 2) named_sync(BAR_FREE + (it & 1));
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) xch[i * 128] = st[i];
            __threadfence_block();
            named_sync(BAR_FULL + (it & 1));
        }
        if constexpr (ROLE == DK_ONLY) {
            __threadfence_block();
            named_arrive(BAR_FREE + (it & 1));
        }

        // dV += P^T dO, dK += dS^T Q
        uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc) {
            if constexpr (WITH_P)
                flash::acc_to_a(st + 8 * kc, st + 8 * kc + 4, pa[kc]);
            if constexpr (WITH_DS)
                flash::acc_to_a(dpt + 8 * kc, dpt + 8 * kc + 4, sa[kc]);
        }
        const uint64_t qm = opaque(desc_mn<ROWB>(tQ, 0));
        const uint64_t om = opaque(desc_mn<ROWB>(tdO, 0));
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < BQ / 16; ++kc)
#pragma unroll
            for (int c = 0; c < BOXES; ++c) {
                const uint32_t o = (c * BQ + kc * 16) * ROWB;
                if constexpr (WITH_P)
                    wgmma_rs<COLS>(dv + c * COLS / 2, pa[kc], desc_add(om, o), 1);
                if constexpr (WITH_DS)
                    wgmma_rs<COLS>(dk + c * COLS / 2, sa[kc], desc_add(qm, o), 1);
            }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (WITH_P) {
            fence_regs<D / 2>(dv);
            fence_regs<BQ / 4>(&pa[0][0]);
        }
        if constexpr (WITH_DS) {
            fence_regs<D / 2>(dk);
            fence_regs<BQ / 4>(&sa[0][0]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty + s);
    }
    if constexpr (ROLE == DV_ONLY)   // match the dK side's last two frees
        for (int it = max(n_iter - 2, 0); it < n_iter; ++it)
            named_sync(BAR_FREE + (it & 1));

    TO* dK = static_cast<TO*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
    TO* dV = static_cast<TO*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const long long kv = kv0 + 8 * r;
        if (kv >= p.Sk) continue;
        if constexpr (WITH_DS) store_acc_row<D>(dK + kv * p.dk_ss, dk, r, 1.f);
        if constexpr (WITH_P) store_acc_row<D>(dV + kv * p.dv_ss, dv, r, 1.f);
    }
}

template <int D, typename TO>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ FlashParams p,
                     const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const __grid_constant__ CUtensorMap tmdO,
                     const __grid_constant__ CUtensorMap tmLse,
                     const __grid_constant__ CUtensorMap tmDelta) {
    using C = Cfg<D>;
    constexpr int BN = C::BN, COLS = C::COLS, BOXES = C::BOXES;
    extern __shared__ unsigned char smem_raw[];
    Smem sm;
    sm.k = reinterpret_cast<bf16*>(align1024(smem_raw));  // [box][BN][COLS]
    sm.v = sm.k + BN * D;
    sm.q = sm.v + BN * D;
    sm.dout = sm.q + C::STAGES * BQ * D;
    sm.lse = reinterpret_cast<float*>(sm.dout + C::STAGES * BQ * D);
    sm.delta = sm.lse + C::STAGES * C::ROWS_PITCH;
    sm.xch = sm.delta + C::STAGES * C::ROWS_PITCH;
    sm.full_kv = reinterpret_cast<uint64_t*>(sm.xch + C::XCH_FLOATS);
    sm.empty_kv = sm.full_kv + 1;
    sm.full = sm.empty_kv + 1;
    sm.empty = sm.full + C::STAGES;
    const int n_items = (p.Sk + BN - 1) / BN * p.Hk * p.B;
    const int group = p.H / p.Hk;

    if (threadIdx.x == 0) {
        mbar_init(sm.full_kv, 1);
        mbar_init(sm.empty_kv, 8);        // one arrival per consumer warp
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(sm.full + s, 1);
            mbar_init(sm.empty + s, 8);
        }
        mbar_fence_init();
    }
    __syncthreads();

    // Persistent: each CTA takes one item a round (zigzag_item). Both
    // roles walk the same items and count the K/V loads (nkv) and Q/dO ring slots
    // (ring) the same way, which gives every barrier wait its phase.
    if (threadIdx.x < 128) {
        // ---- producer warpgroup ----
        regs_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            tma_prefetch(&tmQ);
            tma_prefetch(&tmdO);
            int nkv = 0, ring = 0;
            for (int r = 0, w; (w = zigzag_item(r, n_items)) >= 0; ++r) {
                const Item itm = item<BN>(p, w);
                if (itm.n_iter == 0) continue;
                // K and V of this item once the consumers are done with the
                // last item's
                mbar_wait(sm.empty_kv, (nkv++ & 1) ^ 1);
                mbar_expect_tx(sm.full_kv, 2 * C::KV_BYTES);
                for (int c = 0; c < BOXES; ++c) {
                    tma_load_4d(sm.k + c * BN * COLS, &tmK, sm.full_kv, c * COLS,
                                itm.k0, itm.hk, itm.b);
                    tma_load_4d(sm.v + c * BN * COLS, &tmV, sm.full_kv, c * COLS,
                                itm.k0, itm.hk, itm.b);
                }
                for (int it = 0; it < itm.n_iter; ++it, ++ring) {
                    const int s = ring % C::STAGES;
                    mbar_wait(sm.empty + s, ((ring / C::STAGES) & 1) ^ 1);
                    const int h = itm.hk * group + it / itm.n_live;
                    const int q0 = (itm.qt_first + it % itm.n_live) * BQ;
                    mbar_expect_tx(sm.full + s, C::SLOT_BYTES);
                    for (int c = 0; c < BOXES; ++c) {
                        tma_load_4d(sm.q + (s * BOXES + c) * BQ * COLS, &tmQ,
                                    sm.full + s, c * COLS, q0, h, itm.b);
                        tma_load_4d(sm.dout + (s * BOXES + c) * BQ * COLS, &tmdO,
                                    sm.full + s, c * COLS, q0, h, itm.b);
                    }
                    const int row = ((itm.b * p.H + h) * p.Sq + q0) & ~3;
                    tma_load_1d(sm.lse + s * C::ROWS_PITCH, &tmLse, sm.full + s,
                                row);
                    tma_load_1d(sm.delta + s * C::ROWS_PITCH, &tmDelta,
                                sm.full + s, row);
                }
            }
        }
    } else {
        // ---- consumer warpgroups ----
        regs_inc<CONSUMER_REGS>();
        const int cw = threadIdx.x / 128 - 1;          // 0 or 1
        int nkv = 0, ring = 0;
        for (int r = 0, w; (w = zigzag_item(r, n_items)) >= 0; ++r) {
            const Item itm = item<BN>(p, w);
            if (itm.n_iter > 0) mbar_wait(sm.full_kv, nkv++ & 1);
            if constexpr (C::SPLIT) {
                if (cw == 0)
                    consume<D, TO, DV_ONLY>(p, sm, itm, itm.k0, ring);
                else
                    consume<D, TO, DK_ONLY>(p, sm, itm, itm.k0, ring);
            } else {
                consume<D, TO, BOTH>(p, sm, itm, itm.k0 + cw * 64, ring);
            }
            ring += itm.n_iter;
        }
    }
}

template <int D, typename TO>
int launch_dkv(const FlashParams& p, cudaStream_t stream) {
    using C = Cfg<D>;
    CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
    const long long rows = (long long)p.B * p.H * p.Sq;
    int e = map_bhsd(&tq, p.q, p.B, p.H, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                     C::COLS, BQ);
    if (!e) e = map_bhsd(&tdo, p.dout, p.B, p.H, p.Sq, D, p.do_sb, p.do_sh,
                         p.do_ss, C::COLS, BQ);
    if (!e) e = map_bhsd(&tk, p.k, p.B, p.Hk, p.Sk, D, p.k_sb, p.k_sh,
                         p.k_ss, C::COLS, C::BN);
    if (!e) e = map_bhsd(&tv, p.v, p.B, p.Hk, p.Sk, D, p.v_sb, p.v_sh,
                         p.v_ss, C::COLS, C::BN);
    if (!e) e = map_f32_rows(&tlse, p.lse, rows, C::ROWS_BOX);
    if (!e) e = map_f32_rows(&tdelta, p.delta, rows, C::ROWS_BOX);
    if (e) return e;
    const int n_items = (p.Sk + C::BN - 1) / C::BN * p.Hk * p.B;
    const dim3 grid(min(n_items, sm_count()));
    return launch_ws(flash_bwd_dkv_kernel<D, TO>, grid, C::SMEM, stream, p,
                     tq, tk, tv, tdo, tlse, tdelta);
}

template <typename TO>
int dispatch_d(const FlashParams& p, cudaStream_t stream) {
    switch (p.D) {
        case 32: return launch_dkv<32, TO>(p, stream);
        case 64: return launch_dkv<64, TO>(p, stream);
        case 128: return launch_dkv<128, TO>(p, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/k/v/dO are bf16; out_f32 picks dK/dV's dtype.
extern "C" int rtt_flash_bwd_dkv(const FlashParams* p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return p->out_f32 ? dispatch_d<float>(*p, s) : dispatch_d<bf16>(*p, s);
}
