// wkv6_wgmma: the bf16 form of the port's RWKV-6 WKV, on Hopper's tensor
// cores (wgmma) with TMA loads and stores.  CUDA C++ for sm_90a, built with
// wkv6.cu into one shared library (repro_torch/kernels/build.py); wkv6.cu's
// C entry point sends every bf16 call here and every f32 call to its own
// CUDA-core form.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel
// (wrapper wkv6) for bf16.  The function is the one wkv6.cu's header states,
// over chunks of L = 64 steps: per (batch, head), with the (K, K) f32 state
// S zero at the start, cum the inclusive cumsum of log_w over the chunk and
// cum_{-1} = 0,
//   o  = (r_t * exp(cum_{t-1})) S + A v,
//   A[t, i] = sum_d r_t[d] k_i[d] exp(cum_{t-1}[d] - cum_i[d])  (i < t),
//   A[t, t] = sum_d r_t[d] u[d] k_t[d]                    (the u bonus),
//   S <- diag(exp(cum_{L-1})) S + sum_i (k_i * exp(cum_{L-1} - cum_i)) v_i^T,
// in f32, o rounded once to bf16.  Any log_w <= 0 is taken: no step rests
// on the model's clamp.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes.  At rwkv6-1.6b's
// prefill (B = 2, S = 2048, H = 32, K = 64) r, k, v, o are 16.8 MB each and
// log_w 33.6 MB: 100.7 MB, 30 us at 3.35 TB/s.  This form issues, per
// (batch, head, chunk), seven products of 64^3 on the chain (7.5 GFLOP at
// the prefill) and, per block, twelve of 64 x 16 x 64 for A (6.4 GFLOP with
// two blocks a head): 14 us at 989 TFLOP/s.
//
// What the design does about it:
// - A's sub-blocks (sub-chunks of 16 steps) are products on the tensor
//   cores.  For a row t after column sub-chunk j and c_j the cum of its last
//   step, r_t exp(cum_{t-1} - c_j) and k_i exp(c_j - cum_i) both have
//   exponents <= 0, so nothing overflows (an underflow to 0 loses a term
//   below 2^-126); rows at or before sub-chunk j are zero in the product.
//   The diagonal sub-block j = p is a product too where no sub-chunk's cum
//   falls more than kRange (2^kRange bounds r_t exp(cum_{t-1} - c_p) from
//   above and k_i exp(c_p - cum_i) from below), decided per (batch, head,
//   chunk) over all its channels (tools/wkv_phases.py counts the chunks of
//   rwkv6-1.6b's prefill that take each path).  Where one falls further
//   (log_w at the model's clamp of -8 a step falls 185 in log2 units over
//   16 steps) the chunk's diagonal sub-blocks are formed per (t, i, d)
//   instead, one warp each with a channel a lane (two: d and d + 32), k_i
//   times a running product along t of the steps' decays (each at most 1),
//   and a butterfly reduce-scatter that sums 32 (t, i) pairs over the lanes
//   at a time.  So any log_w <= 0 is taken.  R~ is formed as R^_t = r_t
//   exp(cum_{t-1} - c_{p-1}) (row sub-chunk p, c_{-1} = 0), one ex2 a
//   (t, d), times exp(c_{p-1} - c_j), one a (p, j, d); the same R^ gives
//   r~ = r exp(cum_{t-1}) and K~ = k exp(c_j - cum_i) gives kdec = k
//   exp(cum_{L-1} - cum_i).
// - Every f32 operand enters the tensor cores as bf16 hi + lo (16 bits):
//   each of R~, K~ (A's sub-blocks), A, r~, S and kdec rounded once to bf16
//   puts outputs outside the bound the kernel is held to (2e-3 + 1e-2 |want|
//   against the plain f32 arithmetic) at the main path's shape
//   (tests/test_torch_rwkv6.py).  A product of two split operands is three
//   products (lo x lo dropped).  r, k and v are bf16 and exact.
// - The state chain runs on wgmma with S (64 x NV, f32) in one warpgroup's
//   accumulator registers for the whole sequence.  Per chunk: (a) O = r~ S
//   (S^T's hi and lo in shared memory, K-major), (b) O += A v (A from shared
//   memory, v the MN-major operand as TMA wrote it), (c) S <- exp(cum_L) S
//   + kdec^T v (kdec read transposed by ldmatrix.trans into registers): 28
//   wgmma.m64nNVk16 in one group.
// - Everything that does not depend on S (the scan, R^, r~, kdec, the
//   decay, all of A) is formed ahead of the chain by two more warpgroups,
//   one on the even chunks and one on the odd, each into its own input and
//   output buffers, with mbarriers between them and the chain (full: a
//   chunk's operands are ready; empty: the chain is done with them).  Each
//   is latency-bound with one warp a scheduler, so two of them keep the
//   chain fed about twice as fast as one (tools/wkv_phases.py).  The scan is
//   one channel a thread over half the chunk and one exchange.  K~ lives in
//   the A tiles until A is written over it.
// - TMA loads r, k, v (bf16, 128-byte swizzled rows) and log_w (f32, plain
//   rows, then overwritten in place by cum with 8-float groups XOR-swizzled
//   by row) as they lie, views included, two chunks ahead; zero fill past S
//   and past K adds nothing (log_w = 0, k = 0 there).  o leaves through a
//   TMA store, clipped at S and K.
// - NV = 64 value columns a block (one block a (batch, head)) or 32 (two
//   blocks a head, each forming all of A: 128 blocks at the prefill, the
//   default, kKeptColumns): the "geometry".  Three warpgroups, about 217 KB
//   of shared memory, one block an SM.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kL = 64;                    // chunk length: the rows of a tile
// (sub-chunks of 16 steps: A's blocks, one a warp's rows in wgmma layouts)
constexpr int kThreads = 384;             // the chain's and two preps' warpgroups
constexpr int kTile = kL * kRowBytes;     // one 64 x 64 bf16 tile, 8 KB
constexpr int kIn = 2 * kTile + kL * kL * 4;   // r, k, log_w of a chunk: 32 KB
constexpr int kOut = 6 * kTile;           // r~, kdec, A, each hi and lo: 48 KB
constexpr int kPrepF = 13 * 64 + 4 * 256 + 2 * 64;   // a prep's floats
constexpr float kLog2e = 1.4426950408889634f;   // exp(v) = ex2(v kLog2e)
// the most a sub-chunk's cum may fall (log2 units, 69 in natural units) for
// its diagonal sub-block to be a product: past it, per (t, i, d)
constexpr float kRange = 100.f;
// value columns a block unless the caller asks for the other geometry
constexpr int kKeptColumns = 32;

// byte offsets from the 1024-aligned base
constexpr uint32_t kOffV = 2 * kIn;              // v of chunk c at + kTile (c % 2)
constexpr uint32_t kOffOut = kOffV + 2 * kTile;  // prep outputs, + kOut (c % 2)
constexpr uint32_t kOffSt = kOffOut + 2 * kOut;  // S^T hi, lo
constexpr uint32_t kOffO = kOffSt + 2 * kTile;   // o of a chunk, for the store
constexpr uint32_t kOffF = kOffO + kTile;        // floats: decay [2][64]; per
// prep warpgroup its vectors [9][64], the diagonal sub-blocks [4][16][16],
// bonus [64] and the scan's exchange [64]; u [64]
constexpr int kFloats = 2 * 64 + 2 * kPrepF + 64;
constexpr uint32_t kOffBar = kOffF + 4 * kFloats;    // 8 mbarriers
constexpr int kSmem = kOffBar + 8 * 8 + 1024;        // + 1024 to align
static_assert(kSmem <= 232448, "over the shared memory a block can have");

// chunk c's r, k and log_w into input set c % 2, completing mbarrier in[c % 2]
__device__ __forceinline__ void load_in(const CUtensorMap* tr,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tw, uint32_t base,
                                        uint32_t bar, int c, int h, int b) {
    const uint32_t dst = base + (c & 1) * kIn, full = bar + 8 * (c & 1);
    mbar_expect(full, kIn);
    tma_load(dst, tr, full, 0, h, c * kL, b);            // (K, H, S, B)
    tma_load(dst + kTile, tk, full, 0, h, c * kL, b);
    tma_load(dst + 2 * kTile, tw, full, 0, h, c * kL, b);
}

// chunk c's v into v slot c % 2, completing mbarrier vb[c % 2]
__device__ __forceinline__ void load_v(const CUtensorMap* tv, uint32_t base,
                                       uint32_t bar, int c, int h, int b) {
    const uint32_t full = bar + 8 * (c & 1);
    mbar_expect(full, kTile);
    tma_load(base + kOffV + (c & 1) * kTile, tv, full, 0, h, c * kL, b);
}

// cum of step t, channel d, in the log_w tile it overwrote: rows of 64
// floats, groups of 8 XOR-swizzled by the row (so that the rows a fragment
// reads fall in distinct banks)
__device__ __forceinline__ int cidx(int t, int d) {
    return t * kL + (d ^ ((t & 7) << 3));
}

__device__ __forceinline__ float2 bf2(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
__device__ __forceinline__ float bf1(const uint8_t* p) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// the address of (row, 16-byte chunk) of the o tile: NV = 64, 128-byte rows
// swizzled as TMA's 128B mode; NV = 32, 64-byte rows as its 64B mode
template <int NV>
__device__ __forceinline__ uint32_t oswz(int row, int chunk) {
    if constexpr (NV == 64) return swz(row, chunk);
    return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// The butterfly reduce-scatter of 32 values a lane: lane l returns the sum,
// over the warp's lanes, of their v[l]
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
        const bool up = lane & s;
#pragma unroll
        for (int j = 0; j < s; ++j) {
            const float send = up ? v[j] : v[j + s];
            const float keep = up ? v[j + s] : v[j];
            v[j] = keep + __shfl_xor_sync(0xffffffffu, send, s);
        }
    }
    return v[0];
}

// The chain warpgroup: S (64 x NV) in registers, products (a), (b), (c) a
// chunk, o out through TMA.
template <int NV>
__device__ __forceinline__ void chain(const CUtensorMap* tm_v,
                                      const CUtensorMap* tm_o, uint32_t base,
                                      const float* decay, int n_chunks,
                                      int h, int b, int n0) {
    constexpr int NA = NV / 2;                    // accumulators a thread
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;          // rows r0, r0 + 8
    const int st_row = warp * 16 + 8 * (lane / 8 % 2) + lane % 8;
    const uint32_t vb = base + kOffBar + 16, full = vb + 16, empty = full + 16;
    const uint32_t sthi = base + kOffSt, stlo = sthi + kTile;
    const uint32_t otile = base + kOffO, vcol = 2 * n0;
    float st[NA];                                 // S[d][c], accumulator layout
#pragma unroll
    for (int j = 0; j < NA; ++j) st[j] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
        const int s = c & 1;
        const uint32_t ph = (c >> 1) & 1;
        const uint32_t out = base + kOffOut + s * kOut;
        const uint32_t rthi = out, rtlo = out + kTile, kdhi = out + 2 * kTile,
                       kdlo = out + 3 * kTile, ahi = out + 4 * kTile,
                       alo = out + 5 * kTile;
        const uint32_t vt = base + kOffV + s * kTile + vcol;
        mbar_wait(full + 8 * s, ph);              // the prep's chunk c
        mbar_wait(vb + 8 * s, ph);                // v of chunk c

        // S's decay by rows d; kdec^T as A fragments (ldmatrix.trans reads
        // kdec's 8 x 8 blocks transposed: matrix f holds rows d + 8 (f % 2),
        // steps i + 8 (f / 2))
        const float dec[2] = {decay[s * kL + r0], decay[s * kL + r0 + 8]};
        float o[NA];
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            st[j] *= dec[(j >> 1) & 1];
            o[j] = 0.f;
        }
        uint32_t khi[4][4], klo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int mq = lane / 8;
            const uint32_t off = swz(16 * kk + 8 * (mq / 2) + lane % 8,
                                     2 * warp + mq % 2);
            ldmatrix_x4_trans(khi[kk], kdhi + off);
            ldmatrix_x4_trans(klo[kk], kdlo + off);
        }

        // (a) O = r~ S, (b) O += A v, (c) S += kdec^T v, one group
        pin<NA>(st);
        pin<NA>(o);
        pin<16>(&khi[0][0]);
        pin<16>(&klo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t ah = desc(rthi + 32 * kk, 16, 1024),
                           al = desc(rtlo + 32 * kk, 16, 1024),
                           bh = desc(sthi + 32 * kk, 16, 1024),
                           bl = desc(stlo + 32 * kk, 16, 1024);
            wgmma_ss<NV, 0, 0>(o, ah, bh);
            wgmma_ss<NV, 0, 0>(o, al, bh);
            wgmma_ss<NV, 0, 0>(o, ah, bl);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t vk = desc(vt + 16 * kRowBytes * kk, kTile, 1024);
            wgmma_ss<NV, 0, 1>(o, desc(ahi + 32 * kk, 16, 1024), vk);
            wgmma_ss<NV, 0, 1>(o, desc(alo + 32 * kk, 16, 1024), vk);
            wgmma_rs<NV, 1>(st, khi[kk], vk);
            wgmma_rs<NV, 1>(st, klo[kk], vk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<NA>(st);
        pin<NA>(o);
        if (tid == 0) bulk_wait_read();           // chunk c - 1's o is read
        named_bar(1, 128);                        // the chunk's operands are read
        if (tid == 0) {
            mbar_arrive(empty + 8 * s);
            if (c + 2 < n_chunks) load_v(tm_v, base, vb, c + 2, h, b);
        }

        // S^T's bf16 hi and lo for the next chunk's (a): rows c, d
        // contiguous (stmatrix.trans: matrix j of the pair m holds rows
        // d + 8 (j % 2), columns 8 (m + j / 2))
#pragma unroll
        for (int m = 0; m < NV / 8; m += 2) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                split2(st[4 * m + 2 * j], st[4 * m + 2 * j + 1], hi[j], lo[j]);
            const uint32_t off = swz(8 * (m + lane / 16) + lane % 8,
                                     2 * warp + (lane / 8) % 2);
            stmatrix_x4_trans(sthi + off, hi);
            stmatrix_x4_trans(stlo + off, lo);
        }
        // o, rounded once, into the o tile; TMA writes it out, nothing past
        // S or K
#pragma unroll
        for (int m = 0; m < NV / 8; m += 2) {
            uint32_t ob[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 v = __floats2bfloat162_rn(
                    o[4 * m + 2 * j], o[4 * m + 2 * j + 1]);
                ob[j] = *reinterpret_cast<const uint32_t*>(&v);
            }
            stmatrix_x4(otile + oswz<NV>(st_row, m + lane / 16), ob);
        }
        fence_proxy_async();
        named_bar(1, 128);                        // S^T and the o tile are written
        if (tid == 0) {
            tma_store(tm_o, otile, n0, h, c * kL, b);
            bulk_commit();
        }
    }
    if (tid == 0) bulk_wait();
}

// A prep warpgroup: per chunk, everything the chain needs that does not
// depend on S.  Prep warpgroup w takes chunks w, w + 2, ..., so it owns input
// and output set w; named barrier 2 + w.  Warp p owns rows 16 p .. 16 p + 15
// (row sub-chunk p) in the fragment layouts and diagonal sub-block p.
__device__ __forceinline__ void prep(const CUtensorMap* tm_r,
                                     const CUtensorMap* tm_k,
                                     const CUtensorMap* tm_w, uint32_t base,
                                     uint8_t* gb, float* fl, int n_chunks,
                                     int h, int b) {
    const int w = (threadIdx.x - 128) / 128, ptid = (threadIdx.x - 128) % 128;
    const int p = ptid / 32, lane = ptid % 32;
    const int r0 = 16 * p + lane / 4;
    const int st_row = 16 * p + 8 * (lane / 8 % 2) + lane % 8;
    const int cq = 2 * (lane % 4);
    const uint32_t inb = base + kOffBar, full = inb + 32, empty = inb + 48;
    float* const decay = fl;
    // E_1..3, G_20, G_30, G_31, F_0..2, D_0..3; the diagonal's sums
    float* const vec = fl + 2 * kL + w * kPrepF;
    float* const dg = vec + 13 * kL;
    float* const bonus = dg + 4 * 256;
    float* const xs = bonus + kL;
    const float* const us = fl + 2 * kL + 2 * kPrepF;
    // where lane's four reduce-scatter sums go: pair 32 q + lane, pairs in
    // the order (t, i) = (1, 0), (2, 0), (2, 1), (3, 0) ...; 120 pairs, the
    // last 8 slots to an entry above the diagonal, never read
    int dst[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int idx = 32 * q + lane;
        int t = 1;
        while ((t + 1) * t / 2 <= idx) ++t;
        dst[q] = p * 256 + (idx < 120 ? t * 16 + idx - t * (t - 1) / 2 : 15);
    }

    const int s = w;                              // this warpgroup's set
    uint8_t* const Rb = gb + s * kIn;
    uint8_t* const Kb = Rb + kTile;
    float* const W = reinterpret_cast<float*>(Rb + 2 * kTile);
    const uint32_t out = base + kOffOut + s * kOut;
    uint8_t* const outp = gb + kOffOut + s * kOut;
    // K~ (hi, lo) lives in the A tiles until A is written over it
    const uint32_t kthi = out + 4 * kTile, ktlo = out + 5 * kTile;
    uint8_t* const kth = outp + 4 * kTile;
    uint8_t* const ktl = outp + 5 * kTile;
    for (int c = w; c < n_chunks; c += 2) {
        const uint32_t ph = (c >> 1) & 1;
        mbar_wait(inb + 8 * s, ph);               // r, k, log_w of chunk c

        // ---- the scan: thread (d, half) over 32 steps, in log2 units ----
        bool slow;              // a diagonal sub-block is formed per (t, i, d)
        float dec = 0.f;        // exp(cum_L) of channel d (the second half)
        {
            const int d = ptid & 63, hf = ptid >> 6;
            float cv[32];
#pragma unroll
            for (int t = 0; t < 32; ++t)
                cv[t] = W[(32 * hf + t) * kL + d] * kLog2e;
#pragma unroll
            for (int t = 1; t < 32; ++t) cv[t] += cv[t - 1];
            if (hf == 0) xs[d] = cv[31];
            // the fall of cum over each of this thread's two sub-chunks
            slow = named_bar_or(2 + w, 128, -cv[15] > kRange
                                || cv[15] - cv[31] > kRange);
            const float off = hf ? xs[d] : 0.f;
#pragma unroll
            for (int t = 0; t < 32; ++t) W[cidx(32 * hf + t, d)] = cv[t] + off;
            named_bar(2 + w, 128);                    // cum written
            // c_j = cum of step 16 j + 15; cum_L = cum of step 63
            const float c0 = W[cidx(15, d)], c1 = W[cidx(31, d)],
                        c2 = W[cidx(47, d)], cl = W[cidx(63, d)];
            if (hf == 0) {
                vec[0 * kL + d] = ex2(c0);        // E_p = exp(c_{p-1})
                vec[1 * kL + d] = ex2(c1);
                vec[2 * kL + d] = ex2(c2);
                vec[3 * kL + d] = ex2(c1 - c0);   // G_pj = exp(c_{p-1} - c_j)
                vec[4 * kL + d] = ex2(c2 - c0);
                vec[5 * kL + d] = ex2(c2 - c1);
                vec[9 * kL + d] = ex2(-c0);       // D_p = exp(c_{p-1} - c_p)
                vec[10 * kL + d] = ex2(c0 - c1);
            } else {
                vec[6 * kL + d] = ex2(cl - c0);   // F_j = exp(cum_L - c_j)
                vec[7 * kL + d] = ex2(cl - c1);
                vec[8 * kL + d] = ex2(cl - c2);
                vec[11 * kL + d] = ex2(c1 - c2);
                vec[12 * kL + d] = ex2(c2 - cl);
                dec = ex2(cl);                    // exp(cum_L)
            }
            named_bar(2 + w, 128);
        }


        // R^ = r exp(cum_{t-1} - c_{p-1}) of fragment f of k-step kk: rows
        // r0 + 8 (f % 2), channels ch, ch + 1
        auto rhat = [&](int kk, int f, int& ch, float& x0, float& x1) {
            const int t = r0 + 8 * (f & 1);
            ch = 16 * kk + 8 * (f >> 1) + cq;
            const float2 rv = bf2(*reinterpret_cast<const uint32_t*>(
                Rb + swz(t, 2 * kk + (f >> 1)) + 2 * cq));
            const float2 cx =
                t > 0 ? *reinterpret_cast<const float2*>(W + cidx(t - 1, ch))
                      : make_float2(0.f, 0.f);
            const float2 ref =
                p > 0 ? *reinterpret_cast<const float2*>(W + cidx(16 * p - 1,
                                                                  ch))
                      : make_float2(0.f, 0.f);
            x0 = rv.x * ex2(cx.x - ref.x);
            x1 = rv.y * ex2(cx.y - ref.y);
        };

        // ---- diagonal sub-block p, where a sub-chunk's cum falls more than
        // kRange, per (t, i, d): lane = channels d, d + 32; pair (t, i) is
        // number t (t - 1) / 2 + i, summed 32 at a time (every loop has a
        // fixed count, so that all of it unrolls and every index is a
        // constant)
        if (slow) {
            const int T0 = 16 * p, d0 = lane, d1 = lane + 32;
            auto cm = [&](int T, int d) { return W[cidx(T, d)]; };
            auto bf = [&](const uint8_t* tile, int T, int d) {
                return bf1(tile + swz(T, d >> 3) + 2 * (d & 7));
            };
            float qv[15][2];    // k_i prod_{i<s<t} w_s
            float part[32];
            float cp0 = cm(T0, d0), cp1 = cm(T0, d1);      // cum_{t-1}
            qv[0][0] = bf(Kb, T0, d0);
            qv[0][1] = bf(Kb, T0, d1);
#pragma unroll
            for (int t = 1; t < 16; ++t) {
                const int T = T0 + t;
                const float rt0 = bf(Rb, T, d0), rt1 = bf(Rb, T, d1);
                const float cm0 = cm(T, d0), cm1 = cm(T, d1);
#pragma unroll
                for (int i = 0; i < 15; ++i) {
                    if (i < t) {
                        const int P = t * (t - 1) / 2 + i;
                        part[P % 32] = rt0 * qv[i][0] + rt1 * qv[i][1];
                        if (P % 32 == 31)
                            dg[dst[P / 32]] = reduce_scatter(part, lane);
                    }
                }
                if (t < 15) {                     // q_i <- q_i w_t
                    const float w0 = ex2(cm0 - cp0), w1 = ex2(cm1 - cp1);
#pragma unroll
                    for (int i = 0; i < 15; ++i) {
                        if (i < t) {
                            qv[i][0] *= w0;
                            qv[i][1] *= w1;
                        }
                    }
                    qv[t][0] = bf(Kb, T, d0);
                    qv[t][1] = bf(Kb, T, d1);
                }
                cp0 = cm0;
                cp1 = cm1;
            }
#pragma unroll
            for (int e = 120 % 32; e < 32; ++e) part[e] = 0.f;
            dg[dst[3]] = reduce_scatter(part, lane);
        }
        __syncwarp();

        // R^, for both rounds below: everything so far reads only chunk c's
        // inputs and this warpgroup's own floats, and runs while the chain
        // still reads output set s (chunk c - 2)
        float xr[4][4][2];                        // R^, both rounds
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                int ch;
                rhat(kk, f, ch, xr[kk][f][0], xr[kk][f][1]);
            }
        if (c >= 2) mbar_wait(empty + 8 * s, ph ^ 1);   // the chain's c - 2
        if (ptid >= 64) decay[s * kL + (ptid & 63)] = dec;

        // ---- the k side: K~ = k exp(c_j - cum_i) (sub-chunk j), kdec = K~
        // exp(cum_L - c_j) (c_3 = cum_L), both split; the bonus sum_d r u k ----
#pragma unroll
        for (int n = 0; n < 4; ++n) {             // row i in sub-chunk n
            const int i = (ptid >> 3) + 16 * n, c8 = ptid & 7;
            const uint32_t off = swz(i, c8);
            const uint4 kv = *reinterpret_cast<const uint4*>(Kb + off);
            const uint4 rv = *reinterpret_cast<const uint4*>(Rb + off);
            const float4* crow = reinterpret_cast<const float4*>(
                W + i * kL + ((c8 ^ (i & 7)) << 3));          // cum_i
            const float4* rrow = reinterpret_cast<const float4*>(
                W + (16 * n + 15) * kL + ((c8 ^ 7) << 3));    // c_n
            const float4 ca[2] = {crow[0], crow[1]}, ra[2] = {rrow[0], rrow[1]};
            const float* cv = reinterpret_cast<const float*>(ca);
            const float* rc = reinterpret_cast<const float*>(ra);
            const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
            const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
            uint32_t th[4], tl[4], dh[4], dl[4];
            float bsum = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 kf = bf2(kw[e]), rf = bf2(rw[e]);
                const float x0 = kf.x * ex2(rc[2 * e] - cv[2 * e]);
                const float x1 = kf.y * ex2(rc[2 * e + 1] - cv[2 * e + 1]);
                bsum += rf.x * us[8 * c8 + 2 * e] * kf.x
                        + rf.y * us[8 * c8 + 2 * e + 1] * kf.y;
                split2(x0, x1, th[e], tl[e]);
                if (n < 3) {
                    const float* F = vec + (6 + n) * kL + 8 * c8 + 2 * e;
                    split2(x0 * F[0], x1 * F[1], dh[e], dl[e]);
                } else {
                    dh[e] = th[e];
                    dl[e] = tl[e];
                }
            }
            *reinterpret_cast<uint4*>(kth + off) =
                make_uint4(th[0], th[1], th[2], th[3]);
            *reinterpret_cast<uint4*>(ktl + off) =
                make_uint4(tl[0], tl[1], tl[2], tl[3]);
            const uint4 kdh = make_uint4(dh[0], dh[1], dh[2], dh[3]),
                        kdl = make_uint4(dl[0], dl[1], dl[2], dl[3]);
            *reinterpret_cast<uint4*>(outp + 2 * kTile + off) = kdh;
            *reinterpret_cast<uint4*>(outp + 3 * kTile + off) = kdl;
            bsum += __shfl_xor_sync(0xffffffffu, bsum, 1);
            bsum += __shfl_xor_sync(0xffffffffu, bsum, 2);
            bsum += __shfl_xor_sync(0xffffffffu, bsum, 4);
            if (c8 == 0) bonus[i] = bsum;
        }
        fence_proxy_async();
        named_bar(2 + w, 128);                        // K~, kdec, bonus written
        // input set s is read: chunk c + 2's loads start here, a round of
        // products and A ahead of their use
        if (ptid == 0 && c + 2 < n_chunks)
            load_in(tm_r, tm_k, tm_w, base, inb, c + 2, h, b);

        // ---- the r side, in fragment layout: r~ = R^ E_p (to shared
        // memory), and A's sub-blocks (p, j), j <= p, as products over two
        // rounds of two column sub-chunks: R~_j = R^ G_pj (j < p; G = 1 for
        // j = p - 1) or R^ D_p (j = p, where no sub-chunk's cum falls more
        // than kRange: at most 2^kRange, against K~ of at least 2^-kRange),
        // zero for rows at or before sub-chunk j; K~ of sub-chunk j ----
        float acc[4][8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            uint32_t fh[2][4][4], fo[2][4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                uint32_t rth[4], rtl[4];
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const int ch = 16 * kk + 8 * (f >> 1) + cq;
                    const float x0 = xr[kk][f][0], x1 = xr[kk][f][1];
                    if (half == 0) {                  // r~ in round 0
                        const float2 E =
                            p > 0 ? *reinterpret_cast<const float2*>(
                                        vec + (p - 1) * kL + ch)
                                  : make_float2(1.f, 1.f);
                        split2(x0 * E.x, x1 * E.y, rth[f], rtl[f]);
                    }
#pragma unroll
                    for (int jj = 0; jj < 2; ++jj) {
                        const int j = 2 * half + jj;
                        const float* gv =
                            vec + (p == j ? 9 + p : p == 2 ? 3 : 4 + j) * kL;
                        const float2 g =
                            p < j || (p == j && slow) ? make_float2(0.f, 0.f)
                            : p == j + 1 ? make_float2(1.f, 1.f)
                            : *reinterpret_cast<const float2*>(gv + ch);
                        split2(x0 * g.x, x1 * g.y, fh[jj][kk][f],
                               fo[jj][kk][f]);
                    }
                }
                if (half == 0) {
                    const uint32_t so = swz(st_row, 2 * kk + lane / 16);
                    stmatrix_x4(out + so, rth);
                    stmatrix_x4(out + kTile + so, rtl);
                }
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[2 * half + jj][e] = 0.f;
            pin<8>(acc[2 * half]);
            pin<8>(acc[2 * half + 1]);
            pin<32>(&fh[0][0][0]);
            pin<32>(&fo[0][0][0]);
            wgmma_fence();
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * half + jj;
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint64_t bh = desc(kthi + 2048 * j + 32 * kk, 16, 1024);
                    const uint64_t bl = desc(ktlo + 2048 * j + 32 * kk, 16, 1024);
                    wgmma_rs<16, 0>(acc[j], fh[jj][kk], bh);
                    wgmma_rs<16, 0>(acc[j], fo[jj][kk], bh);
                    wgmma_rs<16, 0>(acc[j], fh[jj][kk], bl);
                }
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin<8>(acc[2 * half]);
            pin<8>(acc[2 * half + 1]);
        }

        // ---- A, split, into the chunk's A tiles (over K~, once the products
        // have read it): sub-blocks j < p from the products, j = p from them
        // or dg, with the bonus on the diagonal, j > p zero ----
        named_bar(2 + w, 128);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int f = 0; f < 4; ++f) {         // rows + 8 (f % 2), columns
                const int tl = lane / 4 + 8 * (f & 1);   // 16 j + 8 (f / 2) + cq
                const int il = 8 * (f >> 1) + cq;
                const int e = 4 * (f >> 1) + 2 * (f & 1);
                const float* dgr = dg + p * 256 + tl * 16 + il;
                const float a0 = slow ? dgr[0] : acc[j][e];
                const float a1 = slow ? dgr[1] : acc[j][e + 1];
                const float bt = bonus[16 * p + tl];
                const float g0 = il < tl ? a0 : (il == tl ? bt : 0.f);
                const float g1 = il + 1 < tl ? a1 : (il + 1 == tl ? bt : 0.f);
                const float v0 = j < p ? acc[j][e] : j == p ? g0 : 0.f;
                const float v1 = j < p ? acc[j][e + 1] : j == p ? g1 : 0.f;
                split2(v0, v1, ah[f], al[f]);
            }
            const uint32_t so = swz(st_row, 2 * j + lane / 16);
            stmatrix_x4(out + 4 * kTile + so, ah);
            stmatrix_x4(out + 5 * kTile + so, al);
        }
        fence_proxy_async();
        named_bar(2 + w, 128);                        // chunk c's operands are written
        if (ptid == 0) mbar_arrive(full + 8 * s);
    }
}

template <int NV>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_kernel_wgmma(const __grid_constant__ CUtensorMap tm_r,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_o,
                  const float* __restrict__ u, int S, int H, int K) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);  // base, as a plain pointer
    float* const fl = reinterpret_cast<float*>(gb + kOffF);
    // mbarriers: in[2] (r, k, log_w landed), vb[2] (v landed), full[2] (the
    // prep's outputs ready), empty[2] (the chain is done with them)
    const uint32_t bar = base + kOffBar;
    const int b = blockIdx.x / H, h = blockIdx.x % H, n0 = blockIdx.y * NV;
    const int tid = threadIdx.x;
    const int n_chunks = (S + kL - 1) / kL;

    if (tid == 0) {
        for (int i = 0; i < 8; ++i) mbar_init(bar + 8 * i);
        mbar_init_fence();
        for (int c = 0; c < 2 && c < n_chunks; ++c) {
            load_in(&tm_r, &tm_k, &tm_w, base, bar, c, h, b);
            load_v(&tm_v, base, bar + 16, c, h, b);
        }
    }
    if (tid >= 128) {                              // u, zero past K
        const int d = tid - 128;
        if (d < kL) fl[2 * kL + 2 * kPrepF + d] = d < K ? u[h * K + d] : 0.f;
    } else {                                       // S^T hi and lo: zero
        for (int i = tid; i < 2 * kTile / 16; i += 128)
            reinterpret_cast<uint4*>(gb + kOffSt)[i] = make_uint4(0, 0, 0, 0);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid < 128)
        chain<NV>(&tm_v, &tm_o, base, fl, n_chunks, h, b, n0);
    else
        prep(&tm_r, &tm_k, &tm_w, base, gb, fl, n_chunks, h, b);
}

template <int NV>
int launch_form(const CUtensorMap& tr, const CUtensorMap& tk,
                const CUtensorMap& tv, const CUtensorMap& tw,
                const CUtensorMap& to, const float* u, int B, int S, int H,
                int K, cudaStream_t stream) {
    const auto kernel = wkv6_kernel_wgmma<NV>;
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (set != cudaSuccess) return static_cast<int>(set);
    const dim3 grid(B * H, (K + NV - 1) / NV);
    kernel<<<grid, kThreads, kSmem, stream>>>(tr, tk, tv, tw, to, u, S, H, K);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, called by wkv6.cu's entry point: K at most 64; r, k, v bf16
// and log_w f32, each with a contiguous last axis, 16-byte aligned, every
// other stride a multiple of 16 bytes (the wrapper copies what is not);
// strides (in elements) as wkv6_launch takes them; o contiguous (B, S, H, K
// rounded up to 8), 16-byte aligned.  columns: the value columns a block,
// 64 or 32, or 0 for kKeptColumns.  Returns the CUDA error of the launch, or
// -(a CUresult) when a tensor map cannot be made.
int wkv6_wgmma_launch(const void* r, const void* k, const void* v,
                      const void* log_w, const void* u, void* o, int B, int S,
                      int H, int K, const long long* st, int columns,
                      cudaStream_t stream) {
    using u64 = cuuint64_t;
    const int nv = columns == 0 ? kKeptColumns : columns;
    if (nv != 64 && nv != 32) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tr, tk, tv, tw, to;
    const u64 dims[4] = {u64(K), u64(H), u64(S), u64(B)};
    const cuuint32_t box[4] = {64, 1, kL, 1};
    const u64 rs[3] = {u64(st[2]) * 2, u64(st[1]) * 2, u64(st[0]) * 2};
    const u64 ks[3] = {u64(st[5]) * 2, u64(st[4]) * 2, u64(st[3]) * 2};
    const u64 vs[3] = {u64(st[8]) * 2, u64(st[7]) * 2, u64(st[6]) * 2};
    const u64 ws[3] = {u64(st[11]) * 4, u64(st[10]) * 4, u64(st[9]) * 4};
    int err = make_map_bf16(&tr, r, 4, dims, rs, box);
    if (err == 0) err = make_map_bf16(&tk, k, 4, dims, ks, box);
    if (err == 0) err = make_map_bf16(&tv, v, 4, dims, vs, box);
    if (err == 0)
        err = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, log_w, 4, dims,
                       ws, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    // o: contiguous (B, S, H, KO), KO = K rounded up to 8 (the wrapper
    // allocates it so), of which TMA writes the first K columns
    const u64 ob = u64((K + 7) / 8 * 8) * 2;
    const u64 os[3] = {ob, ob * H, ob * H * S};
    const cuuint32_t obox[4] = {cuuint32_t(nv), 1, kL, 1};
    if (err == 0)
        err = make_map(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o, 4, dims, os,
                       obox, nv == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B);
    if (err != 0) return err;
    const float* uf = static_cast<const float*>(u);
    return nv == 64
        ? launch_form<64>(tr, tk, tv, tw, to, uf, B, S, H, K, stream)
        : launch_form<32>(tr, tk, tv, tw, to, uf, B, S, H, K, stream);
}

// the value columns a block of the geometry the bf16 form runs when the
// caller names none
extern "C" int wkv6_kept_columns() { return kKeptColumns; }
