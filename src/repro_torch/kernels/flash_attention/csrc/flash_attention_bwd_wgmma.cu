// flash_attention_bwd_wgmma: the bf16 form of the port's flash-attention
// backward, on Hopper's tensor cores (wgmma) with TMA loads.  CUDA C++ for
// sm_90a, built with flash_attention_bwd.cu into one shared library
// (repro_torch/kernels/build.py); flash_attention_bwd.cu's C entry point
// sends every bf16 call here and every f32 call to its own CUDA-core passes.
//
// Replaces, for bf16, what the JAX package computes with XLA's autodiff of
// src/repro/models/layers.py::blockwise_attention (the Pallas kernel has no
// backward).  The function is the one flash_attention_bwd.cu's header
// states: with s = q . k / sqrt(D) under the forward's mask (causal, window,
// prefix_len) and P = exp(s - lse),
//   Drow = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - Drow),
//   dQ = dS K / sqrt(D),    dK = dS^T Q / sqrt(D),    dV = P^T dO,
// every product accumulated in f32, dQ, dK and dV written once in bf16
// (rounded to nearest even), GQA reduced in registers with no atomics, so
// that two calls give the same bits.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): operations.  The
// algorithm needs 10 D flops a kept (query, key) pair: at h2o-danube-1.8b's
// training shape (B 4, S 2048, 32 query and 8 KV heads of 80, causal) 214.9
// GFLOP, 0.217 ms at 989 TFLOP/s, against 0.063 ms for its inputs and
// outputs at 3.35 TB/s.  This form does 20 D flops a pair (below), whose own
// floor there is 0.43 ms.
//
// What the design does about it:
// - Three passes, as the CUDA-core form: (1) Drow, and lse in log2 units,
//   one warp a row, into (B, H, Sq_pad) f32 buffers padded to 128 rows
//   (padding: Drow 0, lse 1e30, so that P = 0 there); (2) dK and dV of one
//   (batch, KV head, tile of keys); (3) dQ of one (batch, head, 128 query
//   rows).  Pass 2 and 3 both recompute S, P and dP: 4 D flops a pair each.
// - Pass 2 computes the *transposed* scores of its keys: S^T = K Q^T and
//   dP^T = V dO^T are wgmmas with K (or V) the K-major A operand and Q (or
//   dO) the K-major B operand, both from shared memory.  P^T and dS^T then
//   lie in the accumulator layout, which is the register layout of a wgmma
//   A operand, so dV += P^T dO and dK += dS^T Q take them from registers,
//   with dO and Q the MN-major B operand (the descriptor's transpose bit,
//   as the forward's V).  One block of two warpgroups: up to D = 128 each
//   warpgroup owns 64 keys (128 a block) and keeps their dK and dV in
//   registers across the group's query heads and the query tiles that see
//   its keys (the forward's tile range seen from the key side: from the
//   tile's first key when causal, unless the tile starts inside the prefix;
//   before its last key + window); above D = 128 both warpgroups own the
//   same 64 keys, one keeping dV (S^T only) and the other dK (S^T and
//   dP^T), so that neither holds more than 128 accumulators a thread.
//   Thread 0 loads K and V once and streams Q, dO and the two row vectors
//   of each query tile (kBQ = 64 rows up to D = 96, 32 above, for
//   registers) through a two-stage ring with TMA, each stage completing an
//   mbarrier.
// - Pass 3 is the forward's shape: two warpgroups of 64 query rows, Q and
//   dO loaded once, K and V tiles (128 keys up to D = 128, 32 above) through
//   a two-stage ring; S = Q K^T and dP = dO V^T from shared memory, dS in
//   registers, dQ += dS K with K the MN-major B operand.
// - In both passes the two warpgroups stay in step, one barrier a tile.
//   Two variants measured slower at danube's shape (PERF.md §6): a
//   three-stage ring with per-stage empty barriers that let the
//   warpgroups drift apart (pass 3), and tiles worked in halves, one
//   half's P and dS formed while the other's products run (both passes:
//   the halves' N = 32 products read their A operand twice as often).
// - P and dS are split.  A bf16 P or dS keeps 8 bits, and at the main
//   path's shape a P (into dV) or a dS (into dK and dQ) rounded once puts
//   outputs outside the bound the kernel is held to (2e-3 + 1e-2 |want|
//   against the plain f32 arithmetic: tests/test_torch_flash_attention_bwd
//   .py's emulation of these roundings).  So each is split into bf16 hi +
//   lo, two wgmmas where one would do: dV, dK and dQ cost 4 D flops a pair
//   each, 20 D in all where 10 D would do.
// - Tiles outside the causal diagonal (and past the prefix) or the window
//   are skipped, per block and then per warpgroup; the per-element mask is
//   applied only on tiles that cross the diagonal (and are not wholly
//   inside the prefix), the window's edge or Skv.  TMA fills rows past Sq
//   or Skv and columns past D with zeros; rows past Sq get P = 0 from the
//   padded lse, and keys past Skv are masked.
// - exp2 with scale * log2(e) folded into the scores and log2(e) into lse
//   once, in pass 1 (the wgmma forward writes lse in natural-log units).
// - D is padded to DP, a multiple of 16 (the k-step), up to 256; the
//   register-A products' output columns go in wgmma pieces of 128 and one
//   of the rest (at D = 80 one piece of 80, not 64 and 16), each starting
//   at a 64-column box.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kThreads = 256;     // two warpgroups
constexpr int kRows3 = 128;       // pass 3: query rows a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse = 1e30f;  // lse past Sq: exp2(s - it) is 0

template <int DP>
struct Tiles {
    static constexpr int kChunks = (DP + 63) / 64;        // 64-column boxes
    // pass 2
    static constexpr bool kSplit = DP > 128;   // one warpgroup dV, one dK
    static constexpr int kKeys = kSplit ? 64 : 128;       // keys a block
    static constexpr int kBQ = DP <= 96 ? 64 : 32;        // rows a q tile
    static constexpr int kKBytes = kChunks * kKeys * kRowBytes;   // K or V
    static constexpr int kQBytes = kChunks * kBQ * kRowBytes;     // Q or dO
    static constexpr int kVecBytes = kBQ * 4;             // lse or Drow
    // K, V, then Q and dO of two stages, lse and Drow of two stages, then
    // three mbarriers; +1024 to align
    static constexpr int kSmem2 =
        2 * kKBytes + 4 * kQBytes + 4 * kVecBytes + 64 + 1024;
    // pass 3
    static constexpr int kBK = DP <= 128 ? 128 : 32;      // keys a tile
    static constexpr int kQ3Bytes = kChunks * kRows3 * kRowBytes;
    static constexpr int kKV3Bytes = kChunks * kBK * kRowBytes;
    // Q, dO, then K and V of two stages, then three mbarriers
    static constexpr int kSmem3 = 2 * kQ3Bytes + 4 * kKV3Bytes + 64 + 1024;
};

// acc (64 x DP) += A (registers) B over one 16-deep k-step, B the MN-major
// operand whose k-step starts at row b of box 0 (boxes of kTileRows rows);
// the DP output columns in wgmma pieces of 128 (two boxes) and one of the
// rest (up to 112 columns, a piece that may end inside its second box)
template <int DP, int kTileRows>
__device__ __forceinline__ void mn_step(float* acc, const uint32_t* a,
                                        uint32_t b) {
    constexpr uint32_t kBox = kTileRows * kRowBytes;
    constexpr int n128 = DP / 128 * 128;
#pragma unroll
    for (int n0 = 0; n0 < n128; n0 += 128)
        wgmma_rs<128, 1>(acc + n0 / 2, a,
                         desc(b + n0 / 64 * kBox, kBox, 1024));
    if constexpr (DP > n128)
        wgmma_rs<DP - n128, 1>(acc + n128 / 2, a,
                               desc(b + n128 / 64 * kBox, kBox, 1024));
}

// acc (64 x N) += A B^T over DP: A 64 rows from a (row 0 of box 0, boxes of
// kARows rows), B N rows from b (boxes of N rows), both K-major
template <int DP, int N, int kARows>
__device__ __forceinline__ void ss_product(float* acc, uint32_t a,
                                           uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t kc = (kk % 4) * 32;       // 16 columns
        wgmma_ss<N, 0, 0>(acc,
                          desc(a + kk / 4 * (kARows * kRowBytes) + kc, 16,
                               1024),
                          desc(b + kk / 4 * (N * kRowBytes) + kc, 16, 1024));
    }
}

// an accumulator of N columns as bf16 hi and lo A fragments, N / 16 k-steps
template <int N>
__device__ __forceinline__ void fragments(const float* x, uint32_t (*hi)[4],
                                          uint32_t (*lo)[4]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
            // fragment f: columns + 8 (f / 2), row + 8 (f % 2)
            const int j = 4 * (2 * kk + f / 2) + 2 * (f % 2);
            split2(x[j], x[j + 1], hi[kk][f], lo[kk][f]);
        }
}

__device__ __forceinline__ bool kept(int qp, int kp, int Skv, int causal,
                                     int window, int prefix_len) {
    bool keep = kp < Skv;
    if (causal) keep = keep && (qp >= kp || kp < prefix_len);
    if (window > 0) keep = keep && qp - kp < window;
    return keep;
}

// pass 1: Drow = rowsum(dO o O) and lse in log2 units, one warp a row of
// the (B, H, Sq_pad) buffers; rows past Sq get 0 and kPadLse
__global__ void __launch_bounds__(kThreads)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, int B, int Sq, int Sq_pad, int H,
                int D) {
    const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32)
                       + threadIdx.x / 32;
    if (row >= static_cast<size_t>(B) * H * Sq_pad) return;
    const int lane = threadIdx.x % 32;
    const size_t bh = row / Sq_pad;
    const int sq = static_cast<int>(row % Sq_pad);
    if (sq >= Sq) {
        if (lane == 0) {
            delta[row] = 0.f;
            lse2[row] = kPadLse;
        }
        return;
    }
    const size_t b = bh / H, h = bh % H;
    const size_t off = ((b * Sq + sq) * H + h) * D;     // D is even
    const __nv_bfloat162* op =
        reinterpret_cast<const __nv_bfloat162*>(o + off);
    const __nv_bfloat162* gp =
        reinterpret_cast<const __nv_bfloat162*>(dout + off);
    float s = 0.f;
    for (int d = lane; d < D / 2; d += 32) {
        const float2 x = __bfloat1622float2(op[d]);
        const float2 g = __bfloat1622float2(gp[d]);
        s = fmaf(x.x, g.x, s);
        s = fmaf(x.y, g.y, s);
    }
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off2);
    if (lane == 0) {
        delta[row] = s;
        lse2[row] = lse[bh * Sq + sq] * kLog2e;
    }
}

// pass 2's query tile i (rows q0 .., head h): Q, dO, lse, Drow into stage
// i % 2, completing its mbarrier
template <int DP>
__device__ __forceinline__ void load_q_tile(
    const CUtensorMap* tq, const CUtensorMap* tg, const CUtensorMap* tl,
    const CUtensorMap* td, uint32_t sQ, uint32_t sG, uint32_t sL,
    uint32_t sD, uint32_t bar, int i, int q0, int h, int b) {
    using T = Tiles<DP>;
    const int s = i & 1;
    const uint32_t full = bar + 8 + 8 * s;
    mbar_expect(full, 2 * T::kQBytes + 2 * T::kVecBytes);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
        const uint32_t off = s * T::kQBytes + c * T::kBQ * kRowBytes;
        tma_load(sQ + off, tq, full, c * 64, h, q0, b);
        tma_load(sG + off, tg, full, c * 64, h, q0, b);
    }
    tma_load(sL + s * T::kVecBytes, tl, full, q0, h, b);
    tma_load(sD + s * T::kVecBytes, td, full, q0, h, b);
}

// pass 2, one query tile for one warpgroup: S^T (and dP^T) of its 64 keys
// against the tile's rows, P^T (and dS^T), then dV += P^T dO (kDV) and
// dK += dS^T Q (kDK); aK / aV: the warpgroup's first key row in box 0 of
// K / V; q, g: the stage's Q and dO tiles; ls, ds: its lse and Drow
template <int DP, bool kDV, bool kDK>
__device__ __forceinline__ void dkdv_tile(
    float* accV, float* accK, uint32_t aK, uint32_t aV, uint32_t q,
    uint32_t g, const float* ls, const float* ds, int kw0, int q0, int row0,
    int lane, bool edge, int Skv, int causal, int window, int prefix_len,
    float scale_log2) {
    using T = Tiles<DP>;
    constexpr int BQ = T::kBQ;
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.f;
    pin<BQ / 2>(st);
    if constexpr (kDK) pin<BQ / 2>(dpt);
    wgmma_fence();
    ss_product<DP, BQ, T::kKeys>(st, aK, q);
    wgmma_commit();
    if constexpr (kDK) {
        ss_product<DP, BQ, T::kKeys>(dpt, aV, g);
        wgmma_commit();
        wgmma_wait<1>();
    } else {
        wgmma_wait<0>();
    }
    pin<BQ / 2>(st);

    // P^T: rows are keys, columns queries; masked on an edge tile
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) {
        const int col = j / 4 * 8 + (lane % 4) * 2 + j % 2;
        float p = exp2f(st[j] * scale_log2 - ls[col]);
        if (edge) {
            const int kp = kw0 + row0 + 8 * ((j / 2) % 2);
            p = kept(q0 + col, kp, Skv, causal, window, prefix_len) ? p
                                                                    : 0.f;
        }
        st[j] = p;
    }
    uint32_t phi[BQ / 16][4], plo[BQ / 16][4];
    if constexpr (kDV) fragments<BQ>(st, phi, plo);
    uint32_t shi[BQ / 16][4], slo[BQ / 16][4];
    if constexpr (kDK) {
        wgmma_wait<0>();
        pin<BQ / 2>(dpt);
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
            const int col = j / 4 * 8 + (lane % 4) * 2 + j % 2;
            dpt[j] = st[j] * (dpt[j] - ds[col]);
        }
        fragments<BQ>(dpt, shi, slo);
    }

    // dV += (P_hi + P_lo)^T dO, dK += (dS_hi + dS_lo)^T Q
    if constexpr (kDV) {
        pin<DP / 2>(accV);
        pin<BQ / 4>(&phi[0][0]);
        pin<BQ / 4>(&plo[0][0]);
    }
    if constexpr (kDK) {
        pin<DP / 2>(accK);
        pin<BQ / 4>(&shi[0][0]);
        pin<BQ / 4>(&slo[0][0]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
        if constexpr (kDV) {
            mn_step<DP, BQ>(accV, phi[kk], g + kk * 16 * kRowBytes);
            mn_step<DP, BQ>(accV, plo[kk], g + kk * 16 * kRowBytes);
        }
        if constexpr (kDK) {
            mn_step<DP, BQ>(accK, shi[kk], q + kk * 16 * kRowBytes);
            mn_step<DP, BQ>(accK, slo[kk], q + kk * 16 * kRowBytes);
        }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDV) pin<DP / 2>(accV);
    if constexpr (kDK) pin<DP / 2>(accK);
}

// a warpgroup's 64 rows of an accumulator (64 x DP) times `mul`, rounded to
// bf16, into rows r0 .. of a (B, S, heads, D) tensor at (b, ., head, 0);
// rows past S and columns past D left out
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float* acc, float mul,
                                           int r0, int row0, int lane,
                                           int b, int S, int heads, int head,
                                           int D) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int sp = r0 + row0 + 8 * r;
        if (sp >= S) continue;
        __nv_bfloat16* orow =
            out + ((static_cast<size_t>(b) * S + sp) * heads + head) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
            const int d = j * 8 + (lane % 4) * 2;
            if (d < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul,
                                          acc[4 * j + 2 * r + 1] * mul);
        }
    }
}

// pass 2: dK and dV of one (batch, KV head, tile of kKeys keys)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_g,
                      const __grid_constant__ CUtensorMap tm_l,
                      const __grid_constant__ CUtensorMap tm_d,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int H,
                      int KV, int D, int causal, int window, int prefix_len,
                      float scale_log2, float scale) {
    using T = Tiles<DP>;
    constexpr int BQ = T::kBQ;
    extern __shared__ uint8_t smem_raw[];
    // the swizzle's pattern repeats every 1024 bytes: align the tiles to it
    const uint32_t base = smem_u32(smem_raw);
    const uint32_t sK = (base + 1023) & ~1023u;
    const uint32_t sV = sK + T::kKBytes;
    const uint32_t sQ = sV + T::kKBytes;          // stage s: + s * kQBytes
    const uint32_t sG = sQ + 2 * T::kQBytes;      // dO
    const uint32_t sL = sG + 2 * T::kQBytes;      // stage s: + s * kVecBytes
    const uint32_t sD = sL + 2 * T::kVecBytes;    // Drow
    const uint32_t bar = sD + 2 * T::kVecBytes;   // K and V, stage 0, 1
    const float* pL = reinterpret_cast<const float*>(smem_raw + (sL - base));
    const float* pD = reinterpret_cast<const float*>(smem_raw + (sD - base));

    const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
    const int k0 = blockIdx.y * T::kKeys;         // longest walks first
    const int G = H / KV;
    const int tid = threadIdx.x;
    const int wg = tid / 128, lane = tid % 32;
    const int kw0 = T::kSplit ? k0 : k0 + wg * 64;   // this warpgroup's keys
    const int row0 = (tid % 128) / 32 * 16 + lane / 4;   // and + 8

    // the query rows that see a key of this tile
    int q_lo = 0, q_hi = Sq;
    if (causal && k0 >= prefix_len) q_lo = min(k0, Sq);
    if (window > 0) q_hi = min(Sq, min(k0 + T::kKeys, Skv) - 1 + window);
    const int qt_lo = q_lo / BQ;
    const int n_qt = max(0, (q_hi + BQ - 1) / BQ - qt_lo);
    const int n_tiles = G * n_qt;

    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
        mbar_init_fence();
        mbar_expect(bar, 2 * T::kKBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
            const uint32_t off = c * T::kKeys * kRowBytes;
            tma_load(sK + off, &tm_k, bar, c * 64, kvh, k0, b);
            tma_load(sV + off, &tm_v, bar, c * 64, kvh, k0, b);
        }
        for (int i = 0; i < 2 && i < n_tiles; ++i)
            load_q_tile<DP>(&tm_q, &tm_g, &tm_l, &tm_d, sQ, sG, sL, sD, bar,
                            i, (qt_lo + i % n_qt) * BQ, kvh * G + i / n_qt,
                            b);
    }
    __syncthreads();

    constexpr int kAcc = T::kSplit ? 1 : 2;       // dK and dV, or one
    float acc[kAcc][DP / 2];
#pragma unroll
    for (int a = 0; a < kAcc; ++a)
#pragma unroll
        for (int j = 0; j < DP / 2; ++j) acc[a][j] = 0.f;
    const uint32_t aK = sK + (kw0 - k0) * kRowBytes;
    const uint32_t aV = sV + (kw0 - k0) * kRowBytes;
    mbar_wait(bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1, q0 = (qt_lo + i % n_qt) * BQ;
        mbar_wait(bar + 8 + 8 * s, (i >> 1) & 1);
        // does this warpgroup's key see any row of the tile?
        bool live = kw0 < Skv;
        if (causal) live = live && (q0 + BQ - 1 >= kw0 || kw0 < prefix_len);
        if (window > 0) live = live && q0 - (kw0 + 63) < window;
        if (live) {
            const bool edge =
                kw0 + 64 > Skv
                || (causal && kw0 + 63 > q0 && kw0 + 64 > prefix_len)
                || (window > 0 && q0 + BQ - 1 - kw0 >= window);
            const uint32_t q = sQ + s * T::kQBytes, g = sG + s * T::kQBytes;
            const float* ls = pL + s * BQ;
            const float* ds = pD + s * BQ;
            if constexpr (!T::kSplit) {
                dkdv_tile<DP, true, true>(acc[1], acc[0], aK, aV, q, g, ls,
                                          ds, kw0, q0, row0, lane, edge, Skv,
                                          causal, window, prefix_len,
                                          scale_log2);
            } else if (wg == 0) {
                dkdv_tile<DP, true, false>(acc[0], nullptr, aK, aV, q, g, ls,
                                           ds, kw0, q0, row0, lane, edge,
                                           Skv, causal, window, prefix_len,
                                           scale_log2);
            } else {
                dkdv_tile<DP, false, true>(nullptr, acc[0], aK, aV, q, g, ls,
                                           ds, kw0, q0, row0, lane, edge,
                                           Skv, causal, window, prefix_len,
                                           scale_log2);
            }
        }
        __syncthreads();              // both warpgroups are done with stage s
        if (tid == 0 && i + 2 < n_tiles)
            load_q_tile<DP>(&tm_q, &tm_g, &tm_l, &tm_d, sQ, sG, sL, sD, bar,
                            i + 2, (qt_lo + (i + 2) % n_qt) * BQ,
                            kvh * G + (i + 2) / n_qt, b);
    }

    if constexpr (!T::kSplit) {
        store_rows<DP>(dk, acc[0], scale, kw0, row0, lane, b, Skv, KV, kvh,
                       D);
        store_rows<DP>(dv, acc[1], 1.f, kw0, row0, lane, b, Skv, KV, kvh, D);
    } else {
        store_rows<DP>(wg == 0 ? dv : dk, acc[0], wg == 0 ? 1.f : scale, kw0,
                       row0, lane, b, Skv, KV, kvh, D);
    }
}

// pass 3's K and V of tile i (keys k0 ..) into stage i % 2
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sK,
                                        uint32_t sV, uint32_t bar, int i,
                                        int k0, int kvh, int b) {
    using T = Tiles<DP>;
    const int s = i & 1;
    const uint32_t full = bar + 8 + 8 * s;
    mbar_expect(full, 2 * T::kKV3Bytes);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
        const uint32_t off = s * T::kKV3Bytes + c * T::kBK * kRowBytes;
        tma_load(sK + off, tk, full, c * 64, kvh, k0, b);
        tma_load(sV + off, tv, full, c * 64, kvh, k0, b);
    }
}

// pass 3: dQ of one (batch, head, 128 query rows)
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_g,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
                    int KV, int D, int Sq_pad, int causal, int window,
                    int prefix_len, float scale_log2, float scale) {
    using T = Tiles<DP>;
    constexpr int kBK = T::kBK;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sG = sQ + T::kQ3Bytes;         // dO
    const uint32_t sK = sG + T::kQ3Bytes;         // stage s: + s * kKV3Bytes
    const uint32_t sV = sK + 2 * T::kKV3Bytes;
    const uint32_t bar = sV + 2 * T::kKV3Bytes;   // Q and dO, stage 0, 1

    const int bh = blockIdx.x;
    const int qb = gridDim.y - 1 - blockIdx.y;    // longest walks first
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int q0 = qb * kRows3;
    const int tid = threadIdx.x;
    const int wg = tid / 128, lane = tid % 32;
    const int qw0 = q0 + wg * 64;                 // this warpgroup's rows
    const int row0 = (tid % 128) / 32 * 16 + lane / 4;   // and + 8

    // the KV tiles the forward's rows see: up to the diagonal, every tile
    // that holds a key of the prefix, from the window's first key
    const int n_kv = (Skv + kBK - 1) / kBK;
    int kv_hi = n_kv;
    if (causal)
        kv_hi = min(n_kv, max((min(q0 + kRows3, Sq) - 1) / kBK + 1,
                              (prefix_len + kBK - 1) / kBK));
    int kv_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / kBK;
    const int n_tiles = kv_hi - kv_lo;

    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
        mbar_init_fence();
        mbar_expect(bar, 2 * T::kQ3Bytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
            const uint32_t off = c * kRows3 * kRowBytes;
            tma_load(sQ + off, &tm_q, bar, c * 64, h, q0, b);
            tma_load(sG + off, &tm_g, bar, c * 64, h, q0, b);
        }
        for (int i = 0; i < 2 && i < n_tiles; ++i)
            load_kv<DP>(&tm_k, &tm_v, sK, sV, bar, i, (kv_lo + i) * kBK, kvh,
                        b);
    }
    // the thread's two rows' lse (log2 units) and Drow; the buffers are
    // padded to Sq_pad >= q0 + 128 rows
    float l2[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const size_t at = static_cast<size_t>(bh) * Sq_pad + qw0 + row0
                          + 8 * r;
        l2[r] = lse2[at];
        dr[r] = delta[at];
    }
    __syncthreads();

    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
    mbar_wait(bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1, k0 = (kv_lo + i) * kBK;
        mbar_wait(bar + 8 + 8 * s, (i >> 1) & 1);
        // does this warpgroup see any key of the tile?
        bool live = qw0 < Sq;
        if (causal) live = live && (k0 <= qw0 + 63 || k0 < prefix_len);
        if (window > 0) live = live && qw0 - (k0 + kBK - 1) < window;
        if (live) {
            const uint32_t kt = sK + s * T::kKV3Bytes;
            const uint32_t vt = sV + s * T::kKV3Bytes;
            // S = Q K^T, dP = dO V^T
            float sc[kBK / 2], dp[kBK / 2];
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j) sc[j] = dp[j] = 0.f;
            pin<kBK / 2>(sc);
            pin<kBK / 2>(dp);
            wgmma_fence();
            ss_product<DP, kBK, kRows3>(sc, sQ + wg * 64 * kRowBytes, kt);
            wgmma_commit();
            ss_product<DP, kBK, kRows3>(dp, sG + wg * 64 * kRowBytes, vt);
            wgmma_commit();
            wgmma_wait<1>();
            pin<kBK / 2>(sc);

            // P; masked only on a tile that crosses the diagonal and is not
            // wholly inside the prefix, the window's edge or Skv
            const bool edge = k0 + kBK > Skv
                              || (causal && k0 + kBK - 1 > qw0
                                  && k0 + kBK > prefix_len)
                              || (window > 0 && qw0 + 63 - k0 >= window);
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j) {
                const int r = (j / 2) % 2;
                float p = exp2f(sc[j] * scale_log2 - l2[r]);
                if (edge) {
                    const int qp = qw0 + row0 + 8 * r;
                    const int kp = k0 + j / 4 * 8 + (lane % 4) * 2 + j % 2;
                    p = kept(qp, kp, Skv, causal, window, prefix_len) ? p
                                                                      : 0.f;
                }
                sc[j] = p;
            }
            // dS = P (dP - Drow), split into A fragments
            wgmma_wait<0>();
            pin<kBK / 2>(dp);
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j)
                dp[j] = sc[j] * (dp[j] - dr[(j / 2) % 2]);
            uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
            fragments<kBK>(dp, hi, lo);

            // dQ += (dS_hi + dS_lo) K
            pin<DP / 2>(acc);
            pin<kBK / 4>(&hi[0][0]);
            pin<kBK / 4>(&lo[0][0]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                mn_step<DP, kBK>(acc, hi[kk], kt + kk * 16 * kRowBytes);
                mn_step<DP, kBK>(acc, lo[kk], kt + kk * 16 * kRowBytes);
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin<DP / 2>(acc);
        }
        __syncthreads();              // both warpgroups are done with stage s
        if (tid == 0 && i + 2 < n_tiles)
            load_kv<DP>(&tm_k, &tm_v, sK, sV, bar, i + 2, k0 + 2 * kBK, kvh,
                        b);
    }

    store_rows<DP>(dq, acc, scale, qw0, row0, lane, b, Sq, H, h, D);
}

// the map of a (B, S, heads, D) bf16 tensor as (D, heads, S, B), boxes of
// 64 columns x rows rows of one head, 128-byte swizzled, zero-filled past
// the edges; 0 or -(the CUresult) (-1 without the encoder)
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, int rows) {
    const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
    const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
    return make_map_bf16(map, ptr, 4, dims, strides, box);
}

// the map of an f32 (B, H, S_pad) row vector as (S_pad, H, B), boxes of
// `rows` entries
int make_vec_map(CUtensorMap* map, const float* ptr, int B, int H, int S_pad,
                 int rows) {
    const cuuint64_t row = static_cast<cuuint64_t>(S_pad) * 4;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(S_pad),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {row, row * H};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(rows), 1, 1};
    return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ptr, 3,
                            dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
           int causal, int window, int prefix_len, float scale,
           cudaStream_t stream) {
    using T = Tiles<DP>;
    const int Sq_pad = (Sq + kRows3 - 1) / kRows3 * kRows3;
    float* lse2 = scratch;
    float* delta = scratch + static_cast<size_t>(B) * H * Sq_pad;
    const size_t rows = static_cast<size_t>(B) * H * Sq_pad;
    bwd_prep_kernel<<<static_cast<unsigned>((rows + kThreads / 32 - 1)
                                            / (kThreads / 32)),
                      kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, B, Sq,
        Sq_pad, H, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);

    CUtensorMap tq2, tg2, tk2, tv2, tl, td, tq3, tg3, tk3, tv3;
    int err = make_map(&tq2, q, B, Sq, H, D, T::kBQ);
    if (err == 0) err = make_map(&tg2, dout, B, Sq, H, D, T::kBQ);
    if (err == 0) err = make_map(&tk2, k, B, Skv, KV, D, T::kKeys);
    if (err == 0) err = make_map(&tv2, v, B, Skv, KV, D, T::kKeys);
    if (err == 0) err = make_vec_map(&tl, lse2, B, H, Sq_pad, T::kBQ);
    if (err == 0) err = make_vec_map(&td, delta, B, H, Sq_pad, T::kBQ);
    if (err == 0) err = make_map(&tq3, q, B, Sq, H, D, kRows3);
    if (err == 0) err = make_map(&tg3, dout, B, Sq, H, D, kRows3);
    if (err == 0) err = make_map(&tk3, k, B, Skv, KV, D, T::kBK);
    if (err == 0) err = make_map(&tv3, v, B, Skv, KV, D, T::kBK);
    if (err != 0) return err;
    const float scale_log2 = scale * kLog2e;

    e = cudaFuncSetAttribute(bwd_dkdv_kernel_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem2);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd_dkdv_kernel_wgmma<DP>
        <<<dim3(B * KV, (Skv + T::kKeys - 1) / T::kKeys), kThreads,
           T::kSmem2, stream>>>(tq2, tk2, tv2, tg2, tl, td,
                                static_cast<__nv_bfloat16*>(dk),
                                static_cast<__nv_bfloat16*>(dv), Sq, Skv, H,
                                KV, D, causal, window, prefix_len,
                                scale_log2, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);

    e = cudaFuncSetAttribute(bwd_dq_kernel_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem3);
    if (e != cudaSuccess) return static_cast<int>(e);
    bwd_dq_kernel_wgmma<DP>
        <<<dim3(B * H, Sq_pad / kRows3), kThreads, T::kSmem3, stream>>>(
            tq3, tk3, tv3, tg3, lse2, delta, static_cast<__nv_bfloat16*>(dq),
            Sq, Skv, H, KV, D, Sq_pad, causal, window, prefix_len,
            scale_log2, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, called by flash_attention_bwd.cu's entry point: D a
// multiple of 8 up to 256 (the wrapper pads it; `scale` is the caller's
// 1/sqrt(D)), tensors contiguous and 16-byte aligned; `scratch` an f32
// buffer of 2 B H Sq_pad floats, Sq_pad = Sq rounded up to 128.  Returns
// the CUDA error of the first launch refused, or -(a CUresult) when a
// tensor map cannot be made.
int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, int prefix_len, float scale, cudaStream_t s) {
#define FA_BWD_WGMMA_CASE(N)                                                 \
    case N:                                                                  \
        return launch<16 * N>(q, k, v, o, dout, lse, scratch, dq, dk, dv, B, \
                              Sq, Skv, H, KV, D, causal, window, prefix_len, \
                              scale, s);
    switch ((D + 15) / 16) {
        FA_BWD_WGMMA_CASE(1) FA_BWD_WGMMA_CASE(2) FA_BWD_WGMMA_CASE(3)
        FA_BWD_WGMMA_CASE(4) FA_BWD_WGMMA_CASE(5) FA_BWD_WGMMA_CASE(6)
        FA_BWD_WGMMA_CASE(7) FA_BWD_WGMMA_CASE(8) FA_BWD_WGMMA_CASE(9)
        FA_BWD_WGMMA_CASE(10) FA_BWD_WGMMA_CASE(11) FA_BWD_WGMMA_CASE(12)
        FA_BWD_WGMMA_CASE(13) FA_BWD_WGMMA_CASE(14) FA_BWD_WGMMA_CASE(15)
        FA_BWD_WGMMA_CASE(16)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FA_BWD_WGMMA_CASE
}
