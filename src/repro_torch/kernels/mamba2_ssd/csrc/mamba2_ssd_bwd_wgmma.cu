// mamba2_ssd_bwd_wgmma: the bf16 form of the port's SSD backward, on
// Hopper's tensor cores (wgmma) with TMA loads and stores, chunk-parallel.
// CUDA C++ for sm_90a, built with mamba2_ssd_bwd.cu into one shared library
// (repro_torch/kernels/build.py); mamba2_ssd_bwd.cu's C entry point sends
// every bf16 call here and every f32 call to its own CUDA-core form.
//
// Replaces no pallas_call: the JAX package's gradient of the SSD is XLA's
// autodiff of src/repro/models/mamba2.py::ssd_chunked.  The function is the
// one mamba2_ssd_bwd.cu's header states, under its rules: M's diagonal and
// the last step's dk kdec are left out of dcum, every exponent is <= 0 where
// it is used, the ragged final chunk is masked here (TMA fills rows past S
// with zeros and dt is 0 there; no row past S is written), and x, B and C
// are read through their own strides.  Per chunk c of L = 64 steps and head
// h (cum the chunk's inclusive cumsum of -dt A, kdec_i = dt_i exp(cum_L -
// cum_i), S_c the state entering the chunk, G_c the gradient of the state
// leaving it), following the SSD's own decomposition (Dao and Gu,
// arXiv:2405.21060, section 6):
//
//   1. the state walks, one block per (batch, head, direction): forward,
//      S_{c+1} = exp(cum_L) S_c + (kdec x)^T B; in reverse, G_{c-1} =
//      exp(cum_L) G_c + (exp(cum) dy)^T C; each chunk's S_c or G_c stored
//      as bf16 hi and lo tiles (the carry itself stays f32 in the
//      accumulators).  S_c is stored on the way forward, never recovered
//      from S_{c+1}: the reverse divides by decays that underflow;
//   2. the rest, one block per (batch, chunk, group of 8 heads), all in
//      parallel: G^T = B C^T once, then per head dW^T = x dy^T, dx = W^T dy
//      + kdec_i B G_c^T + D dy, x G_c (dB's state term, times kdec_i),
//      dy S_c (dC's state term, times exp(cum_t)), M's sums, dk and
//      trace(S_c^T G_c) for ddt and dcum, the in-chunk reverse cumsum,
//      ddt and the dA_log and dD partials; dcb and dB's state term summed over the
//      group's heads in shared memory and dC's in registers, then dC +=
//      dcb B and dB += dcb^T C once a group;
//   3. dB and dC summed over the groups, dA_log and dD over the chunks, in a
//      fixed order: no atomics, so two calls give the same bits.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes.  At zamba2's
// training shape (B = 4, S = 2048, H = 80, P = N = 64) the gradient needs
// 32.4 GFLOP of products, 0.033 ms at 989 TFLOP/s, and 0.26 GB of inputs
// and gradients in bf16, 0.078 ms at 3.35 TB/s (chip_smoke.py's
// ssd_bwd_bound).  This form's own traffic is larger: the states and their
// gradients, hi + lo, 168 MB each, are written once and read once, x and
// dy are read twice, and dB's and dC's partials add 42 MB: about 1.1 GB in
// all, 0.34 ms at 3.35 TB/s.  It issues per (batch, chunk) 7 products of
// 64^3 a head and 3 a group (ten a head in mamba2_ssd_bwd.cu), and
// trace(S_c^T G_c) as three more a head, each f32 operand as bf16 hi + lo
// (W, dcb, S_c, G_c) or, in the walks, hi + mid + lo (kdec x and exp(cum)
// dy).  All six splits are needed: with any one rounded to bf16 alone,
// some gradient leaves the bound of 2e-3 + 1e-2 |want|, ddt the most; and
// with the walks' operands as hi + lo, the error they leave in the carried
// G_c reaches ddt through x G_c and left one element of it past the bound
// at B = 2, S = 2048 and 16 of zamba2's heads (tests/test_torch_ssd_bwd.py
// emulates the form's arithmetic on the CPU: test_bf16_form_needs_each_split
// and test_bf16_form_walks_need_three_parts).
//
// What the design does about it:
// - The 32 chunks are a serial chain only in phase 1, whose step is two
//   products and a tile store; phase 2, where the products are, runs
//   every (batch, chunk) at once.  B and C's products are shared by a
//   group's heads.
// - All products run on the tensor cores (wgmma.m64n64k16, bf16 operands,
//   f32 accumulators), the transposed operands read as MN-major tiles:
//   x, dy, B, C, S_c and G_c as TMA wrote them (128-byte swizzled rows).
//   W^T and dW^T are formed in the accumulator layout [i][t], which is the
//   A register layout, so W^T enters its product from registers; dcb^T's
//   sum enters as a tile, K-major for dB and MN-major for dC.
// - dB and dC leave as one f32 partial per (batch, chunk, group), 21 MB each
//   at the training shape, where the CUDA-core form wrote 168 MB each per
//   head.
// - Phase 1 keeps two stages of input tiles and two pairs of staging tiles
//   (about 66 KB: three blocks an SM); phase 2 about 100 KB and 255
//   registers: two blocks an SM, so that one block's loads overlap the
//   other's products.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kL = 64;                  // chunk length: the rows of a tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kTile = kL * kRowBytes;   // one 64 x 64 bf16 tile, 8 KB
constexpr int kPN = 64 * 64;            // one f32 state tile, in floats
constexpr int kGroup = 8;               // heads a phase-3 block
constexpr float kLog2e = 1.4426950408889634f;   // exp(v) = ex2(v kLog2e)

// phase 1: a two-stage ring of A and B tiles, two pairs of staging tiles,
// the scalars of two chunks, two mbarriers
constexpr int kSmemState = 8 * kTile + 2 * 32 * 16 + 16 + 1024;
// phase 2: B, C, x, dy, S hi, S lo, G hi, G lo tiles; the f32 sums of
// dcb^T and of dB's state term; the scalars cum, dt, exp(cum), dec, kdec;
// rows' and columns' sums; three mbarriers
constexpr int kVecs = 5 + 2 + 4 + 2 + 2;     // 64 floats each
constexpr int kSmemChunk =
    8 * kTile + 2 * kPN * 4 + kVecs * 64 * 4 + 32 + 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// the sum of v over the four lanes of a quad (one accumulator row's lanes)
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

// bf16 hi + mid + lo of two f32 values, packed as A fragments: hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), so the three keep
// 24 bits of v
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
    uint32_t rest;
    split2(a, b, hi, rest);
    const float2 h = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi));
    split2(a - h.x, b - h.y, mid, lo);
}

// lane l's two steps 2l and 2l + 1 of the chunk's dt, zero past S
__device__ __forceinline__ void load_dt(const float* dg, long long sds,
                                        int c, int S, int lane, float& d0,
                                        float& d1) {
    const int s = c * kL + 2 * lane;
    d0 = s < S ? dg[static_cast<long long>(s) * sds] : 0.f;
    d1 = s + 1 < S ? dg[static_cast<long long>(s + 1) * sds] : 0.f;
}

// warp 0: lane l's steps' cum (inclusive cumsum of -dt A over the chunk,
// the forward's scan) and the chunk's last cum
__device__ __forceinline__ void chunk_cum(float d0, float d1, float A,
                                          int lane, float& c0, float& c1,
                                          float& cl) {
    const float a0 = -d0 * A, a1 = -d1 * A;
    float v = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    c0 = v - a1;
    c1 = v;
    cl = __shfl_sync(0xffffffffu, v, 31);
}

// a 64 x 64 wgmma accumulator (rows r0 + 8 rr, columns 8 m + cq + e at
// j = 4 m + 2 rr + e) to a row-major f32 tile of 64 columns
__device__ __forceinline__ void store_acc(float* dst, const float* acc,
                                          int r0, int cq) {
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
            *reinterpret_cast<float2*>(dst + (r0 + 8 * rr) * 64 + 8 * m + cq) =
                make_float2(acc[4 * m + 2 * rr], acc[4 * m + 2 * rr + 1]);
}

// the pair of bf16 values at (row, column col, col + 1) of a swizzled tile,
// col even
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int row,
                                            int col) {
    const uint32_t off = swz(row, col / 8) + 2 * (col % 8);
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + off));
}

// ---- phase 1: the state walks -------------------------------------------

// chunk c's A tile (x or dy, one head) and B tile (B or C) into stage n % 2
// of the ring, completing its mbarrier
__device__ __forceinline__ void load_walk(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          uint32_t base, uint32_t bar, int n,
                                          int c, int h, int b) {
    const uint32_t st = base + (n & 1) * 2 * kTile, full = bar + 8 * (n & 1);
    mbar_expect(full, 2 * kTile);
    tma_load(st, ta, full, 0, h, c * kL, b);            // (P, H, S, B)
    tma_load(st + kTile, tb, full, 0, c * kL, b);       // (N, S, B)
}

// warp 0: a chunk's scalars from its dt, lane l holding steps 2l and
// 2l + 1, as one float4 a lane: {exp(cum), kdec} of both steps
__device__ __forceinline__ void walk_scalars(float4* sc, float d0, float d1,
                                             float A, int lane) {
    float c0, c1, cl;
    chunk_cum(d0, d1, A, lane, c0, c1, cl);
    sc[lane] = make_float4(ex2(c0 * kLog2e), ex2(c1 * kLog2e),
                           d0 * ex2((cl - c0) * kLog2e),
                           d1 * ex2((cl - c1) * kLog2e));
}

// one block per (head, batch, walk).  Walk 0 goes forward over x and B
// and stores the state entering each chunk, S_{c+1} = exp(cum_L) S_c +
// (kdec x)^T B; walk 1 goes in reverse over dy and C and stores the
// gradient of the state leaving each chunk, G_{c-1} = exp(cum_L) G_c +
// (exp(cum) dy)^T C.  The carried value lives in the warpgroup's
// accumulators (f32) for the whole walk, as the forward's S does; each
// chunk's is stored as bf16 hi and lo tiles by TMA from two staging tiles,
// double-buffered.  The walk's last chunk takes no update.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                           const __grid_constant__ CUtensorMap tm_dy,
                           const __grid_constant__ CUtensorMap tm_b,
                           const __grid_constant__ CUtensorMap tm_c,
                           const __grid_constant__ CUtensorMap tm_s,
                           const __grid_constant__ CUtensorMap tm_g,
                           const float* __restrict__ dt,
                           const float* __restrict__ A_log, int S, int H,
                           long long sdb, long long sds, long long sdh) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);
    // stage s: A tile at base + 2 kTile s, B tile after it; staging tiles
    // of chunk n: hi at kOut + 2 kTile (n % 2), lo after it
    constexpr uint32_t kOut = 4 * kTile;
    float4* const scal = reinterpret_cast<float4*>(gb + 8 * kTile);
    const uint32_t bar = base + 8 * kTile + 2 * 32 * 16;

    const int h = blockIdx.x, b = blockIdx.y;
    const bool rev = blockIdx.z != 0;
    const CUtensorMap* ta = rev ? &tm_dy : &tm_x;
    const CUtensorMap* tb = rev ? &tm_c : &tm_b;
    const CUtensorMap* tout = rev ? &tm_g : &tm_s;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int st_row = warp * 16 + 8 * (lane / 8 % 2) + lane % 8;
    const int cq = 2 * (lane % 4);
    const float A = expf(A_log[h]);
    const float* dg = dt + b * sdb + h * sdh;
    const int nc = (S + kL - 1) / kL;
    auto chunk = [&](int n) { return rev ? nc - 1 - n : n; };

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        mbar_init_fence();
        for (int n = 0; n < 2 && n < nc; ++n)
            load_walk(ta, tb, base, bar, n, chunk(n), h, b);
    }
    float nd0 = 0.f, nd1 = 0.f;               // warp 0: the next chunk's dt
    if (warp == 0) {
        float d0, d1;
        load_dt(dg, sds, chunk(0), S, lane, d0, d1);
        walk_scalars(scal, d0, d1, A, lane);
        if (nc > 1) load_dt(dg, sds, chunk(1), S, lane, nd0, nd1);
    }
    float st[32];                             // the carry, accumulator layout
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    __syncthreads();

    for (int n = 0; n < nc; ++n) {
        const int s = n & 1, c = chunk(n);
        const uint32_t sa = base + 2 * kTile * s, sb = sa + kTile;
        const uint32_t out = base + kOut + 2 * kTile * s;
        const float4* sc = scal + 32 * s;

        // the carry at the chunk's boundary, split, into staging tiles s
        // (chunk n - 2's store from them has read them)
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                split2(st[4 * m + 2 * j], st[4 * m + 2 * j + 1], hi[j], lo[j]);
            const uint32_t off = swz(st_row, m + lane / 16);
            stmatrix_x4(out + off, hi);
            stmatrix_x4(out + kTile + off, lo);
        }

        mbar_wait(bar + 8 * s, (n >> 1) & 1);
        if (n + 1 < nc) {
            // carry = exp(cum_L) carry + (w a)^T b, w = kdec (walk 0) or
            // exp(cum) (walk 1) on the A tile's rows: A fragments from the
            // tile read transposed (ldmatrix.trans), split into hi + mid +
            // lo (hi + lo left ddt past its bound: the header)
            const float decay = sc[31].y;     // exp(cum_L)
            uint32_t ahi[4][4], amid[4][4], alo[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int mq = lane / 8;
                uint32_t ar[4];
                ldmatrix_x4_trans(ar, sa + swz(16 * kk + 8 * (mq / 2)
                                               + lane % 8,
                                               2 * warp + mq % 2));
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const float4 k = sc[(16 * kk + 8 * (f / 2) + cq) / 2];
                    const float2 av = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(&ar[f]));
                    const float w0 = rev ? k.x : k.z, w1 = rev ? k.y : k.w;
                    split3(w0 * av.x, w1 * av.y, ahi[kk][f], amid[kk][f],
                           alo[kk][f]);
                }
            }
#pragma unroll
            for (int j = 0; j < 32; ++j) st[j] *= decay;
            pin<32>(st);
            pin<16>(&ahi[0][0]);
            pin<16>(&amid[0][0]);
            pin<16>(&alo[0][0]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint64_t bk = desc(sb + 16 * kRowBytes * kk, kTile,
                                         1024);
                wgmma_rs<64, 1>(st, ahi[kk], bk);
                wgmma_rs<64, 1>(st, amid[kk], bk);
                wgmma_rs<64, 1>(st, alo[kk], bk);
            }
            wgmma_commit();
            if (warp == 0) {                  // the next chunk's scalars
                walk_scalars(scal + 32 * (s ^ 1), nd0, nd1, A, lane);
                if (n + 2 < nc)
                    load_dt(dg, sds, chunk(n + 2), S, lane, nd0, nd1);
            }
            wgmma_wait<0>();
            pin<32>(st);
        }
        fence_proxy_async();
        if (tid == 0) bulk_wait_read();       // chunk n - 1's store has read
        __syncthreads();                      // stage s and staging s done
        if (tid == 0) {
            const int ti = static_cast<int>((static_cast<size_t>(b) * nc + c)
                                            * H + h);
            tma_store(tout, out, 0, 0, 0, ti);
            tma_store(tout, out + kTile, 0, 0, 1, ti);
            bulk_commit();
            if (n + 2 < nc) load_walk(ta, tb, base, bar, n + 2, chunk(n + 2),
                                      h, b);
        }
    }
    if (tid == 0) bulk_wait();
}

// ---- phase 2: the rest ---------------------------------------------------

// one block per (head group, chunk, batch): see the header
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_kernel_wgmma(
        const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_dy,
        const __grid_constant__ CUtensorMap tm_b,
        const __grid_constant__ CUtensorMap tm_c,
        const __grid_constant__ CUtensorMap tm_s,
        const __grid_constant__ CUtensorMap tm_g,
        const float* __restrict__ dt, const float* __restrict__ A_log,
        const float* __restrict__ Dv, __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ dBp, float* __restrict__ dCp,
        float* __restrict__ dAp, float* __restrict__ dDp, int S, int H, int P,
        long long sdb, long long sds, long long sdh) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);
    // tiles: B, C, x, dy, S hi, S lo, G hi, G lo
    const uint32_t tB = base, tC = base + kTile, tX = base + 2 * kTile,
                   tY = base + 3 * kTile, tSh = base + 4 * kTile,
                   tSl = base + 5 * kTile, tGh = base + 6 * kTile,
                   tGl = base + 7 * kTile;
    const uint8_t* const pC = gb + kTile;
    const uint8_t* const pX = gb + 2 * kTile;
    const uint8_t* const pY = gb + 3 * kTile;
    // thread-owned f32 sums in the accumulator layout, [j][tid]: dcb^T
    // over the heads, and dB's state term
    float* const dcb = reinterpret_cast<float*>(gb + 8 * kTile);
    float* const dBs = dcb + kPN;
    float* const v_cum = dBs + kPN;
    float* const v_dt = v_cum + 64;
    float* const v_ecum = v_dt + 64;       // exp(cum_t)
    float* const v_dec = v_ecum + 64;      // exp(cum_L - cum_i)
    float* const v_kdec = v_dec + 64;      // dt_i exp(cum_L - cum_i)
    float* const v_rowi = v_kdec + 64;     // sum_{t >= i} M[t][i]
    float* const v_rowe = v_rowi + 64;     // sum_{t > i} M[t][i]
    float* const v_col = v_rowe + 64;      // [warp][t]: sum_{i < t} M dt_i
    float* const v_dk = v_col + 4 * 64;    // dk_i
    float* const v_dcs = v_dk + 64;        // the y_state part of dcum_t
    float* const v_red = v_dcs + 64;       // dD's partial a warp
    float* const v_gs = v_red + 64;        // sum(G_c * S_c)'s a warp
    // mbarriers: B and C; each head's x and dy; its S and G tiles
    const uint32_t bar = smem_u32(v_gs + 64);

    const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int nc = gridDim.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;
    const int rows[2] = {r0, r0 + 8};
    const int st_row = warp * 16 + 8 * (lane / 8 % 2) + lane % 8;
    const int cq = 2 * (lane % 4);
    const int h0 = g * kGroup, h1 = min(H, h0 + kGroup);
    const int s0 = c * kL;

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        mbar_init(bar + 16);
        mbar_init_fence();
        mbar_expect(bar, 2 * kTile);
        tma_load(tB, &tm_b, bar, 0, s0, b);
        tma_load(tC, &tm_c, bar, 0, s0, b);
    }
    for (int j = 0; j < 32; ++j) dcb[j * kThreads + tid] = 0.f;
    for (int j = 0; j < 32; ++j) dBs[j * kThreads + tid] = 0.f;
    float dCa[32], gt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) dCa[j] = gt[j] = 0.f;
    __syncthreads();
    mbar_wait(bar, 0);

    // G^T = B C^T, [i][t], shared by the group's heads
    pin<32>(gt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 0, 0>(gt, desc(tB + 32 * kk, 16, 1024),
                           desc(tC + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    pin<32>(gt);

    for (int h = h0; h < h1; ++h) {
        const int k = h - h0;
        const size_t ti = (static_cast<size_t>(b) * nc + c) * H + h;
        if (tid == 0) {
            const uint32_t hb = bar + 8, sgb = bar + 16;
            mbar_expect(hb, 2 * kTile);
            tma_load(tX, &tm_x, hb, 0, h, s0, b);
            tma_load(tY, &tm_dy, hb, 0, h, s0, b);
            mbar_expect(sgb, 4 * kTile);
            tma_load(tSh, &tm_s, sgb, 0, 0, 0, static_cast<int>(ti));
            tma_load(tSl, &tm_s, sgb, 0, 0, 1, static_cast<int>(ti));
            tma_load(tGh, &tm_g, sgb, 0, 0, 0, static_cast<int>(ti));
            tma_load(tGl, &tm_g, sgb, 0, 0, 1, static_cast<int>(ti));
        }
        const float A = expf(A_log[h]);
        if (warp == 0) {
            float d0, d1, c0, c1, cl;
            load_dt(dt + b * sdb + h * sdh, sds, c, S, lane, d0, d1);
            chunk_cum(d0, d1, A, lane, c0, c1, cl);
            const float e0 = ex2((cl - c0) * kLog2e),
                        e1 = ex2((cl - c1) * kLog2e);
            v_cum[2 * lane] = c0;
            v_cum[2 * lane + 1] = c1;
            v_dt[2 * lane] = d0;
            v_dt[2 * lane + 1] = d1;
            v_ecum[2 * lane] = ex2(c0 * kLog2e);
            v_ecum[2 * lane + 1] = ex2(c1 * kLog2e);
            v_dec[2 * lane] = e0;
            v_dec[2 * lane + 1] = e1;
            v_kdec[2 * lane] = d0 * e0;
            v_kdec[2 * lane + 1] = d1 * e1;
        }
        __syncthreads();
        mbar_wait(bar + 8, k & 1);

        // (a) dW^T = x dy^T, [i][t]
        float dw[32], acc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) dw[j] = acc[j] = 0.f;
        pin<32>(dw);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64, 0, 0>(dw, desc(tX + 32 * kk, 16, 1024),
                               desc(tY + 32 * kk, 16, 1024));
        wgmma_commit();

        // W^T[i][t] = exp(cum_t - cum_i) G^T[i][t] dt_i (t >= i) as A
        // fragments, split into hi + lo
        const float cum_i[2] = {v_cum[r0], v_cum[r0 + 8]};
        const float dt_i[2] = {v_dt[r0], v_dt[r0 + 8]};
        uint32_t whi[4][4], wlo[4][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int t = 8 * m + cq;
            const float ct0 = v_cum[t], ct1 = v_cum[t + 1];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int j = 4 * m + 2 * rr, i = rows[rr];
                const float w0 = t >= i ? ex2((ct0 - cum_i[rr]) * kLog2e)
                                          * gt[j] * dt_i[rr] : 0.f;
                const float w1 = t + 1 >= i
                                     ? ex2((ct1 - cum_i[rr]) * kLog2e)
                                       * gt[j + 1] * dt_i[rr]
                                     : 0.f;
                split2(w0, w1, whi[m / 2][2 * (m % 2) + rr],
                       wlo[m / 2][2 * (m % 2) + rr]);
            }
        }

        // (b) dx = W^T dy, dy the MN-major operand
        pin<32>(acc);
        pin<16>(&whi[0][0]);
        pin<16>(&wlo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t yk = desc(tY + 16 * kRowBytes * kk, kTile, 1024);
            wgmma_rs<64, 1>(acc, whi[kk], yk);
            wgmma_rs<64, 1>(acc, wlo[kk], yk);
        }
        wgmma_commit();

        // dcb^T and M^T from dW^T once (a) is done: dcb summed over the
        // heads; M's row sums (ddt, dcum_i) and its columns' sums weighted
        // by dt_i (dcum_t)
        wgmma_wait<1>();
        pin<32>(dw);
        {
            float ri[2] = {0.f, 0.f}, re[2] = {0.f, 0.f};
            float col[16];
#pragma unroll
            for (int m = 0; m < 8; ++m) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int t = 8 * m + cq + e;
                    const float ct = v_cum[t];
                    float cs = 0.f;
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr) {
                        const int j = 4 * m + 2 * rr + e, i = rows[rr];
                        const float ex = t >= i
                            ? ex2((ct - cum_i[rr]) * kLog2e) : 0.f;
                        const float dd = dw[j] * ex;
                        dcb[j * kThreads + tid] += dd * dt_i[rr];
                        const float mm = dd * gt[j];
                        ri[rr] += mm;
                        if (t > i) {
                            re[rr] += mm;
                            cs += mm * dt_i[rr];
                        }
                    }
                    col[2 * m + e] = cs;
                }
            }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                ri[rr] = quad_sum(ri[rr]);
                re[rr] = quad_sum(re[rr]);
            }
            if (lane % 4 == 0) {
                v_rowi[r0] = ri[0];
                v_rowi[r0 + 8] = ri[1];
                v_rowe[r0] = re[0];
                v_rowe[r0 + 8] = re[1];
            }
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                float v = col[q];
                v += __shfl_xor_sync(0xffffffffu, v, 4);
                v += __shfl_xor_sync(0xffffffffu, v, 8);
                v += __shfl_xor_sync(0xffffffffu, v, 16);
                col[q] = v;
            }
            if (lane < 4) {
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    v_col[warp * 64 + 8 * m + cq] = col[2 * m];
                    v_col[warp * 64 + 8 * m + cq + 1] = col[2 * m + 1];
                }
            }
        }

        // (c) B G^T once (b) is done and the state tiles have landed; then
        // dx = acc + kdec_i (B G^T) + D dy, dk_i = x_i . (B G^T)_i, and dD's
        // share
        wgmma_wait<0>();
        pin<32>(acc);
        mbar_wait(bar + 16, k & 1);
        float bg[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) bg[j] = 0.f;
        pin<32>(bg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bk = desc(tB + 32 * kk, 16, 1024);
            wgmma_ss<64, 0, 0>(bg, bk, desc(tGh + 32 * kk, 16, 1024));
            wgmma_ss<64, 0, 0>(bg, bk, desc(tGl + 32 * kk, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(bg);
        const float Dh = Dv[h];
        float dd = 0.f;
        {
            float dk[2] = {0.f, 0.f};
            const float kd[2] = {v_kdec[r0], v_kdec[r0 + 8]};
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int i = rows[rr];
                const int s = s0 + i;
                __nv_bfloat16* row =
                    dx + (static_cast<size_t>(b) * S + s) * H * P
                    + static_cast<size_t>(h) * P;
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const int j = 4 * m + 2 * rr, p = 8 * m + cq;
                    const float2 yv = tile_pair(pY, i, p);
                    const float2 xv = tile_pair(pX, i, p);
                    dk[rr] += xv.x * bg[j] + xv.y * bg[j + 1];
                    dd += yv.x * xv.x + yv.y * xv.y;
                    const float o0 = acc[j] + kd[rr] * bg[j] + Dh * yv.x;
                    const float o1 = acc[j + 1] + kd[rr] * bg[j + 1]
                                     + Dh * yv.y;
                    if (s < S) {
                        if (p + 1 < P && (P & 1) == 0) {
                            *reinterpret_cast<__nv_bfloat162*>(row + p) =
                                __floats2bfloat162_rn(o0, o1);
                        } else {
                            if (p < P) row[p] = __float2bfloat16(o0);
                            if (p + 1 < P) row[p + 1] = __float2bfloat16(o1);
                        }
                    }
                }
                dk[rr] = quad_sum(dk[rr]);
            }
            if (lane % 4 == 0) {
                v_dk[r0] = dk[0];
                v_dk[r0 + 8] = dk[1];
            }
        }

        // (d) x G (dB's state term) and (e) dy S_c (dC's), G and S the
        // MN-major operands
        float xg[32], ys[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) xg[j] = ys[j] = 0.f;
        pin<32>(xg);
        pin<32>(ys);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t xk = desc(tX + 32 * kk, 16, 1024);
            wgmma_ss<64, 0, 1>(xg, xk,
                               desc(tGh + 16 * kRowBytes * kk, kTile, 1024));
            wgmma_ss<64, 0, 1>(xg, xk,
                               desc(tGl + 16 * kRowBytes * kk, kTile, 1024));
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t yk = desc(tY + 32 * kk, 16, 1024);
            wgmma_ss<64, 0, 1>(ys, yk,
                               desc(tSh + 16 * kRowBytes * kk, kTile, 1024));
            wgmma_ss<64, 0, 1>(ys, yk,
                               desc(tSl + 16 * kRowBytes * kk, kTile, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();
        pin<32>(xg);
        {
            const float kd[2] = {v_kdec[r0], v_kdec[r0 + 8]};
#pragma unroll
            for (int j = 0; j < 32; ++j)
                dBs[j * kThreads + tid] += kd[(j / 2) % 2] * xg[j];
        }
        wgmma_wait<0>();
        pin<32>(ys);
        {
            const float et[2] = {v_ecum[r0], v_ecum[r0 + 8]};
            float part[2] = {0.f, 0.f};
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    const int j = 4 * m + 2 * rr;
                    const float v0 = et[rr] * ys[j], v1 = et[rr] * ys[j + 1];
                    dCa[j] += v0;
                    dCa[j + 1] += v1;
                    const float2 cv = tile_pair(pC, rows[rr], 8 * m + cq);
                    part[rr] += cv.x * v0 + cv.y * v1;
                }
            part[0] = quad_sum(part[0]);
            part[1] = quad_sum(part[1]);
            if (lane % 4 == 0) {
                v_dcs[r0] = part[0];
                v_dcs[r0 + 8] = part[1];
            }
        }
        // sum(G_c * S_c) = trace(S_c^T G_c): S^T the MN-major A, G the
        // MN-major B, hi + lo of each (lo lo left out); each thread holds
        // at most two of the diagonal
        {
            float tr[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) tr[j] = 0.f;
            pin<32>(tr);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint32_t o = 16 * kRowBytes * kk;
                const uint64_t sh = desc(tSh + o, kTile, 1024),
                               sl = desc(tSl + o, kTile, 1024),
                               gh = desc(tGh + o, kTile, 1024),
                               gl = desc(tGl + o, kTile, 1024);
                wgmma_ss<64, 1, 1>(tr, sh, gh);
                wgmma_ss<64, 1, 1>(tr, sh, gl);
                wgmma_ss<64, 1, 1>(tr, sl, gh);
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin<32>(tr);
            float part = 0.f;
#pragma unroll
            for (int m = 0; m < 8; ++m)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (8 * m + cq + e == rows[rr])
                            part += tr[4 * m + 2 * rr + e];
            part = warp_sum(part);
            if (lane == 0) v_gs[warp] = part;
        }
        dd = warp_sum(dd);
        if (lane == 0) v_red[warp] = dd;
        __syncthreads();

        // warp 0: dcum, its reverse cumsum dla, ddt and the dA_log and dD
        // partials; lane l holds steps 2l and 2l + 1
        if (warp == 0) {
            float dc[2], kdk = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int t = 2 * lane + j;
                const float kk = t < kL - 1 ? v_dk[t] * v_kdec[t] : 0.f;
                dc[j] = v_dcs[t] + v_col[t] + v_col[64 + t] + v_col[128 + t]
                        + v_col[192 + t] - v_dt[t] * v_rowe[t] - kk;
                kdk += kk;
            }
            kdk = warp_sum(kdk);
            if (lane == 31)
                dc[1] += kdk + v_ecum[kL - 1]
                               * (v_gs[0] + v_gs[1] + v_gs[2] + v_gs[3]);
            float v = dc[0] + dc[1];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float u = __shfl_down_sync(0xffffffffu, v, o);
                if (lane + o < 32) v += u;
            }
            const float dla[2] = {v, v - dc[0]};
            float da = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int t = 2 * lane + j;
                da += dla[j] * (-v_dt[t] * A);
                if (s0 + t < S)
                    ddt[(static_cast<size_t>(b) * S + s0 + t) * H + h] =
                        v_rowi[t] + v_dk[t] * v_dec[t] - A * dla[j];
            }
            da = warp_sum(da);
            if (lane == 0) {
                dAp[ti] = da;
                dDp[ti] = v_red[0] + v_red[1] + v_red[2] + v_red[3];
            }
        }
        __syncthreads();              // this head's tiles and sums are read
    }

    // dcb^T's sum as bf16 hi and lo tiles [i][t] over x's and dy's tiles
    {
        float v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = dcb[j * kThreads + tid];
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                split2(v[4 * m + 2 * j], v[4 * m + 2 * j + 1], hi[j], lo[j]);
            const uint32_t off = swz(st_row, m + lane / 16);
            stmatrix_x4(tX + off, hi);
            stmatrix_x4(tY + off, lo);
        }
    }
    fence_proxy_async();
    __syncthreads();
    // dB += dcb^T C (dcb^T K-major, C MN-major); dC += dcb B (dcb the
    // MN-major A, B MN-major)
    float dBa[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) dBa[j] = dBs[j * kThreads + tid];
    pin<32>(dBa);
    pin<32>(dCa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t ck = desc(tC + 16 * kRowBytes * kk, kTile, 1024);
        wgmma_ss<64, 0, 1>(dBa, desc(tX + 32 * kk, 16, 1024), ck);
        wgmma_ss<64, 0, 1>(dBa, desc(tY + 32 * kk, 16, 1024), ck);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bk = desc(tB + 16 * kRowBytes * kk, kTile, 1024);
        wgmma_ss<64, 1, 1>(dCa, desc(tX + 16 * kRowBytes * kk, kTile, 1024),
                           bk);
        wgmma_ss<64, 1, 1>(dCa, desc(tY + 16 * kRowBytes * kk, kTile, 1024),
                           bk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin<32>(dBa);
    pin<32>(dCa);
    const size_t part = ((static_cast<size_t>(b) * nc + c) * gridDim.x + g)
                        * kPN;
    store_acc(dBp + part, dBa, r0, cq);
    store_acc(dCp + part, dCa, r0, cq);
}

// ---- phase 3: the sums across blocks --------------------------------------

// dB and dC (B, S, N) in bf16: the groups' partials summed in order
__global__ void __launch_bounds__(256)
ssd_bwd_sum_bc_kernel(const float* __restrict__ dBp,
                      const float* __restrict__ dCp,
                      __nv_bfloat16* __restrict__ dB,
                      __nv_bfloat16* __restrict__ dC, int S, int N, int nc,
                      int G, long long total) {
    const float* src = blockIdx.y ? dCp : dBp;
    __nv_bfloat16* dst = blockIdx.y ? dC : dB;
    const long long SN = static_cast<long long>(S) * N;
    for (long long o = blockIdx.x * 256LL + threadIdx.x; o < total;
         o += static_cast<long long>(gridDim.x) * 256) {
        const long long b = o / SN, r = o % SN;
        const int s = static_cast<int>(r / N), n = static_cast<int>(r % N);
        const float* p = src + ((b * nc + s / kL) * G) * kPN
                         + (s % kL) * 64 + n;
        float v = 0.f;
        for (int g = 0; g < G; ++g) v += p[static_cast<size_t>(g) * kPN];
        dst[o] = __float2bfloat16(v);
    }
}

// dA_log and dD (H,): the (batch, chunk) partials summed in a fixed order,
// one warp a head (lane l the partials l, l + 32, ..., then a fixed tree)
__global__ void __launch_bounds__(256)
ssd_bwd_sum_h_kernel(const float* __restrict__ dAp,
                     const float* __restrict__ dDp, float* __restrict__ dA,
                     float* __restrict__ dD, int H, int count) {
    const int h = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
    if (h >= H) return;
    float a = 0.f, d = 0.f;
    for (int k = lane; k < count; k += 32) {
        a += dAp[static_cast<size_t>(k) * H + h];
        d += dDp[static_cast<size_t>(k) * H + h];
    }
    a = warp_sum(a);
    d = warp_sum(d);
    if (lane == 0) {
        dA[h] = a;
        dD[h] = d;
    }
}

// the scratch's parts, in floats: the two state tiles a (batch, chunk,
// head), the dB and dC partials a (batch, chunk, group), then exp(cum_L)
// and the dA_log and dD partials a (batch, chunk, head)
struct Scratch {
    float *s, *g, *dA, *dD, *dB, *dC;
};

Scratch carve(float* p, int B, int nc, int H) {
    const long long tiles = static_cast<long long>(B) * nc * H;
    const long long parts =
        static_cast<long long>(B) * nc * ((H + kGroup - 1) / kGroup) * kPN;
    Scratch s;
    s.s = p;
    s.g = s.s + tiles * kPN;
    s.dB = s.g + tiles * kPN;
    s.dC = s.dB + parts;
    s.dA = s.dC + parts;
    s.dD = s.dA + tiles;
    return s;
}

}  // namespace

// The f32 scratch (in floats) the bf16 form needs for these sizes.
long long mamba2_ssd_bwd_wgmma_scratch_floats(int B, int S, int H) {
    const long long nc = (S + kL - 1) / kL;
    const long long tiles = B * nc * H;
    const long long parts = B * nc * ((H + kGroup - 1) / kGroup) * kPN;
    return 2 * tiles * kPN + 2 * parts + 2 * tiles;
}

// The bf16 form, called by mamba2_ssd_bwd.cu's entry point: P and N at most
// 64; x, B, C and dy bf16 with a contiguous last axis, 16-byte aligned,
// every other stride a multiple of 8 elements (the wrapper copies what is
// not); strides as mamba2_ssd_bwd_launch takes them; dx contiguous (B, S, H,
// P) bf16, dB and dC contiguous (B, S, N) bf16; ddt, dA_log, dD f32.
// Returns the CUDA error of a launch, or -(a CUresult) when a tensor map
// cannot be made.
int mamba2_ssd_bwd_wgmma_launch(const void* x, const void* dt,
                                const void* A_log, const void* Bm,
                                const void* Cm, const void* D, const void* dy,
                                void* dx, void* ddt, void* dA_log, void* dB,
                                void* dC, void* dD, void* scratch, int B,
                                int S, int H, int P, int N,
                                const long long* st, cudaStream_t stream) {
    using u64 = cuuint64_t;
    const int nc = (S + kL - 1) / kL;
    const int G = (H + kGroup - 1) / kGroup;
    const Scratch sc = carve(static_cast<float*>(scratch), B, nc, H);
    CUtensorMap tx, ty, tb, tc, ts, tg;
    const u64 xd[4] = {u64(P), u64(H), u64(S), u64(B)};
    const u64 xs[3] = {u64(st[2]) * 2, u64(st[1]) * 2, u64(st[0]) * 2};
    const u64 ys[3] = {u64(st[12]) * 2, u64(st[11]) * 2, u64(st[10]) * 2};
    const cuuint32_t xbox[4] = {64, 1, kL, 1};
    const u64 nd[3] = {u64(N), u64(S), u64(B)};
    const u64 bs[2] = {u64(st[7]) * 2, u64(st[6]) * 2};
    const u64 cs[2] = {u64(st[9]) * 2, u64(st[8]) * 2};
    const cuuint32_t nbox[3] = {64, kL, 1};
    // a state scratch: per (batch, chunk, head) a hi tile, then a lo tile,
    // each 64 rows of 64 bf16 columns
    const u64 sd[4] = {64, kL, 2, u64(B) * nc * H};
    const u64 ss[3] = {kRowBytes, kTile, u64(kPN) * 4};
    const cuuint32_t sbox[4] = {64, kL, 1, 1};
    int err = make_map_bf16(&tx, x, 4, xd, xs, xbox);
    if (err == 0) err = make_map_bf16(&ty, dy, 4, xd, ys, xbox);
    if (err == 0) err = make_map_bf16(&tb, Bm, 3, nd, bs, nbox);
    if (err == 0) err = make_map_bf16(&tc, Cm, 3, nd, cs, nbox);
    if (err == 0) err = make_map_bf16(&ts, sc.s, 4, sd, ss, sbox);
    if (err == 0) err = make_map_bf16(&tg, sc.g, 4, sd, ss, sbox);
    if (err != 0) return err;
    cudaError_t set = cudaFuncSetAttribute(
        ssd_bwd_state_kernel_wgmma,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemState);
    if (set == cudaSuccess)
        set = cudaFuncSetAttribute(
            ssd_bwd_chunk_kernel_wgmma,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemChunk);
    if (set != cudaSuccess) return static_cast<int>(set);
    const float* dtf = static_cast<const float*>(dt);
    const float* Af = static_cast<const float*>(A_log);

    ssd_bwd_state_kernel_wgmma<<<dim3(H, B, 2), kThreads, kSmemState,
                                 stream>>>(tx, ty, tb, tc, ts, tg, dtf, Af, S,
                                           H, st[3], st[4], st[5]);
    int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    ssd_bwd_chunk_kernel_wgmma<<<dim3(G, nc, B), kThreads, kSmemChunk,
                                 stream>>>(
        tx, ty, tb, tc, ts, tg, dtf, Af, static_cast<const float*>(D),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), sc.dB,
        sc.dC, sc.dA, sc.dD, S, H, P, st[3], st[4], st[5]);
    if ((e = static_cast<int>(cudaGetLastError()))) return e;
    const long long total = static_cast<long long>(B) * S * N;
    const int blocks = static_cast<int>(
        total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
    ssd_bwd_sum_bc_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(
        sc.dB, sc.dC, static_cast<__nv_bfloat16*>(dB),
        static_cast<__nv_bfloat16*>(dC), S, N, nc, G, total);
    if ((e = static_cast<int>(cudaGetLastError()))) return e;
    ssd_bwd_sum_h_kernel<<<(H + 7) / 8, 256, 0, stream>>>(
        sc.dA, sc.dD, static_cast<float*>(dA_log), static_cast<float*>(dD), H,
        B * nc);
    return static_cast<int>(cudaGetLastError());
}
