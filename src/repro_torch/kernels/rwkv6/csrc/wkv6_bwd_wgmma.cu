// wkv6_bwd_wgmma: the bf16 form of the port's RWKV-6 WKV backward, on
// Hopper's tensor cores (wgmma) with TMA loads and stores, chunk-parallel.
// CUDA C++ for sm_90a, built with wkv6_bwd.cu into one shared library
// (repro_torch/kernels/build.py); wkv6_bwd.cu's C entry point sends every
// bf16 call here and every f32 call to its own CUDA-core form.
//
// Replaces no pallas_call: the JAX package's gradient of the WKV is XLA's
// autodiff of src/repro/models/rwkv6.py::wkv6_chunked.  The function is the
// one wkv6_bwd.cu's header states, under its rules (the last step's kdec
// dkdec is left out of dcum_L both times, every exponent is <= 0 where it
// is used, the ragged final chunk is masked: TMA fills rows past S with
// zeros and log_w = 0 there, no row past S is written; r, k, v and log_w
// are read through their own strides), over chunks of L = 64 steps.  Per
// chunk c and head h (cum the chunk's inclusive cumsum of log_w, cum_ex =
// cum - log_w, S_c the state entering the chunk, G_c the gradient of the
// state leaving it):
//
//   1. the state walks, one block per (head, batch, direction): forward,
//      S_{c+1} = diag(exp(cum_L)) S_c + kdec^T v; in reverse, G_{c-1} =
//      diag(exp(cum_L)) G_c + (r exp(cum_ex))^T do; each chunk's S_c or G_c
//      stored in f32 (the carry itself stays f32 in the accumulators);
//   2. the rest, one block per (head, chunk, batch), all in parallel, of two
//      warpgroups: both form the chunk's scan, vectors and operand tiles;
//      then warpgroup 0 forms A^T, dv = A^T do + kdec G_c (the bonus on A's
//      diagonal) and dk's state term from v G_c^T, and warpgroup 1 dr (do
//      S_c^T and the sum over E) and dk (the sum over E), with dcum_ex and
//      dcum; then both the in-chunk reverse scans that give dlog_w, and
//      du's partial;
//   3. du summed over the (batch, chunk) partials in a fixed order: no
//      atomics, so two calls give the same bits.
//
// The sums over E use the forward's sub-chunk factorisation (wkv6_wgmma.cu):
// with sub-chunks of 16 steps, c_j the cum at the end of sub-chunk j (c_{-1}
// = 0), Ks_i = exp(c_j - cum_i) for i in sub-chunk j and Rs_t = exp(cum_ex_t
// - c_{p-1}) for t in sub-chunk p (both <= 1), and Gv[p][j] = exp(c_{p-1} -
// c_j) (<= 1 for j < p):
//   dr_t  = Rs_t (exp(c_{p-1}) (do S_c^T)_t
//                 + sum_j Gv[p][j] (dA[:, j] K~_j)_t),
//   dk_i  = Ks_i sum_p Gv[p][j] (dA[p, :]^T R^_p)_i + ...,
//   A^T[i][t in p] = (k_i Ks_i Gv[p][j]) . R^_t,
// with K~ = k Ks and R^ = r Rs, over j < p; the diagonal sub-block j = p is
// a product too where no sub-chunk's cum falls more than kRange (then Gv[p][p]
// <= 2^kRange bounds the other factors from below), decided per (batch, head,
// chunk) over all its channels.  Where one falls further (log_w at the
// model's clamp of -8 falls 185 in log2 units over 16 steps) the chunk's
// diagonal sub-blocks of A, dr and dk are formed per (t, i, d) instead, one
// warp a sub-block and a channel a lane (two: d and d + 32), with a running
// product along t of the steps' decays (each at most 1).  So any log_w <= 0
// is taken.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes.  At rwkv6-1.6b's
// training shape (B = 4, S = 2048, H = 32, K = 64) the gradient needs about
// 13.5 GFLOP of products (chip_smoke.py's wkv_bwd_bound), 0.014 ms at 989
// TFLOP/s, against 0.37 GB of inputs and gradients, 0.11 ms at 3.35 TB/s.
// This form's own traffic is larger: S_c and G_c in f32, 67 MB each, are
// written once and read once, and r, k, v, do and log_w are read twice (the
// walks and the rest): about 0.9 GB, 0.27 ms at 3.35 TB/s.
//
// What the design does about it:
// - The 32 chunks are a serial chain only in phase 1, whose step is one
//   product of 64 x 64 x 64 (three wgmma groups of four) and a scan; phase 2,
//   where the products are, runs every (batch, chunk, head) at once.
// - Every product runs on the tensor cores (wgmma, bf16 operands, f32
//   accumulators); an f32 operand enters as bf16 parts, a product of two
//   split operands as the part products above 2^-24.  The parts are what the
//   bound needs (tests/test_torch_wkv_bwd.py emulates the form on the CPU):
//   the walks' operands (kdec, r exp(cum_ex)) and the E sums' (dA, R^, K~)
//   in three parts (hi + mid + lo), since dlog_w is a difference of dcum and
//   dcum_ex whose terms cancel (two parts left dlog_w past the bound on slow
//   decays); A, A^T's weighted K~ and kdec in two; S_c and G_c stored in
//   f32 and split into three where they enter a product.
// - dA, dA^T and A^T are formed in the accumulator layout, which is the A
//   register layout, so they enter their products from registers; K~, R^
//   and the states' parts are tiles in shared memory, read K-major or
//   MN-major as each product needs.
// - Phase 1 keeps two stages of input tiles (about 65 KB: three blocks an
//   SM) and scans the next chunk while the current chunk's product runs.
// - Phase 2 holds about 220 KB (the inputs, cum, S_c and G_c in f32 and as
//   three tiles each, K~ and R^ as three tiles each, three f32 staging
//   tiles, dv's output tile), one block an SM, so its two warpgroups split
//   the work to overlap their products and waits (tools/wkv_bwd_phases.py
//   prints SM clocks by phase): warpgroup 0 forms dk's state term first and
//   signals it with a non-blocking bar.arrive, so that warpgroup 1 never
//   waits for it.  dr, dk and dv leave as bf16 tiles by TMA store, dr's and
//   dk's through S's and K~'s tiles once read (stores straight from the
//   accumulator layout, 4 bytes a lane over 8 rows, were slower).  At 255
//   registers it does not spill: each product's tile addresses, and the
//   final scan's views, pass through an empty asm (opaque) so that the
//   compiler forms them where they are used instead of keeping them from
//   the kernel's start.
// - Where the clamp sends a chunk down the per-(t, i, d) path, warpgroup 1
//   forms its diagonal sub-blocks first: A's sums over the lanes by warp
//   sums (a reduce-scatter's array went to local memory), dk's into FG's
//   rows, a lane's own channels.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kL = 64;                  // chunk length: the rows of a tile
constexpr int kThreads = 128;           // the walks: one warpgroup
constexpr int kChunkThreads = 256;      // the rest: two warpgroups
constexpr int kTile = kL * kRowBytes;   // one 64 x 64 bf16 tile, 8 KB
constexpr int kFTile = kL * kL * 4;     // one 64 x 64 f32 tile, 16 KB
constexpr int kPN = kL * kL;            // floats a state tile
constexpr float kLog2e = 1.4426950408889634f;   // exp(v) = ex2(v kLog2e)
// the most a sub-chunk's cum may fall (log2 units, 69 in natural units) for
// its diagonal sub-block to be a product: past it, per (t, i, d)
constexpr float kRange = 100.f;

// phase 1: two stages of (A tile, B tile, log_w tile), two mbarriers, the
// scan's exchange
constexpr int kStage = 2 * kTile + kFTile;
constexpr int kSmemWalk = 2 * kStage + 64 * 4 + 16 + 1024;

// phase 2, byte offsets from the 1024-aligned base: r, k, v, do tiles; cum;
// S and G in f32 (later the slow path's and the scan's f32 staging); dk's
// state term, dec dkdec, in f32; S, G, K~ and R^ each as hi, mid, lo tiles;
// then dv's staging tile, the floats and three mbarriers
constexpr uint32_t kOffR = 0, kOffK = kTile, kOffV = 2 * kTile,
                   kOffO = 3 * kTile;
constexpr uint32_t kOffW = 4 * kTile;
constexpr uint32_t kOffFS = kOffW + kFTile, kOffFG = kOffFS + kFTile,
                   kOffFP = kOffFG + kFTile;
constexpr uint32_t kOffS3 = kOffFP + kFTile, kOffG3 = kOffS3 + 3 * kTile,
                   kOffK3 = kOffG3 + 3 * kTile, kOffR3 = kOffK3 + 3 * kTile;
constexpr uint32_t kOffDV = kOffR3 + 3 * kTile;   // dv's staging tile
constexpr uint32_t kOffF = kOffDV + kTile;
// the floats, in floats from kOffF: u; c_0..c_3 [j][d]; Gv [p][j][d], 0
// where unused; exp(c_{p-1}) [p][d]; exp(cum_L - c_j) [j][d]; exp(cum_L);
// sum_c S G; beta; dbeta; sum kdec dkdec [warp][d]; the scans' and du's
// exchanges [quarter][d]; dA's and A's diagonal sub-blocks [w][t][i]
constexpr int kFU = 0, kFCref = kFU + 64, kFGv = kFCref + 4 * 64,
              kFEp = kFGv + 16 * 64, kFFj = kFEp + 4 * 64,
              kFDec = kFFj + 4 * 64, kFSig = kFDec + 64, kFBeta = kFSig + 64,
              kFDbeta = kFBeta + 64, kFKk = kFDbeta + 64, kFXs = kFKk + 4 * 64,
              kFDu = kFXs + 4 * 64, kFDad = kFDu + 4 * 64,
              kFDg = kFDad + 1024, kFloats = kFDg + 1024;
constexpr uint32_t kOffBar = kOffF + 4 * kFloats;
constexpr int kSmemChunk = kOffBar + 24 + 1024;
static_assert(kSmemChunk <= 232448, "over the shared memory a block can have");

// bf16 hi + mid + lo of two f32 values, packed as A fragments (or a tile's
// column pairs): hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
    uint32_t rest;
    split2(a, b, hi, rest);
    const float2 h = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hi));
    split2(a - h.x, b - h.y, mid, lo);
}

__device__ __forceinline__ float2 bf2(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// cum of step t, channel d, in the log_w tile it overwrote (and the f32
// staging tiles): rows of 64 floats, groups of 8 XOR-swizzled by the row
__device__ __forceinline__ int cidx(int t, int d) {
    return t * kL + (d ^ ((t & 7) << 3));
}

// the pair of bf16 values at (row, col), (row, col + 1) of a swizzled tile
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int row,
                                            int col) {
    return bf2(*reinterpret_cast<const uint32_t*>(
        tile + swz(row, col >> 3) + 2 * (col & 7)));
}

// The scan of a chunk's log_w tile (rows as TMA wrote them) into cum, in
// log2 units, in place (cidx): NT / 64 threads a channel, each over 64 / (NT
// / 64) steps, then one exchange through xs ((NT / 64 - 1) x 64 floats).
// Returns, to every thread, whether a sub-chunk's cum falls more than kRange
// in some channel.  Ends with a barrier of the block.
template <int NT>
__device__ __forceinline__ bool scan_cum(float* W, float* xs) {
    constexpr int kParts = NT / 64, kSteps = kL / kParts;
    const int d = threadIdx.x & 63, part = threadIdx.x >> 6;
    float cv[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
        cv[t] = W[(kSteps * part + t) * kL + d] * kLog2e;
#pragma unroll
    for (int t = 1; t < kSteps; ++t) cv[t] += cv[t - 1];
    if (part < kParts - 1) xs[part * 64 + d] = cv[kSteps - 1];
    // the fall of cum over each of this thread's sub-chunks of 16
    bool falls = false;
#pragma unroll
    for (int j = 0; j < kSteps / 16; ++j)
        falls |= (j > 0 ? cv[16 * j - 1] : 0.f) - cv[16 * j + 15] > kRange;
    const bool slow = __syncthreads_or(falls);
    float off = 0.f;
    for (int o = 0; o < part; ++o) off += xs[o * 64 + d];
#pragma unroll
    for (int t = 0; t < kSteps; ++t)
        W[cidx(kSteps * part + t, d)] = cv[t] + off;
    __syncthreads();
    return slow;
}

// ---- phase 1: the state walks -------------------------------------------

// chunk c's A tile (k or r), B tile (v or do) and log_w into stage n % 2,
// completing its mbarrier
__device__ __forceinline__ void load_walk(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          const CUtensorMap* tw,
                                          uint32_t base, uint32_t bar, int n,
                                          int c, int h, int b) {
    const uint32_t st = base + (n & 1) * kStage, full = bar + 8 * (n & 1);
    mbar_expect(full, kStage);
    tma_load(st, ta, full, 0, h, c * kL, b);             // (K, H, S, B)
    tma_load(st + kTile, tb, full, 0, h, c * kL, b);
    tma_load(st + 2 * kTile, tw, full, 0, h, c * kL, b);
}

// one block per (head, batch, walk).  Walk 0 goes forward over k, v and
// stores the state entering each chunk, S_{c+1} = diag(exp(cum_L)) S_c +
// kdec^T v; walk 1 goes in reverse over r, do and stores the gradient of the
// state leaving each chunk, G_{c-1} = diag(exp(cum_L)) G_c + (r exp(cum_ex))^T
// do.  The carried value lives in the warpgroup's accumulators (f32) for the
// whole walk; each chunk's is stored in f32 straight from them.  The walk's
// last chunk takes no update; the next chunk's scan runs while a chunk's
// product does.
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_walk_kernel_wgmma(const __grid_constant__ CUtensorMap tm_r,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_w,
                           float* __restrict__ states,
                           float* __restrict__ grads, int S, int H) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);
    float* const xs = reinterpret_cast<float*>(gb + 2 * kStage);
    const uint32_t bar = base + 2 * kStage + 64 * 4;

    const int h = blockIdx.x, b = blockIdx.y;
    const bool rev = blockIdx.z != 0;
    const CUtensorMap* ta = rev ? &tm_r : &tm_k;
    const CUtensorMap* tb = rev ? &tm_do : &tm_v;
    float* const out = rev ? grads : states;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
    const int nc = (S + kL - 1) / kL;
    auto chunk = [&](int n) { return rev ? nc - 1 - n : n; };

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        mbar_init_fence();
        for (int n = 0; n < 2 && n < nc; ++n)
            load_walk(ta, tb, &tm_w, base, bar, n, chunk(n), h, b);
    }
    float st[32];                             // the carry, accumulator layout
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    __syncthreads();
    mbar_wait(bar, 0);
    scan_cum<kThreads>(reinterpret_cast<float*>(gb + 2 * kTile), xs);

    for (int n = 0; n < nc; ++n) {
        const int s = n & 1, c = chunk(n);
        const uint32_t sa = base + s * kStage, sb = sa + kTile;
        const float* W = reinterpret_cast<const float*>(gb + s * kStage
                                                        + 2 * kTile);
        // the carry at the chunk's boundary, in f32, [d][c]
        float* tile = out + ((static_cast<size_t>(b) * nc + c) * H + h) * kPN;
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
                *reinterpret_cast<float2*>(tile + (r0 + 8 * rr) * kL + 8 * m
                                           + cq) =
                    make_float2(st[4 * m + 2 * rr], st[4 * m + 2 * rr + 1]);
        if (n + 1 < nc) {
            // carry = diag(exp(cum_L)) carry + a^T b: A fragments from the
            // tile read transposed (ldmatrix.trans: row d = channel, column
            // = step), times kdec's exp(cum_L - cum_i) (walk 0) or
            // exp(cum_ex_t) (walk 1), split into hi + mid + lo
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
                    const int d = r0 + 8 * (f % 2);
                    const int i = 16 * kk + 8 * (f / 2) + cq;
                    const float2 av = bf2(ar[f]);
                    float w0, w1;
                    if (rev) {
                        w0 = i > 0 ? ex2(W[cidx(i - 1, d)]) : 1.f;
                        w1 = ex2(W[cidx(i, d)]);
                    } else {
                        const float cl = W[cidx(kL - 1, d)];
                        w0 = ex2(cl - W[cidx(i, d)]);
                        w1 = ex2(cl - W[cidx(i + 1, d)]);
                    }
                    split3(av.x * w0, av.y * w1, ahi[kk][f], amid[kk][f],
                           alo[kk][f]);
                }
            }
            const float dec[2] = {ex2(W[cidx(kL - 1, r0)]),
                                  ex2(W[cidx(kL - 1, r0 + 8)])};
#pragma unroll
            for (int j = 0; j < 32; ++j) st[j] *= dec[(j >> 1) & 1];
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
            // the next chunk's scan while the product runs
            mbar_wait(bar + 8 * (s ^ 1), ((n + 1) >> 1) & 1);
            scan_cum<kThreads>(reinterpret_cast<float*>(gb + (s ^ 1) * kStage
                                                        + 2 * kTile), xs);
            wgmma_wait<0>();
            pin<32>(st);
        }
        __syncthreads();                      // stage s is read
        if (tid == 0 && n + 2 < nc)
            load_walk(ta, tb, &tm_w, base, bar, n + 2, chunk(n + 2), h, b);
    }
}

// ---- phase 2: the rest ---------------------------------------------------

// one arrival at a named barrier of `threads` threads, without waiting (the
// producer's side: the consumer's bar.sync waits for it)
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The bf16 pair (a, b) at (row, col), (row, col + 1) of a 128-byte
// swizzled staging tile (col even)
__device__ __forceinline__ void put_pair(uint8_t* tile, int row, int col,
                                         float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(tile + swz(row, col >> 3)
                                       + 2 * (col & 7)) =
        __floats2bfloat162_rn(a, b);
}

// A warpgroup's staging tile, written, out by one TMA store from thread 0
// of the warpgroup (named barrier `bar_id` among its 128 threads); the
// store is a bulk group of that thread, waited for before the block exits.
// TMA writes nothing past S or K.
__device__ __forceinline__ void store_tile(uint32_t tile,
                                           const CUtensorMap* map,
                                           int bar_id) {
    fence_proxy_async();
    named_bar(bar_id, 128);
    if ((threadIdx.x & 127) == 0) {
        tma_store(map, tile, 0, blockIdx.x, blockIdx.y * kL, blockIdx.z);
        bulk_commit();
    }
}

// x, hidden from the compiler, so that what is computed from it (the
// wgmma descriptors of a tile) is computed where it is used and not kept
// in registers from the kernel's start
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
    asm volatile("" : "+r"(x));
    return x;
}

// D = a b over one k-step with a (registers) and b (a tile's descriptors)
// in three parts each: the six part products above 2^-24
template <int TB>
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* am, const uint32_t* al,
                                     uint64_t bh, uint64_t bm, uint64_t bl) {
    wgmma_rs<64, TB>(d, ah, bh);
    wgmma_rs<64, TB>(d, ah, bm);
    wgmma_rs<64, TB>(d, am, bh);
    wgmma_rs<64, TB>(d, ah, bl);
    wgmma_rs<64, TB>(d, al, bh);
    wgmma_rs<64, TB>(d, am, bm);
}

// the bf16 value at (row, col) of a swizzled tile
__device__ __forceinline__ float tile_at(const uint8_t* tile, int row,
                                         int col) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
        tile + swz(row, col >> 3) + 2 * (col & 7)));
}

// the warpgroup's dA = do v^T [t][i] (or, transposed, v do^T [i][t]) into
// acc, keeping i < t; rows r0, r0 + 8 and columns 8 m + cq + e per thread
__device__ __forceinline__ void form_da(float* acc, uint32_t tO, uint32_t tV,
                                        bool transposed, int r0, int cq) {
    tO = opaque(tO);
    tV = opaque(tV);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    pin<32>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 0, 0>(
            acc, desc((transposed ? tV : tO) + 32 * kk, 16, 1024),
            desc((transposed ? tO : tV) + 32 * kk, 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    pin<32>(acc);
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int row = r0 + 8 * rr, col = 8 * m + cq + e;
                const bool keep = transposed ? row < col : col < row;
                acc[4 * m + 2 * rr + e] = keep ? acc[4 * m + 2 * rr + e] : 0.f;
            }
}

// A fragments (hi, mid, lo) of k-step kk of a 64 x 64 accumulator (its
// columns 16 kk .. 16 kk + 15 as the product's depth)
__device__ __forceinline__ void acc_frags3(const float* acc, int kk,
                                           uint32_t* hi, uint32_t* mid,
                                           uint32_t* lo) {
#pragma unroll
    for (int f = 0; f < 4; ++f) {
        const int j = 4 * (2 * kk + f / 2) + 2 * (f % 2);
        split3(acc[j], acc[j + 1], hi[f], mid[f], lo[f]);
    }
}

// The warpgroup's sum over E of dr (T = false: da = dA [t][i], B = K~) or
// dk (T = true: da = dA^T [i][t], B = R^) into out: for each k-step p of
// da, D = da[:, p] B_p, both in three parts (B_p the 16 rows of tile B's
// hi, mid, lo from row 16 p), then out += Gv[w][p] D (dr) or Gv[p][w] D
// (dk) per channel
template <bool T>
__device__ __forceinline__ void esum(float* out, const float* da, uint32_t tB,
                                     const float* v_gv, int warp, int cq) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        float d[32];
        uint32_t fh[4], fm[4], fl[4];
        acc_frags3(da, p, fh, fm, fl);
#pragma unroll
        for (int e = 0; e < 32; ++e) d[e] = 0.f;
        pin<32>(d);
        pin<4>(fh);
        pin<4>(fm);
        pin<4>(fl);
        wgmma_fence();
        const uint32_t b = opaque(tB) + 2048 * p;
        mma3<1>(d, fh, fm, fl, desc(b, kTile, 1024),
                desc(b + kTile, kTile, 1024), desc(b + 2 * kTile, kTile, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(d);
        const float* gv = v_gv + (T ? 4 * p + warp : 4 * warp + p) * 64;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const float2 g = *reinterpret_cast<const float2*>(gv + 8 * m + cq);
            out[4 * m] += g.x * d[4 * m];
            out[4 * m + 1] += g.y * d[4 * m + 1];
            out[4 * m + 2] += g.x * d[4 * m + 2];
            out[4 * m + 3] += g.y * d[4 * m + 3];
        }
    }
}

// one block per (head, chunk, batch) of two warpgroups: see the header.
// Both form the chunk's scan, vectors and tiles; then warpgroup 0 forms A^T
// and dv, warpgroup 1 dr and dk (and, where a sub-chunk's cum falls more
// than kRange, the diagonal sub-blocks per (t, i, d) first); then both the
// reverse scans that give dlog_w.  In a warpgroup's products warp w owns
// rows 16 w .. 16 w + 15 of every accumulator (sub-chunk w).
__global__ void __launch_bounds__(kChunkThreads, 1)
wkv6_bwd_chunk_kernel_wgmma(
        const __grid_constant__ CUtensorMap tm_r,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_w,
        const __grid_constant__ CUtensorMap tm_st,
        const __grid_constant__ CUtensorMap tm_dr,
        const __grid_constant__ CUtensorMap tm_dk,
        const __grid_constant__ CUtensorMap tm_dv,
        const float* __restrict__ u, float* __restrict__ dlw,
        float* __restrict__ dup, int S, int H, int K) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);
    const uint8_t* const pR = gb + kOffR;
    const uint8_t* const pK = gb + kOffK;
    const uint8_t* const pV = gb + kOffV;
    const uint8_t* const pO = gb + kOffO;
    float* const W = reinterpret_cast<float*>(gb + kOffW);
    float* const FS = reinterpret_cast<float*>(gb + kOffFS);
    float* const FG = reinterpret_cast<float*>(gb + kOffFG);
    float* const FP = reinterpret_cast<float*>(gb + kOffFP);
    float* const vf = reinterpret_cast<float*>(gb + kOffF);
    float* const v_u = vf + kFU;
    float* const v_cref = vf + kFCref;
    float* const v_gv = vf + kFGv;
    float* const v_ep = vf + kFEp;
    float* const v_fj = vf + kFFj;
    float* const v_dec = vf + kFDec;
    float* const v_sig = vf + kFSig;
    float* const v_beta = vf + kFBeta;
    float* const v_dbeta = vf + kFDbeta;
    float* const v_kk = vf + kFKk;
    float* const v_xs = vf + kFXs;
    float* const v_du = vf + kFDu;
    float* const v_dad = vf + kFDad;
    float* const v_dg = vf + kFDg;
    const uint32_t bar = base + kOffBar;

    // (the block's coordinates are read again where they are used late,
    // rather than kept in registers)
    const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int nc = gridDim.y;
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid % 32;
    const int gwarp = tid / 32, warp = gwarp % 4;
    const int r0 = warp * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const int s0 = c * kL;
    const size_t ti = (static_cast<size_t>(b) * nc + c) * H + h;
    const uint32_t tV = base + kOffV, tO = base + kOffO;
    const uint32_t tS3 = base + kOffS3, tG3 = base + kOffG3,
                   tK3 = base + kOffK3, tR3 = base + kOffR3;

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        mbar_init(bar + 16);
        mbar_init_fence();
        mbar_expect(bar + 16, kFTile);
        tma_load(base + kOffW, &tm_w, bar + 16, 0, h, s0, b);
        mbar_expect(bar, 4 * kTile);
        tma_load(base + kOffR, &tm_r, bar, 0, h, s0, b);
        tma_load(base + kOffK, &tm_k, bar, 0, h, s0, b);
        tma_load(base + kOffV, &tm_v, bar, 0, h, s0, b);
        tma_load(base + kOffO, &tm_do, bar, 0, h, s0, b);
        mbar_expect(bar + 8, 2 * kFTile);
        tma_load(base + kOffFS, &tm_st, bar + 8, 0, 0,
                 static_cast<int>(ti));
        tma_load(base + kOffFG, &tm_st, bar + 8, 0, 0,
                 static_cast<int>(ti + static_cast<size_t>(gridDim.z) * nc
                                  * H));
    }
    if (tid < 64) v_u[tid] = tid < K ? u[h * K + tid] : 0.f;
    __syncthreads();
    mbar_wait(bar + 16, 0);

    // ---- the scan; the chunk's vectors; beta, dbeta; sum_c S G -------------
    const bool slow = scan_cum<kChunkThreads>(W, v_xs);
    mbar_wait(bar, 0);
    if (tid < 64) {
        const int d = tid;
        float cr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cr[j] = W[cidx(16 * j + 15, d)];
            v_cref[j * 64 + d] = cr[j];
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const float cp = p > 0 ? cr[p - 1] : 0.f;
            v_ep[p * 64 + d] = ex2(cp);
            v_fj[p * 64 + d] = ex2(cr[3] - cr[p]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                v_gv[(4 * p + j) * 64 + d] =
                    j < p || (j == p && !slow) ? ex2(cp - cr[j]) : 0.f;
        }
        v_dec[d] = ex2(cr[3]);
    } else if (gwarp == 4 || gwarp == 5) {
        // beta_t = sum_d r u k, dbeta_t = sum_c do v: a lane a step, its
        // column pairs rotated by the lane (no two lanes on one bank)
        const int t = 32 * (gwarp - 4) + lane;
        float bt = 0.f, dbt = 0.f;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
            const int col = 2 * ((j + lane) & 31);
            const float2 rv = tile_pair(pR, t, col), kv = tile_pair(pK, t, col),
                         ov = tile_pair(pO, t, col), vv = tile_pair(pV, t, col);
            const float2 uu = *reinterpret_cast<const float2*>(v_u + col);
            bt += rv.x * uu.x * kv.x + rv.y * uu.y * kv.y;
            dbt += ov.x * vv.x + ov.y * vv.y;
        }
        v_beta[t] = bt;
        v_dbeta[t] = dbt;
    }
    mbar_wait(bar + 8, 0);
    if (gwarp == 2 || gwarp == 3) {
        // sum_c S[d][c] G[d][c]: a lane a row, its columns rotated by the
        // lane
        const int d = 32 * (gwarp - 2) + lane;
        float sg = 0.f;
#pragma unroll 8
        for (int j = 0; j < 64; ++j) {
            const int col = (j + lane) & 63;
            sg += FS[d * kL + col] * FG[d * kL + col];
        }
        v_sig[d] = sg;
    }
    __syncthreads();                         // the vectors are written

    // ---- tiles: S, G as hi, mid, lo; K~ = k Ks, R^ = r Rs as hi, mid, lo --
#pragma unroll
    for (int m = 0; m < 2; ++m) {
        const int q = tid + kChunkThreads * m, row = q >> 3, c8 = q & 7;
        const uint32_t off = swz(row, c8);
        {
            const float4* fs = reinterpret_cast<const float4*>(FS + row * kL
                                                               + 8 * c8);
            const float4* fg = reinterpret_cast<const float4*>(FG + row * kL
                                                               + 8 * c8);
            const float4 sa = fs[0], sb = fs[1], ga = fg[0], gb4 = fg[1];
            const float sv[8] = {sa.x, sa.y, sa.z, sa.w,
                                 sb.x, sb.y, sb.z, sb.w};
            const float gvv[8] = {ga.x, ga.y, ga.z, ga.w,
                                  gb4.x, gb4.y, gb4.z, gb4.w};
            uint32_t sh[4], sm[4], sl[4], gh[4], gm[4], gl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                split3(sv[2 * e], sv[2 * e + 1], sh[e], sm[e], sl[e]);
                split3(gvv[2 * e], gvv[2 * e + 1], gh[e], gm[e], gl[e]);
            }
            uint8_t* s3 = gb + kOffS3 + off;
            uint8_t* g3 = gb + kOffG3 + off;
            *reinterpret_cast<uint4*>(s3) =
                make_uint4(sh[0], sh[1], sh[2], sh[3]);
            *reinterpret_cast<uint4*>(s3 + kTile) =
                make_uint4(sm[0], sm[1], sm[2], sm[3]);
            *reinterpret_cast<uint4*>(s3 + 2 * kTile) =
                make_uint4(sl[0], sl[1], sl[2], sl[3]);
            *reinterpret_cast<uint4*>(g3) =
                make_uint4(gh[0], gh[1], gh[2], gh[3]);
            *reinterpret_cast<uint4*>(g3 + kTile) =
                make_uint4(gm[0], gm[1], gm[2], gm[3]);
            *reinterpret_cast<uint4*>(g3 + 2 * kTile) =
                make_uint4(gl[0], gl[1], gl[2], gl[3]);
        }
        {
            // K~ = k exp(c_j - cum_i), R^ = r exp(cum_ex_t - c_{j-1}), j the
            // row's sub-chunk (c_{-1} = 0, cum_ex_0 = 0)
            const int j = row >> 4;
            const float4* cm = reinterpret_cast<const float4*>(
                W + row * kL + 8 * (c8 ^ (row & 7)));
            const float4* cx = reinterpret_cast<const float4*>(
                W + (row - 1) * kL + 8 * (c8 ^ ((row - 1) & 7)));
            const float4* cj = reinterpret_cast<const float4*>(
                v_cref + j * 64 + 8 * c8);
            const float4* cp = reinterpret_cast<const float4*>(
                v_cref + (j - 1) * 64 + 8 * c8);
            const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 m4[2] = {cm[0], cm[1]};
            const float4 x4[2] = {row > 0 ? cx[0] : z4, row > 0 ? cx[1] : z4};
            const float4 j4[2] = {cj[0], cj[1]};
            const float4 p4[2] = {j > 0 ? cp[0] : z4, j > 0 ? cp[1] : z4};
            const float* cmv = reinterpret_cast<const float*>(m4);
            const float* cxv = reinterpret_cast<const float*>(x4);
            const float* cjv = reinterpret_cast<const float*>(j4);
            const float* cpv = reinterpret_cast<const float*>(p4);
            const uint4 kv4 = *reinterpret_cast<const uint4*>(pK + off);
            const uint4 rv4 = *reinterpret_cast<const uint4*>(pR + off);
            const uint32_t kw[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
            const uint32_t rw[4] = {rv4.x, rv4.y, rv4.z, rv4.w};
            uint32_t kh[4], km[4], kl[4], rh[4], rm[4], rl[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 kf = bf2(kw[e]), rf = bf2(rw[e]);
                const int d = 2 * e;
                split3(kf.x * ex2(cjv[d] - cmv[d]),
                       kf.y * ex2(cjv[d + 1] - cmv[d + 1]), kh[e], km[e],
                       kl[e]);
                split3(rf.x * ex2(cxv[d] - cpv[d]),
                       rf.y * ex2(cxv[d + 1] - cpv[d + 1]), rh[e], rm[e],
                       rl[e]);
            }
            uint8_t* k3 = gb + kOffK3 + off;
            uint8_t* r3 = gb + kOffR3 + off;
            *reinterpret_cast<uint4*>(k3) =
                make_uint4(kh[0], kh[1], kh[2], kh[3]);
            *reinterpret_cast<uint4*>(k3 + kTile) =
                make_uint4(km[0], km[1], km[2], km[3]);
            *reinterpret_cast<uint4*>(k3 + 2 * kTile) =
                make_uint4(kl[0], kl[1], kl[2], kl[3]);
            *reinterpret_cast<uint4*>(r3) =
                make_uint4(rh[0], rh[1], rh[2], rh[3]);
            *reinterpret_cast<uint4*>(r3 + kTile) =
                make_uint4(rm[0], rm[1], rm[2], rm[3]);
            *reinterpret_cast<uint4*>(r3 + 2 * kTile) =
                make_uint4(rl[0], rl[1], rl[2], rl[3]);
        }
    }
    fence_proxy_async();
    __syncthreads();                         // the tiles are written

    // ---- the slow path (warpgroup 1): the diagonal sub-blocks per (t, i,
    // d), warp w on sub-block w with a channel a lane (two: d, d + 32): A's
    // into v_dg, dr's and dk's into FS and FG ---------------------------
    if (slow) {
        if (wg == 1) {
            {
                float da[32];
                form_da(da, tO, tV, false, r0, cq);
                // warp w's own sub-block: columns 16 w .. 16 w + 15
#pragma unroll
                for (int m = 0; m < 8; ++m)
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            if ((m >> 1) == warp)
                                v_dad[warp * 256 + (lane / 4 + 8 * rr) * 16
                                      + 8 * (m & 1) + cq + e] =
                                    da[4 * m + 2 * rr + e];
            }
            __syncwarp();
            const int T0 = 16 * warp, d0 = lane, d1 = lane + 32;
            const float* dad = v_dad + warp * 256;
            float* dg = v_dg + warp * 256;
            float qv[15][2];        // prod_{i<s<t} w_s
            // dk's diagonal sums, a lane's own channels of FG's rows
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                FG[cidx(T0 + i, d0)] = 0.f;
                FG[cidx(T0 + i, d1)] = 0.f;
            }
            float cp0 = W[cidx(T0, d0)], cp1 = W[cidx(T0, d1)];   // cum_{t-1}
            qv[0][0] = qv[0][1] = 1.f;
            FS[cidx(T0, d0)] = 0.f;              // row 0: nothing below it
            FS[cidx(T0, d1)] = 0.f;
#pragma unroll
            for (int t = 1; t < 16; ++t) {
                const int T = T0 + t;
                const float rt0 = tile_at(pR, T, d0), rt1 = tile_at(pR, T, d1);
                const float cm0 = W[cidx(T, d0)], cm1 = W[cidx(T, d1)];
                float dr0 = 0.f, dr1 = 0.f;
#pragma unroll
                for (int i = 0; i < 15; ++i) {
                    if (i < t) {
                        const float kq0 = tile_at(pK, T0 + i, d0) * qv[i][0],
                                    kq1 = tile_at(pK, T0 + i, d1) * qv[i][1];
                        // A[t][i]: this lane's two channels, summed over
                        // the lanes
                        const float sum = warp_sum(rt0 * kq0 + rt1 * kq1);
                        if (lane == 0) dg[t * 16 + i] = sum;
                        const float a = dad[t * 16 + i];
                        dr0 += a * kq0;
                        dr1 += a * kq1;
                        FG[cidx(T0 + i, d0)] += a * rt0 * qv[i][0];
                        FG[cidx(T0 + i, d1)] += a * rt1 * qv[i][1];
                    }
                }
                FS[cidx(T, d0)] = dr0;
                FS[cidx(T, d1)] = dr1;
                if (t < 15) {                     // q_i <- q_i w_t
                    const float w0 = ex2(cm0 - cp0), w1 = ex2(cm1 - cp1);
#pragma unroll
                    for (int i = 0; i < 15; ++i) {
                        if (i < t) {
                            qv[i][0] *= w0;
                            qv[i][1] *= w1;
                        }
                    }
                    qv[t][0] = qv[t][1] = 1.f;
                }
                cp0 = cm0;
                cp1 = cm1;
            }
        }
        __syncthreads();
    }

    if (wg == 0) {
        // ---- dk's state term first, so that warpgroup 1 need not wait for
        // it: dkdec = v G^T [i][d]; dec dkdec into FP, kdec dkdec (i < L - 1)
        // summed over the rows into v_kk ------------------------------------
        {
        float acc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        pin<32>(acc);
        wgmma_fence();
        const uint32_t tv = opaque(tV), tg = opaque(tG3);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t a = desc(tv + 32 * kk, 16, 1024);
            wgmma_ss<64, 0, 0>(acc, a, desc(tg + 32 * kk, 16, 1024));
            wgmma_ss<64, 0, 0>(acc, a, desc(tg + kTile + 32 * kk, 16, 1024));
            wgmma_ss<64, 0, 0>(acc, a,
                               desc(tg + 2 * kTile + 32 * kk, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(acc);
        float kkp[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) kkp[q] = 0.f;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            const int i = r0 + 8 * rr;
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const int d = 8 * m + cq, j = 4 * m + 2 * rr;
                const float2 cj = *reinterpret_cast<const float2*>(
                    v_cref + warp * 64 + d);
                const float2 fj = *reinterpret_cast<const float2*>(
                    v_fj + warp * 64 + d);
                const float2 cm = *reinterpret_cast<const float2*>(
                    W + cidx(i, d));
                const float2 kv = tile_pair(pK, i, d);
                const float p0 = ex2(cj.x - cm.x) * fj.x * acc[j],
                            p1 = ex2(cj.y - cm.y) * fj.y * acc[j + 1];
                *reinterpret_cast<float2*>(FP + cidx(i, d)) =
                    make_float2(p0, p1);
                if (i < kL - 1) {
                    kkp[2 * m] += kv.x * p0;
                    kkp[2 * m + 1] += kv.y * p1;
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            float v = kkp[q];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            kkp[q] = v;
        }
        if (lane < 4) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                v_kk[warp * 64 + 8 * m + cq] = kkp[2 * m];
                v_kk[warp * 64 + 8 * m + cq + 1] = kkp[2 * m + 1];
            }
        }
        named_bar_arrive(1, kChunkThreads);   // FP is written
        }

        // ---- A^T [i][t], by row sub-chunk p of t: (k Ks Gv[p][w]) . R^ ----
        float at[4][8];
        {
            // K~ = k Ks of this thread's A fragments (rows i, channels d)
            float kt[4][4][2];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    const int i = r0 + 8 * (f % 2),
                              d = 16 * kk + 8 * (f / 2) + cq;
                    const float2 kf = tile_pair(pK, i, d);
                    const float2 cj = *reinterpret_cast<const float2*>(
                        v_cref + warp * 64 + d);
                    const float2 cm = *reinterpret_cast<const float2*>(
                        W + cidx(i, d));
                    kt[kk][f][0] = kf.x * ex2(cj.x - cm.x);
                    kt[kk][f][1] = kf.y * ex2(cj.y - cm.y);
                }
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                uint32_t kh[4][4], kl[4][4];
                const float* gv = v_gv + (4 * p + warp) * 64;
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int f = 0; f < 4; ++f) {
                        const int d = 16 * kk + 8 * (f / 2) + cq;
                        const float2 g =
                            *reinterpret_cast<const float2*>(gv + d);
                        split2(kt[kk][f][0] * g.x, kt[kk][f][1] * g.y,
                               kh[kk][f], kl[kk][f]);
                    }
#pragma unroll
                for (int e = 0; e < 8; ++e) at[p][e] = 0.f;
                pin<8>(at[p]);
                pin<16>(&kh[0][0]);
                pin<16>(&kl[0][0]);
                wgmma_fence();
                const uint32_t tr = opaque(tR3);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const uint32_t o = 2048 * p + 32 * kk;
                    const uint64_t bh = desc(tr + o, 16, 1024),
                                   bm = desc(tr + kTile + o, 16, 1024);
                    wgmma_rs<16, 0>(at[p], kh[kk], bh);
                    wgmma_rs<16, 0>(at[p], kl[kk], bh);
                    wgmma_rs<16, 0>(at[p], kh[kk], bm);
                }
                wgmma_commit();
                wgmma_wait<0>();
                pin<8>(at[p]);
            }
        }
        // strictly lower (i < t), the slow diagonal from v_dg, beta on the
        // diagonal
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int i = r0 + 8 * rr, t = 16 * p + 8 * m + cq + e;
                        float& a = at[p][4 * m + 2 * rr + e];
                        // (t, i) within sub-block w where p == w
                        const float sd = v_dg[warp * 256 + (t & 15) * 16
                                              + (i & 15)];
                        a = i < t ? (slow && p == warp ? sd : a)
                                  : (i == t ? v_beta[t] : 0.f);
                    }

        // ---- dv = A^T do + kdec G ---------------------------------------
        float acc[32];
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int j = 4 * (f / 2) + 2 * (f % 2);
                split2(at[p][j], at[p][j + 1], ah[p][f], al[p][f]);
            }
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
        pin<32>(acc);
        pin<16>(&ah[0][0]);
        pin<16>(&al[0][0]);
        wgmma_fence();
        const uint32_t to = opaque(tO);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint64_t ok = desc(to + 2048 * p, kTile, 1024);
            wgmma_rs<64, 1>(acc, ah[p], ok);
            wgmma_rs<64, 1>(acc, al[p], ok);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(acc);
        // kdec = k Ks Fj, rows i (sub-chunk w), channels d
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const int i = r0 + 8 * (f % 2), d = 16 * kk + 8 * (f / 2) + cq;
                const float2 kf = tile_pair(pK, i, d);
                const float2 cj = *reinterpret_cast<const float2*>(
                    v_cref + warp * 64 + d);
                const float2 fj = *reinterpret_cast<const float2*>(
                    v_fj + warp * 64 + d);
                const float2 cm = *reinterpret_cast<const float2*>(
                    W + cidx(i, d));
                split2(kf.x * ex2(cj.x - cm.x) * fj.x,
                       kf.y * ex2(cj.y - cm.y) * fj.y, ah[kk][f], al[kk][f]);
            }
        pin<32>(acc);
        pin<16>(&ah[0][0]);
        pin<16>(&al[0][0]);
        wgmma_fence();
        const uint32_t tg = opaque(tG3);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint32_t o = 2048 * kk;
            const uint64_t gh = desc(tg + o, kTile, 1024),
                           gm = desc(tg + kTile + o, kTile, 1024);
            wgmma_rs<64, 1>(acc, ah[kk], gh);
            wgmma_rs<64, 1>(acc, ah[kk], gm);
            wgmma_rs<64, 1>(acc, al[kk], gh);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin<32>(acc);
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
                put_pair(gb + kOffDV, r0 + 8 * rr, 8 * m + cq,
                         acc[4 * m + 2 * rr], acc[4 * m + 2 * rr + 1]);
        store_tile(base + kOffDV, &tm_dv, 2);
    } else {
        // ---- dr = Rs (exp(c_{p-1}) do S^T + sum_j Gv[w][j] dA[:, j] K~_j) -
        {
            float z[32], da[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) z[j] = 0.f;
            pin<32>(z);
            wgmma_fence();
            const uint32_t to = opaque(tO), ts = opaque(tS3);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint64_t a = desc(to + 32 * kk, 16, 1024);
                wgmma_ss<64, 0, 0>(z, a, desc(ts + 32 * kk, 16, 1024));
                wgmma_ss<64, 0, 0>(z, a, desc(ts + kTile + 32 * kk, 16, 1024));
                wgmma_ss<64, 0, 0>(z, a,
                                   desc(ts + 2 * kTile + 32 * kk, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait<0>();
            pin<32>(z);
            form_da(da, tO, tV, false, r0, cq);
#pragma unroll
            for (int m = 0; m < 8; ++m) {
                const float2 ep = *reinterpret_cast<const float2*>(
                    v_ep + warp * 64 + 8 * m + cq);
                z[4 * m] *= ep.x;
                z[4 * m + 1] *= ep.y;
                z[4 * m + 2] *= ep.x;
                z[4 * m + 3] *= ep.y;
            }
            esum<false>(z, da, tK3, v_gv, warp, cq);
            // times Rs; the slow diagonal; dcum_ex = r dr (over the slow
            // path's dr in FS); dr += dbeta u k
            const float2* cpv = reinterpret_cast<const float2*>(
                v_cref + (warp > 0 ? warp - 1 : 0) * 64);
            // dr through S's tiles, read by now; the two row halves in turn
            // (a compiler barrier between them bounds the loads in flight,
            // and the row comes through opaque, so that no address is made
            // ahead of the sums)
            const int re = static_cast<int>(opaque(static_cast<uint32_t>(r0)));
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                if (rr == 1) asm volatile("" ::: "memory");
                const int t = re + 8 * rr;
                const float db = v_dbeta[t];
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const int d = 8 * m + cq;
                    const float2 cx = t > 0 ? *reinterpret_cast<const float2*>(
                                                  W + cidx(t - 1, d))
                                            : make_float2(0.f, 0.f);
                    const float2 cp = warp > 0 ? cpv[d / 2]
                                               : make_float2(0.f, 0.f);
                    const float2 rv = tile_pair(pR, t, d),
                                 kv = tile_pair(pK, t, d);
                    const float2 uu = *reinterpret_cast<const float2*>(v_u + d);
                    float2* fs = reinterpret_cast<float2*>(FS + cidx(t, d));
                    float x0 = z[4 * m + 2 * rr] * ex2(cx.x - cp.x);
                    float x1 = z[4 * m + 2 * rr + 1] * ex2(cx.y - cp.y);
                    if (slow) {
                        const float2 sd = *fs;
                        x0 += sd.x;
                        x1 += sd.y;
                    }
                    *fs = make_float2(rv.x * x0, rv.y * x1);
                    put_pair(gb + kOffS3, t, d, x0 + db * uu.x * kv.x,
                             x1 + db * uu.y * kv.y);
                }
            }
            store_tile(base + kOffS3, &tm_dr, 3);
        }

        // ---- dk = Ks sum_p Gv[p][w] (dA[p, :]^T R^_p) + dbeta u r + dec dkdec
        {
            float y[32], da[32];
            form_da(da, tO, tV, true, r0, cq);    // dA^T [i][t]
#pragma unroll
            for (int j = 0; j < 32; ++j) y[j] = 0.f;
            esum<true>(y, da, tR3, v_gv, warp, cq);
            named_bar(1, kChunkThreads);          // warpgroup 0's FP
            // dk through K~'s tiles, read by now; the row halves in turn
            const int re = static_cast<int>(opaque(static_cast<uint32_t>(r0)));
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                if (rr == 1) asm volatile("" ::: "memory");
                const int i = re + 8 * rr;
                const float db = v_dbeta[i];
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                    const int d = 8 * m + cq, j = 4 * m + 2 * rr;
                    const float2 cj = *reinterpret_cast<const float2*>(
                        v_cref + warp * 64 + d);
                    const float2 cm = *reinterpret_cast<const float2*>(
                        W + cidx(i, d));
                    const float2 kv = tile_pair(pK, i, d),
                                 rv = tile_pair(pR, i, d);
                    const float2 uu = *reinterpret_cast<const float2*>(v_u + d);
                    const float2 pp = *reinterpret_cast<const float2*>(
                        FP + cidx(i, d));
                    float2* fg = reinterpret_cast<float2*>(FG + cidx(i, d));
                    float x0 = ex2(cj.x - cm.x) * y[j],
                          x1 = ex2(cj.y - cm.y) * y[j + 1];
                    if (slow) {
                        const float2 sd = *fg;
                        x0 += sd.x;
                        x1 += sd.y;
                    }
                    const float kk0 = i < kL - 1 ? kv.x * pp.x : 0.f;
                    const float kk1 = i < kL - 1 ? kv.y * pp.y : 0.f;
                    *fg = make_float2(-kv.x * x0 - kk0, -kv.y * x1 - kk1);
                    put_pair(gb + kOffK3, i, d, x0 + db * uu.x * rv.x + pp.x,
                             x1 + db * uu.y * rv.y + pp.y);
                }
            }
            store_tile(base + kOffK3, &tm_dk, 3);
        }
    }
    __syncthreads();

    // ---- dlog_w_s = sum_{t >= s} (dcum_t + dcum_ex_t) - dcum_ex_s; du:
    // thread (d, quarter) over 16 steps, then one exchange ------------------
    {
        // the views again, from the shared array and an offset the compiler
        // cannot see through, so that none is carried in registers across
        // the warpgroups' work
        uint8_t* const gf = smem_raw + opaque(base - raw);
        const uint8_t* const pR = gf + kOffR;
        const uint8_t* const pK = gf + kOffK;
        const float* const FS = reinterpret_cast<const float*>(gf + kOffFS);
        const float* const FG = reinterpret_cast<const float*>(gf + kOffFG);
        float* const vf = reinterpret_cast<float*>(gf + kOffF);
        const float* const v_dec = vf + kFDec;
        const float* const v_sig = vf + kFSig;
        const float* const v_dbeta = vf + kFDbeta;
        const float* const v_kk = vf + kFKk;
        float* const v_xs = vf + kFXs;
        float* const v_du = vf + kFDu;
        const int d = tid & 63, qt = tid >> 6;
        const int srow = blockIdx.y * kL;
        const size_t part = (static_cast<size_t>(blockIdx.z) * gridDim.y
                             + blockIdx.y) * H + blockIdx.x;
        const size_t HK = static_cast<size_t>(H) * K;
        float q[16];
        float du = 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const int T = 16 * qt + t;
            q[t] = FG[cidx(T, d)] + FS[cidx(T, d)];
            du += v_dbeta[T] * tile_at(pR, T, d) * tile_at(pK, T, d);
        }
        if (qt == 3)
            q[15] += v_kk[d] + v_kk[64 + d] + v_kk[128 + d] + v_kk[192 + d]
                     + v_dec[d] * v_sig[d];
#pragma unroll
        for (int t = 14; t >= 0; --t) q[t] += q[t + 1];
        v_xs[qt * 64 + d] = q[0];
        v_du[qt * 64 + d] = du;
        __syncthreads();
        float off = 0.f;
        for (int o = qt + 1; o < 4; ++o) off += v_xs[o * 64 + d];
        if (d < K) {
#pragma unroll
            for (int t = 0; t < 16; ++t) {
                const int T = 16 * qt + t, s = srow + T;
                if (s < S)
                    dlw[(static_cast<size_t>(blockIdx.z) * S + s) * HK
                        + static_cast<size_t>(blockIdx.x) * K + d] =
                        q[t] + off - FS[cidx(T, d)];
            }
        }
        if (qt == 0)
            dup[part * 64 + d] = v_du[d] + v_du[64 + d] + v_du[128 + d]
                               + v_du[192 + d];
    }
    if ((tid & 127) == 0) bulk_wait();       // the staged tiles are out
}

// ---- phase 3: du ----------------------------------------------------------

// du (H, K): the (batch, chunk) partials summed in order, one thread a
// (head, channel)
__global__ void __launch_bounds__(256)
wkv6_bwd_sum_u_kernel(const float* __restrict__ dup, float* __restrict__ du,
                      int H, int K, int count) {
    const int o = blockIdx.x * 256 + threadIdx.x;
    if (o >= H * K) return;
    const int h = o / K, d = o % K;
    float s = 0.f;
    for (int n = 0; n < count; ++n)
        s += dup[(static_cast<size_t>(n) * H + h) * 64 + d];
    du[o] = s;
}

}  // namespace

// The f32 scratch (in floats) the bf16 form needs for these sizes: S_c and
// G_c a (batch, chunk, head), then du's partials.
long long wkv6_bwd_wgmma_scratch_floats(int B, int S, int H) {
    const long long tiles = static_cast<long long>(B) * ((S + kL - 1) / kL)
                            * H;
    return 2 * tiles * kPN + tiles * 64;
}

// The bf16 form, called by wkv6_bwd.cu's entry point: K at most 64; r, k, v
// and do bf16, log_w f32, each with a contiguous last axis, 16-byte
// aligned, every other stride a multiple of 16 bytes (the wrapper copies
// what is not); strides (in elements) of r, k, v, log_w and do, batch, step
// and head each; dr, dk, dv (bf16) contiguous (B, S, H, K rounded up to 8),
// 16-byte aligned; dlog_w (f32) contiguous (B, S, H, K); u and du f32
// (H, K).  Returns the CUDA error of a launch, or -(a CUresult)
// when a tensor map cannot be made.
int wkv6_bwd_wgmma_launch(const void* r, const void* k, const void* v,
                          const void* log_w, const void* u, const void* dout,
                          void* dr, void* dk, void* dv, void* dlog_w,
                          void* du, void* scratch, int B, int S, int H, int K,
                          const long long* st, cudaStream_t stream) {
    using u64 = cuuint64_t;
    const int nc = (S + kL - 1) / kL;
    const long long tiles = static_cast<long long>(B) * nc * H;
    float* states = static_cast<float*>(scratch);
    float* grads = states + tiles * kPN;
    float* dup = grads + tiles * kPN;
    CUtensorMap tr, tk, tv, tw, to, ts;
    const u64 dims[4] = {u64(K), u64(H), u64(S), u64(B)};
    const cuuint32_t box[4] = {64, 1, kL, 1};
    const u64 rs[3] = {u64(st[2]) * 2, u64(st[1]) * 2, u64(st[0]) * 2};
    const u64 ks[3] = {u64(st[5]) * 2, u64(st[4]) * 2, u64(st[3]) * 2};
    const u64 vs[3] = {u64(st[8]) * 2, u64(st[7]) * 2, u64(st[6]) * 2};
    const u64 ws[3] = {u64(st[11]) * 4, u64(st[10]) * 4, u64(st[9]) * 4};
    const u64 os[3] = {u64(st[14]) * 2, u64(st[13]) * 2, u64(st[12]) * 2};
    int err = make_map_bf16(&tr, r, 4, dims, rs, box);
    if (err == 0) err = make_map_bf16(&tk, k, 4, dims, ks, box);
    if (err == 0) err = make_map_bf16(&tv, v, 4, dims, vs, box);
    if (err == 0) err = make_map_bf16(&to, dout, 4, dims, os, box);
    if (err == 0)
        err = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, log_w, 4, dims,
                       ws, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    // the states: S_c tiles then G_c tiles, 64 x 64 f32 each
    const u64 sd[3] = {u64(kL), u64(kL), u64(2 * tiles)};
    const u64 ss[2] = {u64(kL) * 4, u64(kFTile)};
    const cuuint32_t sbox[3] = {64, 64, 1};
    if (err == 0)
        err = make_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, states, 3, sd, ss,
                       sbox, CU_TENSOR_MAP_SWIZZLE_NONE);
    // dr, dk, dv: contiguous (B, S, H, KO), KO = K rounded up to 8 (the
    // wrapper allocates them so), of which TMA writes the first K columns
    CUtensorMap tdr, tdk, tdv;
    const u64 ob = u64((K + 7) / 8 * 8) * 2;
    const u64 gs[3] = {ob, ob * H, ob * H * S};
    if (err == 0) err = make_map_bf16(&tdr, dr, 4, dims, gs, box);
    if (err == 0) err = make_map_bf16(&tdk, dk, 4, dims, gs, box);
    if (err == 0) err = make_map_bf16(&tdv, dv, 4, dims, gs, box);
    if (err != 0) return err;
    cudaError_t set = cudaFuncSetAttribute(
        wkv6_bwd_walk_kernel_wgmma,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemWalk);
    if (set == cudaSuccess)
        set = cudaFuncSetAttribute(
            wkv6_bwd_chunk_kernel_wgmma,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemChunk);
    if (set != cudaSuccess) return static_cast<int>(set);

    wkv6_bwd_walk_kernel_wgmma<<<dim3(H, B, 2), kThreads, kSmemWalk,
                                 stream>>>(tr, tk, tv, to, tw, states, grads,
                                           S, H);
    int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    wkv6_bwd_chunk_kernel_wgmma<<<dim3(H, nc, B), kChunkThreads, kSmemChunk,
                                  stream>>>(
        tr, tk, tv, to, tw, ts, tdr, tdk, tdv, static_cast<const float*>(u),
        static_cast<float*>(dlog_w), dup, S, H, K);
    if ((e = static_cast<int>(cudaGetLastError()))) return e;
    wkv6_bwd_sum_u_kernel<<<(H * K + 255) / 256, 256, 0, stream>>>(
        dup, static_cast<float*>(du), H, K, B * nc);
    return static_cast<int>(cudaGetLastError());
}
