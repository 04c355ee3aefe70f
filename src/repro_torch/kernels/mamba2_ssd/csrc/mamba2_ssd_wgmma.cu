// mamba2_ssd_wgmma: the bf16 form of the port's Mamba-2 SSD scan, on
// Hopper's tensor cores (wgmma) with TMA loads and stores.  CUDA C++ for
// sm_90a, built with mamba2_ssd.cu into one shared library
// (repro_torch/kernels/build.py); mamba2_ssd.cu's C entry point sends every
// bf16 call here and every f32 call to its own CUDA-core form.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd/kernel.py::_ssd_kernel
// (wrapper ssd) for bf16.  The function is the one mamba2_ssd.cu's header
// states: per (batch, head), over chunks of L = 64 steps with a (P, N) f32
// state S carried from chunk to chunk,
//   y = exp(cum_t) (C S^T) + W x + D x,  W[t][i] = exp(cum_t - cum_i)
//       (C B^T)[t][i] dt_i for i <= t,
//   S <- exp(cum_L) S + (kdec x)^T B,  kdec_i = dt_i exp(cum_L - cum_i),
// in f32, y rounded once to bf16.  The exponent of W is evaluated only
// where i <= t.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes.  At zamba2's
// prefill (B = 2, S = 2048, H = 80, P = N = 64) x and y are 42 MB each, dt,
// B and C 2.4 MB: 86 MB over 3.35 TB/s is 26 us; the least products are
// 6.75 GFLOP, 7 us at 989 TFLOP/s.  This form issues 7 products of 64^3 a
// (batch, head, chunk), 18.8 GFLOP there, 19 us.
//
// What the design does about it:
// - All products run on the tensor cores (wgmma.m64n64k16, bf16 operands,
//   f32 accumulators), each a 64 x 64 x 64 product in four k-steps:
//   (a) G = C B^T, C and B from shared memory, both K-major;
//   (b) Y += W x, W from registers (G's accumulator layout is the A
//       register layout, as P's is in flash_attention_wgmma.cu), x the
//       MN-major B operand;
//   (c) Y = C S^T, S from shared memory, K-major (rows p, n contiguous);
//   (d) S += (kdec x)^T B, kdec x from registers (x read transposed from
//       its staged tile by ldmatrix.trans, scaled by rows), B the MN-major
//       B operand as TMA wrote it.
// - The D x skip rides on (b): D is added to W's diagonal before W is split
//   (x is exact in bf16, and hi + lo keeps 16 bits of W[t][t] + D), so the
//   epilogue only rounds Y.
// - Three operands are f32 values: W, S and kdec x.  Each rounded once to
//   bf16 puts outputs outside the bound the kernel is held to (2e-3 + 1e-2
//   |want| against the plain f32 arithmetic) at the main path's shape, so
//   each enters as bf16 hi + lo (16 bits), as P does in flash attention:
//   (b), (c) and (d) are two products each, seven in all.  x, B and C are
//   bf16 already and exact.
// - One warpgroup (128 threads) per (batch, head) walks its chunks in
//   order: the counterpart of the TPU kernel's sequential chunk axis with S
//   in VMEM.  S lives in that warpgroup's accumulator registers for the
//   whole sequence (32 floats a thread); its bf16 hi and lo go to shared
//   memory once a chunk for (c).  Y = exp(cum_t) (C S^T) is scaled by rows
//   in registers before (b) accumulates onto it.
// - Thread 0 loads each chunk's x (64 x P), B and C (64 x N) tiles with TMA
//   (128-byte swizzled rows of 64 bf16 columns, as they lie in memory, views
//   included) into a two-stage ring, one mbarrier a stage: chunk c + 2's
//   loads start as soon as chunk c is done with its stage.  TMA fills rows
//   past S and columns past P or N with zeros; dt is 0 there, so they add
//   nothing.  The chunk's y goes out the same way: the block writes it,
//   rounded, into a swizzled tile, and thread 0 stores the tile with TMA,
//   which writes nothing past S or P.
// - The chain of chunks sets the time (one block an SM at B = 1), so each
//   chunk keeps four wgmma groups in flight behind each other, (a) G, (c),
//   (d) and then (b), and works beside them: (d)'s kdec x while (a) and
//   (c) run, W while (c) and (d) run, S's hi and lo while (b) runs.  The
//   y tile is double-buffered, so one block barrier a chunk does.  Warp 0
//   forms the next chunk's scan (cum, exp(cum), kdec) while (b) runs, from
//   dt (f32, plain loads) fetched a chunk ahead.  W's exponent is one
//   ex2.approx a value.
// - About 83 KB of shared memory a block: two blocks an SM.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kL = 64;                  // chunk length: the rows of a tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kTile = kL * kRowBytes;   // one 64 x 64 bf16 tile, 8 KB
constexpr int kStage = 3 * kTile;       // x, B, C
constexpr int kScalars = 4 * kL;        // cum, dt, exp(cum), kdec (floats)
constexpr float kLog2e = 1.4426950408889634f;   // exp(v) = ex2(v kLog2e)
// two stages, S hi and lo, y of two chunks, the scalars of two chunks, two
// mbarriers; + 1024 to align the tiles to the swizzle's period
constexpr int kSmem = 2 * kStage + 4 * kTile + 2 * kScalars * 4 + 16 + 1024;

// chunk c's x, B and C tiles into stage c % 2, completing its mbarrier
__device__ __forceinline__ void load_chunk(const CUtensorMap* tx,
                                           const CUtensorMap* tb,
                                           const CUtensorMap* tc,
                                           uint32_t base, uint32_t bar, int c,
                                           int h, int b) {
    const uint32_t st = base + (c & 1) * kStage, full = bar + 8 * (c & 1);
    mbar_expect(full, kStage);
    tma_load(st, tx, full, 0, h, c * kL, b);           // (P, H, S, B)
    tma_load(st + kTile, tb, full, 0, c * kL, b);      // (N, S, B)
    tma_load(st + 2 * kTile, tc, full, 0, c * kL, b);
}

// lane l's two steps 2l and 2l + 1 of chunk c's dt, zero past S
__device__ __forceinline__ void load_dt(const float* dg, long long sds,
                                        int c, int S, int lane, float& d0,
                                        float& d1) {
    const int s = c * kL + 2 * lane;
    d0 = s < S ? dg[static_cast<long long>(s) * sds] : 0.f;
    d1 = s + 1 < S ? dg[static_cast<long long>(s + 1) * sds] : 0.f;
}

// warp 0: a chunk's scalars from its dt, lane l holding steps 2l and 2l + 1,
// as two float4 a lane: {cum, dt} and {exp(cum), kdec} of both steps, where
// cum is the inclusive cumsum of -dt A; every exponent is <= 0
__device__ __forceinline__ void chunk_scalars(float4* sc, float d0, float d1,
                                              float A, int lane) {
    const float a0 = -d0 * A, a1 = -d1 * A;
    float v = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
    }
    const float c0 = v - a1, c1 = v;
    const float cl = __shfl_sync(0xffffffffu, v, 31);
    sc[lane] = make_float4(c0, c1, d0, d1);
    sc[32 + lane] = make_float4(ex2(c0 * kLog2e), ex2(c1 * kLog2e),
                                d0 * ex2((cl - c0) * kLog2e),
                                d1 * ex2((cl - c1) * kLog2e));
}

// a step's cum (k = 0) or exp(cum) (k = 2) from chunk_scalars' pairs
__device__ __forceinline__ float step_scalar(const float4* sc, int k, int t) {
    return reinterpret_cast<const float*>(sc + (k / 2) * 32 + t / 2)[t % 2];
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_c,
                 const __grid_constant__ CUtensorMap tm_y,
                 const float* __restrict__ dt, const float* __restrict__ A_log,
                 const float* __restrict__ Dv, int S, int H, long long sdb,
                 long long sds, long long sdh) {
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    uint8_t* const gb = smem_raw + (base - raw);  // base, as a plain pointer
    // stage s: x at base + s kStage, B at + kTile, C at + 2 kTile
    constexpr uint32_t kShi = 2 * kStage, kSlo = kShi + kTile;
    constexpr uint32_t kY = kSlo + kTile;         // chunk c's y at + kTile s
    float4* const scal = reinterpret_cast<float4*>(gb + kY + 2 * kTile);
    const uint32_t bar = base + kY + 2 * kTile + 2 * kScalars * 4;

    const int b = blockIdx.x / H, h = blockIdx.x % H;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;          // the thread's rows r0, r0 + 8
    const int rows[2] = {r0, r0 + 8};
    // the row whose address this lane gives stmatrix (row l % 8 of matrix
    // l / 8, matrices j at rows + 8 (j % 2))
    const int st_row = warp * 16 + 8 * (lane / 8 % 2) + lane % 8;
    const int cq = 2 * (lane % 4);                // its columns 8 m + cq (+ 1)
    const float A = expf(A_log[h]);
    const float Dh = Dv[h];
    const float* dg = dt + b * sdb + h * sdh;
    const int n_chunks = (S + kL - 1) / kL;

    if (tid == 0) {
        mbar_init(bar);
        mbar_init(bar + 8);
        mbar_init_fence();
        for (int c = 0; c < 2 && c < n_chunks; ++c)
            load_chunk(&tm_x, &tm_b, &tm_c, base, bar, c, h, b);
    }
    float nd0 = 0.f, nd1 = 0.f;                   // warp 0: the next dt
    if (warp == 0) {
        float d0, d1;
        load_dt(dg, sds, 0, S, lane, d0, d1);
        chunk_scalars(scal, d0, d1, A, lane);
        if (n_chunks > 1) load_dt(dg, sds, 1, S, lane, nd0, nd1);
    }
    for (int i = tid; i < 2 * kTile / 16; i += kThreads)   // S hi and lo
        reinterpret_cast<uint4*>(gb + kShi)[i] = make_uint4(0, 0, 0, 0);
    float st[32];                                 // S[p][n], accumulator layout
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = 0.f;
    fence_proxy_async();
    __syncthreads();

    // Per chunk, four wgmma groups in flight behind each other: (a) G; (c)
    // Y = C S^T; (d) S += (kdec x)^T B; (b) Y += W x.  kdec x is formed
    // while (a) and (c) run, W while (c) and (d) run, S's hi and lo and the
    // next chunk's scan while (b) runs.
    for (int c = 0; c < n_chunks; ++c) {
        const int s = c & 1;
        const uint32_t sx = base + s * kStage, sb = sx + kTile,
                       scc = sx + 2 * kTile;
        const float4* sc = scal + s * (kScalars / 4);
        mbar_wait(bar + 8 * s, (c >> 1) & 1);

        // S's decay, then (a) G = C B^T and (c) Y = C (S_hi + S_lo)^T
        const float decay = step_scalar(sc, 2, kL - 1);   // exp(cum_L)
        float g[32], yv[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            st[j] *= decay;
            g[j] = yv[j] = 0.f;
        }
        pin<32>(g);
        pin<32>(yv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64, 0, 0>(g, desc(scc + 32 * kk, 16, 1024),
                               desc(sb + 32 * kk, 16, 1024));
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t ca = desc(scc + 32 * kk, 16, 1024);
            wgmma_ss<64, 0, 0>(yv, ca, desc(base + kShi + 32 * kk, 16, 1024));
            wgmma_ss<64, 0, 0>(yv, ca, desc(base + kSlo + 32 * kk, 16, 1024));
        }
        wgmma_commit();

        // (d)'s A: x^T with x's rows i scaled by kdec_i, split, as A
        // fragments (ldmatrix.trans reads x's 8 x 8 blocks transposed:
        // matrix f holds rows p + 8 (f % 2), steps i + 8 (f / 2))
        uint32_t xhi[4][4], xlo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const int mq = lane / 8;              // the matrix this lane points at
            uint32_t xr[4];
            ldmatrix_x4_trans(xr, sx + swz(16 * kk + 8 * (mq / 2) + lane % 8,
                                           2 * warp + mq % 2));
#pragma unroll
            for (int f = 0; f < 4; ++f) {
                const float4 kd = sc[32 + (16 * kk + 8 * (f / 2) + cq) / 2];
                const float2 xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&xr[f]));
                split2(kd.z * xv.x, kd.w * xv.y, xhi[kk][f], xlo[kk][f]);
            }
        }

        // (d) S = exp(cum_L) S + (kdec x)^T B, B the MN-major operand
        pin<32>(st);
        pin<16>(&xhi[0][0]);
        pin<16>(&xlo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bk = desc(sb + 16 * kRowBytes * kk, kTile, 1024);
            wgmma_rs<64, 1>(st, xhi[kk], bk);
            wgmma_rs<64, 1>(st, xlo[kk], bk);
        }
        wgmma_commit();

        // W in registers once (a) is done, with the D x skip on its
        // diagonal, split into A fragments
        wgmma_wait<2>();
        pin<32>(g);
        const float cum_t[2] = {step_scalar(sc, 0, r0),
                                step_scalar(sc, 0, r0 + 8)};
        uint32_t whi[4][4], wlo[4][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) {             // columns 8 m + cq, + 1
            const int i = 8 * m + cq;
            const float4 cd = sc[i / 2];          // cum_i, cum_i+1, dt_i, dt_i+1
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int j = 4 * m + 2 * rr, t = rows[rr];
                const float w0 =
                    (i <= t ? ex2((cum_t[rr] - cd.x) * kLog2e) * g[j] * cd.z
                            : 0.f) + (i == t ? Dh : 0.f);
                const float w1 =
                    (i + 1 <= t
                         ? ex2((cum_t[rr] - cd.y) * kLog2e) * g[j + 1] * cd.w
                         : 0.f) + (i + 1 == t ? Dh : 0.f);
                // fragment f = 2 (m % 2) + rr of k-step m / 2
                split2(w0, w1, whi[m / 2][2 * (m % 2) + rr],
                       wlo[m / 2][2 * (m % 2) + rr]);
            }
        }

        // (b) Y = exp(cum_t) Y + (W_hi + W_lo) x once (c) is done
        wgmma_wait<1>();
        pin<32>(yv);
        const float et[2] = {step_scalar(sc, 2, r0),
                             step_scalar(sc, 2, r0 + 8)};
#pragma unroll
        for (int j = 0; j < 32; ++j) yv[j] *= et[(j / 2) % 2];
        pin<32>(yv);
        pin<16>(&whi[0][0]);
        pin<16>(&wlo[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t xk = desc(sx + 16 * kRowBytes * kk, kTile, 1024);
            wgmma_rs<64, 1>(yv, whi[kk], xk);
            wgmma_rs<64, 1>(yv, wlo[kk], xk);
        }
        wgmma_commit();

        // S's bf16 hi and lo for the next chunk's (c) once (d) is done:
        // rows p, n contiguous
        wgmma_wait<1>();
        pin<32>(st);
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
            // matrix j: rows + 8 (j % 2), columns 8 (m + j / 2) + cq
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                split2(st[4 * m + 2 * j], st[4 * m + 2 * j + 1], hi[j], lo[j]);
            const uint32_t off = swz(st_row, m + lane / 16);
            stmatrix_x4(base + kShi + off, hi);
            stmatrix_x4(base + kSlo + off, lo);
        }
        if (warp == 0) {                          // the next chunk's scan
            if (c + 1 < n_chunks)
                chunk_scalars(scal + (s ^ 1) * (kScalars / 4), nd0, nd1, A,
                              lane);
            if (c + 2 < n_chunks) load_dt(dg, sds, c + 2, S, lane, nd0, nd1);
        }

        // y, rounded once, into y tile s once (b) is done (chunk c - 2's
        // store from it has read it); TMA writes it out, nothing past S or P
        wgmma_wait<0>();
        pin<32>(yv);
#pragma unroll
        for (int m = 0; m < 8; m += 2) {
            uint32_t yb[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 v = __floats2bfloat162_rn(
                    yv[4 * m + 2 * j], yv[4 * m + 2 * j + 1]);
                yb[j] = *reinterpret_cast<const uint32_t*>(&v);
            }
            stmatrix_x4(base + kY + kTile * s + swz(st_row, m + lane / 16),
                        yb);
        }
        fence_proxy_async();
        if (tid == 0) bulk_wait_read();           // chunk c - 1's y is read
        __syncthreads();                          // stage s, S and y are done
        if (tid == 0) {
            tma_store(&tm_y, base + kY + kTile * s, 0, h, c * kL, b);
            bulk_commit();
            if (c + 2 < n_chunks)
                load_chunk(&tm_x, &tm_b, &tm_c, base, bar, c + 2, h, b);
        }
    }
    if (tid == 0) bulk_wait();
}

}  // namespace

// The bf16 form, called by mamba2_ssd.cu's entry point: P and N at most 64;
// x, B and C bf16 with a contiguous last axis, 16-byte aligned, every other
// stride a multiple of 8 elements (the wrapper copies what is not); strides
// as mamba2_ssd_launch takes them; y contiguous (B, S, H, P rounded up to 8),
// 16-byte aligned.  Returns the CUDA error of the launch, or
// -(a CUresult) when a tensor map cannot be made.
int mamba2_ssd_wgmma_launch(const void* x, const void* dt, const void* A_log,
                            const void* Bm, const void* Cm, const void* D,
                            void* y, int B, int S, int H, int P, int N,
                            const long long* st, cudaStream_t stream) {
    using u64 = cuuint64_t;
    CUtensorMap tx, tb, tc, ty;
    const u64 xd[4] = {u64(P), u64(H), u64(S), u64(B)};
    const u64 xs[3] = {u64(st[2]) * 2, u64(st[1]) * 2, u64(st[0]) * 2};
    const cuuint32_t xbox[4] = {64, 1, kL, 1};
    const u64 nd[3] = {u64(N), u64(S), u64(B)};
    const u64 bs[2] = {u64(st[7]) * 2, u64(st[6]) * 2};
    const u64 cs[2] = {u64(st[9]) * 2, u64(st[8]) * 2};
    const cuuint32_t nbox[3] = {64, kL, 1};
    int err = make_map_bf16(&tx, x, 4, xd, xs, xbox);
    if (err == 0) err = make_map_bf16(&tb, Bm, 3, nd, bs, nbox);
    if (err == 0) err = make_map_bf16(&tc, Cm, 3, nd, cs, nbox);
    // y: contiguous (B, S, H, PY), PY = P rounded up to 8 (the wrapper
    // allocates it so), of which TMA writes the first P columns
    const u64 yb = u64((P + 7) / 8 * 8) * 2;
    const u64 ys[3] = {yb, yb * H, yb * H * S};
    if (err == 0) err = make_map_bf16(&ty, y, 4, xd, ys, xbox);
    if (err != 0) return err;
    const cudaError_t set = cudaFuncSetAttribute(
        ssd_kernel_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (set != cudaSuccess) return static_cast<int>(set);
    ssd_kernel_wgmma<<<B * H, kThreads, kSmem, stream>>>(
        tx, tb, tc, ty, static_cast<const float*>(dt),
        static_cast<const float*>(A_log), static_cast<const float*>(D), S, H,
        st[3], st[4], st[5]);
    return static_cast<int>(cudaGetLastError());
}
