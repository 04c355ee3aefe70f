// mamba2_ssd_bwd: the gradient of the chunked Mamba-2 SSD scan with respect
// to all six inputs.  CUDA C++ for sm_90a, built with nvcc into a shared
// library of its own with a plain C entry point
// (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/mamba2_ssd/ops.py, ssd_bwd and SSDFn).  This file
// holds the C entry point, which sends every bf16 call to the tensor-core
// form (mamba2_ssd_bwd_wgmma.cu) and every f32 call to the CUDA-core form
// below, with no fallback.
//
// Replaces no pallas_call: the JAX package's gradient of the SSD is XLA's
// autodiff of src/repro/models/mamba2.py::ssd_chunked, and that is what this
// kernel is held to (tests/test_torch_ssd_bwd.py on the CPU, through its
// plain version ref.ssd_bwd_torch).  It computes, for x (B, S, H, P), dt
// (B, S, H) f32, B and C (B, S, N) shared by the H heads of a batch row,
// A_log and D (H,) f32, and dy (B, S, H, P), per head over chunks of L = 64
// steps (la = -dt exp(A_log), cum its inclusive cumsum over the chunk,
// W[t, i] = exp(cum_t - cum_i) (C_t . B_i) dt_i for i <= t, kdec_i = dt_i
// exp(cum_L - cum_i), S_c the state entering chunk c, dS the gradient of the
// state leaving it):
//   y_state:  dC_t += exp(cum_t) dy_t S_c;  dcum_t += C_t . that
//             dS_c += sum_t exp(cum_t) dy_t^T C_t
//   y_intra:  dW = dy x^T (i <= t);  dx += W^T dy
//             dcb = dW exp(cum_t - cum_i) dt_i:  dC += dcb B,  dB += dcb^T C
//             M = dW exp(cum_t - cum_i) (C_t . B_i):  ddt_i += sum_t M,
//             dcum_t += sum_{i<t} M dt_i,  dcum_i -= sum_{t>i} M dt_i
//   state:    dS_c += exp(cum_L) dS;  dx_i += kdec_i B_i dS^T;
//             dB_i += kdec_i x_i dS;  dk_i = B_i . (x_i dS)
//             ddt_i += dk_i exp(cum_L - cum_i);  dcum_i -= dk_i kdec_i (i < L)
//             dcum_L += sum_{i<L} dk_i kdec_i + exp(cum_L) sum(dS * S_c)
// (M's diagonal and the last step's dk kdec would enter dcum twice with
// opposite signs; both are left out, as in the plain version, since in f32
// the two roundings would not cancel and la amplifies the rest.)
//   dla = reverse cumsum of dcum;  ddt += -exp(A_log) dla;
//   dA_log += sum dla la;  dD += sum dy x;  dx += D dy
// Every exponent is <= 0 where it is used (exp(cum_t - cum_i) only for
// i <= t).  The ragged final chunk is masked in the kernel: zeros staged
// past the end (dt = 0 there, so cum stays flat and nothing is added) and
// no row written past S.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes in bf16,
// operations in f32.  At zamba2-2.7b's training shape (B = 4, S = 2048,
// H = 80, P = N = 64) the gradient needs 32.4 GFLOP of products (causal
// where it can be, C B^T and dcb's products once per batch row;
// chip_smoke.py's ssd_bwd_bound), 0.033 ms at bf16's tensor-core peak and
// 0.48 ms at the 67 TFLOP/s of f32, against 0.26 GB of inputs and
// gradients in bf16, 0.078 ms at 3.35 TB/s.  This kernel issues ten full
// 64^3 products per (batch, head, chunk), 53.7 GFLOP.
//
// What the design does about it: this form is simple, right and
// deterministic, on the CUDA cores (it took bf16 too until the tensor-core
// form replaced it there: 5.408 ms at zamba2's bf16 shape on an H100 SXM
// at 700 W, 9.9 TFLOP/s, 0 HGMMA).  One block of 256 threads owns one (batch, head), as the forward
// does, and makes two sweeps over its chunks:
//   1. forward: recompute the state entering each chunk, S_c (f32, P x N),
//      and write it to a scratch in device memory (168 MB at the training
//      shape), one 64^3 product a chunk;
//   2. reverse: carry dS in shared memory from the last chunk to the first;
//      per chunk nine 64^3 products, each thread holding a 4 x 4 block of a
//      64 x 64 result in registers, the row sums by half-warp shuffles.
// The reductions across blocks (dB and dC over the heads, dA_log and dD over
// the batch) are written as per-block partials and summed in a fixed order
// by a second kernel: no atomics, so two calls give the same bits.  x, B and
// C are read with their own strides (the model hands in views of the conv
// output); dy, dx, ddt, dB and dC are contiguous.  Nine 64 x 65 f32 tiles,
// about 152 KB of shared memory a block (over the 48 KB default, so the
// launch opts in), one block to an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

// the bf16 form (mamba2_ssd_bwd_wgmma.cu)
long long mamba2_ssd_bwd_wgmma_scratch_floats(int B, int S, int H);
int mamba2_ssd_bwd_wgmma_launch(const void* x, const void* dt,
                                const void* A_log, const void* Bm,
                                const void* Cm, const void* D, const void* dy,
                                void* dx, void* ddt, void* dA_log, void* dB,
                                void* dC, void* dD, void* scratch, int B,
                                int S, int H, int P, int N,
                                const long long* st, cudaStream_t stream);

namespace {

constexpr int kL = 64;            // chunk length
constexpr int kMaxPN = 64;        // the widest head (P) and state (N)
constexpr int kLD = kMaxPN + 1;   // row stride of every staged tile
constexpr int kThreads = 256;     // 16 x 16 threads over a 64 x 64 product
constexpr int kWarps = kThreads / 32;
constexpr size_t kTile = static_cast<size_t>(kL) * kLD;
static_assert(kL == kMaxPN, "the tiles are square");
// Xs, Bs, Cs, Ys (dy), Ss (S_c), Gs (dS), Ws (W), Ds (dcb), Ms (M); then
// dts, cum, ecum, dec, dcum, colM, rowM, dk (kL each) and red (kWarps)
constexpr int kTiles = 9;
constexpr int kVecs = 8;
constexpr size_t kSmemBytes =
    (kTiles * kTile + kVecs * kL + kWarps) * sizeof(float);
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// cum = inclusive cumsum of la = -dt A over the chunk: warp 0, lane l holds
// steps 2l and 2l + 1 (the forward's scan)
__device__ __forceinline__ void chunk_cum(const float* dts, float* cum,
                                          float A, int tid) {
    if (tid < 32) {
        const float a0 = -dts[2 * tid] * A;
        const float a1 = -dts[2 * tid + 1] * A;
        float v = a0 + a1;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float u = __shfl_up_sync(0xffffffffu, v, o);
            if (tid >= o) v += u;
        }
        cum[2 * tid + 1] = v;
        cum[2 * tid] = v - a1;
    }
}

// the sum of v over the 16 lanes of a half-warp (a row of the 16 x 16
// thread grid), in every one of them
__device__ __forceinline__ float row_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    return row_sum(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A_log, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               const T* __restrict__ dy, T* __restrict__ dx,
               float* __restrict__ ddt, float* __restrict__ dBp,
               float* __restrict__ dCp, float* __restrict__ dAp,
               float* __restrict__ dDp, float* __restrict__ states, int S,
               int H, int P, int N, long long sxb, long long sxs,
               long long sxh, long long sdb, long long sds, long long sdh,
               long long sbb, long long sbs, long long scb, long long scs) {
    extern __shared__ float smem[];
    float* Xs = smem;                 // x[t][p]
    float* Bs = Xs + kTile;           // B[i][n]
    float* Cs = Bs + kTile;           // C[t][n]
    float* Ys = Cs + kTile;           // dy[t][p]
    float* Ss = Ys + kTile;           // S_c[p][n], then the carried state
    float* Gs = Ss + kTile;           // dS[p][n], carried across chunks
    float* Ws = Gs + kTile;           // W[t][i]
    float* Ds = Ws + kTile;           // dcb[t][i]
    float* Ms = Ds + kTile;           // M[t][i]
    float* dts = Ms + kTile;
    float* cum = dts + kL;
    float* ecum = cum + kL;           // exp(cum_t)
    float* dec = ecum + kL;           // exp(cum_L - cum_t) (sweep 1: kdec)
    float* dcum = dec + kL;           // the y_state part of dcum
    float* colM = dcum + kL;          // sum_{t>i} M[t][i]
    float* rowM = colM + kL;          // sum_{i<t} M[t][i] dt_i
    float* dkv = rowM + kL;           // dk_i
    float* red = dkv + kL;            // one partial sum a warp

    const int b = blockIdx.x / H;
    const int h = blockIdx.x % H;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int ty = tid >> 4;          // rows ty, ty + 16, ty + 32, ty + 48
    const int tx = tid & 15;          // columns tx, tx + 16, tx + 32, tx + 48
    const float A = expf(A_log[h]);
    const float Dh = Dv[h];
    const T* xg = x + b * sxb + h * sxh;
    const float* dg = dt + b * sdb + h * sdh;
    const T* bg = Bm + b * sbb;
    const T* cg = Cm + b * scb;
    const size_t row = static_cast<size_t>(H) * P;      // dy's and dx's step
    const T* yg = dy + static_cast<size_t>(b) * S * row
                  + static_cast<size_t>(h) * P;
    T* xog = dx + static_cast<size_t>(b) * S * row
             + static_cast<size_t>(h) * P;
    float* tog = ddt + static_cast<size_t>(b) * S * H + h;
    const size_t part = static_cast<size_t>(blockIdx.x) * S * N;
    float* bog = dBp + part;
    float* cog = dCp + part;
    const int n_chunks = (S + kL - 1) / kL;
    const size_t PN = static_cast<size_t>(P) * N;
    float* sg = states + static_cast<size_t>(blockIdx.x) * n_chunks * PN;

    // chunk c's x, B, C, dy (the last two only when asked) and dt, zero past
    // the end and past P and N
    auto stage = [&](int s0, int len, bool grads) {
        for (int idx = tid; idx < kL * kMaxPN; idx += kThreads) {
            const int t = idx / kMaxPN, k = idx % kMaxPN;
            float xv = 0.f, bv = 0.f, cv = 0.f, yv = 0.f;
            if (t < len) {
                const long long s = s0 + t;
                if (k < P) {
                    xv = ld(xg + s * sxs + k);
                    if (grads) yv = ld(yg + s * row + k);
                }
                if (k < N) {
                    bv = ld(bg + s * sbs + k);
                    if (grads) cv = ld(cg + s * scs + k);
                }
            }
            Xs[t * kLD + k] = xv;
            Bs[t * kLD + k] = bv;
            if (grads) {
                Cs[t * kLD + k] = cv;
                Ys[t * kLD + k] = yv;
            }
        }
        if (tid < kL)
            dts[tid] = tid < len ? dg[static_cast<long long>(s0 + tid) * sds]
                                 : 0.f;
    };

    // ---- sweep 1: the state entering each chunk -------------------------
    for (int i = tid; i < static_cast<int>(kTile); i += kThreads) Ss[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
        stage(s0, len, false);
        __syncthreads();
        chunk_cum(dts, cum, A, tid);
        __syncthreads();
        const float cum_last = cum[kL - 1];
        if (tid < kL) dec[tid] = dts[tid] * expf(cum_last - cum[tid]);
        __syncthreads();
        float acc[4][4] = {};
        if (c < n_chunks - 1) {       // the last chunk's update is not needed
            for (int i = 0; i < kL; ++i) {
                const float kd = dec[i];                            // kdec_i
                float xv[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    xv[r] = Xs[i * kLD + ty + 16 * r] * kd;
#pragma unroll
                for (int q = 0; q < 4; ++q) bv[q] = Bs[i * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] += xv[r] * bv[q];
            }
        }
        const float decay = expf(cum_last);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int p = ty + 16 * r, n = tx + 16 * q;
                if (p < P && n < N) {
                    const float s = Ss[p * kLD + n];
                    sg[c * PN + p * N + n] = s;
                    Ss[p * kLD + n] = s * decay + acc[r][q];
                }
            }
    }

    // ---- sweep 2: the gradients, carrying dS backwards -------------------
    for (int i = tid; i < static_cast<int>(kTile); i += kThreads) Gs[i] = 0.f;
    float dd = 0.f;                   // this thread's share of dD
    float da = 0.f;                   // warp 0: its lanes' share of dA_log
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
        stage(s0, len, true);
        for (int idx = tid; idx < kMaxPN * kMaxPN; idx += kThreads) {
            const int p = idx / kMaxPN, n = idx % kMaxPN;
            Ss[p * kLD + n] = p < P && n < N ? sg[c * PN + p * N + n] : 0.f;
        }
        __syncthreads();
        chunk_cum(dts, cum, A, tid);
        __syncthreads();
        const float cum_last = cum[kL - 1];
        if (tid < kL) {
            ecum[tid] = expf(cum[tid]);
            dec[tid] = expf(cum_last - cum[tid]);             // <= 0
        }

        // cb = C B^T and dW = dy x^T; then W, dcb and M for i <= t
        {
            float cb[4][4] = {}, dw[4][4] = {};
            for (int n = 0; n < N; ++n) {
                float cv[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLD + n];
#pragma unroll
                for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * kLD + n];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) cb[r][q] += cv[r] * bv[q];
            }
            for (int p = 0; p < P; ++p) {
                float yv[4], xv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) yv[r] = Ys[(ty + 16 * r) * kLD + p];
#pragma unroll
                for (int q = 0; q < 4; ++q) xv[q] = Xs[(tx + 16 * q) * kLD + p];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) dw[r][q] += yv[r] * xv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int t = ty + 16 * r, i = tx + 16 * q;
                    float w = 0.f, dcb = 0.f, m = 0.f;
                    if (i <= t) {
                        const float g = expf(cum[t] - cum[i]);
                        w = g * cb[r][q] * dts[i];
                        dcb = dw[r][q] * g * dts[i];
                        m = dw[r][q] * g * cb[r][q];
                    }
                    Ws[t * kLD + i] = w;
                    Ds[t * kLD + i] = dcb;
                    Ms[t * kLD + i] = m;
                }
        }
        __syncthreads();

        // M's column sums (ddt_i, dcum_i) and its row sums weighted by dt_i
        // (dcum_t), both without the diagonal; read after the barrier
        // before the dS update
        if (tid < kL) {
            float s = 0.f;
            for (int t = tid + 1; t < kL; ++t) s += Ms[t * kLD + tid];
            colM[tid] = s;
        } else if (tid < 2 * kL) {
            const int t = tid - kL;
            float s = 0.f;
            for (int i = 0; i < t; ++i) s += Ms[t * kLD + i] * dts[i];
            rowM[t] = s;
        }

        // dx[i][p] = (W^T dy)[i][p] + kdec_i (B dS^T)[i][p] + D dy[i][p]
        {
            float a1[4][4] = {}, a2[4][4] = {};
            for (int t = 0; t < kL; ++t) {
                float wv[4], yv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) wv[r] = Ws[t * kLD + ty + 16 * r];
#pragma unroll
                for (int q = 0; q < 4; ++q) yv[q] = Ys[t * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a1[r][q] += wv[r] * yv[q];
            }
            for (int n = 0; n < N; ++n) {
                float bv[4], gv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) bv[r] = Bs[(ty + 16 * r) * kLD + n];
#pragma unroll
                for (int q = 0; q < 4; ++q) gv[q] = Gs[(tx + 16 * q) * kLD + n];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a2[r][q] += bv[r] * gv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ty + 16 * r;
                const float kd = dts[i] * dec[i];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int p = tx + 16 * q;
                    const float yv = Ys[i * kLD + p];
                    dd += yv * Xs[i * kLD + p];
                    if (i < len && p < P)
                        st(xog + static_cast<size_t>(s0 + i) * row + p,
                           a1[r][q] + kd * a2[r][q] + Dh * yv);
                }
            }
        }

        // dC[t][n] = exp(cum_t) (dy S_c)[t][n] + (dcb B)[t][n], and the
        // y_state part of dcum_t = C_t . exp(cum_t) (dy S_c)_t
        {
            float a1[4][4] = {}, a2[4][4] = {};
            for (int p = 0; p < P; ++p) {
                float yv[4], sv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) yv[r] = Ys[(ty + 16 * r) * kLD + p];
#pragma unroll
                for (int q = 0; q < 4; ++q) sv[q] = Ss[p * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a1[r][q] += yv[r] * sv[q];
            }
            for (int i = 0; i < kL; ++i) {
                float dv[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) dv[r] = Ds[(ty + 16 * r) * kLD + i];
#pragma unroll
                for (int q = 0; q < 4; ++q) bv[q] = Bs[i * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a2[r][q] += dv[r] * bv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int t = ty + 16 * r;
                float part_t = 0.f;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int n = tx + 16 * q;
                    const float ds = ecum[t] * a1[r][q];
                    part_t += Cs[t * kLD + n] * ds;
                    if (t < len && n < N)
                        cog[static_cast<size_t>(s0 + t) * N + n] =
                            ds + a2[r][q];
                }
                part_t = row_sum(part_t);
                if (tx == 0) dcum[t] = part_t;
            }
        }

        // dB[i][n] = (dcb^T C)[i][n] + kdec_i (x dS)[i][n], and
        // dk_i = B_i . (x dS)_i
        {
            float a1[4][4] = {}, a2[4][4] = {};
            for (int t = 0; t < kL; ++t) {
                float dv[4], cv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) dv[r] = Ds[t * kLD + ty + 16 * r];
#pragma unroll
                for (int q = 0; q < 4; ++q) cv[q] = Cs[t * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a1[r][q] += dv[r] * cv[q];
            }
            for (int p = 0; p < P; ++p) {
                float xv[4], gv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) xv[r] = Xs[(ty + 16 * r) * kLD + p];
#pragma unroll
                for (int q = 0; q < 4; ++q) gv[q] = Gs[p * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) a2[r][q] += xv[r] * gv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ty + 16 * r;
                const float kd = dts[i] * dec[i];
                float part_i = 0.f;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int n = tx + 16 * q;
                    part_i += Bs[i * kLD + n] * a2[r][q];
                    if (i < len && n < N)
                        bog[static_cast<size_t>(s0 + i) * N + n] =
                            a1[r][q] + kd * a2[r][q];
                }
                part_i = row_sum(part_i);
                if (tx == 0) dkv[i] = part_i;
            }
        }
        __syncthreads();              // every read of dS for this chunk is done

        // dS <- exp(cum_L) dS + sum_t exp(cum_t) dy_t^T C_t, and the sum of
        // dS * S_c (with dS still the state leaving the chunk)
        {
            float acc[4][4] = {};
            for (int t = 0; t < kL; ++t) {
                const float e = ecum[t];
                float yv[4], cv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    yv[r] = Ys[t * kLD + ty + 16 * r] * e;
#pragma unroll
                for (int q = 0; q < 4; ++q) cv[q] = Cs[t * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] += yv[r] * cv[q];
            }
            const float decay = expf(cum_last);
            float sds = 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int p = ty + 16 * r, n = tx + 16 * q;
                    if (p < P && n < N) {
                        const float g = Gs[p * kLD + n];
                        sds += g * Ss[p * kLD + n];
                        Gs[p * kLD + n] = g * decay + acc[r][q];
                    }
                }
            sds = warp_sum(sds);
            if (lane == 0) red[warp] = sds;
        }
        __syncthreads();

        // warp 0: dcum, then dla (its reverse cumsum), ddt and dA_log; lane
        // l holds steps 2l and 2l + 1
        if (warp == 0) {
            float dc[2], kdk = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int t = 2 * lane + j;
                const float kk = t < kL - 1 ? dkv[t] * dts[t] * dec[t] : 0.f;
                dc[j] = dcum[t] + rowM[t] - dts[t] * colM[t] - kk;
                kdk += kk;
            }
            kdk = warp_sum(kdk);
            if (lane == 31) {
                float sds = 0.f;
                for (int w = 0; w < kWarps; ++w) sds += red[w];
                dc[1] += kdk + expf(cum_last) * sds;
            }
            // suffix sums over the lanes' pairs
            float v = dc[0] + dc[1];
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const float u = __shfl_down_sync(0xffffffffu, v, o);
                if (lane + o < 32) v += u;
            }
            const float dla[2] = {v, v - dc[0]};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int t = 2 * lane + j;
                da += dla[j] * (-dts[t] * A);
                if (t < len)
                    tog[static_cast<size_t>(s0 + t) * H] =
                        colM[t] + Ms[t * kLD + t] + dkv[t] * dec[t]
                        - A * dla[j];
            }
        }
    }

    // the block's partials of dD and dA_log
    __syncthreads();                  // warp 0 has read red
    dd = warp_sum(dd);
    if (lane == 0) red[warp] = dd;
    da = warp_sum(da);                // warp 0's is the block's
    __syncthreads();
    if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w];
        dDp[blockIdx.x] = s;
        dAp[blockIdx.x] = da;
    }
}

// out[a][j] = sum over k < K of in[a][k][j], k in order (j < inner): the
// per-block partials summed with no atomics, so the bits repeat
template <typename T>
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ in, T* __restrict__ out,
                 long long outer, long long inner, int K) {
    const long long total = outer * inner;
    for (long long o = blockIdx.x * 256LL + threadIdx.x; o < total;
         o += static_cast<long long>(gridDim.x) * 256) {
        const long long a = o / inner, j = o % inner;
        const float* p = in + a * K * inner + j;
        float s = 0.f;
        for (int k = 0; k < K; ++k) s += p[k * inner];
        st(out + o, s);
    }
}

template <typename T>
int sum_parts(const float* in, T* out, long long outer, long long inner,
              int K, cudaStream_t stream) {
    const long long total = outer * inner;
    const int blocks = static_cast<int>(
        total / 256 + 1 < 8192 ? total / 256 + 1 : 8192);
    sum_parts_kernel<T><<<blocks, 256, 0, stream>>>(in, out, outer, inner, K);
    return static_cast<int>(cudaGetLastError());
}

// the scratch: the chunks' entry states, then the dB and dC partials (one
// per block, S x N each), then the dA_log and dD partials (one per block)
long long scratch_floats(int B, int S, int H, int P, int N) {
    const long long blocks = static_cast<long long>(B) * H;
    const long long n_chunks = (S + kL - 1) / kL;
    return blocks * (n_chunks * P * N + 2LL * S * N + 2);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, const void* D, const void* dy, void* dx, void* ddt,
           void* dA_log, void* dB, void* dC, void* dD, void* scratch, int B,
           int S, int H, int P, int N, const long long* sv,
           cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(B) * H;
    const long long n_chunks = (S + kL - 1) / kL;
    float* states = static_cast<float*>(scratch);
    float* dBp = states + blocks * n_chunks * P * N;
    float* dCp = dBp + blocks * S * N;
    float* dAp = dCp + blocks * S * N;
    float* dDp = dAp + blocks;
    ssd_bwd_kernel<T><<<static_cast<int>(blocks), kThreads, kSmemBytes,
                        stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A_log), static_cast<const T*>(Bm),
        static_cast<const T*>(Cm), static_cast<const float*>(D),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(ddt), dBp, dCp, dAp, dDp, states, S, H, P, N,
        sv[0], sv[1], sv[2], sv[3], sv[4], sv[5], sv[6], sv[7], sv[8], sv[9]);
    int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    // dB, dC: (B, H, S, N) partials summed over H; dA_log, dD: (B, H) over B
    const long long SN = static_cast<long long>(S) * N;
    if ((e = sum_parts(dBp, static_cast<T*>(dB), B, SN, H, stream))) return e;
    if ((e = sum_parts(dCp, static_cast<T*>(dC), B, SN, H, stream))) return e;
    if ((e = sum_parts(dAp, static_cast<float*>(dA_log), 1, H, B, stream)))
        return e;
    return sum_parts(dDp, static_cast<float*>(dD), 1, H, B, stream);
}

}  // namespace

// The f32 scratch (in floats) the backward needs for these sizes, by dtype
// as mamba2_ssd_bwd_launch takes it.
extern "C" long long mamba2_ssd_bwd_scratch_floats(int dtype, int B, int S,
                                                   int H, int P, int N) {
    return dtype == 1 ? mamba2_ssd_bwd_wgmma_scratch_floats(B, S, H)
                      : scratch_floats(B, S, H, P, N);
}

// dtype 0: x, B, C, dy, dx, dB, dC in f32 (the CUDA-core form); 1: in bf16
// (the tensor-core form).  dt, A_log and D are f32 (A_log and D
// contiguous); ddt (B, S, H), dA_log and dD (H,) come out in f32.  strides
// (in elements): x's batch, step and head; dt's batch, step and head; B's
// batch and step; C's batch and step; dy's batch, step and head (the last
// axis of each is contiguous; the f32 form takes dy contiguous).  dx, ddt,
// dB and dC are contiguous.  scratch holds mamba2_ssd_bwd_scratch_floats
// floats.  Returns a cudaError_t code, 0 on success, or -(a CUresult) when
// the bf16 form cannot make a tensor map.
extern "C" int mamba2_ssd_bwd_launch(const void* x, const void* dt,
                                     const void* A_log, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* dy, void* dx, void* ddt,
                                     void* dA_log, void* dB, void* dC,
                                     void* dD, void* scratch, int dtype, int B,
                                     int S, int H, int P, int N,
                                     const long long* strides, void* stream) {
    if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || P > kMaxPN ||
        N > kMaxPN)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(x, dt, A_log, Bm, Cm, D, dy, dx, ddt, dA_log, dB,
                             dC, dD, scratch, B, S, H, P, N, strides, s);
    if (dtype == 1)
        return mamba2_ssd_bwd_wgmma_launch(x, dt, A_log, Bm, Cm, D, dy, dx,
                                           ddt, dA_log, dB, dC, dD, scratch,
                                           B, S, H, P, N, strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
