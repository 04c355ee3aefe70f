// rwkv6 wkv6_bwd: the gradient of the chunked RWKV-6 WKV with respect to r,
// k, v, log_w and u.  CUDA C++ for sm_90a, built with nvcc into a shared
// library of its own with a plain C entry point
// (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/rwkv6/ops.py, wkv6_bwd and WKV6Fn).  This file holds
// the C entry point, which sends every bf16 call to the tensor-core form
// (wkv6_bwd_wgmma.cu) and every f32 call to the CUDA-core form below, with
// no fallback.
//
// Replaces no pallas_call: the JAX package's gradient of the WKV is XLA's
// autodiff of src/repro/models/rwkv6.py::wkv6_chunked, and that is what this
// kernel is held to (tests/test_torch_wkv_bwd.py on the CPU, through its
// plain version ref.wkv6_bwd_torch).  It computes, for r, k, v, do
// (B, S, H, K), log_w (B, S, H, K) f32 and <= 0, u (H, K) f32, per (batch,
// head) over chunks of L = 32 steps (cum the inclusive cumsum of log_w over
// the chunk, cum_ex = cum - log_w, E[t, i, d] = exp(cum_ex_t[d] - cum_i[d])
// for i < t, A[t, i] = sum_d r_t k_i E, kdec_i = k_i exp(cum_L - cum_i),
// beta_t = sum_d r_t u k_t, S_c the (K, K) state entering chunk c, dS the
// gradient of the state leaving it):
//   o_state:  dr_t += exp(cum_ex_t) (do_t S_c^T);  dS_c += sum_t
//             (r_t exp(cum_ex_t)) do_t^T
//   A v:      dA = do v^T (i < t);  dv += A^T do
//             dr_t += sum_i dA[t, i] k_i E[t, i];  dk_i += sum_t dA[t, i]
//             r_t E[t, i]
//   bonus:    dbeta_t = do_t . v_t;  dv_t += beta_t do_t;  dr_t += dbeta_t u
//             k_t;  dk_t += dbeta_t u r_t;  du += sum dbeta_t r_t k_t
//   state:    dS_c += diag(exp(cum_L)) dS;  dv_i += kdec_i dS;
//             dkdec_i = v_i dS^T;  dk_i += exp(cum_L - cum_i) dkdec_i
//   dcum_ex_t = r_t * (the o_state and A v terms of dr_t)
//   dcum_i    = -k_i * (the A v term of dk_i) - kdec_i dkdec_i  (i < L)
//   dcum_L   += sum_{i<L} kdec_i dkdec_i + exp(cum_L) sum_c S_c dS
//   dlog_w_s  = sum_{t >= s} dcum_t + sum_{t > s} dcum_ex_t
// (the last step's kdec dkdec would enter dcum_L twice with opposite signs;
// it is left out of both, as in the plain version, since in f32 the two
// roundings would not cancel.)
// As in the forward (wkv6.cu), E is evaluated per (t, i, d) and only where
// i < t: with log_w >= -8 a chunk's cum reaches -256, so factoring E as
// exp(cum_ex_t) exp(-cum_i) overflows f32; every exponent here is <= 0.
// The ragged final chunk is masked in the kernel: zeros staged past the end
// (log_w = 0 there, so cum stays flat, and r, k, v, do add nothing) and no
// row written past S.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): bytes, then exps.  At
// rwkv6-1.6b's training shape (B = 4, S = 2048, H = 32, K = 64) the gradient
// needs about 13.5 GFLOP of products (chip_smoke.py's wkv_bwd_bound) and
// three L (L - 1) / 2 K exps per chunk and head (A again, and the two E
// sums), 0.014 ms at bf16's tensor-core peak (0.20 ms in f32 at 67
// TFLOP/s), against 0.37 GB of inputs and gradients (bf16 r, k, v, do and
// their gradients, f32 log_w and its gradient), 0.11 ms at 3.35 TB/s.
//
// What the design does about it: this form is simple, right and
// deterministic, on the CUDA cores (it runs the f32 calls; bf16 ones go to
// wkv6_bwd_wgmma.cu; every sum is f32).  One block of
// 256 threads owns one (batch, head) and all K value columns, so no sum of
// dr, dk or dlog_w crosses blocks, and makes two sweeps over its chunks:
//   1. forward: recompute the state entering each chunk, S_c (f32, K x K),
//      and write it to a scratch in device memory (134 MB at the training
//      shape);
//   2. reverse: carry dS in shared memory from the last chunk to the first.
//      Per chunk: A and dA by 8 lanes a row (A's sum over d per (t, i, d),
//      with each warp's loop cut at its rows' diagonal); then the (t, d)
//      results (dr, dk, dv, dcum, dcum_ex) by one thread a channel and 8 of
//      the 32 rows, the E sums per (t, i, d); then dS and, one thread a
//      channel, the reverse scans that give dlog_w.
// cum is kept in log2 units (log_w scaled by log2 e as it is staged), so
// each exp is one exp2f.  du's sum over the batch is written as per-block
// partials and summed in a fixed order by a second kernel: no atomics, so two
// calls give the same bits.  r, k, v and log_w are read with their own
// strides (the model hands in views of the projections); do, dr, dk, dv and
// dlog_w are contiguous.  About 119 KB of shared memory a block (over the
// 48 KB default, so the launch opts in).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

// the bf16 form (wkv6_bwd_wgmma.cu)
long long wkv6_bwd_wgmma_scratch_floats(int B, int S, int H);
int wkv6_bwd_wgmma_launch(const void* r, const void* k, const void* v,
                          const void* log_w, const void* u, const void* dout,
                          void* dr, void* dk, void* dv, void* dlog_w,
                          void* du, void* scratch, int B, int S, int H, int K,
                          const long long* strides, cudaStream_t stream);

namespace {

constexpr int kL = 32;            // chunk length
constexpr int kMaxK = 64;         // the widest head
constexpr int kLD = kMaxK + 1;    // row stride of the (., K) tiles
constexpr int kALD = kL + 1;      // row stride of A and dA
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kMaxK;     // row groups of the (t, d) map
constexpr int kRows = kL / kGroups;           // rows a thread there
static_assert(kGroups * kRows == kL, "uneven rows");
constexpr size_t kLT = static_cast<size_t>(kL) * kLD;        // an (L, K) tile
constexpr size_t kKT = static_cast<size_t>(kMaxK) * kLD;     // a (K, K) tile
constexpr size_t kAT = static_cast<size_t>(kL) * kALD;       // an (L, L) tile
// Rs, Ks, Vs, Os (do), Es (exp(cum_L - cum_i)), RE (r exp(cum_ex)), DC
// (dcum), DX (dcum_ex): (L, K) tiles; Cz ((L + 1), K); Ss, Gs: (K, K);
// As, dAs: (L, L); then Us, sds (K each), part (kGroups x K), beta, dbeta
// (L each)
constexpr size_t kSmemBytes =
    (8 * kLT + (kL + 1) * kLD + 2 * kKT + 2 * kAT + 2 * kMaxK
     + kGroups * kMaxK + 2 * kL) * sizeof(float);
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can use");
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

// Columns i = ai + 8 j (j < J) of row `at` of A (strictly below the
// diagonal, zero elsewhere) into acc.  Cz holds cum in log2 units, Cz[t] =
// cum_{t-1}.  A warp's rows reach its diagonal in its first J groups of 8
// columns, so each warp calls this with its own J: no lane branches inside
// the loop (the forward's a_row, without its approximate exp).
template <int J>
__device__ __forceinline__ void a_row(const float* Rs, const float* Ks,
                                      const float* Cz, int at, int ai, int K,
                                      float (&acc)[4]) {
    const float* rrow = Rs + at * kLD;
    const float* crow = Cz + at * kLD;            // cum_{t-1}
#pragma unroll 4
    for (int d = 0; d < K; ++d) {
        const float rv = rrow[d], cx = crow[d];
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int i = ai + 8 * j;
            // <= 0 for i < t; -inf (2^-inf = 0) where i >= t
            const float e = i < at ? cx - Cz[(i + 1) * kLD + d]
                                   : -CUDART_INF_F;
            acc[j] = fmaf(rv * Ks[i * kLD + d], exp2f(e), acc[j]);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, const T* __restrict__ dout,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ dlw, float* __restrict__ dup,
                float* __restrict__ states, int S, int H, int K,
                long long srb, long long srs, long long srh, long long skb,
                long long sks, long long skh, long long svb, long long svs,
                long long svh, long long swb, long long sws, long long swh) {
    extern __shared__ float smem[];
    float* Rs = smem;                 // r[t][d]
    float* Ks = Rs + kLT;             // k[i][d]
    float* Vs = Ks + kLT;             // v[i][c]
    float* Os = Vs + kLT;             // do[t][c]
    float* Es = Os + kLT;             // exp(cum_L[d] - cum_i[d])
    float* RE = Es + kLT;             // r[t][d] exp(cum_{t-1}[d])
    float* DC = RE + kLT;             // dcum[t][d]
    float* DX = DC + kLT;             // dcum_ex[t][d]
    float* Cz = DX + kLT;             // Cz[t][d] = cum_{t-1}[d] log2(e)
    float* Ss = Cz + (kL + 1) * kLD;  // S_c[d][c], then the carried state
    float* Gs = Ss + kKT;             // dS[d][c], carried across chunks
    float* As = Gs + kKT;             // A[t][i]
    float* dAs = As + kAT;            // dA[t][i]
    float* Us = dAs + kAT;            // u[d]
    float* sds = Us + kMaxK;          // sum_c S_c[d][c] dS[d][c]
    float* part = sds + kMaxK;        // per row group: sum_i kdec dkdec
    float* beta = part + kGroups * kMaxK;
    float* dbeta = beta + kL;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x % H;
    const int tid = threadIdx.x;
    const T* rg = r + b * srb + h * srh;
    const T* kg = k + b * skb + h * skh;
    const T* vg = v + b * svb + h * svh;
    const float* wg = lw + b * swb + h * swh;
    const size_t row = static_cast<size_t>(H) * K;    // a step of do, dr, ...
    const size_t base = static_cast<size_t>(b) * S * row
                        + static_cast<size_t>(h) * K;
    const T* og = dout + base;
    const int n_chunks = (S + kL - 1) / kL;
    const size_t KK = static_cast<size_t>(K) * K;
    float* sg = states + static_cast<size_t>(blockIdx.x) * n_chunks * KK;

    // A, dA, beta: row at, columns ai + 8 j (j < 4); a warp's rows are
    // 4w .. 4w + 3, so its first jmax groups of 8 columns reach its diagonal
    const int at = tid >> 3, ai = tid & 7;
    const int jmax = ((at | 3) >> 3) + 1;
    // the (t, d) results: channel dch, rows grp + kGroups j (j < kRows)
    const int dch = tid % kMaxK, grp = tid / kMaxK;
    // (K, K) products: rows ty + 16 q, columns tx + 16 p (p, q < 4)
    const int ty = tid >> 4, tx = tid & 15;

    for (int d = tid; d < kMaxK; d += kThreads)
        Us[d] = d < K ? u[h * K + d] : 0.f;
    for (int i = tid; i < kLD; i += kThreads) Cz[i] = 0.f;

    // chunk c's k, v, log_w (in log2 units) and, when asked, r and do; zero
    // past the end and past K
    auto stage = [&](int s0, int len, bool grads) {
        for (int idx = tid; idx < kL * kMaxK; idx += kThreads) {
            const int t = idx / kMaxK, d = idx % kMaxK;
            const bool in = t < len && d < K;
            const long long s = s0 + t;
            Ks[t * kLD + d] = in ? ld(kg + s * sks + d) : 0.f;
            Vs[t * kLD + d] = in ? ld(vg + s * svs + d) : 0.f;
            Cz[(t + 1) * kLD + d] = in ? wg[s * sws + d] * kLog2e : 0.f;
            if (grads) {
                Rs[t * kLD + d] = in ? ld(rg + s * srs + d) : 0.f;
                Os[t * kLD + d] = in ? ld(og + s * row + d) : 0.f;
            }
        }
    };
    // cum: thread d scans channel d, then Es[i][d] = exp(cum_L - cum_i)
    auto scan = [&]() {
        if (tid < kMaxK) {
            float acc = 0.f;
            for (int t = 0; t < kL; ++t) {
                acc += Cz[(t + 1) * kLD + tid];
                Cz[(t + 1) * kLD + tid] = acc;
            }
            for (int t = 0; t < kL; ++t)
                Es[t * kLD + tid] = exp2f(acc - Cz[(t + 1) * kLD + tid]);
        }
    };

    // ---- sweep 1: the state entering each chunk -------------------------
    for (int i = tid; i < static_cast<int>(kKT); i += kThreads) Ss[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
        stage(s0, len, false);
        __syncthreads();
        scan();
        __syncthreads();
        // S[d][c] <- exp(cum_L[d]) S[d][c] + sum_i kdec[i][d] v[i][c]
        float acc[4][4] = {};
        if (c < n_chunks - 1) {       // the last chunk's update is not needed
            for (int i = 0; i < kL; ++i) {
                float kv[4], vv[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int d = ty + 16 * q;
                    kv[q] = Ks[i * kLD + d] * Es[i * kLD + d];
                }
#pragma unroll
                for (int p = 0; p < 4; ++p) vv[p] = Vs[i * kLD + tx + 16 * p];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int p = 0; p < 4; ++p) acc[q][p] += kv[q] * vv[p];
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int d = ty + 16 * q;
            const float decay = exp2f(Cz[kL * kLD + d]);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const int col = tx + 16 * p;
                if (d < K && col < K) {
                    const float s = Ss[d * kLD + col];
                    sg[c * KK + d * K + col] = s;
                    Ss[d * kLD + col] = s * decay + acc[q][p];
                }
            }
        }
    }

    // ---- sweep 2: the gradients, carrying dS backwards -------------------
    for (int i = tid; i < static_cast<int>(kKT); i += kThreads) Gs[i] = 0.f;
    float du_acc = 0.f;               // this thread's share of du[dch]
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
        stage(s0, len, true);
        for (int idx = tid; idx < kMaxK * kMaxK; idx += kThreads) {
            const int d = idx / kMaxK, col = idx % kMaxK;
            Ss[d * kLD + col] = d < K && col < K ? sg[c * KK + d * K + col]
                                                 : 0.f;
        }
        __syncthreads();
        scan();
        __syncthreads();

        // A (strictly lower), dA = do v^T (strictly lower), beta, dbeta;
        // RE = r exp(cum_ex)
        {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            switch (jmax) {           // the same for every lane of a warp
                case 1: a_row<1>(Rs, Ks, Cz, at, ai, K, acc); break;
                case 2: a_row<2>(Rs, Ks, Cz, at, ai, K, acc); break;
                case 3: a_row<3>(Rs, Ks, Cz, at, ai, K, acc); break;
                default: a_row<4>(Rs, Ks, Cz, at, ai, K, acc);
            }
            float da[4] = {0.f, 0.f, 0.f, 0.f};
            for (int cc = 0; cc < K; ++cc) {
                const float ov = Os[at * kLD + cc];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    da[j] += ov * Vs[(ai + 8 * j) * kLD + cc];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = ai + 8 * j;
                As[at * kALD + i] = i < at ? acc[j] : 0.f;
                dAs[at * kALD + i] = i < at ? da[j] : 0.f;
            }
            float bt = 0.f, dbt = 0.f;
            for (int d = ai; d < K; d += 8) {
                bt += Rs[at * kLD + d] * Us[d] * Ks[at * kLD + d];
                dbt += Os[at * kLD + d] * Vs[at * kLD + d];
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) {
                bt += __shfl_xor_sync(0xffffffffu, bt, o);
                dbt += __shfl_xor_sync(0xffffffffu, dbt, o);
            }
            if (ai == 0) {
                beta[at] = bt;
                dbeta[at] = dbt;
            }
            for (int idx = tid; idx < kL * kMaxK; idx += kThreads) {
                const int t = idx / kMaxK, d = idx % kMaxK;
                RE[t * kLD + d] = Rs[t * kLD + d] * exp2f(Cz[t * kLD + d]);
            }
        }
        __syncthreads();

        // the (t, d) results, thread (grp, dch): rows t = grp + kGroups j
        {
            const int d = dch;
            const float ud = Us[d];
            const float czl = Cz[kL * kLD + d];           // cum_L
            float kdk = 0.f;
            for (int j = 0; j < kRows; ++j) {
                const int t = grp + kGroups * j;
                const float cxt = Cz[t * kLD + d];        // cum_{t-1}
                const float cmt = Cz[(t + 1) * kLD + d];  // cum_t
                // dr_t: the state's term, then the sum over i < t of E
                float t1 = 0.f;
                for (int cc = 0; cc < K; ++cc)
                    t1 += Os[t * kLD + cc] * Ss[d * kLD + cc];
                float dra = 0.f;
                for (int i = 0; i < t; ++i)
                    dra += dAs[t * kALD + i] * Ks[i * kLD + d]
                           * exp2f(cxt - Cz[(i + 1) * kLD + d]);
                const float drs = exp2f(cxt) * t1 + dra;
                const float rv = Rs[t * kLD + d], kv = Ks[t * kLD + d];
                DX[t * kLD + d] = rv * drs;
                // dk_t (as the column i = t): the sum over t' > t of E
                float dka = 0.f;
                for (int tt = t + 1; tt < kL; ++tt)
                    dka += dAs[tt * kALD + t] * Rs[tt * kLD + d]
                           * exp2f(Cz[tt * kLD + d] - cmt);
                float dkd = 0.f;
                for (int cc = 0; cc < K; ++cc)
                    dkd += Vs[t * kLD + cc] * Gs[d * kLD + cc];
                const float e = Es[t * kLD + d];
                const float kk = t < kL - 1 ? dkd * kv * e : 0.f;
                DC[t * kLD + d] = -kv * dka - kk;
                kdk += kk;
                du_acc += dbeta[t] * rv * kv;
                // dv[t][c] with c = d: A^T do, the bonus, kdec dS
                float dvv = beta[t] * Os[t * kLD + d];
                for (int tt = t + 1; tt < kL; ++tt)
                    dvv += As[tt * kALD + t] * Os[tt * kLD + d];
                for (int dd = 0; dd < K; ++dd)
                    dvv += Ks[t * kLD + dd] * Es[t * kLD + dd]
                           * Gs[dd * kLD + d];
                if (t < len && d < K) {
                    const size_t at_t = static_cast<size_t>(s0 + t) * row + d;
                    st(dr + base + at_t, drs + dbeta[t] * ud * kv);
                    st(dk + base + at_t, dka + dbeta[t] * ud * rv + e * dkd);
                    st(dv + base + at_t, dvv);
                }
            }
            part[grp * kMaxK + d] = kdk;
            if (grp == 0) {
                float s = 0.f;
                for (int cc = 0; cc < K; ++cc)
                    s += Ss[d * kLD + cc] * Gs[d * kLD + cc];
                sds[d] = s * exp2f(czl);
            }
        }
        __syncthreads();              // every read of dS for this chunk is done

        // dS <- diag(exp(cum_L)) dS + RE^T do
        {
            float acc[4][4] = {};
            for (int t = 0; t < kL; ++t) {
                float rv[4], ov[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) rv[q] = RE[t * kLD + ty + 16 * q];
#pragma unroll
                for (int p = 0; p < 4; ++p) ov[p] = Os[t * kLD + tx + 16 * p];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int p = 0; p < 4; ++p) acc[q][p] += rv[q] * ov[p];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int d = ty + 16 * q;
                const float decay = exp2f(Cz[kL * kLD + d]);
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const int col = tx + 16 * p;
                    if (d < K && col < K)
                        Gs[d * kLD + col] = Gs[d * kLD + col] * decay
                                            + acc[q][p];
                }
            }
        }
        // dlog_w, thread d: the reverse scans of dcum and dcum_ex
        if (tid < K) {
            const int d = tid;
            float tail = sds[d];
            for (int g = 0; g < kGroups; ++g) tail += part[g * kMaxK + d];
            float sc = tail, sx = 0.f;    // dcum_L's extra terms at t = L - 1
            for (int t = kL - 1; t >= 0; --t) {
                sc += DC[t * kLD + d];
                if (t < len)
                    dlw[base + static_cast<size_t>(s0 + t) * row + d] =
                        sc + sx;
                sx += DX[t * kLD + d];
            }
        }
    }

    // the block's partial of du: its row groups summed in order
    __syncthreads();
    part[grp * kMaxK + dch] = du_acc;
    __syncthreads();
    if (tid < K) {
        float s = 0.f;
        for (int g = 0; g < kGroups; ++g) s += part[g * kMaxK + tid];
        dup[static_cast<size_t>(blockIdx.x) * K + tid] = s;
    }
}

// out[j] = sum over b < n of in[b][j], b in order: du's per-block partials
// summed with no atomics, so the bits repeat
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int inner, int n) {
    const int j = blockIdx.x * 256 + threadIdx.x;
    if (j >= inner) return;
    float s = 0.f;
    for (int b = 0; b < n; ++b) s += in[static_cast<size_t>(b) * inner + j];
    out[j] = s;
}

// the scratch: the chunks' entry states, then du's partials (B, H, K)
long long scratch_floats(int B, int S, int H, int K) {
    const long long blocks = static_cast<long long>(B) * H;
    const long long n_chunks = (S + kL - 1) / kL;
    return blocks * (n_chunks * K * K + K);
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* dout, void* dr, void* dk, void* dv,
           void* dlw, void* du, void* scratch, int B, int S, int H, int K,
           const long long* sv, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = static_cast<long long>(B) * H;
    const long long n_chunks = (S + kL - 1) / kL;
    float* states = static_cast<float*>(scratch);
    float* dup = states + blocks * n_chunks * K * K;
    wkv6_bwd_kernel<T><<<static_cast<int>(blocks), kThreads, kSmemBytes,
                         stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<const T*>(dout),
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(dlw), dup, states, S, H, K, sv[0], sv[1], sv[2],
        sv[3], sv[4], sv[5], sv[6], sv[7], sv[8], sv[9], sv[10], sv[11]);
    const int e = static_cast<int>(cudaGetLastError());
    if (e != 0) return e;
    // du: (B, H * K) partials summed over B
    const int inner = H * K;
    sum_parts_kernel<<<(inner + 255) / 256, 256, 0, stream>>>(
        dup, static_cast<float*>(du), inner, B);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 scratch (in floats) the backward needs for these sizes, by dtype
// (0 f32, 1 bf16).
extern "C" long long wkv6_bwd_scratch_floats(int dtype, int B, int S, int H,
                                             int K) {
    return dtype == 1 ? wkv6_bwd_wgmma_scratch_floats(B, S, H)
                      : scratch_floats(B, S, H, K);
}

// dtype 0: r, k, v, do, dr, dk, dv in f32 (the CUDA-core form); 1: in bf16
// (the tensor-core form).  log_w is f32 and dlog_w (B, S, H, K) comes out in
// f32; u and du are f32 contiguous (H, K).  strides (in elements): the
// batch, step and head strides of r, k, v, log_w and do, in that order (the
// last axis of each is contiguous; f32 takes do contiguous and reads only
// the first twelve; bf16 reads each of them 16-byte aligned).  dr, dk, dv
// and dlog_w are contiguous (B, S, H, K), but in bf16 dr, dk and dv have
// rows of K rounded up to 8.  scratch holds wkv6_bwd_scratch_floats floats.
// Returns a cudaError_t code, 0 on success, or -(a CUresult) when the bf16
// form cannot make a tensor map.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* log_w, const void* u,
                               const void* dout, void* dr, void* dk, void* dv,
                               void* dlog_w, void* du, void* scratch,
                               int dtype, int B, int S, int H, int K,
                               const long long* strides, void* stream) {
    if (B < 1 || S < 1 || H < 1 || K < 1 || K > kMaxK)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(r, k, v, log_w, u, dout, dr, dk, dv, dlog_w, du,
                             scratch, B, S, H, K, strides, s);
    if (dtype == 1)
        return wkv6_bwd_wgmma_launch(r, k, v, log_w, u, dout, dr, dk, dv,
                                     dlog_w, du, scratch, B, S, H, K, strides,
                                     s);
    return static_cast<int>(cudaErrorInvalidValue);
}
