// flash_attention_bwd: the gradient of the port's flash attention, dQ, dK and
// dV from q, k, v, the forward's output o, the output's gradient dO and the
// forward's per-row log-sum-exp lse.  CUDA C++ for sm_90a, built with nvcc
// with flash_attention_bwd_wgmma.cu into its own shared library with a plain
// C entry point (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/flash_attention/ops.py, whose autograd Function calls
// it from its backward).  The entry point (below) sends every bf16 call to
// the tensor-core form (flash_attention_bwd_wgmma.cu) and every f32 call to
// this file's CUDA-core form; neither falls back to the other.
//
// Replaces what the JAX package computes with XLA's autodiff of
// src/repro/models/layers.py::blockwise_attention (its Pallas kernel,
// src/repro/kernels/flash_attention/kernel.py::_attn_kernel, has no
// backward): with s = q . k / sqrt(D) under the forward's mask and
// P = exp(s - lse),
//   Drow = rowsum(dO o O),  dP = dO V^T,  dS = P o (dP - Drow),
//   dQ = dS K / sqrt(D),    dK = dS^T Q / sqrt(D),    dV = P^T dO.
// The mask is the forward's (flash_attention.cu): the key at kp is seen by
// the query at qp iff kp < Skv, and (causal) qp >= kp or kp < prefix_len,
// and (window > 0) qp - kp < window.  Here q, k, v, o, dO are f32; every
// product and sum is f32; dQ, dK, dV are written once in f32.  D is the
// caller's own head width (no padding), and the scale is 1/sqrt(D).
//
// What bounds it on an H100 SXM (NVIDIA data sheet): operations.  The
// algorithm needs 10 D flops a kept (query, key) pair (S again, dP, dV, dS
// K and dS^T Q): at h2o-danube-1.8b's training shape (B 4, S 2048, 32 query
// and 8 KV heads of 80, causal) 214.9 GFLOP, 0.217 ms at 989 TFLOP/s,
// against 0.063 ms for its 211 MB of inputs and outputs at 3.35 TB/s.
//
// What the design does about it: it is simple and right, on the CUDA cores
// in f32 (the bf16 form runs on the tensor cores), and it needs no
// atomics, so it is deterministic.  Three passes:
//   1. Drow = rowsum(dO o O), one warp a row.
//   2. One block of 256 threads per (batch, KV head, tile of kBK keys): the
//      tile's K and V stay in shared memory while the block walks the G
//      query heads of its group and, for each, the tiles of kBQ = 32 query
//      rows that see the key tile (the forward's tile range seen from the
//      key side: rows at or after the tile's first key when causal, unless
//      the tile starts inside the prefix, which every row sees; rows before
//      its last key + window under a window); it recomputes S and P, forms
//      dP and dS, and accumulates dV += P^T dO and dK += dS^T Q in
//      registers.
//   3. One block per (batch, head, tile of kBQ query rows), walking the KV
//      tiles the forward's block walked (up to the diagonal and every tile
//      of the prefix; from the window's first key): it recomputes S, P, dP
//      and dS, and accumulates dQ += dS K.
// Every product is one pattern, acc[i][j] += sum_k A[m_i][k] B[n_j][k] over
// tiles in shared memory with k contiguous (float4 loads), rows m_i = ty +
// 16 i and columns n_j = tx + 16 j of a 16 x 16 thread grid, row strides
// of 4 (mod 32) floats, so that 8 neighbouring threads read 8 distinct
// bank quads.  Operands needed with the other axis contiguous (Q and dO
// for the dK and dV products, K for dQ, P and dS) are kept transposed as
// well.  kBK is 64 keys for D <= 128 and 32 above, which keeps shared
// memory under 227 KB (217 KB at D = 256 in pass 2) and the accumulators
// at 32 floats a thread each.  The per-element mask is applied on every
// tile walked, so the tile ranges only skip work.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;     // a 16 x 16 grid (ty, tx)
constexpr int kBQ = 32;           // query rows a tile

template <int DP>
struct Tiles {
    static constexpr int kBK = DP <= 128 ? 64 : 32;   // keys a tile
    static constexpr int kLD = DP + 4;        // row stride of [rows][DP]
    static constexpr int kLQ = kBQ + 4;       // row stride of [..][kBQ]
    static constexpr int kLK = kBK + 4;       // row stride of [..][kBK]
    // pass 2: K, V; Q, dO; Q^T, dO^T; P^T, dS^T; lse, Drow
    static constexpr int kSmem2 =
        4 * (2 * kBK * kLD + 2 * kBQ * kLD + 2 * DP * kLQ + 2 * kBK * kLQ
             + 2 * kBQ);
    // pass 3: Q, dO; K, V; K^T; dS; lse, Drow
    static constexpr int kSmem3 =
        4 * (2 * kBQ * kLD + 2 * kBK * kLD + DP * kLK + kBQ * kLK + 2 * kBQ);
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ bool kept(int qp, int kp, int Sq, int Skv,
                                     int causal, int window, int prefix_len) {
    bool keep = qp < Sq && kp < Skv;
    if (causal) keep = keep && (qp >= kp || kp < prefix_len);
    if (window > 0) keep = keep && qp - kp < window;
    return keep;
}

// rows r0 .. r0 + n of one head of a (B, S, heads, D) tensor (src points at
// (b, 0, head, 0)) into dst[n][ld], times scale, zero past S and D; and
// into dstT[DP][ldT] transposed when dstT is not null
template <int DP, typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, float* dstT,
                                          int ldT, const T* src, int r0,
                                          int n, int S, int heads, int D,
                                          float scale) {
    for (int i = threadIdx.x; i < n * DP; i += kThreads) {
        const int r = i / DP, d = i % DP;
        float x = 0.f;
        if (r0 + r < S && d < D)
            x = load(src + static_cast<size_t>(r0 + r) * heads * D + d)
                * scale;
        dst[r * ld + d] = x;
        if (dstT != nullptr) dstT[d * ldT + r] = x;
    }
}

// acc[i][j] += sum_k A[(ty + 16 i) lda + k] B[(tx + 16 j) ldb + k], k < K
template <int MI, int NJ, int K>
__device__ __forceinline__ void mm_nt(float (&acc)[MI][NJ], const float* A,
                                      int lda, const float* B, int ldb,
                                      int ty, int tx) {
#pragma unroll 1
    for (int k = 0; k < K; k += 4) {
        float4 a[MI], b[NJ];
#pragma unroll
        for (int i = 0; i < MI; ++i)
            a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda
                                                    + k);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * ldb
                                                    + k);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                float s = acc[i][j];
                s = fmaf(a[i].x, b[j].x, s);
                s = fmaf(a[i].y, b[j].y, s);
                s = fmaf(a[i].z, b[j].z, s);
                s = fmaf(a[i].w, b[j].w, s);
                acc[i][j] = s;
            }
    }
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ]) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// pass 1: delta[b, h, s] = sum_d dO[b, s, h, d] o[b, s, h, d], a warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int B, int Sq, int H, int D) {
    const size_t row = static_cast<size_t>(blockIdx.x) * (kThreads / 32)
                       + threadIdx.x / 32;
    if (row >= static_cast<size_t>(B) * Sq * H) return;
    const int lane = threadIdx.x % 32;
    const T* op = o + row * D;
    const T* gp = dout + row * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(load(op + d), load(gp + d), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
        const size_t b = row / (static_cast<size_t>(Sq) * H);
        const int sq = static_cast<int>(row / H % Sq);
        const int h = static_cast<int>(row % H);
        delta[(b * H + h) * Sq + sq] = s;
    }
}

// pass 2: dK and dV of one (batch, KV head, key tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Skv, int H, int KV, int D,
                int causal, int window, int prefix_len, float scale) {
    using Ti = Tiles<DP>;
    constexpr int BK = Ti::kBK, LD = Ti::kLD, LQ = Ti::kLQ;
    constexpr int MS = kBQ / 16, NS = BK / 16;    // S: rows r, columns c
    constexpr int MA = BK / 16, NA = DP / 16;     // dK, dV: rows c, cols d
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);
    float* Vs = Ks + BK * LD;
    float* Qs = Vs + BK * LD;
    float* Gs = Qs + kBQ * LD;                    // dO
    float* Qt = Gs + kBQ * LD;
    float* Gt = Qt + DP * LQ;                     // dO^T
    float* Pt = Gt + DP * LQ;
    float* St = Pt + BK * LQ;                     // dS^T
    float* Ls = St + BK * LQ;                     // lse
    float* Ds = Ls + kBQ;                         // Drow

    const int k0 = blockIdx.x * BK;
    const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
    const int G = H / KV;
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const size_t kv_off = (static_cast<size_t>(b) * Skv * KV + kvh) * D;
    load_rows<DP>(Ks, LD, nullptr, 0, k + kv_off, k0, BK, Skv, KV, D, 1.f);
    load_rows<DP>(Vs, LD, nullptr, 0, v + kv_off, k0, BK, Skv, KV, D, 1.f);

    // the query rows that see a key of this tile
    int q_lo = 0, q_hi = Sq;
    if (causal && k0 >= prefix_len) q_lo = k0;
    if (window > 0) q_hi = min(Sq, min(k0 + BK, Skv) - 1 + window);

    float accK[MA][NA], accV[MA][NA];
    zero(accK);
    zero(accV);
    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
        const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
        for (int q0 = q_lo / kBQ * kBQ; q0 < q_hi; q0 += kBQ) {
            __syncthreads();          // the last tile's operands are read
            load_rows<DP>(Qs, LD, Qt, LQ, q + q_off, q0, kBQ, Sq, H, D,
                          scale);
            load_rows<DP>(Gs, LD, Gt, LQ, dout + q_off, q0, kBQ, Sq, H, D,
                          1.f);
            if (threadIdx.x < kBQ) {
                const int r = q0 + threadIdx.x;
                Ls[threadIdx.x] = r < Sq ? lse[row_off + r] : 0.f;
                Ds[threadIdx.x] = r < Sq ? delta[row_off + r] : 0.f;
            }
            __syncthreads();

            float s[MS][NS], dp[MS][NS];
            zero(s);
            zero(dp);
            mm_nt<MS, NS, DP>(s, Qs, LD, Ks, LD, ty, tx);
            mm_nt<MS, NS, DP>(dp, Gs, LD, Vs, LD, ty, tx);
#pragma unroll
            for (int i = 0; i < MS; ++i)
#pragma unroll
                for (int j = 0; j < NS; ++j) {
                    const int r = ty + 16 * i, c = tx + 16 * j;
                    float p = 0.f;
                    if (kept(q0 + r, k0 + c, Sq, Skv, causal, window,
                             prefix_len))
                        p = expf(s[i][j] - Ls[r]);
                    Pt[c * LQ + r] = p;
                    St[c * LQ + r] = p * (dp[i][j] - Ds[r]);
                }
            __syncthreads();
            mm_nt<MA, NA, kBQ>(accV, Pt, LQ, Gt, LQ, ty, tx);
            mm_nt<MA, NA, kBQ>(accK, St, LQ, Qt, LQ, ty, tx);
        }
    }

#pragma unroll
    for (int i = 0; i < MA; ++i) {
        const int c = k0 + ty + 16 * i;
        if (c >= Skv) continue;
        const size_t off = kv_off + static_cast<size_t>(c) * KV * D;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            const int d = tx + 16 * j;
            if (d < D) {
                store(dk + off + d, accK[i][j]);
                store(dv + off + d, accV[i][j]);
            }
        }
    }
}

// pass 3: dQ of one (batch, head, query tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Skv, int H, int KV, int D,
              int causal, int window, int prefix_len, float scale) {
    using Ti = Tiles<DP>;
    constexpr int BK = Ti::kBK, LD = Ti::kLD, LK = Ti::kLK;
    constexpr int MS = kBQ / 16, NS = BK / 16;    // S: rows r, columns c
    constexpr int NA = DP / 16;                   // dQ: rows r, columns d
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Gs = Qs + kBQ * LD;                    // dO
    float* Ks = Gs + kBQ * LD;
    float* Vs = Ks + BK * LD;
    float* Kt = Vs + BK * LD;
    float* Ss = Kt + DP * LK;                     // dS
    float* Ls = Ss + kBQ * LK;
    float* Ds = Ls + kBQ;

    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    const size_t q_off = (static_cast<size_t>(b) * Sq * H + h) * D;
    const size_t kv_off = (static_cast<size_t>(b) * Skv * KV + kvh) * D;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * Sq;
    load_rows<DP>(Qs, LD, nullptr, 0, q + q_off, q0, kBQ, Sq, H, D, scale);
    load_rows<DP>(Gs, LD, nullptr, 0, dout + q_off, q0, kBQ, Sq, H, D, 1.f);
    if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < Sq ? lse[row_off + r] : 0.f;
        Ds[threadIdx.x] = r < Sq ? delta[row_off + r] : 0.f;
    }

    // the KV tiles the forward's rows see: up to the diagonal, every tile
    // that holds a key of the prefix, from the window's first key
    const int n_kv = (Skv + BK - 1) / BK;
    int kv_hi = n_kv;
    if (causal)
        kv_hi = min(n_kv, max((min(q0 + kBQ, Sq) - 1) / BK + 1,
                              (prefix_len + BK - 1) / BK));
    int kv_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / BK;

    float acc[MS][NA];
    zero(acc);
    for (int kb = kv_lo; kb < kv_hi; ++kb) {
        const int k0 = kb * BK;
        __syncthreads();              // the last tile's operands are read
        load_rows<DP>(Ks, LD, Kt, LK, k + kv_off, k0, BK, Skv, KV, D, 1.f);
        load_rows<DP>(Vs, LD, nullptr, 0, v + kv_off, k0, BK, Skv, KV, D,
                      1.f);
        __syncthreads();

        float s[MS][NS], dp[MS][NS];
        zero(s);
        zero(dp);
        mm_nt<MS, NS, DP>(s, Qs, LD, Ks, LD, ty, tx);
        mm_nt<MS, NS, DP>(dp, Gs, LD, Vs, LD, ty, tx);
#pragma unroll
        for (int i = 0; i < MS; ++i)
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int r = ty + 16 * i, c = tx + 16 * j;
                float ds = 0.f;
                if (kept(q0 + r, k0 + c, Sq, Skv, causal, window, prefix_len))
                    ds = expf(s[i][j] - Ls[r]) * (dp[i][j] - Ds[r]);
                Ss[r * LK + c] = ds;
            }
        __syncthreads();
        mm_nt<MS, NA, BK>(acc, Ss, LK, Kt, LK, ty, tx);
    }

#pragma unroll
    for (int i = 0; i < MS; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= Sq) continue;
        const size_t off = q_off + static_cast<size_t>(r) * H * D;
#pragma unroll
        for (int j = 0; j < NA; ++j) {
            const int d = tx + 16 * j;
            if (d < D) store(dq + off + d, acc[i][j] * scale);
        }
    }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
           int causal, int window, int prefix_len, float scale,
           cudaStream_t stream) {
    using Ti = Tiles<DP>;
    const T* tq = static_cast<const T*>(q);
    const T* tk = static_cast<const T*>(k);
    const T* tv = static_cast<const T*>(v);
    const T* tg = static_cast<const T*>(dout);
    const size_t rows = static_cast<size_t>(B) * Sq * H;
    const unsigned blocks =
        static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32));
    bwd_delta_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(o), tg, delta, B, Sq, H, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ti::kSmem2);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dkdv_kernel<T, DP>
        <<<dim3((Skv + Ti::kBK - 1) / Ti::kBK, B * KV), kThreads, Ti::kSmem2,
           stream>>>(tq, tk, tv, tg, lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), Sq, Skv, H, KV, D, causal, window,
                     prefix_len, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    err = cudaFuncSetAttribute(bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ti::kSmem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dq_kernel<T, DP>
        <<<dim3((Sq + kBQ - 1) / kBQ, B * H), kThreads, Ti::kSmem3,
           stream>>>(tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), Sq,
                     Skv, H, KV, D, causal, window, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int Sq, int Skv, int H, int KV, int D,
             int causal, int window, int prefix_len, float scale,
             cudaStream_t s) {
#define FA_BWD_CASE(DP)                                                      \
    if (D <= DP)                                                             \
        return launch<T, DP>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, \
                             Skv, H, KV, D, causal, window, prefix_len,      \
                             scale, s);
    // head widths padded to 16s up to 128, to 32s and then 64s above
    FA_BWD_CASE(16) FA_BWD_CASE(32) FA_BWD_CASE(48) FA_BWD_CASE(64)
    FA_BWD_CASE(80) FA_BWD_CASE(96) FA_BWD_CASE(112) FA_BWD_CASE(128)
    FA_BWD_CASE(160) FA_BWD_CASE(192) FA_BWD_CASE(256)
#undef FA_BWD_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// the bf16 form (flash_attention_bwd_wgmma.cu)
int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* scratch, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int KV, int D, int causal,
    int window, int prefix_len, float scale, cudaStream_t s);

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk, dv share it);
// q, o, dout, dq (B, Sq, H, D) and k, v, dk, dv (B, Skv, KV, D), contiguous;
// lse (B, H, Sq) f32 from the forward; delta an f32 scratch: (B, H, Sq) for
// f32, 2 B H Sq_pad floats for bf16 (Sq_pad = Sq rounded up to 128);
// 1 <= D <= 256 (bf16: a multiple of 8, 16-byte aligned tensors; scale the
// caller's 1/sqrt(D)), H a multiple of KV; the mask arguments as the
// forward's.  Launches the three passes on the stream; returns the CUDA
// error of the first launch refused (0 when all were accepted), or for
// bf16 -(a CUresult) when a tensor map cannot be made.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Sq, int Skv, int H, int KV, int D,
    int causal, int window, int prefix_len, float scale, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Sq, Skv, H, KV, D, causal, window, prefix_len,
                               scale, s);
    if (dtype == 1)
        return flash_attention_bwd_wgmma_launch(q, k, v, o, dout, lse, delta,
                                                dq, dk, dv, B, Sq, Skv, H, KV,
                                                D, causal, window, prefix_len,
                                                scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
