// rwkv6 wkv6: the chunked RWKV-6 (Finch) WKV with a per-channel,
// data-dependent decay.  CUDA C++ for sm_90a, built with nvcc, together with
// wkv6_wgmma.cu, into a shared library with a plain C entry point
// (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/rwkv6/ops.py).  This file holds the entry point and
// the f32 form on the CUDA cores (kernel wkv6_kernel); the entry point sends
// bf16 to the tensor-core form in wkv6_wgmma.cu (kernel wkv6_kernel_wgmma),
// each dtype to its own form, with no fallback between them.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel
// (wrapper wkv6).  It computes the same function: r, k, v (B, S, H, K),
// log_w (B, S, H, K) f32 and <= 0, u (H, K) f32.  Per (batch, head), over
// chunks of L = 32 steps with a (K, K) f32 state S carried from chunk to
// chunk (zero at the start), cum the inclusive cumsum of log_w over the
// chunk and cum_{-1} = 0:
//   o_state[t] = (r_t * exp(cum_{t-1})) S
//   A[t, i]    = sum_d r_t[d] k_i[d] exp(cum_{t-1}[d] - cum_i[d])   i < t
//   A[t, t]    = sum_d r_t[d] u[d] k_t[d]                  (the u bonus)
//   o          = o_state + A v              (f32, rounded once to r's dtype)
//   S         <- diag(exp(cum_{L-1})) S
//                + sum_i (k_i * exp(cum_{L-1} - cum_i)) v_i^T
// cum_{t-1} is the TPU kernel's cum_ex = cum - log_w, read from the scan one
// row earlier, so the exponent of A is <= 0 exactly.  It is evaluated per
// (t, i, d) and only where i < t (above the diagonal it is replaced by -inf
// before the exp): with log_w >= -8 a chunk's cum reaches -256, so factoring
// it as exp(cum_{t-1}) * exp(-cum_i) overflows f32.  That is why A is not one
// matrix product here: L (L - 1) / 2 * K = 31,744 exps per chunk and head
// (wkv6_wgmma.cu factors it by sub-chunks, every exponent <= 0).  The
// ragged final chunk is masked in the kernel (zeros staged past the end,
// which add nothing, and no row written past S), not padded on the host.
//
// What bounds the f32 form on an H100 SXM (NVIDIA data sheet): bytes.  At
// rwkv6-1.6b's prefill shape in f32 (B = 2, S = 2048, H = 32, K = 64) the
// tensors are 168 MB, 50 us at 3.35 TB/s, against about 2.7 GFLOP of
// products, 40 us at 67 TFLOP/s.
//
// What the design does about it: this form, the port's first, is simple and
// right, and leaves the tensor cores unused (f32 runs in full f32).
// A block of 256 threads owns one (batch, head) and 32 of its K value
// columns, and walks the chunks in order, the counterpart of the TPU
// kernel's sequential chunk axis with the state in VMEM: here its (K, 32)
// slice of S stays in shared memory for the whole sequence.  Two blocks
// share a head at K = 64, each recomputing A, so the prefill's 64 (batch,
// head) pairs fill 128 of the 132 SMs.  With one block of 8 warps an SM
// little latency is hidden, so the design keeps each warp's instruction
// stream free of waits: r, k, v and log_w are read in place with their
// strides (the model hands in views of the projections) into registers a
// whole chunk ahead of their use, then staged in shared memory as f32 (rows
// padded to 65 floats, so a warp's column reads fall in distinct banks);
// each of 64 threads scans one channel's cum, kept in log2 units (log_w is
// scaled by log2 e as it is staged), so each of A's exps is one MUFU.EX2; A
// is formed by 8 lanes per row, each warp running the loop over d with its
// own number of 8-column groups that reach its diagonal (a template
// argument, so no lane branches inside the loop and a lane's exps are
// independent), with the 8-lane shuffle sum of the bonus on the diagonal;
// then r and k are scaled in place and each thread holds a 2 x 2 block of o
// and a 4 x 2 block of the state update in registers.  About 42 KB of
// shared memory a block, under the 48 KB default.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kL = 32;            // chunk length
constexpr int kMaxK = 64;         // the widest head
constexpr int kVC = 32;           // value columns per block
constexpr int kLD = kMaxK + 1;    // row stride of the (., K) tiles
constexpr int kVLD = kVC + 1;     // row stride of the (., value) tiles
constexpr int kALD = kL + 1;      // row stride of A
constexpr int kThreads = 256;
// Rs, Ks (L x kLD), Cz ((L + 1) x kLD), Vs (L x kVLD), As (L x kALD),
// Ss (kMaxK x kVLD), Us (kMaxK)
constexpr size_t kSmemBytes =
    (2 * kL * kLD + (kL + 1) * kLD + kL * kVLD + kL * kALD + kMaxK * kVLD
     + kMaxK) * sizeof(float);
static_assert(kSmemBytes <= 48 * 1024, "over the default shared memory");
// r, k, log_w values (and v values) a thread stages per chunk
constexpr int kPerThread = kL * kMaxK / kThreads;
constexpr int kVPerThread = kL * kVC / kThreads;
static_assert(kPerThread * kThreads == kL * kMaxK
              && kVPerThread * kThreads == kL * kVC, "uneven staging");
constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2, with results below 2^-126 (terms under 1e-38) flushed
// to zero: exp2f and __expf add a fix-up for them on every call
__device__ __forceinline__ float ex2_ftz(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Columns i = ai + 8 j (j < J) of row `at` of A, less the bonus, into acc.
// Cz holds cum in log2 units.  A warp's rows reach its diagonal in its first
// J groups of 8 columns, so each warp calls this with its own J: no lane
// branches inside the loop, and the J exps of one d are independent.
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
            acc[j] = fmaf(rv * Ks[i * kLD + d], ex2_ftz(e), acc[j]);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, float* __restrict__ o, int S, int H,
            int K, long long srb, long long srs, long long srh,
            long long skb, long long sks, long long skh, long long svb,
            long long svs, long long svh, long long swb, long long sws,
            long long swh) {
    extern __shared__ float smem[];
    float* Rs = smem;                 // r[t][d], then r * exp(cum_{t-1})
    float* Ks = Rs + kL * kLD;        // k[i][d], then k * exp(cum_L - cum_i)
    float* Cz = Ks + kL * kLD;        // Cz[t][d] = cum_{t-1}[d] log2(e)
    float* Vs = Cz + (kL + 1) * kLD;  // v[i][c], this block's columns
    float* As = Vs + kL * kVLD;       // A[t][i]
    float* Ss = As + kL * kALD;       // S[d][c], carried across chunks
    float* Us = Ss + kMaxK * kVLD;    // u[d]

    const int b = blockIdx.x / H;
    const int h = blockIdx.x % H;
    const int c0 = blockIdx.y * kVC;  // this block's first value column
    const int nc = min(kVC, K - c0);
    const int tid = threadIdx.x;
    const float* rg = r + b * srb + h * srh;
    const float* kg = k + b * skb + h * skh;
    const float* vg = v + b * svb + h * svh + c0;
    const float* wg = lw + b * swb + h * swh;
    const size_t os = static_cast<size_t>(H) * K;
    float* og = o + static_cast<size_t>(b) * S * os + static_cast<size_t>(h) * K
            + c0;

    // A: row at, columns ai + 8 j (j < 4); the rows of a warp are
    // 4w .. 4w + 3, so the first jmax groups of 8 columns reach its diagonal
    const int at = tid >> 3, ai = tid & 7;
    const int jmax = ((at | 3) >> 3) + 1;
    // o: rows ty, ty + 16; the state: rows ty + 16 q (q < 4); both columns
    // tx, tx + 16
    const int ty = tid >> 4, tx = tid & 15;

    for (int i = tid; i < kMaxK * kVLD; i += kThreads) Ss[i] = 0.f;
    for (int i = tid; i < kLD; i += kThreads) Cz[i] = 0.f;
    for (int d = tid; d < kMaxK; d += kThreads)
        Us[d] = d < K ? u[h * K + d] : 0.f;

    // chunk c's r, k, log_w (in log2 units) and v, zero past the end, into
    // registers: each chunk's loads are issued a whole chunk ahead of use
    float pr[kPerThread], pk[kPerThread], pw[kPerThread], pv[kVPerThread];
    auto fetch = [&](int c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);          // <= 0 past the last chunk
#pragma unroll
        for (int n = 0; n < kPerThread; ++n) {
            const int idx = tid + n * kThreads;
            const int t = idx / kMaxK, d = idx % kMaxK;
            const bool in = t < len && d < K;
            const long long s = s0 + t;
            pr[n] = in ? rg[s * srs + d] : 0.f;
            pk[n] = in ? kg[s * sks + d] : 0.f;
            pw[n] = in ? wg[s * sws + d] * kLog2e : 0.f;
        }
#pragma unroll
        for (int n = 0; n < kVPerThread; ++n) {
            const int idx = tid + n * kThreads;
            const int t = idx / kVC, j = idx % kVC;
            pv[n] = t < len && j < nc
                ? vg[static_cast<long long>(s0 + t) * svs + j] : 0.f;
        }
    };

    const int n_chunks = (S + kL - 1) / kL;
    fetch(0);
    for (int c = 0; c < n_chunks; ++c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
#pragma unroll
        for (int n = 0; n < kPerThread; ++n) {
            const int idx = tid + n * kThreads;
            const int t = idx / kMaxK, d = idx % kMaxK;
            Rs[t * kLD + d] = pr[n];
            Ks[t * kLD + d] = pk[n];
            Cz[(t + 1) * kLD + d] = pw[n];
        }
#pragma unroll
        for (int n = 0; n < kVPerThread; ++n) {
            const int idx = tid + n * kThreads;
            Vs[(idx / kVC) * kVLD + idx % kVC] = pv[n];
        }
        __syncthreads();
        fetch(c + 1);

        // cum: thread d scans channel d (the loads issued ahead of the adds)
        if (tid < kMaxK) {
            float w[kL];
#pragma unroll
            for (int t = 0; t < kL; ++t) w[t] = Cz[(t + 1) * kLD + tid];
            float acc = 0.f;
#pragma unroll
            for (int t = 0; t < kL; ++t) {
                acc += w[t];
                Cz[(t + 1) * kLD + tid] = acc;
            }
        }
        __syncthreads();

        // A[t][i] = sum_d r_t k_i exp(cum_{t-1} - cum_i), i < t; the bonus
        // sum_d r_t u k_t on the diagonal; zero above it
        {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            switch (jmax) {           // the same for every lane of a warp
                case 1: a_row<1>(Rs, Ks, Cz, at, ai, K, acc); break;
                case 2: a_row<2>(Rs, Ks, Cz, at, ai, K, acc); break;
                case 3: a_row<3>(Rs, Ks, Cz, at, ai, K, acc); break;
                default: a_row<4>(Rs, Ks, Cz, at, ai, K, acc);
            }
            float dg = 0.f;
            for (int d = ai; d < K; d += 8)
                dg += Rs[at * kLD + d] * Us[d] * Ks[at * kLD + d];
            dg += __shfl_xor_sync(0xffffffffu, dg, 1);
            dg += __shfl_xor_sync(0xffffffffu, dg, 2);
            dg += __shfl_xor_sync(0xffffffffu, dg, 4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int i = ai + 8 * j;
                As[at * kALD + i] = i < at ? acc[j] : (i == at ? dg : 0.f);
            }
        }
        __syncthreads();

        // r_t <- r_t exp(cum_{t-1}), k_i <- k_i exp(cum_L - cum_i); both <= 0
        for (int idx = tid; idx < kL * kMaxK; idx += kThreads) {
            const int t = idx / kMaxK, d = idx % kMaxK;
            Rs[t * kLD + d] *= exp2f(Cz[t * kLD + d]);
            Ks[t * kLD + d] *= exp2f(Cz[kL * kLD + d] - Cz[(t + 1) * kLD + d]);
        }
        __syncthreads();

        // o[t][c] = (r exp(cum_{t-1}) S)[t][c] + (A v)[t][c]
        {
            float acc[2][2] = {};
            for (int d = 0; d < K; ++d) {
                const float r0 = Rs[ty * kLD + d];
                const float r1 = Rs[(ty + 16) * kLD + d];
                const float s0v = Ss[d * kVLD + tx];
                const float s1v = Ss[d * kVLD + tx + 16];
                acc[0][0] += r0 * s0v;
                acc[0][1] += r0 * s1v;
                acc[1][0] += r1 * s0v;
                acc[1][1] += r1 * s1v;
            }
            for (int i = 0; i < kL; ++i) {
                const float a0 = As[ty * kALD + i];
                const float a1 = As[(ty + 16) * kALD + i];
                const float v0 = Vs[i * kVLD + tx];
                const float v1 = Vs[i * kVLD + tx + 16];
                acc[0][0] += a0 * v0;
                acc[0][1] += a0 * v1;
                acc[1][0] += a1 * v0;
                acc[1][1] += a1 * v1;
            }
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                const int t = ty + 16 * p;
                if (t >= len) continue;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    const int col = tx + 16 * q;
                    if (col < nc)
                        og[static_cast<size_t>(s0 + t) * os + col] =
                            acc[p][q];
                }
            }
        }
        __syncthreads();              // every read of S for this chunk is done

        // S[d][c] <- exp(cum_L[d]) S[d][c] + sum_i kdec[i][d] v[i][c]
        {
            float acc[4][2] = {};
            for (int i = 0; i < kL; ++i) {
                float kv[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) kv[q] = Ks[i * kLD + ty + 16 * q];
                const float v0 = Vs[i * kVLD + tx];
                const float v1 = Vs[i * kVLD + tx + 16];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    acc[q][0] += kv[q] * v0;
                    acc[q][1] += kv[q] * v1;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int d = ty + 16 * q;
                if (d >= K) continue;
                const float decay = exp2f(Cz[kL * kLD + d]);
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int col = tx + 16 * p;
                    if (col < nc)
                        Ss[d * kVLD + col] = Ss[d * kVLD + col] * decay
                                             + acc[q][p];
                }
            }
        }
    }
}

int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* o, int B, int S, int H, int K,
           const long long* st, cudaStream_t stream) {
    const dim3 grid(B * H, (K + kVC - 1) / kVC);
    wkv6_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(lw),
        static_cast<const float*>(u), static_cast<float*>(o), S, H, K, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the bf16 form (wkv6_wgmma.cu)
int wkv6_wgmma_launch(const void* r, const void* k, const void* v,
                      const void* log_w, const void* u, void* o, int B, int S,
                      int H, int K, const long long* st, int columns,
                      cudaStream_t stream);

// dtype 0: r, k, v, o in f32 (the CUDA-core form, columns 0 only); 1: bf16
// (the tensor-core form; columns picks its geometry, 0 the kept one, see
// wkv6_wgmma_launch).  log_w and u are f32, u contiguous (H, K).  strides
// (in elements): the batch, step and head strides of r, k, v and log_w, in
// that order (the last axis of each is contiguous).  f32: o contiguous (B,
// S, H, K); bf16: o contiguous (B, S, H, K rounded up to 8).  Returns a
// cudaError_t code, 0 on success, or -(a CUresult) when the bf16 form
// cannot make a tensor map.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* log_w, const void* u, void* o,
                           int dtype, int B, int S, int H, int K,
                           const long long* strides, int columns,
                           void* stream) {
    if (B < 1 || S < 1 || H < 1 || K < 1 || K > kMaxK)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && columns == 0)
        return launch(r, k, v, log_w, u, o, B, S, H, K, strides, s);
    if (dtype == 1)
        return wkv6_wgmma_launch(r, k, v, log_w, u, o, B, S, H, K, strides,
                                 columns, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
