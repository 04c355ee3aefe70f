// mamba2_ssd: the chunked Mamba-2 SSD (state-space dual) scan.  CUDA C++
// for sm_90a, built with nvcc into a shared library with a plain C entry
// point (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/mamba2_ssd/ops.py).  The entry point sends bf16 calls
// to the tensor-core form (mamba2_ssd_wgmma.cu) and f32 calls to the
// CUDA-core form below; neither falls back to the other.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd/kernel.py::_ssd_kernel
// (wrapper ssd).  It computes the same function: x (B, S, H, P), dt (B, S, H)
// f32, B and C (B, S, N) shared by all H heads of a batch row, A_log and D
// (H,) f32.  Per head, over chunks of L = 64 steps with a (P, N) f32 state S
// carried from chunk to chunk (zero at the start):
//   la      = -dt * exp(A_log[h]),  cum = inclusive cumsum of la over the chunk
//   y_state = exp(cum_t) * (C S^T)[t, p]
//   W[t, i] = exp(cum_t - cum_i) * (C B^T)[t, i] * dt_i   for i <= t, else 0
//   y       = y_state + W x + D[h] * x        (f32, rounded once to x's dtype)
//   S      <- exp(cum_L) S + (x * dt * exp(cum_L - cum))^T B
// The exponent of W is evaluated only where i <= t: above the diagonal it
// is positive and its exp overflows.  The D * x skip is fused here in f32
// and rounded once, as the model's own path (models/mamba2.py ssd_chunked)
// does; the TPU wrapper rounds y first and then again after the skip, so in
// bf16 the two differ by at most one ulp.  The ragged final chunk is masked
// in the kernel (zeros staged past the end, which add nothing since dt = 0
// there, and no row written past S), not padded on the host.
//
// The f32 form.  What bounds it on an H100 SXM (NVIDIA data sheet):
// operations.  At zamba2's prefill shape (B = 2, S = 2048, H = 80,
// P = N = 64) in f32 the least products, 6.75 GFLOP (C B^T shared by the
// heads, the causal half of the intra products), take 0.10 ms at 67 TFLOP/s
// without the tensor cores (TF32 keeps 10 bits, too few for the f32 bound
// of 2e-3 + 2e-3 |want|), against 0.05 ms for its 170 MB at 3.35 TB/s.
//
// What the design does about it: it is simple and right, on the CUDA cores.
// One block of 256 threads owns one (batch, head) and walks its chunks in
// order, the counterpart of the TPU kernel's sequential chunk axis with the
// state in VMEM: here S stays in shared memory for the whole sequence.  Per
// chunk, x, B, C and dt are staged in shared memory as f32 (rows padded to
// 65 floats, so a warp's column reads fall in distinct banks); warp 0 forms
// cum with a shuffle scan; then three passes, each thread holding a 4 x 4
// block of a 64 x 64 product in registers: W, then y (C S^T and W x, with
// the skip, written straight to device memory), then the state update.  x
// and B, C are read with their own strides (the model hands in views of the
// conv output), and y is written contiguous (B, S, H, P).  About 84 KB of
// shared memory a block (over the 48 KB default, so the launch opts in), two
// blocks to an SM.  The kernel issues four full 64^3 products per (b, h,
// chunk), about 10.7 GFLOP at the prefill's shape, on the CUDA cores.
#include <cuda_runtime.h>

#include <cstddef>

// the bf16 form (mamba2_ssd_wgmma.cu)
int mamba2_ssd_wgmma_launch(const void* x, const void* dt, const void* A_log,
                            const void* Bm, const void* Cm, const void* D,
                            void* y, int B, int S, int H, int P, int N,
                            const long long* st, cudaStream_t stream);

namespace {

constexpr int kL = 64;            // chunk length
constexpr int kMaxPN = 64;        // the widest head (P) and state (N)
constexpr int kLD = kMaxPN + 1;   // row stride of every staged tile
constexpr int kThreads = 256;     // 16 x 16 threads over a 64 x 64 product
constexpr size_t kTile = static_cast<size_t>(kL) * kLD;
// Xs, Bs, Cs, Ws (L x kLD), Ss (kMaxPN x kLD), then dt, cum, exp(cum), kdec
constexpr size_t kSmemBytes = (5 * kTile + 4 * kL) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A_log, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dv,
           float* __restrict__ y, int S, int H, int P, int N,
           long long sxb, long long sxs, long long sxh,
           long long sdb, long long sds, long long sdh,
           long long sbb, long long sbs, long long scb, long long scs) {
    extern __shared__ float smem[];
    float* Xs = smem;                 // x[t][p]
    float* Bs = Xs + kTile;           // B[i][n]
    float* Cs = Bs + kTile;           // C[t][n]
    float* Ws = Cs + kTile;           // W[t][i]
    float* Ss = Ws + kTile;           // S[p][n], carried across chunks
    float* dts = Ss + kTile;
    float* cum = dts + kL;
    float* ecum = cum + kL;
    float* kdec = ecum + kL;

    const int b = blockIdx.x / H;
    const int h = blockIdx.x % H;
    const int tid = threadIdx.x;
    const int ty = tid >> 4;          // rows ty, ty + 16, ty + 32, ty + 48
    const int tx = tid & 15;          // columns tx, tx + 16, tx + 32, tx + 48
    const float A = expf(A_log[h]);
    const float Dh = Dv[h];
    const float* xg = x + b * sxb + h * sxh;
    const float* dg = dt + b * sdb + h * sdh;
    const float* bg = Bm + b * sbb;
    const float* cg = Cm + b * scb;
    const size_t ys_stride = static_cast<size_t>(H) * P;
    float* yg = y + static_cast<size_t>(b) * S * ys_stride
            + static_cast<size_t>(h) * P;

    for (int i = tid; i < static_cast<int>(kTile); i += kThreads) Ss[i] = 0.f;

    const int n_chunks = (S + kL - 1) / kL;
    for (int c = 0; c < n_chunks; ++c) {
        const int s0 = c * kL;
        const int len = min(kL, S - s0);
        __syncthreads();              // the last chunk's tiles are read
        for (int i = tid; i < kL * kMaxPN; i += kThreads) {
            const int t = i / kMaxPN, k = i % kMaxPN;
            float xv = 0.f, bv = 0.f, cv = 0.f;
            if (t < len) {
                const long long s = s0 + t;
                if (k < P) xv = xg[s * sxs + k];
                if (k < N) {
                    bv = bg[s * sbs + k];
                    cv = cg[s * scs + k];
                }
            }
            Xs[t * kLD + k] = xv;
            Bs[t * kLD + k] = bv;
            Cs[t * kLD + k] = cv;
        }
        if (tid < kL)
            dts[tid] = tid < len ? dg[static_cast<long long>(s0 + tid) * sds]
                                 : 0.f;
        __syncthreads();

        // cum: lane l holds steps 2l and 2l + 1, an inclusive shuffle scan
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
        __syncthreads();
        const float cum_last = cum[kL - 1];
        if (tid < kL) {
            ecum[tid] = expf(cum[tid]);
            kdec[tid] = dts[tid] * expf(cum_last - cum[tid]);   // exponent <= 0
        }

        // W[t][i] = exp(cum_t - cum_i) * (C B^T)[t][i] * dt_i, i <= t
        {
            float acc[4][4] = {};
            for (int n = 0; n < N; ++n) {
                float cv[4], bv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLD + n];
#pragma unroll
                for (int q = 0; q < 4; ++q) bv[q] = Bs[(tx + 16 * q) * kLD + n];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * bv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int t = ty + 16 * r, i = tx + 16 * q;
                    Ws[t * kLD + i] = i <= t
                        ? expf(cum[t] - cum[i]) * acc[r][q] * dts[i] : 0.f;
                }
        }
        __syncthreads();

        // y[t][p] = exp(cum_t) (C S^T)[t][p] + (W x)[t][p] + D x[t][p]
        {
            float ys[4][4] = {}, yi[4][4] = {};
            for (int n = 0; n < N; ++n) {
                float cv[4], sv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * kLD + n];
#pragma unroll
                for (int q = 0; q < 4; ++q) sv[q] = Ss[(tx + 16 * q) * kLD + n];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) ys[r][q] += cv[r] * sv[q];
            }
            for (int i = 0; i < kL; ++i) {
                float wv[4], xv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) wv[r] = Ws[(ty + 16 * r) * kLD + i];
#pragma unroll
                for (int q = 0; q < 4; ++q) xv[q] = Xs[i * kLD + tx + 16 * q];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) yi[r][q] += wv[r] * xv[q];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int t = ty + 16 * r;
                if (t >= len) continue;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int p = tx + 16 * q;
                    if (p >= P) continue;
                    const float v = ecum[t] * ys[r][q] + yi[r][q]
                                    + Dh * Xs[t * kLD + p];
                    yg[static_cast<size_t>(s0 + t) * ys_stride + p] = v;
                }
            }
        }
        __syncthreads();              // every read of S for this chunk is done

        // S[p][n] <- exp(cum_L) S[p][n] + sum_i x[i][p] kdec_i B[i][n]
        {
            float acc[4][4] = {};
            for (int i = 0; i < kL; ++i) {
                const float kd = kdec[i];
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
            const float decay = expf(cum_last);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int p = ty + 16 * r, n = tx + 16 * q;
                    if (p < P && n < N)
                        Ss[p * kLD + n] = Ss[p * kLD + n] * decay + acc[r][q];
                }
        }
    }
}

int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, const void* D, void* y, int B, int S, int H, int P,
           int N, const long long* st, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_kernel<<<B * H, kThreads, kSmemBytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A_log), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(D),
        static_cast<float*>(y), S, H, P, N, st[0], st[1], st[2], st[3], st[4],
        st[5], st[6], st[7], st[8], st[9]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0: x, B, C, y in f32 (the CUDA-core form); 1: bf16 (the tensor-core
// form).  dt, A_log and D are f32.  strides (in elements): x's batch, step
// and head; dt's batch, step and head; B's batch and step; C's batch and
// step (the last axis of each is contiguous).  Returns a cudaError_t code,
// 0 on success, or -(a CUresult) when the bf16 form cannot make a tensor
// map.
extern "C" int mamba2_ssd_launch(const void* x, const void* dt,
                                 const void* A_log, const void* Bm,
                                 const void* Cm, const void* D, void* y,
                                 int dtype, int B, int S, int H, int P, int N,
                                 const long long* strides, void* stream) {
    if (B < 1 || S < 1 || H < 1 || P < 1 || N < 1 || P > kMaxPN ||
        N > kMaxPN)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch(x, dt, A_log, Bm, Cm, D, y, B, S, H, P, N, strides, s);
    if (dtype == 1)
        return mamba2_ssd_wgmma_launch(x, dt, A_log, Bm, Cm, D, y, B, S, H,
                                       P, N, strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
