// flash_attention: causal / sliding-window / full GQA attention with an
// online softmax.  CUDA C++ for sm_90a, built with nvcc into a shared library
// with a plain C entry point (repro_torch/kernels/build.py) and bound with
// ctypes (repro_torch/kernels/flash_attention/ops.py).  The entry point
// sends bf16 calls to the tensor-core form (flash_attention_wgmma.cu) and
// f32 calls to the CUDA-core form below; neither falls back to the other.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _attn_kernel (wrapper flash_attention).  It computes the same function:
// q (B, Sq, H, D) and k, v (B, Skv, KV, D), head h reading KV head h / G with
// G = H / KV; q is cast to f32 and then scaled by 1/sqrt(D); scores, the
// running max m, the running sum l and the output accumulator are f32; a
// key at absolute position kp is seen by the query at absolute position qp
// iff kp < Skv, and (causal) qp >= kp or kp < prefix_len (the prefix-LM
// mask of the reference's blockwise_attention, which its TPU kernel lacks:
// bidirectional over the first prefix_len keys), and (window > 0)
// qp - kp < window, with no Skv - Sq offset; masked scores are
// NEG_INF = -1e30, finite, as in the TPU kernel (with -INFINITY a tile in
// which a row sees no key gives exp(-inf - -inf) = NaN; with -1e30 it gives
// p = 1, which the later corr = exp(-1e30 - m) = 0 wipes out); the output
// is acc / max(l, 1e-30) in q's dtype (f32 or bf16, rounded to nearest
// even).  Given an f32 lse of shape (B, H, Sq), both forms also write each
// row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)) in natural
// units, which the backward (flash_attention_bwd.cu) recomputes P from.
//
// The f32 form.  What bounds it on an H100 SXM (NVIDIA data sheet):
// operations, 4 * D flops per (query, key) pair that the mask keeps over
// 67 TFLOP/s (f32 without the tensor cores, which have no f32 product; TF32
// keeps 10 bits, too few for the f32 bound of 2e-3 + 2e-3 |want|): at
// B = 2, S = 2048, H = 32, KV = 8, D = 128, 1.03 ms.
//
// What the design does about it: it is simple and right, on the CUDA
// cores.  One block of 128 threads owns kBQ = 64 query rows of one
// (batch, head) and walks the KV tiles of kBK = 32 keys that its rows can
// see: tiles after the causal diagonal and the prefix, and tiles before the
// window are skipped, which halves the causal work (a skipped tile
// contributes exactly 0 to every row that sees some key).  A row that sees
// no key at all (only when window > 0 and Sq - Skv >= window) gets the mean
// of V over every key, padding included, from the TPU kernel, and
// something else here; ops.py refuses such calls, and the serving path
// never makes one.  The query tile
// (scaled, transposed) stays in shared memory for the whole walk; each
// KV tile is staged into shared memory, K transposed so that a
// thread's four keys are one float4; each thread holds a 4 x 4 block of
// scores and a 4 x (D/8) block of the output accumulator in registers, the
// row statistics m and l for its four rows, and reduces them across the
// eight threads of a row with warp shuffles.  Blocks with the longest causal
// walk are launched first.  D is padded to DP, a multiple of 32 up to 256,
// with zeros, which change no score.
#include <cuda_runtime.h>

#include <cstddef>

// the bf16 form (flash_attention_wgmma.cu)
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Sq, int Skv,
                                 int H, int KV, int D, int causal, int window,
                                 int prefix_len, float scale,
                                 cudaStream_t s);

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 32;           // keys per KV tile
constexpr int kThreads = 128;     // 16 row groups (ty) x 8 column groups (tx)
constexpr int kLQ = kBQ + 4;      // row stride of the transposed Q and P tiles
constexpr int kLK = kBK + 4;      // row stride of the transposed K tile
constexpr float kNegInf = -1e30f;

template <int DP>
constexpr size_t smem_floats() {
    return static_cast<size_t>(DP) * kLQ      // Qt  (DP, kLQ)
           + static_cast<size_t>(DP) * kLK    // Kt  (DP, kLK)
           + static_cast<size_t>(kBK) * DP    // Vs  (kBK, DP)
           + static_cast<size_t>(kBK) * kLQ;  // Pt  (kBK, kLQ)
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, int Sq, int Skv, int H, int KV, int D,
            int causal, int window, int prefix_len, float scale) {
    extern __shared__ float4 smem4[];
    float* Qt = reinterpret_cast<float*>(smem4);
    float* Kt = Qt + DP * kLQ;
    float* Vs = Kt + DP * kLK;
    float* Pt = Vs + kBK * DP;

    const int qb = gridDim.x - 1 - blockIdx.x;    // longest walks first
    const int b = blockIdx.y / H;
    const int h = blockIdx.y % H;
    const int kvh = h / (H / KV);
    const int tid = threadIdx.x;
    const int ty = tid >> 3;                      // rows ty*4 .. ty*4+3
    const int tx = tid & 7;                       // this row group's lane
    const int q0 = qb * kBQ;
    const size_t q_stride = static_cast<size_t>(H) * D;
    const size_t kv_stride = static_cast<size_t>(KV) * D;
    const float* qg = q + static_cast<size_t>(b) * Sq * q_stride
                      + static_cast<size_t>(h) * D;
    float* og = o + static_cast<size_t>(b) * Sq * q_stride
                + static_cast<size_t>(h) * D;
    const float* kg = k + static_cast<size_t>(b) * Skv * kv_stride
                      + static_cast<size_t>(kvh) * D;
    const float* vg = v + static_cast<size_t>(b) * Skv * kv_stride
                      + static_cast<size_t>(kvh) * D;

    // the query tile, scaled, as the TPU kernel does
    for (int i = tid; i < kBQ * DP; i += kThreads) {
        const int r = i / DP, d = i % DP;
        float x = 0.f;
        if (q0 + r < Sq && d < D)
            x = qg[static_cast<size_t>(q0 + r) * q_stride + d] * scale;
        Qt[d * kLQ + r] = x;
    }

    constexpr int NC = DP / 32;                   // float4 column chunks
    float acc[4][NC * 4];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int n = 0; n < NC * 4; ++n) acc[i][n] = 0.f;
    }

    // the KV tiles this block's rows can see: up to the diagonal, and every
    // tile that holds a key of the prefix
    const int n_kv = (Skv + kBK - 1) / kBK;
    int kv_hi = n_kv;
    if (causal) {
        const int q_last = min(q0 + kBQ, Sq) - 1;
        kv_hi = min(n_kv, max(q_last / kBK + 1, (prefix_len + kBK - 1) / kBK));
    }
    int kv_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / kBK;

    for (int kb = kv_lo; kb < kv_hi; ++kb) {
        const int k0 = kb * kBK;
        __syncthreads();              // the last tile's Kt, Vs, Pt are read
        for (int i = tid; i < kBK * DP; i += kThreads) {
            const int c = i / DP, d = i % DP;
            float kx = 0.f, vx = 0.f;
            if (k0 + c < Skv && d < D) {
                const size_t off = static_cast<size_t>(k0 + c) * kv_stride + d;
                kx = kg[off];
                vx = vg[off];
            }
            Kt[d * kLK + c] = kx;
            Vs[c * DP + d] = vx;
        }
        __syncthreads();

        // scores of rows ty*4+i against keys tx*4+j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DP; ++d) {
            const float4 qa = *reinterpret_cast<const float4*>(
                &Qt[d * kLQ + ty * 4]);
            const float4 ka = *reinterpret_cast<const float4*>(
                &Kt[d * kLK + tx * 4]);
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }

        // mask, then the online softmax update of each row
        float corr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q0 + ty * 4 + i;
            float rmax = kNegInf;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k0 + tx * 4 + j;
                bool keep = kp < Skv;
                if (causal) keep = keep && (qp >= kp || kp < prefix_len);
                if (window > 0) keep = keep && (qp - kp) < window;
                if (!keep) s[i][j] = kNegInf;
                rmax = fmaxf(rmax, s[i][j]);
            }
            rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
            rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
            rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
            const float m_new = fmaxf(m[i], rmax);
            float rsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = expf(s[i][j] - m_new);
                rsum += s[i][j];
            }
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
            rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
            corr[i] = expf(m[i] - m_new);
            l[i] = l[i] * corr[i] + rsum;
            m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLQ + ty * 4]) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < NC * 4; ++n) acc[i][n] *= corr[i];
        __syncthreads();              // Pt is complete

        // acc += P V over this tile's keys
#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
            const float4 pa = *reinterpret_cast<const float4*>(
                &Pt[c * kLQ + ty * 4]);
            const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
            for (int n = 0; n < NC; ++n) {
                const float4 va = *reinterpret_cast<const float4*>(
                    &Vs[c * DP + n * 32 + tx * 4]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i][n * 4 + 0] = fmaf(pv[i], va.x, acc[i][n * 4 + 0]);
                    acc[i][n * 4 + 1] = fmaf(pv[i], va.y, acc[i][n * 4 + 1]);
                    acc[i][n * 4 + 2] = fmaf(pv[i], va.z, acc[i][n * 4 + 2]);
                    acc[i][n * 4 + 3] = fmaf(pv[i], va.w, acc[i][n * 4 + 3]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= Sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        if (lse != nullptr && tx == 0)
            lse[static_cast<size_t>(blockIdx.y) * Sq + r] = m[i] + logf(den);
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int d = n * 32 + tx * 4 + e;
                if (d < D)
                    og[static_cast<size_t>(r) * q_stride + d] =
                        acc[i][n * 4 + e] / den;
            }
    }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, int D, int causal,
           int window, int prefix_len, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * smem_floats<DP>();
    cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
    attn_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, H,
        KV, D, causal, window, prefix_len, scale);
    return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int B, int Sq, int Skv, int H, int KV, int D, int causal,
             int window, int prefix_len, float scale, cudaStream_t s) {
    switch ((D + 31) / 32) {
        case 1: return launch<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 2: return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 3: return launch<96>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 4: return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 5: return launch<160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 6: return launch<192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 7: return launch<224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 8: return launch<256>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32 (the form above), 1 = bfloat16 (the tensor-core form).
// prefix_len >= 0 (0: no prefix; read only when causal).  lse: null, or an
// f32 (B, H, Sq) that receives each row's log-sum-exp.  All tensors
// contiguous, on the device of the current context; the output
// is written in q's dtype.  Returns the CUDA error of the launch (0 when it
// was accepted), or -(a CUresult) when the bf16 form cannot make a tensor
// map.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype,
                                      int B, int Sq, int Skv, int H, int KV,
                                      int D, int causal, int window,
                                      int prefix_len, float scale,
                                      void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window,
                        prefix_len, scale, s);
    if (dtype == 1)
        return flash_attention_wgmma_launch(q, k, v, o, lse, B, Sq, Skv, H,
                                            KV, D, causal, window, prefix_len,
                                            scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
