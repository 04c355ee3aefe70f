// flash_attention_wgmma: the bf16 form of the port's flash attention, on
// Hopper's tensor cores (wgmma) with TMA loads.  CUDA C++ for sm_90a, built
// with flash_attention.cu into one shared library (repro_torch/kernels/
// build.py); flash_attention.cu's C entry point sends every bf16 call here
// and every f32 call to its own CUDA-core form.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _attn_kernel for bf16.  The function is the one flash_attention.cu's
// header states: head h reads KV head h / (H / KV); the key at kp is seen by
// the query at qp iff kp < Skv, and (causal) qp >= kp or kp < prefix_len,
// and (window > 0) qp - kp < window, with no Skv - Sq offset; m, l and the
// accumulator are f32; masked scores are the finite -1e30; the output is
// acc / max(l, 1e-30) rounded to nearest even; an lse, when given, gets
// each row's log-sum-exp.  One rounding differs: the
// product of two bf16 values is exact in f32, so the score is
// (q . k) * scale, where the TPU kernel scales q first.
//
// What bounds it on an H100 SXM (NVIDIA data sheet): operations.  The
// algorithm needs 4 D flops a kept (query, key) pair: at qwen3-8b's prefill
// (B 2, S 2048, 32 query and 8 KV heads of 128, causal) 68.7 GFLOP, 0.0695 ms
// at 989 TFLOP/s, against 0.025 ms for q, k, v and o at 3.35 TB/s.  This
// kernel does 6 D flops a pair (the split of P below), whose own floor there
// is 0.104 ms.
//
// What the design does about it:
// - Both products run on the tensor cores.  S = Q K^T is a wgmma with Q and
//   K from shared memory (K is stored key-major with D contiguous, which is
//   the K-major B operand, so nothing is transposed); O += P V is a wgmma
//   with P from registers (the accumulator layout of S is the register
//   layout of A) and V from shared memory through the descriptor's
//   transpose bit (V is keys x D with D contiguous: an MN-major B).
// - P is split.  One bf16 P keeps 8 bits, and at the main path's shape a
//   P rounded once puts rare outputs outside the bound the kernel is held
//   to (2e-3 + 1e-2 |want| against the plain f32 arithmetic).
//   So O += P_hi V + P_lo V with P_hi = bf16(P), P_lo = bf16(P - P_hi): P
//   keeps 16 bits, and the outputs agree with the plain version's to one
//   bf16 ulp.  l is summed from the f32 P.  This costs 6 D flops a pair
//   where 4 D would do.  (fp16 P would need V in fp16, inexact for bf16 V.)
// - One block of 256 threads (two warpgroups of 64 query rows) per (batch,
//   head, 128 query rows); blocks with the longest causal walk are launched
//   first.  Thread 0 loads the Q tile once and the K and V tiles (kBK = 128
//   keys for D <= 128, 64 above, for registers) into a two-stage ring of
//   shared memory with TMA, 128-byte swizzled (64 bf16 columns a row, so a
//   wider head takes several boxes), each stage completing an mbarrier;
//   tile i + 2 is loaded once both warpgroups are done with tile i, while
//   tile i + 1 is in flight.  TMA fills rows past Sq or Skv and columns past
//   D with zeros, which change no score.
// - Tiles outside the causal diagonal (and past the prefix) or the window
//   are skipped, per block and then per warpgroup; the mask is applied only
//   on tiles that cross the diagonal (and are not wholly inside the
//   prefix), the window's edge or Skv.
// - The online softmax runs on the accumulator in registers: a row lives in
//   four threads (two shuffles), exp2 with scale * log2(e) folded in, m and
//   the thread's share of l in f32, l reduced once at the end.
// - D is padded to DP, a multiple of 16 (the k-step), up to 256; P V's
//   output columns go in wgmma pieces of 128, 64 and the rest.
#include "../../csrc/hopper.cuh"   // mbarriers, TMA, descriptors, wgmma

#include <cstdint>

namespace {

using namespace hopper;

constexpr int kRows = 128;        // query rows per block: two warpgroups
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int DP>
struct Tiles {
    static constexpr int kBK = DP <= 128 ? 128 : 64;    // keys per tile
    static constexpr int kChunks = (DP + 63) / 64;      // 64-column boxes
    static constexpr int kQBytes = kChunks * kRows * kRowBytes;
    static constexpr int kKVBytes = kChunks * kBK * kRowBytes;  // K or V
    // Q, then K and V of two stages, then three mbarriers; +1024 to align
    static constexpr int kSmem = kQBytes + 4 * kKVBytes + 64 + 1024;
};

// O += P V over one 16-key step: the DP output columns in wgmma pieces of
// 128 (two swizzled column boxes), 64 and the rest (16, 32 or 48), each
// starting at a box; v is the step's first key row in box 0
template <int DP, int kBK>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        uint32_t v) {
    constexpr uint32_t kBox = kBK * kRowBytes;    // from one box to the next
    constexpr int n64 = DP / 128 * 128, nr = DP / 64 * 64;
#pragma unroll
    for (int n0 = 0; n0 < n64; n0 += 128)
        wgmma_rs<128, 1>(o + n0 / 2, a, desc(v + n0 / 64 * kBox, kBox, 1024));
    if constexpr (nr > n64)
        wgmma_rs<64, 1>(o + n64 / 2, a, desc(v + n64 / 64 * kBox, kBox, 1024));
    if constexpr (DP > nr)
        wgmma_rs<DP - nr, 1>(o + nr / 2, a,
                          desc(v + nr / 64 * kBox, kBox, 1024));
}

// K and V of tile i (keys k0 ..) into stage i % 2, completing its mbarrier
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sK,
                                        uint32_t sV, uint32_t bar, int i,
                                        int k0, int kvh, int b) {
    using T = Tiles<DP>;
    const int s = i & 1;
    const uint32_t full = bar + 8 + 8 * s;
    mbar_expect(full, 2 * T::kKVBytes);
#pragma unroll
    for (int c = 0; c < T::kChunks; ++c) {
        const uint32_t off = s * T::kKVBytes + c * T::kBK * kRowBytes;
        tma_load(sK + off, tk, full, c * 64, kvh, k0, b);
        tma_load(sV + off, tv, full, c * 64, kvh, k0, b);
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
attn_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Skv, int H, int KV, int D, int causal,
                  int window, int prefix_len, float scale_log2) {
    using T = Tiles<DP>;
    constexpr int kBK = T::kBK;
    extern __shared__ uint8_t smem_raw[];
    // the swizzle's pattern repeats every 1024 bytes: align the tiles to it
    const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t sK = sQ + T::kQBytes;          // stage s: + s * kKVBytes
    const uint32_t sV = sK + 2 * T::kKVBytes;
    const uint32_t bar = sV + 2 * T::kKVBytes;    // Q, stage 0, stage 1

    const int bh = blockIdx.x;
    const int qb = gridDim.y - 1 - blockIdx.y;    // longest walks first
    const int b = bh / H, h = bh % H;
    const int kvh = h / (H / KV);
    const int q0 = qb * kRows;
    const int tid = threadIdx.x;
    const int wg = tid / 128, lane = tid % 32;
    const int qw0 = q0 + wg * 64;                 // this warpgroup's rows
    const int row0 = (tid % 128) / 32 * 16 + lane / 4;   // and + 8

    // the KV tiles this block's rows can see: up to the diagonal, and every
    // tile that holds a key of the prefix
    const int n_kv = (Skv + kBK - 1) / kBK;
    int kv_hi = n_kv;
    if (causal)
        kv_hi = min(n_kv, max((min(q0 + kRows, Sq) - 1) / kBK + 1,
                              (prefix_len + kBK - 1) / kBK));
    int kv_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / kBK;
    const int n_tiles = kv_hi - kv_lo;

    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
        mbar_init_fence();
        mbar_expect(bar, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
            tma_load(sQ + c * kRows * kRowBytes, &tm_q, bar, c * 64, h, q0, b);
        for (int i = 0; i < 2 && i < n_tiles; ++i)
            load_kv<DP>(&tm_k, &tm_v, sK, sV, bar, i, (kv_lo + i) * kBK, kvh,
                        b);
    }
    __syncthreads();

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i & 1, k0 = (kv_lo + i) * kBK;
        mbar_wait(bar + 8 + 8 * s, (i >> 1) & 1);
        // does this warpgroup see any key of the tile?
        bool live = qw0 < Sq;
        if (causal) live = live && (k0 <= qw0 + 63 || k0 < prefix_len);
        if (window > 0) live = live && qw0 - (k0 + kBK - 1) < window;
        if (live) {
            // S = Q K^T
            float sc[kBK / 2];
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
            pin<kBK / 2>(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
                const uint32_t kc = (kk % 4) * 32;   // 16 columns
                const uint32_t qa = sQ + kk / 4 * (kRows * kRowBytes)
                                    + wg * 64 * kRowBytes + kc;
                const uint32_t ka = sK + s * T::kKVBytes
                                    + kk / 4 * (kBK * kRowBytes) + kc;
                wgmma_ss<kBK, 0, 0>(sc, desc(qa, 16, 1024), desc(ka, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait();
            pin<kBK / 2>(sc);

            // scale into log2 units; mask only a tile that crosses the
            // diagonal and is not wholly inside the prefix, the window's
            // edge or Skv
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j) sc[j] *= scale_log2;
            const bool edge = k0 + kBK > Skv
                              || (causal && k0 + kBK - 1 > qw0
                                  && k0 + kBK > prefix_len)
                              || (window > 0 && qw0 + 63 - k0 >= window);
            if (edge) {
#pragma unroll
                for (int j = 0; j < kBK / 2; ++j) {
                    const int qp = qw0 + row0 + 8 * ((j / 2) % 2);
                    const int kp = k0 + j / 4 * 8 + (lane % 4) * 2 + j % 2;
                    bool keep = kp < Skv;
                    if (causal) keep = keep && (qp >= kp || kp < prefix_len);
                    if (window > 0) keep = keep && qp - kp < window;
                    if (!keep) sc[j] = kNegInf;
                }
            }
            // the online softmax of the thread's two rows
            float corr[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float mx = m[r];
#pragma unroll
                for (int j = 0; j < kBK / 8; ++j)
                    mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r],
                                         sc[4 * j + 2 * r + 1]));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                corr[r] = exp2f(m[r] - mx);
                m[r] = mx;
                float sum = 0.f;
#pragma unroll
                for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float& p = sc[4 * j + 2 * r + e];
                        p = exp2f(p - mx);
                        sum += p;
                    }
                l[r] = l[r] * corr[r] + sum;
            }
#pragma unroll
            for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[(j / 2) % 2];

            // P as A fragments, split: P_hi = bf16(P), P_lo = bf16(P - P_hi)
            uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
                for (int f = 0; f < 4; ++f) {
                    // fragment f: keys + 8 (f / 2), row + 8 (f % 2)
                    const int j = 4 * (2 * kk + f / 2) + 2 * (f % 2);
                    split2(sc[j], sc[j + 1], hi[kk][f], lo[kk][f]);
                }

            // O += P_hi V + P_lo V
            pin<DP / 2>(acc);
            pin<kBK / 4>(&hi[0][0]);
            pin<kBK / 4>(&lo[0][0]);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk) {
                const uint32_t v = sV + s * T::kKVBytes + kk * 16 * kRowBytes;
                pv_step<DP, kBK>(acc, hi[kk], v);
                pv_step<DP, kBK>(acc, lo[kk], v);
            }
            wgmma_commit();
            wgmma_wait();
            pin<DP / 2>(acc);
        }
        __syncthreads();              // both warpgroups are done with stage s
        if (tid == 0 && i + 2 < n_tiles)
            load_kv<DP>(&tm_k, &tm_v, sK, sV, bar, i + 2, k0 + 2 * kBK, kvh,
                        b);
    }

    // acc / max(l, 1e-30), rounded to bf16; ragged rows and columns masked
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int qp = qw0 + row0 + 8 * r;
        if (qp >= Sq) continue;
        const float den = fmaxf(l[r], 1e-30f);
        // m is in log2 units of the scaled scores: back to natural ones
        if (lse != nullptr && lane % 4 == 0)
            lse[static_cast<size_t>(bh) * Sq + qp] =
                (m[r] + log2f(den)) * 0.6931471805599453f;
        __nv_bfloat16* orow =
            o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
            const int d = j * 8 + (lane % 4) * 2;
            if (d < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(acc[4 * j + 2 * r] / den,
                                          acc[4 * j + 2 * r + 1] / den);
        }
    }
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

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, int D, int causal,
           int window, int prefix_len, float scale, cudaStream_t stream) {
    using T = Tiles<DP>;
    CUtensorMap tq, tk, tv;
    int err = make_map(&tq, q, B, Sq, H, D, kRows);
    if (err == 0) err = make_map(&tk, k, B, Skv, KV, D, T::kBK);
    if (err == 0) err = make_map(&tv, v, B, Skv, KV, D, T::kBK);
    if (err != 0) return err;
    const cudaError_t set = cudaFuncSetAttribute(
        attn_kernel_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::kSmem);
    if (set != cudaSuccess) return static_cast<int>(set);
    const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
    attn_kernel_wgmma<DP><<<grid, kThreads, T::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, KV, D,
        causal, window, prefix_len, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, called by flash_attention.cu's entry point: D a multiple
// of 8 up to 256, tensors contiguous and 16-byte aligned (the wrapper pads
// D and checks the rest); lse null or an f32 (B, H, Sq).  Returns the CUDA
// error of the launch, or -(a CUresult) when a tensor map cannot be made.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Sq, int Skv,
                                 int H, int KV, int D, int causal, int window,
                                 int prefix_len, float scale,
                                 cudaStream_t s) {
    switch ((D + 15) / 16) {
        case 1: return launch<16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 2: return launch<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 3: return launch<48>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 4: return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 5: return launch<80>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 6: return launch<96>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 7: return launch<112>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 8: return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 9: return launch<144>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 10: return launch<160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 11: return launch<176>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 12: return launch<192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 13: return launch<208>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 14: return launch<224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 15: return launch<240>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        case 16: return launch<256>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, prefix_len, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
