// flash_attention_wgmma: the bf16 form of the port's flash attention, on
// Hopper's tensor cores (wgmma) with TMA loads.  CUDA C++ for sm_90a, built
// with flash_attention.cu into one shared library (repro_torch/kernels/
// build.py); flash_attention.cu's C entry point sends every bf16 call here
// and every f32 call to its own CUDA-core form.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _attn_kernel for bf16.  The function is the one flash_attention.cu's
// header states: head h reads KV head h / (H / KV); the key at kp is seen by
// the query at qp iff kp < Skv, and (causal) qp >= kp, and (window > 0)
// qp - kp < window, with no Skv - Sq offset; m, l and the accumulator are
// f32; masked scores are the finite -1e30; the output is acc / max(l, 1e-30)
// rounded to nearest even.  One rounding differs: the product of two bf16
// values is exact in f32, so the score is (q . k) * scale, where the TPU
// kernel scales q first.
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
// - Tiles outside the causal diagonal or the window are skipped, per block
//   and then per warpgroup; the mask is applied only on tiles that cross
//   the diagonal, the window's edge or Skv.
// - The online softmax runs on the accumulator in registers: a row lives in
//   four threads (two shuffles), exp2 with scale * log2(e) folded in, m and
//   the thread's share of l in f32, l reduced once at the end.
// - D is padded to DP, a multiple of 16 (the k-step), up to 256; P V's
//   output columns go in wgmma pieces of 128, 64 and the rest.
#include <cuda.h>            // CUtensorMap and its enums (types only: the
                             // encoder is fetched through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;        // query rows per block: two warpgroups
constexpr int kThreads = 256;
constexpr int kRowBytes = 128;    // one swizzled row: 64 bf16 columns
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(1));
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

// waits for the phase of the given parity; a load that never lands traps
// (a launch error) after some seconds rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done, spins = 0;
    do {
        if (++spins == (1u << 26)) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of the 4-D map (D, heads, S, B) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
        "r"(row), "r"(b)
        : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
           | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
           | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
           | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin registers that wgmma reads or writes on this side of a fence or wait
template <int N>
__device__ __forceinline__ void pin(float* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major): one warpgroup; d holds the thread's N / 2 accumulators
template <int N>
__device__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, shared, MN-major)
template <int N>
__device__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

// The operand lists are written out: wgmma names every register.

template <> __device__ __forceinline__ void
wgmma_ss<64>(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_ss<128>(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<48>(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <> __device__ __forceinline__ void
wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

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
        wgmma_rs<128>(o + n0 / 2, a, desc(v + n0 / 64 * kBox, kBox, 1024));
    if constexpr (nr > n64)
        wgmma_rs<64>(o + n64 / 2, a, desc(v + n64 / 64 * kBox, kBox, 1024));
    if constexpr (DP > nr)
        wgmma_rs<DP - nr>(o + nr / 2, a,
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
                  __nv_bfloat16* __restrict__ o, int Sq, int Skv, int H,
                  int KV, int D, int causal, int window, float scale_log2) {
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

    // the KV tiles this block's rows can see
    const int n_kv = (Skv + kBK - 1) / kBK;
    int kv_hi = n_kv;
    if (causal) kv_hi = min(n_kv, (min(q0 + kRows, Sq) - 1) / kBK + 1);
    int kv_lo = 0;
    if (window > 0 && q0 - window + 1 > 0) kv_lo = (q0 - window + 1) / kBK;
    const int n_tiles = kv_hi - kv_lo;

    if (tid == 0) {
        for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
        if (causal) live = live && k0 <= qw0 + 63;
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
                wgmma_ss<kBK>(sc, desc(qa, 16, 1024), desc(ka, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait();
            pin<kBK / 2>(sc);

            // scale into log2 units; mask only a tile that crosses the
            // diagonal, the window's edge or Skv
#pragma unroll
            for (int j = 0; j < kBK / 2; ++j) sc[j] *= scale_log2;
            const bool edge = k0 + kBK > Skv
                              || (causal && k0 + kBK - 1 > qw0)
                              || (window > 0 && qw0 + 63 - k0 >= window);
            if (edge) {
#pragma unroll
                for (int j = 0; j < kBK / 2; ++j) {
                    const int qp = qw0 + row0 + 8 * ((j / 2) % 2);
                    const int kp = k0 + j / 4 * 8 + (lane % 4) * 2 + j % 2;
                    bool keep = kp < Skv;
                    if (causal) keep = keep && qp >= kp;
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
                    const __nv_bfloat162 ph =
                        __floats2bfloat162_rn(sc[j], sc[j + 1]);
                    const float2 pf = __bfloat1622float2(ph);
                    const __nv_bfloat162 pl = __floats2bfloat162_rn(
                        sc[j] - pf.x, sc[j + 1] - pf.y);
                    hi[kk][f] = *reinterpret_cast<const uint32_t*>(&ph);
                    lo[kk][f] = *reinterpret_cast<const uint32_t*>(&pl);
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

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// the map of a (B, S, heads, D) bf16 tensor as (D, heads, S, B), boxes of
// 64 columns x rows rows of one head, 128-byte swizzled, zero-filled past
// the edges; 0 or -(the CUresult) (-1 without the encoder)
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, int rows) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return -1;
    const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
    const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, step,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int D, int causal, int window,
           float scale, cudaStream_t stream) {
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
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Skv, H, KV, D, causal,
        window, scale * 1.4426950408889634f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, called by flash_attention.cu's entry point: D a multiple
// of 8 up to 256, tensors contiguous and 16-byte aligned (the wrapper pads
// D and checks the rest).  Returns the CUDA error of the launch, or -(a CUresult) when a
// tensor map cannot be made.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int Sq, int Skv, int H,
                                 int KV, int D, int causal, int window,
                                 float scale, cudaStream_t s) {
    switch ((D + 15) / 16) {
        case 1: return launch<16>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 2: return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 3: return launch<48>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 4: return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 5: return launch<80>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 6: return launch<96>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 7: return launch<112>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 8: return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 9: return launch<144>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 10: return launch<160>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 11: return launch<176>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 12: return launch<192>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 13: return launch<208>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 14: return launch<224>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 15: return launch<240>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        case 16: return launch<256>(q, k, v, o, B, Sq, Skv, H, KV, D, causal, window, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
