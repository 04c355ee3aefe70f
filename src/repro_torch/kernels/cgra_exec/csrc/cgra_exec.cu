// cgra_exec: cycle-accurate execution of a lowered CGRA configuration, one
// fabric instance per CUDA thread.  CUDA C++ for sm_90a, built with nvcc into
// a shared library with a plain C entry point (repro_torch/kernels/build.py)
// and bound with ctypes (repro_torch/kernels/cgra_exec/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/cgra_exec/kernel.py::_cgra_kernel
// (built by make_cgra_call).  It computes the same function: for
// t0_max + (n_iters + 1) * II + 2 cycles, every PE whose slot fires fetches
// its operands from the previous cycle's output latches, registers or
// immediate, evaluates its ALU op, the LSU-capable PEs run their LOAD/STORE
// in mem_pes order against the lane's scratchpad, register writes land, then
// the output latches update.  The TPU form's one-hot gathers (_sel_rows) and
// compare/select memory ops exist only because the TPU has no per-lane
// gather; here every thread indexes its own state and scratchpad directly.
//
// What bounds it on an H100 SXM (NVIDIA data sheet and Hopper white paper):
//   bytes      the (M, B) int32 scratchpad read once and written once, plus
//              the tables (S*P*(4 + 15) + S*P*R*3 int32) once:
//              8 * M * B + cm_bytes over 3.35 TB/s;
//   operations cycles * P ALU evaluations per lane, as int32 operations, over
//              the int32 rate: 132 SMs * 64 INT32 lanes * 1.98 GHz = 16.7
//              TOP/s (a quarter of the data sheet's 67 TFLOP/s fp32 figure,
//              which counts 128 fp32 lanes per SM and two operations per FMA).
// At the paper's sizes (M = 8192, B = 4096, P = 16..64, 63..151 cycles) the
// bytes term is the larger one: the bound is that of a copy of the images.
//
// What the design does about it: the output images start as one
// device-to-device copy of the input (cgra_exec_launch), which streams at
// the memory rate, and the kernel then touches only the words the
// configuration loads and stores.  The scratchpad stays lane-minor, (M, B),
// as the engine passes it, so when all lanes of a warp touch the same word
// (the kernel_lib kernels' addresses come from the loop counter) a warp's
// access is one coalesced 128-byte transaction.  The tables are read with __ldg and
// every thread of a block reads the same entry (a broadcast through L1).
// The per-lane state (output latches O[P], registers R[P*R] twice for the
// staged register writes, this cycle's results res[P]) lives in a global
// scratch, also lane-minor, because P reaches 64 (PACE) and beyond, and
// cannot be held in registers; it stays in L1/L2 for small batches.  The
// firing pattern is the same for every lane, so each block computes it once
// per cycle into shared memory (P ints).  The tables are not staged in
// shared memory: at ii_max = 48 and P = 64 they reach 380,928 bytes, more
// than a block may hold, and no table size may decide whether the kernel
// launches.  One thread per lane leaves the card mostly idle at B = 4096
// (32 blocks of 128 threads on 132 SMs): the kernel is latency-bound, far
// from either bound; faster forms (tables in shared memory where they fit,
// several lanes per thread) are later work.
//
// Bit-exact semantics kept from the TPU kernel:
//   * ADD, SUB, MUL wrap (computed in uint32_t: signed overflow is UB);
//   * SHL and arithmetic SHR shift by v1 & 31; ABS(INT_MIN) == INT_MIN;
//   * it = floor((t - t0) / II), with floor division (C's / truncates);
//   * when use_const is set, the immediate becomes the first absent operand
//     k with n_ops == k;
//   * a load sees earlier stores of the same cycle; a store's PE result is
//     the stored value; load address (has_idx ? v0 : 0) + const, store
//     address has2 ? v0 + const : const (int32 wrapping adds);
//   * an address outside [0, M) loads 0 and drops the store;
//   * register writes read the previous cycle's state and come before the
//     latch update; K_RESULT writes are gated by the SOURCE PE's firing;
//   * an index outside its table reads 0, as a one-hot gather does.
//
// The opcode numbers (OPC_*) and lowered source kinds (K_*) come in as -D
// flags generated from repro_torch.core.machine.OPC and
// repro_torch.core.lowering at build time; they are never written here.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#if !defined(OPC_NOP) || !defined(OPC_LOAD) || !defined(K_RESULT)
#error "build with the -D flags generated by repro_torch/kernels/build.py"
#endif

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int floor_div(int a, int b) {
    int q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// row `idx` of a lane-minor (n, B) state block; 0 outside [0, n)
__device__ __forceinline__ int sel(const int* state, int idx, int n,
                                   size_t B, int lane) {
    return static_cast<unsigned>(idx) < static_cast<unsigned>(n)
               ? state[static_cast<size_t>(idx) * B + lane]
               : 0;
}

__device__ __forceinline__ bool fires(const int* sc, int t, int II,
                                      int n_iters) {
    const int opc = __ldg(sc);
    const int t0 = __ldg(sc + 3);
    if (opc == OPC_NOP || t0 < 0 || t < t0) return false;
    return floor_div(t - t0, II) < n_iters;
}

// the three ALU operands of one PE: previous-cycle latch / register /
// immediate, the loop-carried init while it < dist, then the trailing
// immediate in the first absent slot k with n_ops == k
__device__ __forceinline__ void fetch_operands(
    const int* op, const int* sc, int t, int II, const int* O,
    const int* Rf, int P, int R, size_t B, int lane, int v[3]) {
    const int cst = __ldg(sc + 1);
    const int t0 = __ldg(sc + 3);
    const int it = t0 >= 0 ? floor_div(t - t0, II) : 0;
    int kinds[3];
    int n_ops = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const int* o = op + 5 * k;
        const int kind = __ldg(o);
        const int pe = __ldg(o + 1);
        const int reg = __ldg(o + 2);
        const int dist = __ldg(o + 3);
        const int init = __ldg(o + 4);
        int x = 0;
        if (kind == K_O) {
            x = sel(O, pe, P, B, lane);
        } else if (kind == K_R) {
            x = sel(Rf, wrap_add(wrap_mul(pe, R), reg), P * R, B, lane);
        } else if (kind == K_CONST) {
            x = cst;
        }
        if (dist > 0 && it < dist) x = init;
        kinds[k] = kind;
        n_ops += kind != K_NONE;
        v[k] = x;
    }
    if (__ldg(sc + 2) != 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (kinds[k] == K_NONE && n_ops == k) v[k] = cst;
    }
}

__device__ __forceinline__ int alu(int opc, int v0, int v1, int v2, int cst) {
    switch (opc) {
        case OPC_ADD: return wrap_add(v0, v1);
        case OPC_SUB: return wrap_sub(v0, v1);
        case OPC_MUL: return wrap_mul(v0, v1);
        case OPC_SHL:
            return static_cast<int>(static_cast<uint32_t>(v0) << (v1 & 31));
        case OPC_SHR: return v0 >> (v1 & 31);   // arithmetic on sm_90
        case OPC_AND: return v0 & v1;
        case OPC_OR: return v0 | v1;
        case OPC_XOR: return v0 ^ v1;
        case OPC_MIN: return v0 < v1 ? v0 : v1;
        case OPC_MAX: return v0 > v1 ? v0 : v1;
        case OPC_ABS: return v0 < 0 ? wrap_sub(0, v0) : v0;
        case OPC_CMPLT: return v0 < v1;
        case OPC_CMPGT: return v0 > v1;
        case OPC_CMPEQ: return v0 == v1;
        case OPC_CMPNE: return v0 != v1;
        case OPC_CMPLE: return v0 <= v1;
        case OPC_CMPGE: return v0 >= v1;
        case OPC_SELECT: return v0 != 0 ? v1 : v2;
        case OPC_MOVC: return cst;
        case OPC_ROUTE: return v0;
        default: return 0;   // NOP, LOAD, STORE: the memory pass sets these
    }
}

__global__ void __launch_bounds__(kThreads) cgra_exec_kernel(
    const int* __restrict__ scalar,    // (S, P, 4)     opcode, const, use_const, t0
    const int* __restrict__ ops,       // (S, P, 3, 5)  kind, pe, reg, dist, init
    const int* __restrict__ regw,      // (S, P, R, 3)  kind, pe, reg
    const int* __restrict__ mem_pes,   // (n_mem_pes,)  LSU PEs in port order
    int n_mem_pes,
    int* __restrict__ mem,             // (M, B) the input images, updated
    int* __restrict__ scratch,         // (2 * P + 2 * P * R, B)
    int II, int P, int R, int M, int B, int t_max, int n_iters) {
    extern __shared__ int fired[];     // (P,) this cycle's firing, per block
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = lane < B;
    const size_t Bs = static_cast<size_t>(B);
    const int PR = P * R;
    int* O = scratch;                                  // (P, B)
    int* res = O + static_cast<size_t>(P) * Bs;        // (P, B)
    int* Rc = res + static_cast<size_t>(P) * Bs;       // (P * R, B)
    int* Rn = Rc + static_cast<size_t>(PR) * Bs;       // (P * R, B)

    if (live) {
        for (int p = 0; p < P; ++p) O[static_cast<size_t>(p) * Bs + lane] = 0;
        for (int i = 0; i < PR; ++i) Rc[static_cast<size_t>(i) * Bs + lane] = 0;
    }

    const int total = t_max + (n_iters + 1) * II + 2;
    for (int t = 0; t < total; ++t) {
        const int s = t % II;
        const int* sc_s = scalar + static_cast<size_t>(s) * P * 4;
        const int* op_s = ops + static_cast<size_t>(s) * P * 15;
        const int* rw_s = regw + static_cast<size_t>(s) * PR * 3;

        __syncthreads();               // last cycle's flags are read
        for (int p = threadIdx.x; p < P; p += blockDim.x)
            fired[p] = fires(sc_s + 4 * p, t, II, n_iters);
        __syncthreads();
        if (!live) continue;

        // ---- ALU: every firing PE, operands from previous-cycle state ----
        for (int p = 0; p < P; ++p) {
            if (!fired[p]) continue;
            const int* sc = sc_s + 4 * p;
            int v[3];
            fetch_operands(op_s + 15 * p, sc, t, II, O, Rc, P, R, Bs, lane, v);
            res[static_cast<size_t>(p) * Bs + lane] =
                alu(__ldg(sc), v[0], v[1], v[2], __ldg(sc + 1));
        }

        // ---- memory ops, sequential in mem_pes (port) order --------------
        for (int i = 0; i < n_mem_pes; ++i) {
            const int mp = __ldg(mem_pes + i);
            if (!fired[mp]) continue;
            const int* sc = sc_s + 4 * mp;
            const int opc = __ldg(sc);
            if (opc != OPC_LOAD && opc != OPC_STORE) continue;
            const int* op = op_s + 15 * mp;
            const int cst = __ldg(sc + 1);
            int v[3];
            fetch_operands(op, sc, t, II, O, Rc, P, R, Bs, lane, v);
            int row;
            if (opc == OPC_LOAD) {
                const bool has_idx = __ldg(op) != K_NONE;
                const int addr = wrap_add(has_idx ? v[0] : 0, cst);
                row = static_cast<unsigned>(addr) < static_cast<unsigned>(M)
                          ? mem[static_cast<size_t>(addr) * Bs + lane]
                          : 0;
            } else {
                const bool has2 = __ldg(op + 5) != K_NONE;
                const int addr = has2 ? wrap_add(v[0], cst) : cst;
                row = has2 ? v[1] : v[0];
                if (static_cast<unsigned>(addr) < static_cast<unsigned>(M))
                    mem[static_cast<size_t>(addr) * Bs + lane] = row;
            }
            res[static_cast<size_t>(mp) * Bs + lane] = row;
        }

        // ---- end of cycle: register writes (staged), then latches --------
        for (int i = 0; i < PR; ++i) {
            const int* rw = rw_s + 3 * i;
            const int kind = __ldg(rw);
            const int sp = __ldg(rw + 1);
            int nv = Rc[static_cast<size_t>(i) * Bs + lane];
            if (kind == K_O) {
                nv = sel(O, sp, P, Bs, lane);
            } else if (kind == K_R) {
                nv = sel(Rc, wrap_add(wrap_mul(sp, R), __ldg(rw + 2)), PR, Bs,
                         lane);
            } else if (kind == K_RESULT &&
                       static_cast<unsigned>(sp) < static_cast<unsigned>(P) &&
                       fired[sp]) {
                nv = res[static_cast<size_t>(sp) * Bs + lane];
            }
            Rn[static_cast<size_t>(i) * Bs + lane] = nv;
        }
        for (int p = 0; p < P; ++p)
            if (fired[p])
                O[static_cast<size_t>(p) * Bs + lane] =
                    res[static_cast<size_t>(p) * Bs + lane];
        int* tmp = Rc;
        Rc = Rn;
        Rn = tmp;
    }
}

}  // namespace

extern "C" int cgra_exec_launch(const int* scalar, const int* ops,
                                const int* regw, const int* mem_pes,
                                const int* mem_in, int* mem_out, int* scratch,
                                int n_mem_pes, int II, int P, int R, int M,
                                int B, int t_max, int n_iters, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the output starts as a copy of the input images; the kernel then
    // updates it in place (a device-to-device copy streams at the memory
    // rate, where a per-lane copy loop would pay M dependent round trips)
    cudaError_t err = cudaMemcpyAsync(
        mem_out, mem_in, sizeof(int) * static_cast<size_t>(M) * B,
        cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (B + kThreads - 1) / kThreads;
    const size_t smem = sizeof(int) * static_cast<size_t>(P);
    cgra_exec_kernel<<<blocks, kThreads, smem, s>>>(
        scalar, ops, regw, mem_pes, n_mem_pes, mem_out, scratch, II, P, R, M,
        B, t_max, n_iters);
    return static_cast<int>(cudaGetLastError());
}
