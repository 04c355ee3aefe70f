// cgra_exec: cycle-accurate execution of a lowered CGRA configuration over a
// batch of scratchpad images, one fabric instance per lane.  CUDA C++ for
// sm_90a, built with nvcc into a shared library with a plain C entry point
// (repro_torch/kernels/build.py) and bound with ctypes
// (repro_torch/kernels/cgra_exec/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/cgra_exec/kernel.py::_cgra_kernel
// (built by make_cgra_call).  It computes the same function: for
// t0_max + (n_iters + 1) * II + 2 cycles, every PE whose slot fires fetches
// its operands from the previous cycle's output latches, registers or
// immediate, evaluates its ALU op, the LSU-capable PEs run their LOAD/STORE
// in mem_pes order against the lane's scratchpad, register writes land, then
// the output latches update.  The TPU form's one-hot gathers and
// compare/select memory ops exist only because the TPU has no per-lane
// gather; here every thread indexes its lane's state and scratchpad.
//
// What bounds it on an H100 SXM (NVIDIA data sheet, Hopper white paper):
//   bytes      the (M, B) int32 images read once and written once, plus the
//              tables once: 8 * M * B + cm_bytes over 3.35 TB/s;
//   operations cycles * P ALU evaluations per lane as int32 operations over
//              132 SMs * 64 INT32 lanes * 1.98 GHz = 16.7 TOP/s.
// At the paper's sizes (M = 8192, B = 4096, P = 16..64, 63..151 cycles) the
// bytes term is the larger: the bound is a copy of the images (0.080 ms).
//
// The design:
//   * The output images start as one device-to-device copy of the input
//     (cgra_exec_launch), which streams at the memory rate; the kernel then
//     touches only the words the configuration loads and stores.  The
//     scratchpad stays lane-minor, (M, B): when the lanes of a warp touch
//     the same word (addresses from the loop counter) the warp's access is
//     one 128-byte transaction.
//   * The host packs the tables per II slot (ops.pack_tables): the PEs that
//     can fire, their operands decoded to a state row or an immediate, the
//     LOAD/STORE PEs in port order, the live register writes.  A gemm slot
//     on HyCUBE 4x4 holds 6-9 firing PEs of 16 and 1-4 register writes of
//     64, so a cycle walks those and not all P PEs and P*R registers.  The
//     packed tables are staged in shared memory once per block where they
//     fit, else read through the read-only path (__ldg); every lane of a
//     warp reads the same record, a broadcast.
//   * The per-lane state (output latches, registers, this cycle's results,
//     staged register writes: P * (1 + R) + n_fire + n_stage words) lives in
//     shared memory, lane-minor ([row][lane]): record indices are
//     warp-uniform, so a warp's access is conflict-free.  Where even one
//     group of 32 lanes' state does not fit, it lives in a global scratch,
//     lane-minor too.  Size only ever picks the form (ops.plan_launch); it
//     never decides whether the kernel launches.
//   * B = 4096 lanes are only 128 warps for 528 schedulers, but the PEs of
//     one cycle are independent (the ALU reads only the previous cycle's
//     state).  A block holds `groups` groups of 32 lanes, and each group's
//     cycle is spread over `warps` warps: phase 1 runs the memory pass in
//     warp 0 beside the ALU PEs and the staged register writes in the
//     others; phase 2, after a barrier, commits the register writes and the
//     latches of the firing PEs, spread over all warps; a barrier ends the
//     cycle.  With one warp a group, a thread owns its lane's state and the
//     cycle needs no barrier.
//   * Whether a PE fires is warp-uniform and computed per thread from its
//     record: at cycle t = q * II + s it fires when 0 <= q + d < n_iters,
//     with d = floor((s - t0) / II) packed on the host (no division, no
//     flag array, no barrier for it).
//   * The memory pass keeps port order per lane, but a load does not wait on
//     the loads before it: a batch of up to kMemBatch records computes its
//     addresses, issues all its loads together, forwards the values of
//     earlier same-cycle stores by comparing addresses, then writes its
//     stores in port order.  The HBM latencies of a cycle overlap.
//
// Bit-exact semantics kept from the TPU kernel:
//   * ADD, SUB, MUL wrap (computed in uint32_t: signed overflow is UB);
//   * SHL and arithmetic SHR shift by v1 & 31; ABS(INT_MIN) == INT_MIN;
//   * it = floor((t - t0) / II), with floor division (folded into d);
//   * when use_const is set, the immediate becomes the first absent operand
//     k with n_ops == k (folded into the packed operand);
//   * a load sees earlier stores of the same cycle; a store's PE result is
//     the stored value; load address (has_idx ? v0 : 0) + const, store
//     address has2 ? v0 + const : const (int32 wrapping adds);
//   * an address outside [0, M) loads 0 and drops the store;
//   * register writes read the previous cycle's state and come before the
//     latch update; K_RESULT writes are gated by the SOURCE PE's firing;
//   * an index outside its table reads 0, as a one-hot gather does.
//
// The opcode numbers (OPC_*), the lowered source kinds (K_*) and the packed
// record sizes (*_WORDS) come in as -D flags generated from
// repro_torch.core.machine.OPC, repro_torch.core.lowering and ops.py at
// build time; they are never written here.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#if !defined(OPC_NOP) || !defined(OPC_LOAD) || !defined(K_RESULT) || \
    !defined(HDR_WORDS) || !defined(MAX_THREADS)
#error "build with the -D flags generated by repro_torch/kernels/build.py"
#endif

namespace {

constexpr int kMemBatch = 4;   // memory records whose loads issue together

struct Args {
    const int* packed;   // the packed tables (ops.PackedTables.words)
    int* mem;            // (M, B) the output images, updated in place
    int* gstate;         // (state rows, blocks * lanes) or null
    int words;           // packed words, a multiple of 4
    int II, P, R, n_fire, n_stage, M, B, total, n_iters;
};

__device__ __forceinline__ int wrap_add(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
    return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ bool fires(int it, int n_iters) {
    return static_cast<unsigned>(it) < static_cast<unsigned>(n_iters);
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
        default: return 0;   // NOP; a LOAD/STORE PE off the memory ports
    }
}

// One lane's view of the state: row r of a lane-minor block lies at
// S[r * stride] (shared memory, or the global scratch).
struct Lane {
    int* S;
    int stride;
    __device__ __forceinline__ int& at(int row) const { return S[row * stride]; }
};

// an operand record (src, imm, dist, init) at iteration `it`; row 0 is read
// where src < 0, so that the read never waits on the record's test
__device__ __forceinline__ int operand(const Lane& st, int4 o, int it) {
    const int x = st.at(o.x > 0 ? o.x : 0);
    if (o.z > 0 && it < o.z) return o.w;
    return o.x >= 0 ? x : o.y;
}

template <bool kTablesShared>
__device__ __forceinline__ int4 rec(const int* T, int off) {
    const int4* p = reinterpret_cast<const int4*>(T + off);
    if constexpr (kTablesShared) return *p;
    else return __ldg(p);
}

// The memory pass of one lane for one cycle, in port order: per batch of
// kMemBatch records, the records and their operands are read together, all
// loads issue together, earlier same-cycle stores are forwarded by address,
// then the stores land in port order.
template <bool kT>
__device__ __forceinline__ void memory_pass(const Args& a, const int* T,
                                            const Lane& st, int res0,
                                            int n_mem, int mem_off, int q,
                                            int lane) {
    const size_t Bs = static_cast<size_t>(a.B);
    for (int base = 0; base < n_mem; base += kMemBatch) {
        int4 e[kMemBatch], o0[kMemBatch], o1[kMemBatch];
#pragma unroll
        for (int k = 0; k < kMemBatch; ++k) {
            const int i = base + k < n_mem ? base + k : n_mem - 1;
            const int off = mem_off + i * MEM_WORDS;
            e[k] = rec<kT>(T, off);                 // j, store | has << 1, c, d
            o0[k] = rec<kT>(T, off + 4);
            o1[k] = rec<kT>(T, off + 8);
        }
        // what: 0 idle, 1 load, 2 load out of range, 3 store, 4 dropped store
        int what[kMemBatch], addr[kMemBatch], val[kMemBatch];
#pragma unroll
        for (int k = 0; k < kMemBatch; ++k) {
            const int it = q + e[k].w;
            const bool store = e[k].y & 1, has = e[k].y >> 1;
            const int v0 = operand(st, o0[k], it);
            const int v1 = operand(st, o1[k], it);
            addr[k] = store ? (has ? wrap_add(v0, e[k].z) : e[k].z)
                            : wrap_add(has ? v0 : 0, e[k].z);
            val[k] = store ? (has ? v1 : v0) : 0;
            what[k] = base + k < n_mem && fires(it, a.n_iters)
                          ? (store ? 3 : 1) +
                                (static_cast<unsigned>(addr[k]) >=
                                 static_cast<unsigned>(a.M))
                          : 0;
        }
        // every load of the batch in flight at once
#pragma unroll
        for (int k = 0; k < kMemBatch; ++k)
            if (what[k] == 1)
                val[k] = a.mem[static_cast<size_t>(addr[k]) * Bs + lane];
        // a load sees the earlier stores of this cycle to its address
#pragma unroll
        for (int k = 1; k < kMemBatch; ++k) {
            if (what[k] != 1) continue;
#pragma unroll
            for (int i = 0; i < k; ++i)
                if (what[i] == 3 && addr[i] == addr[k]) val[k] = val[i];
        }
#pragma unroll
        for (int k = 0; k < kMemBatch; ++k) {
            if (what[k] == 0) continue;
            st.at(res0 + e[k].x) = val[k];          // 0 for a load out of range
            if (what[k] == 3)
                a.mem[static_cast<size_t>(addr[k]) * Bs + lane] = val[k];
        }
    }
}

template <bool kStateShared, bool kTablesShared>
__global__ void __launch_bounds__(MAX_THREADS) cgra_exec_kernel(const Args a) {
    extern __shared__ int4 smem4[];
    int* smem = reinterpret_cast<int*>(smem4);
    const int x = threadIdx.x, y = threadIdx.y;
    const int lanes = blockDim.x, W = blockDim.y;
    const int lane = blockIdx.x * lanes + x;
    const bool live = lane < a.B;

    const int* T = a.packed;
    int* state_smem = smem;
    if constexpr (kTablesShared) {
        const int n4 = a.words / 4;
        const int4* src = reinterpret_cast<const int4*>(a.packed);
        for (int i = y * lanes + x; i < n4; i += lanes * W)
            smem4[i] = __ldg(src + i);
        T = smem;
        state_smem = smem + a.words;
    }
    Lane st;
    if constexpr (kStateShared) {
        st.S = state_smem + x;
        st.stride = lanes;
    } else {
        st.S = a.gstate + static_cast<size_t>(blockIdx.x) * lanes + x;
        st.stride = gridDim.x * lanes;
    }
    const int PR = a.P * a.R;
    const int res0 = a.P + PR;                  // this cycle's results
    const int stage0 = res0 + a.n_fire;         // staged register writes
    for (int r = y; r < res0; r += W) st.at(r) = 0;
    __syncthreads();

    // phase-1 workers for the ALU and staging records: all warps of a group
    // when it has one, else every warp but the memory warp 0
    const int w0 = W == 1 ? 0 : y - 1, ws = W == 1 ? 1 : W - 1;
    int s = 0, q = 0;
    int4 h0 = rec<kTablesShared>(T, 0), h1 = rec<kTablesShared>(T, 4),
         h2 = rec<kTablesShared>(T, 8);
    for (int t = 0; t < a.total; ++t) {
        const int n_fire = h0.x, fire_off = h0.y, n_alu = h0.z,
                  alu_off = h0.w, n_mem = h1.x, mem_off = h1.y,
                  n_stage = h1.z, n_rw = h1.w, rw_off = h2.x;
        const int q_now = q;
        if (++s == a.II) {
            s = 0;
            ++q;
        }

        // ---- phase 1: memory pass | ALU, staged register writes ----------
        if (y == 0 && live)
            memory_pass<kTablesShared>(a, T, st, res0, n_mem, mem_off, q_now,
                                       lane);
        if (W == 1 || y > 0) {
            for (int i = w0; i < n_alu + n_stage; i += ws) {
                if (i < n_alu) {
                    const int off = alu_off + i * ALU_WORDS;
                    const int4 e0 = rec<kTablesShared>(T, off);  // j opc d c
                    const int4 o0 = rec<kTablesShared>(T, off + 4);
                    const int4 o1 = rec<kTablesShared>(T, off + 8);
                    const int4 o2 = rec<kTablesShared>(T, off + 12);
                    const int it = q_now + e0.z;
                    const int v0 = operand(st, o0, it);
                    const int v1 = operand(st, o1, it);
                    const int v2 = operand(st, o2, it);
                    if (fires(it, a.n_iters))
                        st.at(res0 + e0.x) = alu(e0.y, v0, v1, v2, e0.w);
                } else {
                    const int k = i - n_alu;
                    const int4 e = rec<kTablesShared>(T, rw_off + k * RW_WORDS);
                    const int v = st.at(e.y > 0 ? e.y : 0);
                    st.at(stage0 + k) = e.y >= 0 ? v : 0;
                }
            }
        }
        // the next slot's header, read while this cycle finishes
        h0 = rec<kTablesShared>(T, s * HDR_WORDS);
        h1 = rec<kTablesShared>(T, s * HDR_WORDS + 4);
        h2 = rec<kTablesShared>(T, s * HDR_WORDS + 8);
        if (W > 1) __syncthreads();

        // ---- phase 2: register writes, then latches of the firing PEs ----
        // (two items at a time, both read before either lands: the items
        // read results and staged rows and write latch and register rows)
        const int n_items = n_rw + n_fire;
        for (int i = y; i < n_items; i += 2 * W) {
            int dst[2], v[2];
            bool go[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const int k = i + u * W < n_items ? i + u * W : n_items - 1;
                int src;
                bool on;
                if (k < n_rw) {
                    const int4 e = rec<kTablesShared>(T, rw_off + k * RW_WORDS);
                    dst[u] = e.x;
                    src = k < n_stage ? stage0 + k : res0 + e.y;
                    on = k < n_stage || fires(q_now + e.z, a.n_iters);
                } else {
                    const int j = k - n_rw;
                    const int4 e = rec<kTablesShared>(T, fire_off + j * FIRE_WORDS);
                    dst[u] = e.x;
                    src = res0 + j;
                    on = fires(q_now + e.y, a.n_iters);
                }
                v[u] = st.at(src);
                go[u] = i + u * W < n_items && on;
            }
#pragma unroll
            for (int u = 0; u < 2; ++u)
                if (go[u]) st.at(dst[u]) = v[u];
        }
        if (W > 1) __syncthreads();
    }
}

template <bool kS, bool kT>
cudaError_t launch(const Args& a, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream) {
    auto* kernel = &cgra_exec_kernel<kS, kT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, block, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Returns 0 or the CUDA error of the copy, the attribute or the launch.
// `groups` groups of 32 lanes a block, `warps` warps a group; the state and
// the tables in shared memory where `state_shared` / `tables_shared` say
// (ops.plan_launch), `smem` bytes in all.
extern "C" int cgra_exec_launch(const int* packed, const int* mem_in,
                                int* mem_out, int* gstate, int words, int II,
                                int P, int R, int n_fire, int n_stage, int M,
                                int B, int total, int n_iters, int groups,
                                int warps, int state_shared, int tables_shared,
                                int smem, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // the output starts as a copy of the input images; the kernel then
    // updates it in place (a device-to-device copy streams at the memory
    // rate, where a per-lane copy loop would pay M dependent round trips)
    cudaError_t err = cudaMemcpyAsync(
        mem_out, mem_in, sizeof(int) * static_cast<size_t>(M) * B,
        cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!state_shared && gstate == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{packed, mem_out, gstate, words, II, P, R, n_fire, n_stage,
                 M, B, total, n_iters};
    const int lanes = 32 * groups;
    const dim3 grid((B + lanes - 1) / lanes), block(lanes, warps);
    const size_t bytes = static_cast<size_t>(smem);
    if (state_shared && tables_shared)
        err = launch<true, true>(a, grid, block, bytes, s);
    else if (state_shared)
        err = launch<true, false>(a, grid, block, bytes, s);
    else if (tables_shared)
        err = launch<false, true>(a, grid, block, bytes, s);
    else
        err = launch<false, false>(a, grid, block, bytes, s);
    return static_cast<int>(err);
}
