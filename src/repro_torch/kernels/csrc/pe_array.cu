// CGRA PE-array execution for Hopper (sm_90a), written by hand: two kernels
// that share one operand select and one ALU.
//
// cycle_step_kernel replaces repro/kernels/pe_array.py::_cycle_kernel
// (launched there by cycle_step_pallas through pl.pallas_call).  It computes
// what that kernel and repro_torch/kernels/ref.py::cycle_step_ref compute:
// one CGRA cycle for a batch of independent PE arrays that run the same
// instruction row.
//
// run_cycles_kernel replaces the lax.scan of that kernel over the T rows of
// a program (repro/kernels/ops.py:71, run_program): it computes what T
// successive cycle_step_ref calls compute, the out trace (T, B, P) and the
// final state, in one launch.  It also replaces the jax.vmap of that scan
// over K same-grid programs (repro/fuzz/engine.py:508, run_stacked): with
// K > 1 the launch runs K programs of T rows each (shorter ones NOP-padded
// by the caller) over K state stacks, the trace is (K, T, B, P), and
// ref.py::run_stacked_ref is the plain version.
//
// cycle_step_kernel design: one thread per (batch row b, PE p); a block
// holds kThreads / P whole batch rows.  Every thread reads only the
// pre-cycle input buffers (regs, out, sf, zf, mem) and writes separate
// output buffers, so neighbour OUT reads, BSFA/BZFA flag reads and loads
// all see the state from before the cycle.  The block copies its rows of
// mem into mem_o, synchronises, then applies its stores to mem_o: stores
// commit at the end of the cycle, and a load and a store to one address in
// one cycle read the old value.  Loads and stores address memory directly;
// the TPU kernel's one-hot masking was a choice for the TPU's vector units.
// Any B (the last block may be ragged), any P up to kThreads, any M.
//
// run_cycles_kernel design: one thread per (b, p) again, and a block holds
// R whole batch rows (R, the block size and the shared-memory bytes come
// from pe_array.py::run_cycles_geometry).  blockIdx.y is the program k of a
// stack: a block offsets the instruction fields by k*T*P, the state and
// memory by k*B*(...) and the trace by k*T*B*P, and reads the one neighbour
// table every program of the stack shares (one grid).  K = 1 launches the
// instance compiled without the axis.  The state stays on chip for all
// T rows: each thread keeps its own regs, sf and zf in registers (only the
// PE itself reads them), OUT lives in a shared double buffer out_s[2][R][P]
// (neighbours read it), and the memory image in shared memory mem_s[R][M],
// loaded once and written back once.  One cycle: read operands from
// registers and out_s[cur], compute, load from mem_s; write the new OUT to
// out_s[nxt] (every thread, every cycle: a NOP copies its OUT forward) and
// to the trace; barrier (every load of the cycle has read); stores into
// mem_s; barrier (stores visible to the next cycle's loads).  Threads past
// the last batch row or past R*P stay in the loop and reach every barrier.
// Instruction fields go through the read-only cache; all rows of a block
// read the same P words, and the next row's fields are fetched before the
// barriers of the current one.
//
// Semantics kept bit-exact with the JAX reference:
//  * SADD/SSUB/SMUL/branches are computed in uint32_t and cast back (signed
//    overflow is undefined in C++); SRA is an int32_t >>, SRT a uint32_t >>,
//    every shift amount is b & 31.
//  * FXPMUL is the int32-wrapped product, then an arithmetic >> 16: what the
//    JAX ref computes with x64 off, not the exact product of
//    isa.alu_semantics.
//  * Addresses are a (+ imm for LWI/SWI), wrapped to int32, clamped to
//    [0, M-1].
//  * Every op but NOP writes OUT and the sign/zero flags; dst 0-3 also writes
//    that register, 7 writes none.
//  * Selectors 11-15 read ZERO and opcodes 27-31 yield 0, as in the Pallas
//    kernel.
//  * Two stores to one address in one cycle are undefined behaviour (the
//    mapper never schedules them): here one of the stored values lands, and
//    which one is unspecified.
//
// Bounds, on 3.35 TB/s of HBM:
//  * cycle_step_kernel moves the state in and out once, 2 * 4 * B * (7P + M)
//    bytes (regs 4P + out, sf, zf 3P + mem M words per row): 1.97 MB at
//    B=1024, P=16, M=128, 0.6 us, below the cost of one launch.  One launch
//    per cycle is launch-bound by construction.
//  * run_cycles_kernel moves 2 * 4 * B * (7P + M) + 4 * T * B * P
//    + 20 * T * P bytes (state in and out once, the trace written once, the
//    instructions read once): 7.50 MB at T=84, B=1024, 2.24 us; 119.6 MB at
//    B=16384, 35.7 us, 74% of it the trace.  At B=1024 it is bound instead
//    by latency: T dependent cycles of two block barriers and a shared-memory
//    round trip each, about 256 blocks on 132 SMs.  At B=16384 the
//    instructions each thread issues per cycle set the pace: an all-NOP
//    program without a trace takes most of the time of the real one.  The
//    design keeps every byte but the trace off HBM inside the loop, makes the
//    trace stores coalesced (p is the fastest index), uses 64-thread blocks
//    so that B=1024 fills every SM, and selects operands and ALU results
//    without branches (below).
//  * A stack of K programs moves K times those bytes with T the longest
//    program's rows: 279.7 MB at K=15, T=112, B=2048, 83.5 us.  Its serial
//    floor is one program's, T dependent cycles, since the K * B/R blocks
//    run side by side; the NOP rows of the shorter programs still cost
//    their cycles and their trace stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op : int {
  NOP = 0, SADD, SSUB, SMUL, FXPMUL, SLT, SRT, SRA, LAND, LOR, LXOR, LNAND,
  LNOR, LXNOR, BSFA, BZFA, LWD, LWI, SWD, SWI, BEQ, BNE, BLT, BGE, JUMP, EXIT,
  MOV
};

constexpr int kThreads = 256;
constexpr int kFxpFracBits = 16;

// operand() and alu() select their result without branching: the PEs of a
// warp run different opcodes and selectors, and a switch makes the warp
// take every case its lanes need one after another.  regs_bp and nbr_p are
// indexed with constants only, so that the fused kernel's per-thread
// arrays stay in registers.
__device__ __forceinline__ int32_t operand(int sel, const int32_t* regs_bp,
                                           const int32_t* out_b, int p,
                                           const int32_t* nbr_p, int32_t imm) {
  const unsigned s = static_cast<unsigned>(sel);
  int32_t reg = regs_bp[0];
  reg = s == 1u ? regs_bp[1] : reg;
  reg = s == 2u ? regs_bp[2] : reg;
  reg = s == 3u ? regs_bp[3] : reg;
  int col = p;                       // 4 = own OUT, 5-8 = N/E/S/W
  col = s == 5u ? nbr_p[0] : col;
  col = s == 6u ? nbr_p[1] : col;
  col = s == 7u ? nbr_p[2] : col;
  col = s == 8u ? nbr_p[3] : col;
  const int32_t nbr_out = out_b[col];
  // 10 = ZERO; 11-15 unused, read as ZERO
  return s < 4u ? reg : (s < 9u ? nbr_out : (s == 9u ? imm : 0));
}

__device__ __forceinline__ int32_t alu(int op, int32_t a, int32_t b,
                                       int32_t sf, int32_t zf) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  const uint32_t sh = ub & 31u;
  const int32_t prod = static_cast<int32_t>(ua * ub);
  int32_t r = 0;  // NOP, JUMP, EXIT, loads (replaced), 27-31
  r = (op == SADD || op == MOV) ? static_cast<int32_t>(ua + ub) : r;
  r = (op == SSUB || (op >= BEQ && op <= BGE))
          ? static_cast<int32_t>(ua - ub) : r;
  r = op == SMUL ? prod : r;
  r = op == FXPMUL ? prod >> kFxpFracBits : r;
  r = op == SLT ? static_cast<int32_t>(ua << sh) : r;
  r = op == SRT ? static_cast<int32_t>(ua >> sh) : r;
  r = op == SRA ? a >> sh : r;
  r = op == LAND ? a & b : r;
  r = op == LOR ? a | b : r;
  r = op == LXOR ? a ^ b : r;
  r = op == LNAND ? ~(a & b) : r;
  r = op == LNOR ? ~(a | b) : r;
  r = op == LXNOR ? ~(a ^ b) : r;
  r = op == BSFA ? (sf > 0 ? a : b) : r;
  r = op == BZFA ? (zf > 0 ? a : b) : r;
  r = (op == SWD || op == SWI) ? b : r;
  return r;
}

__device__ __forceinline__ int address(int op, int32_t a, int32_t imm, int M) {
  const bool imm_addr = op == LWI || op == SWI;
  const int32_t raw = static_cast<int32_t>(
      static_cast<uint32_t>(a) + static_cast<uint32_t>(imm_addr ? imm : 0));
  return raw < 0 ? 0 : (raw > M - 1 ? M - 1 : raw);
}

__global__ void __launch_bounds__(kThreads)
cycle_step_kernel(const int32_t* __restrict__ op_row,
                  const int32_t* __restrict__ dst_row,
                  const int32_t* __restrict__ sa_row,
                  const int32_t* __restrict__ sb_row,
                  const int32_t* __restrict__ imm_row,
                  const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ regs,
                  const int32_t* __restrict__ out,
                  const int32_t* __restrict__ sf,
                  const int32_t* __restrict__ zf,
                  const int32_t* __restrict__ mem,
                  int32_t* __restrict__ regs_o, int32_t* __restrict__ out_o,
                  int32_t* __restrict__ sf_o, int32_t* __restrict__ zf_o,
                  int32_t* __restrict__ mem_o, int B, int P, int M) {
  const int rows_per_block = blockDim.x / P;
  const int b0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, B - b0);

  // stores commit at the end of the cycle: start from the pre-cycle image
  const int64_t mbase = static_cast<int64_t>(b0) * M;
  const int words = nrows * M;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    mem_o[mbase + i] = mem[mbase + i];
  __syncthreads();

  const int local = threadIdx.x / P;
  const int p = threadIdx.x - local * P;
  if (local >= nrows) return;
  const int b = b0 + local;
  const int64_t bp = static_cast<int64_t>(b) * P + p;

  const int op = op_row[p];
  const int32_t imm = imm_row[p];
  const int32_t* regs_bp = regs + bp * 4;
  const int32_t* out_b = out + static_cast<int64_t>(b) * P;
  const int32_t* nbr_p = nbr + p * 4;
  const int32_t a = operand(sa_row[p], regs_bp, out_b, p, nbr_p, imm);
  const int32_t bv = operand(sb_row[p], regs_bp, out_b, p, nbr_p, imm);
  int32_t res = alu(op, a, bv, sf[bp], zf[bp]);

  const int addr = address(op, a, imm, M);
  const int32_t* mem_b = mem + static_cast<int64_t>(b) * M;
  if (op == LWD || op == LWI) res = mem_b[addr];
  if (op == SWD || op == SWI) mem_o[static_cast<int64_t>(b) * M + addr] = bv;

  int32_t* regs_o_bp = regs_o + bp * 4;
  const bool executed = op != NOP;
  const int dst = dst_row[p];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    regs_o_bp[k] = (executed && dst == k) ? res : regs_bp[k];
  out_o[bp] = executed ? res : out_b[p];
  sf_o[bp] = executed ? static_cast<int32_t>(res < 0) : sf[bp];
  zf_o[bp] = executed ? static_cast<int32_t>(res == 0) : zf[bp];
}

struct Instr {
  int op, dst, sa, sb;
  int32_t imm;
};

__device__ __forceinline__ Instr fetch(const int32_t* __restrict__ op,
                                       const int32_t* __restrict__ dst,
                                       const int32_t* __restrict__ sa,
                                       const int32_t* __restrict__ sb,
                                       const int32_t* __restrict__ imm,
                                       int64_t i) {
  return {__ldg(op + i), __ldg(dst + i), __ldg(sa + i), __ldg(sb + i),
          __ldg(imm + i)};
}

// kStacked adds the program axis: blockIdx.y = k offsets every array but
// the neighbour table.  The unstacked instance is compiled without it, so
// K = 1 runs, instruction for instruction, the code it ran before the axis
// existed: compiled into the one kernel, the per-block offsets slowed the
// latency-bound K = 1 launch on every cycle.
template <bool kStacked>
__global__ void __launch_bounds__(kThreads)
run_cycles_kernel(const int32_t* __restrict__ op_f,
                  const int32_t* __restrict__ dst_f,
                  const int32_t* __restrict__ sa_f,
                  const int32_t* __restrict__ sb_f,
                  const int32_t* __restrict__ imm_f,
                  const int32_t* __restrict__ nbr,
                  const int32_t* __restrict__ regs,
                  const int32_t* __restrict__ out,
                  const int32_t* __restrict__ sf,
                  const int32_t* __restrict__ zf,
                  const int32_t* __restrict__ mem,
                  int32_t* __restrict__ regs_o, int32_t* __restrict__ out_o,
                  int32_t* __restrict__ sf_o, int32_t* __restrict__ zf_o,
                  int32_t* __restrict__ mem_o, int32_t* __restrict__ outs,
                  int T, int B, int P, int M, int rows_per_block) {
  extern __shared__ int32_t smem[];
  const int R = rows_per_block;

  if constexpr (kStacked) {  // program k of the stack: its arrays' slices
    const int64_t k = blockIdx.y;
    const int64_t fk = k * T * P, sk = k * B * P, mk = k * B * M;
    op_f += fk; dst_f += fk; sa_f += fk; sb_f += fk; imm_f += fk;
    regs += 4 * sk; out += sk; sf += sk; zf += sk; mem += mk;
    regs_o += 4 * sk; out_o += sk; sf_o += sk; zf_o += sk; mem_o += mk;
    if (outs != nullptr) outs += k * T * B * P;
  }
  int32_t* mem_s = smem;               // [R][M]
  int32_t* out_s = smem + R * M;       // [2][R][P]

  const int b0 = blockIdx.x * R;
  const int nrows = min(R, B - b0);
  const int local = threadIdx.x / P;
  const int p = threadIdx.x - local * P;
  const bool active = local < nrows;   // false past B and past R*P
  const int b = b0 + local;
  const int64_t bp = static_cast<int64_t>(b) * P + p;

  const int64_t mbase = static_cast<int64_t>(b0) * M;
  const int words = nrows * M;
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    mem_s[i] = mem[mbase + i];

  int32_t r[4] = {0, 0, 0, 0};
  int32_t nb[4] = {0, 0, 0, 0};
  int32_t s = 0, z = 0;
  Instr next = {NOP, 0, 0, 0, 0};
  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = regs[bp * 4 + k];
      nb[k] = nbr[p * 4 + k];
    }
    s = sf[bp];
    z = zf[bp];
    out_s[local * P + p] = out[bp];
    if (T > 0) next = fetch(op_f, dst_f, sa_f, sb_f, imm_f, p);
  }
  int32_t* mem_row = mem_s + local * M;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int32_t* out_cur = out_s + (t & 1) * R * P + local * P;
    int32_t* out_nxt = out_s + ((t + 1) & 1) * R * P + local * P;
    const Instr in = next;
    bool store = false;
    int addr = 0;
    int32_t bv = 0;
    if (active) {
      if (t + 1 < T)
        next = fetch(op_f, dst_f, sa_f, sb_f, imm_f,
                     static_cast<int64_t>(t + 1) * P + p);
      const int32_t a = operand(in.sa, r, out_cur, p, nb, in.imm);
      bv = operand(in.sb, r, out_cur, p, nb, in.imm);
      int32_t res = alu(in.op, a, bv, s, z);
      addr = address(in.op, a, in.imm, M);
      if (in.op == LWD || in.op == LWI) res = mem_row[addr];
      store = in.op == SWD || in.op == SWI;
      const bool executed = in.op != NOP;
      const int32_t new_out = executed ? res : out_cur[p];
      out_nxt[p] = new_out;
      if (outs != nullptr)
        outs[(static_cast<int64_t>(t) * B + b) * P + p] = new_out;
      if (executed) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (in.dst == k) r[k] = res;
        s = static_cast<int32_t>(res < 0);
        z = static_cast<int32_t>(res == 0);
      }
    }
    __syncthreads();  // every load of cycle t has read mem_s
    if (store) mem_row[addr] = bv;
    __syncthreads();  // the stores are visible to cycle t + 1
  }

  if (active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) regs_o[bp * 4 + k] = r[k];
    out_o[bp] = out_s[(T & 1) * R * P + local * P + p];
    sf_o[bp] = s;
    zf_o[bp] = z;
  }
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    mem_o[mbase + i] = mem_s[i];
}

constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
constexpr int kMaxGridY = 65535;         // programs in one stacked launch

}  // namespace

// Plain C entries bound with ctypes.  All arrays are contiguous int32 device
// buffers: nbr (P, 4) as N/E/S/W, regs (B, P, 4), out/sf/zf (B, P),
// mem (B, M); the *_o buffers must not alias the inputs.  Each launches on
// `stream` and returns cudaGetLastError() (0 = launched).

// One cycle: instruction row fields (P,).
extern "C" int pe_cycle_step(const int32_t* op, const int32_t* dst,
                             const int32_t* sa, const int32_t* sb,
                             const int32_t* imm, const int32_t* nbr,
                             const int32_t* regs, const int32_t* out,
                             const int32_t* sf, const int32_t* zf,
                             const int32_t* mem, int32_t* regs_o,
                             int32_t* out_o, int32_t* sf_o, int32_t* zf_o,
                             int32_t* mem_o, int B, int P, int M,
                             cudaStream_t stream) {
  if (B <= 0 || P <= 0 || P > kThreads || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kThreads / P;
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  cycle_step_kernel<<<blocks, kThreads, 0, stream>>>(
      op, dst, sa, sb, imm, nbr, regs, out, sf, zf, mem, regs_o, out_o, sf_o,
      zf_o, mem_o, B, P, M);
  return static_cast<int>(cudaGetLastError());
}

// T cycles of K programs: instruction fields (K, T, P), the state arrays
// with a leading K axis (K, B, ...), outs (K, T, B, P) or null for no
// trace; nbr (P, 4) is shared by the K programs.  rows_per_block, threads,
// blocks (per program), shared_bytes and K come from
// pe_array.py::run_cycles_geometry and are checked here against each other.
extern "C" int pe_run_cycles(const int32_t* op, const int32_t* dst,
                             const int32_t* sa, const int32_t* sb,
                             const int32_t* imm, const int32_t* nbr,
                             const int32_t* regs, const int32_t* out,
                             const int32_t* sf, const int32_t* zf,
                             const int32_t* mem, int32_t* regs_o,
                             int32_t* out_o, int32_t* sf_o, int32_t* zf_o,
                             int32_t* mem_o, int32_t* outs, int T, int B,
                             int P, int M, int rows_per_block, int threads,
                             int blocks, int shared_bytes, int K,
                             cudaStream_t stream) {
  if (T < 0 || B <= 0 || P <= 0 || M <= 0 || rows_per_block <= 0 ||
      threads > kThreads || rows_per_block * P > threads ||
      static_cast<int64_t>(blocks) * rows_per_block < B ||
      shared_bytes != rows_per_block * (M + 2 * P) * 4 ||
      shared_bytes > kMaxSharedBytes || K <= 0 || K > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      K == 1 ? run_cycles_kernel<false> : run_cycles_kernel<true>;
  if (shared_bytes > kDefaultSharedBytes) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  kernel<<<dim3(blocks, K), threads, shared_bytes, stream>>>(
      op, dst, sa, sb, imm, nbr, regs, out, sf, zf, mem, regs_o, out_o, sf_o,
      zf_o, mem_o, outs, T, B, P, M, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
