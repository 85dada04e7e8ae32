// CGRA PE-array execution for Hopper (sm_90a), written by hand: the one-cycle
// kernel and the whole-program kernel, in two layouts.
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
// final state, in one launch.  Its kStacked instance also replaces the
// jax.vmap of that scan over K same-grid programs (repro/fuzz/engine.py:508,
// run_stacked): K programs of T rows each (shorter ones NOP-padded by the
// caller) over K state stacks, the trace (K, T, B, P), one launch, and
// ref.py::run_stacked_ref is the plain version.  run_lanes_kernel computes
// the same in another layout; pe_array.py::run_cycles_geometry chooses
// between them from the shape, and both replace the same TPU constructs.
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
// operand() and alu() below select without branching, because the PEs of
// one warp run different instructions there.
//
// run_cycles_kernel design.  Instruction (t, p) is the same for every batch
// row, so the batch rows go along the lanes: a block holds R batch rows
// (R a power of two up to 32, lane r = row b0 + r) and P PEs, and warp w
// runs PE w (and, when P > 16, PEs w + nwarps, w + 2 nwarps, ..., kPe of
// them in turn, so that a block keeps at most 16 warps; 32 above P = 128).
// Every instruction field is then warp-uniform: the kernel decodes with
// branches that no warp diverges on, and a NOP costs only carrying its OUT
// forward.  Lanes past R (R < 32 at small B) run lane R - 1's column and
// write nothing.  The state stays on chip for all T rows:
//  * each lane has a register file in shared memory, file[slot][S] with
//    S = R | 1: PE p's registers (slots 4p..4p+3), its OUT in two buffers
//    (4P + cP + p), its flags (staging only), a zero slot and a scratch
//    slot.  A source is one load at a precomputed offset, a result one
//    store; uniform slots and contiguous lanes keep both free of bank
//    conflicts.  sf, zf and OUT also stay in registers;
//  * the memory image is transposed, mem_s[M][S]: word m of lane r at
//    m * S + r, conflict-free when the lanes share an address.  When it
//    does not fit at R = 1 (M near the 227 KB limit), the rows stay in
//    mem_o in device memory, with the same barriers;
//  * the program is staged by cp.async in chunks of C rows (C = T when it
//    fits in PROGRAM_SHARED_BYTES, else a ring of two chunks, the next one
//    fetched while the current one runs), 8-word records per (t, p).  A
//    pass over all threads packs each record in place: the byte offsets of
//    a and b for either OUT buffer (neighbour columns resolved from the
//    neighbour table), a control word (ALU class from a 32-entry table,
//    immediates, the destination's offset) and imm, so that a row reads
//    one 16-byte word per PE, fetched one row ahead; and it ORs per-row
//    flags from op alone into shared memory: the row is live (some op is
//    not NOP; a padding word has op = 0 and other fields non-zero), it
//    loads, it stores.  No instruction is read from device memory in the
//    loop;
//  * the state and the image are copied in by cp.async too, transposed by
//    the copies' addresses, in a second group that lands while the first
//    chunk is packed; the write-back goes out through the register files,
//    coalesced.
//
// One live row t: every warp reads operands from its file, computes, loads
// from mem_s, writes its new OUT to buffer cur ^ 1 (a NOP PE copies its OUT
// forward); barrier A; cur flips; stores go into mem_s; the block's trace
// row t is read from buffer cur, coalesced (lanes along (b, p), an equal
// run per warp), and stored one row later, so that the load's latency
// hides behind the next row.  Barrier A orders every load of row t before
// every store of row t (a load and a store to one address in one cycle
// read the old value), and every OUT write of row t before the next live
// row's reads; the next live row's OUT writes go to the other buffer,
// whose readers all passed barrier A of row t.  The stores of row t must
// be visible to the loads of the next live row t'.  If some live row lies
// between them, its barrier A orders them.  So a second barrier is needed
// only where t' is the first live row after t and t' loads: it is taken
// at the top of t' when the block has stored since its last barrier
// (`dirty`).  An all-NOP row changes no state: it writes its trace row and
// crosses no barrier.  The trailing all-NOP rows of a program (a stack's
// padding, or a program's own tail) are not run: once the last chunk is
// packed, the block knows its last live row and fills the remaining trace
// rows with the final OUT, as the NOP cycles would, or stops at once
// without a trace.  Warps' PE slots past P and lanes past the block's
// last batch row reach every barrier and never reach device memory.
//
// run_lanes_kernel design, for launches of at most LANES_MAX_WARPS warps
// (pe_array.py; gsm at B = 1024 is 512).  There the uniform layout leaves
// three quarters of its lanes idle (R = 8) and a row costs a barrier of 16
// warps; the launch is bound by the latency of one row, not by issue.  So
// a lane is one (batch row, PE), a warp W = 32 / P whole batch rows (P <=
// 32; lanes past W * P idle), and a block LANE_WARPS warps that share only
// the opcode table: no block barrier in the loop.  Registers, OUT and the
// flags stay in registers; a neighbour's OUT comes by __shfl_sync from its
// lane; the warp's rows of the memory image sit in shared memory.  Lanes
// run different opcodes, so the ALU selects without branching: the
// candidates of eight result classes, then a 3-level select tree on the
// class from a 32-entry table (lane_control).  Row t + 1 is decoded (its
// control word and three warp votes: live, loads, stores) and row t + 2
// fetched (__ldg: a row's fields are the same for every warp of the
// launch) while row t runs.  An all-NOP row costs its trace store and the
// loop's own chain; a row loads from shared
// memory only where some lane loads, and crosses __syncwarp, before and
// after its stores, only where some lane stores: the first orders every
// load of row t before every store of row t, the second the stores of row
// t before the loads of later rows.  Lanes past the batch neither store
// nor reach device memory.  A row is then about 170 instructions of one
// warp, most of them dependent, with one warp an SM sub-partition at B =
// 1024: the chain, not the bytes or the issue rate, bounds it.
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
//    that register, 4-7 write none.
//  * Selectors 11-15 read ZERO and opcodes 27-31 yield 0, as in the Pallas
//    kernel.
//  * Two stores to one address in one cycle are undefined behaviour (the
//    mapper never schedules them): here one of the stored values lands, and
//    which one is unspecified.
//
// Bounds, on 3.35 TB/s of HBM and 132 SMs x 64 INT32 lanes at 1.98 GHz
// (16.7 T int32 operations/s):
//  * cycle_step_kernel moves the state in and out once, 2 * 4 * B * (7P + M)
//    bytes: 1.97 MB at B=1024, P=16, M=128, 0.6 us, below the cost of one
//    launch.  One launch per cycle is launch-bound by construction.
//  * run_cycles_kernel moves 2 * 4 * B * (7P + M) + 4 * T * B * P
//    + 20 * T * P bytes (state in and out once, the trace written once, the
//    instructions read once): 7.50 MB at T=84, B=1024, 2.24 us; 119.6 MB at
//    B=16384, 35.7 us, 74% of it the trace.  Its integer work is about 8
//    operations per executed PE-cycle (two source selects, the ALU op, the
//    address and its clamp, two flags, the OUT write): 0.1 us and 1.6 us
//    there, far below the bytes.  What bounds it in fact is the chain of T
//    dependent rows.  At B=16384 (R = 32, 512 blocks of 16 warps) the
//    instructions the SMs issue for them set the pace; the design keeps
//    every byte but the trace off HBM inside the loop, issues a handful of
//    warp-uniform instructions per PE-cycle, crosses one barrier per live
//    row (two only where a load follows a store), none for a NOP row, and
//    runs no trailing one.  At B=1024 its rows cost what the parent's did
//    and its prologue (staging, packing) adds to them, so that shape runs
//    run_lanes_kernel, the same bytes, bound by the latency of a row's
//    chain of dependent instructions (above).
//  * A stack of K programs moves K times those bytes with T the longest
//    program's rows: 279.7 MB at K=15, T=112, B=2048, 83.5 us; each block
//    runs only its own program's live rows and fills the rest of its trace.

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
// take every case its lanes need one after another.
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

// ---------------------------------------------------------------------------
// run_cycles_kernel
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;
constexpr int kMaxPes = 256;
constexpr int kRecord = 8;               // words a staged (t, p) record
constexpr unsigned kLive = 1u, kLoads = 2u, kStores = 4u;

// The control word of a packed instruction (record word 2).  Bits 0-15:
// the word offset in the lane's register file of the register the result
// goes to (the scratch slot for none).
constexpr unsigned kClassShift = 16;     // bits 16-19: the ALU class
enum AluClass : unsigned {
  kAdd = 0, kSub, kLogic, kLoad, kStore, kMul, kShift, kFlagSel, kZero
};
constexpr unsigned kSubShift = 20;       // bits 20-21: which shift, logic
                                         // op or flag
constexpr unsigned kInvert = 1u << 22;   // kLogic: ~ of the result
constexpr unsigned kFxp = 1u << 23;      // kMul: >> 16
constexpr unsigned kImmA = 1u << 24;     // a is imm
constexpr unsigned kImmB = 1u << 25;     // b is imm
constexpr unsigned kImmAddr = 1u << 26;  // LWI/SWI: the address is a + imm
constexpr unsigned kExec = 1u << 27;     // op is not NOP

__device__ constexpr unsigned alu_control(int op) {
  switch (op) {
    case SADD: case MOV: return kAdd << kClassShift;
    case SSUB: case BEQ: case BNE: case BLT: case BGE:
      return kSub << kClassShift;
    case SMUL: return kMul << kClassShift;
    case FXPMUL: return kMul << kClassShift | kFxp;
    case SLT: return kShift << kClassShift;
    case SRT: return kShift << kClassShift | 1u << kSubShift;
    case SRA: return kShift << kClassShift | 2u << kSubShift;
    case LAND: return kLogic << kClassShift;
    case LOR: return kLogic << kClassShift | 1u << kSubShift;
    case LXOR: return kLogic << kClassShift | 2u << kSubShift;
    case LNAND: return kLogic << kClassShift | kInvert;
    case LNOR: return kLogic << kClassShift | 1u << kSubShift | kInvert;
    case LXNOR: return kLogic << kClassShift | 2u << kSubShift | kInvert;
    case BSFA: return kFlagSel << kClassShift;
    case BZFA: return kFlagSel << kClassShift | 1u << kSubShift;
    case LWD: return kLoad << kClassShift;
    case LWI: return kLoad << kClassShift | kImmAddr;
    case SWD: return kStore << kClassShift;
    case SWI: return kStore << kClassShift | kImmAddr;
    default: return kZero << kClassShift;  // JUMP, EXIT, 27-31, any other
  }
}

// The register file of one lane, file[slot * S + r]: PE p's registers at
// slots 4p..4p+3, its OUT in buffer c at slot 4P + cP + p, its flags at
// 6P + p and 7P + p (staging only: the loop keeps them in registers), a
// slot of zeros and a scratch slot.  A source is a word offset into it.
__device__ __forceinline__ unsigned source_offset(
    int sel, int p, const int32_t* nbr_s, int P, int S) {
  const unsigned s = static_cast<unsigned>(sel);
  const int col = nbr_s[4 * p + min(max(sel - 5, 0), 3)];
  const int nb = static_cast<unsigned>(col) < static_cast<unsigned>(P)
      ? col : p;
  const int slot = s < 4u ? 4 * p + static_cast<int>(s)
                 : s == 4u ? 4 * P + p                // own OUT, buffer 0
                 : s < 9u ? 4 * P + nb                // N/E/S/W OUT
                 : 8 * P;                             // ZERO, imm, 10-15
  return static_cast<unsigned>(slot * S);
}

// A source that reads OUT (selectors 4-8): its offset moves by P * S
// words in buffer 1.
__device__ __forceinline__ unsigned reads_out(int sel) {
  return static_cast<unsigned>(sel - 4) < 5u ? 1u : 0u;
}

// f(e, e / d, e % d) for e = start, start + step, ... < total, dividing
// only once.
template <class F>
__device__ __forceinline__ void split_walk(int start, int step, int total,
                                           int d, F&& f) {
  int q = start / d, rem = start - q * d;
  const int dq = step / d, dr = step - dq * d;
  for (int e = start; e < total; e += step) {
    f(e, q, rem);
    q += dq;
    rem += dr;
    if (rem >= d) {
      rem -= d;
      ++q;
    }
  }
}

__device__ __forceinline__ int clamp_address(int32_t a, int32_t offset,
                                             int M) {
  const int32_t raw = static_cast<int32_t>(static_cast<uint32_t>(a) +
                                           static_cast<uint32_t>(offset));
  return raw < 0 ? 0 : (raw > M - 1 ? M - 1 : raw);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most one group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// PEs a warp runs in turn: the fewest of 1, 2, 4, 8 that keep a block at
// 16 warps (32 for 8).
__host__ __device__ constexpr int pes_per_warp(int P) {
  return P <= 16 ? 1 : P <= 32 ? 2 : P <= 64 ? 4 : 8;
}

template <int kPe>
constexpr int max_threads() { return kPe == 8 ? 1024 : 512; }

template <int kPe>
constexpr int min_blocks() { return kPe == 8 ? 1 : 2; }

// kStacked adds the program axis: blockIdx.y = k offsets every array but
// the neighbour table.  The unstacked instance is compiled without it (the
// offsets cost the latency-bound K = 1 launch on every row).  kPe is the
// number of PEs a warp runs.  R, the chunk rows C and mem_shared come from
// pe_array.py::run_cycles_geometry and are checked by pe_run_cycles.
template <bool kStacked, int kPe>
__global__ void __launch_bounds__(max_threads<kPe>(), min_blocks<kPe>())
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
                  int T, int B, int P, int M, int R, int C, int mem_shared) {
  extern __shared__ int32_t smem[];

  if constexpr (kStacked) {  // program k of the stack: its arrays' slices
    const int64_t k = blockIdx.y;
    const int64_t fk = k * T * P, sk = k * B * P, mk = k * B * M;
    op_f += fk; dst_f += fk; sa_f += fk; sb_f += fk; imm_f += fk;
    regs += 4 * sk; out += sk; sf += sk; zf += sk; mem += mk;
    regs_o += 4 * sk; out_o += sk; sf_o += sk; zf_o += sk; mem_o += mk;
    if (outs != nullptr) outs += k * T * B * P;
  }
  const int S = R | 1;
  const int nthreads = blockDim.x;
  const int nwarps = nthreads / kLanes;
  const int tid = threadIdx.x;
  const int warp = tid / kLanes;
  const int lane = tid % kLanes;
  const int b0 = blockIdx.x * R;
  const int nrows = min(R, B - b0);
  // Lanes past R run lane R - 1's column: they read what it reads and
  // write nothing (`owner`), so no two lanes write one word.  Lanes past
  // the last batch row run a column of their own and never reach device
  // memory.
  const int r = min(lane, R - 1);
  const bool owner = lane < R;
  const bool on = owner && r < nrows;   // r is a batch row of the block
  const int nchunks = (T + C - 1) / C;
  const int slots = nchunks > 1 ? 2 : 1;
  const int CP = C * P;
  const int out_slot = 4 * P;       // OUT buffer c at out_slot + c * P
  const int sf_slot = 6 * P, zf_slot = 7 * P;
  const int zero_slot = 8 * P, scratch_slot = 8 * P + 1;

  int32_t* prog = smem;                     // [slots][C][P][kRecord]
  int32_t* file = prog + slots * kRecord * CP;              // [8P+2][S]
  int32_t* mem_s = file + (8 * P + 2) * S;                  // [M][S]
  int32_t* nbr_s = mem_s + (mem_shared ? M * S : 0);        // [P][4]
  int* flags = nbr_s + 4 * P;                               // [slots][C+1]
  int* last_s = flags + slots * (C + 1);                    // last live row
  unsigned* alu_tab = reinterpret_cast<unsigned*>(last_s + 1);   // [32]
  int32_t* mem_g = mem_o + static_cast<int64_t>(b0) * M;    // [R][M]
  int32_t* fcol = file + r;                                 // this lane's
  const int64_t mbase = static_cast<int64_t>(b0) * M;
  const int64_t sbase = static_cast<int64_t>(b0) * P;

  // chunk c of the program into slot c & 1 as (t, p) records, async
  auto stage = [&](int c) {
    const int n = min(C, T - c * C) * P;
    int32_t* dst = prog + (c & 1) * kRecord * CP;
    const int64_t g = static_cast<int64_t>(c) * CP;
    for (int e = tid; e < n; e += nthreads) {
      int32_t* rec = dst + kRecord * e;
      cp_async4(rec, op_f + g + e);
      cp_async4(rec + 1, dst_f + g + e);
      cp_async4(rec + 2, sa_f + g + e);
      cp_async4(rec + 3, sb_f + g + e);
      cp_async4(rec + 4, imm_f + g + e);
    }
    cp_async_commit();
  };

  // chunk c, landed: pack each record in place, over all threads, into
  // the source offsets of a and b for OUT buffer 0 (word 0) and 1 (word
  // 1), the control word (word 2) and imm (word 3): one 16-byte load in
  // the loop.  The row flags (zeroed beforehand) gather by shared atomics.
  auto pack = [&](int c) {
    const int rows = min(C, T - c * C);
    int32_t* base = prog + (c & 1) * kRecord * CP;
    int* fl = flags + (c & 1) * (C + 1);
    int last = -1;
    split_walk(tid, nthreads, rows * P, P, [&](int e, int i, int p) {
      int32_t* rec = base + kRecord * e;
      const int op = rec[0], dst = rec[1], sa = rec[2], sb = rec[3];
      const int32_t imm = rec[4];
      const unsigned d = static_cast<unsigned>(dst);
      const bool exec = op != NOP;
      const unsigned ctl =
          static_cast<unsigned>((exec && d < 4u ? 4 * p + static_cast<int>(d)
                                                : scratch_slot) * S) |
          static_cast<unsigned>(alu_tab[static_cast<unsigned>(op) < 32u
                                            ? op : 27]) |
          (exec ? kExec : 0u) |
          (static_cast<unsigned>(sa) == 9u ? kImmA : 0u) |
          (static_cast<unsigned>(sb) == 9u ? kImmB : 0u);
      const unsigned w0 = source_offset(sa, p, nbr_s, P, S) |
                          source_offset(sb, p, nbr_s, P, S) << 16;
      const unsigned w1 = w0 + static_cast<unsigned>(P * S) *
                                   (reads_out(sa) | reads_out(sb) << 16);
      *reinterpret_cast<int4*>(rec) = make_int4(
          static_cast<int32_t>(w0), static_cast<int32_t>(w1),
          static_cast<int32_t>(ctl), imm);
      const unsigned f = (exec ? kLive : 0u) |
                         (op == LWD || op == LWI ? kLoads : 0u) |
                         (op == SWD || op == SWI ? kStores : 0u);
      if (f) atomicOr(fl + i, static_cast<int>(f));
      if (exec) last = c * C + i;   // rows only grow along e
    });
    if (last >= 0) atomicMax(last_s, last);
  };

  // everything the block reads, asynchronously: the neighbour table and
  // the first program chunk in one group, then the state transposed into
  // the register files (lanes along b; the odd stride S keeps every copy
  // free of conflicts) and the memory image into mem_s in another, which
  // lands while the first chunk is packed
  for (int e = tid; e < 4 * P; e += nthreads) cp_async4(nbr_s + e, nbr + e);
  stage(0);
  split_walk(tid, nthreads, nrows * 4 * P, 4 * P, [&](int e, int rr, int s) {
    cp_async4(file + s * S + rr, regs + sbase * 4 + e);
  });
  split_walk(tid, nthreads, nrows * P, P, [&](int e, int rr, int p) {
    cp_async4(file + (out_slot + p) * S + rr, out + sbase + e);
    cp_async4(file + (sf_slot + p) * S + rr, sf + sbase + e);
    cp_async4(file + (zf_slot + p) * S + rr, zf + sbase + e);
  });
  if (mem_shared) {
    split_walk(tid, nthreads, nrows * M, M, [&](int e, int rr, int m) {
      cp_async4(mem_s + m * S + rr, mem + mbase + e);
    });
  } else {
    for (int e = tid; e < nrows * M; e += nthreads) mem_g[e] = mem[mbase + e];
  }
  cp_async_commit();
  if (tid == 0) *last_s = -1;
  if (tid < S) file[zero_slot * S + tid] = 0;
  for (int e = tid; e < 32; e += nthreads) alu_tab[e] = alu_control(e);
  for (int e = tid; e < slots * (C + 1); e += nthreads) flags[e] = 0;

  bool pe_on[kPe];                  // PE slot j of this thread exists
  int pe[kPe];
  int32_t sfl[kPe], zfl[kPe], own[kPe];
  int rec_of[kPe], out_of[kPe];     // PE j's record and OUT column offsets
#pragma unroll
  for (int j = 0; j < kPe; ++j) {
    const int p = warp + j * nwarps;
    pe[j] = p;
    pe_on[j] = p < P;
    rec_of[j] = kRecord * (p < P ? p : 0);   // a slot past P reads PE 0's
    out_of[j] = p * S;
    sfl[j] = zfl[j] = own[j] = 0;
  }

  // the trace elements this thread writes: element e of a row's block slab
  // (nrows * P words, b-major) comes from OUT column e % P of lane e / P.
  // Each warp takes an equal run of consecutive elements, so that the trace
  // costs every warp the same.
  const int run = (R * P + nwarps - 1) / nwarps;   // at most 32 kPe
  int t_src[kPe], t_dst[kPe];
  bool t_on[kPe];
#pragma unroll
  for (int k = 0; k < kPe; ++k) {
    const int e = warp * run + lane + k * kLanes;
    const int rr = e / P;
    t_on[k] = lane + k * kLanes < run && e < nrows * P;
    t_src[k] = (e - rr * P) * S + rr;
    t_dst[k] = e;
  }
  const int64_t row_stride = static_cast<int64_t>(B) * P;
  const int out_step = P * S;       // OUT buffer c at out_slot * S + c * step
  // this thread's OUT words of PE j in buffers 0 and 1, and the words its
  // trace elements come from
  int32_t* out_a[kPe];
  int32_t* out_b[kPe];
  const int32_t* t_a[kPe];
  const int32_t* t_b[kPe];
#pragma unroll
  for (int j = 0; j < kPe; ++j) {
    out_a[j] = fcol + out_slot * S + out_of[j];
    out_b[j] = out_a[j] + out_step;
    t_a[j] = file + out_slot * S + t_src[j];
    t_b[j] = t_a[j] + out_step;
  }

  int cur = 0;          // OUT buffer after the last live row
  bool dirty = false;   // stores since the last barrier
  for (int c = 0; c < nchunks; ++c) {
    if (c == 0)
      cp_async_wait_one();   // the state may still be in flight
    else
      cp_async_wait_all();
    __syncthreads();    // chunk c landed; every row of chunk c - 1 is done
    if (c + 1 < nchunks) {
      stage(c + 1);
      if (c >= 1)   // chunk c - 1 is done with slot (c + 1) & 1's flags
        for (int e = tid; e <= C; e += nthreads)
          flags[((c + 1) & 1) * (C + 1) + e] = 0;
    }
    pack(c);
    if (c == 0) {       // the state, and no later chunk
      if (c + 1 < nchunks)
        cp_async_wait_one();
      else
        cp_async_wait_all();
    }
    __syncthreads();    // packed records, flags, the last live row, state
    dirty = false;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kPe; ++j) {
        if (!pe_on[j]) continue;
        own[j] = fcol[out_slot * S + out_of[j]];
        sfl[j] = fcol[(sf_slot + pe[j]) * S];
        zfl[j] = fcol[(zf_slot + pe[j]) * S];
      }
    }
    const int rows = min(C, T - c * C);
    const int stop = c + 1 == nchunks
        ? max(0, min(rows, *last_s - c * C + 1)) : rows;
    // row i's flags and records are read during row i - 1: the program
    // does not change within a chunk
    const int* fl = flags + (c & 1) * (C + 1);
    const int4* rec[kPe];
    int4 in[kPe];                   // offsets for OUT 0 and 1, control, imm
#pragma unroll
    for (int j = 0; j < kPe; ++j) {
      rec[j] = reinterpret_cast<const int4*>(prog + (c & 1) * kRecord * CP +
                                             rec_of[j]);
      in[j] = *rec[j];
    }
    unsigned f = static_cast<unsigned>(fl[0]);
    int32_t* trow = outs == nullptr ? nullptr
        : outs + c * C * row_stride + sbase;
    int32_t* pend = nullptr;        // the trace row still to be stored
    int32_t pv[kPe];
    for (int i = 0; i < stop; ++i) {
      const unsigned f_next = static_cast<unsigned>(fl[i + 1]);
      const bool more = i + 1 < rows;
      int4 now[kPe];
#pragma unroll
      for (int j = 0; j < kPe; ++j) {
        now[j] = in[j];
        rec[j] += kRecord / 4 * P;
        if (more) in[j] = *rec[j];
      }
      if (f & kLive) {
        if ((f & kLoads) && dirty) __syncthreads();  // stores before loads
        int st_addr[kPe];
        int32_t st_val[kPe];
#pragma unroll
        for (int j = 0; j < kPe; ++j) {
          st_addr[j] = -1;
          st_val[j] = 0;
          if (kPe > 1 && !pe_on[j]) continue;   // warp-uniform
          const unsigned ctl = static_cast<unsigned>(now[j].z);
          const unsigned w = static_cast<unsigned>(cur ? now[j].y : now[j].x);
          const int32_t imm = now[j].w;
          // the operands first, NOP or not (a NOP's offsets are valid
          // slots): their latency overlaps the tests below
          int32_t a = fcol[w & 0xffffu];
          int32_t b = fcol[w >> 16];
          if (ctl & kExec) {
            a = (ctl & kImmA) ? imm : a;
            b = (ctl & kImmB) ? imm : b;
            const uint32_t ua = static_cast<uint32_t>(a);
            const uint32_t ub = static_cast<uint32_t>(b);
            const unsigned sub = (ctl >> kSubShift) & 3u;
            const unsigned cls = (ctl >> kClassShift) & 15u;
            int32_t res;
            if (cls == kAdd) {   // the common cases first
              res = static_cast<int32_t>(ua + ub);
            } else if (cls == kSub) {
              res = static_cast<int32_t>(ua - ub);
            } else {
              switch (cls) {  // warp-uniform
                case kLogic: {
                  const int32_t v = sub == 0 ? (a & b)
                                  : sub == 1 ? (a | b) : (a ^ b);
                  res = (ctl & kInvert) ? ~v : v;
                  break;
                }
                case kLoad: {
                  const int addr =
                      clamp_address(a, (ctl & kImmAddr) ? imm : 0, M);
                  if (mem_shared)
                    res = mem_s[addr * S + r];
                  else
                    res = on ? mem_g[static_cast<int64_t>(r) * M + addr] : 0;
                  break;
                }
                case kStore:
                  st_addr[j] =
                      clamp_address(a, (ctl & kImmAddr) ? imm : 0, M);
                  st_val[j] = b;
                  res = b;
                  break;
                case kMul:
                  res = static_cast<int32_t>(ua * ub) >>
                        ((ctl & kFxp) ? kFxpFracBits : 0);
                  break;
                case kShift: {
                  const uint32_t sh = ub & 31u;
                  res = sub == 0 ? static_cast<int32_t>(ua << sh)
                      : sub == 1 ? static_cast<int32_t>(ua >> sh)
                                 : a >> sh;
                  break;
                }
                case kFlagSel:
                  res = (sub ? zfl[j] : sfl[j]) > 0 ? a : b;
                  break;
                default: res = 0;  // JUMP, EXIT, 27-31
              }
            }
            own[j] = res;
            sfl[j] = static_cast<int32_t>(res < 0);
            zfl[j] = static_cast<int32_t>(res == 0);
            if (owner) fcol[ctl & 0xffffu] = res;
          }
          if (owner) *(cur ? out_a[j] : out_b[j]) = own[j];
        }
        __syncthreads();  // A: loads of row t done, OUT of row t visible
        dirty = false;
        cur ^= 1;
        if (f & kStores) {
#pragma unroll
          for (int j = 0; j < kPe; ++j) {
            if (st_addr[j] < 0 || !owner) continue;
            if (mem_shared)
              mem_s[st_addr[j] * S + r] = st_val[j];
            else if (on)
              mem_g[static_cast<int64_t>(r) * M + st_addr[j]] = st_val[j];
          }
          dirty = true;
        }
      }
      if (trow != nullptr) {   // trace row t: OUT after it, coalesced,
#pragma unroll                 // stored one row later (hides the load)
        for (int k = 0; k < kPe; ++k) {
          if (t_on[k] && pend != nullptr) pend[t_dst[k]] = pv[k];
          pv[k] = cur ? *t_b[k] : *t_a[k];
        }
        pend = trow;
        trow += row_stride;
      }
      f = f_next;
    }
    if (pend != nullptr) {
#pragma unroll
      for (int k = 0; k < kPe; ++k)
        if (t_on[k]) pend[t_dst[k]] = pv[k];
      pend = nullptr;
    }
    if (stop < rows) {  // trailing NOP rows: OUT holds; fill the trace
      if (trow != nullptr) {
        const int64_t left = T - (c * C + stop);
#pragma unroll
        for (int k = 0; k < kPe; ++k) {
          if (!t_on[k]) continue;
          const int32_t v = cur ? *t_b[k] : *t_a[k];
          int32_t* o = trow + t_dst[k];
          for (int64_t u = 0; u < left; ++u, o += row_stride) *o = v;
        }
      }
      break;
    }
  }

  // write-back through the register files, coalesced: OUT is in buffer
  // cur already, the flags go to their staging slots
  __syncthreads();      // the last stores and every read of the files
#pragma unroll
  for (int j = 0; j < kPe; ++j) {
    if (!pe_on[j] || !owner) continue;
    fcol[(sf_slot + pe[j]) * S] = sfl[j];
    fcol[(zf_slot + pe[j]) * S] = zfl[j];
  }
  __syncthreads();
  split_walk(tid, nthreads, nrows * 4 * P, 4 * P, [&](int e, int rr, int s) {
    regs_o[sbase * 4 + e] = file[s * S + rr];
  });
  split_walk(tid, nthreads, nrows * P, P, [&](int e, int rr, int p) {
    out_o[sbase + e] = file[out_slot * S + cur * out_step + p * S + rr];
    sf_o[sbase + e] = file[(sf_slot + p) * S + rr];
    zf_o[sbase + e] = file[(zf_slot + p) * S + rr];
  });
  if (mem_shared) {
    split_walk(tid, nthreads, nrows * M, M, [&](int e, int rr, int m) {
      mem_o[mbase + e] = mem_s[m * S + rr];
    });
  }
}

// ---------------------------------------------------------------------------
// run_lanes_kernel: small launches
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneWarps = 4;            // warps a block

// The result of an instruction in the lanes layout: the leaf of a 3-level
// select tree (bits 0-2), and what picks inside the leaf.
enum LaneClass : unsigned {
  lAddSub = 0, lLogic, lShift, lMul, lFlagSel, lPassB, lLoad, lZero
};
constexpr unsigned lSubShift = 3;        // bits 3-4: which logic op, shift
constexpr unsigned lNeg = 1u << 5;       // subtract
constexpr unsigned lInv = 1u << 6;       // ~ of the logic op
constexpr unsigned lFxp = 1u << 7;       // >> 16 of the product
constexpr unsigned lImmAddr = 1u << 8;   // LWI/SWI: the address is a + imm
constexpr unsigned lStore = 1u << 9;

__device__ constexpr unsigned lane_control(int op) {
  switch (op) {
    case SADD: case MOV: return lAddSub;
    case SSUB: case BEQ: case BNE: case BLT: case BGE: return lAddSub | lNeg;
    case SMUL: return lMul;
    case FXPMUL: return lMul | lFxp;
    case SLT: return lShift;
    case SRT: return lShift | 1u << lSubShift;
    case SRA: return lShift | 2u << lSubShift;
    case LAND: return lLogic;
    case LOR: return lLogic | 1u << lSubShift;
    case LXOR: return lLogic | 2u << lSubShift;
    case LNAND: return lLogic | lInv;
    case LNOR: return lLogic | 1u << lSubShift | lInv;
    case LXNOR: return lLogic | 2u << lSubShift | lInv;
    case BSFA: return lFlagSel;
    case BZFA: return lFlagSel | 1u << lSubShift;
    case LWD: return lLoad;
    case LWI: return lLoad | lImmAddr;
    case SWD: return lPassB | lStore;
    case SWI: return lPassB | lStore | lImmAddr;
    default: return lZero;   // NOP, JUMP, EXIT, 27-31, any other
  }
}

// A source of the lane layout: register sel (0-3), the OUT of lane `lane`
// by shuffle (4-8), imm (9) or zero (10-15), without a branch.
__device__ __forceinline__ int32_t lane_operand(unsigned sel,
                                                int32_t shuffled,
                                                int32_t imm, int32_t r0,
                                                int32_t r1, int32_t r2,
                                                int32_t r3) {
  const int32_t lo = (sel & 1u) ? r1 : r0;
  const int32_t hi = (sel & 1u) ? r3 : r2;
  const int32_t reg = (sel & 2u) ? hi : lo;
  return sel < 4u ? reg : sel - 4u < 5u ? shuffled : sel == 9u ? imm : 0;
}

// The lane that holds the OUT a source reads: N/E/S/W from `nl`, four
// lane numbers of 8 bits each; own OUT and every other source, this lane.
__device__ __forceinline__ int source_lane(unsigned sel, unsigned nl,
                                           int lane) {
  return sel - 5u < 4u ? static_cast<int>((nl >> ((sel - 5u) * 8u)) & 0xffu)
                       : lane;
}

// kStacked as in run_cycles_kernel.  W = 32 / P batch rows a warp; the
// block's warps each run their own rows, and nothing but the control
// table is shared between them.
template <bool kStacked>
__global__ void __launch_bounds__(kLanes * kLaneWarps)
run_lanes_kernel(const int32_t* __restrict__ op_f,
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
                 int T, int B, int P, int M) {
  extern __shared__ int32_t smem[];
  __shared__ unsigned tab[32];

  if constexpr (kStacked) {  // program k of the stack: its arrays' slices
    const int64_t k = blockIdx.y;
    const int64_t fk = k * T * P, sk = k * B * P, mk = k * B * M;
    op_f += fk; dst_f += fk; sa_f += fk; sb_f += fk; imm_f += fk;
    regs += 4 * sk; out += sk; sf += sk; zf += sk; mem += mk;
    regs_o += 4 * sk; out_o += sk; sf_o += sk; zf_o += sk; mem_o += mk;
    if (outs != nullptr) outs += k * T * B * P;
  }
  const int W = kLanes / P;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int b0 = (blockIdx.x * (blockDim.x / kLanes) + warp) * W;
  const int rows = max(0, min(W, B - b0));   // the warp's batch rows
  const int local = lane / P;
  const int p = lane - local * P;
  const bool active = local < rows;          // false past W * P and B
  const int64_t bp = static_cast<int64_t>(b0 + local) * P + p;
  int32_t* img = smem + warp * W * M;        // [W][M], the warp's rows
  int32_t* mem_row = img + min(local, W - 1) * M;
  const int64_t mbase = static_cast<int64_t>(b0) * M;

  for (int e = threadIdx.x; e < 32; e += blockDim.x) tab[e] = lane_control(e);
  __syncthreads();
  if (rows == 0) return;                     // no block barrier follows

  for (int e = lane; e < rows * M; e += kLanes) img[e] = mem[mbase + e];
  int32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0, own = 0, s = 0, z = 0;
  if (active) {
    r0 = regs[bp * 4];
    r1 = regs[bp * 4 + 1];
    r2 = regs[bp * 4 + 2];
    r3 = regs[bp * 4 + 3];
    own = out[bp];
    s = sf[bp];
    z = zf[bp];
  }
  unsigned nl = 0;                           // the lanes of N/E/S/W
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int col = __ldg(nbr + p * 4 + k);
    const int nb = static_cast<unsigned>(col) < static_cast<unsigned>(P)
        ? col : p;
    nl |= static_cast<unsigned>(local * P + nb) << (8 * k);
  }
  __syncwarp();                              // the image has landed

  // Row t runs while row t + 1 is decoded (its control word from the
  // table, and the warp's votes: the row is live, it loads, it stores)
  // and the fields of row t + 2 are fetched, so that the chain of row t
  // waits on no table read.
  const int32_t* f_op = op_f + p;
  const int32_t* f_dst = dst_f + p;
  const int32_t* f_sa = sa_f + p;
  const int32_t* f_sb = sb_f + p;
  const int32_t* f_imm = imm_f + p;
  int op = __ldg(f_op), dst = __ldg(f_dst), sa = __ldg(f_sa),
      sb = __ldg(f_sb), imm = __ldg(f_imm);
  int n_op = 0, n_dst = 0, n_sa = 0, n_sb = 0, n_imm = 0;
  auto fetch = [&]() {
    f_op += P; f_dst += P; f_sa += P; f_sb += P; f_imm += P;
    n_op = __ldg(f_op);
    n_dst = __ldg(f_dst);
    n_sa = __ldg(f_sa);
    n_sb = __ldg(f_sb);
    n_imm = __ldg(f_imm);
  };
  if (T > 1) fetch();
  unsigned ctl = tab[min(static_cast<unsigned>(op), 31u)];
  bool live = __any_sync(kFull, op != NOP);
  bool loads = __any_sync(kFull, (ctl & 7u) == lLoad);
  bool stores = __any_sync(kFull, ctl & lStore);
  int32_t* trow = outs == nullptr || !active ? nullptr : outs + bp;
  const int64_t row_stride = static_cast<int64_t>(B) * P;
  for (int t = 0; t < T; ++t) {
    const bool more = t + 1 < T;
    // row t + 1, fetched a row ago; its control word is read now and
    // waited for at the end of the row
    const int x_op = n_op, x_dst = n_dst, x_sa = n_sa, x_sb = n_sb,
              x_imm = n_imm;
    const unsigned n_ctl = more ? tab[min(static_cast<unsigned>(x_op), 31u)]
                                : 0u;
    if (t + 2 < T) fetch();
    if (live) {                              // warp-uniform
      const unsigned ua_sel = static_cast<unsigned>(sa);
      const unsigned ub_sel = static_cast<unsigned>(sb);
      const int32_t oa = __shfl_sync(kFull, own,
                                     source_lane(ua_sel, nl, lane));
      const int32_t ob = __shfl_sync(kFull, own,
                                     source_lane(ub_sel, nl, lane));
      const int32_t a = lane_operand(ua_sel, oa, imm, r0, r1, r2, r3);
      const int32_t bv = lane_operand(ub_sel, ob, imm, r0, r1, r2, r3);
      const uint32_t ua = static_cast<uint32_t>(a);
      const uint32_t ub = static_cast<uint32_t>(bv);
      const int addr = clamp_address(a, (ctl & lImmAddr) ? imm : 0, M);
      int32_t loaded = 0;
      if (loads) loaded = mem_row[addr];     // warp-uniform
      const unsigned sub = (ctl >> lSubShift) & 3u;
      const uint32_t neg = (ctl & lNeg) ? ~0u : 0u;
      const uint32_t sh = ub & 31u;
      const int32_t add = static_cast<int32_t>(ua + (ub ^ neg) - neg);
      const uint32_t lg = sub == 0u ? (ua & ub) : sub == 1u ? (ua | ub)
                                                             : (ua ^ ub);
      const int32_t logic =
          static_cast<int32_t>((ctl & lInv) ? ~lg : lg);
      const int32_t shift = sub == 0u ? static_cast<int32_t>(ua << sh)
                          : sub == 1u ? static_cast<int32_t>(ua >> sh)
                                      : a >> sh;
      const int32_t mul = static_cast<int32_t>(ua * ub) >>
                          ((ctl & lFxp) ? kFxpFracBits : 0);
      const int32_t flag = (sub ? z : s) > 0 ? a : bv;
      const bool c0 = ctl & 1u, c1 = ctl & 2u, c2 = ctl & 4u;
      const int32_t l0 = c0 ? logic : add;
      const int32_t l1 = c0 ? mul : shift;
      const int32_t l2 = c0 ? bv : flag;
      const int32_t l3 = c0 ? 0 : loaded;
      const int32_t res = c2 ? (c1 ? l3 : l2) : (c1 ? l1 : l0);
      if (stores) {                          // warp-uniform
        __syncwarp();                        // every load of row t is done
        if (active && (ctl & lStore)) mem_row[addr] = bv;
        __syncwarp();                        // row t + 1 sees the stores
      }
      const bool exec = op != NOP;
      const unsigned d = static_cast<unsigned>(dst);
      own = exec ? res : own;
      s = exec ? static_cast<int32_t>(res < 0) : s;
      z = exec ? static_cast<int32_t>(res == 0) : z;
      r0 = exec && d == 0u ? res : r0;
      r1 = exec && d == 1u ? res : r1;
      r2 = exec && d == 2u ? res : r2;
      r3 = exec && d == 3u ? res : r3;
    }
    if (trow != nullptr) {
      *trow = own;
      trow += row_stride;
    }
    if (more) {
      op = x_op;
      dst = x_dst;
      sa = x_sa;
      sb = x_sb;
      imm = x_imm;
      ctl = n_ctl;
      live = __any_sync(kFull, op != NOP);
      loads = __any_sync(kFull, (ctl & 7u) == lLoad);
      stores = __any_sync(kFull, ctl & lStore);
    }
  }

  if (active) {
    regs_o[bp * 4] = r0;
    regs_o[bp * 4 + 1] = r1;
    regs_o[bp * 4 + 2] = r2;
    regs_o[bp * 4 + 3] = r3;
    out_o[bp] = own;
    sf_o[bp] = s;
    zf_o[bp] = z;
  }
  __syncwarp();                              // the last stores
  for (int e = lane; e < rows * M; e += kLanes) mem_o[mbase + e] = img[e];
}

constexpr int kDefaultSharedBytes = 48 * 1024;
constexpr int kLaneSharedBytes = 96 * 1024;   // the lane layout's budget
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
constexpr int kMaxGridY = 65535;         // programs in one stacked launch

template <bool kStacked>
decltype(&run_cycles_kernel<kStacked, 1>) run_cycles_instance(int pes) {
  switch (pes) {
    case 1: return run_cycles_kernel<kStacked, 1>;
    case 2: return run_cycles_kernel<kStacked, 2>;
    case 4: return run_cycles_kernel<kStacked, 4>;
    default: return run_cycles_kernel<kStacked, 8>;
  }
}

}  // namespace

// Plain C entries bound with ctypes.  All arrays are contiguous int32 device
// buffers: nbr (P, 4) as N/E/S/W with entries in [0, P), regs (B, P, 4),
// out/sf/zf (B, P), mem (B, M); the *_o buffers must not alias the inputs.
// Each launches on `stream` and returns cudaGetLastError() (0 = launched).

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
// blocks (per program), shared_bytes, K, chunk_rows, mem_shared and layout
// (0: run_cycles_kernel, 1: run_lanes_kernel) come from
// pe_array.py::run_cycles_geometry and are checked here against each
// other.
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
                             int chunk_rows, int mem_shared, int layout,
                             cudaStream_t stream) {
  const int R = rows_per_block, C = chunk_rows;
  if (layout == 1) {
    const int warps = threads / kLanes;
    if (T <= 0 || B <= 0 || P <= 0 || P > kLanes || M <= 0 || K <= 0 ||
        K > kMaxGridY || threads % kLanes != 0 || warps <= 0 ||
        warps > kLaneWarps || R != (kLanes / P) * warps || C != T ||
        mem_shared != 1 || static_cast<int64_t>(blocks) * R < B ||
        static_cast<int64_t>(blocks - 1) * R >= B ||
        shared_bytes != 4 * R * M || shared_bytes > kLaneSharedBytes)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto lanes = K == 1 ? run_lanes_kernel<false>
                              : run_lanes_kernel<true>;
    static int lane_allowed[2] = {};
    int& allow = lane_allowed[K == 1 ? 0 : 1];
    if (shared_bytes > kDefaultSharedBytes && shared_bytes > allow) {
      const cudaError_t set = cudaFuncSetAttribute(
          lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
      if (set != cudaSuccess) return static_cast<int>(set);
      allow = shared_bytes;
    }
    lanes<<<dim3(blocks, K), threads, shared_bytes, stream>>>(
        op, dst, sa, sb, imm, nbr, regs, out, sf, zf, mem, regs_o, out_o,
        sf_o, zf_o, mem_o, outs, T, B, P, M);
    return static_cast<int>(cudaGetLastError());
  }
  if (layout != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || B <= 0 || P <= 0 || P > kMaxPes || M <= 0 || R <= 0 ||
      R > kLanes || (R & (R - 1)) != 0 || C <= 0 || C > T || K <= 0 ||
      K > kMaxGridY || static_cast<int64_t>(blocks) * R < B ||
      static_cast<int64_t>(blocks - 1) * R >= B)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pes = pes_per_warp(P);
  const int S = R | 1;
  const int slots = C < T ? 2 : 1;
  const int64_t words = (mem_shared ? static_cast<int64_t>(M) * S : 0) +
                        (8 * P + 2) * S + 4 * P +
                        static_cast<int64_t>(slots) * (C * kRecord * P +
                                                       C + 1) + 1 + 32;
  if (threads != kLanes * ((P + pes - 1) / pes) ||
      shared_bytes != 4 * words || shared_bytes > kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = K == 1 ? run_cycles_instance<false>(pes)
                             : run_cycles_instance<true>(pes);
  // the largest dynamic shared size set so far, per instance
  static int allowed[2][4] = {};
  int& allow = allowed[K == 1 ? 0 : 1][pes == 1 ? 0 : pes == 2 ? 1
                                       : pes == 4 ? 2 : 3];
  if (shared_bytes > kDefaultSharedBytes && shared_bytes > allow) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (set != cudaSuccess) return static_cast<int>(set);
    allow = shared_bytes;
  }
  kernel<<<dim3(blocks, K), threads, shared_bytes, stream>>>(
      op, dst, sa, sb, imm, nbr, regs, out, sf, zf, mem, regs_o, out_o, sf_o,
      zf_o, mem_o, outs, T, B, P, M, R, C, mem_shared);
  return static_cast<int>(cudaGetLastError());
}
