// CGRA PE-array cycle step for Hopper (sm_90a), written by hand.
//
// Replaces repro/kernels/pe_array.py::_cycle_kernel (launched there by
// cycle_step_pallas through pl.pallas_call).  It computes what that kernel
// and repro_torch/kernels/ref.py::cycle_step_ref compute: one CGRA cycle for
// a batch of independent PE arrays that run the same instruction row.
//
// Design: one thread per (batch row b, PE p); a block holds
// rows_per_block = blockDim.x / P whole batch rows.  Every thread reads only
// the pre-cycle input buffers (regs, out, sf, zf, mem) and writes separate
// output buffers, so neighbour OUT reads, BSFA/BZFA flag reads and loads all
// see the state from before the cycle.  The block copies its rows of mem into
// mem_o, synchronises, then applies its stores to mem_o: stores commit at the
// end of the cycle, and a load and a store to one address in one cycle read
// the old value.  Loads and stores address memory directly; the TPU kernel's
// one-hot masking was a choice for the TPU's vector units.  Any B (the last
// block may be ragged), any P up to blockDim.x, any M.
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
// Bound: a launch moves the state in and out once, 2 * 4 * B * (7P + M)
// bytes (regs 4P + out, sf, zf 3P + mem M words per row), about 1.97 MB at
// B=1024, P=16, M=128, which is 0.6 us at 3.35 TB/s.  That is below the cost
// of one launch, so this one-launch-per-cycle design is launch-bound by
// construction; a fused whole-program kernel that keeps the state on chip
// across all T rows is the redesign.

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

__device__ __forceinline__ int32_t operand(int sel, const int32_t* regs_bp,
                                           const int32_t* out_b, int p,
                                           const int32_t* nbr_p, int32_t imm) {
  const unsigned s = static_cast<unsigned>(sel);
  if (s < 4u) return regs_bp[s];
  if (s == 4u) return out_b[p];
  if (s < 9u) return out_b[nbr_p[s - 5u]];
  if (s == 9u) return imm;
  return 0;  // 10 = ZERO; 11-15 unused, read as ZERO
}

__device__ __forceinline__ int32_t alu(int op, int32_t a, int32_t b,
                                       int32_t sf, int32_t zf) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  const uint32_t sh = ub & 31u;
  switch (op) {
    case SADD: case MOV: return static_cast<int32_t>(ua + ub);
    case SSUB: case BEQ: case BNE: case BLT: case BGE:
      return static_cast<int32_t>(ua - ub);
    case SMUL: return static_cast<int32_t>(ua * ub);
    case FXPMUL: return static_cast<int32_t>(ua * ub) >> kFxpFracBits;
    case SLT: return static_cast<int32_t>(ua << sh);
    case SRT: return static_cast<int32_t>(ua >> sh);
    case SRA: return a >> sh;
    case LAND: return a & b;
    case LOR: return a | b;
    case LXOR: return a ^ b;
    case LNAND: return ~(a & b);
    case LNOR: return ~(a | b);
    case LXNOR: return ~(a ^ b);
    case BSFA: return sf > 0 ? a : b;
    case BZFA: return zf > 0 ? a : b;
    case SWD: case SWI: return b;
    default: return 0;  // NOP, JUMP, EXIT, loads (replaced), 27-31
  }
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

  const bool imm_addr = op == LWI || op == SWI;
  const int32_t raw = static_cast<int32_t>(
      static_cast<uint32_t>(a) + static_cast<uint32_t>(imm_addr ? imm : 0));
  const int addr = raw < 0 ? 0 : (raw > M - 1 ? M - 1 : raw);
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

}  // namespace

// Plain C entry bound with ctypes.  All arrays are contiguous int32 device
// buffers: instruction row fields (P,), nbr (P, 4) as N/E/S/W, regs (B, P, 4),
// out/sf/zf (B, P), mem (B, M); the *_o buffers must not alias the inputs.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
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
