// The fuzz oracle for Hopper (sm_90a), written by hand: an interpreter of
// a CIL program's compiled table (kernels/oracle.py::compile_oracle), one
// memory a thread.
//
// It replaces no TPU kernel.  The JAX package runs this oracle in numpy on
// the host (repro/fuzz/engine.py::batched_oracle), and so did the port
// until it set the pace of the fuzz path.  Its semantics are those of the
// port's fuzz/engine.py::_batched_interpret, op for op, written from that
// file's _alu_vec: this file shares no code with pe_array.cu, because the
// oracle is what the PE array is judged against and a fault copied into
// both would hide itself.  kernels/oracle.py::oracle_ref and
// oracle_verdict_ref are the plain versions.
//
// Semantics.  Every value is an int32 (the table refuses constants,
// immediates and carry initial values outside 32 bits, so the numpy
// oracle's int64 values are int32 too).  Additions, subtractions,
// products and the logic ops wrap; FXPMUL is the exact 64-bit product
// shifted right arithmetically by 16, then wrapped; shifts take b & 31,
// SRT shifts the unsigned word; the branch ops compute a - b; JUMP, EXIT
// and NOP give 0; BSFA / BZFA take a where their producer's value of this
// iteration is negative / zero, else b; a store's value is b.  An absent
// operand a reads the immediate (0 for LWI / SWI), an absent b the
// immediate; a load or store address is a (+ imm for LWI / SWI), checked
// in 64 bits against [0, M).  An access outside is not performed: the
// thread stops, and the first such (iteration, slot) over all memories
// goes to the error word by atomicMin, which the wrapper turns into the
// numpy oracle's IndexError.  Carries take their update node's value after
// each iteration.
//
// Bound.  A launch reads the B x M int32 images once and writes them back
// as int64, with the N x B int64 node values: at B = 16384, M = 128 a
// 8 MB read and a 16 MB write, about 7 us at 3.35 TB/s; the work is about
// ten integer operations a node and iteration a memory (16384 x 304 x 10
// at most on the shipped kernels, under 1 us at 16.7 T int32 ops/s).  With
// one thread a memory the launch is latency bound: every thread walks the
// same chain of nodes, each a few dependent shared-memory accesses.  The
// verdict epilogue reads the simulator's images and node values once more
// (8 MB and K x 64 KB at B = 16384, M = 128: 2.5 us at 3.35 TB/s).
//
// Design.  The table is the same for every memory, so a block of T = 32
// memories (one a thread, one warp) runs it in lockstep: the warp reads
// the same record at once (a broadcast from shared memory) and every
// branch on it is warp-uniform.  A block stages in shared memory
//  * the table: N records of 8 words, the carries' update slots and
//    initial values;
//  * the node values and the carries, vals[slot][T] and carry[c][T]: a
//    warp-uniform slot and consecutive threads, free of bank conflicts;
//  * the images, word-major with an odd stride, img[word][T + 1]: the
//    coalesced copy in (consecutive words of a row) and a warp-uniform
//    address (consecutive threads) both land on 32 distinct banks, and a
//    data-dependent address spreads over the banks at random.
// Threads touch only their own column of vals, carry and img, so the
// interpreter needs no barrier; one before it (the staging) and one after
// it (the write-back) suffice.  The copy in reads the block's rows of the
// int32 batch as one contiguous run, the write-back writes them as int64
// the same way, and the node values go out [slot][B], coalesced.  Where
// the images do not fit in 227 KB (M above about 1,700 words), they stay
// in the output buffer in device memory (kImageShared false):
// the block widens its rows there first, and each thread then loads and
// stores its own row.  The ragged last block masks its missing rows.
//
// The verdict epilogue (kernels/oracle.py::oracle_verdict).  The fuzz path
// compares the simulator's result with the oracle's, and both are on the
// card when the oracle runs: the simulator's final images
// (B, M) int32 and its last-iteration node values (K, B) int32, each with
// the table slot it belongs to.  The block holds its rows' oracle images
// in shared memory already, so the compare costs one more read of the
// simulator's rows and no pass over the oracle's output.  Each thread
// compares its K node values with vals[slot][t], and its own row of the
// simulator's images with its own oracle image, column t of
// img[word][T + 1] (consecutive threads, distinct banks), or its own row
// in the output buffer where the images stay in device memory: a thread
// reads only what it wrote itself, so the epilogue needs no barrier and
// no warp vote, and runs before the write-back's barrier.  A block is one
// warp whose instructions issue one after another, so the instructions a
// word set the epilogue's time: the simulator's row comes in 16-byte
// loads, four words each, eight in flight (where M % 4 == 0), with no
// index arithmetic a word.  A coalesced walk over the block's rows as one
// run of words needs a word's row and place from a division or a wrapping
// counter, several times the instructions.  Every comparison is int32
// equality, the low 32 bits that fuzz/engine.py::compare_batch compares.
// The verdict word of a memory is kNodeMismatch | kImageMismatch of what
// differed, 0 where all agree.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// Operation classes, in the order of kernels/oracle.py.
enum OpClass : int32_t {
  kAdd, kSub, kMul, kFxpmul, kShl, kShrLogical, kShrArith, kAnd, kOr, kXor,
  kNand, kNor, kXnor, kZero, kLoad, kStore, kSelectSign, kSelectZero,
};
// Operand kinds.
enum Kind : int32_t { kNone, kInt, kVal, kCarry };
constexpr int32_t kATakesImm = 1;       // an absent a reads imm, else 0
constexpr int32_t kAddressAddsImm = 2;  // LWI / SWI
constexpr int kRecord = 8;              // words of a node record
constexpr int kFxpFracBits = 16;
constexpr int kMaxThreads = 32;
constexpr int kMaxSharedBytes = 232448;
constexpr int kDefaultSharedBytes = 48 * 1024;
// Bits of a verdict word.
constexpr int32_t kNodeMismatch = 1;
constexpr int32_t kImageMismatch = 2;

// The verdict epilogue's operands: the simulator's final
// images (B, M) and last-iteration node values (K, B), the table slot of
// each of those K nodes, and one verdict word a memory.
struct Verdict {
  const int32_t* sim_image;
  const int32_t* sim_vals;
  const int32_t* slots;
  int32_t* word;
  int K;
};

__device__ __forceinline__ int32_t alu(int32_t op, int32_t a, int32_t b) {
  const uint32_t ua = static_cast<uint32_t>(a);
  const uint32_t ub = static_cast<uint32_t>(b);
  const uint32_t s = ub & 31u;
  switch (op) {
    case kAdd: return static_cast<int32_t>(ua + ub);
    case kSub: return static_cast<int32_t>(ua - ub);
    case kMul: return static_cast<int32_t>(ua * ub);
    case kFxpmul: {
      const int64_t p = static_cast<int64_t>(a) * static_cast<int64_t>(b);
      return static_cast<int32_t>(static_cast<uint32_t>(p >> kFxpFracBits));
    }
    case kShl: return static_cast<int32_t>(ua << s);
    case kShrLogical: return static_cast<int32_t>(ua >> s);
    case kShrArith: return a >> s;
    case kAnd: return a & b;
    case kOr: return a | b;
    case kXor: return a ^ b;
    case kNand: return ~(a & b);
    case kNor: return ~(a | b);
    case kXnor: return ~(a ^ b);
    default: return 0;                  // kZero
  }
}

// Operand (kind, arg) of thread t; `absent` is what an absent one reads.
__device__ __forceinline__ int32_t fetch(int32_t kind, int32_t arg,
                                         int32_t absent, const int32_t* vals,
                                         const int32_t* carry, int T, int t) {
  switch (kind) {
    case kInt: return arg;
    case kVal: return vals[arg * T + t];
    case kCarry: return carry[arg * T + t];
    default: return absent;             // kNone
  }
}

// The verdict's node bit of thread t: its K node values against the
// simulator's, kLoads loads in flight at a time.
constexpr int kLoads = 16;

__device__ __forceinline__ int32_t node_mismatch(const Verdict& v,
                                                 const int32_t* vals, int B,
                                                 int64_t b0, int T, int t) {
  int32_t word = 0;
  for (int k0 = 0; k0 < v.K; k0 += kLoads) {
    int32_t got[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      got[j] = k0 + j < v.K
                   ? __ldg(v.sim_vals + static_cast<int64_t>(k0 + j) * B +
                           b0 + t)
                   : 0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      if (k0 + j < v.K && got[j] != vals[__ldg(v.slots + k0 + j) * T + t])
        word = kNodeMismatch;
  }
  return word;
}

// The verdict's image bit of thread t: its row of the simulator's images
// (`sim_row`, M words) against its own oracle image, column t of
// img[word][S] or its int64 row `row`.  Where the rows allow it, 16-byte
// loads, four words each.
template <bool kImageShared>
__device__ __forceinline__ int32_t image_mismatch(
    const int32_t* __restrict__ sim_row, const int32_t* img,
    const int64_t* row, int M, int S, int t) {
  bool differs = false;
  if (kImageShared && (M & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(sim_row) & 15) == 0) {
    const int4* sim4 = reinterpret_cast<const int4*>(sim_row);
    const int32_t* own = img + t;
#pragma unroll 8
    for (int c = 0; c < M / 4; ++c) {
      const int4 s = __ldg(sim4 + c);
      const int32_t* o = own + 4 * c * S;
      differs |= (s.x != o[0]) | (s.y != o[S]) | (s.z != o[2 * S]) |
                 (s.w != o[3 * S]);
    }
  } else {
#pragma unroll 8
    for (int w = 0; w < M; ++w)
      differs |= __ldg(sim_row + w) != (kImageShared
                                            ? img[w * S + t]
                                            : static_cast<int32_t>(row[w]));
  }
  return differs ? kImageMismatch : 0;
}

// One block: T memories (rows b0 .. b0 + T - 1 of the batch), the table
// staged, the images in shared memory (kImageShared) or in `image`'s rows.
// Output: image (B, M) int64, vals (N, B) int64, the error word and a
// verdict word a memory.
template <bool kImageShared>
__global__ void __launch_bounds__(kMaxThreads)
oracle_kernel(const int32_t* __restrict__ table,
              const int32_t* __restrict__ mem, int64_t* __restrict__ image,
              int64_t* __restrict__ vals_o,
              unsigned long long* __restrict__ error, int N, int C, int trip,
              int B, int M, Verdict verdict) {
  extern __shared__ __align__(16) int32_t smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = B - b0 < T ? static_cast<int>(B - b0) : T;
  const int words = kRecord * N + 2 * C;
  const int S = T + 1;                  // the images' stride
  int32_t* tab = smem;
  int32_t* vals = tab + words;          // [N][T]
  int32_t* carry = vals + N * T;        // [C][T]
  int32_t* img = carry + C * T;         // [M][S], when kImageShared

  for (int i = t; i < words; i += T) tab[i] = table[i];
  const int run = rows * M;             // launch(): T * M < 2^31
  const int32_t* mem_b = mem + b0 * M;
  int64_t* image_b = image + b0 * M;
  for (int i = t; i < run; i += T) {
    const int r = i / M, w = i - r * M;
    if (kImageShared)
      img[w * S + r] = mem_b[i];
    else
      image_b[i] = mem_b[i];
  }
  __syncthreads();
  const int32_t* upd = tab + kRecord * N;
  const int32_t* init = upd + C;
  const int4* rec4 = reinterpret_cast<const int4*>(tab);

  unsigned long long first_error = ULLONG_MAX;
  if (t < rows) {
    for (int c = 0; c < C; ++c) carry[c * T + t] = init[c];
    int64_t* row = image_b + static_cast<int64_t>(t) * M;
    for (int it = 0; it < trip && first_error == ULLONG_MAX; ++it) {
      for (int pos = 0; pos < N; ++pos) {
        const int4 r0 = rec4[2 * pos], r1 = rec4[2 * pos + 1];
        const int32_t op = r0.x, imm = r1.y, flags = r1.z;
        const int32_t a = fetch(r0.y, r0.z, (flags & kATakesImm) ? imm : 0,
                                vals, carry, T, t);
        const int32_t b = fetch(r0.w, r1.x, imm, vals, carry, T, t);
        int32_t out;
        if (op == kLoad || op == kStore) {
          const int64_t addr = static_cast<int64_t>(a) +
                               ((flags & kAddressAddsImm) ? imm : 0);
          if (addr < 0 || addr >= M) {
            first_error = static_cast<unsigned long long>(it) * N + pos;
            break;
          }
          const int w = static_cast<int>(addr);
          if (op == kLoad) {
            out = kImageShared ? img[w * S + t]
                               : static_cast<int32_t>(row[w]);
          } else {
            out = b;
            if (kImageShared)
              img[w * S + t] = b;
            else
              row[w] = b;
          }
        } else if (op == kSelectSign) {
          out = vals[r1.w * T + t] < 0 ? a : b;
        } else if (op == kSelectZero) {
          out = vals[r1.w * T + t] == 0 ? a : b;
        } else {
          out = alu(op, a, b);
        }
        vals[pos * T + t] = out;
      }
      for (int c = 0; c < C; ++c) carry[c * T + t] = vals[upd[c] * T + t];
    }
    if (first_error != ULLONG_MAX) atomicMin(error, first_error);
    for (int pos = 0; pos < N; ++pos)
      vals_o[static_cast<int64_t>(pos) * B + b0 + t] = vals[pos * T + t];
    verdict.word[b0 + t] =
        node_mismatch(verdict, vals, B, b0, T, t) |
        image_mismatch<kImageShared>(verdict.sim_image + (b0 + t) * M, img,
                                     row, M, S, t);
  }
  if (kImageShared) {
    __syncthreads();
    for (int i = t; i < run; i += T) {
      const int r = i / M, w = i - r * M;
      image_b[i] = img[w * S + r];
    }
  }
}

// One launch over B memories of M words, not waited for: `table` (8N + 2C
// int32) and `mem` (B, M) int32 on the device; `out` B*M + N*B int64 (the
// final images, the last iteration's node values [N][B]); `error` set to
// all ones, then the first (iteration * N + slot) whose address left
// [0, M).  The geometry comes from kernels/oracle.py::oracle_geometry and
// is checked here.  Returns the launch's cudaError.
int launch(const int32_t* table, const int32_t* mem, int64_t* out,
           unsigned long long* error, int N, int C, int trip, int B, int M,
           int threads, int shared_bytes, int image_shared,
           const Verdict& verdict, cudaStream_t stream) {
  const int64_t need =
      4 * (static_cast<int64_t>(kRecord) * N + 2 * C +
           static_cast<int64_t>(N + C) * threads +
           (image_shared ? static_cast<int64_t>(M) * (threads + 1) : 0));
  if (N < 0 || C < 0 || trip < 0 || B <= 0 || M <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || shared_bytes != need ||
      shared_bytes > kMaxSharedBytes ||
      static_cast<int64_t>(threads) * M > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t* vals = out + static_cast<int64_t>(B) * M;
  const cudaError_t set = cudaMemsetAsync(error, 0xFF, sizeof(*error), stream);
  if (set != cudaSuccess) return static_cast<int>(set);
  const auto kernel =
      image_shared ? oracle_kernel<true> : oracle_kernel<false>;
  static int allowed[2] = {};
  int& allow = allowed[image_shared ? 1 : 0];
  if (shared_bytes > kDefaultSharedBytes && shared_bytes > allow) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allow = shared_bytes;
  }
  const int blocks = (B + threads - 1) / threads;
  kernel<<<blocks, threads, shared_bytes, stream>>>(
      table, mem, out, vals, error, N, C, trip, B, M, verdict);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The oracle and its verdict: `out` B*M + N*B int64 as in
// launch(); `sim_image` (B, M) and `sim_vals` (K, B) int32, the
// simulator's, and `slots` (K,) int32, each in [0, N); `words` holds B
// int32 verdict words, padded to an even count, then the 64-bit error
// word (so `words` is 8-byte aligned).
extern "C" int oracle_verdict_run(const int32_t* table, const int32_t* mem,
                                  int64_t* out, const int32_t* sim_image,
                                  const int32_t* sim_vals,
                                  const int32_t* slots, int32_t* words, int K,
                                  int N, int C, int trip, int B, int M,
                                  int threads, int shared_bytes,
                                  int image_shared, cudaStream_t stream) {
  if (K < 0 || K > N || (K > 0 && trip == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* error = reinterpret_cast<unsigned long long*>(words + ((B + 1) & ~1));
  return launch(table, mem, out, error, N, C, trip, B, M, threads,
                shared_bytes, image_shared,
                Verdict{sim_image, sim_vals, slots, words, K}, stream);
}
