// The switching-activity harvest for Hopper (sm_90a), written by hand: one
// chunk's toggle counts read straight from its out trace.
//
// It replaces no TPU kernel.  The JAX package replays the routing datapath
// over the trace in numpy on the host (repro/fuzz/activity.py); the port
// resolves that replay once a schedule into a table of pairs
// (fuzz/activity.py::_replay_pairs) and counted each chunk with some twenty
// torch kernels over (3C, B) int64 temporaries, which became the largest
// load on the card at long programs.  fuzz/activity.py::
// ActivityAccumulator.update_ref is the plain version.
//
// What it computes.  For every memory b and every pair i of the table, the
// value and the previous value are each a trace cell (t, b, q) or the
// pair's constant; __popc(value ^ previous) adds into the pair's bin.  The
// bins are the accumulator's persistent int64 sums (2 x 27 in use), so a
// launch adds to what earlier chunks left there.  Every sum is an integer:
// the result is the same whatever order the blocks run in.
//
// The table (kernels/activity.py::pack_pairs): three int32 words a pair, in
// the replay's schedule-row order: the value's cell t * P + q or its
// constant, the previous value's, and the bin with kLhsConst / kRhsConst
// set where the word is a constant.
//
// Bound.  The trace read once and the table once: T x B x P x 4 + 12 x
// pairs bytes (the frame cell's largest trace, T = 1,120, B = 16,384,
// P = 16, is 1.17 GB, 0.35 ms at 3.35 TB/s); the work is a few integer
// operations a pair and memory, far below the INT32 rate.
//
// Design.  One thread a memory, a block of `threads` memories, and the
// table cut into `slices` along its length (blockIdx.y).  A warp's load of
// one pair reads a word every P x 4 bytes (the trace is (T, B, P)), so
// each load touches a sector a memory: a row of the trace for 32 memories
// is fetched once and then served from L1 to the pairs that read it, as
// long as it stays there.  Each block walks its slice in the table's
// (schedule) order, whose pairs read rows close to one another, and the
// geometry (kernels/activity.py::harvest_geometry) cuts the table until
// the launch has SM_WARPS warps on every SM, few enough that their rows
// stay in L1 while they are read.  A
// block stages its slice in shared memory in tiles of kTile pairs,
// decoded once for all its memories: a cell becomes its row t * B and its
// PE q (q = -1 marks a constant), so a thread's address is
// (t * B + b) * P + q.  A pair is then warp-uniform: every thread reads
// the same decoded record (a broadcast) and takes the same branch; the
// value and the previous value of kBatch pairs are loaded before any is
// used.  Each pair's popcounts are summed over the warp with
// __reduce_add_sync and added by one lane into the block's 32-bit bin in
// shared memory; a block's bin holds at most threads x slice x 32, which
// the geometry keeps within 2^32 - 1, so it is exact.  At the end every
// nonzero bin goes into the int64 bins with one 64-bit atomicAdd.  Threads
// past B (the ragged last block) count 0 and load nothing.  Nothing is
// allocated and nothing is waited for; the launch is on the caller's
// stream.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int32_t kLhsConst = 1 << 8;   // the value's word is a constant
constexpr int32_t kRhsConst = 1 << 9;   // the previous value's word is one
constexpr int32_t kBinMask = 0xFF;
constexpr int kMaxBins = 64;
constexpr int kTile = 1024;             // pairs a block stages at a time
constexpr int kMaxThreads = 256;
constexpr int kBatch = 4;               // pairs whose loads are in flight
constexpr int kRecordBytes = 20;        // a staged pair: int4 + its bin

// A staged source: its row t * B and PE q, or its constant and q = -1.
__device__ __forceinline__ int2 decode(int32_t word, bool constant, int B,
                                       int P) {
  if (constant) return make_int2(word, -1);
  const int32_t t = word / P;
  return make_int2(t * B, word - t * P);
}

__device__ __forceinline__ int32_t value(const int32_t* __restrict__ trace,
                                         int32_t row, int32_t q, int64_t b,
                                         int P) {
  return q < 0 ? row : __ldg(trace + (row + b) * P + q);
}

__global__ void __launch_bounds__(kMaxThreads)
harvest_kernel(const int32_t* __restrict__ trace,
               const int32_t* __restrict__ table,
               unsigned long long* __restrict__ bins, int pairs, int n_bins,
               int B, int P, int slice) {
  extern __shared__ __align__(16) int4 staged[];   // [tile], then bins
  const int tile = min(slice, kTile);
  int32_t* bin_of = reinterpret_cast<int32_t*>(staged + tile);
  __shared__ unsigned int sums[kMaxBins];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < kMaxBins; i += blockDim.x) sums[i] = 0;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + tid;
  const bool live = b < B;
  const int first = static_cast<int>(blockIdx.y) * slice;
  const int end = min(pairs, first + slice);
  for (int i0 = first; i0 < end; i0 += tile) {
    const int n = min(tile, end - i0);
    __syncthreads();                    // every thread is done with the last
    for (int i = tid; i < n; i += blockDim.x) {
      const int32_t* e = table + 3 * static_cast<int64_t>(i0 + i);
      const int32_t word = e[2];
      const int2 lhs = decode(e[0], word & kLhsConst, B, P);
      const int2 rhs = decode(e[1], word & kRhsConst, B, P);
      staged[i] = make_int4(lhs.x, lhs.y, rhs.x, rhs.y);
      bin_of[i] = word & kBinMask;
    }
    __syncthreads();
    for (int i = 0; i < n; i += kBatch) {
      int32_t x[kBatch], y[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x[j] = y[j] = 0;
        if (live && i + j < n) {
          const int4 s = staged[i + j];
          x[j] = value(trace, s.x, s.y, b, P);
          y[j] = value(trace, s.z, s.w, b, P);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i + j < n) {
          const unsigned int flips =
              __reduce_add_sync(0xFFFFFFFFu, __popc(x[j] ^ y[j]));
          if (lane == 0 && flips) atomicAdd(&sums[bin_of[i + j]], flips);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < n_bins; i += blockDim.x)
    if (sums[i]) atomicAdd(bins + i, static_cast<unsigned long long>(sums[i]));
}

}  // namespace

// One launch over a chunk's trace (T, B, P) int32, not waited for: `table`
// (pairs, 3) int32 as above, each cell in [0, T * P) and each bin in
// [0, n_bins); `bins` n_bins int64 (added to as unsigned).  The geometry
// comes from kernels/activity.py::harvest_geometry and is checked here.
// Returns the launch's cudaError.
extern "C" int harvest_run(const int32_t* trace, const int32_t* table,
                           unsigned long long* bins, int pairs, int n_bins,
                           int T, int B, int P, int threads, int slices,
                           int slice, cudaStream_t stream) {
  if (pairs <= 0 || n_bins <= 0 || n_bins > kMaxBins || T <= 0 || B <= 0 ||
      P <= 0 || threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      slice <= 0 || slices <= 0 ||
      static_cast<int64_t>(slices) * slice < pairs ||
      static_cast<int64_t>(slices - 1) * slice >= pairs ||
      static_cast<int64_t>(threads) * slice * 32 > UINT_MAX ||
      static_cast<int64_t>(T) * B > INT_MAX ||
      static_cast<int64_t>(T) * P > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + threads - 1) / threads, slices);
  const int tile = slice < kTile ? slice : kTile;
  harvest_kernel<<<grid, threads, tile * kRecordBytes, stream>>>(
      trace, table, bins, pairs, n_bins, B, P, slice);
  return static_cast<int>(cudaGetLastError());
}
