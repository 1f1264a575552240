// The radix-sort lab's three ingredients for Hopper (sm_90a), bound through a
// plain C interface and loaded with ctypes (see ibu_tpu_torch/ops/_build.py
// and ibu_tpu_torch/labs/_sort_kernels.py).
//
// digit_histogram_kernel replaces the Pallas kernel
//   tools/pallas_sort_lab.py::digit_histogram (_hist_kernel)
// rank_cumsum_kernel replaces
//   tools/pallas_sort_lab.py::rank_cumsum (_rank_kernel)
// dynamic_store_kernel replaces
//   tools/pallas_sort_lab.py::dynamic_store (_store_kernel)
//
// Keys are u32 bit patterns held as int32, cut into tiles of 2048 keys (16
// rows of 128, row-major); the digit of a key is its low byte. One block
// takes one tile, so blocks share nothing and need no second pass.
//
// - digit_histogram: hist[t, c] = number of keys of tile t whose digit is c.
//   256 threads read the tile once; each warp counts into its own 256-bin
//   copy in shared memory (shared-memory atomics, at most 32-way contention
//   within one warp and none between warps), then thread c sums the 8 copies
//   of bin c and writes it. The TPU's 256-way compare-accumulate and its
//   tile-selector matmul stood in for the scatter it lacks.
// - rank_cumsum: rank[i] = number of earlier keys of the same tile with the
//   same digit (a stable rank). Each warp takes runs of 32 consecutive keys:
//   __match_any_sync on the digit gives each key's peers in the run, and
//   popc(peers & lanemask_lt) its rank among them; the lowest peer writes
//   the run's count of that digit into a (64 runs x 256 digits) u16 table in
//   shared memory (32 KB). Thread c then turns column c into an exclusive
//   scan over the runs, which is each run's offset for digit c, and every key
//   adds its run's offset to its rank in the run. This is CUB's block radix
//   rank in its simplest form; the TPU's triangular matmuls (about 64 KFLOP
//   per key) stood in for the cumsum it lacks.
// - dynamic_store: for each tile, 256 stores in the order c = 0..255 of key
//   rows [8g, 8g + 8), g = c % 2, to rows [off_c, off_c + 8) of the tile's
//   16 x 128 output block, a later store overwriting an earlier one; off_c is
//   offs[8t + c / 128, c % 128]. The stores go into the block held in shared
//   memory (8 KB), as the TPU's go into its VMEM output block, and the block
//   is written out once. Thread j owns column j: it keeps its 16 keys in
//   registers and alone writes column j, so its own program order makes the
//   last store win without a barrier inside the loop. Rows that no store
//   covers are written as 0, and a store whose offset lies outside [0, 8] is
//   skipped (the TPU lab's offsets never are).
//
// What bounds them on an H100: device-memory bytes. Per key, the histogram
// reads 4 B and writes 0.5 B, the rank reads and writes 4 B, and the store
// reads 4 B of keys and 2 B of offset rows and writes 4 B; the arithmetic
// per byte is small, and the store's 512 B of shared-memory writes per key
// run at shared-memory speed. Each kernel reads its tile with coalesced
// 4-byte loads.
//
// Each kernel launches on the caller's stream, allocates nothing and never
// synchronises; each C entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a tile count the grid cannot hold).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kRows = 16;
constexpr int kLanes = 128;
constexpr int kDigits = 256;
constexpr int kWarps = 8;  // histogram and rank: 256 threads, one per digit
constexpr int kRuns = kTile / 32;
constexpr int kOffRows = 8;  // rows of 128 offsets reserved per tile

__global__ void __launch_bounds__(kDigits)
digit_histogram_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ hist) {
  __shared__ int counts[kWarps][kDigits];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) counts[w][tid] = 0;
  __syncthreads();
  const int32_t* tile = keys + int64_t(blockIdx.x) * kTile;
#pragma unroll
  for (int k = 0; k < kTile / kDigits; ++k) {
    atomicAdd(&counts[warp][tile[k * kDigits + tid] & 0xFF], 1);
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += counts[w][tid];
  hist[int64_t(blockIdx.x) * kDigits + tid] = sum;
}

__global__ void __launch_bounds__(kDigits)
rank_cumsum_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank) {
  __shared__ uint16_t counts[kRuns][kDigits];  // per run, then per-run offsets
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* words = reinterpret_cast<uint32_t*>(&counts[0][0]);
  for (int i = tid; i < kRuns * kDigits / 2; i += kDigits) words[i] = 0;
  __syncthreads();
  const int64_t base = int64_t(blockIdx.x) * kTile;
  const unsigned below = (1u << lane) - 1u;
  int digit[kRuns / kWarps];
  int local[kRuns / kWarps];
#pragma unroll
  for (int k = 0; k < kRuns / kWarps; ++k) {
    const int run = warp + k * kWarps;
    const int d = keys[base + run * 32 + lane] & 0xFF;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    digit[k] = d;
    local[k] = __popc(peers & below);
    if (local[k] == 0) counts[run][d] = uint16_t(__popc(peers));
  }
  __syncthreads();
  unsigned sum = 0;
  for (int run = 0; run < kRuns; ++run) {
    const unsigned c = counts[run][tid];
    counts[run][tid] = uint16_t(sum);
    sum += c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRuns / kWarps; ++k) {
    const int run = warp + k * kWarps;
    rank[base + run * 32 + lane] = int(counts[run][digit[k]]) + local[k];
  }
}

__global__ void __launch_bounds__(kLanes)
dynamic_store_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ offs,
                     int32_t* __restrict__ out) {
  __shared__ int32_t block[kRows][kLanes];
  __shared__ int32_t off[kDigits];
  const int j = threadIdx.x;
  const int64_t base = int64_t(blockIdx.x) * kTile;
  const int32_t* tile_offs = offs + int64_t(blockIdx.x) * kOffRows * kLanes;
  off[j] = tile_offs[j];
  off[kLanes + j] = tile_offs[kLanes + j];
  int32_t col[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    col[r] = keys[base + r * kLanes + j];
    block[r][j] = 0;
  }
  __syncthreads();
  for (int c = 0; c < kDigits; c += 2) {  // c even stores rows 0-7, c + 1 rows 8-15
    const int lo = off[c];
    const int hi = off[c + 1];
    if (unsigned(lo) <= 8u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) block[lo + k][j] = col[k];
    }
    if (unsigned(hi) <= 8u) {
#pragma unroll
      for (int k = 0; k < 8; ++k) block[hi + k][j] = col[8 + k];
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) out[base + r * kLanes + j] = block[r][j];
}

bool grid_ok(int64_t tiles) { return tiles > 0 && tiles <= INT32_MAX; }

}  // namespace

extern "C" int ibu_lab_digit_histogram(const void* keys, void* hist, int64_t tiles,
                                       void* stream) {
  if (!grid_ok(tiles)) return int(cudaErrorInvalidValue);
  digit_histogram_kernel<<<unsigned(tiles), kDigits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(hist));
  return int(cudaGetLastError());
}

extern "C" int ibu_lab_rank_cumsum(const void* keys, void* rank, int64_t tiles, void* stream) {
  if (!grid_ok(tiles)) return int(cudaErrorInvalidValue);
  rank_cumsum_kernel<<<unsigned(tiles), kDigits, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(rank));
  return int(cudaGetLastError());
}

extern "C" int ibu_lab_dynamic_store(const void* keys, const void* offs, void* out,
                                     int64_t tiles, void* stream) {
  if (!grid_ok(tiles)) return int(cudaErrorInvalidValue);
  dynamic_store_kernel<<<unsigned(tiles), kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(offs),
      static_cast<int32_t*>(out));
  return int(cudaGetLastError());
}
