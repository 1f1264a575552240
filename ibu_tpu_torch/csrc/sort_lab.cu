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
// rows of 128, row-major); the digit of a key is its low byte. Blocks share
// nothing, so no kernel needs a second pass.
//
// - digit_histogram: hist[t, c] = number of keys of tile t whose digit is c.
//   One block per tile: 256 threads read the tile once; each warp counts into
//   its own 256-bin copy in shared memory (shared-memory atomics, at most
//   32-way contention within one warp and none between warps), then thread c
//   sums the 8 copies of bin c and writes it. The TPU's 256-way
//   compare-accumulate and its tile-selector matmul stood in for the scatter
//   it lacks. Bound: device-memory bytes, 4.5 per key.
// - rank_cumsum: rank[i] = number of earlier keys of the same tile with the
//   same digit (a stable rank). The TPU's triangular matmuls (about 64 KFLOP
//   per key) stood in for the cumsum Mosaic lacks; here the function moves 8
//   bytes per key and does a few dozen warp operations per 32 keys, so
//   device-memory bytes bound it. A first design kept the TPU's shape (64 runs
//   of 32 keys per tile, __match_any_sync for each key's peers in its run, a
//   64x256 u16 table of run counts and a 64-step scan per digit): 0.155 ms at
//   2^24 keys, 26% of its bound. Timed with parts removed
//   (labs/sort_ablation.cu), 0.09 ms of that was __match_any_sync, 0.011 ms the
//   scan and 0.001 ms the zeroing (NVIDIA H100 80GB HBM3, 700 W). So the design
//   is now: one block of 4 warps per tile, each warp ranking 512 consecutive
//   keys (4 rows) as 16 runs of 32; a key's peers in its run come from 8
//   __ballot_sync on the digit's bits; the warp carries its running count of
//   every digit across its runs in a private row of 256 u32 counters in shared
//   memory (4 KB per block, counts reach 2048); a 4-step exclusive scan over
//   the warps gives each warp's offset for each digit, and a key's rank is that
//   offset plus its count in the warp. Each load and store is a coalesced
//   128-byte warp access.
// - dynamic_store: for each tile, 256 stores in the order c = 0..255 of key
//   rows [8g, 8g + 8), g = c % 2, to rows [off_c, off_c + 8) of the tile's
//   16x128 output block, a later store overwriting an earlier one, with off_c
//   = offs[8t + c / 128, c % 128]; rows that no store covers are 0, and a store
//   whose offset lies outside [0, 8] is skipped (the TPU lab's offsets never
//   are). The TPU kernel made every store into its VMEM output block, as Mosaic
//   offered no other way to express the moves; a first design made them into a
//   shared-memory block, 512 bytes of shared stores per key, and ran at the
//   shared-store rate (0.30 ms at 2^24 keys, 14% of its bound). The function
//   needs far less: output row r copies key row 8 (c* % 2) + r - off_c*, where
//   c* is the last in-range store that covers r, or is 0 when none does. So one
//   warp takes one tile: lane l reads offsets 8l .. 8l + 7 (two 16-byte loads)
//   and folds them into a per-row maximum of (c << 4 | source row); 16
//   __reduce_max_sync give the warp every row's source; then each lane copies
//   its 16 bytes of each of the 16 rows with 16-byte loads and stores (512
//   contiguous bytes per warp access). Only the key rows the offsets select are
//   read. Bound: device-memory bytes, at most 8.5 per key; 4 tiles per block.
//
// Each kernel launches on the caller's stream, allocates nothing and never
// synchronises; each C entry point returns cudaGetLastError() (or
// cudaErrorInvalidValue for a tile count the grid cannot hold). The store
// kernel reads and writes 16-byte vectors, so its pointers must be 16-byte
// aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;
constexpr int kRows = 16;
constexpr int kLanes = 128;
constexpr int kDigits = 256;
constexpr int kWarps = 8;       // histogram: 256 threads, one per digit
constexpr int kOffRows = 8;     // rows of 128 offsets reserved per tile
constexpr int kRankWarps = 4;   // rank: warps per tile (block)
constexpr int kRankRuns = kTile / 32 / kRankWarps;  // rank: runs of 32 keys per warp
constexpr int kStoreTiles = 4;  // store: tiles per block, one warp each

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

// The lanes of the warp whose digit equals d (8 ballots, one per bit):
// each key's peers in its run of 32.
__device__ __forceinline__ unsigned digit_peers(int d) {
  unsigned peers = 0xFFFFFFFFu;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__global__ void __launch_bounds__(kRankWarps * 32)
rank_cumsum_kernel(const int32_t* __restrict__ keys, int32_t* __restrict__ rank) {
  __shared__ unsigned counts[kRankWarps][kDigits];  // per warp, then its offsets
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t base = int64_t(blockIdx.x) * kTile + warp * (kRankRuns * 32) + lane;
  int digit[kRankRuns];
#pragma unroll
  for (int k = 0; k < kRankRuns; ++k) digit[k] = keys[base + k * 32] & 0xFF;
#pragma unroll
  for (int c = lane; c < kDigits; c += 32) counts[warp][c] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  unsigned local[kRankRuns];
#pragma unroll
  for (int k = 0; k < kRankRuns; ++k) {
    const int d = digit[k];
    const unsigned peers = digit_peers(d);
    const unsigned before = __popc(peers & below);
    const unsigned prior = counts[warp][d];
    local[k] = prior + before;
    __syncwarp();
    if (before == 0) counts[warp][d] = prior + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int c = threadIdx.x; c < kDigits; c += kRankWarps * 32) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kRankWarps; ++w) {
      const unsigned n = counts[w][c];
      counts[w][c] = sum;
      sum += n;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRankRuns; ++k) {
    rank[base + k * 32] = int(counts[warp][digit[k]] + local[k]);
  }
}

__global__ void __launch_bounds__(kStoreTiles * 32)
dynamic_store_kernel(const int4* __restrict__ keys, const int4* __restrict__ offs,
                     int4* __restrict__ out, int64_t tiles) {
  constexpr int kVecs = kLanes / 4;  // int4 per row: one per lane
  const int lane = threadIdx.x & 31;
  const int64_t tile = int64_t(blockIdx.x) * kStoreTiles + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  // lane l holds stores c = 8l .. 8l + 7
  const int4* own = offs + tile * (kOffRows * kVecs) + 2 * lane;
  const int4 lo = own[0], hi = own[1];
  const int start[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  // last[r]: (c << 4) | source row of the last of the lane's stores that
  // covers output row r, or -1
  int last[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) last[r] = -1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = 8 * lane + k;
    const int s = start[k];
    if (unsigned(s) <= unsigned(kRows - 8)) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= s && r < s + 8) last[r] = (c << 4) | (8 * (k & 1) + r - s);
      }
    }
  }
  const int4* src = keys + tile * (kRows * kVecs) + lane;
  int4* dst = out + tile * (kRows * kVecs) + lane;
  int4 row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int winner = __reduce_max_sync(0xFFFFFFFFu, last[r]);  // the same in every lane
    row[r] = winner < 0 ? make_int4(0, 0, 0, 0) : src[(winner & 15) * kVecs];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[r * kVecs] = row[r];
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
  rank_cumsum_kernel<<<unsigned(tiles), kRankWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(rank));
  return int(cudaGetLastError());
}

extern "C" int ibu_lab_dynamic_store(const void* keys, const void* offs, void* out,
                                     int64_t tiles, void* stream) {
  if (!grid_ok(tiles)) return int(cudaErrorInvalidValue);
  const int64_t blocks = (tiles + kStoreTiles - 1) / kStoreTiles;
  dynamic_store_kernel<<<unsigned(blocks), kStoreTiles * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(keys), static_cast<const int4*>(offs), static_cast<int4*>(out),
      tiles);
  return int(cudaGetLastError());
}
