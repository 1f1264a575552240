// The record sort for Hopper (sm_90a): a keys-only least-significant-digit
// radix sort of each record's bit-compacted key, bound through a plain C
// interface and loaded with ctypes (see ibu_tpu_torch/ops/_build.py and
// ibu_tpu_torch/ops/sort_cuda.py, which holds the plain torch version).
//
// It replaces no TPU kernel: ibu_tpu/ops/stats.py::sort_records_soa sorts
// with lax.sort, which XLA lowers for the TPU. The port first sorted with
// torch's stable argsort, one 64-bit key at a time, and gathered the records
// by the permutation; that moved about 700 B a record for a hinted Drop-seq
// batch.
//
// The key. A record (barcode, umi, index) holds, after the hint masks (the lo
// 32 bits of a field whose hi word a hint dropped), w_f bits in field f, where
// w_f is the bit length of the field's OR over the batch. The key
//   barcode << (w_umi + w_idx) | umi << w_idx | index
// has W = w_bc + w_umi + w_idx bits: it is lossless, so equal keys are equal
// records and no index payload is needed, and its unsigned order is the
// records' (barcode, umi, index) order. It is stored least-significant word
// first as ceil(W/64) planes of N u64 (plane j holds bits 64j..64j+63 of
// every key), and the sort makes ceil(W/8) passes of 8-bit digits. A hinted
// Drop-seq batch (24 + 16 + 16 bits) is one plane and 7 passes.
//
// The kernels, in stream order (ibu_record_sort launches 2-4, after
// ibu_field_ors has launched 1):
// - field_or_kernel: the OR of each field over the batch, three u64 (reads
//   24 B a record). The host may read them (the one wait a checked call
//   already made) and then launches exactly ceil(W/8) passes; where it does
//   not wait it launches passes up to a bound (32 bits a dropped field, 64
//   otherwise), and every kernel below works W out from the ORs on the card,
//   so a pass whose digit lies at or above W returns at once.
// - pack_kernel: the keys' live planes (24 B read, 8 B a live plane written
//   a record), and every live pass's digit histogram over the batch, counted
//   in shared memory and added once per block (the histograms do not depend
//   on the order, so one read serves every pass).
// - pass_kernel, one launch a pass (onesweep): a block takes the next tile of
//   256 * ITEMS keys from an atomic counter, ranks its keys by digit stably
//   (rank_warp: each warp finds each of its items' peers by 8 ballots, then
//   counts them with one shared-memory atomicAdd a digit an item), publishes
//   its per-digit counts and looks back over the tiles before it for their
//   prefix (decoupled look-back: a status word a tile and digit holds a flag,
//   the pass and a count), then puts its keys in digit order in shared memory
//   and writes each to its bucket's start plus its place. A pass reads and
//   writes 8 B a key a live plane.
// - unpack_kernel: the (N, 3) int64 records from the sorted planes (8 B a
//   live plane read, 24 B written a record), from whichever buffer the last
//   live pass wrote, found from W on the card. A block rebuilds 256 records
//   into shared memory and stores them as 768 contiguous words: a thread's
//   own three 8-byte stores at a 24-byte stride took 0.078 ms at 2^22 records
//   on an H100, the staged stores 0.054 ms.
//
// What bounds it: device-memory bytes for the OR-reduce, the pack and the
// rebuild (63-77% of their bytes at 3350 GB/s on an H100); the passes run at
// about 42% of their 16 B a key a live plane (7 passes over 2^22 one-word
// keys in 0.33 ms). The rank took half of a pass, and its cost was its
// instructions, not the warp's chain of counter updates: the counts taken out
// of the chain (one atomicAdd a digit an item, no item waiting on another,
// rank_warp's order argument below) moved the pass by under 1%, and the same
// with the peers' ballots in PTX, about 28 instructions a digit in place of
// 65, took it 17% faster (labs/record_sort_ablation.cu). In the lab's traced
// copy of the pass (2 tiles an SM; the shipped pass_kernel<1, 16> fits 3) a
// tile now takes about 11.8 us: the loads and the rank 3.7, the look-back
// 3.7, the scans 1.1, the scatter through shared memory and out 2.1. The
// look-back's serial walk, one status word a step, is the longest part.
//
// Every kernel launches on the caller's stream, allocates nothing and never
// synchronises: the wrapper allocates the planes and the status words in one
// scratch buffer (ibu_record_sort_scratch_bytes), which ibu_record_sort
// zeroes where it must with cudaMemsetAsync. Each C entry point returns the
// first launch error, or cudaErrorInvalidValue for arguments out of range.
//
// The file's second part is the histogram engine's group-by (ibu_group_sum),
// which sorts its own compacted key with the same pass_kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kMaxWords = 3;
constexpr int kMaxPasses = 8 * kMaxWords;
constexpr unsigned kFull = 0xFFFFFFFFu;

// A status word: flag (bits 62-63: 1 the tile's own count, 2 the inclusive
// prefix), the pass + 1 (bits 56-61), the count (bits 0-55). Zeroed words and
// words of the pass before never match the pass's tag.
constexpr uint64_t kCountMask = (uint64_t(1) << 56) - 1;
constexpr uint64_t kTagMask = uint64_t(63) << 56;
constexpr uint64_t kAggregate = uint64_t(1) << 62;
constexpr uint64_t kPrefix = uint64_t(2) << 62;

struct Masks {
  uint64_t m[3];  // barcode, umi, index
};

// Each field's width and place in the key, and the key's width.
struct Layout {
  int width[3];
  int offset[3];
  int bits;
};

__device__ __forceinline__ int bit_length(uint64_t v) { return v ? 64 - __clzll(v) : 0; }

__device__ __forceinline__ Layout key_layout(const unsigned long long* ors, const Masks& masks) {
  Layout l;
#pragma unroll
  for (int f = 0; f < 3; ++f) l.width[f] = bit_length(ors[f] & masks.m[f]);
  l.offset[2] = 0;
  l.offset[1] = l.width[2];
  l.offset[0] = l.width[2] + l.width[1];
  l.bits = l.offset[0] + l.width[0];
  return l;
}

// Or ``v`` (no bits at or above ``width``) into the key at bit ``offset``.
template <int NW>
__device__ __forceinline__ void put(uint64_t (&k)[NW], uint64_t v, int offset, int width) {
  if (width == 0) return;
  const int q = offset >> 6, s = offset & 63;
  const bool spills = s != 0 && s + width > 64;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j == q) k[j] |= v << s;
    if (j == q + 1 && spills) k[j] |= v >> (64 - s);
  }
}

// The ``width`` bits of the key at bit ``offset``.
template <int NW>
__device__ __forceinline__ uint64_t get(const uint64_t (&k)[NW], int offset, int width) {
  if (width == 0) return 0;
  const int q = offset >> 6, s = offset & 63;
  const bool spills = s != 0 && s + width > 64;
  uint64_t v = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j == q) v |= k[j] >> s;
    if (j == q + 1 && spills) v |= k[j] << (64 - s);
  }
  return width == 64 ? v : v & ((uint64_t(1) << width) - 1);
}

template <int NW>
__device__ __forceinline__ int digit_of(const uint64_t (&k)[NW], int pass) {
  const int j = pass >> 3;
  uint64_t w = k[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    if (j == i) w = k[i];
  }
  return int((w >> ((pass & 7) * 8)) & 0xFF);
}

__device__ __forceinline__ uint64_t or_warp(uint64_t v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v |= __shfl_xor_sync(kFull, v, s);
  return v;
}

__global__ void __launch_bounds__(kThreads)
field_or_kernel(const uint64_t* __restrict__ rec, int64_t n, unsigned long long* __restrict__ ors) {
  __shared__ uint64_t part[3][kWarps];
  uint64_t acc[3] = {0, 0, 0};
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < n; r += stride) {
#pragma unroll
    for (int f = 0; f < 3; ++f) acc[f] |= rec[3 * r + f];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const uint64_t v = or_warp(acc[f]);
    if (lane == 0) part[f][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    uint64_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v |= part[threadIdx.x][w];
    if (v) atomicOr(&ors[threadIdx.x], (unsigned long long)v);
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint64_t* __restrict__ rec, int64_t n, const unsigned long long* __restrict__ ors,
            Masks masks, uint64_t* __restrict__ keys, unsigned* __restrict__ hist) {
  __shared__ unsigned counts[kMaxPasses * kDigits];
  const Layout l = key_layout(ors, masks);
  const int passes = (l.bits + 7) >> 3;
  const int live = (l.bits + 63) >> 6;
  for (int c = threadIdx.x; c < passes * kDigits; c += kThreads) counts[c] = 0;
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < n; r += stride) {
    uint64_t k[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) k[j] = 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) put(k, rec[3 * r + f] & masks.m[f], l.offset[f], l.width[f]);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      if (j < live) keys[j * n + r] = k[j];
    }
#pragma unroll
    for (int p = 0; p < 8 * NW; ++p) {
      if (p < passes) atomicAdd(&counts[p * kDigits + digit_of(k, p)], 1u);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < passes * kDigits; c += kThreads) {
    if (counts[c]) atomicAdd(&hist[c], counts[c]);
  }
}

// The lanes of the warp whose digit equals d: per bit, a ballot of the lanes
// that have it set, complemented where d has it clear, ANDed in. Written in
// PTX so that ptxas moves the digit's bits into predicates at once (R2P) and
// spends a ballot, a predicated NOT and an AND a bit, about 28 instructions
// a digit; the same in C took about 65.
__device__ __forceinline__ unsigned digit_peers(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    unsigned same;
    asm("{\n\t.reg .pred p;\n\t.reg .b32 m;\n\t"
        "and.b32 m, %1, %2;\n\t"
        "setp.ne.u32 p, m, 0;\n\t"
        "vote.sync.ballot.b32 %0, p, 0xffffffff;\n\t"
        "selp.b32 m, 0, -1, p;\n\t"
        "xor.b32 %0, %0, m;\n\t}"
        : "=r"(same)
        : "r"(d), "r"(1u << b));
    peers &= same;
  }
  return peers;
}

// A warp's stable rank of its ITEMS x 32 keys by digit (lane l's item k is
// key first + 32k, where ``first`` is the warp's first key plus l; keys from
// n on are not ranked): place[k] gets the count of the warp's keys before it
// with its digit, and ``counts`` (the warp's 256 counters, zeroed) ends
// holding the warp's count of each digit.
//
// Every item's peers first: their ballots do not depend on each other, and a
// warp whose keys all lie below n takes no ballot of the valid lanes. Then,
// item by item, the digit's leader (its lowest lane among the valid ones; an
// invalid lane is in no item's peers, its own neither) adds the item's count
// of the digit with one atomicAdd and keeps the old value: the count of the
// digit in the items before. Last each lane takes its leader's old value by
// shuffle and adds the peers below it. No step waits for an earlier item's
// count, so nothing runs through a chain of shared-memory round trips.
//
// Why the counts come in item order: a counter's atomics are totally ordered,
// and each item has one atomic per digit. The __syncwarp after each item
// orders the memory operations of the lanes before it before those after it
// (the CUDA programming guide's guarantee for __syncwarp), so item k's
// atomic on a counter happens before item k + 1's on the same counter, by
// whichever lanes, and returns the sum over items 0 .. k - 1, not over some
// other set. It costs nothing here: ptxas keeps the atomics back to back
// (a warp's shared-memory operations issue in order).
template <int ITEMS>
__device__ __forceinline__ void rank_warp(const int (&digit)[ITEMS], int64_t first, int64_t n,
                                          unsigned* counts, unsigned (&place)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  const unsigned me = 1u << lane, below = me - 1u;
  const bool whole = first - lane + ITEMS * 32 <= n;
  unsigned peers[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    peers[k] = digit_peers(digit[k]);
    if (!whole) peers[k] &= __ballot_sync(kFull, first + k * 32 < n);
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    place[k] = 0;
    if ((peers[k] & (below | me)) == me) {
      place[k] = atomicAdd(&counts[digit[k]], unsigned(__popc(peers[k])));
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    place[k] = __shfl_sync(kFull, place[k], __ffs(peers[k]) - 1) + __popc(peers[k] & below);
  }
}

// Exclusive prefix of ``v`` over the block's threads in order; ``scratch``
// holds kWarps values. Every thread of the block calls it.
__device__ __forceinline__ long long exclusive_scan(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, s);
    if (lane >= s) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  long long before = 0;
  for (int w = 0; w < warp; ++w) before += scratch[w];
  __syncthreads();
  return before + x - v;
}

template <int NW, int ITEMS>
__global__ void __launch_bounds__(kThreads)
pass_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n,
            const unsigned long long* __restrict__ ors, Masks masks, int pass,
            const unsigned* __restrict__ hist, unsigned long long* status, unsigned* counter) {
  constexpr int kTileKeys = kThreads * ITEMS;
  __shared__ unsigned warp_counts[kWarps][kDigits];
  __shared__ unsigned local_start[kDigits];
  __shared__ long long global_base[kDigits];
  __shared__ long long scan_scratch[kWarps];
  __shared__ unsigned tile_slot;
  __shared__ uint64_t exchange[kTileKeys];
  __shared__ uint8_t sorted_digit[kTileKeys];

  const Layout l = key_layout(ors, masks);
  if (8 * pass >= l.bits) return;  // the digit lies above the key: nothing to do
  const int live = (l.bits + 63) >> 6;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_slot = atomicAdd(counter + pass, 1u);
  for (int c = tid; c < kWarps * kDigits; c += kThreads) (&warp_counts[0][0])[c] = 0;
  __syncthreads();
  const int64_t tile = tile_slot;
  const int64_t base = tile * kTileKeys;
  const int64_t first = base + warp * (ITEMS * 32) + lane;

  uint64_t key[ITEMS][NW];
  int digit[ITEMS];
  unsigned place[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = first + k * 32;
#pragma unroll
    for (int j = 0; j < NW; ++j) key[k][j] = (i < n && j < live) ? in[j * n + i] : 0;
    digit[k] = digit_of(key[k], pass);
  }

  rank_warp(digit, first, n, warp_counts[warp], place);
  __syncthreads();

  // thread tid is digit tid from here: the warps' offsets and the tile's count
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_counts[w][tid];
    warp_counts[w][tid] = count;
    count += c;
  }
  const uint64_t tag = uint64_t(pass + 1) << 56;
  volatile unsigned long long* mine = status + tile * kDigits + tid;
  long long prefix = 0;  // keys of this digit in the tiles before this one
  if (tile == 0) {
    *mine = kPrefix | tag | count;
  } else {
    *mine = kAggregate | tag | count;
    for (int64_t t = tile - 1, spins = 0;;) {
      const uint64_t s = static_cast<volatile unsigned long long*>(status)[t * kDigits + tid];
      if ((s & kTagMask) != tag || (s >> 62) == 0) {  // not published yet
        // the tile before was taken by a running block, so it publishes in
        // microseconds; a wait of seconds is a fault, reported as one
        if (++spins > (int64_t(1) << 26)) __trap();
        continue;
      }
      prefix += static_cast<long long>(s & kCountMask);
      if ((s >> 62) == 2) break;
      --t;
    }
    *mine = kPrefix | tag | uint64_t(prefix + count);
  }
  const long long start = exclusive_scan(count, scan_scratch);
  const long long bucket = exclusive_scan(hist[pass * kDigits + tid], scan_scratch);
  local_start[tid] = unsigned(start);
  global_base[tid] = bucket + prefix - start;
  __syncthreads();

  // the tile in digit order, through shared memory, one plane at a time
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    place[k] += local_start[digit[k]] + warp_counts[warp][digit[k]];
    if (first + k * 32 < n) sorted_digit[place[k]] = uint8_t(digit[k]);
  }
  const int tile_keys = int(n - base < kTileKeys ? n - base : kTileKeys);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j >= live) break;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (first + k * 32 < n) exchange[place[k]] = key[k][j];
    }
    __syncthreads();
    for (int i = tid; i < tile_keys; i += kThreads) {
      out[j * n + global_base[sorted_digit[i]] + i] = exchange[i];
    }
    __syncthreads();
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b, int64_t n,
              const unsigned long long* __restrict__ ors, Masks masks,
              uint64_t* __restrict__ out) {
  __shared__ uint64_t rows[3 * kThreads];
  const Layout l = key_layout(ors, masks);
  const int live = (l.bits + 63) >> 6;
  // pass p reads buffer p % 2 and writes the other
  const uint64_t* src = (((l.bits + 7) >> 3) & 1) ? b : a;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t chunk = int64_t(blockIdx.x) * kThreads; chunk < n; chunk += stride) {
    const int64_t r = chunk + threadIdx.x;
    if (r < n) {
      uint64_t k[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) k[j] = j < live ? src[j * n + r] : 0;
#pragma unroll
      for (int f = 0; f < 3; ++f) rows[3 * threadIdx.x + f] = get(k, l.offset[f], l.width[f]);
    }
    __syncthreads();
    // the block's records are contiguous: store them as contiguous words
    const int words = 3 * int(n - chunk < kThreads ? n - chunk : kThreads);
    for (int j = threadIdx.x; j < words; j += kThreads) out[3 * chunk + j] = rows[j];
    __syncthreads();
  }
}

// Keys a thread ranks in a pass, by key words: the exchange (one plane of
// the tile at a time) holds 16 in static shared memory, and registers bound
// three-word keys at 12 (labs/record_sort_ablation.cu: 12 and 16 against 8
// and 12 took two- and three-word passes 12% and 7% faster on an H100).
constexpr int items_for(int words) { return words == 3 ? 12 : 16; }
constexpr int64_t kHistBytes = int64_t(kMaxPasses) * kDigits * 4;
constexpr int64_t kCounterBytes = 256;  // kMaxPasses u32, padded

int64_t tiles_for(int64_t n, int words) {
  const int64_t tile = int64_t(kThreads) * items_for(words);
  return (n + tile - 1) / tile;
}

// hist | counters | status (zeroed) | keys a | keys b
int64_t zeroed_bytes(int64_t n, int words) {
  return kHistBytes + kCounterBytes + tiles_for(n, words) * kDigits * 8;
}

int grid_for(int64_t n, int per_sm) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = int64_t(sms) * per_sm;
  return int(blocks < cap ? blocks : cap);
}

template <int NW>
int run_sort(const uint64_t* rec, int64_t n, const unsigned long long* ors, Masks masks,
             int passes, char* scratch, uint64_t* out, cudaStream_t stream) {
  constexpr int kItems = items_for(NW);
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + kHistBytes);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + kHistBytes + kCounterBytes);
  uint64_t* keys[2];
  keys[0] = reinterpret_cast<uint64_t*>(scratch + zeroed_bytes(n, NW));
  keys[1] = keys[0] + int64_t(NW) * n;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, size_t(zeroed_bytes(n, NW)), stream);
  if (rc != cudaSuccess) return int(rc);
  pack_kernel<NW><<<grid_for(n, 4), kThreads, 0, stream>>>(rec, n, ors, masks, keys[0], hist);
  if ((rc = cudaGetLastError()) != cudaSuccess) return int(rc);
  const int64_t tiles = tiles_for(n, NW);
  for (int p = 0; p < passes; ++p) {
    pass_kernel<NW, kItems><<<unsigned(tiles), kThreads, 0, stream>>>(
        keys[p & 1], keys[(p + 1) & 1], n, ors, masks, p, hist, status, counter);
    if ((rc = cudaGetLastError()) != cudaSuccess) return int(rc);
  }
  unpack_kernel<NW><<<grid_for(n, 8), kThreads, 0, stream>>>(keys[0], keys[1], n, ors, masks, out);
  return int(cudaGetLastError());
}

bool args_ok(int64_t n, int words, int passes) {
  return n > 0 && n < (int64_t(1) << 31) && words >= 1 && words <= kMaxWords && passes >= 0 &&
         passes <= 8 * words && tiles_for(n, words) <= INT32_MAX;
}

}  // namespace

extern "C" int64_t ibu_record_sort_scratch_bytes(int64_t n, int words) {
  if (!args_ok(n, words, 0)) return -1;
  return zeroed_bytes(n, words) + 2 * int64_t(words) * n * 8;
}

extern "C" int ibu_field_ors(const void* records, int64_t n, void* ors, void* stream) {
  if (n <= 0) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(ors, 0, 3 * sizeof(uint64_t), s);
  if (rc != cudaSuccess) return int(rc);
  field_or_kernel<<<grid_for(n, 8), kThreads, 0, s>>>(
      static_cast<const uint64_t*>(records), n, static_cast<unsigned long long*>(ors));
  return int(cudaGetLastError());
}

extern "C" int ibu_record_sort(const void* records, int64_t n, const void* ors, uint64_t mask_bc,
                               uint64_t mask_umi, uint64_t mask_index, int words, int passes,
                               void* scratch, void* out, void* stream) {
  if (!args_ok(n, words, passes)) return int(cudaErrorInvalidValue);
  const Masks masks = {{mask_bc, mask_umi, mask_index}};
  const auto* rec = static_cast<const uint64_t*>(records);
  const auto* o = static_cast<const unsigned long long*>(ors);
  char* sc = static_cast<char*>(scratch);
  auto* dst = static_cast<uint64_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: return run_sort<1>(rec, n, o, masks, passes, sc, dst, s);
    case 2: return run_sort<2>(rec, n, o, masks, passes, sc, dst, s);
    default: return run_sort<3>(rec, n, o, masks, passes, sc, dst, s);
  }
}

// ---------------------------------------------------------------------------
// The histogram engine's group-by (ibu_group_sum; the wrapper and its plain
// torch version are ibu_tpu_torch/ops/group_sum.py): (key, weight) entries to
// a table of (distinct key, summed weight) in ascending unsigned key order,
// the tail zeroed, and the true number of distinct keys. A batch's histogram
// is this with unit weights (no weight column); a merge of the device table
// with the staged batch tables is this with counts as weights, where a weight
// of 0 marks an empty entry. The entries come as up to kMaxRanges ranges
// (the table and each staged row, or one batch's barcode column at a stride
// of 3 words), so nothing is concatenated first.
//
// The key. After the hint mask, an entry's key holds w_key bits, its weight
// w_cnt bits (the bit lengths of their ORs over the valid entries), and an
// empty entry sets the validity bit (w_inv = 1 where any entry is empty):
//   invalid << (w_key + w_cnt) | key << w_cnt | weight
// with the key and weight of an empty entry zeroed, so the empties are one
// group that sorts after every valid one, whatever its key: barcode 0 never
// merges with an empty slot. The key is lossless, so equal keys are equal
// entries and the sort needs no payload. It is the record sort's key with
// the fields (invalid, key, weight) in place of (barcode, umi, index), so the
// record sort's pass_kernel sorts it as it is.
//
// The kernels, in stream order (one cudaMemsetAsync of the scratch first):
// - group_or_kernel: the three ORs (reads each entry once). The host
//   launches passes up to a bound it knows (32 or 64 key bits, the bit
//   length of the records counted so far, the validity bit), and every
//   kernel works the width out from the ORs, so a pass above it returns at
//   once and nothing waits on the card.
// - group_pack_kernel: the key's live planes and every live pass's digit
//   histogram, as pack_kernel. Unweighted entries are their keys at bit 0
//   whatever the width, so there the pack ORs the keys itself, counts the
//   digits of every launched pass, and no group_or_kernel runs.
// - pass_kernel (the record sort's), one launch a pass.
// - two cudaMemsetAsync (the output's keys and sums), then segment_kernel:
//   one tile of sorted keys a block (2048 of one word, 1024 of two or three),
//   staged in shared memory, each thread holding seg_items adjacent ones. A
//   boundary is where (invalid, key) changes. Each group's id is the count
//   of valid boundaries before it: a block scan, and a look-back over the
//   tiles before by one warp, 32 tiles a step (one status word a tile, as
//   pass_kernel's). Each group's sum within the tile is a segmented block
//   scan of the weights; a group wholly inside the tile stores its sum, and
//   a group cut by a tile's edge adds each tile's part to the zeroed slot
//   with an atomic. Group g < n_slots lands in slot g (key at its first
//   entry); the entry N - 1 leaves the count of valid groups in
//   *n_distinct, above n_slots too.
//
// What bounds it on an H100: the passes, at 29-39% of their 16 B a key a
// live pass, take about half of a Drop-seq batch's 0.11 ms.
// The segment kernel takes about 20 us a 2^20 batch, 0.4 TB/s of its bytes;
// a count kernel and a one-block scan of the tiles' counts in place of the
// look-back took as long in three launches, so its own work, not the
// look-back's chain, bounds it.

namespace {

constexpr int kMaxRanges = 64;
// Entries a thread of the segment kernel holds, by key words (shared memory
// holds the tile's words).
__host__ __device__ constexpr int seg_items(int words) { return words == 1 ? 8 : 4; }
constexpr int64_t kGroupOrsBytes = 32;  // three u64, padded

// The entries: range q holds start[q + 1] - start[q] keys at a stride of
// stride[q] words and, where weighted, as many contiguous weights.
struct Ranges {
  const uint64_t* keys[kMaxRanges];
  const uint64_t* weights[kMaxRanges];
  int64_t stride[kMaxRanges];
  int64_t start[kMaxRanges + 1];
  uint64_t key_mask;
  int count;
  int weighted;
};

// An entry's (invalid, key, weight) as the key's fields; an empty entry's
// key and weight are zeroed, and unweighted entries carry no weight field.
struct Fields {
  uint64_t f[3];
};

__device__ __forceinline__ Fields entry_fields(const Ranges& r, int q, int64_t i) {
  Fields e;
  e.f[1] = r.keys[q][i * r.stride[q]] & r.key_mask;
  e.f[2] = r.weighted ? r.weights[q][i] : 0;
  e.f[0] = r.weighted && e.f[2] == 0;
  if (e.f[0]) e.f[1] = 0;
  return e;
}

template <int NW>
__device__ __forceinline__ Fields key_fields(const uint64_t (&k)[NW], const Layout& l) {
  Fields e;
#pragma unroll
  for (int f = 0; f < 3; ++f) e.f[f] = get(k, l.offset[f], l.width[f]);
  return e;
}

// Whether two keys fall in different groups: (invalid, key) differ.
__device__ __forceinline__ bool other_group(const Fields& a, const Fields& b) {
  return a.f[0] != b.f[0] || a.f[1] != b.f[1];
}

__global__ void __launch_bounds__(kThreads)
group_or_kernel(Ranges r, unsigned long long* __restrict__ ors) {
  __shared__ uint64_t part[3][kWarps];
  uint64_t acc[3] = {0, 0, 0};
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int q = 0; q < r.count; ++q) {
    const int64_t n = r.start[q + 1] - r.start[q];
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
      const Fields e = entry_fields(r, q, i);
#pragma unroll
      for (int f = 0; f < 3; ++f) acc[f] |= e.f[f];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const uint64_t v = or_warp(acc[f]);
    if (lane == 0) part[f][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    uint64_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v |= part[threadIdx.x][w];
    if (v) atomicOr(&ors[threadIdx.x], (unsigned long long)v);
  }
}

// Unweighted entries are their masked keys at bit 0, whatever the key's
// width: the kernel ORs the keys itself (no group_or_kernel runs first) and
// counts the digits of the ``bound`` passes the host launches.
template <int NW>
__global__ void __launch_bounds__(kThreads)
group_pack_kernel(Ranges r, unsigned long long* __restrict__ ors, Masks masks, int bound,
                  uint64_t* __restrict__ keys, unsigned* __restrict__ hist) {
  __shared__ unsigned counts[kMaxPasses * kDigits];
  __shared__ uint64_t part[kWarps];
  Layout l = {{0, 64, 0}, {0, 0, 0}, 64};
  if (r.weighted) l = key_layout(ors, masks);
  const int passes = r.weighted ? (l.bits + 7) >> 3 : bound;
  const int live = r.weighted ? (l.bits + 63) >> 6 : 1;
  const int64_t n = r.start[r.count];
  uint64_t acc = 0;
  for (int c = threadIdx.x; c < passes * kDigits; c += kThreads) counts[c] = 0;
  __syncthreads();
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int q = 0; q < r.count; ++q) {
    const int64_t len = r.start[q + 1] - r.start[q];
    for (int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x; i < len; i += stride) {
      const Fields e = entry_fields(r, q, i);
      acc |= e.f[1];
      uint64_t k[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) k[j] = 0;
#pragma unroll
      for (int f = 0; f < 3; ++f) put(k, e.f[f], l.offset[f], l.width[f]);
      const int64_t at = r.start[q] + i;
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        if (j < live) keys[j * n + at] = k[j];
      }
#pragma unroll
      for (int p = 0; p < 8 * NW; ++p) {
        if (p < passes) atomicAdd(&counts[p * kDigits + digit_of(k, p)], 1u);
      }
    }
  }
  if (!r.weighted) {
    acc = or_warp(acc);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < passes * kDigits; c += kThreads) {
    if (counts[c]) atomicAdd(&hist[c], counts[c]);
  }
  if (!r.weighted && threadIdx.x == 0) {
    uint64_t v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v |= part[w];
    if (v) atomicOr(&ors[1], (unsigned long long)v);
  }
}

// A tile's entry p in shared memory: one pad word after every 8, so that a
// thread's adjacent entries fall in other banks than its neighbour's.
__device__ __forceinline__ int padded(int p) { return p + (p >> 3); }

template <int NW>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b, int64_t n,
               const unsigned long long* __restrict__ ors, Masks masks, int weighted,
               unsigned long long* __restrict__ out_keys, unsigned long long* __restrict__ out_sums,
               int64_t n_slots, long long* __restrict__ n_distinct, unsigned long long* status,
               unsigned* counter) {
  constexpr int kSegItems = seg_items(NW);
  constexpr int kSegTile = kThreads * kSegItems;
  __shared__ uint64_t words[NW][kSegTile + kSegTile / 8];
  __shared__ long long scan_scratch[kWarps];
  __shared__ int warp_began[kWarps];
  __shared__ unsigned long long warp_sum[kWarps];
  __shared__ long long tile_groups;
  __shared__ long long tile_prefix;
  __shared__ unsigned tile_slot;

  const Layout l = key_layout(ors, masks);
  const int live = (l.bits + 63) >> 6;
  // pass p reads buffer p % 2 and writes the other
  const uint64_t* src = (((l.bits + 7) >> 3) & 1) ? b : a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_slot = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = tile_slot;
  const int64_t base = tile * kSegTile;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    for (int i = tid; i < kSegTile; i += kThreads) {
      words[j][padded(i)] = (j < live && base + i < n) ? src[j * n + base + i] : 0;
    }
  }
  __syncthreads();

  auto at = [&](int p) {
    uint64_t k[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) k[j] = words[j][padded(p)];
    return key_fields(k, l);
  };
  const int p0 = tid * kSegItems;
  Fields prev;
  if (p0 > 0) {
    prev = at(p0 - 1);
  } else {
    uint64_t k[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) k[j] = (base > 0 && j < live) ? src[j * n + base - 1] : 0;
    prev = key_fields(k, l);
  }

  // per entry: a group starts here (brk), it belongs to a valid group (real)
  bool brk[kSegItems], real[kSegItems];
  uint64_t key[kSegItems];
  unsigned long long w[kSegItems];
  int starts = 0;       // valid groups starting in this thread's entries
  int began = 0;        // a group starts in this thread's entries
  unsigned long long run = 0;  // the weights since the thread's last group start (mod 2^64)
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int64_t i = base + p0 + k;
    const Fields e = at(p0 + k);
    const bool valid = i < n;
    brk[k] = valid && (i == 0 || other_group(e, prev));
    real[k] = valid && e.f[0] == 0;
    key[k] = e.f[1];
    w[k] = real[k] ? (weighted ? e.f[2] : 1) : 0;
    starts += brk[k] && real[k];
    if (brk[k]) {
      began = 1;
      run = 0;
    }
    run += w[k];
    prev = e;
  }
  // whether the next thread's first entry starts a group
  const int pn = p0 + kSegItems;
  const bool next_brk = pn < kSegTile && base + pn < n && other_group(at(pn), prev);

  // segmented scan of (began, run) over the block: the open group's sum at
  // the thread's first entry, and whether it began inside this tile
  int fi = began;
  unsigned long long si = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int f = __shfl_up_sync(kFull, fi, d);
    const unsigned long long s = __shfl_up_sync(kFull, si, d);
    if (lane >= d) {
      if (!fi) si += s;
      fi |= f;
    }
  }
  int fe = __shfl_up_sync(kFull, fi, 1);
  unsigned long long se = __shfl_up_sync(kFull, si, 1);
  if (lane == 0) {
    fe = 0;
    se = 0;
  }
  if (lane == 31) {
    warp_began[warp] = fi;
    warp_sum[warp] = si;
  }
  const long long groups_before = exclusive_scan(starts, scan_scratch);  // syncs the block
  int cf = 0;
  unsigned long long cs = 0;
  for (int v = 0; v < warp; ++v) {
    cs = warp_began[v] ? warp_sum[v] : cs + warp_sum[v];
    cf |= warp_began[v];
  }
  unsigned long long sum = fe ? se : cs + se;
  bool inside = fe || cf;

  if (tid == kThreads - 1) tile_groups = groups_before + starts;
  __syncthreads();
  if (warp == 0) {  // the valid groups of the tiles before: decoupled look-back
    const uint64_t tag = uint64_t(1) << 56;
    const long long count = tile_groups;
    volatile unsigned long long* vs = status;
    if (lane == 0) vs[tile] = (tile == 0 ? kPrefix : kAggregate) | tag | uint64_t(count);
    long long prefix = 0;
    // 32 tiles a step, the nearest in lane 0; before tile 0 an empty prefix
    for (int64_t t = tile - 1; t >= 0; t -= 32) {
      const int64_t mine = t - lane;
      uint64_t s = kPrefix;
      for (int64_t spins = 0;;) {
        if (mine >= 0) s = vs[mine];
        if (!__any_sync(kFull, (s >> 62) == 0)) break;
        // the tiles before were taken by running blocks, so they publish in
        // microseconds; a wait of seconds is a fault, reported as one
        if (++spins > (int64_t(1) << 26)) __trap();
      }
      const unsigned done = __ballot_sync(kFull, (s >> 62) == 2);
      const int stop = done ? __ffs(done) - 1 : 31;  // the nearest inclusive prefix
      long long v = lane <= stop ? static_cast<long long>(s & kCountMask) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
      prefix += v;
      if (done) break;
    }
    if (lane == 0) {
      if (tile > 0) vs[tile] = kPrefix | tag | uint64_t(prefix + count);
      tile_prefix = prefix;
    }
  }
  __syncthreads();

  long long groups = tile_prefix + groups_before;  // valid groups up to the entry
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int p = p0 + k;
    const int64_t i = base + p;
    if (brk[k]) {
      sum = 0;
      inside = true;
    }
    sum += w[k];
    groups += brk[k] && real[k];
    if (i == n - 1) *n_distinct = groups;
    const long long g = groups - 1;
    if (!real[k] || g >= n_slots) continue;
    if (brk[k]) out_keys[g] = key[k];
    // the group's last entry in this tile: store its sum, or add this
    // tile's part where another tile holds the rest
    const bool cut = i != n - 1 && p + 1 == kSegTile;
    const bool ends = i == n - 1 || cut || (k + 1 < kSegItems ? brk[k + 1] : next_brk);
    if (ends) {
      if (inside && !cut) {
        out_sums[g] = sum;
      } else {
        atomicAdd(&out_sums[g], sum);
      }
    }
  }
}

// tiles of the segment kernel
int64_t seg_tiles(int64_t n, int words) {
  const int64_t tile = int64_t(kThreads) * seg_items(words);
  return (n + tile - 1) / tile;
}

// the record sort's zeroed part | ors | the segment kernel's counter and
// status (zeroed) | keys a | keys b
int64_t group_zeroed_bytes(int64_t n, int words) {
  return zeroed_bytes(n, words) + kGroupOrsBytes + kCounterBytes + seg_tiles(n, words) * 8;
}

template <int NW>
int run_group_sum(const Ranges& r, int passes, char* scratch, unsigned long long* out_keys,
                  unsigned long long* out_sums, int64_t n_slots, long long* n_distinct,
                  cudaStream_t stream) {
  constexpr int kItems = items_for(NW);
  const int64_t n = r.start[r.count];
  const Masks all = {{~uint64_t(0), ~uint64_t(0), ~uint64_t(0)}};
  unsigned* hist = reinterpret_cast<unsigned*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + kHistBytes);
  unsigned long long* status =
      reinterpret_cast<unsigned long long*>(scratch + kHistBytes + kCounterBytes);
  char* tail = scratch + zeroed_bytes(n, NW);
  unsigned long long* ors = reinterpret_cast<unsigned long long*>(tail);
  unsigned* seg_counter = reinterpret_cast<unsigned*>(tail + kGroupOrsBytes);
  unsigned long long* seg_status =
      reinterpret_cast<unsigned long long*>(tail + kGroupOrsBytes + kCounterBytes);
  uint64_t* keys[2];
  keys[0] = reinterpret_cast<uint64_t*>(scratch + group_zeroed_bytes(n, NW));
  keys[1] = keys[0] + int64_t(NW) * n;
  cudaError_t rc = cudaMemsetAsync(scratch, 0, size_t(group_zeroed_bytes(n, NW)), stream);
  if (rc != cudaSuccess) return int(rc);
  if (r.weighted) {
    group_or_kernel<<<grid_for(n, 8), kThreads, 0, stream>>>(r, ors);
    if ((rc = cudaGetLastError()) != cudaSuccess) return int(rc);
  }
  group_pack_kernel<NW><<<grid_for(n, 4), kThreads, 0, stream>>>(r, ors, all, passes, keys[0],
                                                                  hist);
  if ((rc = cudaGetLastError()) != cudaSuccess) return int(rc);
  const int64_t tiles = tiles_for(n, NW);
  for (int p = 0; p < passes; ++p) {
    pass_kernel<NW, kItems><<<unsigned(tiles), kThreads, 0, stream>>>(
        keys[p & 1], keys[(p + 1) & 1], n, ors, all, p, hist, status, counter);
    if ((rc = cudaGetLastError()) != cudaSuccess) return int(rc);
  }
  if ((rc = cudaMemsetAsync(out_keys, 0, size_t(n_slots) * 8, stream)) != cudaSuccess) return int(rc);
  if ((rc = cudaMemsetAsync(out_sums, 0, size_t(n_slots) * 8, stream)) != cudaSuccess) return int(rc);
  segment_kernel<NW><<<unsigned(seg_tiles(n, NW)), kThreads, 0, stream>>>(
      keys[0], keys[1], n, ors, all, r.weighted, out_keys, out_sums, n_slots, n_distinct,
      seg_status, seg_counter);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int64_t ibu_group_sum_scratch_bytes(int64_t n, int words) {
  if (!args_ok(n, words, 0)) return -1;
  return group_zeroed_bytes(n, words) + 2 * int64_t(words) * n * 8;
}

extern "C" int ibu_group_sum(int n_ranges, const void* const* keys, const int64_t* strides,
                             const void* const* weights, const int64_t* lengths,
                             uint64_t key_mask, int words, int passes, void* scratch,
                             void* out_keys, void* out_sums, int64_t n_slots, void* n_distinct,
                             void* stream) {
  if (n_ranges < 1 || n_ranges > kMaxRanges || n_slots < 0) return int(cudaErrorInvalidValue);
  Ranges r = {};
  r.count = n_ranges;
  r.key_mask = key_mask;
  r.weighted = weights != nullptr;
  for (int q = 0; q < n_ranges; ++q) {
    if (lengths[q] < 0 || strides[q] < 1) return int(cudaErrorInvalidValue);
    r.keys[q] = static_cast<const uint64_t*>(keys[q]);
    r.weights[q] = weights ? static_cast<const uint64_t*>(weights[q]) : nullptr;
    r.stride[q] = strides[q];
    r.start[q + 1] = r.start[q] + lengths[q];
  }
  if (!args_ok(r.start[n_ranges], words, passes)) return int(cudaErrorInvalidValue);
  auto* ok = static_cast<unsigned long long*>(out_keys);
  auto* os = static_cast<unsigned long long*>(out_sums);
  auto* nd = static_cast<long long*>(n_distinct);
  char* sc = static_cast<char*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: return run_group_sum<1>(r, passes, sc, ok, os, n_slots, nd, s);
    case 2: return run_group_sum<2>(r, passes, sc, ok, os, n_slots, nd, s);
    default: return run_group_sum<3>(r, passes, sc, ok, os, n_slots, nd, s);
  }
}
