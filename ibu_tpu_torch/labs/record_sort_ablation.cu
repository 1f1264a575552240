// The record sort's kernels (ibu_tpu_torch/csrc/record_sort.cu) timed one by
// one on 2^22 records shaped like a Drop-seq batch (24-bit barcode, 16-bit
// UMI, a Zipf-like gene id below 36,601: a 56-bit key, 7 passes), then the
// pass kernel with its rank swapped or parts removed, at the shapes the main
// path sorts:
// - dropseq.sort: those 2^22 Drop-seq keys, one word (NW = 1);
// - group-by batch: 2^20 keys of 24 bits drawn from 110,000 barcodes, the
//   histogram engine's batch under the 32-bit hint (NW = 1, 3 passes);
// - v3.encode_sort: 2^20 keys of 80 bits (32-bit barcode, 24-bit UMI, 24-bit
//   read number), two words (NW = 2, 10 passes);
// - full width: 2^22 random keys of 192 bits (NW = 3, 24 passes).
// The ranks (see kRankNames): "chain", as the pass ranked before
// record_sort.cu's rank_warp; "hoisted", rank_warp's counts with the chain's
// peers; "shipped", rank_warp; and two the lab alone holds. A traced run
// stamps each tile's phases (thread 0, clock64) and reports their medians.
// Every variant that sorts is checked exactly against std::sort first; a
// variant with a part removed writes wrong places on purpose and is timed
// only. CUDA events, the median of 9 repetitions after one warm-up. A
// variant's code is not the shipped kernel's, and ptxas schedules it
// otherwise (it may interleave the key loads with the rank), so compare a
// variant with variants and the shipped kernel with itself.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -I ibu_tpu_torch/csrc ibu_tpu_torch/labs/record_sort_ablation.cu -o build/record_sort_ablation
//   ./build/record_sort_ablation
//
// One JSON line per measurement. It is not built by ops/_build.py (which
// compiles csrc/ alone) and needs no torch.

#include "record_sort.cu"

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdio>
#include <random>
#include <vector>

namespace {

constexpr int kRank = 1, kLookBack = 2, kScatter = 4, kAll = 7;
constexpr int kReps = 9;
constexpr int kStamps = 11;  // a traced tile's words: see trace()

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The ranks a variant can take: the pass's before this lab's rank_warp
// (chain), its counts hoisted with the peers as before (hoisted), the
// shipped rank_warp (shipped: the same counts, the peers in PTX), and two
// that only the lab holds (match-or, match-any).
constexpr int kChain = 0, kHoisted = 1, kShipped = 2, kMatchOr = 3, kMatchAny = 4;
const char* const kRankNames[] = {"chain", "hoisted", "shipped", "match-or", "match-any"};

// The peers as the pass had them before: 8 ballots and about 65
// instructions a digit.
__device__ __forceinline__ unsigned chain_peers(int d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// The rank as the pass had it before rank_warp: per item the peers' 8
// ballots, then the warp's count of the digit read, __syncwarp, the lowest
// lane's write of the new count, __syncwarp: one chain of dependent
// shared-memory round trips through the warp's items.
template <int ITEMS>
__device__ __forceinline__ void chain_rank(const int (&digit)[ITEMS], int64_t first, int64_t n,
                                           unsigned* counts, unsigned (&place)[ITEMS]) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool valid = first + k * 32 < n;
    const unsigned peers = chain_peers(digit[k]) & __ballot_sync(kFull, valid);
    const unsigned before = __popc(peers & below);
    unsigned prior = 0;
    if (valid) prior = counts[digit[k]];
    place[k] = prior + before;
    __syncwarp();
    if (valid && before == 0) counts[digit[k]] = prior + __popc(peers);
    __syncwarp();
  }
}

// hoisted: rank_warp's counts (every item's peers first, one atomicAdd a
// digit an item, the priors by shuffle) with the peers as before; match-any:
// the same with each item's peers from __match_any_sync.
template <int RK, int ITEMS>
__device__ __forceinline__ void other_rank(const int (&digit)[ITEMS], int64_t first, int64_t n,
                                           unsigned* counts, unsigned (&place)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned peers[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool valid = first + k * 32 < n;
    const unsigned mine = RK == kMatchAny ? __match_any_sync(kFull, valid ? digit[k] : 256 + lane)
                                          : chain_peers(digit[k]);
    peers[k] = mine & __ballot_sync(kFull, valid);
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    place[k] = 0;
    if (first + k * 32 < n && (peers[k] & below) == 0) {
      place[k] = atomicAdd(&counts[digit[k]], unsigned(__popc(peers[k])));
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int leader = peers[k] ? __ffs(peers[k]) - 1 : lane;
    place[k] = __shfl_sync(kFull, place[k], leader) + __popc(peers[k] & below);
  }
}

// match-or: each item's peers from a shared mask that each lane ORs its bit
// into (as cub's BlockRadixRankMatchEarlyCounts does), the leader's
// atomicAdd for the prior, the mask cleared by the leader: three __syncwarps
// an item, no ballots. ``match`` is the warp's 256 zeroed words.
template <int ITEMS>
__device__ __forceinline__ void match_or_rank(const int (&digit)[ITEMS], int64_t first, int64_t n,
                                              unsigned* counts, unsigned* match,
                                              unsigned (&place)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool valid = first + k * 32 < n;
    if (valid) atomicOr(&match[digit[k]], 1u << lane);
    __syncwarp();
    const unsigned peers = valid ? match[digit[k]] : 0u;
    const bool leader = valid && (peers & below) == 0;
    place[k] = leader ? atomicAdd(&counts[digit[k]], unsigned(__popc(peers))) : 0u;
    __syncwarp();
    if (leader) match[digit[k]] = 0;
    __syncwarp();
    place[k] = __shfl_sync(kFull, place[k], peers ? __ffs(peers) - 1 : lane) + __popc(peers & below);
  }
}

// pass_kernel<NW, ITEMS> over NW live planes with the rank RK, and PARTS: which of rank, look-back and scatter
// run (without the rank the tile's counts come from shared atomics and a
// key's place is its slot; without the look-back the prefix is a guess;
// without the scatter the tile is put in order in shared memory and not
// written out).
// TRACE: thread 0 stamps the phases of its tile into ``stamps`` (kStamps
// words a tile).
template <int NW, int ITEMS, int RK, int PARTS, bool TRACE = false>
__global__ void __launch_bounds__(kThreads)
pass_variant(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n, int pass,
             const unsigned* __restrict__ hist, unsigned long long* status, unsigned* counter,
             unsigned long long* stamps) {
  constexpr int kTileKeys = kThreads * ITEMS;
  constexpr bool RANK = PARTS & kRank, LOOKBACK = PARTS & kLookBack, SCATTER = PARTS & kScatter;
  __shared__ unsigned warp_counts[kWarps][kDigits];
  __shared__ unsigned local_start[kDigits];
  __shared__ long long global_base[kDigits];
  __shared__ long long scan_scratch[kWarps];
  __shared__ unsigned tile_slot;
  __shared__ uint64_t exchange[kTileKeys];
  __shared__ uint8_t sorted_digit[kTileKeys];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long t0 = 0, c0 = 0;
  if (TRACE && tid == 0) t0 = global_ns(), c0 = clock64();
  if (tid == 0) tile_slot = atomicAdd(counter + pass, 1u);
  for (int c = tid; c < kWarps * kDigits; c += kThreads) (&warp_counts[0][0])[c] = 0;
  // match-or's masks live where the tile's keys go after the rank
  unsigned* match = reinterpret_cast<unsigned*>(exchange);
  if (RK == kMatchOr) {
    for (int c = tid; c < kWarps * kDigits; c += kThreads) match[c] = 0;
  }
  __syncthreads();
  const int64_t tile = tile_slot;
  unsigned long long* stamp = stamps + tile * kStamps;  // written by thread 0 as it goes
  if (TRACE && tid == 0) stamp[0] = t0, stamp[1] = c0, stamp[2] = clock64();
  const int64_t base = tile * kTileKeys;
  const int64_t first = base + warp * (ITEMS * 32) + lane;
  uint64_t key[ITEMS][NW];
  int digit[ITEMS];
  unsigned place[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = first + k * 32;
#pragma unroll
    for (int j = 0; j < NW; ++j) key[k][j] = i < n ? in[j * n + i] : 0;
    digit[k] = digit_of(key[k], pass);
  }
  if (TRACE) {  // the loads apart from the rank
    __syncthreads();
    if (tid == 0) stamp[3] = clock64();
  }
  if (!RANK) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (first + k * 32 < n) atomicAdd(&warp_counts[warp][digit[k]], 1u);
      place[k] = (warp * ITEMS + k) * 32 + lane;
    }
  } else if (RK == kShipped) {
    rank_warp(digit, first, n, warp_counts[warp], place);
  } else if (RK == kChain) {
    chain_rank(digit, first, n, warp_counts[warp], place);
  } else if (RK == kMatchOr) {
    match_or_rank(digit, first, n, warp_counts[warp], match + warp * kDigits, place);
  } else {
    other_rank<RK>(digit, first, n, warp_counts[warp], place);
  }
  __syncthreads();
  if (TRACE && tid == 0) stamp[4] = clock64();

  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = warp_counts[w][tid];
    warp_counts[w][tid] = count;
    count += c;
  }
  const uint64_t tag = uint64_t(pass + 1) << 56;
  volatile unsigned long long* mine = status + tile * kDigits + tid;
  long long prefix = 0;
  if (tile == 0) {
    *mine = kPrefix | tag | count;
  } else if (LOOKBACK) {
    *mine = kAggregate | tag | count;
    for (int64_t t = tile - 1, spins = 0;;) {  // as pass_kernel's
      const uint64_t s = static_cast<volatile unsigned long long*>(status)[t * kDigits + tid];
      if ((s & kTagMask) != tag || (s >> 62) == 0) {
        if (++spins > (int64_t(1) << 26)) __trap();
        continue;
      }
      prefix += static_cast<long long>(s & kCountMask);
      if ((s >> 62) == 2) break;
      --t;
    }
    *mine = kPrefix | tag | uint64_t(prefix + count);
  } else {
    prefix = tile * (kTileKeys / kDigits);
    *mine = kPrefix | tag | uint64_t(prefix + count);
  }
  if (TRACE) {  // every digit's look-back apart from the scans
    __syncthreads();
    if (tid == 0) stamp[5] = clock64();
  }
  const long long start = exclusive_scan(count, scan_scratch);
  const long long bucket = exclusive_scan(hist[pass * kDigits + tid], scan_scratch);
  local_start[tid] = unsigned(start);
  global_base[tid] = bucket + prefix - start;
  __syncthreads();
  if (TRACE && tid == 0) stamp[6] = clock64();

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (RANK) place[k] += local_start[digit[k]] + warp_counts[warp][digit[k]];
    if (first + k * 32 < n) sorted_digit[place[k]] = uint8_t(digit[k]);
  }
  const int tile_keys = int(n - base < kTileKeys ? n - base : kTileKeys);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (first + k * 32 < n) exchange[place[k]] = key[k][j];
    }
    __syncthreads();
    if (!SCATTER) {
      if (exchange[tid] == 12345 && sorted_digit[tid] == 7) out[0] = 1;  // keeps the tile live
      return;
    }
    if (TRACE && tid == 0 && j == 0) stamp[7] = clock64();
    for (int i = tid; i < tile_keys; i += kThreads) {
      long long dst = global_base[sorted_digit[i]] + i;
      if (PARTS != kAll) dst &= n - 1;  // wrong places: keep them inside (n is a power of two)
      out[j * n + dst] = exchange[i];
    }
    __syncthreads();
  }
  if (TRACE && tid == 0) {
    stamp[8] = clock64(), stamp[9] = global_ns();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    stamp[10] = sm;
  }
}

// the rebuild without staging: each thread stores its record's three words
__global__ void __launch_bounds__(kThreads)
unpack_direct(const uint64_t* __restrict__ keys, int64_t n, const unsigned long long* __restrict__ ors,
              Masks masks, uint64_t* __restrict__ out) {
  const Layout l = key_layout(ors, masks);
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x; r < n; r += stride) {
    const uint64_t k[1] = {keys[r]};
#pragma unroll
    for (int f = 0; f < 3; ++f) out[3 * r + f] = get(k, l.offset[f], l.width[f]);
  }
}

struct Timer {
  cudaEvent_t a, b;
  std::vector<float> ms;
  Timer() {
    cudaEventCreate(&a);
    cudaEventCreate(&b);
  }
  void start() { cudaEventRecord(a); }
  void stop(bool keep) {
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float t;
    cudaEventElapsedTime(&t, a, b);
    if (keep) ms.push_back(t);
  }
  float median() {
    std::sort(ms.begin(), ms.end());
    return ms[ms.size() / 2];
  }
};

void report(const char* what, float ms, double bound_bytes, const char* correct) {
  printf("{\"what\": \"%s\", \"ms\": %.5f, \"bound_ms\": %.5f, \"pct_of_bound\": %.1f, \"correct\": %s}\n",
         what, ms, bound_bytes / 3350e9 * 1e3, 100.0 * bound_bytes / 3350e9 * 1e3 / ms, correct);
}

// One shape: n keys of ``bits`` bits as NW planes, every pass's histogram,
// the sorted planes, and the buffers the passes run over.
struct Shape {
  const char* name;
  int64_t n;
  int words, bits, passes;
  unsigned long long ors[3];  // field ORs that give the shipped kernel W = bits
  uint64_t *keys, *a, *b;
  unsigned* hist;
  unsigned* counter;
  unsigned long long *status, *d_ors;
  std::vector<uint64_t> sorted;  // NW planes of n

  Shape(const char* name_, int words_, int bits_, const unsigned long long (&ors_)[3],
        const std::vector<uint64_t>& planes)
      : name(name_), n(int64_t(planes.size()) / words_), words(words_), bits(bits_),
        passes((bits_ + 7) / 8) {
    for (int f = 0; f < 3; ++f) ors[f] = ors_[f];
    std::vector<std::array<uint64_t, kMaxWords>> rows(n);
    std::vector<unsigned> h(kMaxPasses * kDigits, 0);
    for (int64_t i = 0; i < n; ++i) {
      rows[i] = {0, 0, 0};
      for (int j = 0; j < words; ++j) rows[i][kMaxWords - 1 - j] = planes[j * n + i];
      for (int p = 0; p < passes; ++p) h[p * kDigits + ((planes[(p >> 3) * n + i] >> (8 * (p & 7))) & 0xFF)]++;
    }
    std::sort(rows.begin(), rows.end());  // most significant word first
    sorted.resize(planes.size());
    for (int64_t i = 0; i < n; ++i)
      for (int j = 0; j < words; ++j) sorted[j * n + i] = rows[i][kMaxWords - 1 - j];
    const size_t bytes = planes.size() * 8;
    cudaMalloc(&keys, bytes);
    cudaMalloc(&a, bytes);
    cudaMalloc(&b, bytes);
    cudaMalloc(&hist, h.size() * 4);
    cudaMalloc(&counter, 256);
    cudaMalloc(&status, (n / 1024 + 1) * kDigits * 8);
    cudaMalloc(&d_ors, 24);
    cudaMemcpy(keys, planes.data(), bytes, cudaMemcpyHostToDevice);
    cudaMemcpy(hist, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(d_ors, ors, 24, cudaMemcpyHostToDevice);
  }
  ~Shape() {
    for (void* p : {(void*)keys, (void*)a, (void*)b, (void*)hist, (void*)counter, (void*)status,
                    (void*)d_ors})
      cudaFree(p);
  }
  double bound_bytes() const { return double(passes) * 16.0 * words * n; }
  const char* check() const {  // the passes end in b after an odd count
    std::vector<uint64_t> got(sorted.size());
    cudaMemcpy(got.data(), passes & 1 ? b : a, got.size() * 8, cudaMemcpyDeviceToHost);
    return got == sorted ? "true" : "false";
  }
};

// Times ``launch(in, out, pass)`` over the shape's passes; checks the result
// when ``sorts``.
template <class Launch>
void time_passes(Shape& s, int tile_keys, bool sorts, const char* what, Launch launch) {
  const unsigned tiles = unsigned((s.n + tile_keys - 1) / tile_keys);
  Timer t;
  const char* correct = "null";
  for (int rep = 0; rep <= kReps; ++rep) {
    cudaMemcpy(s.a, s.keys, s.n * s.words * 8, cudaMemcpyDeviceToDevice);
    cudaMemset(s.status, 0, size_t(tiles) * kDigits * 8);
    cudaMemset(s.counter, 0, 256);
    t.start();
    for (int p = 0; p < s.passes; ++p) launch(tiles, p & 1 ? s.b : s.a, p & 1 ? s.a : s.b, p);
    t.stop(rep > 0);
    if (rep == 0 && sorts) correct = s.check();
  }
  char label[256];
  snprintf(label, sizeof label, "%s: %d passes: %s", s.name, s.passes, what);
  report(label, t.median(), s.bound_bytes(), correct);
}

template <int NW, int ITEMS, int RK, int PARTS>
void variant(Shape& s, const char* what) {
  auto k = pass_variant<NW, ITEMS, RK, PARTS>;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, k);
  int occupancy = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, k, kThreads, 0);
  char label[200];
  snprintf(label, sizeof label, "%s rank, %s (256x%d, %d regs, %d blocks an SM)", kRankNames[RK],
           what, ITEMS, attr.numRegs, occupancy);
  time_passes(s, kThreads * ITEMS, PARTS == kAll, label,
              [&](unsigned tiles, const uint64_t* in, uint64_t* out, int p) {
                k<<<tiles, kThreads>>>(in, out, s.n, p, s.hist, s.status, s.counter, nullptr);
              });
}

// One traced run of the shape's passes: the median over tiles of each
// phase's time (thread 0's view, clock64 scaled by globaltimer), the mean
// tiles in flight and each pass's wall.
template <int NW, int ITEMS, int RK>
void trace(Shape& s) {
  auto k = pass_variant<NW, ITEMS, RK, kAll, true>;
  const unsigned tiles = unsigned((s.n + kThreads * ITEMS - 1) / (kThreads * ITEMS));
  unsigned long long* d;
  cudaMalloc(&d, size_t(tiles) * s.passes * kStamps * 8);
  cudaMemcpy(s.a, s.keys, s.n * s.words * 8, cudaMemcpyDeviceToDevice);
  cudaMemset(s.status, 0, size_t(tiles) * kDigits * 8);
  cudaMemset(s.counter, 0, 256);
  for (int p = 0; p < s.passes; ++p)
    k<<<tiles, kThreads>>>(p & 1 ? s.b : s.a, p & 1 ? s.a : s.b, s.n, p, s.hist, s.status,
                           s.counter, d + size_t(p) * tiles * kStamps);
  std::vector<unsigned long long> h(size_t(tiles) * s.passes * kStamps);
  cudaMemcpy(h.data(), d, h.size() * 8, cudaMemcpyDeviceToHost);
  cudaFree(d);
  const char* names[] = {"slot", "loads", "rank", "look-back", "scans", "smem scatter",
                         "global scatter"};
  std::vector<double> phase[7], total;
  double ns_per_clock = 0, busy_ns = 0, wall_ns = 0;
  for (int p = 0; p < s.passes; ++p) {
    unsigned long long t0 = ~0ull, t1 = 0;
    for (unsigned t = 0; t < tiles; ++t) {
      const unsigned long long* x = &h[(size_t(p) * tiles + t) * kStamps];
      ns_per_clock += double(x[9] - x[0]) / double(x[8] - x[1]) / (double(tiles) * s.passes);
      for (int i = 0; i < 7; ++i) phase[i].push_back(double(x[i + 2] - x[i + 1]));
      total.push_back(double(x[8] - x[1]));
      busy_ns += double(x[9] - x[0]);
      t0 = std::min(t0, x[0]), t1 = std::max(t1, x[9]);
    }
    wall_ns += double(t1 - t0);
  }
  auto median = [](std::vector<double> v) {
    std::sort(v.begin(), v.end());
    return v[v.size() / 2];
  };
  printf("{\"what\": \"%s: trace, %s rank (256x%d)\", \"us_per_pass\": %.2f, "
         "\"tiles_in_flight\": %.1f, \"tile_us_median\": %.3f", s.name, kRankNames[RK], ITEMS,
         wall_ns / s.passes / 1e3, busy_ns / wall_ns, median(total) * ns_per_clock / 1e3);
  for (int i = 0; i < 7; ++i) printf(", \"%s_us\": %.3f", names[i], median(phase[i]) * ns_per_clock / 1e3);
  printf("}\n");
}

template <int NW>
void shipped(Shape& s) {
  constexpr int kItems = items_for(NW);
  const Masks all = {{~0ull, ~0ull, ~0ull}};
  char label[200];
  snprintf(label, sizeof label, "pass_kernel<%d, %d> as shipped", NW, kItems);
  time_passes(s, kThreads * kItems, true, label,
              [&](unsigned tiles, const uint64_t* in, uint64_t* out, int p) {
                pass_kernel<NW, kItems><<<tiles, kThreads>>>(in, out, s.n, s.d_ors, all, p, s.hist,
                                                             s.status, s.counter);
              });
}

// the split of a pass at one shape, for both ranks
template <int NW, int ITEMS>
void split(Shape& s) {
  variant<NW, ITEMS, kShipped, 0>(s, "loads, tile counts and scans only");
  variant<NW, ITEMS, kChain, kRank>(s, "rank only");
  variant<NW, ITEMS, kHoisted, kRank>(s, "rank only");
  variant<NW, ITEMS, kShipped, kRank>(s, "rank only");
  variant<NW, ITEMS, kShipped, kRank | kScatter>(s, "no look-back");
  variant<NW, ITEMS, kShipped, kRank | kLookBack>(s, "no scatter");
  variant<NW, ITEMS, kChain, kAll>(s, "full pass");
  variant<NW, ITEMS, kHoisted, kAll>(s, "full pass");
  variant<NW, ITEMS, kShipped, kAll>(s, "full pass");
}

std::vector<uint64_t> dropseq_planes(int64_t n, std::mt19937_64& rng, std::vector<uint64_t>* rec) {
  std::vector<uint64_t> keys(n);
  if (rec) rec->resize(3 * n);
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t bc = rng() & 0xFFFFFF, umi = rng() & 0xFFFF;
    const double u = double(rng() >> 11) / double(uint64_t(1) << 53);
    const uint64_t gene = uint64_t(std::pow(36601.0, u)) - 1;
    if (rec) (*rec)[3 * r] = bc, (*rec)[3 * r + 1] = umi, (*rec)[3 * r + 2] = gene;
    keys[r] = bc << 32 | umi << 16 | gene;  // the packed key: widths 24, 16, 16
  }
  return keys;
}

// the shipped kernels one by one at the Drop-seq shape, and the rebuild
// without staging
void shipped_kernels(Shape& m, const std::vector<uint64_t>& rec) {
  const int64_t n = m.n;
  uint64_t *d_rec, *out;
  cudaMalloc(&d_rec, 3 * n * 8);
  cudaMalloc(&out, 3 * n * 8);
  cudaMemcpy(d_rec, rec.data(), 3 * n * 8, cudaMemcpyHostToDevice);
  std::vector<uint64_t> want(3 * n);
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t k = m.sorted[r];
    want[3 * r] = k >> 32, want[3 * r + 1] = (k >> 16) & 0xFFFF, want[3 * r + 2] = k & 0xFFFF;
  }
  const Masks lo = {{0xFFFFFFFFull, 0xFFFFFFFFull, 0xFFFFFFFFull}};
  const unsigned tiles = unsigned((n + 4095) / 4096);
  Timer t_or, t_pack, t_pass, t_unpack;
  unsigned* d_hist2;
  cudaMalloc(&d_hist2, kMaxPasses * kDigits * 4);
  unsigned long long* ors2;
  cudaMalloc(&ors2, 24);
  for (int rep = 0; rep <= kReps; ++rep) {
    cudaMemset(ors2, 0, 24);
    cudaMemset(d_hist2, 0, kMaxPasses * kDigits * 4);
    cudaMemset(m.status, 0, size_t(tiles) * kDigits * 8);
    cudaMemset(m.counter, 0, 256);
    t_or.start();
    field_or_kernel<<<grid_for(n, 8), kThreads>>>(d_rec, n, ors2);
    t_or.stop(rep > 0);
    t_pack.start();
    pack_kernel<1><<<grid_for(n, 4), kThreads>>>(d_rec, n, m.d_ors, lo, m.a, d_hist2);
    t_pack.stop(rep > 0);
    t_pass.start();
    for (int p = 0; p < 7; ++p)
      pass_kernel<1, 16><<<tiles, kThreads>>>(p & 1 ? m.b : m.a, p & 1 ? m.a : m.b, n, m.d_ors, lo, p,
                                               d_hist2, m.status, m.counter);
    t_pass.stop(rep > 0);
    t_unpack.start();
    unpack_kernel<1><<<grid_for(n, 8), kThreads>>>(m.a, m.b, n, m.d_ors, lo, out);
    t_unpack.stop(rep > 0);
  }
  std::vector<uint64_t> got(3 * n);
  cudaMemcpy(got.data(), out, 3 * n * 8, cudaMemcpyDeviceToHost);
  const char* ok = got == want ? "true" : "false";
  report("field_or_kernel", t_or.median(), 24.0 * n, "null");
  report("pack_kernel<1>", t_pack.median(), 32.0 * n, "null");
  report("pass_kernel<1, 16> x 7", t_pass.median(), 7 * 16.0 * n, "null");
  report("unpack_kernel<1> (staged)", t_unpack.median(), 32.0 * n, ok);
  Timer t_direct;
  for (int rep = 0; rep <= kReps; ++rep) {
    t_direct.start();
    unpack_direct<<<grid_for(n, 8), kThreads>>>(m.b, n, m.d_ors, lo, out);
    t_direct.stop(rep > 0);
  }
  cudaMemcpy(got.data(), out, 3 * n * 8, cudaMemcpyDeviceToHost);
  report("unpack_direct (three strided stores a thread)", t_direct.median(), 32.0 * n,
         got == want ? "true" : "false");
  for (void* p : {(void*)d_rec, (void*)out, (void*)d_hist2, (void*)ors2}) cudaFree(p);
}

}  // namespace

int main() {
  std::mt19937_64 rng(12345);
  {
    std::vector<uint64_t> rec;
    Shape s("dropseq.sort 2^22 W=56", 1, 56, {0xFFFFFF, 0xFFFF, 0xFFFF},
            dropseq_planes(int64_t(1) << 22, rng, &rec));
    shipped_kernels(s, rec);
    variant<1, 16, kShipped, kAll>(s, "warm-up");
    shipped<1>(s);
    trace<1, 16, kChain>(s);
    trace<1, 16, kHoisted>(s);
    trace<1, 16, kShipped>(s);
    split<1, 16>(s);
    variant<1, 16, kMatchOr, kAll>(s, "full pass");
    variant<1, 16, kMatchAny, kAll>(s, "full pass");
    variant<1, 8, kShipped, kAll>(s, "full pass");
    variant<1, 12, kShipped, kAll>(s, "full pass");
  }
  {
    const int64_t n = int64_t(1) << 20;
    std::vector<uint64_t> pool(110000), keys(n);
    for (auto& v : pool) v = rng() & 0xFFFFFF;
    pool[0] = 0xFFFFFF;
    for (auto& v : keys) v = pool[rng() % pool.size()];
    Shape s("group-by batch 2^20 W=24", 1, 24, {0, 0, 0xFFFFFF}, keys);
    shipped<1>(s);
    trace<1, 16, kChain>(s);
    trace<1, 16, kShipped>(s);
    split<1, 16>(s);
  }
  {
    const int64_t n = int64_t(1) << 20;
    std::vector<uint64_t> planes(2 * n);
    for (int64_t i = 0; i < n; ++i) {
      const uint64_t bc = rng() & 0xFFFFFFFF, umi = rng() & 0xFFFFFF, idx = rng() & 0xFFFFFF;
      planes[i] = bc << 48 | umi << 24 | idx;  // widths 32, 24, 24 from bit 79 down
      planes[n + i] = bc >> 16;
    }
    Shape s("v3.encode_sort 2^20 W=80", 2, 80, {0xFFFFFFFF, 0xFFFFFF, 0xFFFFFF}, planes);
    shipped<2>(s);
    trace<2, 12, kChain>(s);
    trace<2, 16, kShipped>(s);
    split<2, 16>(s);
    variant<2, 12, kChain, kAll>(s, "full pass");
    variant<2, 12, kShipped, kAll>(s, "full pass");
  }
  {
    const int64_t n = int64_t(1) << 22;
    std::vector<uint64_t> planes(3 * n);
    for (auto& v : planes) v = rng();
    Shape s("full width 2^22 W=192", 3, 192, {~0ull, ~0ull, ~0ull}, planes);
    shipped<3>(s);
    trace<3, 8, kChain>(s);
    trace<3, 12, kShipped>(s);
    split<3, 12>(s);
    variant<3, 8, kChain, kAll>(s, "full pass");
    variant<3, 8, kShipped, kAll>(s, "full pass");
  }
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
