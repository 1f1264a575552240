// Host runtime of ibu_tpu_torch: the threaded field-sum engine, the host
// 2-bit codec, the FASTQ chunk parser, the record sort, the out-of-core
// external merge sort and the key-interval merges of sorted runs, with a
// plain C interface loaded by ctypes (ibu_tpu_torch/native.py).
//
// A copy of the functions of ibu_tpu/native/ibu_native.cpp that the port
// uses: ibu_checksum_parallel, ibu_pack_2bit / ibu_unpack_2bit with their
// threaded _mt forms, ibu_fastq_gather, ibu_sort_records, ibu_sort_file,
// ibu_run_interval, ibu_merge_runs_interval with its _mt form, and
// ibu_merge_files. Built with g++ (not nvcc) into its own library, so it
// builds and runs where there is no CUDA toolkit. Every function returns 0
// on success or a negative errno-style code.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

static const uint64_t RECORD_SIZE = 24;

struct IbuRecord {
  uint64_t barcode;
  uint64_t umi;
  uint64_t index;
};
static_assert(sizeof(IbuRecord) == 24, "wire record must be 24 bytes");

// Sum the three record fields over [0, n) records with nthreads, using the
// reference's contiguous remainder-to-last partition. Wrapping u64 adds.
int ibu_checksum_parallel(const char* path, uint64_t n_records,
                          uint64_t* out3, int nthreads) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (::fstat(fd, &st) != 0) { int e = errno; ::close(fd); return -e; }
  uint64_t need = 32 + n_records * RECORD_SIZE;
  if (static_cast<uint64_t>(st.st_size) < need) { ::close(fd); return -EINVAL; }
  void* map = ::mmap(nullptr, need, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return -errno;
  const IbuRecord* recs =
      reinterpret_cast<const IbuRecord*>(static_cast<const uint8_t*>(map) + 32);

  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 256));
  uint64_t per = n_records / nthreads;
  std::vector<std::thread> threads;
  std::vector<uint64_t> partial(static_cast<size_t>(nthreads) * 3, 0);
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n_records : start + per;
    threads.emplace_back([recs, start, end, t, &partial]() {
      uint64_t b = 0, u = 0, i = 0;
      for (uint64_t k = start; k < end; ++k) {
        b += recs[k].barcode;
        u += recs[k].umi;
        i += recs[k].index;
      }
      partial[3 * t + 0] = b;
      partial[3 * t + 1] = u;
      partial[3 * t + 2] = i;
    });
  }
  for (auto& th : threads) th.join();
  out3[0] = out3[1] = out3[2] = 0;
  for (int t = 0; t < nthreads; ++t) {
    out3[0] += partial[3 * t + 0];
    out3[1] += partial[3 * t + 1];
    out3[2] += partial[3 * t + 2];
  }
  ::munmap(map, need);
  return 0;
}

// Pack n sequences of L ASCII bases (row-major, n x L) into u64 words, base
// i at bits 2i, A=00 C=01 G=10 T=11 (case-insensitive, total). Returns
// -EINVAL on the first invalid base when validate != 0.
int ibu_pack_2bit(const uint8_t* ascii, uint64_t n, uint32_t L,
                  uint64_t* out, int validate) {
  if (L == 0 || L > 32) return -EINVAL;
  for (uint64_t r = 0; r < n; ++r) {
    const uint8_t* row = ascii + r * L;
    uint64_t word = 0;
    if (validate) {
      for (uint32_t i = 0; i < L; ++i) {
        uint8_t c = row[i] & 0xDF;  // uppercase
        if (c != 'A' && c != 'C' && c != 'G' && c != 'T') return -EINVAL;
      }
    }
    for (uint32_t i = 0; i < L; ++i) {
      uint64_t t = (row[i] >> 1) & 3;
      word |= (t ^ (t >> 1)) << (2 * i);
    }
    out[r] = word;
  }
  return 0;
}

// Unpack n u64 words into n x L uppercase ASCII bases (row-major).
int ibu_unpack_2bit(const uint64_t* words, uint64_t n, uint32_t L,
                    uint8_t* out) {
  if (L == 0 || L > 32) return -EINVAL;
  static const char LUT[4] = {'A', 'C', 'G', 'T'};
  for (uint64_t r = 0; r < n; ++r) {
    uint64_t w = words[r];
    uint8_t* row = out + r * L;
    for (uint32_t i = 0; i < L; ++i) {
      row[i] = static_cast<uint8_t>(LUT[(w >> (2 * i)) & 3]);
    }
  }
  return 0;
}

// Threaded forms: rows split contiguously over nthreads (0: all cores) from
// 65536 rows up; below that, or with one thread, the scalar path. A failed
// validation surfaces as -EINVAL exactly as in the scalar path.
int ibu_pack_2bit_mt(const uint8_t* ascii, uint64_t n, uint32_t L,
                     uint64_t* out, int validate, int nthreads) {
  if (L == 0 || L > 32) return -EINVAL;
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));
  if (n < 65536 || nthreads == 1)
    return ibu_pack_2bit(ascii, n, L, out, validate);
  std::atomic<int> failure(0);
  std::vector<std::thread> threads;
  uint64_t per = n / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n : start + per;
    threads.emplace_back([=, &failure]() {
      int rc = ibu_pack_2bit(ascii + start * L, end - start, L,
                             out + start, validate);
      if (rc != 0) failure.store(-rc);
    });
  }
  for (auto& th : threads) th.join();
  return -failure.load();
}

int ibu_unpack_2bit_mt(const uint64_t* words, uint64_t n, uint32_t L,
                       uint8_t* out, int nthreads) {
  if (L == 0 || L > 32) return -EINVAL;
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min<int>(nthreads, 64));
  if (n < 65536 || nthreads == 1)
    return ibu_unpack_2bit(words, n, L, out);
  std::atomic<int> failure(0);
  std::vector<std::thread> threads;
  uint64_t per = n / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t start = static_cast<uint64_t>(t) * per;
    uint64_t end = (t == nthreads - 1) ? n : start + per;
    threads.emplace_back([=, &failure]() {
      int rc = ibu_unpack_2bit(words + start, end - start, L,
                               out + start * L);
      if (rc != 0) failure.store(-rc);
    });
  }
  for (auto& th : threads) th.join();
  return -failure.load();
}

// Write nbytes to a new file at path in large writes (the run spill of
// ibu_sort_file).
static int write_whole_file(const char* path, const uint8_t* data,
                            uint64_t nbytes) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  uint64_t off = 0;
  while (off < nbytes) {
    size_t chunk = std::min<uint64_t>(nbytes - off, 1ull << 30);
    ssize_t w = ::write(fd, data + off, chunk);
    if (w < 0) { int e = errno; ::close(fd); return -e; }
    off += static_cast<uint64_t>(w);
  }
  if (::close(fd) != 0) return -errno;
  return 0;
}

// ---------------------------------------------------------------------------
// FASTQ chunk parser (the ingest hot loop)
// ---------------------------------------------------------------------------

// Gather the first prefix_len bases of every SEQUENCE line (global line
// index % 4 == 1) among the COMPLETE lines of buf, row-major into
// rows_out. Lines starting at/after start_cap are not processed (the
// byte-range shard cut; pass UINT64_MAX for none). memchr + memcpy.
//
// out6: [rows_written, bytes_consumed (offset after the last processed
// line's newline), lines_processed, capped(0/1), err_line, err_content].
// Returns 0, or -EINVAL for a sequence line shorter than prefix_len
// (err_line = its global line index, err_content = its length excluding
// a trailing \r — the caller formats the user-facing message).
int ibu_fastq_gather(const uint8_t* buf, uint64_t len, uint64_t first_lineno,
                     uint32_t prefix_len, uint64_t start_cap,
                     uint8_t* rows_out, uint64_t max_rows, uint64_t* out6) {
  uint64_t rows = 0, consumed = 0, lines = 0;
  uint64_t pos = 0;
  out6[3] = out6[4] = out6[5] = 0;
  while (pos < len) {
    if (pos >= start_cap) { out6[3] = 1; break; }
    const void* nl = ::memchr(buf + pos, '\n', len - pos);
    if (nl == nullptr) break;  // trailing partial line -> caller's carry
    uint64_t end = static_cast<uint64_t>(
        static_cast<const uint8_t*>(nl) - buf);
    if (((first_lineno + lines) & 3) == 1) {
      uint64_t content = end - pos;
      if (content > 0 && buf[end - 1] == '\r') content -= 1;  // CRLF
      if (content < prefix_len) {
        out6[0] = rows;
        out6[1] = consumed;
        out6[2] = lines;
        out6[4] = first_lineno + lines;
        out6[5] = content;
        return -EINVAL;
      }
      if (rows >= max_rows) return -ENOMEM;  // caller sized rows_out wrong
      ::memcpy(rows_out + rows * prefix_len, buf + pos, prefix_len);
      ++rows;
    }
    ++lines;
    pos = end + 1;
    consumed = pos;
  }
  out6[0] = rows;
  out6[1] = consumed;
  out6[2] = lines;
  return 0;
}

// ---------------------------------------------------------------------------
// record sort (lexicographic barcode → umi → index; record.rs:29-32)
// ---------------------------------------------------------------------------

static bool record_less(const IbuRecord& a, const IbuRecord& b) {
  if (a.barcode != b.barcode) return a.barcode < b.barcode;
  if (a.umi != b.umi) return a.umi < b.umi;
  return a.index < b.index;
}

int ibu_sort_records(uint8_t* records_bytes, uint64_t n_records) {
  IbuRecord* recs = reinterpret_cast<IbuRecord*>(records_bytes);
  std::sort(recs, recs + n_records, record_less);
  return 0;
}

// ---------------------------------------------------------------------------
// out-of-core external merge sort: whole-file sorted rewrite
// ---------------------------------------------------------------------------
//
// Sorts an IBU file that may be larger than memory: chunked in-memory sorts
// (one worker thread per in-flight chunk) spill headerless runs next to the
// output, then a k-way priority-queue merge streams the sorted result with
// the header's sorted flag set (bit 0, ref header.rs:17-24).

// forward declarations: ibu_sort_file's parallel merge phase reuses the
// interval primitives defined further down
namespace {
int run_interval_bounds(const char* run_path, const uint64_t* lo3,
                        const uint64_t* hi3, int hi_unbounded,
                        uint64_t* out2);
}  // namespace
int ibu_merge_runs_interval(const char* const* run_paths, uint64_t n_runs,
                            const uint64_t* lo3, const uint64_t* hi3,
                            int hi_unbounded, const char* out_path,
                            uint64_t out_byte_offset);
int ibu_merge_runs_interval_mt(const char* const* run_paths, uint64_t n_runs,
                               const uint64_t* lo3, const uint64_t* hi3,
                               int hi_unbounded, const char* out_path,
                               uint64_t out_byte_offset, int nthreads,
                               uint64_t expect_records);

namespace {

struct RunReader {
  int fd = -1;
  std::vector<IbuRecord> buf;
  size_t pos = 0, len = 0;
  uint64_t remaining = 0;

  // 1 = refilled, 0 = run exhausted (clean EOF), -1 = I/O error. The
  // distinction matters: treating a read error as exhaustion would emit a
  // truncated "sorted" file with success status.
  int refill() {
    if (remaining == 0) return 0;
    uint64_t want = std::min<uint64_t>(remaining, buf.size());
    uint64_t bytes = want * sizeof(IbuRecord);
    uint64_t got = 0;
    uint8_t* dst = reinterpret_cast<uint8_t*>(buf.data());
    while (got < bytes) {
      ssize_t r = ::read(fd, dst + got, bytes - got);
      if (r <= 0) return -1;  // short run file or read error
      got += static_cast<uint64_t>(r);
    }
    len = want;
    pos = 0;
    remaining -= want;
    return 1;
  }
};

}  // namespace

int ibu_sort_file(const char* in_path, const char* out_path,
                  uint64_t chunk_records, int nthreads) {
  if (chunk_records == 0) chunk_records = 32ull * 1024 * 1024 / 24;
  int in_fd = ::open(in_path, O_RDONLY);
  if (in_fd < 0) return -errno;
  struct stat st;
  if (::fstat(in_fd, &st) != 0) { int e = errno; ::close(in_fd); return -e; }
  uint64_t size = static_cast<uint64_t>(st.st_size);
  if (size < 32 || (size - 32) % RECORD_SIZE != 0) {
    ::close(in_fd);
    return -EINVAL;
  }
  uint8_t header[32];
  if (::read(in_fd, header, 32) != 32) { ::close(in_fd); return -EIO; }
  uint64_t n_records = (size - 32) / RECORD_SIZE;

  // phase 1: sorted runs. Chunks are read sequentially; sorting+spilling of
  // up to `nthreads` chunks proceeds concurrently.
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, 64));
  uint64_t n_runs = (n_records + chunk_records - 1) / chunk_records;
  if (n_runs == 0) n_runs = 1;
  std::vector<std::string> run_paths(n_runs);
  std::vector<uint64_t> run_sizes(n_runs, 0);
  std::atomic<int> failure(0);
  {
    std::vector<std::thread> workers;
    std::atomic<uint64_t> next_run(0);
    std::mutex read_mu;
    for (int t = 0; t < nthreads; ++t) {
      workers.emplace_back([&]() {
        std::vector<IbuRecord> chunk;
        for (;;) {
          uint64_t r = next_run.fetch_add(1);
          if (r >= n_runs || failure.load()) return;
          uint64_t start = r * chunk_records;
          uint64_t count = std::min(chunk_records, n_records - start);
          run_sizes[r] = count;
          chunk.resize(count);
          {
            // pread is thread-safe at independent offsets; no lock needed
            uint64_t bytes = count * sizeof(IbuRecord);
            uint64_t got = 0;
            uint8_t* dst = reinterpret_cast<uint8_t*>(chunk.data());
            while (got < bytes) {
              ssize_t rd = ::pread(in_fd, dst + got, bytes - got,
                                   static_cast<off_t>(32 + start * 24 + got));
              if (rd <= 0) { failure.store(EIO); return; }
              got += static_cast<uint64_t>(rd);
            }
          }
          std::sort(chunk.begin(), chunk.end(), record_less);
          run_paths[r] = std::string(out_path) + ".run" + std::to_string(r);
          int rc = write_whole_file(
              run_paths[r].c_str(),
              reinterpret_cast<const uint8_t*>(chunk.data()),
              count * sizeof(IbuRecord));
          if (rc != 0) { failure.store(-rc); return; }
        }
      });
    }
    for (auto& w : workers) w.join();
  }
  ::close(in_fd);
  if (failure.load()) {
    for (auto& p : run_paths) if (!p.empty()) ::unlink(p.c_str());
    return -failure.load();
  }

  // phase 2: KEY-RANGE-PARALLEL k-way merge. Sampled splitters
  // partition the key space; each thread merges one [lo, hi) interval of
  // every run (an interval of a sorted run is one contiguous slice) and
  // pwrites it at its exact byte offset of the pre-truncated output.
  // Byte-identical to the sequential merge — equal records are
  // byte-identical, so any valid splitter choice yields the same file —
  // and the merge stage now scales with cores like the chunk sorts do.
  int rc = 0;
  {
    int out_fd = ::open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (out_fd < 0) { rc = -errno; goto cleanup; }
    header[16] |= 1;  // sorted flag (bit 0 of the u64 at offset 16)
    if (::write(out_fd, header, 32) != 32 ||
        ::ftruncate(out_fd, 32 + n_records * RECORD_SIZE) != 0) {
      ::close(out_fd);
      rc = -EIO;
      goto cleanup;
    }
    if (::close(out_fd) != 0) { rc = -errno; goto cleanup; }
  }
  {
    std::vector<const char*> paths(n_runs);
    for (uint64_t r = 0; r < n_runs; ++r) paths[r] = run_paths[r].c_str();
    uint64_t zeros[3] = {0, 0, 0};
    rc = ibu_merge_runs_interval_mt(paths.data(), n_runs, zeros, zeros, 1,
                                    out_path, 32, nthreads, n_records);
  }
cleanup:
  for (auto& p : run_paths) if (!p.empty()) ::unlink(p.c_str());
  if (rc != 0) ::unlink(out_path);  // no partial "sorted" file on failure
  return rc;
}

// ---------------------------------------------------------------------------
// key-interval primitives over sorted headerless runs
// ---------------------------------------------------------------------------
//
// Sorted runs make a key interval one contiguous slice: (1) binary-searched
// [lo, hi) key intervals of any sorted run; (2) a k-way merge of one interval
// from every run, pwritten at an exact byte offset of a pre-truncated output,
// with no concatenation pass after the merge.

namespace {

inline bool triple_less(const IbuRecord& a, const uint64_t* k3) {
  if (a.barcode != k3[0]) return a.barcode < k3[0];
  if (a.umi != k3[1]) return a.umi < k3[1];
  return a.index < k3[2];
}

// [start_idx, end_idx) of records with lo3 <= key (< hi3 unless unbounded)
// in one sorted HEADERLESS run; mmap + std::lower_bound (O(log) faults).
int run_interval_bounds(const char* run_path, const uint64_t* lo3,
                        const uint64_t* hi3, int hi_unbounded,
                        uint64_t* out2) {
  int fd = ::open(run_path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (::fstat(fd, &st) != 0) { int e = errno; ::close(fd); return -e; }
  uint64_t size = static_cast<uint64_t>(st.st_size);
  if (size % RECORD_SIZE != 0) { ::close(fd); return -EINVAL; }
  uint64_t n = size / RECORD_SIZE;
  if (n == 0) { ::close(fd); out2[0] = out2[1] = 0; return 0; }
  void* map = ::mmap(nullptr, size, PROT_READ, MAP_SHARED, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return -errno;
  const IbuRecord* recs = reinterpret_cast<const IbuRecord*>(map);
  auto less_key = [](const IbuRecord& a, const uint64_t* k) {
    return triple_less(a, k);
  };
  const IbuRecord* a =
      std::lower_bound(recs, recs + n, lo3, less_key);
  const IbuRecord* b =
      hi_unbounded ? recs + n : std::lower_bound(recs, recs + n, hi3, less_key);
  out2[0] = static_cast<uint64_t>(a - recs);
  out2[1] = static_cast<uint64_t>(b - recs);
  ::munmap(map, size);
  return out2[1] >= out2[0] ? 0 : -EINVAL;
}

}  // namespace

// Python-visible interval query (the counting pass for output offsets).
int ibu_run_interval(const char* run_path, const uint64_t* lo3,
                     const uint64_t* hi3, int hi_unbounded, uint64_t* out2) {
  return run_interval_bounds(run_path, lo3, hi3, hi_unbounded, out2);
}

// k-way merge of the [lo3, hi3) key interval of every sorted HEADERLESS
// run into out_path (which must already exist, pre-truncated) at
// out_byte_offset. Order within each run's interval is verified while
// merging (-EILSEQ on violation). The caller guarantees the destination
// byte range is exactly the summed interval sizes.
int ibu_merge_runs_interval(const char* const* run_paths, uint64_t n_runs,
                            const uint64_t* lo3, const uint64_t* hi3,
                            int hi_unbounded, const char* out_path,
                            uint64_t out_byte_offset) {
  std::vector<RunReader> runs(n_runs);
  int rc = 0;
  for (uint64_t r = 0; r < n_runs; ++r) {
    uint64_t bounds[2];
    rc = run_interval_bounds(run_paths[r], lo3, hi3, hi_unbounded, bounds);
    if (rc != 0) goto fail_open;
    runs[r].fd = ::open(run_paths[r], O_RDONLY);
    if (runs[r].fd < 0) { rc = -errno; goto fail_open; }
    if (::lseek(runs[r].fd, static_cast<off_t>(bounds[0] * RECORD_SIZE),
                SEEK_SET) < 0) {
      rc = -errno;
      goto fail_open;
    }
    runs[r].buf.resize(1 << 16);
    runs[r].remaining = bounds[1] - bounds[0];
    if (runs[r].refill() < 0) { rc = -EIO; goto fail_open; }
  }
  goto opened;
fail_open:
  for (auto& rr : runs) if (rr.fd >= 0) ::close(rr.fd);
  return rc;
opened:

  {
    int out_fd = ::open(out_path, O_WRONLY);
    if (out_fd < 0) {
      rc = -errno;
      for (auto& rr : runs) ::close(rr.fd);
      return rc;
    }
    using HeapItem = std::pair<IbuRecord, uint64_t>;
    auto heap_greater = [](const HeapItem& a, const HeapItem& b) {
      return record_less(b.first, a.first);
    };
    std::vector<HeapItem> heap;
    for (uint64_t r = 0; r < n_runs; ++r) {
      if (runs[r].len > 0) heap.push_back({runs[r].buf[0], r});
      runs[r].pos = 1;
    }
    std::make_heap(heap.begin(), heap.end(), heap_greater);

    uint64_t out_pos = out_byte_offset;
    std::vector<IbuRecord> out_buf;
    out_buf.reserve(1 << 16);
    auto flush = [&]() -> int {
      uint64_t bytes = out_buf.size() * sizeof(IbuRecord);
      uint64_t off = 0;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(out_buf.data());
      while (off < bytes) {
        ssize_t w = ::pwrite(out_fd, src + off, bytes - off,
                             static_cast<off_t>(out_pos + off));
        if (w < 0) return -errno;
        off += static_cast<uint64_t>(w);
      }
      out_pos += bytes;
      out_buf.clear();
      return 0;
    };

    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), heap_greater);
      HeapItem item = heap.back();
      heap.pop_back();
      out_buf.push_back(item.first);
      if (out_buf.size() == out_buf.capacity()) {
        if ((rc = flush()) != 0) goto done;
      }
      RunReader& rr = runs[item.second];
      if (rr.pos >= rr.len) {
        int st = rr.refill();
        if (st < 0) { rc = -EIO; goto done; }
        if (st == 0) continue;
      }
      if (record_less(rr.buf[rr.pos], item.first)) {
        rc = -EILSEQ;  // run not actually sorted
        goto done;
      }
      heap.push_back({rr.buf[rr.pos++], item.second});
      std::push_heap(heap.begin(), heap.end(), heap_greater);
    }
    if (!out_buf.empty()) rc = flush();
  done:
    if (::close(out_fd) != 0 && rc == 0) rc = -errno;
    for (auto& rr : runs) ::close(rr.fd);
    return rc;
  }
}

// Thread-parallel variant of ibu_merge_runs_interval: sampled
// SUB-splitters partition the caller's [lo, hi) key interval and each
// thread merges one sub-interval of every run straight to its byte
// offset. Byte-identical to the sequential merge (equal records are
// byte-identical under any valid splitter choice). expect_records
// (UINT64_MAX = skip) cross-checks the partition's total so a bug
// aborts instead of emitting silent corruption. Used by ibu_sort_file's
// phase 2 (whole key space) and by FASTQ ingest's merge of its spilled runs.
int ibu_merge_runs_interval_mt(const char* const* run_paths, uint64_t n_runs,
                               const uint64_t* lo3, const uint64_t* hi3,
                               int hi_unbounded, const char* out_path,
                               uint64_t out_byte_offset, int nthreads,
                               uint64_t expect_records) {
  if (nthreads <= 0) nthreads = std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min(nthreads, 64));

  // per-run sub-interval bounds (also the counting pass)
  std::vector<uint64_t> a(n_runs), b(n_runs);
  uint64_t total = 0;
  for (uint64_t r = 0; r < n_runs; ++r) {
    uint64_t b2[2];
    int rc = run_interval_bounds(run_paths[r], lo3, hi3, hi_unbounded, b2);
    if (rc != 0) return rc;
    a[r] = b2[0];
    b[r] = b2[1];
    total += b2[1] - b2[0];
  }
  if (expect_records != UINT64_MAX && total != expect_records) return -EIO;
  if (total < (1u << 20)) nthreads = 1;  // spawn cost dominates

  if (nthreads == 1) {
    return ibu_merge_runs_interval(run_paths, n_runs, lo3, hi3,
                                   hi_unbounded, out_path, out_byte_offset);
  }

  // sub-splitters: S evenly-spaced samples per run's sub-interval
  const uint64_t S = 128;
  std::vector<IbuRecord> samples;
  for (uint64_t r = 0; r < n_runs; ++r) {
    uint64_t len = b[r] - a[r];
    if (len == 0) continue;
    int fd = ::open(run_paths[r], O_RDONLY);
    if (fd < 0) return -errno;
    for (uint64_t k = 0; k < S; ++k) {
      uint64_t at = a[r] + ((2 * k + 1) * len) / (2 * S);
      if (at >= b[r]) at = b[r] - 1;
      IbuRecord rec;
      if (::pread(fd, &rec, sizeof(rec),
                  static_cast<off_t>(at * RECORD_SIZE)) !=
          static_cast<ssize_t>(sizeof(rec))) {
        ::close(fd);
        return -EIO;
      }
      samples.push_back(rec);
    }
    ::close(fd);
  }
  if (samples.empty()) return 0;  // empty interval: nothing to write
  std::sort(samples.begin(), samples.end(), record_less);
  std::vector<IbuRecord> splitters;
  for (int t = 1; t < nthreads; ++t)
    splitters.push_back(samples[(t * samples.size()) / nthreads]);

  auto bounds_of = [&](int t, uint64_t* lo, uint64_t* hi, int* unb) {
    if (t == 0) {
      lo[0] = lo3[0]; lo[1] = lo3[1]; lo[2] = lo3[2];
    } else {
      lo[0] = splitters[t - 1].barcode;
      lo[1] = splitters[t - 1].umi;
      lo[2] = splitters[t - 1].index;
    }
    if (t == nthreads - 1) {
      *unb = hi_unbounded;
      hi[0] = hi3[0]; hi[1] = hi3[1]; hi[2] = hi3[2];
    } else {
      *unb = 0;
      hi[0] = splitters[t].barcode;
      hi[1] = splitters[t].umi;
      hi[2] = splitters[t].index;
    }
  };

  // per-thread counts → offsets (+ the same total cross-check)
  std::vector<uint64_t> counts(nthreads, 0);
  for (int t = 0; t < nthreads; ++t) {
    uint64_t lo[3], hi[3];
    int unb;
    bounds_of(t, lo, hi, &unb);
    for (uint64_t r = 0; r < n_runs; ++r) {
      uint64_t b2[2];
      int rc = run_interval_bounds(run_paths[r], lo, hi, unb, b2);
      if (rc != 0) return rc;
      counts[t] += b2[1] - b2[0];
    }
  }
  uint64_t check = 0;
  for (auto c : counts) check += c;
  if (check != total) return -EIO;

  std::atomic<int> merge_fail(0);
  std::vector<std::thread> mergers;
  uint64_t off = out_byte_offset;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t my_off = off;
    off += counts[t] * RECORD_SIZE;
    mergers.emplace_back([&, t, my_off]() {
      uint64_t lo[3], hi[3];
      int unb;
      bounds_of(t, lo, hi, &unb);
      int rc = ibu_merge_runs_interval(run_paths, n_runs, lo, hi, unb,
                                       out_path, my_off);
      if (rc != 0) merge_fail.store(-rc);
    });
  }
  for (auto& th : mergers) th.join();
  return -merge_fail.load();
}

// k-way merge of ALREADY-SORTED IBU files into one sorted file.
// The output header is the first input's header with the sorted bit set
// (the Python binding validates header compatibility before calling).
// Per-run order is verified while merging: an input that is not actually
// sorted returns -EILSEQ instead of emitting a mis-sorted "sorted" file.
int ibu_merge_files(const char* const* in_paths, uint64_t n_inputs,
                    const char* out_path) {
  if (n_inputs == 0) return -EINVAL;
  std::vector<RunReader> runs(n_inputs);
  uint8_t header[32];
  int rc = 0;
  for (uint64_t r = 0; r < n_inputs; ++r) {
    runs[r].fd = ::open(in_paths[r], O_RDONLY);
    if (runs[r].fd < 0) { rc = -errno; goto fail_open; }
    struct stat st;
    if (::fstat(runs[r].fd, &st) != 0) { rc = -errno; goto fail_open; }
    uint64_t size = static_cast<uint64_t>(st.st_size);
    if (size < 32 || (size - 32) % RECORD_SIZE != 0) {
      rc = -EINVAL;
      goto fail_open;
    }
    uint8_t h[32];
    if (::read(runs[r].fd, h, 32) != 32) { rc = -EIO; goto fail_open; }
    if (r == 0) std::memcpy(header, h, 32);
    runs[r].buf.resize(1 << 16);
    runs[r].remaining = (size - 32) / RECORD_SIZE;
    if (runs[r].refill() < 0) { rc = -EIO; goto fail_open; }
  }
  goto opened;
fail_open:
  for (auto& rr : runs) if (rr.fd >= 0) ::close(rr.fd);
  return rc;
opened:

  {
    int out_fd = ::open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (out_fd < 0) {
      rc = -errno;
      for (auto& rr : runs) ::close(rr.fd);
      return rc;
    }
    header[16] |= 1;  // sorted flag, bit 0 of the u64 at offset 16
    if (::write(out_fd, header, 32) != 32) {
      ::close(out_fd);
      ::unlink(out_path);  // no 32-byte stub on failure
      for (auto& rr : runs) ::close(rr.fd);
      return -EIO;
    }

    using HeapItem = std::pair<IbuRecord, uint64_t>;
    auto heap_greater = [](const HeapItem& a, const HeapItem& b) {
      return record_less(b.first, a.first);
    };
    std::vector<HeapItem> heap;
    for (uint64_t r = 0; r < n_inputs; ++r) {
      if (runs[r].len > 0) heap.push_back({runs[r].buf[0], r});
      runs[r].pos = 1;
    }
    std::make_heap(heap.begin(), heap.end(), heap_greater);

    std::vector<IbuRecord> out_buf;
    out_buf.reserve(1 << 16);
    auto flush = [&]() -> int {
      uint64_t bytes = out_buf.size() * sizeof(IbuRecord);
      uint64_t off = 0;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(out_buf.data());
      while (off < bytes) {
        ssize_t w = ::write(out_fd, src + off, bytes - off);
        if (w < 0) return -errno;
        off += static_cast<uint64_t>(w);
      }
      out_buf.clear();
      return 0;
    };

    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), heap_greater);
      HeapItem item = heap.back();
      heap.pop_back();
      out_buf.push_back(item.first);
      if (out_buf.size() == out_buf.capacity()) {
        if ((rc = flush()) != 0) goto done;
      }
      RunReader& rr = runs[item.second];
      if (rr.pos >= rr.len) {
        int st = rr.refill();  // resets pos to 0 on success
        if (st < 0) { rc = -EIO; goto done; }
        if (st == 0) continue;  // input cleanly exhausted
      }
      // sortedness check: the successor within a run must not sort
      // before the record just emitted from that run
      if (record_less(rr.buf[rr.pos], item.first)) {
        rc = -EILSEQ;
        goto done;
      }
      heap.push_back({rr.buf[rr.pos++], item.second});
      std::push_heap(heap.begin(), heap.end(), heap_greater);
    }
    if (!out_buf.empty()) rc = flush();
  done:
    // deferred write errors (NFS, quota) surface at close; a failed close
    // must not report a truncated file as a successful sorted merge
    if (::close(out_fd) != 0 && rc == 0) rc = -errno;
    for (auto& rr : runs) ::close(rr.fd);
    if (rc != 0) ::unlink(out_path);
    return rc;
  }
}

}  // extern "C"
