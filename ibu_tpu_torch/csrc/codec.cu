// Fused 2-bit record codec for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (see ibu_tpu_torch/ops/_build.py and
// ibu_tpu_torch/ops/codec_cuda.py).
//
// encode_records_kernel replaces the Pallas kernel
//   ibu_tpu/ops/codec_pallas.py::encode_records (_encode_records_kernel)
// decode_records_kernel replaces
//   ibu_tpu/ops/codec_pallas.py::decode_records (_decode_records_kernel)
// encode_planes_kernel replaces
//   ibu_tpu/ops/codec_pallas.py::encode_planes (_encode_kernel)
// decode_planes_kernel replaces
//   ibu_tpu/ops/codec_pallas.py::decode_planes (_decode_kernel)
//
// Layout: ASCII rows are row-major (N, L) uint8, as on the host; records are
// the wire layout (N, 3) int64 [barcode, umi, index], a zero-copy view of the
// 24-byte IBU records. Base i of a field sits at bits 2i of its u64 word
// (A=00, C=01, G=10, T=11); the codec is total, so any byte maps to a code
// (validation happens on the host, before the kernel). The fused kernels XOR
// the index with a 32-bit salt repeated in both halves of the u64, exactly the
// Pallas kernels' per-half XOR of the lo/hi index words; salt 0 is the
// identity.
//
// What bounds them on an H100: device-memory bytes. A bc16/umi12 record moves
// 60 B each way (36 B of ASCII + index in, 24 B of record out, or the reverse)
// against a handful of integer operations per byte, far below the card's
// compute-to-bandwidth ratio. The design therefore touches every byte once:
// one thread per record with a grid-stride loop and 64-bit offsets (N * L
// passes 2^31 at 100M records of 32 bases), the field packed by shift-or in
// registers (no TPU matmul pack, no lane padding), and rows read and written
// as 4-byte words whenever the row length and base pointer allow it, so a warp
// covers a few contiguous sectors per access and L1 merges the rest. Wider
// 16-byte loads and a warp-cooperative row layout are later work.
//
// The single-field kernels are the same loop over one field: L + 8 bytes per
// record (L bytes of ASCII, one 8-byte word), bound by device memory in the
// same way. The Pallas encode packs through an f32 matmul on the TPU's matrix
// unit; here the pack is the shift-or of pack_row, and decode is unpack_row's
// byte-table select.
//
// Both kernels launch on the caller's stream, allocate nothing and never
// synchronise; each C entry point returns cudaGetLastError().
//
// The per-record device code (base_code, code_ascii, word_rows, pack_row,
// unpack_row) lives in codec_device.cuh, which the codec labs
// (codec_lab.cu) include too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec_device.cuh"

namespace {

using namespace ibu;

constexpr int kBlock = 256;
constexpr int64_t kMaxGrid = int64_t(1) << 20;

__global__ void encode_records_kernel(const uint8_t* __restrict__ bc,
                                      const uint8_t* __restrict__ umi,
                                      const int64_t* __restrict__ index,
                                      int64_t* __restrict__ out, int64_t n,
                                      int bc_len, int umi_len, uint64_t salt) {
  const bool bc_words = word_rows(bc, bc_len);
  const bool umi_words = word_rows(umi, umi_len);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    uint64_t b = pack_row(bc + r * bc_len, bc_len, bc_words);
    uint64_t u = pack_row(umi + r * umi_len, umi_len, umi_words);
    out[3 * r] = int64_t(b);
    out[3 * r + 1] = int64_t(u);
    out[3 * r + 2] = int64_t(uint64_t(index[r]) ^ salt);
  }
}

__global__ void decode_records_kernel(const int64_t* __restrict__ records,
                                      uint8_t* __restrict__ bc,
                                      uint8_t* __restrict__ umi,
                                      int64_t* __restrict__ index, int64_t n,
                                      int bc_len, int umi_len, uint64_t salt) {
  const bool bc_words = word_rows(bc, bc_len);
  const bool umi_words = word_rows(umi, umi_len);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    uint64_t b = uint64_t(records[3 * r]);
    uint64_t u = uint64_t(records[3 * r + 1]);
    index[r] = int64_t(uint64_t(records[3 * r + 2]) ^ salt);
    unpack_row(b, bc + r * bc_len, bc_len, bc_words);
    unpack_row(u, umi + r * umi_len, umi_len, umi_words);
  }
}

__global__ void encode_planes_kernel(const uint8_t* __restrict__ rows,
                                     int64_t* __restrict__ out, int64_t n,
                                     int len) {
  const bool words = word_rows(rows, len);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    out[r] = int64_t(pack_row(rows + r * len, len, words));
  }
}

__global__ void decode_planes_kernel(const int64_t* __restrict__ in,
                                     uint8_t* __restrict__ rows, int64_t n,
                                     int len) {
  const bool words = word_rows(rows, len);
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t r = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    unpack_row(uint64_t(in[r]), rows + r * len, len, words);
  }
}

// The salt as the u64 the index is XORed with: the u32 in both halves.
uint64_t salt_word(uint32_t salt) {
  return uint64_t(salt) | (uint64_t(salt) << 32);
}

unsigned int grid_for(int64_t n) {
  int64_t blocks = (n + kBlock - 1) / kBlock;
  return unsigned(blocks < kMaxGrid ? blocks : kMaxGrid);
}

}  // namespace

extern "C" int ibu_encode_records(const void* bc, const void* umi,
                                  const void* index, void* out, int64_t n,
                                  int bc_len, int umi_len, uint32_t salt,
                                  void* stream) {
  encode_records_kernel<<<grid_for(n), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bc), static_cast<const uint8_t*>(umi),
      static_cast<const int64_t*>(index), static_cast<int64_t*>(out), n,
      bc_len, umi_len, salt_word(salt));
  return int(cudaGetLastError());
}

extern "C" int ibu_decode_records(const void* records, void* bc, void* umi,
                                  void* index, int64_t n, int bc_len,
                                  int umi_len, uint32_t salt, void* stream) {
  decode_records_kernel<<<grid_for(n), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(records), static_cast<uint8_t*>(bc),
      static_cast<uint8_t*>(umi), static_cast<int64_t*>(index), n, bc_len,
      umi_len, salt_word(salt));
  return int(cudaGetLastError());
}

extern "C" int ibu_encode_planes(const void* rows, void* out, int64_t n,
                                 int len, void* stream) {
  encode_planes_kernel<<<grid_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<int64_t*>(out), n, len);
  return int(cudaGetLastError());
}

extern "C" int ibu_decode_planes(const void* words, void* rows, int64_t n,
                                 int len, void* stream) {
  decode_planes_kernel<<<grid_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), static_cast<uint8_t*>(rows), n, len);
  return int(cudaGetLastError());
}

extern "C" const char* ibu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
