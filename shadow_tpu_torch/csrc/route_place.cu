// Kernel B of the PHOLD window step: the bucketed placement of routed
// arrivals into the destination ingress rings, for Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_pipeline.py, _place_kernel (the Pallas
// TPU kernel behind route_place).
//
// For destination row r and slot c of a [N, CI] ring, with nv = nv[r],
// lo = lo[r] and take = take[r]: a slot in [nv, nv + take) takes the
// arrival-sorted stream item at clip(lo + c + CI, 0, B2 - 1) (the streams
// are padded by CI on both sides) in five payload columns and becomes
// valid; every other slot keeps its base values.
//
// What bounds it on the card: memory bytes. It is a masked gather with no
// arithmetic to speak of: each slot reads 5 int32 words (from the stream
// when placed, else from its bases, plus the base valid byte) and writes 5
// int32 words and a valid byte, plus 12 B a row; at N=32768, CI=32 that is
// about 44 MB, some 13 us at 3.35 TB/s. The design is one thread per
// output slot, so the base reads and all writes are consecutive across a
// warp, and a thread reads either its stream item or its bases, never
// both. The stream reads of one row are consecutive too (slot c reads item
// lo + c + CI), so placed slots gather in short contiguous runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock) route_place_kernel(
    int64_t total, int ci, int64_t b2, const int* __restrict__ nv,
    const int* __restrict__ lo, const int* __restrict__ take,
    const int* __restrict__ s_src, const int* __restrict__ s_seq,
    const int* __restrict__ s_sock, const int* __restrict__ s_bytes,
    const int* __restrict__ s_del, const int* __restrict__ b_src,
    const int* __restrict__ b_seq, const int* __restrict__ b_sock,
    const int* __restrict__ b_bytes, const int* __restrict__ b_del,
    const uint8_t* __restrict__ b_valid, int* __restrict__ o_src,
    int* __restrict__ o_seq, int* __restrict__ o_sock,
    int* __restrict__ o_bytes, int* __restrict__ o_del,
    uint8_t* __restrict__ o_valid) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (e >= total) return;
  const int64_t row = e / ci;
  const int c = static_cast<int>(e - row * ci);
  const int n0 = nv[row];
  if (c >= n0 && c < n0 + take[row]) {
    int64_t idx = static_cast<int64_t>(lo[row]) + c + ci;
    idx = idx < 0 ? 0 : (idx > b2 - 1 ? b2 - 1 : idx);
    o_src[e] = s_src[idx];
    o_seq[e] = s_seq[idx];
    o_sock[e] = s_sock[idx];
    o_bytes[e] = s_bytes[idx];
    o_del[e] = s_del[idx];
    o_valid[e] = 1;
  } else {
    o_src[e] = b_src[e];
    o_seq[e] = b_seq[e];
    o_sock[e] = b_sock[e];
    o_bytes[e] = b_bytes[e];
    o_del[e] = b_del[e];
    o_valid[e] = b_valid[e] != 0;
  }
}

}  // namespace

// nv, lo, take: [n_rows] int32. Streams s_*: [b2] int32. Bases b_src,
// b_seq, b_sock, b_bytes, b_del: [n_rows, ci] int32, b_valid [n_rows, ci]
// bool. Outputs o_* likewise. Returns the launch's cudaError_t.
extern "C" int route_place_launch(
    int n_rows, int ci, long long b2, const void* nv, const void* lo,
    const void* take, const void* s_src, const void* s_seq, const void* s_sock,
    const void* s_bytes, const void* s_del, const void* b_src,
    const void* b_seq, const void* b_sock, const void* b_bytes,
    const void* b_del, const void* b_valid, void* o_src, void* o_seq,
    void* o_sock, void* o_bytes, void* o_del, void* o_valid,
    void* stream_ptr) {
  const int64_t total = static_cast<int64_t>(n_rows) * ci;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  if (b2 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (total + kBlock - 1) / kBlock;
  route_place_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      total, ci, static_cast<int64_t>(b2), static_cast<const int*>(nv),
      static_cast<const int*>(lo), static_cast<const int*>(take),
      static_cast<const int*>(s_src), static_cast<const int*>(s_seq),
      static_cast<const int*>(s_sock), static_cast<const int*>(s_bytes),
      static_cast<const int*>(s_del), static_cast<const int*>(b_src),
      static_cast<const int*>(b_seq), static_cast<const int*>(b_sock),
      static_cast<const int*>(b_bytes), static_cast<const int*>(b_del),
      static_cast<const uint8_t*>(b_valid), static_cast<int*>(o_src),
      static_cast<int*>(o_seq), static_cast<int*>(o_sock),
      static_cast<int*>(o_bytes), static_cast<int*>(o_del),
      static_cast<uint8_t*>(o_valid));
  return static_cast<int>(cudaGetLastError());
}
