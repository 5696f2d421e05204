// Kernel D of the PHOLD window step (the split `kernel="pallas"` path): the
// per-destination-row append of routed arrivals into the ingress rings,
// for Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_route.py, _route_kernel (the Pallas TPU
// kernel behind route_scatter).
//
// For destination row r of a [N, CI] ring, with nv = nv[r], lo = lo[r] and
// take = take[r]: slot c in [nv, nv + take) takes the arrival-sorted stream
// item at lo + CI + c (the streams are padded by CI on both sides) in five
// payload columns and becomes valid; every other slot keeps its base
// values. That is kernel B's function (route_place.cu), taken a row at a
// time as the TPU kernel takes it. For the routing stage's inputs the index
// of a placed slot lies in the bucket's own segment, [lo + CI + nv,
// lo + CI + nv + take); it is clipped into the stream all the same, as
// kernel B clips it, so that no input can read past the stream.
//
// What bounds it on the card: memory bytes, as for kernel B. Each slot
// reads 5 int32 words (from the stream when placed, else from its bases,
// plus the base valid byte) and writes 5 int32 words and a valid byte,
// plus 12 B a row; at N=32768, CI=32 that is about 44 MB, some 13 us at
// 3.35 TB/s. The design is one warp per destination row, looping over the
// row in chunks of 32 slots: lane 0 loads the row's nv/lo/take once and a
// shuffle broadcasts them (kernel B reads them in every slot's thread);
// the base reads and all writes of a chunk are consecutive across the
// warp, and the placed lanes of a chunk read one contiguous run of the
// stream. Only placed lanes touch the stream; the TPU kernel's windowed
// load reads it for every lane, which the CUDA kernel must not.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRowsPerBlock = kBlock / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kBlock) route_scatter_kernel(
    int n_rows, int ci, int64_t b2, const int* __restrict__ nv,
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
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  int n0 = 0, l0 = 0, t0 = 0;
  if (lane == 0) {
    n0 = nv[row];
    l0 = lo[row];
    t0 = take[row];
  }
  n0 = __shfl_sync(kFull, n0, 0);
  l0 = __shfl_sync(kFull, l0, 0);
  t0 = __shfl_sync(kFull, t0, 0);
  const int64_t first = n0;
  const int64_t end = first + t0;
  const int64_t start = static_cast<int64_t>(l0) + ci;  // into the padded stream
  for (int c = lane; c < ci; c += 32) {
    const int64_t e = row * ci + c;
    if (c >= first && c < end) {
      int64_t idx = start + c;
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
}

}  // namespace

// nv, lo, take: [n_rows] int32. Streams s_*: [b2] int32. Bases b_src,
// b_seq, b_sock, b_bytes, b_del: [n_rows, ci] int32, b_valid [n_rows, ci]
// bool. Outputs o_* likewise. Returns the launch's cudaError_t.
extern "C" int route_scatter_launch(
    int n_rows, int ci, long long b2, const void* nv, const void* lo,
    const void* take, const void* s_src, const void* s_seq, const void* s_sock,
    const void* s_bytes, const void* s_del, const void* b_src,
    const void* b_seq, const void* b_sock, const void* b_bytes,
    const void* b_del, const void* b_valid, void* o_src, void* o_seq,
    void* o_sock, void* o_bytes, void* o_del, void* o_valid,
    void* stream_ptr) {
  if (n_rows <= 0 || ci <= 0) return static_cast<int>(cudaSuccess);
  if (b2 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (static_cast<int64_t>(n_rows) + kRowsPerBlock - 1) /
                         kRowsPerBlock;
  route_scatter_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                         static_cast<cudaStream_t>(stream_ptr)>>>(
      n_rows, ci, static_cast<int64_t>(b2), static_cast<const int*>(nv),
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
