// Device code of the egress-stage kernels: kernel A's (egress_rank.cu)
// per-row ascending bitonic sort of (key, column) pairs in its three forms
// (a warp segment, a block in shared memory, a block over device memory)
// and the token gate's prefix sum, and the clock rebase and FIFO key that
// kernel C (egress_gate.cu) shares with it.
//
// The (key, column) pairs of a row are distinct, so each network's output
// is the stable sort by key, which is what the TPU kernels' whole-tile
// bitonic over (key, column) gives. Arithmetic that may wrap (rebase,
// prefix sum, row sum) is done in uint32, which wraps as the TPU kernels'
// int32 does.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace row_bitonic {

constexpr uint32_t kSign = 0x80000000u;
constexpr int kNoClamp = -(1 << 30);
constexpr unsigned kFull = 0xffffffffu;
// threads a block of the warp-segment path (CE <= 32)
constexpr int kWarpBlock = 256;

__device__ __forceinline__ bool pair_less(uint32_t ka, int ia, uint32_t kb,
                                          int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// The rebased send time and clamp of one slot: invalid send times become
// 0, NO_CLAMP stays, every other valid clamp moves by `shift`.
__device__ __forceinline__ int rebase_tsend(bool v, int ts, int shift) {
  return v ? wrap_sub(ts, shift) : 0;
}
__device__ __forceinline__ int rebase_clamp(bool v, int cl, int shift) {
  return (v && cl != kNoClamp) ? wrap_sub(cl, shift) : cl;
}

// The FIFO key: validity in bit 31 (invalid last), priority below.
__device__ __forceinline__ uint32_t fifo_key(bool v, int prio) {
  return (v ? 0u : kSign) | static_cast<uint32_t>(prio);
}

// Ascending bitonic sort of (k, i) over the CE lanes of a warp segment;
// lane c of the segment holds element c. Every lane of the warp takes
// part (full masks).
template <int CE>
__device__ __forceinline__ void warp_bitonic(uint32_t& k, int& i, int c) {
#pragma unroll
  for (int size = 2; size <= CE; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const uint32_t pk = __shfl_xor_sync(kFull, k, stride);
      const int pi = __shfl_xor_sync(kFull, i, stride);
      // the lower element of a pair keeps the min in an ascending block
      const bool take_min = ((c & stride) == 0) == ((c & size) == 0);
      const bool keep = pair_less(k, i, pk, pi) == take_min;
      if (!keep) {
        k = pk;
        i = pi;
      }
    }
  }
}

// Inclusive prefix sum over the CE lanes of a warp segment.
template <int CE>
__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t x, int c) {
#pragma unroll
  for (int d = 1; d < CE; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, x, d, CE);
    if (c >= d) x += up;
  }
  return x;
}

// Sum over the CE lanes of a warp segment, in every lane.
template <int CE>
__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int d = CE >> 1; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// Ascending bitonic sort of (sk, si) over n elements in shared memory, one
// thread per element; ends synchronised.
__device__ inline void block_bitonic(uint32_t* sk, int* si, int n, int c) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int q = c ^ stride;
      if (q > c) {
        const uint32_t ka = sk[c], kb = sk[q];
        const int ia = si[c], ib = si[q];
        const bool up = (c & size) == 0;
        if (up != pair_less(ka, ia, kb, ib)) {
          sk[c] = kb;
          sk[q] = ka;
          si[c] = ib;
          si[q] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// Hillis-Steele inclusive scan of x over the n threads of a block, through
// the n words at `buf`; returns this thread's prefix, ends synchronised.
__device__ inline uint32_t block_inclusive_scan(uint32_t* buf, uint32_t x,
                                                int n, int c) {
  buf[c] = x;
  __syncthreads();
  for (int d = 1; d < n; d <<= 1) {
    const uint32_t up = c >= d ? buf[c - d] : 0u;
    __syncthreads();
    buf[c] += up;
    __syncthreads();
  }
  const uint32_t out = buf[c];
  __syncthreads();
  return out;
}

// --- the wide build (CE > 1024): one block of kWideBlock threads a row, the
// row in device memory.

constexpr int kWideBlock = 1024;

// Ascending bitonic sort of a row's columns 0..n-1 by (key(i), i) into
// `idx` (n words of device memory, one row of an output column): the
// network moves the column indices only and reads each one's key through
// `key` (from the inputs, or from an output column written before the
// call). Each thread takes n / (2 * kWideBlock) compare-exchanges a stage,
// with a block barrier a stage; n is a power of two >= 2 * kWideBlock.
// Starts with a barrier (the caller's last reads of `idx` and its writes
// to what `key` reads are done) and ends synchronised.
template <class Key>
__device__ __forceinline__ void wide_bitonic(int* idx, int n, Key key) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kWideBlock) idx[i] = i;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += kWideBlock) {
        // the pair (a, a + stride): a has bit `stride` clear
        const int a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
        const int b = a + stride;
        const int ia = idx[a], ib = idx[b];
        const bool up = (a & size) == 0;
        if (up != pair_less(key(ia), ia, key(ib), ib)) {
          idx[a] = ib;
          idx[b] = ia;
        }
      }
      __syncthreads();
    }
  }
}

// The row's prefix before this thread's run of slots: x is the sum of
// the thread's own run (thread t owns slots [t * n / kWideBlock, (t + 1) *
// n / kWideBlock)); returns the sum over the earlier threads' runs, in
// uint32. `buf` is kWideBlock words of shared memory. Ends synchronised.
__device__ __forceinline__ uint32_t wide_exclusive_prefix(uint32_t* buf,
                                                          uint32_t x) {
  return block_inclusive_scan(buf, x, kWideBlock, threadIdx.x) - x;
}

// The token gate over this thread's run of a sorted row, slots [c0, c0 +
// run) of the row's valid_o and bytes_o (written by this thread), `total`
// the run's valid bytes: the row's inclusive prefix of valid bytes against
// `bal` gives sendable_o, and the run's sendable bytes are added to
// *spent_acc (shared memory, zeroed before a barrier the call follows).
// `buf` is kWideBlock words of shared memory. Read *spent_acc only after
// a barrier.
__device__ __forceinline__ void wide_token_gate(
    const uint8_t* valid_o, const int* bytes_o, uint8_t* sendable_o, int c0,
    int run, uint32_t total, int bal, uint32_t* buf, uint32_t* spent_acc) {
  uint32_t cum = wide_exclusive_prefix(buf, total);
  uint32_t spent = 0;
  for (int c = c0; c < c0 + run; ++c) {
    const bool v_s = valid_o[c] != 0;
    const uint32_t b = static_cast<uint32_t>(bytes_o[c]);
    if (v_s) cum += b;
    const bool sendable = v_s && static_cast<int>(cum) <= bal;
    sendable_o[c] = static_cast<uint8_t>(sendable);
    if (sendable) spent += b;
  }
  atomicAdd(spent_acc, spent);
}

}  // namespace row_bitonic
