// Kernel C of the PHOLD window step (the split `kernel="pallas"` path):
// the FIFO order and token gate of every host row, for Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_egress.py, _egress_kernel (the Pallas
// TPU kernel behind egress_order_gate).
//
// Per host row of CE egress slots it computes, bitwise as the TPU kernel:
//   - the clock rebase of tsend/clamp by `shift` (NO_CLAMP kept, invalid
//     tsend -> 0);
//   - the FIFO order: an ascending bitonic sort of the (key, column) pairs,
//     key = (invalid << 31) | prio as uint32, returned as `perm`; the
//     bytes, rebased tsend and rebased clamp columns in that order, and the
//     validity read back from the sorted key's top bit;
//   - the inclusive prefix sum of the valid bytes, sendable = valid &&
//     cum <= balance, and the row's spent bytes.
// Unlike kernel A it permutes no other column and returns no row_perm: the
// caller gathers prio/sock/dst/seq/ctrl through `perm`.
//
// What bounds it on the card: memory bytes. Each slot reads 4 int32 and 1
// bool column and writes 4 int32 and 2 bool columns (35 B), plus 8 B a row;
// at N=32768, CE=16 that is 18.6 MB, about 5.6 us at 3.35 TB/s, against
// about 70 integer operations and 30 shuffles a slot. The design is kernel
// A's (row_bitonic.cuh): for CE <= 32 each row lives in CE lanes of one warp
// (32/CE rows a warp, one column a lane), the sort exchanges through
// __shfl_xor_sync, the payload permutation is one __shfl_sync per carried
// column instead of the TPU's carried swaps, and the scan and the row sum
// are warp shuffles; loads and stores of a column are consecutive across
// lanes. For 64 <= CE <= 1024 one block holds one row in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_bitonic.cuh"

namespace {

using namespace row_bitonic;

template <int CE>
__global__ void __launch_bounds__(kWarpBlock) egress_gate_warp(
    int n_rows, int shift, const uint8_t* __restrict__ valid,
    const int* __restrict__ prio, const int* __restrict__ nbytes,
    const int* __restrict__ tsend, const int* __restrict__ clamp,
    const int* __restrict__ balance, int* __restrict__ perm_o,
    int* __restrict__ bytes_o, int* __restrict__ tsend_o,
    int* __restrict__ clamp_o, uint8_t* __restrict__ valid_o,
    uint8_t* __restrict__ sendable_o, int* __restrict__ spent_o) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpBlock + threadIdx.x;
  const int64_t row = e / CE;
  const int c = threadIdx.x & (CE - 1);
  // rows past the end still run the shuffles (full warp masks) on dummy
  // values and write nothing; a row is never split across that edge
  const bool live = row < n_rows;
  const int64_t x = live ? e : 0;

  const bool v = valid[x] != 0;
  const int ts = rebase_tsend(v, tsend[x], shift);
  const int cl = rebase_clamp(v, clamp[x], shift);
  uint32_t k = fifo_key(v, prio[x]);
  int src = c;
  warp_bitonic<CE>(k, src, c);
  const bool v_s = (k & kSign) == 0;

  // lane c takes the carried columns of lane src
  const int bytes_s = __shfl_sync(kFull, nbytes[x], src, CE);
  const int ts_s = __shfl_sync(kFull, ts, src, CE);
  const int cl_s = __shfl_sync(kFull, cl, src, CE);

  const uint32_t cum = warp_inclusive_scan<CE>(
      v_s ? static_cast<uint32_t>(bytes_s) : 0u, c);
  const int bal = balance[live ? row : 0];
  const bool sendable = v_s && static_cast<int>(cum) <= bal;
  const uint32_t spent =
      warp_sum<CE>(sendable ? static_cast<uint32_t>(bytes_s) : 0u);

  if (!live) return;
  perm_o[e] = src;
  bytes_o[e] = bytes_s;
  tsend_o[e] = ts_s;
  clamp_o[e] = cl_s;
  valid_o[e] = static_cast<uint8_t>(v_s);
  sendable_o[e] = static_cast<uint8_t>(sendable);
  if (c == 0) spent_o[row] = static_cast<int>(spent);
}

// One block of CE threads per row, 64 <= CE <= 1024. Dynamic shared memory:
// keys, indices and the 3 carried columns, CE words each.
__global__ void egress_gate_block(
    int ce, int shift, const uint8_t* __restrict__ valid,
    const int* __restrict__ prio, const int* __restrict__ nbytes,
    const int* __restrict__ tsend, const int* __restrict__ clamp,
    const int* __restrict__ balance, int* __restrict__ perm_o,
    int* __restrict__ bytes_o, int* __restrict__ tsend_o,
    int* __restrict__ clamp_o, uint8_t* __restrict__ valid_o,
    uint8_t* __restrict__ sendable_o, int* __restrict__ spent_o) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t spent_acc;
  uint32_t* sk = smem;
  int* si = reinterpret_cast<int*>(smem + ce);
  int* pay = reinterpret_cast<int*>(smem + 2 * ce);
  const int c = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t e = row * ce + c;

  const bool v = valid[e] != 0;
  pay[0 * ce + c] = nbytes[e];
  pay[1 * ce + c] = rebase_tsend(v, tsend[e], shift);
  pay[2 * ce + c] = rebase_clamp(v, clamp[e], shift);
  sk[c] = fifo_key(v, prio[e]);
  si[c] = c;
  if (c == 0) spent_acc = 0u;
  __syncthreads();
  block_bitonic(sk, si, ce, c);

  const bool v_s = (sk[c] & kSign) == 0;
  const int src = si[c];
  const int bytes_s = pay[0 * ce + src];
  const int ts_s = pay[1 * ce + src];
  const int cl_s = pay[2 * ce + src];
  __syncthreads();

  // inclusive scan of the valid bytes, through sk
  const uint32_t cum = block_inclusive_scan(
      sk, v_s ? static_cast<uint32_t>(bytes_s) : 0u, ce, c);
  const bool sendable = v_s && static_cast<int>(cum) <= balance[row];
  if (sendable) atomicAdd(&spent_acc, static_cast<uint32_t>(bytes_s));
  __syncthreads();

  perm_o[e] = src;
  bytes_o[e] = bytes_s;
  tsend_o[e] = ts_s;
  clamp_o[e] = cl_s;
  valid_o[e] = static_cast<uint8_t>(v_s);
  sendable_o[e] = static_cast<uint8_t>(sendable);
  if (c == 0) spent_o[row] = static_cast<int>(spent_acc);
}

template <int CE>
cudaError_t launch_warp(int n_rows, int shift, const void* const* in,
                        void* const* out, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n_rows) * CE;
  const int64_t blocks = (total + kWarpBlock - 1) / kWarpBlock;
  egress_gate_warp<CE><<<static_cast<unsigned>(blocks), kWarpBlock, 0, stream>>>(
      n_rows, shift, static_cast<const uint8_t*>(in[0]),
      static_cast<const int*>(in[1]), static_cast<const int*>(in[2]),
      static_cast<const int*>(in[3]), static_cast<const int*>(in[4]),
      static_cast<const int*>(in[5]), static_cast<int*>(out[0]),
      static_cast<int*>(out[1]), static_cast<int*>(out[2]),
      static_cast<int*>(out[3]), static_cast<uint8_t*>(out[4]),
      static_cast<uint8_t*>(out[5]), static_cast<int*>(out[6]));
  return cudaGetLastError();
}

cudaError_t launch_block(int n_rows, int ce, int shift, const void* const* in,
                         void* const* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(5) * ce * sizeof(uint32_t);
  egress_gate_block<<<n_rows, ce, smem, stream>>>(
      ce, shift, static_cast<const uint8_t*>(in[0]),
      static_cast<const int*>(in[1]), static_cast<const int*>(in[2]),
      static_cast<const int*>(in[3]), static_cast<const int*>(in[4]),
      static_cast<const int*>(in[5]), static_cast<int*>(out[0]),
      static_cast<int*>(out[1]), static_cast<int*>(out[2]),
      static_cast<int*>(out[3]), static_cast<uint8_t*>(out[4]),
      static_cast<uint8_t*>(out[5]), static_cast<int*>(out[6]));
  return cudaGetLastError();
}

}  // namespace

// Inputs: valid (bool), prio, bytes, tsend, clamp (int32), all [n_rows, ce]
// row-major; balance [n_rows] int32. Outputs: perm, bytes, tsend, clamp
// (int32), valid, sendable (bool), all [n_rows, ce]; spent [n_rows] int32.
// ce is a power of two in [2, 1024]. Returns the launch's cudaError_t.
extern "C" int egress_gate_launch(
    int n_rows, int ce, int shift, const void* valid, const void* prio,
    const void* nbytes, const void* tsend, const void* clamp,
    const void* balance, void* perm_o, void* bytes_o, void* tsend_o,
    void* clamp_o, void* valid_o, void* sendable_o, void* spent_o,
    void* stream_ptr) {
  const void* in[6] = {valid, prio, nbytes, tsend, clamp, balance};
  void* out[7] = {perm_o,  bytes_o,    tsend_o, clamp_o,
                  valid_o, sendable_o, spent_o};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  switch (ce) {
    case 2: return static_cast<int>(launch_warp<2>(n_rows, shift, in, out, stream));
    case 4: return static_cast<int>(launch_warp<4>(n_rows, shift, in, out, stream));
    case 8: return static_cast<int>(launch_warp<8>(n_rows, shift, in, out, stream));
    case 16: return static_cast<int>(launch_warp<16>(n_rows, shift, in, out, stream));
    case 32: return static_cast<int>(launch_warp<32>(n_rows, shift, in, out, stream));
    default:
      if (ce < 64 || ce > 1024 || (ce & (ce - 1)) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_block(n_rows, ce, shift, in, out, stream));
  }
}
