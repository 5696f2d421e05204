// Kernel A of the PHOLD window step: the FIFO egress stage of every host
// row, for Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_pipeline.py, _egress_rank_kernel (the
// Pallas TPU kernel behind egress_rank_stage).
//
// Per host row of CE egress slots it computes, bitwise as the TPU kernel:
//   - the clock rebase of tsend/clamp by `shift` (NO_CLAMP kept, invalid
//     tsend -> 0);
//   - the FIFO order: an ascending bitonic sort of the (key, column) pairs,
//     key = (invalid << 31) | prio as uint32; the pairs are distinct, so
//     the network's output is the stable sort by key;
//   - the permutation of all nine egress columns;
//   - the inclusive prefix sum of the valid bytes, sendable = valid &&
//     cum <= balance, and the row's spent bytes;
//   - a second bitonic over (seq ^ SIGN, column) of the sorted row, whose
//     index output is the routing stage's row_perm.
//
// What bounds it on the card: memory bytes. Each slot reads 7 int32 and 2
// bool columns and writes 8 int32 and 3 bool columns (65 B), plus 8 B a row;
// at N=32768, CE=16 that is 34.3 MB, about 10 us at 3.35 TB/s, against
// some 2 thousand integer operations a row. The design keeps everything but
// those bytes on chip: for CE <= 32 each row lives in CE lanes of one warp
// (32/CE rows a warp, one column a lane), both sorts exchange through
// __shfl_xor_sync, the payload permutation is one __shfl_sync per column,
// and the scan and the row sum are warp shuffles; loads and stores of a
// column are consecutive across lanes. For 64 <= CE <= 1024 one block holds
// one row in shared memory.
//
// The sorting networks, the scans and the rebase are row_bitonic.cuh's,
// shared with kernel C (egress_gate.cu).

#include <cstdint>
#include <cuda_runtime.h>

#include "row_bitonic.cuh"

namespace {

using namespace row_bitonic;

template <int CE>
__global__ void __launch_bounds__(kWarpBlock) egress_rank_warp(
    int n_rows, int shift, const uint8_t* __restrict__ valid,
    const int* __restrict__ prio, const int* __restrict__ nbytes,
    const int* __restrict__ tsend, const int* __restrict__ clamp,
    const int* __restrict__ dst, const int* __restrict__ seq,
    const int* __restrict__ sock, const uint8_t* __restrict__ ctrl,
    const int* __restrict__ balance, int* __restrict__ prio_o,
    int* __restrict__ sock_o, int* __restrict__ dst_o,
    int* __restrict__ bytes_o, int* __restrict__ seq_o,
    uint8_t* __restrict__ ctrl_o, int* __restrict__ tsend_o,
    int* __restrict__ clamp_o, uint8_t* __restrict__ valid_o,
    uint8_t* __restrict__ sendable_o, int* __restrict__ spent_o,
    int* __restrict__ row_perm_o) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpBlock + threadIdx.x;
  const int64_t row = e / CE;
  const int c = threadIdx.x & (CE - 1);
  // rows past the end still run the shuffles (full warp masks) on dummy
  // values and write nothing; a row is never split across that edge
  const bool live = row < n_rows;
  const int64_t x = live ? e : 0;

  const bool v = valid[x] != 0;
  const int p = prio[x];
  const int ts = rebase_tsend(v, tsend[x], shift);
  const int cl_rb = rebase_clamp(v, clamp[x], shift);

  uint32_t k = fifo_key(v, p);
  int src = c;
  warp_bitonic<CE>(k, src, c);
  const bool v_s = (k & kSign) == 0;

  // the permutation lands every payload column: lane c reads lane src
  const int p_s = __shfl_sync(kFull, p, src, CE);
  const int sock_s = __shfl_sync(kFull, sock[x], src, CE);
  const int dst_s = __shfl_sync(kFull, dst[x], src, CE);
  const int bytes_s = __shfl_sync(kFull, nbytes[x], src, CE);
  const int seq_s = __shfl_sync(kFull, seq[x], src, CE);
  const int ctrl_s = __shfl_sync(kFull, static_cast<int>(ctrl[x]), src, CE);
  const int ts_s = __shfl_sync(kFull, ts, src, CE);
  const int cl_s = __shfl_sync(kFull, cl_rb, src, CE);

  // inclusive scan of the valid bytes -> token gate
  const uint32_t cum = warp_inclusive_scan<CE>(
      v_s ? static_cast<uint32_t>(bytes_s) : 0u, c);
  const int bal = balance[live ? row : 0];
  const bool sendable = v_s && static_cast<int>(cum) <= bal;
  const uint32_t spent =
      warp_sum<CE>(sendable ? static_cast<uint32_t>(bytes_s) : 0u);

  // routing phase A: the sorted row's (seq, column) order
  uint32_t k2 = static_cast<uint32_t>(seq_s) ^ kSign;
  int perm2 = c;
  warp_bitonic<CE>(k2, perm2, c);

  if (!live) return;
  prio_o[e] = p_s;
  sock_o[e] = sock_s;
  dst_o[e] = dst_s;
  bytes_o[e] = bytes_s;
  seq_o[e] = seq_s;
  ctrl_o[e] = static_cast<uint8_t>(ctrl_s != 0);
  tsend_o[e] = ts_s;
  clamp_o[e] = cl_s;
  valid_o[e] = static_cast<uint8_t>(v_s);
  sendable_o[e] = static_cast<uint8_t>(sendable);
  row_perm_o[e] = perm2;
  if (c == 0) spent_o[row] = static_cast<int>(spent);
}

// One block of CE threads per row, 64 <= CE <= 1024. Dynamic shared memory:
// keys, indices and 8 payload columns, CE words each.
__global__ void egress_rank_block(
    int n_rows, int ce, int shift, const uint8_t* __restrict__ valid,
    const int* __restrict__ prio, const int* __restrict__ nbytes,
    const int* __restrict__ tsend, const int* __restrict__ clamp,
    const int* __restrict__ dst, const int* __restrict__ seq,
    const int* __restrict__ sock, const uint8_t* __restrict__ ctrl,
    const int* __restrict__ balance, int* __restrict__ prio_o,
    int* __restrict__ sock_o, int* __restrict__ dst_o,
    int* __restrict__ bytes_o, int* __restrict__ seq_o,
    uint8_t* __restrict__ ctrl_o, int* __restrict__ tsend_o,
    int* __restrict__ clamp_o, uint8_t* __restrict__ valid_o,
    uint8_t* __restrict__ sendable_o, int* __restrict__ spent_o,
    int* __restrict__ row_perm_o) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t spent_acc;
  uint32_t* sk = smem;
  int* si = reinterpret_cast<int*>(smem + ce);
  int* pay = reinterpret_cast<int*>(smem + 2 * ce);
  const int c = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t e = row * ce + c;
  (void)n_rows;

  const bool v = valid[e] != 0;
  const int p = prio[e];
  pay[0 * ce + c] = p;
  pay[1 * ce + c] = sock[e];
  pay[2 * ce + c] = dst[e];
  pay[3 * ce + c] = nbytes[e];
  pay[4 * ce + c] = seq[e];
  pay[5 * ce + c] = static_cast<int>(ctrl[e]);
  pay[6 * ce + c] = rebase_tsend(v, tsend[e], shift);
  pay[7 * ce + c] = rebase_clamp(v, clamp[e], shift);
  sk[c] = fifo_key(v, p);
  si[c] = c;
  if (c == 0) spent_acc = 0u;
  __syncthreads();
  block_bitonic(sk, si, ce, c);

  const uint32_t k = sk[c];
  const int src = si[c];
  const bool v_s = (k & kSign) == 0;
  const int p_s = pay[0 * ce + src];
  const int sock_s = pay[1 * ce + src];
  const int dst_s = pay[2 * ce + src];
  const int bytes_s = pay[3 * ce + src];
  const int seq_s = pay[4 * ce + src];
  const int ctrl_s = pay[5 * ce + src];
  const int ts_s = pay[6 * ce + src];
  const int cl_s = pay[7 * ce + src];
  __syncthreads();

  // inclusive scan of the valid bytes, through sk
  const uint32_t cum = block_inclusive_scan(
      sk, v_s ? static_cast<uint32_t>(bytes_s) : 0u, ce, c);
  const bool sendable = v_s && static_cast<int>(cum) <= balance[row];
  if (sendable) atomicAdd(&spent_acc, static_cast<uint32_t>(bytes_s));
  __syncthreads();

  sk[c] = static_cast<uint32_t>(seq_s) ^ kSign;
  si[c] = c;
  __syncthreads();
  block_bitonic(sk, si, ce, c);

  prio_o[e] = p_s;
  sock_o[e] = sock_s;
  dst_o[e] = dst_s;
  bytes_o[e] = bytes_s;
  seq_o[e] = seq_s;
  ctrl_o[e] = static_cast<uint8_t>(ctrl_s != 0);
  tsend_o[e] = ts_s;
  clamp_o[e] = cl_s;
  valid_o[e] = static_cast<uint8_t>(v_s);
  sendable_o[e] = static_cast<uint8_t>(sendable);
  row_perm_o[e] = si[c];
  if (c == 0) spent_o[row] = static_cast<int>(spent_acc);
}

template <int CE>
cudaError_t launch_warp(int n_rows, int shift, const void* const* in,
                        void* const* out, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n_rows) * CE;
  const int64_t blocks = (total + kWarpBlock - 1) / kWarpBlock;
  egress_rank_warp<CE><<<static_cast<unsigned>(blocks), kWarpBlock, 0, stream>>>(
      n_rows, shift, static_cast<const uint8_t*>(in[0]),
      static_cast<const int*>(in[1]), static_cast<const int*>(in[2]),
      static_cast<const int*>(in[3]), static_cast<const int*>(in[4]),
      static_cast<const int*>(in[5]), static_cast<const int*>(in[6]),
      static_cast<const int*>(in[7]), static_cast<const uint8_t*>(in[8]),
      static_cast<const int*>(in[9]), static_cast<int*>(out[0]),
      static_cast<int*>(out[1]), static_cast<int*>(out[2]),
      static_cast<int*>(out[3]), static_cast<int*>(out[4]),
      static_cast<uint8_t*>(out[5]), static_cast<int*>(out[6]),
      static_cast<int*>(out[7]), static_cast<uint8_t*>(out[8]),
      static_cast<uint8_t*>(out[9]), static_cast<int*>(out[10]),
      static_cast<int*>(out[11]));
  return cudaGetLastError();
}

cudaError_t launch_block(int n_rows, int ce, int shift, const void* const* in,
                         void* const* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(10) * ce * sizeof(uint32_t);
  egress_rank_block<<<n_rows, ce, smem, stream>>>(
      n_rows, ce, shift, static_cast<const uint8_t*>(in[0]),
      static_cast<const int*>(in[1]), static_cast<const int*>(in[2]),
      static_cast<const int*>(in[3]), static_cast<const int*>(in[4]),
      static_cast<const int*>(in[5]), static_cast<const int*>(in[6]),
      static_cast<const int*>(in[7]), static_cast<const uint8_t*>(in[8]),
      static_cast<const int*>(in[9]), static_cast<int*>(out[0]),
      static_cast<int*>(out[1]), static_cast<int*>(out[2]),
      static_cast<int*>(out[3]), static_cast<int*>(out[4]),
      static_cast<uint8_t*>(out[5]), static_cast<int*>(out[6]),
      static_cast<int*>(out[7]), static_cast<uint8_t*>(out[8]),
      static_cast<uint8_t*>(out[9]), static_cast<int*>(out[10]),
      static_cast<int*>(out[11]));
  return cudaGetLastError();
}

}  // namespace

// Inputs: valid (bool), prio, bytes, tsend, clamp, dst, seq, sock (int32),
// ctrl (bool), all [n_rows, ce] row-major; balance [n_rows] int32.
// Outputs: prio, sock, dst, bytes, seq (int32), ctrl (bool), tsend, clamp
// (int32), valid, sendable (bool), spent [n_rows] int32, row_perm int32.
// ce is a power of two in [2, 1024]. Returns the launch's cudaError_t.
extern "C" int egress_rank_launch(
    int n_rows, int ce, int shift, const void* valid, const void* prio,
    const void* nbytes, const void* tsend, const void* clamp, const void* dst,
    const void* seq, const void* sock, const void* ctrl, const void* balance,
    void* prio_o, void* sock_o, void* dst_o, void* bytes_o, void* seq_o,
    void* ctrl_o, void* tsend_o, void* clamp_o, void* valid_o,
    void* sendable_o, void* spent_o, void* row_perm_o, void* stream_ptr) {
  const void* in[10] = {valid, prio, nbytes, tsend, clamp,
                        dst,   seq,  sock,   ctrl,  balance};
  void* out[12] = {prio_o,  sock_o,  dst_o,   bytes_o,    seq_o,   ctrl_o,
                   tsend_o, clamp_o, valid_o, sendable_o, spent_o, row_perm_o};
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
