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
//     validity read back from the sorted key's top bit (so a negative
//     priority reads as invalid, as on the TPU);
//   - the inclusive prefix sum of the valid bytes, sendable = valid &&
//     cum <= balance, and the row's spent bytes, in uint32 (wrapping as the
//     TPU's int32 does).
// Unlike kernel A it permutes no other column and returns no row_perm: the
// caller gathers prio/sock/dst/seq/ctrl through `perm`.
//
// What bounds it on the card: memory bytes. Each slot reads 4 int32 and 1
// bool column and writes 4 int32 and 2 bool columns (35 B), plus 8 B a row:
// at N=32768, CE=16, 18.6 MB, 5.6 us at 3.35 TB/s. At that size a device
// copy of as many bytes, timed as chip_smoke.py times the kernel (inputs in
// HBM behind an L2 full of dirty lines), takes about twice that on an H100:
// the launch, the first misses and the write-back of the evicted lines are
// most of the time. The first design of this kernel (one slot a lane, a
// shuffle for every compare-exchange, 1- and 4-byte memory operations, two
// waves of load-then-sort blocks) spent ~160 instructions and ~31 shuffles
// a slot and ran 1.3x its byte bound with its inputs in L2, so instruction
// throughput and latency came on top of the bytes. This design takes that
// work off the bytes' path:
//   - a thread holds kV = 4 consecutive slots of a row (at CE = 2, two
//     rows). Every int32 column moves as one 16-byte vector a thread and
//     the bool columns as one 4-byte word, consecutive across the warp;
//   - the sort runs on one 64-bit (key << 32 | column) word a slot, so a
//     compare-exchange is one compare and two selects. Strides below kV
//     run in registers (compile-time indices), strides up to 64 slots
//     through one 64-bit shuffle a slot, and only strides of 128 and more
//     (CE >= 256, a row over several warps) through shared memory, with
//     one barrier a stage (two buffers);
//   - bytes/tsend/clamp ride no network: after the sort each slot fetches
//     them once through `perm` from a block tile in shared memory;
//   - the scan is a serial prefix of kV in the thread plus log2(CE / kV)
//     shuffle steps, and across warps one barrier over the warps' totals;
//   - a persistent grid of as many 256-thread blocks as fit on the card
//     (four an SM up to CE = 32, in 64 registers) walks tiles of 1024
//     slots, and each thread loads its next tile's columns into registers
//     before it sorts the current one, so loads stay in flight while it
//     computes;
//   - the inputs are loaded with an L2 evict-first policy: read once, they
//     make room for the outputs before lines that must be written back.
// Cold, it runs in the time of that device copy of its bytes.
//
// At CE = 1 a thread holds four rows, and the network and the scan are
// empty. Rows wider than 1024 slots (which no main path runs) take the
// wide build: a block of 1024 threads a row, its network run over device
// memory with a block barrier a stage.

#include <cstdint>
#include <cuda_runtime.h>

#include "row_bitonic.cuh"

namespace {

using row_bitonic::fifo_key;
using row_bitonic::kFull;
using row_bitonic::kSign;
using row_bitonic::rebase_clamp;
using row_bitonic::rebase_tsend;

constexpr int kBlock = 256;         // threads a block
constexpr int kV = 4;               // consecutive slots a thread
constexpr int kTile = kBlock * kV;  // slots a block tile
constexpr int kWarps = kBlock / 32;
constexpr int kMaxDevices = 64;

struct Args {
  int64_t n_slots;
  int n_rows;
  int shift;
  const uint8_t* valid;
  const int* prio;
  const int* nbytes;
  const int* tsend;
  const int* clamp;
  const int* balance;
  int* perm_o;
  int* bytes_o;
  int* tsend_o;
  int* clamp_o;
  uint8_t* valid_o;
  uint8_t* sendable_o;
  int* spent_o;
};

__host__ __device__ constexpr int log2i(int x) {
  return x > 1 ? 1 + log2i(x / 2) : 0;
}

// How CE slots of a row spread over threads.
template <int CE>
struct Row {
  static constexpr int kLog = log2i(CE);
  static constexpr int kLanes = CE >= kV ? CE / kV : 1;  // threads a row
  static constexpr int kRows = CE >= kV ? 1 : kV / CE;   // rows a thread
  static constexpr int kWarpsPerRow = kLanes > 32 ? kLanes / 32 : 1;
};

// One thread's kV slots of the input columns, as loaded.
template <int CE>
struct Chunk {
  uint32_t valid;  // 4 bool bytes
  int4 prio, nbytes, tsend, clamp;
  int balance[Row<CE>::kRows];
};

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The inputs are read once, so their lines go first when L2 needs room
// (for the outputs, rather than lines some other kernel left dirty).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int4 load_once(const int4* p, uint64_t pol) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t load_once(const uint32_t* p,
                                              uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

// Chunk q: slots [kV*q, kV*q + kV) of the flat [n_rows * CE] columns. A
// chunk past the end loads zeros; only the last one can be partial (CE = 2
// with n_rows odd).
template <int CE>
__device__ __forceinline__ void load_chunk(Chunk<CE>& ch, const Args& a,
                                           int64_t q, uint64_t pol) {
  const int64_t s0 = q * kV;
  if (s0 + kV <= a.n_slots) {
    ch.valid = load_once(reinterpret_cast<const uint32_t*>(a.valid) + q, pol);
    ch.prio = load_once(reinterpret_cast<const int4*>(a.prio) + q, pol);
    ch.nbytes = load_once(reinterpret_cast<const int4*>(a.nbytes) + q, pol);
    ch.tsend = load_once(reinterpret_cast<const int4*>(a.tsend) + q, pol);
    ch.clamp = load_once(reinterpret_cast<const int4*>(a.clamp) + q, pol);
  } else {
    int w[4][kV];
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const bool in = s0 + j < a.n_slots;
      const int64_t s = in ? s0 + j : 0;
      v |= static_cast<uint32_t>(in ? a.valid[s] : 0) << (8 * j);
      w[0][j] = in ? a.prio[s] : 0;
      w[1][j] = in ? a.nbytes[s] : 0;
      w[2][j] = in ? a.tsend[s] : 0;
      w[3][j] = in ? a.clamp[s] : 0;
    }
    ch.valid = v;
    ch.prio = make_int4(w[0][0], w[0][1], w[0][2], w[0][3]);
    ch.nbytes = make_int4(w[1][0], w[1][1], w[1][2], w[1][3]);
    ch.tsend = make_int4(w[2][0], w[2][1], w[2][2], w[2][3]);
    ch.clamp = make_int4(w[3][0], w[3][1], w[3][2], w[3][3]);
  }
#pragma unroll
  for (int r = 0; r < Row<CE>::kRows; ++r) {
    const int64_t row = s0 / CE + r;
    ch.balance[r] = row < a.n_rows ? __ldg(a.balance + row) : 0;
  }
}

// Rows within a warp synchronise the warp; rows over several warps the
// block.
template <int CE>
__device__ __forceinline__ void row_sync() {
  if constexpr (Row<CE>::kWarpsPerRow > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Ascending bitonic sort of the rows' packed (key, column) words. `base`
// is the column of the thread's first slot in its row (0 when CE < kV);
// `xk` is 2 * kTile words of shared memory, used only when CE >= 256.
template <int CE>
__device__ __forceinline__ void sort_rows(uint64_t (&k)[kV], int base,
                                          uint64_t* xk) {
  int xphase = 0;
#pragma unroll
  for (int ls = 1; ls <= Row<CE>::kLog; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, stride = 1 << lt;
      if (stride < kV) {
        // both slots in this thread: compile-time indices
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (j & stride) continue;
          const bool asc = size < kV ? ((j & (CE - 1)) & size) == 0
                                     : (base & size) == 0;
          const uint64_t x = k[j], y = k[j | stride];
          const bool swap = (x > y) == asc;
          k[j] = swap ? y : x;
          k[j | stride] = swap ? x : y;
        }
        continue;
      }
      // the partner slot is the same j of another thread
      const bool keep_min = ((base & stride) == 0) == ((base & size) == 0);
      uint64_t p[kV];
      if (stride < 32 * kV) {
#pragma unroll
        for (int j = 0; j < kV; ++j)
          p[j] = __shfl_xor_sync(kFull, k[j], stride / kV);
      } else {
        uint64_t* buf = xk + (xphase & 1) * kTile;
        ++xphase;
        ulonglong2* mine =
            reinterpret_cast<ulonglong2*>(buf + threadIdx.x * kV);
        mine[0] = make_ulonglong2(k[0], k[1]);
        mine[1] = make_ulonglong2(k[2], k[3]);
        __syncthreads();
        const ulonglong2* other = reinterpret_cast<const ulonglong2*>(
            buf + (threadIdx.x ^ (stride / kV)) * kV);
        const ulonglong2 p01 = other[0], p23 = other[1];
        p[0] = p01.x;
        p[1] = p01.y;
        p[2] = p23.x;
        p[3] = p23.y;
      }
#pragma unroll
      for (int j = 0; j < kV; ++j)
        k[j] = ((k[j] < p[j]) == keep_min) ? k[j] : p[j];
    }
  }
}

// Order and gate one tile's chunk q (the thread's), from its loaded
// columns.
template <int CE>
__device__ __forceinline__ void gate_chunk(const Chunk<CE>& ch, int64_t q,
                                           const Args& a, uint4 (*pay)[kBlock],
                                           uint64_t* xk, uint32_t* wsum,
                                           uint32_t* wspent) {
  using R = Row<CE>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = CE >= kV ? (tid * kV) & (CE - 1) : 0;

  // rebase, pack the keys, park the carried columns in shared memory
  uint64_t k[kV];
  int ts[kV], cl[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const bool v = ((ch.valid >> (8 * j)) & 0xffu) != 0;
    ts[j] = rebase_tsend(v, lane_of(ch.tsend, j), a.shift);
    cl[j] = rebase_clamp(v, lane_of(ch.clamp, j), a.shift);
    const uint32_t col = static_cast<uint32_t>(base + (j & (CE - 1)));
    k[j] = (static_cast<uint64_t>(fifo_key(v, lane_of(ch.prio, j))) << 32) |
           col;
  }
  row_sync<CE>();  // the previous tile's reads of `pay` are done
  pay[0][tid] = make_uint4(ch.nbytes.x, ch.nbytes.y, ch.nbytes.z,
                           ch.nbytes.w);
  pay[1][tid] = make_uint4(ts[0], ts[1], ts[2], ts[3]);
  pay[2][tid] = make_uint4(cl[0], cl[1], cl[2], cl[3]);

  sort_rows<CE>(k, base, xk);
  row_sync<CE>();  // `pay` written by the whole row

  const uint32_t* pay0 = reinterpret_cast<const uint32_t*>(pay[0]);
  const uint32_t* pay1 = reinterpret_cast<const uint32_t*>(pay[1]);
  const uint32_t* pay2 = reinterpret_cast<const uint32_t*>(pay[2]);
  int src[kV], bytes_s[kV], ts_s[kV], cl_s[kV];
  bool v_s[kV];
  uint32_t pre[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    src[j] = static_cast<int>(static_cast<uint32_t>(k[j]));
    v_s[j] = (static_cast<uint32_t>(k[j] >> 32) & kSign) == 0;
    const int at = ((tid * kV + j) & ~(CE - 1)) + src[j];
    bytes_s[j] = static_cast<int>(pay0[at]);
    ts_s[j] = static_cast<int>(pay1[at]);
    cl_s[j] = static_cast<int>(pay2[at]);
    // inclusive prefix in the thread; a row starts again at j = CE (CE < kV)
    const uint32_t b = v_s[j] ? static_cast<uint32_t>(bytes_s[j]) : 0u;
    pre[j] = (j & (CE - 1)) == 0 ? b : pre[j > 0 ? j - 1 : 0] + b;
  }

  // the row's earlier threads' bytes
  uint32_t excl = 0;
  // a row's lanes in one warp
  [[maybe_unused]] constexpr int kWidth = R::kLanes < 32 ? R::kLanes : 32;
  if constexpr (R::kLanes > 1) {
    const uint32_t total = pre[kV - 1];
    const int in_row = lane & (kWidth - 1);
    uint32_t x = total;
#pragma unroll
    for (int d = 1; d < kWidth; d <<= 1) {
      const uint32_t up = __shfl_up_sync(kFull, x, d, kWidth);
      if (in_row >= d) x += up;
    }
    excl = x - total;
    if constexpr (R::kWarpsPerRow > 1) {
      if (lane == 31) wsum[warp] = x;
      __syncthreads();
      for (int w = warp & ~(R::kWarpsPerRow - 1); w < warp; ++w)
        excl += wsum[w];
    }
  }

  bool sendable[kV];
  uint32_t spent[R::kRows];
#pragma unroll
  for (int r = 0; r < R::kRows; ++r) spent[r] = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int r = R::kRows > 1 ? j / CE : 0;
    sendable[j] =
        v_s[j] && static_cast<int>(excl + pre[j]) <= ch.balance[r];
    spent[r] += sendable[j] ? static_cast<uint32_t>(bytes_s[j]) : 0u;
  }
  if constexpr (R::kLanes > 1) {
#pragma unroll
    for (int d = kWidth >> 1; d > 0; d >>= 1)
      spent[0] += __shfl_xor_sync(kFull, spent[0], d);
    if constexpr (R::kWarpsPerRow > 1) {
      if (lane == 0) wspent[warp] = spent[0];
      __syncthreads();
      const int first = warp & ~(R::kWarpsPerRow - 1);
      spent[0] = 0;
#pragma unroll
      for (int w = 0; w < R::kWarpsPerRow; ++w) spent[0] += wspent[first + w];
    }
  }

  uint32_t vo = 0, so = 0;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    vo |= static_cast<uint32_t>(v_s[j]) << (8 * j);
    so |= static_cast<uint32_t>(sendable[j]) << (8 * j);
  }
  const int64_t s0 = q * kV;
  if (s0 + kV <= a.n_slots) {
    reinterpret_cast<int4*>(a.perm_o)[q] =
        make_int4(src[0], src[1], src[2], src[3]);
    reinterpret_cast<int4*>(a.bytes_o)[q] =
        make_int4(bytes_s[0], bytes_s[1], bytes_s[2], bytes_s[3]);
    reinterpret_cast<int4*>(a.tsend_o)[q] =
        make_int4(ts_s[0], ts_s[1], ts_s[2], ts_s[3]);
    reinterpret_cast<int4*>(a.clamp_o)[q] =
        make_int4(cl_s[0], cl_s[1], cl_s[2], cl_s[3]);
    reinterpret_cast<uint32_t*>(a.valid_o)[q] = vo;
    reinterpret_cast<uint32_t*>(a.sendable_o)[q] = so;
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      if (s0 + j >= a.n_slots) break;
      a.perm_o[s0 + j] = src[j];
      a.bytes_o[s0 + j] = bytes_s[j];
      a.tsend_o[s0 + j] = ts_s[j];
      a.clamp_o[s0 + j] = cl_s[j];
      a.valid_o[s0 + j] = static_cast<uint8_t>(v_s[j]);
      a.sendable_o[s0 + j] = static_cast<uint8_t>(sendable[j]);
    }
  }
  if (base == 0) {
#pragma unroll
    for (int r = 0; r < R::kRows; ++r) {
      const int64_t row = s0 / CE + r;
      if (row < a.n_rows) a.spent_o[row] = static_cast<int>(spent[r]);
    }
  }
}

// Up to CE = 32 the kernel fits in 64 registers, so four blocks share an
// SM and 132 SMs hold a 32768 x 16 call's 512 tiles at once; wider rows
// keep what the compiler gives them (80-110 registers, no spills).
template <int CE>
__global__ void __launch_bounds__(kBlock, CE <= 32 ? 4 : 1)
    egress_gate_kernel(const Args a) {
  __shared__ uint4 pay[3][kBlock];
  // the key exchange of rows over several warps
  __shared__ __align__(16)
      uint64_t xk[Row<CE>::kWarpsPerRow > 1 ? 2 * kTile : 2];
  __shared__ uint32_t wsum[kWarps], wspent[kWarps];
  const int64_t n_tiles = (a.n_slots + kTile - 1) / kTile;
  const uint64_t pol = evict_first_policy();
  int64_t t = blockIdx.x;
  Chunk<CE> cur, next;
  if (t < n_tiles) load_chunk<CE>(cur, a, t * kBlock + threadIdx.x, pol);
  for (; t < n_tiles; t += gridDim.x) {
    const int64_t t_next = t + gridDim.x;
    if (t_next < n_tiles)
      load_chunk<CE>(next, a, t_next * kBlock + threadIdx.x, pol);
    gate_chunk<CE>(cur, t * kBlock + threadIdx.x, a, pay, xk, wsum, wspent);
    cur = next;
  }
}

// Blocks of the persistent grid: as many as fit on the device at once, or
// one a tile if there are fewer tiles. The SM count and the occupancy are
// read once a device.
template <int CE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static int fit[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int blocks = dev < kMaxDevices ? fit[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, egress_gate_kernel<CE>, kBlock, 0);
    if (err != cudaSuccess) return err;
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) fit[dev] = blocks;
  }
  const int64_t tiles = (a.n_slots + kTile - 1) / kTile;
  if (tiles < blocks) blocks = static_cast<int>(tiles);
  egress_gate_kernel<CE><<<blocks, kBlock, 0, stream>>>(a);
  return cudaGetLastError();
}

// One block of kWideBlock threads a row for CE > 1024 (the tile design's
// key exchange holds at most a 1024-slot row): the network runs over
// device memory through perm_o (row_bitonic::wide_bitonic), its keys read
// from the inputs, and each thread gathers, scans and writes its own run
// of CE / kWideBlock consecutive slots. Nothing of the main paths runs it.
__global__ void __launch_bounds__(row_bitonic::kWideBlock)
    egress_gate_wide(const Args a, int ce) {
  using row_bitonic::kWideBlock;
  __shared__ uint32_t buf[kWideBlock];
  __shared__ uint32_t spent_acc;
  const int64_t row = blockIdx.x;
  const int64_t r0 = row * ce;
  const int run = ce / kWideBlock;
  const int c0 = threadIdx.x * run;
  if (threadIdx.x == 0) spent_acc = 0u;
  row_bitonic::wide_bitonic(a.perm_o + r0, ce, [&](int i) {
    return fifo_key(a.valid[r0 + i] != 0, a.prio[r0 + i]);
  });

  // gather the thread's run of slots; sum its valid bytes
  uint32_t total = 0;
  for (int c = c0; c < c0 + run; ++c) {
    const int64_t e = r0 + c;
    const int64_t s = r0 + a.perm_o[e];
    const bool v = a.valid[s] != 0;
    const bool v_s = (fifo_key(v, a.prio[s]) & kSign) == 0;
    a.bytes_o[e] = a.nbytes[s];
    a.tsend_o[e] = rebase_tsend(v, a.tsend[s], a.shift);
    a.clamp_o[e] = rebase_clamp(v, a.clamp[s], a.shift);
    a.valid_o[e] = static_cast<uint8_t>(v_s);
    if (v_s) total += static_cast<uint32_t>(a.nbytes[s]);
  }

  row_bitonic::wide_token_gate(a.valid_o + r0, a.bytes_o + r0,
                               a.sendable_o + r0, c0, run, total,
                               a.balance[row], buf, &spent_acc);
  __syncthreads();
  if (threadIdx.x == 0) a.spent_o[row] = static_cast<int>(spent_acc);
}

// The build a row of ce slots runs: 1 the tile design (ce <= 1024), 2 the
// wide build; 0 for a ce the kernel does not take (not a power of two, or
// not positive).
int build_of(int ce) {
  if (ce <= 0 || (ce & (ce - 1)) != 0) return 0;
  return ce <= 1024 ? 1 : 2;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The build egress_gate_launch runs for rows of ce slots (see build_of).
extern "C" int egress_gate_build(int ce) { return build_of(ce); }

// Inputs: valid (bool), prio, bytes, tsend, clamp (int32), all [n_rows, ce]
// row-major; balance [n_rows] int32. Outputs: perm, bytes, tsend, clamp
// (int32), valid, sendable (bool), all [n_rows, ce]; spent [n_rows] int32.
// ce is a power of two; the [n_rows, ce] columns start on 16 bytes.
// Returns the launch's cudaError_t.
extern "C" int egress_gate_launch(
    int n_rows, int ce, int shift, const void* valid, const void* prio,
    const void* nbytes, const void* tsend, const void* clamp,
    const void* balance, void* perm_o, void* bytes_o, void* tsend_o,
    void* clamp_o, void* valid_o, void* sendable_o, void* spent_o,
    void* stream_ptr) {
  if (build_of(ce) == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const void* cols[] = {valid,   prio,    nbytes,  tsend,  clamp,     perm_o,
                        bytes_o, tsend_o, clamp_o, valid_o, sendable_o};
  for (const void* p : cols)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{static_cast<int64_t>(n_rows) * ce,
               n_rows,
               shift,
               static_cast<const uint8_t*>(valid),
               static_cast<const int*>(prio),
               static_cast<const int*>(nbytes),
               static_cast<const int*>(tsend),
               static_cast<const int*>(clamp),
               static_cast<const int*>(balance),
               static_cast<int*>(perm_o),
               static_cast<int*>(bytes_o),
               static_cast<int*>(tsend_o),
               static_cast<int*>(clamp_o),
               static_cast<uint8_t*>(valid_o),
               static_cast<uint8_t*>(sendable_o),
               static_cast<int*>(spent_o)};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (ce) {
    case 1: return static_cast<int>(launch<1>(a, stream));
    case 2: return static_cast<int>(launch<2>(a, stream));
    case 4: return static_cast<int>(launch<4>(a, stream));
    case 8: return static_cast<int>(launch<8>(a, stream));
    case 16: return static_cast<int>(launch<16>(a, stream));
    case 32: return static_cast<int>(launch<32>(a, stream));
    case 64: return static_cast<int>(launch<64>(a, stream));
    case 128: return static_cast<int>(launch<128>(a, stream));
    case 256: return static_cast<int>(launch<256>(a, stream));
    case 512: return static_cast<int>(launch<512>(a, stream));
    case 1024: return static_cast<int>(launch<1024>(a, stream));
    default:
      egress_gate_wide<<<n_rows, row_bitonic::kWideBlock, 0, stream>>>(a, ce);
      return static_cast<int>(cudaGetLastError());
  }
}
