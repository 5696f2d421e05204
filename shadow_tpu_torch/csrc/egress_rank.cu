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
// What bounds it on the card, and the design, by build (the launcher picks
// one by CE; `egress_rank_build` reports it):
//   - "warp" (CE <= 32, the main paths' CE = 16): memory bytes. Each slot
//     reads 7 int32 and 2 bool columns and writes 8 int32 and 3 bool
//     columns (65 B), plus 8 B a row; at N=32768, CE=16 that is 34.3 MB,
//     about 10 us at 3.35 TB/s, against some 2 thousand integer operations
//     a row. Each row lives in CE lanes of one warp (32/CE rows a warp, one
//     column a lane), both sorts exchange through __shfl_xor_sync, the
//     payload permutation is one __shfl_sync per column, and the scan and
//     the row sum are warp shuffles; loads and stores of a column are
//     consecutive across lanes. At CE = 1 a warp holds 32 rows, and the
//     networks, the scan and the sum are empty.
//   - "block" (64 <= CE <= 1024): one block holds one row in shared
//     memory, a slot a thread, a barrier a stage.
//   - "wide" (2048 <= CE <= 16384, which a row grows to when an elastic
//     run doubles its egress rings): operations. Two networks of 66-105
//     stages over the row's packed words cost more integer operations and
//     shuffles than the 65 B a slot take at 3.35 TB/s. One block holds
//     the row in shared memory (row_bitonic's `Wide`: runs of 16 slots in
//     registers a pass at a time, shuffles within a warp, shared memory
//     only across warps). prio is staged before the sort, the other
//     payload columns after it, up to three at a time, each gathered
//     through the sorted slots' source columns (kept in shared memory) and
//     written coalesced, and the second network's (seq ^ SIGN, column)
//     words come from the gathered seq: no scattered read of device
//     memory. 14 B a slot of dynamic shared memory (224 KB at 16384: one
//     block an SM).
//   - "cluster" (CE = 32768 and 65536, past what a block's shared memory
//     holds): operations, as the wide build, and the gathers over
//     distributed shared memory. A thread-block cluster a row
//     (row_bitonic's `ClusterRow`: 2 blocks of 16384 slots at 32768, 8 of
//     8192 at 65536, the geometry that won on the card), each block
//     holding its share of the row as the wide build holds a row and
//     running the wide build's strides within it; the 1 and 6 stages a
//     network whose stride spans blocks exchange words over distributed
//     shared memory, a cluster barrier a stage. Each block stages its
//     share of the payload columns, two side by side, and every block
//     gathers its sorted slots' values from whichever block owns the
//     source slot, over distributed shared memory (one 8-byte load a slot
//     fetches a pair, at the cost of one 4-byte load): no scattered read
//     of device memory. The token gate's prefix starts from the
//     lower-ranked blocks' totals.
//   - "device" (CE >= 131072, past the portable cluster of 8 blocks):
//     a block of 1024 threads a row, its two networks sorting column
//     indices in place in row_perm with each key read through the inputs
//     and seq_o, a block barrier a stage; barriers and scattered reads
//     bound it.
//
// The sorting networks, the scans and the rebase are row_bitonic.cuh's,
// shared with kernel C (egress_gate.cu).

#include <cooperative_groups.h>
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

// The wide build's arguments (the launcher's `in` and `out` arrays).
struct WideArgs {
  int shift;
  const uint8_t* valid;
  const int *prio, *nbytes, *tsend, *clamp, *dst, *seq, *sock;
  const uint8_t* ctrl;
  const int* balance;
  int *prio_o, *sock_o, *dst_o, *bytes_o, *seq_o;
  uint8_t* ctrl_o;
  int *tsend_o, *clamp_o;
  uint8_t *valid_o, *sendable_o;
  int *spent_o, *row_perm_o;
};

// The wide build, 2048 <= CE <= 16384: one block a row, the row in its
// shared memory (row_bitonic::Wide; a thread plays kPasses runs of kV
// slots, a pass at a time); every [n_rows, CE] column on 16 bytes. prio
// is staged before the sort in col(2) (row_bitonic::Layout); the other
// seven payload columns after it, up to three at a time, and each is
// gathered through the sorted slots' source columns and written out. The
// second network sorts the (seq ^ SIGN, column) words built from the
// gathered seq.
template <int CE>
__global__ void __launch_bounds__(Wide<CE>::kThreads)
    egress_rank_wide(const WideArgs a) {
  using W = Wide<CE>;
  constexpr int kRun = W::kV, kP = W::kPasses;
  extern __shared__ __align__(16) uint64_t wide_smem[];
  __shared__ uint32_t wsum[(kP + 1) * W::kWarps];
  const Layout<CE> L(wide_smem);
  const uint64_t pol = evict_first_policy();
  const auto as_is = [](int, int v) { return v; };

#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const uint32_t vin = load_bits<kRun>(a.valid + row_start<CE>() + base,
                                         pol);
    uint64_t k[kRun];
    load_keys<kRun>(k, vin, a.prio + row_start<CE>() + base, base, pol,
                    L.col(2));
    put_words<kRun>(L.words, base, k);
  }
  wide_sort<CE>(L.words);
  sorted_runs<CE>(L);

  // prio (staged), sock, dst
  __syncthreads();  // every thread has read its words
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    stage_from<kRun>(L.col(0), base, a.sock + row_start<CE>() + base, pol,
                     as_is);
    stage_from<kRun>(L.col(1), base, a.dst + row_start<CE>() + base, pol,
                     as_is);
  }
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<CE>() + base;
    gather_to<kRun>(a.prio_o + e0, L.col(2), L.src(), base);
    gather_to<kRun>(a.sock_o + e0, L.col(0), L.src(), base);
    gather_to<kRun>(a.dst_o + e0, L.col(1), L.src(), base);
    store_bits<kRun>(a.valid_o + e0, valid_bits<kRun>(L.src(), base));
  }

  // tsend and clamp rebased, ctrl
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    // the inputs' validity, read again for the rebase
    const uint32_t v = load_bits<kRun>(a.valid + row_start<CE>() + base, pol);
    stage_from<kRun>(L.col(0), base, a.tsend + row_start<CE>() + base, pol,
                     [&](int j, int x) {
                       return rebase_tsend((v >> j) & 1u, x, a.shift);
                     });
    stage_from<kRun>(L.col(1), base, a.clamp + row_start<CE>() + base, pol,
                     [&](int j, int x) {
                       return rebase_clamp((v >> j) & 1u, x, a.shift);
                     });
    const uint32_t ctrl =
        load_bits<kRun>(a.ctrl + row_start<CE>() + base, pol);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q)
      *reinterpret_cast<int4*>(L.col(2) + col_at(base + 4 * q)) =
          make_int4(static_cast<int>((ctrl >> (4 * q)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 1)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 2)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 3)) & 1u));
  }
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<CE>() + base;
    gather_to<kRun>(a.tsend_o + e0, L.col(0), L.src(), base);
    gather_to<kRun>(a.clamp_o + e0, L.col(1), L.src(), base);
    store_bits<kRun>(a.ctrl_o + e0, gather_bits<kRun>(L.col(2), L.src(), base));
  }

  // bytes -> the token gate; seq -> the second network
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    stage_from<kRun>(L.col(0), base, a.nbytes + row_start<CE>() + base, pol,
                     as_is);
    stage_from<kRun>(L.col(2), base, a.seq + row_start<CE>() + base, pol,
                     as_is);
  }
  __syncthreads();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<CE>() + base;
    gather_to<kRun>(a.bytes_o + e0, L.col(0), L.src(), base);
    gather_to<kRun>(a.seq_o + e0, L.col(2), L.src(), base);
  }
  const uint32_t spent = wide_gate<CE>(
      L.col(0), L.src(), __ldg(a.balance + blockIdx.x), wsum,
      [&](int base, uint32_t sendable) {
        store_bits<kRun>(a.sendable_o + row_start<CE>() + base, sendable);
      });
  if (threadIdx.x == 0) a.spent_o[blockIdx.x] = static_cast<int>(spent);

  // routing phase A: the sorted row's (seq, column) order. The words go
  // where col(0) was (the gate's last barrier follows every read of it);
  // seq is read from col(2).
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      int s[4];
      src4(L.src(), base + 4 * q, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        L.words[word_at<kRun>(base + 4 * q + i)] =
            pack(static_cast<uint32_t>(L.col(2)[col_at(s[i])]) ^ kSign,
                 base + 4 * q + i);
    }
  }
  wide_sort<CE>(L.words);
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    int* out = a.row_perm_o + row_start<CE>() + base;
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = static_cast<int>(static_cast<uint32_t>(
            L.words[word_at<kRun>(base + 4 * q + i)]));
      reinterpret_cast<int4*>(out)[q] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The cluster build, CE = 32768 and 65536: a cluster of K::kBlocks
// blocks a row, block r holding the row's slots [r * kS, (r + 1) * kS) in
// its shared memory as the wide build holds a row (row_bitonic's
// `ClusterRow`, `Layout<kS>`; every [n_rows, CE] column on 16 bytes).
// prio is staged before the sort in col(2); the other seven payload
// columns after it, in three groups (sock and dst; tsend, clamp and
// ctrl; bytes and seq), two of each group side by side in the word
// buffer and the third in col(2). Every block stages its share of a
// group, then gathers its sorted slots' values over distributed shared
// memory through their source columns (one 8-byte load a slot for a
// pair), with a cluster barrier after the staging and after the gathers.
// The token gate reads the sorted bytes back from this thread's own runs
// of bytes_o, and the second network's (seq ^ SIGN, column) words are
// built from its own runs of seq_o. Ends with a cluster barrier, so no
// block exits while another may read its shared memory.
template <int CE>
__global__ void __launch_bounds__(ClusterRow<CE>::W::kThreads)
    egress_rank_cluster(const WideArgs a) {
  using K = ClusterRow<CE>;
  using W = typename K::W;
  constexpr int kS = K::kS, kRun = W::kV, kP = W::kPasses;
  extern __shared__ __align__(16) uint64_t wide_smem[];
  __shared__ uint32_t wsum[(kP + 1) * W::kWarps];
  __shared__ uint32_t n_valid_s, xs[2];
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const Layout<kS> L(wide_smem);
  int2* pairs = reinterpret_cast<int2*>(wide_smem);
  const uint64_t pol = evict_first_policy();
  const int off = static_cast<int>(cl.block_rank()) * kS;
  const int row = static_cast<int>(blockIdx.x) / K::kBlocks;
  const auto as_is = [](int, int v) { return v; };
  if (threadIdx.x == 0) n_valid_s = 0;

#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const uint32_t vin = load_bits<kRun>(a.valid + row_start<kS>() + base,
                                         pol);
    uint64_t k[kRun];
    load_keys<kRun>(k, vin, a.prio + row_start<kS>() + base, base, pol,
                    L.col(2));
    // each word's column is its row column
#pragma unroll
    for (int j = 0; j < kRun; ++j) k[j] += static_cast<uint64_t>(off);
    put_words<kRun>(L.words, base, k);
  }
  cluster_sort<CE>(L.words, cl);
  sorted_columns<kS>(L, &n_valid_s);
  __syncthreads();  // every thread has read its words; n_valid_s summed
  const int n_valid = static_cast<int>(n_valid_s);

  // prio (staged), sock and dst
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    stage_pair_from<kRun>(pairs, base, a.sock + row_start<kS>() + base,
                          a.dst + row_start<kS>() + base, pol, as_is, as_is);
  }
  cl.sync();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<kS>() + base;
    gather_cluster<kS, kRun>(cl, a.prio_o + e0, L.col(2), L.src(), base);
    gather_pair_cluster<kS, kRun>(cl, a.sock_o + e0, a.dst_o + e0, pairs,
                                  L.src(), base);
    store_bits<kRun>(a.valid_o + e0, prefix_bits<kRun>(n_valid, base));
  }
  cl.sync();

  // tsend and clamp rebased, ctrl
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    // the inputs' validity, read again for the rebase
    const uint32_t v = load_bits<kRun>(a.valid + row_start<kS>() + base, pol);
    stage_pair_from<kRun>(
        pairs, base, a.tsend + row_start<kS>() + base,
        a.clamp + row_start<kS>() + base, pol,
        [&](int j, int x) { return rebase_tsend((v >> j) & 1u, x, a.shift); },
        [&](int j, int x) {
          return rebase_clamp((v >> j) & 1u, x, a.shift);
        });
    const uint32_t ctrl =
        load_bits<kRun>(a.ctrl + row_start<kS>() + base, pol);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q)
      *reinterpret_cast<int4*>(L.col(2) + col_at(base + 4 * q)) =
          make_int4(static_cast<int>((ctrl >> (4 * q)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 1)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 2)) & 1u),
                    static_cast<int>((ctrl >> (4 * q + 3)) & 1u));
  }
  cl.sync();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<kS>() + base;
    gather_pair_cluster<kS, kRun>(cl, a.tsend_o + e0, a.clamp_o + e0, pairs,
                                  L.src(), base);
    store_bits<kRun>(a.ctrl_o + e0, gather_bits_cluster<kS, kRun>(
                                        cl, L.col(2), L.src(), base));
  }
  cl.sync();

  // bytes -> the token gate; seq -> the second network
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    stage_pair_from<kRun>(pairs, base, a.nbytes + row_start<kS>() + base,
                          a.seq + row_start<kS>() + base, pol, as_is, as_is);
  }
  cl.sync();
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int64_t e0 = row_start<kS>() + base;
    gather_pair_cluster<kS, kRun>(cl, a.bytes_o + e0, a.seq_o + e0, pairs,
                                  L.src(), base);
  }
  // its first cluster barrier follows every block's gathers of the pairs
  cluster_gate<CE>(cl, a.bytes_o + row_start<kS>(), n_valid,
                   __ldg(a.balance + row), wsum, xs, a.spent_o + row,
                   [&](int base, uint32_t sendable) {
                     store_bits<kRun>(
                         a.sendable_o + row_start<kS>() + base, sendable);
                   });

  // routing phase A: the sorted row's (seq, column) order, its words
  // built from this thread's own runs of seq_o in the word buffer (no
  // block reads it after the gate's barriers)
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    const int4* seq_s =
        reinterpret_cast<const int4*>(a.seq_o + row_start<kS>() + base);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int4 v4 = seq_s[q];
      const int v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        L.words[word_at<kRun>(base + 4 * q + i)] =
            pack(static_cast<uint32_t>(v[i]) ^ kSign,
                 off + base + 4 * q + i);
    }
  }
  cluster_sort<CE>(L.words, cl);
#pragma unroll 1
  for (int pass = 0; pass < kP; ++pass) {
    const int base = W::base(pass);
    int* out = a.row_perm_o + row_start<kS>() + base;
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = static_cast<int>(static_cast<uint32_t>(
            L.words[word_at<kRun>(base + 4 * q + i)]));
      reinterpret_cast<int4*>(out)[q] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  cl.sync();
}

// The device build, CE >= 131072 (past the portable cluster of 8 blocks):
// one block of kDeviceBlock threads a row; both networks run over
// device memory through row_perm_o (device_bitonic), their keys read from
// the inputs and from seq_o, and each thread permutes, scans and writes
// its own run of CE / kDeviceBlock consecutive slots.
__global__ void __launch_bounds__(kDeviceBlock) egress_rank_device(
    int ce, int shift, const uint8_t* __restrict__ valid,
    const int* __restrict__ prio, const int* __restrict__ nbytes,
    const int* __restrict__ tsend, const int* __restrict__ clamp,
    const int* __restrict__ dst, const int* __restrict__ seq,
    const int* __restrict__ sock, const uint8_t* __restrict__ ctrl,
    const int* __restrict__ balance, int* prio_o, int* sock_o, int* dst_o,
    int* bytes_o, int* seq_o, uint8_t* ctrl_o, int* tsend_o, int* clamp_o,
    uint8_t* valid_o, uint8_t* sendable_o, int* spent_o, int* row_perm_o) {
  __shared__ uint32_t buf[kDeviceBlock];
  __shared__ uint32_t spent_acc;
  const int64_t row = blockIdx.x;
  const int64_t r0 = row * ce;
  const int run = ce / kDeviceBlock;
  const int c0 = threadIdx.x * run;
  int* idx = row_perm_o + r0;
  if (threadIdx.x == 0) spent_acc = 0u;

  // the FIFO order, its column indices in row_perm_o for now
  device_bitonic(idx, ce, [&](int i) {
    return fifo_key(valid[r0 + i] != 0, prio[r0 + i]);
  });

  // permute the thread's run of slots; sum its valid bytes
  uint32_t total = 0;
  for (int c = c0; c < c0 + run; ++c) {
    const int64_t e = r0 + c;
    const int64_t s = r0 + idx[c];
    const bool v = valid[s] != 0;
    const int p = prio[s];
    const bool v_s = (fifo_key(v, p) & kSign) == 0;
    prio_o[e] = p;
    sock_o[e] = sock[s];
    dst_o[e] = dst[s];
    bytes_o[e] = nbytes[s];
    seq_o[e] = seq[s];
    ctrl_o[e] = static_cast<uint8_t>(ctrl[s] != 0);
    tsend_o[e] = rebase_tsend(v, tsend[s], shift);
    clamp_o[e] = rebase_clamp(v, clamp[s], shift);
    valid_o[e] = static_cast<uint8_t>(v_s);
    if (v_s) total += static_cast<uint32_t>(nbytes[s]);
  }

  device_token_gate(valid_o + r0, bytes_o + r0, sendable_o + r0, c0, run,
                    total, balance[row], buf, &spent_acc);

  // routing phase A: the sorted row's (seq, column) order, over seq_o
  device_bitonic(idx, ce, [&](int i) {
    return static_cast<uint32_t>(seq_o[r0 + i]) ^ kSign;
  });
  if (threadIdx.x == 0) spent_o[row] = static_cast<int>(spent_acc);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The wide and cluster builds' arguments; false if a [n_rows, CE] column
// does not start on 16 bytes (they move as 16-byte vectors).
bool wide_args(int shift, const void* const* in, void* const* out,
               WideArgs* args) {
  for (int i = 0; i < 9; ++i)
    if (!aligned16(in[i])) return false;
  for (int i = 0; i < 12; ++i)
    if (i != 10 && !aligned16(out[i])) return false;
  *args = WideArgs{shift,
                   static_cast<const uint8_t*>(in[0]),
                   static_cast<const int*>(in[1]),
                   static_cast<const int*>(in[2]),
                   static_cast<const int*>(in[3]),
                   static_cast<const int*>(in[4]),
                   static_cast<const int*>(in[5]),
                   static_cast<const int*>(in[6]),
                   static_cast<const int*>(in[7]),
                   static_cast<const uint8_t*>(in[8]),
                   static_cast<const int*>(in[9]),
                   static_cast<int*>(out[0]),
                   static_cast<int*>(out[1]),
                   static_cast<int*>(out[2]),
                   static_cast<int*>(out[3]),
                   static_cast<int*>(out[4]),
                   static_cast<uint8_t*>(out[5]),
                   static_cast<int*>(out[6]),
                   static_cast<int*>(out[7]),
                   static_cast<uint8_t*>(out[8]),
                   static_cast<uint8_t*>(out[9]),
                   static_cast<int*>(out[10]),
                   static_cast<int*>(out[11])};
  return true;
}

template <int CE>
cudaError_t launch_wide(int n_rows, int shift, const void* const* in,
                        void* const* out, cudaStream_t stream) {
  using W = Wide<CE>;
  WideArgs a;
  if (!wide_args(shift, in, out, &a)) return cudaErrorMisalignedAddress;
  static bool allowed[64];
  const cudaError_t err =
      allow_shared(egress_rank_wide<CE>, W::kSmem, allowed);
  if (err != cudaSuccess) return err;
  egress_rank_wide<CE><<<n_rows, W::kThreads, W::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <int CE>
cudaError_t launch_cluster(int n_rows, int shift, const void* const* in,
                           void* const* out, cudaStream_t stream) {
  WideArgs a;
  if (!wide_args(shift, in, out, &a)) return cudaErrorMisalignedAddress;
  static bool allowed[64];
  return launch_clusters<ClusterRow<CE>>(egress_rank_cluster<CE>, n_rows, a,
                                         stream, allowed);
}

cudaError_t launch_device(int n_rows, int ce, int shift,
                          const void* const* in, void* const* out,
                          cudaStream_t stream) {
  egress_rank_device<<<n_rows, kDeviceBlock, 0, stream>>>(
      ce, shift, static_cast<const uint8_t*>(in[0]),
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

// The build a row of ce slots runs: 1 warp segments (ce <= 32), 2 a block
// in shared memory (64 <= ce <= 1024), 3 the wide build (ce <= 16384), 4
// the cluster build (ce <= 65536), 5 the device build; 0 for a ce the
// kernel does not take (not a power of two, or not positive).
int build_of(int ce) {
  if (ce <= 0 || (ce & (ce - 1)) != 0) return 0;
  return ce <= 32 ? 1 : ce <= 1024 ? 2 : ce <= kMaxWideCE ? 3
         : ce <= kMaxClusterCE ? 4 : 5;
}

}  // namespace

// The build egress_rank_launch runs for rows of ce slots (see build_of).
extern "C" int egress_rank_build(int ce) { return build_of(ce); }

// The dynamic shared memory a wide-build launch for rows of ce slots
// requests, or a cluster-build launch a block, in bytes (0 for a ce
// another build runs).
extern "C" int egress_rank_shared_bytes(int ce) {
  return ce <= kMaxWideCE ? wide_shared_bytes(ce) : cluster_shared_bytes(ce);
}

// The blocks a cluster of a cluster-build launch for rows of ce slots (0
// for a ce another build runs).
extern "C" int egress_rank_cluster_blocks(int ce) {
  return cluster_blocks(ce);
}

// cudaOccupancyMaxActiveClusters of the cluster build for rows of ce
// slots on the current device (0 for a ce another build runs; minus the
// CUDA error if the query fails).
extern "C" int egress_rank_max_clusters(int ce) {
  switch (ce) {
    case 32768:
      return max_active_clusters<ClusterRow<32768>>(egress_rank_cluster<32768>);
    case 65536:
      return max_active_clusters<ClusterRow<65536>>(egress_rank_cluster<65536>);
    default: return 0;
  }
}

// Inputs: valid (bool), prio, bytes, tsend, clamp, dst, seq, sock (int32),
// ctrl (bool), all [n_rows, ce] row-major; balance [n_rows] int32.
// Outputs: prio, sock, dst, bytes, seq (int32), ctrl (bool), tsend, clamp
// (int32), valid, sendable (bool), spent [n_rows] int32, row_perm int32.
// ce is a power of two. Returns the launch's cudaError_t.
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
  if (build_of(ce) == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  switch (ce) {
    case 1: return static_cast<int>(launch_warp<1>(n_rows, shift, in, out, stream));
    case 2: return static_cast<int>(launch_warp<2>(n_rows, shift, in, out, stream));
    case 4: return static_cast<int>(launch_warp<4>(n_rows, shift, in, out, stream));
    case 8: return static_cast<int>(launch_warp<8>(n_rows, shift, in, out, stream));
    case 16: return static_cast<int>(launch_warp<16>(n_rows, shift, in, out, stream));
    case 32: return static_cast<int>(launch_warp<32>(n_rows, shift, in, out, stream));
    case 2048: return static_cast<int>(launch_wide<2048>(n_rows, shift, in, out, stream));
    case 4096: return static_cast<int>(launch_wide<4096>(n_rows, shift, in, out, stream));
    case 8192: return static_cast<int>(launch_wide<8192>(n_rows, shift, in, out, stream));
    case 16384: return static_cast<int>(launch_wide<16384>(n_rows, shift, in, out, stream));
    case 32768: return static_cast<int>(launch_cluster<32768>(n_rows, shift, in, out, stream));
    case 65536: return static_cast<int>(launch_cluster<65536>(n_rows, shift, in, out, stream));
    default:
      return static_cast<int>(
          build_of(ce) == 2 ? launch_block(n_rows, ce, shift, in, out, stream)
                            : launch_device(n_rows, ce, shift, in, out, stream));
  }
}
