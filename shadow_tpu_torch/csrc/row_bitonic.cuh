// Device code of the egress-stage kernels: the per-row ascending bitonic
// sort of (key, column) pairs that kernel A (egress_rank.cu) and kernel C
// (egress_gate.cu) share, in each of their forms, with the token gate's
// prefix sums, the clock rebase and the FIFO key:
//   - a warp segment (A, CE <= 32): a slot a lane, shuffles;
//   - a block in shared memory (A, 64 <= CE <= 1024): a slot a thread, a
//     barrier a stage;
//   - the wide build (A and C, 2048 <= CE <= 16384; `Wide`, `wide_sort`,
//     `wide_gate`): one block a row, the row's packed 64-bit (key << 32 |
//     column) words in shared memory, cut into runs of 16 slots that a
//     block of at most 256 threads loads into registers a pass at a time
//     (one run a thread up to 4096, four at 16384); strides within a run
//     compare-exchange in registers, strides within a warp's 512 slots
//     through one 64-bit shuffle a slot, and only strides across warps in
//     shared memory, in place, a barrier a stage. The sorted slots' source
//     columns stay in shared memory (16 bits each), and each payload
//     column is staged there and gathered from there. Bound by
//     operations, not bytes: a network of log2(CE)(log2(CE) + 1) / 2
//     stages costs ~3-8 integer operations a slot a stage against the
//     ~35-65 bytes a slot moves (chip_smoke.wide_design_ops counts them).
//     Runs of 32 slots, or 512-thread blocks, took more registers than a
//     thread has and spilled. A block-wide LSD radix sort on the 32-bit
//     key (4 passes of 8 bits) would need fewer operations at these
//     widths, but its ranks and scatters need per-digit counts and stable
//     ranking across the block; the network is the simpler design and was
//     kept;
//   - the cluster build (A and C, CE = 32768 and 65536, past what one
//     block's shared memory holds; `ClusterRow`, `cluster_sort`,
//     `cluster_gate`): a thread-block cluster a row, each block holding
//     a share of consecutive slots as the wide build holds a row (the
//     wide build's layout, runs and passes): 2 blocks of 16384 slots at
//     32768, 8 blocks of 8192 at 65536 (why, below). Strides within a
//     block run the wide build's network (`wide_sort`, `wide_merge`,
//     built with kInCluster), each merge's direction taken from
//     the slot's index in the row (block rank x slots a block + local
//     index); a stride that spans blocks pairs a block with the block
//     stride / (slots a block) ranks away, the lower taking the first
//     half of the local slots and the upper the second, each reading and
//     writing both words of a pair over distributed shared memory, a
//     cluster barrier a stage. Each block stages its share of the payload
//     columns (two side by side, so one 8-byte load fetches both) and
//     gathers its sorted slots' values from whichever block owns the
//     source slot, over distributed shared memory; the token gate
//     (`row_gate`, the wide gate over accessors) starts each block's
//     prefix from the totals of the lower-ranked blocks. Source
//     columns take all 16 bits (65535 at most) and validity comes from
//     the count of valid slots, which the sort puts first;
//   - the device build (A and C, CE >= 131072, past the portable cluster
//     of 8 blocks; `device_bitonic`): one block of 1024 threads a row,
//     the network sorting column indices in place in an output column of
//     device memory, each key read through the inputs, a barrier a stage.
//
// The (key, column) pairs of a row are distinct, so each network's output
// is the stable sort by key, which is what the TPU kernels' whole-tile
// bitonic over (key, column) gives. Arithmetic that may wrap (rebase,
// prefix sum, row sum) is done in uint32, which wraps as the TPU kernels'
// int32 does.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace row_bitonic {

namespace cg = cooperative_groups;

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

// --- loads of inputs read once (kernel C's tile build and the wide builds)

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

// A 16-byte load of the wide build, read once (L2 evict-first), kept in
// program order with the block's barriers: a load the compiler may move
// (read-only, as load_once) would be hoisted across them, and a row's
// columns would then all sit in registers at once.
__device__ __forceinline__ int4 load_staged(const int4* p, uint64_t pol) {
  int4 v;
  asm volatile("ld.global.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

__host__ __device__ constexpr int ilog2(int x) {
  return x > 1 ? 1 + ilog2(x / 2) : 0;
}

// --- the wide build (2048 <= CE <= 16384): one block a row, the row in
// the block's shared memory.
//
// The row's words, one 64-bit (key << 32 | column) word a slot, live in
// shared memory. The row is cut into runs of kV consecutive slots, one a
// virtual thread; a block of kThreads threads plays kPasses virtual
// threads each (thread t plays t, t + kThreads, ...), so no block is
// wider than 256 threads and a thread may hold a run's words in up to 255
// registers. For the strides within a warp's span (32 kV slots) each pass
// loads its run into registers: strides below kV compare-exchange there
// (compile-time indices), the others through one 64-bit shuffle a slot.
// Only the strides across warps go through shared memory, compare-
// exchanged in place with one barrier a stage. Payload columns are staged
// in shared memory after the sort and gathered from there, so no thread
// reads device memory by a sorted index; every column moves in 16-byte
// vectors.

constexpr int kMaxWideCE = 16384;

template <int CE>
struct Wide {
  static_assert(CE >= 2048 && CE <= kMaxWideCE && (CE & (CE - 1)) == 0,
                "the wide build takes power-of-two rows of 2048-16384");
  static constexpr int kV = 16;             // slots a run
  static constexpr int kRuns = CE / kV;     // virtual threads
  static constexpr int kThreads = kRuns < 256 ? kRuns : 256;
  static constexpr int kPasses = kRuns / kThreads;  // runs a thread
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kLog = ilog2(CE);
  static constexpr int kLogV = ilog2(kV);
  static constexpr int kLogSpan = kLogV + 5;  // a warp spans 2^kLogSpan slots
  // dynamic shared memory, 14 B a slot: the row's words (two staged int32
  // columns after the sort), a third column, and the sorted slots' source
  // columns as 16-bit values (`Layout`)
  static constexpr int kSmem = CE * 14;
  // the first slot of this thread's run in pass p
  __device__ static int base(int p) {
    return (p * kThreads + static_cast<int>(threadIdx.x)) * kV;
  }
};

// The dynamic shared memory a wide-build launch requests for rows of ce
// slots (`Wide<ce>::kSmem`, what the launchers request); 0 for a ce the
// wide build does not take.
inline int wide_shared_bytes(int ce) {
  switch (ce) {
    case 2048: return Wide<2048>::kSmem;
    case 4096: return Wide<4096>::kSmem;
    case 8192: return Wide<8192>::kSmem;
    case 16384: return Wide<16384>::kSmem;
    default: return 0;
  }
}

// Where slot i's word lies in the row's word buffer: a thread's run of kV
// words is rotated by its index, so the 16 words of a half warp's run
// writes fall in 16 distinct bank pairs.
template <int kV>
__device__ __forceinline__ int word_at(int i) {
  return i ^ ((i >> ilog2(kV)) & (kV - 1));
}

// Where slot i lies in a staged int32 column: its 16-byte chunk is
// permuted by the slot's pair of 16-slot runs, so the 8 chunks of a
// quarter warp's vector stores fall in 8 distinct groups of banks.
__device__ __forceinline__ int col_at(int i) {
  return i ^ (((i >> 5) & 7) << 2);
}

// The thread's kV bool bytes at p (on 16 bytes) as bits (bit j: byte j
// is not 0).
template <int kV>
__device__ __forceinline__ uint32_t load_bits(const uint8_t* p, uint64_t pol) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < kV / 16; ++q) {
    const int4 v = load_staged(reinterpret_cast<const int4*>(p) + q, pol);
    const uint32_t w[4] = {static_cast<uint32_t>(v.x),
                           static_cast<uint32_t>(v.y),
                           static_cast<uint32_t>(v.z),
                           static_cast<uint32_t>(v.w)};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      bits |= static_cast<uint32_t>(((w[b >> 2] >> (8 * (b & 3))) & 0xffu)
                                    != 0) << (16 * q + b);
  }
  return bits;
}

// The packed word of a slot: key above, column below.
__device__ __forceinline__ uint64_t pack(uint32_t key, int column) {
  return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(column);
}

// The thread's packed words from its valid bits `vin` and its run of
// prio at p (on 16 bytes): slot j's word is (fifo_key, column base + j).
// Each 16-byte vector of prio goes to *stage* too when stage is not null.
template <int kV>
__device__ __forceinline__ void load_keys(uint64_t (&k)[kV], uint32_t vin,
                                          const int* p, int base,
                                          uint64_t pol, int* stage) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    const int4 v = load_staged(reinterpret_cast<const int4*>(p) + q, pol);
    const int pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      k[j] = pack(fifo_key((vin >> j) & 1u, pv[i]), base + j);
    }
    if (stage != nullptr)
      *reinterpret_cast<int4*>(stage + col_at(base + 4 * q)) = v;
  }
}

template <int kV>
__device__ __forceinline__ void store_bits(uint8_t* p, uint32_t bits) {
#pragma unroll
  for (int q = 0; q < kV / 16; ++q) {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      w[b >> 2] |= static_cast<uint32_t>((bits >> (16 * q + b)) & 1u)
                   << (8 * (b & 3));
    reinterpret_cast<int4*>(p)[q] = make_int4(
        static_cast<int>(w[0]), static_cast<int>(w[1]),
        static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
}

// The thread's run of an int32 column of device memory (p its first
// slot, on 16 bytes) into a staged column, 4 slots at a time, slot j's
// value v as f(j, v): the run never sits in registers whole.
template <int kV, class F>
__device__ __forceinline__ void stage_from(int* col, int base, const int* p,
                                           uint64_t pol, F f) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    const int4 v = load_staged(reinterpret_cast<const int4*>(p) + q, pol);
    *reinterpret_cast<int4*>(col + col_at(base + 4 * q)) =
        make_int4(f(4 * q, v.x), f(4 * q + 1, v.y), f(4 * q + 2, v.z),
                  f(4 * q + 3, v.w));
  }
}

// The wide build's dynamic shared memory: `words` the row's CE words;
// after the sort col(0) and col(1) in the words' space and col(2) past it
// (staged int32 columns), and src each sorted slot's source column (bits
// 0-14) and validity (bit 15), 16 bits a slot.
template <int CE>
struct Layout {
  uint64_t* words;
  __device__ explicit Layout(void* smem)
      : words(static_cast<uint64_t*>(smem)) {}
  __device__ int* col(int c) const {
    return reinterpret_cast<int*>(words) + c * CE;
  }
  __device__ uint16_t* src() const {
    return reinterpret_cast<uint16_t*>(reinterpret_cast<int*>(words) +
                                       3 * CE);
  }
};

constexpr uint32_t kSrcValid = 0x8000u;

// Slots at .. at + 3's source columns (at on 4).
__device__ __forceinline__ void src4(const uint16_t* src, int at,
                                     int (&s)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src + at);
  s[0] = static_cast<int>(v.x & 0x7fffu);
  s[1] = static_cast<int>((v.x >> 16) & 0x7fffu);
  s[2] = static_cast<int>(v.y & 0x7fffu);
  s[3] = static_cast<int>((v.y >> 16) & 0x7fffu);
}

// Bit j: slot base + j of the sorted row is valid.
template <int kV>
__device__ __forceinline__ uint32_t valid_bits(const uint16_t* src,
                                               int base) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    const uint2 v = *reinterpret_cast<const uint2*>(src + base + 4 * q);
    bits |= ((v.x >> 15) & 1u) << (4 * q);
    bits |= ((v.x >> 31) & 1u) << (4 * q + 1);
    bits |= ((v.y >> 15) & 1u) << (4 * q + 2);
    bits |= ((v.y >> 31) & 1u) << (4 * q + 3);
  }
  return bits;
}

// The staged column gathered through the run's sorted source columns and
// stored at p (16 bytes aligned), 4 slots at a time.
template <int kV>
__device__ __forceinline__ void gather_to(int* p, const int* col,
                                          const uint16_t* src, int base) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    src4(src, base + 4 * q, s);
    reinterpret_cast<int4*>(p)[q] =
        make_int4(col[col_at(s[0])], col[col_at(s[1])],
                  col[col_at(s[2])], col[col_at(s[3])]);
  }
}

// The run's sorted source columns themselves, stored at p.
template <int kV>
__device__ __forceinline__ void store_src(int* p, const uint16_t* src,
                                          int base) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    src4(src, base + 4 * q, s);
    reinterpret_cast<int4*>(p)[q] = make_int4(s[0], s[1], s[2], s[3]);
  }
}

// Bit j: the staged column at slot base + j's source column is not 0.
template <int kV>
__device__ __forceinline__ uint32_t gather_bits(const int* col,
                                                const uint16_t* src,
                                                int base) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    src4(src, base + 4 * q, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits |= static_cast<uint32_t>(col[col_at(s[i])] != 0) << (4 * q + i);
  }
  return bits;
}

// One compare-exchange of two words: the lower keeps the min when `asc`.
__device__ __forceinline__ void exchange(uint64_t& x, uint64_t& y, bool asc) {
  const bool swap = (x > y) == asc;
  const uint64_t lo = swap ? y : x;
  y = swap ? x : y;
  x = lo;
}

// The first slot of this block's row, row index read at each use (a
// volatile read of %ctaid.x), so the compiler forms each column's address
// where it is used rather than holding a score of them in registers
// across the sort.
template <int CE>
__device__ __forceinline__ int64_t row_start() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(r));
  return static_cast<int64_t>(r) * CE;
}

template <int kV>
__device__ __forceinline__ void put_words(uint64_t* buf, int base,
                                          const uint64_t (&k)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) buf[word_at<kV>(base + j)] = k[j];
}

template <int kV>
__device__ __forceinline__ void get_words(const uint64_t* buf, int base,
                                          uint64_t (&k)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) k[j] = buf[word_at<kV>(base + j)];
}

// The strides below 2^min(ls, kLogSpan) of the merge of size 2^ls over a
// run's words in registers (ls > kLogV): one direction a run.
template <class W>
__device__ __forceinline__ void merge_in_warp(uint64_t (&k)[W::kV], int base,
                                              int ls) {
  constexpr int kV = W::kV;
  const bool asc = (base & (1 << ls)) == 0;
  // the partner slot is the same j of lane ^ (stride / kV)
#pragma unroll
  for (int lt = W::kLogSpan - 1; lt >= W::kLogV; --lt) {
    if (lt >= ls) continue;
    const bool keep_min = ((base & (1 << lt)) == 0) == asc;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const uint64_t p = __shfl_xor_sync(kFull, k[j], 1 << (lt - W::kLogV));
      k[j] = ((k[j] < p) == keep_min) ? k[j] : p;
    }
  }
  // strides within the run
#pragma unroll
  for (int lt = W::kLogV - 1; lt >= 0; --lt) {
#pragma unroll
    for (int j = 0; j < kV; ++j)
      if (!(j & (1 << lt))) exchange(k[j], k[j | (1 << lt)], asc);
  }
}

// The merge of size 2^ls over the block's CE words in `buf` (slot i's at
// word_at(i)), its strides within the block: those across warps in
// shared memory, in place, a barrier a stage, then a pass at a time the
// strides within a warp in registers and shuffles. Each pair's direction
// comes from the row index of its lower slot: its index in the block,
// plus `off` (the row column of the block's first slot) in the cluster
// build (kInCluster; the wide build's off is 0 at compile time). Starts
// with a barrier (the callers' writes of buf are done).
template <int CE, bool kInCluster>
__device__ __forceinline__ void wide_merge(uint64_t* buf, int off, int ls) {
  using W = Wide<CE>;
  constexpr int kV = W::kV;
  const int o = kInCluster ? off : 0;
  const int size = 1 << ls;
  const int top = kInCluster && ls > W::kLog ? W::kLog : ls;
  uint64_t k[kV];
  __syncthreads();
  // the strides across warps, in place: the pairs (a, a + stride) of a
  // stage spread over the block, consecutive across a warp
#pragma unroll 1
  for (int lt = top - 1; lt >= W::kLogSpan; --lt) {
    const int stride = 1 << lt;
#pragma unroll
    for (int i = 0; i < CE / 2 / W::kThreads; ++i) {
      const int p = static_cast<int>(threadIdx.x) + i * W::kThreads;
      const int a = ((p >> lt) << (lt + 1)) | (p & (stride - 1));
      const int wa = word_at<kV>(a), wb = word_at<kV>(a | stride);
      uint64_t x = buf[wa], y = buf[wb];
      exchange(x, y, ((o | a) & size) == 0);
      buf[wa] = x;
      buf[wb] = y;
    }
    __syncthreads();
  }
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    get_words<kV>(buf, base, k);
    merge_in_warp<W>(k, o | base, ls);
    put_words<kV>(buf, base, k);
  }
}

// Ascending bitonic sort of the row's CE packed words, in place in `buf`
// (CE words of shared memory, slot i's at word_at(i)); in the cluster
// build (kInCluster), the first log2(CE) merges of a wider row's network
// over a block's CE words, each directed by its row index off + i.
// Starts with a barrier (the callers' writes of buf are done) and ends
// with one. The merges within a run are unrolled (compile-time
// directions); each wider merge is one trip of a loop whose register and
// shuffle stages are unrolled, which keeps the code small.
template <int CE, bool kInCluster = false>
__device__ __forceinline__ void wide_sort(uint64_t* buf, int off = 0) {
  using W = Wide<CE>;
  constexpr int kV = W::kV;
  constexpr int kInWarp = W::kLog < W::kLogSpan ? W::kLog : W::kLogSpan;
  const int o = kInCluster ? off : 0;
  uint64_t k[kV];
  __syncthreads();
  // a pass at a time: its run's words alone in registers
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    get_words<kV>(buf, base, k);
#pragma unroll
    for (int ls = 1; ls <= W::kLogV; ++ls) {
#pragma unroll
      for (int lt = ls - 1; lt >= 0; --lt) {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (j & (1 << lt)) continue;
          const bool asc = ls < W::kLogV ? (j & (1 << ls)) == 0
                                         : ((o | base) & (1 << ls)) == 0;
          exchange(k[j], k[j | (1 << lt)], asc);
        }
      }
    }
#pragma unroll 1
    for (int ls = W::kLogV + 1; ls <= kInWarp; ++ls)
      merge_in_warp<W>(k, o | base, ls);
    put_words<kV>(buf, base, k);
  }
#pragma unroll 1
  for (int ls = W::kLogSpan + 1; ls <= W::kLog; ++ls)
    wide_merge<CE, kInCluster>(buf, o, ls);
  __syncthreads();
}

// This thread's sorted runs into L.src(): each slot's source column (its
// word's low half) and validity (the key's top bit clear). The caller
// syncs before the words' space is reused.
template <int CE>
__device__ __forceinline__ void sorted_runs(const Layout<CE>& L) {
  using W = Wide<CE>;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
#pragma unroll
    for (int q = 0; q < W::kV / 4; ++q) {
      uint32_t half[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t w = L.words[word_at<W::kV>(base + 4 * q + i)];
        const uint32_t valid =
            (static_cast<uint32_t>(w >> 32) & kSign) ? 0u : kSrcValid;
        half[i >> 1] |= ((static_cast<uint32_t>(w) & 0x7fffu) | valid)
                        << (16 * (i & 1));
      }
      *reinterpret_cast<uint2*>(L.src() + base + 4 * q) =
          make_uint2(half[0], half[1]);
    }
  }
}

// The valid bytes of the run at `base` (through its source columns from
// the staged column `bytes`, `v` its validity bits): their uint32 sum,
// and this lane's exclusive prefix of the warp's sums in *before.
template <int kV>
__device__ __forceinline__ uint32_t run_total(const int* bytes,
                                              const uint16_t* src, int base,
                                              uint32_t v, uint32_t* before) {
  uint32_t total = 0;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    src4(src, base + 4 * q, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((v >> (4 * q + i)) & 1u)
        total += static_cast<uint32_t>(bytes[col_at(s[i])]);
  }
  const int lane = threadIdx.x & 31;
  uint32_t x = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  *before = x - total;
  return x;
}

// The token gate of a sorted row over this thread's runs: the bytes of
// each slot read through its source column from the staged column
// `bytes`, its validity from L.src() (valid_bits); the row's
// inclusive prefix of valid bytes (uint32, wrapping; runs in slot order)
// against `bal` gives each run's sendable bits, handed to emit(base,
// bits); returns the row's sendable bytes, in every thread. `wsum` is
// (kPasses + 1) * kWarps words of shared memory, not reused after the
// call. Every read of `bytes` is done when it returns (it ends with a
// barrier).
template <int CE, class Emit>
__device__ __forceinline__ uint32_t wide_gate(const int* bytes,
                                              const uint16_t* src, int bal,
                                              uint32_t* wsum, Emit emit) {
  using W = Wide<CE>;
  constexpr int kV = W::kV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    uint32_t before;
    const uint32_t x = run_total<kV>(bytes, src, base,
                                     valid_bits<kV>(src, base), &before);
    if (lane == 31) wsum[pass * W::kWarps + warp] = x;
  }
  __syncthreads();
  uint32_t sent = 0;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    const uint32_t v = valid_bits<kV>(src, base);
    // the runs before this one: every earlier pass's, this pass's
    // earlier warps' and lanes'
    uint32_t cum;
    run_total<kV>(bytes, src, base, v, &cum);
    for (int w = 0; w < pass * W::kWarps + warp; ++w) cum += wsum[w];
    uint32_t sendable = 0;
#pragma unroll
    for (int q = 0; q < kV / 4; ++q) {
      int s[4];
      src4(src, base + 4 * q, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        const bool ok_v = (v >> j) & 1u;
        const uint32_t b = static_cast<uint32_t>(bytes[col_at(s[i])]);
        if (ok_v) cum += b;
        const bool ok = ok_v && static_cast<int>(cum) <= bal;
        sendable |= static_cast<uint32_t>(ok) << j;
        if (ok) sent += b;
      }
    }
    emit(base, sendable);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sent += __shfl_xor_sync(kFull, sent, d);
  uint32_t* wsent = wsum + W::kPasses * W::kWarps;
  if (lane == 0) wsent[warp] = sent;
  __syncthreads();
  uint32_t row = 0;
#pragma unroll
  for (int w = 0; w < W::kWarps; ++w) row += wsent[w];
  return row;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device (once a device); returns the CUDA error of the request.
template <class Kernel>
inline cudaError_t allow_shared(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// --- the cluster build (CE = 32768 and 65536): a thread-block cluster a
// row, each block holding kS consecutive slots of it in its shared
// memory, laid out as the wide build lays out a row (`Wide`, `Layout`).
//
// Block r of a row's cluster holds the row's slots [r * kS, (r + 1) *
// kS), so the slots a block loads and stores start at blockIdx.x * kS of
// the flat [n_rows * CE] columns, as a wide-build block's row does
// (row_start<kS>). A word's column is its row column. The first
// log2(kS) merges of the network run within each block (wide_sort,
// directed by the row index); each wider merge first runs its strides
// that span blocks (cross_stage, a cluster barrier before each and after
// the last) and then its strides within a block (wide_merge). The source
// field takes 16 bits, so a row's columns reach 65535: a sorted slot's
// validity is not kept beside it but read from the count of valid slots,
// which the sort puts first.
//
// The geometry, timed on an NVIDIA H100 80GB HBM3 at 700 W (each width
// built both ways, cluster_slots edited in a second tree, and timed in
// turns by egress_probe.py). At 65536, 8 blocks of 8192 slots (112 KB a block,
// two an SM, 30 clusters at once) beat 4 of 16384 (224 KB, one an SM, 30
// clusters) by 9-14 % cold: six stages a network span blocks against
// three, but two blocks an SM hide each other's barrier waits and a
// thread plays two runs, not four. At 32768, 2 blocks of 16384 (66
// clusters) beat 4 of 8192 (62) for C by 2 % on 2^25 slots and for both
// kernels by 20-30 % a launch on PHOLD's 64-row windows, where a row
// finishes sooner on whole SMs; A alone on 2^24 slots ran 3 % faster in
// blocks of 8192. A gather over distributed shared memory costs about
// the same a warp instruction whatever its width and whether or not a
// lane reads its own block (a local path, 16 loads in flight a thread,
// or mapa with ld.shared::cluster gained nothing), so the payload
// columns travel in pairs: that took A from 2.92 to 2.67 ms cold at
// 32768 and from 3.79 to 3.30 at 65536, C from 2.45 to 2.27 and from
// 3.36 to 2.99. Reading the block's own half of a cross-block stage
// through local shared memory made it 1-4 % slower.

constexpr int kMaxClusterCE = 65536;

// The slots a block of the cluster build takes at rows of CE slots.
template <int CE>
constexpr int cluster_slots() {
  return CE <= 32768 ? 16384 : 8192;
}

template <int CE>
struct ClusterRow {
  static constexpr int kS = cluster_slots<CE>();  // slots a block
  static constexpr int kBlocks = CE / kS;   // blocks a cluster
  static_assert(CE > kMaxWideCE && CE <= kMaxClusterCE &&
                    (CE & (CE - 1)) == 0,
                "the cluster build takes rows of 32768 and 65536 slots");
  static_assert(kBlocks >= 2 && kBlocks <= 8,
                "a cluster of 2-8 blocks (the portable cluster size)");
  using W = Wide<kS>;
  static constexpr int kLog = ilog2(CE);
  static constexpr int kSmem = W::kSmem;  // dynamic shared memory a block
};

// Blocks a cluster and dynamic shared memory a block of a cluster-build
// launch for rows of ce slots (0 for a ce the cluster build does not
// take).
inline int cluster_blocks(int ce) {
  switch (ce) {
    case 32768: return ClusterRow<32768>::kBlocks;
    case 65536: return ClusterRow<65536>::kBlocks;
    default: return 0;
  }
}
inline int cluster_shared_bytes(int ce) {
  switch (ce) {
    case 32768: return ClusterRow<32768>::kSmem;
    case 65536: return ClusterRow<65536>::kSmem;
    default: return 0;
  }
}

// The valid bytes of the run at `base` (bytes4(base, q, b) the bytes of
// its slots base + 4q .. base + 4q + 3, `v` its validity bits): their
// uint32 sum, and this lane's exclusive prefix of the warp's sums in
// *before.
template <int kV, class Bytes4>
__device__ __forceinline__ uint32_t run_total_of(Bytes4 bytes4, int base,
                                                 uint32_t v,
                                                 uint32_t* before) {
  uint32_t total = 0;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    uint32_t b[4];
    bytes4(base, q, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((v >> (4 * q + i)) & 1u) total += b[i];
  }
  const int lane = threadIdx.x & 31;
  uint32_t x = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
  }
  *before = x - total;
  return x;
}

// The token gate of a block's sorted slots over this thread's runs: the
// wide build's wide_gate with its reads and its start abstracted (kept
// apart from it: run as the wide build's gate, these accessors made the
// wide build up to 2.8 % slower on the card). valid(base) the validity
// bits of the run at base, bytes4 its bytes (as run_total_of's); the
// row's inclusive prefix of valid bytes (uint32, wrapping; runs in slot
// order), started from first(block total) (the valid bytes of the row's
// slots before the block), against `bal` gives each run's sendable bits,
// handed to emit(base, bits); returns the block's sendable bytes, in
// every thread. `wsum` is (kPasses + 1) * kWarps words of shared memory,
// not reused after the call. Every read through bytes4 is done when it
// returns (it ends with a barrier).
template <int CE, class Valid, class Bytes4, class First, class Emit>
__device__ __forceinline__ uint32_t row_gate(Valid valid, Bytes4 bytes4,
                                             int bal, uint32_t* wsum,
                                             First first, Emit emit) {
  using W = Wide<CE>;
  constexpr int kV = W::kV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    uint32_t before;
    const uint32_t x = run_total_of<kV>(bytes4, base, valid(base), &before);
    if (lane == 31) wsum[pass * W::kWarps + warp] = x;
  }
  __syncthreads();
  uint32_t block_total = 0;
  for (int w = 0; w < W::kPasses * W::kWarps; ++w) block_total += wsum[w];
  const uint32_t start = first(block_total);
  uint32_t sent = 0;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
    const uint32_t v = valid(base);
    // the runs before this one: every earlier pass's, this pass's
    // earlier warps' and lanes'
    uint32_t cum;
    run_total_of<kV>(bytes4, base, v, &cum);
    cum += start;
    for (int w = 0; w < pass * W::kWarps + warp; ++w) cum += wsum[w];
    uint32_t sendable = 0;
#pragma unroll
    for (int q = 0; q < kV / 4; ++q) {
      uint32_t b[4];
      bytes4(base, q, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        const bool ok_v = (v >> j) & 1u;
        if (ok_v) cum += b[i];
        const bool ok = ok_v && static_cast<int>(cum) <= bal;
        sendable |= static_cast<uint32_t>(ok) << j;
        if (ok) sent += b[i];
      }
    }
    emit(base, sendable);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sent += __shfl_xor_sync(kFull, sent, d);
  uint32_t* wsent = wsum + W::kPasses * W::kWarps;
  if (lane == 0) wsent[warp] = sent;
  __syncthreads();
  uint32_t row = 0;
#pragma unroll
  for (int w = 0; w < W::kWarps; ++w) row += wsent[w];
  return row;
}

// One stage of the merge of size 2^ls whose stride 2^lt spans blocks (lt
// >= log2(kS)): the pair (a, a + 2^lt) joins this block and the block
// 2^lt / kS ranks away, at the same local slot. The lower block of the
// two takes the first half of the local slots and the upper the second;
// each reads both words of a pair (its partner's over distributed shared
// memory), compare-exchanges them, ascending where bit ls of the lower
// slot's row index is clear, and writes both back, so a word is read and
// written by one thread a stage. The caller puts a cluster barrier before
// and after it.
template <int CE>
__device__ __forceinline__ void cross_stage(uint64_t* buf, int lt, int ls,
                                            cg::cluster_group cl) {
  using K = ClusterRow<CE>;
  using W = typename K::W;
  constexpr int kS = K::kS, kHalf = kS / 2, kBatch = 8;
  constexpr int kStep = kBatch * W::kThreads;
  static_assert(kHalf % kStep == 0, "whole batches");
  const int rank = static_cast<int>(cl.block_rank());
  const int apart = (1 << lt) / kS;
  const int lo_rank = rank & ~apart;
  uint64_t* lo = cl.map_shared_rank(buf, lo_rank);
  uint64_t* hi = cl.map_shared_rank(buf, lo_rank | apart);
  const bool asc = ((lo_rank * kS) & (1 << ls)) == 0;
  const int first = (rank & apart) ? kHalf : 0;
#pragma unroll 1
  for (int i0 = first; i0 < first + kHalf; i0 += kStep) {
    // a batch of loads in flight before its exchanges
    uint64_t x[kBatch], y[kBatch];
    int w[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      w[b] = word_at<W::kV>(i0 + b * W::kThreads +
                            static_cast<int>(threadIdx.x));
      x[b] = lo[w[b]];
      y[b] = hi[w[b]];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      exchange(x[b], y[b], asc);
      lo[w[b]] = x[b];
      hi[w[b]] = y[b];
    }
  }
}

// Ascending bitonic sort of a row's CE packed words over its cluster,
// each block's kS in place in its `buf` (slot i's at word_at(i)). Starts
// with a barrier (the callers' writes of buf are done) and ends with one;
// no block reads another's buf after it.
template <int CE>
__device__ __forceinline__ void cluster_sort(uint64_t* buf,
                                             cg::cluster_group cl) {
  using K = ClusterRow<CE>;
  using W = typename K::W;
  const int off = static_cast<int>(cl.block_rank()) * K::kS;
  wide_sort<K::kS, true>(buf, off);
#pragma unroll 1
  for (int ls = W::kLog + 1; ls <= K::kLog; ++ls) {
#pragma unroll 1
    for (int lt = ls - 1; lt >= W::kLog; --lt) {
      cl.sync();
      cross_stage<CE>(buf, lt, ls, cl);
    }
    cl.sync();
    wide_merge<K::kS, true>(buf, off, ls);
  }
  __syncthreads();
}

// This thread's sorted runs into L.src() as 16-bit source columns (row
// columns, up to 65535), and the number of its valid slots (key's top
// bit clear) added to *n_valid (shared memory, zeroed before a barrier
// the call follows; read it after the next). The row's valid slots come
// first in the sorted order, so the block's are the first *n_valid of
// its own. The caller syncs before the words' space is reused.
template <int kS>
__device__ __forceinline__ void sorted_columns(const Layout<kS>& L,
                                               uint32_t* n_valid) {
  using W = Wide<kS>;
  uint32_t n = 0;
#pragma unroll 1
  for (int pass = 0; pass < W::kPasses; ++pass) {
    const int base = W::base(pass);
#pragma unroll
    for (int q = 0; q < W::kV / 4; ++q) {
      uint32_t half[2] = {0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint64_t w = L.words[word_at<W::kV>(base + 4 * q + i)];
        n += (static_cast<uint32_t>(w >> 32) & kSign) ? 0u : 1u;
        half[i >> 1] |= (static_cast<uint32_t>(w) & 0xffffu)
                        << (16 * (i & 1));
      }
      *reinterpret_cast<uint2*>(L.src() + base + 4 * q) =
          make_uint2(half[0], half[1]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
  if ((threadIdx.x & 31) == 0) atomicAdd(n_valid, n);
}

// Bit j: the block's sorted slot base + j is valid (one of its first
// n_valid).
template <int kV>
__device__ __forceinline__ uint32_t prefix_bits(int n_valid, int base) {
  const int n = n_valid - base;
  return n <= 0 ? 0u : n >= kV ? (1u << kV) - 1u : (1u << n) - 1u;
}

// Slots at .. at + 3's 16-bit source columns (at on 4).
__device__ __forceinline__ void columns4(const uint16_t* src, int at,
                                         int (&s)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(src + at);
  s[0] = static_cast<int>(v.x & 0xffffu);
  s[1] = static_cast<int>(v.x >> 16);
  s[2] = static_cast<int>(v.y & 0xffffu);
  s[3] = static_cast<int>(v.y >> 16);
}

// A staged column's value at row column s: the block s / kS of the
// cluster holds it at its slot s % kS, over distributed shared memory.
template <int kS>
__device__ __forceinline__ int staged_at(cg::cluster_group cl,
                                         int* col, int s) {
  return *cl.map_shared_rank(col + col_at(s & (kS - 1)), s >> ilog2(kS));
}

// The staged column `col` (each block's own share) gathered through the
// run's sorted source columns and stored at p (16 bytes aligned), 4
// slots at a time.
template <int kS, int kV>
__device__ __forceinline__ void gather_cluster(cg::cluster_group cl,
                                               int* p, int* col,
                                               const uint16_t* src,
                                               int base) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    columns4(src, base + 4 * q, s);
    reinterpret_cast<int4*>(p)[q] = make_int4(staged_at<kS>(cl, col, s[0]),
                                              staged_at<kS>(cl, col, s[1]),
                                              staged_at<kS>(cl, col, s[2]),
                                              staged_at<kS>(cl, col, s[3]));
  }
}

// Bit j: the staged column at the source of the block's sorted slot base
// + j is not 0.
template <int kS, int kV>
__device__ __forceinline__ uint32_t gather_bits_cluster(
    cg::cluster_group cl, int* col, const uint16_t* src, int base) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    columns4(src, base + 4 * q, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits |= static_cast<uint32_t>(staged_at<kS>(cl, col, s[i]) != 0)
              << (4 * q + i);
  }
  return bits;
}

// Two int32 columns of device memory (the thread's runs at p and r, on
// 16 bytes) staged side by side into `pairs` (8 bytes a slot, slot i's at
// word_at(i), the row's word buffer after the sort), slot j's values as
// f(j, x) and g(j, y): a gather then fetches both in one 8-byte load over
// distributed shared memory, which costs what a 4-byte one does.
template <int kV, class F, class G>
__device__ __forceinline__ void stage_pair_from(int2* pairs, int base,
                                                const int* p, const int* r,
                                                uint64_t pol, F f, G g) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    const int4 x = load_staged(reinterpret_cast<const int4*>(p) + q, pol);
    const int4 y = load_staged(reinterpret_cast<const int4*>(r) + q, pol);
    const int xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      pairs[word_at<kV>(base + j)] = make_int2(f(j, xs[i]), g(j, ys[i]));
    }
  }
}

// The staged pairs gathered through the run's sorted source columns, one
// 8-byte load a slot over distributed shared memory, their first values
// stored at p and their second at r (16 bytes aligned).
template <int kS, int kV>
__device__ __forceinline__ void gather_pair_cluster(cg::cluster_group cl,
                                                    int* p, int* r,
                                                    int2* pairs,
                                                    const uint16_t* src,
                                                    int base) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    columns4(src, base + 4 * q, s);
    int2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = *cl.map_shared_rank(pairs + word_at<kV>(s[i] & (kS - 1)),
                                 s[i] >> ilog2(kS));
    reinterpret_cast<int4*>(p)[q] = make_int4(v[0].x, v[1].x, v[2].x,
                                              v[3].x);
    reinterpret_cast<int4*>(r)[q] = make_int4(v[0].y, v[1].y, v[2].y,
                                              v[3].y);
  }
}

// The run's 16-bit source columns themselves, stored at p.
template <int kV>
__device__ __forceinline__ void store_columns(int* p, const uint16_t* src,
                                              int base) {
#pragma unroll
  for (int q = 0; q < kV / 4; ++q) {
    int s[4];
    columns4(src, base + 4 * q, s);
    reinterpret_cast<int4*>(p)[q] = make_int4(s[0], s[1], s[2], s[3]);
  }
}

// The token gate of a row over its cluster: each block's sorted slots,
// the first n_valid of them valid, their bytes read back from the
// thread's own runs of the output column `bytes_o` (this block's first
// slot; written by the same thread before the call). Each block's prefix
// starts from the uint32 sum of the lower ranks' totals (read over
// distributed shared memory from `xs[0]`); the row's sendable bytes go to
// *spent from rank 0. `xs` is two words of shared memory. Its first
// cluster barrier follows every earlier read of another block's shared
// memory; it ends with one after every read of another block's xs but
// rank 0's of xs[1], so the caller ends with one more.
template <int CE, class Emit>
__device__ __forceinline__ void cluster_gate(cg::cluster_group cl,
                                             const int* bytes_o, int n_valid,
                                             int bal, uint32_t* wsum,
                                             uint32_t* xs, int* spent,
                                             Emit emit) {
  using K = ClusterRow<CE>;
  constexpr int kV = K::W::kV;
  const int rank = static_cast<int>(cl.block_rank());
  const uint32_t sent = row_gate<K::kS>(
      [&](int base) { return prefix_bits<kV>(n_valid, base); },
      [&](int base, int q, uint32_t (&b)[4]) {
        const int4 v = reinterpret_cast<const int4*>(bytes_o + base)[q];
        b[0] = static_cast<uint32_t>(v.x);
        b[1] = static_cast<uint32_t>(v.y);
        b[2] = static_cast<uint32_t>(v.z);
        b[3] = static_cast<uint32_t>(v.w);
      },
      bal, wsum,
      [&](uint32_t total) {
        if (threadIdx.x == 0) xs[0] = total;
        cl.sync();
        uint32_t before = 0;
        for (int r = 0; r < rank; ++r) before += *cl.map_shared_rank(xs, r);
        return before;
      },
      emit);
  if (threadIdx.x == 0) xs[1] = sent;
  cl.sync();
  if (rank == 0 && threadIdx.x == 0) {
    uint32_t row = 0;
    for (int r = 0; r < K::kBlocks; ++r) row += *cl.map_shared_rank(xs + 1, r);
    *spent = static_cast<int>(row);
  }
}

// The launch configuration of `blocks` blocks of a cluster-build kernel
// (K = ClusterRow<CE>): K::kBlocks a cluster, K::W::kThreads threads and
// K::kSmem of dynamic shared memory a block; `attr` holds the cluster
// dimension.
template <class K>
inline cudaLaunchConfig_t cluster_config(unsigned blocks,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(K::W::kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K::kBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A cluster-build launch of `kernel` over n_rows rows, a cluster a row,
// its dynamic shared memory requested once a device through `done`.
// Returns the CUDA error of the request, of the launch, or of
// cudaGetLastError: a cluster launch the card refuses is reported, never
// replaced by another build.
template <class K, class Kernel, class Arg>
inline cudaError_t launch_clusters(Kernel kernel, int n_rows, const Arg& a,
                                   cudaStream_t stream, bool (&done)[64]) {
  cudaError_t err = allow_shared(kernel, K::kSmem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<K>(
      static_cast<unsigned>(n_rows) * K::kBlocks, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of a cluster-build kernel on the
// current device: the clusters (rows) that run at once; minus the CUDA
// error if the query fails.
template <class K, class Kernel>
inline int max_active_clusters(Kernel kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<K>(K::kBlocks, nullptr,
                                                   &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err != cudaSuccess ? -static_cast<int>(err) : n;
}

// --- the device build (CE >= 131072, past the portable cluster of 8
// blocks): one block of kDeviceBlock threads a row, the row in device
// memory.

constexpr int kDeviceBlock = 1024;

// Ascending bitonic sort of a row's columns 0..n-1 by (key(i), i) into
// `idx` (n words of device memory, one row of an output column): the
// network moves the column indices only and reads each one's key through
// `key` (from the inputs, or from an output column written before the
// call). Each thread takes n / (2 * kDeviceBlock) compare-exchanges a
// stage, with a block barrier a stage; n is a power of two >= 2 *
// kDeviceBlock. Starts with a barrier (the caller's last reads of `idx`
// and its writes to what `key` reads are done) and ends synchronised.
template <class Key>
__device__ __forceinline__ void device_bitonic(int* idx, int n, Key key) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kDeviceBlock) idx[i] = i;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += kDeviceBlock) {
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
// the thread's own run (thread t owns slots [t * n / kDeviceBlock, (t + 1)
// * n / kDeviceBlock)); returns the sum over the earlier threads' runs, in
// uint32. `buf` is kDeviceBlock words of shared memory. Ends synchronised.
__device__ __forceinline__ uint32_t device_exclusive_prefix(uint32_t* buf,
                                                            uint32_t x) {
  return block_inclusive_scan(buf, x, kDeviceBlock, threadIdx.x) - x;
}

// The token gate over this thread's run of a sorted row, slots [c0, c0 +
// run) of the row's valid_o and bytes_o (written by this thread), `total`
// the run's valid bytes: the row's inclusive prefix of valid bytes against
// `bal` gives sendable_o, and the run's sendable bytes are added to
// *spent_acc (shared memory, zeroed before a barrier the call follows).
// `buf` is kDeviceBlock words of shared memory. Read *spent_acc only after
// a barrier.
__device__ __forceinline__ void device_token_gate(
    const uint8_t* valid_o, const int* bytes_o, uint8_t* sendable_o, int c0,
    int run, uint32_t total, int bal, uint32_t* buf, uint32_t* spent_acc) {
  uint32_t cum = device_exclusive_prefix(buf, total);
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
