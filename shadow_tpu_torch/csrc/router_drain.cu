// Kernel E of the window step: the destination router's drain (CoDel AQM,
// then the down-bandwidth relay) of one window, for Hopper (sm_90a): a
// host a lane, a block a warp and a tile of 32 hosts whose rows it
// stages in shared memory by asynchronous copy.
//
// Replaces: shadow_tpu/tpu/codel.py, router_drain (a vmapped
// lax.fori_loop of 4*K + 16 micro-steps, not a Pallas kernel; the JAX
// package runs it after the routing stage of all three window-step
// kernels). Its plain PyTorch version is `tpu/codel.router_drain_plain`,
// which this kernel equals bitwise.
//
// Per host (one row of K ingress entries, arrival ascending with I32_MAX
// padding) it runs the micro-step machine of `_route_one_host`:
//   - while no pop chain is active, the relay-cached packet's resume (the
//     lazy 1 ms token refill and the conformance re-check), else a chain
//     start at the head entry's arrival, else the host halts;
//   - inside a chain, one CoDel pop (`_codel_pop_step`: the standing-delay
//     check, the store-mode drop, the drop-mode control law from the int32
//     CTRL_TABLE, the drop loop), then the relay's token gate: a delivered
//     candidate the bucket cannot afford is cached with its resume time.
// `halted` is sticky and a halted host changes nothing, so the thread
// stops at it: that equals the fixed trip count. Each iteration is exactly
// one of halt / resume / chain start / pop, decided by the phase it starts
// in, so the machine is written as branches, not as the JAX selects.
//
// Every add, subtract and multiply that can wrap is done in uint32 and
// cast back (JAX's int32 wraps; C++ signed overflow is undefined, and the
// saturating resume `r = now + w; r < now` must not fold into `w < 0`).
// Every division has a positive divisor (dn_rate >= 1, 1 ms); a
// dividend that can be negative goes through floordiv, as jnp's // rounds
// down.
//
// The queue count n_pushed (searchsorted(arrival, now, right)) is a
// pointer that walks the sorted row forward (and back, should `now` ever
// decrease), carrying the wrapping byte sum of the entries it passed: the
// JAX prefix-sum column is never built. The valid entries (arrival <
// I32_MAX) of a sorted row are a prefix of it, so "eidx < n_valid and the
// head arrives before the window ends" is "eidx < K and A[eidx] <
// window_ns" (window_ns <= I32_MAX): the row is never counted.
//
// What bounds it on the card: bytes. The arrival/size rows in and
// status/deliver_t out (16 B a slot), 13 state fields in and out (86 B a
// host), dn_rate/dn_cap in and co_mask/co_t/cached_idx out (17 B a host):
// at N=32768, K=32, 20.2 MB, 6.0 us at 3.35 TB/s. The serial chain of
// micro-steps (at most 4*K + 16 a host, data-dependent) is short on the
// main path: no thread of chip_smoke.py's AQM world runs more than 4.
// Rows whose buckets are tiny run tens of micro-steps, and the warps'
// latency then sets the time: warps resident on an SM are what hides it.
//
// The design. A block is one warp and one tile of 32 hosts (fewer for
// rows wider than 907 words), a host a lane, the grid a block a tile.
// Blocks are independent and retire as soon as their own hosts halt, so
// a long chain holds only its own warp, and the blocks resident on an SM
// (24 at K=32) overlap one tile's machines with another's loads.
//   - Staging: a tile's rows of arrival and size are one contiguous slab
//     of each input. All 32 lanes issue 4-byte cp.async copies of it into
//     shared memory, lanes on consecutive words, so the warp has its whole
//     slab in flight (8 KB at K=32) where a thread used to hold a few
//     words, and no register holds it on the way. Any storage offset
//     takes word copies. A row's stride there is odd (K for an odd K,
//     K + 1 for an even one), so the 32 lanes reading column j of their
//     rows hit 32 banks; (row, column) is stepped by counters, never by a
//     division a word. The host's state fields load into registers while
//     the slab lands.
//   - Results: the warp writes the tile's status/deliver_t slab as
//     kQueued/I32_MAX with coalesced stores that drain while the slab
//     lands; after __syncwarp (which orders them first), each lane's
//     machine writes the few entries it consumes straight to device
//     memory. The 13 state fields and the 5 per-host outputs are one
//     coalesced access a field a warp.
// Built, measured on an H100 (PERF.md, PR 17) and taken out: a second
// input stage on a persistent grid (the next tile's slab landing during
// the machines) and status/deliver_t built in shared memory, which cost
// shared memory and so warps an SM (rows with long chains ran slower);
// blocks of 2, 4 or 8 warps, which hold an SM's room until their slowest
// warp halts; 16-byte fill stores, 16-byte copies into rows of K + 4 and
// prefetched state, which bought nothing.
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 52 registers, no
// spill, no stack, no static shared memory. Dynamic shared memory a
// block: 2 arrays x 32 rows x the stride, 8448 B at K=32, so 24 blocks
// fit an SM's 228 KB (1 KB reserved a block); wider rows halve the tile,
// down to one host of K = 29055 (kMaxStagedK: 232440 B).
//
// Two builds of the one kernel body (router_drain_kernel's template
// parameter): "staged", as above, for K up to kMaxStagedK, and "device"
// for wider rows, whose machines read their rows straight from the [N, K]
// inputs in device memory (a tile of 32 hosts, no shared memory, no
// staging). A row in device memory is read by its own lane, entry after
// entry as its chain advances: the lanes' loads do not coalesce, but a
// row that wide is long in bytes, not in the entries a window consumes.
// The launcher picks the build by K; `want` forces one (the tests hold the
// device build to the staged one at K the staged build takes).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMs = 1000000;
constexpr int kTarget = 10 * kMs;
constexpr int kInterval = 100 * kMs;
constexpr int kI32Max = 0x7fffffff;
constexpr int kMtu = 1500;
constexpr int kMaxCount = 4096;
constexpr int kWarp = 32;
constexpr int kMaxTile = 32;        // hosts a tile: a warp, one a lane
constexpr int kMaxStagedK = 29055;  // the widest row a block stages
constexpr size_t kMaxSmem = 232448;  // shared memory a block may use

constexpr int kQueued = 0;
constexpr int kDelivered = 1;
constexpr int kDropped = 2;
constexpr int kTaken = 3;

constexpr int kStore = 0;
constexpr int kDrop = 1;

constexpr int kStart = 0;
constexpr int kAfterStoreDrop = 1;
constexpr int kDropLoop = 2;
constexpr int kIdle = 3;

__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
// floor division for a divisor > 0 (the modulo this kernel takes is of a
// non-negative span, where C's % is jnp's)
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b < 0) ? q - 1 : q;
}

// The 13 fields of RouterDownState the drain rewrites (codel.DRAIN_FIELDS)
struct StateIn {
  const int* mode;
  const bool* has_ie;
  const int* ie;
  const bool* has_dn;
  const int* dn;
  const int* cur;
  const int* prev;
  const int* bal;
  const int* lref;
  const bool* has_c;
  const int* c_size;
  const int* resume;
  const int* dropped;
};
struct StateOut {
  int* mode;
  bool* has_ie;
  int* ie;
  bool* has_dn;
  int* dn;
  int* cur;
  int* prev;
  int* bal;
  int* lref;
  bool* has_c;
  int* c_size;
  int* resume;
  int* dropped;
};

// A host's scalars: its bucket and the 13 state fields
struct Host {
  int rate, cap, mode, ie, dn, cur, prev, bal, lref, c_size, resume, dropped;
  bool has_ie, has_dn, has_c;
};

__device__ __forceinline__ Host load_host(const StateIn& in,
                                          const int* __restrict__ dn_rate,
                                          const int* __restrict__ dn_cap,
                                          int h) {
  Host s;
  s.rate = dn_rate[h];
  s.cap = dn_cap[h];
  s.mode = in.mode[h];
  s.has_ie = in.has_ie[h];
  s.ie = in.ie[h];
  s.has_dn = in.has_dn[h];
  s.dn = in.dn[h];
  s.cur = in.cur[h];
  s.prev = in.prev[h];
  s.bal = in.bal[h];
  s.lref = in.lref[h];
  s.has_c = in.has_c[h];
  s.c_size = in.c_size[h];
  s.resume = in.resume[h];
  s.dropped = in.dropped[h];
  return s;
}

struct Bucket {
  int rate;
  int cap;
  // lazy 1 ms refill at `now`, elapsed clamped before multiplying
  __device__ __forceinline__ void refill(int bal, int lref, int now,
                                         int& bal2, int& lref2) const {
    const int span = max(sub(now, lref), 0);
    const int num = span / kMs;
    const int headroom = max(sub(cap, bal), 0);
    const int need = floordiv(sub(add(headroom, rate), 1), rate);
    bal2 = sub(cap, max(sub(headroom, mul(rate, min(num, need))), 0));
    lref2 = sub(max(now, lref), span % kMs);
  }
  // the refill boundary that affords `required` more bytes, saturating
  // just below I32_MAX when the sum wraps
  __device__ __forceinline__ int wait_until(int now, int required,
                                            int lref) const {
    const int n_refills = floordiv(sub(add(required, rate), 1), rate);
    const int w = add(sub(kMs, sub(now, lref)), mul(sub(n_refills, 1), kMs));
    const int r = add(now, w);
    return (r < now) ? kI32Max - kMs : r;
  }
};

// One host's drain over its staged row A/S (K entries), recording into
// its staged status/deliver_t row ST/DT; leaves the new state in `s`.
__device__ __forceinline__ void drain_host(
    Host& s, const int* A, const int* S, int* ST, int* DT, int k,
    int window_ns, const int* __restrict__ table, bool& co_mask, int& co_t,
    int& c_idx) {
  const Bucket bucket{s.rate, s.cap};
  int mode = s.mode, ie = s.ie, dn = s.dn;
  bool has_ie = s.has_ie, has_dn = s.has_dn, has_c = s.has_c;
  int cur = s.cur, prev = s.prev;
  int bal = s.bal, lref = s.lref;
  int c_size = s.c_size, resume = s.resume;
  int dropped = s.dropped;
  int eidx = 0, cbytes = 0, T = 0, phase = kIdle;
  c_idx = -1;
  co_mask = false;
  co_t = 0;

  int n_pushed = 0;  // entries with arrival <= the chain time
  int pushed = 0;    // their real bytes, wrapping

  const int trips = 4 * k + 16;
  for (int it = 0; it < trips; ++it) {
    if (phase == kIdle) {
      if (has_c && resume < window_ns) {
        // the cached packet's resume: refill, conformance re-check
        int r_bal, r_lref;
        bucket.refill(bal, lref, resume, r_bal, r_lref);
        lref = r_lref;
        if (c_size <= r_bal) {
          bal = sub(r_bal, c_size);
          if (c_idx >= 0) {
            ST[c_idx] = kDelivered;
            DT[c_idx] = resume;
          } else {
            co_mask = true;
            co_t = resume;
          }
          has_c = false;
          c_idx = -1;
          T = resume;
          phase = kStart;
        } else {
          bal = r_bal;
          resume = bucket.wait_until(resume, sub(c_size, r_bal), r_lref);
        }
        continue;
      }
      if (!has_c && eidx < k && A[eidx] < window_ns) {
        // an idle chain starts at the head entry's arrival
        T = A[eidx];
        phase = kStart;
        continue;
      }
      break;  // halted: no later micro-step writes anything
    }

    // one CoDel pop at chain time T
    const int now = T;
    while (n_pushed < k && A[n_pushed] <= now) {
      if (A[n_pushed] < kI32Max) pushed = add(pushed, S[n_pushed]);
      ++n_pushed;
    }
    while (n_pushed > 0 && A[n_pushed - 1] > now) {
      --n_pushed;
      if (A[n_pushed] < kI32Max) pushed = sub(pushed, S[n_pushed]);
    }
    const bool empty = eidx >= n_pushed;
    const int e = min(eidx, k - 1);
    const int e_size = S[e];
    const int total_after = sub(sub(pushed, cbytes), e_size);

    const bool below = sub(now, A[e]) < kTarget || total_after <= kMtu;
    const bool ok = !below && has_ie && now >= ie;
    if (!below && !has_ie) ie = add(now, kInterval);
    bool any_empty = false, deliver = false, drop = false;
    int n_phase = phase;
    if (phase == kStart) {
      if (empty) {
        any_empty = true;
        mode = kStore;
      } else if (!ok) {
        deliver = true;
        mode = kStore;
      } else if (mode == kStore) {
        // store-mode drop: count bookkeeping, enter the after-drop phase
        const bool recently =
            has_dn && max(sub(now, dn), 0) < kInterval * 16;
        const int delta = sub(cur, prev);
        const int new_cur = (recently && delta > 1) ? delta : 1;
        cur = prev = new_cur;
        dn = add(now, __ldg(table + min(max(new_cur, 1), kMaxCount)));
        has_dn = true;
        mode = kDrop;
        n_phase = kAfterStoreDrop;
        drop = true;
      } else if (mode == kDrop) {
        if (has_dn && now >= dn) {
          cur = add(cur, 1);
          n_phase = kDropLoop;
          drop = true;
        } else {
          deliver = true;
        }
      }
    } else if (phase == kAfterStoreDrop) {
      if (empty) any_empty = true;
      else deliver = true;  // whatever its ok flag
    } else {  // kDropLoop
      if (empty) {
        any_empty = true;
      } else {
        const int dn_upd =
            ok ? add(dn, __ldg(table + min(max(cur, 1), kMaxCount))) : dn;
        dn = dn_upd;
        if (ok && has_dn && now >= dn_upd) {
          cur = add(cur, 1);
          drop = true;
        } else {
          deliver = true;
          if (!ok) mode = kStore;
        }
      }
    }
    has_ie = !below && !any_empty;

    int rec = drop ? kDropped : kQueued;
    if (deliver) {
      // the relay's token gate
      int g_bal, g_lref;
      bucket.refill(bal, lref, now, g_bal, g_lref);
      lref = g_lref;
      if (e_size <= g_bal) {
        bal = sub(g_bal, e_size);
        rec = kDelivered;
        n_phase = kStart;  // a forwarded pop restarts the chain
      } else {
        bal = g_bal;
        rec = kTaken;
        has_c = true;
        c_size = e_size;
        c_idx = e;
        resume = bucket.wait_until(now, sub(e_size, g_bal), g_lref);
        n_phase = kIdle;
      }
    } else if (any_empty) {
      n_phase = kIdle;
    }
    phase = n_phase;
    if (drop || deliver) {
      ST[e] = rec;
      if (rec == kDelivered) DT[e] = now;
      if (drop) dropped = add(dropped, 1);
      eidx += 1;
      cbytes = add(cbytes, e_size);
    }
  }
  s.mode = mode;
  s.has_ie = has_ie;
  s.ie = ie;
  s.has_dn = has_dn;
  s.dn = dn;
  s.cur = cur;
  s.prev = prev;
  s.bal = bal;
  s.lref = lref;
  s.has_c = has_c;
  s.c_size = c_size;
  s.resume = resume;
  s.dropped = dropped;
}

// ---------------------------------------------------------------------------
// staging: asynchronous copies into shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the copies of one input slab (`cnt` words at `src`) into `dst`,
// slab element i (row i / K, column i % K) at word (i / K) * stride + i %
// K: one 4-byte copy a word, lane l on words l, l + 32, ..., its (column,
// shared word) stepped by counters, never by a division a word.
__device__ __forceinline__ void stage_slab(int* dst,
                                           const int* __restrict__ src,
                                           int cnt, int k, int stride,
                                           int lane) {
  const int pad = stride - k;
  const int dcol = kWarp % k, dpos = kWarp + pad * (kWarp / k);
  int col = lane % k, pos = lane + pad * (lane / k);
  for (int i = lane; i < cnt; i += kWarp) {
    cp_async4(dst + pos, src + i);
    col += dcol;
    pos += dpos;
    if (col >= k) {
      col -= k;
      pos += pad;
    }
  }
}

// the builds, as the launcher takes them (`want`) and reports them
constexpr int kBuildByK = 0;
constexpr int kBuildStaged = 1;
constexpr int kBuildDevice = 2;

// The launch's geometry (`choose_geometry`)
struct Geometry {
  int tile;     // hosts a tile (a power of two, at most 32)
  int stride;   // a staged row, in words: K for an odd K, else K + 1
  int words;    // one staged array of a tile, in words
  size_t smem;  // bytes a block: its two staged arrays (0: device build)
  int build;    // kBuildStaged or kBuildDevice
};

// A launch's arguments
struct Args {
  int n, k, window_ns;
  Geometry g;
  const int* arrival;
  const int* size;
  const int* dn_rate;
  const int* dn_cap;
  const int* table;
  StateIn in;
  StateOut out;
  int* status;
  int* deliver_t;
  bool* co_mask;
  int* co_t;
  int* cached_idx;
};

// A block is a warp and a tile: stage its rows (the staged build), fill
// its outputs, run its machines over the staged rows or, in the device
// build, over the rows in device memory.
template <bool kStaged>
__global__ void __launch_bounds__(kWarp) router_drain_kernel(const Args a) {
  extern __shared__ __align__(16) int smem[];
  const int k = a.k;
  const Geometry g = a.g;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * g.tile;
  const int rows = min(g.tile, a.n - first);
  const int cnt = rows * k;
  const int64_t off = static_cast<int64_t>(first) * k;

  const int* A = a.arrival + off;
  const int* S = a.size + off;
  int stride = k;
  if (kStaged) {
    stage_slab(smem, A, cnt, k, g.stride, lane);
    stage_slab(smem + g.words, S, cnt, k, g.stride, lane);
    cp_async_commit();
    A = smem;
    S = smem + g.words;
    stride = g.stride;
  }
  Host host{};
  if (lane < rows) host = load_host(a.in, a.dn_rate, a.dn_cap, first + lane);
  // every entry queued and undelivered until a machine says otherwise;
  // the stores drain while the slab lands
  int* const st = a.status + off;
  int* const dt = a.deliver_t + off;
  for (int i = lane; i < cnt; i += kWarp) {
    st[i] = kQueued;
    dt[i] = kI32Max;
  }
  if (kStaged) cp_async_wait_all();
  __syncwarp();  // the slab in every lane's view, the fills before

  if (lane >= rows) return;
  const int h = first + lane;
  const int64_t row = static_cast<int64_t>(lane) * stride;
  bool co_mask;
  int co_t, c_idx;
  drain_host(host, A + row, S + row, st + lane * k, dt + lane * k, k,
             a.window_ns, a.table, co_mask, co_t, c_idx);
  const StateOut& out = a.out;
  out.mode[h] = host.mode;
  out.has_ie[h] = host.has_ie;
  out.ie[h] = host.ie;
  out.has_dn[h] = host.has_dn;
  out.dn[h] = host.dn;
  out.cur[h] = host.cur;
  out.prev[h] = host.prev;
  out.bal[h] = host.bal;
  out.lref[h] = host.lref;
  out.has_c[h] = host.has_c;
  out.c_size[h] = host.c_size;
  out.resume[h] = host.resume;
  out.dropped[h] = host.dropped;
  a.co_mask[h] = co_mask;
  a.co_t[h] = co_t;
  a.cached_idx[h] = c_idx;
}

// The launch's geometry over n rows of K words, in the build `want` asks
// for (kBuildByK: staged up to kMaxStagedK, device beyond). Staged: a tile
// of 32 hosts where its two staged arrays fit a block's shared memory,
// halved for wider rows (one host of K = 29055 takes 232440 B). Device: a
// tile of 32 hosts, no shared memory. A block a tile. False for a K the
// build does not take.
bool choose_geometry(int n, int k, int want, Geometry& g, int& blocks) {
  if (k < 1) return false;
  if (want == kBuildByK) want = k <= kMaxStagedK ? kBuildStaged : kBuildDevice;
  if (want == kBuildStaged && k <= kMaxStagedK) {
    g.stride = k | 1;
    g.tile = kMaxTile;
    while (2 * sizeof(int) * static_cast<size_t>(g.tile) * g.stride >
           kMaxSmem)
      g.tile /= 2;
    g.words = g.tile * g.stride;
    g.smem = 2 * sizeof(int) * static_cast<size_t>(g.words);
  } else if (want == kBuildDevice) {
    g.stride = k;
    g.tile = kMaxTile;
    g.words = 0;
    g.smem = 0;
  } else {
    return false;
  }
  g.build = want;
  blocks = static_cast<int>((static_cast<int64_t>(n) + g.tile - 1) / g.tile);
  return true;
}

}  // namespace

// The geometry of a launch over n rows of k words in the build `want`
// asks for (0 by K, 1 staged, 2 device): out = {hosts a tile, blocks,
// shared bytes a block, build}. Returns a cudaError_t.
extern "C" int router_drain_geometry(int n, int k, int want, int* out) {
  Geometry g;
  int blocks = 0;
  if (!choose_geometry(n, k, want, g, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = g.tile;
  out[1] = blocks;
  out[2] = static_cast<int>(g.smem);
  out[3] = g.build;
  return 0;
}

template <bool kStaged>
static cudaError_t start(const Args& a, int blocks, cudaStream_t stream) {
  if (a.g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        router_drain_kernel<kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.g.smem));
    if (err != cudaSuccess) return err;
  }
  router_drain_kernel<kStaged><<<blocks, kWarp, a.g.smem, stream>>>(a);
  return cudaGetLastError();
}

// The launch in the build `want` asks for (0 by K, 1 staged, 2 device).
extern "C" int router_drain_launch(
    int n, int k, int window_ns, int want, const void* arrival,
    const void* size,
    const void* dn_rate, const void* dn_cap, const void* table,
    const void* mode, const void* has_ie, const void* ie, const void* has_dn,
    const void* dn, const void* cur, const void* prev, const void* bal,
    const void* lref, const void* has_c, const void* c_size,
    const void* resume, const void* dropped, void* mode_o, void* has_ie_o,
    void* ie_o, void* has_dn_o, void* dn_o, void* cur_o, void* prev_o,
    void* bal_o, void* lref_o, void* has_c_o, void* c_size_o, void* resume_o,
    void* dropped_o, void* status, void* deliver_t, void* co_mask,
    void* co_t, void* cached_idx, void* stream_ptr) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Geometry g;
  int blocks = 0;
  if (!choose_geometry(n, k, want, g, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const StateIn in{
      static_cast<const int*>(mode), static_cast<const bool*>(has_ie),
      static_cast<const int*>(ie), static_cast<const bool*>(has_dn),
      static_cast<const int*>(dn), static_cast<const int*>(cur),
      static_cast<const int*>(prev), static_cast<const int*>(bal),
      static_cast<const int*>(lref), static_cast<const bool*>(has_c),
      static_cast<const int*>(c_size), static_cast<const int*>(resume),
      static_cast<const int*>(dropped)};
  const StateOut out{
      static_cast<int*>(mode_o), static_cast<bool*>(has_ie_o),
      static_cast<int*>(ie_o), static_cast<bool*>(has_dn_o),
      static_cast<int*>(dn_o), static_cast<int*>(cur_o),
      static_cast<int*>(prev_o), static_cast<int*>(bal_o),
      static_cast<int*>(lref_o), static_cast<bool*>(has_c_o),
      static_cast<int*>(c_size_o), static_cast<int*>(resume_o),
      static_cast<int*>(dropped_o)};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Args a{n, k, window_ns, g, static_cast<const int*>(arrival),
               static_cast<const int*>(size),
               static_cast<const int*>(dn_rate),
               static_cast<const int*>(dn_cap),
               static_cast<const int*>(table), in, out,
               static_cast<int*>(status), static_cast<int*>(deliver_t),
               static_cast<bool*>(co_mask), static_cast<int*>(co_t),
               static_cast<int*>(cached_idx)};
  return static_cast<int>(g.build == kBuildStaged
                              ? start<true>(a, blocks, stream)
                              : start<false>(a, blocks, stream));
}
