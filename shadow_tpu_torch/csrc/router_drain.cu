// Kernel E of the window step: the destination router's drain (CoDel AQM,
// then the down-bandwidth relay) of one window, one thread a host, for
// Hopper (sm_90a).
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
// JAX prefix-sum column is never built.
//
// What bounds it on the card: bytes, against the serial chain of
// micro-steps each thread runs (data-dependent, at most 4*K + 16). The
// bytes: the arrival/size rows in, status/deliver_t out (16 B a slot),
// 13 state fields in and out (86 B a host), dn_rate/dn_cap in and
// co_mask/co_t/cached_idx out (17 B a host): at N=32768, K=32, 20.2 MB,
// 6.0 us at 3.35 TB/s. The design: a block of 32 hosts (fewer for rows
// wider than 442) stages its rows of arrival and size in shared memory
// with a coalesced load (row stride K + 1, odd, so a warp's rows start in
// 32 different banks), keeps the
// CoDel, bucket and cache scalars in registers, builds status/deliver_t in
// shared memory and stores them coalesced at the end. A warp runs as long
// as its slowest host. On chip_smoke.py's AQM world (phase 15: N=32768,
// K=32, the rows of a window where CoDel drops and every relay caches) no
// thread runs more than 4 micro-steps, and the kernel took 2.6x its byte
// bound cold and 1.4x warm on an NVIDIA H100 80GB HBM3 at 700 W: the
// bytes and a cold launch's fixed cost set its time there, not the chain.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMs = 1000000;
constexpr int kTarget = 10 * kMs;
constexpr int kInterval = 100 * kMs;
constexpr int kI32Max = 0x7fffffff;
constexpr int kMtu = 1500;
constexpr int kMaxCount = 4096;
constexpr int kMaxHosts = 32;  // hosts (threads) a block: one warp
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

__global__ void __launch_bounds__(kMaxHosts) router_drain_kernel(
    int n, int k, int window_ns, const int* __restrict__ arrival,
    const int* __restrict__ size, const int* __restrict__ dn_rate,
    const int* __restrict__ dn_cap, const int* __restrict__ table, StateIn in,
    StateOut out, int* __restrict__ status, int* __restrict__ deliver_t,
    bool* __restrict__ co_mask_out, int* __restrict__ co_t_out,
    int* __restrict__ cached_idx_out) {
  extern __shared__ int smem[];
  const int hosts = blockDim.x;
  const int stride = k + 1;
  int* arr_s = smem;
  int* size_s = arr_s + hosts * stride;
  int* status_s = size_s + hosts * stride;
  int* deliver_s = status_s + hosts * stride;

  const int base = blockIdx.x * hosts;
  const int rows = min(hosts, n - base);
  const int64_t off = static_cast<int64_t>(base) * k;
  const int total = rows * k;
  for (int i = threadIdx.x; i < total; i += hosts) {
    const int r = i / k;
    const int s = r * stride + (i - r * k);
    arr_s[s] = arrival[off + i];
    size_s[s] = size[off + i];
    status_s[s] = kQueued;
    deliver_s[s] = kI32Max;
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const int h = base + t;
    const int* A = arr_s + t * stride;
    const int* S = size_s + t * stride;
    int* ST = status_s + t * stride;
    int* DT = deliver_s + t * stride;
    const Bucket bucket{dn_rate[h], dn_cap[h]};

    int mode = in.mode[h], ie = in.ie[h], dn = in.dn[h];
    bool has_ie = in.has_ie[h], has_dn = in.has_dn[h], has_c = in.has_c[h];
    int cur = in.cur[h], prev = in.prev[h];
    int bal = in.bal[h], lref = in.lref[h];
    int c_size = in.c_size[h], resume = in.resume[h];
    int dropped = in.dropped[h];
    int c_idx = -1, eidx = 0, cbytes = 0, T = 0, phase = kIdle;
    bool co_mask = false;
    int co_t = 0;

    int n_valid = 0;
    for (int c = 0; c < k; ++c) n_valid += A[c] < kI32Max;
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
        const int head_arr = A[min(eidx, k - 1)];
        if (!has_c && eidx < n_valid && head_arr < window_ns) {
          // an idle chain starts at the head entry's arrival
          T = head_arr;
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
          dn = add(now, table[min(max(new_cur, 1), kMaxCount)]);
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
              ok ? add(dn, table[min(max(cur, 1), kMaxCount)]) : dn;
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

    out.mode[h] = mode;
    out.has_ie[h] = has_ie;
    out.ie[h] = ie;
    out.has_dn[h] = has_dn;
    out.dn[h] = dn;
    out.cur[h] = cur;
    out.prev[h] = prev;
    out.bal[h] = bal;
    out.lref[h] = lref;
    out.has_c[h] = has_c;
    out.c_size[h] = c_size;
    out.resume[h] = resume;
    out.dropped[h] = dropped;
    co_mask_out[h] = co_mask;
    co_t_out[h] = co_t;
    cached_idx_out[h] = c_idx;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += hosts) {
    const int r = i / k;
    const int s = r * stride + (i - r * k);
    status[off + i] = status_s[s];
    deliver_t[off + i] = deliver_s[s];
  }
}

}  // namespace

extern "C" int router_drain_launch(
    int n, int k, int window_ns, const void* arrival, const void* size,
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
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
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
  // a block stages 4 rows of k + 1 words a host: 32 hosts up to k = 442,
  // fewer above, down to one (k = 14527)
  const size_t row_bytes = sizeof(int) * 4 * static_cast<size_t>(k + 1);
  int hosts = kMaxHosts;
  while (hosts > 1 && hosts * row_bytes > kMaxSmem) hosts /= 2;
  const size_t smem = hosts * row_bytes;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        router_drain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + hosts - 1) / hosts;
  router_drain_kernel<<<blocks, hosts, smem,
                        static_cast<cudaStream_t>(stream_ptr)>>>(
      n, k, window_ns, static_cast<const int*>(arrival),
      static_cast<const int*>(size), static_cast<const int*>(dn_rate),
      static_cast<const int*>(dn_cap), static_cast<const int*>(table), in, out,
      static_cast<int*>(status), static_cast<int*>(deliver_t),
      static_cast<bool*>(co_mask), static_cast<int*>(co_t),
      static_cast<int*>(cached_idx));
  return static_cast<int>(cudaGetLastError());
}
