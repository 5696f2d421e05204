// Kernel F: the flow engine's windows, one thread a flow pair, for Hopper
// (sm_90a).
//
// Replaces: shadow_tpu/tpu/floweng.py, run_windows (a lax.scan of windows,
// each a lax.while_loop of fused steps holding the scheduled-event loop and
// the egress pull loop; not a Pallas kernel). Its plain PyTorch version is
// `tpu/floweng.run_windows_plain`, which this kernel equals bit for bit.
//
// One launch advances the world n_windows windows in place. A thread owns
// the pair (2p, 2p+1): it loads both lanes' TCP scalars, runs the windows
// and stores them back; the reassembly and SACK slots and the [C, Q] and
// [C, Q, 16] segment rings stay in global memory in the plain version's
// layout. In each window the thread runs fused steps while its pair has
// work (a scheduled event before the window's end, or a segment to pull)
// and fewer than max_events steps ran: up to sched_batch scheduled events
// of each lane, the app phase of each lane, then up to pull_cap pulls,
// each pulling lane a then lane b. The two lanes step in lockstep in the
// order of JAX's global loops; a pull reads the peer's ring head and
// count, which only the peer's own scheduled events and this lane's
// emissions change, so the ring slots, the ring-overflow drops and the
// loss-hash counters equal the batched loop's. After a window that ran
// steps, a pull pass with ack_every = 1 flushes the delayed ACKs.
//
// Stopping a pair early is exact: a scheduled-event pass, the app phase, a
// pull pass and the barrier flush all leave a pair with no work unchanged
// (tests/test_torch_floweng.py, the pair-independence test). JAX's
// global step count of a window is the largest pair's (atomicMax into
// steps[w]); a window is saturated when any pair still has work at the cap
// (sat[w] = 1; the wrapper adds the windows to n_saturated and advances
// clock_us).
//
// The loss draw (_wire_draw) is uint32 arithmetic. The TCP machine is
// tcp_fsm.cuh.
//
// Built without nvcc (no __CUDACC__), the file is plain C++ whose
// flow_window_host runs the same thread loop for every pair in turn, on
// host memory: `g++ -x c++ -O2 -shared -fPIC`.

#include <stdint.h>
#include <string.h>

#include "tcp_fsm.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FW_HD __device__
#else
#define FW_HD
#endif

using namespace fsm;

// The tensors of a FlowWorld, in the order of the launcher's pointer array:
// every TcpPlane field, then the world's (tpu/floweng.F_PLANE_FIELDS,
// F_WORLD_FIELDS), then clock_us and the two per-window outputs.
#define FW_PLANE_SCALARS(X)                                                  \
  X(int32_t, state) X(int32_t, error) X(uint8_t, error_consumed)             \
  X(int64_t, iss) X(int32_t, snd_una) X(int32_t, snd_nxt)                    \
  X(int32_t, snd_wnd) X(int32_t, stream_len) X(int32_t, snd_max)             \
  X(uint8_t, fin_requested) X(uint8_t, fin_sent) X(uint8_t, fin_acked)       \
  X(uint8_t, syn_outstanding) X(int32_t, syn_sends) X(uint8_t, syn_acked)    \
  X(uint8_t, retx_pending) X(uint8_t, probe_pending) X(int32_t, recover)     \
  X(int32_t, gbn_high) X(uint8_t, rst_pending) X(int64_t, irs)               \
  X(int32_t, rcv_nxt) X(int32_t, ordered_bytes) X(int32_t, reass_bytes)      \
  X(uint8_t, fin_received) X(uint8_t, has_fin_offset) X(int32_t, fin_offset) \
  X(uint8_t, ack_pending) X(int32_t, my_wscale) X(int32_t, peer_wscale)      \
  X(uint8_t, wscale_ok) X(int64_t, last_ts_recv) X(int32_t, srtt_ms)         \
  X(int32_t, rttvar_ms) X(int32_t, rto_ms) X(int32_t, backoff_count)         \
  X(int32_t, cwnd) X(int32_t, ssthresh) X(int32_t, phase)                    \
  X(int32_t, dup_acks) X(int32_t, avoid_acked) X(int32_t, rto_gen)           \
  X(uint8_t, rto_armed) X(int32_t, rto_deadline_ms) X(int32_t, persist_gen)  \
  X(uint8_t, persist_armed) X(int32_t, persist_deadline_ms)                  \
  X(int32_t, retransmit_count) X(int32_t, retransmitted_bytes)               \
  X(uint8_t, last_retx) X(uint8_t, sack_on) X(uint8_t, sack_ok)

#define FW_WORLD_SCALARS(X)                                                  \
  X(int32_t, q_head) X(int32_t, q_count) X(int32_t, q_dropped)               \
  X(uint8_t, opened) X(uint8_t, close_sent) X(int32_t, written)              \
  X(int32_t, read_bytes) X(int32_t, total) X(int32_t, t_start)               \
  X(int32_t, latency_us) X(int64_t, loss_u32) X(int32_t, lane_id)            \
  X(int32_t, w_iss) X(int32_t, conn_t) X(int32_t, complete_us)               \
  X(int32_t, n_segments) X(int32_t, seg_units) X(int32_t, wire_drops)        \
  X(int32_t, unacked)

#define FW_DECL(t, n) t* n;
struct FlowPtrs {
  FW_PLANE_SCALARS(FW_DECL)
  int32_t* sacked_s;   // [C, SACK_SLOTS]
  int32_t* sacked_e;
  int32_t* reass_off;  // [C, RS]
  int32_t* reass_len;
  int32_t* q_time;     // [C, Q]
  int32_t* q_fields;   // [C, Q, 16]
  FW_WORLD_SCALARS(FW_DECL)
  int32_t* clock_us;   // []
  int32_t* steps;      // [n_windows] out (atomicMax)
  int32_t* sat;        // [n_windows] out (0/1)
};
#undef FW_DECL
constexpr int FW_N_PTRS = 80;
static_assert(sizeof(FlowPtrs) == FW_N_PTRS * sizeof(void*),
              "FlowPtrs holds one pointer a tensor");

struct Params {
  int n_pairs, Q, RS, n_windows, window_us, max_events, ack_every,
      sched_batch, pull_cap, gso_segs;
};

// One lane: its TCP machine and the world's per-lane columns.
struct Lane {
  Conn c;
  int q_head, q_count, q_dropped;
  bool opened, close_sent;
  int written, read_bytes, total, t_start, latency_us;
  uint32_t loss_u32;
  int lane_id, w_iss, conn_t, complete_us, n_segments, seg_units,
      wire_drops, unacked;
  int* q_time;    // this lane's ring row [Q]
  int* q_fields;  // [Q, 16]
};

FW_HD inline void load_lane(const FlowPtrs& P, const Params& K, int i,
                            Lane& L) {
#define FW_LOAD_C(t, n) L.c.n = static_cast<decltype(L.c.n)>(P.n[i]);
  FW_PLANE_SCALARS(FW_LOAD_C)
#undef FW_LOAD_C
  // the world's scalars live beside the plane's in Lane (w_iss is the
  // world's int32 iss column)
#define FW_LOAD_W(t, n) L.n = static_cast<decltype(L.n)>(P.n[i]);
  FW_WORLD_SCALARS(FW_LOAD_W)
#undef FW_LOAD_W
  L.c.sacked_s = P.sacked_s + static_cast<int64_t>(i) * SACK_SLOTS;
  L.c.sacked_e = P.sacked_e + static_cast<int64_t>(i) * SACK_SLOTS;
  L.c.reass_off = P.reass_off + static_cast<int64_t>(i) * K.RS;
  L.c.reass_len = P.reass_len + static_cast<int64_t>(i) * K.RS;
  L.c.rs = K.RS;
  L.q_time = P.q_time + static_cast<int64_t>(i) * K.Q;
  L.q_fields = P.q_fields + static_cast<int64_t>(i) * K.Q * N_FIELDS;
}

FW_HD inline void store_lane(const FlowPtrs& P, int i, const Lane& L) {
#define FW_STORE_C(t, n) P.n[i] = static_cast<t>(L.c.n);
  FW_PLANE_SCALARS(FW_STORE_C)
#undef FW_STORE_C
#define FW_STORE_W(t, n) P.n[i] = static_cast<t>(L.n);
  FW_WORLD_SCALARS(FW_STORE_W)
#undef FW_STORE_W
}

// -- the flow engine's per-lane steps (tpu/floweng.py) -------------------------

FW_HD inline int us_of_ms(int ms) { return mul32(ms, 1000); }

// _sched_times: the earliest scheduled event; the parts by reference
FW_HD inline int sched_times(const Lane& L, int Q, int& arr_t, int& rto_t,
                             int& tw_t, int& ps_t) {
  arr_t = L.q_count > 0 ? L.q_time[L.q_head % Q] : I32_MAX;
  rto_t = L.c.rto_armed ? us_of_ms(L.c.rto_deadline_ms) : I32_MAX;
  tw_t = L.c.state == TIME_WAIT ? us_of_ms(L.c.rto_deadline_ms) : I32_MAX;
  ps_t = L.c.persist_armed ? us_of_ms(L.c.persist_deadline_ms) : I32_MAX;
  int open_t = L.opened ? I32_MAX : L.t_start;
  return imin(imin(arr_t, rto_t), imin(imin(tw_t, ps_t), open_t));
}

FW_HD inline int sched_time(const Lane& L, int Q) {
  int a, r, t, p;
  return sched_times(L, Q, a, r, t, p);
}

FW_HD inline bool pull_wanted(const Lane& L, int ack_every) {
  int kind = next_kind(L.c);
  if (kind == K_NONE || !L.opened) return false;
  const Conn& p = L.c;
  bool delayed = kind == K_ACK && p.state == ESTABLISHED && !p.fin_received
                 && p.reass_bytes == 0 && p.error == 0 && L.unacked >= 1
                 && L.unacked < ack_every;
  return !delayed;
}

// _sched_event for one lane; returns whether it was active
FW_HD inline bool sched_event(Lane& L, int Q, int end) {
  int arr_t, rto_t, tw_t, ps_t;
  int sched_t = sched_times(L, Q, arr_t, rto_t, tw_t, ps_t);
  if (!(sched_t < end)) return false;
  int t = imax(sched_t, L.conn_t);
  int now_ms = t / 1000;
  int f[N_FIELDS];
  for (int k = 0; k < N_FIELDS; ++k) f[k] = 0;
  int kind = EV_NONE;
  if (sched_t == arr_t) {  // arrival > rto > time-wait > persist > open
    const int* af = L.q_fields + (L.q_head % Q) * N_FIELDS;
    if (L.opened) {
      kind = EV_SEG;
      for (int k = 0; k < N_FIELDS; ++k) f[k] = af[k];
      if (af[4] > 0) L.unacked += 1;
    } else if (af[0] & SYN) {  // a SYN at an unopened passive side
      kind = EV_OPEN_PASSIVE;
      f[0] = L.w_iss;
      f[1] = af[1];
      f[2] = af[3];
      f[3] = af[5];
      f[4] = af[6];
      f[5] = af[7];
      f[6] = af[8];
    }  // else popped and dropped
    L.q_head += 1;
    L.q_count -= 1;
  } else if (sched_t == rto_t) {
    kind = EV_TIMER_RTO;
    f[0] = L.c.rto_gen;
  } else if (sched_t == tw_t) {
    kind = EV_TIMER_TW;
    f[0] = L.c.rto_gen;
  } else if (sched_t == ps_t) {
    kind = EV_TIMER_PERSIST;
    f[0] = L.c.persist_gen;
  } else {
    kind = EV_OPEN_ACTIVE;
    f[0] = L.w_iss;
  }
  sched_step(L.c, kind, f, now_ms);
  if (kind == EV_OPEN_ACTIVE || kind == EV_OPEN_PASSIVE) L.opened = true;
  L.conn_t = t;
  return true;
}

// _app_phase for one lane
FW_HD inline void app_phase(Lane& L, int peer_total) {
  Conn& p = L.c;
  int now_ms = L.conn_t / 1000;
  bool healthy = p.error == 0;
  bool state_ok = p.state == ESTABLISHED || p.state == CLOSE_WAIT;
  int got = L.opened ? p.ordered_bytes : 0;
  bool drain = got > 0;
  if (drain) {
    p.ordered_bytes = 0;
    p.ack_pending = true;
  }
  L.read_bytes = add32(L.read_bytes, got);
  if (L.complete_us == I32_MAX && L.read_bytes >= peer_total
      && peer_total > 0 && drain)
    L.complete_us = L.conn_t;
  int n = imin(send_space(p), L.total - L.written);
  if (state_ok && healthy && L.opened && n > 0) {
    p.stream_len += n;
    L.written += n;
    if (p.snd_wnd == 0 && p.state >= ESTABLISHED && !p.persist_armed) {
      p.persist_gen += 1;
      p.persist_armed = true;
      p.persist_deadline_ms = add32(now_ms, p.rto_ms);
    }
  }
  bool do_close;
  if (L.total > 0)
    do_close = L.written >= L.total && p.state == ESTABLISHED;
  else
    do_close = p.fin_received && p.ordered_bytes == 0 && p.reass_bytes == 0
               && state_ok;
  if (do_close && !L.close_sent && L.opened && healthy) {
    if (p.state == ESTABLISHED)
      p.state = FIN_WAIT_1;
    else if (p.state == CLOSE_WAIT)
      p.state = LAST_ACK;
    p.fin_requested = true;
    L.close_sent = true;
  }
}

FW_HD inline uint32_t wire_draw(int idx, uint32_t counter) {
  uint32_t z = static_cast<uint32_t>(idx) * 0x9E3779B9u
               + counter * 0x85EBCA6Bu + 0x6A09E667u;
  z = (z ^ (z >> 16)) * 0x21F0AAADu;
  z = (z ^ (z >> 15)) * 0x735A2D97u;
  return z ^ (z >> 15);
}

// enqueue one wire segment into the peer's ring at `slot`
FW_HD inline void ring_put(Lane& peer, int slot, int t, const int* seg) {
  peer.q_time[slot] = t;
  int* dst = peer.q_fields + slot * N_FIELDS;
  for (int k = 0; k < N_FIELDS; ++k) dst[k] = seg[k];
}

// one pull of one lane (an iteration of _pull_phase's body, this lane's
// part): emit, draw the wire loss per MSS unit, enqueue at the peer
FW_HD inline void pull_lane(Lane& L, Lane& peer, const Params& K,
                            int ack_every) {
  if (!pull_wanted(L, ack_every)) return;
  int out[N_OUT];
  ev_pull(L.c, L.conn_t / 1000, K.gso_segs, out);
  if (out[0] == 0) return;
  int paylen = out[5];
  int units = imax((paylen + MSS - 1) / MSS, 1);
  uint32_t base = static_cast<uint32_t>(L.n_segments)
                  * static_cast<uint32_t>(K.gso_segs);
  int f0 = -1, f1 = -1;
  if (L.loss_u32 > 0) {
    for (int k = 0; k < units && k < K.gso_segs; ++k) {
      if (wire_draw(L.lane_id, base + static_cast<uint32_t>(k)) < L.loss_u32) {
        if (f0 < 0) {
          f0 = k;
        } else {
          f1 = k;
          break;
        }
      }
    }
  }
  bool any_lost = f0 >= 0;
  if (!any_lost) f0 = 0;
  if (f1 < 0) f1 = units;
  int lenA_units = any_lost ? f0 : units;
  int lenA = imin(lenA_units * MSS, paylen);
  int startB = (f0 + 1) * MSS;
  int lenB = any_lost ? imax(imin(f1 * MSS, paylen) - startB, 0) : 0;
  int lenB_units = (lenB + MSS - 1) / MSS;
  bool pure = paylen == 0;
  bool hasA = pure ? !any_lost : lenA > 0;
  bool hasB = lenB > 0;
  int delivered = pure ? (hasA ? 1 : 0) : lenA_units + lenB_units;
  int seg[N_FIELDS];
  for (int k = 0; k < 8; ++k) seg[k] = out[1 + k];
  for (int k = 8; k < N_FIELDS; ++k) seg[k] = out[2 + k];
  int p_count = peer.q_count, p_head = peer.q_head;
  int arrive = add32(L.conn_t, L.latency_us);
  bool roomA = p_count < K.Q;
  int occA = (hasA && roomA) ? 1 : 0;
  bool roomB = p_count + occA < K.Q;
  int seg4 = seg[4];
  if (hasA && roomA) {
    seg[4] = imin(seg4, lenA);
    ring_put(peer, (p_head + p_count) % K.Q, arrive, seg);
    peer.q_count += 1;
  }
  if (hasB && roomB) {
    seg[4] = lenB;
    seg[1] = static_cast<int>(static_cast<uint32_t>(out[2])
                              + static_cast<uint32_t>(startB));
    ring_put(peer, (p_head + p_count + occA) % K.Q, arrive, seg);
    peer.q_count += 1;
  }
  L.q_dropped += (hasA && !roomA) + (hasB && !roomB);
  L.wire_drops += units - delivered;
  L.n_segments += 1;
  L.seg_units += units;
  L.unacked = 0;
}

FW_HD inline void pull_phase(Lane& a, Lane& b, const Params& K,
                             int ack_every) {
  for (int i = 0; i < K.pull_cap; ++i) {
    pull_lane(a, b, K, ack_every);
    pull_lane(b, a, K, ack_every);
    if (!pull_wanted(a, ack_every) && !pull_wanted(b, ack_every)) break;
  }
}

FW_HD inline bool pair_has_work(const Lane& a, const Lane& b, int Q, int end,
                                int ack_every) {
  return sched_time(a, Q) < end || sched_time(b, Q) < end
         || pull_wanted(a, ack_every) || pull_wanted(b, ack_every);
}

FW_HD inline void fused_step(Lane& a, Lane& b, const Params& K, int end) {
  for (int i = 0; i < K.sched_batch; ++i) {
    bool act = sched_event(a, K.Q, end);
    act = sched_event(b, K.Q, end) || act;
    if (!(act && (sched_time(a, K.Q) < end || sched_time(b, K.Q) < end)))
      break;
  }
  app_phase(a, b.total);
  app_phase(b, a.total);
  pull_phase(a, b, K, K.ack_every);
}

#ifdef __CUDACC__
__device__ inline void note_window(int32_t* steps, int32_t* sat, int w,
                                   int n, bool saturated) {
  atomicMax(steps + w, n);
  if (saturated) atomicMax(sat + w, 1);
}
#else
inline void note_window(int32_t* steps, int32_t* sat, int w, int n,
                        bool saturated) {
  if (n > steps[w]) steps[w] = n;
  if (saturated) sat[w] = 1;
}
#endif

// the thread loop of pair p over the chunk's windows
FW_HD inline void run_pair(const FlowPtrs& P, const Params& K, int p) {
  Lane a, b;
  load_lane(P, K, 2 * p, a);
  load_lane(P, K, 2 * p + 1, b);
  const int clock0 = *P.clock_us;
  for (int w = 0; w < K.n_windows; ++w) {
    int end = add32(clock0, mul32(w + 1, K.window_us));
    int n = 0;
    while (n < K.max_events && pair_has_work(a, b, K.Q, end, K.ack_every)) {
      fused_step(a, b, K, end);
      ++n;
    }
    bool saturated = n >= K.max_events
                     && pair_has_work(a, b, K.Q, end, K.ack_every);
    if (n > 0) pull_phase(a, b, K, 1);  // flush the delayed ACKs
    a.conn_t = imax(a.conn_t, end);
    b.conn_t = imax(b.conn_t, end);
    note_window(P.steps, P.sat, w, n, saturated);
  }
  store_lane(P, 2 * p, a);
  store_lane(P, 2 * p + 1, b);
}

static bool fw_params_ok(const Params& K) {
  return K.n_pairs >= 0 && K.Q >= 1 && K.RS >= 1 && K.n_windows >= 0
         && K.gso_segs >= 1 && K.pull_cap >= 0 && K.sched_batch >= 0
         && K.max_events >= 0 && K.ack_every >= 1;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
    flow_window_kernel(const FlowPtrs P, const Params K) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < K.n_pairs) run_pair(P, K, p);
}

extern "C" int flow_window_launch(int n_pairs, int q, int rs, int n_windows,
                                  int window_us, int max_events,
                                  int ack_every, int sched_batch,
                                  int pull_cap, int gso_segs,
                                  void* const* ptrs, int n_ptrs,
                                  void* stream_ptr) {
  const Params K{n_pairs, q, rs, n_windows, window_us, max_events,
                 ack_every, sched_batch, pull_cap, gso_segs};
  if (n_ptrs != FW_N_PTRS || !fw_params_ok(K))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0 || n_windows == 0) return static_cast<int>(cudaSuccess);
  FlowPtrs P;
  memcpy(&P, ptrs, sizeof P);
  const int threads = 128;
  const int blocks = (n_pairs + threads - 1) / threads;
  flow_window_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(P, K);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host build

extern "C" int flow_window_host(int n_pairs, int q, int rs, int n_windows,
                                int window_us, int max_events, int ack_every,
                                int sched_batch, int pull_cap, int gso_segs,
                                void* const* ptrs, int n_ptrs) {
  const Params K{n_pairs, q, rs, n_windows, window_us, max_events,
                 ack_every, sched_batch, pull_cap, gso_segs};
  if (n_ptrs != FW_N_PTRS || !fw_params_ok(K)) return 1;
  FlowPtrs P;
  memcpy(&P, ptrs, sizeof P);
  for (int p = 0; p < n_pairs; ++p) run_pair(P, K, p);
  return 0;
}

#endif
