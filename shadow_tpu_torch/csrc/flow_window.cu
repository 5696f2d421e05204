// Kernel F: the flow engine's windows for Hopper (sm_90a): one flow pair
// a warp, its two lanes on two threads, its slots and rings' heads and
// counts in shared memory, its rings in device memory.
//
// Replaces: shadow_tpu/tpu/floweng.py, run_windows (a lax.scan of windows,
// each a lax.while_loop of fused steps holding the scheduled-event loop and
// the egress pull loop; not a Pallas kernel). Its plain PyTorch version is
// `tpu/floweng.run_windows_plain`, which this kernel equals bit for bit.
//
// One launch advances the world n_windows windows in place. Pair p's two
// threads are lanes 0 and 1 of one warp (FW_PAIRS_A_WARP pairs a warp):
// the even thread runs lane 2p, the odd one lane 2p + 1, each with its
// lane's TCP scalars in registers. In each window the pair runs fused
// steps while it has work (a scheduled event before the window's end, or
// a segment to pull) and fewer than max_events steps ran: up to
// sched_batch scheduled events, the app phase, then up to pull_cap pulls.
// These are JAX's phases, each acting on every lane at once, and the two
// threads run each phase at once: in a scheduled-event pass a lane pops
// only its own ring; in the app phase it reads only itself and its peer's
// constant `total`; in a pull it writes its own state and pushes only to
// its peer's ring, whose head no pull moves and whose count only this lane
// raises. `__syncwarp` over the pair parts the phases; each loop's
// condition (has work, another scheduled event, another pull, saturated)
// is the two lanes' vote by `__shfl_xor_sync`. After a window that ran
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
// A block's pairs stage, for the whole launch, each lane's reassembly
// (2 x RS) and SACK (2 x 16) slots and its ring's head and count in
// shared memory (792 B a pair at RS = 32): the whole block copies them
// in, coalesced, before the windows and out after them. `Conn`'s slot
// pointers point there, so the slot loops of tcp_fsm.cuh read shared
// memory. The ring itself, its arrival times [Q] and fields [Q, 16],
// stays in device memory (`Lane::q_time` and `q_fields` point at the
// lane's rows: a time read once a scheduled-event test, fields read once
// an arrival, both written once a push), so any Q runs, and the ring's
// size never limits the pairs a block. (Staging the ring's times too was
// no faster at Q = 128 and up to 9x slower where it cut the pairs a
// block, PERF.md.) The launcher spreads the pairs over every SM (warps a
// block = the warps needed over the SMs, at most FW_MAX_WARPS). The
// kernel is built for the flow world's 32 reassembly slots (FW_RS), so
// the slot loops have a constant trip count; a power-of-two Q takes a
// ring slot by a mask, not a division.
//
// What bounds it on the card: not bytes (bench_flows' world, 36 MB read
// and written once, would take ~0.011 ms) but the longest pair's serial
// chain of events through the TCP machine, each a data-dependent walk of
// branches and slot loops, a few hundred dependent instructions that one
// warp issues one after another (~2.1 us an event at bench_flows' first
// chunk, PERF.md). One thread a pair with 32 pairs a warp ran the union
// of 32 pairs' branches (~4x slower there than one pair a warp). The SM
// count, the lanes on two warps and two pairs a warp bought nothing; the
// slot loops across a warp's lanes would shorten the chain.
//
// The loss draw (wire_draw) is uint32 arithmetic. The TCP machine is
// tcp_fsm.cuh.
//
// Built without nvcc (no __CUDACC__), the file is plain C++ whose
// flow_window_host runs the same phase functions over the same staged
// layout for each pair in turn, lane a then lane b within each phase (lane
// b first under FW_HOST_LANES_REVERSED, a build the tests use to show the
// order does not matter): `g++ -x c++ -O2 -shared -fPIC`.

#include <stdint.h>
#include <string.h>

#include "tcp_fsm.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FW_HD __device__ __forceinline__
#else
#include <vector>
#define FW_HD inline
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

// the world's per-lane scalars after the ring's head and count
#define FW_WORLD_SCALARS(X)                                                  \
  X(int32_t, q_dropped)                                                      \
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
  int32_t* q_head;     // [C]
  int32_t* q_count;    // [C]
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
  int q_mask;  // Q - 1 when Q is a power of two, else -1 (ring_slot)
};

static inline Params fw_params(int n_pairs, int q, int rs, int n_windows,
                               int window_us, int max_events, int ack_every,
                               int sched_batch, int pull_cap, int gso_segs) {
  return Params{n_pairs, q, rs, n_windows, window_us, max_events, ack_every,
                sched_batch, pull_cap, gso_segs,
                q > 0 && (q & (q - 1)) == 0 ? q - 1 : -1};
}

// -- the launch geometry and the staged layout -------------------------------

// pairs a warp: one, so a warp runs one pair's branches (PERF.md §6: of
// 1, 2, 4 and 8 pairs a warp, one was the fastest at bench_flows' and
// (a)'s chunks and level with the others at rung 3's)
constexpr int FW_PAIRS_A_WARP = 1;
// the reassembly slots a lane has (make_flow_world's), known when compiled
constexpr int FW_RS = 32;
constexpr int FW_MAX_WARPS = 8;           // warps a block

// A lane's staged words: reass_off [RS], reass_len [RS], sacked_s [16],
// sacked_e [16], q_head, q_count; an odd count, so lanes reading the
// same offset fall in different banks.
FSM_HD constexpr int lane_words(int RS) {
  return (2 * RS + 2 * SACK_SLOTS + 2) | 1;
}
FSM_HD int off_sacked(int RS) { return 2 * RS; }
FSM_HD int off_q_head(int RS) { return 2 * RS + 2 * SACK_SLOTS; }

// shared bytes a pair stages
static inline int64_t fw_pair_bytes(int RS) {
  return 2 * static_cast<int64_t>(lane_words(RS)) * 4;
}
// a full block of the card's build stages within the 48 KB a block may
// use without opting in
static_assert(FW_MAX_WARPS * FW_PAIRS_A_WARP * 2 * lane_words(FW_RS) * 4
                  <= 48 * 1024,
              "a block's staged slots fit the default shared memory");

struct Geometry {
  int pairs_a_block, blocks, smem_bytes;
};

// The pairs over the SMs: as many warps a block as spread the pairs' warps
// over n_sms blocks (one block an SM), at most FW_MAX_WARPS. Returns false
// for a Q, RS or SM count the kernel does not take.
static inline bool fw_geometry(int n_pairs, int Q, int RS, int n_sms,
                               Geometry& g) {
  if (Q < 1 || RS < 1 || n_sms < 1) return false;
  int warps = (n_pairs + FW_PAIRS_A_WARP - 1) / FW_PAIRS_A_WARP;
  int wpb = (warps + n_sms - 1) / n_sms;
  wpb = wpb < 1 ? 1 : (wpb > FW_MAX_WARPS ? FW_MAX_WARPS : wpb);
  int ppb = wpb * FW_PAIRS_A_WARP;
  if (n_pairs > 0 && ppb > n_pairs) ppb = n_pairs;
  g.pairs_a_block = ppb;
  g.blocks = (n_pairs + ppb - 1) / ppb;
  g.smem_bytes = static_cast<int>(ppb * fw_pair_bytes(RS));
  return true;
}

// Copy `n` lanes' rows of one [C, per] int32 tensor from lane `l0` into
// their staged words at `off` (or back, with `in` false); thread t0 of dt
// copies every dt-th word.
FW_HD void stage_rows(int32_t* g, int per, int l0, int n, int* s,
                      int stride, int off, int t0, int dt, bool in) {
  g += static_cast<int64_t>(l0) * per;
  for (int k = t0; k < n * per; k += dt) {
    int lane = k / per;
    int* w = s + lane * stride + off + (k - lane * per);
    if (in)
      *w = g[k];
    else
      g[k] = *w;
  }
}

// every staged tensor of lanes [l0, l0 + n)
FW_HD void stage_lanes(const FlowPtrs& P, const Params& K, int l0, int n,
                       int* s, int t0, int dt, bool in) {
  const int st = lane_words(K.RS), RS = K.RS, qh = off_q_head(RS);
  stage_rows(P.reass_off, RS, l0, n, s, st, 0, t0, dt, in);
  stage_rows(P.reass_len, RS, l0, n, s, st, RS, t0, dt, in);
  stage_rows(P.sacked_s, SACK_SLOTS, l0, n, s, st, off_sacked(RS), t0, dt,
             in);
  stage_rows(P.sacked_e, SACK_SLOTS, l0, n, s, st,
             off_sacked(RS) + SACK_SLOTS, t0, dt, in);
  stage_rows(P.q_head, 1, l0, n, s, st, qh, t0, dt, in);
  stage_rows(P.q_count, 1, l0, n, s, st, qh + 1, t0, dt, in);
}

// One lane: its TCP machine, the world's per-lane columns, its ring (to
// pop) and its peer's (to push).
struct Lane {
  Conn c;
  int q_dropped;
  bool opened, close_sent;
  int written, read_bytes, total, t_start, latency_us;
  uint32_t loss_u32;
  int lane_id, w_iss, conn_t, complete_us, n_segments, seg_units,
      wire_drops, unacked;
  int peer_total;
  int* q_time;     // global [Q]
  int* q_head;     // staged
  int* q_count;    // staged
  int* q_fields;   // global [Q, 16]
  int* p_time;     // the peer's, global
  int* p_head;
  int* p_count;
  int* p_fields;   // the peer's, global
};

// lane i's scalars from the world, its slots and ring's head and count
// from its staged words `s` (the peer's at `ps`), its ring from the world
FW_HD void load_lane(const FlowPtrs& P, const Params& K, int i, int* s,
                     int* ps, Lane& L) {
#define FW_LOAD_C(t, n) L.c.n = static_cast<decltype(L.c.n)>(P.n[i]);
  FW_PLANE_SCALARS(FW_LOAD_C)
#undef FW_LOAD_C
  // the world's scalars live beside the plane's in Lane (w_iss is the
  // world's int32 iss column)
#define FW_LOAD_W(t, n) L.n = static_cast<decltype(L.n)>(P.n[i]);
  FW_WORLD_SCALARS(FW_LOAD_W)
#undef FW_LOAD_W
  L.peer_total = P.total[i ^ 1];
  const int qh = off_q_head(K.RS);
  L.c.reass_off = s;
  L.c.reass_len = s + K.RS;
  L.c.sacked_s = s + off_sacked(K.RS);
  L.c.sacked_e = s + off_sacked(K.RS) + SACK_SLOTS;
  L.c.rs = K.RS;
  L.q_time = P.q_time + static_cast<int64_t>(i) * K.Q;
  L.p_time = P.q_time + static_cast<int64_t>(i ^ 1) * K.Q;
  L.q_head = s + qh;
  L.q_count = s + qh + 1;
  L.p_head = ps + qh;
  L.p_count = ps + qh + 1;
  L.q_fields = P.q_fields + static_cast<int64_t>(i) * K.Q * N_FIELDS;
  L.p_fields = P.q_fields + static_cast<int64_t>(i ^ 1) * K.Q * N_FIELDS;
}

FW_HD void store_lane(const FlowPtrs& P, int i, const Lane& L) {
#define FW_STORE_C(t, n) P.n[i] = static_cast<t>(L.c.n);
  FW_PLANE_SCALARS(FW_STORE_C)
#undef FW_STORE_C
#define FW_STORE_W(t, n) P.n[i] = static_cast<t>(L.n);
  FW_WORLD_SCALARS(FW_STORE_W)
#undef FW_STORE_W
}

// -- the flow engine's per-lane steps (tpu/floweng.py) -------------------------

FW_HD int us_of_ms(int ms) { return mul32(ms, 1000); }

// a ring position's slot (a mask in place of the division when Q is a
// power of two; positions never go negative)
FW_HD int ring_slot(int pos, const Params& K) {
  return K.q_mask >= 0 ? pos & K.q_mask : pos % K.Q;
}

// _sched_times: the earliest scheduled event; the parts by reference
FW_HD int sched_times(const Lane& L, const Params& K, int& arr_t,
                      int& rto_t, int& tw_t, int& ps_t) {
  arr_t = *L.q_count > 0 ? L.q_time[ring_slot(*L.q_head, K)] : I32_MAX;
  rto_t = L.c.rto_armed ? us_of_ms(L.c.rto_deadline_ms) : I32_MAX;
  tw_t = L.c.state == TIME_WAIT ? us_of_ms(L.c.rto_deadline_ms) : I32_MAX;
  ps_t = L.c.persist_armed ? us_of_ms(L.c.persist_deadline_ms) : I32_MAX;
  int open_t = L.opened ? I32_MAX : L.t_start;
  return imin(imin(arr_t, rto_t), imin(imin(tw_t, ps_t), open_t));
}

FW_HD int sched_time(const Lane& L, const Params& K) {
  int a, r, t, p;
  return sched_times(L, K, a, r, t, p);
}

FW_HD bool pull_wanted(const Lane& L, int ack_every) {
  int kind = next_kind(L.c);
  if (kind == K_NONE || !L.opened) return false;
  const Conn& p = L.c;
  bool delayed = kind == K_ACK && p.state == ESTABLISHED && !p.fin_received
                 && p.reass_bytes == 0 && p.error == 0 && L.unacked >= 1
                 && L.unacked < ack_every;
  return !delayed;
}

// _sched_event for one lane; returns whether it was active
FW_HD bool sched_event(Lane& L, const Params& K, int end) {
  int arr_t, rto_t, tw_t, ps_t;
  int sched_t = sched_times(L, K, arr_t, rto_t, tw_t, ps_t);
  if (!(sched_t < end)) return false;
  int t = imax(sched_t, L.conn_t);
  int now_ms = t / 1000;
  int f[N_FIELDS];
  for (int k = 0; k < N_FIELDS; ++k) f[k] = 0;
  int kind = EV_NONE;
  if (sched_t == arr_t) {  // arrival > rto > time-wait > persist > open
    const int* af = L.q_fields + ring_slot(*L.q_head, K) * N_FIELDS;
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
    *L.q_head += 1;
    *L.q_count -= 1;
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
FW_HD void app_phase(Lane& L) {
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
  if (L.complete_us == I32_MAX && L.read_bytes >= L.peer_total
      && L.peer_total > 0 && drain)
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

FW_HD uint32_t wire_draw(int idx, uint32_t counter) {
  uint32_t z = static_cast<uint32_t>(idx) * 0x9E3779B9u
               + counter * 0x85EBCA6Bu + 0x6A09E667u;
  z = (z ^ (z >> 16)) * 0x21F0AAADu;
  z = (z ^ (z >> 15)) * 0x735A2D97u;
  return z ^ (z >> 15);
}

// enqueue one wire segment into the peer's ring at `slot`
FW_HD void ring_put(Lane& L, int slot, int t, const int* seg) {
  L.p_time[slot] = t;
  int* dst = L.p_fields + slot * N_FIELDS;
  for (int k = 0; k < N_FIELDS; ++k) dst[k] = seg[k];
}

// one pull of one lane (an iteration of _pull_phase's body, this lane's
// part): emit, draw the wire loss per MSS unit, enqueue at the peer
FW_HD void pull_lane(Lane& L, const Params& K, int ack_every) {
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
  int p_count = *L.p_count, p_head = *L.p_head;
  int arrive = add32(L.conn_t, L.latency_us);
  bool roomA = p_count < K.Q;
  int occA = (hasA && roomA) ? 1 : 0;
  bool roomB = p_count + occA < K.Q;
  int seg4 = seg[4];
  if (hasA && roomA) {
    seg[4] = imin(seg4, lenA);
    ring_put(L, ring_slot(p_head + p_count, K), arrive, seg);
    *L.p_count += 1;
  }
  if (hasB && roomB) {
    seg[4] = lenB;
    seg[1] = static_cast<int>(static_cast<uint32_t>(out[2])
                              + static_cast<uint32_t>(startB));
    ring_put(L, ring_slot(p_head + p_count + occA, K), arrive, seg);
    *L.p_count += 1;
  }
  L.q_dropped += (hasA && !roomA) + (hasB && !roomB);
  L.wire_drops += units - delivered;
  L.n_segments += 1;
  L.seg_units += units;
  L.unacked = 0;
}

// -- a pair's phases, over its two lanes -------------------------------------
//
// `Pair` runs a phase on both lanes (`each`), votes a condition over them
// (`any`, which runs its function on both lanes before it answers) and
// parts two phases (`sync`): on the card each thread holds one lane and
// the pair's two threads meet in `__syncwarp`; on the host one caller runs
// lane a and then lane b.

template <class Pair>
FW_HD bool pair_has_work(Pair& pr, const Params& K, int end,
                          int ack_every) {
  return pr.any([&](Lane& L) {
    return sched_time(L, K) < end || pull_wanted(L, ack_every);
  });
}

template <class Pair>
FW_HD void pull_phase(Pair& pr, const Params& K, int ack_every) {
  for (int i = 0; i < K.pull_cap; ++i) {
    pr.each([&](Lane& L) { pull_lane(L, K, ack_every); });
    if (!pr.any([&](Lane& L) { return pull_wanted(L, ack_every); })) break;
  }
  pr.sync();  // the pushes land before the lanes read their rings
}

template <class Pair>
FW_HD void fused_step(Pair& pr, const Params& K, int end) {
  for (int i = 0; i < K.sched_batch; ++i) {
    bool act = pr.any([&](Lane& L) { return sched_event(L, K, end); });
    if (!(act && pr.any([&](Lane& L) { return sched_time(L, K) < end; })))
      break;
  }
  pr.sync();  // the pops land before the peer's pulls read the heads
  pr.each([&](Lane& L) { app_phase(L); });
  pull_phase(pr, K, K.ack_every);
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

// the windows of one pair
template <class Pair>
FW_HD void run_pair(Pair& pr, const FlowPtrs& P, const Params& K) {
  const int clock0 = *P.clock_us;
  for (int w = 0; w < K.n_windows; ++w) {
    int end = add32(clock0, mul32(w + 1, K.window_us));
    int n = 0;
    while (n < K.max_events && pair_has_work(pr, K, end, K.ack_every)) {
      fused_step(pr, K, end);
      ++n;
    }
    bool saturated = n >= K.max_events
                     && pair_has_work(pr, K, end, K.ack_every);
    if (n > 0) pull_phase(pr, K, 1);  // flush the delayed ACKs
    pr.each([&](Lane& L) { L.conn_t = imax(L.conn_t, end); });
    if (pr.leader()) note_window(P.steps, P.sat, w, n, saturated);
  }
}

static bool fw_params_ok(const Params& K) {
  return K.n_pairs >= 0 && K.Q >= 1 && K.RS >= 1 && K.n_windows >= 0
         && K.gso_segs >= 1 && K.pull_cap >= 0 && K.sched_batch >= 0
         && K.max_events >= 0 && K.ack_every >= 1;
}

// the bytes one pair stages, for the wrapper's check (both builds)
extern "C" int flow_window_pair_bytes(int rs) {
  int64_t b = fw_pair_bytes(rs);
  return b > 0x7FFFFFFF ? -1 : static_cast<int>(b);
}

// pairs a block, blocks and shared bytes a block of a launch over n_sms
// SMs (out[3]); 1 for a Q, RS or SM count the kernel does not take
extern "C" int flow_window_geometry(int n_pairs, int q, int rs, int n_sms,
                                    int* out) {
  Geometry g;
  if (!fw_geometry(n_pairs, q, rs, n_sms, g)) return 1;
  out[0] = g.pairs_a_block;
  out[1] = g.blocks;
  out[2] = g.smem_bytes;
  return 0;
}

#ifdef __CUDACC__

// this thread's lane of its pair
struct ThreadPair {
  Lane& L;
  unsigned mask;  // the pair's two lanes of the warp
  template <class F>
  __device__ void each(F f) { f(L); }
  template <class F>
  __device__ bool any(F f) {
    int v = f(L) ? 1 : 0;
    return (v | __shfl_xor_sync(mask, v, 1)) != 0;
  }
  __device__ void sync() { __syncwarp(mask); }
  __device__ bool leader() const { return (threadIdx.x & 1) == 0; }
};

__global__ void __launch_bounds__(FW_MAX_WARPS * 32, 1)
    flow_window_kernel(const FlowPtrs P, const Params K, int pairs_a_block) {
  extern __shared__ int staged[];
  const int p0 = blockIdx.x * pairs_a_block;
  const int np = imin(pairs_a_block, K.n_pairs - p0);
  stage_lanes(P, K, 2 * p0, 2 * np, staged, threadIdx.x, blockDim.x, true);
  __syncthreads();
  const int wl = threadIdx.x & 31;
  const int lp = (threadIdx.x >> 5) * FW_PAIRS_A_WARP + (wl >> 1);
  if ((wl >> 1) < FW_PAIRS_A_WARP && lp < np) {
    const int st = lane_words(K.RS);
    const int li = 2 * lp + (wl & 1);  // the block's lane
    Lane L;
    load_lane(P, K, 2 * p0 + li, staged + li * st, staged + (li ^ 1) * st,
              L);
    L.c.rs = FW_RS;  // a constant trip count for the slot loops
    ThreadPair pr{L, 3u << (wl & 30)};
    run_pair(pr, P, K);
    store_lane(P, 2 * p0 + li, L);
  }
  __syncthreads();
  stage_lanes(P, K, 2 * p0, 2 * np, staged, threadIdx.x, blockDim.x, false);
}

extern "C" int flow_window_launch(int n_pairs, int q, int rs, int n_windows,
                                  int window_us, int max_events,
                                  int ack_every, int sched_batch,
                                  int pull_cap, int gso_segs,
                                  void* const* ptrs, int n_ptrs,
                                  void* stream_ptr) {
  const Params K = fw_params(n_pairs, q, rs, n_windows, window_us,
                             max_events, ack_every, sched_batch, pull_cap,
                             gso_segs);
  if (n_ptrs != FW_N_PTRS || !fw_params_ok(K) || rs != FW_RS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0 || n_windows == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, n_sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g;
  if (!fw_geometry(n_pairs, q, rs, n_sms, g))
    return static_cast<int>(cudaErrorInvalidValue);
  FlowPtrs P;
  memcpy(&P, ptrs, sizeof P);
  const int warps = (g.pairs_a_block + FW_PAIRS_A_WARP - 1) / FW_PAIRS_A_WARP;
  flow_window_kernel<<<g.blocks, warps * 32, g.smem_bytes,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      P, K, g.pairs_a_block);
  return static_cast<int>(cudaGetLastError());
}

#else  // the host build

// lane a then lane b within each phase (b then a when reversed)
struct HostPair {
  Lane* l[2];
  template <class F>
  void each(F f) {
    f(*l[0]);
    f(*l[1]);
  }
  template <class F>
  bool any(F f) {
    bool first = f(*l[0]);
    bool second = f(*l[1]);
    return first || second;
  }
  void sync() {}
  bool leader() const { return true; }
};

extern "C" int flow_window_host(int n_pairs, int q, int rs, int n_windows,
                                int window_us, int max_events, int ack_every,
                                int sched_batch, int pull_cap, int gso_segs,
                                void* const* ptrs, int n_ptrs) {
  const Params K = fw_params(n_pairs, q, rs, n_windows, window_us,
                             max_events, ack_every, sched_batch, pull_cap,
                             gso_segs);
  if (n_ptrs != FW_N_PTRS || !fw_params_ok(K)) return 1;
  FlowPtrs P;
  memcpy(&P, ptrs, sizeof P);
  const int st = lane_words(rs);
  std::vector<int> staged(2 * static_cast<size_t>(st));
  for (int p = 0; p < n_pairs; ++p) {
    stage_lanes(P, K, 2 * p, 2, staged.data(), 0, 1, true);
    Lane a, b;
    load_lane(P, K, 2 * p, staged.data(), staged.data() + st, a);
    load_lane(P, K, 2 * p + 1, staged.data() + st, staged.data(), b);
#ifdef FW_HOST_LANES_REVERSED
    HostPair pr{{&b, &a}};
#else
    HostPair pr{{&a, &b}};
#endif
    run_pair(pr, P, K);
    store_lane(P, 2 * p, a);
    store_lane(P, 2 * p + 1, b);
    stage_lanes(P, K, 2 * p, 2, staged.data(), 0, 1, false);
  }
  return 0;
}

#endif
