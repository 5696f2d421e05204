// The TCP connection state machine for one connection of a thread: the
// scheduled-event handlers and the PULL (next_segment) of kernel F
// (flow_window.cu).
//
// Counterpart of shadow_tpu/tpu/tcp.py (the JAX package writes the
// machine on one connection's scalars and vmaps it) and of the port's
// batched plain version, shadow_tpu_torch/tpu/tcp.py, which it equals bit
// for bit: edit the two together. The JAX code computes every branch and
// selects; here only the branch taken runs. Where a JAX branch that may be
// discarded writes the reassembly or SACK slots (which stay in global
// memory), the write is made only once the branch is known to be taken.
//
// uint32 wire values (iss, irs, last_ts_recv, sequence arithmetic) are
// uint32_t. Adds and multiplies of int32 values that JAX lets wrap go
// through uint32 (add32, mul32): C++ signed overflow is undefined. Every
// division is of a non-negative dividend by a positive constant, except
// the acked-segment count, which uses floordiv32 as jnp's // rounds down.
// JAX's data-dependent while_loops (_avoid_tick, _reass_drain, _sb_next)
// are loops here: a thread may loop as long as its own data needs.
//
// Built with nvcc for sm_90a, and with a host C++ compiler (no __CUDACC__)
// for the host build of flow_window.cu.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FSM_HD __host__ __device__ __forceinline__
#else
#define FSM_HD inline
#endif

namespace fsm {

constexpr int MSS = 1460;
constexpr int TIME_WAIT_MS = 60000;
constexpr int MAX_WSCALE = 14;
constexpr int SYN_RETRIES = 6;
constexpr int DATA_RETRIES = 15;
constexpr int SEND_BUFFER = 131072;
constexpr int RECV_BUFFER = 174760;
constexpr int SACK_SLOTS = 16;
constexpr int SACK_WIRE_BLOCKS = 3;
constexpr int SB_INF = 1 << 30;
constexpr int I32_MAX = 0x7FFFFFFF;
constexpr int INITIAL_CWND = 10;
constexpr int RTO_INIT_MS = 1000;
constexpr int RTO_MIN_MS = 200;
constexpr int RTO_MAX_MS = 120000;
constexpr int N_FIELDS = 16;
constexpr int N_OUT = 18;

enum { FIN = 1, SYN = 2, RST = 4, PSH = 8, ACK = 16 };
enum { CLOSED, LISTEN, SYN_SENT, SYN_RCVD, ESTABLISHED, FIN_WAIT_1,
       FIN_WAIT_2, CLOSING, TIME_WAIT, CLOSE_WAIT, LAST_ACK };
enum { PH_SLOW_START, PH_AVOIDANCE, PH_RECOVERY };
enum { EV_NONE, EV_OPEN_ACTIVE, EV_OPEN_PASSIVE, EV_WRITE, EV_READ,
       EV_CLOSE, EV_ABORT, EV_SEG, EV_PULL, EV_TIMER_RTO, EV_TIMER_PERSIST,
       EV_TIMER_TW };
enum { K_NONE, K_RST, K_SYN, K_RETX, K_PROBE, K_DATA, K_FIN, K_ACK };

FSM_HD int add32(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
FSM_HD int mul32(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
FSM_HD int imin(int a, int b) { return a < b ? a : b; }
FSM_HD int imax(int a, int b) { return a > b ? a : b; }
FSM_HD int floordiv32(int a, int d) {  // d > 0
  int q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}

// One connection's scalars (TcpPlane of tpu/tcp.py, field for field); the
// slot rows stay in global memory.
struct Conn {
  int state, error;
  bool error_consumed;
  uint32_t iss;
  int snd_una, snd_nxt, snd_wnd, stream_len, snd_max;
  bool fin_requested, fin_sent, fin_acked, syn_outstanding;
  int syn_sends;
  bool syn_acked, retx_pending, probe_pending;
  int recover, gbn_high;
  bool rst_pending;
  uint32_t irs;
  int rcv_nxt, ordered_bytes, reass_bytes;
  bool fin_received, has_fin_offset;
  int fin_offset;
  bool ack_pending;
  int my_wscale, peer_wscale;
  bool wscale_ok;
  uint32_t last_ts_recv;
  int srtt_ms, rttvar_ms, rto_ms, backoff_count;
  int cwnd, ssthresh, phase, dup_acks, avoid_acked;
  int rto_gen;
  bool rto_armed;
  int rto_deadline_ms, persist_gen;
  bool persist_armed;
  int persist_deadline_ms, retransmit_count, retransmitted_bytes;
  bool last_retx, sack_on, sack_ok;
  int* sacked_s;  // [SACK_SLOTS]
  int* sacked_e;
  int* reass_off;  // [rs]
  int* reass_len;
  int rs;
};

// -- wire helpers ----------------------------------------------------------

FSM_HD uint32_t wire_seq(const Conn& s, int off) {
  return s.iss + 1u + static_cast<uint32_t>(off);
}
FSM_HD uint32_t wire_ack(const Conn& s) {
  return s.irs + 1u + static_cast<uint32_t>(s.rcv_nxt)
         + (s.fin_received ? 1u : 0u);
}
FSM_HD uint32_t wire_rcv_nxt(const Conn& s) {
  return s.irs + 1u + static_cast<uint32_t>(s.rcv_nxt);
}
FSM_HD int recv_space(const Conn& s) {
  return imax(0, RECV_BUFFER - (s.ordered_bytes + s.reass_bytes));
}
FSM_HD int advertised_window(const Conn& s, bool for_syn) {
  int shift = (for_syn || !s.wscale_ok) ? 0 : s.my_wscale;
  return imin(recv_space(s) >> shift, 0xFFFF);
}
FSM_HD int send_space(const Conn& s) {
  return imax(0, SEND_BUFFER - (s.stream_len - s.snd_una));
}

// -- RTT (RFC 6298, integer ms) ----------------------------------------------

FSM_HD int clamp_rto(int ms) {
  return ms < RTO_MIN_MS ? RTO_MIN_MS : (ms > RTO_MAX_MS ? RTO_MAX_MS : ms);
}
FSM_HD int rto_from_estimate(int srtt, int rttvar) {
  return srtt + 4 * imax(rttvar, RTO_MIN_MS / 4);
}
FSM_HD void rtt_update(Conn& s, int rtt_ms) {
  rtt_ms = imax(1, rtt_ms);
  bool first = s.srtt_ms == 0;
  int d = s.srtt_ms - rtt_ms;
  int rttvar = first ? rtt_ms / 2
                     : (3 * s.rttvar_ms) / 4 + (d < 0 ? -d : d) / 4;
  int srtt = first ? rtt_ms : (7 * s.srtt_ms) / 8 + rtt_ms / 8;
  s.srtt_ms = srtt;
  s.rttvar_ms = rttvar;
  s.backoff_count = 0;
  s.rto_ms = clamp_rto(rto_from_estimate(srtt, rttvar));
}
FSM_HD void rtt_backoff(Conn& s) {
  s.backoff_count += 1;
  s.rto_ms = clamp_rto(mul32(s.rto_ms, 2));
}
FSM_HD void rtt_reset_backoff(Conn& s) {
  if (s.backoff_count > 0) {
    s.backoff_count = 0;
    s.rto_ms = clamp_rto(s.srtt_ms > 0
                             ? rto_from_estimate(s.srtt_ms, s.rttvar_ms)
                             : RTO_INIT_MS);
  }
}

// -- Reno --------------------------------------------------------------------

FSM_HD void avoid_tick(int& cwnd, int& acked, int n) {
  acked = add32(acked, n);
  while (acked >= cwnd) {
    acked -= cwnd;
    cwnd += 1;
  }
}
FSM_HD void cong_new_ack(Conn& s, int n) {
  s.dup_acks = 0;
  if (s.phase == PH_RECOVERY) {
    int cw = s.ssthresh, aa = 0;
    avoid_tick(cw, aa, n);
    s.cwnd = cw;
    s.avoid_acked = aa;
    s.phase = PH_AVOIDANCE;
  } else if (s.phase == PH_SLOW_START) {
    int nc = add32(s.cwnd, n);
    if (nc >= s.ssthresh) {
      int cw = s.ssthresh, aa = 0;
      avoid_tick(cw, aa, imax(nc - s.ssthresh, 0));
      s.cwnd = cw;
      s.avoid_acked = aa;
      s.phase = PH_AVOIDANCE;
    } else {
      s.cwnd = nc;
    }
  } else {
    avoid_tick(s.cwnd, s.avoid_acked, n);
  }
}
FSM_HD bool cong_dup_ack(Conn& s) {  // returns fast_retransmit_now
  if (s.phase == PH_RECOVERY) {
    s.cwnd += 1;
    return false;
  }
  s.dup_acks += 1;
  if (s.dup_acks == 3) {
    int ssthresh = s.cwnd / 2 + 1;
    s.ssthresh = ssthresh;
    s.cwnd = ssthresh + 3;
    s.phase = PH_RECOVERY;
    return true;
  }
  return false;
}
FSM_HD void cong_timeout(Conn& s) {
  s.dup_acks = 0;
  s.ssthresh = s.cwnd / 2 + 1;
  s.cwnd = INITIAL_CWND;
  s.phase = PH_SLOW_START;
}

// -- timers --------------------------------------------------------------------

FSM_HD void arm_rto(Conn& s, int now_ms) {
  s.rto_gen += 1;
  s.rto_armed = true;
  s.rto_deadline_ms = add32(now_ms, s.rto_ms);
}
FSM_HD void disarm_rto(Conn& s) {
  s.rto_gen += 1;
  s.rto_armed = false;
}
FSM_HD void arm_persist(Conn& s, int now_ms) {
  if (!s.persist_armed) {
    s.persist_gen += 1;
    s.persist_armed = true;
    s.persist_deadline_ms = add32(now_ms, s.rto_ms);
  }
}
FSM_HD void enter_closed(Conn& s, int errno_) {
  s.state = CLOSED;
  disarm_rto(s);
  if (errno_ != 0 && s.error == 0) s.error = errno_;
  s.persist_gen += 1;
}
FSM_HD void enter_time_wait(Conn& s, int now_ms) {
  s.state = TIME_WAIT;
  disarm_rto(s);
  s.rto_deadline_ms = add32(now_ms, TIME_WAIT_MS);
}

// -- reassembly ------------------------------------------------------------------

// _reass_insert: union every live slot the range touches into the first
// of them (clearing the others), else take the first free slot, else drop.
FSM_HD void reass_insert(Conn& s, int off, int len) {
  int* ro = s.reass_off;
  int* rl = s.reass_len;
  int end = off + len;
  int first = -1, new_off = off, new_end = end;
  for (int j = 0; j < s.rs; ++j) {
    if (rl[j] > 0 && ro[j] <= end && off <= ro[j] + rl[j]) {
      if (first < 0) first = j;
      new_off = imin(new_off, ro[j]);
      new_end = imax(new_end, ro[j] + rl[j]);
    }
  }
  if (first >= 0) {
    for (int j = first + 1; j < s.rs; ++j)
      if (rl[j] > 0 && ro[j] <= end && off <= ro[j] + rl[j]) rl[j] = 0;
    ro[first] = new_off;
    rl[first] = new_end - new_off;
  } else {
    for (int j = 0; j < s.rs; ++j) {
      if (rl[j] == 0) {
        ro[j] = off;
        rl[j] = len;
        break;
      }
    }
  }
  int bytes = 0;
  for (int j = 0; j < s.rs; ++j) bytes += rl[j] > 0 ? rl[j] : 0;
  s.reass_bytes = bytes;
}

// _reass_drain: advance rcv_nxt through contiguous coverage, free the
// consumed slots.
FSM_HD void reass_drain(Conn& s) {
  int* ro = s.reass_off;
  int* rl = s.reass_len;
  int off0 = s.rcv_nxt, off = off0;
  for (;;) {
    int best = off;
    for (int j = 0; j < s.rs; ++j)
      if (rl[j] > 0 && ro[j] <= off && off < ro[j] + rl[j])
        best = imax(best, ro[j] + rl[j]);
    if (best <= off) break;
    off = best;
  }
  int bytes = 0;
  for (int j = 0; j < s.rs; ++j) {
    if (!(rl[j] > 0 && ro[j] + rl[j] > off)) rl[j] = 0;
    bytes += rl[j];
  }
  s.rcv_nxt = off;
  s.reass_bytes = bytes;
  s.ordered_bytes += off - off0;
}

// -- SACK scoreboard -------------------------------------------------------------

FSM_HD void sb_insert(int* ss, int* se, int start, int end, int una) {
  start = imax(start, una);
  if (!(start < end)) return;
  int first_ov = -1, first_empty = -1;
  for (int j = 0; j < SACK_SLOTS; ++j) {
    bool live = se[j] > ss[j];
    if (live && ss[j] <= start && end <= se[j]) return;  // contained
    if (live && start <= se[j] && ss[j] <= end && first_ov < 0) first_ov = j;
    if (!live && first_empty < 0) first_empty = j;
  }
  if (first_ov >= 0) {
    ss[first_ov] = imin(ss[first_ov], start);
    se[first_ov] = imax(se[first_ov], end);
  } else if (first_empty >= 0) {
    ss[first_empty] = start;
    se[first_empty] = end;
  }
}
FSM_HD void sb_prune(int* ss, int* se, int una) {
  for (int j = 0; j < SACK_SLOTS; ++j) {
    if (se[j] > ss[j]) {
      int s2 = imax(ss[j], una);
      if (s2 >= se[j]) {
        ss[j] = 0;
        se[j] = 0;
      } else {
        ss[j] = s2;
      }
    }
  }
}
// (off', cap): the first unSACKed offset >= off, the bytes to the next
// range above it (SB_INF when none)
FSM_HD int sb_next(const int* ss, const int* se, int off, int& cap) {
  for (;;) {
    int best = off;
    for (int j = 0; j < SACK_SLOTS; ++j)
      if (se[j] > ss[j] && ss[j] <= off && off < se[j])
        best = imax(best, se[j]);
    if (best <= off) break;
    off = best;
  }
  cap = SB_INF;
  for (int j = 0; j < SACK_SLOTS; ++j)
    if (se[j] > ss[j] && ss[j] > off) cap = imin(cap, ss[j] - off);
  return off;
}

// _recv_sack_blocks: the reassembly ranges merged (touching ranges join),
// the lowest three blocks as wire bits. A block opens at the smallest
// start above the running maximum of the earlier ends and runs while the
// next start lies at or below its running end.
FSM_HD int recv_sack_blocks(const Conn& s, int ws[3], int we[3]) {
  const int* ro = s.reass_off;
  const int* rl = s.reass_len;
  int cnt = 0, m_s[3] = {0, 0, 0}, m_e[3] = {0, 0, 0};
  int run_max = -1;
  while (cnt < SACK_WIRE_BLOCKS) {
    int bs = I32_MAX;
    for (int j = 0; j < s.rs; ++j)
      if (rl[j] > 0 && ro[j] > run_max) bs = imin(bs, ro[j]);
    if (bs == I32_MAX) break;
    int be = run_max;
    for (;;) {
      int nb = be;
      for (int j = 0; j < s.rs; ++j)
        if (rl[j] > 0 && ro[j] >= bs && ro[j] <= imax(be, bs))
          nb = imax(nb, ro[j] + rl[j]);
      if (nb <= be) break;
      be = nb;
    }
    m_s[cnt] = bs;
    m_e[cnt] = be;
    cnt += 1;
    run_max = be;
  }
  bool has = s.sack_ok && cnt > 0;
  uint32_t base = s.irs + 1u;
  for (int k = 0; k < 3; ++k) {
    bool sel = has && k < cnt;
    ws[k] = sel ? static_cast<int>(base + static_cast<uint32_t>(m_s[k])) : 0;
    we[k] = sel ? static_cast<int>(base + static_cast<uint32_t>(m_e[k])) : 0;
  }
  return has ? cnt : 0;
}

// -- scheduled events --------------------------------------------------------------

FSM_HD void ev_open_active(Conn& s, const int* f, int now_ms) {
  s.iss = static_cast<uint32_t>(f[0]);
  s.state = SYN_SENT;
  arm_rto(s, now_ms);
}

FSM_HD void ev_open_passive(Conn& s, const int* f, int now_ms) {
  bool has_ws = f[3] >= 0;
  s.iss = static_cast<uint32_t>(f[0]);
  s.irs = static_cast<uint32_t>(f[1]);
  s.rcv_nxt = 0;
  if (has_ws) s.peer_wscale = imin(f[3], MAX_WSCALE);
  s.wscale_ok = has_ws;
  if (!has_ws) s.my_wscale = 0;
  s.snd_wnd = f[2];
  if (f[4] != 0) s.last_ts_recv = static_cast<uint32_t>(f[4]);
  s.sack_ok = f[6] != 0 && s.sack_on;
  s.state = SYN_RCVD;
  arm_rto(s, now_ms);
}

FSM_HD void maybe_apply_fin(Conn& s, int now_ms) {
  if (!s.fin_received && s.has_fin_offset && s.fin_offset <= s.rcv_nxt) {
    s.fin_received = true;
    if (s.state == ESTABLISHED) {
      s.state = CLOSE_WAIT;
    } else if (s.state == FIN_WAIT_1 && s.fin_acked) {
      enter_time_wait(s, now_ms);
    } else if (s.state == FIN_WAIT_1) {
      s.state = CLOSING;
    } else if (s.state == FIN_WAIT_2) {
      enter_time_wait(s, now_ms);
    }
  }
}

FSM_HD void process_ack(Conn& s, const int* f, int now_ms) {
  uint32_t wire_ack_u = static_cast<uint32_t>(f[2]);
  int paylen = f[4], wnd = f[3], ts_echo = f[7];
  uint32_t delta = wire_ack_u - wire_seq(s, s.snd_una);
  bool is_fwd = delta < 0x80000000u;
  uint32_t limit =
      static_cast<uint32_t>(imax(s.snd_nxt, s.snd_max) - s.snd_una);
  bool fwd_valid = is_fwd && delta <= limit;
  if (is_fwd && !fwd_valid) return;  // an ack of bytes never sent
  int adv = fwd_valid ? static_cast<int>(delta) : 0;
  bool is_eq = fwd_valid && delta == 0;
  int ack_off = s.snd_una + adv;

  // SYN_RCVD completing ACK: any forward-valid ack
  if (s.state == SYN_RCVD && (is_eq || adv > 0)) {
    s.syn_acked = true;
    s.state = ESTABLISHED;
    disarm_rto(s);
    if (ts_echo != 0 && s.backoff_count == 0)
      rtt_update(s, now_ms - ts_echo);
  }
  // SACK blocks -> scoreboard, clipped at the pre-advance snd_una
  uint32_t base0 = wire_seq(s, 0);
  int lim = imax(s.snd_nxt, s.snd_max);
  for (int k = 0; k < SACK_WIRE_BLOCKS; ++k) {
    int s_off = static_cast<int>(static_cast<uint32_t>(f[10 + 2 * k]) - base0);
    int e_off = static_cast<int>(static_cast<uint32_t>(f[11 + 2 * k]) - base0);
    if (s.sack_ok && k < f[9] && s_off >= 0 && e_off >= 0 && s_off < e_off
        && e_off <= lim)
      sb_insert(s.sacked_s, s.sacked_e, s_off, e_off, s.snd_una);
  }
  int fin_off = s.stream_len + 1;
  int new_window = static_cast<int>(static_cast<uint32_t>(wnd)
                                    << (s.wscale_ok ? s.peer_wscale : 0));

  if (adv > 0) {  // new data acked
    int acked_bytes = imin(ack_off, s.stream_len) - s.snd_una;
    s.snd_una = imin(ack_off, s.stream_len);
    if (s.fin_sent && ack_off >= fin_off) {
      s.fin_acked = true;
      s.snd_una = s.stream_len;
    }
    s.snd_nxt = imax(s.snd_nxt, s.snd_una);
    sb_prune(s.sacked_s, s.sacked_e, s.snd_una);
    int n_seg = floordiv32(acked_bytes + MSS - 1, MSS);
    bool partial = s.phase == PH_RECOVERY && ack_off < s.recover;
    if (acked_bytes > 0) {
      if (partial) {
        s.cwnd = imax(1, s.cwnd - n_seg + 1);
        s.retx_pending = true;
      } else {
        cong_new_ack(s, n_seg);
        s.retx_pending = false;
      }
    } else {
      s.retx_pending = false;
    }
    if (ts_echo != 0 && s.backoff_count == 0)
      rtt_update(s, now_ms - ts_echo);
    rtt_reset_backoff(s);
    if (s.snd_nxt > s.snd_una || (s.fin_sent && !s.fin_acked))
      arm_rto(s, now_ms);
    else
      disarm_rto(s);
    if (s.fin_acked && s.state == FIN_WAIT_1) {
      s.state = FIN_WAIT_2;
    } else if (s.fin_acked && s.state == CLOSING) {
      enter_time_wait(s, now_ms);
    } else if (s.fin_acked && s.state == LAST_ACK) {
      enter_closed(s, 0);
    }
  } else if (is_eq && paylen == 0 && s.snd_nxt > s.snd_una
             && new_window == s.snd_wnd && new_window > 0) {  // dup ack
    if (cong_dup_ack(s)) {
      s.retx_pending = true;
      s.recover = s.snd_nxt;
    }
  }
  s.snd_wnd = new_window;
  if (s.snd_wnd == 0 && s.stream_len > s.snd_nxt) arm_persist(s, now_ms);
}

FSM_HD void process_payload(Conn& s, const int* f, int now_ms) {
  uint32_t seq_u = static_cast<uint32_t>(f[1]);
  int paylen = f[4];
  bool tw = s.state == TIME_WAIT;
  uint32_t base = wire_rcv_nxt(s);
  uint32_t delta = seq_u - base;
  bool is_fwd = delta < 0x80000000u;
  int back = static_cast<int>(base - seq_u);  // valid when !is_fwd
  bool pure_dup = !is_fwd && back >= paylen;
  int space = recv_space(s);
  bool beyond = is_fwd && static_cast<int>(delta) >= space;
  if (!tw && !pure_dup && !beyond) {
    int eff_off = is_fwd ? s.rcv_nxt + static_cast<int>(delta) : s.rcv_nxt;
    int raw_len = is_fwd ? paylen : paylen - back;
    int eff_len = imin(raw_len, space - (eff_off - s.rcv_nxt));
    if (eff_len > 0) {
      reass_insert(s, eff_off, eff_len);
      reass_drain(s);
    }
  }
  s.ack_pending = true;
  if (!(tw || pure_dup || beyond)) maybe_apply_fin(s, now_ms);
}

FSM_HD void process_fin(Conn& s, const int* f, int now_ms) {
  uint32_t end = static_cast<uint32_t>(f[1]) + static_cast<uint32_t>(f[4]);
  uint32_t delta = end - wire_rcv_nxt(s);
  bool is_fwd = delta < 0x80000000u;
  int dd = static_cast<int>(delta & 0x7FFFFFFFu);
  dd = imin(dd, 1 << 30);
  int fin_off = is_fwd ? s.rcv_nxt + dd : s.rcv_nxt;
  if (!s.has_fin_offset) s.fin_offset = fin_off;
  s.has_fin_offset = true;
  s.ack_pending = true;
  maybe_apply_fin(s, now_ms);
}

FSM_HD void on_segment_syn_sent(Conn& s, const int* f, int now_ms) {
  int flags = f[0];
  bool is_rst = flags & RST, is_syn = flags & SYN, is_ack = flags & ACK;
  uint32_t ack_u = static_cast<uint32_t>(f[2]);
  uint32_t expect = s.iss + 1u;
  bool has_ws = f[5] >= 0;
  if (is_rst) {
    if (is_ack && ack_u == expect) enter_closed(s, 111);
  } else if (is_syn && is_ack) {
    if (ack_u != expect) {
      s.rst_pending = true;
      return;
    }
    s.irs = static_cast<uint32_t>(f[1]);
    s.rcv_nxt = 0;
    s.syn_acked = true;
    s.syn_outstanding = false;
    if (has_ws) s.peer_wscale = imin(f[5], MAX_WSCALE);
    s.wscale_ok = has_ws;
    if (!has_ws) s.my_wscale = 0;
    s.sack_ok = f[8] != 0 && s.sack_on;
    s.snd_wnd = f[3];
    s.state = ESTABLISHED;
    s.ack_pending = true;
    disarm_rto(s);
    if (f[7] != 0 && s.backoff_count == 0) rtt_update(s, now_ms - f[7]);
  } else if (is_syn) {  // simultaneous open
    s.irs = static_cast<uint32_t>(f[1]);
    s.rcv_nxt = 0;
    if (has_ws) s.peer_wscale = imin(f[5], MAX_WSCALE);
    s.wscale_ok = has_ws;
    s.sack_ok = f[8] != 0 && s.sack_on;
    s.snd_wnd = f[3];
    s.state = SYN_RCVD;
    s.syn_outstanding = false;
    s.syn_sends = 0;
  }
}

FSM_HD void ev_segment(Conn& s, const int* f, int now_ms) {
  int flags = f[0];
  bool is_rst = flags & RST;
  if (s.state == CLOSED) {  // a non-RST segment elicits a RESET
    s.rst_pending = s.rst_pending || !is_rst;
    return;
  }
  if (f[6] != 0) s.last_ts_recv = static_cast<uint32_t>(f[6]);
  if (s.state == SYN_SENT) {
    on_segment_syn_sent(s, f, now_ms);
    return;
  }
  bool tw = s.state == TIME_WAIT;
  if (is_rst) {
    enter_closed(s, tw ? 0 : 104);
    return;
  }
  if (flags & SYN) {  // SYN outside the handshake
    uint32_t syn_seq = static_cast<uint32_t>(f[1]);
    if (s.state == SYN_RCVD && syn_seq == s.irs) {
      s.syn_outstanding = false;
    } else if (!tw) {
      uint32_t d = wire_rcv_nxt(s) - syn_seq;
      if (d != 0 && d < 0x80000000u)
        s.ack_pending = true;  // an old duplicate SYN: ACK, never RST
      else
        s.rst_pending = true;
    }
    return;
  }
  if (flags & ACK) process_ack(s, f, now_ms);
  if (f[4] > 0) process_payload(s, f, now_ms);
  if (flags & FIN) process_fin(s, f, now_ms);
}

FSM_HD void ev_timer_rto(Conn& s, const int* f, int now_ms) {
  if (f[0] != s.rto_gen || s.state == CLOSED) return;
  s.rto_armed = false;
  bool handshake = s.state == SYN_SENT || s.state == SYN_RCVD;
  bool in_flight = s.snd_nxt > s.snd_una || (s.fin_sent && !s.fin_acked)
                   || handshake;
  if (!in_flight) return;
  if (s.backoff_count >= (handshake ? SYN_RETRIES : DATA_RETRIES)) {
    enter_closed(s, 110);
    return;
  }
  rtt_backoff(s);
  cong_timeout(s);
  if (handshake) {
    s.syn_outstanding = false;
  } else {
    s.gbn_high = imax(s.gbn_high, s.snd_nxt);
    s.snd_nxt = s.snd_una;
    s.retx_pending = false;
    s.fin_sent = s.fin_sent && s.fin_acked;
    if (s.snd_wnd == 0 && s.stream_len > s.snd_nxt) arm_persist(s, now_ms);
  }
  arm_rto(s, now_ms);
}

FSM_HD void ev_timer_tw(Conn& s, const int* f) {
  if (f[0] == s.rto_gen) enter_closed(s, 0);
}

FSM_HD void ev_timer_persist(Conn& s, const int* f, int now_ms) {
  if (f[0] != s.persist_gen || s.state == CLOSED) return;
  s.persist_armed = false;
  if (!(s.snd_wnd == 0 && s.stream_len > s.snd_nxt)) return;
  s.probe_pending = true;
  rtt_backoff(s);
  s.persist_gen += 1;
  s.persist_armed = true;
  s.persist_deadline_ms = add32(now_ms, s.rto_ms);
}

// tcp_sched_step for one connection
FSM_HD void sched_step(Conn& s, int kind, const int* f, int now_ms) {
  switch (kind) {
    case EV_OPEN_ACTIVE: ev_open_active(s, f, now_ms); break;
    case EV_OPEN_PASSIVE: ev_open_passive(s, f, now_ms); break;
    case EV_SEG: ev_segment(s, f, now_ms); break;
    case EV_TIMER_RTO: ev_timer_rto(s, f, now_ms); break;
    case EV_TIMER_PERSIST: ev_timer_persist(s, f, now_ms); break;
    case EV_TIMER_TW: ev_timer_tw(s, f); break;
    default: break;
  }
}

// -- egress (PULL = next_segment) ------------------------------------------------

FSM_HD int next_kind(const Conn& s) {
  int st = s.state;
  if (s.rst_pending) return K_RST;
  if ((st == SYN_SENT || st == SYN_RCVD) && !s.syn_outstanding) return K_SYN;
  if (st == SYN_SENT) return K_NONE;
  if (s.retx_pending && s.snd_nxt > s.snd_una) return K_RETX;
  if (s.probe_pending && s.stream_len > s.snd_nxt) return K_PROBE;
  bool can_data =
      (st == ESTABLISHED || st == CLOSE_WAIT || st == FIN_WAIT_1
       || st == CLOSING || st == LAST_ACK)
      && s.snd_nxt < s.stream_len
      && s.snd_nxt - s.snd_una < imin(mul32(s.cwnd, MSS), s.snd_wnd);
  if (can_data) return K_DATA;
  if (s.fin_requested && !s.fin_sent && s.snd_nxt >= s.stream_len
      && (st == FIN_WAIT_1 || st == LAST_ACK || st == CLOSING))
    return K_FIN;
  if (s.ack_pending && st != CLOSED) return K_ACK;
  return K_NONE;
}

// _ev_pull: out = (has, flags, seq, ack, window, paylen, wscale, ts,
// ts_echo, retransmit, sack_permitted, nsack, s1, e1, s2, e2, s3, e3)
FSM_HD void ev_pull(Conn& s, int now_ms, int gso_segs, int* out) {
  int kind = next_kind(s);
  for (int k = 0; k < N_OUT; ++k) out[k] = 0;
  if (kind == K_NONE) {
    s.last_retx = false;
    return;
  }
  const int ts = now_ms & 0x7FFFFFFF;
  const int ts_echo = static_cast<int>(s.last_ts_recv);
  const int wack = static_cast<int>(wire_ack(s));
  const int awnd = advertised_window(s, false);
  const int before_nxt = s.snd_nxt;
  out[0] = 1;
  out[6] = -1;
  out[3] = wack;
  out[4] = awnd;
  out[7] = ts;
  out[8] = ts_echo;
  if (kind != K_RST && kind != K_SYN) {
    int ws[3], we[3];
    out[11] = recv_sack_blocks(s, ws, we);
    for (int k = 0; k < 3; ++k) {
      out[12 + 2 * k] = ws[k];
      out[13 + 2 * k] = we[k];
    }
  }
  switch (kind) {
    case K_RST: {
      out[1] = RST | ACK;
      out[2] = static_cast<int>(wire_seq(s, imin(s.snd_nxt, s.stream_len)));
      out[4] = 0;
      out[7] = 0;
      out[8] = 0;
      s.rst_pending = false;
      enter_closed(s, 104);
      break;
    }
    case K_SYN: {
      bool syn_is_sent = s.state == SYN_SENT;
      bool syn_retx = s.syn_sends + 1 > 1;
      out[1] = syn_is_sent ? SYN : (SYN | ACK);
      out[2] = static_cast<int>(s.iss);
      out[3] = syn_is_sent ? 0 : wack;
      out[4] = advertised_window(s, true);
      out[6] = s.my_wscale;
      out[9] = syn_retx;
      out[10] = s.sack_on;
      s.syn_outstanding = true;
      s.syn_sends += 1;
      s.retransmit_count += syn_retx;
      s.ack_pending = false;
      break;
    }
    case K_RETX: {
      int r_cap;
      sb_next(s.sacked_s, s.sacked_e, s.snd_una, r_cap);
      int r_n = imin(imin(MSS, s.stream_len - s.snd_una), r_cap);
      int fin_seq = imin(s.snd_nxt, s.stream_len + (s.fin_sent ? 1 : 0));
      out[9] = 1;
      s.retx_pending = false;
      s.retransmit_count += 1;
      if (r_n > 0) {
        out[1] = ACK;
        out[2] = static_cast<int>(wire_seq(s, s.snd_una));
        out[5] = r_n;
        s.retransmitted_bytes += r_n;
        if (!s.rto_armed) arm_rto(s, now_ms);
      } else if (s.fin_sent) {
        out[1] = FIN | ACK;
        out[2] = static_cast<int>(wire_seq(s, s.stream_len));
        s.ack_pending = false;
        if (!s.rto_armed) arm_rto(s, now_ms);
      } else {
        out[1] = ACK;
        out[2] = static_cast<int>(wire_seq(s, fin_seq));
        s.ack_pending = false;
      }
      break;
    }
    case K_PROBE: {
      out[1] = ACK;
      out[2] = static_cast<int>(wire_seq(s, s.snd_nxt));
      out[5] = 1;
      out[9] = 1;
      s.probe_pending = false;
      s.snd_max = imax(s.snd_max, s.snd_nxt + 1);
      s.snd_nxt += 1;
      if (!s.rto_armed) arm_rto(s, now_ms);
      break;
    }
    case K_DATA: {
      int off0 = s.snd_nxt, d_cap;
      int off = sb_next(s.sacked_s, s.sacked_e, off0, d_cap);
      int window = imin(mul32(s.cwnd, MSS), s.snd_wnd);
      int n_data = imin(imin(imin(MSS * gso_segs, s.stream_len - off),
                             window - (off - s.snd_una)), d_cap);
      bool d_has = n_data > 0;
      int n_eff = imax(n_data, 0);
      bool data_gbn = before_nxt < s.gbn_high;
      uint32_t seq_data = wire_seq(s, off);
      s.snd_nxt = d_has ? off + n_eff : imax(off, off0);
      s.snd_max = imax(s.snd_max, d_has ? off + n_eff : off);
      s.ack_pending = false;
      if (d_has && !s.rto_armed) arm_rto(s, now_ms);
      s.retransmit_count += data_gbn;
      if (data_gbn && d_has) s.retransmitted_bytes += n_eff;
      int d_ack_seq = imin(s.snd_nxt, s.stream_len + (s.fin_sent ? 1 : 0));
      out[1] = d_has ? (s.snd_nxt >= s.stream_len ? (ACK | PSH) : ACK) : ACK;
      out[2] = static_cast<int>(d_has ? seq_data : wire_seq(s, d_ack_seq));
      out[5] = d_has ? n_data : 0;
      out[9] = data_gbn;
      break;
    }
    case K_FIN: {
      bool fin_gbn = before_nxt < s.gbn_high;
      out[1] = FIN | ACK;
      out[2] = static_cast<int>(wire_seq(s, s.stream_len));
      out[9] = fin_gbn;
      s.fin_sent = true;
      s.snd_nxt = s.stream_len + 1;
      s.snd_max = imax(s.snd_max, s.stream_len + 1);
      s.ack_pending = false;
      if (!s.rto_armed) arm_rto(s, now_ms);
      s.retransmit_count += fin_gbn;
      break;
    }
    default: {  // K_ACK
      out[1] = ACK;
      out[2] = static_cast<int>(
          wire_seq(s, imin(s.snd_nxt, s.stream_len + (s.fin_sent ? 1 : 0))));
      s.ack_pending = false;
      break;
    }
  }
  s.last_retx = out[9] > 0;
}

}  // namespace fsm
