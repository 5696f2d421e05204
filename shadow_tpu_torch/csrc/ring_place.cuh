// The placement of routed arrivals into the destination ingress rings, for
// Hopper (sm_90a): the device code of kernels B (route_place.cu) and D
// (route_scatter.cu), which compute the same function.
//
// For destination row r of the [N, CI] rings, with nv = nv[r], off =
// offsets[r] and take = take[r], slot c is placed when nv <= c < nv + take.
// It takes arrival j = off - nv + c of the arrival-sorted order, read
// through the routing permutation rather than from materialised streams:
//
//   p   = o_pos[j]                  (its flat egress slot, in seq order)
//   src = p / CE                    (its source row)
//   g   = src * CE + row_perm[p]    (its slot in the sorted egress columns)
//
// and its seq, sock, bytes and deliver are eg_seq[g], eg_sock[g],
// eg_bytes[g] and deliver_rel[g]; for j outside [0, N*CE) all five columns
// are 0 (the TPU kernel's clip into the streams' zero padding). A placed
// slot becomes valid. Every other slot keeps its values, except that an
// invalid one gets deliver = I32_MAX where it differs (the routing stage's
// select before the TPU kernel). The rings are updated in place: a slot
// that changes is the only one written.
//
// The source rows (row_perm, the eg_* columns and the N*CE entries of
// o_pos) are an axis of their own, `src_rows` a world: under a host-axis
// mesh a rank places into its own N_local destination rows the arrivals of
// all R*N_local source hosts, which the routing exchange gathered, and src
// is then the global source host. Without a mesh src_rows = N.
//
// An ensemble of W worlds is one launch over W * N rows: the rows are the
// worlds' rows one world after another, `world_rows` (N) a world, and
// o_pos, row_perm, src and the arrival index j are each world's own (as in
// a solo launch), so a row reads only its world's arrivals: with base =
// (row / world_rows) * src_rows * CE, the first flat egress slot of the
// row's world, p = o_pos[base + j], g = base + src * CE + row_perm[base +
// p], and j is inside when 0 <= j < src_rows * CE. An ensemble has
// src_rows = world_rows (no mesh under an ensemble); a solo launch has
// world_rows = n_rows and base = 0.
//
// What bounds it on the card: not bytes. At the main path's shape (N=32768,
// CE=16, CI=32) a window places ~49 k of the 1,048,576 slots; the kernel
// reads 12 B a row, valid + deliver (5 B) a slot, and 8 + 4 + 16 B for a
// placed slot, and writes 21 B a placed slot: ~8 MB, ~2.4 us at 3.35 TB/s.
// A placed slot's reads are a chain three loads deep (o_pos -> row_perm ->
// payload), each at L2 or HBM latency, and only ~5 % of the slots have
// one, so the kernel is bound by how many chains it keeps in flight. The
// design: a segment of lanes a destination row, each lane serving
// kSlots = 4 slots of it (seg apart, so a segment's loads stay coalesced)
// at once, stage by stage: the slots' valid and deliver, then the placed
// ones' o_pos, then row_perm, then the four payload words, so a lane has
// up to four independent chains in flight. For CI=32 that is 8 lanes a
// row, 4 rows a warp; a narrower ring takes fewer lanes, a wider one
// loops. Lane 0 of a segment loads the row's nv/offsets/take and a
// shuffle broadcasts them. Blocks of 256 threads held to 64 registers
// (`__launch_bounds__(256, 4)`), with no spills: on an H100, one slot a
// lane (a warp a row) ran twice as long in the window, and variants that
// spilled or took 1, 2 or 8 slots a lane were slower too (PERF.md). There
// is no dense tile, so neither tensor cores nor TMA apply: a TMA tile copy
// does nothing for scattered 4 B reads. A slot is owned by one lane, which
// reads it before it writes it, so the in-place update has no race.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring_place {

constexpr int kBlock = 256;
constexpr int kSlots = 4;  // slots a lane serves at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kI32Max = 0x7fffffff;

struct Args {
  int n_rows;      // W * N: destination rows
  int world_rows;  // N: the destination rows of one world
  int src_rows;    // the source rows of one world (N without a mesh)
  int ci;          // ingress ring width
  int ce;          // egress row width
  int seg;         // lanes a destination row: a power of two <= 32
  int64_t n_items; // src_rows * CE arrivals a world
  const int* nv;
  const int* offsets;
  const int* take;
  const long long* o_pos;
  const int* row_perm;
  const int* eg_seq;
  const int* eg_sock;
  const int* eg_bytes;
  const int* deliver_rel;
  int* in_src;
  int* in_seq;
  int* in_sock;
  int* in_bytes;
  int* in_deliver;
  uint8_t* in_valid;
};

// The lanes a destination row: the largest power of two <= min(ci, 32 *
// kSlots), over kSlots, and at least 1.
inline int segment_lanes(int ci) {
  int width = 32 * kSlots;
  while (width > ci && width > 1) width >>= 1;
  return width >= kSlots ? width / kSlots : 1;
}

// One thread's part of the placement: lane `threadIdx.x % seg` of the
// segment that serves destination row (global thread) / seg, kSlots slots
// (seg apart) at a time.
__device__ __forceinline__ void place_rows(const Args& a) {
  const int seg = a.seg;
  const int sl = threadIdx.x & (seg - 1);
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / seg;
  const bool live_row = row < a.n_rows;
  int n0 = 0, off = 0, t0 = 0;
  if (live_row && sl == 0) {
    n0 = a.nv[row];
    off = a.offsets[row];
    t0 = a.take[row];
  }
  // every lane of the warp takes part in the broadcast, dead rows too
  n0 = __shfl_sync(kFull, n0, 0, seg);
  off = __shfl_sync(kFull, off, 0, seg);
  t0 = __shfl_sync(kFull, t0, 0, seg);
  if (!live_row) return;
  // the first flat egress slot of the row's world
  const int64_t base =
      (row / a.world_rows) * static_cast<int64_t>(a.src_rows) * a.ce;
  const int64_t first = n0;
  const int64_t end = first + t0;
  const int64_t lo = static_cast<int64_t>(off) - n0;
  for (int c0 = sl; c0 < a.ci; c0 += seg * kSlots) {
    int64_t e[kSlots], j[kSlots], p[kSlots], g[kSlots];
    bool live[kSlots], placed[kSlots], inside[kSlots], was_valid[kSlots];
    int deliver[kSlots], src[kSlots], seq[kSlots], sock[kSlots];
    int nbytes[kSlots], del[kSlots];
    // each stage's loads are independent across the kSlots slots, so a
    // lane keeps kSlots chains in flight
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = c0 + k * seg;
      live[k] = c < a.ci;
      e[k] = row * a.ci + c;
      was_valid[k] = live[k] ? a.in_valid[e[k]] != 0 : true;
      deliver[k] = live[k] ? a.in_deliver[e[k]] : kI32Max;
      placed[k] = live[k] && c >= first && c < end;
      j[k] = lo + c;
      inside[k] = placed[k] && j[k] >= 0 && j[k] < a.n_items;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      p[k] = inside[k] ? a.o_pos[base + j[k]] : 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (inside[k]) {
        const int64_t s = p[k] / a.ce;
        g[k] = base + s * a.ce + a.row_perm[base + p[k]];
        src[k] = static_cast<int>(s);
      } else {
        g[k] = 0;
        src[k] = 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      seq[k] = inside[k] ? a.eg_seq[g[k]] : 0;
      sock[k] = inside[k] ? a.eg_sock[g[k]] : 0;
      nbytes[k] = inside[k] ? a.eg_bytes[g[k]] : 0;
      del[k] = inside[k] ? a.deliver_rel[g[k]] : 0;
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (placed[k]) {
        a.in_src[e[k]] = src[k];
        a.in_seq[e[k]] = seq[k];
        a.in_sock[e[k]] = sock[k];
        a.in_bytes[e[k]] = nbytes[k];
        a.in_deliver[e[k]] = del[k];
        a.in_valid[e[k]] = 1;
      } else if (live[k] && !was_valid[k] && deliver[k] != kI32Max) {
        a.in_deliver[e[k]] = kI32Max;
      }
    }
  }
}

// Fill Args from the launchers' plain C arguments (see route_place.cu).
inline Args make_args(int n_rows, int world_rows, int src_rows, int ci,
                      int ce,
                      const void* nv, const void* offsets, const void* take,
                      const void* o_pos,
                      const void* row_perm, const void* eg_seq,
                      const void* eg_sock, const void* eg_bytes,
                      const void* deliver_rel, void* in_src, void* in_seq,
                      void* in_sock, void* in_bytes, void* in_deliver,
                      void* in_valid) {
  Args a;
  a.n_rows = n_rows;
  a.world_rows = world_rows;
  a.src_rows = src_rows;
  a.ci = ci;
  a.ce = ce;
  a.seg = segment_lanes(ci);
  a.n_items = static_cast<int64_t>(src_rows) * ce;
  a.nv = static_cast<const int*>(nv);
  a.offsets = static_cast<const int*>(offsets);
  a.take = static_cast<const int*>(take);
  a.o_pos = static_cast<const long long*>(o_pos);
  a.row_perm = static_cast<const int*>(row_perm);
  a.eg_seq = static_cast<const int*>(eg_seq);
  a.eg_sock = static_cast<const int*>(eg_sock);
  a.eg_bytes = static_cast<const int*>(eg_bytes);
  a.deliver_rel = static_cast<const int*>(deliver_rel);
  a.in_src = static_cast<int*>(in_src);
  a.in_seq = static_cast<int*>(in_seq);
  a.in_sock = static_cast<int*>(in_sock);
  a.in_bytes = static_cast<int*>(in_bytes);
  a.in_deliver = static_cast<int*>(in_deliver);
  a.in_valid = static_cast<uint8_t*>(in_valid);
  return a;
}

// Blocks of kBlock threads for `a`: seg lanes a destination row.
inline unsigned grid_blocks(const Args& a) {
  const int64_t threads = static_cast<int64_t>(a.n_rows) * a.seg;
  return static_cast<unsigned>((threads + kBlock - 1) / kBlock);
}

}  // namespace ring_place
