// Kernel B of the PHOLD window step (the fused `kernel="pallas_fused"`
// path): the bucketed placement of routed arrivals into the destination
// ingress rings, for Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_pipeline.py, _place_kernel (the Pallas
// TPU kernel behind route_place).
//
// The TPU kernel reads five arrival-sorted payload streams, which the
// routing stage materialises and pads for it, because there the whole
// stream sits in VMEM for every tile; it then copies every slot of the
// rings to new outputs, from the stream or from the base. On the card no
// block holds the stream, and a window changes ~4 % of the slots, so this
// kernel reads each placed arrival through the routing permutation and
// writes only the slots that change, in place. The device code, its bound
// and its design are in ring_place.cuh, shared with kernel D
// (route_scatter.cu).

#include "ring_place.cuh"

namespace {

__global__ void __launch_bounds__(ring_place::kBlock, 4)
    route_place_kernel(const ring_place::Args a) {
  ring_place::place_rows(a);
}

}  // namespace

// n_rows = W * world_rows: W worlds of world_rows destination rows each (W
// = 1 for a solo window); src_rows source rows a world (world_rows, but
// the R * N_local gathered hosts of a mesh rank's solo launch). nv,
// offsets, take: [n_rows] int32. o_pos: [W * src_rows * ce] int64, each
// world's entries in [0, src_rows * ce). row_perm, eg_seq, eg_sock,
// eg_bytes, deliver_rel: [W * src_rows, ce] int32. in_src, in_seq,
// in_sock, in_bytes, in_deliver: [n_rows, ci] int32 and in_valid [n_rows,
// ci] bool, updated in place. An ensemble (W > 1) needs src_rows =
// world_rows. Returns the launch's cudaError_t.
extern "C" int route_place_launch(
    int n_rows, int world_rows, int src_rows, int ci, int ce,
    const void* nv, const void* offsets, const void* take, const void* o_pos,
    const void* row_perm, const void* eg_seq, const void* eg_sock,
    const void* eg_bytes, const void* deliver_rel, void* in_src,
    void* in_seq, void* in_sock, void* in_bytes, void* in_deliver,
    void* in_valid, void* stream_ptr) {
  if (n_rows <= 0 || ci <= 0) return static_cast<int>(cudaSuccess);
  if (ce <= 0 || world_rows <= 0 || n_rows % world_rows != 0 ||
      src_rows <= 0 || (world_rows != n_rows && src_rows != world_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const ring_place::Args a = ring_place::make_args(
      n_rows, world_rows, src_rows, ci, ce, nv, offsets, take, o_pos,
      row_perm, eg_seq, eg_sock, eg_bytes, deliver_rel, in_src, in_seq,
      in_sock, in_bytes, in_deliver, in_valid);
  route_place_kernel<<<ring_place::grid_blocks(a), ring_place::kBlock, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
