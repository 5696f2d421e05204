// Kernel D of the PHOLD window step (the split `kernel="pallas"` path): the
// per-destination-row append of routed arrivals into the ingress rings, for
// Hopper (sm_90a).
//
// Replaces: shadow_tpu/tpu/pallas_route.py, _route_kernel (the Pallas TPU
// kernel behind route_scatter).
//
// The TPU kernel computes kernel B's function (route_place.cu) a row at a
// time: each grid step loads a CI-wide window of the materialised,
// arrival-sorted streams at the row's bucket offset and copies the row to
// new outputs. The card needs no such window: this kernel is kernel B's
// design, in ring_place.cuh, which already serves one destination row with
// one segment of lanes, reads each placed arrival through the routing
// permutation and writes only the slots that change, in place. The split
// path hands it the row order of plane._seq_row_order where the fused path
// hands kernel B kernel A's.

#include "ring_place.cuh"

namespace {

__global__ void __launch_bounds__(ring_place::kBlock, 4)
    route_scatter_kernel(const ring_place::Args a) {
  ring_place::place_rows(a);
}

}  // namespace

// The arguments of route_place_launch (route_place.cu). Returns the
// launch's cudaError_t.
extern "C" int route_scatter_launch(
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
  route_scatter_kernel<<<ring_place::grid_blocks(a), ring_place::kBlock, 0,
                         static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
