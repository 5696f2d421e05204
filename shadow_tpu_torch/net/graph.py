"""The network graph: topology parsing and path computation.

The port's own copy of `shadow_tpu/net/graph.py`, for the flow
engine's plan (`core/flowplan.py`) and the Manager: the
GML topology, all-pairs shortest paths by (latency, then loss) as a
Floyd-Warshall over dense [N, N] numpy matrices (path composition
latency_a + latency_b, loss 1-(1-a)(1-b); every used node needs exactly
one self-loop, which supplies the node->node path), direct single-edge
paths otherwise, the `RoutingInfo` tables, and the IP assignment
(`IpAssignment`: from 11.0.0.0, skipping .0 and .255). Built on the host in
numpy, as in JAX.
"""

from __future__ import annotations

import gzip
import ipaddress
import lzma
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core import units
from . import gml

class GraphError(ValueError):
    pass


# The reference's built-in graph (`configuration.rs:1357-1370`).
ONE_GBIT_SWITCH_GRAPH = """graph [
  directed 0
  node [
    id 0
    host_bandwidth_up "1 Gbit"
    host_bandwidth_down "1 Gbit"
  ]
  edge [
    source 0
    target 0
    latency "1 ms"
    packet_loss 0.0
  ]
]"""


@dataclass(frozen=True)
class PathProperties:
    """Network characteristics of a path (`graph/mod.rs:295-331`)."""

    latency_ns: int
    packet_loss: float

    def compose(self, other: "PathProperties") -> "PathProperties":
        return PathProperties(
            self.latency_ns + other.latency_ns,
            1.0 - (1.0 - self.packet_loss) * (1.0 - other.packet_loss),
        )


@dataclass
class ShadowNode:
    id: int
    bandwidth_up: Optional[int]  # bits/sec
    bandwidth_down: Optional[int]


@dataclass
class ShadowEdge:
    source: int
    target: int
    latency_ns: int
    jitter_ns: int
    packet_loss: float


def _parse_node(raw: gml.GmlList) -> ShadowNode:
    node_id = raw.get("id")
    if not isinstance(node_id, int):
        raise GraphError("node requires an integer 'id'")

    def bw(key):
        v = raw.get(key)
        if v is None:
            return None
        if not isinstance(v, str):
            raise GraphError(f"node {node_id}: {key} must be a unit string")
        return units.parse_bits_per_sec(v)

    return ShadowNode(node_id, bw("host_bandwidth_up"), bw("host_bandwidth_down"))


def _parse_edge(raw: gml.GmlList) -> ShadowEdge:
    src, dst = raw.get("source"), raw.get("target")
    if not isinstance(src, int) or not isinstance(dst, int):
        raise GraphError("edge requires integer 'source' and 'target'")
    latency = raw.get("latency")
    if latency is None:
        raise GraphError(f"edge {src}->{dst}: 'latency' was not provided")
    latency_ns = units.parse_duration_ns(latency)
    if latency_ns <= 0:
        raise GraphError(f"edge {src}->{dst}: 'latency' must not be 0")
    jitter = raw.get("jitter")
    jitter_ns = units.parse_duration_ns(jitter) if jitter is not None else 0
    loss = float(raw.get("packet_loss", 0.0))
    if not 0.0 <= loss <= 1.0:
        raise GraphError(f"edge {src}->{dst}: packet_loss must be in [0,1]")
    return ShadowEdge(src, dst, latency_ns, jitter_ns, loss)


def load_graph_text(path: str) -> str:
    """Read GML from a path, transparently decompressing .xz/.gz
    (parity: reference compressed-graph support, `src/test/compressed-graph/`)."""
    if path.endswith(".xz"):
        with lzma.open(path, "rt") as fh:
            return fh.read()
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as fh:
            return fh.read()
    with open(path) as fh:
        return fh.read()


class NetworkGraph:
    """Parsed topology with dense adjacency matrices."""

    def __init__(self, nodes: list[ShadowNode], edges: list[ShadowEdge], directed: bool):
        self.directed = directed
        self.nodes = nodes
        self.edges = edges
        self.node_id_to_index = {n.id: i for i, n in enumerate(nodes)}
        if len(self.node_id_to_index) != len(nodes):
            raise GraphError("duplicate node ids")
        n = len(nodes)
        # Dense adjacency; +inf latency = no edge. float64 holds ns values
        # exactly (< 2^53) and supports inf sentinels.
        lat = np.full((n, n), np.inf)
        loss = np.full((n, n), np.inf)
        count = np.zeros((n, n), dtype=np.int64)
        for e in edges:
            try:
                i, j = self.node_id_to_index[e.source], self.node_id_to_index[e.target]
            except KeyError as missing:
                raise GraphError(f"edge endpoint {missing} doesn't exist") from None
            pairs = [(i, j)] if directed else ({(i, j), (j, i)})
            for a, b in pairs:
                count[a, b] += 1
                # parallel edges: keep the (latency, loss)-lexicographic min
                if (e.latency_ns, e.packet_loss) < (lat[a, b], loss[a, b]):
                    lat[a, b], loss[a, b] = e.latency_ns, e.packet_loss
        self._lat = lat
        self._loss = loss
        self._edge_count = count

    @staticmethod
    def parse(text: str) -> "NetworkGraph":
        g = gml.parse(text)
        directed = bool(g.get("directed", 0))
        nodes = [_parse_node(x) for x in g.get_all("node")]
        edges = [_parse_edge(x) for x in g.get_all("edge")]
        if not nodes:
            raise GraphError("graph has no nodes")
        return NetworkGraph(nodes, edges, directed)

    def node_by_id(self, node_id: int) -> ShadowNode:
        try:
            return self.nodes[self.node_id_to_index[node_id]]
        except KeyError:
            raise GraphError(f"graph node {node_id} doesn't exist") from None

    # -- path computation ---------------------------------------------------

    def _self_loop(self, idx: int) -> tuple[float, float]:
        if self._edge_count[idx, idx] != 1:
            raise GraphError(
                f"node id {self.nodes[idx].id} must have exactly one self-loop "
                f"(found {self._edge_count[idx, idx]})"
            )
        return self._lat[idx, idx], self._loss[idx, idx]

    def compute_shortest_paths(
        self, used_ids: list[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """All-pairs shortest paths over the FULL graph (unused nodes still
        relay), returned as dense [U,U] (latency_ns int64, loss float32)
        matrices over `used_ids` order. Lexicographic (latency, loss) metric,
        matching the reference's Dijkstra weight ordering
        (`graph/mod.rs:305-315`)."""
        lat = self._lat.copy()
        loss = self._loss.copy()
        n = lat.shape[0]
        # Self-loops must not act as intermediate steps: Floyd–Warshall on a
        # latency>0 graph never prefers adding a self-loop, but the initial
        # diagonal would; clear it and re-apply the self-loop contract at the
        # end (the reference replaces Dijkstra's trivial 0-cost self paths
        # with the mandatory self-loop edge, graph/mod.rs:210-217).
        np.fill_diagonal(lat, 0.0)
        np.fill_diagonal(loss, 0.0)
        for k in range(n):
            new_lat = lat[:, k, None] + lat[None, k, :]
            ok_k = 1.0 - (1.0 - loss[:, k, None]) * (1.0 - loss[None, k, :])
            better = (new_lat < lat) | ((new_lat == lat) & (ok_k < loss))
            lat = np.where(better, new_lat, lat)
            loss = np.where(better, ok_k, loss)
        idx = self._used_indices(used_ids)
        out_lat = lat[np.ix_(idx, idx)]
        out_loss = loss[np.ix_(idx, idx)]
        for u, i in enumerate(idx):
            out_lat[u, u], out_loss[u, u] = self._self_loop(i)
        if np.isinf(out_lat).any():
            bad = np.argwhere(np.isinf(out_lat))[0]
            raise GraphError(
                f"no path between graph nodes "
                f"{self.nodes[idx[bad[0]]].id} and {self.nodes[idx[bad[1]]].id}"
            )
        return out_lat.astype(np.int64), out_loss.astype(np.float32)

    def get_direct_paths(self, used_ids: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Single-edge paths between every used pair; exactly one edge must
        exist per pair (`graph/mod.rs:230-252,258-266`)."""
        idx = self._used_indices(used_ids)
        for a in idx:
            for b in idx:
                if self._edge_count[a, b] != 1:
                    raise GraphError(
                        f"expected exactly one edge between nodes "
                        f"{self.nodes[a].id} and {self.nodes[b].id}, "
                        f"found {self._edge_count[a, b]}"
                    )
        out_lat = self._lat[np.ix_(idx, idx)]
        out_loss = self._loss[np.ix_(idx, idx)]
        return out_lat.astype(np.int64), out_loss.astype(np.float32)

    def _used_indices(self, used_ids: list[int]) -> list[int]:
        try:
            return [self.node_id_to_index[i] for i in used_ids]
        except KeyError as missing:
            raise GraphError(f"graph node {missing} doesn't exist") from None


class IpAssignment:
    """IP ↔ graph-node registry (`graph/mod.rs:352-420`)."""

    def __init__(self):
        self._ip_to_node: dict[str, int] = {}
        self._counter = int(ipaddress.IPv4Address("11.0.0.0"))

    def assign_manual(self, ip: str, node_id: int) -> None:
        ip = str(ipaddress.IPv4Address(ip))
        if ip in self._ip_to_node:
            raise GraphError(f"IP {ip} previously assigned")
        self._ip_to_node[ip] = node_id

    def assign_auto(self, node_id: int) -> str:
        while True:
            self._counter += 1
            ip = ipaddress.IPv4Address(self._counter)
            last = int(ip) & 0xFF
            if last in (0, 255):
                continue  # skip .0 and .255
            s = str(ip)
            if s not in self._ip_to_node:
                self._ip_to_node[s] = node_id
                return s

    def node_for(self, ip: str) -> Optional[int]:
        return self._ip_to_node.get(str(ip))


class RoutingInfo:
    """(src_node, dst_node) → PathProperties as dense arrays, plus packet
    counters (`graph/mod.rs:428-460`). `used_ids` defines the row/col order —
    the same order the TPU plane uses for its HBM latency/loss matrices."""

    def __init__(self, latency_ns: np.ndarray, packet_loss: np.ndarray, used_ids: list[int]):
        self.latency_ns = latency_ns
        self.packet_loss = packet_loss
        self.used_ids = list(used_ids)
        self._pos = {nid: i for i, nid in enumerate(self.used_ids)}
        self.packet_counters = np.zeros_like(latency_ns, dtype=np.int64)

    def path(self, src_node: int, dst_node: int) -> PathProperties:
        i, j = self._pos[src_node], self._pos[dst_node]
        return PathProperties(int(self.latency_ns[i, j]), float(self.packet_loss[i, j]))

    def node_index(self, node_id: int) -> int:
        """Row/col index of a node id in the dense matrices (used_ids
        order) — the same index the TPU plane's host_node map uses."""
        return self._pos[node_id]

    def increment_packet_count(self, src_node: int, dst_node: int, n: int = 1) -> None:
        self.packet_counters[self._pos[src_node], self._pos[dst_node]] += n

    def get_smallest_latency_ns(self) -> int:
        return int(self.latency_ns.min())


def build_routing(
    graph: NetworkGraph, used_ids: list[int], use_shortest_path: bool
) -> RoutingInfo:
    # deterministic, deduplicated node order
    seen: dict[int, None] = {}
    for nid in used_ids:
        seen.setdefault(nid, None)
    ids = list(seen)
    if use_shortest_path:
        lat, loss = graph.compute_shortest_paths(ids)
    else:
        lat, loss = graph.get_direct_paths(ids)
    return RoutingInfo(lat, loss, ids)
