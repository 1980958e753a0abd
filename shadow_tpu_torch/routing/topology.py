"""Network topology: GML graph → device latency/reliability arrays.

The reference loads an igraph GML graph, attaches each host to a vertex
(honoring ip/city/country hints), and lazily runs Dijkstra (edge weight =
latency) per (src, dst) vertex pair, caching results
(src/main/routing/topology.c:1682-1723, 1144-1259, 2218). The minimum path
latency feeds the scheduler's conservative runahead window
(src/main/core/worker.c:624-626 → controller.c:141-153).

TPU-first inversion: instead of a lazily-filled locked hashtable, we bake the
path model into dense device arrays *over the used vertices only* (vertices
with attached hosts) before the simulation starts:

    latency_vv[U, U]     int64 ns       path latency
    reliability_vv[U, U] float32        ∏(1 - packet_loss) along path
    host_vertex[H]       int32          host → used-vertex index

Per-packet lookups on device are then two gathers — no locks, no cache, and
the arrays shard cleanly over a mesh. U is the used-vertex count (≤ hosts),
so a 100k-host simulation over a few thousand-vertex graph stays small.
"""

from __future__ import annotations

import dataclasses
import ipaddress

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from shadow_tpu_torch.core import units
from shadow_tpu_torch.routing.gml import GmlGraph, parse_gml


class TopologyError(ValueError):
    pass


@dataclasses.dataclass
class Vertex:
    id: int
    index: int  # dense index in the parsed graph
    ip_address: str | None
    city_code: str | None
    country_code: str | None
    bandwidth_down: int | None  # bits/sec
    bandwidth_up: int | None


@dataclasses.dataclass
class Edge:
    source: int  # dense vertex index
    target: int
    latency_ns: int
    jitter_ns: int
    packet_loss: float


class Topology:
    """Parsed graph + host attachment + baked path arrays."""

    def __init__(self, graph: GmlGraph, use_shortest_path: bool = True):
        self.directed = graph.directed
        self.use_shortest_path = use_shortest_path
        self.vertices: list[Vertex] = []
        self._id_to_index: dict[int, int] = {}
        for idx, n in enumerate(graph.nodes):
            v = Vertex(
                id=int(n["id"]),
                index=idx,
                ip_address=n.get("ip_address"),
                city_code=str(n["city_code"]) if "city_code" in n else None,
                country_code=str(n["country_code"]) if "country_code" in n else None,
                bandwidth_down=(
                    units.parse_bits(n["bandwidth_down"])
                    if "bandwidth_down" in n
                    else None
                ),
                bandwidth_up=(
                    units.parse_bits(n["bandwidth_up"]) if "bandwidth_up" in n else None
                ),
            )
            if v.id in self._id_to_index:
                raise TopologyError(f"duplicate vertex id {v.id}")
            self._id_to_index[v.id] = idx
            self.vertices.append(v)
        self.edges: list[Edge] = []
        for e in graph.edges:
            if "latency" not in e:
                raise TopologyError("edge missing required latency attribute")
            # Bare numeric latency/jitter are seconds per the graph spec
            # (docs/network_graph_spec.md: base unit of "seconds").
            lat = units.parse_time_ns(e["latency"])
            if lat <= 0:
                raise TopologyError("edge latency must be > 0 (runahead requires it)")
            src_id, dst_id = int(e["source"]), int(e["target"])
            for vid in (src_id, dst_id):
                if vid not in self._id_to_index:
                    raise TopologyError(f"edge references unknown node id {vid}")
            self.edges.append(
                Edge(
                    source=self._id_to_index[src_id],
                    target=self._id_to_index[dst_id],
                    latency_ns=lat,
                    jitter_ns=units.parse_time_ns(e.get("jitter", 0)),
                    packet_loss=float(e.get("packet_loss", 0.0)),
                )
            )
        # host attachments
        self._attached_vertex: list[int] = []  # per host, dense vertex index

    @classmethod
    def from_gml(cls, text: str, use_shortest_path: bool = True) -> "Topology":
        return cls(parse_gml(text), use_shortest_path)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    # ---- attachment (reference topology.c:2132-2216 candidate filtering) ----

    def attach_host(
        self,
        host_index: int,
        ip_address_hint: str | None = None,
        city_code_hint: str | None = None,
        country_code_hint: str | None = None,
        network_node_id: int | None = None,
    ) -> Vertex:
        """Pick the attachment vertex for a host, most-specific hint first:
        city candidates, else country candidates, else all; exact/longest-
        prefix IP match within candidates; else deterministic round-robin by
        host index (the reference draws from its seeded RNG here — ours is
        deterministic in host order, which the determinism tests pin).
        An explicit network_node_id (graph vertex id) bypasses hint search."""
        if network_node_id is not None:
            if network_node_id not in self._id_to_index:
                raise TopologyError(f"no graph vertex with id {network_node_id}")
            chosen = self.vertices[self._id_to_index[network_node_id]]
            if host_index != len(self._attached_vertex):
                raise TopologyError("hosts must attach in index order")
            self._attached_vertex.append(chosen.index)
            return chosen
        cands = [v for v in self.vertices if city_code_hint and v.city_code == city_code_hint]
        if not cands:
            cands = [
                v
                for v in self.vertices
                if country_code_hint and v.country_code == country_code_hint
            ]
        if not cands:
            cands = list(self.vertices)
        if ip_address_hint is not None:
            want = int(ipaddress.ip_address(ip_address_hint))
            best, best_len = None, -1
            for v in cands:
                if v.ip_address is None:
                    continue
                have = int(ipaddress.ip_address(v.ip_address))
                if have == want:
                    best, best_len = v, 33
                    break
                # longest common prefix length
                x = have ^ want
                plen = 32 - x.bit_length()
                if plen > best_len:
                    best, best_len = v, plen
            if best is not None:
                chosen = best
            else:
                chosen = cands[host_index % len(cands)]
        else:
            chosen = cands[host_index % len(cands)]
        if host_index != len(self._attached_vertex):
            raise TopologyError("hosts must attach in index order")
        self._attached_vertex.append(chosen.index)
        return chosen

    # ---- path baking ----

    def _arcs(self):
        """Min-latency arc set: (csr latency graph, per-arc attr csr pair).
        For undirected graphs both directions are added; parallel edges
        keep the minimum-latency arc (the one Dijkstra would use)."""
        V = self.num_vertices
        arc_attr: dict[tuple[int, int], tuple[int, float, int]] = {}

        def add_arc(s, t, e: Edge):
            key = (s, t)
            prev = arc_attr.get(key)
            if prev is None or e.latency_ns < prev[0]:
                arc_attr[key] = (e.latency_ns, e.packet_loss, e.jitter_ns)

        for e in self.edges:
            add_arc(e.source, e.target, e)
            if not self.directed:
                add_arc(e.target, e.source, e)
        rows = np.fromiter((k[0] for k in arc_attr), dtype=np.int64,
                           count=len(arc_attr))
        cols = np.fromiter((k[1] for k in arc_attr), dtype=np.int64,
                           count=len(arc_attr))
        lats = np.fromiter((v[0] for v in arc_attr.values()), dtype=np.float64,
                           count=len(arc_attr))
        loss = np.fromiter((v[1] for v in arc_attr.values()), dtype=np.float64,
                           count=len(arc_attr))
        jit = np.fromiter((v[2] for v in arc_attr.values()), dtype=np.int64,
                          count=len(arc_attr))
        graph = csr_matrix((lats, (rows, cols)), shape=(V, V))
        loss_m = csr_matrix((loss, (rows, cols)), shape=(V, V))
        jit_m = csr_matrix((jit.astype(np.float64), (rows, cols)),
                           shape=(V, V))
        return graph, loss_m, jit_m, arc_attr

    @staticmethod
    def _tree_accumulate(pred_rows: np.ndarray, srcs: np.ndarray,
                         loss_m, jit_m):
        """Accumulate reliability (∏(1-loss)) and jitter (Σ) along the
        shortest-path trees, vectorized with pointer doubling — the
        predecessor-walk loop the scalar form needs is O(U·V·depth) Python
        at 10k vertices (hours); this is O(U·V·log V) numpy (seconds).
        pred_rows: [N, V] predecessor matrix (scipy convention, -9999 for
        none); srcs: [N] source vertex per row."""
        N, V = pred_rows.shape
        cols = np.arange(V, dtype=np.int64)
        valid = pred_rows >= 0
        prows = np.where(valid, pred_rows, 0).astype(np.int64)
        rel = np.ones((N, V), dtype=np.float64)
        jit = np.zeros((N, V), dtype=np.int64)
        for i in range(N):
            rel[i] = np.where(
                valid[i],
                1.0 - np.asarray(loss_m[prows[i], cols]).ravel(), 1.0
            )
            jit[i] = np.where(
                valid[i],
                np.asarray(jit_m[prows[i], cols]).ravel().astype(np.int64), 0
            )
        # each hop: fold in the parent's accumulated value, then jump the
        # pointer twice as far; log2(V)+1 rounds cover any path length
        ptr = np.where(valid, prows, srcs[:, None]).astype(np.int64)
        rows_idx = np.arange(N)[:, None]
        for _ in range(max(1, int(np.ceil(np.log2(max(V, 2)))) + 1)):
            rel = rel * rel[rows_idx, ptr]
            jit = jit + jit[rows_idx, ptr]
            ptr = ptr[rows_idx, ptr]
        return rel, jit

    def bake_lazy(self) -> "LazyPaths":
        """On-demand path model (no dense [U, U] allocation) for the
        managed-process plane on big graphs. Call after all attaches."""
        return LazyPaths(self)

    def bake(self) -> "BakedPaths":
        """Compute path arrays over used vertices. Call after all attaches."""
        used = sorted(set(self._attached_vertex))
        if not used:
            raise TopologyError("no hosts attached")
        uidx = {v: i for i, v in enumerate(used)}
        U = len(used)

        graph, loss_m, jit_m, arc_attr = self._arcs()
        used_a = np.asarray(used, dtype=np.int64)

        lat_vv = np.full((U, U), np.iinfo(np.int64).max, dtype=np.int64)
        rel_vv = np.zeros((U, U), dtype=np.float32)
        jit_vv = np.zeros((U, U), dtype=np.int64)

        if self.use_shortest_path:
            dist, predecessors = dijkstra(
                graph, directed=True, indices=used, return_predecessors=True
            )
            rel_all, jit_all = self._tree_accumulate(
                predecessors, used_a, loss_m, jit_m
            )
            reach = np.isfinite(dist[:, used_a])  # [U, U]
            lat_vv = np.where(
                reach,
                np.where(reach, dist[:, used_a], 0.0).astype(np.int64),
                lat_vv,
            )
            rel_vv = np.where(
                reach, rel_all[:, used_a].astype(np.float32), rel_vv
            )
            jit_vv = np.where(reach, jit_all[:, used_a], jit_vv)
            # Dijkstra reports a 0-cost self path, but the reference
            # requires an explicit self-loop edge for co-located hosts to
            # communicate — overwrite the diagonal with its attributes.
            for i, src in enumerate(used):
                a = arc_attr.get((src, src))
                if a is None:
                    lat_vv[i, i] = np.iinfo(np.int64).max
                    rel_vv[i, i] = 0.0
                    jit_vv[i, i] = 0
                else:
                    lat_vv[i, i] = a[0]
                    rel_vv[i, i] = np.float32(1.0 - a[1])
                    jit_vv[i, i] = a[2]
        else:
            # Complete-graph direct-edge mode (configuration.rs:203-208):
            # only direct edges route; pairs without one stay unreachable
            # (the reference errors at lookup time — we drop at send time
            # and count it, since unreachable pairs may never be used).
            for (s, t), a in arc_attr.items():
                i, j = uidx.get(s), uidx.get(t)
                if i is None or j is None:
                    continue
                lat_vv[i, j] = a[0]
                rel_vv[i, j] = np.float32(1.0 - a[1])
                jit_vv[i, j] = a[2]

        host_vertex = np.array([uidx[v] for v in self._attached_vertex], dtype=np.int32)
        reachable = lat_vv != np.iinfo(np.int64).max
        if not reachable.any():
            raise TopologyError("no reachable paths between attached hosts")
        min_latency = int(lat_vv[reachable].min())
        vert_bw_down = np.array(
            [
                self.vertices[v].bandwidth_down or 0
                for v in used
            ],
            dtype=np.int64,
        )
        vert_bw_up = np.array(
            [self.vertices[v].bandwidth_up or 0 for v in used], dtype=np.int64
        )
        return BakedPaths(
            latency_vv=lat_vv,
            reliability_vv=rel_vv,
            jitter_vv=jit_vv,
            host_vertex=host_vertex,
            min_latency_ns=min_latency,
            used_vertices=np.array(used, dtype=np.int32),
            vertex_bw_down_bits=vert_bw_down,
            vertex_bw_up_bits=vert_bw_up,
        )


class LazyPaths:
    """On-demand per-source shortest paths with a row cache — the
    reference's strategy at Tor scale (topology.c:1144-1259 lazily fills a
    locked 2-level hashtable per (src, dst) pair; we cache whole source
    ROWS, which one Dijkstra run yields anyway). NO dense [U, U] is ever
    allocated: memory is O(cached sources × V). Used by the managed-process
    plane's latency_fn/reliability_fn on big graphs; the device plane keeps
    dense baked arrays (per-packet lookups on device can't fault rows in).

    ``min_latency_ns`` is the minimum EDGE latency — a lower bound on every
    path latency, hence a sound (conservative) runahead window
    (controller.c:125-139 seeds its min-time-jump the same way before any
    path is computed).
    """

    def __init__(self, topo: "Topology"):
        used = sorted(set(topo._attached_vertex))
        if not used:
            raise TopologyError("no hosts attached")
        self._graph, self._loss_m, self._jit_m, self._arc_attr = topo._arcs()
        self.use_shortest_path = topo.use_shortest_path
        uidx = {v: i for i, v in enumerate(used)}
        self.host_vertex = np.array(
            [uidx[v] for v in topo._attached_vertex], dtype=np.int32
        )
        self.used_vertices = np.array(used, dtype=np.int32)
        self.vertex_bw_down_bits = np.array(
            [topo.vertices[v].bandwidth_down or 0 for v in used],
            dtype=np.int64,
        )
        self.vertex_bw_up_bits = np.array(
            [topo.vertices[v].bandwidth_up or 0 for v in used],
            dtype=np.int64,
        )
        if self._graph.nnz == 0:
            raise TopologyError("no edges between attached hosts")
        self.min_latency_ns = int(self._graph.data.min())
        # src used-index -> (lat_row [V] i64 | NEVER, rel_row [V] f32)
        self._rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _row(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        got = self._rows.get(u)
        if got is not None:
            return got
        src = int(self.used_vertices[u])
        V = self._graph.shape[0]
        never = np.iinfo(np.int64).max
        if self.use_shortest_path:
            dist, pred = dijkstra(
                self._graph, directed=True, indices=[src],
                return_predecessors=True,
            )
            rel_a, _ = Topology._tree_accumulate(
                pred, np.array([src], dtype=np.int64),
                self._loss_m, self._jit_m,
            )
            reach = np.isfinite(dist[0])
            lat_row = np.where(
                reach, np.where(reach, dist[0], 0.0).astype(np.int64), never
            )
            rel_row = np.where(reach, rel_a[0].astype(np.float32), 0.0)
        else:
            lat_row = np.full((V,), never, dtype=np.int64)
            rel_row = np.zeros((V,), dtype=np.float32)
            for (s, t), a in self._arc_attr.items():
                if s == src:
                    lat_row[t] = a[0]
                    rel_row[t] = np.float32(1.0 - a[1])
        # diagonal: explicit self-loop edge required (reference semantics)
        a = self._arc_attr.get((src, src))
        if a is None:
            lat_row[src] = never
            rel_row[src] = 0.0
        else:
            lat_row[src] = a[0]
            rel_row[src] = np.float32(1.0 - a[1])
        self._rows[u] = (lat_row, rel_row)
        return self._rows[u]

    def latency_ns(self, src_u: int, dst_u: int) -> int:
        """Path latency between used-vertex indices (NEVER if unreachable)."""
        lat_row, _ = self._row(int(src_u))
        return int(lat_row[int(self.used_vertices[int(dst_u)])])

    def reliability(self, src_u: int, dst_u: int) -> float:
        _, rel_row = self._row(int(src_u))
        return float(rel_row[int(self.used_vertices[int(dst_u)])])


@dataclasses.dataclass
class BakedPaths:
    latency_vv: np.ndarray  # [U, U] int64 ns (NEVER = unreachable)
    reliability_vv: np.ndarray  # [U, U] float32 in [0,1]
    jitter_vv: np.ndarray  # [U, U] int64 ns (stored; not applied by default,
    # matching the reference which logs but does not sample jitter in 2.0)
    host_vertex: np.ndarray  # [H] int32 → used-vertex index
    min_latency_ns: int  # conservative runahead bound (controller.c:125-139)
    used_vertices: np.ndarray  # [U] int32 dense vertex indices
    vertex_bw_down_bits: np.ndarray  # [U] int64 bits/sec (0 = unspecified)
    vertex_bw_up_bits: np.ndarray  # [U] int64
