"""Graph data: synthetic power-law graphs, CSR storage, and a real
layer-wise neighbor sampler (fanout sampling, GraphSAGE-style) — required
for the ``minibatch_lg`` cell.

All host-side numpy (a copy of ``repro.data.graphs`` whose draws match it
call for call); batches are padded to static shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 16
    seed: int = 5


class CsrGraph:
    """Undirected-ish random power-law graph in CSR form."""

    def __init__(self, spec: GraphSpec):
        self.spec = spec
        rs = np.random.RandomState(spec.seed)
        n, e = spec.n_nodes, spec.n_edges
        # power-law destination preference (preferential-attachment-ish)
        w = (rs.pareto(1.5, n) + 1.0)
        w /= w.sum()
        src = rs.randint(0, n, e).astype(np.int64)
        dst = rs.choice(n, size=e, p=w).astype(np.int64)
        order = np.argsort(dst, kind="stable")
        self.src = src[order].astype(np.int32)
        self.dst = dst[order].astype(np.int32)
        counts = np.bincount(self.dst, minlength=n)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]
                                     ).astype(np.int64)
        # features: community structure so classification is learnable
        comm = rs.randint(0, spec.n_classes, n)
        centers = rs.randn(spec.n_classes, spec.d_feat).astype(np.float32)
        self.features = (centers[comm]
                         + 0.5 * rs.randn(n, spec.d_feat)).astype(np.float32)
        self.labels = comm.astype(np.int32)

    def full_batch(self) -> dict:
        """Whole graph as one padded batch (full-graph training cells)."""
        edges = np.stack([self.src, self.dst], axis=-1)
        return {"nodes": self.features[None],
                "edges": edges[None].astype(np.int32),
                "labels": self.labels[None]}

    def in_neighbors(self, node: int) -> np.ndarray:
        lo, hi = self.indptr[node], self.indptr[node + 1]
        return self.src[lo:hi]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    batch_nodes: int
    fanouts: Tuple[int, ...]       # e.g. (15, 10)
    seed: int = 7


class NeighborSampler:
    """Layer-wise fanout sampling producing padded static-shape subgraphs.

    Hop k samples ≤ fanouts[k] in-neighbors of the current frontier.  The
    returned subgraph re-indexes nodes locally: seeds first, then each hop's
    sampled nodes.  Edges point sampled-neighbor → frontier-node (message
    direction).  Static padded sizes so the train step compiles once.
    """

    def __init__(self, graph: CsrGraph, cfg: SamplerConfig):
        self.g = graph
        self.cfg = cfg
        n_nodes, n_edges = cfg.batch_nodes, 0
        frontier = cfg.batch_nodes
        for f in cfg.fanouts:
            n_edges += frontier * f
            frontier = frontier * f
            n_nodes += frontier
        self.max_nodes = n_nodes
        self.max_edges = n_edges

    def sample(self, step: int) -> dict:
        cfg, g = self.cfg, self.g
        rs = np.random.RandomState((cfg.seed * 40_009 + step) % 2 ** 31)
        n_total = g.spec.n_nodes
        seeds = rs.randint(0, n_total, cfg.batch_nodes).astype(np.int32)

        local_of: dict = {}
        nodes: List[int] = []

        def local_id(global_id: int) -> int:
            if global_id not in local_of:
                local_of[global_id] = len(nodes)
                nodes.append(global_id)
            return local_of[global_id]

        for s in seeds:
            local_id(int(s))
        edges_src: List[int] = []
        edges_dst: List[int] = []
        frontier = [int(s) for s in seeds]
        for fanout in cfg.fanouts:
            nxt: List[int] = []
            for u in frontier:
                nbrs = g.in_neighbors(u)
                if len(nbrs) == 0:
                    continue
                take = nbrs if len(nbrs) <= fanout else \
                    nbrs[rs.randint(0, len(nbrs), fanout)]
                du = local_of[u]
                for v in take:
                    lv = local_id(int(v))
                    edges_src.append(lv)
                    edges_dst.append(du)
                    nxt.append(int(v))
            frontier = nxt

        n_loc = len(nodes)
        nodes_arr = np.asarray(nodes, np.int64)
        feat = np.zeros((self.max_nodes, g.spec.d_feat), np.float32)
        feat[:n_loc] = g.features[nodes_arr]
        labels = np.zeros((self.max_nodes,), np.int32)
        labels[:n_loc] = g.labels[nodes_arr]
        e = len(edges_src)
        edges = -np.ones((self.max_edges, 2), np.int32)
        edges[:e, 0] = edges_src
        edges[:e, 1] = edges_dst
        label_mask = np.zeros((self.max_nodes,), np.int32)
        label_mask[:cfg.batch_nodes] = 1            # loss on seeds only
        return {"nodes": feat[None], "edges": edges[None],
                "labels": labels[None], "label_mask": label_mask[None]}


def molecule_batch(batch: int, n_nodes: int, n_edges: int,
                   atom_vocab: int = 119, n_classes: int = 2,
                   seed: int = 0, step: int = 0) -> dict:
    """Batched small molecule-like graphs with categorical atom types."""
    rs = np.random.RandomState((seed * 131 + step) % 2 ** 31)
    atoms = rs.randint(0, atom_vocab, (batch, n_nodes)).astype(np.int32)
    edges = rs.randint(0, n_nodes, (batch, n_edges, 2)).astype(np.int32)
    # label correlated with atom composition (learnable)
    y = (atoms.mean(axis=1) > atom_vocab / 2).astype(np.int32)
    return {"nodes": np.zeros((batch, n_nodes, 1), np.float32),
            "atom_types": atoms, "edges": edges, "labels": y,
            "node_mask": np.ones((batch, n_nodes), np.int32)}
