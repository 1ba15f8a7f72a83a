"""Hypergraph container (Sec. 3.1 terminology).

Vertices carry vector weights (w_comp, w_mem); nets carry costs.  Pins are
stored CSR-by-net; the transposed vertex->net CSR is built lazily.  All arrays
are numpy; partitioning and cost evaluation operate on these directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class Hypergraph:
    n_vertices: int
    net_ptr: np.ndarray  # (n_nets + 1,) int64
    net_pins: np.ndarray  # (n_pins,) int64 vertex ids, per net
    w_comp: np.ndarray  # (n_vertices,) int64
    w_mem: np.ndarray  # (n_vertices,) int64
    net_cost: np.ndarray  # (n_nets,) int64
    # optional metadata for interpreting vertices/nets (builders fill these)
    vertex_kind: np.ndarray | None = None  # int8: 0=mult, 1=A, 2=B, 3=C
    net_kind: np.ndarray | None = None  # int8: 1=A, 2=B, 3=C
    name: str = ""

    _vtx_ptr: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _vtx_nets: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _pin_nets: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _inc: "sp.csr_matrix | None" = dataclasses.field(default=None, repr=False)

    # -- properties --------------------------------------------------------
    @property
    def n_nets(self) -> int:
        return len(self.net_ptr) - 1

    @property
    def n_pins(self) -> int:
        return len(self.net_pins)

    def net_sizes(self) -> np.ndarray:
        return np.diff(self.net_ptr)

    def pins_of(self, net: int) -> np.ndarray:
        return self.net_pins[self.net_ptr[net] : self.net_ptr[net + 1]]

    # -- derived structures --------------------------------------------------
    def incidence(self) -> sp.csr_matrix:
        """(n_nets x n_vertices) 0/1 incidence matrix (Fig. 4); cached."""
        if self._inc is None:
            indptr = self.net_ptr.astype(np.int64)
            data = np.ones(self.n_pins, dtype=np.int8)
            self._inc = sp.csr_matrix(
                (data, self.net_pins, indptr), shape=(self.n_nets, self.n_vertices)
            )
        return self._inc

    def pin_nets(self) -> np.ndarray:
        """(n_pins,) net id of each pin entry — the expansion
        ``repeat(arange(n_nets), net_sizes())``, cached because every
        vectorized sweep over the pin list starts from it."""
        if self._pin_nets is None:
            self._pin_nets = np.repeat(
                np.arange(self.n_nets, dtype=np.int64), self.net_sizes()
            )
        return self._pin_nets

    def vertex_to_nets(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR of nets incident to each vertex (built lazily, cached).
        Pure index arithmetic: one stable argsort of the pin list by vertex
        plus a bincount — no scipy transpose."""
        if self._vtx_ptr is None:
            order = np.argsort(self.net_pins, kind="stable")
            self._vtx_nets = self.pin_nets()[order]
            counts = np.bincount(self.net_pins, minlength=self.n_vertices)
            self._vtx_ptr = np.concatenate(
                [[0], np.cumsum(counts)]
            ).astype(np.int64)
        return self._vtx_ptr, self._vtx_nets

    def nets_of(self, vertex: int) -> np.ndarray:
        ptr, nets = self.vertex_to_nets()
        return nets[ptr[vertex] : ptr[vertex + 1]]

    # -- sanity -------------------------------------------------------------
    def validate(self) -> None:
        assert self.net_ptr[0] == 0 and self.net_ptr[-1] == self.n_pins
        assert (np.diff(self.net_ptr) >= 0).all()
        if self.n_pins:
            assert self.net_pins.min() >= 0
            assert self.net_pins.max() < self.n_vertices
        assert len(self.w_comp) == len(self.w_mem) == self.n_vertices
        assert len(self.net_cost) == self.n_nets

    def total_comp(self) -> int:
        return int(self.w_comp.sum())

    def total_mem(self) -> int:
        return int(self.w_mem.sum())

    def __repr__(self) -> str:  # compact, used in benchmark CSV "derived"
        return (
            f"Hypergraph({self.name!r}, V={self.n_vertices}, N={self.n_nets}, "
            f"pins={self.n_pins}, comp={self.total_comp()})"
        )


def build_hypergraph_flat(
    net_ids: np.ndarray,
    pin_vertices: np.ndarray,
    n_nets: int,
    n_vertices: int,
    w_comp: np.ndarray,
    w_mem: np.ndarray,
    net_cost: np.ndarray,
    **meta,
) -> Hypergraph:
    """Assemble from flat (net_id, vertex) pin pairs — vectorized path used
    by the SpGEMM model builders."""
    net_ids = np.asarray(net_ids, dtype=np.int64)
    pin_vertices = np.asarray(pin_vertices, dtype=np.int64)
    order = np.argsort(net_ids, kind="stable")
    net_ids = net_ids[order]
    pins = pin_vertices[order]
    counts = np.bincount(net_ids, minlength=n_nets)
    net_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    hg = Hypergraph(
        n_vertices=n_vertices,
        net_ptr=net_ptr,
        net_pins=pins,
        w_comp=np.asarray(w_comp, dtype=np.int64),
        w_mem=np.asarray(w_mem, dtype=np.int64),
        net_cost=np.asarray(net_cost, dtype=np.int64),
        **meta,
    )
    hg.validate()
    return hg
