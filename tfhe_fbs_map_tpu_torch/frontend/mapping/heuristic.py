"""Greedy cone-merging heuristic mapping Boolean circuits to FBS programs.

Implements the paper's heuristic (reference ``MapToFBSHeur``,
``fbs_mapper/map_to_fbs.py:54-547``): a single greedy pass over
the source circuit keeping, per wire, a *cone* — the wire expressed as one
lincomb + one pending functional bootstrap over already-materialized nodes.
For each 2-input gate the two input cones are merged into one via a lincomb
``a·x + b·y`` whenever valid coefficients exist; an input cone is bootstrapped
(materialized) only when forced.

Coefficient search flavors (reference ``map_to_fbs.py:336-392``):

* ``naive`` — fixed stacking ``(a, b) = (size(y), 1)``,
* ``search`` — enumerate all (a, b) grouped by resulting FBS size, scan groups
  in increasing output-size order, tie-break by minimal Σmvt².
"""

from __future__ import annotations

import logging

import numpy as np

from ..bit_circuit import BitCircuit, CONST0, CONST1, K_INPUT
from ..lut_program import LutProgram, LutNode
from .cones import (Cone, ConeSpace, dedupe_pair_rows, merge_cones, mvt_span,
                    pair_tables, valid_pairs_mask)

__all__ = ["HeuristicMapper", "MappingError"]


class MappingError(RuntimeError):
    """No valid lincomb coefficients exist even after bootstrapping both
    gate inputs (e.g. the ``naive`` merger at fbs_size 2 on an AND gate —
    matches the reference's terminal assert, ``map_to_fbs.py:545``)."""


def map_best(circuit: BitCircuit, fbs_size: int = 8,
             max_fbs_size: int | None = None,
             max_truth_table_size: int = 16) -> LutProgram:
    """Best-of-both mapping: run the reference-parity "search" merger and
    the trial-repair "search+" variant, keep the cheaper program by
    (nb_bootstrap, norm2_linprod, max_lut_size).  The greedy repairs are
    locally never worse but globally non-monotone (a preserved cone changes
    every later merge), so the robust way to beat the reference heuristic
    is to race both and pick — map time roughly doubles, which is noise
    next to homomorphic execution."""
    best = None
    for merger in ("search", "search+", "search+dc"):
        prog = HeuristicMapper(
            cone_merger=merger, fbs_size=fbs_size, max_fbs_size=max_fbs_size,
            max_truth_table_size=max_truth_table_size).map(circuit)
        prog.remove_dangling_nodes()
        s = prog.stats()
        key = (s["nb_bootstrap"], s["norm2_linprod"], s["max_lut_size"])
        if best is None or key < best[0]:
            best = (key, prog)
    return best[1]


class HeuristicMapper:
    def __init__(self, cone_merger: str = "search", fbs_size: int = 8,
                 max_fbs_size: int | None = None,
                 max_truth_table_size: int = 16):
        """:param cone_merger: "naive", "search", "search+", or
            "search+dc".  "search+" adds trial-based bootstrap choice on
            merge failure; "search+dc" additionally treats sparse-mvt holes
            as per-position don't-cares in the negacyclic overlap check
            (the reference's open TODO, ``map_to_fbs.py:8-11``) — both are
            strict-quality beyond-parity modes; plain "search" stays
            reference-parity
        :param fbs_size: plaintext precision p of one FBS
        :param max_fbs_size: longest acceptable test vector (2p unless strict)
        :param max_truth_table_size: support-size cap (log2 of tt rows) above
            which an input cone is force-bootstrapped
            (reference ``map_to_fbs.py:483-498``)"""
        self.space = ConeSpace(
            fbs_size, 2 * fbs_size if max_fbs_size is None else max_fbs_size,
            dont_care=cone_merger == "search+dc")
        self.max_support = max_truth_table_size
        self.alt_boot = cone_merger in ("search+", "search+dc")
        if cone_merger == "naive":
            self._find_coefs = self._find_coefs_naive
        elif cone_merger in ("search", "search+", "search+dc"):
            self._find_coefs = self._find_coefs_search
        else:
            raise ValueError(f"unknown cone merger {cone_merger!r}")
        self._coef_cache: dict[tuple, tuple | None] = {}
        self._group_cache: dict[tuple, list] = {}
        self.logger = logging.getLogger(f"fbs_mapper.heur_{cone_merger}")

    # -------------------------------------------------------------- cones
    def const_cone(self, bit: int) -> Cone:
        return Cone(self.space, [], [], [bit], [0])

    def unit_cone(self, node: LutNode) -> Cone:
        """Cone of a fresh 0/1-valued program node."""
        return Cone(self.space, [node], [1], [0, 1], [0, 1])

    def materialize(self, prog: LutProgram, cone: Cone) -> Cone:
        """Emit the cone's lincomb + bootstrap into the program; returns the
        fresh unit cone over the bootstrap output
        (reference ``new_bootstrap``, ``map_to_fbs.py:264-284``).
        Constant and single-node cones need no bootstrap."""
        if len(cone.support) <= 1:
            return cone

        shift = -int(cone.mvt.min())
        mvt = cone.mvt + shift
        lin = prog.linear([int(c) for c in cone.coefs], list(cone.support),
                          const_coef=shift)
        table = self.space.fbs_test_vector(cone.tt, mvt)
        return self.unit_cone(prog.bootstrap(lin, table))

    def emit_output(self, prog: LutProgram, cone: Cone) -> LutNode:
        """Program node carrying the cone's value (reference ``new_output``,
        ``map_to_fbs.py:251-262``, with its unreachable-path bug fixed)."""
        if cone.is_const():
            return prog.const(int(cone.tt[0]))
        if len(cone.support) == 1:
            node = cone.support[0]
            if np.array_equal(cone.tt, [1, 0]):
                return prog.linear([-1], [node], const_coef=1)
            return node
        return self.materialize(prog, cone).support[0]

    # ---------------------------------------------------- coefficient search
    # Both searchers run on the deduplicated (x, y, tt, count) rows from
    # ``dedupe_pair_rows`` — validity and the Σmvt² tie-break (with counts as
    # multiplicities) are exactly those of the full 2^|support| row tables,
    # at a fraction of the size.

    def _find_coefs_naive(self, xu, yu, tt_u, counts):
        a, b = mvt_span(yu), 1
        if self.space.lut_ok(tt_u, a * xu + b * yu):
            return (a, b)
        return None

    def _coefs_by_fbs_size(self, size1: int, size2: int) -> list:
        """All (a, b) candidates grouped by the merged FBS size
        |a|(size1-1) + |b|(size2-1), groups in increasing size order, pairs
        within a group in descending (a, b) order; the smaller cone gets the
        signed range (reference ``map_to_fbs.py:344-361``)."""
        memo_key = (size1, size2)
        hit = self._group_cache.get(memo_key)
        if hit is not None:
            return hit
        if size1 < size2:
            cand = [(a, b) for a in range(size2 + 1)
                    for b in range(-size1, size1 + 1)]
        else:
            cand = [(a, b) for a in range(-size2, size2 + 1)
                    for b in range(size1 + 1)]
        cand = np.array(cand, dtype=np.int64)
        out_size = (np.abs(cand[:, 0]) * (size1 - 1)
                    + np.abs(cand[:, 1]) * (size2 - 1))
        groups = []
        for size in np.unique(out_size):
            pairs = sorted((tuple(map(int, ab))
                            for ab in cand[out_size == size]), reverse=True)
            groups.append((int(size), np.array(pairs, dtype=np.int64)))
        self._group_cache[memo_key] = groups
        return groups

    def _find_coefs_search(self, xu, yu, tt_u, counts):
        """First group (in increasing merged-size order) containing a valid
        pair; within it the minimal count-weighted Σmvt², ties resolved by
        pair order — semantics of the reference scan
        (``map_to_fbs.py:363-392``), vectorized group by group."""
        for _, pairs in self._coefs_by_fbs_size(mvt_span(xu), mvt_span(yu)):
            valid, mvts = valid_pairs_mask(self.space, pairs, xu, yu, tt_u)
            if not valid.any():
                continue
            norm2 = (counts[None, :] * mvts * mvts).sum(axis=1)
            norm2[~valid] = np.iinfo(np.int64).max
            j = int(np.argmin(norm2))
            return (int(pairs[j, 0]), int(pairs[j, 1]))
        return None

    def _find_coefs_cached(self, xy_mvt: np.ndarray, r_tt: np.ndarray):
        dedup = dedupe_pair_rows(xy_mvt, r_tt)
        if dedup is None:
            return None, None
        xu, yu, tt_u, counts = dedup
        key = (xu.tobytes(), yu.tobytes(), tt_u.tobytes(), counts.tobytes())
        if key not in self._coef_cache:
            self._coef_cache[key] = self._find_coefs(xu, yu, tt_u, counts)
        ab = self._coef_cache[key]
        if ab is None:
            return None, None
        return ab, ab[0] * xy_mvt[:, 0] + ab[1] * xy_mvt[:, 1]

    # ------------------------------------------------------------- gate step
    @staticmethod
    def _swap_cones(cone1, cone2, idx1, idx2, gate_tt):
        gate_tt = list(gate_tt)
        gate_tt[1], gate_tt[2] = gate_tt[2], gate_tt[1]
        return cone2, cone1, idx2, idx1, gate_tt

    def map_gate(self, prog: LutProgram, input_cones: list[Cone],
                 gate_tt) -> tuple[Cone, dict[int, Cone]]:
        """Map one source gate; returns the output cone plus any input cones
        that had to be bootstrapped along the way, keyed by input position
        (reference ``treat_bit_exec_lut_gate``, ``map_to_fbs.py:442-547``)."""
        log = self.logger

        if len(input_cones) == 1:
            cone, = input_cones
            assert len(gate_tt) == 2
            return cone.with_tt(np.asarray(gate_tt)[cone.tt]), {}

        assert len(input_cones) == 2 and len(gate_tt) == 4
        cone1, cone2 = input_cones
        gate_tt = list(gate_tt)
        idx1, idx2 = 0, 1

        # Keep the larger (or equal-size, higher-norm) cone as cone1 so it is
        # the one preserved intact (reference ``map_to_fbs.py:474-477``).
        if (cone1.size() < cone2.size()
                or (cone1.size() == cone2.size()
                    and cone1.norm2_squared() < cone2.norm2_squared())):
            cone1, cone2, idx1, idx2, gate_tt = self._swap_cones(
                cone1, cone2, idx1, idx2, gate_tt)

        forced: dict[int, Cone] = {}

        # Force a bootstrap when the united support would exceed the tt cap.
        union = set(cone1.support_names()).union(cone2.support_names())
        if len(union) > self.max_support:
            log.debug("force bootstrap of cone %d (support cap)", idx1)
            forced[idx1] = cone1 = self.materialize(prog, cone1)
            cone1, cone2, idx1, idx2, gate_tt = self._swap_cones(
                cone1, cone2, idx1, idx2, gate_tt)
            union = set(cone1.support_names()).union(cone2.support_names())
            if len(union) > self.max_support:
                log.debug("force bootstrap of cone %d (support cap)", idx1)
                forced[idx1] = cone1 = self.materialize(prog, cone1)

        # Up to three merge attempts, bootstrapping cone1 then cone2 between
        # failures; the third attempt cannot fail (both cones are then unit).
        # In "search+" mode the first failure instead TRIALS both
        # single-bootstrap repairs (shape-only, no program emission) and
        # picks the cheaper winner — never worse than the fixed ladder,
        # which can spend TWO bootstraps where bootstrapping the other
        # input would have spent one.
        for attempt in range(3):
            xy_mvt, r_tt = pair_tables(cone1, cone2, gate_tt)
            if len(np.unique(r_tt)) == 1:
                return self.const_cone(int(r_tt[0])), forced
            ab, r_mvt = self._find_coefs_cached(xy_mvt, r_tt)
            if ab is not None:
                return (merge_cones(self.space, cone1, cone2, ab, r_tt, r_mvt),
                        forced)
            if attempt == 2:
                raise MappingError(
                    f"no valid lincomb for gate tt {gate_tt} at fbs_size "
                    f"{self.space.fbs_size}/{self.space.max_fbs_size}")
            if attempt == 0 and self.alt_boot:
                pick = self._pick_bootstrap(cone1, cone2, gate_tt)
                if pick == 1:
                    log.debug("bootstrap cone %d (trial pick)", idx2)
                    forced[idx2] = cone2 = self.materialize(prog, cone2)
                    continue
            if attempt == 0:
                log.debug("bootstrap cone %d", idx1)
                forced[idx1] = cone1 = self.materialize(prog, cone1)
            elif len(cone2.support) > 1:
                log.debug("bootstrap cone %d", idx2)
                forced[idx2] = cone2 = self.materialize(prog, cone2)
            else:  # cone2 already unit (search+ trial path): repair cone1
                log.debug("bootstrap cone %d", idx1)
                forced[idx1] = cone1 = self.materialize(prog, cone1)

        raise AssertionError("unreachable")

    # ------------------------------------------------ search+ trial repair
    class _TrialNode:
        """Stand-in for a not-yet-emitted bootstrap output; only its unique
        name participates in the support index algebra."""
        __slots__ = ("name",)
        _n = 0

        def __init__(self):
            HeuristicMapper._TrialNode._n += 1
            self.name = f"__trial{HeuristicMapper._TrialNode._n}__"

    def _trial_unit(self) -> Cone:
        return Cone(self.space, [self._TrialNode()], [1], [0, 1], [0, 1])

    def _pick_bootstrap(self, cone1: Cone, cone2: Cone, gate_tt) -> int:
        """Which input to bootstrap after a failed merge: 0 (= cone1, the
        reference ladder's choice) or 1.  Trials both repairs without
        emitting anything (a materialized cone is a fresh unit cone, so
        merge feasibility depends only on shapes; the coefficient cache key
        is shape-based and is reused by the real merge that follows).
        Prefers the repair that merges at all; between two feasible repairs,
        the one whose merged cone is smaller (size, then norm²)."""
        results = []
        for boot_pos, (t1, t2) in enumerate(
                ((self._trial_unit(), cone2), (cone1, self._trial_unit()))):
            xy_mvt, r_tt = pair_tables(t1, t2, gate_tt)
            if len(np.unique(r_tt)) == 1:
                return boot_pos  # collapses to a constant — free
            ab, r_mvt = self._find_coefs_cached(xy_mvt, r_tt)
            if ab is None:
                continue
            merged = merge_cones(self.space, t1, t2, ab, r_tt, r_mvt)
            results.append((merged.size(), merged.norm2_squared(), boot_pos))
        if not results:
            return 0  # neither single repair works: keep the ladder order
        return min(results)[2]

    # ------------------------------------------------------------------ map
    def map(self, circuit: BitCircuit) -> LutProgram:
        to_bootstrap = {out.nid for out in circuit.outputs.values()}
        return self.map_internal(circuit, to_bootstrap)

    def map_internal(self, circuit: BitCircuit,
                     nodes_to_bootstrap: set[int]) -> LutProgram:
        """``nodes_to_bootstrap``: node ids (``nid``) forced to materialize.

        Cones are keyed by node identity, not name — .bench netlists name
        wires "0"/"1", which must not collide with the const singletons."""
        prog = LutProgram(fbs_size=self.space.fbs_size)
        cones: dict[int, Cone] = {CONST0.nid: self.const_cone(0),
                                  CONST1.nid: self.const_cone(1)}

        for node in circuit.nodes:
            if node.kind == K_INPUT:
                cone = self.unit_cone(prog.input(node.name))
            else:
                input_cones = [cones[f.nid] for f in node.fanins]
                assert len(input_cones) <= 2, \
                    "only 1- and 2-input gates are supported"
                cone, forced = self.map_gate(prog, input_cones, node.table)
                for pos, new_cone in forced.items():
                    cones[node.fanins[pos].nid] = new_cone

            if node.nid in nodes_to_bootstrap:
                cone = self.materialize(prog, cone)
            cones[node.nid] = cone

        for name, out in circuit.outputs.items():
            prog.output(name, self.emit_output(prog, cones[out.nid]))
        return prog
