"""Cone algebra for the FBS mapping heuristic.

A *cone* represents a Boolean wire as a function of already-materialized
``LutProgram`` nodes: a support list, integer lincomb coefficients over that
support, a Boolean truth table ``tt`` over all support assignments, and the
multi-value table ``mvt`` giving the integer the lincomb takes per assignment.
Equivalent of the reference's ``MapToFBSHeur.new_cone`` inner class
(``fbs_mapper/map_to_fbs.py:177-232``) and its index algebra
(``map_to_fbs.py:286-334,407-440``).

The invariant enforced at construction: the cone must be realizable as a
single functional bootstrap — no tt-0/tt-1 collision on the same mvt value,
and the completed test vector fits the FBS size, possibly through the
negacyclic (anti-cyclic ring) extension modes (``map_to_fbs.py:78-113``).
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

logger = logging.getLogger("fbs_mapper.cones")


def mvt_span(mvt: np.ndarray) -> int:
    """Number of distinct lincomb values the cone can take (range width)."""
    return int(np.max(mvt) - np.min(mvt) + 1)


def complete_test_vector(tt: np.ndarray, mvt: np.ndarray,
                         missing_val: int) -> list[int]:
    """Dense test vector over ``[mvt.min(), mvt.max()]``; holes get
    ``missing_val`` (reference ``map_to_fbs.py:73-76``)."""
    mvt = np.asarray(mvt)
    lo, hi = int(mvt.min()), int(mvt.max())
    table = np.full(hi - lo + 1, missing_val, dtype=np.int64)
    table[mvt - lo] = tt
    return table.tolist()


class ConeSpace:
    """Validity rules shared by all cones of one mapping run.

    ``fbs_size`` is the plaintext precision p; ``max_fbs_size`` is the longest
    acceptable test vector (2p when the negacyclic extension is enabled,
    p under ``--strict_fbs_size``).
    """

    def __init__(self, fbs_size: int, max_fbs_size: int,
                 dont_care: bool = False):
        self.fbs_size = fbs_size
        self.max_fbs_size = max_fbs_size
        # Sparse-mvt don't-cares (the reference's open TODO,
        # map_to_fbs.py:8-11): mvt holes — lincomb values no input
        # assignment reaches — are FREE per-position in the negacyclic
        # overlap check, instead of one global 0/1 fill.  A test vector
        # longer than p is then accepted iff SOME overlap constant
        # C in {1, 0, 2} (tv[x] + tv[x+p] = C) is consistent with the
        # defined entries alone.  Strictly more merges; exposed through
        # the beyond-parity mappers ("search+dc"/"best") — plain "search"
        # stays reference-parity.
        self.dont_care = dont_care

    # -- validity ---------------------------------------------------------
    def mvt_consistent(self, tt: np.ndarray, mvt: np.ndarray) -> bool:
        """No mvt value may be shared by a tt-0 and a tt-1 row."""
        return not np.isin(mvt[tt == 0], mvt[tt == 1]).any()

    def test_vector_ok(self, tv: Sequence[int]) -> bool:
        """A test vector longer than p but ≤ 2p is accepted in three
        negacyclic modes (reference ``map_to_fbs.py:81-98``):

        * mode 1: f(x) = 1 - f(x + p)   (complement on the overlap)
        * mode 2: f(x) = 0 = f(x + p)   (overlap constant 0)
        * mode 3: f(x) = 1 = f(x + p)   (overlap constant 1)
        """
        p = self.fbs_size
        if len(tv) <= p:
            return True
        if len(tv) > self.max_fbs_size:
            return False
        tv = np.asarray(tv)
        head, tail = tv[: len(tv) - p], tv[p:]
        if np.all(head != tail):
            return True
        if np.all(head == tail):
            return bool(np.all(head == 0) or np.all(head == 1))
        return False

    def _sparse_tv(self, tt: np.ndarray, mvt: np.ndarray) -> np.ndarray:
        mvt = np.asarray(mvt)
        lo = int(mvt.min())
        tv = np.full(int(mvt.max()) - lo + 1, -1, dtype=np.int64)
        tv[mvt - lo] = tt
        return tv

    def _dc_mode(self, tv: np.ndarray) -> int | None:
        """Feasible overlap constant C for a sparse tv (-1 = hole)."""
        p = self.fbs_size
        if len(tv) > self.max_fbs_size:
            return None
        head, tail = tv[: len(tv) - p], tv[p:]
        both = (head >= 0) & (tail >= 0)
        if not np.any(both & (head == tail)):
            return 1                       # complement mode realizable
        if not np.any(head == 1) and not np.any(tail == 1):
            return 0
        if not np.any(head == 0) and not np.any(tail == 0):
            return 2
        return None

    def lut_ok(self, tt: np.ndarray, mvt: np.ndarray) -> bool:
        if not self.mvt_consistent(tt, mvt):
            return False
        if mvt_span(mvt) <= self.fbs_size:
            return True
        if self.dont_care:
            return self._dc_mode(self._sparse_tv(tt, mvt)) is not None
        return (self.test_vector_ok(complete_test_vector(tt, mvt, 0))
                or self.test_vector_ok(complete_test_vector(tt, mvt, 1)))

    def fbs_test_vector(self, tt: np.ndarray, mvt: np.ndarray) -> list[int]:
        """The test vector a bootstrap of this cone will use; holes are
        filled with whichever missing value keeps the vector valid."""
        tv = complete_test_vector(tt, mvt, 0)
        if self.test_vector_ok(tv):
            return tv
        tv = complete_test_vector(tt, mvt, 1)
        if self.test_vector_ok(tv):
            return tv
        assert self.dont_care, "no valid test-vector completion"
        return self._dc_realize(self._sparse_tv(tt, mvt))

    def _dc_realize(self, tv: np.ndarray) -> list[int]:
        """Concrete per-hole filling for the feasible overlap constant."""
        c = self._dc_mode(tv)
        assert c is not None, "no valid don't-care completion"
        tv = tv.copy()
        p, n = self.fbs_size, len(tv)
        if c == 1:
            for x in range(n - p):
                if tv[x] < 0 and tv[x + p] >= 0:
                    tv[x] = 1 - tv[x + p]
                elif tv[x] >= 0 and tv[x + p] < 0:
                    tv[x + p] = 1 - tv[x]
                elif tv[x] < 0:
                    tv[x], tv[x + p] = 0, 1
        else:
            v = c // 2
            for x in range(n - p):
                if tv[x] < 0:
                    tv[x] = v
                if tv[x + p] < 0:
                    tv[x + p] = v
        tv[tv < 0] = 0                     # holes outside the overlap
        return tv.tolist()


class Cone:
    __slots__ = ("space", "support", "coefs", "tt", "mvt", "_support_names")

    def __init__(self, space: ConeSpace, support, coefs, tt, mvt):
        self.space = space
        self.support = np.asarray(support, dtype=object)
        self.coefs = np.asarray(coefs, dtype=np.int64)
        self.tt = np.asarray(tt, dtype=np.int64)
        self.mvt = np.asarray(mvt, dtype=np.int64)
        assert space.lut_ok(self.tt, self.mvt), f"invalid cone {self}"
        self._support_names = np.array([n.name for n in self.support])
        if self.size() != len(np.unique(self.mvt)):
            logger.debug("cone with sparse mvt: %d vs %d unique",
                         self.size(), len(np.unique(self.mvt)))

    # -- queries ----------------------------------------------------------
    def size(self) -> int:
        return mvt_span(self.mvt)

    def norm2_squared(self) -> int:
        return int(np.sum(self.coefs * self.coefs))

    def support_names(self) -> np.ndarray:
        return self._support_names

    def is_const(self) -> bool:
        return len(self.support) == 0

    def with_tt(self, new_tt) -> "Cone":
        return Cone(self.space, self.support, self.coefs, new_tt, self.mvt)

    def __repr__(self) -> str:
        return (f"Cone({list(self._support_names)}, {list(self.coefs)}, "
                f"{list(self.mvt)}, {list(self.tt)})")


# ---------------------------------------------------------------------------
# Truth-table index algebra over cone supports.
# ---------------------------------------------------------------------------

def tt_row_bits(nb_vars: int) -> np.ndarray:
    """[nb_vars, 2^nb_vars] matrix of variable values per tt row, MSB-first:
    row r of variable v is bit (nb_vars-1-v) of r."""
    rows = np.arange(1 << nb_vars, dtype=np.uint32)
    shifts = np.arange(nb_vars - 1, -1, -1, dtype=np.uint32)
    return ((rows[None, :] >> shifts[:, None]) & 1).astype(np.uint32)


def cone_pair_indices(sup1: np.ndarray, sup2: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Row indices of cone1/cone2 tables inside the union-support table.

    The union support is ``sup1 ++ (sup2 \\ sup1)`` in order; cone1's vars are
    a prefix, so its index simply repeats (reference ``map_to_fbs.py:415-431``).
    """
    sup1 = np.asarray(sup1)
    sup2 = np.asarray(sup2)
    sup_union = np.concatenate((sup1, sup2[~np.isin(sup2, sup1)]))
    n = len(sup_union)
    bits = tt_row_bits(n)

    idx2 = np.zeros(1 << n, dtype=np.uint32)
    for node in sup2:
        pos = int(np.where(sup_union == node)[0][0])
        idx2 = (idx2 << 1) + bits[pos]

    n1 = len(sup1)
    idx1 = np.repeat(np.arange(1 << n1, dtype=np.uint32), 1 << (n - n1))
    return idx1, idx2


def pair_tables(cone1: Cone, cone2: Cone, gate_tt: Sequence[int]
                ) -> tuple[np.ndarray, np.ndarray]:
    """(xy_mvt, r_tt) over the union support: per row, the (mvt1, mvt2) value
    pair and the gate output bit ``gate_tt[2*tt1 + tt2]``
    (reference ``map_to_fbs.py:433-440``)."""
    idx1, idx2 = cone_pair_indices(cone1.support_names(),
                                   cone2.support_names())
    xy_mvt = np.stack((cone1.mvt[idx1], cone2.mvt[idx2]), axis=1)
    r_tt = np.asarray(gate_tt, dtype=np.int64)[2 * cone1.tt[idx1]
                                               + cone2.tt[idx2]]
    return xy_mvt, r_tt


def dedupe_pair_rows(xy_mvt: np.ndarray, r_tt: np.ndarray):
    """Collapse the union-support rows to unique ``(x, y)`` value pairs.

    Validity of a lincomb ``a·x + b·y`` depends only on the set of
    ``(x, y, tt)`` triples, and the search's Σmvt² tie-break only on their
    multiplicities — so the O(2^|support|) row tables reduce to at most
    span(x)·span(y) rows for the whole coefficient scan.

    Returns ``(xu, yu, tt_u, counts)`` or ``None`` when some value pair
    occurs with both tt polarities: then every lincomb maps a tt-0 and a
    tt-1 row to the same value, so no valid coefficients exist at all.
    """
    x = xy_mvt[:, 0]
    y = xy_mvt[:, 1]
    key = (x - x.min()) * np.int64(y.max() - y.min() + 1) + (y - y.min())
    uniq, first, inverse, counts = np.unique(
        key, return_index=True, return_inverse=True, return_counts=True)
    ones = np.bincount(inverse, weights=r_tt).astype(np.int64)
    if np.any((ones > 0) & (ones < counts)):
        return None
    return (x[first].astype(np.int64), y[first].astype(np.int64),
            (ones > 0).astype(np.int64), counts.astype(np.int64))


def valid_pairs_mask(space: ConeSpace, cand: np.ndarray, xu: np.ndarray,
                     yu: np.ndarray, tt_u: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``lut_ok`` over candidate coefficient pairs.

    ``cand`` is [P, 2] (a, b) pairs; rows are the deduplicated value pairs
    from :func:`dedupe_pair_rows`.  Returns ``(valid [P] bool, mvts [P, U])``
    with semantics identical to calling ``space.lut_ok`` per pair on the
    full row tables (reference ``map_to_fbs.py:81-113``).
    """
    p, maxp = space.fbs_size, space.max_fbs_size
    mvts = cand[:, :1] * xu[None, :] + cand[:, 1:] * yu[None, :]
    lo = mvts.min(axis=1)
    span = mvts.max(axis=1) - lo + 1
    valid = np.zeros(len(cand), dtype=bool)
    sub = np.nonzero(span <= maxp)[0]
    if not len(sub):
        return valid, mvts

    sm = mvts[sub] - lo[sub, None]
    rows = np.arange(len(sub))[:, None]
    t0 = tt_u == 0
    pres0 = np.zeros((len(sub), maxp), dtype=bool)
    pres1 = np.zeros((len(sub), maxp), dtype=bool)
    if t0.any():
        pres0[rows, sm[:, t0]] = True
    if (~t0).any():
        pres1[rows, sm[:, ~t0]] = True
    consistent = ~(pres0 & pres1).any(axis=1)

    small = span[sub] <= p
    ok = consistent & small
    big = consistent & ~small
    if big.any():
        w = maxp - p
        in_win = np.arange(w)[None, :] < (span[sub, None] - p)
        if space.dont_care:
            # Sparse-mvt don't-cares: holes are free PER POSITION, so a
            # long tv is valid iff some overlap constant C is consistent
            # with the defined entries alone (ConeSpace._dc_mode).
            h0, h1 = pres0[:, :w], pres1[:, :w]
            q0, q1 = pres0[:, p:p + w], pres1[:, p:p + w]
            bad_c1 = (in_win & ((h0 & q0) | (h1 & q1))).any(axis=1)
            bad_c0 = (in_win & (h1 | q1)).any(axis=1)
            bad_c2 = (in_win & (h0 | q0)).any(axis=1)
            ok |= big & ~(bad_c1 & bad_c0 & bad_c2)
        else:
            # Negacyclic half-table acceptance: compare the head
            # tv[:span-p] against the tail tv[p:span] for both hole
            # fillings m in {0, 1} (reference test_vector_ok modes,
            # ``map_to_fbs.py:81-98``).
            for m in (0, 1):
                head = np.where(pres1[:, :w], 1,
                                np.where(pres0[:, :w], 0, m))
                tail = np.where(pres1[:, p:p + w], 1,
                                np.where(pres0[:, p:p + w], 0, m))
                eq = np.where(in_win, head == tail, True)
                all_diff = np.where(in_win, head != tail, True).all(axis=1)
                all_eq = eq.all(axis=1)
                head0 = np.where(in_win, head == 0, True).all(axis=1)
                head1 = np.where(in_win, head == 1, True).all(axis=1)
                ok |= big & (all_diff | (all_eq & (head0 | head1)))
    valid[sub] = ok
    return valid, mvts


def simplify_cone(space: ConeSpace, support: np.ndarray, coefs: np.ndarray,
                  tt: np.ndarray, mvt: np.ndarray) -> Cone:
    """Drop zero-coefficient support vars and gcd-reduce coefs and mvt
    (reference ``map_to_fbs.py:286-311``)."""
    zero = coefs == 0
    if np.any(zero):
        # Keep only tt/mvt rows where every dropped variable is 0.
        n = len(coefs)
        rows = np.arange(1 << n, dtype=np.uint32)
        dropped_mask = 0
        for pos in np.nonzero(zero)[0]:
            dropped_mask |= 1 << (n - 1 - int(pos))
        keep_rows = (rows & dropped_mask) == 0
        support = support[~zero]
        coefs = coefs[~zero]
        tt = tt[keep_rows]
        mvt = mvt[keep_rows]

    g = int(np.gcd.reduce(coefs)) if len(coefs) else 1
    if g > 1:
        coefs = coefs // g
        mvt = mvt // g

    return Cone(space, support, coefs, tt, mvt)


def merge_cones(space: ConeSpace, cone1: Cone, cone2: Cone,
                ab: tuple[int, int], new_tt: np.ndarray,
                new_mvt: np.ndarray) -> Cone:
    """Merge two cones into one via the lincomb a·cone1 + b·cone2; shared
    support nodes fold their coefficients into cone1's slots
    (reference ``map_to_fbs.py:313-334``)."""
    a, b = ab
    names1 = cone1.support_names()
    names2 = cone2.support_names()

    coefs1 = cone1.coefs * a
    coefs2 = cone2.coefs * b

    common = set(names1).intersection(names2)
    for name in common:
        i1 = int(np.where(names1 == name)[0][0])
        i2 = int(np.where(names2 == name)[0][0])
        coefs1[i1] += coefs2[i2]

    keep = ~np.isin(names2, list(common))
    support = np.concatenate((cone1.support, cone2.support[keep]))
    coefs = np.concatenate((coefs1, coefs2[keep]))
    return simplify_cone(space, support, coefs, np.asarray(new_tt),
                         np.asarray(new_mvt))
