"""Batched homomorphic executor for mapped FBS programs.

The counterpart of ``tfhe_fbs_map_tpu.runtime.executor``.  A
:class:`LutProgram` is compiled into per-level plans (bootstraps grouped by
depth, each level padded to a power-of-two bootstrap count, padding results
sent to one dummy wire row), equal to JAX's.  A level launches fewer: its
real bootstraps of the V evaluations together, padded only to whole tiles
of the kernel that serves the launch, as the cost model chooses each
launch once (:func:`..optimizer.runtime_model.launch_choice`,
:meth:`CircuitExecutor.launch_choices`); the choice carries K1's route and
plan down to the kernel (:meth:`CircuitExecutor.step`).  Two pipelines:

* native, one parameter family (:func:`compile_program`,
  :func:`_level_step`): each level is one gather + integer lincomb and one
  batched functional bootstrap of ``bootstraps × V`` ciphertexts;
* staged, two families over one master secret (:mod:`..tfhe.staged`,
  :func:`compile_staged`, :func:`_staged_level_step`): each level is one
  fam1 call (stage 1 of the split nodes, then the fam1 singles) and one
  fam2 call (stage 2 of the splits, then the fam2 singles), and wires are
  produced pre-scaled to what their consumers need.

:meth:`CircuitExecutor.run` walks the level groups (:func:`level_groups`:
runs of consecutive levels whose plan tensors have the same shapes, which
the JAX executor runs as one ``lax.scan`` each, and, on the card, whose
launches are of the same sizes).  On a CUDA device each
group is one CUDA graph, captured once a wire-buffer layout
(:meth:`CircuitExecutor.capture`) and replayed; on the CPU the group's
levels run one :meth:`CircuitExecutor.step` after another.  With a
checkpoint, ``run`` steps level by level, as JAX does.

Under a (dp, tp) mesh (:mod:`..parallel.mesh`) the wire buffer is a list
of per-position ``[W, V/dp, d]`` shards, the evaluation batch split in mesh
order over dp; the tp positions of a dp group each hold that group's shard
(a wire buffer is cheap to repeat), and its outputs are read from the
first.  The whole batch is encrypted with one rng, as on one device, and
then split, so every draw and every bit equals the one-device run's.  At
tp = 1 each position runs every level with its device's keys and plan
tensors (one copy a device), and on the card has its own static buffer and
graphs; nothing waits for a device between levels: each device's stream
orders its own work.  At tp > 1 (the ``"matmul"`` orientation only, JAX's
GSPMD level step) each level is one :func:`_tp_level_step` a dp group, its
bootstrap's key contraction split over the group's positions, each holding
its slice of the keys; those levels run eagerly, one after another, with
no graphs.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..frontend.lut_program import (LutProgram, N_BOOT, N_CONST, N_INPUT,
                                    N_LIN)
from ..ops import fused_blind_rotate as fbr
from ..optimizer.runtime_model import bucket, launch_choice, takes_ring
from ..parallel.mesh import (Mesh, check_tp, group_bootstrap,
                             position_keys, shard_batch)
from ..tfhe.encrypt import decode, encode, lwe_encrypt, lwe_phase
from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I64, wrap32
from ..tfhe.params import TFHEParams
from ..tfhe.pbs import build_test_vector, functional_bootstrap
from ..tfhe.staged import SELECT_P, StagedKeys, split_node
from ..utils import profiling

__all__ = ["CircuitExecutor", "LevelPlan", "StagedLevelPlan",
           "compile_program", "compile_staged", "staged_probe",
           "staged_level_routes", "native_level_boots", "level_groups"]


@dataclass
class LevelPlan:
    """Static tensors for one level of batched bootstraps."""

    wire_idx: np.ndarray     # [nb, T] gather rows into the wire buffer
    coefs: np.ndarray        # [nb, T] int32 lincomb coefficients (0-padded)
    consts: np.ndarray       # [nb] int32 lincomb constant * delta (torus)
    test_polys: np.ndarray   # [nb, N] int32
    posts: np.ndarray        # [nb] int32 post-rotation body offsets
    out_rows: np.ndarray     # [nb] destination rows in the wire buffer

    def arrays(self) -> tuple[np.ndarray, ...]:
        return (self.wire_idx, self.coefs, self.consts, self.test_polys,
                self.posts, self.out_rows)


@dataclass
class StagedLevelPlan:
    """Static tensors for one level of staged (two-family) bootstraps.

    Stage 1: the re-gridded x_lo lincomb through fam1 (and the fam1
    singles); stage 2: G + the branch lincomb through the select family
    (and the fam2 singles).  Coefficients multiply pre-scaled wires."""

    wire_idx1: np.ndarray    # [nb1, T]
    coefs1: np.ndarray       # [nb1, T]
    consts1: np.ndarray      # [nb1]
    tvs1: np.ndarray         # [nb1, N1]
    posts1: np.ndarray       # [nb1]
    out_rows1: np.ndarray    # [nb1] (dummy for split rows; real for singles)
    wire_idx2: np.ndarray    # [nb2, T]
    coefs2: np.ndarray       # [nb2, T]
    consts2: np.ndarray      # [nb2]
    tvs2: np.ndarray         # [nb2, N2]
    posts2: np.ndarray       # [nb2]
    out_rows: np.ndarray     # [nb2]
    n_splits: int = 0        # leading rows of both stages forming pairs

    def arrays(self) -> tuple[np.ndarray, ...]:
        return (self.wire_idx1, self.coefs1, self.consts1, self.tvs1,
                self.posts1, self.out_rows1, self.wire_idx2, self.coefs2,
                self.consts2, self.tvs2, self.posts2, self.out_rows)


@dataclass
class OutputSpec:
    kind: str                # "wire" | "lin" | "const"
    wire_idx: np.ndarray     # for lin: [T]; for wire: [1]
    coefs: np.ndarray
    const: int               # const term (value units) / const value


@dataclass
class Plan:
    input_rows: dict[str, int]
    levels: list
    outputs: dict[str, OutputSpec]
    dummy_row: int
    num_wires: int
    num_bootstraps: int


@dataclass
class StagedPlan(Plan):
    """A staged plan and what the JAX staged compile reports beside it."""

    row_scale: np.ndarray              # [num_wires] torus multiple a row
    route_counts: dict[str, int]       # nodes by route: f1, f2, split
    eff_norm1: int                     # max squared norm of a fam1 lincomb
    eff_norm2: int                     # the same for fam2 (+1 for G)
    level_routes: list[tuple[int, int, int]]   # (splits, f1, f2) a level


def _u32(x) -> np.int32:
    return np.int64(x).astype(np.uint32).astype(np.int32)


def _boot_nodes(prog: LutProgram, wire_row: dict, input_rows: dict):
    """Walk ``prog`` in topological order, giving wire rows to inputs and
    bootstraps; yields every bootstrap as (node, rows, coefs, const, wire
    bounds, level, row) with its source lincomb's terms."""
    level: dict[str, int] = {}
    for node in prog.nodes:
        if node.kind == N_INPUT:
            wire_row[node.name] = input_rows[node.name] = len(wire_row)
            level[node.name] = 0
        elif node.kind == N_LIN:
            level[node.name] = max((level[v.name] for _, v in node.terms),
                                   default=0)
        elif node.kind == N_BOOT:
            src = node.src
            if src.kind == N_LIN:
                rows = [wire_row[v.name] for _, v in src.terms]
                coefs = [int(c) for c, _ in src.terms]
                const = int(src.const)
                bounds = [v.max_val for _, v in src.terms]
            else:  # bootstrap of a raw input/bootstrap wire
                rows, coefs, const = [wire_row[src.name]], [1], 0
                bounds = [src.max_val]
            lv = level[src.name] + 1
            row = len(wire_row)
            wire_row[node.name] = row
            level[node.name] = lv
            yield node, rows, coefs, const, bounds, lv, row


def _output_specs(prog: LutProgram, wire_row: dict) -> dict[str, OutputSpec]:
    outputs: dict[str, OutputSpec] = {}
    for name, node in prog.outputs.items():
        if node.kind == N_CONST:
            outputs[name] = OutputSpec("const", np.zeros(0, np.int32),
                                       np.zeros(0, np.int32), node.const)
        elif node.kind == N_LIN:
            outputs[name] = OutputSpec(
                "lin",
                np.asarray([wire_row[v.name] for _, v in node.terms],
                           np.int32),
                np.asarray([int(c) for c, _ in node.terms], np.int32),
                int(node.const))
        else:
            outputs[name] = OutputSpec(
                "wire", np.asarray([wire_row[node.name]], np.int32),
                np.asarray([1], np.int32), 0)
    return outputs


def compile_program(prog: LutProgram, params) -> Plan:
    """Levelized plan of ``prog``, equal to the JAX ``_compile``'s arrays."""
    wire_row: dict[str, int] = {}
    input_rows: dict[str, int] = {}
    levels: dict[int, list] = {}
    for node, rows, coefs, const, _, lv, row in _boot_nodes(prog, wire_row,
                                                            input_rows):
        tv, post = build_test_vector(node.table, params)
        levels.setdefault(lv, []).append((rows, coefs, const, tv, post, row))

    dummy_row = len(wire_row)
    t_global = max((len(rows) for v in levels.values()
                    for rows, *_ in v), default=1)
    plans = []
    for lv in sorted(levels):
        entries = levels[lv]
        nb = bucket(len(entries))
        wire_idx = np.zeros((nb, t_global), dtype=np.int32)
        coefs = np.zeros((nb, t_global), dtype=np.int32)
        consts = np.zeros(nb, dtype=np.int32)
        tvs = np.zeros((nb, params.poly_size), dtype=np.int32)
        posts = np.zeros(nb, dtype=np.int32)
        out_rows = np.full(nb, dummy_row, dtype=np.int32)
        for j, (rows, cfs, const, tv, post, row) in enumerate(entries):
            wire_idx[j, :len(rows)] = rows
            coefs[j, :len(cfs)] = cfs
            consts[j] = _u32(const * params.delta)
            tvs[j] = tv
            posts[j] = _u32(post)
            out_rows[j] = row
        plans.append(LevelPlan(wire_idx, coefs, consts, tvs, posts,
                               out_rows))
    return Plan(input_rows, plans, _output_specs(prog, wire_row), dummy_row,
                len(wire_row) + 1, sum(len(v) for v in levels.values()))


def _single_ok(table, pf: int) -> bool:
    """Whether one size-``pf`` bootstrap realizes ``table``: directly, or
    through a negacyclic half-table mode."""
    tau = len(table)
    if tau <= pf:
        return True
    c = table[0] + table[pf]
    return tau <= 2 * pf and all(table[x] + table[x + pf] == c
                                 for x in range(tau - pf))


def compile_staged(prog: LutProgram, p: int, params1: TFHEParams,
                   params2: TFHEParams) -> StagedPlan:
    """Staged plan of ``prog`` at wire size ``p`` over the families
    ``params1`` / ``params2`` (keyless), equal to the JAX
    ``_compile_staged``.

    A node runs, cheapest first, as one fam2 bootstrap when its table fits
    the select grid, as one fam1 bootstrap when it fits fam1's, else as a
    two-stage split.  Each wire is produced at the gcd of the torus
    multiples its consumers need (the test vector carries the scale), so
    most lincomb multipliers collapse to 1.  Raises ValueError when a node
    fits none of the three."""
    wparams = params1.with_p(p)
    delta_w, delta1, delta2 = wparams.delta, params1.delta, params2.delta
    m1, m2 = p // params1.p, p // params2.p
    # splits are wired for the select grid; singles need the family grid
    # to divide the wire grid
    splits_ok = params1.p == p // 2 and p % (2 * params2.p) == 0
    wire_row: dict[str, int] = {}
    input_rows: dict[str, int] = {}
    needs: dict[int, set] = {}
    compiled, failures = [], []

    def need(r, x):
        needs.setdefault(r, set()).add(x)

    for node, rows, coefs, const, bounds, lv, row in _boot_nodes(
            prog, wire_row, input_rows):
        table = list(node.table)
        split = None
        if p % params2.p == 0 and _single_ok(table, params2.p):
            kind = "f2"
            for r, c in zip(rows, coefs):
                need(r, m2 * c)
        elif _single_ok(table, params1.p):
            kind = "f1"
            for r, c in zip(rows, coefs):
                need(r, m1 * c)
        else:
            kind = "split"
            if splits_ok:
                split = split_node(coefs, const, table, p, bounds=bounds)
            if split is None:
                failures.append(f"{node.name}: tau={len(table)} "
                                f"coefs={coefs} const={const}")
                continue
            for i in split.a_idx:
                need(rows[i], 2 * coefs[i])
            for i in split.b_idx:
                need(rows[i], coefs[i])
        compiled.append((lv, kind, rows, coefs, const, table, row, split))
    if failures:
        raise ValueError(
            "program has bootstrap nodes the staged pipeline cannot "
            "realize (run the native single-family executor instead): "
            + "; ".join(failures[:8]))

    for node in prog.outputs.values():
        if node.kind == N_LIN:
            for _, v in node.terms:
                need(wire_row[v.name], 1)
        elif node.kind != N_CONST:
            need(wire_row[node.name], 1)
    scale = {r: max(1, math.gcd(*ns) if len(ns) > 1 else abs(next(iter(ns))))
             for r, ns in needs.items()}
    row_scale = np.ones(len(wire_row) + 1, dtype=np.int64)
    for r, s in scale.items():
        row_scale[r] = s

    def mult(needed, r):
        s = scale.get(r, 1)
        assert needed % s == 0, (needed, s)
        return needed // s

    entries: dict[int, list] = {}
    for lv, kind, rows, coefs, const, table, row, split in compiled:
        out_delta = int(scale.get(row, 1)) * delta_w
        if kind == "f2":
            tv, post = build_test_vector(table, params2, out_delta=out_delta)
            e = dict(kind="f2", rows2=rows,
                     coefs2=[mult(m2 * c, r) for r, c in zip(rows, coefs)],
                     const2=const * delta2, tv2=tv, post2=post, row=row)
        elif kind == "f1":
            tv, post = build_test_vector(table, params1, out_delta=out_delta)
            e = dict(kind="f1", rows1=rows,
                     coefs1=[mult(m1 * c, r) for r, c in zip(rows, coefs)],
                     const1=const * delta1, tv1=tv, post1=post, row=row)
        else:
            tv1, post1 = build_test_vector(split.t1, params1,
                                           out_delta=delta2)
            tv2, post2 = build_test_vector(split.t2, params2,
                                           out_delta=out_delta)
            e = dict(kind="split",
                     rows1=[rows[i] for i in split.a_idx],
                     coefs1=[mult(2 * coefs[i], rows[i])
                             for i in split.a_idx],
                     const1=split.const_lo * delta1, tv1=tv1, post1=post1,
                     rows2=[rows[i] for i in split.b_idx],
                     coefs2=[mult(coefs[i], rows[i]) for i in split.b_idx],
                     const2=4 * split.const_hi * delta2, tv2=tv2,
                     post2=post2, row=row)
        entries.setdefault(lv, []).append(e)

    every = [e for lv in sorted(entries) for e in entries[lv]]
    dummy_row = len(wire_row)
    t_global = max([len(e.get("rows1", [])) for e in every]
                   + [len(e.get("rows2", [])) for e in every] + [1])
    N1, N2 = params1.poly_size, params2.poly_size
    levels = []
    for lv in sorted(entries):
        lvl = entries[lv]
        splits = [e for e in lvl if e["kind"] == "split"]
        f1s = [e for e in lvl if e["kind"] == "f1"]
        f2s = [e for e in lvl if e["kind"] == "f2"]
        ns = len(splits)
        nb1 = bucket(ns + len(f1s)) if (ns or f1s) else 0
        nb2 = bucket(ns + len(f2s)) if (ns or f2s) else 0
        wi1 = np.zeros((nb1, t_global), np.int32)
        cf1 = np.zeros((nb1, t_global), np.int32)
        cs1 = np.zeros(nb1, np.int32)
        tvs1 = np.zeros((nb1, N1), np.int32)
        ps1 = np.zeros(nb1, np.int32)
        or1 = np.full(nb1, dummy_row, np.int32)
        for j, e in enumerate(splits + f1s):
            wi1[j, :len(e["rows1"])] = e["rows1"]
            cf1[j, :len(e["coefs1"])] = e["coefs1"]
            cs1[j] = _u32(e["const1"])
            tvs1[j] = e["tv1"]
            ps1[j] = _u32(e["post1"])
            if e["kind"] == "f1":
                or1[j] = e["row"]
        wi2 = np.zeros((nb2, t_global), np.int32)
        cf2 = np.zeros((nb2, t_global), np.int32)
        cs2 = np.zeros(nb2, np.int32)
        tvs2 = np.zeros((nb2, N2), np.int32)
        ps2 = np.zeros(nb2, np.int32)
        or2 = np.full(nb2, dummy_row, np.int32)
        for j, e in enumerate(splits + f2s):
            wi2[j, :len(e.get("rows2", []))] = e.get("rows2", [])
            cf2[j, :len(e.get("coefs2", []))] = e.get("coefs2", [])
            cs2[j] = _u32(e["const2"])
            tvs2[j] = e["tv2"]
            ps2[j] = _u32(e["post2"])
            or2[j] = e["row"]
        levels.append(StagedLevelPlan(wi1, cf1, cs1, tvs1, ps1, or1,
                                      wi2, cf2, cs2, tvs2, ps2, or2, ns))

    return StagedPlan(
        input_rows, levels, _output_specs(prog, wire_row), dummy_row,
        len(wire_row) + 1, len(compiled),
        row_scale=row_scale,
        route_counts={k: sum(1 for e in every if e["kind"] == k)
                      for k in ("f1", "f2", "split")},
        # post-scaling squared norms per family (the noise model's input)
        eff_norm1=max((sum(c * c for c in e["coefs1"]) for e in every
                       if "coefs1" in e), default=1),
        eff_norm2=max((sum(c * c for c in e.get("coefs2", []))
                       + (e["kind"] == "split") for e in every
                       if e["kind"] != "f1"), default=1),
        level_routes=[tuple(sum(1 for e in entries[lv] if e["kind"] == k)
                            for k in ("split", "f1", "f2"))
                      for lv in sorted(entries)])


def _probe_plan(prog: LutProgram, p: int) -> StagedPlan:
    """:func:`compile_staged` with the family grids the JAX CLI would pick
    at ``p`` and shell sizes (the plan's routes do not depend on them)."""
    p1 = p // 2 if p >= 32 else p
    p2 = SELECT_P if p % SELECT_P == 0 else p // 2

    def shell(pp, k, N):
        return TFHEParams(p=pp, lwe_dim=16, glwe_dim=k, poly_size=N,
                          bsk_level=1, bsk_base_log=8, ksk_level=1,
                          ksk_base_log=8, lwe_noise_std=0.0,
                          glwe_noise_std=0.0)

    return compile_staged(prog, p, shell(p1, 1, 2048), shell(p2, 2, 1024))


def staged_probe(prog: LutProgram, p: int
                 ) -> tuple[int, int, dict[str, int]]:
    """Keyless staged probe: (eff_norm1, eff_norm2, route_counts), the
    inputs of the JAX ``optimize_staged``; raises ValueError when the
    program has nodes the staged pipeline cannot realize."""
    plan = _probe_plan(prog, p)
    return plan.eff_norm1, plan.eff_norm2, plan.route_counts


def staged_level_routes(prog: LutProgram, p: int
                        ) -> list[tuple[int, int, int]]:
    """Per-level (n_split, n_f1, n_f2) of the staged plan at ``p``: each
    level issues one fam1 call of ``ns + nf1`` real bootstraps (the plan
    pads it to ``bucket(ns + nf1)``) and one fam2 call of ``ns + nf2``."""
    return _probe_plan(prog, p).level_routes


def native_level_boots(prog: LutProgram) -> list[int]:
    """Per-level bootstrap counts of the native single-family plan (the
    level assignment of :func:`compile_program`, keyless)."""
    level: dict[str, int] = {}
    counts: dict[int, int] = {}
    for node in prog.nodes:
        if node.kind == N_INPUT:
            level[node.name] = 0
        elif node.kind == N_LIN:
            level[node.name] = max((level[v.name] for _, v in node.terms),
                                   default=0)
        elif node.kind == N_BOOT:
            lv = level[node.src.name] + 1
            level[node.name] = lv
            counts[lv] = counts.get(lv, 0) + 1
    return [counts[lv] for lv in sorted(counts)]


def _lincomb_flat(buf, wire_idx, coefs, consts) -> torch.Tensor:
    """Lincombs of gathered wires, flattened V-major: [V·nb, d] int32.

    An elementwise int64 multiply-and-sum (no integer matmul on CUDA),
    wrapped to int32."""
    nb = wire_idx.shape[0]
    _, v, d = buf.shape
    gathered = buf[wire_idx.to(I64)].to(I64)                      # [nb, T, V, d]
    lin = (coefs.to(I64)[:, :, None, None] * gathered).sum(1)
    lin[:, :, -1] += consts.to(I64)[:, None]
    return wrap32(lin).transpose(0, 1).reshape(v * nb, d)


def _run_fbs(keys: TFHEKeys, fast_keys, flat, tvs, posts, v: int,
             launch: profiling.Launch | None = None, choice=None):
    """One batched FBS of the V-major flat batch, the per-bootstrap test
    polynomials and offsets repeated for each of the V evaluations.
    ``launch``: the call's entry of the launch record; ``choice``: its
    launch as the cost model chose it
    (:class:`..optimizer.runtime_model.LaunchChoice`), whose K1 route and
    plan the kernel runs."""
    tvs_flat = tvs.repeat(v, 1)
    posts_flat = posts.repeat(v)
    if fast_keys is not None:
        from ..ops.blind_rotate import functional_bootstrap_fast
        return functional_bootstrap_fast(fast_keys, flat, tvs_flat,
                                         posts_flat, launch, choice)
    with profiling.launch(launch):
        return functional_bootstrap(keys, flat, tvs_flat, posts_flat)


def _scatter(buf, fresh, out_rows) -> torch.Tensor:
    """A level's fresh ciphertexts [V·nb, d] into rows ``out_rows`` of
    ``buf`` [W, V, d], in place."""
    nb = out_rows.shape[0]
    _, v, d = buf.shape
    # padding slots all bootstrap the zero ciphertext to the same value, so
    # the repeated dummy row in out_rows is written with equal rows
    buf[out_rows.to(I64)] = fresh.reshape(v, nb, d).transpose(0, 1)
    return buf


def _level_step(keys: TFHEKeys, fast_keys, buf, wire_idx, coefs, consts,
                tvs, posts, out_rows, launch: profiling.Launch | None = None,
                choice=None) -> torch.Tensor:
    """One native level, in place on ``buf`` [W, V, d]: lincombs of gathered
    wires, one batched FBS, results scattered to ``out_rows``.
    ``launch``: the FBS call's entry of the launch record; ``choice``: its
    launch choice (:func:`_run_fbs`)."""
    fresh = _run_fbs(keys, fast_keys, _lincomb_flat(buf, wire_idx, coefs,
                                                    consts), tvs, posts,
                     buf.shape[1], launch, choice)
    return _scatter(buf, fresh, out_rows)


def _tp_level_step(keys: list, bufs: list, plans: list,
                   launches: list | None = None) -> list:
    """One native level of a tp group, in place on each position's buffer
    (the same values in each): every position forms the same lincombs, the
    group runs one batched FBS, its key contraction split over the
    positions' slices of the ``"matmul"`` keys, and every position
    scatters the results into its buffer.  ``launches``: the FBS call's
    entries of the launch record, one a position."""
    v = bufs[0].shape[1]
    flats = [_lincomb_flat(b, *p[:3]) for b, p in zip(bufs, plans)]
    with profiling.launch(*(launches or ())):
        fresh = group_bootstrap(keys, flats,
                                [p[3].repeat(v, 1) for p in plans],
                                [p[4].repeat(v) for p in plans])
    return [_scatter(b, f, p[5]) for b, f, p in zip(bufs, fresh, plans)]


def _staged_level_step(keys1: TFHEKeys, keys2: TFHEKeys, fast1, fast2,
                       n_splits: int, buf, wi1, cf1, cs1, tvs1, ps1,
                       out_rows1, wi2, cf2, cs2, tvs2, ps2,
                       out_rows, launches: tuple = (None, None),
                       cleared: tuple = (None, None),
                       choices: tuple = (None, None)) -> torch.Tensor:
    """One staged level, in place on ``buf``: the fam1 call (stage 1 of the
    ``n_splits`` split nodes, then the fam1 singles) and its scatter, then
    the fam2 call, whose first ``n_splits`` rows add the stage-1 outputs G,
    and its scatter.  Split and padding rows of the fam1 call land on the
    dummy row.  ``launches``: the two calls' entries of the launch
    record.  ``cleared``: for each call, the dummy row where its plan pads
    and its launch does not, zeroed after its scatter, as the plan's
    padding rows (each the zero ciphertext) would leave it; else None.
    ``choices``: the two calls' launch choices (:func:`_run_fbs`)."""
    _, v, d = buf.shape
    nb1, nb2 = wi1.shape[0], wi2.shape[0]
    g = None
    if nb1:
        out1 = _run_fbs(keys1, fast1, _lincomb_flat(buf, wi1, cf1, cs1),
                        tvs1, ps1, v, launches[0],
                        choices[0]).reshape(v, nb1, d)
        g = out1[:, :n_splits]                            # [V, ns, d]
        buf[out_rows1.to(I64)] = out1.transpose(0, 1)
        if cleared[0] is not None:
            buf[cleared[0]] = 0
    if nb2:
        flat2 = _lincomb_flat(buf, wi2, cf2, cs2)
        if n_splits:
            lead = flat2.view(v, nb2, d)[:, :n_splits]
            lead.copy_(wrap32(lead.to(I64) + g.to(I64)))
        out2 = _run_fbs(keys2, fast2, flat2, tvs2, ps2, v, launches[1],
                        choices[1])
        buf[out_rows.to(I64)] = out2.reshape(v, nb2, d).transpose(0, 1)
        if cleared[1] is not None:
            buf[cleared[1]] = 0
    return buf


def level_groups(levels: list, staged: bool,
                 launched: list | None = None) -> list[range]:
    """The runs of consecutive levels whose plan tensors have the same
    shapes (and, staged, the same ``n_splits``), in order: the groups the
    JAX executor's ``_scan_groups_from(0)`` stacks into one ``lax.scan``
    each.  ``launched``: where given, each level's launch layout
    (:meth:`CircuitExecutor.launch_layout`), which must be equal too."""
    groups: list[range] = []
    last = None
    for lv, plan in enumerate(levels):
        key = tuple(x.shape for x in plan.arrays())
        if staged:
            key = (plan.n_splits,) + key
        if launched is not None:
            key += (launched[lv],)
        if groups and key == last:
            groups[-1] = range(groups[-1].start, lv + 1)
        else:
            groups.append(range(lv, lv + 1))
        last = key
    return groups


# One capture stream a device for the whole process, as torch.cuda.graph
# keeps one: cuBLAS keeps a workspace for every stream it has run on, so a
# stream of each executor's own would leave one behind for each.
_CAPTURE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _layout(shards: list[torch.Tensor]) -> tuple:
    """The key of a wire buffer's graphs: each position's device and
    shape."""
    return tuple((s.device, tuple(s.shape)) for s in shards)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    launches: tuple          # its family calls' entries, made at capture
    counts: tuple            # its kernel launches, (counter, key, count)
    span: str                # the host span of its replay


class _Graphs:
    """The captured level groups of one wire-buffer layout: a static buffer
    a position, and for each group and position (group-major, the order of
    capture and of replay) a CUDA graph with the launch record's entries
    of its family calls."""

    def __init__(self, statics: list[torch.Tensor]):
        self.statics = statics
        self.graphs: list[_Graph] = []

    def replay(self, batch: int | None = None) -> None:
        """Every group on every position, in place on the static buffers;
        each replay adds its kernel launches to ``fbr.LAUNCHES``,
        ``fbr.K1_KERNELS`` and ``fbr.K1_EPILOGUES``.  In traced
        run ``batch`` each replay is a host span and appends its entries to
        the launch record."""
        for g in self.graphs:
            if batch is None:
                g.graph.replay()
            else:
                with profiling.span(g.span, True):
                    g.graph.replay()
                profiling.record(g.launches, batch)
            for table, k, n in g.counts:
                table[k] += n


def _k1_kernel(path: str, poly_size: int) -> str | None:
    """The kernel a launch of the record's ``path`` runs at N =
    ``poly_size``, as ``fbr.K1_KERNELS`` names it (None: not K1's)."""
    if path == "k1s":
        return "k1s_kernel" if poly_size < fbr.K1_SLICE \
            else "k1s_kernel_wide"
    return "k1_kernel" if path == "k1" else None


def _take_back(entries, sizes: dict[str, int]) -> tuple:
    """Take the fused-kernel launches of ``entries`` (a capture's, which
    launched nothing, or a warm-up's) back out of ``fbr.LAUNCHES``, and
    K1's out of ``fbr.K1_KERNELS`` by the kernel each entry's path runs at
    its family's N (``sizes``, by family) and the ring kernel's out of
    ``fbr.K1_EPILOGUES``; returns them as (counter, key, count) triples."""
    kernels: dict[str, int] = {}
    for e in entries:
        k = _k1_kernel(e.path, sizes[e.family])
        if k is not None:
            kernels[k] = kernels.get(k, 0) + 1
    counts = [(fbr.LAUNCHES, k, n)
              for k, n in profiling.launch_counts(entries).items()]
    counts += [(fbr.K1_KERNELS, k, n) for k, n in kernels.items()]
    if kernels.get("k1_kernel"):  # a ring launch's epilogue
        counts.append((fbr.K1_EPILOGUES, "reduce", kernels["k1_kernel"]))
    for table, k, n in counts:
        table[k] -= n
    return tuple(counts)


class CircuitExecutor:
    def __init__(self, prog: LutProgram, keys: TFHEKeys | StagedKeys,
                 fast_keys=None, mesh: Mesh | None = None):
        """``keys``: :class:`TFHEKeys` (native pipeline) or
        :class:`StagedKeys` (staged pipeline); they fix the device the
        inputs are encrypted on.  ``fast_keys``: for the native pipeline an
        optional :class:`..ops.blind_rotate.FastKeys`, for the staged one an
        optional pair (fast1, fast2); a family without fast keys runs the
        generic bootstrap.  ``mesh``: an optional (dp, tp)
        :class:`..parallel.mesh.Mesh`; the buffers of :meth:`encrypt_inputs`
        and :meth:`run` are then lists of shards, one a position, and the
        keys are copied once to each of the mesh's devices (at tp > 1 each
        position's slice of them).  A mesh with tp > 1 takes native
        ``"matmul"`` keys alone, and a staged run under a mesh the fused
        orientations, not ``"matmul"`` nor a conv one (JAX's rules,
        ``executor.py:546-548``): ValueError otherwise."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.staged = isinstance(keys, StagedKeys)
        if self.staged:
            if fast_keys is not None and len(fast_keys) != 2:
                raise ValueError("staged fast_keys: a (fast1, fast2) pair")
            if mesh is not None and any(
                    f.orientation not in ("fused", "fused_otf")
                    for f in fast_keys or ()):
                raise ValueError(
                    "the staged executor under a mesh takes the fused "
                    "orientations, not " + "+".join(
                        f.orientation for f in fast_keys))
            self.params = keys.wire_params
            plan = compile_staged(prog, keys.p, keys.keys1.params,
                                  keys.keys2.params)
        elif isinstance(keys, TFHEKeys):
            self.params = keys.params
            plan = compile_program(prog, self.params)
        else:
            raise TypeError(f"keys: TFHEKeys or StagedKeys, not "
                            f"{type(keys).__name__}")
        profiling.tracing()              # a profiler off now ends a session
        self.prog = prog
        self.keys = keys
        self.fast_keys = fast_keys
        self.mesh = mesh
        self.device = keys.device
        self.plan = plan
        self.input_rows = plan.input_rows
        self.levels = plan.levels
        self.outputs = plan.outputs
        self.dummy_row = plan.dummy_row
        self.num_wires = plan.num_wires
        self.num_bootstraps = plan.num_bootstraps
        self._replicas = {self.device: (keys, fast_keys)}
        self.tp = mesh.tp if mesh is not None else 1
        self._tp_keys = None
        if self.tp > 1:
            first = fast_keys[0] if self.staged and fast_keys else fast_keys
            check_tp(self.tp, getattr(first, "orientation", None))
            self._tp_keys = position_keys(mesh, fast_keys)
        # copy the keys and plans to every device of the mesh now, not
        # inside the first timed level
        for dev in mesh.distinct if mesh is not None else ():
            self._replica(dev)
            self.plan_tensors(dev)

    @property
    def levels(self) -> list:
        return self._levels

    @levels.setter
    def levels(self, levels: list) -> None:
        """New levels drop what was built from the old ones: the plan
        tensors on the devices, the captured graphs, the family calls'
        counts and the launch layouts."""
        self._levels = levels
        self._plan_device = None
        self._graphs: dict[tuple, _Graphs] = {}
        self._plan_calls: dict[int, list] = {}
        self._choices: dict[tuple, list] = {}
        self._layouts: dict[tuple, list] = {}
        self._launch_device: dict[tuple, list] = {}

    @property
    def groups(self) -> list[range]:
        """The plan's level groups (:func:`level_groups`), JAX's scan
        groups."""
        return level_groups(self.levels, self.staged)

    def launch_groups(self, v: int, card: bool = True) -> list[range]:
        """The level groups :meth:`run` walks at ``v`` evaluations a
        position, one CUDA graph each on the card: the plan's groups split
        where the launch layout changes (:meth:`launch_layout`)."""
        return level_groups(self.levels, self.staged,
                            self.launch_layout(v, card))

    def _replica(self, device: torch.device):
        """(keys, fast keys) on ``device``: the executor's own on their
        device, elsewhere copies made once (at tp > 1 no fast keys: each
        position holds its slice of them)."""
        if device not in self._replicas:
            fast = self.fast_keys if self.tp == 1 else None
            if fast is not None:
                fast = (tuple(f.to(device) for f in fast) if self.staged
                        else fast.to(device))
            self._replicas[device] = (self.keys.to(device), fast)
        return self._replicas[device]

    def plan_tensors(self, device: torch.device | None = None
                     ) -> list[tuple[torch.Tensor, ...]]:
        """Per-level plan tensors on ``device`` (default the keys'),
        uploaded once a device."""
        device = self.device if device is None else device
        if self._plan_device is None:
            self._plan_device = {}
        if device not in self._plan_device:
            self._plan_device[device] = [
                tuple(torch.from_numpy(x).to(device) for x in p.arrays())
                for p in self.levels]
        return self._plan_device[device]

    def _calls(self, lv: int) -> list[tuple[str, int, int]]:
        """(family, bootstraps in the plan, real bootstraps) of each family
        call of level ``lv`` for one evaluation: ``native``, or ``fam1``
        and ``fam2``.  Real are the out-rows that are not the dummy row,
        and a staged fam1 call's ``n_splits`` split rows; they come first
        in the plan's arrays."""
        if lv not in self._plan_calls:
            plan, dummy = self.levels[lv], self.dummy_row
            if self.staged:
                calls = [("fam1", plan.wire_idx1.shape[0],
                          int(np.sum(plan.out_rows1 != dummy))
                          + plan.n_splits),
                         ("fam2", plan.wire_idx2.shape[0],
                          int(np.sum(plan.out_rows != dummy)))]
            else:
                calls = [("native", plan.wire_idx.shape[0],
                          int(np.sum(plan.out_rows != dummy)))]
            self._plan_calls[lv] = calls
        return self._plan_calls[lv]

    def _families(self) -> list[tuple]:
        """(fast keys or None, parameters) of each family."""
        fasts = (self.fast_keys or (None, None)) if self.staged \
            else (self.fast_keys,)
        params = ((self.keys.keys1.params, self.keys.keys2.params)
                  if self.staged else (self.keys.params,))
        return list(zip(fasts, params))

    def launch_choices(self, v: int, card: bool = True) -> list[tuple]:
        """Each family call's launch at every level at ``v`` evaluations a
        position, as the cost model chooses it once
        (:func:`..optimizer.runtime_model.launch_choice`): its real
        bootstraps packed over the V evaluations, on the card (``card``)
        padded to whole tiles of the kernel that serves them; at tp > 1 the
        level's bucket.  The launch record names its path, and :meth:`step`
        hands its K1 route and plan down to the kernel; a K1 family whose
        every launch the small tiles hold in one wave keeps them all there
        (:func:`..optimizer.runtime_model.takes_ring`).  Cached."""
        key = (v, card)
        if key not in self._choices:
            whole = self.tp > 1
            fams = [(p, (f.orientation, f.limbs, f.route) if f is not None
                     else (None, fbr.N_LIMBS, None))
                    for f, p in self._families()]
            calls = [self._calls(lv) for lv in range(len(self.levels))]
            rings = [how[0] != "fused_otf" or takes_ring(
                p, [v * (c[i][1] if whole else c[i][2]) for c in calls],
                how[1]) for i, (p, how) in enumerate(fams)]
            self._choices[key] = [
                tuple(launch_choice(p, nb if whole else real, v, *how,
                                    card and not whole, ring)
                      for (_, nb, real), (p, how), ring in zip(
                          lv_calls, fams, rings))
                for lv_calls in calls]
        return self._choices[key]

    def launch_layout(self, v: int, card: bool = True
                      ) -> list[tuple[int, ...]]:
        """The bootstraps an evaluation each family call of every level
        launches at ``v`` evaluations a position: the plan's real ones
        first, then its padding up to the count
        :meth:`launch_choices` launches.  Cached."""
        key = (v, card)
        if key not in self._layouts:
            self._layouts[key] = [tuple(c.launched // v for c in calls)
                                  for calls in self.launch_choices(v, card)]
        return self._layouts[key]

    def launch_tensors(self, device: torch.device, v: int
                       ) -> list[tuple[torch.Tensor, ...]]:
        """Per-level plan tensors on ``device`` cut to the launch layout at
        ``v`` evaluations (:meth:`launch_layout`): views of the first rows
        of :meth:`plan_tensors`.  Cached."""
        key = (device, v)
        if key not in self._launch_device:
            layout = self.launch_layout(v, device.type == "cuda")
            got = []
            for plan, rows in zip(self.plan_tensors(device), layout):
                per = len(plan) // len(rows)
                got.append(tuple(x[:rows[i // per]]
                                 for i, x in enumerate(plan)))
            self._launch_device[key] = got
        return self._launch_device[key]

    def family_calls(self, lv: int, v: int = 1, card: bool | None = None
                     ) -> list[tuple[str, int, int]]:
        """(family, bootstraps launched, real bootstraps) of each family
        call of level ``lv`` at ``v`` evaluations a position: ``native``,
        or ``fam1`` and ``fam2`` (a call of none launched is not made);
        launched by :meth:`launch_layout` (``card``: default whether the
        executor's device is a card).  Real are the out-rows that are not
        the dummy row, and a staged fam1 call's ``n_splits`` split rows."""
        if card is None:
            card = self.device.type == "cuda"
        rows = self.launch_layout(v, card)[lv]
        return [(fam, v * r, v * real)
                for (fam, _, real), r in zip(self._calls(lv), rows)]

    def _launches(self, buf: torch.Tensor, lv: int) -> list:
        """The launch record's entries of level ``lv``'s family calls on
        ``buf``'s position, one a family (None for each where no
        :func:`..utils.profiling.collect` block is open)."""
        v, dev = buf.shape[1], buf.device
        choices = self.launch_choices(v, dev.type == "cuda")[lv]
        if not profiling.collecting():
            return [None] * len(choices)
        return [profiling.Launch(None, lv, fam, str(dev), c.path, c.launched,
                                 v * real)
                for (fam, _, real), c in zip(self._calls(lv), choices)]

    def step(self, buf: torch.Tensor, lv: int) -> torch.Tensor:
        """Run level ``lv`` in place on ``buf`` (one device's buffer or
        shard, with that device's keys) at its launch layout; returns it.
        At tp > 1 a level is a tp group's, not one shard's: ValueError."""
        if self.tp > 1:
            raise ValueError("at tp > 1 a level runs on a tp group's "
                             "shards together (run)")
        keys, fast = self._replica(buf.device)
        v, card = buf.shape[1], buf.device.type == "cuda"
        plan = self.launch_tensors(buf.device, v)[lv]
        choices = self.launch_choices(v, card)[lv]
        launches = self._launches(buf, lv)
        if self.staged:
            fast1, fast2 = fast or (None, None)
            cleared = tuple(
                self.dummy_row if r == real < nb else None
                for (_, nb, real), r in zip(self._calls(lv),
                                            self.launch_layout(v, card)[lv]))
            return _staged_level_step(keys.keys1, keys.keys2, fast1, fast2,
                                      self.levels[lv].n_splits, buf, *plan,
                                      launches=launches, cleared=cleared,
                                      choices=choices)
        return _level_step(keys, fast, buf, *plan, launch=launches[0],
                           choice=choices[0])

    def _step_all(self, shards: list[torch.Tensor], lv: int
                  ) -> list[torch.Tensor]:
        """Level ``lv`` on every shard: one :meth:`step` a position, or at
        tp > 1 one :func:`_tp_level_step` a dp group."""
        if self.tp == 1:
            return [self.step(s, lv) for s in shards]
        out = []
        for keys, bufs in zip(self.mesh.groups(self._tp_keys),
                              self.mesh.groups(shards)):
            plans = [self.plan_tensors(b.device)[lv] for b in bufs]
            out += _tp_level_step(keys, bufs, plans,
                                  [self._launches(b, lv)[0] for b in bufs])
        return out

    def _shard(self, buf: torch.Tensor):
        """A whole-batch buffer as :meth:`run` takes it: on the keys' device
        without a mesh, else this process's shards."""
        if self.mesh is None:
            return buf.to(self.device)
        return shard_batch(self.mesh, buf, axis=1)

    def encrypt_inputs(self, values: dict[str, np.ndarray],
                       rng: np.random.Generator):
        """The initial wire buffer [num_wires, V, kN+1]: all inputs in one
        encryption, with the JAX executor's draws.  Staged inputs are
        encrypted pre-scaled to their consumers' torus multiple, under
        fam1's key and noise.  Under a mesh the whole batch is encrypted
        the same way and this process's dp shards are returned."""
        v = len(next(iter(values.values()))) if values else 1
        if self.mesh is not None and v % self.mesh.dp:
            raise ValueError(f"batch {v} must be divisible by the dp axis "
                             f"({self.mesh.dp})")
        d = self.params.big_dim + 1
        buf = torch.zeros((self.num_wires, v, d), dtype=torch.int32,
                          device=self.device)
        names = list(self.input_rows)
        if names:
            holder = self.keys.keys1 if self.staged else self.keys
            scale = self.plan.row_scale if self.staged else None
            flat = np.concatenate([
                np.asarray(values[n], dtype=np.int64)
                * (1 if scale is None else int(scale[self.input_rows[n]]))
                for n in names])
            cts = lwe_encrypt(holder.extracted_key, encode(flat, self.params),
                              holder.params.glwe_noise_std, rng)
            rows = torch.tensor([self.input_rows[n] for n in names],
                                device=self.device)
            buf[rows] = cts.reshape(len(names), v, d)
        return buf if self.mesh is None else self._shard(buf)

    def _leaders(self, shards) -> list[torch.Tensor]:
        """The shard of each dp group's first position."""
        return self.mesh.leaders(shards) if self.mesh is not None \
            else list(shards)

    def _shards(self, buf) -> list[torch.Tensor]:
        """``buf`` as :meth:`run` takes it, as a list of shards."""
        if (self.mesh is not None) == isinstance(buf, torch.Tensor):
            raise TypeError("run takes a list of shards under a mesh, a "
                            "tensor without one")
        return list(buf) if self.mesh is not None else [buf]

    def capture(self, buf) -> int:
        """Capture the CUDA graphs :meth:`run` replays for ``buf``'s layout
        (a tensor, or under a mesh this process's shards) now, so that no
        timed run pays for it; returns how many it captured (groups ×
        positions): 0 off the card, at tp > 1 (eager levels) or when they
        exist already.  ``buf``'s values are not used."""
        shards = self._shards(buf)
        profiling.tracing()              # a profiler off now ends a session
        if shards[0].device.type != "cuda" or self.tp > 1 \
                or _layout(shards) in self._graphs:
            return 0
        return len(self._graphs_of(shards).graphs)

    def _graphs_of(self, shards: list[torch.Tensor]) -> _Graphs:
        """The graphs of the shards' layout, captured where they are not."""
        key = _layout(shards)
        if key not in self._graphs:
            self._graphs[key] = self._capture(shards)
        return self._graphs[key]

    def _capture(self, shards: list[torch.Tensor]) -> _Graphs:
        """One CUDA graph for every level group at every position, captured
        group-major (the order :meth:`_Graphs.replay` replays them in), the
        graphs of a device in one memory pool, each reading and writing its
        position's static buffer.

        First each device runs the first level of each launch layout once
        (:meth:`launch_layout`: each launch size, and so each kernel plan),
        on a scratch copy, on the capture stream: that builds and loads the
        kernels and fills their plan caches and cuBLAS's workspace, so that
        nothing in a capture waits for the card.  Each graph keeps the
        launch record's entries of the family calls it captured; the
        kernel launches of those and of the warm-up's are taken back out
        of ``fbr.LAUNCHES``, ``fbr.K1_KERNELS`` and ``fbr.K1_EPILOGUES``
        (:func:`_take_back`), and
        each replay adds its graph's.  A capture that meets a host sync
        raises."""
        devices = list(dict.fromkeys(s.device for s in shards))
        sizes = dict(zip(("fam1", "fam2") if self.staged else ("native",),
                         (p.poly_size for _, p in self._families())))
        firsts: dict[tuple, int] = {}
        for lv, rows in enumerate(self.launch_layout(shards[0].shape[1])):
            firsts.setdefault(rows, lv)
        groups = self.launch_groups(shards[0].shape[1])
        pools = {}
        with profiling.collect() as warm:
            try:
                for dev in devices:
                    self._replica(dev)
                    self.plan_tensors(dev)
                    stream = _capture_stream(dev)
                    stream.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        scratch = next(s for s in shards
                                       if s.device == dev).clone()
                        for lv in firsts.values():
                            self.step(scratch, lv)
                        del scratch
                    torch.cuda.current_stream(dev).wait_stream(stream)
                    pools[dev] = torch.cuda.graph_pool_handle()
            finally:
                _take_back(warm.entries, sizes)
        graphs = _Graphs([torch.empty_like(s) for s in shards])
        for i, group in enumerate(groups):
            for static in graphs.statics:
                dev = static.device
                graph = torch.cuda.CUDAGraph()
                with profiling.collect() as got:
                    try:
                        with torch.cuda.device(dev), torch.cuda.graph(
                                graph, pool=pools[dev],
                                stream=_capture_stream(dev)):
                            for lv in group:
                                self.step(static, lv)
                    finally:
                        counts = _take_back(got.entries, sizes)
                graphs.graphs.append(_Graph(
                    graph, tuple(got.entries), counts,
                    f"tfhe.replay g{i} levels {group.start}-"
                    f"{group.stop - 1} {dev}"))
        return graphs

    def run(self, buf, checkpoint: str | None = None,
            checkpoint_every: int | None = None,
            checkpoint_budget: float = 0.1):
        """Execute all levels on a copy of ``buf`` (a tensor, or under a
        mesh this process's shards); returns the filled wire buffer in the
        same form.

        Without a checkpoint on a CUDA device at tp = 1 it copies ``buf``
        into the static buffers of its layout, replays every level group's
        graph (capturing them first where :meth:`capture` has not) and
        returns copies.  On the CPU, with a checkpoint, and at tp > 1 the
        levels run one after another (:meth:`step` a position, at tp > 1
        one tp group's step a dp group), which is each group's levels in
        turn.

        While a torch profiler records, the run is a host span with the
        spans and launch record of :mod:`..utils.profiling` inside it.

        ``checkpoint``: optional ``.npz`` path.  The whole buffer is saved
        (keys ``buf``, ``level``, ``num_levels``, as the JAX executor saves
        it; under a mesh each dp group's first shard, gathered in batch
        order) and a matching
        file resumes the run after its level, on whatever mesh this
        executor has.  Not for a mesh that spans processes.
        ``checkpoint_every``: fixed level interval; default: adaptive, a
        snapshot is taken when the time spent on snapshots stays within
        ``checkpoint_budget`` of the elapsed run, priced by the last one."""
        args = (buf, checkpoint, checkpoint_every, checkpoint_budget)
        if not profiling.tracing():
            return self._run(*args, None)
        with profiling.span("tfhe.run", True):
            return self._run(*args, profiling.begin_batch())

    def _run(self, buf, checkpoint, checkpoint_every, checkpoint_budget,
             batch: int | None):
        """:meth:`run`; ``batch``: the traced run's index in the launch
        record (None: untraced)."""
        traced = batch is not None
        shards = self._shards(buf)
        if checkpoint is None and shards[0].device.type == "cuda" \
                and self.tp == 1:
            graphs = self._graphs_of(shards)
            with profiling.span("tfhe.copy_in", traced):
                for static, s in zip(graphs.statics, shards):
                    static.copy_(s)
            graphs.replay(batch)
            with profiling.span("tfhe.copy_out", traced):
                shards = [static.clone() for static in graphs.statics]
            return shards if self.mesh is not None else shards[0]
        if checkpoint is not None and self.mesh is not None \
                and self.mesh.spans_processes:
            raise ValueError("checkpoints of a mesh that spans processes "
                             "are not supported")
        t_run = time.time()
        spent, cost_est = 0.0, 0.0
        start = 0
        shards = [s.clone() for s in shards]
        if checkpoint is not None:
            whole = (shards[0].shape[0],
                     sum(s.shape[1] for s in self._leaders(shards)),
                     shards[0].shape[2])
            try:
                with np.load(checkpoint) as z:
                    if z["num_levels"] == len(self.levels) \
                            and z["buf"].shape == whole:
                        start = int(z["level"]) + 1
                        loaded = self._shard(torch.from_numpy(z["buf"]))
                        shards = loaded if self.mesh is not None \
                            else [loaded]
            except FileNotFoundError:
                pass
        with (profiling.collect(batch=batch) if traced
              else contextlib.nullcontext()):
            for lv in range(start, len(self.levels)):
                with profiling.span(f"tfhe.level {lv}", traced):
                    shards = self._step_all(shards, lv)
                if checkpoint is None or lv + 1 >= len(self.levels):
                    continue
                if checkpoint_every is not None:
                    due = (lv + 1) % checkpoint_every == 0
                else:
                    due = spent + cost_est < checkpoint_budget * (
                        time.time() - t_run)
                if due:
                    t0 = time.time()
                    np.savez(checkpoint, buf=np.concatenate(
                        [s.cpu().numpy() for s in self._leaders(shards)],
                        axis=1), level=lv,
                        num_levels=len(self.levels))
                    cost_est = time.time() - t0
                    spent += cost_est
                    print(f"# checkpoint level {lv}: {cost_est:.2f}s "
                          f"(total {spent:.2f}s of "
                          f"{time.time() - t_run:.2f}s)", file=sys.stderr)
        return shards if self.mesh is not None else shards[0]

    def decrypt_outputs(self, buf) -> dict[str, np.ndarray]:
        """All outputs in one gather + lincomb + phase, decoded on the wire
        grid; of a list of shards, each dp group's first decrypted on its
        device and the outputs joined along the batch in mesh order."""
        if isinstance(buf, (list, tuple)):
            parts = [self.decrypt_outputs(s) for s in self._leaders(buf)]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        params = self.params
        out: dict[str, np.ndarray] = {}
        v = buf.shape[1]
        names = [n for n, s in self.outputs.items() if s.kind != "const"]
        for name, spec in self.outputs.items():
            if spec.kind == "const":
                out[name] = np.full(v, spec.const, dtype=np.int64)
        if not names:
            return out
        t_max = max(1, max(len(self.outputs[n].wire_idx) for n in names))
        idx = np.full((len(names), t_max), self.dummy_row, dtype=np.int64)
        cfs = np.zeros((len(names), t_max), dtype=np.int64)
        consts = np.zeros(len(names), dtype=np.int64)
        for o, name in enumerate(names):
            spec = self.outputs[name]
            idx[o, :len(spec.wire_idx)] = spec.wire_idx
            cfs[o, :len(spec.coefs)] = spec.coefs
            consts[o] = spec.const * params.delta
        dev = buf.device
        cts = buf[torch.from_numpy(idx).to(dev)].to(I64)  # [O, T, V, d]
        lin = (torch.from_numpy(cfs).to(dev)[:, :, None, None] * cts).sum(1)
        lin[:, :, -1] += torch.from_numpy(consts).to(dev)[:, None]
        lin = wrap32(lin)
        phases = lwe_phase(self._replica(dev)[0].extracted_key,
                           lin.reshape(-1, lin.shape[-1])).cpu().numpy()
        decoded = decode(phases, params).reshape(len(names), v)
        for o, name in enumerate(names):
            out[name] = decoded[o]
        return out

    def run_cleartext(self, values: dict[str, np.ndarray],
                      seed: int = 0) -> dict[str, np.ndarray]:
        """encrypt → run → decrypt convenience wrapper."""
        rng = np.random.default_rng(seed)
        return self.decrypt_outputs(self.run(self.encrypt_inputs(values,
                                                                 rng)))
