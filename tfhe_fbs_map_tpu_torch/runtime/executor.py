"""Batched homomorphic executor for mapped FBS programs (native path).

The counterpart of ``tfhe_fbs_map_tpu.runtime.executor`` for one parameter
family on one device.  A :class:`LutProgram` is compiled into per-level
plans (bootstraps grouped by depth, each level padded to a power-of-two
bootstrap count, padding results sent to one dummy wire row); :meth:`run`
is a Python loop of :func:`_level_step` over the levels.  Each step is one
gather + integer lincomb and one batched functional bootstrap of
``bootstraps × V`` ciphertexts.

Not here yet: the staged two-family pipeline, multi-device execution and
grouping levels into one launch; the constructor refuses staged keys and a
mesh.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..frontend.lut_program import (LutProgram, N_BOOT, N_CONST, N_INPUT,
                                    N_LIN)
from ..tfhe.encrypt import decode, encode, lwe_encrypt, lwe_phase
from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I64, wrap32
from ..tfhe.pbs import build_test_vector, functional_bootstrap

__all__ = ["CircuitExecutor", "LevelPlan", "compile_program"]


@dataclass
class LevelPlan:
    """Static tensors for one level of batched bootstraps."""

    wire_idx: np.ndarray     # [nb, T] gather rows into the wire buffer
    coefs: np.ndarray        # [nb, T] int32 lincomb coefficients (0-padded)
    consts: np.ndarray       # [nb] int32 lincomb constant * delta (torus)
    test_polys: np.ndarray   # [nb, N] int32
    posts: np.ndarray        # [nb] int32 post-rotation body offsets
    out_rows: np.ndarray     # [nb] destination rows in the wire buffer


@dataclass
class OutputSpec:
    kind: str                # "wire" | "lin" | "const"
    wire_idx: np.ndarray     # for lin: [T]; for wire: [1]
    coefs: np.ndarray
    const: int               # const term (value units) / const value


@dataclass
class Plan:
    input_rows: dict[str, int]
    levels: list[LevelPlan]
    outputs: dict[str, OutputSpec]
    dummy_row: int
    num_wires: int
    num_bootstraps: int


def _u32(x) -> np.int32:
    return np.int64(x).astype(np.uint32).astype(np.int32)


def _bucket(nb: int) -> int:
    b = 1
    while b < nb:
        b *= 2
    return b


def compile_program(prog: LutProgram, params) -> Plan:
    """Levelized plan of ``prog``, equal to the JAX ``_compile``'s arrays."""
    wire_row: dict[str, int] = {}
    input_rows: dict[str, int] = {}
    levels: dict[int, list] = {}
    node_level: dict[str, int] = {}

    def lin_parts(node):
        return ([wire_row[v.name] for _, v in node.terms],
                [int(c) for c, _ in node.terms], int(node.const))

    for node in prog.nodes:
        if node.kind == N_INPUT:
            wire_row[node.name] = len(wire_row)
            input_rows[node.name] = wire_row[node.name]
            node_level[node.name] = 0
        elif node.kind == N_LIN:
            node_level[node.name] = max(
                (node_level[v.name] for _, v in node.terms), default=0)
        elif node.kind == N_BOOT:
            src = node.src
            if src.kind == N_LIN:
                rows, coefs, const = lin_parts(src)
            else:  # bootstrap of a raw input/bootstrap wire
                rows, coefs, const = [wire_row[src.name]], [1], 0
            lv = node_level[src.name] + 1
            row = len(wire_row)
            wire_row[node.name] = row
            node_level[node.name] = lv
            tv, post = build_test_vector(node.table, params)
            levels.setdefault(lv, []).append(
                (rows, coefs, const, tv, post, row))

    # one extra dummy wire row receives the results of padding slots
    dummy_row = len(wire_row)
    t_global = max((len(rows) for v in levels.values()
                    for rows, *_ in v), default=1)
    plans = []
    for lv in sorted(levels):
        entries = levels[lv]
        nb = _bucket(len(entries))
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

    outputs: dict[str, OutputSpec] = {}
    for name, node in prog.outputs.items():
        if node.kind == N_CONST:
            outputs[name] = OutputSpec("const", np.zeros(0, np.int32),
                                       np.zeros(0, np.int32), node.const)
        elif node.kind == N_LIN:
            rows, cfs, const = lin_parts(node)
            outputs[name] = OutputSpec("lin", np.asarray(rows, np.int32),
                                       np.asarray(cfs, np.int32), const)
        else:
            outputs[name] = OutputSpec(
                "wire", np.asarray([wire_row[node.name]], np.int32),
                np.asarray([1], np.int32), 0)
    return Plan(input_rows, plans, outputs, dummy_row, len(wire_row) + 1,
                sum(len(v) for v in levels.values()))


def _level_step(keys: TFHEKeys, fast_keys, buf, wire_idx, coefs, consts,
                tvs, posts, out_rows) -> torch.Tensor:
    """One level, in place on ``buf`` [W, V, d]: lincombs of gathered wires,
    one batched FBS (flattened V-major), results scattered to ``out_rows``.

    The lincomb is an elementwise int64 multiply-and-sum (no integer matmul
    on CUDA), wrapped to int32."""
    nb = wire_idx.shape[0]
    _, v, d = buf.shape
    gathered = buf[wire_idx.to(I64)].to(I64)                      # [nb, T, V, d]
    lin = (coefs.to(I64)[:, :, None, None] * gathered).sum(1)
    lin[:, :, -1] += consts.to(I64)[:, None]
    flat = wrap32(lin).transpose(0, 1).reshape(v * nb, d)
    tvs_flat = tvs.repeat(v, 1)
    posts_flat = posts.repeat(v)
    if fast_keys is not None:
        from ..ops.blind_rotate import functional_bootstrap_fast
        fresh = functional_bootstrap_fast(fast_keys, flat, tvs_flat,
                                          posts_flat)
    else:
        fresh = functional_bootstrap(keys, flat, tvs_flat, posts_flat)
    # padding slots all bootstrap the zero ciphertext to the same value, so
    # the repeated dummy row in out_rows is written with equal rows
    buf[out_rows.to(I64)] = fresh.reshape(v, nb, d).transpose(0, 1)
    return buf


class CircuitExecutor:
    def __init__(self, prog: LutProgram, keys: TFHEKeys, fast_keys=None,
                 mesh=None):
        """``keys`` fix the device; ``fast_keys``: optional
        :class:`..ops.blind_rotate.FastKeys` for the fused kernels, else
        the generic path runs."""
        if not isinstance(keys, TFHEKeys):
            raise NotImplementedError(
                "only single-family TFHEKeys: the staged pipeline is not "
                "ported yet")
        if mesh is not None:
            raise NotImplementedError("multi-device execution is not "
                                      "ported yet")
        self.prog = prog
        self.keys = keys
        self.fast_keys = fast_keys
        self.params = keys.params
        self.device = keys.device
        plan = compile_program(prog, self.params)
        self.input_rows = plan.input_rows
        self.levels = plan.levels
        self.outputs = plan.outputs
        self.dummy_row = plan.dummy_row
        self.num_wires = plan.num_wires
        self.num_bootstraps = plan.num_bootstraps
        self._plan_device = None

    def plan_tensors(self) -> list[tuple[torch.Tensor, ...]]:
        """Per-level plan tensors on the device, uploaded once."""
        if self._plan_device is None:
            self._plan_device = [
                tuple(torch.from_numpy(x).to(self.device)
                      for x in (p.wire_idx, p.coefs, p.consts, p.test_polys,
                                p.posts, p.out_rows))
                for p in self.levels]
        return self._plan_device

    def encrypt_inputs(self, values: dict[str, np.ndarray],
                       rng: np.random.Generator) -> torch.Tensor:
        """The initial wire buffer [num_wires, V, kN+1]: all inputs in one
        encryption, with the JAX executor's draws."""
        v = len(next(iter(values.values()))) if values else 1
        d = self.params.big_dim + 1
        buf = torch.zeros((self.num_wires, v, d), dtype=torch.int32,
                          device=self.device)
        names = list(self.input_rows)
        if names:
            flat = np.concatenate([np.asarray(values[n], dtype=np.int64)
                                   for n in names])
            cts = lwe_encrypt(self.keys.extracted_key,
                              encode(flat, self.params),
                              self.params.glwe_noise_std, rng)
            rows = torch.tensor([self.input_rows[n] for n in names],
                                device=self.device)
            buf[rows] = cts.reshape(len(names), v, d)
        return buf

    def run(self, buf: torch.Tensor, checkpoint: str | None = None,
            checkpoint_every: int | None = None,
            checkpoint_budget: float = 0.1) -> torch.Tensor:
        """Execute all levels on a copy of ``buf``; returns the filled wire
        buffer.

        ``checkpoint``: optional ``.npz`` path.  The buffer is saved (keys
        ``buf``, ``level``, ``num_levels``, as the JAX executor saves it) and
        a matching file resumes the run after its level.
        ``checkpoint_every``: fixed level interval; default: adaptive, a
        snapshot is taken when the time spent on snapshots stays within
        ``checkpoint_budget`` of the elapsed run, priced by the last one."""
        t_run = time.time()
        spent, cost_est = 0.0, 0.0
        start = 0
        buf = buf.clone()
        if checkpoint is not None:
            try:
                with np.load(checkpoint) as z:
                    if z["num_levels"] == len(self.levels) \
                            and z["buf"].shape == tuple(buf.shape):
                        start = int(z["level"]) + 1
                        buf = torch.from_numpy(z["buf"]).to(self.device)
            except FileNotFoundError:
                pass
        plans = self.plan_tensors()
        for lv in range(start, len(self.levels)):
            buf = _level_step(self.keys, self.fast_keys, buf, *plans[lv])
            if checkpoint is None or lv + 1 >= len(self.levels):
                continue
            if checkpoint_every is not None:
                due = (lv + 1) % checkpoint_every == 0
            else:
                due = spent + cost_est < checkpoint_budget * (
                    time.time() - t_run)
            if due:
                t0 = time.time()
                np.savez(checkpoint, buf=buf.cpu().numpy(), level=lv,
                         num_levels=len(self.levels))
                cost_est = time.time() - t0
                spent += cost_est
                print(f"# checkpoint level {lv}: {cost_est:.2f}s (total "
                      f"{spent:.2f}s of {time.time() - t_run:.2f}s)",
                      file=sys.stderr)
        return buf

    def decrypt_outputs(self, buf: torch.Tensor) -> dict[str, np.ndarray]:
        """All outputs in one gather + lincomb + phase."""
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
        phases = lwe_phase(self.keys.extracted_key,
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
