"""The comparison that decides ``correct``: a wire buffer the program
returned, decrypted with the secret the benchmark drew, against the
plaintext evaluation of the same program on the same input bits.

Two numbers come out of it, each summed over batches by :class:`Tally`:

* ``wrong_bits``: output bits whose decryption differs from the plaintext
  evaluation (limit 0: the configuration's guarantee is exact evaluation);
* ``noise_rms``: the root mean square of every bootstrapped wire's noise,
  as a share of the half message step.  It is steady from seed to seed and
  grows when the bootstrap is computed with less precision than the
  configuration states (a key with fewer limbs), well before a bit flips.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .lbf import Program
from .lwe import Q, decode, delta, phases

__all__ = ["Tally", "judge"]


@dataclass
class Tally:
    evaluations: int = 0
    failed: int = 0
    wrong_bits: int = 0
    noise_sq: float = 0.0
    noise_n: int = 0
    bad_buffers: int = 0          # buffers not of the program's shape

    @property
    def noise_rms(self) -> float:
        return (self.noise_sq / self.noise_n) ** 0.5 if self.noise_n else 0.0


def judge(prog: Program, p: int, key: np.ndarray, inputs: dict,
          buf: np.ndarray, tally: Tally) -> None:
    """Add one batch to ``tally``: ``buf`` [rows + 1, V, d + 1] as the
    program returned it, ``inputs`` name -> V input bits, ``key`` the
    binary secret [d] under which the wires are encrypted."""
    rows = prog.rows()
    v = len(next(iter(inputs.values())))
    want_shape = (len(rows) + 1, v, key.shape[0] + 1)
    tally.evaluations += v
    if tuple(buf.shape) != want_shape:
        tally.bad_buffers += 1
        tally.failed += v
        tally.wrong_bits += v * len(prog.outputs)
        return
    order = sorted(rows, key=rows.get)
    ph = phases(buf[:len(order)], key)                  # [rows, V]
    boots = [rows[i] for i in order if prog.nodes[i].kind == "boot"]
    _, noise = decode(ph[boots], p)
    tally.noise_sq += float(np.sum(noise * noise))
    tally.noise_n += noise.size

    vals = prog.evaluate(inputs)
    bad = np.zeros(v, dtype=bool)
    dl = delta(p)
    for kind, x in prog.outputs.values():
        if kind == "const":
            continue
        node = prog.nodes[x]
        if node.kind == "lin":
            phase = np.int64(node.const * dl)
            for c, j in node.terms:
                phase = phase + c * ph[rows[j]]
            phase = np.asarray(phase % Q)
        else:
            phase = ph[rows[x]]
        got, _ = decode(phase, p)
        wrong = got != np.asarray(vals[x]) % (2 * p)
        tally.wrong_bits += int(np.sum(wrong))
        bad |= wrong
    tally.failed += int(np.sum(bad))
