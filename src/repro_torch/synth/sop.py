"""Sum-of-products cover IR: the two-level synthesis result.

A :class:`SopCover` is the minimized form of one neuron's truth table —
per output bit, a list of :class:`Cube` product terms whose OR computes
that bit.  The port's copy of ``repro.synth.sop``: in the reference it
is the contract between the minimizer (``synth.minimize``), the SOP
Verilog backend (``core.verilog.generate_verilog(..., sop=True)``) and
the measured-cost model (``core.lut_cost.sop_lut_estimate``); the port
has the minimizer, and the other two wait for the Verilog slice.

A cube is an ``(mask, value)`` pair over the neuron's ``n_in`` input
bits: input word ``w`` is covered iff ``(w & mask) == value``.  Bits
outside ``mask`` are don't-cares within the cube, so the number of set
bits in ``mask`` is the cube's literal count — the quantity two-level
minimization drives down.  ``Cube(0, 0)`` covers every word (the
tautology); an output bit with *no* cubes is constant 0.

Covers are exact only on the *reachable* on-set they were extracted
from: on don't-care (unreachable) inputs a cover may legally disagree
with the source table — that freedom is where the minimization wins
come from, and why every consumer compares behavior on reachable
inputs only (network input words are always reachable by contract).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class Cube(NamedTuple):
    """One product term over ``n_in`` input bits.

    ``mask`` selects the cared-about bits, ``value`` their required
    values (``value & ~mask == 0`` always).  Examples:

    >>> c = Cube(mask=0b101, value=0b001)       # M0[0] & ~M0[2]
    >>> c.covers(0b001), c.covers(0b011), c.covers(0b100)
    (True, True, False)
    >>> c.n_literals
    2
    >>> Cube(0, 0).covers(0b111)                # tautology covers all
    True
    """

    mask: int
    value: int

    def covers(self, word: int) -> bool:
        return (word & self.mask) == self.value

    @property
    def n_literals(self) -> int:
        return int(self.mask).bit_count()

    def literals(self) -> list[tuple[int, bool]]:
        """``(input bit position, positive?)`` per literal, LSB first."""
        out = []
        mask, value = int(self.mask), int(self.value)
        pos = 0
        while mask:
            if mask & 1:
                out.append((pos, bool(value & 1)))
            mask >>= 1
            value >>= 1
            pos += 1
        return out


@dataclasses.dataclass(frozen=True)
class SopCover:
    """Minimized two-level cover of one neuron: per-output-bit cube lists.

    ``bits[b]`` is the tuple of cubes whose OR computes output bit ``b``
    (LSB first).  Empty tuple = constant 0; a tuple containing the
    tautology cube ``Cube(0, 0)`` = constant 1.

    >>> cover = SopCover(n_in=2, out_bits=1,
    ...                  bits=((Cube(0b01, 0b01), Cube(0b10, 0b00)),))
    >>> [cover.evaluate_word(w) for w in range(4)]   # M0[0] | ~M0[1]
    [1, 1, 0, 1]
    >>> cover.n_terms, cover.n_literals
    (2, 2)
    """

    n_in: int
    out_bits: int
    bits: tuple[tuple[Cube, ...], ...]

    def __post_init__(self) -> None:
        if len(self.bits) != self.out_bits:
            raise ValueError(
                f"cover has {len(self.bits)} bit covers for "
                f"{self.out_bits} output bits")

    @property
    def n_terms(self) -> int:
        """Total product terms across all output bits."""
        return sum(len(cubes) for cubes in self.bits)

    @property
    def n_literals(self) -> int:
        """Total literal count — the two-level minimization objective."""
        return sum(c.n_literals for cubes in self.bits for c in cubes)

    def bit_support(self, b: int) -> tuple[int, ...]:
        """Input bit positions output bit ``b`` actually depends on."""
        mask = 0
        for c in self.bits[b]:
            mask |= int(c.mask)
        return tuple(i for i in range(self.n_in) if mask >> i & 1)

    def evaluate(self, entries) -> np.ndarray:
        """Vectorized evaluation: entry words -> output codes (int64).

        >>> cover = SopCover(1, 1, bits=((Cube(1, 0),),))    # ~M0[0]
        >>> cover.evaluate(np.arange(2)).tolist()
        [1, 0]
        """
        entries = np.asarray(entries, dtype=np.int64)
        out = np.zeros(entries.shape, dtype=np.int64)
        for b, cubes in enumerate(self.bits):
            hit = np.zeros(entries.shape, dtype=bool)
            for c in cubes:
                hit |= (entries & int(c.mask)) == int(c.value)
            out |= hit.astype(np.int64) << b
        return out

    def evaluate_word(self, word: int) -> int:
        """Scalar evaluation of one input word."""
        return int(self.evaluate(np.asarray([word]))[0])

    def table(self) -> np.ndarray:
        """The full ``2^n_in``-entry truth table this cover computes."""
        return self.evaluate(np.arange(1 << self.n_in))


__all__ = ["Cube", "SopCover"]
