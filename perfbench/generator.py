"""The one traffic generator: the streams of programs and operands that
a mix file (`traffic/<mix>.json`) and the seed make.  The loop that
sends them is the mix's `kind`, a file of its own (`traffic/<kind>.py`).

Programs are dealt from a deck that holds the mix's integer weights
exactly, so every seed gets the same work in another order.  The
streams are pure functions of (seed, labels), as in the port's
`sim.arrivals` (whose `seeded_rng` this copies).
"""
from __future__ import annotations

import hashlib
import random


def seeded_rng(*parts) -> random.Random:
    """A `random.Random` seeded from a stable digest of `parts` (Python's
    own string hash is salted per process)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def deck(mix: dict) -> list:
    """Program names, each as often as its integer weight."""
    out = []
    for name, weight in sorted(mix.items()):
        if weight != int(weight) or weight < 0:
            raise ValueError(f"mix weights are whole numbers: {name}={weight}")
        out += [name] * int(weight)
    return out


def client_programs(traffic: dict, client: int, count: int, seed: int) -> list:
    """A closed-loop client's first `count` programs: its own shuffle of
    the deck, cycled."""
    cards = deck(traffic["mix"])
    seeded_rng("client-deck", seed, client).shuffle(cards)
    start = seeded_rng("client-start", seed, client).randrange(len(cards))
    return [cards[(start + j) % len(cards)] for j in range(count)]
