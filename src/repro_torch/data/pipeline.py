"""Deterministic, resumable synthetic LM data: the port of
`repro.data.pipeline`.

Every batch is a pure function of (seed, step), so any worker can
regenerate any batch: the property restarts need (no data state is
checkpointed beyond the step counter).  It is drawn on the CPU from a
`torch.Generator` seeded from both, then moved to the caller's device,
so the card and the CPU see the same batches.  `jax.random` streams
cannot be reproduced, so the batches are not the reference's; the
distribution is.

The token stream is a mixture of Zipf-distributed unigrams and short
motifs, giving a non-degenerate loss curve (a pure-uniform stream has
constant CE and hides training bugs).  The motif table comes from
numpy's `default_rng(seed)`, as in the reference, and equals its table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLMData:
    """batch(step) -> {"tokens", "labels"} (next-token LM pairs, int32)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Zipf unigram table (clipped to vocab)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._probs = torch.tensor(p / p.sum(), dtype=torch.float32)
        self._motifs = torch.tensor(
            rng.integers(0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len)), dtype=torch.int32)

    def _generator(self, step: int) -> torch.Generator:
        """The CPU generator of batch `step`: seeded from (seed, step)."""
        seed = np.random.SeedSequence([self.cfg.seed, step]).generate_state(1, np.uint64)[0]
        return torch.Generator().manual_seed(int(seed))

    def batch(self, step: int, device=None) -> dict:
        """Batch `step` on `device` (the card unless given one)."""
        cfg = self.cfg
        device = resolve_device(device)
        g = self._generator(step)
        B, S = cfg.global_batch, cfg.seq_len
        toks = torch.multinomial(self._probs, B * (S + 1), replacement=True,
                                 generator=g).to(torch.int32).reshape(B, S + 1)
        # overwrite random windows with motifs (learnable structure), in
        # order: a later window overwrites an earlier one where they overlap
        n_inj = max(1, S // (4 * cfg.motif_len))
        starts = torch.randint(0, max(S - cfg.motif_len, 1), (B, n_inj), generator=g)
        which = torch.randint(0, cfg.n_motifs, (B, n_inj), generator=g)
        for b in range(B):
            for s, w in zip(starts[b].tolist(), which[b].tolist()):
                toks[b, s:s + cfg.motif_len] = self._motifs[w]
        return {"tokens": toks[:, :-1].contiguous().to(device),
                "labels": toks[:, 1:].contiguous().to(device)}
