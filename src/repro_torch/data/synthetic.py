"""Deterministic synthetic LM data (the JAX package's ``data/synthetic.py``):
an order-1 Markov chain over the vocabulary with a sparse successor table
fixed by the seed.  Draws go through the threefry twin, so the same seed
and step give the same tokens as the JAX package.  ``make_batch`` puts one
global batch on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import prng


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 8  # successors per token

    def _table(self) -> np.ndarray:
        """(V, branching) successor table, fixed by seed."""
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab_size, size=(self.vocab_size, self.branching))

    def sample(self, step: int, batch: int | None = None, seq: int | None = None,
               device="cpu"):
        """(tokens, labels) of shape (batch, seq) for `step`:
        tokens[t+1] ~ Uniform(table[tokens[t]]), labels = next token."""
        b = batch or self.global_batch
        s = seq or self.seq_len
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        k0, kc = prng.split(key)
        x0 = prng.randint(k0, (b,), 0, self.vocab_size)
        choices = prng.randint(kc, (b, s), 0, self.branching)
        tab = torch.from_numpy(self._table())
        seq_toks = torch.empty((b, s), dtype=torch.int64)
        tok = x0
        for t in range(s):
            tok = tab[tok, choices[:, t]]
            seq_toks[:, t] = tok
        tokens = torch.cat([x0[:, None], seq_toks[:, :-1]], dim=1)
        return tokens.to(device), seq_toks.to(device)

    def bigram_entropy(self) -> float:
        """Bayes cross-entropy floor (nats/token) of the generating chain,
        averaged over the first 1024 rows of the table."""
        rows = self._table()[: min(1024, self.vocab_size)]
        ent = 0.0
        for row in rows:
            _, counts = np.unique(row, return_counts=True)
            p = counts / counts.sum()
            ent += float(-(p * np.log(p)).sum())
        return ent / len(rows)


def make_batch(data: SyntheticLM, step: int, device="cpu") -> dict:
    """One global batch {"tokens", "labels"} (B, S) int64 on `device`."""
    tokens, labels = data.sample(step, device=device)
    return {"tokens": tokens, "labels": labels}
