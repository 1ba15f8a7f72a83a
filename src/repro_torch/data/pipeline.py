"""Deterministic, resumable synthetic token pipeline (a copy of
``repro.data.pipeline``: numpy, batches bit for bit the reference's).

Every batch is a pure function of (seed, step, host_slice): restart at step k
reproduces the exact stream (fault-tolerance requirement — no cursor files to
lose).  At multi-host scale each host materializes only its slice of the
global batch; in-container there is one host and the slice is everything.

The token stream is a mixture of Zipf-distributed unigrams and short
repeated motifs, which gives a learnable (loss goes below uniform) yet
tokenizer-free workload for the end-to-end examples.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    motif_prob: float = 0.5

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        return self.global_batch // self.n_hosts

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        B, S = self.host_batch, self.seq_len
        # Zipf unigrams, clipped to vocab (rejection-free)
        base = rng.zipf(self.zipf_a, size=(B, S + 1)) % self.vocab
        # inject repeated motifs: positions copy a motif drawn per row
        motif = rng.integers(0, self.vocab, size=(B, self.motif_len))
        for b in range(B):
            n_spans = int(S * self.motif_prob / self.motif_len)
            starts = rng.integers(0, S - self.motif_len, size=n_spans)
            for s in starts:
                base[b, s : s + self.motif_len] = motif[b]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}


def make_batch(cfg, shape_spec, step: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Batch for a ModelConfig x ShapeSpec cell (training kinds only)."""
    ds = SyntheticTokens(
        vocab=cfg.vocab,
        seq_len=shape_spec.seq_len,
        global_batch=shape_spec.global_batch,
        seed=seed,
    )
    return ds.batch(step)
