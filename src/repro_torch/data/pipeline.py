"""Deterministic synthetic token pipeline — port of `repro.data.pipeline`.

Seeded and stateless: batch i is a pure function of (seed, i), drawn with
numpy exactly as the reference draws it, so the tokens are bitwise the
reference's.  The token stream is a Zipf-ish unigram mixture with a Markov
bigram component, so cross entropy is learnable (the loss visibly falls)
rather than uniform noise.  `make_batch_iterator` yields torch tensors on a
device (the CUDA device unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import device as _device


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # active vocab head
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.probs = (ranks ** -self.zipf_a)
        self.probs /= self.probs.sum()
        self.active_vocab = v
        # deterministic "grammar": each token has a preferred successor
        self.successor = rng.integers(0, v, size=v)

    def batch(self, i: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, i))
        B, S = self.global_batch, self.seq_len
        base = rng.choice(self.active_vocab, size=(B, S), p=self.probs)
        # with prob 0.5, token t+1 = successor(token t) → learnable bigrams
        follow = rng.random((B, S)) < 0.5
        out = base.copy()
        for s in range(1, S):
            out[:, s] = np.where(follow[:, s], self.successor[out[:, s - 1]],
                                 base[:, s])
        return out.astype(np.int32)


def make_batch_iterator(
    vocab_size: int,
    seq_len: int,
    global_batch: int,
    seed: int = 0,
    extras: Optional[Dict[str, tuple]] = None,
    dtype=torch.bfloat16,
    *,
    device=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches ``{"tokens": (global_batch, seq_len) int32, **extras}``: each
    extra a standard normal draw of its shape from numpy's generator seeded
    ``seed + 1`` (one generator for the whole stream, as the reference's),
    cast to `dtype` and scaled by 0.02 in that type."""
    dev = _device.resolve(device)
    gen = SyntheticTokens(vocab_size, seq_len, global_batch, seed)
    i = 0
    rng = np.random.default_rng(seed + 1)
    while True:
        b: Dict[str, torch.Tensor] = {"tokens": torch.as_tensor(gen.batch(i), device=dev)}
        for name, shape in (extras or {}).items():
            # 0.02 in `dtype` itself, as the reference's weakly typed scalar is
            b[name] = (torch.as_tensor(rng.standard_normal(shape)).to(dev).to(dtype)
                       * torch.tensor(0.02, dtype=dtype, device=dev))
        yield b
        i += 1
