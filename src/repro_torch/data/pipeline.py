"""Deterministic token pipelines.

``SyntheticTokens`` — stateless per-step PRNG batches (any step is
reconstructable, which the fault-tolerance tests rely on: a restarted run
re-reads exactly the batches it would have seen).

``FileTokens`` — the paper's §5 file IO as a data source: every batch maps
a *disjoint chunk* of the token file into a data block via
``ocrFileGetChunk`` (read-only acquire ⇒ no write-back), going through the
core runtime rather than raw ``fopen`` — no side effects outside the
runtime, per the paper's resilience argument.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core import DbMode, NULL_GUID, Runtime, spawn_main


def make_batch(tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """tokens (B, S+1) -> {"tokens": (B,S), "targets": (B,S)}."""
    return {"tokens": tokens[:, :-1].astype(np.int32),
            "targets": tokens[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class SyntheticTokens:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    mode: str = "uniform"            # uniform | markov (learnable bigrams)

    def get(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.PCG64(
            (self.seed << 32) ^ (step + 1)))
        if self.mode == "uniform":
            toks = rng.integers(0, self.vocab_size,
                                size=(self.batch, self.seq + 1),
                                dtype=np.int64)
        else:
            # deterministic affine bigram chain + 10% noise: learnable
            v = self.vocab_size
            toks = np.empty((self.batch, self.seq + 1), dtype=np.int64)
            toks[:, 0] = rng.integers(0, v, size=self.batch)
            noise = rng.random((self.batch, self.seq)) < 0.1
            rand = rng.integers(0, v, size=(self.batch, self.seq))
            for i in range(self.seq):
                nxt = (toks[:, i] * 31 + 7) % v
                toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
        return make_batch(toks)


class FileTokens:
    """Token file (int32 little-endian) read through §5 file-mapped chunks."""

    def __init__(self, path: str, vocab_size: int, batch: int, seq: int,
                 num_nodes: int = 2):
        self.path = path
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq = seq
        self.num_nodes = num_nodes
        self._bytes_per_batch = batch * (seq + 1) * 4
        self.total_tokens: Optional[int] = None

    def num_batches(self) -> int:
        import os
        return os.path.getsize(self.path) // self._bytes_per_batch

    def get(self, step: int) -> Dict[str, np.ndarray]:
        """Read batch ``step`` (mod file size) via a read-only chunk."""
        n = max(self.num_batches(), 1)
        offset = (step % n) * self._bytes_per_batch
        out: Dict[str, np.ndarray] = {}
        rt = Runtime(num_nodes=self.num_nodes)

        grabbed = {}

        def reader(paramv, depv, api):
            data = depv[0].ptr
            toks = np.frombuffer(bytes(data), dtype=np.int32).reshape(
                self.batch, self.seq + 1)
            grabbed["tokens"] = toks.copy()
            api.db_destroy(depv[0].guid)
            return NULL_GUID

        def main(paramv, depv, api):
            fg, desc = api.file_open(self.path, "rb")

            def after_open(pv, dv, api2):
                f = api2.file_get_guid(dv[0].ptr)
                chunk = api2.file_get_chunk(f, offset, self._bytes_per_batch)
                api2.file_release(f)
                api2.db_destroy(dv[0].guid)
                tmpl2 = api2.edt_template_create(reader, 0, 1)
                api2.edt_create(tmpl2, depv=[chunk], dep_modes=[DbMode.RO])
                return NULL_GUID

            tmpl = api.edt_template_create(after_open, 0, 1)
            api.edt_create(tmpl, depv=[desc])
            return NULL_GUID

        spawn_main(rt, main)
        rt.run()
        toks = grabbed["tokens"] % self.vocab_size
        return make_batch(toks)


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.int32).tofile(path)
