"""Deterministic synthetic LM data pipeline and its MapReduce twin: port
of ``src/repro/data/pipeline.py`` (numpy, as the reference).

``TokenPipeline`` yields {tokens, labels} batches where every token is a
counter-based hash of (seed, row, position): no state beyond the step
counter, so a restart reproduces the exact stream on any number of hosts
(the shard assignment is a pure function of (step, host)).

``pipeline_jobs`` renders the same pipeline as the paper's MapReduce DAG
(shard read = map, global shuffle = mapper-to-reducer transfer, batch
assembly = reduce), so the DES can predict ingest throughput on a fabric.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

from ..core.mapreduce import JobSpec


def _hash_u32(x: np.ndarray) -> np.ndarray:
    x = (x ^ 61) ^ (x >> 16)
    x = (x + (x << 3)) & 0xFFFFFFFF
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & 0xFFFFFFFF
    return x ^ (x >> 15)


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int              # per-host batch
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    step: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """A pure function of ``step``: the restart contract."""
        b, s = self.batch, self.seq
        rows = (np.arange(b, dtype=np.uint64)
                + np.uint64(step) * np.uint64(b * self.n_hosts)
                + np.uint64(self.host_id * b))
        pos = np.arange(s + 1, dtype=np.uint64)
        base = (rows[:, None] * np.uint64(1_000_003) + pos[None, :]
                + np.uint64(self.seed) * np.uint64(0x9E3779B9))
        toks = (_hash_u32(base.astype(np.uint32).astype(np.uint64)
                          .astype(np.uint32)) % np.uint32(self.vocab)
                ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


def pipeline_jobs(*, n_shards: int, shard_gbits: float, n_reducers: int,
                  read_mi: float = 1e3, assemble_mi: float = 1e3,
                  shuffle_fraction: float = 1.0,
                  submit_time: float = 0.0) -> List[JobSpec]:
    """The ingest pipeline as one MapReduce job for the DES: map =
    decompress and tokenise a shard, shuffle = re-shard to the
    data-parallel consumers, reduce = batch assembly."""
    total = n_shards * shard_gbits
    return [JobSpec(
        submit_time=submit_time, n_map=n_shards, n_reduce=n_reducers,
        map_mi=read_mi, reduce_mi=assemble_mi,
        input_gbits=total, shuffle_gbits=total * shuffle_fraction,
        output_gbits=total * shuffle_fraction)]
