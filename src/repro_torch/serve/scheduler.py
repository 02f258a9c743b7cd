"""Continuous-batching serve loop (single-host): port of
``src/repro/serve/scheduler.py``.

Requests enter a FIFO; a fixed pool of B slots holds active sequences.
Each tick: (1) free slots are refilled by prefilling queued prompts into
the slot's cache rows, (2) one decode step advances every slot, idle ones
included, (3) finished rows (EOS or budget) are emitted.  Admission,
bucketing, the left padding with token 0, the splice of a fresh one-row
cache into the slot (every cache tensor of two or more dims at
``[:, slot]``, a one-dim tensor at ``[slot]``, through nested dicts as the
reference's ``tree_map``, whatever the family) and the stop rule are the
reference's.  The reference jits the decode step and one prefill per
bucket; the port runs eagerly.  ``backend`` goes to the model's prefill
and decode step: for the dense and moe families it is the prefill's
attention (the decode step attends over the cache by its one-token path);
for the ssm family it is the scan of both, and for the hybrid family both
of these.  ``"kernel"`` is the CUDA kernel on the card and its plain
version on the CPU.

Host syncs: a tick waits for the device once, to copy its argmax back, and
an admission once more, for its first token; on CUDA the token and prompt
uploads are staged through pinned memory and copied without waiting.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List

import numpy as np
import torch

from ..device import resolve
from ..models.registry import ModelApi


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new: int = 16
    eos_id: int = -2            # -2: never (synthetic workloads)


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]           # the prefill's argmax, then one per step
    prefill_len: int
    decode_steps: int


def _splice(full: dict, row: dict, slot: int) -> None:
    """Write the one-row cache ``row`` into ``full``'s ``slot``, in place,
    leaf by leaf through nested dicts."""
    for name, leaf in full.items():
        if isinstance(leaf, dict):
            _splice(leaf, row[name], slot)
        elif leaf.dim() >= 2:
            leaf[:, slot:slot + 1] = row[name]
        else:
            leaf[slot] = row[name][0]


class ServeLoop:
    def __init__(self, api: ModelApi, params, *, slots: int = 4,
                 max_len: int = 256, bucket: int = 32,
                 backend: str = "kernel", device=None):
        self.device = resolve(device)
        for name, p in params.named_parameters():
            if p.device.type != self.device.type:
                raise ValueError(f"parameter {name} is on {p.device}, the "
                                 f"loop runs on {self.device}")
        self.api = api
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.bucket = bucket
        self.backend = backend
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, dict] = {}          # slot -> request state
        self.free = list(range(slots))
        self.cache = api.init_cache(slots, max_len, device=self.device)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the loop's device, without waiting for it on
        CUDA (the pinned staging buffer lives until its copy is done)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def _bucketed(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _admit(self):
        while self.free and self.queue:
            slot = self.free.pop()
            req = self.queue.popleft()
            plen = self._bucketed(len(req.prompt))
            prompt = np.full((plen,), 0, np.int32)
            prompt[-len(req.prompt):] = req.prompt
            # per-slot prefill into a fresh single-row cache, then splice
            row = self.api.init_cache(1, self.max_len, device=self.device)
            tokens = self._upload(prompt[None])
            logits, row = self.api.prefill(self.params, {"tokens": tokens},
                                           row, backend=self.backend)
            _splice(self.cache, row, slot)
            tok = int(torch.argmax(logits[0, -1]))
            self.active[slot] = {"req": req, "tokens": [tok], "steps": 0,
                                 "plen": plen}

    # -- one tick ----------------------------------------------------------
    def tick(self) -> List[Result]:
        self._admit()
        if not self.active:
            return []
        tokens = np.zeros((self.slots, 1), np.int32)
        for slot, st in self.active.items():
            tokens[slot, 0] = st["tokens"][-1]
        logits, self.cache = self.api.decode_step(
            self.params, self._upload(tokens), self.cache,
            backend=self.backend)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        done: List[Result] = []
        for slot in list(self.active):
            st = self.active[slot]
            st["steps"] += 1
            st["tokens"].append(int(nxt[slot]))
            req = st["req"]
            if (st["steps"] >= req.max_new
                    or int(nxt[slot]) == req.eos_id):
                done.append(Result(req.rid, st["tokens"], st["plen"],
                                   st["steps"]))
                del self.active[slot]
                self.free.append(slot)
        return done

    def run(self, until_empty: bool = True, max_ticks: int = 10_000
            ) -> List[Result]:
        """Tick until the queue and the slots are empty or ``max_ticks``
        ran.  ``until_empty`` is accepted and ignored, as the reference
        does."""
        out: List[Result] = []
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            out.extend(self.tick())
            ticks += 1
        return out
