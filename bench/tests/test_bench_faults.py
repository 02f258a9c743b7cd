"""With the timed path broken underneath, the rest of a run (the harness
on the CPU, past its look for a card) reports ``correct`` false: a step
that returns its state unchanged, half of the lanes left out and filled
from the rest, and an answer altered where it is produced.  (One chip:
there is no exchange between chips to leave out.)"""
import pytest
import torch

from bench_tiny import run_tiny


def _half(width):
    """Lanes of the second half take the first half's values."""
    idx = torch.arange(width)
    idx[width // 2:] = idx[:width - width // 2]

    def fn(t):
        return t[idx.to(t.device)] if t.dim() and t.shape[0] == width else t
    return fn


def _plant(monkeypatch, fault):
    from repro_torch.api import runners
    from repro_torch.core import engine
    if fault == "unchanged":
        monkeypatch.setattr(engine, "_advance",
                            lambda consts, meta, pol, ph, aux, carry,
                            max_events=None: carry)
        return
    make_sim = engine.make_packed_simulator

    def sim(meta):
        run = make_sim(meta)

        def broken(consts, pol, s0=None):
            s = run(consts, pol, s0)
            if fault == "half":
                return type(s)(*map(_half(s.time.shape[0]), s))
            # every job of every lane reports its completion 1 % later
            return s._replace(job_done_t=s.job_done_t * 1.01)
        return broken
    monkeypatch.setattr(runners, "make_packed_simulator", sim)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_makes_run_incorrect(fault, monkeypatch, fresh_caches):
    _plant(monkeypatch, fault)
    line = run_tiny(seconds=0.2, seeds=2)
    assert line["correct"] is False
    assert line["failed"] >= 1
