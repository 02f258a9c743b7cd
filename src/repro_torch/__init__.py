"""BigDataSDNSim reproduction in PyTorch, with hand-written CUDA kernels.

The port of the JAX package ``repro`` (which stays the reference).  It
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``:

    from repro_torch.api import Experiment, PolicyConfig
    Experiment("paper-fabric", [PolicyConfig(routing=1)]).run()
"""
