"""The plain reference that decides ``correct``: the simulator's semantics
written again from the paper (BigDataSDNSim, arXiv 1910.04517: Fig. 9,
Tables 2-3, Eqs. 1-9) and the simulator's documented rules, as a
sequential NumPy event loop, one policy lane at a time.

It imports nothing of the program, runs on the CPU, and takes nothing the
program made: it builds its own fabric (``fabric``), its own candidate
routes (breadth-first hop counts, every shortest route enumerated and
ordered), its own jobs, tasks and packets and its own final states and
reports (``sim``), from the plain numbers of the benchmark's generator.
"""
