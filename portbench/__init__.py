"""portbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload zamba2-train --seed 7 --seconds 40 --trace 0

Everything a cell needs is found by name: its configuration in
``configs/<config>.json`` (with its plain reference in ``reference/``), its
traffic in ``traffic/<mix>.json`` (read by the runner of the mix's kind in
``kinds/``), each metric's reader in ``metrics/<metric>.py``, the limits of
its correctness check in ``limits/<cell>.json``.  The least-work counts and
the model-FLOP counts (``work/``), the kernel-name groups (``groups/``), the
H100's peaks and the reference are frozen here, so that a change to the
program cannot move the yardstick.
"""
