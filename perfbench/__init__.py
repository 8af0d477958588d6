"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: the
configuration in ``configs/<config>.json`` (which names its system,
``systems/<system>.py``, and its plain reference,
``reference/<reference>.py``), the traffic mix in ``traffic/<mix>.json``
(which names its arrival process, ``loops/<loop>.py``) and each metric's
reader in ``metrics/<metric>.py`` (or ``metrics/<part before the first
dot>.py``).
"""
