"""The benchmark of nllstpu_torch: time to a solved problem on one card.

``run.py`` is the entry; ``harness.py`` drives a cell from the names in
``BENCHMARK.json``; ``kinds/`` holds what a kind of configuration needs
(building the problem, its solves, judging them against ``reference/``);
``configs/`` and ``traffic/`` are data; ``metrics/`` holds one reader per
metric; ``roofline.py`` and ``trace.py`` are the yardstick's arithmetic.
"""
