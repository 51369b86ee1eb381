"""Throughput probes of the port: the rollout kernels' valid rollouts per
second (``throughput``), the card's calibration chains and the kernels'
roofline shares (``roofline``), and the device-time helpers they share
with chip_smoke.py (``timing``). Counterparts of bench.py's
``measure_prop_throughput``, tools/r4_cull_bench.py and tools/roofline.py.
"""
