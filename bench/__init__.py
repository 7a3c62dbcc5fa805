"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

`bench/run.py` runs one cell of `BENCHMARK.json` once.  Everything that
belongs to one configuration, one traffic mix or one per-layer metric is a
file of its own under this folder, found by the name the manifest gives."""
