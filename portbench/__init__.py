"""The benchmark of the PyTorch/CUDA port (`vox_serve_tpu_torch`): one
run of one cell is `python3 -m portbench.run` (see `run.py`); what it runs
is named in `BENCHMARK.json` at the repository root."""
