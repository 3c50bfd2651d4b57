"""The benchmark of the PyTorch and CUDA port (`ntm_tracker_tpu_torch`).

One command runs one cell of `BENCHMARK.json` once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json` (whose "kind" names the runner
`kinds/<kind>.py`), `limits/<workload>.json` and `metrics/<metric>.py`.
The plain reference that decides `correct` is `reference/`; the analytic
counts and the card's peaks are `counts.py`. Nothing here imports JAX or
the JAX package.
"""
