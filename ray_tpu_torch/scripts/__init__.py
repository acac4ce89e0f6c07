"""The port's scripts: the CLI (cli.py, run as ``python -m ray_tpu_torch``)
and its microbenchmark, the analysis gate, the storms and the soaks, at the
reference's paths; and the port's own measurement scripts (profile_*.py,
probe_collectives.py, check_attention_sm90.py, dryrun_multichip.py), which
need a CUDA device."""
