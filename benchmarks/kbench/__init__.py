"""The harness of the benchmark of seekr_tpu_torch (see ``benchmarks/README.md``)."""
