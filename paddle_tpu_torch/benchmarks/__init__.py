"""The port's benches: ``lm`` (``bench_lm.py``'s measured path,
``python -m paddle_tpu_torch.benchmarks.lm``) and ``common`` (the shared
card check, watchdog and failure line)."""
