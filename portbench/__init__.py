"""The benchmark of the port (``loro_tpu_torch``): ``run.py`` is its one
command, ``BENCHMARK.json`` at the checkout's root its cells and metrics.
Nothing here imports JAX or the JAX package."""
