"""The config-2 kernel experiments, ported from ``benchmarks/exp_kernel.py``
and ``benchmarks/exp_plateau.py``: ablations that time the merge's bytes,
its arithmetic and its table lookup apart, on the card.

    python -m camera_linearity_tpu_torch.experiments.exp_kernel dma math
    python -m camera_linearity_tpu_torch.experiments.exp_plateau xla dma

Their kernels (E1-E5) are in ``ops/ablation_cuda.py``; the modules here
make the data, time the calls with CUDA events and print the JAX scripts'
lines.  ``--device cpu`` runs them on the CPU through the plain versions,
untimed.
"""
