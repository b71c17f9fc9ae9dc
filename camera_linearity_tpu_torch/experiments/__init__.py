"""The config-2 kernel experiments, ported from ``benchmarks/exp_kernel.py``,
``benchmarks/exp_plateau.py``, ``benchmarks/exp_manual_pipeline.py`` and
``benchmarks/exp_int8_planes.py``: ablations and variants that time the
merge's bytes, its arithmetic, its table lookup, its load pattern and its
table form apart, on the card.

    python -m camera_linearity_tpu_torch.experiments.exp_kernel dma math
    python -m camera_linearity_tpu_torch.experiments.exp_plateau xla dma
    python -m camera_linearity_tpu_torch.experiments.exp_manual_pipeline
    python -m camera_linearity_tpu_torch.experiments.exp_int8_planes

Their kernels are in ``ops/ablation_cuda.py`` (E1-E5) and
``ops/lut_merge_cuda.py`` (E6, E7); the modules here make the data, time
the calls with CUDA events and print the JAX scripts' lines.
``--device cpu`` runs them on the CPU through the plain versions, untimed.
"""
