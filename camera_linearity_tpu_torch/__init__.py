"""camera_linearity_tpu_torch — the PyTorch / CUDA port of
``camera_linearity_tpu`` for NVIDIA Hopper GPUs.

The module layout mirrors the JAX package: each port module sits where its
counterpart is.  Plain tensor code is PyTorch: the statistics, the
linearity analysis and the ICRF calibration among it.  The three Pallas
merge kernels of ``camera_linearity_tpu/ops/hdr_pallas2.py`` are
hand-written CUDA (``csrc/hdr_merge.cu``), built with ``nvcc`` on first
use.  The package never imports JAX: the JAX package is the reference its
tests hold it to.
"""
from .config import CameraConfig, DEFAULT_CONFIG  # noqa: F401
from .measurand import Measurand  # noqa: F401

__version__ = "0.1.0"
