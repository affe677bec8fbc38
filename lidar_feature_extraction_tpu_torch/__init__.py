"""PyTorch + CUDA port of the LiDAR feature-extraction SLAM engine.

Counterpart of ``lidar_feature_extraction_tpu`` (the JAX reference, which
stays beside it): the same layout (``core/``, ``ops/``, ``pipeline/``) and
names, on torch tensors. Plain tensor code is PyTorch; the reference's
Pallas kernel is a hand-written CUDA kernel (``ops/extraction_cuda.py``,
``csrc/extraction_k1.cu``), built with ``nvcc`` at first use.

This package imports neither JAX nor the reference package.
"""

__version__ = "0.1.0"

from lidar_feature_extraction_tpu_torch.config import (  # noqa: F401
    ExtractionConfig,
    RegistrationConfig,
    EkfConfig,
    MappingConfig,
    PipelineConfig,
)
