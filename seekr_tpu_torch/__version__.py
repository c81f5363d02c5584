__title__ = "seekr_tpu_torch"
__description__ = "PyTorch/CUDA port of seekr_tpu for NVIDIA Hopper GPUs."
__version__ = "0.1.0"
__license__ = "MIT"
