"""L0 ops: FIR resampling, fused bias+activation, modulated conv, and the
Hopper kernels behind them (``ops/kernels.py``)."""

from portbench.reference.frozen.ops.fused_act import fused_leaky_relu, scaled_leaky_relu
from portbench.reference.frozen.ops.modulated_conv import modulated_conv2d
from portbench.reference.frozen.ops.upfirdn2d import blur, downsample_2x, make_kernel, upsample_2x

__all__ = [
    "blur",
    "downsample_2x",
    "fused_leaky_relu",
    "make_kernel",
    "modulated_conv2d",
    "scaled_leaky_relu",
    "upsample_2x",
]
