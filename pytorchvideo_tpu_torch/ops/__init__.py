"""Kernels of the port, each beside its plain PyTorch version.

The package exports the JAX package's names: ``ops.pooled_attention`` is the
attention function, as there, so the module of that name is reached by
``from pytorchvideo_tpu_torch.ops.pooled_attention import ...`` or
``importlib.import_module``.

Each kernel wrapper (``*_cuda``) counts its launches in its ``launches``
attribute: :func:`kernel_wrappers` names them, :func:`launch_counts` reads
them."""

import importlib

from pytorchvideo_tpu_torch.ops.depthwise_conv import (  # noqa: F401
    depthwise3x3x3_bn_swish,
    depthwise3x3x3_bn_swish_cuda,
    depthwise3x3x3_bn_swish_torch,
)
from pytorchvideo_tpu_torch.ops.pooled_attention import (  # noqa: F401
    pooled_attention,
    pooled_attention_packed,
)
from pytorchvideo_tpu_torch.ops.roi_align import RoIAlign, roi_align  # noqa: F401
from pytorchvideo_tpu_torch.ops.token_pool import (  # noqa: F401
    avg_token_pool,
    depthwise_token_pool,
    max_token_pool,
)


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its count is read under."""
    from pytorchvideo_tpu_torch.ops import depthwise_conv as dw
    from pytorchvideo_tpu_torch.ops import fused_kvpool_attention as fk
    from pytorchvideo_tpu_torch.ops import token_pool as tp

    pa = importlib.import_module("pytorchvideo_tpu_torch.ops.pooled_attention")
    return {
        "depthwise3x3x3_bn_swish": dw.depthwise3x3x3_bn_swish_cuda,
        "fused_kvpool_attention": fk.fused_kvpool_attention_cuda,
        "pooled_attention_packed": pa.pooled_attention_packed_cuda,
        "pooled_attention": pa.pooled_attention_cuda,
        "token_pool_conv": tp.depthwise_token_pool_cuda,
        "token_pool_max": tp.max_token_pool_cuda,
        "token_pool_avg": tp.avg_token_pool_cuda,
        "pooled_attention_packed_bwd": pa.pooled_attention_packed_bwd_cuda,
        "pooled_attention_bwd": pa.pooled_attention_bwd_cuda,
        "token_pool_dx": tp.depthwise_token_pool_dx_cuda,
        "token_pool_dw": tp.depthwise_token_pool_dw_cuda,
    }


def launch_counts() -> dict:
    """{kernel name: launches so far} over :func:`kernel_wrappers`."""
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}


def launches_since(before: dict) -> dict:
    """{kernel name: launches made since ``before`` (a :func:`launch_counts`)},
    the kernels that launched only."""
    now = launch_counts()
    return {name: n - before[name] for name, n in now.items() if n != before[name]}
