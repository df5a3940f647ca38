"""Hand-written Hopper kernels for the PoseNet encoder layers.

- transformer_layer: the f32 layer (replaces the TPU kernel _layer_kernel),
  `gemm_f32` and `attention_f32`, and `posenet_apply_fused`
- transformer_layer_bf16: the bf16 layer (replaces _layer_kernel_bf16) and
  `gemm_bf16`
- transformer_layer_int8: the W8A8 layer (replaces _layer_kernel_int8,
  qattn=False and True), `quant_rows_int8`, `gemm_int8` and `attention_int8`,
  and the whole int8 stack in one launch, `fused_encoder_stack_int8`
  (replaces _mega_kernel_int8)
- kernel_common: `attention_bf16` and `residual_layernorm`, shared

CUDA sources are in csrc/, built by _build.py at the first launch.
"""

from rohm_tpu_torch.ops.transformer_layer import (
    embed_cond_f32,
    fused_encoder_layer,
    posenet_apply_fused,
)
from rohm_tpu_torch.ops.transformer_layer_bf16 import (
    embed_cond,
    fused_encoder_layer_bf16,
    posenet_apply_prepared,
    prepare_posenet_fused,
)
from rohm_tpu_torch.ops.transformer_layer_int8 import (
    fused_encoder_layer_int8,
    fused_encoder_stack_int8,
    prepare_posenet_int8,
)

__all__ = [
    "embed_cond",
    "embed_cond_f32",
    "fused_encoder_layer",
    "fused_encoder_layer_bf16",
    "fused_encoder_layer_int8",
    "fused_encoder_stack_int8",
    "posenet_apply_fused",
    "posenet_apply_prepared",
    "prepare_posenet_fused",
    "prepare_posenet_int8",
]
