"""Weight-only int8/int4 compression for the decode path (counterpart of
``repro.quant``).

Selected weights — the LM head the streaming verify kernels read every
token, the spec-head gather, the exit predictors and the per-layer
projections — become int8 or plane-packed int4 codes with per-output-column
fp32 scales, held in a *parallel* pytree: the original params are never
touched. The layout is the JAX package's byte for byte.
"""
from repro_torch.quant.core import (QTensor, QuantSpec, dequantize,
                                    dequantized_reference, matmul_codes,
                                    merge_dequant, pack_int4,
                                    quantize_params, quantize_tensor,
                                    take_columns, unpack_int4)

__all__ = ["QTensor", "QuantSpec", "dequantize", "dequantized_reference",
           "matmul_codes", "merge_dequant", "pack_int4", "quantize_params",
           "quantize_tensor", "take_columns", "unpack_int4"]
