from .attention import dot_product_attention, reference_attention
from .rel_bias import relative_position_bucket

__all__ = ["dot_product_attention", "reference_attention", "relative_position_bucket"]
