from .backbone import FallbackSubwordTokenizer, load_backbone_tokenizer

__all__ = ["FallbackSubwordTokenizer", "load_backbone_tokenizer"]
