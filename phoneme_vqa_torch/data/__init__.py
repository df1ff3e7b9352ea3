from .adapters import textlayout_ocr_adapt
from .latr import LaTrDataset
from .loader import ArrayDataset, batch_iterator

__all__ = ["ArrayDataset", "LaTrDataset", "batch_iterator", "textlayout_ocr_adapt"]
