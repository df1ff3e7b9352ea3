from .adapters import textlayout_obj_adapt, textlayout_ocr_adapt
from .latr import LaTrDataset
from .loader import ArrayDataset, batch_iterator, num_batches
from .sal import SaLDataset

__all__ = [
    "ArrayDataset", "LaTrDataset", "SaLDataset", "batch_iterator", "num_batches",
    "textlayout_obj_adapt", "textlayout_ocr_adapt",
]
