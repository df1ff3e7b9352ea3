"""The benchmark of ``phoneme_vqa_torch`` on an NVIDIA card (``run.py``)."""
