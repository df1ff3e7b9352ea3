"""The plain float32 reference: PyTorch and NumPy only. It imports nothing
of ``phoneme_vqa_torch`` and takes nothing the program made: it reads the
fixture's files and the seeded weights itself."""
