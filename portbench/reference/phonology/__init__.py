"""Vietnamese syllable analysis, re-composition and the flat phoneme
vocabulary: frozen copies of ``phoneme_vqa_torch/phonology/`` (the plain
maths the reference needs, kept here so that a change to the program cannot
change the yardstick)."""
